"""The rows engine's megabatch route in the port (engine/dispatch.py
plan_round / apply_round_adaptive, pack.py's bucket helpers, the dispatch
ledger's megabatch account), held to the reference.

The invariant: a megabatched read's hashes are BIT-IDENTICAL to the
per-doc path's, because each bucket is a pure row-index subset of the full
docs-minor layout (pack.mega_row_map). The port takes the route on a
minority-dirty hash read; a round frame stays on the classic full-buffer
dispatch (the reference's frame intent is not ported: on the card the
whole resident buffer's reconcile costs less than the route's host work).
So every end-to-end case feeds the same AMR1 frames, with lazy_dispatch
set, to the port (each round then read with hashes_for of its docs, a
minority of the fleet: the route's read), to the port with
AMTPU_MEGABATCH=0 and to the reference read the same way, and holds all
three, and the reference's own frame route (eager frames), to equal
hashes. These are the cases of tests/test_megabatch.py one level down
(the port's EngineDocSet service is not ported yet).

Routing is priced. The port's constants are an H100's, so a test that
must take the route prices bytes instead (`force_route`: the port's own
calibrate, and the reference's link constants at CPU scale); the `mb`
fixture puts both back. Both packages cache AMTPU_MEGABATCH and the
ledger's gate in module globals: the fixture reloads those caches at
setup and again after monkeypatch has restored the environment, so no
test leaves a cache behind for a later file on the same worker."""

import numpy as np
import pytest
import torch

import automerge_tpu as am
from automerge_tpu.core.change import Change, Op
from automerge_tpu.core.ids import ROOT_ID
from automerge_tpu.engine import dispatch as ref_dispatch
from automerge_tpu.engine import dispatchledger as ref_ledger
from automerge_tpu.engine import pack as ref_pack
from automerge_tpu.engine.resident_rows import (
    DeviceDispatchError as RefDeviceDispatchError,
    ResidentRowsDocSet as RefRows)
from automerge_tpu.sync.frames import (
    encode_round_frame as ref_encode_round_frame)

from automerge_tpu_torch.engine import dispatch, dispatchledger, pack
from automerge_tpu_torch.engine.cuda_kernels import hashes_to_numpy
from automerge_tpu_torch.engine.resident_rows import (DeviceDispatchError,
                                                      ResidentRowsDocSet)
from automerge_tpu_torch.sync.frames import encode_round_frame
from automerge_tpu_torch.utils import metrics

from torch_port_helpers import rounds_to_port


def _reload_caches():
    for mod in (dispatch, dispatchledger, ref_dispatch, ref_ledger):
        mod._reload_for_tests()


@pytest.fixture
def mb(monkeypatch):
    """Every test that touches the route: the megabatch environment
    cleared, both packages' module caches reloaded, and both packages'
    cost constants restored at teardown; the caches are reloaded again
    after monkeypatch has put the environment back."""
    for var in ("AMTPU_MEGABATCH", "AMTPU_MEGABATCH_MIN_DOCS",
                "AMTPU_DISPATCHLEDGER"):
        monkeypatch.delenv(var, raising=False)
    saved = dict(dispatch._LINK), dict(ref_dispatch._LINK)
    _reload_caches()
    yield monkeypatch
    monkeypatch.undo()
    dispatch._LINK.update(saved[0])
    ref_dispatch._LINK.update(saved[1])
    _reload_caches()


def force_route():
    """Price bytes, not the card's fixed costs: the port's reconcile at
    1 KB/s and its host gather at 1 MB/s (the route's smaller buckets then
    win wherever the reference's do), and the reference's link at CPU
    scale (the constants of tests/test_megabatch.py's cpu_link)."""
    dispatch.calibrate(dev_bytes_per_s=1e3, host_gather_bytes_per_s=1e6)
    ref_dispatch.calibrate(dispatch_fixed_s=1e-5, h2d_call_s=1e-6,
                           d2h_call_s=1e-5)


def per_doc(mb, fn):
    """fn() with AMTPU_MEGABATCH=0 in both packages."""
    mb.setenv("AMTPU_MEGABATCH", "0")
    _reload_caches()
    try:
        return fn()
    finally:
        mb.delenv("AMTPU_MEGABATCH")
        _reload_caches()


def mega_totals(ledger):
    sec = ledger.ledger().section() or {}
    return {k: int(sec.get(f"mega_{k}_total") or 0)
            for k in ("rounds", "dispatches", "docs")}


def moved(before, after):
    return {k: after[k] - before[k] for k in before}


# ---------------------------------------------------------------------------
# change sets (each generated ONCE and replayed everywhere: a doc's identity
# is actor-random at init)

def big_doc_changes(n_ops=96):
    doc = am.change(am.init("big"), lambda d: am.assign(
        d, {"items": list(range(n_ops)), "meta": {"kind": "big"}}))
    return doc._doc.opset.get_missing_changes({})


def small_doc_changes(i):
    doc = am.change(am.init(f"w{i:03d}"), lambda d: am.assign(
        d, {"x": i, "tags": ["a", "b"]}))
    return doc._doc.opset.get_missing_changes({})


def storm_rounds(changes):
    """The first pair alone (it grows the caps), then the rest as ONE
    round."""
    return [dict(changes[:1]), dict(changes[1:])]


def with_idle(ids):
    """The fleet's ids and as many idle docs again, plus one: a round of
    any of `ids` is then a minority of the fleet."""
    return ids + [f"idle{k:03d}" for k in range(len(ids) + 1)]


def port_frames(ids, rounds, mega=True, mb=None, native=True, **kw):
    """The rounds as AMR1 frames through a fresh port engine, a frame a
    call, each returned hash tensor checked against the classic contract.
    Returns (engine, hashes after each call)."""
    def run():
        ds = ResidentRowsDocSet(ids, device="cpu", native=native, **kw)
        out = []
        for r in rounds_to_port(rounds):
            h = ds.apply_round_frames([encode_round_frame(r)])
            assert h.dtype == torch.int32 and h.shape == (ds.n_pad,)
            assert h.device.type == "cpu"
            got = hashes_to_numpy(h)[:len(ids)]
            np.testing.assert_array_equal(ds.hashes(), got)
            out.append(got)
        return ds, out
    return run() if mega else per_doc(mb, run)


def ref_frames(ids, rounds, native=True):
    ref = RefRows(ids, native=native)
    out = []
    for r in rounds:
        h = np.asarray(ref.apply_round_frames([ref_encode_round_frame(r)]))
        out.append(h[:len(ids)])
        np.testing.assert_array_equal(ref.hashes(), out[-1])
    return ref, out


def round_idx(ids, r):
    return sorted(ids.index(d) for d in r)


def port_reads(ids, rounds, mega=True, mb=None):
    """The rounds as AMR1 frames through a fresh port engine with
    lazy_dispatch set, each followed by a hashes_for read of the round's
    docs. Returns (engine, each read's hashes and a last hashes())."""
    def run():
        ds = ResidentRowsDocSet(ids, device="cpu")
        ds.lazy_dispatch = True
        out = []
        for r in rounds_to_port(rounds):
            assert ds.apply_round_frames([encode_round_frame(r)]) is None
            out.append(ds.hashes_for(round_idx(ids, r)))
        out.append(ds.hashes())
        return ds, out
    return run() if mega else per_doc(mb, run)


def ref_reads(ids, rounds):
    """port_reads on the reference."""
    ref = RefRows(ids, native=True)
    ref.lazy_dispatch = True
    out = []
    for r in rounds:
        ref.apply_round_frames([ref_encode_round_frame(r)])
        out.append(np.asarray(ref.hashes_for(round_idx(ids, r))))
    out.append(np.asarray(ref.hashes()))
    return ref, out


def three_ways(mb, ids, rounds):
    """The port's route, its per-doc path and the reference, each read as
    port_reads reads, and the reference's eager frames (its frame route):
    every read's hashes equal. Returns the port engine of the route and
    how the two ledgers' megabatch totals moved on the reads."""
    pb, rb = mega_totals(dispatchledger), mega_totals(ref_ledger)
    ds, fused = port_reads(ids, rounds)
    pa = mega_totals(dispatchledger)
    _, ref = ref_reads(ids, rounds)
    ra = mega_totals(ref_ledger)
    _, classic = port_reads(ids, rounds, mega=False, mb=mb)
    _, eager = ref_frames(ids, rounds)
    for f, c, r in zip(fused, classic, ref):
        np.testing.assert_array_equal(f, c)
        np.testing.assert_array_equal(f, r)
    for f, r, e in zip(fused, rounds, eager):
        np.testing.assert_array_equal(f, e[round_idx(ids, r)])
    np.testing.assert_array_equal(fused[-1], eager[-1])
    return ds, moved(pb, pa), moved(rb, ra)


# ---------------------------------------------------------------------------
# pack: quantize / row map / bucket planning (tests/test_megabatch.py's four,
# then held to the reference's helpers on seeded inputs)

def test_mega_quantize_power_of_two_ladder():
    assert pack.mega_quantize(1, 256) == pack.MEGA_MIN_DIM
    assert pack.mega_quantize(8, 256) == 8
    assert pack.mega_quantize(9, 256) == 16
    assert pack.mega_quantize(100, 256) == 128
    # clamped at the cap even off-ladder
    assert pack.mega_quantize(100, 96) == 96
    assert pack.mega_quantize(0, 96) == pack.MEGA_MIN_DIM


def test_mega_row_map_is_an_exact_subset():
    i, a, le = 64, 2, 8 * 16
    i_b, le_b = 16, 2 * 16
    rmap = pack.mega_row_map(i, a, le, i_b, le_b)
    full = pack.rows_count(i, a, le)
    assert len(rmap) == pack.rows_count(i_b, a, le_b)
    assert len(set(rmap.tolist())) == len(rmap)      # no row twice
    assert rmap.min() >= 0 and rmap.max() < full     # inside the layout


def test_mega_row_map_full_dims_is_identity():
    i, a, le = 32, 3, 4 * 8
    rmap = pack.mega_row_map(i, a, le, i, le)
    assert np.array_equal(rmap, np.arange(pack.rows_count(i, a, le)))


def test_plan_megabuckets_caps_bucket_count():
    # pathological spread: every doc a different size
    i_used = np.asarray([1, 3, 7, 15, 31, 63, 127, 200, 9, 80], np.int64)
    l_used = np.asarray([0, 1, 2, 4, 8, 16, 3, 30, 0, 12], np.int64)
    caps = (256, 2, 32 * 16)
    buckets = pack.plan_megabuckets(i_used, l_used, caps, 16)
    assert 1 <= len(buckets) <= pack.MEGA_MAX_BUCKETS
    # every doc position lands in exactly one bucket...
    seen = sorted(p for b in buckets for p in b["docs"].tolist())
    assert seen == list(range(len(i_used)))
    # ...whose dims cover its used sizes (no truncated reconcile)
    for b in buckets:
        i_b, le_b = b["dims"]
        for p in b["docs"].tolist():
            assert i_b >= i_used[p]
            assert le_b >= l_used[p] * 16 or le_b == caps[2]


def test_pack_helpers_equal_the_reference():
    assert (pack.MEGA_MAX_BUCKETS, pack.MEGA_MIN_DIM) == \
        (ref_pack.MEGA_MAX_BUCKETS, ref_pack.MEGA_MIN_DIM)
    for cap in (1, 8, 96, 256, 1024, 2048):
        for n in (0, 1, 7, 8, 9, 100, 500, 1024, 5000):
            assert pack.mega_quantize(n, cap) == \
                ref_pack.mega_quantize(n, cap)
    # caps over the base envelope too (I 2,048, LE 4,096), odd strides
    for caps, e in (((512, 2, 8), 8), ((1024, 9, 1024), 8),
                    ((2048, 4, 4096), 16), ((64, 3, 0), 8),
                    ((96, 2, 60), 12), ((256, 2, 40), 5)):
        for i_used in (0, 1, 8, 9, 100, caps[0]):
            for l_used in range(0, caps[2] // e + 2 if e else 1):
                assert pack.mega_bucket_dims(i_used, l_used, caps, e) == \
                    ref_pack.mega_bucket_dims(i_used, l_used, caps, e)
        i_b, le_b = pack.mega_bucket_dims(caps[0] // 3, 1, caps, e)
        np.testing.assert_array_equal(
            pack.mega_row_map(caps[0], caps[1], caps[2], i_b, le_b),
            ref_pack.mega_row_map(caps[0], caps[1], caps[2], i_b, le_b))


@pytest.mark.parametrize("seed", range(6))
def test_plan_megabuckets_equals_the_reference(seed):
    """Seeded doc sizes, many shapes (so MEGA_MAX_BUCKETS merging runs)
    and ties in bucket size: the same buckets, dims, members and order."""
    rng = np.random.default_rng(seed)
    caps, e = ((2048, 4, 4096), 16) if seed % 2 else ((512, 2, 64), 8)
    n = int(rng.integers(1, 400))
    i_used = rng.integers(0, caps[0] + 1, n) >> int(rng.integers(0, 8))
    l_used = rng.integers(0, caps[2] // e + 1, n) >> int(rng.integers(0, 6))
    if seed == 0:
        l_used[:] = 0
    got = pack.plan_megabuckets(i_used, l_used, caps, e)
    want = ref_pack.plan_megabuckets(i_used, l_used, caps, e)
    assert [b["dims"] for b in got] == [b["dims"] for b in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["docs"], w["docs"])
    assert pack.plan_megabuckets([], [], caps, e) == []


# ---------------------------------------------------------------------------
# routing

def _small_fleet(n=6, **kw):
    ids = [f"d{i}" for i in range(n)]
    ds = ResidentRowsDocSet(ids, device="cpu", **kw)
    rnd = {ids[i]: small_doc_changes(i) for i in range(n)}
    ds.apply_rounds(rounds_to_port([rnd]))
    return ds


def test_one_doc_round_stays_per_doc(mb):
    force_route()
    ds = _small_fleet(2)
    plan = dispatch.plan_round(ds, [0])
    assert plan.route == "per_doc"          # below the doc floor
    assert plan.buckets == []
    assert dispatch.apply_round_adaptive(ds, plan) is None


def test_disabled_env_short_circuits_planning(mb):
    force_route()
    ds = _small_fleet(6)

    def plan():
        assert not dispatch.megabatch_enabled()
        return dispatch.plan_round(ds, list(range(6)))
    p = per_doc(mb, plan)
    assert p.route == "per_doc"
    assert p.buckets == []                  # never even planned
    assert dispatch.megabatch_enabled()


def test_min_docs_env_sets_the_floor(mb):
    force_route()
    ds = _small_fleet(6)
    mb.setenv("AMTPU_MEGABATCH_MIN_DOCS", "5")
    _reload_caches()
    assert dispatch.megabatch_min_docs() == 5
    assert dispatch.plan_round(ds, [0, 1, 2, 3]).buckets == []
    assert dispatch.plan_round(ds, [0, 1, 2, 3, 4]).buckets


@pytest.mark.parametrize("link", ["card", "bytes", "fixed"])
@pytest.mark.parametrize("resident", [True, False],
                         ids=["resident", "stale"])
def test_planner_never_picks_a_costlier_route(mb, link, resident):
    """Pathological spread, whatever the constants (the card's, bytes
    priced, fixed costs priced) and whether the device copy is current or
    stale: the route taken is the side of the comparison the plan prices
    no dearer."""
    if link == "bytes":
        force_route()
    elif link == "fixed":
        dispatch.calibrate(launch_s=1e-3, h2d_call_s=1e-3)
    ids = ["big"] + [f"d{i}" for i in range(8)]
    rnd = {"big": big_doc_changes(120)}
    for i in range(8):
        doc = am.change(am.init("W"), lambda d, i=i: am.assign(
            d, {"v": i, "pad": list(range(1 + 4 * i))}))
        rnd[f"d{i}"] = doc._doc.opset.get_missing_changes({})
    ds = ResidentRowsDocSet(ids, device="cpu")
    ds.apply_rounds(rounds_to_port([rnd]))
    if not resident:
        ds._dirty = True
    plan = dispatch.plan_round(ds, list(range(1, 9)))
    assert len(plan.buckets) <= pack.MEGA_MAX_BUCKETS
    if plan.route == "megabatch":
        assert plan.buckets and plan.est_mega_s <= plan.est_alt_s
    else:
        # est_mega_s is the route's full price, or (no buckets) the
        # lower bound of its fixed legs alone
        assert plan.est_mega_s > plan.est_alt_s


def test_card_constants_keep_a_small_fleet_classic(mb):
    """Round frames stay on the classic full-buffer dispatch whatever the
    constants (the card's, or bytes priced so that the route would win a
    read): they never plan, the ledger records no megabatch round, and the
    hashes are those of the reference's frame route."""
    changes = [("doc-big", big_doc_changes())]
    changes += [(f"doc{i:03d}", small_doc_changes(i)) for i in range(6)]
    ids = [d for d, _ in changes]
    planned = []
    real = dispatch.plan_round
    mb.setattr(dispatch, "plan_round",
               lambda *a, **k: planned.append(a) or real(*a, **k))
    _, want = ref_frames(ids, storm_rounds(changes))
    for priced in ("card", "bytes"):
        if priced == "bytes":
            force_route()
        before = mega_totals(dispatchledger)
        _, got = port_frames(ids, storm_rounds(changes))
        assert mega_totals(dispatchledger) == before
        assert planned == []
        np.testing.assert_array_equal(got[-1], want[-1])


# ---------------------------------------------------------------------------
# bit parity with the per-doc path and the reference

def test_same_shape_storm_one_bucket_one_dispatch(mb):
    force_route()
    changes = [("doc-big", big_doc_changes())]
    changes += [(f"doc{i:03d}", small_doc_changes(i)) for i in range(12)]
    ids = with_idle([d for d, _ in changes])
    _, port, ref = three_ways(mb, ids, storm_rounds(changes))
    assert port == {"rounds": 1, "dispatches": 1, "docs": 12}
    assert port == ref


def test_mixed_shape_storm_byte_equal(mb):
    # two shape clusters (tiny maps vs mid-size lists): few buckets
    force_route()
    changes = [("doc-big", big_doc_changes(96))]
    for i in range(10):
        n_xs = 2 if i % 2 == 0 else 18
        doc = am.change(am.init("W"), lambda d, i=i, n=n_xs: am.assign(
            d, {"n": i, "xs": list(range(n))}))
        changes.append((f"doc{i:02d}",
                        doc._doc.opset.get_missing_changes({})))
    ids = with_idle([d for d, _ in changes])
    _, port, ref = three_ways(mb, ids, storm_rounds(changes))
    assert port["rounds"] == 1
    assert 1 <= port["dispatches"] <= pack.MEGA_MAX_BUCKETS
    assert port == ref


def test_mixed_map_list_move_round_byte_equal(mb):
    """Raw map / list / move ops through the fused read, each doc's change
    set shared verbatim."""
    def doc_changes(i):
        ops = [Op("makeMap", f"f{i}a"), Op("makeMap", f"f{i}b"),
               Op("link", ROOT_ID, key="ka", value=f"f{i}a"),
               Op("link", ROOT_ID, key="kb", value=f"f{i}b"),
               Op("makeList", f"L{i}"),
               Op("link", ROOT_ID, key="L", value=f"L{i}")]
        prev = "_head"
        for e in range(1, 3 + i % 4):
            ops.append(Op("ins", f"L{i}", key=prev, elem=e))
            ops.append(Op("set", f"L{i}", key=f"A:{e}", value=e * 10))
            prev = f"A:{e}"
        return [Change("A", 1, {}, ops),
                Change("A", 2, {}, [Op("move", f"f{i}b", key="moved",
                                       value=f"f{i}a")])]

    force_route()
    changes = [("doc-big", big_doc_changes())]
    changes += [(f"doc{i}", doc_changes(i)) for i in range(9)]
    ids = with_idle([d for d, _ in changes])
    _, port, ref = three_ways(mb, ids, storm_rounds(changes))
    assert port["rounds"] == 1 and port == ref


def _two_writer_rounds(order):
    """Doc-big alone, then each doc's base, then two concurrent writers'
    edits in the given order, a round each."""
    rounds = [{"doc-big": _TWO_WRITERS["big"]},
              {f"d{i}": base for i, (base, _, _) in
               enumerate(_TWO_WRITERS["docs"])}]
    first, second = (1, 2) if order == "ab" else (2, 1)
    for k in (first, second):
        rounds.append({f"d{i}": chs[k] for i, chs in
                       enumerate(_TWO_WRITERS["docs"])})
    return rounds


def _two_writers():
    docs = []
    for i in range(8):
        a = am.change(am.init(f"A{i}"),
                      lambda d, i=i: am.assign(d, {"x": i, "l": [i]}))
        b = am.merge(am.init(f"B{i}"), a)
        a2 = am.change(a, lambda d: d.__setitem__("x", 99))
        b2 = am.change(b, lambda d: d["l"].append(7))
        clk = {c.actor: c.seq for c in a._doc.opset.get_missing_changes({})}
        docs.append((a._doc.opset.get_missing_changes({}),
                     a2._doc.opset.get_missing_changes(clk),
                     b2._doc.opset.get_missing_changes(clk)))
    return {"big": big_doc_changes(), "docs": docs}


_TWO_WRITERS = _two_writers()


def test_both_orders_storm_converges_through_megabatch(mb):
    """Two concurrent writers per doc, applied in opposite orders and read
    through the route: the same converged hash per doc, equal to the
    reference's and to the per-doc path's every round."""
    force_route()
    ids = with_idle(["doc-big"] + [f"d{i}" for i in range(8)])
    finals = []
    for order in ("ab", "ba"):
        _, port, ref = three_ways(mb, ids, _two_writer_rounds(order))
        assert port["rounds"] >= 1 and port == ref
        finals.append(port_reads(ids, _two_writer_rounds(order))[1][-1])
    np.testing.assert_array_equal(finals[0], finals[1])


def test_fused_dispatch_failure_recovers_byte_equal(mb):
    """A failure inside a fused bucket launch surfaces as
    DeviceDispatchError(admission_complete=True): host truth already holds
    the round, and the next hash read reconciles the still-dirty lanes to
    the per-doc path's hashes."""
    force_route()
    changes = [("doc-big", big_doc_changes())]
    changes += [(f"doc{i:03d}", small_doc_changes(i)) for i in range(8)]
    ids = with_idle([d for d, _ in changes])
    rounds = rounds_to_port(storm_rounds(changes))
    _, classic = port_reads(ids, storm_rounds(changes), mega=False, mb=mb)
    ds = ResidentRowsDocSet(ids, device="cpu")
    ds.apply_round_frames([encode_round_frame(rounds[0])])
    ds.hashes()
    ds.lazy_dispatch = True
    ds.apply_round_frames([encode_round_frame(rounds[1])])
    real = dispatch.reconcile_rows_hash
    armed = {"now": True}

    def flaky(*a, **k):
        if armed["now"]:
            armed["now"] = False
            raise RuntimeError("injected fused dispatch failure")
        return real(*a, **k)

    mb.setattr(dispatch, "reconcile_rows_hash", flaky)
    failed = metrics.snapshot().get("rows_dispatch_failed", 0)
    with pytest.raises(DeviceDispatchError) as err:
        ds.hashes_for(round_idx(ids, rounds[1]))
    assert err.value.admission_complete
    assert not armed["now"]                 # the injection fired
    assert metrics.snapshot()["rows_dispatch_failed"] == failed + 1
    assert not ds.hashes_clean
    np.testing.assert_array_equal(ds.hashes(), classic[-1])
    assert ds.hashes_clean


def test_fused_round_summary_and_ledger_account(mb):
    """The fused read's occupancy lands in the open round and in the
    cumulative account, as the reference's does on the same round."""
    force_route()
    changes = [("doc-big", big_doc_changes())]
    changes += [(f"doc{i:03d}", small_doc_changes(i)) for i in range(12)]
    ids = with_idle([d for d, _ in changes])
    rounds = storm_rounds(changes)
    idx = round_idx(ids, rounds[1])

    def last_round(ledger, engine, frames):
        engine.apply_round_frames(frames[:1])
        engine.hashes()
        engine.lazy_dispatch = True
        with ledger.round_scope(12, label="storm"):
            engine.apply_round_frames(frames[1:])
            engine.hashes_for(idx)
        return ledger.ledger().section()["ring"][-1]

    base = mega_totals(dispatchledger)
    got = last_round(dispatchledger, ResidentRowsDocSet(ids, device="cpu"),
                     [encode_round_frame(r) for r in rounds_to_port(rounds)])
    sec = dispatchledger.ledger().section()
    assert moved(base, mega_totals(dispatchledger))["docs"] == 12
    assert int(sec["mega_docs_cap_total"]) > 0
    want = last_round(ref_ledger, RefRows(ids),
                      [ref_encode_round_frame(r) for r in rounds])
    assert got["mega"] == {k: v for k, v in want["mega"].items()
                           if k != "tenant_lanes"}
    assert got["kernels"]["rows_mega"]["calls"] == \
        want["kernels"]["rows_mega"]["calls"] == got["mega"]["buckets"]
    assert got["dirty_docs"] == 12 and got["label"] == "storm"
    assert dispatchledger.last_round_summary()["mega"] == got["mega"]


# ---------------------------------------------------------------------------
# the device copy stays resident

def test_route_keeps_a_current_device_copy(mb):
    """A megabatch read on an instance whose device copy was current
    gathers its buckets from that copy and never drops it: afterwards
    rows_dev equals the host mirror, the hashes are clean and equal to
    the reference's, and a hashes() read launches nothing. Late docs fill
    padding lanes, as a service adds them: the copy stays current and the
    new lanes are the read's dirty minority."""
    force_route()
    ids = ["doc-big"] + [f"d{i}" for i in range(10)]
    base = {"doc-big": big_doc_changes()}
    base.update({f"d{i}": small_doc_changes(i) for i in range(10)})
    late = [f"late{i}" for i in range(5)]
    ds = ResidentRowsDocSet(ids, device="cpu")
    ds.apply_rounds(rounds_to_port([base]))         # a classic upload
    ds.add_docs(late)
    assert ds.rows_dev is not None and not ds._dirty
    assert sorted(ds._doc_dirty) == list(range(11, 16))
    before = mega_totals(dispatchledger)
    got = ds.hashes()
    assert moved(before, mega_totals(dispatchledger)) == \
        {"rounds": 1, "dispatches": 1, "docs": 5}
    assert ds.rows_dev is not None and not ds._dirty
    assert torch.equal(ds.rows_dev, torch.from_numpy(ds.rows_host))
    assert ds.hashes_clean
    calls = []
    mb.setattr(dispatch, "reconcile_rows_hash",
               lambda *a, **k: calls.append(a))
    np.testing.assert_array_equal(ds.hashes(), got)
    assert calls == []
    ref = RefRows(ids)
    ref.apply_rounds([base])
    ref.add_docs(late)
    np.testing.assert_array_equal(got, np.asarray(ref.hashes()))


def test_mega_doc_sizes_equal_the_reference_band_scan(mb):
    """The port sizes docs from op_count and an ins_mask scan; the
    reference scans both bands of its mirror: equal on the same frames."""
    changes = [("doc-big", big_doc_changes())]
    changes += [(f"doc{i:02d}", small_doc_changes(i)) for i in range(5)]
    ids = [d for d, _ in changes]
    ds, _ = port_frames(ids, storm_rounds(changes))
    ref, _ = ref_frames(ids, storm_rounds(changes))
    idxs = list(range(len(ids)))
    for got, want in zip(ds._mega_doc_sizes(idxs),
                         ref._mega_doc_sizes(idxs)):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the minority-dirty hash refresh

@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_minority_refresh_takes_the_route(mb, native):
    """Lazily applied rounds leave their lanes dirty; a minority
    hashes_for read reconciles them through the fused buckets (from the
    stale copy's host mirror), as the reference's does: equal hashes and
    equal ledger moves."""
    force_route()
    ids = ["doc-big"] + [f"d{i:02d}" for i in range(20)]
    boot = {"doc-big": big_doc_changes()}
    boot.update({ids[i + 1]: small_doc_changes(i) for i in range(20)})
    edits = {}
    for i in (0, 3, 5):
        doc = am.change(am.init(f"z{i}"), lambda d, i=i: am.assign(
            d, {"late": [i, i + 1]}))
        edits[ids[i + 1]] = doc._doc.opset.get_missing_changes({})
    want_idx = [1, 4, 6, 7]
    port = ResidentRowsDocSet(ids, device="cpu", native=native)
    port.apply_rounds(rounds_to_port([boot]))
    port.lazy_dispatch = True
    ref = RefRows(ids, native=native)
    ref.apply_rounds([boot])
    ref.lazy_dispatch = True
    pb, rb = mega_totals(dispatchledger), mega_totals(ref_ledger)
    assert port.apply_round_frames(
        [encode_round_frame(rounds_to_port([edits])[0])]) is None
    ref.apply_round_frames([ref_encode_round_frame(edits)])
    got = port.hashes_for(want_idx)
    np.testing.assert_array_equal(got, ref.hashes_for(want_idx))
    got_moved = moved(pb, mega_totals(dispatchledger))
    # the new actors re-rank every doc: all four requested lanes are dirty
    assert got_moved["rounds"] == 1 and got_moved["docs"] == len(want_idx)
    ref_moved = moved(rb, mega_totals(ref_ledger))
    if native:
        assert got_moved == ref_moved
    else:
        # the reference's Python-encoder frame ingress runs apply_rounds,
        # which reconciles eagerly whatever lazy_dispatch says: nothing
        # is left dirty for its read
        assert ref_moved["rounds"] == 0
    np.testing.assert_array_equal(port.hashes(), ref.hashes())


# ---------------------------------------------------------------------------
# the reference's fault (ROADMAP Queue C): a megabatch micro-batch that
# admits nothing

def _dangling_rounds():
    """Two docs, each with two changes; the second changes arrive first
    (their dependency has not), then the first."""
    firsts, seconds = {}, {}
    for i, did in enumerate(("a", "b")):
        d1 = am.change(am.init(f"Q{i}"), lambda d, i=i: am.assign(
            d, {"k": i}))
        d2 = am.change(d1, lambda d, i=i: d.__setitem__("k", 10 + i))
        firsts[did] = d1._doc.opset.get_missing_changes({})
        seconds[did] = d2._doc.opset.get_missing_changes(
            d1._doc.opset.clock)
    return [seconds, firsts]


@pytest.mark.parametrize("route", ["card", "forced"])
def test_dangling_dependencies_return_hashes(mb, route):
    """The reference raises DeviceDispatchError on a two-doc frame whose
    changes all wait on a missing dependency (its megabatch intent skips
    the device upload, then nothing is touched); the port returns the
    hashes, [0, 0], then the reference's AMTPU_MEGABATCH=0 hashes once the
    missing changes arrive."""
    if route == "forced":
        force_route()
    ids = ["a", "b"]
    rounds = _dangling_rounds()
    ref = RefRows(ids, native=True)
    with pytest.raises(RefDeviceDispatchError):
        ref.apply_round_frames([ref_encode_round_frame(rounds[0])])
    _, want = per_doc(mb, lambda: ref_frames(ids, rounds))
    ds, got = port_frames(ids, rounds)
    np.testing.assert_array_equal(got[0], np.zeros(2, np.uint32))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].all()


def test_empty_round_after_a_megabatch_round_returns_hashes(mb):
    """The same sequence after a read that took the route: the port
    returns the unchanged hashes, then the reference's AMTPU_MEGABATCH=0
    ones. The reference raises here too, after its frame route has
    dropped its device copy."""
    force_route()
    changes = [("doc-big", big_doc_changes())]
    changes += [(f"doc{i:03d}", small_doc_changes(i)) for i in range(6)]
    ids = with_idle([d for d, _ in changes] + ["a", "b"])
    storm, dangling = storm_rounds(changes), _dangling_rounds()
    ds = ResidentRowsDocSet(ids, device="cpu")
    ds.lazy_dispatch = True
    before = mega_totals(dispatchledger)
    for r in rounds_to_port(storm):
        ds.apply_round_frames([encode_round_frame(r)])
        ds.hashes_for(round_idx(ids, r))
    assert moved(before, mega_totals(dispatchledger))["rounds"] == 1
    settled = ds.hashes()
    ds.lazy_dispatch = False
    got = [hashes_to_numpy(ds.apply_round_frames(
        [encode_round_frame(r)]))[:len(ids)]
        for r in rounds_to_port(dangling)]
    np.testing.assert_array_equal(got[0], settled)
    _, want = per_doc(mb, lambda: ref_frames(ids, storm + dangling))
    np.testing.assert_array_equal(got[0], want[2])
    np.testing.assert_array_equal(got[1], want[3])
    ref = RefRows(ids, native=True)
    for r in storm:
        ref.apply_round_frames([ref_encode_round_frame(r)])
    with pytest.raises(RefDeviceDispatchError):
        ref.apply_round_frames([ref_encode_round_frame(dangling[0])])


# ---------------------------------------------------------------------------
# seeded storms: random shapes, new actors, several micro-batches

def _random_storm(seed, n_docs=16, n_rounds=4):
    rng = np.random.default_rng(seed)
    ids = ["doc-big"] + [f"r{i:02d}" for i in range(n_docs)]
    docs = {d: am.change(am.init(f"S{i % 3}"), lambda x, i=i: am.assign(
        x, {"n": i, "xs": list(range(int(rng.integers(0, 12))))}))
        for i, d in enumerate(ids[1:])}
    rounds = [{"doc-big": big_doc_changes(int(rng.integers(40, 120)))},
              {d: doc._doc.opset.get_missing_changes({})
               for d, doc in docs.items()}]
    second = set()
    for _ in range(n_rounds):
        rnd = {}
        for d in rng.choice(ids[1:], int(rng.integers(2, n_docs)),
                            replace=False):
            prev = docs[d]
            kind = int(rng.integers(3))
            if kind == 0:
                nxt = am.change(prev, lambda x, v=int(rng.integers(99)):
                                x.__setitem__("n", v))
            elif kind == 1:
                nxt = am.change(prev, lambda x, k=int(rng.integers(1, 5)):
                                x["xs"].insert_at(0, *range(k)))
            else:
                if d not in second:     # a second writer joins the doc
                    second.add(d)
                    prev = am.merge(am.init(f"T{seed}"), prev)
                nxt = am.change(prev, lambda x: x.__setitem__("m", "t"))
            rnd[d] = nxt._doc.opset.get_missing_changes(prev._doc.opset.clock)
            docs[d] = nxt
        rounds.append(rnd)
    return ids, rounds


@pytest.mark.parametrize("seed", range(4))
def test_seeded_storms_equal_the_reference(mb, seed):
    """Every read's hashes equal on the three routes and the reference's
    eager frames. The two packages price the route differently, so only
    each one's taking it is asserted."""
    force_route()
    ids, rounds = _random_storm(seed)
    _, port, ref = three_ways(mb, with_idle(ids), rounds)
    assert port["rounds"] >= 1 and ref["rounds"] >= 1
