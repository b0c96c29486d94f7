"""The megabatch route on eager round frames (the reference's frame
intent) in the port's rows engine, held to AMTPU_MEGABATCH=0 and to the
reference.

First the reference's own service-level cases (`tests/test_megabatch.py`:
`run_fleet`'s storms through `EngineDocSet`, made eager with its `eager`
helper, the planner's routing, the fused failure's recovery, the ledger's
account) run on both packages through `torch_twin_helpers`, the port's
service on `device="cpu"`, their hashes and dispatch counts held equal
label by label. The reference's `cpu_link` fixture prices its link at CPU
scale; the port's planner reads other constants (the card's), so on the
port's side the fixture's `dispatch.calibrate` also prices bytes
(`PortDispatch`, the constants of `test_torch_megabatch.force_route`),
and every case puts the port's constants back. No case is left out.

Then the port's own cases, one engine down: seeded map, list, text and
move storms as AMR1 frames, eager, a frame a call, through the route
(bytes priced), through AMTPU_MEGABATCH=0 and through the reference's
eager frame route, every round's hashes equal; the device copy kept
current by a route round (the next round scatters into the same tensor,
nothing re-uploaded); `hashes()` after a route round launching nothing;
and the planner pricing a frame against the classic frame dispatch, not
the narrow gather of a read. Tolerance: exact.
"""

import types

import numpy as np
import pytest
import torch

import automerge_tpu as am
from automerge_tpu.core.change import Change, Op
from automerge_tpu.core.ids import ROOT_ID
from automerge_tpu.engine import dispatch as ref_dispatch
from automerge_tpu.engine.resident_rows import ResidentRowsDocSet as RefRows
from automerge_tpu.sync.frames import (
    encode_round_frame as ref_encode_round_frame)

from torch_port_helpers import rounds_to_port
from torch_twin_helpers import collect, hygiene_teardown, run_twin
from test_torch_megabatch import (_random_storm, big_doc_changes,  # noqa
                                  force_route, frame_plans, mb,
                                  mega_totals, moved, per_doc,
                                  small_doc_changes)

from automerge_tpu_torch.engine import dispatch, dispatchledger
from automerge_tpu_torch.engine import resident_rows
from automerge_tpu_torch.engine.cuda_kernels import hashes_to_numpy
from automerge_tpu_torch.engine.pack import rows_count
from automerge_tpu_torch.engine.resident_rows import ResidentRowsDocSet
from automerge_tpu_torch.sync.frames import encode_round_frame


class PortDispatch(types.ModuleType):
    """The port's engine.dispatch as the reference's test module sees it:
    every name the port's, but `calibrate`, which also prices bytes so
    that the route wins where the reference's CPU-scale link makes it
    win (its `cpu_link` fixture calibrates the reference's link only)."""

    def __init__(self):
        super().__init__(dispatch.__name__)

    def __getattr__(self, name):
        return getattr(dispatch, name)

    @staticmethod
    def calibrate(**overrides):
        dispatch.calibrate(**overrides)
        force_route()


CASES = collect("test_megabatch", adapters={ref_dispatch: PortDispatch()})


@pytest.fixture(autouse=True)
def _hygiene():
    saved = dict(dispatch._LINK), dict(ref_dispatch._LINK)
    yield
    dispatch._LINK.update(saved[0])
    ref_dispatch._LINK.update(saved[1])
    hygiene_teardown()


@pytest.mark.parametrize("case", CASES, ids=str)
def test_reference_case_on_both_packages(case, tmp_path, monkeypatch):
    run_twin(case, tmp_path, monkeypatch, dispatches=True)


# ---------------------------------------------------------------------------
# the port's frame route, one engine down


def port_eager(ids, rounds, native=True):
    """The rounds as eager AMR1 frames through a fresh port engine, a frame
    a call. Returns (engine, the returned hashes a round, the megabatch
    rounds the ledger counted a round)."""
    ds = ResidentRowsDocSet(ids, device="cpu", native=native)
    out, fused = [], []
    for r in rounds_to_port(rounds):
        before = mega_totals(dispatchledger)["rounds"]
        h = ds.apply_round_frames([encode_round_frame(r)])
        fused.append(mega_totals(dispatchledger)["rounds"] - before)
        assert h.dtype == torch.int32 and h.shape == (ds.n_pad,)
        got = hashes_to_numpy(h)[:len(ids)]
        np.testing.assert_array_equal(ds.hashes(), got)
        out.append(got)
    return ds, out, fused


def ref_eager(ids, rounds):
    """The reference's eager frames (its frame route where it plans one)."""
    ref = RefRows(ids, native=True)
    return [np.asarray(ref.apply_round_frames([ref_encode_round_frame(r)]))
            [:len(ids)] for r in rounds]


def hold_three_ways(mb, ids, rounds, native=True):
    """The port's route (bytes priced), its AMTPU_MEGABATCH=0 path and the
    reference's eager frames: every round's hashes equal. Returns the
    port's route engine and its fused rounds a round."""
    force_route()
    ds, routed, fused = port_eager(ids, rounds, native)
    _, classic, none = per_doc(mb, lambda: port_eager(ids, rounds, native))
    want = ref_eager(ids, rounds)
    assert sum(none) == 0
    for k, (r, c, w) in enumerate(zip(routed, classic, want)):
        np.testing.assert_array_equal(r, c, err_msg=f"round {k}")
        np.testing.assert_array_equal(r, w, err_msg=f"round {k}")
    return ds, fused


def _text_storm(seed, n_docs=8, n_rounds=4):
    """Docs of a Text edited by two typists a round."""
    rng = np.random.default_rng(seed)
    ids = ["doc-big"] + [f"t{i:02d}" for i in range(n_docs)]
    docs = {}
    for i, d in enumerate(ids[1:]):
        docs[d] = am.change(am.init(f"A{i % 2}"), lambda x: x.__setitem__(
            "t", am.Text()))
        docs[d] = am.change(docs[d], lambda x, i=i: x["t"].insert_at(
            0, *"ab"[:1 + i % 2]))
    rounds = [{"doc-big": big_doc_changes()},
              {d: doc._doc.opset.get_missing_changes({})
               for d, doc in docs.items()}]
    typist = {d: am.merge(am.init(f"B{k}"), docs[d])
              for k, d in enumerate(ids[1:])}
    for _ in range(n_rounds):
        rnd = {}
        for d in rng.choice(ids[1:], int(rng.integers(2, n_docs)),
                            replace=False):
            prev = docs[d]
            a = am.change(prev, lambda x, k=int(rng.integers(0, 2)):
                          x["t"].insert_at(k, "x", "y"))
            b = am.change(am.merge(typist[d], prev),
                          lambda x: x["t"].delete_at(0))
            typist[d] = b
            nxt = am.merge(a, b)
            rnd[d] = nxt._doc.opset.get_missing_changes(prev._doc.opset.clock)
            docs[d] = nxt
        rounds.append(rnd)
    return ids, rounds


def _move_storm(seed, n_docs=8, n_rounds=3):
    """Docs of two maps and a list whose children move, a round."""
    rng = np.random.default_rng(seed)
    ids = ["doc-big"] + [f"m{i:02d}" for i in range(n_docs)]
    rounds = [{"doc-big": big_doc_changes()}]
    seqs = {}
    base = {}
    for i, d in enumerate(ids[1:]):
        ops = [Op("makeMap", f"{d}a"), Op("makeMap", f"{d}b"),
               Op("link", ROOT_ID, key="a", value=f"{d}a"),
               Op("link", ROOT_ID, key="b", value=f"{d}b"),
               Op("makeMap", f"{d}c"),
               Op("link", f"{d}a", key="c", value=f"{d}c"),
               Op("makeList", f"{d}L"),
               Op("link", ROOT_ID, key="L", value=f"{d}L")]
        prev = "_head"
        for e in range(1, 5):
            ops.append(Op("ins", f"{d}L", key=prev, elem=e))
            ops.append(Op("set", f"{d}L", key=f"M:{e}", value=e))
            prev = f"M:{e}"
        seqs[d] = 1
        base[d] = [Change("M", 1, {}, ops)]
    rounds.append(base)
    for r in range(n_rounds):
        rnd = {}
        for d in rng.choice(ids[1:], int(rng.integers(2, n_docs)),
                            replace=False):
            seqs[d] += 1
            src, dst = (f"{d}a", f"{d}b") if seqs[d] % 2 else \
                (f"{d}b", f"{d}a")
            rnd[d] = [Change("M", seqs[d], {}, [
                Op("move", src, key="c", value=dst),
                Op("set", f"{d}L", key=f"M:{1 + r % 4}", value=100 + r)])]
        rounds.append(rnd)
    return ids, rounds


STORMS = {"map_list": _random_storm, "text": _text_storm,
          "move": _move_storm}


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("kind", sorted(STORMS))
def test_frame_route_equals_per_doc_and_the_reference(mb, kind, seed):
    """Seeded storms as eager frames: the route's hashes equal the
    per-doc path's and the reference's eager frame route's, round by
    round, and the route is taken by every round but the first (one
    doc, below the floor)."""
    ids, rounds = STORMS[kind](seed)
    _, fused = hold_three_ways(mb, ids, rounds)
    assert fused == [0] + [1] * (len(rounds) - 1)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_frame_route_on_both_encoders(mb, native):
    """apply_round_frames on a native=False instance (Change rounds through
    the pure-Python encoder) takes the same decision."""
    ids, rounds = _random_storm(7)
    _, fused = hold_three_ways(mb, ids, rounds, native=native)
    assert fused == [0] + [1] * (len(rounds) - 1)


def _resident_fleet():
    """A fleet whose every actor is registered by its first round, then
    rounds of one-op edits by those actors (no growth, no new actor)."""
    ids = ["doc-big"] + [f"d{i}" for i in range(10)]
    base = {"doc-big": big_doc_changes()}
    docs = {}
    for i in range(10):
        docs[f"d{i}"] = am.change(am.init("W"), lambda x, i=i: am.assign(
            x, {"v": i, "xs": [i]}))
        base[f"d{i}"] = docs[f"d{i}"]._doc.opset.get_missing_changes({})
    rounds = [base]
    for r in range(3):
        rnd = {}
        for i in range(r, 10, 2):
            prev = docs[f"d{i}"]
            docs[f"d{i}"] = am.change(prev, lambda x, r=r: x.__setitem__(
                "v", 100 + r))
            rnd[f"d{i}"] = docs[f"d{i}"]._doc.opset.get_missing_changes(
                prev._doc.opset.clock)
        rounds.append(rnd)
    return ids, rounds


def test_route_round_keeps_the_device_copy_current(mb):
    """A route round scatters its triplets into the resident copy and
    gathers its buckets from it: afterwards the copy equals the host
    mirror, and the next round scatters into the same tensor: nothing the
    size of the buffer is uploaded."""
    force_route()
    ids, rounds = _resident_fleet()
    frames = [encode_round_frame(r) for r in rounds_to_port(rounds)]
    ds = ResidentRowsDocSet(ids, device="cpu")
    ds.apply_round_frames(frames[:1])
    ds.hashes()
    uploads = []
    real = ds._to_dev

    def to_dev(arr):
        uploads.append(arr.shape)
        return real(arr)
    mb.setattr(ds, "_to_dev", to_dev)
    scatters = []
    real_scatter = resident_rows._scatter_
    mb.setattr(resident_rows, "_scatter_",
               lambda rows, trips: scatters.append(len(trips))
               or real_scatter(rows, trips))
    for k, frame in enumerate(frames[1:]):
        dev_before = ds.rows_dev
        before = mega_totals(dispatchledger)
        ds.apply_round_frames([frame])
        assert moved(before, mega_totals(dispatchledger))["rounds"] == 1
        assert ds.rows_dev is dev_before and not ds._dirty
        assert torch.equal(ds.rows_dev, torch.from_numpy(ds.rows_host))
        assert len(scatters) == k + 1
    assert ds.rows_host.shape not in uploads
    _, classic, _ = per_doc(mb, lambda: port_eager(ids, rounds))
    np.testing.assert_array_equal(ds.hashes(), classic[-1])


def test_hashes_after_a_route_round_launch_nothing(mb):
    """The route reads its lanes' hashes back into the mirror and returns
    the post-batch tensor from it: the next hashes() serves the mirror,
    no launch and no readback of a device tensor."""
    ids, rounds = _resident_fleet()
    _, classic, _ = per_doc(mb, lambda: port_eager(ids, rounds[:2]))
    force_route()
    frames = [encode_round_frame(r) for r in rounds_to_port(rounds)]
    ds = ResidentRowsDocSet(ids, device="cpu")
    ds.apply_round_frames(frames[:1])
    ds.hashes()
    before = mega_totals(dispatchledger)
    h = ds.apply_round_frames(frames[1:2])
    assert moved(before, mega_totals(dispatchledger))["rounds"] == 1
    assert ds.hashes_clean
    calls = []
    mb.setattr(resident_rows, "reconcile_rows_hash",
               lambda *a, **k: calls.append(a))
    mb.setattr(dispatch, "reconcile_rows_hash",
               lambda *a, **k: calls.append(a))
    mb.setattr(resident_rows, "hashes_to_numpy",
               lambda *a, **k: calls.append(a))
    got = ds.hashes()
    assert calls == []
    np.testing.assert_array_equal(got, h.numpy().view(np.uint32)[:len(ids)])
    np.testing.assert_array_equal(got, classic[-1])


def test_planner_prices_a_frame_against_the_classic_dispatch(mb):
    """On the same dirty docs the two callers' alternatives disagree: a
    read prices the narrow gather at full dims from the host mirror (dear
    at the card's host gather rate), a frame the classic frame dispatch
    (one reconcile of this small buffer and its readback, cheap). With
    the card's constants the read takes the route and the frame does
    not; the frame's alternative is the classic dispatch's price."""
    ids, rounds = _resident_fleet()
    ds, _, _ = port_eager(ids, rounds[:1])
    idxs = [1, 2, 3]
    read = dispatch.plan_round(ds, idxs)
    frame = dispatch.plan_round(ds, idxs, frame_trips=6)
    link = dispatch._LINK
    nbytes = rows_count(*ds.dims()[:3]) * 4 * 128
    assert read.route == "megabatch"
    assert read.est_alt_s == pytest.approx(
        nbytes / link["host_gather_bytes_per_s"]
        + link["h2d_call_s"] + nbytes / link["h2d_bytes_per_s"]
        + link["launch_s"] + nbytes / link["dev_bytes_per_s"]
        + link["d2h_call_s"], rel=1e-12)
    assert frame.route == "per_doc"
    shared = (link["h2d_call_s"] + 6 * 24 / link["h2d_bytes_per_s"]
              + link["launch_s"])
    assert frame.est_alt_s == pytest.approx(
        shared + link["launch_s"]
        + ds.rows_host.nbytes / link["dev_bytes_per_s"]
        + link["d2h_call_s"] + ds.n_pad * 4 / link["d2h_bytes_per_s"],
        rel=1e-12)
    assert frame.est_alt_s < read.est_alt_s
    # a stale copy: both sides of a frame pay the re-upload
    ds._dirty = True
    stale = dispatch.plan_round(ds, idxs, frame_trips=6)
    up = (link["h2d_call_s"]
          + ds.rows_host.nbytes / link["h2d_bytes_per_s"])
    assert stale.est_alt_s == pytest.approx(
        frame.est_alt_s - shared + up, rel=1e-12)
    # a dear reconcile of the whole buffer sends the frame to the route
    dispatch.calibrate(dev_bytes_per_s=1e3)
    ds._dirty = False
    assert dispatch.plan_round(ds, idxs, frame_trips=6).route == "megabatch"


def test_frame_below_the_floor_or_off_is_never_planned(mb):
    """A frame batch dirtying fewer than megabatch_min_docs() docs, and
    every frame with AMTPU_MEGABATCH=0, goes to the classic dispatch
    unplanned."""
    force_route()
    ids, rounds = _resident_fleet()
    planned = frame_plans(mb)
    mb.setenv("AMTPU_MEGABATCH_MIN_DOCS", "6")
    dispatch._reload_for_tests()
    # rounds of 5, 5 and 4 docs: none reaches 6; the first (11) does
    port_eager(ids, rounds)
    assert [len(p.docs) for p in planned] == [11]
    planned.clear()
    per_doc(mb, lambda: port_eager(ids, rounds))
    assert planned == []
