"""Causally-stable compaction and the ghost-anchor reject of the port's rows
engine (automerge_tpu_torch/engine/compaction.py, ResidentRowsDocSet.
compact) against the reference's, at engine level: the cases of
tests/test_compaction.py (less the one that needs `Connection`) and a
seeded fuzz of tests/test_hypothesis_compaction.py. The same seeded change
streams go through both packages' ResidentRowsDocSet (the port on
device="cpu", the kernel's plain version); the reference's tests reach
them through EngineDocSet, which is not ported, so a floor the service
computes from peer clocks is computed here (`peer_floor`).

Tolerance: exact. Compaction stats, the compacted row mirror, op counts,
insert logs, ghosts, clocks and every hash are equal, and a rejected
ingress raises the same error before admission in both."""

import os
import random
import shutil
import tempfile

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import automerge_tpu as am
from automerge_tpu.core.change import Change, Op
from automerge_tpu.core.ids import ROOT_ID
from automerge_tpu.engine import compaction as ref_compaction
from automerge_tpu.engine.pack import ROWS_MAX_OPS
from automerge_tpu.engine.resident_rows import (
    CompactionAnchorError as RefAnchorError, ResidentRowsDocSet as RefRows,
    RowsBudgetError as RefBudgetError)
from automerge_tpu.native.wire import (
    changes_to_columns as ref_changes_to_columns)
from automerge_tpu.sync.frames import (
    encode_round_frame as ref_encode_round_frame)
from automerge_tpu.sync.logarchive import LogArchive as RefArchive

from automerge_tpu_torch.engine import compaction
from automerge_tpu_torch.engine.resident_rows import (
    CompactionAnchorError, ResidentRowsDocSet, RowsBudgetError)
from automerge_tpu_torch.native.wire import changes_to_columns
from automerge_tpu_torch.sync.frames import encode_round_frame
from automerge_tpu_torch.sync.logarchive import LogArchive

from test_torch_rows import history, split_rounds
from torch_port_helpers import (assert_same_rows, build_history, changes_of,
                                to_port)


def pair(ids, native=True):
    return (RefRows(ids, native=native),
            ResidentRowsDocSet(ids, device="cpu", native=native))


def deliver(ref, port, rnd, route="rounds"):
    """One round {doc_id: [reference Change]} into both engines through
    `route`: Change rounds, column rounds, or one AMR1 round frame."""
    if route == "rounds":
        ref.apply_rounds([rnd])
        port.apply_rounds([{d: to_port(c) for d, c in rnd.items()}])
    elif route == "cols":
        ref.apply_rounds_cols([{d: ref_changes_to_columns(c)
                                for d, c in rnd.items()}])
        port.apply_rounds_cols([{d: changes_to_columns(to_port(c))
                                 for d, c in rnd.items()}])
    else:
        ref.apply_round_frames([ref_encode_round_frame(rnd)])
        port.apply_round_frames([encode_round_frame(
            {d: to_port(c) for d, c in rnd.items()})])
    np.testing.assert_array_equal(port.hashes(), ref.hashes())


def compact_both(ref, port, floors, pins=None):
    s_ref = ref.compact(floors, pins)
    s_port = port.compact(floors, pins)
    assert s_port == s_ref
    assert port.compaction_floors == ref.compaction_floors
    assert_same_rows(ref, port)
    return s_port


def own_floor(rset, doc="doc"):
    rset.sync_tables()
    return dict(rset.tables[rset.doc_index[doc]].clock)


def peer_floor(rset, doc, peers, causal_floor):
    """The sync service's floor for `doc` (reference sync/service.py
    `_compaction_floor_locked`): the engine's causal floor, lowered by each
    peer's advertised clock, and empty when a peer advertises an actor this
    node has no change from."""
    i = rset.doc_index[doc]
    floor = causal_floor(rset, i)
    own = own_floor(rset, doc)
    for peer in peers:
        if any(a not in own for a in peer):
            return {}
        floor = {a: min(s, peer.get(a, 0)) for a, s in floor.items()}
    return {a: s for a, s in floor.items() if s > 0}


def text_of(ref, doc="doc"):
    return "".join(ref.materialize(doc)["data"]["t"])


@pytest.mark.parametrize("native", [True, False])
def test_hash_parity_and_reclaim(native):
    d = build_history()
    ref, port = pair(["doc"], native)
    deliver(ref, port, {"doc": changes_of(d)})
    h0 = port.hashes()
    floor = {"doc": own_floor(port)}
    stats = port.compact(floor)["doc"]
    assert stats == ref.compact(floor)["doc"]
    # the compacted doc re-reads through the kernel: its lane is dirty and
    # the device copy re-uploads from the compacted mirror
    assert port._doc_dirty == {0} and port.rows_dev is None
    assert_same_rows(ref, port)
    # dominated overwrites, every make/ins row and the below-floor deletes
    # go; the 6 deleted characters leave their band slots
    assert stats["ops_after"] < stats["ops_before"]
    assert stats["elems_after"] == 5
    assert int(port.op_count[0]) == stats["ops_after"]
    np.testing.assert_array_equal(port.hashes(), h0)
    assert text_of(ref) == "world"


@pytest.mark.parametrize("route,native", [
    ("rounds", True), ("rounds", False), ("cols", True), ("frames", True),
    ("frames", False)])
def test_admission_and_linearization_after_compaction(route, native):
    d = build_history()
    ref, port = pair(["doc"], native)
    deliver(ref, port, {"doc": changes_of(d)})
    floor = own_floor(port)
    compact_both(ref, port, {"doc": floor})
    # front, middle and map edits on the compacted state: the ghosts'
    # ordering keys keep new inserts where an uncompacted replica puts them
    d2 = am.change(d, lambda x: x["t"].insert_at(0, *"HI "))
    d2 = am.change(d2, lambda x: x["t"].insert_at(5, "X"))
    d2 = am.change(d2, lambda x: x.__setitem__("n", 999))
    deliver(ref, port, {"doc": [c for c in changes_of(d2)
                                if c.seq > floor.get(c.actor, 0)]}, route)
    assert_same_rows(ref, port)
    fresh = ResidentRowsDocSet(["doc"], device="cpu", native=native)
    fresh.apply_rounds([{"doc": to_port(changes_of(d2))}])
    np.testing.assert_array_equal(port.hashes(), fresh.hashes())
    assert text_of(ref) == "HI woXrld"


def test_concurrent_conflicts_survive_compaction():
    a = am.change(am.init("A"), lambda x: x.__setitem__("k", "from-a"))
    b = am.merge(am.init("B"), a)
    a2 = am.change(a, lambda x: x.__setitem__("k", "a-wins?"))
    b2 = am.change(b, lambda x: x.__setitem__("k", "b-wins?"))
    ref, port = pair(["doc"])
    deliver(ref, port, {"doc": changes_of(am.merge(a2, b2))})
    h0 = port.hashes()
    stats = compact_both(ref, port, {"doc": own_floor(port)})["doc"]
    np.testing.assert_array_equal(port.hashes(), h0)
    # both concurrent assigns are candidates: neither is reclaimed
    assert stats["ops_after"] >= 2


def test_floor_gates_del_reclaim_for_straggler_inserts():
    """A tombstone above the floor keeps its slot, so a straggler's insert
    anchored at it admits and converges."""
    base = am.change(am.init("A"), lambda x: x.__setitem__("t", am.Text()))
    base = am.change(base, lambda x: x["t"].insert_at(0, *"abc"))
    fork = am.merge(am.init("B"), base)
    a2 = am.change(base, lambda x: x["t"].delete_at(1))
    floor = {c.actor: c.seq for c in changes_of(base)}
    ref, port = pair(["doc"])
    deliver(ref, port, {"doc": changes_of(a2)})
    stats = compact_both(ref, port, {"doc": floor})["doc"]
    assert stats["elems_after"] == 3
    b2 = am.change(fork, lambda x: x["t"].insert_at(2, "X"))
    merged = am.merge(a2, b2)
    deliver(ref, port, {"doc": [c for c in changes_of(b2)
                                if c.actor == "B"]}, "frames")
    assert_same_rows(ref, port)
    assert text_of(ref) == "".join(merged["t"])


def test_peer_ahead_blocks_tombstone_reclaim():
    """A peer that advertises a change this node has not admitted may have
    one in flight anchored at a tombstone: the service's floor is empty
    and nothing is ghosted."""
    base = am.change(am.init("A"), lambda x: x.__setitem__("t", am.Text()))
    base = am.change(base, lambda x: x["t"].insert_at(0, *"abc"))
    fork = am.merge(am.init("B"), base)
    b2 = am.change(fork, lambda x: x["t"].insert_at(2, "X"))
    a2 = am.change(base, lambda x: x["t"].delete_at(1))
    ref, port = pair(["doc"])
    deliver(ref, port, {"doc": changes_of(a2)})
    peers = [{**own_floor(port), "B": 1}]
    floor = peer_floor(port, "doc", peers, compaction.causal_floor)
    assert floor == peer_floor(ref, "doc", peers,
                               ref_compaction.causal_floor) == {}
    stats = compact_both(ref, port, {"doc": floor})["doc"]
    assert stats["elems_after"] == 3
    deliver(ref, port, {"doc": [c for c in changes_of(b2)
                                if c.actor == "B"]})
    assert_same_rows(ref, port)
    assert text_of(ref) == "".join(am.merge(a2, b2)["t"])


@pytest.mark.parametrize("native", [True, False])
def test_pins_protect_pending_round_anchors(native):
    d = build_history()
    ref, port = pair(["doc"], native)
    deliver(ref, port, {"doc": changes_of(d)})
    pinned = "alice:3"
    stats = compact_both(ref, port, {"doc": own_floor(port)},
                         pins={"doc": {pinned}})["doc"]
    assert pinned not in port.ghost_eids[0]
    assert stats["elems_after"] > 5
    # an insert at the pinned element admits
    text_obj = changes_of(d)[1].ops[0].obj
    c = Change("alice", len(changes_of(d)) + 1, {}, [
        Op("ins", text_obj, key=pinned, elem=500)])
    deliver(ref, port, {"doc": [c]}, "frames")
    assert_same_rows(ref, port)


@pytest.mark.parametrize("route,native", [
    ("rounds", False), ("rounds", True), ("cols", True), ("frames", True),
    ("frames", False)])
def test_anchor_at_compacted_element_rejected_preadmission(route, native):
    """Every ingress route rejects an insert anchored at a ghost before
    admission, with the reference's error, and stays usable."""
    d = build_history()
    ids = ["doc", "other"]
    ref, port = pair(ids, native)
    deliver(ref, port, {"doc": changes_of(d)})
    compact_both(ref, port, {"doc": own_floor(port)})
    assert port.ghost_eids[0]
    ghost = sorted(port.ghost_eids[0])[0]
    text_obj = changes_of(d)[1].ops[0].obj
    bad = Change("alice", len(changes_of(d)) + 1, {}, [
        Op("ins", text_obj, key=ghost, elem=999)])
    ok = Change("bob", 1, {}, [Op("set", ROOT_ID, key="x", value=1)])
    rnd = {"other": [ok], "doc": [bad]}
    logs = [len(log) for log in port.change_log]
    h0 = port.hashes()
    with pytest.raises(RefAnchorError) as ref_err:
        deliver(ref, port, rnd, route)
    port_rnd = {k: to_port(v) for k, v in rnd.items()}
    with pytest.raises(CompactionAnchorError) as err:
        if route == "rounds":
            port.apply_rounds([port_rnd])
        elif route == "cols":
            port.apply_rounds_cols([{k: changes_to_columns(v)
                                     for k, v in port_rnd.items()}])
        else:
            port.apply_round_frames([encode_round_frame(port_rnd)])
    assert str(err.value) == str(ref_err.value)
    assert err.value.doc_id == ref_err.value.doc_id == "doc"
    # before admission: no log grew, no hash moved, ingress goes on
    assert [len(log) for log in port.change_log] == logs
    np.testing.assert_array_equal(port.hashes(), h0)
    d2 = am.change(d, lambda x: x.__setitem__("ok", True))
    deliver(ref, port, {"doc": [changes_of(d2)[-1]], "other": [ok]}, route)
    assert_same_rows(ref, port)


def test_peer_floor_limits_then_allows_reclaim():
    d = build_history()
    chs = changes_of(d)
    ref, port = pair(["doc"])
    deliver(ref, port, {"doc": chs})
    floor = peer_floor(port, "doc", [{"alice": 2}], compaction.causal_floor)
    assert floor == {"alice": 2}
    stats = compact_both(ref, port, {"doc": floor})["doc"]
    assert stats["elems_after"] == 11      # the deletes are above it
    h0 = port.hashes()
    floor = peer_floor(port, "doc", [{"alice": chs[-1].seq}],
                       compaction.causal_floor)
    stats = compact_both(ref, port, {"doc": floor})["doc"]
    assert stats["elems_after"] == 5
    np.testing.assert_array_equal(port.hashes(), h0)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_causal_floor_and_compaction_on_concurrent_histories(native, seed):
    """Multi-actor histories with merges, delivered out of order over a
    few rounds: the causal floors, then every compaction at them, equal the
    reference's; so do later rounds on the compacted state."""
    ids = [f"doc{i}" for i in range(3)]
    per_doc = {d: history(seed * 10 + i, steps=30) for i, d in
               enumerate(ids)}
    rounds = split_rounds(per_doc, 4, np.random.default_rng(seed))
    ref, port = pair(ids, native)
    for k, rnd in enumerate(rounds):
        deliver(ref, port, rnd, ("rounds", "frames")[k % 2])
        floors = {}
        for i, d in enumerate(ids):
            f = compaction.causal_floor(port, i)
            assert f == ref_compaction.causal_floor(ref, i)
            floors[d] = f
        compact_both(ref, port, floors)


def test_keep_mask_and_floor_ranks_equal_the_reference():
    rng = np.random.default_rng(5)
    for _ in range(20):
        n, a = int(rng.integers(1, 40)), int(rng.integers(1, 5))
        om = rng.integers(0, 2, n).astype(np.int32)
        ac = rng.integers(0, 6, n).astype(np.int32)
        fid = rng.integers(0, 4, n).astype(np.int32)
        act = rng.integers(0, a, n).astype(np.int32)
        seq = rng.integers(1, 6, n).astype(np.int32)
        chg = rng.integers(0, 8, n).astype(np.int32)
        co = rng.integers(0, 6, (a, n)).astype(np.int32)
        floor_r = rng.integers(0, 6, a).astype(np.int64)
        np.testing.assert_array_equal(
            compaction._op_keep_mask(om, ac, fid, act, seq, chg, co,
                                     floor_r),
            ref_compaction._op_keep_mask(om, ac, fid, act, seq, chg, co,
                                         floor_r))


def _edit_round(d, rng, n_ins=8, n_del=8, n_sets=8):
    def step(x):
        t = x["t"]
        for _ in range(n_ins):
            t.insert_at(rng.randrange(len(t) + 1),
                        chr(97 + rng.randrange(26)))
        for _ in range(n_del):
            if len(t) > 1:
                t.delete_at(rng.randrange(len(t)))
        for k in range(n_sets):
            x[f"f{rng.randrange(4)}"] = rng.randrange(1000)
    return am.change(d, step)


def _budget_rule(rset, frame, budget_error, causal_floor):
    """The sync service's rule (reference sync/service.py
    `_apply_with_compaction`): on the budget error, compact every doc to
    its floor (no peers: the causal floor) and retry once. Returns whether
    it compacted."""
    try:
        rset.apply_round_frames([frame])
        return False
    except budget_error:
        stats = rset.compact({d: causal_floor(rset, i)
                              for i, d in enumerate(rset.doc_ids)})
        assert any(s["ops_after"] < s["ops_before"]
                   or s["elems_after"] < s["elems_before"]
                   for s in stats.values())
        rset.apply_round_frames([frame])
        return True


def test_soak_long_lived_doc_past_the_budget():
    """A single document keeps editing far past the envelope under the
    service's rule; both packages compact on the same rounds and hold equal
    hashes and row mirrors throughout, and bare engines fed the same
    history with no compaction hook both raise RowsBudgetError."""
    rng = random.Random(7)
    d = am.change(am.init("W"), lambda x: x.__setitem__("t", am.Text()))
    ref, port = pair(["doc"])
    deliver(ref, port, {"doc": changes_of(d)}, "frames")
    served = len(changes_of(d))
    total_ops = len(changes_of(d)[0].ops)
    compacted = []
    for r in range(60):
        d = _edit_round(d, rng)
        new = changes_of(d)[served:]
        served += len(new)
        total_ops += sum(len(c.ops) for c in new)
        c_ref = _budget_rule(ref, ref_encode_round_frame({"doc": new}),
                             RefBudgetError, ref_compaction.causal_floor)
        c_port = _budget_rule(port, encode_round_frame(
            {"doc": to_port(new)}), RowsBudgetError, compaction.causal_floor)
        assert c_port == c_ref, f"round {r}"
        compacted.append(c_port)
        np.testing.assert_array_equal(port.hashes(), ref.hashes())
    assert total_ops > ROWS_MAX_OPS and sum(compacted) >= 2
    assert_same_rows(ref, port)
    assert text_of(ref) == "".join(d["t"])
    all_chs = changes_of(d)
    bare_ref = RefRows(["doc"])
    with pytest.raises(RefBudgetError):
        for k in range(0, len(all_chs), 64):
            bare_ref.apply_rounds([{"doc": all_chs[k:k + 64]}])
    bare = ResidentRowsDocSet(["doc"], device="cpu")
    with pytest.raises(RowsBudgetError):
        for k in range(0, len(all_chs), 64):
            bare.apply_rounds([{"doc": to_port(all_chs[k:k + 64])}])
    np.testing.assert_array_equal(bare.op_count, bare_ref.op_count)


# ---------------------------------------------------------------------------
# seeded fuzz: random delivery with compaction (and archival) against the
# reference (tests/test_hypothesis_compaction.py at engine level)

ACTORS = ("A", "B", "C")
_EXAMPLES = int(os.environ.get("AMTPU_FUZZ_EXAMPLES", "8"))

_instr = st.tuples(
    st.sampled_from(ACTORS),
    st.sampled_from(("text_ins", "text_ins", "text_del", "set", "del",
                     "merge_from")),
    st.integers(min_value=0, max_value=30),
    st.integers(min_value=0, max_value=5),
)


def _clock_of(doc):
    clk: dict[str, int] = {}
    for c in changes_of(doc):
        if c.seq > clk.get(c.actor, 0):
            clk[c.actor] = c.seq
    return clk


def _run_program(instrs):
    base = am.change(am.init("A"), lambda x: x.__setitem__("t", am.Text()))
    reps = {a: (base if a == "A" else am.merge(am.init(a), base))
            for a in ACTORS}
    snaps = {a: [_clock_of(reps[a])] for a in ACTORS}
    for (actor, kind, pos, val) in instrs:
        d = reps[actor]
        if kind == "text_ins":
            d = am.change(d, lambda x, pos=pos, val=val: x["t"].insert_at(
                min(pos, len(x["t"])), chr(97 + (pos + val) % 26)))
        elif kind == "text_del":
            d = am.change(d, lambda x, pos=pos: (
                x["t"].delete_at(pos % len(x["t"]))
                if len(x["t"]) else x.__setitem__("noop", 1)))
        elif kind == "set":
            d = am.change(d, lambda x, pos=pos, val=val: x.__setitem__(
                f"f{val}", pos))
        elif kind == "del":
            key = f"f{val}"
            if key in d:
                d = am.change(d, lambda x, key=key: x.__delitem__(key))
            else:
                d = am.change(d, lambda x, val=val: x.__setitem__(
                    f"f{val}", -1))
        elif kind == "merge_from":
            src = ACTORS[val % len(ACTORS)]
            if src != actor:
                d = am.merge(d, reps[src])
        reps[actor] = d
        snaps[actor].append(_clock_of(d))
    merged = reps["A"]
    for a in ACTORS[1:]:
        merged = am.merge(merged, reps[a])
    return merged, snaps


def _fuzz(instrs, data, archive_root):
    merged, snaps = _run_program(instrs)
    all_changes = changes_of(merged)
    ref, port = pair(["doc"])
    if archive_root is not None:
        ref.log_archive = RefArchive(os.path.join(archive_root, "ref"))
        port.log_archive = LogArchive(os.path.join(archive_root, "port"))
    delivered_clock: dict[str, int] = {}
    pending = list(all_changes)
    adverts: dict[str, dict] = {}

    def ready(c):
        return c.seq == delivered_clock.get(c.actor, 0) + 1 and all(
            delivered_clock.get(a, 0) >= s for a, s in (c.deps or {}).items())

    while pending:
        rd = [c for c in pending if ready(c)]
        assert rd
        picks = data.draw(st.lists(
            st.integers(min_value=0, max_value=len(rd) - 1), min_size=1,
            max_size=min(4, len(rd)), unique=True), label="batch")
        batch = [rd[k] for k in sorted(picks)]
        route = data.draw(st.sampled_from(("rounds", "frames")),
                          label="route")
        deliver(ref, port, {"doc": batch}, route)
        for c in batch:
            delivered_clock[c.actor] = c.seq
            pending.remove(c)
        actions = ("none", "advert", "compact", "compact") + (
            ("archive",) if archive_root is not None else ())
        action = data.draw(st.sampled_from(actions), label="action")
        h = port.hashes()
        if action == "advert":
            a = data.draw(st.sampled_from(ACTORS), label="peer")
            adverts[a] = data.draw(st.sampled_from(snaps[a]), label="snap")
        elif action in ("compact", "archive"):
            floor = peer_floor(port, "doc", list(adverts.values()),
                               compaction.causal_floor)
            assert floor == peer_floor(ref, "doc", list(adverts.values()),
                                       ref_compaction.causal_floor)
            if action == "compact":
                stats = compact_both(ref, port, {"doc": floor})["doc"]
                assert stats["ops_after"] <= stats["ops_before"]
                assert stats["elems_after"] <= stats["elems_before"]
            elif floor:
                assert port.archive_log_prefix("doc", floor) == \
                    ref.archive_log_prefix("doc", floor)
                assert port.log_horizon == ref.log_horizon
                assert [len(x) for x in port.change_log] == \
                    [len(x) for x in ref.change_log]
            np.testing.assert_array_equal(port.hashes(), h)
    fresh = ResidentRowsDocSet(["doc"], device="cpu")
    fresh.apply_rounds([{"doc": to_port(all_changes)}])
    np.testing.assert_array_equal(port.hashes(), fresh.hashes())
    compact_both(ref, port, {"doc": own_floor(port)})
    np.testing.assert_array_equal(port.hashes(), fresh.hashes())
    assert text_of(ref) == "".join(merged["t"])


_fuzz_settings = settings(
    max_examples=_EXAMPLES, deadline=None, derandomize=True,
    database=None, suppress_health_check=[
        HealthCheck.too_slow, HealthCheck.data_too_large,
        HealthCheck.function_scoped_fixture])


@_fuzz_settings
@given(st.lists(_instr, min_size=4, max_size=30), st.data())
def test_compaction_under_random_delivery(instrs, data):
    _fuzz(instrs, data, None)


@_fuzz_settings
@given(st.lists(_instr, min_size=4, max_size=30), st.data())
def test_compaction_and_log_horizon_under_random_delivery(tmp_path, instrs,
                                                          data):
    root = tempfile.mkdtemp(dir=tmp_path)
    try:
        _fuzz(instrs, data, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
