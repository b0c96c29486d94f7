"""Failure recovery of the port's rows engine against the reference's: the
engine cases of tests/test_dispatch_failure.py (a pure dispatch failure, a
readback failure, a mid-admission failure that rebuilds from the log, a
partial admission replayed and deduped, poisoning where a rebuild is
impossible, a pre-admission failure), the chunked replay of a compacted
long-lived document whose history exceeds the envelope, and what a rebuild
keeps (its device, its attachments, a monotonic hash epoch). The same fault
is injected into both packages (the port on device="cpu") and their state
after it is compared.

Tolerance: exact (hashes, row mirrors, log lengths, error flags). Metrics
counters are compared as deltas."""

import numpy as np
import pytest
import torch

import automerge_tpu as am
from automerge_tpu.engine import compaction as ref_compaction
from automerge_tpu.engine.resident_rows import (
    DeviceDispatchError as RefDispatchError, ResidentRowsDocSet as RefRows,
    RowsBudgetError as RefBudgetError)
from automerge_tpu.sync.frames import (
    encode_round_frame as ref_encode_round_frame)

from automerge_tpu_torch.engine import compaction
from automerge_tpu_torch.engine.resident_rows import (
    DeviceDispatchError, ResidentRowsDocSet, RowsBudgetError)
from automerge_tpu_torch.sync.frames import encode_round_frame
from automerge_tpu_torch.utils import metrics
from automerge_tpu_torch.workloads import long_lived_changes

from torch_port_helpers import (assert_same_rows, build_history, changes_of,
                                to_port)


def make_doc(i):
    d = am.change(am.init("W"), lambda x, i=i: am.assign(
        x, {"n": i, "xs": [i, i + 1]}))
    return changes_of(d)


def pair(ids, native=True):
    return (RefRows(ids, native=native),
            ResidentRowsDocSet(ids, device="cpu", native=native))


def frames_of(rnd):
    return (ref_encode_round_frame(rnd),
            encode_round_frame({d: to_port(c) for d, c in rnd.items()}))


def boom(*a, **k):
    raise MemoryError("grow failed mid-scatter")


def fail_after_admission(monkeypatch, rset, native: bool) -> str:
    """Make rset's next apply fail after part of it was admitted into the
    change log: the native route's triplet assembly raises; on the Python
    encoder (which admits doc by doc inside the triplet pass) the first
    doc's encode runs, then a list's re-linearization or the next doc's
    encode raises. Returns the name of a patched method."""
    if native:
        monkeypatch.setattr(rset, "_cols_triplets", boom)
        return "_cols_triplets"
    real = rset._encode_delta
    calls = []

    def first_only(*a, **k):
        calls.append(1)
        if len(calls) > 1:
            boom()
        return real(*a, **k)
    monkeypatch.setattr(rset, "_encode_delta", first_only)
    monkeypatch.setattr(rset, "_linearized_pos_rows", boom)
    return "_encode_delta"


def oracle(ids, per_doc):
    """A fresh port instance fed every change at once."""
    full = ResidentRowsDocSet(ids, device="cpu")
    full.apply_rounds([{d: to_port(c) for d, c in per_doc.items()}])
    return full.hashes()


def test_dispatch_failure_keeps_admission_and_recovers(monkeypatch):
    ids = ["d0", "d1"]
    ref, port = pair(ids)
    chs0 = make_doc(0)
    f_ref, f_port = frames_of({"d0": chs0})
    ref.apply_round_frames([f_ref])
    port.apply_round_frames([f_port])
    chs1 = make_doc(1)
    f_ref, f_port = frames_of({"d1": chs1})
    for rset in (ref, port):
        monkeypatch.setattr(rset, "_dispatch_final", boom)
    with pytest.raises(RefDispatchError) as ref_err:
        ref.apply_round_frames([f_ref])
    with pytest.raises(DeviceDispatchError) as err:
        port.apply_round_frames([f_port])
    assert err.value.admission_complete and ref_err.value.admission_complete
    monkeypatch.undo()
    assert port.rows_dev is None and port._dirty
    assert len(port.change_log[1]) == len(chs1)
    port.sync_tables()
    assert port.tables[1].clock == {"W": len(chs1)}
    # replaying the admitted round is a duplicate-drop
    port.apply_round_frames([f_port])
    ref.apply_round_frames([f_ref])
    assert len(port.change_log[1]) == len(chs1)
    assert_same_rows(ref, port)
    np.testing.assert_array_equal(
        port.hashes(), oracle(ids, {"d0": chs0, "d1": chs1}))


def test_readback_failure_recovers_at_next_read():
    ids = ["d0"]
    ref, port = pair(ids)
    f_ref, f_port = frames_of({"d0": make_doc(5)})
    ref.apply_round_frames([f_ref])
    port.apply_round_frames([f_port])

    class BoomHandle:
        def __array__(self, *a, **k):
            raise RuntimeError("lost during readback")

        def cpu(self):
            raise RuntimeError("lost during readback")

    ref._hash_handle = BoomHandle()
    port._hash_handle = BoomHandle()
    with pytest.raises(RefDispatchError):
        ref.hashes()
    with pytest.raises(DeviceDispatchError) as err:
        port.hashes()
    assert err.value.admission_complete
    assert port.rows_dev is None and port._dirty
    assert_same_rows(ref, port)


@pytest.mark.parametrize("route,native", [("frames", True), ("rounds", True),
                                          ("rounds", False)])
def test_midadmission_failure_rebuilds_from_log(monkeypatch, route, native):
    ids = ["d0", "d1"]
    ref, port = pair(ids, native)
    chs0, chs1 = make_doc(0), make_doc(1)
    ref.apply_rounds([{"d0": chs0}])
    port.apply_rounds([{"d0": to_port(chs0)}])
    for rset in (ref, port):
        name = fail_after_admission(monkeypatch, rset, native)
    before = metrics.snapshot().get("rows_log_rebuilt", 0)
    f_ref, f_port = frames_of({"d1": chs1})
    with pytest.raises(RefDispatchError) as ref_err:
        if route == "frames":
            ref.apply_round_frames([f_ref])
        else:
            ref.apply_rounds([{"d1": chs1}])
    with pytest.raises(DeviceDispatchError) as err:
        if route == "frames":
            port.apply_round_frames([f_port])
        else:
            port.apply_rounds([{"d1": to_port(chs1)}])
    assert not err.value.admission_complete
    assert not ref_err.value.admission_complete
    assert isinstance(err.value.__cause__, MemoryError)
    assert metrics.snapshot()["rows_log_rebuilt"] == before + 1
    # the rebuild swapped in fresh internals (the patch is gone) with the
    # admitted changes in the log
    assert name not in port.__dict__ and port._poisoned is None
    assert len(port.change_log[1]) == len(chs1)
    assert_same_rows(ref, port)
    # replaying the whole round admits nothing twice
    port.apply_round_frames([f_port])
    ref.apply_round_frames([f_ref])
    assert len(port.change_log[1]) == len(chs1)
    assert_same_rows(ref, port)
    np.testing.assert_array_equal(port.hashes(),
                                  oracle(ids, {"d0": chs0, "d1": chs1}))


def test_partial_admission_replayed_and_deduped():
    """A round whose admission stopped after doc a: the caller replays the
    whole round; a's changes drop as duplicates and only b's admit."""
    ids = ["a", "b"]
    ref, port = pair(ids)
    chs_a, chs_b = make_doc(1), make_doc(2)
    f_ref, f_port = frames_of({"a": chs_a})
    ref.apply_round_frames([f_ref])
    port.apply_round_frames([f_port])
    assert [len(x) for x in port.change_log] == [len(chs_a), 0]
    f_ref, f_port = frames_of({"a": chs_a, "b": chs_b})
    ref.apply_round_frames([f_ref])
    port.apply_round_frames([f_port])
    assert [len(x) for x in port.change_log] == [len(chs_a), len(chs_b)]
    assert_same_rows(ref, port)
    np.testing.assert_array_equal(port.hashes(),
                                  oracle(ids, {"a": chs_a, "b": chs_b}))


def test_poisoned_when_rebuild_is_impossible(monkeypatch):
    """A failure inside a rebuild's replay is deterministic: the instance
    fails loudly on every later apply and read, in both packages."""
    ids = ["d0"]
    ref, port = pair(ids)
    f_ref, f_port = frames_of({"d0": make_doc(1)})
    before = metrics.snapshot().get("rows_engine_poisoned", 0)
    for rset, frame, err in ((ref, f_ref, MemoryError),
                             (port, f_port, MemoryError)):
        rset._rebuilding = True
        monkeypatch.setattr(rset, "_cols_triplets", boom)
        with pytest.raises(err):
            rset.apply_round_frames([frame])
        with pytest.raises(RuntimeError, match="no longer reflects"):
            rset.hashes()
        with pytest.raises(RuntimeError, match="no longer reflects"):
            rset.apply_round_frames([frame])
        with pytest.raises(RuntimeError, match="no longer reflects"):
            rset.compact({"d0": {}})
    assert metrics.snapshot()["rows_engine_poisoned"] == before + 1


def test_preadmission_failure_leaves_the_instance_usable(monkeypatch):
    ids = ["d3"]
    ref, port = pair(ids)
    chs = make_doc(3)
    f_ref, f_port = frames_of({"d3": chs})

    def precheck_boom(*a, **k):
        raise RuntimeError("batch would blow the budget")
    for rset in (ref, port):
        monkeypatch.setattr(rset, "_precheck_round_frames", precheck_boom)
    with pytest.raises(RuntimeError, match="blow the budget"):
        ref.apply_round_frames([f_ref])
    with pytest.raises(RuntimeError, match="blow the budget"):
        port.apply_round_frames([f_port])
    monkeypatch.undo()
    assert port.change_log == [[]] and port._rebuild_gen == 0
    ref.apply_round_frames([f_ref])
    port.apply_round_frames([f_port])
    assert_same_rows(ref, port)
    # a real budget error is pre-admission too
    big = [{"d3": [am.change(am.init("Z"), lambda x: am.assign(
        x, {f"k{j}": j for j in range(600)}))._doc.opset
        .get_missing_changes({})[0]]}]
    with pytest.raises(RefBudgetError):
        ref.apply_rounds(big)
    with pytest.raises(RowsBudgetError):
        port.apply_rounds([{d: to_port(c) for d, c in big[0].items()}])
    assert len(port.change_log[0]) == len(chs) and port._rebuild_gen == 0
    assert_same_rows(ref, port)


def _budget_rule(rset, frame, budget_error, causal_floor):
    """The sync service's rule on the budget error: compact every doc to
    its causal floor and retry once."""
    try:
        rset.apply_round_frames([frame])
    except budget_error:
        rset.compact({d: causal_floor(rset, i)
                      for i, d in enumerate(rset.doc_ids)})
        rset.apply_round_frames([frame])


@pytest.mark.parametrize("native", [True, False])
def test_rebuild_of_a_long_lived_doc_replays_in_chunks(monkeypatch, native):
    """A long-lived fleet whose history exceeds the envelope (kept inside it
    by compaction under the service's rule) rebuilds through the chunked
    replay, compacting to the stored floors between chunks: the rebuilt
    row mirror, hashes and stats equal the reference's under the same
    fault."""
    ids = [f"doc{j}" for j in range(3)]
    ref, port = pair(ids, native)
    for lo in range(1, 1201, 200):
        rnd = {d: [c for c in long_lived_changes(j, lo, lo + 199)]
               for j, d in enumerate(ids)}
        ref_rnd = {d: [_to_ref(c) for c in chs] for d, chs in rnd.items()}
        _budget_rule(ref, ref_encode_round_frame(ref_rnd), RefBudgetError,
                     ref_compaction.causal_floor)
        _budget_rule(port, encode_round_frame(rnd), RowsBudgetError,
                     compaction.causal_floor)
    assert port.compaction_floors == ref.compaction_floors != {}
    assert_same_rows(ref, port)
    h0 = port.hashes()
    for rset in (ref, port):
        fail_after_admission(monkeypatch, rset, native)
    tail = {d: long_lived_changes(j, 1201, 1210) for j, d in enumerate(ids)}
    calls = []
    real = ResidentRowsDocSet._replay_chunked
    monkeypatch.setattr(ResidentRowsDocSet, "_replay_chunked",
                        lambda self, *a, **k: (calls.append(1),
                                               real(self, *a, **k))[1])
    with pytest.raises(RefDispatchError):
        ref.apply_rounds([{d: [_to_ref(c) for c in chs]
                           for d, chs in tail.items()}])
    with pytest.raises(DeviceDispatchError) as err:
        port.apply_rounds([tail])
    assert not err.value.admission_complete and calls == [1]
    assert [len(x) for x in port.change_log] == \
        [len(x) for x in ref.change_log]
    assert_same_rows(ref, port)
    # the caller replays the round under its rule: what the failure cut
    # off admits (Change rounds: a frame that admits nothing would meet
    # the reference's megabatch fault, ROADMAP Queue C)
    ref_tail = {d: [_to_ref(c) for c in chs] for d, chs in tail.items()}
    for rset, rnd, err, floor_of in (
            (ref, ref_tail, RefBudgetError, ref_compaction.causal_floor),
            (port, tail, RowsBudgetError, compaction.causal_floor)):
        try:
            rset.apply_rounds([rnd])
        except err:
            rset.compact({d: floor_of(rset, i) for i, d in enumerate(ids)})
            rset.apply_rounds([rnd])
    assert [len(x) for x in port.change_log] == [1210] * 3
    assert_same_rows(ref, port)
    assert (port.hashes() != h0).all()
    full = ResidentRowsDocSet(ids, device="cpu")
    for lo in range(1, 1211, 100):
        full.compact({d: compaction.causal_floor(full, i)
                      for i, d in enumerate(ids)})
        full.apply_rounds([{d: long_lived_changes(j, lo, min(lo + 99, 1210))
                            for j, d in enumerate(ids)}])
    np.testing.assert_array_equal(port.hashes(), full.hashes())


def _to_ref(c):
    from automerge_tpu.core.change import Change as RefChange
    return RefChange.from_dict(c.to_dict())


def test_rebuild_after_compaction_of_a_text_doc(monkeypatch):
    """A compacted text doc (ghosts in its insert log) rebuilds from its
    full log; the rebuilt state equals the reference's under the same
    fault (tests/test_compaction.py's rebuild case)."""
    d = build_history()
    ref, port = pair(["doc"])
    ref.apply_rounds([{"doc": changes_of(d)}])
    port.apply_rounds([{"doc": to_port(changes_of(d))}])
    port.sync_tables()
    floor = {"doc": dict(port.tables[0].clock)}
    assert port.compact(floor) == ref.compact(floor)
    for rset in (ref, port):
        monkeypatch.setattr(rset, "_cols_triplets", boom)
    d2 = am.change(d, lambda x: x.__setitem__("post", 1))
    new = changes_of(d2)[-1:]
    with pytest.raises(RefDispatchError):
        ref.apply_rounds([{"doc": new}])
    with pytest.raises(DeviceDispatchError):
        port.apply_rounds([{"doc": to_port(new)}])
    assert_same_rows(ref, port)
    assert port.compaction_floors == ref.compaction_floors == floor
    assert "".join(ref.materialize("doc")["data"]["t"]) == "world"


def test_rebuild_keeps_the_device_and_the_attachments(monkeypatch):
    """The rebuilt instance stays on the caller's device, keeps its
    archive, snapshot store, floors and lazy dispatch, and its hash epoch
    only grows."""
    ids = ["d0", "d1"]
    chs0, chs1 = make_doc(0), make_doc(1)
    port = ResidentRowsDocSet(ids, device="cpu")
    port.apply_rounds([{"d0": to_port(chs0)}])
    port.lazy_dispatch = True
    port.log_archive = archive = object()
    port.snapshot_store = store = object()
    port.compaction_floors = {"d0": {"W": 1}}
    epoch = port.hash_epoch
    seen = []
    real_init = ResidentRowsDocSet.__init__

    def spy(self, *a, **k):
        seen.append(k.get("device"))
        real_init(self, *a, **k)
    monkeypatch.setattr(ResidentRowsDocSet, "__init__", spy)
    monkeypatch.setattr(port, "_cols_triplets", boom)
    with pytest.raises(DeviceDispatchError):
        port.apply_rounds([{"d1": to_port(chs1)}])
    assert seen == [torch.device("cpu")]
    assert port.device == torch.device("cpu")
    assert port.rows_dev is None or port.rows_dev.device.type == "cpu"
    assert port.lazy_dispatch and port.log_archive is archive
    assert port.snapshot_store is store
    assert port.compaction_floors == {"d0": {"W": 1}}
    assert port.hash_epoch > epoch and port._rebuild_gen == 1
    assert not port._rebuilding
    np.testing.assert_array_equal(
        port.hashes(), oracle(ids, {"d0": chs0, "d1": chs1}))


@pytest.mark.parametrize("native", [False, True])
def test_encode_failure_after_admit_matches_the_reference_fault(native):
    """A fault of the reference, reproduced (ROADMAP Queue C). On the
    Python encoder a change that fails inside the delta encode after its
    causal admission (here a move into an unknown object) leaves the doc's
    clock advanced and its change log empty, so the guard neither rebuilds
    nor poisons, and a corrected redelivery of the same (actor, seq) drops
    as a duplicate. On the native encoder the change was logged before the
    encode failed: the rebuild's replay meets it again and both packages
    poison."""
    from automerge_tpu.core.change import Change as RefChange, Op as RefOp
    from automerge_tpu.core.ids import ROOT_ID
    bad = RefChange("A", 1, {}, [
        RefOp("set", ROOT_ID, key="k", value=1),
        RefOp("move", "nowhere", key="x", value="obj")])
    good = RefChange("A", 1, {}, [RefOp("set", ROOT_ID, key="k", value=1)])
    ref, port = pair(["d"], native=native)
    err = ValueError if native else KeyError
    with pytest.raises(err):
        ref.apply_rounds([{"d": [bad]}])
    with pytest.raises(err):
        port.apply_rounds([{"d": to_port([bad])}])
    if native:
        for rset in (ref, port):
            with pytest.raises(RuntimeError, match="no longer reflects"):
                rset.hashes()
        return
    ref.apply_rounds([{"d": [good]}])
    port.apply_rounds([{"d": to_port([good])}])
    assert port.change_log == ref.change_log == [[]]
    assert port._poisoned is None and port._rebuild_gen == 0
    assert_same_rows(ref, port)
