"""Column and round-frame ingress of both engines: the port's
ResidentRowsDocSet (`apply_round_frames`, `apply_rounds_cols`,
`apply_rounds`) and ResidentDocSet (`apply_columns`,
`apply_and_reconcile_columns`) against the reference's, on the same seeded
change streams, each with the native encoder and with `native=False`.
The rows tests are tests/test_resident.py's TestResidentRows and
TestRoundFrames, ported (without the materialize ones: the rows engine's
`materialize` is not ported yet). Tolerance: exact (uint32 hashes, clocks,
frontiers and change counts)."""

import numpy as np
import pytest
import torch

import automerge_tpu as am
from automerge_tpu.engine.resident import ResidentDocSet as RefResident
from automerge_tpu.engine.resident_rows import ResidentRowsDocSet as RefRows
from automerge_tpu.sync.frames import (
    decode_frame as ref_decode_frame,
    encode_round_frame as ref_encode_round_frame)

from automerge_tpu_torch.engine import cuda_kernels
from automerge_tpu_torch.engine.cuda_kernels import hashes_to_numpy
from automerge_tpu_torch.engine.resident import ResidentDocSet
from automerge_tpu_torch.engine.resident_rows import ResidentRowsDocSet
from automerge_tpu_torch.native.wire import changes_to_columns
from automerge_tpu_torch.sync.frames import (decode_frame, decode_round_frame,
                                             encode_frame, encode_round_frame,
                                             round_from_columns)
from automerge_tpu_torch.utils import metrics
from automerge_tpu_torch.workloads import docset_fleet, text_fleet

from torch_port_helpers import rounds_to_port, to_port

NATIVE = pytest.mark.parametrize("native", [True, False],
                                 ids=["native", "python"])


def rows(ids, native):
    return ResidentRowsDocSet(ids, device="cpu", native=native)


def admission_rounds() -> dict:
    """The rows engine's rounds by admission route so far (its metrics
    counters)."""
    snap = metrics.snapshot()
    return {k: snap.get(k, 0)
            for k in ("rows_rounds_batched", "rows_rounds_fallback")}


def frame_hashes(engine, frames) -> np.ndarray:
    """apply_round_frames, then the returned device hashes read back."""
    h = engine.apply_round_frames(frames)
    assert h.dtype == torch.int32 and h.shape == (engine.n_pad,)
    return hashes_to_numpy(h)[:len(engine.doc_ids)]


def ref_frame_hashes(ref, rounds) -> np.ndarray:
    frames = [ref_encode_round_frame(r) for r in rounds]
    return np.asarray(ref.apply_round_frames(frames))[:len(ref.doc_ids)]


def mk_docs(n=4):
    docs, logs = [], []
    for i in range(n):
        d1 = am.change(am.init("A"), lambda d, i=i: am.assign(
            d, {"n": i, "xs": [1, 2]}))
        d2 = am.merge(am.init("B"), d1)
        d1 = am.change(d1, lambda d: d["xs"].insert_at(1, 99))
        d2 = am.change(d2, lambda d, i=i: d.__setitem__("n", -i))
        m = am.merge(d1, d2)
        docs.append(m)
        logs.append(m._doc.opset.get_missing_changes({}))
    return docs, logs


def deltas_of(docs, ids, edits):
    """edits: (doc_idx, fn) applied in order; one round of per-doc deltas
    (reference Change objects)."""
    deltas = {}
    for i, fn in edits:
        prev = docs[i]
        new = am.change(prev, fn)
        deltas.setdefault(ids[i], []).extend(
            new._doc.opset.get_missing_changes(prev._doc.opset.clock))
        docs[i] = new
    return deltas


def tables_equal(a, b) -> None:
    a.sync_tables()
    b.sync_tables()
    for ta, tb in zip(a.tables, b.tables):
        assert ta.clock == tb.clock
        assert ta.frontier == tb.frontier
        assert ta.n_changes == tb.n_changes


@NATIVE
class TestResidentRows:
    """apply_rounds: the port against the reference's engine with the same
    encoder, every round's row compared."""

    def _both(self, ids, native):
        return rows(ids, native), RefRows(ids, native=native)

    def _apply(self, port, ref, rounds):
        got = port.apply_rounds(rounds_to_port(rounds))
        np.testing.assert_array_equal(got, ref.apply_rounds(rounds))
        return got

    def test_rounds_converge_with_the_reference(self, native):
        docs, logs = mk_docs()
        ids = [f"d{i}" for i in range(len(docs))]
        port, ref = self._both(ids, native)
        self._apply(port, ref, [{ids[i]: logs[i] for i in range(len(ids))}])
        rounds = [deltas_of(docs, ids, [
            (i, lambda d, rnd=rnd, i=i: d.__setitem__("n", rnd * 100 + i))
            for i in (0, 2)]) for rnd in range(3)]
        hs = self._apply(port, ref, rounds)
        assert hs.shape == (3, len(ids))

    def test_new_actor_mid_flight_remaps(self, native):
        docs, logs = mk_docs(2)
        ids = ["d0", "d1"]
        port, ref = self._both(ids, native)
        self._apply(port, ref, [{ids[i]: logs[i] for i in range(2)}])
        prev = docs[0]
        other = am.merge(am.init("AA"), prev)   # A < AA < B: ranks shift
        other = am.change(other, lambda d: d.__setitem__("n", 777))
        merged = am.merge(prev, other)
        delta = merged._doc.opset.get_missing_changes(prev._doc.opset.clock)
        self._apply(port, ref, [{ids[0]: delta}])
        assert port.actors == ref.actors

    def test_capacity_growth_mid_batch(self, native):
        docs, logs = mk_docs(2)
        ids = ["d0", "d1"]
        port, ref = self._both(ids, native)
        self._apply(port, ref, [{ids[i]: logs[i] for i in range(2)}])
        cap_before = port.cap_ops
        rounds = [deltas_of(docs, ids, [
            (1, lambda d, rnd=rnd: d["xs"].insert_at(0, rnd))])
            for rnd in range(max(cap_before, 8))]
        self._apply(port, ref, rounds)
        assert port.cap_ops > cap_before

    def test_causal_buffering_across_rounds(self, native):
        docs, logs = mk_docs(1)
        ids = ["d0"]
        port, ref = self._both(ids, native)
        self._apply(port, ref, [{ids[0]: logs[0]}])
        prev = docs[0]
        s1 = am.change(prev, lambda d: d.__setitem__("a", 1))
        s2 = am.change(s1, lambda d: d.__setitem__("a", 2))
        c1 = s1._doc.opset.get_missing_changes(prev._doc.opset.clock)
        c2 = s2._doc.opset.get_missing_changes(s1._doc.opset.clock)
        h_before = port.hashes()
        hs = self._apply(port, ref, [{ids[0]: c2}, {ids[0]: c1}])
        np.testing.assert_array_equal(hs[0], h_before)

    def test_second_list_reserves_cap_lists(self, native):
        docs, logs = mk_docs(1)
        ids = ["d0"]
        port, ref = self._both(ids, native)
        self._apply(port, ref, [{ids[0]: logs[0]}])
        delta = deltas_of(docs, ids, [(0, lambda d: d.__setitem__(
            "ys", [7, 8]))])
        self._apply(port, ref, [delta])
        assert port.cap_lists >= 2

    def test_queued_changes_count_toward_reservation(self, native):
        docs, logs = mk_docs(1)
        ids = ["d0"]
        port, ref = self._both(ids, native)
        self._apply(port, ref, [{ids[0]: logs[0]}])
        prev = docs[0]
        # c2 has many ops and depends on c1; c2 first, so it queues
        s1 = am.change(prev, lambda d: d.__setitem__("k", 0))
        s2 = am.change(s1, lambda d: am.assign(
            d, {f"q{j}": j for j in range(12)}))
        c1 = s1._doc.opset.get_missing_changes(prev._doc.opset.clock)
        c2 = s2._doc.opset.get_missing_changes(s1._doc.opset.clock)
        self._apply(port, ref, [{ids[0]: c2}])     # buffers in the queue
        self._apply(port, ref, [{ids[0]: c1}])     # releases c1 AND c2
        assert int(port.op_count[0]) <= port.cap_ops
        assert not port._queued_docs

    def test_apply_rounds_cols_equals_apply_rounds(self, native):
        docs, logs = mk_docs(3)
        ids = [f"d{i}" for i in range(3)]
        a, b = rows(ids, native), rows(ids, native)
        boot = [{ids[i]: logs[i] for i in range(3)}]
        rounds = boot + [deltas_of(docs, ids, [
            (i, lambda d, rnd=rnd, i=i: d["xs"].insert_at(0, rnd + i))
            for i in range(3)]) for rnd in range(2)]
        port_rounds = rounds_to_port(rounds)
        got = a.apply_rounds_cols([
            {d: changes_to_columns(chs) for d, chs in r.items()}
            for r in port_rounds])
        np.testing.assert_array_equal(got, b.apply_rounds(port_rounds))
        tables_equal(a, b)


@NATIVE
class TestRoundFrames:
    """apply_round_frames: held to apply_rounds on a twin of the port, and
    to the reference's apply_round_frames with the same encoder."""

    def _twin_check(self, native, ids, logs, rounds):
        a, b = rows(ids, native), rows(ids, native)
        ref = RefRows(ids, native=native)
        boot = [{ids[i]: logs[i] for i in range(len(ids))}]
        for e in (a, b):
            e.apply_rounds(rounds_to_port(boot))
        ref.apply_rounds(boot)
        port_rounds = rounds_to_port(rounds)
        frames = [encode_round_frame(r) for r in port_rounds]
        assert frames == [ref_encode_round_frame(r) for r in rounds]
        h = frame_hashes(a, frames)
        hs = b.apply_rounds(port_rounds)
        np.testing.assert_array_equal(h, hs[-1])
        np.testing.assert_array_equal(h, ref_frame_hashes(ref, rounds))
        tables_equal(a, b)
        return a

    def test_in_order_rounds_match_apply_rounds(self, native):
        docs, logs = mk_docs(4)
        ids = [f"d{i}" for i in range(4)]
        rounds = [deltas_of(docs, ids, [
            (i, lambda d, rnd=rnd, i=i: d.__setitem__("n", rnd * 100 + i))
            for i in (0, 2, 3)]) for rnd in range(3)]
        self._twin_check(native, ids, logs, rounds)

    def test_in_order_chains_take_batched_path(self, native):
        """The streaming steady state (one actor's consecutive edits per
        doc across rounds) rides the whole-batch vectorized admission, not
        the per-round fallback, and still matches bit for bit."""
        docs, logs = mk_docs(3)
        ids = [f"d{i}" for i in range(3)]
        rounds = [deltas_of(docs, ids, [
            (i, lambda d, rnd=rnd, i=i: d.__setitem__("n", rnd * 10 + i))
            for i in range(3)]) for rnd in range(5)]
        port_rounds = rounds_to_port(rounds)
        a, b = rows(ids, native), rows(ids, native)
        boot = rounds_to_port([{ids[i]: logs[i] for i in range(3)}])
        a.apply_rounds(boot)
        b.apply_rounds(boot)
        # the boot merge leaves two heads, which the dense cache cannot
        # check coverage against: this first micro-batch may fall back
        frame_hashes(a, [encode_round_frame(port_rounds[0])])
        before = admission_rounds()
        h = frame_hashes(a, [encode_round_frame(r)
                             for r in port_rounds[1:]])
        moved = {k: v - before[k] for k, v in admission_rounds().items()}
        if native:
            assert moved == {"rows_rounds_batched": 4,
                             "rows_rounds_fallback": 0}
        else:
            # the Python encoder takes neither admission route
            assert moved == {"rows_rounds_batched": 0,
                             "rows_rounds_fallback": 0}
        hs = b.apply_rounds(port_rounds)
        np.testing.assert_array_equal(h, hs[-1])
        tables_equal(a, b)

    def test_out_of_order_rounds_buffer_and_release(self, native):
        docs, logs = mk_docs(1)
        prev = docs[0]
        s1 = am.change(prev, lambda d: d.__setitem__("a", 1))
        s2 = am.change(s1, lambda d: d.__setitem__("a", 2))
        c1 = s1._doc.opset.get_missing_changes(prev._doc.opset.clock)
        c2 = s2._doc.opset.get_missing_changes(s1._doc.opset.clock)
        self._twin_check(native, ["d0"], logs, [{"d0": c2}, {"d0": c1}])

    def test_queued_release_across_frames(self, native):
        """A change queued by one apply_round_frames call is released by a
        later one: the released payload lives in another frame."""
        docs, logs = mk_docs(1)
        ids = ["d0"]
        a, b = rows(ids, native), rows(ids, native)
        ref = RefRows(ids, native=native)
        for e in (a, b):
            e.apply_rounds(rounds_to_port([{ids[0]: logs[0]}]))
        ref.apply_rounds([{ids[0]: logs[0]}])
        prev = docs[0]
        s1 = am.change(prev, lambda d: d.__setitem__("x", 1))
        s2 = am.change(s1, lambda d: d.__setitem__("x", 2))
        c1 = s1._doc.opset.get_missing_changes(prev._doc.opset.clock)
        c2 = s2._doc.opset.get_missing_changes(s1._doc.opset.clock)
        frame_hashes(a, [encode_round_frame({ids[0]: to_port(c2)})])
        ref_frame_hashes(ref, [{ids[0]: c2}])
        assert a._queued_docs == {0}
        h = frame_hashes(a, [encode_round_frame({ids[0]: to_port(c1)})])
        assert a._queued_docs == set()
        hs = b.apply_rounds(rounds_to_port([{ids[0]: c2}, {ids[0]: c1}]))
        np.testing.assert_array_equal(h, hs[-1])
        np.testing.assert_array_equal(h, ref_frame_hashes(ref, [{ids[0]: c1}]))

    def test_unknown_dep_actor_queues_instead_of_crashing(self, native):
        """A change whose declared dep names an actor the set has never
        seen queues, and is released when the dep arrives."""
        docs, logs = mk_docs(1)
        ids = ["d0"]
        a, b = rows(ids, native), rows(ids, native)
        for e in (a, b):
            e.apply_rounds(rounds_to_port([{ids[0]: logs[0]}]))
        prev = docs[0]
        y = am.change(am.merge(am.init("Y"), prev),
                      lambda d: d.__setitem__("w", 1))
        z = am.change(am.merge(am.init("Z"), y),
                      lambda d: d.__setitem__("w", 2))
        cy = y._doc.opset.get_missing_changes(prev._doc.opset.clock)
        cz = z._doc.opset.get_missing_changes(y._doc.opset.clock)
        frame_hashes(a, [encode_round_frame({ids[0]: to_port(cz)})])
        assert a._queued_docs == {0}
        h = frame_hashes(a, [encode_round_frame({ids[0]: to_port(cy)})])
        assert a._queued_docs == set()
        hs = b.apply_rounds(rounds_to_port([{ids[0]: cz}, {ids[0]: cy}]))
        np.testing.assert_array_equal(h, hs[-1])

    def test_empty_doc_entry_is_a_noop(self, native):
        """A doc mapped to no change in a round frame is left as it was
        (and steals no neighbour's change), first or last in the frame."""
        docs, logs = mk_docs(2)
        ids = ["d0", "d1"]
        a, b = rows(ids, native), rows(ids, native)
        boot = rounds_to_port([{ids[i]: logs[i] for i in range(2)}])
        a.apply_rounds(boot)
        b.apply_rounds(boot)
        clock_before = dict(a.tables[0].clock)
        nc_before = a.tables[0].n_changes
        c1 = to_port(deltas_of(docs, ids, [(1, lambda d: d.__setitem__(
            "n", 123))])[ids[1]])
        h = frame_hashes(a, [encode_round_frame({ids[0]: [], ids[1]: c1})])
        assert a.tables[0].clock == clock_before
        assert a.tables[0].n_changes == nc_before
        np.testing.assert_array_equal(h, b.apply_rounds([{ids[1]: c1}])[-1])
        c2 = to_port(deltas_of(docs, ids, [(1, lambda d: d.__setitem__(
            "n", 456))])[ids[1]])
        h = frame_hashes(a, [encode_round_frame({ids[1]: c2, ids[0]: []})])
        np.testing.assert_array_equal(h, b.apply_rounds([{ids[1]: c2}])[-1])

    def test_duplicate_delivery_is_idempotent(self, native):
        docs, logs = mk_docs(1)
        c = deltas_of(docs, ["d0"], [(0, lambda d: d.__setitem__("z", 9))])
        self._twin_check(native, ["d0"], logs, [c, c])

    def test_new_actor_in_round_frame(self, native):
        docs, logs = mk_docs(2)
        prev = docs[0]
        other = am.merge(am.init("AA"), prev)  # rank shifts: A < AA < B
        other = am.change(other, lambda d: d.__setitem__("n", 777))
        merged = am.merge(prev, other)
        delta = merged._doc.opset.get_missing_changes(prev._doc.opset.clock)
        self._twin_check(native, ["d0", "d1"], logs, [{"d0": delta}])

    def test_concurrent_heads_fall_back_to_slow_path(self, native):
        """Two concurrent changes, then a merge change whose deps only
        partly cover the frontier at admission: the closure walk runs (the
        fast path must not claim the full clock)."""
        docs, logs = mk_docs(1)
        prev = docs[0]
        x = am.change(am.merge(am.init("X"), prev),
                      lambda d: d.__setitem__("n", 1))
        y = am.change(am.merge(am.init("Y"), prev),
                      lambda d: d.__setitem__("n", 2))
        m = am.change(am.merge(x, y), lambda d: d.__setitem__("n", 3))
        delta = m._doc.opset.get_missing_changes(prev._doc.opset.clock)
        self._twin_check(native, ["d0"], logs, [{"d0": delta}])

    def test_list_edits_relinearize(self, native):
        docs, logs = mk_docs(1)
        rounds = [deltas_of(docs, ["d0"], [
            (0, lambda d, rnd=rnd: d["xs"].insert_at(0, rnd * 10))])
            for rnd in range(3)]
        self._twin_check(native, ["d0"], logs, rounds)

    def test_round_frame_wire_roundtrip(self, native):
        docs, logs = mk_docs(2)
        deltas = {"a": to_port(logs[0]), "b": to_port(logs[1])}
        rc = decode_round_frame(encode_round_frame(deltas))
        assert rc.doc_ids == ["a", "b"]
        out = rc.to_dict()
        for k in deltas:
            assert [c.to_dict() for c in out[k]] \
                == [c.to_dict() for c in deltas[k]]

    def test_lazy_dispatch_defers_the_device_work(self, native):
        """Under lazy_dispatch a frame launches nothing and returns None;
        the next read reconciles only the dirty lanes and equals the eager
        twin's hashes."""
        docs, logs = mk_docs(3)
        ids = [f"d{i}" for i in range(3)]
        lazy, eager = rows(ids, native), rows(ids, native)
        boot = rounds_to_port([{ids[i]: logs[i] for i in range(3)}])
        lazy.apply_rounds(boot)
        eager.apply_rounds(boot)
        lazy.lazy_dispatch = True
        frame = encode_round_frame(to_port_round(deltas_of(
            docs, ids, [(1, lambda d: d["xs"].insert_at(0, 5))])))
        before = cuda_kernels.LAUNCHES["reconcile_rows_hash"]
        assert lazy.apply_round_frames([frame]) is None
        assert cuda_kernels.LAUNCHES["reconcile_rows_hash"] == before
        assert lazy._doc_dirty == {1}
        want = frame_hashes(eager, [frame])
        np.testing.assert_array_equal(lazy.hashes(), want)

    def test_reference_parity_on_fleets(self, native):
        """The port's frames of seeded fleets give the reference's final
        hashes (text fleet: concurrent typists, queues and list
        re-linearization; docset fleet: one-op rounds and a new actor)."""
        tids, trounds = text_fleet(n_docs=6, chars=12)
        ids, initial, drounds = docset_fleet(n_docs=12, rounds=3)
        for doc_ids, rounds in ((tids, trounds),
                                (ids, [initial] + drounds)):
            port = rows(doc_ids, native)
            ref = RefRows(doc_ids, native=native)
            ref_rounds = [{d: from_port(chs) for d, chs in r.items()}
                          for r in rounds]
            got = frame_hashes(port, [encode_round_frame(r) for r in rounds])
            np.testing.assert_array_equal(
                got, ref_frame_hashes(ref, ref_rounds))


def to_port_round(r):
    return {d: to_port(chs) for d, chs in r.items()}


def from_port(changes):
    """Port Change objects as the reference's (through the wire dict)."""
    from automerge_tpu.core.change import Change as RefChange
    return [RefChange.from_dict(c.to_dict()) for c in changes]


def test_frames_decoded_by_the_reference_drive_the_port():
    """A round built by the reference and decoded by the port, and a
    coalesced round built from per-doc columns, give the same hashes."""
    docs, logs = mk_docs(3)
    ids = [f"d{i}" for i in range(3)]
    rnd = {ids[i]: logs[i] for i in range(3)}
    a, b = rows(ids, True), rows(ids, True)
    h = frame_hashes(a, [ref_encode_round_frame(rnd)])
    rc = round_from_columns({d: decode_frame(encode_frame(to_port(chs)))
                             for d, chs in rnd.items()})
    np.testing.assert_array_equal(h, frame_hashes(b, [rc]))


# ---------------------------------------------------------------------------
# docs-major column ingress

def rich_trace():
    d = am.change(am.init("A"), lambda d: am.assign(d, {
        "i": 7, "f": 3.25, "b": True, "s": "héllo\ud800", "big": 2 ** 70,
        "null": None, "neg": -1.5, "nest": {"deep": [1, "two", False]}}))
    d = am.change(d, lambda doc: doc.__delitem__("i"))
    d = am.change(d, lambda doc: doc.__setitem__("t", am.Text()))
    d = am.change(d, "msg", lambda doc: doc["t"].insert_at(0, *"abc"))
    e = am.merge(am.init("B"), d)
    e = am.change(e, lambda doc: doc["t"].delete_at(1))
    e = am.change(e, lambda doc: doc.__setitem__("s", "overwrite"))
    m = am.merge(d, e)
    return m._doc.opset.get_missing_changes({})


@NATIVE
def test_apply_columns_equals_apply_changes_and_the_reference(native):
    chs = rich_trace()
    via_cols = ResidentDocSet(["d"], device="cpu", native=native)
    via_chs = ResidentDocSet(["d"], device="cpu", native=native)
    ref = RefResident(["d"], native=native)
    via_cols.apply_columns({"d": decode_frame(encode_frame(to_port(chs)))})
    via_chs.apply_changes({"d": to_port(chs)})
    ref.apply_columns({"d": ref_decode_frame(encode_frame(to_port(chs)))})
    want = ref.reconcile()
    np.testing.assert_array_equal(via_cols.reconcile(), want)
    np.testing.assert_array_equal(via_chs.reconcile(), want)
    assert via_cols.materialize("d") == via_chs.materialize("d") \
        == ref.materialize("d")


@NATIVE
def test_apply_and_reconcile_columns_rounds(native):
    """Rounds with queueing, duplicates and a released tail through
    apply_and_reconcile_columns equal apply_and_reconcile and the
    reference, round by round."""
    chs = rich_trace()
    cols_e = ResidentDocSet(["d", "e"], device="cpu", native=native)
    chs_e = ResidentDocSet(["d", "e"], device="cpu", native=native)
    ref = RefResident(["d", "e"], native=native)
    for rs in (chs[3:], chs[:3], chs):     # tail queues; last = duplicates
        rnd = {"d": to_port(rs), "e": to_port(rs[::-1])}
        cols = {k: changes_to_columns(v) for k, v in rnd.items()}
        want = ref.apply_and_reconcile_columns(
            {k: ref_decode_frame(encode_frame(v)) for k, v in rnd.items()})
        np.testing.assert_array_equal(
            cols_e.apply_and_reconcile_columns(cols), want)
        np.testing.assert_array_equal(chs_e.apply_and_reconcile(rnd), want)
    for t_a, t_b in zip(cols_e.tables, chs_e.tables):
        assert t_a.clock == t_b.clock and t_a.frontier == t_b.frontier
        assert t_a.n_changes == t_b.n_changes


def test_admitted_refs_materialize():
    """last_admitted's lazy refs rebuild the exact Change objects."""
    chs = to_port(rich_trace())
    nat = ResidentDocSet(["d"], device="cpu")
    nat.apply_columns({"d": changes_to_columns(chs)})
    assert [r.change() for r in nat.last_admitted["d"]] == chs


@NATIVE
def test_docset_fleet_columns_equal_the_rows_engine(native):
    """The docset fleet through apply_and_reconcile_columns (per-doc
    columns decoded from frames), apply_and_reconcile, and the rows
    engine's apply_round_frames: one set of hashes."""
    ids, initial, rounds = docset_fleet(n_docs=24, rounds=3)
    cols_e = ResidentDocSet(ids, device="cpu", native=native)
    chs_e = ResidentDocSet(ids, device="cpu", native=native)
    for rnd in [initial] + rounds:
        got = cols_e.apply_and_reconcile_columns(
            {d: decode_frame(encode_frame(c)) for d, c in rnd.items()})
        np.testing.assert_array_equal(got, chs_e.apply_and_reconcile(rnd))
    r = rows(ids, native)
    np.testing.assert_array_equal(
        frame_hashes(r, [encode_round_frame(x) for x in [initial] + rounds]),
        got)


@NATIVE
def test_first_actor_after_upload_refreshes_the_device_copy(native):
    """The port's guard against the reference's stale actor-hash band
    (ROADMAP Queue C) holds on the frame path: a read uploads the buffer
    before any actor, then the first frame's actor must reach the device
    copy; the hashes equal a fresh reference instance's."""
    from automerge_tpu.core.change import Change as RefChange, Op as RefOp
    ids = ["s0", "s1", "s2"]
    rnd = {"s0": [RefChange("x", 1, {}, [RefOp("set", am.ROOT_ID, key="k",
                                               value=1)])]}
    fresh = RefRows(ids, native=native).apply_rounds([rnd])[-1]
    port = rows(ids, native)
    port.hashes()
    assert port.rows_dev is not None
    np.testing.assert_array_equal(
        frame_hashes(port, [encode_round_frame(to_port_round(rnd))]), fresh)


@NATIVE
def test_rows_hashes_clean_follows_the_hash_handle(native):
    """The rows engine's hashes_clean (the docs-major test plus the
    flush-time hash handle): False while a frame's device hashes are
    unread (the port's apply_round_frames returns them unread; the
    reference's reads them back itself), True once hashes() has read them,
    as the reference's is then."""
    ids, initial, drounds = docset_fleet(n_docs=6, rounds=2)
    port, ref = rows(ids, native), RefRows(ids, native=native)
    assert not port.hashes_clean and not ref.hashes_clean
    for rnd in [initial] + drounds:
        port.apply_round_frames([encode_round_frame(rnd)])
        ref.apply_round_frames([ref_encode_round_frame(
            {d: from_port(chs) for d, chs in rnd.items()})])
        assert port._hash_handle is not None and not port.hashes_clean
        np.testing.assert_array_equal(port.hashes(), ref.hashes())
        assert port.hashes_clean and ref.hashes_clean
