"""The docs-major resident engine: the port's ResidentDocSet (device="cpu",
so its reconcile runs the B5 kernel's plain version) against the
reference's ResidentDocSet (pure-Python ingress) fed the same changes, and
against the port's own from-scratch `apply_batch` and the reference
oracle. The tests of tests/test_resident.py's TestResidentParity and
TestReserve, ported; then materialize, hashes_for, add_docs and the
docset fleet. Tolerance: exact (uint32 hashes, decoded states)."""

import numpy as np

import automerge_tpu as am
from automerge_tpu.engine.batchdoc import oracle_state as ref_oracle_state
from automerge_tpu.engine.resident import ResidentDocSet as RefResident
from automerge_tpu.frontend.materialize import apply_changes_to_doc

from automerge_tpu_torch.engine import cuda_kernels
from automerge_tpu_torch.engine.batchdoc import (BatchedDocSet, apply_batch,
                                                 decode_doc, doc_outputs,
                                                 oracle_state)
from automerge_tpu_torch.engine.cuda_kernels import hashes_to_numpy
from automerge_tpu_torch.engine.resident import ResidentDocSet
from automerge_tpu_torch.workloads import docset_fleet, text_fleet

from torch_port_helpers import to_port


class Pair:
    """The port's engine and the reference's, fed the same changes; every
    hash read is held equal between them."""

    def __init__(self, doc_ids):
        self.port = ResidentDocSet(doc_ids, device="cpu")
        self.ref = RefResident(doc_ids, native=False)

    def apply_changes(self, changes_by_doc):
        self.port.apply_changes({d: to_port(c)
                                 for d, c in changes_by_doc.items()})
        self.ref.apply_changes(changes_by_doc)

    def reconcile(self):
        got = self.port.reconcile()
        np.testing.assert_array_equal(got, self.ref.reconcile())
        return got

    def materialize(self, doc_id):
        got = self.port.materialize(doc_id)
        assert got == self.ref.materialize(doc_id)
        return got

    def __getattr__(self, name):
        return getattr(self.port, name)


def from_scratch_hash(changes):
    _, _, out = apply_batch([to_port(changes)], device="cpu")
    return int(hashes_to_numpy(out["hash"])[0])


def oracle_of(changes):
    doc = am.init("oracle")
    doc = apply_changes_to_doc(doc, doc._doc.opset, changes,
                               incremental=False)
    state = oracle_state(doc)
    assert state == ref_oracle_state(doc)
    return state


class TestResidentParity:
    def test_single_round_matches_batch(self):
        s1 = am.change(am.init("A"), lambda d: am.assign(d, {"x": 1, "y": "two"}))
        s2 = am.change(am.init("B"), lambda d: d.__setitem__("x", 9))
        m = am.merge(s1, s2)
        changes = m._doc.opset.get_missing_changes({})

        r = Pair(["doc"])
        r.apply_changes({"doc": changes})
        assert r.materialize("doc") == oracle_of(changes)
        assert int(r.reconcile()[0]) == from_scratch_hash(changes)

    def test_incremental_rounds(self):
        doc = am.change(am.init("A"), lambda d: d.__setitem__("n", 0))
        r = Pair(["doc"])
        r.apply_changes({"doc": doc._doc.opset.get_missing_changes({})})
        for i in range(5):
            new = am.change(doc, lambda d, i=i: am.assign(
                d, {"n": i + 1, f"k{i}": i}))
            delta = new._doc.opset.get_missing_changes(
                doc._doc.opset.clock)
            doc = new
            r.apply_changes({"doc": delta})
            all_changes = doc._doc.opset.get_missing_changes({})
            assert r.materialize("doc") == oracle_of(all_changes)
            assert int(r.reconcile()[0]) == from_scratch_hash(all_changes)

    def test_new_actor_mid_stream_remaps_ranks(self):
        # actor "M" joins after "Z": sorted ranks must shift so LWW still
        # breaks ties by string order
        s_z = am.change(am.init("Z"), lambda d: d.__setitem__("f", "from Z"))
        r = Pair(["doc"])
        r.apply_changes({"doc": s_z._doc.opset.get_missing_changes({})})

        s_m = am.change(am.init("M"), lambda d: d.__setitem__("f", "from M"))
        r.apply_changes({"doc": s_m._doc.opset.get_missing_changes({})})

        merged = am.merge(am.merge(am.init("x"), s_z), s_m)
        all_changes = merged._doc.opset.get_missing_changes({})
        state = r.materialize("doc")
        assert state["data"]["f"] == "from Z"  # Z > M wins
        assert state == oracle_of(all_changes)
        assert int(r.reconcile()[0]) == from_scratch_hash(all_changes)

    def test_list_edits_across_rounds(self):
        doc = am.change(am.init("A"), lambda d: d.__setitem__("xs", ["a", "b"]))
        r = Pair(["doc"])
        r.apply_changes({"doc": doc._doc.opset.get_missing_changes({})})

        prev = doc
        doc = am.change(doc, lambda d: d["xs"].insert_at(1, "mid"))
        doc = am.change(doc, lambda d: d["xs"].delete_at(0))
        delta = doc._doc.opset.get_missing_changes(prev._doc.opset.clock)
        r.apply_changes({"doc": delta})

        all_changes = doc._doc.opset.get_missing_changes({})
        assert r.materialize("doc") == oracle_of(all_changes)
        assert r.materialize("doc")["data"]["xs"] == ["mid", "b"]
        assert int(r.reconcile()[0]) == from_scratch_hash(all_changes)

    def test_out_of_order_delivery_buffers(self):
        s = am.change(am.init("A"), lambda d: d.__setitem__("a", 1))
        s = am.change(s, lambda d: d.__setitem__("b", 2))
        c1, c2 = s._doc.opset.get_missing_changes({})
        r = Pair(["doc"])
        r.apply_changes({"doc": [c2]})  # dependency missing: buffered
        assert r.materialize("doc")["data"] == {}
        r.apply_changes({"doc": [c1]})  # both become visible
        assert r.materialize("doc")["data"] == {"a": 1, "b": 2}

    def test_duplicate_delivery_idempotent(self):
        s = am.change(am.init("A"), lambda d: d.__setitem__("a", 1))
        changes = s._doc.opset.get_missing_changes({})
        r = Pair(["doc"])
        r.apply_changes({"doc": changes})
        h1 = int(r.reconcile()[0])
        r.apply_changes({"doc": changes})
        assert int(r.reconcile()[0]) == h1

    def test_many_docs_capacity_growth(self):
        docs = {}
        r = Pair([f"d{i}" for i in range(16)])
        for i in range(16):
            s = am.change(am.init(f"a{i:02d}"),
                          lambda d, i=i: am.assign(d, {"n": i, "xs": [i] * (i + 1)}))
            docs[f"d{i}"] = s
        r.apply_changes({k: v._doc.opset.get_missing_changes({})
                         for k, v in docs.items()})
        for i in (0, 7, 15):
            all_changes = docs[f"d{i}"]._doc.opset.get_missing_changes({})
            assert r.materialize(f"d{i}") == oracle_of(all_changes)
        assert r.cap_elems == 16 and r.cap_actors == 16
        r.reconcile()

    def test_hash_matches_across_replica_delivery_orders(self):
        s1 = am.change(am.init("A"), lambda d: d.__setitem__("xs", ["a"]))
        s2 = am.merge(am.init("B"), s1)
        s1 = am.change(s1, lambda d: d["xs"].append("b"))
        s2 = am.change(s2, lambda d: d["xs"].insert_at(0, "z"))
        m1 = am.merge(s1, s2)
        m2 = am.merge(s2, s1)
        ch1 = m1._doc.opset.get_missing_changes({})
        ch2 = m2._doc.opset.get_missing_changes({})

        ra = Pair(["d"])
        # replica A receives its own changes first, then B's
        ra.apply_changes({"d": ch1[:len(ch1) // 2]})
        ra.apply_changes({"d": ch1[len(ch1) // 2:]})
        rb = Pair(["d"])
        rb.apply_changes({"d": ch2})
        assert int(ra.reconcile()[0]) == int(rb.reconcile()[0])


class TestReserve:
    def test_reserve_presizes_and_preserves_state(self):
        s1 = am.change(am.init("A"), lambda d: am.assign(d, {"x": 1, "xs": [1, 2]}))
        changes = s1._doc.opset.get_missing_changes({})
        r = Pair(["doc"])
        r.apply_changes({"doc": changes})
        before = r.materialize("doc")
        for eng in (r.port, r.ref):
            eng.reserve(ops_per_doc=64, changes_per_doc=32,
                        elems_per_list=64, lists_per_doc=4, actors=8,
                        fids_per_doc=64)
        assert r.cap_ops >= 64 and r.cap_changes >= 32
        assert r.cap_elems >= 64 and r.cap_actors >= 8
        # state survives the resize and no regrow happens within the horizon
        assert r.materialize("doc") == before
        caps = (r.cap_ops, r.cap_changes, r.cap_lists, r.cap_elems)
        doc = s1
        for i in range(10):
            new = am.change(doc, lambda d, i=i: d.__setitem__("n", i))
            delta = new._doc.opset.get_missing_changes(doc._doc.opset.clock)
            doc = new
            r.apply_changes({"doc": delta})
        assert (r.cap_ops, r.cap_changes, r.cap_lists, r.cap_elems) == caps
        all_changes = doc._doc.opset.get_missing_changes({})
        assert r.materialize("doc") == oracle_of(all_changes)

    def test_reserve_noop_when_smaller(self):
        r = ResidentDocSet(["doc"], device="cpu")
        caps = (r.cap_ops, r.cap_changes, r.cap_actors)
        r.reserve(ops_per_doc=1, changes_per_doc=1, actors=1)
        assert (r.cap_ops, r.cap_changes, r.cap_actors) == caps


def fleet_history(i):
    """A two-actor history of map, list and text edits for doc i."""
    def setup(d):
        d["n"] = i
        d["xs"] = [i, i + 1]
        d["t"] = am.Text()
        d["t"].insert_at(0, *"ab")
    a = am.change(am.init("A"), setup)
    b = am.merge(am.init("B"), a)
    a = am.change(a, lambda d: d["xs"].insert_at(1, "a"))
    b = am.change(b, lambda d: d["t"].insert_at(1, *"xy"))
    b = am.change(b, lambda d: d.__setitem__("n", -i))
    return am.merge(a, b)


def test_apply_and_reconcile_rounds_match_reference_and_batch():
    """Per-doc deliveries split over rounds (dependencies first arriving
    after their dependants on some docs): every round's hashes equal the
    reference's, and the last equals apply_batch's from scratch."""
    docs = [fleet_history(i) for i in range(6)]
    ids = [f"doc{i}" for i in range(6)]
    rng = np.random.default_rng(5)
    per_doc = []
    for d in docs:
        chs = list(d._doc.opset.get_missing_changes({}))
        rng.shuffle(chs)
        per_doc.append(chs)
    r = Pair(ids)
    for k in range(3):
        rnd = {ids[i]: chs[k::3] for i, chs in enumerate(per_doc)}
        got = r.port.apply_and_reconcile({d: to_port(c)
                                          for d, c in rnd.items()})
        np.testing.assert_array_equal(got, r.ref.apply_and_reconcile(rnd))
    _, _, out = apply_batch([to_port(d._doc.opset.get_missing_changes({}))
                             for d in docs], device="cpu")
    np.testing.assert_array_equal(got, hashes_to_numpy(out["hash"]))
    for i, d in enumerate(docs):
        assert r.materialize(ids[i]) == oracle_state(d)


def test_hashes_for_a_minority_after_apply_changes():
    """apply_changes without reconcile, then hashes_for on a minority:
    only the requested dirty docs reconcile (a narrow sub-batch), and the
    hashes equal the reference's and a full reconcile's."""
    ids, initial, rounds = docset_fleet(n_docs=40, rounds=2)
    r = Pair(ids)
    np.testing.assert_array_equal(
        r.port.apply_and_reconcile(initial),
        r.ref.apply_and_reconcile(_to_ref(initial)))
    r.apply_changes(_to_ref(rounds[0]))
    touched = sorted(r.doc_index[d] for d in rounds[0])
    want = touched[:3] + [i for i in range(40) if i not in touched][:2]
    got = r.port.hashes_for(want)
    assert r.port._out is None
    assert all(i in r.port._doc_dirty for i in touched[3:])
    np.testing.assert_array_equal(got, r.ref.hashes_for(want))
    np.testing.assert_array_equal(r.port.hashes(), r.ref.hashes())
    np.testing.assert_array_equal(r.port.hashes(), r.reconcile())


def _to_ref(changes_by_doc):
    """Port Change objects as the reference's (through the wire dict)."""
    from automerge_tpu.core.change import Change
    return {d: [Change.from_dict(c.to_dict()) for c in chs]
            for d, chs in changes_by_doc.items()}


def test_add_docs_grows_the_doc_axis():
    ids, initial, _ = docset_fleet(n_docs=3, rounds=0)
    r = Pair(ids[:1])
    r.port.apply_and_reconcile({ids[0]: initial[ids[0]]})
    r.ref.apply_and_reconcile(_to_ref({ids[0]: initial[ids[0]]}))
    assert r.port.add_docs(ids[1:]) == ids[1:]
    r.ref.add_docs(ids[1:])
    assert r.cap_docs == 8
    got = r.port.apply_and_reconcile(initial)
    np.testing.assert_array_equal(got, r.ref.apply_and_reconcile(
        _to_ref(initial)))
    assert r.port.resident_bytes() == sum(
        int(v.nbytes) for v in r.ref.state.values())


def test_docset_fleet_held_to_the_reference_engine():
    """Bench config 5's shape at 256 docs: the initial merge and all 12
    rounds (the first registers the "bench" actor mid-stream, growing the
    actor capacity), each round's hashes equal the reference's; the final
    state equals apply_batch's and decodes to the oracle's view."""
    ids, initial, rounds = docset_fleet(n_docs=256)
    r = Pair(ids)
    for rnd in [initial] + rounds:
        got = r.port.apply_and_reconcile(rnd)
        np.testing.assert_array_equal(got, r.ref.apply_and_reconcile(
            _to_ref(rnd)))
    assert r.cap_actors == 4 and r.actors == ["A", "B", "bench"]
    per_doc = {d: list(initial[d]) for d in ids}
    for rnd in rounds:
        for d, chs in rnd.items():
            per_doc[d].extend(chs)
    encs, _, out = apply_batch([per_doc[d] for d in ids], device="cpu")
    np.testing.assert_array_equal(got, hashes_to_numpy(out["hash"]))
    for i in (0, 1, 255):
        assert r.materialize(ids[i]) == decode_doc(encs[i],
                                                   doc_outputs(out, i))


def test_text_fleet_docs_major_equals_rows_engine():
    """The rows engine and the docs-major engine hash the same text
    streams identically (the cross-engine check phase 9 makes on the
    card)."""
    from automerge_tpu_torch.engine.resident_rows import ResidentRowsDocSet
    ids, rounds = text_fleet(n_docs=5, chars=12, chars_per_change=3,
                             rounds=3, seed=4)
    docs = ResidentDocSet(ids, device="cpu")
    rows = ResidentRowsDocSet(ids, device="cpu")
    for rnd in rounds:
        docs.apply_and_reconcile(rnd)
    rows.apply_rounds(rounds)
    np.testing.assert_array_equal(docs.hashes(), rows.hashes())
    b = BatchedDocSet(device="cpu")
    for rnd in rounds:
        for d, chs in rnd.items():
            b.add_changes(d, chs)
    np.testing.assert_array_equal(b.reconcile(), docs.hashes())
    assert b.state_hash(ids[2]) == int(docs.hashes()[2])
    assert b.materialize(ids[2]) == docs.materialize(ids[2])


def test_reconcile_launches_no_kernel_on_the_cpu():
    ids, initial, _ = docset_fleet(n_docs=4, rounds=0)
    r = ResidentDocSet(ids, device="cpu")
    before = dict(cuda_kernels.LAUNCHES)
    r.apply_and_reconcile(initial)
    assert cuda_kernels.LAUNCHES == before



def test_committed_docs_hashes_reproduced_by_both_packages():
    """testdata/reference_hashes.npz's docs-major entries (what
    chip_smoke.py holds the card to): the reference's ResidentDocSet
    still computes them, and the port's on the CPU equals them."""
    from pathlib import Path

    from automerge_tpu_torch.workloads import reference_docs_streams
    from torch_port_helpers import load_reference_script

    committed = np.load(Path(__file__).resolve().parent.parent
                        / "automerge_tpu_torch" / "testdata"
                        / "reference_hashes.npz")
    ref = load_reference_script().reference_docs_hashes()
    for name, ids, rounds in reference_docs_streams():
        ds = ResidentDocSet(ids, device="cpu")
        for rnd in rounds:
            ds.apply_and_reconcile(rnd)
        np.testing.assert_array_equal(ds.hashes(), committed[f"docs_{name}"])
        np.testing.assert_array_equal(ref[f"docs_{name}"],
                                      committed[f"docs_{name}"])
