"""The docs-major diff plane: the port's ResidentDocSet (device="cpu") with
diffs=True against the reference's, fed the same change streams. Every
round's hashes and record lists are equal, and a MirrorDoc folded from the
port's records equals the port's materialize and the reference's (and the
interpretive oracle's state where tests/test_engine_diffs.py compares with
it). The cases of tests/test_engine_diffs.py, each on both encoders
(`native` True and False; the reference on its matching encoder), and of
tests/test_cursor_equivalence.py, whose cursor transformer and Selection
(the reference's frontend: the port has none yet) read the port's records.
Then _fid_survivor_hash's bits, hashes_clean, and the committed reference
records. Tolerance: exact."""

import json
import random
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import automerge_tpu as am
from automerge_tpu import api
from automerge_tpu.core.ids import ROOT_ID
from automerge_tpu.engine.batchdoc import oracle_state
from automerge_tpu.engine.resident import ResidentDocSet as RefResident
from automerge_tpu.engine.resident import \
    _fid_survivor_hash as ref_survivor_hash
from automerge_tpu.frontend.cursors import Selection, transform_index

from automerge_tpu_torch.engine.diffs import MirrorDoc
from automerge_tpu_torch.engine.resident import (ResidentDocSet,
                                                 _fid_survivor_hash)
from automerge_tpu_torch.workloads import reference_diff_streams

from torch_port_helpers import to_port

NATIVE = pytest.mark.parametrize("native", [True, False])
COMMITTED = (Path(__file__).resolve().parent.parent / "automerge_tpu_torch"
             / "testdata" / "reference_diffs.json")


def _delta(prev, new):
    return new._doc.opset.get_missing_changes(prev._doc.opset.clock)


def _all(doc):
    return doc._doc.opset.get_missing_changes({})


class Tracker:
    """The reference's ResidentDocSet and the port's fed the same changes;
    every round's hashes and records are held equal, and per-doc mirrors
    fold the port's records."""

    def __init__(self, doc_ids, native=True):
        self.ref = RefResident(doc_ids, native=None if native else False)
        self.port = ResidentDocSet(doc_ids, device="cpu", native=native)
        self.mirrors = {d: MirrorDoc() for d in doc_ids}

    def round(self, changes_by_doc, diffs=True):
        want = self.ref.apply_and_reconcile(changes_by_doc, diffs=diffs)
        got = self.port.apply_and_reconcile(
            {d: to_port(c) for d, c in changes_by_doc.items()}, diffs=diffs)
        if not diffs:
            np.testing.assert_array_equal(got, want)
            return got, None
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
        for doc_id, records in got[1].items():
            self.mirrors[doc_id].apply(records)
        return got

    def add_docs(self, ids):
        self.ref.add_docs(ids)
        self.port.add_docs(ids)
        self.mirrors.update((d, MirrorDoc()) for d in ids)

    def check(self, doc_id, doc=None):
        got = self.mirrors[doc_id].snapshot(ROOT_ID)
        want = self.port.materialize(doc_id)
        assert got == want, f"{doc_id}:\nmirror: {got}\nengine: {want}"
        assert want == self.ref.materialize(doc_id)
        if doc is not None:
            assert want == oracle_state(doc)


# ---------------------------------------------------------------------------
# tests/test_engine_diffs.py

@NATIVE
def test_incremental_mirror_follows_engine_diffs(native):
    docs = {}
    a = am.change(am.init("A"), lambda d: am.assign(
        d, {"n": 1, "xs": [10, 20], "t": am.Text(), "m": {"deep": True}}))
    a = am.change(a, lambda d: d["t"].insert_at(0, *"hi"))
    docs["d0"] = a
    docs["d1"] = am.change(am.init("A"), lambda d: am.assign(d, {"x": "y"}))

    tr = Tracker(["d0", "d1"], native)
    # round 1: the initial load, records describe construction from empty
    tr.round({d: _all(doc) for d, doc in docs.items()})
    tr.check("d0", docs["d0"])
    tr.check("d1", docs["d1"])

    # round 2: map set + list insert + text edit + delete on d0 only
    prev = docs["d0"]
    new = am.change(prev, lambda d: d.__setitem__("n", 2))
    new = am.change(new, lambda d: d["xs"].insert_at(1, 15))
    new = am.change(new, lambda d: d["t"].insert_at(2, "!"))
    new = am.change(new, lambda d: d["m"].__delitem__("deep"))
    _, diffs = tr.round({"d0": _delta(prev, new)})
    docs["d0"] = new
    assert "d1" not in diffs, "unchanged doc must emit no records"
    tr.check("d0", new)
    tr.check("d1")

    # round 3: removals and a set on an existing element
    prev = docs["d0"]
    new = am.change(prev, lambda d: d["xs"].delete_at(0))
    new = am.change(new, lambda d: d["t"].delete_at(0))
    new = am.change(new, lambda d: d["xs"].__setitem__(0, 99))
    tr.round({"d0": _delta(prev, new)})
    tr.check("d0", new)


@NATIVE
def test_conflict_only_change_is_reported(native):
    """A concurrent losing write changes no winner, no visibility, no rank:
    only the conflict set. The survivor-hash mask must still catch it."""
    base = am.change(am.init("B"), lambda d: d.__setitem__("k", "v0"))
    tr = Tracker(["d"], native)
    tr.round({"d": _all(base)})
    tr.check("d")

    fork = am.merge(am.init("A"), base)
    b2 = am.change(base, lambda d: d.__setitem__("k", "vb"))
    a2 = am.change(fork, lambda d: d.__setitem__("k", "va"))
    merged = am.merge(b2, a2)
    _, diffs = tr.round({"d": _delta(base, merged)})
    assert "d" in diffs, "conflict-only change produced no diff"
    recs = [r for r in diffs["d"] if r.get("key") == "k"]
    assert recs and recs[0]["action"] == "set" and recs[0]["value"] == "vb"
    assert recs[0]["conflicts"] == [{"actor": "A", "value": "va"}]
    tr.check("d", merged)


@NATIVE
def test_diff_records_match_oracle_diffs_shape(native):
    """The records of a simple round carry the action/obj/key/value content
    of the interpretive oracle's diff stream for the same delta."""
    base = am.change(am.init("A"), lambda d: am.assign(d, {"xs": [1, 2]}))
    tr = Tracker(["d"], native)
    tr.round({"d": _all(base)})

    new = am.change(base, lambda d: d["xs"].insert_at(1, 7))
    new = am.change(new, lambda d: d.__setitem__("k", "v"))
    delta = _delta(base, new)
    _, diffs = tr.round({"d": delta})
    _, oracle_diffs = base._doc.opset.add_changes(delta)

    def norm(recs):
        return {(r["action"], r["type"], r.get("key"), r.get("index"),
                 repr(r.get("value"))) for r in recs
                if r["action"] != "create"}

    assert norm(diffs["d"]) == norm(oracle_diffs)
    tr.check("d", new)


@NATIVE
def test_random_rounds_mirror_parity(native):
    """A seeded multi-round soak: mirrors driven only by the port's records
    track its materialize, the reference's and the interpretive oracle."""
    rng = random.Random(5)
    ids = [f"d{i}" for i in range(4)]
    docs = {did: am.change(am.init("A"), lambda x, i=i: am.assign(
        x, {"n": i, "xs": [i], "t": am.Text()})) for i, did in enumerate(ids)}
    tr = Tracker(ids, native)
    tr.round({d: _all(docs[d]) for d in ids})

    for rnd in range(6):
        round_changes = {}
        for did in rng.sample(ids, rng.randint(1, len(ids))):
            prev = docs[did]
            r = rng.random()
            if r < 0.35:
                new = am.change(prev, lambda d, rnd=rnd: d.__setitem__(
                    "n", rnd * 10))
            elif r < 0.6:
                pos = rng.randint(0, len(prev["xs"]))
                new = am.change(prev, lambda d, p=pos, rnd=rnd:
                                d["xs"].insert_at(p, rnd))
            elif r < 0.8 and len(prev["xs"]):
                pos = rng.randrange(len(prev["xs"]))
                new = am.change(prev, lambda d, p=pos: d["xs"].delete_at(p))
            else:
                pos = rng.randint(0, len(prev["t"]))
                new = am.change(prev, lambda d, p=pos: d["t"].insert_at(
                    p, rng.choice("xyz")))
            round_changes[did] = _delta(prev, new)
            docs[did] = new
        tr.round(round_changes)
        for did in ids:
            tr.check(did, docs[did])


@NATIVE
def test_baseline_survives_add_docs_and_hash_only_rounds(native):
    """add_docs and diffs=False rounds leave the diff baseline alone: the
    next diff round reports only what the consumer has not seen (list
    inserts are not idempotent, so a reset would duplicate elements)."""
    a = am.change(am.init("A"), lambda d: d.__setitem__("xs", [1, 2, 3]))
    tr = Tracker(["d0"], native)
    tr.round({"d0": _all(a)})
    tr.check("d0", a)

    tr.add_docs(["d1"])
    b = am.change(am.init("B"), lambda d: d.__setitem__("y", 1))
    a2 = am.change(a, lambda d: d.__setitem__("n", 7))
    _, diffs = tr.round({"d0": _delta(a, a2), "d1": _all(b)})
    assert all(r.get("type") != "list" for r in diffs["d0"]), diffs["d0"]
    tr.check("d0", a2)
    tr.check("d1", b)

    # a hash-only round's effects surface on the NEXT diff round
    a3 = am.change(a2, lambda d: d["xs"].insert_at(0, 0))
    tr.round({"d0": _delta(a2, a3)}, diffs=False)
    a4 = am.change(a3, lambda d: d.__setitem__("n", 8))
    _, diffs = tr.round({"d0": _delta(a3, a4)})
    kinds = {(r["action"], r.get("type")) for r in diffs["d0"]}
    assert ("insert", "list") in kinds, "hash-only round's insert was lost"
    tr.check("d0", a4)


@NATIVE
def test_capacity_growth_between_hash_only_and_diff_rounds(native):
    """A diff round whose delta grows capacities after a hash-only round
    pads the (empty) baseline to the new shapes."""
    a = am.change(am.init("A"), lambda d: d.__setitem__("k", 0))
    tr = Tracker(["d"], native)
    tr.round({"d": _all(a)}, diffs=False)
    big = am.change(a, lambda d: am.assign(
        d, {f"k{i}": i for i in range(40)}))  # grows cap_ops / cap_fids
    tr.round({"d": _delta(a, big)})
    # the baseline was empty (first diff round): the mirror sees the doc
    tr.check("d", big)


@NATIVE
def test_new_actor_remap_emits_no_spurious_diffs(native):
    """Registering an actor that re-sorts the ranks flags no unchanged
    document."""
    docs = {f"d{i}": am.change(am.init("M"), lambda d, i=i: am.assign(
        d, {"n": i, "xs": [i]})) for i in range(3)}
    tr = Tracker(list(docs), native)
    tr.round({d: _all(doc) for d, doc in docs.items()})

    # actor "A" sorts before "M": a global rank remap
    prev = docs["d0"]
    peer = am.change(am.merge(am.init("A"), prev),
                     lambda d: d.__setitem__("n", 99))
    merged = am.merge(prev, peer)
    _, diffs = tr.round({"d0": _delta(prev, merged)})
    docs["d0"] = merged
    assert set(diffs) == {"d0"}, f"spurious diffs: {sorted(diffs)}"
    for d in docs:
        tr.check(d, docs[d])


@NATIVE
def test_hash_only_path_unaffected(native):
    """diffs=False keeps the hashes-only contract."""
    base = am.change(am.init("A"), lambda d: d.__setitem__("k", 1))
    tr = Tracker(["d"], native)
    h, _ = tr.round({"d": _all(base)}, diffs=False)
    assert isinstance(h, np.ndarray) and h.shape == (1,)
    assert tr.port._diff_prev is None


@NATIVE
def test_map_move_diffs_relocate_child(native):
    """A map move is a `remove` at the old parent key plus a `set {link:
    True}` at the destination; a chained move re-homes the child again."""
    base = am.change(am.init("A"), lambda d: am.assign(
        d, {"src": {"child": {"x": 1}}, "dst": {}}))
    tr = Tracker(["d"], native)
    tr.round({"d": _all(base)})
    tr.check("d")

    new = am.change(base, lambda d: d["src"].move("child", d["dst"], "kid"))
    _, diffs = tr.round({"d": _delta(base, new)})
    acts = [(r["action"], r.get("key")) for r in diffs["d"]]
    assert ("remove", "child") in acts and ("set", "kid") in acts
    assert next(r for r in diffs["d"] if r["action"] == "set")["link"]
    tr.check("d")
    assert tr.mirrors["d"].snapshot(ROOT_ID)["data"] == {
        "src": {}, "dst": {"kid": {"x": 1}}}

    prev, new = new, am.change(new, lambda d: d["dst"].move("kid", d, "home"))
    _, diffs = tr.round({"d": _delta(prev, new)})
    acts = [(r["action"], r.get("key")) for r in diffs["d"]]
    assert ("remove", "kid") in acts and ("set", "home") in acts
    tr.check("d")
    assert tr.mirrors["d"].snapshot(ROOT_ID)["data"] == {
        "src": {}, "dst": {}, "home": {"x": 1}}


@NATIVE
def test_same_round_create_and_move(native):
    """The creating link and the move in one round: the stale link is
    suppressed (the single-location rule), never paired with a remove."""
    base = am.change(am.init("A"), lambda d: am.assign(
        d, {"src": {"child": {"x": 1}}, "dst": {}}))
    new = am.change(base, lambda d: d["src"].move("child", d["dst"], "kid"))
    tr = Tracker(["d"], native)
    _, diffs = tr.round({"d": _all(new)})
    tr.check("d")
    assert tr.mirrors["d"].snapshot(ROOT_ID)["data"] == {
        "src": {}, "dst": {"kid": {"x": 1}}}
    assert not any(r["action"] == "remove" for r in diffs["d"])


@NATIVE
def test_concurrent_map_moves_match_oracle(native):
    """Two replicas move one child from the same context: the records, the
    materialize and the interpretive oracle pick the same destination."""
    base = am.change(am.init("A"), lambda d: am.assign(
        d, {"src": {"child": {"x": 1}}, "p": {}, "q": {}}))
    fork_b = am.merge(am.init("B"), base)
    a2 = am.change(base, lambda d: d["src"].move("child", d["p"], "ka"))
    b2 = am.change(fork_b, lambda d: d["src"].move("child", d["q"], "kb"))
    merged = am.merge(a2, b2)

    tr = Tracker(["d"], native)
    tr.round({"d": _all(base)})
    tr.round({"d": merged._doc.opset.get_missing_changes(
        base._doc.opset.clock)})
    tr.check("d")
    assert tr.mirrors["d"].snapshot(ROOT_ID)["data"] == api.inspect(merged)


@NATIVE
def test_list_move_emits_explicit_record(native):
    """A list move ships one explicit `move` record, which the mirror
    ignores (element ranks are move-agnostic): mirror == materialize."""
    base = am.change(am.init("A"), lambda d: am.assign(
        d, {"xs": [10, 20, 30]}))
    tr = Tracker(["d"], native)
    tr.round({"d": _all(base)})
    new = am.change(base, lambda d: d["xs"].move(0, 2))
    _, diffs = tr.round({"d": _delta(base, new)})
    movs = [r for r in diffs["d"] if r["action"] == "move"]
    assert len(movs) == 1
    rec = movs[0]
    assert rec["type"] == "list"
    assert rec["elem"].startswith("A:") and rec["anchor"].startswith("A:")
    assert isinstance(rec["counter"], int)
    tr.check("d")


# ---------------------------------------------------------------------------
# tests/test_cursor_equivalence.py: the port's batch records moved through
# the reference's cursor transformer land where the oracle's per-op stream
# puts them

def _text_obj_id(doc, key="t"):
    from automerge_tpu.core.opset import get_field_ops
    (op,) = get_field_ops(doc._doc.opset, ROOT_ID, key)
    assert op.action == "link"
    return op.value


def _random_trace(rng, base, n_rounds=8, n_actors=3):
    """Concurrent 3-actor text editing; yields (delta, merged_doc)."""
    replicas = {a: am.merge(am.init(a), base) for a in "ABC"[:n_actors]}
    shipped = base
    for _ in range(n_rounds):
        for a in list(replicas):
            d = replicas[a]
            for _ in range(rng.randint(0, 3)):
                n = len(d["t"])
                if rng.random() < 0.65 or n == 0:
                    pos = rng.randint(0, n)
                    ch = rng.choice("abcdef ")
                    d = am.change(d, lambda doc, pos=pos, ch=ch:
                                  doc["t"].insert_at(pos, ch))
                else:
                    pos = rng.randrange(n)
                    d = am.change(d, lambda doc, pos=pos:
                                  doc["t"].delete_at(pos))
            replicas[a] = d
        a, b = rng.sample(list(replicas), 2)
        replicas[a] = am.merge(replicas[a], replicas[b])
        merged = shipped
        for d in replicas.values():
            merged = am.merge(merged, d)
        delta = _delta(shipped, merged)
        if delta:
            yield delta, merged
        shipped = merged


def _text_base(text):
    def mk(d):
        d["t"] = am.Text()
        d["t"].insert_at(0, *text)
    return am.change(am.init("base"), mk)


def _observers(base):
    """The engine pair after the base round, and the oracle's OpSet."""
    tr = Tracker(["d"])
    tr.round({"d": _all(base)})
    oracle_opset, _ = am.init("obs")._doc.opset.add_changes(_all(base))
    return tr, oracle_opset


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_cursor_equivalence_on_concurrent_text_traces(seed):
    """A cursor at every position: where its anchor survives, the port's
    batch stream and the oracle's per-op stream move it to exactly the
    anchor's new rank; where it died, both land inside the ambiguity zone
    between its surviving neighbours."""
    rng = random.Random(seed)
    base = _text_base("hello world")
    tid = _text_obj_id(base)
    tr, oracle_opset = _observers(base)

    for delta, merged in _random_trace(rng, base):
        old_elems = list(oracle_opset.by_object[tid].elem_ids)
        n_old = len(old_elems)
        _, batch_diffs = tr.round({"d": delta})
        oracle_opset, op_diffs = oracle_opset.add_changes(delta)
        new_rank = {e: i for i, e in
                    enumerate(oracle_opset.by_object[tid].elem_ids)}
        n_new = len(new_rank)
        assert n_new == len(merged["t"])

        for i in range(n_old + 1):
            got = transform_index(i, batch_diffs.get("d", []), tid)
            want = transform_index(i, op_diffs, tid)
            anchor = old_elems[i] if i < n_old else None
            if anchor is None:
                assert got == want == n_new, (i, got, want, n_new)
            elif anchor in new_rank:
                assert got == want == new_rank[anchor], (i, got, want)
            else:
                lo = 0
                for j in range(i - 1, -1, -1):
                    if old_elems[j] in new_rank:
                        lo = new_rank[old_elems[j]] + 1
                        break
                hi = n_new
                for j in range(i + 1, n_old):
                    if old_elems[j] in new_rank:
                        hi = new_rank[old_elems[j]]
                        break
                assert lo <= got <= hi and lo <= want <= hi, (i, got, want)
    tr.check("d", merged)


def test_cursor_equivalence_insert_delete_same_round():
    """A char inserted and deleted within one round: the oracle emits
    insert-then-remove, the port nothing; cursors agree."""
    base = _text_base("abcd")
    tid = _text_obj_id(base)
    tr, oracle_opset = _observers(base)

    new = am.change(base, lambda d: d["t"].insert_at(2, "X"))
    new = am.change(new, lambda d: d["t"].delete_at(2))
    delta = _delta(base, new)
    _, batch_diffs = tr.round({"d": delta})
    oracle_opset, op_diffs = oracle_opset.add_changes(delta)
    assert not [r for r in batch_diffs.get("d", [])
                if r.get("type") == "text"], "transient char leaked"
    for i in range(5):
        got = transform_index(i, batch_diffs.get("d", []), tid)
        want = transform_index(i, op_diffs, tid)
        assert got == want == i


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_selection_equivalence_on_concurrent_text_traces(seed):
    """Sampled [s, e) selections: the port's batch stream and the oracle's
    per-op stream give the same range wherever both anchors survive, and
    neither inverts a range."""
    rng = random.Random(100 + seed)
    base = _text_base("hello world")
    tid = _text_obj_id(base)
    tr, oracle_opset = _observers(base)

    for delta, merged in _random_trace(rng, base):
        old_elems = list(oracle_opset.by_object[tid].elem_ids)
        n_old = len(old_elems)
        _, batch_diffs = tr.round({"d": delta})
        oracle_opset, op_diffs = oracle_opset.add_changes(delta)
        new_rank = {e: i for i, e in
                    enumerate(oracle_opset.by_object[tid].elem_ids)}
        n_new = len(new_rank)
        assert n_new == len(merged["t"])

        pairs = {(rng.randint(0, n_old), rng.randint(0, n_old))
                 for _ in range(25)}
        for s, e in ((min(p), max(p)) for p in pairs):
            eng = Selection(tid, s, e).apply(batch_diffs.get("d", []))
            ora = Selection(tid, s, e).apply(op_diffs)
            assert eng.start <= eng.end, (s, e, eng)
            assert ora.start <= ora.end, (s, e, ora)
            for idx, got, want in ((s, eng.start, ora.start),
                                   (e, eng.end, ora.end)):
                anchor = old_elems[idx] if idx < n_old else None
                if anchor is None:
                    assert got == want == n_new
                elif anchor in new_rank:
                    assert got == want == new_rank[anchor], (idx, got, want)


# ---------------------------------------------------------------------------
# the pieces

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fid_survivor_hash_bits_equal_the_reference(seed):
    """_fid_survivor_hash on random states (actor ranks and fids past
    their ranges, hashes over the whole int32 range, dozens of candidates
    a field, so the uint32 sums wrap) against the reference's."""
    rng = np.random.default_rng(seed)
    d, i, a, f = 6, 96, 5, 8
    state = {"actor": rng.integers(-1, a + 2, (d, i)),
             "value_hash": rng.integers(-2**31, 2**31, (d, i)),
             "fid": rng.integers(-1, f + 2, (d, i))}
    state = {k: v.astype(np.int32) for k, v in state.items()}
    candidate = rng.random((d, i)) < 0.7
    actor_hashes = rng.integers(-2**31, 2**31, a).astype(np.int32)

    got = _fid_survivor_hash(
        {k: torch.from_numpy(v) for k, v in state.items()},
        {"candidate": torch.from_numpy(candidate)}, f,
        torch.from_numpy(actor_hashes))
    want = ref_survivor_hash(
        {k: jnp.asarray(v) for k, v in state.items()} | {
            "op_mask": jnp.ones((d, i), bool)},
        {"candidate": jnp.asarray(candidate)}, f, jnp.asarray(actor_hashes))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))
    assert (np.asarray(want) >= 2**31).any()


@NATIVE
def test_hashes_clean_through_dirty_read_clean(native):
    """hashes_clean: False before the first read and after an ingress that
    does not reconcile, True once a read or a fused round has served every
    doc; the reference's says the same at each step."""
    a = am.change(am.init("A"), lambda d: d.__setitem__("k", 1))
    b = am.change(a, lambda d: d.__setitem__("k", 2))
    tr = Tracker(["d0", "d1"], native)

    def both():
        assert tr.port.hashes_clean == tr.ref.hashes_clean
        return tr.port.hashes_clean

    assert not both()
    np.testing.assert_array_equal(tr.port.hashes(), tr.ref.hashes())
    assert both()
    tr.round({"d0": _all(a)})
    assert both()
    tr.port.apply_changes({"d1": to_port(_all(a))})
    tr.ref.apply_changes({"d1": _all(a)})
    assert not both()
    np.testing.assert_array_equal(tr.port.hashes(), tr.ref.hashes())
    assert both()
    tr.round({"d0": _delta(a, b)}, diffs=False)
    assert both()


def test_committed_reference_records_reproduced():
    """testdata/reference_diffs.json (what chip_smoke.py holds the card
    to): the port on the CPU reproduces every round's records."""
    committed = json.loads(COMMITTED.read_text())
    for name, ids, rounds in reference_diff_streams():
        ds = ResidentDocSet(ids, device="cpu")
        got = [json.loads(json.dumps(ds.apply_and_reconcile(
            rnd, diffs=True)[1])) for rnd in rounds]
        assert got == committed[name], name
