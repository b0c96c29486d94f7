"""The port's native host code against the reference's: the wire codec
(`parse_changes_json`, `changes_to_columns`, `concat_columns`: the same
WireColumns field for field), the delta encoder (`NativeDeltaEncoder`:
the same BatchDelta arrays and table additions on the same frames), and
the host linearizer (`linearize_host`, its Python twin
`linearize_host_plain`, the reference's and the port's device `linearize`).
Ports of tests/test_native_wire.py, tests/test_native_delta.py and
tests/test_linearize_host.py; then the build: content-hash names,
concurrent builds, and no fallback without a compiler. Tolerance: exact."""

import json
import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import automerge_tpu as am
from automerge_tpu.core.change import coerce_change
from automerge_tpu.engine.resident import ResidentDocSet as RefResident
from automerge_tpu.native import delta as ref_delta
from automerge_tpu.native import linearize as ref_linearize
from automerge_tpu.native import wire as ref_wire

import automerge_tpu_torch.native as native
from automerge_tpu_torch.core.change import Change, Op
from automerge_tpu_torch.core.ids import ROOT_ID
from automerge_tpu_torch.engine.kernels import linearize
from automerge_tpu_torch.engine.resident import ResidentDocSet
from automerge_tpu_torch.engine.resident_rows import ResidentRowsDocSet
from automerge_tpu_torch.native import delta, wire
from automerge_tpu_torch.native.linearize import (linearize_host,
                                                  linearize_host_plain)
from automerge_tpu_torch.sync.frames import encode_frame

from torch_port_helpers import to_port

REPO = Path(__file__).resolve().parent.parent
COLUMNS = ("change_actor", "change_seq", "change_msg", "deps_off",
           "deps_actor", "deps_seq", "op_off", "op_action", "op_obj",
           "op_key", "op_elem", "op_vtag", "op_vint", "op_vdbl", "op_vstr")
TABLES = ("actors", "objects", "keys", "messages", "strings")


def assert_same_columns(got, want) -> None:
    for f in COLUMNS:
        g, w = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    for f in TABLES:
        assert list(getattr(got, f)) == list(getattr(want, f)), f


def wire_of(doc) -> str:
    return json.dumps(am.get_changes(am.init(), doc))


def scalars_doc():
    return am.change(am.init("a"), lambda d: am.assign(d, {
        "s": "str", "i": 42, "neg": -17, "f": 3.25, "t": True,
        "fl": False, "n": None, "zero": 0, "big": 2**40}))


def unicode_doc():
    return am.change(am.init("actor-ü"), 'msg "q" \\ ☃',
                     lambda d: d.__setitem__("k", "héllo\n\t☃ \"x\" 𝄞"))


def nested_doc():
    return am.change(am.init("a"), lambda d: d.__setitem__(
        "board", {"cards": [{"t": "one"}, "plain", 7]}))


def text_doc():
    def edit(doc):
        doc["t"] = am.Text()
        doc["t"].insert_at(0, *"hey")
    s = am.change(am.init("a"), edit)
    return am.change(s, lambda d: d["t"].delete_at(1))


def multi_actor_doc():
    s1 = am.change(am.init("A"), lambda d: d.__setitem__("a", 1))
    s2 = am.merge(am.init("B"), s1)
    s2 = am.change(s2, lambda d: d.__setitem__("b", 2))
    s1 = am.merge(s1, s2)
    return am.change(s1, lambda d: d.__setitem__("c", 3))


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


DOCS = {"scalars": scalars_doc, "unicode": unicode_doc, "nested": nested_doc,
        "text": text_doc, "multi_actor": multi_actor_doc}

ODD_WIRES = {
    "bigint": [{"actor": "a", "seq": 1, "deps": {},
                "ops": [{"action": "set", "obj": am.ROOT_ID, "key": "big",
                         "value": 2**70}]}],
    "unknown_fields": [{"actor": "a", "seq": 1, "deps": {}, "time": 123,
                        "ops": [{"action": "set", "obj": am.ROOT_ID,
                                 "key": "x", "value": 1,
                                 "extra": [1, {"a": 2}]}]}],
    "lone_surrogate": [{"actor": "a", "seq": 1, "deps": {},
                        "ops": [{"action": "set", "obj": am.ROOT_ID,
                                 "key": "s", "value": "x\ud800y"}]}],
}


# ---------------------------------------------------------------------------
# the wire codec

@pytest.mark.parametrize("name", list(DOCS))
def test_parse_changes_json_equals_the_reference(name):
    data = wire_of(DOCS[name]())
    got = wire.parse_changes_json(data)
    assert_same_columns(got, ref_wire.parse_changes_json(data))
    want = [coerce_change(c) for c in json.loads(data)]
    assert [c.to_dict() for c in got.to_changes()] \
        == [c.to_dict() for c in want]


@pytest.mark.parametrize("name", list(ODD_WIRES))
def test_parse_odd_wires_equals_the_reference(name):
    data = json.dumps(ODD_WIRES[name])
    got = wire.parse_changes_json(data)
    assert_same_columns(got, ref_wire.parse_changes_json(data))
    assert [c.to_dict() for c in got.to_changes()] \
        == [coerce_change(c).to_dict() for c in json.loads(data)]


def test_parse_bigint_and_missing_ops():
    got = wire.parse_changes_json(json.dumps(ODD_WIRES["bigint"]))
    assert got.to_changes()[0].ops[0].value == 2**70
    changes = wire.parse_changes_json(
        '[{"actor":"a","seq":1,"deps":{}}]').to_changes()
    assert changes[0].ops == ()


@pytest.mark.parametrize("data", [
    '[{"actor": "a", "seq": }]', '{"not": "an array"}', '[{"actor": "a"}]',
    '[{"actor":"a","seq":1099511627776,"deps":{},"ops":[]}]'])
def test_malformed_wire_raises(data):
    with pytest.raises(ValueError):
        wire.parse_changes_json(data)
    with pytest.raises(ValueError):
        ref_wire.parse_changes_json(data)


@pytest.mark.parametrize("name", list(DOCS) + ["rich"])
def test_changes_to_columns_equals_the_reference(name):
    chs = (rich_trace() if name == "rich"
           else DOCS[name]()._doc.opset.get_missing_changes({}))
    got = wire.changes_to_columns(to_port(chs))
    assert_same_columns(got, ref_wire.changes_to_columns(chs))
    assert got.to_changes() == to_port(chs)
    assert [got.change_at(i) for i in range(got.n_changes)] == to_port(chs)
    assert [got.deps_at(i) for i in range(got.n_changes)] \
        == [c.deps for c in chs]


def concat_parts(lib):
    parts = []
    for w in range(4):
        chs = []
        for s in range(1, 4):
            chs.append(lib.Change(
                f"actor{w}", s, {f"actor{(w + 1) % 4}": 1} if s > 1 else {},
                tuple(lib.Op("set", ROOT_ID, key=f"k{(w + i) % 5}", value=v)
                      for i, v in enumerate(
                          (s, 1.5 * w, f"s{w % 2}", True, None))),
                f"m{w}" if s == 1 else None))
        parts.append(lib.changes_to_columns(chs))
    return parts


class _Port:
    Change, Op, changes_to_columns = Change, Op, wire.changes_to_columns


class _Ref:
    from automerge_tpu.core.change import Change, Op
    changes_to_columns = staticmethod(ref_wire.changes_to_columns)


@pytest.mark.parametrize("path", ["small", "numpy"])
def test_concat_columns_equals_the_reference(monkeypatch, path):
    """Both of concat_columns' paths (the pure-Python merge of small
    rounds and the numpy remap) give the reference's columns, and each
    other's."""
    port_parts, ref_parts = concat_parts(_Port), concat_parts(_Ref)
    assert sum(len(p.op_action) for p in port_parts) \
        <= wire._SMALL_CONCAT_OPS
    if path == "numpy":
        monkeypatch.setattr(wire, "_SMALL_CONCAT_OPS", 0)
        monkeypatch.setattr(ref_wire, "_SMALL_CONCAT_OPS", 0)
    got = wire.concat_columns(port_parts)
    assert_same_columns(got, ref_wire.concat_columns(ref_parts))
    assert_same_columns(got, wire._concat_columns_small(port_parts))
    assert got.to_changes() == [c for p in port_parts
                                for c in p.to_changes()]


def test_concat_columns_remaps_tables_and_keeps_value_types():
    a = wire.changes_to_columns([Change("X", 1, {}, (
        Op("set", ROOT_ID, key="k", value=1.5),
        Op("set", ROOT_ID, key="big", value=2**70)), "msg-a")])
    b = wire.changes_to_columns([Change("Y", 1, {"X": 1}, (
        Op("set", ROOT_ID, key="k", value=True),
        Op("set", ROOT_ID, key="s", value="str")))])
    m = wire.concat_columns([a, b])
    chs = m.to_changes()
    assert [c.actor for c in chs] == ["X", "Y"]
    assert chs[0].message == "msg-a" and chs[1].message is None
    assert chs[1].deps == {"X": 1}
    assert [op.value for c in chs for op in c.ops] == [1.5, 2**70, True,
                                                       "str"]
    assert m.objects.count(ROOT_ID) == 1 and m.keys.count("k") == 1
    assert wire.concat_columns([a]) is a


def test_concat_columns_rejects_an_out_of_range_index():
    a = wire.changes_to_columns([Change("X", 1, {}, (
        Op("set", ROOT_ID, key="k", value=1),))])
    a.op_key = np.asarray([3], np.int32)
    with pytest.raises(IndexError):
        wire.concat_columns([a, a])


# ---------------------------------------------------------------------------
# the delta encoder

def admit_all(cols_list, doc_of, rank_of, n_changes):
    """Admission arrays for every change of every frame, in frame order
    (each doc's changes in causal order already)."""
    adm = {k: [] for k in ("frame", "idx", "doc", "arank", "seq", "cidx")}
    for f, (cols, d) in enumerate(zip(cols_list, doc_of)):
        for j in range(cols.n_changes):
            adm["frame"].append(f)
            adm["idx"].append(j)
            adm["doc"].append(d)
            adm["arank"].append(rank_of[cols.actors[cols.change_actor[j]]])
            adm["seq"].append(int(cols.change_seq[j]))
            adm["cidx"].append(n_changes[d])
            n_changes[d] += 1
    return adm


def run_encoder(enc, frames, adm, n_docs):
    enc.ensure_docs(n_docs)
    enc.begin()
    enc.apply_frames(frames, adm["frame"], adm["idx"], adm["doc"],
                     adm["arank"], adm["seq"], adm["cidx"])
    return enc.finish()


def test_native_encoder_equals_the_reference_on_the_same_frames():
    """Two rounds over three docs (a map, text and a rich trace): every
    BatchDelta array and table addition equals the reference's, and the
    second round reuses the first's interning in both."""
    traces = [rich_trace(), text_doc()._doc.opset.get_missing_changes({}),
              multi_actor_doc()._doc.opset.get_missing_changes({})]
    actors = sorted({c.actor for t in traces for c in t})
    rank_of = {a: i for i, a in enumerate(actors)}
    port, ref = delta.NativeDeltaEncoder.create(), \
        ref_delta.NativeDeltaEncoder.create()
    n_port, n_ref = [0, 0, 0], [0, 0, 0]
    for cut in (slice(0, 2), slice(2, None)):
        parts = [to_port(t[cut]) for t in traces]
        frames = [encode_frame(p) for p in parts]
        cols = [wire.changes_to_columns(p) for p in parts]
        got = run_encoder(port, frames, admit_all(cols, [0, 1, 2], rank_of,
                                                  n_port), 3)
        want = run_encoder(ref, frames, admit_all(cols, [0, 1, 2], rank_of,
                                                  n_ref), 3)
        for f in ("op_rows", "ins_rows", "newlist_rows", "stats"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)
        for f in ("new_objects", "new_fields", "new_values"):
            assert getattr(got, f) == getattr(want, f), f
        assert len(got.op_rows)


def test_native_and_python_encoders_agree():
    """The same history through native=True, native=False and the
    reference's native engine: hashes, decoded documents and the mirrored
    interning tables agree."""
    chs = rich_trace()
    nat = ResidentDocSet(["d"], device="cpu")
    py = ResidentDocSet(["d"], device="cpu", native=False)
    ref = RefResident(["d"], native=True)
    nat.apply_changes({"d": to_port(chs)})
    py.apply_changes({"d": to_port(chs)})
    ref.apply_changes({"d": chs})
    want = ref.reconcile()
    np.testing.assert_array_equal(nat.reconcile(), want)
    np.testing.assert_array_equal(py.reconcile(), want)
    assert nat.materialize("d") == py.materialize("d") == ref.materialize("d")
    tn, tp = nat.tables[0], py.tables[0]
    assert tn.objects == tp.objects == ref.tables[0].objects
    assert tn.fields == tp.fields == ref.tables[0].fields
    assert tn.value_list == tp.value_list == ref.tables[0].value_list
    assert (tn.n_lists, tn.max_elems) == \
        (len(tp.list_rows), max(len(s) for s in tp.elem_slots.values()))


def test_native_incremental_rounds_and_multi_doc():
    """Deltas across rounds reuse fields and values in the persistent C++
    tables; several docs share one native call a round."""
    nat = ResidentDocSet(["d", "e"], device="cpu")
    py = ResidentDocSet(["d", "e"], device="cpu", native=False)
    seen: dict = {}
    doc = am.change(am.init("A"), lambda d: d.__setitem__("xs", []))
    for r in range(5):
        doc = am.change(doc, lambda d, r=r: d["xs"].insert_at(
            len(d["xs"]), f"item{r}"))
        doc = am.change(doc, lambda d, r=r: d.__setitem__("n", r % 2))
        chs = to_port(doc._doc.opset.get_missing_changes(seen))
        seen = dict(doc._doc.opset.clock)
        rnd = {"d": chs, "e": chs[::-1]}
        np.testing.assert_array_equal(nat.apply_and_reconcile(rnd),
                                      py.apply_and_reconcile(rnd))
    assert nat.materialize("d") == py.materialize("d")


# ---------------------------------------------------------------------------
# the host linearizer

def random_tree(rng, n):
    """A random insertion tree with parent.elem < child.elem."""
    ins_mask = np.zeros(n, dtype=bool)
    ins_elem = np.zeros(n, dtype=np.int32)
    ins_actor = np.zeros(n, dtype=np.int32)
    ins_parent = np.full(n, -1, dtype=np.int32)
    for i in range(rng.randint(1, n)):
        ins_mask[i] = True
        ins_elem[i] = i + 1
        ins_actor[i] = rng.randint(0, 3)
        ins_parent[i] = rng.randint(-1, i - 1) if i else -1
    return ins_mask, ins_elem, ins_actor, ins_parent


@pytest.mark.parametrize("seed", range(8))
def test_linearize_host_equals_plain_reference_and_device(seed):
    args = random_tree(random.Random(seed), 64)
    got = linearize_host(*args)
    np.testing.assert_array_equal(got, linearize_host_plain(*args))
    np.testing.assert_array_equal(got, ref_linearize.linearize_host(*args))
    valid = args[0]
    dev = linearize(*(torch.from_numpy(a)[None] for a in args))[0].numpy()
    np.testing.assert_array_equal(got[valid], dev[valid])
    assert (got[~valid] == -1).all()


def test_linearize_host_long_chain_and_empty():
    n = 65536
    pos = linearize_host(np.ones(n, bool), np.arange(1, n + 1, dtype=np.int32),
                         np.zeros(n, np.int32),
                         np.arange(-1, n - 1, dtype=np.int32))
    np.testing.assert_array_equal(pos, np.arange(n))
    out = linearize_host(np.zeros(4, bool), np.zeros(4, np.int32),
                         np.zeros(4, np.int32), np.full(4, -1, np.int32))
    assert (out == -1).all()


# ---------------------------------------------------------------------------
# the build

def test_libraries_are_named_by_content_hash():
    for src, lib in (("wirecodec.cpp", "amtpuwire"),
                     ("deltaenc.cpp", "amtpudelta")):
        path = native.library_path(src, lib)
        assert path.parent == native.BUILD_DIR
        assert path.name.startswith(f"lib{lib}-") and path.suffix == ".so"
    native.get_lib()
    delta.NativeDeltaEncoder.create()
    assert native.library_path("wirecodec.cpp", "amtpuwire").exists()
    assert native.library_path("deltaenc.cpp", "amtpudelta").exists()


def test_concurrent_builds_install_one_whole_library(tmp_path):
    """Three processes build the codec into one empty directory at once
    (as parallel test workers do): each loads a whole library."""
    code = "\n".join([
        "import sys",
        "from pathlib import Path",
        "import automerge_tpu_torch.native as native",
        "native.BUILD_DIR = Path(sys.argv[1])",
        "from automerge_tpu_torch.native.linearize import linearize_host",
        "import numpy as np",
        "pos = linearize_host(np.ones(3, bool), np.arange(1, 4, dtype="
        "np.int32), np.zeros(3, np.int32), np.arange(-1, 2, dtype=np.int32))",
        "assert pos.tolist() == [0, 1, 2], pos",
        "print('ok')"])
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        assert out.strip() == "ok"
    assert [f.name for f in tmp_path.iterdir()] == [
        native.library_path("wirecodec.cpp", "amtpuwire").name]


def test_without_a_compiler_native_raises_and_nothing_falls_back(
        monkeypatch, tmp_path):
    """With no g++ on PATH and an empty build directory, every native
    entry raises RuntimeError; only native=False reaches the Python
    encoder."""
    empty = tmp_path / "bin"
    empty.mkdir()
    monkeypatch.setenv("PATH", str(empty))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_wire_state", {})
    monkeypatch.setattr(delta, "_state", {})
    for make in (lambda: ResidentDocSet(["a"], device="cpu"),
                 lambda: ResidentRowsDocSet(["a"], device="cpu"),
                 delta.NativeDeltaEncoder.create,
                 lambda: wire.parse_changes_json("[]"),
                 lambda: linearize_host(np.ones(1, bool),
                                        np.ones(1, np.int32),
                                        np.zeros(1, np.int32),
                                        np.full(1, -1, np.int32))):
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            make()
    assert not (tmp_path / "build").exists() or \
        not any((tmp_path / "build").iterdir())
    py = ResidentRowsDocSet(["a"], device="cpu", native=False)
    py.apply_rounds([{"a": [Change("A", 1, {}, [
        Op("set", ROOT_ID, key="k", value=1)])]}])
    assert py._native is None
