"""Snapshot images and snapshot boot of the port (automerge_tpu_torch/sync/
snapshots.py, ResidentRowsDocSet.seed_clock, the post-seed clock-row
clamp of resident.DocTables.snap_floor) against the reference's: the
survivor pass (`compact_prefix`), the image file (the same bytes for the
same prefix, and each package decodes the other's), `remap_tail`,
`validate_tail`, the store's surface, and a boot (every image through
apply_rounds, then seed_clock, then the tail) whose hashes, clocks and row
mirror equal the reference's and a full-history replay's. The port runs on
device="cpu".

Tolerance: exact. Every store lives under `tmp_path`."""

import os

import numpy as np
import pytest

import automerge_tpu as am
from automerge_tpu.engine import compaction as ref_compaction
from automerge_tpu.engine.resident_rows import (
    DeviceDispatchError as RefDispatchError, ResidentRowsDocSet as RefRows)
from automerge_tpu.sync import snapshots as ref_snap
from automerge_tpu.sync.frames import (
    encode_round_frame as ref_encode_round_frame)
from automerge_tpu.sync.logarchive import LogArchive as RefArchive

from automerge_tpu_torch.engine import compaction
from automerge_tpu_torch.engine.resident_rows import (DeviceDispatchError,
                                                      ResidentRowsDocSet)
from automerge_tpu_torch.sync import snapshots as snap
from automerge_tpu_torch.sync.frames import encode_round_frame
from automerge_tpu_torch.sync.logarchive import LogArchive
from automerge_tpu_torch.workloads import long_lived_changes

from test_torch_rows import history as concurrent_history
from torch_port_helpers import (assert_same_rows, build_history, changes_of,
                                to_port)


def move_history():
    d = am.change(am.init("A"), lambda x: am.assign(
        x, {"a": {"c": {"v": 1}}, "b": {}, "xs": [1, 2, 3]}))
    b = am.merge(am.init("B"), d)
    d = am.change(d, lambda x: x["a"].move("c", x["b"]))
    b = am.change(b, lambda x: x["xs"].move(0, 2))
    d = am.change(d, lambda x: x["b"].move("c", x["a"]))
    return changes_of(am.merge(d, b))


def histories():
    """(name, every change in causal order) of a few kinds of document."""
    from automerge_tpu.core.change import Change as RefChange
    long_lived = [RefChange.from_dict(c.to_dict())
                  for c in long_lived_changes(1, 1, 300)]
    return [("long_lived", long_lived),
            ("text_and_map", changes_of(build_history())),
            ("concurrent_0", concurrent_history(0)),
            ("concurrent_1", concurrent_history(1)),
            ("moves", move_history())]


HISTORIES = histories()
NAMES = [name for name, _ in HISTORIES]


def dicts(changes):
    return [c.to_dict() for c in changes]


def same_compacted(got: dict, want: dict) -> None:
    assert dicts(got["kept"]) == dicts(want["kept"])
    for k in ("clock", "heads", "kept_seqs", "n_in", "ops_in", "ops_kept"):
        assert got[k] == want[k], k


@pytest.mark.parametrize("idx", range(len(HISTORIES)), ids=NAMES)
def test_compact_prefix_equals_the_reference(idx):
    _name, chs = HISTORIES[idx]
    for cut in (len(chs) // 3, len(chs) - 2, len(chs)):
        got = snap.compact_prefix(to_port(chs[:cut]))
        want = ref_snap.compact_prefix(chs[:cut])
        same_compacted(got, want)
        assert got["ops_kept"] <= got["ops_in"]


@pytest.mark.parametrize("idx", range(len(HISTORIES)), ids=NAMES)
def test_image_bytes_equal_and_each_package_decodes_the_other(tmp_path, idx):
    _name, chs = HISTORIES[idx]
    cut = len(chs) - 2
    ref = ref_snap.SnapshotStore(str(tmp_path / "ref"))
    port = snap.SnapshotStore(str(tmp_path / "port"))
    info = port.write("doc", snap.compact_prefix(to_port(chs[:cut])))
    assert info == ref.write("doc", ref_snap.compact_prefix(chs[:cut]))
    blob = port.payload("doc")
    assert blob == ref.payload("doc")
    assert os.listdir(tmp_path / "port") == os.listdir(tmp_path / "ref")
    for img_p, img_r in ((port.load("doc"), ref.load("doc")),
                         (snap.SnapshotStore.decode(ref.payload("doc")),
                          ref_snap.SnapshotStore.decode(blob))):
        for k in img_r.__slots__:
            assert getattr(img_p, k) == getattr(img_r, k), k
        assert dicts(img_p.columns().to_changes()) == \
            dicts(img_r.columns().to_changes())
    assert port.doc_ids() == ref.doc_ids() == ["doc"]
    # a peer's image adopted by each package is the same file
    port.adopt("other", ref.payload("doc"))
    ref.adopt("other", blob)
    assert port.payload("other") == ref.payload("other") == blob
    # doc_ids reads each image's header (the adopted one names "doc"); a
    # torn tmp file is ignored; a damaged image raises
    with open(os.path.join(port.root, "x.snap.tmp"), "wb") as f:
        f.write(blob[:7])
    assert port.doc_ids() == ref.doc_ids() == ["doc", "doc"]
    with pytest.raises(ValueError):
        port.adopt("bad", blob[:-1] + bytes([blob[-1] ^ 1]))
    with pytest.raises(ValueError):
        snap.SnapshotStore.decode(b"XXXXX" + blob[5:])
    assert port.load("missing") is None and port.payload("missing") is None


@pytest.mark.parametrize("idx", range(len(HISTORIES)), ids=NAMES)
def test_remap_and_validate_tail_equal_the_reference(idx):
    _name, chs = HISTORIES[idx]
    cut = max(1, len(chs) - 4)
    got = snap.compact_prefix(to_port(chs[:cut]))
    want = ref_snap.compact_prefix(chs[:cut])
    tail = chs[cut:]
    assert dicts(snap.remap_tail(to_port(tail), got["clock"],
                                 got["kept_seqs"])) == \
        dicts(ref_snap.remap_tail(tail, want["clock"], want["kept_seqs"]))
    assert snap.validate_tail(to_port(tail), got["clock"], got["heads"]) \
        == ref_snap.validate_tail(tail, want["clock"], want["heads"])


def conforming_cut(chs) -> int:
    """The latest cut, at least 3 changes before the end, whose tail covers
    the prefix's clock (`validate_tail`): the snapshot contract, which a
    writer meets by snapshotting at the compaction floor."""
    for cut in range(len(chs) - 3, 0, -1):
        img = snap.compact_prefix(to_port(chs[:cut]))
        if snap.validate_tail(to_port(chs[cut:]), img["clock"],
                              img["heads"]):
            return cut
    raise AssertionError("no conforming cut")


def boot(rset, images: dict, tail: dict, frames: bool, encode):
    """Snapshot boot (reference resident_rows.py:905-912): one apply_rounds
    of every image, seed_clock per doc, then the tail. A seeded doc's row
    of the dense admission cache is stale until refreshed."""
    rset.apply_rounds([{d: img.columns().to_changes()
                        for d, img in images.items()}])
    for d, img in images.items():
        rset.seed_clock(d, img.clock, img.heads)
        assert rset.doc_index[d] in rset._cache_dirty
    if isinstance(rset, ResidentRowsDocSet):
        rset._refresh_admission_cache()
        for d, img in images.items():
            row = rset._clock_cache[rset.doc_index[d]]
            for a, s in img.clock.items():
                assert row[rset.actor_rank[a]] == s
    if frames:
        rset.apply_round_frames([encode(tail)])
    else:
        rset.apply_rounds([tail])


@pytest.mark.parametrize("frames", [True, False])
@pytest.mark.parametrize("native", [True, False])
def test_snapshot_boot_equals_full_history(tmp_path, native, frames):
    ids = [name for name in NAMES if name != "moves"]
    per_doc = dict(HISTORIES)
    cut = {d: conforming_cut(per_doc[d]) for d in ids}
    ref_store = ref_snap.SnapshotStore(str(tmp_path / "ref"))
    port_store = snap.SnapshotStore(str(tmp_path / "port"))
    for d in ids:
        ref_store.write(d, ref_snap.compact_prefix(per_doc[d][:cut[d]]))
        port_store.write(d, snap.compact_prefix(to_port(per_doc[d][:cut[d]])))
    tail = {d: per_doc[d][cut[d]:] for d in ids}
    ref = RefRows(ids, native=native)
    port = ResidentRowsDocSet(ids, device="cpu", native=native)
    boot(ref, {d: ref_store.load(d) for d in ids}, tail, frames,
         ref_encode_round_frame)
    boot(port, {d: port_store.load(d) for d in ids},
         {d: to_port(c) for d, c in tail.items()}, frames,
         encode_round_frame)
    assert_same_rows(ref, port)
    for i, d in enumerate(ids):
        assert port.tables[i].snap_floor == ref.tables[i].snap_floor
        assert compaction.causal_floor(port, i) == \
            ref_compaction.causal_floor(ref, i)
    full = ResidentRowsDocSet(ids, device="cpu", native=native)
    full.apply_rounds([{d: to_port(per_doc[d]) for d in ids}])
    np.testing.assert_array_equal(port.hashes(), full.hashes())
    # redelivered prefix changes drop below the seeded clock
    logs = [len(log) for log in port.change_log]
    port.apply_rounds([{d: to_port(per_doc[d][max(0, cut[d] - 5):cut[d]])
                        for d in ids}])
    assert [len(log) for log in port.change_log] == logs
    np.testing.assert_array_equal(port.hashes(), full.hashes())


def test_clock_rows_clamp_to_the_snapshot_floor():
    """A post-seed change whose deps name a head the image compacted away
    still gets the covered clock in its row (the clamp), as in the
    reference."""
    chs = changes_of(build_history())
    img_r = ref_snap.compact_prefix(chs[:-1])
    img_p = snap.compact_prefix(to_port(chs[:-1]))
    ref = RefRows(["doc"], native=False)
    port = ResidentRowsDocSet(["doc"], device="cpu", native=False)
    for rset, img, conv in ((ref, img_r, list), (port, img_p, to_port)):
        rset.apply_rounds([{"doc": img["kept"]}])
        rset.seed_clock("doc", img["clock"], img["heads"])
        rset.apply_rounds([{"doc": conv(chs[-1:])}])
    key = (chs[-1].actor, chs[-1].seq)
    assert port.tables[0].state_clocks[key] == ref.tables[0].state_clocks[key]
    assert port.tables[0].state_clocks[key]["alice"] >= chs[-2].seq
    assert_same_rows(ref, port)


@pytest.mark.parametrize("with_archive", [False, True])
def test_rebuild_replays_a_snapshot_booted_doc_from_its_image(
        tmp_path, monkeypatch, with_archive):
    """A snapshot-booted doc whose archive holds only its post-boot tail
    (or no archive at all) rebuilds from its image, re-seeded, then the
    tail; without an image the rebuild poisons. Both as the reference."""
    chs = changes_of(build_history())
    cut = len(chs) - 6
    ids = ["doc"]
    engines = {}
    for pkg in ("ref", "port"):
        store_cls = ref_snap.SnapshotStore if pkg == "ref" \
            else snap.SnapshotStore
        comp = ref_snap.compact_prefix if pkg == "ref" \
            else snap.compact_prefix
        conv = list if pkg == "ref" else to_port
        store = store_cls(str(tmp_path / pkg / "snap"))
        store.write("doc", comp(conv(chs[:cut])))
        rset = RefRows(ids) if pkg == "ref" else \
            ResidentRowsDocSet(ids, device="cpu")
        rset.snapshot_store = store
        if with_archive:
            arch_cls = RefArchive if pkg == "ref" else LogArchive
            rset.log_archive = arch_cls(str(tmp_path / pkg / "arch"))
        img = store.load("doc")
        rset.apply_rounds([{"doc": img.columns().to_changes()}])
        rset.seed_clock("doc", img.clock, img.heads)
        rset.change_log[0] = []
        rset.log_horizon[0] = dict(img.clock)
        rset.apply_rounds([{"doc": conv(chs[cut:-2])}])
        if with_archive:
            rset.archive_log_prefix("doc", {"alice": chs[-3].seq})
        engines[pkg] = rset
    ref, port = engines["ref"], engines["port"]
    assert_same_rows(ref, port)

    def boom(*a, **k):
        raise MemoryError("grow failed mid-scatter")
    for rset in (ref, port):
        monkeypatch.setattr(rset, "_cols_triplets", boom)
    with pytest.raises(RefDispatchError):
        ref.apply_rounds([{"doc": chs[-2:]}])
    with pytest.raises(DeviceDispatchError) as err:
        port.apply_rounds([{"doc": to_port(chs[-2:])}])
    assert not err.value.admission_complete
    assert port.tables[0].snap_floor == ref.tables[0].snap_floor
    assert port.log_horizon == ref.log_horizon
    assert [len(x) for x in port.change_log] == \
        [len(x) for x in ref.change_log]
    assert_same_rows(ref, port)
    full = ResidentRowsDocSet(ids, device="cpu")
    full.apply_rounds([{"doc": to_port(chs)}])
    np.testing.assert_array_equal(port.hashes(), full.hashes())
    # with the image gone, the next rebuild poisons both
    for rset in (ref, port):
        os.remove(rset.snapshot_store._path("doc"))
        rset.snapshot_store._cache.clear()
        monkeypatch.setattr(rset, "_cols_triplets", boom)
    d2 = am.change(build_history(), lambda x: x.__setitem__("z", 1))
    extra = [c for c in changes_of(d2) if c.seq == chs[-1].seq + 1]
    extra[0].deps = {}
    with pytest.raises(RuntimeError, match="no local snapshot image"):
        ref.apply_rounds([{"doc": extra}])
    with pytest.raises(RuntimeError, match="no local snapshot image"):
        port.apply_rounds([{"doc": to_port(extra)}])
    for rset in (ref, port):
        with pytest.raises(RuntimeError, match="no longer reflects"):
            rset.hashes()


def test_archive_covers_floor_equals_the_reference():
    chs = to_port(changes_of(build_history()))
    for archived, floor in ((chs, {"alice": 5}), (chs[3:], {"alice": 5}),
                            ([], {}), ([], {"alice": 1}),
                            (chs, {"alice": 5, "bob": 1})):
        assert ResidentRowsDocSet._archive_covers_floor(archived, floor) == \
            RefRows._archive_covers_floor(archived, floor)
