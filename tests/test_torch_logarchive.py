"""The log-horizon layer of the port (automerge_tpu_torch/sync/logarchive.py
and ResidentRowsDocSet.archive_log_prefix) against the reference's: the
archive cases of tests/test_log_horizon.py at engine level (EngineDocSet is
not ported), plus cross-reads. The archive is a storage format, so both
packages write the same bytes for the same appends (active segments,
sealed segments, manifests) and each reads the other's directory.

Tolerance: exact (file bytes, change dicts, counts, hashes). Metrics
counters are compared as deltas; every store lives under `tmp_path`;
environment switches are set only through `monkeypatch`."""

import json
import os
import sys
import threading

import numpy as np
import pytest

import automerge_tpu as am
from automerge_tpu.engine.resident_rows import (
    DeviceDispatchError as RefDispatchError, ResidentRowsDocSet as RefRows)
from automerge_tpu.sync import logarchive as ref_la
from automerge_tpu.sync.frames import (
    encode_round_frame as ref_encode_round_frame)

from automerge_tpu_torch.engine.resident_rows import (DeviceDispatchError,
                                                      ResidentRowsDocSet)
from automerge_tpu_torch.sync import logarchive as la
from automerge_tpu_torch.sync.frames import encode_round_frame
from automerge_tpu_torch.utils import chaos, lockprof, metrics

from torch_port_helpers import assert_same_rows, changes_of, to_port


def history(n_rounds=40):
    d = am.change(am.init("alice"), lambda x: x.__setitem__("t", am.Text()))
    d = am.change(d, lambda x: x["t"].insert_at(0, *"hello"))
    for k in range(n_rounds):
        d = am.change(d, lambda x, k=k: x.__setitem__("n", k))
    return d


def concurrent_history():
    """Three writers with merges (deps across actors), one doc."""
    base = am.change(am.init("A"), lambda x: x.__setitem__("t", am.Text()))
    reps = {"A": base, "B": am.merge(am.init("B"), base),
            "C": am.merge(am.init("C"), base)}
    for k in range(12):
        for a in "ABC":
            reps[a] = am.change(reps[a], lambda x, k=k, a=a: x.__setitem__(
                f"{a}{k % 3}", k))
        if k % 4 == 3:
            reps["A"] = am.merge(reps["A"], reps["C"])
            reps["B"] = am.merge(reps["B"], reps["A"])
    m = reps["A"]
    for a in "BC":
        m = am.merge(m, reps[a])
    return changes_of(m)


def delta(before: dict, key: str) -> int:
    return metrics.snapshot().get(key, 0) - before.get(key, 0)


def files_of(root) -> dict:
    out = {}
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name), "rb") as f:
            out[name] = f.read()
    return out


def dicts(changes) -> list:
    return [c.to_dict() for c in changes]


@pytest.fixture
def small_segments(monkeypatch):
    """Rotation bounds small enough that the appends below seal segments,
    in both packages (module globals read at each append)."""
    for mod in (la, ref_la):
        monkeypatch.setattr(mod, "SEGMENT_RECORDS", 7)
        monkeypatch.setattr(mod, "SEGMENT_BYTES", 1 << 20)


def test_archive_bytes_equal_and_each_package_reads_the_other(
        tmp_path, small_segments):
    chs = concurrent_history()
    ref = ref_la.LogArchive(str(tmp_path / "ref"))
    port = la.LogArchive(str(tmp_path / "port"))
    for k in range(0, len(chs), 5):
        assert port.append("doc", to_port(chs[k:k + 5])) == \
            ref.append("doc", chs[k:k + 5])
        port.append("other", to_port(chs[k:k + 2]))
        ref.append("other", chs[k:k + 2])
    theirs, ours = files_of(tmp_path / "ref"), files_of(tmp_path / "port")
    assert ours == theirs
    assert any(".s0" in name for name in ours)           # sealed segments
    assert any(name.endswith(".manifest.json") for name in ours)
    for d in ("doc", "other"):
        want = dicts(ref.read(d))
        assert dicts(port.read(d)) == want
        assert dicts(la.LogArchive(str(tmp_path / "ref")).read(d)) == want
        assert dicts(ref_la.LogArchive(str(tmp_path / "port")).read(d)) \
            == want
        clock = {"A": 5, "B": 3, "C": 9}
        assert dicts(port.read_since(d, clock)) == \
            dicts(ref.read_since(d, clock))
        assert port.stats(d) == ref.stats(d)


@pytest.mark.parametrize("route,native", [("frames", True), ("rounds", True),
                                          ("rounds", False)])
def test_archive_log_prefix_matches_the_reference(tmp_path, route, native):
    chs = changes_of(history())
    ref = RefRows(["doc"], native=native)
    port = ResidentRowsDocSet(["doc"], device="cpu", native=native)
    ref.log_archive = ref_la.LogArchive(str(tmp_path / "ref"))
    port.log_archive = la.LogArchive(str(tmp_path / "port"))
    if route == "frames":
        ref.apply_round_frames([ref_encode_round_frame({"doc": chs})])
        port.apply_round_frames([encode_round_frame({"doc": to_port(chs)})])
    else:
        ref.apply_rounds([{"doc": chs}])
        port.apply_rounds([{"doc": to_port(chs)}])
    h0 = port.hashes()
    # a lagging peer bounds the horizon; a floor that has not moved is a
    # no-op; once it catches up the rest moves
    for floor, moved in (({"alice": 10}, 10), ({"alice": 10}, 0),
                         ({"alice": chs[-1].seq}, len(chs) - 10)):
        assert port.archive_log_prefix("doc", floor) == moved
        assert ref.archive_log_prefix("doc", floor) == moved
        assert port.log_horizon == ref.log_horizon
        assert len(port.change_log[0]) == len(ref.change_log[0])
    assert port.log_horizon == [{"alice": chs[-1].seq}]
    assert port.change_log == [[]]
    assert files_of(tmp_path / "port") == files_of(tmp_path / "ref")
    assert dicts(port.log_archive.read("doc")) == dicts(chs)
    np.testing.assert_array_equal(port.hashes(), h0)
    # no archive attached, or an empty floor: nothing moves
    assert ResidentRowsDocSet(["doc"], device="cpu").archive_log_prefix(
        "doc", {"alice": 3}) == 0
    assert port.archive_log_prefix("doc", {}) == 0


def test_torn_archive_tail_is_skipped(tmp_path):
    chs = changes_of(history())
    arch = la.LogArchive(str(tmp_path / "a"))
    arch.append("doc", to_port(chs))
    path = arch._path("doc")
    with open(path, "a") as f:
        f.write('{"actor": "alice", "se')     # torn mid-record
    before = metrics.snapshot()
    got = arch.read("doc")
    assert dicts(got) == dicts(chs)
    assert delta(before, "sync_archive_tail_skipped") == 1
    assert dicts(ref_la.LogArchive(str(tmp_path / "a")).read("doc")) == \
        dicts(chs)
    # corruption before the tail is not skipped, in either package
    lines = open(path).read().split("\n")
    lines[1] = lines[1][:10]
    open(path, "w").write("\n".join(lines))
    with pytest.raises(json.JSONDecodeError):
        la.LogArchive(str(tmp_path / "a")).read("doc")
    with pytest.raises(json.JSONDecodeError):
        ref_la.LogArchive(str(tmp_path / "a")).read("doc")


def test_append_after_torn_tail_repairs_not_glues(tmp_path):
    chs = changes_of(history(6))
    for mod, root, conv in ((la, "port", to_port), (ref_la, "ref", list)):
        arch = mod.LogArchive(str(tmp_path / root))
        arch.append("d", conv(chs[:3]))
        with open(arch._path("d"), "a") as f:
            f.write('{"torn": tru')
        assert len(arch.read("d")) == 3
        arch.append("d", conv(chs[3:]))
    before = metrics.snapshot()
    port = la.LogArchive(str(tmp_path / "port2"))
    port.append("d", to_port(chs[:3]))
    with open(port._path("d"), "a") as f:
        f.write('{"torn": tru')
    port.append("d", to_port(chs[3:]))
    assert delta(before, "sync_archive_tail_repaired") == 1
    assert sorted((c.actor, c.seq) for c in port.read("d")) == \
        sorted((c.actor, c.seq) for c in chs)
    assert files_of(tmp_path / "port") == files_of(tmp_path / "ref")


def test_first_archive_append_fsyncs_directory(tmp_path, monkeypatch):
    chs = to_port(changes_of(history(6)))
    arch = la.LogArchive(str(tmp_path / "a"))
    dir_syncs = []
    real = la.LogArchive._fsync_dir
    monkeypatch.setattr(
        la.LogArchive, "_fsync_dir",
        lambda self: (dir_syncs.append(self.root), real(self))[1])
    arch.append("d", chs[:3])
    assert dir_syncs == [arch.root]     # first creation: directory synced
    arch.append("d", chs[3:])
    assert dir_syncs == [arch.root]     # an existing file: no re-sync
    arch.append("d2", chs[:2])
    assert dir_syncs == [arch.root, arch.root]


def test_cold_read_parses_outside_lock_and_caches(tmp_path, monkeypatch):
    chs = to_port(changes_of(history(8)))
    arch = la.LogArchive(str(tmp_path / "a"))
    arch.append("d", chs[:4])
    assert len(arch.read("d")) == 4
    before = metrics.snapshot()
    first = arch.read("d")
    assert arch.read("d") is first      # the same tuple, no copy
    assert delta(before, "sync_archive_reads_cached") == 2
    arch.append("d", chs[4:6])
    assert len(arch.read("d")) == 6     # re-parsed, not a stale serve
    arch.append("d", chs[6:8])
    parse_started = threading.Event()
    release = threading.Event()
    real_loads = la.json.loads

    def slow_loads(s, *a, **kw):
        parse_started.set()
        release.wait(timeout=10.0)
        return real_loads(s, *a, **kw)
    monkeypatch.setattr(la.json, "loads", slow_loads)
    out: list = []
    t = threading.Thread(target=lambda: out.append(arch.read("d")),
                         daemon=True)
    t.start()
    try:
        assert parse_started.wait(timeout=10.0)
        # the reader is mid-parse: the archive lock is free
        assert arch._lock.acquire(timeout=5.0)
        arch._lock.release()
    finally:
        release.set()
        t.join(timeout=10.0)
    assert not t.is_alive() and len(out[0]) == 8


def test_sealed_segment_checks_and_orphan_adoption(tmp_path, small_segments):
    chs = concurrent_history()
    for mod, root, conv in ((la, "port", to_port), (ref_la, "ref", list)):
        arch = mod.LogArchive(str(tmp_path / root))
        for k in range(0, 30, 6):
            arch.append("doc", conv(chs[k:k + 6]))
        os.remove(arch._manifest_path("doc"))
    before = metrics.snapshot()
    port = la.LogArchive(str(tmp_path / "port"))
    assert dicts(port.read("doc")) == dicts(chs[:30])
    assert delta(before, "sync_segments_adopted") >= 2
    assert dicts(ref_la.LogArchive(str(tmp_path / "ref")).read("doc")) == \
        dicts(chs[:30])
    assert files_of(tmp_path / "port") == files_of(tmp_path / "ref")
    # a sealed segment that changed under its manifest entry fails loudly
    sealed = sorted(n for n in os.listdir(tmp_path / "port") if ".s0" in n)
    with open(tmp_path / "port" / sealed[0], "ab") as f:
        f.write(b"\n")
    with pytest.raises(la.SegmentMismatchError):
        la.LogArchive(str(tmp_path / "port")).read("doc")
    os.remove(tmp_path / "port" / sealed[0])
    with pytest.raises(la.SegmentMismatchError):
        la.LogArchive(str(tmp_path / "port")).read("doc")


def test_read_since_skips_covered_segments(tmp_path, small_segments):
    chs = [c for c in concurrent_history() if c.actor == "A"]
    arch = la.LogArchive(str(tmp_path / "a"))
    for k in range(0, len(chs), 7):
        arch.append("doc", to_port(chs[k:k + 7]))
    before = metrics.snapshot()
    got = arch.read_since("doc", {"A": 8})
    assert [c.seq for c in got] == [c.seq for c in chs if c.seq > 8]
    assert delta(before, "sync_segments_skipped") == 1
    assert dicts(arch.read_since("doc", {})) == dicts(chs)


def test_concurrent_writers_and_a_reader(tmp_path, small_segments):
    """Three writer threads append their own actor's changes while a
    reader reads in a loop, with segments sealing under them: no error, no
    deadlock, and the final read holds every change once."""
    chs = concurrent_history()
    arch = la.LogArchive(str(tmp_path / "a"))
    errors: list = []
    stop = threading.Event()

    def writer(actor):
        try:
            for c in to_port([c for c in chs if c.actor == actor]):
                arch.append("doc", [c])
        except Exception as e:  # reported below
            errors.append(e)

    def reader():
        try:
            while not stop.is_set():
                arch.read("doc")
                arch.read_since("doc", {"A": 3})
                arch.stats("doc")
        except Exception as e:
            errors.append(e)

    ws = [threading.Thread(target=writer, args=(a,), daemon=True)
          for a in "ABC"]
    rd = threading.Thread(target=reader, daemon=True)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in ws + [rd]:
            t.start()
        for t in ws:
            t.join(timeout=60)
        stop.set()
        rd.join(timeout=30)
    finally:
        stop.set()
        sys.setswitchinterval(interval)
    assert not errors, errors
    assert not any(t.is_alive() for t in ws + [rd])
    got = arch.read("doc")
    assert sorted((c.actor, c.seq) for c in got) == \
        sorted((c.actor, c.seq) for c in chs)
    assert arch.stats("doc")["sealed_segments"] >= 2


@pytest.mark.parametrize("native", [True, False])
def test_rebuild_replays_archive_plus_tail(tmp_path, monkeypatch, native):
    """A mid-admission failure after the prefix was archived rebuilds from
    the archive plus the RAM tail, as the reference does under the same
    fault: equal hashes, the full log back in RAM, an empty horizon, and a
    clean re-archive."""
    d = history()
    chs = changes_of(d)
    ref = RefRows(["doc"], native=native)
    port = ResidentRowsDocSet(["doc"], device="cpu", native=native)
    ref.log_archive = ref_la.LogArchive(str(tmp_path / "ref"))
    port.log_archive = la.LogArchive(str(tmp_path / "port"))
    ref.apply_rounds([{"doc": chs[:-5]}])
    port.apply_rounds([{"doc": to_port(chs[:-5])}])
    floor = {"alice": chs[-6].seq}
    assert port.archive_log_prefix("doc", floor) == \
        ref.archive_log_prefix("doc", floor)
    ref.apply_rounds([{"doc": chs[-5:-2]}])
    port.apply_rounds([{"doc": to_port(chs[-5:-2])}])
    assert len(port.change_log[0]) == 3

    def boom(*a, **k):
        raise MemoryError("grow failed mid-scatter")
    name = "_cols_triplets" if native else "_linearized_pos_rows"
    monkeypatch.setattr(ref, name, boom)
    monkeypatch.setattr(port, name, boom)
    d2 = am.change(d, lambda x: [x["t"].insert_at(0, "!"),
                                 x.__setitem__("post", 1)])
    tail = changes_of(d2)[-3:]
    with pytest.raises(RefDispatchError) as ref_err:
        ref.apply_rounds([{"doc": tail}])
    with pytest.raises(DeviceDispatchError) as err:
        port.apply_rounds([{"doc": to_port(tail)}])
    assert not err.value.admission_complete
    assert not ref_err.value.admission_complete
    # the rebuilt instance: fresh internals (the fault is gone), the full
    # log in RAM, no horizon, the same state as the reference's
    assert name not in port.__dict__
    assert port.log_horizon == ref.log_horizon == [{}]
    assert len(port.change_log[0]) == len(ref.change_log[0]) \
        == len(chs) + 1
    assert port._rebuild_gen == 1
    assert_same_rows(ref, port)
    # the round's replay is a duplicate-drop; re-archiving after the
    # rebuild is clean (the read dedups)
    ref.apply_rounds([{"doc": tail}])
    port.apply_rounds([{"doc": to_port(tail)}])
    assert len(port.change_log[0]) == len(chs) + 1
    assert_same_rows(ref, port)
    full = {"alice": tail[-1].seq}
    assert port.archive_log_prefix("doc", full) == \
        ref.archive_log_prefix("doc", full)
    assert dicts(port.log_archive.read("doc")) == \
        dicts(ref.log_archive.read("doc"))
    assert files_of(tmp_path / "port") == files_of(tmp_path / "ref")


def test_disk_stall_is_injected_only_where_targeted(tmp_path, monkeypatch):
    chs = to_port(changes_of(history(4)))
    monkeypatch.setenv("AMTPU_CHAOS_DISK_STALL_S", "0.01")
    monkeypatch.setenv("AMTPU_CHAOS_NODE", "n1")
    chaos.reload()
    try:
        before = metrics.snapshot()
        hit = la.LogArchive(str(tmp_path / "hit"))
        hit.chaos_node = "n1"
        hit.append("d", chs)
        miss = la.LogArchive(str(tmp_path / "miss"))
        miss.chaos_node = "n2"
        miss.append("d", chs)
        assert delta(before, "obs_chaos_injected{fault=disk_stall}") == 1
        assert delta(before, "sync_archive_fsync_s_count") == 2
        assert metrics.snapshot()["sync_archive_fsync_s_max"] >= 0.01
    finally:
        monkeypatch.undo()
        chaos.reload()
    before = metrics.snapshot()
    la.LogArchive(str(tmp_path / "off")).append("d", chs)
    assert delta(before, "obs_chaos_injected{fault=disk_stall}") == 0


def test_instrumented_lock_counts_contention_and_holds():
    lock = lockprof.InstrumentedLock("test_lock")
    before = metrics.snapshot()
    with lock:
        assert lock.locked()
        got: list = []
        t = threading.Thread(
            target=lambda: got.append(lock.acquire(timeout=0.05)))
        t.start()
        t.join()
        assert got == [False]
        assert not lock.acquire(blocking=False)
    assert not lock.locked()
    assert delta(before, "sync_lock_contended_total{lock=test_lock}") == 2
    assert delta(before, "sync_lock_hold_s{lock=test_lock}_count") == 1
    assert delta(before, "sync_lock_wait_s{lock=test_lock}_count") == 2
