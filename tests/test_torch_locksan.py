"""The port's lock-order sanitizer (`automerge_tpu_torch/utils/locksan.py`)
and `lockprof`'s hooks into it, held to the reference's on the CPU.

Through `torch_twin_helpers.run_twin`, every case of the reference's
`tests/test_locksan.py` runs on both packages. One of them,
`test_arms_at_import_in_fresh_process`, starts a child process that
imports the reference's module by name, so its port run checks the
reference again; `test_port_arms_at_import_in_fresh_process` below is
the port's. The sanitizer's switch is set only through `monkeypatch`
and re-read at teardown (`hygiene_teardown` re-reads both packages').

The port's own cases: the manifest resolves to the repository's
`locks_manifest.json`, the port's runtime lock names map to the
reference's manifest ids, and a strict-mode run of the port's live
threads (a sharded node, a TCP pair, an archive) keeps the committed
order. Tolerance: exact.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from torch_twin_helpers import collect, hygiene_teardown, run_twin

from automerge_tpu.utils import locksan as ref_locksan

from automerge_tpu_torch.core.change import Change, Op
from automerge_tpu_torch.core.ids import ROOT_ID
from automerge_tpu_torch.sync import ShardedEngineDocSet
from automerge_tpu_torch.sync.service import EngineDocSet
from automerge_tpu_torch.sync.tcp import TcpSyncClient, TcpSyncServer
from automerge_tpu_torch.utils import lockprof, locksan

REPO = Path(__file__).resolve().parents[1]

CASES = collect("test_locksan")


@pytest.fixture(autouse=True)
def _hygiene():
    yield
    hygiene_teardown()


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reference_case_on_both_packages(case, tmp_path, monkeypatch):
    run_twin(case, tmp_path, monkeypatch)


def _reload_both():
    locksan._reload_for_tests()
    ref_locksan._reload_for_tests()


def test_port_arms_at_import_in_fresh_process():
    env = dict(os.environ, AMTPU_LOCKSAN="1")
    env.pop("AMTPU_LOCKSAN_MANIFEST", None)
    out = subprocess.run(
        [sys.executable, "-c",
         "from automerge_tpu_torch.utils import locksan; print(locksan.on)"],
        env=env, capture_output=True, text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "True"


def test_manifest_resolves_at_the_repo_root(monkeypatch):
    monkeypatch.delenv("AMTPU_LOCKSAN_MANIFEST", raising=False)
    assert locksan._manifest_path() == REPO / "locks_manifest.json"
    assert locksan._manifest_path() == ref_locksan._manifest_path()
    monkeypatch.setenv("AMTPU_LOCKSAN_MANIFEST", "/elsewhere/m.json")
    assert str(locksan._manifest_path()) == "/elsewhere/m.json"


@pytest.mark.parametrize("name", ["service", "service_shard0",
                                  "service_shard7", "tcp_peers",
                                  "peer_send", "archive", "snapshots"])
def test_runtime_names_map_to_the_reference_ids(monkeypatch, name):
    monkeypatch.delenv("AMTPU_LOCKSAN_MANIFEST", raising=False)
    _reload_both()
    got = locksan._resolve(name)
    assert got is not None
    assert got == ref_locksan._resolve(name)


def _wait(predicate, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return False


def test_strict_mode_port_threads_keep_the_committed_order(monkeypatch,
                                                           tmp_path):
    """AMTPU_LOCKSAN=2 against the committed manifest: a sharded node
    (its shard locks renamed `service_shard<k>`) with an archive, served
    over TCP to a rows node, syncs with no order violation raised or
    recorded. The TCP server's peer list lock is a sanitizer lock."""
    monkeypatch.delenv("AMTPU_LOCKSAN_MANIFEST", raising=False)
    monkeypatch.setenv("AMTPU_LOCKSAN", "2")
    _reload_both()
    assert locksan.on
    sharded = ShardedEngineDocSet(n_shards=3, devices=["cpu"],
                                  log_archive_dir=str(tmp_path))
    plain = EngineDocSet(backend="rows", device="cpu")
    server = TcpSyncServer(sharded, wire="columnar").start()
    client = None
    try:
        assert isinstance(server._peers_lock, locksan._SanLock)
        assert isinstance(sharded.shards[2]._lock,
                          lockprof.InstrumentedRLock)
        client = TcpSyncClient(plain, server.host, server.port,
                               wire="columnar").start()
        for i in range(12):
            sharded.apply_changes(f"d{i}", [Change(
                actor="S", seq=1, deps={},
                ops=[Op("set", ROOT_ID, key="k", value=i)])])
        plain.apply_changes("p", [Change(
            actor="P", seq=1, deps={},
            ops=[Op("set", ROOT_ID, key="k", value=1)])])
        assert _wait(lambda: set(plain.doc_ids) == set(sharded.doc_ids)
                     and plain.hashes() == sharded.hashes())
        sharded.archive_logs()
    finally:
        if client is not None:
            client.close()
        server.close()
        sharded.close()
        plain.close()
    assert [v for v in locksan.violations() if v["kind"] == "order"] == []


def test_self_seconds_count_the_hooks_while_on(monkeypatch):
    """The sanitizer's own time (`self_seconds`, the race smoke's
    overhead reading) grows only while it is on, from every thread that
    takes a sanitized lock, and `reset` zeroes it."""
    import threading

    monkeypatch.setenv("AMTPU_LOCKSAN", "1")
    locksan._reload_for_tests()
    assert locksan.self_seconds() == 0.0
    lock = locksan.named_lock("service")

    def take(n=50):
        for _ in range(n):
            with lock:
                pass
    take()
    mine = locksan.self_seconds()
    assert mine > 0.0
    t = threading.Thread(target=take, name="amtpu-torch-test-locksan")
    t.start()
    t.join()
    assert locksan.self_seconds() > mine
    locksan.reset()
    assert locksan.self_seconds() == 0.0
    monkeypatch.delenv("AMTPU_LOCKSAN")
    locksan._reload_for_tests()
    take()
    assert locksan.self_seconds() == 0.0
