"""The port's multi-process layer (`automerge_tpu_torch/parallel/
multihost.py`, `collective.py`) across real OS processes on the CPU: the
five cases of the reference's `tests/test_multihost.py`, run by the
port's workers (`tests/torch_multihost_worker.py`, `torch_multihost_
resident_worker.py`, `torch_multihost_ring_worker.py`):

- two processes whose interpretive DocSets sync over TCP in the
  reference's JSON protocol, then one gloo group, a global mesh of 8 CPU
  shards (4 a process), `reconcile_global` and the clock union;
- the same with `EngineDocSet` nodes syncing binary columnar frames, on
  the resident, rows and sharded backends;
- four processes, hub and spokes over TCP, 2 shards a process.

Each worker prints its lane range, its hashes, the clock union and its
synced change lists; the test holds every worker's hashes to the
reference's `apply_batch` of those changes, computed here, its union to
the changes' own clocks, the lane ranges to a partition of the padded
docs axis, and every worker to the same change sets, union and winner.

Then a reference host and a port host: a reference DocSet behind a
reference TcpSyncServer in this process and a port worker as its client
sync over TCP; then each reconciles, the reference on its 8-device mesh,
the port on a one-process gloo group, and both equal the oracle.

Nothing binds a fixed port: servers listen on port 0 and publish the
port in a rendezvous directory under tmp_path, where gloo meets through a
file. Each worker has its own deadline (DEADLINE_S) and this test its
own; a worker that fails or times out fails the test. Tolerance: exact.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from automerge_tpu.core.change import Change as RefChange
from automerge_tpu.engine.batchdoc import apply_batch as ref_apply_batch

from torch_twin_helpers import hygiene_teardown

HERE = os.path.dirname(os.path.abspath(__file__))
N_DOCS = 8
#: seconds this test waits for all its workers
DEADLINE_S = 240


@pytest.fixture(autouse=True)
def _hygiene():
    yield
    hygiene_teardown()


def _spawn(worker: str, argv: list, extra_env=None) -> subprocess.Popen:
    env = dict(os.environ, OMP_NUM_THREADS="1", **(extra_env or {}))
    return subprocess.Popen(
        [sys.executable, os.path.join(HERE, worker), *map(str, argv)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)


def _collect(procs, deadline=DEADLINE_S) -> list[dict]:
    """Every worker's JSON line; a worker that fails or outlives the
    deadline fails the test (and every worker is reaped)."""
    outs = [""] * len(procs)
    t0 = time.time()
    try:
        for k, p in enumerate(procs):
            outs[k], _ = p.communicate(
                timeout=max(1.0, deadline - (time.time() - t0)))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for k, p in enumerate(procs):
            out, _ = p.communicate()
            outs[k] = outs[k] or out or ""
        pytest.fail("workers timed out:\n" + "\n---\n".join(
            o[-3000:] for o in outs))
    results = []
    for k, (p, out) in enumerate(zip(procs, outs)):
        tail = "\n".join(out.splitlines()[-25:])
        assert p.returncode == 0, f"worker {k} failed:\n{tail}"
        lines = [ln for ln in out.splitlines() if ln.startswith("{")]
        assert lines, f"worker {k} printed no result:\n{tail}"
        results.append(json.loads(lines[-1]))
    return results


def _run(worker, argvs, tmp_path, extra_env=None) -> list[dict]:
    rdv = tmp_path / "rdv"
    rdv.mkdir()
    procs = [_spawn(worker, [*argv, rdv], extra_env) for argv in argvs]
    return _collect(procs)


def _ref_changes(dicts) -> list:
    return [[RefChange.from_dict(c) for c in chs] for chs in dicts]


def _oracle(doc_changes) -> np.ndarray:
    _, _, out = ref_apply_batch(doc_changes)
    return np.asarray(out["hash"])[:len(doc_changes)].astype(np.uint32)


def _change_sets(dicts) -> list:
    return [sorted(json.dumps(c, sort_keys=True) for c in chs)
            for chs in dicts]


def _hold(results: list[dict], marker: str) -> None:
    """Every worker's shard equal to the reference's apply_batch of its
    synced changes; the ranges a partition of the padded docs axis; the
    union the changes' clock max; change sets, unions and winners equal
    across workers."""
    for r in results:
        assert r["marker"] == marker
        doc_changes = _ref_changes(r["changes"])
        want = _oracle(doc_changes)[r["lo"]:min(r["hi"], N_DOCS)]
        got = np.asarray(r["hashes"], np.uint32)[:len(want)]
        np.testing.assert_array_equal(got, want)
        rank = {a: k for k, a in enumerate(r["actors"])}
        clocks = np.zeros((N_DOCS, len(rank)), np.int64)
        for i, chs in enumerate(doc_changes):
            for c in chs:
                clocks[i, rank[c.actor]] = max(clocks[i, rank[c.actor]],
                                               c.seq)
        assert r["union"] == clocks.max(axis=0).tolist()
    spans = sorted((r["lo"], r["hi"]) for r in results)
    assert spans[0][0] == 0 and spans[-1][1] >= N_DOCS
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    first = results[0]
    for r in results[1:]:
        assert _change_sets(r["changes"]) == _change_sets(first["changes"])
        assert r["union"] == first["union"] and r["winner"] == first["winner"]


def test_two_process_sync_and_global_mesh(tmp_path):
    results = _run("torch_multihost_worker.py",
                   [[pid, 2, pid] for pid in (0, 1)], tmp_path)
    _hold(results, "TORCH-MULTIHOST-OK")


@pytest.mark.parametrize("backend", ["resident", "rows", "sharded"])
def test_two_process_engine_columnar_sync(tmp_path, backend):
    """EngineDocSets on the resident, rows and sharded backends syncing
    binary columnar frames over TCP (the reference's
    test_two_process_resident_columnar_sync, _rows_backend_ and
    _sharded_service_ cases)."""
    results = _run("torch_multihost_resident_worker.py",
                   [[pid, 2] for pid in (0, 1)], tmp_path,
                   {"AMTPU_MH_BACKEND": backend})
    _hold(results, "TORCH-MULTIHOST-RESIDENT-OK")
    assert {r["backend"] for r in results} == {backend}


def test_four_process_hub_sync_and_global_mesh(tmp_path):
    results = _run("torch_multihost_ring_worker.py",
                   [[pid, 4] for pid in range(4)], tmp_path)
    _hold(results, "TORCH-MULTIHOST4-OK")
    assert len({r["winner"] for r in results}) == 1


def test_reference_and_port_hosts_sync_then_each_reconcile(tmp_path):
    """A reference host (this process: a DocSet behind a TcpSyncServer)
    and a port host (a worker in a one-process gloo group, its TCP
    client) author half the fleet each, sync, both write doc0, then each
    reconciles: the reference on its 8-device mesh, the port through
    reconcile_global. Both equal the oracle."""
    import automerge_tpu as am
    from automerge_tpu.parallel.mesh import make_mesh, reconcile_sharded
    from automerge_tpu.sync.tcp import TcpSyncServer, sync_lock
    from torch_multihost_worker import publish_port

    rdv = tmp_path / "rdv"
    rdv.mkdir()
    ds = am.DocSet()
    for i in range(0, N_DOCS, 2):
        ds.set_doc(f"doc{i}", am.change(am.init("host0"), lambda x, i=i:
                   am.assign(x, {"n": i, "xs": [i, i + 1],
                                 "owner": "host0"})))
    server = TcpSyncServer(ds, port=0).start()
    try:
        publish_port(str(rdv), server.port)
        proc = _spawn("torch_multihost_worker.py", [1, 1, 0, rdv])

        def wait(pred, what):
            deadline = time.time() + 60
            while time.time() < deadline:
                if pred():
                    return
                if proc.poll() is not None:
                    break
                time.sleep(0.05)
            proc.kill()
            out, _ = proc.communicate()
            pytest.fail(f"{what}:\n{out[-3000:]}")

        wait(lambda: all(ds.get_doc(f"doc{i}") is not None
                         for i in range(N_DOCS)), "initial sync")
        with sync_lock(ds):
            doc0 = ds.get_doc("doc0")
            ds.set_doc("doc0", am.change(
                doc0, lambda x: x.__setitem__("winner", "host0")))

        def converged():
            clock = ds.get_doc("doc0")._doc.opset.clock
            return (all(f"host{h}" in clock for h in (0, 1))
                    and sum(clock.values()) >= 3)
        wait(converged, "concurrent edits")
        (result,) = _collect([proc])
        with sync_lock(ds):
            doc_changes = [ds.get_doc(f"doc{i}")._doc.opset
                           .get_missing_changes({}) for i in range(N_DOCS)]
    finally:
        server.close()
    want = _oracle(doc_changes)
    _, out, n = reconcile_sharded(doc_changes, make_mesh(8))
    np.testing.assert_array_equal(
        np.asarray(out["hash"])[:n].astype(np.uint32), want)
    assert (result["lo"], result["hi"]) == (0, N_DOCS)
    np.testing.assert_array_equal(
        np.asarray(result["hashes"], np.uint32)[:N_DOCS], want)
    assert _change_sets(result["changes"]) == _change_sets(
        [[c.to_dict() for c in chs] for chs in doc_changes])
    assert result["winner"] == ds.get_doc("doc0")["winner"]
