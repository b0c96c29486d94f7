"""Worker process for tests/test_torch_multihost.py (not a pytest module):
the port's counterpart of tests/multihost_worker.py, and the helpers its
two siblings share.

Each process owns half of a DocSet (interpretive documents on the CPU),
syncs with the other host over TCP in the reference's {docId, clock,
changes} protocol, then joins a gloo process group and a global mesh (4
CPU shards a process) for one reconcile of its own document range
(`parallel.multihost.reconcile_global`) and a cross-process clock union.
Nothing binds a fixed port: the sync server listens on port 0 and writes
its port into the rendezvous directory, and gloo meets through a file
there. Each process has its own deadline. The last line is one JSON
object: the lane range, the local hashes, the clock union and the synced
change lists, which the test holds to the reference's `apply_batch`.

Usage:
    python tests/torch_multihost_worker.py <role> <nprocs> <rank> <dir>

role is the host this process plays (0 serves, 1 connects); in the
two-process run it equals rank. With nprocs 1 the one process plays role
1 against a reference node the test runs.
"""

import faulthandler
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

#: seconds a worker may run before it dumps its stacks and exits
DEADLINE_S = 200
N_DOCS = 8


def setup() -> None:
    torch.set_num_threads(1)
    faulthandler.dump_traceback_later(DEADLINE_S, exit=True)


def publish_port(rdv: str, port: int) -> None:
    tmp = os.path.join(rdv, "sync_port.tmp")
    with open(tmp, "w") as f:
        f.write(str(port))
    os.replace(tmp, os.path.join(rdv, "sync_port"))


def read_port(rdv: str, timeout: float = 60.0) -> int:
    path = os.path.join(rdv, "sync_port")
    deadline = time.time() + timeout
    while time.time() < deadline:
        if os.path.exists(path):
            with open(path) as f:
                return int(f.read())
        time.sleep(0.05)
    raise AssertionError("the server never published its port")


def connect(client_cls, node, rdv: str, **kw):
    port = read_port(rdv)
    for _ in range(100):
        try:
            return client_cls(node, "127.0.0.1", port, **kw).start()
        except OSError:
            time.sleep(0.1)
    raise AssertionError("could not reach host 0")


def wait_for(pred, timeout: float, what: str) -> None:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.05)
    raise AssertionError(what)


def join_mesh(rdv: str, nprocs: int, rank: int, per_host: int):
    """The gloo process group (through a file in `rdv`) and the global
    mesh of `per_host` CPU shards a process."""
    from automerge_tpu_torch.parallel.multihost import (global_mesh,
                                                        init_multihost)
    init_multihost(f"file://{os.path.join(rdv, 'gloo')}", nprocs, rank)
    mesh = global_mesh(local_devices=["cpu"] * per_host)
    assert mesh.size == nprocs * per_host, mesh
    return mesh


def reconcile_and_report(marker, role, mesh, doc_changes, clock_of,
                         **extra) -> None:
    """reconcile_global of the synced change lists, held to the port's
    own apply_batch; the clock union and doc0's hash agreement across
    processes; then the JSON line."""
    from automerge_tpu_torch.engine.batchdoc import apply_batch
    from automerge_tpu_torch.engine.cuda_kernels import hashes_to_numpy
    from automerge_tpu_torch.parallel.collective import global_clock_union
    from automerge_tpu_torch.parallel.multihost import reconcile_global

    lo, hi, local = reconcile_global(doc_changes, mesh)
    _, _, out = apply_batch(doc_changes, device="cpu")
    ref = hashes_to_numpy(out["hash"])
    want = ref[lo:min(hi, N_DOCS)]
    assert (local[:len(want)] == want).all(), f"[{role}] shard hash mismatch"

    actors = sorted({c.actor for chs in doc_changes for c in chs})
    rank = {a: k for k, a in enumerate(actors)}
    clocks = np.zeros((N_DOCS, len(actors)), np.int32)
    for i in range(N_DOCS):
        for a, s in clock_of(i).items():
            clocks[i, rank[a]] = s
    union = global_clock_union(torch.from_numpy(clocks[lo:hi]), mesh)
    assert (union.numpy() == clocks.max(axis=0)).all(), \
        f"[{role}] union {union.tolist()} != {clocks.max(axis=0)}"
    # every process fed its own doc0 hash: max == min across processes
    h0 = torch.tensor([[int(ref[0].astype(np.int32))]], dtype=torch.int32)
    mx = int(global_clock_union(h0, mesh)[0])
    mn = -int(global_clock_union(-h0, mesh)[0])
    assert mx == mn, f"[{role}] processes disagree on doc0: {mx} vs {mn}"
    print(json.dumps({
        "marker": marker, "role": role, "lo": lo, "hi": hi,
        "hashes": [int(h) for h in local], "union": union.tolist(),
        "actors": actors,
        "changes": [[c.to_dict() for c in chs] for chs in doc_changes],
        **extra}), flush=True)


def leave() -> None:
    """Wait for every process, then leave the process group."""
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


def main() -> None:
    role, nprocs, rank, rdv = (int(sys.argv[1]), int(sys.argv[2]),
                               int(sys.argv[3]), sys.argv[4])
    setup()
    from automerge_tpu_torch import api
    from automerge_tpu_torch.sync.docset import DocSet
    from automerge_tpu_torch.sync.tcp import (TcpSyncClient, TcpSyncServer,
                                              sync_lock)

    mesh = join_mesh(rdv, nprocs, rank, per_host=4)
    actor = f"host{role}"
    ds = DocSet(device="cpu")
    for i in range(N_DOCS):
        if i % 2 == role:
            d = api.change(api.init(actor, device="cpu"),
                           lambda x, i=i: api.assign(
                               x, {"n": i, "xs": [i, i + 1], "owner": actor}))
            ds.set_doc(f"doc{i}", d)

    if role == 0:
        link = TcpSyncServer(ds, port=0).start()
        publish_port(rdv, link.port)
    else:
        link = connect(TcpSyncClient, ds, rdv)
    wait_for(lambda: all(ds.get_doc(f"doc{i}") is not None
                         for i in range(N_DOCS)), 60,
             f"[{role}] initial sync did not converge")

    # both hosts write doc0.winner; the non-authoring host's replica has a
    # random actor, so the write goes through an actor-named replica, and
    # the read-modify-write holds the transport lock
    with sync_lock(ds):
        doc0 = ds.get_doc("doc0")
        if doc0._doc.actor_id == actor:
            ds.set_doc("doc0", api.change(
                doc0, lambda x: x.__setitem__("winner", actor)))
        else:
            mine = api.change(api.merge(api.init(actor, device="cpu"), doc0),
                              lambda x: x.__setitem__("winner", actor))
            ds.set_doc("doc0", api.merge(ds.get_doc("doc0"), mine))

    def converged():
        clock = ds.get_doc("doc0")._doc.opset.clock
        return (all(f"host{h}" in clock for h in (0, 1))
                and sum(clock.values()) >= 3)
    wait_for(converged, 60, f"[{role}] concurrent-edit sync did not converge")
    winner = ds.get_doc("doc0")["winner"]
    assert winner in ("host0", "host1"), winner

    with sync_lock(ds):
        doc_changes = [ds.get_doc(f"doc{i}")._doc.opset.get_missing_changes(
            {}) for i in range(N_DOCS)]
        clocks = [dict(ds.get_doc(f"doc{i}")._doc.opset.clock)
                  for i in range(N_DOCS)]
    reconcile_and_report("TORCH-MULTIHOST-OK", role, mesh, doc_changes,
                         lambda i: clocks[i], winner=winner)
    leave()
    link.close()


if __name__ == "__main__":
    main()
