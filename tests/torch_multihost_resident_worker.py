"""Worker process for tests/test_torch_multihost.py (not a pytest module):
the port's counterpart of tests/multihost_resident_worker.py.

Each of two processes runs an `EngineDocSet` on the CPU (documents
resident in the columnar engine; `AMTPU_MH_BACKEND` picks "resident",
"rows" or "sharded", the last a `ShardedEngineDocSet` of 2 shards),
syncs over TCP with binary columnar frames, then joins the gloo group and
the global mesh for one reconcile of its document range and a
cross-process clock union; the engine's own hashes must equal the mesh's.
The sync server listens on port 0 (its port goes through the rendezvous
directory), and the process has its own deadline.

Usage:
    python tests/torch_multihost_resident_worker.py <rank> <nprocs> <dir>
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_multihost_worker import (N_DOCS, connect, join_mesh,  # noqa: E402
                                    leave, publish_port,
                                    reconcile_and_report, setup, wait_for)


def main() -> None:
    rank, nprocs, rdv = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    setup()
    import numpy as np
    from automerge_tpu_torch import api
    from automerge_tpu_torch.core.change import Change, Op
    from automerge_tpu_torch.core.ids import ROOT_ID
    from automerge_tpu_torch.engine.batchdoc import apply_batch
    from automerge_tpu_torch.engine.cuda_kernels import hashes_to_numpy
    from automerge_tpu_torch.sync.service import EngineDocSet
    from automerge_tpu_torch.sync.tcp import (TcpSyncClient, TcpSyncServer,
                                              sync_lock)
    from automerge_tpu_torch.utils import metrics

    mesh = join_mesh(rdv, nprocs, rank, per_host=4)
    actor = f"host{rank}"
    backend = os.environ.get("AMTPU_MH_BACKEND", "resident")
    if backend == "sharded":
        from automerge_tpu_torch.sync.sharded_service import (
            ShardedEngineDocSet)
        engine = ShardedEngineDocSet(n_shards=2, devices=["cpu"])
    else:
        engine = EngineDocSet(backend=backend, device="cpu")
    for i in range(N_DOCS):
        if i % 2 == rank:
            d = api.change(api.init(actor, device="cpu"),
                           lambda x, i=i: api.assign(
                               x, {"n": i, "xs": [i, i + 1], "owner": actor}))
            engine.add_doc(f"doc{i}")
            engine.apply_changes(f"doc{i}",
                                 d._doc.opset.get_missing_changes({}))

    if rank == 0:
        link = TcpSyncServer(engine, port=0, wire="columnar").start()
        publish_port(rdv, link.port)
    else:
        link = connect(TcpSyncClient, engine, rdv, wire="columnar")
    wait_for(lambda: (set(engine.doc_ids) >= {f"doc{i}" for i in
                                              range(N_DOCS)}
                      and all(engine.clock_of(f"doc{i}").get(
                          f"host{i % 2}", 0) > 0 for i in range(N_DOCS))),
             60, f"[{rank}] initial columnar sync did not converge")
    assert metrics.snapshot().get("sync_frames_received", 0) > 0, \
        f"[{rank}] no columnar frames received"

    # both hosts write doc0.winner straight into the engine
    with sync_lock(engine):
        clk = engine.clock_of("doc0")
        ch = Change(actor, clk.get(actor, 0) + 1,
                    {a: s for a, s in clk.items() if a != actor},
                    [Op("set", ROOT_ID, key="winner", value=actor)])
        engine.apply_changes("doc0", [ch])

    def converged():
        clk = engine.clock_of("doc0")
        return (all(clk.get(f"host{h}", 0) > 0 for h in (0, 1))
                and sum(clk.values()) >= 3)
    wait_for(converged, 60, f"[{rank}] concurrent-edit sync did not converge")
    winner = engine.materialize("doc0")["data"]["winner"]
    assert winner in ("host0", "host1"), winner

    with sync_lock(engine):
        doc_changes = [engine.missing_changes(f"doc{i}", {})
                       for i in range(N_DOCS)]
        clocks = [dict(engine.clock_of(f"doc{i}")) for i in range(N_DOCS)]
    # the engine's own hashes agree with a from-scratch reconcile
    _, _, out = apply_batch(doc_changes, device="cpu")
    ref = hashes_to_numpy(out["hash"])
    eng = engine.hashes()
    for i in range(N_DOCS):
        assert np.uint32(eng[f"doc{i}"]) == ref[i], \
            f"[{rank}] engine hash != apply_batch for doc{i}"
    reconcile_and_report("TORCH-MULTIHOST-RESIDENT-OK", rank, mesh,
                         doc_changes, lambda i: clocks[i], winner=winner,
                         backend=backend)
    leave()
    link.close()
    engine.close()


if __name__ == "__main__":
    main()
