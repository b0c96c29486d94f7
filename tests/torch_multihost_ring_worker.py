"""Worker for the 4-process case of tests/test_torch_multihost.py (not a
pytest module): the port's counterpart of tests/multihost_ring_worker.py.

Host 0 is the sync hub (a TcpSyncServer on port 0), hosts 1..N-1 connect
as clients, and the hub's DocSet relays admissions between spokes. After
the DocSets converge, every process joins one gloo group and one global
mesh (8 CPU shards in all) for a reconcile of its own document range and
a clock union that must hold every host's seqs.

Usage:
    python tests/torch_multihost_ring_worker.py <rank> <nprocs> <dir>
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
    from automerge_tpu_torch import api
    from automerge_tpu_torch.sync.docset import DocSet
    from automerge_tpu_torch.sync.tcp import (TcpSyncClient, TcpSyncServer,
                                              sync_lock)

    mesh = join_mesh(rdv, nprocs, rank, per_host=8 // nprocs)
    actor = f"host{rank}"
    ds = DocSet(device="cpu")
    for i in range(N_DOCS):
        if i % nprocs == rank:
            d = api.change(api.init(actor, device="cpu"),
                           lambda x, i=i: api.assign(
                               x, {"n": i, "xs": [i, i + 1], "owner": actor}))
            ds.set_doc(f"doc{i}", d)

    if rank == 0:
        link = TcpSyncServer(ds, port=0).start()
        publish_port(rdv, link.port)
    else:
        link = connect(TcpSyncClient, ds, rdv)

    def all_owned():
        docs = [ds.get_doc(f"doc{i}") for i in range(N_DOCS)]
        return all(d is not None and "owner" in d for d in docs)
    wait_for(all_owned, 90, f"[{rank}] spoke sync did not converge")

    with sync_lock(ds):
        doc0 = ds.get_doc("doc0")
        if doc0._doc.actor_id == actor:
            ds.set_doc("doc0", api.change(
                doc0, lambda x: x.__setitem__("winner", actor)))
        else:
            mine = api.change(api.merge(api.init(actor, device="cpu"), doc0),
                              lambda x: x.__setitem__("winner", actor))
            ds.set_doc("doc0", api.merge(ds.get_doc("doc0"), mine))

    # every host's winner write: doc0's author (host0, rank 0) made it
    # at seq 2, the others at seq 1. Waiting only for each actor to
    # appear lets a spoke go on before host0's write reaches it (host0 is
    # in the clock since the doc arrived), and its reconcile then differs
    # from the other processes'.
    wait_for(lambda: all(ds.get_doc("doc0")._doc.opset.clock.get(
        f"host{h}", 0) >= (2 if h == 0 else 1) for h in range(nprocs)), 90,
             f"[{rank}] concurrent-edit sync did not converge")
    winner = ds.get_doc("doc0")["winner"]
    assert winner in {f"host{h}" for h in range(nprocs)}, winner

    with sync_lock(ds):
        doc_changes = [ds.get_doc(f"doc{i}")._doc.opset.get_missing_changes(
            {}) for i in range(N_DOCS)]
        clocks = [dict(ds.get_doc(f"doc{i}")._doc.opset.clock)
                  for i in range(N_DOCS)]
    reconcile_and_report("TORCH-MULTIHOST4-OK", rank, mesh, doc_changes,
                         lambda i: clocks[i], winner=winner)
    leave()
    link.close()


if __name__ == "__main__":
    main()
