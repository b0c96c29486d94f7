"""`perf bootstrap --smoke`: the replica-bootstrap smoke (`chip_smoke.py`
phase 16 runs it on the card).

Proof, in seconds, that the r15 storage tier works in this image: build
a deep-history doc on a serving node (segmented archive + snapshot
store), compact it into a doc-state image, cold-boot a FRESH replica
from snapshot + archived tail, and assert its converged hash is
byte-equal to a full-history replay replica's — the same parity bench
config 15 gates at fleet scale. Informational timing (snapshot vs
replay wall) is printed; the smoke FAILS only on correctness (parity,
boot mode, compaction actually happening), never on this host's timing.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time


def smoke_main(argv=None) -> int:
    import argparse

    import numpy as np

    from .. import api as am
    from ..device import resolve_device
    from ..sync.service import EngineDocSet

    ap = argparse.ArgumentParser(prog="automerge_tpu_torch.perf bootstrap")
    ap.add_argument("--smoke", action="store_true",
                    help="run the bootstrap smoke (default)")
    ap.add_argument("--changes", type=int, default=3000,
                    help="history depth of the smoke doc")
    ap.add_argument("--fields", type=int, default=24,
                    help="live fields the history overwrites")
    ap.add_argument("--device", default="cuda",
                    help="the services' device (cuda, or cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    root = tempfile.mkdtemp(prefix="amtpu-bootstrap-smoke-")
    try:
        d = am.init("writer", device=device)
        srv = EngineDocSet(backend="rows", device=device,
                           log_archive_dir=os.path.join(root, "arch"),
                           snapshot_dir=os.path.join(root, "snap"))
        for k in range(args.changes):
            d = am.change(d, lambda x, k=k: x.__setitem__(
                f"f{k % args.fields}", k))
        chs = d._doc.opset.get_missing_changes({})
        # chunked ingest: the engine's own budget-pressure compaction
        # reclaims dominated rows between rounds (one 3K-op batch into
        # an empty doc would exceed the rows budget precheck outright)
        for k in range(0, len(chs), 256):
            srv.apply_changes("doc", chs[k:k + 256])
        t0 = time.perf_counter()
        info = srv.write_snapshots(["doc"])["doc"]
        write_s = time.perf_counter() - t0
        srv.flush()
        h_srv = np.uint32(srv.hashes()["doc"])
        arch_stats = srv._resident.log_archive.stats("doc")

        t0 = time.perf_counter()
        replay = EngineDocSet(backend="rows", device=device,
                              log_archive_dir=os.path.join(root, "arch"))
        r_res = replay.bootstrap_from_storage(["doc"])["doc"]
        replay_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        fresh = EngineDocSet(backend="rows", device=device,
                             log_archive_dir=os.path.join(root, "arch"),
                             snapshot_dir=os.path.join(root, "snap"))
        s_res = fresh.bootstrap_from_storage(["doc"])["doc"]
        snap_s = time.perf_counter() - t0

        h_replay = np.uint32(replay.hashes()["doc"])
        h_snap = np.uint32(fresh.hashes()["doc"])
        parity = bool(h_srv == h_replay == h_snap)
        ratio = (info.get("bytes", 0) / arch_stats["bytes"]
                 if arch_stats.get("bytes") else None)
        speedup = replay_s / snap_s if snap_s > 0 else None
        ok = (parity and s_res.get("mode") == "snapshot"
              and r_res.get("mode") == "replay"
              and info.get("n_changes", args.changes) < args.changes)
        verdict = "OK" if ok else "FAILED"
        print(f"bootstrap smoke: {verdict} — {args.changes}-change doc "
              f"compacted to {info.get('n_changes')} changes "
              f"({info.get('bytes')}B image vs {arch_stats['bytes']}B "
              f"archived log"
              + (f", x{ratio:.3f}" if ratio is not None else "")
              + f"); cold boot snapshot+tail {snap_s:.3f}s vs "
              f"full replay {replay_s:.3f}s"
              + (f" (x{speedup:.1f})" if speedup else "")
              + f"; snapshot write {write_s:.3f}s; converged hashes "
              f"{'byte-equal' if parity else 'DIVERGED'} across server / "
              "replay-boot / snapshot-boot")
        return 0 if ok else 1
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    raise SystemExit(smoke_main())
