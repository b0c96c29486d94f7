#!/usr/bin/env python3
"""Measure the spread of the race smoke's end-to-end reading on one host:
for each storm size, run the smoke's timed storms (`perf/raceplane.py`
`_timed_modes`: STORM_REPS pairs of one storm with the lock sanitizer off
and one with it on) several times, and print each run's median pair
difference of the writer loop's wall (the smoke's bounded reading), the
pairs' range, the median walls a mode and the sanitizer hooks' share.

    python3 scripts/race_spread.py [--device cuda] [--runs 3]
                                   [--sizes 12x20x20,12x20x40]

A size is DOCSxCHANGESxREPS: each writer's docs, the changes a doc, and
the pairs of storms a run.
"""

import argparse
import os
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--sizes", default="12x20x20,12x20x40")
    args = ap.parse_args()
    import torch
    from automerge_tpu_torch.perf import raceplane as rp
    from automerge_tpu_torch.utils import locksan
    dev = torch.device(args.device)
    prev = os.environ.get("AMTPU_LOCKSAN")
    try:
        for size in args.sizes.split(","):
            docs, ops, reps = (int(x) for x in size.split("x"))
            rp.STORM_DOCS, rp.STORM_OPS, rp.STORM_REPS = docs, ops, reps
            for run in range(args.runs):
                t0 = time.perf_counter()
                runs = rp._timed_modes(dev)
                pairs = sorted(on[0] / off[0] - 1
                               for off, on in zip(runs["off"], runs["on"]))
                wall = {m: statistics.median(r[0] for r in rs)
                        for m, rs in runs.items()}
                hooks = (sum(r[2] for r in runs["on"])
                         / sum(r[0] for r in runs["on"]))
                print(f"race spread {size} run {run}: median pair "
                      f"{statistics.median(pairs):+.2%} ({len(pairs)} "
                      f"pairs, {pairs[0]:+.1%} to {pairs[-1]:+.1%}); "
                      f"median wall {wall['off']:.4f}s off / "
                      f"{wall['on']:.4f}s on; hooks {hooks:.2%}; "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        if prev is None:
            os.environ.pop("AMTPU_LOCKSAN", None)
        else:
            os.environ["AMTPU_LOCKSAN"] = prev
        locksan._reload_for_tests()
    return 0


if __name__ == "__main__":
    sys.exit(main())
