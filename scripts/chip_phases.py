#!/usr/bin/env python3
"""Run phases 2, 3, 9 and 11 of one checkout's chip_smoke.py on the GPU:
the rows engine's map storm and text fleet, the docs-major engine, and
the rows engine's durability (its rebuild from the log among them), each
line as chip_smoke.py prints it, the kernels built in that checkout.

    python3 scripts/chip_phases.py CHECKOUT [PHASE ...]

PHASE is 2, 3, 9 or 11 (default: all four; 9 needs 3).

To compare two commits on one card, unpack the other commit with `git
archive <commit> | tar -x -C DIR` into a git-ignored directory and run
this script on the two checkouts in turns (A, B, B, A), in one session.
"""

import collections
import os
import shutil
import sys
import time


def main() -> int:
    tree = os.path.abspath(sys.argv[1])
    sys.path.insert(0, tree)
    import torch
    import chip_smoke as cs
    from automerge_tpu_torch.engine import cuda_kernels as ck
    if not ck.__file__.startswith(tree):
        raise RuntimeError(f"imported {ck.__file__}, not from {tree}")
    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(f"== checkout {tree}: kernels built in {ck.build():.1f} s")
    phases = set(sys.argv[2:]) or {"2", "3", "9", "11"}
    took = {}
    if "2" in phases:
        t0 = time.perf_counter()
        cs.drive_map_storm(torch, dev)
        took["2"] = time.perf_counter() - t0
    if "3" in phases:
        t0 = time.perf_counter()
        _text_ds, text_final, _ = cs.drive_text_fleet(torch, dev)
        took["3"] = time.perf_counter() - t0
    if "9" in phases:
        t0 = time.perf_counter()
        cs.drive_docs_major(torch, dev, {"dominated": [], "linearize": []},
                            text_final)
        took["9"] = time.perf_counter() - t0
    if "11" in phases:
        t0 = time.perf_counter()
        _, keep = cs.drive_long_lived(torch, dev,
                                      collections.defaultdict(list))
        shutil.rmtree(keep["root"], ignore_errors=True)
        took["11"] = time.perf_counter() - t0
    print(f"== checkout {tree}: " + ", ".join(
        f"phase {p} {s:.1f} s" for p, s in took.items())
        + f" [{cs.card()}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
