#!/usr/bin/env python3
"""Run phases 2, 3 and 9 of one checkout's chip_smoke.py on the GPU: the
rows engine's map storm and text fleet, and the docs-major engine, each
line as chip_smoke.py prints it, the kernels built in that checkout.

    python3 scripts/chip_phases.py CHECKOUT

To compare two commits on one card, unpack the other commit with `git
archive <commit> | tar -x -C DIR` into a git-ignored directory and run
this script on the two checkouts in turns (A, B, B, A), in one session.
"""

import os
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
    t0 = time.perf_counter()
    cs.drive_map_storm(torch, dev)
    t1 = time.perf_counter()
    _text_ds, text_final, _ = cs.drive_text_fleet(torch, dev)
    t2 = time.perf_counter()
    cs.drive_docs_major(torch, dev, {"dominated": [], "linearize": []},
                        text_final)
    t3 = time.perf_counter()
    print(f"== checkout {tree}: phase 2 {t1 - t0:.1f} s, phase 3 "
          f"{t2 - t1:.1f} s, phase 9 {t3 - t2:.1f} s [{cs.card()}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
