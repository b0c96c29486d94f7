"""Fix the hashes the port must reproduce: run small seeded streams of
`automerge_tpu_torch.workloads` through the JAX reference's rows engine
(pure-Python ingress, Pallas kernel in interpret mode, on the CPU) and write
their final per-doc hashes to automerge_tpu_torch/testdata/
reference_hashes.npz. `chip_smoke.py` holds the port to that file on a
machine that has no JAX; `tests/test_torch_rows.py` checks that both
packages still reproduce it.

    JAX_PLATFORMS=cpu python scripts/torch_reference_hashes.py
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "automerge_tpu_torch" / "testdata" / "reference_hashes.npz"


def reference_hashes() -> dict[str, np.ndarray]:
    from automerge_tpu.core.change import Change
    from automerge_tpu.engine.resident_rows import ResidentRowsDocSet
    from automerge_tpu_torch.workloads import reference_streams

    out = {}
    for name, ids, batches in reference_streams():
        ds = ResidentRowsDocSet(ids, native=False)
        for batch in batches:
            ds.apply_rounds([{d: [Change.from_dict(c.to_dict()) for c in chs]
                              for d, chs in r.items()} for r in batch])
        out[name] = ds.hashes()
    return out


def main() -> int:
    sys.path.insert(0, str(REPO))
    hashes = reference_hashes()
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez(OUT, **hashes)
    print(f"wrote {OUT.relative_to(REPO)}: "
          + ", ".join(f"{k} {v.shape}" for k, v in hashes.items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
