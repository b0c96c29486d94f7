"""Fix the outputs the port must reproduce: run small seeded workloads of
`automerge_tpu_torch.workloads` through the JAX reference on the CPU and
write them to automerge_tpu_torch/testdata/reference_hashes.npz:

- the rows streams through the reference's rows engine (pure-Python
  ingress, Pallas kernel in interpret mode): the final per-doc hashes,
  under each stream's name;
- small span tables through the reference's XLA `merge_spans`:
  `spans_order`, `spans_start`, `spans_total`, `spans_hash`;
- small move realms through the reference's XLA `resolve_moves`:
  `moves_ptr`, `moves_parent`, `moves_resolved`, `moves_dropped`,
  `moves_hash`;
- the docs-major streams (a 512-doc cut of the docset fleet with its 12
  rounds, a 64-doc cut of the text fleet) through the reference's
  docs-major ResidentDocSet (pure-Python ingress), one
  apply_and_reconcile a round: the final per-doc hashes, under
  `docs_<name>`.

and the diff records of the same two streams with a round of moves added
(`workloads.reference_diff_streams`), one apply_and_reconcile(...,
diffs=True) a round through the reference's docs-major ResidentDocSet on
its native (C++) encoder, the port's default, to
automerge_tpu_torch/testdata/reference_diffs.json: {name: [{doc_id:
[records]} for each round]}. (The two encoders' records differ in one
field: a list move in a text object is typed "list" on the native
encoder, whose tables keep no object index, and "text" on the Python one;
the port reproduces each.)

`chip_smoke.py` holds the port to both files on a machine that has no JAX;
`tests/test_torch_rows.py`, `test_torch_spans.py`, `test_torch_moves.py`,
`test_torch_resident.py` and `test_torch_diffs.py` check that both packages
still reproduce them.

    JAX_PLATFORMS=cpu python scripts/torch_reference_hashes.py
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "automerge_tpu_torch" / "testdata" / "reference_hashes.npz"
DIFFS_OUT = REPO / "automerge_tpu_torch" / "testdata" / "reference_diffs.json"


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


def reference_docs_hashes() -> dict[str, np.ndarray]:
    from automerge_tpu.core.change import Change
    from automerge_tpu.engine.resident import ResidentDocSet
    from automerge_tpu_torch.workloads import reference_docs_streams

    out = {}
    for name, ids, rounds in reference_docs_streams():
        ds = ResidentDocSet(ids, native=False)
        for rnd in rounds:
            ds.apply_and_reconcile({
                d: [Change.from_dict(c.to_dict()) for c in chs]
                for d, chs in rnd.items()})
        out[f"docs_{name}"] = ds.hashes()
    return out


def reference_diff_records() -> dict[str, list]:
    from automerge_tpu.core.change import Change
    from automerge_tpu.engine.resident import ResidentDocSet
    from automerge_tpu_torch.workloads import reference_diff_streams

    out = {}
    for name, ids, rounds in reference_diff_streams():
        ds = ResidentDocSet(ids, native=True)
        out[name] = [ds.apply_and_reconcile({
            d: [Change.from_dict(c.to_dict()) for c in chs]
            for d, chs in rnd.items()}, diffs=True)[1] for rnd in rounds]
    return out


def reference_span_outputs() -> dict[str, np.ndarray]:
    from automerge_tpu.engine.pack import pack_spans
    from automerge_tpu.engine.span_kernels import merge_spans
    from automerge_tpu_torch.workloads import reference_span_tables

    out = merge_spans(pack_spans(reference_span_tables()))
    return {f"spans_{k}": np.asarray(v) for k, v in out.items()}


def reference_move_outputs() -> dict[str, np.ndarray]:
    from automerge_tpu.engine.move_kernels import resolve_moves
    from automerge_tpu.engine.pack import pack_moves
    from automerge_tpu_torch.workloads import reference_move_problems

    packed = pack_moves(reference_move_problems())
    out = resolve_moves(packed["nodes"], packed["cands"])
    return {f"moves_{k}": np.asarray(v) for k, v in out.items()}


def main() -> int:
    sys.path.insert(0, str(REPO))
    outputs = {**reference_hashes(), **reference_span_outputs(),
               **reference_move_outputs(), **reference_docs_hashes()}
    OUT.parent.mkdir(parents=True, exist_ok=True)
    np.savez(OUT, **outputs)
    print(f"wrote {OUT.relative_to(REPO)}: "
          + ", ".join(f"{k} {v.shape}" for k, v in outputs.items()))
    diffs = reference_diff_records()
    DIFFS_OUT.write_text(json.dumps(diffs, separators=(",", ":")) + "\n")
    print(f"wrote {DIFFS_OUT.relative_to(REPO)}: " + ", ".join(
        f"{k} {sum(len(r) for rnd in v for r in rnd.values())} records"
        for k, v in diffs.items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
