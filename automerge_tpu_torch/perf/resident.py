"""Stage breakdown of the round-frame resident ingress
(`ResidentRowsDocSet.apply_round_frames`) on the port: the counterpart of
`automerge_tpu/perf/resident.py`. How much of a streamed sync round goes
to actor registration, precheck, admission + native encode, capacity
growth, triplet build, dispatch enqueue, frame decode, and the final
readback (`python -m automerge_tpu_torch.perf resident [--device cpu]`).

`encode_admit` times both admission routes: `_encode_rounds_batched` (the
steady-state route, the whole micro-batch at once, which
`apply_round_frames` tries first) and `_encode_round_frame` (round by
round, when a change breaks a doc's in-order chain). The reference wraps
only the second, so on a steady round its stages miss the admission and
encode and `accounted` falls short of `total`.

`gc` is the garbage collections that run while no other stage is timing:
in practice the one that `apply_round_frames` defers (it runs under
`gc_paused`) to its own exit, where the young objects of the whole call
are collected. The reference's stages miss it too.

Prints one JSON object: per-stage milliseconds per round, the accounted
sum, the total, the unaccounted rest split into the part inside
`apply_round_frames` calls and the part between them, and the final
hashes' digest. Timings are meaningful
relative to each other; the device work runs behind the host legs and is
waited for in `final_readback`.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import random
import time
from dataclasses import dataclass

#: stage -> the engine methods it wraps
STAGES = {
    "register": ("_register_round_actors",),
    "precheck": ("_precheck_round_frames",),
    "encode_admit": ("_encode_rounds_batched", "_encode_round_frame"),
    "grow": ("_grow_for_rounds",),
    "triplets": ("_cols_triplets",),
    "dispatch_enqueue": ("_dispatch_final",),
}


@dataclass
class Workload:
    """build()'s result: the fleet, its initial changes a doc, and the
    n_rounds * (1 + n_batches) rounds as AMR1 frames (`wire`) and as
    {doc: [Change]} (`rounds`)."""
    doc_ids: list
    doc_changes: list
    wire: list
    rounds: list
    n_rounds: int
    n_batches: int


def build(n_docs: int = 2000, n_rounds: int = 12, n_batches: int = 4,
          fraction: float = 0.2, seed: int = 3) -> Workload:
    """The reference's workload: bench config 5's docset fleet as
    documents (the port's document API on the CPU), then
    n_rounds * (1 + n_batches) rounds in which the same `fraction` of the
    docs each set "n" once."""
    from .. import api, workloads
    from ..frontend.materialize import apply_changes_to_doc
    from ..sync.frames import encode_round_frame

    rng = random.Random(seed)
    doc_ids, initial, _ = workloads.docset_fleet(n_docs, rounds=0)
    doc_changes = [initial[d] for d in doc_ids]
    docs = []
    for changes in doc_changes:
        d = api.init("bench", device="cpu")
        d = apply_changes_to_doc(d, d._doc.opset, changes,
                                 incremental=False)
        docs.append(d)

    total_rounds = n_rounds * (1 + n_batches)
    changed = rng.sample(range(n_docs), max(1, int(n_docs * fraction)))
    rounds = []
    for rnd in range(total_rounds):
        deltas = {}
        for i in changed:
            prev = docs[i]
            new = api.change(prev, lambda d, rnd=rnd, i=i: d.__setitem__(
                "n", rnd * 1000 + i))
            deltas[doc_ids[i]] = new._doc.opset.get_missing_changes(
                prev._doc.opset.clock)
            docs[i] = new
        rounds.append(deltas)
    return Workload(doc_ids, doc_changes,
                    [encode_round_frame(r) for r in rounds], rounds,
                    n_rounds, n_batches)


def run(n_docs: int = 2000, n_rounds: int = 12, n_batches: int = 4,
        fraction: float = 0.2, seed: int = 3, device="cuda",
        workload: Workload | None = None) -> dict:
    """The breakdown over n_batches micro-batches of n_rounds frames each
    (one warm-up micro-batch first). `workload` is build()'s result, whose
    own sizes then hold (made here from the arguments when None). The
    returned dict also carries `hashes`, the final np.uint32 hashes of the
    fleet."""
    from ..device import resolve_device
    from ..engine.cuda_kernels import hashes_to_numpy
    from ..engine.resident_rows import ResidentRowsDocSet
    from ..sync.frames import decode_round_frame

    dev = resolve_device(device)
    work = workload or build(n_docs, n_rounds, n_batches, fraction, seed)
    doc_ids, doc_changes, wire = work.doc_ids, work.doc_changes, work.wire
    n_docs, n_rounds, n_batches = len(doc_ids), work.n_rounds, \
        work.n_batches
    total_rounds = n_rounds * (1 + n_batches)
    rset = ResidentRowsDocSet(doc_ids, device=dev)
    rset.apply_rounds([{doc_ids[i]: doc_changes[i] for i in range(n_docs)}])
    rset.reserve(
        ops_per_doc=int(rset.op_count.max()) + total_rounds + 1,
        changes_per_doc=int(rset.change_count.max()) + total_rounds + 1)

    stage: dict[str, float] = {}
    # the calls' own wall (not a stage): what the stages leave out of it
    calls: dict[str, float] = {}
    # stages timing now; a collection inside one is that stage's time
    depth = 0
    gc_t0 = None

    @contextlib.contextmanager
    def clock(into, name):
        nonlocal depth
        nested = 1 if into is stage else 0
        depth += nested
        t0 = time.perf_counter()
        try:
            yield
        finally:
            into[name] = into.get(name, 0.0) + time.perf_counter() - t0
            depth -= nested

    def timed(into, name, fn):
        def wrap(*a, **k):
            with clock(into, name):
                return fn(*a, **k)
        return wrap

    def on_gc(phase, info):
        nonlocal gc_t0
        if phase == "start":
            gc_t0 = None if depth else time.perf_counter()
        elif gc_t0 is not None:
            stage["gc"] += time.perf_counter() - gc_t0
            gc_t0 = None

    for name, methods in STAGES.items():
        for m in methods:
            setattr(rset, m, timed(stage, name, getattr(rset, m)))
    rset.apply_round_frames = timed(calls, "apply_round_frames",
                                    rset.apply_round_frames)

    # warm
    hashes_to_numpy(rset.apply_round_frames(wire[:n_rounds]))
    stage.clear()
    calls.clear()
    stage["gc"] = 0.0

    gc.callbacks.append(on_gc)
    try:
        t0 = time.perf_counter()
        h = None
        for b in range(n_batches):
            with clock(stage, "frame_decode"):
                frames = [decode_round_frame(f) for f in
                          wire[n_rounds * (1 + b):n_rounds * (2 + b)]]
            h = rset.apply_round_frames(frames)
        with clock(stage, "final_readback"):
            vals = hashes_to_numpy(h)[:n_docs]
        total = time.perf_counter() - t0
    finally:
        gc.callbacks.remove(on_gc)
    stage["gc"] = stage.pop("gc")

    nt = n_rounds * n_batches
    # gc counts as inside: a collection outside every stage runs, in
    # practice, at a call's exit (gc_paused)
    inner = sum(v for k, v in stage.items()
                if k not in ("frame_decode", "final_readback"))
    inside = calls["apply_round_frames"] - inner
    return {"device": str(dev), "docs": n_docs,
            "rounds": nt, "batches": n_batches,
            "total_ms_per_round": total / nt * 1000,
            "stages_ms_per_round": {k: v / nt * 1000
                                    for k, v in stage.items()},
            "accounted": sum(stage.values()) / nt * 1000,
            "unaccounted_ms_per_round": {
                "inside_apply_round_frames": inside / nt * 1000,
                "between_calls": (total - sum(stage.values()) - inside)
                / nt * 1000},
            "hashes": vals}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="automerge_tpu_torch.perf resident")
    ap.add_argument("--docs", type=int, default=2000)
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--fraction", type=float, default=0.2)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (default cuda; it "
                         "raises without a card)")
    args = ap.parse_args(argv)
    out = run(n_docs=args.docs, n_rounds=args.rounds,
              n_batches=args.batches, fraction=args.fraction,
              device=args.device)
    h = out.pop("hashes")
    out["hash_digest"] = int(h.astype("uint64").sum() % (1 << 32))
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
