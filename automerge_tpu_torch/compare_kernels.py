"""Times this checkout's kernels against another checkout's, in turns on
one card: the move-resolution kernel (`engine/move_kernels.py::
resolve_moves`) and the span rank+hash kernel (`engine/span_kernels.py::
span_rank_hash`), on the storm realm, the realm fleet, the span fleet and
the bulk merge (`workloads.py`), as the planes hand them to the kernels;
and the docs-major linearize kernel (`engine/cuda_kernels.py::linearize`)
on the text fleet's and the docset fleet's rows as `apply_doc` hands them
over (the fleets' rounds through this checkout's `ResidentDocSet` on the
card). On each workload the two outputs are held equal first, then the
two kernels are timed old, new, new, old, each as a CUDA-graph replay of
20 launches (the device alone, inputs warm in L2).

The other checkout's package is loaded from its own files under another
module name, and builds its kernels from its own sources through its own
wrappers, so any two checkouts whose wrappers keep these three contracts
compare.

    python3 -m automerge_tpu_torch.compare_kernels OTHER_CHECKOUT

from the root of this checkout, OTHER_CHECKOUT the root of the other (for
example an earlier commit unpacked with `git archive` into a git-ignored
directory). Prints a line a workload, the card's name and power limit, and
one JSON line. Needs a CUDA card.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

from .engine import cuda_kernels, move_kernels, span_kernels
from .engine.pack import pack_moves, pack_spans
from .engine.resident import ResidentDocSet
from .workloads import (docset_fleet, move_fleet, move_storm,
                        span_bulk_merge, span_fleet, text_fleet)


def load_other(checkout: Path, name: str = "amt_other"):
    """(move_kernels, span_kernels, cuda_kernels) of the package in
    `checkout`, imported as `name`."""
    pkg = checkout / "automerge_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return tuple(importlib.import_module(f"{name}.engine.{m}")
                 for m in ("move_kernels", "span_kernels", "cuda_kernels"))


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Mean device milliseconds of one call of fn(): `reps` calls captured
    into one CUDA graph, one replay to warm up, then `replays` replays
    between CUDA events."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * replays)


def workloads(dev) -> dict:
    """{name: (kind, inputs)} on the card: move lanes (nodes, cands), span
    lanes and their merge order, or the four [R, E] columns of linearize."""
    out = {}
    for name, realms in (("storm realm", [move_storm()]),
                         ("realm fleet", move_fleet())):
        pk = pack_moves(realms)
        out[name] = ("moves", tuple(torch.from_numpy(pk[k]).to(dev)
                                    for k in ("nodes", "cands")))
    for name, (tables, _) in (("span fleet", span_fleet()),
                              ("bulk merge", span_bulk_merge())):
        spans = torch.from_numpy(pack_spans(tables)).to(dev)
        order = span_kernels.merge_order(spans)[0].to(torch.int32)
        out[name] = ("spans", (spans, order))
    docset_ids, initial, docset_rounds = docset_fleet()
    text_ids, text_rounds = text_fleet()
    for name, ids, rounds in (("text fleet", text_ids, text_rounds),
                              ("docset fleet", docset_ids,
                               [initial] + docset_rounds)):
        ds = ResidentDocSet(ids, device=dev)
        for rnd in rounds:
            ds.apply_and_reconcile(rnd)
        s = ds.state
        d, n_lists, n_elems = s["ins_mask"].shape
        out[name] = ("linearize", tuple(
            s[k].reshape(d * n_lists, n_elems)
            for k in ("ins_mask", "ins_elem", "ins_actor", "ins_parent")))
    return out


def main(argv: list[str]) -> int:
    if len(argv) != 1 or not torch.cuda.is_available():
        print("usage (on a CUDA card): python3 -m "
              "automerge_tpu_torch.compare_kernels OTHER_CHECKOUT",
              file=sys.stderr)
        return 1
    old_mk, old_sk, old_ck = load_other(Path(argv[0]).resolve())
    dev = torch.device("cuda", 0)
    result = {}
    for name, (kind, inp) in workloads(dev).items():
        if kind == "moves":
            old = lambda: old_mk.resolve_moves(*inp)       # noqa: E731
            new = lambda: move_kernels.resolve_moves(*inp)  # noqa: E731
            o, n = old(), new()
            same = o.keys() == n.keys() and all(torch.equal(o[k], n[k])
                                                for k in o)
        elif kind == "spans":
            old = lambda: old_sk.span_rank_hash(*inp)       # noqa: E731
            new = lambda: span_kernels.span_rank_hash(*inp)  # noqa: E731
            same = all(torch.equal(a, b) for a, b in zip(old(), new()))
        else:
            old = lambda: old_ck.linearize(*inp)            # noqa: E731
            new = lambda: cuda_kernels.linearize(*inp)      # noqa: E731
            same = torch.equal(old(), new())
        if not same:
            print(f"{name}: the two kernels' outputs differ",
                  file=sys.stderr)
            return 1
        turns = [graph_ms(fn) for fn in (old, new, new, old)]
        result[name] = {"old": [turns[0], turns[3]],
                        "new": [turns[1], turns[2]]}
        print(f"{name}: old {turns[0]:.5f} new {turns[1]:.5f} new "
              f"{turns[2]:.5f} old {turns[3]:.5f} graph ms (outputs equal)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({"compare": result, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
