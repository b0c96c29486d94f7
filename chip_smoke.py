#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (automerge_tpu_torch) on one NVIDIA
GPU: builds the hand-written kernels from the checkout, holds each against
its plain PyTorch version, and drives the port's main paths at full size:
the rows engine (`ResidentRowsDocSet.apply_round_frames`, `apply_rounds`,
`hashes`, `hashes_for`), the text-merge plane
(`dispatch.merge_spans_adaptive`), the move plane
(`dispatch.resolve_moves_adaptive`), the docs-major engine
(`ResidentDocSet.apply_and_reconcile_columns`, `apply_and_reconcile`,
`apply_changes`, `hashes_for`, `batchdoc.apply_batch`) and its diff plane
(`apply_and_reconcile_columns(..., diffs=True)`, `diffs.MirrorDoc`), and the
document API with the interpretive OpSet (`api.load`, `OpSet.add_changes`,
`ResidentRowsDocSet.materialize`, `dispatch.apply_batch_adaptive`). Ingress
runs the native C++ encoder, built with g++ at first use, unless a line says
native=False.

    python3 chip_smoke.py

Phases:
  1. build (one nvcc per kernel source, all started together) and kernel
     parity on random inputs: the reconcile kernel on every case of
     workloads.RECONCILE_CASES (the base and XL-only shapes, a heavy lane
     among near-empty ones, every slot live, lanes with no op, LE = 0,
     A = 1, I = LE = 1,024, a lane past the shared memory, a lane whose
     state needs a whole block, and the megabatch route's bucket dims,
     each of these timed), with and without force_xl (with it where
     I % 32 == 0); the
     span rank+hash kernel (pre-sorted and through an order) on both of
     its paths: a warp per document at S_pad 128 and 131 (scalar loads),
     a block per document at 2,176, 4,096 and 9,000 (two chunks), D = 1
     on each; the move
     source's round kernel (move_round) and fixpoint kernel
     (resolve_moves, the one the move plane launches) at N_pad 512
     (K_pad 512) and 4,096 (registers and shared memory, up to the cap),
     4,224, 8,192 and 16,384 (global scratch), and 1,664 with wide labels
     and with labels whose hi is the pad; the domination kernel
     at (D, N, A) (512, 128, 4), (64, 1,024, 8), (1, 4,096, 16), (10,000,
     32, 4) (the docset fleet's shape) and (300, 45, 3), each with values
     below 2**24 and over the whole int32 range; the linearize kernel on
     workloads.LINEARIZE_CASES (E = 1, 8, 256, 257, 4,096, 9,000 past the
     shared memory, 20,000 rows of 8) of random_linearize's edge rows (RGA
     rows, parents past the array, all-masked rows, equal keys), and on
     workloads.LINEARIZE_CAUSAL_CASES (E = 8, 256, 4,096, and 9,000 in the
     global scratch) of causal_linearize's rows (its parallel path) and
     of mixed_linearize's batches (causal rows and rows that take the
     walk in one launch), each line with how many rows took the walk;
  2. the map storm of the reference's bench config 20: 10,000 docs, 8 heavy
     docs of 400 ops, 8 zipf(1.1) rounds of ~1K dirty docs. (a) The main
     path: the rounds pre-encoded as AMR1 round frames, applied by
     apply_round_frames one frame a call, each followed by hashes(); each
     round's host legs (decode, actor registration + precheck, admission
     + native encode, triplets, dispatch, readback) timed by wrapping the
     engine's methods; every round after the first call on the batched
     admission path; no frame round plans a megabatch route. (b) The 8
     frames as one micro-batch. (c) apply_rounds (native), then late docs
     and a minority-dirty hashes_for read, MINORITY_REPS times each way in
     turns (the same lanes marked dirty again before each): the megabatch
     route on (the default; its plan, est_mega_s against est_alt_s,
     printed) and off (AMTPU_MEGABATCH=0), hashes equal, the planner's
     pick held to be no slower than the route off (10% of its p50 + 0.05
     ms), with the route's buckets, fill and padding waste. (d)
     apply_rounds with native=False. One final hash set;
  3. a text fleet of 2,048 docs, 4 concurrent typists each, so the list
     half of the kernel runs; its startup read takes the full-buffer path;
     the main path through apply_round_frames (a frame a call, read back,
     legs split), then apply_rounds native and native=False, all equal;
  4. both paths' final hashes (and those of 2(c)'s engine, after the
     megabatch route's reads) recomputed from the device buffer by the
     plain version, and the launch counts of both paths;
  5. small fixed-seed workloads against outputs the JAX reference computed
     (automerge_tpu_torch/testdata/reference_hashes.npz): the rows streams'
     hashes (through apply_rounds and apply_round_frames), span-table
     merges, move resolutions and the docs-major engine's hashes (512 docs
     of the docset fleet, 64 of the text fleet; through apply_and_reconcile
     and apply_and_reconcile_columns);
  6. the text-merge plane: bench config 10's 1,000,000-char bulk merge and
     a 10,000-doc fleet of its small-doc shape, each one routed dispatch
     (the plan must pick the device, the kernel must launch once), held
     against the plain version and the numpy oracle; then merge_spans
     split by CUDA events into its four sorts, the kernel and the glue;
  7. the move plane: bench config 16's storm realm (1,536 concurrent
     reparents of 1,600 objects) and a fleet of 1,024 such realms, held
     against the plain version, the numpy oracle, the kernel's schedule
     model (move_schedule.schedule_model, whose rounds, doubling steps and
     gathers the timing line prints beside the plain schedule's) and (one
     realm) the host walk;
  8. the routers' cost constants measured on this machine (the "link"
     line: launch + readback, host<->device copies, the numpy oracles;
     the megabatch planner's: a launch's enqueue, the reconcile's rate
     over phase 2's resident buffer, the host mirror's gather, the route's
     host work);
  9. the docs-major engine: (a) bench config 5's docset fleet (10,000
     docs, 12 rounds of 2,000 one-op changes) through ResidentDocSet, then
     apply_changes and a minority hashes_for read, held to apply_batch
     from scratch; the same rounds through apply_and_reconcile_columns
     (per-doc columns decoded from AMW1 frames) and through
     apply_and_reconcile with native=False; (b) phase 3's text fleet
     through ResidentDocSet by the same three routes, its hashes equal to
     the rows engine's; (c) apply_batch of the text fleet's change sets
     equal to (b). For (a) and (b) the domination kernel on the final
     state equals its plain version, and (b)'s last apply_doc kept
     exactly the ops the plain flags leave undominated. Every
     apply_and_reconcile launches the linearize kernel once: phase 9's
     launches and phase 10's are the kernels line's count;
 10. the docs-major diff plane at full width: phase 9's docset fleet (an
     admitting round, then 12) and text fleet (4 rounds) through
     apply_and_reconcile_columns(..., diffs=True), every round's hashes
     equal to phase 9's column route, the records equal to a device="cpu"
     instance's over a subset (every 10th docset doc, every 2nd text doc),
     and a MirrorDoc per document folded from every round equal to
     materialize (the docset fleet's 2,000 touched docs and 100 others, all
     text docs); the round walls with and without diffs and the diff
     round's legs; then the small streams of
     workloads.reference_diff_streams (with a map move and a list move)
     against the records the JAX reference computed
     (testdata/reference_diffs.json). Each diff round launches the
     linearize kernel once;
 11. rows-engine durability on the long-lived fleet of the reference's
     bench config 15 (1,024 docs, 4 writers, 64 overwritten fields; the
     depth cut from 10,000 changes a doc to 2,560): 10 micro-batches of
     256 round frames through apply_round_frames under the sync service's
     rule (on RowsBudgetError compact every doc to its causal floor and
     retry once), each followed by the horizon pass (archive_log_prefix
     into a LogArchive); the round walls with and without a compaction,
     the compaction wall, ops and resident bytes before and after, the
     archive's walls and the RAM log; then _rebuild_from_log (archive
     read, chunked replay), its wall and launches, hashes equal to the
     engine's before; then a snapshot boot (SnapshotStore images of all
     but the last 50 changes a doc, apply_rounds of every image,
     seed_clock, the tail as one frame) equal to the long-lived engine;
     then phase 3's text fleet after a round in which every typist
     acknowledges the others: compaction at the causal floors (elements
     and ghosts), an insert after a ghost rejected before admission with
     CompactionAnchorError, and an ordinary round admitted. Every engine
     state is held to the plain version (hold_to_plain); the kernels
     line counts the phase's launches;
 12. the document API and the interpretive OpSet on the card: (a) bench
     config 16(b)'s storm (1,600 objects, 1,536 concurrent moves by 7
     writers) through OpSet.init(device).add_changes(move_batch=True),
     held to the same on the CPU (the plain B4) and to the per-op path
     with the walk forced (AMTPU_MOVE_KERNEL_MIN = 2**30): parents, drops,
     batch diffs and documents equal; the plan's estimates and the B4
     launches; (b) the same storm a change a call at the default
     threshold (B4 from the 64th moved node on), its state equal to (a);
     (c) bench config 10's bulk merge: a 1M-char base by api.load (the bulk
     loader), H1 applied, H2 (1% concurrency) merged by the span plane and
     by the per-op path, the joined texts equal; (d) bench config 6's
     65,536-edit text load by api.load, equal to the interpretive replay;
     (e) ResidentRowsDocSet.materialize: 64 docs of phase 3's text fleet
     (equal to phase 9's docs-major materialize and to a CPU rows
     instance), 16 docs of phase 11's long-lived fleet after an archive
     pass (archive + tail) and 16 snapshot-booted ones (image +
     remap_tail), each equal to a replay of its full log, ms a doc; (f)
     the batch route's host constants (the "batch_link" line), then
     dispatch.apply_batch_adaptive on bench config 5's docset fleet (the
     device route, hashes equal to apply_batch's) and on a batch small
     enough to plan the host (documents equal to apply_batch's decode).
     The kernels line adds (a) and (b)'s B4 launches and (f)'s B5 and
     linearize launches.
Then the kernel timings (each kernel's launches timed three ways:
`kernel_ms` from CUDA events around a host loop of launches, the host's
`enqueue_ms` per launch in that loop, and `graph_ms` from a replay of the
same launches captured in one CUDA graph, the device alone; the reconcile
kernel also `graph_cold_ms`, the graph with the L2 flushed before each
launch, as the main path finds it), a `kernels` JSON line (its `ms` the
graph figure, cold for the reconcile kernel; the reconcile kernel's
launches count the megabatch buckets, and its "mega" key the route's
rounds, buckets, docs, fill and padding waste on the main path), the
card's name and power limit, and the last line {"ok": true, "device":
{...}}. Any failure exits
non-zero; without a CUDA device, or outside a checkout, it prints no result.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, and the
# non-tensor float32 rate, taken for the int32 compares (a bound: Hopper's
# int32 lanes are no faster than its float32 lanes).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# Bytes read between two timed launches to leave the H100's 50 MB L2 cold.
L2_FLUSH_BYTES = 256 << 20

# Integer operations a lane of each plane's kernel needs at least: an
# unmasked span lane of the rank+hash takes four murmur finalizers (8 ops
# each), their four mixes, the scan add and the masked selects; a move
# node does ~12 for its winner gather and ~8 per doubling step (two label
# loads, three compares, three selects).
SPAN_LANE_OPS = 40
# Minority reads each way (the megabatch route on, off) in phase 2(c), in
# turns: the p50s its check compares are over all of them.
MINORITY_REPS = 8
MOVE_GATHER_OPS = 12
MOVE_STEP_OPS = 8


_CARD: list = []


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them (read
    once), to print beside every number."""
    if not _CARD:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        _CARD.append(smi.stdout.strip().splitlines()[0])
    return _CARD[0]


def check(cond, msg: str) -> None:
    """Fail the run (a raise, unlike assert, survives python -O)."""
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps: int, enqueue: list | None = None) -> float:
    """Mean device milliseconds of fn() over `reps` launches, after one
    warm-up, from CUDA events. With a list `enqueue`, appends the host
    milliseconds per call that the loop took to enqueue them: where that
    comes near the device time, the launches waited on the host and the
    window measured the host's launch rate, not the kernel."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    stop.record()
    torch.cuda.synchronize()
    if enqueue is not None:
        enqueue.append(host * 1e3 / reps)
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps: int, replays: int = 5) -> float:
    """Mean device milliseconds of one call of fn() with the host out of
    the window: `reps` calls captured into one CUDA graph (the wrappers
    launch on the current stream, which torch.cuda.graph makes the capture
    stream), one replay to warm up, then `replays` replays between CUDA
    events, over reps * replays."""
    import torch
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


def graph_cold_ms(fn, reps: int) -> float:
    """graph_ms of fn() where each launch finds the L2 cold, as a caller
    whose buffer is far larger than the L2 leaves it: each launch in the
    graph follows a read of L2_FLUSH_BYTES (a read, so the lines it leaves
    are clean and evicting them costs the launch nothing), and the graph
    of those reads alone is subtracted."""
    import torch
    flush = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                       device=torch.cuda.current_device())
    both = graph_ms(lambda: (flush.sum(), fn()), reps)
    alone = graph_ms(lambda: flush.sum(), reps)
    return both - alone


def launch_times(fn, reps: int, cold: bool = False) -> dict:
    """The windows of one kernel's launches: `kernel_ms` (CUDA events
    around `reps` launches from the host loop), `enqueue_ms` (the host's ms
    per launch in that loop), `graph_ms` (graph_ms: the device alone, on
    inputs the previous launch left in L2) and, with `cold`,
    `graph_cold_ms` (graph_cold_ms: the device alone, L2 cold)."""
    enq = []
    k_ms = cuda_ms(fn, reps, enq)
    t = {"kernel_ms": k_ms, "enqueue_ms": enq[0],
         "graph_ms": graph_ms(fn, reps)}
    if cold:
        t["graph_cold_ms"] = graph_cold_ms(fn, reps)
    return t


def times_text(t: dict) -> str:
    return (f"kernel_ms={t['kernel_ms']:.4f} enqueue_ms={t['enqueue_ms']:.4f} "
            f"graph_ms={t['graph_ms']:.4f}"
            + (f" graph_cold_ms={t['graph_cold_ms']:.4f}"
               if "graph_cold_ms" in t else ""))


def max_abs_err(got, want) -> int:
    import numpy as np
    return int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max(
        initial=0))


def bound_of(nbytes: int, ops: int):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the operations over the compute rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _key_hists(keys, mask, other, other_mask):
    """Per-lane histograms ([D, R] int64) of the masked keys of `keys` and
    of `other` ([D, n] int32 each) over one shared key range."""
    import torch
    masked = [k[m] for k, m in ((keys, mask), (other, other_mask))]
    masked = [k for k in masked if k.numel()]
    lo = min((int(k.min()) for k in masked), default=0)
    hi = max((int(k.max()) for k in masked), default=0)

    def hist(k, m):
        out = torch.zeros((k.shape[0], hi - lo + 1), dtype=torch.int64,
                          device=k.device)
        at = torch.where(m, k - lo, 0).to(torch.int64)
        return out.scatter_add_(1, at, m.to(torch.int64))
    return hist(keys, mask), hist(other, other_mask), lo


def _pair_count(keys, mask, other=None, other_mask=None):
    """Per lane, the ordered pairs of masked slots with equal keys ([D, N]
    int32 keys), or with `other`/`other_mask` the pairs (slot of keys,
    slot of other) with equal keys. Summed over lanes."""
    if other is None:
        other, other_mask = keys, mask
    h, g, _ = _key_hists(keys, mask, other, other_mask)
    return int((h * g).sum())


def _has_key(keys, mask, other, other_mask):
    """[D, n] bool: the slot of `keys` is masked and a masked slot of
    `other` in its lane holds the same key."""
    import torch
    _, g, lo = _key_hists(keys, mask, other, other_mask)
    at = torch.where(mask, keys - lo, 0).to(torch.int64)
    return mask & (torch.gather(g, 1, at) > 0)


def _clock_cells(clock_op, actor, fid, seq, change, mask_i, mask_j,
                 oob_reads_zero):
    """(cells, dominated) of a domination over docs-major [D, N(, A)]
    inputs: the 4-byte cells clock_op[d, j, actor_i] the answer needs, each
    once (for an undominated op i of mask_i, those of every j of mask_j on
    its field from another change; for a dominated one, that of its first
    dominator; an actor outside [0, A) reads none), and the [D, N]
    dominated flags. Such an actor reads a clock of 0 where
    `oob_reads_zero`, and is never dominated otherwise."""
    import torch
    d, n, a = clock_op.shape
    cells = 0
    dominated = torch.zeros((d, n), dtype=torch.bool, device=fid.device)
    step = max(1, (1 << 24) // max(n * n, 1))
    for lo in range(0, d, step):
        sl = slice(lo, lo + step)
        f, c, sq, act = fid[sl], change[sl], seq[sl], actor[sl]
        ok = (act >= 0) & (act < a)
        col = act.clamp(0, a - 1).to(torch.int64)
        cand = (mask_i[sl][:, :, None] & mask_j[sl][:, None, :]
                & (f[:, :, None] == f[:, None, :])
                & (c[:, :, None] != c[:, None, :]))            # [d, i, j]
        clk = torch.gather(clock_op[sl].transpose(1, 2), 1,
                           col[:, :, None].expand(-1, -1, n))  # [d, i, j]
        ge = clk >= sq[:, :, None]
        oob = (sq <= 0) if oob_reads_zero else torch.zeros_like(ok)
        hit = cand & torch.where(ok[:, :, None], ge, oob[:, :, None])
        dominated[sl] = hit.any(2)
        first = torch.zeros_like(hit).scatter_(
            2, hit.to(torch.int32).argmax(2, keepdim=True), True) & hit
        need = torch.where(hit.any(2, keepdim=True), first, cand)
        need &= ok[:, :, None]
        onehot = torch.nn.functional.one_hot(col, a).to(torch.float32)
        cells += int((torch.einsum("dij,dia->dja", need.to(torch.float32),
                                   onehot) > 0).sum())
    return cells, dominated


def bound(rows, dims):
    """(bound_ms, bound_by, bytes, ops) of one reconcile of `rows`, for
    this data. Bytes, each cell once: op_mask of every op slot; action
    where op_mask > 0; fid and change of live ops; actor and seq of live
    non-deletes, and the clock cells their domination reads
    (_clock_cells); the value hash of candidates, and the field hash of a
    candidate whose field holds no valid element (a list's key is its
    element's objhash and rank); ins_mask of every element slot; ins_fid
    where ins_mask > 0; ins_pos, objhash and list of visible elements (the
    only ones a rank or a candidate's join reads: a valid element on a
    candidate's field is visible); the actor-hash rows the candidates use;
    the hashes written. Operations: a compare for each pair a join matches
    on its key: (live non-delete, live) ops on one field, (valid element,
    candidate) and (candidate, visible element) on one field, and visible
    elements in one list."""
    import torch
    from automerge_tpu_torch.engine.pack import row_bases
    i, a, le, a_set, a_del = dims
    b = row_bases(i, a, le)
    d = rows.shape[1]

    def band(g, n):                      # [D, n], docs-major view
        return rows[b[g]:b[g] + n].t()
    om, ac, fid, act, seq, chg = (band(g, i) for g in
                                  ("om", "ac", "fid", "act", "seq", "chg"))
    live = (om > 0) & (ac >= a_set)
    need = live & (ac != a_del)
    clock_op = rows[b["co"]:b["co"] + a * i].reshape(a, i, d).permute(2, 1, 0)
    cells, dominated = _clock_cells(clock_op, act, fid, seq, chg, need, live,
                                    oob_reads_zero=False)
    cand = need & ~dominated
    ok = (act >= 0) & (act < a)
    ah_used = torch.zeros((d, max(a, 1)), dtype=torch.int64,
                          device=rows.device)
    ah_used.scatter_add_(1, act.clamp(0, max(a - 1, 0)).to(torch.int64),
                         (cand & ok).to(torch.int64))
    ops = _pair_count(fid, need, fid, live)
    is_list = torch.zeros_like(cand)
    n_set = n_visible = 0
    if le:
        im, ifd, il = (band(g, le) for g in ("im", "if", "il"))
        valid = (im > 0) & (ifd >= 0)
        visible = _has_key(ifd, valid, fid, cand)
        is_list = _has_key(fid, cand, ifd, valid)
        n_set, n_visible = int((im > 0).sum()), int(visible.sum())
        ops += (_pair_count(ifd, valid, fid, cand) + _pair_count(il, visible)
                + _pair_count(fid, cand, ifd, visible))
    nbytes = (4 * i * d + 4 * int((om > 0).sum()) + 8 * int(live.sum())
              + 8 * int(need.sum()) + 4 * cells + 4 * int(cand.sum())
              + 4 * int((cand & ~is_list).sum()) + 4 * le * d + 4 * n_set
              + 12 * n_visible + 4 * int((ah_used > 0).sum()) + 4 * d)
    return (*bound_of(nbytes, ops), nbytes, ops)


def span_bound(spans):
    """(bound_ms, bound_by, bytes, ops) of one rank+hash launch through an
    order, for this data: the mask and the order read and the starts
    written on every lane; origin, start_id and vis_len read on unmasked
    lanes only (the function needs nothing else of a masked lane, nor the
    sort keys); hash and total written once per document; SPAN_LANE_OPS
    per unmasked lane."""
    from automerge_tpu_torch.engine.span_kernels import F_MASK
    d, _f, s = spans.shape
    real = int((spans[:, F_MASK] > 0).sum())
    nbytes = d * s * 3 * 4 + real * 3 * 4 + d * 2 * 4
    ops = real * SPAN_LANE_OPS
    return (*bound_of(nbytes, ops), nbytes, ops)


def move_rounds(nodes, cands):
    """Per realm, the fixpoint rounds the resolution runs before its final
    round (the rounds with drops and the one that finds none), from the
    plain round on the same lanes."""
    import torch
    from automerge_tpu_torch.engine.move_kernels import _round_plain
    d = nodes.shape[0]
    ptr = torch.zeros((d, nodes.shape[2]), dtype=torch.int32,
                      device=nodes.device)
    active = torch.ones(d, dtype=torch.bool, device=nodes.device)
    rounds = torch.zeros(d, dtype=torch.int64, device=nodes.device)
    for _ in range(cands.shape[2] + 1):
        _parent, drop, _unres = _round_plain(nodes, cands, ptr)
        rounds += active
        active &= drop.any(1)
        if not bool(active.any()):
            break
        ptr = ptr + drop.to(torch.int32)
    return rounds


def move_bound(nodes, cands):
    """(bound_ms, bound_by, bytes, ops) of one fixpoint launch: the lanes
    read once and ptr, parent, resolved, dropped and hash written once;
    per real node and round run (this data's rounds plus the final one),
    one winner gather and ceil(log2 N) + 1 doubling steps."""
    from automerge_tpu_torch.engine.move_kernels import _ceil_log2
    d, _f, n = nodes.shape
    k = cands.shape[2]
    steps = _ceil_log2(n) + 1
    real = (nodes[:, 0] > 0).sum(1)
    runs = move_rounds(nodes, cands) + 1
    ops = int((runs * real).sum()) * (MOVE_GATHER_OPS
                                      + steps * MOVE_STEP_OPS)
    nbytes = d * (16 * n + 12 * k) + d * (9 * n + 8)
    return (*bound_of(nbytes, ops), nbytes, ops)


def phase_kernel_parity(torch, dev, report):
    from automerge_tpu_torch.engine import cuda_kernels as ck
    from automerge_tpu_torch.engine.pack import rows_dims_eligible
    from automerge_tpu_torch.workloads import RECONCILE_CASES, reconcile_case

    t = ck.build()
    print(f"phase 1: built {sorted(ck.SOURCES)} in {t:.2f} s")
    print_ptxas()
    for name in RECONCILE_CASES:
        rows_np, dims = reconcile_case(name, seed=1)
        i, a, le = dims[:3]
        rows = torch.from_numpy(rows_np).to(dev)
        want = ck.hashes_to_numpy(ck.reconcile_rows_hash_plain(rows, dims))
        # the XL form blocks the op band by _XL_BI
        xl_forms = (False, True) if i % ck._XL_BI == 0 else (False,)
        for force_xl in xl_forms:
            got, launches = counted("reconcile_rows_hash",
                                    lambda: ck.reconcile_rows_hash(
                                        rows, dims, force_xl))
            got = ck.hashes_to_numpy(got)
            err = max_abs_err(got, want)
            check(launches == 1, "the wrapper did not launch its kernel")
            check(err == 0 and (got == want).all(),
                  f"{name} force_xl={force_xl}: kernel != plain version")
            report["reconcile_rows_hash"].append(err)
        line = (f"phase 1: reconcile {name} I={i} A={a} LE={le} "
                f"D={rows.shape[1]} base_envelope="
                f"{rows_dims_eligible(i, a, le)} xl_envelope="
                f"{ck.rows_dims_eligible_xl(i, a, le)}: one launch a call, "
                f"equal to the plain version, "
                + ("with and without force_xl" if len(xl_forms) == 2
                   else f"without force_xl (I % {ck._XL_BI} != 0)"))
        if name in ("base", "xl_only") or name.startswith("bucket_"):
            t = launch_times(lambda: ck.reconcile_rows_hash(rows, dims), 10,
                             cold=True)
            p_ms = cuda_ms(lambda: ck.reconcile_rows_hash_plain(rows, dims), 2)
            b_ms, b_by = bound(rows, dims)[:2]
            line += (f"; {times_text(t)} plain_ms={p_ms:.3f} "
                     f"bound_ms={b_ms:.5f} ({b_by}) [{card()}]")
        print(line)
    check(not rows_dims_eligible(512, 8, 512)
          and ck.rows_dims_eligible_xl(512, 8, 512),
          "the XL-only shape is not XL-only")


def print_ptxas() -> None:
    """The compiler's register and spill report of every source built in
    this process (cuda_kernels.BUILD_LOG), each kernel's line after its
    name."""
    from automerge_tpu_torch.engine import cuda_kernels as ck
    for name, log in ck.BUILD_LOG.items():
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")


def hold_equal(got: dict, want: dict, what: str, report: list) -> None:
    """Every key of `want` equal in `got` (numpy arrays); the largest
    absolute difference goes to `report`."""
    for k, w in want.items():
        g = got[k]
        check(g.shape == w.shape, f"{what}: {k} shape {g.shape} != {w.shape}")
        err = max_abs_err(g, w)
        report.append(err)
        check(err == 0 and (g == w).all(), f"{what}: {k} differs")


def counted(name: str, fn):
    """fn() and the launches of kernel `name` it made, by a delta of the
    wrapper's counter."""
    import torch
    from automerge_tpu_torch.engine import cuda_kernels as ck
    before = ck.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    return out, ck.LAUNCHES[name] - before


def phase_plane_kernel_parity(torch, dev, report):
    """Phase 1, the batched planes' kernels on random inputs: each call
    launches its kernel once and equals the plain version bit for bit."""
    import numpy as np
    from automerge_tpu_torch.engine import move_kernels as mk
    from automerge_tpu_torch.engine import span_kernels as sk
    from automerge_tpu_torch.engine.pack import pack_spans
    from automerge_tpu_torch.workloads import (random_move_lanes,
                                               random_span_tables)

    rng = np.random.default_rng(2)
    # both paths of the kernel: a warp per document (S <= 1,024; S = 131
    # takes scalar loads) and a block per document (S = 9,000: two
    # chunks), and D = 1 on each
    for d, s_pad in [(512, 128), (64, 4096), (64, 131), (1, 131),
                     (1, 2176), (4, 9000)]:
        tables = (random_span_tables(rng, d // 2, s_pad - 5)
                  + random_span_tables(rng, d - d // 2, s_pad - 5,
                                       full_range=True))
        packed = pack_spans(tables)[:, :, :s_pad]
        spans = torch.from_numpy(np.ascontiguousarray(np.pad(
            packed, ((0, 0), (0, 0), (0, s_pad - packed.shape[2]))))).to(dev)
        check(spans.shape == (d, 8, s_pad), f"span shape {spans.shape}")
        order = torch.argsort(torch.rand((d, s_pad), device=dev),
                              dim=1).to(torch.int32)
        for label, args in (("pre-sorted", (spans,)),
                            ("through order", (spans, order))):
            got, n = counted("span_rank_hash",
                             lambda: sk.span_rank_hash(*args))
            want = sk.span_rank_hash_plain(*args)
            check(n == 1, f"span_rank_hash launched {n} times")
            hold_equal({k: g.cpu().numpy() for k, g in
                        zip(("starts", "hash", "total"), got)},
                       {k: w.cpu().numpy() for k, w in
                        zip(("starts", "hash", "total"), want)},
                       f"span_rank_hash {label} D={d} S_pad={s_pad}",
                       report["span_rank_hash"])
        print(f"phase 1: span_rank_hash D={d} S_pad={s_pad} "
              f"({'warp' if sk.span_launch(s_pad) else 'block'} per "
              f"document): pre-sorted and through an order, one launch "
              f"each, equal to the plain version")
    # registers and shared memory on each side of each threshold of the
    # launch plan (a node a thread up to 512 nodes, 512 threads x 4 up to
    # 2,048, 1,024 x 4 up to SMEM_MAX_NODES, 4,096), the global scratch
    # above it (labels: the narrow code on ranks and on labels whose hi is
    # the pad, and wide labels)
    for d, n_pad, k_pad, labels in [
            (256, 512, 512, "ranks"), (64, 640, 640, "ranks"),
            (16, 2176, 1024, "ranks"), (32, 4096, 4096, "ranks"),
            (4, 4224, 1024, "ranks"), (4, 8192, 1024, "ranks"),
            (2, 16384, 2048, "ranks"),
            (64, 1664, 1664, "wide"),
            (64, 1664, 1664, "pad_hi")]:
        nodes, cands, ptr = (torch.from_numpy(a).to(dev) for a in
                             random_move_lanes(rng, d, n_pad, k_pad, labels))
        got, n = counted("move_round",
                         lambda: mk.move_round(nodes, cands, ptr))
        check(n == 1, f"move_round launched {n} times")
        hold_equal({"out": got.cpu().numpy()},
                   {"out": mk.move_round_plain(nodes, cands,
                                               ptr).cpu().numpy()},
                   f"move_round N_pad={n_pad}", report["move_round"])
        got, n = counted("resolve_moves",
                         lambda: mk.resolve_moves(nodes, cands))
        check(n == 1, f"resolve_moves launched {n} times")
        want = mk.resolve_moves_plain(nodes, cands)
        hold_equal({k: v.cpu().numpy() for k, v in got.items()},
                   {k: v.cpu().numpy() for k, v in want.items()},
                   f"resolve_moves N_pad={n_pad}", report["resolve_moves"])
        threads, npt = mk.move_launch(n_pad)
        where = (f"{threads} threads, {npt} nodes a thread in registers"
                 if npt else "global scratch")
        print(f"phase 1: move_round and resolve_moves D={d} N_pad={n_pad} "
              f"K_pad={k_pad} labels {labels} ({where}): "
              f"one round and the fixpoint, one launch each, equal to the "
              f"plain version (cycle drops {int(want['dropped'].sum())})")


def phase_dominated_parity(torch, dev, report):
    """Phase 1, the domination kernel on random inputs: one launch a call,
    bit-equal to the plain version."""
    import numpy as np
    from automerge_tpu_torch.engine import cuda_kernels as ck
    from automerge_tpu_torch.workloads import random_dominated

    rng = np.random.default_rng(5)
    for d, n, a in [(512, 128, 4), (64, 1024, 8), (1, 4096, 16),
                    (10_000, 32, 4), (300, 45, 3)]:
        for full in (False, True):
            args = [torch.from_numpy(x).to(dev)
                    for x in random_dominated(rng, d, n, a, full)]
            got, k = counted("dominated", lambda: ck.dominated(*args))
            check(k == 1, f"dominated launched {k} times")
            hold_equal({"flags": got.cpu().numpy()},
                       {"flags": ck.dominated_plain(*args).cpu().numpy()},
                       f"dominated D={d} N={n} A={a}", report["dominated"])
            print(f"phase 1: dominated D={d} N={n} A={a} "
                  f"{'full int32 range' if full else 'values < 2**24'}: one "
                  f"launch, equal to the plain version (dominated share "
                  f"{float(got.float().mean()):.3f})")


def linearize_where(ck, e) -> str:
    """The launch path the linearize kernel takes for rows of E slots."""
    from automerge_tpu_torch.linearize_schedule import SHORT_MAX
    if e <= SHORT_MAX:
        return "a warp slice a row"
    return ("a block a row, global scratch" if ck.linearize_uses_scratch(e)
            else "a block a row, shared memory")


def walk_text(args) -> str:
    """How many of these rows (numpy inputs) take the kernel's sequential
    walk, are empty, or take the parallel path: its verdict, computed on
    the host by the kernel's CPU model."""
    from automerge_tpu_torch.linearize_schedule import causal_rows
    live = args[0].any(1)
    causal = causal_rows(*args)
    return (f"{int((live & ~causal).sum())} rows take the walk, "
            f"{int((live & causal).sum())} the parallel path, "
            f"{int((~live).sum())} empty")


def phase_linearize_parity(torch, dev, report):
    """Phase 1, the linearize kernel on random_linearize's edge rows, on
    causal_linearize's rows and on mixed_linearize's batches: one launch a
    call, bit-equal to linearize_plain on the card."""
    import numpy as np
    from automerge_tpu_torch.engine import cuda_kernels as ck
    from automerge_tpu_torch.engine.kernels import linearize_plain
    from automerge_tpu_torch.workloads import (LINEARIZE_CASES,
                                               LINEARIZE_CAUSAL_CASES,
                                               causal_linearize,
                                               mixed_linearize,
                                               random_linearize)

    cases = ([("edge rows", random_linearize, r, e, r + e)
              for r, e in LINEARIZE_CASES]
             + [(name, gen, r, e, r * e)
                for r, e in LINEARIZE_CAUSAL_CASES
                for name, gen in (("causal rows", causal_linearize),
                                  ("mixed batch", mixed_linearize))])
    for name, gen, r, e, seed in cases:
        host = gen(np.random.default_rng(seed), r, e)
        args = [torch.from_numpy(x).to(dev) for x in host]
        got, k = counted("linearize", lambda: ck.linearize(*args))
        check(k == 1, f"linearize launched {k} times")
        hold_equal({"elem_pos": got.cpu().numpy()},
                   {"elem_pos": linearize_plain(*args).cpu().numpy()},
                   f"linearize {name} R={r} E={e}", report["linearize"])
        print(f"phase 1: linearize {name} R={r} E={e} "
              f"({linearize_where(ck, e)}; {walk_text(host)}): one launch, "
              f"equal to the plain version")


def p50(xs) -> float:
    return sorted(xs)[len(xs) // 2]


def walls_text(walls) -> str:
    return (f"{[round(w, 4) for w in walls]} (p50 {p50(walls):.4f})")


# The host legs of each ingress route, each the engine methods it wraps
# (chip_smoke.py times them from outside; the package has no switch). The
# frame decode and the readback are timed around the calls, and "other" is
# the call's wall less its legs.
FRAME_LEGS = {
    "register+precheck": ("_register_round_actors", "_precheck_round_frames"),
    "admit+encode": ("_encode_rounds_batched", "_encode_round_frame",
                     "_grow_for_rounds"),
    "triplets": ("_cols_triplets",),
    "dispatch": ("_dispatch_final",),
}
# apply_rounds on the native encoder ("other": changes_to_columns, the
# guards)
ROUNDS_LEGS = {
    "register+precheck": ("_register_actors_cols",
                          "_precheck_rows_budget_cols"),
    "admit+encode": ("_native_encode_round", "_grow_for_rounds"),
    "triplets": ("_cols_triplets",),
    "dispatch+readback": ("_dispatch_rounds",),
}
# apply_and_reconcile_columns ("other": a Delta per doc slot, the rows
# sliced per doc, the table mirror)
COLUMN_LEGS = {
    "register": ("_register_actors_cols",),
    "admit+encode": ("_native_ingest_round",),
    "stack+copy": ("_stack_deltas",),
    "apply+readback": ("_apply_flat",),
}


def timed_into(legs: dict, leg: str, fn):
    """fn, wrapped to add the host seconds of each call into legs[leg]."""
    def timed(*a, **k):
        t = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            legs[leg] += time.perf_counter() - t
    return timed


def time_legs(ds, spec=FRAME_LEGS) -> dict:
    """Wrap ds's methods named in `spec` to add their host seconds into
    the returned dict."""
    legs = {leg: 0.0 for leg in spec}
    for leg, names in spec.items():
        for name in names:
            setattr(ds, name, timed_into(legs, leg, getattr(ds, name)))
    return legs


def timed_calls(ds, spec, calls):
    """Run each call (a function of ds) with ds's `spec` legs timed.
    Returns the walls and the legs of each call, "other" included."""
    legs = time_legs(ds, spec)
    walls, per_call = [], []
    for call in calls:
        for k in legs:
            legs[k] = 0.0
        t0 = time.perf_counter()
        out = call(ds)
        wall = time.perf_counter() - t0
        walls.append(wall)
        per_call.append({**legs, "other": wall - sum(legs.values())})
    return out, walls, per_call


def frame_rounds(ds, frames):
    """The main path: one round frame a call, then the hash read, each
    round split into its host legs. Returns the final hashes, the walls
    and the legs of each round."""
    from automerge_tpu_torch.sync.frames import decode_round_frame
    legs = time_legs(ds)
    walls, per_round = [], []
    final = None
    for f in frames:
        for k in legs:
            legs[k] = 0.0
        t0 = time.perf_counter()
        rc = decode_round_frame(f)
        t1 = time.perf_counter()
        ds.apply_round_frames([rc])
        t2 = time.perf_counter()
        final = ds.hashes()
        t3 = time.perf_counter()
        split = {"decode": t1 - t0, **legs, "readback": t3 - t2}
        split["other"] = (t2 - t1) - sum(legs.values())
        walls.append(t3 - t0)
        per_round.append(split)
    return final, walls, per_round


def legs_text(per_round) -> str:
    """Each leg's p50 seconds over the rounds and its share of the summed
    walls."""
    total = sum(sum(r.values()) for r in per_round)
    return "; ".join(
        f"{k} p50 {p50([r[k] for r in per_round]):.5f} s "
        f"({100 * sum(r[k] for r in per_round) / total:.1f}%)"
        for k in per_round[0])


@contextlib.contextmanager
def megabatch_off():
    """AMTPU_MEGABATCH=0 for the port: set in os.environ and the planner's
    cached reading dropped; both restored after."""
    from automerge_tpu_torch.engine import dispatch
    old = os.environ.get("AMTPU_MEGABATCH")
    os.environ["AMTPU_MEGABATCH"] = "0"
    dispatch._reload_for_tests()
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("AMTPU_MEGABATCH", None)
        else:
            os.environ["AMTPU_MEGABATCH"] = old
        dispatch._reload_for_tests()


@contextlib.contextmanager
def recorded_plans():
    """Every RoundPlan the engine's planner returns, in order:
    dispatch.plan_round wrapped, put back after."""
    from automerge_tpu_torch.engine import dispatch
    plans = []
    real = dispatch.plan_round

    def rec(rset, idxs):
        t0 = time.perf_counter()
        plan = real(rset, idxs)
        plan.plan_s = time.perf_counter() - t0
        plans.append(plan)
        return plan
    dispatch.plan_round = rec
    try:
        yield plans
    finally:
        dispatch.plan_round = real


def plans_text(plans) -> str:
    return "; ".join(
        f"{p.route} buckets "
        f"{[(b['dims'], len(b['docs'])) for b in p.buckets]} est_mega_s="
        f"{p.est_mega_s:.3e} est_alt_s={p.est_alt_s:.3e} (planned in "
        f"{p.plan_s:.2e} s)"
        for p in plans) or "no plan"


def last_mega():
    """The megabatch summary of the ledger's newest folded round, or None."""
    from automerge_tpu_torch.engine import dispatchledger
    sec = dispatchledger.ledger().section()
    return sec["ring"][-1].get("mega") if sec and sec["ring"] else None


class MegaAccount:
    """The megabatch occupancy of the rounds a run folds: rounds routed
    megabatch, buckets (fused launches), docs, and fill and padding waste
    over them (the ledger's definitions)."""

    def __init__(self):
        self.rounds = self.dispatches = self.docs = 0
        self.docs_cap = self.logical = self.padded = 0

    def add(self, m) -> None:
        if m:
            self.rounds += 1
            for k in ("dispatches", "docs", "docs_cap", "logical",
                      "padded"):
                setattr(self, k, getattr(self, k) + m[k])

    def as_dict(self) -> dict:
        return {"rounds": self.rounds, "dispatches": self.dispatches,
                "docs": self.docs,
                "fill_pct": (round(100.0 * self.docs / self.docs_cap, 3)
                             if self.docs_cap else None),
                "pad_waste_pct": (
                    round(100.0 * (1 - self.logical / self.padded), 3)
                    if self.padded else None)}

    def text(self) -> str:
        d = self.as_dict()
        return (f"rounds routed megabatch {d['rounds']}, buckets (fused "
                f"launches) {d['dispatches']}, docs {d['docs']}, fill_pct "
                f"{d['fill_pct']}, pad_waste_pct {d['pad_waste_pct']}")


def check_routes(name, on, off) -> None:
    """The planner's pick (route on) no slower than the route off, by more
    than 10% of the latter's p50 plus 0.05 ms (on and off: seconds of the
    same work). Prints the comparison before it checks it."""
    a, b = p50(on), p50(off)
    print(f"{name}: p50 {a:.6f} s (route on) against {b:.6f} s (off), "
          f"margin {1.1 * b + 5e-5 - a:.6f} s [{card()}]")
    check(a <= 1.1 * b + 5e-5,
          f"{name}: the planner's pick took {a:.6f} s (p50) against "
          f"{b:.6f} s with the route off")


def drive_map_storm(torch, dev):
    """Phase 2: the main path at bench config 20's scale, the storm's AMR1
    round frames through apply_round_frames one a call, each read back;
    then the same rounds as one 8-frame micro-batch, through apply_rounds
    (native) with the late docs and a minority read (the megabatch route
    on and off, in turns), and through apply_rounds with native=False.
    Returns the main path's engine, its final hashes and its launches
    with the route's, the apply_rounds engine with its final hashes, and
    the route's megabatch account."""
    from automerge_tpu_torch.engine import cuda_kernels as ck
    from automerge_tpu_torch.engine import dispatchledger
    from automerge_tpu_torch.engine import resident_rows as rr
    from automerge_tpu_torch.engine.resident_rows import ResidentRowsDocSet
    from automerge_tpu_torch.sync.frames import encode_round_frame
    from automerge_tpu_torch.workloads import map_storm

    ids, heavy, storm = map_storm()
    n = len(ids)
    t0 = time.perf_counter()
    heavy_frame = encode_round_frame(heavy)
    frames = [encode_round_frame(r) for r in storm]
    encode_s = time.perf_counter() - t0

    # (a) the main path; round frames never plan the megabatch route
    ds = ResidentRowsDocSet(ids, device=dev)
    ck.LAUNCHES["reconcile_rows_hash"] = 0
    with recorded_plans() as frame_plans:
        t0 = time.perf_counter()
        ds.apply_round_frames([heavy_frame])
        ds.hashes()
        heavy_s = time.perf_counter() - t0
        before = dict(rr.ROUNDS)
        final, walls, per_round = frame_rounds(ds, frames)
    launches = ck.LAUNCHES["reconcile_rows_hash"]
    moved = {k: rr.ROUNDS[k] - before[k] for k in before}
    check(moved == {"rows_rounds_batched": len(frames),
                    "rows_rounds_fallback": 0},
          f"map storm frames: rounds not all batched: {moved}")
    check(not frame_plans, "map storm frames: a frame round was planned")

    # (b) the same rounds as one micro-batch
    mb = ResidentRowsDocSet(ids, device=dev)
    mb.apply_round_frames([heavy_frame])
    mb.hashes()
    before = dict(rr.ROUNDS)
    t0 = time.perf_counter()
    h = mb.apply_round_frames(frames)
    t1 = time.perf_counter()
    mb_final = ck.hashes_to_numpy(h)[:n]
    mb_s, mb_read_s = t1 - t0, time.perf_counter() - t1
    mb_moved = {k: rr.ROUNDS[k] - before[k] for k in before}
    check(mb_moved["rows_rounds_fallback"] == 0,
          f"map storm micro-batch fell back: {mb_moved}")

    # (c) apply_rounds, native, with late docs and a minority read
    rd = ResidentRowsDocSet(ids, device=dev)
    rd.apply_rounds([heavy])
    rd.hashes()
    _, r_walls, r_legs = timed_calls(
        rd, ROUNDS_LEGS,
        [lambda e, rnd=rnd: e.apply_rounds([rnd]) for rnd in storm])
    # late docs fill padding lanes (the device copy stays current): a
    # minority-dirty read gathers them, through the route and (the same
    # lanes marked dirty again) with the route off, in turns
    fresh = [f"late{k:03d}"
             for k in range(min(100, rd.n_pad - len(rd.doc_ids)))]
    rd.add_docs(fresh)
    want = [rd.doc_index[d] for d in fresh] + [0, 9, 500]
    c_mega = MegaAccount()
    on_s, off_s = [], []
    minority_launches = 0
    minority_plans = first = None
    for rep in range(MINORITY_REPS):
        for route in ((True, False) if rep % 2 == 0 else (False, True)):
            if first is not None:
                rd._mark_hash_dirty(want)
            check(rd.rows_dev is not None and not rd._dirty,
                  "minority read: the device copy is not current")
            ctx = contextlib.nullcontext() if route else megabatch_off()
            with ctx, recorded_plans() as plans, \
                    dispatchledger.round_scope(len(want)):
                ck.LAUNCHES["reconcile_rows_hash"] = 0
                t = time.perf_counter()
                got = rd.hashes_for(want)
                (on_s if route else off_s).append(time.perf_counter() - t)
                launched = ck.LAUNCHES["reconcile_rows_hash"]
            if route:
                check(plans and plans[0].route == "megabatch",
                      f"minority read: the route was not taken "
                      f"({plans_text(plans)})")
                c_mega.add(last_mega())
                minority_launches += launched
                minority_plans = minority_plans or plans
            else:
                check(all(p.route == "per_doc" and not p.buckets
                          for p in plans),
                      "AMTPU_MEGABATCH=0 still planned a read")
            first = got if first is None else first
            check((got == first).all(),
                  "minority hashes_for: route on != route off")
    check(c_mega.dispatches == minority_launches,
          f"minority read: {minority_launches} launches for "
          f"{c_mega.dispatches} buckets")
    rd_final = rd.hashes()

    # (d) apply_rounds on the pure-Python encoder
    py = ResidentRowsDocSet(ids, device=dev, native=False)
    py.apply_rounds([heavy])
    py.hashes()
    py_walls = []
    for rnd in storm:
        t = time.perf_counter()
        py.apply_rounds([rnd])
        py_walls.append(time.perf_counter() - t)
    py_final = py.hashes()

    for name, got in (("micro-batch", mb_final), ("apply_rounds", rd_final),
                      ("apply_rounds native=False", py_final)):
        check((got[:n] == final).all(), f"map storm: {name} != frames")
    print(f"phase 2: {n} docs n_pad={ds.n_pad} dims={ds.dims()} "
          f"buffer_bytes={ds.rows_host.nbytes} "
          f"dirty_per_round={[len(r) for r in storm]}; frames encoded "
          f"outside the timed window in {encode_s:.4f} s [{card()}]")
    print(f"phase 2: (a) heavy round + read {heavy_s:.4f} s; "
          f"apply_round_frames, one frame a call + hashes(): storm round "
          f"walls s {walls_text(walls)}; rounds batched "
          f"{moved['rows_rounds_batched']}, fallback "
          f"{moved['rows_rounds_fallback']}; launches {launches}; no frame "
          f"round planned [{card()}]")
    print(f"phase 2: (a) host legs a round: {legs_text(per_round)}")
    print(f"phase 2: (b) one {len(frames)}-frame micro-batch {mb_s:.4f} s "
          f"({mb_s / len(frames):.4f} s a round) + readback {mb_read_s:.4f}"
          f" s; rounds batched {mb_moved['rows_rounds_batched']}, fallback "
          f"{mb_moved['rows_rounds_fallback']}")
    print(f"phase 2: (c) apply_rounds (native) storm round walls s "
          f"{walls_text(r_walls)}")
    print(f"phase 2: (c) host legs a round: {legs_text(r_legs)}")
    print(f"phase 2: (c) minority hashes_for of {len(want)} docs, "
          f"{MINORITY_REPS} reads each way in turns: route on s "
          f"{walls_text(on_s)} ({plans_text(minority_plans)}; "
          f"{c_mega.text()}; launches {minority_launches}), off s "
          f"{walls_text(off_s)}; equal [{card()}]")
    check_routes("phase 2: (c) minority read", on_s, off_s)
    print(f"phase 2: (d) apply_rounds native=False storm round walls s "
          f"{walls_text(py_walls)}; final hashes of (a)-(d) equal")
    return (ds, final, launches + minority_launches, rd, rd_final, c_mega)


def drive_text_fleet(torch, dev):
    """Phase 3: concurrent text editing, so the list half runs: the
    main path through apply_round_frames (a frame a call, each read
    back), then apply_rounds with the native and the Python encoder."""
    from automerge_tpu_torch.engine import cuda_kernels as ck
    from automerge_tpu_torch.engine import resident_rows as rr
    from automerge_tpu_torch.engine.pack import rows_dims_eligible
    from automerge_tpu_torch.engine.resident_rows import ResidentRowsDocSet
    from automerge_tpu_torch.sync.frames import encode_round_frame
    from automerge_tpu_torch.workloads import text_fleet

    ids, rounds = text_fleet()
    frames = [encode_round_frame(r) for r in rounds]
    ds = ResidentRowsDocSet(ids, device=dev)
    ck.LAUNCHES["reconcile_rows_hash"] = 0
    t0 = time.perf_counter()
    ds.hashes()                      # startup read: full-buffer branch
    t1 = time.perf_counter()
    before = dict(rr.ROUNDS)
    with recorded_plans() as frame_plans:
        final, walls, per_round = frame_rounds(ds, frames)
    launches = ck.LAUNCHES["reconcile_rows_hash"]
    moved = {k: rr.ROUNDS[k] - before[k] for k in before}
    check(rows_dims_eligible(*ds.dims()[:3]), "text dims off the envelope")
    check(not frame_plans, "text fleet frames: a frame round was planned")

    walls_by = {}
    for native in (True, False):
        other = ResidentRowsDocSet(ids, device=dev, native=native)
        spec = ROUNDS_LEGS if native else {}
        per, wall, r_legs = timed_calls(
            other, spec, [lambda e: e.apply_rounds(rounds)])
        walls_by[native] = wall[0]
        if native:
            native_legs = r_legs
        check((per[-1] == final).all(),
              f"text fleet: apply_rounds native={native} != frames")
        check((other.hashes() == final).all(), "last round != hashes()")
    print(f"phase 3: {len(ids)} docs dims={ds.dims()} "
          f"buffer_bytes={ds.rows_host.nbytes} startup read "
          f"{t1 - t0:.4f} s; apply_round_frames, a frame a call + hashes(),"
          f" round walls s {walls_text(walls)}, all {sum(walls):.4f} s; "
          f"rounds batched {moved['rows_rounds_batched']}, fallback "
          f"{moved['rows_rounds_fallback']}; launches {launches} "
          f"[{card()}]")
    print(f"phase 3: host legs a round: {legs_text(per_round)}")
    print(f"phase 3: apply_rounds of {len(rounds)} rounds: native "
          f"{walls_by[True]:.4f} s, native=False {walls_by[False]:.4f} s; "
          f"hashes of all three routes equal")
    print(f"phase 3: apply_rounds (native) host legs of the call: "
          f"{legs_text(native_legs)}")
    return ds, final, launches


def hold_to_plain(ds, final, name, report, phase="4"):
    """Phase 4 for one path: the device buffer equals the host mirror, and
    on that buffer the kernel's wrapper, its plain version and the engine's
    final hashes agree bit for bit."""
    import torch
    from automerge_tpu_torch.engine import cuda_kernels as ck
    check(torch.equal(ds.rows_dev.cpu(), torch.from_numpy(ds.rows_host)),
          f"{name}: device buffer != host mirror")
    n = len(final)
    plain = ck.hashes_to_numpy(
        ck.reconcile_rows_hash_plain(ds.rows_dev, ds.dims()))[:n]
    kernel = ck.hashes_to_numpy(
        ck.reconcile_rows_hash(ds.rows_dev, ds.dims()))[:n]
    err = max(max_abs_err(final, plain), max_abs_err(kernel, plain))
    report["reconcile_rows_hash"].append(err)
    check(err == 0, f"{name}: engine or kernel hashes != plain version")
    print(f"phase {phase}: {name}: {n} engine and kernel hashes equal to "
          f"the plain version")


def phase_reference(dev):
    import numpy as np
    from automerge_tpu_torch.engine.cuda_kernels import hashes_to_numpy
    from automerge_tpu_torch.engine.resident_rows import ResidentRowsDocSet
    from automerge_tpu_torch.sync.frames import encode_round_frame
    from automerge_tpu_torch.workloads import reference_streams

    path = (Path(__file__).resolve().parent / "automerge_tpu_torch"
            / "testdata" / "reference_hashes.npz")
    committed = np.load(path)
    for name, ids, batches in reference_streams():
        ds = ResidentRowsDocSet(ids, device=dev)
        for batch in batches:
            ds.apply_rounds(batch)
        got = ds.hashes()
        check((got == committed[name]).all(), f"{name}: != reference")
        # the same streams as round frames, a micro-batch a call
        fr = ResidentRowsDocSet(ids, device=dev)
        for batch in batches:
            h = fr.apply_round_frames([encode_round_frame(r) for r in batch])
        check((hashes_to_numpy(h)[:len(ids)] == committed[name]).all(),
              f"{name}: apply_round_frames != reference")
        print(f"phase 5: {name}: {len(got)} hashes of apply_rounds and of "
              f"apply_round_frames equal to the reference's")


def phase_docs_reference(dev):
    """Phase 5 for the docs-major engine: the committed reference hashes."""
    import numpy as np
    from automerge_tpu_torch.engine.resident import ResidentDocSet
    from automerge_tpu_torch.sync.frames import decode_frame, encode_frame
    from automerge_tpu_torch.workloads import reference_docs_streams

    committed = np.load(Path(__file__).resolve().parent
                        / "automerge_tpu_torch" / "testdata"
                        / "reference_hashes.npz")
    for name, ids, rounds in reference_docs_streams():
        ds = ResidentDocSet(ids, device=dev)
        for rnd in rounds:
            ds.apply_and_reconcile(rnd)
        got = ds.hashes()
        check((got == committed[f"docs_{name}"]).all(),
              f"docs-major {name}: != reference")
        cols = ResidentDocSet(ids, device=dev)
        for rnd in rounds:
            cols.apply_and_reconcile_columns(
                {d: decode_frame(encode_frame(c)) for d, c in rnd.items()})
        check((cols.hashes() == committed[f"docs_{name}"]).all(),
              f"docs-major {name}: apply_and_reconcile_columns != reference")
        print(f"phase 5: docs-major {name}: {len(got)} hashes of "
              f"apply_and_reconcile and of apply_and_reconcile_columns "
              f"equal to the reference's")


def drive_text_plane(torch, dev, report):
    """Phase 6: both text-merge workloads through the router. Returns
    {workload: (device spans, order)} for the timings and the launches of
    the plane's kernel on this path."""
    from automerge_tpu_torch.engine import cuda_kernels as ck
    from automerge_tpu_torch.engine.dispatch import (merge_spans_adaptive,
                                                     result_to_numpy)
    from automerge_tpu_torch.engine.pack import pack_spans
    from automerge_tpu_torch.engine.span_kernels import (merge_spans,
                                                         merge_spans_host)
    from automerge_tpu_torch.workloads import span_bulk_merge, span_fleet

    t0 = time.perf_counter()
    workloads = {"bulk merge": span_bulk_merge(),
                 "span fleet": span_fleet()}
    print(f"phase 6: generated both span workloads in "
          f"{time.perf_counter() - t0:.2f} s")
    inputs, launches = {}, 0
    for name, (tables, expected) in workloads.items():
        ck.LAUNCHES["span_rank_hash"] = 0
        t0 = time.perf_counter()
        plan, out = merge_spans_adaptive(tables, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = ck.LAUNCHES["span_rank_hash"]
        launches += n
        check(plan.backend == "device", f"{name}: the plan chose the host "
              f"({plan})")
        check(n == 1, f"{name}: span_rank_hash launched {n} times")
        got = result_to_numpy(out)
        spans = pack_spans(tables)
        t0 = time.perf_counter()
        host = merge_spans_host(spans)
        host_wall = time.perf_counter() - t0
        plain = result_to_numpy(merge_spans(torch.from_numpy(spans)))
        hold_equal(got, plain, f"{name} vs plain", report["span_rank_hash"])
        hold_equal(got, host, f"{name} vs numpy", report["span_rank_hash"])
        check(got["total"].tolist() == list(expected),
              f"{name}: totals != the generator's visible lengths")
        spans_dev = torch.from_numpy(spans).to(dev)
        inputs[name] = (spans_dev, torch.from_numpy(got["order"]).to(dev))
        # the routed wall's legs, after the counted run
        pack_s = host_s(lambda: pack_spans(tables), 3)
        copy_s = host_s(lambda: (torch.from_numpy(spans).to(dev),
                                 torch.cuda.synchronize()), 5)
        merge_s = host_s(lambda: (merge_spans(spans_dev),
                                  torch.cuda.synchronize()), 5)
        split = merge_split(torch, spans_dev)
        rows = [len(t) for t in tables]
        print(f"phase 6: {name}: {len(tables)} docs, spans per doc "
              f"{min(rows)}-{max(rows)}, lanes {tuple(spans.shape)}; plan "
              f"{plan.backend} (est device {plan.est_device_s * 1e3:.4f} ms, "
              f"host {plan.est_host_s * 1e3:.4f} ms); routed wall "
              f"{wall * 1e3:.3f} ms (pack {pack_s * 1e3:.3f} ms, copy "
              f"{copy_s * 1e3:.3f} ms, merge_spans on the card "
              f"{merge_s * 1e3:.3f} ms), numpy oracle after the pack "
              f"{host_wall * 1e3:.3f} ms; launches {n}; visible length total "
              f"{int(got['total'].astype('int64').sum())}; order, start, "
              f"total, hash equal to the plain version and the oracle")
        print(f"phase 6: {name}: merge_spans on the card by CUDA events "
              f"(ms per call, host enqueue ms and CUDA-graph ms in "
              f"brackets): "
              + "; ".join(f"{k} {v[0]:.4f} [{v[1]:.4f}, graph {v[2]:.4f}]"
                          for k, v in split.items()))
    return inputs, launches


def merge_split(torch, spans):
    """merge_spans in its three steps, each timed by CUDA events around 10
    calls (cuda_ms) and as a CUDA-graph replay of them (graph_ms, the
    device alone), on the same lanes: the four stable sorts
    (merge_order), the rank+hash kernel through the order, and the glue
    (slot_starts: the masked lanes' gathers, cummax and scatter_), then
    the whole call. {step: (ms, host enqueue ms, graph ms)}."""
    from automerge_tpu_torch.engine.span_kernels import (
        merge_order, merge_spans, slot_starts, span_rank_hash)
    order, mask = merge_order(spans)
    order32 = order.to(torch.int32)
    starts_o = span_rank_hash(spans, order32)[0]
    steps = {"sorts": lambda: merge_order(spans),
             "kernel": lambda: span_rank_hash(spans, order32),
             "glue": lambda: slot_starts(spans, mask, order, starts_o),
             "whole merge_spans": lambda: merge_spans(spans)}
    out = {}
    for k, fn in steps.items():
        enq = []
        out[k] = (cuda_ms(fn, 10, enq), enq[0], graph_ms(fn, 10))
    return out


def drive_move_plane(torch, dev, report):
    """Phase 7: the storm realm and the realm fleet through the router.
    Returns {workload: (device nodes, cands, the kernel's schedule from
    its CPU model)} and the launches of the plane's kernel on this
    path."""
    from automerge_tpu_torch.core.moves import _resolve_walk
    from automerge_tpu_torch.engine import cuda_kernels as ck
    from automerge_tpu_torch.engine.dispatch import (resolve_moves_adaptive,
                                                     result_to_numpy)
    from automerge_tpu_torch.engine.move_kernels import (
        resolve_moves, resolve_moves_host, resolve_moves_plain)
    from automerge_tpu_torch.engine.pack import pack_moves
    from automerge_tpu_torch.move_schedule import schedule_model
    from automerge_tpu_torch.workloads import move_fleet, move_storm

    t0 = time.perf_counter()
    storm = move_storm()
    workloads = {"storm realm": [storm], "realm fleet": move_fleet()}
    packed = {k: pack_moves(v) for k, v in workloads.items()}
    print(f"phase 7: built and packed both move workloads in "
          f"{time.perf_counter() - t0:.2f} s")
    inputs, launches = {}, 0
    for name, pk in packed.items():
        ck.LAUNCHES["resolve_moves"] = 0
        t0 = time.perf_counter()
        plan, out = resolve_moves_adaptive(pk, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = ck.LAUNCHES["resolve_moves"]
        launches += n
        check(plan.backend == "device", f"{name}: the plan chose the host "
              f"({plan})")
        check(n == 1, f"{name}: resolve_moves launched {n} times")
        got = result_to_numpy(out)
        nodes = torch.from_numpy(pk["nodes"]).to(dev)
        cands = torch.from_numpy(pk["cands"]).to(dev)
        t0 = time.perf_counter()
        host = resolve_moves_host(pk)
        host_wall = time.perf_counter() - t0
        plain = result_to_numpy(resolve_moves_plain(nodes, cands))
        hold_equal(got, plain, f"{name} vs plain", report["resolve_moves"])
        hold_equal(got, host, f"{name} vs numpy", report["resolve_moves"])
        if name == "storm realm":
            walk_ptr, walk_dropped = _resolve_walk(storm)
            check(got["ptr"][0][:len(storm.nodes)].tolist() == walk_ptr
                  and int(got["dropped"][0]) == walk_dropped,
                  "storm realm != the host walk")
        t0 = time.perf_counter()
        sched = schedule_model(pk["nodes"], pk["cands"])
        model_s = time.perf_counter() - t0
        hold_equal({k: sched[k] for k in host}, host,
                   f"{name}: schedule model vs numpy", report["resolve_moves"])
        inputs[name] = (nodes, cands, sched)
        pack_s = host_s(lambda: pack_moves(workloads[name]), 1)
        resolve_s = host_s(lambda: (resolve_moves(nodes, cands),
                                    torch.cuda.synchronize()), 5)
        print(f"phase 7: {name}: {len(workloads[name])} realms, lanes "
              f"nodes {tuple(pk['nodes'].shape)} cands "
              f"{tuple(pk['cands'].shape)}; plan {plan.backend} (est device "
              f"{plan.est_device_s * 1e3:.4f} ms, host "
              f"{plan.est_host_s * 1e3:.4f} ms); routed wall from packed "
              f"lanes {wall * 1e3:.3f} ms (resolve_moves on the card "
              f"{resolve_s * 1e3:.3f} ms; pack_moves before it "
              f"{pack_s * 1e3:.3f} ms), numpy oracle {host_wall * 1e3:.3f} ms; "
              f"launches {n}; cycle drops {int(got['dropped'].sum())} "
              f"(most in one realm {int(got['dropped'].max())}), "
              f"unresolved nodes "
              f"{int((pk['nodes'][:, 0] > 0).sum() - got['resolved'].sum())}"
              f"; ptr, parent, resolved, dropped, hash equal to the plain "
              f"version, the oracle and the kernel's schedule model ("
              f"{model_s:.2f} s)"
              + ("" if name != "storm realm" else " and the host walk"))
    return inputs, launches


def phase_plane_reference(torch, dev, report):
    """Phase 5 for the batched planes: the committed reference outputs."""
    import numpy as np
    from automerge_tpu_torch.engine.dispatch import result_to_numpy
    from automerge_tpu_torch.engine.move_kernels import resolve_moves
    from automerge_tpu_torch.engine.pack import pack_moves, pack_spans
    from automerge_tpu_torch.engine.span_kernels import merge_spans
    from automerge_tpu_torch.workloads import (reference_move_problems,
                                               reference_span_tables)

    committed = np.load(Path(__file__).resolve().parent
                        / "automerge_tpu_torch" / "testdata"
                        / "reference_hashes.npz")
    spans = torch.from_numpy(pack_spans(reference_span_tables())).to(dev)
    got = result_to_numpy(merge_spans(spans))
    hold_equal(got, {k: committed[f"spans_{k}"] for k in got},
               "span tables vs reference", report["span_rank_hash"])
    packed = pack_moves(reference_move_problems())
    got = result_to_numpy(resolve_moves(
        torch.from_numpy(packed["nodes"]).to(dev),
        torch.from_numpy(packed["cands"]).to(dev)))
    hold_equal(got, {k: committed[f"moves_{k}"] for k in got},
               "move realms vs reference", report["resolve_moves"])
    print(f"phase 5: {spans.shape[0]} span tables and "
          f"{packed['nodes'].shape[0]} move realms equal to the reference's")


def hold_dominated_to_plain(ds, what, report, check_survivor):
    """The domination kernel on the engine's final state (the launch
    apply_doc makes there) equals the plain version bit for bit; with
    `check_survivor`, the engine's last apply_doc output kept exactly the
    live assign ops the plain flags leave undominated."""
    from automerge_tpu_torch.engine import cuda_kernels as ck
    from automerge_tpu_torch.engine.kernels import domination_inputs
    s = ds.state
    args = domination_inputs(s["op_mask"], s["action"], s["fid"], s["actor"],
                             s["seq"], s["change_idx"], s["clock"])
    plain = ck.dominated_plain(*args)
    hold_equal({"flags": ck.dominated(*args).cpu().numpy()},
               {"flags": plain.cpu().numpy()},
               f"{what}: dominated vs plain", report["dominated"])
    if check_survivor:
        hold_equal({"survivor": ds._out["survivor"].cpu().numpy()},
                   {"survivor": (args[-1] & ~plain).cpu().numpy()},
                   f"{what}: apply_doc survivors vs plain flags",
                   report["dominated"])


@contextlib.contextmanager
def gen2_timer():
    """Yields a list that collects the seconds of each generation-2
    garbage collection while the block runs."""
    import gc
    spans, start = [], []

    def cb(phase, info):
        if info["generation"] != 2:
            return
        if phase == "start":
            start.append(time.perf_counter())
        elif start:
            spans.append(time.perf_counter() - start.pop())
    gc.callbacks.append(cb)
    try:
        yield spans
    finally:
        gc.callbacks.remove(cb)


def column_rounds(ds, frames_by_round):
    """Each round's per-doc AMW1 frames decoded and applied through
    apply_and_reconcile_columns, its host legs timed. Returns each round's
    hashes, the decode seconds, the apply walls and the legs a round."""
    from automerge_tpu_torch.sync.frames import decode_frame
    legs = time_legs(ds, COLUMN_LEGS)
    hashes, decode_s, walls, per_round = [], [], [], []
    for frames in frames_by_round:
        for k in legs:
            legs[k] = 0.0
        t0 = time.perf_counter()
        cols = {d: decode_frame(f) for d, f in frames.items()}
        t1 = time.perf_counter()
        hashes.append(ds.apply_and_reconcile_columns(cols))
        walls.append(time.perf_counter() - t1)
        decode_s.append(t1 - t0)
        per_round.append({"decode": t1 - t0, **legs,
                          "other": walls[-1] - sum(legs.values())})
    return hashes, decode_s, walls, per_round


def drive_docs_major(torch, dev, report, text_final):
    """Phase 9: the docs-major engine. Returns the docset fleet's and the
    text fleet's engines (their states feed the kernel timings) and the
    launches of the domination kernel on this path."""
    import numpy as np
    from automerge_tpu_torch.engine import cuda_kernels as ck
    from automerge_tpu_torch.engine.batchdoc import apply_batch
    from automerge_tpu_torch.engine.resident import ResidentDocSet
    from automerge_tpu_torch.sync.frames import encode_frame
    from automerge_tpu_torch.workloads import docset_fleet, text_fleet

    t0 = time.perf_counter()
    ids, initial, rounds = docset_fleet(rounds=13)
    tids, trounds = text_fleet()
    print(f"phase 9: generated the docset fleet ({len(ids)} docs, "
          f"{len(rounds) - 1} rounds + 1 of {len(rounds[0])} docs) and the "
          f"text fleet ({len(tids)} docs) in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    docset_frames = [{d: encode_frame(c) for d, c in rnd.items()}
                     for rnd in [initial] + rounds[:12]]
    text_frames = [{d: encode_frame(c) for d, c in rnd.items()}
                   for rnd in trounds]
    print(f"phase 9: encoded the per-doc AMW1 frames of both fleets outside "
          f"the timed window in {time.perf_counter() - t0:.2f} s")
    ck.LAUNCHES["dominated"] = 0
    ck.LAUNCHES["linearize"] = 0

    # (a) the docset fleet
    ds = ResidentDocSet(ids, device=dev)
    t0 = time.perf_counter()
    ds.apply_and_reconcile(initial)
    initial_s = time.perf_counter() - t0
    walls, gc_s = [], []
    with gen2_timer() as gen2:
        for rnd in rounds[:12]:
            t = time.perf_counter()
            before = sum(gen2)
            round12 = ds.apply_and_reconcile(rnd)
            walls.append(time.perf_counter() - t)
            gc_s.append(sum(gen2) - before)
    t = time.perf_counter()
    ds.apply_changes(rounds[12])
    apply_s = time.perf_counter() - t
    minority = [ds.doc_index[d] for d in list(rounds[12])[:100]] + [
        i for i in range(len(ids)) if ids[i] not in rounds[12]][:10]
    t = time.perf_counter()
    got = ds.hashes_for(minority)
    read_s = time.perf_counter() - t
    docset_final = ds.hashes()
    check((got == docset_final[minority]).all(),
          "docset fleet: hashes_for != hashes()")
    docset_bytes = ds.resident_bytes()

    # (a') the docset fleet's rounds as per-doc columns decoded from frames
    before = ck.LAUNCHES["dominated"]
    cds = ResidentDocSet(ids, device=dev)
    c_hashes, c_decode, c_walls, c_legs = column_rounds(cds, docset_frames)
    cols12 = c_hashes[-1]
    col_launches = ck.LAUNCHES["dominated"] - before

    # (b) the text fleet, same streams as phase 3
    tds = ResidentDocSet(tids, device=dev)
    t0 = time.perf_counter()
    for rnd in trounds:
        tds.apply_and_reconcile(rnd)
    text_s = time.perf_counter() - t0
    text_hashes = tds.hashes()

    # (b') the text fleet as columns
    before = ck.LAUNCHES["dominated"]
    tcs = ResidentDocSet(tids, device=dev)
    t_hashes, t_decode, t_walls, t_legs = column_rounds(tcs, text_frames)
    tcols = t_hashes[-1]
    col_launches += ck.LAUNCHES["dominated"] - before

    # (c) apply_batch of the text fleet's whole change sets
    per_doc = {d: [] for d in tids}
    for rnd in trounds:
        for d, chs in rnd.items():
            per_doc[d].extend(chs)
    t0 = time.perf_counter()
    _, _, out = apply_batch([per_doc[d] for d in tids], device=dev)
    batch_hashes = ck.hashes_to_numpy(out["hash"])
    batch_s = time.perf_counter() - t0
    launches = ck.LAUNCHES["dominated"]
    lin_launches = ck.LAUNCHES["linearize"]

    check(launches > 0, "the docs-major path skipped the domination kernel")
    check(lin_launches > 0, "the docs-major path skipped the linearize kernel")
    check(col_launches == len(docset_frames) + len(text_frames),
          f"the column routes launched the domination kernel "
          f"{col_launches} times, not once a round")
    check((text_hashes == text_final).all(),
          "text fleet: docs-major hashes != the rows engine's")
    check((batch_hashes == text_hashes).all(),
          "text fleet: apply_batch != ResidentDocSet")
    check((cols12 == round12).all(),
          "docset fleet: apply_and_reconcile_columns != apply_and_reconcile")
    check((tcols == text_hashes).all(),
          "text fleet: apply_and_reconcile_columns != apply_and_reconcile")
    # checks after the count: their launches are not the path's
    # the pure-Python encoder on both fleets
    py = ResidentDocSet(ids, device=dev, native=False)
    py.apply_and_reconcile(initial)
    py_walls = []
    for rnd in rounds[:12]:
        t = time.perf_counter()
        py_last = py.apply_and_reconcile(rnd)
        py_walls.append(time.perf_counter() - t)
    check((py_last == round12).all(),
          "docset fleet: native=False != the native encoder")
    tpy = ResidentDocSet(tids, device=dev, native=False)
    t0 = time.perf_counter()
    for rnd in trounds:
        tpy_last = tpy.apply_and_reconcile(rnd)
    tpy_s = time.perf_counter() - t0
    check((tpy_last == text_hashes).all(),
          "text fleet: native=False != the native encoder")
    # the docset fleet from scratch
    per_doc = {d: list(initial[d]) for d in ids}
    for rnd in rounds:
        for d, chs in rnd.items():
            per_doc[d].extend(chs)
    _, _, out = apply_batch([per_doc[d] for d in ids], device=dev)
    check((ck.hashes_to_numpy(out["hash"]) == docset_final).all(),
          "docset fleet: ResidentDocSet != apply_batch from scratch")
    hold_dominated_to_plain(ds, "docset fleet", report, False)
    hold_dominated_to_plain(tds, "text fleet", report, True)

    print(f"phase 9: (a) docset fleet: {len(ids)} docs caps ops="
          f"{ds.cap_ops} changes={ds.cap_changes} actors={ds.cap_actors} "
          f"fids={ds.cap_fids}; initial apply_and_reconcile {initial_s:.4f} "
          f"s; round walls s {walls_text(walls)}; gen-2 garbage collection "
          f"inside each round s {[round(g, 4) for g in gc_s]}; apply_changes of "
          f"{len(rounds[12])} docs {apply_s:.4f} s; hashes_for of "
          f"{len(minority)} docs {read_s:.4f} s; resident_bytes "
          f"{docset_bytes}; equal to apply_batch from scratch")
    print(f"phase 9: (a) apply_and_reconcile_columns: initial "
          f"{c_walls[0]:.4f} s (decode {c_decode[0]:.4f}); round walls s "
          f"{walls_text(c_walls[1:])}, decode p50 {p50(c_decode[1:]):.4f} "
          f"s; native=False apply_and_reconcile round walls s "
          f"{walls_text(py_walls)}; hashes of the three routes equal")
    print(f"phase 9: (a) apply_and_reconcile_columns host legs a round "
          f"(after the initial one): {legs_text(c_legs[1:])}")
    print(f"phase 9: (b) text fleet: {len(tids)} docs caps ops="
          f"{tds.cap_ops} changes={tds.cap_changes} lists={tds.cap_lists} "
          f"elems={tds.cap_elems} actors={tds.cap_actors} fids="
          f"{tds.cap_fids}; {len(trounds)} apply_and_reconcile rounds "
          f"{text_s:.4f} s (round p50 {p50(t_walls):.4f} s through "
          f"apply_and_reconcile_columns, {sum(t_walls):.4f} s in all, "
          f"decode {sum(t_decode):.4f} s; native=False {tpy_s:.4f} s); "
          f"resident_bytes {tds.resident_bytes()}; hashes of the three "
          f"routes equal, and to the rows engine's (phase 3)")
    print(f"phase 9: (b) apply_and_reconcile_columns host legs a round: "
          f"{legs_text(t_legs)}")
    print(f"phase 9: (c) apply_batch of the text fleet {batch_s:.4f} s, "
          f"equal to (b); launches of dominated on this path {launches} "
          f"({col_launches} by the column routes), of linearize "
          f"{lin_launches} (apply_batch orders on the host)")
    fleets = {"ids": ids, "docset_frames": docset_frames,
              "docset_hashes": c_hashes, "docset_walls": c_walls,
              "tids": tids, "text_frames": text_frames,
              "text_hashes": t_hashes, "text_walls": t_walls}
    return ds, tds, launches, lin_launches, fleets


# A diff round's legs beyond COLUMN_LEGS' host legs: the module functions
# _apply_flat calls (the dispatch only enqueues; the readback of the
# changed documents' rows waits for the device).
DIFF_LEGS = {"dispatch": "_scatter_apply_diff", "readback": "_changed_rows",
             "decode": "decode_round_diffs"}


@contextlib.contextmanager
def diff_legs():
    """Wrap the resident module's DIFF_LEGS functions for the block;
    yields the dict their host seconds add into."""
    from automerge_tpu_torch.engine import resident
    legs = {leg: 0.0 for leg in DIFF_LEGS}
    saved = {name: getattr(resident, name) for name in DIFF_LEGS.values()}
    for leg, name in DIFF_LEGS.items():
        setattr(resident, name, timed_into(legs, leg, saved[name]))
    try:
        yield legs
    finally:
        for name, fn in saved.items():
            setattr(resident, name, fn)


def diff_rounds(ds, frames_by_round, legs=None):
    """Each round's frames decoded and applied through
    apply_and_reconcile_columns(..., diffs=True). With the dict of
    diff_legs, times each round's legs (COLUMN_LEGS' register,
    admit+encode and stack+copy, and DIFF_LEGS). Returns each round's
    hashes and records, the apply walls and the legs a round."""
    from automerge_tpu_torch.sync.frames import decode_frame
    host = time_legs(ds, {k: COLUMN_LEGS[k] for k in
                          ("register", "admit+encode", "stack+copy")}) \
        if legs is not None else {}
    hashes, records, walls, per_round = [], [], [], []
    for frames in frames_by_round:
        for d in (host, legs or {}):
            for k in d:
                d[k] = 0.0
        cols = {d: decode_frame(f) for d, f in frames.items()}
        t0 = time.perf_counter()
        h, recs = ds.apply_and_reconcile_columns(cols, diffs=True)
        walls.append(time.perf_counter() - t0)
        hashes.append(h)
        records.append(recs)
        split = {**host, **(legs or {})}
        per_round.append({**split, "other": walls[-1] - sum(split.values())})
    return hashes, records, walls, per_round


def hold_diff_fleet(torch, dev, name, ids, frames, phase9_hashes, subset,
                    checked):
    """Phase 10 on one fleet: the rounds through the diff plane on the
    card, each round's hashes held to phase 9's column route, the records
    to a device="cpu" instance over `subset` (records are per document),
    and a MirrorDoc per document folded from every round to materialize
    for the `checked` documents. Returns the walls, legs and records per
    round, the seconds of the checks, and the linearize launches of the
    card's rounds."""
    from automerge_tpu_torch.core.ids import ROOT_ID
    from automerge_tpu_torch.engine import cuda_kernels as ck
    from automerge_tpu_torch.engine.diffs import MirrorDoc
    from automerge_tpu_torch.engine.resident import ResidentDocSet

    ds = ResidentDocSet(ids, device=dev)
    for k in ck.LAUNCHES:
        ck.LAUNCHES[k] = 0
    with diff_legs() as legs:
        hashes, records, walls, per_round = diff_rounds(ds, frames, legs)
    launches = dict(ck.LAUNCHES)
    check(launches["linearize"] == len(frames),
          f"{name}: the diff rounds launched linearize "
          f"{launches['linearize']} times, not once a round")
    t0 = time.perf_counter()
    for k, (h, want) in enumerate(zip(hashes, phase9_hashes)):
        check((h == want).all(), f"{name}: diff round {k} hashes != phase "
              f"9's apply_and_reconcile_columns")
    keep = set(subset)
    cpu = ResidentDocSet(subset, device="cpu")
    _, cpu_records, _, _ = diff_rounds(
        cpu, [{d: f for d, f in rnd.items() if d in keep} for rnd in frames])
    for k, (got, want) in enumerate(zip(records, cpu_records)):
        mine = {d: r for d, r in got.items() if d in keep}
        check(mine == want, f"{name}: diff round {k} records != the CPU's "
              f"on the {len(subset)}-doc subset")
    mirrors = {d: MirrorDoc() for d in ids}
    for recs in records:
        for d, r in recs.items():
            mirrors[d].apply(r)
    for d in checked:
        check(mirrors[d].snapshot(ROOT_ID) == ds.materialize(d),
              f"{name}: MirrorDoc of {d} != materialize")
    return walls, per_round, records, time.perf_counter() - t0, launches


def drive_diff_plane(torch, dev, fleets):
    """Phase 10: the docs-major diff plane at full width (the docset fleet
    and the text fleet through apply_and_reconcile_columns(...,
    diffs=True)), then the committed reference records. Returns the
    linearize launches of the two fleets' diff rounds."""
    import json
    from automerge_tpu_torch.engine.resident import ResidentDocSet
    from automerge_tpu_torch.workloads import reference_diff_streams

    t_phase = time.perf_counter()
    ids, tids = fleets["ids"], fleets["tids"]
    frames = fleets["docset_frames"]
    touched = sorted({d for rnd in frames[1:] for d in rnd})
    others = [d for d in ids if d not in set(touched)][:100]
    d_walls, d_legs, d_recs, d_check_s, d_launch = hold_diff_fleet(
        torch, dev, "docset fleet", ids, frames, fleets["docset_hashes"],
        ids[::10], touched + others)
    t_walls, t_legs, t_recs, t_check_s, t_launch = hold_diff_fleet(
        torch, dev, "text fleet", tids, fleets["text_frames"],
        fleets["text_hashes"], tids[::2], tids)

    committed = json.loads((Path(__file__).resolve().parent
                            / "automerge_tpu_torch" / "testdata"
                            / "reference_diffs.json").read_text())
    n_ref = 0
    for name, rids, rounds in reference_diff_streams():
        ds = ResidentDocSet(rids, device=dev)
        for k, rnd in enumerate(rounds):
            _, recs = ds.apply_and_reconcile(rnd, diffs=True)
            check(json.loads(json.dumps(recs)) == committed[name][k],
                  f"reference records: {name} round {k} differs")
            n_ref += sum(len(r) for r in recs.values())

    def counts(recs):
        return [sum(len(r) for r in rnd.values()) for rnd in recs]
    d_plain = fleets["docset_walls"][1:]
    print(f"phase 10: (a) docset fleet: {len(ids)} docs, "
          f"{len(frames) - 1} diff rounds after the admitting one "
          f"({d_walls[0]:.4f} s); round walls s {walls_text(d_walls[1:])}; "
          f"without diffs (phase 9, same route) p50 {p50(d_plain):.4f} s; "
          f"records a round {counts(d_recs)}; hashes equal to phase 9's, "
          f"records to the CPU's on {len(ids[::10])} docs, MirrorDocs to "
          f"materialize on {len(touched)} touched + {len(others)} untouched "
          f"docs ({d_check_s:.2f} s of checks)")
    print(f"phase 10: (a) diff round legs (after the admitting one): "
          f"{legs_text(d_legs[1:])}; the admitting round's: "
          f"{legs_text(d_legs[:1])}")
    print(f"phase 10: (b) text fleet: {len(tids)} docs, "
          f"{len(t_walls)} diff rounds, walls s {walls_text(t_walls)}; "
          f"without diffs (phase 9, same route) p50 "
          f"{p50(fleets['text_walls']):.4f} s; records a round "
          f"{counts(t_recs)}; hashes equal to phase 9's, records to the "
          f"CPU's on {len(tids[::2])} docs, MirrorDocs to materialize on "
          f"all {len(tids)} docs ({t_check_s:.2f} s of checks)")
    print(f"phase 10: (b) diff round legs: {legs_text(t_legs)}")
    print(f"phase 10: (c) {n_ref} reference records of "
          f"{len(reference_diff_streams())} small streams (map and list "
          f"moves) equal to the committed ones")
    nonzero = [{k: v for k, v in lc.items() if v}
               for lc in (d_launch, t_launch)]
    print(f"phase 10: launches on the diff rounds (a) {nonzero[0]} (b) "
          f"{nonzero[1]}; phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return d_launch["linearize"] + t_launch["linearize"]


# Phase 11's long-lived fleet: bench config 15's corpus (1,024 docs, 4
# writers, 64 fields) with its depth cut from 10,000 changes a doc to
# LONG_ROUNDS x LONG_PER_ROUND, delivered as micro-batches of round frames
# (one change a doc a frame); the snapshot covers all but the last
# LONG_TAIL changes of each doc.
LONG_DOCS = 1024
LONG_ROUNDS = 10
LONG_PER_ROUND = 256
LONG_TAIL = 50


def b1_launches(torch, dev, fn):
    """fn() and the reconcile kernel's launches in it: the counter set to
    0 just before, read just after."""
    from automerge_tpu_torch.engine import cuda_kernels as ck
    ck.LAUNCHES["reconcile_rows_hash"] = 0
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out, ck.LAUNCHES["reconcile_rows_hash"]


def long_lived_rounds(torch, ds, ids, per_round: int, rounds: int,
                      archive_floor):
    """Phase 11 (a) and (b): each round a micro-batch of `per_round` round
    frames through apply_round_frames and a hashes() read, under the sync
    service's rule (on RowsBudgetError: compact every doc to its causal
    floor, retry once); after each round, the horizon pass
    (archive_log_prefix of every doc at its floor). Returns the walls,
    the compaction stats and the launches."""
    from automerge_tpu_torch.engine.compaction import causal_floor
    from automerge_tpu_torch.engine.resident_rows import RowsBudgetError
    from automerge_tpu_torch.sync.frames import decode_round_frame
    from automerge_tpu_torch.workloads import long_lived_frame

    out = {"walls": [], "compacted": [], "compact_s": [], "ops": [],
           "bytes": [], "archive_s": [], "ram_log": [], "launches": 0,
           "final": None}
    for r in range(rounds):
        frames = [decode_round_frame(long_lived_frame(ids, s))
                  for s in range(r * per_round + 1, (r + 1) * per_round + 1)]

        def one_round():
            compacted = False
            t0 = time.perf_counter()
            try:
                ds.apply_round_frames(frames)
            except RowsBudgetError:
                ops0 = int(ds.op_count[:len(ids)].sum())
                bytes0 = ds.resident_bytes()
                tc = time.perf_counter()
                floors = {d: causal_floor(ds, i) for i, d in enumerate(ids)}
                stats = ds.compact(floors)
                out["compact_s"].append(time.perf_counter() - tc)
                check(any(st["ops_after"] < st["ops_before"]
                          for st in stats.values()),
                      "long-lived fleet: compaction reclaimed nothing")
                out["ops"].append((ops0, int(ds.op_count[:len(ids)].sum())))
                out["bytes"].append((bytes0, ds.resident_bytes()))
                compacted = True
                ds.apply_round_frames(frames)
            final = ds.hashes()
            return final, compacted, time.perf_counter() - t0
        (final, compacted, wall), n = b1_launches(torch, ds.device,
                                                  one_round)
        out["launches"] += n
        out["walls"].append(wall)
        out["compacted"].append(compacted)
        out["final"] = final
        t0 = time.perf_counter()
        for i, d in enumerate(ids):
            ds.archive_log_prefix(d, archive_floor(ds, i))
        out["archive_s"].append(time.perf_counter() - t0)
        out["ram_log"].append(sum(len(log) for log in ds.change_log))
    return out


def drive_long_lived(torch, dev, report, n_docs=LONG_DOCS,
                     rounds=LONG_ROUNDS, per_round=LONG_PER_ROUND,
                     tail=LONG_TAIL, text_docs=2048):
    """Phase 11: rows-engine durability on the card. Returns the reconcile
    kernel's launches on the phase's main path (hold_to_plain's own
    launches are not counted), and what phase 12 (e) reads of the
    long-lived fleet: the engine after its rebuild, the snapshot store,
    and the directory that holds them (the caller removes it)."""
    import shutil
    import tempfile

    import numpy as np
    from automerge_tpu_torch.engine.compaction import causal_floor
    from automerge_tpu_torch.engine.resident_rows import (
        CompactionAnchorError, ResidentRowsDocSet)
    from automerge_tpu_torch.sync.frames import encode_round_frame
    from automerge_tpu_torch.sync.logarchive import LogArchive
    from automerge_tpu_torch.sync.snapshots import (SnapshotStore,
                                                    compact_prefix)
    from automerge_tpu_torch.workloads import (LONG_LIVED_WRITERS,
                                               long_lived_changes, text_fleet,
                                               text_fleet_acks)

    t_phase = time.perf_counter()
    ids = [f"doc{j:04d}" for j in range(n_docs)]
    writers = [f"w{k:02d}" for k in range(LONG_LIVED_WRITERS)]
    depth = rounds * per_round
    root = tempfile.mkdtemp(prefix="amtpu-smoke-long-")
    launches = 0
    keep = None
    try:
        archive = LogArchive(os.path.join(root, "arch"))
        store = SnapshotStore(os.path.join(root, "snap"))
        ds = ResidentRowsDocSet(ids, actors=writers, device=dev)
        ds.log_archive = archive
        # (a) + (b)
        run = long_lived_rounds(torch, ds, ids, per_round, rounds,
                                causal_floor)
        launches += run["launches"]
        final = run["final"]
        hold_to_plain(ds, final, "(a) long-lived fleet after its rounds",
                      report, "11")
        w_c = [w for w, c in zip(run["walls"], run["compacted"]) if c]
        w_n = [w for w, c in zip(run["walls"], run["compacted"]) if not c]
        check(w_c, "long-lived fleet: no round compacted")
        print(f"phase 11: (a) {n_docs} docs x {depth} changes ({rounds} "
              f"micro-batches of {per_round} round frames, "
              f"{n_docs * per_round} changes each) dims={ds.dims()}; "
              f"round walls s {walls_text(run['walls'])}; p50 with a "
              f"compaction {p50(w_c):.4f} s ({len(w_c)} rounds), without "
              f"{p50(w_n) if w_n else float('nan'):.4f} s ({len(w_n)}); "
              f"compaction walls s {walls_text(run['compact_s'])}, "
              f"{1e3 * p50(run['compact_s']) / n_docs:.4f} ms a doc; ops "
              f"before/after {run['ops']}; resident bytes before/after "
              f"{run['bytes']}; launches {run['launches']} [{card()}]")
        print(f"phase 11: (b) archive_log_prefix of every doc a round: "
              f"append walls s {walls_text(run['archive_s'])}; RAM log "
              f"length after each round {run['ram_log']}; archive "
              f"{sum(archive.stats(d)['bytes'] for d in ids)} B")

        # (c) rebuild from the log (archive + RAM tail), chunked
        t0 = time.perf_counter()
        _, n = b1_launches(torch, dev, ds._rebuild_from_log)
        rebuilt = ds.hashes()
        rebuild_s = time.perf_counter() - t0
        launches += n
        check(ds.device == dev and ds.rows_dev is not None
              and ds.rows_dev.device.type == dev.type,
              "long-lived fleet: the rebuild left the card")
        check((rebuilt == final).all(),
              "long-lived fleet: hashes after the rebuild != before")
        hold_to_plain(ds, rebuilt, "(c) long-lived fleet after the rebuild",
                      report, "11")
        print(f"phase 11: (c) _rebuild_from_log (archive read + chunked "
              f"replay of {n_docs * depth} changes) {rebuild_s:.3f} s, "
              f"launches {n}; hashes equal to the long-lived engine's "
              f"[{card()}]")

        # (d) snapshot boot
        cut = depth - tail
        t0 = time.perf_counter()
        per_writer = [long_lived_changes(k, 1, cut)
                      for k in range(LONG_LIVED_WRITERS)]
        for j, d in enumerate(ids):
            store.write(d, compact_prefix(per_writer[j % len(per_writer)]))
        write_s = time.perf_counter() - t0
        tail_frame = encode_round_frame(
            {d: long_lived_changes(j, cut + 1, depth)
             for j, d in enumerate(ids)})
        boot = ResidentRowsDocSet(ids, actors=writers, device=dev)

        def do_boot():
            images = {d: store.load(d) for d in ids}
            boot.apply_rounds([{d: img.columns().to_changes()
                                for d, img in images.items()}])
            for d, img in images.items():
                boot.seed_clock(d, img.clock, img.heads)
            boot.apply_round_frames([tail_frame])
            return boot.hashes()
        t0 = time.perf_counter()
        booted, n = b1_launches(torch, dev, do_boot)
        boot_s = time.perf_counter() - t0
        launches += n
        check((booted == final).all(),
              "long-lived fleet: snapshot boot != long-lived engine")
        hold_to_plain(boot, booted, "(d) long-lived fleet after a snapshot "
                      "boot", report, "11")
        snap_b = sum(len(store.payload(d)) for d in ids)
        arch_b = sum(archive.stats(d)["bytes"] for d in ids)
        check(snap_b < arch_b, "snapshot bytes not below the archive's")
        print(f"phase 11: (d) snapshot writes of {cut} changes a doc "
              f"{write_s:.3f} s; boot (apply_rounds of every image, "
              f"seed_clock, the {tail}-change tail as one frame) "
              f"{boot_s:.3f} s, {1e3 * boot_s / n_docs:.4f} ms a doc, "
              f"launches {n}; snapshot {snap_b} B against archive "
              f"{arch_b} B ({snap_b / arch_b:.5f}); hashes equal to the "
              f"long-lived engine's [{card()}]")
        keep = {"ds": ds, "store": store, "root": root, "ids": ids,
                "writers": writers, "depth": depth, "cut": cut}
        del boot
    finally:
        if keep is None:
            shutil.rmtree(root, ignore_errors=True)

    # (e) the text fleet: compaction, the ghost-anchor reject, admission
    tids, trounds = text_fleet(n_docs=text_docs)
    acks = text_fleet_acks(trounds)
    tds = ResidentRowsDocSet(tids, device=dev)
    frames = [encode_round_frame(r) for r in trounds + [acks]]
    (h0, n) = b1_launches(torch, dev, lambda: (
        tds.apply_round_frames(frames), tds.hashes())[1])
    launches += n
    floors = {d: causal_floor(tds, i) for i, d in enumerate(tids)}
    t0 = time.perf_counter()
    stats = tds.compact(floors)
    compact_s = time.perf_counter() - t0
    h1, n = b1_launches(torch, dev, tds.hashes)
    launches += n
    check(n > 0, "text fleet: the compaction re-read launched nothing")
    check((h1 == h0).all(), "text fleet: compaction moved a hash")
    ghosts = sum(len(g) for g in tds.ghost_eids)
    e0 = sum(st["elems_before"] for st in stats.values())
    e1 = sum(st["elems_after"] for st in stats.values())
    check(ghosts > 0 and e1 < e0, "text fleet: no element reclaimed")
    hold_to_plain(tds, h1, "(e) text fleet after compaction", report, "11")
    k = next(i for i, g in enumerate(tds.ghost_eids) if g)
    d = tids[k]
    clock = dict(tds.tables[k].clock)
    from automerge_tpu_torch.core.change import Change, Op
    bad = Change("alice", clock["alice"] + 1, clock, [
        Op("ins", f"{d}/text", key=sorted(tds.ghost_eids[k])[0], elem=999)])
    logs = [len(log) for log in tds.change_log]
    try:
        tds.apply_round_frames([encode_round_frame({d: [bad]})])
        check(False, "text fleet: an insert at a ghost admitted")
    except CompactionAnchorError as e:
        check(e.doc_id == d, "text fleet: the reject named another doc")
    check([len(log) for log in tds.change_log] == logs,
          "text fleet: the rejected frame grew a change log")
    h2, n = b1_launches(torch, dev, tds.hashes)
    launches += n
    check((h2 == h1).all(), "text fleet: the reject moved a hash")
    ok_round = {d: [Change("alice", clock["alice"] + 1, clock, [
        Op("set", "00000000-0000-0000-0000-000000000000", key="after",
           value=1)])]}
    h3, n = b1_launches(torch, dev, lambda: (
        tds.apply_round_frames([encode_round_frame(ok_round)]),
        tds.hashes())[1])
    launches += n
    check(len(tds.change_log[k]) == logs[k] + 1 and (h3 != h2).sum() == 1,
          "text fleet: the ordinary round did not admit")
    hold_to_plain(tds, h3, "(e) text fleet after the ordinary round",
                  report, "11")
    print(f"phase 11: (e) text fleet {len(tids)} docs: compaction "
          f"{compact_s:.3f} s, elements {e0} -> {e1}, ops "
          f"{sum(st['ops_before'] for st in stats.values())} -> "
          f"{sum(st['ops_after'] for st in stats.values())}, ghosts "
          f"{ghosts}; hashes unchanged; an insert after a ghost raised "
          f"CompactionAnchorError before admission (no change log grew, "
          f"hashes unchanged); the next round admitted [{card()}]")
    print(f"phase 11: launches {launches}; phase 11 took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches, keep



# ---------------------------------------------------------------------------
# Phase 12: the document API and the interpretive OpSet on the card


def storm_state(opset) -> dict:
    """What a resolved storm realm decides: each moved object's effective
    parent, the realm's cycle drops, and the materialized document."""
    from automerge_tpu_torch.core.ids import ROOT_ID
    from automerge_tpu_torch.core.moves import _DROPS_KEY
    from automerge_tpu_torch.engine.batchdoc import oracle_state
    from automerge_tpu_torch.frontend.materialize import materialize_root
    parents = {}
    for oid in sorted(opset.moved_objs):
        obj = opset.by_object[oid]
        ref = obj.loc if obj.loc is not None else next(iter(obj.inbound))
        parents[oid] = ref.obj
    return {"parents": parents,
            "drops": opset.by_object[ROOT_ID].moves.get(_DROPS_KEY, 0),
            "doc": oracle_state(materialize_root("storm", opset))}


@contextlib.contextmanager
def recorded_move_plans():
    """Every plan of dispatch.resolve_moves_adaptive, in order (wrapped,
    put back after)."""
    from automerge_tpu_torch.engine import dispatch
    plans = []
    real = dispatch.resolve_moves_adaptive

    def rec(packed, device="cuda"):
        plan, out = real(packed, device=device)
        plans.append(plan)
        return plan, out
    dispatch.resolve_moves_adaptive = rec
    try:
        yield plans
    finally:
        dispatch.resolve_moves_adaptive = real


@contextlib.contextmanager
def kernel_min(value):
    """AMTPU_MOVE_KERNEL_MIN set to `value`, restored after."""
    old = os.environ.get("AMTPU_MOVE_KERNEL_MIN")
    os.environ["AMTPU_MOVE_KERNEL_MIN"] = str(value)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("AMTPU_MOVE_KERNEL_MIN", None)
        else:
            os.environ["AMTPU_MOVE_KERNEL_MIN"] = old


def drive_storm_opset(torch, dev, report, n_objs=1600, n_moves=1536):
    """Phase 12 (a) and (b): bench config 16(b)'s storm (1,600 objects,
    1,536 concurrent moves by 7 writers) through the OpSet on the card:
    (a) one add_changes(move_batch=True), held to the same on the CPU (the
    plain B4) and to the per-op path with the walk forced; (b) the per-op
    path at the default threshold, a change a call. Returns the B4
    launches of (a) and (b)."""
    import numpy as np
    from automerge_tpu_torch.core.moves import (MOVE_KERNEL_MIN_NODES,
                                                _build_map_problem)
    from automerge_tpu_torch.core.opset import OpSet
    from automerge_tpu_torch.engine import cuda_kernels as ck
    from automerge_tpu_torch.engine.move_kernels import (resolve_moves,
                                                         resolve_moves_plain)
    from automerge_tpu_torch.engine.pack import pack_moves
    from automerge_tpu_torch.workloads import move_storm_changes

    base, storm = move_storm_changes(n_objs, n_moves)
    card0, _ = OpSet.init(dev).add_changes([base])
    cpu0, _ = OpSet.init("cpu").add_changes([base])
    with recorded_move_plans() as plans:
        ck.LAUNCHES["resolve_moves"] = 0
        t0 = time.perf_counter()
        dev_set, card_diffs = card0.add_changes(storm, move_batch=True)
        wall_a = time.perf_counter() - t0
        n_a = ck.LAUNCHES["resolve_moves"]
    check(n_a > 0, "storm realm: the OpSet did not launch B4")
    check(card_diffs and all(d["action"] == "batch" for d in card_diffs),
          "storm realm: the batch did not take the move plane")
    plan = plans[-1]
    check(plan.backend == "device", "storm realm: the plan took the host")
    t0 = time.perf_counter()
    cpu, cpu_diffs = cpu0.add_changes(storm, move_batch=True)
    cpu_s = time.perf_counter() - t0
    want = storm_state(dev_set)
    check(cpu_diffs == card_diffs, "storm realm: card diffs != CPU diffs")
    check(storm_state(cpu) == want, "storm realm: card state != CPU state")
    with kernel_min(1 << 30):
        t0 = time.perf_counter()
        walk = card0
        for c in storm:
            walk, _ = walk.add_changes([c])
        walk_s = time.perf_counter() - t0
    check(storm_state(walk) == want,
          "storm realm: card state != the per-op walk's")
    # B4 against its plain version on the realm the batch resolved
    packed = pack_moves([_build_map_problem(dev_set.thaw())])
    nodes = torch.from_numpy(np.ascontiguousarray(packed["nodes"])).to(dev)
    cands = torch.from_numpy(np.ascontiguousarray(packed["cands"])).to(dev)
    got = resolve_moves(nodes, cands)
    ref = resolve_moves_plain(nodes.cpu(), cands.cpu())
    err = max(max_abs_err(got[k].cpu().numpy(), ref[k].numpy())
              for k in ref)
    report["resolve_moves"].append(err)
    check(err == 0, "storm realm: B4 != plain version")
    print(f"phase 12: (a) storm realm ({len(storm)} moves of "
          f"{len(dev_set.moved_objs)} objects by 7 writers) through "
          f"OpSet.add_changes(move_batch=True) on the card {wall_a:.4f} s "
          f"(plan {plan.backend}: est_device_s {plan.est_device_s:.3e}, "
          f"est_host_s {plan.est_host_s:.3e}; nodes {tuple(nodes.shape)}, "
          f"cands {tuple(cands.shape)}); B4 launches {n_a}; on the CPU "
          f"(plain B4) {cpu_s:.4f} s; per-op with the walk forced "
          f"{walk_s:.3f} s; parents, drops ({want['drops']}), batch diffs "
          f"({len(card_diffs)}) and documents equal; B4 on this realm "
          f"equal to the plain version [{card()}]")
    ck.LAUNCHES["resolve_moves"] = 0
    t0 = time.perf_counter()
    per = card0
    for c in storm:
        per, _ = per.add_changes([c])
    wall_b = time.perf_counter() - t0
    n_b = ck.LAUNCHES["resolve_moves"]
    check(n_b > 0, "per-op storm: no change launched B4")
    check(storm_state(per) == want, "per-op storm: state != (a)")
    print(f"phase 12: (b) the same storm a change a call "
          f"(add_changes([c]), threshold {MOVE_KERNEL_MIN_NODES} moved "
          f"nodes) {wall_b:.3f} s, {1e3 * wall_b / len(storm):.3f} ms a "
          f"change; B4 launches {n_b} (changes from the "
          f"{MOVE_KERNEL_MIN_NODES}th moved node on: "
          f"{len(storm) - MOVE_KERNEL_MIN_NODES + 1}); state equal to (a) "
          f"[{card()}]")
    return n_a + n_b


def drive_text_api(dev, base_chars=1_000_000, load_edits=65536):
    """Phase 12 (c) and (d): bench config 10's bulk merge (a 1M-char base
    by api.load, H1 applied, H2 merged by the span plane and by the
    per-op path) and bench config 6's text load (65,536 edits by api.load,
    held to the interpretive replay)."""
    import json

    from automerge_tpu_torch import api
    from automerge_tpu_torch.core import bulkload
    from automerge_tpu_torch.core.change import coerce_change
    from automerge_tpu_torch.frontend.materialize import apply_changes_to_doc
    from automerge_tpu_torch.utils import metrics
    from automerge_tpu_torch.workloads import (SPAN_ARANK, SPAN_ORIGINS,
                                               divergent_side,
                                               merge_table_from_events,
                                               text_load_log)

    builds = []
    real_build = bulkload.build_opset

    def counted_build(cols, device="cuda"):
        builds.append(device)
        return real_build(cols, device)
    bulkload.build_opset = counted_build
    try:
        t0 = time.perf_counter()
        wire, seq, mx, nb = text_load_log(int(base_chars / 0.85), seed=31,
                                          variant="paste_burst",
                                          with_state=True)
        n_side = int(round(len(seq) * 0.01))
        h1, ev1 = divergent_side(seq, mx, nb, "A", "C", n_side, seed=21)
        h2, ev2 = divergent_side(seq, mx, nb, "A", "B", n_side, seed=22)
        h1c = [coerce_change(c) for c in h1]
        h2c = [coerce_change(c) for c in h2]
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        doc = api.load(wire, device=dev)
        load_s = time.perf_counter() - t0
        check(len(builds) == 1 and len(doc["t"]) == len(seq),
              "bulk merge: the base did not load through the bulk loader")
        t0 = time.perf_counter()
        doc1 = apply_changes_to_doc(doc, doc._doc.opset, h1c,
                                    incremental=True)
        h1_s = time.perf_counter() - t0
        merged0 = metrics.snapshot().get("sync_text_batches_merged", 0)
        t0 = time.perf_counter()
        span = apply_changes_to_doc(doc1, doc1._doc.opset, h2c,
                                    incremental=True)
        span_s = time.perf_counter() - t0
        check(metrics.snapshot().get("sync_text_batches_merged", 0)
              > merged0, "bulk merge: H2 did not take the span plane")
        t0 = time.perf_counter()
        perop = apply_changes_to_doc(doc1, doc1._doc.opset, h2c,
                                     incremental=True, text_batch=False)
        perop_s = time.perf_counter() - t0
        joined = span["t"].join()
        _r, _b, _c, expected = merge_table_from_events(
            len(seq), {"C": ev1, "B": ev2}, SPAN_ARANK, SPAN_ORIGINS)
        check(joined == perop["t"].join() and len(joined) == expected,
              "bulk merge: span plane != per-op path")
        print(f"phase 12: (c) bulk merge (bench config 10): base "
              f"{len(seq)} chars ({nb} changes) generated with both sides "
              f"({n_side} char ops a side) in {gen_s:.2f} s; api.load "
              f"(bulk) {load_s:.3f} s; H1 applied {h1_s:.3f} s; H2 merged "
              f"by the span plane {span_s:.3f} s, by the per-op path "
              f"{perop_s:.3f} s; joined texts equal ({len(joined)} chars) "
              f"[{card()}]")
        del doc, doc1, span, perop
        full, vis = text_load_log(load_edits)
        builds.clear()
        t0 = time.perf_counter()
        loaded = api.load(full, device=dev)
        load6_s = time.perf_counter() - t0
        check(len(builds) == 1 and len(loaded["t"]) == vis,
              "text load: not through the bulk loader")
        t0 = time.perf_counter()
        ref = api.init("replay", dev)
        ref = apply_changes_to_doc(ref, ref._doc.opset,
                                   [coerce_change(c)
                                    for c in json.loads(full)],
                                   incremental=False)
        replay_s = time.perf_counter() - t0
        check(api.equals(loaded, ref), "text load: bulk != interpretive")
        print(f"phase 12: (d) text load (bench config 6, {load_edits:,} edits, "
              f"{vis} chars): api.load (bulk) {load6_s:.3f} s; the "
              f"interpretive replay (incremental=False) {replay_s:.3f} s; "
              f"api.equals [{card()}]")
    finally:
        bulkload.build_opset = real_build


def replay_state(changes, dev) -> dict:
    """A whole log replayed through the interpretive frontend on `dev`, as
    oracle_state."""
    from automerge_tpu_torch import api
    from automerge_tpu_torch.engine.batchdoc import oracle_state
    from automerge_tpu_torch.frontend.materialize import apply_changes_to_doc
    doc = api.init("replay", dev)
    return oracle_state(apply_changes_to_doc(
        doc, doc._doc.opset, changes, incremental=False, emit_diffs=False))


def drive_materialize(dev, text_ds, docs_ds, long_keep, n_text=64,
                      n_long=16, fleet=None):
    """Phase 12 (e): ResidentRowsDocSet.materialize on the card: 64 docs of
    phase 3's text fleet (equal to phase 9's docs-major materialize and to
    a CPU rows instance of the same streams), 16 long-lived docs of phase
    11 after an archive pass (archive + tail) and 16 snapshot-booted ones
    (image + remap_tail), each equal to a replay of its full log."""
    from automerge_tpu_torch.engine.resident_rows import ResidentRowsDocSet
    from automerge_tpu_torch.sync.frames import encode_round_frame
    from automerge_tpu_torch.workloads import long_lived_changes, text_fleet

    tids, trounds = fleet or text_fleet()
    sub = tids[:n_text]
    t0 = time.perf_counter()
    got = {d: text_ds.materialize(d) for d in sub}
    text_ms = 1e3 * (time.perf_counter() - t0) / len(sub)
    cpu = ResidentRowsDocSet(sub, device="cpu")
    cpu.apply_rounds([{d: r[d] for d in sub if d in r} for r in trounds])
    for d in sub:
        check(got[d] == docs_ds.materialize(d) == cpu.materialize(d),
              f"text fleet: materialize of {d} differs")
    ds, store, ids = long_keep["ds"], long_keep["store"], long_keep["ids"]
    depth, cut = long_keep["depth"], long_keep["cut"]
    arch = ids[:n_long]
    for i, d in enumerate(arch):
        w = f"w{i % 4:02d}"
        ds.archive_log_prefix(d, {w: depth - 50})
        check(ds.log_horizon[i] and 0 < len(ds.change_log[i]) < depth,
              f"long-lived: {d} has no archive + tail split")
    t0 = time.perf_counter()
    got = [ds.materialize(d) for d in arch]
    arch_ms = 1e3 * (time.perf_counter() - t0) / len(arch)
    for j, state in enumerate(got):
        check(state == replay_state(long_lived_changes(j, 1, depth), dev),
              f"long-lived: materialize of {arch[j]} != its full log")
    booted = ids[n_long:2 * n_long]
    boot = ResidentRowsDocSet(booted, actors=long_keep["writers"],
                              device=dev)
    boot.snapshot_store = store
    images = {d: store.load(d) for d in booted}
    boot.apply_rounds([{d: img.columns().to_changes()
                        for d, img in images.items()}])
    for i, (d, img) in enumerate(images.items()):
        boot.seed_clock(d, img.clock, img.heads)
        boot.change_log[i] = []
        boot.log_horizon[i] = dict(img.clock)
    boot.apply_round_frames([encode_round_frame(
        {d: long_lived_changes(n_long + i, cut + 1, depth)
         for i, d in enumerate(booted)})])
    t0 = time.perf_counter()
    got = [boot.materialize(d) for d in booted]
    boot_ms = 1e3 * (time.perf_counter() - t0) / len(booted)
    for i, state in enumerate(got):
        # doc j's image was written from writer j % 4's first `cut` changes
        check(state == replay_state(
            long_lived_changes(n_long + i, 1, depth), dev),
            f"snapshot-booted: materialize of {booted[i]} != its full log")
    print(f"phase 12: (e) rows materialize on the card: text fleet "
          f"{len(sub)} docs {text_ms:.3f} ms a doc (equal to the docs-major "
          f"materialize and to a CPU rows instance); long-lived after an "
          f"archive pass (archive + 50-change tail, {depth} changes a "
          f"doc) {len(arch)} docs {arch_ms:.3f} ms a doc; snapshot-booted "
          f"(image of {cut} changes + remap_tail) {len(booted)} docs "
          f"{boot_ms:.3f} ms a doc; each equal to a replay of its full log "
          f"[{card()}]")


def measure_batch_constants(dev, ids, initial) -> dict:
    """The batch route's host constants on this machine (dispatch._LINK's
    host_op_s, bulk_op_s, bulk_fixed_s): apply_host's no-diff apply +
    materialize over 2,000 docs of the docset fleet, seconds an op; the
    bulk build from in-memory changes (changes_to_columns included) of
    bench config 6's log at 24,576 and 49,152 edits, a fixed part and a
    part an op."""
    import json

    from automerge_tpu_torch.core.bulkload import try_bulk_build
    from automerge_tpu_torch.core.change import Change
    from automerge_tpu_torch.engine.dispatch import apply_host
    from automerge_tpu_torch.native.wire import changes_to_columns
    from automerge_tpu_torch.workloads import text_load_log

    docs = [initial[d] for d in ids[:2000]]
    n_ops = sum(len(c.ops) for chs in docs for c in chs)
    t0 = time.perf_counter()
    for chs in docs:
        apply_host(chs, device=dev)
    host_op = (time.perf_counter() - t0) / n_ops
    points = []
    for n in (24576, 49152):
        chs = [Change.from_dict(c)
               for c in json.loads(text_load_log(n)[0])]
        ops = sum(len(c.ops) for c in chs)
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            check(try_bulk_build(changes_to_columns(chs), dev) is not None,
                  "bulk build fell back")
            walls.append(time.perf_counter() - t0)
        points.append((ops, p50(walls)))
    (o1, t1), (o2, t2) = points
    bulk_op = (t2 - t1) / (o2 - o1)
    out = {"host_op_s": host_op, "bulk_op_s": bulk_op,
           "bulk_fixed_s": max(t1 - o1 * bulk_op, 1e-6)}
    print(f"phase 12: (f) batch route host legs: apply_host of "
          f"{len(docs)} docset-fleet docs ({n_ops} ops) "
          f"{host_op * n_ops:.4f} s; bulk build of {o1} ops "
          f"{t1:.4f} s, of {o2} ops {t2:.4f} s [{card()}]")
    print("batch_link " + json.dumps(out))
    return out


def drive_batch_route(torch, dev, n_docs=10_000):
    """Phase 12 (f): dispatch.apply_batch_adaptive on bench config 5's
    docset fleet (10,000 docs x 3 changes; the device route, its hashes
    equal to apply_batch's) and on a batch small enough to plan the host
    (its documents equal to apply_batch's decode). Returns the launches
    of dominated and linearize on the device route."""
    from automerge_tpu_torch.core.change import Change, Op
    from automerge_tpu_torch.core.ids import ROOT_ID
    from automerge_tpu_torch.engine import cuda_kernels as ck
    from automerge_tpu_torch.engine import dispatch
    from automerge_tpu_torch.engine.batchdoc import (apply_batch, decode_doc,
                                                     doc_outputs,
                                                     oracle_state)
    from automerge_tpu_torch.workloads import docset_fleet

    ids, initial, _ = docset_fleet(n_docs=n_docs, rounds=0)
    measure_batch_constants(dev, ids, initial)
    batch = [initial[d] for d in ids]
    ck.LAUNCHES["dominated"] = ck.LAUNCHES["linearize"] = 0
    t0 = time.perf_counter()
    plan, hashes = dispatch.apply_batch_adaptive(batch, device=dev)
    wall = time.perf_counter() - t0
    n_dom, n_lin = ck.LAUNCHES["dominated"], ck.LAUNCHES["linearize"]
    check(plan.backend == "device" and n_dom > 0,
          "docset fleet: the batch route did not take the card")
    _e, _b, out = apply_batch(batch, device=dev)
    check((hashes == ck.hashes_to_numpy(out["hash"])).all(),
          "docset fleet: the route's hashes != apply_batch's")
    small = None
    for k in (8, 4, 2, 1):
        cand = batch[:k]
        if dispatch.plan_for(cand).backend == "host":
            small = cand
            break
    if small is None:
        small = [[Change("A", 1, {}, [Op("set", ROOT_ID, key="n",
                                         value=0)])]]
    t0 = time.perf_counter()
    hplan, docs = dispatch.apply_batch_adaptive(small, device=dev)
    hwall = time.perf_counter() - t0
    check(hplan.backend == "host", "no batch planned the host")
    encs, _b, out = apply_batch(small, device=dev)
    for i, doc in enumerate(docs):
        check(oracle_state(doc) == decode_doc(encs[i], doc_outputs(out, i)),
              "host route: a document != apply_batch's decode")
    print(f"phase 12: (f) apply_batch_adaptive: docset fleet {len(batch)} "
          f"docs plan {plan.backend} (est_device_s {plan.est_device_s:.3e}, "
          f"est_host_s {plan.est_host_s:.3e}) {wall:.3f} s, hashes equal "
          f"to apply_batch's, launches dominated {n_dom} linearize {n_lin};"
          f" {len(small)} docs ({sum(len(c.ops) for chs in small for c in chs)}"
          f" ops) plan {hplan.backend} (est_device_s "
          f"{hplan.est_device_s:.3e}, est_host_s {hplan.est_host_s:.3e}) "
          f"{hwall:.4f} s, documents equal to apply_batch's decode "
          f"[{card()}]")
    return n_dom, n_lin


def drive_api(torch, dev, report, text_ds, docs_ds, long_keep):
    """Phase 12: the document API and the interpretive OpSet on the card.
    Returns the launches of B4 ((a) and (b)) and of dominated and
    linearize ((f))."""
    t_phase = time.perf_counter()
    n_b4 = drive_storm_opset(torch, dev, report)
    drive_text_api(dev)
    drive_materialize(dev, text_ds, docs_ds, long_keep)
    n_dom, n_lin = drive_batch_route(torch, dev)
    print(f"phase 12: launches resolve_moves {n_b4}, dominated {n_dom}, "
          f"linearize {n_lin}; phase 12 took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return n_b4, n_dom, n_lin

def time_docs_round(torch, ds):
    """Device milliseconds of one full apply_doc over the text fleet's
    state, of its linearize step (the kernel) and of linearize_plain."""
    from automerge_tpu_torch.engine.kernels import (apply_doc, linearize,
                                                    linearize_plain)
    s = ds.state
    d, n_lists, n_elems = s["ins_mask"].shape
    cols = [s[k].reshape(d * n_lists, n_elems)
            for k in ("ins_mask", "ins_elem", "ins_actor", "ins_parent")]
    whole = cuda_ms(lambda: apply_doc(s, ds.cap_fids), 10)
    lin = cuda_ms(lambda: linearize(*cols), 10)
    plain = cuda_ms(lambda: linearize_plain(*cols), 3)
    print(f"timing text fleet: apply_doc {whole:.3f} ms, of which linearize "
          f"{lin:.3f} ms ({100 * lin / whole:.1f}%) at [{d * n_lists}, "
          f"{n_elems}] element rows (linearize_plain {plain:.3f} ms)")


def linearize_bound(host, model):
    """(bound_ms, bound_by, bytes, ops) of one linearize launch on these
    rows (numpy inputs): the mask byte and three int32 columns read, one
    int32 written, a slot each (17 bytes); operations, for this data: on
    each row with n live slots a comparison sort (n log2 n), four a live
    slot to build the list, and three a live node for each doubling step
    the row needs before no pointer is left (the kernel's CPU model's
    count, `model` its result); an empty row none."""
    import math
    r, e = host[0].shape
    live, steps = model["live"], model["doublings"]
    ops = sum(int(n * math.log2(n)) + 4 * int(n) + 3 * (int(n) + 1) * int(k)
              for n, k in zip(live, steps) if n)
    nbytes = 17 * r * e
    return (*bound_of(nbytes, ops), nbytes, ops)


def time_linearize(torch, ds, label):
    """The linearize launch apply_doc makes on this engine's state."""
    from automerge_tpu_torch.engine import cuda_kernels as ck
    from automerge_tpu_torch.engine.kernels import linearize_plain
    from automerge_tpu_torch.linearize_schedule import schedule_model
    s = ds.state
    d, n_lists, n_elems = s["ins_mask"].shape
    cols = [s[k].reshape(d * n_lists, n_elems)
            for k in ("ins_mask", "ins_elem", "ins_actor", "ins_parent")]
    host = [c.cpu().numpy() for c in cols]
    t = launch_times(lambda: ck.linearize(*cols), 20)
    p_ms = cuda_ms(lambda: linearize_plain(*cols), 2)
    model = schedule_model(*host)
    b_ms, b_by, nbytes, ops = linearize_bound(host, model)
    print(f"timing {label}: linearize rows=[{d * n_lists}, {n_elems}] "
          f"({linearize_where(ck, n_elems)}) live slots="
          f"{int(host[0].sum())} {times_text(t)} plain_ms={p_ms:.3f} "
          f"bound_ms={b_ms:.5f} ({b_by}; bytes={nbytes} ops={ops}); "
          f"{walk_text(host)}; CPU model: narrow records on "
          f"{int(model['narrow'].sum())} rows, jumps max "
          f"{int(model['jumps'].max())}, doubling steps max "
          f"{int(model['doublings'].max())}")
    return t["graph_ms"], p_ms, b_ms, b_by


def dominated_bound(args):
    """(bound_ms, bound_by, bytes, ops) of one domination launch, for this
    data: amask read and the flags written on every lane (a byte each);
    fid, change_idx, actor and seq read on live lanes only (the function
    needs nothing else of a masked lane); and the 4-byte clock cells
    clock_op[j, actor_i] that the answer needs, each once: for an
    undominated live op i, those of every live j on its field from another
    change; for a dominated one, that of its first dominator. An actor
    outside [0, A) reads no cell. Operations: one compare for each ordered
    pair of live ops on one field."""
    clock_op, actor, fid, seq, change_idx, amask = args
    cells, _ = _clock_cells(clock_op, actor, fid, seq, change_idx, amask,
                            amask, oob_reads_zero=True)
    nbytes = 2 * amask.numel() + 16 * int(amask.sum()) + 4 * cells
    ops = _pair_count(fid, amask)
    return (*bound_of(nbytes, ops), nbytes, ops)


def time_dominated(torch, ds, label):
    """The domination launch apply_doc makes on this engine's state, timed
    warm: on the main path apply_doc gathers these inputs just before the
    launch, so they reach the kernel from L2."""
    from automerge_tpu_torch.engine import cuda_kernels as ck
    from automerge_tpu_torch.engine.kernels import domination_inputs
    s = ds.state
    args = domination_inputs(s["op_mask"], s["action"], s["fid"], s["actor"],
                             s["seq"], s["change_idx"], s["clock"])
    t = launch_times(lambda: ck.dominated(*args), 20)
    p_ms = cuda_ms(lambda: ck.dominated_plain(*args), 2)
    b_ms, b_by, nbytes, ops = dominated_bound(args)
    print(f"timing {label}: dominated clock_op={tuple(args[0].shape)} "
          f"live ops={int(args[-1].sum())} {times_text(t)} "
          f"plain_ms={p_ms:.3f} bound_ms={b_ms:.5f} "
          f"({b_by}; bytes={nbytes} compares={ops})")
    return t["graph_ms"], p_ms, b_ms, b_by


def host_s(fn, reps: int) -> float:
    """Median host seconds of fn() over `reps` calls, after one warm-up."""
    import statistics
    fn()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls)


def route_host_s(ds, idxs, reps: int = 15) -> float:
    """Median host seconds of the megabatch route on `idxs` (refresh path:
    the lanes marked dirty, plan_round, apply_round_adaptive) beyond what
    the plan prices for its link, launch and device legs. Run with the
    route's host terms at zero, so that est_mega_s is those legs alone."""
    import statistics

    from automerge_tpu_torch.engine import dispatch
    extra = []
    for _ in range(reps):
        ds._mark_hash_dirty(idxs.tolist())
        t0 = time.perf_counter()
        plan = dispatch.plan_round(ds, idxs)
        check(plan.route == "megabatch", "the route was not taken")
        dispatch.apply_round_adaptive(ds, plan)
        extra.append(time.perf_counter() - t0 - plan.est_mega_s)
    check(ds.hashes_clean, "the route left dirty lanes")
    return statistics.median(extra)


def measure_route_constants(torch, ds) -> dict:
    """The megabatch planner's constants on phase 2's map storm engine
    (route on, its device copy resident): a launch (the reconcile wrapper
    on a bucket-shaped buffer, host enqueue only), the reconcile's rate
    over the resident buffer (buffer bytes over its L2-cold graph time),
    the host mirror's narrow gather (128 lanes at full dims, bytes
    gathered a second), and the route's host work at 128 and 1,024 docs
    of the storm (one-op docs, one bucket), a fixed part and a part a
    doc."""
    import numpy as np
    from automerge_tpu_torch.engine import cuda_kernels as ck
    from automerge_tpu_torch.engine import dispatch
    from automerge_tpu_torch.workloads import reconcile_case

    rows_np, dims = reconcile_case("bucket_small", seed=1)
    small = torch.from_numpy(rows_np).to(ds.rows_dev.device)
    ck.reconcile_rows_hash(small, dims)
    enq = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            ck.reconcile_rows_hash(small, dims)
        enq.append((time.perf_counter() - t0) / 100)
        torch.cuda.synchronize()
    rows, rdims = ds.rows_dev, ds.dims()
    cold_ms = graph_cold_ms(lambda: ck.reconcile_rows_hash(rows, rdims), 10)
    rng = np.random.default_rng(8)
    sel = np.sort(rng.choice(len(ds.doc_ids), 128, replace=False))
    gather_s = host_s(lambda: np.ascontiguousarray(ds.rows_host[:, sel]),
                      20)
    out = {"launch_s": sorted(enq)[2],
           "dev_bytes_per_s": rows.numel() * 4 / (cold_ms / 1e3),
           "host_gather_bytes_per_s": ds.rows_host.shape[0] * 128 * 4
           / gather_s}
    saved = dict(dispatch._LINK)
    dispatch.calibrate(**out, mega_fixed_s=0.0, mega_doc_s=0.0)
    try:
        small_docs = np.flatnonzero(ds.op_count[:len(ds.doc_ids)] <= 8)
        e1 = route_host_s(ds, small_docs[:128])
        e2 = route_host_s(ds, small_docs[:1024])
    finally:
        dispatch._LINK.update(saved)
    out["mega_doc_s"] = max((e2 - e1) / (1024 - 128), 1e-9)
    out["mega_fixed_s"] = max(e1 - 128 * out["mega_doc_s"], 1e-9)
    print(f"phase 8: route legs: reconcile enqueue {out['launch_s']:.3e} s; "
          f"reconcile of the map storm's {rows.numel() * 4} B buffer "
          f"{cold_ms:.4f} ms (L2 cold); host gather of 128 lanes at full "
          f"dims {gather_s:.3e} s; the route's host work beyond its priced "
          f"legs {e1:.3e} s at 128 docs, {e2:.3e} s at 1,024 [{card()}]")
    return out


def measure_link(torch, dev, map_ds) -> dict:
    """Phase 8: the routers' cost constants on this machine. Link legs
    through torch from pageable numpy memory, as the router ships; host
    legs on the port's numpy oracles; the megabatch planner's constants
    on phase 2's engine (measure_route_constants)."""
    import random

    import numpy as np
    from automerge_tpu_torch.engine.move_kernels import resolve_moves_host
    from automerge_tpu_torch.engine.pack import pack_moves, pack_spans
    from automerge_tpu_torch.engine.span_kernels import (merge_spans_host,
                                                         span_rank_hash)
    from automerge_tpu_torch.workloads import (move_fleet,
                                               random_move_problem,
                                               span_fleet)

    small = torch.zeros(128, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    d2h = host_s(lambda: small.cpu(), 200)
    tiny = torch.from_numpy(pack_spans([[(1, 2, 3, 0, 0, 0, 0)]])).to(dev)
    tiny_total = host_s(lambda: span_rank_hash(tiny)[1].cpu(), 200)

    def h2d(nbytes):
        a = np.zeros(nbytes // 4, np.int32)
        return host_s(lambda: (torch.from_numpy(a).to(dev),
                               torch.cuda.synchronize()), 20)
    h2d_small = h2d(1024)
    t1, t64 = h2d(1 << 20), h2d(64 << 20)

    fleet_spans = pack_spans(span_fleet(n_docs=2000)[0])
    one_span = pack_spans([[(1, 2, 3, 0, 0, 0, 0)]])
    span_fixed = host_s(lambda: merge_spans_host(one_span), 50)
    span_big = host_s(lambda: merge_spans_host(fleet_spans), 5)
    d, _f, s = fleet_spans.shape

    one_realm = pack_moves([random_move_problem(random.Random(1), 20, 10)])
    realms = pack_moves(move_fleet(n_realms=32))
    move_fixed = host_s(lambda: resolve_moves_host(one_realm), 20)
    move_big = host_s(lambda: resolve_moves_host(realms), 3)
    rd, _f, n = realms["nodes"].shape
    k = realms["cands"].shape[2]
    link = {
        "dispatch_fixed_s": max(tiny_total - d2h, 1e-7),
        "h2d_call_s": h2d_small,
        "h2d_bytes_per_s": (63 << 20) / max(t64 - t1, 1e-9),
        "d2h_call_s": d2h,
        "span_op_s": (span_big - span_fixed) / (d * s),
        "span_fixed_s": span_fixed,
        "move_lane_s": (move_big - move_fixed) / (rd * (n + k)),
        "move_fixed_s": move_fixed,
        **measure_route_constants(torch, map_ds),
    }
    print(f"phase 8: link legs: tiny launch + readback {tiny_total:.3e} s, "
          f"512 B readback {d2h:.3e} s, 1 KiB copy {h2d_small:.3e} s, "
          f"1 MiB {t1:.3e} s, 64 MiB {t64:.3e} s; host legs: "
          f"merge_spans_host 1x128 {span_fixed:.3e} s, {d}x{s} "
          f"{span_big:.3e} s; resolve_moves_host 1x(128+128) "
          f"{move_fixed:.3e} s, {rd}x({n}+{k}) {move_big:.3e} s "
          f"[{card()}]")
    print("link " + json.dumps(link))
    return link


def time_kernel(torch, ds, label):
    from automerge_tpu_torch.engine import cuda_kernels as ck
    rows, dims = ds.rows_dev, ds.dims()
    t = launch_times(lambda: ck.reconcile_rows_hash(rows, dims), 20,
                     cold=True)
    p_ms = cuda_ms(lambda: ck.reconcile_rows_hash_plain(rows, dims), 1)
    b_ms, b_by, nbytes, ops = bound(rows, dims)
    print(f"timing {label}: dims={dims} lanes={rows.shape[1]} "
          f"{times_text(t)} plain_ms={p_ms:.3f} bound_ms={b_ms:.5f} "
          f"({b_by}; bytes={nbytes} compares={ops})")
    return t["graph_cold_ms"], p_ms, b_ms, b_by


def time_span_kernel(torch, spans, order, label):
    """The rank+hash launch that merge_spans makes on this workload."""
    from automerge_tpu_torch.engine.span_kernels import (
        span_launch, span_rank_hash, span_rank_hash_plain)
    t = launch_times(lambda: span_rank_hash(spans, order), 20)
    p_ms = cuda_ms(lambda: span_rank_hash_plain(spans, order), 3)
    b_ms, b_by, nbytes, ops = span_bound(spans)
    path = "warp" if span_launch(spans.shape[2]) else "block"
    print(f"timing {label}: span_rank_hash ({path} per document) "
          f"lanes={tuple(spans.shape)} "
          f"{times_text(t)} plain_ms={p_ms:.3f} bound_ms={b_ms:.5f} "
          f"({b_by}; bytes={nbytes} ops={ops})")
    return t["graph_ms"], p_ms, b_ms, b_by


def schedule_text(sched) -> str:
    """The kernel's schedule on a workload, summed over its realms (CPU
    model): rounds, doubling steps (each ends on a block barrier) and node
    gathers, against those of the plain schedule (every walk the full
    steps over every node)."""
    return (f"rounds={int(sched['rounds'].sum())} (most "
            f"{int(sched['rounds'].max())}) walks={int(sched['walks'].sum())}"
            f" (old {int(sched['rounds'].sum() + len(sched['rounds']))}) "
            f"doubling steps={int(sched['steps'].sum())} (old "
            f"{int(sched['steps_old'].sum())}) node gathers="
            f"{int(sched['gathers'].sum())} (old "
            f"{int(sched['gathers_old'].sum())})")


def time_move_kernel(torch, nodes, cands, sched, label):
    """The fixpoint launch that resolve_moves makes on this workload."""
    from automerge_tpu_torch.engine.move_kernels import (move_launch,
                                                         resolve_moves,
                                                         resolve_moves_plain)
    t = launch_times(lambda: resolve_moves(nodes, cands), 20)
    p_ms = cuda_ms(lambda: resolve_moves_plain(nodes, cands), 2)
    b_ms, b_by, nbytes, ops = move_bound(nodes, cands)
    print(f"timing {label}: resolve_moves (fixpoint) nodes="
          f"{tuple(nodes.shape)} cands={tuple(cands.shape)} "
          f"{times_text(t)} plain_ms={p_ms:.3f} bound_ms={b_ms:.5f} "
          f"({b_by}; bytes={nbytes} ops={ops}); launch plan "
          f"{move_launch(nodes.shape[2])} (threads, nodes a thread); "
          f"schedule (CPU model) "
          f"{schedule_text(sched)}")
    return t["graph_ms"], p_ms, b_ms, b_by


def kernel_entry(name, source, replaces, launches, errs, times):
    k_ms, p_ms, b_ms, b_by = times
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(errs), "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    repo = Path(__file__).resolve().parent
    if not (repo / "automerge_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(automerge_tpu_torch/ not found)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(repo))
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    report = {"reconcile_rows_hash": [], "span_rank_hash": [],
              "move_round": [], "resolve_moves": [], "dominated": [],
              "linearize": []}

    phase_kernel_parity(torch, dev, report)
    phase_plane_kernel_parity(torch, dev, report)
    phase_dominated_parity(torch, dev, report)
    phase_linearize_parity(torch, dev, report)
    (map_ds, map_final, map_launches,
     rounds_ds, rounds_final, mega) = drive_map_storm(torch, dev)
    text_ds, text_final, text_launches = drive_text_fleet(torch, dev)
    check(map_launches > 0 and text_launches > 0, "a path skipped the kernel")
    hold_to_plain(map_ds, map_final, "map storm", report)
    hold_to_plain(rounds_ds, rounds_final, "map storm (apply_rounds)",
                  report)
    hold_to_plain(text_ds, text_final, "text fleet", report)
    phase_reference(dev)
    phase_plane_reference(torch, dev, report)
    phase_docs_reference(dev)
    span_inputs, span_launches = drive_text_plane(torch, dev, report)
    move_inputs, move_launches = drive_move_plane(torch, dev, report)
    measure_link(torch, dev, map_ds)
    docset_ds, docs_ds, docs_launches, lin9, fleets = drive_docs_major(
        torch, dev, report, text_final)
    lin10 = drive_diff_plane(torch, dev, fleets)
    long_launches, long_keep = drive_long_lived(torch, dev, report)
    try:
        api_b4, api_dom, api_lin = drive_api(torch, dev, report, text_ds,
                                             docs_ds, long_keep)
    finally:
        import shutil
        shutil.rmtree(long_keep["root"], ignore_errors=True)
        del long_keep

    rows_times = time_kernel(torch, map_ds, "map storm")
    time_kernel(torch, text_ds, "text fleet")
    span_times = {k: time_span_kernel(torch, *v, k)
                  for k, v in span_inputs.items()}
    move_times = {k: time_move_kernel(torch, *v, k)
                  for k, v in move_inputs.items()}
    dom_times = time_dominated(torch, docs_ds, "text fleet (docs-major)")
    time_dominated(torch, docset_ds, "docset fleet (docs-major)")
    lin_times = time_linearize(torch, docs_ds, "text fleet (docs-major)")
    time_linearize(torch, docset_ds, "docset fleet (docs-major)")
    time_docs_round(torch, docs_ds)
    print(f"launches: rows engine {map_launches} (map storm frames and "
          f"minority reads) + {text_launches} (text fleet), of them "
          f"{mega.dispatches} megabatch buckets ({mega.text()}); text-merge "
          f"plane {span_launches}; "
          f"move plane {move_launches}; docs-major engine {docs_launches} "
          f"(dominated); linearize {lin9} (phase 9) + {lin10} (phase 10, "
          f"the diff plane); rows engine durability {long_launches} "
          f"(phase 11); the document API and the OpSet: resolve_moves "
          f"{api_b4}, dominated {api_dom}, linearize {api_lin} (phase 12)")
    print(json.dumps({"kernels": [
        kernel_entry("reconcile_rows_hash",
                     "automerge_tpu_torch/csrc/reconcile_rows.cu",
                     "automerge_tpu/engine/pallas_kernels.py:499",
                     map_launches + text_launches + long_launches,
                     report["reconcile_rows_hash"], rows_times),
        kernel_entry("span_rank_hash",
                     "automerge_tpu_torch/csrc/span_rank_hash.cu",
                     "automerge_tpu/engine/span_kernels.py:184",
                     span_launches, report["span_rank_hash"],
                     span_times["span fleet"]),
        kernel_entry("resolve_moves",
                     "automerge_tpu_torch/csrc/move_round.cu",
                     "automerge_tpu/engine/move_kernels.py:319",
                     move_launches + api_b4, report["resolve_moves"],
                     move_times["realm fleet"]),
        kernel_entry("dominated",
                     "automerge_tpu_torch/csrc/dominated.cu",
                     "automerge_tpu/engine/pallas_kernels.py:578",
                     docs_launches + api_dom, report["dominated"],
                     dom_times),
        kernel_entry("linearize",
                     "automerge_tpu_torch/csrc/linearize.cu",
                     "automerge_tpu/engine/kernels.py:102-137 (plain XLA, "
                     "no Pallas kernel)",
                     lin9 + lin10 + api_lin, report["linearize"],
                     lin_times)],
        "mega": mega.as_dict()}))
    print(f"total {time.perf_counter() - t_all:.1f} s")
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
