"""Adaptive routing by a measured cost model (the span, move and megabatch
part of `automerge_tpu/engine/dispatch.py`).

A batch of span tables or move realms can be merged on the host (the
numpy oracles, no fixed cost) or on the device (microseconds of kernel
time behind a fixed cost per dispatch, transfer and readback). The router
prices both and takes the cheaper; its result dict has the same keys and
shapes on both routes (numpy arrays on the host route, tensors on the
device route; `result_to_numpy` gives the numpy schema).

The rows engine's planner (`plan_round`, `apply_round_adaptive`) prices
the megabatch route, the dirty lanes of a minority hash read reconciled in
a few fused launches at smaller bucket dims, against the narrow gather the
engine does otherwise, and runs the route where it is not dearer.

The batch route (`plan_batch`, `plan_for`, `apply_batch_adaptive`) prices a
from-scratch DocSet batch: on the device, batchdoc.apply_batch (the B5
domination kernel and the linearize kernel on the card) returns per-doc
hashes; on the host, `apply_host` builds each document through the
interpretive OpSet (or the bulk loader) and returns materialized
documents; the batch runs inside a `metrics.trace("engine_dispatch")`
span. The megabatch route's gathers and its readback are timed under the
`pack` and `readback` phases (`utils/perfscope.py`).
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve_device
from ..utils import metrics, perfscope
from . import dispatchledger
from .cuda_kernels import hashes_to_numpy, reconcile_rows_hash
from .pack import mega_row_map, pad_to_lanes, plan_megabuckets, rows_count

# Cost model (seconds), measured by `chip_smoke.py` (phase 8, its "link"
# line) on an NVIDIA H100 80GB HBM3 with a 700.00 W power limit and the
# host of that machine, to five digits: the link legs through torch from
# pageable numpy memory, as the router ships; the host legs on the port's
# numpy oracles; the megabatch planner's terms (launch_s on) on the map
# storm's engine after phase 2 (chip_smoke.measure_route_constants).
# Override with calibrate() for another deployment.
_LINK = {
    "dispatch_fixed_s": 5.1166e-05,  # tiny launch + readback, less d2h
    "h2d_call_s": 3.1743e-05,        # per host->device copy (1 KiB)
    "h2d_bytes_per_s": 7.6423e9,     # host->device rate, 1 -> 64 MiB
    "d2h_call_s": 1.9129e-05,        # per 512-byte readback
    "span_op_s": 5.7452e-08,         # merge_spans_host per span lane
    "span_fixed_s": 7.4931e-05,      # merge_spans_host per batch
    "move_lane_s": 4.7201e-07,       # resolve_moves_host per node +
                                     # candidate lane (all rounds)
    "move_fixed_s": 9.1590e-04,      # resolve_moves_host per batch
    "launch_s": 2.0496e-05,          # reconcile wrapper, host enqueue
    "dev_bytes_per_s": 1.7563e12,    # reconcile over a resident row
                                     # buffer, its bytes a second (L2 cold)
    "host_gather_bytes_per_s": 1.5639e8,  # numpy gather of 128 scattered
                                     # lanes of the host mirror, bytes out
    "mega_fixed_s": 4.4542e-04,      # megabatch route's host work (bucket
    "mega_doc_s": 6.5875e-07,        # planning, bookkeeping) and a doc's
    # the batch route's host legs (chip_smoke.measure_batch_constants,
    # phase 12 (f), its "batch_link" line, same card and host)
    "host_op_s": 8.6586e-06,         # apply_host: no-diff interpretive
                                     # apply + materialize, an op
    "bulk_op_s": 1.8353e-05,         # bulk build from in-memory changes
    "bulk_fixed_s": 1.0000e-06,      # (changes_to_columns included), an
                                     # op and a doc (the fit's intercept
                                     # fell to its 1e-6 floor)
}


def calibrate(**overrides) -> None:
    """Override cost constants (e.g. from a deployment's own probe)."""
    for k, v in overrides.items():
        if k not in _LINK:
            raise KeyError(k)
        _LINK[k] = float(v)


def calibrate_from_profile(profile: dict) -> dict:
    """Update the link model from a link-profile record (the reference's
    profile_tunnel.py JSON: `h2d_ms_by_mb`, `d2h_512B_ms`,
    `tiny_dispatch_plus_readback_ms`). Returns the constants actually
    applied. Unknown or missing fields are skipped: partial profiles
    calibrate partially."""
    applied = {}
    h2d = profile.get("h2d_ms_by_mb") or {}
    if "0.001" in h2d:
        applied["h2d_call_s"] = float(h2d["0.001"]) / 1e3
    sizes = sorted((float(mb), float(ms)) for mb, ms in h2d.items()
                   if float(mb) >= 1)
    if len(sizes) >= 2:
        (mb0, ms0), (mb1, ms1) = sizes[0], sizes[-1]
        if ms1 > ms0:
            applied["h2d_bytes_per_s"] = ((mb1 - mb0) * 1e6
                                          / ((ms1 - ms0) / 1e3))
    if "d2h_512B_ms" in profile:
        applied["d2h_call_s"] = float(profile["d2h_512B_ms"]) / 1e3
    if "tiny_dispatch_plus_readback_ms" in profile:
        total = float(profile["tiny_dispatch_plus_readback_ms"]) / 1e3
        applied["dispatch_fixed_s"] = max(
            total - applied.get("d2h_call_s", _LINK["d2h_call_s"]), 1e-4)
    calibrate(**applied)
    return applied


# apply_host engages the vectorized bulk build from this many changes per
# document (the reference's threshold: below it the no-diff interpretive
# apply, O(ops) with one end-of-batch RGA linearization, ties or wins).
HOST_BULK_MIN_CHANGES = 24576


@dataclass
class Plan:
    backend: str          # "device" | "host"
    est_device_s: float
    est_host_s: float


def _device_cost(wire_bytes: int, passes: int = 1) -> float:
    """One dispatch shipping `wire_bytes`, its fixed legs amortized over
    `passes` identical jobs."""
    return (_LINK["dispatch_fixed_s"] / passes
            + _LINK["h2d_call_s"]
            + wire_bytes / _LINK["h2d_bytes_per_s"]
            + _LINK["d2h_call_s"] / passes)


def plan_batch(n_docs: int, n_ops: int, wire_bytes: int,
               passes: int = 1, changes_per_doc: float | None = None) -> Plan:
    """Choose the backend for a from-scratch batch apply of `n_docs`
    documents totalling `n_ops` ops, shipping `wire_bytes` per pass,
    with fixed costs amortized over `passes` identical jobs.

    `changes_per_doc` prices the host side with the same predicate
    apply_host executes (bulk build from HOST_BULK_MIN_CHANGES changes a
    doc); when unknown it is estimated at n_ops/n_docs/2 (ins+set pairs)."""
    dev = _device_cost(wire_bytes, passes)
    if changes_per_doc is None:
        changes_per_doc = n_ops / max(n_docs, 1) / 2
    if changes_per_doc >= HOST_BULK_MIN_CHANGES:
        host = n_docs * _LINK["bulk_fixed_s"] + n_ops * _LINK["bulk_op_s"]
    else:
        host = n_ops * _LINK["host_op_s"]
    return Plan("device" if dev < host else "host", dev, host)


def plan_for(doc_changes: list, passes: int = 1) -> Plan:
    """Plan (no execution) for a concrete from-scratch batch: estimates the
    wire from the padded dims pack.py uses, and prices the host side per
    document with apply_host's bulk/interpretive predicate. The plan also
    carries those dims (`plan.dims`) for the dispatch ledger."""
    def _pad(n, minimum=8):
        p = minimum
        while p < n:
            p *= 2
        return p

    max_ops = 1
    max_ins = 1
    actors: set = set()
    host = 0.0
    for chs in doc_changes:
        doc_ops = 0
        doc_ins = 0
        for c in chs:
            doc_ops += len(c.ops)
            for o in c.ops:
                if o.action == "ins":
                    doc_ins += 1
            actors.add(c.actor)
        max_ops = max(max_ops, doc_ops)
        max_ins = max(max_ins, doc_ins)
        if len(chs) >= HOST_BULK_MIN_CHANGES:  # apply_host's predicate
            host += _LINK["bulk_fixed_s"] + doc_ops * _LINK["bulk_op_s"]
        else:
            host += doc_ops * _LINK["host_op_s"]
    ops_pad = _pad(max_ops)
    ins_pad = _pad(max_ins)
    d_pad = pad_to_lanes(len(doc_changes))
    wire_bytes = (rows_count(ops_pad, max(len(actors), 1), ins_pad)
                  * d_pad * 4)
    dev = _device_cost(wire_bytes, passes)
    plan = Plan("device" if dev < host else "host", dev, host)
    plan.dims = {"docs": (len(doc_changes), d_pad),
                 "ops": (max_ops, ops_pad), "ins": (max_ins, ins_pad)}
    return plan


def _causal_order(changes):
    """Stable causal (re)ordering of a complete change list. Returns the
    input unchanged when it is already causally ordered (one O(n) clock
    pass), a stably reordered copy when a causal order exists, or None when
    none does (missing deps, duplicate or gapped seqs): the interpretive
    path owns those semantics (causal queueing, seq-reuse errors).

    The bulk build requires application order, and get_missing_changes
    emits per-actor runs whose deps point across runs. The reorder is a
    Kahn walk over per-actor chains with dep wait-heaps: O(n + deps log)
    even on logs whose per-actor runs interleave change by change."""
    import heapq
    from collections import defaultdict, deque

    clock: dict[str, int] = {}
    for c in changes:
        if c.seq != clock.get(c.actor, 0) + 1 or any(
                clock.get(a, 0) < s for a, s in c.deps.items()):
            break
        clock[c.actor] = c.seq
    else:
        return changes

    chains: dict[str, list] = defaultdict(list)
    for c in changes:
        chains[c.actor].append(c)
    for chain in chains.values():
        chain.sort(key=lambda c: c.seq)
        if [c.seq for c in chain] != list(range(1, len(chain) + 1)):
            return None  # duplicate or gapped seqs: interpretive semantics

    clock = {}
    ptr = {a: 0 for a in chains}
    # waiting[a]: heap of (dep_seq, blocked_actor), actors whose chain
    # head needs clock[a] >= dep_seq before it can advance
    waiting: dict[str, list] = defaultdict(list)
    ready = deque(chains)
    out: list = []
    while ready:
        a = ready.popleft()
        chain = chains[a]
        while ptr[a] < len(chain):
            c = chain[ptr[a]]
            unmet = next(((da, ds) for da, ds in c.deps.items()
                          if clock.get(da, 0) < ds), None)
            if unmet is not None:
                heapq.heappush(waiting[unmet[0]], (unmet[1], a))
                break
            out.append(c)
            clock[a] = c.seq
            ptr[a] += 1
            w = waiting.get(a)
            while w and w[0][0] <= clock[a]:
                ready.append(heapq.heappop(w)[1])
    if len(out) != len(changes):
        return None  # some dep is outside the log: no causal order exists
    return out


def apply_host(changes, actor_id: str = "engine", device="cuda"):
    """Host-path from-scratch apply of one document's complete change set:
    the bulk build when the log is big enough and eligible, else the
    interpretive replay, the OpSet on `device` (its move realms resolve
    there). Returns the materialized document."""
    from ..api import init
    from ..core.bulkload import try_bulk_build
    from ..frontend.materialize import apply_changes_to_doc, materialize_root
    from ..native.wire import changes_to_columns

    if len(changes) >= HOST_BULK_MIN_CHANGES:
        ordered = _causal_order(changes)
        if ordered is not None:
            opset = try_bulk_build(changes_to_columns(ordered), device)
            if opset is not None:
                metrics.bump("engine_bulk_built")
                return materialize_root(actor_id, opset)
    doc = init(actor_id, device)
    # no-diff apply: a from-scratch load has no diff consumer
    return apply_changes_to_doc(doc, doc._doc.opset, list(changes),
                                incremental=False, emit_diffs=False)


def apply_batch_adaptive(doc_changes: list, passes: int = 1, device="cuda"):
    """Route a from-scratch DocSet batch through the cheaper backend.

    Returns (plan, result): a list of materialized documents on the host
    route (apply_host, the OpSet on `device`), or the per-doc state hashes
    (np.uint32) on the device route (batchdoc.apply_batch on `device`; its
    readable-state decode is on demand, batchdoc.decode_doc)."""
    from .batchdoc import apply_batch

    dev = resolve_device(device)
    plan = plan_for(doc_changes, passes)
    with metrics.trace("engine_dispatch", backend=plan.backend), \
            dispatchledger.call_scope("apply", plan=plan,
                                      docs=len(doc_changes),
                                      axes=plan.dims):
        if plan.backend == "host":
            return plan, [apply_host(chs, device=dev) for chs in doc_changes]
        _encs, _batch, out = apply_batch(doc_changes, device=dev)
        return plan, hashes_to_numpy(out["hash"])


def plan_spans(n_docs: int, s_pad: int) -> Plan:
    """Backend plan for a batched span-table merge of `n_docs` documents
    whose span axis padded to `s_pad` lanes: the wire is the packed
    [D, F, S_pad] block; the host alternative is merge_spans_host."""
    from .pack import SPAN_FIELDS

    wire_bytes = n_docs * len(SPAN_FIELDS) * s_pad * 4
    dev = _device_cost(wire_bytes)
    host = _LINK["span_fixed_s"] + n_docs * s_pad * _LINK["span_op_s"]
    return Plan("device" if dev < host else "host", dev, host)


def merge_spans_adaptive(doc_spans: list, device="cuda"):
    """Route a batched span-table merge through the cheaper backend: the
    numpy host merge, or span_kernels.merge_spans on `device`. Returns
    (plan, result dict)."""
    from .pack import pack_spans
    from .span_kernels import merge_spans, merge_spans_host

    dev = resolve_device(device)
    spans = pack_spans(doc_spans)
    plan = plan_spans(spans.shape[0], spans.shape[2])
    if plan.backend == "host":
        return plan, merge_spans_host(spans)
    return plan, merge_spans(torch.from_numpy(spans).to(dev))


def result_to_numpy(out: dict) -> dict:
    """A span-merge or move-resolution result from either route as numpy
    arrays in the host route's schema (hash as np.uint32)."""
    res = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
               else np.asarray(v)) for k, v in out.items()}
    res["hash"] = res["hash"].view(np.uint32)
    return res


def plan_moves(n_docs: int, n_pad: int, k_pad: int) -> Plan:
    """Backend plan for a batched move resolution of `n_docs` realms
    padded to `n_pad` node / `k_pad` candidate lanes: the wire is the two
    packed lane blocks; the host alternative is resolve_moves_host."""
    from .pack import MOVE_CAND_FIELDS, MOVE_NODE_FIELDS

    wire_bytes = n_docs * (len(MOVE_NODE_FIELDS) * n_pad
                           + len(MOVE_CAND_FIELDS) * k_pad) * 4
    dev = _device_cost(wire_bytes)
    host = (_LINK["move_fixed_s"]
            + n_docs * (n_pad + k_pad) * _LINK["move_lane_s"])
    return Plan("device" if dev < host else "host", dev, host)


def resolve_moves_adaptive(packed: dict, device="cuda"):
    """Route a batched move resolution through the cheaper backend: the
    numpy host fixpoint, or move_kernels.resolve_moves on `device`.
    Returns (plan, result dict)."""
    from .move_kernels import resolve_moves, resolve_moves_host

    dev = resolve_device(device)
    nodes = packed["nodes"]
    plan = plan_moves(nodes.shape[0], nodes.shape[2],
                      packed["cands"].shape[2])
    if plan.backend == "host":
        return plan, resolve_moves_host(packed)
    return plan, resolve_moves(
        torch.from_numpy(np.ascontiguousarray(nodes, np.int32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(packed["cands"], np.int32))
        .to(dev))


# ---------------------------------------------------------------------------
# Megabatch round planning: the dirty lanes of a rows-engine hash read
# reconciled in at most pack.MEGA_MAX_BUCKETS fused launches, each at its
# bucket's dims (pack.plan_megabuckets). plan_round prices the route
# against the narrow gather the engine does otherwise, with this card's
# constants; apply_round_adaptive runs it. The reference also routes
# round frames (its megabatch intent); the port does not: on this card
# one reconcile of the whole resident buffer (0.12 ms for the map
# storm's 209 MB on an H100) costs less than the route's host work.
#
# The port keeps the device copy of the row buffer resident: where it is
# current, a bucket is gathered from it on the device (one index upload for
# every bucket, a gather and a reconcile launch per bucket); only where it
# is stale (after growth, under lazy dispatch) does a bucket come from the
# host mirror, uploaded, as the reference gathers every bucket. Either way
# all buckets' hashes come back in one readback.

_megabatch: bool | None = None
_megabatch_min: int | None = None


def megabatch_enabled() -> bool:
    """AMTPU_MEGABATCH != "0" (default on). Read once and cached;
    `_reload_for_tests` drops the cache."""
    global _megabatch
    if _megabatch is None:
        _megabatch = os.environ.get("AMTPU_MEGABATCH", "1") != "0"
    return _megabatch


def megabatch_min_docs() -> int:
    """Routing threshold (AMTPU_MEGABATCH_MIN_DOCS, default 2): rounds
    dirtying fewer docs stay on the per-doc path."""
    global _megabatch_min
    if _megabatch_min is None:
        try:
            _megabatch_min = max(
                int(os.environ.get("AMTPU_MEGABATCH_MIN_DOCS", "2")), 1)
        except ValueError:
            _megabatch_min = 2
    return _megabatch_min


def _reload_for_tests() -> None:
    global _megabatch, _megabatch_min
    _megabatch = None
    _megabatch_min = None


@dataclass
class RoundPlan:
    route: str                      # "megabatch" | "per_doc"
    docs: np.ndarray = field(       # doc indices, sorted (unique on the
        default_factory=lambda: np.zeros(0, np.int64))  # megabatch route)
    buckets: list = field(default_factory=list)  # pack.plan_megabuckets
    est_mega_s: float = 0.0
    est_alt_s: float = 0.0


def _upload_s(nbytes: int) -> float:
    return _LINK["h2d_call_s"] + nbytes / _LINK["h2d_bytes_per_s"]


def _reconcile_s(nbytes: int) -> float:
    """One reconcile launch over a row buffer of nbytes on the device."""
    return _LINK["launch_s"] + nbytes / _LINK["dev_bytes_per_s"]


def _resident(rset) -> bool:
    return rset.rows_dev is not None and not rset._dirty


def plan_round(rset, idxs) -> RoundPlan:
    """Route the dirty docs `idxs` of a ResidentRowsDocSet's hash read
    (a minority of the fleet): bucket their used sizes and price the fused
    bucketed launches against the narrow gather. Returns a RoundPlan whose
    buckets apply_round_adaptive runs. Never plans with AMTPU_MEGABATCH=0
    or below the doc floor.

    Estimates, from _LINK:
    - the route: its host work (mega_fixed_s, and mega_doc_s a doc: the
      bucket planning and the bookkeeping around the launches); per
      bucket, a gather and a reconcile at the bucket's dims (from the
      resident copy: two launches, the bucket's bytes read and written,
      then read; from a stale copy: the host gather and its upload, one
      launch); one upload of every bucket's indices when the copy is
      resident; one readback;
    - the alternative: the narrow lane gather at full dims from the host
      mirror, its upload, one reconcile and one readback
      (_reconcile_lanes).

    The route's legs that need no buckets are priced first, from the doc
    count alone: where they cost more than the alternative, the plan is
    per-doc with no buckets and est_mega_s is that lower bound (the docs
    are neither sorted nor sized)."""
    idxs = np.asarray(idxs, np.int64)
    if not megabatch_enabled() or len(idxs) < megabatch_min_docs():
        return RoundPlan("per_doc", idxs)
    dims_i, a, dims_le = rset.dims()[:3]
    resident = _resident(rset)
    nbytes = rows_count(dims_i, a, dims_le) * 4 * pad_to_lanes(len(idxs))
    est_alt = (nbytes / _LINK["host_gather_bytes_per_s"]
               + _upload_s(nbytes) + _reconcile_s(nbytes)
               + _LINK["d2h_call_s"])
    # the legs every bucketing shares: host work and the readback
    est_mega = (_LINK["mega_fixed_s"] + len(idxs) * _LINK["mega_doc_s"]
                + _LINK["d2h_call_s"])
    bound = (est_mega + _LINK["h2d_call_s"]
             + _LINK["launch_s"] * (2 if resident else 1))
    if bound > est_alt:
        metrics.bump("engine_megabatch_fallbacks")
        return RoundPlan("per_doc", idxs, [], bound, est_alt)
    idxs = np.unique(idxs)
    i_used, l_used = rset._mega_doc_sizes(idxs)
    buckets = plan_megabuckets(i_used, l_used, (dims_i, a, dims_le),
                               rset.cap_elems)
    index_bytes = 0
    for b in buckets:
        k_pad = pad_to_lanes(len(b["docs"]))
        rows_b = rows_count(b["dims"][0], a, b["dims"][1])
        nbytes = rows_b * k_pad * 4
        if resident:
            est_mega += (_LINK["launch_s"]
                         + 2 * nbytes / _LINK["dev_bytes_per_s"]
                         + _reconcile_s(nbytes))
            index_bytes += (rows_b + k_pad) * 8
        else:
            est_mega += (nbytes / _LINK["host_gather_bytes_per_s"]
                         + _upload_s(nbytes) + _reconcile_s(nbytes))
    if index_bytes:
        est_mega += _upload_s(index_bytes)
    if est_mega <= est_alt:
        return RoundPlan("megabatch", idxs, buckets, est_mega, est_alt)
    metrics.bump("engine_megabatch_fallbacks")
    return RoundPlan("per_doc", idxs, buckets, est_mega, est_alt)


@functools.lru_cache(maxsize=64)
def _row_map(dims_i: int, a: int, dims_le: int, i_b: int,
             le_b: int) -> np.ndarray:
    """mega_row_map, computed once per shape (read-only)."""
    rmap = mega_row_map(dims_i, a, dims_le, i_b, le_b)
    rmap.setflags(write=False)
    return rmap


def apply_round_adaptive(rset, plan: RoundPlan):
    """Run a megabatch-routed RoundPlan on a ResidentRowsDocSet: per bucket,
    ONE reconcile launch over a [rows(bucket dims), k_pad] sub-buffer of the
    same lanes (pack.mega_row_map's subset property makes the hashes
    bit-identical to the full buffer's), gathered from the resident device
    copy when it is current, else from the host mirror. Padding lanes
    repeat the bucket's last doc (a zero column is not a valid doc). All
    buckets' hashes come back in one readback into the host hash mirror,
    and their docs leave the dirty set. The device copy is never dropped.

    Returns the round's occupancy summary, or None when the plan routed
    per-doc (the caller takes its classic path)."""
    if plan is None or plan.route != "megabatch" or not plan.buckets:
        return None
    dims_i, a, dims_le, a_set, a_del = rset.dims()
    mirror = rset._ensure_hash_mirror()
    idxs = plan.docs
    resident = _resident(rset)
    parts = []
    for b in plan.buckets:
        docs = idxs[b["docs"]]
        k = len(docs)
        k_pad = pad_to_lanes(k)
        i_b, le_b = b["dims"]
        rmap = _row_map(dims_i, a, dims_le, i_b, le_b)
        sel = np.concatenate([docs, np.full(k_pad - k, docs[-1], np.int64)])
        parts.append((docs, k_pad, (i_b, a, le_b, a_set, a_del), rmap, sel))
    if resident:
        # every bucket's row map and lane selection in one upload
        flat = rset._to_dev(np.concatenate(
            [x for p in parts for x in (p[3], p[4])]))
    outs = []
    logical = padded = docs_cap = off = 0
    for docs, k_pad, dims, rmap, sel in parts:
        k, rows_b = len(docs), len(rmap)
        with perfscope.phase("pack"):
            if resident:
                rows_t = flat[off:off + rows_b]
                lanes_t = flat[off + rows_b:off + rows_b + k_pad]
                off += rows_b + k_pad
                # one gather kernel, no [rows_b, n_pad] or [ROWS, k_pad]
                # intermediate
                sub = rset.rows_dev[rows_t[:, None], lanes_t]
            else:
                sub = rset._to_dev(rset.rows_host[np.ix_(rmap, sel)])
        with dispatchledger.call_scope(
                "rows_mega", backend="device", docs=k,
                axes={"docs": (k, k_pad), "rows": (rows_b, rows_b)}):
            outs.append(reconcile_rows_hash(sub, dims)[:k])
        logical += rows_b * k
        padded += rows_b * k_pad
        docs_cap += k_pad
    with perfscope.phase("readback"):
        vals = hashes_to_numpy(outs[0] if len(outs) == 1
                               else torch.cat(outs))
    done = (parts[0][0] if len(parts) == 1
            else np.concatenate([p[0] for p in parts]))
    mirror[done] = vals
    rset._doc_dirty.difference_update(done.tolist())
    nb = len(parts)
    n_docs = len(idxs)
    summary = {
        "buckets": nb,
        "docs": n_docs,
        "dispatches": nb,
        "docs_cap": docs_cap,
        "logical": logical,
        "padded": padded,
        "docs_per_dispatch": round(n_docs / nb, 4),
        "fill_pct": round(100.0 * n_docs / docs_cap, 3),
        "pad_waste_pct": round(100.0 * (1.0 - logical / padded), 3),
    }
    metrics.bump("engine_megabatch_rounds")
    metrics.bump("engine_megabatch_docs", n_docs)
    dispatchledger.note_megabatch(summary)
    return summary
