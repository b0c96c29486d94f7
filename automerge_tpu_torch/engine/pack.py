"""The batch wire formats of `automerge_tpu/engine/pack.py`.

The packed docs-major format (`pack_batch`): a whole stacked batch
(encode.stack_docs) flattened into ONE int32 buffer plus a static meta
header, so a batch crosses to the device in one copy and `apply_packed`
unpacks it there as views.

The docs-minor row format (`pack_rows`): one int32 [ROWS, D_pad] buffer
holds a whole batch, documents on the minor (lane) axis, every logical
column a static row range. It is the native layout of the fused reconcile
kernel (`cuda_kernels.reconcile_rows_hash`) and of the resident rows
engine.

Both are byte-for-byte the reference's formats, so a buffer packed by
either package feeds the other.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .encode import A_DEL, A_SET

# Field order of the packed docs-major buffer: the wire contract.
FIELDS = ("op_mask", "action", "fid", "actor", "seq", "change_idx", "value",
          "fid_hash", "value_hash", "clock", "ins_mask", "ins_elem",
          "ins_actor", "ins_parent", "ins_fid", "ins_pos", "list_obj",
          "list_obj_hash", "actor_hash")


def pack_batch(batch: dict) -> tuple[np.ndarray, tuple]:
    """Flatten a stacked batch into (flat int32 buffer, static meta). meta
    is a hashable tuple of (name, offset, shape, is_bool) entries."""
    parts = []
    meta = []
    offset = 0
    for name in FIELDS:
        arr = np.asarray(batch[name])
        flat = arr.astype(np.int32).ravel()
        meta.append((name, offset, arr.shape, arr.dtype == np.bool_))
        parts.append(flat)
        offset += flat.size
    return np.concatenate(parts), tuple(meta)


def unpack_batch(flat: torch.Tensor, meta: tuple) -> dict:
    """The batch dict of a packed buffer (a 1-D int32 tensor): each field a
    view of `flat` in its shape, bool fields converted."""
    out = {}
    for name, offset, shape, is_bool in meta:
        size = int(np.prod(shape))
        arr = flat[offset:offset + size].view(shape)
        out[name] = arr.bool() if is_bool else arr
    return out


def apply_packed(flat: torch.Tensor, meta: tuple, max_fids: int,
                 host_order: bool = True) -> dict:
    """Full reconcile over a packed batch (every output of
    kernels.apply_doc), on the device of `flat`, the packed buffer as a
    1-D int32 tensor."""
    from .kernels import apply_doc
    return apply_doc(unpack_batch(flat, meta), max_fids, host_order)


def apply_packed_hash(flat: torch.Tensor, meta: tuple, max_fids: int,
                      host_order: bool = True) -> torch.Tensor:
    """One reconcile pass over a packed batch, returning only the per-doc
    state hashes ([D] int32 holding the uint32 bits)."""
    return apply_packed(flat, meta, max_fids, host_order)["hash"]


# The docs axis of every docs-minor layout pads to a multiple of this (the
# reference's TPU lane width; kept so both packages agree on buffer shapes).
LANE = 128


def pad_to_lanes(n: int) -> int:
    """Round a doc count up to the lane width (docs-minor layouts)."""
    return ((n + LANE - 1) // LANE) * LANE


# Row-buffer column groups, in wire order. `clock_op` is each op's own
# change-clock row (actor-major), so the kernel never indexes by change id;
# `elem_list` is the owning-list row per element slot (a static pattern).
ROW_FIELDS = ("op_mask", "action", "fid", "actor", "seq", "change_idx",
              "fid_hash", "value_hash", "clock_op", "ins_mask", "ins_fid",
              "ins_pos", "elem_objhash", "elem_list", "actor_hash")

# The reference's per-doc dims envelope, kept numerically identical so that
# RowsBudgetError fires for exactly the batches the reference rejects. The
# numbers model the TPU kernel's on-chip working set (in units of 128-lane
# int32 rows); the CUDA kernel has no such limit, and re-deriving the
# envelope for the GPU is later work (ROADMAP.md).
ROWS_MAX_OPS = 1024
ROWS_MAX_ELEMS = 1024
ROWS_VMEM_BUDGET = 22528


def rows_count(i: int, a: int, le: int) -> int:
    """Row count of the docs-minor layout (the buffer holds
    rows_count * d_pad int32 values)."""
    return 8 * i + a * i + 5 * le + a


def row_bases(i: int, a: int, le: int) -> dict:
    """Row offsets of each ROW_FIELDS group — the one definition of the
    layout, shared by the kernel wrappers and the resident rows mirror. The
    trailing "ah" band is the rank -> actor content hash table the state
    hash mixes."""
    co = 8 * i
    return {
        "om": 0, "ac": i, "fid": 2 * i, "act": 3 * i, "seq": 4 * i,
        "chg": 5 * i, "fh": 6 * i, "vh": 7 * i, "co": co,
        "im": co + a * i, "if": co + a * i + le, "ip": co + a * i + 2 * le,
        "io": co + a * i + 3 * le, "il": co + a * i + 4 * le,
        "ah": co + a * i + 5 * le,
        "rows": co + a * i + 5 * le + a,
    }


def rows_dims_eligible(i: int, a: int, le: int) -> bool:
    """Whether per-doc dims (ops, actors, list-element slots) sit inside the
    base envelope. I and LE must be multiples of 8 — encode._pad_to
    guarantees this for in-repo producers; external callers must pad."""
    working = rows_count(i, a, le) + 24 * max(i, le) + 3 * i + 2 * le
    return (i % 8 == 0 and le % 8 == 0
            and i <= ROWS_MAX_OPS and le <= ROWS_MAX_ELEMS
            and working <= ROWS_VMEM_BUDGET)


def pack_rows(batch: dict, max_fids: int) -> tuple[np.ndarray, tuple, int]:
    """Repack a stacked batch (docs-major dict of encode.stack_docs) into
    the docs-minor [ROWS, D_pad] int32 row buffer + static dims.

    Returns (rows, dims, n_docs). D_pad rounds the doc count up to a
    multiple of LANE; padded docs hash to garbage and are sliced off.
    `max_fids` is accepted for the reference's signature: field ids are
    joined by equality, so the field count never shapes the buffer.
    """
    d, i = batch["op_mask"].shape
    c, a = batch["clock"].shape[1:]
    l, e = batch["ins_mask"].shape[1:]
    d_pad = pad_to_lanes(d)

    def rowify(arr, fill=0):
        """[d, ...] -> [prod(...), d_pad] int32, docs minor."""
        arr = np.asarray(arr).astype(np.int32)
        flat = arr.reshape(d, -1).T
        if d_pad > d:
            flat = np.pad(flat, ((0, 0), (0, d_pad - d)),
                          constant_values=fill)
        return flat

    # per-op clock rows: clock_op[d, i, a] = clock[d, change_idx[d, i], a],
    # then actor-major [d, a, i] so each actor's band is a contiguous range
    chg = np.clip(np.asarray(batch["change_idx"]), 0, c - 1)
    clock_op = np.take_along_axis(
        np.asarray(batch["clock"]),
        chg[:, :, None].astype(np.int64), axis=1)          # [d, i, a]
    clock_op_am = np.moveaxis(clock_op, 2, 1)              # [d, a, i]

    elem_objhash = np.broadcast_to(
        np.asarray(batch["list_obj_hash"])[:, :, None], (d, l, e))
    elem_list = np.broadcast_to(
        np.arange(l, dtype=np.int32)[None, :, None], (d, l, e))
    parts = [
        rowify(batch["op_mask"]), rowify(batch["action"], -1),
        rowify(batch["fid"], -1), rowify(batch["actor"]),
        rowify(batch["seq"]), rowify(batch["change_idx"]),
        rowify(batch["fid_hash"]), rowify(batch["value_hash"]),
        rowify(clock_op_am), rowify(batch["ins_mask"]),
        rowify(batch["ins_fid"], -1), rowify(batch["ins_pos"]),
        rowify(elem_objhash, -1), rowify(elem_list, -1),
        rowify(batch["actor_hash"]),
    ]
    rows = np.concatenate(parts, axis=0)
    dims = (i, a, l * e, int(A_SET), int(A_DEL))
    return rows, dims, d


def rows_from_numpy(rows: np.ndarray, dims: tuple,
                    device="cuda") -> torch.Tensor:
    """A row buffer packed by either package (numpy [ROWS, D_pad] int32) as
    the port's device state: a contiguous int32 tensor on `device` (a copy;
    the caller's array is never aliased)."""
    i, a, le = dims[:3]
    rows = np.asarray(rows)
    if rows.dtype != np.int32 or rows.ndim != 2:
        raise ValueError(f"row buffer must be 2-D int32, got "
                         f"{rows.dtype} {rows.shape}")
    if rows.shape[0] != rows_count(i, a, le) or rows.shape[1] % LANE:
        raise ValueError(f"row buffer shape {rows.shape} does not match dims "
                         f"{dims} (rows {rows_count(i, a, le)}, lanes a "
                         f"multiple of {LANE})")
    return torch.from_numpy(np.ascontiguousarray(rows)).to(
        resolve_device(device), copy=True)


def apply_rows_hash(rows: torch.Tensor, dims: tuple,
                    n_docs: int) -> torch.Tensor:
    """Per-doc state hashes of a row buffer ([n_docs] int32 holding the
    uint32 bits), through the CUDA kernel for a CUDA tensor or its plain
    version for a CPU one."""
    from .cuda_kernels import reconcile_rows_hash
    return reconcile_rows_hash(rows, dims)[:n_docs]


# ---------------------------------------------------------------------------
# Megabatch buckets: a round's dirty documents reconciled at smaller dims
#
# Documents share lanes in the docs-minor buffer but not shape: one 16-op
# doc in a fleet grown to I = 1,024 pays the whole 1,024-row band. A
# smaller-dims (I', A, L'*E) layout is a pure ROW-INDEX SUBSET of the full
# (I, A, L*E) layout for the same lanes, provided the elem-slot stride E is
# kept (whole lists only):
#
#   op bands        rows g + [0, I')           per op group g
#   clock band      rows co + a*I + [0, I')    per actor a (strided)
#   elem bands      rows g + [0, L'*E)         per elem group g
#   ah band         all A rows
#
# Every band is lane-independent in the kernel (cuda_kernels.
# reconcile_rows_hash: one output per lane), op and elem rows join only
# within their own band ranges, and unused rows (op_mask = 0, ins_mask = 0)
# add nothing to the hash. So hashing the subset buffer at dims
# (I', A, L'*E) is BIT-IDENTICAL to hashing the full buffer, for any
# I' >= ops used and L' >= lists used of every selected lane. Ragged
# per-doc sizes are bucketed onto a power-of-two ladder, so a round runs at
# most MEGA_MAX_BUCKETS kernel shapes; each bucket carries its doc-position
# table, so unpacking the per-doc hashes is exact.

#: distinct bucket shapes a megabatched round may have (the cap on its
#: launches)
MEGA_MAX_BUCKETS = 4
#: smallest quantized op / list band (the kernel's join block height)
MEGA_MIN_DIM = 8


def mega_quantize(n: int, cap: int) -> int:
    """Power-of-two ladder from MEGA_MIN_DIM up to (and clamped at) cap.
    cap need not be a power of two: the top rung is the fleet dimension."""
    q = MEGA_MIN_DIM
    while q < n:
        q *= 2
    return min(q, cap)


def mega_bucket_dims(i_used: int, l_used: int, caps: tuple,
                     e: int) -> tuple:
    """Quantized (i_b, le_b) bucket dims of one doc's used sizes under the
    fleet caps (I, A, LE). Elem slots subset at LIST granularity only
    (le_b = l_b * e keeps the slot stride), and both dims stay multiples of
    the join block height; where that cannot be met the dimension is the
    fleet's."""
    i_cap, _a, le_cap = caps
    i_b = mega_quantize(max(int(i_used), 1), i_cap)
    if i_b % 8:
        i_b = i_cap
    if le_cap == 0 or e == 0:
        return i_b, 0
    l_cap = le_cap // e
    l_b = mega_quantize(max(int(l_used), 1), l_cap) if l_used else 0
    while l_b < l_cap and (l_b * e) % 8:
        l_b *= 2
    le_b = min(l_b * e, le_cap)
    if le_b % 8:
        le_b = le_cap
    return i_b, le_b


def mega_row_map(i: int, a: int, le: int, i_b: int,
                 le_b: int) -> np.ndarray:
    """Row indices into the full (i, a, le) docs-minor buffer that gather a
    valid (i_b, a, le_b) buffer of the SAME doc lanes (the subset property
    above). Its length is rows_count(i_b, a, le_b); row_bases is the one
    layout definition on both sides."""
    src = row_bases(i, a, le)
    ops = np.arange(i_b, dtype=np.int64)
    elems = np.arange(le_b, dtype=np.int64)
    parts = [src[g] + ops
             for g in ("om", "ac", "fid", "act", "seq", "chg", "fh", "vh")]
    parts.extend(src["co"] + aa * i + ops for aa in range(a))
    parts.extend(src[g] + elems for g in ("im", "if", "ip", "io", "il"))
    parts.append(src["ah"] + np.arange(a, dtype=np.int64))
    out = np.concatenate(parts)
    assert len(out) == rows_count(i_b, a, le_b)
    return out


def plan_megabuckets(i_used, l_used, caps: tuple, e: int) -> list[dict]:
    """Bucket a round's docs by quantized shape: positions p group under
    mega_bucket_dims(i_used[p], l_used[p]). Past MEGA_MAX_BUCKETS distinct
    shapes, the smallest padded volume merges into its cheapest superset
    (a doc hashes identically at any dims >= its used sizes, so merging
    adds padding, never error).

    Returns [{"dims": (i_b, le_b), "docs": int64 positions}], largest
    bucket first. The shapes are keyed in the order of their first doc, as
    the reference's per-doc loop keys them (ties in size keep that order);
    the dims are computed once per distinct (i_used, l_used) pair."""
    i_used = np.asarray(i_used, np.int64)
    l_used = np.asarray(l_used, np.int64)
    groups: dict[tuple, np.ndarray] = {}
    if len(i_used):
        uniq, first, inv = np.unique((i_used << 32) | l_used,
                                     return_index=True, return_inverse=True)
        key_of = [mega_bucket_dims(int(u >> 32), int(u & 0xFFFFFFFF), caps,
                                   e) for u in uniq]
        key_id: dict[tuple, int] = {}
        pos_key = np.asarray([key_id.setdefault(k, len(key_id))
                              for k in key_of])[inv.reshape(-1)]
        for u in np.argsort(first, kind="stable"):
            key = key_of[u]
            if key not in groups:
                groups[key] = np.flatnonzero(pos_key == key_id[key])
    a_rows = caps[1]
    while len(groups) > MEGA_MAX_BUCKETS:
        small = min(groups, key=lambda k: (rows_count(k[0], a_rows, k[1])
                                           * len(groups[k])))
        members = groups.pop(small)
        best = min(groups,
                   key=lambda k: rows_count(max(k[0], small[0]), a_rows,
                                            max(k[1], small[1])))
        merged = (max(best[0], small[0]), max(best[1], small[1]))
        members = np.concatenate([members, groups.pop(best)])
        groups[merged] = (np.concatenate([groups[merged], members])
                          if merged in groups else members)
    out = [{"dims": k, "docs": np.sort(v)} for k, v in groups.items()]
    out.sort(key=lambda b: -len(b["docs"]))
    return out


# ---------------------------------------------------------------------------
# Span-table lane layout (the batched text-merge plane's wire shape)
#
# Per document, one int32 [len(SPAN_FIELDS), S_pad] block with the span
# axis minor, so a fleet of divergent documents merges as one
# [D, F, S_pad] dispatch. Merge-order encoding (span_kernels sorts by it):
#   slot       2*i for the i-th span of the base (common-history) table,
#              2*g+1 for a concurrent span anchored in the gap after base
#              span g (-1 for the head gap);
#   prio_elem/prio_actor  RGA sibling priority of the span's head element,
#              concurrent spans in one gap order by it DESCENDING;
#   block_seq  ascending tiebreak keeping one side's flattened subtree
#              block contiguous and in its side-local order.

SPAN_FIELDS = ("span_mask", "origin_hash", "start_id", "vis_len", "slot",
               "prio_elem", "prio_actor", "block_seq")


def pack_spans(doc_spans: list) -> np.ndarray:
    """Pack per-document span tables into [D, len(SPAN_FIELDS), S_pad]
    int32 lanes. Each span is an (origin_hash, start_id, vis_len, slot,
    prio_elem, prio_actor, block_seq) tuple; the mask row is synthesized.
    The span axis pads to the lane width (pad_to_lanes); padded slots are
    all zero and mask out."""
    d = len(doc_spans)
    s_max = max((len(sp) for sp in doc_spans), default=0)
    s_pad = pad_to_lanes(max(s_max, 1))
    out = np.zeros((d, len(SPAN_FIELDS), s_pad), np.int32)
    for i, spans in enumerate(doc_spans):
        if not spans:
            continue
        arr = np.asarray(spans, np.int64).T  # [7, s]
        if arr.shape[0] != len(SPAN_FIELDS) - 1:
            raise ValueError(
                f"span tuples must have {len(SPAN_FIELDS) - 1} columns "
                f"({SPAN_FIELDS[1:]}), got {arr.shape[0]}")
        out[i, 0, :arr.shape[1]] = 1
        out[i, 1:, :arr.shape[1]] = arr.astype(np.int32)
    return out


# ---------------------------------------------------------------------------
# Move-resolution tables: one realm (core/moves.MoveProblem) packs into two
# lane blocks,
#
#   nodes [D, 4, N_pad]:  mask, base_parent_slot (-1 root), cand_off,
#                         cand_cnt
#   cands [D, 3, K_pad]:  parent_slot, prio_hi, prio_lo
#
# Candidates are sorted per node by priority DESCENDING and concatenated in
# node-slot order (cand_off/cand_cnt index the runs), so a node's current
# winner is one gather at cand_off + ptr. Both priority components are
# RANK-compressed within the realm: integer compares reproduce the host
# tuple order exactly, priorities stay unique (the cycle-drop rule needs
# it), and no rank can reach the MOVE_PRIO_PAD sentinel.

MOVE_NODE_FIELDS = ("node_mask", "base_parent", "cand_off", "cand_cnt")
MOVE_CAND_FIELDS = ("cand_parent", "cand_hi", "cand_lo")
MOVE_PRIO_PAD = np.iinfo(np.int32).max


def pack_moves(problems: list) -> dict:
    """Pack MoveProblems into the move-resolution lane layout. Returns
    {"nodes": [D, 4, N_pad] int32, "cands": [D, 3, K_pad] int32}."""
    d = len(problems)
    n_max = max((len(p.nodes) for p in problems), default=0)
    k_max = max((sum(len(c) for c in p.cands) for p in problems), default=0)
    n_pad = pad_to_lanes(max(n_max, 1))
    k_pad = pad_to_lanes(max(k_max, 1))
    nodes = np.zeros((d, len(MOVE_NODE_FIELDS), n_pad), np.int32)
    nodes[:, 1, :] = -1
    cands = np.zeros((d, len(MOVE_CAND_FIELDS), k_pad), np.int32)
    cands[:, 0, :] = -1
    cands[:, 1:, :] = MOVE_PRIO_PAD
    for i, p in enumerate(problems):
        n = len(p.nodes)
        if n == 0:
            continue
        # raw lamport sums can exceed int32 and a local unstamped preview
        # op carries a 2^62 sentinel: ranks are order-isomorphic and
        # bounded by the candidate count
        hi_rank = {v: r for r, v in enumerate(
            sorted({c[0] for cl in p.cands for c in cl}))}
        lo_rank = {v: r for r, v in enumerate(
            sorted({c[1] for cl in p.cands for c in cl}))}
        nodes[i, 0, :n] = 1
        nodes[i, 1, :n] = np.asarray(p.base[:n], np.int32) if p.base else -1
        cnt = np.fromiter((len(cl) for cl in p.cands[:n]), np.int64, n)
        nodes[i, 3, :n] = cnt
        nodes[i, 2, :n] = np.cumsum(cnt) - cnt
        flat = [c for cl in p.cands[:n] for c in cl]
        k = len(flat)
        cands[i, 0, :k] = [-1 if c[2] is None else c[2] for c in flat]
        cands[i, 1, :k] = [hi_rank[c[0]] for c in flat]
        cands[i, 2, :k] = [lo_rank[c[1]] for c in flat]
    return {"nodes": nodes, "cands": cands}
