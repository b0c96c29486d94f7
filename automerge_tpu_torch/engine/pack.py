"""The docs-minor row wire format (rows half of `automerge_tpu/engine/
pack.py`).

One int32 [ROWS, D_pad] buffer holds a whole batch: documents on the minor
(lane) axis, every logical column a static row range. It is the native
layout of the fused reconcile kernel (`cuda_kernels.reconcile_rows_hash`)
and of the resident rows engine, and it is byte-for-byte the reference's
format, so a buffer packed by either package feeds the other.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .encode import A_DEL, A_SET

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
