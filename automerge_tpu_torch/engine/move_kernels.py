"""Batched move cycle resolution by pointer doubling (counterpart of
`automerge_tpu/engine/move_kernels.py`).

A fleet absorbing a storm of concurrent reparents resolves every realm's
winner + cycle fixpoint over the packed lane layout (pack.pack_moves):

    winner(i)   = cand[off_i + ptr_i]            (one gather)
    root-find   = pointer doubling, ceil(log2 N) + 1 steps, carrying the
                  MINIMUM (prio_hi, prio_lo) edge label along the walk
    drop(i)     = on-a-cycle(i) & e(i) == cycle-minimum(anchor(i))
    repeat until no drops (each round breaks every remaining cycle)

After 2^L >= N doubling steps an unresolved node's pointer lies on its
cycle, where the carried minimum is the cycle's minimum edge priority;
priorities are unique (pack_moves ranks them), so the drop mask picks
exactly the victims of `core.moves._resolve_walk`.

- `resolve_moves`      the full fixpoint on the tensor's device: on a CUDA
                       tensor ONE launch of `csrc/move_round.cu` resolves
                       every realm (the rounds loop inside the kernel), on
                       a CPU tensor `resolve_moves_plain`;
- `move_round`         one round, the TPU kernel `move_round_pallas`'s
                       contract, by the same CUDA source, or
                       `move_round_plain` on the CPU;
- `resolve_moves_host` numpy, the host route of the adaptive router
                       (dispatch.plan_moves) and the parity oracle.

The kernel's own schedule is modelled in numpy by `automerge_tpu_torch/
move_schedule.py`.

Every resolution returns the same schema: `ptr` (winner index per node;
== cand_cnt when the base edge wins), `parent` (the resolved forest),
`resolved` (False only for undroppable cycles), `dropped` (per-realm
cycle-drop count) and a murmur-mixed `hash` of the resolved table. The
torch routes hold the hash as int32 bits of the uint32
(`dispatch.result_to_numpy` gives the numpy schema).
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda_kernels import launch, stream_of
from .kernels import _GOLD, _int32_bits, _mix, _mix_np, _u32
from .pack import MOVE_CAND_FIELDS, MOVE_NODE_FIELDS, MOVE_PRIO_PAD

F_MASK, F_BASE, F_OFF, F_CNT = range(4)
F_PARENT, F_HI, F_LO = range(3)

# The kernel's launch plan (move_launch): one block per realm; a thread
# keeps the walk state of NPT of its nodes in registers (NPT in
# MOVE_NPTS; more would spill), and the two (p, key) buffers and each
# node's slots take MOVE_SMEM_NODE_BYTES a node of shared memory. Realms
# past MOVE_MAX_THREADS * max(MOVE_NPTS) nodes, or past MOVE_SMEM_BYTES,
# run the same schedule in a global scratch (NPT = 0) of
# MOVE_SCRATCH_NODE_BYTES a node. MOVE_THREADS was chosen by measurement
# (PERF.md).
MOVE_THREADS = 512
MOVE_MAX_THREADS = 1024
MOVE_NPTS = (1, 4)
MOVE_SMEM_NODE_BYTES = 41
MOVE_SCRATCH_NODE_BYTES = 64
MOVE_SMEM_BYTES = 220 * 1024
SMEM_MAX_NODES = min(MOVE_MAX_THREADS * MOVE_NPTS[-1],
                     MOVE_SMEM_BYTES // MOVE_SMEM_NODE_BYTES)


def _ceil_log2(n: int) -> int:
    bits, m = 0, 1
    while m < n:
        m *= 2
        bits += 1
    return max(bits, 1)


# ---------------------------------------------------------------------------
# numpy host oracle


def _round_host(nodes, cands, ptr):
    """One fixpoint round: (parent, drop_mask, unresolved_mask)."""
    mask = nodes[:, F_MASK] > 0
    base = nodes[:, F_BASE]
    off, cnt = nodes[:, F_OFF], nodes[:, F_CNT]
    has = mask & (ptr < cnt)
    widx = np.clip(off + np.minimum(ptr, np.maximum(cnt - 1, 0)), 0,
                   cands.shape[2] - 1)
    take = np.take_along_axis
    parent = np.where(has, take(cands[:, F_PARENT], widx, 1), base)
    ehi = np.where(has, take(cands[:, F_HI], widx, 1), MOVE_PRIO_PAD)
    elo = np.where(has, take(cands[:, F_LO], widx, 1), MOVE_PRIO_PAD)
    parent = np.where(mask, parent, -1)

    p, mh, ml = parent, ehi.copy(), elo.copy()
    for _ in range(_ceil_log2(nodes.shape[2]) + 1):
        pm = p >= 0
        pi = np.clip(p, 0, None)
        nh = take(mh, pi, 1)
        nl = take(ml, pi, 1)
        less = pm & ((nh < mh) | ((nh == mh) & (nl < ml)))
        mh = np.where(less, nh, mh)
        ml = np.where(less, nl, ml)
        p = np.where(pm, take(p, pi, 1), -1)
    unresolved = p >= 0
    anchor = np.clip(p, 0, None)
    dh = take(mh, anchor, 1)
    dl = take(ml, anchor, 1)
    drop = (unresolved & has & (ehi == dh) & (elo == dl)
            & (dh != MOVE_PRIO_PAD))
    return parent, drop, unresolved


def resolve_moves_host(packed: dict) -> dict:
    """numpy reference and host route with the resolution contract (hash
    as np.uint32)."""
    nodes = np.asarray(packed["nodes"], np.int32)
    cands = np.asarray(packed["cands"], np.int32)
    d, _f, n_pad = nodes.shape
    ptr = np.zeros((d, n_pad), np.int32)
    dropped = np.zeros(d, np.int32)
    for _ in range(cands.shape[2] + 1):
        parent, drop, unresolved = _round_host(nodes, cands, ptr)
        if not drop.any():
            break
        ptr = ptr + drop
        dropped = dropped + drop.sum(axis=1).astype(np.int32)
    parent, _drop, unresolved = _round_host(nodes, cands, ptr)
    mask = nodes[:, F_MASK] > 0
    resolved = mask & ~unresolved
    return {"ptr": ptr, "parent": parent, "resolved": resolved,
            "dropped": dropped, "hash": _table_hash_host(nodes, parent,
                                                         ptr)}


def _table_hash_host(nodes, parent, ptr):
    mask = nodes[:, F_MASK] > 0
    slot = np.broadcast_to(np.arange(nodes.shape[2], dtype=np.int32),
                           parent.shape)
    with np.errstate(over="ignore"):
        h = _mix_np(slot.astype(np.uint32) + np.uint32(0x9E3779B9))
        h = _mix_np(h ^ parent.astype(np.uint32))
        h = _mix_np(h ^ ptr.astype(np.uint32))
        return np.where(mask, h, np.uint32(0)).astype(np.uint64) \
            .sum(axis=1).astype(np.uint32)


# ---------------------------------------------------------------------------
# the kernel's plain PyTorch versions


def _round_plain(nodes: torch.Tensor, cands: torch.Tensor,
                 ptr: torch.Tensor):
    """One fixpoint round on torch tensors: (parent, drop, unresolved)."""
    mask = nodes[:, F_MASK] > 0
    base, off, cnt = nodes[:, F_BASE], nodes[:, F_OFF], nodes[:, F_CNT]
    has = mask & (ptr < cnt)
    widx = (off + torch.minimum(ptr, (cnt - 1).clamp(min=0))).clamp(
        0, cands.shape[2] - 1).long()

    def take(row, idx):
        return torch.gather(row, 1, idx)

    parent = torch.where(has, take(cands[:, F_PARENT], widx), base)
    ehi = torch.where(has, take(cands[:, F_HI], widx), MOVE_PRIO_PAD)
    elo = torch.where(has, take(cands[:, F_LO], widx), MOVE_PRIO_PAD)
    parent = torch.where(mask, parent, -1)

    p, mh, ml = parent, ehi, elo
    for _ in range(_ceil_log2(nodes.shape[2]) + 1):
        pm = p >= 0
        pi = p.clamp(min=0).long()
        nh, nl = take(mh, pi), take(ml, pi)
        less = pm & ((nh < mh) | ((nh == mh) & (nl < ml)))
        mh = torch.where(less, nh, mh)
        ml = torch.where(less, nl, ml)
        p = torch.where(pm, take(p, pi), -1)
    unresolved = p >= 0
    anchor = p.clamp(min=0).long()
    dh, dl = take(mh, anchor), take(ml, anchor)
    drop = (unresolved & has & (ehi == dh) & (elo == dl)
            & (dh != MOVE_PRIO_PAD))
    return parent, drop, unresolved


def move_round_plain(nodes: torch.Tensor, cands: torch.Tensor,
                     ptr: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of move_round."""
    parent, drop, unresolved = _round_plain(nodes, cands, ptr)
    return torch.stack([drop.to(torch.int32), unresolved.to(torch.int32),
                        parent], dim=1)


def _table_hash_plain(nodes, parent, ptr) -> torch.Tensor:
    slot = torch.arange(nodes.shape[2], dtype=torch.int64,
                        device=nodes.device)
    h = _mix(slot + _GOLD)[None]
    h = _mix(h ^ _u32(parent))
    h = _mix(h ^ _u32(ptr))
    return _int32_bits(torch.where(nodes[:, F_MASK] > 0, h, 0).sum(1))


def resolve_moves_plain(nodes: torch.Tensor, cands: torch.Tensor) -> dict:
    """The plain PyTorch version of resolve_moves: the rounds loop of the
    reference's while_loop, on the tensors' own device."""
    d, _f, n_pad = nodes.shape
    ptr = torch.zeros((d, n_pad), dtype=torch.int32, device=nodes.device)
    dropped = torch.zeros(d, dtype=torch.int32, device=nodes.device)
    for _ in range(cands.shape[2] + 1):
        _parent, drop, _unres = _round_plain(nodes, cands, ptr)
        if not bool(drop.any()):
            break
        ptr = ptr + drop.to(torch.int32)
        dropped = dropped + drop.sum(1, dtype=torch.int32)
    parent, _drop, unresolved = _round_plain(nodes, cands, ptr)
    return {"ptr": ptr, "parent": parent,
            "resolved": (nodes[:, F_MASK] > 0) & ~unresolved,
            "dropped": dropped, "hash": _table_hash_plain(nodes, parent,
                                                          ptr)}


# ---------------------------------------------------------------------------
# the CUDA kernel's wrappers


def _check_moves(nodes: torch.Tensor, cands: torch.Tensor, ptr=None):
    if (nodes.dtype != torch.int32 or nodes.dim() != 3
            or nodes.shape[1] != len(MOVE_NODE_FIELDS)
            or cands.dtype != torch.int32 or cands.dim() != 3
            or cands.shape[1] != len(MOVE_CAND_FIELDS)
            or cands.shape[0] != nodes.shape[0]
            or nodes.shape[2] < 1 or cands.shape[2] < 1):
        raise ValueError(
            f"move lanes must be nodes [D, 4, N] and cands [D, 3, K] "
            f"int32 (N, K >= 1), got {nodes.dtype} {tuple(nodes.shape)} "
            f"and {cands.dtype} {tuple(cands.shape)}")
    if cands.device != nodes.device or (
            ptr is not None and ptr.device != nodes.device):
        raise ValueError("nodes, cands and ptr must share one device")
    if ptr is not None and (ptr.dtype != torch.int32
                            or ptr.shape != (nodes.shape[0],
                                             nodes.shape[2])):
        raise ValueError(f"ptr must be [D, N] int32, got {ptr.dtype} "
                         f"{tuple(ptr.shape)}")
    if nodes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {nodes.device}")


def move_launch(n: int) -> tuple[int, int]:
    """(threads, npt) of a realm of n node lanes, npt its nodes a thread
    in registers: up to MOVE_THREADS nodes, a thread each; up to 4 *
    MOVE_THREADS, MOVE_THREADS threads and 4 each (a thread skips its
    slots past n); above, MOVE_MAX_THREADS threads and 4; npt = 0 (the
    global scratch, MOVE_MAX_THREADS threads) past SMEM_MAX_NODES."""
    if n > SMEM_MAX_NODES:
        return MOVE_MAX_THREADS, 0
    if n <= MOVE_THREADS:
        return -(-n // 32) * 32, 1
    return (MOVE_THREADS if n <= 4 * MOVE_THREADS else MOVE_MAX_THREADS), 4


def _scratch(nodes: torch.Tensor, npt: int):
    """None (the kernel works in registers and shared memory) or the
    global scratch of the npt = 0 path: per realm MOVE_SCRATCH_NODE_BYTES
    * N bytes."""
    if npt:
        return None
    d, _f, n = nodes.shape
    return torch.empty((d, MOVE_SCRATCH_NODE_BYTES * n), dtype=torch.uint8,
                       device=nodes.device)


def move_round(nodes: torch.Tensor, cands: torch.Tensor,
               ptr: torch.Tensor) -> torch.Tensor:
    """One fixpoint round for every realm: returns [D, 3, N] int32 lanes
    (drop mask, unresolved mask, tentative parent). nodes [D, 4, N], cands
    [D, 3, K], ptr [D, N], all int32. A CUDA tensor launches the kernel of
    csrc/move_round.cu; a CPU tensor runs move_round_plain."""
    _check_moves(nodes, cands, ptr)
    if nodes.device.type == "cpu":
        return move_round_plain(nodes, cands, ptr)
    nodes, cands, ptr = nodes.contiguous(), cands.contiguous(), \
        ptr.contiguous()
    d, _f, n = nodes.shape
    threads, npt = move_launch(n)
    with torch.cuda.device(nodes.device):
        out = torch.empty((d, 3, n), dtype=torch.int32, device=nodes.device)
        if d:
            scratch = _scratch(nodes, npt)
            launch("move_round", "amt_move_round", "move_round",
                   nodes.data_ptr(), cands.data_ptr(), ptr.data_ptr(),
                   out.data_ptr(),
                   None if scratch is None else scratch.data_ptr(), d, n,
                   cands.shape[2], _ceil_log2(n) + 1, threads, npt,
                   stream_of(nodes))
    return out


def resolve_moves(nodes: torch.Tensor, cands: torch.Tensor) -> dict:
    """Batched resolution on the tensors' device. nodes [D, 4, N], cands
    [D, 3, K] int32 (pack_moves). Returns the resolution schema as tensors
    (hash as int32 bits). A CUDA tensor launches the kernel of
    csrc/move_round.cu once, every realm's fixpoint inside it; a CPU
    tensor runs resolve_moves_plain."""
    _check_moves(nodes, cands)
    if nodes.device.type == "cpu":
        return resolve_moves_plain(nodes, cands)
    nodes, cands = nodes.contiguous(), cands.contiguous()
    d, _f, n = nodes.shape
    k = cands.shape[2]
    dev = nodes.device
    threads, npt = move_launch(n)
    with torch.cuda.device(dev):
        ptr = torch.empty((d, n), dtype=torch.int32, device=dev)
        parent = torch.empty((d, n), dtype=torch.int32, device=dev)
        resolved = torch.empty((d, n), dtype=torch.bool, device=dev)
        dropped = torch.empty(d, dtype=torch.int32, device=dev)
        h = torch.empty(d, dtype=torch.int32, device=dev)
        if d:
            scratch = _scratch(nodes, npt)
            launch("move_round", "amt_resolve_moves", "resolve_moves",
                   nodes.data_ptr(), cands.data_ptr(), ptr.data_ptr(),
                   parent.data_ptr(), resolved.data_ptr(),
                   dropped.data_ptr(), h.data_ptr(),
                   None if scratch is None else scratch.data_ptr(), d, n, k,
                   _ceil_log2(n) + 1, k + 1, threads, npt, stream_of(nodes))
    return {"ptr": ptr, "parent": parent, "resolved": resolved,
            "dropped": dropped, "hash": h}
