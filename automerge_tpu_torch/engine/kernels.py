"""The docs-major reconcile of `automerge_tpu/engine/kernels.py` on torch
tensors (`apply_doc` and its stages: field_states, linearize and its
plain version, visible_ranks, state_hash), the murmur-style state-hash
mixers it and the rows kernel's plain version share, and their numpy
uint32 forms for the host oracles.

The reference computes the hash in uint32. Torch's `>>` on int32 is an
arithmetic shift and its integer products overflow as signed values, so
here every value is held in int64 in [0, 2**32): shifts are then logical,
and each 32x32-bit product is split into two products below 2**49 so that
nothing overflows before the `& 0xFFFFFFFF` wrap.
"""

from __future__ import annotations

import numpy as np
import torch

from .encode import A_DEL, A_SET

_MASK = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLD = 0x9E3779B9


def _mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    """(h * m) mod 2**32 for int64 h in [0, 2**32) and a uint32 constant."""
    lo = h * (m & 0xFFFF)
    hi = ((h * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _mix(h: torch.Tensor) -> torch.Tensor:
    """32-bit finalizer over int64 tensors holding uint32 values."""
    h = h & _MASK
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 13)
    h = _mul32(h, _M2)
    h = h ^ (h >> 16)
    return h


def _u32(x: torch.Tensor) -> torch.Tensor:
    """An int32 (or int64) tensor's low 32 bits as int64 in [0, 2**32)."""
    return x.to(torch.int64) & _MASK


def _mix4(a, b, c, d) -> torch.Tensor:
    """mix4 of four int32 (or int64) tensors; returns int64 in [0, 2**32)."""
    h = _mix(_u32(a) + _GOLD)
    h = _mix(h ^ _u32(b))
    h = _mix(h ^ _u32(c))
    return _mix(h ^ _u32(d))


def _int32_bits(x: torch.Tensor) -> torch.Tensor:
    """An int64 tensor taken mod 2**32, as int32 holding those bits (the
    uint32 wraparound of a sum)."""
    x = x & _MASK
    return (x - ((x >> 31) << 32)).to(torch.int32)


def _mix_np(h: np.ndarray) -> np.ndarray:
    """The 32-bit finalizer on numpy arrays, in uint32 (wrapping)."""
    h = h.astype(np.uint32)
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(_M1)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(_M2)
    h = h ^ (h >> np.uint32(16))
    return h


def _mix4_np(a, b, c, d) -> np.ndarray:
    """mix4 of four numpy integer arrays, in uint32 (wrapping)."""
    h = _mix_np(a.astype(np.uint32) + np.uint32(_GOLD))
    h = _mix_np(h ^ b.astype(np.uint32))
    h = _mix_np(h ^ c.astype(np.uint32))
    return _mix_np(h ^ d.astype(np.uint32))


# ---------------------------------------------------------------------------
# The docs-major reconcile (`apply_doc` and its stages), batched over the
# leading docs axis where the reference vmaps a per-document function.
#
# JAX clamps an out-of-range gather index and drops an out-of-range
# segment id or scatter index; torch raises on both (a device-side assert
# on the card). So every gather whose index is not in range by
# construction is clamped here, and every segment id outside
# [0, max_fids] goes to the trailing parking segment, which is sliced off
# as in the reference.

INT32_MIN = -2**31
INT32_MAX = 2**31 - 1


def _gather(x: torch.Tensor, idx: torch.Tensor, hi: int) -> torch.Tensor:
    """x[..., clamp(idx, 0, hi - 1)] along the last axis (JAX's clamped
    gather), for x of shape [B, n] and idx of shape [B, ...]."""
    idx = idx.clamp(0, hi - 1).to(torch.int64)
    return torch.gather(x, 1, idx.reshape(idx.shape[0], -1)).reshape(
        idx.shape)


def _segment_max(vals: torch.Tensor, seg: torch.Tensor,
                 n_seg: int) -> torch.Tensor:
    """jax.ops.segment_max over the last axis for each row: [B, n] values
    into [B, n_seg] maxima; empty segments hold INT32_MIN (JAX's identity
    for int32 max). `seg` must lie in [0, n_seg)."""
    out = torch.full((vals.shape[0], n_seg), INT32_MIN, dtype=torch.int32,
                     device=vals.device)
    return out.scatter_reduce_(1, seg.to(torch.int64), vals.to(torch.int32),
                               "amax", include_self=True)


def _seg_of(amask: torch.Tensor, fid: torch.Tensor,
            max_fids: int) -> torch.Tensor:
    """The segment of each op: its fid where amask holds and the fid is in
    range, else the trailing parking segment `max_fids`."""
    ok = amask & (fid >= 0) & (fid < max_fids)
    return torch.where(ok, fid, max_fids)


def domination_inputs(op_mask, action, fid, actor, seq, change_idx, clock):
    """The arguments of `cuda_kernels.dominated` for a batch: (clock_op
    [D, I, A], actor, fid, seq, change_idx, amask [D, I]), clock_op being
    each op's change-clock row (the change index clamped, as JAX's gather
    clamps it) and amask the live assign ops."""
    amask = op_mask & (action >= A_SET)
    chg = change_idx.clamp(0, clock.shape[1] - 1).to(torch.int64)
    clock_op = torch.gather(
        clock, 1, chg[:, :, None].expand(-1, -1, clock.shape[2]))
    return clock_op, actor, fid, seq, change_idx, amask


def field_states(op_mask, action, fid, actor, seq, change_idx, value, clock,
                 max_fids: int):
    """Per-field CRDT state for a batch of documents ([D, I] op columns,
    clock [D, C, A]). Returns (survivor, candidate [D, I] bool, present
    [D, F] bool, win_actor, win_value [D, F] int32), as the reference's
    field_states computes per document.

    Domination goes through the B5 kernel's wrapper
    (`cuda_kernels.dominated`, pairwise with the change_j != change_i
    term), not the reference's segment-max form.
    The two agree on every encoded batch: a change's clock row holds its
    own actor at seq - 1, so no op of its own change can reach seq_i."""
    from .cuda_kernels import dominated

    dom_args = domination_inputs(op_mask, action, fid, actor, seq,
                                 change_idx, clock)
    amask = dom_args[-1]
    survivor = amask & ~dominated(*dom_args)
    candidate = survivor & (action != A_DEL)

    seg = _seg_of(amask, fid, max_fids)
    win_actor = _segment_max(torch.where(candidate, actor, -1), seg,
                             max_fids + 1)[:, :max_fids].clamp_min(-1)
    is_winner = (candidate & amask
                 & (actor == _gather(win_actor, torch.where(amask, fid, 0),
                                     max_fids)))
    win_value = _segment_max(torch.where(is_winner, value, -1), seg,
                             max_fids + 1)[:, :max_fids].clamp_min(-1)
    present = win_actor >= 0
    return survivor, candidate, present, win_actor, win_value


def _ceil_log2(n: int) -> int:
    bits = 0
    m = 1
    while m < n:
        m *= 2
        bits += 1
    return max(bits, 1)


def linearize(ins_mask, ins_elem, ins_actor, ins_parent) -> torch.Tensor:
    """RGA order of list objects, one per row of [R, E] columns: returns
    elem_pos [R, E] int32, each element slot's 0-based position in the
    full document order (tombstones included; garbage for masked slots).
    The route follows the tensors' device: a CUDA tensor launches the
    kernel of csrc/linearize.cu (`cuda_kernels.linearize`), a CPU tensor
    runs linearize_plain. Nothing falls back."""
    if ins_mask.device.type == "cpu":
        return linearize_plain(ins_mask, ins_elem, ins_actor, ins_parent)
    from .cuda_kernels import linearize as linearize_kernel
    return linearize_kernel(ins_mask, ins_elem, ins_actor, ins_parent)


def linearize_plain(ins_mask, ins_elem, ins_actor,
                    ins_parent) -> torch.Tensor:
    """The plain PyTorch version of `linearize`, on the tensors' own device.

    Elements are taken in ascending (elem, actor) order (two stable sorts,
    actor first, for the reference's lexsort) and each is head-inserted
    right after its parent in a next-pointer array, node 0 being the head
    sentinel; the reference's lax.scan over those steps is a loop over
    the E steps here, each step vectorized over every row. Pointer
    doubling (_ceil_log2(E + 1) steps) then ranks the linked list."""
    r, e = ins_mask.shape
    dev = ins_mask.device
    sort_elem = torch.where(ins_mask, ins_elem, INT32_MAX)
    by_actor = torch.sort(ins_actor, dim=1, stable=True).indices
    by_elem = torch.sort(torch.gather(sort_elem, 1, by_actor), dim=1,
                         stable=True).indices
    order = torch.gather(by_actor, 1, by_elem)             # [R, E] int64

    nxt = torch.full((r, e + 1), -1, dtype=torch.int32, device=dev)
    for t in range(e):
        slot = order[:, t:t + 1]
        valid = torch.gather(ins_mask, 1, slot)
        par = torch.gather(ins_parent, 1, slot)
        p = torch.where(par >= 0, par + 1, 0).to(torch.int64)
        node = slot + 1
        succ = torch.gather(nxt, 1, p.clamp(max=e))
        nxt.scatter_(1, node, torch.where(valid, succ,
                                          torch.gather(nxt, 1, node)))
        # a parent index past the array is dropped, as JAX's scatter does
        put_p = valid & (p <= e)
        p = p.clamp(max=e)
        nxt.scatter_(1, p, torch.where(put_p, node.to(torch.int32),
                                       torch.gather(nxt, 1, p)))

    d = (nxt >= 0).to(torch.int32)
    for _ in range(_ceil_log2(e + 1)):
        live = nxt >= 0
        safe = nxt.clamp_min(0).to(torch.int64)
        d = d + torch.where(live, torch.gather(d, 1, safe), 0)
        nxt = torch.where(live, torch.gather(nxt, 1, safe), -1)
    pos = d[:, :1] - d
    return pos[:, 1:] - 1


def visible_ranks(elem_pos, visible) -> torch.Tensor:
    """Each visible element's position among the visible ones, per row of
    [R, E] (-1 where not visible): a scatter-add of the visibility bits at
    the elements' positions, an int32 prefix sum, and a gather back."""
    e = elem_pos.shape[1]
    safe = elem_pos.clamp(0, e - 1).to(torch.int64)
    arr = torch.zeros(elem_pos.shape, dtype=torch.int32,
                      device=elem_pos.device)
    arr.scatter_add_(1, safe, visible.to(torch.int32))
    cum = torch.cumsum(arr, dim=1, dtype=torch.int32)
    return torch.where(visible, torch.gather(cum, 1, safe) - 1, -1)


def state_hash(candidate, fid, actor_hash, fid_hash, value_hash, fid_is_list,
               fid_list_objhash, fid_vis_rank) -> torch.Tensor:
    """Canonical per-document state hash ([D] int32 holding the uint32
    bits): Σ over candidate ops of mix4(key1, key2, actor content hash,
    value hash), where a list element field keys by (owning object hash,
    visible rank) and a map field by (-7, field hash). The uint32 sum runs
    in int64 and is taken mod 2**32."""
    n_fids = fid_is_list.shape[1]
    is_list = _gather(fid_is_list, fid.clamp_min(0), n_fids)
    key1 = torch.where(is_list, _gather(fid_list_objhash, fid.clamp_min(0),
                                        n_fids), -7)
    key2 = torch.where(is_list, _gather(fid_vis_rank, fid.clamp_min(0),
                                        n_fids), fid_hash)
    contrib = _mix4(key1, key2, actor_hash, value_hash)
    return _int32_bits(torch.where(candidate, contrib, 0).sum(1))


def apply_doc(batch: dict, max_fids: int, host_order: bool = False) -> dict:
    """Converged state of every document of a stacked batch (a dict of
    tensors with a leading docs axis, encode.stack_docs's keys, all on one
    device). host_order=True reads the host linearizer's positions
    (batch["ins_pos"]); False runs `linearize` on the device.

    Returns a dict of tensors on the batch's device: survivor, candidate
    [D, I] bool; present [D, F] bool; win_actor, win_value [D, F] int32;
    elem_pos, vis_rank [D, L, E] int32; elem_visible [D, L, E] bool; hash
    [D] int32 holding the uint32 bits (`cuda_kernels.hashes_to_numpy`)."""
    ins_mask = batch["ins_mask"]
    d, n_lists, n_elems = ins_mask.shape
    if host_order:
        elem_pos = batch["ins_pos"]
    else:
        elem_pos = linearize(
            *(batch[k].reshape(d * n_lists, n_elems) for k in (
                "ins_mask", "ins_elem", "ins_actor", "ins_parent"))
        ).reshape(d, n_lists, n_elems)
    survivor, candidate, present, win_actor, win_value = field_states(
        batch["op_mask"], batch["action"], batch["fid"], batch["actor"],
        batch["seq"], batch["change_idx"], batch["value"], batch["clock"],
        max_fids)

    ins_fid = batch["ins_fid"]
    elem_visible = (ins_mask & (ins_fid >= 0)
                    & _gather(present, ins_fid, max_fids))
    vis_rank = visible_ranks(elem_pos.reshape(d * n_lists, n_elems),
                             elem_visible.reshape(d * n_lists, n_elems)
                             ).reshape(d, n_lists, n_elems)

    # fid -> (is_list, owning list object hash, visible rank) tables; an
    # invalid entry goes to the trailing slot, sliced off
    flat_fid = ins_fid.reshape(d, -1)
    flat_valid = flat_fid >= 0
    upd = torch.where(flat_valid & (flat_fid < max_fids), flat_fid, max_fids)
    objhash = batch["list_obj_hash"][:, :, None].expand(
        -1, -1, n_elems).reshape(d, -1)
    fid_is_list = _segment_max(flat_valid.to(torch.int32), upd,
                               max_fids + 1).clamp_min(0)[:, :max_fids]
    fid_list_objhash = _segment_max(torch.where(flat_valid, objhash, -1),
                                    upd, max_fids + 1).clamp_min(-1)
    fid_vis_rank = _segment_max(
        torch.where(flat_valid, vis_rank.reshape(d, -1), -1), upd,
        max_fids + 1).clamp_min(-1)

    actor_hash = batch["actor_hash"]
    ah_op = _gather(actor_hash, batch["actor"], actor_hash.shape[1])
    h = state_hash(candidate, batch["fid"], ah_op, batch["fid_hash"],
                   batch["value_hash"], fid_is_list.bool(),
                   fid_list_objhash[:, :max_fids], fid_vis_rank[:, :max_fids])
    return {"survivor": survivor, "candidate": candidate, "present": present,
            "win_actor": win_actor, "win_value": win_value,
            "elem_pos": elem_pos, "vis_rank": vis_rank,
            "elem_visible": elem_visible, "hash": h}
