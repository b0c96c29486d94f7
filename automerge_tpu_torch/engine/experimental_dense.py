"""EXPERIMENTAL: the dense one-hot reconcile of
`automerge_tpu/engine/experimental_dense.py`, on torch tensors. Routed
nowhere: `kernels.apply_doc` is the product path on every device.

The dense formulation replaces every gather and scatter of the reconcile
by one-hot compare-reduces, and the clock lookup by a contraction, so that
all work lands on full vector lanes. It gives the same outputs as
`kernels.apply_doc`, bit for bit (tests/test_torch_dense.py holds it to
the reference's dense path and to `apply_doc` on the CPU; `chip_smoke.py`
phase 17 on the card).

The reference quarantines the module at import on any accelerator backend:
it never ran on hardware and was the prime suspect for a TPU-window
fault. Torch has no default backend to probe at import, so the guard sits
at the call: a CUDA device raises NotImplementedError unless
AMTPU_ALLOW_DENSE_ON_DEVICE=1 (the reference's opt-in, under its name).

To A/B it deliberately:

    from automerge_tpu_torch.engine import experimental_dense as xd
    out = xd.reconcile_dense(batch, max_fids, device="cpu")
    ref = kernels.apply_doc(batch, max_fids)          # same outputs

Layout: the reference moves the docs axis last (TPU lanes); here it stays
first, as in `kernels.apply_doc`, so no output needs a transpose. The
three int32 contractions run as float64 matrix products: one operand is
one-hot, so each sum has at most one non-zero term and float64 holds
every int32 product exactly, on the CPU and on the card alike (CUDA has
no int32 matmul).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device
from .encode import A_DEL, A_SET
from .kernels import _int32_bits, _mix4, linearize

# Largest dense intermediate allowed (elements, i.e. 128MB of int32) before
# reconcile_dense refuses the batch, before any device memory is committed.
# A module constant so a validation session can raise it deliberately.
DENSE_BUDGET = 32 * 1024 * 1024

#: the opt-in that lets the dense path run on a CUDA device
ALLOW_ENV = "AMTPU_ALLOW_DENSE_ON_DEVICE"

#: the batch keys the dense path reads
_KEYS = ("op_mask", "action", "fid", "actor", "seq", "change_idx", "value",
         "fid_hash", "value_hash", "clock", "ins_mask", "ins_fid",
         "ins_elem", "ins_actor", "ins_parent", "ins_pos", "list_obj_hash",
         "actor_hash")


def dense_cost(batch, max_fids: int) -> int:
    """Element count of the largest dense intermediate — the change/actor
    one-hots ([D, I, C] / [D, I, A]), the fid one-hots ([D, F, I] /
    [D, F, L, E]), and the rank compare ([D, L, E, E])."""
    d, i = batch["op_mask"].shape
    c, a = batch["clock"].shape[1:]
    l, e = batch["ins_mask"].shape[1:]
    return max(i * c * d, i * a * d,
               max_fids * i * d, max_fids * l * e * d, l * e * e * d)


def _contract(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for int tensors whose products sum at most one non-zero term
    (one side one-hot), exact in float64, back to int32."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(
        torch.int32)


def apply_doc_dense(batch: dict, max_fids: int,
                    elem_pos_all: torch.Tensor) -> dict:
    """Dense reconcile over a stacked batch of tensors (leading docs axis);
    the same outputs as `kernels.apply_doc`, hash as int32 bits."""
    op_mask = batch["op_mask"]                          # [D, I]
    action = batch["action"]
    fid = batch["fid"]
    actor = batch["actor"]
    seq = batch["seq"]
    change_idx = batch["change_idx"]
    value = batch["value"]
    fid_hash = batch["fid_hash"]
    value_hash = batch["value_hash"]
    clock = batch["clock"]                              # [D, C, A]
    ins_mask = batch["ins_mask"]                        # [D, L, E]
    ins_fid = batch["ins_fid"]
    elem_pos = elem_pos_all                             # [D, L, E]
    list_obj_hash = batch["list_obj_hash"]              # [D, L]
    dev = op_mask.device

    n_changes, n_actors = clock.shape[1], clock.shape[2]
    F = max_fids

    is_assign = action >= A_SET
    amask = op_mask & is_assign

    # per-op change clocks through a one-hot contraction
    ch_oh = change_idx[:, :, None] == torch.arange(n_changes, device=dev)
    clock_j = _contract(ch_oh, clock)                   # [D, I, A]
    ac_oh = actor[:, :, None] == torch.arange(n_actors, device=dev)

    # per-fid reductions through a fid one-hot [D, F, I]
    f_oh = ((fid[:, None, :] == torch.arange(F, device=dev)[None, :, None])
            & amask[:, None, :])

    # Domination as a per-field segment max: the per-field per-actor clock
    # MAX bounds every dominator. A change's clock row holds its own actor
    # at seq - 1, so no self-domination term is needed. The actor axis is
    # unrolled to keep the max at [D, F, I] scale.
    fld_clock = torch.stack(
        [torch.where(f_oh, clock_j[:, None, :, a], -1).amax(dim=2)
         for a in range(n_actors)], dim=2)              # [D, F, A]
    bound_at_op = _contract(fld_clock, ac_oh.transpose(1, 2))   # [D, F, I]
    dom_bound = torch.where(f_oh, bound_at_op, 0).sum(1)        # [D, I]
    survivor = amask & ~(amask & (dom_bound >= seq))
    candidate = survivor & (action != A_DEL)
    win_actor = torch.where(f_oh & candidate[:, None, :], actor[:, None, :],
                            -1).amax(dim=2).to(torch.int32)     # [D, F]
    present = win_actor >= 0
    win_actor_at_op = torch.where(f_oh, win_actor[:, :, None], 0).sum(1)
    is_winner = candidate & (actor == win_actor_at_op)
    win_value = torch.where(f_oh & is_winner[:, None, :], value[:, None, :],
                            -1).amax(dim=2).to(torch.int32)     # [D, F]

    # element visibility + dense tombstone rank
    el_fid_valid = ins_mask & (ins_fid >= 0)
    safe_fid = ins_fid.clamp(0, F - 1)
    ef_oh = (safe_fid[:, None] == torch.arange(F, device=dev)[
        None, :, None, None])                           # [D, F, L, E]
    present_at_elem = (ef_oh & present[:, :, None, None]).any(dim=1)
    elem_visible = el_fid_valid & present_at_elem

    lt = elem_pos[:, :, :, None] < elem_pos[:, :, None, :]     # [D, L, E, E]
    vis_rank = (elem_visible[:, :, :, None] & lt).sum(dim=2)
    vis_rank = torch.where(elem_visible, vis_rank, -1).to(torch.int32)

    # fid -> (is_list, owning-object hash, visible rank) dense tables
    efm = ef_oh & el_fid_valid[:, None]
    fid_is_list = efm.any(dim=3).any(dim=2)                     # [D, F]
    fid_objhash = torch.where(efm, list_obj_hash[:, None, :, None],
                              -1).amax(dim=3).amax(dim=2)
    fid_rank = torch.where(efm, vis_rank[:, None], -1).amax(dim=3).amax(dim=2)

    op_is_list = (f_oh & fid_is_list[:, :, None]).any(dim=1)    # [D, I]
    op_objhash = torch.where(f_oh, fid_objhash[:, :, None], 0).sum(1)
    op_rank = torch.where(f_oh, fid_rank[:, :, None], 0).sum(1)

    # per-op actor CONTENT hash (rank-basis independent; see state_hash)
    ah_at_op = _contract(ac_oh, batch["actor_hash"][:, :, None])[:, :, 0]
    key1 = torch.where(op_is_list, op_objhash, -7)
    key2 = torch.where(op_is_list, op_rank, fid_hash)
    contrib = _mix4(key1, key2, ah_at_op, value_hash)
    h = _int32_bits(torch.where(candidate, contrib, 0).sum(1))

    return {
        "survivor": survivor, "candidate": candidate, "present": present,
        "win_actor": win_actor, "win_value": win_value,
        "elem_pos": elem_pos_all, "vis_rank": vis_rank,
        "elem_visible": elem_visible, "hash": h,
    }


def _device_of(batch: dict, device) -> torch.device:
    """`device` when given, else the batch's own tensors' device, else (a
    numpy batch) the card."""
    if device is not None:
        return torch.device(device)
    for v in batch.values():
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cuda")


def reconcile_dense(batch: dict, max_fids: int, host_order: bool = False,
                    device=None) -> dict:
    """The dense analog of `kernels.apply_doc` (linearization included),
    for A/B parity runs and hardware validation; never routed by product
    code. `batch` is encode.stack_docs's dict, numpy arrays or tensors;
    `device` defaults to the tensors' device (the card for numpy).
    host_order=True reads the host linearizer's positions; False runs
    `kernels.linearize` (the linearize kernel on the card).

    Raises NotImplementedError on a CUDA device unless
    AMTPU_ALLOW_DENSE_ON_DEVICE=1, and ValueError for a batch over
    DENSE_BUDGET; both before any device memory is committed."""
    dev = _device_of(batch, device)
    if dev.type != "cpu" and os.environ.get(ALLOW_ENV) != "1":
        raise NotImplementedError(
            "engine.experimental_dense is quarantined on accelerator "
            "devices: it has never been validated on hardware and is the "
            "reference's prime suspect for its r5 TPU-window fault. A "
            "hardware-validation session may opt in explicitly with "
            f"{ALLOW_ENV}=1.")
    cost = dense_cost(batch, max_fids)
    if cost > DENSE_BUDGET:
        raise ValueError(
            f"dense reconcile refused: largest one-hot intermediate would "
            f"be {cost} elements ({cost * 4 // (1024 * 1024)}MB int32) > "
            f"DENSE_BUDGET {DENSE_BUDGET}; shrink the batch or raise "
            f"experimental_dense.DENSE_BUDGET deliberately")
    dev = resolve_device(dev)
    t = {k: (torch.from_numpy(np.ascontiguousarray(batch[k]))
             if isinstance(batch[k], np.ndarray) else batch[k]).to(dev)
         for k in _KEYS if k in batch}
    if host_order:
        elem_pos_all = t["ins_pos"]
    else:
        d, n_lists, n_elems = t["ins_mask"].shape
        elem_pos_all = linearize(
            *(t[k].reshape(d * n_lists, n_elems) for k in (
                "ins_mask", "ins_elem", "ins_actor", "ins_parent"))
        ).reshape(d, n_lists, n_elems)
    return apply_doc_dense(t, max_fids, elem_pos_all)
