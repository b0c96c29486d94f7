"""Batched span-table merge (counterpart of `automerge_tpu/engine/
span_kernels.py`): replay only the concurrent spans.

A fleet merging many divergent text documents at once packs each
document's merge working set as a span table (pack.pack_spans: base spans
of the touched regions plus the concurrent spans of both histories, never
the whole document), and the merge itself is a sort:

    order   = lexsort(slot, -prio_elem, -prio_actor, block_seq)
    starts  = exclusive_cumsum(vis_len[order])     # visible positions
    hash    = sum mix4(origin, start_id, vis_len, start)   # per doc

`slot` interleaves concurrent spans into the gaps of the common history
and (prio_elem, prio_actor) DESCENDING is the RGA sibling rule, so the
sorted order is the merged document order at span granularity.

- `merge_spans`      the product contract on the tensor's device: the
                     4-key sort as chained stable `torch.sort` calls
                     (`merge_order`), then one launch of the rank+hash
                     kernel reading the spans through `order`, then the
                     masked lanes' running totals and a scatter of the
                     starts back to slot order (`slot_starts`);
- `span_rank_hash`   rank + hash over merged span lanes: on a CUDA tensor
                     the kernel of `csrc/span_rank_hash.cu` (replaces the
                     TPU kernel `span_rank_hash_pallas`), on a CPU tensor
                     `span_rank_hash_plain`;
- `merge_spans_host` numpy, the host route of the adaptive router
                     (dispatch.plan_spans) and the parity oracle.
"""

from __future__ import annotations

import numpy as np
import torch

from .cuda_kernels import launch, stream_of
from .kernels import _int32_bits, _mix4, _mix4_np
from .pack import SPAN_FIELDS

INT32_MAX = np.iinfo(np.int32).max

# The kernel's launch plan (span_launch): a warp per document up to this
# many span lanes, a block per document above.
SPAN_WARP_MAX_S = 1024

F_MASK, F_ORIGIN, F_START, F_VIS, F_SLOT, F_PELEM, F_PACTOR, F_SEQ = \
    range(len(SPAN_FIELDS))


def merge_spans_host(spans: np.ndarray) -> dict:
    """numpy reference and host route with merge_spans's exact contract
    (hash as np.uint32)."""
    spans = np.asarray(spans, np.int32)
    mask = spans[:, F_MASK] > 0
    slot = np.where(mask, spans[:, F_SLOT], INT32_MAX)
    order = np.lexsort((spans[:, F_SEQ], -spans[:, F_PACTOR],
                        -spans[:, F_PELEM], slot), axis=-1).astype(np.int32)
    vis = np.where(mask, spans[:, F_VIS], 0)
    vis_o = np.take_along_axis(vis, order, axis=-1)
    starts_o = np.cumsum(vis_o, axis=-1) - vis_o
    starts = np.zeros_like(starts_o)
    np.put_along_axis(starts, order, starts_o, axis=-1)
    with np.errstate(over="ignore"):
        contrib = _mix4_np(spans[:, F_ORIGIN], spans[:, F_START], vis,
                           starts)
        h = np.where(mask, contrib, np.uint32(0)).astype(np.uint64) \
            .sum(axis=-1).astype(np.uint32)
    return {"order": order, "start": starts.astype(np.int32),
            "total": vis.sum(axis=-1).astype(np.int32), "hash": h}


def sort_spans(spans):
    """Apply the merge order on the host: [D, F, S_pad] -> the lanes
    reordered along the span axis (mask row included), and the order."""
    spans = np.asarray(spans, np.int32)
    mask = spans[:, F_MASK] > 0
    slot = np.where(mask, spans[:, F_SLOT], INT32_MAX)
    order = np.lexsort((spans[:, F_SEQ], -spans[:, F_PACTOR],
                        -spans[:, F_PELEM], slot), axis=-1)
    return np.take_along_axis(spans, order[:, None, :], axis=-1), order


# ---------------------------------------------------------------------------
# rank + hash: the kernel and its plain version


def _check_spans(spans: torch.Tensor, order) -> None:
    if spans.dtype != torch.int32 or spans.dim() != 3 \
            or spans.shape[1] != len(SPAN_FIELDS) or spans.shape[2] < 1:
        raise ValueError(f"span lanes must be [D, {len(SPAN_FIELDS)}, S] "
                         f"int32 (S >= 1), got {spans.dtype} "
                         f"{tuple(spans.shape)}")
    if order is not None and (order.dtype != torch.int32
                              or order.shape != (spans.shape[0],
                                                 spans.shape[2])
                              or order.device != spans.device):
        raise ValueError(f"order must be [D, S] int32 on {spans.device}, "
                         f"got {order.dtype} {tuple(order.shape)} on "
                         f"{order.device}")


def span_launch(s: int) -> bool:
    """True where the kernel takes a warp per document (eight a block, no
    barrier: S <= SPAN_WARP_MAX_S), False for a block per document."""
    return s <= SPAN_WARP_MAX_S


def span_rank_hash(spans: torch.Tensor, order: torch.Tensor | None = None):
    """Rank + hash over merged span lanes, one pass per document.

    spans: [D, 8, S] int32. Without `order` the lanes are PRE-SORTED
    (sort_spans); with `order` ([D, S] int32, a permutation per document)
    merged position j reads lane order[j], so no sorted copy is needed.
    Returns (starts [D, S] int32 in merged order, hash [D] int32 holding
    the uint32 bits, total [D] int32): the exclusive prefix sum of the
    masked vis_len, Σ mix4(origin, start_id, vis, start) over unmasked
    lanes, and Σ vis, all wrapping as uint32. Masked lanes start at 0
    (the TPU kernel's contract).

    A CUDA tensor launches the kernel of csrc/span_rank_hash.cu (the path
    span_launch picks); a CPU tensor runs span_rank_hash_plain."""
    _check_spans(spans, order)
    if spans.device.type == "cpu":
        return span_rank_hash_plain(spans, order)
    if spans.device.type != "cuda":
        raise ValueError(f"unsupported device {spans.device}")
    spans = spans.contiguous()
    d, _f, s = spans.shape
    with torch.cuda.device(spans.device):
        starts = torch.empty((d, s), dtype=torch.int32, device=spans.device)
        h = torch.empty(d, dtype=torch.int32, device=spans.device)
        total = torch.empty(d, dtype=torch.int32, device=spans.device)
        if d:
            if order is not None:
                order = order.contiguous()
            launch("span_rank_hash", "amt_span_rank_hash", "span_rank_hash",
                   spans.data_ptr(),
                   None if order is None else order.data_ptr(),
                   starts.data_ptr(), h.data_ptr(), total.data_ptr(), d, s,
                   int(span_launch(s)), stream_of(spans))
    return starts, h, total


def span_rank_hash_plain(spans: torch.Tensor,
                         order: torch.Tensor | None = None):
    """The plain PyTorch version of span_rank_hash, on the tensor's own
    device: a gather through `order`, a cumsum and the int64 mixers."""
    x = spans
    if order is not None:
        x = spans.gather(2, order.long()[:, None, :].expand_as(spans))
    mask = x[:, F_MASK] > 0
    vis = torch.where(mask, x[:, F_VIS], 0)
    excl = torch.cumsum(vis, dim=1) - vis          # int64
    contrib = _mix4(x[:, F_ORIGIN], x[:, F_START], vis, excl)
    h = _int32_bits(torch.where(mask, contrib, 0).sum(1))
    return (_int32_bits(torch.where(mask, excl, 0)), h,
            _int32_bits(vis.sum(1)))


def merge_order(spans: torch.Tensor):
    """(order [D, S] int64, mask [D, S] bool): the merge's 4-key lexsort,
    primary key last, as stable sorts from the least significant key;
    negation wraps in int32, as in the reference."""
    mask = spans[:, F_MASK] > 0
    slot = torch.where(mask, spans[:, F_SLOT], INT32_MAX)
    order = None
    for key in (spans[:, F_SEQ], -spans[:, F_PACTOR], -spans[:, F_PELEM],
                slot):
        k = key if order is None else key.gather(1, order)
        perm = torch.sort(k, dim=1, stable=True).indices
        order = perm if order is None else order.gather(1, perm)
    return order, mask


def slot_starts(spans, mask, order, starts_o):
    """The kernel's merged-order starts as the merge's slot-indexed start:
    the kernel starts a masked lane at 0; the reference keeps its running
    total (cumsum - vis), the end of the last unmasked lane before it in
    merged order, or 0 (an unmasked lane may sort after the padding)."""
    mask_o = mask.gather(1, order)
    ends = _int32_bits(starts_o.long() + torch.where(
        mask_o, spans[:, F_VIS].gather(1, order), 0))
    pos = torch.arange(order.shape[1], device=order.device)
    last = torch.where(mask_o, pos, -1).cummax(1).values.clamp(min=0)
    starts_o = torch.where(mask_o, starts_o, ends.gather(1, last))
    return torch.empty_like(starts_o).scatter_(1, order, starts_o)


def merge_spans(spans: torch.Tensor) -> dict:
    """Merge a batch of span tables on the tensor's device. spans:
    [D, 8, S] int32 (pack.pack_spans). Returns a dict of tensors: order
    [D, S] int32 (merged position -> span slot), start [D, S] int32 (per
    span visible start position, slot-indexed), total [D] int32 visible
    lengths, hash [D] int32 holding the uint32 span-table hashes."""
    _check_spans(spans, None)
    order, mask = merge_order(spans)
    order32 = order.to(torch.int32)
    starts_o, h, total = span_rank_hash(spans, order32)
    return {"order": order32, "start": slot_starts(spans, mask, order,
                                                   starts_o),
            "total": total, "hash": h}
