"""The document axis of a batch split over devices (counterpart of
`automerge_tpu/parallel/mesh.py`).

Documents are independent, so a batch's document axis splits into
contiguous shards, one a device of a `Mesh`, and each shard reconciles on
its own device with no communication: the docs-major `kernels.apply_doc`
(B5, and `linearize` where lists are ordered on the device) for
`sharded_apply` / `reconcile_sharded`, one reconcile-kernel launch over
the shard's lanes of the row buffer for `reconcile_rows_sharded`, and the
same over the shard's lanes of the compact byte wire, widened on its
device, for `reconcile_rows_sharded_bytes`. Cross-document reductions
(the fleet's clock union) are `parallel/collective.py`.

A mesh names its devices in order. `make_mesh` takes the first n CUDA
devices, or the caller's list (the CPU tests pass `["cpu"] * 8`; a list
may name one device more than once, each entry a shard). A mesh that
`multihost.global_mesh` builds spans processes: each device carries the
rank of the process that owns it, and a process computes only its own
shards.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..engine.cuda_kernels import hashes_to_numpy, reconcile_rows_hash
from ..engine.encode import encode_doc, stack_docs
from ..engine.pack import (LANE, narrow_groups, pack_rows, pack_rows_compact,
                           widen_rows)

DOCS_AXIS = "docs"


class Mesh:
    """Ordered devices the document axis splits over, with the axis name;
    `ranks` (one a device) where the mesh spans processes."""

    def __init__(self, devices, axis: str = DOCS_AXIS, ranks=None):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_name = axis
        self.ranks = None if ranks is None else tuple(int(r) for r in ranks)
        if self.ranks is not None and len(self.ranks) != len(self.devices):
            raise ValueError("one rank a device")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def spans_processes(self) -> bool:
        return self.ranks is not None

    def local_indices(self) -> list[int]:
        """Mesh positions of this process's devices."""
        if self.ranks is None:
            return list(range(self.size))
        import torch.distributed as dist
        me = dist.get_rank()
        return [k for k, r in enumerate(self.ranks) if r == me]

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices]}, axis="
                f"{self.axis_name!r}, ranks={self.ranks})")


def make_mesh(n_devices: int | None = None, axis: str = DOCS_AXIS,
              devices=None) -> Mesh:
    """A mesh over the first `n_devices` CUDA devices (all of them by
    default), or over `devices` (its first `n_devices`). Raises where a
    named CUDA device is missing."""
    if devices is None:
        resolve_device("cuda")
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if n > count:
            raise ValueError(f"{n} CUDA devices asked for, {count} present")
        devices = [torch.device("cuda", k) for k in range(n)]
    else:
        devices = list(devices)[:n_devices]
        for d in devices:
            resolve_device(d)
    return Mesh(devices, axis)


def _pad_docs(batch: dict, multiple: int) -> dict:
    """Pad the leading docs axis to a multiple of `multiple`; padded docs
    are fully masked and add nothing."""
    n_docs = batch["op_mask"].shape[0]
    rem = n_docs % multiple
    if rem == 0:
        return batch
    pad = multiple - rem
    out = {}
    for key, arr in batch.items():
        if not isinstance(arr, np.ndarray):
            out[key] = arr
            continue
        widths = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
        fill = False if arr.dtype == bool else (
            0 if key in ("actor", "seq", "change_idx", "clock", "ins_elem",
                         "ins_actor") else -1)
        out[key] = np.pad(arr, widths, constant_values=fill)
    return out


def encode_padded_batch(doc_changes, mesh: Mesh, multiple: int | None = None):
    """Encode per-document change sets into a stacked numpy batch padded to
    the mesh size (or to `multiple`, e.g. LANE * mesh size for the row
    reconcile). Depends on the change sets alone (sorted global actor
    order), so every process of a multi-process run builds the same batch.
    Returns (encodings, batch, max_fids)."""
    all_actors = sorted({c.actor for changes in doc_changes for c in changes})
    encodings = [encode_doc(changes, all_actors) for changes in doc_changes]
    batch = stack_docs(encodings)
    max_fids = batch.pop("max_fids")
    return encodings, _pad_docs(batch, multiple or mesh.size), max_fids


def _lane_ranges(n: int, mesh: Mesh) -> list[tuple[torch.device, int, int]]:
    """(device, lo, hi) of this process's shards of an axis of n entries,
    in mesh order: n splits into mesh.size contiguous equal shards."""
    if n % mesh.size:
        raise ValueError(f"axis of {n} does not split over {mesh.size} "
                         f"devices (pad it first)")
    per = n // mesh.size
    return [(mesh.devices[k], k * per, (k + 1) * per)
            for k in mesh.local_indices()]


def shard_batch(batch: dict, mesh: Mesh) -> list[dict]:
    """This process's shards of a stacked batch (every process's, on a
    single-process mesh): one dict of tensors a device, each holding its
    contiguous range of the docs axis, in mesh order."""
    n = batch["op_mask"].shape[0]
    return [{k: torch.from_numpy(np.ascontiguousarray(
                np.asarray(v)[lo:hi])).to(dev)
             for k, v in batch.items()}
            for dev, lo, hi in _lane_ranges(n, mesh)]


def sharded_apply(shards: list[dict], max_fids: int, mesh: Mesh,
                  host_order: bool = True) -> dict:
    """kernels.apply_doc on each shard, on its own device, with the
    outputs concatenated in shard order on the first shard's device (the
    reference's outputs stay sharded over the docs axis). host_order=True
    is the reference's: list order from the host linearizer; False runs
    the `linearize` kernel on each shard."""
    from ..engine.kernels import apply_doc
    outs = [apply_doc(s, max_fids, host_order=host_order) for s in shards]
    if len(outs) == 1:
        return outs[0]
    dev = outs[0]["hash"].device
    return {k: torch.cat([o[k].to(dev) for o in outs]) for k in outs[0]}


def reconcile_sharded(doc_changes, mesh: Mesh, host_order: bool = True):
    """Encode per-document change sets, split them over the mesh and
    reconcile: (encodings, outputs over the padded docs axis, n_docs)."""
    encodings, batch, max_fids = encode_padded_batch(doc_changes, mesh)
    out = sharded_apply(shard_batch(batch, mesh), max_fids, mesh,
                        host_order)
    return encodings, out, len(doc_changes)


def _single_process(mesh: Mesh) -> None:
    if mesh.spans_processes:
        raise ValueError("the row reconcile gathers every shard's hashes in "
                         "this process; on a mesh across processes use "
                         "multihost.reconcile_global")


def reconcile_rows_sharded(doc_changes, mesh: Mesh):
    """The row buffer's lane axis (documents) split over the mesh: docs
    padded to LANE * mesh size, each device's contiguous lane range sent
    to it and reconciled by one reconcile-kernel launch, the hashes
    gathered in lane order. Returns (hashes np.uint32 [n_docs], n_docs)."""
    _single_process(mesh)
    _encs, batch, max_fids = encode_padded_batch(doc_changes, mesh,
                                                 multiple=LANE * mesh.size)
    rows, dims, _d = pack_rows(batch, max_fids)
    hashes = [reconcile_rows_hash(torch.from_numpy(
                  np.ascontiguousarray(rows[:, lo:hi])).to(dev), dims)
              for dev, lo, hi in _lane_ranges(rows.shape[1], mesh)]
    n = len(doc_changes)
    return np.concatenate([hashes_to_numpy(h) for h in hashes])[:n], n


def reconcile_rows_sharded_bytes(doc_changes, mesh: Mesh):
    """reconcile_rows_sharded fed by the compact byte wire: each dtype
    group ([rows_dt, d_pad, itemsize] uint8) split on its lane axis, each
    device's slices sent to it as they are, widened to the int32 row
    buffer there, and reconciled by one launch. Returns (hashes np.uint32
    [n_docs], n_docs), equal to the wide path's."""
    _single_process(mesh)
    _encs, batch, max_fids = encode_padded_batch(doc_changes, mesh,
                                                 multiple=LANE * mesh.size)
    (b8, b16, b32), meta, dims, _d = pack_rows_compact(batch, max_fids)
    # each dtype buffer as little-endian bytes [rows_dt, d_pad, itemsize],
    # which exposes the document lane axis
    groups = [np.ascontiguousarray(b).view(np.uint8).reshape(
                  b.shape[0], b.shape[1], k)
              for b, k in ((b8, 1), (b16, 2), (b32, 4))]
    hashes = []
    for dev, lo, hi in _lane_ranges(b8.shape[1], mesh):
        shard = [torch.from_numpy(np.ascontiguousarray(g[:, lo:hi])).to(dev)
                 for g in groups]
        rows = widen_rows(*narrow_groups(*shard), meta)
        hashes.append(reconcile_rows_hash(rows, dims))
    n = len(doc_changes)
    return np.concatenate([hashes_to_numpy(h) for h in hashes])[:n], n
