"""Multi-process DocSet execution: `torch.distributed` process groups, a
global mesh across processes, and the reference's sync protocol between
hosts (counterpart of `automerge_tpu/parallel/multihost.py`).

Hosts sync their DocSets over TCP (`sync/tcp.py`); then every process
encodes the same global batch from the synced change logs, reconciles
only its own contiguous range of the document axis on its own devices,
and cross-process reductions (the clock union) go through the process
group: gloo over TCP between CPU processes (also for processes that share
one GPU); NCCL for one GPU a rank is left to the caller's `backend`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..engine.cuda_kernels import hashes_to_numpy
from .mesh import (DOCS_AXIS, Mesh, encode_padded_batch, shard_batch,
                   sharded_apply)


def init_multihost(coordinator: str, num_processes: int, process_id: int,
                   backend: str = "gloo") -> None:
    """Join the process group (idempotent per process). `coordinator` is
    "host:port" (rank 0 listens there) or an init_method URL such as
    "tcp://host:port" or "file:///path"."""
    if dist.is_initialized():
        return
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend=backend, init_method=init,
                            world_size=num_processes, rank=process_id)


def global_mesh(axis: str = DOCS_AXIS, local_devices=None) -> Mesh:
    """One mesh over every device of every process, rank-major:
    `local_devices` are this process's (every CUDA device by default,
    which raises without one); each process learns the others' from an
    all-gather over the group."""
    if local_devices is None:
        resolve_device("cuda")
        local_devices = [torch.device("cuda", k)
                         for k in range(torch.cuda.device_count())]
    local = [str(resolve_device(d)) for d in local_devices]
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, local)
    devices, ranks = [], []
    for rank, devs in enumerate(gathered):
        devices += devs
        ranks += [rank] * len(devs)
    return Mesh(devices, axis, ranks)


def host_doc_range(n_global: int, mesh: Mesh) -> tuple[int, int]:
    """The contiguous [lo, hi) block of the global docs axis this process
    owns (the axis is laid out device-major in mesh order, and a global
    mesh groups devices by rank)."""
    n_dev = mesh.size
    assert n_global % n_dev == 0, "pad the doc axis to the mesh size first"
    per_dev = n_global // n_dev
    mine = mesh.local_indices()
    assert mine == list(range(min(mine), max(mine) + 1)), (
        "this process's devices are not contiguous in mesh order; build "
        "the mesh with global_mesh (rank-major) for multi-process runs")
    return min(mine) * per_dev, (max(mine) + 1) * per_dev


def shard_global_batch(batch: dict, mesh: Mesh) -> list[dict]:
    """This process's shards of the global batch, each on its device; every
    process must pass the same batch (the synced change logs make it so)."""
    host_doc_range(batch["op_mask"].shape[0], mesh)
    return shard_batch(batch, mesh)


def reconcile_global(doc_changes, mesh: Mesh, host_order: bool = True):
    """One reconcile of a DocSet over a global mesh: every process holds
    the same synced per-document change lists, encodes the global batch
    and reconciles its own document range. Returns (lo, hi, hashes):
    this process's range and the np.uint32 state hashes of exactly those
    documents (padding included; the caller slices by n_docs)."""
    _, batch, max_fids = encode_padded_batch(doc_changes, mesh)
    out = sharded_apply(shard_global_batch(batch, mesh), max_fids, mesh,
                        host_order)
    lo, hi = host_doc_range(batch["op_mask"].shape[0], mesh)
    return lo, hi, hashes_to_numpy(out["hash"])
