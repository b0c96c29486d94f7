"""Collectives for DocSet reconciliation across a mesh (counterpart of
`automerge_tpu/parallel/collective.py`).

The reference's Connection merges peer clocks with an element-wise max
(clockUnion). Over a mesh the same operation on the fleet's [n_docs,
n_actors] clock matrix is a max over the docs axis: each process takes
the max over its own shards, and where the mesh spans processes an
all-reduce (MAX) over the process group gives every rank the fleet's.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import Mesh

_INT32_MIN = int(np.iinfo(np.int32).min)


def global_clock_union(clocks, mesh: Mesh) -> torch.Tensor:
    """Element-wise max over the docs axis: the fleet-wide vector clock.

    clocks: this process's [n, A] int32 clocks, a tensor (any device) or a
    list of them (one a shard). Returns [A] int32 on the mesh's first
    local device, the max over every process's docs when the mesh spans
    processes (gloo reduces a CPU copy; another backend the tensor in
    place)."""
    parts = list(clocks) if isinstance(clocks, (list, tuple)) else [clocks]
    parts = [torch.as_tensor(p) for p in parts]
    for p in parts:
        if p.dtype != torch.int32 or p.dim() != 2:
            raise ValueError(f"clocks must be [n, A] int32, got {p.dtype} "
                             f"{tuple(p.shape)}")
    dev = mesh.devices[mesh.local_indices()[0]]
    out = torch.full((parts[0].shape[1],), _INT32_MIN, dtype=torch.int32,
                     device=dev)
    for p in parts:
        if p.shape[0]:
            out = torch.maximum(out, p.to(dev).amax(0))
    if mesh.spans_processes:
        import torch.distributed as dist
        buf = out.cpu() if dist.get_backend() == "gloo" else out
        dist.all_reduce(buf, op=dist.ReduceOp.MAX)
        out = buf.to(dev)
    return out
