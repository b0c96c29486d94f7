"""Adaptive routing of the batched planes: host numpy or the device, by a
measured cost model (the span and move part of `automerge_tpu/engine/
dispatch.py`).

A batch of span tables or move realms can be merged on the host (the
numpy oracles, no fixed cost) or on the device (microseconds of kernel
time behind a fixed cost per dispatch, transfer and readback). The router
prices both and takes the cheaper; its result dict has the same keys and
shapes on both routes (numpy arrays on the host route, tensors on the
device route; `result_to_numpy` gives the numpy schema).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device

# Cost model (seconds), measured by `chip_smoke.py` (phase 8, its "link"
# line) on an NVIDIA H100 80GB HBM3 with a 700.00 W power limit and the
# host of that machine, to five digits: the link legs through torch from
# pageable numpy memory, as the router ships; the host legs on the port's
# numpy oracles. Override with calibrate() for another deployment.
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
}


def calibrate(**overrides) -> None:
    """Override cost constants (e.g. from a deployment's own probe)."""
    for k, v in overrides.items():
        if k not in _LINK:
            raise KeyError(k)
        _LINK[k] = float(v)


@dataclass
class Plan:
    backend: str          # "device" | "host"
    est_device_s: float
    est_host_s: float


def _device_cost(wire_bytes: int) -> float:
    return (_LINK["dispatch_fixed_s"]
            + _LINK["h2d_call_s"]
            + wire_bytes / _LINK["h2d_bytes_per_s"]
            + _LINK["d2h_call_s"])


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
