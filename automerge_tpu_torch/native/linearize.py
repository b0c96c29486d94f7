"""Host RGA linearization (counterpart of `automerge_tpu/native/
linearize.py`): `linearize_host` runs the C++ `amtpu_linearize` of
`wirecodec.cpp`; `linearize_host_plain` is the same algorithm in Python,
kept as the tests' plain version."""

from __future__ import annotations

import ctypes

import numpy as np

from . import get_lib


def linearize_host(ins_mask: np.ndarray, ins_elem: np.ndarray,
                   ins_actor: np.ndarray, ins_parent: np.ndarray) -> np.ndarray:
    """Positions of each element slot in full RGA order (-1 for masked-out
    slots): siblings are ordered by descending (elem counter, actor rank),
    each subtree directly after its parent."""
    n = len(ins_mask)
    out = np.full(n, -1, dtype=np.int32)
    if n == 0 or not ins_mask.any():
        return out
    elem = np.ascontiguousarray(ins_elem, dtype=np.int32)
    actor = np.ascontiguousarray(ins_actor, dtype=np.int32)
    parent = np.ascontiguousarray(ins_parent, dtype=np.int32)
    mask = np.ascontiguousarray(ins_mask, dtype=np.uint8)

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    get_lib().amtpu_linearize(n, ptr(elem), ptr(actor), ptr(parent),
                              ptr(mask), ptr(out))
    return out


def linearize_host_plain(ins_mask: np.ndarray, ins_elem: np.ndarray,
                         ins_actor: np.ndarray,
                         ins_parent: np.ndarray) -> np.ndarray:
    """`linearize_host` in pure Python (the same algorithm)."""
    n = len(ins_mask)
    out = np.full(n, -1, dtype=np.int32)
    if n == 0 or not ins_mask.any():
        return out
    order = sorted((i for i in range(n) if ins_mask[i]),
                   key=lambda i: (ins_elem[i], ins_actor[i]))
    nxt = np.full(n + 1, -1, dtype=np.int32)  # node 0 = head; slot e -> e+1
    for idx in order:
        p = ins_parent[idx] + 1 if ins_parent[idx] >= 0 else 0
        e = idx + 1
        nxt[e] = nxt[p]
        nxt[p] = e
    pos = 0
    v = nxt[0]
    while v != -1:
        out[v - 1] = pos
        pos += 1
        v = nxt[v]
    return out
