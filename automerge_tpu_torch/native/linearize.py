"""Host RGA linearization (the pure-Python algorithm of
`automerge_tpu/native/linearize.py`; its C++ twin comes with the native
column ingress)."""

from __future__ import annotations

import numpy as np


def linearize_host(ins_mask: np.ndarray, ins_elem: np.ndarray,
                   ins_actor: np.ndarray, ins_parent: np.ndarray) -> np.ndarray:
    """Positions of each element slot in full RGA order (-1 for masked-out
    slots): siblings are ordered by descending (elem counter, actor rank),
    each subtree directly after its parent."""
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
