"""Move cycle resolution, realm-neutral part (counterpart of
`automerge_tpu/core/moves.py`).

A realm (the map-object forest, or one list's insertion forest) is a
`MoveProblem`: nodes with an undroppable base parent edge and a list of
move candidates sorted by priority DESCENDING. The semantics:

1. *Winner.* Each node takes its highest-priority live candidate, or its
   base edge once every candidate is dropped.
2. *Cycles.* Tentatively applying every winner can cycle the forest
   (concurrent `A->B` + `B->A`). Fixpoint: on each cycle drop the
   minimum-priority move edge (all of them on an exact tie), re-select
   winners, repeat until no cycle has a droppable edge. The result is a
   pure function of the candidate set.

`_resolve_walk` is that definition as host walks; `engine/move_kernels`
computes the identical fixpoint over packed lanes, and `resolve_problem`
routes between them by realm size. The builders that make problems from
an op set (`_build_map_problem`, `_build_list_problem`) come with the port
of the interpretive core.
"""

from __future__ import annotations

#: moved-node count from which a realm resolves through the packed
#: kernels instead of the host walk
MOVE_KERNEL_MIN_NODES = 64


class MoveProblem:
    """One realm's resolution working set: the dirty closure of nodes
    (every moved node, every candidate target, and all their ancestors up
    to the root), base parent edges, and per-node sorted candidates
    `(prio_hi, prio_lo, parent_slot, op)`."""

    __slots__ = ("nodes", "index", "base", "cands", "moved")

    def __init__(self):
        self.nodes: list = []          # node keys, slot order
        self.index: dict = {}          # node key -> slot
        self.base: list[int] = []      # slot -> base parent slot (-1 root)
        self.cands: list[list] = []    # slot -> [(hi, lo, parent_slot, op)]
        self.moved: list[int] = []     # slots with >= 1 candidate

    def slot(self, key) -> int:
        s = self.index.get(key)
        if s is None:
            s = len(self.nodes)
            self.index[key] = s
            self.nodes.append(key)
            self.base.append(-1)
            self.cands.append([])
        return s


def _resolve_walk(p: MoveProblem) -> tuple[list[int], int]:
    """The host-walk fixpoint: returns (winner index per slot, equal to
    len(cands[slot]) when the base edge wins, and the number of
    cycle-dropped candidates). This is the semantics definition."""
    n = len(p.nodes)
    ptr = [0] * n
    dropped = 0
    total = sum(len(c) for c in p.cands)
    for _round in range(total + 1):
        parent = [0] * n
        for i in range(n):
            c = p.cands[i]
            parent[i] = c[ptr[i]][2] if ptr[i] < len(c) else p.base[i]
        # cycle detection over the functional graph: iterative coloring
        state = [0] * n          # 0 unvisited, >0 walk id, -1 done
        to_drop: list[int] = []
        wid = 0
        for start in range(n):
            if state[start] != 0:
                continue
            wid += 1
            path = []
            x = start
            while x >= 0 and state[x] == 0:
                state[x] = wid
                path.append(x)
                x = parent[x]
            if x >= 0 and state[x] == wid:
                # a fresh cycle: the path suffix from x. Drop its minimum-
                # priority move edge (every one of them on an exact tie)
                cyc = path[path.index(x):]
                best = None
                for node in cyc:
                    if ptr[node] < len(p.cands[node]):
                        e = p.cands[node][ptr[node]][:2]
                        if best is None or e < best:
                            best = e
                if best is not None:
                    for node in cyc:
                        if (ptr[node] < len(p.cands[node])
                                and p.cands[node][ptr[node]][:2] == best):
                            to_drop.append(node)
            for node in path:
                state[node] = -1
        if not to_drop:
            break
        for node in to_drop:
            ptr[node] += 1
            dropped += 1
    return ptr, dropped


def _resolve_packed(p: MoveProblem, device) -> tuple[list[int], int]:
    """The identical fixpoint through the routed packed path."""
    from ..engine.dispatch import resolve_moves_adaptive
    from ..engine.pack import pack_moves

    _plan, out = resolve_moves_adaptive(pack_moves([p]), device=device)
    # numpy arrays on the host route, tensors on the device route
    return out["ptr"][0][:len(p.nodes)].tolist(), int(out["dropped"][0])


def resolve_problem(p: MoveProblem,
                    device="cuda") -> tuple[list[int], int]:
    """Resolve one realm: host walks below MOVE_KERNEL_MIN_NODES moved
    nodes, the routed packed path (engine/dispatch.resolve_moves_adaptive
    on `device`) from there on."""
    if len(p.moved) >= MOVE_KERNEL_MIN_NODES:
        return _resolve_packed(p, device)
    return _resolve_walk(p)
