"""Move operations: one-op reparenting with deterministic cycle resolution.

Kleppmann-style moves ("Extending JSON CRDTs with Move Operations",
arxiv 2311.14007) give this CRDT an op class the v0.8.0 reference cannot
express: relocating a map child object or a list element is ONE op
(`move {obj, key, value, elem?}`) instead of a delete + re-insert that
re-ships the whole subtree and duplicates it under concurrency.

Two *realms* share one resolution engine:

- the **map realm** — the document-wide object forest. A map move
  reparents child object `value` under map `obj` at key `key`. Parent
  edges come from each object's effective location op (`ObjState.loc`);
  objects never move-targeted keep the reference's link semantics bit
  for bit.
- a **list realm** per list/text object — its RGA insertion forest. A
  list move re-anchors element `value` after `key` with a fresh sibling
  counter `elem` (allocated like an insert, so destination-order ties
  break exactly like concurrent inserts). The element keeps its
  identity: concurrent set/del on it still apply.

**Semantics (the one definition, shared by every implementation):**

1. *Candidates.* Each moved node carries the antichain of its
   non-dominated move ops (a move causally covered by a later move of
   the same node is dead forever — the same monotone-domination argument
   that lets the snapshot compactor drop it, sync/snapshots.py) plus an
   undroppable *base* edge: the element's original `ins` (lists) or its
   minimum-stamp inbound `link` (maps).
2. *Winner.* Highest-priority candidate, priority =
   (lamport, actor) where lamport = sum of the op's change's full
   vector clock — a total order extending causality, so a causally-later
   move always beats everything it has seen, and concurrent moves
   tie-break on the actor exactly like the LWW rule everywhere else in
   this engine.
3. *Cycles.* Tentatively applying every winner can cycle the forest
   (concurrent `A->B` + `B->A`). Fixpoint: find the cycles, drop the
   minimum-priority move edge on each cycle (the highest-priority move
   survives), re-select winners (a dropped node falls back to its next
   candidate, ultimately its base edge), repeat. Drops are monotone so
   the loop terminates; the result is a pure function of the candidate
   SET — delivery order, batching, and replica cannot matter. A cycle
   with no droppable move edge (pre-existing concurrent cross-links, a
   wart this repo inherits from the reference) is left as-is.

This is the port's copy of `automerge_tpu/core/moves.py`. A realm with
fewer than `_kernel_min()` moved nodes (AMTPU_MOVE_KERNEL_MIN, default
MOVE_KERNEL_MIN_NODES) resolves with the host walk, on the per-op path and
in batches alike. From there on it packs and routes through
engine/dispatch.resolve_moves_adaptive on the OpSet's device
(`Builder.device`): the numpy fixpoint, or on the card the B4 kernel
(`csrc/move_round.cu`, the whole fixpoint in one launch), priced by the
card's constants (engine/dispatch.plan_moves). Batches of >=
MOVE_BATCH_MIN_OPS moves admit through the span-plane scaffolding
(`admit_change_header` classification, one resolution per batch).
"""

from __future__ import annotations

import os

from ..utils import metrics
from .change import Change
from .ids import HEAD, ROOT_ID
from .opset import (Builder, admit_change_header, get_path, get_previous,
                    patch_list, update_map_key)

#: below this many ops a batch keeps the per-op path (interactive moves
#: keep their per-op diff records); tests override to force the plane.
MOVE_BATCH_MIN_OPS = 32

#: moved-node count from which realm resolution routes through the packed
#: path (engine/dispatch.resolve_moves_adaptive) instead of the host walk
#: (AMTPU_MOVE_KERNEL_MIN overrides).
MOVE_KERNEL_MIN_NODES = 64


def op_priority(b, op) -> tuple[int, str, str]:
    """(lamport, actor, moved-id) priority of a stamped op: lamport is
    the sum of the op's change's full transitive clock — strictly
    monotone along causality — the actor string breaks concurrent ties
    with the same highest-wins convention as the LWW rule
    (op_set.js:201), and the moved id makes priorities UNIQUE even for
    two moves inside one change (cross-moving two nodes), which the
    cycle-drop rule needs for walk/kernel parity."""
    if not op.actor or not op.seq:
        # local op inside an open change block: previews as winning over
        # everything admitted (the commit re-applies it stamped)
        return 2 ** 62, op.actor or "", str(op.value)
    clock = b.states[op.actor][op.seq - 1][1]
    # the stored row holds the op's own actor at seq-1, so this sum is
    # the true vector-clock sum minus a constant 1: ordering-identical
    return sum(clock.values()), op.actor or "", str(op.value)


def covers(b, op_a, op_b) -> bool:
    """True when op_a's change causally covers op_b's change (op_b is
    dominated: dead forever as a location candidate)."""
    if not op_a.actor or not op_a.seq:
        return True   # local unstamped op: sees (and overrides) everything
    if not op_b.actor or not op_b.seq:
        return False
    if op_a.actor == op_b.actor:
        return op_a.seq > op_b.seq
    clock = b.states[op_a.actor][op_a.seq - 1][1]
    return clock.get(op_b.actor, 0) >= op_b.seq


# ---------------------------------------------------------------------------
# the resolution problem: realm-neutral packed form


class MoveProblem:
    """One realm's resolution working set: the dirty closure of nodes
    (every moved node, every candidate target, and all their ancestors up
    to the root), base parent edges, and per-node sorted candidates."""

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
    """The host-walk fixpoint: returns (winner index per slot — equal to
    len(cands[slot]) when the base edge wins — aligned with p.nodes, and
    the number of cycle-dropped candidates). This is the SEMANTICS
    definition — engine/move_kernels implements the identical fixpoint
    over packed arrays (parity-pinned by tests/test_moves.py)."""
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
                # fresh cycle: the path suffix from x. Drop its minimum-
                # priority move edge (all of them on an exact tie — two
                # moves of one change cross-moving two nodes — which is
                # deterministic too: ties drop together on every replica)
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
    """Route the identical fixpoint through the packed path on `device`
    (the numpy host fixpoint or the B4 kernel, by measured cost model)."""
    from ..engine.dispatch import resolve_moves_adaptive
    from ..engine.pack import pack_moves

    _plan, out = resolve_moves_adaptive(pack_moves([p]), device=device)
    # numpy arrays on the host route, tensors on the device route
    return out["ptr"][0][:len(p.nodes)].tolist(), int(out["dropped"][0])


def _kernel_min() -> int:
    try:
        return int(os.environ.get("AMTPU_MOVE_KERNEL_MIN",
                                  MOVE_KERNEL_MIN_NODES))
    except ValueError:  # pragma: no cover
        return MOVE_KERNEL_MIN_NODES


def resolve_problem(p: MoveProblem,
                    device="cuda") -> tuple[list[int], int]:
    """Resolve one realm: host walks below `_kernel_min()` moved nodes,
    the routed packed path on `device` from there on."""
    if len(p.moved) >= _kernel_min():
        return _resolve_packed(p, device)
    return _resolve_walk(p)


# ---------------------------------------------------------------------------
# map realm


def _map_base(child):
    """The child's undroppable base edge: its minimum-stamp inbound link
    (the op that first placed it — causally before every move of it, so
    the choice is delivery-order-independent)."""
    best = None
    best_key = None
    for ref in child.inbound:
        if ref.action != "link":
            continue
        key = (ref.actor or "", ref.seq or 0)
        if best is None or key < best_key:
            best, best_key = ref, key
    return best


def _map_candidates(b: Builder, child) -> list:
    out = []
    for ref in child.inbound:
        if ref.action == "move":
            hi, a, v = op_priority(b, ref)
            out.append((hi, (a, v), ref))
    # stable sort, then reverse slices of equal keys keep REGISTRATION
    # order among exact ties (two moves of one change): the later op of
    # the change must rank first, and registration replaced same-stamp
    # earlier ops already, so ties here are cross-node only
    out.sort(key=lambda t: (t[0], t[1]), reverse=True)
    return out


def _effective_parent_map(b: Builder, oid: str) -> str | None:
    obj = b.by_object.get(oid)
    if obj is None or not obj.inbound:
        return None
    if obj.loc is not None:
        return obj.loc.obj
    ref = next(iter(obj.inbound))
    return ref.obj


def _build_map_problem(b: Builder) -> MoveProblem:
    p = MoveProblem()
    packed: dict[str, tuple] = {}
    frontier: list[str | None] = []
    for oid in b.moved_objs:
        child = b.by_object.get(oid)
        if child is None:
            continue
        cands = _map_candidates(b, child)
        base = _map_base(child)
        packed[oid] = (base, cands)
        p.moved.append(p.slot(oid))
        frontier.extend(op.obj for (_h, _l, op) in cands)
        if base is not None:
            frontier.append(base.obj)
    # closure: every target and every ancestor chain up to the root
    while frontier:
        oid = frontier.pop()
        if oid is None or oid == ROOT_ID or oid in p.index:
            continue
        p.slot(oid)
        frontier.append(_effective_parent_map(b, oid))
    # fill edges (closure complete: slot() below never adds a node)
    n = len(p.nodes)
    for s in range(n):
        oid = p.nodes[s]

        def pslot(target):
            return -1 if target is None or target == ROOT_ID \
                else p.index[target]

        entry = packed.get(oid)
        if entry is not None:
            base, cands = entry
            p.base[s] = pslot(base.obj) if base is not None else -1
            p.cands[s] = [(hi, lo, pslot(op.obj), op)
                          for (hi, lo, op) in cands]
        else:
            p.base[s] = pslot(_effective_parent_map(b, oid))
    assert len(p.nodes) == n
    return p


def _place_map_child(b: Builder, child_id: str, new_op,
                     touched: list) -> None:
    """Materialize one map child's effective location: remove every
    non-effective location op from its field, install `new_op` at its
    destination field (with the standard causal-overwrite split), stamp
    `loc`. Appends affected (obj, key) pairs to `touched`; diff emission
    happens AFTER the whole realm is placed (get_path must never walk a
    half-updated forest)."""
    child = b.obj(child_id)
    old = child.loc
    if old is new_op:
        return
    # single-location sweep: once a child is move-managed, exactly its
    # EFFECTIVE op may present it — every other inbound location op
    # (the base link, losing candidates, a stale previous winner) leaves
    # its field. Pure function of the candidate set, so delivery order
    # cannot matter.
    for ref in child.inbound:
        if ref is new_op:
            continue
        holder = b.by_object.get(ref.obj)
        if holder is not None and ref in holder.fields.get(ref.key, ()):
            hmut = b.obj(ref.obj)
            hmut.fields[ref.key] = tuple(
                o for o in hmut.fields[ref.key] if o is not ref)
            touched.append((ref.obj, ref.key))
    child.loc = new_op
    touched.append((new_op.obj, new_op.key))
    dest = b.obj(new_op.obj)
    prior = dest.fields.get(new_op.key, ())
    if new_op in prior:
        return
    # a location op causally covered by an assign already at the key is
    # suppressed — the overwrite wins, and any-order replay agrees
    # because apply_assign strips it the same way
    if any(covers(b, other, new_op) for other in prior):
        return
    overwritten = [o for o in prior if covers(b, new_op, o)]
    remaining = [o for o in prior if not covers(b, new_op, o)]
    for dead in overwritten:
        if dead.action == "link":
            b.obj(dead.value).inbound.pop(dead, None)
        # dead MOVE ops stay in their child's inbound: they remain
        # resolution candidates (visibility is what the field holds)
    remaining.append(new_op)
    remaining.sort(key=lambda o: o.actor or "", reverse=True)
    dest.fields[new_op.key] = tuple(remaining)


#: reserved ObjState.moves key holding the realm's drop count at its
#: previous resolution: the metric reports the positive DELTA, so a
#: standing cycle counts once, not once per later unrelated admission
#: (element ids are "actor:n" and map keys never start with \x00, so
#: the key cannot collide)
_DROPS_KEY = "\x00cycle_drops"


def _bump_drops(b: Builder, holder_oid: str, dropped: int) -> None:
    holder = b.obj(holder_oid)
    prev = holder.moves.get(_DROPS_KEY, 0)
    if dropped > prev:
        metrics.bump("sync_move_cycles_dropped", dropped - prev)
    if dropped != prev:
        holder.moves[_DROPS_KEY] = dropped


def _resolve_map_realm(b: Builder, emit: bool,
                       touched: set | None = None,
                       pre_pairs: list | None = None) -> list[dict]:
    if not b.moved_objs:
        return []
    p = _build_map_problem(b)
    ptr, dropped = resolve_problem(p, b.device)
    _bump_drops(b, ROOT_ID, int(dropped))
    # pre_pairs: (obj, key) fields the REGISTRATION step stripped
    # (domination pruning of superseded location ops) — they need diff
    # records too or incremental caches go stale on chained moves
    keys: list[tuple[str, str]] = list(pre_pairs or ())
    for s in p.moved:
        oid = p.nodes[s]
        child = b.by_object.get(oid)
        if child is None:
            continue
        cands = p.cands[s]
        if ptr[s] < len(cands):
            winner = cands[ptr[s]][3]
        else:
            winner = _map_base(child)
        if winner is None:
            continue
        _place_map_child(b, oid, winner, keys)
    diffs: list[dict] = []
    seen: set = set()
    for pair in keys:
        if pair in seen:
            continue
        seen.add(pair)
        if touched is not None:
            touched.add(pair[0])
        if emit:
            diffs.extend(update_map_key(b, pair[0], pair[1]))
    return diffs


# ---------------------------------------------------------------------------
# list realm
#
# Node space: each element contributes its PLACED spot (plain eid — where
# its winning op puts it) and, once moved, a GHOST spot (eid + suffix —
# its original ins position, which its unaware siblings keep anchoring
# at). Ghost edges are undroppable ins edges; candidates attach to placed
# spots only. Cycles arise when placement-aware anchoring loops (E typed
# after moved D, then D moved after E) and resolve exactly like map-realm
# cycles.


def _list_candidates(b: Builder, entry):
    out = []
    for op in entry.cands:
        hi, a, v = op_priority(b, op)
        out.append((hi, (a, v), op))
    out.sort(key=lambda t: (t[0], t[1]), reverse=True)
    return out


def _build_list_problem(b: Builder, oid: str) -> MoveProblem:
    from .opset import GHOST_SUFFIX, anchored_at_placed, strip_ghost

    obj = b.by_object[oid]
    p = MoveProblem()
    packed: dict[str, list] = {}

    def anchor_of(_eid: str, via_op) -> str | None:
        # PROSPECTIVE spot split: resolution runs before placement, so
        # the split keys on candidate existence, not on the currently
        # installed winner (when the winner ends up being the base, both
        # spots converge on the same position and the distinction is
        # harmless)
        anchor = via_op.key
        if anchor == HEAD:
            return None
        if anchor not in obj.moves:
            return anchor
        if anchored_at_placed(b, obj, via_op, anchor):
            return anchor
        return anchor + GHOST_SUFFIX

    frontier: list[str | None] = []
    for eid, entry in obj.moves.items():
        if eid == _DROPS_KEY:
            continue
        cands = _list_candidates(b, entry)
        packed[eid] = cands
        p.moved.append(p.slot(eid))
        frontier.append(eid + GHOST_SUFFIX)
        frontier.append(anchor_of(eid, entry.base))
        frontier.extend(anchor_of(eid, op) for (_h, _l, op) in cands)
    while frontier:
        key = frontier.pop()
        if key is None or key == HEAD or key in p.index:
            continue
        p.slot(key)
        bare = strip_ghost(key)
        entry = obj.moves.get(bare)
        if entry is not None:
            if key == bare and bare not in packed:
                # a moved element reached as an anchor: its candidates
                # (and their chains) shape the forest too
                cands = _list_candidates(b, entry)
                packed[bare] = cands
                p.moved.append(p.index[bare])
                frontier.append(bare + GHOST_SUFFIX)
                frontier.extend(anchor_of(bare, op)
                                for (_h, _l, op) in cands)
            frontier.append(anchor_of(bare, entry.base))
        else:
            ins = obj.insertion.get(bare)
            if ins is not None:
                frontier.append(anchor_of(bare, ins))
    n = len(p.nodes)

    def pslot(key):
        return -1 if key is None or key == HEAD else p.index[key]

    for s in range(n):
        key = p.nodes[s]
        bare = strip_ghost(key)
        entry = obj.moves.get(bare)
        if entry is not None:
            base_slot = pslot(anchor_of(bare, entry.base))
            p.base[s] = base_slot
            if key == bare:
                p.cands[s] = [(hi, lo, pslot(anchor_of(bare, op)), op)
                              for (hi, lo, op) in packed[bare]]
        else:
            ins = obj.insertion.get(bare)
            p.base[s] = pslot(anchor_of(bare, ins)) if ins is not None \
                else -1
    assert len(p.nodes) == n
    return p


def _place_list_elem(b: Builder, oid: str, eid: str, new_op,
                     emit: bool) -> list:
    """Re-place one element. The original ins never leaves the insertion
    tree (it is the ghost — siblings anchored at it keep their
    positions); the winning move op joins its destination bucket. The
    visible index updates incrementally (remove + insert, the same
    records a delete + re-add would emit) unless placement-aware
    followers exist, in which case the whole index rebuilds."""
    from .opset import rebuild_elem_ids

    obj = b.obj(oid)
    entry = obj.moves[eid]
    old = obj.insertion.get(eid)
    if old is new_op:
        return []
    if old is not entry.base:
        sibs = obj.following.get(old.key, ())
        obj.following[old.key] = tuple(o for o in sibs if o is not old)
    if new_op is not entry.base \
            and new_op not in obj.following.get(new_op.key, ()):
        obj.following[new_op.key] = \
            obj.following.get(new_op.key, ()) + (new_op,)
    obj.insertion[eid] = new_op
    if not emit:
        b._deferred_seqs.add(oid)
        return []
    if entry.followers:
        # siblings track this element's placement: their flat positions
        # shift with it, so rebuild the index wholesale (rare — requires
        # conflicting concurrent moves under placement-aware anchors)
        rebuild_elem_ids(obj, state=b)
        b._elem_copied.add(oid)
        kind = "text" if obj.init_action == "makeText" else "list"
        return [{"action": "batch", "type": kind, "obj": oid,
                 "path": get_path(b, oid)}]
    diffs: list[dict] = []
    elems = b.elem_ids_mut(oid)
    ops = obj.fields.get(eid, ())
    idx = elems.index_of(eid)
    if idx >= 0:
        diffs.extend(patch_list(b, oid, idx, "remove", None))
    if ops:
        prev = get_previous(b, oid, eid)
        at = -1
        while prev is not None:
            at = elems.index_of(prev)
            if at >= 0:
                break
            prev = get_previous(b, oid, prev)
        diffs.extend(patch_list(b, oid, at + 1, "insert", ops))
    return diffs


def _resolve_list_realm(b: Builder, oid: str, emit: bool) -> list[dict]:
    obj = b.by_object.get(oid)
    if obj is None or not obj.moves:
        return []
    p = _build_list_problem(b, oid)
    ptr, dropped = resolve_problem(p, b.device)
    _bump_drops(b, oid, int(dropped))
    diffs: list[dict] = []
    for s in p.moved:
        eid = p.nodes[s]
        cands = p.cands[s]
        if ptr[s] < len(cands):
            winner = cands[ptr[s]][3]
        else:
            winner = b.by_object[oid].moves[eid].base
        diffs.extend(_place_list_elem(b, oid, eid, winner, emit))
    return diffs


# ---------------------------------------------------------------------------
# per-op application (called from opset.apply_op)


def apply_move(b: Builder, op, emit: bool = True) -> list[dict]:
    """Apply one stamped move op: candidate registration with monotone
    domination pruning, then a realm resolution pass (host walks at this
    granularity — the batched plane amortizes resolution per batch)."""
    dest = b.by_object.get(op.obj)
    if dest is None:
        raise ValueError(f"Modification of unknown object {op.obj}")
    metrics.bump("core_moves_applied")
    if dest.is_sequence:
        _register_list_move(b, op)
        return _resolve_list_realm(b, op.obj, emit)
    stripped: list = []
    _register_map_move(b, op, stripped)
    return _resolve_map_realm(b, emit, pre_pairs=stripped)


def _register_map_move(b: Builder, op, stripped: list | None = None) -> None:
    child_id = op.value
    child = b.by_object.get(child_id)
    if not isinstance(child_id, str) or child is None:
        raise ValueError(f"Move of unknown object {child_id!r}")
    if child_id == ROOT_ID:
        raise ValueError("Cannot move the root object")
    child = b.obj(child_id)
    # monotone domination: candidates causally covered by this move are
    # dead forever (they can never win nor serve as a cycle fallback —
    # the base link below every chain is kept separately). A same-change
    # earlier move of the same child is replaced too: last op wins.
    for ref in [r for r in child.inbound if r.action == "move"]:
        if covers(b, op, ref) or (ref.actor == op.actor
                                  and ref.seq == op.seq):
            child.inbound.pop(ref, None)
            holder = b.by_object.get(ref.obj)
            if holder is not None and ref in holder.fields.get(ref.key, ()):
                hmut = b.obj(ref.obj)
                hmut.fields[ref.key] = tuple(
                    o for o in hmut.fields[ref.key] if o is not ref)
                if stripped is not None:
                    stripped.append((ref.obj, ref.key))
            if child.loc is ref:
                child.loc = None
    child.inbound[op] = None
    b.moved_objs.add(child_id)


def _register_list_move(b: Builder, op) -> None:
    from .opset import MoveEntry, anchored_at_placed

    oid = op.obj
    obj = b.obj(oid)
    eid = op.value
    ins = obj.insertion.get(eid)
    if ins is None:
        raise ValueError(f"Move of unknown list element {eid!r}")
    if op.key != HEAD and op.key not in obj.insertion:
        raise ValueError(f"Move anchored at unknown element {op.key!r}")
    if op.elem is None:
        raise ValueError("List move requires a destination elem counter")
    entry = obj.moves.get(eid)
    if entry is None:
        # first move of this element: the current insertion op IS its
        # original ins (nothing else can have replaced it yet)
        entry = MoveEntry(ins)
    else:
        entry = entry.copy()
    entry.cands = tuple(
        c for c in entry.cands
        if not covers(b, op, c)
        and not (c.actor == op.actor and c.seq == op.seq)) + (op,)
    if op.seq:  # local preview ops re-apply stamped at commit
        q = entry.stamps.get(op.actor)
        if q is None or op.seq < q:
            entry.stamps[op.actor] = op.seq
    obj.moves[eid] = entry
    # this move is itself a sibling op of its anchor: if it tracks the
    # anchor's placement, flag the anchor (winner changes there must
    # reposition this element too)
    if op.key != HEAD:
        aentry = obj.moves.get(op.key)
        if aentry is not None and not aentry.followers \
                and anchored_at_placed(b, obj, op, op.key):
            aentry = aentry.copy()
            aentry.followers = True
            obj.moves[op.key] = aentry
    if op.elem > obj.max_elem:
        obj.max_elem = op.elem


# ---------------------------------------------------------------------------
# the batched admission plane (the span-plane scaffolding, move-shaped)


def _scan(b: Builder, changes: list) -> int | None:
    """Eligibility: every change causally ready in batch order,
    duplicate-free, pure-move ops on existing containers with resolvable
    targets. Mutates nothing; None falls back to the generic path."""
    total = 0
    clock = dict(b.clock)
    for change in changes:
        if not isinstance(change, Change):
            return None
        actor, seq = change.actor, change.seq
        if seq != clock.get(actor, 0) + 1:
            return None
        for a, s in change.deps.items():
            if a != actor and clock.get(a, 0) < s:
                return None
        for op in change.ops:
            if op.action != "move":
                return None
            dest = b.by_object.get(op.obj)
            if dest is None:
                return None
            if dest.is_sequence:
                if (op.value not in dest.insertion or op.elem is None
                        or (op.key != HEAD
                            and op.key not in dest.insertion)):
                    return None
            else:
                child = b.by_object.get(op.value)
                if child is None or op.value == ROOT_ID:
                    return None
            total += 1
        clock[actor] = seq
    return total if total >= MOVE_BATCH_MIN_OPS else None


def try_apply_move_batch(b: Builder, changes: list) -> list[dict] | None:
    """Admit an all-move batch with ONE resolution pass per touched realm
    (winner selection + cycle fixpoint over the union), classifying each
    change sequential-vs-concurrent through admit_change_header exactly
    like the text span plane. Emits one coarse ``{"action": "batch"}``
    record per touched container (frontend/materialize.update_cache folds
    per object); callers needing per-op records must not opt in. Returns
    None when ineligible — the scan mutates nothing, so falling back to
    the per-op path is always safe."""
    if _scan(b, changes) is None:
        return None
    seq_ops = conc_ops = 0
    list_realms: set[str] = set()
    map_realm = False
    stripped: list = []
    for change in changes:
        prev_frontier = b.deps  # admit_change_header rebinds, not mutates
        all_deps = admit_change_header(b, change)
        sequential = True
        for a, s in prev_frontier.items():
            if all_deps.get(a, 0) < s:
                sequential = False
                break
        actor, seq = change.actor, change.seq
        for op in change.ops:
            stamped = op.stamped(actor, seq)
            dest = b.by_object[stamped.obj]
            if dest.is_sequence:
                _register_list_move(b, stamped)
                list_realms.add(stamped.obj)
            else:
                _register_map_move(b, stamped, stripped)
                map_realm = True
        if sequential:
            seq_ops += len(change.ops)
        else:
            conc_ops += len(change.ops)

    touched: set[str] = set()
    touched.update(obj for (obj, _key) in stripped)
    if map_realm:
        _resolve_map_realm(b, emit=False, touched=touched)
    for oid in list_realms:
        _resolve_list_realm(b, oid, emit=False)
        touched.add(oid)
    # emit=False deferred the visible-index maintenance; coarse records +
    # one rebuild per touched list keep materialization exact
    from .opset import rebuild_elem_ids
    for oid in b._deferred_seqs:
        obj = b.by_object.get(oid)
        if obj is not None:
            rebuild_elem_ids(obj, state=b)
    b._deferred_seqs.clear()
    diffs: list[dict] = []
    for oid in touched:
        obj = b.by_object.get(oid)
        kind = ("text" if obj is not None and obj.init_action == "makeText"
                else "list" if obj is not None and obj.is_sequence
                else "map")
        diffs.append({"action": "batch", "type": kind, "obj": oid,
                      "path": get_path(b, oid)})

    metrics.bump("sync_move_batches_merged")
    if seq_ops:
        metrics.bump("sync_move_ops_sequential", seq_ops)
    if conc_ops:
        metrics.bump("sync_move_ops_concurrent", conc_ops)
    return diffs
