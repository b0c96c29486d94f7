"""The CRDT semantic core: causally-ordered op application, LWW conflict
resolution, RGA list ordering, and diff emission.

This is the host-side *oracle* engine. Its semantics mirror the reference's
OpSet (Automerge's src/op_set.js) operation for operation; conformance
targets (each covered by a test in tests/):

- LWW winner among concurrent assigns = highest actorId (op_set.js:201,425);
  losers are retained as conflicts keyed by actor (op_set.js:428-434).
- Concurrent inserts at one position are ordered by Lamport (elem, actor)
  descending, so each actor's runs do not interleave (op_set.js:343-362).
- Delete vs concurrent assign: the assign wins — deletion only removes ops
  causally prior to it (op_set.js:184-199).
- Out-of-order changes buffer in a causal queue until ready (op_set.js:254-270);
  duplicate deliveries are idempotent no-ops; reusing an (actor, seq) with
  different content is an error (op_set.js:227-232).

This is the port's copy of `automerge_tpu/core/opset.py`. The batched
columnar path lives in engine/ and is checked against this engine for
byte-identical convergence (state hashing).

Device: `OpSet.init(device=...)` resolves the device once (`device.py`: the
card unless the caller passes "cpu", raising without one); every OpSet
derived from it and every Builder thawed from those carries it, and each
move realm resolution runs on it (core/moves.py: the packed route is the
B4 kernel on the card, its plain version on the CPU). The reference's
op-lifecycle hand-offs (`utils/oplag.py`: `queue_admitted` at a change's
admission, `queue_park_batch` when a batch leaves changes queued) are not
here: that module comes with the sync service.

Persistence model: `OpSet` instances are immutable. Mutation happens through a
`Builder` that shallow-copies the top-level containers once per *batch* of
changes and copies per-object state on first touch, so old document snapshots
remain valid (the reference achieves the same with Immutable.js throughout,
op_set.js:272-285).
"""

from __future__ import annotations

from typing import Any, Iterator

from ..device import resolve_device
from ..utils import metrics
from ..utils.persist import AList, CowDict, EMPTY_ALIST
from .change import Change, Op
from .ids import HEAD, ROOT_ID, make_elem_id, parse_elem_id
from .elems import ElemList


class Link:
    """Marker for a link value inside an ElemList (points at a child object)."""

    __slots__ = ("obj",)

    def __init__(self, obj: str):
        self.obj = obj

    def __eq__(self, other):
        return isinstance(other, Link) and self.obj == other.obj

    def __hash__(self):
        return hash(("__link__", self.obj))

    def __repr__(self):
        return f"Link({self.obj!r})"


class ObjState:
    """Per-object CRDT state (the reference's byObject entry, op_set.js:63-93).

    - fields: key/elemId -> tuple of surviving assign ops, winner first
    - following: parent elemId -> tuple of 'ins' ops inserted after it
    - insertion: elemId -> the 'ins' op that created it
    - inbound: ordered set (dict keys) of 'link' ops pointing at this object
    - max_elem: per-list Lamport counter for element IDs
    - elem_ids: visible-element order index (lists/text only)
    """

    __slots__ = ("init_action", "fields", "following", "insertion", "inbound",
                 "max_elem", "elem_ids", "moves", "loc")

    def __init__(self, init_action: str):
        self.init_action = init_action
        seq = init_action in ("makeList", "makeText")
        # Sequence objects grow with document length (one fields/insertion
        # entry per element, tombstones included); CowDict makes their
        # per-change-batch snapshot O(1) instead of O(n) — the role
        # Immutable.js Map plays in op_set.js:272-285. Plain maps stay
        # dicts: small, and their key enumeration order is user-visible.
        self.fields: dict[str, tuple[Op, ...]] = CowDict() if seq else {}
        self.following: dict[str, tuple[Op, ...]] = CowDict() if seq else {}
        self.insertion: dict[str, Op] = CowDict() if seq else {}
        self.inbound: dict[Op, None] = {}
        self.max_elem = 0
        self.elem_ids: ElemList | None = ElemList() if seq else None
        # move plane (core/moves.py): per moved list element its
        # (base ins op, non-dominated move candidates); per moved map
        # child its resolved effective location op. Empty/None for every
        # object no move has ever targeted — the reference semantics are
        # untouched until the first move arrives.
        self.moves: dict[str, tuple] = {}
        self.loc: Op | None = None

    def copy(self) -> "ObjState":
        out = ObjState.__new__(ObjState)
        out.init_action = self.init_action
        out.fields = self.fields.copy()
        out.following = self.following.copy()
        out.insertion = self.insertion.copy()
        out.inbound = dict(self.inbound)
        out.max_elem = self.max_elem
        out.elem_ids = self.elem_ids  # copied lazily by Builder.elem_ids_mut
        out.moves = dict(self.moves) if self.moves else {}
        out.loc = self.loc
        return out

    @property
    def is_sequence(self) -> bool:
        return self.init_action in ("makeList", "makeText")


class MoveEntry:
    """Per-moved-list-element move-plane state (one per ObjState.moves
    entry): the original ins (the undroppable base edge and the ghost
    spot's identity), the non-dominated move candidates, the per-actor
    MINIMUM move seq ever seen (`stamps` — what anchored_at_placed tests
    against; additions are monotone and already-admitted siblings can
    never cover a later-arriving move, so the ghost/placed split never
    flips), and whether any sibling op follows the placed spot (the flag
    that forces a full index rebuild when the winner changes)."""

    __slots__ = ("base", "cands", "stamps", "followers")

    def __init__(self, base: Op, cands: tuple = (),
                 stamps: dict | None = None, followers: bool = False):
        self.base = base
        self.cands = cands
        self.stamps = stamps if stamps is not None else {}
        self.followers = followers

    def copy(self) -> "MoveEntry":
        return MoveEntry(self.base, self.cands, dict(self.stamps),
                         self.followers)


class Builder:
    """Copy-on-write working state for applying a batch of changes."""

    __slots__ = ("states", "by_object", "clock", "deps", "queue", "history",
                 "moved_objs", "device", "_touched", "_elem_copied",
                 "_deferred_seqs")

    def __init__(self, opset: "OpSet"):
        self.device = opset.device
        self.states: dict[str, AList] = dict(opset.states)
        self.by_object: dict[str, ObjState] = dict(opset.by_object)
        self.clock: dict[str, int] = dict(opset.clock)
        self.deps: dict[str, int] = dict(opset.deps)
        self.queue: list[Change] = list(opset.queue)
        self.history: AList = opset.history
        self.moved_objs: set[str] = set(opset.moved_objs)
        self._touched: set[str] = set()
        self._elem_copied: set[str] = set()
        # sequence objects whose elem_ids maintenance was deferred by a
        # no-diff apply (add_changes(emit_diffs=False)); rebuilt once at
        # the end of the batch
        self._deferred_seqs: set[str] = set()

    def obj(self, object_id: str) -> ObjState:
        """Object state for mutation (copied on first touch in this batch)."""
        obj = self.by_object[object_id]
        if object_id not in self._touched:
            obj = obj.copy()
            self.by_object[object_id] = obj
            self._touched.add(object_id)
        return obj

    def elem_ids_mut(self, object_id: str) -> ElemList:
        obj = self.obj(object_id)
        if object_id not in self._elem_copied:
            obj.elem_ids = obj.elem_ids.copy()
            self._elem_copied.add(object_id)
        return obj.elem_ids


# ---------------------------------------------------------------------------
# Causality (op_set.js:7-37)

def is_concurrent(state, op1: Op, op2: Op) -> bool:
    """True if neither stamped op causally precedes the other (op_set.js:7-16).

    Ops lacking a (actor, seq) stamp — i.e. local ops inside an open change
    block — are never concurrent with anything: prior ops are treated as
    overwritten by the local edit.
    """
    a1, s1, a2, s2 = op1.actor, op1.seq, op2.actor, op2.seq
    if not a1 or not a2 or not s1 or not s2:
        return False
    clock1 = state.states[a1][s1 - 1][1]
    clock2 = state.states[a2][s2 - 1][1]
    return clock1.get(a2, 0) < s2 and clock2.get(a1, 0) < s1


def causally_ready(state, change: Change) -> bool:
    """True if every causal predecessor of `change` has been applied
    (op_set.js:20-27)."""
    if state.clock.get(change.actor, 0) < change.seq - 1:
        return False
    for actor, seq in change.deps.items():
        if actor != change.actor and state.clock.get(actor, 0) < seq:
            return False
    return True


def transitive_deps(state, base_deps: dict[str, int]) -> dict[str, int]:
    """Expand a dependency frontier into a full vector clock (op_set.js:29-37).

    Unknown (actor, seq) entries — possible when computing missing changes
    against a peer that is ahead of us — contribute only themselves.
    """
    out: dict[str, int] = {}
    for actor, seq in base_deps.items():
        if seq <= 0:
            continue
        entries = state.states.get(actor)
        if entries is not None and seq - 1 < len(entries):
            for dep_actor, dep_seq in entries[seq - 1][1].items():
                if dep_seq > out.get(dep_actor, 0):
                    out[dep_actor] = dep_seq
        out[actor] = seq
    return out


# ---------------------------------------------------------------------------
# Paths and RGA traversal (op_set.js:43-60, 343-397)
#
# Ghost spots (the move plane, core/moves.py): a moved-away list element
# leaves its original `ins` in the insertion tree as an invisible GHOST —
# elements anchored at it keep their positions (the anchor relation is an
# ordering artifact, not containment), while the element itself is placed
# by its winning move op. A sibling op that causally KNOWS some move of
# its anchor (`anchored_at_placed`) follows the anchor's placed spot
# instead — that predicate is decidable at the sibling's admission
# (causal delivery: any move it covers has already arrived) and never
# flips afterwards, so positions are stable and delivery-order-free.
# Traversal walks spot-qualified ids: `eid` is the element's placed spot,
# `eid + GHOST_SUFFIX` its ghost. Ghost ids never appear in elem_ids,
# diffs, or on the wire.

GHOST_SUFFIX = "\x00g"


def is_ghost(key: str) -> bool:
    return key.endswith(GHOST_SUFFIX)


def strip_ghost(key: str) -> str:
    return key[:-len(GHOST_SUFFIX)] if key.endswith(GHOST_SUFFIX) else key


def moved_away(obj, eid: str) -> bool:
    """True when `eid`'s effective placement is a move op (its original
    ins spot is a ghost)."""
    if not obj.moves or eid not in obj.moves:
        return False
    placed = obj.insertion.get(eid)
    return placed is not None and placed.action == "move"


def anchored_at_placed(state, obj, sib_op, anchor_eid: str) -> bool:
    """True when sibling op `sib_op` (ins or move) anchored at
    `anchor_eid` follows the anchor's PLACED spot: it causally covers at
    least one move of the anchor. Stable from the op's admission on."""
    entry = obj.moves.get(anchor_eid)
    if entry is None:
        return False
    actor, seq = sib_op.actor, sib_op.seq
    if not actor or not seq:
        return True  # local unstamped op: sees the current placement
    clock = None
    for a, q in entry.stamps.items():
        if a == actor:
            if seq > q:
                return True
            continue
        if clock is None:
            clock = state.states[actor][seq - 1][1]
        if clock.get(a, 0) >= q:
            return True
    return False


def spot_of(state, obj, anchor_key: str, via_op) -> str:
    """Spot-qualified id of `via_op`'s anchor: the placed spot when the
    op causally follows the anchor's relocation, else the ghost spot."""
    if anchor_key == HEAD or not moved_away(obj, anchor_key):
        return anchor_key
    if anchored_at_placed(state, obj, via_op, anchor_key):
        return anchor_key
    return anchor_key + GHOST_SUFFIX

def get_path(state, object_id: str) -> list | None:
    """Path from the root to `object_id` (string keys for maps, integer
    indexes for lists), or None if unreachable (op_set.js:43-60)."""
    path: list = []
    while object_id != ROOT_ID:
        obj = state.by_object.get(object_id)
        if obj is None or not obj.inbound:
            return None
        # a move-targeted object's position is its RESOLVED location
        # (core/moves.py); everything else keeps first-inbound semantics
        ref = obj.loc if obj.loc is not None else next(iter(obj.inbound))
        object_id = ref.obj
        parent = state.by_object[object_id]
        if parent.is_sequence:
            index = parent.elem_ids.index_of(ref.key)
            if index < 0:
                return None
            path.insert(0, index)
        else:
            path.insert(0, ref.key)
    return path


def get_parent(state, object_id: str, key: str) -> str | None:
    """Spot-qualified anchor after which `key` sits, or None for the head
    (op_set.js:336-341). A ghost spot's anchor comes from the element's
    original ins; a placed spot's from its effective placement op."""
    if key == HEAD:
        return None
    obj = state.by_object[object_id]
    if is_ghost(key):
        entry = obj.moves.get(strip_ghost(key))
        if entry is None:
            raise TypeError(f"Missing move entry for ghost {key!r}")
        op = entry.base
    else:
        op = obj.insertion.get(key)
        if op is None:
            raise TypeError(f"Missing index entry for list element {key}")
    if op.key == HEAD:
        return HEAD
    return spot_of(state, obj, op.key, op)


def insertions_after(state, object_id: str, parent_id: str,
                     child_id: str | None = None) -> list[str]:
    """Element IDs inserted directly after `parent_id`, in Lamport-descending
    (elem, actor) order; if `child_id` is given, only those ordered before it
    (op_set.js:351-362)."""
    obj = state.by_object[object_id]
    anchor = strip_ghost(parent_id) if parent_id else parent_id
    ops = [op for op in obj.following.get(anchor, ())
           if op.action == "ins" or op.action == "move"]
    if parent_id and obj.moves and moved_away(obj, anchor):
        # the anchor element has a ghost and a placed spot: each sibling
        # op belongs to exactly one of them (anchored_at_placed is stable
        # from its admission, so this split never flips)
        want_placed = not is_ghost(parent_id)
        ops = [op for op in ops
               if anchored_at_placed(state, obj, op, anchor) == want_placed]
    if child_id:
        # a moved child bound compares by its PLACEMENT op's stamp, not
        # by the stamp embedded in its id; a ghost bound by its ins
        cid = strip_ghost(child_id)
        placed = (obj.moves[cid].base if is_ghost(child_id)
                  else obj.insertion.get(cid))
        if placed is not None and (placed.action == "move"
                                   or is_ghost(child_id)):
            child_elem, child_actor = placed.elem, placed.actor
        else:
            child_actor, child_elem = parse_elem_id(cid)
        ops = [op for op in ops
               if (op.elem, op.actor) < (child_elem, child_actor)]
    ops.sort(key=lambda op: (op.elem, op.actor), reverse=True)
    out = []
    for op in ops:
        if op.action == "move":
            out.append(op.value)          # the element at its placed spot
        else:
            eid = make_elem_id(op.actor, op.elem)
            out.append(eid + GHOST_SUFFIX if moved_away(obj, eid) else eid)
    return out


def get_next(state, object_id: str, key: str) -> str | None:
    """Successor of `key` in RGA document order (op_set.js:364-376)."""
    children = insertions_after(state, object_id, key)
    if children:
        return children[0]
    while True:
        ancestor = get_parent(state, object_id, key)
        if ancestor is None:
            return None
        siblings = insertions_after(state, object_id, ancestor, key)
        if siblings:
            return siblings[0]
        key = ancestor


def get_previous(state, object_id: str, key: str) -> str | None:
    """Predecessor of `key` in RGA document order, or None at the head
    (op_set.js:380-397)."""
    parent_id = get_parent(state, object_id, key)
    children = insertions_after(state, object_id, parent_id if parent_id is not None else HEAD)
    if children and children[0] == key:
        return None if (parent_id is None or parent_id == HEAD) else parent_id

    prev_id = None
    for child in children:
        if child == key:
            break
        prev_id = child
    while True:
        children = insertions_after(state, object_id, prev_id)
        if not children:
            return prev_id
        prev_id = children[-1]


def iter_list_elem_ids(state, object_id: str) -> Iterator[str]:
    """All element IDs of a list/text object in RGA document order (including
    deleted ones). Iterative preorder walk of the insertion tree — sequential
    text insertions form a chain as deep as the document, so recursion is not
    an option (the columnar engine linearizes the same tree with a sort-based
    kernel instead, see engine/kernels.py)."""
    stack = [iter(insertions_after(state, object_id, HEAD))]
    while stack:
        nxt = next(stack[-1], None)
        if nxt is None:
            stack.pop()
            continue
        yield nxt
        stack.append(iter(insertions_after(state, object_id, nxt)))


# ---------------------------------------------------------------------------
# Op application (op_set.js:63-252)

def _type_of(obj: ObjState) -> str:
    if obj.init_action == "makeText":
        return "text"
    if obj.init_action == "makeList":
        return "list"
    return "map"


def _conflict_records(ops: tuple[Op, ...]) -> list[dict]:
    """Conflict (loser) records for a multi-op field (op_set.js:95-103)."""
    out = []
    for op in ops[1:]:
        record: dict[str, Any] = {"actor": op.actor, "value": op.value}
        if op.action in ("link", "move"):
            record["link"] = True  # a map move's value IS a child object id
        out.append(record)
    return out


def apply_make(b: Builder, op: Op) -> list[dict]:
    object_id = op.obj
    if object_id in b.by_object:
        raise ValueError(f"Duplicate creation of object {object_id}")
    obj = ObjState(op.action)
    b.by_object[object_id] = obj
    b._touched.add(object_id)
    b._elem_copied.add(object_id)
    return [{"action": "create", "type": _type_of(obj), "obj": object_id}]


def apply_insert(b: Builder, op: Op) -> list[dict]:
    object_id = op.obj
    elem_id = make_elem_id(op.actor, op.elem)
    if object_id not in b.by_object:
        raise ValueError(f"Modification of unknown object {object_id}")
    obj = b.obj(object_id)
    if elem_id in obj.insertion:
        raise ValueError(f"Duplicate list element ID {elem_id}")
    obj.following[op.key] = obj.following.get(op.key, ()) + (op,)
    obj.max_elem = max(op.elem, obj.max_elem)
    obj.insertion[elem_id] = op
    if obj.moves:
        entry = obj.moves.get(op.key)
        if entry is not None and anchored_at_placed(b, obj, op, op.key):
            # this insert tracks the anchor's placement: a future winner
            # change must reposition it too (full-index rebuild path)
            if not entry.followers:
                entry = entry.copy()
                entry.followers = True
                obj.moves[op.key] = entry
    return []


def patch_list(b: Builder, object_id: str, index: int, action: str,
               ops: tuple[Op, ...] | None) -> list[dict]:
    obj = b.by_object[object_id]
    first = ops[0] if ops else None
    value = first.value if first is not None else None
    edit: dict[str, Any] = {"action": action, "type": _type_of(obj),
                            "obj": object_id, "index": index,
                            "path": get_path(b, object_id)}
    if first is not None and first.action == "link":
        edit["link"] = True
        value = Link(first.value)

    elem_ids = b.elem_ids_mut(object_id)
    if action == "insert":
        elem_ids.insert_index(index, first.key, value)
        edit["value"] = first.value
    elif action == "set":
        elem_ids.set_value(first.key, value)
        edit["value"] = first.value
    elif action == "remove":
        elem_ids.remove_index(index)
    else:
        raise ValueError(f"Unknown action type: {action}")

    if ops is not None and len(ops) > 1:
        edit["conflicts"] = _conflict_records(ops)
    return [edit]


def update_list_element(b: Builder, object_id: str, elem_id: str) -> list[dict]:
    obj = b.by_object[object_id]
    ops = obj.fields.get(elem_id, ())
    index = obj.elem_ids.index_of(elem_id)

    if index >= 0:
        if not ops:
            return patch_list(b, object_id, index, "remove", None)
        return patch_list(b, object_id, index, "set", ops)

    if not ops:
        return []  # deleting a non-existent element is a no-op

    # Find the closest visible predecessor element (op_set.js:146-156).
    prev_id = elem_id
    while True:
        index = -1
        prev_id = get_previous(b, object_id, prev_id)
        if prev_id is None:
            break
        index = obj.elem_ids.index_of(prev_id)
        if index >= 0:
            break
    return patch_list(b, object_id, index + 1, "insert", ops)


def update_map_key(b: Builder, object_id: str, key: str) -> list[dict]:
    ops = b.by_object[object_id].fields.get(key, ())
    edit: dict[str, Any] = {"action": "", "type": "map", "obj": object_id,
                            "key": key, "path": get_path(b, object_id)}
    if not ops:
        edit["action"] = "remove"
    else:
        edit["action"] = "set"
        edit["value"] = ops[0].value
        if ops[0].action in ("link", "move"):
            edit["link"] = True
        if len(ops) > 1:
            edit["conflicts"] = _conflict_records(ops)
    return [edit]


def apply_assign(b: Builder, op: Op, emit: bool = True) -> list[dict]:
    object_id = op.obj
    if object_id not in b.by_object:
        raise ValueError(f"Modification of unknown object {object_id}")
    obj = b.obj(object_id)

    prior = obj.fields.get(op.key, ())
    overwritten, remaining = [], []
    for prior_op in prior:
        (remaining if is_concurrent(b, prior_op, op) else overwritten).append(prior_op)

    # Overwritten links disappear from the target's inbound index.
    for dead in overwritten:
        if dead.action == "link":
            target = b.obj(dead.value)
            target.inbound.pop(dead, None)

    if op.action == "link":
        if op.value not in b.by_object:
            raise ValueError(f"Link to unknown object {op.value}")
        b.obj(op.value).inbound[op] = None
    if op.action != "del":
        remaining.append(op)

    # Survivors sorted by actor descending: the highest actor wins LWW
    # (op_set.js:201; winner read at op_set.js:425).
    remaining.sort(key=lambda o: o.actor or "", reverse=True)
    obj.fields[op.key] = tuple(remaining)

    # single-location rule for move-managed children (core/moves.py): a
    # link to a child whose position is move-resolved registers as a
    # potential base edge (inbound) but must not ALSO present the child
    # beside its effective location
    if op.action == "link" and op.value in b.moved_objs:
        child = b.by_object[op.value]
        if child.loc is not None and child.loc is not op:
            obj.fields[op.key] = tuple(
                o for o in obj.fields[op.key] if o is not op)

    if not emit:
        # No-diff mode (from-scratch loads): edit records have no consumer
        # and elem_ids maintenance — the per-op O(sqrt n) index work — is
        # deferred to one rebuild_elem_ids pass at end of batch. The
        # reference cannot skip this (its frontends are diff-driven,
        # op_set.js:105-129); ours materializes from state.
        if obj.is_sequence:
            b._deferred_seqs.add(object_id)
        return _NO_DIFFS
    if obj.is_sequence:
        return update_list_element(b, object_id, op.key)
    return update_map_key(b, object_id, op.key)


# immutable empty sentinel: returned (never mutated) by the no-diff
# apply paths so emit=False costs zero allocations per op
_NO_DIFFS: tuple = ()


def _queue_gauges(b: "Builder") -> None:
    """Causal-queue gauges after a batch (THE one definition — every
    add_changes exit path reports them): a growing depth means peers are
    delivering out of causal order (or a dep will never arrive); bytes
    are a coarse per-change host-object estimate (header + per-op
    records — exact sizeof walks would cost more than the queue is
    worth)."""
    metrics.gauge("core_queue_depth", len(b.queue))
    metrics.gauge("core_queue_bytes",
                  sum(120 + 80 * len(c.ops) for c in b.queue))


def rebuild_elem_ids(obj: "ObjState", actor_rank: dict | None = None,
                     state=None) -> None:
    """Rebuild a sequence object's visible-element index from its insertion
    tree in one pass: native RGA linearization over every insertion (the
    same algorithm the incremental path applies per-op), then a bulk
    ElemList build of the visible elements (those with surviving field
    ops), winner value first. Shared by the bulk loader (core/bulkload.py
    step 7) and the no-diff interpretive load (add_changes(emit_diffs=
    False)); O(n) total instead of O(ops * sqrt n) incremental upkeep."""
    import numpy as np

    from ..native.linearize import linearize_host

    # iterate (eid, op) pairs: a moved element's effective op carries the
    # MOVE stamp for ordering while the dict key keeps its identity
    ins_items = list(obj.insertion.items())
    n = len(ins_items)
    if n == 0:
        obj.elem_ids = ElemList()
        return
    if obj.moves:
        # moved lists have ghost/placed spot splits the native linearizer
        # cannot see (and can violate its parent.elem < child.elem
        # invariant): rebuild by walking the insertion tree in document
        # order instead — same O(n log n), no invariant needed. The walk
        # needs the states table for the anchored_at_placed predicate.
        if state is None:
            raise ValueError("rebuilding a moved list requires state")
        _rebuild_by_walk(obj, state)
        return
    if actor_rank is None:
        # ranks need only be order-isomorphic to the actor strings for
        # sibling comparisons within this object
        actor_rank = {a: r for r, a in enumerate(
            sorted({op.actor for _eid, op in ins_items}))}
    slot_of = {eid: s for s, (eid, _op) in enumerate(ins_items)}
    elem = np.fromiter((op.elem for _e, op in ins_items), np.int32, n)
    arank = np.fromiter((actor_rank[op.actor] for _e, op in ins_items),
                        np.int32, n)
    parent = np.fromiter(
        ((-1 if op.key == HEAD else slot_of[op.key])
         for _e, op in ins_items),
        np.int32, n)
    pos = linearize_host(np.ones(n, bool), elem, arank, parent)
    keys_v, values_v = [], []
    fields_get = obj.fields.get
    for s in np.argsort(pos, kind="stable").tolist():
        eid = ins_items[s][0]
        fops = fields_get(eid)
        if not fops:
            continue
        first = fops[0]
        keys_v.append(eid)
        values_v.append(Link(first.value) if first.action == "link"
                        else first.value)
    obj.elem_ids = ElemList(keys_v, values_v)


def _rebuild_by_walk(obj: "ObjState", state) -> None:
    """Visible-index rebuild by insertion-tree walk (move-aware twin of
    the linearize_host path above). Ghost spots yield no entry — their
    ids are not fields keys — but their subtrees are walked through."""
    keys_v, values_v = [], []
    fields_get = obj.fields.get
    for eid in iter_list_elem_ids(_ObjView(obj, state), "_"):
        fops = fields_get(eid)
        if not fops:
            continue
        first = fops[0]
        keys_v.append(eid)
        values_v.append(Link(first.value) if first.action == "link"
                        else first.value)
    obj.elem_ids = ElemList(keys_v, values_v)


class _ObjView:
    """Minimal state adapter so the RGA traversal helpers accept a bare
    ObjState (rebuilds run outside any Builder)."""
    __slots__ = ("by_object", "states")

    def __init__(self, obj, state=None):
        self.by_object = {"_": obj}
        self.states = state.states if state is not None else {}


def apply_op(b: Builder, op: Op, emit: bool = True) -> list[dict]:
    action = op.action
    if action in ("makeMap", "makeList", "makeText"):
        made = apply_make(b, op)
        return made if emit else _NO_DIFFS
    if action == "ins":
        return apply_insert(b, op)
    if action in ("set", "del", "link"):
        return apply_assign(b, op, emit)
    if action == "move":
        from .moves import apply_move
        return apply_move(b, op, emit)
    raise ValueError(f"Unknown operation type {action}")


def admit_change_header(b: Builder, change: Change) -> dict | None:
    """The op-independent half of applying one causally-ready change:
    duplicate-delivery check, transitive-clock computation, states/clock/
    deps/history bookkeeping (op_set.js:224-241, 243-248). Returns the
    change's full vector clock, or None for an idempotent re-delivery.
    Shared by the per-op path below and the batched text-merge plane
    (core/textspans.py), so both admit changes bit-identically."""
    actor, seq = change.actor, change.seq
    prior = b.states.get(actor, EMPTY_ALIST)
    if seq <= len(prior):
        if prior[seq - 1][0] != change:
            raise ValueError(f"Inconsistent reuse of sequence number {seq} by {actor}")
        return None  # idempotent re-delivery

    base = dict(change.deps)
    base[actor] = seq - 1
    all_deps = transitive_deps(b, base)
    b.states[actor] = prior.append((change, all_deps))
    b.deps = {a: s for a, s in b.deps.items() if s > all_deps.get(a, 0)}
    b.deps[actor] = seq
    b.clock[actor] = seq
    b.history = b.history.append(change)
    metrics.bump("core_changes_applied")
    metrics.bump("core_ops_applied", len(change.ops))
    return all_deps


def apply_change(b: Builder, change: Change, emit: bool = True) -> list[dict]:
    """Apply one causally-ready change (op_set.js:224-252)."""
    actor, seq = change.actor, change.seq
    # ops apply against the PRE-admission states view only through the
    # stamped clocks, which admit_change_header has already appended —
    # exactly the order the reference applies them in (op_set.js:224-241)
    if admit_change_header(b, change) is None:
        return []  # idempotent re-delivery

    diffs: list[dict] = []
    for op in change.ops:
        d = apply_op(b, op.stamped(actor, seq), emit)
        if d:
            diffs.extend(d)
    metrics.bump("core_diffs_emitted", len(diffs))
    return diffs


def apply_queued_ops(b: Builder, emit: bool = True) -> list[dict]:
    """Fixpoint drain of the causal queue (op_set.js:254-270)."""
    diffs: list[dict] = []
    while True:
        leftover: list[Change] = []
        progressed = False
        for change in b.queue:
            if causally_ready(b, change):
                diffs.extend(apply_change(b, change, emit))
                progressed = True
            else:
                leftover.append(change)
        b.queue = leftover
        if not progressed or not leftover:
            return diffs


# ---------------------------------------------------------------------------
# Read queries (op_set.js:332-479)

def valid_field_name(key) -> bool:
    return isinstance(key, str) and key != "" and not key.startswith("_")


def get_field_ops(state, object_id: str, key: str) -> tuple[Op, ...]:
    obj = state.by_object.get(object_id)
    if obj is None:
        return ()
    return obj.fields.get(key, ())


def get_object_fields(state, object_id: str) -> list[str]:
    """Present field names of a map object, in field-creation order."""
    obj = state.by_object[object_id]
    return [key for key, ops in obj.fields.items()
            if valid_field_name(key) and ops]


def list_length(state, object_id: str) -> int:
    return len(state.by_object[object_id].elem_ids)


# ---------------------------------------------------------------------------
# The persistent OpSet

class OpSet:
    """Immutable CRDT state for one document (op_set.js:272-285).

    undo_pos / undo_stack / redo_stack live here (as in the reference) but are
    maintained by the change-assembly layer (api.py),
    mirroring auto_api.js:41-111.
    """

    __slots__ = ("states", "by_object", "clock", "deps", "queue", "history",
                 "moved_objs", "undo_pos", "undo_stack", "redo_stack",
                 "device")

    def __init__(self, states, by_object, clock, deps, queue, history,
                 undo_pos=0, undo_stack=(), redo_stack=(),
                 moved_objs=frozenset(), device=None):
        self.states = states          # actor -> AList[(Change, all_deps)]
        self.by_object = by_object    # objectId -> ObjState
        self.clock = clock            # actor -> seq
        self.deps = deps              # pruned dependency frontier
        self.queue = queue            # tuple of causally-unready changes
        self.history = history        # AList[Change], application order
        self.moved_objs = moved_objs  # map-realm children with move cands
        self.undo_pos = undo_pos
        self.undo_stack = undo_stack  # tuple of tuples of undo Ops
        self.redo_stack = redo_stack
        self.device = device          # torch.device move realms resolve on

    @staticmethod
    def init(device="cuda") -> "OpSet":
        """An empty document on `device` (resolved here, once)."""
        return OpSet(states={}, by_object={ROOT_ID: ObjState("makeMap")},
                     clock={}, deps={}, queue=(), history=EMPTY_ALIST,
                     device=resolve_device(device))

    def thaw(self) -> Builder:
        return Builder(self)

    def freeze(self, b: Builder, undo_pos=None, undo_stack=None,
               redo_stack=None) -> "OpSet":
        return OpSet(states=b.states, by_object=b.by_object, clock=b.clock,
                     deps=b.deps, queue=tuple(b.queue), history=b.history,
                     moved_objs=frozenset(b.moved_objs), device=self.device,
                     undo_pos=self.undo_pos if undo_pos is None else undo_pos,
                     undo_stack=self.undo_stack if undo_stack is None else undo_stack,
                     redo_stack=self.redo_stack if redo_stack is None else redo_stack)

    def replace_undo(self, undo_pos=None, undo_stack=None, redo_stack=None) -> "OpSet":
        return OpSet(states=self.states, by_object=self.by_object,
                     clock=self.clock, deps=self.deps, queue=self.queue,
                     history=self.history, moved_objs=self.moved_objs,
                     device=self.device,
                     undo_pos=self.undo_pos if undo_pos is None else undo_pos,
                     undo_stack=self.undo_stack if undo_stack is None else undo_stack,
                     redo_stack=self.redo_stack if redo_stack is None else redo_stack)

    # -- change ingestion ---------------------------------------------------

    def add_change(self, change: Change) -> tuple["OpSet", list[dict]]:
        return self.add_changes([change])

    def add_changes(self, changes, emit_diffs: bool = True,
                    text_batch: bool = False,
                    move_batch: bool = False) -> tuple["OpSet", list[dict]]:
        """Queue + causally apply a batch of changes (op_set.js:294-297).

        emit_diffs=False is the from-scratch-load fast path: no edit
        records are produced (returns an empty diff list) and sequence
        index maintenance is deferred to ONE rebuild per touched list at
        the end of the batch. State is bit-identical to the emitting path
        — pinned by tests/test_nodiff_apply.py.

        text_batch=True offers the batch to the span-granularity text
        merge plane (core/textspans.py) first: a large all-text batch is
        admitted with visible-order maintenance at SPAN granularity (one
        placement + splice per contiguous run instead of per op) and
        returns ONE coarse diff per touched object ({"action": "batch"})
        instead of per-op edits — callers that fold diffs per object
        (frontend/materialize.update_cache) are unaffected; callers that
        need per-op edit records must not opt in. State is bit-identical
        to the per-op path (tests/test_textspans.py)."""
        if text_batch and emit_diffs and not self.queue:
            from .textspans import TEXT_BATCH_MIN_OPS, try_apply_text_batch
            changes = list(changes)
            # pre-thaw gate: a below-threshold batch (every interactive
            # keystroke takes this path) must not pay a Builder
            # construction just to be rejected by the scan
            if sum(len(c.ops) for c in changes
                   if isinstance(c, Change)) >= TEXT_BATCH_MIN_OPS:
                b = self.thaw()
                batch_diffs = try_apply_text_batch(b, changes)
                if batch_diffs is not None:
                    _queue_gauges(b)
                    return self.freeze(b), batch_diffs
                # ineligible: fall through on a FRESH builder (the scan
                # phase mutates nothing, but a clean thaw keeps that
                # contract local)
        if move_batch and emit_diffs and not self.queue:
            # the move twin of the text plane: an all-move batch admits
            # with ONE winner+cycle resolution per touched realm
            # (core/moves.py), kernel-routed above the size threshold
            from .moves import MOVE_BATCH_MIN_OPS, try_apply_move_batch
            changes = list(changes)
            if sum(len(c.ops) for c in changes
                   if isinstance(c, Change)) >= MOVE_BATCH_MIN_OPS:
                b = self.thaw()
                batch_diffs = try_apply_move_batch(b, changes)
                if batch_diffs is not None:
                    _queue_gauges(b)
                    return self.freeze(b), batch_diffs
        b = self.thaw()
        diffs: list[dict] = []
        for change in changes:
            b.queue.append(change)
            d = apply_queued_ops(b, emit_diffs)
            if d:
                diffs.extend(d)
        if b._deferred_seqs:
            for oid in b._deferred_seqs:
                obj = b.by_object.get(oid)
                if obj is not None:
                    rebuild_elem_ids(obj, state=b)
            b._deferred_seqs.clear()
        _queue_gauges(b)
        return self.freeze(b), diffs

    # -- change-graph queries (op_set.js:299-330) ---------------------------

    def get_missing_changes(self, have_deps: dict[str, int]) -> list[Change]:
        all_deps = transitive_deps(self, have_deps)
        out: list[Change] = []
        for actor, entries in self.states.items():
            skip = all_deps.get(actor, 0)
            for i in range(skip, len(entries)):
                out.append(entries[i][0])
        return out

    def get_changes_for_actor(self, for_actor: str, after_seq: int = 0) -> list[Change]:
        entries = self.states.get(for_actor, EMPTY_ALIST)
        return [entries[i][0] for i in range(after_seq, len(entries))]

    def get_missing_deps(self) -> dict[str, int]:
        missing: dict[str, int] = {}
        for change in self.queue:
            deps = dict(change.deps)
            deps[change.actor] = change.seq - 1
            for actor, seq in deps.items():
                if self.clock.get(actor, 0) < seq:
                    missing[actor] = max(seq, missing.get(actor, 0))
        return missing
