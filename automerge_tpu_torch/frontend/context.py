"""Mutation capture: the write path inside a change block.

The reference implements this with ES Proxies feeding op-generator functions
(Automerge's src/automerge.js:11-139, src/proxies.js). The Python analog is
an explicit ChangeContext: proxies (frontend/proxies.py) translate item/
attribute assignment into context calls; the context generates ops, applies
them eagerly to a working copy of the OpSet (so reads inside the callback see
the new values), and records the op list + undo ops for change assembly.

The working state is discarded when the change is committed: the assembled
change is re-applied to the document's original OpSet through the normal
causal pipeline, exactly as the reference does (SURVEY.md §3.2).
"""

from __future__ import annotations

from typing import Any

from ..core import opset as O
from ..core.change import Op
from ..core.ids import HEAD, make_elem_id
from ..core.opset import Builder
from ..utils.uuid import make_uuid
from .snapshots import FrozenList, FrozenMap
from .text import Text


def is_object_value(value) -> bool:
    return isinstance(value, (dict, list, tuple, Text, FrozenMap, FrozenList)) or \
        hasattr(value, "_object_id")


def parse_list_index(key) -> int:
    """Accept non-negative ints (or digit strings) as list indexes
    (automerge.js:151-158)."""
    if isinstance(key, str) and key.isdigit():
        key = int(key)
    if isinstance(key, bool) or not isinstance(key, int):
        raise TypeError(f"A list index must be a number, but you passed {key!r}")
    if key < 0:
        raise IndexError(f"A list index must be positive, but you passed {key}")
    return key


class ChangeContext:
    """Collects ops for one change block and applies them to a working state."""

    def __init__(self, doc_state):
        self.actor_id: str = doc_state.actor_id
        self._builder: Builder = doc_state.opset.thaw()
        self._preview_pending: list[Op] = []
        self.local: list[Op] = []
        self.undo_local: list[Op] = []
        self.mutable = True

    @property
    def builder(self) -> Builder:
        """The preview working state, synced lazily: pending local ops
        apply only when something READS builder state (read-your-writes
        preserved — every read path goes through this property). A
        write-only change block (the interactive keystroke shape: one
        insert/delete, no reads after) never pays the preview apply at
        all — the commit path re-applies the collected ops to the real
        opset anyway, so the eager preview was pure duplicated work
        (measured 44% of config 7's per-keystroke cost, r16)."""
        pend = self._preview_pending
        if pend:
            self._preview_pending = []
            for op in pend:
                O.apply_op(self._builder, op)
        return self._builder

    # -- op generation ------------------------------------------------------

    def _make_op(self, op: Op, undo_ops=None) -> None:
        """Record a local op; the preview state applies it lazily at the
        next read (automerge.js:11-18, op_set.js:287-292 apply eagerly —
        but their frontends are diff-driven and must; ours previews from
        state)."""
        self.local.append(op)
        if undo_ops:
            self.undo_local.extend(u.stripped() for u in undo_ops)
        self._preview_pending.append(op.stamped(self.actor_id, None))

    def insert_after(self, list_id: str, elem_id: str) -> str:
        """Insert a fresh element after `elem_id`; returns the new element's ID
        (automerge.js:29-37)."""
        obj = self.builder.by_object.get(list_id)
        if obj is None:
            raise ValueError("List object does not exist")
        if elem_id != HEAD and elem_id not in obj.fields:
            raise ValueError("Preceding list element does not exist")
        elem = obj.max_elem + 1
        self._make_op(Op("ins", list_id, key=elem_id, elem=elem))
        return make_elem_id(self.actor_id, elem)

    def create_nested_objects(self, value) -> str:
        """Recursively turn a plain dict/list/Text into CRDT objects
        (automerge.js:39-58). A value that already has an _object_id is linked
        in place rather than copied."""
        existing = getattr(value, "_object_id", None)
        if isinstance(existing, str):
            return existing
        object_id = make_uuid()

        if isinstance(value, Text):
            self._make_op(Op("makeText", object_id))
            if len(value) > 0:
                raise ValueError("assigning a non-empty Text is not yet supported")
        elif isinstance(value, (list, tuple)):
            self._make_op(Op("makeList", object_id))
            elem_id = HEAD
            for item in value:
                elem_id = self.insert_after(object_id, elem_id)
                self.set_field(object_id, elem_id, item, top_level=False,
                               fresh=True)
        elif isinstance(value, dict):
            self._make_op(Op("makeMap", object_id))
            for key, item in value.items():
                self.set_field(object_id, key, item, top_level=False)
        else:
            raise TypeError(f"Unsupported object type: {type(value).__name__}")
        return object_id

    def _reaches(self, src_id: str, target_id: str) -> bool:
        """True if `target_id` is reachable from `src_id` via link ops — used
        to refuse reference cycles, which a JSON document model cannot
        represent (the reference would loop forever on them instead)."""
        stack, visited = [src_id], set()
        while stack:
            oid = stack.pop()
            if oid == target_id:
                return True
            if oid in visited:
                continue
            visited.add(oid)
            obj = self.builder.by_object.get(oid)
            if obj is None:
                continue
            for ops in obj.fields.values():
                for op in ops:
                    if op.action == "link":
                        stack.append(op.value)
        return False

    def move_key(self, dest_id: str, dest_key: str, child_id: str) -> None:
        """Reparent child object `child_id` under map `dest_id` at
        `dest_key` as ONE move op (the r16 move plane, core/moves.py) —
        the old location empties and the subtree is never duplicated.
        Local cycles are refused eagerly like link cycles; CONCURRENT
        cycles resolve deterministically at merge time."""
        if not isinstance(dest_key, str) or not dest_key \
                or dest_key.startswith("_"):
            raise TypeError(f"Invalid destination key {dest_key!r}")
        dest = self.builder.by_object.get(dest_id)
        if dest is None:
            raise ValueError("Destination object does not exist")
        if dest.is_sequence:
            raise TypeError("move_key destination must be a map")
        if self.builder.by_object.get(child_id) is None:
            raise ValueError("Moved object does not exist")
        if child_id == dest_id or self._reaches(child_id, dest_id):
            raise ValueError("Cannot move an object into its own subtree")
        # undo = move back to the current effective location
        child = self.builder.by_object[child_id]
        prior = child.loc
        if prior is None:
            for ref in child.inbound:
                if ref.action == "link":
                    prior = ref
                    break
        undo = ([Op("move", prior.obj, key=prior.key, value=child_id)]
                if prior is not None else None)
        self._make_op(Op("move", dest_id, key=dest_key, value=child_id),
                      undo)

    def move_list_index(self, list_id: str, from_index: int,
                        to_index: int) -> None:
        """Reorder one list element: `to_index` is its position AFTER the
        move (standard list.move semantics). One op — identity preserved,
        concurrent edits on the element still apply."""
        obj = self.builder.by_object.get(list_id)
        if obj is None or not obj.is_sequence:
            raise ValueError("List object does not exist")
        keys = obj.elem_ids.keys
        n = len(keys)
        if not 0 <= from_index < n:
            raise IndexError(f"move from index {from_index} out of range")
        if not 0 <= to_index < n:
            raise IndexError(f"move to index {to_index} out of range")
        if from_index == to_index:
            return
        eid = keys[from_index]
        rest = [k for i, k in enumerate(keys) if i != from_index]
        anchor = HEAD if to_index == 0 else rest[to_index - 1]
        elem = obj.max_elem + 1
        # undo = move back after its current visible predecessor; the
        # dest elem counter is allocated at UNDO time (api.undo) so a
        # stale stamp can never tie with later inserts
        back = HEAD if from_index == 0 else keys[from_index - 1]
        self._make_op(Op("move", list_id, key=anchor, value=eid, elem=elem),
                      [Op("move", list_id, key=back, value=eid)])

    def set_field(self, object_id: str, key: str, value, top_level: bool,
                  fresh: bool = False) -> None:
        """Assign a map field or list element (automerge.js:60-92).
        `fresh=True` marks a key this change block just created (a
        freshly inserted element): its field ops are () by construction,
        so the prior-state read — which would force the lazy preview to
        apply — is skipped."""
        if not isinstance(key, str):
            raise TypeError(f"The key of a map entry must be a string, "
                            f"but {key!r} is a {type(key).__name__}")
        if key == "":
            raise TypeError("The key of a map entry must not be an empty string")
        if key.startswith("_"):
            raise TypeError(f"Map entries starting with underscore are not allowed: {key}")

        field_ops = () if fresh else O.get_field_ops(self.builder,
                                                     object_id, key)
        undo = None
        if top_level:
            undo = [Op("del", object_id, key=key)] if not field_ops else list(field_ops)

        if is_object_value(value):
            existing_id = getattr(value, "_object_id", None)
            if isinstance(existing_id, str) and self._reaches(existing_id, object_id):
                raise ValueError(
                    f"Cannot create a reference cycle: {object_id} is reachable "
                    f"from {existing_id}")
            new_id = self.create_nested_objects(value)
            self._make_op(Op("link", object_id, key=key, value=new_id), undo)
        elif value is None or isinstance(value, (bool, int, float, str)):
            # Writing the value that's already there is a no-op
            # (automerge.js:85-88). Type-strict so 1, 1.0 and True stay distinct.
            if (len(field_ops) == 1 and field_ops[0].action == "set"
                    and field_ops[0].value == value
                    and type(field_ops[0].value) is type(value)):
                return
            self._make_op(Op("set", object_id, key=key, value=value), undo)
        else:
            raise TypeError(f"Unsupported type of value: {type(value).__name__}")

    def splice(self, object_id: str, start: int, deletions: int, insertions) -> None:
        """Delete/insert list elements at a position (automerge.js:94-115).
        Builder re-reads happen only when a LATER step needs the updated
        preview (multi-deletion runs, inserts after deletes) — the
        single-keystroke shapes (one del, or one insert) stay fully lazy."""
        obj = self.builder.by_object[object_id]
        anchor = None
        if deletions and insertions:
            # resolve the insertion anchor BEFORE deleting: the element
            # left of `start` survives the deletions, so its id is the
            # same anchor the post-delete index would yield
            anchor = HEAD if start == 0 else obj.elem_ids.key_of(start - 1)
        for i in range(deletions):
            if i:
                obj = self.builder.by_object[object_id]
            elem_id = obj.elem_ids.key_of(start)
            if elem_id is not None:
                field_ops = obj.fields.get(elem_id, ())
                self._make_op(Op("del", object_id, key=elem_id), list(field_ops))

        if not insertions:
            return
        if anchor is None:
            elem_ids = self.builder.by_object[object_id].elem_ids
            anchor = HEAD if start == 0 else elem_ids.key_of(start - 1)
        prev = anchor
        if prev is None:
            raise IndexError(f"Cannot insert at index {start}, "
                             f"which is past the end of the list")
        for item in insertions:
            prev = self.insert_after(object_id, prev)
            self.set_field(object_id, prev, item, top_level=True,
                           fresh=True)

    def set_list_index(self, list_id: str, index, value) -> None:
        """Assign a list index; one-past-the-end assignment inserts
        (automerge.js:117-125)."""
        index = parse_list_index(index)
        elem = self.builder.by_object[list_id].elem_ids.key_of(index)
        if elem is not None:
            self.set_field(list_id, elem, value, top_level=True)
        else:
            self.splice(list_id, index, 0, [value])

    def delete_field(self, object_id: str, key) -> None:
        """Delete a map key or list element (automerge.js:127-139)."""
        obj = self.builder.by_object[object_id]
        if obj.is_sequence:
            self.splice(object_id, parse_list_index(key), 1, [])
            return
        field_ops = O.get_field_ops(self.builder, object_id, key)
        if field_ops:
            self._make_op(Op("del", object_id, key=key), list(field_ops))
