"""Second materialization frontend: immutable mapping/tuple views.

The reference ships two interchangeable frontends over the same CRDT core:
frozen plain objects (freeze_api.js) and Immutable.js Map/List structures
(immutable_api.js), selected per document at init time. This is the Python
analog of the second one: documents materialize as `types.MappingProxyType`
views over dicts, and lists as tuples — structures that are immutable by
construction rather than by blocked mutators, and hashable/iterable in the
way functional-style Python code expects.

Contract parity with the reference (immutable_api.js:137-170): created via
`init_immutable()` / `load_immutable()`; all api.py functions (change, merge,
apply_changes, save, undo/redo, ...) work identically on either frontend, and
`save()` output is frontend-independent (tested via save equality, the same
check as Automerge's test/immutable_test.js:31-34).
"""

from __future__ import annotations

from types import MappingProxyType
from typing import Any

from ..core import opset as O
from ..core.ids import ROOT_ID
from ..core.opset import Link, OpSet
from .snapshots import DocState
from .text import Text


class ImmutableRoot:
    """Root handle of an immutable-view document.

    Behaves like a read-only mapping (get/[]/in/len/iteration) and carries the
    same metadata the frozen frontend exposes (_object_id, _conflicts, _doc),
    so every api.py entry point works on it unchanged.
    """

    __slots__ = ("_view", "_conflicts_attr", "_doc")

    def __init__(self, view: MappingProxyType, conflicts: MappingProxyType,
                 doc_state: DocState):
        object.__setattr__(self, "_view", view)
        object.__setattr__(self, "_conflicts_attr", conflicts)
        object.__setattr__(self, "_doc", doc_state)

    @property
    def _object_id(self) -> str:
        return ROOT_ID

    @property
    def _objectId(self) -> str:
        return ROOT_ID

    @property
    def _conflicts(self):
        return self._conflicts_attr

    @property
    def _actor_id(self) -> str:
        return self._doc.actor_id

    def __getitem__(self, key: str) -> Any:
        return self._view[key]

    def get(self, key: str, default=None) -> Any:
        return self._view.get(key, default)

    def __contains__(self, key) -> bool:
        return key in self._view

    def __iter__(self):
        return iter(self._view)

    def keys(self):
        return self._view.keys()

    def values(self):
        return self._view.values()

    def items(self):
        return self._view.items()

    def __len__(self) -> int:
        return len(self._view)

    def __eq__(self, other):
        if isinstance(other, ImmutableRoot):
            return dict(self._view) == dict(other._view)
        if isinstance(other, dict):
            return dict(self._view) == other
        return NotImplemented

    def __repr__(self):
        return f"ImmutableRoot({dict(self._view)!r})"

    def __setattr__(self, name, value):
        raise TypeError("immutable document roots are read-only; "
                        "use change() to get a writable version")


def _freeze_value(value: Any) -> Any:
    if isinstance(value, dict):
        return MappingProxyType({k: _freeze_value(v) for k, v in value.items()})
    if isinstance(value, (list, tuple)):
        return tuple(_freeze_value(v) for v in value)
    return value


def _build(state: OpSet, object_id: str, cache: dict) -> Any:
    if object_id != ROOT_ID and object_id in cache:
        return cache[object_id]
    obj = state.by_object[object_id]

    if obj.init_action == "makeText":
        values, elem_ids = [], []
        for i, key in enumerate(obj.elem_ids.keys):
            value = obj.elem_ids.values[i]
            if isinstance(value, Link):
                value = _build(state, value.obj, cache)
            values.append(value)
            elem_ids.append(key)
        snapshot: Any = Text(values, elem_ids, object_id)
    elif obj.init_action == "makeList":
        values = []
        for key in obj.elem_ids.keys:
            ops = obj.fields.get(key, ())
            op = ops[0]
            values.append(_build(state, op.value, cache)
                          if op.action == "link" else op.value)
        snapshot = tuple(values)
    else:
        data = {}
        for key, ops in obj.fields.items():
            if not O.valid_field_name(key) or not ops:
                continue
            op = ops[0]
            data[key] = (_build(state, op.value, cache)
                         if op.action == "link" else op.value)
        snapshot = MappingProxyType(data)

    if object_id != ROOT_ID:
        cache[object_id] = snapshot
    return snapshot


def _root_conflicts(state: OpSet, cache: dict) -> MappingProxyType:
    obj = state.by_object[ROOT_ID]
    out = {}
    for key, ops in obj.fields.items():
        if not O.valid_field_name(key) or len(ops) <= 1:
            continue
        out[key] = MappingProxyType({
            op.actor: (_build(state, op.value, cache)
                       if op.action == "link" else op.value)
            for op in ops[1:]})
    return MappingProxyType(out)


def materialize_immutable_root(actor_id: str, opset: OpSet) -> ImmutableRoot:
    cache: dict = {}
    view = _build(opset, ROOT_ID, cache)
    conflicts = _root_conflicts(opset, cache)
    doc_state = DocState(actor_id, opset, cache, frontend="immutable")
    return ImmutableRoot(view, conflicts, doc_state)
