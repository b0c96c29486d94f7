"""Mutable-looking proxies served inside change blocks.

The Python analog of Automerge's src/proxies.js: a MapProxy turns item and
attribute assignment into context ops; a ListProxy serves both lists and Text
with Python list methods plus the reference's insert_at / delete_at / splice.
Reads always reflect the context's working state, so values written earlier in
the same change block are immediately visible.
"""

from __future__ import annotations

from typing import Any, Iterator

from ..core import opset as O
from ..core.ids import ROOT_ID
from .array_ops import ArrayReadOps
from .context import ChangeContext, parse_list_index


def _proxy_for(ctx: ChangeContext, object_id: str):
    obj = ctx.builder.by_object[object_id]
    if obj.is_sequence:
        return ListProxy(ctx, object_id)
    return MapProxy(ctx, object_id)


def _read_value(ctx: ChangeContext, op) -> Any:
    if op.action == "link":
        return _proxy_for(ctx, op.value)
    return op.value


class MapProxy:
    __slots__ = ("_ctx", "_oid")

    def __init__(self, ctx: ChangeContext, object_id: str):
        object.__setattr__(self, "_ctx", ctx)
        object.__setattr__(self, "_oid", object_id)

    # -- metadata -----------------------------------------------------------

    @property
    def _object_id(self) -> str:
        return self._oid

    @property
    def _objectId(self) -> str:
        return self._oid

    @property
    def _type(self) -> str:
        return "map"

    @property
    def _actor_id(self) -> str:
        return self._ctx.actor_id

    @property
    def _conflicts(self) -> dict:
        ctx, oid = self._ctx, self._oid
        obj = ctx.builder.by_object[oid]
        out = {}
        for key, ops in obj.fields.items():
            if O.valid_field_name(key) and len(ops) > 1:
                out[key] = {op.actor: _read_value(ctx, op) for op in ops[1:]}
        return out

    def _get(self, object_id: str):
        """Proxy for any object in the document by its ID (the reference's
        doc._get, proxies.js:233)."""
        return _proxy_for(self._ctx, object_id)

    # -- reads --------------------------------------------------------------

    def __getitem__(self, key: str) -> Any:
        ops = O.get_field_ops(self._ctx.builder, self._oid, key)
        if not O.valid_field_name(key) or not ops:
            raise KeyError(key)
        return _read_value(self._ctx, ops[0])

    def get(self, key: str, default=None) -> Any:
        try:
            return self[key]
        except KeyError:
            return default

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def keys(self):
        return list(O.get_object_fields(self._ctx.builder, self._oid))

    def values(self):
        return [self[k] for k in self.keys()]

    def items(self):
        return [(k, self[k]) for k in self.keys()]

    def __iter__(self) -> Iterator[str]:
        return iter(self.keys())

    def __contains__(self, key) -> bool:
        return O.valid_field_name(key) and \
            bool(O.get_field_ops(self._ctx.builder, self._oid, key))

    def __len__(self) -> int:
        return len(self.keys())

    def to_plain(self) -> dict:
        """Plain-Python deep copy of the current state (the reference's
        `_inspect`, proxies.js:98)."""
        out = {}
        for key in self.keys():
            value = self[key]
            out[key] = value.to_plain() if hasattr(value, "to_plain") else value
        return out

    def __eq__(self, other):
        if isinstance(other, (dict, MapProxy)):
            other_plain = other.to_plain() if isinstance(other, MapProxy) else other
            return self.to_plain() == other_plain
        return NotImplemented

    def __repr__(self):
        return f"MapProxy({self.to_plain()!r})"

    # -- writes -------------------------------------------------------------

    def __setitem__(self, key: str, value) -> None:
        self._ctx.set_field(self._oid, key, value, top_level=True)

    def __setattr__(self, name: str, value) -> None:
        self._ctx.set_field(self._oid, name, value, top_level=True)

    def __delitem__(self, key: str) -> None:
        self._ctx.delete_field(self._oid, key)

    def __delattr__(self, name: str) -> None:
        self._ctx.delete_field(self._oid, name)

    def update(self, values: dict) -> None:
        for key, value in values.items():
            self[key] = value

    def move(self, key: str, dest: "MapProxy", dest_key: str | None = None
             ) -> None:
        """Reparent the child object at `key` under `dest` as ONE move op
        (the r16 move plane): `board.move("card3", done_column)` instead
        of a delete + re-insert of the whole subtree."""
        ops = O.get_field_ops(self._ctx.builder, self._oid, key)
        if not ops or ops[0].action not in ("link", "move"):
            raise TypeError(f"{key!r} does not hold a child object")
        if not isinstance(dest, MapProxy):
            raise TypeError("move destination must be a map proxy")
        self._ctx.move_key(dest._oid, dest_key if dest_key is not None
                           else key, ops[0].value)


class ListProxy(ArrayReadOps):
    __slots__ = ("_ctx", "_oid")

    def __init__(self, ctx: ChangeContext, object_id: str):
        object.__setattr__(self, "_ctx", ctx)
        object.__setattr__(self, "_oid", object_id)

    # -- metadata -----------------------------------------------------------

    @property
    def _object_id(self) -> str:
        return self._oid

    @property
    def _objectId(self) -> str:
        return self._oid

    @property
    def _type(self) -> str:
        obj = self._ctx.builder.by_object[self._oid]
        return "text" if obj.init_action == "makeText" else "list"

    @property
    def _actor_id(self) -> str:
        return self._ctx.actor_id

    # -- reads --------------------------------------------------------------

    def _elem_ids(self):
        return self._ctx.builder.by_object[self._oid].elem_ids

    def __len__(self) -> int:
        return len(self._elem_ids())

    def _value_at(self, index: int) -> Any:
        elem = self._elem_ids().key_of(index)
        if elem is None:
            raise IndexError(index)
        ops = O.get_field_ops(self._ctx.builder, self._oid, elem)
        return _read_value(self._ctx, ops[0])

    def __getitem__(self, index):
        if isinstance(index, slice):
            return [self._value_at(i) for i in range(*index.indices(len(self)))]
        if index < 0:
            index += len(self)
        return self._value_at(index)

    def get(self, index: int, default=None) -> Any:
        try:
            return self[index]
        except IndexError:
            return default

    def __iter__(self) -> Iterator[Any]:
        for i in range(len(self)):
            yield self._value_at(i)

    def __contains__(self, item) -> bool:
        return any(v == item for v in self)

    def index(self, item) -> int:
        for i, v in enumerate(self):
            if v == item:
                return i
        raise ValueError(f"{item!r} is not in list")

    def count(self, item) -> int:
        return sum(1 for v in self if v == item)

    def to_plain(self) -> list:
        out = []
        for value in self:
            out.append(value.to_plain() if hasattr(value, "to_plain") else value)
        return out

    def __eq__(self, other):
        if isinstance(other, (list, tuple, ListProxy)):
            other_plain = other.to_plain() if isinstance(other, ListProxy) else list(other)
            return self.to_plain() == other_plain
        return NotImplemented

    def __repr__(self):
        return f"ListProxy({self.to_plain()!r})"

    # -- writes (proxies.js:9-92) -------------------------------------------

    def __setitem__(self, index, value) -> None:
        if isinstance(index, int) and not isinstance(index, bool) and index < 0:
            index += len(self)
        self._ctx.set_list_index(self._oid, index, value)

    def __delitem__(self, index) -> None:
        if index < 0:
            index += len(self)
        self._ctx.splice(self._oid, parse_list_index(index), 1, [])

    def append(self, *values) -> None:
        self._ctx.splice(self._oid, len(self), 0, values)

    def extend(self, values) -> None:
        self._ctx.splice(self._oid, len(self), 0, list(values))

    def insert(self, index: int, *values) -> None:
        # Python list.insert semantics: negatives count from the end, both
        # directions clamp into range.
        if isinstance(index, int) and not isinstance(index, bool) and index < 0:
            index = max(index + len(self), 0)
        index = min(parse_list_index(index), len(self))
        self._ctx.splice(self._oid, index, 0, values)

    def insert_at(self, index: int, *values) -> "ListProxy":
        self._ctx.splice(self._oid, parse_list_index(index), 0, values)
        return self

    def delete_at(self, index: int, num_delete: int = 1) -> "ListProxy":
        self._ctx.splice(self._oid, parse_list_index(index), num_delete, [])
        return self

    def pop(self, index: int = -1) -> Any:
        length = len(self)
        if length == 0:
            raise IndexError("pop from empty list")
        if index < 0:
            index += length
        value = self._value_at(index)
        value = value.to_plain() if hasattr(value, "to_plain") else value
        self._ctx.splice(self._oid, index, 1, [])
        return value

    def move(self, from_index: int, to_index: int) -> "ListProxy":
        """Reorder one element as ONE move op (`to_index` is its position
        after the move — standard list.move semantics). Identity is
        preserved: concurrent edits on the element still apply."""
        self._ctx.move_list_index(self._oid, parse_list_index(from_index),
                                  parse_list_index(to_index))
        return self

    def shift(self) -> Any:
        if len(self) == 0:
            return None
        return self.pop(0)

    def unshift(self, *values) -> int:
        self._ctx.splice(self._oid, 0, 0, values)
        return len(self)

    def push(self, *values) -> int:
        self._ctx.splice(self._oid, len(self), 0, values)
        return len(self)

    def splice(self, start: int, delete_count: int | None = None, *values) -> list:
        start = parse_list_index(start)
        if delete_count is None:
            delete_count = len(self) - start
        deleted = []
        for n in range(delete_count):
            deleted.append(self.get(start + n))
        self._ctx.splice(self._oid, start, delete_count, list(values))
        return deleted

    def remove(self, item) -> None:
        del self[self.index(item)]

    def fill(self, value, start: int = 0, end: int | None = None) -> "ListProxy":
        length = len(self)
        end = length if end is None else min(end, length)
        for i in range(start, end):
            elem = self._elem_ids().key_of(i)
            self._ctx.set_field(self._oid, elem, value, top_level=True)
        return self


def root_proxy(ctx: ChangeContext) -> MapProxy:
    return MapProxy(ctx, ROOT_ID)
