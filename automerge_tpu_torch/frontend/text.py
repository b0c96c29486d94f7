"""Text: a character-sequence CRDT view.

Mirrors Automerge's src/text.js: a Text object is an immutable snapshot
of a character sequence whose reads go straight to the element order index —
the snapshot is NOT materialized per change (text.js:3-32 reads the skip
list lazily; there is no per-char diff folding). Editing happens through the
list proxy inside a change block (insert_at / delete_at), exactly as the
reference routes Text edits through ListHandler.

A fresh `Text()` (empty) can be assigned into a document to create a text
object; assigning a non-empty Text is not supported (parity with
Automerge's src/automerge.js:43-45).
"""

from __future__ import annotations

from typing import Any, Iterator

from .array_ops import ArrayReadOps


class Text(ArrayReadOps):
    __slots__ = ("_values_cache", "_elem_ids_cache", "_object_id_attr",
                 "_elems", "_resolve")

    def __init__(self, values=(), elem_ids=(), object_id: str | None = None,
                 _elems=None, _resolve=None):
        """Either an eager snapshot (values/elem_ids sequences) or — when
        `_elems` is given — a lazy view over a persistent ElemList, with
        `_resolve` mapping raw stored values to application values (link
        materialization). Lazy views cost O(1) to create; a change touching
        a 100K-char text no longer rebuilds 100K entries."""
        if _elems is not None:
            object.__setattr__(self, "_values_cache", None)
            object.__setattr__(self, "_elem_ids_cache", None)
        else:
            object.__setattr__(self, "_values_cache", tuple(values))
            object.__setattr__(self, "_elem_ids_cache", tuple(elem_ids))
        object.__setattr__(self, "_object_id_attr", object_id)
        object.__setattr__(self, "_elems", _elems)
        object.__setattr__(self, "_resolve", _resolve)

    @property
    def _values(self) -> tuple:
        if self._values_cache is None:
            resolve = self._resolve
            vals = self._elems.values
            object.__setattr__(
                self, "_values_cache",
                tuple(map(resolve, vals)) if resolve else tuple(vals))
        return self._values_cache

    @property
    def _object_id(self) -> str | None:
        return self._object_id_attr

    @property
    def elem_ids(self) -> tuple[str, ...]:
        if self._elem_ids_cache is None:
            object.__setattr__(self, "_elem_ids_cache",
                               tuple(self._elems.keys))
        return self._elem_ids_cache

    def __len__(self) -> int:
        if self._values_cache is None:
            return len(self._elems)
        return len(self._values_cache)

    def get(self, index: int) -> Any:
        if self._values_cache is None:
            if 0 <= index < len(self._elems):
                v = self._elems.value_at(index)
                return self._resolve(v) if self._resolve else v
            return None
        if 0 <= index < len(self._values_cache):
            return self._values_cache[index]
        return None

    def __getitem__(self, index):
        if isinstance(index, slice):
            # lazy windowed read: a viewport slice of a 100K-char text must
            # not materialize all 100K entries
            if self._values_cache is None:
                resolve = self._resolve
                vals = (self._elems.value_at(i)
                        for i in range(*index.indices(len(self._elems))))
                return tuple(map(resolve, vals)) if resolve else tuple(vals)
            return self._values[index]
        # per-index reads (incl. negative) go through get()'s lazy path —
        # a caret read per keystroke must not materialize the whole text
        n = len(self)
        i = index + n if index < 0 else index
        if not 0 <= i < n:
            raise IndexError("Text index out of range")
        return self.get(i)

    def __iter__(self) -> Iterator[Any]:
        return iter(self._values)

    def __contains__(self, item) -> bool:
        return item in self._values

    def __str__(self) -> str:
        return "".join(str(v) for v in self._values)

    def __repr__(self) -> str:
        return f"Text({str(self)!r})"

    def __eq__(self, other):
        if isinstance(other, Text):
            return self._values == other._values
        if isinstance(other, str):
            return str(self) == other
        if isinstance(other, (list, tuple)):
            return list(self._values) == list(other)
        return NotImplemented

    def __hash__(self):
        return hash(("Text", self._values))

    def spans(self):
        """Run-length-encoded view of this text: (actor, start_elem,
        length, text) tuples, one per maximal run of consecutively-
        numbered same-origin characters in document order — the host form
        of the engine's span-table lane layout (engine/pack.SPAN_FIELDS).
        Reads go straight through the persistent element index (lazy view
        path) without materializing per-character tuples, so a merged
        100K-char document summarizes in O(spans)."""
        from ..core.textspans import rle_runs

        if self._elems is not None:
            keys = self._elems.keys
            vals = self._elems.values
        else:
            keys, vals = self.elem_ids, self._values
        resolve = self._resolve
        out = []
        for (actor, start, length, at) in rle_runs(keys):
            chunk = vals[at:at + length]
            if resolve:
                chunk = [resolve(v) for v in chunk]
            out.append((actor, start, length,
                        "".join(str(v) for v in chunk)))
        return out

    def join(self, sep: str = "") -> str:
        return sep.join(str(v) for v in self._values)

    def index_of(self, item) -> int:
        try:
            return self._values.index(item)
        except ValueError:
            return -1

    def __setattr__(self, name, value):
        raise TypeError("Text objects are read-only. "
                        "Use change() to get a writable version.")
