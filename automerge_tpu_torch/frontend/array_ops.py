"""Reference-parity read helpers for sequence objects.

The reference delegates 16 read-only Array methods on list proxies
(Automerge's src/proxies.js:82-89), plain list snapshots (implicitly —
they ARE frozen JS arrays) and Text (Automerge's src/text.js:35-42).
Python's sequence protocol already covers most of them idiomatically
(iteration, `in`, slicing, `len`); this mixin adds the named forms so code
ported from the reference keeps working. All methods are read-only and
eager (they return plain Python values, never CRDT objects).
"""

from __future__ import annotations

from functools import reduce as _reduce


class ArrayReadOps:
    """Mixin over any iterable sequence with __len__/__getitem__."""

    __slots__ = ()

    def concat(self, *others):
        # JS Array.concat spreads arrays one level; everything else —
        # including Text, which is not an Array in the reference — appends
        # as a single element.
        out = list(self)
        for o in others:
            if isinstance(o, (list, tuple)) or (
                    isinstance(o, ArrayReadOps)
                    and getattr(o, "_type", None) == "list"):
                out.extend(o)
            else:
                out.append(o)
        return out

    def every(self, pred) -> bool:
        return all(pred(v) for v in self)

    def some(self, pred) -> bool:
        return any(pred(v) for v in self)

    def filter(self, pred) -> list:
        return [v for v in self if pred(v)]

    def find(self, pred, default=None):
        for v in self:
            if pred(v):
                return v
        return default

    def find_index(self, pred) -> int:
        for i, v in enumerate(self):
            if pred(v):
                return i
        return -1

    def for_each(self, fn) -> None:
        for v in self:
            fn(v)

    def includes(self, item) -> bool:
        return any(v == item for v in self)

    def index_of(self, item) -> int:
        for i, v in enumerate(self):
            if v == item:
                return i
        return -1

    def last_index_of(self, item) -> int:
        found = -1
        for i, v in enumerate(self):
            if v == item:
                found = i
        return found

    def join(self, sep: str = ",") -> str:
        return sep.join("" if v is None else str(v) for v in self)

    def map(self, fn) -> list:
        return [fn(v) for v in self]

    def reduce(self, fn, *initial):
        return _reduce(fn, list(self), *initial)

    def reduce_right(self, fn, *initial):
        return _reduce(fn, list(self)[::-1], *initial)

    def slice(self, start: int = 0, end: int | None = None) -> list:
        return list(self)[start:end]

    def to_string(self) -> str:
        return self.join(",")
