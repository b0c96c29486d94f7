"""Lightweight persistent containers for the semantic core.

The reference keeps every piece of CRDT state in Immutable.js structures so that
old document snapshots stay valid after new changes are applied
(Automerge's src/op_set.js:272-285). We get the same persistence guarantee
with two cheaper devices tuned for the actual mutation patterns:

- `AList`: an append-only shared-backing list view. Appending to the newest view
  is O(1) amortized (it extends the shared backing list in place); appending to
  an older view copies the prefix. Change histories, per-actor state lists and
  undo/redo stacks are append-mostly, so forks are rare and cheap.
- copy-on-write dicts, managed by the OpSet builder (one shallow copy per
  *batch* of changes rather than per op).
"""

from __future__ import annotations

from itertools import islice
from typing import Any, Iterator


class AList:
    """Persistent append-only list: views share one backing list.

    A view is (backing, length). `append` mutates the backing in place when the
    view is the newest one (length == len(backing)); otherwise it copies the
    visible prefix. Old views never observe appends made through newer views.
    """

    __slots__ = ("_backing", "_length")

    def __init__(self, backing: list | None = None, length: int | None = None):
        self._backing = backing if backing is not None else []
        self._length = length if length is not None else len(self._backing)

    def append(self, item: Any) -> "AList":
        if self._length == len(self._backing):
            self._backing.append(item)
            return AList(self._backing, self._length + 1)
        backing = self._backing[: self._length]
        backing.append(item)
        return AList(backing, self._length + 1)

    def extend(self, items) -> "AList":
        out = self
        for item in items:
            out = out.append(item)
        return out

    def __len__(self) -> int:
        return self._length

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return list(islice(self._backing, *idx.indices(self._length)))
        if idx < 0:
            idx += self._length
        if not 0 <= idx < self._length:
            raise IndexError(idx)
        return self._backing[idx]

    def __iter__(self) -> Iterator[Any]:
        return islice(iter(self._backing), self._length)

    def __repr__(self) -> str:
        return f"AList({list(self)!r})"


EMPTY_ALIST = AList([], 0)


# ---------------------------------------------------------------------------
# PMap: a persistent hash map (hash array mapped trie)

_SHIFT = 5
_MASK = 31

# node kinds (first tuple element)
_LEAF = 0       # (_LEAF, hash, key, value)
_COLL = 1       # (_COLL, hash, ((k, v), ...))
_BITMAP = 2     # (_BITMAP, bitmap, (child, ...))

_BM_ABSENT = object()   # _bm_set's "key was not present" old-value marker


def _bm_set(node, shift, h, key, value):
    """Returns (new_node, added, old_value) — `old_value` is _BM_ABSENT
    when the key was not present, so writers that need the displaced
    value (CowDict.__setitem__'s existed-in-base check) get it from the
    SAME walk instead of paying a second full lookup (the r16 keystroke
    profile's worst single overhead: every shared-mode write walked the
    overlay twice)."""
    if node is None:
        return (_LEAF, h, key, value), 1, _BM_ABSENT
    kind = node[0]
    if kind == _LEAF:
        nh, nk = node[1], node[2]
        if nh == h and nk == key:
            return (_LEAF, h, key, value), 0, node[3]
        if nh == h:
            return (_COLL, h, ((nk, node[3]), (key, value))), 1, _BM_ABSENT
        merged, _, _ = _bm_set(None, shift, nh, nk, node[3])
        wrapped = (_BITMAP, 1 << ((nh >> shift) & _MASK), (merged,))
        return _bm_set(wrapped, shift, h, key, value)
    if kind == _COLL:
        if node[1] == h:
            entries = node[2]
            for i, (k, _v) in enumerate(entries):
                if k == key:
                    return (_COLL, h, entries[:i] + ((key, value),)
                            + entries[i + 1:]), 0, entries[i][1]
            return (_COLL, h, entries + ((key, value),)), 1, _BM_ABSENT
        wrapped = (_BITMAP, 1 << ((node[1] >> shift) & _MASK), (node,))
        return _bm_set(wrapped, shift, h, key, value)
    bitmap, children = node[1], node[2]
    bit = 1 << ((h >> shift) & _MASK)
    idx = bin(bitmap & (bit - 1)).count("1")
    if bitmap & bit:
        child, added, old = _bm_set(children[idx], shift + _SHIFT, h, key,
                                    value)
        return (_BITMAP, bitmap,
                children[:idx] + (child,) + children[idx + 1:]), added, old
    leaf = (_LEAF, h, key, value)
    return (_BITMAP, bitmap | bit,
            children[:idx] + (leaf,) + children[idx:]), 1, _BM_ABSENT


def _bm_get(node, shift, h, key, default):
    while node is not None:
        kind = node[0]
        if kind == _LEAF:
            if node[1] == h and node[2] == key:
                return node[3]
            return default
        if kind == _COLL:
            if node[1] == h:
                for k, v in node[2]:
                    if k == key:
                        return v
            return default
        bit = 1 << ((h >> shift) & _MASK)
        if not node[1] & bit:
            return default
        idx = bin(node[1] & (bit - 1)).count("1")
        node = node[2][idx]
        shift += _SHIFT
    return default


def _bm_delete(node, shift, h, key):
    """Returns (new_node | None, removed: bool)."""
    if node is None:
        return None, False
    kind = node[0]
    if kind == _LEAF:
        if node[1] == h and node[2] == key:
            return None, True
        return node, False
    if kind == _COLL:
        if node[1] != h:
            return node, False
        entries = tuple(e for e in node[2] if e[0] != key)
        if len(entries) == len(node[2]):
            return node, False
        if len(entries) == 1:
            return (_LEAF, h, entries[0][0], entries[0][1]), True
        return (_COLL, h, entries), True
    bitmap, children = node[1], node[2]
    bit = 1 << ((h >> shift) & _MASK)
    if not bitmap & bit:
        return node, False
    idx = bin(bitmap & (bit - 1)).count("1")
    child, removed = _bm_delete(children[idx], shift + _SHIFT, h, key)
    if not removed:
        return node, False
    if child is None:
        rest = children[:idx] + children[idx + 1:]
        if not rest:
            return None, True
        if len(rest) == 1 and rest[0][0] != _BITMAP:
            return rest[0], True
        return (_BITMAP, bitmap & ~bit, rest), True
    return (_BITMAP, bitmap, children[:idx] + (child,) + children[idx + 1:]), \
        True


class PMap:
    """Persistent string-keyed hash map (HAMT, 32-way). `set`/`delete`
    return new maps sharing structure with the old — the device the
    reference gets from Immutable.js Map (used for the skip list's
    key->node index, src/skip_list.js). O(log32 n) per operation."""

    __slots__ = ("_root", "_size")

    def __init__(self, root=None, size=0):
        self._root = root
        self._size = size

    def get(self, key, default=None):
        return _bm_get(self._root, 0, hash(key) & 0xFFFFFFFF, key, default)

    def set(self, key, value) -> "PMap":
        root, added, _old = _bm_set(self._root, 0, hash(key) & 0xFFFFFFFF,
                                    key, value)
        return PMap(root, self._size + added)

    def set_lookup(self, key, value):
        """(new map, displaced value or the _BM_ABSENT marker) from ONE
        walk — the write-path twin of get() for callers that need the
        old value anyway (CowDict.__setitem__)."""
        root, added, old = _bm_set(self._root, 0, hash(key) & 0xFFFFFFFF,
                                   key, value)
        return PMap(root, self._size + added), old

    def delete(self, key) -> "PMap":
        root, removed = _bm_delete(self._root, 0, hash(key) & 0xFFFFFFFF, key)
        return PMap(root, self._size - removed) if removed else self

    def __len__(self) -> int:
        return self._size

    def __contains__(self, key) -> bool:
        sentinel = object()
        return self.get(key, sentinel) is not sentinel

    def items(self):
        def walk(node):
            if node is None:
                return
            kind = node[0]
            if kind == _LEAF:
                yield node[2], node[3]
            elif kind == _COLL:
                yield from node[2]
            else:
                for child in node[2]:
                    yield from walk(child)
        yield from walk(self._root)

    def __iter__(self):
        for k, _v in self.items():
            yield k


EMPTY_PMAP = PMap()


# ---------------------------------------------------------------------------
# CowDict: dict with O(1) copy-on-write snapshots

_DELETED = object()
_ABSENT = object()


class CowDict:
    """Dict-like map whose `copy()` is O(1): a shared plain-dict base plus a
    persistent PMap overlay. Fresh (never-copied) instances write straight
    into the base at dict speed; once copied, writers go to their own
    overlay (structure-shared, so siblings and ancestors are unaffected),
    and a large overlay is folded into a fresh base — amortized O(1).

    This is the role Immutable.js Map plays for the reference's per-object
    CRDT state (src/op_set.js:272-285): big sequence objects stop paying
    O(n) per change-batch snapshot. Iteration order: base insertion order,
    then overlay additions in hash order (callers that need sequence order
    use the element index, not this map).
    """

    __slots__ = ("_base", "_over", "_size", "_shared")

    def __init__(self, base: dict | None = None):
        self._base = {} if base is None else base
        self._over = EMPTY_PMAP
        self._size = len(self._base)
        self._shared = False

    def copy(self) -> "CowDict":
        self._shared = True
        out = CowDict.__new__(CowDict)
        out._base = self._base
        out._over = self._over
        out._size = self._size
        out._shared = True
        return out

    def _maybe_rebase(self) -> None:
        if len(self._over) <= max(512, len(self._base) // 4):
            return
        self.rebase()

    def rebase(self) -> None:
        """Fold the overlay into a PRIVATE base fork now (O(n)) so
        subsequent writes run at plain-dict speed. Sharing-safe: the old
        base is forked, never mutated, so sibling snapshots are
        unaffected. No-op when already owned. Callers with a large write
        burst pending (the span-merge plane, core/textspans.py) invoke
        this up front: one base fork beats thousands of persistent-overlay
        updates."""
        if not self._shared and not len(self._over):
            return
        base = dict(self._base)
        for k, v in self._over.items():
            if v is _DELETED:
                base.pop(k, None)
            else:
                base[k] = v
        self._base = base
        self._over = EMPTY_PMAP
        self._shared = False   # fresh base: in-place writes are safe again

    # -- reads -------------------------------------------------------------

    def get(self, key, default=None):
        over = self._over
        if over._size:
            # inlined PMap.get (this is the engine's hottest read: ~20
            # calls per keystroke through the apply path)
            v = _bm_get(over._root, 0, hash(key) & 0xFFFFFFFF, key,
                        _ABSENT)
            if v is not _ABSENT:
                return default if v is _DELETED else v
        v = self._base.get(key, _ABSENT)
        return default if v is _ABSENT else v

    def __getitem__(self, key):
        v = self.get(key, _DELETED)
        if v is _DELETED:
            raise KeyError(key)
        return v

    def __contains__(self, key) -> bool:
        return self.get(key, _DELETED) is not _DELETED

    def __len__(self) -> int:
        return self._size

    def __bool__(self) -> bool:
        return self._size > 0

    def items(self):
        over = self._over
        if not len(over):
            yield from self._base.items()
            return
        od = dict(over.items())
        for k, v in self._base.items():
            if k in od:
                w = od.pop(k)
                if w is not _DELETED:
                    yield k, w
            else:
                yield k, v
        for k, w in od.items():
            if w is not _DELETED:
                yield k, w

    def keys(self):
        for k, _v in self.items():
            yield k

    def values(self):
        for _k, v in self.items():
            yield v

    def __iter__(self):
        return self.keys()

    # -- writes ------------------------------------------------------------

    def __setitem__(self, key, value) -> None:
        if self._shared:
            # one overlay walk, not two: set_lookup returns the value it
            # displaced, and only a key absent from the overlay needs the
            # (plain-dict-cheap) base membership probe
            self._over, old = self._over.set_lookup(key, value)
            if old is _BM_ABSENT:
                existed = key in self._base
            else:
                existed = old is not _DELETED
            if not existed:
                self._size += 1
            self._maybe_rebase()
        else:
            if key not in self._base:
                self._size += 1
            self._base[key] = value

    def pop(self, key, *default):
        v = self.get(key, _DELETED)
        if v is _DELETED:
            if default:
                return default[0]
            raise KeyError(key)
        if self._shared:
            if key in self._base:
                self._over = self._over.set(key, _DELETED)
            else:
                self._over = self._over.delete(key)
            self._size -= 1
            self._maybe_rebase()
        else:
            del self._base[key]
            self._size -= 1
        return v

    def __delitem__(self, key) -> None:
        self.pop(key)

    def __eq__(self, other):
        if isinstance(other, CowDict):
            return dict(self.items()) == dict(other.items())
        if isinstance(other, dict):
            return dict(self.items()) == other
        return NotImplemented

    def __repr__(self) -> str:
        return f"CowDict({dict(self.items())!r})"
