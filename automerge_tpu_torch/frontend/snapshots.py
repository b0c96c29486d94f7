"""Frozen document snapshots.

The reference materializes documents as Object.freeze'd plain JS objects and
arrays with non-enumerable `_objectId` / `_conflicts` properties
(Automerge's src/freeze_api.js). The Python analog: dict/list subclasses
whose mutating methods raise, carrying the same metadata as attributes. They
compare equal to plain dicts/lists, so assertions and user code stay natural.

The root snapshot additionally carries `_doc`, the internal DocState
(actor id, OpSet, materialization cache) — the analog of the reference's
hidden `_state` property (freeze_api.js:232-237).
"""

from __future__ import annotations

from typing import Any

from .array_ops import ArrayReadOps

_READONLY_MSG = ("this document snapshot is read-only. "
                 "Use change() to get a writable version.")


class DocState:
    """Internal per-document state hanging off the root snapshot.

    `frontend` selects the materialization style — "frozen" (blocked-mutator
    dict/list snapshots) or "immutable" (mapping-proxy/tuple views) — the
    analog of the reference's FreezeAPI/ImmutableAPI dispatch
    (auto_api.js:34-38)."""

    __slots__ = ("actor_id", "opset", "cache", "frontend")

    def __init__(self, actor_id: str, opset, cache: dict,
                 frontend: str = "frozen"):
        self.actor_id = actor_id
        self.opset = opset
        self.cache = cache  # objectId -> materialized snapshot
        self.frontend = frontend


def _blocked(name: str):
    def method(self, *args, **kwargs):
        raise TypeError(f"You tried to {name}, but {_READONLY_MSG}")
    return method


class FrozenMap(dict):
    """Immutable map snapshot; == plain dicts with the same contents."""

    _object_id: str
    _conflicts_attr: dict

    def __init__(self, data=(), object_id: str | None = None, conflicts=None):
        super().__init__(data)
        object.__setattr__(self, "_object_id", object_id)
        object.__setattr__(self, "_conflicts_attr", conflicts if conflicts is not None else {})

    @property
    def _objectId(self) -> str:  # camelCase alias for reference parity
        return self._object_id

    @property
    def _conflicts(self) -> dict:
        return self._conflicts_attr

    @property
    def _type(self) -> str:
        return "map"

    def __getattr__(self, name: str) -> Any:
        # Convenience: doc.foo mirrors doc['foo'] (the reference doc is a JS
        # object, where the two are the same thing).
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        raise TypeError(f"You tried to set attribute {name!r}, but {_READONLY_MSG}")

    __setitem__ = _blocked("set a key")
    __delitem__ = _blocked("delete a key")
    clear = _blocked("clear the map")
    pop = _blocked("pop a key")
    popitem = _blocked("pop an item")
    setdefault = _blocked("set a default")
    update = _blocked("update the map")

    def __reduce__(self):
        return (dict, (dict(self),))


class FrozenList(list, ArrayReadOps):
    """Immutable list snapshot; == plain lists with the same contents.

    `_conflicts` is a list aligned with the elements: each entry is None or a
    {actor: value} dict of conflict losers (freeze_api.js:76-111).
    """

    def __init__(self, data=(), object_id: str | None = None, conflicts=None):
        super().__init__(data)
        object.__setattr__(self, "_object_id", object_id)
        object.__setattr__(self, "_conflicts_attr",
                           conflicts if conflicts is not None else [])

    @property
    def _objectId(self) -> str:
        return self._object_id

    @property
    def _conflicts(self) -> list:
        return self._conflicts_attr

    @property
    def _type(self) -> str:
        return "list"

    def __setattr__(self, name, value):
        raise TypeError(f"You tried to set attribute {name!r}, but {_READONLY_MSG}")

    __setitem__ = _blocked("set a list element")
    __delitem__ = _blocked("delete a list element")
    __iadd__ = _blocked("extend the list in place")
    __imul__ = _blocked("multiply the list in place")
    append = _blocked("append to the list")
    extend = _blocked("extend the list")
    insert = _blocked("insert into the list")
    remove = _blocked("remove from the list")
    pop = _blocked("pop from the list")
    clear = _blocked("clear the list")
    sort = _blocked("sort the list")
    reverse = _blocked("reverse the list")

    def __reduce__(self):
        return (list, (list(self),))


class RootMap(FrozenMap):
    """The document root: a FrozenMap that also carries the DocState."""

    def __init__(self, data=(), object_id=None, conflicts=None, doc_state: DocState | None = None):
        super().__init__(data, object_id, conflicts)
        object.__setattr__(self, "_doc", doc_state)

    @property
    def _actor_id(self) -> str:
        return self._doc.actor_id

    @property
    def _actorId(self) -> str:
        return self._doc.actor_id
