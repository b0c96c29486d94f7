"""Public API surface.

The analog of Automerge's src/automerge.js:351-360 + src/auto_api.js:
init, change, empty_change, merge, diff, assign, load, save, equals, inspect,
get_history, get_conflicts, get_changes, get_changes_for_actor, apply_changes,
get_missing_changes, get_missing_deps, can_undo, undo, can_redo, redo.

Documents are frozen snapshots; all functions here are pure (they return new
documents and never mutate their arguments).

This is the port's copy of `automerge_tpu/api.py`. A document lives on a
device (`init`, `init_immutable`, `load`, `load_immutable` take `device=`,
default the card; "cpu" runs without one): its OpSet resolves move realms
there (core/moves.py). `merge`, `apply_changes`, `change` and the rest keep
the local document's device. `save_transit` / `load_transit` read and
write Automerge's own save format (`interop/transit.py`); `load_transit`
takes `device=` like `load`.
"""

from __future__ import annotations

import json
from typing import Any, Callable

from .core import clock as C
from .core.change import Change, Op, coerce_change
from .core.ids import ROOT_ID
from .core.opset import OpSet
from .core import opset as O
from .frontend.context import ChangeContext
from .frontend.materialize import apply_changes_to_doc, materialize_root
from .frontend.proxies import ListProxy, MapProxy, root_proxy
from .frontend.snapshots import DocState, FrozenList, FrozenMap, RootMap
from .frontend.text import Text
from .utils import tracer
from .utils.uuid import make_uuid

SAVE_FORMAT_VERSION = 1


def _check_target(func_name: str, target) -> None:
    """Validate that `target` is a document root (auto_api.js:15-26)."""
    doc_state = getattr(target, "_doc", None)
    if doc_state is None or getattr(target, "_object_id", None) != ROOT_ID:
        raise TypeError(f"The first argument to {func_name} must be the "
                        f"document root, but you passed {target!r}")


def init(actor_id: str | None = None, device="cuda") -> RootMap:
    """Create an empty document on `device` (automerge.js:143-145)."""
    return materialize_root(actor_id or make_uuid(), OpSet.init(device))


def init_immutable(actor_id: str | None = None, device="cuda"):
    """Create an empty document with the immutable-view frontend
    (automerge.js:147-149)."""
    from .frontend.immutable_view import materialize_immutable_root
    return materialize_immutable_root(actor_id or make_uuid(),
                                      OpSet.init(device))


def load_immutable(data: str, actor_id: str | None = None, device="cuda"):
    """Load a saved change log into an immutable-view document
    (automerge.js:216-221)."""
    doc = init_immutable(actor_id, device)
    payload = json.loads(data)
    changes = payload.get("changes", payload) if isinstance(payload, dict) else payload
    return apply_changes_to_doc(doc, doc._doc.opset,
                                [coerce_change(c) for c in changes],
                                incremental=False, emit_diffs=False)


# ---------------------------------------------------------------------------
# Change assembly (auto_api.js:28-111)

def _apply_new_change(doc, opset: OpSet, ops, message: str | None) -> RootMap:
    """Stamp actor/seq/deps on a fresh change and apply it
    (auto_api.js:28-39). The trace plane's lifecycle starts here: a
    deterministically sampled (actor, seq) gets a trace context whose
    finalize span covers change construction + the local apply
    (utils/tracer.py; one check when AMTPU_TRACE_SAMPLE is unset)."""
    actor = doc._doc.actor_id
    seq = opset.clock.get(actor, 0) + 1
    tr = tracer.finalize_begin(actor, seq)
    deps = {a: s for a, s in opset.deps.items() if a != actor}
    change = Change(actor, seq, deps, ops, message)
    out = apply_changes_to_doc(doc, opset, [change], incremental=True)
    if tr is not None:
        tracer.finalize_end(tr)
    return out


def _make_change(doc, ctx_local, ctx_undo_local, message: str | None) -> RootMap:
    """Dedup local assignments, push the undo stack, commit
    (auto_api.js:41-68)."""
    local = list(ctx_local)
    keep = [True] * len(local)
    seen: set[tuple[str, str]] = set()
    for i in range(len(local) - 1, -1, -1):
        op = local[i]
        if op.action in ("set", "del", "link"):
            field = (op.obj, op.key)
            if field in seen:
                keep[i] = False
            else:
                seen.add(field)
    ops = [op for i, op in enumerate(local) if keep[i]]

    opset = doc._doc.opset
    undo_pos = opset.undo_pos
    opset = opset.replace_undo(
        undo_pos=undo_pos + 1,
        undo_stack=opset.undo_stack[:undo_pos] + (tuple(ctx_undo_local),),
        redo_stack=())
    return _apply_new_change(doc, opset, ops, message)


def change(doc, message_or_fn=None, fn: Callable | None = None) -> RootMap:
    """Apply a local change via a callback receiving a mutable proxy
    (automerge.js:160-184). Accepts change(doc, fn) or change(doc, message, fn)."""
    _check_target("change", doc)
    message = message_or_fn
    if callable(message_or_fn) and fn is None:
        message, fn = None, message_or_fn
    if message is not None and not isinstance(message, str):
        raise TypeError("Change message must be a string")
    if fn is None:
        raise TypeError("change() requires a callback")

    ctx = ChangeContext(doc._doc)
    fn(root_proxy(ctx))

    if not ctx.local:
        return doc  # nothing changed: return the identical document object
    return _make_change(doc, ctx.local, ctx.undo_local, message)


class Transaction:
    """Imperative change-building: an alternative to the change() callback.

        tx = am.begin(doc)
        tx.root["title"] = "hello"
        tx.root["items"].append(1)
        doc2 = tx.commit("my message")

    Reads through tx.root see earlier writes. `commit` returns the new
    document (or the original unchanged document if nothing was written);
    `rollback` discards the working state. A committed or rolled-back
    transaction cannot be reused.
    """

    def __init__(self, doc):
        _check_target("begin", doc)
        self._doc = doc
        self._ctx = ChangeContext(doc._doc)
        self.root = root_proxy(self._ctx)
        self._done = False

    def commit(self, message: str | None = None):
        if self._done:
            raise RuntimeError("transaction already finished")
        if message is not None and not isinstance(message, str):
            raise TypeError("Change message must be a string")
        self._done = True
        if not self._ctx.local:
            return self._doc
        return _make_change(self._doc, self._ctx.local,
                            self._ctx.undo_local, message)

    def rollback(self) -> None:
        self._done = True


def begin(doc) -> Transaction:
    """Start an imperative transaction on a document."""
    return Transaction(doc)


def empty_change(doc, message: str | None = None) -> RootMap:
    """Commit a change containing no ops (automerge.js:186-192)."""
    _check_target("empty_change", doc)
    if message is not None and not isinstance(message, str):
        raise TypeError("Change message must be a string")
    return _make_change(doc, [], [], message)


def assign(target, values: dict) -> None:
    """Bulk-assign into a writable proxy (automerge.js:194-207)."""
    if not isinstance(target, (MapProxy, ListProxy)):
        raise TypeError("assign requires a writable object as first argument; "
                        "use change() to get a writable version.")
    if not isinstance(values, dict):
        raise TypeError("The second argument to assign must be a dict")
    for key, value in values.items():
        target[key] = value  # ListProxy accepts ints and digit strings


# ---------------------------------------------------------------------------
# Remote-change ingestion (auto_api.js:113-137)

def apply_changes(doc, changes) -> RootMap:
    """Apply changes received from another replica."""
    _check_target("apply_changes", doc)
    changes = [coerce_change(c) for c in changes]
    opset = doc._doc.opset
    incremental = len(opset.history) > 0
    return apply_changes_to_doc(doc, opset, changes, incremental)


def merge(local, remote) -> RootMap:
    """Merge another replica's document into this one (auto_api.js:124-137)."""
    _check_target("merge", local)
    if local._doc.actor_id == remote._doc.actor_id:
        raise ValueError("Cannot merge an actor with itself")
    opset = local._doc.opset
    changes = remote._doc.opset.get_missing_changes(opset.clock)
    return apply_changes_to_doc(local, opset, changes, incremental=True)


# ---------------------------------------------------------------------------
# Undo / redo (auto_api.js:70-111)

def can_undo(doc) -> bool:
    _check_target("can_undo", doc)
    return doc._doc.opset.undo_pos > 0


def undo(doc, message: str | None = None) -> RootMap:
    _check_target("undo", doc)
    if message is not None and not isinstance(message, str):
        raise TypeError("Change message must be a string")
    opset = doc._doc.opset
    undo_pos = opset.undo_pos
    if undo_pos < 1 or undo_pos > len(opset.undo_stack):
        raise ValueError("Cannot undo: there is nothing to be undone")
    undo_ops = opset.undo_stack[undo_pos - 1]

    redo_ops: list[Op] = []
    for op in undo_ops:
        if op.action == "move":
            # redo = move back to the element's CURRENT location (read
            # now: applying the undo rewrites it)
            cur = _current_location(opset, op)
            if cur is not None:
                redo_ops.append(Op("move", cur.obj, key=cur.key,
                                   value=op.value))
            continue
        if op.action not in ("set", "del", "link"):
            raise ValueError(f"Unexpected operation type in undo history: {op!r}")
        field_ops = O.get_field_ops(opset, op.obj, op.key)
        if not field_ops:
            redo_ops.append(Op("del", op.obj, key=op.key))
        else:
            redo_ops.extend(f.stripped() for f in field_ops)

    opset = opset.replace_undo(
        undo_pos=undo_pos - 1,
        redo_stack=opset.redo_stack + (tuple(redo_ops),))
    return _apply_new_change(doc, opset, _finalize_move_ops(opset, undo_ops),
                             message)


def _current_location(opset: OpSet, op: Op) -> Op | None:
    """The effective location op of a move target right now (map child:
    resolved loc or first inbound link; list element: its placement)."""
    dest = opset.by_object.get(op.obj)
    if dest is not None and dest.is_sequence:
        return dest.insertion.get(op.value)
    child = opset.by_object.get(op.value)
    if child is None:
        return None
    if child.loc is not None:
        return child.loc
    for ref in child.inbound:
        if ref.action == "link":
            return ref
    return None


def _finalize_move_ops(opset: OpSet, ops) -> list[Op]:
    """Allocate fresh destination elem counters for LIST move ops in an
    undo/redo replay — stored records deliberately omit them so a stale
    stamp can never tie with elements inserted since."""
    out: list[Op] = []
    bump: dict[str, int] = {}
    for op in ops:
        if op.action == "move" and op.elem is None:
            dest = opset.by_object.get(op.obj)
            if dest is not None and dest.is_sequence:
                nxt = bump.get(op.obj, dest.max_elem) + 1
                bump[op.obj] = nxt
                op = Op("move", op.obj, key=op.key, value=op.value,
                        elem=nxt)
        out.append(op)
    return out


def can_redo(doc) -> bool:
    _check_target("can_redo", doc)
    return len(doc._doc.opset.redo_stack) > 0


def redo(doc, message: str | None = None) -> RootMap:
    _check_target("redo", doc)
    if message is not None and not isinstance(message, str):
        raise TypeError("Change message must be a string")
    opset = doc._doc.opset
    if not opset.redo_stack:
        raise ValueError("Cannot redo: the last change was not an undo")
    redo_ops = opset.redo_stack[-1]
    opset = opset.replace_undo(
        undo_pos=opset.undo_pos + 1,
        redo_stack=opset.redo_stack[:-1])
    return _apply_new_change(doc, opset, _finalize_move_ops(opset, redo_ops),
                             message)


# ---------------------------------------------------------------------------
# Persistence (automerge.js:209-226): the change log is the save format.

def save(doc) -> str:
    """Serialize the full change history as JSON."""
    _check_target("save", doc)
    return json.dumps({
        "automerge_tpu": SAVE_FORMAT_VERSION,
        "changes": [c.to_dict() for c in doc._doc.opset.history],
    })


def save_transit(doc) -> str:
    """Serialize the history in Automerge's own save format: transit
    JSON of the change list (automerge.js:223-226, transit-immutable-js).
    The output is loadable by Automerge's ``Automerge.load``."""
    from .interop.transit import changes_to_transit
    _check_target("save_transit", doc)
    return changes_to_transit(doc._doc.opset.history)


def load_transit(data: str | bytes, actor_id: str | None = None,
                 device="cuda") -> RootMap:
    """Load a save file produced by Automerge (``Automerge.save``,
    automerge.js:223-226) or by :func:`save_transit`, on `device`."""
    from .interop.transit import changes_from_transit
    doc = init(actor_id, device=device)
    return apply_changes_to_doc(doc, doc._doc.opset,
                                changes_from_transit(data),
                                incremental=False, emit_diffs=False)


def load(data: str, actor_id: str | None = None, device="cuda") -> RootMap:
    """Rebuild a document on `device` by replaying a saved change log.

    Large causally-ordered logs take the bulk fast path (core/bulkload.py:
    native JSON parse + vectorized state build + one RGA linearization per
    list — O(n log n) instead of the interpretive replay's O(n^2) on long
    list histories); anything it cannot prove it handles exactly falls back
    to the interpretive path below."""
    from .core.bulkload import BULK_MIN_CHANGES, try_bulk_load
    if len(data) > 64 * BULK_MIN_CHANGES:  # cheap size gate before parsing
        opset = try_bulk_load(data, max_version=SAVE_FORMAT_VERSION,
                              device=device)
        if opset is not None:
            return materialize_root(actor_id or make_uuid(), opset)

    payload = json.loads(data)
    if isinstance(payload, dict):
        version = payload.get("automerge_tpu", SAVE_FORMAT_VERSION)
        if version > SAVE_FORMAT_VERSION:
            raise ValueError(f"Cannot load save format version {version}; "
                             f"this build supports up to {SAVE_FORMAT_VERSION}")
        changes = payload.get("changes", [])
    else:
        changes = payload  # bare list of changes
    doc = init(actor_id, device)
    # no-diff load: diffs have no consumer on a from-scratch replay
    return apply_changes_to_doc(doc, doc._doc.opset,
                                [coerce_change(c) for c in changes],
                                incremental=False, emit_diffs=False)


# ---------------------------------------------------------------------------
# Introspection

def equals(val1, val2) -> bool:
    """Deep equality ignoring document metadata (automerge.js:228-237)."""
    if isinstance(val1, Text) or isinstance(val2, Text):
        return val1 == val2
    if isinstance(val1, dict) and isinstance(val2, dict):
        if set(val1.keys()) != set(val2.keys()):
            return False
        return all(equals(val1[k], val2[k]) for k in val1)
    if isinstance(val1, (list, tuple)) and isinstance(val2, (list, tuple)):
        if len(val1) != len(val2):
            return False
        return all(equals(a, b) for a, b in zip(val1, val2))
    return val1 == val2


def inspect(doc) -> Any:
    """Plain-Python deep copy of a document (automerge.js:239-242)."""
    def convert(value):
        if isinstance(value, Text):
            return str(value)
        if isinstance(value, dict):
            return {k: convert(v) for k, v in value.items()}
        if isinstance(value, (list, tuple)):
            return [convert(v) for v in value]
        return value
    return convert(doc)


class HistoryEntry:
    """One entry of getHistory: the change plus a lazy snapshot
    (automerge.js:244-259)."""

    __slots__ = ("_opset", "_actor_id", "_index", "change")

    def __init__(self, opset: OpSet, actor_id: str, index: int, change_dict: dict):
        self._opset = opset
        self._actor_id = actor_id
        self._index = index
        self.change = change_dict

    @property
    def snapshot(self) -> RootMap:
        doc = init(self._actor_id, self._opset.device)
        changes = [self._opset.history[i] for i in range(self._index + 1)]
        return apply_changes_to_doc(doc, doc._doc.opset, changes,
                                    incremental=False, emit_diffs=False)


def get_history(doc) -> list[HistoryEntry]:
    _check_target("get_history", doc)
    opset = doc._doc.opset
    actor_id = doc._doc.actor_id
    return [HistoryEntry(opset, actor_id, i, change.to_dict())
            for i, change in enumerate(opset.history)]


def diff(old_doc, new_doc) -> list[dict]:
    """Edit records taking old_doc's state to new_doc's (automerge.js:270-288)."""
    _check_target("diff", old_doc)
    old_clock = old_doc._doc.opset.clock
    new_clock = new_doc._doc.opset.clock
    if not C.less_or_equal(old_clock, new_clock):
        raise ValueError("Cannot diff two states that have diverged")
    changes = new_doc._doc.opset.get_missing_changes(old_clock)
    _, diffs = old_doc._doc.opset.add_changes(changes)
    return diffs


def get_conflicts(doc, obj) -> Any:
    """Conflict losers for a map snapshot ({key: {actor: value}}) or a list
    snapshot (per-index list) (automerge.js:290-298)."""
    if isinstance(obj, (FrozenMap, FrozenList)):
        return obj._conflicts
    raise TypeError("The second argument to get_conflicts must be a document object")


# ---------------------------------------------------------------------------
# Changes API (automerge.js:300-323)

def get_changes(old_doc, new_doc) -> list[dict]:
    """Changes in new_doc that old_doc lacks, in wire (dict) form."""
    _check_target("get_changes", old_doc)
    old_clock = old_doc._doc.opset.clock
    new_clock = new_doc._doc.opset.clock
    if not C.less_or_equal(old_clock, new_clock):
        raise ValueError("Cannot diff two states that have diverged")
    return [c.to_dict() for c in
            new_doc._doc.opset.get_missing_changes(old_clock)]


def get_changes_for_actor(doc, actor_id: str) -> list[dict]:
    _check_target("get_changes_for_actor", doc)
    return [c.to_dict() for c in
            doc._doc.opset.get_changes_for_actor(actor_id)]


def get_missing_changes(doc, have_deps: dict[str, int]) -> list[dict]:
    _check_target("get_missing_changes", doc)
    return [c.to_dict() for c in doc._doc.opset.get_missing_changes(have_deps)]


def get_missing_deps(doc) -> dict[str, int]:
    _check_target("get_missing_deps", doc)
    return doc._doc.opset.get_missing_deps()


def get_clock(doc) -> dict[str, int]:
    """The document's vector clock (highest applied seq per actor)."""
    _check_target("get_clock", doc)
    return dict(doc._doc.opset.clock)


def get_actor_id(doc) -> str:
    _check_target("get_actor_id", doc)
    return doc._doc.actor_id


def changes_from_json(data: str | bytes) -> list[Change]:
    """Parse a JSON array of changes (the sync wire format). Uses the native
    C++ wire codec when available, falling back to the pure-Python path."""
    try:
        from .native.wire import parse_changes_json
        cols = parse_changes_json(data)
        if cols is not None:
            return cols.to_changes()
    except ImportError:
        pass
    if isinstance(data, bytes):
        data = data.decode("utf-8")
    return [coerce_change(c) for c in json.loads(data)]
