"""Snapshot materialization with incremental cache maintenance.

The analog of the reference's FreezeAPI (Automerge's src/freeze_api.js):
folds CRDT state into frozen snapshots, keeping a per-document cache of
materialized objects. After a change, only the touched objects and their
ancestor chain up to the root are rebuilt (freeze_api.js:148-186); everything
else is shared structurally with the previous snapshot.

This is the port's copy of `automerge_tpu/frontend/materialize.py`;
`apply_changes_to_doc` is timed under `perfscope.phase("host_materialize")`.
"""

from __future__ import annotations

from typing import Any

from ..core import opset as O
from ..core.ids import ROOT_ID
from ..core.opset import Link, OpSet
from ..utils import perfscope
from .snapshots import DocState, FrozenList, FrozenMap, RootMap
from .text import Text


def _op_value(state, op, cache: dict) -> Any:
    """Application-visible value of a field op (op_set.js:399-405)."""
    if op.action == "link" or op.action == "move":
        # a map move's value is the relocated child's object id
        return _materialize(state, op.value, cache)
    return op.value


def _materialize(state, object_id: str, cache: dict) -> Any:
    """Materialize `object_id`, reusing cached snapshots of descendants."""
    if object_id != ROOT_ID and object_id in cache:
        return cache[object_id]
    snapshot = _build(state, object_id, cache)
    cache[object_id] = snapshot
    return snapshot


def _build(state, object_id: str, cache: dict) -> Any:
    """Build one object's snapshot; children come from `cache` (or are built
    recursively on a cache miss)."""
    obj = state.by_object[object_id]

    if obj.init_action == "makeText":
        # Lazy view over the (persistent) element index: O(1) per rebuild,
        # reads resolve on demand — the reference's Text does exactly this
        # over its skip list (text.js:3-32, no per-char diff folding).
        def resolve(value, _state=state, _cache=cache):
            if isinstance(value, Link):
                return _materialize(_state, value.obj, _cache)
            return value
        return Text(object_id=object_id, _elems=obj.elem_ids,
                    _resolve=resolve)

    if obj.init_action == "makeList":
        values, conflicts = [], []
        for key in obj.elem_ids.keys:
            ops = obj.fields.get(key, ())
            values.append(_op_value(state, ops[0], cache))
            if len(ops) > 1:
                conflicts.append({op.actor: _op_value(state, op, cache)
                                  for op in ops[1:]})
            else:
                conflicts.append(None)
        return FrozenList(values, object_id, conflicts)

    # map (including the root)
    data, conflicts = {}, {}
    for key, ops in obj.fields.items():
        if not O.valid_field_name(key) or not ops:
            continue
        data[key] = _op_value(state, ops[0], cache)
        if len(ops) > 1:
            conflicts[key] = {op.actor: _op_value(state, op, cache)
                              for op in ops[1:]}
    if object_id == ROOT_ID:
        return (data, conflicts)  # root snapshot assembled by build_root
    return FrozenMap(data, object_id, conflicts)


def build_root(actor_id: str, opset: OpSet, cache: dict) -> RootMap:
    """Assemble a fresh root snapshot object (always a new identity, mirroring
    freeze_api.js:253-262)."""
    data, conflicts = _build(opset, ROOT_ID, cache)
    doc_state = DocState(actor_id, opset, cache)
    return RootMap(data, ROOT_ID, conflicts, doc_state)


def materialize_root(actor_id: str, opset: OpSet) -> RootMap:
    """Full (non-incremental) materialization into a fresh cache."""
    cache: dict = {}
    return build_root(actor_id, opset, cache)


def update_cache(opset: OpSet, diffs: list[dict], old_cache: dict) -> dict:
    """Incremental cache maintenance (freeze_api.js:148-186).

    Rebuilds each object touched by `diffs`, then propagates rebuilds up the
    inbound-link ancestor DAG to the root. Returns a new cache dict sharing
    untouched snapshots with `old_cache`.
    """
    cache = dict(old_cache)

    # Objects directly touched, in diff order (children are created/updated
    # before the parent link that references them).
    affected: list[str] = []
    seen: set[str] = set()
    for diff in diffs:
        obj = diff["obj"]
        if obj not in seen:
            seen.add(obj)
            affected.append(obj)

    for object_id in affected:
        if object_id != ROOT_ID:  # the root is rebuilt once, by build_root
            cache[object_id] = _build(opset, object_id, cache)

    # Ancestor propagation: wave by wave toward the root. A move-managed
    # object walks its RESOLVED location only (obj.loc) — the raw inbound
    # set also holds LOSING move candidates, which may cross-reference
    # (A holds a losing move of B and vice versa) even though the
    # resolved forest never cycles. The wave cap is a safety net against
    # genuinely cyclic link graphs (a pre-move-era wart this walk
    # previously looped on).
    wave = set(affected)
    for _depth in range(len(opset.by_object) + 1):
        if not wave:
            break
        parents: set[str] = set()
        for object_id in wave:
            obj = opset.by_object.get(object_id)
            if obj is None:
                continue
            if obj.loc is not None:
                parents.add(obj.loc.obj)
            else:
                for ref in obj.inbound:
                    parents.add(ref.obj)
        for parent_id in parents:
            if parent_id != ROOT_ID:
                cache[parent_id] = _build(opset, parent_id, cache)
        wave = parents - {ROOT_ID}

    return cache


def apply_changes_to_doc(doc, opset: OpSet, changes, incremental: bool,
                         emit_diffs: bool = True,
                         text_batch: bool | None = None):
    """The frontend's change-ingestion entry point (freeze_api.js:245-267):
    run changes through the CRDT core, then refresh the materialization.
    Dispatches on the document's frontend style (auto_api.js:34-38).

    emit_diffs=False (valid only with incremental=False, where the diff
    stream has no consumer) takes the opset's no-diff fast path — the
    bench oracle deliberately keeps emit_diffs=True, because the
    reference's applyChanges cannot skip diff emission (its frontends
    are diff-driven, op_set.js:105-129).

    text_batch=None (the default) opts incremental ingestion into the
    span-granularity text plane (core/textspans.py): large all-text
    batches — the merge shape — are admitted with one splice per
    contiguous run and one coarse diff per object, which is exactly what
    update_cache folds; ineligible batches fall through to the per-op
    path unchanged. Pass False to force the per-op path (the bench's
    A/B baseline)."""
    if not emit_diffs and incremental:
        raise ValueError("emit_diffs=False requires incremental=False")
    if text_batch is None:
        text_batch = incremental
    with perfscope.phase("host_materialize"):
        new_opset, diffs = opset.add_changes(changes, emit_diffs=emit_diffs,
                                             text_batch=text_batch)
        if getattr(doc._doc, "frontend", "frozen") == "immutable":
            # The immutable-view frontend re-instantiates from the opset
            # (the reference's ImmutableAPI likewise refreshes rather than
            # patches, immutable_api.js:45-50).
            from .immutable_view import materialize_immutable_root
            return materialize_immutable_root(doc._doc.actor_id, new_opset)
        if incremental:
            cache = update_cache(new_opset, diffs, doc._doc.cache)
        else:
            cache = {}
        return build_root(doc._doc.actor_id, new_opset, cache)
