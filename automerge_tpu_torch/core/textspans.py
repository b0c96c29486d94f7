"""Batched text merging at span granularity (the eg-walker shape).

The generic ingestion path (core/opset.py) applies every op of every
incoming change through the per-op RGA machinery: each insert pays an
index-resolution walk plus an O(CHUNK + chunks) element-index update, and
each op emits a diff record — so merging a remote history into a long text
costs per-op work in the *document*, not in the *divergence*. Eg-walker
("Collaborative Text Editing with Eg-walker: Better, Faster, Smaller",
arxiv 2409.14252) shows the winning shape for collaborative text: replay
on merge over the causal graph, touch only the spans that are actually
concurrent, and keep the working state run-length encoded.

This module is that shape for our OpSet. For an eligible batch (all ops
are ins/set/del on existing makeText objects, causally ready in order,
nothing queued):

- **Region split.** Each change is classified against the local causal
  frontier at its admission point: a *sequential* change (its transitive
  clock covers the frontier — a single writer streaming, or a peer that
  is strictly ahead) skips every per-pair concurrency check outright:
  all prior field ops are causally dominated by construction. Only
  *concurrent* changes replay through `is_concurrent`.

- **RLE span splices.** Consecutive inserts that chain (each op's parent
  is the previous op's element — the typing/paste shape) are segmented
  into runs at admission time. The visible-order index is then updated
  with ONE placement walk and ONE `ElemList.splice_insert` per run
  instead of per op, so order maintenance costs O(spans), not O(ops).

- **Placement invariant.** A run splices immediately after its closest
  *already-placed* document-order predecessor (a `get_previous` walk that
  skips tombstones and not-yet-placed batch elements). Because every run
  placed later inserts after *its own* closest placed predecessor, placed
  elements are always in correct relative document order regardless of
  placement sequence — the property tests/test_textspans.py pins against
  per-op replay under hypothesis.

The CRDT tables themselves (fields / following / insertion / clocks /
history) are maintained bit-identically to the per-op path — the batch
plane only changes *how the visible-order index is maintained* and *what
diff records are emitted* (one coarse ``{"action": "batch"}`` record per
touched object; frontend/materialize.update_cache folds per object, so
the materialization is unaffected). Callers that need per-op edit records
must not opt in (`OpSet.add_changes(text_batch=...)`).

The device-side twin of this plane (span tables packed into lanes with a
batched merge-order sort and the B3 rank+hash kernel) lives in
engine/span_kernels.py; `try_apply_text_batch` places spans on the host,
as the reference does.

This is the port's copy of `automerge_tpu/core/textspans.py`; the
placement loop is timed under `perfscope.phase("span_merge")`.
"""

from __future__ import annotations

from ..utils import metrics, perfscope
from .change import Change
from .elems import CHUNK
from .ids import HEAD, make_elem_id
from .opset import (Builder, Link, admit_change_header, get_path,
                    get_previous, is_concurrent)

# Below this many ops the per-op path's constants win (and small batches
# are what interactive editing sends — they keep their per-op diff
# records). Tests override this to force the span plane on tiny batches.
TEXT_BATCH_MIN_OPS = 48

_TEXT_ACTIONS = frozenset(("ins", "set", "del"))


class _ObjBatch:
    """Per-object working state of one batched apply."""

    __slots__ = ("obj", "runs", "run_of", "last_ins", "dirty", "new")

    def __init__(self, obj, batch_ops: int = 0):
        self.obj = obj
        self.runs: list[list[str]] = []   # contiguous new-element runs
        self.run_of: dict[str, int] = {}  # new elem id -> run index
        self.last_ins: str | None = None  # chain-extension anchor
        self.dirty: set = set()           # assigned PRE-batch elem keys
        self.new: set = set()             # elem ids inserted this batch
        # Big batches fork the object's CRDT-table CowDicts up front
        # (fields/following/insertion write per op): one O(n) base fork
        # beats per-op persistent-overlay updates — same crossover
        # reasoning as ElemList.own_kmap in _place_object below.
        if batch_ops > max(1024, len(obj.fields) // 256):
            for table in (obj.fields, obj.following, obj.insertion):
                rebase = getattr(table, "rebase", None)
                if rebase is not None:
                    rebase()


def _scan(b: Builder, changes: list) -> dict | None:
    """Pre-mutation eligibility check: every change must be causally ready
    in sequence, duplicate-free, and composed purely of ins/set/del ops on
    existing makeText objects with resolvable parents/targets. Returns the
    per-object op counts when eligible (they size the copy-on-write
    ownership decision per object); anything else returns None and the
    generic path keeps its exact semantics (queueing, idempotent drops,
    error surfaces)."""
    total_ops = 0
    obj_ops: dict[str, int] = {}
    clock = dict(b.clock)
    known: dict[str, object] = {}
    new_elems: dict[str, set] = {}
    for change in changes:
        if not isinstance(change, Change):
            return None
        actor, seq = change.actor, change.seq
        if seq != clock.get(actor, 0) + 1:
            return None  # duplicate or gap: generic semantics own those
        for a, s in change.deps.items():
            if a != actor and clock.get(a, 0) < s:
                return None  # not causally ready in batch order
        for op in change.ops:
            if op.action not in _TEXT_ACTIONS:
                return None
            oid = op.obj
            obj = known.get(oid)
            if obj is None:
                obj = b.by_object.get(oid)
                if obj is None or obj.init_action != "makeText":
                    return None
                known[oid] = obj
                new_elems[oid] = set()
            new = new_elems[oid]
            if op.action == "ins":
                if op.elem is None or op.key is None:
                    return None
                eid = f"{actor}:{op.elem}"
                if eid in new or eid in obj.insertion:
                    return None  # duplicate elem id: per-op error path
                if (op.key != HEAD and op.key not in new
                        and op.key not in obj.insertion):
                    return None  # unknown parent element
                new.add(eid)
            else:
                key = op.key
                if (not isinstance(key, str)
                        or (key not in new and key not in obj.insertion)):
                    return None  # unknown element: per-op error path
            total_ops += 1
            obj_ops[oid] = obj_ops.get(oid, 0) + 1
        clock[actor] = seq
    return obj_ops if total_ops >= TEXT_BATCH_MIN_OPS else None


def _admit_ins(ob: _ObjBatch, op) -> None:
    """apply_insert's table maintenance + run segmentation. An insert
    extends the current run iff its parent is the immediately previously
    admitted element — no other sibling can have been admitted between
    two consecutive ops, so the chain is contiguous in document order at
    placement time (later runs splice INTO earlier blocks)."""
    obj = ob.obj
    eid = make_elem_id(op.actor, op.elem)
    obj.following[op.key] = obj.following.get(op.key, ()) + (op,)
    if op.elem > obj.max_elem:
        obj.max_elem = op.elem
    obj.insertion[eid] = op
    if ob.last_ins is not None and op.key == ob.last_ins:
        r = ob.run_of[ob.last_ins]
        ob.runs[r].append(eid)
    else:
        r = len(ob.runs)
        ob.runs.append([eid])
    ob.run_of[eid] = r
    ob.last_ins = eid
    ob.new.add(eid)


def _admit_assign(b: Builder, ob: _ObjBatch, op, sequential: bool) -> None:
    """apply_assign's survivor analysis without diff emission or per-op
    index maintenance. A sequential change causally knows every prior op
    on the field, so the whole per-pair `is_concurrent` join collapses to
    'everything prior is overwritten'."""
    obj = ob.obj
    key = op.key
    prior = obj.fields.get(key, ())
    if sequential or not prior:
        for prior_op in prior:
            if prior_op.action == "link":
                b.obj(prior_op.value).inbound.pop(prior_op, None)
        remaining = () if op.action == "del" else (op,)
    else:
        overwritten, rem = [], []
        for prior_op in prior:
            (rem if is_concurrent(b, prior_op, op)
             else overwritten).append(prior_op)
        for dead in overwritten:
            if dead.action == "link":
                b.obj(dead.value).inbound.pop(dead, None)
        if op.action != "del":
            rem.append(op)
        rem.sort(key=lambda o: o.actor or "", reverse=True)
        remaining = tuple(rem)
    obj.fields[key] = remaining
    if key not in ob.new:
        ob.dirty.add(key)


def _winner_value(fops):
    first = fops[0]
    return Link(first.value) if first.action == "link" else first.value


def _placed_predecessor_index(b: Builder, oid: str, elems, eid: str) -> int:
    """Visible index of the closest document-order predecessor of `eid`
    that is already in the element index (skipping tombstones and
    not-yet-placed batch elements), or -1 at the head."""
    prev = get_previous(b, oid, eid)
    while prev is not None:
        idx = elems.index_of(prev)
        if idx >= 0:
            return idx
        prev = get_previous(b, oid, prev)
    return -1


def _place_object(b: Builder, oid: str, ob: _ObjBatch) -> int:
    """Fold one object's batch into its visible-order index: one splice
    per run, then the dirty (pre-batch) keys — value rewrites, removals,
    and resurrections (a concurrent set outliving a delete). Returns the
    number of spans spliced."""
    fields_get = ob.obj.fields.get
    elems = b.elem_ids_mut(oid)
    # Key-map mode choice: every splice writes k + min-half-of-a-chunk
    # keys and every removal one, each a persistent-overlay update on a
    # copied index (~20us) — a big merge is better off forking the key
    # map's base dict ONCE (~0.05us/key) and writing at dict speed. The
    # crossover on the measuring host is ~n/400 writes; n//256 with a
    # 1024 floor keeps small interactive batches off the O(n) fork.
    est_writes = (len(ob.new) + (CHUNK // 2) * len(ob.runs)
                  + len(ob.dirty))
    if est_writes > max(1024, len(elems) // 256):
        elems.own_kmap()
    spans = 0
    for run in ob.runs:
        vis_keys: list[str] = []
        vis_vals: list = []
        for eid in run:
            fops = fields_get(eid)
            if fops:
                vis_keys.append(eid)
                vis_vals.append(_winner_value(fops))
        if not vis_keys:
            continue  # inserted and deleted within the batch: tombstones
        at = _placed_predecessor_index(b, oid, elems, run[0]) + 1
        elems.splice_insert(at, vis_keys, vis_vals)
        spans += 1
    for key in ob.dirty:
        fops = fields_get(key)
        idx = elems.index_of(key)
        if fops:
            val = _winner_value(fops)
            if idx >= 0:
                elems.set_value(key, val)
            else:
                # resurrection: place like a single-element run
                at = _placed_predecessor_index(b, oid, elems, key) + 1
                elems.insert_index(at, key, val)
                spans += 1
        elif idx >= 0:
            elems.remove_index(idx)
    return spans


def try_apply_text_batch(b: Builder, changes: list) -> list[dict] | None:
    """Admit a batch of changes through the span plane. Returns one coarse
    diff per touched object, or None when the batch needs the generic
    per-op path (the scan phase mutates nothing, so falling back is
    always safe)."""
    obj_ops = _scan(b, changes)
    if obj_ops is None:
        return None

    per_obj: dict[str, _ObjBatch] = {}
    seq_ops = conc_ops = 0
    for change in changes:
        prev_frontier = b.deps  # admit_change_header rebinds, not mutates
        all_deps = admit_change_header(b, change)
        # _scan rejected duplicates, so all_deps is never None here
        sequential = True
        for a, s in prev_frontier.items():
            if all_deps.get(a, 0) < s:
                sequential = False
                break
        actor, seq = change.actor, change.seq
        for op in change.ops:
            stamped = op.stamped(actor, seq)
            ob = per_obj.get(stamped.obj)
            if ob is None:
                ob = per_obj[stamped.obj] = _ObjBatch(
                    b.obj(stamped.obj), obj_ops[stamped.obj])
            if stamped.action == "ins":
                _admit_ins(ob, stamped)
            else:
                _admit_assign(b, ob, stamped, sequential)
        if sequential:
            seq_ops += len(change.ops)
        else:
            conc_ops += len(change.ops)

    diffs: list[dict] = []
    spans = 0
    with perfscope.phase("span_merge"):
        for oid, ob in per_obj.items():
            spans += _place_object(b, oid, ob)
            diffs.append({"action": "batch", "type": "text", "obj": oid,
                          "path": get_path(b, oid)})

    metrics.bump("sync_text_batches_merged")
    metrics.bump("sync_text_spans_spliced", spans)
    if seq_ops:
        metrics.bump("sync_text_ops_sequential", seq_ops)
    if conc_ops:
        metrics.bump("sync_text_ops_concurrent", conc_ops)
    return diffs


# ---------------------------------------------------------------------------
# RLE span extraction (the engine wire shape)

def merge_table(base_spans, blocks) -> list[tuple]:
    """Assemble one document's merge span table — the 7-tuple rows
    engine/pack.pack_spans ships — from its region split.

    `base_spans` is the RLE of the common history in document order,
    ALREADY split at every concurrent anchor gap and deletion boundary:
    (origin, start_id, vis_len) rows, vis_len=0 for a tombstone run (a
    region the merge deletes). `blocks` are the concurrent subtree
    blocks, each (gap, prio_elem, prio_actor, runs): `gap` is the index
    of the base span the block anchors AFTER (-1 for the head gap),
    (prio_elem, prio_actor) the RGA sibling priority of the block's head
    element against the other blocks in the same gap, and `runs` the
    block's RLE spans flattened in side-local document order (one side's
    spans in one gap stay contiguous — they are one insertion subtree).

    The merged document order is exactly
    ``lexsort(slot, -prio_elem, -prio_actor, block_seq)`` over the
    returned rows (engine/span_kernels.merge_spans): the table size is
    O(touched regions + concurrent spans), never O(document)."""
    rows = []
    for i, (origin, start, vis) in enumerate(base_spans):
        rows.append((origin, start, vis, 2 * i, 0, 0, i))
    for (gap, pelem, pactor, runs) in blocks:
        for j, (origin, start, vis) in enumerate(runs):
            rows.append((origin, start, vis, 2 * gap + 1, pelem, pactor, j))
    return rows


def rle_runs(keys):
    """Maximal runs of consecutively-numbered same-origin elem ids, in
    order: yields (actor, start_elem, length, start_index). The ONE
    definition of the run-boundary rule — spans_of_elems and both
    Text.spans() paths consume it, so lazy and eager views cannot
    drift."""
    cur_actor: str | None = None
    cur_start = cur_len = cur_at = 0
    prev_elem = -2
    at = 0
    for key in keys:
        i = key.rindex(":")
        actor, elem = key[:i], int(key[i + 1:])
        if actor == cur_actor and elem == prev_elem + 1:
            cur_len += 1
        else:
            if cur_actor is not None:
                yield cur_actor, cur_start, cur_len, cur_at
            cur_actor, cur_start, cur_len, cur_at = actor, elem, 1, at
        prev_elem = elem
        at += 1
    if cur_actor is not None:
        yield cur_actor, cur_start, cur_len, cur_at


def spans_of_elems(elems, insertion) -> list[tuple[str, int, int]]:
    """Run-length encode a visible element index: maximal runs of
    consecutive (actor, elem) ids in document order compress to
    (actor, start_elem, length) triples — the host form of the span rows
    engine/pack.pack_spans ships to the device, and what Text.spans()
    surfaces to the frontend. `insertion` is accepted for signature parity
    with future tombstone-carrying span tables; visibility is what the
    element index already encodes."""
    return [(a, s, n) for a, s, n, _ in rle_runs(elems.keys)]
