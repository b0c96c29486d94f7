"""Host half of the resident DocSet (counterpart of `automerge_tpu/engine/
resident.py`): per-document interning, causal admission, transitive clock
rows, the pure-Python delta encoder, actor ranking, capacities, and the
incremental hash mirror.

The docs-major device tables and their reconcile (the reference's
`apply_doc`/`_scatter_*` path) are not part of this port yet; the rows
engine (`resident_rows.ResidentRowsDocSet`) is the one device engine built
on this class.

Key mechanics, as in the reference:
- Interning tables grow in arrival order; state hashes stay canonical
  because they mix content hashes, not table ids (encode.content_hash).
- Actor ranks stay sorted by actor string (the LWW tie-break). A new actor
  re-ranks; the subclass remaps its resident rank columns (`_remap_actors`).
- Capacities (ops, lists, elements per list, actors) are powers of two,
  doubled on overflow.
- Causality: each document keeps a host queue of changes whose dependencies
  are not yet applied; duplicates drop idempotently.
"""

from __future__ import annotations

import numpy as np

from ..core.change import Change
from ..core.ids import ROOT_ID, HEAD, make_elem_id
from .encode import (A_INS, A_LINK, A_MAKE_LIST, A_MAKE_MAP,
                     A_MAKE_TEXT, A_MOVE, A_SET, _ACTION_CODE, ValueTable,
                     content_hash, move_loc_key, move_value_key,
                     value_hash_of, _pad_to)


class DocTables:
    """Host-side per-document interning state, arrival-ordered."""

    def __init__(self):
        self.objects: list[tuple[str, int]] = [(ROOT_ID, A_MAKE_MAP)]
        self.obj_index: dict[str, int] = {ROOT_ID: 0}
        self.fields: list[tuple[int, str]] = []
        self.fid_index: dict[tuple[int, str], int] = {}
        self.value_arrival: dict = {}   # key -> arrival id
        self.value_list: list = []
        self.list_rows: dict[int, int] = {}      # obj_idx -> list row
        self.elem_slots: dict[int, dict[str, int]] = {}  # obj_idx -> eid -> slot
        self.state_clocks: dict[tuple[str, int], dict[str, int]] = {}
        self.clock: dict[str, int] = {}
        # dependency frontier: the maximal (actor, seq) heads (op_set.js
        # keeps the same pruned set as opSet.deps)
        self.frontier: dict[str, int] = {}
        self.seen: set[tuple[str, int]] = set()
        self.queue: list = []  # _Pending records awaiting admission
        self.n_changes = 0
        self.n_lists = 0
        self.max_elems = 0

    # arrival-ordered value interning (ValueTable sorts; we can't)
    def value_id(self, value) -> int:
        key = ValueTable._key(value)
        if key not in self.value_arrival:
            self.value_arrival[key] = len(self.value_list)
            self.value_list.append(value)
        return self.value_arrival[key]

    def fid_of(self, obj_idx: int, key: str) -> int:
        fk = (obj_idx, key)
        if fk not in self.fid_index:
            self.fid_index[fk] = len(self.fields)
            self.fields.append(fk)
        return self.fid_index[fk]


class Delta:
    """Delta rows for one document, from the Python encoder."""

    def __init__(self):
        self.ops = []        # (code, fid, arank, seq, change_idx, value, fh, vh)
        self.clocks: list[np.ndarray] = []  # rows [cap_actors]
        self.ins = []        # (list_row, slot, elem, actor, parent_slot, fid)
        self.new_lists = []  # (list_row, obj_idx, obj_hash)
        self.changes = []    # admitted changes, in order


class _Pending:
    """A change awaiting causal admission: protocol header + payload."""
    __slots__ = ("actor", "seq", "deps", "payload")

    def __init__(self, actor: str, seq: int, deps: dict, payload):
        self.actor = actor
        self.seq = seq
        self.deps = deps
        self.payload = payload


class ResidentDocSet:
    """Host state shared by the port's resident engines."""

    def __init__(self, doc_ids: list[str]):
        self.doc_ids = list(doc_ids)
        self.doc_index = {d: i for i, d in enumerate(self.doc_ids)}
        n = len(self.doc_ids)
        self.tables = [DocTables() for _ in range(n)]
        self.actors: list[str] = []
        self.actor_rank: dict[str, int] = {}
        # running fleet-wide maxima of per-doc list/elem stats (values only
        # grow, so the cached max is exact)
        self._lists_hi = 0
        self._elems_hi = 0

        # capacities (powers of two); change ids and field ids live in the
        # rows themselves and are joined by equality, so neither needs one
        self.cap_ops = 8
        self.cap_lists = 1
        self.cap_elems = 8
        self.cap_actors = 2
        # doc-axis capacity: exact at construction, grown by add_docs
        self.cap_docs = max(n, 1)

        self.op_count = np.zeros(self.cap_docs, dtype=np.int64)
        self.change_count = np.zeros(self.cap_docs, dtype=np.int64)
        # doc indices whose causal queue is non-empty
        self._queued_docs: set[int] = set()

        # Incremental hash plane: a host mirror of the last per-doc hash
        # readback plus the doc indices whose state changed since. Reads
        # reconcile only dirty docs. hash_epoch bumps on every
        # hash-affecting mutation, never on reads.
        self._hash_mirror: np.ndarray | None = None
        self._doc_dirty: set[int] = set(range(n))
        self.hash_epoch = 0

    # ------------------------------------------------------------------
    def _grow(self, **caps):
        """Set new capacities. Subclasses re-lay their resident state; the
        mirror goes conservative across any re-layout."""
        for k, v in caps.items():
            setattr(self, k, v)
        self._mark_all_hash_dirty()

    def add_docs(self, new_ids: list[str]) -> list[str]:
        """Grow the document axis (a sync service auto-creates docs the way
        DocSet.apply_changes does). Capacity pads to a power of two past the
        current cap. Returns the ids that were new."""
        fresh = [d for d in dict.fromkeys(new_ids) if d not in self.doc_index]
        if not fresh:
            return fresh
        first_new = len(self.doc_ids)
        for d in fresh:
            self.doc_index[d] = len(self.doc_ids)
            self.doc_ids.append(d)
            self.tables.append(DocTables())
        # fresh docs have no mirror entry yet; existing docs stay clean
        self._mark_hash_dirty(range(first_new, len(self.doc_ids)))
        n = len(self.doc_ids)
        if n > self.cap_docs:
            k = _pad_to(n, 8) - self.cap_docs
            self.cap_docs += k
            self.op_count = np.concatenate([self.op_count,
                                            np.zeros(k, np.int64)])
            self.change_count = np.concatenate([self.change_count,
                                                np.zeros(k, np.int64)])
        return fresh

    # ------------------------------------------------------------------
    def _register_actors(self, changes_by_doc) -> None:
        self._register_actor_names(
            {c.actor for changes in changes_by_doc.values() for c in changes})

    def _register_actor_names(self, names: set) -> None:
        """Re-rank the actor table in sorted-string order; a rank change of
        known actors is pushed to the resident columns by _remap_actors."""
        new = set(names) - set(self.actors)
        if not new:
            return
        old_actors = list(self.actors)
        self.actors = sorted(set(self.actors) | new)
        self.actor_rank = {a: i for i, a in enumerate(self.actors)}
        if len(self.actors) > self.cap_actors:
            self._grow(cap_actors=_pad_to(len(self.actors), 2))
        if old_actors:
            # hash VALUES survive the remap (content hashes, never ranks),
            # but the mirror stays conservative across the rewrite
            self._mark_all_hash_dirty()
        perm = np.array([self.actor_rank[a] for a in old_actors],
                        dtype=np.int32)
        self._remap_actors(perm)

    def _remap_actors(self, perm: np.ndarray) -> None:
        """Rewrite resident rank columns: old rank r becomes perm[r]
        (called after every registration, perm empty on the first)."""
        raise NotImplementedError

    def _ensure_actor_hash_state(self) -> np.ndarray:
        """[cap_actors] int32 actor CONTENT hashes in the current rank basis
        (the state hash mixes these, never ranks, so hashes do not depend on
        the instance's global actor set; content_hash is memoized)."""
        vals = np.zeros(self.cap_actors, np.int32)
        for r, a in enumerate(self.actors):
            vals[r] = content_hash(a)
        return vals

    # ------------------------------------------------------------------
    def _admit(self, t: DocTables, incoming: list[_Pending]) -> list[_Pending]:
        """Causal admission fixpoint over the doc's queue + `incoming`
        (op_set.js:254-270 analog); duplicates drop idempotently."""
        pending = list(t.queue)
        for p in incoming:
            key = (p.actor, p.seq)
            # already queued/admitted (seen) or already applied: per-actor
            # seqs are dense and admitted in order, so clock >= seq
            if key in t.seen or t.clock.get(p.actor, 0) >= p.seq:
                continue
            pending.append(p)
            t.seen.add(key)
        ready: list[_Pending] = []
        progress = True
        while progress:
            progress = False
            still = []
            for p in pending:
                deps = dict(p.deps)
                deps[p.actor] = p.seq - 1
                if all(t.clock.get(a, 0) >= s for a, s in deps.items()):
                    ready.append(p)
                    t.clock[p.actor] = max(t.clock.get(p.actor, 0), p.seq)
                    # frontier update (op_set.js:243-249): drop heads the
                    # change declares it has seen, add the change itself
                    drop = [a for a, s in t.frontier.items()
                            if deps.get(a, 0) >= s]
                    for a in drop:
                        del t.frontier[a]
                    t.frontier[p.actor] = p.seq
                    progress = True
                else:
                    still.append(p)
            pending = still
        t.queue = pending
        return ready

    def _clock_row(self, t: DocTables, actor: str, seq: int,
                   deps: dict) -> np.ndarray:
        """Transitive clock row for one admitted change; also advances the
        per-doc state-clock memo."""
        base = dict(deps)
        base[actor] = seq - 1
        full: dict[str, int] = {}
        for a, s in base.items():
            if s <= 0:
                continue
            trans = t.state_clocks.get((a, s))
            if trans:
                for a2, s2 in trans.items():
                    if s2 > full.get(a2, 0):
                        full[a2] = s2
            full[a] = s
        t.state_clocks[(actor, seq)] = full
        row = np.zeros(self.cap_actors, dtype=np.int32)
        for a, s in full.items():
            row[self.actor_rank[a]] = s
        return row

    def _encode_delta(self, doc_idx: int, changes: list[Change]) -> Delta:
        """Pure-Python delta encode: admit, intern, and build op/ins rows."""
        t = self.tables[doc_idx]
        delta = Delta()
        ready = self._admit(t, [
            _Pending(c.actor, c.seq, dict(c.deps), c) for c in changes])
        if t.queue:
            self._queued_docs.add(doc_idx)
        else:
            self._queued_docs.discard(doc_idx)
        delta.changes = [p.payload for p in ready]
        for p in ready:
            c: Change = p.payload
            delta.clocks.append(self._clock_row(t, c.actor, c.seq, c.deps))
            change_idx = t.n_changes
            t.n_changes += 1

            arank = self.actor_rank[c.actor]
            for op in c.ops:
                code = _ACTION_CODE[op.action]
                if code in (A_MAKE_MAP, A_MAKE_LIST, A_MAKE_TEXT):
                    if op.obj not in t.obj_index:
                        t.obj_index[op.obj] = len(t.objects)
                        t.objects.append((op.obj, code))
                        if code in (A_MAKE_LIST, A_MAKE_TEXT):
                            oi = t.obj_index[op.obj]
                            row_i = len(t.list_rows)
                            t.list_rows[oi] = row_i
                            t.elem_slots[oi] = {}
                            delta.new_lists.append(
                                (row_i, oi, content_hash(op.obj)))
                    fid = -1
                    value = -1
                    fh = vh = 0
                elif code == A_INS:
                    oi = t.obj_index[op.obj]
                    eid = make_elem_id(c.actor, op.elem)
                    slots = t.elem_slots[oi]
                    if eid not in slots:
                        slot = len(slots)
                        slots[eid] = slot
                        parent_slot = (-1 if op.key == HEAD
                                       else slots[op.key])
                        fid = t.fid_of(oi, eid)
                        delta.ins.append((t.list_rows[oi], slot, op.elem,
                                          arank, parent_slot, fid))
                    fid = -1
                    value = -1
                    fh = vh = 0
                elif code == A_MOVE:
                    # location field on the root object (encode.py's
                    # move_loc_key contract)
                    if op.obj not in t.obj_index:
                        raise KeyError(f"move into unknown object {op.obj}")
                    lockey = move_loc_key(op)
                    fid = t.fid_of(0, lockey)
                    fh = content_hash(f"{ROOT_ID}\x00{lockey}")
                    vkey = move_value_key(op)
                    value = t.value_id(vkey)
                    vh = value_hash_of(vkey)
                else:  # assign
                    oi = t.obj_index[op.obj]
                    fid = t.fid_of(oi, op.key)
                    fh = content_hash(f"{op.obj}\x00{op.key}")
                    if code == A_SET:
                        value = t.value_id(op.value)
                        vh = value_hash_of(op.value)
                    elif code == A_LINK:
                        value = t.value_id(("__link__", op.value))
                        vh = value_hash_of(("__link__", op.value))
                    else:
                        value = -1
                        vh = 0
                delta.ops.append((code, fid, arank, c.seq, change_idx,
                                  value, fh, vh))
        t.n_lists = len(t.list_rows)
        if t.elem_slots:
            t.max_elems = max(len(s) for s in t.elem_slots.values())
        if t.n_lists > self._lists_hi:
            self._lists_hi = t.n_lists
        if t.max_elems > self._elems_hi:
            self._elems_hi = t.max_elems
        return delta

    # -- incremental hash plane ----------------------------------------

    def _mark_hash_dirty(self, idxs) -> None:
        """Record a hash-affecting mutation for specific docs. The epoch
        bumps even when every doc was already dirty: epoch equality is the
        sync layers' "nothing changed since my cached read" test."""
        self._doc_dirty.update(int(i) for i in idxs)
        self.hash_epoch += 1

    def _mark_all_hash_dirty(self) -> None:
        self._doc_dirty.update(range(len(self.doc_ids)))
        self.hash_epoch += 1

    def _ensure_hash_mirror(self) -> np.ndarray:
        n = len(self.doc_ids)
        mirror = self._hash_mirror
        if mirror is None or len(mirror) < n:
            grown = np.zeros(max(self.cap_docs, n), np.uint32)
            if mirror is not None:
                grown[:len(mirror)] = mirror
            self._hash_mirror = mirror = grown
        return mirror

    def _adopt_full_hashes(self, row: np.ndarray) -> None:
        """Adopt a full per-doc hash readback (flush-time capture): the
        mirror becomes current and every doc goes clean."""
        n = len(self.doc_ids)
        self._ensure_hash_mirror()[:n] = np.asarray(row)[:n]
        self._doc_dirty.clear()
