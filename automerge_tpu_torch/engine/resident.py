"""The resident DocSet (counterpart of `automerge_tpu/engine/resident.py`):
per-document interning, causal admission, transitive clock rows, the delta
encoders (the native C++ one of `native/deltaenc.cpp` and the pure-Python
`_encode_delta`), actor ranking, capacities, the incremental hash mirror,
and the docs-major device state with its reconcile.

State lives on `self.device` as a dict of docs-major tensors (`state`,
encode.stack_docs's columns at the instance's capacities), and only deltas
cross from the host: each round's rows are stacked into ONE flat int32
buffer (one copy), scattered at per-document offsets, and the whole state
is reconciled by `kernels.apply_doc`, whose domination step is the B5
kernel (`cuda_kernels.dominated`). The rows engine
(`resident_rows.ResidentRowsDocSet`) shares the host half and keeps its
own device layout instead.

Key mechanics, as in the reference:
- Interning tables grow in arrival order; state hashes stay canonical
  because they mix content hashes, not table ids (encode.content_hash).
- Actor ranks stay sorted by actor string (the LWW tie-break). A new actor
  re-ranks; the resident rank columns and clock columns are remapped
  (`_remap_actors`).
- Capacities (ops, changes, lists, elements per list, actors, fields) are
  powers of two, doubled on overflow; padding keeps every hash.
- Causality: each document keeps a host queue of changes whose dependencies
  are not yet applied; duplicates drop idempotently.
- Column ingress (`apply_columns`, `apply_and_reconcile_columns`): wire
  columns (`native.wire.WireColumns`, a decoded AMW1 frame) are admitted
  per change in Python and encoded per op in C++ straight from the frame
  bytes, one native call a round for every document.

- The diff plane (`apply_and_reconcile(..., diffs=True)` and its column
  twin): the round's converged state is compared on the device with the
  baseline the diff consumer last saw (`_scatter_apply_diff`), only the
  changed documents' rows come back, and `diffs.decode_round_diffs` turns
  them into the reference's edit records.

Telemetry, as in the reference: `engine_resident_apply` and
`engine_hashes` spans (`metrics.trace`), an `engine_hash_readback`
flight-recorder event before a reconcile's readback, and the `readback`
phase (`utils/perfscope.py`).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.change import Change
from ..core.ids import ROOT_ID, HEAD, make_elem_id
from ..device import resolve_device
from ..native.delta import NativeDeltaEncoder, frame_bytes_of
from ..native.wire import changes_to_columns
from ..utils import flightrec, metrics, perfscope
from .encode import (A_INS, A_LINK, A_MAKE_LIST, A_MAKE_MAP,
                     A_MAKE_TEXT, A_MOVE, A_SET, _ACTION_CODE, ValueTable,
                     content_hash, move_loc_key, move_value_key,
                     value_hash_of, _pad_to)
from .cuda_kernels import hashes_to_numpy
from .diffs import DIFF_ROWS, decode_round_diffs
from .kernels import _int32_bits, _mix4, apply_doc

OP_COLS = ("op_mask", "action", "fid", "actor", "seq", "change_idx", "value",
           "fid_hash", "value_hash")
# fill of each docs-major state column where it holds no row
_FILL = {"action": -1, "fid": -1, "value": -1, "ins_parent": -1,
         "ins_fid": -1, "list_obj": -1, "list_obj_hash": -1}


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
        # set to the doc index while the rows engine's vectorized admission
        # owns this table's clock/frontier truth in its dense cache;
        # _sync_stale_table materializes it back before any dict reader
        self._stale_idx: int | None = None
        self.n_changes = 0
        self.n_lists = 0
        self.max_elems = 0
        # snapshot-bootstrap floor (ResidentRowsDocSet.seed_clock): the
        # covered clock of the snapshot this doc was booted from, in
        # ORIGINAL seq numbering. Post-seed clock rows clamp to it: every
        # conforming suffix change covers the snapshot floor, and the
        # clamp restores the transitive coverage whose prefix memos the
        # compacted history no longer holds. None = never seeded.
        self.snap_floor: dict[str, int] | None = None

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
    """Delta rows for one document (lists of tuples from the Python encoder
    or numpy row arrays from the native one; stacked later)."""

    def __init__(self):
        self.ops = []        # rows matching OP_COLS[1:]
        self.clocks: list[np.ndarray] = []  # rows [cap_actors]
        self.ins = []        # (list_row, slot, elem, actor, parent_slot, fid)
        self.new_lists = []  # (list_row, obj_idx, obj_hash)
        self.changes = []    # admitted changes (Change or AdmittedRef)


class _Pending:
    """A change awaiting causal admission: protocol header + payload (a
    Change, or (cols, idx) into a columnar frame on a native instance)."""
    __slots__ = ("actor", "seq", "deps", "payload")

    def __init__(self, actor: str, seq: int, deps: dict, payload):
        self.actor = actor
        self.seq = seq
        self.deps = deps
        self.payload = payload


class AdmittedRef:
    """Lazy handle to an admitted change living in a columnar frame: the
    change log keeps it without materializing per-op Python objects."""
    __slots__ = ("cols", "idx")

    def __init__(self, cols, idx: int):
        self.cols = cols
        self.idx = idx

    @property
    def actor(self) -> str:
        return self.cols.actors[self.cols.change_actor[self.idx]]

    @property
    def seq(self) -> int:
        return int(self.cols.change_seq[self.idx])

    def change(self) -> Change:
        return self.cols.change_at(self.idx)


class ResidentDocSet:
    """A DocSet whose columnar state lives on the device.

    `device` is where the state lives and the reconcile runs: "cuda" (the
    default) needs a GPU and raises without one; "cpu" runs the kernels'
    plain PyTorch versions.

    `native` picks the instance's one delta encoder. True (the default):
    the C++ encoder (`native/deltaenc.cpp`, built with g++ at first use;
    a failed build raises RuntimeError), and Change-object ingress is
    converted to columns first so the C++ tables stay authoritative.
    False: the pure-Python `_encode_delta`. One instance never mixes the
    two: their interning tables would drift apart."""

    def __init__(self, doc_ids: list[str],
                 device: str | torch.device = "cuda", native: bool = True):
        self.device = resolve_device(device)
        self.doc_ids = list(doc_ids)
        self.doc_index = {d: i for i, d in enumerate(self.doc_ids)}
        n = len(self.doc_ids)
        self.tables = [DocTables() for _ in range(n)]
        self.actors: list[str] = []
        self.actor_rank: dict[str, int] = {}
        # running fleet-wide maxima of per-doc stats (values only grow, so
        # the cached max is exact)
        self._lists_hi = 0
        self._elems_hi = 0
        self._fids_hi = 0
        self._changes_hi = 0

        # capacities (powers of two)
        self.cap_ops = 8
        self.cap_changes = 8
        self.cap_lists = 1
        self.cap_elems = 8
        self.cap_actors = 2
        self.cap_fids = 8
        # doc-axis capacity: exact at construction, grown by add_docs
        self.cap_docs = max(n, 1)

        self.op_count = np.zeros(self.cap_docs, dtype=np.int64)
        self.change_count = np.zeros(self.cap_docs, dtype=np.int64)
        # doc indices whose causal queue is non-empty
        self._queued_docs: set[int] = set()
        # docs whose rows of the rows engine's dense admission cache are
        # stale; admission here only marks them
        self._cache_dirty: set[int] = set()
        # {doc_id: admitted changes} of the last docs-major build
        self.last_admitted: dict = {}

        # Incremental hash plane: a host mirror of the last per-doc hash
        # readback plus the doc indices whose state changed since. Reads
        # reconcile only dirty docs. hash_epoch bumps on every
        # hash-affecting mutation, never on reads.
        self._hash_mirror: np.ndarray | None = None
        self._doc_dirty: set[int] = set(range(n))
        self.hash_epoch = 0

        self.state: dict[str, torch.Tensor] = {}
        self._actor_hash_key = None
        self._alloc()
        # outputs of the last full reconcile (apply_doc's dict), or None
        # once the state changed since
        self._out: dict[str, torch.Tensor] | None = None
        # the diff plane's state: the baseline the diff consumer last saw
        # (present, win_value, win_actor, survivor hash, elem_visible,
        # vis_rank of the last diff round, on the device; None before the
        # first), the objects announced with a "create" record per doc,
        # and per doc each map-move child's last emitted location
        self._diff_prev: tuple | None = None
        self._diff_announced: dict[int, int] = {}
        self._diff_move_homes: dict[int, dict] = {}
        self._native = NativeDeltaEncoder.create() if native else None

    # ------------------------------------------------------------------
    def _alloc(self):
        n, dev = self.cap_docs, self.device
        ops = (n, self.cap_ops)
        ins = (n, self.cap_lists, self.cap_elems)
        shapes = {name: ops for name in OP_COLS}
        shapes.update(clock=(n, self.cap_changes, self.cap_actors),
                      ins_mask=ins, ins_elem=ins, ins_actor=ins,
                      ins_parent=ins, ins_fid=ins,
                      list_obj=(n, self.cap_lists),
                      list_obj_hash=(n, self.cap_lists))
        self.state = {
            name: torch.full(shape, _FILL.get(name, 0),
                             dtype=_dtype_of(name), device=dev)
            for name, shape in shapes.items()}

    def _grow(self, **caps):
        """Set new capacities and pad the resident tensors to them. Padding
        preserves per-doc hashes, but the mirror goes conservative across
        any re-layout (growth events are rare and amortized)."""
        self._mark_all_hash_dirty()
        for k, v in caps.items():
            setattr(self, k, v)
        s = self.state
        if not s:
            return
        ops = (self.cap_docs, self.cap_ops)
        ins = (self.cap_docs, self.cap_lists, self.cap_elems)
        for col in OP_COLS:
            s[col] = _pad(s[col], ops, _FILL.get(col, 0))
        s["clock"] = _pad(s["clock"], (self.cap_docs, self.cap_changes,
                                       self.cap_actors), 0)
        for col in ("ins_mask", "ins_elem", "ins_actor", "ins_parent",
                    "ins_fid"):
            s[col] = _pad(s[col], ins, _FILL.get(col, 0))
        for col in ("list_obj", "list_obj_hash"):
            s[col] = _pad(s[col], (self.cap_docs, self.cap_lists), -1)

    def add_docs(self, new_ids: list[str]) -> list[str]:
        """Grow the document axis (a sync service auto-creates docs the way
        DocSet.apply_changes does). Capacity pads to a power of two past the
        current cap; rows between len(doc_ids) and cap_docs are valid empty
        documents. Returns the ids that were new."""
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
        self._out = None
        n = len(self.doc_ids)
        if n > self.cap_docs:
            k = _pad_to(n, 8) - self.cap_docs
            self.cap_docs += k
            self.op_count = np.concatenate([self.op_count,
                                            np.zeros(k, np.int64)])
            self.change_count = np.concatenate([self.change_count,
                                                np.zeros(k, np.int64)])
            self.state = {
                name: _pad(t, (self.cap_docs,) + tuple(t.shape[1:]),
                           _FILL.get(name, 0))
                for name, t in self.state.items()}
        return fresh

    def reserve(self, *, ops_per_doc: int | None = None,
                changes_per_doc: int | None = None,
                lists_per_doc: int | None = None,
                elems_per_list: int | None = None,
                actors: int | None = None,
                fids_per_doc: int | None = None) -> None:
        """Pre-size resident capacity so steady-state rounds never regrow
        (a regrow re-lays every resident tensor)."""
        grow = {}
        for want, cap_name in ((ops_per_doc, "cap_ops"),
                               (changes_per_doc, "cap_changes"),
                               (elems_per_list, "cap_elems")):
            if want and _pad_to(want) > getattr(self, cap_name):
                grow[cap_name] = _pad_to(want)
        if lists_per_doc and _pad_to(lists_per_doc, 1) > self.cap_lists:
            grow["cap_lists"] = _pad_to(lists_per_doc, 1)
        if actors and _pad_to(actors, 2) > self.cap_actors:
            grow["cap_actors"] = _pad_to(actors, 2)
        if grow:
            self._grow(**grow)
        if fids_per_doc and _pad_to(fids_per_doc) > self.cap_fids:
            self.cap_fids = _pad_to(fids_per_doc)

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
        if self._diff_prev is not None and len(perm):
            # the diff baseline's winner ranks follow the remap, or every
            # field would look changed on the next diff round
            p, wv, wa, sh, ev, vr = self._diff_prev
            perm_t = torch.from_numpy(perm).to(wa.device)
            wa = torch.where(wa >= 0,
                             perm_t[wa.clamp(0, len(perm) - 1).long()], wa)
            self._diff_prev = (p, wv, wa, sh, ev, vr)

    def _remap_actors(self, perm: np.ndarray) -> None:
        """Rewrite resident rank columns: old rank r becomes perm[r] (called
        after every registration, perm empty on the first). Op and element
        actor columns map through perm; clock columns gather through its
        inverse (new -> old, a column no old actor had stays 0)."""
        if not len(perm) or not self.state:
            return
        s, dev = self.state, self.device
        perm_t = torch.from_numpy(perm).to(dev)
        inv = np.full(self.cap_actors, -1, dtype=np.int64)
        inv[perm] = np.arange(len(perm))
        inv_t = torch.from_numpy(inv).to(dev)
        hi = len(perm) - 1
        for col, mask in (("actor", "op_mask"), ("ins_actor", "ins_mask")):
            s[col] = torch.where(s[mask], perm_t[s[col].clamp(0, hi).long()],
                                 s[col])
        clock = s["clock"]
        gathered = clock[..., inv_t.clamp(0, clock.shape[-1] - 1)]
        s["clock"] = torch.where(inv_t >= 0, gathered, 0).to(torch.int32)
        self._out = None

    def _actor_hash_values(self) -> np.ndarray:
        """[cap_actors] int32 actor CONTENT hashes in the current rank basis
        (the state hash mixes these, never ranks, so hashes do not depend on
        the instance's global actor set; content_hash is memoized)."""
        vals = np.zeros(self.cap_actors, np.int32)
        for r, a in enumerate(self.actors):
            vals[r] = content_hash(a)
        return vals

    def _ensure_actor_hash_state(self) -> None:
        """Keep state["actor_hash"] current: [cap_docs, cap_actors] actor
        content hashes, rebuilt only when the actor table or the capacities
        that shape it change."""
        key = (len(self.actors), self.cap_actors, self.cap_docs)
        if "actor_hash" in self.state and self._actor_hash_key == key:
            return
        vals = torch.from_numpy(self._actor_hash_values()).to(self.device)
        self.state["actor_hash"] = vals[None].expand(
            self.cap_docs, -1).contiguous()
        self._actor_hash_key = key

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
            if trans is not None and not isinstance(trans, dict):
                # lazy dense-row memo of the rows engine's vectorized
                # admission: (matrix, row) in the CURRENT rank basis (made
                # dicts before any actor remap)
                arr, ridx = trans
                trans = {self.actors[r]: int(v)
                         for r, v in enumerate(arr[ridx]) if v}
                t.state_clocks[(a, s)] = trans
            if trans:
                for a2, s2 in trans.items():
                    if s2 > full.get(a2, 0):
                        full[a2] = s2
            full[a] = s
        if t.snap_floor:
            # snapshot-booted doc: memos for the compacted-away prefix do
            # not exist, but every conforming post-seed change covers the
            # snapshot floor (sync/snapshots.py)
            for a, s in t.snap_floor.items():
                if s > full.get(a, 0):
                    full[a] = s
        t.state_clocks[(actor, seq)] = full
        row = np.zeros(self.cap_actors, dtype=np.int32)
        for a, s in full.items():
            row[self.actor_rank[a]] = s
        return row

    def _encode_delta(self, doc_idx: int, changes: list[Change]) -> Delta:
        """Pure-Python delta encode (`native=False`): admit, intern, and
        build op/ins rows."""
        t = self.tables[doc_idx]
        delta = Delta()
        ready = self._admit(t, [
            _Pending(c.actor, c.seq, dict(c.deps), c) for c in changes])
        if t.queue:
            self._queued_docs.add(doc_idx)
        else:
            self._queued_docs.discard(doc_idx)
        self._cache_dirty.add(doc_idx)
        delta.changes = [p.payload for p in ready]
        for p in ready:
            c: Change = p.payload
            delta.clocks.append(self._clock_row(t, c.actor, c.seq, c.deps))
            change_idx = t.n_changes
            t.n_changes += 1
            if t.n_changes > self._changes_hi:
                self._changes_hi = t.n_changes

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

    # -- docs-major ingress ----------------------------------------------

    def apply_changes(self, changes_by_doc: dict[str, list[Change]]) -> None:
        """Encode + scatter a delta batch into resident state (no
        reconcile: the next read reconciles the docs it needs)."""
        if self._native is not None:
            self.apply_columns({d: changes_to_columns(chs)
                                for d, chs in changes_by_doc.items()})
            return
        self._register_actors(changes_by_doc)
        flat, meta = self._build_delta_arrays(changes_by_doc)
        _scatter_delta(self.state, flat, meta)
        self._out = None

    def apply_columns(self, cols_by_doc: dict) -> None:
        """Column ingress ({doc_id: WireColumns}): encode + scatter with no
        per-op Python on a native instance; through Change objects on a
        `native=False` one."""
        if self._native is None:
            self.apply_changes({d: c.to_changes()
                                for d, c in cols_by_doc.items()})
            return
        self._register_actors_cols(cols_by_doc)
        flat, meta = self._build_delta_arrays_cols(cols_by_doc)
        _scatter_delta(self.state, flat, meta)
        self._out = None

    def apply_and_reconcile(self, changes_by_doc: dict[str, list[Change]],
                            diffs: bool = False):
        """Delta apply + full reconcile in one pass: one copy of the delta
        rows to the device, the scatter, `apply_doc` over the whole state
        and one readback of the hashes. Returns np.uint32 hashes aligned
        with doc_ids.

        With diffs=True the pass also compares each field and element with
        the baseline the diff consumer last saw (the last diff round's
        state; empty before the first, so that round describes every
        document from scratch), and returns (hashes, {doc_id: [edit
        records]}): the reference's records (op_set.js:105-176), decoded
        for the changed entries only (engine/diffs.py). Rounds without
        diffs leave the baseline where it was, so their effects show in
        the next diff round."""
        if self._native is not None:
            return self.apply_and_reconcile_columns(
                {d: changes_to_columns(chs)
                 for d, chs in changes_by_doc.items()}, diffs=diffs)
        self._register_actors(changes_by_doc)
        flat, meta = self._build_delta_arrays(changes_by_doc)
        return self._apply_flat(flat, meta, diffs)

    def apply_and_reconcile_columns(self, cols_by_doc: dict,
                                    diffs: bool = False):
        """`apply_and_reconcile` for column ingress ({doc_id:
        WireColumns}); same arguments and return value."""
        if self._native is None:
            return self.apply_and_reconcile(
                {d: c.to_changes() for d, c in cols_by_doc.items()},
                diffs=diffs)
        self._register_actors_cols(cols_by_doc)
        flat, meta = self._build_delta_arrays_cols(cols_by_doc)
        return self._apply_flat(flat, meta, diffs)

    def _register_actors_cols(self, cols_by_doc: dict) -> None:
        new = set()
        for cols in cols_by_doc.values():
            for i in set(np.asarray(cols.change_actor).tolist()):
                new.add(cols.actors[i])
        self._register_actor_names(new)

    def _build_delta_arrays(self, changes_by_doc: dict[str, list[Change]]):
        deltas = [Delta() for _ in range(self.cap_docs)]
        self._mark_hash_dirty(self.doc_index[d] for d in changes_by_doc)
        self.last_admitted = {}
        for doc_id, changes in changes_by_doc.items():
            i = self.doc_index[doc_id]
            deltas[i] = self._encode_delta(i, changes)
            self.last_admitted[doc_id] = deltas[i].changes
        return self._stack_deltas(deltas)

    def _native_ingest_round(self, cols_by_doc: dict, on_admitted):
        """The native encode of one round: per-doc causal admission in doc
        order, frame dedup, the admitted-metadata columns, ONE batched
        native call straight from the raw AMW1 frame bytes, and the
        capacity-stats mirror. `on_admitted(i, t, ready)` runs per doc with
        its admitted _Pending list (clock rows, change logs) before the
        metadata is assembled. Returns (BatchDelta | None, adm_doc, cidxs),
        None when nothing was admitted."""
        frames: list[bytes] = []
        frame_of: dict[int, int] = {}
        adm_frame, adm_idx, adm_doc, aranks, seqs, cidxs = \
            [], [], [], [], [], []
        for doc_id in sorted(cols_by_doc, key=lambda d: self.doc_index[d]):
            cols = cols_by_doc[doc_id]
            i = self.doc_index[doc_id]
            t = self.tables[i]
            ready = self._admit(t, [
                _Pending(cols.actors[cols.change_actor[j]],
                         int(cols.change_seq[j]), cols.deps_at(j), (cols, j))
                for j in range(cols.n_changes)])
            if t.queue:
                self._queued_docs.add(i)
            else:
                self._queued_docs.discard(i)
            self._cache_dirty.add(i)
            on_admitted(i, t, ready)
            for p in ready:
                c, j = p.payload
                if id(c) not in frame_of:
                    frame_of[id(c)] = len(frames)
                    frames.append(frame_bytes_of(c))
                adm_frame.append(frame_of[id(c)])
                adm_idx.append(j)
                adm_doc.append(i)
                aranks.append(self.actor_rank[p.actor])
                seqs.append(p.seq)
                cidxs.append(t.n_changes)
                t.n_changes += 1
                if t.n_changes > self._changes_hi:
                    self._changes_hi = t.n_changes
        if not adm_doc:
            return None, adm_doc, cidxs

        self._native.ensure_docs(len(self.doc_ids))
        self._native.begin()
        self._native.apply_frames(frames, adm_frame, adm_idx, adm_doc,
                                  aranks, seqs, cidxs)
        bd = self._native.finish()
        for i in range(min(len(self.tables), len(bd.stats))):
            t = self.tables[i]
            t.n_lists = int(bd.stats[i, 0])
            t.max_elems = int(bd.stats[i, 1])
        if len(bd.stats):
            self._lists_hi = max(self._lists_hi, int(bd.stats[:, 0].max()))
            self._elems_hi = max(self._elems_hi, int(bd.stats[:, 1].max()))
        return bd, adm_doc, cidxs

    def _build_delta_arrays_cols(self, cols_by_doc: dict):
        """Columnar round encode: admission + clock rows in Python (per
        change), ONE batched native call for all per-op work (interning,
        hashing, row building) across every document of the round, read
        from the raw AMW1 frame bytes."""
        n = self.cap_docs
        deltas = [Delta() for _ in range(n)]
        self._mark_hash_dirty(self.doc_index[d] for d in cols_by_doc)
        self.last_admitted = {}

        def on_admitted(i, t, ready):
            deltas[i].changes = [AdmittedRef(*p.payload) for p in ready]
            self.last_admitted[self.doc_ids[i]] = deltas[i].changes
            for p in ready:
                deltas[i].clocks.append(
                    self._clock_row(t, p.actor, p.seq, p.deps))

        bd, _, _ = self._native_ingest_round(cols_by_doc, on_admitted)
        if bd is None:
            return self._stack_deltas(deltas)

        # slice the doc-grouped rows into per-doc deltas
        for rows, attr in ((bd.op_rows, "ops"), (bd.ins_rows, "ins"),
                           (bd.newlist_rows, "new_lists")):
            if len(rows):
                bounds = np.searchsorted(rows[:, 0], np.arange(n + 1))
                for i in range(n):
                    lo, hi = bounds[i], bounds[i + 1]
                    if hi > lo:
                        setattr(deltas[i], attr, rows[lo:hi, 1:])
        # mirror the table additions
        for d, name, kind in bd.new_objects:
            self.tables[d].objects.append((name, kind))
        for d, oi, key in bd.new_fields:
            self.tables[d].fields.append((oi, key))
        for d, v in bd.new_values:
            self.tables[d].value_list.append(v)
        return self._stack_deltas(deltas)

    def _stack_deltas(self, deltas: list[Delta]):
        """Grow capacities for the deltas, then stack them into one flat
        int32 buffer on the device (one copy) and its static meta."""
        n = self.cap_docs
        touched = [i for i, d in enumerate(deltas) if len(d.ops)
                   or len(d.clocks) or len(d.ins) or len(d.new_lists)]
        need_ops = int(max((self.op_count[i] + len(deltas[i].ops)
                            for i in touched), default=0))
        need_ch = int(max((self.change_count[i] + len(deltas[i].clocks)
                           for i in touched), default=0))
        self._fids_hi = max([self._fids_hi]
                            + [len(self.tables[i].fields) for i in touched])
        grow = {}
        if need_ops > self.cap_ops:
            grow["cap_ops"] = _pad_to(need_ops)
        if need_ch > self.cap_changes:
            grow["cap_changes"] = _pad_to(need_ch)
        if self._lists_hi > self.cap_lists:
            grow["cap_lists"] = _pad_to(self._lists_hi, 1)
        if self._elems_hi > self.cap_elems:
            grow["cap_elems"] = _pad_to(self._elems_hi)
        if grow:
            self._grow(**grow)
        if self._fids_hi > self.cap_fids:
            self.cap_fids = _pad_to(self._fids_hi)

        def most(attr):
            return _pad_to(max((len(getattr(deltas[i], attr))
                                for i in touched), default=1), 1)

        d_ops = np.zeros((n, most("ops"), 8), dtype=np.int32)
        d_ops_n = np.zeros(n, dtype=np.int32)
        d_clock = np.zeros((n, most("clocks"), self.cap_actors),
                           dtype=np.int32)
        d_ch_n = np.zeros(n, dtype=np.int32)
        d_ins = np.zeros((n, most("ins"), 6), dtype=np.int32)
        d_ins_n = np.zeros(n, dtype=np.int32)
        d_nl = np.zeros((n, most("new_lists"), 3), dtype=np.int32)
        d_nl_n = np.zeros(n, dtype=np.int32)
        offsets_ops = self.op_count.astype(np.int32)
        offsets_ch = self.change_count.astype(np.int32)
        for i in touched:
            d = deltas[i]
            if len(d.ops):
                d_ops[i, :len(d.ops)] = np.asarray(d.ops, dtype=np.int32)
                d_ops_n[i] = len(d.ops)
            if len(d.clocks):
                d_clock[i, :len(d.clocks)] = np.stack(d.clocks)
                d_ch_n[i] = len(d.clocks)
            if len(d.ins):
                d_ins[i, :len(d.ins)] = np.asarray(d.ins, dtype=np.int32)
                d_ins_n[i] = len(d.ins)
            if len(d.new_lists):
                d_nl[i, :len(d.new_lists)] = np.asarray(d.new_lists,
                                                        dtype=np.int32)
                d_nl_n[i] = len(d.new_lists)
            self.op_count[i] += len(d.ops)
            self.change_count[i] += len(d.clocks)

        parts = [d_ops, d_ops_n, offsets_ops, d_clock, d_ch_n, offsets_ch,
                 d_ins, d_ins_n, d_nl, d_nl_n]
        meta = tuple((p.shape, int(np.prod(p.shape))) for p in parts)
        flat = np.concatenate([p.ravel() for p in parts])
        return torch.from_numpy(flat).to(self.device), meta

    def _apply_flat(self, flat: torch.Tensor, meta: tuple, diffs: bool):
        self._ensure_actor_hash_state()
        n = len(self.doc_ids)
        if not diffs:
            with metrics.trace("engine_resident_apply"):
                self._out = _scatter_and_apply(self.state, flat, meta,
                                               self.cap_fids)
            vals = hashes_to_numpy(self._out["hash"])[:n]
            self._adopt_full_hashes(vals)   # flush-time capture
            return vals
        prev = self._prev_for_diffs()
        # actor content hashes in the rank basis (every row is the same)
        actor_hashes = self.state["actor_hash"][0]
        with metrics.trace("engine_resident_apply"):
            out, survh, chg_fid, chg_elem = _scatter_apply_diff(
                self.state, flat, meta, actor_hashes, *prev, self.cap_fids)
        self._out = out
        # the baseline of the NEXT diff round stays on the device; it is
        # independent of _out, so hash-only rounds and add_docs in between
        # do not reset what the consumer saw
        self._diff_prev = (out["present"], out["win_value"],
                           out["win_actor"], survh, out["elem_visible"],
                           out["vis_rank"])
        # removed elements take their old index from the baseline's ranks
        prev_vis, prev_rank = prev[4:]
        docs, rows = _changed_rows(self.state, out, chg_fid, chg_elem,
                                   prev_vis, prev_rank, n)
        records = decode_round_diffs(self, docs, rows)
        vals = hashes_to_numpy(out["hash"])[:n]
        self._adopt_full_hashes(vals)   # flush-time capture
        return vals, records

    def _prev_for_diffs(self) -> tuple:
        """The diff baseline padded to the current capacities: present,
        win_value, win_actor, survivor hash [cap_docs, cap_fids];
        elem_visible, vis_rank [cap_docs, cap_lists, cap_elems]. Before the
        first diff round it is the empty state."""
        n, f = self.cap_docs, self.cap_fids
        lists = (n, self.cap_lists, self.cap_elems)
        fills = (False, -1, -1, 0, False, -1)
        shapes = ((n, f),) * 4 + (lists,) * 2
        if self._diff_prev is None:
            dev = self.device
            return tuple(
                torch.full(shape, fill, device=dev,
                           dtype=torch.bool if fill is False else torch.int32)
                for shape, fill in zip(shapes, fills))
        return tuple(_pad(t, shape, fill) for t, shape, fill in
                     zip(self._diff_prev, shapes, fills))

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

    @property
    def hashes_clean(self) -> bool:
        """True iff hashes() would serve entirely from the host mirror
        (no launch, no readback)."""
        n = len(self.doc_ids)
        return ((n == 0 or (self._hash_mirror is not None
                            and len(self._hash_mirror) >= n))
                and not any(i < n for i in self._doc_dirty))

    def _reconcile_partial(self, idxs: list[int]) -> None:
        """Reconcile ONLY the given docs: gather their rows out of the
        resident state, run the same reconcile on the narrow sub-batch, and
        put the hashes into the mirror. Device work is O(len(idxs)),
        independent of the fleet size."""
        with metrics.trace("engine_hashes"):
            self._ensure_actor_hash_state()
            k = len(idxs)
            # padded rows repeat the last dirty doc (any valid doc works;
            # the extra hashes are discarded below)
            sel = torch.tensor(idxs + [idxs[-1]] * (_pad_to(k, 8) - k),
                               dtype=torch.int64, device=self.device)
            sub = {name: t.index_select(0, sel)
                   for name, t in self.state.items()}
            out = apply_doc(sub, self.cap_fids)
            flightrec.record("engine_hash_readback", docs=k)
            with perfscope.phase("readback"):
                vals = hashes_to_numpy(out["hash"])
            self._ensure_hash_mirror()[np.asarray(idxs, np.int64)] = \
                vals[:k]
            self._doc_dirty.difference_update(idxs)

    def reconcile(self) -> np.ndarray:
        """Run the reconcile over the whole resident state; returns per-doc
        np.uint32 hashes aligned with doc_ids."""
        with metrics.trace("engine_hashes"):
            self._ensure_actor_hash_state()
            self._out = apply_doc(self.state, self.cap_fids)
            # breadcrumb before the readback barrier (see the rows engine)
            flightrec.record("engine_hash_readback",
                             docs=len(self.doc_ids))
            metrics.gauge("engine_resident_bytes", self.resident_bytes())
            with perfscope.phase("readback"):
                vals = hashes_to_numpy(self._out["hash"])[:len(self.doc_ids)]
            self._adopt_full_hashes(vals)
            return vals

    def resident_bytes(self) -> int:
        """Footprint of the docs-major resident state tensors (bytes)."""
        return sum(t.numel() * t.element_size() for t in self.state.values())

    def hashes(self) -> np.ndarray:
        """Per-doc state hashes, O(dirty) not O(fleet): served from the
        host hash mirror; only docs whose state changed since the last
        read are reconciled (a narrow sub-batch). A clean read launches
        nothing; a read after a fused apply reuses its hashes."""
        n = len(self.doc_ids)
        mirror = self._hash_mirror
        if mirror is not None and len(mirror) >= n \
                and not any(i < n for i in self._doc_dirty):
            return mirror[:n].copy()
        if self._out is not None:
            # flush-time hashes from the last fused apply cover every
            # doc: one readback, no reconcile
            with perfscope.phase("readback"):
                vals = hashes_to_numpy(self._out["hash"])[:n]
            self._adopt_full_hashes(vals)
            return vals.copy()
        dirty = sorted(i for i in self._doc_dirty if i < n)
        if self._hash_mirror is None or 2 * len(dirty) >= n:
            return self.reconcile().copy()
        self._reconcile_partial(dirty)
        return self._hash_mirror[:n].copy()

    def hashes_for(self, idxs) -> np.ndarray:
        """Hashes for a subset of docs (indices into doc_ids) WITHOUT
        reconciling untouched docs: device work is O(requested & dirty).
        Returns np.uint32 hashes aligned with idxs."""
        idxs = [int(i) for i in idxs]
        if not idxs:
            return np.zeros(0, np.uint32)
        n = len(self.doc_ids)
        if self._out is not None and self._hash_mirror is None:
            return self.hashes()[np.asarray(idxs, np.int64)].copy()
        mirror = self._ensure_hash_mirror()
        want = set(idxs)
        dirty = sorted(i for i in self._doc_dirty if i < n and i in want)
        if dirty:
            if self._out is not None:
                with perfscope.phase("readback"):
                    self._adopt_full_hashes(
                        hashes_to_numpy(self._out["hash"]))
            else:
                self._reconcile_partial(dirty)
        return mirror[np.asarray(idxs, np.int64)].copy()

    def materialize(self, doc_id: str) -> Any:
        """Decode one document from resident state + reconcile outputs
        ({"data", "conflicts"}, as batchdoc.decode_doc)."""
        from .batchdoc import decode_doc

        if self._out is None:
            self.reconcile()
        i = self.doc_index[doc_id]
        t = self.tables[i]
        out = {k: v[i].cpu().numpy() for k, v in self._out.items()}
        host = {k: self.state[k][i].cpu().numpy()
                for k in ("fid", "actor", "value", "ins_fid", "list_obj")}
        return decode_doc(_ResidentEncoding(host, self.actors, t), out)


class _ResidentEncoding:
    """The DocEncoding fields decode_doc reads, from one document's
    resident columns and its arrival-ordered host tables."""

    def __init__(self, host: dict, actors: list[str], t: DocTables):
        self.fid = host["fid"]
        self.actor = host["actor"]
        self.value = host["value"]
        self.ins_fid = host["ins_fid"]
        self.list_obj = host["list_obj"]
        self.actors = actors
        self.objects = t.objects
        self.fields = t.fields
        self.value_table = ValueTable(values=t.value_list)


# ---------------------------------------------------------------------------
# device-side state updates

def _dtype_of(name: str) -> torch.dtype:
    return torch.bool if name in ("op_mask", "ins_mask") else torch.int32


def _pad(t: torch.Tensor, shape: tuple, fill) -> torch.Tensor:
    """t grown to `shape` (every axis at least as long), new cells `fill`."""
    if tuple(t.shape) == tuple(shape):
        return t
    out = torch.full(shape, fill, dtype=t.dtype, device=t.device)
    out[tuple(slice(0, k) for k in t.shape)] = t
    return out


def _unpack_delta(flat: torch.Tensor, meta: tuple) -> list[torch.Tensor]:
    parts = []
    offset = 0
    for shape, size in meta:
        parts.append(flat[offset:offset + size].view(shape))
        offset += size
    return parts


def _scatter_delta(state: dict, flat: torch.Tensor, meta: tuple) -> None:
    """Scatter a stacked delta into `state` in place. Rows past each doc's
    delta count are masked out before the index_put_: none of them ever
    indexes (the reference parks them one past the end and drops them)."""
    (d_ops, d_ops_n, off_ops, d_clock, d_ch_n, off_ch,
     d_ins, d_ins_n, d_nl, d_nl_n) = _unpack_delta(flat, meta)
    dev = flat.device

    def rows(n_valid, width):
        """(doc index, row index) of the valid rows of a [n, width]
        delta block, and their mask."""
        j = torch.arange(width, device=dev)[None, :]
        valid = j < n_valid[:, None]
        docs = torch.arange(valid.shape[0], device=dev)[:, None].expand_as(
            valid)
        return docs[valid], j.expand_as(valid)[valid], valid

    # op rows at per-doc offsets
    dv, jv, valid = rows(d_ops_n, d_ops.shape[1])
    pos = off_ops.long()[dv] + jv
    for ci, name in enumerate(OP_COLS[1:]):
        state[name].index_put_((dv, pos), d_ops[:, :, ci][valid])
    state["op_mask"].index_put_((dv, pos), torch.ones_like(dv, dtype=torch.bool))

    # clock rows at per-doc offsets
    dv, jv, valid = rows(d_ch_n, d_clock.shape[1])
    state["clock"].index_put_((dv, off_ch.long()[dv] + jv), d_clock[valid])

    # ins rows at explicit (list_row, slot)
    dv, _, valid = rows(d_ins_n, d_ins.shape[1])
    ins = d_ins[valid]
    li, si = ins[:, 0].long(), ins[:, 1].long()
    for ci, name in ((2, "ins_elem"), (3, "ins_actor"), (4, "ins_parent"),
                     (5, "ins_fid")):
        state[name].index_put_((dv, li, si), ins[:, ci])
    state["ins_mask"].index_put_((dv, li, si),
                                 torch.ones_like(dv, dtype=torch.bool))

    # new list rows
    dv, _, valid = rows(d_nl_n, d_nl.shape[1])
    nl = d_nl[valid]
    state["list_obj"].index_put_((dv, nl[:, 0].long()), nl[:, 1])
    state["list_obj_hash"].index_put_((dv, nl[:, 0].long()), nl[:, 2])


def _scatter_and_apply(state: dict, flat: torch.Tensor, meta: tuple,
                       max_fids: int) -> dict:
    """Delta scatter (in place; the reference donated its buffers to the
    jitted function instead) + full reconcile. Returns apply_doc's
    outputs."""
    _scatter_delta(state, flat, meta)
    return apply_doc(state, max_fids)


def _fid_survivor_hash(state: dict, out: dict, max_fids: int,
                       actor_hashes: torch.Tensor) -> torch.Tensor:
    """Order-independent per-field hash of the surviving (actor, value)
    pairs, [D, max_fids] int32 holding the uint32 bits: the sum over a
    field's candidates of mix4(ah, value_hash, ah ^ 0x5BF0, value_hash),
    wrapping. It changes whenever a field's conflict set changes, even
    when its winner does not (op_set.js:95-103). Actors mix by CONTENT hash
    (actor_hashes[rank]), so a rank remap leaves it alone. The sum runs in
    int64 and is taken mod 2**32, the same bits in any order on any
    device."""
    ah = actor_hashes[state["actor"].clamp(0, actor_hashes.shape[0] - 1)
                      .long()]
    vh = state["value_hash"]
    contrib = torch.where(out["candidate"], _mix4(ah, vh, ah ^ 0x5BF0, vh), 0)
    seg = state["fid"].clamp(0, max_fids - 1).long()
    acc = torch.zeros((seg.shape[0], max_fids), dtype=torch.int64,
                      device=seg.device)
    return _int32_bits(acc.scatter_add_(1, seg, contrib))


def _scatter_apply_diff(state: dict, flat: torch.Tensor, meta: tuple,
                        actor_hashes: torch.Tensor, prev_present,
                        prev_win_value, prev_win_actor, prev_survh, prev_vis,
                        prev_rank, max_fids: int):
    """_scatter_and_apply plus the change masks against the diff baseline.
    chg_fid [D, F]: a field's presence, winner value, winner actor or
    survivor hash moved. chg_elem [D, L, E]: an element's visibility or
    rank moved, or its field changed. Returns (out, survh, chg_fid,
    chg_elem), all on the state's device."""
    out = _scatter_and_apply(state, flat, meta, max_fids)
    survh = _fid_survivor_hash(state, out, max_fids, actor_hashes)
    chg_fid = ((out["present"] != prev_present)
               | (out["win_value"] != prev_win_value)
               | (out["win_actor"] != prev_win_actor)
               | (survh != prev_survh))
    ins_fid = state["ins_fid"]
    d = ins_fid.shape[0]
    field_moved = torch.gather(
        chg_fid, 1, ins_fid.clamp(0, max_fids - 1).reshape(d, -1).long()
    ).reshape(ins_fid.shape)
    chg_elem = ((out["elem_visible"] != prev_vis)
                | (out["vis_rank"] != prev_rank)
                | (field_moved & (ins_fid >= 0)))
    return out, survh, chg_fid, chg_elem


def _changed_rows(state: dict, out: dict, chg_fid, chg_elem, prev_vis,
                  prev_rank, n_docs: int):
    """The rows `diffs.decode_round_diffs` reads, for the documents among
    the first n_docs with a changed field or element: (docs, {name: numpy
    array [k, ...]}). The documents are found on the device; their rows
    are gathered there and cross to the host in one copy."""
    changed = chg_fid[:n_docs].any(1) | chg_elem[:n_docs].flatten(1).any(1)
    docs = changed.nonzero().flatten()
    src = {"chg_fid": chg_fid, "chg_elem": chg_elem, "prev_vis": prev_vis,
           "prev_rank": prev_rank}
    src.update((k, out[k]) for k in ("present", "win_value", "win_actor",
                                     "candidate", "elem_visible", "vis_rank"))
    src.update((k, state[k]) for k in ("fid", "actor", "value", "ins_fid",
                                       "list_obj"))
    picked = [src[name].index_select(0, docs) for name in DIFF_ROWS]
    flat = torch.cat([p.flatten(1).to(torch.int32) for p in picked],
                     1).cpu().numpy()
    rows, at = {}, 0
    for name, p in zip(DIFF_ROWS, picked):
        w = int(np.prod(p.shape[1:]))
        part = flat[:, at:at + w].reshape(p.shape)
        rows[name] = part.astype(bool) if p.dtype == torch.bool else part
        at += w
    return docs.cpu().numpy(), rows
