"""Device-resident DocSet state in the fused reconcile kernel's docs-minor
row layout (counterpart of `automerge_tpu/engine/resident_rows.py`, main
path).

State is one int32 [ROWS, n_pad] buffer, the layout `cuda_kernels.
reconcile_rows_hash` reads natively. The host keeps an authoritative numpy
mirror (`rows_host`); the device copy (`rows_dev`, a torch tensor on
`self.device`) takes each round's delta as a point scatter and then one
kernel launch. Structural events (capacity growth, new actors) rebuild the
host mirror and re-upload it once.

Causal admission, interning and LWW actor ranking are the host machinery of
`resident.ResidentDocSet`. List order is kept on the host by the native RGA
linearizer (`native.linearize.linearize_host`) and shipped as position rows.

Ingress, on a native instance (the default):
- `apply_round_frames`: AMR1 round frames (`sync.frames`), the streaming
  service's path. A micro-batch whose every change extends its doc's
  same-actor in-order chain is admitted by one vectorized pass over the
  frame columns against a dense clock/frontier cache and encoded by ONE
  native call (`_encode_rounds_batched`, counted in
  the `rows_rounds_batched` counter); otherwise each round is admitted per
  doc, fast docs vectorized and the rest through `_admit`
  (`_encode_round_frame`, counted in `rows_rounds_fallback`).
  The micro-batch is applied with one scatter and one kernel launch, and
  the device hash tensor is returned unread; with `lazy_dispatch` set the
  device work waits for the next hash read. A device copy left stale
  (growth, a failed dispatch, lazy rounds) is replaced by the post-batch
  host mirror, which already holds the batch, and nothing is scattered.
- The megabatch route (`dispatch.plan_round` / `apply_round_adaptive`;
  at least `AMTPU_MEGABATCH_MIN_DOCS` dirty documents, default 2;
  `AMTPU_MEGABATCH=0` turns it off): the dirty lanes reconciled in a few
  launches at smaller bucket dims and read back into the host hash
  mirror. The card's cost model picks it; the hashes are the same bit
  for bit. Two callers plan it:
  - an eager frame micro-batch (the reference's frame intent), priced
    against the classic dispatch above (one reconcile of the whole
    buffer and its readback). The device copy is brought up to date
    first on both routes (the triplets scattered, or a stale copy
    re-uploaded) and stays resident: the buckets are gathered from it,
    the post-batch hashes come back from the mirror, and the next
    hashes() launches nothing. On the card the classic dispatch wins
    the map storm's rounds up to a 2.07 GB buffer (PERF.md);
  - a minority-dirty hash read (`hashes_for`, or `hashes()` after lazy
    rounds), priced against the narrow gather, its buckets gathered from
    the device copy or, where that is stale, from the host mirror.
- `apply_rounds_cols` ({doc_id: WireColumns} rounds) and `apply_rounds`
  (Change rounds, converted to columns): one native encode per round and
  a scatter + launch per round, the hashes read back.
With `native=False` every route runs the pure-Python encoder.

Durability (a long-lived document on a bounded row buffer):
- `compact(floors, pins)` (`engine/compaction.py`, host numpy over the
  mirror) reclaims dominated op slots and below-floor tombstoned element
  slots, preserving every hash; the docs whose slots moved re-read through
  the kernel, and the device copy re-uploads from the compacted mirror.
  A reclaimed element's id goes to `ghost_eids`, and an insert anchored at
  one is rejected before admission (`CompactionAnchorError`) by every
  ingress route. The sync service's rule on `RowsBudgetError`: compact to
  the floors and retry the round once.
- `archive_log_prefix(doc, floor)` moves the causally-stable prefix of a
  doc's change log into `log_archive` (`sync/logarchive.LogArchive`),
  advancing `log_horizon`.
- `seed_clock(doc, clock, heads)` raises a snapshot-booted doc's clock to
  the image's covered clock (`sync/snapshots.py`); post-seed clock rows
  clamp to it (`resident.DocTables.snap_floor`).
- A failure after part of a batch was admitted rebuilds the whole
  instance from its log (`_rebuild_from_log`: the archived prefix, or the
  snapshot image, then the RAM log and the queues; replayed in chunks with
  compaction between them when the history exceeds the envelope) on the
  instance's own device, and raises `DeviceDispatchError(
  admission_complete=False)`. The instance is poisoned only when the
  rebuild itself fails or a failure happens inside a rebuild.

Telemetry, as in the reference: `metrics.trace` spans around a round
frame's apply (`rows_round_apply`) and a hash read (`rows_hashes`), the
admission routes counted as `rows_rounds_batched` / `rows_rounds_fallback`,
a `rows_hash_readback` flight-recorder event before
each readback, the `pack` and `readback` phases (`utils/perfscope.py`),
and every launch inside a `dispatchledger.call_scope`.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..core.ids import HEAD
from ..native.delta import frame_bytes_of
from ..native.linearize import linearize_host
from ..native.wire import changes_to_columns
from ..storage import _ACTION_IDX
from ..sync.frames import RoundColumns, decode_round_frame
from ..utils import flightrec, metrics, perfscope
from ..utils.gcpause import gc_paused
from . import compaction
from . import dispatch as round_dispatch
from . import dispatchledger
from .cuda_kernels import hashes_to_numpy, reconcile_rows_hash
from .encode import A_DEL, A_SET, _pad_to
from .pack import pad_to_lanes, row_bases, rows_dims_eligible
from .resident import AdmittedRef, ResidentDocSet, _Pending



class DeviceDispatchError(RuntimeError):
    """The device dispatch of an already-admitted batch failed, or the
    admission failed partway and the instance was rebuilt from its log.

    ``admission_complete`` True (the dispatch guard): host truth
    (change_log, per-doc clocks, and the rows_host mirror, all updated
    BEFORE the dispatch) is consistent and every change of the batch was
    admitted, queued, or dropped as a duplicate; only the device buffer is
    suspect, and the engine has marked itself dirty so the next dispatch
    re-uploads the mirror. Nothing to retry. False (a mid-admission
    rebuild): the unprocessed suffix of the batch is in neither the rebuilt
    log nor the queue; the caller replays the batch, and the (actor, seq)
    admission dedup drops the already-admitted prefix."""

    def __init__(self, msg: str, *, admission_complete: bool = False):
        super().__init__(msg)
        self.admission_complete = admission_complete


class RowsBudgetError(RuntimeError):
    """The batch would grow the resident rows state past the kernel's dims
    envelope (pack.rows_dims_eligible). Recoverable: the instance is
    untouched. Compact the long-lived docs (`compact`) and retry, or shard
    the DocSet."""


def _budget_error(cap_ops: int, actors: int,
                  elem_slots: int) -> RowsBudgetError:
    return RowsBudgetError(
        f"this batch could grow the resident rows state past the "
        f"megakernel dims envelope (ops<={cap_ops}, actors={actors}, "
        f"elem slots<={elem_slots}); compact the long-lived docs "
        f"(ResidentRowsDocSet.compact) or shard this DocSet across more "
        f"rows instances")


class CompactionAnchorError(RuntimeError):
    """An ingress inserts after an element that compaction reclaimed. The
    clock floor guarantees every known peer saw that element's tombstone,
    so a conforming frontend never emits this anchor; the sender is below
    the compaction horizon (it needs a full resync) or nonconforming.
    Raised BEFORE admission: the instance is untouched. `doc_id` names the
    offending doc, whose round the sync service drops."""

    def __init__(self, msg: str, *, doc_id: str | None = None):
        super().__init__(msg)
        self.doc_id = doc_id


def _anchor_error(anchor: str, doc_id: str) -> CompactionAnchorError:
    return CompactionAnchorError(
        f"insert anchored at compacted element {anchor!r} in doc "
        f"{doc_id!r}; the sender is below the compaction horizon — full "
        f"resync required", doc_id=doc_id)


class ResidentRowsDocSet(ResidentDocSet):
    """Resident DocSet whose device state IS the kernel's row buffer.

    `device` is where the buffer lives and the kernel runs: "cuda" (the
    default) needs a GPU and raises without one; "cpu" runs the kernel's
    plain PyTorch version. `native` picks the delta encoder, as in
    `ResidentDocSet`."""

    def __init__(self, doc_ids, actors: list[str] = (),  # noqa: B006
                 device: str | torch.device = "cuda", native: bool = True):
        super().__init__(doc_ids, device=device, native=native)
        self.n_pad = pad_to_lanes(max(len(self.doc_ids), 1))
        # per-doc: list_row -> [(slot, elem, arank, parent), ...]. `parent`
        # is the ENTRY INDEX of the anchor in the same list's entries.
        # Before any compaction it equals the anchor's slot (slots assign
        # densely in arrival order); after one, ghost entries (slot -1)
        # keep their RGA ordering key here while their band slot is freed,
        # so only entry indices stay stable. ins_idx maps slot -> entry
        # index per list, for appends.
        self.ins_log: list[dict[int, list[tuple]]] = [
            {} for _ in self.doc_ids]
        self.ins_idx: list[dict[int, dict[int, int]]] = [
            {} for _ in self.doc_ids]
        # per-doc: list_row -> owning-object content hash
        self.list_hash: list[dict[int, int]] = [{} for _ in self.doc_ids]
        # per-doc: list_row -> object interning index (compaction addresses
        # the encoders' per-object element-slot maps with it)
        self.list_obj: list[dict[int, int]] = [{} for _ in self.doc_ids]
        # per-doc: ids of elements compaction reclaimed; an insert anchored
        # at one is rejected before admission (CompactionAnchorError)
        self.ghost_eids: list[set] = [set() for _ in self.doc_ids]
        # last compaction floor per doc_id (a rebuild from the log
        # re-compacts with these, so a long-lived doc fits again)
        self.compaction_floors: dict[str, dict[str, int]] = {}
        # per-doc admitted change log
        self.change_log: list[list] = [[] for _ in self.doc_ids]
        # log-horizon layer: per-doc clock below which the admitted prefix
        # was moved to log_archive (sync/logarchive.LogArchive); the RAM
        # change_log holds only the tail above it. {} = no horizon.
        self.log_horizon: list[dict] = [{} for _ in self.doc_ids]
        self.log_archive = None
        # sync/snapshots.SnapshotStore: a rebuild replays a snapshot-booted
        # doc from its image when the archive does not hold its prefix
        self.snapshot_store = None
        # bumped by each _rebuild_from_log (which restores the archived
        # prefix into the RAM log, so log lengths stop comparing)
        self._rebuild_gen = 0
        # True while this instance is a rebuild's replay target
        self._rebuilding = False
        if actors:
            # pre-registering the expected actor set avoids a remap and
            # re-upload when they first appear in deltas
            self.actors = sorted(actors)
            self.actor_rank = {a: i for i, a in enumerate(self.actors)}
            if len(self.actors) > self.cap_actors:
                self.cap_actors = _pad_to(len(self.actors), 2)
        self._alloc_rows()
        self.rows_dev: torch.Tensor | None = None
        self._dirty = True
        # device hashes of the last merged-batch apply, not yet read back
        self._hash_handle: torch.Tensor | None = None
        self._poisoned: str | None = None
        # True = apply_round_frames skips the device dispatch: the host
        # mirror is the complete post-round truth, and upload + reconcile
        # wait for the next hash read (which reconciles only the dirty
        # lanes)
        self.lazy_dispatch = False
        # dense admission cache of the vectorized round-frame path: per-doc
        # clock rows in rank basis and a single-head frontier summary
        # (size, head rank, head seq), rebuilt lazily from the DocTables
        # dicts for the docs in _cache_dirty
        self._clock_cache: np.ndarray | None = None
        self._fsize = None
        self._hrank = None
        self._hseq = None
        self._cache_dirty = set(range(len(self.doc_ids)))
        # True once a vectorized admission left some table stale
        self._stale_tables = False

    # ------------------------------------------------------------------
    # row layout

    def _bases(self):
        return row_bases(self.cap_ops, self.cap_actors,
                         self.cap_lists * self.cap_elems)

    def dims(self) -> tuple:
        return (self.cap_ops, self.cap_actors,
                self.cap_lists * self.cap_elems, int(A_SET), int(A_DEL))

    def _alloc_rows(self):
        b = self._bases()
        self.rows_host = np.zeros((b["rows"], self.n_pad), dtype=np.int32)
        self.rows_host[b["ac"]:b["ac"] + self.cap_ops] = -1
        self.rows_host[b["fid"]:b["fid"] + self.cap_ops] = -1
        le = self.cap_lists * self.cap_elems
        self.rows_host[b["if"]:b["if"] + le] = -1
        self.rows_host[b["io"]:b["io"] + le] = -1
        # elem_list is a static pattern (owning-list row per slot) shared by
        # every doc; it never needs scattering
        self.rows_host[b["il"]:b["il"] + le] = np.repeat(
            np.arange(self.cap_lists, dtype=np.int32),
            self.cap_elems)[:, None]
        self._refill_actor_hash_band()

    def _refill_actor_hash_band(self) -> None:
        """Rewrite the ah band (rank -> actor CONTENT hash, the same for
        every doc column) from the current actor table."""
        b = self._bases()
        self.rows_host[b["ah"]:b["ah"] + self.cap_actors] = \
            self._actor_hash_values()[:, None]

    # the docs-major device state of the base class is never built
    def _alloc(self):
        self.state = {}

    def add_docs(self, new_ids: list[str]) -> list[str]:
        """Grow the document (lane) axis of the rows mirror. Padded lanes
        are valid empty documents."""
        old_cap_docs = self.cap_docs
        fresh = super().add_docs(new_ids)
        if self._clock_cache is not None and self.cap_docs > old_cap_docs:
            # fresh lanes are valid empty docs (zero clock, no frontier):
            # grow the cache rather than rebuild it for every doc
            k = self.cap_docs - old_cap_docs
            self._clock_cache = np.pad(self._clock_cache, ((0, k), (0, 0)))
            self._fsize = np.pad(self._fsize, (0, k))
            self._hrank = np.pad(self._hrank, (0, k), constant_values=-1)
            self._hseq = np.pad(self._hseq, (0, k))
        for _ in fresh:
            self.ins_log.append({})
            self.ins_idx.append({})
            self.list_hash.append({})
            self.list_obj.append({})
            self.ghost_eids.append(set())
            self.change_log.append([])
            self.log_horizon.append({})
        new_pad = pad_to_lanes(len(self.doc_ids))
        if new_pad > self.n_pad:
            b = self._bases()
            grown = np.zeros((b["rows"], new_pad), np.int32)
            grown[:, :self.n_pad] = self.rows_host
            cols = slice(self.n_pad, new_pad)
            I = self.cap_ops
            le = self.cap_lists * self.cap_elems
            for g in ("ac", "fid"):
                grown[b[g]:b[g] + I, cols] = -1
            for g in ("if", "io"):
                grown[b[g]:b[g] + le, cols] = -1
            grown[b["il"]:b["il"] + le, cols] = np.repeat(
                np.arange(self.cap_lists, dtype=np.int32),
                self.cap_elems)[:, None]
            self.rows_host = grown
            self.n_pad = new_pad
            self._refill_actor_hash_band()
            self.rows_dev = None
            self._dirty = True
        return fresh

    def _grow(self, **caps):
        """Re-layout the host mirror for new capacities; the device copy
        re-uploads at the next dispatch."""
        old_b = self._bases()
        old = self.rows_host
        I0, A0 = self.cap_ops, self.cap_actors
        L0, E0 = self.cap_lists, self.cap_elems
        super()._grow(**caps)
        b = self._bases()
        self._alloc_rows()
        new = self.rows_host
        for g in ("om", "ac", "fid", "act", "seq", "chg", "fh", "vh"):
            new[b[g]:b[g] + I0] = old[old_b[g]:old_b[g] + I0]
        # clock_op bands re-stride from (A0, I0) to (A, I)
        co = old[old_b["co"]:old_b["co"] + A0 * I0].reshape(A0, I0, -1)
        new[b["co"]:b["co"] + self.cap_actors * self.cap_ops] \
            .reshape(self.cap_actors, self.cap_ops, -1)[:A0, :I0] = co
        for g in ("im", "if", "ip", "io"):
            src = old[old_b[g]:old_b[g] + L0 * E0].reshape(L0, E0, -1)
            new[b[g]:b[g] + self.cap_lists * self.cap_elems] \
                .reshape(self.cap_lists, self.cap_elems, -1)[:L0, :E0] = src
        # il and ah were re-filled by _alloc_rows for the new layout
        self._dirty = True

    def _remap_actors(self, perm: np.ndarray) -> None:
        """Host-mirror remap after a registration: act rows through perm,
        clock_op bands re-gathered, ins_log ranks followed, and the ah band
        re-filled. The device copy re-uploads in every case, the first
        registration included: the ah band changed under it."""
        if len(perm):
            b = self._bases()
            I, A = self.cap_ops, self.cap_actors
            act = self.rows_host[b["act"]:b["act"] + I]
            om = self.rows_host[b["om"]:b["om"] + I]
            safe = np.clip(act, 0, len(perm) - 1)
            self.rows_host[b["act"]:b["act"] + I] = np.where(
                om > 0, perm[safe], act)
            co = self.rows_host[b["co"]:b["co"] + A * I].reshape(A, I, -1)
            remapped = np.zeros_like(co)
            for old_rank, new_rank in enumerate(perm):
                remapped[new_rank] = co[old_rank]
            self.rows_host[b["co"]:b["co"] + A * I] = \
                remapped.reshape(A * I, -1)
            for log in self.ins_log:
                for lrow, entries in log.items():
                    log[lrow] = [(s, e, int(perm[a]) if a < len(perm) else a,
                                  p) for (s, e, a, p) in entries]
        self._refill_actor_hash_band()
        self._dirty = True

    # ------------------------------------------------------------------
    # the dense admission cache and its lazy tables

    class _StaleView:
        """Read-through guard left in place of a fast-path-stale table's
        clock/frontier dict: any read materializes the real dicts first
        (_sync_stale_table), so no reader sees stale values, and a write
        through it fails (no __setitem__)."""

        __slots__ = ("_owner", "_t", "_attr")

        def __init__(self, owner, t, attr):
            self._owner = owner
            self._t = t
            self._attr = attr

        def _m(self) -> dict:
            self._owner._sync_stale_table(self._t)
            real = getattr(self._t, self._attr)
            if real is self:
                raise RuntimeError("stale table could not materialize")
            return real

        def get(self, k, d=None):
            return self._m().get(k, d)

        def __getitem__(self, k):
            return self._m()[k]

        def __contains__(self, k):
            return k in self._m()

        def __iter__(self):
            return iter(self._m())

        def __len__(self):
            return len(self._m())

        def __eq__(self, other):
            return self._m() == other

        def __bool__(self):
            return bool(self._m())

        def items(self):
            return self._m().items()

        def keys(self):
            return self._m().keys()

        def values(self):
            return self._m().values()

        def __repr__(self):
            return repr(self._m())

    def _mirror_stats(self, bd, docs) -> None:
        """Mirror the native encoder's per-doc list/elem stats into the
        host tables (the batched and the per-round encode share it)."""
        touched = np.unique(docs)
        if len(touched) and len(bd.stats):
            sub = bd.stats[touched[touched < len(bd.stats)]]
            if len(sub):
                self._lists_hi = max(self._lists_hi, int(sub[:, 0].max()))
                self._elems_hi = max(self._elems_hi, int(sub[:, 1].max()))
        for i in touched:
            if i < len(bd.stats):
                t = self.tables[i]
                t.n_lists = int(bd.stats[i, 0])
                t.max_elems = int(bd.stats[i, 1])

    def _queued_mask(self) -> np.ndarray | None:
        """Boolean [cap_docs] mask of docs with queued changes, or None."""
        if not self._queued_docs:
            return None
        qf = np.zeros(self.cap_docs, bool)
        qf[np.fromiter(self._queued_docs, np.int64,
                       len(self._queued_docs))] = True
        return qf

    def sync_tables(self) -> None:
        """Materialize every fast-path-stale table's clock/frontier dicts
        from the dense cache. The vectorized admission leaves the dicts
        stale (the cache is the authority); internal readers sync per
        table on touch, and an external reader of `tables[i].clock` or
        `.frontier` calls this first."""
        if self._stale_tables:
            for t in self.tables:
                self._sync_stale_table(t)
            self._stale_tables = False

    def _sync_stale_table(self, t) -> None:
        """Materialize one fast-path-stale table's clock/frontier dicts from
        the dense cache. Runs before any dict reader touches the table:
        the slow-path _admit, the cache rebuild, an actor remap."""
        i = t._stale_idx
        if i is None:
            return
        cc = self._clock_cache
        if cc is None:
            # every site that drops the cache materializes stale tables
            # first (_register_actor_names, _refresh_admission_cache)
            raise RuntimeError("stale table with no clock cache")
        actors = self.actors
        t.clock = {actors[r]: int(v)
                   for r, v in enumerate(cc[i].tolist())
                   if v and r < len(actors)}
        if self._fsize[i] == 1 and self._hrank[i] >= 0:
            t.frontier = {actors[int(self._hrank[i])]: int(self._hseq[i])}
        elif isinstance(t.frontier, self._StaleView):
            raise RuntimeError("stale table frontier not single-head")
        t._stale_idx = None

    def _admit(self, t, incoming):
        self._sync_stale_table(t)
        return super()._admit(t, incoming)

    def _register_actor_names(self, names: set) -> None:
        """Before the rank basis changes: materialize the stale tables and
        the lazy dense clock memos (both in the OLD basis) and drop the
        cache, which rebuilds at its next use."""
        new = set(names) - set(self.actors)
        if not new:
            return
        self.sync_tables()
        old_actors = list(self.actors)
        for t in self.tables:
            for key, trans in t.state_clocks.items():
                if trans is not None and not isinstance(trans, dict):
                    arr, ridx = trans
                    t.state_clocks[key] = {
                        old_actors[r]: int(v)
                        for r, v in enumerate(arr[ridx])
                        if v and r < len(old_actors)}
        self._clock_cache = None
        self._cache_dirty = set(range(len(self.doc_ids)))
        super()._register_actor_names(new)

    def _refresh_admission_cache(self) -> None:
        """Rebuild the dense clock/frontier cache rows of stale docs. The
        DocTables dicts stay authoritative; the cache lets a round's
        admission checks run as a handful of numpy gathers."""
        D, A = self.cap_docs, self.cap_actors
        if self._clock_cache is None \
                or self._clock_cache.shape != (D, A):
            # a full rebuild reads every table's dicts: materialize the
            # fast-path-stale tables from the OLD cache before zeroing it
            self.sync_tables()
            self._clock_cache = np.zeros((D, A), np.int64)
            self._fsize = np.zeros(D, np.int64)
            self._hrank = np.full(D, -1, np.int64)
            self._hseq = np.zeros(D, np.int64)
            dirty = range(len(self.doc_ids))
        elif self._cache_dirty:
            dirty = self._cache_dirty
        else:
            return
        rank_of = self.actor_rank
        cc, fs, hr, hs = (self._clock_cache, self._fsize,
                          self._hrank, self._hseq)
        for i in dirty:
            t = self.tables[i]
            if t._stale_idx is not None:
                # stale AND dirtied: the dicts must be current before this
                # rebuild reads them
                self._sync_stale_table(t)
            row = cc[i]
            row[:] = 0
            for a, s in t.clock.items():
                row[rank_of[a]] = s
            f = t.frontier
            fs[i] = len(f)
            if len(f) == 1:
                (a, s), = f.items()
                hr[i] = rank_of[a]
                hs[i] = s
        self._cache_dirty = set()

    # ------------------------------------------------------------------
    # delta encoding to scatter triplets

    def _reserve_for(self, rounds) -> None:
        """Upper-bound capacity growth so row offsets stay fixed across the
        whole micro-batch. Counts submitted changes PLUS every change still
        in the per-doc causal queues (a delta can release them)."""
        need_ops = self.op_count.copy()
        n_elems = {}
        n_lists = {}

        def count(i, c):
            need_ops[i] += len(c.ops)
            for op in c.ops:
                if op.action == "ins":
                    n_elems[i] = n_elems.get(i, 0) + 1
                    if op.key in self.ghost_eids[i]:
                        raise _anchor_error(op.key, self.doc_ids[i])
                elif op.action in ("makeList", "makeText"):
                    n_lists[i] = n_lists.get(i, 0) + 1

        for i in sorted(self._queued_docs):
            for p in self.tables[i].queue:
                count(i, p.payload)
        for r in rounds:
            for doc_id, changes in r.items():
                i = self.doc_index[doc_id]
                for c in changes:
                    count(i, c)
        grow = {}
        if need_ops.max(initial=0) > self.cap_ops:
            grow["cap_ops"] = _pad_to(int(need_ops.max()))
        cur_elems = self._elems_hi
        add_elems = max(n_elems.values(), default=0)
        if cur_elems + add_elems > self.cap_elems:
            grow["cap_elems"] = _pad_to(cur_elems + add_elems)
        cur_lists = self._lists_hi
        add_lists = max(n_lists.values(), default=0)
        if cur_lists + add_lists > self.cap_lists:
            grow["cap_lists"] = _pad_to(cur_lists + add_lists, 1)
        # budget-check the PROSPECTIVE caps before _grow re-lays the buffer:
        # a rejected batch must leave the instance fully usable
        self._check_rows_budget(
            grow.get("cap_ops", self.cap_ops),
            grow.get("cap_lists", self.cap_lists)
            * grow.get("cap_elems", self.cap_elems))
        if grow:
            self._grow(**grow)

    def _check_rows_budget(self, cap_ops: int | None = None,
                           le: int | None = None) -> None:
        cap_ops = self.cap_ops if cap_ops is None else cap_ops
        le = self.cap_lists * self.cap_elems if le is None else le
        if not rows_dims_eligible(cap_ops, self.cap_actors, le):
            raise _budget_error(cap_ops, self.cap_actors, le)

    def _linearized_pos_rows(self, doc_idx: int, lrow: int):
        """Fresh RGA positions for one touched list from its ins log:
        (ip-band row indices, positions), both int64 arrays. Ghost entries
        (compacted-away tombstones, slot -1) take part in the linearization
        (they order their retained descendants) but ship no row; positions
        are rank-compressed over the slotted entries, so they stay dense in
        [0, cap_elems)."""
        entries = self.ins_log[doc_idx][lrow]
        n = len(entries)
        elem = np.fromiter((e for (_, e, _, _) in entries), np.int32, n)
        arank = np.fromiter((a for (_, _, a, _) in entries), np.int32, n)
        parent = np.fromiter((p for (_, _, _, p) in entries), np.int32, n)
        slots = np.fromiter((s for (s, _, _, _) in entries), np.int64, n)
        pos = np.asarray(
            linearize_host(np.ones(n, dtype=bool), elem, arank, parent),
            np.int64)
        slotted = slots >= 0
        if not slotted.all():
            k = int(slotted.sum())
            order = np.argsort(pos[slotted], kind="stable")
            dense = np.empty(k, np.int64)
            dense[order] = np.arange(k)
            pos, slots = dense, slots[slotted]
        rows = self._bases()["ip"] + lrow * self.cap_elems + slots
        return rows, pos

    def _log_insert(self, i: int, lrow: int, slot: int, elem: int,
                    arank: int, parent_slot: int) -> None:
        """Append one admitted insert to doc i's ins log, its parent slot
        resolved to the parent's entry index."""
        entries = self.ins_log[i].setdefault(lrow, [])
        s2i = self.ins_idx[i].setdefault(lrow, {})
        parent = (s2i.get(parent_slot, parent_slot)
                  if parent_slot >= 0 else -1)
        s2i[slot] = len(entries)
        entries.append((slot, elem, arank, parent))

    def _round_triplets(self, changes_by_doc) -> np.ndarray:
        """Encode one round into (P, 3) int32 scatter triplets
        (row, doc, value) and apply them to the host mirror."""
        b = self._bases()
        I, E = self.cap_ops, self.cap_elems
        rows, docs, vals = [], [], []

        def put(r, d, v):
            rows.append(r)
            docs.append(d)
            vals.append(int(v))

        for doc_id, changes in changes_by_doc.items():
            i = self.doc_index[doc_id]
            delta = self._encode_delta(i, changes)
            self.change_log[i].extend(delta.changes)
            s0 = int(self.op_count[i])
            c0 = int(self.change_count[i])
            for k, (code, fid, arank, seq, chg, _value, fh, vh) in enumerate(
                    delta.ops):
                s = s0 + k
                put(b["om"] + s, i, 1)
                put(b["ac"] + s, i, code)
                put(b["fid"] + s, i, fid)
                put(b["act"] + s, i, arank)
                put(b["seq"] + s, i, seq)
                put(b["chg"] + s, i, chg)
                put(b["fh"] + s, i, fh)
                put(b["vh"] + s, i, vh)
                # the op's own change-clock row, scattered into the
                # actor-major clock_op bands
                row = delta.clocks[chg - c0]
                for a in np.nonzero(row)[0]:
                    put(b["co"] + int(a) * I + s, i, row[a])
            for (lrow, oi, objhash) in delta.new_lists:
                self.list_hash[i][lrow] = objhash
                self.list_obj[i][lrow] = oi
            touched_lists = set()
            for (lrow, slot, elem, arank, parent_slot, fid) in delta.ins:
                self._log_insert(i, lrow, slot, elem, arank, parent_slot)
                le = lrow * E + slot
                put(b["im"] + le, i, 1)
                put(b["if"] + le, i, fid)
                put(b["io"] + le, i, self.list_hash[i][lrow])
                touched_lists.add(lrow)
            # re-linearize touched lists; ship fresh position rows
            for lrow in touched_lists:
                prow, pval = self._linearized_pos_rows(i, lrow)
                for r, v in zip(prow.tolist(), pval.tolist()):
                    put(r, i, v)
            self.op_count[i] += len(delta.ops)
            self.change_count[i] += len(delta.clocks)

        trips = np.stack([np.asarray(rows, np.int32),
                          np.asarray(docs, np.int32),
                          np.asarray(vals, np.int32)], axis=1) \
            if rows else np.zeros((0, 3), np.int32)
        self.rows_host[trips[:, 0], trips[:, 1]] = trips[:, 2]
        return trips

    # ------------------------------------------------------------------
    # failure contract: every apply runs
    #   precheck -> admission (change_log/clocks) -> mirror scatter
    #   (rows_host) -> device dispatch
    # and the guards keep the instance consistent at each boundary.

    @contextlib.contextmanager
    def _dispatch_guard(self):
        """Wrap the device dispatch and readback. Host truth is already
        complete when they run, so the recovery is: drop the device buffer,
        mark dirty so the next dispatch re-uploads the mirror, and raise
        the typed error (the admission SUCCEEDED and must not be
        replayed)."""
        try:
            yield
        except Exception as e:
            self.rows_dev = None
            self._dirty = True
            self._hash_handle = None
            metrics.bump("rows_dispatch_failed")
            raise DeviceDispatchError(str(e), admission_complete=True) from e

    @contextlib.contextmanager
    def _admission_guard(self):
        """Wrap admission + mirror scatter. A failure midway (encoder
        error, a grow's MemoryError) can leave change_log/clocks ahead of
        the rows mirror AND an unprocessed suffix of the batch in neither
        the log nor the queue. If anything was admitted, rebuild the
        instance from its log and raise DeviceDispatchError with
        admission_complete=False: the caller replays the whole batch, and
        the (actor, seq) dedup drops the admitted prefix. If nothing was
        admitted, the error propagates and the caller may retry. Inside a
        rebuild's replay the failure is deterministic: poison and raise."""
        log_lens = [len(log) for log in self.change_log]
        try:
            yield
        except DeviceDispatchError:
            raise  # the dispatch guard recovered; admission stands
        except Exception as e:
            if any(len(log) != n
                   for log, n in zip(self.change_log, log_lens)):
                if self._rebuilding:
                    self._poison(e)
                    raise
                metrics.bump("rows_log_rebuilt")
                self._rebuild_from_log()
                raise DeviceDispatchError(
                    str(e), admission_complete=False) from e
            raise

    def _poison(self, cause) -> None:
        self._poisoned = (f"resident row state no longer reflects the "
                          f"admitted change log ({cause!r}); rebuild the "
                          f"node from its durable log")
        metrics.bump("rows_engine_poisoned")

    def _check_poisoned(self) -> None:
        if self._poisoned:
            raise RuntimeError(self._poisoned)

    # ------------------------------------------------------------------
    # durability: the log horizon, snapshot seeding, rebuild from the log

    def archive_log_prefix(self, doc_id: str,
                           floor: dict[str, int]) -> int:
        """Move the causally-stable prefix of one doc's admitted log (every
        change with seq <= floor[actor]) out of RAM into log_archive,
        advancing log_horizon. The floor must be a causal-stability floor
        (compaction.causal_floor, lowered by peer clocks): such floors are
        transitive clocks, so the prefix is causally closed and archive-
        then-tail replay order is valid. Returns the number of changes
        archived (0 with no archive attached or nothing below the
        floor)."""
        if self.log_archive is None or not floor:
            return 0
        i = self.doc_index[doc_id]
        hz = self.log_horizon[i]
        if not any(s > hz.get(a, 0) for a, s in floor.items()):
            # the floor has not passed the horizon: nothing below it is
            # still in RAM, so skip the O(log) scan
            return 0
        keep, move = [], []
        for c in self.change_log[i]:
            (move if c.seq <= floor.get(c.actor, 0) else keep).append(c)
        if not move:
            return 0
        self.log_archive.append(
            doc_id, [c.change() if isinstance(c, AdmittedRef) else c
                     for c in move])
        self.change_log[i] = keep
        for a, s in floor.items():
            if s > hz.get(a, 0):
                hz[a] = int(s)
        metrics.bump("rows_horizon_truncated")
        return len(move)

    @staticmethod
    def _archive_covers_floor(archived, floor: dict[str, int]) -> bool:
        """True when the archived changes hold each floor actor's history
        FROM SEQ 1, i.e. the doc's full prefix and not just a post-boot
        tail (per-actor seqs are dense from 1 and archive_log_prefix moves
        contiguous prefixes, so min seq == 1 is the witness)."""
        if not floor:
            return True
        mins: dict[str, int] = {}
        for c in archived:
            if c.actor in floor and c.seq < mins.get(c.actor, 1 << 62):
                mins[c.actor] = c.seq
        return all(mins.get(a) == 1 for a in floor)

    def seed_clock(self, doc_id: str, clock: dict[str, int],
                   head_closures: dict | None = None) -> None:
        """Snapshot boot (sync/snapshots.py): after a doc's compacted,
        renumbered image admitted through the ordinary ingress, raise the
        doc's clock to the ORIGINAL covered clock, so the suffix admits
        with its original seqs and redeliveries below the clock drop.
        `head_closures` (per-actor transitive clocks of the covered heads,
        without their own coordinate) are memoized for causal_floor and
        later clock rows; `snap_floor` arms the post-seed clamp."""
        i = self.doc_index[doc_id]
        t = self.tables[i]
        self._sync_stale_table(t)
        self._register_actor_names(set(clock))
        heads = head_closures or {}
        for a, s in clock.items():
            if s > t.clock.get(a, 0):
                t.clock[a] = int(s)
            t.state_clocks[(a, int(s))] = dict(heads.get(a) or {})
        # frontier := the seeded heads no other head's closure covers
        t.frontier = {
            a: int(s) for a, s in clock.items()
            if not any(o != a and (heads.get(o) or {}).get(a, 0) >= s
                       for o in clock)}
        t.snap_floor = {a: int(s) for a, s in clock.items()}
        self._cache_dirty.add(i)
        metrics.bump("sync_bootstrap_docs")

    def _rebuild_from_log(self) -> None:
        """Reconstruct the whole instance from its admitted change log (the
        authoritative record) plus the causal queues' payloads, then adopt
        the fresh state in place, on this instance's device. A device
        failure during the rebuild leaves the fresh instance host-
        consistent and dirty (its dispatch guard), and the next read
        re-uploads. Any OTHER failure poisons the instance: serving reads
        would silently drop admitted changes.

        With a log horizon the RAM log is only the tail: the archived
        prefix is read back and replayed first (it is causally closed
        below the floor), or, for a snapshot-booted doc whose archive
        lacks the prefix, the snapshot image (re-seeded). The rebuilt
        instance holds the full log in RAM with an empty horizon; the
        archive's (actor, seq) read dedup makes a later re-archive
        harmless."""
        docs = list(self.doc_ids)
        round_: dict[str, list] = {}
        snap_replay: dict[str, object] = {}
        for i, d in enumerate(docs):
            chs = []
            snap_floor = self.tables[i].snap_floor
            if self.log_archive is not None and self.log_horizon[i]:
                archived = self.log_archive.read(d)
                if snap_floor and not self._archive_covers_floor(
                        archived, snap_floor):
                    # the archive holds only the post-boot tail; the
                    # prefix lives in the image
                    chs.extend(c for c in archived
                               if c.seq > snap_floor.get(c.actor, 0))
                else:
                    chs.extend(archived)
                    snap_floor = None   # the full prefix is on disk
            if snap_floor:
                img = (self.snapshot_store.load(d)
                       if self.snapshot_store is not None else None)
                if img is None:
                    e = RuntimeError(
                        f"rebuild of snapshot-booted doc {d!r}: no "
                        "archived prefix and no local snapshot image")
                    self._poison(e)
                    raise e
                snap_replay[d] = img
            chs.extend(c.change() if isinstance(c, AdmittedRef) else c
                       for c in self.change_log[i])
            for p in self.tables[i].queue:
                pay = p.payload
                chs.append(AdmittedRef(*pay).change()
                           if isinstance(pay, tuple) else pay)
            if chs:
                round_[d] = chs
        fresh = ResidentRowsDocSet(docs, actors=list(self.actors),
                                   device=self.device,
                                   native=self._native is not None)
        fresh.log_archive = self.log_archive
        fresh.snapshot_store = self.snapshot_store
        fresh.compaction_floors = dict(self.compaction_floors)
        fresh.lazy_dispatch = self.lazy_dispatch
        fresh._rebuilding = True
        try:
            for d, img in snap_replay.items():
                fresh.apply_rounds([{d: img.columns().to_changes()}])
                fresh.seed_clock(d, img.clock, img.heads)
                i2 = fresh.doc_index[d]
                # the image is the doc's below-horizon truth, not a
                # re-servable log prefix (its seqs are renumbered)
                fresh.change_log[i2] = []
                fresh.log_horizon[i2] = dict(img.clock)
            if round_:
                try:
                    fresh.apply_rounds([round_])
                except RowsBudgetError:
                    # a compacted long-lived doc's full log exceeds the
                    # envelope by design: replay in chunks
                    self._replay_chunked(fresh, round_)
        except DeviceDispatchError:
            pass
        except Exception as e:
            self._poison(e)
            raise
        fresh._rebuilding = False
        gen = self._rebuild_gen
        # the hash epoch stays monotonic across the rebuild: a holder of a
        # pre-rebuild epoch must see every later read as changed
        epoch = max(self.hash_epoch, fresh.hash_epoch) + 1
        self.__dict__.clear()
        self.__dict__.update(fresh.__dict__)
        self._rebuild_gen = gen + 1
        self.hash_epoch = epoch

    def _replay_chunked(self, fresh: "ResidentRowsDocSet", round_: dict,
                        chunk: int = 256) -> None:
        """Envelope-safe rebuild replay: admit the log in per-doc chunks,
        compacting to the last-known floors when a chunk does not fit, so
        the rebuilt rows converge to the compacted footprint the original
        carried. Anchors of the not-yet-replayed tail are pinned: the log
        legitimately inserts after elements whose tombstones are below
        the stored floor (they were ghosted only AFTER those inserts
        admitted in the original)."""
        pos = {d: 0 for d in round_}
        while True:
            part = {d: chs[pos[d]:pos[d] + chunk]
                    for d, chs in round_.items() if pos[d] < len(chs)}
            if not part:
                return
            try:
                fresh.apply_rounds([part])
            except RowsBudgetError:
                # a stored empty floor ({}) means "nothing reclaimable" and
                # is honored as is; only docs with NO stored floor fall
                # back to their own replayed clock
                floors = {d: (self.compaction_floors[d]
                              if d in self.compaction_floors
                              else dict(
                                  fresh.tables[fresh.doc_index[d]].clock))
                          for d in fresh.doc_ids}
                pins: dict[str, set] = {}
                for d, chs in round_.items():
                    p = {op.key for c in chs[pos[d]:] for op in c.ops
                         if op.action == "ins" and op.key
                         and op.key != HEAD}
                    if p:
                        pins[d] = p
                fresh.compact(floors, pins)
                fresh.apply_rounds([part])
            for d, chs in part.items():
                pos[d] += len(chs)

    def compact(self, floors: dict[str, dict[str, int]],
                pins: dict[str, set] | None = None) -> dict[str, dict]:
        """Causally-stable compaction (engine/compaction.py): reclaim
        dominated op slots and below-floor tombstoned element slots per doc,
        in place on the host mirror, preserving every hash. `floors` maps
        doc_id -> that doc's clock floor; `pins` maps doc_id -> anchor
        element ids of known-but-unadmitted changes that keep their slots.
        Returns per-doc reclaim stats. The device copy is dropped (the next
        dispatch uploads the compacted mirror), and every doc whose slots
        moved re-reads through the kernel at the next hash read, so the
        hash mirror cannot hide a compaction bug."""
        stats = compaction.compact(self, floors, pins)
        moved = [self.doc_index[d] for d, st in stats.items()
                 if d in self.doc_index
                 and (st["ops_after"] < st["ops_before"]
                      or st["elems_after"] < st["elems_before"])]
        if moved:
            self._mark_hash_dirty(moved)
        return stats

    def materialize(self, doc_id: str) -> dict:
        """Snapshot one document ({"data", "conflicts"}, as
        batchdoc.oracle_state) by replaying its admitted change log
        through the interpretive frontend on this instance's device (the
        cold path; the hot path is hash-only; the docs-major decode this
        class would otherwise inherit reads outputs the rows engine never
        builds).

        The log is the archived prefix (when a log horizon is set) and the
        RAM tail. A snapshot-booted doc whose archive lacks the prefix
        replays its snapshot image instead, with the tail (a post-boot
        archive folded in) rebased onto the image's renumbered history
        (snapshots.remap_tail)."""
        from .. import api
        from ..frontend.materialize import apply_changes_to_doc
        from .batchdoc import oracle_state

        i = self.doc_index[doc_id]
        changes: list = []
        arch_tail: list = []
        snap_floor = self.tables[i].snap_floor
        if self.log_archive is not None and self.log_horizon[i]:
            archived = self.log_archive.read(doc_id)
            if snap_floor and not self._archive_covers_floor(
                    archived, snap_floor):
                # archived after the boot: the archive is tail, not prefix
                arch_tail = [c for c in archived
                             if c.seq > snap_floor.get(c.actor, 0)]
            else:
                changes.extend(archived)
                snap_floor = None   # the full prefix is on disk
        tail = arch_tail + [c.change() if isinstance(c, AdmittedRef) else c
                            for c in self.change_log[i]]
        if snap_floor:
            from ..sync.snapshots import remap_tail
            img = (self.snapshot_store.load(doc_id)
                   if self.snapshot_store is not None else None)
            if img is None:
                raise RuntimeError(
                    f"cannot materialize snapshot-booted doc {doc_id!r}: "
                    "no archived prefix and no local snapshot image "
                    "(attach snapshot_dir so wire-received images are "
                    "retained)")
            changes = img.columns().to_changes()
            tail = remap_tail(tail, img.clock, img.kept_seqs)
        changes.extend(tail)
        doc = api.init("resident-view", self.device)
        doc = apply_changes_to_doc(doc, doc._doc.opset, changes,
                                   incremental=False, emit_diffs=False)
        return oracle_state(doc)

    # ------------------------------------------------------------------
    # device path

    def apply_rounds(self, rounds) -> np.ndarray:
        """Apply a micro-batch of sync rounds, reconciling after each.

        rounds: list of {doc_id: [Change]}, applied in order. Returns
        np.ndarray [len(rounds), n_docs] uint32 state hashes, one row per
        round.

        Actor ranks are those of the WHOLE micro-batch's actor universe (all
        rounds register before any is encoded), so the hash of an
        intermediate round is only comparable to hashes under the same final
        actor universe. The FINAL round's hash is the canonical post-batch
        hash.

        On a native instance the rounds are converted to columns and run
        through `apply_rounds_cols`.
        """
        self._check_poisoned()
        if self._native is not None:
            return self.apply_rounds_cols(
                [{d: changes_to_columns(chs) for d, chs in r.items()}
                 for r in rounds])
        for r in rounds:
            self._register_actors(r)
        self._reserve_for(rounds)
        with self._admission_guard():
            pre_rows = self.rows_host.copy() \
                if self._dirty or self.rows_dev is None else None
            trip_list = [self._round_triplets(r) for r in rounds]
            with self._dispatch_guard():
                return self._dispatch_rounds(trip_list, pre_rows)

    def apply_rounds_cols(self, rounds) -> np.ndarray:
        """`apply_rounds` for column rounds ({doc_id: WireColumns}, decoded
        wire frames): frame bytes -> native delta encoder -> vectorized
        triplet assembly -> a scatter and a launch per round. Admission and
        clock rows stay per-change Python. Same return value and actor
        universe as apply_rounds."""
        self._check_poisoned()
        if self._native is None:
            return self.apply_rounds(
                [{d: c.to_changes() for d, c in r.items()} for r in rounds])
        for r in rounds:
            self._register_actors_cols(r)
        # reject an oversized batch BEFORE admission mutates any state
        # (seen-sets, clocks, change logs, C++ tables)
        self._precheck_rows_budget_cols(rounds)
        with self._admission_guard():
            encoded = [self._native_encode_round(r) for r in rounds]
            self._grow_for_rounds(encoded)
            pre_rows = self.rows_host.copy() \
                if self._dirty or self.rows_dev is None else None
            trip_list = [self._cols_triplets(e) for e in encoded]
            with self._dispatch_guard():
                return self._dispatch_rounds(trip_list, pre_rows)

    def _to_dev(self, arr: np.ndarray) -> torch.Tensor:
        """A copy of a host array on this instance's device (never aliasing
        the host mirror, which the device copy is updated apart from)."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            self.device, copy=True)

    def _upload_trips(self, trip_list) -> list[torch.Tensor]:
        """Each round's triplets, de-duplicated on the host (last write
        wins, so the device scatter never sees a repeated (row, lane) key,
        whose outcome index_put_ leaves undefined), uploaded in one copy
        as int64 (index_put_'s index type)."""
        parts = [_last_wins(t, self.n_pad) for t in trip_list]
        flat = self._to_dev(np.concatenate(
            parts + [np.zeros((0, 3), np.int32)]).astype(np.int64))
        return list(torch.split(flat, [len(t) for t in parts]))

    def _mark_trips_dirty(self, trip_list) -> np.ndarray:
        """Hash invalidation for the lanes a batch touches, BEFORE the
        dispatch (a failed dispatch leaves host truth updated). Returns the
        touched doc indices, sorted (int64)."""
        touched = np.unique(np.concatenate(
            [t[:, 1] for t in trip_list] + [np.zeros(0, np.int32)])
            ).astype(np.int64)
        if len(touched):
            self._mark_hash_dirty(touched.tolist())
        return touched

    def _dispatch_rounds(self, trip_list, pre_rows) -> np.ndarray:
        n = len(self.doc_ids)
        touched = self._mark_trips_dirty(trip_list)
        if pre_rows is not None:
            self.rows_dev = self._to_dev(pre_rows)
            self._dirty = False
        p = max((len(t) for t in trip_list), default=1)
        with dispatchledger.call_scope(
                "rows_scan", backend="device", docs=len(touched),
                axes={"docs": (n, self.n_pad),
                      "rounds": (len(trip_list), len(trip_list)),
                      "trips": (p, p)}):
            self.rows_dev, hashes = metrics.dispatch_jit(
                "scan_rounds", _scan_rounds,
                self.rows_dev, self._upload_trips(trip_list), self.dims())
        self._hash_handle = None
        with perfscope.phase("readback"):
            vals = hashes_to_numpy(hashes)
        if len(trip_list):
            # the FINAL round's row is the canonical post-batch hash table:
            # adopt it so the next hashes() read is free
            self._adopt_full_hashes(vals[-1])
        return vals[:, :n]

    # ------------------------------------------------------------------
    # native column ingress

    def _check_ghost_anchors_cols(self, i: int, cols, op_lo: int,
                                  op_hi: int) -> None:
        """Reject ins ops anchored at compacted-away elements BEFORE
        admission (CompactionAnchorError)."""
        ghosts = self.ghost_eids[i]
        if not ghosts:
            return
        acts = np.asarray(cols.op_action[op_lo:op_hi])
        for j in np.nonzero(acts == _ACTION_IDX["ins"])[0].tolist():
            k = int(cols.op_key[op_lo + j])
            if k >= 0 and cols.keys[k] in ghosts:
                raise _anchor_error(cols.keys[k], self.doc_ids[i])

    def _precheck_rows_budget_cols(self, rounds) -> None:
        """Upper-bound budget check from the submitted columns plus the
        causal queues, BEFORE any admission runs, with the ghost-anchor
        reject. Conservative: duplicates and changes that stay queued
        count as applied; the exact check in _grow_for_rounds still runs
        after the encode. A doc's columns are counted in one numpy pass
        (the reference slices them change by change; the counts, and the
        first ghost anchor in op order, are the same)."""
        ins_idx = _ACTION_IDX["ins"]
        l1, l2 = _ACTION_IDX["makeList"], _ACTION_IDX["makeText"]

        need_ops = self.op_count.copy()
        n_elems = np.zeros(self.cap_docs, np.int64)
        n_lists = np.zeros(self.cap_docs, np.int64)

        def count(i, cols, j0, j1):
            o0, o1 = int(cols.op_off[j0]), int(cols.op_off[j1])
            need_ops[i] += o1 - o0
            acts = np.asarray(cols.op_action[o0:o1])
            n_elems[i] += int((acts == ins_idx).sum())
            n_lists[i] += int(((acts == l1) | (acts == l2)).sum())
            self._check_ghost_anchors_cols(i, cols, o0, o1)

        for i in sorted(self._queued_docs):
            for p in self.tables[i].queue:  # native payloads: (cols, j)
                cols, j = p.payload
                count(i, cols, j, j + 1)
        for r in rounds:
            for doc_id, cols in r.items():
                count(self.doc_index[doc_id], cols, 0, cols.n_changes)
        self._check_prospective_caps(need_ops, int(n_elems.max(initial=0)),
                                     int(n_lists.max(initial=0)))

    def _check_prospective_caps(self, need_ops: np.ndarray, add_elems: int,
                                add_lists: int) -> None:
        cap_ops = max(self.cap_ops, _pad_to(int(need_ops.max(initial=1))))
        cap_elems = max(self.cap_elems, _pad_to(self._elems_hi + add_elems))
        cap_lists = max(self.cap_lists,
                        _pad_to(self._lists_hi + add_lists, 1))
        if not rows_dims_eligible(cap_ops, self.cap_actors,
                                  cap_lists * cap_elems):
            raise _budget_error(cap_ops, self.cap_actors,
                                cap_lists * cap_elems)

    def _native_encode_round(self, cols_by_doc):
        """Causal admission (Python, per change) + ONE native encode for
        the round (`_native_ingest_round`). Returns the BatchDelta with the
        admission-aligned clock matrix, or None if nothing was admitted."""
        clock_rows = []

        def on_admitted(i, t, ready):
            self.change_log[i].extend(
                AdmittedRef(*p.payload) for p in ready)
            for p in ready:
                clock_rows.append(self._clock_row(t, p.actor, p.seq, p.deps))

        bd, adm_doc, cidxs = self._native_ingest_round(cols_by_doc,
                                                       on_admitted)
        if bd is None:
            return None
        return {"bd": bd, "clock_mat": np.stack(clock_rows),
                "adm_doc": np.asarray(adm_doc, np.int64),
                "adm_cidx": np.asarray(cidxs, np.int64)}

    def _grow_for_rounds(self, encoded) -> None:
        """Exact capacity growth from the encoded rounds (the native
        encoder reports which op, element and list slots each round
        fills)."""
        need_ops = self.op_count.copy()
        for enc in encoded:
            if enc is None:
                continue
            doc = enc["bd"].op_rows[:, 0]
            if len(doc):
                ids, cnts = np.unique(doc, return_counts=True)
                need_ops[ids] += cnts
        grow = {}
        if need_ops.max(initial=0) > self.cap_ops:
            grow["cap_ops"] = _pad_to(int(need_ops.max()))
        if self._lists_hi > self.cap_lists:
            grow["cap_lists"] = _pad_to(self._lists_hi, 1)
        if self._elems_hi > self.cap_elems:
            grow["cap_elems"] = _pad_to(self._elems_hi)
        self._check_rows_budget(
            grow.get("cap_ops", self.cap_ops),
            grow.get("cap_lists", self.cap_lists)
            * grow.get("cap_elems", self.cap_elems))
        if grow:
            self._grow(**grow)
        if self._changes_hi > self.cap_changes:
            self.cap_changes = _pad_to(self._changes_hi)

    def _cols_triplets(self, enc) -> np.ndarray:
        """Vectorized scatter-triplet assembly from one encoded round (the
        numpy counterpart of _round_triplets' per-op loop), applied to the
        host mirror."""
        if enc is None:
            return np.zeros((0, 3), np.int32)
        b = self._bases()
        I, E = self.cap_ops, self.cap_elems
        bd = enc["bd"]
        parts_r, parts_d, parts_v = [], [], []

        op = bd.op_rows.astype(np.int64)
        if len(op):
            doc = op[:, 0]
            # rows are doc-grouped in admission order: the index within a
            # group from each row's group start
            starts = np.searchsorted(doc, doc, side="left")
            slot = self.op_count[doc] + (np.arange(len(op)) - starts)
            for g, v in (("om", np.ones(len(op), np.int64)), ("ac", op[:, 1]),
                         ("fid", op[:, 2]), ("act", op[:, 3]),
                         ("seq", op[:, 4]), ("chg", op[:, 5]),
                         ("fh", op[:, 7]), ("vh", op[:, 8])):
                parts_r.append(b[g] + slot)
                parts_d.append(doc)
                parts_v.append(v)
            # each op's change-clock row into the actor-major clock_op
            # bands; (doc, cidx) keys ascend in both arrays, so the op ->
            # admitted-change join is one searchsorted
            key_adm = enc["adm_doc"] * (1 << 32) + enc["adm_cidx"]
            key_op = doc * (1 << 32) + op[:, 5]
            ai = np.searchsorted(key_adm, key_op)
            cmat = enc["clock_mat"][ai]                      # [k, A]
            oi, a = np.nonzero(cmat)
            parts_r.append(b["co"] + a * I + slot[oi])
            parts_d.append(doc[oi])
            parts_v.append(cmat[oi, a])
            ids, cnts = np.unique(doc, return_counts=True)
            self.op_count[ids] += cnts
        ids, cnts = np.unique(enc["adm_doc"], return_counts=True)
        self.change_count[ids] += cnts

        for (d, lrow, oi, objhash) in bd.newlist_rows.tolist():
            self.list_hash[d][lrow] = objhash
            self.list_obj[d][lrow] = oi

        ins = bd.ins_rows
        if len(ins):
            touched = set()
            ir, idd, iv = [], [], []
            for (d, lrow, slot_, elem, arank, parent_slot, fid) in \
                    ins.tolist():
                self._log_insert(d, lrow, slot_, elem, arank, parent_slot)
                le = lrow * E + slot_
                ir += [b["im"] + le, b["if"] + le, b["io"] + le]
                idd += [d, d, d]
                iv += [1, fid, self.list_hash[d][lrow]]
                touched.add((d, lrow))
            parts_r.append(np.asarray(ir, np.int64))
            parts_d.append(np.asarray(idd, np.int64))
            parts_v.append(np.asarray(iv, np.int64))
            for (d, lrow) in touched:
                prow, pval = self._linearized_pos_rows(d, lrow)
                parts_r.append(prow)
                parts_d.append(np.full(len(prow), d, np.int64))
                parts_v.append(pval)

        if not parts_r:
            return np.zeros((0, 3), np.int32)
        trips = np.stack([np.concatenate(parts_r),
                          np.concatenate(parts_d),
                          np.concatenate(parts_v)], axis=1).astype(np.int32)
        self.rows_host[trips[:, 0], trips[:, 1]] = trips[:, 2]
        return trips

    # ------------------------------------------------------------------
    # round-frame ingress: the streaming sync service's path

    def apply_round_frames(self, frames) -> torch.Tensor | None:
        """Apply a micro-batch of sync rounds shipped as round frames
        (sync/frames.py AMR1: one columnar frame a round covering every
        document it touches) with ONE scatter and ONE kernel launch, or,
        where the batch dirties at least `dispatch.megabatch_min_docs()`
        documents and the card's cost model prices it cheaper, with the
        scatter and a fused launch a bucket of the dirty lanes (the
        megabatch route, `_dispatch_final`).

        frames: round-frame bytes or decoded RoundColumns; the documents
        must exist in this set. Returns the device tensor of the post-batch
        per-doc hashes (int32 bits, padded to n_pad; `cuda_kernels.
        hashes_to_numpy` reads it), or None under `lazy_dispatch`, when the
        next hash read does the device work. The classic dispatch leaves
        the tensor unread, so consecutive calls chain on the device and the
        host encode of one batch overlaps the device work of the one
        before; the route reads its lanes' hashes back and uploads the
        tensor from the host mirror.

        On a `native=False` instance the rounds go through Change objects
        and the pure-Python encoder, then the same merged dispatch."""
        self._check_poisoned()
        rounds = [f if isinstance(f, RoundColumns) else decode_round_frame(f)
                  for f in frames]
        if self._native is None:
            return self._apply_rounds_final([rc.to_dict() for rc in rounds])
        # the path's allocation bursts (admitted refs, delta rows) would
        # trigger generation-2 collections over the whole heap
        with metrics.trace("rows_round_apply"), gc_paused():
            return self._apply_round_frames(rounds)

    def _apply_round_frames(self, rounds):
        for rc in rounds:
            self._register_round_actors(rc)
        self._precheck_round_frames(rounds)
        with self._admission_guard():
            # steady state: ONE vectorized admission + native encode for
            # the whole micro-batch; per-round encode (every protocol
            # case) when any change breaks the per-doc in-order chain
            enc_all = self._encode_rounds_batched(rounds)
            if enc_all is not None:
                metrics.bump("rows_rounds_batched", len(rounds))
                encoded = [enc_all]
            else:
                if any(rc.cols.n_changes for rc in rounds):
                    metrics.bump("rows_rounds_fallback", len(rounds))
                encoded = [self._encode_round_frame(rc) for rc in rounds]
            self._grow_for_rounds(encoded)
            trip_list = [self._cols_triplets(e) for e in encoded]
            with self._dispatch_guard():
                return self._dispatch_final(trip_list)

    def _apply_rounds_final(self, rounds) -> torch.Tensor | None:
        """Change rounds through the pure-Python encoder, then the merged
        dispatch of apply_round_frames."""
        for r in rounds:
            self._register_actors(r)
        self._reserve_for(rounds)
        with self._admission_guard():
            trip_list = [self._round_triplets(r) for r in rounds]
            with self._dispatch_guard():
                return self._dispatch_final(trip_list)

    def _register_round_actors(self, rc) -> None:
        cols = rc.cols
        idx = set(np.asarray(cols.change_actor).tolist())
        self._register_actor_names({cols.actors[i] for i in idx})

    def _precheck_round_frames(self, rounds) -> None:
        """Vectorized budget precheck for round frames (one numpy pass a
        round instead of per-change slicing), after the ghost-anchor reject
        for compacted docs."""
        for rc in rounds:
            if any(self.ghost_eids[self.doc_index[d]] for d in rc.doc_ids):
                off = np.asarray(rc.change_off, np.int64)
                op_off = np.asarray(rc.cols.op_off, np.int64)
                for k, d in enumerate(rc.doc_ids):
                    self._check_ghost_anchors_cols(
                        self.doc_index[d], rc.cols,
                        int(op_off[off[k]]), int(op_off[off[k + 1]]))
        ins_idx = _ACTION_IDX["ins"]
        l1, l2 = _ACTION_IDX["makeList"], _ACTION_IDX["makeText"]

        need_ops = self.op_count.copy()
        n_elems = np.zeros(self.cap_docs, np.int64)
        n_lists = np.zeros(self.cap_docs, np.int64)
        for i in self._queued_docs:
            for p in self.tables[i].queue:
                cols, j = p.payload
                o0, o1 = int(cols.op_off[j]), int(cols.op_off[j + 1])
                need_ops[i] += o1 - o0
                acts = np.asarray(cols.op_action[o0:o1])
                n_elems[i] += int((acts == ins_idx).sum())
                n_lists[i] += int(((acts == l1) | (acts == l2)).sum())
        for rc in rounds:
            cols = rc.cols
            doc_idx = np.fromiter((self.doc_index[d] for d in rc.doc_ids),
                                  np.int64, len(rc.doc_ids))
            off = np.asarray(rc.change_off, np.int64)
            op_off = np.asarray(cols.op_off, np.int64)
            ops_per_doc = op_off[off[1:]] - op_off[off[:-1]]
            np.add.at(need_ops, doc_idx, ops_per_doc)
            acts = np.asarray(cols.op_action)
            if (acts == ins_idx).any() or (acts == l1).any() \
                    or (acts == l2).any():
                op_doc = np.repeat(doc_idx, ops_per_doc)
                np.add.at(n_elems, op_doc, acts == ins_idx)
                np.add.at(n_lists, op_doc, (acts == l1) | (acts == l2))
        self._check_prospective_caps(need_ops, int(n_elems.max(initial=0)),
                                     int(n_lists.max(initial=0)))

    def _encode_rounds_batched(self, rounds):
        """Whole-micro-batch vectorized admission (the streaming steady
        state): every change of every round extends its doc's SAME-ACTOR
        in-order chain, one peer's consecutive edits per document. One
        classification over the frame columns, one batched clock-row
        construction and ONE native encode for all rounds; per-change
        Python shrinks to the clock memo and the change-log append.
        Returns the merged encode, or None when any change breaks the
        chain shape (the caller then encodes round by round, which handles
        every protocol case)."""
        rcs = [rc for rc in rounds if rc.cols.n_changes]
        if not rcs:
            return None
        self._refresh_admission_cache()
        rank_of = self.actor_rank

        doc_l, j_l, rnd_l, arank_l, seq_l = [], [], [], [], []
        dep_rank_l, dep_seq_l, dep_chg_l = [], [], []
        off = 0
        for r, rc in enumerate(rcs):
            cols = rc.cols
            n_k = len(rc.doc_ids)
            ch_off = np.asarray(rc.change_off, np.int64)
            ch_per_k = np.diff(ch_off)
            if (ch_per_k > 1).any():
                return None  # multi-change docs: per-round path
            sel = ch_per_k == 1
            docs_r = np.fromiter((self.doc_index[d] for d in rc.doc_ids),
                                 np.int64, n_k)[sel]
            js_r = ch_off[:-1][sel]
            perm = np.fromiter((rank_of.get(a, -1) for a in cols.actors),
                               np.int64, len(cols.actors))
            arank_r = perm[np.asarray(cols.change_actor, np.int64)[js_r]]
            seq_r = np.asarray(cols.change_seq, np.int64)[js_r]
            doc_l.append(docs_r)
            j_l.append(js_r)
            rnd_l.append(np.full(len(js_r), r, np.int64))
            arank_l.append(arank_r)
            seq_l.append(seq_r)
            deps_off = np.asarray(cols.deps_off, np.int64)
            dep_cnt = np.diff(deps_off)
            if dep_cnt.any():
                # change index within the frame -> admitted position
                dep_chg_frame = np.repeat(np.arange(cols.n_changes), dep_cnt)
                pos_of_j = np.full(cols.n_changes, -1, np.int64)
                pos_of_j[js_r] = off + np.arange(len(js_r))
                dep_pos = pos_of_j[dep_chg_frame]
                if (dep_pos < 0).any():
                    return None  # dep rows of unadmitted changes
                dep_rank_l.append(perm[np.asarray(cols.deps_actor,
                                                  np.int64)])
                dep_seq_l.append(np.asarray(cols.deps_seq, np.int64))
                dep_chg_l.append(dep_pos)
            off += len(js_r)

        doc_all = np.concatenate(doc_l)
        n = len(doc_all)
        if n == 0:
            return None
        j_all = np.concatenate(j_l)
        rnd_all = np.concatenate(rnd_l)
        arank_all = np.concatenate(arank_l)
        seq_all = np.concatenate(seq_l)
        if (arank_all < 0).any():
            return None
        qf = self._queued_mask()
        if qf is not None and qf[doc_all].any():
            return None

        order = np.lexsort((rnd_all, doc_all))
        d = doc_all[order]
        a = arank_all[order]
        s = seq_all[order]
        starts = np.searchsorted(d, d, side="left")
        is_first = starts == np.arange(n)
        cc, fs_, hr_, hs_ = (self._clock_cache, self._fsize,
                             self._hrank, self._hseq)
        # one actor a chain, consecutive seqs from the pre-batch clock
        if (a != a[starts]).any():
            return None
        base = cc[d[starts], a[starts]]
        if not (s == base + 1 + (np.arange(n) - starts)).all():
            return None
        # frontier coverage of the chain firsts (deps checked below)
        own = (a == hr_[d]) & (s - 1 >= hs_[d])
        cov = np.zeros(n, np.int64)
        if dep_chg_l:
            dep_chg = np.concatenate(dep_chg_l)
            dep_rank = np.concatenate(dep_rank_l)
            dep_seq = np.concatenate(dep_seq_l)
            # dep rows into the ordered space
            inv = np.empty(n, np.int64)
            inv[order] = np.arange(n)
            dep_pos = inv[dep_chg]
            dep_doc = d[dep_pos]
            safe_rank = np.maximum(dep_rank, 0)
            sat_pre = (dep_rank >= 0) & (cc[dep_doc, safe_rank] >= dep_seq)
            sat_chain = (dep_rank == a[dep_pos]) & (dep_seq < s[dep_pos])
            bad = np.zeros(n, np.int64)
            np.add.at(bad, dep_pos, ~(sat_pre | sat_chain))
            if bad.any():
                return None
            np.add.at(cov, dep_pos,
                      (dep_rank == hr_[dep_doc]) & (dep_seq >= hs_[dep_doc]))
        fsz = fs_[d]
        first_ok = (~is_first) | (fsz == 0) | ((fsz == 1) & ((cov > 0) | own))
        if not first_ok.all():
            return None

        # ---- admitted: batched bookkeeping ----
        # the clock row before each change: the pre-batch row with its own
        # entry at seq - 1
        cmat = cc[d].astype(np.int32)
        cmat[np.arange(n), a] = (s - 1).astype(np.int32)
        # the cache from each chain's last change
        last = np.ones(n, bool)
        last[:-1] = d[1:] != d[:-1]
        cc[d[last], a[last]] = s[last]
        fs_[d[last]] = 1
        hr_[d[last]] = a[last]
        hs_[d[last]] = s[last]

        j_ord = j_all[order]
        rnd_ord = rnd_all[order]
        cidx = np.empty(n, np.int64)
        tables = self.tables
        change_log = self.change_log
        actor_names = self.actors
        cols_of = [rc.cols for rc in rcs]
        for pos, (i, j, r, ar, s_) in enumerate(zip(
                d.tolist(), j_ord.tolist(), rnd_ord.tolist(),
                a.tolist(), s.tolist())):
            t = tables[i]
            t.state_clocks[(actor_names[ar], s_)] = (cmat, pos)
            change_log[i].append(AdmittedRef(cols_of[r], j))
            cidx[pos] = t.n_changes
            t.n_changes += 1
            if t.n_changes > self._changes_hi:
                self._changes_hi = t.n_changes
            if t._stale_idx is None:
                t._stale_idx = i
                t.clock = self._StaleView(self, t, "clock")
                t.frontier = self._StaleView(self, t, "frontier")
        self._stale_tables = True

        self._native.ensure_docs(len(self.doc_ids))
        self._native.begin()
        self._native.apply_frames([frame_bytes_of(c) for c in cols_of],
                                  rnd_ord, j_ord, d, a, s, cidx)
        bd = self._native.finish()
        self._mirror_stats(bd, d)
        return {"bd": bd, "clock_mat": cmat, "adm_doc": d,
                "adm_cidx": cidx}

    def _encode_round_frame(self, rc):
        """Admission + clock rows for one round frame, then ONE native
        encode over its embedded AMW1 frame.

        The hot case, in-order delivery of one change per doc whose
        declared deps cover the doc's dependency frontier, is classified
        vectorized against the dense cache: its transitive clock IS the
        doc's current clock (one gather for the round), no closure walk,
        no _Pending. Anything else (gaps, duplicates, queued docs,
        multi-change docs, partial frontiers) goes per doc through _admit
        and _clock_row."""
        cols = rc.cols
        n_ch = cols.n_changes
        if n_ch == 0:
            return None
        self._refresh_admission_cache()
        actors = cols.actors
        rank_of = self.actor_rank

        n_k = len(rc.doc_ids)
        doc_of_k = np.fromiter((self.doc_index[d] for d in rc.doc_ids),
                               np.int64, n_k)
        ch_off = np.asarray(rc.change_off, np.int64)
        ch_per_k = np.diff(ch_off)
        chg_doc = np.repeat(doc_of_k, ch_per_k)
        chg_k = np.repeat(np.arange(n_k), ch_per_k)
        # the frame may intern actors seen only in deps, with no rank yet:
        # -1 marks them, and a dep on one is unsatisfied (the change goes
        # the slow way and queues)
        perm = np.fromiter((rank_of.get(a, -1) for a in actors),
                           np.int64, len(actors))
        arank = perm[np.asarray(cols.change_actor, np.int64)]
        seq = np.asarray(cols.change_seq, np.int64)

        cc, fs_, hr_, hs_ = (self._clock_cache, self._fsize,
                             self._hrank, self._hseq)
        # in-order next change of its actor
        ok = seq == cc[chg_doc, arank] + 1
        # every declared dep satisfied; the frontier head covered by a dep
        deps_off = np.asarray(cols.deps_off, np.int64)
        dep_cnt = np.diff(deps_off)
        cov = np.zeros(n_ch, np.int64)
        if dep_cnt.any():
            dep_chg = np.repeat(np.arange(n_ch), dep_cnt)
            dep_doc = chg_doc[dep_chg]
            dep_rank = perm[np.asarray(cols.deps_actor, np.int64)]
            dep_seq = np.asarray(cols.deps_seq, np.int64)
            safe_rank = np.maximum(dep_rank, 0)
            bad = np.zeros(n_ch, np.int64)
            np.add.at(bad, dep_chg,
                      (dep_rank < 0) | (cc[dep_doc, safe_rank] < dep_seq))
            ok &= bad == 0
            np.add.at(cov, dep_chg,
                      (dep_rank == hr_[dep_doc]) & (dep_seq >= hs_[dep_doc]))
        own = (arank == hr_[chg_doc]) & (seq - 1 >= hs_[chg_doc])
        fsz = fs_[chg_doc]
        ok &= (fsz == 0) | ((fsz == 1) & ((cov > 0) | own))
        qflag = self._queued_mask()
        if qflag is not None:
            ok &= ~qflag[chg_doc]
        # multi-change docs need sequential cache updates: slow path
        ok &= np.repeat(ch_per_k == 1, ch_per_k)
        k_bad = np.zeros(n_k, np.int64)
        np.add.at(k_bad, chg_k, ~ok)

        order = sorted(range(n_k), key=lambda k: doc_of_k[k])
        # fast docs: exactly one change this round, passing every check
        # (empty docs are no-ops; multi-change docs went slow above)
        fast_in_order = [k for k in order
                         if ch_per_k[k] == 1 and not k_bad[k]]
        fast_js = ch_off[fast_in_order]
        fast_docs = doc_of_k[fast_in_order]
        # clock rows = the clock BEFORE each fast change (doc-disjoint, so
        # one gather), then one batched cache update
        cmat_fast = cc[fast_docs]
        cc[fast_docs, arank[fast_js]] = seq[fast_js]
        fs_[fast_docs] = 1
        hr_[fast_docs] = arank[fast_js]
        hs_[fast_docs] = seq[fast_js]

        # fast bookkeeping: the per-doc dicts (clock, frontier, seen) are
        # NOT updated; the dense cache is their authority until
        # _sync_stale_table materializes them. What stays per doc: the
        # clock memo (read by _clock_row for later slow changes), the
        # change log and the change counter.
        n_fast = len(fast_in_order)
        cidx_fast = np.empty(n_fast, np.int64)
        ca_list = np.asarray(cols.change_actor)[fast_js].tolist()
        seq_list = seq[fast_js].tolist()
        tables = self.tables
        change_log = self.change_log
        for pos, (i, j, ca, s) in enumerate(zip(
                fast_docs.tolist(), fast_js.tolist(), ca_list, seq_list)):
            t = tables[i]
            t.state_clocks[(actors[ca], s)] = (cmat_fast, pos)
            change_log[i].append(AdmittedRef(cols, j))
            cidx_fast[pos] = t.n_changes
            t.n_changes += 1
            if t.n_changes > self._changes_hi:
                self._changes_hi = t.n_changes
            if t._stale_idx is None:
                t._stale_idx = i
                t.clock = self._StaleView(self, t, "clock")
                t.frontier = self._StaleView(self, t, "frontier")
        if n_fast:
            self._stale_tables = True

        frames: list[bytes] = [frame_bytes_of(cols)]
        frame_of: dict[int, int] = {id(cols): 0}
        adm_frame: list[int] = []
        adm_idx: list[int] = []
        adm_doc: list[int] = []
        aranks: list[int] = []
        seqs: list[int] = []
        cidxs: list[int] = []
        clock_rows: list[np.ndarray] = []

        queued = self._queued_docs
        change_actor = cols.change_actor
        for k in order:
            if not ch_per_k[k] or (ch_per_k[k] == 1 and not k_bad[k]):
                continue
            i = int(doc_of_k[k])
            t = self.tables[i]
            log = self.change_log[i]
            # slow path: full causal admission, change by change (may also
            # release changes queued earlier, from other frames too)
            for j in range(int(ch_off[k]), int(ch_off[k + 1])):
                actor = actors[int(change_actor[j])]
                s = int(seq[j])
                ready = self._admit(t, [_Pending(actor, s,
                                                 cols.deps_at(j), (cols, j))])
                if t.queue:
                    queued.add(i)
                else:
                    queued.discard(i)
                for p in ready:
                    pc, pj = p.payload
                    if id(pc) not in frame_of:
                        frame_of[id(pc)] = len(frames)
                        frames.append(frame_bytes_of(pc))
                    clock_rows.append(
                        self._clock_row(t, p.actor, p.seq, p.deps))
                    log.append(AdmittedRef(pc, pj))
                    adm_frame.append(frame_of[id(pc)])
                    adm_idx.append(pj)
                    adm_doc.append(i)
                    aranks.append(rank_of[p.actor])
                    seqs.append(p.seq)
                    cidxs.append(t.n_changes)
                    t.n_changes += 1
                    if t.n_changes > self._changes_hi:
                        self._changes_hi = t.n_changes
            self._cache_dirty.add(i)

        n_adm = n_fast + len(adm_doc)
        if not n_adm:
            return None

        # merge fast (vectors) and slow (lists) into (doc, cidx)-ascending
        # admitted columns: the order of the native encoder's doc-grouped
        # rows and of _cols_triplets' searchsorted join
        if adm_doc:
            m_frame = np.concatenate([np.zeros(n_fast, np.int64),
                                      np.asarray(adm_frame, np.int64)])
            m_idx = np.concatenate([fast_js, np.asarray(adm_idx, np.int64)])
            m_doc = np.concatenate([fast_docs,
                                    np.asarray(adm_doc, np.int64)])
            m_arank = np.concatenate([arank[fast_js],
                                      np.asarray(aranks, np.int64)])
            m_seq = np.concatenate([seq[fast_js],
                                    np.asarray(seqs, np.int64)])
            m_cidx = np.concatenate([cidx_fast,
                                     np.asarray(cidxs, np.int64)])
            m_clock = np.zeros((n_adm, cc.shape[1]), np.int32)
            m_clock[:n_fast] = cmat_fast
            for r, row in enumerate(clock_rows):
                m_clock[n_fast + r, :len(row)] = row
            perm2 = np.lexsort((m_cidx, m_doc))
            m_frame, m_idx, m_doc = (m_frame[perm2], m_idx[perm2],
                                     m_doc[perm2])
            m_arank, m_seq, m_cidx = (m_arank[perm2], m_seq[perm2],
                                      m_cidx[perm2])
            m_clock = m_clock[perm2]
        else:
            m_frame = np.zeros(n_fast, np.int64)
            m_idx, m_doc = fast_js, fast_docs
            m_arank, m_seq, m_cidx = arank[fast_js], seq[fast_js], cidx_fast
            m_clock = cmat_fast.astype(np.int32)

        self._native.ensure_docs(len(self.doc_ids))
        self._native.begin()
        self._native.apply_frames(frames, m_frame, m_idx, m_doc,
                                  m_arank, m_seq, m_cidx)
        bd = self._native.finish()
        self._mirror_stats(bd, m_doc)
        return {"bd": bd, "clock_mat": m_clock, "adm_doc": m_doc,
                "adm_cidx": m_cidx}

    def _dispatch_final(self, trip_list) -> torch.Tensor | None:
        """One scatter and one reconcile for a whole batch: triplets merged
        in round order with last-wins dedup (rounds overwrite each other
        only on re-linearized position rows). A stale device copy is
        replaced by the host mirror, which already holds the batch, and
        nothing is scattered. Returns the device hash tensor without
        reading it back; the next hashes() read consumes it. Under
        lazy_dispatch it returns None and launches nothing.

        A batch that dirties at least `megabatch_min_docs()` documents is
        planned (dispatch.plan_round, priced against this classic
        dispatch). On the megabatch route the device copy is brought up to
        date the same way, then only the batch's lanes reconcile, in fused
        launches at their buckets' dims (dispatch.apply_round_adaptive),
        read back into the host hash mirror; the post-batch hashes are
        returned from the mirror, uploaded, and the next hashes() launches
        nothing."""
        touched = self._mark_trips_dirty(trip_list)
        if self.lazy_dispatch:
            # the triplets are already in the host mirror; the next hash
            # read uploads and reconciles only the lanes just marked
            self.rows_dev = None
            self._dirty = True
            self._hash_handle = None
            return None
        merged = [t for t in trip_list if len(t)]
        trips = (_last_wins(np.concatenate(merged), self.n_pad) if merged
                 else None)
        plan = None
        if round_dispatch.megabatch_enabled() \
                and len(touched) >= round_dispatch.megabatch_min_docs():
            plan = round_dispatch.plan_round(
                self, touched, frame_trips=0 if trips is None else len(trips))
        if self.rows_dev is None or self._dirty:
            self.rows_dev = self._to_dev(self.rows_host)
            self._dirty = False
            trips = None
        elif trips is not None:
            trips = self._to_dev(trips.astype(np.int64))
        if plan is not None and plan.route == "megabatch":
            return self._dispatch_route(plan, trips)
        with dispatchledger.call_scope(
                "rows_apply", backend="device", docs=len(touched),
                axes={"docs": (len(self.doc_ids), self.n_pad)}):
            self.rows_dev, h = metrics.dispatch_jit(
                "apply_final", _apply_final,
                self.rows_dev, trips, self.dims())
        self._hash_handle = h
        return h

    def _dispatch_route(self, plan, trips) -> torch.Tensor:
        """The megabatch route of a frame batch: the triplets scattered into
        the current device copy, the planned lanes reconciled from it in
        fused bucket launches, any other dirty lane through the classic
        read paths, and the post-batch hashes (int32 bits, n_pad long,
        padding lanes 0) uploaded from the host mirror."""
        if trips is not None:
            _scatter_(self.rows_dev, trips)
        # an unread hash tensor of an earlier batch predates this one's
        # scatter: the lanes it would refresh are still marked dirty
        self._hash_handle = None
        round_dispatch.apply_round_adaptive(self, plan)
        self._refresh_hash_mirror(None)
        n = len(self.doc_ids)
        out = np.zeros(self.n_pad, np.uint32)
        out[:n] = self._hash_mirror[:n]
        return self._to_dev(out.view(np.int32))

    def _refresh_hash_mirror(self, want) -> None:
        """Bring the host hash mirror current for `want` (doc indices; None
        = every doc), doing the minimum device work:

        - an unconsumed device handle covers every lane: ONE readback
          refreshes the whole mirror, no launch;
        - otherwise only dirty lanes in `want` reconcile: with a minority
          of the fleet dirty, through the megabatch route where
          dispatch.plan_round prices it no dearer, else through a narrow
          gathered sub-buffer (_reconcile_lanes); with a majority dirty,
          through the full-buffer reconcile (which re-primes the device
          copy).
        """
        n = len(self.doc_ids)
        mirror = self._ensure_hash_mirror()
        if self._hash_handle is not None \
                and (self._dirty or self.rows_dev is None):
            # the handle predates a re-layout or invalidation: it can never
            # be consumed
            self._hash_handle = None
        if self._hash_handle is not None:
            # breadcrumb BEFORE the readback barrier: a hang there finds
            # this thread's entry in the flight recorder
            flightrec.record("rows_hash_readback", docs=n, cached=True)
            with perfscope.phase("readback"):
                vals = hashes_to_numpy(self._hash_handle)
            mirror[:n] = vals[:n]
            self._hash_handle = None
            self._doc_dirty.clear()
            return
        dirty = sorted(i for i in self._doc_dirty if i < n
                       and (want is None or i in want))
        if not dirty:
            return
        if 2 * len(dirty) < n and round_dispatch.apply_round_adaptive(
                self, round_dispatch.plan_round(self, dirty)) is not None:
            return
        if 2 * len(dirty) >= n:
            if self.rows_dev is None or self._dirty:
                self.rows_dev = self._to_dev(self.rows_host)
                self._dirty = False
            with dispatchledger.call_scope(
                    "rows_hash", backend="device", docs=len(dirty),
                    axes={"docs": (n, self.n_pad)}):
                h = metrics.dispatch_jit(
                    "reconcile_rows_hash", reconcile_rows_hash,
                    self.rows_dev, self.dims())
            flightrec.record("rows_hash_readback", docs=n, cached=False)
            with perfscope.phase("readback"):
                vals = hashes_to_numpy(h)
            mirror[:n] = vals[:n]
            self._hash_handle = None
            self._doc_dirty.clear()
            return
        self._reconcile_lanes(dirty)

    def _mega_doc_sizes(self, idxs):
        """Exact per-doc used sizes for megabatch bucket planning: the ops
        used (op rows fill slots [0, op_count) with op_mask set, and
        compaction packs its survivors to the front, so this equals the
        reference's scan of the op_mask band) and the lists used, from a scan of the selected lanes'
        ins_mask band: the highest occupied elem slot rounded up to whole
        lists (elem bands subset only at list granularity,
        pack.mega_row_map). Returns (i_used, l_used) int64 arrays."""
        sel = np.asarray(idxs, np.int64)
        i_used = self.op_count[sel].astype(np.int64)
        le = self.cap_lists * self.cap_elems
        if le:
            b = self._bases()
            im = self.rows_host[b["im"]:b["im"] + le][:, sel] > 0
            slot = np.where(im.any(axis=0),
                            le - np.argmax(im[::-1], axis=0), 0)
            l_used = -(-slot // self.cap_elems)
        else:
            l_used = np.zeros(len(sel), np.int64)
        return i_used, l_used.astype(np.int64)

    def _reconcile_lanes(self, idxs: list[int]) -> None:
        """Reconcile ONLY the given doc lanes: gather their columns from the
        host mirror into a narrow [ROWS, k_pad] buffer and run the same
        kernel on it. Cost is O(dirty), independent of fleet size."""
        k = len(idxs)
        k_pad = pad_to_lanes(k)
        # padding lanes must be VALID doc columns (a zero column is not:
        # empty lanes carry -1 in the ac/fid/if/io bands); repeat the last
        # dirty lane, whose extra hashes are discarded below
        sel = np.asarray(idxs + [idxs[-1]] * (k_pad - k), np.int64)
        with perfscope.phase("pack"):
            sub = np.ascontiguousarray(self.rows_host[:, sel])
        with dispatchledger.call_scope("rows_hash", backend="device", docs=k,
                                       axes={"docs": (k, k_pad)}):
            h = metrics.dispatch_jit(
                "reconcile_rows_hash", reconcile_rows_hash,
                self._to_dev(sub), self.dims())
        flightrec.record("rows_hash_readback", docs=k, cached=False)
        with perfscope.phase("readback"):
            vals = hashes_to_numpy(h)
        self._hash_mirror[np.asarray(idxs, np.int64)] = vals[:k]
        self._doc_dirty.difference_update(idxs)

    @property
    def hashes_clean(self) -> bool:
        """True iff hashes() would serve entirely from the host mirror: no
        launch, no readback, no unread flush-time hash handle."""
        return (super().hashes_clean and self._hash_handle is None
                and self._poisoned is None)

    def hashes(self) -> np.ndarray:
        """Current per-doc state hashes (np.uint32), O(dirty) not O(fleet):
        served from the host hash mirror; only lanes whose rows changed
        since the last read are reconciled. A clean read launches
        nothing."""
        self._check_poisoned()
        with metrics.trace("rows_hashes"), self._dispatch_guard():
            self._refresh_hash_mirror(None)
            metrics.gauge("rows_resident_bytes", self.resident_bytes())
            return self._hash_mirror[:len(self.doc_ids)].copy()

    def hashes_for(self, idxs) -> np.ndarray:
        """Hashes for a subset of docs (indices into doc_ids) WITHOUT
        reconciling untouched docs: device work is O(requested & dirty).
        Returns np.uint32 hashes aligned with idxs."""
        self._check_poisoned()
        idxs = [int(i) for i in idxs]
        if not idxs:
            return np.zeros(0, np.uint32)
        with metrics.trace("rows_hashes"), self._dispatch_guard():
            self._refresh_hash_mirror(set(idxs))
            return self._hash_mirror[np.asarray(idxs, np.int64)].copy()

    def resident_bytes(self) -> int:
        """Footprint of this engine's resident state: the host row mirror,
        the device buffer (same layout), and the per-doc counters."""
        total = int(self.rows_host.nbytes)
        if self.rows_dev is not None:
            total += self.rows_dev.numel() * self.rows_dev.element_size()
        total += int(self.op_count.nbytes) + int(self.change_count.nbytes)
        return total

    def device_bytes(self) -> int:
        """Bytes of the device copy of the rows buffer (the CPU footprint
        gauge of utils/perfscope.py sums them)."""
        rows = getattr(self, "rows_dev", None)
        return 0 if rows is None else rows.numel() * rows.element_size()


def _last_wins(trips: np.ndarray, n_pad: int) -> np.ndarray:
    """(P, 3) triplets with one per (row, lane) key: the last in order."""
    if len(trips) < 2:
        return trips
    key = trips[:, 0].astype(np.int64) * n_pad + trips[:, 1]
    # np.unique keeps the FIRST occurrence per key of the reversed array,
    # which is the LAST write in order
    _, first = np.unique(key[::-1], return_index=True)
    return trips[len(trips) - 1 - first]


def _scatter_(rows: torch.Tensor, trips: torch.Tensor) -> None:
    """rows[r, c] = v for each (r, c, v) of an int64 [P, 3] tensor, in
    place. Keys are unique (_last_wins). The reference padded its triplets
    to a static shape with an out-of-range row its scatter dropped; the
    port uploads no padding, so every triplet lands."""
    rows.index_put_((trips[:, 0], trips[:, 1]), trips[:, 2].to(rows.dtype))


def _apply_final(rows: torch.Tensor, trips: torch.Tensor | None,
                 dims: tuple):
    """Merged-batch apply: one scatter, one reconcile + hash. `rows` is
    updated in place (the reference donated its buffer to the jitted
    function instead). Returns (rows, hash bits) without a readback."""
    if trips is not None:
        _scatter_(rows, trips)
    return rows, reconcile_rows_hash(rows, dims)


def _scan_rounds(rows: torch.Tensor, round_trips: list[torch.Tensor],
                 dims: tuple):
    """Per round: point-scatter the round's triplets into `rows` in place,
    then reconcile + hash (one kernel launch). The reference ran this as a
    lax.scan over a donated buffer. Returns (rows, [R, D_pad] int32 hash
    bits)."""
    out = []
    for trips in round_trips:
        _scatter_(rows, trips)
        out.append(reconcile_rows_hash(rows, dims))
    if not out:
        return rows, torch.zeros((0, rows.shape[1]), dtype=torch.int32,
                                 device=rows.device)
    return rows, torch.stack(out)
