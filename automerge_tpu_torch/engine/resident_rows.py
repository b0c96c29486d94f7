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
`resident.ResidentDocSet`. List order is kept on the host by the RGA
linearizer and shipped as position rows.

Not here yet (later slices): the native column ingress (`apply_rounds_cols`,
`apply_round_frames`), the megabatch route, compaction, the log archive and
snapshots, rebuild-from-log, `materialize`, and the telemetry planes.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..native.linearize import linearize_host
from .cuda_kernels import hashes_to_numpy, reconcile_rows_hash
from .encode import A_DEL, A_SET, _pad_to
from .pack import pad_to_lanes, row_bases, rows_dims_eligible
from .resident import ResidentDocSet


class DeviceDispatchError(RuntimeError):
    """The device dispatch of an already-admitted batch failed. Host truth
    (change_log, per-doc clocks, and the rows_host mirror, all updated
    BEFORE the dispatch) is consistent; only the device buffer is suspect,
    and the engine has marked itself dirty so the next dispatch re-uploads
    the mirror. ``admission_complete`` is True when every change of the
    batch was admitted, queued, or dropped as a duplicate: nothing to
    retry."""

    def __init__(self, msg: str, *, admission_complete: bool = False):
        super().__init__(msg)
        self.admission_complete = admission_complete


class RowsBudgetError(RuntimeError):
    """The batch would grow the resident rows state past the kernel's dims
    envelope (pack.rows_dims_eligible). Recoverable: the instance is
    untouched. Shard the DocSet, or compact long-lived docs once compaction
    is ported."""


def _budget_error(cap_ops: int, actors: int,
                  elem_slots: int) -> RowsBudgetError:
    return RowsBudgetError(
        f"this batch could grow the resident rows state past the "
        f"megakernel dims envelope (ops<={cap_ops}, actors={actors}, "
        f"elem slots<={elem_slots}); shard this DocSet across more rows "
        f"instances")


class ResidentRowsDocSet(ResidentDocSet):
    """Resident DocSet whose device state IS the kernel's row buffer.

    `device` is where the buffer lives and the kernel runs: "cuda" (the
    default) needs a GPU and raises without one; "cpu" runs the kernel's
    plain PyTorch version."""

    def __init__(self, doc_ids, actors: list[str] = (),  # noqa: B006
                 device: str | torch.device = "cuda"):
        super().__init__(doc_ids, device=device)
        self.n_pad = pad_to_lanes(max(len(self.doc_ids), 1))
        # per-doc: list_row -> [(slot, elem, arank, parent_slot), ...]
        self.ins_log: list[dict[int, list[tuple]]] = [
            {} for _ in self.doc_ids]
        # per-doc: list_row -> owning-object content hash
        self.list_hash: list[dict[int, int]] = [{} for _ in self.doc_ids]
        # per-doc admitted change log
        self.change_log: list[list] = [[] for _ in self.doc_ids]
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
        fresh = super().add_docs(new_ids)
        for _ in fresh:
            self.ins_log.append({})
            self.list_hash.append({})
            self.change_log.append([])
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
                elif op.action in ("makeList", "makeText"):
                    n_lists[i] = n_lists.get(i, 0) + 1

        for i in self._queued_docs:
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
        (ip-band row indices, positions), both int64 arrays. Without
        compaction an entry's index in the log is its slot, so a parent
        slot is also the parent's entry index."""
        entries = self.ins_log[doc_idx][lrow]
        n = len(entries)
        elem = np.fromiter((e for (_, e, _, _) in entries), np.int32, n)
        arank = np.fromiter((a for (_, _, a, _) in entries), np.int32, n)
        parent = np.fromiter((p for (_, _, _, p) in entries), np.int32, n)
        slots = np.fromiter((s for (s, _, _, _) in entries), np.int64, n)
        pos = np.asarray(
            linearize_host(np.ones(n, dtype=bool), elem, arank, parent),
            np.int64)
        rows = self._bases()["ip"] + lrow * self.cap_elems + slots
        return rows, pos

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
            for (lrow, _oi, objhash) in delta.new_lists:
                self.list_hash[i][lrow] = objhash
            touched_lists = set()
            for (lrow, slot, elem, arank, parent_slot, fid) in delta.ins:
                self.ins_log[i].setdefault(lrow, []).append(
                    (slot, elem, arank, parent_slot))
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
            raise DeviceDispatchError(str(e), admission_complete=True) from e

    @contextlib.contextmanager
    def _admission_guard(self):
        """Wrap admission + mirror scatter. A failure after some change was
        admitted leaves change_log/clocks ahead of the rows mirror; the
        reference rebuilds from the log there, which is not ported yet, so
        the instance is poisoned (every later apply or read raises) and the
        error propagates. A failure before any admission propagates and
        leaves the instance usable."""
        log_lens = [len(log) for log in self.change_log]
        try:
            yield
        except DeviceDispatchError:
            raise  # the dispatch guard recovered; admission stands
        except Exception as e:
            if any(len(log) != n
                   for log, n in zip(self.change_log, log_lens)):
                self._poison(e)
            raise

    def _poison(self, cause) -> None:
        self._poisoned = (f"resident row state no longer reflects the "
                          f"admitted change log ({cause!r}); rebuild the "
                          f"node from its durable log")

    def _check_poisoned(self) -> None:
        if self._poisoned:
            raise RuntimeError(self._poisoned)

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
        """
        self._check_poisoned()
        for r in rounds:
            self._register_actors(r)
        self._reserve_for(rounds)
        with self._admission_guard():
            pre_rows = self.rows_host.copy() \
                if self._dirty or self.rows_dev is None else None
            trip_list = [self._round_triplets(r) for r in rounds]
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

    def _mark_trips_dirty(self, trip_list) -> None:
        """Hash invalidation for the lanes a batch touches, BEFORE the
        dispatch (a failed dispatch leaves host truth updated)."""
        touched = {int(d) for t in trip_list for d in np.unique(t[:, 1])}
        if touched:
            self._mark_hash_dirty(touched)

    def _dispatch_rounds(self, trip_list, pre_rows) -> np.ndarray:
        n = len(self.doc_ids)
        self._mark_trips_dirty(trip_list)
        if pre_rows is not None:
            self.rows_dev = self._to_dev(pre_rows)
            self._dirty = False
        self.rows_dev, hashes = _scan_rounds(
            self.rows_dev, self._upload_trips(trip_list), self.dims())
        self._hash_handle = None
        vals = hashes_to_numpy(hashes)
        if len(trip_list):
            # the FINAL round's row is the canonical post-batch hash table:
            # adopt it so the next hashes() read is free
            self._adopt_full_hashes(vals[-1])
        return vals[:, :n]

    def _dispatch_final(self, trip_list, pre_rows) -> torch.Tensor:
        """One scatter + one reconcile for a whole batch: triplets merged
        in round order with last-wins dedup. Returns the device hash tensor
        without reading it back; the next hashes() read consumes it. (The
        reference's frame ingress drives this; in the port it arrives with
        that ingress.)"""
        self._mark_trips_dirty(trip_list)
        if pre_rows is not None:
            self.rows_dev = self._to_dev(pre_rows)
            self._dirty = False
        merged = [t for t in trip_list if len(t)]
        trips = self._upload_trips(
            [np.concatenate(merged)] if merged else [])
        self.rows_dev, h = _apply_final(
            self.rows_dev, trips[0] if trips else None, self.dims())
        self._hash_handle = h
        return h

    def _refresh_hash_mirror(self, want) -> None:
        """Bring the host hash mirror current for `want` (doc indices; None
        = every doc), doing the minimum device work:

        - an unconsumed device handle covers every lane: ONE readback
          refreshes the whole mirror, no launch;
        - otherwise only dirty lanes in `want` reconcile, through a narrow
          gathered sub-buffer (_reconcile_lanes), UNLESS a majority of the
          fleet is dirty; then the full-buffer reconcile is cheaper (and
          re-primes the device copy).
        """
        n = len(self.doc_ids)
        mirror = self._ensure_hash_mirror()
        if self._hash_handle is not None \
                and (self._dirty or self.rows_dev is None):
            # the handle predates a re-layout or invalidation: it can never
            # be consumed
            self._hash_handle = None
        if self._hash_handle is not None:
            vals = hashes_to_numpy(self._hash_handle)
            mirror[:n] = vals[:n]
            self._hash_handle = None
            self._doc_dirty.clear()
            return
        dirty = sorted(i for i in self._doc_dirty if i < n
                       and (want is None or i in want))
        if not dirty:
            return
        if 2 * len(dirty) >= n:
            if self.rows_dev is None or self._dirty:
                self.rows_dev = self._to_dev(self.rows_host)
                self._dirty = False
            vals = hashes_to_numpy(reconcile_rows_hash(self.rows_dev,
                                                       self.dims()))
            mirror[:n] = vals[:n]
            self._hash_handle = None
            self._doc_dirty.clear()
            return
        self._reconcile_lanes(dirty)

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
        sub = np.ascontiguousarray(self.rows_host[:, sel])
        vals = hashes_to_numpy(reconcile_rows_hash(self._to_dev(sub),
                                                   self.dims()))
        self._hash_mirror[np.asarray(idxs, np.int64)] = vals[:k]
        self._doc_dirty.difference_update(idxs)

    def hashes(self) -> np.ndarray:
        """Current per-doc state hashes (np.uint32), O(dirty) not O(fleet):
        served from the host hash mirror; only lanes whose rows changed
        since the last read are reconciled. A clean read launches
        nothing."""
        self._check_poisoned()
        with self._dispatch_guard():
            self._refresh_hash_mirror(None)
            return self._hash_mirror[:len(self.doc_ids)].copy()

    def hashes_for(self, idxs) -> np.ndarray:
        """Hashes for a subset of docs (indices into doc_ids) WITHOUT
        reconciling untouched docs: device work is O(requested & dirty).
        Returns np.uint32 hashes aligned with idxs."""
        self._check_poisoned()
        idxs = [int(i) for i in idxs]
        if not idxs:
            return np.zeros(0, np.uint32)
        with self._dispatch_guard():
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
