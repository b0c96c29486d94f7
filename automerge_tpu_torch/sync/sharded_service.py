"""ShardedEngineDocSet: one sync-node surface over K engine shards (the port
of `automerge_tpu/sync/sharded_service.py`, whole).

The rows engine bounds its per-instance working set and rejects batches
that would blow it with the advice "shard this DocSet across more rows
instances" (resident_rows.py budget prechecks). This module follows that
advice: documents are partitioned across K independent `EngineDocSet`
shards by a stable hash of the doc id (crc32 mod K), every
Connection-facing read and write routes to the owning shard, and
`batch()` coalesces a burst into at most one device dispatch per shard.

Devices: `devices=None` puts every shard on the card (`"cuda"`, the
current CUDA device) and raises without one, as `EngineDocSet` does; a
list of `torch.device`s (or device strings) binds the shards round-robin,
so K shards can drive K cards from one process. With all shards on one
card, each shard's flusher (`amtpu-torch-flusher-<k>`) and each hash
fan-out thread (`amtpu-torch-hashfan-<k>`, non-daemon, joined) enqueue
their own reconcile launches and read back their own results on the
default stream; under the GIL the fan-out does not scale with K.

Duck-typing contract: same surface Connection consumes from EngineDocSet
(doc_ids, get_doc, add_doc, apply_changes, apply_columns,
register_handler/unregister_handler), plus the engine reads
(hashes, materialize, clock_of, missing_changes, flush, batch).
"""

from __future__ import annotations

import contextlib
import os
import threading
import zlib
from typing import Callable

from ..device import DEFAULT_DEVICE
from ..utils import flightrec, metrics, perfscope
from .service import EngineDocSet

# Stall-watchdog budget for the hash fan-out (a shard's hash read can sit
# on a readback barrier). When a hash read overruns this many seconds,
# one WARNING line with every thread's active span stack is logged; 0
# disables. Overridable per deployment.
STALL_WATCHDOG_S = float(os.environ.get("AMTPU_STALL_WATCHDOG_S", "120"))


class ShardedEngineDocSet:
    #: transports may apply without holding their doc_set-wide lock
    #: (see EngineDocSet.concurrent_ingest; routing adds no shared state
    #: beyond the stable crc32 hash)
    concurrent_ingest = True

    def __init__(self, n_shards: int = 2, doc_ids: list[str] | None = None,
                 backend: str = "rows", devices=None,
                 log_archive_dir: str | None = None,
                 log_horizon_changes: int | None = None,
                 ingest_mode: str | None = None):
        """devices: optional list of torch devices; shards bind
        round-robin so K shards drive K cards from one process (each
        shard's engine holds its rows and launches its reconcile on its
        own device). None puts every shard on the card and raises
        without one.

        log_archive_dir/log_horizon_changes thread the log-horizon layer
        to every shard (shard k archives under <dir>/shard<k>; routing is
        stable, so a doc's archive stays with its shard across restarts)."""
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        self.n_shards = n_shards
        self.shards = [
            EngineDocSet(backend=backend,
                         device=(devices[k % len(devices)]
                                 if devices else DEFAULT_DEVICE),
                         log_archive_dir=(None if log_archive_dir is None
                                          else f"{log_archive_dir}/shard{k}"),
                         log_horizon_changes=log_horizon_changes,
                         ingest_mode=ingest_mode)
            for k in range(n_shards)]
        for k, s in enumerate(self.shards):
            s._shard = str(k)   # per-shard metric series (sync_round_flush…)
            # per-shard lock-contention series (bounded: one per shard),
            # so the lockprof plane separates a hot shard from the rest;
            # each shard's lazy flusher thread picks up the shard label
            # at spawn time (amtpu-torch-flusher-<k>)
            s._lock.rename(f"service_shard{k}")
        # monotonic hash fan-out counter: tagged onto the fan-out span and
        # the flight-recorder progress events, so a post-mortem names which
        # round stalled and how far the fan-out got before stalling
        self._hash_round = 0
        # per-shard dirty epochs (the incremental convergence plane): each
        # entry caches (engine hash epoch, per-doc hash dict) from that
        # shard's last read. hashes() fans out ONLY to shards whose state
        # moved since (hashes_dirty_since) and serves the rest from the
        # cache, so a clean-fleet read touches no engine at all. Guarded
        # by _hash_cache_lock (reads can race ingress threads).
        self._hash_cache: list[tuple[int, dict] | None] = [None] * n_shards
        self._hash_cache_lock = threading.Lock()
        # clean/dirty split of the most recent fan-out (bench/ops surface;
        # also exported as the sync_hashes_{clean,dirty}_shards gauges)
        self.last_hashes_clean_shards = 0
        self.last_hashes_dirty_shards = n_shards
        for d in doc_ids or []:
            self.add_doc(d)

    # -- routing ------------------------------------------------------------

    def shard_of(self, doc_id: str) -> EngineDocSet:
        """Stable assignment: crc32 of the id mod K (deterministic across
        processes and restarts; no coordination state to persist)."""
        return self.shards[zlib.crc32(doc_id.encode()) % self.n_shards]

    # -- registry surface ----------------------------------------------------

    @property
    def doc_ids(self) -> list[str]:
        return [d for s in self.shards for d in s.doc_ids]

    def get_doc(self, doc_id: str):
        return self.shard_of(doc_id).get_doc(doc_id)

    def add_doc(self, doc_id: str):
        return self.shard_of(doc_id).add_doc(doc_id)

    def register_handler(self, handler: Callable) -> None:
        for s in self.shards:
            s.register_handler(handler)

    def unregister_handler(self, handler: Callable) -> None:
        for s in self.shards:
            s.unregister_handler(handler)

    # -- ingress -------------------------------------------------------------

    def apply_changes(self, doc_id: str, changes):
        return self.shard_of(doc_id).apply_changes(doc_id, changes)

    def apply_columns(self, doc_id: str, cols):
        return self.shard_of(doc_id).apply_columns(doc_id, cols)

    def apply_columns_async(self, doc_id: str, cols):
        """Pipelined admission routed to the owning shard (see
        EngineDocSet.apply_columns_async); per-shard flushers drain
        concurrently, so a streaming writer saturates K shards."""
        return self.shard_of(doc_id).apply_columns_async(doc_id, cols)

    def archive_logs(self, doc_ids: list[str] | None = None) -> dict[str, int]:
        """Per-doc archived counts across shards (log-horizon layer)."""
        out: dict[str, int] = {}
        if doc_ids is None:
            for s in self.shards:
                out.update(s.archive_logs())
        else:
            for d in doc_ids:
                out.update(self.shard_of(d).archive_logs([d]))
        return out

    def close(self) -> None:
        """Flush buffered ingress and stop (join) every shard's flusher
        thread — deterministic teardown for tests and restarts."""
        for s in self.shards:
            s.close()

    def flush(self) -> None:
        """Flush every shard even if one raises (shards are independent;
        batch() has the same semantics via ExitStack): the first error
        propagates after all shards have drained."""
        first: BaseException | None = None
        for s in self.shards:
            try:
                s.flush()
            except BaseException as e:
                first = first or e
        if first is not None:
            raise first

    def batch(self):
        """Coalesce a burst into at most ONE dispatch per shard."""
        @contextlib.contextmanager
        def _cm():
            with contextlib.ExitStack() as stack:
                for s in self.shards:
                    stack.enter_context(s.batch())
                yield self
        return _cm()

    # -- protocol / engine reads ---------------------------------------------

    def clock_of(self, doc_id: str):
        return self.shard_of(doc_id).clock_of(doc_id)

    def missing_changes(self, doc_id: str, clock, drain: bool = True):
        return self.shard_of(doc_id).missing_changes(doc_id, clock,
                                                     drain=drain)

    def hashes(self) -> dict[str, int]:
        """Fleet convergence read, O(dirty shards) not O(fleet): shards
        untouched since their last read serve straight from the per-shard
        hash cache (validated by the engine's hash epoch — zero engine
        work, zero locks beyond the epoch check); dirty shards are read
        CONCURRENTLY (dispatch all, then barrier) instead of serially, so
        the wall cost is the slowest dirty shard, and each shard's own
        read is O(its dirty docs) via the engine's lane-partial
        reconcile. A read of a fleet where nothing changed touches no
        engine at all."""
        self._hash_round += 1
        rnd = self._hash_round
        with self._hash_cache_lock:
            cache = list(self._hash_cache)
        clean: list[int] = []
        dirty: list[int] = []
        results: dict[int, tuple[dict, int]] = {}
        failures: list[tuple[int, BaseException]] = []

        def _read(k: int) -> None:
            # per-shard progress breadcrumbs: if the fan-out stalls, the
            # flight-recorder dump shows exactly how many shards answered
            # before the stall
            flightrec.record("hash_shard", shard=str(k), round=rnd)
            try:
                results[k] = self.shards[k].hashes_snapshot()
            except BaseException as e:  # re-raised on the calling thread
                failures.append((k, e))

        # The epoch classification takes each shard's engine lock, so it
        # runs INSIDE the watchdog too: a shard wedged by a hung apply
        # must produce the watchdog diagnosis + flightrec breadcrumb, not
        # a silent pre-fan-out block.
        with metrics.watchdog("sync_hashes_fanout", STALL_WATCHDOG_S,
                              tags={"round": rnd}), \
                perfscope.phase("fleet_hashes"):
            for k, s in enumerate(self.shards):
                flightrec.record("hash_epoch_check", shard=str(k),
                                 round=rnd)
                c = cache[k]
                if c is not None and not s.hashes_dirty_since(c[0]):
                    clean.append(k)
                else:
                    dirty.append(k)
            if len(dirty) <= 1:
                for k in dirty:
                    _read(k)
            else:
                threads = [threading.Thread(
                    target=_read, args=(k,),
                    name=f"amtpu-torch-hashfan-{k}", daemon=False)
                    for k in dirty]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
        with self._hash_cache_lock:
            for k, (d, ep) in results.items():
                self._hash_cache[k] = (ep, d)
        if failures:
            raise failures[0][1]
        self.last_hashes_clean_shards = len(clean)
        self.last_hashes_dirty_shards = len(dirty)
        metrics.gauge("sync_hashes_clean_shards", len(clean))
        metrics.gauge("sync_hashes_dirty_shards", len(dirty))
        out: dict[str, int] = {}
        for k in clean:
            out.update(cache[k][1])
        for k, (d, _ep) in results.items():
            out.update(d)
        flightrec.record("hash_fanout_done", round=rnd,
                         shards=self.n_shards, docs=len(out),
                         clean=len(clean), dirty=len(dirty))
        return out

    def hashes_for(self, doc_ids) -> dict[str, int]:
        """Partial convergence read routed per shard: each owning shard
        reconciles only its requested ∩ dirty docs (EngineDocSet
        .hashes_for); untouched shards are never contacted."""
        by_shard: dict[int, list[str]] = {}
        for d in doc_ids:
            by_shard.setdefault(
                zlib.crc32(d.encode()) % self.n_shards, []).append(d)
        out: dict[str, int] = {}
        for k, ds in sorted(by_shard.items()):
            out.update(self.shards[k].hashes_for(ds))
        return out

    def materialize(self, doc_id: str):
        return self.shard_of(doc_id).materialize(doc_id)

    # -- convergence audit surface (sync/audit.py) ---------------------------

    def audit_state(self) -> dict[str, dict]:
        """Per-shard audit digests across all K shards — the auditor
        compares these shard-by-shard and bisects only mismatched shards
        to the doc level."""
        out: dict[str, dict] = {}
        for s in self.shards:
            out.update(s.audit_state())
        return out

    def audit_shard_state(self, shard: str) -> dict:
        """Doc-level hashes + clock frontiers for one shard."""
        return self.shards[int(shard)].audit_shard_state(shard)
