"""Per-doc convergence ledger: who is behind, on which doc, and who pays.

Every signal the repo had before this module is node-level (the fleet
collector's rates, the SLO rollups) or sampled (1/N oplag lifecycles).
The question operators of a large fleet actually ask — "why isn't doc X
converged on node Y, and what is it costing on the wire?" — needs
DOC-granular state: per (doc, peer), the peer's advertised clock, what we
shipped, what arrived, and how far the local frontier lags. That is also
the groundwork interest-based partial replication needs:
per-object sync degradation (arxiv 1303.7462) cannot be built or
validated without per-doc convergence and traffic measurement, and the
full-mesh redundancy ratio this ledger reports is the baseline number
partial replication will later improve.

One `DocLedger` per sync node (DocSet/EngineDocSet), attached lazily by
`of(doc_set)`. Hooks feed it:

- `sync/connection.py`: clock adverts received (`record_advert`),
  change-bearing sends (`record_send`), deliveries split into useful vs
  duplicate against the pre-apply local clock (`record_receive`), chaos/
  transport drops (`record_drop`);
- `sync/service.py`: per-doc admissions at flush time (`note_admit` —
  counts and stamps only; the flush hot path never pays a clock read);
- `sync/epochs.py`: buffered-entry visibility (`EpochIngestBuffer
  .doc_count`), read at export time.

**Bounded memory**: the top `AMTPU_DOCLEDGER_K` docs (default 128) are
tracked exactly in an LRU table; on overflow the least-recently-touched
entry that is NOT currently behind a peer is folded into one aggregate
bucket (counts survive, per-peer frontiers do not) and
`obs_doc_evictions` counts it. A lagging doc is only evicted when every
candidate lags — the table's job is precisely the lagging tail.

**Frontier reads are never blocking**: the local clock is peeked from the
service's lock-free snapshot read cache (`_clock_cache`, warm wherever
gossip is flowing) or a plain DocSet's doc object; a miss leaves the
doc's lag `None` rather than taking the service lock — this module's
snapshot section is embedded in flight-recorder dumps, which must render
WHILE the service lock is wedged. `refresh_clocks()` is the explicit
locked read for diagnostic callers (`perf explain`, bench config 12).

**Pure-state export**: `section()` (the `"docledger"` nested section of
`metrics.snapshot()`, keyed per node label) reads no wall clock — lag
seconds are stamped at mutation time (`lag_s` as of the last update,
`behind_since` absolute) so two back-to-back snapshots with no traffic
in between compare equal, and consumers (perf/explain.py, perf/top.py)
compute now-relative ages themselves. The export also refreshes the
`obs_doc_*` gauges, so the fleet collector and SLO engine see the
ledger through the ordinary registered-series surface.

Self-cost: every public mutation accumulates its wall time; the per-
export delta lands in `obs_doc_ledger_s`, and bench config 12 gates the
duty cycle (ledger seconds / traffic wall) under 2% — same posture as
the fleet collector's bound. `AMTPU_DOCLEDGER=0` disables the plane
entirely (one cached check; `of()` then returns None and every hook
no-ops on the None).
"""

from __future__ import annotations

import os
import threading
import time
import weakref

from ..utils import metrics
from . import tenantledger

#: exactly-tracked docs per ledger (AMTPU_DOCLEDGER_K)
DEFAULT_TOP_K = 128
#: docs exported per snapshot section (worst-lag first, then activity) —
#: the wire cost of a metrics pull stays bounded even at top-K 128
EXPORT_K = 32
#: eviction scan depth: how many LRU-side entries are examined for a
#: non-lagging victim before a lagging one is (reluctantly) evicted
EVICT_SCAN = 16
#: mutations between obs_doc_* gauge refreshes (the oplag percentile
#: cadence): gauges ride the mutation path, exports stay read-only
GAUGE_REFRESH = 32

_enabled: bool | None = None


def enabled() -> bool:
    global _enabled
    if _enabled is None:
        _enabled = os.environ.get("AMTPU_DOCLEDGER", "1") != "0"
    return _enabled


def _reload_for_tests() -> None:
    global _enabled
    _enabled = None


class _PeerView:
    """One (doc, peer) lane: the peer's advertised frontier and the
    traffic both directions have paid for this doc."""

    __slots__ = ("advert_clock", "advert_total", "last_advert_at",
                 "sent_changes", "last_send_at", "recv_useful",
                 "recv_duplicate", "last_recv_at", "bytes_sent",
                 "bytes_received", "drops", "unsubscribed", "sub_events")

    def __init__(self):
        self.advert_clock: dict[str, int] = {}
        self.advert_total = 0
        self.last_advert_at: float | None = None
        self.sent_changes = 0
        self.last_send_at: float | None = None
        self.recv_useful = 0
        self.recv_duplicate = 0
        self.last_recv_at: float | None = None
        self.bytes_sent = 0
        self.bytes_received = 0
        self.drops = 0
        # interest state (sync/connection.py subscribe/unsubscribe):
        # True while THIS side has explicitly unsubscribed the doc from
        # this peer — the peer's adverts keep the lag honest, and
        # `perf explain` reads the flag as doc_unsubscribed (chosen lag,
        # not a fault). sub_events counts toggles: churn evidence for
        # the sub_flap chaos class.
        self.unsubscribed = False
        self.sub_events = 0


class _DocEntry:
    __slots__ = ("peers", "admitted", "last_admit_at", "behind_since",
                 "behind_peer", "lag_s", "lag_changes", "touches")

    def __init__(self):
        self.peers: dict[str, _PeerView] = {}
        self.admitted = 0                 # changes admitted locally
        self.last_admit_at: float | None = None
        self.behind_since: float | None = None   # deficit>0 first seen
        self.behind_peer: str | None = None      # worst peer label
        self.lag_s = 0.0                  # as of the last update (pure)
        self.lag_changes = 0
        self.touches = 0


def _deficit(peer_clock: dict, local_clock: dict) -> int:
    """Changes the peer advertises that the local frontier lacks."""
    return sum(max(0, int(s) - int(local_clock.get(a, 0)))
               for a, s in peer_clock.items())


class DocLedger:
    """Per-node doc-granular convergence + traffic ledger."""

    def __init__(self, doc_set=None, label: str | None = None,
                 top_k: int | None = None):
        env_k = os.environ.get("AMTPU_DOCLEDGER_K")
        if top_k is None:
            try:
                top_k = int(env_k) if env_k else DEFAULT_TOP_K
            except ValueError:
                top_k = DEFAULT_TOP_K
        self.top_k = max(4, top_k)
        # Export cap: EXPORT_K (32) by default so a metrics pull stays
        # bounded — but an operator who EXPLICITLY sized the table
        # (AMTPU_DOCLEDGER_K) asked for that many docs, and silently
        # truncating the export at 32 would hide the tail they paid to
        # track. section(k=...) overrides per call (perf explain --k).
        self.export_k = (self.top_k if env_k
                         else min(EXPORT_K, self.top_k))
        self.label = label
        self._ds = (weakref.ref(doc_set) if doc_set is not None
                    else (lambda: None))
        self._lock = threading.Lock()
        self._docs: dict[str, _DocEntry] = {}    # insertion order = LRU
        self._conn_labels: dict[int, str] = {}   # id(conn) -> label
        self._conn_seq = 0
        # aggregate bucket: evicted docs' counts (frontiers are dropped —
        # the documented bounded-memory trade)
        self._agg = {"docs": 0, "sent_changes": 0, "recv_useful": 0,
                     "recv_duplicate": 0, "bytes_sent": 0,
                     "bytes_received": 0, "drops": 0, "admitted": 0}
        self._useful = 0
        self._duplicate = 0
        self._evictions = 0
        self._self_s = 0.0          # accumulated ledger wall time
        self._self_s_flushed = 0.0  # portion already observed to metrics
        self._active = False        # any mutation since construction/reset
        self._mutations = 0         # drives the periodic gauge refresh

    # -- peer identity -------------------------------------------------------

    def conn_label(self, conn) -> str:
        """Stable label for a Connection: the operator-set `peer_label`,
        the peer's self-reported node name (metrics pulls), else a
        positional `conn<k>`. Re-resolved per call so a label arriving
        later (first metrics answer) upgrades the lane in place."""
        explicit = getattr(conn, "peer_label", None) \
            or getattr(conn, "peer_node", None)
        if explicit:
            return str(explicit)
        key = id(conn)
        # allocation under the lock: every tcp reader thread lands here
        # before its record_* call, and an unlocked read-modify-write of
        # _conn_seq can hand two connections the same positional label
        # (found by graftlint shared-write-unlocked; regression-pinned
        # in tests/test_race_regressions.py). conn_label is always
        # called OUTSIDE the record_* critical sections, so the plain
        # Lock never re-enters.
        with self._lock:
            lbl = self._conn_labels.get(key)
            if lbl is None:
                self._conn_seq += 1
                lbl = self._conn_labels[key] = f"conn{self._conn_seq}"
        return lbl

    def forget_conn(self, conn) -> None:
        """Drop a closed connection's per-doc lanes (aggregate totals
        survive in the per-doc counters)."""
        lbl = self.conn_label(conn)
        t0 = time.perf_counter()
        with self._lock:
            self._conn_labels.pop(id(conn), None)
            for e in self._docs.values():
                e.peers.pop(lbl, None)
            self._self_s += time.perf_counter() - t0

    # -- local frontier peeks ------------------------------------------------

    def _peek_local_clock(self, doc_id: str) -> dict | None:
        """The local frontier WITHOUT locks: the service's snapshot read
        cache (GIL-atomic dict peek) or a plain DocSet's doc object.
        None when unknown — callers must treat lag as indeterminate, not
        zero."""
        ds = self._ds()
        if ds is None:
            return None
        cache = getattr(ds, "_clock_cache", None)
        if cache is not None:
            snap = cache.get(doc_id)
            if snap is not None:
                return dict(snap[1])
            # cache cold — but a doc this node does not HOLD at all has
            # frontier {} by definition (the whole advert is deficit):
            # that is the "peer has a doc we never received" stall shape
            idx = getattr(getattr(ds, "_resident", None), "doc_index",
                          None)
            if idx is not None and doc_id not in idx:
                return {}
            return None
        try:
            doc = ds.get_doc(doc_id)
            if doc is None:
                return {}       # unknown doc: everything is deficit
            return dict(doc._doc.opset.clock)
        except Exception:
            return None

    def refresh_clocks(self, doc_ids=None) -> int:
        """Diagnostic-path frontier refresh: read each tracked doc's
        clock through the service's ORDINARY (locking, cache-filling)
        read and restamp its lag. Never called from snapshot providers
        or dump paths — only from perf explain / bench drivers that own
        the calling context. Returns docs refreshed."""
        ds = self._ds()
        if ds is None:
            return 0
        with self._lock:
            targets = list(doc_ids) if doc_ids is not None \
                else list(self._docs)
        n = 0
        for d in targets:
            clock = None
            try:
                f = getattr(ds, "clock_of", None)
                if f is not None:
                    clock = f(d)
                else:
                    doc = ds.get_doc(d)
                    clock = dict(doc._doc.opset.clock) if doc else {}
            except KeyError:
                clock = {}      # unknown doc: frontier {} by definition
            except Exception:
                clock = None
            if clock is None:
                continue
            t0 = time.perf_counter()
            with self._lock:
                e = self._docs.get(d)
                if e is not None:
                    self._restamp_lag_locked(e, dict(clock),
                                             time.time())
                    n += 1
                self._self_s += time.perf_counter() - t0
        return n

    # -- mutation hooks ------------------------------------------------------

    def _entry_locked(self, doc_id: str) -> _DocEntry:
        e = self._docs.get(doc_id)
        if e is None:
            e = self._docs[doc_id] = _DocEntry()
            if len(self._docs) > self.top_k:
                self._evict_locked()
        else:
            # LRU touch: move to the MRU end (dicts keep insertion order)
            self._docs[doc_id] = self._docs.pop(doc_id)
        e.touches += 1
        if not self._active:
            # first mutation since construction or a metrics.reset():
            # (re-)register so the snapshot section sees this node again.
            # Lock order self._lock -> _registry_lock only; _reset_all
            # never takes a ledger lock while holding the registry lock.
            self._active = True
            with _registry_lock:
                _registry.add(self)
        self._mutations += 1
        if self._mutations % GAUGE_REFRESH == 0:
            self._refresh_gauges_locked()
        return e

    def _refresh_gauges_locked(self) -> None:
        """Periodic registered-series refresh, on the MUTATION path (every
        GAUGE_REFRESH records, like oplag's percentile cadence) — never at
        export time, so snapshot() stays read-only and two idle snapshots
        compare equal. Also flushes the self-time delta into the
        obs_doc_ledger_s histogram."""
        lags = sorted(e.lag_s for e in self._docs.values())
        n = len(lags)
        if n:
            metrics.gauge("obs_doc_converge_lag_p50_s",
                          round(lags[n // 2], 6))
            metrics.gauge("obs_doc_converge_lag_p99_s",
                          round(lags[min(n - 1, int(0.99 * (n - 1)))], 6))
            metrics.gauge("obs_doc_converge_lag_max_s",
                          round(lags[-1], 6))
        metrics.gauge("obs_doc_tracked", n)
        metrics.gauge("obs_doc_lagging",
                      sum(1 for e in self._docs.values()
                          if e.behind_since is not None))
        if self._useful:
            metrics.gauge("obs_doc_redundancy_ratio",
                          round(self._duplicate / self._useful, 4))
        delta = self._self_s - self._self_s_flushed
        self._self_s_flushed = self._self_s
        if delta > 0:
            metrics.observe("obs_doc_ledger_s", delta)

    def _evict_locked(self) -> None:
        """Fold one entry into the aggregate bucket: the least-recently-
        touched NON-lagging doc within the scan window; only when every
        scanned candidate is behind does a lagging one go (the table
        exists to hold the lagging tail)."""
        victim = None
        for i, (d, e) in enumerate(self._docs.items()):
            if i >= EVICT_SCAN:
                break
            if e.behind_since is None:
                victim = d
                break
            if victim is None:
                victim = d
        if victim is None:                      # empty table (can't be)
            return
        e = self._docs.pop(victim)
        a = self._agg
        a["docs"] += 1
        a["admitted"] += e.admitted
        for pv in e.peers.values():
            a["sent_changes"] += pv.sent_changes
            a["recv_useful"] += pv.recv_useful
            a["recv_duplicate"] += pv.recv_duplicate
            a["bytes_sent"] += pv.bytes_sent
            a["bytes_received"] += pv.bytes_received
            a["drops"] += pv.drops
        self._evictions += 1
        metrics.bump("obs_doc_evictions")

    def _restamp_lag_locked(self, e: _DocEntry, local_clock: dict | None,
                            now: float) -> None:
        """Recompute the entry's deficit vs every peer advert against a
        just-peeked local clock, stamping lag_s AT THIS MOMENT (exports
        stay pure). local_clock=None leaves the previous stamp."""
        if local_clock is None:
            return
        worst = 0
        worst_peer = None
        for lbl, pv in e.peers.items():
            d = _deficit(pv.advert_clock, local_clock)
            if d > worst:
                worst, worst_peer = d, lbl
        e.lag_changes = worst
        if worst > 0:
            if e.behind_since is None:
                e.behind_since = now
            e.behind_peer = worst_peer
            e.lag_s = max(0.0, now - e.behind_since)
        else:
            e.behind_since = None
            e.behind_peer = None
            e.lag_s = 0.0

    def record_advert(self, doc_id: str, conn, clock: dict) -> None:
        """A peer advertised its clock for a doc (every received
        protocol message carries one)."""
        t0 = time.perf_counter()
        now = time.time()
        lbl = self.conn_label(conn)
        local = self._peek_local_clock(doc_id)
        with self._lock:
            e = self._entry_locked(doc_id)
            pv = e.peers.get(lbl)
            if pv is None:
                pv = e.peers[lbl] = _PeerView()
            for a, s in (clock or {}).items():
                if int(s) > pv.advert_clock.get(a, 0):
                    pv.advert_clock[a] = int(s)
            pv.advert_total = sum(pv.advert_clock.values())
            pv.last_advert_at = now
            self._restamp_lag_locked(e, local, now)
            lag = e.lag_s
            self._self_s += time.perf_counter() - t0
        # tenant lane: the freshly restamped converge lag feeds the
        # per-tenant p99 ring (outside our lock — tenantledger is a leaf)
        tenantledger.note_lag(doc_id, lag)

    def record_send(self, doc_id: str, conn, n_changes: int,
                    nbytes: int | None = None) -> None:
        """We shipped changes (or an advert, n_changes=0) for a doc."""
        t0 = time.perf_counter()
        lbl = self.conn_label(conn)
        with self._lock:
            e = self._entry_locked(doc_id)
            pv = e.peers.get(lbl)
            if pv is None:
                pv = e.peers[lbl] = _PeerView()
            if n_changes:
                pv.sent_changes += int(n_changes)
                pv.last_send_at = time.time()
            if nbytes:
                pv.bytes_sent += int(nbytes)
            self._self_s += time.perf_counter() - t0
        tenantledger.note_wire(doc_id, sent=int(n_changes or 0),
                               bytes_sent=int(nbytes or 0))

    def record_receive(self, doc_id: str, conn, useful: int, dup: int,
                       nbytes: int | None = None) -> None:
        """Changes arrived for a doc, already split useful/duplicate
        against the pre-apply local clock (sync/connection.py)."""
        t0 = time.perf_counter()
        now = time.time()
        lbl = self.conn_label(conn)
        with self._lock:
            e = self._entry_locked(doc_id)
            pv = e.peers.get(lbl)
            if pv is None:
                pv = e.peers[lbl] = _PeerView()
            pv.recv_useful += int(useful)
            pv.recv_duplicate += int(dup)
            pv.last_recv_at = now
            if nbytes:
                pv.bytes_received += int(nbytes)
            self._useful += int(useful)
            self._duplicate += int(dup)
            self._self_s += time.perf_counter() - t0
        tenantledger.note_wire(doc_id, useful=int(useful), dup=int(dup),
                               bytes_recv=int(nbytes or 0))

    def record_drop(self, doc_id: str, conn) -> None:
        """An outgoing change-bearing message for this doc was dropped
        before the wire (transport failure or injected chaos)."""
        t0 = time.perf_counter()
        lbl = self.conn_label(conn)
        with self._lock:
            e = self._entry_locked(doc_id)
            pv = e.peers.get(lbl)
            if pv is None:
                pv = e.peers[lbl] = _PeerView()
            pv.drops += 1
            self._self_s += time.perf_counter() - t0
        tenantledger.note_wire(doc_id, drops=1)

    def record_sub(self, doc_id: str, conn, subscribed: bool) -> None:
        """This side subscribed (True) or unsubscribed (False) the doc
        from the peer (sync/connection.py subscribe()). The lane flag
        lets `perf explain` name a lagging-but-unsubscribed doc
        doc_unsubscribed instead of flagging a stall; the toggle count
        is the sub_flap churn evidence."""
        t0 = time.perf_counter()
        lbl = self.conn_label(conn)
        with self._lock:
            e = self._entry_locked(doc_id)
            pv = e.peers.get(lbl)
            if pv is None:
                pv = e.peers[lbl] = _PeerView()
            pv.unsubscribed = not subscribed
            pv.sub_events += 1
            self._self_s += time.perf_counter() - t0

    def note_admit(self, doc_id: str, n_changes: int) -> None:
        """A flush admitted changes for a doc. Called under the service
        lock — counts and stamps ONLY (dict math, no clock reads: the
        ~18%-of-a-fleet-round StaleView cost stays off the flush). The
        lag restamp happens opportunistically from the read cache."""
        t0 = time.perf_counter()
        now = time.time()
        with self._lock:
            e = self._entry_locked(doc_id)
            e.admitted += int(n_changes)
            e.last_admit_at = now
            # cheap catch-up check: the post-flush clock is not in the
            # read cache yet (the flush just invalidated it), so only a
            # later advert/refresh can clear the lag exactly — but an
            # admission at least refreshes the stamp time for a doc
            # already known behind, keeping lag_s honest while traffic
            # flows.
            if e.behind_since is not None:
                e.lag_s = max(0.0, now - e.behind_since)
            self._self_s += time.perf_counter() - t0

    # -- export --------------------------------------------------------------

    def _buffered(self, doc_id: str) -> int:
        """Entries parked in the service's epoch ingest buffer for this
        doc (lock-free peek; 0 when the service has no epoch plane)."""
        ds = self._ds()
        buf = getattr(ds, "_epoch", None) if ds is not None else None
        if buf is None:
            return 0
        try:
            return buf.doc_count(doc_id)
        except Exception:
            return 0

    def redundancy(self) -> dict:
        with self._lock:
            u, d = self._useful, self._duplicate
        return {"useful": u, "duplicate": d,
                "ratio": (round(d / u, 4) if u else None)}

    def self_seconds(self) -> float:
        """Total accumulated ledger self-time (the duty-cycle feed)."""
        with self._lock:
            return self._self_s

    def lag_percentiles(self) -> dict:
        """p50/p99/max of lag_s (as-of-last-update stamps) over tracked
        docs, plus the lagging count. Pure state."""
        with self._lock:
            lags = sorted(e.lag_s for e in self._docs.values())
            lagging = sum(1 for e in self._docs.values()
                          if e.behind_since is not None)
        if not lags:
            return {"p50_s": None, "p99_s": None, "max_s": None,
                    "lagging": 0, "docs": 0}
        n = len(lags)
        return {"p50_s": round(lags[n // 2], 6),
                "p99_s": round(lags[min(n - 1, int(0.99 * (n - 1)))], 6),
                "max_s": round(lags[-1], 6),
                "lagging": lagging, "docs": n}

    def _catchup(self) -> None:
        """Clear resolved deficits before export: a doc marked behind may
        have caught up since the last advert (the advert arrives BEFORE
        the changes it describes, so the behind mark is always set first
        and must be re-checked). Lock-free clock peeks only, and the
        restamp is purely state-dependent — no wall-clock reads, so two
        idle back-to-back snapshots stay equal."""
        with self._lock:
            behind = [d for d, e in self._docs.items()
                      if e.behind_since is not None]
        for d in behind:
            local = self._peek_local_clock(d)
            if local is None:
                continue
            with self._lock:
                e = self._docs.get(d)
                if e is None:
                    continue
                worst, worst_peer = 0, None
                for lbl, pv in e.peers.items():
                    dd = _deficit(pv.advert_clock, local)
                    if dd > worst:
                        worst, worst_peer = dd, lbl
                if worst == 0:
                    e.behind_since = None
                    e.behind_peer = None
                    e.lag_s = 0.0
                    e.lag_changes = 0
                else:
                    e.lag_changes = worst
                    e.behind_peer = worst_peer

    def section(self, k: int | None = None) -> dict | None:
        """This ledger's share of the `"docledger"` snapshot section:
        pure state (absolute stamps, as-of-update lag), worst-lag-first
        doc export capped at `k` (default: export_k — EXPORT_K unless
        AMTPU_DOCLEDGER_K was explicitly set, see __init__), aggregate
        bucket, redundancy. `truncated` counts the tracked docs the cap
        cut (perf top's hot-doc panel discloses it). Returns None when
        nothing was ever recorded (a freshly reset or idle node adds no
        section).

        The export is READ-ONLY against the metrics registry (gauges and
        the obs_doc_ledger_s histogram refresh on the mutation path,
        _refresh_gauges_locked) and its cost is not accumulated into the
        self-time account: obs_doc_ledger_s bounds the hot-path tax (the
        hooks riding every message and flush — the duty-cycle gate's
        subject) while exports happen on scrape ticks whose cost the
        collector bound already covers. Both choices also keep two idle
        back-to-back snapshots bit-equal."""
        self._catchup()
        with self._lock:
            if not self._active:
                return None
            entries = list(self._docs.items())
            agg = dict(self._agg)
            evictions = self._evictions
            u, dup = self._useful, self._duplicate
        # worst lag first, then recent activity — a stalled doc is always
        # exported, however cold
        entries.sort(key=lambda kv: (-(kv[1].lag_changes or 0),
                                     -(kv[1].touches)))
        cap = self.export_k if k is None else max(1, int(k))
        docs_out = {}
        for d, e in entries[:cap]:
            peers = {}
            for lbl, pv in e.peers.items():
                peers[lbl] = {
                    "advert_total": pv.advert_total,
                    "advert_clock": dict(pv.advert_clock),
                    "last_advert_at": pv.last_advert_at,
                    "sent": pv.sent_changes,
                    "last_send_at": pv.last_send_at,
                    "recv_useful": pv.recv_useful,
                    "recv_duplicate": pv.recv_duplicate,
                    "last_recv_at": pv.last_recv_at,
                    "bytes_sent": pv.bytes_sent,
                    "bytes_received": pv.bytes_received,
                    "drops": pv.drops,
                }
                # interest lane state: exported only when it carries
                # information (keeps idle-snapshot pins byte-stable)
                if pv.unsubscribed:
                    peers[lbl]["unsubscribed"] = True
                if pv.sub_events:
                    peers[lbl]["sub_events"] = pv.sub_events
            docs_out[d] = {
                "admitted": e.admitted,
                "last_admit_at": e.last_admit_at,
                "buffered": self._buffered(d),
                "lag_changes": e.lag_changes,
                "lag_s": round(e.lag_s, 6),
                "behind_since": e.behind_since,
                "behind_peer": e.behind_peer,
                "peers": peers,
            }
            # tenant label on the lane (r18): derivation only — the
            # per-tenant aggregates live in the tenantledger section.
            # Absent when the tenant plane is disabled, so pinned
            # pre-tenancy exports stay byte-identical.
            if tenantledger.enabled():
                docs_out[d]["tenant"] = tenantledger.tenant_of(d)
        pct = self.lag_percentiles()
        return {
            "label": self.label or metrics.node_name() or "local",
            "tracked": len(entries),
            "top_k": self.top_k,
            "exported": len(docs_out),
            "truncated": max(0, len(entries) - len(docs_out)),
            "evictions": evictions,
            "aggregate": agg,
            "redundancy": {"useful": u, "duplicate": dup,
                           "ratio": (round(dup / u, 4) if u else None)},
            "lag": pct,
            "self_s": round(self.self_seconds(), 6),
            "docs": docs_out,
        }

    def reset(self) -> None:
        with self._lock:
            self._docs.clear()
            self._agg = {k: 0 for k in self._agg}
            self._useful = self._duplicate = 0
            self._evictions = 0
            self._self_s = self._self_s_flushed = 0.0
            self._active = False


# ---------------------------------------------------------------------------
# per-process registry (the "docledger" snapshot section merges every
# live node's ledger, keyed by label — one-service-per-process fleets
# export exactly one)

_registry: "weakref.WeakSet[DocLedger]" = weakref.WeakSet()
_registry_lock = threading.Lock()
_create_lock = threading.Lock()
_module_fallback: DocLedger | None = None


def of(doc_set, create: bool = True,
       label: str | None = None) -> DocLedger | None:
    """The doc_set's ledger, creating and registering one lazily. None
    when the plane is disabled (AMTPU_DOCLEDGER=0) or create=False and
    none exists. Falls back to one module-level ledger for doc_sets that
    reject attribute assignment (__slots__).

    Creation is double-checked under _create_lock: two Connections
    attaching to the same plain DocSet from concurrent accept threads
    must share ONE ledger — split ledgers would halve every lane and
    break the cross-node label joins."""
    if not enabled():
        return None
    led = getattr(doc_set, "_doc_ledger", None)
    if led is not None or not create:
        return led
    with _create_lock:
        led = getattr(doc_set, "_doc_ledger", None)
        if led is None:
            led = DocLedger(doc_set, label=label)
            try:
                doc_set._doc_ledger = led
            except AttributeError:
                global _module_fallback
                if _module_fallback is None:
                    _module_fallback = led
                led = _module_fallback
    with _registry_lock:
        _registry.add(led)
    return led


def detach(doc_set) -> None:
    """Unregister a closing service's ledger (its section disappears
    from future snapshots; the object keeps working for late callers)."""
    led = getattr(doc_set, "_doc_ledger", None)
    if led is not None:
        with _registry_lock:
            _registry.discard(led)


def ledgers() -> list[DocLedger]:
    with _registry_lock:
        return list(_registry)


def snapshot_section() -> dict | None:
    """The `"docledger"` section: every live, active ledger keyed by its
    node label (collisions disambiguated positionally). None when no
    ledger has recorded anything — an idle process exports nothing."""
    out: dict = {}
    for led in ledgers():
        sec = led.section()
        if not sec:
            continue
        key = sec["label"]
        k, i = key, 1
        while k in out:
            i += 1
            k = f"{key}#{i}"
        out[k] = sec
    return {"nodes": out} if out else None


def _reset_all() -> None:
    global _module_fallback
    with _registry_lock:
        leds = list(_registry)
        _registry.clear()
    for led in leds:        # outside the registry lock (led.reset takes
        led.reset()         # the ledger lock — never nest the two here)
    _module_fallback = None


metrics.register_snapshot_section("docledger", snapshot_section)
metrics.register_reset_hook(_reset_all)
