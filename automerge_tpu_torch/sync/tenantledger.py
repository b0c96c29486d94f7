"""Per-tenant attribution ledger: who pays for the fleet, and who waits.

Multi-tenant sharded serving needs what every scaling step needed
first: a measurement substrate. Before this module no code in
the tree knew what a *tenant* was — a hot tenant's cost (wire bytes,
dispatch lanes, shed ingress) was invisible until a quiet tenant's
converge-p99 breached, exactly the degrade-per-object regime of arxiv
1303.7462 applied per-tenant, with Jiffy's batch-amortization argument
(arxiv 2102.01044) saying the shared-lane costs must be *attributed*
before they can be divided fairly.

**Tenant identity** is derived from the doc-id namespace: with the
default prefix rule (`AMTPU_TENANT_PREFIX`, default ``tenant/``), a doc
named ``tenant/<id>/...`` belongs to tenant ``<id>``; every other doc
belongs to ``_default``. Zero-config fleets therefore collapse to one
``_default`` bucket and behave byte-identically — the rule never touches
doc ids, routing, or admission, it only labels the account.

One process-global ledger (tenancy is a fleet property, like dispatch
routing). Hooks feed it:

- `sync/service.py` stamps per-tenant **ingress** at both admission
  sites (`note_ingress` — alongside the doc ledger's `note_admit`) and
  hands each coalesced flush round's per-tenant dirty-doc counts to the
  dispatch ledger (`round_tenants`), whose round fold forwards the
  round's **dispatch/padding shares** here (`note_round`, attributed
  proportionally by dirty-doc count);
- `sync/docledger.py` forwards its wire lanes (`note_wire` — bytes,
  useful-vs-duplicate deliveries, drops) and converge-lag restamps
  (`note_lag`), so the per-doc plane's lanes carry a tenant label;
- `sync/epochs.py` splits the governor's shed/delay decisions per
  tenant (`note_shed` — also the `sync_tenant_shed_*` labeled series).

**Bounded memory**: at most `MAX_TENANTS` tenants are tracked exactly;
overflow folds into one ``_overflow`` bucket (counts survive, identity
does not) and is disclosed in the export (`overflow_tenants`). Per-tenant
converge-lag history is a `LAG_RING`-deep deque of mutation-time stamps.

**Pure-state export**: `section()` reads no wall clock — lag samples and
stamps are recorded at mutation time, so two idle back-to-back snapshots
compare equal. The `obs_tenant_*` gauges and the `obs_tenant_ledger_s`
self-time histogram refresh on the MUTATION path (every `GAUGE_REFRESH`
mutations — the docledger cadence), never at export.

Self-cost: hook bookkeeping accumulates into `self_seconds()`; bench
config 18 gates the duty cycle (ledger seconds / traffic wall) under 2%
(perf/history.TENANT_LEDGER_BUDGET_PCT). `AMTPU_TENANTLEDGER=0` disables
the plane entirely: one cached check, every hook returns before
allocating, and config 18 asserts the disabled path is behavior-
identical (equal doc hashes, zero tenants recorded).

Consumed by `perf tenant` (perf/tenantplane.py), the `perf top` tenant
band, the `tenant_converge_p99` SLO family (perf/slo.py), and the
doctor's `tenant_hot` cause (docs/OBSERVABILITY.md r18).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

from ..utils import metrics

#: the doc id every non-namespaced doc is attributed to
DEFAULT_TENANT = "_default"
#: the fold bucket identity once MAX_TENANTS distinct tenants exist
OVERFLOW_TENANT = "_overflow"
#: tenants tracked exactly (operator-bounded; overflow folds, disclosed)
MAX_TENANTS = 64
#: per-tenant converge-lag samples retained (mutation-time stamps)
LAG_RING = 64
#: tenants exported per snapshot section (hottest-ingress first)
EXPORT_TENANTS = 32
#: ledger mutations between obs_tenant_* gauge refreshes
GAUGE_REFRESH = 32

_enabled: bool | None = None
_prefix: str | None = None


def enabled() -> bool:
    global _enabled
    if _enabled is None:
        _enabled = os.environ.get("AMTPU_TENANTLEDGER", "1") != "0"
    return _enabled


def prefix() -> str:
    global _prefix
    if _prefix is None:
        _prefix = os.environ.get("AMTPU_TENANT_PREFIX") or "tenant/"
    return _prefix


def _reload_for_tests() -> None:
    global _enabled, _prefix
    _enabled = None
    _prefix = None


def tenant_of(doc_id: str) -> str:
    """The configurable prefix rule: ``tenant/<id>/...`` -> ``<id>``,
    everything else -> ``_default``. Pure string math — never touches
    routing, admission, or the doc itself."""
    p = prefix()
    if doc_id.startswith(p):
        tid = doc_id[len(p):].split("/", 1)[0]
        if tid:
            return tid
    return DEFAULT_TENANT


class _Tenant:
    """One tenant's account: ingress, wire, governor, dispatch shares,
    and the converge-lag sample ring."""

    __slots__ = ("admitted", "admit_events", "last_admit_at",
                 "sent_changes", "bytes_sent", "recv_useful",
                 "recv_duplicate", "bytes_received", "drops",
                 "shed_dropped", "shed_delayed", "delayed_s",
                 "rounds", "dirty_docs", "dispatch_share",
                 "padded_share", "logical_share", "wall_share_s",
                 "lags", "lag_max_s")

    def __init__(self):
        self.admitted = 0
        self.admit_events = 0
        self.last_admit_at: float | None = None
        self.sent_changes = 0
        self.bytes_sent = 0
        self.recv_useful = 0
        self.recv_duplicate = 0
        self.bytes_received = 0
        self.drops = 0
        self.shed_dropped = 0
        self.shed_delayed = 0
        self.delayed_s = 0.0
        self.rounds = 0
        self.dirty_docs = 0
        self.dispatch_share = 0.0
        self.padded_share = 0.0
        self.logical_share = 0.0
        self.wall_share_s = 0.0
        self.lags: deque = deque(maxlen=LAG_RING)
        self.lag_max_s = 0.0


def _lag_pct(lags) -> dict:
    vals = sorted(lags)
    if not vals:
        return {"p50_s": None, "p99_s": None}
    n = len(vals)
    return {"p50_s": round(vals[n // 2], 6),
            "p99_s": round(vals[min(n - 1, int(0.99 * (n - 1)))], 6)}


class TenantLedger:
    """Process-global per-tenant cost/latency/isolation account."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tenants: dict[str, _Tenant] = {}
        self._overflowed = 0        # distinct ids folded into _overflow
        self._admitted_total = 0
        self._rounds_total = 0
        self._dispatch_total = 0.0
        self._padded_total = 0
        self._logical_total = 0
        self._wall_total_s = 0.0
        self._self_s = 0.0
        self._self_s_flushed = 0.0
        self._active = False
        self._mutations = 0

    # -- table ---------------------------------------------------------------

    def _tenant_locked(self, tid: str) -> _Tenant:
        t = self._tenants.get(tid)
        if t is None:
            if (len(self._tenants) >= MAX_TENANTS
                    and tid != OVERFLOW_TENANT):
                self._overflowed += 1
                metrics.bump("sync_tenant_overflow")
                return self._tenant_locked(OVERFLOW_TENANT)
            t = self._tenants[tid] = _Tenant()
        self._active = True
        self._mutations += 1
        if self._mutations % GAUGE_REFRESH == 0:
            self._refresh_gauges_locked()
        return t

    def _refresh_gauges_locked(self) -> None:
        """Periodic registered-series refresh on the MUTATION path —
        never at export time, so snapshot() stays read-only and two idle
        snapshots compare equal. Also flushes the self-time delta into
        the obs_tenant_ledger_s histogram."""
        metrics.gauge("obs_tenant_tracked", len(self._tenants))
        total = self._admitted_total
        for tid, t in self._tenants.items():
            if total:
                metrics.gauge("obs_tenant_ingress_share_pct",
                              round(100.0 * t.admitted / total, 3),
                              tenant=tid)
            p99 = _lag_pct(t.lags)["p99_s"]
            if p99 is not None:
                metrics.gauge("obs_tenant_converge_lag_p99_s", p99,
                              tenant=tid)
        delta = self._self_s - self._self_s_flushed
        self._self_s_flushed = self._self_s
        if delta > 0:
            metrics.observe("obs_tenant_ledger_s", delta)

    # -- mutation hooks ------------------------------------------------------

    def note_ingress(self, doc_id: str, n_changes: int) -> None:
        if not enabled() or n_changes <= 0:
            return
        t0 = time.perf_counter()
        tid = tenant_of(doc_id)
        now = time.time()
        with self._lock:
            t = self._tenant_locked(tid)
            t.admitted += int(n_changes)
            t.admit_events += 1
            t.last_admit_at = now
            self._admitted_total += int(n_changes)
            self._self_s += time.perf_counter() - t0

    def note_wire(self, doc_id: str, sent: int = 0, bytes_sent: int = 0,
                  useful: int = 0, dup: int = 0, bytes_recv: int = 0,
                  drops: int = 0) -> None:
        if not enabled():
            return
        t0 = time.perf_counter()
        tid = tenant_of(doc_id)
        with self._lock:
            t = self._tenant_locked(tid)
            t.sent_changes += int(sent)
            t.bytes_sent += int(bytes_sent)
            t.recv_useful += int(useful)
            t.recv_duplicate += int(dup)
            t.bytes_received += int(bytes_recv)
            t.drops += int(drops)
            self._self_s += time.perf_counter() - t0

    def note_lag(self, doc_id: str, lag_s: float) -> None:
        """A converge-lag restamp for one doc (sync/docledger.py) —
        stamped value, so the export stays pure."""
        if not enabled():
            return
        t0 = time.perf_counter()
        tid = tenant_of(doc_id)
        with self._lock:
            t = self._tenant_locked(tid)
            t.lags.append(float(lag_s))
            if lag_s > t.lag_max_s:
                t.lag_max_s = float(lag_s)
            self._self_s += time.perf_counter() - t0

    def note_shed(self, doc_id: str, delayed: bool,
                  delay_s: float = 0.0) -> None:
        """The governor split: one delayed (True) or shed (False)
        admission decision for this doc's tenant (sync/epochs.py)."""
        if not enabled():
            return
        t0 = time.perf_counter()
        tid = tenant_of(doc_id)
        if delayed:
            metrics.bump("sync_tenant_shed_delayed", tenant=tid)
        else:
            metrics.bump("sync_tenant_shed_dropped", tenant=tid)
        with self._lock:
            t = self._tenant_locked(tid)
            if delayed:
                t.shed_delayed += 1
                t.delayed_s += float(delay_s)
            else:
                t.shed_dropped += 1
            self._self_s += time.perf_counter() - t0

    def note_round(self, tenant_docs: dict, folded: dict,
                   label: str | None = None) -> None:
        """One folded flush round's per-tenant dispatch/padding shares
        (engine/dispatchledger.py round fold): the round's dispatches,
        padded/logical lanes, and wall are attributed proportionally —
        Jiffy's amortized batch cost, divided by who filled the batch.

        Pre-r20 the split assumed each dispatch served one doc's dirty
        fraction (dirty-doc count as weight). A megabatched round fuses
        docs of very different shapes into shared dispatches, so when the
        fold carries the megabatch occupancy summary (folded["mega"]
        ["tenant_lanes"], engine/dispatch.py apply_round_adaptive), the
        padded/logical/wall costs divide by each tenant's actual padded-
        LANE occupancy instead — a tenant whose docs landed in big
        buckets pays for big buckets. Dispatch counts stay doc-weighted
        (a fused dispatch is shared headcount, not lane area). Both
        weightings are normalized, so per-tenant shares still sum to the
        fleet totals accumulated here (perf/tenantplane.py
        attribution_check proves it per snapshot)."""
        if not enabled() or not tenant_docs:
            return
        t0 = time.perf_counter()
        total = sum(tenant_docs.values()) or 1
        dispatches = ((folded.get("dispatches") or 0)
                      + (folded.get("ambient") or 0))
        padded = folded.get("padded") or 0
        logical = folded.get("logical") or 0
        wall = folded.get("wall_s") or 0.0
        lanes = (folded.get("mega") or {}).get("tenant_lanes") or None
        # lane-occupancy weights for the area-like costs; tenants absent
        # from the mega summary (their docs reconciled on a classic path
        # this round) fall back to doc weight, and the mixed vector is
        # re-normalized so shares still sum exactly to the fleet totals
        lweight = {}
        if lanes:
            lanes_total = sum(lanes.values()) or 1.0
            for tid, n in tenant_docs.items():
                lweight[tid] = (lanes[tid] / lanes_total if tid in lanes
                                else n / total)
            lsum = sum(lweight.values()) or 1.0
            lweight = {tid: w / lsum for tid, w in lweight.items()}
        with self._lock:
            for tid, n in tenant_docs.items():
                share = n / total
                lshare = lweight.get(tid, share)
                t = self._tenant_locked(tid)
                t.rounds += 1
                t.dirty_docs += int(n)
                t.dispatch_share += dispatches * share
                t.padded_share += padded * lshare
                t.logical_share += logical * lshare
                t.wall_share_s += wall * lshare
            self._rounds_total += 1
            self._dispatch_total += dispatches
            self._padded_total += padded
            self._logical_total += logical
            self._wall_total_s += wall
            self._self_s += time.perf_counter() - t0

    def add_self(self, seconds: float) -> None:
        """Fold externally measured bookkeeping (round_tenants) into the
        self-time account the duty-cycle gate bounds."""
        with self._lock:
            self._self_s += seconds

    # -- export --------------------------------------------------------------

    def self_seconds(self) -> float:
        with self._lock:
            return self._self_s

    def section(self) -> dict | None:
        """This ledger's share of the `"tenantledger"` snapshot section:
        per-tenant accounts ranked hottest-ingress first (capped at
        EXPORT_TENANTS, truncation disclosed), plus fleet totals the
        attribution must sum back to (the config-18 1% gate). Pure
        state; read-only against the metrics registry. None when nothing
        was ever recorded."""
        with self._lock:
            if not self._active:
                return None
            entries = sorted(self._tenants.items(),
                             key=lambda kv: (-kv[1].admitted,
                                             -kv[1].recv_useful, kv[0]))
            total = self._admitted_total
            tenants = {}
            for tid, t in entries[:EXPORT_TENANTS]:
                tenants[tid] = {
                    "admitted": t.admitted,
                    "admit_events": t.admit_events,
                    "last_admit_at": t.last_admit_at,
                    "ingress_share_pct": (
                        round(100.0 * t.admitted / total, 3)
                        if total else None),
                    "sent": t.sent_changes,
                    "bytes_sent": t.bytes_sent,
                    "recv_useful": t.recv_useful,
                    "recv_duplicate": t.recv_duplicate,
                    "bytes_received": t.bytes_received,
                    "drops": t.drops,
                    "shed_dropped": t.shed_dropped,
                    "shed_delayed": t.shed_delayed,
                    "delayed_s": round(t.delayed_s, 6),
                    "rounds": t.rounds,
                    "dirty_docs": t.dirty_docs,
                    "dispatch_share": round(t.dispatch_share, 4),
                    "padded_share": round(t.padded_share, 2),
                    "logical_share": round(t.logical_share, 2),
                    "wall_share_s": round(t.wall_share_s, 6),
                    "lag": dict(_lag_pct(t.lags),
                                max_s=round(t.lag_max_s, 6)),
                }
            out = {
                "label": metrics.node_name() or "local",
                "prefix": prefix(),
                "tracked": len(self._tenants),
                "truncated": max(0, len(self._tenants) - len(tenants)),
                "overflow_tenants": self._overflowed,
                "admitted_total": total,
                "rounds_total": self._rounds_total,
                "dispatch_total": round(self._dispatch_total, 4),
                "padded_total": self._padded_total,
                "logical_total": self._logical_total,
                "wall_total_s": round(self._wall_total_s, 6),
                "self_s": round(self._self_s, 6),
                "tenants": tenants,
            }
        return out

    def reset(self) -> None:
        with self._lock:
            self._tenants.clear()
            self._overflowed = 0
            self._admitted_total = 0
            self._rounds_total = 0
            self._dispatch_total = 0.0
            self._padded_total = 0
            self._logical_total = 0
            self._wall_total_s = 0.0
            self._self_s = self._self_s_flushed = 0.0
            self._active = False
            self._mutations = 0


_ledger = TenantLedger()


def ledger() -> TenantLedger:
    return _ledger


# ---------------------------------------------------------------------------
# module-level hooks (the only API call sites use; every one is a single
# cached check when AMTPU_TENANTLEDGER=0)


def note_ingress(doc_id: str, n_changes: int) -> None:
    _ledger.note_ingress(doc_id, n_changes)


def note_wire(doc_id: str, **kw) -> None:
    _ledger.note_wire(doc_id, **kw)


def note_lag(doc_id: str, lag_s: float) -> None:
    _ledger.note_lag(doc_id, lag_s)


def note_shed(doc_id: str, delayed: bool, delay_s: float = 0.0) -> None:
    _ledger.note_shed(doc_id, delayed, delay_s)


def note_round(tenant_docs: dict, folded: dict,
               label: str | None = None) -> None:
    _ledger.note_round(tenant_docs, folded, label=label)


def round_tenants(doc_ids) -> dict | None:
    """Per-tenant dirty-doc counts for one flush round's pending set —
    what sync/service.py hands to dispatchledger.round_scope(tenants=).
    None when the plane is disabled, so the dispatch ledger's folded
    rounds stay byte-identical with tenancy off."""
    if not enabled():
        return None
    t0 = time.perf_counter()
    out: dict[str, int] = {}
    for d in doc_ids:
        tid = tenant_of(d)
        out[tid] = out.get(tid, 0) + 1
    _ledger.add_self(time.perf_counter() - t0)
    return out


# ---------------------------------------------------------------------------
# snapshot section (the {"nodes": {label: sec}} shape the doc/dispatch
# ledgers export, so fleet/doctor/top consumers walk all three planes
# identically)


def snapshot_section() -> dict | None:
    sec = _ledger.section()
    if not sec:
        return None
    return {"nodes": {sec["label"]: sec}}


def _reset_all() -> None:
    _ledger.reset()


metrics.register_snapshot_section("tenantledger", snapshot_section)
metrics.register_reset_hook(_reset_all)
