"""Dispatch-efficiency ledger: what every kernel call of the engines cost,
and why (the port of `automerge_tpu/engine/dispatchledger.py`).

It records how many dispatches a dirty doc costs per flush round (the
**amplification** the megabatch route divides), how much of each padded
tensor is wasted lanes, and where the cost model routed. One
process-global ledger (dispatch routing is process-level state). Hooks
feed it:

- the sync service (`sync/service.py`) wraps each coalesced flush in
  `round_scope(dirty docs, tenants=...)`, the boundary every rollup is
  keyed on;
- `engine/dispatch.py::apply_round_adaptive` wraps each fused bucket
  launch in `call_scope("rows_mega", ...)` and reports the round's
  occupancy through `note_megabatch`;
- `engine/resident_rows.py` wraps its fixed-backend device dispatches
  (round scans, final applies, hash reconciles) the same way;
- `note_jit(kernel, retraced)` lands a compile-cache status on the OPEN
  call scope, and a dispatch with no scope open still counts as an
  *ambient* entry, so nothing escapes the account. (Its caller in the
  reference, `utils/metrics.dispatch_jit`, reads JAX's compile telemetry
  and is not ported; the hook is kept with its semantics.)

**Bounded memory**: per-round data is pre-folded at round exit into one
small dict (per-kernel attribution and a padded-bucket histogram) pushed
onto a `RING`-deep deque; within a round at most `CALL_CAP` calls are
recorded exactly and the rest only counted.

**Never blocks the flush path**: calls inside a round append to
thread-local state; the ledger lock is taken once per round, at fold.

**Pure-state export**: `section()` reads no clock, so two idle
back-to-back snapshots compare equal. The `obs_dispatch_*` gauges and
the `obs_dispatch_ledger_s` self-time histogram refresh on the mutation
path (every `GAUGE_REFRESH` folds).

`AMTPU_DISPATCHLEDGER=0` disables the plane: one cached check (reset by
`_reload_for_tests`), and every hook returns before allocating.

At a round's fold two optional hand-offs run, as in the reference: the
round's folded cost goes to the tenant ledger (`sync/tenantledger.py
note_round`, split by who dirtied the round) and one `dispatch_round`
event to the flight recorder (`utils/flightrec.py`).

Definitions:

- **amplification** = dispatches / dirty docs over the round window;
- **padding-waste %** = 1 - logical lanes / padded lanes, summed over
  every recorded axis product;
- **bucket shape** = kernel family + padded dims (`rows_mega:1024x82`),
  the launch-shape key.
"""

from __future__ import annotations

import os
import threading
import time

from ..utils import metrics

#: folded rounds retained (the rollup window and the post-mortem ring)
RING = 256
#: calls recorded exactly per round; overflow is counted, not detailed
CALL_CAP = 512
#: rounds exported verbatim per snapshot section (the ring's newest end)
EXPORT_ROUNDS = 16
#: distinct padded-bucket shapes exported per window rollup
EXPORT_BUCKETS = 24
#: ledger-lock mutations (round/ambient folds) between gauge refreshes
GAUGE_REFRESH = 16

_enabled: bool | None = None


def enabled() -> bool:
    global _enabled
    if _enabled is None:
        _enabled = os.environ.get("AMTPU_DISPATCHLEDGER", "1") != "0"
    return _enabled


def _reload_for_tests() -> None:
    global _enabled
    _enabled = None


class _Call:
    """One routed kernel call, thread-local until its round folds."""

    __slots__ = ("family", "backend", "est_device_s", "est_host_s",
                 "docs", "docs_cap", "logical", "padded", "bucket",
                 "jits", "retraces", "wall_s")

    def __init__(self, family, backend, plan, docs, axes):
        self.family = family
        self.backend = backend or "host"
        self.est_device_s = (round(float(plan.est_device_s), 9)
                             if plan is not None else None)
        self.est_host_s = (round(float(plan.est_host_s), 9)
                           if plan is not None else None)
        # lane products: logical vs padded, across every recorded axis
        logical = padded = 1
        dims = []
        for name, (lo, pa) in (axes or {}).items():
            logical *= max(int(lo), 0)
            padded *= max(int(pa), 1)
            dims.append(str(int(pa)))
        self.logical = logical if axes else 0
        self.padded = padded if axes else 0
        self.bucket = f"{family}:{'x'.join(dims)}" if dims else family
        self.docs = int(docs)
        # docs-lane capacity of ONE dispatch of this bucket shape — the
        # denominator of the megabatch projection
        dax = (axes or {}).get("docs")
        self.docs_cap = int(dax[1]) if dax else max(int(docs), 1)
        self.jits = 0
        self.retraces = 0
        self.wall_s = 0.0


class _Round:
    """One open flush round: thread-local call accumulator."""

    __slots__ = ("label", "dirty_docs", "calls", "dropped", "ambient",
                 "self_s", "tenants", "mega")

    def __init__(self, dirty_docs, label, tenants=None):
        self.label = label
        self.dirty_docs = int(dirty_docs)
        self.calls: list[_Call] = []
        self.dropped = 0        # calls past CALL_CAP (counted, undetailed)
        self.ambient = 0        # jit dispatches with no call scope open
        self.self_s = 0.0
        # per-tenant dirty-doc counts, carried into the folded round when
        # a caller passes them (None: the fold has no "tenants" key)
        self.tenants = tenants
        # megabatch occupancy summary (note_megabatch), the ACHIEVED
        # numbers; None: the fold has no "mega" key
        self.mega = None


class _Tls(threading.local):
    round: "_Round | None" = None
    call: "_Call | None" = None


_tls = _Tls()


def _fold_calls(calls: list, ambient: int, dropped: int) -> dict:
    """Pre-fold a round's call list into the small dict the ring keeps:
    per-kernel attribution + padded-bucket histogram, no per-call data
    survives."""
    kernels: dict[str, dict] = {}
    buckets: dict[str, dict] = {}
    dispatches = jits = retraces = 0
    logical = padded = 0
    wall = 0.0
    for c in calls:
        dispatches += 1
        jits += c.jits
        retraces += c.retraces
        logical += c.logical
        padded += c.padded
        wall += c.wall_s
        k = kernels.get(c.family)
        if k is None:
            k = kernels[c.family] = {
                "calls": 0, "host": 0, "device": 0, "wall_s": 0.0,
                "jits": 0, "retraces": 0, "logical": 0, "padded": 0}
        k["calls"] += 1
        k["host" if c.backend == "host" else "device"] += 1
        k["wall_s"] += c.wall_s
        k["jits"] += c.jits
        k["retraces"] += c.retraces
        k["logical"] += c.logical
        k["padded"] += c.padded
        b = buckets.get(c.bucket)
        if b is None:
            b = buckets[c.bucket] = {
                "calls": 0, "docs": 0, "docs_cap": 0,
                "logical": 0, "padded": 0, "wall_s": 0.0}
        b["calls"] += 1
        b["docs"] += c.docs
        b["docs_cap"] += c.docs_cap
        b["logical"] += c.logical
        b["padded"] += c.padded
        b["wall_s"] += c.wall_s
    for k in kernels.values():
        k["wall_s"] = round(k["wall_s"], 6)
    for b in buckets.values():
        b["wall_s"] = round(b["wall_s"], 6)
    return {"dispatches": dispatches, "ambient": ambient,
            "dropped": dropped, "jits": jits, "retraces": retraces,
            "logical": logical, "padded": padded,
            "wall_s": round(wall, 6), "kernels": kernels,
            "buckets": buckets}


class DispatchLedger:
    """Process-global per-round dispatch-efficiency account."""

    def __init__(self):
        self._lock = threading.Lock()
        from collections import deque
        self._ring: "deque[dict]" = deque(maxlen=RING)
        self._round_seq = 0
        self._rounds_total = 0
        self._dirty_docs_total = 0
        self._dispatches_total = 0
        self._ambient_total = 0
        self._jits_total = 0
        self._retraces_total = 0
        self._mega_rounds_total = 0
        self._mega_dispatches_total = 0
        self._mega_docs_total = 0
        self._mega_docs_cap_total = 0
        self._self_s = 0.0
        self._self_s_flushed = 0.0
        self._active = False
        self._mutations = 0

    # -- fold paths (the only lock takers) ----------------------------------

    def _fold_round_locked(self, folded: dict) -> None:
        self._ring.append(folded)
        self._rounds_total += 1
        self._dirty_docs_total += folded["dirty_docs"]
        self._dispatches_total += folded["dispatches"]
        self._ambient_total += folded["ambient"]
        self._jits_total += folded["jits"]
        self._retraces_total += folded["retraces"]
        self._active = True
        self._mutations += 1
        if self._mutations % GAUGE_REFRESH == 0:
            self._refresh_gauges_locked()

    def _fold_ambient_locked(self, n: int) -> None:
        self._ambient_total += n
        self._active = True
        self._mutations += 1
        if self._mutations % GAUGE_REFRESH == 0:
            self._refresh_gauges_locked()

    def _window_locked(self) -> dict:
        """Rollups over the ring window. Pure state — no clock reads."""
        rounds = len(self._ring)
        dispatches = dirty = jits = retraces = ambient = 0
        logical = padded = 0
        wall = 0.0
        kernels: dict[str, dict] = {}
        buckets: dict[str, dict] = {}
        for r in self._ring:
            dispatches += r["dispatches"]
            ambient += r["ambient"]
            dirty += r["dirty_docs"]
            jits += r["jits"]
            retraces += r["retraces"]
            logical += r["logical"]
            padded += r["padded"]
            wall += r["wall_s"]
            for fam, k in r["kernels"].items():
                dst = kernels.get(fam)
                if dst is None:
                    dst = kernels[fam] = dict(k)
                else:
                    for f in ("calls", "host", "device", "jits",
                              "retraces", "logical", "padded"):
                        dst[f] += k[f]
                    dst["wall_s"] = round(dst["wall_s"] + k["wall_s"], 6)
            for shape, b in r["buckets"].items():
                dst = buckets.get(shape)
                if dst is None:
                    dst = buckets[shape] = dict(b)
                else:
                    for f in ("calls", "docs", "docs_cap", "logical",
                              "padded"):
                        dst[f] += b[f]
                    dst["wall_s"] = round(dst["wall_s"] + b["wall_s"], 6)
        # megabatch ACHIEVED occupancy over the window
        m_rounds = m_disp = m_docs = m_cap = 0
        m_logical = m_padded = 0
        for r in self._ring:
            m = r.get("mega")
            if not m:
                continue
            m_rounds += 1
            m_disp += m.get("dispatches", 0)
            m_docs += m.get("docs", 0)
            m_cap += m.get("docs_cap", 0)
            m_logical += m.get("logical", 0)
            m_padded += m.get("padded", 0)
        mega = None
        if m_rounds:
            mega = {
                "rounds": m_rounds,
                "dispatches": m_disp,
                "docs": m_docs,
                "docs_per_dispatch": (round(m_docs / m_disp, 4)
                                      if m_disp else None),
                "fill_pct": (round(100.0 * m_docs / m_cap, 3)
                             if m_cap else None),
                "pad_waste_pct": (
                    round(100.0 * (1.0 - m_logical / m_padded), 3)
                    if m_padded else None),
            }
        # ambient jit dispatches are dispatches too: megabatching must
        # divide them just the same, so they join the numerator
        amp = (round((dispatches + ambient) / dirty, 4) if dirty
               else None)
        waste = (round(100.0 * (1.0 - logical / padded), 3)
                 if padded else None)
        # biggest padded volume first: the waste sources worth attacking
        ranked = sorted(buckets.items(), key=lambda kv: -kv[1]["padded"])
        out_buckets = dict(ranked[:EXPORT_BUCKETS])
        return {
            "rounds": rounds,
            "dispatches": dispatches,
            "ambient": ambient,
            "dirty_docs": dirty,
            "dispatches_per_round": (round(dispatches / rounds, 4)
                                     if rounds else None),
            "amplification": amp,
            "pad_waste_pct": waste,
            "jits": jits,
            "retraces": retraces,
            "logical_lanes": logical,
            "padded_lanes": padded,
            "wall_s": round(wall, 6),
            "kernels": kernels,
            "buckets": out_buckets,
            "buckets_truncated": max(0, len(buckets) - len(out_buckets)),
            "megabatch": mega,
        }

    def _refresh_gauges_locked(self) -> None:
        """Periodic registered-series refresh on the MUTATION path
        (every GAUGE_REFRESH folds), never at export time, so snapshot() stays
        read-only and two idle snapshots compare equal. Also flushes the
        self-time delta into the obs_dispatch_ledger_s histogram."""
        w = self._window_locked()
        if w["amplification"] is not None:
            metrics.gauge("obs_dispatch_amplification", w["amplification"])
        if w["pad_waste_pct"] is not None:
            metrics.gauge("obs_dispatch_pad_waste_pct", w["pad_waste_pct"])
        if w["dispatches_per_round"] is not None:
            metrics.gauge("obs_dispatch_per_round",
                          w["dispatches_per_round"])
        metrics.gauge("obs_dispatch_rounds_tracked", w["rounds"])
        m = w.get("megabatch")
        if m:
            if m["docs_per_dispatch"] is not None:
                metrics.gauge("obs_megabatch_docs_per_dispatch",
                              m["docs_per_dispatch"])
            if m["fill_pct"] is not None:
                metrics.gauge("obs_megabatch_fill_pct", m["fill_pct"])
        delta = self._self_s - self._self_s_flushed
        self._self_s_flushed = self._self_s
        if delta > 0:
            metrics.observe("obs_dispatch_ledger_s", delta)

    # -- export --------------------------------------------------------------

    def self_seconds(self) -> float:
        """Accumulated ledger self-time (the plane's cost on the flush
        path): scope entry/exit/fold bookkeeping only, never the kernel
        wall the scopes surround."""
        with self._lock:
            return self._self_s

    def section(self) -> dict | None:
        """This ledger's share of the `"dispatchledger"` snapshot
        section: cumulative totals, the window rollup over the ring, and
        the newest EXPORT_ROUNDS rounds verbatim. Pure state; read-only
        against the metrics registry (gauges refresh on the mutation
        path); export cost is not accumulated into self-time, which
        measures the flush path's tax only. None when nothing was ever
        recorded."""
        with self._lock:
            if not self._active:
                return None
            window = self._window_locked()
            ring = [dict(r) for r in list(self._ring)[-EXPORT_ROUNDS:]]
            out = {
                "label": metrics.node_name() or "local",
                "rounds_total": self._rounds_total,
                "dirty_docs_total": self._dirty_docs_total,
                "dispatches_total": self._dispatches_total,
                "ambient_total": self._ambient_total,
                "jits_total": self._jits_total,
                "retraces_total": self._retraces_total,
                "mega_rounds_total": self._mega_rounds_total,
                "mega_dispatches_total": self._mega_dispatches_total,
                "mega_docs_total": self._mega_docs_total,
                "mega_docs_cap_total": self._mega_docs_cap_total,
                "window": window,
                "ring": ring,
                "ring_truncated": max(0, len(self._ring) - len(ring)),
                "self_s": round(self._self_s, 6),
            }
        return out

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._round_seq = 0
            self._rounds_total = 0
            self._dirty_docs_total = 0
            self._dispatches_total = 0
            self._ambient_total = 0
            self._jits_total = 0
            self._retraces_total = 0
            self._mega_rounds_total = 0
            self._mega_dispatches_total = 0
            self._mega_docs_total = 0
            self._mega_docs_cap_total = 0
            self._self_s = self._self_s_flushed = 0.0
            self._active = False
            self._mutations = 0


_ledger = DispatchLedger()


def ledger() -> DispatchLedger:
    return _ledger


# ---------------------------------------------------------------------------
# hooks (the only API call sites use)


class _RoundScope:
    """Round boundary: `with round_scope(dirty_docs):` around one
    coalesced flush. Thread-local while open — the ledger lock is taken
    once, at fold. Re-entrant opens nest as no-ops (the outer round owns
    the account)."""

    __slots__ = ("_rd", "_nested")

    def __init__(self, dirty_docs: int, label: str | None = None,
                 tenants: dict | None = None):
        self._rd = None
        self._nested = False
        if not enabled():
            return
        t0 = time.perf_counter()
        if _tls.round is not None:
            self._nested = True
            return
        self._rd = _tls.round = _Round(dirty_docs, label, tenants)
        self._rd.self_s += time.perf_counter() - t0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        rd = self._rd
        if rd is None:
            return False
        t0 = time.perf_counter()
        _tls.round = None
        folded = _fold_calls(rd.calls, rd.ambient, rd.dropped)
        led = _ledger
        with led._lock:
            led._round_seq += 1
            seq = led._round_seq
            folded["round"] = seq
            folded["dirty_docs"] = rd.dirty_docs
            if rd.label:
                folded["label"] = rd.label
            if rd.tenants:
                folded["tenants"] = dict(rd.tenants)
            if rd.mega:
                folded["mega"] = rd.mega
            amp = ((folded["dispatches"] + folded["ambient"])
                   / rd.dirty_docs if rd.dirty_docs else None)
            led._fold_round_locked(folded)
            led._self_s += (rd.self_s + time.perf_counter() - t0)
        if rd.tenants:
            # the tenant attribution plane's dispatch/padding-share feed:
            # this round's folded cost is divided by who dirtied the
            # batch (lazy import: the tenant ledger lives in the sync
            # layer and reaches back here only through this hand-off)
            try:
                from ..sync import tenantledger
                tenantledger.note_round(rd.tenants, folded,
                                        label=rd.label)
            except Exception:
                pass
        try:
            from ..utils import flightrec
            flightrec.record("dispatch_round", round=seq,
                             docs=rd.dirty_docs,
                             dispatches=folded["dispatches"],
                             **({"amp": round(amp, 3)} if amp else {}))
        except Exception:
            pass
        return False


def round_scope(dirty_docs: int, label: str | None = None,
                tenants: dict | None = None) -> _RoundScope:
    return _RoundScope(dirty_docs, label, tenants=tenants)


def note_megabatch(summary: dict) -> None:
    """One executed megabatch round's ACHIEVED occupancy
    (engine/dispatch.py apply_round_adaptive): attaches to the open
    flush round when one is open (the fold carries it to the ring), and
    always updates the cumulative megabatch account. Two summaries in one
    round (the route on the frame path, then on the hash refresh of lanes
    it did not cover) merge additively."""
    if not enabled():
        return
    t0 = time.perf_counter()
    rd = _tls.round
    if rd is not None:
        m = rd.mega
        if m is None:
            rd.mega = dict(summary)
        else:
            for f in ("buckets", "docs", "dispatches", "docs_cap",
                      "logical", "padded"):
                m[f] = m.get(f, 0) + summary.get(f, 0)
            if m.get("dispatches"):
                m["docs_per_dispatch"] = round(
                    m["docs"] / m["dispatches"], 4)
            if m.get("docs_cap"):
                m["fill_pct"] = round(
                    100.0 * m["docs"] / m["docs_cap"], 3)
            if m.get("padded"):
                m["pad_waste_pct"] = round(
                    100.0 * (1.0 - m["logical"] / m["padded"]), 3)
            for tid, w in (summary.get("tenant_lanes") or {}).items():
                lanes = m.setdefault("tenant_lanes", {})
                lanes[tid] = lanes.get(tid, 0.0) + w
    led = _ledger
    with led._lock:
        led._mega_rounds_total += 1
        led._mega_dispatches_total += summary.get("dispatches", 0)
        led._mega_docs_total += summary.get("docs", 0)
        led._mega_docs_cap_total += summary.get("docs_cap", 0)
        led._active = True
        led._self_s += time.perf_counter() - t0


def last_round_summary() -> dict | None:
    """The most recently folded round, reduced to what a cross-plane
    join needs: its ledger seq plus per-round amplification / pad-waste
    and its megabatch summary. None when the ledger is off or nothing
    has folded yet."""
    led = _ledger
    with led._lock:
        if not led._ring:
            return None
        r = led._ring[-1]
    amp = None
    if r.get("dirty_docs"):
        amp = round((r["dispatches"] + r["ambient"]) / r["dirty_docs"], 4)
    waste = None
    if r.get("padded"):
        waste = round(100.0 * (1.0 - r["logical"] / r["padded"]), 3)
    return {"round": r.get("round"), "amp": amp,
            "pad_waste_pct": waste, "mega": r.get("mega")}


class _CallScope:
    """One routed kernel call: `with call_scope("spans", plan=plan,
    docs=n, axes={"docs": (n, d_pad), "spans": (s_max, s_pad)}):` around
    the backend call. Wall time covers the body (the dispatch itself);
    bookkeeping outside the body is self-time. Folds lock-free into the
    open round, or under the ledger lock when ambient."""

    __slots__ = ("_c", "_prev", "_t0")

    def __init__(self, family, plan=None, docs=1, axes=None,
                 backend=None):
        self._c = None
        self._prev = None
        self._t0 = 0.0
        if not enabled():
            return
        t0 = time.perf_counter()
        be = backend or (plan.backend if plan is not None else None)
        c = _Call(family, be, plan, docs, axes)
        self._prev = _tls.call
        self._c = c
        _tls.call = c
        oh = time.perf_counter() - t0
        rd = _tls.round
        if rd is not None:
            rd.self_s += oh
        else:
            with _ledger._lock:
                _ledger._self_s += oh

    def __enter__(self):
        if self._c is not None:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        c = self._c
        if c is None:
            return False
        end = time.perf_counter()
        c.wall_s = end - self._t0
        _tls.call = self._prev
        metrics.bump("engine_dispatch_calls", family=c.family,
                     backend=c.backend)
        rd = _tls.round
        if rd is not None:
            if len(rd.calls) < CALL_CAP:
                rd.calls.append(c)
            else:
                rd.dropped += 1
            rd.self_s += time.perf_counter() - end
        else:
            folded = _fold_calls([c], 0, 0)
            led = _ledger
            with led._lock:
                led._round_seq += 1
                folded["round"] = led._round_seq
                folded["dirty_docs"] = c.docs
                folded["label"] = "ambient"
                led._fold_round_locked(folded)
                led._self_s += time.perf_counter() - end
        return False


def call_scope(family: str, plan=None, docs: int = 1,
               axes: dict | None = None,
               backend: str | None = None) -> _CallScope:
    return _CallScope(family, plan=plan, docs=docs, axes=axes,
                      backend=backend)


def note_jit(kernel: str, retraced: bool) -> None:
    """metrics.dispatch_jit hook: compile-cache status for the open call
    scope (a routed job may fan into several jitted dispatches), or an
    ambient count when no scope is open — nothing escapes the account."""
    if not enabled():
        return
    c = _tls.call
    if c is not None:
        c.jits += 1
        if retraced:
            c.retraces += 1
        c.backend = "device"
        return
    metrics.bump("engine_dispatch_ambient")
    rd = _tls.round
    if rd is not None:
        rd.ambient += 1
        return
    t0 = time.perf_counter()
    with _ledger._lock:
        _ledger._fold_ambient_locked(1)
        _ledger._self_s += time.perf_counter() - t0


# ---------------------------------------------------------------------------
# snapshot section, in the reference's {"nodes": {label: sec}} shape


def snapshot_section() -> dict | None:
    sec = _ledger.section()
    if not sec:
        return None
    return {"nodes": {sec["label"]: sec}}


def _reset_all() -> None:
    _ledger.reset()
    _tls.round = None
    _tls.call = None


metrics.register_snapshot_section("dispatchledger", snapshot_section)
metrics.register_reset_hook(_reset_all)
