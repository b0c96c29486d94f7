"""Declarative fleet SLOs, evaluated every collector scrape tick.

Convergence lag under arbitrary scale and latency is THE quantity a CRDT
fleet's service objectives must be written against (PAPERS.md, arxiv
1303.7462) — not CPU or queue depth, which are means, not ends. This
module is the judge the collector (perf/fleet.py) feeds: a small
declarative spec of bounds over fleet rollup signals, re-evaluated every
scrape tick, with verdict TRANSITIONS (ok -> breach, breach -> ok)
recorded as `slo_verdict` flight-recorder events and exported as
`obs_slo_ok{slo=...}` / `obs_slo_breaches{slo=...}` series.

Spec format (docs/OBSERVABILITY.md "Fleet health") — a list of dicts or
`Slo` objects:

    {"name": "converge_p99",          # series label (bounded)
     "signal": "converge_p99_s",      # a fleet_state() rollup key, or
                                      # "scrape_p50_s" (self-overhead)
     "bound": 2.0,                    # breach when value > bound
     "delta": False,                  # True: judge the growth since the
                                      # engine attached, not the level
                                      # (e.g. watchdog fires must not
                                      # INCREASE on this engine's watch)
     "description": "..."}

The five defaults mirror the plane's acceptance bar:

- `converge_p99`: fleet max converge-stage p99 stays under bound;
- `watchdog_clean`: zero NEW watchdog fires fleet-wide;
- `retrace_stability`: fleet total retraces stay within the rolling
  bench-history compile budget (`bench_history.jsonl` median
  compiles_total, + the same slack `perf check` grants) — a retrace
  storm is the classic silent perf cliff;
- `collector_overhead`: the collector's own scrape p50 stays under
  budget (a health plane must not degrade the fleet it watches);
- `dispatch_amplification`: fleet max dispatches-per-dirty-doc (the
  dispatch ledger's window rollup) stays under bound — the number
  ROADMAP #2's megabatching must divide, judged here so a regression
  into dispatch-per-doc behavior breaches before it becomes a latency
  incident;
- `tenant_converge_p99`: the WORST per-tenant converge p99 across the
  fleet (sync/tenantledger.py lag rings) stays under bound — the
  isolation objective: one tenant's storm must not ride another
  tenant's latency budget. `tenant_slos()` expands the same objective
  into one named SLO per tenant (signal `tenant:<id>:converge_p99_s`,
  read from the rollup's per-tenant merge) for fleets that pin
  specific tenants to specific bounds.

A signal the fleet has not produced yet (no oplag samples, empty
history) evaluates to verdict None — "no data" is neither ok nor breach,
and never fires a transition.
"""

from __future__ import annotations

import statistics
import time

from ..utils import flightrec, metrics

#: default bound on the fleet max converge-stage p99 (seconds);
#: deployments override per spec
DEFAULT_CONVERGE_P99_S = 2.0
#: default bound on the collector's own scrape p50 (seconds) — also the
#: absolute budget the perf-history gate holds bench config 11 to
#: (perf/history.py SCRAPE_BUDGET_S mirrors this)
DEFAULT_SCRAPE_P50_S = 0.25
#: slack over the bench-history compile median for retrace_stability
#: (same shape as perf check's compile gate: pct growth + absolute)
RETRACE_SLACK_PCT = 50.0
RETRACE_ABS_SLACK = 2
#: default bound on the fleet max dispatches-per-dirty-doc window
#: rollup (engine/dispatchledger.py): a steady fleet batches a round's
#: docs into a handful of routed calls, so the per-doc share stays well
#: under one dispatch each — sustained amplification past this bound
#: means the engine is dispatching per doc, exactly the regime ROADMAP
#: #2's megabatching exists to collapse
DEFAULT_DISPATCH_AMPLIFICATION = 8.0
#: default bound on the worst per-tenant converge p99 (seconds) — the
#: isolation objective: the same latency bar as the fleet-wide
#: converge_p99, held PER TENANT so a quiet tenant's breach under a hot
#: neighbor is visible even while the fleet aggregate stays green
DEFAULT_TENANT_CONVERGE_P99_S = 2.0
#: default bound on the sampled end-to-end critical-path p99 (seconds)
#: from the trace plane (utils/tracer.py): the same latency bar as the
#: fleet converge_p99, but measured over STITCHED per-change lifecycles
#: (origin finalize through remote visibility) — a breach here comes
#: with the stage decomposition that names which stage to fix
DEFAULT_TRACE_CRITICAL_P99_S = 2.0


class Slo:
    """One declarative objective over a fleet signal."""

    __slots__ = ("name", "signal", "bound", "delta", "description")

    def __init__(self, name: str, signal: str, bound: float | None,
                 delta: bool = False, description: str = ""):
        self.name = name
        self.signal = signal
        self.bound = bound
        self.delta = delta
        self.description = description

    @classmethod
    def from_dict(cls, d: dict) -> "Slo":
        return cls(d["name"], d["signal"], d.get("bound"),
                   delta=bool(d.get("delta")),
                   description=d.get("description", ""))

    def to_dict(self) -> dict:
        return {"name": self.name, "signal": self.signal,
                "bound": self.bound, "delta": self.delta,
                "description": self.description}


def retrace_budget_from_history(path: str | None = None) -> float | None:
    """The retrace_stability bound: rolling median `compiles_total` of
    the comparable bench-history records, with perf check's compile-gate
    slack. None (SLO skips) when the ledger carries no compile
    telemetry — the judge never invents a baseline."""
    from . import history
    records = history.load(path)
    compiles = [(r.get("perf") or {}).get("compiles_total")
                for r in records]
    compiles = [c for c in compiles if isinstance(c, int)]
    if not compiles:
        return None
    med = statistics.median(compiles[-history.DEFAULT_WINDOW:])
    return med * (1.0 + RETRACE_SLACK_PCT / 100.0) + RETRACE_ABS_SLACK


def default_slos(converge_p99_s: float = DEFAULT_CONVERGE_P99_S,
                 scrape_p50_s: float = DEFAULT_SCRAPE_P50_S,
                 retrace_budget: float | None = None,
                 dispatch_amplification: float =
                 DEFAULT_DISPATCH_AMPLIFICATION,
                 tenant_converge_p99_s: float =
                 DEFAULT_TENANT_CONVERGE_P99_S,
                 trace_critical_p99_s: float =
                 DEFAULT_TRACE_CRITICAL_P99_S) -> list[Slo]:
    return [
        Slo("converge_p99", "converge_p99_s", converge_p99_s,
            description="fleet max converge-stage p99 under bound"),
        Slo("watchdog_clean", "watchdog_fires", 0, delta=True,
            description="zero new watchdog fires fleet-wide"),
        Slo("retrace_stability", "retraced", retrace_budget, delta=True,
            description="fleet retraces within the bench-history "
                        "compile budget"),
        Slo("collector_overhead", "scrape_p50_s", scrape_p50_s,
            description="collector scrape p50 under budget"),
        Slo("dispatch_amplification", "dispatch_amplification",
            dispatch_amplification,
            description="fleet max dispatches per dirty doc under "
                        "bound (engine/dispatchledger.py window)"),
        Slo("tenant_converge_p99", "tenant_converge_p99_s",
            tenant_converge_p99_s,
            description="worst per-tenant converge p99 under bound "
                        "(sync/tenantledger.py — the isolation "
                        "objective)"),
        Slo("trace_critical_p99", "trace_critical_p99_s",
            trace_critical_p99_s,
            description="sampled end-to-end critical-path p99 under "
                        "bound (utils/tracer.py trace plane — a breach "
                        "names its stage via `perf trace`)"),
    ]


def tenant_slos(tenants, bound: float = DEFAULT_TENANT_CONVERGE_P99_S,
                ) -> list[Slo]:
    """The per-tenant SLO spec family: one `tenant_converge_p99:<id>`
    objective per named tenant, each judged against that tenant's own
    merged converge p99 (the rollup's `tenants` map, perf/fleet.py
    `_tenant_rollup`). Compose with default_slos():

        SloEngine(slos=default_slos() + tenant_slos(["acme", "globex"]))
    """
    return [
        Slo(f"tenant_converge_p99:{t}", f"tenant:{t}:converge_p99_s",
            bound,
            description=f"tenant {t!r} converge p99 under bound "
                        "(per-tenant isolation)")
        for t in tenants]


class SloEngine:
    """Evaluates a spec against a FleetCollector every tick; holds the
    verdict table and records transitions."""

    def __init__(self, slos=None, history_path: str | None = None):
        if slos is None:
            slos = default_slos(
                retrace_budget=retrace_budget_from_history(history_path))
        self.slos = [s if isinstance(s, Slo) else Slo.from_dict(s)
                     for s in slos]
        #: name -> {"ok": bool|None, "value", "bound", "at",
        #:          "transitions": n}
        self.verdicts: dict[str, dict] = {}
        self._baselines: dict[str, float] = {}
        self._membership: frozenset = frozenset()
        # SLO-coupled admission control (sync/epochs.IngressGovernor,
        # attached to a service via attach_governor): every evaluate()
        # pass feeds the converge_p99 value into the governor's judge,
        # closing the backpressure loop — sustained breach -> the epoch
        # plane delays/sheds low-priority ingress, disclosed on the
        # sync_shed_* series. None = observe-only (the default).
        self.governor = None
        # verdict-transition subscriber (perf/remediate.py): called as
        # on_transition(name, ok, value, bound) exactly when a
        # transition is recorded — the remediation plane's "something
        # changed" edge, so it never has to diff verdict tables. None =
        # nobody listening.
        self.on_transition = None

    def _value(self, slo: Slo, state: dict) -> float | None:
        if slo.signal in ("scrape_p50_s", "scrape_p99_s"):
            v = (state.get("scrape") or {}).get(slo.signal)
        elif slo.signal.startswith("tenant:"):
            # per-tenant family (tenant_slos): "tenant:<id>:<field>"
            # reads from the rollup's merged per-tenant map
            _, tid, field = slo.signal.split(":", 2)
            v = (((state.get("rollup") or {}).get("tenants") or {})
                 .get(tid) or {}).get(field)
        else:
            v = (state.get("rollup") or {}).get(slo.signal)
        if not isinstance(v, (int, float)):
            return None
        if slo.delta:
            base = self._baselines.setdefault(slo.name, float(v))
            return float(v) - base
        return float(v)

    def evaluate(self, collector) -> dict[str, dict]:
        """One judging pass over the collector's current fleet state.
        Returns the verdict table {name: {"ok": bool|None, "value",
        "bound"}}; transitions hit flightrec + the obs_slo_* series."""
        state = collector.fleet_state()
        now = time.time()
        # Delta SLOs judge growth on THIS engine's watch — but the fleet
        # rollup is a sum over reporting nodes, so a LATE JOINER's first
        # snapshot (carrying its lifetime counters) or a departing node
        # (its sum vanishing) moves the rollup without anything new
        # happening. Re-baseline every delta SLO whenever the set of
        # reporting nodes changes: that tick's delta is zero, and growth
        # counting resumes against the new membership.
        membership = frozenset(
            n for n, rec in (state.get("nodes") or {}).items()
            if rec.get("derived") is not None)
        if membership != self._membership:
            self._membership = membership
            for slo in self.slos:
                if slo.delta:
                    self._baselines.pop(slo.name, None)
        for slo in self.slos:
            value = self._value(slo, state)
            if slo.name == "converge_p99" and self.governor is not None:
                # the backpressure loop's forward edge: breach state is
                # the governor's to decide (it owns sustain/bound); a
                # None value never transitions it
                try:
                    self.governor.judge(value)
                except Exception:
                    pass   # a broken governor must not stop the judging
            ok: bool | None
            if value is None or slo.bound is None:
                ok = None               # no data / no baseline: skip
            else:
                ok = value <= slo.bound
            prev = self.verdicts.get(slo.name)
            prev_ok = prev["ok"] if prev else None
            rec = {"ok": ok, "value": value, "bound": slo.bound,
                   "at": now,
                   "transitions": (prev["transitions"] if prev else 0)}
            if ok is not None:
                metrics.gauge("obs_slo_ok", 1 if ok else 0, slo=slo.name)
                if (prev_ok is not None and ok != prev_ok) or \
                        (prev_ok is None and ok is False):
                    # a verdict CHANGE (or a first verdict that is
                    # already a breach) is worth a breadcrumb; steady
                    # health is not
                    rec["transitions"] += 1
                    flightrec.record(
                        "slo_verdict", slo=slo.name, ok=bool(ok),
                        value=(round(value, 6)
                               if isinstance(value, float) else value),
                        bound=slo.bound)
                    if not ok:
                        metrics.bump("obs_slo_breaches", slo=slo.name)
                    if self.on_transition is not None:
                        try:
                            self.on_transition(slo.name, bool(ok), value,
                                               slo.bound)
                        except Exception:
                            pass   # a broken listener must not stop judging
            self.verdicts[slo.name] = rec
        return self.verdicts

    def summary(self) -> list[dict]:
        """JSON-able verdict rows in spec order (the `perf top` strip)."""
        out = []
        for slo in self.slos:
            v = self.verdicts.get(slo.name) or {}
            out.append({"name": slo.name, "signal": slo.signal,
                        "ok": v.get("ok"), "value": v.get("value"),
                        "bound": v.get("bound"),
                        "description": slo.description})
        return out
