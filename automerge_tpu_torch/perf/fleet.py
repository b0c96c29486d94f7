"""Fleet health collector: scrape, roll up, flag stragglers.

Every instrument the repo grew in rounds 1-8 — labeled metrics, oplag
stage percentiles, lock-holder tables, watchdog fires, flight-recorder
dumps — is per-node and post-hoc: at 100K docs across a fleet, "is the
fleet healthy RIGHT NOW, and which node/stage/lock is the cause" meant
hand-joining JSON files. This module is the layer that scrapes and
judges live:

- **sources**: the local node directly (one `metrics.snapshot()` call —
  the epoch-snapshot read plane makes this cheap and consistent), plus
  any number of peers over the existing `{"metrics": "pull"}` wire op
  (`add_peer(connection)`); the peer's answer names its node
  (`metrics.node_name()` -> `Connection.peer_node`), so fleets self-label.
- **time-series ring per node** (bounded, `ring` samples): counters
  become rates across consecutive samples, span totals become per-round
  means, oplag reservoir percentiles and gauges are sampled as-is.
- **fleet rollups + straggler/skew detection**: every tick the collector
  compares each node's signals (converge-stage p99, round-flush mean,
  service-lock wait rate, frame-drop rate, retrace rate) against the
  fleet median of its role group and flags any node whose positive
  deviation reaches K "sigma". The deviation scale is a robust one —
  1.4826·MAD with relative/absolute floors — because a 3-node fleet's
  two healthy members have MAD 0 and a classic z-score would divide by
  the outlier it is trying to flag. Exported as `obs_fleet_*` series and
  `straggler_flagged` flight-recorder events.
- **self-overhead accounting**: every tick's wall cost lands in
  `obs_fleet_scrape_s`; the SLO engine (perf/slo.py) bounds it — a
  health plane that degrades the fleet it watches fails its own check.

Scrape protocol for wire peers: tick k harvests whatever answers arrived
since tick k-1 (stamped at ARRIVAL on the transport reader thread), then
issues the next pull — the collector never blocks on a slow peer, and a
dead one simply goes stale (`obs_fleet_scrape_age_s` keeps growing,
surfaced in `fleet_state()["nodes"][n]["stale"]`).

`python -m automerge_tpu_torch.perf top` renders this live; `perf doctor`
turns a flagged straggler into a ranked root-cause report
(docs/OBSERVABILITY.md "Fleet health").
"""

from __future__ import annotations

import logging
import re
import threading
import time
from collections import deque

from ..utils import flightrec, locksan, metrics

log = logging.getLogger("automerge_tpu_torch.fleet")

#: default seconds between scrape ticks
DEFAULT_INTERVAL_S = 1.0
#: default per-node ring length (samples)
DEFAULT_RING = 128
#: default K: a node flags when its robust deviation score reaches K
DEFAULT_K_SIGMA = 3.0
#: minimum nodes in a role group before straggler comparison is
#: meaningful (a 2-node "fleet" has no median to deviate from)
MIN_NODES = 3

#: signals compared across nodes for straggler detection, with the
#: absolute scale floor per signal (units of the signal itself) — the
#: floor keeps a uniform fleet (MAD 0) from flagging noise, and makes a
#: genuinely deviant node score high even when the healthy members are
#: bit-identical
STRAGGLER_SIGNALS: dict[str, float] = {
    "converge_p99_s": 0.05,
    "round_flush_mean_s": 0.01,
    "lock_wait_rate": 0.05,
    "drop_rate": 0.2,
    "retrace_rate": 0.5,
}
#: relative floor on the deviation scale (fraction of |median|)
REL_FLOOR = 0.25

_SERVICE_WAIT_RE = re.compile(
    r"^sync_lock_wait_s\{lock=service[^}]*\}_sum$")
_SERVICE_HOLD_RE = re.compile(
    r"^sync_lock_hold_s\{lock=service[^}]*\}_sum$")


def collapse(snapshot: dict, prefix: str, suffix: str = "") -> float:
    """Sum `prefix<suffix>` plus every labeled `prefix{...}<suffix>`
    series in a flat snapshot (handles spans' `_s`/`_count` suffixes,
    which sit OUTSIDE the label braces)."""
    total = 0.0
    exact = prefix + suffix
    for k, v in snapshot.items():
        if not isinstance(v, (int, float)):
            continue
        if k == exact or (k.startswith(prefix + "{")
                          and k.endswith(suffix) and "}" in k):
            total += v
    return total


def _stage_p99(snapshot: dict, stage: str) -> float | None:
    """A stage's p99 from the nested oplag section, falling back to the
    exported gauge. None when the node never recorded the stage."""
    stages = ((snapshot.get("oplag") or {}).get("stages") or {})
    st = stages.get(stage)
    if isinstance(st, dict) and isinstance(st.get("p99_s"), (int, float)):
        return float(st["p99_s"])
    g = snapshot.get("sync_op_lag_p99_s{stage=%s}" % stage)
    return float(g) if isinstance(g, (int, float)) else None


def extract_features(snapshot: dict) -> dict:
    """One node snapshot -> the flat feature dict the ring stores.
    `_CUMULATIVE` keys are monotonic counters/totals (turned into rates
    by NodeState); the rest are instantaneous samples."""
    out = {
        # cumulative
        "ops_ingested": collapse(snapshot, "sync_ops_ingested"),
        "rounds_flushed": collapse(snapshot, "sync_rounds_flushed"),
        "round_flush_total_s": collapse(snapshot, "sync_round_flush", "_s"),
        "round_flush_count": collapse(snapshot, "sync_round_flush",
                                      "_count"),
        "frames_dropped": collapse(snapshot, "sync_frames_dropped"),
        "watchdog_fires": collapse(snapshot, "obs_watchdog_fired"),
        "retraced": collapse(snapshot, "engine_kernels_retraced"),
        "dispatched": collapse(snapshot, "engine_kernels_dispatched"),
        "lock_wait_s": 0.0,
        "lock_hold_s": 0.0,
    }
    for k, v in snapshot.items():
        if not isinstance(v, (int, float)):
            continue
        if _SERVICE_WAIT_RE.match(k):
            out["lock_wait_s"] += v
        elif _SERVICE_HOLD_RE.match(k):
            out["lock_hold_s"] += v
    # instantaneous
    for stage, key in (("converge", "converge_p99_s"),
                       ("flush", "flush_p99_s"),
                       ("queue_wait", "queue_wait_p99_s"),
                       ("peer_apply", "peer_apply_p99_s")):
        v = _stage_p99(snapshot, stage)
        if v is not None:
            out[key] = v
    # dispatch-efficiency window rollups (engine/dispatchledger.py —
    # already windowed over the per-round ring, so instantaneous here;
    # worst label wins on the rare multi-section snapshot)
    for sec in ((snapshot.get("dispatchledger") or {}).get("nodes")
                or {}).values():
        w = (sec or {}).get("window") or {}
        for src, key in (("amplification", "dispatch_amplification"),
                         ("pad_waste_pct", "dispatch_pad_waste_pct")):
            v = w.get(src)
            if isinstance(v, (int, float)):
                out[key] = max(float(v), out.get(key, 0.0))
    # tenant attribution rollups (sync/tenantledger.py): worst per-tenant
    # converge p99 and hottest ingress share this node sees — the
    # tenant_converge_p99 SLO feed and the noisy-neighbor headline
    for sec in ((snapshot.get("tenantledger") or {}).get("nodes")
                or {}).values():
        for t in ((sec or {}).get("tenants") or {}).values():
            p99 = (t.get("lag") or {}).get("p99_s")
            if isinstance(p99, (int, float)):
                out["tenant_converge_p99_s"] = max(
                    float(p99), out.get("tenant_converge_p99_s", 0.0))
            share = t.get("ingress_share_pct")
            if isinstance(share, (int, float)):
                out["tenant_hot_share_pct"] = max(
                    float(share), out.get("tenant_hot_share_pct", 0.0))
    # trace-plane rollup (utils/tracer.py): the sampled end-to-end
    # critical-path p99 over the node's completed ring — the
    # trace_critical_p99 SLO feed (worst label wins, as above)
    for sec in ((snapshot.get("traceplane") or {}).get("nodes")
                or {}).values():
        crit = (sec or {}).get("critical_path") or {}
        v = crit.get("p99_s")
        if isinstance(v, (int, float)) and crit.get("count"):
            out["trace_critical_p99_s"] = max(
                float(v), out.get("trace_critical_p99_s", 0.0))
    return out


_CUMULATIVE = ("ops_ingested", "rounds_flushed", "round_flush_total_s",
               "round_flush_count", "frames_dropped", "watchdog_fires",
               "retraced", "dispatched", "lock_wait_s", "lock_hold_s")


class NodeState:
    """One scraped node: bounded sample ring + the derived view."""

    def __init__(self, name: str, role: str = "node", ring: int = DEFAULT_RING):
        self.name = name
        self.role = role
        self.samples: deque = deque(maxlen=max(2, ring))
        self.last_snapshot: dict | None = None
        self.last_at: float | None = None
        self.straggler_since: float | None = None
        self.straggler_signal: str | None = None
        # quarantined by the remediation engine (perf/remediate.py):
        # excluded from straggler scoring, rollups and SLO membership —
        # like a stale node, but deliberate and sticky across reconnects
        self.quarantined = False

    def add_sample(self, t: float, snapshot: dict) -> dict:
        """Fold one snapshot in; returns the derived dict (rates over the
        previous sample, instantaneous values as-is)."""
        feats = extract_features(snapshot)
        prev = self.samples[-1] if self.samples else None
        derived = dict(feats)
        if prev is not None:
            dt = max(t - prev["t"], 1e-6)
            pf = prev["features"]
            for k in _CUMULATIVE:
                # clamped at 0: cumulative counters only go backwards
                # when the node's registry reset (process restart,
                # metrics.reset) — that is a quiet tick, not a negative
                # rate spiking the rollups and sparklines
                derived[k + "_delta"] = max(0.0, feats[k] - pf.get(k, 0.0))
            derived["ops_per_s"] = derived["ops_ingested_delta"] / dt
            derived["lock_wait_rate"] = derived["lock_wait_s_delta"] / dt
            derived["lock_hold_rate"] = derived["lock_hold_s_delta"] / dt
            derived["drop_rate"] = derived["frames_dropped_delta"] / dt
            derived["retrace_rate"] = derived["retraced_delta"] / dt
            n = derived["round_flush_count_delta"]
            derived["round_flush_mean_s"] = (
                derived["round_flush_total_s_delta"] / n if n > 0 else 0.0)
        self.samples.append({"t": t, "features": feats, "derived": derived})
        self.last_snapshot = snapshot
        self.last_at = t
        return derived

    def latest(self) -> dict | None:
        return self.samples[-1]["derived"] if self.samples else None

    def series(self, key: str) -> list[tuple[float, float]]:
        """(t, value) points of one derived signal, oldest first (the
        `perf top` sparkline feed)."""
        out = []
        for s in self.samples:
            v = s["derived"].get(key)
            if isinstance(v, (int, float)):
                out.append((s["t"], float(v)))
        return out


def cost_percentiles(costs) -> tuple[float | None, float | None]:
    """(p50, p99) over a scrape-cost sample, (None, None) when empty.
    ONE definition shared by scrape_stats (what the collector_overhead
    SLO judges) and bench config 11 (what the perf-history scrape gate
    enforces) — the two numbers must never diverge."""
    c = sorted(costs)
    if not c:
        return None, None
    return (round(c[len(c) // 2], 6),
            round(c[min(len(c) - 1, int(0.99 * (len(c) - 1)))], 6))


def robust_scores(values: dict[str, float], abs_floor: float,
                  rel_floor: float = REL_FLOOR) -> dict[str, float]:
    """Positive robust deviation score per node vs the group median:
    (x - median) / max(1.4826*MAD, rel_floor*|median|, abs_floor),
    clamped at 0 (a FAST node is not a straggler). The MAD scale keeps
    one huge outlier from inflating its own yardstick the way a plain
    standard deviation would; the floors keep a uniform group (MAD 0)
    from dividing by zero."""
    if len(values) < 2:
        return {n: 0.0 for n in values}
    vals = sorted(values.values())
    mid = len(vals) // 2
    med = (vals[mid] if len(vals) % 2
           else 0.5 * (vals[mid - 1] + vals[mid]))
    devs = sorted(abs(v - med) for v in vals)
    mad = (devs[mid] if len(devs) % 2
           else 0.5 * (devs[mid - 1] + devs[mid]))
    scale = max(1.4826 * mad, rel_floor * abs(med), abs_floor, 1e-9)
    return {n: max(0.0, (v - med) / scale) for n, v in values.items()}


class FleetCollector:
    """Background scraper + rollup engine over local/wire sources."""

    def __init__(self, interval_s: float = DEFAULT_INTERVAL_S,
                 ring: int = DEFAULT_RING,
                 k_sigma: float = DEFAULT_K_SIGMA,
                 min_nodes: int = MIN_NODES,
                 slo_engine=None):
        self.interval_s = interval_s
        self.ring = ring
        self.k_sigma = k_sigma
        self.min_nodes = min_nodes
        self.slo_engine = slo_engine
        # remediation engine (perf/remediate.py): tick()ed after every
        # scrape+SLO pass with the freshly judged state — the diagnosis-
        # to-action edge. None = observe-only (the default).
        self.remediator = None
        self.nodes: dict[str, NodeState] = {}
        self._locals: list[tuple[str, object]] = []   # (name, snapshot_fn)
        self._wires: list[dict] = []                  # peer records
        # guards the source registries (nodes/_locals/_wires): callers
        # register sources from their own threads while the collector
        # thread iterates them every tick — an unguarded registration
        # mid-scrape is a "dict changed size during iteration" away
        # from killing the loop (found by graftlint shared-mutate-
        # aliased; regression-pinned in tests/test_race_regressions.py).
        # Leaf-ish: never held across _inbox_lock or a scrape callback.
        self._sources_lock = locksan.named_lock("fleet_sources")
        self._inbox_lock = threading.Lock()
        self._scrape_costs: deque = deque(maxlen=256)
        self.ticks = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- sources -------------------------------------------------------------

    def add_local(self, name: str = "local", snapshot_fn=None,
                  role: str = "node") -> NodeState:
        """Scrape this process directly: `snapshot_fn()` (default the
        global `metrics.snapshot`) runs on the collector thread each
        tick."""
        fn = snapshot_fn or metrics.snapshot
        with self._sources_lock:
            self._locals.append((name, fn))
        return self._node(name, role)

    def add_peer(self, connection, name: str | None = None,
                 role: str = "node") -> None:
        """Scrape a peer over its Connection via `{"metrics": "pull"}`.
        The node is named by the peer's self-reported label when its
        first answer arrives (Connection.peer_node), falling back to
        `name`/`peer<k>`. Issues the first pull immediately."""
        rec = {"conn": connection, "name": name,
               "role": role, "inbox": []}

        def _arrived(snapshot, rec=rec):
            with self._inbox_lock:
                rec["inbox"].append((time.time(), snapshot))

        connection.on_peer_metrics = _arrived
        with self._sources_lock:
            if rec["name"] is None:
                rec["name"] = f"peer{len(self._wires)}"
            self._wires.append(rec)
        try:
            connection.request_metrics()
        except Exception:
            pass    # a dead transport just leaves the node stale

    def remove_peer(self, connection) -> None:
        """Drop a wire source whose transport died. The NodeState (and
        its ring) survives: a reconnected peer self-reporting the same
        node label re-adopts it via add_peer, so rates stay continuous
        across transport generations (counter resets clamp to a quiet
        tick) — and the label is no longer 'taken' by a dead record,
        which is what would otherwise strand the replacement on a
        positional name."""
        with self._sources_lock:
            victims = [rec for rec in self._wires
                       if rec["conn"] is connection]
            for rec in victims:
                self._wires.remove(rec)
        for rec in victims:
            if getattr(connection, "on_peer_metrics", None) is not None:
                connection.on_peer_metrics = None

    # -- quarantine (perf/remediate.py's isolation primitive) -----------------

    def quarantine(self, name: str) -> None:
        """Mark a node quarantined: excluded from straggler scoring,
        rollups and (via derived=None) SLO membership until
        unquarantined. Sticky across reconnects — a quarantined peer
        that redials is still quarantined. The node stays in the table
        with its marker: quarantine is disclosure, not amnesia."""
        st = self._node(name, "node")
        st.quarantined = True
        self._refresh_quarantine_gauge()

    def unquarantine(self, name: str) -> None:
        with self._sources_lock:
            st = self.nodes.get(name)
        if st is not None:
            st.quarantined = False
        self._refresh_quarantine_gauge()

    def quarantined(self) -> list[str]:
        with self._sources_lock:
            items = list(self.nodes.items())
        return sorted(n for n, st in items if st.quarantined)

    def _refresh_quarantine_gauge(self) -> None:
        with self._sources_lock:
            states = list(self.nodes.values())
        metrics.gauge("obs_remed_quarantined",
                      sum(1 for st in states if st.quarantined))

    def _node(self, name: str, role: str) -> NodeState:
        with self._sources_lock:
            st = self.nodes.get(name)
            if st is None:
                st = self.nodes[name] = NodeState(name, role=role,
                                                  ring=self.ring)
        return st

    # -- the tick ------------------------------------------------------------

    def scrape_once(self) -> dict:
        """One scrape tick: sample local sources, harvest wire arrivals,
        re-issue pulls, recompute stragglers + rollups, export the
        obs_fleet_* series, and (when attached) evaluate the SLOs.
        Returns fleet_state()."""
        t0 = time.perf_counter()
        now = time.time()
        # snapshot the registries: sources registered mid-tick are
        # picked up next tick, and the iteration never races a
        # registration (the callbacks below must run unlocked)
        with self._sources_lock:
            local_srcs = list(self._locals)
            wires = list(self._wires)
        for name, fn in local_srcs:
            try:
                snap = fn()
            except Exception:
                continue
            st = self._node(name, "node")
            if isinstance(snap, dict):
                st.add_sample(now, snap)
        for rec in wires:
            with self._inbox_lock:
                arrivals, rec["inbox"] = rec["inbox"], []
            conn = rec["conn"]
            node_label = getattr(conn, "peer_node", None)
            if node_label and node_label != rec["name"]:
                # adopt the peer's self-reported label, migrating off the
                # positional placeholder as long as nothing was recorded
                # under it (the label arrives with the FIRST answer, so
                # in practice the placeholder is always empty) — UNLESS
                # another source already owns the label: two peers
                # launched with the same AMTPU_NODE_NAME must not merge
                # into one ring (interleaved registries make garbage
                # rates), so the collision keeps its positional name and
                # the misconfig is surfaced instead of hidden
                with self._sources_lock:
                    taken = (any(r is not rec and r["name"] == node_label
                                 for r in self._wires)
                             or any(n == node_label
                                    for n, _ in self._locals))
                    if not taken:
                        placeholder = self.nodes.get(rec["name"])
                        if placeholder is None or not placeholder.samples:
                            self.nodes.pop(rec["name"], None)
                            rec["name"] = node_label
                if taken and not rec.get("collision_warned"):
                    rec["collision_warned"] = True
                    log.warning(
                        "fleet collector: peer self-reports node "
                        "label %r already owned by another source; "
                        "keeping positional name %r (duplicate "
                        "AMTPU_NODE_NAME?)", node_label, rec["name"])
            st = self._node(rec["name"], rec["role"])
            for (at, snap) in arrivals:
                if isinstance(snap, dict):
                    st.add_sample(at, snap)
            try:
                conn.request_metrics()
            except Exception:
                pass
        self.ticks += 1
        state = self._judge(now)
        dt = time.perf_counter() - t0
        self._scrape_costs.append(dt)
        metrics.observe("obs_fleet_scrape_s", dt)
        flightrec.record("fleet_scrape", nodes=state["rollup"]["nodes"],
                         fresh=state["rollup"]["nodes_fresh"],
                         stragglers=len(state["stragglers"]),
                         s=round(dt, 6))
        if self.slo_engine is not None:
            try:
                self.slo_engine.evaluate(self)
            except Exception:
                pass    # a broken SLO spec must not kill the scraper
        if self.remediator is not None:
            try:
                # AFTER the SLO pass: the remediation engine judges the
                # same tick's verdicts, not last tick's
                self.remediator.tick(state)
            except Exception:
                log.exception("remediation tick failed")
        return state

    def _judge(self, now: float) -> dict:
        """Recompute straggler scores + fleet rollups from the latest
        derived sample of every FRESH node, and export the gauges. A
        stale node (no snapshot for 3 ticks — dead peer, wedged
        transport) is excluded from scoring and rollups entirely: its
        frozen last rates would otherwise keep it flagged (and keep
        inflating the fleet ops/s) forever; it stays in the table with
        the stale marker and a growing scrape age."""
        stale_after = 3.0 * max(self.interval_s, 0.1)
        # judge a point-in-time snapshot of the node table: a node
        # registered mid-judgement is scored next tick
        with self._sources_lock:
            nodes = dict(self.nodes)

        def _fresh(st: NodeState) -> bool:
            return st.last_at is not None and now - st.last_at <= stale_after

        latest = {n: (st.latest()
                      if _fresh(st) and not st.quarantined else None)
                  for n, st in nodes.items()}
        scores: dict[str, tuple[float, str | None]] = {
            n: (0.0, None) for n in nodes}
        roles: dict[str, list[str]] = {}
        for n, st in nodes.items():
            roles.setdefault(st.role, []).append(n)
        for role, members in roles.items():
            if len(members) < self.min_nodes:
                continue
            for signal, floor in STRAGGLER_SIGNALS.items():
                vals = {n: latest[n].get(signal)
                        for n in members if latest[n] is not None}
                vals = {n: float(v) for n, v in vals.items()
                        if isinstance(v, (int, float))}
                if len(vals) < self.min_nodes:
                    continue
                for n, z in robust_scores(vals, floor).items():
                    if z > scores[n][0]:
                        scores[n] = (z, signal)
        stragglers = []
        for n, st in nodes.items():
            z, signal = scores[n]
            flagged = z >= self.k_sigma
            if flagged:
                stragglers.append(n)
                if st.straggler_since is None:
                    st.straggler_since = now
                    metrics.bump("obs_fleet_stragglers_flagged", node=n)
                    flightrec.record("straggler_flagged", node=n,
                                     signal=signal, score=round(z, 2))
                st.straggler_signal = signal
            else:
                st.straggler_since = None
                st.straggler_signal = None
            metrics.gauge("obs_fleet_straggler_score", round(z, 3), node=n)
            if st.last_at is not None:
                metrics.gauge("obs_fleet_scrape_age_s",
                              round(now - st.last_at, 3), node=n)
            d = latest[n] or {}
            if isinstance(d.get("converge_p99_s"), (int, float)):
                metrics.gauge("obs_fleet_converge_p99_s",
                              round(d["converge_p99_s"], 6), node=n)
            if isinstance(d.get("round_flush_mean_s"), (int, float)):
                metrics.gauge("obs_fleet_round_flush_s",
                              round(d["round_flush_mean_s"], 6), node=n)
        fresh = sum(1 for st in nodes.values() if _fresh(st))
        metrics.gauge("obs_fleet_nodes_scraped", fresh)

        def _agg(key, how):
            vals = [d[key] for d in latest.values()
                    if d is not None and isinstance(d.get(key),
                                                    (int, float))]
            if not vals:
                return None
            if how == "sum":
                return round(sum(vals), 6)
            if how == "max":
                return round(max(vals), 6)
            vals.sort()
            return round(vals[len(vals) // 2], 6)

        rollup = {
            "nodes": len(nodes),
            "nodes_fresh": fresh,
            "ops_per_s": _agg("ops_per_s", "sum"),
            "converge_p99_s": _agg("converge_p99_s", "max"),
            "round_flush_mean_s": _agg("round_flush_mean_s", "median"),
            "frames_dropped": _agg("frames_dropped", "sum"),
            "watchdog_fires": _agg("watchdog_fires", "sum"),
            "retraced": _agg("retraced", "sum"),
            "dispatch_amplification": _agg("dispatch_amplification",
                                           "max"),
            "dispatch_pad_waste_pct": _agg("dispatch_pad_waste_pct",
                                           "max"),
            "tenant_converge_p99_s": _agg("tenant_converge_p99_s",
                                          "max"),
            "tenant_hot_share_pct": _agg("tenant_hot_share_pct", "max"),
            "trace_critical_p99_s": _agg("trace_critical_p99_s", "max"),
        }
        tenants = self._tenant_rollup(nodes)
        if tenants:
            rollup["tenants"] = tenants
        self._last_state = {
            "at": now,
            "rollup": rollup,
            "stragglers": stragglers,
            "nodes": {
                n: {
                    "role": st.role,
                    "age_s": (round(now - st.last_at, 3)
                              if st.last_at is not None else None),
                    "stale": not _fresh(st),
                    "quarantined": st.quarantined,
                    "straggler_score": round(scores[n][0], 3),
                    "straggler_signal": st.straggler_signal,
                    "flagged": n in stragglers,
                    "derived": latest[n],
                } for n, st in nodes.items()},
            "scrape": self.scrape_stats(),
        }
        return self._last_state

    def _tenant_rollup(self, nodes: dict[str, NodeState]) -> dict:
        """Fleet-wide per-tenant merge over every scraped node's
        `"tenantledger"` section (sync/tenantledger.py): cost counters
        SUM across nodes (each node accounts its own traffic exactly
        once), converge p99 takes the worst node, and the ingress share
        is recomputed from the merged totals — so one hot tenant on one
        shard still reads hot fleet-wide. Empty when no node ships the
        section."""
        merged: dict[str, dict] = {}
        total = 0
        for st in nodes.values():
            snap = st.last_snapshot
            if not isinstance(snap, dict):
                continue
            for sec in ((snap.get("tenantledger") or {}).get("nodes")
                        or {}).values():
                for tid, t in ((sec or {}).get("tenants") or {}).items():
                    m = merged.setdefault(tid, {
                        "admitted": 0, "bytes_sent": 0,
                        "bytes_received": 0, "dispatch_share": 0.0,
                        "shed": 0, "converge_p99_s": None})
                    m["admitted"] += int(t.get("admitted") or 0)
                    m["bytes_sent"] += int(t.get("bytes_sent") or 0)
                    m["bytes_received"] += int(t.get("bytes_received")
                                               or 0)
                    m["dispatch_share"] += float(t.get("dispatch_share")
                                                 or 0.0)
                    m["shed"] += (int(t.get("shed_dropped") or 0)
                                  + int(t.get("shed_delayed") or 0))
                    p99 = (t.get("lag") or {}).get("p99_s")
                    if isinstance(p99, (int, float)):
                        cur = m["converge_p99_s"]
                        m["converge_p99_s"] = (float(p99) if cur is None
                                               else max(cur, float(p99)))
                    total += int(t.get("admitted") or 0)
        for m in merged.values():
            m["dispatch_share"] = round(m["dispatch_share"], 4)
            m["ingress_share_pct"] = (
                round(100.0 * m["admitted"] / total, 3) if total
                else None)
        return merged

    # -- read surface ---------------------------------------------------------

    def fleet_state(self) -> dict:
        """The latest judged fleet view (computed by scrape_once)."""
        return getattr(self, "_last_state", None) or self._judge(time.time())

    def stragglers(self) -> list[str]:
        return list(self.fleet_state()["stragglers"])

    def scrape_costs(self) -> list[float]:
        """Per-tick scrape wall costs (bounded window, oldest first) —
        the raw feed bench config 11 aggregates across sub-runs."""
        return list(self._scrape_costs)

    def scrape_stats(self) -> dict:
        p50, p99 = cost_percentiles(self._scrape_costs)
        return {"ticks": self.ticks, "p50_s": p50, "p99_s": p99}

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "FleetCollector":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="amtpu-torch-fleet-collector",
                daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        """Stop and join the scrape thread (idempotent)."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.scrape_once()
            except Exception:
                import logging
                logging.getLogger("automerge_tpu_torch.fleet").exception(
                    "fleet scrape tick failed")


def connect_sources(addrs: list[str], wire: str = "json"):
    """CLI helper (`perf top --connect`, `perf doctor --connect`): open a
    throwaway TcpSyncClient per `host:port`, return ([(name, connection),
    ...], close_fn). The client's empty DocSet syncs nothing; the
    connection exists to carry metrics pulls, so it lives on the CPU
    whatever device the scraped nodes use."""
    from ..sync.docset import DocSet
    from ..sync.tcp import TcpSyncClient

    clients = []
    conns = []
    for addr in addrs:
        host, _, port = addr.rpartition(":")
        cli = TcpSyncClient(DocSet(device="cpu"), host or "127.0.0.1",
                            int(port),
                            wire=wire).start()
        clients.append(cli)
        conns.append((addr, cli.peer.connection))

    def close():
        for c in clients:
            try:
                c.close()
            except Exception:
                pass
    return conns, close
