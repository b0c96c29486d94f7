"""SLO-driven remediation: diagnosis becomes bounded self-healing.

The fleet plane built in rounds 10-12 detects everything and heals
nothing: the collector flags stragglers (perf/fleet.py), the SLO engine
judges breaches (perf/slo.py), the doctor ranks root causes
(perf/doctor.py) — and then every verdict waits for a human. ROADMAP #4
calls that gap "the difference between an observable fleet and an
operable one"; the scale/latency regime of arxiv 1303.7462 demands the
closed loop: a fleet serving millions of users must not just degrade
gracefully, it must RECOVER gracefully, without operator action.

This module is the policy engine that closes the loop. A
`RemediationEngine` rides the collector's tick (FleetCollector.
remediator), judges the same state + SLO verdicts the operator would,
and maps (cause, node) to a small set of bounded, fully-disclosed
actions:

    cause observed                       action
    ----------------------------------   ---------------------------------
    straggler flagged, doctor cause in   `quarantine`: exclude the node
    {slow_apply, lock_contention,        from scoring/rollups/SLO
    frame_loss, retrace_storm,           membership (FleetCollector.
    watchdog_stall}                      quarantine), run the deployment's
                                         isolation hook (on_quarantine),
                                         and re-home its relay subtree
                                         onto a healthy hub
                                         (rehome_children: RelayHub.
                                         detach_child + adopt — the relay's
                                         crash re-home path, driven
                                         automatically)
    quarantine executed, node has a      `re_bootstrap`: run the node's
    registered bootstrapper              registered rebuild-from-storage
                                         executor (typically
                                         EngineDocSet.
                                         bootstrap_from_storage —
                                         snapshot + archived tail,
                                         sync/snapshots.py; the r15
                                         storage tier this action was
                                         blocked on)
    tracked node gone stale (dead or     `reconnect`: kick the node's
    wedged transport, chaos conn_kill/   registered SupervisedTcpClient
    peer_hang)                           (sync/tcp.py) — exponential-
                                         backoff redial + resubscribe()
                                         targeted backfill
    converge-p99 breach sustained        `governor_escalate` /
    (rollup)                             `governor_relax`: step the
                                         IngressGovernor up the
                                         delay -> shed ladder, and back
                                         down with hysteresis
                                         (GovernorLadder) — replacing
                                         the single-SLO governor coupling

Every action passes GUARDRAILS before it runs, because an automated
responder that misfires is worse than none:

- **per-action cooldowns** — the same (action, node) cannot repeat
  inside `cooldown_s` (per-action overrides supported);
- **a global actions-per-window budget** — at most `budget` executed
  actions per `window_s`, fleet-wide;
- **minimum-healthy-quorum** — a quarantine that would leave the
  healthy nodes at or below `min_healthy_fraction` of the fleet is
  refused: remediation can NEVER quarantine the majority;
- **dry-run** (`AMTPU_REMED_DRY_RUN=1` or `dry_run=True`) — intended
  actions are logged and disclosed (`remed_action` with dry_run=true,
  `obs_remed_skipped{reason=dry_run}`) and nothing executes.

Disclosure is total: executed actions land on
`obs_remed_actions{action=...}` + a `remed_action` flightrec event;
withheld ones on `obs_remed_skipped{reason=...}`; every escalation
(quarantine, governor_escalate) auto-captures a flight-recorder dump
WITH the live doctor report embedded (`remed:<action>` — rate-limited
per trigger class by flightrec's dump cooldown, so an escalation loop
cannot storm the disk); and a closed episode — fleet back to green
after >= 1 action — records `remed_recovered` with the measured MTTR.

The chaos suite (utils/chaos.py) is the acceptance harness: bench
config 14 injects each fault class into a live multi-process fleet and
measures MTTR — time from injection to SLO-green with zero human
action — gated in `perf check` (docs/OBSERVABILITY.md "Remediation
plane").
"""

from __future__ import annotations

import os
import time
from collections import deque

from ..utils import flightrec, metrics

#: default per-(action, node) cooldown between repeats
DEFAULT_COOLDOWN_S = 30.0
#: default global executed-actions budget per window
DEFAULT_BUDGET = 6
DEFAULT_WINDOW_S = 120.0
#: default minimum fraction of the fleet that must REMAIN healthy
#: (non-quarantined) after any quarantine — strict: never the majority
DEFAULT_MIN_HEALTHY = 0.5
#: consecutive green ticks before an episode is declared recovered
GREEN_STREAK_TICKS = 2

#: doctor causes that justify quarantining the flagged node — all are
#: node-local degradations where isolating the node protects the fleet;
#: doc_stall/gc_pressure are NOT here (a lagging doc or a GC pass is
#: not a reason to cut a node off)
QUARANTINE_CAUSES = frozenset((
    "slow_apply", "lock_contention", "frame_loss", "retrace_storm",
    "watchdog_stall"))


def fleet_green(state: dict, verdicts: dict | None) -> tuple[bool, list]:
    """The remediation plane's health predicate over one judged fleet
    state: green iff no SLO verdict is in breach, no (non-quarantined)
    straggler is flagged, and no tracked node that HAS reported is
    stale. A node that never reported at all (age None — the startup
    handshake window) is pending, not red: remediation must not fire
    on a fleet that merely hasn't finished assembling. Returns
    (green, red_reasons)."""
    reasons: list[str] = []
    for name, v in (verdicts or {}).items():
        if isinstance(v, dict) and v.get("ok") is False:
            reasons.append(f"slo:{name}")
    for n in state.get("stragglers") or ():
        reasons.append(f"straggler:{n}")
    for n, rec in (state.get("nodes") or {}).items():
        if rec.get("quarantined"):
            continue
        if rec.get("stale") and rec.get("age_s") is not None:
            reasons.append(f"stale:{n}")
    return (not reasons, sorted(reasons))


class Guardrails:
    """The bounded-action contract every remediation passes through."""

    def __init__(self, cooldown_s: float = DEFAULT_COOLDOWN_S,
                 budget: int = DEFAULT_BUDGET,
                 window_s: float = DEFAULT_WINDOW_S,
                 min_healthy_fraction: float = DEFAULT_MIN_HEALTHY,
                 per_action_cooldown_s: dict | None = None):
        self.cooldown_s = cooldown_s
        self.budget = budget
        self.window_s = window_s
        self.min_healthy_fraction = min_healthy_fraction
        self.per_action = dict(per_action_cooldown_s or {})
        self._last: dict[tuple, float] = {}
        self._window: deque = deque()

    def check(self, action: str, node: str | None,
              now: float) -> str | None:
        """None = allowed; else the denial reason ("cooldown" /
        "budget"). The quorum check lives on the engine — it needs the
        fleet state, not just the action history."""
        cd = self.per_action.get(action, self.cooldown_s)
        last = self._last.get((action, node))
        if last is not None and now - last < cd:
            return "cooldown"
        while self._window and now - self._window[0] > self.window_s:
            self._window.popleft()
        if len(self._window) >= self.budget:
            return "budget"
        return None

    def note(self, action: str, node: str | None, now: float,
             consume_budget: bool = False) -> None:
        """Record an attempt: cooldown always stamps (dry-run included —
        one intended-action log per cooldown, not one per tick); only
        EXECUTED actions consume the global budget."""
        self._last[(action, node)] = now
        if consume_budget:
            self._window.append(now)


class GovernorLadder:
    """Escalate the admission governor delay -> shed and relax it back
    with hysteresis — the replacement for the single-edge SLO
    coupling (breach => shed, recover => open), which flapped on any
    p99 hovering at the bound.

    Stages: 0 open, 1 delay (low-priority ingress throttled), 2 shed
    (low-priority ingress refused). Escalation requires the breach to
    SUSTAIN (`sustain_s` to enter delay; `escalate_s` more to enter
    shed); relaxation requires p99 to drop below `recover_frac * bound`
    (the hysteresis band) and HOLD there for `recover_sustain_s`, one
    stage at a time. `desired()` is the pure decision; `apply()`
    (called by the engine through its guardrails) drives the governor
    via IngressGovernor.force, which discloses each flip on the
    existing shed_transition plane."""

    STAGES = ("open", "delay", "shed")

    def __init__(self, governor, bound_s: float = 2.0,
                 sustain_s: float = 1.0, escalate_s: float = 4.0,
                 recover_frac: float = 0.7,
                 recover_sustain_s: float = 2.0):
        self.governor = governor
        self.bound_s = bound_s
        self.sustain_s = sustain_s
        self.escalate_s = escalate_s
        self.recover_frac = recover_frac
        self.recover_sustain_s = recover_sustain_s
        self.stage = 0
        self._breach_since: float | None = None
        self._ok_since: float | None = None

    def desired(self, p99_s: float | None,
                now: float | None = None) -> int:
        """The stage this ladder wants, given one converge-p99
        observation. None (no data) never moves the ladder."""
        if p99_s is None:
            return self.stage
        now = time.monotonic() if now is None else now
        if p99_s > self.bound_s:
            self._ok_since = None
            if self._breach_since is None:
                self._breach_since = now
            dur = now - self._breach_since
            if self.stage == 0:
                return 1 if dur >= self.sustain_s else 0
            if self.stage == 1:
                return 2 if dur >= self.escalate_s else 1
            return 2
        self._breach_since = None
        if self.stage == 0:
            self._ok_since = None
            return 0
        if p99_s <= self.bound_s * self.recover_frac:
            if self._ok_since is None:
                self._ok_since = now
            if now - self._ok_since >= self.recover_sustain_s:
                self._ok_since = now    # re-arm for the next step down
                return self.stage - 1
        else:
            # inside the hysteresis band (recovered past the bound but
            # not past recover_frac): hold — this is what kills the
            # flapping the single-edge coupling suffered
            self._ok_since = None
        return self.stage

    def apply(self, stage: int, p99_s: float | None = None) -> None:
        stage = max(0, min(2, int(stage)))
        p99 = float(p99_s or 0.0)
        if stage == 0:
            self.governor.force(False, p99_s=p99)
        elif stage == 1:
            self.governor.force(True, mode="delay", p99_s=p99)
        else:
            self.governor.force(True, mode="shed", p99_s=p99)
        self.stage = stage
        # a transition resets the sustain timers: the NEXT escalation
        # needs its own fresh sustained breach
        self._breach_since = None
        self._ok_since = None
        metrics.gauge("obs_remed_governor_stage", stage)


def rehome_children(dead_hub, new_hub, rebuild_conn=None) -> list:
    """Re-home a quarantined/dead hub's relay subtree onto a healthy
    hub — the automated drive of the relay's crash re-home path: each child
    is detached (releasing its cover refs so the dead hub's upstream
    subscriptions shrink), optionally rebuilt (`rebuild_conn(old_conn)
    -> new hub-side Connection` when the transports died with the hub;
    in-process topologies can reuse the connection object), and adopted
    by `new_hub` (RelayHub.adopt — relay_rehome event + interest
    re-merge). The child side replays its interest with clocks
    (Connection.resubscribe) and the ordinary backfill ships whatever
    the subtree missed. Returns the adopted connections."""
    moved = []
    for conn in list(dead_hub.children()):
        dead_hub.detach_child(conn)
        nc = rebuild_conn(conn) if rebuild_conn is not None else conn
        new_hub.adopt(nc)
        moved.append(nc)
    return moved


class RemediationEngine:
    """The policy engine: collector state + SLO verdicts in, bounded
    disclosed actions out. Attach with `RemediationEngine(collector,
    slo_engine)` — the constructor installs itself as
    `collector.remediator`, so every scrape tick runs one judging pass
    after the SLO evaluation."""

    def __init__(self, collector, slo_engine=None,
                 guardrails: Guardrails | None = None,
                 dry_run: bool | None = None,
                 capture_dumps: bool = True,
                 quarantine_causes=QUARANTINE_CAUSES,
                 green_streak_ticks: int = GREEN_STREAK_TICKS,
                 quarantine_after_ticks: int = 2):
        self.collector = collector
        self.slo_engine = slo_engine
        self.guardrails = guardrails or Guardrails()
        if dry_run is None:
            dry_run = os.environ.get("AMTPU_REMED_DRY_RUN") == "1"
        self.dry_run = bool(dry_run)
        self.capture_dumps = capture_dumps
        self.quarantine_causes = frozenset(quarantine_causes)
        self.green_streak_ticks = green_streak_ticks
        # a straggler flag must SUSTAIN this many consecutive ticks
        # before quarantine: one bad sample window is not a sick node.
        # (Measured in anger: a transport death's retry-drop burst makes
        # the node's drop-rate deviate for exactly one window right as
        # its supervisor finishes healing it — isolating it then would
        # punish recovery.)
        self.quarantine_after_ticks = quarantine_after_ticks
        self._flag_streaks: dict[str, int] = {}
        #: deployment isolation hook: called with the node label AFTER
        #: the collector-side quarantine (close its transports, stop
        #: routing to it, page nobody) — None means health-plane
        #: exclusion + re-homing only
        self.on_quarantine = None
        self.ladder: GovernorLadder | None = None
        self._supervisors: dict[str, object] = {}
        self._hubs: dict[str, object] = {}
        self._bootstrappers: dict[str, object] = {}
        #: bounded log of intended/executed actions — the dry-run proof
        #: surface (bench config 14 asserts the intentions were logged
        #: while nothing ran)
        self.log: deque = deque(maxlen=256)
        self.last_recovery: dict | None = None
        self._episode: dict | None = None
        self._tick_costs: deque = deque(maxlen=256)
        self._diagnosis_cache: tuple | None = None   # (tick, report)
        self._slo_transitions: deque = deque(maxlen=64)
        collector.remediator = self
        # the deque exists BEFORE the hook installs: the collector
        # thread may evaluate SLOs between these two statements
        if slo_engine is not None and slo_engine.on_transition is None:
            slo_engine.on_transition = self._on_slo_transition

    # -- wiring ---------------------------------------------------------------

    def attach_ladder(self, governor, **kw) -> GovernorLadder:
        """Own an IngressGovernor through the delay->shed escalation
        ladder (kw forwarded to GovernorLadder)."""
        self.ladder = GovernorLadder(governor, **kw)
        return self.ladder

    def register_supervisor(self, node: str, supervisor) -> None:
        """Register a node's SupervisedTcpClient (anything with
        force_reconnect()) as the `reconnect` action's executor."""
        self._supervisors[node] = supervisor

    def register_hub(self, node: str, hub) -> None:
        """Register the RelayHub a node label fronts; quarantining that
        node re-homes the hub's children onto the healthiest OTHER
        registered hub."""
        self._hubs[node] = hub

    def register_bootstrapper(self, node: str, fn) -> None:
        """Register a node's re-bootstrap executor: a zero-arg callable
        that rebuilds the node's replica from the storage tier —
        typically EngineDocSet.bootstrap_from_storage on a fresh
        service (snapshot + archived tail, sync/snapshots.py), the
        fast path r12's remediation plane was blocked on. After a
        successful quarantine of `node`, the engine attempts the
        `re_bootstrap` action through the same guardrails; the healed
        replica re-joins via the ordinary reconnect/resubscribe path."""
        self._bootstrappers[node] = fn

    def _on_slo_transition(self, name, ok, value, bound) -> None:
        self._slo_transitions.append(
            {"slo": name, "ok": ok, "value": value, "bound": bound,
             "at": time.time()})

    def _drain_slo_transitions(self) -> list[dict]:
        out = []
        while self._slo_transitions:
            out.append(self._slo_transitions.popleft())
        return out

    # -- the judging pass -----------------------------------------------------

    def tick(self, state: dict | None = None) -> dict:
        """One judging pass (called by the collector after its SLO
        evaluation). Returns a summary of what was decided."""
        t0 = time.perf_counter()
        now = time.time()
        if state is None:
            state = self.collector.fleet_state()
        verdicts = self.slo_engine.verdicts if self.slo_engine else {}
        green, reasons = fleet_green(state, verdicts)
        # drain the SLO transition feed: breach edges carry the EXACT
        # moment health flipped (the tick only observes it afterwards),
        # so a fresh episode is backdated to the earliest breach edge —
        # the MTTR it reports measures from the flip, not from the next
        # scrape
        breach_edges = [t["at"] for t in self._drain_slo_transitions()
                        if t["ok"] is False]
        if not green:
            if self._episode is None:
                since = min([now] + breach_edges)
                self._episode = {"since": since, "actions": 0,
                                 "reasons": set(reasons),
                                 "green_streak": 0}
            else:
                self._episode["reasons"].update(reasons)
                self._episode["green_streak"] = 0
        decided = []

        flagged_now = set(state.get("stragglers") or ())
        for n in list(self._flag_streaks):
            if n not in flagged_now:
                del self._flag_streaks[n]
        for n in flagged_now:
            rec = (state.get("nodes") or {}).get(n) or {}
            if rec.get("quarantined"):
                continue
            streak = self._flag_streaks.get(n, 0) + 1
            self._flag_streaks[n] = streak
            if streak < self.quarantine_after_ticks:
                continue        # one bad window is not a sick node
            cause = self._diagnose_cause(n)
            if cause not in self.quarantine_causes:
                continue
            if self._attempt(
                    "quarantine", n,
                    lambda n=n: self._execute_quarantine(n),
                    evidence=(f"straggler {n} (signal "
                              f"{rec.get('straggler_signal')}, score "
                              f"{rec.get('straggler_score')}): doctor "
                              f"cause {cause}"),
                    escalation=True):
                decided.append(("quarantine", n))
                boot = self._bootstrappers.get(n)
                if boot is not None and self._attempt(
                        "re_bootstrap", n, boot,
                        evidence=(f"quarantined {n} has a registered "
                                  "bootstrapper — rebuilding its replica "
                                  "from snapshot + archived tail")):
                    decided.append(("re_bootstrap", n))

        for n, rec in (state.get("nodes") or {}).items():
            if not rec.get("stale") or rec.get("quarantined") \
                    or rec.get("age_s") is None:
                continue
            sup = self._supervisors.get(n)
            if sup is None:
                continue
            if self._attempt(
                    "reconnect", n,
                    lambda sup=sup: sup.force_reconnect(),
                    evidence=(f"node {n} stale for {rec.get('age_s')}s "
                              "with a live supervisor — forcing a "
                              "redial")):
                decided.append(("reconnect", n))

        if self.ladder is not None:
            p99 = (state.get("rollup") or {}).get("converge_p99_s")
            target = self.ladder.desired(
                p99 if isinstance(p99, (int, float)) else None)
            cur = self.ladder.stage
            if target != cur:
                step = cur + (1 if target > cur else -1)
                action = ("governor_escalate" if target > cur
                          else "governor_relax")
                if self._attempt(
                        action, None,
                        lambda s=step, p=p99: self.ladder.apply(s, p),
                        evidence=(f"converge p99 {p99}s vs bound "
                                  f"{self.ladder.bound_s}s: stage "
                                  f"{self.ladder.STAGES[cur]} -> "
                                  f"{self.ladder.STAGES[step]}"),
                        escalation=(target > cur)):
                    decided.append((action, None))

        ep = self._episode
        if ep is not None and green:
            ep["green_streak"] += 1
            if ep["green_streak"] >= self.green_streak_ticks:
                if ep["actions"]:
                    mttr = now - ep["since"]
                    metrics.bump("obs_remed_recovered")
                    flightrec.record(
                        "remed_recovered", mttr_s=round(mttr, 3),
                        actions=ep["actions"],
                        reasons=sorted(ep["reasons"])[:6])
                    self.last_recovery = {"mttr_s": mttr,
                                          "actions": ep["actions"],
                                          "at": now}
                self._episode = None

        dt = time.perf_counter() - t0
        self._tick_costs.append(dt)
        metrics.observe("obs_remed_tick_s", dt)
        return {"green": green, "reasons": reasons, "decided": decided}

    def tick_costs(self) -> list[float]:
        """Per-tick judging wall costs (bounded window) — the feed for
        the config-14 steady-state duty-cycle bound."""
        return list(self._tick_costs)

    # -- actions --------------------------------------------------------------

    def _diagnose_cause(self, node: str) -> str | None:
        """The live doctor's top cause FOR this node (one diagnosis per
        collector tick, cached)."""
        from .doctor import diagnose_live
        tick = self.collector.ticks
        if self._diagnosis_cache is None \
                or self._diagnosis_cache[0] != tick:
            try:
                self._diagnosis_cache = (tick, diagnose_live(self.collector))
            except Exception:
                return None
        for c in self._diagnosis_cache[1].get("causes") or ():
            if c.get("node") == node:
                return c.get("cause")
        return None

    def _quorum_denial(self, node: str) -> str | None:
        nodes = self.collector.nodes
        total = len(nodes)
        q_after = sum(1 for st in nodes.values() if st.quarantined) + 1
        if total - q_after <= total * self.guardrails.min_healthy_fraction:
            return "quorum"
        return None

    def _execute_quarantine(self, node: str) -> None:
        # fallible steps FIRST (the deployment hook, the re-home): if
        # one raises, the collector-side quarantine below never runs
        # and the reported not-executed outcome matches reality — the
        # inverse order would leave the node silently quarantined while
        # every disclosure surface says the action was withheld
        if self.on_quarantine is not None:
            self.on_quarantine(node)
        hub = self._hubs.get(node)
        if hub is not None:
            target = self._healthiest_hub(exclude=node)
            if target is not None:
                rehome_children(hub, target)
        self.collector.quarantine(node)

    def _healthiest_hub(self, exclude: str):
        state = self.collector.fleet_state()
        nodes = state.get("nodes") or {}
        best = None
        for label, hub in self._hubs.items():
            if label == exclude:
                continue
            rec = nodes.get(label) or {}
            if rec.get("quarantined") or rec.get("flagged"):
                continue
            if best is None or (rec.get("straggler_score") or 0.0) < \
                    (nodes.get(best) or {}).get("straggler_score", 0.0):
                best = label
        return self._hubs.get(best) if best is not None else None

    def _attempt(self, action: str, node: str | None, execute,
                 evidence: str, escalation: bool = False) -> bool:
        now = time.monotonic()
        denial = self.guardrails.check(action, node, now)
        if denial is None and action == "quarantine":
            denial = self._quorum_denial(node)
        if denial is not None:
            metrics.bump("obs_remed_skipped", reason=denial)
            return False
        entry = {"action": action, "node": node, "dry_run": self.dry_run,
                 "evidence": evidence, "at": time.time()}
        self.log.append(entry)
        if self.dry_run:
            # intended, disclosed, NOT executed — and the cooldown
            # stamps so the intention logs once per window, not per tick
            self.guardrails.note(action, node, now)
            metrics.bump("obs_remed_skipped", reason="dry_run")
            flightrec.record("remed_action", action=action, node=node,
                             dry_run=True, evidence=evidence)
            return False
        try:
            execute()
        except Exception:
            import logging
            logging.getLogger("automerge_tpu_torch.remediate").exception(
                "remediation action %s@%s failed", action, node)
            metrics.bump("obs_remed_skipped", reason="error")
            # a failed action still stamps its cooldown (not the
            # budget): a persistently-raising handler must not be
            # retried — with a full logged traceback — on every tick
            self.guardrails.note(action, node, now)
            return False
        self.guardrails.note(action, node, now, consume_budget=True)
        metrics.bump("obs_remed_actions", action=action)
        flightrec.record("remed_action", action=action, node=node,
                         dry_run=False, evidence=evidence)
        if self._episode is not None:
            self._episode["actions"] += 1
        if escalation and self.capture_dumps:
            report = (self._diagnosis_cache[1]
                      if self._diagnosis_cache is not None else None)
            flightrec.dump(f"remed:{action}",
                           extra={"remediation": entry, "doctor": report})
        return True


# ---------------------------------------------------------------------------
# the chaos-recovery smoke


def smoke_main(argv=None) -> int:
    """One injected fault, assert recovery: a supervised TCP link is
    torn down mid-stream by the chaos conn_kill fault and must redial +
    reconverge with zero human action. Fast (~seconds) and self-
    contained — the proof that the self-healing path still works
    (`chip_smoke.py` phase 16 runs it on the card)."""
    import argparse

    from .. import api as am
    from ..device import resolve_device
    from ..sync.docset import DocSet
    from ..sync.tcp import SupervisedTcpClient, TcpSyncServer
    from ..utils import chaos

    ap = argparse.ArgumentParser(prog="automerge_tpu_torch.perf remediate")
    ap.add_argument("--smoke", action="store_true",
                    help="run the chaos-recovery smoke (default)")
    ap.add_argument("--timeout", type=float, default=20.0)
    ap.add_argument("--device", default="cuda",
                    help="the documents' device (cuda, or cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    prev = {k: os.environ.get(k) for k in
            ("AMTPU_CHAOS_CONN_KILL_AFTER", "AMTPU_CHAOS_NODE")}
    os.environ["AMTPU_CHAOS_CONN_KILL_AFTER"] = "8"
    os.environ["AMTPU_CHAOS_NODE"] = "smoke-client"
    chaos.reload()
    ds_server, ds_client = DocSet(device=device), DocSet(device=device)
    ds_client._chaos_node = "smoke-client"
    server = TcpSyncServer(ds_server)
    server.start()
    reconnects0 = metrics.snapshot().get("sync_reconnects", 0)
    sup = SupervisedTcpClient(ds_client, server.host, server.port,
                              backoff_s=0.1, node="smoke-client").start()
    t0 = time.monotonic()
    try:
        from ..sync.tcp import sync_lock
        doc = am.init("smoke", device=device)
        for k in range(24):
            doc = am.change(doc, lambda d, k=k: d.__setitem__(f"k{k}", k))
            with sync_lock(ds_client):
                ds_client.set_doc("smoke-doc", doc)
            time.sleep(0.05)

        deadline = time.monotonic() + args.timeout
        converged = False
        while time.monotonic() < deadline:
            got = ds_server.get_doc("smoke-doc")
            if got is not None and got == ds_client.get_doc("smoke-doc"):
                converged = True
                break
            time.sleep(0.1)
        reconnects = metrics.snapshot().get("sync_reconnects", 0) \
            - reconnects0
        dt = time.monotonic() - t0
        if converged and reconnects >= 1:
            print(f"chaos-recovery smoke: RECOVERED in {dt:.2f}s — one "
                  f"conn_kill mid-stream, {int(reconnects)} supervised "
                  "reconnect(s), server == client with zero human action")
            return 0
        print(f"chaos-recovery smoke: FAILED (converged={converged}, "
              f"reconnects={int(reconnects)} after {dt:.2f}s)")
        return 1
    finally:
        sup.close()
        server.close()
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        chaos.reload()


if __name__ == "__main__":
    raise SystemExit(smoke_main())
