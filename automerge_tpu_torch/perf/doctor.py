"""`perf doctor`: an automated root-cause correlation engine.

The instruments answer "what happened" channel by channel — watchdog
fires, lock-holder tables, oplag stage percentiles, retrace counters, GC
attribution, frame-drop counts. The doctor JOINS them on one timeline
and emits a RANKED root-cause report, in two modes:

- **live** (`diagnose_live(collector)`): fleet-relative. For every node
  the collector scrapes, each candidate cause gets a robust deviation
  score against the fleet median of its role group (perf/fleet.py
  scoring), with cross-signal corrections — a slow flush drags the
  service lock with it, so lock contention is only credited for the
  wait a slow apply does NOT explain. The ranking is what the bench's
  fault-injection config asserts on: the injected fault class must come
  out first.
- **post-mortem** (`diagnose_detail` / `diagnose_dump` /
  `diagnose_snapshot`): absolute. A `BENCH_DETAIL.json` yields one
  section per config; a flight-recorder dump additionally yields the
  event-timeline join — each watchdog fire is correlated with the lock
  holders it embedded (WHO held WHAT when the region stalled), the
  oplag stage spikes and retraced dispatches around it. Scores here are
  roughly "seconds attributed to the cause", so the ranking reads as a
  wall-time budget.

Cause classes (stable identifiers — the bench asserts on them):

    slow_apply       round flushes themselves are slow (engine/apply)
    lock_contention  waiting on the service lock dominates, flushes fine
    frame_loss       outgoing change frames are being dropped
    retrace_storm    jit compile-cache misses on the hot path
    gc_pressure      GC passes landing inside timed regions
    watchdog_stall   a watched region overran its budget (with holders)
    doc_stall        specific DOCS are behind a peer's advertised
                     frontier (the docledger section) — the evidence
                     names them and points at `perf explain <doc>` for
                     the per-doc causal walk (perf/explain.py)
    storage_stall    archive/snapshot fsyncs dominate (slow or stalled
                     disk — the chaos `disk_stall` fault class): slow
                     appends and slow bootstraps attribute to the
                     STORAGE tier, not the engine (r15 storage tier)
    dispatch_amplification
                     the engine is paying several routed dispatches per
                     dirty doc (the dispatchledger window rollup), with
                     padding-waste evidence — the regime ROADMAP #2's
                     megabatching collapses; `perf dispatch` prints the
                     opportunity report (r17 dispatch ledger)
    tenant_hot       one tenant dominates the fleet's ingress/dispatch
                     shares while OTHER tenants' converge-p99 degrades
                     (the tenantledger section) — the noisy-neighbor
                     regime ROADMAP #5's per-tenant QoS ladder divides;
                     the evidence names the hot tenant's shares and the
                     degraded victims, and `perf tenant` prints the full
                     attribution report (r18 tenant plane)
    coalesce_wait_hot / wire_serialize_hot / remote_admission_hot
                     one lifecycle stage dominates the sampled end-to-
                     end critical path (the traceplane section's stage
                     rollup, visibility excluded — that stage is read-
                     cadence bound by design). Each hot stage has a
                     distinct owner: coalesce_wait is the flush
                     governor/round cadence, wire_serialize the frame
                     encoder, remote_admission the receiver's apply
                     lock. `perf trace` prints the stage table and the
                     slowest stitched waterfalls (r19 trace plane)

CLI: `python -m automerge_tpu_torch.perf doctor [--post-mortem PATH]
[--config N] [--json] [--connect host:port,... --ticks N]`. With no
arguments it reads the port's bench detail (`history.detail_path()`)
and exits 0 even when there is nothing to diagnose — absence of
evidence is not a build failure.
"""

from __future__ import annotations

import json
import os
import sys
import time

from . import history
from .contention import lock_table, stage_table


# ---------------------------------------------------------------------------
# report assembly


def _cause(causes: list, cause: str, node: str | None, score: float,
           evidence: list[str]) -> None:
    if score > 0:
        causes.append({"cause": cause, "node": node,
                       "score": round(float(score), 3),
                       "evidence": evidence})


def _ranked(causes: list) -> list:
    """Merge same-(cause, node) entries (max score, evidence
    concatenated) and rank most-severe first."""
    merged: dict[tuple, dict] = {}
    for c in causes:
        key = (c["cause"], c.get("node"))
        cur = merged.get(key)
        if cur is None:
            merged[key] = {"cause": c["cause"], "node": c.get("node"),
                           "score": c["score"],
                           "evidence": list(c.get("evidence") or [])}
        else:
            cur["score"] = max(cur["score"], c["score"])
            for ev in c.get("evidence") or []:
                if ev not in cur["evidence"]:
                    cur["evidence"].append(ev)
    return sorted(merged.values(), key=lambda c: -c["score"])


# ---------------------------------------------------------------------------
# live mode (fleet-relative)


def diagnose_live(collector) -> dict:
    """Ranked causes from a FleetCollector's current per-node view.
    Fleet-relative: each signal's robust deviation score vs the node's
    role-group median (perf/fleet.robust_scores), with the slow-flush
    correction on lock contention."""
    from .fleet import STRAGGLER_SIGNALS, robust_scores

    state = collector.fleet_state()
    latest = {n: (state["nodes"][n].get("derived") or {})
              for n in state["nodes"]}
    roles: dict[str, list[str]] = {}
    for n, rec in state["nodes"].items():
        roles.setdefault(rec["role"], []).append(n)

    def zscores(signal: str) -> tuple[dict, dict]:
        """(per-node score, per-node raw value) across each role group."""
        z: dict[str, float] = {}
        raw: dict[str, float] = {}
        floor = STRAGGLER_SIGNALS.get(signal, 0.01)
        for members in roles.values():
            vals = {n: latest[n].get(signal) for n in members}
            vals = {n: float(v) for n, v in vals.items()
                    if isinstance(v, (int, float))}
            raw.update(vals)
            if len(vals) >= collector.min_nodes:
                z.update(robust_scores(vals, floor))
        return z, raw

    z_flush, raw_flush = zscores("round_flush_mean_s")
    z_lock, raw_lock = zscores("lock_wait_rate")
    z_drop, raw_drop = zscores("drop_rate")
    z_retrace, raw_retrace = zscores("retrace_rate")
    z_conv, raw_conv = zscores("converge_p99_s")

    causes: list = []
    for n in state["nodes"]:
        zf = z_flush.get(n, 0.0)
        zl = z_lock.get(n, 0.0)
        conv_note = (f"; converge p99 {raw_conv[n]:.3f}s"
                     if isinstance(raw_conv.get(n), float) else "")
        if zf > 0:
            _cause(causes, "slow_apply", n, zf, [
                f"{n}: round-flush mean {raw_flush.get(n, 0):.4f}s "
                f"deviates x{zf:.1f} robust-sigma above the fleet median"
                + conv_note])
        # lock contention is only credited for the wait a slow flush
        # does NOT explain: a 200ms apply under the lock makes every
        # waiter slow without the LOCK being the root cause
        zl_net = zl - max(zf, 0.0)
        if zl_net > 0:
            _cause(causes, "lock_contention", n, zl_net, [
                f"{n}: service-lock wait rate "
                f"{raw_lock.get(n, 0):.3f} s/s deviates x{zl:.1f} while "
                f"round flushes stay near the fleet median (flush "
                f"deviation x{zf:.1f})" + conv_note])
        zd = z_drop.get(n, 0.0)
        if zd > 0:
            _cause(causes, "frame_loss", n, zd, [
                f"{n}: dropping {raw_drop.get(n, 0):.1f} outgoing "
                f"change frames/s (x{zd:.1f} above fleet median)"])
        zr = z_retrace.get(n, 0.0)
        if zr > 0:
            _cause(causes, "retrace_storm", n, zr, [
                f"{n}: {raw_retrace.get(n, 0):.1f} jit retraces/s "
                f"(x{zr:.1f} above fleet median)"])
        wd = latest[n].get("watchdog_fires_delta")
        if isinstance(wd, (int, float)) and wd > 0:
            _cause(causes, "watchdog_stall", n, 10.0 + wd, [
                f"{n}: {int(wd)} watchdog fire(s) during the last "
                "scrape interval — see the node's flight-recorder dump "
                "for the holder table"])
    return {"mode": "live", "at": state["at"],
            "stragglers": state["stragglers"],
            "causes": _ranked(causes)}


# ---------------------------------------------------------------------------
# post-mortem mode (absolute, per snapshot)


def diagnose_snapshot(snapshot: dict, label: str = "snapshot",
                      extra_causes: list | None = None) -> dict:
    """Ranked causes from ONE metrics snapshot (a bench config's
    `metrics` section, or a raw metrics.snapshot() file). Scores are
    seconds attributed to the cause (counters are scaled into the same
    order of magnitude), so the ranking reads as a wall-time budget."""
    causes: list = list(extra_causes or [])
    locks = lock_table(snapshot)
    stages = stage_table(snapshot)

    flush_total = sum(v for k, v in snapshot.items()
                      if isinstance(v, (int, float))
                      and (k == "sync_round_flush_s"
                           or (k.startswith("sync_round_flush{")
                               and k.endswith("_s"))))
    service_wait = sum(r["wait_s"] for name, r in locks.items()
                       if name.startswith("service"))
    service_hold = sum(r["hold_s"] for name, r in locks.items()
                       if name.startswith("service"))

    wd = sum(v for k, v in snapshot.items()
             if isinstance(v, (int, float))
             and k.startswith("obs_watchdog_fired"))
    if wd > 0:
        _cause(causes, "watchdog_stall", None, 100.0 + wd, [
            f"{int(wd)} watchdog fire(s) recorded — a watched region "
            "overran its budget; the flight-recorder dump embeds the "
            "lock-holder table for each"])

    if service_wait > 0:
        ev = [f"service-lock wait {service_wait:.3f}s "
              f"(hold {service_hold:.3f}s) vs round-flush wall "
              f"{flush_total:.3f}s"]
        qw = stages.get("queue_wait") or {}
        if qw.get("p99_s") is not None:
            ev.append(f"queue_wait stage p99 {qw['p99_s']}s")
        # wait beyond what the flushes themselves occupy points at a
        # non-flush holder (reads, chaos, a wedged peer serve)
        _cause(causes, "lock_contention", None,
               max(service_wait - flush_total, 0.0)
               + 0.25 * min(service_wait, flush_total), ev)

    fl = stages.get("flush") or {}
    if flush_total > 0:
        ev = [f"round flushes total {flush_total:.3f}s"]
        if fl.get("p99_s") is not None:
            ev.append(f"flush stage p99 {fl['p99_s']}s")
        _cause(causes, "slow_apply", None, flush_total, ev)

    drops = snapshot.get("sync_frames_dropped", 0)
    if isinstance(drops, (int, float)) and drops > 0:
        sent = snapshot.get("sync_frames_sent", 0) or 0
        _cause(causes, "frame_loss", None, float(drops), [
            f"{int(drops)} outgoing change frame(s) dropped before the "
            f"socket write ({int(sent)} sent)"])

    # per-doc convergence join (sync/docledger.py): lagging docs in the
    # snapshot's ledger section become a doc_stall cause whose evidence
    # hands off to the per-doc debugger
    from .explain import hot_docs, views_from_snapshot
    rows = hot_docs(views_from_snapshot(snapshot), limit=4)
    if rows:
        ev = [f"doc {r['doc']!r} @ {r['node']}: {r['lag_changes']} "
              f"change(s) / {r['lag_s']:.3f}s behind "
              f"{r['behind_peer'] or '?'}"
              + (f", {r['buffered']} buffered" if r["buffered"] else "")
              for r in rows]
        ev.append("run `perf explain <doc>` for the per-doc causal walk")
        _cause(causes, "doc_stall", None,
               sum(r["lag_s"] for r in rows)
               + 0.1 * sum(r["lag_changes"] for r in rows), ev)

    # storage tier (r15): archive/seal/snapshot fsync wall — when the
    # disk is the bottleneck (chaos disk_stall, or a genuinely slow
    # volume), slow appends and slow bootstraps must attribute HERE,
    # not to the engine. Scored by the fsync seconds themselves, with
    # the worst single fsync as supporting evidence.
    fsync_s = snapshot.get("sync_archive_fsync_s_sum", 0)
    fsync_n = snapshot.get("sync_archive_fsync_s_count", 0)
    fsync_max = snapshot.get("sync_archive_fsync_s_max", 0)
    if isinstance(fsync_s, (int, float)) and fsync_s > 0.5:
        ev = [f"archive/snapshot fsyncs total {fsync_s:.3f}s across "
              f"{int(fsync_n)} syncs (worst {fsync_max}s) — the storage "
              "tier, not the engine, is absorbing the time"]
        boot = snapshot.get("sync_bootstrap_s_sum")
        if isinstance(boot, (int, float)) and boot > 0:
            ev.append(f"replica bootstraps spent {boot:.3f}s total")
        inj = snapshot.get("obs_chaos_injected{fault=disk_stall}", 0)
        if inj:
            ev.append(f"{int(inj)} injected disk_stall fault(s) "
                      "disclosed — chaos run, not an organic disk")
        _cause(causes, "storage_stall", None, float(fsync_s), ev)

    # dispatch-efficiency join (engine/dispatchledger.py): sustained
    # per-doc dispatch amplification, with the pad-waste and per-kernel
    # evidence the ledger's window rollup already folded
    for sec in ((snapshot.get("dispatchledger") or {}).get("nodes")
                or {}).values():
        w = (sec or {}).get("window") or {}
        amp = w.get("amplification")
        disp = (w.get("dispatches") or 0) + (w.get("ambient") or 0)
        if not isinstance(amp, (int, float)) or amp <= 2.0 or disp < 8:
            continue
        ev = [f"{int(disp)} dispatches over {w.get('dirty_docs')} dirty "
              f"doc(s) in {w.get('rounds')} round(s): amplification "
              f"x{amp:.2f}"]
        waste = w.get("pad_waste_pct")
        if isinstance(waste, (int, float)):
            ev.append(f"padding waste {waste:.1f}% of padded lanes")
        worst = sorted((w.get("kernels") or {}).items(),
                       key=lambda kv: -(kv[1].get("calls") or 0))[:3]
        if worst:
            ev.append("top kernels: " + ", ".join(
                f"{fam} x{k.get('calls')} ({k.get('wall_s')}s)"
                for fam, k in worst))
        ev.append("run `perf dispatch` for the megabatch-opportunity "
                  "report")
        _cause(causes, "dispatch_amplification", None,
               float(w.get("wall_s") or amp), ev)

    # tenant-isolation join (sync/tenantledger.py): one tenant owning
    # most of the ingress/dispatch shares while OTHER tenants' converge
    # p99 degrades is the noisy-neighbor regime — the evidence names the
    # perpetrator AND the victims, which is what makes it actionable
    for sec in ((snapshot.get("tenantledger") or {}).get("nodes")
                or {}).values():
        tenants = (sec or {}).get("tenants") or {}
        if len(tenants) < 2:
            continue
        ranked = sorted(tenants.items(),
                        key=lambda kv: -(kv[1].get("ingress_share_pct")
                                         or 0.0))
        hot_id, hot = ranked[0]
        share = hot.get("ingress_share_pct") or 0.0
        # "dominates" = more than twice the even split of this tenant
        # population (and at least half the fleet's ingress)
        if share < max(50.0, 200.0 / len(tenants)):
            continue
        victims = [(tid, (t.get("lag") or {}).get("p99_s"))
                   for tid, t in ranked[1:]
                   if isinstance((t.get("lag") or {}).get("p99_s"),
                                 (int, float))
                   and (t.get("lag") or {}).get("p99_s") > 0.05]
        if not victims:
            continue
        ev = [f"tenant {hot_id!r} holds {share:.1f}% of fleet ingress "
              f"({hot.get('admitted')} change(s)), dispatch share "
              f"{hot.get('dispatch_share')}"]
        ev.extend(f"tenant {tid!r} converge p99 {p99:.3f}s under the "
                  "hot neighbor" for tid, p99 in victims[:3])
        inj = snapshot.get("obs_chaos_injected{fault=tenant_storm}", 0)
        if inj:
            ev.append(f"{int(inj)} injected tenant_storm fault(s) "
                      "disclosed — chaos run, not an organic hot tenant")
        ev.append("run `perf tenant` for the full attribution report")
        _cause(causes, "tenant_hot", None,
               share / 100.0 + sum(p99 for _, p99 in victims), ev)

    # trace-plane join (utils/tracer.py): a lifecycle stage dominating
    # the sampled end-to-end critical path names WHERE the latency goes
    # — actionable because each hot stage has a distinct owner. The
    # visibility stage is excluded from the denominator: it measures
    # the consumer's hash-read cadence (and first-read JIT), not a
    # pipeline cost the fleet can tune.
    _TRACE_HOT = {
        "coalesce_wait": (
            "coalesce_wait_hot",
            "sealed changes are parked waiting for their flush round "
            "— the flush governor / round cadence owns this"),
        "wire_serialize": (
            "wire_serialize_hot",
            "columnar frame encode dominates the path — the frame "
            "encoder / batch sizing owns this"),
        "remote_admission": (
            "remote_admission_hot",
            "the receiver's apply lock dominates the path — remote "
            "admission is the bottleneck, not the sender"),
    }
    for sec in ((snapshot.get("traceplane") or {}).get("nodes")
                or {}).values():
        stages = (sec or {}).get("stages") or {}
        done = (sec or {}).get("completed") or 0
        if done < 4 or not stages:
            continue
        total = sum(float(d.get("sum_s") or 0.0)
                    for st, d in stages.items() if st != "visibility")
        if total <= 0:
            continue
        for st, (cause_name, hint) in _TRACE_HOT.items():
            d = stages.get(st)
            if not d:
                continue
            sum_s = float(d.get("sum_s") or 0.0)
            share = 100.0 * sum_s / total
            if share < 30.0:
                continue
            _cause(causes, cause_name, None, sum_s, [
                f"stage {st} holds {share:.1f}% of the sampled "
                f"critical path over {int(done)} completed trace(s) "
                f"(p99 {d.get('p99_s')}s, sum {sum_s:.4f}s)",
                hint,
                "run `perf trace` for the stage table + the slowest "
                "stitched waterfalls"])

    retraced = sum(v for k, v in snapshot.items()
                   if isinstance(v, (int, float))
                   and k.startswith("engine_kernels_retraced"))
    dispatched = sum(v for k, v in snapshot.items()
                     if isinstance(v, (int, float))
                     and k.startswith("engine_kernels_dispatched"))
    if retraced > 3 and dispatched and retraced / dispatched > 0.2:
        _cause(causes, "retrace_storm", None, float(retraced), [
            f"{int(retraced)} retraces across {int(dispatched)} "
            "dispatches — a compile per call is the classic silent "
            "perf cliff"])

    return {"mode": "post-mortem", "label": label,
            "causes": _ranked(causes)}


def diagnose_detail(detail: dict, config: str | None = None) -> list[dict]:
    """One report per bench config carrying a metrics snapshot in a
    BENCH_DETAIL.json, with the config's own GC attribution
    (`round_max_cause`) joined in as the gc_pressure evidence."""
    out = []
    configs = detail.get("configs") or {}
    for cfg in sorted(configs, key=lambda c: (len(c), c)):
        if config is not None and cfg != str(config):
            continue
        rec = configs[cfg] or {}
        snap = rec.get("metrics")
        if not isinstance(snap, dict):
            continue
        extra: list = []
        cause_note = rec.get("round_max_cause")
        if isinstance(cause_note, str) and "GC" in cause_note:
            _cause(extra, "gc_pressure", None,
                   float(rec.get("round_max_s") or 1.0),
                   [f"config {cfg}: {cause_note} "
                    f"(max round {rec.get('round_max_s')}s vs median "
                    f"{rec.get('round_s')}s)"])
        out.append(diagnose_snapshot(snap, label=f"config {cfg}",
                                     extra_causes=extra))
    return out


def diagnose_dump(dump: dict) -> dict:
    """Report from a flight-recorder post-mortem dump: the snapshot
    heuristics PLUS the event-timeline join — each embedded watchdog
    fire correlated with the lock holders it captured, and the oplag
    stage spikes / retraced dispatches around it."""
    snap = dump.get("metrics") or {}
    report = diagnose_snapshot(snap, label=dump.get("reason", "dump"))
    timeline: list[dict] = []

    for ev in dump.get("watchdog_events") or []:
        holders = ev.get("lock_holders") or {}
        hdesc = "; ".join(
            f"{lock} held {h.get('held_s', 0):.2f}s by "
            f"{h.get('thread')} ({h.get('site')})"
            for lock, h in sorted(holders.items())) or "no holders"
        timeline.append({
            "t": ev.get("at"), "kind": "watchdog_fire",
            "detail": (f"watchdog {ev.get('name')!r} fired after "
                       f"{ev.get('elapsed_s')}s (budget "
                       f"{ev.get('budget_s')}s); holders: {hdesc}")})
        _cause(report["causes"], "watchdog_stall", None,
               100.0 + float(ev.get("elapsed_s") or 0.0), [
                   f"watchdog {ev.get('name')!r} overran; {hdesc}"])
        if holders:
            # the join the hand-written post-mortems always did by hand:
            # the stalled region's lock was held by THAT thread
            worst = max(holders.items(),
                        key=lambda kv: kv[1].get("held_s", 0.0))
            _cause(report["causes"], "lock_contention", None,
                   float(worst[1].get("held_s") or 0.0), [
                       f"{worst[0]} held {worst[1].get('held_s')}s by "
                       f"{worst[1].get('thread')} at "
                       f"{worst[1].get('site')} while "
                       f"{ev.get('name')!r} stalled"])

    events = [e for tail in (dump.get("threads") or {}).values()
              for e in tail]
    for e in sorted(events, key=lambda e: e.get("t", 0.0)):
        kind = e.get("kind")
        if kind == "oplag_stage" and (e.get("s") or 0.0) >= 0.1:
            timeline.append({
                "t": e.get("t"), "kind": "oplag_spike",
                "detail": (f"op {e.get('id')} stage {e.get('stage')} "
                           f"took {e.get('s')}s "
                           f"[{e.get('thread')}]")})
        elif kind == "dispatch" and e.get("retraced"):
            timeline.append({
                "t": e.get("t"), "kind": "retrace",
                "detail": (f"kernel {e.get('kernel')} retraced "
                           f"[{e.get('thread')}]")})
        elif kind in ("chaos_inject", "straggler_flagged",
                      "slo_verdict", "watchdog_fire"):
            timeline.append({
                "t": e.get("t"), "kind": kind,
                "detail": json.dumps({k: v for k, v in e.items()
                                      if k not in ("seq", "t", "kind")},
                                     sort_keys=True, default=str)})
    timeline.sort(key=lambda r: r.get("t") or 0.0)
    report["causes"] = _ranked(report["causes"])
    report["timeline"] = timeline
    return report


# ---------------------------------------------------------------------------
# rendering + CLI


def report_lines(report: dict) -> list[str]:
    lines = [f"# perf doctor — {report.get('label', report['mode'])} "
             f"({report['mode']})"]
    if report.get("stragglers"):
        lines.append("  stragglers flagged: "
                     + ", ".join(report["stragglers"]))
    causes = report.get("causes") or []
    if not causes:
        lines.append("  no root-cause signals above threshold "
                     "(healthy, or not instrumented)")
    for i, c in enumerate(causes, 1):
        where = f" @ {c['node']}" if c.get("node") else ""
        lines.append(f"  {i}. {c['cause']}{where} "
                     f"(score {c['score']})")
        for ev in c.get("evidence") or []:
            lines.append(f"       - {ev}")
    for row in (report.get("timeline") or [])[:24]:
        t = row.get("t")
        ts = time.strftime("%H:%M:%S", time.localtime(t)) if t else "?"
        lines.append(f"  [{ts}] {row['kind']}: {row['detail']}")
    return lines


def _load_post_mortem(path: str):
    with open(path) as f:
        data = json.load(f)
    if not isinstance(data, dict):
        raise ValueError(f"{path}: not a JSON object")
    if "configs" in data and "reason" not in data:
        return "detail", data
    if "reason" in data or "threads" in data or "watchdog_events" in data:
        return "dump", data
    return "snapshot", data


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="automerge_tpu_torch.perf doctor")
    ap.add_argument("--post-mortem", default=None, metavar="PATH",
                    help="a bench detail, a flight-recorder dump, or "
                         "a raw metrics snapshot (auto-detected; "
                         "default: the port's bench detail)")
    ap.add_argument("--config", default=None,
                    help="restrict a bench-detail report to one config")
    ap.add_argument("--connect", default=None,
                    help="live mode: comma-separated host:port fleet "
                         "nodes to scrape (the local process is NOT "
                         "included)")
    ap.add_argument("--ticks", type=int, default=4,
                    help="live mode: scrape ticks before diagnosing")
    ap.add_argument("--interval", type=float, default=0.5)
    ap.add_argument("--json", action="store_true",
                    help="emit the raw report object(s) as JSON")
    args = ap.parse_args(argv)

    if args.connect:
        from .fleet import FleetCollector, connect_sources
        conns, close = connect_sources(
            [a for a in args.connect.split(",") if a])
        try:
            collector = FleetCollector(interval_s=args.interval)
            for name, conn in conns:
                collector.add_peer(conn, name=name)
            for _ in range(max(2, args.ticks)):
                time.sleep(args.interval)
                collector.scrape_once()
            report = diagnose_live(collector)
        finally:
            close()
        print(json.dumps(report, indent=1, default=str) if args.json
              else "\n".join(report_lines(report)))
        return 0

    path = args.post_mortem or history.detail_path()
    if not os.path.exists(path):
        print(f"perf doctor: nothing to diagnose ({path} missing; run "
              "bench.py, or pass --post-mortem/--connect)")
        return 0
    try:
        kind, data = _load_post_mortem(path)
    except (OSError, ValueError) as e:
        print(f"perf doctor: cannot read {path}: {e}", file=sys.stderr)
        return 2
    if kind == "detail":
        reports = diagnose_detail(data, config=args.config)
        if not reports:
            print("perf doctor: no per-config metrics snapshots in "
                  f"{path} (pre-observability capture?)")
            return 0
    elif kind == "dump":
        reports = [diagnose_dump(data)]
    else:
        reports = [diagnose_snapshot(data, label=os.path.basename(path))]
    if args.json:
        print(json.dumps(reports, indent=1, default=str))
    else:
        for r in reports:
            print("\n".join(report_lines(r)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
