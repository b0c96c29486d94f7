"""`perf top`: a live terminal dashboard over the fleet collector.

One screen, three bands (docs/OBSERVABILITY.md "Fleet health"):

- the **SLO verdict strip** — one cell per objective, `OK`/`BREACH`/`--`
  (no data), with the current value against its bound;
- the **fleet table** — per node: role, ops/s, converge-stage p99,
  round-flush mean, service-lock wait rate, dropped frames/s, the
  straggler score (flagged nodes are marked `<< STRAGGLER`), and the
  scrape age (stale nodes are the collector's dead-peer signal);
- **per-stage sparklines** — the ring history of the headline signals
  (converge p99, round-flush mean, ops/s) for the busiest node, so a
  spike's shape is visible without leaving the terminal;
- the **per-doc hot list** — the worst-lagging docs across every
  scraped node's convergence ledger (the `"docledger"` snapshot
  section, sync/docledger.py), with the `perf explain <doc>` handle for
  the causal walk;
- the **dispatch-waste band** — per scraped node shipping a
  `"dispatchledger"` section (engine/dispatchledger.py): window
  amplification (dispatches per dirty doc), padding-waste %, and the
  biggest padded bucket, with the `perf dispatch` handle for the full
  megabatch-opportunity report;
- the **tenant band** — per (node, tenant) from the `"tenantledger"`
  section (sync/tenantledger.py): ingress share, attributed dispatch
  share, converge-lag p99, and shed counts, hottest share first, with
  the `perf tenant` handle for the full attribution report;
- the **trace-stage band** — per (node, lifecycle stage) from the
  `"traceplane"` section (utils/tracer.py): each stage's share of the
  sampled end-to-end critical path (visibility excluded — read-cadence
  bound) and its p99, biggest share first, with the `perf trace`
  handle for the stage table and stitched waterfalls.

Keys (tty only): `q` quit · `p` pause/resume scraping ·
`d` dump a `perf doctor` live report to a file and show the path.
Non-tty (pipes, CI) renders plain frames with no escape codes; `--once`
prints a single frame and exits (the testable path).

Usage:
    python -m automerge_tpu_torch.perf top --connect host:port[,host:port...]
    python -m automerge_tpu_torch.perf top --local          # this process only
"""

from __future__ import annotations

import json
import os
import sys
import time

SPARK_CHARS = "▁▂▃▄▅▆▇█"


def spark(values: list[float], width: int = 24) -> str:
    """Unicode sparkline of the last `width` values (empty-safe)."""
    vals = [v for v in values if isinstance(v, (int, float))][-width:]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(
        SPARK_CHARS[min(len(SPARK_CHARS) - 1,
                        int((v - lo) / span * (len(SPARK_CHARS) - 1)))]
        for v in vals)


def _fmt(v, unit="", nd=3):
    if not isinstance(v, (int, float)):
        return "-"
    return f"{v:.{nd}f}{unit}"


def render(collector, slo_engine=None, width: int = 100) -> list[str]:
    """One dashboard frame as plain lines (the tty loop adds the ANSI
    clear; tests assert on these lines directly)."""
    state = collector.fleet_state()
    rollup = state["rollup"]
    scrape = state["scrape"]
    lines = [
        f"amtpu fleet — {rollup['nodes']} node(s), "
        f"{rollup['nodes_fresh']} fresh, "
        f"{len(state['stragglers'])} straggler(s) | "
        f"fleet ops/s {_fmt(rollup['ops_per_s'], nd=0)} | "
        f"scrape p50 {_fmt(scrape['p50_s'], 's', 4)} "
        f"({scrape['ticks']} ticks)"]
    if slo_engine is not None:
        cells = []
        for row in slo_engine.summary():
            ok = row["ok"]
            mark = "--" if ok is None else ("OK" if ok else "BREACH")
            val = _fmt(row["value"], nd=3)
            cells.append(f"[{mark}] {row['name']} {val}/"
                         f"{_fmt(row['bound'], nd=2)}")
        lines.append("SLO: " + "  ".join(cells))
    lines.append(f"{'node':<12} {'role':<6} {'ops/s':>8} "
                 f"{'conv p99':>9} {'flush':>9} {'lockw/s':>8} "
                 f"{'drops/s':>8} {'score':>6} {'age':>6}")
    for name in sorted(state["nodes"]):
        rec = state["nodes"][name]
        d = rec.get("derived") or {}
        flag = "  << STRAGGLER" if rec["flagged"] else (
            "  (stale)" if rec["stale"] else "")
        lines.append(
            f"{name:<12} {rec['role']:<6} "
            f"{_fmt(d.get('ops_per_s'), nd=0):>8} "
            f"{_fmt(d.get('converge_p99_s'), 's'):>9} "
            f"{_fmt(d.get('round_flush_mean_s'), 's'):>9} "
            f"{_fmt(d.get('lock_wait_rate')):>8} "
            f"{_fmt(d.get('drop_rate'), nd=1):>8} "
            f"{rec['straggler_score']:>6} "
            f"{_fmt(rec.get('age_s'), 's', 1):>6}{flag}")
    # sparklines for the busiest (or flagged) node
    focus = (state["stragglers"] or [None])[0]
    if focus is None and state["nodes"]:
        focus = max(state["nodes"],
                    key=lambda n: ((state["nodes"][n].get("derived") or {})
                                   .get("ops_per_s") or 0))
    if focus is not None and focus in collector.nodes:
        st = collector.nodes[focus]
        for key, label in (("converge_p99_s", "conv p99"),
                           ("round_flush_mean_s", "flush"),
                           ("ops_per_s", "ops/s")):
            series = [v for _, v in st.series(key)]
            if series:
                lines.append(f"{focus} {label:<9} {spark(series)} "
                             f"{_fmt(series[-1], nd=4)}")
    lines.extend(hot_doc_lines(collector))
    lines.extend(dispatch_lines(collector))
    lines.extend(tenant_lines(collector))
    lines.extend(trace_lines(collector))
    return [line[:width] for line in lines]


def hot_doc_lines(collector, limit: int = 5) -> list[str]:
    """The per-doc hot-list band: worst converge lag across every
    scraped node's ledger section (each NodeState keeps the node's last
    full snapshot, so the panel costs no extra wire traffic). Empty when
    no node ships a ledger — the band simply disappears."""
    from .explain import hot_docs, merge_views, views_from_snapshot

    parts = []
    for st in collector.nodes.values():
        if isinstance(st.last_snapshot, dict):
            parts.append(views_from_snapshot(st.last_snapshot))
    views = merge_views(parts)
    rows = hot_docs(views, limit=limit)
    if not rows:
        return []
    lines = ["hot docs (converge lag; `perf explain <doc>`):"]
    for r in rows:
        lines.append(
            f"  {str(r['doc'])[:24]:<24} @ {str(r['node'])[:10]:<10} "
            f"{r['lag_changes']:>5} chg {_fmt(r['lag_s'], 's'):>9} "
            f"behind {r['behind_peer'] or '?'}"
            + (f"  [{r['buffered']} buffered]" if r["buffered"] else ""))
    # a truncated export must SAY so: docs beyond the per-node cap are
    # invisible here, not healthy (satellite of the export-cap fix)
    truncated = sum(max(0, int(v.get("truncated") or 0))
                    for v in views.values())
    if truncated:
        lines.append(f"  (+{truncated} tracked doc(s) beyond the export "
                     "cap — raise AMTPU_DOCLEDGER_K or pass --k to "
                     "perf explain)")
    return lines


def dispatch_lines(collector, limit: int = 5) -> list[str]:
    """The dispatch-waste band: per ledger-shipping node, the window
    amplification / padding-waste rollup and its biggest padded bucket
    (engine/dispatchledger.py), worst amplification first. Empty when no
    scraped node ships a `"dispatchledger"` section — the band simply
    disappears (same contract as the hot-doc panel)."""
    rows = []
    for st in collector.nodes.values():
        snap = st.last_snapshot
        if not isinstance(snap, dict):
            continue
        for label, sec in ((snap.get("dispatchledger") or {})
                           .get("nodes") or {}).items():
            w = (sec or {}).get("window") or {}
            if not w.get("dispatches") and not w.get("ambient"):
                continue
            buckets = sorted((w.get("buckets") or {}).items(),
                             key=lambda kv: -(kv[1].get("padded") or 0))
            rows.append({
                "node": label,
                "amp": w.get("amplification"),
                "waste": w.get("pad_waste_pct"),
                "dispatches": ((w.get("dispatches") or 0)
                               + (w.get("ambient") or 0)),
                "rounds": w.get("rounds"),
                "bucket": buckets[0][0] if buckets else None,
            })
    if not rows:
        return []
    rows.sort(key=lambda r: -(r["amp"]
                              if isinstance(r["amp"], (int, float))
                              else -1.0))
    lines = ["dispatch waste (amplification; `perf dispatch`):"]
    for r in rows[:limit]:
        lines.append(
            f"  {str(r['node'])[:12]:<12} "
            f"amp {_fmt(r['amp'], 'x', 2):>8} "
            f"waste {_fmt(r['waste'], '%', 1):>7} "
            f"{r['dispatches']:>5} disp/{r['rounds']} rnd"
            + (f"  worst {r['bucket']}" if r["bucket"] else ""))
    if len(rows) > limit:
        lines.append(f"  (+{len(rows) - limit} more ledger node(s) — "
                     "run `perf dispatch` for the full report)")
    return lines


def tenant_lines(collector, limit: int = 5) -> list[str]:
    """The tenant band: one row per (node, tenant) from the
    `"tenantledger"` snapshot section (sync/tenantledger.py), hottest
    ingress share first — the at-a-glance noisy-neighbor check. Empty
    when no scraped node ships the section — the band simply disappears
    (same contract as the hot-doc and dispatch panels)."""
    rows = []
    for st in collector.nodes.values():
        snap = st.last_snapshot
        if not isinstance(snap, dict):
            continue
        for label, sec in ((snap.get("tenantledger") or {})
                           .get("nodes") or {}).items():
            for tid, t in ((sec or {}).get("tenants") or {}).items():
                lag = t.get("lag") or {}
                rows.append({
                    "node": label,
                    "tenant": tid,
                    "share": t.get("ingress_share_pct"),
                    "disp": t.get("dispatch_share"),
                    "p99": lag.get("p99_s"),
                    "shed": ((t.get("shed_dropped") or 0)
                             + (t.get("shed_delayed") or 0)),
                })
    if not rows:
        return []
    rows.sort(key=lambda r: -(r["share"]
                              if isinstance(r["share"], (int, float))
                              else -1.0))
    lines = ["tenants (ingress share; `perf tenant`):"]
    for r in rows[:limit]:
        lines.append(
            f"  {str(r['tenant'])[:14]:<14} @ {str(r['node'])[:10]:<10} "
            f"share {_fmt(r['share'], '%', 1):>7} "
            f"disp {_fmt(r['disp'], nd=1):>8} "
            f"p99 {_fmt(r['p99'], 's', 4):>9}"
            + (f"  [{r['shed']} shed]" if r["shed"] else ""))
    if len(rows) > limit:
        lines.append(f"  (+{len(rows) - limit} more tenant row(s) — "
                     "run `perf tenant` for the full report)")
    return lines


def trace_lines(collector, limit: int = 4) -> list[str]:
    """The trace-stage band: one row per (node, stage) from the
    `"traceplane"` snapshot section (utils/tracer.py), biggest share of
    the sampled critical path first (visibility excluded — that stage
    is read-cadence bound by design), plus the node's end-to-end
    critical-path p99. Empty when no scraped node ships the section —
    the band simply disappears (same contract as the other panels)."""
    rows = []
    for st in collector.nodes.values():
        snap = st.last_snapshot
        if not isinstance(snap, dict):
            continue
        for label, sec in ((snap.get("traceplane") or {})
                           .get("nodes") or {}).items():
            stages = (sec or {}).get("stages") or {}
            crit = (sec or {}).get("critical_path") or {}
            total = sum(float(d.get("sum_s") or 0.0)
                        for s, d in stages.items() if s != "visibility")
            for s, d in stages.items():
                if s == "visibility" or not d.get("count"):
                    continue
                sum_s = float(d.get("sum_s") or 0.0)
                rows.append({
                    "node": label,
                    "stage": s,
                    "share": (100.0 * sum_s / total) if total else None,
                    "p99": d.get("p99_s"),
                    "done": (sec or {}).get("completed"),
                    "crit_p99": crit.get("p99_s"),
                })
    if not rows:
        return []
    rows.sort(key=lambda r: -(r["share"]
                              if isinstance(r["share"], (int, float))
                              else -1.0))
    lines = ["trace stages (critical-path share; `perf trace`):"]
    for r in rows[:limit]:
        lines.append(
            f"  {str(r['stage'])[:16]:<16} @ {str(r['node'])[:10]:<10} "
            f"share {_fmt(r['share'], '%', 1):>7} "
            f"p99 {_fmt(r['p99'], 's', 4):>10} "
            f"e2e p99 {_fmt(r['crit_p99'], 's', 4):>10} "
            f"({r['done'] or 0} done)")
    if len(rows) > limit:
        lines.append(f"  (+{len(rows) - limit} more stage row(s) — "
                     "run `perf trace` for the full report)")
    return lines


def _read_key(timeout: float) -> str | None:
    """One key from a tty stdin without blocking past `timeout`."""
    import select
    r, _, _ = select.select([sys.stdin], [], [], timeout)
    if r:
        return sys.stdin.read(1)
    return None


def _loop(collector, slo_engine, interval: float,
          duration: float | None) -> int:
    is_tty = sys.stdin.isatty() and sys.stdout.isatty()
    paused = False
    deadline = (time.time() + duration) if duration else None
    cm = None
    if is_tty:
        import termios
        import tty
        fd = sys.stdin.fileno()
        saved = termios.tcgetattr(fd)
        tty.setcbreak(fd)
        cm = (fd, saved)
    try:
        while True:
            if not paused:
                collector.scrape_once()
            frame = render(collector, slo_engine)
            if is_tty:
                sys.stdout.write("\x1b[2J\x1b[H" + "\n".join(frame)
                                 + "\n\n[q]uit  [p]ause  [d]octor"
                                 + ("  (paused)" if paused else "")
                                 + "\n")
                sys.stdout.flush()
                key = _read_key(interval)
                if key == "q":
                    return 0
                if key == "p":
                    paused = not paused
                elif key == "d":
                    from . import doctor
                    report = doctor.diagnose_live(collector)
                    path = os.path.join(
                        os.path.abspath(os.curdir),
                        f"amtpu-doctor-{int(time.time())}.json")
                    with open(path, "w") as f:
                        json.dump(report, f, indent=1, default=str)
                    sys.stdout.write(f"doctor report -> {path}\n")
                    sys.stdout.flush()
                    time.sleep(1.0)
            else:
                print("\n".join(frame) + "\n")
                time.sleep(interval)
            if deadline and time.time() >= deadline:
                return 0
    except KeyboardInterrupt:
        return 0
    finally:
        if cm is not None:
            import termios
            termios.tcsetattr(cm[0], termios.TCSADRAIN, cm[1])


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="automerge_tpu_torch.perf top")
    ap.add_argument("--connect", default=None,
                    help="comma-separated host:port fleet nodes to "
                         "scrape over {'metrics':'pull'}")
    ap.add_argument("--local", action="store_true",
                    help="also scrape this process directly")
    ap.add_argument("--interval", type=float, default=1.0)
    ap.add_argument("--once", action="store_true",
                    help="scrape twice, print one frame, exit")
    ap.add_argument("--duration", type=float, default=None,
                    help="exit after this many seconds")
    args = ap.parse_args(argv)
    if not args.connect and not args.local:
        args.local = True   # something must be scraped

    from .fleet import FleetCollector, connect_sources
    from .slo import SloEngine

    collector = FleetCollector(interval_s=args.interval)
    engine = SloEngine()
    collector.slo_engine = engine
    close = None
    if args.local:
        collector.add_local("local")
    if args.connect:
        conns, close = connect_sources(
            [a for a in args.connect.split(",") if a])
        for name, conn in conns:
            collector.add_peer(conn, name=name)
    try:
        if args.once:
            collector.scrape_once()
            time.sleep(min(args.interval, 0.2))
            collector.scrape_once()
            print("\n".join(render(collector, engine)))
            return 0
        return _loop(collector, engine, args.interval, args.duration)
    finally:
        if close is not None:
            close()


if __name__ == "__main__":
    raise SystemExit(main())
