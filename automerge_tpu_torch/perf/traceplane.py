"""`perf trace`: where a change's end-to-end latency actually goes.

The rendering end of the trace plane (utils/tracer.py). Every mode
reads the same `"traceplane"` snapshot section the fleet wire already
ships, so live fleets, post-mortem bench captures, and this process all
get the identical report:

- **totals** — sampling rate, sampled/received/completed/stitched trace
  counts with the disclosed loss counters (expired, dropped) and the
  ring occupancy, plus ledger self-time;
- **per-stage table** — count, p50, p99 and total seconds for every
  lifecycle stage observed in the completed ring, in critical-path
  order (finalize .. visibility);
- **critical path** — the end-to-end distribution over completed
  traces (the config-19 p99 the SLO plane watches);
- **waterfalls** — the slowest completed exemplars rendered as aligned
  span bars, each row a stage with its offset from the origin's
  finalize epoch, including the dispatch ledger's round join
  (amplification / pad-waste) when that plane is on.

Modes (mirroring `perf tenant` / `perf dispatch`):

    python -m automerge_tpu_torch.perf trace                  # port's bench detail
    python -m automerge_tpu_torch.perf trace --post-mortem P  # detail/dump/snapshot
    python -m automerge_tpu_torch.perf trace --connect h:p    # scrape a live fleet
    python -m automerge_tpu_torch.perf trace --smoke          # stitched self-check
    ... [--json] [--limit N] [--config C]

`--smoke` stands up a real two-service fleet (two rows EngineDocSets
over a TcpSyncServer/TcpSyncClient loopback link), forces 1-in-1
sampling, streams writes through node A until node B converges, and
asserts at least one COMPLETED STITCHED trace whose spans cover both
processes (wire + remote stages present) with a ledger duty cycle under
the 2% budget — the cheap CI proof (scripts/verify.sh stage 2) that the
whole sample->stitch->complete path is wired, without running bench
config 19.
"""

from __future__ import annotations

import json
import os
import sys
import time

from . import history


def sections_from_snapshot(snapshot: dict) -> dict:
    """label -> trace-plane section, from one node's metrics snapshot
    (empty when the node ships no `"traceplane"` section)."""
    out = {}
    for label, sec in ((snapshot.get("traceplane") or {})
                       .get("nodes") or {}).items():
        if isinstance(sec, dict):
            out[label] = sec
    return out


def merge_sections(parts: list[dict]) -> dict:
    """Join per-node section maps; a label collision (two scraped nodes
    both calling themselves "local") is disambiguated by suffix, never
    silently overwritten."""
    out: dict = {}
    for part in parts:
        for label, sec in part.items():
            key, n = label, 2
            while key in out:
                key, n = f"{label}#{n}", n + 1
            out[key] = sec
    return out


def _fmt(v, unit="", nd=4):
    if not isinstance(v, (int, float)):
        return "-"
    return f"{v:.{nd}f}{unit}"


BAR_W = 30


def waterfall_lines(trace: dict, indent: str = "    ") -> list[str]:
    """One completed trace as aligned span bars: each row a stage, the
    bar's offset/width proportional to the span's place on the end-to-
    end critical path."""
    spans = trace.get("spans") or []
    crit = max((float(trace.get("crit_s") or 0.0), 1e-9))
    meta = trace.get("meta") or {}
    join = ""
    if "round" in meta:
        bits = [f"round {meta['round']}"]
        if meta.get("amp") is not None:
            bits.append(f"amp {meta['amp']}")
        if meta.get("pad_waste_pct") is not None:
            bits.append(f"pad waste {meta['pad_waste_pct']}%")
        join = f"  ({', '.join(bits)})"
    lines = [
        f"  {trace.get('tid', '?'):<12} {trace.get('role', '?'):<9}"
        f" doc {trace.get('doc') or '?'}  crit {_fmt(crit, 's')}"
        f"  origin {trace.get('origin', '?')}{join}"]
    for st, rel, dur in spans:
        start = int(max(0.0, float(rel)) / crit * BAR_W)
        width = max(1, int(float(dur) / crit * BAR_W))
        start = min(start, BAR_W - 1)
        width = min(width, BAR_W - start)
        bar = " " * start + "#" * width
        lines.append(
            f"{indent}{st:<17}|{bar:<{BAR_W}}| "
            f"+{_fmt(float(rel), 's', 6)} {_fmt(float(dur), 's', 6)}")
    return lines


def report_lines(label: str, sec: dict, limit: int = 2) -> list[str]:
    """One node's trace-plane section as the plain-text report (the
    testable surface; `main` only gathers and prints)."""
    lines = [f"# perf trace — {label}"]
    rate = sec.get("sample_rate")
    lines.append(
        f"  sampling: {'1/' + str(rate) if rate else 'OFF'}"
        f" — {sec.get('sampled', 0)} sampled,"
        f" {sec.get('received', 0)} received,"
        f" {sec.get('handed_off', 0)} shipped,"
        f" {sec.get('completed', 0)} completed"
        f" ({sec.get('stitched', 0)} stitched),"
        f" {sec.get('inflight', 0)} in flight")
    expired = sec.get("expired") or 0
    dropped = sec.get("dropped") or 0
    if expired or dropped:
        lines.append(f"  losses: {expired} expired (TTL), "
                     f"{dropped} dropped (bounded tables) — "
                     "counted, never silent")
    lines.append(
        f"  ring {sec.get('ring', 0)}/{sec.get('ring_cap', 0)}"
        + (" [older completions truncated]" if sec.get("truncated")
           else "")
        + f", ledger self {_fmt(sec.get('self_s'), 's')}")
    stages = sec.get("stages") or {}
    if stages:
        lines.append(f"  {'stage':<17} {'count':>6} {'p50_s':>10} "
                     f"{'p99_s':>10} {'sum_s':>10}")
        for st, d in stages.items():
            lines.append(
                f"  {st:<17} {d.get('count', 0):>6} "
                f"{_fmt(d.get('p50_s'), nd=6):>10} "
                f"{_fmt(d.get('p99_s'), nd=6):>10} "
                f"{_fmt(d.get('sum_s'), nd=4):>10}")
        crit = sec.get("critical_path") or {}
        lines.append(
            f"  critical path: n={crit.get('count', 0)} "
            f"p50 {_fmt(crit.get('p50_s'), 's')} "
            f"p99 {_fmt(crit.get('p99_s'), 's')} "
            f"max {_fmt(crit.get('max_s'), 's')}")
        exemplars = (sec.get("exemplars") or [])[:limit]
        if exemplars:
            lines.append("  slowest exemplars:")
            for t in exemplars:
                lines.extend(waterfall_lines(t))
    elif sec.get("completed"):
        lines.append("  (completed traces aged out of the ring)")
    else:
        lines.append("  (no completed traces"
                     + ("" if rate else
                        " — plane off; set AMTPU_TRACE_SAMPLE") + ")")
    return lines


def gather_local() -> dict:
    """This process's plane, in the same label->section shape."""
    from ..utils import tracer
    sec = tracer.section()
    return {sec["label"]: sec} if sec else {}


def _report_all(sections: dict, args) -> int:
    if not sections:
        print("perf trace: no trace-plane data "
              "(AMTPU_TRACE_SAMPLE unset, or no sampled traffic yet)")
        return 0
    if args.json:
        print(json.dumps(sections, indent=1, default=str))
        return 0
    for label in sorted(sections):
        print("\n".join(report_lines(label, sections[label],
                                     limit=args.limit)))
    return 0


# ---------------------------------------------------------------------------
# smoke: a real two-service TCP fleet, one stitched waterfall asserted


def smoke_run(n_docs: int = 2, writes: int = 3,
              verbose: bool = True, device="cuda") -> int:
    """Stand up two rows EngineDocSets linked by a real loopback
    TcpSyncServer/TcpSyncClient, force 1-in-1 sampling, stream writes
    through node A until node B's converged-hash read sees them, and
    assert the plane end to end: every write sampled, traces shipped
    inside the change-frame envelope, at least one COMPLETED STITCHED
    trace whose spans cover both processes (wire + remote_admission +
    visibility present), and a ledger duty cycle under the 2% budget
    (perf/history.py TRACE_LEDGER_BUDGET_PCT). Both services run on
    `device`.

    The smoke reads no hash before the send path has handed a trace off
    (a read on A completes A's awaiting traces at their origin), and it
    keeps reading until the stitched trace completes: B adopts the trace
    just after it applies the frame, so a read that already sees B
    converged can come before the trace is parked for visibility."""
    import numpy as np

    from ..core.change import Change, Op
    from ..core.ids import ROOT_ID
    from ..device import resolve_device
    from ..native.wire import changes_to_columns
    from ..sync.service import EngineDocSet
    from ..sync.tcp import TcpSyncClient, TcpSyncServer
    from ..utils import tracer

    device = resolve_device(device)
    tracer.reset()
    tracer.set_sample_rate(1)
    a = EngineDocSet(backend="rows", device=device)
    b = EngineDocSet(backend="rows", device=device)
    server = TcpSyncServer(a).start()
    client = TcpSyncClient(b, server.host, server.port).start()
    docs = [f"smoke{i}" for i in range(n_docs)]
    try:
        t0 = time.perf_counter()
        for s in range(1, writes + 1):
            for d in docs:
                a.apply_columns(d, changes_to_columns([Change(
                    actor="SMK", seq=s, deps={},
                    ops=[Op("set", ROOT_ID, key="k", value=s)])]))

        deadline = time.perf_counter() + 30.0
        while (tracer.section()["handed_off"] < 1
               and time.perf_counter() < deadline):
            time.sleep(0.005)      # section() reads; it completes nothing
        converged = False
        while time.perf_counter() < deadline:
            ha, hb = a.hashes(), b.hashes()   # hash reads drive visible()
            if (set(ha) == set(hb) == set(docs)
                    and all(np.uint32(ha[d]) == np.uint32(hb[d])
                            for d in ha)
                    and tracer.section()["stitched"] >= 1):
                converged = True
                break
            time.sleep(0.02)
        traffic_wall = time.perf_counter() - t0
        assert converged, (
            f"fleet did not converge: {a.hashes()} vs {b.hashes()}")

        sec = tracer.section()
        total = writes * n_docs
        assert sec["sampled"] >= total, (
            f"expected >= {total} sampled finalizes, "
            f"got {sec['sampled']}")
        assert sec["handed_off"] >= 1, "no trace shipped on the wire"
        assert sec["received"] >= 1, "no trace adopted by the receiver"
        assert sec["stitched"] >= 1, (
            f"no stitched trace completed (completed={sec['completed']},"
            f" inflight={sec['inflight']}, expired={sec['expired']})")
        stitched = [t for t in sec["exemplars"] if t.get("stitched")]
        assert stitched, "no stitched exemplar in the section"
        got = {s[0] for s in stitched[0]["spans"]}
        for need in ("wire", "remote_admission", "visibility"):
            assert need in got, (
                f"stitched exemplar missing the {need} span (has "
                f"{sorted(got)}) — the cross-process path is not "
                "covered")
        duty_pct = 100.0 * sec["self_s"] / max(traffic_wall, 1e-9)
        budget = history.TRACE_LEDGER_BUDGET_PCT
        assert duty_pct < budget, (
            f"trace-plane duty cycle {duty_pct:.3f}% breaches the "
            f"{budget}% budget")
        if verbose:
            print(f"perf trace --smoke OK: {total} sampled write(s) "
                  f"over 2 TCP services, {sec['completed']} completed "
                  f"({sec['stitched']} stitched), duty cycle "
                  f"{duty_pct:.3f}% (< "
                  f"{history.TRACE_LEDGER_BUDGET_PCT}%)")
            print("\n".join(report_lines(sec.get("label", "local"),
                                         sec, limit=1)))
        return 0
    finally:
        client.close()
        server.close()
        a.close()
        b.close()
        tracer.reset()
        tracer._reload_for_tests()   # hand the rate back to the env


# ---------------------------------------------------------------------------
# CLI


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="automerge_tpu_torch.perf trace")
    ap.add_argument("--post-mortem", default=None, metavar="PATH",
                    help="a bench detail, a flight-recorder dump, or "
                         "a raw metrics snapshot (auto-detected; "
                         "default: the port's bench detail)")
    ap.add_argument("--config", default=None,
                    help="restrict a bench-detail report to one config")
    ap.add_argument("--connect", default=None,
                    help="live mode: comma-separated host:port fleet "
                         "nodes to scrape")
    ap.add_argument("--local", action="store_true",
                    help="report this process's own plane")
    ap.add_argument("--ticks", type=int, default=2,
                    help="live mode: scrape ticks before reporting")
    ap.add_argument("--interval", type=float, default=0.5)
    ap.add_argument("--limit", type=int, default=2,
                    help="exemplar waterfalls per node")
    ap.add_argument("--json", action="store_true",
                    help="emit raw sections as JSON")
    ap.add_argument("--smoke", action="store_true",
                    help="two-service TCP fleet, one stitched "
                         "waterfall asserted (CI self-check)")
    ap.add_argument("--device", default="cuda",
                    help="the smoke's device (cuda, or cpu)")
    args = ap.parse_args(argv)

    if args.smoke:
        return smoke_run(device=args.device)

    if args.local:
        return _report_all(gather_local(), args)

    if args.connect:
        from .fleet import FleetCollector, connect_sources
        conns, close = connect_sources(
            [a for a in args.connect.split(",") if a])
        try:
            collector = FleetCollector(interval_s=args.interval)
            for name, conn in conns:
                collector.add_peer(conn, name=name)
            for _ in range(max(1, args.ticks)):
                time.sleep(args.interval)
                collector.scrape_once()
            parts = [sections_from_snapshot(st.last_snapshot)
                     for st in collector.nodes.values()
                     if isinstance(st.last_snapshot, dict)]
        finally:
            close()
        return _report_all(merge_sections(parts), args)

    path = args.post_mortem or history.detail_path()
    if not os.path.exists(path):
        print(f"perf trace: nothing to report ({path} missing; run "
              "bench.py, or pass --post-mortem/--connect/--local)")
        return 0
    from .doctor import _load_post_mortem
    try:
        kind, data = _load_post_mortem(path)
    except (OSError, ValueError) as e:
        print(f"perf trace: cannot read {path}: {e}", file=sys.stderr)
        return 2
    if kind == "detail":
        sections = {}
        for cfg in sorted(data.get("configs") or {},
                          key=lambda c: (len(c), c)):
            if args.config is not None and cfg != str(args.config):
                continue
            snap = (data["configs"][cfg] or {}).get("metrics")
            if isinstance(snap, dict):
                for label, sec in sections_from_snapshot(snap).items():
                    sections[f"config {cfg} @ {label}"] = sec
    elif kind == "dump":
        snap = data.get("metrics") if isinstance(data.get("metrics"),
                                                 dict) else data
        sections = sections_from_snapshot(snap)
        # a flight-recorder dump also carries what was MID-LIFECYCLE at
        # fault time (utils/flightrec.py dump(): "inflight_traces")
        inflight = data.get("inflight_traces") or []
        if inflight and not args.json:
            print("# in-flight traces at fault time "
                  f"({len(inflight)} shown)")
            for t in inflight:
                print("\n".join(waterfall_lines(t)))
    else:
        sections = sections_from_snapshot(data)
    return _report_all(sections, args)


if __name__ == "__main__":
    raise SystemExit(main())
