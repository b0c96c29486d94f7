"""`perf dispatch`: rank dispatch-waste sources, project megabatch wins.

The rendering end of the dispatch-efficiency ledger
(engine/dispatchledger.py). Every mode reads the same `"dispatchledger"`
snapshot section the fleet wire already ships, so live fleets,
post-mortem bench captures, and this process all get the identical
report:

- **totals / window rollup** — rounds, dirty docs, dispatches (routed +
  ambient), amplification (dispatches per dirty doc), padding-waste %,
  per-round dispatch rate;
- **per-kernel table** — calls, host/device split from the cost-model
  verdicts, wall time, compile-cache hits vs retraces, per-kernel
  padding waste, ranked by wall time (the time the waste actually
  costs);
- **bucket histogram** — per padded shape (the compile-cache key), the
  calls/docs/waste it accounted for;
- the **megabatch-opportunity report** — per bucket shape, the
  projected dispatch count and padded-docs-lane occupancy IF the
  window's independent docs had shared lanes: current calls vs
  `ceil(logical_docs / mean docs-lane capacity)`. This is the concrete
  claim ROADMAP #2's megabatching must cash, stated from measured
  traffic rather than hope.

Modes (mirroring `perf doctor`):

    python -m automerge_tpu_torch.perf dispatch                  # port's bench detail
    python -m automerge_tpu_torch.perf dispatch --post-mortem P  # detail/dump/snapshot
    python -m automerge_tpu_torch.perf dispatch --connect h:p    # scrape a live fleet
    python -m automerge_tpu_torch.perf dispatch --smoke          # self-check round
    ... [--json] [--limit N] [--config C]

`--smoke` runs one real multi-doc coalesced flush round through an
EngineDocSet (rows backend) and asserts the ledger caught it: the round
records every dirty doc, at least one dispatch, positive amplification,
and a ledger duty cycle under the 2% budget — the cheap proof
(`chip_smoke.py` phase 16 runs it on the card) that the instrument is
wired, without running a bench.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

from . import history


def sections_from_snapshot(snapshot: dict) -> dict:
    """label -> ledger section, from one node's metrics snapshot (empty
    when the node ships no `"dispatchledger"` section)."""
    out = {}
    for label, sec in ((snapshot.get("dispatchledger") or {})
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


def megabatch_rows(window: dict) -> list[dict]:
    """The megabatch-opportunity projection, per bucket shape: if the
    window's independent docs had shared this bucket's docs lanes, how
    many dispatches would the same traffic have cost, and how full would
    the padded docs axis have run? `cap` is the mean docs-lane capacity
    of one dispatch of this shape (padded docs axis; the bucket carries
    the summed capacity so the mean survives folding)."""
    rows = []
    for shape, b in (window.get("buckets") or {}).items():
        calls = int(b.get("calls") or 0)
        docs = int(b.get("docs") or 0)
        cap_total = int(b.get("docs_cap") or 0)
        if not calls or not cap_total:
            continue
        cap = cap_total / calls
        projected = max(1, math.ceil(docs / cap)) if docs else calls
        padded = b.get("padded") or 0
        logical = b.get("logical") or 0
        rows.append({
            "bucket": shape,
            "calls": calls,
            "docs": docs,
            "docs_cap_mean": round(cap, 2),
            "occupancy_pct": round(100.0 * docs / cap_total, 2),
            "pad_waste_pct": (round(100.0 * (1 - logical / padded), 2)
                              if padded else None),
            "projected_calls": projected,
            "projected_occupancy_pct": round(
                100.0 * docs / (projected * cap), 2),
            "dispatches_saved": calls - projected,
            "wall_s": b.get("wall_s"),
        })
    # biggest win first: that is the order megabatching work should land
    rows.sort(key=lambda r: (-r["dispatches_saved"],
                             -(r["wall_s"] or 0.0)))
    return rows


def _fmt(v, unit="", nd=2):
    if not isinstance(v, (int, float)):
        return "-"
    return f"{v:.{nd}f}{unit}"


def report_lines(label: str, sec: dict, limit: int = 8) -> list[str]:
    """One node's ledger section as the plain-text report (the testable
    surface; `main` only gathers and prints)."""
    w = sec.get("window") or {}
    lines = [f"# perf dispatch — {label}"]
    lines.append(
        f"  totals: {sec.get('rounds_total', 0)} round(s), "
        f"{sec.get('dirty_docs_total', 0)} dirty doc(s), "
        f"{sec.get('dispatches_total', 0)} dispatch(es) "
        f"+{sec.get('ambient_total', 0)} ambient, "
        f"{sec.get('jits_total', 0)} jit(s) / "
        f"{sec.get('retraces_total', 0)} retrace(s)")
    lines.append(
        f"  window ({w.get('rounds', 0)} round(s)): "
        f"amplification {_fmt(w.get('amplification'), 'x')} | "
        f"pad waste {_fmt(w.get('pad_waste_pct'), '%', 1)} | "
        f"{_fmt(w.get('dispatches_per_round'), nd=1)} disp/round | "
        f"wall {_fmt(w.get('wall_s'), 's', 4)}")
    kernels = sorted((w.get("kernels") or {}).items(),
                     key=lambda kv: -(kv[1].get("wall_s") or 0.0))
    if kernels:
        lines.append(f"  {'kernel':<12} {'calls':>6} {'host':>5} "
                     f"{'dev':>5} {'wall_s':>9} {'jits':>5} "
                     f"{'retr':>5} {'waste':>7}")
        for fam, k in kernels[:limit]:
            padded = k.get("padded") or 0
            waste = (100.0 * (1 - (k.get("logical") or 0) / padded)
                     if padded else None)
            lines.append(
                f"  {fam:<12} {k.get('calls', 0):>6} "
                f"{k.get('host', 0):>5} {k.get('device', 0):>5} "
                f"{_fmt(k.get('wall_s'), nd=4):>9} "
                f"{k.get('jits', 0):>5} {k.get('retraces', 0):>5} "
                f"{_fmt(waste, '%', 1):>7}")
        if len(kernels) > limit:
            lines.append(f"  (+{len(kernels) - limit} more kernel "
                         "famil(ies) — raise --limit)")
    rows = megabatch_rows(w)
    if rows:
        lines.append("  megabatch opportunity (docs sharing lanes, per "
                     "bucket shape):")
        for r in rows[:limit]:
            lines.append(
                f"    {str(r['bucket'])[:28]:<28} "
                f"{r['calls']:>5} disp -> {r['projected_calls']:>4} "
                f"(cap ~{_fmt(r['docs_cap_mean'], nd=0)} docs/disp) | "
                f"occupancy {_fmt(r['occupancy_pct'], '%', 1)} -> "
                f"{_fmt(r['projected_occupancy_pct'], '%', 1)} | "
                f"waste {_fmt(r['pad_waste_pct'], '%', 1)}")
        if len(rows) > limit:
            lines.append(f"    (+{len(rows) - limit} more bucket "
                         "shape(s) — raise --limit)")
        saved = sum(r["dispatches_saved"] for r in rows)
        base = sum(r["calls"] for r in rows)
        if base:
            lines.append(
                f"    projected: {base} -> {base - saved} dispatch(es) "
                f"({_fmt(100.0 * saved / base, '%', 1)} fewer) over the "
                "window if independent docs shared lanes")
    mega = w.get("megabatch")
    if mega:
        lines.append(
            f"  megabatch achieved ({mega.get('rounds', 0)} fused "
            f"round(s)): {mega.get('docs', 0)} doc(s) over "
            f"{mega.get('dispatches', 0)} dispatch(es) = "
            f"{_fmt(mega.get('docs_per_dispatch'), nd=1)} docs/disp | "
            f"bucket fill {_fmt(mega.get('fill_pct'), '%', 1)} | "
            f"pad waste {_fmt(mega.get('pad_waste_pct'), '%', 1)}")
    elif sec.get("mega_rounds_total"):
        md, mt = sec.get("mega_docs_total", 0), \
            sec.get("mega_dispatches_total", 0)
        lines.append(
            f"  megabatch achieved (cumulative, outside the ring "
            f"window): {sec.get('mega_rounds_total')} fused round(s), "
            f"{md} doc(s) over {mt} dispatch(es)"
            + (f" = {_fmt(md / mt, nd=1)} docs/disp" if mt else ""))
    truncated = w.get("buckets_truncated") or 0
    if truncated:
        lines.append(f"  (+{truncated} bucket shape(s) beyond the "
                     "export cap not shown)")
    if not kernels and not rows:
        lines.append("  (no routed calls in the window — ambient "
                     "dispatches only)")
    return lines


def gather_local() -> dict:
    """This process's ledger, in the same label->section shape."""
    from ..engine import dispatchledger
    sec = dispatchledger.ledger().section()
    return {sec["label"]: sec} if sec else {}


def _report_all(sections: dict, args) -> int:
    if not sections:
        print("perf dispatch: no dispatch-ledger data "
              "(AMTPU_DISPATCHLEDGER=0, or no routed rounds yet)")
        return 0
    if args.json:
        print(json.dumps(
            {label: {"section": sec,
                     "megabatch": megabatch_rows(sec.get("window") or {})}
             for label, sec in sections.items()},
            indent=1, default=str))
        return 0
    for label in sorted(sections):
        print("\n".join(report_lines(label, sections[label],
                                     limit=args.limit)))
    return 0


# ---------------------------------------------------------------------------
# smoke: one real coalesced round, asserted end to end


def smoke_run(n_docs: int = 12, rounds: int = 4,
              verbose: bool = True, device="cuda") -> int:
    """Drive `rounds` coalesced multi-doc flush rounds through a rows
    EngineDocSet on `device` and assert the ledger account is live and
    cheap: every round recorded with its full dirty-doc count, at least
    one dispatch attributed, positive amplification, and ledger self-time
    under the 2% duty-cycle budget (perf/history.py
    DISPATCH_LEDGER_BUDGET_PCT, a bound on wall time)."""
    from ..core.change import Change, Op
    from ..core.ids import ROOT_ID
    from ..device import resolve_device
    from ..engine import dispatchledger
    from ..sync.service import EngineDocSet

    device = resolve_device(device)

    if not dispatchledger.enabled():
        print("perf dispatch --smoke: ledger disabled "
              "(AMTPU_DISPATCHLEDGER=0) — nothing to prove")
        return 0
    led = dispatchledger.ledger()
    base = led.section() or {}
    base_rounds = int(base.get("rounds_total") or 0)
    base_self = led.self_seconds()
    svc = EngineDocSet(backend="rows", device=device)
    # pin the eager (card-posture) dispatch path: CPU services normally
    # defer the reconcile to hash reads, which would leave every flush
    # round empty here — the smoke must prove IN-ROUND attribution
    svc._lazy_resolved = True
    svc._resident.lazy_dispatch = False
    try:
        t0 = time.perf_counter()
        for r in range(rounds):
            with svc.batch():
                for d in range(n_docs):
                    svc.apply_changes(f"doc{d:03d}", [Change(
                        actor="smoke", seq=r + 1, deps={},
                        ops=[Op("set", ROOT_ID, key=f"k{r}", value=r)])])
        svc.hashes()   # the read path: any deferred work lands ambient
        traffic_wall = time.perf_counter() - t0
    finally:
        svc.close()

    sec = led.section()
    assert sec, "smoke round left no ledger section"
    new_rounds = int(sec.get("rounds_total") or 0) - base_rounds
    assert new_rounds >= rounds, (
        f"expected >= {rounds} ledgered round(s), got {new_rounds}")
    ring = sec.get("ring") or []
    flush_rounds = [r for r in ring if r.get("dirty_docs") == n_docs]
    assert flush_rounds, (
        f"no ring round recorded all {n_docs} dirty docs: "
        f"{[r.get('dirty_docs') for r in ring]}")
    last = flush_rounds[-1]
    dispatches = ((last.get("dispatches") or 0)
                  + (last.get("ambient") or 0))
    assert dispatches >= 1, "coalesced round recorded zero dispatches"
    amp = (sec.get("window") or {}).get("amplification")
    assert isinstance(amp, (int, float)) and amp > 0, (
        f"window amplification not positive: {amp!r}")
    self_s = led.self_seconds() - base_self
    duty_pct = 100.0 * self_s / max(traffic_wall, 1e-9)
    budget = history.DISPATCH_LEDGER_BUDGET_PCT
    assert duty_pct < budget, (
        f"ledger duty cycle {duty_pct:.3f}% breaches the {budget}% budget")
    if verbose:
        print(f"perf dispatch --smoke OK: {rounds} round(s) x {n_docs} "
              f"docs, {dispatches} dispatch(es) in the coalesced round, "
              f"amplification {amp}x, pad waste "
              f"{(sec.get('window') or {}).get('pad_waste_pct')}%, "
              f"ledger duty cycle {duty_pct:.3f}% "
              f"(< {history.DISPATCH_LEDGER_BUDGET_PCT}%)")
        print("\n".join(report_lines(sec.get("label", "local"), sec,
                                     limit=4)))
    return 0


# ---------------------------------------------------------------------------
# CLI


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="automerge_tpu_torch.perf dispatch")
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
                    help="report this process's own ledger")
    ap.add_argument("--ticks", type=int, default=2,
                    help="live mode: scrape ticks before reporting")
    ap.add_argument("--interval", type=float, default=0.5)
    ap.add_argument("--limit", type=int, default=8,
                    help="kernel/bucket rows per table")
    ap.add_argument("--json", action="store_true",
                    help="emit raw sections + megabatch rows as JSON")
    ap.add_argument("--smoke", action="store_true",
                    help="one real coalesced multi-doc round, asserted "
                         "(CI self-check)")
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
        print(f"perf dispatch: nothing to report ({path} missing; run "
              "bench.py, or pass --post-mortem/--connect/--local)")
        return 0
    from .doctor import _load_post_mortem
    try:
        kind, data = _load_post_mortem(path)
    except (OSError, ValueError) as e:
        print(f"perf dispatch: cannot read {path}: {e}", file=sys.stderr)
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
    else:
        sections = sections_from_snapshot(data)
    return _report_all(sections, args)


if __name__ == "__main__":
    raise SystemExit(main())
