"""`perf tenant`: who pays for the fleet, and who waits.

The rendering end of the tenant attribution plane
(sync/tenantledger.py). Every mode reads the same `"tenantledger"`
snapshot section the fleet wire already ships, so live fleets,
post-mortem bench captures, and this process all get the identical
report:

- **totals** — tenants tracked (with overflow/truncation disclosure),
  fleet admitted changes and flush rounds, ledger self-time;
- **per-tenant table** — ingress share, wire bytes both ways,
  useful-vs-duplicate deliveries, governor shed/delay counts, the
  attributed dispatch share (Jiffy's amortized batch cost divided by
  who filled the batch), and the converge-lag p50/p99/max ring —
  ranked hottest-ingress first;
- an **attribution check** — the per-tenant shares summed back against
  the fleet totals (the config-18 1% gate, printed so a drifting hook
  is visible before the bench catches it).

Modes (mirroring `perf dispatch`):

    python -m automerge_tpu_torch.perf tenant                  # port's bench detail
    python -m automerge_tpu_torch.perf tenant --post-mortem P  # detail/dump/snapshot
    python -m automerge_tpu_torch.perf tenant --connect h:p    # scrape a live fleet
    python -m automerge_tpu_torch.perf tenant --smoke          # self-check rounds
    ... [--json] [--limit N] [--config C]

`--smoke` drives real coalesced flush rounds for three namespaced
tenants through an EngineDocSet (rows backend) and asserts the account
is live and honest: every tenant tracked, per-tenant ingress and
dispatch shares summing to the fleet totals within 1%, and a ledger
duty cycle under the 2% budget — the cheap proof (`chip_smoke.py` phase
16 runs it on the card) that the instrument is wired, without running a
bench.
"""

from __future__ import annotations

import json
import os
import sys
import time

from . import history


def sections_from_snapshot(snapshot: dict) -> dict:
    """label -> ledger section, from one node's metrics snapshot (empty
    when the node ships no `"tenantledger"` section)."""
    out = {}
    for label, sec in ((snapshot.get("tenantledger") or {})
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


def attribution_check(sec: dict) -> dict:
    """Per-tenant shares summed back against the fleet totals: the
    ingress sum must equal `admitted_total` exactly (same counter, split)
    and the summed dispatch shares must cover every attributed round —
    the config-18 'sums to fleet totals within 1%' gate, computed from
    one section so bench and CLI share the arithmetic. Truncated exports
    (more tenants than EXPORT_TENANTS) disclose rather than fail.

    r20 extends the proof to the flush-round cost axes: summed per-tenant
    dispatch/padded/logical/wall shares must land back on the ledger's
    fleet totals even when megabatched rounds split the area-like costs
    by lane occupancy instead of doc count (sync/tenantledger.py
    note_round) — re-weighting must never create or destroy cost. Those
    err_pcts are only meaningful on a complete export; err_pct (the
    headline) stays the max over the axes that could be checked."""
    tenants = sec.get("tenants") or {}
    admitted = sum(int(t.get("admitted") or 0) for t in tenants.values())
    total = int(sec.get("admitted_total") or 0)
    err_pct = (abs(admitted - total) * 100.0 / total) if total else 0.0
    complete = not (sec.get("truncated") or 0)
    out = {
        "admitted_sum": admitted,
        "admitted_total": total,
        "err_pct": round(err_pct, 4),
        "complete": complete,
    }
    if complete:
        for axis, key in (("dispatch", "dispatch_share"),
                          ("padded", "padded_share"),
                          ("logical", "logical_share"),
                          ("wall", "wall_share_s")):
            fleet = sec.get(f"{axis}_total" if axis != "wall"
                            else "wall_total_s")
            if fleet is None:
                continue
            summed = sum(float(t.get(key) or 0.0) for t in tenants.values())
            axis_err = (abs(summed - fleet) * 100.0 / fleet) if fleet else 0.0
            out[f"{axis}_sum"] = round(summed, 4)
            out[f"{axis}_total"] = fleet
            out[f"{axis}_err_pct"] = round(axis_err, 4)
            out["err_pct"] = max(out["err_pct"], round(axis_err, 4))
    return out


def _fmt(v, unit="", nd=2):
    if not isinstance(v, (int, float)):
        return "-"
    return f"{v:.{nd}f}{unit}"


def report_lines(label: str, sec: dict, limit: int = 8) -> list[str]:
    """One node's ledger section as the plain-text report (the testable
    surface; `main` only gathers and prints)."""
    tenants = sec.get("tenants") or {}
    lines = [f"# perf tenant — {label}"]
    lines.append(
        f"  totals: {sec.get('tracked', 0)} tenant(s) "
        f"(prefix {sec.get('prefix')!r}), "
        f"{sec.get('admitted_total', 0)} admitted change(s), "
        f"{sec.get('rounds_total', 0)} attributed round(s), "
        f"ledger self {_fmt(sec.get('self_s'), 's', 4)}")
    overflow = sec.get("overflow_tenants") or 0
    if overflow:
        lines.append(f"  ({overflow} tenant id(s) folded into "
                     "'_overflow' past the tracking cap)")
    if tenants:
        lines.append(
            f"  {'tenant':<14} {'share':>7} {'admitted':>9} "
            f"{'disp':>7} {'tx_B':>9} {'rx_B':>9} {'dup':>5} "
            f"{'shed':>5} {'p99_s':>8} {'max_s':>8}")
        shown = list(tenants.items())[:limit]
        for tid, t in shown:
            lag = t.get("lag") or {}
            useful = t.get("recv_useful") or 0
            dup = t.get("recv_duplicate") or 0
            shed = ((t.get("shed_dropped") or 0)
                    + (t.get("shed_delayed") or 0))
            lines.append(
                f"  {tid[:14]:<14} "
                f"{_fmt(t.get('ingress_share_pct'), '%', 1):>7} "
                f"{t.get('admitted', 0):>9} "
                f"{_fmt(t.get('dispatch_share'), nd=1):>7} "
                f"{t.get('bytes_sent', 0):>9} "
                f"{t.get('bytes_received', 0):>9} "
                f"{(f'{dup}/{useful + dup}' if (useful + dup) else '-'):>5} "
                f"{shed:>5} "
                f"{_fmt(lag.get('p99_s'), nd=4):>8} "
                f"{_fmt(lag.get('max_s'), nd=4):>8}")
        if len(tenants) > limit:
            lines.append(f"  (+{len(tenants) - limit} more tenant(s) — "
                         "raise --limit)")
        truncated = sec.get("truncated") or 0
        if truncated:
            lines.append(f"  (+{truncated} tracked tenant(s) beyond the "
                         "export cap not shown)")
        chk = attribution_check(sec)
        lines.append(
            f"  attribution: ingress {chk['admitted_sum']}/"
            f"{chk['admitted_total']} "
            f"(err {_fmt(chk['err_pct'], '%', 2)})"
            + ("" if chk["complete"] else " [export truncated]"))
    else:
        lines.append("  (no tenant traffic recorded)")
    return lines


def gather_local() -> dict:
    """This process's ledger, in the same label->section shape."""
    from ..sync import tenantledger
    sec = tenantledger.ledger().section()
    return {sec["label"]: sec} if sec else {}


def _report_all(sections: dict, args) -> int:
    if not sections:
        print("perf tenant: no tenant-ledger data "
              "(AMTPU_TENANTLEDGER=0, or no traffic yet)")
        return 0
    if args.json:
        print(json.dumps(
            {label: {"section": sec,
                     "attribution": attribution_check(sec)}
             for label, sec in sections.items()},
            indent=1, default=str))
        return 0
    for label in sorted(sections):
        print("\n".join(report_lines(label, sections[label],
                                     limit=args.limit)))
    return 0


# ---------------------------------------------------------------------------
# smoke: three namespaced tenants, asserted end to end


def smoke_run(n_docs: int = 4, rounds: int = 4,
              verbose: bool = True, device="cuda") -> int:
    """Drive `rounds` coalesced flush rounds of three namespaced tenants
    (`tenant/a/...`, `tenant/b/...`, plus un-namespaced docs landing in
    `_default`) through a rows EngineDocSet and assert the account is
    live and honest: all three tenants tracked, per-tenant ingress
    summing to the fleet total within 1% (config 18's attribution gate),
    per-tenant dispatch shares covering the attributed rounds, and
    ledger self-time under the 2% duty-cycle budget (perf/history.py
    TENANT_LEDGER_BUDGET_PCT, a bound on wall time). The service runs on
    `device`."""
    from ..core.change import Change, Op
    from ..core.ids import ROOT_ID
    from ..device import resolve_device
    from ..sync import tenantledger
    from ..sync.service import EngineDocSet

    device = resolve_device(device)

    if not tenantledger.enabled():
        print("perf tenant --smoke: ledger disabled "
              "(AMTPU_TENANTLEDGER=0) — nothing to prove")
        return 0
    led = tenantledger.ledger()
    base = led.section() or {}
    base_admitted = int(base.get("admitted_total") or 0)
    base_self = led.self_seconds()
    svc = EngineDocSet(backend="rows", device=device)
    # pin the eager (card-posture) dispatch path: CPU services normally
    # defer the reconcile to hash reads, which would leave every flush
    # round without dispatch shares to attribute
    svc._lazy_resolved = True
    svc._resident.lazy_dispatch = False
    docs = ([f"tenant/a/doc{i}" for i in range(n_docs)]
            + [f"tenant/b/doc{i}" for i in range(n_docs)]
            + [f"doc{i}" for i in range(n_docs)])
    try:
        t0 = time.perf_counter()
        for r in range(rounds):
            with svc.batch():
                for i, d in enumerate(docs):
                    svc.apply_changes(d, [Change(
                        actor=f"w{i}", seq=r + 1, deps={},
                        ops=[Op("set", ROOT_ID, key=f"k{r}", value=r)])])
        svc.hashes()
        traffic_wall = time.perf_counter() - t0
    finally:
        svc.close()

    sec = led.section()
    assert sec, "smoke rounds left no ledger section"
    tenants = sec.get("tenants") or {}
    for tid in ("a", "b", tenantledger.DEFAULT_TENANT):
        assert tid in tenants, (
            f"tenant {tid!r} not tracked (got {sorted(tenants)})")
    new_admitted = int(sec.get("admitted_total") or 0) - base_admitted
    assert new_admitted >= rounds * len(docs), (
        f"expected >= {rounds * len(docs)} admitted changes, "
        f"got {new_admitted}")
    chk = attribution_check(sec)
    assert chk["err_pct"] < history.TENANT_ATTRIBUTION_ERR_MAX_PCT, (
        f"per-tenant ingress attribution off by {chk['err_pct']}% "
        f"(>= {history.TENANT_ATTRIBUTION_ERR_MAX_PCT}%)")
    rounds_covered = sum(int(t.get("rounds") or 0)
                         for t in tenants.values())
    assert rounds_covered >= int(sec.get("rounds_total") or 0), (
        "attributed rounds do not cover the fleet round total")
    disp = sum(float(t.get("dispatch_share") or 0.0)
               for t in tenants.values())
    assert disp > 0, "no dispatch share attributed to any tenant"
    self_s = led.self_seconds() - base_self
    duty_pct = 100.0 * self_s / max(traffic_wall, 1e-9)
    budget = history.TENANT_LEDGER_BUDGET_PCT
    assert duty_pct < budget, (
        f"ledger duty cycle {duty_pct:.3f}% breaches the {budget}% budget")
    if verbose:
        print(f"perf tenant --smoke OK: {rounds} round(s) x {len(docs)} "
              f"docs over {len(tenants)} tenant(s), attribution err "
              f"{chk['err_pct']}%, ledger duty cycle {duty_pct:.3f}% "
              f"(< {history.TENANT_LEDGER_BUDGET_PCT}%)")
        print("\n".join(report_lines(sec.get("label", "local"), sec,
                                     limit=4)))
    return 0


# ---------------------------------------------------------------------------
# CLI


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="automerge_tpu_torch.perf tenant")
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
                    help="tenant rows per table")
    ap.add_argument("--json", action="store_true",
                    help="emit raw sections + attribution checks as JSON")
    ap.add_argument("--smoke", action="store_true",
                    help="three-tenant coalesced rounds, asserted "
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
        print(f"perf tenant: nothing to report ({path} missing; run "
              "bench.py, or pass --post-mortem/--connect/--local)")
        return 0
    from .doctor import _load_post_mortem
    try:
        kind, data = _load_post_mortem(path)
    except (OSError, ValueError) as e:
        print(f"perf tenant: cannot read {path}: {e}", file=sys.stderr)
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
