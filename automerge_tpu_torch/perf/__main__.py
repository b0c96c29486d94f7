"""CLI for the port's performance plane: `python -m automerge_tpu_torch.perf
{report,check,contention,doctor,explain,top,dispatch,tenant,trace,
remediate,move,bootstrap,race,megabatch,roofline,resident}` (the reference's
`automerge_tpu/perf/__main__.py`, on the port's modules).

- `report` / `check` — the port's bench history
  (`bench_history_torch.jsonl`, `backend: "cuda"` records) and its
  regression gate; `check` skips cleanly while the file is absent.
- `contention` — lock waits and convergence lag from a bench detail or a
  metrics snapshot.
- `doctor`  — ranked root-cause report: live against a fleet
  (--connect), or post-mortem against a bench detail / flight-recorder
  dump / metrics snapshot (--post-mortem).
- `explain` — per-DOC causal convergence debugger over the docledger
  sections: `perf explain <doc>` names the blocking cause; without a doc
  it lists the worst-lagging docs. Same modes as the doctor.
- `top`     — live terminal dashboard (fleet table, SLO verdict strip,
  sparklines, per-doc hot list) driven by the fleet collector.
- `dispatch` — dispatch-efficiency report over the kernel-routing ledger
  (engine/dispatchledger.py); `tenant` — the tenant attribution plane
  (sync/tenantledger.py); `trace` — the trace plane (utils/tracer.py).
  Same modes as the doctor, plus `--smoke`.
- `remediate`, `move`, `bootstrap`, `race`, `megabatch` — the smokes:
  chaos recovery over a supervised TCP link, the move plane (with the
  move kernel held to the host walk), a snapshot cold boot, a threaded
  storm under the lock sanitizer, and the fused multi-doc round.

Every smoke takes `--device` (default `cuda`; it raises without a card,
pass `--device cpu` on a machine without one) and ends with a line
`perf launches: {...}`, the kernel launches it made
(`engine/cuda_kernels.LAUNCHES`).

- `roofline` — the rows kernel's bandwidth on the card (B1's base body and
  B2, the XL body) against the H100's HBM spec and its measured copy rate;
  `--cpu-smoke` runs two tiny probes on the CPU. Writes
  ROOFLINE_torch.json.
- `resident` — the stage breakdown of `ResidentRowsDocSet.
  apply_round_frames` (`--device`, default `cuda`).

Exit codes: 0 = ok (including a gracefully skipped check), 1 = the
regression gate tripped (or a probe failed), 2 = usage error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import history


def _cmd_check(argv) -> int:
    ap = argparse.ArgumentParser(prog="automerge_tpu_torch.perf check")
    ap.add_argument("--history", default=None,
                    help="path to the port's history file "
                         "(default: bench_history_torch.jsonl at the "
                         "repo root)")
    ap.add_argument("--record", default=None,
                    help="judge this JSON record file instead of the last "
                         "history entry (it is compared against the whole "
                         "file)")
    ap.add_argument("--window", type=int, default=history.DEFAULT_WINDOW)
    ap.add_argument("--threshold-pct", type=float,
                    default=history.DEFAULT_THRESHOLD_PCT,
                    help="fail when throughput drops below "
                         "(1 - pct/100) x rolling median")
    ap.add_argument("--compile-growth-pct", type=float,
                    default=history.DEFAULT_COMPILE_GROWTH_PCT,
                    help="fail when total compiles exceed the rolling "
                         "median by more than pct (+2 absolute slack)")
    ap.add_argument("--hash-growth-pct", type=float,
                    default=history.DEFAULT_HASH_GROWTH_PCT,
                    help="fail when the clean-fleet convergence read "
                         "(fleet_hashes_s) exceeds the rolling median by "
                         "more than pct (+0.25s absolute slack)")
    ap.add_argument("--no-backfill", action="store_true",
                    help="do not create the history file from the "
                         "port's committed BENCH_TORCH_r*.json captures "
                         "when missing")
    args = ap.parse_args(argv)

    path = args.history or history.history_path()
    if not args.no_backfill and not os.path.exists(path):
        n = history.ensure_backfilled(path=path)
        if n:
            print(f"perf check: backfilled {n} records from committed "
                  f"{history.CAPTURE_GLOB} captures -> {path}")
    record = None
    if args.record:
        try:
            with open(args.record) as f:
                record = json.load(f)
        except (OSError, ValueError) as e:
            print(f"perf check: cannot read --record {args.record}: {e}",
                  file=sys.stderr)
            return 2
        if "schema" not in record:   # a raw bench final/compact record
            # stamp_host=False: the capture's provenance is whatever the
            # record itself says (bench stamps `host` at run time) — the
            # CHECKING machine's identity must not be invented onto a
            # record produced elsewhere
            record = history.record_from_bench(record, source=args.record,
                                               stamp_host=False)
    rc, lines = history.check(
        path=path, record=record, window=args.window,
        threshold_pct=args.threshold_pct,
        compile_growth_pct=args.compile_growth_pct,
        hash_growth_pct=args.hash_growth_pct)
    print("\n".join(lines))
    print("PERFCHECK", "FAIL" if rc else "OK")
    return rc


def _cmd_report(argv) -> int:
    ap = argparse.ArgumentParser(prog="automerge_tpu_torch.perf report")
    ap.add_argument("--history", default=None)
    ap.add_argument("--no-backfill", action="store_true")
    args = ap.parse_args(argv)
    path = args.history or history.history_path()
    if not args.no_backfill and not os.path.exists(path):
        history.ensure_backfilled(path=path)
    records = history.load(path)
    if not records:
        print("perf report: no history "
              f"({path} is missing or empty; the port's bench writes it)")
        return 0
    print(f"# bench history — {len(records)} records ({path})")
    print(f"{'#':>3} {'source':<28} {'backend':<8} "
          f"{'ops/sec':>12} {'vs_base':>8}  configs(speedup)")
    for i, r in enumerate(records):
        cfgs = r.get("configs") or {}
        cfg_s = " ".join(
            f"{c}:{(cfgs[c] or {}).get('speedup')}"
            for c in sorted(cfgs, key=lambda c: (len(c), c))
            if (cfgs[c] or {}).get("speedup") is not None)
        value = r.get("value")
        print(f"{i:>3} {str(r.get('source', '?'))[:28]:<28} "
              f"{str(r.get('backend', '?')):<8} "
              f"{value if value is not None else '-':>12} "
              f"{str(r.get('vs_baseline', '-')):>8}  {cfg_s}")
    last = records[-1]
    perf = last.get("perf")
    if perf:
        print(f"# latest perf: {perf.get('compiles_total')} compiles "
              f"across {len(perf.get('kernels') or {})} kernels: "
              + ", ".join(f"{k}={v}"
                          for k, v in sorted(
                              (perf.get("kernels") or {}).items())))
    # the in-repo detail sidecar, when the last bench run left one
    detail = os.path.join(os.path.dirname(path), history.DETAIL_BASENAME)
    if os.path.exists(detail):
        print(f"# full per-config breakdown: {detail}")
        # the contention & convergence-lag section (informational)
        from . import contention
        for line in contention.report_lines(detail_path=detail):
            print(line)
    return 0


def _cmd_contention(argv) -> int:
    ap = argparse.ArgumentParser(prog="automerge_tpu_torch.perf contention")
    ap.add_argument("--detail", default=None,
                    help="bench detail to read per-config snapshots "
                         "from (default: the port's, "
                         "BENCH_DETAIL_TORCH.json at the repo root)")
    ap.add_argument("--snapshot", default=None,
                    help="render a raw metrics.snapshot() JSON file "
                         "instead of the bench detail")
    ap.add_argument("--config", default=None,
                    help="restrict the detail report to one bench config")
    args = ap.parse_args(argv)
    from . import contention
    print("\n".join(contention.report_lines(
        detail_path=args.detail, snapshot_path=args.snapshot,
        config=args.config)))
    return 0


#: subcommand -> (module, entry) of the lazily imported planes
LAZY = {
    "doctor": ("doctor", "main"),
    "explain": ("explain", "main"),
    "top": ("top", "main"),
    "dispatch": ("dispatchplane", "main"),
    "tenant": ("tenantplane", "main"),
    "trace": ("traceplane", "main"),
    # the chaos-recovery smoke: one injected fault, assert the supervised
    # link self-heals
    "remediate": ("remediate", "smoke_main"),
    # the move-plane smoke: concurrent cycle storm on two services,
    # convergence + kernel parity asserted
    "move": ("moveplane", "smoke_main"),
    # the replica-bootstrap smoke: deep-history doc -> snapshot ->
    # cold-boot a fresh replica, byte-equal hashes
    "bootstrap": ("bootstrap", "smoke_main"),
    # the race-plane smoke: a threaded sync storm under AMTPU_LOCKSAN=1,
    # zero sanitizer violations, sanitizer overhead < 5%
    "race": ("raceplane", "smoke_main"),
    # the megabatch-plane smoke: a mixed-shape fleet storm through the
    # fused multi-doc round, byte-equal against the AMTPU_MEGABATCH=0
    # path, occupancy asserted
    "megabatch": ("megabatchplane", "smoke_main"),
    # the rows kernel's roofline probe (B1 base, B2 XL) on the card
    "roofline": ("roofline", "main"),
    # the stage breakdown of the round-frame ingress
    "resident": ("resident", "main"),
}
#: commands whose run is a smoke (and so reports its kernel launches)
SMOKES = ("remediate", "move", "bootstrap", "race", "megabatch")


def _launches_line() -> str:
    """The kernel launches this process made, as one line."""
    from ..engine import cuda_kernels
    return "perf launches: " + json.dumps(
        {k: v for k, v in cuda_kernels.LAUNCHES.items() if v})


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    commands = {
        "check": _cmd_check,
        "report": _cmd_report,
        "contention": _cmd_contention,
    }
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    if cmd in commands:
        return commands[cmd](rest)
    if cmd in LAZY:
        import importlib
        modname, attr = LAZY[cmd]
        mod = importlib.import_module(f"{__package__}.{modname}")
        rc = getattr(mod, attr)(rest)
        if cmd in SMOKES or "--smoke" in rest:
            print(_launches_line())
        return rc
    print(f"unknown command {cmd!r}; expected one of "
          "report, check, contention, doctor, explain, top, dispatch, "
          "tenant, trace, remediate, move, bootstrap, race, megabatch, "
          "roofline, resident", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
