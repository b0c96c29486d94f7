"""Contention & convergence-lag report (`python -m automerge_tpu_torch.perf
contention`).

Renders the lock-contention plane (utils/lockprof.py) and the sampled
op-lifecycle plane (utils/oplag.py) out of recorded metrics snapshots —
by default the per-config snapshots a full bench run leaves in
`BENCH_DETAIL.json` (`configs.<n>.metrics`), or any raw
`metrics.snapshot()` JSON via --snapshot. Three sections per config:

- **locks** — per named lock: total wait, total hold, contended
  acquisitions, acquisition count (from the
  `sync_lock_{wait,hold}_s{lock=...}` histograms);
- **op lag** — per lifecycle stage: count, p50/p99/max (from the
  snapshot's nested `oplag` section, falling back to the
  `sync_op_lag_s{stage=...}` histogram summaries);
- **flush attribution** — where `sync_round_flush_s` wall time went:
  the in-flush engine sub-spans (`rows_round_apply_s` /
  `engine_resident_apply_s`) vs the service-host remainder
  (coalescing, logs, floors), with the config-wide pack/dispatch/
  device_wait phase totals as the engine-side split, plus the
  epoch-ingestion decomposition (r7): `commit_wait_s` (writer park
  from buffer append to group-commit resolution — NOT lock wait; the
  `buffer_wait` oplag stage is its sampled in-buffer slice) next to
  the residual `service*` lock wait, so the before/after of the
  lock-free admission refactor reads off one line.

Pure stdlib (like perf/history.py): loadable without importing torch.
"""

from __future__ import annotations

import json
import os
import re

from . import history

_LOCK_RE = re.compile(
    r"^sync_lock_(wait|hold)_s\{lock=([^}]*)\}_(count|sum|max)$")
_CONT_RE = re.compile(r"^sync_lock_contended_total\{lock=([^}]*)\}$")
_STAGE_RE = re.compile(
    r"^sync_op_lag_s\{stage=([^}]*)\}_(count|sum|max)$")

#: oplag stage display order (matches the lifecycle; unknown stages sort
#: after, alphabetically)
_STAGE_ORDER = ("causal_queue", "buffer_wait", "queue_wait", "pack",
                "dispatch", "device_wait", "flush", "origin_total", "wire",
                "peer_apply", "converge")


def _collapse(snapshot: dict, base: str) -> float:
    """Sum a span/timer total across its label variants:
    `sync_round_flush_s` + every `sync_round_flush{...}_s`."""
    total = 0.0
    pre, suf = (base[:-2], "_s") if base.endswith("_s") else (base, "")
    for k, v in snapshot.items():
        if not isinstance(v, (int, float)):
            continue
        if k == base or (k.startswith(pre + "{") and k.endswith(suf)
                         and "}" in k):
            total += v
    return total


def lock_table(snapshot: dict) -> dict[str, dict]:
    """{lock: {wait_s, hold_s, contended, acquires}} from a snapshot."""
    out: dict[str, dict] = {}

    def row(lock):
        return out.setdefault(lock, {"wait_s": 0.0, "hold_s": 0.0,
                                     "contended": 0, "acquires": 0})

    for k, v in snapshot.items():
        if not isinstance(v, (int, float)):
            continue
        m = _LOCK_RE.match(k)
        if m:
            kind, lock, stat = m.groups()
            r = row(lock)
            if stat == "sum":
                r[f"{kind}_s"] += v
            elif stat == "count" and kind == "hold":
                r["acquires"] += int(v)
            continue
        m = _CONT_RE.match(k)
        if m:
            row(m.group(1))["contended"] += int(v)
    return out


def stage_table(snapshot: dict) -> dict[str, dict]:
    """{stage: {count, p50_s?, p99_s?, max_s, sum_s?}}: the exact
    reservoir percentiles when the nested `oplag` section is present,
    else the histogram count/sum/max."""
    oplag = snapshot.get("oplag")
    if isinstance(oplag, dict) and isinstance(oplag.get("stages"), dict):
        return {s: dict(v) for s, v in oplag["stages"].items()}
    out: dict[str, dict] = {}
    for k, v in snapshot.items():
        if not isinstance(v, (int, float)):
            continue
        m = _STAGE_RE.match(k)
        if m:
            stage, stat = m.groups()
            r = out.setdefault(stage, {})
            key = {"count": "count", "sum": "sum_s", "max": "max_s"}[stat]
            r[key] = int(v) if stat == "count" else round(v, 6)
    return out


def _stage_sort_key(stage: str):
    try:
        return (0, _STAGE_ORDER.index(stage))
    except ValueError:
        return (1, stage)


def flush_attribution(snapshot: dict) -> dict | None:
    """Decompose sync_round_flush_s into named components. None when the
    snapshot recorded no flushes."""
    flush_s = _collapse(snapshot, "sync_round_flush_s")
    if flush_s <= 0:
        return None
    engine_s = (_collapse(snapshot, "rows_round_apply_s")
                + _collapse(snapshot, "engine_resident_apply_s"))
    engine_s = min(engine_s, flush_s)
    phases = ((snapshot.get("perf") or {}).get("phases") or {})

    def ph(name):
        e = phases.get(name)
        return float(e.get("s", 0.0)) if isinstance(e, dict) else 0.0

    out = {
        "flush_s": round(flush_s, 4),
        "engine_apply_s": round(engine_s, 4),
        "service_host_s": round(flush_s - engine_s, 4),
        # config-wide phase totals: the engine-side split (upper bounds
        # on in-flush time — hash-read dispatches share these buckets)
        "pack_s": round(ph("pack"), 4),
        "dispatch_s": round(ph("dispatch"), 4),
        "device_wait_s": round(ph("device_wait"), 4),
        "lock_wait_s": round(sum(
            r["wait_s"] for r in lock_table(snapshot).values()), 4),
        # epoch-ingestion split: writer group-commit park (not a lock)
        # vs the residual wait on the service* locks themselves
        "commit_wait_s": round(
            _collapse(snapshot, "sync_commit_wait_s_sum"), 4),
        "service_lock_wait_s": round(sum(
            r["wait_s"] for name, r in lock_table(snapshot).items()
            if name.startswith("service")), 4),
    }
    named = min(engine_s + ph("pack") + ph("dispatch") + ph("device_wait"),
                flush_s)
    out["measured_pct"] = round(100.0 * named / flush_s, 1)
    return out


def lines_for_snapshot(snapshot: dict, label: str) -> list[str]:
    """The human-readable contention section for one metrics snapshot."""
    lines: list[str] = []
    locks = lock_table(snapshot)
    stages = stage_table(snapshot)
    if not locks and not stages:
        return lines
    lines.append(f"# contention & convergence lag — {label}")
    if locks:
        lines.append(f"  {'lock':<18} {'wait_s':>10} {'hold_s':>10} "
                     f"{'contended':>10} {'acquires':>10}")
        for name in sorted(locks):
            r = locks[name]
            lines.append(f"  {name:<18} {r['wait_s']:>10.4f} "
                         f"{r['hold_s']:>10.4f} {r['contended']:>10} "
                         f"{r['acquires']:>10}")
    if stages:
        rate = (snapshot.get("oplag") or {}).get("sample_rate")
        tag = f" (sampled 1/{rate})" if rate else ""
        lines.append(f"  op lag by stage{tag}:")
        lines.append(f"  {'stage':<14} {'count':>7} {'p50_s':>10} "
                     f"{'p99_s':>10} {'max_s':>10}")
        for s in sorted(stages, key=_stage_sort_key):
            r = stages[s]
            p50 = r.get("p50_s")
            p99 = r.get("p99_s")
            lines.append(
                f"  {s:<14} {r.get('count', 0):>7} "
                f"{p50 if p50 is not None else '-':>10} "
                f"{p99 if p99 is not None else '-':>10} "
                f"{r.get('max_s', '-'):>10}")
    att = flush_attribution(snapshot)
    if att:
        lines.append(
            f"  flush attribution: sync_round_flush_s={att['flush_s']}s "
            f"-> engine apply {att['engine_apply_s']}s "
            f"({100 * att['engine_apply_s'] / att['flush_s']:.0f}%), "
            f"service host {att['service_host_s']}s "
            f"({100 * att['service_host_s'] / att['flush_s']:.0f}%); "
            f"engine-side phases (config-wide): pack {att['pack_s']}s, "
            f"dispatch {att['dispatch_s']}s, device_wait "
            f"{att['device_wait_s']}s; lock wait total "
            f"{att['lock_wait_s']}s (service* {att['service_lock_wait_s']}s)"
            f"; group-commit park {att['commit_wait_s']}s; "
            f"directly measured "
            f"{att['measured_pct']}% of flush wall time")
    return lines


def report_lines(detail_path: str | None = None,
                 snapshot_path: str | None = None,
                 config: str | None = None) -> list[str]:
    """The full report: one section per bench config carrying contention
    data (BENCH_DETAIL.json), or one section for a raw snapshot file."""
    if snapshot_path:
        try:
            with open(snapshot_path) as f:
                snap = json.load(f)
        except (OSError, ValueError) as e:
            return [f"perf contention: cannot read {snapshot_path}: {e}"]
        return (lines_for_snapshot(snap, os.path.basename(snapshot_path))
                or ["perf contention: snapshot carries no lock/op-lag "
                    "series (instrumented paths never ran?)"])
    path = detail_path or history.detail_path()
    try:
        with open(path) as f:
            detail = json.load(f)
    except (OSError, ValueError):
        return [f"perf contention: no bench detail at {path} "
                "(run bench.py, or pass --snapshot FILE)"]
    out: list[str] = []
    configs = detail.get("configs") or {}
    for cfg in sorted(configs, key=lambda c: (len(c), c)):
        if config is not None and cfg != str(config):
            continue
        m = (configs[cfg] or {}).get("metrics")
        if isinstance(m, dict):
            out.extend(lines_for_snapshot(
                m, f"{os.path.basename(path)} config {cfg}"))
    if not out:
        out.append("perf contention: no lock/op-lag series in "
                   f"{path} (pre-contention-plane capture, or "
                   "AMTPU_OPLAG_SAMPLE=0 run)")
    return out
