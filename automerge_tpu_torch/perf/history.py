"""Bench-history ledger + regression gate (the port's
`bench_history_torch.jsonl`; a copy of `automerge_tpu/perf/history.py`,
pure stdlib).

- **`bench_history_torch.jsonl`** (repo root): one JSON record per run of
  the port's bench, which records `backend: "cuda"`. The reference's
  `bench_history.jsonl` and its `BENCH_r0*.json` captures are runs of the
  JAX package on a TPU or a CPU: this module never reads or writes them.
  The port's file is absent until the port's bench writes it, and
  `perf check` skips cleanly while it is. `backfill_records` reads the
  port's own captures (`BENCH_TORCH_r*.json`) only.
- **`python -m automerge_tpu_torch.perf check`**: compares the most recent
  run against the rolling median of prior runs **on the same backend**
  (a CPU run must never be judged against card history — the
  backend-labeling rule) and exits nonzero on a throughput regression or
  growth in kernel builds (`compiles_total`).

Record schema (one line of the history file, schema 1):

    {
      "schema": 1,
      "at": <epoch seconds>,
      "source": "bench.py" | "backfill:BENCH_TORCH_r01.json",
      "backend": "cuda" | "cpu" | "none",
      "headline_config": "5",   # which config produced `value` (partial
                                # runs fall back to another config; the
                                # gate only compares like with like)
      "value": <headline engine ops/sec (config 5)>,
      "unit": "ops/sec",
      "vs_baseline": <headline speedup>,
      "configs": {"<cfg>": {"speedup": .., "engine_ops_per_s": ..}},
      "perf": {"compiles_total": <n>, "kernels": {"<kernel>": <compiles>}},
      "metrics": {<bench _metrics_rollup, when available>},
      "host": {"cpus": <n>, "machine": "x86_64"},   # additive (r6):
                                 # the gate only compares same-host-class
                                 # records (raw ops/sec is ~10x apart
                                 # between a 2-core container and a big
                                 # runner on identical code)
      "fleet": {                 # additive (r6) — present when config 8 ran
        "fleet_hashes_s": <clean-fleet hashes() wall seconds>,
        "fleet_hashes_first_s": <all-dirty first read>,
        "fleet_hashes_clean_shards": <n>, "fleet_hashes_dirty_shards": <n>,
        "round_cost_scaling": <full/quarter round-cost ratio>,
        "round_max_s": <max round>
      }
    }

The `fleet` section feeds the convergence-read gate: `perf check` fails
when the clean-fleet `fleet_hashes_s` grows past the rolling same-backend
median by more than `--hash-growth-pct` (+0.25s absolute slack for timer
jitter on sub-second reads) — the regression it guards against is the
exact r5 stall class (a convergence read silently going O(fleet) again).
Same skip-clean semantics as the throughput gate: records missing the
section on either side are never compared, and no baseline is invented.

Backfilled records carry whatever the bench capture preserved (compact
records have per-config speedups only; no `perf` section), and the gate
skips any comparison whose inputs are missing on either side — it never
invents a baseline.

This module stays pure-stdlib and free of package-relative imports, so
a bench parent process can load it by file path without importing torch.
"""

from __future__ import annotations

import glob
import json
import os
import platform
import statistics
import time

SCHEMA = 1
HISTORY_BASENAME = "bench_history_torch.jsonl"
#: the port's own bench captures (never the reference's BENCH_r0*.json)
CAPTURE_GLOB = "BENCH_TORCH_r*.json"
#: the port's bench detail (never the reference's BENCH_DETAIL.json)
DETAIL_BASENAME = "BENCH_DETAIL_TORCH.json"

#: gate defaults (docs/OBSERVABILITY.md "Performance plane"). A fresh run
#: fails when its throughput drops below (1 - threshold/100) x the rolling
#: same-backend median — 35% absorbs the measured run-to-run jitter of the
#: CPU fallback records while a 2x regression (ratio 0.5) still trips —
#: or when its total compile count exceeds the median by more than
#: growth/100 (+2 absolute slack for one-off warmup variance).
DEFAULT_WINDOW = 8
DEFAULT_THRESHOLD_PCT = 35.0
DEFAULT_COMPILE_GROWTH_PCT = 50.0
#: convergence-read gate: fail when the clean-fleet hashes() read exceeds
#: the rolling same-backend median by more than this (+ the absolute
#: slack, which absorbs timer jitter on reads that are milliseconds).
DEFAULT_HASH_GROWTH_PCT = 100.0
HASH_ABS_SLACK_S = 0.25
#: keystroke-flatness ceiling (config 7, r8): keystroke latency at 4x
#: document length over 1x. The acceptance bar is 1.25; the GATE fails at
#: a looser ceiling so one noisy slice on a busy 2-core container cannot
#: red a healthy run (the recorded value is still the honest number).
DEFAULT_FLATNESS_MAX = 1.5

#: fleet-health collector gate (r9, config 11): the collector's own
#: scrape tick p50 must stay under this ABSOLUTE budget — a health plane
#: whose scrape cost creeps up is quietly taxing every node it watches.
#: Absolute (not median-relative): scrape cost is a property of the
#: collector code, not the workload, and the bound mirrors the
#: collector_overhead SLO default (perf/slo.py DEFAULT_SCRAPE_P50_S).
SCRAPE_BUDGET_S = 0.25

#: per-doc convergence-ledger gate (r11, config 12): the ledger's own
#: duty cycle (mutation-path self time / traffic wall, worst node) must
#: stay under this ABSOLUTE percentage — doc-granular observability that
#: taxes the sync hot path more than 2% is not "observability", it is
#: the workload. Absolute for the same reason as the scrape budget: the
#: cost is a property of the ledger code, not of the traffic mix.
LEDGER_BUDGET_PCT = 2.0

#: dispatch-efficiency-ledger gate (r17, config 17): the dispatch
#: ledger's duty cycle (scope/fold self time / traffic wall) must stay
#: under this ABSOLUTE percentage — the same posture as the doc ledger's
#: bound above, and for the same reason: an instrument that taxes the
#: flush path it measures is the workload, not observability.
DISPATCH_LEDGER_BUDGET_PCT = 2.0

#: tenant-attribution-plane gates (r18, config 18). Both ABSOLUTE —
#: properties of the tenantledger code, not of the traffic mix:
#: the tenant ledger's duty cycle (hook self time / traffic wall) must
#: stay under the same 2% bound every other ledger honors,
TENANT_LEDGER_BUDGET_PCT = 2.0
#: and the per-tenant shares must sum back to the fleet totals within
#: this percentage — attribution that leaks cost is worse than none,
#: because it assigns blame that does not add up.
TENANT_ATTRIBUTION_ERR_MAX_PCT = 1.0

#: trace-plane gates (r19, config 19). All ABSOLUTE — properties of the
#: tracer code (utils/tracer.py), not of the traffic mix:
#: the plane's duty cycle (hook self time / traffic wall, both nodes
#: combined) must stay under the same 2% bound every other ledger
#: honors — an instrument that taxes the lifecycle it measures is the
#: workload, not observability,
TRACE_LEDGER_BUDGET_PCT = 2.0
#: sampled traces must COMPLETE (origin finalize through converged-hash
#: visibility, across the wire) at at least this rate — an instrument
#: that loses traces mid-lifecycle reports a biased critical path,
TRACE_COMPLETENESS_MIN_PCT = 99.0
#: and the per-stage span sums must reconcile with the doc ledger's
#: independently measured end-to-end lag within this percentage —
#: stages that do not add up to the e2e number are decomposing
#: something other than the latency they claim to explain.
TRACE_STAGE_SUM_ERR_MAX_PCT = 5.0

#: megabatch-plane gates (r20, config 20). Both ABSOLUTE — the first is
#: the perf claim the plane exists to cash, the second is the r17
#: baseline it must divide:
#: the fused multi-doc round path must flush the 10K-doc zipf storm at
#: least this many times faster than the identical storm under
#: AMTPU_MEGABATCH=0 (the per-doc reference path),
MEGABATCH_SPEEDUP_MIN = 5.0
#: and fused dispatches per dirty doc served must stay STRICTLY below
#: the per-doc dispatch-amplification floor config 17 recorded — a
#: megabatch that does not divide amplification is just padding.
MEGABATCH_AMP_MAX = 0.019

#: partial-replication gates (r12, config 13). All ABSOLUTE — each is a
#: property of the subscription/relay code, not of the host:
#: relay-tree total fan-out bytes must grow sublinearly in subscriber
#: count (growth exponent over N=8..128 strictly under 1.0; the bench
#: asserts a tighter 0.9 in-run),
SUB_GROWTH_EXP_MAX = 1.0
#: relay bytes/subscriber must stay under this fraction of the flat
#: full-sync baseline's bytes/subscriber,
SUB_FANOUT_MESH_FRACTION_MAX = 0.5
#: the relay tree's duplicate/useful delivery ratio must stay under
#: 1.2 — against the 1.85 full-mesh ratio config 12 recorded as the
#: baseline partial replication improves,
SUB_REDUNDANCY_MAX = 1.2
#: and subscribed-doc converge-p99 must stay within the default
#: converge SLO (mirrors perf/slo.py DEFAULT_CONVERGE_P99_S).
SUB_CONVERGE_P99_BUDGET_S = 2.0

#: move-plane gates (r16, config 16). All ABSOLUTE — properties of the
#: move plane, not of the host:
#: move-as-atom must beat the delete+reinsert emulation by at least
#: this factor on BOTH wire-frame and archived-log bytes for subtree
#: reparents (the capability headline: one op vs re-shipping the tree),
MOVE_BYTES_RATIO_MIN = 5.0
#: and one batched winner+cycle resolution must beat the per-op host
#: walk on a >= 1K mutually-concurrent move storm (recorded ~x196; the
#: floor only guards the direction).
MOVE_RESOLVE_SPEEDUP_MIN = 1.0

#: remediation gates (r13, config 14). All ABSOLUTE — properties of the
#: remediation code, not of the host:
#: every injected fault class must return the live fleet to SLO-green
#: with zero human action inside this MTTR budget,
REMED_MTTR_BUDGET_S = 30.0
#: at least this many fault classes must be injected AND recovered
#: (incl. conn_kill and a straggler fault — the bench enforces the mix),
REMED_MIN_CLASSES = 4
#: the remediation engine's steady-state judging duty cycle
#: (tick-p50 / scrape interval) must stay under this percentage — the
#: same 2% bar the collector (config 11) and the ledger (config 12)
#: hold their own overhead to,
REMED_BUDGET_PCT = 2.0

#: replica-bootstrap gates (r15, config 15). All ABSOLUTE — properties
#: of the storage tier, not the host:
#: a fresh replica joining a deep-history fleet via snapshot+tail must
#: converge at least this many times faster than full-history replay,
BOOTSTRAP_SPEEDUP_MIN = 5.0
#: the compacted snapshot images must be strictly smaller than the
#: archived op logs covering the same prefix (the bench asserts a much
#: tighter ratio in-run; the gate pins the direction),
SNAPSHOT_LOG_RATIO_MAX = 1.0
#: and converged-state hashes must be byte-equal between the snapshot
#: path and the replay path (asserted in-run; the gate re-checks the
#: recorded verdict so a disabled assertion cannot ship silently).

#: config-8 fields copied into the history record's `fleet` section
FLEET_KEYS = ("fleet_hashes_s", "fleet_hashes_first_s",
              "fleet_hashes_clean_shards", "fleet_hashes_dirty_shards",
              "round_cost_scaling", "round_max_s")


def repo_root() -> str:
    """The repo root this module is installed under (…/automerge_tpu_torch/
    perf/history.py -> three levels up)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def history_path(root: str | None = None) -> str:
    return os.path.join(root or repo_root(), HISTORY_BASENAME)


def detail_path(root: str | None = None) -> str:
    """The port's bench detail (per-config metrics snapshots), the
    planes' default post-mortem; never the reference's BENCH_DETAIL.json."""
    return os.path.join(root or repo_root(), DETAIL_BASENAME)


def load(path: str | None = None) -> list[dict]:
    """All parseable records, file order (oldest first). Unparseable lines
    are skipped — a torn tail from a killed run must not wedge the gate."""
    path = path or history_path()
    out: list[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict):
                    out.append(rec)
    except OSError:
        return []
    return out


def append(record: dict, path: str | None = None) -> str:
    path = path or history_path()
    with open(path, "a") as f:
        f.write(json.dumps(record, sort_keys=True) + "\n")
    return path


# ---------------------------------------------------------------------------
# record construction


def _norm_configs(raw) -> dict:
    """Normalize a bench record's `configs` section: full records map each
    config to a dict, compact/captured records to a bare speedup float."""
    out: dict = {}
    if not isinstance(raw, dict):
        return out
    for cfg, v in raw.items():
        if isinstance(v, dict):
            entry = {k: v[k] for k in ("speedup", "engine_ops_per_s",
                                       "device_speedup", "backend",
                                       # the contention plane (r7):
                                       # per-config lock wait + sampled
                                       # op-lag percentiles, the baseline
                                       # ROADMAP #1's refactor must beat
                                       "lock_wait_total_s",
                                       "op_lag_p50_s", "op_lag_p99_s",
                                       # multi-writer admission (r8,
                                       # config 9): the epoch-ingestion
                                       # headline + its A/B evidence
                                       "admission_ops_per_s",
                                       "admission_scaling_4x",
                                       "admission_vs_r6_single_writer_x",
                                       "service_lock_wait_reduction_x",
                                       "service_lock_wait_locked_s",
                                       "service_lock_wait_epoch_s",
                                       # the text span plane (r8): config
                                       # 10's bulk-merge headline + A/B
                                       # evidence, and config 7's measured
                                       # length-flatness ratio
                                       "merge_ops_per_s",
                                       "merge_speedup_vs_perop",
                                       "merge_speedup_vs_replay",
                                       "span_merge_s", "perop_merge_s",
                                       "ms_per_keystroke",
                                       "keystroke_flatness",
                                       # the fleet health plane (r9,
                                       # config 11): collector scrape
                                       # cost + overhead A/B + how many
                                       # injected fault classes the
                                       # doctor attributed correctly
                                       "scrape_p50_s", "scrape_p99_s",
                                       "collector_overhead_pct",
                                       "collector_duty_cycle_pct",
                                       "round_overhead_pct",
                                       "hashes_overhead_pct",
                                       "faults_attributed",
                                       # per-doc sync observability
                                       # (r11, config 12): lag
                                       # percentiles, mesh redundancy,
                                       # ledger duty cycle, explain
                                       # attribution
                                       "doc_lag_p50_s", "doc_lag_p99_s",
                                       "doc_lag_max_s",
                                       "redundancy_ratio",
                                       "redundancy_floor",
                                       "ledger_overhead_pct",
                                       "explain_attributed",
                                       "mesh_nodes",
                                       # partial replication (r12,
                                       # config 13): relay fan-out
                                       # sublinearity + redundancy +
                                       # subscribed-doc SLO + backfill
                                       "fanout_bytes_per_sub",
                                       "mesh_bytes_per_sub",
                                       "fanout_vs_mesh_fraction",
                                       "fanout_growth_exponent",
                                       "sub_redundancy_ratio",
                                       "sub_converge_p99_s",
                                       "sub_slo_bound_s",
                                       "sub_backfill_ok",
                                       # remediation (r13, config 14):
                                       # chaos-to-green MTTR, recovered
                                       # class count, dry-run proof,
                                       # steady-state duty cycle
                                       "mttr_max_s", "mttr_mean_s",
                                       "mttr_budget_s",
                                       "fault_classes_injected",
                                       "fault_classes_recovered",
                                       "remed_overhead_pct",
                                       "remed_tick_p50_s",
                                       "remed_dry_run_clean",
                                       "remed_actions_total",
                                       "reconnects_total",
                                       # replica bootstrap (r15, config
                                       # 15): snapshot+tail vs replay
                                       # time-to-converged, image-vs-log
                                       # size, in-run parity verdict
                                       "bootstrap_speedup_x",
                                       "bootstrap_snapshot_s",
                                       "bootstrap_replay_s",
                                       "snapshot_log_ratio",
                                       "snapshot_bytes", "archive_bytes",
                                       "bootstrap_hash_parity",
                                       "bootstrap_docs_per_fleet",
                                       "bootstrap_changes_per_doc",
                                       "bootstrap_fallbacks",
                                       "compaction_ratio",
                                       # the move plane (r16, config
                                       # 16): atom-vs-emulation byte
                                       # ratios, batched-vs-per-op
                                       # resolution, in-run parity +
                                       # convergence verdicts
                                       "move_wire_ratio_x",
                                       "move_archive_ratio_x",
                                       "move_atom_ops_per_s",
                                       "reorder_ops_per_s",
                                       "move_resolve_speedup_x",
                                       "move_batch_resolve_s",
                                       "move_perop_resolve_s",
                                       "move_storm_moves",
                                       "move_cycles_dropped",
                                       "move_kernel_parity",
                                       "move_pallas_parity",
                                       "move_storm_converged",
                                       # the dispatch-efficiency ledger
                                       # (r17, config 17): baseline
                                       # amplification + padding waste,
                                       # ledger duty cycle, disabled-
                                       # path parity, megabatch
                                       # projection
                                       "dispatch_amplification",
                                       "dispatch_pad_waste_pct",
                                       "dispatches_per_round",
                                       "dispatch_ledger_overhead_pct",
                                       "dispatch_disabled_parity",
                                       "megabatch_dispatches_current",
                                       "megabatch_dispatches_projected",
                                       "megabatch_savings_pct",
                                       "megabatch_worst_bucket",
                                       # the tenant attribution plane
                                       # (r18, config 18): hot-tenant
                                       # shares, quiet-tenant p99
                                       # degradation, attribution sum,
                                       # ledger duty cycle, disabled-
                                       # path parity
                                       "hot_tenant",
                                       "hot_ingress_share_pct",
                                       "quiet_p99_base_s",
                                       "quiet_p99_hot_s",
                                       "quiet_p99_degradation_x",
                                       "tenant_attribution_err_pct",
                                       "tenant_ledger_overhead_pct",
                                       "tenant_disabled_parity",
                                       # the trace plane (r19, config
                                       # 19): sampled-lifecycle
                                       # completeness, stage-sum vs
                                       # docledger e2e reconciliation,
                                       # plane duty cycle, disabled-
                                       # path parity, critical path
                                       "trace_sampled",
                                       "trace_completed",
                                       "trace_stitched",
                                       "trace_completeness_pct",
                                       "trace_stage_sum_err_pct",
                                       "trace_ledger_overhead_pct",
                                       "trace_disabled_parity",
                                       "trace_crit_p50_s",
                                       "trace_crit_p99_s",
                                       # the megabatch plane (r20,
                                       # config 20): fused-vs-per-doc
                                       # round throughput, flush
                                       # percentiles, achieved
                                       # amplification + occupancy,
                                       # both parity verdicts
                                       "megabatch_speedup_x",
                                       "megabatch_round_p50_s",
                                       "megabatch_round_p99_s",
                                       "perdoc_round_p50_s",
                                       "perdoc_round_p99_s",
                                       "megabatch_amplification",
                                       "megabatch_rounds_fused",
                                       "megabatch_dispatches",
                                       "megabatch_docs_served",
                                       "megabatch_docs_per_dispatch",
                                       "megabatch_parity",
                                       "megabatch_disabled_parity")
                     if isinstance(v.get(k), (int, float, str))}
        elif isinstance(v, (int, float)):
            entry = {"speedup": v}
        else:
            entry = {}
        out[str(cfg)] = entry
    return out


def _headline_config(configs: dict, value) -> str | None:
    """Which config produced the record's headline `value`. A full run's
    headline is config 5; a partial run falls back to whatever config
    produced throughput (bench._final_record) — the gate must never judge
    one against the other. Matched by ops/sec when the per-config numbers
    are present, else by the headline config's presence."""
    if isinstance(value, (int, float)):
        for cfg, v in configs.items():
            if (v or {}).get("engine_ops_per_s") == value:
                return cfg
    if "5" in configs:
        return "5"
    return ",".join(sorted(configs, key=lambda c: (len(c), c))) or None


def _perf_from_configs(raw_configs) -> dict | None:
    """Aggregate per-kernel compile counts out of the per-config metrics
    snapshots a full bench record carries (`configs.<n>.metrics.perf`)."""
    kernels: dict[str, int] = {}
    if not isinstance(raw_configs, dict):
        return None
    for v in raw_configs.values():
        perf = (((v or {}).get("metrics") or {}).get("perf")
                if isinstance(v, dict) else None)
        for k, st in ((perf or {}).get("kernels") or {}).items():
            c = st.get("compiles") if isinstance(st, dict) else None
            if isinstance(c, int):
                kernels[k] = kernels.get(k, 0) + c
    if not kernels:
        return None
    return {"compiles_total": sum(kernels.values()), "kernels": kernels}


def _fleet_from_configs(raw_configs) -> dict | None:
    """The config-8 convergence-read numbers (the hash-gate inputs) out of
    a full bench record's configs section. Compact/captured records and runs
    without config 8 yield None — the gate then skips cleanly."""
    if not isinstance(raw_configs, dict):
        return None
    v = raw_configs.get("8")
    if not isinstance(v, dict):
        return None
    out = {k: v[k] for k in FLEET_KEYS
           if isinstance(v.get(k), (int, float))}
    return out or None


def record_from_bench(rec: dict, source: str = "bench.py",
                      at: float | None = None,
                      metrics_rollup: dict | None = None,
                      stamp_host: bool = True) -> dict:
    """Build one history record from a bench final record (full `rec` from
    bench._final_record, or a compact captured record).

    Host identity: the bench record's own `host` field wins (the host is a
    property of the RUN, stamped by bench.py at run time); otherwise the
    current machine is stamped only when `stamp_host` is True (a live
    append from this machine's own run). Backfills from captures that
    predate host-stamping pass stamp_host=False — inventing a host for a
    record of unknown provenance would put it in the wrong comparison
    pool."""
    configs = _norm_configs(rec.get("configs"))
    out = {
        "schema": SCHEMA,
        "at": time.time() if at is None else at,
        "source": source,
        "backend": rec.get("backend") or "none",
        "headline_config": _headline_config(configs, rec.get("value")),
        "value": rec.get("value"),
        "unit": rec.get("unit", "ops/sec"),
        "vs_baseline": rec.get("vs_baseline"),
        "configs": configs,
    }
    perf = _perf_from_configs(rec.get("configs"))
    if perf:
        out["perf"] = perf
    fleet = _fleet_from_configs(rec.get("configs"))
    if fleet:
        out["fleet"] = fleet
    if metrics_rollup:
        out["metrics"] = metrics_rollup
    # Host identity (r6): raw ops/sec is meaningless across machines — a
    # 2-core container and a 32-core runner differ ~10x on the same code
    # (the per-config SPEEDUP ratios, engine vs oracle on the same host,
    # barely move). The gate compares a host-stamped record only against
    # records from the SAME host class; see check().
    rec_host = rec.get("host")
    if isinstance(rec_host, dict) and "cpus" in rec_host:
        out["host"] = {"cpus": rec_host.get("cpus"),
                       "machine": rec_host.get("machine")}
    elif stamp_host:
        out["host"] = {"cpus": os.cpu_count() or 0,
                       "machine": platform.machine()}
    return out


# ---------------------------------------------------------------------------
# backfill from the port's committed bench captures


def backfill_records(root: str | None = None) -> list[dict]:
    """History records synthesized from the port's committed
    `BENCH_TORCH_r*.json` captures, filename order (the round number is
    chronological). Captures without a parsed final record (crashed
    rounds) are skipped. None exists yet: the port's bench writes the
    first."""
    root = root or repo_root()
    out: list[dict] = []
    for path in sorted(glob.glob(os.path.join(root, CAPTURE_GLOB))):
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            continue
        parsed = data.get("parsed") if isinstance(data, dict) else None
        if not isinstance(parsed, dict):
            continue
        value = parsed.get("value")
        if not isinstance(value, (int, float)) or value <= 0:
            continue
        rec = record_from_bench(
            parsed, source=f"backfill:{os.path.basename(path)}",
            at=os.path.getmtime(path), stamp_host=False)
        out.append(rec)
    return out


def ensure_backfilled(root: str | None = None,
                      path: str | None = None) -> int:
    """Create the history file from the port's committed captures when it
    does not exist yet. Returns the number of records written (0 when the
    file already exists — backfill never rewrites history — or when there
    is no capture, in which case no file is created)."""
    root = root or repo_root()
    path = path or history_path(root)
    if os.path.exists(path):
        return 0
    records = backfill_records(root)
    if not records:
        return 0
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
    return len(records)


# ---------------------------------------------------------------------------
# the regression gate


def check(path: str | None = None, record: dict | None = None,
          window: int = DEFAULT_WINDOW,
          threshold_pct: float = DEFAULT_THRESHOLD_PCT,
          compile_growth_pct: float = DEFAULT_COMPILE_GROWTH_PCT,
          hash_growth_pct: float = DEFAULT_HASH_GROWTH_PCT,
          ) -> tuple[int, list[str]]:
    """Compare the current run against the rolling same-backend median.

    `record=None` judges the LAST history record against the ones before
    it; an explicit `record` (e.g. a freshly parsed bench line not yet
    appended) is judged against the whole file. Returns (exit_code,
    report_lines): 0 = ok or gracefully skipped (no comparable history),
    1 = throughput regression, compile-count growth, or convergence-read
    (fleet_hashes_s) cost growth.
    """
    lines: list[str] = []
    records = load(path)
    if record is None:
        if not records:
            return 0, ["perf check: SKIP (empty history — run bench.py "
                       "or backfill first)"]
        current, prior_pool = records[-1], records[:-1]
    else:
        current, prior_pool = record, records

    backend = current.get("backend") or "none"
    headline = current.get("headline_config")
    value = current.get("value")
    # Host-scoping (r6): a host-stamped record compares only against
    # records stamped with the SAME host class — raw throughput across
    # machines differs ~10x on identical code, so a cross-host compare is
    # either blind or permanently red (same reasoning as the backend
    # rule). Un-stamped records (pre-r6 backfills) are excluded from a
    # stamped record's pool; a record with no stamp keeps the old
    # behavior.
    cur_host = current.get("host")

    def _host_ok(r: dict) -> bool:
        return cur_host is None or r.get("host") == cur_host

    prior = [r for r in prior_pool
             if (r.get("backend") or "none") == backend
             and r.get("headline_config") == headline
             and _host_ok(r)
             and isinstance(r.get("value"), (int, float))
             and r["value"] > 0][-window:]
    host_note = "" if cur_host is None else \
        f" host={cur_host.get('machine')}/{cur_host.get('cpus')}cpu"
    lines.append(f"perf check: current={current.get('source', '?')} "
                 f"backend={backend} headline_config={headline} "
                 f"value={value}{host_note} (history: {len(prior)} "
                 f"comparable of {len(prior_pool)} prior)")
    rc = 0
    # Throughput + compile gates: skipped (never failed) without a
    # headline value or comparable history. These skips must NOT return
    # early — the convergence-read gate below has its own comparison pool
    # (config 8 carries its own numbers; the headline-config restriction
    # does not apply to it) and must still run.
    if not isinstance(value, (int, float)) or value <= 0:
        lines.append("perf check: SKIP throughput (current run has no "
                     "headline throughput — partial/errored bench)")
    elif not prior:
        lines.append(f"perf check: SKIP throughput (no prior {backend} "
                     f"history with headline config {headline!r} to "
                     f"compare against)")
    else:
        med = statistics.median(r["value"] for r in prior)
        ratio = value / med
        floor = 1.0 - threshold_pct / 100.0
        verdict = "OK" if ratio >= floor else "REGRESSION"
        lines.append(f"  throughput: {value:.0f} vs rolling median "
                     f"{med:.0f} (x{ratio:.2f}, floor x{floor:.2f}) "
                     f"-> {verdict}")
        if ratio < floor:
            rc = 1

        # per-config detail (informational: config mix varies per round)
        cur_cfgs = current.get("configs") or {}
        for cfg in sorted(cur_cfgs, key=lambda c: (len(c), c)):
            cv = (cur_cfgs[cfg] or {}).get("engine_ops_per_s")
            pv = [((r.get("configs") or {}).get(cfg) or {})
                  .get("engine_ops_per_s") for r in prior]
            pv = [x for x in pv if isinstance(x, (int, float)) and x > 0]
            if isinstance(cv, (int, float)) and cv > 0 and pv:
                m = statistics.median(pv)
                flag = "" if cv / m >= floor else "  <-- below floor"
                lines.append(f"  config {cfg}: {cv:.0f} vs median {m:.0f} "
                             f"(x{cv / m:.2f}){flag}")

        cur_c = (current.get("perf") or {}).get("compiles_total")
        prior_c = [(r.get("perf") or {}).get("compiles_total")
                   for r in prior]
        prior_c = [c for c in prior_c if isinstance(c, int)]
        if isinstance(cur_c, int) and prior_c:
            med_c = statistics.median(prior_c)
            allowed = med_c * (1.0 + compile_growth_pct / 100.0) + 2
            verdict = "OK" if cur_c <= allowed else "COMPILE GROWTH"
            lines.append(f"  compiles: {cur_c} vs rolling median "
                         f"{med_c:.0f} (allowed <= {allowed:.0f}) "
                         f"-> {verdict}")
            if cur_c > allowed:
                rc = 1
        elif isinstance(cur_c, int):
            lines.append(f"  compiles: {cur_c} (no prior compile "
                         "telemetry — comparison starts next run)")

    # convergence-read gate (r6): the clean-fleet hashes() read must stay
    # O(dirty) — a regression back to O(fleet) is the r5 stall class.
    # Same skip-clean semantics as the throughput gate: only same-backend
    # same-host records carrying the fleet section are compared (filter
    # FIRST, then window — fleet-less runs in between must not consume
    # window slots and blind the gate).
    cur_h = (current.get("fleet") or {}).get("fleet_hashes_s")
    prior_h = [(r.get("fleet") or {}).get("fleet_hashes_s")
               for r in prior_pool
               if (r.get("backend") or "none") == backend
               and _host_ok(r)]
    prior_h = [h for h in prior_h
               if isinstance(h, (int, float)) and h > 0][-window:]
    if isinstance(cur_h, (int, float)) and prior_h:
        med_h = statistics.median(prior_h)
        allowed_h = med_h * (1.0 + hash_growth_pct / 100.0) \
            + HASH_ABS_SLACK_S
        verdict = "OK" if cur_h <= allowed_h else "HASH-READ GROWTH"
        lines.append(
            f"  fleet_hashes_s: {cur_h:.4f} vs rolling median "
            f"{med_h:.4f} (allowed <= {allowed_h:.4f}) -> {verdict}")
        if cur_h > allowed_h:
            rc = 1
    elif isinstance(cur_h, (int, float)):
        lines.append(f"  fleet_hashes_s: {cur_h:.4f} (no prior "
                     "convergence-read telemetry — comparison starts "
                     "next run)")

    # multi-writer admission gate (r8): config 9's N=4 epoch-mode
    # admission throughput must hold against the same-backend same-host
    # rolling median (raw ops/sec — host-class scoping applies exactly
    # as for the headline gate), with the scaling ratio reported
    # alongside. Skip-clean: runs without config 9, or with no
    # comparable history, never fail.
    def _mw(r: dict):
        return ((r.get("configs") or {}).get("9") or {})

    cur_mw = _mw(current).get("admission_ops_per_s")
    prior_mw = [_mw(r).get("admission_ops_per_s")
                for r in prior_pool
                if (r.get("backend") or "none") == backend
                and _host_ok(r)]
    prior_mw = [x for x in prior_mw
                if isinstance(x, (int, float)) and x > 0][-window:]
    if isinstance(cur_mw, (int, float)) and cur_mw > 0 and prior_mw:
        med_mw = statistics.median(prior_mw)
        floor = 1.0 - threshold_pct / 100.0
        ratio = cur_mw / med_mw
        verdict = "OK" if ratio >= floor else "ADMISSION REGRESSION"
        lines.append(
            f"  multiwriter admission (config 9, N=4): {cur_mw:.0f} "
            f"ops/s vs rolling median {med_mw:.0f} (x{ratio:.2f}, "
            f"floor x{floor:.2f}) -> {verdict}")
        if ratio < floor:
            rc = 1
    elif isinstance(cur_mw, (int, float)) and cur_mw > 0:
        lines.append(f"  multiwriter admission (config 9, N=4): "
                     f"{cur_mw:.0f} ops/s (no prior multi-writer "
                     "telemetry — comparison starts next run)")
    scal = _mw(current).get("admission_scaling_4x")
    if isinstance(scal, (int, float)):
        def _x(key):
            v = _mw(current).get(key)
            return f"x{v}" if isinstance(v, (int, float)) else "n/a"
        lines.append(f"  multiwriter scaling (N=4 vs N=1): x{scal:.2f} "
                     "(vs r6 single-writer baseline: "
                     f"{_x('admission_vs_r6_single_writer_x')}"
                     "); service-lock wait locked/epoch: "
                     f"{_x('service_lock_wait_reduction_x')}")

    # bulk text-merge gate (r8, config 10): the span-plane merge
    # throughput must hold against the same-backend same-host rolling
    # median (raw ops/sec — host-class scoping applies exactly as for
    # the headline gate). Skip-clean: runs without config 10, or with no
    # comparable history, never fail.
    def _tm(r: dict):
        return ((r.get("configs") or {}).get("10") or {})

    cur_tm = _tm(current).get("merge_ops_per_s")
    prior_tm = [_tm(r).get("merge_ops_per_s")
                for r in prior_pool
                if (r.get("backend") or "none") == backend
                and _host_ok(r)]
    prior_tm = [x for x in prior_tm
                if isinstance(x, (int, float)) and x > 0][-window:]
    if isinstance(cur_tm, (int, float)) and cur_tm > 0 and prior_tm:
        med_tm = statistics.median(prior_tm)
        floor = 1.0 - threshold_pct / 100.0
        ratio = cur_tm / med_tm
        verdict = "OK" if ratio >= floor else "MERGE REGRESSION"
        lines.append(
            f"  text bulk merge (config 10): {cur_tm:.0f} ops/s vs "
            f"rolling median {med_tm:.0f} (x{ratio:.2f}, floor "
            f"x{floor:.2f}) -> {verdict}")
        if ratio < floor:
            rc = 1
    elif isinstance(cur_tm, (int, float)) and cur_tm > 0:
        lines.append(f"  text bulk merge (config 10): {cur_tm:.0f} ops/s "
                     "(no prior merge telemetry — comparison starts "
                     "next run)")
    tm_spd = _tm(current).get("merge_speedup_vs_perop")
    if isinstance(tm_spd, (int, float)):
        lines.append(f"  merge span-plane vs per-op: x{tm_spd:.2f} "
                     "(vs full replay: "
                     f"x{_tm(current).get('merge_speedup_vs_replay', 0)})")

    # fleet-health collector gate (r9, config 11): the collector's own
    # scrape tick p50 must stay under the ABSOLUTE budget (SCRAPE_BUDGET_S
    # — absolute because scrape cost is a property of the collector code,
    # not the workload). Skip-clean: runs without config 11 never fail.
    def _fh(r: dict):
        return ((r.get("configs") or {}).get("11") or {})

    cur_sp = _fh(current).get("scrape_p50_s")
    if isinstance(cur_sp, (int, float)):
        verdict = "OK" if cur_sp <= SCRAPE_BUDGET_S else "SCRAPE OVER BUDGET"
        lines.append(
            f"  fleet-health scrape p50 (config 11): {cur_sp:.4f}s "
            f"(budget <= {SCRAPE_BUDGET_S}s) -> {verdict}")
        if cur_sp > SCRAPE_BUDGET_S:
            rc = 1
        att = _fh(current).get("faults_attributed")
        ovh = _fh(current).get("collector_overhead_pct")
        if att is not None or ovh is not None:
            lines.append(
                f"  fleet-health: {att if att is not None else '?'}/3 "
                "fault classes attributed; collector duty-cycle bound "
                f"{ovh if ovh is not None else '?'}%")

    # per-doc ledger gate (r11, config 12): the convergence ledger's own
    # duty cycle must stay under the ABSOLUTE budget (LEDGER_BUDGET_PCT
    # — a property of the ledger code, like the scrape budget).
    # Skip-clean: runs without config 12 never fail. The redundancy
    # ratio and explain attribution are reported alongside — the ratio
    # is the full-mesh baseline partial replication will improve, so it
    # is informational here, asserted against its analytic floor inside
    # the bench config itself.
    def _dl(r: dict):
        return ((r.get("configs") or {}).get("12") or {})

    cur_lp = _dl(current).get("ledger_overhead_pct")
    if isinstance(cur_lp, (int, float)):
        verdict = ("OK" if cur_lp <= LEDGER_BUDGET_PCT
                   else "LEDGER OVER BUDGET")
        lines.append(
            f"  doc-ledger duty cycle (config 12): {cur_lp:.3f}% "
            f"(budget <= {LEDGER_BUDGET_PCT}%) -> {verdict}")
        if cur_lp > LEDGER_BUDGET_PCT:
            rc = 1
        red = _dl(current).get("redundancy_ratio")
        fl = _dl(current).get("redundancy_floor")
        att = _dl(current).get("explain_attributed")
        extra = []
        if isinstance(red, (int, float)):
            extra.append(f"mesh redundancy x{red}"
                         + (f" (analytic floor {fl})"
                            if isinstance(fl, (int, float)) else ""))
        p99 = _dl(current).get("doc_lag_p99_s")
        if isinstance(p99, (int, float)):
            extra.append(f"doc-lag p99 {p99}s")
        if att is not None:
            extra.append("explain attribution "
                         + ("OK" if att else "MISS"))
        if extra:
            lines.append("  doc-ledger: " + "; ".join(extra))

    # partial-replication gates (r12, config 13): fan-out sublinearity,
    # bytes/subscriber ceiling vs the flat baseline, relay redundancy,
    # and subscribed-doc converge-p99 — all absolute (properties of the
    # subscription/relay code). Skip-clean: runs without config 13
    # never fail. Ratios/exponents are host-normalized, so no host
    # scoping applies.
    def _pr(r: dict):
        return ((r.get("configs") or {}).get("13") or {})

    # each gate checks its own field independently — a record missing
    # one field (renamed, dropped by a future writer) must not silently
    # vacate the OTHER four gates
    cur_exp = _pr(current).get("fanout_growth_exponent")
    if isinstance(cur_exp, (int, float)):
        verdict = ("OK" if cur_exp < SUB_GROWTH_EXP_MAX
                   else "FAN-OUT NOT SUBLINEAR")
        lines.append(
            f"  relay fan-out growth (config 13, N=8..128): exponent "
            f"{cur_exp:.3f} (must be < {SUB_GROWTH_EXP_MAX}) "
            f"-> {verdict}")
        if cur_exp >= SUB_GROWTH_EXP_MAX:
            rc = 1
    frac = _pr(current).get("fanout_vs_mesh_fraction")
    if isinstance(frac, (int, float)):
        verdict = ("OK" if frac <= SUB_FANOUT_MESH_FRACTION_MAX
                   else "FAN-OUT OVER MESH CEILING")
        lines.append(
            f"  relay bytes/subscriber vs flat baseline: x{frac:.4f}"
            f" (ceiling x{SUB_FANOUT_MESH_FRACTION_MAX}) "
            f"-> {verdict}")
        if frac > SUB_FANOUT_MESH_FRACTION_MAX:
            rc = 1
    red = _pr(current).get("sub_redundancy_ratio")
    if isinstance(red, (int, float)):
        verdict = ("OK" if red <= SUB_REDUNDANCY_MAX
                   else "RELAY REDUNDANCY OVER BUDGET")
        lines.append(
            f"  relay redundancy ratio: x{red} (budget <= "
            f"{SUB_REDUNDANCY_MAX}; full-mesh baseline 1.85) "
            f"-> {verdict}")
        if red > SUB_REDUNDANCY_MAX:
            rc = 1
    p99 = _pr(current).get("sub_converge_p99_s")
    if isinstance(p99, (int, float)):
        verdict = ("OK" if p99 <= SUB_CONVERGE_P99_BUDGET_S
                   else "SUBSCRIBED-DOC SLO BREACH")
        lines.append(
            f"  subscribed-doc converge p99: {p99}s (SLO <= "
            f"{SUB_CONVERGE_P99_BUDGET_S}s) -> {verdict}")
        if p99 > SUB_CONVERGE_P99_BUDGET_S:
            rc = 1
    bf = _pr(current).get("sub_backfill_ok")
    if bf is not None:
        lines.append("  late-subscribe backfill: "
                     + ("OK (auditor green, unsubscribed lanes "
                        "silent)" if bf else "MISS"))
        if not bf:
            rc = 1

    # remediation gates (r13, config 14): chaos-to-green MTTR bound,
    # recovered-class floor, dry-run cleanliness, and the engine's
    # steady-state duty cycle — all absolute (properties of the
    # remediation code). Skip-clean: runs without config 14 never
    # fail; each gate judges its own field independently.
    def _rm(r: dict):
        return ((r.get("configs") or {}).get("14") or {})

    mttr = _rm(current).get("mttr_max_s")
    if isinstance(mttr, (int, float)):
        verdict = ("OK" if mttr <= REMED_MTTR_BUDGET_S
                   else "MTTR OVER BUDGET")
        lines.append(
            f"  remediation MTTR (config 14, worst class): {mttr}s "
            f"(budget <= {REMED_MTTR_BUDGET_S}s) -> {verdict}")
        if mttr > REMED_MTTR_BUDGET_S:
            rc = 1
    rec_n = _rm(current).get("fault_classes_recovered")
    if isinstance(rec_n, (int, float)):
        inj_n = _rm(current).get("fault_classes_injected")
        verdict = ("OK" if rec_n >= REMED_MIN_CLASSES
                   else "TOO FEW CLASSES RECOVERED")
        lines.append(
            f"  remediation classes recovered: {int(rec_n)}"
            + (f"/{int(inj_n)} injected"
               if isinstance(inj_n, (int, float)) else "")
            + f" (floor >= {REMED_MIN_CLASSES}) -> {verdict}")
        if rec_n < REMED_MIN_CLASSES:
            rc = 1
    ovh = _rm(current).get("remed_overhead_pct")
    if isinstance(ovh, (int, float)):
        verdict = ("OK" if ovh < REMED_BUDGET_PCT
                   else "REMEDIATION OVER BUDGET")
        lines.append(
            f"  remediation duty cycle: {ovh}% (budget < "
            f"{REMED_BUDGET_PCT}%) -> {verdict}")
        if ovh >= REMED_BUDGET_PCT:
            rc = 1
    dr = _rm(current).get("remed_dry_run_clean")
    if dr is not None:
        lines.append("  remediation dry-run: "
                     + ("OK (intentions logged, nothing executed)"
                        if dr else "EXECUTED SOMETHING"))
        if not dr:
            rc = 1

    # replica-bootstrap gates (r15, config 15): snapshot+tail speedup
    # floor, image-vs-log size direction, and the in-run byte-equal
    # parity verdict — all absolute (properties of the storage tier).
    # Skip-clean: runs without config 15 never fail; each gate judges
    # its own field independently.
    def _bs(r: dict):
        return ((r.get("configs") or {}).get("15") or {})

    spd = _bs(current).get("bootstrap_speedup_x")
    if isinstance(spd, (int, float)):
        verdict = ("OK" if spd >= BOOTSTRAP_SPEEDUP_MIN
                   else "BOOTSTRAP TOO SLOW")
        lines.append(
            f"  replica bootstrap (config 15): snapshot+tail x{spd:.2f} "
            f"faster than full replay (floor >= "
            f"x{BOOTSTRAP_SPEEDUP_MIN}) -> {verdict}")
        if spd < BOOTSTRAP_SPEEDUP_MIN:
            rc = 1
    ratio = _bs(current).get("snapshot_log_ratio")
    if isinstance(ratio, (int, float)):
        verdict = ("OK" if ratio < SNAPSHOT_LOG_RATIO_MAX
                   else "SNAPSHOT NOT SMALLER THAN LOG")
        lines.append(
            f"  snapshot/log bytes: x{ratio:.4f} (must be < "
            f"{SNAPSHOT_LOG_RATIO_MAX}) -> {verdict}")
        if ratio >= SNAPSHOT_LOG_RATIO_MAX:
            rc = 1
    par = _bs(current).get("bootstrap_hash_parity")
    if par is not None:
        lines.append("  bootstrap hash parity: "
                     + ("OK (byte-equal, asserted in-run)"
                        if par else "DIVERGED"))
        if not par:
            rc = 1

    # move-plane gates (r16, config 16): atom-vs-emulation byte ratios,
    # batched-resolution direction, and the in-run parity/convergence
    # verdicts. All absolute; skip-clean without config 16; each field
    # judged independently.
    def _mv(r: dict):
        return ((r.get("configs") or {}).get("16") or {})

    for field, label in (("move_wire_ratio_x", "wire-frame"),
                         ("move_archive_ratio_x", "archived-log")):
        val = _mv(current).get(field)
        if isinstance(val, (int, float)):
            verdict = ("OK" if val >= MOVE_BYTES_RATIO_MIN
                       else "MOVE NOT BEATING DELETE+REINSERT")
            lines.append(
                f"  move-as-atom {label} bytes (config 16): x{val:.2f} "
                f"of the delete+reinsert emulation (floor >= "
                f"x{MOVE_BYTES_RATIO_MIN}) -> {verdict}")
            if val < MOVE_BYTES_RATIO_MIN:
                rc = 1
    spd = _mv(current).get("move_resolve_speedup_x")
    if isinstance(spd, (int, float)):
        verdict = ("OK" if spd > MOVE_RESOLVE_SPEEDUP_MIN
                   else "BATCHED RESOLUTION NOT FASTER")
        moves_n = _mv(current).get("move_storm_moves")
        lines.append(
            f"  batched move resolution (config 16): x{spd:.1f} vs the "
            f"per-op host walk on {moves_n} concurrent moves -> {verdict}")
        if spd <= MOVE_RESOLVE_SPEEDUP_MIN:
            rc = 1
    for field, label in (("move_kernel_parity", "host/XLA parity"),
                         ("move_pallas_parity", "pallas parity"),
                         ("move_storm_converged",
                          "two-replica storm convergence")):
        val = _mv(current).get(field)
        if val is not None:
            lines.append(f"  move {label}: "
                         + ("OK (asserted in-run)" if val else "FAILED"))
            if not val:
                rc = 1

    # dispatch-ledger gates (r17, config 17): the dispatch-efficiency
    # ledger's own duty cycle must stay under the ABSOLUTE budget
    # (DISPATCH_LEDGER_BUDGET_PCT — a property of the ledger code, like
    # the doc ledger's bound), and the disabled path must have proved
    # behavior parity in-run. Amplification / padding waste / megabatch
    # projection are reported alongside — they are the BASELINE numbers
    # fleet megabatching (ROADMAP #2) exists to shrink, so they inform
    # rather than gate. Skip-clean: runs without config 17 never fail.
    def _dd(r: dict):
        return ((r.get("configs") or {}).get("17") or {})

    cur_dp = _dd(current).get("dispatch_ledger_overhead_pct")
    if isinstance(cur_dp, (int, float)):
        verdict = ("OK" if cur_dp <= DISPATCH_LEDGER_BUDGET_PCT
                   else "DISPATCH LEDGER OVER BUDGET")
        lines.append(
            f"  dispatch-ledger duty cycle (config 17): {cur_dp:.3f}% "
            f"(budget <= {DISPATCH_LEDGER_BUDGET_PCT}%) -> {verdict}")
        if cur_dp > DISPATCH_LEDGER_BUDGET_PCT:
            rc = 1
    dpar = _dd(current).get("dispatch_disabled_parity")
    if dpar is not None:
        lines.append("  dispatch-ledger disabled-path parity: "
                     + ("OK (byte-equal hashes, zero rounds recorded)"
                        if dpar else "DIVERGED"))
        if not dpar:
            rc = 1
    amp = _dd(current).get("dispatch_amplification")
    if isinstance(amp, (int, float)):
        extra = [f"amplification x{amp}"]
        pw = _dd(current).get("dispatch_pad_waste_pct")
        if isinstance(pw, (int, float)):
            extra.append(f"pad waste {pw}%")
        mbc = _dd(current).get("megabatch_dispatches_current")
        mbp = _dd(current).get("megabatch_dispatches_projected")
        if isinstance(mbc, (int, float)) and isinstance(mbp, (int, float)):
            extra.append(f"megabatch projection {int(mbc)} -> {int(mbp)} "
                         "dispatches")
        lines.append("  dispatch baseline (ROADMAP #2 divides these): "
                     + "; ".join(extra))

    # tenant-plane gates (r18, config 18): the tenant ledger's own duty
    # cycle must stay under its ABSOLUTE budget (TENANT_LEDGER_BUDGET_PCT
    # — a property of the hook code, like the doc/dispatch ledgers'
    # bounds), the per-tenant shares must sum back to the fleet totals
    # within TENANT_ATTRIBUTION_ERR_MAX_PCT, and the disabled path must
    # have proved behavior parity in-run. The quiet-tenant p99
    # degradation is reported alongside — it is the BASELINE isolation
    # number ROADMAP #5's per-tenant work exists to shrink, so it
    # informs rather than gates. Skip-clean: runs without config 18
    # never fail.
    def _tn(r: dict):
        return ((r.get("configs") or {}).get("18") or {})

    cur_tp = _tn(current).get("tenant_ledger_overhead_pct")
    if isinstance(cur_tp, (int, float)):
        verdict = ("OK" if cur_tp <= TENANT_LEDGER_BUDGET_PCT
                   else "TENANT LEDGER OVER BUDGET")
        lines.append(
            f"  tenant-ledger duty cycle (config 18): {cur_tp:.3f}% "
            f"(budget <= {TENANT_LEDGER_BUDGET_PCT}%) -> {verdict}")
        if cur_tp > TENANT_LEDGER_BUDGET_PCT:
            rc = 1
    terr = _tn(current).get("tenant_attribution_err_pct")
    if isinstance(terr, (int, float)):
        verdict = ("OK" if terr <= TENANT_ATTRIBUTION_ERR_MAX_PCT
                   else "ATTRIBUTION DOES NOT SUM TO FLEET TOTALS")
        lines.append(
            f"  tenant attribution error (config 18): {terr:.3f}% "
            f"(bound <= {TENANT_ATTRIBUTION_ERR_MAX_PCT}%) -> {verdict}")
        if terr > TENANT_ATTRIBUTION_ERR_MAX_PCT:
            rc = 1
    tpar = _tn(current).get("tenant_disabled_parity")
    if tpar is not None:
        lines.append("  tenant-ledger disabled-path parity: "
                     + ("OK (byte-equal hashes, zero tenants recorded)"
                        if tpar else "DIVERGED"))
        if not tpar:
            rc = 1
    qd = _tn(current).get("quiet_p99_degradation_x")
    if isinstance(qd, (int, float)):
        hot_t = _tn(current).get("hot_tenant")
        hot_sh = _tn(current).get("hot_ingress_share_pct")
        extra = [f"quiet-tenant p99 degradation x{qd}"]
        if isinstance(hot_sh, (int, float)):
            extra.append(f"hot tenant '{hot_t}' at "
                         f"{hot_sh:.1f}% ingress share")
        lines.append("  tenant isolation baseline (ROADMAP #5 shrinks "
                     "this): " + "; ".join(extra))

    # trace-plane gates (r19, config 19): the plane's own duty cycle
    # must stay under its ABSOLUTE budget (TRACE_LEDGER_BUDGET_PCT — a
    # property of the hook code, like every other ledger's bound),
    # sampled traces must complete end to end at >=
    # TRACE_COMPLETENESS_MIN_PCT, the per-stage sums must reconcile
    # with the doc ledger's independently measured e2e lag within
    # TRACE_STAGE_SUM_ERR_MAX_PCT, and the unset path must have proved
    # byte-identical behavior in-run. The critical-path percentiles are
    # reported alongside — they are the BASELINE decomposition fleet
    # megabatching (ROADMAP #2) exists to shift, so they inform rather
    # than gate. Skip-clean: runs without config 19 never fail.
    def _tr(r: dict):
        return ((r.get("configs") or {}).get("19") or {})

    cur_trp = _tr(current).get("trace_ledger_overhead_pct")
    if isinstance(cur_trp, (int, float)):
        verdict = ("OK" if cur_trp <= TRACE_LEDGER_BUDGET_PCT
                   else "TRACE PLANE OVER BUDGET")
        lines.append(
            f"  trace-plane duty cycle (config 19): {cur_trp:.3f}% "
            f"(budget <= {TRACE_LEDGER_BUDGET_PCT}%) -> {verdict}")
        if cur_trp > TRACE_LEDGER_BUDGET_PCT:
            rc = 1
    comp = _tr(current).get("trace_completeness_pct")
    if isinstance(comp, (int, float)):
        verdict = ("OK" if comp >= TRACE_COMPLETENESS_MIN_PCT
                   else "SAMPLED TRACES LOST MID-LIFECYCLE")
        lines.append(
            f"  trace completeness (config 19): {comp:.2f}% "
            f"(floor >= {TRACE_COMPLETENESS_MIN_PCT}%) -> {verdict}")
        if comp < TRACE_COMPLETENESS_MIN_PCT:
            rc = 1
    serr = _tr(current).get("trace_stage_sum_err_pct")
    if isinstance(serr, (int, float)):
        verdict = ("OK" if serr <= TRACE_STAGE_SUM_ERR_MAX_PCT
                   else "STAGES DO NOT RECONCILE WITH E2E LAG")
        lines.append(
            f"  trace stage-sum vs e2e lag (config 19): {serr:.2f}% "
            f"(bound <= {TRACE_STAGE_SUM_ERR_MAX_PCT}%) -> {verdict}")
        if serr > TRACE_STAGE_SUM_ERR_MAX_PCT:
            rc = 1
    trpar = _tr(current).get("trace_disabled_parity")
    if trpar is not None:
        lines.append("  trace-plane unset-path parity: "
                     + ("OK (byte-equal hashes, zero traces recorded)"
                        if trpar else "DIVERGED"))
        if not trpar:
            rc = 1
    tcp99 = _tr(current).get("trace_crit_p99_s")
    if isinstance(tcp99, (int, float)):
        extra = [f"critical path p99 {tcp99:.4f}s"]
        tcp50 = _tr(current).get("trace_crit_p50_s")
        if isinstance(tcp50, (int, float)):
            extra.insert(0, f"p50 {tcp50:.4f}s")
        tst = _tr(current).get("trace_stitched")
        if isinstance(tst, (int, float)):
            extra.append(f"{int(tst)} stitched across the wire")
        lines.append("  trace critical-path baseline (ROADMAP #2 "
                     "shifts this): " + "; ".join(extra))

    # megabatch-plane gates (r20, config 20): the fused round path must
    # beat the per-doc reference by >= MEGABATCH_SPEEDUP_MIN on the
    # identical storm, fused amplification must stay strictly below the
    # r17 per-doc baseline (MEGABATCH_AMP_MAX), and BOTH parity
    # verdicts (fused vs per-doc hashes; AMTPU_MEGABATCH=0 recording
    # zero fused rounds) must have held in-run. Skip-clean: runs
    # without config 20 never fail.
    def _mb(r: dict):
        return ((r.get("configs") or {}).get("20") or {})

    mb_x = _mb(current).get("megabatch_speedup_x")
    if isinstance(mb_x, (int, float)):
        verdict = ("OK" if mb_x >= MEGABATCH_SPEEDUP_MIN
                   else "FUSED ROUNDS TOO SLOW")
        lines.append(
            f"  megabatch round throughput (config 20): x{mb_x:.2f} "
            f"vs per-doc (floor >= x{MEGABATCH_SPEEDUP_MIN}) "
            f"-> {verdict}")
        if mb_x < MEGABATCH_SPEEDUP_MIN:
            rc = 1
    mb_amp = _mb(current).get("megabatch_amplification")
    if isinstance(mb_amp, (int, float)):
        verdict = ("OK" if mb_amp < MEGABATCH_AMP_MAX
                   else "AMPLIFICATION NOT DIVIDED")
        lines.append(
            f"  megabatch amplification (config 20): {mb_amp:.5f} "
            f"dispatches/doc (strictly < {MEGABATCH_AMP_MAX} — the "
            f"r17 per-doc baseline) -> {verdict}")
        if mb_amp >= MEGABATCH_AMP_MAX:
            rc = 1
    for key, label in (("megabatch_parity", "fused-vs-per-doc"),
                       ("megabatch_disabled_parity",
                        "AMTPU_MEGABATCH=0")):
        v = _mb(current).get(key)
        if v is not None:
            lines.append(f"  megabatch {label} parity: "
                         + ("OK (byte-equal hashes)" if v
                            else "DIVERGED"))
            if not v:
                rc = 1
    mb_p99 = _mb(current).get("megabatch_round_p99_s")
    if isinstance(mb_p99, (int, float)):
        extra = [f"fused round p99 {mb_p99:.4f}s"]
        pd_p99 = _mb(current).get("perdoc_round_p99_s")
        if isinstance(pd_p99, (int, float)):
            extra.append(f"per-doc p99 {pd_p99:.4f}s")
        dpd = _mb(current).get("megabatch_docs_per_dispatch")
        if isinstance(dpd, (int, float)):
            extra.append(f"{dpd:.0f} docs/dispatch achieved")
        lines.append("  megabatch occupancy baseline: "
                     + "; ".join(extra))

    # keystroke-flatness gate (r8, config 7): latency at 4x document
    # length over 1x must stay under the ceiling. A RATIO is
    # host-normalized, so no host scoping applies; the ceiling is looser
    # than the 1.25 acceptance bar to absorb single-slice jitter.
    flat = (((current.get("configs") or {}).get("7") or {})
            .get("keystroke_flatness"))
    if isinstance(flat, (int, float)):
        verdict = ("OK" if flat <= DEFAULT_FLATNESS_MAX
                   else "FLATNESS REGRESSION")
        lines.append(
            f"  keystroke flatness (config 7, 4x/1x): x{flat:.3f} "
            f"(ceiling x{DEFAULT_FLATNESS_MAX}) -> {verdict}")
        if flat > DEFAULT_FLATNESS_MAX:
            rc = 1
    return rc, lines
