"""Observability for the port: labeled metrics, structured span tracing,
trace-context propagation and the stall watchdog (the port of
`automerge_tpu/utils/metrics.py`, with the reference's semantics,
registries and snapshot keys).

- **labeled counters / gauges / histograms** (`bump`, `gauge`, `observe`,
  `add_time`) with bounded-cardinality label values, in one thread-safe,
  process-global store;
- a **span tracer** (`trace`): nested spans per thread, a ring buffer of
  recently completed spans (`recent_spans`), the active stacks
  (`span_stacks`). Each span is also a `torch.profiler.record_function`
  range while a `torch.profiler` session is recording, so the span's
  device work shows under its name in the trace;
- **cross-replica trace context**: `current_context`, `adopt_context`
  and `merge_timeline` (sync/connection.py stamps the context onto
  outgoing protocol messages);
- a **stall watchdog** (`watchdog(name, budget_s)`): one shared checker
  thread, named `amtpu-torch-watchdog`, logs every thread's active span
  stack and the lock holders when a watched region overruns its budget,
  and dumps the flight recorder;
- **exporters**: `snapshot()` (flat, `json.dumps`-safe, plus the nested
  `perf`, `oplag` and registered sections) and `prometheus()`;
- **dispatch accounting** (`dispatch_jit`): every device program call of
  both engines goes through it, counted per kernel label, with the
  kernel builds it triggered counted as retraces (utils/perfscope.py).
"""

from __future__ import annotations

import binascii
import logging
import os
import re
import threading
import time
from collections import deque
from contextlib import contextmanager

log = logging.getLogger("automerge_tpu_torch.metrics")

# How many completed spans the ring buffer retains. Small enough to never
# matter for memory, large enough to cover a whole sync round's nesting on
# a sharded fleet node.
SPAN_RING = 512

# ---------------------------------------------------------------------------
# metric name registries (the naming contract; see module docstring)

COUNTERS: dict[str, str] = {
    # core — host interpretive / bulk apply
    "core_changes_applied": "changes admitted by the host apply paths",
    "core_ops_applied": "ops inside admitted changes (host apply paths)",
    "core_diffs_emitted": "diff records produced by the interpretive apply",
    "core_bulk_fallbacks": "bulk builds that fell back to interpretive",
    # text span plane (core/textspans.py + engine/span_kernels.py):
    # batched text merging — span splices instead of per-op RGA inserts
    "sync_text_batches_merged":
        "change batches admitted through the span-granularity text plane "
        "(core/textspans.py)",
    "sync_text_spans_spliced":
        "contiguous element runs spliced into the visible-order index "
        "(one splice per run, not per op)",
    "sync_text_ops_sequential":
        "text ops from changes covering the local frontier (no "
        "concurrency checks paid)",
    "sync_text_ops_concurrent":
        "text ops replayed with per-pair concurrency checks (the only "
        "ops whose cost scales with divergence)",
    "engine_span_tables_packed":
        "span tables packed into the [ROWS, S_pad] lane layout "
        "(engine/pack.pack_spans)",
    "engine_span_merges":
        "batched span-table merge dispatches (engine/span_kernels.py) "
        "{backend=host|device}",
    # move plane (core/moves.py + engine/move_kernels.py): one-op
    # reparenting with deterministic cycle resolution
    "core_moves_applied":
        "move ops admitted through the per-op interpretive path",
    "sync_move_batches_merged":
        "change batches admitted through the batched move plane (one "
        "winner+cycle resolution per touched realm)",
    "sync_move_ops_sequential":
        "move ops from changes covering the local frontier (classified "
        "at admission via admit_change_header)",
    "sync_move_ops_concurrent":
        "move ops concurrent with the local frontier (the only moves "
        "that can conflict or cycle)",
    "sync_move_cycles_dropped":
        "move candidates dropped by deterministic cycle resolution "
        "(losers become no-ops; the element falls back to its next "
        "candidate or base position)",
    "engine_move_tables_packed":
        "move-resolution realms packed into the node/candidate lane "
        "layout (engine/pack.pack_moves)",
    "engine_move_resolves":
        "batched move cycle-resolution dispatches "
        "(engine/move_kernels.py) {backend=host|device}",
    # engine — docs-major device engine + adaptive router
    "engine_docs_reconciled": "documents reconciled by the batched kernel",
    "engine_ops_reconciled": "ops reconciled by the batched kernel",
    "engine_bulk_built": "host-path documents built by the bulk loader",
    "engine_kernels_dispatched": "device program dispatches {kernel=...}",
    "engine_kernels_retraced":
        "dispatches that had to build a kernel library first (nvcc or "
        "g++) {kernel=...}",
    # dispatch-efficiency ledger (engine/dispatchledger.py — r17)
    "engine_dispatch_calls":
        "routed kernel calls recorded by the dispatch-efficiency ledger "
        "{family=...,backend=host|device} (engine/dispatchledger.py)",
    "engine_dispatch_ambient":
        "jitted dispatches observed with no routed call scope open "
        "(engine/dispatchledger.note_jit; counted so nothing escapes "
        "the amplification account)",
    # megabatch plane (engine/dispatch.py plan_round — r20)
    "engine_megabatch_rounds":
        "flush rounds executed through the fused multi-doc megabatch "
        "path (engine/dispatch.py apply_round_adaptive)",
    "engine_megabatch_docs":
        "documents whose reconcile rode a fused megabatch dispatch "
        "(engine/dispatch.py; lane sharing across independent docs)",
    "engine_megabatch_fallbacks":
        "rounds the cost model routed back to the per-doc path after "
        "planning buckets (engine/dispatch.py plan_round; padded wire "
        "would have exceeded the classic gather)",
    # rows — docs-minor streaming engine
    "rows_rounds_batched": "round frames through the vectorized admission",
    "rows_rounds_fallback": "round frames through the per-round fallback",
    "rows_dispatch_failed": "device dispatches that failed (host recovered)",
    "rows_log_rebuilt": "engine rebuilds replayed from the admitted log",
    "rows_engine_poisoned": "engines poisoned by an unrecoverable failure",
    "rows_horizon_truncated": "log prefixes truncated below the horizon",
    "rows_docs_compacted": "documents compacted in place",
    # sync — services, wire protocol, transports, log archive
    "sync_frames_sent": "columnar change frames sent",
    "sync_frames_received": "columnar change frames received",
    "sync_frame_bytes_sent": "payload bytes of columnar frames sent",
    "sync_frame_bytes_received": "payload bytes of columnar frames received",
    "sync_msgs_sent": "protocol messages written to a TCP transport",
    "sync_msgs_received": "protocol messages read from a TCP transport",
    "sync_wire_bytes_sent": "framed bytes written to a TCP transport",
    "sync_wire_bytes_received": "framed bytes read from a TCP transport",
    "sync_ops_ingested": "ops admitted through service round flushes",
    "sync_rounds_flushed": "coalesced service round flushes",
    # epoch-batched ingestion (sync/epochs.py): the lock-free admission
    # path and its snapshot read plane (sync/service.py)
    "sync_ops_buffered":
        "ingress ops appended to the epoch ingestion buffer "
        "(sync/epochs.py; no service lock on this path)",
    "sync_epochs_sealed":
        "ingestion epochs sealed into coalesced rounds (sync/epochs.py)",
    "sync_reads_cached":
        "clock_of/missing_changes served lock-free from the per-doc "
        "snapshot read cache (sync/service.py)",
    "sync_archive_cold_reads": "lagging-peer reads served from the archive",
    "sync_changes_archived": "changes moved into the log archive",
    "sync_archive_tail_repaired": "torn archive tails repaired on open",
    "sync_archive_tail_skipped": "torn archive tails skipped on read",
    "sync_archive_reads_cached":
        "archive cold reads served from the parsed-prefix cache "
        "(sync/logarchive.py; active-segment entries keyed by file "
        "size+mtime)",
    # segmented archive + snapshot shipping (r15 storage tier:
    # sync/logarchive.py segments, sync/snapshots.py images,
    # sync/service.py bootstrap — docs/INTERNALS.md "The storage tier")
    "sync_segments_sealed":
        "active archive segments sealed (rotated immutable + manifest "
        "entry committed) (sync/logarchive.py)",
    "sync_segments_adopted":
        "orphan sealed segments re-adopted into a manifest after a "
        "crash between the seal rename and the manifest commit "
        "(sync/logarchive.py)",
    "sync_segment_reads_cached":
        "sealed-segment reads served from the immutable per-segment "
        "parse cache — entries never invalidate, only LRU-evict "
        "(sync/logarchive.py)",
    "sync_segments_skipped":
        "sealed segments skipped by a clock-bounded tail read — the "
        "manifest clock range proved every record covered "
        "(sync/logarchive.py read_since; the segmented bootstrap/"
        "cold-read win)",
    "sync_snapshot_writes":
        "compacted doc-state snapshot images committed "
        "(sync/snapshots.py; write-temp-then-rename)",
    "sync_snapshot_bytes_written":
        "bytes of committed snapshot images (sync/snapshots.py)",
    "sync_snapshot_loads":
        "snapshot images decoded from disk (sync/snapshots.py; "
        "cache misses — cached loads don't re-decode)",
    "sync_snapshot_frames_sent":
        "snapshot images shipped to fresh joiners over the sync wire "
        "(sync/connection.py; the empty-clock subscribe answer)",
    "sync_snapshot_bytes_sent":
        "payload bytes of snapshot images shipped (sync/connection.py)",
    "sync_snapshot_frames_received":
        "snapshot images applied from the sync wire (sync/service.py "
        "apply_snapshot)",
    "sync_snapshot_bytes_received":
        "payload bytes of snapshot images applied (sync/service.py)",
    "sync_bootstrap_docs":
        "docs snapshot-booted: compacted image admitted + covered "
        "clock seeded (engine seed_clock; local and wire bootstraps)",
    "sync_bootstrap_fallbacks":
        "bootstraps that fell back to full-history replay/serving — "
        "no usable image, non-covering tail, or a non-empty doc "
        "(sync/service.py; disclosed so a silent snapshot regression "
        "shows up in ops metrics, not just in wall time)",
    "sync_metrics_pulls": "remote metrics snapshots served to peers",
    # lockprof (utils/lockprof.py): the contention plane. The `_total`
    # suffix is deliberate prometheus idiom for this one counter (it
    # exports as-is; the exporter adds no suffix to counters).
    "sync_lock_contended_total":
        "lock acquisitions that found the lock held {lock=...} "
        "(utils/lockprof.py)",
    "sync_ops_sampled":
        "ingress ops sampled by the op-lifecycle plane (utils/oplag.py; "
        "1 of every AMTPU_OPLAG_SAMPLE admissions)",
    "sync_audit_pulls": "convergence-audit digest requests served to peers",
    "sync_audits_completed":
        "convergence-audit rounds completed against a peer's digests",
    "sync_divergences_detected":
        "convergence-audit divergence reports (shard+doc isolated)",
    # transport loss accounting (sync/tcp.py): a message the sender gave
    # up on before the socket write — send failure or an injected fault
    # (utils/chaos.py). The fleet doctor reads this as the frame-loss
    # root-cause signal (perf/doctor.py).
    "sync_frames_dropped":
        "outgoing change-bearing messages dropped before the socket "
        "write (sync/tcp.py; transport failure or injected fault)",
    # per-connection traffic accounting (sync/connection.py + sync/tcp.py
    # + sync/docledger.py): protocol messages split by frame KIND
    # (advert/changes/frame/audit/metrics — frames.msg_kind), and the
    # delivered-change usefulness split the redundancy ratio reads off.
    # Per-DOC splits live in the bounded docledger snapshot section, not
    # in label space (doc ids are unbounded cardinality).
    "sync_conn_msgs_sent":
        "protocol messages sent by a Connection {kind=clock|changes|"
        "frame|audit:*|metrics:*} (sync/connection.py; transport-"
        "agnostic — counts in-process and TCP sends alike)",
    "sync_conn_msgs_received":
        "protocol messages received by a Connection {kind=...} "
        "(sync/connection.py)",
    "sync_conn_bytes_sent":
        "framed wire bytes written, split by message kind {kind=...} "
        "(sync/tcp.py send_frame; exact post-encode sizes)",
    "sync_conn_bytes_received":
        "framed wire bytes read, split by message kind {kind=...} "
        "(sync/tcp.py recv_frame)",
    "sync_conn_changes_delivered":
        "received changes that advanced (or will advance) the local "
        "frontier — NOT already covered by the local clock at delivery "
        "(sync/connection.py; the redundancy ratio's denominator)",
    "sync_conn_changes_duplicate":
        "received changes already covered by the local clock at "
        "delivery — wasted wire work the engine dedups away "
        "(sync/connection.py; the redundancy ratio's numerator)",
    # subscription layer (sync/connection.py InterestSet) + relay fabric
    # (sync/relay.py) + SLO-coupled admission shedding (sync/epochs.py
    # IngressGovernor): interest-based partial replication's control and
    # disclosure plane (docs/INTERNALS.md "Interest-based partial
    # replication")
    "sync_sub_adds":
        "interest entries (doc ids + prefixes) added to a peer's "
        "subscription via {'sub': ...} messages (sync/connection.py)",
    "sync_sub_removes":
        "interest entries removed from a peer's subscription "
        "(sync/connection.py; removed docs degrade to advert-only)",
    "sync_sub_backfills":
        "targeted late-subscribe backfills served — missing-suffix "
        "pushes through the missing_changes snapshot read plane, never "
        "a full-DocSet replay (sync/connection.py)",
    "sync_sub_frames_suppressed":
        "gossip events where interest filtering suppressed the "
        "change-frame channel toward a peer (sync/connection.py; the "
        "wire partial replication saves)",
    "sync_sub_resubscribes":
        "full-interest replays after a re-home (Connection."
        "resubscribe; sync/relay.py adoption path)",
    "sync_relay_sub_deduped":
        "upstream subscription entries a relay hub suppressed because "
        "its merged cover already held them (sync/relay.py; the "
        "dedup-upward half of the fan-out tree)",
    "sync_shed_delayed":
        "low-priority epoch-path ingresses delayed by the admission "
        "governor during a sustained converge-SLO breach "
        "(sync/epochs.IngressGovernor mode='delay')",
    "sync_shed_dropped":
        "low-priority ingresses shed (IngressShedError) by the "
        "admission governor (sync/epochs.IngressGovernor mode='shed')",
    "sync_shed_transitions":
        "admission-governor state transitions (open <-> shedding) "
        "(sync/epochs.IngressGovernor; each also a shed_transition "
        "flight-recorder event)",
    # tenant attribution plane (sync/tenantledger.py — r18): the
    # governor's shed/delay decisions split per tenant {tenant=...}
    # (bounded: the ledger tracks at most MAX_TENANTS identities)
    "sync_tenant_shed_delayed":
        "governor-delayed low-priority ingresses per tenant "
        "{tenant=...} (sync/tenantledger.py note_shed)",
    "sync_tenant_shed_dropped":
        "governor-shed (IngressShedError) ingresses per tenant "
        "{tenant=...} (sync/tenantledger.py note_shed)",
    "sync_tenant_overflow":
        "distinct tenant identities folded into the _overflow bucket "
        "past MAX_TENANTS (sync/tenantledger.py; disclosed truncation)",
    # per-doc convergence ledger (sync/docledger.py)
    "obs_doc_evictions":
        "tracked docs evicted from the ledger's top-K table into the "
        "aggregate bucket (sync/docledger.py; bounded-memory policy)",
    # obs — the observability subsystem's own signals
    "obs_watchdog_fired": "watchdog budget overruns {name=...}",
    "obs_budget_exceeded": "trace(budget_s=...) post-hoc overruns {name=...}",
    "obs_flightrec_dumps": "flight-recorder post-mortem dumps {reason=...}",
    # fleet health plane (perf/fleet.py, perf/slo.py, utils/chaos.py)
    "obs_chaos_injected":
        "chaos fault injections fired {fault=slow_apply|lock_hold|"
        "frame_drop|doc_stall|sub_flap|conn_kill|peer_hang|disk_stall|"
        "tenant_storm} (utils/chaos.py; inert unless AMTPU_CHAOS_* set)",
    "obs_fleet_stragglers_flagged":
        "straggler flags raised by the fleet collector {node=...} "
        "(perf/fleet.py; counted on the transition into flagged)",
    "obs_slo_breaches":
        "SLO verdict transitions into breach {slo=...} (perf/slo.py)",
    # remediation plane (perf/remediate.py + sync/tcp.py supervisor —
    # r13): every automated action, withhold, and recovery disclosed
    "obs_remed_actions":
        "remediation actions EXECUTED {action=quarantine|reconnect|"
        "re_bootstrap|governor_escalate|governor_relax} "
        "(perf/remediate.py; dry-run intentions never land here)",
    "obs_remed_skipped":
        "remediation actions withheld by a guardrail {reason=cooldown|"
        "budget|quorum|dry_run} (perf/remediate.py)",
    "obs_remed_recovered":
        "remediation episodes closed with the fleet back to SLO-green "
        "(perf/remediate.py; each also a remed_recovered event with "
        "the measured MTTR)",
    "obs_flightrec_suppressed":
        "flight-recorder dumps suppressed by the per-trigger-class "
        "cooldown {reason=...} (utils/flightrec.py; a dump storm is "
        "throttled, never unbounded)",
    # lock-order sanitizer (utils/locksan.py — r18): runtime checks of
    # the committed locks_manifest.json hierarchy, AMTPU_LOCKSAN=1
    "obs_locksan_order_violations_total":
        "lock acquisitions inverting a committed locks_manifest.json "
        "order edge {lock=...} (utils/locksan.py; each also a "
        "locksan_violation event; AMTPU_LOCKSAN=2 additionally raises)",
    "obs_locksan_long_holds_total":
        "outermost lock holds exceeding AMTPU_LOCKSAN_HOLD_S released "
        "while other threads were blocked on the same lock {lock=...} "
        "(utils/locksan.py; the r5 stall shape caught live)",
    "sync_reconnect_attempts":
        "socket (re)connection attempts by the reconnect supervisor "
        "(sync/tcp.SupervisedTcpClient; includes the refused ones)",
    "sync_reconnects":
        "successful reconnections after a transport death — generation "
        ">= 2 links brought back by the supervisor (sync/tcp.py)",
    "sync_reconnect_idle_kicks":
        "reconnects forced by the inbound-idle detector — a live socket "
        "whose PROCESSED inbound activity went quiet past "
        "idle_reconnect_s (sync/tcp.SupervisedTcpClient; the peer_hang "
        "fault's detection path)",
}

GAUGES: dict[str, str] = {
    "core_queue_depth": "causal queue depth after the latest apply batch",
    "core_queue_bytes":
        "approximate host bytes held by the causal queue {estimate}",
    # perfscope telemetry (utils/perfscope.py): one row per kernel
    # signature, from the first dispatch that used it
    "engine_kernel_flops":
        "work count of a kernel {kernel=...} (none yet on the port)",
    "engine_kernel_bytes_accessed":
        "argument + output tensor bytes of a dispatch {kernel=...}",
    "engine_kernel_hbm_bytes":
        "argument / output tensor bytes of a dispatch {kernel=...,section="
        "argument|output}",
    # resident-state footprints (the memory picture a post-mortem needs)
    "engine_resident_bytes": "docs-major resident-state footprint (bytes)",
    "rows_resident_bytes": "rows-engine resident-state footprint (bytes)",
    "sync_shard_resident_bytes":
        "per-shard resident-state footprint {shard=...}",
    "sync_hashes_clean_shards":
        "shards served from the hash cache on the last fleet hash read",
    "sync_hashes_dirty_shards":
        "shards re-read (dirty since epoch) on the last fleet hash read",
    "obs_live_arrays_bytes": "sampled live device-tensor footprint (bytes)",
    "obs_live_arrays_peak_bytes":
        "high-water mark of the live device-tensor footprint since reset",
    # oplag (utils/oplag.py): rolling per-stage lag percentiles over the
    # sampled-op reservoir (refreshed every few samples; the exact
    # reservoir lives in the snapshot's nested "oplag" section)
    "sync_op_lag_p50_s":
        "rolling median sampled-op lag {stage=...} (utils/oplag.py)",
    "sync_op_lag_p99_s":
        "rolling p99 sampled-op lag {stage=...} (utils/oplag.py)",
    # fleet health plane (perf/fleet.py): per-node rollups the collector
    # refreshes every scrape tick — node labels are bounded by fleet size
    "obs_fleet_nodes_scraped":
        "nodes with a fresh snapshot on the last collector tick "
        "(perf/fleet.py)",
    "obs_fleet_scrape_age_s":
        "seconds since a node's last snapshot arrived {node=...} "
        "(perf/fleet.py)",
    "obs_fleet_converge_p99_s":
        "per-node converge-stage p99 at the last scrape {node=...} "
        "(perf/fleet.py)",
    "obs_fleet_round_flush_s":
        "per-node mean round-flush seconds over the scrape window "
        "{node=...} (perf/fleet.py)",
    "obs_fleet_straggler_score":
        "robust deviation score vs the fleet median {node=...} "
        "(perf/fleet.py; >= K sigma flags the node)",
    "obs_slo_ok":
        "current SLO verdict {slo=...} (perf/slo.py; 1 ok / 0 breach)",
    # per-doc convergence ledger (sync/docledger.py): doc-population
    # percentiles over the tracked top-K set, refreshed whenever the
    # ledger snapshot section is exported (no doc-id labels — unbounded)
    "obs_doc_tracked":
        "docs tracked exactly by the convergence ledger "
        "(sync/docledger.py; bounded at its top-K)",
    "obs_doc_lagging":
        "tracked docs currently behind some peer's advertised frontier "
        "(sync/docledger.py)",
    "obs_doc_converge_lag_p50_s":
        "median per-doc convergence lag over tracked docs, seconds "
        "behind the most-advanced peer advert (sync/docledger.py)",
    "obs_doc_converge_lag_p99_s":
        "p99 per-doc convergence lag over tracked docs "
        "(sync/docledger.py)",
    "obs_doc_converge_lag_max_s":
        "max per-doc convergence lag over tracked docs "
        "(sync/docledger.py)",
    "obs_doc_redundancy_ratio":
        "duplicate deliveries / useful deliveries since reset "
        "(sync/docledger.py; the full-mesh fan-out waste partial "
        "replication exists to shrink)",
    # subscription / relay / shedding plane (r12)
    "sync_relay_cover_docs":
        "entries (doc ids + prefixes) in a relay hub's merged "
        "downstream cover set {node=...} (sync/relay.py)",
    "sync_shed_active":
        "admission governor state: 1 while low-priority ingress is "
        "being delayed/shed, else 0 (sync/epochs.IngressGovernor)",
    # dispatch-efficiency ledger (engine/dispatchledger.py — r17):
    # window rollups over the per-round ring, refreshed on the fold
    # cadence (no kernel/bucket labels here — the full attribution lives
    # in the nested "dispatchledger" snapshot section)
    "obs_dispatch_amplification":
        "dispatches per dirty doc over the round window — the number "
        "fleet megabatching must divide (engine/dispatchledger.py)",
    "obs_dispatch_pad_waste_pct":
        "padded-lane fraction computed for nobody, percent, over the "
        "round window (engine/dispatchledger.py)",
    "obs_dispatch_per_round":
        "mean routed dispatches per flush round over the window "
        "(engine/dispatchledger.py)",
    "obs_dispatch_rounds_tracked":
        "flush rounds currently held in the dispatch ledger's bounded "
        "ring (engine/dispatchledger.py)",
    # tenant attribution plane (sync/tenantledger.py — r18): refreshed
    # on the ledger's mutation path every GAUGE_REFRESH records; tenant
    # labels are bounded by the ledger's MAX_TENANTS table
    "obs_tenant_tracked":
        "tenant identities tracked by the attribution ledger "
        "(sync/tenantledger.py; bounded at MAX_TENANTS)",
    "obs_tenant_ingress_share_pct":
        "tenant's share of all admitted changes {tenant=...} "
        "(sync/tenantledger.py; the tenant_hot doctor evidence)",
    "obs_tenant_converge_lag_p99_s":
        "p99 converge-lag restamp over the tenant's recent sample ring "
        "{tenant=...} (sync/tenantledger.py; the tenant_converge_p99 "
        "SLO family's per-node feed)",
    # trace plane (utils/tracer.py — r19): refreshed on the plane's
    # mutation path every GAUGE_REFRESH completions; stage-level detail
    # lives in the nested "traceplane" snapshot section (no stage or
    # doc labels here)
    "obs_trace_sampled":
        "changes stamped with a trace context at frontend finalize "
        "since reset (utils/tracer.py; the completeness denominator)",
    "obs_trace_completed":
        "traces completed at converged-hash visibility since reset "
        "(utils/tracer.py; stitched cross-process ones included)",
    "obs_trace_inflight":
        "sampled changes currently mid-lifecycle across the awaiting "
        "tables (utils/tracer.py; TTL-expired ones leave as expired)",
    "obs_trace_critical_path_p99_s":
        "p99 end-to-end critical path over the completed-trace ring "
        "(utils/tracer.py; the number fleet megabatching divides "
        "into stages)",
    # megabatch plane (engine/dispatchledger.py window — r20): achieved
    # fused-round occupancy over the ring window, refreshed with the
    # other obs_dispatch_* gauges
    "obs_megabatch_docs_per_dispatch":
        "docs served per fused dispatch over the megabatch rounds in "
        "the ledger window (engine/dispatchledger.py; the achieved "
        "number next to perf dispatch's projection)",
    "obs_megabatch_fill_pct":
        "percent of fused-dispatch doc-lane capacity actually occupied "
        "over the window's megabatch rounds (engine/dispatchledger.py)",
    # remediation plane (perf/remediate.py — r13)
    "obs_remed_quarantined":
        "nodes currently quarantined by the remediation engine "
        "(perf/fleet.py; excluded from straggler scoring, rollups and "
        "SLO membership until unquarantined)",
    "obs_remed_governor_stage":
        "admission-governor escalation ladder stage: 0 open / 1 delay "
        "/ 2 shed (perf/remediate.GovernorLadder)",
}

HISTOGRAMS: dict[str, str] = {
    "sync_round_seconds": "latency of coalesced service round flushes",
    # lockprof (utils/lockprof.py): per-lock contention profile. Named
    # with the `_s` unit suffix (the naming contract) — they
    # export as `sync_lock_wait_s{lock=...}_{count,sum,min,max}`.
    "sync_lock_wait_s":
        "time spent waiting to acquire an instrumented lock {lock=...}",
    "sync_lock_hold_s":
        "outermost hold time of an instrumented lock {lock=...}",
    # oplag (utils/oplag.py): per-stage lag of sampled ops through the
    # admission -> flush -> wire -> peer-apply -> converged lifecycle
    "sync_op_lag_s":
        "sampled op-lifecycle stage lag {stage=causal_queue|buffer_wait|"
        "queue_wait|pack|dispatch|device_wait|flush|origin_total|wire|"
        "peer_apply|converge} (utils/oplag.py; docs/OBSERVABILITY.md)",
    "sync_commit_wait_s":
        "writer park from epoch-buffer append to its group-commit flush "
        "resolving (sync/epochs.py ticket wait — NOT a lock wait: the "
        "writer holds nothing while parked)",
    "obs_fleet_scrape_s":
        "wall seconds of one fleet-collector scrape tick (perf/fleet.py; "
        "the self-overhead the collector_overhead SLO bounds)",
    "obs_doc_ledger_s":
        "convergence-ledger self-time flushed per snapshot export "
        "(sync/docledger.py; sum/elapsed = the duty-cycle bound the "
        "config-12 perf-check gate holds under 2%)",
    "obs_dispatch_ledger_s":
        "dispatch-ledger self-time flushed per gauge refresh "
        "(engine/dispatchledger.py; sum/elapsed = the duty-cycle bound "
        "the config-17 perf-check gate holds under 2%)",
    "obs_tenant_ledger_s":
        "tenant-ledger self-time flushed per gauge refresh "
        "(sync/tenantledger.py; sum/elapsed = the duty-cycle bound the "
        "config-18 perf-check gate holds under 2%)",
    "obs_trace_ledger_s":
        "trace-plane self-time flushed per gauge refresh "
        "(utils/tracer.py; sum/elapsed = the duty-cycle bound the "
        "config-19 perf-check gate holds under 2%)",
    "obs_remed_tick_s":
        "remediation-engine per-tick wall cost (perf/remediate.py; "
        "p50/interval = the steady-state duty cycle bench config 14 "
        "bounds under 2%)",
    "sync_archive_fsync_s":
        "wall seconds of one storage-tier fsync — archive append, "
        "segment seal, manifest commit, snapshot write "
        "(sync/logarchive.py / sync/snapshots.py; the doctor's "
        "storage_stall evidence and the disk_stall chaos signature)",
    "sync_bootstrap_s":
        "wall seconds of one replica bootstrap — snapshot admission + "
        "clock seed + tail replay, or the full-replay fallback "
        "(sync/service.py bootstrap paths)",
}

SPANS: dict[str, str] = {
    "engine_reconcile": "from-scratch batched encode + reconcile kernel",
    "engine_dispatch": "adaptive-routed batch apply {backend=host|device}",
    "engine_resident_apply": "docs-major resident delta scatter + apply",
    "engine_hashes": "docs-major reconcile / hash read",
    "rows_round_apply": "rows-engine round-frame admission + dispatch",
    "rows_hashes": "rows-engine hash read (the readback barrier)",
    "sync_round_flush": "service coalesced-round flush {shard=...}",
    "sync_hashes": "service hash read, incl. read-triggered flush",
    "sync_hashes_fanout": "sharded service hash fan-out over all shards",
    "sync_msg_send": "one outgoing protocol message (trace-context root)",
    "sync_msg_serve": "serving one received protocol message",
    "sync_snapshot_write":
        "one doc's snapshot write: archived-prefix read + survivor "
        "join + crash-safe image commit (sync/service.write_snapshots)",
    "engine_kernel_compile":
        "attributed kernel-library build wall time {kernel=...} "
        "(perfscope build hook; timer-only, no span records)",
}

# The pre-rename alias names ("changes_applied", "wire_frames_received", …)
# the scheme migration kept readable for one release are GONE: bump()/
# trace() on them now registers as an unknown name and snapshot() emits
# canonical keys only. Kept as an (empty) table so extension code probing
# `metrics.ALIASES` keeps working.
ALIASES: dict[str, str] = {}

REGISTRY: dict[str, str] = {**COUNTERS, **GAUGES, **HISTOGRAMS, **SPANS}


def register(name: str, description: str, kind: str = "counter") -> None:
    """Register an extension metric name (plugins, tests, deployments).
    The collection-time lint accepts any registered name."""
    REGISTRY[name] = description
    {"counter": COUNTERS, "gauge": GAUGES, "histogram": HISTOGRAMS,
     "span": SPANS}[kind][name] = description


def _resolve(name: str) -> str:
    return ALIASES.get(name, name)


def _lk(labels: dict) -> tuple:
    """Canonical hashable label key (sorted (k, str(v)) pairs)."""
    if not labels:
        return ()
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _flat_key(name: str, lk: tuple) -> str:
    if not lk:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in lk) + "}"


def _new_id(nbytes: int) -> str:
    return binascii.hexlify(os.urandom(nbytes)).decode()


# Thread-local adopted trace context: (trace_id, parent_span_id) a remote
# peer shipped with a protocol message. Spans opened while it is set join
# the remote trace instead of starting their own (adopt_context()).
_tls = threading.local()


class _Span:
    __slots__ = ("name", "lk", "t0", "wall", "depth", "parent", "thread",
                 "trace_id", "span_id", "parent_sid", "tags")

    def __init__(self, name, lk, depth, parent, thread):
        self.name = name
        self.lk = lk
        self.t0 = time.perf_counter()
        self.wall = time.time()
        self.depth = depth
        self.parent = parent
        self.thread = thread
        if parent is not None:
            self.trace_id = parent.trace_id
            self.parent_sid = parent.span_id
        else:
            ctx = getattr(_tls, "ctx", None)
            self.trace_id = ctx[0] if ctx else _new_id(8)
            self.parent_sid = ctx[1] if ctx else None
        self.span_id = _new_id(4)
        self.tags = None


class _Metrics:
    """Thread-safe metrics store. Every public mutation takes self.lock —
    the sync/tcp layer calls in from socket reader threads concurrently
    with application threads."""

    def __init__(self):
        self.lock = threading.RLock()
        self.counters: dict[tuple, int] = {}
        self.gauges: dict[tuple, float] = {}
        self.timers: dict[tuple, float] = {}
        self.span_counts: dict[tuple, int] = {}
        # histogram summary: [count, sum, min, max]
        self.hists: dict[tuple, list] = {}
        self.spans: deque = deque(maxlen=SPAN_RING)
        # thread ident -> stack of active _Span (the watchdog's evidence)
        self.active: dict[int, list] = {}
        self.watchdog_events: list[dict] = []

    # -- primitives ---------------------------------------------------------

    def bump(self, _name: str, _n: int = 1, **labels) -> None:
        key = (_resolve(_name), _lk(labels))
        with self.lock:
            self.counters[key] = self.counters.get(key, 0) + _n

    def gauge(self, _name: str, _value: float, **labels) -> None:
        key = (_resolve(_name), _lk(labels))
        with self.lock:
            self.gauges[key] = _value

    def observe(self, _name: str, _value: float, **labels) -> None:
        key = (_resolve(_name), _lk(labels))
        with self.lock:
            h = self.hists.get(key)
            if h is None:
                self.hists[key] = [1, _value, _value, _value]
            else:
                h[0] += 1
                h[1] += _value
                h[2] = min(h[2], _value)
                h[3] = max(h[3], _value)

    def add_time(self, _name: str, _seconds: float, **labels) -> None:
        key = (_resolve(_name), _lk(labels))
        with self.lock:
            self.timers[key] = self.timers.get(key, 0.0) + _seconds

    # -- span stack ---------------------------------------------------------

    def push_span(self, name: str, lk: tuple, tags: dict | None = None
                  ) -> _Span:
        ident = threading.get_ident()
        with self.lock:
            stack = self.active.setdefault(ident, [])
            span = _Span(name, lk, len(stack),
                         stack[-1] if stack else None,
                         threading.current_thread().name)
            if tags:
                span.tags = dict(tags)
            stack.append(span)
        return span

    def pop_span(self, span: _Span, duration: float) -> None:
        ident = threading.get_ident()
        with self.lock:
            stack = self.active.get(ident)
            if stack is not None:
                for i in range(len(stack) - 1, -1, -1):
                    if stack[i] is span:
                        del stack[i]
                        break
                if not stack:
                    del self.active[ident]
            self.timers[(span.name, span.lk)] = (
                self.timers.get((span.name, span.lk), 0.0) + duration)
            ckey = (span.name, span.lk)
            self.span_counts[ckey] = self.span_counts.get(ckey, 0) + 1
            rec = {
                "name": span.name,
                "labels": dict(span.lk),
                "start": span.wall,
                "duration_s": round(duration, 6),
                "depth": span.depth,
                "parent": (span.parent.name
                           if span.parent is not None else None),
                "thread": span.thread,
                "trace_id": span.trace_id,
                "span_id": span.span_id,
                "parent_span_id": span.parent_sid,
            }
            if span.tags:
                rec["tags"] = span.tags
            self.spans.append(rec)

    def span_stacks(self) -> dict[str, list[str]]:
        """Active span stacks for every thread — `{"Thread-3":
        ["sync_round_flush(12.1s)", "rows_hashes(11.8s)"]}`. This is the
        watchdog's one-line diagnosis payload."""
        now = time.perf_counter()
        with self.lock:
            out = {}
            for stack in self.active.values():
                if stack:
                    out[stack[0].thread] = [
                        f"{_flat_key(s.name, s.lk)}({now - s.t0:.2f}s)"
                        for s in stack]
            return out

    # -- exporters ----------------------------------------------------------

    def snapshot(self) -> dict:
        """Flat, json.dumps-safe view: counters as-is, gauges as-is,
        timers as `<name>_s`, histograms as `<name>_{count,sum,min,max}`.
        Labeled series flatten to `name{k=v,...}` keys. Canonical names
        only — the pre-rename alias keys the scheme migration emitted for
        one release are gone."""
        with self.lock:
            out: dict = {}
            for (name, lk), v in self.counters.items():
                out[_flat_key(name, lk)] = v
            for (name, lk), v in self.gauges.items():
                out[_flat_key(name, lk)] = v
            for (name, lk), h in self.hists.items():
                base = _flat_key(name, lk)
                out[base + "_count"] = h[0]
                out[base + "_sum"] = round(h[1], 6)
                out[base + "_min"] = round(h[2], 6)
                out[base + "_max"] = round(h[3], 6)
            for (name, lk), v in self.span_counts.items():
                out[_flat_key(name, lk) + "_count"] = v
            for (name, lk), v in self.timers.items():
                out[_flat_key(name, lk) + "_s"] = round(v, 6)
        return out

    def prometheus(self, prefix: str = "amtpu_") -> str:
        """Prometheus text exposition (0.0.4). Counters export as
        `<prefix><name>`, span/timer totals as
        `<prefix><name>_seconds_total`, histograms as summary-style
        `_count`/`_sum` plus `_min`/`_max` gauges."""
        def san(name):
            return re.sub(r"[^a-zA-Z0-9_:]", "_", name)

        def esc(value):
            return (value.replace("\\", r"\\").replace('"', r'\"')
                    .replace("\n", r"\n"))

        def labelstr(lk):
            if not lk:
                return ""
            return "{" + ",".join(f'{san(k)}="{esc(v)}"'
                                  for k, v in lk) + "}"

        with self.lock:
            counters = sorted(self.counters.items())
            gauges = sorted(self.gauges.items())
            hists = sorted(self.hists.items())
            span_counts = sorted(self.span_counts.items())
            timers = sorted(self.timers.items())
        lines: list[str] = []
        typed: set[str] = set()

        def emit(name, kind, lk, value, help_=None):
            full = prefix + san(name)
            if full not in typed:
                typed.add(full)
                desc = help_ or REGISTRY.get(name)
                if desc:
                    lines.append(f"# HELP {full} {desc}")
                lines.append(f"# TYPE {full} {kind}")
            lines.append(f"{full}{labelstr(lk)} {value}")

        for (name, lk), v in counters:
            emit(name, "counter", lk, v)
        for (name, lk), v in gauges:
            emit(name, "gauge", lk, v)
        for (name, lk), h in hists:
            emit(name + "_count", "counter", lk, h[0],
                 help_=REGISTRY.get(name))
            emit(name + "_sum", "counter", lk, h[1])
            emit(name + "_min", "gauge", lk, h[2])
            emit(name + "_max", "gauge", lk, h[3])
        for (name, lk), v in span_counts:
            emit(name + "_count", "counter", lk, v,
                 help_=REGISTRY.get(name))
        for (name, lk), v in timers:
            emit(name + "_seconds_total", "counter", lk, v,
                 help_=REGISTRY.get(name))
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        with self.lock:
            self.counters.clear()
            self.gauges.clear()
            self.timers.clear()
            self.span_counts.clear()
            self.hists.clear()
            self.spans.clear()
            self.watchdog_events.clear()
            # active spans are NOT cleared: regions currently executing
            # still finish and record into the fresh store


_global = _Metrics()

# ---------------------------------------------------------------------------
# module-level API (the singleton surface every layer imports)


def bump(_name: str, _n: int = 1, **labels) -> None:
    _global.bump(_name, _n, **labels)


def gauge(_name: str, _value: float, **labels) -> None:
    _global.gauge(_name, _value, **labels)


def observe(_name: str, _value: float, **labels) -> None:
    _global.observe(_name, _value, **labels)


def add_time(_name: str, _seconds: float, **labels) -> None:
    _global.add_time(_name, _seconds, **labels)


# Extension snapshot sections: a subsystem that cannot live in utils/
# (the per-doc ledger is sync-layer code) registers a provider here and
# its nested section rides every snapshot() — and therefore every
# metrics-pull answer, flight-recorder dump, and bench config capture —
# without utils importing the owning package. Providers run OUTSIDE the
# metrics lock (they may bump their own gauges), must return a
# json.dumps-clean dict (or None/{} to skip), and must be PURE functions
# of their subsystem's state: no wall-clock reads at export time, so two
# back-to-back snapshots with no traffic in between compare equal.
_section_providers: dict[str, object] = {}


def register_snapshot_section(name: str, provider) -> None:
    """Register (or replace) a nested snapshot section provider.
    `provider()` is called by every snapshot(); a raising provider is
    skipped — telemetry must never take down the caller."""
    _section_providers[name] = provider


def snapshot() -> dict:
    """Flat metrics view plus — when the performance plane has recorded
    anything since the last reset — a nested `"perf"` section
    (utils/perfscope.py: per-kernel compile telemetry, phase rollup,
    memory footprint). The perf attach happens OUTSIDE the metrics lock:
    perfscope has its own lock and the two must never nest."""
    out = _global.snapshot()
    try:
        from . import perfscope
        perf = perfscope.perf_snapshot()
    except Exception:
        perf = None
    if perf:
        out["perf"] = perf
    try:    # the op-lifecycle lag percentiles (same nested-section rule)
        from . import oplag
        lag = oplag.lag_snapshot()
    except Exception:
        lag = None
    if lag:
        out["oplag"] = lag
    for name, provider in list(_section_providers.items()):
        try:
            sec = provider()
        except Exception:
            sec = None
        if sec:
            out[name] = sec
    return out


def prometheus(prefix: str = "amtpu_") -> str:
    return _global.prometheus(prefix=prefix)


def reset() -> None:
    _global.reset()
    try:
        from . import perfscope
        perfscope.reset()
    except Exception:
        pass
    try:
        from . import oplag
        oplag.reset()
    except Exception:
        pass
    # registered section providers observe the reset through their own
    # reset hook, if they installed one (sync/docledger.py: clears every
    # live ledger so a post-reset snapshot() is {} again)
    for hook in list(_section_reset_hooks):
        try:
            hook()
        except Exception:
            pass


_section_reset_hooks: list = []


def register_reset_hook(hook) -> None:
    """Subsystems whose snapshot section must clear on reset() (the
    per-config bench captures depend on it) register a zero-arg hook."""
    if hook not in _section_reset_hooks:
        _section_reset_hooks.append(hook)


def recent_spans() -> list[dict]:
    """Completed spans from the ring buffer, oldest first."""
    with _global.lock:
        return list(_global.spans)


def span_stacks() -> dict[str, list[str]]:
    return _global.span_stacks()


def watchdog_events() -> list[dict]:
    """Diagnoses recorded by fired watchdogs since the last reset()."""
    with _global.lock:
        return list(_global.watchdog_events)


# ---------------------------------------------------------------------------
# node identity (the fleet health plane's scrape naming)

_node_name: str | None = None
_node_name_read = False


def node_name() -> str | None:
    """This process's fleet node label, if any: AMTPU_NODE_NAME (read
    once) or whatever set_node_name() installed. A Connection serving a
    `{"metrics": "pull"}` stamps it on the answer, so a fleet collector
    (perf/fleet.py) names scraped peers by THEIR self-identity instead
    of guessing from socket order."""
    global _node_name, _node_name_read
    if not _node_name_read:
        _node_name_read = True
        _node_name = os.environ.get("AMTPU_NODE_NAME") or None
    return _node_name


def set_node_name(name: str | None) -> None:
    """Override (or with None: clear back to the env) the node label."""
    global _node_name, _node_name_read
    if name is None:
        _node_name_read = False
        _node_name = None
    else:
        _node_name_read = True
        _node_name = str(name)


# ---------------------------------------------------------------------------
# cross-replica trace context


def current_context() -> dict | None:
    """The calling thread's live trace context — `{"tid": ..., "sid": ...}`
    of its innermost active span, falling back to an adopted remote context
    — or None when nothing is being traced. Public surface for CUSTOM
    transports/embedders stamping the context onto their own envelopes;
    the built-in Connection does not use it (its sync_msg_send span IS the
    context it stamps — sync/connection.py:_send_traced)."""
    ident = threading.get_ident()
    with _global.lock:
        stack = _global.active.get(ident)
        if stack:
            return {"tid": stack[-1].trace_id, "sid": stack[-1].span_id}
    ctx = getattr(_tls, "ctx", None)
    if ctx is not None:
        return {"tid": ctx[0], "sid": ctx[1]}
    return None


@contextmanager
def adopt_context(ctx: dict | None):
    """Join a remote trace: top-level spans opened by this thread inside
    the block record the remote `tid` as their trace id and the remote
    `sid` as their parent span, stitching the local serving work onto the
    peer's span tree. A None/invalid ctx is a no-op (untraced peers cost
    nothing). Nested adoptions restore the previous context on exit."""
    if not isinstance(ctx, dict) or not ctx.get("tid"):
        yield
        return
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = (str(ctx["tid"]), str(ctx["sid"]) if ctx.get("sid") else None)
    try:
        yield
    finally:
        _tls.ctx = prev


def _topo_trace(spans: list[dict]) -> list[dict]:
    """Causal order within one trace: parent before child (even when clock
    skew between replicas makes the child's start earlier), siblings by
    start time, orphans (parent span not captured in any buffer) as roots.
    Each span emits exactly once (the guard also breaks parent cycles a
    span-id collision could fabricate)."""
    by_sid = {s["span_id"]: s for s in spans if s.get("span_id")}
    children: dict[str | None, list[dict]] = {}
    for s in spans:
        p = s.get("parent_span_id")
        children.setdefault(p if p in by_sid else None, []).append(s)
    out: list[dict] = []
    emitted: set[int] = set()

    def walk(parent_sid):
        for s in sorted(children.get(parent_sid, []),
                        key=lambda s: s.get("start", 0.0)):
            if id(s) in emitted:
                continue
            emitted.add(id(s))
            out.append(s)
            if s.get("span_id"):
                walk(s["span_id"])
    walk(None)
    for s in spans:        # collision leftovers: never drop a span
        if id(s) not in emitted:
            out.append(s)
    return out


def merge_timeline(buffers: dict[str, list[dict]]) -> list[dict]:
    """Merge per-replica span buffers (each a `recent_spans()` list — local
    or pulled from a peer via the `{"metrics": "pull", "spans": true}`
    protocol message) into ONE causally-ordered timeline. Each output span
    gains a `"replica"` key; traces are ordered by their earliest span
    start, and within a trace parents precede children regardless of
    replica clock skew — the cross-node picture of a sync round the
    per-node ring buffers cannot show alone. A span present in several
    buffers (overlapping pulls, or an in-process "peer" sharing the
    store) is emitted once, under the first buffer that carried it."""
    spans: list[dict] = []
    seen: set = set()
    for replica, buf in buffers.items():
        for s in buf or []:
            key = (s.get("span_id"), s.get("name"), s.get("start"))
            if s.get("span_id") and key in seen:
                continue
            seen.add(key)
            t = dict(s)
            t["replica"] = replica
            spans.append(t)
    by_trace: dict[str, list[dict]] = {}
    loose: list[dict] = []
    for s in spans:
        tid = s.get("trace_id")
        (by_trace.setdefault(tid, []) if tid else loose).append(s)
    groups = [(_topo_trace(group)) for group in by_trace.values()]
    groups.extend([s] for s in loose)
    groups.sort(key=lambda g: min(s.get("start", 0.0) for s in g))
    return [s for g in groups for s in g]


def _device_annotation(name: str):
    """`torch.profiler.record_function(name)` while a torch.profiler
    session is recording (the span's device work then shows under
    `name` in the trace); None otherwise, so an unprofiled span pays one
    flag check."""
    import torch
    if not torch.autograd._profiler_enabled():
        return None
    return torch.profiler.record_function(name)


@contextmanager
def trace(name: str, budget_s: float | None = None,
          tags: dict | None = None, **labels):
    """Structured span: nests per thread, records wall seconds + a count
    even when the body raises, annotates device work for torch.profiler, and
    lands in the recent-span ring buffer. With budget_s, an overrun is
    flagged post-hoc (`obs_budget_exceeded{name=...}` + one warning line);
    for live stall detection of a possibly-hung region use watchdog().

    `tags` ride on the ring-buffer span record ONLY — unlike **labels they
    never become metric series keys, so unbounded values (round numbers,
    doc ids) are safe there and forbidden as labels."""
    name = _resolve(name)
    lk = _lk(labels)
    annotation = _device_annotation(_flat_key(name, lk))
    span = _global.push_span(name, lk, tags)
    t0 = time.perf_counter()
    try:
        if annotation is not None:
            with annotation:
                yield span
        else:
            yield span
    finally:
        duration = time.perf_counter() - t0
        _global.pop_span(span, duration)
        if budget_s is not None and duration > budget_s:
            bump("obs_budget_exceeded", name=name)
            log.warning(
                "span %r exceeded budget: %.3fs > %.3fs (labels %s)",
                name, duration, budget_s, dict(lk))


class _WatchdogMonitor:
    """One shared background checker for every active watchdog. A
    threading.Timer per watched region would spawn a thread per hashes()
    poll; this parks a single daemon thread on a condition variable and
    wakes it only at the earliest pending deadline. An idle checker (no
    pending deadlines for `linger_s`) EXITS instead of parking forever —
    thread hygiene between tests/services — and the next add() respawns
    it."""

    #: seconds an idle checker thread lingers before exiting (a steady
    #: stream of watchdogged regions reuses the thread; a one-off lets it
    #: die). Tests shrink this to assert hygiene quickly.
    linger_s = 0.5

    def __init__(self):
        self._cv = threading.Condition()
        self._entries: dict[int, tuple[float, object]] = {}
        self._thread: threading.Thread | None = None
        self._seq = 0

    def add(self, deadline: float, fire) -> int:
        with self._cv:
            self._seq += 1
            key = self._seq
            self._entries[key] = (deadline, fire)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="amtpu-torch-watchdog", daemon=True)
                self._thread.start()
            self._cv.notify()
        return key

    def remove(self, key: int) -> None:
        with self._cv:
            self._entries.pop(key, None)
            self._cv.notify()

    def thread(self) -> threading.Thread | None:
        """The live checker thread, if any (hygiene tests join on it)."""
        with self._cv:
            return self._thread

    def _run(self) -> None:
        while True:
            with self._cv:
                now = time.perf_counter()
                due = [(k, f) for k, (d, f) in self._entries.items()
                       if d <= now]
                for k, _ in due:
                    del self._entries[k]
                if not due:
                    if self._entries:
                        nxt = min(d for d, _ in self._entries.values())
                        self._cv.wait(timeout=max(nxt - now, 0.001))
                    else:
                        self._cv.wait(timeout=self.linger_s)
                        if not self._entries:
                            # idle past the linger: exit; add() respawns.
                            # The _thread reset happens under the cv, so
                            # an add() racing this exit either sees the
                            # old thread (and its entry is caught by the
                            # empty-check above on the next loop) or
                            # spawns a fresh one.
                            self._thread = None
                            return
                    continue
            for _, fire in due:   # outside the cv: fire() takes other locks
                try:
                    fire()
                except Exception:
                    log.exception("watchdog fire failed")


_monitor = _WatchdogMonitor()


@contextmanager
def watchdog(name: str, budget_s: float, logger=None,
             tags: dict | None = None):
    """Stall watchdog around a traced region: the shared background checker
    fires once at budget_s if the block has not exited, logging a one-line
    diagnosis with every thread's active span stack (the "where is it
    stuck" line the r5 config-8 hang never produced), bumping
    obs_watchdog_fired{name=...}, and dumping the flight recorder
    (utils/flightrec.py) so the hang leaves a self-contained post-mortem
    file. The watched block itself runs inside trace(name, tags=tags), so
    the diagnosis always names at least the watched region. The region is
    never interrupted. budget_s <= 0 disables."""
    if budget_s is None or budget_s <= 0:
        with trace(name, tags=tags):
            yield
        return
    lg = logger or log
    t_start = time.perf_counter()

    def _fire():
        stacks = _global.span_stacks()
        desc = "; ".join(f"{t}: {' > '.join(s)}"
                         for t, s in sorted(stacks.items())) \
            or "no active spans"
        try:    # who holds what, not just which span stalled (lockprof)
            from . import lockprof
            holders = lockprof.holders_snapshot()
        except Exception:
            holders = {}
        hdesc = "; ".join(
            f"{n} held {h['held_s']:.2f}s by {h['thread']} ({h['site']})"
            for n, h in sorted(holders.items())) or "none"
        lg.warning(
            "watchdog %r: traced region still running after %.2fs "
            "(budget %.2fs); active spans: %s; lock holders: %s",
            name, time.perf_counter() - t_start, budget_s, desc, hdesc)
        bump("obs_watchdog_fired", name=name)
        with _global.lock:
            _global.watchdog_events.append({
                "name": name, "budget_s": budget_s,
                "elapsed_s": round(time.perf_counter() - t_start, 3),
                "spans": stacks, "lock_holders": holders,
                "at": time.time()})
        try:    # the stall post-mortem: one self-contained JSON file
            from . import flightrec
            flightrec.record("watchdog_fire", name=name,
                             budget_s=budget_s)
            flightrec.dump(f"watchdog:{name}")
        except Exception:
            log.exception("flight-recorder dump on watchdog fire failed")

    key = _monitor.add(t_start + budget_s, _fire)
    try:
        with trace(name, tags=tags):
            yield
    finally:
        _monitor.remove(key)


# ---------------------------------------------------------------------------
# dispatch accounting


def dispatch_jit(kernel: str, fn, *args, **kwargs):
    """Call a device program, counting the dispatch under
    `engine_kernels_dispatched{kernel=...}` and, when the call had to
    build a kernel library first (nvcc or g++, content-hashed, once a
    process), a retrace under `engine_kernels_retraced{kernel=...}`. The
    build is attributed to this dispatch through a thread-local marker
    (utils/perfscope.py), so concurrent dispatches are counted exactly.
    The same window records the build seconds
    (`engine_kernel_compile{kernel=...}_s`) and the call's memory and cost
    rows. Each dispatch also lands in the flight recorder's event ring
    and in the dispatch-efficiency ledger (`dispatchledger.note_jit`).
    The name is the reference's: its callers and its tests patch it."""
    from . import perfscope
    marker = perfscope.dispatch_begin(kernel, fn, args, kwargs)
    out = None
    try:
        with perfscope.phase("dispatch"):
            out = fn(*args, **kwargs)
        return out
    finally:
        retraced = perfscope.dispatch_end(marker, out)
        bump("engine_kernels_dispatched", kernel=kernel)
        if retraced:
            bump("engine_kernels_retraced", kernel=kernel)
        from . import flightrec
        flightrec.record("dispatch", kernel=kernel,
                         **({"retraced": True} if retraced else {}))
        from ..engine import dispatchledger
        dispatchledger.note_jit(kernel, retraced)
