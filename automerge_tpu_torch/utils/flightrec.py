"""Flight recorder: a bounded ring of structured events + crash dumps (the
port of `automerge_tpu/utils/flightrec.py`; dump files are named
`amtpu-torch-flightrec-<pid>-<n>-<reason>.json`).

The r5 config-8 hang taught the painful version of this lesson: a fleet
that dies under a watchdog/timeout leaves, at best, a thread dump — no
record of which peer it was talking to, which shard was mid-flush, or
which kernel was the last one pushed at the device. This module is the
always-on black box the post-mortem needs:

- **record(kind, **fields)** appends a structured event — frame send/recv
  (sync/tcp.py), round flushes (sync/service.py), hash fan-out progress
  (engine hashes paths), dispatch-ledger rounds, watchdog fires — to an in-memory ring. Bounded
  (AMTPU_FLIGHTREC_EVENTS, default 2048 events) and cheap (one dict append
  under a lock), so it stays on in production.
- **dump(reason)** writes one self-contained JSON file: the last N events
  per thread, every thread's active span stack, recent completed spans,
  watchdog diagnoses, and the full metrics snapshot. Returns the path.
- **install()** arms automatic dumps on unhandled exceptions (sys and
  threading excepthooks) and SIGTERM; the stall watchdog
  (metrics.watchdog) dumps on fire without any installation.

So the config-8 class of hang now produces a file naming the stalled span,
its peer, and the last thing every thread did — instead of a bare
`Timeout!`. Schema documented in docs/OBSERVABILITY.md.

Env knobs: AMTPU_FLIGHTREC=0 disables recording entirely;
AMTPU_FLIGHTREC_DIR picks the dump directory (default: the system temp
dir); AMTPU_FLIGHTREC_EVENTS sizes the ring; AMTPU_FLIGHTREC_PER_THREAD
caps the per-thread event tail embedded in a dump (default 64);
AMTPU_FLIGHTREC_COOLDOWN_S (default 30, 0 disables) rate-limits
auto-pathed dumps PER TRIGGER CLASS — a watchdog firing every budget
window, or a remediation escalation loop, must not write an unbounded
dump storm to disk. The class is the reason string itself (reasons are
already class-shaped: "watchdog:<name>", "exception", "remed:<action>");
within the cooldown a repeat trigger returns the PREVIOUS dump path,
bumps `obs_flightrec_suppressed{reason=<class>}`, and writes nothing.
An explicit `path=` or `force=True` always dumps — a caller that names
a destination is deliberate, not a storm.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
import traceback
from collections import deque

log = logging.getLogger("automerge_tpu_torch.flightrec")



def _read_env() -> tuple[bool, int, int, float]:
    try:
        cooldown = float(os.environ.get("AMTPU_FLIGHTREC_COOLDOWN_S", "30"))
    except ValueError:
        cooldown = 30.0
    return (os.environ.get("AMTPU_FLIGHTREC", "1") != "0",
            int(os.environ.get("AMTPU_FLIGHTREC_EVENTS", "2048")),
            int(os.environ.get("AMTPU_FLIGHTREC_PER_THREAD", "64")),
            cooldown)


_ENABLED, _RING, _PER_THREAD, _COOLDOWN_S = _read_env()

_lock = threading.Lock()
_events: deque = deque(maxlen=_RING)
_seq = 0
_dump_count = 0
_last_dump_path: str | None = None
# per-trigger-class dump dedup: reason -> (monotonic stamp, path written)
_dump_stamps: dict[str, tuple[float, str | None]] = {}

# Event-kind registry: every `record(kind, ...)` call site in the package
# must use a kind declared here (enforced statically — the graftlint
# registry pass, automerge_tpu/analysis/registry.py — the same way metric
# names are pinned to metrics.REGISTRY). Post-mortem readers can only
# interpret documented kinds; an undeclared kind is a breadcrumb nobody
# can follow. Extension code registers its kinds by inserting here (or
# suppresses the lint with a justification).
EVENT_KINDS: dict[str, str] = {
    "frame_send": "one protocol message written to a TCP socket "
                  "(sync/tcp.py; kind/doc/bytes)",
    "frame_recv": "one protocol message read from a TCP socket",
    "round_flush": "a coalesced service round entering the engine "
                   "(sync/service.py; shard/round/docs/ops)",
    "epoch_seal": "an ingestion epoch sealed into the pending round "
                  "(sync/service.py; shard/entries/ops — the group-"
                  "commit boundary of the epoch-buffered admission path)",
    "hash_read": "per-node converged hash-table read served "
                 "(sync/service.py; shard/docs)",
    "hash_shard": "sharded hash fan-out reaching shard k "
                  "(sync/sharded_service.py; the stall-progress trail)",
    "hash_epoch_check": "sharded fan-out probing shard k's dirty epoch "
                        "(takes the shard lock — a wedged shard stalls "
                        "HERE, inside the watchdog)",
    "hash_fanout_done": "sharded hash fan-out completed (round/shards/docs)",
    "engine_hash_readback": "docs-major engine device->host hash readback "
                            "barrier (engine/resident.py)",
    "rows_hash_readback": "rows engine device->host hash readback barrier "
                          "(engine/resident_rows.py)",
    "dispatch": "one jitted kernel dispatch (metrics.dispatch_jit; "
                "kernel, retraced flag)",
    "dispatch_round": "one flush round folded into the dispatch-"
                      "efficiency ledger (engine/dispatchledger.py; "
                      "round/docs/dispatches/amp)",
    "watchdog_fire": "a stall watchdog fired (metrics.watchdog; "
                     "name/budget_s)",
    "audit_state": "a convergence-audit digest round compared "
                   "(sync/audit.py; shards/mismatched)",
    "divergence": "a convergence divergence isolated to one doc "
                  "(sync/audit.py; shard/doc)",
    "oplag_admit": "a sampled op entered the lifecycle plane "
                   "(utils/oplag.py; id/doc — the provenance id every "
                   "later oplag_stage event of this op carries)",
    "oplag_stage": "one lifecycle stage of a sampled op completed "
                   "(utils/oplag.py; id/stage/s — admission queue wait, "
                   "flush, wire, peer apply, convergence)",
    # fleet health plane (perf/fleet.py, perf/slo.py, utils/chaos.py)
    "chaos_inject": "an injected chaos fault fired (utils/chaos.py; "
                    "fault/node — discloses every degradation so a chaos "
                    "post-mortem is never mistaken for an organic one)",
    "fleet_scrape": "one fleet-collector scrape tick (perf/fleet.py; "
                    "nodes/fresh/stragglers/s)",
    "straggler_flagged": "the fleet collector flagged a straggler "
                         "(perf/fleet.py; node/signal/score)",
    "slo_verdict": "an SLO verdict transition (perf/slo.py; "
                   "slo/ok/value/bound — recorded on CHANGE, so the ring "
                   "shows when health flipped, not a heartbeat)",
    # subscription / relay / shedding plane (sync/connection.py,
    # sync/relay.py, sync/epochs.py — r12)
    "sub_change": "a peer's interest set changed via a {'sub': ...} "
                  "message (sync/connection.py; added/prefixes/removed)",
    "relay_rehome": "a relay hub adopted an orphaned downstream "
                    "connection after its previous hub died "
                    "(sync/relay.py; node)",
    "shed_transition": "the admission governor flipped between open and "
                       "shedding (sync/epochs.IngressGovernor; "
                       "shedding/p99_s/bound_s/mode)",
    # remediation plane (perf/remediate.py, sync/tcp.SupervisedTcpClient
    # — r13)
    "remed_action": "a remediation action was executed — or, in dry-run, "
                    "would have been (perf/remediate.py; action/node/"
                    "dry_run/evidence; reconnects recorded by the "
                    "supervisor carry action=reconnect)",
    "remed_recovered": "a remediation episode closed: the fleet returned "
                       "to SLO-green with zero human action "
                       "(perf/remediate.py; mttr_s/actions)",
    # trace plane (utils/tracer.py — r19)
    "trace_exemplar": "a completed lifecycle trace set a new slowest-"
                      "critical-path high-water mark (utils/tracer.py; "
                      "tid/doc/role/crit_s/stages — the full waterfall "
                      "lives in the traceplane section's exemplars)",
    # race plane (utils/locksan.py — r18)
    "locksan_violation": "the runtime lock-order sanitizer flagged a "
                         "violation (utils/locksan.py; violation=order|"
                         "long-hold, lock/held/hold_s — order inversions "
                         "vs. the committed locks_manifest.json, and "
                         "over-threshold holds with waiters pending)",
}


def enabled() -> bool:
    return _ENABLED


def record(_kind: str, **fields) -> None:
    """Append one structured event to the ring. Field values should be
    small JSON-able scalars (doc ids and per-event values are fine here —
    the ring is bounded, unlike a metric label space)."""
    if not _ENABLED:
        return
    global _seq
    with _lock:
        _seq += 1
        _events.append({
            "seq": _seq,
            "t": time.time(),
            "thread": threading.current_thread().name,
            "kind": _kind,
            **fields,
        })


def events() -> list[dict]:
    """Ring contents, oldest first."""
    with _lock:
        return list(_events)


def reset() -> None:
    global _seq
    with _lock:
        _events.clear()
        _seq = 0
        _dump_stamps.clear()


def _reload_for_tests() -> None:
    """Re-read the AMTPU_FLIGHTREC* environment (cached at import) and
    empty the ring; a test that sets one calls this at setup and again
    after `monkeypatch.undo()`."""
    global _ENABLED, _RING, _PER_THREAD, _COOLDOWN_S, _events
    _ENABLED, _RING, _PER_THREAD, _COOLDOWN_S = _read_env()
    with _lock:
        _events = deque(maxlen=_RING)
    reset()


def last_dump() -> str | None:
    """Path of the most recent dump() of this process, if any."""
    return _last_dump_path


def _dump_dir() -> str:
    d = os.environ.get("AMTPU_FLIGHTREC_DIR")
    if d:
        return d
    import tempfile
    return tempfile.gettempdir()


def _json_default(o):
    try:
        return int(o)          # numpy integers and friends
    except Exception:
        return repr(o)


def dump(reason: str, path: str | None = None,
         extra: dict | None = None, force: bool = False) -> str | None:
    """Write the post-mortem JSON: per-thread event tails, active span
    stacks, recent completed spans, watchdog diagnoses, and the metrics
    snapshot. Never raises (a broken dump must not mask the failure being
    dumped); returns the file path, or None when disabled or the write
    failed.

    Auto-pathed dumps are rate-limited per trigger class (the reason
    string): a repeat trigger within AMTPU_FLIGHTREC_COOLDOWN_S is
    suppressed — counted on `obs_flightrec_suppressed{reason=...}`,
    returning the class's previous path so callers embedding "the dump"
    in a report still point somewhere real. `last_dump()` is NOT
    updated by a suppressed call. `path=`/`force=True` bypass."""
    global _dump_count, _last_dump_path
    if not _ENABLED:
        return None
    try:
        from . import metrics

        rate_limited = path is None and not force and _COOLDOWN_S > 0
        if rate_limited:
            with _lock:
                prev = _dump_stamps.get(reason)
            # the stamp is written only AFTER a successful dump (below):
            # a failed or still-in-flight first write must not silence
            # the whole trigger class for a cooldown window — the rare
            # race of two threads passing this check together costs one
            # extra dump, the opposite bias costs the post-mortem
            if prev is not None \
                    and time.monotonic() - prev[0] < _COOLDOWN_S:
                # bounded label: the reason class, not the full string
                metrics.bump("obs_flightrec_suppressed",
                             reason=reason.split(":")[0])
                log.debug("flight-recorder dump suppressed (reason %s "
                          "within %.0fs cooldown)", reason, _COOLDOWN_S)
                return prev[1]

        with _lock:
            evs = list(_events)
            _dump_count += 1
            n = _dump_count
        threads: dict[str, list[dict]] = {}
        for e in evs:
            threads.setdefault(e["thread"], []).append(e)
        threads = {t: es[-_PER_THREAD:] for t, es in threads.items()}
        try:    # who currently holds which instrumented lock (lockprof)
            from . import lockprof
            lock_holders = lockprof.holders_snapshot()
        except Exception:
            lock_holders = {}
        try:    # the slowest in-flight lifecycle traces at fault time:
            #     a divergence capture shows what was mid-flight, not
            #     just the aggregate gauges (docs/OBSERVABILITY.md
            #     "Trace plane")
            from . import tracer
            inflight_traces = tracer.inflight_snapshot()
        except Exception:
            inflight_traces = []
        doc = {
            "reason": reason,
            "at": time.time(),
            "pid": os.getpid(),
            "argv": sys.argv,
            "span_stacks": metrics.span_stacks(),
            "lock_holders": lock_holders,
            "threads": threads,
            "recent_spans": metrics.recent_spans(),
            "watchdog_events": metrics.watchdog_events(),
            "inflight_traces": inflight_traces,
            "metrics": metrics.snapshot(),
        }
        if extra:
            doc["extra"] = extra
        if path is None:
            safe = "".join(c if c.isalnum() or c in "-_" else "-"
                           for c in reason)[:48]
            path = os.path.join(
                _dump_dir(),
                f"amtpu-torch-flightrec-{os.getpid()}-{n:03d}-{safe}.json")
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, default=_json_default)
        _last_dump_path = path
        if rate_limited:
            with _lock:
                # stamped on SUCCESS only, carrying the path a later
                # suppressed repeat of this trigger class will return
                _dump_stamps[reason] = (time.monotonic(), path)
        # bounded label: the reason class, not the full reason string
        metrics.bump("obs_flightrec_dumps", reason=reason.split(":")[0])
        log.warning("flight recorder dumped to %s (reason: %s)",
                    path, reason)
        return path
    except Exception:
        log.exception("flight-recorder dump failed (reason: %s)", reason)
        return None


# ---------------------------------------------------------------------------
# automatic dump triggers: unhandled exceptions + SIGTERM


_installed = False
_prev_sys_hook = None
_prev_threading_hook = None
_prev_sigterm = None


def install(signals: bool = True, excepthooks: bool = True) -> None:
    """Arm automatic dumps: unhandled exceptions on any thread (sys and
    threading excepthooks, chained to the previous hooks) and SIGTERM
    (dump, then re-deliver so termination semantics are unchanged).
    Idempotent. Long-lived processes (bench workers, sync services) call
    this once at startup; libraries should not."""
    global _installed, _prev_sys_hook, _prev_threading_hook, _prev_sigterm
    if _installed or not _ENABLED:
        return
    _installed = True

    if excepthooks:
        _prev_sys_hook = sys.excepthook

        def _sys_hook(exc_type, exc, tb):
            dump("exception", extra={
                "exception": "".join(traceback.format_exception(
                    exc_type, exc, tb))[-8000:]})
            (_prev_sys_hook or sys.__excepthook__)(exc_type, exc, tb)

        sys.excepthook = _sys_hook

        _prev_threading_hook = threading.excepthook

        def _thread_hook(args):
            dump("thread-exception", extra={
                "thread": getattr(args.thread, "name", None),
                "exception": "".join(traceback.format_exception(
                    args.exc_type, args.exc_value,
                    args.exc_traceback))[-8000:]})
            (_prev_threading_hook or threading.__excepthook__)(args)

        threading.excepthook = _thread_hook

    if signals and threading.current_thread() is threading.main_thread():
        import signal as _signal
        try:
            _prev_sigterm = _signal.getsignal(_signal.SIGTERM)

            def _on_sigterm(signum, frame):
                dump("sigterm")
                if _prev_sigterm is _signal.SIG_IGN:
                    return          # the process chose to ignore SIGTERM;
                    #                 dumping must not turn that into death
                if callable(_prev_sigterm):
                    _prev_sigterm(signum, frame)
                else:               # SIG_DFL (or unknown): default death
                    _signal.signal(_signal.SIGTERM, _signal.SIG_DFL)
                    os.kill(os.getpid(), _signal.SIGTERM)

            _signal.signal(_signal.SIGTERM, _on_sigterm)
        except (ValueError, OSError):   # non-main interpreter contexts
            _prev_sigterm = None


def uninstall() -> None:
    """Restore the hooks install() replaced (tests; embedders shutting
    down cleanly)."""
    global _installed, _prev_sys_hook, _prev_threading_hook, _prev_sigterm
    if not _installed:
        return
    _installed = False
    if _prev_sys_hook is not None:
        sys.excepthook = _prev_sys_hook
        _prev_sys_hook = None
    if _prev_threading_hook is not None:
        threading.excepthook = _prev_threading_hook
        _prev_threading_hook = None
    if _prev_sigterm is not None:
        import signal as _signal
        try:
            _signal.signal(_signal.SIGTERM, _prev_sigterm)
        except (ValueError, OSError):
            pass
        _prev_sigterm = None
