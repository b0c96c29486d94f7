"""The counter core of `automerge_tpu/utils/metrics.py`: one thread-safe,
process-global store of counters, gauges and histogram summaries, the
snapshot sections other planes register, and the node label.

This is the part the dispatch ledger (`engine/dispatchledger.py`), the
rows engine's megabatch route and the interpretive core (`core/`) call: `register`, `bump`, `gauge`,
`observe`, `snapshot`, `reset`, `register_snapshot_section`,
`register_reset_hook`, `node_name` and `set_node_name`, with the
reference's semantics and snapshot keys.

Not here yet: spans and `trace`, the watchdog, `add_time`, the Prometheus
exporter, trace-context propagation, and `dispatch_jit` (it reads JAX's
compile telemetry, and the reference's device annotation uses
`jax.profiler`); the port needs CUDA-event timing and a compile-cache
count in their place. The reference's `snapshot()` also attaches its
`perfscope` and `oplag` sections, which are not ported.
"""

from __future__ import annotations

import os
import threading

# Registered metric names (name -> description), as the reference keeps
# them; the names the port's ledger and engine emit, and any `register`ed.
COUNTERS: dict[str, str] = {
    "engine_dispatch_calls":
        "routed / fixed-backend kernel calls {family=...,backend=...} "
        "(engine/dispatchledger.py call_scope)",
    "engine_dispatch_ambient":
        "kernel dispatches with no call scope open",
    "engine_megabatch_rounds":
        "rounds whose dirty lanes reconciled through the fused bucketed "
        "dispatches (engine/dispatch.py apply_round_adaptive)",
    "engine_megabatch_docs": "docs reconciled on the megabatch route",
    "engine_megabatch_fallbacks":
        "rounds the megabatch planner priced onto the per-doc path",
    "rows_dispatch_failed":
        "rows-engine device dispatches that failed after admission",
    # the interpretive core (core/opset.py, core/bulkload.py)
    "core_changes_applied": "changes admitted by the host apply paths",
    "core_ops_applied": "ops inside admitted changes (host apply paths)",
    "core_diffs_emitted": "diff records produced by the interpretive apply",
    "core_bulk_fallbacks": "bulk builds that fell back to interpretive",
    "engine_bulk_built": "host-path documents built by the bulk loader",
    # the span-granularity text plane (core/textspans.py)
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
    # the move plane (core/moves.py)
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
}
GAUGES: dict[str, str] = {
    "core_queue_depth": "causal queue depth after the latest apply batch",
    "core_queue_bytes":
        "approximate host bytes held by the causal queue {estimate}",
    "obs_dispatch_amplification":
        "dispatches per dirty doc over the ledger window",
    "obs_dispatch_pad_waste_pct":
        "padded lanes computed for nobody over the ledger window, %",
    "obs_dispatch_per_round": "dispatches per round over the ledger window",
    "obs_dispatch_rounds_tracked": "rounds in the ledger window",
    "obs_megabatch_docs_per_dispatch":
        "docs per fused dispatch over the ledger window",
    "obs_megabatch_fill_pct":
        "docs over docs-lane capacity of the fused dispatches, %",
}
HISTOGRAMS: dict[str, str] = {
    "obs_dispatch_ledger_s": "dispatch ledger self-time per gauge refresh",
}
REGISTRY: dict[str, str] = {**COUNTERS, **GAUGES, **HISTOGRAMS}


def register(name: str, description: str, kind: str = "counter") -> None:
    """Register an extension metric name (plugins, tests, deployments)."""
    REGISTRY[name] = description
    {"counter": COUNTERS, "gauge": GAUGES,
     "histogram": HISTOGRAMS}[kind][name] = description


def _lk(labels: dict) -> tuple:
    """Canonical hashable label key (sorted (k, str(v)) pairs)."""
    if not labels:
        return ()
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _flat_key(name: str, lk: tuple) -> str:
    if not lk:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in lk) + "}"


class _Metrics:
    """Thread-safe store: every mutation takes self.lock."""

    def __init__(self):
        self.lock = threading.RLock()
        self.counters: dict[tuple, int] = {}
        self.gauges: dict[tuple, float] = {}
        # histogram summary: [count, sum, min, max]
        self.hists: dict[tuple, list] = {}

    def bump(self, _name: str, _n: int = 1, **labels) -> None:
        key = (_name, _lk(labels))
        with self.lock:
            self.counters[key] = self.counters.get(key, 0) + _n

    def gauge(self, _name: str, _value: float, **labels) -> None:
        with self.lock:
            self.gauges[(_name, _lk(labels))] = _value

    def observe(self, _name: str, _value: float, **labels) -> None:
        key = (_name, _lk(labels))
        with self.lock:
            h = self.hists.get(key)
            if h is None:
                self.hists[key] = [1, _value, _value, _value]
            else:
                h[0] += 1
                h[1] += _value
                h[2] = min(h[2], _value)
                h[3] = max(h[3], _value)

    def snapshot(self) -> dict:
        """Flat, json.dumps-safe view: counters and gauges as they are,
        histograms as `<name>_{count,sum,min,max}`; labeled series flatten
        to `name{k=v,...}` keys."""
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
        return out

    def reset(self) -> None:
        with self.lock:
            self.counters.clear()
            self.gauges.clear()
            self.hists.clear()


_global = _Metrics()


def bump(_name: str, _n: int = 1, **labels) -> None:
    _global.bump(_name, _n, **labels)


def gauge(_name: str, _value: float, **labels) -> None:
    _global.gauge(_name, _value, **labels)


def observe(_name: str, _value: float, **labels) -> None:
    _global.observe(_name, _value, **labels)


# Nested snapshot sections: a plane registers a provider, and its section
# rides every snapshot(). Providers run outside the metrics lock, return a
# json.dumps-clean dict (or None / {} to skip) and are pure functions of
# their plane's state, so two snapshots with no traffic between compare
# equal.
_section_providers: dict[str, object] = {}
_section_reset_hooks: list = []


def register_snapshot_section(name: str, provider) -> None:
    """Register (or replace) a nested snapshot section provider. A raising
    provider is skipped: telemetry never takes down its caller."""
    _section_providers[name] = provider


def register_reset_hook(hook) -> None:
    """A zero-argument hook that reset() calls, for planes whose snapshot
    section must clear with the store."""
    if hook not in _section_reset_hooks:
        _section_reset_hooks.append(hook)


def snapshot() -> dict:
    """The flat metrics view plus every registered section."""
    out = _global.snapshot()
    for name, provider in list(_section_providers.items()):
        try:
            sec = provider()
        except Exception:
            sec = None
        if sec:
            out[name] = sec
    return out


def reset() -> None:
    """Clear the store and every plane that registered a reset hook."""
    _global.reset()
    for hook in list(_section_reset_hooks):
        try:
            hook()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# node identity

_node_name: str | None = None
_node_name_read = False


def node_name() -> str | None:
    """This process's node label: AMTPU_NODE_NAME (read once) or whatever
    set_node_name() installed."""
    global _node_name, _node_name_read
    if not _node_name_read:
        _node_name_read = True
        _node_name = os.environ.get("AMTPU_NODE_NAME") or None
    return _node_name


def set_node_name(name: str | None) -> None:
    """Override (or with None: clear back to the environment) the node
    label."""
    global _node_name, _node_name_read
    if name is None:
        _node_name_read = False
        _node_name = None
    else:
        _node_name_read = True
        _node_name = str(name)
