"""Performance plane, the phase half of `automerge_tpu/utils/perfscope.py`.

`phase(name)` accumulates wall time into one of the registered PHASES
(pack, dispatch, device_wait, readback, host_materialize, sync_wire,
span_merge), so a run self-reports where its time went across layers.
The sync service reads `phase_totals()` around a round flush and hands
the delta to the sampled ops that rode the round (`utils/oplag.py`), and
`metrics.snapshot()` embeds the rollup as its nested `perf` section.

Not here yet (ROADMAP item 7): the reference's compile telemetry
(`dispatch_begin` / `dispatch_end`, a `jax.monitoring` listener on
`/jax/core/compile/*` events, per-kernel XLA cost and memory analysis)
and its `jax.live_arrays()` footprint sample. On the port these become a
count of the kernel builds (`engine/cuda_kernels.py` builds each CUDA
source once a process) and `torch.cuda.memory_allocated` on the
service's device.
"""

from __future__ import annotations

import functools
import threading
import time
from contextlib import contextmanager

#: Registered phase names for `phase()`: the cross-layer wall-time rollup.
PHASES: dict[str, str] = {
    "pack": "columnar batch/rows packing on the host (engine/pack.py)",
    "dispatch": "kernel dispatch calls",
    "device_wait": "explicit host barriers on in-flight device work",
    "readback": "device->host readbacks (hash reads, the trusted barrier)",
    "host_materialize": "interpretive apply + snapshot materialization "
                        "(frontend/materialize.py)",
    "sync_wire": "wire encode/decode of sync frames (sync/frames.py)",
    "fleet_hashes": "fleet-wide convergence reads: the sharded hash "
                    "fan-out incl. per-shard dirty-lane reconciles",
    "span_merge": "span-granularity text-merge placement: run placement "
                  "walks + ElemList splices (core/textspans.py)",
}

_lock = threading.Lock()
_phases: dict[str, list] = {}     # name -> [seconds, count]


@contextmanager
def phase(name: str):
    """Accumulate wall time under one of the registered PHASES. Cheap (two
    perf_counter reads + one locked dict update), safe to nest; phases are
    attribution, not a partition: overlapping phases both count."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            e = _phases.get(name)
            if e is None:
                _phases[name] = [dt, 1]
            else:
                e[0] += dt
                e[1] += 1


def phase_totals() -> dict[str, float]:
    """Accumulated seconds per phase since the last reset (one locked dict
    copy)."""
    with _lock:
        return {n: e[0] for n, e in _phases.items()}


def phased(name: str):
    """Decorator form of phase() for whole-function attribution."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with phase(name):
                return fn(*args, **kwargs)
        return wrapped
    return deco


def perf_snapshot() -> dict | None:
    """The `perf` section `metrics.snapshot()` embeds: the phase rollup.
    None when nothing has been recorded since the last reset (so an
    untouched process still snapshots without it)."""
    with _lock:
        if not _phases:
            return None
        return {"phases": {n: {"s": round(s, 6), "count": c}
                           for n, (s, c) in _phases.items()}}


def reset() -> None:
    """Clear the phase rollup (metrics.reset() calls this)."""
    with _lock:
        _phases.clear()
