"""Performance plane: build telemetry, phase attribution, memory gauges (the
port of `automerge_tpu/utils/perfscope.py`).

- **build telemetry**: `metrics.dispatch_jit` routes every device program
  call of both engines through `dispatch_begin()` / `dispatch_end()` here.
  The reference counts a jit compile-cache miss, observed through a
  `jax.monitoring` listener. The port compiles nothing at a call: its
  kernels are libraries built once (nvcc through
  `engine/cuda_kernels.build`, g++ through `native/__init__.py`, both
  named by content hash). So "retraced" on the port means that the
  dispatch had to build a library first. The two build paths call
  `note_build(name, seconds)`, which attributes the build to the
  dispatch open on the same thread through a thread-local marker stack
  (so attribution is thread-exact), or to the reserved
  "(unattributed)" row when none is open. A plain version on the CPU
  never builds.
- **per-kernel rows**: `dispatches`, `compiles` (dispatches that built),
  `compile_s` (build seconds), and, from the first dispatch of each
  (kernel, signature), `memory` and `cost`. A signature holds the shapes
  and dtypes of the call's tensors (inside lists, tuples and dicts too)
  and the values of its hashable statics; it never formats a tensor. The
  port's kernels take exact, unpadded lengths, so a long-lived service
  would meet a new signature at every batch size: a kernel keeps at most
  MAX_SIGNATURES of them, and past that its rows keep their last
  analysis.
  `memory` = {"argument", "output"}: the bytes of the call's tensor
  arguments and of its tensor results (`nbytes`), under the reference's
  section names; `cost` = {"bytes_accessed"}: argument plus output bytes.
  There is no `flops`: the port has no work count for these kernels, and
  XLA's or a TPU's numbers do not apply to them (the row carries
  `"flops": None` so a reader sees it was left out, not lost).
- **phase attribution**: `phase(name)` accumulates wall time into one of
  the registered PHASES, so a run self-reports where its time went.
- **memory gauges**: `sample_live_arrays` (throttled; every dispatch
  samples) keeps `obs_live_arrays_bytes` / `obs_live_arrays_peak_bytes`.
  On a CUDA device they read `torch.cuda.memory_allocated` of the
  dispatch's device; on a CPU device, the bytes of the resident tensors
  of every live engine on the CPU (`track_resident`; each engine's
  `device_bytes()`), so `peak >= live >= 0` holds there too.

Locking discipline: the store lock guards only dict arithmetic; metric
emission runs outside it, so this module adds no lock-order edge against
the metrics store.
"""

from __future__ import annotations

import functools
import threading
import time
import weakref
from contextlib import contextmanager

#: Registered phase names for `phase()`: the cross-layer wall-time rollup.
PHASES: dict[str, str] = {
    "pack": "columnar batch/rows packing on the host (engine/pack.py)",
    "dispatch": "kernel dispatch calls (metrics.dispatch_jit)",
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

#: seconds between live-footprint samples (dispatch sites sample
#: opportunistically)
LIVE_SAMPLE_INTERVAL_S = 0.5

#: signatures a kernel keeps (see the module docstring)
MAX_SIGNATURES = 256

_UNATTRIBUTED = "(unattributed)"

_tls = threading.local()


class _KernelStats:
    __slots__ = ("dispatches", "compiles", "compile_s", "signatures")

    def __init__(self):
        self.dispatches = 0
        self.compiles = 0        # dispatch windows that built a library
        self.compile_s = 0.0     # build seconds
        self.signatures: set = set()


class _Store:
    def __init__(self):
        self.lock = threading.Lock()
        self.kernels: dict[str, _KernelStats] = {}
        self.phases: dict[str, list] = {}     # name -> [seconds, count]
        self.live_bytes = 0
        self.live_peak = 0
        self._last_live = 0.0

    def kernel(self, name: str) -> _KernelStats:
        st = self.kernels.get(name)
        if st is None:
            st = self.kernels[name] = _KernelStats()
        return st


_store = _Store()

# Analysis rows survive metrics.reset(), as the reference's do: the bytes
# of a (kernel, signature) do not change between runs.
# kernel -> {"cost": {...}, "memory": {...}}
_analysis_lock = threading.Lock()
_analysis: dict[str, dict] = {}


class _Marker:
    """Per-dispatch build accumulator (thread-local; no lock)."""
    __slots__ = ("kernel", "builds", "build_s", "signature", "device",
                 "arg_bytes")

    def __init__(self, kernel: str):
        self.kernel = kernel
        self.builds = 0
        self.build_s = 0.0
        self.signature = None
        self.device = None
        self.arg_bytes = 0


# ---------------------------------------------------------------------------
# the build hook (the counterpart of the reference's jax.monitoring listener)


def note_build(name: str, seconds: float) -> None:
    """Called by `cuda_kernels.build` and `native._build_shared` after a
    library was built: attribute the build to the dispatch open on this
    thread, or count it under "(unattributed)"."""
    stack = getattr(_tls, "stack", None)
    if stack:
        stack[-1].builds += 1
        stack[-1].build_s += seconds
        return
    with _store.lock:
        st = _store.kernel(_UNATTRIBUTED)
        st.compiles += 1
        st.compile_s += seconds


# ---------------------------------------------------------------------------
# per-dispatch accounting (driven by metrics.dispatch_jit)


def _tensors(obj):
    """The torch tensors in a call's arguments or results (one level into
    tuples, lists and dicts, which is how both engines pass state)."""
    import torch
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            if isinstance(x, torch.Tensor):
                yield x
            elif isinstance(x, dict):
                yield from (v for v in x.values()
                            if isinstance(v, torch.Tensor))
    elif isinstance(obj, dict):
        yield from (v for v in obj.values() if isinstance(v, torch.Tensor))


def _nbytes(obj) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(obj))


def _signature(args, kwargs) -> tuple:
    """Abstract call signature: shapes/dtypes for tensors, recursing into
    lists, tuples and dicts; values for hashable statics; the type's name
    for anything else (a repr could format a tensor's values)."""
    def one(x):
        shape = getattr(x, "shape", None)
        dtype = getattr(x, "dtype", None)
        if shape is not None and dtype is not None:
            return ("a", tuple(shape), str(dtype))
        if isinstance(x, (list, tuple)):
            return ("l", tuple(one(v) for v in x))
        if isinstance(x, dict):
            return ("d", tuple((k, one(v)) for k, v in sorted(x.items())))
        try:
            hash(x)
            return ("s", x)
        except TypeError:
            return ("r", type(x).__qualname__)
    return (tuple(one(a) for a in args),
            tuple((k, one(v)) for k, v in sorted(kwargs.items())))


def dispatch_begin(kernel: str, fn, args: tuple, kwargs: dict):
    """Open a dispatch window: note the call's signature, device and
    argument bytes, and push the attribution marker. Returns the marker
    for dispatch_end()."""
    marker = _Marker(kernel)
    try:
        sig = _signature(args, kwargs)
    except Exception:
        sig = None
    if sig is not None:
        with _store.lock:
            st = _store.kernel(kernel)
            if sig not in st.signatures \
                    and len(st.signatures) < MAX_SIGNATURES:
                st.signatures.add(sig)
                marker.signature = sig     # analyze after the call
    flat = list(args) + list(kwargs.values())
    first = next(_tensors(flat), None)
    if first is not None:
        marker.device = first.device
        if marker.signature is not None:
            marker.arg_bytes = _nbytes(flat)
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(marker)
    return marker


def dispatch_end(marker, result=None) -> bool:
    """Close a dispatch window. Folds the marker's builds into the store,
    records the memory/cost rows of a new signature from the call's
    result, and returns True when the dispatch built a library (the
    ground truth behind `engine_kernels_retraced`)."""
    stack = getattr(_tls, "stack", None)
    if stack is not None:
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is marker:
                del stack[i]
                break
    built = marker.builds > 0
    with _store.lock:
        st = _store.kernel(marker.kernel)
        st.dispatches += 1
        if built:
            st.compiles += 1
            st.compile_s += marker.build_s
    from . import metrics
    if built:
        metrics.add_time("engine_kernel_compile", marker.build_s,
                         kernel=marker.kernel)
    if marker.signature is not None and marker.device is not None:
        _analyze(marker.kernel, marker.arg_bytes, _nbytes(result))
    sample_live_arrays(device=marker.device)
    return built


def _analyze(kernel: str, arg_bytes: int, out_bytes: int) -> None:
    """The one-time rows of a new (kernel, signature): the bytes the call
    took and gave. `flops` is None: the port has no work count here."""
    memory = {"argument": int(arg_bytes), "output": int(out_bytes)}
    cost = {"flops": None, "bytes_accessed": float(arg_bytes + out_bytes)}
    with _analysis_lock:
        _analysis[kernel] = {"cost": cost, "memory": memory}
    from . import metrics
    metrics.gauge("engine_kernel_bytes_accessed", cost["bytes_accessed"],
                  kernel=kernel)
    for section, v in memory.items():
        metrics.gauge("engine_kernel_hbm_bytes", v, kernel=kernel,
                      section=section)


# ---------------------------------------------------------------------------
# phase attribution


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
        with _store.lock:
            e = _store.phases.get(name)
            if e is None:
                _store.phases[name] = [dt, 1]
            else:
                e[0] += dt
                e[1] += 1


def phase_totals() -> dict[str, float]:
    """Accumulated seconds per phase since the last reset (one locked dict
    copy)."""
    with _store.lock:
        return {n: e[0] for n, e in _store.phases.items()}


def phased(name: str):
    """Decorator form of phase() for whole-function attribution."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with phase(name):
                return fn(*args, **kwargs)
        return wrapped
    return deco


# ---------------------------------------------------------------------------
# memory gauges


_engines_lock = threading.Lock()
_engines: "weakref.WeakSet" = weakref.WeakSet()


def track_resident(engine) -> None:
    """Count `engine` (a resident engine with `device` and
    `device_bytes()`) in the CPU footprint while it lives."""
    with _engines_lock:
        _engines.add(engine)


def _cpu_resident_bytes() -> int:
    with _engines_lock:
        engines = list(_engines)
    return sum(e.device_bytes() for e in engines if e.device.type == "cpu")


def sample_live_arrays(force: bool = False, device=None) -> int | None:
    """Throttled live-footprint sample; maintains the high-water mark.
    On a CUDA `device`: `torch.cuda.memory_allocated(device)`; on the CPU:
    the resident tensor bytes of every live engine there. Returns the
    sampled byte total (None when throttled or when no device is
    known)."""
    if device is None:
        return None
    now = time.monotonic()
    with _store.lock:
        if not force and now - _store._last_live < LIVE_SAMPLE_INTERVAL_S:
            return None
        _store._last_live = now
    if device.type == "cuda":
        import torch
        total = int(torch.cuda.memory_allocated(device))
    else:
        total = _cpu_resident_bytes()
    with _store.lock:
        _store.live_bytes = total
        if total > _store.live_peak:
            _store.live_peak = total
        peak = _store.live_peak
    from . import metrics
    metrics.gauge("obs_live_arrays_bytes", total)
    metrics.gauge("obs_live_arrays_peak_bytes", peak)
    return total


# ---------------------------------------------------------------------------
# snapshot / reset


def perf_snapshot() -> dict | None:
    """The `perf` section `metrics.snapshot()` embeds: per-kernel build
    telemetry (counts, build seconds, memory and cost rows), the
    cross-layer phase rollup, and the live footprint. None when nothing
    has been recorded since the last reset."""
    with _store.lock:
        kernels = {
            k: {"dispatches": st.dispatches,
                "compiles": st.compiles,
                "compile_s": round(st.compile_s, 6)}
            for k, st in _store.kernels.items()
            if st.dispatches or st.compiles or st.compile_s}
        if not kernels and not _store.phases and not _store.live_peak:
            return None
        phases = {n: {"s": round(s, 6), "count": c}
                  for n, (s, c) in _store.phases.items()}
        memory = None
        if _store.live_peak:
            memory = {"live_array_bytes": _store.live_bytes,
                      "live_array_peak_bytes": _store.live_peak}
    with _analysis_lock:
        for k, entry in _analysis.items():
            if k in kernels:
                kernels[k]["cost"] = dict(entry["cost"])
                kernels[k]["memory"] = dict(entry["memory"])
    out: dict = {"kernels": kernels}
    if phases:
        out["phases"] = phases
    if memory:
        out["memory"] = memory
    return out


def reset() -> None:
    """Clear per-run counters, phases and the footprint (metrics.reset()
    calls this). The signature sets and analysis rows survive, as the
    reference's do."""
    with _store.lock:
        for st in _store.kernels.values():
            st.dispatches = 0
            st.compiles = 0
            st.compile_s = 0.0
        _store.kernels = {k: st for k, st in _store.kernels.items()
                          if st.signatures}
        _store.phases.clear()
        _store.live_bytes = 0
        _store.live_peak = 0
        _store._last_live = 0.0


def reset_kernel_store() -> None:
    """Forget every kernel row, signature and analysis row too (a test's
    teardown: the next test sees the store as a fresh process would)."""
    reset()
    with _store.lock:
        _store.kernels.clear()
    with _analysis_lock:
        _analysis.clear()
