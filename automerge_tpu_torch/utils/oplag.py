"""Op-lifecycle / convergence-lag plane: sampled end-to-end op lineage.

Convergence LATENCY — not just eventual convergence — is the operative
metric for a CRDT fleet at scale (PAPERS.md: "Operational Concurrency
Control in the Face of Arbitrary Scale and Latency", arxiv 1303.7462).
Before this module the repo measured rounds and reads but never an OP:
nothing said how long an admitted change waits in the coalescing queue,
rides a flush, crosses the wire, and becomes converged state at a peer.
This plane samples ~1 of every N admitted ingresses (N =
``AMTPU_OPLAG_SAMPLE``, default 64; ``0`` disables and unsampled ops pay
zero profiler work) and attributes its whole life to stages:

    causal_queue   parked causally-unready in the interpretive queue
                   (core/opset.py) until its deps arrived
    buffer_wait    ingress appended to the epoch ingestion buffer -> its
                   epoch sealed into a coalesced round (sync/epochs.py;
                   epoch-mode services only — the group-commit park)
    queue_wait     sealed (or admitted, in locked mode) -> its coalesced
                   round flush started (sync/service.py `_rows_ingest`
                   -> `_flush_locked`)
    flush          the round flush that carried it (host admission +
                   device dispatch), wall time
    pack           host packing attributed to that flush (perfscope
                   phase delta across the flush)
    dispatch       jitted dispatch time attributed to that flush
    device_wait    explicit device barriers attributed to that flush
    origin_total   admission -> flush complete at the ORIGIN node (the
                   locally-durable latency; the end-to-end number for a
                   node with no peers, e.g. bench configs)
    wire           sender's transport write -> receiver's parse
                   (cross-process: wall-clock, subject to host clock
                   skew — exact on a single host, indicative across)
    peer_apply     receiver parse -> the change admitted at the peer
    converge       origin admission -> admitted at the peer: the fleet
                   replication lag (wall-clock, same skew caveat)

The sampled op carries a **provenance id**: it rides the flight-recorder
event ring (``oplag_admit`` / ``oplag_stage`` events) and the wire as an
``"oplag"`` message key (`sync/frames.py:OPLAG_KEY`) stamped by
`Connection.send_msg` beside the existing ``trace:`` header — same
envelope rules: it lives in the JSON part of both wire forms, and peers
that predate it ignore it. The receiving peer records the wire /
peer_apply / converge stages **whatever its own sampling rate is** (the
sender paid the sampling decision; pulling `{"metrics": "pull"}` from
any replica therefore yields fleet-wide replication-lag histograms).

Surfaces:

- ``sync_op_lag_s{stage=...}`` histogram (count/sum/min/max) per stage;
- ``sync_op_lag_p50_s`` / ``sync_op_lag_p99_s`` gauges per stage
  (recomputed from a bounded per-stage reservoir every few samples);
- the nested ``"oplag"`` section of `metrics.snapshot()` — exact
  reservoir percentiles + sample rate (bench embeds it per config; the
  `python -m automerge_tpu.perf contention` report reads it);
- `sync_ops_sampled` counter (how many ops the plane tracked).

Overhead discipline: every hook starts with a cached ``rate <= 0``
check, so ``AMTPU_OPLAG_SAMPLE=0`` reduces the whole plane to one int
compare per call site. With sampling on, non-sampled ops pay one locked
counter increment at admission and nothing anywhere else.
"""

from __future__ import annotations

import binascii
import itertools
import os
import threading
import time
import zlib
from collections import OrderedDict, deque

from . import metrics

#: default 1-in-N sampling of admitted ingresses (AMTPU_OPLAG_SAMPLE)
DEFAULT_SAMPLE = 64

#: per-stage reservoir size backing the p50/p99 estimates (rolling —
#: the percentiles track the most recent window, not all history)
RESERVOIR = 512

#: recompute the p50/p99 gauges every this many samples per stage
_GAUGE_REFRESH = 32

#: registered stage names (label values of sync_op_lag_s; the docstring
#: above and docs/OBSERVABILITY.md define each)
STAGES = ("causal_queue", "buffer_wait", "queue_wait", "pack", "dispatch",
          "device_wait", "flush", "origin_total", "wire", "peer_apply",
          "converge")

#: bound on docs awaiting a wire send and on parked causal-queue marks
_AWAIT_MAX = 256
_PARK_MAX = 4096

#: seconds a flushed token stays attachable to outgoing messages. Gossip
#: for a flushed round happens within milliseconds of the flush (the
#: same drain loop); anything older is a LATER change of the same doc
#: re-shipping a stale header, which would record a spurious
#: ever-growing converge lag at the peer.
WIRE_TTL_S = 5.0

_lock = threading.Lock()
_rate: int | None = None          # resolved lazily from the env
# admissions-since-reset sampling clock: an itertools.count, whose
# next() is a single C-level (GIL-atomic) operation — concurrent
# epoch-mode writers admit without ever touching _lock
_counter = itertools.count(1)
_awaiting_wire: "OrderedDict[str, Token]" = OrderedDict()
_parked: "OrderedDict[tuple, float]" = OrderedDict()
_stage_res: dict[str, deque] = {}
_stage_count: dict[str, int] = {}


class Token:
    """One sampled op in flight: provenance id + origin timestamps."""

    __slots__ = ("id", "doc", "t0", "wall", "t_sealed", "t_flushed")

    def __init__(self, doc: str):
        self.id = binascii.hexlify(os.urandom(4)).decode()
        self.doc = doc
        self.t0 = time.perf_counter()
        self.wall = time.time()
        self.t_sealed = 0.0
        self.t_flushed = 0.0


def sample_rate() -> int:
    """Resolved 1-in-N rate (0 = disabled). Read once from
    AMTPU_OPLAG_SAMPLE, overridable via set_sample_rate() (tests,
    embedders)."""
    global _rate
    r = _rate
    if r is None:
        try:
            r = int(os.environ.get("AMTPU_OPLAG_SAMPLE",
                                   str(DEFAULT_SAMPLE)))
        except ValueError:
            r = DEFAULT_SAMPLE
        _rate = r = max(0, r)
    return r


def set_sample_rate(n: int | None) -> None:
    """Override (or with None: re-read from the env) the sampling rate."""
    global _rate, _counter
    with _lock:
        _rate = None if n is None else max(0, int(n))
        _counter = itertools.count(1)


def enabled() -> bool:
    return sample_rate() > 0


# ---------------------------------------------------------------------------
# stage recording


def _percentile(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, max(0, int(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


def record_stage(op_id: str, stage: str, seconds: float) -> None:
    """One lifecycle stage of sampled op `op_id` took `seconds`. Updates
    the histogram, the flight-recorder lineage trail, and (throttled)
    the percentile gauges + reservoir."""
    seconds = max(0.0, float(seconds))
    metrics.observe("sync_op_lag_s", seconds, stage=stage)
    try:
        from . import flightrec
        flightrec.record("oplag_stage", id=op_id, stage=stage,
                         s=round(seconds, 6))
    except Exception:
        pass
    with _lock:
        dq = _stage_res.get(stage)
        if dq is None:
            dq = _stage_res[stage] = deque(maxlen=RESERVOIR)
        dq.append(seconds)
        n = _stage_count[stage] = _stage_count.get(stage, 0) + 1
        refresh = (n % _GAUGE_REFRESH == 1)
        vals = sorted(dq) if refresh else None
    if vals:
        metrics.gauge("sync_op_lag_p50_s", round(_percentile(vals, 0.50), 6),
                      stage=stage)
        metrics.gauge("sync_op_lag_p99_s", round(_percentile(vals, 0.99), 6),
                      stage=stage)


# ---------------------------------------------------------------------------
# origin side: admission -> flush


def admit(doc_id: str) -> Token | None:
    """Sampling decision at ingress (sync/service.py). Returns a Token
    for the 1-in-N sampled admission, None otherwise. The caller parks
    the token until its round flushes, then hands it to flushed()."""
    n = sample_rate()
    if n <= 0:
        return None
    if next(_counter) % n:
        # the common path: one GIL-atomic counter tick, no lock — an
        # unsampled admission must stay nearly free even with many
        # concurrent epoch-mode writers
        return None
    tok = Token(doc_id)
    metrics.bump("sync_ops_sampled")
    try:
        from . import flightrec
        flightrec.record("oplag_admit", id=tok.id, doc=doc_id)
    except Exception:
        pass
    return tok


def sealed(tok: Token) -> None:
    """`tok`'s ingress left the epoch ingestion buffer (sync/epochs.py
    seal). STAMP ONLY — this runs under the service lock, so it must
    not touch the registry (histogram locks, flightrec, the periodic
    percentile refresh would inflate exactly the lock-hold time the
    contention plane measures); flushed() records the buffer_wait
    stage from the stamp in the deferred _drain_lag_records pass. The
    later queue_wait stage counts from the seal, keeping the stages
    additive (buffer_wait + queue_wait = admission -> flush start)."""
    tok.t_sealed = time.perf_counter()


def flushed(tok: Token, flush_start: float, flush_s: float,
            phases: dict | None = None) -> None:
    """The round carrying `tok` flushed: record queue_wait / flush /
    origin_total plus the perfscope phase deltas the flush accumulated
    (pack / dispatch / device_wait — the attribution is the ROUND's, so
    every sampled op in the round reports the stage time it actually
    experienced). Then park the token awaiting its wire send."""
    if tok.t_sealed:
        # deferred from sealed() — see its stamp-only contract
        record_stage(tok.id, "buffer_wait", tok.t_sealed - tok.t0)
    record_stage(tok.id, "queue_wait",
                 flush_start - (tok.t_sealed or tok.t0))
    record_stage(tok.id, "flush", flush_s)
    for stage in ("pack", "dispatch", "device_wait"):
        v = (phases or {}).get(stage, 0.0)
        if v > 0.0:
            record_stage(tok.id, stage, v)
    record_stage(tok.id, "origin_total", time.perf_counter() - tok.t0)
    tok.t_flushed = time.perf_counter()
    with _lock:
        _awaiting_wire[tok.doc] = tok
        while len(_awaiting_wire) > _AWAIT_MAX:
            _awaiting_wire.popitem(last=False)


def flush_boundary(doc_ids) -> None:
    """A new round flushed for these docs: awaiting-wire tokens from
    EARLIER rounds of the same docs are stale — a later change's message
    must not re-ship their header (the peer would record a spurious,
    ever-growing converge lag for an op that long converged). The
    service calls this after every flush, BEFORE parking the round's own
    sampled tokens. One unlocked empty-check, then a walk bounded by the
    (≤ _AWAIT_MAX) awaiting table, not the round size."""
    if not _awaiting_wire or sample_rate() <= 0:
        return
    with _lock:
        for d in [d for d in _awaiting_wire if d in doc_ids]:
            del _awaiting_wire[d]


# ---------------------------------------------------------------------------
# wire side: Connection.send_msg / _receive_msg


def wire_header(doc_id: str) -> str | None:
    """Compact `id,t_admit,t_send` header for an outgoing change-bearing
    message of `doc_id`, when a sampled op of that doc awaits shipping.
    The token stays parked across sends (a node gossips to MANY peers,
    all within the same post-flush drain), so every peer's replication
    lag records; flush_boundary() retires it when a later round of the
    doc flushes, and WIRE_TTL_S retires it by age as a backstop."""
    if sample_rate() <= 0:
        return None
    now = time.perf_counter()
    with _lock:
        tok = _awaiting_wire.get(doc_id)
        if tok is not None and now - tok.t_flushed > WIRE_TTL_S:
            del _awaiting_wire[doc_id]     # stale: a long-past flush
            tok = None
    if tok is None:
        return None
    return f"{tok.id},{tok.wall:.6f},{time.time():.6f}"


def wire_receive(header) -> tuple | None:
    """Parse an incoming oplag header and record the `wire` stage.
    Returns an opaque context for peer_applied(), or None for absent or
    malformed headers. Recording is unconditional on the local sampling
    rate — the SENDER paid the sampling decision, and fleet replication
    lag must be observable on every receiving replica."""
    if not isinstance(header, str):
        return None
    try:
        op_id, t_admit, t_send = header.split(",")
        t_admit, t_send = float(t_admit), float(t_send)
    except (ValueError, AttributeError):
        return None
    now = time.time()
    record_stage(op_id, "wire", now - t_send)
    return (op_id, t_admit, time.perf_counter())


def peer_applied(ctx: tuple | None) -> None:
    """The message whose header produced `ctx` finished applying at this
    peer: record peer_apply and the end-to-end converge lag."""
    if ctx is None:
        return
    op_id, t_admit, t_recv = ctx
    record_stage(op_id, "peer_apply", time.perf_counter() - t_recv)
    record_stage(op_id, "converge", time.time() - t_admit)


# ---------------------------------------------------------------------------
# interpretive causal queue (core/opset.py)


def _park_sampled(actor: str, seq: int, n: int) -> bool:
    """Deterministic 1-in-n pick for causal-queue parking: hash-based
    (not counter-based) so a change re-seen across apply batches keeps
    its original decision — a counter would eventually 'sample' a
    long-parked change with a fresh (wrong) park time."""
    return zlib.crc32(f"{actor}:{seq}".encode()) % n == 0


def queue_park(actor: str, seq: int) -> None:
    """A change parked causally-unready in the interpretive queue
    (1-in-N hash-sampled, same rate as admissions)."""
    if sample_rate() <= 0:
        return
    queue_park_batch([(actor, seq)])


def queue_park_batch(pairs) -> None:
    """Park marks for a whole apply batch's leftover queue in ONE lock
    acquisition, sampling each (actor, seq) at 1/N — a persistently
    out-of-causal-order peer must not turn every apply batch into an
    O(queue) locked walk, and unsampled parked changes record nothing."""
    n = sample_rate()
    if n <= 0:
        return
    picked = [(a, s) for a, s in pairs if _park_sampled(a, s, n)]
    if not picked:
        return
    now = time.perf_counter()
    with _lock:
        for key in picked:
            _parked.setdefault(key, now)
        while len(_parked) > _PARK_MAX:
            _parked.popitem(last=False)


def queue_admitted(actor: str, seq: int) -> None:
    """A change left the causal queue and applied; records how long its
    dependencies kept it parked. Cheap for never-parked changes (the
    common case): one unlocked empty-dict check."""
    if not _parked or sample_rate() <= 0:
        return
    with _lock:
        t = _parked.pop((actor, seq), None)
    if t is not None:
        record_stage(f"{actor}:{seq}", "causal_queue",
                     time.perf_counter() - t)


# ---------------------------------------------------------------------------
# snapshot / reset


def lag_snapshot() -> dict | None:
    """The nested `"oplag"` section of metrics.snapshot(): per-stage
    reservoir percentiles (`p50_s`/`p90_s`/`p99_s`/`max_s` over the last
    RESERVOIR samples) + lifetime counts + the active sample rate. None
    when nothing has been recorded since reset (so an idle process still
    snapshots flat)."""
    with _lock:
        if not _stage_count:
            return None
        res = {s: sorted(dq) for s, dq in _stage_res.items() if dq}
        counts = dict(_stage_count)
        rate = sample_rate()
    stages = {}
    for s, vals in res.items():
        stages[s] = {
            "count": counts.get(s, len(vals)),
            "p50_s": round(_percentile(vals, 0.50), 6),
            "p90_s": round(_percentile(vals, 0.90), 6),
            "p99_s": round(_percentile(vals, 0.99), 6),
            "max_s": round(vals[-1], 6),
        }
    return {"sample_rate": rate, "stages": stages}


def reset() -> None:
    """Clear reservoirs, counters, and in-flight tables (metrics.reset()
    calls this). The sampling rate survives — it mirrors the env/explicit
    configuration, not run state."""
    global _counter
    with _lock:
        _counter = itertools.count(1)
        _awaiting_wire.clear()
        _parked.clear()
        _stage_res.clear()
        _stage_count.clear()


def _reload_for_tests() -> None:
    """Drop the cached AMTPU_OPLAG_SAMPLE rate (the next check re-reads
    the env) and clear the plane's state."""
    set_sample_rate(None)
    reset()
