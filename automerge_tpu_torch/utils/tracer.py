"""The trace plane: sampled end-to-end change lifecycle tracing with
cross-process span stitching (docs/OBSERVABILITY.md "Trace plane").

Every latency figure the other planes report is a single end-to-end
number — the docledger's convergence rings, the tenant plane's per-
tenant p99 — with no decomposition of *where* the time goes between a
client mutation and remote convergence. This module stamps a trace
context on a deterministically sampled change at frontend finalize
(``api._apply_new_change``) and records a bounded span at every stage
the change crosses:

    finalize         change construction + local apply (frontend)
    governor_delay   admission-governor park before epoch append
    queue_wait       epoch-buffer admission -> epoch seal
    coalesce_wait    epoch seal -> its flush round starting
    dispatch         the flush round's wall time (joined to the
                     dispatch ledger's folded round: amplification and
                     pad-waste ride the span's metadata)
    wire_serialize   columnar frame encode on the sending connection
    wire             socket send -> remote receive (wall-clock delta;
                     cross-host skew is disclosed, not corrected)
    remote_decode    frame decode on the receiving connection
    remote_admission frame apply under the receiver's apply lock
    visibility       admission -> the change's doc appearing in a
                     converged-hash read

Sampling is 1-in-N by ``zlib.crc32(f"{actor}:{seq}")`` so every process
— and both ends of a connection — make the same decision without
coordination. ``AMTPU_TRACE_SAMPLE`` unset (the default) keeps the
plane INERT: every hook reduces to one cached boolean check, and the
wire envelope carries no trace key (byte-identical frames — the bench
config-19 parity gate).

Cross-process stitching: the sending connection pops the doc's awaiting
traces and ships each one's accumulated spans inside the change-frame
envelope (``frames.TRACEPLANE_KEY``). The receiver records its own
spans RELATIVE TO THE ORIGIN's wall epoch and completes ONE trace whose
spans cover both processes — the single cross-process critical path the
fleet megabatching arc divides. Receivers record
unconditionally of their local rate: the sender paid the sampling
decision (the oplag precursor's contract).

House ledger contract (docledger/dispatchledger/tenantledger):

- bounded everything — the finalized handoff table, the per-doc
  awaiting tables, the completed ring — with DISCLOSED truncation
  (``dropped``/``expired`` counters, never silent loss);
- ``section()`` is PURE — no wall-clock reads, no lock ordering
  surprises — and rides ``metrics.register_snapshot_section`` so every
  snapshot consumer (fleet collector, doctor, bench detail) sees it;
- ``obs_trace_*`` gauges refresh on the MUTATION path (every
  GAUGE_REFRESH completions), never on export;
- ``self_seconds()`` duty accounting, gated in bench config 19 under
  the same 2% budget as the other ledgers.

In-flight traces that never complete (an unreachable peer, a doc with
no hash reader) expire after ``TTL_S`` and are counted ``expired`` —
the completeness gauge's honest denominator, never a leak.
"""

from __future__ import annotations

import os
import threading
import time
import zlib
from collections import OrderedDict, deque

from . import flightrec, metrics

#: lifecycle stages, in critical-path order (the waterfall's row order)
STAGES = (
    "finalize", "governor_delay", "queue_wait", "coalesce_wait",
    "dispatch", "megabatch", "wire_serialize", "wire", "remote_decode",
    "remote_admission", "visibility",
)

#: completed-trace ring capacity (AMTPU_TRACE_RING)
DEFAULT_RING = 256
#: finalized-but-unadmitted handoff entries kept per thread
PENDING_MAX = 8
#: per-table cap on docs with awaiting traces (oldest doc retired first)
AWAIT_MAX = 256
#: traces shipped per wire header (a storm of sampled changes on one
#: doc must not balloon the envelope)
HEADER_MAX = 4
#: in-flight traces older than this are retired as expired
TTL_S = 10.0
#: refresh the obs_trace_* gauges every this many mutations
GAUGE_REFRESH = 16
#: slowest completed exemplars surfaced by section()/the CLI waterfall
EXEMPLARS = 4

_rate: int | None | bool = False     # False = not yet read from env
_rate_lock = threading.Lock()


def sample_rate() -> int | None:
    """1-in-N sampling rate from AMTPU_TRACE_SAMPLE, or None when the
    plane is disabled (unset/0/garbage — the default). Cached; tests
    override via set_sample_rate()."""
    global _rate
    r = _rate
    if r is False:
        with _rate_lock:
            if _rate is False:
                try:
                    n = int(os.environ.get("AMTPU_TRACE_SAMPLE", "0"))
                except ValueError:
                    n = 0
                _rate = n if n > 0 else None
            r = _rate
    return r


def set_sample_rate(n: int | None) -> None:
    """Override the sampling rate (tests, the bench, the smoke).
    ``None`` disables the plane."""
    global _rate
    with _rate_lock:
        _rate = n if (n is None or n > 0) else None


def _reload_for_tests() -> None:
    """Drop the cached rate so the next check re-reads the env."""
    global _rate
    with _rate_lock:
        _rate = False


def enabled() -> bool:
    return sample_rate() is not None


def sampled(actor: str, seq: int) -> bool:
    """The deterministic coordination-free sampling decision: every
    process hashes (actor, seq) the same way."""
    n = sample_rate()
    if n is None:
        return False
    return zlib.crc32(f"{actor}:{seq}".encode()) % n == 0


def _ring_cap() -> int:
    try:
        n = int(os.environ.get("AMTPU_TRACE_RING", str(DEFAULT_RING)))
    except ValueError:
        n = DEFAULT_RING
    return max(8, n)


class _Trace:
    """One sampled change's lifecycle. Mutated only under the plane
    lock after the thread-local finalize handoff."""

    __slots__ = ("tid", "actor", "seq", "doc", "t0_wall", "t0_perf",
                 "spans", "role", "origin", "meta", "born", "mark")

    def __init__(self, actor: str, seq: int):
        self.tid = f"{actor}.{seq}"
        self.actor = actor
        self.seq = seq
        self.doc: str | None = None
        self.t0_wall = time.time()
        self.t0_perf = time.perf_counter()
        self.spans: list[list] = []      # [stage, rel_start_s, dur_s]
        self.role = "origin"
        self.origin = metrics.node_name() or "local"
        self.meta: dict = {}
        self.born = self.t0_perf
        self.mark = 0.0                  # last stage boundary (perf)

    def rel(self, t_perf: float) -> float:
        """Origin-epoch-relative seconds for a local perf stamp. On the
        remote side t0_wall is the ORIGIN's wall epoch and t0_perf the
        local receive stamp re-based onto it (see wire_receive)."""
        return t_perf - self.t0_perf

    def span(self, stage: str, start_perf: float, end_perf: float):
        self.spans.append([stage, round(self.rel(start_perf), 6),
                           round(max(0.0, end_perf - start_perf), 6)])

    def to_dict(self) -> dict:
        crit = 0.0
        if self.spans:
            crit = max(s[1] + s[2] for s in self.spans)
        return {
            "tid": self.tid, "doc": self.doc, "actor": self.actor,
            "seq": self.seq, "role": self.role, "origin": self.origin,
            "stitched": self.role == "stitched",
            "crit_s": round(crit, 6),
            "spans": [list(s) for s in self.spans],
            "meta": dict(self.meta),
        }


class TracePlane:
    """Process-global trace registry: the finalize handoff, the doc-
    keyed awaiting tables for each deferred stage boundary, and the
    bounded completed ring."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tls = threading.local()
        # doc id -> [traces] parked between admission and round flush
        self._awaiting_flush: OrderedDict[str, list] = OrderedDict()
        # doc id -> [traces] parked between round flush and wire send
        # (a doc with no peer completes from here at hash visibility)
        self._awaiting_wire: OrderedDict[str, list] = OrderedDict()
        # doc id -> [traces] parked between remote admission and the
        # converged-hash read that makes the change visible
        self._awaiting_visible: OrderedDict[str, list] = OrderedDict()
        self._completed: deque = deque(maxlen=_ring_cap())
        self._sampled = 0        # origin-side sampled finalizes
        self._received = 0       # sender-stamped traces adopted here
        self._handed_off = 0     # traces shipped inside a wire header
        self._done = 0           # traces completed at visibility here
        self._stitched = 0       # ... of which carry both processes
        self._expired = 0        # TTL retirements (incompleteness)
        self._dropped = 0        # bounded-table overflow retirements
        self._mutations = 0
        self._self_s = 0.0
        self._self_s_flushed = 0.0
        self._worst_crit = 0.0

    # -- frontend finalize ------------------------------------------------

    def finalize_begin(self, actor: str, seq: int):
        """Called by api._apply_new_change BEFORE change construction.
        Returns the trace for the matching finalize_end, or None when
        the plane is off or (actor, seq) is not sampled."""
        if not sampled(actor, seq):
            return None
        t0 = time.perf_counter()
        tr = _Trace(actor, seq)
        with self._lock:
            self._sampled += 1
            self._self_s += time.perf_counter() - t0
        return tr

    def finalize_end(self, tr) -> None:
        """The change is constructed and locally applied: record the
        finalize span and park the trace on THIS thread for the service
        admission that follows (set_doc on the same thread claims it)."""
        if tr is None:
            return
        t = time.perf_counter()
        tr.span("finalize", tr.t0_perf, t)
        tr.mark = t
        pend = getattr(self._tls, "pending", None)
        if pend is None:
            pend = self._tls.pending = []
        pend.append(tr)
        if len(pend) > PENDING_MAX:      # bounded: oldest unclaimed out
            del pend[0]
            with self._lock:
                self._dropped += 1

    def origin_ingress(self, pairs) -> None:
        """Engine-service writers hand the service Change objects
        directly (bench storms, native ingest) — there is no frontend
        finalize to stamp them. Start the sampled ones' lifecycle at the
        service boundary instead (zero-length finalize). A frontend-
        finalized trace already pending on this thread keeps its real
        finalize span (dedup by trace id); applies running under
        remote_apply() (a connection receive) never originate — the
        sender's stitched context owns that lifecycle."""
        if not enabled() or getattr(self._tls, "remote", False):
            return
        pend = getattr(self._tls, "pending", None)
        have = {tr.tid for tr in pend} if pend else ()
        started = []
        for actor, seq in pairs:
            if not sampled(actor, seq) or f"{actor}.{seq}" in have:
                continue
            tr = _Trace(actor, seq)
            tr.span("finalize", tr.t0_perf, tr.t0_perf)
            tr.mark = tr.t0_perf
            started.append(tr)
        if not started:
            return
        if pend is None:
            pend = self._tls.pending = []
        pend.extend(started)
        with self._lock:
            self._sampled += len(started)
            if len(pend) > PENDING_MAX:
                self._dropped += len(pend) - PENDING_MAX
                del pend[:len(pend) - PENDING_MAX]

    def remote_apply(self):
        """Context manager a connection wraps around a received frame's
        apply: origin_ingress under it is a no-op, so a remote change is
        never double-traced as a local origin."""
        plane = self

        class _Remote:
            def __enter__(self):
                plane._tls.remote = True

            def __exit__(self, *exc):
                plane._tls.remote = False
                return False

        return _Remote()

    # -- service admission -> flush ---------------------------------------

    def admit(self, doc_id: str, delay_s: float = 0.0) -> None:
        """Service ingress admitted a frame for doc_id on this thread:
        claim the thread's finalized traces, bind the doc, record the
        governor park and open the queue_wait stage."""
        if not enabled():
            return
        pend = getattr(self._tls, "pending", None)
        if not pend:
            return
        t0 = time.perf_counter()
        traces, pend[:] = pend[:], []
        for tr in traces:
            tr.doc = doc_id
            if delay_s > 0.0:
                tr.span("governor_delay", t0 - delay_s, t0)
            tr.mark = t0
        with self._lock:
            self._park_locked(self._awaiting_flush, doc_id, traces)
            self._self_s += time.perf_counter() - t0

    def sealed(self, doc_ids) -> None:
        """Epoch seal boundary — STAMP ONLY (called under the service
        lock; recording is deferred to flush_round outside it)."""
        if not enabled() or not self._awaiting_flush:
            return
        t0 = time.perf_counter()
        with self._lock:
            for d in doc_ids:
                for tr in self._awaiting_flush.get(d, ()):
                    if "sealed" not in tr.meta:
                        tr.meta["sealed"] = t0
            self._self_s += time.perf_counter() - t0

    def flush_round(self, round_docs, round_no: int,
                    t_start: float, dur_s: float) -> None:
        """A coalesced flush round covering round_docs finished (called
        OUTSIDE the service lock, before handler gossip — every trace is
        parked in the awaiting-wire table before its doc's message
        leaves). Records queue_wait / coalesce_wait / dispatch and joins
        the dispatch ledger's folded round."""
        if not enabled() or not self._awaiting_flush or round_docs is None:
            return
        t0 = time.perf_counter()
        t_end = t_start + dur_s
        rd = self._round_join()
        with self._lock:
            for d in round_docs:
                traces = self._awaiting_flush.pop(d, None)
                if not traces:
                    continue
                for tr in traces:
                    t_seal = tr.meta.pop("sealed", t_start)
                    tr.span("queue_wait", tr.mark, t_seal)
                    tr.span("coalesce_wait", t_seal, t_start)
                    tr.span("dispatch", t_start, t_end)
                    tr.mark = t_end
                    if rd is not None:
                        tr.meta["round"] = rd.get("round", round_no)
                        if rd.get("amp") is not None:
                            tr.meta["amp"] = rd["amp"]
                        if rd.get("pad_waste_pct") is not None:
                            tr.meta["pad_waste_pct"] = rd["pad_waste_pct"]
                        mega = rd.get("mega")
                        if mega:
                            # this change rode a fused multi-doc round
                            # (engine/dispatch.py apply_round_adaptive);
                            # the span shadows "dispatch" — same window,
                            # tagged so `perf explain` can show which
                            # fused round carried the doc's ops
                            tr.span("megabatch", t_start, t_end)
                            tr.meta["mega_buckets"] = mega.get("buckets")
                            tr.meta["mega_docs"] = mega.get("docs")
                            if mega.get("pad_waste_pct") is not None:
                                tr.meta["mega_pad_waste_pct"] = (
                                    mega["pad_waste_pct"])
                    else:
                        tr.meta["round"] = round_no
                self._park_locked(self._awaiting_wire, d, traces)
            self._expire_locked(t0)
            self._self_s += time.perf_counter() - t0

    def _round_join(self) -> dict | None:
        """The dispatch-ledger join: the most recent folded round's
        amplification / pad-waste, when that ledger is on (lazy import —
        the engine must not become a hard dependency of the plane)."""
        try:
            from ..engine import dispatchledger
            if dispatchledger.enabled():
                return dispatchledger.last_round_summary()
        except Exception:
            pass
        return None

    # -- wire: stitching --------------------------------------------------

    def wire_header(self, doc_id: str, serialize_s: float = 0.0):
        """Pop doc_id's post-flush traces for the send path. Returns the
        JSON-able header the envelope carries (the sender's accumulated
        spans + the origin wall epoch), or None when nothing is awaiting
        — the unset/unsampled envelope stays byte-identical."""
        if not enabled() or not self._awaiting_wire:
            return None
        t0 = time.perf_counter()
        with self._lock:
            traces = self._awaiting_wire.pop(doc_id, None)
            if not traces:
                self._self_s += time.perf_counter() - t0
                return None
            if len(traces) > HEADER_MAX:
                self._dropped += len(traces) - HEADER_MAX
                traces = traces[-HEADER_MAX:]
            hdr = []
            for tr in traces:
                tr.span("wire_serialize", t0 - serialize_s, t0)
                hdr.append({
                    "tid": tr.tid, "actor": tr.actor, "seq": tr.seq,
                    "t0": round(tr.t0_wall, 6),
                    "sent": round(time.time(), 6),
                    "origin": tr.origin,
                    "spans": tr.spans,
                    "meta": tr.meta,
                })
                self._handed_off += 1
            self._mutations += 1
            if self._mutations % GAUGE_REFRESH == 0:
                self._refresh_gauges_locked()
            self._self_s += time.perf_counter() - t0
        return hdr

    def wire_receive(self, hdr, doc_id: str | None = None):
        """Adopt sender-stamped traces from a received envelope header.
        Records the wire span (wall-clock delta — same-host skew is
        noise, cross-host skew is disclosed in the docs, not corrected)
        and returns the trace list for remote_admitted(). Recording is
        UNCONDITIONAL of the local rate: the sender paid the sampling
        decision."""
        if not hdr:
            return None
        t0 = time.perf_counter()
        now_wall = time.time()
        out = []
        try:
            for h in hdr[:HEADER_MAX]:
                tr = _Trace(str(h["actor"]), int(h["seq"]))
                tr.doc = doc_id
                tr.role = "stitched"
                tr.origin = str(h.get("origin", "?"))
                tr.t0_wall = float(h["t0"])
                # re-base the local perf clock onto the origin's wall
                # epoch: rel(local perf stamp) continues the sender's
                # timeline (minus inter-host skew)
                tr.t0_perf = t0 - (now_wall - tr.t0_wall)
                tr.spans = [list(s) for s in h.get("spans", ())][:32]
                tr.meta = dict(h.get("meta") or {})
                sent = float(h.get("sent", now_wall))
                wire_start = t0 - max(0.0, now_wall - sent)
                tr.span("wire", wire_start, t0)
                tr.mark = t0
                out.append(tr)
        except (KeyError, TypeError, ValueError):
            # a malformed header from a peer must never break apply
            out = out or None
        if out:
            with self._lock:
                self._received += len(out)
                self._self_s += time.perf_counter() - t0
        return out

    def remote_admitted(self, traces, doc_id: str,
                        decode_s: float = 0.0,
                        admission_s: float = 0.0) -> None:
        """The received frame is decoded and applied: record both spans
        and park for the converged-hash visibility read."""
        if not traces:
            return
        t0 = time.perf_counter()
        t_admit0 = t0 - admission_s
        t_dec0 = t_admit0 - decode_s
        for tr in traces:
            tr.doc = tr.doc or doc_id
            tr.span("remote_decode", t_dec0, t_admit0)
            tr.span("remote_admission", t_admit0, t0)
            tr.mark = t0
        with self._lock:
            self._park_locked(self._awaiting_visible, doc_id, traces)
            self._self_s += time.perf_counter() - t0

    # -- completion -------------------------------------------------------

    def visible(self, doc_ids=None) -> None:
        """A converged-hash read covering doc_ids (None = all docs) just
        served: complete every awaiting trace with its visibility span.
        Origin-side traces whose doc never crossed a wire complete from
        the awaiting-wire table — first consumer (send or visibility)
        wins. NOT gated on the local rate: adopted remote traces must
        complete even on a receiver whose own sampling is unset (the
        sender paid the decision); when the plane was never touched both
        tables are empty and this is two attribute loads."""
        if not self._awaiting_visible and not self._awaiting_wire:
            return
        t0 = time.perf_counter()
        done = []
        with self._lock:
            for table in (self._awaiting_visible, self._awaiting_wire):
                docs = (list(table) if doc_ids is None
                        else [d for d in doc_ids if d in table])
                for d in docs:
                    for tr in table.pop(d, ()):
                        tr.span("visibility", tr.mark, t0)
                        if self._complete_locked(tr):
                            done.append(tr)
            self._expire_locked(t0)
            self._self_s += time.perf_counter() - t0
        # the exemplar event is emitted OUTSIDE the plane lock
        for tr in done:
            d = tr.to_dict()
            flightrec.record("trace_exemplar", tid=d["tid"],
                             doc=d["doc"], role=d["role"],
                             crit_s=d["crit_s"],
                             stages=len(d["spans"]))

    def _complete_locked(self, tr) -> bool:
        """Fold a finished trace into the ring; True when it is a new
        slowest exemplar (the caller emits the flightrec event)."""
        self._done += 1
        if tr.role == "stitched":
            self._stitched += 1
        crit = max((s[1] + s[2] for s in tr.spans), default=0.0)
        exemplar = crit >= self._worst_crit
        if exemplar:
            self._worst_crit = crit
        self._completed.append(tr.to_dict())
        self._mutations += 1
        if self._mutations % GAUGE_REFRESH == 0:
            self._refresh_gauges_locked()
        return exemplar

    # -- bounded-table plumbing -------------------------------------------

    def _park_locked(self, table, doc_id: str, traces) -> None:
        table.setdefault(doc_id, []).extend(traces)
        table.move_to_end(doc_id)
        while len(table) > AWAIT_MAX:
            _, lost = table.popitem(last=False)
            self._dropped += len(lost)
        self._mutations += 1
        if self._mutations % GAUGE_REFRESH == 0:
            self._refresh_gauges_locked()

    def _expire_locked(self, now_perf: float) -> None:
        """Retire in-flight traces past TTL_S — counted, not leaked."""
        for table in (self._awaiting_flush, self._awaiting_wire,
                      self._awaiting_visible):
            for d in list(table):
                traces = table[d]
                live = [t for t in traces if now_perf - t.born < TTL_S]
                if len(live) != len(traces):
                    self._expired += len(traces) - len(live)
                    if live:
                        table[d] = live
                    else:
                        del table[d]

    def _inflight_locked(self) -> int:
        return (sum(len(v) for v in self._awaiting_flush.values())
                + sum(len(v) for v in self._awaiting_wire.values())
                + sum(len(v) for v in self._awaiting_visible.values()))

    def _refresh_gauges_locked(self) -> None:
        metrics.gauge("obs_trace_sampled", self._sampled)
        metrics.gauge("obs_trace_completed", self._done)
        metrics.gauge("obs_trace_inflight", self._inflight_locked())
        crits = sorted(t["crit_s"] for t in self._completed)
        if crits:
            metrics.gauge("obs_trace_critical_path_p99_s",
                          crits[min(len(crits) - 1,
                                    int(0.99 * len(crits)))])
        delta = self._self_s - self._self_s_flushed
        if delta > 0:
            metrics.observe("obs_trace_ledger_s", delta)
            self._self_s_flushed = self._self_s

    # -- export ------------------------------------------------------------

    def self_seconds(self) -> float:
        with self._lock:
            return self._self_s

    def section(self) -> dict:
        """PURE snapshot: counts, per-stage latency rollups over the
        completed ring, and the slowest completed exemplars (full
        waterfalls). No wall-clock reads."""
        with self._lock:
            ring = list(self._completed)
            sec = {
                "label": metrics.node_name() or "local",
                "sample_rate": sample_rate(),
                "sampled": self._sampled,
                "received": self._received,
                "handed_off": self._handed_off,
                "completed": self._done,
                "stitched": self._stitched,
                "expired": self._expired,
                "dropped": self._dropped,
                "inflight": self._inflight_locked(),
                "ring": len(ring),
                "ring_cap": self._completed.maxlen,
                "truncated": self._done > len(ring),
                "self_s": round(self._self_s, 6),
            }
        stages: dict[str, list] = {}
        for t in ring:
            for st, _rel, dur in t["spans"]:
                stages.setdefault(st, []).append(dur)
        sec["stages"] = {
            st: {
                "count": len(ds),
                "sum_s": round(sum(ds), 6),
                "p50_s": round(_pct(sorted(ds), 0.50), 6),
                "p99_s": round(_pct(sorted(ds), 0.99), 6),
            }
            for st, ds in sorted(
                stages.items(),
                key=lambda kv: (STAGES.index(kv[0])
                                if kv[0] in STAGES else 99))
        }
        crits = sorted(t["crit_s"] for t in ring)
        sec["critical_path"] = {
            "count": len(crits),
            "p50_s": round(_pct(crits, 0.50), 6),
            "p99_s": round(_pct(crits, 0.99), 6),
            "max_s": round(crits[-1], 6) if crits else 0.0,
        }
        ex = sorted(ring, key=lambda t: t["crit_s"], reverse=True)
        sec["exemplars"] = [
            {k: v for k, v in t.items() if not str(k).startswith("_")}
            for t in ex[:EXEMPLARS]]
        return sec

    def inflight_snapshot(self, limit: int = 8) -> list[dict]:
        """The slowest (oldest) in-flight traces — the flight recorder
        embeds these in a post-mortem dump so a divergence capture shows
        what was mid-lifecycle at fault time."""
        if not enabled():
            return []
        with self._lock:
            live = []
            for table, where in ((self._awaiting_flush, "flush"),
                                 (self._awaiting_wire, "wire"),
                                 (self._awaiting_visible, "visible")):
                for traces in table.values():
                    for tr in traces:
                        d = tr.to_dict()
                        d["awaiting"] = where
                        live.append(d)
        live.sort(key=lambda d: d["crit_s"], reverse=True)
        return live[:limit]

    def reset(self) -> None:
        with self._lock:
            self._awaiting_flush.clear()
            self._awaiting_wire.clear()
            self._awaiting_visible.clear()
            self._completed = deque(maxlen=_ring_cap())
            self._sampled = self._received = self._handed_off = 0
            self._done = self._stitched = 0
            self._expired = self._dropped = self._mutations = 0
            self._self_s = self._self_s_flushed = 0.0
            self._worst_crit = 0.0
        self._tls = threading.local()


def _pct(sorted_vals, q: float) -> float:
    if not sorted_vals:
        return 0.0
    return sorted_vals[min(len(sorted_vals) - 1,
                           int(q * len(sorted_vals)))]


_plane = TracePlane()

# module-level hooks (the call-site API — every one inert when the
# plane is off beyond the cached-rate check)
finalize_begin = _plane.finalize_begin
finalize_end = _plane.finalize_end
origin_ingress = _plane.origin_ingress
remote_apply = _plane.remote_apply
admit = _plane.admit
sealed = _plane.sealed
flush_round = _plane.flush_round
wire_header = _plane.wire_header
wire_receive = _plane.wire_receive
remote_admitted = _plane.remote_admitted
visible = _plane.visible
section = _plane.section
self_seconds = _plane.self_seconds
inflight_snapshot = _plane.inflight_snapshot
reset = _plane.reset


def snapshot_section() -> dict | None:
    """None when the plane is off AND untouched — an unset process's
    snapshot must stay byte-identical to the pre-plane shape (the
    test_metrics reset contract). A receiver with its own rate unset
    but adopted traces still exports (the sender paid the decision)."""
    sec = _plane.section()
    if (sec["sample_rate"] is None and not sec["sampled"]
            and not sec["received"] and not sec["completed"]
            and not sec["inflight"]):
        return None
    return {"nodes": {sec["label"]: sec}}


def _reset_all() -> None:
    _plane.reset()


metrics.register_snapshot_section("traceplane", snapshot_section)
metrics.register_reset_hook(_reset_all)
