"""Epoch-batched ingestion buffers: the service lock off the admission path
(the port of `automerge_tpu/sync/epochs.py`).

The Jiffy design (PAPERS.md: "Jiffy: A Lock-free Skip List
with Batch Updates and Snapshots", arxiv 2102.01044): writers append ops
into epoch-stamped buffers without the service lock, a single flusher per
shard drains sealed epochs into the engine as coalesced rounds, and reads
are served from immutable epoch snapshots. This module is the buffer +
flusher half; the snapshot read caches live on the service
(sync/service.py `_clock_cache` / `_log_cache`, keyed by the per-doc
admission version — the host-side twin of the engine's hash epoch).

Shape:

- **EpochIngestBuffer** — striped append-only buffers (stripe =
  crc32(doc) mod S, so one doc's entries stay ordered within one stripe
  and concurrent writers of different docs rarely share a stripe lock).
  An append takes ONE stripe lock for a list append and a counter bump —
  microseconds — and returns a `Ticket`. An epoch is delimited by
  `seal()`, which the service calls UNDER its lock: sealing swaps
  every stripe's list out, making the drained entries immutable; the
  sealed epoch then flushes through the existing engine dispatch as one
  round. This is the group-commit geometry: N writers' ingresses riding
  one flush is where the near-linear multi-writer admission scaling
  comes from (bench config 9).

- **Ticket** — one ingress awaiting its epoch's flush. `wait()` parks on
  the buffer's condition until the flush that carried (or rejected) the
  entry resolves it, then re-raises the flush error if any — so
  `apply_changes` keeps today's synchronous contract (when it returns,
  the change is flushed; when the flush fails, the caller sees the
  error) while never touching the service lock itself. The parked time
  is the `sync_commit_wait_s` histogram and (sampled) the oplag
  `buffer_wait` stage.

- **Flusher** — the single drainer thread per service/shard
  (`amtpu-torch-flusher-<shard>`). Spawned lazily on the first kick, exits
  after an idle linger (AMTPU_FLUSHER_LINGER_S, default 2s) so idle
  services hold no thread, and respawns on the next kick. A flush error
  resolves the epoch's tickets with the exception and the flusher
  survives — retry semantics stay exactly the service's existing
  `_pending` restore rules.

Lock order: service lock -> stripe lock (seal); append takes only the
stripe lock; ticket waits hold only the buffer condition. Nothing here
ever takes the service lock while holding a stripe lock.
"""

from __future__ import annotations

import os
import threading
import time
import zlib

from ..utils import flightrec, metrics
from . import tenantledger

#: stripes per buffer (power of two; bounds stripe-lock contention for
#: concurrent writers of different docs)
N_STRIPES = 4

#: seconds an idle flusher thread lingers before exiting (respawns on
#: the next kick); overridable for deployments with bursty writers
LINGER_S = float(os.environ.get("AMTPU_FLUSHER_LINGER_S", "2.0"))


def _reload_for_tests() -> None:
    """Re-read AMTPU_FLUSHER_LINGER_S (cached at import); flushers made
    after the call linger that long."""
    global LINGER_S
    LINGER_S = float(os.environ.get("AMTPU_FLUSHER_LINGER_S", "2.0"))


class Entry:
    """One buffered ingress: the wire columns plus its oplag token."""

    __slots__ = ("doc_id", "cols", "tok", "ticket")

    def __init__(self, doc_id: str, cols, tok, ticket: "Ticket"):
        self.doc_id = doc_id
        self.cols = cols
        self.tok = tok
        self.ticket = ticket


class Ticket:
    """One ingress awaiting its epoch flush; resolved by the flusher (or
    an inline reader flush) with the flush outcome. Each ticket parks on
    its OWN pre-acquired raw lock — one C-level futex per park and per
    wake (a shared condition serialized the round's writers through one
    lock reacquisition chain; Event adds a pure-python Condition walk on
    both sides — both measured as wake-latency tax on a 2-core host).
    Single-waiter by construction: one writer per ingress."""

    __slots__ = ("doc_id", "exc", "t0", "claimed", "_done", "_lk")

    def __init__(self, doc_id: str, claimed: bool = False):
        self.doc_id = doc_id
        self.exc: BaseException | None = None
        self.t0 = time.perf_counter()
        # claimed=True: a writer thread is committed to waiting on this
        # ticket and will run the admission gossip itself after it wakes
        # (synchronous apply_*; set before the entry is published so no
        # seal can observe it unset). The flusher's post-drain gossip
        # backstop skips rounds whose riders are ALL claimed — delivery
        # then happens deterministically on the writers' threads, which
        # keeps a relayed send inside the serve span that triggered it
        # (trace inheritance) and keeps the flusher thread off the
        # handler path in the steady synchronous case. An async handle
        # (apply_columns_async) starts unclaimed — the backstop owns its
        # gossip until PendingIngress.wait() claims it.
        self.claimed = claimed
        self._done = False
        self._lk = threading.Lock()
        self._lk.acquire()

    @property
    def done(self) -> bool:
        return self._done

    def resolve(self, exc: BaseException | None = None) -> float | None:
        """Resolve and wake the parked writer; returns the park duration
        (the group-commit wait) for the CALLER to record, or None when
        already resolved. The futex releases before any metrics work —
        recording on the resolver side keeps the registry crossing off
        the waking writer's critical path, and deferring it past the
        release keeps it off the wake latency too (the early-resolve
        path additionally batches it outside the service lock)."""
        if self._done:
            return None   # early-resolved (post-admission); keep that outcome
        self.exc = exc
        self._done = True
        wait_s = time.perf_counter() - self.t0
        self._lk.release()
        return wait_s

    def wait(self, alive_fn=None, poll_s: float = 0.5) -> None:
        """Park until the flush carrying this entry resolves it; re-raise
        its error. Idempotent: the first wait consumes the one release
        resolve() performs, so a repeat wait must short-circuit on _done
        (set before the release) instead of parking on the spent lock.
        `alive_fn` (the flusher's liveness + re-kick hook) is polled so
        a flusher that died mid-window cannot strand waiters — each poll
        re-kicks the flusher, which re-spawns it if needed."""
        if not self._done:
            while not self._lk.acquire(timeout=poll_s):
                if alive_fn is not None:
                    alive_fn()
        if self.exc is not None:
            raise self.exc


class _Stripe:
    __slots__ = ("lock", "entries", "doc_counts")

    def __init__(self):
        # a PLAIN lock, deliberately uninstrumented: the append hold is
        # two list/dict ops (sub-microsecond), and lockprof's two
        # histogram updates per acquire would cost ~10x the work being
        # guarded — per-op admission overhead is exactly what this path
        # exists to eliminate. Contention here is visible indirectly:
        # sync_commit_wait_s (writers) and the oplag buffer_wait stage.
        self.lock = threading.Lock()
        self.entries: list[Entry] = []
        self.doc_counts: dict[str, int] = {}


class EpochIngestBuffer:
    """Striped epoch-stamped admission buffer (one per service/shard)."""

    def __init__(self, n_stripes: int = N_STRIPES):
        self._stripes = [_Stripe() for _ in range(n_stripes)]
        self._n = n_stripes

    # -- writer side ---------------------------------------------------------

    def _stripe_of(self, doc_id: str) -> _Stripe:
        return self._stripes[zlib.crc32(doc_id.encode()) % self._n]

    def append(self, doc_id: str, cols, tok, claimed: bool = False) -> Ticket:
        """Buffer one ingress; returns the Ticket the writer waits on.
        Takes only the stripe lock — never the service lock."""
        ticket = Ticket(doc_id, claimed=claimed)
        entry = Entry(doc_id, cols, tok, ticket)
        s = self._stripe_of(doc_id)
        with s.lock:
            s.entries.append(entry)
            s.doc_counts[doc_id] = s.doc_counts.get(doc_id, 0) + 1
        # (sync_ops_buffered is bumped in bulk at seal time — a per-
        # append metrics-lock crossing would dominate the append itself)
        return ticket

    # -- read-side visibility ------------------------------------------------

    def has(self, doc_id: str) -> bool:
        """True when un-sealed entries for this doc are buffered (lock-free
        dict peek; the GIL makes the read atomic, and both false-positive
        and false-negative races only route a read onto the locked path
        or serve the pre-append snapshot — both linearizable outcomes)."""
        return doc_id in self._stripe_of(doc_id).doc_counts

    def doc_count(self, doc_id: str) -> int:
        """Un-sealed buffered entries for ONE doc (lock-free dict peek,
        same linearizability argument as has()) — the per-doc ledger's
        "parked in the epoch buffer" signal (sync/docledger.py) and a
        `perf explain` blocking-cause input."""
        return self._stripe_of(doc_id).doc_counts.get(doc_id, 0)

    def empty(self) -> bool:
        return all(not s.entries for s in self._stripes)

    def count(self) -> int:
        """Buffered entries across stripes — lock-free (each per-stripe
        len is GIL-atomic; a torn sum across stripes only mis-sizes one
        probe step of the flusher's pre-seal refill window)."""
        return sum(len(s.entries) for s in self._stripes)

    # -- flusher side --------------------------------------------------------

    def seal(self) -> list[Entry]:
        """Swap every stripe's buffer out as one sealed epoch. Called
        under the service lock (the seal is the one remaining
        service-lock duty on the ingestion path); the returned entries
        are immutable — no writer can reach them anymore. ALL stripe
        locks are held across the swap so the seal is one atomic cut
        of the buffer: without that, a writer's later append (landing
        in a not-yet-drained stripe) could seal into an EARLIER round
        than its own prior append to an already-drained stripe —
        breaking the per-thread ordering PendingIngress's durability
        contract promises (waiting on ingress k implies every earlier
        same-thread ingress is durable). An append that raced past the
        cut blocks on its stripe lock until the whole seal completes,
        so program order and cut order agree."""
        if all(not s.entries for s in self._stripes):
            # lock-free empty peek: racing appends linearize after this
            # seal (their kick re-drives the flusher)
            return []
        for s in self._stripes:
            s.lock.acquire()
        try:
            out: list[Entry] = []
            for s in self._stripes:
                if s.entries:
                    out.extend(s.entries)
                    s.entries = []
                    # every buffered entry of this stripe just sealed
                    s.doc_counts.clear()
        finally:
            for s in reversed(self._stripes):
                s.lock.release()
        if out:
            metrics.bump("sync_epochs_sealed")
        return out

    @staticmethod
    def resolve(tickets, exc: BaseException | None = None) -> None:
        """Resolve an epoch's tickets (already-resolved ones keep their
        earlier outcome — the early post-admission resolve wins). Every
        futex releases before any commit-wait histogram is touched."""
        waits = [t.resolve(exc) for t in tickets]
        for w in waits:
            if w is not None:
                metrics.observe("sync_commit_wait_s", w)


class IngressShedError(RuntimeError):
    """A low-priority ingress was shed by the admission governor
    (mode="shed") during a sustained converge-SLO breach. The change was
    NOT admitted; the sender's ordinary anti-entropy cycle re-offers it
    once its clock advert next crosses the wire — at-least-once
    redelivery, idempotent under the engine's (actor, seq) dedup."""


class IngressGovernor:
    """SLO-coupled admission control for the epoch-buffer plane (the
    degrade-gracefully half of arxiv 1303.7462): when the fleet's
    converge-p99 breaches its bound for `sustain_s` seconds, LOW-
    PRIORITY ingress is delayed (mode="delay", default — each append
    sleeps `delay_s` before buffering, throttling writers without
    breaking the synchronous apply contract) or shed outright
    (mode="shed" — the append raises IngressShedError, disclosed on
    `sync_shed_dropped`; opt-in because the caller must own the retry).

    `judge(converge_p99_s)` is the feed — wired to the SLO engine's
    converge_p99 verdict (perf/slo.py SloEngine.governor) or driven
    directly from the per-doc ledger's lag percentiles. Transitions are
    disclosed: `sync_shed_active` gauge, `sync_shed_transitions`
    counter, and a `shed_transition` flight-recorder event — shed load
    must never be silent. `high_priority` (doc_id -> bool) protects the
    ingress classes that must keep flowing (interactive docs, control
    planes); everything else is "low priority".
    """

    def __init__(self, bound_s: float = 2.0, sustain_s: float = 1.0,
                 delay_s: float = 0.02, mode: str = "delay",
                 high_priority=None):
        if mode not in ("delay", "shed"):
            raise ValueError(f"unknown governor mode {mode!r}")
        self.bound_s = bound_s
        self.sustain_s = sustain_s
        self.delay_s = delay_s
        self.mode = mode
        self.high_priority = high_priority or (lambda doc_id: False)
        self.shedding = False
        self._breach_since: float | None = None
        self._lock = threading.Lock()

    def judge(self, converge_p99_s: float | None,
              now: float | None = None) -> bool:
        """Feed one converge-p99 observation; returns the (possibly
        updated) shedding state. None (no data) never transitions."""
        if converge_p99_s is None:
            return self.shedding
        now = time.monotonic() if now is None else now
        with self._lock:
            if converge_p99_s > self.bound_s:
                if self._breach_since is None:
                    self._breach_since = now
                if not self.shedding \
                        and now - self._breach_since >= self.sustain_s:
                    self._transition_locked(True, converge_p99_s)
            else:
                self._breach_since = None
                if self.shedding:
                    self._transition_locked(False, converge_p99_s)
            return self.shedding

    def force(self, shedding: bool, mode: str | None = None,
              p99_s: float = 0.0) -> None:
        """External state control (the remediation ladder,
        perf/remediate.GovernorLadder): set the governed mode and the
        shedding state directly, with the same transition disclosure
        judge() performs. A ladder escalating delay -> shed, or relaxing
        with hysteresis, owns the decision; this method only applies it
        — the sustain timer resets so a later judge() feed starts
        clean."""
        if mode is not None and mode not in ("delay", "shed"):
            raise ValueError(f"unknown governor mode {mode!r}")
        with self._lock:
            mode_changed = mode is not None and mode != self.mode
            if mode is not None:
                self.mode = mode
            self._breach_since = None
            # a mode flip while already shedding (the ladder's
            # delay -> shed escalation, or the relax back) is a real
            # severity change and must be disclosed like any other
            # transition — appends START raising IngressShedError at
            # that edge, and shed load must never be silent
            if shedding != self.shedding or (mode_changed and shedding):
                self._transition_locked(shedding, p99_s)

    def _transition_locked(self, shedding: bool, p99: float) -> None:
        self.shedding = shedding
        metrics.gauge("sync_shed_active", 1 if shedding else 0)
        metrics.bump("sync_shed_transitions")
        flightrec.record("shed_transition", shedding=shedding,
                         p99_s=round(float(p99), 4), bound_s=self.bound_s,
                         mode=self.mode)

    def admit(self, doc_id: str) -> float:
        """Admission decision for one ingress: 0.0 = admit now; a
        positive value = delay that many seconds before buffering;
        raises IngressShedError in shed mode. One attribute check on
        the un-governed steady state."""
        if not self.shedding or self.high_priority(doc_id):
            return 0.0
        if self.mode == "shed":
            metrics.bump("sync_shed_dropped")
            tenantledger.note_shed(doc_id, delayed=False)
            raise IngressShedError(
                f"ingress for {doc_id!r} shed under sustained "
                f"converge-p99 breach (bound {self.bound_s}s)")
        metrics.bump("sync_shed_delayed")
        tenantledger.note_shed(doc_id, delayed=True, delay_s=self.delay_s)
        return self.delay_s


class Flusher:
    """Single lazy drainer thread per service/shard: parks on a condition,
    runs `flush_fn` whenever kicked, exits after an idle linger (and
    respawns on the next kick). `flush_fn` must be self-contained — any
    exception it raises was already delivered to the waiting writers via
    their tickets, so the flusher just survives it."""

    def __init__(self, flush_fn, name_fn, linger_s: float | None = None):
        self._flush_fn = flush_fn
        self._name_fn = name_fn
        self._linger_s = LINGER_S if linger_s is None else linger_s
        self._cv = threading.Condition(threading.Lock())
        self._thread: threading.Thread | None = None
        self._work = False
        self._stop = False

    def kick(self) -> bool:
        """Signal work; spawn the thread if none is parked. Returns
        False once stop() has been called — the caller then owns the
        drain (a late writer must not park behind a dead flusher)."""
        t = self._thread
        if self._work and t is not None and t.is_alive():
            # already signalled and a drainer is live (GIL-atomic reads):
            # skip the condition acquire — the common per-op case once a
            # round is forming
            return True
        with self._cv:
            if self._stop:
                return False
            self._work = True
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, name=self._name_fn(), daemon=True)
                self._thread.start()
            self._cv.notify_all()
        return True

    def stop(self, join_timeout: float = 5.0) -> None:
        with self._cv:
            self._stop = True
            t = self._thread
            self._cv.notify_all()
        if t is not None:
            t.join(timeout=join_timeout)

    def _loop(self) -> None:
        while True:
            with self._cv:
                deadline = time.monotonic() + self._linger_s
                while not self._work and not self._stop:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
                if self._stop or not self._work:
                    # idle past the linger (or stopping): deregister so
                    # the next kick spawns a fresh thread
                    self._thread = None
                    return
                self._work = False
            try:
                self._flush_fn()
            except BaseException:
                # the epoch's tickets already carry the error; the
                # flusher itself must survive to drain later epochs
                pass
            # Post-drain hot window: writers woken by the drain are
            # appending their next ops right now — spin-yield briefly
            # instead of parking, saving one futex wake + scheduler
            # latency per round in the streaming steady state (sleep(0)
            # releases the GIL each probe, so the writers run).
            spin_deadline = time.monotonic() + 0.001
            while not self._work and not self._stop \
                    and time.monotonic() < spin_deadline:
                time.sleep(0)
