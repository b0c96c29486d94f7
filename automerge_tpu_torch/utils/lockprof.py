"""Lock-contention profiler: instrumented lock/condition wrappers (the
port of `automerge_tpu/utils/lockprof.py`).

- **InstrumentedLock / InstrumentedRLock**: drop-in `threading.Lock` /
  `RLock` replacements (``with``, acquire/release, locked) that record,
  per named lock (bounded cardinality: "service", "archive",
  "snapshots", ...):

  * `sync_lock_wait_s{lock=...}`: histogram of time spent WAITING for
    the lock (the uncontended path records ~0 through a non-blocking
    first try);
  * `sync_lock_hold_s{lock=...}`: histogram of the outermost hold time
    (reentrant re-acquisitions by the owner neither wait nor count as
    separate holds);
  * `sync_lock_contended_total{lock=...}`: acquisitions that found the
    lock held by another thread.

- **holder attribution**: while held, each lock knows its holder (thread
  name, acquiring call site, since-when). Every instrumented lock
  registers in a process-wide weak registry; `holders_snapshot()` walks
  it and returns the current-holder table, which `flightrec.dump()`
  embeds in every post-mortem and `metrics.watchdog` appends to its fire
  diagnosis.

- **InstrumentedCondition**: the same wait accounting for condition
  variables.

Runtime sanitizer: with `AMTPU_LOCKSAN=1` (utils/locksan.py) every
outermost acquire and release also reports to the lock-order sanitizer,
which checks live acquisition order against the committed
`locks_manifest.json`. The disabled path costs one module-attribute
truth test per acquire.
"""

from __future__ import annotations

import sys
import threading
import time
import weakref

from . import locksan, metrics

# every live instrumented lock/condition (weak: a dropped service must
# not pin its locks in the holder table forever)
_registry: "weakref.WeakSet" = weakref.WeakSet()
_registry_lock = threading.Lock()


def _call_site(depth: int) -> tuple[str, int]:
    """(filename, lineno) of the acquiring frame, best-effort."""
    try:
        f = sys._getframe(depth)
        return f.f_code.co_filename, f.f_lineno
    except Exception:
        return "?", 0


class InstrumentedLock:
    """Named, profiled mutual exclusion. Drop-in for `threading.Lock`
    (`reentrant=True` for `threading.RLock` semantics)."""

    _REENTRANT = False

    def __init__(self, name: str):
        self.name = name
        self._lock = (threading.RLock() if self._REENTRANT
                      else threading.Lock())
        # (thread name, ident, filename, lineno, t_acquired) while held
        self._holder: tuple | None = None
        self._depth = 0          # reentrancy depth (owner-only mutation)
        self._owner: int | None = None
        with _registry_lock:
            _registry.add(self)

    def rename(self, name: str) -> None:
        """Change the metric label (ShardedEngineDocSet renames each
        shard's service lock to `service_shard<k>` after construction)."""
        self.name = name

    # -- lock protocol -------------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1,
                _depth: int = 2) -> bool:
        me = threading.get_ident()
        if self._REENTRANT and self._owner == me:
            # reentrant re-acquire by the owner: no wait, no new hold
            self._lock.acquire()
            self._depth += 1
            return True
        wait_s = 0.0
        if self._lock.acquire(blocking=False):
            acquired = True
        else:
            metrics.bump("sync_lock_contended_total", lock=self.name)
            if not blocking:
                return False
            if locksan.on:
                locksan.note_wait(self.name)
            t0 = time.perf_counter()
            try:
                acquired = (self._lock.acquire()
                            if timeout is None or timeout < 0
                            else self._lock.acquire(timeout=timeout))
            finally:
                if locksan.on:
                    locksan.note_wait_done(self.name)
            wait_s = time.perf_counter() - t0
            if not acquired:
                metrics.observe("sync_lock_wait_s", wait_s, lock=self.name)
                return False
        self._owner = me
        self._depth = 1
        fn, ln = _call_site(_depth)
        self._holder = (threading.current_thread().name, me, fn, ln,
                        time.perf_counter())
        metrics.observe("sync_lock_wait_s", wait_s, lock=self.name)
        if locksan.on:
            # strict mode can raise here: the lock is held at that point
            # (the sanitizer is a test and storm harness, not production)
            locksan.note_acquire(self.name)
        return True

    def release(self) -> None:
        if self._REENTRANT and self._owner == threading.get_ident() \
                and self._depth > 1:
            self._depth -= 1
            self._lock.release()
            return
        holder = self._holder
        self._holder = None
        self._owner = None
        self._depth = 0
        if locksan.on:
            locksan.note_release(self.name)
        self._lock.release()
        if holder is not None:
            metrics.observe("sync_lock_hold_s",
                            time.perf_counter() - holder[4], lock=self.name)

    def locked(self) -> bool:
        return self._holder is not None

    def __enter__(self) -> "InstrumentedLock":
        self.acquire(_depth=3)
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # -- holder attribution --------------------------------------------------

    def _release_save(self) -> int:
        """Release ALL recursion levels (threading.Condition's
        _release_save contract — a reentrantly-held lock must fully
        release before the owner parks on a condition, or the notifier
        deadlocks). Returns the depth to restore."""
        holder = self._holder
        depth = max(1, self._depth)
        self._holder = None
        self._owner = None
        self._depth = 0
        if locksan.on:
            locksan.note_release(self.name)
        for _ in range(depth):
            self._lock.release()
        if holder is not None:
            metrics.observe("sync_lock_hold_s",
                            time.perf_counter() - holder[4], lock=self.name)
        return depth

    def _acquire_restore(self, depth: int, _depth: int = 3) -> None:
        """Re-acquire to the saved recursion depth (one profiled
        outermost acquire + silent inner re-acquires)."""
        self.acquire(_depth=_depth + 1)
        for _ in range(depth - 1):
            self._lock.acquire()
        self._depth = depth

    def holder(self) -> dict | None:
        """Current holder `{thread, site, held_s}` or None. Racy by
        design (a diagnostic read must never take the lock it reports
        on); the tuple swap is atomic so the result is self-consistent."""
        h = self._holder
        if h is None:
            return None
        return {"thread": h[0], "site": f"{h[2]}:{h[3]}",
                "held_s": round(time.perf_counter() - h[4], 4)}

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"


class InstrumentedRLock(InstrumentedLock):
    """Named, profiled reentrant lock (drop-in for `threading.RLock`)."""

    _REENTRANT = True


class InstrumentedCondition:
    """Condition variable over an instrumented (or plain) lock; `wait`
    time records under `sync_lock_wait_s{lock=<name>}` so a consumer
    parked on a condition shows up in the same contention table."""

    def __init__(self, name: str, lock: InstrumentedLock | None = None):
        self.name = name
        self._ilock = lock if lock is not None else InstrumentedRLock(name)
        # the condition owns a private inner mutex; the public protocol
        # routes through the instrumented lock so holds/waits all record
        self._cv = threading.Condition(threading.Lock())

    def acquire(self) -> bool:
        return self._ilock.acquire(_depth=3)

    def release(self) -> None:
        self._ilock.release()

    def __enter__(self):
        self._ilock.acquire(_depth=3)
        return self

    def __exit__(self, *exc) -> None:
        self._ilock.release()

    def wait(self, timeout: float | None = None) -> bool:
        """Release the instrumented lock (ALL recursion levels, matching
        threading.Condition's _release_save semantics — a reentrant
        holder must not park while still owning the lock), park,
        re-acquire to the saved depth. The parked time records as wait
        on this condition's name."""
        t0 = time.perf_counter()
        with self._cv:
            saved = self._ilock._release_save()
            notified = self._cv.wait(timeout=timeout)
        self._ilock._acquire_restore(saved)
        metrics.observe("sync_lock_wait_s", time.perf_counter() - t0,
                        lock=self.name)
        return notified

    def notify(self, n: int = 1) -> None:
        with self._cv:
            self._cv.notify(n)

    def notify_all(self) -> None:
        with self._cv:
            self._cv.notify_all()


def holders_snapshot() -> dict[str, dict]:
    """Current-holder table across every live instrumented lock:
    `{lock_name: {"thread": ..., "site": "file.py:123", "held_s": ...}}`.
    Only held locks appear. This is the table flightrec embeds in every
    post-mortem and the watchdog appends to its fire line — the "who held
    what" the r5 hang diagnosis lacked. Duplicate names (many peers share
    "peer_send") keep the longest-held entry — the interesting one."""
    with _registry_lock:
        locks = list(_registry)
    out: dict[str, dict] = {}
    for lk in locks:
        h = lk.holder()
        if h is None:
            continue
        prev = out.get(lk.name)
        if prev is None or h["held_s"] > prev["held_s"]:
            out[lk.name] = h
    return out
