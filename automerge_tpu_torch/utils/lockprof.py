"""Lock-contention profiler: the named lock of `automerge_tpu/utils/
lockprof.py` that the storage tier's two stores take (`sync/logarchive.py`,
`sync/snapshots.py`).

`InstrumentedLock` is a drop-in `threading.Lock` (``with``, `acquire`,
`release`, `locked`) that records, per lock NAME (bounded cardinality:
"archive", "snapshots"):

- `sync_lock_wait_s{lock=...}`: histogram of the time spent WAITING for
  the lock (the uncontended path records 0 through a non-blocking first
  try);
- `sync_lock_hold_s{lock=...}`: histogram of the hold time;
- `sync_lock_contended_total{lock=...}`: acquisitions that found the lock
  held by another thread.

Left out (later slices, with the service of ROADMAP item 5): the reentrant
`InstrumentedRLock`, `InstrumentedCondition`, holder attribution
(`holder()`, the process-wide registry and `holders_snapshot()`, which the
flight recorder and the metrics watchdog read), `rename`, and the
lock-order sanitizer hooks (`utils/locksan.py`).
"""

from __future__ import annotations

import threading
import time

from . import metrics


class InstrumentedLock:
    """Named, profiled mutual exclusion. Drop-in for `threading.Lock`."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        # perf_counter() of the acquisition while held, else None
        self._since: float | None = None

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        wait_s = 0.0
        if not self._lock.acquire(blocking=False):
            metrics.bump("sync_lock_contended_total", lock=self.name)
            if not blocking:
                return False
            t0 = time.perf_counter()
            acquired = (self._lock.acquire()
                        if timeout is None or timeout < 0
                        else self._lock.acquire(timeout=timeout))
            wait_s = time.perf_counter() - t0
            if not acquired:
                metrics.observe("sync_lock_wait_s", wait_s, lock=self.name)
                return False
        self._since = time.perf_counter()
        metrics.observe("sync_lock_wait_s", wait_s, lock=self.name)
        return True

    def release(self) -> None:
        since = self._since
        self._since = None
        self._lock.release()
        if since is not None:
            metrics.observe("sync_lock_hold_s", time.perf_counter() - since,
                            lock=self.name)

    def locked(self) -> bool:
        return self._since is not None

    def __enter__(self) -> "InstrumentedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()
