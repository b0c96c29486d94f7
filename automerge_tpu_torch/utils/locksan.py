"""Runtime lock-order sanitizer (the port of `automerge_tpu/utils/locksan.py`,
whole).

`locks_manifest.json` at the repo root commits the lock hierarchy as a
reviewed DAG. This module checks the same order on live threads: with
`AMTPU_LOCKSAN=1`, every named lock acquisition (the lockprof wrappers
call in through `note_acquire` / `note_release`; plain locks adopt
through the `named_lock()` factory) is checked against the committed
manifest edges, per thread:

- **order violation**: acquiring lock A while holding lock B when the
  manifest commits A -> B (A before B). Only committed inversions flag:
  an edge the manifest has never seen is not judged at run time.
- **long hold**: an outermost hold longer than `AMTPU_LOCKSAN_HOLD_S`
  (default 0.25 s) released while other threads are blocked waiting on
  the same name.

Disclosure, not crashing: violations bump
`obs_locksan_order_violations_total` / `obs_locksan_long_holds_total`,
record a `locksan_violation` flight-recorder event, and append to a
bounded in-process list readable through `violations()`. Strict mode
(`AMTPU_LOCKSAN=2`) also raises `LockOrderViolation` on an order
violation (for tests and storm harnesses, never production).

Inert when unset: `AMTPU_LOCKSAN` is read once and cached; the disabled
fast path in lockprof is a single module-attribute truth test
(`locksan.on`), and `named_lock()` returns a plain `threading.Lock`.
`_reload_for_tests()` re-reads the environment and clears all state.

Manifest: `AMTPU_LOCKSAN_MANIFEST` names it; unset, the port reads
`locks_manifest.json` at the root of the repository that holds this
package (a data file of the repository, shared with the reference).

Lock-name resolution: the manifest's lock table maps runtime names
("service", "peer_send") to static identities ("EngineDocSet._lock").
Renamed locks resolve by longest manifest-name prefix
("service_shard3" -> "service"), so sharded renames keep their identity.
The port's runtime names are the reference's: `service`,
`service_shard<k>`, `tcp_peers`, `peer_send`, `archive`, `snapshots`.
Names with no manifest entry get no order checking (but still take part
in hold-time accounting).
"""

from __future__ import annotations

import json
import os
import pathlib
import threading
import time

MANIFEST_NAME = "locks_manifest.json"
DEFAULT_HOLD_S = 0.25
_MAX_VIOLATIONS = 256

#: fast-path flag — lockprof reads this attribute on every acquire; it
#: is the "one cached check" of the disabled path.
on = False

_level: int | None = None
_hold_s: float | None = None
_manifest: tuple[dict, set] | None = None   # (name->id, committed edges)
_tls = threading.local()
_meta_lock = threading.Lock()    # guards _violations and _waiters (leaf
_violations: list[dict] = []     # lock: never held while acquiring
_waiters: dict[str, int] = {}    # another)


class LockOrderViolation(RuntimeError):
    """Raised in strict mode (AMTPU_LOCKSAN=2) on an order violation."""


# ---------------------------------------------------------------------------
# configuration


def level() -> int:
    """0 = inert, 1 = record, 2 = strict (raise on order violation)."""
    global _level, on
    if _level is None:
        raw = os.environ.get("AMTPU_LOCKSAN", "0").strip() or "0"
        try:
            _level = max(0, min(2, int(raw)))
        except ValueError:
            _level = 0
        on = _level >= 1
    return _level


def enabled() -> bool:
    return level() >= 1


def hold_threshold_s() -> float:
    global _hold_s
    if _hold_s is None:
        try:
            _hold_s = float(os.environ.get("AMTPU_LOCKSAN_HOLD_S",
                                           str(DEFAULT_HOLD_S)))
        except ValueError:
            _hold_s = DEFAULT_HOLD_S
    return _hold_s


def _reload_for_tests() -> None:
    """Re-read AMTPU_LOCKSAN* and drop every cache (tests flip the env
    var mid-process; production reads it once)."""
    global _level, _hold_s, _manifest, on
    _level = None
    _hold_s = None
    _manifest = None
    on = False
    level()
    reset()


def reset() -> None:
    """Clear recorded violations and waiter counts (test isolation)."""
    with _meta_lock:
        _violations.clear()
        _waiters.clear()


def violations() -> list[dict]:
    """Snapshot of recorded violations (bounded at _MAX_VIOLATIONS)."""
    with _meta_lock:
        return list(_violations)


# ---------------------------------------------------------------------------
# manifest


def _manifest_path() -> pathlib.Path:
    override = os.environ.get("AMTPU_LOCKSAN_MANIFEST")
    if override:
        return pathlib.Path(override)
    # automerge_tpu_torch/utils/locksan.py -> the repo root
    return pathlib.Path(__file__).resolve().parents[2] / MANIFEST_NAME


def _load_manifest() -> tuple[dict, set]:
    global _manifest
    if _manifest is None:
        names: dict[str, str] = {}
        edges: set[tuple[str, str]] = set()
        try:
            data = json.loads(_manifest_path().read_text())
            for e in data.get("locks", []):
                if e.get("name"):
                    names[e["name"]] = e["id"]
            for e in data.get("order", []):
                edges.add((e["before"], e["after"]))
        except (OSError, ValueError):
            pass        # no manifest: order checking disarmed
        _manifest = (names, edges)
    return _manifest


def _resolve(name: str) -> str | None:
    """Runtime name -> manifest lock id; longest-prefix match absorbs
    renames like service -> service_shard<k>."""
    names, _ = _load_manifest()
    lid = names.get(name)
    if lid is not None:
        return lid
    best = None
    for n, i in names.items():
        if name.startswith(n) and (best is None or len(n) > len(best[0])):
            best = (n, i)
    return best[1] if best else None


# ---------------------------------------------------------------------------
# the per-thread held stack


def _stack() -> list:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s    # entries: [name, lock_id, t_acquired, depth]


def note_acquire(name: str) -> None:
    """Called by the lock wrapper AFTER an outermost acquire."""
    if not on:
        return
    stack = _stack()
    for entry in stack:
        if entry[0] == name:        # reentrant re-acquire through rename
            entry[3] += 1
            return
    lid = _resolve(name)
    _, edges = _load_manifest()
    if lid is not None:
        for held_name, held_id, _t0, _d in reversed(stack):
            if held_id is None or held_id == lid:
                continue
            if (lid, held_id) in edges:
                _disclose("order", lock=name, lock_id=lid,
                          held=held_name, held_id=held_id,
                          detail=(f"acquired {name} ({lid}) while "
                                  f"holding {held_name} ({held_id}); "
                                  f"{MANIFEST_NAME} commits "
                                  f"{lid} -> {held_id}"))
                break
    stack.append([name, lid, time.perf_counter(), 1])


def note_release(name: str) -> None:
    """Called by the lock wrapper BEFORE/AT an outermost release."""
    if not on:
        return
    stack = _stack()
    for i in range(len(stack) - 1, -1, -1):
        if stack[i][0] != name:
            continue
        stack[i][3] -= 1
        if stack[i][3] > 0:
            return
        _n, lid, t0, _d = stack.pop(i)
        hold_s = time.perf_counter() - t0
        if hold_s >= hold_threshold_s():
            with _meta_lock:
                pending = _waiters.get(name, 0)
            if pending > 0:
                _disclose("long-hold", lock=name, lock_id=lid,
                          hold_s=round(hold_s, 4), waiters=pending,
                          detail=(f"held {name} for {hold_s:.3f}s with "
                                  f"{pending} thread(s) blocked on it"),
                          raise_strict=False)
        return


def note_wait(name: str) -> None:
    """A thread is about to block on `name` (contended acquire)."""
    if not on:
        return
    with _meta_lock:
        _waiters[name] = _waiters.get(name, 0) + 1


def note_wait_done(name: str) -> None:
    if not on:
        return
    with _meta_lock:
        n = _waiters.get(name, 0) - 1
        if n <= 0:
            _waiters.pop(name, None)
        else:
            _waiters[name] = n


# ---------------------------------------------------------------------------
# disclosure


def _disclose(kind: str, detail: str, raise_strict: bool = True,
              **fields) -> None:
    rec = {"kind": kind, "thread": threading.current_thread().name,
           "detail": detail, **fields}
    with _meta_lock:
        if len(_violations) < _MAX_VIOLATIONS:
            _violations.append(rec)
    # lazy imports: lockprof imports this module, and metrics/flightrec
    # sit above lockprof — the inert path must not pull them in either
    try:
        from . import metrics
        if kind == "order":
            metrics.bump("obs_locksan_order_violations_total",
                         lock=fields.get("lock", "?"))
        else:
            metrics.bump("obs_locksan_long_holds_total",
                         lock=fields.get("lock", "?"))
        from . import flightrec
        # the violation class rides as `violation` — a `kind` field
        # would clobber the event kind itself
        flightrec.record("locksan_violation", violation=kind, **{
            k: v for k, v in rec.items() if k not in ("kind",)})
    except Exception:
        pass        # a sanitizer must never take the process down
    if raise_strict and level() >= 2:
        raise LockOrderViolation(detail)


# ---------------------------------------------------------------------------
# the named-lock factory (for plain-threading.Lock adopters)


class _SanLock:
    """A `threading.Lock` wrapper that reports to the sanitizer. Only
    handed out by `named_lock()` when the sanitizer is on — the
    disabled path carries zero wrapper overhead."""

    __slots__ = ("name", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._lock.acquire(blocking=False):
            note_acquire(self.name)
            return True
        if not blocking:
            return False
        note_wait(self.name)
        try:
            got = (self._lock.acquire() if timeout is None or timeout < 0
                   else self._lock.acquire(timeout=timeout))
        finally:
            note_wait_done(self.name)
        if got:
            note_acquire(self.name)
        return got

    def release(self) -> None:
        note_release(self.name)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "_SanLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<_SanLock {self.name!r}>"


def named_lock(name: str):
    """A mutex carrying a sanitizer name. Inert (`AMTPU_LOCKSAN` unset):
    a plain `threading.Lock` — zero overhead, no wrapper. Enabled: a
    `_SanLock` that participates in order/hold checking."""
    if level() >= 1:
        return _SanLock(name)
    return threading.Lock()


# arm at import: the lockprof fast path tests `locksan.on` directly and
# must see the env verdict without anyone ever calling level() — a
# process whose only named locks are lockprof wrappers would otherwise
# never arm under AMTPU_LOCKSAN=1
level()
