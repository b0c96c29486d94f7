"""Process-wide generational-GC pause with a refcount.

Burst allocation phases (coalesced ingress, bulk builds, round encodes)
trigger gen-2 collections that scan the WHOLE service heap — measured at
~2/3 of ingress cost on a 2K-doc node and ~4x the round cost on a
100K-doc fleet node. Python's gc enable/disable is process-global, so
independent pause sites on concurrent threads (two service nodes syncing
over Connections) would re-enable each other mid-burst if each tracked
its own was-enabled flag; this refcount makes nesting and concurrency
safe: GC re-enables only when the LAST pauser exits, and never if
something outside had already disabled it.
"""

from __future__ import annotations

import contextlib
import gc
import threading

_lock = threading.Lock()
_depth = 0
_we_disabled = False


@contextlib.contextmanager
def gc_paused():
    global _depth, _we_disabled
    with _lock:
        _depth += 1
        if _depth == 1:
            _we_disabled = gc.isenabled()
            if _we_disabled:
                gc.disable()
    try:
        yield
    finally:
        with _lock:
            _depth -= 1
            if _depth == 0 and _we_disabled:
                gc.enable()
                _we_disabled = False
