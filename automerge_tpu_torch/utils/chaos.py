"""Chaos fault injection: the storage-tier hook of `automerge_tpu/utils/
chaos.py`, the one the log archive and the snapshot store call.

- **disk-stall** (`AMTPU_CHAOS_DISK_STALL_S=<seconds>`): every archive,
  seal, manifest and snapshot fsync (`sync/logarchive.py` `timed_fsync`)
  sleeps that long first, inside the timed window, so the node's
  `sync_archive_fsync_s` histogram inflates while everything else stays
  ordinary.

Targeting: with `AMTPU_CHAOS_NODE=<label>` set, only owners whose
`chaos_node` is that label are affected; unset, every owner in the
process is. With no `AMTPU_CHAOS_*` set, the hook is one cached attribute
check and returns. `reload()` re-reads the environment (tests flip knobs
per case). Every injection is disclosed as `obs_chaos_injected{fault=...}`.

Left out (later slices, with the service and transports of ROADMAP item
5): the slow-apply, lock-hold, frame-drop, doc-stall, sub-flap, conn-kill,
tenant-storm and peer-hang hooks with their knobs, `enabled()`,
`maybe_lock_holder`, and the flight-recorder event each injection also
records in the reference (`utils/flightrec.py` is not ported).
"""

from __future__ import annotations

import os
import time

from . import metrics


class _Config:
    __slots__ = ("disk_stall_s", "node")

    def __init__(self):
        try:
            stall = float(os.environ.get("AMTPU_CHAOS_DISK_STALL_S", "")
                          or 0.0)
        except ValueError:
            stall = 0.0
        self.disk_stall_s = max(0.0, stall)
        self.node = os.environ.get("AMTPU_CHAOS_NODE") or None


_config: _Config | None = None


def _cfg() -> _Config:
    global _config
    c = _config
    if c is None:
        _config = c = _Config()
    return c


def reload() -> None:
    """Re-read the AMTPU_CHAOS_* environment."""
    global _config
    _config = None


def _match(c: _Config, node: str | None) -> bool:
    return c.node is None or node == c.node


def disk_stall(node: str | None = None) -> None:
    """Injection point in the storage tier's durability paths: sleep
    AMTPU_CHAOS_DISK_STALL_S before the fsync (a slow disk). Inert unless
    the knob is set."""
    c = _cfg()
    if not c.disk_stall_s or not _match(c, node):
        return
    metrics.bump("obs_chaos_injected", fault="disk_stall")
    time.sleep(c.disk_stall_s)
