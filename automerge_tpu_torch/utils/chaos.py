"""Chaos fault injection (the port of `automerge_tpu/utils/chaos.py`): the
hooks the sync service, the `Connection` and the storage tier call. Each
is inert unless its variable is set:

- **slow-apply** (`AMTPU_CHAOS_SLOW_APPLY_S=<seconds>`): a rows
  service's round flush sleeps that long inside the flush window, under
  the service lock;
- **lock-hold** (`AMTPU_CHAOS_LOCK_HOLD_S=<seconds>`, cadence
  `AMTPU_CHAOS_LOCK_HOLD_EVERY_S`, default 0.2): a `LockHolder` thread,
  named `amtpu-torch-chaos-lockhold`, that a service spawns at
  construction (`maybe_lock_holder`) periodically sits on the service
  lock; `EngineDocSet.close()` stops and joins it;
- **doc-stall** (`AMTPU_CHAOS_STALL_DOC=<doc_id>`): a Connection drops
  its outgoing change-bearing messages for exactly that doc;
- **sub-flap** (`AMTPU_CHAOS_SUB_FLAP_DOC=<doc_id>`, cadence
  `AMTPU_CHAOS_SUB_FLAP_EVERY`, default 4): a subscriber connection
  toggles its subscription for that doc;
- **tenant-storm** (`AMTPU_CHAOS_TENANT_STORM=<tenant>`, factor
  `AMTPU_CHAOS_TENANT_STORM_X`, default 8): a service re-appends that
  tenant's epoch-path ingress as extra un-waited entries (duplicates
  dedup at admission);
- **disk-stall** (`AMTPU_CHAOS_DISK_STALL_S=<seconds>`): every archive,
  seal, manifest and snapshot fsync sleeps that long first;
- **frame-drop** (`AMTPU_CHAOS_DROP_FRAMES=<probability>`): outgoing
  change-bearing transport messages are dropped before the socket write
  (sync/tcp.py `_Peer._send`, counted as `sync_frames_dropped`);
  telemetry, audit and clock messages are never dropped;
- **conn-kill** (`AMTPU_CHAOS_CONN_KILL_AFTER=<n>`): the n-th outgoing
  transport message of an affected peer hard-closes its socket instead
  of being written (sync/tcp.py `_Peer._send`); it fires once per node
  key until `reload()`, so a reconnect supervisor
  (`sync/tcp.SupervisedTcpClient`) must bring the link back;
- **peer-hang** (`AMTPU_CHAOS_PEER_HANG_S=<seconds>`, onset
  `AMTPU_CHAOS_PEER_HANG_AFTER=<n>`, default 1): for that many seconds
  from the n-th eligible receive, an affected peer's transport reader
  swallows every incoming message unprocessed (sync/tcp.py
  `_Peer._read_loop`); only an idle detector that watches processed
  inbound messages notices.

Targeting: with `AMTPU_CHAOS_NODE=<label>` set, only owners whose
`_chaos_node` / `chaos_node` is that label are affected; unset, every
owner in the process is. With no `AMTPU_CHAOS_*` set, every hook is one
cached attribute check and returns. `reload()` re-reads the environment
(tests flip knobs per case). Every injection is disclosed as
`obs_chaos_injected{fault=...}` and a `chaos_inject` flight-recorder
event.
"""

from __future__ import annotations

import os
import random
import threading
import time

from . import flightrec, metrics

# The sleeps below are the PRODUCT of this module: slow-apply sleeps
# inside a held service lock by design (that is the fault being
# injected). The alias keeps graftlint's block-under-lock rule — which
# guards against ACCIDENTAL stalls — from flagging every product call
# site that can reach a deliberately-injected one; the injection is
# env-gated, disclosed via obs_chaos_injected, and off in production.
_sleep = time.sleep

#: default seconds between two chaos lock holds
DEFAULT_HOLD_EVERY_S = 0.2

#: default sub_flap cadence: one subscribe/unsubscribe toggle per this
#: many eligible received messages of the victim doc
DEFAULT_FLAP_EVERY = 4


class _Config:
    __slots__ = ("slow_apply_s", "lock_hold_s", "lock_hold_every_s",
                 "drop_frames", "stall_doc_id", "sub_flap_doc_id",
                 "sub_flap_every", "conn_kill_after", "peer_hang_s",
                 "peer_hang_after", "disk_stall_s", "tenant_storm_id",
                 "tenant_storm_x", "node", "any")

    def __init__(self):
        def _f(name, default=0.0):
            try:
                return float(os.environ.get(name, "") or default)
            except ValueError:
                return default
        self.slow_apply_s = max(0.0, _f("AMTPU_CHAOS_SLOW_APPLY_S"))
        self.lock_hold_s = max(0.0, _f("AMTPU_CHAOS_LOCK_HOLD_S"))
        self.lock_hold_every_s = max(
            0.001, _f("AMTPU_CHAOS_LOCK_HOLD_EVERY_S", DEFAULT_HOLD_EVERY_S))
        self.drop_frames = min(1.0, max(0.0, _f("AMTPU_CHAOS_DROP_FRAMES")))
        self.stall_doc_id = os.environ.get("AMTPU_CHAOS_STALL_DOC") or None
        self.sub_flap_doc_id = (os.environ.get("AMTPU_CHAOS_SUB_FLAP_DOC")
                                or None)
        self.sub_flap_every = max(
            1, int(_f("AMTPU_CHAOS_SUB_FLAP_EVERY", DEFAULT_FLAP_EVERY)))
        self.conn_kill_after = max(0, int(_f("AMTPU_CHAOS_CONN_KILL_AFTER")))
        self.peer_hang_s = max(0.0, _f("AMTPU_CHAOS_PEER_HANG_S"))
        self.peer_hang_after = max(1, int(_f("AMTPU_CHAOS_PEER_HANG_AFTER",
                                             1)))
        self.disk_stall_s = max(0.0, _f("AMTPU_CHAOS_DISK_STALL_S"))
        self.tenant_storm_id = (os.environ.get("AMTPU_CHAOS_TENANT_STORM")
                                or None)
        self.tenant_storm_x = max(2, int(_f("AMTPU_CHAOS_TENANT_STORM_X",
                                            8)))
        self.node = os.environ.get("AMTPU_CHAOS_NODE") or None
        self.any = bool(self.slow_apply_s or self.lock_hold_s
                        or self.drop_frames or self.stall_doc_id
                        or self.sub_flap_doc_id or self.conn_kill_after
                        or self.peer_hang_s or self.disk_stall_s
                        or self.tenant_storm_id)


_config: _Config | None = None


def _cfg() -> _Config:
    global _config
    c = _config
    if c is None:
        _config = c = _Config()
    return c


def reload() -> None:
    """Re-read the AMTPU_CHAOS_* env (tests flip knobs between cases;
    already-running lock holders are unaffected — stop them via their
    handle)."""
    global _config
    _config = None
    _flap_counts.clear()
    _kill_counts.clear()
    _hang_counts.clear()
    _hang_started.clear()


def enabled() -> bool:
    return _cfg().any


def _match(c: _Config, node: str | None) -> bool:
    """Targeting: with AMTPU_CHAOS_NODE set, only owners labeled with
    that exact node are affected; unset targets every node (the
    process-per-peer posture)."""
    return c.node is None or node == c.node


def _disclose(fault: str, node: str | None, **fields) -> None:
    metrics.bump("obs_chaos_injected", fault=fault)
    flightrec.record("chaos_inject", fault=fault, node=node, **fields)


def slow_apply(node: str | None = None) -> None:
    """Injection point inside a rows service's round flush: sleep
    AMTPU_CHAOS_SLOW_APPLY_S inside the flush window (and therefore
    under the service lock — the fault IS a slow engine apply)."""
    c = _cfg()
    if not c.slow_apply_s or not _match(c, node):
        return
    _disclose("slow_apply", node, s=c.slow_apply_s)
    _sleep(c.slow_apply_s)


def drop_frame(node: str | None = None, kind: str = "frame") -> bool:
    """True when the transport should drop this outgoing message.
    Only change-bearing kinds ("frame"/"changes") are ever dropped —
    metrics pulls, audit digests, and clock adverts always pass, so the
    health plane keeps observing the node it is degrading."""
    c = _cfg()
    if not c.drop_frames or not _match(c, node):
        return False
    if kind not in ("frame", "changes"):
        return False
    if random.random() >= c.drop_frames:
        return False
    _disclose("frame_drop", node, kind=kind)
    return True


def disk_stall(node: str | None = None) -> None:
    """Injection point in the storage tier's durability paths
    (`AMTPU_CHAOS_DISK_STALL_S=<seconds>`): every archive/seal/snapshot
    fsync (sync/logarchive.py `_fsync_file`, sync/snapshots.py write)
    sleeps that long first — a slow or overloaded disk. Signature: the
    node's `sync_archive_fsync_s` histogram inflates while round
    flushes and lock waits stay ordinary, which is what lets the doctor
    attribute slow-append/slow-bootstrap to `storage_stall` instead of
    the engine. Inert (one cached check) unless the knob is set; every
    injection is disclosed."""
    c = _cfg()
    if not c.disk_stall_s or not _match(c, node):
        return
    _disclose("disk_stall", node, s=c.disk_stall_s)
    _sleep(c.disk_stall_s)


def stall_doc(node: str | None, doc_id: str) -> bool:
    """True when outgoing change-bearing messages for EXACTLY this doc
    should be suppressed (`AMTPU_CHAOS_STALL_DOC=<doc_id>`): the per-doc
    stall the doc-granular observability plane must localize — every
    OTHER doc keeps syncing, clock adverts keep flowing, and only the
    victim doc's changes die at the sender. Transport-agnostic: the hook
    sits in Connection.send_msg, so in-process meshes degrade the same
    way TCP fleets do. Caller counts the drop (sync_frames_dropped +
    the ledger's per-doc drop lane)."""
    c = _cfg()
    if c.stall_doc_id is None or not _match(c, node):
        return False
    if doc_id != c.stall_doc_id:
        return False
    _disclose("doc_stall", node, doc=doc_id)
    return True


# per-(node, doc) eligible-event counters for the sub_flap cadence —
# cleared by reload() so per-case env flips restart the rhythm
_flap_counts: dict = {}


def sub_flap(node: str | None, doc_id: str) -> bool:
    """True when the subscriber-side connection should TOGGLE its
    subscription for exactly this doc (`AMTPU_CHAOS_SUB_FLAP_DOC=<doc>`,
    cadence `AMTPU_CHAOS_SUB_FLAP_EVERY`, default one toggle per 4
    eligible events): subscribe/unsubscribe churn — the interest-plane
    fault class whose induced lag `perf explain` must attribute as
    doc_unsubscribed-with-churn instead of flagging a stall. The hook
    sits in Connection's receive path and only fires on connections
    with an explicit local interest; every toggle is disclosed
    (obs_chaos_injected{fault=sub_flap} + a chaos_inject event)."""
    c = _cfg()
    if c.sub_flap_doc_id is None or not _match(c, node):
        return False
    if doc_id != c.sub_flap_doc_id:
        return False
    key = (node, doc_id)
    n = _flap_counts.get(key, 0) + 1
    _flap_counts[key] = n
    if n % c.sub_flap_every:
        return False
    _disclose("sub_flap", node, doc=doc_id)
    return True


def tenant_storm(node: str | None, doc_id: str) -> int:
    """Extra ingress copies this epoch append should enqueue (0 = no
    storm): `AMTPU_CHAOS_TENANT_STORM=<tenant_id>` multiplies exactly
    that tenant's epoch-path ingress by `AMTPU_CHAOS_TENANT_STORM_X`
    (default 8, min 2) — the caller (sync/service.py `_epoch_append`)
    appends the batch x-1 additional times as un-waited entries.
    Duplicate changes dedup at (actor, seq) admission, so the storm
    costs real flush/dispatch/wire work without corrupting state. Inert
    (one cached check) unset; every fire is disclosed."""
    c = _cfg()
    if c.tenant_storm_id is None or not _match(c, node):
        return 0
    from ..sync.tenantledger import tenant_of
    tid = tenant_of(doc_id)
    if tid != c.tenant_storm_id:
        return 0
    _disclose("tenant_storm", node, tenant=tid, x=c.tenant_storm_x)
    return c.tenant_storm_x - 1


# per-node outgoing-message counters for conn_kill; the sentinel -1
# marks "already fired" (one transport death per node key per reload)
_kill_counts: dict = {}

# per-node peer_hang state: receive count until onset, then the wall
# clock the window opened at; cleared by reload()
_hang_counts: dict = {}
_hang_started: dict = {}


def conn_kill(node: str | None = None) -> bool:
    """True exactly ONCE per node key, on the n-th eligible outgoing
    transport message (`AMTPU_CHAOS_CONN_KILL_AFTER=<n>`): the caller
    (sync/tcp.py `_Peer._send`) hard-closes the socket instead of
    writing — an established connection torn down mid-stream, the
    reconnect supervisor's acceptance input. Inert unset; fires once
    and then stays quiet until reload() (the fault under test is a
    single transport death, not flapping — churn is sub_flap's job)."""
    c = _cfg()
    if not c.conn_kill_after or not _match(c, node):
        return False
    n = _kill_counts.get(node, 0)
    if n < 0:
        return False            # already fired for this node key
    n += 1
    if n < c.conn_kill_after:
        _kill_counts[node] = n
        return False
    _kill_counts[node] = -1
    _disclose("conn_kill", node, after=c.conn_kill_after)
    return True


def peer_hang(node: str | None = None) -> bool:
    """True while the hang window is open (`AMTPU_CHAOS_PEER_HANG_S=
    <seconds>`, opening at the `AMTPU_CHAOS_PEER_HANG_AFTER`-th
    eligible receive — default 1, i.e. immediately): the caller
    (sync/tcp.py `_Peer._read_loop`) swallows the incoming message
    unprocessed — an accepted but unresponsive peer. The socket stays
    open and keeps delivering, so nothing times out at the transport;
    only an idle detector watching PROCESSED inbound activity
    (SupervisedTcpClient `idle_reconnect_s`) can tell this apart from a
    quiet link. Every swallow is disclosed."""
    c = _cfg()
    if not c.peer_hang_s or not _match(c, node):
        return False
    now = time.monotonic()
    started = _hang_started.get(node)
    if started is None:
        n = _hang_counts.get(node, 0) + 1
        _hang_counts[node] = n
        if n < c.peer_hang_after:
            return False        # window not open yet
        _hang_started[node] = started = now
    if now - started >= c.peer_hang_s:
        return False            # window expired: responsive again
    _disclose("peer_hang", node, s=c.peer_hang_s)
    return True


class LockHolder:
    """Chaos thread that periodically acquires a lock and sits on it for
    `hold_s` — the deliberate re-creation of the r5 stall class, scaled
    down. The lockprof holder table names this thread
    (`amtpu-torch-chaos-lockhold`), so a doctor report on a chaos run
    shows exactly the who-held-what evidence a real stall would."""

    def __init__(self, lock, hold_s: float, every_s: float,
                 node: str | None = None):
        self._lock_ref = lock
        self.hold_s = hold_s
        self.every_s = every_s
        self.node = node
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="amtpu-torch-chaos-lockhold",
            daemon=True)

    def start(self) -> "LockHolder":
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop and join (idempotent); waits out at most one hold."""
        self._stop.set()
        self._thread.join(timeout=10.0 + self.hold_s)

    def _loop(self) -> None:
        while not self._stop.wait(self.every_s):
            with self._lock_ref:
                _disclose("lock_hold", self.node, s=self.hold_s)
                _sleep(self.hold_s)


def maybe_lock_holder(lock, node: str | None = None) -> LockHolder | None:
    """Start a LockHolder against `lock` when AMTPU_CHAOS_LOCK_HOLD_S is
    set (and the node matches any AMTPU_CHAOS_NODE targeting). Returns
    the handle (caller owns stop()) or None when inert.

    sync/service.py calls this at service construction, so a process
    launched with the knob set degrades every service it hosts — the
    bench's degraded-peer subprocess needs no code of its own. In-process
    multi-node tests pass an explicit matching `node` label instead."""
    c = _cfg()
    if not c.lock_hold_s or not _match(c, node):
        return None
    return LockHolder(lock, c.lock_hold_s, c.lock_hold_every_s,
                      node=node).start()
