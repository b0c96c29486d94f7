"""TCP transport for Connection sync (the port of `automerge_tpu/sync/tcp.py`,
whole).

A Connection only needs a `send_msg` callback and a `receive_msg` entry
point; this module carries its `{docId, clock, changes}` messages over TCP
sockets with a minimal length-prefixed framing, so two nodes (port or
reference, in any pairing) sync over a real transport.

Framing: 4-byte big-endian length, then the payload. A payload starting
with b"AMWM" is a binary columnar message (header JSON carrying docId /
clock, then a sync/frames.py columnar change frame); anything else is
parsed as UTF-8 JSON. A server therefore accepts JSON and columnar
senders on one port. `wire=` selects what this side emits: keep the
default "json" when the remote peer speaks only the JSON protocol; use
"columnar" between automerge_tpu nodes. The bytes on the socket are the
reference's, byte for byte: a reference node and a port node are peers.

Threads: a peer's reader is `amtpu-torch-tcp-read-<id>`, a server's
acceptor `amtpu-torch-tcp-accept-<port>`, a supervised client's
supervisor `amtpu-torch-tcp-supervisor-<port>`. Every `close()` joins the
threads it owns (a reader closing its own peer does not join itself). A
server's `close()` shuts its listening socket down before closing it,
which wakes the acceptor blocked in `accept()` so it can be joined.

Usage:
    server = TcpSyncServer(doc_set, host="127.0.0.1", port=0)
    server.start()                       # accepts any number of peers
    client = TcpSyncClient(other_doc_set, "127.0.0.1", server.port)
    client.start()
    ... edit documents, call doc_set.set_doc(...) ...
    client.close(); server.close()
"""

from __future__ import annotations

import json
import socket
import struct
import threading
import time

from ..utils import chaos, lockprof, locksan
from .connection import Connection
from .frames import msg_kind as _msg_kind   # canonical home: frames.py


def _sync_lock_of(doc_set) -> threading.RLock:
    """The doc_set-wide reentrant lock serializing transport entry points."""
    lock = getattr(doc_set, "_sync_lock", None)
    if lock is None:
        lock = threading.RLock()
        try:
            doc_set._sync_lock = lock
        except AttributeError:  # doc_set with __slots__: per-call lock
            pass
    return lock


def sync_lock(doc_set) -> threading.RLock:
    """Public handle to the transport lock: application threads that
    read-modify-write docs in a DocSet served by a TCP transport must hold
    this around the get_doc -> change -> set_doc sequence, or the receive
    thread can advance the doc between their read and their write."""
    return _sync_lock_of(doc_set)


_HEADER = struct.Struct(">I")
_MSG_MAGIC = b"AMWM"
_MSG_HDR = struct.Struct("<I")
MAX_FRAME = 256 * 1024 * 1024
#: seconds a close() waits for each thread it joins
JOIN_TIMEOUT_S = 10.0


def encode_msg(msg: dict) -> bytes:
    """Message dict -> wire payload. Messages carrying a binary columnar
    frame (msg["frame"]) use the AMWM binary envelope; everything else is
    plain JSON (byte-compatible with the reference protocol)."""
    frame = msg.get("frame")
    if frame is None:
        return json.dumps(msg).encode("utf-8")
    head = json.dumps({k: v for k, v in msg.items() if k != "frame"}
                      ).encode("utf-8")
    return _MSG_MAGIC + _MSG_HDR.pack(len(head)) + head + frame


def decode_msg(payload: bytes) -> dict:
    if payload[:4] != _MSG_MAGIC:
        return json.loads(payload.decode("utf-8"))
    (head_len,) = _MSG_HDR.unpack_from(payload, 4)
    body = 4 + _MSG_HDR.size + head_len
    msg = json.loads(payload[4 + _MSG_HDR.size:body].decode("utf-8"))
    msg["frame"] = payload[body:]
    return msg


def send_frame(sock: socket.socket, msg: dict) -> None:
    from ..utils import flightrec, metrics
    payload = encode_msg(msg)
    kind = _msg_kind(msg)
    sock.sendall(_HEADER.pack(len(payload)) + payload)
    metrics.bump("sync_msgs_sent")
    metrics.bump("sync_wire_bytes_sent", _HEADER.size + len(payload))
    # per-kind wire accounting (the docledger plane's exact-bytes side:
    # who pays for adverts vs changes vs audit vs metrics pulls)
    metrics.bump("sync_conn_bytes_sent", _HEADER.size + len(payload),
                 kind=kind)
    flightrec.record("frame_send", kind=kind,
                     doc=msg.get("docId"), n=len(payload))


def recv_frame(sock: socket.socket) -> dict | None:
    from ..utils import flightrec, metrics
    header = _recv_exact(sock, _HEADER.size)
    if header is None:
        return None
    (length,) = _HEADER.unpack(header)
    if length > MAX_FRAME:
        raise ValueError(f"frame of {length} bytes exceeds limit")
    payload = _recv_exact(sock, length)
    if payload is None:
        return None
    metrics.bump("sync_msgs_received")
    metrics.bump("sync_wire_bytes_received", _HEADER.size + length)
    msg = decode_msg(payload)
    kind = _msg_kind(msg)
    metrics.bump("sync_conn_bytes_received", _HEADER.size + length,
                 kind=kind)
    flightrec.record("frame_recv", kind=kind,
                     doc=msg.get("docId"), n=length)
    return msg


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except OSError:
            return None
        if not chunk:
            return None
        buf += chunk
    return buf


class LockedConnection(Connection):
    """Connection safe for concurrent entry from a socket reader thread and
    the application thread (Automerge's Connection assumes a single
    event loop; sockets give us two threads). Reentrant because receive_msg
    can re-enter doc_changed through DocSet handler gossip.

    The lock is SHARED by every connection attached to the same doc_set
    (one lock per doc_set — per-connection locks would deadlock: two
    reader threads each holding their own connection's lock while gossip
    tries to enter the other's, classic ABBA through DocSet handlers).
    It is installed as the base Connection's `_state_lock`, guarding the
    clock maps and send decisions in SHORT sections rather than the
    whole receive->apply->gossip chain. The apply itself runs outside it
    when the doc_set declares `concurrent_ingest` (EngineDocSet /
    ShardedEngineDocSet): N peer reader threads then ingest concurrently
    and group-commit through the service's epoch buffers instead of
    serializing node-wide — the multi-writer drain path. Plain DocSets
    (interpretive doc objects, not thread-safe) keep the apply under the
    shared lock via `_apply_lock`."""

    def __init__(self, doc_set, send_msg, wire: str = "json",
                 local_interest=None):
        super().__init__(doc_set, send_msg, wire=wire,
                         local_interest=local_interest)
        self._lock = _sync_lock_of(doc_set)
        self._state_lock = self._lock
        if not getattr(doc_set, "concurrent_ingest", False):
            self._apply_lock = self._lock


class _Peer:
    """One socket bound to one Connection; reads frames on a thread."""

    def __init__(self, doc_set, sock: socket.socket, wire: str = "json",
                 local_interest=None):
        self.sock = sock
        # monotonic stamp of the last PROCESSED inbound message — not
        # mere socket arrival: a chaos-hung peer still receives bytes,
        # and the supervisor's idle detector must see through that
        self.last_active = time.monotonic()
        # chaos targeting label, inherited from the doc_set this peer
        # serves (utils/chaos.py; None unless a bench/test labeled it)
        self._chaos_node = getattr(doc_set, "_chaos_node", None)
        # instrumented (utils/lockprof.py): a peer wedged mid-sendall
        # shows up in the contention plane (sync_lock_wait_s{lock=
        # peer_send}) and the post-mortem holder table names the thread
        # stuck inside the write
        self._send_lock = lockprof.InstrumentedLock("peer_send")
        self.connection = LockedConnection(doc_set, self._send, wire=wire,
                                           local_interest=local_interest)
        # named so flight-recorder event tails and watchdog span stacks
        # attribute socket work to the right peer reader (not "Thread-3")
        self._thread = threading.Thread(target=self._read_loop, daemon=True,
                                        name=f"amtpu-torch-tcp-read-"
                                             f"{id(sock):x}")
        self.closed = threading.Event()

    def _send(self, msg: dict) -> None:
        # chaos frame-drop (utils/chaos.py): env-gated loss injection for
        # the fleet health plane's fault-attribution proof. Only change-
        # bearing kinds are ever dropped (telemetry/audit/clock always
        # pass); the drop is counted like any other pre-write loss so
        # the doctor's frame-loss signal reads off a real series.
        if chaos.drop_frame(self._chaos_node, _msg_kind(msg)):
            from ..utils import metrics
            metrics.bump("sync_frames_dropped")
            return
        if chaos.conn_kill(self._chaos_node):
            # chaos conn_kill (utils/chaos.py): an established socket
            # torn down mid-stream. Only the socket dies here — the read
            # thread's exit runs the full close() (connection released,
            # closed set), exactly like an organic transport death, so
            # the supervisor sees the real failure signature.
            from ..utils import metrics
            metrics.bump("sync_frames_dropped")
            try:
                self.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self.sock.close()
            except OSError:
                pass
            return
        with self._send_lock:
            try:
                send_frame(self.sock, msg)
            except OSError:
                # organic transport loss counts on the SAME series the
                # injector uses — the fleet doctor's frame-loss signal
                # must see a genuinely failing peer socket, not only
                # chaos (the counter's documented contract)
                from ..utils import metrics
                metrics.bump("sync_frames_dropped")
                self.closed.set()

    def start(self) -> None:
        self.connection.open()
        self._thread.start()

    def _read_loop(self) -> None:
        try:
            while not self.closed.is_set():
                msg = recv_frame(self.sock)
                if msg is None:
                    break
                if chaos.peer_hang(self._chaos_node):
                    # chaos peer_hang (utils/chaos.py): accepted but
                    # unresponsive — the message is swallowed before any
                    # processing, so nothing is applied and nothing
                    # (metrics pulls included) is answered while the
                    # window is open; last_active freezes, which is what
                    # the supervisor's idle detector keys on
                    continue
                self.connection.receive_msg(msg)
                self.last_active = time.monotonic()
        finally:
            # always release the Connection (and its compaction-floor
            # registry entry) — a receive_msg exception must not leave a
            # dead peer's clock pinning the floor forever
            self.close()

    def close(self) -> None:
        if not self.closed.is_set():
            self.closed.set()
            self.connection.close()
            try:
                # shutdown BEFORE close: a bare close() of an fd another
                # thread is blocked in recv() on neither unblocks that
                # thread nor sends FIN (the kernel socket stays
                # referenced by the in-flight syscall) — the remote end
                # would never learn the link died. shutdown() tears the
                # connection down immediately on both sides.
                self.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self.sock.close()
            except OSError:
                pass
        self.join()

    def join(self) -> None:
        """Wait for the reader thread to exit (not from the reader
        itself, which closes its own peer on the way out)."""
        t = self._thread
        if t.ident is not None and t is not threading.current_thread():
            t.join(timeout=JOIN_TIMEOUT_S)


class TcpSyncServer:
    """Accepts peers and syncs a DocSet with each over its own Connection."""

    def __init__(self, doc_set, host: str = "127.0.0.1", port: int = 0,
                 wire: str = "json"):
        self.doc_set = doc_set
        self.wire = wire
        self._listener = socket.create_server((host, port))
        self.host, self.port = self._listener.getsockname()[:2]
        self.peers: list[_Peer] = []
        # guards self.peers: the accept thread prunes/appends while
        # close() (caller thread) snapshots — an unguarded rebind could
        # leak a peer accepted concurrently with close (pinned by
        # tests/test_race_regressions.py)
        self._peers_lock = locksan.named_lock("tcp_peers")
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True,
                                               name=f"amtpu-torch-tcp-"
                                                    f"accept-{self.port}")
        self._closed = threading.Event()

    def start(self) -> "TcpSyncServer":
        self._accept_thread.start()
        return self

    def _accept_loop(self) -> None:
        while not self._closed.is_set():
            try:
                sock, _ = self._listener.accept()
            except OSError:
                break
            # prune dead peers as replacements arrive: supervised
            # clients (SupervisedTcpClient) redial after every
            # transport death, and an append-only list would grow one
            # dead _Peer per reconnect forever on a long-lived server
            peer = _Peer(self.doc_set, sock, wire=self.wire)
            with self._peers_lock:
                if self._closed.is_set():
                    # lost the race with close(): close() already swept
                    # the list, so this peer must not be registered
                    peer.close()
                    break
                self.peers = [p for p in self.peers
                              if not p.closed.is_set()]
                self.peers.append(peer)
            peer.start()

    def close(self) -> None:
        self._closed.set()
        try:
            # shutdown first: closing a listening socket does not wake a
            # thread blocked in accept() on Linux; shutting it down does
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._listener.close()
        except OSError:
            pass
        if self._accept_thread.ident is not None:
            self._accept_thread.join(timeout=JOIN_TIMEOUT_S)
        with self._peers_lock:
            peers = list(self.peers)
        for peer in peers:
            peer.close()


class TcpSyncClient:
    """Connects a DocSet to a remote TcpSyncServer."""

    def __init__(self, doc_set, host: str, port: int, timeout: float = 10.0,
                 wire: str = "json", local_interest=None):
        sock = socket.create_connection((host, port), timeout=timeout)
        sock.settimeout(None)
        self.peer = _Peer(doc_set, sock, wire=wire,
                          local_interest=local_interest)

    def start(self) -> "TcpSyncClient":
        self.peer.start()
        return self

    def close(self) -> None:
        self.peer.close()


class SupervisedTcpClient:
    """Self-healing TCP client: a supervisor thread owns the link's
    lifecycle, so a dead read thread is a reconnect, not a silent stop.

    Without it, a peer socket dying mid-stream stops convergence for that
    peer: the TCP read thread exits, the Connection unregisters, and no
    error reaches the application. The supervisor closes that hole:

    - **exponential-backoff reconnect**: on transport death (organic
      OSError, chaos `conn_kill`, a force_reconnect() from the
      remediation engine), the supervisor redials with backoff doubling
      from `backoff_s` up to `backoff_max_s`, resetting after each
      successful connect. Attempts/successes land on
      `sync_reconnect_attempts` / `sync_reconnects`, and each
      re-established link records a `remed_action` event
      (action=reconnect) — self-healing is never silent.
    - **targeted backfill**: the carried InterestSet (one object across
      transport generations) seeds every replacement connection, and a
      narrowed interest is replayed via `resubscribe()` — reset form
      WITH clocks — so the serving side pushes exactly the suffix the
      dead window missed through its missing_changes snapshot read
      plane. Full-interest links recover through the ordinary
      anti-entropy of `open()`'s re-adverts.
    - **inbound-idle detection** (`idle_reconnect_s`, opt-in): a live
      socket whose PROCESSED inbound activity goes quiet past the
      threshold is torn down and redialed (`sync_reconnect_idle_kicks`)
      — the only way to catch an accepted-but-unresponsive peer (chaos
      `peer_hang`), whose socket never errors. Stamped on processed
      messages, not arrivals, so a hung reader cannot look alive.
    """

    def __init__(self, doc_set, host: str, port: int, wire: str = "json",
                 local_interest=None, backoff_s: float = 0.25,
                 backoff_max_s: float = 5.0,
                 idle_reconnect_s: float | None = None,
                 connect_timeout: float = 10.0, node: str | None = None,
                 on_reconnect=None):
        self._doc_set = doc_set
        self._host, self._port, self._wire = host, port, wire
        self._interest = local_interest
        self.backoff_s = backoff_s
        self.backoff_max_s = backoff_max_s
        self.idle_reconnect_s = idle_reconnect_s
        self._connect_timeout = connect_timeout
        self._node = node or getattr(doc_set, "_chaos_node", None)
        self.on_reconnect = on_reconnect
        self.generation = 0
        self._client: TcpSyncClient | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"amtpu-torch-tcp-supervisor-{port}")

    @property
    def connection(self) -> Connection | None:
        cli = self._client
        return cli.peer.connection if cli is not None else None

    def start(self) -> "SupervisedTcpClient":
        self._thread.start()
        return self

    def force_reconnect(self) -> None:
        """Tear the current link down; the supervisor redials. The
        remediation engine's `reconnect` action for wedged-but-open
        connections routes here."""
        cli = self._client
        if cli is not None:
            cli.close()

    def close(self) -> None:
        """Stop supervising and close the link (idempotent; joins)."""
        self._stop.set()
        cli = self._client
        if cli is not None:
            cli.close()
        if self._thread.ident is not None:
            self._thread.join(timeout=JOIN_TIMEOUT_S)

    def _loop(self) -> None:
        from ..utils import flightrec, metrics
        backoff = self.backoff_s
        while not self._stop.is_set():
            metrics.bump("sync_reconnect_attempts")
            try:
                cli = TcpSyncClient(
                    self._doc_set, self._host, self._port,
                    timeout=self._connect_timeout, wire=self._wire,
                    local_interest=self._interest)
            except OSError:
                if self._stop.wait(backoff):
                    return
                backoff = min(backoff * 2.0, self.backoff_max_s)
                continue
            cli.start()
            self._client = cli
            self.generation += 1
            conn = cli.peer.connection
            if self._interest is None:
                # adopt generation 1's set: later generations carry it
                self._interest = conn.local_interest
            if self.generation > 1:
                metrics.bump("sync_reconnects")
                flightrec.record("remed_action", action="reconnect",
                                 node=self._node,
                                 generation=self.generation)
                if self._interest.narrowed:
                    try:
                        conn.resubscribe()
                    except Exception:
                        pass   # the link may die again; the loop retries
                if self.on_reconnect is not None:
                    try:
                        self.on_reconnect(conn)
                    except Exception:
                        pass
            backoff = self.backoff_s        # healthy link: reset
            while not self._stop.is_set():
                if cli.peer.closed.wait(timeout=0.1):
                    break
                if self.idle_reconnect_s is not None and \
                        time.monotonic() - cli.peer.last_active \
                        > self.idle_reconnect_s:
                    metrics.bump("sync_reconnect_idle_kicks")
                    cli.close()
                    break
            cli.close()
            if self._stop.wait(backoff):
                return
            backoff = min(backoff * 2.0, self.backoff_max_s)
