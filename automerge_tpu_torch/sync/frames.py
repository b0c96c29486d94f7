"""Columnar wire frames (the port of `automerge_tpu/sync/frames.py`): the
per-list frame (AMW1), the round frame (AMR1), and the protocol's message
headers and classes (`TRACE_KEY`, `OPLAG_KEY`, `TRACEPLANE_KEY`,
`SUB_KEY`, `SNAP_KEY`, `msg_kind`, `pack_trace`, `unpack_trace`), each
the reference's byte for byte, so a port node and a reference node speak
one protocol.

A frame is a self-contained binary serialization of a change list as
struct-of-arrays (integer columns plus frame-local string tables) whose
schema is exactly `native.wire.WireColumns`, so that:

- decode is a handful of `np.frombuffer` views (no per-op parsing);
- the receiver feeds the columns, and the raw frame bytes, straight to the
  native delta encoder without materializing per-op Python objects;
- relaying a decoded frame is `columns_to_bytes`, again no per-op work;
- values keep their exact types (int vs float vs bool).

Layout (little-endian):
    magic  b"AMW1"
    u32 x 8   n_changes n_ops n_deps n_actors n_objects n_keys n_messages n_strings
    i32[n_changes]    change_actor
    i32[n_changes]    change_seq
    i32[n_changes]    change_msg      (-1 = no message)
    i32[n_changes+1]  deps_off
    i32[n_deps]       deps_actor
    i32[n_deps]       deps_seq
    i32[n_changes+1]  op_off
    i8 [n_ops]        op_action       (storage._ACTIONS index)
    i32[n_ops]        op_obj
    i32[n_ops]        op_key          (-1 = none)
    i32[n_ops]        op_elem         (-1 = none)
    i8 [n_ops]        op_vtag         (native.wire V_* tag)
    i64[n_ops]        op_vint
    f64[n_ops]        op_vdbl
    i32[n_ops]        op_vstr
    5 string tables (actors, objects, keys, messages, strings), each:
        i32[n+1] byte offsets, then the UTF-8/WTF-8 blob (offsets[n] bytes)

A round frame (AMR1) covers many documents:
    magic  b"AMR1"
    u32       n_docs
    i32[n_docs+1]  change_off (the changes of doc k are change_off[k:k+2])
    i32[n_docs+1]  doc id byte offsets, then the doc id blob
    one AMW1 frame holding every change of the round
"""

from __future__ import annotations

import struct

import numpy as np

from ..core.change import Change
from ..native.wire import WireColumns, changes_to_columns, concat_columns
from ..utils import perfscope

FRAME_MAGIC = b"AMW1"
ROUND_MAGIC = b"AMR1"

# ---------------------------------------------------------------------------
# trace-context header
#
# Cross-replica trace propagation (docs/OBSERVABILITY.md): every protocol
# message MAY carry a `"trace"` key holding the sender's span context in
# the compact form `<trace_id>-<span_id>` (hex, 16+8 chars). The receiver
# adopts it (metrics.adopt_context) so its serving spans join the sender's
# trace. It rides in the JSON part of the message — the plain-JSON wire and
# the AMWM binary envelope's JSON head both carry it unchanged — and peers
# that predate it simply ignore the key.

TRACE_KEY = "trace"

# Op-lifecycle provenance header (utils/oplag.py): change-bearing
# messages whose doc carries a sampled op additionally ship an
# `"oplag": "<id>,<t_admit>,<t_send>"` key beside the trace header —
# same envelope rules (JSON part of both wire forms; unknown-key-ignored
# by peers that predate it). The receiver records the wire / peer-apply /
# convergence lag stages from it (docs/OBSERVABILITY.md "Contention &
# convergence lag").
OPLAG_KEY = "oplag"

# Trace-plane stitching header (utils/tracer.py — r19): a change-bearing
# message whose doc carries sampled lifecycle traces ships a
# `"traceplane": [{tid, actor, seq, t0, sent, origin, spans, meta}, ...]`
# key beside the oplag header — the SENDER'S accumulated stage spans plus
# its wall epoch, so the receiving service stitches its own
# decode/admission/visibility spans onto them and completes ONE
# cross-process trace. Same envelope rules (JSON part of both wire forms;
# unknown-key-ignored by peers that predate it). With AMTPU_TRACE_SAMPLE
# unset the key is never emitted — the envelope stays byte-identical
# (the bench config-19 parity gate).
TRACEPLANE_KEY = "traceplane"

# Subscription (interest) protocol message (sync/connection.py): a peer
# declares WHICH docs it wants synced instead of the whole DocSet —
# `{"sub": {"add": [...], "prefixes": [...], "remove": [...],
# "remove_prefixes": [...], "reset": bool, "mode": "all"?,
# "clocks": {doc: clock}}}`. Plain JSON, so it crosses the TCP envelope
# and any reference-framing relay unchanged; peers that predate the
# message keep full-DocSet sync (interest defaults to everything). The
# optional `clocks` map carries the subscriber's current frontiers for
# explicitly-added docs — the serving side backfills exactly the
# missing suffix through the ordinary `missing_changes` snapshot read
# plane, never a full-DocSet replay (docs/INTERNALS.md "Interest-based
# partial replication").
SUB_KEY = "sub"

# Snapshot-bootstrap message (sync/connection.py + sync/snapshots.py): a
# serving peer answers a fresh joiner's empty-clock subscribe with
# `{"docId": ..., "clock": {...}, "snap": {"clock": {...}, "b64": ...}}`
# — a base64 compacted doc-state image covering `snap.clock`, followed by
# the ordinary missing-suffix frames. Base64 keeps the image JSON-clean,
# so it crosses the plain wire, the AMWM envelope's JSON head, and any
# reference-framing relay unchanged. Strictly opt-in: the joiner
# declares `"snap": 1` inside its sub delta (only doc_sets exposing
# apply_snapshot do), and peers that predate the key never see one.
SNAP_KEY = "snap"


def msg_kind(msg: dict) -> str:
    """Coarse protocol-message class: the label space of the per-kind
    traffic accounting (`sync_conn_msgs_*{kind=...}` /
    `sync_conn_bytes_*{kind=...}`) and of flight-recorder frame
    breadcrumbs. Lives here (not sync/tcp.py, its original home) so the
    transport-agnostic Connection classifies without a transport
    import."""
    if "metrics" in msg:
        return f"metrics:{msg['metrics']}"
    if "audit" in msg:
        return f"audit:{msg['audit']}"
    if "sub" in msg:
        return "sub"
    if msg.get("snap") is not None:
        return "snapshot"
    if msg.get("frame") is not None:
        return "frame"
    if msg.get("changes") is not None:
        return "changes"
    return "clock"


def pack_trace(ctx: dict) -> str:
    """`{"tid": ..., "sid": ...}` -> compact `tid-sid` wire header."""
    return f"{ctx['tid']}-{ctx.get('sid') or ''}"


def unpack_trace(header) -> dict | None:
    """Wire header -> `{"tid", "sid"}`; None for absent/malformed values
    (an untraced or foreign peer must never break message handling)."""
    if not isinstance(header, str) or not header:
        return None
    tid, _, sid = header.partition("-")
    if not tid:
        return None
    return {"tid": tid, "sid": sid or None}


# ---------------------------------------------------------------------------
# columns <-> bytes

def _blob(items: list[str]) -> tuple[np.ndarray, bytes]:
    offsets = np.zeros(len(items) + 1, np.int32)
    parts = []
    pos = 0
    for i, s in enumerate(items):
        b = s.encode("utf-8", "surrogatepass")
        parts.append(b)
        pos += len(b)
        offsets[i + 1] = pos
    return offsets, b"".join(parts)


def columns_to_bytes(cols: WireColumns) -> bytes:
    """Serialize columns into one frame. No per-op work: numpy buffer
    concatenation, so relaying a decoded frame costs O(columns)."""
    n_changes = len(cols.change_actor)
    n_ops = len(cols.op_action)
    n_deps = len(cols.deps_actor)
    head = FRAME_MAGIC + struct.pack(
        "<8I", n_changes, n_ops, n_deps, len(cols.actors), len(cols.objects),
        len(cols.keys), len(cols.messages), len(cols.strings))
    parts = [head]
    for arr, dtype in (
            (cols.change_actor, np.int32), (cols.change_seq, np.int32),
            (cols.change_msg, np.int32), (cols.deps_off, np.int32),
            (cols.deps_actor, np.int32), (cols.deps_seq, np.int32),
            (cols.op_off, np.int32), (cols.op_action, np.int8),
            (cols.op_obj, np.int32), (cols.op_key, np.int32),
            (cols.op_elem, np.int32), (cols.op_vtag, np.int8),
            (cols.op_vint, np.int64), (cols.op_vdbl, np.float64),
            (cols.op_vstr, np.int32)):
        parts.append(np.ascontiguousarray(arr, dtype=dtype).tobytes())
    for items in (cols.actors, cols.objects, cols.keys, cols.messages,
                  cols.strings):
        offsets, blob = _blob(items)
        parts.append(offsets.tobytes())
        parts.append(blob)
    return b"".join(parts)


def bytes_to_columns(data: bytes) -> WireColumns:
    """Deserialize a frame: `np.frombuffer` views over the payload (copy-free
    for the integer columns) plus the five string tables."""
    if data[:4] != FRAME_MAGIC:
        raise ValueError("not a columnar wire frame (bad magic)")
    (n_changes, n_ops, n_deps, n_actors, n_objects, n_keys, n_messages,
     n_strings) = struct.unpack_from("<8I", data, 4)
    pos = 4 + 32

    def arr(n, dtype):
        nonlocal pos
        nbytes = n * np.dtype(dtype).itemsize
        out = np.frombuffer(data, dtype=dtype, count=n, offset=pos)
        pos += nbytes
        return out

    def table(n):
        nonlocal pos
        offsets = arr(n + 1, np.int32)
        blob_len = int(offsets[-1]) if n else 0
        blob = data[pos:pos + blob_len]
        pos += blob_len
        return [blob[offsets[i]:offsets[i + 1]].decode("utf-8", "surrogatepass")
                for i in range(n)]

    cols = WireColumns(
        change_actor=arr(n_changes, np.int32),
        change_seq=arr(n_changes, np.int32),
        change_msg=arr(n_changes, np.int32),
        deps_off=arr(n_changes + 1, np.int32),
        deps_actor=arr(n_deps, np.int32),
        deps_seq=arr(n_deps, np.int32),
        op_off=arr(n_changes + 1, np.int32),
        op_action=arr(n_ops, np.int8),
        op_obj=arr(n_ops, np.int32),
        op_key=arr(n_ops, np.int32),
        op_elem=arr(n_ops, np.int32),
        op_vtag=arr(n_ops, np.int8),
        op_vint=arr(n_ops, np.int64),
        op_vdbl=arr(n_ops, np.float64),
        op_vstr=arr(n_ops, np.int32),
        actors=table(n_actors), objects=table(n_objects), keys=table(n_keys),
        messages=table(n_messages), strings=table(n_strings))
    if pos != len(data):
        raise ValueError(f"frame has {len(data) - pos} trailing bytes")
    # retain the raw frame: it is the native delta encoder's direct input
    cols.frame_bytes = bytes(data)
    return cols


@perfscope.phased("sync_wire")
def encode_frame(changes: list[Change]) -> bytes:
    return columns_to_bytes(changes_to_columns(changes))


@perfscope.phased("sync_wire")
def decode_frame(data: bytes) -> WireColumns:
    return bytes_to_columns(data)


# ---------------------------------------------------------------------------
# round frames: one frame per sync round, covering many documents

class RoundColumns:
    """A decoded round frame: one WireColumns holding every change of the
    round, plus the doc table mapping contiguous change ranges to doc ids.
    `cols.frame_bytes` is the embedded AMW1 frame, the native delta
    encoder's direct input, shared by all documents of the round."""

    __slots__ = ("doc_ids", "change_off", "cols")

    def __init__(self, doc_ids: list[str], change_off: np.ndarray,
                 cols: WireColumns):
        self.doc_ids = doc_ids
        self.change_off = change_off
        self.cols = cols

    def to_dict(self) -> dict[str, list[Change]]:
        chs = self.cols.to_changes()  # bulk materialization, one pass
        off = self.change_off
        return {d: chs[int(off[k]):int(off[k + 1])]
                for k, d in enumerate(self.doc_ids)}


@perfscope.phased("sync_wire")
def encode_round_frame(deltas: dict[str, list[Change]]) -> bytes:
    """Serialize one sync round, {doc_id: [Change]}, as a single frame: the
    receiver decodes O(1) frames per round instead of O(docs)."""
    doc_ids = list(deltas)
    all_changes: list[Change] = []
    off = np.zeros(len(doc_ids) + 1, np.int32)
    for k, d in enumerate(doc_ids):
        chs = deltas[d]
        if not isinstance(chs, list):
            chs = chs.to_changes()  # relaying decoded per-doc columns
        all_changes.extend(chs)
        off[k + 1] = len(all_changes)
    inner = columns_to_bytes(changes_to_columns(all_changes))
    id_off, id_blob = _blob(doc_ids)
    return b"".join([ROUND_MAGIC, struct.pack("<I", len(doc_ids)),
                     off.tobytes(), id_off.tobytes(), id_blob, inner])


def round_from_columns(deltas: dict[str, WireColumns]) -> RoundColumns:
    """Coalesce per-doc column batches into one decoded round without
    materializing Change objects (native.wire.concat_columns). The merged
    frame bytes are attached so the native delta encoder reads them
    directly."""
    return round_from_parts({d: [c] for d, c in deltas.items()})


def round_from_parts(doc_parts: dict[str, list]) -> RoundColumns:
    """Like round_from_columns but accepting several column batches per doc
    (a coalescing service's pending queue): one concat across everything
    instead of per-doc merges followed by a cross-doc merge."""
    doc_ids = list(doc_parts)
    flat = []
    off = np.zeros(len(doc_ids) + 1, np.int32)
    for k, d in enumerate(doc_ids):
        parts = doc_parts[d]
        flat.extend(parts)
        off[k + 1] = off[k] + sum(p.n_changes for p in parts)
    merged = concat_columns(flat)
    # a single-part passthrough may already carry its received frame bytes;
    # serialize only when absent (and cache them for the native encoder)
    if getattr(merged, "frame_bytes", None) is None:
        merged.frame_bytes = columns_to_bytes(merged)
    return RoundColumns(doc_ids, off, merged)


@perfscope.phased("sync_wire")
def decode_round_frame(data: bytes) -> RoundColumns:
    if data[:4] != ROUND_MAGIC:
        raise ValueError("not a round frame (bad magic)")
    n_docs = struct.unpack_from("<I", data, 4)[0]
    pos = 8
    change_off = np.frombuffer(data, np.int32, n_docs + 1, pos)
    pos += (n_docs + 1) * 4
    id_off = np.frombuffer(data, np.int32, n_docs + 1, pos)
    pos += (n_docs + 1) * 4
    blob_len = int(id_off[-1]) if n_docs else 0
    blob = data[pos:pos + blob_len]
    pos += blob_len
    doc_ids = [blob[id_off[i]:id_off[i + 1]].decode("utf-8", "surrogatepass")
               for i in range(n_docs)]
    return RoundColumns(doc_ids, change_off, bytes_to_columns(data[pos:]))
