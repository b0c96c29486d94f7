"""Compacted doc-state snapshots: fast replica bootstrap for deep history
(a copy of `automerge_tpu/sync/snapshots.py`; the image bytes equal the
reference's for the same prefix, and each package decodes the other's).

The segmented archive (sync/logarchive.py) keeps the full-fidelity
change history; replaying it is still O(history). This module holds the
compacted counterpart: a columnar doc-state image a fresh or evicted
replica loads in O(state), with the covered clock stamped on it so
correctness is checkable. The semidirect-product
composition view (arxiv 2004.04303) is the lever: a causally-closed
prefix composes into a state whose size tracks the VISIBLE document, not
the length of its history — for overwrite-heavy registers the image is
orders of magnitude smaller than the op log.

**What the image is.** Not serialized engine internals (fragile) and not
the raw change list (O(history)): the *survivor subset* of the prefix,
re-encoded as an ordinary columnar change frame (native/wire.py /
sync/frames.py — the engine's own pack format):

- every non-assign op (make*/ins) is kept — structural rows are inert in
  the survivor join and future inserts anchor at their element ids;
- an assign (set/del/link) is kept iff nothing in the prefix dominates
  it — the same host-side domination join `kernels.field_states` runs on
  device (per field, the per-actor max over the assigns' transitive
  change clocks); dominated assigns are dead forever (domination is
  monotone), so dropping them is exact for ANY suffix;
- changes left with zero ops vanish, and the kept changes are
  RENUMBERED per-actor (seq -> rank among kept) so the subset is a
  gap-free, causally-valid history an unmodified engine admits through
  its ordinary ingress — no trusted side door into admission;
- each kept change's deps are rewritten to its FULL transitive clock
  (rank-mapped), so the bootstrap replay reconstructs exactly the
  original domination relations among the kept ops (rank-mapping is
  order-preserving on kept seqs, and transitive deps need no memo
  lookups at admission time).

After the frame admits, the engine's clock is SEEDED to the covered
clock (ResidentRowsDocSet.seed_clock) with the per-actor head closures
from the image, so the suffix — archive tail or live sync — admits with
its original seqs, duplicates below the clock drop idempotently, and
`causal_floor` keeps working. Post-seed clock rows are clamped to the
covered clock: every conforming suffix change covers the snapshot floor
(the writer snapshots at the compaction floor, which registered peers'
future changes provably cover — the same conformance contract
CompactionAnchorError already imposes), so the clamp reconstructs the
transitive coverage the dropped prefix memos would have provided, and
the converged state — and its content hash, which mixes (field, actor,
value, visible rank) and never seqs — is byte-equal to a full-history
replay.

**The file.** One crash-safe image per doc under the store root:
``<sha1(doc)[:20]>.snap`` = magic ``AMSS1`` + u32 header length + JSON
header (covered clock, head closures, change/op counts, crc32 and raw
length of the payload) + zlib-compressed AMW1 frame. Writes go
write-temp-then-rename with a directory fsync; a crash between the tmp
write and the rename leaves the previous image (or none) intact and the
orphan tmp is ignored and overwritten by the next writer.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import zlib
from bisect import bisect_right
from collections import OrderedDict

from ..core.change import Change
from ..native.wire import changes_to_columns
from ..utils import lockprof, metrics
from .frames import bytes_to_columns, columns_to_bytes
from .logarchive import timed_fsync

SNAP_MAGIC = b"AMSS1"
_ASSIGNS = ("set", "del", "link")
# a MAP move joins the domination pass on its target's LOCATION field —
# the same key the engine encoders use (engine/encode.move_loc_key): a
# reparent chain compacts exactly like an assign chain, only the
# surviving position is live state. A map location op dominated by a
# later location op of the same child can never win resolution nor serve
# as its cycle fallback (core/moves.py prunes it at admission for the
# same reason), so dropping it here is exact for any suffix. LIST moves
# (elem >= 0) are deliberately EXEMPT: a dominated list move is still
# "this element has moved" awareness evidence for the ghost/placed
# anchoring split (opset.anchored_at_placed), so dropping it would shift
# siblings admitted in between — they compact as ordinary kept ops.
_LOC_FIELD = "\x00loc\x00"


def _joins_move_chain(op) -> bool:
    return op.action == "move" and (op.elem is None or op.elem < 0)


def _field_of(op):
    if op.action == "move":
        return (_LOC_FIELD, op.value)
    return (op.obj, op.key)

#: loaded-image cache entries kept (LRU by doc)
CACHE_SNAPS = int(os.environ.get("AMTPU_SNAPSHOT_CACHE_DOCS", "8"))


class SnapshotImage:
    """One decoded snapshot: the covered clock (original numbering), the
    per-actor head closures (transitive clocks of the covered heads, for
    clock seeding + causal_floor), and the kept-change frame."""

    __slots__ = ("clock", "heads", "kept_seqs", "frame_bytes", "n_changes",
                 "n_ops", "payload_bytes")

    def __init__(self, clock, heads, kept_seqs, frame_bytes, n_changes,
                 n_ops, payload_bytes):
        self.clock = clock
        self.heads = heads
        self.kept_seqs = kept_seqs
        self.frame_bytes = frame_bytes
        self.n_changes = n_changes
        self.n_ops = n_ops
        self.payload_bytes = payload_bytes

    def columns(self):
        return bytes_to_columns(self.frame_bytes)


# ---------------------------------------------------------------------------
# the compaction pass (host-side survivor join over a causally-closed prefix)


def compact_prefix(changes) -> dict:
    """Compact one doc's causally-closed prefix into the survivor subset.

    `changes` must be the prefix in admission (causal) order — exactly
    what LogArchive.read returns. Returns
    ``{"kept": [Change], "clock": {...}, "heads": {actor: closure},
    "n_in": int, "ops_in": int, "ops_kept": int}`` where `kept` carries
    renumbered seqs and full-transitive rank-mapped deps.
    """
    # pass 1: transitive clock row per change + per-field domination max.
    # closure[(a, s)] = transitive clock of change (a, s) EXCLUDING its
    # own (a, s) coordinate — the engine's state_clocks convention.
    closures: dict[tuple, dict] = {}
    rows: list[dict] = []
    clock: dict[str, int] = {}
    fld: dict[tuple, dict] = {}
    ops_in = 0
    for c in changes:
        base = dict(c.deps)
        base[c.actor] = c.seq - 1
        row: dict[str, int] = {}
        for a, s in base.items():
            if s <= 0:
                continue
            trans = closures.get((a, s))
            if trans:
                for a2, s2 in trans.items():
                    if s2 > row.get(a2, 0):
                        row[a2] = s2
            if s > row.get(a, 0):
                row[a] = s
        rows.append(row)
        closures[(c.actor, c.seq)] = row
        if c.seq > clock.get(c.actor, 0):
            clock[c.actor] = c.seq
        ops_in += len(c.ops)
        has_assign = any(op.action in _ASSIGNS or _joins_move_chain(op)
                         for op in c.ops)
        if has_assign:
            own = dict(row)
            # a change's own assigns dominate earlier same-field assigns
            # of the same actor (clock row holds own actor at seq-1)
            for op in c.ops:
                if op.action not in _ASSIGNS and not _joins_move_chain(op):
                    continue
                f = fld.setdefault(_field_of(op), {})
                for a, s in own.items():
                    if s > f.get(a, 0):
                        f[a] = s

    # pass 2: survivors. An assign (actor A, seq s) on field f is kept
    # iff no assign on f has a clock row covering it: fld[f][A] < s.
    kept_raw: list[tuple[Change, list]] = []
    ops_kept = 0
    for c, row in zip(changes, rows):
        ops = []
        for op in c.ops:
            if op.action in _ASSIGNS or _joins_move_chain(op):
                if fld[_field_of(op)].get(c.actor, 0) >= c.seq:
                    continue            # dominated: dead forever
            ops.append(op)
        if ops:
            ops_kept += len(ops)
            kept_raw.append((c, ops))

    # pass 3: renumber per actor; deps = full transitive row, rank-mapped
    kept_seqs: dict[str, list[int]] = {}
    for c, _ops in kept_raw:
        kept_seqs.setdefault(c.actor, []).append(c.seq)

    def rank(a: str, s: int) -> int:
        return bisect_right(kept_seqs.get(a, ()), s)

    kept: list[Change] = []
    for c, ops in kept_raw:
        row = closures[(c.actor, c.seq)]
        deps = {}
        for a, s in row.items():
            r = rank(a, s)
            if a == c.actor or r <= 0:
                continue               # own coord is implicit (seq - 1)
            deps[a] = r
        kept.append(Change(c.actor, rank(c.actor, c.seq), deps, ops,
                           c.message))

    heads = {a: dict(closures.get((a, s)) or {}) for a, s in clock.items()}
    return {"kept": kept, "clock": clock, "heads": heads,
            "kept_seqs": kept_seqs,
            "n_in": len(rows), "ops_in": ops_in, "ops_kept": ops_kept}


def remap_tail(tail, clock: dict, kept_seqs: dict) -> list[Change]:
    """Rebase original-numbered suffix changes onto the renumbered
    image history: seq' = rank(seq) where rank extends the image's
    kept-seq ranking monotonically past the covered clock (tail seqs
    map to k_a + (s - clock[a])), and dep coordinates map through the
    same function. A monotone per-actor bijection over the replayed set
    preserves every coverage/concurrency decision, so the interpretive
    replay of image + remapped tail yields the identical visible state
    (the reference's ResidentRowsDocSet.materialize uses this for
    snapshot-booted docs whose original-numbered prefix exists only as
    the image)."""
    def rank(a: str, s: int) -> int:
        ceiling = clock.get(a, 0)
        ks = kept_seqs.get(a, ())
        if s > ceiling:
            return len(ks) + (s - ceiling)
        return bisect_right(ks, s)

    out = []
    for c in tail:
        deps = {}
        for a, s in c.deps.items():
            r = rank(a, s)
            if r > 0:
                deps[a] = r
        out.append(Change(c.actor, rank(c.actor, c.seq), deps, list(c.ops),
                          c.message))
    return out


def validate_tail(tail, clock: dict, heads: dict) -> bool:
    """Receive-side conformance gate: True when every tail change's
    transitive clock row covers the snapshot clock. The walk mirrors
    compact_prefix's closure pass, seeded with the image's head
    closures; references to compacted-away sub-head prefix seqs
    contribute only their raw coordinate, so the check is conservative
    — a False here routes the caller to full-history replay, never to
    an unsound snapshot boot."""
    closures: dict[tuple, dict] = {
        (a, s): dict(heads.get(a) or {}) for a, s in clock.items()}
    for c in tail:
        base = dict(c.deps)
        base[c.actor] = c.seq - 1
        row: dict[str, int] = {}
        for a, s in base.items():
            if s <= 0:
                continue
            trans = closures.get((a, s))
            if trans:
                for a2, s2 in trans.items():
                    if s2 > row.get(a2, 0):
                        row[a2] = s2
            if s > row.get(a, 0):
                row[a] = s
        closures[(c.actor, c.seq)] = row
        for a, s in clock.items():
            have = row.get(a, 0)
            if a == c.actor and c.seq > have:
                have = c.seq
            if have < s:
                return False
    return True


# ---------------------------------------------------------------------------
# the store


class SnapshotStore:
    """Crash-safe per-doc snapshot images under one directory."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.chaos_node: str | None = None
        self._lock = lockprof.InstrumentedLock("snapshots")
        # doc_id -> (file identity, SnapshotImage, raw blob): ONE cache
        # entry serves both load() and payload(), so a wire serve never
        # re-reads the file it just verified (and can never pair an
        # image with a blob a concurrent write() replaced underneath)
        self._cache: "OrderedDict[str, tuple]" = OrderedDict()

    def _path(self, doc_id: str) -> str:
        h = hashlib.sha1(doc_id.encode()).hexdigest()[:20]
        return os.path.join(self.root, f"{h}.snap")

    def _fsync_dir(self) -> None:
        try:
            fd = os.open(self.root, os.O_RDONLY)
        except OSError:
            return
        try:
            os.fsync(fd)
        except OSError:
            pass
        finally:
            os.close(fd)

    # -- write ---------------------------------------------------------------

    def write(self, doc_id: str, compacted: dict) -> dict:
        """Serialize one compact_prefix result as the doc's image.
        Write-temp-then-rename with file AND directory fsync: a crash at
        any point leaves the previous image (or none), never a torn one."""
        kept = compacted["kept"]
        frame = columns_to_bytes(changes_to_columns(kept))
        payload = zlib.compress(frame, 6)
        head = {
            "doc": doc_id,
            "clock": compacted["clock"],
            "heads": compacted["heads"],
            "kept_seqs": compacted["kept_seqs"],
            "n_changes": len(kept),
            "n_ops": compacted["ops_kept"],
            "compacted_from": {"changes": compacted["n_in"],
                               "ops": compacted["ops_in"]},
            "raw_len": len(frame),
            "crc32": zlib.crc32(payload) & 0xFFFFFFFF,
        }
        hb = json.dumps(head, separators=(",", ":")).encode()
        blob = SNAP_MAGIC + struct.pack("<I", len(hb)) + hb + payload
        path = self._path(doc_id)
        tmp = path + ".tmp"
        with self._lock:
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                timed_fsync(f, self.chaos_node)
            os.replace(tmp, path)
            self._fsync_dir()
            self._cache.pop(doc_id, None)
        metrics.bump("sync_snapshot_writes")
        metrics.bump("sync_snapshot_bytes_written", len(blob))
        return {"bytes": len(blob), "n_changes": len(kept),
                "clock": dict(compacted["clock"])}

    # -- read ----------------------------------------------------------------

    @staticmethod
    def decode(blob: bytes) -> SnapshotImage:
        """Parse one image blob (file or wire payload), verifying the
        magic and payload crc before anything is trusted."""
        if blob[:5] != SNAP_MAGIC:
            raise ValueError("not a snapshot image (bad magic)")
        (hlen,) = struct.unpack_from("<I", blob, 5)
        head = json.loads(blob[9:9 + hlen].decode("utf-8"))
        payload = blob[9 + hlen:]
        if (zlib.crc32(payload) & 0xFFFFFFFF) != head["crc32"]:
            raise ValueError("snapshot payload crc mismatch")
        frame = zlib.decompress(payload)
        if len(frame) != head["raw_len"]:
            raise ValueError("snapshot payload length mismatch")
        return SnapshotImage(dict(head["clock"]),
                             {a: dict(cl)
                              for a, cl in (head.get("heads") or {}).items()},
                             {a: list(s)
                              for a, s in (head.get("kept_seqs")
                                           or {}).items()},
                             frame, int(head["n_changes"]),
                             int(head.get("n_ops", 0)), len(blob))

    def _load_entry(self, doc_id: str):
        """(image, blob) from the shared cache (filled on miss), or
        None when no image exists. A torn/corrupt image raises."""
        path = self._path(doc_id)
        with self._lock:
            try:
                st = os.stat(path)
            except OSError:
                return None
            ident = (st.st_size, st.st_mtime_ns)
            hit = self._cache.get(doc_id)
            if hit is not None and hit[0] == ident:
                self._cache.move_to_end(doc_id)
                return hit[1], hit[2]
        with open(path, "rb") as f:
            blob = f.read()
        img = self.decode(blob)
        metrics.bump("sync_snapshot_loads")
        with self._lock:
            self._cache[doc_id] = (ident, img, blob)
            self._cache.move_to_end(doc_id)
            while len(self._cache) > max(0, CACHE_SNAPS):
                self._cache.popitem(last=False)
        return img, blob

    def payload(self, doc_id: str) -> bytes | None:
        """The doc's raw image blob (for wire shipping), or None —
        served from the same cache entry load() verified, so the blob
        can never disagree with the image a caller just checked."""
        entry = self._load_entry(doc_id)
        return entry[1] if entry is not None else None

    def load(self, doc_id: str) -> SnapshotImage | None:
        """Decode the doc's image (LRU-cached by file identity);
        None when no image exists. A torn/corrupt image raises."""
        entry = self._load_entry(doc_id)
        return entry[0] if entry is not None else None

    def doc_ids(self) -> list[str]:
        """Doc ids with an image on disk (header-only reads: the doc id
        is recorded in each image's JSON header; file names are hashed).
        Unreadable/torn images — e.g. a crash-orphaned ``.tmp`` — are
        skipped."""
        out = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        for name in sorted(names):
            if not name.endswith(".snap"):
                continue
            try:
                with open(os.path.join(self.root, name), "rb") as f:
                    if f.read(5) != SNAP_MAGIC:
                        continue
                    (hlen,) = struct.unpack("<I", f.read(4))
                    head = json.loads(f.read(hlen).decode("utf-8"))
                out.append(head["doc"])
            except (OSError, ValueError, KeyError, struct.error):
                continue
        return out

    def adopt(self, doc_id: str, blob: bytes) -> None:
        """Persist a wire-received image so this replica can re-serve
        it to the next joiner (decode-validated first; same timed,
        chaos-injectable fsync discipline as every other storage-tier
        durability point)."""
        self.decode(blob)
        path = self._path(doc_id)
        tmp = path + ".tmp"
        with self._lock:
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                timed_fsync(f, self.chaos_node)
            os.replace(tmp, path)
            self._fsync_dir()
            self._cache.pop(doc_id, None)
