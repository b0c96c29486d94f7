"""Segmented append-only change-log archive for the log-horizon layer (a
copy of `automerge_tpu/sync/logarchive.py`; its files are the same storage
format, byte for byte, and each package reads the other's).

Row compaction (engine/compaction.py) bounds the DEVICE working set of a
long-lived document; this archive bounds the HOST working set by holding
the causally-stable log prefix (everything below the peer-clock floor) on
disk, as rolled SEGMENTS:

- the ACTIVE segment (``<h>.jsonl``) is the only file ever appended to or
  tail-repaired; each append is one buffered write + fsync;
- when the active segment exceeds the size/record rotation bounds it is
  SEALED: tail-repaired, renamed to ``<h>.sNNNN.jsonl`` (dir-fsynced), and
  a manifest entry recording its byte size, record count and per-actor
  clock range is committed write-temp-then-rename. Sealed segments are
  immutable;
- the parse cache is per SEALED segment (never invalidated, only evicted)
  plus a (size, mtime)-keyed entry for the active tail, so a peer catching
  up over many rounds re-parses only the active tail;
- a sealed segment whose on-disk size or record count disagrees with its
  manifest entry raises (`SegmentMismatchError`): the archive is the only
  copy of the truncated prefix;
- a crash between the seal rename and the manifest commit is recovered on
  the next open: orphan sealed files are parsed once and adopted into the
  manifest.

``read()`` returns an immutable per-read tuple served from the cache;
callers that need a mutable list copy it themselves.

The snapshot layer (sync/snapshots.py) sits beside this: segments keep the
full-fidelity history, snapshots hold the compacted doc-state image a
fresh replica boots from.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import time as _time
from collections import OrderedDict

from ..core.change import Change, coerce_change
from ..utils import chaos, lockprof, metrics

#: parsed-prefix read cache entries kept for ACTIVE segments (LRU by doc)
CACHE_DOCS = int(os.environ.get("AMTPU_ARCHIVE_CACHE_DOCS", "8"))
#: sealed-segment cache entries kept (LRU; entries never invalidate, only
#: evict — sealed segments are immutable)
CACHE_SEGS = int(os.environ.get("AMTPU_ARCHIVE_CACHE_SEGS", "64"))
#: rotation bounds for the active segment: seal when the NEXT append
#: would grow it past either (bytes checked pre-append; records from
#: the in-memory running count, rehydrated by the next active-tail
#: parse after a restart)
SEGMENT_BYTES = int(os.environ.get("AMTPU_ARCHIVE_SEGMENT_BYTES",
                                   str(4 * 1024 * 1024)))
SEGMENT_RECORDS = int(os.environ.get("AMTPU_ARCHIVE_SEGMENT_RECORDS",
                                     "8192"))

_SEAL_RE = re.compile(r"\.s(\d{4,})\.jsonl$")


def timed_fsync(f, chaos_node: str | None) -> None:
    """THE storage-tier fsync: one chaos-injectable, histogram-timed
    file sync shared by every durability point (archive appends, seals,
    manifests, snapshot writes/adoptions — sync/snapshots.py imports
    this), so the `disk_stall` fault and the `sync_archive_fsync_s`
    evidence the doctor's storage_stall cause reads cover ALL of them.
    The injected stall sleeps INSIDE the timed window — the signature
    is precisely "fsyncs got slow"."""
    t0 = _time.perf_counter()
    chaos.disk_stall(chaos_node)
    os.fsync(f.fileno())
    metrics.observe("sync_archive_fsync_s", _time.perf_counter() - t0)


class SegmentMismatchError(RuntimeError):
    """A sealed segment's on-disk bytes/records disagree with its
    manifest entry. Sealed segments are immutable by contract; serving
    one that changed underneath the manifest would be silent divergence,
    so the read fails loudly instead."""


class LogArchive:
    """Per-document segmented append-only JSONL archive under one
    directory, with the ``append``/``read`` surface every attach point
    (the engine's rebuild-from-log, the service's cold reads) uses."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        # chaos targeting label (utils/chaos.py disk_stall): set by the
        # owning service/test so storage-fault injection can be scoped to
        # one node of an in-process fleet
        self.chaos_node: str | None = None
        # The lock guards appends/seals (tail repair + write + fsync +
        # rotation must not interleave) and the cache/manifest tables.
        # Reads only SNAPSHOT file identities under it; the O(segment)
        # parses run OUTSIDE the lock (one lagging peer's cold read must
        # not stall concurrent appends).
        self._lock = lockprof.InstrumentedLock("archive")
        # doc_id -> ((size, mtime_ns), parsed tuple) for the ACTIVE tail
        self._read_cache: "OrderedDict[str, tuple]" = OrderedDict()
        # doc_id -> ((active ident, sealed names), final deduped tuple):
        # a repeat cold read of an unchanged archive returns THE SAME
        # tuple object — no O(history) merge, no defensive copy
        self._merged_cache: "OrderedDict[str, tuple]" = OrderedDict()
        # (doc_id, segment name) -> parsed tuple for SEALED segments —
        # never invalidated (immutable files), only LRU-evicted
        self._seg_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        # doc_id -> list of manifest entries (loaded lazily, adopted on
        # crash recovery); doc_id -> running record count of the active
        # segment (None = unknown until the next parse)
        self._manifests: dict[str, list[dict]] = {}
        self._active_records: dict[str, int | None] = {}

    # -- paths ---------------------------------------------------------------

    def _stem(self, doc_id: str) -> str:
        return hashlib.sha1(doc_id.encode()).hexdigest()[:20]

    def _path(self, doc_id: str) -> str:
        """The ACTIVE segment's path (the only appendable file)."""
        return os.path.join(self.root, f"{self._stem(doc_id)}.jsonl")

    def _seal_path(self, doc_id: str, n: int) -> str:
        return os.path.join(self.root, f"{self._stem(doc_id)}.s{n:04d}.jsonl")

    def _manifest_path(self, doc_id: str) -> str:
        return os.path.join(self.root, f"{self._stem(doc_id)}.manifest.json")

    @staticmethod
    def _seg_no(name: str) -> int:
        m = _SEAL_RE.search(name)
        return int(m.group(1)) if m else 0

    # -- durability primitives ----------------------------------------------

    def _fsync_dir(self) -> None:
        """Make a new file's directory entry durable (os.fsync on the
        file alone does not cover its name on most filesystems)."""
        try:
            fd = os.open(self.root, os.O_RDONLY)
        except OSError:
            return   # platform without directory fds: best effort
        try:
            os.fsync(fd)
        except OSError:
            pass
        finally:
            os.close(fd)

    def _fsync_file(self, f) -> None:
        timed_fsync(f, self.chaos_node)

    @staticmethod
    def _repair_tail(path: str) -> None:
        """Truncate a torn final line (crash/ENOSPC mid-append) of the
        ACTIVE segment so a new append cannot glue onto the fragment.
        Safe: the failed append's caller never truncated the RAM log, so
        the fragment's record still lives there. Sealed segments are
        never repaired — they were repaired before sealing and are
        immutable after; any damage there is a loud error instead."""
        try:
            size = os.path.getsize(path)
        except OSError:
            return                      # nothing on disk yet
        if size == 0:
            return
        with open(path, "r+b") as f:
            f.seek(size - 1)
            if f.read(1) == b"\n":
                return                  # clean tail, nothing to repair
            pos = size
            while pos > 0:
                step = min(4096, pos)
                f.seek(pos - step)
                nl = f.read(step).rfind(b"\n")
                if nl >= 0:
                    f.truncate(pos - step + nl + 1)
                    metrics.bump("sync_archive_tail_repaired")
                    return
                pos -= step
            f.truncate(0)               # single torn line, no newline at all
            metrics.bump("sync_archive_tail_repaired")

    # -- manifest ------------------------------------------------------------

    def _load_manifest_locked(self, doc_id: str) -> list[dict]:
        """The doc's manifest entries, loading from disk on first touch
        and ADOPTING any orphan sealed segments (a crash between the
        seal rename and the manifest commit leaves the sealed file on
        disk with no entry — re-parse it once and commit the entry)."""
        m = self._manifests.get(doc_id)
        if m is None:
            try:
                with open(self._manifest_path(doc_id)) as f:
                    data = json.load(f)
                m = list(data.get("segments") or [])
            except (OSError, ValueError):
                m = []
            known = {e["name"] for e in m}
            stem = self._stem(doc_id)
            orphans = []
            try:
                names = os.listdir(self.root)
            except OSError:
                names = []
            for name in names:
                if name.startswith(stem + ".s") and _SEAL_RE.search(name) \
                        and name not in known:
                    orphans.append(name)
            for name in sorted(orphans, key=self._seg_no):
                path = os.path.join(self.root, name)
                recs, clock, nbytes = self._scan_segment(path, doc_id)
                m.append({"name": name, "records": recs,
                          "bytes": nbytes, "clock": clock})
                metrics.bump("sync_segments_adopted")
            # numeric order, not lexicographic: past segment 9999 the
            # zero-padded names stop sorting correctly as strings, and
            # archive order IS admission order (the replay invariant)
            m.sort(key=lambda e: self._seg_no(e["name"]))
            if orphans:
                self._write_manifest_locked(doc_id, m)
            self._manifests[doc_id] = m
        return m

    def _write_manifest_locked(self, doc_id: str, entries: list[dict]) -> None:
        """Commit the manifest write-temp-then-rename with a dir fsync:
        a crash leaves either the old or the new manifest, never a torn
        one (orphan recovery covers the rename-but-no-entry window of
        the segments themselves)."""
        path = self._manifest_path(doc_id)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"doc": doc_id, "segments": entries}, f)
            f.flush()
            self._fsync_file(f)
        os.replace(tmp, path)
        self._fsync_dir()
        self._manifests[doc_id] = entries

    def _scan_segment(self, path: str, doc_id: str):
        """(records, clock, bytes) of one on-disk segment — the seal-time
        accounting pass (and the orphan-adoption re-parse)."""
        recs = 0
        clock: dict[str, int] = {}
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return 0, {}, 0
        for raw in data.split(b"\n"):
            if not raw.strip():
                continue
            rec = json.loads(raw.decode("utf-8"))
            if rec.get("_doc", doc_id) != doc_id:
                continue
            recs += 1
            a, s = rec["actor"], int(rec["seq"])
            if s > clock.get(a, 0):
                clock[a] = s
        return recs, clock, len(data)

    # -- sealing -------------------------------------------------------------

    def _maybe_seal_locked(self, doc_id: str) -> None:
        """Roll the active segment when it crossed a rotation bound.
        Seal = repair tail, account (records + clock range), rename to
        the next sealed name, dir-fsync, commit the manifest entry."""
        path = self._path(doc_id)
        try:
            size = os.path.getsize(path)
        except OSError:
            return
        if size == 0:
            return
        recs = self._active_records.get(doc_id)
        if size < SEGMENT_BYTES and (recs is None or recs < SEGMENT_RECORDS):
            return
        self._repair_tail(path)
        recs, clock, nbytes = self._scan_segment(path, doc_id)
        if not recs:
            return
        entries = self._load_manifest_locked(doc_id)
        n = 1 + max((self._seg_no(e["name"]) for e in entries), default=0)
        sealed = self._seal_path(doc_id, n)
        os.replace(path, sealed)
        self._fsync_dir()
        entries = entries + [{"name": os.path.basename(sealed),
                              "records": recs, "bytes": nbytes,
                              "clock": clock}]
        self._write_manifest_locked(doc_id, entries)
        self._active_records[doc_id] = 0
        self._read_cache.pop(doc_id, None)   # active tail is now empty
        metrics.bump("sync_segments_sealed")

    # -- append --------------------------------------------------------------

    def append(self, doc_id: str, changes) -> int:
        """Append materialized changes for one doc; returns count written.

        The whole batch goes down as ONE buffered write + fsync after a
        torn-tail repair check on the ACTIVE segment: a crash mid-append
        can tear at most the final line, and the next append truncates
        the fragment before writing, so records never interleave or glue.
        Rotation runs BEFORE the write, so a batch always lands whole in
        one segment and sealed segments end on record boundaries.

        On the FIRST creation of a doc's archive file the containing
        directory is fsynced too, before this returns: the caller
        truncates the RAM log right after, and a crash that loses the
        brand-new DIRECTORY ENTRY would lose the only copy of the
        archived prefix."""
        if not changes:
            return 0
        lines = []
        for c in changes:
            rec = c.to_dict() if isinstance(c, Change) else dict(c)
            rec["_doc"] = doc_id
            lines.append(json.dumps(rec, separators=(",", ":")))
        with self._lock:
            self._maybe_seal_locked(doc_id)
            path = self._path(doc_id)
            created = not os.path.exists(path)
            self._repair_tail(path)     # no-op on a missing or clean file
            with open(path, "a") as f:
                f.write("\n".join(lines) + "\n")
                f.flush()
                self._fsync_file(f)
            if created:
                self._fsync_dir()
            recs = self._active_records.get(doc_id)
            if created:
                recs = 0 if recs is None else recs
            self._active_records[doc_id] = (None if recs is None
                                            else recs + len(lines))
        metrics.bump("sync_changes_archived", len(changes))
        return len(changes)

    # -- reads ---------------------------------------------------------------

    def _parse_lines(self, data: bytes, doc_id: str, path: str,
                     tolerate_tail: bool):
        """Parse one segment's bytes into Change objects (file order).
        A torn FINAL line is skipped only where tolerated (the active
        segment — a crash or a snapshot racing an append); corruption
        anywhere else raises, because silently dropping records from the
        only copy of the prefix would be divergence."""
        out = []
        lines = data.split(b"\n")
        for j, raw in enumerate(lines):
            if not raw.strip():
                continue
            try:
                rec = json.loads(raw.decode("utf-8"))
            except (json.JSONDecodeError, UnicodeDecodeError):
                if not tolerate_tail or any(l.strip()
                                            for l in lines[j + 1:]):
                    raise
                metrics.bump("sync_archive_tail_skipped")
                break
            if rec.pop("_doc", doc_id) != doc_id:
                continue  # sha1-prefix collision guard
            out.append(coerce_change(rec))
        return out

    def _read_sealed(self, doc_id: str, entry: dict):
        """One sealed segment's changes: immutable-cache hit or a single
        parse, with the manifest-vs-disk disagreement check."""
        key = (doc_id, entry["name"])
        with self._lock:
            hit = self._seg_cache.get(key)
            if hit is not None:
                self._seg_cache.move_to_end(key)
                metrics.bump("sync_segment_reads_cached")
                return hit
        path = os.path.join(self.root, entry["name"])
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError as e:
            raise SegmentMismatchError(
                f"sealed segment {entry['name']} missing for doc "
                f"{doc_id!r} (manifest records {entry['records']} "
                f"changes): {e}") from e
        if len(data) != int(entry["bytes"]):
            raise SegmentMismatchError(
                f"sealed segment {entry['name']} is {len(data)} bytes on "
                f"disk but the manifest sealed it at {entry['bytes']} — "
                f"immutable-segment contract violated")
        changes = self._parse_lines(data, doc_id, path, tolerate_tail=False)
        if len(changes) != int(entry["records"]):
            raise SegmentMismatchError(
                f"sealed segment {entry['name']} parsed to {len(changes)} "
                f"records vs {entry['records']} in the manifest")
        tup = tuple(changes)
        with self._lock:
            self._seg_cache[key] = tup
            self._seg_cache.move_to_end(key)
            while len(self._seg_cache) > max(0, CACHE_SEGS):
                self._seg_cache.popitem(last=False)
        return tup

    def _snapshot_state_locked(self, doc_id: str):
        """(manifest entries, active path, active identity) under the
        lock — the consistent view one read attempt works against."""
        entries = list(self._load_manifest_locked(doc_id))
        path = self._path(doc_id)
        try:
            st = os.stat(path)
            ident = (st.st_size, st.st_mtime_ns)
        except OSError:
            ident = None
        return entries, path, ident

    def _active_parts(self, doc_id: str, path: str, ident):
        """Parse (or cache-serve) the active tail for one read attempt;
        None signals the attempt lost a race with a concurrent seal
        (the active file was renamed under us) and must retry."""
        with self._lock:
            if ident is None:
                return ()
            hit = self._read_cache.get(doc_id)
            if hit is not None and hit[0] == ident:
                self._read_cache.move_to_end(doc_id)
                return hit[1]
        try:
            with open(path, "rb") as f:
                data = f.read(ident[0])      # exactly the snapshotted prefix
        except OSError:
            return None                      # sealed under us: retry
        active = tuple(self._parse_lines(data, doc_id, path,
                                         tolerate_tail=True))
        with self._lock:
            self._read_cache[doc_id] = (ident, active)
            self._read_cache.move_to_end(doc_id)
            while len(self._read_cache) > max(0, CACHE_DOCS):
                self._read_cache.popitem(last=False)
            if self._active_records.get(doc_id) is None:
                # restart rehydration: the parse just counted the active
                # records, so the rotation record-bound re-arms
                self._active_records[doc_id] = len(active)
        return active

    def _manifest_moved(self, doc_id: str, sig: tuple) -> bool:
        """True when a concurrent seal changed the segment list since
        `sig` was snapshotted — the parsed active tail then belongs to
        a DIFFERENT archive state than the sealed parts and the read
        attempt must restart (appends alone never move the manifest,
        so steady-state reads never retry)."""
        with self._lock:
            cur = tuple(e["name"]
                        for e in self._load_manifest_locked(doc_id))
        return cur != sig

    def read(self, doc_id: str) -> tuple[Change, ...]:
        """All archived changes for a doc, deduplicated by (actor, seq),
        sealed segments first then the active tail (archive order is
        admission order, so archive-then-RAM-tail replay stays causally
        valid). Returns an IMMUTABLE tuple served from the caches —
        callers that mutate copy (tests pin the no-copy contract).

        Concurrency/cost: the lock is held only to snapshot identities
        and consult the caches; every O(segment) parse runs OUTSIDE it.
        Sealed-segment cache entries never invalidate; the active tail
        re-parses only when its (size, mtime) identity moved. A read
        racing a concurrent SEAL (active renamed mid-attempt, or the
        manifest growing under the parse) retries against the post-seal
        state instead of serving a merge that misses the sealed bytes.

        The ``sync_archive_cold_reads`` metric is bumped by the
        missing_changes call site, not here — internal replays
        (rebuild-from-log, snapshot writes) also read and must not
        pollute the operator signal."""
        for _ in range(16):
            with self._lock:
                entries, path, ident = self._snapshot_state_locked(doc_id)
                sig = tuple(e["name"] for e in entries)
                merged_key = (ident, sig)
                mhit = self._merged_cache.get(doc_id)
                if mhit is not None and mhit[0] == merged_key:
                    self._merged_cache.move_to_end(doc_id)
                    metrics.bump("sync_archive_reads_cached")
                    return mhit[1]
            parts = [self._read_sealed(doc_id, e) for e in entries]
            active = self._active_parts(doc_id, path, ident)
            if active is None or self._manifest_moved(doc_id, sig):
                continue
            out: dict[tuple, Change] = {}
            for part in parts:
                for c in part:
                    out[(c.actor, c.seq)] = c
            for c in active:
                out[(c.actor, c.seq)] = c
            merged = tuple(out.values())
            with self._lock:
                self._merged_cache[doc_id] = (merged_key, merged)
                self._merged_cache.move_to_end(doc_id)
                while len(self._merged_cache) > max(0, CACHE_DOCS):
                    self._merged_cache.popitem(last=False)
            return merged
        raise RuntimeError(
            f"archive read of {doc_id!r} lost 16 straight races with "
            "concurrent seals — rotation is pathologically hot")

    def read_since(self, doc_id: str,
                   clock: dict[str, int]) -> tuple[Change, ...]:
        """Archived changes strictly ABOVE `clock`, skipping every
        sealed segment whose manifest clock range is entirely covered
        (per-actor max <= clock, all actors known) — the segmented tail
        read: a snapshot-booted replica or a lagging-but-not-fresh peer
        pays O(uncovered segments), not O(history). Dedup, ordering,
        and the seal-race retry match read(); an empty clock degrades
        to the full read."""
        if not clock:
            return self.read(doc_id)
        for _ in range(16):
            with self._lock:
                entries, path, ident = self._snapshot_state_locked(doc_id)
                sig = tuple(e["name"] for e in entries)
            needed = []
            for e in entries:
                seg_clock = e.get("clock") or {}
                if seg_clock and all(int(m) <= clock.get(a, 0)
                                     for a, m in seg_clock.items()):
                    metrics.bump("sync_segments_skipped")
                    continue
                needed.append(e)
            parts = [self._read_sealed(doc_id, e) for e in needed]
            active = self._active_parts(doc_id, path, ident)
            if active is None or self._manifest_moved(doc_id, sig):
                continue
            out: dict[tuple, Change] = {}
            for part in parts:
                for c in part:
                    if c.seq > clock.get(c.actor, 0):
                        out[(c.actor, c.seq)] = c
            for c in active:
                if c.seq > clock.get(c.actor, 0):
                    out[(c.actor, c.seq)] = c
            return tuple(out.values())
        raise RuntimeError(
            f"archive tail read of {doc_id!r} lost 16 straight races "
            "with concurrent seals — rotation is pathologically hot")

    # -- accounting ----------------------------------------------------------

    def stats(self, doc_id: str) -> dict:
        """On-disk accounting for one doc: total archived bytes/records
        and the segment count — the denominator of the snapshot-size-
        vs-log gate and the `perf bootstrap` report."""
        with self._lock:
            entries = list(self._load_manifest_locked(doc_id))
            path = self._path(doc_id)
            try:
                active_bytes = os.path.getsize(path)
            except OSError:
                active_bytes = 0
        sealed_bytes = sum(int(e["bytes"]) for e in entries)
        sealed_records = sum(int(e["records"]) for e in entries)
        return {"segments": len(entries) + (1 if active_bytes else 0),
                "sealed_segments": len(entries),
                "bytes": sealed_bytes + active_bytes,
                "sealed_records": sealed_records}
