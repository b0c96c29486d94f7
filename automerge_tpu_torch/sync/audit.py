"""Convergence auditor: continuous cross-replica state-hash checking (the
port of `automerge_tpu/sync/audit.py`; its thread is `amtpu-torch-auditor`).

The paper's core guarantee — replicas that applied the same changes
converge to byte-identical state — is exactly the property the sync stack
never verified at runtime: a bug that made two replicas "converge never"
would sit silent until a user diffed materialized documents by hand. The
arbitrary-scale OCC line of work argues consistency checking must be
continuous rather than post-hoc; this module is that plane for the engine
services, built on state the fleet already maintains (the per-doc
convergence hashes every dispatch computes — engine/resident.py,
engine/resident_rows.py).

Protocol — rides the ordinary Connection message channel, like
`{"metrics": "pull"}` (plain JSON, crosses the TCP transport and any
reference-framing relay unchanged; peers that predate it never see it
unsolicited):

1. `{"audit": "pull"}` → the peer answers
   `{"audit": "state", "state": {shard: {"digest": crc, "docs": n}}}` —
   one digest per shard over its sorted (doc, hash) pairs.
2. The requester's ConvergenceAuditor compares against its own digests.
   Every matching shard is convergence VERIFIED for this round at the
   cost of one small message.
3. A mismatched shard is bisected to the document level:
   `{"audit": "shard_pull", "shard": k}` →
   `{"audit": "shard", "shard": k, "hashes": {doc: h}, "clocks":
   {doc: clock}}`; the requester walks the shared docs in sorted order and
   flags the FIRST doc whose clocks are equal (both replicas claim the
   same change set) but whose hashes differ — that is a genuine
   convergence violation, not sync lag.
4. The divergence report `{shard, doc_id, local_hash, peer_hash, clock,
   peer_clock}` is logged, counted (`sync_divergences_detected`), handed
   to `on_divergence`, and dumped with the flight recorder so the
   post-mortem is self-contained (docs/OBSERVABILITY.md walks through
   reading one).

Docs whose clocks differ are skipped: divergence-by-lag is the sync
protocol's normal operating state and heals by anti-entropy; hash
inequality under EQUAL clocks can never heal and is the only thing worth
alarming on.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import zlib
from typing import Callable

from ..utils import flightrec, metrics

log = logging.getLogger("automerge_tpu_torch.audit")

# Default seconds between audit rounds (ConvergenceAuditor.start); each
# round costs one digest message per direction plus, only on mismatch, one
# per-shard hash table. 0 disables the periodic thread (audit_once still
# works).
AUDIT_PERIOD_S = float(os.environ.get("AMTPU_AUDIT_PERIOD_S", "30"))


def _reload_for_tests() -> None:
    """Re-read AMTPU_AUDIT_PERIOD_S (cached at import)."""
    global AUDIT_PERIOD_S
    AUDIT_PERIOD_S = float(os.environ.get("AMTPU_AUDIT_PERIOD_S", "30"))


def state_digest(hashes: dict[str, int]) -> int:
    """One crc32 over the sorted (doc, hash) pairs: equal digests ⇒ equal
    per-doc hash tables (modulo crc collisions, which the doc-level bisect
    would surface on the next round anyway)."""
    return zlib.crc32(json.dumps(
        sorted((d, int(h)) for d, h in hashes.items())).encode())


def _peer_interest_filter(conn):
    """The requesting peer's explicit interest set, or None for full
    interest — audit digests are filtered to the intersection of the
    peer's subscriptions and local holdings, so a partial replica's
    digest compares equal to the serving side's digest over the SAME doc
    subset (a full-holdings digest would mismatch forever and bisect
    every round)."""
    interest = getattr(conn, "_peer_interest", None)
    if interest is not None and getattr(interest, "narrowed", False):
        return interest
    return None


def _filtered_audit_state(ds, interest) -> dict:
    """Per-shard digests over only the docs the peer subscribed — the
    partial-replication twin of audit_state(), read through the partial
    hashes_for plane (never reconciles unsubscribed docs)."""
    docs = sorted(d for d in ds.doc_ids if interest.covers(d))
    h = (ds.hashes_for(docs) if hasattr(ds, "hashes_for")
         else {d: v for d, v in ds.hashes().items() if d in set(docs)})
    groups: dict[str, dict] = {}
    for d, v in h.items():
        if hasattr(ds, "shard_of"):
            lbl = ds.shard_of(d)._audit_label
        else:
            lbl = getattr(ds, "_audit_label", "0")
        groups.setdefault(lbl, {})[d] = v
    return {lbl: {"digest": state_digest(hh), "docs": len(hh)}
            for lbl, hh in groups.items()}


def handle_audit_msg(conn, msg: dict) -> None:
    """Serve/route one `{"audit": ...}` protocol message for a Connection.
    Serving needs only the doc_set's audit surface (audit_state /
    audit_shard_state — EngineDocSet and ShardedEngineDocSet); responses
    are routed to the attached ConvergenceAuditor, if any. A peer with
    an explicit interest set (partial replication) is served digests
    over the subscribed-doc intersection only."""
    kind = msg.get("audit")
    ds = conn._doc_set
    if kind == "pull":
        metrics.bump("sync_audit_pulls")
        interest = _peer_interest_filter(conn)
        if not hasattr(ds, "audit_state"):
            # interpretive DocSet: no engine hashes to audit
            conn._send_traced({"audit": "unsupported"})
        elif interest is not None:
            conn._send_traced({"audit": "state",
                               "state": _filtered_audit_state(ds, interest)})
        else:
            conn._send_traced({"audit": "state", "state": ds.audit_state()})
    elif kind == "shard_pull":
        if hasattr(ds, "audit_shard_state"):
            st = ds.audit_shard_state(str(msg.get("shard")))
            interest = _peer_interest_filter(conn)
            if interest is not None:
                st = {"hashes": {d: h for d, h in st["hashes"].items()
                                 if interest.covers(d)},
                      "clocks": {d: c for d, c in st["clocks"].items()
                                 if interest.covers(d)}}
            conn._send_traced({"audit": "shard",
                               "shard": str(msg.get("shard")), **st})
    elif kind == "state":
        if conn.auditor is not None:
            conn.auditor.on_peer_state(conn, msg.get("state") or {})
    elif kind == "shard":
        if conn.auditor is not None:
            conn.auditor.on_peer_shard(conn, msg)
    elif kind == "unsupported":
        if conn.auditor is not None:
            conn.auditor.on_peer_unsupported(conn)


class ConvergenceAuditor:
    """Periodic background audit of one node against one peer connection.

    Attach to the Connection whose peer should be audited; `start()` spawns
    a daemon thread (name `amtpu-torch-auditor`) that fires `request_audit()`
    every `period_s` seconds. The comparison work runs on whatever thread
    delivers the peer's answers (the transport reader), keeping the audit
    thread itself trivially idle. `stop()` joins the thread — tests assert
    this hygiene.

    `divergences` accumulates every report; `on_divergence` (callable)
    fires per report. A report means REAL divergence: same clock, different
    state hash — the convergence guarantee is broken for that doc."""

    def __init__(self, doc_set, connection, period_s: float | None = None,
                 on_divergence: Callable[[dict], None] | None = None):
        self.doc_set = doc_set
        self.conn = connection
        connection.auditor = self
        self.period_s = AUDIT_PERIOD_S if period_s is None else period_s
        self.on_divergence = on_divergence
        self.divergences: list[dict] = []
        self.rounds_clean = 0
        self.last_audit_at: float | None = None
        # local digest snapshot taken on the audit thread per round, so
        # the peer-answer comparison on the reader thread is a dict
        # compare, not an engine fan-out under the transport lock
        self._local_state: dict | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ConvergenceAuditor":
        if self.period_s and self.period_s > 0 and self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="amtpu-torch-auditor", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        """Stop and JOIN the audit thread (idempotent)."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=10.0)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                self.audit_once()
            except Exception:
                log.exception("audit round failed")

    def _local_audit_state(self) -> dict:
        """Local digests, filtered to this side's OWN explicit interest
        when it has one: the serving peer filters its digests to our
        subscription (covers() — advert-only docs excluded, since their
        local state froze the moment frames stopped and would mismatch
        forever), so the local digest must cover the SAME doc subset or
        every round degrades to a full bisect."""
        interest = getattr(self.conn, "_local_interest", None)
        if interest is not None \
                and getattr(interest, "narrowed", False) \
                and hasattr(self.doc_set, "doc_ids"):
            return _filtered_audit_state(self.doc_set, interest)
        return self.doc_set.audit_state()

    def audit_once(self) -> None:
        """Fire one audit round (also usable without start()). The local
        digest snapshot is taken HERE — on the calling/audit thread —
        before the pull goes out; the answer may race a concurrent
        ingress, but a stale digest only costs a doc-level bisect whose
        clock guard filters the lag (never a false report)."""
        self.last_audit_at = time.time()
        self._local_state = self._local_audit_state()
        self.conn.request_audit()

    # -- peer answers (delivered on the transport reader thread) -------------
    #
    # Thread-cost note: the local digest snapshot is taken on the AUDIT
    # thread in audit_once() (before the pull is sent), so the reader
    # thread's comparison work is a dict compare — it does not re-run the
    # engine hash fan-out while holding the transport lock. The doc-level
    # bisect (mismatch only) does read engine state on the reader thread;
    # hashes are cached between deltas, so this is cheap unless the node
    # is mid-ingress — keep period_s long relative to fan-out time on
    # heavily loaded fleets. SERVING a peer's pull necessarily computes
    # on the reader thread (handle_audit_msg); same caveat applies.

    def on_peer_state(self, conn, peer_state: dict) -> None:
        local = self._local_state or self._local_audit_state()
        # a shard label the local node cannot confirm — digest mismatch,
        # or a label only one side has (heterogeneous n_shards) — gets
        # bisected to doc level; the doc compare below is partition-
        # agnostic, so differing shard counts cannot hide a divergence
        mismatched = sorted(
            s for s, st in peer_state.items()
            if s not in local
            or int(local[s]["digest"]) != int((st or {}).get("digest", -1)))
        metrics.bump("sync_audits_completed")
        flightrec.record("audit_state", shards=len(peer_state),
                         mismatched=len(mismatched))
        if not mismatched:
            with self._lock:
                self.rounds_clean += 1
            return
        for s in mismatched:   # bisect each mismatched shard to doc level
            conn._send_traced({"audit": "shard_pull", "shard": s})

    def _local_shard_label(self, doc_id: str) -> str:
        """The LOCAL shard owning a doc (reports must name the shard the
        operator can act on here, whatever partition the peer uses)."""
        ds = self.doc_set
        if hasattr(ds, "shard_of"):
            return ds.shard_of(doc_id)._audit_label
        return getattr(ds, "_audit_label", "0")

    def on_peer_shard(self, conn, msg: dict) -> None:
        peer_hashes = msg.get("hashes") or {}
        peer_clocks = msg.get("clocks") or {}
        # compare against the local doc table, not the same-label local
        # shard: with differing shard counts the peer's shard k holds a
        # different doc subset than ours, and a label-for-label compare
        # would silently skip exactly the diverged doc. The read is
        # PARTIAL (hashes_for): only the docs the peer actually reported
        # — reconciling untouched docs on the transport reader thread is
        # exactly the O(fleet) cost the incremental plane removed
        if hasattr(self.doc_set, "hashes_for"):
            local_h = self.doc_set.hashes_for(sorted(peer_hashes))
        else:
            local_h = self.doc_set.hashes()   # interpretive doc sets
        for d in sorted(set(local_h) & set(peer_hashes)):
            lc, pc = self.doc_set.clock_of(d), peer_clocks.get(d)
            if lc != pc:
                continue   # sync lag, not divergence — anti-entropy heals it
            if int(local_h[d]) != int(peer_hashes[d]):
                self._report({
                    "shard": self._local_shard_label(d),
                    "doc_id": d,
                    "local_hash": int(local_h[d]),
                    "peer_hash": int(peer_hashes[d]),
                    "clock": lc,
                    "peer_clock": pc,
                    "at": time.time(),
                })
                return   # the FIRST diverging doc is the bisect's answer

    def on_peer_unsupported(self, conn) -> None:
        log.warning("audit peer has no engine hashes to audit "
                    "(interpretive DocSet?) — auditing disabled for it")

    def _report(self, report: dict) -> None:
        with self._lock:
            self.divergences.append(report)
        metrics.bump("sync_divergences_detected")
        log.error("convergence DIVERGENCE detected: %s",
                  json.dumps(report, sort_keys=True, default=str))
        flightrec.record("divergence", shard=report["shard"],
                         doc=report["doc_id"])
        # force: every divergence is its own critical post-mortem — two
        # distinct divergences inside one dump-cooldown window must BOTH
        # be persisted, never deduped as a repeat trigger
        flightrec.dump("divergence", extra={"divergence": report},
                       force=True)
        if self.on_divergence is not None:
            try:
                self.on_divergence(report)
            except Exception:
                log.exception("on_divergence callback failed")
