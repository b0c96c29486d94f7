"""Connection: per-peer anti-entropy sync over an injected transport.

Mirrors Automerge's src/connection.js. The protocol is transport-agnostic:
`send_msg` (constructor callback) carries messages out; `receive_msg` is called
by the network stack on arrival. Messages are plain dicts
`{"docId": ..., "clock": {...}, "changes": [...]?}` — the exact schema the
reference speaks, so an automerge_tpu node can sync with any peer using the
reference protocol over DCN/websocket/whatever.

State per peer:
- `their_clock`: best estimate of what the peer has (per doc). Everything more
  recent must be sent.
- `our_clock`: what we have advertised to the peer.

Protocol invariants (tested in tests/test_connection.py): duplicate deliveries
are tolerated (idempotent apply + clock checks); drops only delay convergence
(clock re-advertisement catches up).

TPU-scale counterpart: within a pod, the clock union below becomes an
element-wise max all-reduce over int32 clock matrices
(automerge_tpu/parallel/collective.py).
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Callable

from ..core import clock as C
from ..core.change import coerce_change
from ..utils import chaos, flightrec, metrics, oplag, tracer
from . import docledger
from .frames import (OPLAG_KEY, SNAP_KEY, SUB_KEY, TRACE_KEY,
                     TRACEPLANE_KEY, msg_kind, pack_trace, unpack_trace)


class InterestSet:
    """Doc-granular interest: which docs one side of a connection wants
    synced (the `{"sub": ...}` protocol message's state).

    Three states per doc id:

    - **covered** (mode "all", an explicit doc id, or a prefix match):
      change frames AND clock adverts flow;
    - **advert-only** (explicitly removed after having been covered):
      clock adverts keep flowing — the peer still sees the frontier it
      chose to ignore, so a later resubscribe is an informed decision
      and `perf explain` can name the lag `doc_unsubscribed` instead of
      flagging a stall — but change frames stop;
    - **unknown** (explicit mode, never added): nothing is sent at all.

    The default is full interest (mode "all"): a peer that never speaks
    the sub protocol syncs the whole DocSet exactly as before — the
    subscription layer is strictly opt-in. Two working styles follow
    from the first delta a peer sends:

    - **narrowing** (the first delta carries adds/prefixes on a
      pristine "all" set): the set flips to explicit-with-only-these;
    - **exclusion** (the first delta is remove-only): the set STAYS
      "all" and the removed docs become advert-only — full sync minus
      opt-outs, so a pure unsubscribe can never silently darken the
      whole connection."""

    __slots__ = ("mode", "docs", "prefixes", "advert_only")

    def __init__(self):
        self.mode = "all"
        self.docs: set[str] = set()
        self.prefixes: tuple[str, ...] = ()
        self.advert_only: set[str] = set()

    @property
    def explicit(self) -> bool:
        return self.mode == "explicit"

    @property
    def narrowed(self) -> bool:
        """True when this set filters ANYTHING (explicit mode, or an
        exclusion-style "all" with opted-out docs) — the condition under
        which audit digests must be computed over the covered subset."""
        return self.mode == "explicit" or bool(self.advert_only)

    def covers(self, doc_id: str) -> bool:
        """True when change frames for this doc should flow."""
        if self.mode == "all":
            return doc_id not in self.advert_only
        return doc_id in self.docs \
            or any(doc_id.startswith(p) for p in self.prefixes)

    def wants_adverts(self, doc_id: str) -> bool:
        """True when at least clock adverts should flow (covered docs
        plus explicitly-unsubscribed ones)."""
        return self.covers(doc_id) or doc_id in self.advert_only

    def apply(self, add=(), prefixes=(), remove=(),
              remove_prefixes=(), mode: str | None = None
              ) -> tuple[list[str], list[str]]:
        """Apply one sub delta. Returns (newly covered doc ids, newly
        added prefixes) — the serving side's targeted-backfill set.
        mode="all" resets to full interest FIRST (removes in the same
        delta then re-apply as exclusions — the resubscribe wire form
        of an exclusion-style set). Adds/prefixes on a PRISTINE "all"
        set (no exclusions yet) switch it to explicit-with-only-these;
        on an exclusion-style "all" set they just lift exclusions."""
        if mode == "all":
            self.mode = "all"
            self.docs.clear()
            self.prefixes = ()
            self.advert_only.clear()
        elif mode == "explicit":
            # reset-form replay of an explicit set: stay explicit even
            # when the replayed set is empty (an emptied subscription
            # must not resurrect as full interest)
            self.mode = "explicit"
        if self.mode == "all" and (add or prefixes) \
                and not self.advert_only:
            self.mode = "explicit"
        new_docs: list[str] = []
        for d in add or ():
            if self.mode == "all":
                # exclusion style: a re-add lifts the opt-out — it was
                # dark for frames, so it IS newly covered (backfill)
                if d in self.advert_only:
                    self.advert_only.discard(d)
                    new_docs.append(d)
                continue
            self.advert_only.discard(d)
            if d not in self.docs:
                if not self.covers(d):
                    new_docs.append(d)
                self.docs.add(d)
        new_prefixes: list[str] = []
        for p in prefixes or ():
            if self.mode == "all":
                continue   # everything is covered already
            if p not in self.prefixes:
                new_prefixes.append(p)
                self.prefixes = self.prefixes + (p,)
        for d in remove or ():
            if self.mode == "all":
                # exclusion style (also the remove-only first delta):
                # stay "all", degrade just this doc to advert-only
                self.advert_only.add(d)
            elif d in self.docs:
                self.docs.discard(d)
                self.advert_only.add(d)
            # a doc covered only by a prefix stays covered until the
            # prefix itself is removed — doc-id removes never override
            # a broader prefix subscription (the cover-set merge rule)
        for p in remove_prefixes or ():
            if p in self.prefixes:
                self.prefixes = tuple(x for x in self.prefixes if x != p)
        return new_docs, new_prefixes

    def to_wire(self) -> dict:
        """The FULL current interest as one sub delta (reset form) —
        what `resubscribe()` sends after a re-home."""
        if self.mode == "all":
            out = {"mode": "all"}
            if self.advert_only:
                out["remove"] = sorted(self.advert_only)
            return out
        out = {"reset": True, "mode": "explicit",
               "add": sorted(self.docs)}
        if self.prefixes:
            out["prefixes"] = list(self.prefixes)
        if self.advert_only:
            out["remove"] = sorted(self.advert_only)
        return out


class Connection:
    def __init__(self, doc_set, send_msg: Callable[[dict], None],
                 wire: str = "json", local_interest=None):
        """wire="json" sends changes as reference-protocol per-op dicts;
        wire="columnar" sends them as one binary columnar frame per message
        (msg["frame"], see sync/frames.py). automerge_tpu receivers
        auto-detect the form, so two automerge_tpu nodes interoperate
        whatever each side emits. A genuine reference-JS peer only parses
        JSON: talk to it with wire="json" (its messages are always accepted
        here; the mode only selects what THIS side emits)."""
        if wire not in ("json", "columnar"):
            raise ValueError(f"unknown wire mode {wire!r}")
        self._doc_set = doc_set
        self._send_msg = send_msg
        self._wire = wire
        self._their_clock: dict[str, dict[str, int]] = {}
        self._our_clock: dict[str, dict[str, int]] = {}
        # last metrics snapshot the peer answered with (request_metrics),
        # its arrival wall time, and the peer's self-reported node label
        # (metrics.node_name() on the serving side) — the fleet collector
        # (perf/fleet.py) names scraped peers from peer_node instead of
        # guessing from connection order
        self.peer_metrics: dict | None = None
        self.peer_metrics_at: float | None = None
        self.peer_node: str | None = None
        # operator-set peer name for the per-doc ledger's lanes (takes
        # precedence over peer_node; unset peers get positional labels).
        # Cross-node `perf explain` joins lanes by these labels, so a
        # mesh that names its connections after the remote node gets
        # exact sender-side attribution.
        self.peer_label: str | None = None
        self.on_peer_metrics: Callable[[dict], None] | None = None
        # last span ring the peer shipped (request_metrics(spans=True)) —
        # merge with the local one via metrics.merge_timeline
        self.peer_spans: list | None = None
        # a ConvergenceAuditor (sync/audit.py) attaches itself here to
        # receive the peer's audit digests/hashes as they arrive
        self.auditor = None
        # engine-backed DocSets track each peer's advertised clock as the
        # compaction floor (engine/compaction.py); this object is the
        # registry key, released again in close()
        self._floor_sink = (doc_set
                            if hasattr(doc_set, "note_peer_clock") else None)
        # Concurrency seams (no-ops here; LockedConnection installs real
        # locks): _state_lock guards this connection's clock maps and
        # send decisions; _apply_lock guards the doc_set apply for
        # doc_sets that are NOT safe for concurrent ingestion. Keeping
        # them separate lets a transport serialize Connection state in
        # tiny sections while N peers' applies run concurrently into an
        # epoch-buffered service (sync/service.py) — the receive chain
        # no longer parks every peer behind one node-wide lock for the
        # whole receive->apply->gossip span.
        self._state_lock = contextlib.nullcontext()
        self._apply_lock = contextlib.nullcontext()
        # per-doc convergence ledger (sync/docledger.py): shared with the
        # doc_set's other connections, so one node's lanes live in one
        # table. None when AMTPU_DOCLEDGER=0 — every hook below no-ops.
        self._ledger = docledger.of(doc_set)
        # Interest sets (the subscription layer): _peer_interest is what
        # the PEER subscribed to — every outgoing advert/frame/gossip/
        # audit digest is filtered against it; _local_interest is what
        # THIS side subscribed to from the peer (subscribe() below).
        # Both default to full interest, so a connection that never
        # speaks the sub protocol syncs the whole DocSet unchanged.
        # `local_interest` seeds the local set (the re-home path: a new
        # connection carrying a dead hub's child interest, replayed to
        # the adopting peer via resubscribe()).
        self._peer_interest = InterestSet()
        self._local_interest = (local_interest if local_interest
                                is not None else InterestSet())
        # relay hook (sync/relay.py): fires after the peer's interest
        # changed — (conn, {"added", "added_prefixes", "removed",
        # "removed_prefixes"}) — so a hub can re-merge its cover set
        self.on_sub_change: Callable | None = None
        # snapshot bootstrap (sync/snapshots.py): set sticky when the
        # peer's sub delta carried `"snap": 1` — an empty-clock add from
        # such a peer is answered with a compacted doc-state image plus
        # the suffix instead of full history (frames.SNAP_KEY).
        # _snap_sent holds docs whose image is in flight: until the
        # peer's first post-apply advert lands, an empty-clock request
        # for such a doc must NOT trigger the full-history push (the
        # open()-advert / subscribe race would otherwise ship the whole
        # history right behind the image it exists to replace)
        self._peer_wants_snap = False
        self._snap_sent: set[str] = set()

    # -- lifecycle (connection.js:49-56) ------------------------------------

    def open(self) -> None:
        # The handler goes in first, then the walk, so a doc that another
        # peer's reader admits meanwhile is advertised either by the walk
        # or by the handler. Walking first and registering after
        # (connection.js:49-52, and the reference) never advertises a doc
        # admitted in between: on a hub, the peer that connected then
        # never learns of it. Each doc is read and advertised in one
        # section of the state lock, so no advert is older than one the
        # handler already sent (a plain DocSet's states are immutable: a
        # read outside the section could predate it), and the lock, which
        # a transport shares among every connection on the doc set, is
        # free between documents for the other peers.
        #
        # Python's locks are not fair: a walk that takes the lock again
        # straight after each document keeps it, and a waiting reader
        # gets in only when the scheduler happens to run it in that gap
        # (tenths of a second apart at 10,000 docs). So once a switch
        # interval has passed, the walk sleeps for a moment outside the
        # lock, which hands it, and the GIL, to whoever waits.
        self._doc_set.register_handler(self.doc_changed)
        slice_s = sys.getswitchinterval()
        t_slice = time.perf_counter()
        for doc_id in self._doc_set.doc_ids:
            with self._state_lock:
                self.doc_changed(doc_id, self._doc_set.get_doc(doc_id))
            if time.perf_counter() - t_slice >= slice_s:
                time.sleep(0)
                t_slice = time.perf_counter()

    def close(self) -> None:
        auditor = self.auditor
        if auditor is not None:
            # a dead transport must take its audit loop down with it, or
            # the amtpu-auditor thread keeps firing pulls into the void
            # (and leaks) until someone separately remembers stop()
            self.auditor = None
            try:
                auditor.stop()
            except Exception:
                pass
        self._doc_set.unregister_handler(self.doc_changed)
        if self._floor_sink is not None:
            self._floor_sink.forget_peer(self)
        if self._ledger is not None:
            self._ledger.forget_conn(self)

    # -- sending (connection.js:58-79) --------------------------------------

    def _clock_union(self, clock_map: dict, doc_id: str, clock: dict) -> dict:
        merged = C.union(clock_map.get(doc_id, {}), clock)
        out = dict(clock_map)
        out[doc_id] = merged
        return out

    def _send_traced(self, msg: dict) -> None:
        """Every outgoing protocol message leaves through here: a
        `sync_msg_send` span brackets the transport write, and the span's
        trace context rides on the message (frames.TRACE_KEY) so the
        peer's serving spans stitch onto it. Sends that happen while this
        thread is already inside a span (a round flush, a serve-and-relay
        chain) INHERIT that trace — a change propagating A→B→C is one
        trace id across all three replicas."""
        metrics.bump("sync_conn_msgs_sent", kind=msg_kind(msg))
        with metrics.trace("sync_msg_send") as span:
            msg[TRACE_KEY] = pack_trace({"tid": span.trace_id,
                                         "sid": span.span_id})
            self._send_msg(msg)

    def send_msg(self, doc_id: str, clock: dict, changes=None) -> None:
        if changes is not None and chaos.stall_doc(
                getattr(self._doc_set, "_chaos_node", None), doc_id):
            # chaos per-doc stall (utils/chaos.py AMTPU_CHAOS_STALL_DOC):
            # the CHANGES are dropped but the message degrades to a
            # clock-only advert — chaos never blinds the instruments,
            # and the advert is precisely what lets the peer's ledger
            # SEE the frontier it cannot reach (the lag `perf explain`
            # then walks back to this sender's drop counter). Counted on
            # the same loss series the transport injector uses, and
            # per-doc in the ledger.
            metrics.bump("sync_frames_dropped")
            if self._ledger is not None:
                self._ledger.record_drop(doc_id, self)
            changes = None
        msg: dict = {"docId": doc_id, "clock": dict(clock)}
        self._our_clock = self._clock_union(self._our_clock, doc_id, clock)
        nbytes = None
        if changes is not None:
            t_ser = time.perf_counter()
            if self._wire == "columnar":
                from .frames import encode_frame
                msg["frame"] = encode_frame(changes)
                nbytes = len(msg["frame"])
                metrics.bump("sync_frames_sent")
                metrics.bump("sync_frame_bytes_sent", len(msg["frame"]))
            else:
                msg["changes"] = [c.to_dict() for c in changes]
            # op-lifecycle provenance (utils/oplag.py): a sampled op of
            # this doc awaiting shipping rides out on this message, so
            # the peer can record wire / apply / convergence lag
            hdr = oplag.wire_header(doc_id)
            if hdr is not None:
                msg[OPLAG_KEY] = hdr
            # trace-plane stitching (utils/tracer.py): this doc's post-
            # flush lifecycle traces leave with the frame — the sender's
            # accumulated spans + wall epoch — so the receiver completes
            # one cross-process trace. Never emitted when the plane is
            # off (the envelope stays byte-identical).
            if tracer.enabled():
                thdr = tracer.wire_header(
                    doc_id, time.perf_counter() - t_ser)
                if thdr is not None:
                    msg[TRACEPLANE_KEY] = thdr
        if self._ledger is not None:
            self._ledger.record_send(
                doc_id, self, len(changes) if changes is not None else 0,
                nbytes=nbytes)
        self._send_traced(msg)

    def maybe_send_changes(self, doc_id: str) -> None:
        interest = self._peer_interest
        frames_ok = interest.covers(doc_id)
        if not frames_ok and not interest.wants_adverts(doc_id):
            # the peer never subscribed this doc: nothing is sent at all
            # — no advert, no frame. This is THE wire saving of partial
            # replication (counted once per suppressed gossip event).
            metrics.bump("sync_sub_frames_suppressed")
            return
        doc = self._doc_set.get_doc(doc_id)
        opset = doc._doc.opset
        clock = opset.clock

        if not frames_ok:
            # advert-only (explicitly unsubscribed): the peer keeps
            # seeing the frontier it opted out of, but frames stop
            if doc_id not in self._our_clock or \
                    not C.equal(clock, self._our_clock[doc_id]):
                metrics.bump("sync_sub_frames_suppressed")
                self.send_msg(doc_id, clock)
            return

        if doc_id in self._their_clock:
            their = self._their_clock[doc_id]
            if not their and doc_id in self._snap_sent:
                # an image is in flight for this doc and the peer still
                # claims an empty clock (the subscribe/open race): hold
                # the full-history push; the post-apply advert (clock
                # >= the image's) pulls exactly the suffix — and if the
                # image was refused, that advert carries the peer's
                # real clock and ordinary anti-entropy resumes
                return
            changes = opset.get_missing_changes(their)
            if changes:
                self._their_clock = self._clock_union(self._their_clock, doc_id, clock)
                self.send_msg(doc_id, clock, changes)
                return

        # Advertise when our clock moved past what we advertised — and also on
        # first contact even with an empty clock. (The reference skips the
        # empty-clock advert, connection.js:78, which deadlocks when both peers
        # register an empty doc and one of them later edits it: neither side
        # ever learns the other's clock, so nothing is pushed.)
        if doc_id not in self._our_clock or \
                not C.equal(clock, self._our_clock[doc_id]):
            self.send_msg(doc_id, clock)

    # -- docset callback (connection.js:82-94) ------------------------------

    def doc_changed(self, doc_id: str, doc) -> None:
        doc_state = getattr(doc, "_doc", None)
        if doc_state is None:
            raise TypeError("This object cannot be used for network sync. "
                            "Are you trying to sync a snapshot from the history?")
        with self._state_lock:
            # the clock read must happen UNDER the state lock: every
            # entry into _our_clock is unioned from a clock read under
            # this lock, so reading here keeps the monotonicity check
            # sound — a pre-lock read could be overtaken by a concurrent
            # peer's gossip and trip the old-state guard spuriously.
            # (On an epoch-buffered service the read is a snapshot-cache
            # hit in the steady state: no service lock.)
            clock = doc_state.opset.clock
            if not C.less_or_equal(self._our_clock.get(doc_id, {}), clock):
                raise ValueError(
                    "Cannot pass an old state object to a connection")
            self.maybe_send_changes(doc_id)

    # -- subscriptions (SUB message type; sync partial replication) ---------

    @property
    def local_interest(self) -> InterestSet:
        """THIS side's declared interest (what subscribe() built). The
        reconnect supervisor (sync/tcp.SupervisedTcpClient) carries this
        object across transport generations: a replacement connection is
        seeded with it and `resubscribe()` replays it with clocks, so a
        re-established link backfills exactly what the dead window
        missed instead of resetting to full-DocSet sync."""
        return self._local_interest

    def subscribe(self, docs=(), prefixes=(), remove=(),
                  remove_prefixes=(), everything: bool = False) -> None:
        """Declare interest to the peer: only subscribed docs are framed
        back to us. `docs`/`prefixes` add; `remove`/`remove_prefixes`
        drop (removed docs degrade to advert-only — the peer keeps
        advertising their clocks so we still see the frontier we opted
        out of). `everything=True` resets to full-DocSet sync.

        For each explicitly-added doc we already hold, our current
        clock rides along (`"clocks"`), so the serving side backfills
        exactly the missing suffix through its `missing_changes`
        snapshot read plane — a late subscribe never costs a
        full-DocSet replay."""
        with self._state_lock:
            if everything:
                self._local_interest.apply(mode="all")
                msg = {"mode": "all"}
            else:
                self._local_interest.apply(
                    add=docs, prefixes=prefixes, remove=remove,
                    remove_prefixes=remove_prefixes)
                msg = {}
                if docs:
                    msg["add"] = list(docs)
                    msg["clocks"] = self._held_clocks(docs)
                if prefixes:
                    msg["prefixes"] = list(prefixes)
                if remove:
                    msg["remove"] = list(remove)
                if remove_prefixes:
                    msg["remove_prefixes"] = list(remove_prefixes)
            if hasattr(self._doc_set, "apply_snapshot"):
                # opt into snapshot-frame bootstrap: only doc_sets that
                # can APPLY an image may ask for one (a plain DocSet
                # receiving a renumbered image could never admit the
                # original-seq suffix on top)
                msg["snap"] = 1
            if self._ledger is not None:
                for d in docs or ():
                    self._ledger.record_sub(d, self, True)
                for d in remove or ():
                    self._ledger.record_sub(d, self, False)
        self._send_traced({SUB_KEY: msg})

    def resubscribe(self) -> None:
        """Re-send the FULL current local interest (reset form, clocks
        included) — the re-home path: a child whose relay hub died
        reattaches elsewhere and replays its interest, and the new hub
        backfills whatever the child missed in between."""
        metrics.bump("sync_sub_resubscribes")
        with self._state_lock:
            msg = self._local_interest.to_wire()
            if msg.get("add"):
                msg["clocks"] = self._held_clocks(msg["add"])
            if hasattr(self._doc_set, "apply_snapshot"):
                msg["snap"] = 1
        self._send_traced({SUB_KEY: msg})

    def _held_clocks(self, doc_ids) -> dict:
        """Current local clocks for the held docs among `doc_ids` (the
        subscribe-time backfill anchors); unheld docs report {} — the
        whole history is missing."""
        out = {}
        for d in doc_ids:
            doc = self._doc_set.get_doc(d)
            out[d] = dict(doc._doc.opset.clock) if doc is not None else {}
        return out

    def _handle_sub_msg(self, msg: dict) -> bool:
        sub = msg.get(SUB_KEY)
        if sub is None:
            return False
        add = list(sub.get("add") or ())
        prefixes = list(sub.get("prefixes") or ())
        removed = list(sub.get("remove") or ())
        removed_prefixes = list(sub.get("remove_prefixes") or ())
        if add or prefixes:
            metrics.bump("sync_sub_adds", len(add) + len(prefixes))
        if removed or removed_prefixes:
            metrics.bump("sync_sub_removes",
                         len(removed) + len(removed_prefixes))
        # `removed*` as applied to the interest set stays the wire
        # delta; `report_removed*` (what on_sub_change / the hub's
        # refcounts see) additionally carries a reset's WHOLE old set —
        # a reset REPLACES the interest, and a hub that re-counted the
        # re-declared entries without releasing the old ones would pin
        # the cover forever after the child departs. (_merge_delta
        # applies adds before removes in one call, so kept entries net
        # to zero with no upstream churn.)
        report_removed = list(removed)
        report_removed_prefixes = list(removed_prefixes)
        if sub.get("snap"):
            self._peer_wants_snap = True
        with self._state_lock:
            if sub.get("reset"):
                old = self._peer_interest
                self._peer_interest = InterestSet()
                if old.explicit:
                    report_removed += sorted(old.docs)
                    report_removed_prefixes += list(old.prefixes)
            new_docs, new_prefixes = self._peer_interest.apply(
                add=add, prefixes=prefixes, remove=removed,
                remove_prefixes=removed_prefixes, mode=sub.get("mode"))
        flightrec.record("sub_change", added=len(new_docs),
                         prefixes=len(new_prefixes),
                         removed=len(report_removed))
        if self.on_sub_change is not None:
            self.on_sub_change(self, {
                "added": new_docs, "added_prefixes": new_prefixes,
                "removed": report_removed,
                "removed_prefixes": report_removed_prefixes})
        self._backfill(new_docs, new_prefixes, sub.get("clocks") or {})
        return True

    def _backfill(self, new_docs, new_prefixes, clocks: dict) -> None:
        """Targeted late-subscribe backfill: push each newly-covered
        held doc's missing suffix (vs the subscriber's declared clock,
        else its last advert, else {} = full history of THAT doc) via
        the existing missing_changes snapshot read plane. Prefix adds
        only ADVERTISE matching held docs — the subscriber answers with
        its clock and the ordinary anti-entropy flow ships the delta —
        so a broad prefix never triggers a speculative bulk push."""
        targets = [d for d in new_docs
                   if self._doc_set.get_doc(d) is not None]
        with self._state_lock:
            for d in targets:
                known = clocks.get(d)
                if known is not None:
                    self._their_clock = self._clock_union(
                        self._their_clock, d, known)
                elif d not in self._their_clock:
                    self._their_clock = self._clock_union(
                        self._their_clock, d, {})
                metrics.bump("sync_sub_backfills")
                if not (known or {}) and self._maybe_send_snapshot(d):
                    # image shipped: the suffix flows when the joiner's
                    # post-apply advert arrives (its clock then covers
                    # the image), so a lost or refused image degrades to
                    # ordinary full-history anti-entropy instead of
                    # stranding the middle of the history
                    continue
                self.maybe_send_changes(d)
            if new_prefixes:
                for d in self._doc_set.doc_ids:
                    if d in targets or self._doc_set.get_doc(d) is None:
                        continue
                    if any(d.startswith(p) for p in new_prefixes):
                        self.maybe_send_changes(d)

    def _maybe_send_snapshot(self, doc_id: str) -> bool:
        """Serve a fresh joiner (empty declared clock, snap-capable) a
        compacted doc-state image instead of full history. Runs under
        _state_lock (the _backfill path). True when an image shipped —
        the peer's assumed clock advances to the image's covered clock,
        so the ordinary missing-suffix flow sends only the tail."""
        if not self._peer_wants_snap:
            return False
        offer_fn = getattr(self._doc_set, "snapshot_payload_for", None)
        if offer_fn is None:
            return False
        offer = offer_fn(doc_id)
        if offer is None:
            return False
        blob, sclock = offer
        import base64

        doc = self._doc_set.get_doc(doc_id)
        clock = doc._doc.opset.clock
        self._our_clock = self._clock_union(self._our_clock, doc_id, clock)
        self._snap_sent.add(doc_id)
        metrics.bump("sync_snapshot_frames_sent")
        metrics.bump("sync_snapshot_bytes_sent", len(blob))
        if self._ledger is not None:
            self._ledger.record_send(doc_id, self, 0, nbytes=len(blob))
        self._send_traced({
            "docId": doc_id, "clock": dict(clock),
            SNAP_KEY: {"clock": dict(sclock),
                       "b64": base64.b64encode(blob).decode("ascii")}})
        return True

    def _maybe_sub_flap(self, doc_id: str) -> None:
        """Chaos `sub_flap` (utils/chaos.py AMTPU_CHAOS_SUB_FLAP_DOC):
        subscribe/unsubscribe churn on exactly one doc, injected on the
        SUBSCRIBER side of an explicit-interest connection — the
        interest-plane fault class `perf explain` must attribute
        (doc_unsubscribed with a churn note) instead of flagging a
        stall. Inert (one cached check) unless the knob is set."""
        if not self._local_interest.narrowed:
            return
        if not chaos.sub_flap(getattr(self._doc_set, "_chaos_node", None),
                              doc_id):
            return
        if self._local_interest.covers(doc_id):
            self.subscribe(remove=[doc_id])
        else:
            self.subscribe(docs=[doc_id])

    # -- metrics pull (METRICS message type; no reference counterpart) ------

    def request_metrics(self, spans: bool = False) -> None:
        """Ask the peer for its metrics.snapshot(). The answer lands in
        self.peer_metrics (and on_peer_metrics fires, if set). With
        spans=True the peer also ships its recent-span ring buffer (lands
        in self.peer_spans; feed `metrics.merge_timeline({...})` together
        with the local ring for the cross-replica timeline). Carried as a
        `{"metrics": ...}` message — JSON, so it crosses the TCP transport
        and any reference-framing relay unchanged; doc-sync peers that
        predate the message type simply never send it."""
        msg: dict = {"metrics": "pull"}
        if spans:
            msg["spans"] = True
        self._send_traced(msg)

    def _handle_metrics_msg(self, msg: dict) -> bool:
        kind = msg.get("metrics")
        if kind is None:
            return False
        if kind == "pull":
            metrics.bump("sync_metrics_pulls")
            resp = {"metrics": "snapshot", "snapshot": metrics.snapshot()}
            node = metrics.node_name()
            if node is not None:
                resp["node"] = node
            if msg.get("spans"):
                resp["spans"] = metrics.recent_spans()
            self._send_traced(resp)
        elif kind == "snapshot":
            import time as _time
            self.peer_metrics = msg.get("snapshot") or {}
            self.peer_metrics_at = _time.time()
            if msg.get("node"):
                self.peer_node = str(msg["node"])
            if "spans" in msg:
                self.peer_spans = msg.get("spans") or []
            if self.on_peer_metrics is not None:
                self.on_peer_metrics(self.peer_metrics)
        return True

    # -- convergence audit (AUDIT message type; sync/audit.py) --------------

    def request_audit(self) -> None:
        """Start one audit round: ask the peer for its per-shard state
        digests. The comparison (and the doc-level bisect on mismatch)
        runs in the attached ConvergenceAuditor when the answer arrives."""
        self._send_traced({"audit": "pull"})

    def _handle_audit_msg(self, msg: dict) -> bool:
        if msg.get("audit") is None:
            return False
        from .audit import handle_audit_msg
        handle_audit_msg(self, msg)
        return True

    # -- receiving (connection.js:96-113) -----------------------------------

    def receive_msg(self, msg: dict):
        """Transport entry point. The whole serve runs under a
        `sync_msg_serve` span that adopts the sender's trace context
        (frames.TRACE_KEY), so one sync round reads as one stitched trace
        across replicas."""
        ctx = unpack_trace(msg.pop(TRACE_KEY, None)) \
            if isinstance(msg, dict) else None
        with metrics.adopt_context(ctx), metrics.trace("sync_msg_serve"):
            return self._receive_msg(msg)

    def _account_delivery(self, doc_id: str, pairs,
                          nbytes: int | None) -> None:
        """Split a delivered change batch into useful vs duplicate
        against the pre-apply local clock and record both globally
        (`sync_conn_changes_*` — the redundancy ratio's two legs) and
        per (doc, peer) in the ledger. `pairs` is [(actor, seq), ...].
        Changes ahead of the frontier count as useful even when they
        park in the causal queue first — they are new information; only
        already-covered (actor, seq) pairs are wasted wire work.

        The frontier comes from the ledger's LOCK-FREE peek, never from
        clock_of(): a locked read here would re-serialize the whole
        receive hot path on the service lock (and inline-flush the epoch
        buffer before every apply — exactly what concurrent_ingest
        transports exist to avoid), with the cost invisible to the
        ledger's own duty-cycle gate. An indeterminate peek (cold cache)
        counts the whole batch useful — duplicates are only counted when
        the frontier is cheaply known, so the redundancy ratio is a
        LOWER bound, and a slightly stale cached clock errs the same
        safe direction."""
        if self._ledger is None:
            return
        pre = self._ledger._peek_local_clock(doc_id)
        if pre is None:
            dup = 0
        else:
            dup = sum(1 for a, s in pairs if s <= pre.get(a, 0))
        useful = len(pairs) - dup
        if useful:
            metrics.bump("sync_conn_changes_delivered", useful)
        if dup:
            metrics.bump("sync_conn_changes_duplicate", dup)
        self._ledger.record_receive(doc_id, self, useful, dup,
                                    nbytes=nbytes)

    def _receive_msg(self, msg: dict):
        metrics.bump("sync_conn_msgs_received", kind=msg_kind(msg))
        # metrics / audit serving touches only thread-safe surfaces (the
        # metrics registry; the engine's audit/hash caches) — served
        # outside the transport state lock, so one peer's audit pull no
        # longer queues every other peer's receive chain behind an
        # engine read (the r6-baselined tcp.py lock hold, now retired)
        if self._handle_metrics_msg(msg):
            return None
        if self._handle_audit_msg(msg):
            return None
        if self._handle_sub_msg(msg):
            return None
        # op-lifecycle provenance: records the wire lag now, the
        # peer-apply + convergence lag once the apply below finishes
        lag = oplag.wire_receive(msg.pop(OPLAG_KEY, None))
        doc_id = msg["docId"]
        # trace-plane stitching: adopt the sender's lifecycle traces
        # (the key is popped UNCONDITIONALLY — the envelope must not
        # leak it downstream — and recording ignores the local sampling
        # rate: the sender paid the decision)
        tctx = tracer.wire_receive(msg.pop(TRACEPLANE_KEY, None), doc_id)
        if msg.get("clock") is not None:
            with self._state_lock:
                self._their_clock = self._clock_union(
                    self._their_clock, doc_id, msg["clock"])
            if self._floor_sink is not None:
                self._floor_sink.note_peer_clock(self, doc_id, msg["clock"])
            if self._ledger is not None:
                # the ledger's frontier lane: what this peer claims to
                # have, vs the local clock it peeks lock-free
                self._ledger.record_advert(doc_id, self, msg["clock"])
            self._maybe_sub_flap(doc_id)
        snap = msg.get(SNAP_KEY)
        if snap is not None:
            import base64
            apply_snap = getattr(self._doc_set, "apply_snapshot", None)
            if apply_snap is not None:
                blob = base64.b64decode(snap["b64"])
                with self._apply_lock:
                    # a False return (doc no longer empty — e.g. normal
                    # sync raced the image) is fine: the suffix frames
                    # behind this message still converge the doc
                    apply_snap(doc_id, blob)
            return self._doc_set.get_doc(doc_id)
        if msg.get("frame") is not None:
            from .frames import decode_frame
            metrics.bump("sync_frames_received")
            metrics.bump("sync_frame_bytes_received", len(msg["frame"]))
            t_dec = time.perf_counter()
            cols = decode_frame(msg["frame"])
            decode_s = time.perf_counter() - t_dec
            self._account_delivery(
                doc_id,
                [(cols.actors[int(a)], int(s))
                 for a, s in zip(cols.change_actor, cols.change_seq)],
                len(msg["frame"]))
            # DocSets exposing a column ingress get the decoded columns
            # as-is (the engine service's native-encoder seam); plain
            # DocSets materialize changes from them. The apply runs
            # under _apply_lock — a no-op for doc_sets declaring
            # concurrent_ingest, so N peer reader threads ride ONE
            # group-commit flush instead of serializing node-wide.
            t_adm = time.perf_counter()
            # tracer.remote_apply: a received change is never re-traced
            # as a local origin — its lifecycle belongs to the sender's
            # stitched context (tctx above)
            with self._apply_lock, tracer.remote_apply():
                if hasattr(self._doc_set, "apply_columns"):
                    out = self._doc_set.apply_columns(doc_id, cols)
                else:
                    out = self._doc_set.apply_changes(doc_id,
                                                      cols.to_changes())
            oplag.peer_applied(lag)
            tracer.remote_admitted(tctx, doc_id, decode_s,
                                   time.perf_counter() - t_adm)
            return out
        if msg.get("changes") is not None:
            chs = [coerce_change(c) for c in msg["changes"]]
            self._account_delivery(doc_id,
                                   [(c.actor, c.seq) for c in chs], None)
            t_adm = time.perf_counter()
            with self._apply_lock, tracer.remote_apply():
                out = self._doc_set.apply_changes(doc_id, chs)
            oplag.peer_applied(lag)
            tracer.remote_admitted(tctx, doc_id, 0.0,
                                   time.perf_counter() - t_adm)
            return out

        with self._state_lock:
            if self._doc_set.get_doc(doc_id) is not None:
                self.maybe_send_changes(doc_id)
            elif doc_id not in self._our_clock:
                # The peer has a doc we don't know: request it.
                self.send_msg(doc_id, {})

            return self._doc_set.get_doc(doc_id)
