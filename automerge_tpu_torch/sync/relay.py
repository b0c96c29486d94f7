"""Relay fan-out tree: hub nodes between writers and subscriber leaves (the
port of `automerge_tpu/sync/relay.py`, whole).

Flat-mesh sync costs O(clients x docs) wire and a hot doc costs O(N)
sends from its origin. **RelayHub** is a store-and-forward node that

- aggregates its downstream children's interest into one merged **cover
  set** (union of doc ids and prefixes, refcounted per child);
- **dedupes upward subscriptions**: a doc two children want is
  subscribed upstream once (`sync_relay_sub_deduped` counts the saved
  adds), and a doc already under a covering upstream prefix is never
  doc-subscribed at all;
- fans changes down the tree: the hub's doc_set admits a change once and
  its per-child Connections gossip it, each filtered to that child's
  interest, so a hot doc costs the origin O(fanout) sends and the tree
  O(depth) hops instead of O(N) direct sends;
- survives **re-homing**: when a hub dies, its children reattach
  elsewhere and replay their interest (`Connection.resubscribe()`, the
  reset-form sub message with clocks), and the adopting hub backfills
  whatever they missed through the ordinary `missing_changes` plane.

The hub is transport-agnostic, exactly like Connection: callers build
the Connections (in-process queues, TCP, whatever) and hand the
child-facing ones to `attach_child` and the parent-facing one to
`set_upstream`. The hub never looks inside messages: it reacts to
interest changes through Connection.on_sub_change. It starts no thread
and holds no tensor; the hub's doc_set (an `EngineDocSet` on its own
device, or a plain `DocSet`) does the work.

Lock order: the hub's cover lock is leaf-level (no calls into the
service or other locks while held); upstream sends happen outside it.
"""

from __future__ import annotations

import threading

from ..utils import flightrec, metrics
from .connection import Connection, InterestSet  # noqa: F401 (InterestSet
# is re-exported: relay topologies are the natural place callers import
# the interest semantics from)


class RelayHub:
    """One relay node: a doc_set plus the interest bookkeeping that
    merges downstream subscriptions into a deduped upstream cover."""

    def __init__(self, doc_set, label: str | None = None,
                 local_interest=()):
        self.doc_set = doc_set
        self.label = label
        # docs/prefixes the hub itself wants regardless of children
        # (a hub co-hosting an application; usually empty for pure relays)
        self._own_docs = set(local_interest)
        self._lock = threading.Lock()
        self._children: list[Connection] = []
        # child-interest refcounts: how many children (plus the hub
        # itself) currently cover each doc id / prefix
        self._doc_refs: dict[str, int] = {d: 1 for d in self._own_docs}
        self._prefix_refs: dict[str, int] = {}
        self._up: Connection | None = None
        # what is currently subscribed upstream (docs not under a
        # covering upstream prefix, plus the prefixes themselves)
        self._up_docs: set[str] = set()
        self._up_prefixes: set[str] = set()

    # -- cover set -----------------------------------------------------------

    def cover(self) -> tuple[set[str], set[str]]:
        """(doc ids, prefixes) of the merged downstream+own interest."""
        with self._lock:
            return set(self._doc_refs), set(self._prefix_refs)

    def covers(self, doc_id: str) -> bool:
        with self._lock:
            return doc_id in self._doc_refs or any(
                doc_id.startswith(p) for p in self._prefix_refs)

    def _under_prefix_locked(self, doc_id: str) -> bool:
        return any(doc_id.startswith(p) for p in self._prefix_refs)

    # -- children ------------------------------------------------------------

    def children(self) -> list[Connection]:
        """Snapshot of the currently attached downstream connections —
        what a caller walks when a hub's subtree must be re-homed."""
        with self._lock:
            return list(self._children)

    def attach_child(self, conn: Connection) -> None:
        """Adopt a downstream connection (hub-side). Its future sub
        messages re-merge the cover; interest it already declared (a
        re-homed child that resubscribed before attach) merges now."""
        conn.on_sub_change = self._child_sub_changed
        with self._lock:
            self._children.append(conn)
        it = conn._peer_interest
        if it.explicit and (it.docs or it.prefixes):
            self._merge_delta(list(it.docs), list(it.prefixes), [], [])

    def detach_child(self, conn: Connection) -> None:
        """Release a departed child's interest refs; upstream
        subscriptions whose refcount reaches zero are removed (a dead
        leaf must not pin the cover forever)."""
        with self._lock:
            if conn in self._children:
                self._children.remove(conn)
        if conn.on_sub_change == self._child_sub_changed:
            conn.on_sub_change = None
        it = conn._peer_interest
        if it.explicit:
            self._merge_delta([], [], list(it.docs), list(it.prefixes))

    def set_upstream(self, conn: Connection | None) -> None:
        """Attach the parent-facing connection and push the current
        merged cover up (reset form, clocks included — the adopting
        parent backfills what this subtree missed). None detaches."""
        with self._lock:
            self._up = conn
            self._up_docs = set()
            self._up_prefixes = set()
        if conn is None:
            return
        docs, prefixes = self.cover()
        with self._lock:
            self._up_prefixes = set(prefixes)
            self._up_docs = {d for d in docs
                             if not any(d.startswith(p) for p in prefixes)}
            up_docs, up_prefixes = sorted(self._up_docs), sorted(prefixes)
        if up_docs or up_prefixes:
            conn.subscribe(docs=up_docs, prefixes=up_prefixes)
        self._refresh_gauge()

    # -- interest merging ----------------------------------------------------

    def _child_sub_changed(self, conn: Connection, delta: dict) -> None:
        self._merge_delta(delta.get("added") or [],
                          delta.get("added_prefixes") or [],
                          delta.get("removed") or [],
                          delta.get("removed_prefixes") or [])

    def _merge_delta(self, added, added_prefixes, removed,
                     removed_prefixes) -> None:
        """Refcount the delta into the cover and ship ONLY the upstream
        difference: adds that were already covered are deduped
        (`sync_relay_sub_deduped`); removes only propagate when the last
        referencing child departs."""
        up_add: list[str] = []
        up_add_prefixes: list[str] = []
        up_remove: list[str] = []
        up_remove_prefixes: list[str] = []
        deduped = 0
        with self._lock:
            for d in added:
                n = self._doc_refs.get(d, 0)
                self._doc_refs[d] = n + 1
                if n or self._under_prefix_locked(d) or d in self._up_docs:
                    deduped += 1
                else:
                    up_add.append(d)
            for p in added_prefixes:
                n = self._prefix_refs.get(p, 0)
                self._prefix_refs[p] = n + 1
                if n or p in self._up_prefixes:
                    deduped += 1
                else:
                    up_add_prefixes.append(p)
                    # docs the new prefix absorbs need no upstream doc-sub
                    absorbed = {d for d in self._up_docs if d.startswith(p)}
                    self._up_docs -= absorbed
                    up_remove.extend(sorted(absorbed))
            for d in removed:
                n = self._doc_refs.get(d, 0)
                if n <= 1:
                    self._doc_refs.pop(d, None)
                    if d in self._up_docs:
                        self._up_docs.discard(d)
                        up_remove.append(d)
                else:
                    self._doc_refs[d] = n - 1
            for p in removed_prefixes:
                n = self._prefix_refs.get(p, 0)
                if n <= 1:
                    self._prefix_refs.pop(p, None)
                    if p in self._up_prefixes:
                        self._up_prefixes.discard(p)
                        up_remove_prefixes.append(p)
                        # re-subscribe the doc ids the departing prefix
                        # had ABSORBED upstream: still-refcounted docs
                        # under it would otherwise silently lose their
                        # upstream coverage (adds are applied before
                        # prefix removes on the receiving side, so
                        # coverage never gaps)
                        orphaned = sorted(
                            d for d in self._doc_refs
                            if d.startswith(p)
                            and not self._under_prefix_locked(d)
                            and d not in self._up_docs)
                        self._up_docs.update(orphaned)
                        up_add.extend(orphaned)
                else:
                    self._prefix_refs[p] = n - 1
            self._up_docs.update(up_add)
            self._up_prefixes.update(up_add_prefixes)
            up = self._up
        if deduped:
            metrics.bump("sync_relay_sub_deduped", deduped)
        if up is not None and (up_add or up_add_prefixes or up_remove
                               or up_remove_prefixes):
            up.subscribe(docs=up_add, prefixes=up_add_prefixes,
                         remove=up_remove,
                         remove_prefixes=up_remove_prefixes)
        self._refresh_gauge()

    def _refresh_gauge(self) -> None:
        with self._lock:
            n = len(self._doc_refs) + len(self._prefix_refs)
        metrics.gauge("sync_relay_cover_docs", n,
                      **({"node": self.label} if self.label else {}))

    # -- re-homing -----------------------------------------------------------

    def adopt(self, conn: Connection) -> None:
        """Adopt an orphaned downstream connection after its previous
        hub died: attach it and merge whatever interest it has already
        replayed (the child side calls `resubscribe()` on its new
        connection — reset-form interest with clocks — and the ordinary
        backfill ships what the subtree missed)."""
        flightrec.record("relay_rehome", node=self.label)
        self.attach_child(conn)
