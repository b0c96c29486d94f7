"""The port's `Connection` (both wire modes, subscriptions) and convergence
auditor held to the reference's, on the CPU, and a reference node and a
port node syncing with each other.

The cases of the reference's `tests/test_connection.py`,
`tests/test_subscriptions.py` (with its perf-plane cases: explain, the
SLO engine, `perf top`, the history gate) and
`tests/test_convergence_audit.py` that need no socket and no wall clock
run on both packages through `torch_twin_helpers.run_twin`.

Cross-package sync: a reference `EngineDocSet(backend="rows")` and a port
one on `device="cpu"` are joined by `Connection`s over in-process queues,
in both wire modes ("json" change lists and "columnar" AMW1 frames).
Concurrent writes go in on both sides, a message is dropped and another
delivered twice; after a drain, the two nodes' hashes, clocks and
`materialize` must be equal, and equal to a reference node fed every
change directly. Tolerance: exact.
"""

import random
from collections import deque

import pytest

from torch_twin_helpers import collect, hygiene_teardown, run_twin

import automerge_tpu as ref_am
from automerge_tpu.core.change import Change as RefChange, Op as RefOp
from automerge_tpu.sync.connection import Connection as RefConnection
from automerge_tpu.sync.service import EngineDocSet as RefEngineDocSet

from automerge_tpu_torch import api
from automerge_tpu_torch.core.change import Change, Op
from automerge_tpu_torch.core.ids import ROOT_ID
from automerge_tpu_torch.sync.audit import ConvergenceAuditor
from automerge_tpu_torch.sync.connection import Connection
from automerge_tpu_torch.sync.service import EngineDocSet

CASES = (
    collect("test_connection")
    + collect("test_subscriptions", exclude={
        "test_governor_delays_low_priority_only_and_discloses":
            "asserts on wall-clock delays",
    })
    + collect("test_convergence_audit")
)


@pytest.fixture(autouse=True)
def _hygiene():
    yield
    hygiene_teardown()


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reference_case_on_both_packages(case, tmp_path, monkeypatch):
    run_twin(case, tmp_path, monkeypatch)


# ---------------------------------------------------------------------------
# a reference node and a port node


class Link:
    """Two Connections joined by in-process queues; `faults` drops the
    k-th message of a direction (True) or delivers it twice (False)."""

    def __init__(self, ref_node, port_node, wire, faults=None):
        self.nodes, self.wire = (ref_node, port_node), wire
        self.to_port, self.to_ref = deque(), deque()
        self._connect()
        self.faults = dict(faults or {})
        self.sent = {"to_port": 0, "to_ref": 0}

    def _connect(self):
        ref_node, port_node = self.nodes
        self.ref = RefConnection(ref_node, self.to_port.append,
                                 wire=self.wire)
        self.port = Connection(port_node, self.to_ref.append,
                               wire=self.wire)

    def _deliver(self, name, queue, conn):
        msg = queue.popleft()
        self.sent[name] += 1
        fault = self.faults.pop((name, self.sent[name]), None)
        if fault is True:
            return                       # dropped
        conn.receive_msg(msg)
        if fault is False:
            conn.receive_msg(msg)        # delivered twice

    def pump(self):
        for _ in range(10_000):
            if not self.to_port and not self.to_ref:
                return
            while self.to_port:
                self._deliver("to_port", self.to_port, self.port)
            while self.to_ref:
                self._deliver("to_ref", self.to_ref, self.ref)
        raise AssertionError("link failed to quiesce")

    def open(self):
        self.ref.open()
        self.port.open()
        self.pump()

    def reopen(self):
        """A dropped message is recovered by reconnecting: fresh
        Connections re-advertise every clock (a sender assumes what it
        sent arrived, so the old pair would never resend it)."""
        self.ref.close()
        self.port.close()
        self._connect()
        self.open()


def _writes(seed: int, n: int = 60):
    """(side, doc, actor, seq, key, value) writes: two actors a side,
    interleaved over three documents."""
    rng = random.Random(seed)
    seqs = {}
    out = []
    for _ in range(n):
        side = rng.choice(("ref", "port"))
        actor = rng.choice(("R1", "R2") if side == "ref" else ("P1", "P2"))
        doc = rng.choice(("d0", "d1", "d2"))
        seqs[(actor, doc)] = seqs.get((actor, doc), 0) + 1
        out.append((side, doc, actor, seqs[(actor, doc)],
                    rng.choice("abc"), rng.randrange(1000)))
    return out


def _change(ref, actor, seq, key, value, deps):
    ch, op = (RefChange, RefOp) if ref else (Change, Op)
    return ch(actor=actor, seq=seq, deps=deps,
              ops=[op("set", ROOT_ID, key=key, value=value)])


@pytest.mark.parametrize("wire", ["json", "columnar"])
@pytest.mark.parametrize("seed", [3, 8])
def test_reference_and_port_nodes_converge(wire, seed):
    ref_node = RefEngineDocSet(backend="rows", ingest_mode="locked")
    port_node = EngineDocSet(backend="rows", device="cpu",
                             ingest_mode="locked")
    oracle = RefEngineDocSet(backend="rows", ingest_mode="locked")
    link = Link(ref_node, port_node, wire,
                faults={("to_port", 3): True, ("to_ref", 4): False,
                        ("to_ref", 9): True, ("to_port", 7): False})
    try:
        link.open()
        for k, (side, doc, actor, seq, key, value) in enumerate(
                _writes(seed)):
            node = ref_node if side == "ref" else port_node
            # each change depends on what its node has of the doc
            have = (node.clock_of(doc) if node.get_doc(doc) is not None
                    else {})
            deps = {a: s for a, s in have.items() if a != actor}
            node.apply_changes(doc, [_change(side == "ref", actor, seq,
                                             key, value, deps)])
            oracle.apply_changes(doc, [_change(True, actor, seq, key,
                                               value, deps)])
            if k % 7 == 6:
                link.pump()
        link.pump()
        link.reopen()
        assert not link.faults, "every planned fault fired"
        want = oracle.hashes()
        assert ref_node.hashes() == want
        assert port_node.hashes() == want
        for d in want:
            assert port_node.clock_of(d) == ref_node.clock_of(d) \
                == oracle.clock_of(d)
            assert port_node.materialize(d) == ref_node.materialize(d) \
                == oracle.materialize(d)
    finally:
        for n in (ref_node, port_node, oracle):
            n.close()


@pytest.mark.parametrize("wire", ["json", "columnar"])
def test_interactive_reference_doc_syncs_into_a_port_node(wire):
    """A reference node serving documents built through the reference's
    document API, and a port node in epoch mode (the default), over the
    same link; the port node's `materialize` equals the documents'."""
    doc = ref_am.change(ref_am.init("alice"),
                        lambda d: ref_am.assign(d, {"title": "t",
                                                    "tags": ["x", "y"]}))
    doc = ref_am.change(doc, lambda d: d["tags"].append("z"))
    ref_node = RefEngineDocSet(backend="rows")
    port_node = EngineDocSet(backend="rows", device="cpu")
    link = Link(ref_node, port_node, wire)
    try:
        ref_node.apply_changes("doc", doc._doc.opset.get_missing_changes({}))
        link.open()
        assert port_node.hashes() == ref_node.hashes()
        assert port_node.materialize("doc") == ref_node.materialize("doc")
        port_doc = api.apply_changes(
            api.init("bob", device="cpu"),
            port_node.missing_changes("doc", {}))
        assert api.save(port_doc) == ref_am.save(
            ref_am.apply_changes(ref_am.init("bob"),
                                 ref_node.missing_changes("doc", {})))
    finally:
        ref_node.close()
        port_node.close()


def test_port_auditor_finds_a_divergence_on_a_reference_peer():
    """A port node audits a reference peer (plain JSON audit messages):
    clean while converged; after one doc's state is corrupted on the
    reference side out of band, the report names that doc."""
    from test_convergence_audit import _inject_divergence

    ref_node = RefEngineDocSet(backend="rows", ingest_mode="locked")
    port_node = EngineDocSet(backend="rows", device="cpu",
                             ingest_mode="locked")
    link = Link(ref_node, port_node, "columnar")
    auditor = ConvergenceAuditor(port_node, link.port, period_s=0)
    try:
        link.open()
        for i in range(6):
            port_node.apply_changes(f"doc{i}", [_change(
                False, f"W{i}", 1, "k", i, {})])
        link.pump()
        auditor.audit_once()
        link.pump()
        assert auditor.rounds_clean >= 1 and not auditor.divergences
        _inject_divergence(ref_node, "doc3")
        auditor.audit_once()
        link.pump()
        (report,) = auditor.divergences
        assert report["doc_id"] == "doc3"
        assert report["clock"] == report["peer_clock"] == {"W3": 1}
        assert report["local_hash"] != report["peer_hash"]
    finally:
        auditor.stop()
        ref_node.close()
        port_node.close()


# ---------------------------------------------------------------------------
# a doc admitted while a connection opens


def test_doc_admitted_while_a_connection_opens_is_advertised():
    """A hub's reader thread can admit another peer's doc while a new
    peer's Connection opens. The reference walks the docs, then registers
    its handler, so a doc admitted in between is never advertised to the
    new peer (the four-process hub case of tests/test_torch_multihost.py
    then waits forever for it). The port registers first: here the doc
    list itself admits a doc as the walk reads it, and that doc reaches
    the new peer; the reference's Connection misses it."""
    from automerge_tpu.sync.docset import DocSet as RefDocSet
    from automerge_tpu_torch.sync.docset import DocSet

    for ds_cls, am_mod, init, conn_cls, reaches in (
            (RefDocSet, ref_am, ref_am.init, RefConnection, False),
            (DocSet, api, lambda a: api.init(a, device="cpu"), Connection,
             True)):
        class AdmitsDuringOpen(ds_cls):
            armed = True

            @property
            def doc_ids(self):
                ids = list(super().doc_ids)
                if self.armed:
                    self.armed = False
                    self.set_doc("late", am_mod.change(
                        init("spoke2"), lambda d: d.__setitem__("n", 2)))
                return ids
        ds = AdmitsDuringOpen(**({} if ds_cls is RefDocSet
                                 else {"device": "cpu"}))
        ds.set_doc("early", am_mod.change(
            init("hub"), lambda d: d.__setitem__("n", 0)))
        sent = []
        conn_cls(ds, sent.append).open()
        advertised = {m["docId"] for m in sent}
        assert "early" in advertised
        assert ("late" in advertised) is reaches, ds_cls


# ---------------------------------------------------------------------------
# the shared lock while a connection opens

#: documents an opening connection walks, and the id before which the
#: walk's hook runs
WALK_DOCS = 300
WALK_HOOK_AT = 150


class _HookedIds(list):
    """A doc id list whose iterator calls `hook` before it yields the
    `at`-th id: between two of the walk's documents, outside any section
    the walk takes for one of them."""

    def __init__(self, ids, at, hook):
        super().__init__(ids)
        self.at, self.hook = at, hook

    def __iter__(self):
        for k, doc_id in enumerate(super().__iter__()):
            if k == self.at:
                self.hook()
            yield doc_id


def _hooked(ds_cls):
    """`ds_cls` whose `doc_ids` runs `self.walk_hook` (when set) in the
    middle of the next walk over them."""
    class Hooked(ds_cls):
        walk_hook = None

        @property
        def doc_ids(self):
            ids = super().doc_ids
            hook, self.walk_hook = self.walk_hook, None
            return ids if hook is None else _HookedIds(ids, WALK_HOOK_AT,
                                                       hook)
    return Hooked


def _walk_doc_set(package, kind):
    """A doc set of WALK_DOCS documents, of the package's rows
    `EngineDocSet` or its plain `DocSet`, and the package's `tcp`
    module."""
    ref = package == "reference"
    if ref:
        from automerge_tpu.sync import tcp
        from automerge_tpu.sync.docset import DocSet as PlainDocSet
    else:
        from automerge_tpu_torch.sync import tcp
        from automerge_tpu_torch.sync.docset import DocSet as PlainDocSet
    ids = [f"d{i:03d}" for i in range(WALK_DOCS)]
    if kind == "rows_engine":
        cls = _hooked(RefEngineDocSet if ref else EngineDocSet)
        kw = {} if ref else {"device": "cpu"}
        return cls(ids, backend="rows", ingest_mode="locked", **kw), tcp
    ds = _hooked(PlainDocSet)(**({} if ref else {"device": "cpu"}))
    am_mod = ref_am if ref else api
    doc = am_mod.change(
        ref_am.init("hub") if ref else api.init("hub", device="cpu"),
        lambda d: d.__setitem__("n", 0))
    for doc_id in ids:
        ds.set_doc(doc_id, doc)
    return ds, tcp


@pytest.mark.parametrize("kind", ["rows_engine", "plain"])
@pytest.mark.parametrize("package", ["reference", "port"])
def test_shared_lock_is_free_between_the_documents_open_walks(package,
                                                               kind):
    """Under a transport every connection on a doc set shares one lock.
    An opening connection takes it one document at a time, so another
    peer's reader gets it between two documents of the walk instead of
    waiting for the whole walk: here a second thread's non-blocking
    acquire, made halfway through, succeeds. Every document is still
    advertised."""
    import threading

    ds, tcp = _walk_doc_set(package, kind)
    got = []

    def probe():
        lock = tcp.sync_lock(ds)
        if lock.acquire(blocking=False):
            lock.release()
            got.append(True)
        else:
            got.append(False)

    def hook():
        t = threading.Thread(target=probe, name="amtpu-torch-lock-probe")
        t.start()
        t.join()

    sent = []
    conn = tcp.LockedConnection(ds, sent.append)
    try:
        ds.walk_hook = hook
        conn.open()
        assert got == [True]
        assert {m["docId"] for m in sent} == set(ds.doc_ids)
    finally:
        conn.close()
        if kind == "rows_engine":
            ds.close()


@pytest.mark.parametrize("replaced", ["walked", "next"])
def test_doc_replaced_while_a_connection_opens_sends_its_newest_clock(
        replaced):
    """A plain DocSet's doc is replaced by a newer state in the middle of
    open()'s walk, through set_doc, which fires the connection's handler:
    a doc the walk has advertised already, or the one it reads next.
    open() raises no "old state" error, and the last clock sent for the
    doc is the newest."""
    from automerge_tpu_torch.sync.tcp import LockedConnection

    ds, _tcp = _walk_doc_set("port", "plain")
    target = "d000" if replaced == "walked" else f"d{WALK_HOOK_AT:03d}"
    newer = api.change(ds.get_doc(target), lambda d: d.__setitem__("n", 1))
    ds.walk_hook = lambda: ds.set_doc(target, newer)
    sent = []
    conn = LockedConnection(ds, sent.append)
    try:
        conn.open()
        clocks = [m["clock"] for m in sent if m["docId"] == target]
        assert clocks[-1] == newer._doc.opset.clock == {"hub": 2}
        assert {m["docId"] for m in sent} == set(ds.doc_ids)
    finally:
        conn.close()
