"""The port's `Connection` (both wire modes, subscriptions) and convergence
auditor held to the reference's, on the CPU, and a reference node and a
port node syncing with each other.

The cases of the reference's `tests/test_connection.py`,
`tests/test_subscriptions.py` and `tests/test_convergence_audit.py` that
need no socket, no unported module (relay, sharded service, perf
planes) and no wall clock run on both packages through
`torch_twin_helpers.run_twin`.

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

PERF = "needs a perf plane (automerge_tpu/perf), which is not ported"

CASES = (
    collect("test_connection")
    + collect("test_subscriptions", exclude={
        "test_explain_names_doc_unsubscribed_not_a_stall": PERF,
        "test_slo_engine_drives_governor": PERF,
        "test_perf_top_hot_doc_panel_states_truncation": PERF,
        "test_history_sub_gates_run_independently_per_field": PERF,
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
