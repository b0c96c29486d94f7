"""The port's relay hub (`automerge_tpu_torch/sync/relay.py`, `RelayHub`) in
a tree whose nodes are of both packages, on the CPU.

The reference's relay cases (`tests/test_subscriptions.py`) run on both
packages in `tests/test_torch_connection.py`, and its trace-stitching
cases through a relay chain (`tests/test_trace_propagation.py`) here,
through `torch_twin_helpers.run_twin`.

A mixed tree: a reference rows node at the root writes random
multi-actor histories (`test_torch_tcp.histories`); a port rows node
behind a port `RelayHub` relays them to three port leaves and a
reference leaf, each subscribed to a few docs, over `Connection`s in both
wire modes joined by in-process queues. Each leaf ends with exactly its
subscribed docs, with the root's hashes, clocks and documents; the hub's
cover is the union of the leaves' interest with each shared doc
subscribed upstream once. Then the hub dies and its children re-home to
a second port hub that adopts them: writes made while they were orphaned
are backfilled. Tolerance: exact.
"""

from collections import deque

import numpy as np
import pytest

from test_torch_tcp import histories
from torch_twin_helpers import collect, hygiene_teardown, run_twin

from automerge_tpu.sync.connection import Connection as RefConnection
from automerge_tpu.sync.service import EngineDocSet as RefEngineDocSet

from automerge_tpu_torch.sync.connection import Connection
from automerge_tpu_torch.sync.relay import RelayHub
from automerge_tpu_torch.sync.service import EngineDocSet
from automerge_tpu_torch.utils import metrics

CASES = collect("test_trace_propagation")


@pytest.fixture(autouse=True)
def _hygiene():
    yield
    hygiene_teardown()


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reference_case_on_both_packages(case, tmp_path, monkeypatch):
    run_twin(case, tmp_path, monkeypatch)


class Tree:
    """Named nodes joined by Connection pairs over one message queue."""

    def __init__(self, wire):
        self.wire, self.msgs, self.conns = wire, deque(), {}

    def link(self, a, b, name):
        """(a's connection to b, b's connection to a); a reference node
        gets the reference's Connection."""
        out = []
        for node, end, peer in ((a, name + ".a", name + ".b"),
                                (b, name + ".b", name + ".a")):
            cls = RefConnection if isinstance(node, RefEngineDocSet) \
                else Connection
            out.append(cls(node, lambda m, p=peer: self.msgs.append((p, m)),
                           wire=self.wire))
            self.conns[end] = out[-1]
        return out

    def pump(self):
        for _ in range(200_000):
            if not self.msgs:
                return
            name, m = self.msgs.popleft()
            conn = self.conns.get(name)
            if conn is not None:             # a dead node's queue drains
                conn.receive_msg(m)
        raise AssertionError("tree failed to quiesce")


def _state(node, docs):
    return ({d: int(np.uint32(node.hashes()[d])) for d in docs},
            {d: node.clock_of(d) for d in docs},
            {d: node.materialize(d) for d in docs})


@pytest.mark.parametrize("wire", ["json", "columnar"])
def test_mixed_tree_fans_out_by_interest_and_rehomes(wire):
    hist = histories(21, n_docs=5, n_changes=8)
    docs = sorted(hist)
    interest = [docs[0:2], docs[1:3], docs[2:4], [docs[1]]]
    root = RefEngineDocSet(backend="rows", ingest_mode="locked")
    hub_node = EngineDocSet(backend="rows", device="cpu",
                            ingest_mode="locked")
    leaves = [EngineDocSet(backend="rows", device="cpu",
                           ingest_mode="locked") for _ in range(3)]
    leaves.append(RefEngineDocSet(backend="rows", ingest_mode="locked"))
    hub2_node = EngineDocSet(backend="rows", device="cpu",
                             ingest_mode="locked")
    nodes = [root, hub_node, hub2_node] + leaves
    tree = Tree(wire)
    try:
        d0 = int(metrics.snapshot().get("sync_relay_sub_deduped", 0))
        hub = RelayHub(hub_node, label="hub")
        _root_side, hub_up = tree.link(root, hub_node, "rh")
        hub.set_upstream(hub_up)
        leaf_sides = []
        for i, leaf in enumerate(leaves):
            hub_side, leaf_side = tree.link(hub_node, leaf, f"hl{i}")
            hub.attach_child(hub_side)
            leaf_sides.append(leaf_side)
            leaf_side.subscribe(docs=interest[i])
        tree.pump()
        for c in list(tree.conns.values()):
            c.open()
        tree.pump()
        half = {d: len(chs) // 2 for d, chs in hist.items()}
        for d, chs in hist.items():
            root.apply_changes(d, chs[:half[d]])
            tree.pump()
        cover, prefixes = hub.cover()
        assert cover == set(docs[0:4]) and not prefixes
        # docs[1] is wanted by three leaves and docs[2] by two: three
        # upstream adds saved
        assert int(metrics.snapshot().get("sync_relay_sub_deduped", 0)) \
            >= d0 + 3
        assert docs[4] not in hub_node.doc_ids
        for leaf, want in zip(leaves, interest):
            assert sorted(leaf.doc_ids) == sorted(want)
            assert _state(leaf, want) == _state(root, want)

        # the hub dies; its children re-home to hub 2, which adopts them
        # after they resubscribe, while the root keeps writing
        for name in [n for n in tree.conns if n.startswith(("rh", "hl"))]:
            del tree.conns[name]
        hub2 = RelayHub(hub2_node, label="hub2")
        _root_side2, hub2_up = tree.link(root, hub2_node, "rh2")
        hub2.set_upstream(hub2_up)
        for d, chs in hist.items():
            root.apply_changes(d, chs[half[d]:])
        for i, leaf in enumerate(leaves):
            hub_side, leaf_side = tree.link(hub2_node, leaf, f"h2l{i}")
            leaf_side.subscribe(docs=interest[i])
            tree.pump()
            hub2.adopt(hub_side)
        for c in list(tree.conns.values()):
            c.open()
        tree.pump()
        assert hub2.cover()[0] == set(docs[0:4])
        for leaf, want in zip(leaves, interest):
            assert sorted(leaf.doc_ids) == sorted(want)
            assert _state(leaf, want) == _state(root, want)
        full = {d: len(chs) for d, chs in hist.items()}
        assert {d: sum(root.clock_of(d).values()) for d in docs} == full
    finally:
        for n in nodes:
            n.close()
