"""The port's TCP transport (`automerge_tpu_torch/sync/tcp.py`) held to the
reference's on the CPU, and a reference node and a port node syncing over
a real socket.

Through `torch_twin_helpers.run_twin`, the cases of the reference's
`tests/test_tcp_sync.py` and `tests/test_race_regressions.py` run on both
packages. Left out: `test_multiple_docs_multiplexed` (its actor ids
depend on thread
scheduling; replaced below with named actors) and
`test_bidirectional_concurrent_edits_converge` (the client's recorded
document depends on whether the server's change has crossed the socket
before the client edits; replaced by `tests/torch_tcp_cases.py::
bidirectional_edits_after_the_server_change_arrives`, run on both
packages, whose client edits once a DocSet handler has seen the server's
change).

Cross-package: a reference `EngineDocSet(backend="rows")` and a port one
on `device="cpu"` are joined over TCP on 127.0.0.1, in both wire modes and
both directions (reference server with a port client, and the reverse).
Random multi-actor histories made from a seed (maps, lists, text, list
moves) are split between the two writers by actor and streamed in while
the link runs; both nodes converge to equal `hashes()`, `clock_of` and
`materialize`, each equal to a reference oracle fed every change. The
framing is byte-equal (`encode_msg`), and a port server takes a JSON and
an AMWM reference client on one port. Every socket binds 127.0.0.1 on
port 0; every server and client is closed and its threads are asserted
gone. Tolerance: exact.
"""

import random
import threading
import time

import numpy as np
import pytest

import torch_tcp_cases
from torch_twin_helpers import collect, helper_case, hygiene_teardown, run_twin

import automerge_tpu as ref_am
from automerge_tpu.sync import tcp as ref_tcp
from automerge_tpu.sync.service import EngineDocSet as RefEngineDocSet

from automerge_tpu_torch.core.change import Change
from automerge_tpu_torch.sync import tcp
from automerge_tpu_torch.sync.service import EngineDocSet

CASES = (
    collect("test_tcp_sync", exclude={
        "test_multiple_docs_multiplexed":
            "draws actor ids from the uuid factory on the test thread while "
            "the peer's reader thread draws them too, so the twin's ids "
            "depend on the scheduler; test_multiple_docs_multiplexed_"
            "named_actors below is the port's",
        "test_bidirectional_concurrent_edits_converge":
            "the client's recorded document depends on whether the server's "
            "change has crossed the socket before the client edits; "
            "torch_tcp_cases.bidirectional_edits_after_the_server_change_"
            "arrives (below) waits for it on an event",
    })
    + [helper_case(
        "torch_tcp_cases",
        torch_tcp_cases.bidirectional_edits_after_the_server_change_arrives,
        {})]
    + collect("test_race_regressions")
)


@pytest.fixture(autouse=True)
def _hygiene():
    yield
    hygiene_teardown()


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reference_case_on_both_packages(case, tmp_path, monkeypatch):
    run_twin(case, tmp_path, monkeypatch)


# ---------------------------------------------------------------------------
# random multi-actor histories


def _edit(rng, doc):
    """One random change body: a map set, a list insert or delete, a text
    insert or delete, a list move, or a nested map."""
    r = rng.randrange(6)
    v = rng.randrange(1000)

    def fn(d):
        if r == 0:
            d[f"k{v % 5}"] = v
        elif r == 1:
            xs = d["xs"]
            xs.insert_at(v % (len(xs) + 1), v)
        elif r == 2:
            t = d["t"]
            t.insert_at(v % (len(t) + 1), *f"{v}")
        elif r == 3 and len(d["xs"]) > 1:
            d["xs"].move(v % len(d["xs"]), (v // 7) % len(d["xs"]))
        elif r == 4 and len(d["t"]) > 0:
            d["t"].delete_at(v % len(d["t"]))
        else:
            d[f"m{v % 3}"] = {"v": v, "w": [v, str(v)]}
    return ref_am.change(doc, fn)


def histories(seed, n_docs=4, n_actors=4, n_changes=14):
    """{doc: [change, ...]} in causal order per doc: `n_actors` replicas
    of each doc edit at random and merge each other now and then."""
    rng = random.Random(seed)
    out = {}
    for i in range(n_docs):
        base = ref_am.change(ref_am.init(f"a{i}0"), lambda d: ref_am.assign(
            d, {"xs": [1, 2], "t": ref_am.Text()}))
        reps = [base] + [ref_am.merge(ref_am.init(f"a{i}{k}"), base)
                         for k in range(1, n_actors)]
        for _ in range(n_changes):
            k = rng.randrange(n_actors)
            reps[k] = _edit(rng, reps[k])
            j = rng.randrange(n_actors)
            if j != k and rng.random() < 0.3:
                reps[k] = ref_am.merge(reps[k], reps[j])
        merged = ref_am.init("oracle")
        for r in reps:
            merged = ref_am.merge(merged, r)
        out[f"doc{i}"] = merged._doc.opset.get_missing_changes({})
    return out


def _wait(predicate, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return False


def _tcp_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith("amtpu-torch-tcp")]


def run_pair(seed, wire, direction):
    """Stream `histories(seed)` into a reference node (actors ending in
    an even digit) and a port node (odd) joined over TCP; return the
    three nodes' hashes, clocks and documents after convergence (or at
    the time limit)."""
    hist = histories(seed)
    ref_node = RefEngineDocSet(backend="rows")
    port_node = EngineDocSet(backend="rows", device="cpu")
    oracle = RefEngineDocSet(backend="rows", ingest_mode="locked")
    if direction == "ref_server":
        server = ref_tcp.TcpSyncServer(ref_node, wire=wire).start()
        client = tcp.TcpSyncClient(port_node, server.host, server.port,
                                   wire=wire).start()
    else:
        server = tcp.TcpSyncServer(port_node, wire=wire).start()
        client = ref_tcp.TcpSyncClient(ref_node, server.host, server.port,
                                       wire=wire).start()
    try:
        stream = [(d, c) for d, chs in hist.items() for c in chs]
        random.Random(seed).shuffle(stream)
        by_doc = {}
        for d, c in stream:
            by_doc.setdefault(d, []).append(c)
        for d in by_doc:                       # causal order per doc
            by_doc[d].sort(key=lambda c: hist[d].index(c))
        order = []
        rng = random.Random(seed + 1)
        while any(by_doc.values()):
            d = rng.choice([d for d, cs in by_doc.items() if cs])
            order.append((d, by_doc[d].pop(0)))
        for d, c in order:
            oracle.apply_changes(d, [c])
            if int(c.actor[-1]) % 2 == 0:
                ref_node.apply_changes(d, [c])
            else:
                port_node.apply_changes(d, [Change.from_dict(c.to_dict())])
        want = oracle.hashes()

        def same(h):
            return set(h) == set(want) and all(
                np.uint32(h[d]) == np.uint32(want[d]) for d in want)
        _wait(lambda: same(ref_node.hashes()) and same(port_node.hashes()))
        return {name: (node.hashes(),
                       {d: node.clock_of(d) for d in sorted(want)},
                       {d: node.materialize(d) for d in sorted(want)})
                for name, node in (("oracle", oracle), ("ref", ref_node),
                                   ("port", port_node))}
    finally:
        client.close()
        server.close()
        for n in (ref_node, port_node, oracle):
            n.close()


def _as_uint32(state):
    hashes, clocks, docs = state
    return ({d: int(np.uint32(h)) for d, h in hashes.items()}, clocks, docs)


@pytest.mark.parametrize("direction", ["ref_server", "port_server"])
@pytest.mark.parametrize("wire", ["json", "columnar"])
@pytest.mark.parametrize("seed", [11, 12])
def test_reference_and_port_nodes_converge_over_tcp(seed, wire, direction):
    got = run_pair(seed, wire, direction)
    want = _as_uint32(got["oracle"])
    assert _as_uint32(got["ref"]) == want
    assert _as_uint32(got["port"]) == want
    assert _tcp_threads() == []


# ---------------------------------------------------------------------------
# framing, one port for both wires, threads


def test_framing_is_byte_equal_to_the_reference():
    rng = random.Random(5)
    for _ in range(50):
        msg = {"docId": f"d{rng.randrange(9)}",
               "clock": {f"A{k}": rng.randrange(99) for k in range(3)}}
        if rng.random() < 0.5:
            msg["changes"] = [{"actor": "A", "seq": 1, "deps": {},
                               "ops": [{"action": "set", "key": "k",
                                        "value": rng.random()}]}]
        else:
            msg["frame"] = bytes(rng.randrange(256) for _ in range(40))
        payload = tcp.encode_msg(dict(msg))
        assert payload == ref_tcp.encode_msg(dict(msg))
        assert tcp.decode_msg(payload) == ref_tcp.decode_msg(payload) == msg


def test_port_server_takes_json_and_amwm_reference_clients_on_one_port():
    node = EngineDocSet(backend="rows", device="cpu")
    json_side = RefEngineDocSet(backend="rows")
    amwm_side = RefEngineDocSet(backend="rows")
    server = tcp.TcpSyncServer(node, wire="columnar").start()
    clients = [ref_tcp.TcpSyncClient(json_side, server.host, server.port,
                                     wire="json").start(),
               ref_tcp.TcpSyncClient(amwm_side, server.host, server.port,
                                     wire="columnar").start()]
    try:
        hist = histories(3, n_docs=2)
        for c in hist["doc0"]:
            json_side.apply_changes("doc0", [c])
        for c in hist["doc1"]:
            amwm_side.apply_changes("doc1", [c])
        assert _wait(lambda: node.hashes() == json_side.hashes()
                     == amwm_side.hashes() and len(node.hashes()) == 2)
        assert node.materialize("doc0") == json_side.materialize("doc0")
        assert node.materialize("doc1") == amwm_side.materialize("doc1")
    finally:
        for c in clients:
            c.close()
        server.close()
        for n in (node, json_side, amwm_side):
            n.close()
    assert _tcp_threads() == []


def test_threads_are_named_and_joined_by_close():
    a = EngineDocSet(backend="rows", device="cpu")
    b = EngineDocSet(backend="rows", device="cpu")
    server = tcp.TcpSyncServer(a).start()
    client = tcp.TcpSyncClient(b, server.host, server.port).start()
    sup = tcp.SupervisedTcpClient(b, server.host, server.port,
                                  backoff_s=0.05).start()
    try:
        assert _wait(lambda: sup.connection is not None
                     and len(server.peers) == 2)
        names = _tcp_threads()
        assert f"amtpu-torch-tcp-accept-{server.port}" in names
        assert f"amtpu-torch-tcp-supervisor-{server.port}" in names
        assert sum(n.startswith("amtpu-torch-tcp-read-")
                   for n in names) == 4
        assert all(t.daemon for t in threading.enumerate()
                   if t.name.startswith("amtpu-torch-tcp"))
    finally:
        sup.close()
        client.close()
        server.close()
        a.close()
        b.close()
    assert _tcp_threads() == []


def test_multiple_docs_multiplexed_named_actors():
    """test_tcp_sync.py::test_multiple_docs_multiplexed with each
    document's actor named, port server to port client and reference
    server to port client."""
    from automerge_tpu_torch import api
    from automerge_tpu_torch.sync.docset import DocSet
    for ref_server in (False, True):
        if ref_server:
            ds_server = ref_am.DocSet()
            server = ref_tcp.TcpSyncServer(ds_server).start()
            am = ref_am
            kw = {}
        else:
            ds_server = DocSet(device="cpu")
            server = tcp.TcpSyncServer(ds_server).start()
            am, kw = api, {"device": "cpu"}
        ds_client = DocSet(device="cpu")
        client = tcp.TcpSyncClient(ds_client, server.host,
                                   server.port).start()
        try:
            for i in range(5):
                ds_server.set_doc(f"doc{i}", am.change(
                    am.init(f"w{i}", **kw),
                    lambda d, i=i: d.__setitem__("n", i)))
            assert _wait(lambda: all(
                ds_client.get_doc(f"doc{i}") == {"n": i} for i in range(5)))
            assert all(api.save(ds_client.get_doc(f"doc{i}"))
                       == am.save(ds_server.get_doc(f"doc{i}"))
                       for i in range(5))
        finally:
            client.close()
            server.close()
    assert _tcp_threads() == []
