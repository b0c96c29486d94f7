"""Reference-style test bodies that tests/test_torch_tcp.py runs on both
packages through `torch_twin_helpers` (not a pytest module): written
against `automerge_tpu`, rebound to the port on the port's run."""

import threading
import time

import automerge_tpu as am
from automerge_tpu import DocSet
from automerge_tpu.sync.tcp import TcpSyncClient, TcpSyncServer, sync_lock


def wait_until(predicate, timeout=10.0, interval=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


def bidirectional_edits_after_the_server_change_arrives():
    """test_tcp_sync.py::test_bidirectional_concurrent_edits_converge with
    the client's edit made once the server's change has reached the
    client (a DocSet handler sets an event), so every document the case
    records is the same whatever the threads' scheduling."""
    ds_server, ds_client = DocSet(), DocSet()
    server = TcpSyncServer(ds_server).start()
    client = TcpSyncClient(ds_client, server.host, server.port).start()
    try:
        base = am.change(am.init("base"), lambda d: d.__setitem__("v", 0))
        ds_server.set_doc("doc1", am.merge(am.init("S"), base))
        assert wait_until(lambda: ds_client.get_doc("doc1") is not None)

        arrived = threading.Event()

        def on_doc(doc_id, doc):
            if doc_id == "doc1" and "server" in doc:
                arrived.set()
        ds_client.register_handler(on_doc)
        with sync_lock(ds_server):
            ds_server.set_doc("doc1", am.change(
                ds_server.get_doc("doc1"),
                lambda d: d.__setitem__("server", 1)))
        assert arrived.wait(10), "the server's change never arrived"
        ds_client.unregister_handler(on_doc)
        with sync_lock(ds_client):
            ds_client.set_doc("doc1", am.change(
                ds_client.get_doc("doc1"),
                lambda d: d.__setitem__("client", 2)))

        expected = {"v": 0, "server": 1, "client": 2}
        assert wait_until(lambda: ds_server.get_doc("doc1") == expected
                          and ds_client.get_doc("doc1") == expected), (
            am.inspect(ds_server.get_doc("doc1")),
            am.inspect(ds_client.get_doc("doc1")))
    finally:
        client.close()
        server.close()
