"""The port's epoch-batched ingestion (`automerge_tpu_torch.sync.epochs` and
the service's epoch mode) held to the reference's, on the CPU.

The deterministic cases of the reference's `tests/test_epoch_ingest.py`
run on both packages through `torch_twin_helpers.run_twin`. Its cases that
wait on a clock, sleep, or need the sharded service are replaced below by
cases that wait only on events and joins: concurrent writers, the seal's
atomic cut, reads during a flush, the gossip backstop, and the flusher's
name and lifecycle. Every service is closed and every flusher joined at
teardown. Tolerance: exact.
"""

import threading

import pytest

from torch_twin_helpers import collect, hygiene_teardown, run_twin

from automerge_tpu.core.change import Change as RefChange, Op as RefOp
from automerge_tpu.native.wire import changes_to_columns as ref_columns
from automerge_tpu.sync import epochs as ref_epochs
from automerge_tpu.sync.service import EngineDocSet as RefEngineDocSet
from automerge_tpu.utils import metrics as ref_metrics

from automerge_tpu_torch.core.change import Change, Op
from automerge_tpu_torch.core.ids import ROOT_ID
from automerge_tpu_torch.native.wire import changes_to_columns
from automerge_tpu_torch.sync import epochs
from automerge_tpu_torch.sync.service import EngineDocSet
from automerge_tpu_torch.utils import metrics

CLOCKED = "waits on the wall clock or sleeps; replaced below by a case " \
          "that waits on events and joins"

CASES = collect("test_epoch_ingest", exclude={
    "test_concurrent_writers_group_commit_and_converge": CLOCKED,
    "test_abandoned_async_handle_still_gossips": CLOCKED,
    "test_refill_probe_waits_on_growth_never_on_a_clock": CLOCKED,
    "test_seal_is_one_atomic_cut_across_stripes": CLOCKED,
    "test_reads_mid_flush_equal_quiesced_reread": CLOCKED,
    "test_flusher_exits_after_idle_linger_and_respawns": CLOCKED,
    "test_flusher_thread_named_and_joined_on_close":
        "asserts the reference's thread name (amtpu-flusher-<k>); "
        "test_flusher_named_and_joined_on_close below is the port's",
})


@pytest.fixture(autouse=True)
def _hygiene():
    yield
    hygiene_teardown()


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reference_case_on_both_packages(case, tmp_path, monkeypatch):
    run_twin(case, tmp_path, monkeypatch)


class Pkg:
    """One package's service class, change types and metrics."""

    def __init__(self, ref: bool):
        self.ref = ref
        self.Change, self.Op = (RefChange, RefOp) if ref else (Change, Op)
        self.columns = ref_columns if ref else changes_to_columns
        self.metrics = ref_metrics if ref else metrics
        self.epochs = ref_epochs if ref else epochs

    def service(self, **kw):
        if self.ref:
            return RefEngineDocSet(backend="rows", **kw)
        return EngineDocSet(backend="rows", device="cpu", **kw)

    def change(self, actor, seq, key="k", value=0):
        return self.Change(actor=actor, seq=seq, deps={},
                           ops=[self.Op("set", ROOT_ID, key=key,
                                        value=value)])

    def cols(self, actor, seq, key="k", value=0):
        return self.columns([self.change(actor, seq, key, value)])


PKGS = [pytest.param(True, id="ref"), pytest.param(False, id="port")]


def test_concurrent_writers_group_commit_and_converge():
    """Four writer threads through one epoch-mode service on each
    package: every op is buffered, rounds coalesce (fewer than ingresses),
    and each doc converges to the reference's locked-mode hashes."""
    n_writers, n_ops = 4, 40
    want = RefEngineDocSet(backend="rows", ingest_mode="locked")
    for w in range(n_writers):
        want.apply_changes(f"w{w}", [Pkg(True).change(f"W{w}", s, value=s)
                                     for s in range(1, n_ops + 2)])
    for ref in (True, False):
        pkg = Pkg(ref)
        pkg.metrics.reset()
        e = pkg.service()
        for w in range(n_writers):
            e.apply_changes(f"w{w}", [pkg.change(f"W{w}", 1, value=1)])
        m0 = pkg.metrics.snapshot()
        errs = []

        def writer(w):
            try:
                for s in range(2, n_ops + 2):
                    e.apply_columns(f"w{w}", pkg.cols(f"W{w}", s, value=s))
            except BaseException as exc:   # noqa: BLE001 - reported below
                errs.append(exc)

        ts = [threading.Thread(target=writer, args=(w,),
                               name=f"t-epoch-w{w}")
              for w in range(n_writers)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not errs
        m1 = pkg.metrics.snapshot()
        total = n_writers * n_ops
        rounds = (m1.get("sync_rounds_flushed", 0)
                  - m0.get("sync_rounds_flushed", 0))
        assert 0 < rounds <= total
        assert (m1.get("sync_ops_buffered", 0)
                - m0.get("sync_ops_buffered", 0)) == total
        assert e.hashes() == want.hashes()
        for w in range(n_writers):
            assert e.clock_of(f"w{w}") == {f"W{w}": n_ops + 1}
        e.close()
    want.close()


@pytest.mark.parametrize("ref", PKGS)
def test_seal_is_one_atomic_cut_across_stripes(ref):
    """seal() holds every stripe lock across the swap: while it waits for
    a later stripe's lock, an earlier stripe still holds its entry."""
    buf = Pkg(ref).epochs.EpochIngestBuffer()
    docs = {}
    for i in range(64):
        d = f"doc{i}"
        docs.setdefault(buf._stripes.index(buf._stripe_of(d)), d)
        if len(docs) >= 2:
            break
    (k_lo, d_lo), (k_hi, d_hi) = sorted(docs.items())[:2]
    buf.append(d_lo, None, None)
    buf.append(d_hi, None, None)

    class Gate:
        """The later stripe's lock: says when the seal reaches it."""

        def __init__(self, lock):
            self.lock = lock
            self.reached = threading.Event()

        def acquire(self, *a, **k):
            self.reached.set()
            return self.lock.acquire(*a, **k)

        def release(self):
            self.lock.release()

    gate = Gate(buf._stripes[k_hi].lock)
    buf._stripes[k_hi].lock = gate
    sealed = []
    with gate.lock:                       # the cut blocks at a later stripe
        t = threading.Thread(target=lambda: sealed.append(buf.seal()),
                             name="t-seal")
        t.start()
        assert gate.reached.wait(10.0)
        assert len(buf._stripes[k_lo].entries) == 1   # nothing swapped
    t.join()
    assert {e.doc_id for e in sealed[0]} == {d_lo, d_hi}
    assert buf.empty() and not buf.has(d_lo) and not buf.has(d_hi)


@pytest.mark.parametrize("ref", PKGS)
def test_refill_probe_never_consumes(ref):
    """The flusher's pre-seal refill probe returns on an empty or a
    static buffer and never seals what it observes."""
    pkg = Pkg(ref)
    e = pkg.service()
    for _ in range(50):
        e._refill_probe()
    assert e._epoch.count() == 0
    e._epoch.append("d", pkg.cols("A", 1, value=1), None)
    e._refill_probe()
    assert e._epoch.count() == 1
    e.close()
    assert e.clock_of("d") == {"A": 1}    # close flushed the entry


def test_reads_during_a_flush_equal_a_quiesced_reread():
    """A read racing a flush that is held open sees the state before or
    after it, never a torn one, and the final reads agree across the
    packages."""
    out = []
    for ref in (True, False):
        pkg = Pkg(ref)
        e = pkg.service()
        e.apply_changes("d", [pkg.change("A", 1, value=1)])
        rset = e._resident
        real = rset.apply_round_frames
        entered, release = threading.Event(), threading.Event()

        def held(*a, **k):
            entered.set()
            assert release.wait(30.0)
            return real(*a, **k)

        rset.apply_round_frames = held
        writer = threading.Thread(
            target=lambda: e.apply_columns("d", pkg.cols("A", 2, value=2)),
            name="t-held-writer")
        writer.start()
        assert entered.wait(30.0)
        seen = []
        reader = threading.Thread(
            target=lambda: seen.append(e.clock_of("d")), name="t-reader")
        reader.start()
        release.set()
        writer.join()
        reader.join()
        rset.apply_round_frames = real
        assert seen[0].get("A") in (1, 2)
        assert e.clock_of("d") == {"A": 2}
        assert len(e.missing_changes("d", {})) == 2
        out.append(e.hashes())
        e.close()
    assert out[0] == out[1]


@pytest.mark.parametrize("ref", PKGS)
def test_abandoned_async_handle_still_gossips(ref):
    """The flusher's gossip backstop: an async ingress whose handle is
    never waited still reaches the handlers, and a handler that applies
    again on the drain thread takes the inline path."""
    pkg = Pkg(ref)
    e = pkg.service()
    e.apply_changes("d", [pkg.change("A", 1)])
    e.apply_changes("other", [pkg.change("B", 1)])
    done = threading.Event()
    seen = []

    def handler(doc_id, handle):
        seen.append(doc_id)
        if doc_id == "d" and seen.count("d") == 1:
            e.apply_columns("other", pkg.cols("B", 2, value=2))
            done.set()

    e.handlers.append(handler)
    e.apply_columns_async("d", pkg.cols("A", 2, value=2))   # abandoned
    assert done.wait(30.0), "abandoned ingress never gossiped"
    assert e.clock_of("other") == {"B": 2}
    assert e.clock_of("d") == {"A": 2}
    e.close()


def test_flusher_named_and_joined_on_close():
    """The port's flusher is `amtpu-torch-flusher-<shard>` (so no thread
    check of the reference's names can see it), spawns on the first
    ingress, and close() joins it."""
    pkg = Pkg(False)
    e = pkg.service()
    e.apply_changes("d", [pkg.change("A", 1)])
    t = e._flusher._thread
    assert t is not None and t.name == "amtpu-torch-flusher-0"
    e._shard = "3"
    assert e._flusher._name_fn() == "amtpu-torch-flusher-3"
    e.close()
    assert not t.is_alive()


def test_sharded_flushers_named_per_shard_and_joined_on_close():
    """A sharded node's shards each spawn `amtpu-torch-flusher-<k>` on
    their first ingress; the node's close() joins them all."""
    from automerge_tpu_torch.sync import ShardedEngineDocSet
    pkg = Pkg(False)
    s = ShardedEngineDocSet(n_shards=2, devices=["cpu"])
    docs = ["doc-a", "doc-b", "doc-c", "doc-d"]
    for d in docs:
        s.apply_changes(d, [pkg.change("A", 1)])
    threads = [sh._flusher._thread for sh in s.shards
               if sh._flusher._thread is not None]
    assert sorted({t.name for t in threads}) == sorted(
        f"amtpu-torch-flusher-{k}" for k, sh in enumerate(s.shards)
        if sh.doc_ids)
    s.close()
    assert not any(t.is_alive() for t in threads)


def test_flusher_exits_after_idle_linger_and_respawns():
    """An idle flusher exits after its linger and a later ingress spawns
    a fresh one (the join is the wait)."""
    pkg = Pkg(False)
    e = pkg.service()
    e._flusher._linger_s = 0.0
    e.apply_changes("d", [pkg.change("A", 1)])
    t1 = e._flusher._thread
    assert t1 is not None
    t1.join()
    assert e._flusher._thread is None
    e.apply_columns("d", pkg.cols("A", 2, value=2))   # respawns
    assert e.clock_of("d") == {"A": 2}
    e.close()


def test_linger_is_read_from_the_environment(monkeypatch):
    monkeypatch.setenv("AMTPU_FLUSHER_LINGER_S", "0.25")
    epochs._reload_for_tests()
    try:
        assert epochs.Flusher(lambda: None, lambda: "x")._linger_s == 0.25
    finally:
        monkeypatch.undo()
        epochs._reload_for_tests()
    assert epochs.LINGER_S == 2.0
