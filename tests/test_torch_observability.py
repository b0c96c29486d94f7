"""The port's observability planes held to the reference's, on the CPU: the
op-lifecycle plane (`utils/oplag.py`), the trace plane (`utils/tracer.py`),
the flight recorder (`utils/flightrec.py`), spans and the watchdog of
`utils/metrics.py`, `utils/lockprof.py`, the service hooks of
`utils/chaos.py`, the phases of `utils/perfscope.py`, and the protocol
headers of `sync/frames.py`.

The cases of the reference's `tests/test_oplag.py`, `tests/test_tracer.py`
and `tests/test_flightrec.py` that need no socket, no sharded service
and no wall clock run on both packages through
`torch_twin_helpers.run_twin`; the cases below replace the clocked ones
with waits on events and joins, and hold the wire headers byte-equal
across the packages. A test that installs the flight recorder's hooks
uninstalls them, dumps go to `tmp_path`, and the metrics watchdog's
thread (`amtpu-torch-watchdog`) is joined at teardown. Tolerance: exact.
"""

import json
import threading

import pytest
import torch

from torch_twin_helpers import collect, hygiene_teardown, run_twin

from automerge_tpu.core.change import Change as RefChange, Op as RefOp
from automerge_tpu.sync import frames as ref_frames
from automerge_tpu.utils import flightrec as ref_flightrec
from automerge_tpu.utils import metrics as ref_metrics
from automerge_tpu.utils import oplag as ref_oplag
from automerge_tpu.utils import tracer as ref_tracer

import automerge_tpu_torch
from automerge_tpu_torch.core.change import Change, Op
from automerge_tpu_torch.core.ids import ROOT_ID
from automerge_tpu_torch.core.opset import OpSet
from automerge_tpu_torch.sync import frames
from automerge_tpu_torch.sync.service import EngineDocSet
from automerge_tpu_torch.utils import (chaos, flightrec, lockprof, metrics,
                                       oplag, perfscope, tracer)

CLOCKED = "waits on the wall clock or sleeps; replaced below"

CASES = (
    collect("test_oplag", exclude={
        "test_stale_token_retired_by_ttl": CLOCKED,
        "test_causal_queue_stage_via_opset": CLOCKED,
    })
    + collect("test_tracer", exclude={
        "test_tcp_stitch_one_trace_covers_both_processes":
            "a race in the reference (the trace can complete on its origin "
            "before the send path pops it); test_tcp_stitch_waits_on_the_"
            "hand_off below is the port's",
    })
    + collect("test_flightrec", exclude={
        "test_excepthook_dump": CLOCKED,
    })
)


@pytest.fixture(autouse=True)
def _hygiene():
    metrics.reset()
    flightrec.reset()
    yield
    metrics.reset()
    flightrec.reset()
    oplag.set_sample_rate(None)
    hygiene_teardown()


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reference_case_on_both_packages(case, tmp_path, monkeypatch):
    run_twin(case, tmp_path, monkeypatch)


def _change(ref, actor="X", seq=1, key="k", value=1):
    ch, op = (RefChange, RefOp) if ref else (Change, Op)
    return ch(actor=actor, seq=seq, deps={},
              ops=[op("set", ROOT_ID, key=key, value=value)])


# ---------------------------------------------------------------------------
# the reference's clocked cases, without the clock


@pytest.mark.parametrize("ref", [True, False], ids=["ref", "port"])
def test_stale_token_retired_by_ttl(monkeypatch, ref):
    mod = ref_oplag if ref else oplag
    mod.set_sample_rate(1)
    try:
        tok = mod.admit("doc-t")
        mod.flushed(tok, flush_start=tok.t0, flush_s=0.001)
        assert mod.wire_header("doc-t") is not None
        monkeypatch.setattr(mod, "WIRE_TTL_S", -1.0)   # every token stale
        assert mod.wire_header("doc-t") is None
    finally:
        mod.set_sample_rate(None)


def test_causal_queue_stage_via_opset():
    """A change parked causally-unready records its dependency wait once
    its dependency arrives (the OpSet's oplag hand-offs)."""
    oplag.set_sample_rate(1)
    opset = OpSet.init(device="cpu")
    opset, _ = opset.add_changes([_change(False, seq=2, value=2)])
    assert len(opset.queue) == 1
    opset, _ = opset.add_changes([_change(False, seq=1, value=1)])
    assert not opset.queue
    assert metrics.snapshot()["sync_op_lag_s{stage=causal_queue}_count"] \
        == 1


def test_excepthook_dump(tmp_path, monkeypatch):
    """install() dumps on an unhandled thread exception (the hook runs on
    the dying thread, so the dump exists once it is joined), chains to
    the previous hook, and uninstall() restores it."""
    monkeypatch.setenv("AMTPU_FLIGHTREC_DIR", str(tmp_path))
    seen = []
    monkeypatch.setattr(threading, "excepthook", seen.append)
    flightrec.install(signals=False)
    try:
        def boom():
            raise RuntimeError("crash for the recorder")

        t = threading.Thread(target=boom, name="crasher")
        t.start()
        t.join()
        path = flightrec.last_dump()
        assert path.startswith(str(tmp_path))
        assert path.rsplit("/", 1)[1].startswith("amtpu-torch-flightrec-")
        doc = json.load(open(path))
        assert doc["reason"] == "thread-exception"
        assert "crash for the recorder" in doc["extra"]["exception"]
        assert doc["extra"]["thread"] == "crasher"
        assert seen, "previous excepthook was not chained"
    finally:
        flightrec.uninstall()
    assert threading.excepthook == seen.append


def test_flightrec_environment_is_reread(monkeypatch):
    monkeypatch.setenv("AMTPU_FLIGHTREC", "0")
    flightrec._reload_for_tests()
    try:
        flightrec.record("round_flush")
        assert flightrec.events() == [] and not flightrec.enabled()
    finally:
        monkeypatch.undo()
        flightrec._reload_for_tests()
    flightrec.record("round_flush")
    assert len(flightrec.events()) == 1


# ---------------------------------------------------------------------------
# spans, the watchdog, exporters


def _span_shape(mod) -> list:
    mod.reset()
    with mod.trace("sync_round_flush", tags={"round": 1}, shard="0"):
        with mod.trace("rows_round_apply"):
            pass
    mod.add_time("rows_hashes", 0.5)
    mod.bump("sync_rounds_flushed", shard="0")
    spans = [{k: v for k, v in s.items()
              if k not in ("start", "duration_s", "trace_id", "span_id",
                           "parent_span_id", "thread")}
             for s in mod.recent_spans()]
    snap = {k: v for k, v in mod.snapshot().items()
            if not k.endswith("_s")}
    prom = [ln for ln in mod.prometheus().splitlines()
            if "seconds_total" not in ln or ln.startswith("#")]
    return [spans, snap, prom]


def test_spans_and_exporters_match_the_reference():
    assert _span_shape(metrics) == _span_shape(ref_metrics)
    child, parent = metrics.recent_spans()
    assert child["parent_span_id"] == parent["span_id"]
    assert child["trace_id"] == parent["trace_id"]


def test_trace_context_adopted_and_merged():
    metrics.reset()
    with metrics.adopt_context({"tid": "t" * 16, "sid": "s" * 8}):
        assert metrics.current_context() == {"tid": "t" * 16,
                                             "sid": "s" * 8}
        with metrics.trace("sync_msg_serve"):
            ctx = metrics.current_context()
    assert ctx["tid"] == "t" * 16
    (span,) = metrics.recent_spans()
    assert span["parent_span_id"] == "s" * 8
    merged = metrics.merge_timeline({"a": metrics.recent_spans(),
                                     "b": metrics.recent_spans()})
    assert [s["replica"] for s in merged] == ["a"]


def test_watchdog_fires_once_names_the_region_and_its_thread_is_joined(
        tmp_path, monkeypatch):
    """The watchdog fires while its region is still running (the region
    waits on the fire itself), records the span stacks and the service
    lock's holder, dumps the flight recorder, and its checker thread is
    `amtpu-torch-watchdog`."""
    monkeypatch.setenv("AMTPU_FLIGHTREC_DIR", str(tmp_path))
    fired = threading.Event()

    class Log:
        def warning(self, *a):
            fired.set()

    held = lockprof.InstrumentedRLock("service")
    with held, metrics.watchdog("sync_hashes", budget_s=0.001,
                                logger=Log()):
        names = {t.name for t in threading.enumerate()}
        assert fired.wait(30.0)
    assert "amtpu-torch-watchdog" in names
    # the checker exits after its idle linger, the fire (and its dump)
    # done
    metrics._monitor.thread().join()
    (ev,) = metrics.watchdog_events()
    assert ev["name"] == "sync_hashes"
    assert any("sync_hashes" in s for st in ev["spans"].values()
               for s in st)
    assert ev["lock_holders"]["service"]["thread"] == \
        threading.current_thread().name
    assert metrics.snapshot()["obs_watchdog_fired{name=sync_hashes}"] == 1
    assert flightrec.last_dump().startswith(str(tmp_path))


def test_spans_show_in_a_torch_profiler_trace():
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with metrics.trace("rows_hashes"):
            torch.ones(4).sum()
    assert "rows_hashes" in {e.key for e in prof.key_averages()}
    assert metrics._device_annotation("rows_hashes") is None   # unprofiled


# ---------------------------------------------------------------------------
# lockprof, chaos, perfscope, the wire headers


def _lock_counts(lp, mets) -> dict:
    mets.reset()
    lk = lp.InstrumentedRLock("service")
    cv = lp.InstrumentedCondition("cv", lk)
    assert lp.holders_snapshot().get("service") is None
    with lk:
        with lk:
            h = lp.holders_snapshot()["service"]
            assert h["thread"] == threading.current_thread().name
            assert "test_torch_observability.py" in h["site"]
        assert lk.locked()
    assert not lk.locked()
    with cv:
        assert not cv.wait(timeout=0)
    return {k: v for k, v in mets.snapshot().items()
            if k.endswith("_count") and "lock" in k}


def test_instrumented_rlock_reenters_and_reports_its_holder():
    from automerge_tpu.utils import lockprof as ref_lockprof
    got = _lock_counts(lockprof, metrics)
    assert got["sync_lock_wait_s{lock=cv}_count"] == 1
    assert got == _lock_counts(ref_lockprof, ref_metrics)


def test_chaos_hooks_inert_unset():
    chaos.reload()
    assert not chaos.enabled()
    assert chaos.maybe_lock_holder(threading.Lock()) is None
    assert chaos.tenant_storm(None, "tenant/a/1") == 0
    assert not chaos.stall_doc(None, "d") and not chaos.sub_flap(None, "d")
    chaos.slow_apply()
    assert not any(k.startswith("obs_chaos") for k in metrics.snapshot())


def test_chaos_lock_holder_thread_is_named_and_joined(monkeypatch):
    """AMTPU_CHAOS_LOCK_HOLD_S starts a holder on a new service's lock;
    close() stops and joins it."""
    monkeypatch.setenv("AMTPU_CHAOS_LOCK_HOLD_S", "0.001")
    monkeypatch.setenv("AMTPU_CHAOS_LOCK_HOLD_EVERY_S", "0.001")
    chaos.reload()
    try:
        svc = EngineDocSet(backend="rows", device="cpu")
        holder = svc._chaos_holder
        assert holder._thread.name == "amtpu-torch-chaos-lockhold"
        svc.apply_changes("d", [_change(False)])
        svc.close()
        assert not holder._thread.is_alive()
    finally:
        monkeypatch.undo()
        chaos.reload()


def test_chaos_slow_apply_is_disclosed(monkeypatch):
    monkeypatch.setenv("AMTPU_CHAOS_SLOW_APPLY_S", "0.001")
    chaos.reload()
    try:
        svc = EngineDocSet(backend="rows", device="cpu",
                           ingest_mode="locked")
        svc.apply_changes("d", [_change(False)])
        svc.close()
        assert metrics.snapshot()[
            "obs_chaos_injected{fault=slow_apply}"] == 1
        assert any(e["kind"] == "chaos_inject"
                   for e in flightrec.events())
    finally:
        monkeypatch.undo()
        chaos.reload()


def test_service_flush_records_phases_and_spans():
    perfscope.reset()
    svc = EngineDocSet(backend="rows", device="cpu", ingest_mode="locked")
    svc.apply_changes("d", [_change(False)])
    frames.decode_frame(frames.encode_frame([_change(False, seq=2)]))
    svc.hashes()
    svc.close()
    totals = perfscope.phase_totals()
    assert {"sync_wire", "readback"} <= set(totals)
    snap = metrics.snapshot()
    assert snap["perf"]["phases"]["sync_wire"]["count"] == 2
    assert snap["sync_round_flush_count"] == 1
    assert snap["rows_round_apply_count"] == 1
    assert snap["sync_hashes_count"] == 1
    kinds = [e["kind"] for e in flightrec.events()]
    assert "round_flush" in kinds and "dispatch_round" in kinds \
        and "hash_read" in kinds
    metrics.reset()
    assert perfscope.phase_totals() == {}


@pytest.mark.parametrize("msg", [
    {"metrics": "pull"}, {"audit": "state"}, {"sub": {"add": ["d"]}},
    {"docId": "d", "snap": {"b64": ""}}, {"docId": "d", "frame": "AA=="},
    {"docId": "d", "changes": []}, {"docId": "d", "clock": {}}])
def test_message_classes_match_the_reference(msg):
    assert frames.msg_kind(msg) == ref_frames.msg_kind(msg)


def test_wire_headers_are_the_references():
    for name in ("TRACE_KEY", "OPLAG_KEY", "TRACEPLANE_KEY", "SUB_KEY",
                 "SNAP_KEY"):
        assert getattr(frames, name) == getattr(ref_frames, name)
    ctx = {"tid": "ab" * 8, "sid": "cd" * 4}
    assert frames.pack_trace(ctx) == ref_frames.pack_trace(ctx)
    for hdr in (frames.pack_trace(ctx), "", "-x", None, 7, "t-"):
        assert frames.unpack_trace(hdr) == ref_frames.unpack_trace(hdr)


def test_oplag_header_crosses_packages():
    """A sampled op's oplag header made by one package is read by the
    other (the receiver records the wire and peer-apply stages)."""
    for src, dst in ((ref_oplag, oplag), (oplag, ref_oplag)):
        src.set_sample_rate(1)
        try:
            tok = src.admit("doc-x")
            src.flushed(tok, flush_start=tok.t0, flush_s=0.001)
            hdr = src.wire_header("doc-x")
            ctx = dst.wire_receive(hdr)
            assert ctx is not None and ctx[0] == tok.id
        finally:
            src.set_sample_rate(None)
            src.reset()


def test_trace_header_crosses_packages(monkeypatch):
    """A sampled lifecycle trace shipped by a reference sender completes
    on a port receiver as one trace, and the other way round."""
    for src, dst in ((ref_tracer, tracer), (tracer, ref_tracer)):
        src.set_sample_rate(1)
        dst.set_sample_rate(None)
        try:
            tr = src.finalize_begin("A", 1)
            src.finalize_end(tr)
            src.admit("d")
            src.flush_round(["d"], 1, 0.0, 0.0)
            hdr = src.wire_header("d")
            assert hdr
            ctx = dst.wire_receive(json.loads(json.dumps(hdr)), "d")
            dst.remote_admitted(ctx, "d", 0.0, 0.0)
            dst.visible(["d"])
            sec = dst.snapshot_section()
            assert sec is not None
            (node,) = sec["nodes"].values()
            assert node["completed"] == 1 and node["stitched"] == 1
        finally:
            for m in (src, dst):
                m._reload_for_tests()
                m.reset()


def test_package_root_exports():
    assert automerge_tpu_torch.Connection.__module__ == \
        "automerge_tpu_torch.sync.connection"
    assert automerge_tpu_torch.flightrec is flightrec
    assert ref_flightrec is not flightrec


# ---------------------------------------------------------------------------
# the trace plane's stitch over a real socket, waiting on the hand-off


def test_tcp_stitch_waits_on_the_hand_off(monkeypatch):
    """test_tracer.py::test_tcp_stitch_one_trace_covers_both_processes on
    the port, with its race taken out: a sampled change on node A crosses
    a loopback socket and completes as one stitched trace on node B. The
    case waits for the send path to hand the trace off (an event set by
    the sender's `wire_header`) before it reads A's hashes, since a read
    on A can complete the trace at its origin first."""
    import string
    import time

    import numpy as np

    from automerge_tpu_torch.native.wire import changes_to_columns
    from automerge_tpu_torch.sync.tcp import TcpSyncClient, TcpSyncServer

    def cols(actor, seq, key, value):
        return changes_to_columns([Change(
            actor=actor, seq=seq, deps={},
            ops=[Op("set", ROOT_ID, key=key, value=value)])])

    def wait(predicate, timeout=30.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if predicate():
                return True
            time.sleep(0.01)
        return False

    tracer.set_sample_rate(2)
    hot = next(a for a in string.ascii_uppercase if tracer.sampled(a, 1))
    cold = next(a for a in string.ascii_uppercase
                if not tracer.sampled(a, 1))
    handed = threading.Event()
    wire_header = tracer.wire_header

    def spy(doc_id, serialize_s=0.0):
        out = wire_header(doc_id, serialize_s)
        if out and doc_id == "doc1":
            handed.set()
        return out
    monkeypatch.setattr(tracer, "wire_header", spy)
    a = EngineDocSet(backend="rows", device="cpu")
    b = EngineDocSet(backend="rows", device="cpu")
    server = TcpSyncServer(a).start()
    client = TcpSyncClient(b, server.host, server.port).start()
    try:
        a.apply_columns("warm", cols(cold, 1, "w", 0))
        assert wait(lambda: "warm" in a.hashes() and "warm" in b.hashes())
        a.apply_columns("doc1", cols(hot, 1, "x", 1))
        a.apply_columns("doc1", cols(cold, 2, "y", 2))
        assert handed.wait(timeout=30.0)

        def converged():
            ha, hb = a.hashes(), b.hashes()
            return ("doc1" in ha and "doc1" in hb
                    and np.uint32(ha["doc1"]) == np.uint32(hb["doc1"]))
        assert wait(converged)
        assert wait(lambda: tracer.section()["stitched"] >= 1
                    and tracer.section()["inflight"] == 0)
        sec = tracer.section()
        assert sec["sampled"] == 1
        assert sec["handed_off"] >= 1 and sec["received"] >= 1
        t = next(t for t in sec["exemplars"]
                 if t["stitched"] and t["doc"] == "doc1")
        assert t["actor"] == hot
        stages = [s[0] for s in t["spans"]]
        for st in ("finalize", "dispatch", "wire", "remote_admission",
                   "visibility"):
            assert st in stages, (st, stages)
    finally:
        client.close()
        server.close()
        a.close()
        b.close()
