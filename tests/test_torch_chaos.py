"""The port's chaos hooks (`automerge_tpu_torch/utils/chaos.py`), the
transport ones included (`drop_frame`, `conn_kill`, `peer_hang`), and the
reconnect supervisor (`sync/tcp.SupervisedTcpClient`), held to the
reference's on the CPU.

Through `torch_twin_helpers.run_twin`, the cases of the reference's
`tests/test_chaos.py` and the chaos and supervisor cases of
`tests/test_remediation.py` run on both packages. Left out, each with its
reason: the fleet-doctor and remediation-engine cases (they need
`automerge_tpu.perf`, which is not ported); `test_lock_hold_auto_holder_and_close`
(it asserts the reference's thread name; the port's thread is
`amtpu-torch-chaos-lockhold`, and `test_lock_hold_holder_named_and_joined`
below is the port's); `test_supervisor_idle_kick_heals_peer_hang` (it
writes on a wall-clock deadline; `test_peer_hang_idle_kick_heals` below
waits on the supervisor's generation instead); and
`test_server_prunes_dead_peers_on_reconnect` (it fails in some runs of
the reference). Chaos switches are set only through `monkeypatch` and
re-read at teardown. Tolerance: exact.
"""

import threading
import time

import pytest

from torch_twin_helpers import collect, hygiene_teardown, run_twin

from automerge_tpu_torch import api
from automerge_tpu_torch.sync.docset import DocSet
from automerge_tpu_torch.sync.service import EngineDocSet
from automerge_tpu_torch.sync.tcp import (SupervisedTcpClient, TcpSyncServer,
                                          sync_lock)
from automerge_tpu_torch.utils import chaos, metrics

PERF = "needs a perf plane (automerge_tpu/perf), which is not ported"
PERF_CASES = (
    "test_guardrails_cooldown_blocks_repeat",
    "test_guardrails_budget_window_exhaustion",
    "test_guardrails_per_action_override",
    "test_engine_quarantines_flagged_straggler",
    "test_engine_recovery_episode_measures_mttr",
    "test_engine_quorum_refuses_majority_quarantine",
    "test_engine_dry_run_executes_nothing",
    "test_engine_dry_run_env_knob",
    "test_engine_reconnect_action_for_stale_supervised_node",
    "test_engine_tick_costs_bounded_and_recorded",
    "test_ladder_escalates_delay_then_shed_and_relaxes_with_hysteresis",
    "test_ladder_no_data_never_moves",
    "test_engine_drives_ladder_through_guardrails",
    "test_rehome_children_moves_cover_and_backfills",
    "test_fleet_green_predicate",
    "test_collector_quarantine_excludes_from_rollup_and_scoring",
    "test_collector_remove_peer_frees_label_for_reconnect",
    "test_slo_on_transition_hook_fires",
    "test_governor_force_discloses_mode_flip_while_shedding",
)

CASES = (
    collect("test_chaos", exclude={
        "test_lock_hold_auto_holder_and_close":
            "asserts the reference's thread name; "
            "test_lock_hold_holder_named_and_joined below is the port's",
        "test_straggler_and_doctor_attribution": PERF,
    })
    + collect("test_remediation", exclude=dict(
        {name: PERF for name in PERF_CASES},
        test_supervisor_idle_kick_heals_peer_hang=(
            "writes on a wall-clock deadline; "
            "test_peer_hang_idle_kick_heals below waits on the supervisor"),
        test_server_prunes_dead_peers_on_reconnect=(
            "fails in some runs of the reference (timing)"),
    ))
)


@pytest.fixture(autouse=True)
def _hygiene():
    yield
    hygiene_teardown()


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reference_case_on_both_packages(case, tmp_path, monkeypatch):
    run_twin(case, tmp_path, monkeypatch)


def _wait(predicate, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return False


def test_lock_hold_holder_named_and_joined(monkeypatch):
    metrics.reset()
    monkeypatch.setenv("AMTPU_CHAOS_LOCK_HOLD_S", "0.04")
    monkeypatch.setenv("AMTPU_CHAOS_LOCK_HOLD_EVERY_S", "0.02")
    chaos.reload()
    svc = EngineDocSet(backend="rows", device="cpu")
    try:
        holder_thread = svc._chaos_holder._thread
        assert holder_thread.name == "amtpu-torch-chaos-lockhold"
        assert _wait(lambda: metrics.snapshot().get(
            "obs_chaos_injected{fault=lock_hold}", 0) >= 2)
    finally:
        svc.close()
    assert not holder_thread.is_alive()
    assert metrics.snapshot().get(
        "sync_lock_hold_s{lock=service}_max", 0) >= 0.03


def test_peer_hang_idle_kick_heals(monkeypatch):
    """A client whose reader swallows every message for 0.6 s: the
    supervisor's idle detector (0.3 s) redials, the window closes, and
    the replacement link backfills what the hung one swallowed."""
    monkeypatch.setenv("AMTPU_CHAOS_PEER_HANG_S", "0.6")
    monkeypatch.setenv("AMTPU_CHAOS_NODE", "cl")
    chaos.reload()
    metrics.reset()
    ds_server, ds_client = DocSet(device="cpu"), DocSet(device="cpu")
    ds_client._chaos_node = "cl"
    server = TcpSyncServer(ds_server).start()
    sup = SupervisedTcpClient(ds_client, server.host, server.port,
                              backoff_s=0.05, idle_reconnect_s=0.3,
                              node="cl").start()
    try:
        assert _wait(lambda: sup.connection is not None)
        doc = api.init("S", device="cpu")
        for k in range(4):
            doc = api.change(doc, lambda d, k=k: d.__setitem__(f"k{k}", k))
            with sync_lock(ds_server):
                ds_server.set_doc("d", doc)
        assert _wait(lambda: sup.generation >= 2)
        assert _wait(lambda: ds_client.get_doc("d") is not None
                     and ds_client.get_doc("d") == ds_server.get_doc("d"))
        snap = metrics.snapshot()
        assert snap.get("obs_chaos_injected{fault=peer_hang}", 0) >= 1
        assert snap.get("sync_reconnect_idle_kicks", 0) >= 1
    finally:
        sup.close()
        server.close()
    assert not any(t.name.startswith("amtpu-torch-tcp")
                   for t in threading.enumerate())
