"""The port's sync service (`automerge_tpu_torch.sync.service.
EngineDocSet`, both backends, both ingest modes, `live_views`) held to the
reference's, on the CPU.

Every case of the reference's rows-service and incremental-hash test
modules that needs no socket and no unported module runs twice through `torch_twin_helpers.run_twin`:
on `automerge_tpu`, then rebound to the port (`device="cpu"`). Its own
assertions must hold on the port, every document it makes must match the
reference's, and every `EngineDocSet` it makes must give the reference's
`hashes()`, clocks and missing changes. The docs-major service and the
live views are in `tests/test_torch_service_views.py`. Tolerance: exact.
"""

import random

import pytest

from torch_twin_helpers import (collect, hygiene_teardown, port_apply_batch,
                                run_twin)

from automerge_tpu.core.change import Change as RefChange, Op as RefOp
from automerge_tpu.engine.batchdoc import apply_batch as ref_apply_batch
from automerge_tpu.engine.resident_rows import (
    DeviceDispatchError as RefDispatchError)
from automerge_tpu.native.wire import changes_to_columns as ref_columns
from automerge_tpu.sync.service import EngineDocSet as RefEngineDocSet
from automerge_tpu.utils import metrics as ref_metrics

from automerge_tpu_torch.core.change import Change, Op
from automerge_tpu_torch.core.ids import ROOT_ID
from automerge_tpu_torch.engine import resident_rows
from automerge_tpu_torch.engine.resident_rows import DeviceDispatchError
from automerge_tpu_torch.native.wire import changes_to_columns
from automerge_tpu_torch.sync.service import EngineDocSet

ORACLE = {ref_apply_batch: port_apply_batch}
JIT_FAULT = ("injects its fault through metrics.dispatch_jit, which the "
             "port does not have; test_dispatch_fault_* below inject the "
             "same fault into each package's reconcile")

CASES = (
    collect("test_rows_service", adapters=ORACLE)
    + collect("test_incremental_hashes", exclude={
        "test_clean_fleet_read_zero_reconcile_dispatches":
            "reads the JAX dispatch counters; "
            "test_clean_read_launches_nothing below is the port's",
        "test_dispatch_failure_then_retry_recovers": JIT_FAULT,
        "test_incremental_equals_full_recompute_seeded": JIT_FAULT,
    })
)


@pytest.fixture(autouse=True)
def _hygiene():
    yield
    hygiene_teardown()


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reference_case_on_both_packages(case, tmp_path, monkeypatch):
    run_twin(case, tmp_path, monkeypatch)



# ---------------------------------------------------------------------------
# the reference's fault-injection cases, with the fault injected into each
# package's own reconcile


def _cols(cols_fn, change, op, actor, seq, key, val):
    return cols_fn([change(actor, seq, {},
                           [op("set", ROOT_ID, key=key, value=val)])])


class _Side:
    """One package's service, columns and fault hook."""

    def __init__(self, ref: bool, monkeypatch, **kw):
        self.ref = ref
        self.mp = monkeypatch
        self.svc = (RefEngineDocSet(backend="rows", **kw) if ref
                    else EngineDocSet(backend="rows", device="cpu", **kw))
        self.error = RefDispatchError if ref else DeviceDispatchError

    def cols(self, actor, seq, key, val):
        if self.ref:
            return _cols(ref_columns, RefChange, RefOp, actor, seq, key, val)
        return _cols(changes_to_columns, Change, Op, actor, seq, key, val)

    def arm(self):
        """The next reconcile launch raises (once)."""
        state = {"armed": True}
        if self.ref:
            real = ref_metrics.dispatch_jit

            def flaky(kernel, fn, *a, **kw):
                if state["armed"] and kernel == "reconcile_rows_hash":
                    state["armed"] = False
                    raise RuntimeError("injected device fault")
                return real(kernel, fn, *a, **kw)
            self.mp.setattr(ref_metrics, "dispatch_jit", flaky)
        else:
            real = resident_rows.reconcile_rows_hash

            def flaky(*a, **kw):
                if state["armed"]:
                    state["armed"] = False
                    raise RuntimeError("injected device fault")
                return real(*a, **kw)
            self.mp.setattr(resident_rows, "reconcile_rows_hash", flaky)

    def full(self):
        """A full recompute of the same host rows."""
        r = self.svc._resident
        r._hash_mirror = None
        r._doc_dirty = set(range(len(r.doc_ids)))
        r._hash_handle = None
        r._dirty = True
        r.rows_dev = None
        return self.svc.hashes()


def test_dispatch_fault_then_retry_recovers(monkeypatch):
    out = []
    for ref in (True, False):
        side = _Side(ref, monkeypatch)
        for i in range(40):
            side.svc.apply_columns(f"d{i}", side.cols("A", 1, "k", i))
        side.svc.hashes()
        side.svc.apply_columns("d3", side.cols("A", 2, "k", 77))
        side.arm()
        with pytest.raises(side.error):
            side.svc.hashes()
        h = side.svc.hashes()           # the dirty set survived the fault
        assert h == side.full()
        out.append(h)
        monkeypatch.undo()
        side.svc.close()
    assert out[0] == out[1]


ACTIONS = ("admit", "admit2", "burst", "archive", "compact", "rebuild",
           "fail_read")


def _walk(side: _Side, seed: int, n_steps: int = 9) -> list:
    """The reference's interleaving walk (test_incremental_hashes.py):
    after every step the incremental read equals a full recompute.
    Returns the hashes after each step."""
    choose = random.Random(seed).choice
    svc = side.svc
    docs = [f"d{i}" for i in range(5)]
    seqs = {(d, a): 0 for d in docs for a in ("A", "B")}
    trail = []

    def admit(d, actor):
        seqs[(d, actor)] += 1
        seq = seqs[(d, actor)]
        svc.apply_columns(d, side.cols(actor, seq, f"k{seq % 3}",
                                       seq * 7 + ord(actor)))

    for _ in range(n_steps):
        action = choose(ACTIONS)
        if action == "admit":
            admit(choose(docs), "A")
        elif action == "admit2":
            admit(choose(docs), "B")
        elif action == "burst":
            with svc.batch():
                for d in docs[:choose((1, 2, 3, 4))]:
                    admit(d, "A")
        elif action == "archive":
            svc.archive_logs()
        elif action == "compact":
            svc.flush()
            r = svc._resident
            r.compact({d: dict(r.tables[r.doc_index[d]].clock)
                       for d in r.doc_ids})
        elif action == "rebuild":
            svc.flush()
            svc._resident._rebuild_from_log()
        elif action == "fail_read":
            side.arm()
            if svc._resident.hashes_clean and not svc._pending:
                svc.hashes()            # clean read: nothing to fail
            else:
                with pytest.raises(side.error):
                    svc.hashes()
            side.mp.undo()
        h = svc.hashes()
        assert h == side.full()
        trail.append(h)
    return trail


@pytest.mark.parametrize("seed", [11, 23, 47, 101])
def test_dispatch_fault_walk_incremental_equals_full(tmp_path, monkeypatch,
                                                     seed):
    trails = []
    for ref in (True, False):
        side = _Side(ref, monkeypatch,
                     log_archive_dir=str(tmp_path / f"{ref}"),
                     log_horizon_changes=3)
        trails.append(_walk(side, seed))
        side.svc.close()
    assert trails[0] == trails[1]


def test_clean_read_launches_nothing():
    """After one reconciled read, a clean-fleet read does no device work
    (the port's counterpart of the reference's zero-dispatch case: the
    port counts its launches per kernel, `cuda_kernels.LAUNCHES` on the
    card; here the reconcile wrapper is counted)."""
    svc = EngineDocSet(backend="rows", device="cpu")
    side = _Side(False, None)
    for i in range(8):
        svc.apply_columns(f"d{i}", side.cols("A", 1, "k", i))
    h = svc.hashes()
    calls = []
    real = resident_rows.reconcile_rows_hash
    resident_rows.reconcile_rows_hash = \
        lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        assert svc.hashes() == h
        assert svc._resident.hashes_clean
    finally:
        resident_rows.reconcile_rows_hash = real
        svc.close()
        side.svc.close()
    assert not calls
