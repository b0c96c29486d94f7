"""The port's dispatch-efficiency ledger (automerge_tpu_torch/engine/
dispatchledger.py) and its metrics core (utils/metrics.py): the
reference's tests of tests/test_dispatchledger.py run against the port's
modules (env gate, round/call folding, ambient accounting, bounded
memory, pure-state export, amplification/padding math, the reset hook),
and the same scripted rounds folded by both packages' ledgers give equal
sections."""

import pytest

from automerge_tpu.engine import dispatchledger as ref_dl

from automerge_tpu_torch.engine import dispatchledger as dl
from automerge_tpu_torch.utils import metrics


@pytest.fixture(autouse=True)
def _clean():
    metrics.reset()
    yield
    metrics.reset()


class _Plan:
    def __init__(self, backend="host", est_device_s=0.002,
                 est_host_s=0.001):
        self.backend = backend
        self.est_device_s = est_device_s
        self.est_host_s = est_host_s


def _one_round(dirty=4, calls=2, ambient=1,
               axes={"docs": (3, 8), "ops": (10, 16)}):
    with dl.round_scope(dirty, label="flush"):
        for _ in range(calls):
            with dl.call_scope("fam", plan=_Plan(), docs=3, axes=axes):
                pass
        for _ in range(ambient):
            dl.note_jit("stray_kernel", retraced=False)


# -- env gate ----------------------------------------------------------------


def test_env_gate_disables_every_hook(monkeypatch):
    monkeypatch.setenv("AMTPU_DISPATCHLEDGER", "0")
    dl._reload_for_tests()
    try:
        assert dl.enabled() is False
        _one_round()
        dl.note_jit("k", retraced=True)
        assert dl.ledger().section() is None
        assert dl.snapshot_section() is None
    finally:
        monkeypatch.delenv("AMTPU_DISPATCHLEDGER")
        dl._reload_for_tests()
    assert dl.enabled() is True


# -- round/call folding ------------------------------------------------------


def test_round_folds_calls_kernels_and_buckets():
    _one_round(dirty=4, calls=2, ambient=1)
    sec = dl.ledger().section()
    assert sec["rounds_total"] == 1
    assert sec["dispatches_total"] == 2
    assert sec["ambient_total"] == 1
    assert sec["dirty_docs_total"] == 4
    (rnd,) = sec["ring"]
    assert rnd["label"] == "flush"
    assert rnd["dirty_docs"] == 4 and rnd["dispatches"] == 2
    assert rnd["ambient"] == 1
    k = rnd["kernels"]["fam"]
    assert k["calls"] == 2 and k["host"] == 2 and k["device"] == 0
    # axes {"docs": (3, 8), "ops": (10, 16)}: logical 30, padded 128
    b = rnd["buckets"]["fam:8x16"]
    assert b["calls"] == 2 and b["docs"] == 6
    assert b["docs_cap"] == 16          # padded docs axis x 2 calls
    assert b["logical"] == 60 and b["padded"] == 256


def test_window_amplification_and_waste_math():
    _one_round(dirty=4, calls=2, ambient=1)
    w = dl.ledger().section()["window"]
    # (2 dispatches + 1 ambient) / 4 dirty docs
    assert w["amplification"] == pytest.approx(0.75)
    # 100 * (1 - 60/256)
    assert w["pad_waste_pct"] == pytest.approx(76.562, abs=1e-3)
    assert w["dispatches_per_round"] == 2.0


def test_note_jit_marks_open_call_device_and_retraces():
    with dl.round_scope(1):
        with dl.call_scope("fam", backend="host"):
            dl.note_jit("fam_kernel", retraced=False)
            dl.note_jit("fam_kernel", retraced=True)
    (rnd,) = dl.ledger().section()["ring"]
    k = rnd["kernels"]["fam"]
    assert k["jits"] == 2 and k["retraces"] == 1
    assert k["device"] == 1 and k["host"] == 0   # jit => device dispatch


def test_nested_round_scope_is_a_noop():
    with dl.round_scope(2, label="outer"):
        with dl.round_scope(99, label="inner"):
            with dl.call_scope("fam"):
                pass
    sec = dl.ledger().section()
    assert sec["rounds_total"] == 1
    assert sec["ring"][0]["label"] == "outer"
    assert sec["ring"][0]["dirty_docs"] == 2


# -- ambient paths -----------------------------------------------------------


def test_call_outside_round_folds_as_ambient_pseudo_round():
    with dl.call_scope("fam", docs=5, axes={"docs": (5, 8)}):
        pass
    (rnd,) = dl.ledger().section()["ring"]
    assert rnd["label"] == "ambient"
    assert rnd["dirty_docs"] == 5 and rnd["dispatches"] == 1


def test_jit_with_no_scope_counts_ambient_total():
    dl.note_jit("stray", retraced=False)
    sec = dl.ledger().section()
    assert sec["ambient_total"] == 1
    assert sec["rounds_total"] == 0


# -- bounded memory ----------------------------------------------------------


def test_ring_is_bounded_and_export_truncates():
    for _ in range(dl.RING + 10):
        with dl.round_scope(1):
            pass
    sec = dl.ledger().section()
    assert sec["rounds_total"] == dl.RING + 10
    assert sec["window"]["rounds"] == dl.RING
    assert len(sec["ring"]) == dl.EXPORT_ROUNDS
    assert sec["ring_truncated"] == dl.RING - dl.EXPORT_ROUNDS


def test_call_cap_drops_detail_but_keeps_count():
    with dl.round_scope(1):
        for _ in range(dl.CALL_CAP + 5):
            with dl.call_scope("fam"):
                pass
    (rnd,) = dl.ledger().section()["ring"]
    assert rnd["dispatches"] == dl.CALL_CAP
    assert rnd["dropped"] == 5


def test_bucket_export_cap_reports_truncation():
    with dl.round_scope(1):
        for i in range(dl.EXPORT_BUCKETS + 3):
            with dl.call_scope("fam", axes={"docs": (1, i + 1)}):
                pass
    w = dl.ledger().section()["window"]
    assert len(w["buckets"]) == dl.EXPORT_BUCKETS
    assert w["buckets_truncated"] == 3


# -- export purity / registration -------------------------------------------


def test_section_is_pure_two_idle_snapshots_equal():
    _one_round()
    a = dl.ledger().section()
    b = dl.ledger().section()
    assert a == b


def test_snapshot_section_registered_with_nodes_shape():
    _one_round()
    snap = metrics.snapshot()
    nodes = snap["dispatchledger"]["nodes"]
    (label,) = nodes
    assert nodes[label]["rounds_total"] == 1


def test_metrics_reset_clears_ledger():
    _one_round()
    assert dl.ledger().section() is not None
    metrics.reset()
    assert dl.ledger().section() is None
    assert dl.snapshot_section() is None


def test_self_seconds_accumulates():
    """Self-time grows with the rounds folded (the reference's test also
    bounds it by a wall-clock figure, which a tier-1 test does not
    assert)."""
    for _ in range(5):
        _one_round()
    s5 = dl.ledger().self_seconds()
    for _ in range(45):
        _one_round()
    assert 0 < s5 < dl.ledger().self_seconds()


def _scrub(sec):
    """A section without its clock-derived fields (wall and self times)."""
    if isinstance(sec, dict):
        return {k: _scrub(v) for k, v in sec.items()
                if k not in ("wall_s", "self_s")}
    if isinstance(sec, list):
        return [_scrub(v) for v in sec]
    return sec


def test_sections_equal_the_reference_on_the_same_rounds(monkeypatch):
    """Rounds, ambient calls and megabatch notes scripted the same way
    fold to the same section in both packages (clock fields aside). Each
    package's hooks fold into a fresh ledger for the test, so the
    reference's process-global one is left as it was."""
    summary = {"buckets": 2, "docs": 9, "dispatches": 2, "docs_cap": 256,
               "logical": 700, "padded": 9000, "docs_per_dispatch": 4.5,
               "fill_pct": 3.516, "pad_waste_pct": 92.222}

    def script(led):
        with led.round_scope(4, label="flush"):
            for n in (3, 5):
                with led.call_scope("rows_mega", backend="device", docs=n,
                                    axes={"docs": (n, 128),
                                          "rows": (82, 82)}):
                    led.note_jit("k", retraced=n == 3)
            led.note_jit("stray", retraced=False)
            led.note_megabatch(summary)
            led.note_megabatch(summary)
        with led.call_scope("rows_hash", docs=7, axes={"docs": (7, 128)}):
            pass
        led.note_megabatch(summary)

    monkeypatch.setattr(ref_dl, "_ledger", ref_dl.DispatchLedger())
    monkeypatch.setattr(dl, "_ledger", dl.DispatchLedger())
    script(ref_dl)
    script(dl)
    ref = ref_dl.ledger().section()
    got = dl.ledger().section()
    assert _scrub(got) == _scrub(ref)
    assert got["mega_rounds_total"] == 3
    assert dl.last_round_summary() == ref_dl.last_round_summary()
