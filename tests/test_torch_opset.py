"""The port's interpretive core (`core/opset.py`, `core/elems.py`, the
move plane of `core/moves.py`) and the dispatcher's batch route, held to
the reference's on the CPU (the text plane and the cursors:
`tests/test_torch_textplane.py`).

Every OpSet case of the reference's test modules runs on both packages
through `torch_twin_helpers.run_twin`: its own assertions must hold on the
port, and every document it makes must match the reference's. Tolerance:
exact. The cases left out are named with the reason; the router's own
cases are at the end of this file.
"""

import tempfile
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import test_moves
from torch_twin_helpers import collect, helper_case, run_twin

ENGINE = "reaches a reference device path the port has no counterpart of"
CASES = (
    collect("test_elems_property", exclude={
        "test_interactive_latency_at_100k":
            "a wall-clock bound (the port's ElemList is the reference's "
            "code; its behaviour is held by the other cases)",
    })
    + collect("test_nodiff_apply")
    + collect("test_moves", exclude={
        "test_kernel_triple_parity_on_random_realms":
            ENGINE + " (the XLA and Pallas move kernels; the port's B4 is "
            "held in test_torch_moves.py)",
        "test_pallas_node_cap_is_loud": ENGINE + " (Pallas node cap)",
        "test_two_service_fleet_move_storm_auditor_green":
            "needs EngineDocSet and the auditor (the sync service, not "
            "ported)",
        "test_experimental_dense_refuses_non_cpu_backend":
            "engine/experimental_dense.py is not ported",
    })
    + collect("test_dispatch", exclude={
        "test_plan_small_single_doc_routes_host":
            "prices with the TPU link's constants "
            "(test_plan_batch_prices_with_the_cards_constants below)",
        "test_adaptive_small_batch_returns_host_docs":
            "prices with the TPU link's constants "
            "(test_apply_batch_adaptive_* below force each route)",
    })
)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reference_case_on_both_packages(case, tmp_path, monkeypatch):
    run_twin(case, tmp_path, monkeypatch)


@settings(max_examples=25, derandomize=True, deadline=None)
@given(st.integers(0, 10**9))
def test_move_storms_converge_on_both_packages(seed):
    """test_moves.test_hypothesis_move_storms_converge on both packages,
    derandomized (no fixture inside @given: each example makes its own
    monkeypatch and directory)."""
    with tempfile.TemporaryDirectory() as tmp, \
            pytest.MonkeyPatch.context() as mp:
        run_twin(helper_case("test_moves", test_moves._check_storm_converges,
                             {"seed": seed}), Path(tmp), mp)


# The batch route of engine/dispatch.py at the port's own constants (the
# card's), and each route forced through calibrate.


@pytest.fixture
def link():
    """The port's cost constants, restored after the test."""
    from automerge_tpu_torch.engine import dispatch
    saved = dict(dispatch._LINK)
    yield dispatch
    dispatch._LINK.clear()
    dispatch._LINK.update(saved)


def test_plan_batch_prices_with_the_cards_constants(link):
    L = link._LINK
    for n_docs, n_ops, wire, passes in ((1, 200, 120 * 128 * 4, 1),
                                        (10_000, 80_000, 5_000_000, 10)):
        p = link.plan_batch(n_docs=n_docs, n_ops=n_ops, wire_bytes=wire,
                            passes=passes)
        dev = (L["dispatch_fixed_s"] / passes + L["h2d_call_s"]
               + wire / L["h2d_bytes_per_s"] + L["d2h_call_s"] / passes)
        assert p.est_device_s == pytest.approx(dev, rel=1e-12)
        assert p.est_host_s == pytest.approx(n_ops * L["host_op_s"],
                                             rel=1e-12)
        assert p.backend == ("device" if dev < p.est_host_s else "host")
    big = link.plan_batch(n_docs=1, n_ops=200_000, wire_bytes=1,
                          changes_per_doc=link.HOST_BULK_MIN_CHANGES)
    assert big.est_host_s == pytest.approx(
        L["bulk_fixed_s"] + 200_000 * L["bulk_op_s"], rel=1e-12)
    link.calibrate(dispatch_fixed_s=10.0)
    assert link.plan_batch(1, 200, 120 * 128 * 4).backend == "host"


def _batch():
    import test_dispatch
    from torch_port_helpers import to_port
    ref = [test_dispatch._trace_small(), test_dispatch._trace_bulk(80)]
    return ref, [to_port(chs) for chs in ref]


def test_apply_batch_adaptive_host_route_equals_the_reference(link):
    """The host route (the card's fixed cost priced up) returns documents
    equal to the reference's apply_host and to the device route's
    decode."""
    import automerge_tpu as am
    from automerge_tpu.engine.dispatch import apply_host as ref_apply_host
    from automerge_tpu_torch import api
    from automerge_tpu_torch.engine.batchdoc import (apply_batch,
                                                     decode_doc,
                                                     doc_outputs,
                                                     oracle_state)
    ref_chs, chs = _batch()
    link.calibrate(dispatch_fixed_s=10.0)
    plan, docs = link.apply_batch_adaptive(chs, device="cpu")
    assert plan.backend == "host" and len(docs) == 2
    encs, _b, out = apply_batch(chs, device="cpu")
    for i, (doc, rchs) in enumerate(zip(docs, ref_chs)):
        want = ref_apply_host(rchs)
        assert api.save(doc) == am.save(want)
        assert oracle_state(doc) == decode_doc(encs[i], doc_outputs(out, i))


def test_apply_batch_adaptive_device_route_equals_the_reference(link):
    """The device route (the host priced up) returns apply_batch's hashes,
    equal to the reference's."""
    from automerge_tpu.engine.batchdoc import apply_batch as ref_apply_batch
    from automerge_tpu_torch.engine.batchdoc import apply_batch
    from automerge_tpu_torch.engine.cuda_kernels import hashes_to_numpy
    ref_chs, chs = _batch()
    link.calibrate(host_op_s=1.0)
    plan, hashes = link.apply_batch_adaptive(chs, device="cpu")
    assert plan.backend == "device"
    assert plan.dims["docs"] == (2, plan.dims["docs"][1])
    _e, _b, out = apply_batch(chs, device="cpu")
    assert hashes.tolist() == hashes_to_numpy(out["hash"]).tolist()
    _e, _b, ref_out = ref_apply_batch(ref_chs)
    assert hashes.tolist() == \
        np.asarray(ref_out["hash"]).astype(np.uint32).tolist()
