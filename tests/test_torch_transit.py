"""The port's transit save format (`automerge_tpu_torch/interop/transit.py`,
`api.save_transit` / `api.load_transit`) held to the reference's on the
CPU.

Through `torch_twin_helpers.run_twin`, every case of the reference's
`tests/test_transit_interop.py` runs on both packages (every document a
case makes is held to the reference's). The reference's
`tests/test_hypothesis_transit_perop.py` runs on both packages under a
fixed hypothesis seed (`derandomize=True`): random multi-replica
programs round-trip through transit, and a `PerOpDiffStream` folds
concurrent admissions exactly once (its writer threads make documents
in the scheduler's order, so that case holds the two runs' nodes equal
and not their documents one by one). Across the packages: random
documents' transit text is byte-equal, and each package loads the
other's text to the same state. Tolerance: exact.
"""

import random
import tempfile
from pathlib import Path

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import test_hypothesis_transit_perop as perop
import torch_twin_helpers
from torch_twin_helpers import (collect, helper_case, helper_modules,
                                hold_services, hygiene_teardown,
                                reload_caches, run_twin, state_of)

import automerge_tpu as ref_am
from automerge_tpu.interop import transit as ref_transit
from automerge_tpu.utils import uuid as ref_uuid

from automerge_tpu_torch import api
from automerge_tpu_torch.interop import transit
from automerge_tpu_torch.utils import uuid as port_uuid

helper_modules("tests.test_hypothesis_conformance")
from tests.test_hypothesis_conformance import _instr  # noqa: E402

CASES = collect("test_transit_interop")

_FUZZ = dict(deadline=None, derandomize=True,
             suppress_health_check=[HealthCheck.too_slow])


@pytest.fixture(autouse=True)
def _hygiene():
    yield
    hygiene_teardown()


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reference_case_on_both_packages(case, tmp_path, monkeypatch):
    run_twin(case, tmp_path, monkeypatch)


def _twin(fn, params):
    with tempfile.TemporaryDirectory() as tmp, \
            pytest.MonkeyPatch.context() as mp:
        run_twin(helper_case("test_hypothesis_transit_perop", fn, params),
                 Path(tmp), mp)


@settings(max_examples=15, **_FUZZ)
@given(st.lists(_instr, min_size=1, max_size=18))
def test_transit_roundtrip_of_random_conflict_states_on_both_packages(
        instrs):
    _twin(perop.test_transit_roundtrip_preserves_random_conflict_states
          .hypothesis.inner_test, {"instrs": instrs})


@settings(max_examples=4, **_FUZZ)
@given(st.integers(min_value=2, max_value=4),
       st.integers(min_value=2, max_value=6),
       st.integers(min_value=0, max_value=2**31))
def test_perop_stream_under_concurrent_gossip_on_both_packages(
        n_threads, n_changes, seed):
    nodes = {}
    with tempfile.TemporaryDirectory() as tmp, \
            pytest.MonkeyPatch.context() as mp:
        for side in ("ref", "port"):
            case = helper_case(
                "test_hypothesis_transit_perop",
                perop.test_perop_stream_under_concurrent_admission_gossip
                .hypothesis.inner_test,
                {"n_threads": n_threads, "n_changes": n_changes,
                 "rnd": random.Random(seed)})
            reload_caches()
            _, rb = torch_twin_helpers._run_side(case, side, {
                "tmp_path": Path(tmp), "monkeypatch": mp})
            mp.undo()
            nodes[side] = rb.services
        reload_caches()
    hold_services(nodes["ref"], nodes["port"])


def _docs(seed):
    """A reference document and the port's, built by the same random
    edits of two replicas (maps, lists, text, list moves, conflicts)
    from the same uuid sequence."""
    out = []
    for side, am in (("ref", ref_am), ("port", api)):
        n = {"i": 0}

        def factory():
            n["i"] += 1
            return f"00000000-tran-{n['i']:08d}"
        (ref_uuid if side == "ref" else port_uuid).set_factory(factory)
        kw = {} if side == "ref" else {"device": "cpu"}
        rng = random.Random(seed)
        try:
            a = am.change(am.init("A", **kw), lambda d: am.assign(d, {
                "title": "t~^`", "xs": [1, 2, 3], "meta": {"n": 1.5}}))
            a = am.change(a, lambda d: d.__setitem__("t", am.Text()))
            b = am.merge(am.init("B", **kw), a)
            for k in range(12):
                r = rng.randrange(5)
                who = rng.choice("ab")
                doc = a if who == "a" else b

                def edit(d, r=r, k=k):
                    if r == 0:
                        d["title"] = f"{who}{k}"
                    elif r == 1:
                        d["xs"].insert_at(min(k % 4, len(d["xs"])), k)
                    elif r == 2:
                        d["t"].insert_at(0, *f"{who}{k}")
                    elif r == 3 and len(d["xs"]) > 1:
                        d["xs"].move(0, len(d["xs"]) - 1)
                    else:
                        d["meta"][f"k{k % 3}"] = {"v": [k, None, True]}
                doc = am.change(doc, edit)
                if who == "a":
                    a = doc
                else:
                    b = doc
                if k % 5 == 4:
                    a, b = am.merge(a, b), am.merge(b, a)
            out.append(am.merge(a, b))
        finally:
            (ref_uuid if side == "ref" else port_uuid).reset()
    return out


@pytest.mark.parametrize("seed", range(6))
def test_transit_text_equal_and_loaded_across_packages(seed):
    ref_doc, port_doc = _docs(seed)
    text = ref_am.save_transit(ref_doc)
    assert api.save_transit(port_doc) == text
    want = state_of(ref_doc)
    assert state_of(api.load_transit(text, "X", device="cpu")) == want
    assert state_of(ref_am.load_transit(api.save_transit(port_doc),
                                        "X")) == want
    history = [c.to_dict() for c in ref_doc._doc.opset.history]
    assert transit.dumps(history) == ref_transit.dumps(history)
    assert transit.loads(text) == ref_transit.loads(text)


def test_load_transit_defaults_to_the_card():
    import torch
    text = api.save_transit(api.init("A", device="cpu"))
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        api.load_transit(text)
