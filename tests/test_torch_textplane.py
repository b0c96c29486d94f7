"""The port's span-granularity text plane (`core/textspans.py`) and the
frontend's cursors (`frontend/cursors.py`), held to the reference's on the
CPU.

Every OpSet case of the reference's text-plane and cursor test modules
runs on both packages through `torch_twin_helpers.run_twin`: its own
assertions must hold on the port, and every document it makes must match
the reference's. Tolerance: exact. The cases left out are named with the
reason.
"""

import tempfile
from pathlib import Path

import pytest
from hypothesis import given, settings, strategies as st

import test_textspans
from torch_twin_helpers import collect, helper_case, run_twin

ENGINE = "reaches a reference device path the port has no counterpart of"
CASES = (
    collect("test_textspans", exclude={
        "test_merge_spans_three_way_parity":
            ENGINE + " (the XLA and Pallas span merges; the port's B3 is "
            "held in test_torch_spans.py)",
        "test_plan_spans_and_adaptive_router":
            "prices with the TPU link's constants; the port's router "
            "prices with the card's (test_torch_spans.py)",
        "test_concurrent_text_fleet_converges_and_audits_clean":
            "needs EngineDocSet and the auditor (the sync service, not "
            "ported)",
    })
    + collect("test_cursor_equivalence", exclude={
        "test_cursor_equivalence_on_concurrent_text_traces":
            "the engine's diff stream on random traces, held to the "
            "reference's records in test_torch_diffs.py",
        "test_selection_equivalence_on_concurrent_text_traces":
            "the engine's diff stream on random traces, held to the "
            "reference's records in test_torch_diffs.py",
    })
)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reference_case_on_both_packages(case, tmp_path, monkeypatch):
    run_twin(case, tmp_path, monkeypatch)


@settings(max_examples=25, derandomize=True, deadline=None)
@given(st.lists(test_textspans._instr, min_size=1, max_size=25))
def test_span_merge_equals_perop_replay_on_both_packages(instrs):
    """test_textspans.test_property_span_merge_equals_perop_replay
    (its body, with the span_plane fixture resolved per example),
    derandomized."""
    body = test_textspans.test_property_span_merge_equals_perop_replay
    with tempfile.TemporaryDirectory() as tmp, \
            pytest.MonkeyPatch.context() as mp:
        run_twin(helper_case("test_textspans", body.hypothesis.inner_test,
                             {"instrs": instrs}, fixtures=["span_plane"]),
                 Path(tmp), mp)
