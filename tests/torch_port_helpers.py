"""Shared helpers of the port's tests (`tests/test_torch_*.py`)."""

import importlib.util
import sys
from pathlib import Path

import pytest
import torch

from automerge_tpu_torch.core.change import Change as PortChange

REPO = Path(__file__).resolve().parent.parent


def load_bench():
    """The repo-root bench.py as a module (imported by file path; its
    heavy imports are deferred, so this is cheap)."""
    mod = sys.modules.get("bench")
    if mod is None:
        spec = importlib.util.spec_from_file_location("bench",
                                                      REPO / "bench.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules["bench"] = mod
        spec.loader.exec_module(mod)
    return mod


def load_reference_script():
    """scripts/torch_reference_hashes.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "torch_reference_hashes",
        REPO / "scripts" / "torch_reference_hashes.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips where there is none. Decided
    inside the fixture, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False); chip_smoke.py covers the kernel on the card")
    return torch.device("cuda", 0)


def to_port(changes):
    """Reference Change objects as the port's own (through the wire dict)."""
    return [PortChange.from_dict(c.to_dict()) for c in changes]


def rounds_to_port(rounds):
    return [{d: to_port(chs) for d, chs in r.items()} for r in rounds]


def changes_of(doc):
    """Every change of an interpretive (reference) document, in causal
    order."""
    return doc._doc.opset.get_missing_changes({})


def build_history():
    """One author's text and map history (tests/test_compaction.py's):
    "hello world" typed, `n` overwritten 30 times, the first 6 characters
    deleted, leaving "world"."""
    import automerge_tpu as am
    d = am.init("alice")
    d = am.change(d, lambda x: x.__setitem__("t", am.Text()))
    d = am.change(d, lambda x: x["t"].insert_at(0, *"hello world"))
    for k in range(30):
        d = am.change(d, lambda x, k=k: x.__setitem__("n", k))
    d = am.change(d, lambda x: [x["t"].delete_at(0) for _ in range(6)])
    return d


def assert_same_rows(ref, port):
    """The two packages' rows engines hold the same state: hashes, the row
    mirror, per-doc counters, the insert logs, ghosts and clocks."""
    import numpy as np
    np.testing.assert_array_equal(port.hashes(), ref.hashes())
    assert port.dims() == ref.dims()
    np.testing.assert_array_equal(port.rows_host, ref.rows_host)
    n = len(ref.doc_ids)
    np.testing.assert_array_equal(port.op_count[:n], ref.op_count[:n])
    assert port.ins_log == ref.ins_log
    assert port.ins_idx == ref.ins_idx
    assert port.list_obj == ref.list_obj
    assert port.ghost_eids == ref.ghost_eids
    ref.sync_tables()
    port.sync_tables()
    for t_ref, t_port in zip(ref.tables, port.tables):
        assert dict(t_port.clock) == dict(t_ref.clock)
        assert dict(t_port.frontier) == dict(t_ref.frontier)
