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
