"""Shared helpers of the port's tests (`tests/test_torch_*.py`)."""

import pytest
import torch

from automerge_tpu_torch.core.change import Change as PortChange


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
