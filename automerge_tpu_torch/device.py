"""The port's device rule.

Entry points run on the GPU unless the caller passes `device="cpu"`. A CUDA
device that is not present is an error, never a silent fall back to the CPU:
a caller who asked for the card must not get CPU timings or CPU memory
behaviour without knowing it.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """The torch.device for `device`; raises if it names CUDA and no CUDA
    device is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev
