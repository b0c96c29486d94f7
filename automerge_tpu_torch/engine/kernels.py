"""The murmur-style state-hash mixers of `automerge_tpu/engine/kernels.py`
on torch tensors, and their numpy uint32 forms for the host oracles.

The reference computes in uint32. Torch's `>>` on int32 is an arithmetic
shift and its integer products overflow as signed values, so here every
value is held in int64 in [0, 2**32): shifts are then logical, and each
32x32-bit product is split into two products below 2**49 so that nothing
overflows before the `& 0xFFFFFFFF` wrap.
"""

from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLD = 0x9E3779B9


def _mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    """(h * m) mod 2**32 for int64 h in [0, 2**32) and a uint32 constant."""
    lo = h * (m & 0xFFFF)
    hi = ((h * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _mix(h: torch.Tensor) -> torch.Tensor:
    """32-bit finalizer over int64 tensors holding uint32 values."""
    h = h & _MASK
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 13)
    h = _mul32(h, _M2)
    h = h ^ (h >> 16)
    return h


def _u32(x: torch.Tensor) -> torch.Tensor:
    """An int32 (or int64) tensor's low 32 bits as int64 in [0, 2**32)."""
    return x.to(torch.int64) & _MASK


def _mix4(a, b, c, d) -> torch.Tensor:
    """mix4 of four int32 (or int64) tensors; returns int64 in [0, 2**32)."""
    h = _mix(_u32(a) + _GOLD)
    h = _mix(h ^ _u32(b))
    h = _mix(h ^ _u32(c))
    return _mix(h ^ _u32(d))


def _int32_bits(x: torch.Tensor) -> torch.Tensor:
    """An int64 tensor taken mod 2**32, as int32 holding those bits (the
    uint32 wraparound of a sum)."""
    x = x & _MASK
    return (x - ((x >> 31) << 32)).to(torch.int32)


def _mix_np(h: np.ndarray) -> np.ndarray:
    """The 32-bit finalizer on numpy arrays, in uint32 (wrapping)."""
    h = h.astype(np.uint32)
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(_M1)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(_M2)
    h = h ^ (h >> np.uint32(16))
    return h


def _mix4_np(a, b, c, d) -> np.ndarray:
    """mix4 of four numpy integer arrays, in uint32 (wrapping)."""
    h = _mix_np(a.astype(np.uint32) + np.uint32(_GOLD))
    h = _mix_np(h ^ b.astype(np.uint32))
    h = _mix_np(h ^ c.astype(np.uint32))
    return _mix_np(h ^ d.astype(np.uint32))
