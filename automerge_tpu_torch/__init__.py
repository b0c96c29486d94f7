"""automerge_tpu_torch — the PyTorch/CUDA port of automerge_tpu.

The JAX package `automerge_tpu` stays the reference; this package computes
the same per-document convergence hashes bit for bit, on an NVIDIA GPU
through hand-written CUDA kernels (`csrc/`), or on the CPU through their
plain PyTorch versions when the caller asks for `device="cpu"`.

It imports `torch` and numpy, never `jax` and never `automerge_tpu`.
Module paths mirror the reference: `automerge_tpu_torch/engine/
resident_rows.py` is the counterpart of `automerge_tpu/engine/
resident_rows.py`.
"""

__version__ = "0.1.0"
