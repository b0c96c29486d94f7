"""The port's CUDA kernel and rows engine on the card. Every test here is
marked `cuda` and skips without a GPU. The file imports neither jax nor the
JAX package, so it runs on a GPU machine that has neither:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerance: exact (integer hashes). The CPU side of each comparison is the
plain PyTorch version, which tests/test_torch_kernels.py and
tests/test_torch_rows.py hold bit-equal to the reference."""

from pathlib import Path

import numpy as np
import pytest

from automerge_tpu_torch.engine import cuda_kernels
from automerge_tpu_torch.engine.cuda_kernels import (
    hashes_to_numpy, reconcile_rows_hash, reconcile_rows_hash_plain)
from automerge_tpu_torch.engine.pack import rows_from_numpy
from automerge_tpu_torch.engine.resident_rows import ResidentRowsDocSet
from automerge_tpu_torch.workloads import reference_streams, text_fleet

from torch_port_helpers import cuda_device  # noqa: F401 (fixture)

REFERENCE = (Path(__file__).resolve().parent.parent / "automerge_tpu_torch"
             / "testdata" / "reference_hashes.npz")


@pytest.mark.cuda
@pytest.mark.parametrize("force_xl", [False, True])
def test_kernel_matches_plain_on_a_text_fleet_buffer(cuda_device, force_xl):
    ids, rounds = text_fleet(n_docs=200, chars=16)
    host = ResidentRowsDocSet(ids, device="cpu")
    host.apply_rounds(rounds)
    dims = host.dims()
    before = cuda_kernels.LAUNCHES["reconcile_rows_hash"]
    got = reconcile_rows_hash(rows_from_numpy(host.rows_host, dims,
                                              cuda_device), dims, force_xl)
    assert cuda_kernels.LAUNCHES["reconcile_rows_hash"] == before + 1
    want = reconcile_rows_hash_plain(rows_from_numpy(host.rows_host, dims,
                                                     "cpu"), dims)
    np.testing.assert_array_equal(hashes_to_numpy(got),
                                  hashes_to_numpy(want))


@pytest.mark.cuda
def test_engine_on_the_card_reproduces_the_reference(cuda_device):
    committed = np.load(REFERENCE)
    for name, ids, batches in reference_streams():
        ds = ResidentRowsDocSet(ids, device=cuda_device)
        before = cuda_kernels.LAUNCHES["reconcile_rows_hash"]
        for batch in batches:
            ds.apply_rounds(batch)
        assert cuda_kernels.LAUNCHES["reconcile_rows_hash"] == \
            before + sum(len(b) for b in batches)
        np.testing.assert_array_equal(ds.hashes(), committed[name])
        np.testing.assert_array_equal(ds.rows_dev.cpu().numpy(),
                                      ds.rows_host)
