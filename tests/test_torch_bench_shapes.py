"""The row wires and field sharding on the exact batches of the reference's
bench configs 1-5, on both packages.

Through `torch_twin_helpers.run_twin`, the cases of the reference's
`tests/test_bench_shapes_interpret.py` run on both packages: the byte
wire, its widen and the wide-path cross-check on configs 2-5, and config
1's field split recombined. On the port's run the device-side functions
are bound to the port's on `device="cpu"` through adapters that take
numpy and return np.uint32 hashes, and the bench's reference changes
reach the port's encoder and `apply_batch` through their wire dicts.
`test_dense_kernel_parity_on_bench_shapes` holds the port's quarantined
dense reconcile to its `apply_doc` on configs 1 and 2, both on the CPU.

Then the port's own generators of configs 1-4 (`workloads.BENCH_CONFIGS`,
the ones `chip_smoke.py` drives on the card) give the bench's changes,
change for change, with both packages' uuid factories set alike.
Tolerance: exact.
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import load_bench, to_port
from torch_twin_helpers import (collect, counter_factory, hygiene_teardown,
                                run_twin)

from automerge_tpu.engine import batchdoc as ref_batchdoc
from automerge_tpu.engine import encode as ref_encode
from automerge_tpu.engine import experimental_dense as ref_xd
from automerge_tpu.engine import kernels as ref_kernels
from automerge_tpu.engine import pack as ref_pack
from automerge_tpu.utils import uuid as ref_uuid

from automerge_tpu_torch import workloads
from automerge_tpu_torch.engine import batchdoc, encode, pack
from automerge_tpu_torch.engine import experimental_dense as xd
from automerge_tpu_torch.engine import kernels
from automerge_tpu_torch.engine.cuda_kernels import hashes_to_numpy
from automerge_tpu_torch.utils import uuid as port_uuid

load_bench()


def _encode_doc(changes, actors=None):
    return encode.encode_doc(to_port(changes), actors)


def _apply_batch(doc_changes, actors=None):
    encs, arrays, out = batchdoc.apply_batch(
        [to_port(chs) for chs in doc_changes], actors, device="cpu")
    return encs, arrays, dict(out, hash=hashes_to_numpy(out["hash"]))


def _apply_rows_hash(rows, dims, n_docs, interpret=False):
    return hashes_to_numpy(pack.apply_rows_hash(
        torch.from_numpy(np.asarray(rows)), dims, n_docs))


def _apply_rows_hash_bytes(wire, bmeta, dims, interpret=False):
    return hashes_to_numpy(pack.apply_rows_hash_bytes(
        np.asarray(wire), bmeta, dims, device="cpu"))


_apply_rows_hash_bytes.__wrapped__ = _apply_rows_hash_bytes


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


class _Kernels:
    """The port's `kernels` module as the reference's test calls it: a
    numpy batch, reconciled on the CPU."""

    @staticmethod
    def apply_doc(batch, max_fids, host_order=False):
        return kernels.apply_doc(_tensors(batch), max_fids, host_order)


class _Dense:
    """The port's `experimental_dense` on the CPU (a numpy batch would
    otherwise go to the card, where the module is quarantined)."""
    DENSE_BUDGET = xd.DENSE_BUDGET
    dense_cost = staticmethod(xd.dense_cost)

    @staticmethod
    def reconcile_dense(batch, max_fids, host_order=False):
        return xd.reconcile_dense(batch, max_fids, host_order, device="cpu")


ADAPTERS = {
    ref_kernels: _Kernels,
    ref_xd: _Dense,
    ref_encode.encode_doc: _encode_doc,
    ref_batchdoc.apply_batch: _apply_batch,
    ref_pack.apply_rows_hash: _apply_rows_hash,
    ref_pack.apply_rows_hash_bytes: _apply_rows_hash_bytes,
}

CASES = collect("test_bench_shapes_interpret", adapters=ADAPTERS)


@pytest.fixture(autouse=True)
def _hygiene():
    yield
    hygiene_teardown()


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reference_case_on_both_packages(case, tmp_path, monkeypatch):
    run_twin(case, tmp_path, monkeypatch)


@pytest.mark.parametrize("config", sorted(workloads.BENCH_CONFIGS))
def test_port_generators_give_the_bench_changes(config):
    bench = load_bench()
    bench._load_package()
    gen = {1: bench.gen_lww_storm, 2: bench.gen_trellis,
           3: bench.gen_text_trace, 4: bench.gen_tombstone_list}[config]
    try:
        ref_uuid.set_factory(counter_factory("00000000-bench-"))
        want = gen()
        port_uuid.set_factory(counter_factory("00000000-bench-"))
        got = workloads.BENCH_CONFIGS[config]()
    finally:
        ref_uuid.reset()
        port_uuid.reset()
    assert [[c.to_dict() for c in chs] for chs in got] \
        == [[c.to_dict() for c in chs] for chs in want]
    # and the same batch shapes, so the same envelope decisions
    actors = sorted({c.actor for chs in got for c in chs})
    batch = encode.stack_docs([encode.encode_doc(chs, actors) for chs in got])
    mf = batch.pop("max_fids")
    rbatch = ref_encode.stack_docs(
        [ref_encode.encode_doc(chs, actors) for chs in want])
    rbatch.pop("max_fids")
    assert pack.rows_eligible(batch, mf) == ref_pack.rows_eligible(rbatch, mf)
    assert batch["op_mask"].shape == rbatch["op_mask"].shape
