"""The docs-major reconcile: the port's `apply_doc` (device="cpu", so the
domination step runs the B5 kernel's plain version) against the
reference's `apply_doc` on the same stacked batch, for every output key
and both list-order routes. Tolerance: exact (integer and boolean outputs,
uint32 hashes).

The batches are the change sets of tests/test_engine_parity.py: its 20
scenario tests and its 6 random traces (not the experimental dense path),
captured by running each test body with its parity assertion replaced by
a recorder, built by the reference's frontend and carried into the port
through the wire dicts (`to_port`)."""

import inspect
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import test_engine_parity as tep
from automerge_tpu.engine import encode as ref_encode
from automerge_tpu.engine import kernels as ref_kernels
from automerge_tpu.engine import pack as ref_pack

from automerge_tpu_torch.engine import cuda_kernels
from automerge_tpu_torch.engine.cuda_kernels import hashes_to_numpy
from automerge_tpu_torch.engine.encode import encode_doc, stack_docs
from automerge_tpu_torch.engine.kernels import apply_doc
from automerge_tpu_torch.engine.pack import (FIELDS, apply_packed,
                                             apply_packed_hash, pack_batch,
                                             unpack_batch)

from torch_port_helpers import to_port

SCENARIO_CLASSES = ("TestMapParity", "TestListParity", "TestTextParity",
                    "TestBatch")
CASES = [f"{cls}.{name}" for cls in SCENARIO_CLASSES
         for name, _ in inspect.getmembers(getattr(tep, cls),
                                           inspect.isfunction)
         if name.startswith("test_")] + [
    f"TestFuzzConvergence.test_random_traces[{s}]" for s in range(6)]


def test_the_cases_are_the_parity_suite():
    assert len(CASES) == 26
    assert "TestDensePathParity" not in " ".join(CASES)


_captured: dict = {}


def change_sets(case: str) -> list:
    """The batches one parity test reconciles: a list of batches, each a
    list of per-document change lists (reference Change objects)."""
    if case in _captured:
        return _captured[case]
    batches = []
    real_apply_batch = tep.apply_batch

    def record_parity(doc):
        changes = tep.all_changes(doc)
        batches.append([changes])
        # the shuffled delivery of assert_parity's hash check
        shuffled = list(changes)
        random.Random(0).shuffle(shuffled)
        batches.append([shuffled])

    def record_batch(doc_changes, *a, **kw):
        batches.append(list(doc_changes))
        return real_apply_batch(doc_changes, *a, **kw)

    cls_name, _, rest = case.partition(".")
    name, _, param = rest.partition("[")
    saved = tep.assert_parity, tep.apply_batch
    tep.assert_parity, tep.apply_batch = record_parity, record_batch
    try:
        method = getattr(getattr(tep, cls_name)(), name)
        method(int(param[:-1])) if param else method()
    finally:
        tep.assert_parity, tep.apply_batch = saved
    assert batches, case
    _captured[case] = batches
    return batches


def both_batches(doc_changes):
    """(reference stacked batch, port stacked batch, max_fids) of one
    batch, each package encoding its own Change objects."""
    actors = sorted({c.actor for chs in doc_changes for c in chs})
    ref = ref_encode.stack_docs([ref_encode.encode_doc(chs, actors)
                                 for chs in doc_changes])
    port = stack_docs([encode_doc(to_port(chs), actors)
                       for chs in doc_changes])
    max_fids = ref.pop("max_fids")
    assert port.pop("max_fids") == max_fids
    return ref, port, max_fids


def as_numpy(out: dict) -> dict:
    got = {k: v.numpy() for k, v in out.items()}
    got["hash"] = hashes_to_numpy(out["hash"])
    return got


def assert_outputs_equal(got: dict, want: dict, what: str):
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype, (what, k, got[k].dtype, w.dtype)
        np.testing.assert_array_equal(got[k], w, err_msg=f"{what}: {k}")


@pytest.mark.parametrize("host_order", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_apply_doc_matches_reference(case, host_order):
    for doc_changes in change_sets(case):
        ref, port, max_fids = both_batches(doc_changes)
        for k in ref:
            np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
        want = ref_kernels.apply_doc(
            {k: jnp.asarray(v) for k, v in ref.items()}, max_fids,
            host_order=host_order)
        got = apply_doc({k: torch.from_numpy(v) for k, v in port.items()},
                        max_fids, host_order=host_order)
        assert_outputs_equal(as_numpy(got), want, case)


@pytest.mark.parametrize("case", CASES)
def test_packed_batch_and_domination_route(case):
    """pack_batch is byte-equal to the reference's; apply_packed equals
    apply_doc and apply_packed_hash its hash; the B5 route's flags equal
    the reference's segment-max domination form on the same batch."""
    for doc_changes in change_sets(case):
        ref, port, max_fids = both_batches(doc_changes)
        flat, meta = pack_batch(port)
        ref_flat, ref_meta = ref_pack.pack_batch(ref)
        assert flat.dtype == ref_flat.dtype == np.int32
        assert flat.tobytes() == ref_flat.tobytes()
        assert meta == ref_meta
        assert [m[0] for m in meta] == list(FIELDS)

        tensors = {k: torch.from_numpy(v) for k, v in port.items()}
        direct = as_numpy(apply_doc(tensors, max_fids, host_order=True))
        packed = torch.from_numpy(flat)
        for k, v in unpack_batch(packed, meta).items():
            assert torch.equal(v, tensors[k]), k
        assert_outputs_equal(as_numpy(apply_packed(packed, meta, max_fids)),
                             direct, f"{case} packed")
        np.testing.assert_array_equal(
            hashes_to_numpy(apply_packed_hash(packed, meta, max_fids)),
            direct["hash"])

        # B5 route vs the reference's segment-max form
        amask = ref["op_mask"] & (ref["action"] >= ref_encode.A_SET)
        seg_form = jax.vmap(ref_kernels.field_states, in_axes=(
            0, 0, 0, 0, 0, 0, 0, 0, None))(
            *(jnp.asarray(ref[k]) for k in (
                "op_mask", "action", "fid", "actor", "seq", "change_idx",
                "value", "clock")), max_fids)[0]
        want = amask & ~np.asarray(seg_form)
        clock_op = np.take_along_axis(
            ref["clock"], ref["change_idx"][:, :, None].astype(np.int64),
            axis=1)
        before = cuda_kernels.LAUNCHES["dominated"]
        got = cuda_kernels.dominated(*(torch.from_numpy(
            np.ascontiguousarray(x)) for x in (
            clock_op, port["actor"], port["fid"], port["seq"],
            port["change_idx"], amask))).numpy()
        assert cuda_kernels.LAUNCHES["dominated"] == before
        np.testing.assert_array_equal(got, want)


def test_out_of_range_indices_are_clamped_as_in_jax():
    """A batch whose padded op rows carry indices past their tables (a
    change index past the clock rows, an actor past the actor hashes, an
    element field past max_fids): JAX clamps those gathers and drops those
    segment ids; the port must give the same outputs, not raise."""
    changes = change_sets("TestListParity.test_concurrent_insert_delete")[0]
    ref, port, max_fids = both_batches(changes)
    n_ops = int(ref["op_mask"].sum())
    for b in (ref, port):
        b["change_idx"][0, n_ops:] = 1000
        b["actor"][0, n_ops:] = 77
        b["fid"][0, n_ops:] = max_fids + 5
    for host_order in (True, False):
        want = ref_kernels.apply_doc(
            {k: jnp.asarray(v) for k, v in ref.items()}, max_fids,
            host_order=host_order)
        got = apply_doc({k: torch.from_numpy(v) for k, v in port.items()},
                        max_fids, host_order=host_order)
        assert_outputs_equal(as_numpy(got), want, "out of range")


@pytest.mark.parametrize("r,e", [(8, 1), (16, 8), (12, 33), (8, 257)])
def test_linearize_plain_on_edge_rows_equals_the_reference(r, e):
    """linearize_plain (the route kernels.linearize takes for a CPU tensor,
    and what the linearize kernel is held to on the card) against the
    reference's vmapped linearize on random_linearize's edge rows: RGA
    rows, parents past the array (detached nodes, self-loops), all-masked
    rows, equal keys."""
    from automerge_tpu_torch.engine.kernels import linearize, linearize_plain
    from automerge_tpu_torch.workloads import random_linearize
    args = random_linearize(np.random.default_rng(r * e), r, e)
    want = np.asarray(jax.vmap(ref_kernels.linearize)(
        *(jnp.asarray(a) for a in args)))
    got = linearize_plain(*(torch.from_numpy(a) for a in args))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(linearize(*(torch.from_numpy(a) for a in args)), got)
