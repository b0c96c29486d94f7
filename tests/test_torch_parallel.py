"""The port's mesh layer (`automerge_tpu_torch/parallel/`) held to the
reference's on the CPU.

The cases of the reference's `tests/test_parallel.py`, each on both
packages: the port on an 8-shard CPU mesh (`make_mesh(devices=["cpu"] *
8)`), the reference on its 8-device CPU mesh (tests/conftest.py), the
same change sets (the reference's `Change` objects reach the port through
their wire dicts). `reconcile_sharded`'s every output (the uint32 hash
bits included), `reconcile_rows_sharded` and `reconcile_rows_sharded_
bytes` hashes, and `global_clock_union` are equal to the reference's and
to the unsharded engines'. Left out: `test_graft_entry_single_chip` and
`test_graft_entry_multichip`, because `__graft_entry__.py` drives the JAX
package; `chip_smoke.py` is the port's entry.

Then meshes of 1, 2, 4 and 8 shards on doc counts that are not a multiple
of 128 x shards, both list-order routes of `sharded_apply`, the shards'
placement, and the device rule. Tolerance: exact.
"""

import numpy as np
import pytest
import torch

import automerge_tpu as am
from automerge_tpu.engine.batchdoc import apply_batch as ref_apply_batch
from automerge_tpu.parallel import mesh as ref_mesh
from automerge_tpu.parallel import global_clock_union as ref_union

from automerge_tpu_torch.engine.batchdoc import apply_batch
from automerge_tpu_torch.engine.cuda_kernels import hashes_to_numpy
from automerge_tpu_torch.parallel import (global_clock_union, make_mesh,
                                          reconcile_sharded, shard_batch)
from automerge_tpu_torch.parallel import mesh as pmesh

from torch_port_helpers import to_port
from torch_twin_helpers import hygiene_teardown

CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True)
def _hygiene():
    yield
    hygiene_teardown()


@pytest.fixture(scope="module")
def ref_mesh8():
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("the reference needs 8 virtual devices")
    return ref_mesh.make_mesh(8)


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh(devices=CPU8)


def _doc_changes(n):
    """test_parallel.py's _doc_changes."""
    out = []
    for i in range(n):
        s1 = am.change(am.init("A"), lambda d, i=i: am.assign(
            d, {"n": i, "xs": [i]}))
        s2 = am.change(am.init("B"), lambda d, i=i: d.__setitem__("n", i * 10))
        m = am.merge(s1, s2)
        out.append(m._doc.opset.get_missing_changes({}))
    return out


def _list_docs(n, tag=False):
    """The docs of test_rows_megakernel_sharded_over_mesh (and, with
    `tag`, of the byte-wire case)."""
    docs = []
    for i in range(n):
        base = {"n": i, "xs": [i, i + 1]}
        if tag:
            base["tag"] = f"t{i % 5}"
        s1 = am.change(am.init("A"), lambda d, b=base: am.assign(d, b))
        s2 = am.merge(am.init("B"), s1)
        s1 = am.change(s1, lambda d: d["xs"].delete_at(0))
        s2 = am.change(s2, lambda d, i=i: d.__setitem__("n", -i))
        m = am.merge(s1, s2)
        docs.append(m._doc.opset.get_missing_changes({}))
    return docs


def _port(docs):
    return [to_port(chs) for chs in docs]


def _oracle(docs):
    _, _, out = ref_apply_batch(docs)
    return np.asarray(out["hash"])[:len(docs)].astype(np.uint32)


def _same_outputs(port_out: dict, ref_out: dict, n: int):
    assert port_out.keys() == ref_out.keys()
    for k in ref_out:
        want = np.asarray(ref_out[k])
        got = port_out[k].cpu().numpy()
        if want.dtype == np.uint32:
            got = got.view(np.uint32)
        assert got.shape[1:] == want.shape[1:], k
        np.testing.assert_array_equal(got[:n], want[:n], err_msg=k)


# ---------------------------------------------------------------------------
# the cases of tests/test_parallel.py


def test_sharded_reconcile_matches_single_device(mesh8, ref_mesh8):
    docs = _doc_changes(16)
    _, _, out_single = apply_batch(_port(docs), device="cpu")
    _, out, n_real = reconcile_sharded(_port(docs), mesh8)
    np.testing.assert_array_equal(hashes_to_numpy(out_single["hash"]),
                                  hashes_to_numpy(out["hash"])[:n_real])
    _, ref_out, ref_n = ref_mesh.reconcile_sharded(docs, ref_mesh8)
    assert n_real == ref_n == 16
    _same_outputs(out, ref_out, 16)


def test_sharded_reconcile_with_doc_padding(mesh8, ref_mesh8):
    docs = _doc_changes(13)
    _, out, n_real = reconcile_sharded(_port(docs), mesh8)
    assert out["hash"].shape[0] % 8 == 0 and n_real == 13
    _, ref_out, _ = ref_mesh.reconcile_sharded(docs, ref_mesh8)
    assert out["hash"].shape[0] == np.asarray(ref_out["hash"]).shape[0]
    _same_outputs(out, ref_out, out["hash"].shape[0])


def test_global_clock_union(mesh8, ref_mesh8):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    clocks = np.array([[i, 16 - i, 3] for i in range(16)], dtype=np.int32)
    want = np.asarray(ref_union(jax.device_put(
        clocks, NamedSharding(ref_mesh8, P(ref_mesh.DOCS_AXIS))), ref_mesh8))
    assert want.tolist() == [15, 16, 3]
    whole = global_clock_union(torch.from_numpy(clocks), mesh8)
    per_shard = global_clock_union(
        [torch.from_numpy(clocks[k * 2:(k + 1) * 2]) for k in range(8)],
        mesh8)
    assert whole.dtype == per_shard.dtype == torch.int32
    assert whole.tolist() == per_shard.tolist() == want.tolist()


def test_rows_megakernel_sharded_over_mesh(mesh8, ref_mesh8):
    docs = _list_docs(40)
    got, n = pmesh.reconcile_rows_sharded(_port(docs), mesh8)
    assert n == 40 and got.dtype == np.uint32
    np.testing.assert_array_equal(got, _oracle(docs))
    want, _ = ref_mesh.reconcile_rows_sharded(docs, ref_mesh8)
    np.testing.assert_array_equal(got, want.astype(np.uint32))


def test_rows_megakernel_sharded_byte_wire(mesh8, ref_mesh8):
    docs = _list_docs(40, tag=True)
    got, n = pmesh.reconcile_rows_sharded_bytes(_port(docs), mesh8)
    assert n == 40 and got.dtype == np.uint32
    np.testing.assert_array_equal(got, _oracle(docs))
    wide, _ = pmesh.reconcile_rows_sharded(_port(docs), mesh8)
    np.testing.assert_array_equal(got, wide)
    want, _ = ref_mesh.reconcile_rows_sharded_bytes(docs, ref_mesh8)
    np.testing.assert_array_equal(got, want.astype(np.uint32))


# ---------------------------------------------------------------------------
# other mesh sizes, ragged doc counts, both list-order routes


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
@pytest.mark.parametrize("n_docs", [1, 13, 130, 300])
def test_row_reconciles_on_meshes_and_ragged_doc_counts(shards, n_docs):
    docs = _list_docs(n_docs, tag=True)
    mesh = make_mesh(devices=["cpu"] * shards)
    want = _oracle(docs)
    wide, n = pmesh.reconcile_rows_sharded(_port(docs), mesh)
    narrow, n_b = pmesh.reconcile_rows_sharded_bytes(_port(docs), mesh)
    assert n == n_b == n_docs
    np.testing.assert_array_equal(wide, want)
    np.testing.assert_array_equal(narrow, want)


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("host_order", [True, False])
def test_sharded_apply_on_meshes_equals_the_reference(shards, host_order,
                                                      ref_mesh8):
    """Every apply_doc output of reconcile_sharded on 1, 2 and 4 shards
    (13 docs: padded to the shard count), with lists ordered on the host
    and by the linearize route, equals the reference's 8-device mesh."""
    docs = _list_docs(13, tag=True)
    mesh = make_mesh(devices=["cpu"] * shards)
    _, out, n = reconcile_sharded(_port(docs), mesh, host_order=host_order)
    assert out["hash"].shape[0] % shards == 0
    if host_order:
        _, ref_out, _ = ref_mesh.reconcile_sharded(docs, ref_mesh8)
    else:
        # the reference's mesh orders on the host; its apply_doc on the
        # device route is the other side (masked slots' elem_pos differ
        # between the two routes in both packages)
        from automerge_tpu.engine.kernels import apply_doc as ref_apply_doc
        _, batch, mf = ref_mesh.encode_padded_batch(docs, ref_mesh8)
        ref_out = ref_apply_doc(batch, mf, host_order=False)
    _same_outputs(out, ref_out, n)


def test_shard_batch_places_contiguous_ranges(ref_mesh8):
    ref_docs = _doc_changes(13)
    mesh = make_mesh(devices=CPU8)
    _, batch, max_fids = pmesh.encode_padded_batch(_port(ref_docs), mesh)
    _, ref_batch, ref_mf = ref_mesh.encode_padded_batch(
        ref_docs, ref_mesh.make_mesh(8))
    assert max_fids == ref_mf and batch.keys() == ref_batch.keys()
    for k in batch:
        np.testing.assert_array_equal(batch[k], ref_batch[k], err_msg=k)
    shards = shard_batch(batch, mesh)
    assert len(shards) == 8
    for k in batch:
        assert all(s[k].device == torch.device("cpu") for s in shards)
        np.testing.assert_array_equal(
            torch.cat([s[k] for s in shards]).numpy(), batch[k])
    assert [s["op_mask"].shape[0] for s in shards] == [2] * 8


def test_make_mesh_takes_the_named_devices_and_the_card_by_default():
    mesh = make_mesh(3, devices=CPU8)
    assert mesh.size == 3 and mesh.axis_name == "docs"
    assert not mesh.spans_processes
    if torch.cuda.is_available():
        assert make_mesh().devices[0].type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh(devices=["cuda:0"])


def test_row_reconcile_refuses_a_mesh_across_processes():
    mesh = pmesh.Mesh(["cpu", "cpu"], ranks=[0, 1])
    with pytest.raises(ValueError, match="reconcile_global"):
        pmesh.reconcile_rows_sharded(_port(_doc_changes(2)), mesh)
    with pytest.raises(ValueError, match="reconcile_global"):
        pmesh.reconcile_rows_sharded_bytes(_port(_doc_changes(2)), mesh)


def test_clock_union_checks_its_input(mesh8):
    with pytest.raises(ValueError, match="int32"):
        global_clock_union(torch.zeros((4, 3), dtype=torch.int64), mesh8)
