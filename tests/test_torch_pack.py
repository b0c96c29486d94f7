"""The port's host encoding and row packing against the reference's, byte
for byte, on the same change sets (the reference's Change objects go to the
port through their wire dicts)."""

import numpy as np
import pytest
import torch

from automerge_tpu.engine import encode as ref_encode
from automerge_tpu.engine import pack as ref_pack
from automerge_tpu.native.linearize import linearize_host as ref_linearize

from automerge_tpu_torch.engine import encode, pack
from automerge_tpu_torch.engine.kernels import _mix, _mix4
from automerge_tpu_torch.native.linearize import linearize_host

from torch_port_helpers import to_port
from test_torch_rows import history


def _doc_sets():
    return [
        [history(1, lists=False), history(2, lists=False)],
        [history(3), history(4, actors=("A", "B", "C", "D")), history(5)],
    ]


@pytest.mark.parametrize("case", [0, 1], ids=["maps", "lists_and_text"])
def test_encode_stack_pack_rows_byte_equal(case):
    docs = _doc_sets()[case]
    actors = sorted({c.actor for chs in docs for c in chs})
    ref_batch = ref_encode.stack_docs(
        [ref_encode.encode_doc(chs, actors) for chs in docs])
    port_batch = encode.stack_docs(
        [encode.encode_doc(to_port(chs), actors) for chs in docs])
    assert ref_batch.keys() == port_batch.keys()
    for k in ref_batch:
        np.testing.assert_array_equal(np.asarray(port_batch[k]),
                                      np.asarray(ref_batch[k]), err_msg=k)
    mf = ref_batch.pop("max_fids")
    port_batch.pop("max_fids")
    ref_rows, ref_dims, ref_n = ref_pack.pack_rows(ref_batch, mf)
    rows, dims, n = pack.pack_rows(port_batch, mf)
    assert (dims, n) == (ref_dims, ref_n)
    assert rows.dtype == ref_rows.dtype == np.int32
    assert rows.tobytes() == ref_rows.tobytes()
    dev = pack.rows_from_numpy(ref_rows, ref_dims, "cpu")
    assert dev.dtype == torch.int32 and dev.numpy().tobytes() == rows.tobytes()


def test_layout_constants_and_bases_match():
    assert pack.ROW_FIELDS == ref_pack.ROW_FIELDS
    assert pack.LANE == ref_pack.LANE
    assert (pack.ROWS_MAX_OPS, pack.ROWS_MAX_ELEMS, pack.ROWS_VMEM_BUDGET) \
        == (ref_pack.ROWS_MAX_OPS, ref_pack.ROWS_MAX_ELEMS,
            ref_pack.ROWS_VMEM_BUDGET)
    for i, a, le in [(8, 2, 8), (64, 4, 64), (512, 2, 8), (512, 8, 512),
                     (1024, 3, 0)]:
        assert pack.row_bases(i, a, le) == ref_pack.row_bases(i, a, le)
        assert pack.rows_count(i, a, le) == ref_pack.rows_count(i, a, le)
        assert pack.rows_dims_eligible(i, a, le) == \
            ref_pack.rows_dims_eligible(i, a, le)
    for n in (0, 1, 127, 128, 129, 10_000):
        assert pack.pad_to_lanes(n) == ref_pack.pad_to_lanes(n)


def test_action_codes_and_hashes_match():
    for name in ("A_MAKE_MAP", "A_MAKE_LIST", "A_MAKE_TEXT", "A_INS", "A_SET",
                 "A_DEL", "A_LINK", "A_MOVE"):
        assert getattr(encode, name) == getattr(ref_encode, name)
    for s in ("", "A", "actor-ü", "00000000-0000-0000-0000-000000000000\x00k"):
        assert encode.content_hash(s) == ref_encode.content_hash(s)
    for v in (None, True, 0, -3, 2.5, "x", ("__link__", "obj")):
        assert encode.value_hash_of(v) == ref_encode.value_hash_of(v)
    for n, m in [(0, 8), (9, 8), (700, 8), (3, 1), (3, 2)]:
        assert encode._pad_to(n, m) == ref_encode._pad_to(n, m)


def test_mix_matches_uint32_reference():
    from automerge_tpu.engine.kernels import _mix as ref_mix
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(ref_mix(jnp.asarray(x)))
    got = _mix(torch.from_numpy(x.astype(np.int64))).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, want)
    cols = [rng.integers(-2**31, 2**31, size=64, dtype=np.int64)
            .astype(np.int32) for _ in range(4)]
    from automerge_tpu.engine.pallas_kernels import _mix4_i32
    want4 = np.asarray(_mix4_i32(*map(jnp.asarray, cols))).view(np.uint32)
    got4 = _mix4(*map(torch.from_numpy, cols)).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got4, want4)


@pytest.mark.parametrize("seed", range(3))
def test_linearize_host_matches(seed):
    rng = np.random.default_rng(seed)
    n = 40
    parent = np.array([-1] + [int(rng.integers(-1, i)) for i in range(1, n)],
                      np.int32)
    # (elem counter, actor) is unique per element, as in a real list
    elem = (rng.permutation(n) + 1).astype(np.int32)
    actor = rng.integers(0, 3, size=n).astype(np.int32)
    mask = np.ones(n, bool)
    np.testing.assert_array_equal(
        linearize_host(mask, elem, actor, parent),
        ref_linearize(mask, elem, actor, parent))


def test_rows_from_numpy_validates_shape():
    dims = (8, 2, 8, 4, 5)
    with pytest.raises(ValueError, match="int32"):
        pack.rows_from_numpy(np.zeros((5, 128), np.int64), dims, "cpu")
    with pytest.raises(ValueError, match="does not match"):
        pack.rows_from_numpy(np.zeros((5, 128), np.int32), dims, "cpu")
    rows = np.zeros((pack.rows_count(8, 2, 8), 128), np.int32)
    t = pack.rows_from_numpy(rows, dims, "cpu")
    rows[0, 0] = 7
    assert int(t[0, 0]) == 0          # a copy, never an alias
