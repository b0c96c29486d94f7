"""The domination kernel B5's plain version against the reference: the
pairwise definition the reference's Pallas test holds (reference_dominated)
and the Pallas kernel itself in interpret mode. Inputs are made from a seed
with numpy; tolerance: exact (boolean flags).

On the CPU the port's wrapper runs its plain version, so `dominated` on a
CPU tensor is the function under test here; tests/test_torch_cuda.py holds
the CUDA kernel to it on the card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from automerge_tpu.engine.pallas_kernels import dominated_pallas

from automerge_tpu_torch.engine import cuda_kernels
from automerge_tpu_torch.engine.cuda_kernels import dominated, dominated_plain
from automerge_tpu_torch.workloads import random_dominated

from test_pallas_kernels import random_case, reference_dominated


def _port(args):
    clock_op, actor, fid, seq, change_idx, amask = args
    return dominated(*(torch.from_numpy(np.ascontiguousarray(x)) for x in (
        clock_op, actor, fid, seq, change_idx, amask))).numpy()


@pytest.mark.parametrize("seed", range(5))
def test_matches_reference_and_pallas_on_random_cases(seed):
    args = random_case(np.random.default_rng(seed))
    want = reference_dominated(*args)
    pallas = np.asarray(dominated_pallas(*map(jnp.asarray, args),
                                         interpret=True))
    before = cuda_kernels.LAUNCHES["dominated"]
    got = _port(args)
    assert cuda_kernels.LAUNCHES["dominated"] == before  # CPU: no launch
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)


def test_matches_reference_and_pallas_on_a_real_batch():
    """The batch of the reference's test_engine_parity_on_real_batch."""
    import automerge_tpu as am
    from automerge_tpu.engine.encode import A_SET, encode_doc, stack_docs

    s1 = am.change(am.init("A"), lambda d: am.assign(d, {"x": 1, "y": 2}))
    s2 = am.merge(am.init("B"), s1)
    s1 = am.change(s1, lambda d: d.__setitem__("x", 10))
    s2 = am.change(s2, lambda d: am.assign(d, {"x": 20, "z": 3}))
    changes = am.merge(s1, s2)._doc.opset.get_missing_changes({})
    batch = stack_docs([encode_doc(changes, sorted({c.actor
                                                    for c in changes}))])
    clock_op = batch["clock"][np.arange(1)[:, None], batch["change_idx"]]
    amask = batch["op_mask"] & (batch["action"] >= A_SET)
    args = (clock_op, batch["actor"], batch["fid"], batch["seq"],
            batch["change_idx"], amask)
    want = reference_dominated(*args)
    assert want.any()
    pallas = np.asarray(dominated_pallas(*map(jnp.asarray, args),
                                         interpret=True))
    np.testing.assert_array_equal(_port(args), want)
    np.testing.assert_array_equal(_port(args), pallas)


@pytest.mark.parametrize("seed", range(3))
def test_full_int32_range_matches_the_integer_definition(seed):
    """Clock and seq values over the whole int32 range, where a float32
    compare is no longer exact (a third of the seqs within one of a
    clock value their pairs read)."""
    args = list(random_dominated(np.random.default_rng(100 + seed), 3, 40,
                                 4, full_range=True))
    args[1] = np.clip(args[1], 0, 3)   # the numpy definition indexes by it
    want = reference_dominated(*args)
    assert want.any() and not want.all()
    np.testing.assert_array_equal(_port(args), want)


def test_plain_version_chunks_match_one_pass():
    """Chunking over j and documents gives the flags of one unchunked
    pass (the chunk bound is lowered so every path runs)."""
    args = random_case(np.random.default_rng(7), docs=5, n=64, n_fids=4)
    tensors = [torch.from_numpy(np.ascontiguousarray(x)) for x in args]
    whole = dominated_plain(*tensors)
    saved = cuda_kernels._PLAIN_PAIR_ELEMS
    try:
        cuda_kernels._PLAIN_PAIR_ELEMS = 64 * 5
        chunked = dominated_plain(*tensors)
    finally:
        cuda_kernels._PLAIN_PAIR_ELEMS = saved
    assert torch.equal(whole, chunked)
    np.testing.assert_array_equal(whole.numpy(), reference_dominated(*args))


def test_out_of_range_actor_reads_a_zero_clock():
    """An actor outside [0, A) reads clock 0, as the Pallas kernel's
    one-hot does: such an op is dominated exactly when seq <= 0."""
    clock_op = np.full((1, 3, 2), 9, np.int32)
    actor = np.array([[-1, 2, 0]], np.int32)
    fid = np.zeros((1, 3), np.int32)
    seq = np.array([[0, 1, 5]], np.int32)
    change_idx = np.arange(3, dtype=np.int32)[None]
    amask = np.ones((1, 3), bool)
    args = (clock_op, actor, fid, seq, change_idx, amask)
    got = _port(args)
    np.testing.assert_array_equal(got, [[True, False, True]])
    pallas = np.asarray(dominated_pallas(*map(jnp.asarray, args),
                                         interpret=True))
    np.testing.assert_array_equal(got, pallas)


def test_wrapper_rejects_bad_inputs():
    args = [torch.zeros((2, 4, 3), dtype=torch.int32)] + [
        torch.zeros((2, 4), dtype=torch.int32) for _ in range(4)] + [
        torch.zeros((2, 4), dtype=torch.bool)]
    assert dominated(*args).shape == (2, 4)
    bad = list(args)
    bad[5] = bad[5].to(torch.int32)
    with pytest.raises(ValueError, match="amask"):
        dominated(*bad)
    bad = list(args)
    bad[2] = torch.zeros((2, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="fid"):
        dominated(*bad)


@pytest.mark.parametrize("seed", range(3))
def test_chip_smoke_bound_counts_the_bytes_this_data_needs(seed):
    """chip_smoke.py's bytes bound of a domination launch, against a count
    by the definition: a byte of mask and of flag per lane, four int32
    columns per live lane, and each clock cell once that an undominated
    op's field peers (other changes) or a dominated op's first dominator
    make the function read."""
    from chip_smoke import dominated_bound
    args = random_case(np.random.default_rng(200 + seed), docs=3, n=48,
                       n_fids=5)
    clock_op, actor, fid, seq, change_idx, amask = args
    d, n, a = clock_op.shape
    cells = set()
    for k in range(d):
        for i in np.flatnonzero(amask[k]):
            ok = 0 <= actor[k, i] < a
            cand = [j for j in range(n) if amask[k, j]
                    and fid[k, j] == fid[k, i]
                    and change_idx[k, j] != change_idx[k, i]]
            hits = [j for j in cand
                    if (clock_op[k, j, actor[k, i]] if ok else 0)
                    >= seq[k, i]]
            if ok:
                cells.update((k, j, int(actor[k, i]))
                             for j in (hits[:1] if hits else cand))
    want = 2 * d * n + 16 * int(amask.sum()) + 4 * len(cells)
    got = dominated_bound([torch.from_numpy(np.ascontiguousarray(x))
                           for x in args])
    assert len(cells) > 0
    assert got[2] == want
