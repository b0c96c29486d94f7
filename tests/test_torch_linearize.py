"""The linearize kernel's algorithm (`csrc/linearize.cu`) on the CPU: its
numpy model (`linearize_schedule.schedule_model`: the record sort, the
causal verdict per row, the preorder's successors by pointer jumping on
causal rows, the reference's walk on the others, doubling until no
pointer is left) against `kernels.linearize_plain` and the reference's
vmapped `linearize`. Tolerance: exact (int32 positions, masked slots
included). Inputs are made from fixed numpy seeds."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from automerge_tpu.engine import kernels as ref_kernels

from automerge_tpu_torch.engine.kernels import _ceil_log2, linearize_plain
from automerge_tpu_torch.engine.resident import ResidentDocSet
from automerge_tpu_torch.linearize_schedule import (SHORT_MAX, causal_rows,
                                                    schedule_model)
from automerge_tpu_torch.workloads import (causal_linearize,
                                           mixed_linearize,
                                           random_linearize, text_fleet)


def _hold(args):
    """The model's result on numpy args, after holding its positions to
    linearize_plain and to the reference, bit for bit."""
    got = schedule_model(*args)
    plain = linearize_plain(*(torch.from_numpy(a) for a in args)).numpy()
    ref = np.asarray(jax.vmap(ref_kernels.linearize)(
        *(jnp.asarray(a) for a in args)))
    np.testing.assert_array_equal(plain, ref)
    np.testing.assert_array_equal(got["elem_pos"], plain)
    return got


def _chain_row(e, rng):
    """One causal row of e live slots: a random tree over keys that grow
    with depth (the engine's counters), random actors."""
    parent = np.array([-1] + [int(rng.integers(-1, s)) for s in range(1, e)])
    elem = np.zeros(e, np.int64)
    for s in range(e):
        elem[s] = (elem[parent[s]] if parent[s] >= 0 else 0) + 1 + \
            int(rng.integers(0, 3))
    return (np.ones((1, e), bool), elem[None].astype(np.int32),
            rng.integers(0, 4, (1, e)).astype(np.int32),
            parent[None].astype(np.int32))


@pytest.mark.parametrize("r,e", [(8, 1), (16, 2), (32, 8), (12, 33),
                                 (8, 257)])
def test_model_on_random_rows(r, e):
    """random_linearize's row kinds (RGA rows with masked parents, random
    parents past the array, self-loops, all-masked rows, equal keys):
    all-masked rows are causal, the others mostly take the walk."""
    args = random_linearize(np.random.default_rng(7 * r + e), r, e)
    got = _hold(args)
    empty = ~args[0].any(1)
    assert got["causal"][empty].all()
    np.testing.assert_array_equal(got["doublings"][empty], 0)
    np.testing.assert_array_equal(got["elem_pos"][empty], -1)


@pytest.mark.parametrize("gen", [causal_linearize, mixed_linearize])
@pytest.mark.parametrize("r,e", [(16, 1), (16, 3), (64, 8), (16, 32),
                                 (16, 33), (8, 256)])
def test_model_on_causal_and_mixed_rows(gen, r, e):
    """causal_linearize's rows (random trees with equal keys, every slot a
    child of the head, one chain) all take the parallel path; in
    mixed_linearize's batches the causal rows (even) do."""
    args = gen(np.random.default_rng(r * e + 3), r, e)
    got = _hold(args)
    want = causal_rows(*args)
    np.testing.assert_array_equal(got["causal"], want)
    assert want[0::2].all()
    if gen is causal_linearize:
        assert want.all()
    steps = _ceil_log2(e + 1)
    assert (got["doublings"] <= steps).all()
    assert (got["jumps"][got["causal"]] <= steps).all()
    if e > SHORT_MAX and gen is causal_linearize:
        # rows r % 8 >= 4 spread their keys: both record codes run
        assert got["narrow"][:4].all() and not got["narrow"][4:8].any()


@pytest.mark.parametrize("e", [2, 8, 32, 33, 256])
@pytest.mark.parametrize("how", ["later", "self", "past", "masked"])
def test_one_slot_breaks_causality(e, how):
    """A causal row with one slot's parent moved to a later slot, to
    itself, past the array or to a masked slot: the row takes the walk
    and still equals the reference."""
    rng = np.random.default_rng(e)
    mask, elem, actor, parent = _chain_row(e, rng)
    assert causal_rows(mask, elem, actor, parent).all()
    _hold((mask, elem, actor, parent))
    s = int(rng.integers(0, e - 1))
    key = np.lexsort((np.arange(e), actor[0], elem[0]))
    if how == "later":
        parent[0, s] = key[-1] if key[-1] != s else key[-2]
    elif how == "self":
        parent[0, s] = s
    elif how == "past":
        parent[0, s] = e + 1
    else:
        q = int(rng.integers(0, e))
        q = q if q != s else (s + 1) % e
        mask[0, q] = False
        parent[0, s] = q
    got = _hold((mask, elem, actor, parent))
    assert not got["causal"][0]


@pytest.mark.parametrize("shape", ["head", "chain"])
def test_head_children_and_single_chain_at_256(shape):
    """Every slot a child of the head (the order comes out descending) and
    a single chain (ascending), E = 256, every slot live."""
    e = 256
    rng = np.random.default_rng(256)
    elem = rng.permutation(e).astype(np.int32) + 1
    actor = rng.integers(0, 3, (1, e)).astype(np.int32)
    order = np.argsort(elem)
    parent = np.full(e, -1, np.int64)
    if shape == "chain":
        parent[order[1:]] = order[:-1]
    args = (np.ones((1, e), bool), elem[None], actor,
            parent[None].astype(np.int32))
    got = _hold(args)
    assert got["causal"][0]
    rank = np.empty(e, np.int64)
    rank[order] = np.arange(e)
    want = e - 1 - rank if shape == "head" else rank
    np.testing.assert_array_equal(got["elem_pos"][0], want)
    if shape == "head":
        assert got["jumps"][0] == 0
    else:
        assert got["jumps"][0] == _ceil_log2(e)


@pytest.mark.parametrize("seed", range(6))
def test_model_on_seeded_batches(seed):
    """Seeded batches of every generator at a random width: the model,
    the plain version and the reference agree."""
    rng = np.random.default_rng(1000 + seed)
    e = int(rng.integers(1, 80))
    for gen in (random_linearize, causal_linearize, mixed_linearize):
        _hold(gen(rng, 12, e))


def test_text_fleet_rows_all_take_the_parallel_path():
    """The text fleet's list rows, as the docs-major engine holds them
    after its change streams (four actors typing after their own cursors,
    deletes as tombstones): every row is causal, and the model's positions
    equal linearize_plain's and the reference's."""
    ids, rounds = text_fleet(n_docs=12, chars=24, chars_per_change=4,
                             rounds=3, seed=5)
    ds = ResidentDocSet(ids, device="cpu")
    for rnd in rounds:
        ds.apply_and_reconcile(rnd)
    s = ds.state
    d, n_lists, n_elems = s["ins_mask"].shape
    args = [s[k].reshape(d * n_lists, n_elems).numpy()
            for k in ("ins_mask", "ins_elem", "ins_actor", "ins_parent")]
    got = _hold(args)
    live = args[0].any(1)
    assert live.sum() >= len(ids)
    assert got["causal"].all()
    assert (got["jumps"][live] > 0).all()
