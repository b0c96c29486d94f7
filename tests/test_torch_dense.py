"""The quarantined dense reconcile (`engine/experimental_dense.py`) on the
port, on the CPU.

- Against the reference: the port's `reconcile_dense(device="cpu")` and the
  reference's (plain XLA on the CPU) on seeded random batches made with
  numpy (a few docs, narrow dims; out-of-range fids, actors and change
  indexes among them), key by key, in both `host_order` modes.
- Against `apply_doc`: the port's dense path and its `kernels.apply_doc`
  on encoded batches of bench config 5's docset fleet and the text fleet.
- The reference's own `TestDensePathParity` on both packages through
  `torch_twin_helpers` (bench configs 1 and 2 run in
  tests/test_torch_bench_shapes.py).
- The refusals: the budget's ValueError (the reference's message) and the
  quarantine on a CUDA device without AMTPU_ALLOW_DENSE_ON_DEVICE=1, both
  raised before any device work.

Tolerance: exact (integer and boolean outputs, uint32 hashes).
"""

import numpy as np
import pytest
import torch

from torch_twin_helpers import collect, hygiene_teardown, run_twin

from automerge_tpu.engine import experimental_dense as ref_xd

from automerge_tpu_torch import workloads
from automerge_tpu_torch.engine import experimental_dense as xd
from automerge_tpu_torch.engine.encode import encode_doc, stack_docs
from automerge_tpu_torch.engine.kernels import apply_doc


@pytest.fixture(autouse=True)
def _hygiene():
    yield
    hygiene_teardown()


def random_batch(seed: int, d: int = 3, i: int = 24, c: int = 8,
                 a: int = 3, l: int = 2, e: int = 12, f: int = 16):
    """A stacked batch of random columns (encode.stack_docs's keys) with
    max_fids f: masked and unmasked ops of every action, fids, actors and
    change indexes partly out of range, list rows from
    workloads.random_linearize and a random host order."""
    rng = np.random.default_rng(seed)

    def ints(lo, hi, shape):
        return rng.integers(lo, hi, shape).astype(np.int32)

    mask, elem, actor, parent = workloads.random_linearize(rng, d * l, e)
    return {
        "op_mask": rng.random((d, i)) < 0.8,
        "action": ints(-1, 6, (d, i)),
        "fid": ints(-1, f + 2, (d, i)),
        "actor": ints(-1, a + 1, (d, i)),
        "seq": ints(0, 6, (d, i)),
        "change_idx": ints(-1, c + 1, (d, i)),
        "value": ints(-1, 50, (d, i)),
        "fid_hash": ints(-2**31, 2**31 - 1, (d, i)),
        "value_hash": ints(-2**31, 2**31 - 1, (d, i)),
        "clock": ints(0, 6, (d, c, a)),
        "ins_mask": mask.reshape(d, l, e),
        "ins_elem": elem.reshape(d, l, e),
        "ins_actor": actor.reshape(d, l, e),
        "ins_parent": parent.reshape(d, l, e),
        "ins_fid": ints(-1, f + 1, (d, l, e)),
        "ins_pos": np.stack([rng.permutation(e) for _ in range(d * l)]
                            ).reshape(d, l, e).astype(np.int32),
        "list_obj_hash": ints(-2**31, 2**31 - 1, (d, l)),
        "actor_hash": ints(-2**31, 2**31 - 1, (d, a)),
    }, f


def as_numpy(out: dict) -> dict:
    """Outputs as numpy, the hash as its uint32 bits."""
    got = {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
           for k, v in out.items()}
    got["hash"] = got["hash"].view(np.uint32) \
        if got["hash"].dtype == np.int32 else got["hash"]
    return got


def assert_same(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("host_order", [True, False])
@pytest.mark.parametrize("seed", range(5))
def test_dense_equals_the_reference_dense_on_random_batches(seed,
                                                            host_order):
    batch, f = random_batch(seed)
    want = as_numpy(ref_xd.reconcile_dense(batch, f, host_order=host_order))
    got = as_numpy(xd.reconcile_dense(batch, f, host_order=host_order,
                                      device="cpu"))
    assert_same(got, want)


@pytest.mark.parametrize("host_order", [True, False])
def test_dense_equals_the_reference_dense_on_wide_lists(host_order):
    """Longer list rows (E = 40) and more actors than the default."""
    batch, f = random_batch(7, d=2, i=40, c=12, a=6, l=3, e=40, f=24)
    want = as_numpy(ref_xd.reconcile_dense(batch, f, host_order=host_order))
    got = as_numpy(xd.reconcile_dense(batch, f, host_order=host_order,
                                      device="cpu"))
    assert_same(got, want)


def fleet_batch(doc_changes):
    actors = sorted({c.actor for chs in doc_changes for c in chs})
    batch = stack_docs([encode_doc(chs, actors) for chs in doc_changes])
    mf = int(batch.pop("max_fids"))
    return {k: torch.from_numpy(v) for k, v in batch.items()}, mf


def docset_slice(n_docs: int = 64):
    ids, initial, rounds = workloads.docset_fleet(n_docs, rounds=3)
    return [initial[d] + [c for r in rounds for c in r.get(d, [])]
            for d in ids]


def text_slice(n_docs: int = 16):
    ids, rounds = workloads.text_fleet(n_docs=n_docs, chars=16)
    return [[c for r in rounds for c in r.get(d, [])] for d in ids]


@pytest.mark.parametrize("host_order", [True, False])
@pytest.mark.parametrize("fleet", ["docset", "text"])
def test_dense_equals_apply_doc_on_encoded_fleets(fleet, host_order):
    doc_changes = docset_slice() if fleet == "docset" else text_slice()
    batch, mf = fleet_batch(doc_changes)
    assert xd.dense_cost(batch, mf) <= xd.DENSE_BUDGET
    want = as_numpy(apply_doc(batch, mf, host_order=host_order))
    got = as_numpy(xd.reconcile_dense(batch, mf, host_order=host_order))
    assert_same(got, want)


def test_a_tensor_batch_stays_on_its_device():
    batch, mf = fleet_batch(docset_slice(8))
    out = xd.reconcile_dense(batch, mf)
    assert all(v.device.type == "cpu" for v in out.values())
    assert out["hash"].dtype == torch.int32


def over_budget():
    """A batch whose fid one-hot ([D, F, I]) is past DENSE_BUDGET while its
    arrays stay small: 4,096 docs x 64 op slots, max_fids 256."""
    batch, _ = random_batch(0, d=4096, i=64, c=8, a=2, l=1, e=8, f=256)
    return batch, 256


def test_budget_refusal_gives_the_reference_message():
    batch, mf = over_budget()
    assert xd.dense_cost(batch, mf) == ref_xd.dense_cost(batch, mf) \
        > xd.DENSE_BUDGET == ref_xd.DENSE_BUDGET
    with pytest.raises(ValueError) as want:
        ref_xd.reconcile_dense(batch, mf)
    with pytest.raises(ValueError) as got:
        xd.reconcile_dense(batch, mf, device="cpu")
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith("dense reconcile refused")


@pytest.mark.parametrize("device", ["cuda", "cuda:0", None])
def test_quarantined_on_a_cuda_device_without_the_opt_in(device,
                                                         monkeypatch):
    """Without the variable a CUDA device (or a numpy batch with no device,
    which goes to the card) raises before any device work, so it raises
    here too, where there is no card."""
    monkeypatch.delenv(xd.ALLOW_ENV, raising=False)
    batch, mf = random_batch(1)
    with pytest.raises(NotImplementedError, match="quarantined"):
        xd.reconcile_dense(batch, mf, device=device)


def test_the_opt_in_lifts_the_quarantine_before_the_budget(monkeypatch):
    """With AMTPU_ALLOW_DENSE_ON_DEVICE=1 the guard passes and the budget
    check comes next, still before any device memory is committed."""
    monkeypatch.setenv(xd.ALLOW_ENV, "1")
    batch, mf = over_budget()
    with pytest.raises(ValueError, match="dense reconcile refused"):
        xd.reconcile_dense(batch, mf, device="cuda")


def test_the_cpu_needs_no_opt_in(monkeypatch):
    monkeypatch.delenv(xd.ALLOW_ENV, raising=False)
    batch, mf = random_batch(2)
    out = xd.reconcile_dense(batch, mf, device="cpu")
    assert out["hash"].shape == (3,)


PARITY = [c for c in collect("test_engine_parity")
          if c.cls is not None and c.cls.__name__ == "TestDensePathParity"]


def test_the_parity_class_has_its_case():
    assert [c.name for c in PARITY] == ["test_dense_matches_segment"]


@pytest.mark.parametrize("case", PARITY, ids=lambda c: c.id)
def test_reference_dense_case_on_both_packages(case, tmp_path, monkeypatch):
    run_twin(case, tmp_path, monkeypatch)
