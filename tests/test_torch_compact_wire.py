"""The port's compact row wires and field sharding
(`automerge_tpu_torch/engine/pack.py`) held to the reference's on the CPU.

Through `torch_twin_helpers.run_twin`, the cases of the reference's
`tests/test_compact_wire.py` run on both packages. On the port's run the
module's `jax` is a host stand-in (`jit` returns the function,
`numpy.asarray` is numpy's), and the device-side functions are bound to
the port's through adapters that take numpy and return numpy (the hash
bits as np.uint32): `widen_rows`, `widen_bytes`, `apply_rows_hash`,
`apply_rows_hash_compact` and `apply_rows_hash_bytes` on `device="cpu"`,
where the reconcile runs its plain version. No case is left out.

Then, on seeded random batches (`test_torch_rows.history`, long enough
that seq and clock counters leave int8) and on the shapes of bench
configs 1-5 (the reference's `bench.py` generators, cut to small sizes
where they take a size): `classify_row_groups`, `pack_rows_compact` and
`pack_rows_bytes` byte-equal to the reference's (buffers, dtypes, meta,
bmeta); the port's widen equal to the wide `pack_rows` buffer; the port's
hashes through both wires equal to the reference's `apply_rows_hash_
compact` / `_bytes` with `interpret=True`; `shard_batch_by_fields` and
`select_field_sharding` arrays, dtypes and `owner` equal, and
`recombine_hashes` equal; the capacity check raising the same error where
the reference's does. Tolerance: exact.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_port_helpers import load_bench, to_port
from torch_twin_helpers import collect, hygiene_teardown, run_twin
from test_torch_rows import history

from automerge_tpu.engine import encode as ref_encode
from automerge_tpu.engine import pack as ref_pack

from automerge_tpu_torch.engine import encode, pack
from automerge_tpu_torch.engine.cuda_kernels import hashes_to_numpy


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _hashes(h) -> np.ndarray:
    return hashes_to_numpy(h)


def _apply_rows_hash(rows, dims, n_docs, interpret=False):
    return _hashes(pack.apply_rows_hash(_t(rows), dims, n_docs))


def _apply_rows_hash_compact(b8, b16, b32, meta, dims, interpret=False):
    return _hashes(pack.apply_rows_hash_compact(
        *(np.asarray(b) for b in (b8, b16, b32)), meta, dims, device="cpu"))


def _apply_rows_hash_bytes(wire, bmeta, dims, interpret=False):
    return _hashes(pack.apply_rows_hash_bytes(np.asarray(wire), bmeta, dims,
                                              device="cpu"))


_apply_rows_hash_bytes.__wrapped__ = _apply_rows_hash_bytes
_apply_rows_hash_compact.__wrapped__ = _apply_rows_hash_compact


def _widen_rows(b8, b16, b32, meta):
    return pack.widen_rows(_t(b8), _t(b16), _t(b32), meta).numpy()


def _widen_bytes(wire, bmeta):
    return pack.widen_bytes(_t(wire), bmeta).numpy()


#: the port run's `jax`: the reference cases call jax only to move numpy
#: to a device and back, and to jit a function
HOST_JAX = types.SimpleNamespace(
    jit=lambda fn, **_: fn,
    numpy=types.SimpleNamespace(asarray=np.asarray),
    default_backend=lambda: "cpu")

ADAPTERS = {
    jax: HOST_JAX,
    ref_pack.widen_rows: _widen_rows,
    ref_pack.widen_bytes: _widen_bytes,
    ref_pack.apply_rows_hash: _apply_rows_hash,
    ref_pack.apply_rows_hash_compact: _apply_rows_hash_compact,
    ref_pack.apply_rows_hash_bytes: _apply_rows_hash_bytes,
}

CASES = collect("test_compact_wire", adapters=ADAPTERS)


@pytest.fixture(autouse=True)
def _hygiene():
    yield
    hygiene_teardown()


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reference_case_on_both_packages(case, tmp_path, monkeypatch):
    run_twin(case, tmp_path, monkeypatch)


# ---------------------------------------------------------------------------
# byte equality on seeded batches and bench shapes


def _batches(doc_changes):
    """(reference batch, port batch, max_fids) of the same change sets."""
    actors = sorted({c.actor for chs in doc_changes for c in chs})
    ref = ref_encode.stack_docs(
        [ref_encode.encode_doc(chs, actors) for chs in doc_changes])
    port = encode.stack_docs(
        [encode.encode_doc(to_port(chs), actors) for chs in doc_changes])
    mf = ref.pop("max_fids")
    assert port.pop("max_fids") == mf
    return ref, port, int(mf)


def _seeded(seed):
    """Seeded multi-doc histories; the long ones take seq and the clock
    counters past int8."""
    rng = np.random.default_rng(seed)
    return [history(int(rng.integers(1 << 30)),
                    actors=("A", "B", "C", "D")[:int(rng.integers(1, 5))],
                    steps=int(rng.integers(8, 160)),
                    lists=bool(rng.integers(2)))
            for _ in range(int(rng.integers(2, 6)))]


_BENCH_SIZES = {"gen_lww_storm": (60,), "gen_trellis": (2,),
                "gen_text_trace": (60,), "gen_tombstone_list": (80,),
                "gen_docset": (40,)}


def _bench(name):
    bench = load_bench()
    bench._load_package()
    return getattr(bench, name)(*_BENCH_SIZES[name])


WIRE_INPUTS = ([("seed", s) for s in (1, 2, 3, 4)]
               + [("bench", n) for n in _BENCH_SIZES])


def _doc_changes(kind, arg):
    return _seeded(arg) if kind == "seed" else _bench(arg)


def _assert_same_bufs(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind,arg", WIRE_INPUTS,
                         ids=[f"{k}-{a}" for k, a in WIRE_INPUTS])
def test_wires_byte_equal_and_hashes_equal_the_reference(kind, arg):
    dc = _doc_changes(kind, arg)
    ref, port, mf = _batches(dc)
    assert pack.rows_eligible(port, mf) == ref_pack.rows_eligible(ref, mf)
    if not pack.rows_eligible(port, mf):
        pytest.skip("past both envelopes (held by the sharding test)")
    rows, dims, n = pack.pack_rows(port, mf)
    ref_rows, _, _ = ref_pack.pack_rows(ref, mf)
    np.testing.assert_array_equal(rows, ref_rows)
    assert pack.classify_row_groups(rows, dims, mf) \
        == ref_pack.classify_row_groups(ref_rows, dims, mf)

    bufs, meta, dims_c, n_c = pack.pack_rows_compact(port, mf)
    rbufs, rmeta, rdims, rn = ref_pack.pack_rows_compact(ref, mf)
    assert (meta, dims_c, n_c) == (rmeta, rdims, rn)
    _assert_same_bufs(bufs, rbufs)
    wire, bmeta, dims_b, n_b = pack.pack_rows_bytes(port, mf)
    rwire, rbmeta, _, _ = ref_pack.pack_rows_bytes(ref, mf)
    assert bmeta == rbmeta and (dims_b, n_b) == (dims, n)
    assert wire.dtype == rwire.dtype == np.uint8
    np.testing.assert_array_equal(wire, rwire)

    # the widen on the CPU rebuilds the wide buffer
    np.testing.assert_array_equal(
        pack.widen_rows(*(_t(b) for b in bufs), meta).numpy(), rows)
    np.testing.assert_array_equal(pack.widen_bytes(_t(wire), bmeta).numpy(),
                                  rows)

    # hashes through both wires equal the reference's in interpret mode
    want = np.asarray(ref_pack.apply_rows_hash_compact(
        *(jnp.asarray(b) for b in rbufs), rmeta, rdims, True)).astype(
            np.uint32)
    np.testing.assert_array_equal(
        _hashes(pack.apply_rows_hash_compact(*bufs, meta, dims,
                                             device="cpu")), want)
    want_b = np.asarray(ref_pack.apply_rows_hash_bytes.__wrapped__(
        jnp.asarray(rwire), rbmeta, rdims, True)).astype(np.uint32)
    np.testing.assert_array_equal(want_b, want)
    np.testing.assert_array_equal(
        _hashes(pack.apply_rows_hash_bytes(wire, bmeta, dims,
                                           device="cpu")), want)
    # tensors already on the CPU go through unchanged
    np.testing.assert_array_equal(
        _hashes(pack.apply_rows_hash_bytes(_t(wire), bmeta, dims,
                                           device="cpu")), want)


def _assert_same_batch(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("target", [64, 128, 512])
@pytest.mark.parametrize("kind,arg", [("seed", 5), ("seed", 6),
                                      ("bench", "gen_lww_storm"),
                                      ("bench", "gen_trellis"),
                                      ("bench", "gen_docset")])
def test_field_sharding_equals_the_reference(kind, arg, target):
    dc = _doc_changes(kind, arg)
    ref, port, mf = _batches(dc)
    got, owner = pack.shard_batch_by_fields(port, mf, target)
    want, rowner = ref_pack.shard_batch_by_fields(ref, mf, target)
    _assert_same_batch(got, want)
    assert owner.dtype == rowner.dtype
    np.testing.assert_array_equal(owner, rowner)
    if not pack.rows_eligible(got, mf):
        return
    rows, dims, nv = pack.pack_rows(got, mf)
    vh = pack.apply_rows_hash(_t(rows), dims, nv)
    real = pack.recombine_hashes(vh, owner, len(dc))
    rvh = np.asarray(ref_pack.apply_rows_hash(jnp.asarray(rows), dims, nv,
                                              interpret=True))
    np.testing.assert_array_equal(
        real, ref_pack.recombine_hashes(rvh, rowner, len(dc)))
    np.testing.assert_array_equal(
        pack.recombine_hashes(_hashes(vh), owner, len(dc)), real)
    # the split hashes sum back to the unsplit documents'
    if pack.rows_eligible(port, mf):
        whole, wdims, _ = pack.pack_rows(port, mf)
        np.testing.assert_array_equal(
            real, _hashes(pack.apply_rows_hash(_t(whole), wdims, len(dc))))


def test_select_field_sharding_on_config_1_equals_the_reference():
    """Bench config 1 at its own width (2,048 op slots): past both
    envelopes, split at 512 into 5 virtual docs by both packages."""
    dc = _bench_full("gen_lww_storm")
    ref, port, mf = _batches(dc)
    assert not pack.rows_eligible(port, mf)
    got, owner, target = pack.select_field_sharding(port, mf)
    want, rowner, rtarget = ref_pack.select_field_sharding(ref, mf)
    assert (target, len(owner)) == (rtarget, len(rowner)) == (512, 5)
    _assert_same_batch(got, want)
    np.testing.assert_array_equal(owner, rowner)


def _bench_full(name):
    bench = load_bench()
    bench._load_package()
    return getattr(bench, name)()


def test_select_field_sharding_refuses_where_the_reference_does():
    """Actors, not ops, past the envelope: neither package finds a split."""
    port = {"op_mask": np.zeros((1, 1024), bool),
            "clock": np.zeros((1, 1, 64), np.int32),
            "ins_mask": np.zeros((1, 4, 256), bool)}
    assert pack.select_field_sharding(port, 8) == (None, None, None) \
        == ref_pack.select_field_sharding(port, 8)


def test_capacity_check_raises_where_the_reference_does():
    """A max_fids below the batch's field ids: the fid group is declared
    int8 and holds 199, so both packages refuse to narrow it."""
    import automerge_tpu as am
    d = am.change(am.init("A"), lambda x: am.assign(
        x, {f"k{i}": i for i in range(200)}))
    ref, port, mf = _batches([d._doc.opset.get_missing_changes({})])
    assert mf >= 200
    with pytest.raises(ValueError) as want:
        ref_pack.pack_rows_compact(ref, 1)
    with pytest.raises(ValueError) as got:
        pack.pack_rows_compact(port, 1)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        pack.pack_rows_bytes(port, 1)
    # within capacity both narrow alike
    assert pack.pack_rows_compact(port, mf)[1] \
        == ref_pack.pack_rows_compact(ref, mf)[1]


def test_narrow_dtype_and_width_classes_equal_the_reference():
    for lo, hi in ((0, 0), (-1, 127), (-129, 5), (0, 128), (-32768, 32767),
                   (0, 32768), (-(1 << 31), (1 << 31) - 1)):
        part = np.asarray([lo, hi], np.int64)
        assert pack._narrow_dtype(part) == ref_pack._narrow_dtype(part)
        assert pack._width_of_bound(lo, hi) == ref_pack._width_of_bound(lo,
                                                                        hi)
    assert pack._CAP_GROUPS == ref_pack._CAP_GROUPS
    assert pack._HASH_GROUPS == ref_pack._HASH_GROUPS


def test_wire_entry_points_default_to_the_card():
    """Without a card the default device raises; nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    dc = _seeded(9)
    _, port, mf = _batches(dc)
    bufs, meta, dims, _ = pack.pack_rows_compact(port, mf)
    wire, bmeta, _, _ = pack.pack_rows_bytes(port, mf)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pack.apply_rows_hash_compact(*bufs, meta, dims)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pack.apply_rows_hash_bytes(wire, bmeta, dims)
