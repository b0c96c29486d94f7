"""The port's reconcile kernel (plain PyTorch version on the CPU) against the
reference's Pallas kernel in interpret mode, on the same row buffers.

Tolerance: exact. Both compute uint32 hashes with integer arithmetic only.
The CUDA kernel itself runs on the card (`chip_smoke.py`, and
`tests/test_torch_cuda.py`)."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import automerge_tpu as am
from automerge_tpu.engine.encode import encode_doc, stack_docs
from automerge_tpu.engine.pack import pack_rows
from automerge_tpu.engine.pallas_kernels import \
    reconcile_rows_hash as ref_reconcile

from automerge_tpu_torch.engine import cuda_kernels
from automerge_tpu_torch.engine.cuda_kernels import (
    hashes_to_numpy, reconcile_rows_hash, reconcile_rows_hash_plain,
    rows_dims_eligible_xl)
from automerge_tpu_torch.engine.pack import (apply_rows_hash, row_bases,
                                             rows_count, rows_dims_eligible,
                                             rows_from_numpy)
from automerge_tpu_torch.workloads import random_rows, reconcile_case


def _pack(doc_changes):
    actors = sorted({c.actor for chs in doc_changes for c in chs})
    batch = stack_docs([encode_doc(c, actors) for c in doc_changes])
    mf = batch.pop("max_fids")
    return pack_rows(batch, mf)


def _both(rows, dims, force_xl=False):
    ref = np.asarray(ref_reconcile(jnp.asarray(rows), dims, True, force_xl))
    got = hashes_to_numpy(reconcile_rows_hash(
        rows_from_numpy(rows, dims, "cpu"), dims, force_xl=force_xl))
    return ref, got


def _map_docs():
    docs = []
    for i in range(7):
        s1 = am.change(am.init("A"), lambda d, i=i: am.assign(
            d, {"n": i, "tag": f"t{i % 3}", "flags": {"hot": i % 2 == 0}}))
        s2 = am.merge(am.init("B"), s1)
        s1 = am.change(s1, lambda d, i=i: d.__setitem__("n", i + 1))
        s2 = am.change(s2, lambda d, i=i: am.assign(d, {"n": -i, "o": "B"}))
        m = am.merge(s1, s2)
        docs.append(m._doc.opset.get_missing_changes({}))
    return docs


def _list_docs():
    docs = []
    for _ in range(3):
        d = am.change(am.init("A"), lambda doc: doc.__setitem__("xs", []))
        for j in range(4):
            d = am.change(d, lambda doc, j=j: doc["xs"].insert_at(j, j * 10))
        d = am.change(d, lambda doc: doc["xs"].delete_at(1))
        r = am.merge(am.init("B"), d)
        r = am.change(r, lambda doc: doc["xs"].insert_at(0, 99))
        m = am.merge(d, r)
        docs.append(m._doc.opset.get_missing_changes({}))
    return docs


def _large_docs():
    big = am.change(am.init("A"), lambda d: d.__setitem__(
        "xs", list(range(12))))
    for i in range(130):
        big = am.change(big, lambda d, i=i: d.__setitem__(f"k{i}", i))
    b2 = am.change(am.merge(am.init("B"), big),
                   lambda d: d.__setitem__("k3", -1))
    big = am.merge(big, b2)
    changes = big._doc.opset.get_missing_changes({})
    return [changes, changes]


def _text_docs():
    rng = random.Random(9)
    docs = []
    for _ in range(2):
        def mk(d):
            d["t"] = am.Text()
            d["t"].insert_at(0, *"hello world ok")
        base = am.change(am.init("base"), mk)
        reps = {a: am.merge(am.init(a), base) for a in "AB"}
        for _step in range(30):
            a = rng.choice("AB")
            d = reps[a]
            n = len(d["t"])
            if rng.random() < 0.7 or n == 0:
                d = am.change(d, lambda x, p=rng.randint(0, n):
                              x["t"].insert_at(p, rng.choice("xyz")))
            else:
                d = am.change(d, lambda x, p=rng.randrange(n):
                              x["t"].delete_at(p))
            reps[a] = d
        m = am.merge(reps["A"], reps["B"])
        docs.append(m._doc.opset.get_missing_changes({}))
    return docs


@pytest.mark.parametrize("make", [_map_docs, _list_docs, _large_docs,
                                  _text_docs],
                         ids=["map", "lists_tombstones", "large_dims",
                              "concurrent_text"])
def test_plain_matches_reference_on_real_batches(make):
    rows, dims, n = _pack(make())
    ref, got = _both(rows, dims)
    np.testing.assert_array_equal(got, ref)
    if make is _large_docs:
        assert dims[0] >= 256


def test_force_xl_matches_reference():
    """force_xl: the reference's XL form and the port's one kernel agree
    with each other and with the base form."""
    rows, dims, n = _pack(_text_docs())
    assert dims[0] % 32 == 0 and dims[2] >= 32
    ref_xl, got_xl = _both(rows, dims, force_xl=True)
    ref_base, got_base = _both(rows, dims)
    np.testing.assert_array_equal(got_xl, ref_xl)
    np.testing.assert_array_equal(got_xl, ref_base)
    np.testing.assert_array_equal(got_base, ref_base)


@pytest.mark.parametrize("seed,i,a,le", [(0, 16, 3, 16), (1, 8, 2, 0),
                                         (2, 32, 4, 8), (3, 24, 1, 40)])
def test_plain_matches_reference_on_random_buffers(seed, i, a, le):
    rows, dims = random_rows(np.random.default_rng(seed), i, a, le, 128)
    ref, got = _both(rows, dims)
    np.testing.assert_array_equal(got, ref)


def test_plain_lane_chunks_do_not_change_the_result(monkeypatch):
    rows, dims = random_rows(np.random.default_rng(5), 16, 2, 16, 256)
    t = torch.from_numpy(rows)
    whole = reconcile_rows_hash_plain(t, dims)
    monkeypatch.setattr(cuda_kernels, "_PLAIN_JOIN_ELEMS", 16 * 16 * 3)
    torch.testing.assert_close(reconcile_rows_hash_plain(t, dims), whole,
                               rtol=0, atol=0)


def test_apply_rows_hash_slices_docs():
    rows, dims, n = _pack(_map_docs())
    got = apply_rows_hash(rows_from_numpy(rows, dims, "cpu"), dims, n)
    ref, _ = _both(rows, dims)
    assert got.shape == (n,)
    np.testing.assert_array_equal(hashes_to_numpy(got), ref[:n])


def test_rejects_unpadded_dims_like_the_reference():
    rows = torch.zeros((rows_count(12, 2, 8), 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiples of 8"):
        reconcile_rows_hash(rows, (12, 2, 8, 4, 5))
    with pytest.raises(ValueError, match="XL kernel needs"):
        reconcile_rows_hash(torch.zeros((rows_count(8, 2, 8), 128),
                                        dtype=torch.int32),
                            (8, 2, 8, 4, 5), force_xl=True)
    with pytest.raises(ValueError, match="rows"):
        reconcile_rows_hash(torch.zeros((5, 128), dtype=torch.int32),
                            (8, 2, 8, 4, 5))


def test_envelopes_match_the_reference():
    from automerge_tpu.engine import pack as ref_pack
    from automerge_tpu.engine.pallas_kernels import \
        rows_dims_eligible_xl as ref_xl
    for i in (8, 32, 256, 512, 1024, 2048):
        for a in (1, 2, 8, 64):
            for le in (0, 8, 128, 256, 512, 1024):
                assert rows_dims_eligible(i, a, le) == \
                    ref_pack.rows_dims_eligible(i, a, le)
                assert rows_dims_eligible_xl(i, a, le) == ref_xl(i, a, le)
    # the chip-smoke XL-only shape
    assert not rows_dims_eligible(512, 8, 512)
    assert rows_dims_eligible_xl(512, 8, 512)


@pytest.mark.parametrize("name", ["base", "all_live", "zero_ops",
                                  "no_elements", "one_actor",
                                  "bucket_one_op", "bucket_small",
                                  "bucket_mid", "bucket_wide_ops"])
def test_plain_matches_reference_on_the_kernel_cases(name):
    """The named cases chip_smoke.py and tests/test_torch_cuda.py hold the
    CUDA kernel to, cut to their first 128 lanes: the plain version they
    compare with equals the reference here."""
    rows, dims = reconcile_case(name)
    rows = np.ascontiguousarray(rows[:, :128])
    ref, got = _both(rows, dims)
    np.testing.assert_array_equal(got, ref)


def _mix32(h):
    h ^= h >> 16
    h = h * 0x85EBCA6B & 0xFFFFFFFF
    h ^= h >> 13
    h = h * 0xC2B2AE35 & 0xFFFFFFFF
    return h ^ h >> 16


def _mix4(a, b, c, d):
    h = _mix32((a + 0x9E3779B9) & 0xFFFFFFFF)
    for v in (b, c, d):
        h = _mix32(h ^ v)
    return h


def _reconcile_lane_by_reads(x, dims):
    """One lane's reconcile, evaluated from the function's definition by a
    walk that reads a cell of the lane's column `x` only when the answer
    depends on it: action where op_mask is set; fid and change of live ops;
    actor and seq of a live op that may be dominated; the clock cells that
    decide it (one dominator's, or those of every peer on its field from
    another change when none dominates); an element's columns once it
    is known valid or visible; a field hash only for a candidate on no
    list; an actor hash only for a candidate's actor. Returns (uint32 hash,
    the rows read, the key-matched pairs of the four joins)."""
    i, a, le, a_set, a_del = dims
    b = row_bases(i, a, le)
    rows_read = set()

    def at(group, k):
        rows_read.add(b[group] + k)
        return int(x[b[group] + k])

    live = [k for k in range(i) if at("om", k) > 0 and at("ac", k) >= a_set]
    need = [k for k in live if at("ac", k) != a_del]
    fid = {k: at("fid", k) for k in live}
    chg = {k: at("chg", k) for k in live}
    pairs = 0
    cand = []
    for k in need:
        act, seq = at("act", k), at("seq", k)
        peers = [j for j in live if fid[j] == fid[k]]
        pairs += len(peers)
        others = [j for j in peers if chg[j] != chg[k]] if 0 <= act < a else []
        hits = [j for j in others if x[b["co"] + act * i + j] >= seq]
        # the cells that decide it: one dominator's, or every peer's
        for j in hits[:1] if hits else others:
            at("co", act * i + j)
        if not hits:
            cand.append(k)
    valid = [e for e in range(le) if at("im", e) > 0 and at("if", e) >= 0]
    ifd = {e: int(x[b["if"] + e]) for e in valid}
    cand_fids = [fid[k] for k in cand]
    visible = []
    for e in valid:
        pairs += cand_fids.count(ifd[e])
        if ifd[e] in cand_fids:
            visible.append(e)
    pos = {e: at("ip", e) for e in visible}
    lst = {e: at("il", e) for e in visible}
    rank = {}
    for e in visible:
        same = [f for f in visible if lst[f] == lst[e]]
        pairs += len(same)
        rank[e] = sum(pos[f] < pos[e] for f in same)
    h = 0
    for k in cand:
        on_field = [e for e in valid if ifd[e] == fid[k]]   # all visible
        pairs += len(on_field)
        if on_field:   # maxima from -1, as the definition's
            key1 = max([-1] + [at("io", e) for e in on_field])
            key2 = max([-1] + [rank[e] for e in on_field])
        else:
            key1, key2 = -7, at("fh", k)
        act = int(x[b["act"] + k])
        ah = at("ah", act) if 0 <= act < a else 0
        h += _mix4(key1 & 0xFFFFFFFF, key2 & 0xFFFFFFFF, ah & 0xFFFFFFFF,
                   at("vh", k) & 0xFFFFFFFF)
    return h & 0xFFFFFFFF, rows_read, pairs


@pytest.mark.parametrize("seed,i,a,le,n_fids", [(0, 16, 3, 16, 4),
                                                (1, 24, 1, 0, 3),
                                                (2, 32, 4, 24, 6),
                                                (3, 24, 2, 32, 12)])
def test_chip_smoke_bound_counts_the_bytes_this_data_needs(seed, i, a, le,
                                                            n_fids):
    """chip_smoke.py's bound of one reconcile counts the cells a walk of
    the function's definition must read for this data (each once, four
    bytes, plus the hash written per lane) and the pairs its joins match
    on their keys, not the whole buffer. The walk is the function: its
    hashes equal the plain version's."""
    from chip_smoke import bound
    rows, dims = random_rows(np.random.default_rng(300 + seed), i, a, le, 12,
                             n_fids=n_fids)
    want = hashes_to_numpy(reconcile_rows_hash_plain(torch.from_numpy(rows),
                                                     dims))
    nbytes = pairs = 0
    for lane, x in enumerate(rows.T):
        h, read, p = _reconcile_lane_by_reads(x, dims)
        assert h == want[lane]
        nbytes += 4 * len(read) + 4
        pairs += p
    got = bound(torch.from_numpy(rows), dims)
    assert (got[2], got[3]) == (nbytes, pairs)
    assert got[2] < rows.nbytes


def test_library_name_covers_every_included_header(tmp_path, monkeypatch):
    """A kernel's library is named by its source and every header the
    source includes, directly or through another header, so an edited
    header never loads a stale build."""
    (tmp_path / "k.cu").write_text('#include <cstdint>\n#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// v1\n")
    monkeypatch.setitem(cuda_kernels.SOURCES, "k", tmp_path / "k.cu")
    first = cuda_kernels.library_path("k")
    assert cuda_kernels.library_path("k") == first
    (tmp_path / "b.cuh").write_text("// v2\n")
    second = cuda_kernels.library_path("k")
    assert second != first
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n// x\n')
    assert cuda_kernels.library_path("k") not in (first, second)
    assert [p.name for p in cuda_kernels._build_inputs(tmp_path / "k.cu")] \
        == ["k.cu", "a.cuh", "b.cuh"]
    real = cuda_kernels._build_inputs(cuda_kernels.SOURCES["reconcile_rows"])
    assert [p.name for p in real] == ["reconcile_rows.cu", "lane_team.cuh"]
