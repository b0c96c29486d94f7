"""The port's CUDA kernels, the rows engine, the batched planes and the
docs-major engine on the card. Every test here is marked `cuda` and skips without a GPU. The file imports neither jax nor the
JAX package, so it runs on a GPU machine that has neither:

    python -m pytest tests/test_torch_cuda.py -q --noconftest

Tolerance: exact (integer outputs and hashes). The other side of each
comparison is the plain PyTorch version, which tests/test_torch_kernels.py,
test_torch_rows.py, test_torch_spans.py and test_torch_moves.py hold
bit-equal to the reference (test_torch_dominated.py, test_torch_apply_doc.py,
test_torch_resident.py and test_torch_diffs.py for the docs-major engine)."""

from pathlib import Path

import numpy as np
import pytest

import torch

from automerge_tpu_torch.engine import cuda_kernels
from automerge_tpu_torch.engine import move_kernels as mk
from automerge_tpu_torch.engine import span_kernels as sk
from automerge_tpu_torch.engine.cuda_kernels import (
    _XL_BI, hashes_to_numpy, reconcile_rows_hash, reconcile_rows_hash_plain)
from automerge_tpu_torch.engine.dispatch import (merge_spans_adaptive,
                                                 resolve_moves_adaptive,
                                                 result_to_numpy)
from automerge_tpu_torch.engine.pack import (pack_moves, pack_spans,
                                             rows_from_numpy)
from automerge_tpu_torch.engine.resident_rows import ResidentRowsDocSet
from automerge_tpu_torch.engine.kernels import apply_doc, linearize_plain
from automerge_tpu_torch.engine.resident import ResidentDocSet
from automerge_tpu_torch.workloads import (
    LINEARIZE_CASES, LINEARIZE_CAUSAL_CASES, RECONCILE_CASES,
    causal_linearize, mixed_linearize, move_fleet, random_dominated,
    random_linearize, random_move_lanes, random_span_tables, reconcile_case,
    reference_diff_streams, reference_docs_streams, reference_move_problems,
    reference_span_tables, reference_streams, span_fleet, text_fleet)

from torch_port_helpers import cuda_device  # noqa: F401 (fixture)

REFERENCE = (Path(__file__).resolve().parent.parent / "automerge_tpu_torch"
             / "testdata" / "reference_hashes.npz")
REFERENCE_DIFFS = REFERENCE.with_name("reference_diffs.json")


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
@pytest.mark.parametrize(
    "name,force_xl",
    [(n, xl) for n in RECONCILE_CASES for xl in (False, True)
     if not xl or RECONCILE_CASES[n][0] % _XL_BI == 0],
    ids=lambda v: v if isinstance(v, str) else str(v))
def test_kernel_matches_plain_on_the_named_cases(cuda_device, name,
                                                 force_xl):
    """The reconcile kernel at the shapes its design could get wrong (a
    heavy lane among near-empty ones, every slot live, lanes with no op,
    LE = 0, A = 1, I = LE = 1,024, the XL-only shape, a lane past the
    shared memory, the megabatch route's bucket dims), bit-equal to the
    plain version, one launch a call; with force_xl wherever the XL form
    takes the op band (I a multiple of 32)."""
    rows_np, dims = reconcile_case(name, seed=7)
    rows = torch.from_numpy(rows_np).to(cuda_device)
    got = _launched("reconcile_rows_hash",
                    lambda: reconcile_rows_hash(rows, dims, force_xl))
    assert torch.equal(got, reconcile_rows_hash_plain(rows, dims))


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


def _launched(name, fn):
    before = cuda_kernels.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert cuda_kernels.LAUNCHES[name] == before + 1
    return out


def _span_lanes(tables, s_pad):
    """pack_spans(tables) ([D, 8, S], S a multiple of 128) cut or padded
    with masked lanes to exactly s_pad lanes."""
    spans = pack_spans(tables)[:, :, :s_pad]
    return np.ascontiguousarray(np.pad(
        spans, ((0, 0), (0, 0), (0, s_pad - spans.shape[2]))))


@pytest.mark.cuda
@pytest.mark.parametrize("s_pad", [128, 131, 1024, 1025, 4096, 9000])
def test_span_kernel_matches_plain(cuda_device, s_pad):
    """Both paths of the kernel: a warp per document (S <= 1,024; 131 is
    not a multiple of 4, so scalar loads) and a block per document (one
    chunk up to 8,192 lanes; 9,000 takes two)."""
    rng = np.random.default_rng(s_pad)
    tables = (random_span_tables(rng, 16, s_pad - 3)
              + random_span_tables(rng, 16, s_pad - 3, full_range=True))
    spans_np = _span_lanes(tables, s_pad)
    spans = torch.from_numpy(spans_np).to(cuda_device)
    order = torch.argsort(torch.rand(spans.shape[0], s_pad,
                                     device=cuda_device), 1).to(torch.int32)
    for args in ((spans,), (spans, order)):
        got = _launched("span_rank_hash", lambda: sk.span_rank_hash(*args))
        for g, w in zip(got, sk.span_rank_hash_plain(*args)):
            assert torch.equal(g, w)
    got = result_to_numpy(_launched("span_rank_hash",
                                    lambda: sk.merge_spans(spans)))
    want = sk.merge_spans_host(spans_np)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("s_pad", [128, 131, 2176])
def test_span_kernel_on_one_document(cuda_device, s_pad):
    """D = 1 on both paths, through an order and pre-sorted."""
    tables = random_span_tables(np.random.default_rng(s_pad), 1, s_pad - 2,
                                full_range=True)
    spans = torch.from_numpy(_span_lanes(tables, s_pad)).to(cuda_device)
    order = torch.randperm(s_pad, device=cuda_device)[None].to(torch.int32)
    for args in ((spans,), (spans, order)):
        got = _launched("span_rank_hash", lambda: sk.span_rank_hash(*args))
        for g, w in zip(got, sk.span_rank_hash_plain(*args)):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("labels", ["ranks", "wide", "pad_hi"])
@pytest.mark.parametrize("n_pad,k_pad", [(128, 256), (512, 512),
                                         (640, 640), (1664, 1664),
                                         (2176, 1024), (4096, 1024),
                                         (4224, 1024), (8192, 512),
                                         (16384, 2048)])
def test_move_kernel_matches_plain(cuda_device, n_pad, k_pad, labels):
    """Realms in registers and shared memory, on each side of each
    threshold of the launch plan (a node a thread up to 512 nodes, 512
    threads x 4 up to 2,048, 1,024 x 4 up to the cap SMEM_MAX_NODES,
    4,096 nodes), and past the cap in the global scratch; in the narrow
    label code (ranks, labels with the pad as hi) and wide."""
    nodes, cands, ptr = (torch.from_numpy(a).to(cuda_device) for a in
                         random_move_lanes(np.random.default_rng(n_pad), 8,
                                           n_pad, k_pad, labels))
    got = _launched("move_round", lambda: mk.move_round(nodes, cands, ptr))
    assert torch.equal(got, mk.move_round_plain(nodes, cands, ptr))
    got = _launched("resolve_moves", lambda: mk.resolve_moves(nodes, cands))
    want = mk.resolve_moves_plain(nodes, cands)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
def test_planes_route_to_the_card_and_reproduce_the_reference(cuda_device):
    committed = np.load(REFERENCE)
    tables, expected = span_fleet(n_docs=300)
    before = cuda_kernels.LAUNCHES["span_rank_hash"]
    plan, out = merge_spans_adaptive(tables, device=cuda_device)
    assert plan.backend == "device"
    assert cuda_kernels.LAUNCHES["span_rank_hash"] == before + 1
    assert result_to_numpy(out)["total"].tolist() == expected
    packed = pack_moves(move_fleet(n_realms=8))
    before = cuda_kernels.LAUNCHES["resolve_moves"]
    plan, out = resolve_moves_adaptive(packed, device=cuda_device)
    assert plan.backend == "device"
    assert cuda_kernels.LAUNCHES["resolve_moves"] == before + 1
    want = mk.resolve_moves_host(packed)
    got = result_to_numpy(out)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    got = result_to_numpy(sk.merge_spans(torch.from_numpy(
        pack_spans(reference_span_tables())).to(cuda_device)))
    for k in got:
        np.testing.assert_array_equal(got[k], committed[f"spans_{k}"])
    packed = pack_moves(reference_move_problems())
    got = result_to_numpy(mk.resolve_moves(
        torch.from_numpy(packed["nodes"]).to(cuda_device),
        torch.from_numpy(packed["cands"]).to(cuda_device)))
    for k in got:
        np.testing.assert_array_equal(got[k], committed[f"moves_{k}"])


@pytest.mark.cuda
@pytest.mark.parametrize("full_range", [False, True])
@pytest.mark.parametrize("d,n,a", [(512, 128, 4), (64, 1024, 8),
                                   (1, 4096, 16), (5, 1, 1), (10_000, 32, 4),
                                   (300, 45, 3), (7, 1100, 2)])
def test_dominated_kernel_matches_plain(cuda_device, d, n, a, full_range):
    """B5 against its plain version, bit-equal, at chip_smoke's shapes,
    with values below 2**24 and over the whole int32 range."""
    args = [torch.from_numpy(x).to(cuda_device) for x in random_dominated(
        np.random.default_rng(d * n + full_range), d, n, a, full_range)]
    got = _launched("dominated", lambda: cuda_kernels.dominated(*args))
    assert torch.equal(got, cuda_kernels.dominated_plain(*args))
    assert torch.equal(got.cpu(), cuda_kernels.dominated(
        *(x.cpu() for x in args)))


@pytest.mark.cuda
def test_docs_major_engine_on_the_card_reproduces_the_reference(cuda_device):
    committed = np.load(REFERENCE)
    for name, ids, rounds in reference_docs_streams():
        ds = ResidentDocSet(ids, device=cuda_device)
        before = cuda_kernels.LAUNCHES["dominated"]
        for rnd in rounds:
            ds.apply_and_reconcile(rnd)
        assert cuda_kernels.LAUNCHES["dominated"] == before + len(rounds)
        np.testing.assert_array_equal(ds.hashes(), committed[f"docs_{name}"])
        # the whole apply_doc output on the card equals the CPU's
        ds._ensure_actor_hash_state()
        on_card = apply_doc(ds.state, ds.cap_fids)
        on_cpu = apply_doc({k: v.cpu() for k, v in ds.state.items()},
                           ds.cap_fids)
        for k in on_cpu:
            assert torch.equal(on_card[k].cpu(), on_cpu[k]), (name, k)


@pytest.mark.cuda
@pytest.mark.parametrize("native", [True, False])
def test_frame_ingress_on_the_card_equals_the_cpu(cuda_device, native):
    """apply_round_frames (the rows engine) and apply_and_reconcile_columns
    (docs-major) on the card give the CPU's hashes and the committed
    reference's, and launch B1 and B5."""
    from automerge_tpu_torch.sync.frames import (decode_frame, encode_frame,
                                                 encode_round_frame)
    committed = np.load(REFERENCE)
    for name, ids, batches in reference_streams():
        frames = [encode_round_frame(r) for batch in batches for r in batch]
        out = {}
        for dev in (cuda_device, "cpu"):
            ds = ResidentRowsDocSet(ids, device=dev, native=native)
            before = cuda_kernels.LAUNCHES["reconcile_rows_hash"]
            h = ds.apply_round_frames(frames)
            assert h.device.type == torch.device(dev).type
            if dev != "cpu":
                assert cuda_kernels.LAUNCHES["reconcile_rows_hash"] \
                    == before + 1
            out[str(dev)] = hashes_to_numpy(h)[:len(ids)]
        np.testing.assert_array_equal(out[str(cuda_device)], out["cpu"])
        np.testing.assert_array_equal(out["cpu"], committed[name])
    for name, ids, rounds in reference_docs_streams():
        out = {}
        for dev in (cuda_device, "cpu"):
            ds = ResidentDocSet(ids, device=dev, native=native)
            before = cuda_kernels.LAUNCHES["dominated"]
            for rnd in rounds:
                ds.apply_and_reconcile_columns(
                    {d: decode_frame(encode_frame(c)) for d, c in rnd.items()})
            if dev != "cpu":
                assert cuda_kernels.LAUNCHES["dominated"] \
                    == before + len(rounds)
            out[str(dev)] = ds.hashes()
        np.testing.assert_array_equal(out[str(cuda_device)], out["cpu"])
        np.testing.assert_array_equal(out["cpu"], committed[f"docs_{name}"])


@pytest.mark.cuda
def test_megabatch_route_on_the_card_equals_the_cpu(cuda_device,
                                                    monkeypatch):
    """The megabatch route on the card, on both of its sources: a small
    map storm's frame rounds (planned by the same prices on both
    engines), then late docs and a minority read
    (index upload, device gather from the resident copy, the reconcile
    kernel at bucket dims, one readback), then a lazy round and a minority
    read of its docs (the stale copy: buckets gathered from the host
    mirror). Each read gives the CPU's hashes and launches one kernel per
    bucket; the resident copy is left equal to the host mirror. Bytes are
    priced (the constants' CPU-test values) so that the route is taken at
    this size."""
    from automerge_tpu_torch.engine import dispatch, dispatchledger
    from automerge_tpu_torch.sync.frames import encode_round_frame
    from automerge_tpu_torch.workloads import map_storm
    monkeypatch.delenv("AMTPU_MEGABATCH", raising=False)
    monkeypatch.delenv("AMTPU_MEGABATCH_MIN_DOCS", raising=False)
    monkeypatch.setitem(dispatch._LINK, "dev_bytes_per_s", 1e3)
    monkeypatch.setitem(dispatch._LINK, "host_gather_bytes_per_s", 1e6)
    dispatch._reload_for_tests()
    try:
        ids, heavy, storm = map_storm(n_docs=600, n_heavy=2,
                                      heavy_ops=100, rounds=3,
                                      draws_per_round=300)
        frames = [encode_round_frame(r) for r in [heavy] + storm]
        gpu = ResidentRowsDocSet(ids, device=cuda_device)
        cpu = ResidentRowsDocSet(ids, device="cpu")
        n = len(ids)

        def totals():
            sec = dispatchledger.ledger().section() or {}
            return (sec.get("mega_rounds_total", 0),
                    sec.get("mega_dispatches_total", 0))

        def routed_read(want_idx):
            (r0, d0), before = totals(), \
                cuda_kernels.LAUNCHES["reconcile_rows_hash"]
            got = gpu.hashes_for(want_idx)
            (r1, d1), launched = totals(), \
                cuda_kernels.LAUNCHES["reconcile_rows_hash"] - before
            assert r1 == r0 + 1 and launched == d1 - d0 >= 1
            np.testing.assert_array_equal(got, cpu.hashes_for(want_idx))

        for f in frames[:-1]:
            h = gpu.apply_round_frames([f])
            assert h.device.type == "cuda" and h.shape == (gpu.n_pad,)
            want = hashes_to_numpy(cpu.apply_round_frames([f]))
            np.testing.assert_array_equal(hashes_to_numpy(h)[:n], want[:n])
        late = [f"late{i}" for i in range(20)]
        for e in (gpu, cpu):
            e.hashes()                  # consumes the last frame's handle
            e.add_docs(late)
        assert gpu.rows_dev is not None and not gpu._dirty
        routed_read([gpu.doc_index[d] for d in late] + [0, 5, 9])
        assert gpu.rows_dev is not None and not gpu._dirty
        np.testing.assert_array_equal(gpu.rows_dev.cpu().numpy(),
                                      gpu.rows_host)
        for e in (gpu, cpu):
            e.hashes()
            e.lazy_dispatch = True
            assert e.apply_round_frames(frames[-1:]) is None
        touched = sorted(gpu.doc_index[d] for d in storm[-1])
        routed_read(touched[:len(touched) // 4])
        np.testing.assert_array_equal(gpu.hashes(), cpu.hashes())
    finally:
        monkeypatch.undo()
        dispatch._reload_for_tests()


@pytest.mark.cuda
def test_frame_route_on_the_card_equals_the_cpu(cuda_device, monkeypatch):
    """Eager round frames on the megabatch route on the card (the classic
    frame dispatch's readback priced dear, so every planned frame takes
    the route): each round's returned hashes equal the CPU engine's on the
    same route and AMTPU_MEGABATCH=0's, one kernel launch a bucket, the
    device copy the same tensor from round to round and equal to the host
    mirror, and hashes() after a route round launching nothing."""
    from automerge_tpu_torch.engine import dispatch, dispatchledger
    from automerge_tpu_torch.sync.frames import encode_round_frame
    from automerge_tpu_torch.workloads import map_storm
    monkeypatch.delenv("AMTPU_MEGABATCH", raising=False)
    monkeypatch.delenv("AMTPU_MEGABATCH_MIN_DOCS", raising=False)
    dispatch._reload_for_tests()
    ids, heavy, storm = map_storm(n_docs=600, n_heavy=2, heavy_ops=100,
                                  rounds=3, draws_per_round=300)
    frames = [encode_round_frame(r) for r in [heavy] + storm]
    n = len(ids)
    classic = ResidentRowsDocSet(ids, device=cuda_device)
    monkeypatch.setenv("AMTPU_MEGABATCH", "0")
    dispatch._reload_for_tests()
    want = [hashes_to_numpy(classic.apply_round_frames([f]))[:n]
            for f in frames]
    monkeypatch.delenv("AMTPU_MEGABATCH")
    monkeypatch.setitem(dispatch._LINK, "d2h_bytes_per_s", 1.0)
    dispatch._reload_for_tests()
    try:
        gpu = ResidentRowsDocSet(ids, device=cuda_device)
        cpu = ResidentRowsDocSet(ids, device="cpu")
        rows = None
        for k, f in enumerate(frames):
            sec = dispatchledger.ledger().section() or {}
            d0 = sec.get("mega_dispatches_total", 0)
            b0 = cuda_kernels.LAUNCHES["reconcile_rows_hash"]
            h = gpu.apply_round_frames([f])
            launched = cuda_kernels.LAUNCHES["reconcile_rows_hash"] - b0
            sec = dispatchledger.ledger().section() or {}
            assert h.device.type == "cuda" and h.shape == (gpu.n_pad,)
            got = hashes_to_numpy(h)[:n]
            np.testing.assert_array_equal(got, want[k])
            np.testing.assert_array_equal(
                got, hashes_to_numpy(cpu.apply_round_frames([f]))[:n])
            if k:
                # the heavy round re-ranks every doc (a new actor): its
                # refresh of the other lanes launches once more
                assert launched == sec.get("mega_dispatches_total",
                                           0) - d0 >= 1
                assert gpu.rows_dev is rows
            assert gpu.hashes_clean and not gpu._dirty
            b1 = cuda_kernels.LAUNCHES["reconcile_rows_hash"]
            np.testing.assert_array_equal(gpu.hashes(), want[k])
            assert cuda_kernels.LAUNCHES["reconcile_rows_hash"] == b1
            rows = gpu.rows_dev
        np.testing.assert_array_equal(gpu.rows_dev.cpu().numpy(),
                                      gpu.rows_host)
    finally:
        monkeypatch.undo()
        dispatch._reload_for_tests()


@pytest.mark.cuda
@pytest.mark.parametrize("r,e", LINEARIZE_CASES)
def test_linearize_kernel_matches_plain(cuda_device, r, e):
    """The linearize kernel against linearize_plain, bit-equal, on
    random_linearize's edge cases (RGA rows, parents past the array,
    all-masked rows, equal keys) at chip_smoke's shapes, the global-scratch
    row (E = 9,000) included; and kernels.linearize routes the CUDA tensor
    to the kernel."""
    from automerge_tpu_torch.engine.kernels import linearize
    args = [torch.from_numpy(x).to(cuda_device)
            for x in random_linearize(np.random.default_rng(r + e), r, e)]
    got = _launched("linearize", lambda: linearize(*args))
    assert torch.equal(got, linearize_plain(*args))
    assert torch.equal(got.cpu(), linearize(*(x.cpu() for x in args)))


@pytest.mark.cuda
@pytest.mark.parametrize("gen", ["causal", "mixed"])
@pytest.mark.parametrize("r,e", LINEARIZE_CAUSAL_CASES)
def test_linearize_kernel_matches_plain_on_causal_rows(cuda_device, gen, r,
                                                       e):
    """The linearize kernel's parallel path against linearize_plain,
    bit-equal: causal_linearize's rows (random trees with equal keys, all
    children of the head, one chain), and mixed_linearize's batches where
    causal rows and rows that take the walk share one launch, on a warp
    slice a row (E = 8), a block a row, and the global scratch (E =
    9,000)."""
    from automerge_tpu_torch.engine.kernels import linearize
    make = causal_linearize if gen == "causal" else mixed_linearize
    args = [torch.from_numpy(x).to(cuda_device)
            for x in make(np.random.default_rng(r * e), r, e)]
    got = _launched("linearize", lambda: linearize(*args))
    assert torch.equal(got, linearize_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("e", [2, 3, 5, 16, 17, 31, 32, 33, 63, 64, 65,
                               127, 128, 129, 511, 512, 1000, 1024, 2048,
                               4097])
def test_linearize_kernel_at_odd_widths(cuda_device, e):
    """The linearize kernel on mixed_linearize's batches at every warp
    slice width (E <= 32, padded lanes where E is not a power of two), at
    and around each block instance's P (64 to 2,048) and just past 4,096
    (the global scratch), bit-equal to linearize_plain; R not a multiple
    of a block's rows."""
    from automerge_tpu_torch.engine.kernels import linearize
    args = [torch.from_numpy(x).to(cuda_device)
            for x in mixed_linearize(np.random.default_rng(e), 77, e)]
    got = _launched("linearize", lambda: linearize(*args))
    assert torch.equal(got, linearize_plain(*args))


@pytest.mark.cuda
def test_diff_streams_on_the_card_equal_the_cpu(cuda_device):
    """apply_and_reconcile(..., diffs=True) on the card: every round's
    hashes and records equal the CPU's and the committed reference records,
    and each round launches the linearize kernel once."""
    import json
    committed = json.loads(REFERENCE_DIFFS.read_text())
    for name, ids, rounds in reference_diff_streams():
        card = ResidentDocSet(ids, device=cuda_device)
        cpu = ResidentDocSet(ids, device="cpu")
        before = cuda_kernels.LAUNCHES["linearize"]
        for k, rnd in enumerate(rounds):
            h, recs = card.apply_and_reconcile(rnd, diffs=True)
            h_cpu, recs_cpu = cpu.apply_and_reconcile(rnd, diffs=True)
            np.testing.assert_array_equal(h, h_cpu)
            assert recs == recs_cpu, (name, k)
            assert json.loads(json.dumps(recs)) == committed[name][k]
        assert cuda_kernels.LAUNCHES["linearize"] == before + len(rounds)


@pytest.mark.cuda
def test_compaction_on_the_card_rereads_through_the_kernel(cuda_device):
    """compact on a card engine (a text fleet after every typist
    acknowledged the others): the docs whose slots moved re-read through
    the reconcile kernel, the hashes stay as they were, and the compacted
    mirror, stats, ghosts and hashes equal a CPU instance's."""
    from automerge_tpu_torch.engine.compaction import causal_floor
    from automerge_tpu_torch.sync.frames import encode_round_frame
    from automerge_tpu_torch.workloads import text_fleet_acks
    ids, rounds = text_fleet(n_docs=64)
    frames = [encode_round_frame(r)
              for r in rounds + [text_fleet_acks(rounds)]]
    out = {}
    for dev in (cuda_device, "cpu"):
        ds = ResidentRowsDocSet(ids, device=dev)
        ds.apply_round_frames(frames)
        h0 = ds.hashes()
        stats = ds.compact({d: causal_floor(ds, i)
                            for i, d in enumerate(ids)})
        assert ds.rows_dev is None and ds._doc_dirty
        before = cuda_kernels.LAUNCHES["reconcile_rows_hash"]
        h1 = ds.hashes()
        if dev != "cpu":
            assert cuda_kernels.LAUNCHES["reconcile_rows_hash"] > before
        np.testing.assert_array_equal(h1, h0)
        assert sum(len(g) for g in ds.ghost_eids) > 0
        out[str(dev)] = (h1, ds.rows_host.copy(), stats, ds.ghost_eids)
    card, cpu = out[str(cuda_device)], out["cpu"]
    np.testing.assert_array_equal(card[0], cpu[0])
    np.testing.assert_array_equal(card[1], cpu[1])
    assert card[2] == cpu[2] and card[3] == cpu[3]


@pytest.mark.cuda
def test_rebuild_on_the_card_stays_on_the_card(cuda_device, monkeypatch):
    """A mid-admission failure on a long-lived fleet kept inside the
    envelope by compaction rebuilds from the log through the chunked
    replay, on the card (the reconcile kernel launches, the rebuilt device
    copy lives there), with the hashes of a CPU instance under the same
    fault."""
    from automerge_tpu_torch.engine.compaction import causal_floor
    from automerge_tpu_torch.engine.resident_rows import (
        DeviceDispatchError, RowsBudgetError)
    from automerge_tpu_torch.sync.frames import encode_round_frame
    from automerge_tpu_torch.workloads import long_lived_changes

    def boom(*a, **k):
        raise MemoryError("grow failed mid-scatter")
    ids = [f"doc{j}" for j in range(8)]
    out = {}
    for dev in (cuda_device, "cpu"):
        ds = ResidentRowsDocSet(ids, device=dev)
        for lo in range(1, 1201, 200):
            frame = encode_round_frame(
                {d: long_lived_changes(j, lo, lo + 199)
                 for j, d in enumerate(ids)})
            try:
                ds.apply_round_frames([frame])
            except RowsBudgetError:
                ds.compact({d: causal_floor(ds, i)
                            for i, d in enumerate(ids)})
                ds.apply_round_frames([frame])
        monkeypatch.setattr(ds, "_cols_triplets", boom)
        before = cuda_kernels.LAUNCHES["reconcile_rows_hash"]
        with pytest.raises(DeviceDispatchError):
            ds.apply_rounds([{d: long_lived_changes(j, 1201, 1210)
                              for j, d in enumerate(ids)}])
        assert ds._rebuild_gen == 1
        assert ds.device == torch.device(dev)
        if dev != "cpu":
            assert cuda_kernels.LAUNCHES["reconcile_rows_hash"] > before
            assert ds.rows_dev is not None and ds.rows_dev.is_cuda
        out[str(dev)] = ds.hashes()
    np.testing.assert_array_equal(out[str(cuda_device)], out["cpu"])


def _storm_state(opset):
    from automerge_tpu_torch.engine.batchdoc import oracle_state
    from automerge_tpu_torch.frontend.materialize import materialize_root
    parents = {}
    for oid in sorted(opset.moved_objs):
        obj = opset.by_object[oid]
        ref = obj.loc if obj.loc is not None else next(iter(obj.inbound))
        parents[oid] = ref.obj
    return parents, oracle_state(materialize_root("s", opset))


@pytest.mark.cuda
def test_storm_realm_through_the_opset_on_the_card_equals_the_cpu(
        cuda_device):
    """An OpSet on the card resolves a storm realm of >= 64 moved nodes
    through B4 (its launch counter moves), in one batch and a change a
    call, to the CPU OpSet's state and diffs."""
    from automerge_tpu_torch.core.opset import OpSet
    from automerge_tpu_torch.workloads import move_storm_changes
    base, storm = move_storm_changes(n_objs=200, n_moves=150)
    out = {}
    for dev in (cuda_device, "cpu"):
        o0, _ = OpSet.init(dev).add_changes([base])
        assert o0.device == torch.device(dev)
        before = cuda_kernels.LAUNCHES["resolve_moves"]
        batched, diffs = o0.add_changes(storm, move_batch=True)
        per = o0
        for c in storm:
            per, _ = per.add_changes([c])
        launched = cuda_kernels.LAUNCHES["resolve_moves"] - before
        if dev != "cpu":
            # one for the batch, one a change from the 64th moved node on
            assert launched == 1 + len(storm) - 63
        else:
            assert launched == 0
        assert _storm_state(per) == _storm_state(batched)
        out[str(dev)] = (diffs, _storm_state(batched))
    assert out[str(cuda_device)] == out["cpu"]


@pytest.mark.cuda
def test_rows_materialize_on_the_card_equals_the_cpu(cuda_device):
    from automerge_tpu_torch import api
    from automerge_tpu_torch.workloads import text_fleet
    ids, rounds = text_fleet(n_docs=16)
    got = {}
    for dev in (cuda_device, "cpu"):
        ds = ResidentRowsDocSet(ids, device=dev)
        ds.apply_rounds(rounds)
        got[str(dev)] = [ds.materialize(d) for d in ids]
    assert got[str(cuda_device)] == got["cpu"]
    assert api.init("x", device=cuda_device)._doc.opset.device.type == "cuda"


@pytest.mark.cuda
def test_apply_batch_adaptive_routes_decode_equal_on_the_card(
        cuda_device, monkeypatch):
    """On the same batch, the device route (the host priced up) and the
    host route (the card's fixed cost priced up) decode to the same
    states."""
    from automerge_tpu_torch.engine import dispatch
    from automerge_tpu_torch.engine.batchdoc import (apply_batch, decode_doc,
                                                     doc_outputs,
                                                     oracle_state)
    from automerge_tpu_torch.workloads import docset_fleet
    ids, initial, _ = docset_fleet(n_docs=64, rounds=0)
    batch = [initial[d] for d in ids]
    saved = dict(dispatch._LINK)
    try:
        dispatch.calibrate(host_op_s=1.0)
        before = cuda_kernels.LAUNCHES["dominated"]
        plan, hashes = dispatch.apply_batch_adaptive(batch,
                                                     device=cuda_device)
        assert plan.backend == "device"
        assert cuda_kernels.LAUNCHES["dominated"] == before + 1
        dispatch._LINK.update(saved)
        dispatch.calibrate(dispatch_fixed_s=10.0)
        plan, docs = dispatch.apply_batch_adaptive(batch,
                                                   device=cuda_device)
        assert plan.backend == "host"
    finally:
        dispatch._LINK.clear()
        dispatch._LINK.update(saved)
    encs, _b, out = apply_batch(batch, device=cuda_device)
    assert hashes.tolist() == hashes_to_numpy(out["hash"]).tolist()
    assert [oracle_state(d) for d in docs] == \
        [decode_doc(encs[i], doc_outputs(out, i)) for i in range(len(ids))]


def _service_streams(n_docs: int = 48, rounds: int = 4):
    """The docset fleet as per-round {doc: [Change]} ingress."""
    from automerge_tpu_torch.workloads import docset_fleet
    ids, initial, later = docset_fleet(n_docs=n_docs, rounds=rounds)
    return ids, [initial] + list(later)


@pytest.mark.cuda
@pytest.mark.parametrize("ingest_mode", ["epoch", "locked"])
def test_rows_service_on_the_card_equals_the_cpu(cuda_device, ingest_mode):
    """EngineDocSet(backend="rows") on the card: each flush launches the
    reconcile kernel (eager dispatch on a card), and the hashes, clocks
    and a minority hashes_for equal a CPU service's."""
    from automerge_tpu_torch.sync.service import EngineDocSet
    ids, rounds = _service_streams()
    out = {}
    for dev in (cuda_device, "cpu"):
        svc = EngineDocSet(backend="rows", device=dev,
                           ingest_mode=ingest_mode)
        before = cuda_kernels.LAUNCHES["reconcile_rows_hash"]
        for rnd in rounds:
            with svc.batch():
                for d, chs in rnd.items():
                    svc.apply_changes(d, chs)
        if dev != "cpu":
            assert svc._resident.lazy_dispatch is False
            assert cuda_kernels.LAUNCHES["reconcile_rows_hash"] \
                >= before + len(rounds)
        out[str(dev)] = (svc.hashes(), svc.hashes_for(ids[:5]),
                         {d: svc.clock_of(d) for d in ids})
        svc.close()
    assert out[str(cuda_device)] == out["cpu"]


@pytest.mark.cuda
def test_dispatch_counters_on_the_card(cuda_device):
    """On the card every flush of a rows service is one counted
    `apply_final` dispatch that launches B1, no dispatch counts a build
    once the kernels are built, the per-kernel row carries the call's
    bytes, and the live footprint is torch.cuda.memory_allocated."""
    from automerge_tpu_torch.sync.service import EngineDocSet
    from automerge_tpu_torch.utils import metrics, perfscope
    cuda_kernels.build()
    ids, rounds = _service_streams()
    svc = EngineDocSet(backend="rows", device=cuda_device)
    try:
        metrics.reset()
        before = cuda_kernels.LAUNCHES["reconcile_rows_hash"]
        for rnd in rounds:
            with svc.batch():
                for d, chs in rnd.items():
                    svc.apply_changes(d, chs)
        snap = metrics.snapshot()
        launched = cuda_kernels.LAUNCHES["reconcile_rows_hash"] - before
        assert snap["engine_kernels_dispatched{kernel=apply_final}"] \
            == len(rounds) <= launched
        assert not [k for k in snap
                    if k.startswith("engine_kernels_retraced")]
        row = snap["perf"]["kernels"]["apply_final"]
        assert row["compiles"] == 0 and row["memory"]["argument"] > 0
        live = perfscope.sample_live_arrays(force=True, device=cuda_device)
        assert live == torch.cuda.memory_allocated(cuda_device)
        assert metrics.snapshot()["obs_live_arrays_bytes"] == live
    finally:
        svc.close()


@pytest.mark.cuda
def test_live_views_on_the_card_equal_the_cpu(cuda_device):
    """EngineDocSet(backend="resident", live_views=True) on the card: the
    diff records each subscriber receives, the views and the hashes equal
    a CPU service's, and each ingress launches B5 and linearize."""
    from automerge_tpu_torch.sync.service import EngineDocSet
    ids, rounds = _service_streams(n_docs=16, rounds=3)
    out = {}
    for dev in (cuda_device, "cpu"):
        svc = EngineDocSet(backend="resident", device=dev, live_views=True)
        seen = []
        svc.subscribe_views(lambda d, recs: seen.append((d, recs)))
        before = dict(cuda_kernels.LAUNCHES)
        for rnd in rounds:
            for d, chs in rnd.items():
                svc.apply_changes(d, chs)
        if dev != "cpu":
            for k in ("dominated", "linearize"):
                assert cuda_kernels.LAUNCHES[k] > before[k], k
        out[str(dev)] = (seen, {d: svc.view(d) for d in ids}, svc.hashes())
        svc.close()
    assert out[str(cuda_device)] == out["cpu"]


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["json", "columnar"])
def test_card_and_cpu_nodes_converge_over_a_connection(cuda_device, wire):
    """A node on the card and a node on the CPU, each written to, joined
    by Connections over in-process queues, converge to equal hashes,
    clocks and materialized documents."""
    from collections import deque
    from automerge_tpu_torch import Connection
    from automerge_tpu_torch.sync.service import EngineDocSet
    ids, rounds = _service_streams(n_docs=24, rounds=2)
    card = EngineDocSet(backend="rows", device=cuda_device)
    cpu = EngineDocSet(backend="rows", device="cpu")
    qa, qb = deque(), deque()
    ca = Connection(card, qa.append, wire=wire)
    cb = Connection(cpu, qb.append, wire=wire)
    ca.open()
    cb.open()

    def pump():
        while qa or qb:
            while qa:
                cb.receive_msg(qa.popleft())
            while qb:
                ca.receive_msg(qb.popleft())

    for k, rnd in enumerate(rounds):
        node = card if k % 2 == 0 else cpu
        for d, chs in rnd.items():
            node.apply_changes(d, chs)
        pump()
    assert card.hashes() == cpu.hashes()
    for d in ids:
        assert card.clock_of(d) == cpu.clock_of(d)
    for d in ids[:4]:
        assert card.materialize(d) == cpu.materialize(d)
    card.close()
    cpu.close()


# ---------------------------------------------------------------------------
# the sharded node and the TCP transport on the card


@pytest.mark.cuda
def test_sharded_node_on_the_card_equals_the_cpu(cuda_device):
    """ShardedEngineDocSet with devices=None puts every shard on the card;
    its bursts and first read launch the reconcile kernel, a clean re-read
    launches nothing; hashes, the reads' clean and dirty shard counts,
    clocks and a minority hashes_for equal a sharded node on the CPU."""
    from automerge_tpu_torch.sync.sharded_service import ShardedEngineDocSet
    ids, rounds = _service_streams(n_docs=96, rounds=3)
    out = {}
    for devices in (None, ["cpu"]):
        svc = ShardedEngineDocSet(n_shards=4, devices=devices)
        if devices is None:
            assert all(s._resident.device.type == "cuda" for s in svc.shards)
        before = cuda_kernels.LAUNCHES["reconcile_rows_hash"]
        for rnd in rounds:
            with svc.batch():
                for d, chs in rnd.items():
                    svc.apply_changes(d, chs)
        h = svc.hashes()
        launched = cuda_kernels.LAUNCHES["reconcile_rows_hash"] - before
        first = (svc.last_hashes_clean_shards, svc.last_hashes_dirty_shards)
        before = cuda_kernels.LAUNCHES["reconcile_rows_hash"]
        assert svc.hashes() == h
        clean = cuda_kernels.LAUNCHES["reconcile_rows_hash"] - before
        out[devices is None] = (h, first,
                                (svc.last_hashes_clean_shards,
                                 svc.last_hashes_dirty_shards),
                                {d: svc.clock_of(d) for d in ids},
                                svc.hashes_for(ids[::7]))
        svc.close()
        if devices is None:
            assert launched >= 1 and clean == 0
    assert out[True] == out[False]


@pytest.mark.cuda
def test_sharded_shards_bind_to_every_card(cuda_device):
    """One shard on each card of the machine (devices round-robin): each
    shard's rows live on its own card, and the hashes equal a CPU node's."""
    from automerge_tpu_torch.sync.sharded_service import ShardedEngineDocSet
    n = torch.cuda.device_count()
    devs = [torch.device("cuda", k) for k in range(n)]
    ids, rounds = _service_streams(n_docs=16 * n, rounds=2)
    card = ShardedEngineDocSet(n_shards=n, devices=devs)
    cpu = ShardedEngineDocSet(n_shards=n, devices=["cpu"])
    try:
        for rnd in rounds:
            for node in (card, cpu):
                for d, chs in rnd.items():
                    node.apply_changes(d, chs)
        assert card.hashes() == cpu.hashes()
        for k, s in enumerate(card.shards):
            assert s._resident.device == devs[k]
            assert s._resident.rows_dev.device == devs[k]
    finally:
        card.close()
        cpu.close()


@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["json", "columnar"])
def test_tcp_pair_on_the_card_equals_the_cpu(cuda_device, wire):
    """A rows node written on the card carried over TCP on 127.0.0.1 to a
    rows node on the card, and the same pair on the CPU: both pairs
    converge, and the card's hashes, clocks and documents equal the
    CPU's."""
    import time
    from automerge_tpu_torch.sync.service import EngineDocSet
    from automerge_tpu_torch.sync.tcp import TcpSyncClient, TcpSyncServer
    ids, rounds = _service_streams(n_docs=48, rounds=3)
    out = {}
    for dev in (cuda_device, "cpu"):
        writer = EngineDocSet(backend="rows", device=dev)
        node = EngineDocSet(backend="rows", device=dev)
        server = TcpSyncServer(node, wire=wire).start()
        client = TcpSyncClient(writer, server.host, server.port,
                               wire=wire).start()
        try:
            for rnd in rounds:
                with writer.batch():
                    for d, chs in rnd.items():
                        writer.apply_changes(d, chs)
            want = writer.hashes()
            deadline = time.monotonic() + 120
            while node.hashes() != want:
                assert time.monotonic() < deadline, "no convergence"
                time.sleep(0.01)
            out[str(dev)] = (want, {d: node.clock_of(d) for d in ids},
                             {d: node.materialize(d) for d in ids[:6]})
        finally:
            client.close()
            server.close()
            writer.close()
            node.close()
    assert out[str(cuda_device)] == out["cpu"]


def _bench_batch(config):
    """Bench config `config`'s batch (workloads.BENCH_CONFIGS), and its
    changes."""
    from automerge_tpu_torch import workloads
    from automerge_tpu_torch.engine.encode import encode_doc, stack_docs
    dc = workloads.BENCH_CONFIGS[config]()
    actors = sorted({c.actor for chs in dc for c in chs})
    batch = stack_docs([encode_doc(chs, actors) for chs in dc])
    return dc, batch, int(batch.pop("max_fids"))


@pytest.mark.cuda
@pytest.mark.parametrize("config", [2, 3, 4])
def test_compact_wires_on_the_card_equal_the_cpu(cuda_device, config):
    """The compact and byte wires of bench configs 2-4 widened on the card
    equal the wide buffer, and their hashes through the kernel equal the
    CPU's; configs 3 and 4 sit past the base envelope, so their launches
    take the XL body (B2)."""
    from automerge_tpu_torch.engine import pack
    dc, batch, mf = _bench_batch(config)
    rows, dims, n = pack.pack_rows(batch, mf)
    bufs, meta, _, _ = pack.pack_rows_compact(batch, mf)
    wire, bmeta, _, _ = pack.pack_rows_bytes(batch, mf)
    widened = pack.widen_rows(*(torch.from_numpy(b).to(cuda_device)
                                for b in bufs), meta)
    np.testing.assert_array_equal(widened.cpu().numpy(), rows)
    np.testing.assert_array_equal(pack.widen_bytes(
        torch.from_numpy(wire).to(cuda_device), bmeta).cpu().numpy(), rows)
    want = hashes_to_numpy(pack.apply_rows_hash_compact(*bufs, meta, dims,
                                                        device="cpu"))
    xl = cuda_kernels.LAUNCHES["reconcile_rows_hash_xl"]
    got = _launched("reconcile_rows_hash", lambda: pack.apply_rows_hash_bytes(
        wire, bmeta, dims, device=cuda_device))
    np.testing.assert_array_equal(hashes_to_numpy(got), want)
    got_c = _launched("reconcile_rows_hash",
                      lambda: pack.apply_rows_hash_compact(
                          *bufs, meta, dims, device=cuda_device))
    np.testing.assert_array_equal(hashes_to_numpy(got_c), want)
    past_base = not pack.rows_dims_eligible(*dims[:3])
    assert past_base == (config in (3, 4))
    assert cuda_kernels.LAUNCHES["reconcile_rows_hash_xl"] \
        == xl + (2 if past_base else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 3])
def test_mesh_on_the_card_equals_the_unsharded_engine(cuda_device, shards):
    """The card's mesh (all its CUDA devices, or three shards on this
    card): reconcile_sharded (both list orders), reconcile_rows_sharded
    and its byte wire equal apply_batch on the card and on the CPU, and
    the clock union is the fleet's."""
    from automerge_tpu_torch.engine.batchdoc import apply_batch
    from automerge_tpu_torch.parallel import global_clock_union, make_mesh
    from automerge_tpu_torch.parallel import mesh as pmesh
    from automerge_tpu_torch.workloads import docset_fleet
    ids, initial, _ = docset_fleet(n_docs=300)
    dc = [initial[d] for d in ids]
    mesh = (make_mesh() if shards == 1
            else make_mesh(devices=[cuda_device] * shards))
    _, _, out = apply_batch(dc, device="cpu")
    want = hashes_to_numpy(out["hash"])
    _, _, card = apply_batch(dc, device=cuda_device)
    np.testing.assert_array_equal(hashes_to_numpy(card["hash"]), want)
    for host_order in (True, False):
        _, got, n = pmesh.reconcile_sharded(dc, mesh, host_order=host_order)
        assert got["hash"].device.type == "cuda"
        np.testing.assert_array_equal(hashes_to_numpy(got["hash"])[:n], want)
    wide, _ = pmesh.reconcile_rows_sharded(dc, mesh)
    narrow, _ = pmesh.reconcile_rows_sharded_bytes(dc, mesh)
    np.testing.assert_array_equal(wide, want)
    np.testing.assert_array_equal(narrow, want)
    clocks = torch.randint(0, 50, (len(ids), 3), dtype=torch.int32)
    union = global_clock_union(clocks.to(cuda_device), mesh)
    assert union.device.type == "cuda"
    assert union.tolist() == clocks.amax(0).tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("host_order", [True, False])
def test_dense_on_the_card_equals_apply_doc(cuda_device, host_order,
                                            monkeypatch):
    """The quarantined dense reconcile, opted in, on bench config 5's
    docset fleet (300 docs and 3 rounds): every output key equal to
    apply_doc's on the card and to its own run on the CPU; without the
    variable the same call raises."""
    from automerge_tpu_torch.engine import experimental_dense as xd
    from automerge_tpu_torch.engine.encode import encode_doc, stack_docs
    from automerge_tpu_torch.workloads import docset_fleet
    ids, initial, rounds = docset_fleet(n_docs=300, rounds=3)
    dc = [initial[d] + [c for r in rounds for c in r.get(d, [])]
          for d in ids]
    actors = sorted({c.actor for chs in dc for c in chs})
    batch = stack_docs([encode_doc(chs, actors) for chs in dc])
    mf = int(batch.pop("max_fids"))
    card = {k: torch.from_numpy(v).to(cuda_device) for k, v in batch.items()}
    monkeypatch.delenv(xd.ALLOW_ENV, raising=False)
    with pytest.raises(NotImplementedError, match="quarantined"):
        xd.reconcile_dense(card, mf, host_order)
    monkeypatch.setenv(xd.ALLOW_ENV, "1")
    got = xd.reconcile_dense(card, mf, host_order)
    want = apply_doc(card, mf, host_order)
    cpu = xd.reconcile_dense(batch, mf, host_order, device="cpu")
    assert got["hash"].device.type == "cuda"
    for k in want:
        np.testing.assert_array_equal(got[k].cpu().numpy(),
                                      want[k].cpu().numpy(), err_msg=k)
        np.testing.assert_array_equal(got[k].cpu().numpy(),
                                      cpu[k].numpy(), err_msg=k)
