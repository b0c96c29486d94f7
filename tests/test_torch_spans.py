"""The text-merge plane: the port's pack_spans, merge_spans and
span_rank_hash (device="cpu", the kernel's plain PyTorch version) against
the reference's pack_spans, XLA merge_spans, numpy merge_spans_host and
span_rank_hash_pallas in interpret mode, on the same inputs made from
seeds. Tolerance: exact (integer outputs, uint32 hashes bit for bit)."""

import numpy as np
import pytest
import torch

from automerge_tpu.core import textspans as ref_textspans
from automerge_tpu.core.elems import ElemList
from automerge_tpu.engine import span_kernels as ref_sk
from automerge_tpu.engine.pack import pack_spans as ref_pack_spans

from automerge_tpu_torch.core import textspans
from automerge_tpu_torch.engine import span_kernels as sk
from automerge_tpu_torch.engine.dispatch import result_to_numpy
from automerge_tpu_torch.engine.pack import pack_spans
from automerge_tpu_torch.workloads import (
    SPAN_ARANK, SPAN_ORIGINS, divergent_side_events, merge_table_from_events,
    random_span_tables, reference_span_tables, span_bulk_merge, span_fleet)

from test_textspans import _random_tables
from torch_port_helpers import load_bench, load_reference_script

INT32_MIN, INT32_MAX = -2**31, 2**31 - 1


def _extreme_tables():
    """int32-extreme priorities, slots, lengths and hashes: the sort keys'
    negation wraps (-INT32_MIN == INT32_MIN) and the sums overflow."""
    rng = np.random.default_rng(7)
    tables = random_span_tables(rng, 3, 60, full_range=True)
    tables.append([(INT32_MAX, INT32_MIN, INT32_MAX, INT32_MAX, INT32_MIN,
                    INT32_MIN, 0),
                   (INT32_MIN, INT32_MAX, INT32_MAX, INT32_MAX, INT32_MAX,
                    INT32_MAX, 1),
                   (1, 2, INT32_MAX, -1, INT32_MIN, 0, INT32_MIN),
                   (3, 4, 5, INT32_MAX, 0, INT32_MIN, INT32_MAX)])
    return tables


def _config10_tables():
    """Small config-10 tables built by the bench's own generator and the
    reference's core.textspans.merge_table (bench._merge_table_from_events)
    on a base of 4,096 elements."""
    bench = load_bench()
    base = [f"A:{i}" for i in range(1, 4097)]
    tables = []
    for i in range(3):
        _, e1 = bench.gen_divergent_side(base, len(base), 1, "A", "C", 41,
                                         seed=300 + i)
        _, e2 = bench.gen_divergent_side(base, len(base), 1, "A", "B", 41,
                                         seed=600 + i)
        rows, _, _, _ = bench._merge_table_from_events(
            len(base), {"C": e1, "B": e2}, SPAN_ARANK, SPAN_ORIGINS)
        tables.append(rows)
    return tables


CASES = {
    "random0": lambda: _random_tables(0),
    "random1": lambda: _random_tables(1),
    "random2": lambda: _random_tables(2, n_docs=9, max_spans=300),
    "extreme": _extreme_tables,
    "empty_and_padded": lambda: [[], [(7, 0, 3, 0, 0, 0, 0)], []],
    # slot INT32_MAX with keys above the padding's: the span sorts after
    # the masked lanes, whose starts stay the running total before it
    "after_padding": lambda: [[(3, 4, 5, INT32_MAX, 0, 0, 1),
                               (1, 1, 2, 0, 0, 0, 0),
                               (2, 2, 7, INT32_MAX, -4, 0, 0)]],
    "config10": _config10_tables,
}


def _np(out):
    return result_to_numpy(out)


@pytest.mark.parametrize("case", sorted(CASES))
def test_pack_spans_is_byte_equal(case):
    tables = CASES[case]()
    assert pack_spans(tables).tobytes() == ref_pack_spans(tables).tobytes()


@pytest.mark.parametrize("case", sorted(CASES))
def test_merge_spans_matches_xla_and_host(case):
    spans = ref_pack_spans(CASES[case]())
    want = {k: np.asarray(v) for k, v in ref_sk.merge_spans(spans).items()}
    host = ref_sk.merge_spans_host(spans)
    got = _np(sk.merge_spans(torch.from_numpy(pack_spans(CASES[case]()))))
    port_host = sk.merge_spans_host(spans)
    for k in ("order", "start", "total", "hash"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(host[k], want[k], err_msg=k)
        np.testing.assert_array_equal(port_host[k], want[k], err_msg=k)
        assert got[k].dtype == host[k].dtype, k


@pytest.mark.parametrize("case", sorted(CASES))
def test_span_rank_hash_matches_pallas_interpret(case):
    spans = ref_pack_spans(CASES[case]())
    sorted_spans, order = ref_sk.sort_spans(spans)
    p_starts, p_hash, p_total = ref_sk.span_rank_hash_pallas(
        sorted_spans, interpret=True)
    starts, h, total = sk.span_rank_hash(torch.from_numpy(sorted_spans))
    np.testing.assert_array_equal(starts.numpy(), np.asarray(p_starts))
    np.testing.assert_array_equal(h.numpy().view(np.uint32),
                                  np.asarray(p_hash))
    np.testing.assert_array_equal(total.numpy(), np.asarray(p_total))
    # read through `order` instead of a sorted copy: the same function
    s2, h2, t2 = sk.span_rank_hash(torch.from_numpy(spans),
                                   torch.from_numpy(order.astype(np.int32)))
    assert torch.equal(s2, starts) and torch.equal(h2, h) \
        and torch.equal(t2, total)
    port_sorted, port_order = sk.sort_spans(spans)
    np.testing.assert_array_equal(port_sorted, sorted_spans)
    np.testing.assert_array_equal(port_order, order)


def test_span_rank_hash_rejects_bad_lanes():
    with pytest.raises(ValueError, match="span lanes"):
        sk.span_rank_hash(torch.zeros((2, 7, 128), dtype=torch.int32))
    with pytest.raises(ValueError, match="span lanes"):
        sk.merge_spans(torch.zeros((2, 8, 128), dtype=torch.int64))
    with pytest.raises(ValueError, match="order"):
        sk.span_rank_hash(torch.zeros((2, 8, 128), dtype=torch.int32),
                          torch.zeros((2, 128), dtype=torch.int64))


def test_merge_table_rle_runs_and_spans_of_elems_equal_the_reference():
    base = [(1, 1, 5), (1, 6, 0), (1, 7, 3)]
    blocks = [(-1, 9, 2, [(2, 9, 4)]), (1, 12, 1, [(3, 12, 2), (3, 20, 1)])]
    assert textspans.merge_table(base, blocks) == \
        ref_textspans.merge_table(base, blocks)
    keys = ["A:1", "A:2", "A:4", "B:5", "B:6", "A:7", "a:b:8", "a:b:9"]
    assert list(textspans.rle_runs(keys)) == \
        list(ref_textspans.rle_runs(keys))
    el = ElemList(keys, list(range(len(keys))))
    assert textspans.spans_of_elems(el, None) == \
        ref_textspans.spans_of_elems(el, None)
    assert textspans.spans_of_elems(ElemList(), None) == []


@pytest.mark.parametrize("base_len,n_side,seeds",
                         [(4096, 41, (300, 600)), (4096, 41, (301, 601)),
                          (20_000, 200, (21, 22))])
def test_workload_tables_equal_the_benchs(base_len, n_side, seeds):
    """The port's event replay builds config 10's table exactly as the
    bench's generator and region split do (with the reference's
    merge_table), without building the document."""
    bench = load_bench()
    base = [f"A:{i}" for i in range(1, base_len + 1)]
    sides = {}
    for side, seed in zip(("C", "B"), seeds):
        _, ev = bench.gen_divergent_side(base, base_len, 1, "A", side,
                                         n_side, seed=seed)
        assert divergent_side_events(base_len, base_len, n_side, seed) == ev
        sides[side] = ev
    want = bench._merge_table_from_events(base_len, sides, SPAN_ARANK,
                                          SPAN_ORIGINS)
    assert merge_table_from_events(base_len, sides, SPAN_ARANK,
                                   SPAN_ORIGINS) == want


def test_span_workloads_totals_equal_expected_lengths():
    tables, expected = span_fleet(n_docs=12)
    host = sk.merge_spans_host(pack_spans(tables))
    np.testing.assert_array_equal(host["total"], expected)
    big, big_expected = span_bulk_merge(base_len=50_000)
    out = _np(sk.merge_spans(torch.from_numpy(pack_spans(big))))
    assert out["total"].tolist() == big_expected


def test_committed_span_outputs_hold_in_both_packages():
    """The span part of the .npz that chip_smoke.py holds the card to is
    what the reference computes today, and the port on the CPU reproduces
    it."""
    mod = load_reference_script()
    committed = np.load(mod.OUT)
    ref = mod.reference_span_outputs()
    got = _np(sk.merge_spans(torch.from_numpy(
        pack_spans(reference_span_tables()))))
    for k in ("order", "start", "total", "hash"):
        np.testing.assert_array_equal(committed[f"spans_{k}"],
                                      ref[f"spans_{k}"])
        np.testing.assert_array_equal(got[k], committed[f"spans_{k}"])


@pytest.mark.parametrize("s,warp", [(1, True), (128, True), (131, True),
                                    (sk.SPAN_WARP_MAX_S, True),
                                    (sk.SPAN_WARP_MAX_S + 1, False),
                                    (2176, False)])
def test_span_launch_plan_at_its_boundary(s, warp):
    """The kernel takes a warp per document up to SPAN_WARP_MAX_S span
    lanes (the span fleet's 128) and a block per document above (the
    bulk merge's 2,176)."""
    assert sk.span_launch(s) is warp


def test_merge_spans_is_its_three_steps():
    """merge_spans is merge_order, then the rank+hash through the order,
    then slot_starts: the pieces chip_smoke.py times one by one."""
    spans = torch.from_numpy(pack_spans(_extreme_tables()))
    order, mask = sk.merge_order(spans)
    starts_o, h, total = sk.span_rank_hash(spans, order.to(torch.int32))
    whole = sk.merge_spans(spans)
    assert torch.equal(whole["order"], order.to(torch.int32))
    assert torch.equal(whole["start"],
                       sk.slot_starts(spans, mask, order, starts_o))
    assert torch.equal(whole["hash"], h) and torch.equal(whole["total"],
                                                         total)
