"""The port's sharded sync node (`automerge_tpu_torch/sync/sharded_service.py`,
`ShardedEngineDocSet`) held to the reference's on the CPU.

Through `torch_twin_helpers.run_twin`, the cases of the reference's
`tests/test_sharded_service.py` run on both packages; every sharded node a
case makes is recorded on both sides and must give the reference's
`hashes()`, clocks and missing changes. Left out, each with its reason:

- `test_shards_bind_to_distinct_devices` asks `jax.devices()` for four
  CPU devices; torch has one CPU device. Replaced below by
  `test_shards_bind_to_their_devices_on_the_cpu` (four shards on
  `[cpu] * 4`) and, on the card, by
  `tests/test_torch_cuda.py::test_sharded_shards_bind_to_every_card`.
- `test_mixed_tenant_batch_coalesces_and_attributes_per_shard` ends in
  `automerge_tpu.perf.tenantplane.attribution_check`, which is not ported.

The reference's `tests/test_hypothesis_sync_chaos.py` (a triangle of an
interpretive DocSet, a docs-major node and a rows or sharded node over
lossy links) runs on both packages under a fixed hypothesis seed
(`derandomize=True`); the reference's own sharded triangle is unseeded.

A seeded fleet in bench config 8's shape, cut to 400 documents (load in
shard-coalesced bursts, streamed rounds to 2% of the fleet, a dirty
read, a clean re-read, a minority `hashes_for`), goes through a reference
and a port sharded node: hashes, clean and dirty shard counts, routing,
clocks and documents equal. Tolerance: exact.
"""

import random
import tempfile
import threading
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import test_hypothesis_sync_chaos as sync_chaos
from torch_twin_helpers import (collect, helper_case, helper_modules,
                                hygiene_teardown, run_twin)

from automerge_tpu.core.change import Change as RefChange, Op as RefOp
from automerge_tpu.sync.sharded_service import (
    ShardedEngineDocSet as RefShardedEngineDocSet)

from automerge_tpu_torch.core.change import Change, Op
from automerge_tpu_torch.core.ids import ROOT_ID
from automerge_tpu_torch.sync import ShardedEngineDocSet
from automerge_tpu_torch.sync import sharded_service

helper_modules("tests.test_rows_service")

CASES = collect("test_sharded_service", exclude={
    "test_shards_bind_to_distinct_devices":
        "asks jax.devices() for four CPU devices (torch has one); "
        "test_shards_bind_to_their_devices_on_the_cpu below is the port's",
    "test_mixed_tenant_batch_coalesces_and_attributes_per_shard":
        "needs automerge_tpu.perf.tenantplane, which is not ported",
})

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _hygiene():
    yield
    hygiene_teardown()


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reference_case_on_both_packages(case, tmp_path, monkeypatch):
    run_twin(case, tmp_path, monkeypatch)


_TRIANGLE = dict(max_examples=12, deadline=None, derandomize=True,
                 suppress_health_check=[HealthCheck.too_slow])


def _triangle(test, steps):
    with tempfile.TemporaryDirectory() as tmp, \
            pytest.MonkeyPatch.context() as mp:
        run_twin(helper_case("test_hypothesis_sync_chaos",
                             test.hypothesis.inner_test, {"steps": steps}),
                 Path(tmp), mp)


@settings(**_TRIANGLE)
@given(st.lists(sync_chaos._step, min_size=1, max_size=25))
def test_chaos_triangle_converges_on_both_packages(steps):
    _triangle(sync_chaos.test_triangle_converges_after_chaos_and_reconnect,
              steps)


@settings(**_TRIANGLE)
@given(st.lists(sync_chaos._step, min_size=1, max_size=25))
def test_chaos_triangle_with_sharded_node_on_both_packages(steps):
    _triangle(sync_chaos.test_triangle_with_sharded_node_converges, steps)


# ---------------------------------------------------------------------------
# devices and threads


def _one_change(ref, i, actor="W", seq=1, deps=None):
    ch, op = (RefChange, RefOp) if ref else (Change, Op)
    return ch(actor=actor, seq=seq, deps=deps or {},
              ops=[op("set", ROOT_ID, key=f"k{i % 4}", value=i)])


def test_devices_none_puts_every_shard_on_the_card():
    """Without `devices=` every shard asks for the card, and raises where
    there is none (no shard falls back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the card case is in "
                    "tests/test_torch_cuda.py")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ShardedEngineDocSet(n_shards=2)


def test_shards_bind_to_their_devices_on_the_cpu():
    """Four shards bound round-robin over `[cpu] * 4`: each shard's engine
    and its device copy of the rows live on its own device, and the
    fleet's hashes equal the reference's."""
    devs = [torch.device("cpu")] * 4
    port = ShardedEngineDocSet(n_shards=4, devices=devs)
    ref = RefShardedEngineDocSet(n_shards=4)
    try:
        for i in range(16):
            port.apply_changes(f"d{i}", [_one_change(False, i)])
            ref.apply_changes(f"d{i}", [_one_change(True, i)])
        assert port.hashes() == ref.hashes()
        for k, s in enumerate(port.shards):
            rset = s._resident
            assert rset.device == devs[k]
            assert rset.rows_dev is not None
            assert rset.rows_dev.device == devs[k]
    finally:
        port.close()
        ref.close()


def test_hash_fanout_threads_are_named_and_joined(monkeypatch):
    """A read of two or more dirty shards fans out on one thread a dirty
    shard, `amtpu-torch-hashfan-<k>`, non-daemon, joined before the read
    returns; a read of one dirty shard runs on the caller's thread."""
    made = []

    class Recording(threading.Thread):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            if "hashfan" in self.name:
                made.append(self)

    monkeypatch.setattr(sharded_service.threading, "Thread", Recording)
    e = ShardedEngineDocSet(n_shards=3, devices=[CPU])
    try:
        for i in range(12):
            e.apply_changes(f"d{i}", [_one_change(False, i)])
        e.hashes()
        assert sorted(t.name for t in made) == [
            f"amtpu-torch-hashfan-{k}" for k in range(3)]
        assert all(not t.daemon and not t.is_alive() for t in made)
        made.clear()
        e.apply_changes("d0", [_one_change(False, 99, seq=2)])
        e.hashes()
        assert made == []
        assert (e.last_hashes_clean_shards, e.last_hashes_dirty_shards) \
            == (2, 1)
    finally:
        e.close()


# ---------------------------------------------------------------------------
# bench config 8's fleet, cut to size, on both packages


def _fleet_changes(ref, n_docs, rounds, frac, seed):
    """Load: one 4-`set` change a doc; then `rounds` rounds that each give
    one change to `frac` of the fleet (drawn from `seed`)."""
    ch, op = (RefChange, RefOp) if ref else (Change, Op)
    rng = random.Random(seed)
    load = {f"doc{i:05d}": ch(actor=f"w{i % 7}", seq=1, deps={}, ops=[
        op("set", ROOT_ID, key=f"f{j}", value=i * 4 + j) for j in range(4)])
        for i in range(n_docs)}
    seqs = {d: 1 for d in load}
    out = []
    for r in range(rounds):
        docs = rng.sample(sorted(load), max(1, int(n_docs * frac)))
        rnd = {}
        for d in docs:
            seqs[d] += 1
            actor = load[d].actor
            rnd[d] = ch(actor=actor, seq=seqs[d], deps={}, ops=[
                op("set", ROOT_ID, key=f"f{r % 4}", value=r * 1000 + seqs[d])])
        out.append(rnd)
    return load, out


def test_config8_fleet_shape_equals_the_reference():
    n_docs, shards = 400, 8
    nodes = {}
    try:
        for side in ("ref", "port"):
            ref = side == "ref"
            node = (RefShardedEngineDocSet(n_shards=shards) if ref
                    else ShardedEngineDocSet(n_shards=shards, devices=[CPU]))
            nodes[side] = node
            load, rounds = _fleet_changes(ref, n_docs, 3, 0.02, seed=8)
            with node.batch():
                for d, c in load.items():
                    node.apply_changes(d, [c])
            first = node.hashes()
            for rnd in rounds:
                for d, c in rnd.items():
                    node.apply_changes(d, [c])
            dirty = node.hashes()
            counts = (node.last_hashes_clean_shards,
                      node.last_hashes_dirty_shards)
            again = node.hashes()
            clean = (node.last_hashes_clean_shards,
                     node.last_hashes_dirty_shards)
            minority = sorted(rounds[-1])[:5]
            nodes[side + "_out"] = (
                first, dirty, counts, again, clean,
                node.hashes_for(minority),
                [node.shards.index(node.shard_of(d)) for d in sorted(load)],
                {d: node.clock_of(d) for d in minority},
                {d: node.materialize(d) for d in minority})
        r, p = nodes["ref_out"], nodes["port_out"]
        assert p == r
        assert r[4] == (shards, 0)          # the re-read is all cache
        assert r[2][1] >= 1
        assert {np.uint32(v) for v in r[1].values()} \
            == {np.uint32(v) for v in p[1].values()}
    finally:
        for k in ("ref", "port"):
            if k in nodes:
                nodes[k].close()
