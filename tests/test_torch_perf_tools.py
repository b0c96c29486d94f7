"""The port's device probes, `perf roofline` and `perf resident`, on the CPU.

- roofline: `--cpu-smoke` in a subprocess exits 0 with both tiny probes
  run (none skipped) and each chain's hash equal to the plain version's;
  the default path exits non-zero where there is no CUDA device; a probe's
  chain hash does not depend on the kernel body it asks for.
- resident: `resident.run` at 64 docs on the CPU reports every stage of
  the reference's breakdown, with `encode_admit` > 0 on rounds that all
  take the batched admission route (`_encode_rounds_batched`, which the
  reference leaves outside its stages) and `accounted` <= `total`; its
  final hashes equal the reference engine's after the same frames. Its
  `gc` stage (not the reference's) holds the collections that run outside
  every other stage, which `apply_round_frames` defers to its exit.
Tolerance: exact (hashes).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_twin_helpers import hygiene_teardown

from automerge_tpu.core.change import Change as RefChange
from automerge_tpu.engine.resident_rows import (
    ResidentRowsDocSet as RefResidentRowsDocSet)

from automerge_tpu_torch import workloads
from automerge_tpu_torch.perf import resident, roofline
from automerge_tpu_torch.utils import metrics

REPO = Path(__file__).resolve().parent.parent

# The stages of the reference's breakdown (automerge_tpu/perf/resident.py)
REFERENCE_STAGES = {"register", "precheck", "encode_admit", "grow",
                    "triplets", "dispatch_enqueue", "frame_decode",
                    "final_readback"}
# the port's one stage more: collections outside every other stage
PORT_STAGES = REFERENCE_STAGES | {"gc"}


@pytest.fixture(autouse=True)
def _hygiene():
    yield
    hygiene_teardown()


def perf_cli(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, "-m", "automerge_tpu_torch.perf", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def test_roofline_cpu_smoke_runs_both_probes():
    p = perf_cli("roofline", "--cpu-smoke")
    assert p.returncode == 0, p.stderr
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["smoke"] is True and out["device"] == "cpu"
    assert [q["probe"] for q in out["probes"]] == ["smoke-base",
                                                    "smoke-trellis"]
    for q in out["probes"]:
        assert "skipped" not in q
        assert q["chain_equal"] is True
        assert q["passes"] == 2
    assert not (REPO / "ROOFLINE_torch.json").exists() or \
        "smoke" not in (REPO / "ROOFLINE_torch.json").read_text()


def test_roofline_default_path_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default path runs")
    p = perf_cli("roofline")
    assert p.returncode != 0
    assert "no CUDA device" in p.stderr
    assert "probes" not in p.stdout


def test_roofline_probe_fields_on_the_cpu():
    ids, initial, _ = workloads.docset_fleet(32, rounds=0)
    p = roofline.probe("tiny", [initial[d] for d in ids], False, 3,
                       device="cpu", copy_gb_s=1000.0)
    assert p["kernel"] == "base" and p["docs"] == 32
    assert p["doc_lanes"] == 128 and p["passes"] == 3
    assert p["fits_l2"] is False and p["l2_flushed"] is False
    assert p["chain_equal"] is True
    assert p["copy_GB_per_s"] == 1000.0 and p["hbm_peak_GB_per_s"] == 3350
    assert "ms/pass" in roofline.probe_line(p)


def test_roofline_xl_probe_gives_the_base_chain():
    """The XL body computes the same function: forcing it changes no
    hash (on the CPU both chains run the plain version; on the card
    chip_smoke.py phase 17 holds each body to it)."""
    docs = workloads.trellis() * 2
    base = roofline.probe("b", docs, False, 2, device="cpu")
    xl = roofline.probe("x", docs, True, 2, device="cpu")
    assert base["chain_hash"] == xl["chain_hash"]
    assert xl["kernel"] == "xl"


def test_roofline_skips_an_xl_probe_off_its_block():
    ids, initial, _ = workloads.docset_fleet(8, rounds=0)
    p = roofline.probe("odd", [initial[d] for d in ids], True, 1,
                       device="cpu")
    assert "skipped" in p and "XL block" in p["skipped"]


def reference_hashes(work):
    """The reference's rows engine fed what resident.run feeds the port's:
    the initial changes, a warm-up micro-batch, then the timed ones."""
    doc_ids, doc_changes, wire = work.doc_ids, work.doc_changes, work.wire
    n_rounds, n_batches = work.n_rounds, work.n_batches
    ref = RefResidentRowsDocSet(doc_ids)
    ref.apply_rounds([{d: [RefChange.from_dict(c.to_dict()) for c in chs]
                       for d, chs in zip(doc_ids, doc_changes)}],
                     interpret=True)
    np.asarray(ref.apply_round_frames(wire[:n_rounds], interpret=True))
    h = None
    for b in range(n_batches):
        h = ref.apply_round_frames(
            wire[n_rounds * (1 + b):n_rounds * (2 + b)], interpret=True)
    return np.asarray(h)[:len(doc_ids)].astype(np.uint32)


def test_resident_breakdown_counts_the_batched_admission():
    n_rounds, n_batches = 3, 2
    work = resident.build(n_docs=64, n_rounds=n_rounds, n_batches=n_batches)
    keys = ("rows_rounds_batched", "rows_rounds_fallback")
    before = [metrics.snapshot().get(k, 0) for k in keys]
    out = resident.run(device="cpu", workload=work)
    batched, fallback = (metrics.snapshot().get(k, 0) - b
                         for k, b in zip(keys, before))
    # the warm-up micro-batch (the first rounds of the new "bench" actor)
    # goes round by round; every timed round takes the batched route, so
    # _encode_round_frame never runs in the timed window and encode_admit
    # is _encode_rounds_batched's time
    assert (fallback, batched) == (n_rounds, n_rounds * n_batches)
    stages = out["stages_ms_per_round"]
    assert set(stages) == PORT_STAGES
    assert stages["encode_admit"] > 0
    assert 0 < out["accounted"] <= out["total_ms_per_round"]
    assert out["rounds"] == n_rounds * n_batches
    np.testing.assert_array_equal(out["hashes"], reference_hashes(work))


def test_resident_gc_stage_holds_the_collection_deferred_to_the_exit():
    """apply_round_frames runs under gc_paused, so the collection its
    allocations call for runs as it exits, outside every wrapped stage:
    the gc stage times it, once, and the accounted sum stays within the
    total. A threshold of 1 makes every round's exit collect."""
    import gc
    work = resident.build(n_docs=64, n_rounds=3, n_batches=2)
    threshold = gc.get_threshold()
    gc.set_threshold(1)
    try:
        out = resident.run(device="cpu", workload=work)
    finally:
        gc.set_threshold(*threshold)
    assert not any(cb.__name__ == "on_gc" for cb in gc.callbacks)
    assert out["stages_ms_per_round"]["gc"] > 0
    assert 0 < out["accounted"] <= out["total_ms_per_round"]


def test_resident_stage_table_wraps_both_admission_routes():
    assert resident.STAGES["encode_admit"] == ("_encode_rounds_batched",
                                               "_encode_round_frame")
    assert set(resident.STAGES) | {"frame_decode", "final_readback"} \
        == REFERENCE_STAGES
    from automerge_tpu_torch.engine.resident_rows import ResidentRowsDocSet
    for methods in resident.STAGES.values():
        for m in methods:
            assert callable(getattr(ResidentRowsDocSet, m))


def test_resident_cli_prints_one_json_object():
    p = perf_cli("resident", "--device", "cpu", "--docs", "16",
                 "--rounds", "2", "--batches", "1")
    assert p.returncode == 0, p.stderr
    out = json.loads(p.stdout)
    assert out["device"] == "cpu" and out["docs"] == 16
    assert set(out["stages_ms_per_round"]) == PORT_STAGES
    assert isinstance(out["hash_digest"], int)
