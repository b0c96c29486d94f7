"""The port's bench-history gate (`automerge_tpu_torch/perf/history.py`,
`python -m automerge_tpu_torch.perf check|report`) held to the
reference's on the CPU.

Through `torch_twin_helpers.run_twin`, the cases of the reference's
`tests/test_perf_history.py` run on both packages; its CLI cases start
`python -m automerge_tpu.perf`, which the port's run rewrites to
`python -m automerge_tpu_torch.perf` (`PortSubprocess`). Left out, each
with its reason: `test_backfill_from_committed_bench_captures` and
`test_cli_check_backfills_missing_history` read the reference's
committed `BENCH_r0*.json` captures (TPU and CPU runs of the JAX
package), which the port's history never reads; the port-written cases
below hold the port's own file, its captures and its clean skip.
Tolerance: exact (report lines and exit codes).
"""

import json
import subprocess
import sys

import pytest

from torch_twin_helpers import (PortSubprocess, collect, hygiene_teardown,
                                run_twin)

from automerge_tpu_torch.perf import history

REF_CAPTURES = ("reads the reference's committed BENCH_r0*.json captures, "
                "which the port's history never reads")

CASES = collect("test_perf_history", exclude={
    "test_backfill_from_committed_bench_captures": REF_CAPTURES,
    "test_cli_check_backfills_missing_history": REF_CAPTURES,
}, adapters={subprocess: PortSubprocess()})


@pytest.fixture(autouse=True)
def _hygiene():
    yield
    hygiene_teardown()


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reference_case_on_both_packages(case, tmp_path, monkeypatch):
    run_twin(case, tmp_path, monkeypatch)


def test_history_names_the_ports_own_files():
    """The history and the planes' default post-mortem are the port's
    files, never the reference's bench_history.jsonl / BENCH_DETAIL.json
    (runs of the JAX package)."""
    assert history.history_path().endswith("/bench_history_torch.jsonl")
    assert history.detail_path().endswith("/BENCH_DETAIL_TORCH.json")


def test_backfill_reads_only_the_ports_captures(tmp_path):
    """A reference capture beside the port's history is never read; a
    port capture is, and no history file is made from nothing."""
    ref_capture = {"parsed": {"value": 100.0, "backend": "tpu",
                              "configs": {"5": 2.0}}}
    (tmp_path / "BENCH_r04.json").write_text(json.dumps(ref_capture))
    assert history.backfill_records(str(tmp_path)) == []
    path = str(tmp_path / history.HISTORY_BASENAME)
    assert history.ensure_backfilled(str(tmp_path), path) == 0
    assert not (tmp_path / history.HISTORY_BASENAME).exists()
    port_capture = {"parsed": {"value": 250.0, "backend": "cuda",
                               "configs": {"5": 3.0}}}
    (tmp_path / "BENCH_TORCH_r01.json").write_text(json.dumps(port_capture))
    (rec,) = history.backfill_records(str(tmp_path))
    assert rec["backend"] == "cuda" and rec["value"] == 250.0
    assert rec["source"] == "backfill:BENCH_TORCH_r01.json"
    assert history.ensure_backfilled(str(tmp_path), path) == 1


def test_cli_check_skips_without_history(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "automerge_tpu_torch.perf", "check",
         "--history", str(tmp_path / "none.jsonl")],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "SKIP" in out.stdout and "PERFCHECK OK" in out.stdout
    assert not (tmp_path / "none.jsonl").exists()


def test_cuda_records_are_judged_only_against_cuda(tmp_path):
    """The same-backend rule keeps port records apart from the
    reference's: a slow cuda run is never judged against fast cpu or tpu
    history, and is judged against cuda history."""
    p = str(tmp_path / "h.jsonl")

    def rec(value, backend):
        return {"schema": 1, "at": 0.0, "source": "t", "backend": backend,
                "value": value, "unit": "ops/sec", "vs_baseline": 1.0,
                "configs": {}}
    for r in (rec(1000, "tpu"), rec(1000, "cpu"), rec(100, "cuda")):
        history.append(r, p)
    rc, lines = history.check(path=p)
    assert rc == 0, lines
    for r in (rec(1000, "cuda"), rec(1000, "cuda"), rec(100, "cuda")):
        history.append(r, p)
    rc, lines = history.check(path=p)
    assert rc == 1, lines
