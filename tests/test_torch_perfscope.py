"""The port's dispatch counters and perfscope (`utils/metrics.dispatch_jit`,
`utils/perfscope.py`) held to the reference's on the CPU.

Through `torch_twin_helpers.run_twin`, the cases of the reference's
`tests/test_perfscope.py` and `tests/test_metrics.py` run on both
packages. Left out, each with its reason:

- `test_dispatch_compile_telemetry_rows` asserts fields of XLA's cost and
  memory analysis of a `jax.jit` kernel (flops, HBM sections);
- `test_dispatch_attribution_is_thread_exact` and
  `test_perf_section_resets_with_metrics` count `jax.jit` compile-cache
  misses and cache hits of a fresh jitted closure. On the port a retrace
  is a kernel-library build, so their counterparts below drive the build
  hook (`perfscope.note_build`) from two threads at once, and hold the
  memory/cost rows across a reset.

The port's counters are also held label by label to the reference's on
the same streams: every twin case of `tests/test_torch_service.py` and
`tests/test_torch_service_views.py` (rows and docs-major engines, the
megabatch, partial-read, compaction and fault routes) compares the two
runs' `engine_kernels_dispatched{kernel=...}` (`run_twin(...,
dispatches=True)`). `engine_kernels_retraced` is compared only as "the
port counts no build on the CPU": a reference XLA compile is not a port
build. Tolerance: exact.
"""

import threading

import pytest
import torch

from torch_twin_helpers import collect, hygiene_teardown, run_twin

from automerge_tpu_torch import api
from automerge_tpu_torch.engine import batchdoc, cuda_kernels
from automerge_tpu_torch.engine.resident import ResidentDocSet
from automerge_tpu_torch.engine.resident_rows import ResidentRowsDocSet
from automerge_tpu_torch.utils import flightrec, metrics, perfscope

XLA_CACHE = ("counts jax.jit compile-cache misses of a fresh jitted "
             "closure; on the port a retrace is a kernel build "
             "(test_build_attribution_is_thread_exact / "
             "test_rows_survive_reset_with_metrics below)")

CASES = (
    collect("test_perfscope", exclude={
        "test_dispatch_compile_telemetry_rows":
            "asserts fields of XLA's cost and memory analysis",
        "test_dispatch_attribution_is_thread_exact": XLA_CACHE,
        "test_perf_section_resets_with_metrics": XLA_CACHE,
    })
    + collect("test_metrics")
)


@pytest.fixture(autouse=True)
def _hygiene():
    yield
    hygiene_teardown()


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reference_case_on_both_packages(case, tmp_path, monkeypatch,
                                         caplog):
    run_twin(case, tmp_path, monkeypatch, caplog=caplog)


# ---------------------------------------------------------------------------
# the port's build telemetry


def _building_kernel(name, builds=1, seconds=0.25):
    """A device program whose call builds a library `builds` times first
    (the build hook as cuda_kernels.build and native call it)."""
    def fn(x):
        for _ in range(builds):
            perfscope.note_build(name, seconds)
        return x + 1
    return fn


def test_a_build_inside_a_dispatch_is_its_retrace():
    metrics.reset()
    x = torch.arange(8, dtype=torch.int32)
    metrics.dispatch_jit("pt_toy", _building_kernel("pt_toy"), x)
    metrics.dispatch_jit("pt_toy", lambda t: t + 1, x)      # built already
    snap = metrics.snapshot()
    assert snap["engine_kernels_dispatched{kernel=pt_toy}"] == 2
    assert snap["engine_kernels_retraced{kernel=pt_toy}"] == 1
    row = snap["perf"]["kernels"]["pt_toy"]
    assert row["dispatches"] == 2 and row["compiles"] == 1
    assert row["compile_s"] == 0.25
    assert snap["engine_kernel_compile{kernel=pt_toy}_s"] == 0.25
    # memory and cost rows: the call's tensor bytes, no flops
    assert row["memory"] == {"argument": 32, "output": 32}
    assert row["cost"] == {"flops": None, "bytes_accessed": 64.0}
    assert snap["engine_kernel_hbm_bytes{kernel=pt_toy,section=argument}"] \
        == 32
    events = [e for e in flightrec.events()
              if e.get("kind") == "dispatch"]
    assert [e.get("retraced") for e in events[-2:]] == [True, None]


def test_a_build_outside_any_dispatch_is_unattributed():
    metrics.reset()
    perfscope.note_build("reconcile_rows", 1.5)
    row = metrics.snapshot()["perf"]["kernels"]["(unattributed)"]
    assert row == {"dispatches": 0, "compiles": 1, "compile_s": 1.5}


def test_build_attribution_is_thread_exact():
    """Two threads dispatch at once, each building on every other call:
    each kernel gets exactly its own builds (the marker stack is
    thread-local), none lands unattributed."""
    metrics.reset()
    n = 6
    barrier = threading.Barrier(2)
    errs = []

    def worker(name):
        try:
            barrier.wait()
            x = torch.zeros(4)
            for i in range(2 * n):
                fn = (_building_kernel(name, seconds=0.01) if i % 2 == 0
                      else (lambda t: t))
                metrics.dispatch_jit(name, fn, x)
        except Exception as e:   # noqa: BLE001 - surfaced below
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(k,),
                                name=f"amtpu-torch-test-{k}")
               for k in ("pt_a", "pt_b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs, errs
    snap = metrics.snapshot()
    for name in ("pt_a", "pt_b"):
        assert snap[f"engine_kernels_dispatched{{kernel={name}}}"] == 2 * n
        assert snap[f"engine_kernels_retraced{{kernel={name}}}"] == n
        assert snap["perf"]["kernels"][name]["compiles"] == n
    assert "(unattributed)" not in snap["perf"]["kernels"]


def test_rows_survive_reset_with_metrics():
    x = torch.ones(16, dtype=torch.int64)
    metrics.dispatch_jit("pt_reset", _building_kernel("pt_reset"), x)
    assert "perf" in metrics.snapshot()
    metrics.reset()
    assert metrics.snapshot() == {}
    metrics.dispatch_jit("pt_reset", lambda t: t * 2, x)    # built already
    row = metrics.snapshot()["perf"]["kernels"]["pt_reset"]
    assert row["dispatches"] == 1 and row["compiles"] == 0
    assert row["memory"] == {"argument": 128, "output": 128}
    assert row["cost"]["bytes_accessed"] == 256.0


def test_a_failed_dispatch_is_counted_and_raises():
    metrics.reset()

    def boom(x):
        raise RuntimeError("device fault")
    with pytest.raises(RuntimeError, match="device fault"):
        metrics.dispatch_jit("pt_boom", boom, torch.zeros(2))
    snap = metrics.snapshot()
    assert snap["engine_kernels_dispatched{kernel=pt_boom}"] == 1
    assert snap["perf"]["kernels"]["pt_boom"]["dispatches"] == 1


def _rows_round(device="cpu", n_docs=5):
    ids = [f"d{i}" for i in range(n_docs)]
    changes = {}
    for i, d in enumerate(ids):
        doc = api.change(api.init("A", device=device),
                         lambda x, i=i: x.__setitem__("n", i))
        changes[d] = doc._doc.opset.get_missing_changes({})
    rset = ResidentRowsDocSet(ids, device=device)
    rset.apply_rounds([changes])
    return rset, changes


def test_cpu_plain_versions_never_build():
    """Every dispatch site of both engines on the CPU: dispatches counted
    under the reference's labels, zero builds, and no launch of a CUDA
    kernel (the plain versions ran)."""
    metrics.reset()
    launches = dict(cuda_kernels.LAUNCHES)
    rset, changes = _rows_round()
    rset.hashes()
    more = api.change(api.init("B", device="cpu"),
                      lambda x: x.__setitem__("m", 1))
    rset.apply_rounds([{"d1": more._doc.opset.get_missing_changes({})}])
    rset.hashes_for([1])
    batchdoc.apply_batch([changes["d0"]], device="cpu")
    ds = ResidentDocSet(list(changes), device="cpu")
    ds.apply_and_reconcile({d: changes[d] for d in changes})
    ds.reconcile()
    snap = metrics.snapshot()
    dispatched = {k for k in snap
                  if k.startswith("engine_kernels_dispatched{")}
    assert {"engine_kernels_dispatched{kernel=scan_rounds}",
            "engine_kernels_dispatched{kernel=apply_doc}",
            "engine_kernels_dispatched{kernel=scatter_and_apply}"} \
        <= dispatched
    assert not [k for k in snap if k.startswith("engine_kernels_retraced")]
    assert all(row["compiles"] == 0
               for row in snap["perf"]["kernels"].values())
    assert cuda_kernels.LAUNCHES == launches


def test_cpu_live_footprint_is_the_engines_resident_tensors(monkeypatch):
    """On the CPU the gauge is the resident tensor bytes of the live
    engines, not the arguments of whichever dispatch sampled last: a
    narrow sub-batch read leaves it at least the rows buffer."""
    monkeypatch.setattr(perfscope, "LIVE_SAMPLE_INTERVAL_S", 0.0)
    metrics.reset()
    rset, _ = _rows_round(n_docs=300)
    rset.hashes()
    # the narrow sub-batch read that hashes_for takes for a minority of
    # dirty lanes: one lane gathered into a [ROWS, k_pad] buffer
    rset._reconcile_lanes([1])
    snap = metrics.snapshot()
    assert snap["engine_kernels_dispatched{kernel=reconcile_rows_hash}"] \
        == 1
    assert snap["obs_live_arrays_peak_bytes"] \
        >= snap["obs_live_arrays_bytes"] > 0
    assert snap["obs_live_arrays_bytes"] >= rset.device_bytes() \
        == rset.rows_dev.numel() * rset.rows_dev.element_size()


def test_a_list_of_tensors_signs_by_shape_and_never_formats_one(
        monkeypatch):
    def no_repr(self):
        raise AssertionError("a tensor was formatted")
    monkeypatch.setattr(torch.Tensor, "__repr__", no_repr)
    a = [torch.zeros(3, 3, dtype=torch.int64), torch.ones(2, 3)]
    b = [torch.full((3, 3), 7, dtype=torch.int64), torch.zeros(2, 3)]
    sig = perfscope._signature((a, {"x": torch.zeros(4)}, (1, 2), 5), {})
    assert sig == perfscope._signature(
        (b, {"x": torch.ones(4)}, (1, 2), 5), {})
    assert sig[0][0] == ("l", (("a", (3, 3), "torch.int64"),
                               ("a", (2, 3), "torch.float32")))
    assert perfscope._signature(([torch.zeros(4, 3)],), {}) != \
        perfscope._signature(([torch.zeros(5, 3)],), {})


def test_rounds_of_equal_shapes_keep_one_signature():
    rset, _ = _rows_round()
    sigs = perfscope._store.kernels["scan_rounds"].signatures
    assert len(sigs) == 1
    for v in (10, 20):
        again = {}
        for i, d in enumerate(rset.doc_ids):
            doc = api.change(api.init(f"v{v}", device="cpu"),
                             lambda x, i=i: x.__setitem__("n", i + v))
            again[d] = doc._doc.opset.get_missing_changes({})
        rset.apply_rounds([again])
    assert metrics.snapshot()[
        "engine_kernels_dispatched{kernel=scan_rounds}"] >= 3
    assert len(perfscope._store.kernels["scan_rounds"].signatures) == 2


def test_a_kernel_keeps_at_most_max_signatures(monkeypatch):
    monkeypatch.setattr(perfscope, "MAX_SIGNATURES", 4)
    for n in range(1, 10):
        metrics.dispatch_jit("pt_shapes", lambda t: t + 1,
                             torch.zeros(n))
    snap = metrics.snapshot()
    assert snap["engine_kernels_dispatched{kernel=pt_shapes}"] == 9
    assert len(perfscope._store.kernels["pt_shapes"].signatures) == 4
    # the rows keep the analysis of the last signature kept
    assert snap["perf"]["kernels"]["pt_shapes"]["memory"] == \
        {"argument": 16, "output": 16}
