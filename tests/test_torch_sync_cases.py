"""The reference's remaining sync-layer cases that need the TCP transport,
the relay or the sharded node, run on both packages on the CPU through
`torch_twin_helpers.run_twin`: `tests/test_log_horizon.py` (the log
horizon behind a service, a fresh peer over real TCP, a sharded node
archiving per shard), `tests/test_lockprof.py` (the service lock renamed
per shard), `tests/test_observability_smoke.py` and `tests/test_frames.py`
(the AMWM envelope through `sync/tcp.py`'s codec). Each exclusion is named
with its reason. Tolerance: exact.
"""

import pytest

from torch_twin_helpers import (collect, helper_modules, hygiene_teardown,
                                port_apply_batch, run_twin)

from automerge_tpu.engine.batchdoc import apply_batch as ref_apply_batch

helper_modules("tests.test_compaction")

CASES = (
    collect("test_log_horizon", exclude={
        "test_concurrent_writers_archiver_and_reader":
            "its writer threads make documents in the scheduler's order, "
            "so the twin cannot pair them; tests/test_torch_logarchive.py "
            "holds concurrent writers and a reader against the archive",
    }, adapters={ref_apply_batch: port_apply_batch})
    + collect("test_lockprof")
    + collect("test_observability_smoke", exclude={
        "test_fleet_round_populates_expected_span_keys":
            "counts the JAX dispatch counters (engine_kernels_dispatched, "
            "metrics.dispatch_jit), which the port does not have",
    })
    + collect("test_frames")
)


@pytest.fixture(autouse=True)
def _hygiene():
    yield
    hygiene_teardown()


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reference_case_on_both_packages(case, tmp_path, monkeypatch):
    run_twin(case, tmp_path, monkeypatch)
