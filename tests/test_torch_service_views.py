"""The port's docs-major sync service (`EngineDocSet(backend="resident")`)
and its live views (`live_views=True`: the diff stream, `view()`, the
per-op stream `engine.diffs.PerOpDiffStream`) held to the reference's, on
the CPU.

Every case of the reference's `tests/test_engine_service.py` and `tests/test_perop_stream.py` runs twice through
`torch_twin_helpers.run_twin`: on `automerge_tpu`, then rebound to the
port (`device="cpu"`). Its own assertions must hold on the port (the
batch oracle, `batchdoc.apply_batch`, is the port's with its hashes read
back as np.uint32), every document it makes must match the reference's,
and every `EngineDocSet` it makes must give the reference's `hashes()`,
clocks and missing changes, and the two runs' dispatch counts
(`engine_kernels_dispatched{kernel=...}`) must be equal, label by label,
except in the cases whose count depends on thread scheduling (SCHEDULED:
TCP pairs and concurrent ingress threads, where the number of messages,
and so of `apply_doc` dispatches, varies from run to run). Tolerance:
exact.
"""

import pytest

from torch_twin_helpers import (collect, hygiene_teardown, port_apply_batch,
                                run_twin)

from automerge_tpu.engine.batchdoc import apply_batch as ref_apply_batch

CASES = (
    collect("test_engine_service",
            adapters={ref_apply_batch: port_apply_batch})
    + collect("test_perop_stream")
)


# cases whose dispatch count depends on thread scheduling
SCHEDULED = {"test_two_peer_tcp_no_deadlock", "test_tcp_columnar_sync",
             "test_subscriber_sees_rounds_in_ingress_order"}


@pytest.fixture(autouse=True)
def _hygiene():
    yield
    hygiene_teardown()


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reference_case_on_both_packages(case, tmp_path, monkeypatch):
    run_twin(case, tmp_path, monkeypatch,
             dispatches=case.name not in SCHEDULED)
