"""The port's docs-major sync service (`EngineDocSet(backend="resident")`)
and its live views (`live_views=True`: the diff stream, `view()`, the
per-op stream `engine.diffs.PerOpDiffStream`) held to the reference's, on
the CPU.

Every case of the reference's `tests/test_engine_service.py` (but its TCP
cases) and `tests/test_perop_stream.py` runs twice through
`torch_twin_helpers.run_twin`: on `automerge_tpu`, then rebound to the
port (`device="cpu"`). Its own assertions must hold on the port (the
batch oracle, `batchdoc.apply_batch`, is the port's with its hashes read
back as np.uint32), every document it makes must match the reference's,
and every `EngineDocSet` it makes must give the reference's `hashes()`,
clocks and missing changes. Tolerance: exact.
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


@pytest.fixture(autouse=True)
def _hygiene():
    yield
    hygiene_teardown()


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reference_case_on_both_packages(case, tmp_path, monkeypatch):
    run_twin(case, tmp_path, monkeypatch)
