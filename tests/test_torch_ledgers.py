"""The port's per-doc convergence ledger (`sync/docledger.py`), tenant
ledger (`sync/tenantledger.py`) and the dispatch ledger's hand-offs to
them held to the reference's, on the CPU.

The cases of the reference's `tests/test_docledger.py` and
`tests/test_tenantledger.py` that need no socket and no unported module
run on both packages through `torch_twin_helpers.run_twin`; the
environment switches both ledgers cache (`AMTPU_DOCLEDGER`,
`AMTPU_TENANTLEDGER`, `AMTPU_TENANT_PREFIX`, `AMTPU_CHAOS_*`) are set only
through monkeypatch and re-read at setup and after each undo. Below them,
a service's round split by tenant reaches the tenant ledger through the
dispatch ledger's fold on both packages alike. Tolerance: exact.
"""

import pytest

from torch_twin_helpers import collect, hygiene_teardown, run_twin

from automerge_tpu.core.change import Change as RefChange, Op as RefOp
from automerge_tpu.sync import tenantledger as ref_tenantledger
from automerge_tpu.sync.service import EngineDocSet as RefEngineDocSet
from automerge_tpu.utils import flightrec as ref_flightrec
from automerge_tpu.utils import metrics as ref_metrics

from automerge_tpu_torch.core.change import Change, Op
from automerge_tpu_torch.core.ids import ROOT_ID
from automerge_tpu_torch.sync import tenantledger
from automerge_tpu_torch.sync.service import EngineDocSet
from automerge_tpu_torch.utils import flightrec, metrics

CASES = (
    collect("test_docledger")
    + collect("test_tenantledger", exclude={
        "test_attribution_check_sums_to_totals":
            "needs automerge_tpu.perf.tenantplane, which is not ported",
    })
)


@pytest.fixture(autouse=True)
def _hygiene():
    yield
    hygiene_teardown()


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reference_case_on_both_packages(case, tmp_path, monkeypatch):
    run_twin(case, tmp_path, monkeypatch)


def _round_accounts(ref: bool) -> tuple:
    """One batch() of ingress over two tenants' docs on one package's
    rows service: the tenant ledger's account and the flight recorder's
    dispatch_round event."""
    led, rec, mets = ((ref_tenantledger, ref_flightrec, ref_metrics) if ref
                      else (tenantledger, flightrec, metrics))
    ch, op = (RefChange, RefOp) if ref else (Change, Op)
    mets.reset()
    led._reset_all()
    rec.reset()
    svc = (RefEngineDocSet(backend="rows", ingest_mode="locked") if ref
           else EngineDocSet(backend="rows", device="cpu",
                             ingest_mode="locked"))
    docs = ["tenant/a/1", "tenant/a/2", "tenant/b/1"]
    with svc.batch():
        for k, d in enumerate(docs):
            svc.apply_changes(d, [ch(actor="W", seq=1, deps={}, ops=[
                op("set", ROOT_ID, key="k", value=k)])])
    svc.hashes()
    svc.close()
    sec = led.snapshot_section()
    rounds = [{k: v for k, v in e.items() if k not in ("t", "seq",
                                                         "thread")}
              for e in rec.events() if e["kind"] == "dispatch_round"]
    tenants = {t: {k: v for k, v in acc.items()
                   if not k.endswith(("_s", "_at")) and k != "lag"}
               for t, acc in sec["nodes"]["local"]["tenants"].items()}
    return tenants, rounds


def test_round_tenant_split_reaches_the_tenant_ledger():
    ref, port = _round_accounts(True), _round_accounts(False)
    assert set(port[0]) == {"a", "b"}
    assert port == ref
    assert port[1] and port[1][0]["docs"] == 3
