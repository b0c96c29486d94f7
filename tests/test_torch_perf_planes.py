"""The port's perf planes (`automerge_tpu_torch/perf/`: dispatch, fleet
collector, SLO engine, doctor, explain, top, remediation) held to the
reference's on the CPU.

Through `torch_twin_helpers.run_twin`, the cases of the reference's
`tests/test_dispatchplane.py`, `tests/test_fleet_health.py`,
`tests/test_storage_tier.py`, `tests/test_perf_top.py` and
`tests/test_perf_explain.py` run on both packages (the explain CLI cases
start `python -m automerge_tpu.perf`, which the port's run rewrites to
`python -m automerge_tpu_torch.perf`). Left out, with its reason:
`test_dispatchplane::test_smoke_run_asserts_ledger_account`, whose
ledger duty-cycle bound is a bound on wall time (it fails in some runs
of the reference); `test_dispatch_smoke_accounts_every_round` below runs
the port's smoke without the bound, and `chip_smoke.py` phase 16 holds
the bound on the card at full width.

The post-mortem readers are held across the packages: a metrics
snapshot and a flight-recorder dump written by one package, read by the
other's `doctor --post-mortem`, `explain --post-mortem` and `dispatch
--post-mortem`, give the same report lines (less the lines that name the
package). Tolerance: exact.
"""

import json
import subprocess

import pytest

from torch_twin_helpers import (PortSubprocess, collect, hygiene_teardown,
                                run_twin)

from automerge_tpu.perf import __main__ as ref_perf_main
from automerge_tpu.utils import flightrec as ref_flightrec
from automerge_tpu.utils import metrics as ref_metrics

from automerge_tpu_torch.perf import __main__ as perf_main
from automerge_tpu_torch.perf import (dispatchplane, history, raceplane,
                                      tenantplane, traceplane)
from automerge_tpu_torch.utils import flightrec, metrics

CASES = (
    collect("test_dispatchplane", exclude={
        "test_smoke_run_asserts_ledger_account":
            "its ledger duty-cycle bound is a bound on wall time; "
            "test_dispatch_smoke_accounts_every_round below runs the "
            "port's smoke without it, chip_smoke.py phase 16 with it",
    })
    + collect("test_fleet_health")
    + collect("test_storage_tier")
    + collect("test_perf_top")
    + collect("test_perf_explain",
              adapters={subprocess: PortSubprocess()})
)


@pytest.fixture(autouse=True)
def _hygiene():
    yield
    hygiene_teardown()


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reference_case_on_both_packages(case, tmp_path, monkeypatch,
                                         capsys):
    run_twin(case, tmp_path, monkeypatch, capsys=capsys)


# ---------------------------------------------------------------------------
# the port's smokes on the CPU, their wall-clock bounds lifted (chip_smoke.py
# phase 16 holds them on the card)


def test_dispatch_smoke_accounts_every_round(monkeypatch):
    monkeypatch.setattr(history, "DISPATCH_LEDGER_BUDGET_PCT", float("inf"))
    assert dispatchplane.smoke_run(n_docs=6, rounds=2, verbose=False,
                                   device="cpu") == 0


def test_tenant_smoke_attributes_every_tenant(monkeypatch):
    monkeypatch.setattr(history, "TENANT_LEDGER_BUDGET_PCT", float("inf"))
    assert tenantplane.smoke_run(verbose=False, device="cpu") == 0


def test_trace_smoke_stitches_across_the_socket(monkeypatch):
    monkeypatch.setattr(history, "TRACE_LEDGER_BUDGET_PCT", float("inf"))
    assert traceplane.smoke_run(verbose=False, device="cpu") == 0


@pytest.mark.parametrize("cmd", ["remediate", "move", "bootstrap", "race",
                                 "megabatch"])
def test_smoke_commands_pass_on_the_cpu(cmd, capsys, monkeypatch):
    # the race smoke's sanitizer-overhead bound is a bound on wall time
    monkeypatch.setattr(raceplane, "OVERHEAD_BOUND", float("inf"))
    assert perf_main.main([cmd, "--smoke", "--device", "cpu"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("perf launches: ")
    # the plain versions ran: no CUDA kernel was launched
    assert json.loads(last[len("perf launches: "):]) == {}


# ---------------------------------------------------------------------------
# post-mortems read across the packages


def _traffic(side):
    """A small stream from a DocSet to a rows service, with a dropped
    frame, on one package; its metrics snapshot after a hash read."""
    if side == "ref":
        import automerge_tpu as am
        from automerge_tpu.sync.connection import Connection
        from automerge_tpu.sync.docset import DocSet
        from automerge_tpu.sync.service import EngineDocSet
        m = ref_metrics
        kw = {}
    else:
        from automerge_tpu_torch import api as am
        from automerge_tpu_torch.sync.connection import Connection
        from automerge_tpu_torch.sync.docset import DocSet
        from automerge_tpu_torch.sync.service import EngineDocSet
        m = metrics
        kw = {"device": "cpu"}
    m.reset()
    a = DocSet(**kw)
    b = EngineDocSet(backend="rows", ingest_mode="locked", **kw)
    qa, qb = [], []
    ca, cb = Connection(a, qa.append), Connection(b, qb.append)
    ca.open()
    cb.open()
    doc = am.init("writer", **kw)
    for k in range(6):
        doc = am.change(doc, lambda d, k=k: d.__setitem__(f"k{k}", k))
        a.set_doc("doc", doc)
    sent = 0
    for _ in range(50):
        if not qa and not qb:
            break
        while qa:
            msg = qa.pop(0)
            sent += bool(msg.get("changes"))
            if sent == 3:          # the third change frame is lost
                m.bump("sync_frames_dropped")
                continue
            cb.receive_msg(msg)
        while qb:
            ca.receive_msg(qb.pop(0))
    b.hashes()
    b.close()
    return m.snapshot()


def _report(main, argv, capsys):
    capsys.readouterr()
    assert main(argv) == 0
    return [line for line in capsys.readouterr().out.splitlines()
            if "automerge_tpu" not in line]


@pytest.mark.parametrize("cmd", ["doctor", "explain", "dispatch"])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_post_mortem_reads_across_packages(cmd, writer, tmp_path, capsys):
    snap = _traffic(writer)
    dump_mod = ref_flightrec if writer == "ref" else flightrec
    snap_path = tmp_path / "snap.json"
    snap_path.write_text(json.dumps(snap))
    dump_path = dump_mod.dump("cross-package", path=str(tmp_path /
                                                       "dump.json"))
    assert dump_path is not None
    for path in (str(snap_path), dump_path):
        argv = [cmd, "--post-mortem", path]
        assert _report(perf_main.main, argv, capsys) \
            == _report(ref_perf_main.main, argv, capsys)
