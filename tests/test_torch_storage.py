"""The port's persistence (`api.save` / `load`, `storage.save_binary` /
`load_binary` / `changes_from_binary`, the bulk loader) held to the
reference's, on the CPU.

Every case of the reference's persistence, storage and bulk-load test
modules runs on both packages through `torch_twin_helpers.run_twin`: its
own assertions must hold on the port, and every document it makes must
match the reference's (`save()` text and `save_binary` bytes equal, equal
states and diff records, each package loading the other's output).
Tolerance: exact.
"""

import pytest

from torch_twin_helpers import collect, run_twin

CASES = (
    collect("test_persistence")
    + collect("test_storage")
    + collect("test_bulkload", exclude={
        "test_api_load_routes_large_logs_through_bulk":
            "its spy takes build_opset's one argument; the port's takes "
            "the device too (the port's copy of the case is below)",
    })
)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reference_case_on_both_packages(case, tmp_path, monkeypatch):
    run_twin(case, tmp_path, monkeypatch)


def test_api_load_routes_large_logs_through_bulk(monkeypatch):
    """test_bulkload's case on the port: a large saved log loads through
    build_opset, once, on the caller's device, to the reference's state."""
    import automerge_tpu as am
    from automerge_tpu.engine.batchdoc import oracle_state as ref_state
    import test_bulkload
    from automerge_tpu_torch import api
    from automerge_tpu_torch.core import bulkload
    from automerge_tpu_torch.engine.batchdoc import oracle_state

    doc = test_bulkload._random_trace(7)
    data = am.save(doc)
    orig = bulkload.build_opset
    calls = []

    def spy(cols, device):
        calls.append(device)
        return orig(cols, device)
    monkeypatch.setattr(bulkload, "build_opset", spy)
    loaded = api.load(data, device="cpu")
    assert [str(d) for d in calls] == ["cpu"]
    assert oracle_state(loaded) == ref_state(doc)
    assert api.save(loaded) == data


@pytest.mark.parametrize("variant,n", [("random", 3000), ("delete_heavy", 2000),
                                       ("paste_burst", 20_000)])
def test_text_load_logs_equal_the_benchs(variant, n):
    """workloads.text_load_log and divergent_side (the logs of bench
    configs 6 and 10 that chip_smoke.py loads and merges) are the bench's
    generators, draw for draw."""
    from torch_port_helpers import load_bench
    from automerge_tpu_torch import workloads
    bench = load_bench()
    want = bench.gen_text_load_log(n, seed=5, variant=variant,
                                   with_state=True)
    got = workloads.text_load_log(n, seed=5, variant=variant,
                                  with_state=True)
    assert got == want
    wire, seq, mx, nb = got
    for actor, seed in (("C", 21), ("B", 22)):
        assert workloads.divergent_side(seq, mx, nb, "A", actor, 400,
                                        seed) == \
            bench.gen_divergent_side(seq, mx, nb, "A", actor, 400, seed)
