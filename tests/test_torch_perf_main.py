"""Subcommand routing of `python -m automerge_tpu_torch.perf`
(`automerge_tpu_torch/perf/__main__.py`) held to the reference's on the
CPU.

Through `torch_twin_helpers.run_twin`, the cases of the reference's
`tests/test_perf_main.py` run on both packages. Left out, with its
reason: `test_lazy_subcommands_route_with_rest_argv` imports each plane
by the string `automerge_tpu.perf.<module>`, which the twin cannot
rebind; `test_lazy_subcommands_route_on_both_packages` below runs its
table on both packages by each package's own module path, for every
lazily routed subcommand of the reference's CLI, `roofline` and
`resident` included. Tolerance: exact.
"""

import importlib

import pytest

from torch_twin_helpers import collect, hygiene_teardown, run_twin

CASES = collect("test_perf_main", exclude={
    "test_lazy_subcommands_route_with_rest_argv":
        "imports each plane by the string 'automerge_tpu.perf.<module>'; "
        "test_lazy_subcommands_route_on_both_packages below is its twin",
})

ROUTES = [
    ("doctor", "doctor", "main"),
    ("explain", "explain", "main"),
    ("top", "top", "main"),
    ("dispatch", "dispatchplane", "main"),
    ("tenant", "tenantplane", "main"),
    ("trace", "traceplane", "main"),
    ("remediate", "remediate", "smoke_main"),
    ("move", "moveplane", "smoke_main"),
    ("bootstrap", "bootstrap", "smoke_main"),
    ("race", "raceplane", "smoke_main"),
    ("megabatch", "megabatchplane", "smoke_main"),
    ("roofline", "roofline", "main"),
    ("resident", "resident", "main"),
]


@pytest.fixture(autouse=True)
def _hygiene():
    yield
    hygiene_teardown()


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.id)
def test_reference_case_on_both_packages(case, tmp_path, monkeypatch,
                                         capsys):
    run_twin(case, tmp_path, monkeypatch, capsys=capsys)


@pytest.mark.parametrize("package", ["automerge_tpu", "automerge_tpu_torch"])
@pytest.mark.parametrize("cmd,modname,attr", ROUTES)
def test_lazy_subcommands_route_on_both_packages(monkeypatch, package, cmd,
                                                 modname, attr):
    main = importlib.import_module(f"{package}.perf.__main__").main
    mod = importlib.import_module(f"{package}.perf.{modname}")
    calls = []

    def fake(argv=None):
        calls.append(list(argv) if argv is not None else None)
        return 0
    monkeypatch.setattr(mod, attr, fake)
    assert main([cmd, "--flag", "v"]) == 0
    assert calls == [["--flag", "v"]]

