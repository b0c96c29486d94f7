"""The port's static analysis (`automerge_tpu_torch/analysis/`) held to the
reference's (`automerge_tpu/analysis/`).

1. The reference's own cases on both packages. The fixture cases of
   `test_analysis_core.py`, `test_analysis_locks.py`,
   `test_analysis_races.py`, `test_metrics_lint.py` and
   `test_analysis_jit.py` run twice: as written, and from a copy of the
   module's source rewritten for the port (`port_module`: the analysis
   and utils imports, and every fixture path, under `automerge_tpu_torch`),
   so each side writes its fixture tree under its own package name. Every
   pass's findings are recorded on both sides and must be equal in rule,
   severity, path within the package, line, column and message (the
   package's name in a message read as the same). The cases that read the
   repo's own tree (TREE) run on the port's side only, on the port's tree,
   against the port's baseline and the manifest the port's sanitizer
   reads; the reference's run them in its own test files. Excluded, with
   the reason: test_analysis_jit.py's jax-root cases (EXCLUDED). The
   runtime cases of test_race_regressions.py run on both packages in
   tests/test_torch_tcp.py; those of test_thread_hygiene.py run here
   through `torch_twin_helpers`.
2. Port cases: one flagged and one clean fixture for each torch rule of the
   jit-hygiene pass, the torch readbacks of the lock pass, the CLI's
   torch hazard, and the lock manifest the CLI writes.
3. At full size: the port's analyzer over the reference's own tree gives
   the reference analyzer's findings for every pass but jit-hygiene (the
   six of `analysis_baseline.json`); the port's lock-order edges equal the
   15 of `locks_manifest.json`; every `amtpu-torch-*` thread's target is
   a thread root. Each full-tree project is built once per module.
"""

import importlib
import inspect
import json
import pathlib
import textwrap
import threading
import time
import types

import pytest

from torch_twin_helpers import collect, hygiene_teardown, run_twin

from automerge_tpu.analysis import core as ref_core
from automerge_tpu.analysis import flow as ref_flow
from automerge_tpu.analysis import jit_hygiene as ref_jit
from automerge_tpu.analysis import lock_discipline as ref_locks
from automerge_tpu.analysis import races as ref_races
from automerge_tpu.analysis import registry as ref_registry

from automerge_tpu_torch.analysis import core, flow, jit_hygiene
from automerge_tpu_torch.analysis import lock_discipline, races, registry
from automerge_tpu_torch.analysis.__main__ import main as cli_main
from automerge_tpu_torch.analysis.threadmap import thread_map
from automerge_tpu_torch.sync.audit import ConvergenceAuditor as PortAuditor
from automerge_tpu_torch.sync.connection import Connection as PortConnection
from automerge_tpu_torch.sync.service import (
    EngineDocSet as PortEngineDocSet)
from automerge_tpu_torch.utils import metrics as port_metrics

ROOT = pathlib.Path(__file__).resolve().parent.parent

MODULES = ("test_analysis_core", "test_analysis_locks",
           "test_analysis_races", "test_metrics_lint", "test_analysis_jit")

# The reference's jit-hygiene cases whose roots are jax forms (`jax.jit`,
# `static_argnames`, `pl.pallas_call`): the port's pass roots at
# `metrics.dispatch_jit` and `cuda_kernels.launch` instead; its own cases
# are in part 2.
_JAX_ROOTS = "a jax root (jax.jit / static_argnames): the port's roots " \
    "are metrics.dispatch_jit and cuda_kernels.launch (part 2)"
EXCLUDED = {
    "test_analysis_jit": {
        "test_item_and_scalar_casts_on_tracer_flagged": _JAX_ROOTS,
        "test_np_asarray_of_tracer_flagged_but_static_ok": _JAX_ROOTS,
        "test_block_until_ready_in_jit_reachable_code_flagged": _JAX_ROOTS,
        "test_host_sync_found_through_call_graph": _JAX_ROOTS,
        "test_unreachable_helper_not_flagged": _JAX_ROOTS,
        "test_branch_on_tracer_flagged_static_branch_ok": _JAX_ROOTS,
        "test_shape_reads_and_len_are_static": _JAX_ROOTS,
        "test_static_propagates_through_call_edge": _JAX_ROOTS,
        "test_jit_wrapped_inside_function_flagged": _JAX_ROOTS,
        "test_cached_wrapper_builder_not_flagged": _JAX_ROOTS,
        "test_module_level_jit_wrap_not_flagged": _JAX_ROOTS,
        "test_jit_call_expression_honors_static_argnums": _JAX_ROOTS,
        "test_static_argnames_typo_flagged": _JAX_ROOTS,
    },
    "test_analysis_core": {
        "test_cli_exits_nonzero_when_hazard_introduced":
            "its hazard is a jax.jit root; "
            "test_port_cli_exits_nonzero_when_a_torch_hazard_is_introduced "
            "is its twin",
    },
    "test_analysis_locks": {
        "test_repo_tcp_threads_are_named":
            "reads the reference's thread names; "
            "test_port_tcp_threads_are_named is its twin",
    },
}
# Cases that read the repo's own tree: run on the port's side only, on the
# port's tree (the reference's own test files run them on its tree).
TREE = {
    "test_analysis_core": {
        "test_cli_exits_zero_on_repo_with_committed_baseline",
        "test_cli_list_shows_grandfathered",
        "test_committed_baseline_entries_all_have_justifications"},
    "test_analysis_locks": {"test_repo_lock_findings_are_all_baselined"},
    "test_analysis_races": {"test_repo_race_findings_all_baselined",
                            "test_repo_lock_graph_matches_committed_manifest"},
    "test_metrics_lint": {"test_package_metric_names_are_registered",
                          "test_package_call_sites_use_canonical_names",
                          "test_registry_names_follow_scheme"},
    "test_analysis_jit": {"test_repo_jit_findings_are_all_baselined"},
}

# The reference test module's source, rewritten for the port.
REWRITES = (
    ("automerge_tpu.analysis", "automerge_tpu_torch.analysis"),
    ("automerge_tpu.utils", "automerge_tpu_torch.utils"),
    ('"automerge_tpu/', '"automerge_tpu_torch/'),
    ('"automerge_tpu"', '"automerge_tpu_torch"'),
    ('"analysis_baseline.json"', '"analysis_baseline_torch.json"'),
)

_PORT_MODULES: dict = {}
_FIXTURES: dict = {}


@pytest.fixture(autouse=True)
def _hygiene():
    yield
    hygiene_teardown()


def port_module(name: str) -> types.ModuleType:
    """The reference test module `name`, its source rewritten by REWRITES
    and run as a module of its own (its __file__ kept, so its ROOT is the
    repo's)."""
    mod = _PORT_MODULES.get(name)
    if mod is None:
        ref = importlib.import_module(name)
        src = pathlib.Path(ref.__file__).read_text()
        for old, new in REWRITES:
            src = src.replace(old, new)
        mod = types.ModuleType(f"port_{name}")
        mod.__file__ = ref.__file__
        exec(compile(src, ref.__file__, "exec"), mod.__dict__)
        _PORT_MODULES[name] = mod
    return mod


def _fixture(module, name: str, given: dict):
    """A module fixture's value (module-scoped ones computed once)."""
    key = (module.__name__, name)
    if key not in _FIXTURES:
        raw = getattr(module, name)._get_wrapped_function()
        _FIXTURES[key] = raw(**{p: _arg(module, p, given) for p in
                                inspect.signature(raw).parameters})
    return _FIXTURES[key]


def _arg(module, name: str, given: dict):
    return given[name] if name in given else _fixture(module, name, given)


def run_case(module, name: str, given: dict) -> None:
    fn = getattr(module, name)
    fn(**{p: _arg(module, p, given)
          for p in inspect.signature(fn).parameters})


PASSES = {
    "ref": (ref_registry.RegistryConformancePass, ref_jit.JitHygienePass,
            ref_locks.LockDisciplinePass, ref_races.RacePass),
    "port": (registry.RegistryConformancePass, jit_hygiene.JitHygienePass,
             lock_discipline.LockDisciplinePass, races.RacePass),
}
PACKAGES = {"ref": "automerge_tpu", "port": "automerge_tpu_torch"}


def normalized(finding, package: str) -> tuple:
    """A finding with its package's name taken out of its path and
    message."""
    path = finding.path
    if path.startswith(package + "/"):
        path = path[len(package) + 1:]
    return (finding.rule, finding.severity, path, finding.line,
            finding.col, finding.message.replace(package, "<pkg>"))


def record_passes(monkeypatch) -> dict:
    """Wrap every pass's run() of both packages to record its findings
    (normalized) by side."""
    out = {"ref": [], "port": []}
    for side, classes in PASSES.items():
        for cls in classes:
            def run(self, project, _orig=cls.run, _side=side):
                found = _orig(self, project)
                out[_side].append(sorted(
                    normalized(f, PACKAGES[_side]) for f in found))
                return found
            monkeypatch.setattr(cls, "run", run)
    return out


def _cases():
    out = []
    for name in MODULES:
        for case in collect(name, exclude=EXCLUDED.get(name, {})):
            out.append(pytest.param(name, case.name,
                                    id=f"{name}::{case.name}"))
    return out


@pytest.mark.parametrize("module,name", _cases())
def test_reference_case_on_both_packages(module, name, tmp_path,
                                         monkeypatch, capsys):
    found = record_passes(monkeypatch)
    if name in TREE.get(module, ()):
        run_case(port_module(module), name,
                 {"tmp_path": tmp_path, "capsys": capsys,
                  "monkeypatch": monkeypatch})
        return
    for side, mod in (("ref", importlib.import_module(module)),
                      ("port", port_module(module))):
        d = tmp_path / side
        d.mkdir()
        capsys.readouterr()
        run_case(mod, name, {"tmp_path": d, "capsys": capsys,
                             "monkeypatch": monkeypatch})
    assert found["port"] == found["ref"]


def test_every_reference_analysis_case_is_run_or_excluded():
    """Every case of the five modules is collected here, and every
    exclusion names a case that exists (collect() checks that too)."""
    names = {p.values[1] for p in _cases()}
    for module in MODULES:
        ref = importlib.import_module(module)
        tests = {n for n in vars(ref) if n.startswith("test")}
        assert tests == ({n for n in tests if n in names}
                         | set(EXCLUDED.get(module, {})))
        assert TREE.get(module, set()) <= names


_NAMES = ("looks threads up by the reference's names (amtpu-auditor, "
          "amtpu-watchdog); {} is its twin on the port's amtpu-torch- names")
THREAD_HYGIENE = collect("test_thread_hygiene", exclude={
    "test_auditor_stop_joins_thread":
        _NAMES.format("test_port_auditor_stop_joins_thread"),
    "test_no_observability_threads_leak_between_tests":
        _NAMES.format("test_port_observability_threads_do_not_leak"),
})


@pytest.mark.parametrize("case", THREAD_HYGIENE, ids=lambda c: c.id)
def test_thread_hygiene_case_on_both_packages(case, tmp_path, monkeypatch):
    run_twin(case, tmp_path, monkeypatch)


def _wait_until(predicate, timeout=5.0, interval=0.02):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


def _port_obs_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(("amtpu-torch-watchdog",
                                  "amtpu-torch-auditor"))]


def test_port_auditor_stop_joins_thread():
    svc = PortEngineDocSet(backend="rows", device="cpu")
    try:
        conn = PortConnection(svc, lambda m: None, wire="columnar")
        aud = PortAuditor(svc, conn, period_s=0.05).start()
        assert _wait_until(lambda: any(
            t.name == "amtpu-torch-auditor" for t in threading.enumerate()))
        thread = aud._thread
        aud.stop()
        assert aud._thread is None
        assert not thread.is_alive()
        aud.stop()   # idempotent
        assert not any(t.name == "amtpu-torch-auditor"
                       for t in threading.enumerate())
    finally:
        svc.close()


def test_port_observability_threads_do_not_leak(monkeypatch):
    monkeypatch.setattr(port_metrics._monitor, "linger_s", 0.05)
    svc = PortEngineDocSet(backend="rows", device="cpu")
    try:
        conn = PortConnection(svc, lambda m: None, wire="columnar")
        aud = PortAuditor(svc, conn, period_s=10.0).start()
        with port_metrics.watchdog("sync_hashes_fanout", budget_s=30.0):
            assert any(t.name == "amtpu-torch-watchdog"
                       for t in threading.enumerate())
        aud.stop()
    finally:
        svc.close()
    assert _wait_until(lambda: not _port_obs_threads()), _port_obs_threads()


# ---------------------------------------------------------------------------
# 2. the port's own cases


def _project(tmp_path, files: dict, package="automerge_tpu_torch"):
    for rel, source in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(source))
    return core.load_project(tmp_path, package=package)


def _jit(tmp_path, source, rel="automerge_tpu_torch/engine/fix.py",
         extra=None):
    files = dict(extra or {}, **{rel: source})
    return jit_hygiene.JitHygienePass().run(_project(tmp_path, files))


def _rules(findings):
    return [f.rule for f in findings]


HOST_SYNCS = '''\
    import numpy as np
    import torch

    from ..utils import metrics


    def kernel(x: torch.Tensor, n: int):
        a = x.sum().item()
        b = x.tolist()
        c = np.asarray(x)
        d = int(x[0])
        torch.cuda.synchronize()
        return helper(x) + n


    def helper(y):
        return y.cpu()


    def run(x):
        return metrics.dispatch_jit("k", kernel, x, 3)
    '''


def test_host_syncs_in_a_dispatched_function_flagged(tmp_path):
    findings = _jit(tmp_path, HOST_SYNCS)
    assert _rules(findings) == ["jit-host-sync"] * 6
    msgs = " ".join(f.message for f in findings)
    for what in (".item()", ".tolist()", "np.asarray()", "int()",
                 ".synchronize()", ".cpu() on a tensor in helper()"):
        assert what in msgs, what


def test_host_values_and_unreached_helpers_clean(tmp_path):
    findings = _jit(tmp_path, '''\
        import numpy as np
        import torch

        from ..utils import metrics


        def kernel(x: torch.Tensor, n: int, dims: tuple):
            m = int(n) + x.shape[0] + x.numel() + int(dims[0])
            if x.device.type == "cpu" and x is not None:
                m += len(x)
            host = np.asarray([n, m]).tolist()
            return torch.zeros(m, device=x.device), host


        def unreached(x):
            return x.item()


        def run(x):
            return metrics.dispatch_jit("k", kernel, x, 3, (8, 2))
        ''')
    assert findings == []


def test_a_kernel_wrapper_that_launches_is_a_root(tmp_path):
    launcher = {"automerge_tpu_torch/engine/cuda_kernels.py": '''\
        def launch(source, fn, counter, *args):
            return None
        '''}
    flagged = _jit(tmp_path / "a", '''\
        import torch

        from .cuda_kernels import launch


        def wrapper(x: torch.Tensor):
            n = int(x.max())
            launch("src", "amt_fn", "fn", x.data_ptr(), n)
        ''', extra=launcher)
    assert _rules(flagged) == ["jit-host-sync"]
    clean = _jit(tmp_path / "b", '''\
        import torch

        from .cuda_kernels import launch


        def wrapper(x: torch.Tensor, n: int):
            launch("src", "amt_fn", "fn", x.data_ptr(), x.numel(), n)


        def not_a_root(x):
            return int(x.max())
        ''', extra=launcher)
    assert clean == []


def test_branch_on_a_tensor_flagged(tmp_path):
    findings = _jit(tmp_path, '''\
        import torch

        from ..utils import metrics


        def kernel(x: torch.Tensor):
            if x.any():
                x = x + 1
            while x.sum() > 0:
                x = x - 1
            y = 1 if x.max() > 0 else 2
            assert x.all()
            return y


        def run(x):
            return metrics.dispatch_jit("k", kernel, x)
        ''')
    assert _rules(findings) == ["jit-tracer-branch"] * 4


def test_branch_on_host_values_clean(tmp_path):
    findings = _jit(tmp_path, '''\
        import torch

        from ..utils import metrics


        def kernel(x: torch.Tensor, parts: list[torch.Tensor], n: int,
                   trips: torch.Tensor | None = None):
            if trips is not None and x.shape[0] > n:
                x = x + trips
            for p in parts:
                x = x + p
            for name, t, k in (("a", x, 1), ("b", x, 2)):
                if k > 1 and name == "b":
                    x = t * k
            return x


        def run(x, parts):
            return metrics.dispatch_jit("k", kernel, x, parts, 4)
        ''')
    assert findings == []


def test_builds_on_the_call_path_flagged(tmp_path):
    findings = _jit(tmp_path, '''\
        import ctypes

        import torch

        from . import cuda_kernels


        def per_call(fn, path):
            lib = ctypes.CDLL(path)
            cuda_kernels.build(["reconcile_rows"])
            return torch.compile(fn), lib
        ''')
    assert _rules(findings) == ["jit-retrace"] * 3


def test_the_build_cache_and_module_level_compiles_clean(tmp_path):
    findings = _jit(tmp_path, '''\
        import ctypes

        import torch

        _CACHE = {}


        def _plain(x):
            return x


        compiled = torch.compile(_plain)


        def cached(key):
            fn = torch.compile(_plain)
            _CACHE[key] = fn
            return fn
        ''', extra={"automerge_tpu_torch/engine/cuda_kernels.py": '''\
        import ctypes


        def _library(path):
            return ctypes.CDLL(path)
        '''})
    assert findings == []


def test_shape_literals_flagged_outside_pack_only(tmp_path):
    drift = _jit(tmp_path / "a", '''\
        BUDGET = 22528


        def pad(n):
            return ((n + 127) // 128) * 128
        ''')
    assert _rules(drift) == ["jit-shape-drift"] * 2
    owner = _jit(tmp_path / "b", '''\
        LANE = 128
        ROWS_VMEM_BUDGET = 22528


        def pad_to_lanes(n):
            return ((n + LANE - 1) // LANE) * LANE
        ''', rel="automerge_tpu_torch/engine/pack.py")
    assert owner == []


READBACKS_UNDER_LOCK = '''\
    import threading

    import numpy as np

    from ..engine.cuda_kernels import hashes_to_numpy


    class Node:
        def __init__(self):
            self._lock = threading.Lock()

        def item(self, t):
            with self._lock:
                return t.item()

        def copy(self, t):
            with self._lock:
                return t.cpu()

        def read(self, h):
            with self._lock:
                return hashes_to_numpy(h)

        def host(self, m):
            with self._lock:
                return np.nonzero(m)[0].tolist()
    '''
CUDA_KERNELS_STUB = '''\
    def hashes_to_numpy(h):
        return h.cpu().numpy().view("uint32")
    '''


def test_torch_readbacks_under_a_lock_flagged(tmp_path):
    files = {"automerge_tpu_torch/sync/fix.py": READBACKS_UNDER_LOCK,
             "automerge_tpu_torch/engine/cuda_kernels.py": CUDA_KERNELS_STUB}
    findings = lock_discipline.LockDisciplinePass().run(
        _project(tmp_path, files))
    assert _rules(findings) == ["block-under-lock"] * 3
    msgs = sorted(f.message.split(" while")[0] for f in findings)
    assert msgs == ["blocking device-readback call hashes_to_numpy()",
                    "blocking device-readback call t.cpu()",
                    "blocking device-readback call t.item()"]


def test_torch_readbacks_count_on_the_port_tree_only(tmp_path):
    """The same module under the reference's package name: the torch table
    does not apply, so the analyzer keeps the reference's findings on the
    reference's tree."""
    files = {"automerge_tpu/sync/fix.py": READBACKS_UNDER_LOCK,
             "automerge_tpu/engine/cuda_kernels.py": CUDA_KERNELS_STUB}
    findings = lock_discipline.LockDisciplinePass().run(
        _project(tmp_path, files, package="automerge_tpu"))
    assert findings == []


def test_port_cli_exits_nonzero_when_a_torch_hazard_is_introduced(
        tmp_path, capsys):
    """The twin of test_cli_exits_nonzero_when_hazard_introduced: a host
    sync in a dispatched function fails the CLI; after --write-baseline
    it exits 0."""
    _project(tmp_path, {"automerge_tpu_torch/engine/hazard.py": '''\
        from ..utils import metrics


        def f(x):
            return float(x.sum())


        def run(x):
            return metrics.dispatch_jit("f", f, x)
        '''})
    assert cli_main(["--root", str(tmp_path)]) == 1
    assert "jit-host-sync" in capsys.readouterr().out
    assert cli_main(["--root", str(tmp_path), "--write-baseline"]) == 0
    assert (tmp_path / core.BASELINE_NAME).exists()
    assert not (tmp_path / "analysis_baseline.json").exists()
    assert cli_main(["--root", str(tmp_path)]) == 0


def test_write_locks_manifest_writes_the_port_files_only(tmp_path):
    _project(tmp_path, {"automerge_tpu_torch/sync/fix.py": '''\
        import threading


        class Node:
            def __init__(self):
                self._lock = threading.Lock()
                self._log_lock = threading.Lock()

            def a_then_b(self):
                with self._lock:
                    with self._log_lock:
                        pass
        '''})
    read = {"version": 1, "locks": [], "order": [],
            "lockfree": [{"attr": "X.y", "justification": "kept"}]}
    (tmp_path / "locks_manifest.json").write_text(json.dumps(read))
    assert cli_main(["--root", str(tmp_path), "--write-locks-manifest"]) == 0
    assert json.loads((tmp_path / "locks_manifest.json").read_text()) == read
    assert not (tmp_path / "docs" / "LOCK_HIERARCHY.md").exists()
    written = flow.LocksManifest.load(tmp_path / "locks_manifest_torch.json")
    assert written.order_edges() == {("Node._lock", "Node._log_lock")}
    assert written.lockfree_attrs() == {"X.y": "kept"}
    doc = (tmp_path / "docs" / "LOCK_HIERARCHY_TORCH.md").read_text()
    assert "automerge_tpu_torch.analysis --write-locks-manifest" in doc
    assert "`Node._lock` | `Node._log_lock`" in doc


def test_port_tcp_threads_are_named(port_tree):
    """The twin of test_repo_tcp_threads_are_named: the port's tcp reader
    and accept threads carry amtpu-torch- names the flight recorder can
    key on, and the threadmap finds their targets as thread roots."""
    tm = thread_map(port_tree)
    assert tm.thread_names["thread:tcp._Peer._read_loop"] \
        == "amtpu-torch-tcp-read-*"
    assert tm.thread_names["thread:tcp.TcpSyncServer._accept_loop"] \
        == "amtpu-torch-tcp-accept-*"


# ---------------------------------------------------------------------------
# 3. at full size


@pytest.fixture(scope="module")
def ref_tree():
    """The reference's tree analyzed by both analyzers: (the reference's
    findings, the port's findings, both projects)."""
    ref_project = ref_core.load_project(ROOT)
    port_project = core.load_project(ROOT, package="automerge_tpu")
    return (ref_core.run_passes(ref_project), core.run_passes(port_project),
            ref_project, port_project)


@pytest.fixture(scope="module")
def port_tree():
    return core.load_project(ROOT)


def _key(f):
    return (f.rule, f.path, f.line, f.col, f.severity, f.message)


def test_port_analyzer_gives_the_reference_findings_on_its_tree(ref_tree):
    ref, port, _, _ = ref_tree
    ref_keys = sorted(_key(f) for f in ref
                      if not f.rule.startswith("jit-"))
    port_keys = sorted(_key(f) for f in port
                       if not f.rule.startswith("jit-"))
    assert port_keys == ref_keys
    baseline = json.loads((ROOT / "analysis_baseline.json").read_text())
    assert sorted({(r, p, m) for r, p, _, _, _, m in port_keys}) == sorted(
        (e["rule"], e["path"], e["message"]) for e in baseline["findings"])
    assert len(port_keys) == 6


def test_both_analyzers_see_the_same_reference_files(ref_tree):
    _, _, ref_project, port_project = ref_tree
    assert [u.rel for u in port_project.units] \
        == [u.rel for u in ref_project.units]
    assert port_project.units[0].rel == "bench.py"


def test_port_scope_is_the_package_and_chip_smoke(port_tree):
    rels = [u.rel for u in port_tree.units]
    assert rels[0] == "chip_smoke.py"
    assert all(r.startswith("automerge_tpu_torch/") for r in rels[1:])
    assert not any(r.startswith("automerge_tpu_torch/build/") for r in rels)
    assert "automerge_tpu_torch/analysis/core.py" in rels


def test_port_lock_edges_are_the_manifests(port_tree, ref_tree):
    """The port's lock-order edges, as (before, after) pairs, equal the 15
    of locks_manifest.json (the file the port's sanitizer reads) and the
    reference analyzer's on the reference's tree."""
    committed = flow.LocksManifest.load(
        ROOT / "locks_manifest.json").order_edges()
    port_edges = set(flow.lock_graph(port_tree))
    assert len(committed) == 15
    assert port_edges == committed
    assert set(ref_flow.lock_graph(ref_tree[2])) == committed
    for (_a, _b), sites in flow.lock_graph(port_tree).items():
        assert sites[0][2].startswith("automerge_tpu_torch/")


def test_every_port_thread_target_is_a_root(port_tree):
    tm = thread_map(port_tree)
    names = set(tm.thread_names.values())
    assert names == {
        "amtpu-torch-auditor", "amtpu-torch-fleet-collector",
        "amtpu-torch-watchdog", "amtpu-torch-chaos-lockhold",
        "amtpu-torch-hashfan-*", "amtpu-torch-tcp-read-*",
        "amtpu-torch-tcp-accept-*", "amtpu-torch-tcp-supervisor-*",
        "amtpu-torch-race-smoke-scraper", "amtpu-torch-race-smoke-writer-*"}
    # the flusher's name comes from a function (amtpu-torch-flusher-<k>)
    assert "thread:epochs.Flusher._loop" in tm.roots
    assert "thread:tcp.TcpSyncServer._accept_loop" in tm.roots


def test_port_baseline_findings_by_rule():
    """The port's grandfathered findings: the reference's six on the
    port's copy of the same code, the plain move fixpoint's early exit,
    and the remediation guardrails the reference's analyzer cannot see."""
    doc = json.loads((ROOT / core.BASELINE_NAME).read_text())
    by_rule: dict = {}
    for e in doc["findings"]:
        by_rule[e["rule"]] = by_rule.get(e["rule"], 0) + e["count"]
        assert e["path"].startswith("automerge_tpu_torch/")
        assert e["justification"].strip()
    assert by_rule == {"block-under-lock": 4, "shared-mutate-aliased": 3,
                       "lockfree-undeclared": 1, "jit-host-sync": 1}


def test_registry_reads_the_knob_table_and_never_writes_it(port_tree):
    doc = ROOT / "docs" / "OBSERVABILITY.md"
    before = doc.read_bytes()
    found = registry.RegistryConformancePass().run(port_tree)
    assert not [f for f in found if f.rule == "env-knob-undocumented"]
    assert registry.documented_knobs(port_tree)
    assert doc.read_bytes() == before
