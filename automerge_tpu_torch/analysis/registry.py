"""registry-conformance pass: every observability name is declared (the
port's copy of `automerge_tpu/analysis/registry.py`). Names are checked
against the port's own registries (`utils.metrics`, `flightrec.
EVENT_KINDS`, `perfscope.PHASES`); the knob table is read from
docs/OBSERVABILITY.md, never written.

AST replacement for the old regex metrics lint (tests/test_metrics_lint.py
drove it): an unregistered metric/span/event name is a typo or a
naming-scheme violation — either way it mints a series nobody can find in
docs/OBSERVABILITY.md, which is how instrumentation rots. The regex could
only see `metrics.bump("literal"...)`; this pass also catches

- f-string names (`metrics.bump(f"sync_{kind}_sent")` — flagged as
  dynamic unless every part is constant),
- variable indirection (`name = "sync_frames_sent"; metrics.bump(name)`
  resolves through single-assignment locals),
- bare calls in modules that `from ...utils.metrics import bump`,
- and KIND mismatches: a counter name passed to `trace()` would silently
  export under `_s`/`_count` suffixes nothing in the docs mentions.

It also extends coverage to span names (`metrics.trace`/`watchdog`) and
flight-recorder event kinds (`flightrec.record("kind", ...)` against
`flightrec.EVENT_KINDS`).

Rules:

- **metric-unregistered** (error): name not in `metrics.REGISTRY` (or
  `ALIASES`). Declare it in COUNTERS/GAUGES/HISTOGRAMS/SPANS per the
  `<layer>_<noun>_<verb>` scheme (docs/OBSERVABILITY.md), or
  `metrics.register()` it at runtime and suppress the line.
- **metric-kind** (error): registered name used through the wrong API
  (counter traced, span bumped, ...).
- **metric-retired** (error): a pre-rename name whose alias window is
  closed; reintroducing it mints a fresh series nobody reads.
- **metric-dynamic** (warning): a name the pass cannot resolve (mutated
  local, computed f-string). Wrapper plumbing that forwards a parameter
  is exempt — the wrapper's call sites are checked instead.
- **flightrec-kind** (error) / **flightrec-dynamic** (warning): the same
  discipline for `flightrec.record` event kinds.
- **metric-scheme** (error): a REGISTRY entry violating the naming scheme
  itself, or an alias pointing at an unregistered canonical name.
- **env-knob-undocumented** (error): an `AMTPU_*` environment knob read
  (`os.environ.get` / `os.getenv` / `os.environ[...]`, literal name)
  that the docs/OBSERVABILITY.md "Environment knobs" table never
  mentions. A knob nobody can discover is configuration rot — the same
  failure mode as an unregistered metric, one layer up. Skipped when
  the doc is absent (fixture projects).

Scope: the whole analyzed package + its root script (chip_smoke.py for
the port, bench.py for the reference).
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass

from ..utils import flightrec as _flightrec
from ..utils import metrics as _metrics
from ..utils import perfscope as _perfscope
from .core import Finding, Project, SourceUnit, dotted_name

METRIC_FUNCS = ("bump", "gauge", "observe", "trace", "watchdog", "add_time")

# perfscope phase-attribution call forms (ctx manager + decorator); names
# are checked against perfscope.PHASES the same way metric names are
# checked against metrics.REGISTRY
PHASE_FUNCS = ("phase", "phased")

_KIND_TABLE = {
    "bump": ("counter", lambda m: m.COUNTERS),
    "gauge": ("gauge", lambda m: m.GAUGES),
    "observe": ("histogram", lambda m: m.HISTOGRAMS),
    "trace": ("span", lambda m: m.SPANS),
    "watchdog": ("span", lambda m: m.SPANS),
    "add_time": ("span", lambda m: m.SPANS),
}


def _modules(package: str) -> tuple[str, str, str]:
    """The metrics, flight-recorder and perfscope module names of
    `package`."""
    return (f"{package}.utils.metrics", f"{package}.utils.flightrec",
            f"{package}.utils.perfscope")

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")
LAYER_PREFIXES = ("core_", "engine_", "rows_", "sync_", "obs_")

# The pre-scheme names retired by the PR-2 rename (alias window closed).
# A call site reintroducing one would silently mint a fresh series.
RETIRED_METRIC_NAMES = frozenset({
    "changes_applied", "ops_applied", "diffs_emitted",
    "bulkload_fallback_keyerror", "host_bulk_built", "rows_compacted",
    "rows_rebuilt_from_log", "rows_poisoned", "log_horizon_truncations",
    "wire_frames_received", "log_archive_cold_reads",
    "log_archived_changes", "log_archive_torn_tail_repaired",
    "log_archive_torn_tail_skipped",
})


@dataclass(frozen=True)
class MetricUse:
    """One observability call site the pass extracted."""
    path: str
    line: int
    col: int
    api: str            # bump | gauge | observe | trace | watchdog |
    #                     add_time | record
    name: str | None    # resolved name, or None when dynamic
    dynamic_reason: str | None = None


def _import_aliases(unit: SourceUnit) -> dict[str, str]:
    """local name -> dotted target (module or symbol)."""
    mod = unit.modname
    pkg = mod.rsplit(".", 1)[0] if "." in mod else ""
    out: dict[str, str] = {}
    for node in ast.walk(unit.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = mod if unit.rel.endswith("__init__.py") else pkg
                for _ in range(node.level - 1):
                    base = base.rsplit(".", 1)[0] if "." in base else ""
                src = (base + "." + node.module) if node.module else base
            else:
                src = node.module or ""
            for a in node.names:
                if a.name != "*":
                    out[a.asname or a.name] = f"{src}.{a.name}"
    return out


class _ScopeResolver:
    """Resolve a call's first argument to a string: constants, all-constant
    f-strings, and single-assignment constant locals. Returns
    (name, dynamic_reason, is_param_forward)."""

    def __init__(self, const_env: dict[str, str | None],
                 params: set[str]):
        self.env = const_env
        self.params = params

    def resolve(self, node: ast.AST) -> tuple[str | None, str | None, bool]:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value, None, False
        if isinstance(node, ast.JoinedStr):
            parts = []
            for v in node.values:
                if isinstance(v, ast.Constant) and isinstance(v.value, str):
                    parts.append(v.value)
                else:
                    return None, "computed f-string name", False
            return "".join(parts), None, False
        if isinstance(node, ast.Name):
            if node.id in self.params:
                return None, None, True     # wrapper plumbing: exempt
            if node.id in self.env:
                val = self.env[node.id]
                if val is None:
                    return None, (f"local {node.id!r} is not a single "
                                  "constant assignment"), False
                return val, None, False
            return None, f"unresolvable name {node.id!r}", False
        return None, "computed metric name expression", False


def _const_envs(unit: SourceUnit) -> dict[int, dict[str, str | None]]:
    """Per-function (and module) constant-string environments: name ->
    value if assigned exactly once to a string constant, None if
    reassigned or non-constant."""
    envs: dict[int, dict[str, str | None]] = {}

    def collect(body_owner: ast.AST) -> dict[str, str | None]:
        env: dict[str, str | None] = {}

        def visit(node):
            # nested defs get their own env: a local rebind inside some
            # other function must not clobber a module-level constant
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not body_owner:
                return
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        if isinstance(node.value, ast.Constant) \
                                and isinstance(node.value.value, str) \
                                and tgt.id not in env:
                            env[tgt.id] = node.value.value
                        else:
                            env[tgt.id] = None
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                tgt = node.target
                if isinstance(tgt, ast.Name):
                    env[tgt.id] = None
            for child in ast.iter_child_nodes(node):
                visit(child)

        visit(body_owner)
        return env

    envs[id(unit.tree)] = collect(unit.tree)
    for node in ast.walk(unit.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            envs[id(node)] = collect(node)
    return envs


def _enclosing_func_map(unit: SourceUnit) -> dict[int, ast.AST | None]:
    out: dict[int, ast.AST | None] = {}

    def walk(node, enclosing):
        for child in ast.iter_child_nodes(node):
            out[id(child)] = enclosing
            walk(child, child if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef))
                else enclosing)

    walk(unit.tree, None)
    return out


def extract_uses(project: Project) -> list[MetricUse]:
    """Every metrics/flightrec call site in the project, with its resolved
    name (or dynamic reason). Parameter-forwarding wrappers are skipped —
    their call sites are extracted instead."""
    uses: list[MetricUse] = []
    modules = _modules(project.package)
    metrics_mod, flightrec_mod, perfscope_mod = modules
    for unit in project.units:
        if unit.rel.startswith(f"{project.package}/analysis/"):
            continue            # the lint's own sources talk ABOUT names
        aliases = _import_aliases(unit)
        envs = _const_envs(unit)
        enclosing = _enclosing_func_map(unit)
        is_metrics_mod = unit.modname == metrics_mod
        is_flightrec_mod = unit.modname == flightrec_mod
        is_perfscope_mod = unit.modname == perfscope_mod

        for node in ast.walk(unit.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            api = _classify_call(node, aliases,
                                 is_metrics_mod, is_flightrec_mod,
                                 is_perfscope_mod, modules)
            if api is None:
                continue
            host = enclosing.get(id(node))
            env = envs.get(id(host) if host is not None else id(unit.tree),
                           {})
            # module-level constants are visible inside functions too
            merged = dict(envs[id(unit.tree)])
            merged.update(env)
            params = set()
            if host is not None:
                a = host.args
                params = {p.arg for p in
                          a.posonlyargs + a.args + a.kwonlyargs}
                if a.vararg:
                    params.add(a.vararg.arg)
                if a.kwarg:
                    params.add(a.kwarg.arg)
            name, reason, forwarded = _ScopeResolver(
                merged, params).resolve(node.args[0])
            if forwarded:
                continue
            uses.append(MetricUse(path=unit.rel, line=node.lineno,
                                  col=node.col_offset, api=api,
                                  name=name, dynamic_reason=reason))
    return uses


def _classify_call(node: ast.Call, aliases: dict[str, str],
                   is_metrics_mod: bool, is_flightrec_mod: bool,
                   is_perfscope_mod: bool,
                   modules: tuple[str, str, str]) -> str | None:
    """"bump"/"trace"/... for a metrics call, "record" for a flightrec
    call, "phase" for a perfscope phase/phased call, None otherwise.
    `modules` names the analyzed package's metrics, flightrec and
    perfscope modules."""
    metrics_mod, flightrec_mod, perfscope_mod = modules
    fn = node.func
    if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name):
        target = aliases.get(fn.value.id, fn.value.id)
        if fn.attr in METRIC_FUNCS and (
                target == metrics_mod or target == "metrics"
                or target.endswith(".metrics")):
            return fn.attr
        if fn.attr == "record" and (
                target == flightrec_mod or target == "flightrec"
                or target.endswith(".flightrec")):
            return "record"
        if fn.attr in PHASE_FUNCS and (
                target == perfscope_mod or target == "perfscope"
                or target.endswith(".perfscope")):
            return "phase"
        return None
    if isinstance(fn, ast.Name):
        target = aliases.get(fn.id)
        if fn.id in METRIC_FUNCS and (
                is_metrics_mod
                or (target or "").startswith(metrics_mod + ".")):
            return fn.id
        if fn.id == "record" and (
                is_flightrec_mod
                or (target or "") == flightrec_mod + ".record"):
            return "record"
        if fn.id in PHASE_FUNCS and (
                is_perfscope_mod
                or (target or "").startswith(perfscope_mod + ".")):
            return "phase"
    return None


ENV_KNOB_PREFIX = "AMTPU_"
_KNOB_DOC_REL = "docs/OBSERVABILITY.md"
_KNOB_SECTION_RE = re.compile(
    r"^##\s+Environment knobs\s*$(.*?)(?=^##\s|\Z)",
    re.MULTILINE | re.DOTALL)
_KNOB_TOKEN_RE = re.compile(r"\bAMTPU_[A-Z0-9_]+\b")


def documented_knobs(project: Project) -> set[str] | None:
    """AMTPU_* names the OBSERVABILITY.md knob table documents, or None
    when the doc is absent (fixture projects: the rule disarms). Scans
    the "Environment knobs" section when present, the whole file
    otherwise — a knob documented anywhere beats a finding."""
    doc = project.root / "docs" / "OBSERVABILITY.md"
    try:
        text = doc.read_text()
    except OSError:
        return None
    m = _KNOB_SECTION_RE.search(text)
    scope = m.group(1) if m else text
    return set(_KNOB_TOKEN_RE.findall(scope))


def extract_env_reads(project: Project
                      ) -> list[tuple[str, int, int, str]]:
    """Every literal AMTPU_* environment read: (rel, line, col, name).
    Recognized forms: `os.environ.get(K, ...)`, `os.getenv(K, ...)`,
    `os.environ[K]`, and the `from os import environ/getenv` spellings.
    Dynamic names are ignored (there are none today; a computed knob
    name would defeat the table anyway)."""
    out: list[tuple[str, int, int, str]] = []
    for unit in project.units:
        if unit.rel.startswith(f"{project.package}/analysis/"):
            continue            # the lint's own sources talk ABOUT names
        if ENV_KNOB_PREFIX not in unit.text:
            continue
        aliases = _import_aliases(unit)

        def _is_environ(node: ast.AST) -> bool:
            d = dotted_name(node)
            if d == "os.environ":
                return True
            return d is not None and aliases.get(d) == "os.environ"

        for node in ast.walk(unit.tree):
            name_node = None
            if isinstance(node, ast.Call):
                fn = node.func
                if isinstance(fn, ast.Attribute):
                    if fn.attr == "get" and _is_environ(fn.value):
                        name_node = node.args[0] if node.args else None
                    elif fn.attr == "getenv" and \
                            dotted_name(fn.value) == "os":
                        name_node = node.args[0] if node.args else None
                elif isinstance(fn, ast.Name) and \
                        aliases.get(fn.id) == "os.getenv":
                    name_node = node.args[0] if node.args else None
            elif isinstance(node, ast.Subscript) and \
                    _is_environ(node.value):
                name_node = node.slice
            if isinstance(name_node, ast.Constant) and \
                    isinstance(name_node.value, str) and \
                    name_node.value.startswith(ENV_KNOB_PREFIX):
                out.append((unit.rel, node.lineno, node.col_offset,
                            name_node.value))
    return out


def registry_scheme_problems() -> list[str]:
    """Violations inside the registry itself (names off-scheme, aliases
    dangling). Used by the pass and by tests/test_metrics_lint.py."""
    problems = []
    for name in _metrics.REGISTRY:
        if not _NAME_RE.match(name):
            problems.append(f"invalid metric name {name!r}")
        elif not name.startswith(LAYER_PREFIXES):
            problems.append(
                f"{name!r} lacks a layer prefix {LAYER_PREFIXES} "
                "(<layer>_<noun>_<verb>, docs/OBSERVABILITY.md)")
    for old, new in _metrics.ALIASES.items():
        if new not in _metrics.REGISTRY:
            problems.append(f"alias {old!r} -> unregistered {new!r}")
    return problems


class RegistryConformancePass:
    name = "registry"

    def run(self, project: Project) -> list[Finding]:
        findings: list[Finding] = []
        known = set(_metrics.REGISTRY) | set(_metrics.ALIASES)
        event_kinds = set(getattr(_flightrec, "EVENT_KINDS", ()))

        phases = set(getattr(_perfscope, "PHASES", ()))

        for use in extract_uses(project):
            if use.name is None:
                if use.dynamic_reason is None:
                    continue
                rule = ("flightrec-dynamic" if use.api == "record"
                        else "phase-dynamic" if use.api == "phase"
                        else "metric-dynamic")
                findings.append(Finding(
                    rule=rule, path=use.path, line=use.line, col=use.col,
                    severity="warning",
                    message=(f"{use.api}() name cannot be verified "
                             f"statically: {use.dynamic_reason} (use a "
                             "registered literal, or suppress with a "
                             "justification)")))
                continue
            if use.api == "phase":
                if use.name not in phases:
                    findings.append(Finding(
                        rule="phase-unregistered", path=use.path,
                        line=use.line, col=use.col, severity="error",
                        message=(f"phase name {use.name!r} is not "
                                 "declared in perfscope.PHASES — the "
                                 "cross-layer wall-time rollup can only "
                                 "be read against documented phases "
                                 "(docs/OBSERVABILITY.md)")))
                continue
            if use.api == "record":
                if use.name not in event_kinds:
                    findings.append(Finding(
                        rule="flightrec-kind", path=use.path,
                        line=use.line, col=use.col, severity="error",
                        message=(f"flight-recorder event kind "
                                 f"{use.name!r} is not declared in "
                                 "flightrec.EVENT_KINDS — post-mortem "
                                 "readers can only interpret documented "
                                 "kinds")))
                continue
            if use.name in RETIRED_METRIC_NAMES:
                findings.append(Finding(
                    rule="metric-retired", path=use.path,
                    line=use.line, col=use.col, severity="error",
                    message=(f"metric name {use.name!r} was retired by "
                             "the naming-scheme migration; it would mint "
                             "a series nobody reads (canonical names: "
                             "docs/OBSERVABILITY.md)")))
                continue
            if use.name not in known:
                findings.append(Finding(
                    rule="metric-unregistered", path=use.path,
                    line=use.line, col=use.col, severity="error",
                    message=(f"metric name {use.name!r} is not declared "
                             f"in {project.package}/utils/metrics.py "
                             "(COUNTERS/GAUGES/HISTOGRAMS/SPANS) per the "
                             "<layer>_<noun>_<verb> scheme")))
                continue
            kind_label, table = _KIND_TABLE[use.api]
            canonical = _metrics.ALIASES.get(use.name, use.name)
            if canonical not in table(_metrics):
                findings.append(Finding(
                    rule="metric-kind", path=use.path,
                    line=use.line, col=use.col, severity="error",
                    message=(f"{use.api}() expects a {kind_label} name "
                             f"but {use.name!r} is registered as a "
                             "different kind — the series would export "
                             "under suffixes the docs never mention")))

        metrics_rel = f"{project.package}/utils/metrics.py"
        for problem in registry_scheme_problems():
            findings.append(Finding(
                rule="metric-scheme", path=metrics_rel, line=1, col=0,
                severity="error", message=problem))

        knobs = documented_knobs(project)
        if knobs is not None:
            flagged: set[tuple[str, str]] = set()
            for rel, line, col, knob in extract_env_reads(project):
                if knob in knobs or (rel, knob) in flagged:
                    continue
                flagged.add((rel, knob))    # one finding per (file, knob)
                findings.append(Finding(
                    rule="env-knob-undocumented", path=rel,
                    line=line, col=col, severity="error",
                    message=(f"environment knob {knob!r} is read here "
                             f"but missing from the {_KNOB_DOC_REL} "
                             "'Environment knobs' table — an "
                             "undiscoverable knob is configuration rot; "
                             "document it (name, default, effect)")))
        return findings
