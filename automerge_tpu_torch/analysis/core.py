"""graftlint core, on the port: findings, suppressions, baselines, the pass
runner (the counterpart of `automerge_tpu/analysis/core.py`).

Pieces:

- `Finding`: one diagnosis — rule id, `file:line`, severity, message. The
  baseline key deliberately omits the line number (pure line drift must
  not resurrect a grandfathered finding).
- `SourceUnit` / `load_project`: parsed source files. The port's scope is
  `chip_smoke.py` plus `automerge_tpu_torch/**/*.py` (the git-ignored
  `build/` skipped); `package="automerge_tpu"` loads the reference's own
  scope instead (`bench.py` plus `automerge_tpu/**/*.py`), so the same
  passes can be held to the reference's analyzer on its tree.
- Suppressions: a `# graftlint: disable=rule-id[,rule-id...]` comment on
  the flagged line (or the line directly above it) silences those rules
  there; `# graftlint: skip-file` in the first ten lines silences a whole
  file. Suppression is for deliberate, locally-justified exceptions; the
  BASELINE is for grandfathering pre-existing debt with a justification.
- Baseline (`analysis_baseline_torch.json`, committed at the repo root):
  pre-existing findings are recorded as (rule, path, message, count,
  justification) and tolerated; anything NEW fails the run. An entry
  whose findings all disappear is reported as stale so the file shrinks
  as debt is paid down.
- `run_analysis`: load → run passes → apply suppressions → diff against
  the baseline. `python -m automerge_tpu_torch.analysis` (see
  __main__.py) is the CLI.

A pass is any object with `.name` and `.run(project) -> list[Finding]`,
registered in `default_passes()`; a pass reads the analyzed package's
name from `project.package` and builds its scope from it.
"""

from __future__ import annotations

import ast
import json
import pathlib
import re
from dataclasses import dataclass, field

SEVERITIES = ("error", "warning")

#: the package this analyzer checks by default, and the reference package
#: it can be pointed at (`load_project(root, package=REFERENCE_PACKAGE)`)
PACKAGE = "automerge_tpu_torch"
REFERENCE_PACKAGE = "automerge_tpu"
#: the repo-root script analyzed with each package
ROOT_SCRIPTS = {PACKAGE: "chip_smoke.py", REFERENCE_PACKAGE: "bench.py"}
#: directories of a package that hold no source of its own (build output)
_SKIPPED_DIRS = ("build",)


def scope_of(package: str, *subdirs: str) -> tuple[str, ...]:
    """The repo-relative path prefixes of `subdirs` of `package`."""
    return tuple(f"{package}/{d}/" for d in subdirs)

# the marker word in suppression comments; also the suite's name
TOOL = "graftlint"

_SUPPRESS_RE = re.compile(
    r"#\s*" + TOOL + r"\s*:\s*disable\s*=\s*([A-Za-z0-9_,\s-]+)")
_SKIP_FILE_RE = re.compile(r"#\s*" + TOOL + r"\s*:\s*skip-file")


@dataclass(frozen=True)
class Finding:
    """One static-analysis diagnosis, anchored to file:line."""
    rule: str
    path: str          # repo-relative, posix separators
    line: int
    col: int
    severity: str
    message: str

    def location(self) -> str:
        return f"{self.path}:{self.line}"

    def baseline_key(self) -> tuple[str, str, str]:
        """Line numbers drift with unrelated edits; a baselined finding is
        identified by WHAT it is and WHERE (file granularity), not by the
        exact line."""
        return (self.rule, self.path, self.message)

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.severity}[{self.rule}] {self.message}")


@dataclass
class SourceUnit:
    """One parsed source file."""
    path: pathlib.Path
    rel: str           # repo-relative posix path
    text: str
    lines: list[str]
    tree: ast.Module

    @property
    def modname(self) -> str:
        """Dotted module name relative to the repo root (chip_smoke.py ->
        "chip_smoke", automerge_tpu_torch/sync/tcp.py ->
        "automerge_tpu_torch.sync.tcp")."""
        parts = self.rel[:-3].split("/")
        if parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join(parts)


@dataclass
class Project:
    """Every SourceUnit the suite analyzes, plus lookup helpers.
    `package` is the analyzed package's name (the passes' scopes hang off
    it)."""
    root: pathlib.Path
    units: list[SourceUnit] = field(default_factory=list)
    package: str = PACKAGE

    def by_rel(self, rel: str) -> SourceUnit | None:
        for u in self.units:
            if u.rel == rel:
                return u
        return None

    def by_modname(self, modname: str) -> SourceUnit | None:
        for u in self.units:
            if u.modname == modname:
                return u
        return None

    def under(self, *prefixes: str) -> list[SourceUnit]:
        return [u for u in self.units
                if any(u.rel.startswith(p) for p in prefixes)]


def parse_source(path: pathlib.Path, rel: str, text: str | None = None
                 ) -> SourceUnit:
    if text is None:
        text = path.read_text()
    return SourceUnit(path=path, rel=rel, text=text,
                      lines=text.splitlines(),
                      tree=ast.parse(text, filename=str(path)))


def load_project(root: pathlib.Path | str,
                 extra: list[pathlib.Path] | None = None,
                 package: str = PACKAGE) -> Project:
    """The analyzed file set: the package's root script (chip_smoke.py for
    the port, bench.py for the reference) + <package>/**/*.py (its
    `build/` skipped), plus any `extra` files (tests pass fixture snippets
    this way)."""
    root = pathlib.Path(root).resolve()
    paths: list[pathlib.Path] = []
    script = root / ROOT_SCRIPTS.get(package, "")
    if script.is_file():
        paths.append(script)
    pkg = root / package
    if pkg.is_dir():
        paths.extend(
            p for p in sorted(pkg.rglob("*.py"))
            if p.relative_to(pkg).parts[0] not in _SKIPPED_DIRS)
    project = Project(root=root, package=package)
    for p in paths:
        rel = p.relative_to(root).as_posix()
        project.units.append(parse_source(p, rel))
    for p in extra or []:
        p = pathlib.Path(p).resolve()
        try:
            rel = p.relative_to(root).as_posix()
        except ValueError:
            rel = p.name
        project.units.append(parse_source(p, rel))
    return project


# ---------------------------------------------------------------------------
# suppression comments


def suppressed_rules(unit: SourceUnit, line: int) -> set[str]:
    """Rules disabled at `line` (1-based): trailing comment on the line
    itself or a standalone comment on the line above."""
    out: set[str] = set()
    for ln in (line, line - 1):
        if 1 <= ln <= len(unit.lines):
            m = _SUPPRESS_RE.search(unit.lines[ln - 1])
            if m:
                out.update(r.strip() for r in m.group(1).split(",")
                           if r.strip())
    return out


def file_skipped(unit: SourceUnit) -> bool:
    return any(_SKIP_FILE_RE.search(l) for l in unit.lines[:10])


def apply_suppressions(project: Project,
                       findings: list[Finding]) -> list[Finding]:
    units = {u.rel: u for u in project.units}
    out = []
    for f in findings:
        u = units.get(f.path)
        if u is not None:
            if file_skipped(u):
                continue
            if f.rule in suppressed_rules(u, f.line):
                continue
        out.append(f)
    return out


# ---------------------------------------------------------------------------
# baseline


BASELINE_VERSION = 1
BASELINE_NAME = "analysis_baseline_torch.json"


@dataclass
class Baseline:
    """Grandfathered findings: up to `count` findings per (rule, path,
    message) key are tolerated; the justification is human documentation
    (required for review, not interpreted)."""
    entries: dict[tuple[str, str, str], dict] = field(default_factory=dict)

    @staticmethod
    def load(path: pathlib.Path | str) -> "Baseline":
        doc = json.loads(pathlib.Path(path).read_text())
        if doc.get("version") != BASELINE_VERSION:
            raise ValueError(
                f"unsupported baseline version {doc.get('version')!r}")
        b = Baseline()
        for e in doc.get("findings", []):
            key = (e["rule"], e["path"], e["message"])
            b.entries[key] = {"count": int(e.get("count", 1)),
                              "justification": e.get("justification", "")}
        return b

    def save(self, path: pathlib.Path | str) -> None:
        findings = [
            {"rule": r, "path": p, "message": m,
             "count": v["count"], "justification": v["justification"]}
            for (r, p, m), v in sorted(self.entries.items())]
        pathlib.Path(path).write_text(json.dumps(
            {"version": BASELINE_VERSION, "findings": findings},
            indent=1, sort_keys=False) + "\n")

    @staticmethod
    def from_findings(findings: list[Finding],
                      old: "Baseline | None" = None) -> "Baseline":
        """Baseline covering exactly `findings`; justifications carried
        over from `old` where the key survives."""
        b = Baseline()
        for f in findings:
            key = f.baseline_key()
            if key in b.entries:
                b.entries[key]["count"] += 1
            else:
                just = ""
                if old is not None and key in old.entries:
                    just = old.entries[key]["justification"]
                b.entries[key] = {"count": 1, "justification": just}
        return b

    def split(self, findings: list[Finding]
              ) -> tuple[list[Finding], list[Finding], list[tuple]]:
        """(grandfathered, new, stale_keys): findings covered by the
        baseline vs. not; baseline keys no finding used at all."""
        budget = {k: v["count"] for k, v in self.entries.items()}
        grandfathered, new = [], []
        for f in findings:
            key = f.baseline_key()
            if budget.get(key, 0) > 0:
                budget[key] -= 1
                grandfathered.append(f)
            else:
                new.append(f)
        stale = [k for k, v in self.entries.items()
                 if budget.get(k, 0) == v["count"]]
        return grandfathered, new, stale


# ---------------------------------------------------------------------------
# runner


@dataclass
class AnalysisReport:
    findings: list[Finding]          # post-suppression, all passes
    new: list[Finding]               # not covered by the baseline
    grandfathered: list[Finding]
    stale_baseline: list[tuple]      # baseline keys with zero live findings

    @property
    def ok(self) -> bool:
        return not self.new


def default_passes() -> list:
    """The shipped rule set, in report order. Import here (not module
    top-level) so `core` stays importable from the pass modules."""
    from .jit_hygiene import JitHygienePass
    from .lock_discipline import LockDisciplinePass
    from .races import RacePass
    from .registry import RegistryConformancePass
    return [RegistryConformancePass(), JitHygienePass(),
            LockDisciplinePass(), RacePass()]


def run_passes(project: Project, passes: list | None = None
               ) -> list[Finding]:
    findings: list[Finding] = []
    for p in passes if passes is not None else default_passes():
        findings.extend(p.run(project))
    findings = apply_suppressions(project, findings)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def run_analysis(root: pathlib.Path | str,
                 baseline_path: pathlib.Path | str | None = None,
                 passes: list | None = None,
                 package: str = PACKAGE) -> AnalysisReport:
    root = pathlib.Path(root).resolve()
    project = load_project(root, package=package)
    findings = run_passes(project, passes)
    if baseline_path is None:
        candidate = root / BASELINE_NAME
        baseline_path = candidate if candidate.exists() else None
    if baseline_path is not None:
        baseline = Baseline.load(baseline_path)
        grandfathered, new, stale = baseline.split(findings)
    else:
        grandfathered, new, stale = [], list(findings), []
    return AnalysisReport(findings=findings, new=new,
                          grandfathered=grandfathered, stale_baseline=stale)


# ---------------------------------------------------------------------------
# shared AST helpers (used by every pass)


def dotted_name(node: ast.AST) -> str | None:
    """`a.b.c` -> "a.b.c" for Name/Attribute chains, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def const_str(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def str_tuple(node: ast.AST) -> tuple[str, ...] | None:
    """("a", "b") / ["a"] / "a" -> tuple of strings, else None."""
    s = const_str(node)
    if s is not None:
        return (s,)
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for elt in node.elts:
            s = const_str(elt)
            if s is None:
                return None
            out.append(s)
        return tuple(out)
    return None
