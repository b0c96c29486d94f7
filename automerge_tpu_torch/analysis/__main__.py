"""CLI: `python -m automerge_tpu_torch.analysis [options]`.

Exit 0 when every finding is grandfathered by the baseline (or there are
none); exit 1 on any new finding; exit 2 on usage errors (the reference's
codes).

Options:
    --root DIR            repo root to analyze (default: auto-detected
                          from this package's location, falling back to
                          the current directory)
    --baseline FILE       baseline to diff against (default:
                          <root>/analysis_baseline_torch.json when present)
    --no-baseline         ignore any baseline: report everything as new
    --write-baseline      rewrite the baseline to cover the current
                          findings (carrying over justifications whose
                          keys survive), then exit 0. Review the diff —
                          every new entry needs a justification.
    --list                print every finding (including grandfathered)
    --write-locks-manifest
                          write the port's lock manifest,
                          locks_manifest_torch.json, and
                          docs/LOCK_HIERARCHY_TORCH.md from the code's
                          current lock-order edges (lockfree declarations
                          carried over from the manifest the passes read,
                          locks_manifest.json — they are human-authored),
                          then exit 0. The reference's files are never
                          written.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

from .core import BASELINE_NAME, PACKAGE, Baseline, run_analysis


def _default_root() -> pathlib.Path:
    # automerge_tpu_torch/analysis/__main__.py -> the directory holding
    # automerge_tpu_torch/ (the repo root in every supported layout)
    pkg_root = pathlib.Path(__file__).resolve().parents[2]
    if (pkg_root / PACKAGE).is_dir():
        return pkg_root
    return pathlib.Path.cwd()


def _write_locks_manifest(root: pathlib.Path) -> int:
    from .core import load_project
    from .flow import (HIERARCHY_DOC, MANIFEST_NAME, MANIFEST_OUT_NAME,
                       LocksManifest, build_manifest, find_cycle)
    from .hierarchy_doc import render_hierarchy
    project = load_project(root)
    path = root / MANIFEST_OUT_NAME
    prior = LocksManifest.load(path) or LocksManifest.load(
        root / MANIFEST_NAME)
    manifest = build_manifest(project, prior)
    cycle = find_cycle(manifest.order_edges())
    manifest.save(path)
    doc = root / HIERARCHY_DOC
    doc.parent.mkdir(parents=True, exist_ok=True)
    doc.write_text(render_hierarchy(manifest))
    print(f"locks manifest written: {path} "
          f"({len(manifest.order)} edge(s), {len(manifest.locks)} "
          f"lock(s), {len(manifest.lockfree)} lockfree declaration(s))")
    print(f"hierarchy doc written: {doc}")
    if cycle:
        print("WARNING: the derived order contains a cycle: "
              + " -> ".join(cycle))
        return 1
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m automerge_tpu_torch.analysis",
        description="graftlint: jit hygiene, lock discipline, and "
                    "observability-registry conformance")
    ap.add_argument("--root", default=None)
    ap.add_argument("--baseline", default=None)
    ap.add_argument("--no-baseline", action="store_true")
    ap.add_argument("--write-baseline", action="store_true")
    ap.add_argument("--write-locks-manifest", action="store_true")
    ap.add_argument("--list", action="store_true", dest="list_all")
    args = ap.parse_args(argv)

    root = pathlib.Path(args.root).resolve() if args.root \
        else _default_root()

    if args.write_locks_manifest:
        return _write_locks_manifest(root)
    baseline_path = pathlib.Path(args.baseline) if args.baseline \
        else (root / BASELINE_NAME
              if (root / BASELINE_NAME).exists() else None)
    if args.no_baseline:
        baseline_path = None

    report = run_analysis(root, baseline_path)

    if args.write_baseline:
        out = pathlib.Path(args.baseline) if args.baseline \
            else root / BASELINE_NAME
        old = Baseline.load(out) if out.exists() else None
        Baseline.from_findings(report.findings, old).save(out)
        print(f"baseline written: {out} "
              f"({len(report.findings)} findings covered)")
        return 0

    shown = report.findings if args.list_all else report.new
    for f in shown:
        grand = "" if f in report.new else "  [baselined]"
        print(f.render() + grand)

    n_err = sum(1 for f in report.new if f.severity == "error")
    n_warn = len(report.new) - n_err
    print(f"graftlint: {len(report.findings)} finding(s), "
          f"{len(report.grandfathered)} baselined, "
          f"{n_err} new error(s), {n_warn} new warning(s)")
    if report.stale_baseline:
        print(f"graftlint: {len(report.stale_baseline)} stale baseline "
              "entr(y/ies) — debt paid down; shrink the baseline with "
              "--write-baseline:")
        for rule, path, msg in report.stale_baseline:
            print(f"  stale: [{rule}] {path}: {msg[:72]}")
    return 1 if report.new else 0


if __name__ == "__main__":
    sys.exit(main())
