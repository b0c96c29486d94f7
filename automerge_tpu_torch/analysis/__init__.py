"""graftlint on the port: the reference's static analysis
(`automerge_tpu/analysis/`) over `automerge_tpu_torch/` and
`chip_smoke.py`.

Run it:

    python -m automerge_tpu_torch.analysis       # port + its baseline

Four passes ship:

- **registry** — every metric/span name reaching `metrics.bump/trace/...`
  and every `flightrec.record` event kind must be declared in the port's
  registries; kind-correct; not retired; every `AMTPU_*` knob read is in
  docs/OBSERVABILITY.md's table.
- **jit-hygiene** — inside code reachable from the port's device
  dispatches (`metrics.dispatch_jit` roots and the kernel wrappers that
  call `cuda_kernels.launch`) in `engine/` and `parallel/`: host syncs
  (`.item()`, `.tolist()`, `.cpu()`, `.numpy()`, `torch.cuda.
  synchronize()`, `int()/float()/bool()` of a tensor, `np.asarray` of a
  tensor), Python branching on tensor values, kernel builds or
  `torch.compile` on the call path, and shape literals drifting from the
  canonical constants in `engine/pack.py`.
- **lock-discipline** — a lock-acquisition graph over `sync/` and
  `utils/`: inconsistent lock ordering, blocking calls (socket IO,
  `join`, device readbacks — the torch ones included — sleeps) while
  holding a lock, `threading.Thread` hygiene, and the lock manifest.
- **races** — cross-thread shared state over `sync/`, `utils/` and
  `perf/`.

Pre-existing findings are grandfathered in `analysis_baseline_torch.json`
(repo root) with one-line justifications; new findings fail the run.
Local deliberate exceptions use `# graftlint: disable=<rule>` comments.
`load_project(root, package="automerge_tpu")` points the same passes at
the reference's own tree.
"""

from .core import (  # noqa: F401
    AnalysisReport, Baseline, Finding, Project, SourceUnit,
    apply_suppressions, default_passes, load_project, parse_source,
    run_analysis, run_passes,
)
