"""automerge_tpu_torch.perf — the port's performance-plane tooling (the
counterpart of `automerge_tpu/perf/`).

`python -m automerge_tpu_torch.perf <command>` (see `__main__.py`): the
bench-history gate (`report`, `check`), the contention report, the fleet
doctor, the per-doc explainer, the live dashboard (`top`), the
dispatch, tenant and trace planes, and the smokes (`remediate`, `move`,
`bootstrap`, `race`, `megabatch`), and the device probes `roofline` (the
rows kernel's bandwidth) and `resident` (the round-frame ingress's
stages).

The runtime half of the plane (dispatch counters, kernel-build
telemetry, phase attribution, memory gauges) lives in
`automerge_tpu_torch/utils/perfscope.py` and `utils/metrics.py`; this
package reads what they record. `history` is pure stdlib.
"""

from . import history  # noqa: F401  (stdlib-only; safe to import eagerly)
