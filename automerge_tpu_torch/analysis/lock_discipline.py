"""lock-discipline pass: ordering, blocking-under-lock, thread hygiene,
and the committed lock-hierarchy manifest (the port's copy of
`automerge_tpu/analysis/lock_discipline.py`; the scopes are the analyzed
package's, and on the port's tree the torch readbacks of `flow.py` count
as blocking calls).

Scope: `sync/` and `utils/` — the layers where socket reader threads, the
watchdog checker, the audit loop, and application threads all meet the
same locks (Connection, the tcp read/accept loops, the service lock, the
flight-recorder ring, the metrics store). The shared call-graph and
lock-footprint machinery lives in `analysis/flow.py` (it also feeds
`threadmap.py` / `races.py` and the lock-hierarchy manifest); this
module keeps only the rules.

Rules:

- **lock-order** (error): two locks acquired in both orders somewhere in
  the scope (the classic ABBA deadlock; Jiffy's core discipline is that
  lock acquisition order is a global invariant, not a local choice).
- **block-under-lock** (error): a blocking call — socket recv/send/
  accept/connect, the project frame helpers (`send_frame`/`recv_frame`),
  `Thread.join`, `Event.wait` on something other than the held condition,
  `time.sleep`, and device readbacks (`block_until_ready`,
  `jax.device_get`, duck-typed engine reads `.hashes()`/
  `.materialize()`) — made while holding a lock. This is the r5 stall
  class: the hang sat on a device readback taken under the service lock,
  and every other thread then queued behind it.
- **thread-daemon** (error): `threading.Thread(...)` without an explicit
  `daemon=` — an implicit non-daemon thread can wedge interpreter
  shutdown; the choice must be visible at the spawn site.
- **thread-name** (warning): `threading.Thread(...)` without a `name=` —
  the flight recorder and the watchdog's span-stack diagnosis key events
  by thread name; an anonymous `Thread-3` makes the post-mortem
  unreadable.
- **thread-join** (error): a `daemon=False` thread whose module never
  joins it — non-daemon threads need an owner that joins them.
- **lock-manifest-drift** (error): a lock-ordering edge observed in the
  code (over the full race scope, `sync/`+`utils/`+`perf/`) that is not
  in the committed `locks_manifest.json` — new lock nesting must be an
  explicit, reviewed manifest change.
- **lock-manifest-stale** (warning): a manifest edge the code no longer
  exhibits — prune it on the next regeneration.
- **lock-order-cycle** (error): the union of committed and observed
  edges contains a cycle — the hierarchy must stay a DAG or the
  acquisition-order invariant (and the runtime sanitizer that enforces
  it) is meaningless.

The manifest rules only run when `locks_manifest.json` exists at the
project root (fixture projects in tests don't carry one). The port's
locks keep the reference's class-qualified identities, so its observed
edges are held to the manifest the port's sanitizer reads; `python -m
automerge_tpu_torch.analysis --write-locks-manifest` writes the port's
own derivation beside it (`locks_manifest_torch.json`).

Known limits (docs/ANALYSIS.md): `.acquire()`/`.release()` pairs are not
tracked (the codebase uses `with` exclusively), duck-typed calls across
layer boundaries end the walk, and two same-named locks on classes the
pass cannot distinguish merge into a `*.attr` identity. The baseline
absorbs deliberate holds (with a justification naming the mitigation,
e.g. the watchdog that covers them).
"""

from __future__ import annotations

import ast

from .core import Finding, Project, SourceUnit, dotted_name
from .flow import (MANIFEST_NAME, THREAD_FACTORY, LocksManifest,
                   default_scope, find_cycle, flow_index, lock_graph)
from .jit_hygiene import _ModuleIndex


class LockDisciplinePass:
    name = "lock-discipline"

    def __init__(self, scope: tuple[str, ...] | None = None):
        self.scope = scope

    def run(self, project: Project) -> list[Finding]:
        findings: set[Finding] = set()
        fi = flow_index(project, self.scope or default_scope(project))

        for unit in fi.units:
            self._check_threads(unit, fi.index(unit), findings)

        edges: dict[tuple[str, str], list[tuple[str, int, str]]] = {}

        def on_edge(a, b, label, line, rel):
            edges.setdefault((a, b), []).append((label, line, rel))

        for unit in fi.units:
            for f in fi.index(unit).all_funcs.values():

                def on_block(node, hid, desc, callee, _f=f):
                    self._flag_block(_f, node, hid, desc, callee, findings)

                fi.walk_holds(f, on_edge=on_edge, on_block=on_block)

        self._check_order(edges, findings)
        self._check_manifest(project, findings)
        return sorted(findings,
                      key=lambda f: (f.path, f.line, f.col, f.rule))

    # -- blocking under a held lock -------------------------------------------

    @staticmethod
    def _flag_block(f, node, hid, desc, callee, findings: set) -> None:
        if callee is not None:
            hz, what = desc.split(":", 1)
            message = (f"call to {callee.qualname}() while holding "
                       f"{hid} reaches a blocking "
                       f"{hz} call "
                       f"({what}) — the r5 stall "
                       "class (every thread needing the lock queues "
                       "behind it)")
        else:
            hz, what = desc.split(":", 1)
            message = (f"blocking {hz} call {what} while holding "
                       f"{hid} — the r5 stall class (every thread "
                       "needing the lock queues behind it)")
        findings.add(Finding(
            rule="block-under-lock", path=f.unit.rel,
            line=node.lineno, col=node.col_offset,
            severity="error", message=message))

    # -- orderings ------------------------------------------------------------

    @staticmethod
    def _check_order(edges: dict, findings: set) -> None:
        for (a, b), sites in sorted(edges.items()):
            if a < b and (b, a) in edges:
                fn_ab, _, _ = sites[0]
                fn_ba, line_ba, rel_ba = edges[(b, a)][0]
                # anchor at the (b, a) site: one finding per inverted pair
                findings.add(Finding(
                    rule="lock-order", path=rel_ba,
                    line=line_ba, col=0, severity="error",
                    message=(f"lock order inversion: {a} is taken before "
                             f"{b} in {fn_ab}(), but {b} before {a} in "
                             f"{fn_ba}() — ABBA deadlock when the two "
                             "paths race")))

    # -- the committed manifest ------------------------------------------------

    @staticmethod
    def _check_manifest(project: Project, findings: set) -> None:
        manifest = LocksManifest.load(project.root / MANIFEST_NAME)
        if manifest is None:
            return
        observed = lock_graph(project)
        committed = manifest.order_edges()
        for (a, b), sites in sorted(observed.items()):
            if (a, b) in committed:
                continue
            label, line, rel = sites[0]
            findings.add(Finding(
                rule="lock-manifest-drift", path=rel, line=line, col=0,
                severity="error",
                message=(f"lock-order edge {a} -> {b} (in {label}()) is "
                         f"not in {MANIFEST_NAME} — new lock nesting must "
                         "be an explicit, reviewed manifest change "
                         "(regenerate with python -m "
                         f"{project.package}.analysis "
                         "--write-locks-manifest)")))
        for (a, b) in sorted(committed - set(observed)):
            findings.add(Finding(
                rule="lock-manifest-stale", path=MANIFEST_NAME,
                line=1, col=0, severity="warning",
                message=(f"manifest edge {a} -> {b} no longer observed in "
                         "the code — prune it on the next "
                         "--write-locks-manifest regeneration")))
        cycle = find_cycle(committed | set(observed))
        if cycle:
            findings.add(Finding(
                rule="lock-order-cycle", path=MANIFEST_NAME,
                line=1, col=0, severity="error",
                message=("lock hierarchy contains a cycle: "
                         + " -> ".join(cycle)
                         + " — the acquisition order must stay a DAG or "
                         "the ABBA invariant (and utils/locksan.py) is "
                         "meaningless")))

    # -- thread hygiene --------------------------------------------------------

    def _check_threads(self, unit: SourceUnit, idx: _ModuleIndex,
                       findings: set) -> None:
        join_targets: set[str] = set()
        for node in ast.walk(unit.tree):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "join":
                rname = dotted_name(node.func.value)
                if rname:
                    join_targets.add(rname.rsplit(".", 1)[-1])
        for node in ast.walk(unit.tree):
            if not isinstance(node, ast.Call):
                continue
            callee = dotted_name(node.func)
            if not callee or idx.resolve_dotted(callee) != THREAD_FACTORY:
                continue
            kwargs = {kw.arg for kw in node.keywords}
            daemon_kw = next((kw for kw in node.keywords
                              if kw.arg == "daemon"), None)
            if daemon_kw is None:
                findings.add(Finding(
                    rule="thread-daemon", path=unit.rel,
                    line=node.lineno, col=node.col_offset,
                    severity="error",
                    message=("threading.Thread(...) without an explicit "
                             "daemon=: an implicit non-daemon thread "
                             "wedges interpreter shutdown; state the "
                             "choice at the spawn site")))
            if "name" not in kwargs:
                findings.add(Finding(
                    rule="thread-name", path=unit.rel,
                    line=node.lineno, col=node.col_offset,
                    severity="warning",
                    message=("threading.Thread(...) without a name=: the "
                             "flight recorder keys per-thread event "
                             "tails and span stacks by thread name — an "
                             "anonymous Thread-N makes the post-mortem "
                             "unreadable")))
            if daemon_kw is not None \
                    and isinstance(daemon_kw.value, ast.Constant) \
                    and daemon_kw.value.value is False:
                # a non-daemon thread needs a joining owner in this module
                if not join_targets:
                    findings.add(Finding(
                        rule="thread-join", path=unit.rel,
                        line=node.lineno, col=node.col_offset,
                        severity="error",
                        message=("daemon=False thread with no join() "
                                 "anywhere in the module: non-daemon "
                                 "threads need an owner that joins "
                                 "them")))
