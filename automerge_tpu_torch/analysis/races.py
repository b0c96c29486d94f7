"""races pass: static cross-thread race detection over the threadmap (the
port's copy of `automerge_tpu/analysis/races.py`, over the analyzed
package's race scope).

For every attribute identity in scope (`sync/` + `utils/` + `perf/`),
`threadmap.py` supplies the access sites, the thread roots that reach
each one, and the locks *guaranteed* held there (intersection over all
call paths). The rules:

- **shared-write-unlocked** (error): the attribute is written from ≥2
  thread roots and no single lock is guaranteed held across all write
  sites. Last-write-wins scalar stamps that are genuinely safe under
  the GIL must be *declared*: a `lockfree` entry in
  `locks_manifest.json` with a written justification suppresses the
  finding and documents the reasoning next to the hierarchy it bends.
- **shared-mutate-aliased** (error): structural container mutation
  (`.append`/`.pop`/`.update`/`dict[k] = v`/`del d[k]`) on state
  reachable from ≥2 roots with no common lock — the "dictionary changed
  size during iteration" / lost-element class; unlike a torn scalar
  this corrupts or raises even with the GIL, because iteration in one
  thread interleaves with resize in another.
- **lockfree-undeclared** (warning): writes are single-rooted or
  consistently locked, but some *other* root reads the attribute
  without any lock the writers hold — the `_clock_cache` peek shape.
  Deliberate lock-free reads are fine; undeclared ones are a review
  gap. Declaring the attribute in the manifest (with justification)
  silences it.
- **lockfree-stale** (warning): a `lockfree` manifest entry whose
  attribute no longer has any lock-free shared access — prune it.

One finding per attribute (anchored at the first offending site, in
path order), not one per site: the fix is per-attribute (pick a lock or
declare), so the noise should be too. Baseline keys are line-free
(rule, path, message) and messages name only the attribute and the
roots, so findings survive unrelated edits.
"""

from __future__ import annotations

from .core import Finding, Project
from .flow import MANIFEST_NAME, LocksManifest, race_scope
from .threadmap import thread_map


def _roots_str(roots) -> str:
    return ", ".join(sorted(roots))


class RacePass:
    name = "races"

    def __init__(self, scope: tuple[str, ...] | None = None):
        self.scope = scope

    def run(self, project: Project) -> list[Finding]:
        tm = thread_map(project, self.scope or race_scope(project))
        manifest = LocksManifest.load(project.root / MANIFEST_NAME)
        lockfree = manifest.lockfree_attrs() if manifest else {}
        declared_used: set[str] = set()
        findings: list[Finding] = []

        for attr, slot in sorted(tm.attr_table().items()):
            writes, mutates, reads = (slot["write"], slot["mutate"],
                                      slot["read"])
            wm = writes + mutates
            if not wm:
                continue
            writing_roots: set[str] = set()
            common_wm: frozenset | None = None
            for _site, ctx in wm:
                for root, held in ctx.items():
                    writing_roots.add(root)
                    common_wm = held if common_wm is None \
                        else (common_wm & held)
            common_wm = common_wm or frozenset()

            if len(writing_roots) >= 2 and not common_wm:
                if attr in lockfree:
                    declared_used.add(attr)
                    continue
                if mutates:
                    s, ctx = mutates[0]
                    findings.append(Finding(
                        rule="shared-mutate-aliased", path=s.rel,
                        line=s.line, col=s.col, severity="error",
                        message=(f"container mutation of {attr} reachable "
                                 f"from roots [{_roots_str(writing_roots)}] "
                                 "with no common lock — concurrent resize "
                                 "vs iteration corrupts or raises even "
                                 "under the GIL; guard every mutating and "
                                 "iterating path with one lock")))
                else:
                    s, ctx = writes[0]
                    findings.append(Finding(
                        rule="shared-write-unlocked", path=s.rel,
                        line=s.line, col=s.col, severity="error",
                        message=(f"{attr} is written from roots "
                                 f"[{_roots_str(writing_roots)}] with no "
                                 "common lock and no declared lock-free "
                                 "justification — pick one lock for every "
                                 "writing path, or declare the attribute "
                                 f"lockfree in {MANIFEST_NAME} with a "
                                 "justification")))
                continue

            # writes are safe; look for cross-root lock-free reads
            peek = None
            for s, ctx in reads:
                for root, held in sorted(ctx.items()):
                    if not (writing_roots - {root}):
                        continue        # only its own writes to race with
                    if held & common_wm:
                        continue        # shares a lock with the writers
                    peek = (s, root)
                    break
                if peek:
                    break
            if peek is None:
                continue
            if attr in lockfree:
                declared_used.add(attr)
                continue
            s, root = peek
            findings.append(Finding(
                rule="lockfree-undeclared", path=s.rel,
                line=s.line, col=s.col, severity="warning",
                message=(f"{attr} is read from {root} without any lock "
                         "its writers hold — a deliberately lock-free "
                         "peek must be declared in "
                         f"{MANIFEST_NAME} (lockfree entry with a "
                         "justification); an accidental one needs the "
                         "writer's lock")))

        for attr in sorted(set(lockfree) - declared_used):
            findings.append(Finding(
                rule="lockfree-stale", path=MANIFEST_NAME, line=1, col=0,
                severity="warning",
                message=(f"lockfree declaration for {attr} matches no "
                         "lock-free shared access in the code — prune "
                         "the manifest entry")))

        findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
        return findings
