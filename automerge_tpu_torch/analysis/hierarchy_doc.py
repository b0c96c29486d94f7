"""docs/LOCK_HIERARCHY_TORCH.md renderer (the port's copy of
`automerge_tpu/analysis/hierarchy_doc.py`).

The markdown is GENERATED from the port's `locks_manifest_torch.json` by
`python -m automerge_tpu_torch.analysis --write-locks-manifest` — edit
the code (or the manifest's lockfree justifications), never the doc.
Kept as its own module so the rendering is deterministic and testable:
same manifest in, byte-identical doc out.
"""

from __future__ import annotations

from .flow import LocksManifest, find_cycle


def _levels(edges: set[tuple[str, str]]) -> list[list[str]]:
    """Kahn levels: locks in level N may be held while acquiring any
    lock in a later level, never an earlier one."""
    nodes: set[str] = set()
    for a, b in edges:
        nodes.update((a, b))
    indeg = {n: 0 for n in nodes}
    for _a, b in edges:
        indeg[b] += 1
    levels: list[list[str]] = []
    remaining = dict(indeg)
    live = set(nodes)
    while live:
        level = sorted(n for n in live if remaining[n] == 0)
        if not level:       # cycle: dump the rest in one level
            levels.append(sorted(live))
            break
        levels.append(level)
        for n in level:
            live.discard(n)
            for a, b in edges:
                if a == n and b in live:
                    remaining[b] -= 1
    return levels


def render_hierarchy(manifest: LocksManifest) -> str:
    edges = manifest.order_edges()
    names = manifest.lock_names()
    cycle = find_cycle(edges)
    out: list[str] = []
    out.append("# Lock hierarchy\n")
    out.append("<!-- GENERATED by `python -m automerge_tpu_torch.analysis "
               "--write-locks-manifest` — do not edit by hand. -->\n")
    out.append(
        "The committed lock-acquisition order for the thread-dense scope\n"
        "(`sync/`, `utils/`, `perf/`). An edge `A -> B` means some path\n"
        "acquires B while holding A — so B must never be held while\n"
        "acquiring A anywhere else. graftlint's `lock-manifest-drift`\n"
        "rule fails the run on any edge not in `locks_manifest.json`;\n"
        "`lock-order-cycle` fails it if the union stops being a DAG.\n"
        "The runtime sanitizer (`utils/locksan.py`, `AMTPU_LOCKSAN=1`)\n"
        "checks the same order on live threads via the runtime names\n"
        "below.\n")
    if cycle:
        out.append("\n**WARNING: the committed order contains a cycle: "
                   + " -> ".join(cycle) + "**\n")

    out.append("\n## Acquisition levels\n")
    out.append("\nHold locks only in increasing level order (a lock may\n"
               "be acquired while holding locks from strictly earlier\n"
               "levels; same-level locks are never nested today).\n\n")
    for i, level in enumerate(_levels(edges), start=1):
        pretty = ", ".join(f"`{n}`" for n in level)
        out.append(f"{i}. {pretty}\n")

    out.append("\n## Locks\n\n")
    out.append("| lock id | runtime name (locksan) |\n")
    out.append("|---|---|\n")
    for e in sorted(manifest.locks, key=lambda e: e["id"]):
        name = e.get("name")
        out.append(f"| `{e['id']}` | "
                   + (f"`{name}`" if name else "—") + " |\n")

    out.append("\n## Ordering edges\n\n")
    out.append("| held | then acquired | witness |\n")
    out.append("|---|---|---|\n")
    for e in sorted(manifest.order,
                    key=lambda e: (e["before"], e["after"])):
        out.append(f"| `{e['before']}` | `{e['after']}` | "
                   f"{e.get('site', '')} |\n")

    out.append("\n## Declared lock-free shared state\n\n")
    if not manifest.lockfree:
        out.append("(none)\n")
    else:
        out.append("| attribute | justification |\n")
        out.append("|---|---|\n")
        for e in sorted(manifest.lockfree, key=lambda e: e["attr"]):
            out.append(f"| `{e['attr']}` | "
                       f"{e.get('justification', '')} |\n")
    return "".join(out)
