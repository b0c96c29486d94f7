"""Shared call-graph + lock-footprint machinery for graftlint passes (the
port's copy of `automerge_tpu/analysis/flow.py`; scopes hang off the
analyzed package, `project.package`).

Extracted from `lock_discipline.py` so the ordering/blocking rules, the
thread-reachability map (`threadmap.py`), the race rules (`races.py`)
and the lock-hierarchy manifest all compute from ONE model of the code:

- `ClassMap` — per-module class-level lookups: which attributes are
  locks (and their runtime names when the factory takes one), base
  classes, thread-target attributes, and lock identity resolution
  (`EngineDocSet._lock`, `docledger._registry_lock`, `*.attr` when the
  owner cannot be pinned).
- `FuncSummary` + `summarize()` — direct acquisitions / blocking calls /
  resolvable call edges of one function (nested defs excluded: they may
  run on another thread entirely).
- `fixpoint()` — transitive closure of acquisitions and blocking
  hazards over the call graph.
- `FlowIndex` — the bundle for one (project, scope): classmaps,
  summaries, transitive sets, discovered lock names; plus
  `walk_holds()`, the held-stack walker that reports ordering edges and
  blocking-call sites to callbacks.
- `lock_graph()` — the global lock-order edge multigraph, the source of
  truth for the lock manifest and its hierarchy doc.
- `LocksManifest` — load/save of a manifest (ordered edges + declared
  lock-free shared sites), shared by the static passes and the runtime
  sanitizer (utils/locksan.py). The passes read `locks_manifest.json`,
  the file the port's sanitizer reads; `--write-locks-manifest` writes
  the port's own derivation to `locks_manifest_torch.json` and
  `docs/LOCK_HIERARCHY_TORCH.md`.

Blocking calls: the reference's table, plus the torch readbacks for the
port's tree (`.item()`, `.cpu()`, `.tolist()`, `torch.cuda.synchronize`,
`cuda_kernels.hashes_to_numpy`): a readback under the service lock on the
card is the same stall class as the reference's device readback.

Identity rules are unchanged from the original pass: locks are
`Class.attr` where the declaring class is resolvable (single-level MRO
walk), `module.attr` for module globals, `*.attr` otherwise; only
attributes that read as locks (factory assignment, "lock"/"mutex" in
the name, known condition-variable names) participate.
"""

from __future__ import annotations

import ast
import json
import pathlib
from dataclasses import dataclass, field

from .core import (PACKAGE, REFERENCE_PACKAGE, Project, SourceUnit,
                   dotted_name, scope_of)
from .jit_hygiene import _Func, _ModuleIndex, _module_index

#: scope of the original lock-discipline rules: where reader threads,
#: the watchdog, the audit loop and application threads meet the locks.
DEFAULT_DIRS = ("sync", "utils")

#: scope of the race plane (threadmap / races / the lock manifest): the
#: collector, remediation and watchdog threads in perf/ share state with
#: sync/ and utils/, so the thread-reachability analysis spans all three.
RACE_DIRS = ("sync", "utils", "perf")


def default_scope(project: Project) -> tuple[str, ...]:
    return scope_of(project.package, *DEFAULT_DIRS)


def race_scope(project: Project) -> tuple[str, ...]:
    return scope_of(project.package, *RACE_DIRS)


#: the manifest the passes read (the one the port's sanitizer reads)
MANIFEST_NAME = "locks_manifest.json"
#: where --write-locks-manifest writes the port's own derivation
MANIFEST_OUT_NAME = "locks_manifest_torch.json"
HIERARCHY_DOC = "docs/LOCK_HIERARCHY_TORCH.md"

LOCK_FACTORIES = {
    "threading.Lock", "threading.RLock", "threading.Condition",
    "threading.Semaphore", "threading.BoundedSemaphore",
    # the lockprof wrappers (utils/lockprof.py) are drop-in lock
    # factories: an instrumented lock must keep its class-qualified
    # identity (EngineDocSet._lock) and keep participating in ABBA /
    # blocking-call analysis — profiling a lock must never exempt it
    # from the discipline the profile exists to inform
    *(f"{pkg}.utils.lockprof.{name}"
      for pkg in (PACKAGE, REFERENCE_PACKAGE)
      for name in ("InstrumentedLock", "InstrumentedRLock",
                   "InstrumentedCondition")),
    "lockprof.InstrumentedLock", "lockprof.InstrumentedRLock",
    "lockprof.InstrumentedCondition",
    # the sanitizer's named factory (utils/locksan.py): same rule
    *(f"{pkg}.utils.locksan.named_lock"
      for pkg in (PACKAGE, REFERENCE_PACKAGE)),
    "locksan.named_lock",
}
#: factories whose first positional arg / name= kwarg is the runtime
#: lock name the sanitizer sees — captured into the manifest lock table.
NAMED_LOCK_FACTORIES = {
    f for f in LOCK_FACTORIES
    if "lockprof" in f or "locksan" in f
}
THREAD_FACTORY = "threading.Thread"

# attribute names that read as lock objects even without a visible
# factory assignment (the tcp sync lock is created behind a helper)
LOCKISH_HINTS = ("lock", "mutex")
CV_NAMES = {"_cv", "cv", "cond", "_cond", "condition"}

# direct blocking attribute calls, by hazard class
BLOCKING_ATTRS = {
    "recv": "socket", "recv_into": "socket", "recvfrom": "socket",
    "accept": "socket", "sendall": "socket", "connect": "socket",
    "getaddrinfo": "socket",
    "sleep": "sleep",
    "block_until_ready": "device-readback", "device_get": "device-readback",
}
# duck-typed engine reads: a readback barrier whoever the receiver is
# (audit_state/audit_shard_state compute full hash fan-outs — serving an
# audit pull on a transport reader thread is the documented caveat in
# sync/audit.py's "Thread-cost note")
ENGINE_READ_ATTRS = {"hashes": "device-readback",
                     "hashes_for": "device-readback",
                     "hashes_snapshot": "device-readback",
                     "materialize": "device-readback",
                     "audit_state": "device-readback",
                     "audit_shard_state": "device-readback"}
BLOCKING_NAME_CALLS = {"send_frame": "socket", "recv_frame": "socket"}
# the torch readbacks, checked on the port's tree: a tensor read to the
# host (or a wait for the card) whoever the receiver is, and the engines'
# hash readback helper, a project function the call graph would
# otherwise walk into
TORCH_READBACK_ATTRS = {"item": "device-readback",
                        "cpu": "device-readback",
                        "tolist": "device-readback",
                        "synchronize": "device-readback"}
TORCH_READBACK_CALLS = {"hashes_to_numpy": "device-readback"}


@dataclass
class FuncSummary:
    func: _Func
    acquires: set[str] = field(default_factory=set)     # direct lock ids
    blocks: set[str] = field(default_factory=set)       # direct hazard descs
    calls: set[tuple] = field(default_factory=set)      # callee func keys


class ClassMap:
    """Class-level lookups for one module: declared locks, base classes,
    and method resolution (incl. single-level inheritance + super())."""

    def __init__(self, unit: SourceUnit, idx: _ModuleIndex):
        self.unit = unit
        self.idx = idx
        self.class_lock_attrs: dict[str, set[str]] = {}   # class -> attrs
        self.attr_owners: dict[str, set[str]] = {}        # attr -> classes
        self.bases: dict[str, list[str]] = {}             # class -> dotted
        self.thread_targets: set[str] = set()             # names/attrs
        self.lock_names: dict[str, str] = {}              # lock id -> runtime
        self._collect()

    def _collect(self) -> None:
        for node in ast.walk(self.unit.tree):
            if isinstance(node, ast.ClassDef):
                self.bases[node.name] = [
                    dotted_name(b) for b in node.bases if dotted_name(b)]
        stack: list[tuple[str | None, ast.AST]] = [(None, self.unit.tree)]
        while stack:
            cls, node = stack.pop()
            for child in ast.iter_child_nodes(node):
                stack.append((child.name if isinstance(child, ast.ClassDef)
                              else cls, child))
            if not isinstance(node, ast.Assign) or \
                    not isinstance(node.value, ast.Call):
                continue
            callee = dotted_name(node.value.func)
            resolved = self.idx.resolve_dotted(callee) if callee else None
            is_lock = resolved in LOCK_FACTORIES
            is_thread = resolved == THREAD_FACTORY
            if not (is_lock or is_thread):
                continue
            runtime_name = None
            if is_lock and resolved in NAMED_LOCK_FACTORIES:
                runtime_name = _const_first_arg(node.value)
            for tgt in node.targets:
                attr = None
                owner = None
                if isinstance(tgt, ast.Attribute):
                    attr = tgt.attr
                    if isinstance(tgt.value, ast.Name) \
                            and tgt.value.id == "self":
                        owner = cls
                elif isinstance(tgt, ast.Name):
                    attr = tgt.id
                if attr is None:
                    continue
                if is_thread:
                    self.thread_targets.add(attr)
                    continue
                self.attr_owners.setdefault(attr, set())
                if owner:
                    self.attr_owners[attr].add(owner)
                    self.class_lock_attrs.setdefault(owner, set()).add(attr)
                    if runtime_name:
                        self.lock_names[f"{owner}.{attr}"] = runtime_name
                elif runtime_name and isinstance(tgt, ast.Name):
                    modtail = self.unit.modname.rsplit(".", 1)[-1]
                    self.lock_names[f"{modtail}.{attr}"] = runtime_name

    def enclosing_class(self, qualname: str) -> str | None:
        """Nearest enclosing segment that names a class — handles methods
        ("C.m") and functions nested in methods ("C.m._cm")."""
        parts = qualname.split(".")
        for i in range(len(parts) - 2, -1, -1):
            if parts[i] in self.bases:
                return parts[i]
        return None

    def lock_id(self, expr: ast.AST, qualname: str) -> str | None:
        """The lock identity of a with-item expression, or None if the
        expression does not read as a lock."""
        name = dotted_name(expr)
        if name is None:
            return None
        attr = name.rsplit(".", 1)[-1]
        lockish = (any(h in attr.lower() for h in LOCKISH_HINTS)
                   or attr in CV_NAMES or attr in self.attr_owners)
        if not lockish:
            return None
        cls = self.enclosing_class(qualname)
        if name.startswith("self.") and name.count(".") == 1:
            if cls:
                # walk the MRO the pass can see: the class itself, then
                # its (project-resolvable) bases
                for c in [cls] + self._base_names(cls):
                    if attr in self.class_lock_attrs.get(c, set()):
                        return f"{c}.{attr}"
            owners = self.attr_owners.get(attr, set())
            if len(owners) == 1:
                return f"{next(iter(owners))}.{attr}"
            return f"*.{attr}"
        owners = self.attr_owners.get(attr, set())
        if len(owners) == 1 and "." in name:
            return f"{next(iter(owners))}.{attr}"
        if "." not in name:           # module-global lock
            return f"{self.unit.modname.rsplit('.', 1)[-1]}.{attr}"
        return f"*.{attr}"

    def _base_names(self, cls: str) -> list[str]:
        out = []
        for b in self.bases.get(cls, []):
            out.append(b.rsplit(".", 1)[-1])
        return out

    def resolve_method(self, cls: str, meth: str) -> _Func | None:
        """C.meth in this module, else in a base class (single level,
        project-resolvable bases only)."""
        f = self.idx.all_funcs.get(f"{cls}.{meth}")
        if f is not None:
            return f
        return self.resolve_in_bases(cls, meth)

    def resolve_in_bases(self, cls: str, meth: str) -> _Func | None:
        """`meth` looked up on cls's base classes ONLY — the super()
        path, where the subclass's own override must be skipped."""
        for b in self.bases.get(cls, []):
            resolved = self.idx.resolve_dotted(b)
            if "." in resolved:
                modname, bcls = resolved.rsplit(".", 1)
                u = self.idx.project.by_modname(modname)
                if u is not None:
                    bidx = _module_index(self.idx.project, u)
                    f = bidx.all_funcs.get(f"{bcls}.{meth}")
                    if f is not None:
                        return f
            f = self.idx.all_funcs.get(f"{resolved.rsplit('.', 1)[-1]}"
                                       f".{meth}")
            if f is not None:
                return f
        return None


def _const_first_arg(call: ast.Call) -> str | None:
    """The literal runtime name handed to a named lock factory."""
    for kw in call.keywords:
        if kw.arg == "name" and isinstance(kw.value, ast.Constant) \
                and isinstance(kw.value.value, str):
            return kw.value.value
    if call.args and isinstance(call.args[0], ast.Constant) \
            and isinstance(call.args[0].value, str):
        return call.args[0].value
    return None


def is_str_receiver(expr: ast.AST) -> bool:
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return True
    if isinstance(expr, ast.JoinedStr):
        return True
    name = dotted_name(expr)
    return name in {"os.path", "posixpath", "ntpath", "str", "string"}


def resolve_call(node: ast.Call, f: _Func, idx: _ModuleIndex,
                 cmap: ClassMap) -> _Func | None:
    """Resolve a call site to a project function: self.m() and
    super().m() before the generic import-alias resolver."""
    if isinstance(node.func, ast.Attribute):
        v = node.func.value
        cls = cmap.enclosing_class(f.qualname)
        if isinstance(v, ast.Name) and v.id == "self" and cls:
            return cmap.resolve_method(cls, node.func.attr)
        if isinstance(v, ast.Call) and isinstance(v.func, ast.Name) \
                and v.func.id == "super" and cls:
            # NOT resolve_method: that returns the subclass's own
            # override, which is exactly what super() skips
            return cmap.resolve_in_bases(cls, node.func.attr)
    return idx.resolve_func(node.func)


def torch_readback(node: ast.Call, cmap: ClassMap) -> str | None:
    """"device-readback:what()" when the call is a torch readback and the
    analyzed package is the port's, else None. Checked before the call
    is resolved into the project."""
    if cmap.idx.project.package != PACKAGE:
        return None
    fn = node.func
    name = fn.attr if isinstance(fn, ast.Attribute) else \
        fn.id if isinstance(fn, ast.Name) else None
    hz = TORCH_READBACK_CALLS.get(name)
    if hz is None and isinstance(fn, ast.Attribute):
        hz = TORCH_READBACK_ATTRS.get(name)
    if hz is None or (isinstance(fn, ast.Attribute)
                      and _numpy_value(fn.value, cmap.idx)):
        return None
    rname = dotted_name(fn)
    return f"{hz}:{rname or name}()"


def _numpy_value(expr: ast.AST, idx: _ModuleIndex) -> bool:
    """Whether `expr` is evidently a numpy value: an index into, or an
    attribute of, the result of a `numpy.*` call (`np.nonzero(m)[0]`), so
    its `.tolist()` / `.item()` reads no device."""
    while isinstance(expr, (ast.Subscript, ast.Attribute)):
        expr = expr.value
    if not isinstance(expr, ast.Call):
        return False
    name = dotted_name(expr.func)
    return name is not None and idx.resolve_dotted(name).startswith(
        "numpy.")


def blocking_desc(node: ast.Call, cmap: ClassMap,
                  held_exprs: list[str]) -> str | None:
    """"hazard:what()" when the call is a known blocking primitive."""
    if isinstance(node.func, ast.Name):
        hz = BLOCKING_NAME_CALLS.get(node.func.id)
        return f"{hz}:{node.func.id}()" if hz else None
    if not isinstance(node.func, ast.Attribute):
        return None
    attr = node.func.attr
    recv = node.func.value
    if attr == "join":
        if is_str_receiver(recv):
            return None
        rname = dotted_name(recv) or ""
        tail = rname.rsplit(".", 1)[-1]
        if tail in cmap.thread_targets or "thread" in tail.lower() \
                or tail == "t":
            return f"thread-join:{rname or 'thread'}.join()"
        return None
    if attr == "wait":
        rname = dotted_name(recv)
        if rname is not None and rname in held_exprs:
            return None     # cv.wait releases the held condition
        return f"wait:{rname or '?'}.wait()"
    hz = BLOCKING_ATTRS.get(attr) or ENGINE_READ_ATTRS.get(attr)
    if hz:
        rname = dotted_name(recv)
        return f"{hz}:{(rname + '.') if rname else ''}{attr}()"
    return None


def summarize(f: _Func, idx: _ModuleIndex, cmap: ClassMap) -> FuncSummary:
    """Direct acquisitions/blocks/calls of ONE function. Nested defs
    are excluded — they have their own summaries, and their bodies may
    run on another thread entirely (a closure spawned as a Thread
    target must not make its spawner look blocking)."""
    s = FuncSummary(f)

    def visit(node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            return              # summarized separately
        if isinstance(node, ast.With):
            for item in node.items:
                lid = cmap.lock_id(item.context_expr, f.qualname)
                if lid:
                    s.acquires.add(lid)
        elif isinstance(node, ast.Call):
            readback = torch_readback(node, cmap)
            callee = None if readback else resolve_call(node, f, idx, cmap)
            if readback:
                s.blocks.add(readback)
            elif callee is not None and callee.key() != f.key():
                s.calls.add(callee.key())
            else:
                desc = blocking_desc(node, cmap, [])
                if desc:
                    s.blocks.add(desc)
        for child in ast.iter_child_nodes(node):
            visit(child)

    body = f.node.body if isinstance(f.node.body, list) else [f.node.body]
    for stmt in body:
        visit(stmt)
    return s


def fixpoint(summaries: dict) -> tuple[dict, dict]:
    """Transitive acquisitions and blocking hazards over the call graph."""
    trans_acq = {k: set(s.acquires) for k, s in summaries.items()}
    trans_blk = {k: set(s.blocks) for k, s in summaries.items()}
    changed = True
    rounds = 0
    while changed and rounds < 50:
        changed = False
        rounds += 1
        for k, s in summaries.items():
            for c in s.calls:
                if c in trans_acq:
                    if not trans_acq[c] <= trans_acq[k]:
                        trans_acq[k] |= trans_acq[c]
                        changed = True
                    if not trans_blk[c] <= trans_blk[k]:
                        trans_blk[k] |= trans_blk[c]
                        changed = True
    return trans_acq, trans_blk


class FlowIndex:
    """The shared flow model for one (project, scope): classmaps,
    per-function summaries, and the transitive closures."""

    def __init__(self, project: Project, scope: tuple[str, ...]):
        self.project = project
        self.scope = scope
        self.units = project.under(*scope)
        self.classmaps: dict[str, ClassMap] = {}
        self.summaries: dict[tuple, FuncSummary] = {}
        for unit in self.units:
            idx = _module_index(project, unit)
            self.classmaps[unit.rel] = ClassMap(unit, idx)
        for unit in self.units:
            idx = _module_index(project, unit)
            cmap = self.classmaps[unit.rel]
            for f in idx.all_funcs.values():
                self.summaries[f.key()] = summarize(f, idx, cmap)
        self.trans_acq, self.trans_blk = fixpoint(self.summaries)

    def index(self, unit: SourceUnit) -> _ModuleIndex:
        return _module_index(self.project, unit)

    @property
    def lock_names(self) -> dict[str, str]:
        """lock id -> runtime name, merged over the scope's modules."""
        out: dict[str, str] = {}
        for cmap in self.classmaps.values():
            out.update(cmap.lock_names)
        return out

    def walk_holds(self, f: _Func, on_edge=None, on_block=None) -> None:
        """Walk one function tracking the held-lock stack.

        - on_edge(outer_id, inner_id, label, line, rel) for every
          ordering edge (syntactic nesting or a call whose transitive
          footprint acquires another lock while one is held).
        - on_block(node, held_id, desc, callee) for every blocking call
          made while holding a lock (callee is the resolved _Func for
          the transitive case, None for a direct blocking primitive).
        """
        unit = f.unit
        idx = self.index(unit)
        cmap = self.classmaps[unit.rel]
        held: list[tuple[str, str]] = []   # (lock id, dotted expr)
        label = f"{unit.modname.rsplit('.', 1)[-1]}.{f.qualname}"

        def visit(node):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not f.node:
                return
            if isinstance(node, ast.With):
                entered = 0
                for item in node.items:
                    lid = cmap.lock_id(item.context_expr, f.qualname)
                    if lid:
                        if on_edge:
                            for hid, _ in held:
                                if hid != lid:
                                    on_edge(hid, lid, label,
                                            item.context_expr.lineno,
                                            unit.rel)
                        held.append(
                            (lid, dotted_name(item.context_expr) or lid))
                        entered += 1
                for child in node.body:
                    visit(child)
                for item in node.items:   # re-visit exprs for call checks
                    visit(item.context_expr)
                del held[len(held) - entered:len(held)]
                return
            if isinstance(node, ast.Call) and held:
                hid, _ = held[-1]
                readback = torch_readback(node, cmap)
                callee = None if readback else resolve_call(node, f, idx,
                                                            cmap)
                if readback:
                    if on_block:
                        on_block(node, hid, readback, None)
                elif callee is not None and callee.key() != f.key():
                    ck = callee.key()
                    if on_edge:
                        for inner in self.trans_acq.get(ck, ()):
                            if inner != hid:
                                on_edge(hid, inner, label, node.lineno,
                                        unit.rel)
                    blk = self.trans_blk.get(ck, ())
                    if blk and on_block:
                        on_block(node, hid, sorted(blk)[0], callee)
                else:
                    desc = blocking_desc(node, cmap, [e for _, e in held])
                    if desc and on_block:
                        on_block(node, hid, desc, None)
            for child in ast.iter_child_nodes(node):
                visit(child)

        body = f.node.body if isinstance(f.node.body, list) else [f.node.body]
        for stmt in body:
            visit(stmt)


def flow_index(project: Project,
               scope: tuple[str, ...]) -> FlowIndex:
    """FlowIndex for (project, scope), cached on the project."""
    cache = project.__dict__.setdefault("_flow_cache", {})
    fi = cache.get(scope)
    if fi is None:
        fi = cache[scope] = FlowIndex(project, scope)
    return fi


def lock_graph(project: Project, scope: tuple[str, ...] | None = None,
               ) -> dict[tuple[str, str], list[tuple[str, int, str]]]:
    """The global lock-order edge multigraph: (outer, inner) -> list of
    (function label, line, rel path) witness sites; the race scope of the
    project's package unless `scope` is given."""
    fi = flow_index(project, scope or race_scope(project))
    edges: dict[tuple[str, str], list[tuple[str, int, str]]] = {}

    def on_edge(a, b, label, line, rel):
        edges.setdefault((a, b), []).append((label, line, rel))

    for unit in fi.units:
        idx = fi.index(unit)
        for f in idx.all_funcs.values():
            fi.walk_holds(f, on_edge=on_edge)
    return edges


def find_cycle(edges: set[tuple[str, str]]) -> list[str] | None:
    """A lock cycle in the directed edge set, as a node list
    [a, b, ..., a], or None when the graph is a DAG."""
    succ: dict[str, list[str]] = {}
    for a, b in sorted(edges):
        succ.setdefault(a, []).append(b)
    WHITE, GREY, BLACK = 0, 1, 2
    color: dict[str, int] = {}
    stack: list[str] = []

    def dfs(n: str) -> list[str] | None:
        color[n] = GREY
        stack.append(n)
        for m in succ.get(n, ()):
            c = color.get(m, WHITE)
            if c == GREY:
                return stack[stack.index(m):] + [m]
            if c == WHITE:
                cyc = dfs(m)
                if cyc:
                    return cyc
        stack.pop()
        color[n] = BLACK
        return None

    for n in sorted(succ):
        if color.get(n, WHITE) == WHITE:
            cyc = dfs(n)
            if cyc:
                return cyc
    return None


# ---------------------------------------------------------------------------
# the committed manifest


class LocksManifest:
    """A lock manifest: the reviewed lock hierarchy + the declared
    lock-free shared sites.

    Schema (version 1):
      {"version": 1,
       "locks":    [{"id": "EngineDocSet._lock", "name": "service"}],
       "order":    [{"before": A, "after": B, "site": "rel:line fn"}],
       "lockfree": [{"attr": "Svc._clock_cache", "justification": "..."}]}
    """

    def __init__(self, locks=None, order=None, lockfree=None):
        self.locks: list[dict] = locks or []
        self.order: list[dict] = order or []
        self.lockfree: list[dict] = lockfree or []

    @classmethod
    def load(cls, path: pathlib.Path) -> "LocksManifest | None":
        if not path.exists():
            return None
        data = json.loads(path.read_text())
        return cls(locks=data.get("locks", []),
                   order=data.get("order", []),
                   lockfree=data.get("lockfree", []))

    def save(self, path: pathlib.Path) -> None:
        data = {"version": 1, "locks": self.locks, "order": self.order,
                "lockfree": self.lockfree}
        path.write_text(json.dumps(data, indent=2, sort_keys=False) + "\n")

    def order_edges(self) -> set[tuple[str, str]]:
        return {(e["before"], e["after"]) for e in self.order}

    def lockfree_attrs(self) -> dict[str, str]:
        return {e["attr"]: e.get("justification", "")
                for e in self.lockfree}

    def lock_names(self) -> dict[str, str]:
        return {e["id"]: e["name"] for e in self.locks if e.get("name")}


def build_manifest(project: Project,
                   prior: "LocksManifest | None" = None) -> LocksManifest:
    """Derive the manifest from the current code: every ordering edge
    with one witness site, the named-lock table, and the lock-free
    declarations carried over from the prior manifest (those are
    human-authored justifications; regeneration must not drop them)."""
    fi = flow_index(project, race_scope(project))
    edges = lock_graph(project)
    lock_ids: set[str] = set()
    for (a, b) in edges:
        lock_ids.update((a, b))
    for s in fi.summaries.values():
        lock_ids.update(s.acquires)
    names = fi.lock_names
    locks = [{"id": lid, "name": names.get(lid)}
             for lid in sorted(lock_ids)]
    order = []
    for (a, b), sites in sorted(edges.items()):
        label, line, rel = sites[0]
        order.append({"before": a, "after": b,
                      "site": f"{rel}:{line} {label}()"})
    lockfree = list(prior.lockfree) if prior is not None else []
    return LocksManifest(locks=locks, order=order, lockfree=lockfree)
