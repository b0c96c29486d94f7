"""threadmap: which thread roots reach which attribute-access sites,
and which locks are guaranteed held on every path there (the port's copy
of `automerge_tpu/analysis/threadmap.py`, over the analyzed package's
race scope; on the port's tree the thread roots include every
`amtpu-torch-*` thread's target).

The race rules (`races.py`) need three facts per shared-state access:
*who* can execute it (the set of thread roots whose call graphs reach
the enclosing function), *what* is guaranteed held when they do (the
intersection of lock sets over all call paths from each root), and
*what kind* of access it is (plain write, container mutation, read).
This module computes all three on top of `analysis/flow.py`.

Thread roots:

- **main** — the application/API surface: every public function or
  method in scope (final name segment not underscore-prefixed, plus the
  context-manager/iterator dunders) is callable from an application
  thread with no locks held. `__init__` is seeded too (constructors run
  on the calling thread); access sites *inside* `__init__` are excluded
  from the site table — construction happens-before publication.
- **thread:<mod>.<qualname>** — every resolvable
  `threading.Thread(target=...)` target in scope: the tcp reader/accept
  loops, supervisor redial loops, watchdog and collector ticks, chaos
  holder threads. Local-closure targets (`def worker(): ...` inside the
  spawning method) resolve through the enclosing qualname.

Propagation is a worklist over the call graph: the locks guaranteed
held at a function's entry, per root, is the INTERSECTION over all call
sites that reach it (seeded empty at each root); at an access site the
guarantee is the entry set plus the locks of the syntactically
enclosing `with` blocks. Intersection (not union) is what makes the
result a *guarantee* — a lock held on one path but not another protects
nothing.

Call edges resolve like the lock pass (self-methods, super(), module
functions through import aliases) plus one extra step the race rules
need: a duck-typed `x.meth()` on a non-self receiver resolves when
exactly ONE class in scope defines `meth` and no module function shades
the name — that is what connects the tcp reader loop into
`DocLedger.record_recv()` and the collector into the per-node state.
Ambiguous names (`close`, `send`, ...) stay unresolved and end the
walk, as before.

Known limits (docs/ANALYSIS.md): callbacks stored in attributes and
invoked later (`on_peer_metrics`, remediation action tables) are
invisible call edges — sites only reachable through them attribute to
the registering root, not the invoking one; lambda thread targets are
unresolvable and contribute no root; attribute identity merges
same-named classes across modules, exactly like lock identity.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from .core import Project, dotted_name
from .flow import (CV_NAMES, LOCKISH_HINTS, THREAD_FACTORY, ClassMap,
                   FlowIndex, flow_index, race_scope, resolve_call)
from .jit_hygiene import _Func

#: container-mutation method names: calling one of these on a shared
#: attribute rewrites structure in place (the `.append`/`.pop`/
#: `dict[k]=` class). `set`/`add` are deliberately
#: absent: `Event.set()` and metric `.add()` receivers dominate and are
#: internally synchronized.
MUTATORS = {"append", "appendleft", "extend", "insert", "remove",
            "discard", "pop", "popleft", "popitem", "clear", "update",
            "setdefault"}

#: module-level factory names whose result is a mutable container —
#: module globals bound to one of these are tracked for mutation sites.
_CONTAINER_FACTORIES = {"dict", "list", "set", "defaultdict", "deque",
                        "OrderedDict", "Counter", "WeakValueDictionary"}

MAIN_ROOT = "main"

#: dunders that are part of the public surface (context managers,
#: iteration) and therefore main-callable.
_PUBLIC_DUNDERS = {"__init__", "__call__", "__enter__", "__exit__",
                   "__iter__", "__next__", "__contains__", "__len__",
                   "__getitem__", "__setitem__"}


@dataclass(frozen=True)
class AttrSite:
    attr: str                 # identity: "Class.attr" or "module.global"
    kind: str                 # "write" | "mutate" | "read"
    rel: str
    line: int
    col: int
    func_key: tuple
    label: str                # "<mod>.<qualname>" of the enclosing func
    held: frozenset           # lock ids held syntactically at the site


@dataclass
class FuncFacts:
    func: _Func
    calls: list = field(default_factory=list)   # (callee key, frozenset)
    sites: list = field(default_factory=list)   # AttrSite


def _is_public(qualname: str) -> bool:
    tail = qualname.rsplit(".", 1)[-1]
    if tail in _PUBLIC_DUNDERS:
        return True
    return not tail.startswith("_")


def _lockish_attr(attr: str, cmap: ClassMap) -> bool:
    return (any(h in attr.lower() for h in LOCKISH_HINTS)
            or attr in CV_NAMES or attr in cmap.attr_owners)


class _ModuleShape:
    """Per-module attribute ownership: which classes declare which
    attributes (any `self.X = ...`), which globals are runtime-mutated
    (`global X` in a function), which globals are mutable containers."""

    def __init__(self, unit, cmap: ClassMap):
        self.unit = unit
        self.cmap = cmap
        self.class_attrs: dict[str, set[str]] = {}
        self.mut_globals: set[str] = set()
        self.container_globals: set[str] = set()
        self._collect()

    def _collect(self) -> None:
        stack: list[tuple[str | None, ast.AST]] = [(None, self.unit.tree)]
        while stack:
            cls, node = stack.pop()
            for child in ast.iter_child_nodes(node):
                stack.append((child.name if isinstance(child, ast.ClassDef)
                              else cls, child))
            if isinstance(node, ast.Global):
                self.mut_globals.update(node.names)
            if cls is not None:
                for tgt in _assign_targets(node):
                    if isinstance(tgt, ast.Attribute) \
                            and isinstance(tgt.value, ast.Name) \
                            and tgt.value.id == "self":
                        self.class_attrs.setdefault(cls, set()).add(tgt.attr)
        for node in self.unit.tree.body:
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, (ast.Dict, ast.List, ast.Set,
                                                ast.DictComp, ast.ListComp,
                                                ast.Call)):
                if isinstance(node.value, ast.Call):
                    callee = dotted_name(node.value.func) or ""
                    if callee.rsplit(".", 1)[-1] not in _CONTAINER_FACTORIES:
                        continue
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        self.container_globals.add(tgt.id)

    def self_attr_id(self, cls: str | None, attr: str) -> str | None:
        if cls is None:
            return None
        for c in [cls] + self.cmap._base_names(cls):
            if attr in self.class_attrs.get(c, set()):
                return f"{c}.{attr}"
        return f"{cls}.{attr}"

    def global_id(self, name: str) -> str:
        modtail = self.unit.modname.rsplit(".", 1)[-1]
        return f"{modtail}.{name}"


def _assign_targets(node: ast.AST):
    if isinstance(node, ast.Assign):
        return node.targets
    if isinstance(node, (ast.AnnAssign, ast.AugAssign)):
        return [node.target]
    return []


class ThreadMap:
    """Thread roots + per-site reaching roots and guaranteed-held locks
    for one (project, scope)."""

    def __init__(self, project: Project,
                 scope: tuple[str, ...] | None = None):
        self.project = project
        self.fi: FlowIndex = flow_index(project,
                                        scope or race_scope(project))
        self.shapes: dict[str, _ModuleShape] = {}
        self.facts: dict[tuple, FuncFacts] = {}
        self.roots: dict[str, set[tuple]] = {}       # root -> func keys
        self.thread_names: dict[str, str] = {}       # root -> name= hint
        #: (func key) -> {root: frozenset of guaranteed-held lock ids}
        self.entry: dict[tuple, dict[str, frozenset]] = {}
        self._build()

    # -- construction ---------------------------------------------------------

    def _build(self) -> None:
        for unit in self.fi.units:
            cmap = self.fi.classmaps[unit.rel]
            self.shapes[unit.rel] = _ModuleShape(unit, cmap)
        self._unique_methods = self._build_unique_methods()
        for unit in self.fi.units:
            idx = self.fi.index(unit)
            cmap = self.fi.classmaps[unit.rel]
            shape = self.shapes[unit.rel]
            for f in idx.all_funcs.values():
                self.facts[f.key()] = self._func_facts(f, idx, cmap, shape)
        self._discover_roots()
        self._propagate()

    def _build_unique_methods(self) -> dict[str, _Func]:
        """method name -> its _Func, for names defined by exactly one
        class in scope and by no module-level function — the duck-call
        resolution step."""
        seen: dict[str, list[_Func]] = {}
        shadowed: set[str] = set()
        for unit in self.fi.units:
            idx = self.fi.index(unit)
            shadowed.update(idx.funcs)          # module-level names
            for qual, f in idx.all_funcs.items():
                parts = qual.split(".")
                if len(parts) != 2:
                    continue                    # methods only, not nested
                seen.setdefault(parts[1], []).append(f)
        return {name: fs[0] for name, fs in seen.items()
                if len(fs) == 1 and name not in shadowed
                and not name.startswith("__")}

    def _discover_roots(self) -> None:
        thread_target_keys: set[tuple] = set()
        for unit in self.fi.units:
            idx = self.fi.index(unit)
            cmap = self.fi.classmaps[unit.rel]
            for f in idx.all_funcs.values():
                for node in ast.walk(f.node):
                    if not isinstance(node, ast.Call):
                        continue
                    callee = dotted_name(node.func)
                    if not callee or \
                            idx.resolve_dotted(callee) != THREAD_FACTORY:
                        continue
                    tgt = next((kw.value for kw in node.keywords
                                if kw.arg == "target"), None)
                    if tgt is None:
                        continue
                    target = self._resolve_target(tgt, f, idx, cmap)
                    if target is None:
                        continue
                    modtail = target.unit.modname.rsplit(".", 1)[-1]
                    root = f"thread:{modtail}.{target.qualname}"
                    self.roots.setdefault(root, set()).add(target.key())
                    thread_target_keys.add(target.key())
                    tname = _thread_name_hint(node)
                    if tname:
                        self.thread_names[root] = tname
        main: set[tuple] = set()
        for key, facts in self.facts.items():
            if key in thread_target_keys:
                continue
            if _is_public(facts.func.qualname):
                main.add(key)
        self.roots[MAIN_ROOT] = main

    def _resolve_target(self, tgt: ast.AST, f: _Func, idx,
                        cmap: ClassMap) -> _Func | None:
        if isinstance(tgt, ast.Name):
            # a local closure of the spawning function first
            local = idx.all_funcs.get(f"{f.qualname}.{tgt.id}")
            if local is not None:
                return local
            return idx.resolve_func(tgt)
        if isinstance(tgt, ast.Attribute):
            v = tgt.value
            cls = cmap.enclosing_class(f.qualname)
            if isinstance(v, ast.Name) and v.id == "self" and cls:
                return cmap.resolve_method(cls, tgt.attr)
            return idx.resolve_func(tgt)
        return None

    # -- per-function facts ---------------------------------------------------

    def _func_facts(self, f: _Func, idx, cmap: ClassMap,
                    shape: _ModuleShape) -> FuncFacts:
        facts = FuncFacts(f)
        cls = cmap.enclosing_class(f.qualname)
        label = f"{f.unit.modname.rsplit('.', 1)[-1]}.{f.qualname}"
        in_init = f.qualname.rsplit(".", 1)[-1] == "__init__"
        held: list[str] = []
        consumed: set[int] = set()      # Load nodes already counted
        local_names: set[str] = set(f.params)
        for n in ast.walk(f.node):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
                local_names.add(n.id)
        fglobals: set[str] = set()
        for n in ast.walk(f.node):
            if isinstance(n, ast.Global):
                fglobals.update(n.names)
        local_names -= fglobals

        def site(attr_id: str, kind: str, node: ast.AST) -> None:
            if in_init:
                return
            tail = attr_id.rsplit(".", 1)[-1]
            if _lockish_attr(tail, cmap):
                return
            facts.sites.append(AttrSite(
                attr=attr_id, kind=kind, rel=f.unit.rel,
                line=node.lineno, col=node.col_offset,
                func_key=f.key(), label=label,
                held=frozenset(held)))

        def self_attr(node: ast.AST) -> str | None:
            """identity when node is exactly `self.X`, else None."""
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == "self":
                return shape.self_attr_id(cls, node.attr)
            return None

        def global_ref(node: ast.AST, mutate: bool) -> str | None:
            if not isinstance(node, ast.Name):
                return None
            if node.id in local_names:
                return None
            tracked = shape.mut_globals if not mutate else (
                shape.mut_globals | shape.container_globals)
            if node.id in tracked:
                return shape.global_id(node.id)
            return None

        def record_store(tgt: ast.AST) -> None:
            aid = self_attr(tgt)
            if aid:
                consumed.add(id(tgt))
                site(aid, "write", tgt)
                return
            if isinstance(tgt, ast.Name) and tgt.id in fglobals:
                site(shape.global_id(tgt.id), "write", tgt)
                return
            if isinstance(tgt, ast.Subscript):
                aid = self_attr(tgt.value) or global_ref(tgt.value, True)
                if aid:
                    consumed.add(id(tgt.value))
                    site(aid, "mutate", tgt)
            if isinstance(tgt, (ast.Tuple, ast.List)):
                for el in tgt.elts:
                    record_store(el)

        def visit(node: ast.AST) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not f.node:
                return      # nested defs may run on another thread
            if isinstance(node, ast.With):
                entered = 0
                for item in node.items:
                    lid = cmap.lock_id(item.context_expr, f.qualname)
                    if lid:
                        held.append(lid)
                        entered += 1
                for child in node.body:
                    visit(child)
                del held[len(held) - entered:]
                return
            if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                for tgt in _assign_targets(node):
                    record_store(tgt)
            elif isinstance(node, ast.Delete):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Subscript):
                        aid = self_attr(tgt.value) \
                            or global_ref(tgt.value, True)
                        if aid:
                            consumed.add(id(tgt.value))
                            site(aid, "mutate", tgt)
            elif isinstance(node, ast.Call):
                fn = node.func
                if isinstance(fn, ast.Attribute) and fn.attr in MUTATORS:
                    aid = self_attr(fn.value) or global_ref(fn.value, True)
                    if aid:
                        consumed.add(id(fn.value))
                        site(aid, "mutate", node)
                callee = resolve_call(node, f, idx, cmap)
                if callee is None and isinstance(fn, ast.Attribute) \
                        and not (isinstance(fn.value, ast.Name)
                                 and fn.value.id == "self") \
                        and not (isinstance(fn.value, ast.Call)
                                 and isinstance(fn.value.func, ast.Name)
                                 and fn.value.func.id == "super"):
                    callee = self._unique_methods.get(fn.attr)
                if callee is not None and callee.key() != f.key():
                    facts.calls.append((callee.key(), frozenset(held)))
            elif isinstance(node, ast.Attribute) \
                    and isinstance(node.ctx, ast.Load) \
                    and id(node) not in consumed:
                aid = self_attr(node)
                if aid and cls is not None \
                        and cmap.resolve_method(cls, node.attr) is None:
                    site(aid, "read", node)
            elif isinstance(node, ast.Name) \
                    and isinstance(node.ctx, ast.Load):
                gid = global_ref(node, False)
                if gid:
                    site(gid, "read", node)
            for child in ast.iter_child_nodes(node):
                visit(child)

        body = f.node.body if isinstance(f.node.body, list) else [f.node.body]
        for stmt in body:
            visit(stmt)
        return facts

    # -- reachability ---------------------------------------------------------

    def _propagate(self) -> None:
        pending: list[tuple[tuple, str]] = []
        for root, keys in self.roots.items():
            for key in keys:
                self.entry.setdefault(key, {})[root] = frozenset()
                pending.append((key, root))
        while pending:
            key, root = pending.pop()
            facts = self.facts.get(key)
            if facts is None:
                continue
            base = self.entry[key][root]
            for callee, held_at_site in facts.calls:
                if callee not in self.facts:
                    continue
                ctx = base | held_at_site
                slot = self.entry.setdefault(callee, {})
                old = slot.get(root)
                new = ctx if old is None else (old & ctx)
                if old is None or new != old:
                    slot[root] = new
                    pending.append((callee, root))

    # -- queries --------------------------------------------------------------

    def site_contexts(self, s: AttrSite) -> dict[str, frozenset]:
        """root -> locks guaranteed held when that root executes s."""
        out = {}
        for root, entry_held in self.entry.get(s.func_key, {}).items():
            out[root] = entry_held | s.held
        return out

    def attr_table(self) -> dict[str, dict[str, list]]:
        """attr id -> {"write"|"mutate"|"read": [(site, contexts)]},
        only sites reachable from at least one root."""
        table: dict[str, dict[str, list]] = {}
        for facts in self.facts.values():
            for s in facts.sites:
                ctx = self.site_contexts(s)
                if not ctx:
                    continue
                slot = table.setdefault(
                    s.attr, {"write": [], "mutate": [], "read": []})
                slot[s.kind].append((s, ctx))
        for slot in table.values():
            for kind in slot:
                slot[kind].sort(key=lambda p: (p[0].rel, p[0].line,
                                               p[0].col))
        return table


def _thread_name_hint(node: ast.Call) -> str | None:
    for kw in node.keywords:
        if kw.arg != "name":
            continue
        if isinstance(kw.value, ast.Constant) \
                and isinstance(kw.value.value, str):
            return kw.value.value
        if isinstance(kw.value, ast.JoinedStr):
            parts = [v.value for v in kw.value.values
                     if isinstance(v, ast.Constant)]
            if parts:
                return "".join(str(p) for p in parts) + "*"
    return None


def thread_map(project: Project,
               scope: tuple[str, ...] | None = None) -> ThreadMap:
    """ThreadMap for (project, scope), cached on the project; the race
    scope of the project's package unless `scope` is given."""
    scope = scope or race_scope(project)
    cache = project.__dict__.setdefault("_threadmap_cache", {})
    tm = cache.get(scope)
    if tm is None:
        tm = cache[scope] = ThreadMap(project, scope)
    return tm
