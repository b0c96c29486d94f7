"""jit-hygiene pass on the port: host-sync, retrace, and shape-drift
hazards in the code a device dispatch reaches (the torch counterpart of
`automerge_tpu/analysis/jit_hygiene.py`, keeping its rule ids so that
`# graftlint: disable=` comments keep their meaning).

Scope: `engine/` and `parallel/` of the analyzed package. Torch has no
trace: a device program is the Python function that enqueues it. The roots
are the functions handed to `metrics.dispatch_jit` (the engines' ten
dispatch sites) and every function that calls `cuda_kernels.launch` (the
kernel wrappers). The pass walks the intra-package call graph from those
roots, tracking which values are TENSORS: parameters annotated as tensors
(`torch.Tensor`, `list[torch.Tensor]`, `dict`) or left unannotated with no
constant, the results of `torch.*` calls and of tensor methods; a
callee's parameter is a tensor when any call site passes it one (the
intersection of the static sets, as in the reference).

Rules:

- **jit-host-sync** (error): a host synchronization in code a root
  reaches — `.item()` / `.tolist()` / `.cpu()` / `.numpy()` on a tensor,
  `np.asarray` / `np.array` of a tensor, `int()` / `float()` / `bool()`
  of a tensor value, or `torch.cuda.synchronize()` (any `.synchronize()`)
  anywhere reachable. Each waits for the card in the middle of a
  dispatch: the stream drains and the host's enqueue stops overlapping
  the device.
- **jit-tracer-branch** (error): Python control flow (`if` / `while` /
  ternary / `assert`) on a tensor value: the condition reads the tensor
  back, an implicit sync.
- **jit-retrace** (error): a kernel build or compile inside a function
  body outside `engine/cuda_kernels.py`'s build cache —
  `cuda_kernels.build` / `_compile`, `ctypes.CDLL`, or `torch.compile`
  (unless the wrapper is stored into a subscripted cache).
- **jit-shape-drift** (warning): shape literals re-deriving canonical
  constants owned by `engine/pack.py` — open-coded lane-pad arithmetic
  (`((n + 127) // 128)` instead of `pack.pad_to_lanes`) and the row
  budget literal.

Known limits: dataflow through containers is approximated (a list holding
a tensor taints the whole list), duck-typed calls (`self._resident.X`)
end the walk, and a parameter's type comes from its annotation or its
call sites, never from inference.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from .core import (Finding, Project, SourceUnit, dotted_name, scope_of)

#: the scope's directories of the analyzed package
SCOPE_DIRS = ("engine", "parallel")

# numpy host-readback calls (resolved dotted names)
_READBACK_CALLS = {"numpy.asarray", "numpy.array", "np.asarray", "np.array"}

# tensor methods that copy to the host (flagged on a tensor receiver)
_READBACK_METHODS = {"item", "tolist", "cpu", "numpy"}

# attribute reads on a tensor that are PYTHON values
_STATIC_ATTRS = {"shape", "dtype", "ndim", "device", "is_cuda", "layout"}

# tensor methods whose result is a PYTHON value (no sync)
_STATIC_METHODS = {"dim", "size", "numel", "nelement", "element_size",
                   "data_ptr", "stride", "is_contiguous", "get_device",
                   "storage_offset", "is_floating_point", "type"}

# builtins whose call on a tensor is a host sync
_SCALAR_BUILTINS = {"float", "int", "bool", "complex"}

# torch calls whose result is a PYTHON value (or a context), not a tensor
_STATIC_TORCH = ("torch.cuda.", "torch.device", "torch.is_tensor",
                 "torch.iinfo", "torch.finfo", "torch.get_default_dtype",
                 "torch.Size", "torch.no_grad", "torch.inference_mode",
                 "torch.compile", "torch.Generator", "torch.backends.")

# builds and compiles (resolved dotted names or a cuda_kernels attribute)
_BUILD_CALLS = {"ctypes.CDLL", "torch.compile"}
_BUILD_KERNEL_FUNCS = {"build", "_compile"}
# annotation words that mark a parameter as holding tensors
_TENSOR_ANNOTATIONS = ("Tensor", "dict", "Dict")


@dataclass
class _Func:
    unit: SourceUnit
    node: ast.AST                    # FunctionDef | Lambda
    qualname: str
    params: list[str] = field(default_factory=list)

    def key(self):
        return (self.unit.rel, self.qualname)


def _params_of(node: ast.AST) -> list[str]:
    a = node.args
    names = [p.arg for p in a.posonlyargs + a.args]
    if a.vararg:
        names.append(a.vararg.arg)
    names += [p.arg for p in a.kwonlyargs]
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


def _positional_params(node: ast.AST) -> list[str]:
    a = node.args
    return [p.arg for p in a.posonlyargs + a.args]


class _ModuleIndex:
    """Per-module symbol view: function defs by (qual)name and import
    aliases resolved to dotted targets."""

    def __init__(self, unit: SourceUnit, project: Project):
        self.unit = unit
        self.project = project
        self.funcs: dict[str, _Func] = {}          # simple top-level name
        self.all_funcs: dict[str, _Func] = {}      # qualname
        self.aliases: dict[str, str] = {}          # local name -> dotted
        self._collect()

    def _collect(self) -> None:
        mod = self.unit.modname
        pkg = mod.rsplit(".", 1)[0] if "." in mod else ""

        def walk(body, prefix, top):
            for node in body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    q = f"{prefix}{node.name}"
                    f = _Func(self.unit, node, q, _params_of(node))
                    self.all_funcs[q] = f
                    if top:
                        self.funcs[node.name] = f
                    walk(node.body, q + ".", False)
                elif isinstance(node, ast.ClassDef):
                    walk(node.body, f"{prefix}{node.name}.", False)
                elif isinstance(node, (ast.If, ast.Try, ast.With)):
                    walk(getattr(node, "body", []), prefix, top)

        walk(self.unit.tree.body, "", True)

        for node in ast.walk(self.unit.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    base = mod if self.unit.rel.endswith("__init__.py") \
                        else pkg
                    for _ in range(node.level - 1):
                        base = base.rsplit(".", 1)[0] if "." in base else ""
                    src = (base + "." + node.module) if node.module else base
                else:
                    src = node.module or ""
                for a in node.names:
                    if a.name == "*":
                        continue
                    self.aliases[a.asname or a.name] = f"{src}.{a.name}"

    def resolve_dotted(self, name: str) -> str:
        """Expand the leading alias of a dotted name ("pl.pallas_call" ->
        "jax.experimental.pallas.pallas_call")."""
        head, _, rest = name.partition(".")
        target = self.aliases.get(head, head)
        return f"{target}.{rest}" if rest else target

    def resolve_func(self, call_func: ast.AST) -> "_Func | None":
        """Resolve a Call's func expression to a project function: bare
        names, imported symbols, module-attribute calls, and the
        `f.__wrapped__` jit-unwrap idiom."""
        if isinstance(call_func, ast.Attribute) \
                and call_func.attr == "__wrapped__":
            return self.resolve_func(call_func.value)
        if isinstance(call_func, ast.Name):
            f = self.funcs.get(call_func.id)
            if f is not None:
                return f
            dotted = self.aliases.get(call_func.id)
            if dotted and "." in dotted:
                modname, sym = dotted.rsplit(".", 1)
                return self._foreign(modname, sym)
            return None
        name = dotted_name(call_func)
        if name and "." in name:
            head, _, sym = name.rpartition(".")
            modname = self.resolve_dotted(head)
            return self._foreign(modname, sym)
        return None

    def _foreign(self, modname: str, sym: str) -> "_Func | None":
        u = self.project.by_modname(modname)
        if u is None:
            return None
        return _module_index(self.project, u).funcs.get(sym)


def _module_index(project: Project, unit: SourceUnit) -> _ModuleIndex:
    cache = project.__dict__.setdefault("_modindex_cache", {})
    if unit.rel not in cache:
        cache[unit.rel] = _ModuleIndex(unit, project)
    return cache[unit.rel]




# ---------------------------------------------------------------------------
# root discovery


@dataclass
class _Root:
    func: _Func
    statics: frozenset


def _is_const(node: ast.AST) -> bool:
    """A literal host value: a constant, or a tuple/list of them."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, (ast.Tuple, ast.List)):
        return all(_is_const(e) for e in node.elts)
    return False


def _annotated_statics(func: _Func) -> set[str]:
    """Parameters the signature says hold no tensor: an annotation that
    names none (int, bool, tuple, np.ndarray, ...), or no annotation and
    a constant default."""
    node = func.node
    a = node.args
    out: set[str] = set()
    positional = a.posonlyargs + a.args
    defaults = [None] * (len(positional) - len(a.defaults)) + list(
        a.defaults)
    pairs = list(zip(positional, defaults)) + list(
        zip(a.kwonlyargs, a.kw_defaults))
    for arg, default in pairs:
        ann = getattr(arg, "annotation", None)
        if ann is not None:
            if not any(w in ast.unparse(ann) for w in _TENSOR_ANNOTATIONS):
                out.add(arg.arg)
        elif default is not None and _is_const(default):
            out.add(arg.arg)
    return out


def _dispatch_root(node: ast.Call, idx: "_ModuleIndex", unit: SourceUnit,
                   package: str) -> "_Root | None":
    """The root of a `metrics.dispatch_jit(label, fn, *args, **kw)` call:
    fn, its parameters static where the signature or the call site's
    argument says they hold no tensor."""
    name = dotted_name(node.func)
    if name is None or len(node.args) < 2:
        return None
    resolved = idx.resolve_dotted(name)
    if resolved not in (f"{package}.utils.metrics.dispatch_jit",
                        "metrics.dispatch_jit", "dispatch_jit"):
        return None
    target = node.args[1]
    if isinstance(target, ast.Lambda):
        f = _Func(unit, target, f"<lambda@{target.lineno}>",
                  _params_of(target))
    else:
        f = idx.resolve_func(target)
    if f is None:
        return None
    statics = _annotated_statics(f)
    params = _positional_params(f.node)
    for i, arg in enumerate(node.args[2:]):
        if isinstance(arg, ast.Starred):
            break
        if i < len(params) and _is_const(arg):
            statics.add(params[i])
    for kw in node.keywords:
        if kw.arg is not None and _is_const(kw.value):
            statics.add(kw.arg)
    return _Root(f, frozenset(statics))


def _is_launch(func: "_Func | None", package: str) -> bool:
    return (func is not None and func.qualname == "launch"
            and func.unit.rel == f"{package}/engine/cuda_kernels.py")


def _enclosing_funcs(tree: ast.Module) -> dict[int, ast.AST]:
    """node-id -> nearest enclosing FunctionDef/Lambda."""
    out: dict[int, ast.AST] = {}

    def walk(node, enclosing):
        for child in ast.iter_child_nodes(node):
            out[id(child)] = enclosing
            walk(child, child if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
                else enclosing)

    walk(tree, None)
    return out


# ---------------------------------------------------------------------------
# tensor-value taint checking within one function


class _TaintChecker(ast.NodeVisitor):
    """Single-function walk: track which local names hold tensors, flag
    host-sync and tensor-branch hazards, and record call edges into other
    project functions with the static set each callee would see."""

    def __init__(self, func: _Func, statics: frozenset,
                 idx: _ModuleIndex, findings: set, edges: list,
                 _depth: int = 0):
        self.func = func
        self.idx = idx
        self.findings = findings
        self.edges = edges
        self.depth = _depth
        self.returns_traced = False
        params = set(_params_of(func.node))
        self.traced: set[str] = {p for p in params
                                 if p not in statics and p != "self"}

    # -- findings -----------------------------------------------------------

    def _flag(self, rule: str, node: ast.AST, message: str,
              severity: str = "error") -> None:
        self.findings.add(Finding(
            rule=rule, path=self.func.unit.rel,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0),
            severity=severity, message=message))

    # -- tensor-ness --------------------------------------------------------

    def _torch_call(self, node: ast.Call) -> str | None:
        """The resolved `torch.*` name of a call, or None."""
        name = dotted_name(node.func)
        if name is None:
            return None
        resolved = self.idx.resolve_dotted(name)
        return resolved if resolved.startswith("torch.") else None

    def _is_traced(self, node: ast.AST) -> bool:
        """Conservative: an expression holds a tensor if a tensor feeds it
        through tensor-producing operations. Shape, dtype and device
        reads, the size methods, len() and identity tests are host
        values."""
        if isinstance(node, ast.Name):
            return node.id in self.traced
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return False
            return self._is_traced(node.value)
        if isinstance(node, ast.Subscript):
            return self._is_traced(node.value) or self._is_traced(node.slice)
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Name) and fn.id in (
                    "len", "isinstance", "type", "id", "callable"):
                return False
            if isinstance(fn, ast.Name) and fn.id in _SCALAR_BUILTINS:
                return False        # a host value (flagged if a sync)
            if isinstance(fn, ast.Attribute) and (
                    fn.attr in _STATIC_METHODS
                    or fn.attr in _READBACK_METHODS):
                return False        # a host value (flagged if a sync)
            torch_name = self._torch_call(node)
            if torch_name is not None:
                return not torch_name.startswith(_STATIC_TORCH)
            name = dotted_name(fn)
            if name is not None and \
                    self.idx.resolve_dotted(name) in _READBACK_CALLS:
                return False
            parts = [fn] if not isinstance(fn, ast.Name) else []
            parts += list(node.args) + [kw.value for kw in node.keywords]
            if not any(self._is_traced(p) for p in parts):
                return False
            # a resolvable project callee may compute a host value from a
            # tensor (shape reads, cost models): consult its returns
            callee = self.idx.resolve_func(fn)
            if callee is not None and callee.key() != self.func.key() \
                    and self.depth < 4:
                statics = self._callee_statics(callee, node)
                return _returns_traced(self.idx, callee, statics,
                                       self.depth + 1)
            return True
        if isinstance(node, ast.BinOp):
            return self._is_traced(node.left) or self._is_traced(node.right)
        if isinstance(node, ast.UnaryOp):
            return self._is_traced(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self._is_traced(v) for v in node.values)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False        # identity: no value read
            return self._is_traced(node.left) or any(
                self._is_traced(c) for c in node.comparators)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any(self._is_traced(e) for e in node.elts)
        if isinstance(node, ast.Dict):
            return any(self._is_traced(v) for v in node.values
                       if v is not None)
        if isinstance(node, ast.IfExp):
            return any(self._is_traced(n)
                       for n in (node.test, node.body, node.orelse))
        if isinstance(node, ast.Starred):
            return self._is_traced(node.value)
        if isinstance(node, (ast.ListComp, ast.GeneratorExp, ast.SetComp,
                             ast.DictComp)):
            return self._comprehension_traced(node)
        return False

    def _comprehension_traced(self, node) -> bool:
        """A comprehension holds tensors when its element does, with each
        target bound as its iterable is."""
        saved = set(self.traced)
        try:
            for g in node.generators:
                self._bind_iter(g.target, g.iter)
            elts = [node.key, node.value] if isinstance(
                node, ast.DictComp) else [node.elt]
            return any(self._is_traced(e) for e in elts)
        finally:
            self.traced = saved

    def _bind_iter(self, target: ast.AST, it: ast.AST) -> None:
        """Bind a loop target to its iterable's elements. Over a literal
        sequence of equal-length tuples each target name takes its own
        column; otherwise the whole target is a tensor when the iterable
        is."""
        if isinstance(target, (ast.Tuple, ast.List)) \
                and isinstance(it, (ast.Tuple, ast.List)) and it.elts \
                and all(isinstance(r, (ast.Tuple, ast.List))
                        and len(r.elts) == len(target.elts)
                        for r in it.elts):
            for k, t in enumerate(target.elts):
                self._bind(t, any(self._is_traced(r.elts[k])
                                  for r in it.elts))
            return
        self._bind(target, self._is_traced(it))

    def _bind(self, target: ast.AST, traced: bool) -> None:
        if isinstance(target, ast.Name):
            (self.traced.add if traced else self.traced.discard)(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind(elt, traced)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, traced)

    # -- statements ---------------------------------------------------------

    def run(self) -> None:
        body = self.func.node.body
        if isinstance(body, list):
            # two passes: a loop may use a name bound traced further down
            for _ in range(2):
                for stmt in body:
                    self.visit(stmt)
        else:                       # Lambda: a single expression
            self.visit(body)

    def visit_Assign(self, node: ast.Assign) -> None:
        self.generic_visit(node)
        t = self._is_traced(node.value)
        for tgt in node.targets:
            self._bind(tgt, t)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self.visit(node.value)
            self._bind(node.target, self._is_traced(node.value))

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self.generic_visit(node)
        if self._is_traced(node.value):
            self._bind(node.target, True)

    def visit_For(self, node: ast.For) -> None:
        # iterating a tensor (or a list of them) yields views: no sync
        self._bind_iter(node.target, node.iter)
        self.generic_visit(node)

    def _check_branch(self, test: ast.AST, node: ast.AST, kind: str) -> None:
        if self._is_traced(test):
            self._flag("jit-tracer-branch", node,
                       f"python {kind} on a tensor value in "
                       f"{self.func.qualname}(); the condition reads the "
                       "tensor back to the host, an implicit sync (keep "
                       "it on the device with torch.where, or decide it "
                       "from host values)")

    def visit_If(self, node: ast.If) -> None:
        self._check_branch(node.test, node, "branch")
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        self._check_branch(node.test, node, "while-loop")
        self.generic_visit(node)

    def visit_IfExp(self, node: ast.IfExp) -> None:
        self._check_branch(node.test, node, "conditional expression")
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert) -> None:
        self._check_branch(node.test, node, "assert")
        self.generic_visit(node)

    def visit_With(self, node: ast.With) -> None:
        for item in node.items:
            if item.optional_vars is not None:
                self._bind(item.optional_vars,
                           self._is_traced(item.context_expr))
        self.generic_visit(node)

    def visit_comprehension(self, node: ast.comprehension) -> None:
        self._bind_iter(node.target, node.iter)
        self.generic_visit(node)

    def visit_Return(self, node: ast.Return) -> None:
        self.generic_visit(node)
        if node.value is not None and self._is_traced(node.value):
            self.returns_traced = True

    # nested defs get their own checker via call edges; don't walk into them
    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        pass

    def visit_AsyncFunctionDef(self, node) -> None:
        pass

    def visit_Lambda(self, node: ast.Lambda) -> None:
        pass

    # -- calls --------------------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        self.generic_visit(node)
        fn = self.func.qualname

        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr in _READBACK_METHODS \
                    and self._is_traced(node.func.value):
                self._flag("jit-host-sync", node,
                           f".{attr}() on a tensor in {fn}(): a device->"
                           "host readback inside code a dispatch reaches")
            elif attr == "synchronize":
                self._flag("jit-host-sync", node,
                           f".synchronize() in {fn}(): the host waits "
                           "for the card in dispatch-reachable code "
                           "(hoist it to the caller that owns the "
                           "readback)")

        # float()/int()/bool() on a tensor value
        if isinstance(node.func, ast.Name) \
                and node.func.id in _SCALAR_BUILTINS and node.args \
                and self._is_traced(node.args[0]):
            self._flag("jit-host-sync", node,
                       f"{node.func.id}() of a tensor value in {fn}(): "
                       "a host sync (keep it a tensor, or pass the host "
                       "value in)")

        # np.asarray / np.array of a tensor
        name = dotted_name(node.func)
        if name is not None:
            resolved = self.idx.resolve_dotted(name)
            if resolved in _READBACK_CALLS and node.args \
                    and self._is_traced(node.args[0]):
                self._flag("jit-host-sync", node,
                           f"{name}() of a tensor in {fn}(): a device->"
                           "host readback inside code a dispatch reaches")

        # edge into another project function
        callee = self.idx.resolve_func(node.func)
        if callee is not None and callee.key() != self.func.key():
            statics = self._callee_statics(callee, node)
            self.edges.append((callee, statics))

    def _callee_statics(self, callee: _Func, node: ast.Call) -> frozenset:
        a = callee.node.args
        params = _positional_params(callee.node)
        if params[:1] == ["self"]:
            params = params[1:]
        statics: set[str] = set(params) | {p.arg for p in a.kwonlyargs}
        seen: set[str] = set()
        star = False
        extra_traced = False
        for i, arg in enumerate(node.args):
            if isinstance(arg, ast.Starred):
                star = True
                extra_traced |= self._is_traced(arg)
                continue
            if i < len(params):
                seen.add(params[i])
                if self._is_traced(arg):
                    statics.discard(params[i])
            elif self._is_traced(arg):
                extra_traced = True
        for kw in node.keywords:
            if kw.arg is None:
                star = True
                extra_traced |= self._is_traced(kw.value)
                continue
            seen.add(kw.arg)
            if self._is_traced(kw.value):
                statics.discard(kw.arg)
        if star:
            # *args/**kwargs at the call site: anything not explicitly
            # bound may receive a tensor
            statics &= seen
        # a *args / **kwargs parameter holds a tensor only when an
        # argument it collects does
        for extra in (a.vararg, a.kwarg):
            if extra is not None and not extra_traced:
                statics.add(extra.arg)
        return frozenset(statics)


_returns_memo: dict[tuple, bool] = {}


def _returns_traced(idx: _ModuleIndex, func: _Func, statics: frozenset,
                    depth: int) -> bool:
    """Whether `func`, called with `statics` known to hold no tensor, can
    return a tensor. A throwaway checker run (findings discarded — the
    real worklist covers the callee with its own intersected statics);
    cycles and depth overruns conservatively answer True."""
    key = (func.key(), statics)
    if key in _returns_memo:
        return _returns_memo[key]
    _returns_memo[key] = True          # cycle guard: assume a tensor
    callee_idx = _module_index(idx.project, func.unit)
    chk = _TaintChecker(func, statics, callee_idx, set(), [], _depth=depth)
    try:
        chk.run()
    except RecursionError:
        return True
    if not isinstance(func.node.body, list):      # lambda: body IS the return
        chk.returns_traced = chk._is_traced(func.node.body)
    _returns_memo[key] = chk.returns_traced
    return chk.returns_traced


# ---------------------------------------------------------------------------
# the pass


class JitHygienePass:
    name = "jit-hygiene"

    #: literals owned by engine/pack.py
    _OWNED_LITERALS = {22528: "ROWS_VMEM_BUDGET"}

    def __init__(self, scope: tuple[str, ...] | None = None):
        self.scope = scope

    def run(self, project: Project) -> list[Finding]:
        _returns_memo.clear()
        package = project.package
        units = project.under(*(self.scope
                                or scope_of(package, *SCOPE_DIRS)))
        findings: set[Finding] = set()
        roots: list[_Root] = []
        build_cache = f"{package}/engine/cuda_kernels.py"

        for unit in units:
            idx = _module_index(project, unit)
            enclosing = _enclosing_funcs(unit.tree)
            launchers: set[tuple] = set()
            for node in ast.walk(unit.tree):
                if not isinstance(node, ast.Call):
                    continue
                root = _dispatch_root(node, idx, unit, package)
                if root is not None:
                    roots.append(root)
                host = enclosing.get(id(node))
                if host is None or isinstance(host, ast.Lambda):
                    continue
                if _is_launch(idx.resolve_func(node.func), package):
                    launchers.add(id(host))
                if unit.rel != build_cache:
                    self._check_build(unit, idx, node, host, findings)
            for f in idx.all_funcs.values():
                if id(f.node) in launchers:
                    roots.append(_Root(f, frozenset(_annotated_statics(f))))
            self._check_shape_drift(unit, package, findings)

        self._walk_roots(project, roots, findings)
        return sorted(findings,
                      key=lambda f: (f.path, f.line, f.col, f.rule))

    def _check_build(self, unit, idx, node: ast.Call, host,
                     findings: set) -> None:
        """jit-retrace: a build or compile inside a function body."""
        name = dotted_name(node.func)
        if name is None:
            return
        resolved = idx.resolve_dotted(name)
        head, _, tail = resolved.rpartition(".")
        is_build = resolved in _BUILD_CALLS or (
            tail in _BUILD_KERNEL_FUNCS and head.endswith("cuda_kernels"))
        if not is_build:
            return
        if resolved == "torch.compile" and self._wrapper_cached(host, node):
            return
        findings.add(Finding(
            rule="jit-retrace", path=unit.rel,
            line=node.lineno, col=node.col_offset, severity="error",
            message=(f"{name}(...) inside {host.name}(): a kernel build or "
                     "compile on the call path — builds belong in "
                     "engine/cuda_kernels.py's build cache (content-"
                     "hashed, once a process); hoist it there or to "
                     "module level")))

    @staticmethod
    def _wrapper_cached(host: ast.AST, call: ast.Call) -> bool:
        """True when the in-function wrapper is stored into a subscripted
        cache (`_CACHE[key] = fn`) — the memoized-builder idiom keeps the
        compiled function alive across calls."""
        assigned: set[str] = set()
        for a in ast.walk(host):
            if isinstance(a, ast.Assign) and a.value is call:
                assigned.update(t.id for t in a.targets
                                if isinstance(t, ast.Name))
        if not assigned:
            return False
        for a in ast.walk(host):
            if isinstance(a, ast.Assign) \
                    and isinstance(a.value, ast.Name) \
                    and a.value.id in assigned \
                    and any(isinstance(t, ast.Subscript)
                            for t in a.targets):
                return True
        return False

    # -- reachability fixpoint ----------------------------------------------

    def _walk_roots(self, project: Project, roots: list[_Root],
                    findings: set) -> None:
        best: dict[tuple, frozenset] = {}
        work: list[tuple[_Func, frozenset]] = []
        for r in roots:
            self._merge(best, work, r.func, r.statics)
        steps = 0
        while work and steps < 10000:
            steps += 1
            func, statics = work.pop()
            idx = _module_index(project, func.unit)
            edges: list = []
            _TaintChecker(func, statics, idx, findings, edges).run()
            for callee, callee_statics in edges:
                self._merge(best, work, callee, callee_statics)

    @staticmethod
    def _merge(best: dict, work: list, func: _Func,
               statics: frozenset) -> None:
        key = func.key()
        if key in best:
            merged = best[key] & statics
            if merged == best[key]:
                return
            best[key] = merged
            work.append((func, merged))
        else:
            best[key] = statics
            work.append((func, statics))

    # -- shape-literal drift -------------------------------------------------

    def _check_shape_drift(self, unit: SourceUnit, package: str,
                           findings: set) -> None:
        if unit.rel == f"{package}/engine/pack.py":
            return
        for node in ast.walk(unit.tree):
            # ((n + 127) // 128): open-coded lane padding
            if isinstance(node, ast.BinOp) \
                    and isinstance(node.op, ast.FloorDiv) \
                    and isinstance(node.right, ast.Constant) \
                    and node.right.value == 128 \
                    and isinstance(node.left, ast.BinOp) \
                    and isinstance(node.left.op, ast.Add) \
                    and isinstance(node.left.right, ast.Constant) \
                    and node.left.right.value == 127:
                findings.add(Finding(
                    rule="jit-shape-drift", path=unit.rel,
                    line=node.lineno, col=node.col_offset,
                    severity="warning",
                    message=("open-coded lane-pad arithmetic "
                             "((n + 127) // 128); use "
                             "engine.pack.pad_to_lanes/LANE so every "
                             "layer pads the docs axis identically")))
            elif isinstance(node, ast.Constant) \
                    and node.value in self._OWNED_LITERALS:
                findings.add(Finding(
                    rule="jit-shape-drift", path=unit.rel,
                    line=node.lineno, col=node.col_offset,
                    severity="warning",
                    message=(f"literal {node.value} duplicates "
                             f"engine.pack."
                             f"{self._OWNED_LITERALS[node.value]}; "
                             "import the constant")))
