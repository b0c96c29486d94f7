"""Run the reference's own test cases on both packages and hold the port's
documents to the reference's.

A reference test module (`tests/test_sequential.py`, ...) is written against
`automerge_tpu`. `collect` turns each of its tests (each parametrized case
expanded, fixtures resolved here) into a case that `run_twin` runs twice:
once with the module's globals as they are, once with every name that
points into `automerge_tpu` rebound to its counterpart in
`automerge_tpu_torch` (entry points on `device="cpu"`). Both runs start
from the same deterministic uuid factory, so the same actor and object ids
come out, and both record every document root that an API call returns.
The test's own assertions must hold on the port; then the two runs'
documents are compared pair by pair:

- `save()` text equal, equal states (`state_of`, and `oracle_state`
  where the root is a map);
- for the last two distinct histories: `save_binary` bytes equal, each
  package loading the other's `save()` and `save_binary()` output to the
  same state, and the history replayed change by change through
  `OpSet.add_changes` giving equal diff records.

A test that makes more than MAX_RECORDS documents has them sampled.
"""

from __future__ import annotations

import builtins
import functools
import importlib
import inspect
import itertools
import tempfile
import types
from pathlib import Path


import automerge_tpu as ref_am
from automerge_tpu import api as ref_api
from automerge_tpu import storage as ref_storage
from automerge_tpu.core.opset import OpSet as RefOpSet
from automerge_tpu.engine.batchdoc import oracle_state as ref_oracle_state
from automerge_tpu.utils import uuid as ref_uuid

from automerge_tpu_torch import api as port_api
from automerge_tpu_torch import storage as port_storage
from automerge_tpu_torch.core.opset import OpSet as PortOpSet
from automerge_tpu_torch.engine.batchdoc import (
    oracle_state as port_oracle_state)
from automerge_tpu_torch.utils import uuid as port_uuid

# API calls whose result is a document root (recorded on both runs)
DOC_CALLS = ("init", "init_immutable", "change", "empty_change", "merge",
             "load", "load_immutable", "apply_changes", "undo", "redo",
             "load_binary")
# The package surface `import automerge_tpu as am` gives a test. Left out
# of the port's: Connection, flightrec and save_transit / load_transit
# (not ported yet); a case that reaches them is not collected.
SURFACE = ("init", "init_immutable", "change", "empty_change", "merge",
           "diff", "assign", "load", "load_immutable", "save", "equals",
           "inspect", "get_history", "get_conflicts", "get_changes",
           "get_changes_for_actor", "apply_changes", "get_missing_changes",
           "get_missing_deps", "get_clock", "get_actor_id", "can_undo",
           "undo", "can_redo", "redo", "changes_from_json", "begin",
           "Transaction", "SAVE_FORMAT_VERSION")


def counter_factory(prefix: str):
    state = {"n": 0}

    def factory():
        state["n"] += 1
        return f"{prefix}{state['n']:08d}"
    return factory


def plain(value):
    """A document value as plain Python: maps (frozen, immutable views)
    as dicts, lists and tuples as lists, a Text as its string. Neither
    package's `oracle_state` is used here: the reference's keeps a
    non-dict root (an immutable view) as the object itself."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if type(value).__name__ == "Text":
        return ("text", str(value))
    if hasattr(value, "keys") and hasattr(value, "__getitem__"):
        return {k: plain(value[k]) for k in value.keys()}
    if isinstance(value, (list, tuple)) or hasattr(value, "__len__"):
        return [plain(v) for v in value]
    return ("other", repr(value))


def state_of(doc) -> dict:
    """{data, conflicts} of a document root, as plain Python."""
    return {"data": plain(doc), "conflicts": plain(doc._conflicts)}


def is_root(doc) -> bool:
    return getattr(doc, "_doc", None) is not None \
        and getattr(doc, "_object_id", None) == ref_api.ROOT_ID


# ---------------------------------------------------------------------------
# the two package surfaces


class _Uuid:
    """`am.uuid` of the port: make_uuid with set_factory / reset."""

    def __call__(self):
        return port_uuid.make_uuid()

    @staticmethod
    def set_factory(factory):
        port_uuid.set_factory(factory)

    @staticmethod
    def reset():
        port_uuid.reset()


def _cpu(obj):
    """obj with device="cpu" unless the caller names a device: functions
    of the port whose `device` defaults to the card, classes whose
    constructor or static `init` does."""
    def on_card(fn) -> bool:
        try:
            p = inspect.signature(fn).parameters.get("device")
        except (TypeError, ValueError):
            return False
        return p is not None and p.default == "cuda"

    if isinstance(obj, type):
        ns = {}
        if on_card(obj.__init__):
            def __init__(self, *a, device="cpu", **k):
                obj.__init__(self, *a, device=device, **k)
            ns["__init__"] = __init__
        init = obj.__dict__.get("init")
        if isinstance(init, staticmethod) and on_card(init.__func__):
            ns["init"] = staticmethod(functools.partial(init.__func__,
                                                        device="cpu"))
        if not ns:
            return obj
        on_cpu = type(obj.__name__, (obj,), ns)
        on_cpu.__qualname__ = obj.__qualname__
        return on_cpu
    if not callable(obj) or not on_card(obj):
        return obj

    @functools.wraps(obj)
    def on_cpu(*a, **k):
        k.setdefault("device", "cpu")
        return obj(*a, **k)
    return on_cpu


def _recording(fn, records: list):
    @functools.wraps(fn)
    def call(*a, **k):
        out = fn(*a, **k)
        if is_root(out):
            records.append(out)
        return out
    return call


def facade(side: str, records: list) -> types.ModuleType:
    """The `am` package surface of one side, recording every document
    root its calls return into `records`."""
    m = types.ModuleType("automerge_tpu")
    if side == "ref":
        for name in SURFACE:
            setattr(m, name, getattr(ref_api, name))
        for name in ("save_binary", "load_binary", "changes_from_binary"):
            setattr(m, name, getattr(ref_storage, name))
        for name in ("Change", "Op", "ROOT_ID", "Text", "DocSet",
                     "WatchableDoc", "uuid", "metrics", "__version__"):
            setattr(m, name, getattr(ref_am, name))
    else:
        from automerge_tpu_torch import __version__
        from automerge_tpu_torch.core.change import Change, Op
        from automerge_tpu_torch.core.ids import ROOT_ID
        from automerge_tpu_torch.frontend.text import Text
        from automerge_tpu_torch.sync.docset import DocSet
        from automerge_tpu_torch.sync.watchable import WatchableDoc
        from automerge_tpu_torch.utils import metrics
        for name in SURFACE:
            setattr(m, name, _cpu(getattr(port_api, name)))
        for name in ("save_binary", "load_binary", "changes_from_binary"):
            setattr(m, name, _cpu(getattr(port_storage, name)))
        m.Change, m.Op, m.ROOT_ID, m.Text = Change, Op, ROOT_ID, Text
        m.DocSet, m.WatchableDoc = _cpu(DocSet), WatchableDoc
        m.uuid, m.metrics, m.__version__ = _Uuid(), metrics, __version__
    for name in DOC_CALLS:
        setattr(m, name, _recording(getattr(m, name), records))
    return m


def _surface_origins() -> dict:
    """id(reference object) -> its name on the facade, for every facade
    entry that a test can also import from its reference module."""
    out = {}
    for name in SURFACE:
        out[id(getattr(ref_api, name))] = name
    for name in ("save_binary", "load_binary", "changes_from_binary"):
        out[id(getattr(ref_storage, name))] = name
    for name in ("Change", "Op", "Text", "DocSet", "WatchableDoc"):
        out[id(getattr(ref_am, name))] = name
    return out


_SURFACE_ORIGINS = _surface_origins()


# ---------------------------------------------------------------------------
# rebinding a reference test module's globals


class _Unported:
    """Stands for a reference module or name the port does not have; any
    use fails the case loudly."""

    def __init__(self, what):
        self._what = what

    def __getattr__(self, name):
        raise AttributeError(f"{self._what} is not ported ({name})")

    def __call__(self, *a, **k):
        raise AttributeError(f"{self._what} is not ported")


def _port_module(name: str):
    try:
        return importlib.import_module(
            "automerge_tpu_torch" + name[len("automerge_tpu"):])
    except ImportError:
        return _Unported(name)


def _is_ref(modname) -> bool:
    return isinstance(modname, str) and (
        modname == "automerge_tpu" or modname.startswith("automerge_tpu."))


class _ModView:
    """What an `import` of a reference module inside a rebound function
    sees: each attribute passed through the Rebinder (so on the port side
    a reference name is the port's)."""

    def __init__(self, rb: "Rebinder", module):
        self._rb = rb
        self._module = module

    def __getattr__(self, name):
        return self._rb.value(name, getattr(self._module, name))


class Rebinder:
    """The globals of reference test modules (and of the test helpers they
    import) for one side: `am` is that side's recording facade, and on
    the port side every other name into `automerge_tpu` is the port's.
    Imports of `automerge_tpu` inside a test's body go through the same
    mapping (the rebound globals carry their own `__import__`)."""

    def __init__(self, side: str, am: types.ModuleType):
        self.side = side
        self.am = am
        self._globals: dict[str, dict] = {}
        self._builtins = dict(vars(builtins), __import__=self._import)

    def _import(self, name, globals=None, locals=None, fromlist=(),
                level=0):
        mod = builtins.__import__(name, globals, locals, fromlist, level)
        if level or not _is_ref(name):
            return mod
        if not fromlist:
            if name == "automerge_tpu":
                return self.am
            if self.side == "port":
                _port_module(name)
            return _ModView(self, ref_am)
        return _ModView(self, mod)

    def value(self, name, val):
        if val is ref_am or val is ref_api:
            return self.am
        if _SURFACE_ORIGINS.get(id(val)) is not None:
            return getattr(self.am, _SURFACE_ORIGINS[id(val)])
        if isinstance(val, types.FunctionType) \
                and _is_test_module(val.__module__) \
                and val.__globals__.get("__name__") == val.__module__:
            return self.function(val)
        if self.side == "ref":
            return val
        if isinstance(val, types.ModuleType):
            return _port_module(val.__name__) if _is_ref(val.__name__) \
                else val
        mod = getattr(val, "__module__", None)
        if _is_ref(mod) and not isinstance(val, (str, int, float)):
            if hasattr(self.am, name):
                return getattr(self.am, name)
            target = _port_module(mod)
            obj = getattr(target, getattr(val, "__name__", name), None)
            return _Unported(f"{mod}.{name}") if obj is None else _cpu(obj)
        return val

    def module_globals(self, g: dict) -> dict:
        key = g["__name__"]
        out = self._globals.get(key)
        if out is None:
            out = self._globals[key] = dict(g)
            out["__builtins__"] = self._builtins
            for name, val in g.items():
                if not name.startswith("__"):
                    out[name] = self.value(name, val)
        return out

    def function(self, fn):
        g = self.module_globals(fn.__globals__)
        new = types.FunctionType(fn.__code__, g, fn.__name__,
                                 fn.__defaults__, fn.__closure__)
        new.__kwdefaults__ = fn.__kwdefaults__
        return new

    def klass(self, cls):
        ns = {k: (self.function(v) if isinstance(v, types.FunctionType)
                  else v)
              for k, v in cls.__dict__.items()
              if k not in ("__dict__", "__weakref__")}
        return type(cls.__name__, (object,), ns)


_TEST_MODULES: set = {"helpers"}


def _is_test_module(name: str) -> bool:
    return name in _TEST_MODULES


# ---------------------------------------------------------------------------
# collection


class Case:
    """One reference test case: module, class (or None), function name and
    its parametrized arguments."""

    def __init__(self, module, cls, name, params, fixtures, fn=None):
        self.module = module
        self.cls = cls
        self.name = name
        self.params = params
        self.fixtures = fixtures
        self.fn = fn          # a function of the module to call instead

    @property
    def id(self) -> str:
        parts = [self.module.__name__]
        if self.cls is not None:
            parts.append(self.cls.__name__)
        parts.append(self.name)
        out = "::".join(parts)
        if self.params:
            out += "[" + "-".join(
                str(v) if isinstance(v, (int, str, float, bool))
                and len(str(v)) <= 24 else f"p{i}"
                for i, v in enumerate(self.params.values())) + "]"
        return out

    def __repr__(self):
        return self.id


def _marks(obj):
    return list(getattr(obj, "pytestmark", []))


def _expand(marks) -> list[dict]:
    combos = [{}]
    for mark in marks:
        if mark.name != "parametrize":
            continue
        names, values = mark.args[0], mark.args[1]
        if isinstance(names, str):
            names = [n.strip() for n in names.split(",")]
        rows = []
        for v in values:
            if hasattr(v, "values") and hasattr(v, "marks"):
                if any(m.name in ("skip", "skipif", "xfail")
                       for m in v.marks):
                    continue
                v = v.values
                if len(names) == 1:
                    v = v[0]
            rows.append(dict(zip(names, v if len(names) > 1 else [v])))
        combos = [dict(a, **b) for a, b in itertools.product(combos, rows)]
    return combos


def collect(module_name: str, exclude: dict[str, str] = ()) -> list[Case]:
    """Every test case of the reference module `module_name`, parametrize
    expanded; `exclude` maps a test name (`Class::name` or `name`) to why
    it is not run here. Hypothesis tests and `slow` tests are never
    collected."""
    module = importlib.import_module(module_name)
    _TEST_MODULES.add(module.__name__)
    cases: list[Case] = []
    exclude = dict(exclude)
    used = set()

    def add(cls, name, fn):
        key = f"{cls.__name__}::{name}" if cls is not None else name
        if key in exclude:
            used.add(key)
            return
        if getattr(fn, "is_hypothesis_test", False) \
                or hasattr(fn, "hypothesis"):
            return
        marks = _marks(fn) + (_marks(cls) if cls is not None else [])
        if any(m.name in ("slow", "skip", "skipif", "xfail", "cuda")
               for m in marks):
            return
        params = inspect.signature(fn).parameters
        for combo in _expand(marks):
            fixtures = [p for p in params if p != "self" and p not in combo]
            cases.append(Case(module, cls, name, combo, fixtures))

    for name, val in vars(module).items():
        if name.startswith("test") and isinstance(val, types.FunctionType):
            add(None, name, val)
        elif name.startswith("Test") and isinstance(val, type):
            for mname, mval in vars(val).items():
                if mname.startswith("test") \
                        and isinstance(mval, types.FunctionType):
                    add(val, mname, mval)
    missing = set(exclude) - used
    assert not missing, f"excluded names not in {module_name}: {missing}"
    return cases


# ---------------------------------------------------------------------------
# running a case on both sides


def _fixture_function(module, name):
    fx = getattr(module, name, None)
    if fx is None or not hasattr(fx, "_get_wrapped_function"):
        return None
    return fx._get_wrapped_function()


def _autouse(module):
    out = []
    for name, val in vars(module).items():
        marker = getattr(val, "_fixture_function_marker", None)
        if marker is not None and marker.autouse:
            out.append(name)
    return out


def _run_side(case: Case, side: str, given: dict) -> list:
    records: list = []
    am = facade(side, records)
    rb = Rebinder(side, am)
    factory = counter_factory("00000000-twin-")
    ref_uuid.set_factory(factory) if side == "ref" else \
        port_uuid.set_factory(factory)
    finalizers = []
    values: dict = {}

    def resolve(name):
        if name in values:
            return values[name]
        if name in given:
            values[name] = given[name]
            return values[name]
        raw = _fixture_function(case.module, name)
        if raw is None:
            raise LookupError(f"fixture {name!r} of {case.id}")
        fn = rb.function(raw)
        args = {p: resolve(p)
                for p in inspect.signature(raw).parameters}
        out = fn(**args)
        if inspect.isgenerator(out):
            gen = out
            out = next(gen)
            finalizers.append(gen)
        values[name] = out
        return out

    try:
        for name in _autouse(case.module):
            resolve(name)
        args = {f: resolve(f) for f in case.fixtures}
        args.update(case.params)
        if case.cls is None:
            fn = case.fn or getattr(case.module, case.name)
            rb.function(fn)(**args)
        else:
            inst = rb.klass(case.cls)()
            getattr(inst, case.name)(**args)
    finally:
        for gen in reversed(finalizers):
            with_stop = True
            try:
                next(gen)
            except StopIteration:
                with_stop = False
            assert not with_stop, "fixture yielded twice"
        ref_uuid.reset()
        port_uuid.reset()
    return records


def run_twin(case: Case, tmp_path, monkeypatch) -> None:
    """Run `case` on the reference, then on the port, and hold the port's
    recorded documents to the reference's."""
    dirs = {}
    for side in ("ref", "port"):
        dirs[side] = Path(tempfile.mkdtemp(prefix=side, dir=tmp_path))
    ref_docs = _run_side(case, "ref", {"tmp_path": dirs["ref"],
                                       "monkeypatch": monkeypatch})
    monkeypatch.undo()
    port_docs = _run_side(case, "port", {"tmp_path": dirs["port"],
                                         "monkeypatch": monkeypatch})
    monkeypatch.undo()
    hold_docs(ref_docs, port_docs)


def helper_case(module_name: str, fn, params: dict,
                fixtures=()) -> Case:
    """A case that calls `fn` (a function of the reference test module
    `module_name`, e.g. a hypothesis test's inner body or a module
    helper) with `params`."""
    module = importlib.import_module(module_name)
    _TEST_MODULES.add(module.__name__)
    return Case(module, None, fn.__name__, params, list(fixtures), fn)


def _binary_pair(r, p) -> None:
    """save_binary bytes equal. The npz container stamps each member with
    the wall clock's DOS time (two-second steps), so the port's bytes
    are held to the reference's from just before or just after."""
    before = ref_storage.save_binary(r)
    got = port_storage.save_binary(p)
    after = ref_storage.save_binary(r)
    assert got in (before, after)


def replay_diffs(opset_cls, history, **init) -> list:
    opset = opset_cls.init(**init)
    out = []
    for change in history:
        opset, diffs = opset.add_changes([change])
        out.append(diffs)
    return out


#: records compared one by one; past this many a test's records are
#: sampled (the first and last 16, the rest evenly)
MAX_RECORDS = 64
#: histories longer than this skip the change-by-change diff replay
MAX_REPLAY_CHANGES = 1500


def _sample(n: int) -> list[int]:
    if n <= MAX_RECORDS:
        return list(range(n))
    mid = range(16, n - 16, max(1, (n - 32) // (MAX_RECORDS - 32)))
    return sorted(set(range(16)) | set(mid) | set(range(n - 16, n)))


def hold_docs(ref_docs: list, port_docs: list) -> None:
    """Hold the port's recorded documents to the reference's, pair by
    pair: `save()` text and states; for the last two distinct histories
    also `save_binary` bytes, loads across the packages, and (up to
    MAX_REPLAY_CHANGES changes) the diff records of a change-by-change
    replay."""
    assert len(port_docs) == len(ref_docs)
    distinct: dict = {}
    for i in _sample(len(ref_docs)):
        r, p = ref_docs[i], port_docs[i]
        text = ref_api.save(r)
        assert port_api.save(p) == text
        state = state_of(r)
        assert state_of(p) == state
        if isinstance(r, dict):
            assert port_oracle_state(p) == ref_oracle_state(r)
        distinct.pop(text, None)
        distinct[text] = (r, p, state)
    for text, (r, p, state) in list(distinct.items())[-2:]:
        _binary_pair(r, p)
        assert state_of(port_api.load(text, "x", device="cpu")) == state
        assert state_of(ref_api.load(port_api.save(p), "x")) == state
        pb = port_storage.save_binary(p)
        assert state_of(ref_storage.load_binary(pb, "x")) == state
        rb = ref_storage.save_binary(r)
        assert state_of(
            port_storage.load_binary(rb, "x", device="cpu")) == state
        history = list(r._doc.opset.history)
        if len(history) <= MAX_REPLAY_CHANGES:
            assert replay_diffs(PortOpSet, list(p._doc.opset.history),
                                device="cpu") \
                == replay_diffs(RefOpSet, history)
