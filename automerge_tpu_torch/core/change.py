"""Operation and change records — the wire-level "ISA" of the CRDT.

The operation vocabulary matches the reference exactly
(Automerge's INTERNALS.md:117-194): `makeMap`, `makeList`, `makeText`,
`ins {obj, key: prevElemId|'_head', elem}`, `set {obj, key, value}`,
`link {obj, key, value: objectId}`, `del {obj, key}`.

A change is `{actor, seq, deps, message?, ops[]}` (INTERNALS.md:104-115, built
at Automerge's src/auto_api.js:28-33). `deps` is the pruned dependency
frontier, not a full vector clock; full clocks are reconstructed via
`transitive_deps` (src/op_set.js:29-37).

Ops inside a change carry no actor/seq; they are stamped with the change's
(actor, seq) at application time (src/op_set.js:239). Ops stored in per-field
state *do* carry their stamp, which is what concurrency detection keys on.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping

MAKE_ACTIONS = ("makeMap", "makeList", "makeText")
ASSIGN_ACTIONS = ("set", "del", "link")
# `move` (r16) reparents a map child object or repositions a list element
# as ONE op: {obj: destination container, key: dest key (map) / dest anchor
# elemId or '_head' (list), value: moved object id (map) / moved elemId
# (list), elem: dest sibling-order counter (list moves only)}. Concurrent
# moves of one element resolve by priority; cycles resolve deterministically
# (core/moves.py). The reference has no equivalent — a reparent there is a
# delete + re-insert of the whole subtree.
ALL_ACTIONS = MAKE_ACTIONS + ("ins",) + ASSIGN_ACTIONS + ("move",)


class Op:
    __slots__ = ("action", "obj", "key", "value", "elem", "actor", "seq")

    def __init__(self, action: str, obj: str, key: str | None = None,
                 value: Any = None, elem: int | None = None,
                 actor: str | None = None, seq: int | None = None):
        self.action = action
        self.obj = obj
        self.key = key
        self.value = value
        self.elem = elem
        self.actor = actor
        self.seq = seq

    def stamped(self, actor: str, seq: int | None) -> "Op":
        """Copy of this op carrying the applying change's (actor, seq)."""
        return Op(self.action, self.obj, self.key, self.value, self.elem, actor, seq)

    def stripped(self) -> "Op":
        """Copy without actor/seq — the form stored in undo histories
        (Automerge's src/automerge.js:14, auto_api.js:89)."""
        if self.actor is None and self.seq is None:
            return self
        return Op(self.action, self.obj, self.key, self.value, self.elem)

    def _key_tuple(self):
        value = self.value
        if isinstance(value, (dict, list)):  # unhashable payloads: compare by repr
            value = repr(value)
        return (self.action, self.obj, self.key, value, self.elem, self.actor, self.seq)

    def __eq__(self, other):
        if not isinstance(other, Op):
            return NotImplemented
        return (self.action == other.action and self.obj == other.obj
                and self.key == other.key and self.value == other.value
                and self.elem == other.elem and self.actor == other.actor
                and self.seq == other.seq)

    def __hash__(self):
        return hash(self._key_tuple())

    def __repr__(self):
        parts = [f"action={self.action!r}", f"obj={self.obj!r}"]
        for name in ("key", "value", "elem", "actor", "seq"):
            val = getattr(self, name)
            if val is not None:
                parts.append(f"{name}={val!r}")
        return f"Op({', '.join(parts)})"

    def to_dict(self) -> dict:
        out: dict[str, Any] = {"action": self.action, "obj": self.obj}
        if self.key is not None:
            out["key"] = self.key
        if self.action in ("set", "link", "move"):
            out["value"] = self.value
        if self.elem is not None:
            out["elem"] = self.elem
        return out

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "Op":
        return Op(d["action"], d["obj"], d.get("key"), d.get("value"), d.get("elem"))


class Change:
    __slots__ = ("actor", "seq", "deps", "message", "ops")

    def __init__(self, actor: str, seq: int, deps: Mapping[str, int],
                 ops: Iterable[Op], message: str | None = None):
        self.actor = actor
        self.seq = seq
        self.deps = dict(deps)
        self.message = message
        self.ops = tuple(ops)

    def __eq__(self, other):
        if not isinstance(other, Change):
            return NotImplemented
        return (self.actor == other.actor and self.seq == other.seq
                and self.deps == other.deps and self.message == other.message
                and self.ops == other.ops)

    def __hash__(self):
        return hash((self.actor, self.seq, tuple(sorted(self.deps.items())),
                     self.message, self.ops))

    def __repr__(self):
        return (f"Change(actor={self.actor!r}, seq={self.seq}, deps={self.deps!r}, "
                f"message={self.message!r}, ops={list(self.ops)!r})")

    def to_dict(self) -> dict:
        out: dict[str, Any] = {
            "actor": self.actor,
            "seq": self.seq,
            "deps": dict(self.deps),
            "ops": [op.to_dict() for op in self.ops],
        }
        if self.message is not None:
            out["message"] = self.message
        return out

    @staticmethod
    def from_dict(d: Mapping[str, Any]) -> "Change":
        return Change(d["actor"], d["seq"], d.get("deps", {}),
                      [Op.from_dict(o) for o in d.get("ops", [])],
                      d.get("message"))


def coerce_change(c) -> Change:
    """Accept either a Change or a plain dict (the JSON wire form)."""
    if isinstance(c, Change):
        return c
    return Change.from_dict(c)
