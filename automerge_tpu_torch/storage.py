"""Columnar binary persistence.

The reference's save format is the transit-serialized full change history
(Automerge's src/automerge.js:223-226) — log-is-truth, replayed on load.
This module keeps that philosophy but stores the log in a columnar layout:
string-interned int32 arrays in a compressed npz container. Compared with the
JSON log (api.save/load) it is several times smaller and loads without
parsing per-op dicts; the column arrays are also one step from the engine's
wire batches.

Format (npz entries, version 1):
  meta            uint8 JSON blob: version + string tables
                  (actors, objects, keys, messages, values as JSON list)
  change_actor    int32[n_changes]   change_seq  int32[n_changes]
  change_msg      int32[n_changes]   (-1 = no message)
  deps_off        int32[n_changes+1] CSR offsets into deps_actor/deps_seq
  deps_actor      int32[]            deps_seq    int32[]
  op_off          int32[n_changes+1] CSR offsets into the op columns
  op_action       int8[]   op_obj int32[]  op_key int32[] (-1 = none)
  op_vkind        int8[]   0 = none, 1 = scalar value, 2 = link
  op_value        int32[]  scalar table index or link object index
  op_elem         int32[]  (-1 = none)

This is the port's copy of `automerge_tpu/storage.py`: the bytes it writes
are the reference's, and each package reads the other's. `load_binary`
takes `device=` as `api.load` does.
"""

from __future__ import annotations

import io
import json

import numpy as np

from .core.change import Change, Op

FORMAT_VERSION = 1
_ACTIONS = ("makeMap", "makeList", "makeText", "ins", "set", "del", "link",
            "move")
_ACTION_IDX = {a: i for i, a in enumerate(_ACTIONS)}


class _Interner:
    def __init__(self):
        self.items: list = []
        self.index: dict = {}

    def add(self, item) -> int:
        if item not in self.index:
            self.index[item] = len(self.items)
            self.items.append(item)
        return self.index[item]


def save_binary(doc) -> bytes:
    """Serialize a document's change history to the columnar npz format."""
    from .api import _check_target
    _check_target("save_binary", doc)
    history = list(doc._doc.opset.history)

    actors, objects, keys, messages = (_Interner() for _ in range(4))
    values: list = []
    value_index: dict = {}

    def value_id(v) -> int:
        key = (type(v).__name__, repr(v))
        if key not in value_index:
            value_index[key] = len(values)
            values.append(v)
        return value_index[key]

    n = len(history)
    change_actor = np.zeros(n, dtype=np.int32)
    change_seq = np.zeros(n, dtype=np.int32)
    change_msg = np.full(n, -1, dtype=np.int32)
    deps_off = np.zeros(n + 1, dtype=np.int32)
    op_off = np.zeros(n + 1, dtype=np.int32)
    deps_actor_l, deps_seq_l = [], []
    op_rows: list[tuple] = []

    for i, c in enumerate(history):
        change_actor[i] = actors.add(c.actor)
        change_seq[i] = c.seq
        if c.message is not None:
            change_msg[i] = messages.add(c.message)
        for a, s in sorted(c.deps.items()):
            deps_actor_l.append(actors.add(a))
            deps_seq_l.append(s)
        deps_off[i + 1] = len(deps_actor_l)
        for op in c.ops:
            key_id = keys.add(op.key) if op.key is not None else -1
            if op.action in ("set", "move"):
                # a move's value is the moved element/object id string;
                # the scalar table round-trips it exactly
                vkind, vid = 1, value_id(op.value)
            elif op.action == "link":
                vkind, vid = 2, objects.add(op.value)
            else:
                vkind, vid = 0, -1
            op_rows.append((_ACTION_IDX[op.action], objects.add(op.obj),
                            key_id, vkind, vid,
                            op.elem if op.elem is not None else -1))
        op_off[i + 1] = len(op_rows)

    ops = np.array(op_rows, dtype=np.int32).reshape(len(op_rows), 6)
    meta = json.dumps({
        "version": FORMAT_VERSION,
        "actors": actors.items, "objects": objects.items,
        "keys": keys.items, "messages": messages.items,
        "values": values,
    }).encode("utf-8")

    buf = io.BytesIO()
    np.savez_compressed(
        buf, meta=np.frombuffer(meta, dtype=np.uint8),
        change_actor=change_actor, change_seq=change_seq,
        change_msg=change_msg, deps_off=deps_off,
        deps_actor=np.array(deps_actor_l, dtype=np.int32),
        deps_seq=np.array(deps_seq_l, dtype=np.int32),
        op_off=op_off,
        op_action=ops[:, 0].astype(np.int8) if len(op_rows) else np.zeros(0, np.int8),
        op_obj=ops[:, 1] if len(op_rows) else np.zeros(0, np.int32),
        op_key=ops[:, 2] if len(op_rows) else np.zeros(0, np.int32),
        op_vkind=ops[:, 3].astype(np.int8) if len(op_rows) else np.zeros(0, np.int8),
        op_value=ops[:, 4] if len(op_rows) else np.zeros(0, np.int32),
        op_elem=ops[:, 5] if len(op_rows) else np.zeros(0, np.int32),
    )
    return buf.getvalue()


def changes_from_binary(data: bytes) -> list[Change]:
    """Decode a columnar save back into Change records."""
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode("utf-8"))
        if meta["version"] > FORMAT_VERSION:
            raise ValueError(
                f"Cannot load columnar save format version {meta['version']}; "
                f"this build supports up to {FORMAT_VERSION}")
        actors, objects = meta["actors"], meta["objects"]
        keys, messages, values = meta["keys"], meta["messages"], meta["values"]

        out: list[Change] = []
        n = len(z["change_actor"])
        for i in range(n):
            deps = {actors[a]: int(s) for a, s in
                    zip(z["deps_actor"][z["deps_off"][i]:z["deps_off"][i + 1]],
                        z["deps_seq"][z["deps_off"][i]:z["deps_off"][i + 1]])}
            ops = []
            for j in range(int(z["op_off"][i]), int(z["op_off"][i + 1])):
                action = _ACTIONS[z["op_action"][j]]
                key_id = int(z["op_key"][j])
                vkind = int(z["op_vkind"][j])
                if vkind == 1:
                    value = values[int(z["op_value"][j])]
                elif vkind == 2:
                    value = objects[int(z["op_value"][j])]
                else:
                    value = None
                elem = int(z["op_elem"][j])
                ops.append(Op(action, objects[int(z["op_obj"][j])],
                              key=None if key_id < 0 else keys[key_id],
                              value=value,
                              elem=None if elem < 0 else elem))
            msg_id = int(z["change_msg"][i])
            out.append(Change(actors[int(z["change_actor"][i])],
                              int(z["change_seq"][i]), deps, ops,
                              None if msg_id < 0 else messages[msg_id]))
        return out


def load_binary(data: bytes, actor_id: str | None = None, device="cuda"):
    """Rebuild a document on `device` from a columnar save by replaying the
    log."""
    from . import api
    from .frontend.materialize import apply_changes_to_doc
    doc = api.init(actor_id, device)
    return apply_changes_to_doc(doc, doc._doc.opset,
                                changes_from_binary(data),
                                incremental=False, emit_diffs=False)
