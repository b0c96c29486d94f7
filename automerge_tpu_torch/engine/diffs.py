"""Engine-side diff emission and the mirror it feeds (counterpart of
`automerge_tpu/engine/diffs.py`): `decode_round_diffs` turns one diff
round's changed entries into reference-shaped edit records
(op_set.js:105-176), and `MirrorDoc` folds them into a materialized view.

The device side is `resident.ResidentDocSet.apply_and_reconcile(...,
diffs=True)`: `_scatter_apply_diff` compares the round's converged state
with the baseline the diff consumer last saw and returns per-field and
per-element change masks. The readback differs from the reference's, the
records do not: the engine finds the changed documents on the device,
gathers only their rows (this round's outputs and state, the masks, and
the baseline's visibility and ranks, whose ranks give removed elements
their old index) and copies them to the host in one transfer
(`resident._changed_rows`). The reference reads the whole fleet's outputs
back every diff round and keeps host copies of visibility and ranks as
the next baseline; here the baseline stays on the device only.

Record shapes (the reference's, README.md:487-520):
  {"action": "create", "type": "map"|"list"|"text", "obj": id}
  {"action": "set",    "type": "map", "obj", "key", "value",
                       ["link": True], ["conflicts": [{actor, value,
                       [link]}]]}
  {"action": "remove", "type": "map", "obj", "key"}
  {"action": "insert"|"set"|"remove", "type": "list"|"text", "obj",
                       "index", ["value", ...]}
  {"action": "move", "type": "list"|"text", "obj": list_id,
   "elem": moved_elem_id, "anchor": dest_anchor_eid, "counter": n}

A map move emits a `remove` at the child's previous location and a
`set {link: True}` at its destination; a link record for a child whose
move-resolved location is elsewhere is suppressed (the single-location
rule). A list move emits the explicit `move` record, which MirrorDoc
ignores: the engine's element ranks are move-agnostic. These are BATCH
diffs: per list, removes in descending old index, then inserts in
ascending new index, then sets. Conflicts list the losers in
actor-descending order.

Not here yet: `PerOpDiffStream`, the op-granular stream, which folds each
admitted batch through an interpretive shadow OpSet; it comes with the
port of `api.init`, the OpSet and the `EngineDocSet` service.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from .encode import A_MAKE_LIST, A_MAKE_TEXT, LOC_KEY_PREFIX

# The per-document rows decode_round_diffs reads, each [k, ...] for the k
# changed documents: this round's outputs and state, the change masks, and
# the baseline's element visibility and ranks.
DIFF_ROWS = ("present", "win_value", "win_actor", "chg_fid", "candidate",
             "fid", "actor", "value", "elem_visible", "vis_rank", "ins_fid",
             "chg_elem", "prev_vis", "prev_rank", "list_obj")


def _decode_value(t, value_id: int):
    """(value, is_link) from a doc's arrival-ordered value table."""
    raw = t.value_list[value_id]
    if isinstance(raw, tuple) and len(raw) == 2 and raw[0] == "__link__":
        return raw[1], True
    return raw, False


def decode_round_diffs(rset, docs: np.ndarray, rows: dict) -> dict:
    """{doc_id: [edit records]} for the documents the device flagged.

    rset: the ResidentDocSet right after a diff dispatch. docs: the changed
    documents' indices, ascending. rows: {name: array} for every name of
    DIFF_ROWS, row j belonging to document docs[j]."""
    announced = rset._diff_announced
    homes_all = rset._diff_move_homes
    diffs: dict[str, list] = {}
    for j, i in enumerate(docs.tolist()):
        records = _doc_records(rset, i, {k: v[j] for k, v in rows.items()},
                               announced, homes_all.setdefault(i, {}))
        if records:
            diffs[rset.doc_ids[i]] = records
    return diffs


def _doc_records(rset, i: int, r: dict, announced: dict,
                 homes: dict) -> list[dict]:
    """One document's records, from its rows `r` (decode_round_diffs)."""
    t = rset.tables[i]
    present, win_value, win_actor = r["present"], r["win_value"], \
        r["win_actor"]
    chg_fid, chg_elem = r["chg_fid"], r["chg_elem"]
    candidate, st_fid = r["candidate"], r["fid"]
    st_actor, st_value = r["actor"], r["value"]
    kind_of = {oi: kind for oi, (_oid, kind) in enumerate(t.objects)}
    oid_of = {oi: oid for oi, (oid, _k) in enumerate(t.objects)}
    seq_objs = {oi for oi, k in kind_of.items()
                if k in (A_MAKE_LIST, A_MAKE_TEXT)}
    records: list[dict] = []
    # current resolved location per move-managed MAP child (the winning
    # location-field survivor): a link record for a child that now lives
    # elsewhere must not also present it at the link's field
    moved_to: dict[str, tuple] = {}
    for f2, (_oi2, k2) in enumerate(t.fields):
        if not k2.startswith(LOC_KEY_PREFIX):
            continue
        if f2 >= len(present) or not present[f2]:
            continue
        v2, _ = _decode_value(t, int(win_value[f2]))
        if (isinstance(v2, tuple) and len(v2) == 4
                and v2[0] == "__move__" and v2[3] < 0):
            moved_to[k2[len(LOC_KEY_PREFIX):]] = (v2[1], v2[2])

    # create records for objects first seen by the diff consumer
    seen = announced.setdefault(i, 1)  # the root needs no create
    if len(t.objects) > seen:
        for oi in range(seen, len(t.objects)):
            kind = kind_of[oi]
            records.append({
                "action": "create",
                "type": ("text" if kind == A_MAKE_TEXT else
                         "list" if kind == A_MAKE_LIST else "map"),
                "obj": oid_of[oi]})
        announced[i] = len(t.objects)

    def conflicts_of(f: int) -> list[dict] | None:
        """Loser records for a multi-survivor field (op_set.js:95-103),
        in actor-descending order (the winner first, op_set.js:201)."""
        ops = np.nonzero(candidate & (st_fid == f))[0]
        if len(ops) <= 1:
            return None
        w = int(win_actor[f])
        recs = []
        for op in sorted(ops.tolist(), key=lambda op: -int(st_actor[op])):
            a = int(st_actor[op])
            if a == w:
                continue
            v, is_link = _decode_value(t, int(st_value[op]))
            rec = {"actor": rset.actors[a], "value": v}
            if is_link:
                rec["link"] = True
            recs.append(rec)
        return recs or None

    # map-field records (sequence fields are driven by chg_elem below)
    for f in np.nonzero(chg_fid[:len(t.fields)])[0].tolist():
        obj_idx, key = t.fields[f]
        if obj_idx in seq_objs:
            continue
        if key.startswith(LOC_KEY_PREFIX):
            records.extend(_move_records(t, f, key, r, kind_of, oid_of,
                                         seq_objs, homes))
            continue
        rec: dict[str, Any] = {"type": "map", "obj": oid_of[obj_idx],
                               "key": key}
        if present[f]:
            rec["action"] = "set"
            v, is_link = _decode_value(t, int(win_value[f]))
            if is_link:
                loc = moved_to.get(v)
                if loc is not None and loc != (oid_of[obj_idx], key):
                    continue  # single-location rule
                rec["link"] = True
                homes[v] = (oid_of[obj_idx], key)
            rec["value"] = v
            c = conflicts_of(f)
            if c:
                rec["conflicts"] = c
        else:
            rec["action"] = "remove"
        records.append(rec)

    # sequence records, per touched list row: removes (desc old index),
    # inserts (asc new index), sets (asc new index)
    vis, rank = r["elem_visible"], r["vis_rank"]
    prev_vis, prev_rank, ins_fid = r["prev_vis"], r["prev_rank"], r["ins_fid"]
    for lrow in np.nonzero(chg_elem.any(axis=1))[0].tolist():
        obj_idx = int(r["list_obj"][lrow])
        if obj_idx < 0:
            continue
        typ = "text" if kind_of[obj_idx] == A_MAKE_TEXT else "list"
        oid = oid_of[obj_idx]
        removes, inserts, sets = [], [], []
        for slot in np.nonzero(chg_elem[lrow])[0].tolist():
            was = bool(prev_vis[lrow, slot])
            now = bool(vis[lrow, slot])
            f = int(ins_fid[lrow, slot])
            if was and not now:
                removes.append({"action": "remove", "type": typ, "obj": oid,
                                "index": int(prev_rank[lrow, slot])})
            elif now:
                if was and not chg_fid[f]:
                    continue  # pure rank shift: implicit in the patch
                v, is_link = _decode_value(t, int(win_value[f]))
                rec = {"action": "insert" if not was else "set",
                       "type": typ, "obj": oid,
                       "index": int(rank[lrow, slot]), "value": v}
                if is_link:
                    rec["link"] = True
                c = conflicts_of(f)
                if c:
                    rec["conflicts"] = c
                (inserts if not was else sets).append(rec)
        removes.sort(key=lambda rec: -rec["index"])
        inserts.sort(key=lambda rec: rec["index"])
        sets.sort(key=lambda rec: rec["index"])
        records.extend(removes + inserts + sets)
    return records


def _move_records(t, f: int, key: str, r: dict, kind_of: dict, oid_of: dict,
                  seq_objs: set, homes: dict) -> list[dict]:
    """The records of a changed move-plane location field
    (encode.move_loc_key): its winning survivor IS the child's resolved
    location. A list move gives the explicit record; a map move a remove
    at the previous location and a link at the destination. Concurrent
    losers are location candidates, not field survivors: no conflicts."""
    present, win_value, chg_fid = r["present"], r["win_value"], r["chg_fid"]
    if not present[f]:
        return []
    v, _ = _decode_value(t, int(win_value[f]))
    if not (isinstance(v, tuple) and len(v) == 4 and v[0] == "__move__"):
        return []
    _tag, dest_obj, dest_key, delem = v
    body = key[len(LOC_KEY_PREFIX):]
    if delem >= 0:
        lobj, _sep, eid = body.partition("\x00")
        loi = t.obj_index.get(lobj)
        return [{"action": "move",
                 "type": "text" if kind_of.get(loi) == A_MAKE_TEXT else "list",
                 "obj": lobj, "elem": eid, "anchor": dest_key,
                 "counter": int(delem)}]
    child = body
    out = []
    old = homes.get(child)
    if old is None:
        # first move this consumer sees: the child leaves wherever earlier
        # rounds' visible link winners put it (fields changed THIS round
        # are suppressed instead, so they never reached the mirror)
        for f2, (oi3, k3) in enumerate(t.fields):
            if (oi3 in seq_objs or k3.startswith(LOC_KEY_PREFIX)
                    or f2 >= len(present) or not present[f2]
                    or chg_fid[f2]):
                continue
            v2, link2 = _decode_value(t, int(win_value[f2]))
            if link2 and v2 == child:
                out.append({"action": "remove", "type": "map",
                            "obj": oid_of[oi3], "key": k3})
    elif old != (dest_obj, dest_key):
        out.append({"action": "remove", "type": "map", "obj": old[0],
                    "key": old[1]})
    if old != (dest_obj, dest_key):
        out.append({"action": "set", "type": "map", "obj": dest_obj,
                    "key": dest_key, "value": child, "link": True})
    homes[child] = (dest_obj, dest_key)
    return out


class MirrorDoc:
    """An incrementally maintained materialized view driven only by engine
    diff records (the frontend's updateCache-from-diffs flow,
    freeze_api.js:148-186), for consumers that track a resident document
    without holding its op log."""

    def __init__(self):
        self.objects: dict[str, Any] = {"_root": {}}
        self.conflicts: dict[str, dict] = {}  # obj id -> key -> conflicts
        self._links: dict[str, str] = {}      # obj id -> placeholder marker

    def apply(self, records: list[dict]) -> None:
        for rec in records:
            action = rec["action"]
            if action == "create":
                self.objects[rec["obj"]] = ([] if rec["type"] in
                                            ("list", "text") else {})
                if rec["type"] == "text":
                    self._links[rec["obj"]] = "text"
                continue
            obj = rec["obj"]
            if obj not in self.objects:  # the root arrives unannounced
                self.objects[obj] = {}
                self.objects["_root"] = self.objects[obj]
            node = self.objects[obj]
            value = rec.get("value")
            if rec.get("link"):
                value = self.objects[value]
            if rec["type"] == "map":
                if action == "set":
                    node[rec["key"]] = value
                    if rec.get("conflicts"):
                        self.conflicts.setdefault(obj, {})[rec["key"]] = {
                            c["actor"]: (self.objects[c["value"]]
                                         if c.get("link") else c["value"])
                            for c in rec["conflicts"]}
                    else:
                        self.conflicts.get(obj, {}).pop(rec["key"], None)
                elif action == "remove":
                    node.pop(rec["key"], None)
                    self.conflicts.get(obj, {}).pop(rec["key"], None)
            else:  # list / text; a list "move" is ignored (module docstring)
                if action == "insert":
                    node.insert(rec["index"], value)
                elif action == "set":
                    node[rec["index"]] = value
                elif action == "remove":
                    del node[rec["index"]]

    def snapshot(self, root_obj_id: str) -> dict:
        """Plain {data, conflicts} in batchdoc.decode_doc's shape (text
        nodes render as strings)."""
        text_ids = {id(self.objects[o]) for o, m in self._links.items()
                    if m == "text" and o in self.objects}

        def deep(v):
            if isinstance(v, list):
                if id(v) in text_ids:
                    return "".join(str(x) for x in v)
                return [deep(x) for x in v]
            if isinstance(v, dict):
                return {k: deep(x) for k, x in v.items()}
            return v

        root = self.objects.get(root_obj_id, self.objects["_root"])
        conflicts = {k: {a: deep(v) for a, v in c.items()}
                     for k, c in self.conflicts.get(root_obj_id, {}).items()}
        return {"data": deep(root), "conflicts": conflicts}
