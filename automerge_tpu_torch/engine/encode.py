"""Host-side encoder: change graphs -> columnar integer batches (a copy of
`automerge_tpu/engine/encode.py`; plain Python and numpy, no torch).

UUID/string identifiers become integer tables at the host boundary, and
everything past this file is fixed-shape int32 arrays.

Canonicalization rules (required for cross-replica state-hash parity):
- actor ranks are assigned in sorted actor-string order, so integer rank
  comparisons agree with Automerge's string-comparison LWW tie-break
  (op_set.js:201,346-347);
- object ids, field ids and value ids are assigned in a canonical order
  derived from the change graph content, so two replicas holding the same set
  of changes produce identical tables regardless of delivery order.

Causality at the batch boundary: changes whose dependencies are not satisfied
within the batch stay queued on the host (the reference buffers them in the
OpSet queue, op_set.js:254-270); duplicate (actor, seq) deliveries are dropped
as idempotent. Inside a complete batch, survivor analysis is order-independent,
so the kernel needs no causal ordering — only the per-change transitive clocks.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any
import zlib

import numpy as np

from ..core.change import Change
from ..core.ids import ROOT_ID, HEAD, make_elem_id
from ..native.linearize import linearize_host

# Action codes
(A_MAKE_MAP, A_MAKE_LIST, A_MAKE_TEXT, A_INS, A_SET, A_DEL, A_LINK,
 A_MOVE) = range(8)
_ACTION_CODE = {"makeMap": A_MAKE_MAP, "makeList": A_MAKE_LIST,
                "makeText": A_MAKE_TEXT, "ins": A_INS, "set": A_SET,
                "del": A_DEL, "link": A_LINK, "move": A_MOVE}

ASSIGN_CODES = (A_SET, A_DEL, A_LINK)

# A move op is assign-LIKE for the kernels (action >= A_SET joins the
# survivor analysis) but its field is the moved target's LOCATION field
# on the root object: location ops of one target dominate each other
# there regardless of destination — the same move-chain join the
# snapshot compactor runs — and the destination rides in the value
# identity, so the state hash still distinguishes every (dest, elem).
LOC_KEY_PREFIX = "\x00loc\x00"


def move_loc_key(op) -> str:
    """Location-field key for one move op. Map children are globally
    unique (uuid object ids) and their chains span destinations, so the
    key is the child id alone; list element ids are LIST-scoped (two
    lists can both hold an "A:2"), so their key includes the list — and a
    list move always targets its own list. `elem` (present iff list
    move) is the wire-level discriminator."""
    if op.elem is not None and op.elem >= 0:
        return f"{LOC_KEY_PREFIX}{op.obj}\x00{op.value}"
    return LOC_KEY_PREFIX + op.value


def move_value_key(op) -> tuple:
    return ("__move__", op.obj, op.key or "",
            op.elem if op.elem is not None else -1)


_hash_memo: dict[str, int] = {}


def content_hash(text: str) -> int:
    """Stable 31-bit content hash (crc32), memoized — the same actor/key/
    value strings recur across documents in a batch. Used so state hashes
    depend on string/value *content*, not on interning-table order — required
    for incrementally-grown resident tables to agree with canonical ones."""
    h = _hash_memo.get(text)
    if h is None:
        h = zlib.crc32(text.encode("utf-8", "surrogatepass")) & 0x7FFFFFFF
        if len(_hash_memo) < 1_000_000:
            _hash_memo[text] = h
        else:
            return h
    return h


def value_bytes(value) -> bytes:
    """Canonical type-tagged byte form of a scalar value, the input to
    `value_hash_of`. Deliberately language-neutral (decimal ints, raw IEEE754
    bits for floats, UTF-8/WTF-8 for strings) so a native C++ encoder can
    produce identical hashes from the wire tokens without reproducing
    Python repr()."""
    if isinstance(value, tuple) and len(value) == 2 and value[0] == "__link__":
        return b"l:" + value[1].encode("utf-8", "surrogatepass")
    if isinstance(value, tuple) and len(value) == 4 and value[0] == "__move__":
        # ("__move__", dest_obj, dest_key, elem) — the C++ encoder's kind-8
        # ValueKey produces identical bytes (deltaenc.cpp value_bytes)
        return (b"m:" + value[1].encode("utf-8", "surrogatepass") + b"\x00"
                + value[2].encode("utf-8", "surrogatepass")
                + b":%d" % value[3])
    if value is None:
        return b"n"
    if value is True:
        return b"b:1"
    if value is False:
        return b"b:0"
    if isinstance(value, int):
        return b"i:%d" % value
    if isinstance(value, float):
        import struct
        return b"d:" + struct.pack("<d", value)
    if isinstance(value, str):
        return b"s:" + value.encode("utf-8", "surrogatepass")
    return b"r:" + repr(value).encode("utf-8", "surrogatepass")


def value_hash_of(value) -> int:
    """31-bit content hash of a scalar value (see value_bytes)."""
    return zlib.crc32(value_bytes(value)) & 0x7FFFFFFF


def _pad_to(n: int, minimum: int = 8) -> int:
    """Round up to a power of two to bound recompilation across batch sizes."""
    size = minimum
    while size < n:
        size *= 2
    return size


@dataclass
class ValueTable:
    """Canonical value interning. Values are keyed by a type-tagged repr so
    1, 1.0 and True stay distinct (the frontend is type-strict too)."""
    keys: list = field(default_factory=list)
    index: dict = field(default_factory=dict)
    values: list = field(default_factory=list)

    @staticmethod
    def _key(value: Any):
        if isinstance(value, tuple) and len(value) == 2 and value[0] == "__link__":
            return ("link", value[1])
        if isinstance(value, tuple) and len(value) == 4 and value[0] == "__move__":
            return ("move", value[1], value[2], value[3])
        return (type(value).__name__, repr(value))

    def add(self, value: Any) -> None:
        key = self._key(value)
        if key not in self.index:
            self.index[key] = -1  # assigned in finalize()
            self.keys.append(key)
            self.values.append(value)

    def finalize(self) -> None:
        order = sorted(range(len(self.keys)), key=lambda i: repr(self.keys[i]))
        self.keys = [self.keys[i] for i in order]
        self.values = [self.values[i] for i in order]
        self.index = {k: i for i, k in enumerate(self.keys)}
        self.hashes = [value_hash_of(v) for v in self.values]

    def id_and_hash(self, value: Any) -> tuple[int, int]:
        i = self.index[self._key(value)]
        return i, self.hashes[i]


@dataclass
class DocEncoding:
    """Columnar arrays for one document (numpy; stacked across docs later)."""
    # per op
    op_mask: np.ndarray
    action: np.ndarray
    fid: np.ndarray          # dense field id for assigns, -1 otherwise
    actor: np.ndarray        # actor rank of the op's change
    seq: np.ndarray
    change_idx: np.ndarray
    value: np.ndarray        # value table id; -1 for del / non-assign
    fid_hash: np.ndarray     # content hash of (obj uuid, key)
    value_hash: np.ndarray   # content hash of the value
    # per change
    clock: np.ndarray        # [max_changes, n_actors] transitive deps
    # per list object, per element slot
    ins_mask: np.ndarray     # [max_lists, max_elems]
    ins_elem: np.ndarray
    ins_actor: np.ndarray
    ins_parent: np.ndarray   # element slot index of parent, -1 for head
    ins_fid: np.ndarray      # fid of the element's assign field
    ins_pos: np.ndarray      # precomputed RGA position of each element slot
    list_obj: np.ndarray     # [max_lists] object id or -1
    list_obj_hash: np.ndarray  # [max_lists] content hash of the list's uuid
    # decode tables (host side)
    actors: list = None
    objects: list = None     # (object_id, type_code)
    fields: list = None      # fid -> (obj_idx, key_string_or_elemid)
    value_table: ValueTable = None
    n_fids: int = 0
    queued: list = None      # changes left causally unready


def encode_doc(changes: list[Change], actors: list[str] | None = None) -> DocEncoding:
    """Encode a complete change set for one document.

    `actors` optionally supplies a global (batch-wide) actor table; it must be
    sorted. When omitted, the doc's own actors are collected and sorted.
    """
    # -- causal completeness + idempotent dedup ----------------------------
    by_id: dict[tuple[str, int], Change] = {}
    for c in changes:
        by_id.setdefault((c.actor, c.seq), c)
    ready: list[Change] = []
    clock: dict[str, int] = {}
    queued = list(by_id.values())
    progress = True
    while progress:
        progress = False
        still = []
        for c in sorted(queued, key=lambda c: (c.actor, c.seq)):
            deps = dict(c.deps)
            deps[c.actor] = c.seq - 1
            if all(clock.get(a, 0) >= s for a, s in deps.items()):
                ready.append(c)
                clock[c.actor] = max(clock.get(c.actor, 0), c.seq)
                progress = True
            else:
                still.append(c)
        queued = still

    # `ready` is in a causal order (the readiness loop only admits changes
    # whose dependencies are satisfied), so makes precede uses below. Tables
    # are canonicalized afterwards by *content*, never by delivery order.
    if actors is None:
        actors = sorted({c.actor for c in ready})
    actor_rank = {a: i for i, a in enumerate(actors)}

    # transitive clocks per change
    state_clocks: dict[tuple[str, int], dict[str, int]] = {}
    for c in ready:
        base = dict(c.deps)
        base[c.actor] = c.seq - 1
        out: dict[str, int] = {}
        for a, s in base.items():
            if s <= 0:
                continue
            trans = state_clocks.get((a, s))
            if trans:
                for a2, s2 in trans.items():
                    if s2 > out.get(a2, 0):
                        out[a2] = s2
            out[a] = s
        state_clocks[(c.actor, c.seq)] = out

    # -- first pass (causal order): discover objects, elements, values -----
    discovered: dict[str, int] = {}              # object_id -> type code
    values = ValueTable()
    elem_info: dict[str, list] = {}              # object_id -> [(elem, actor, parent_eid, eid)]

    for c in ready:
        for op in c.ops:
            code = _ACTION_CODE[op.action]
            if code in (A_MAKE_MAP, A_MAKE_LIST, A_MAKE_TEXT):
                discovered.setdefault(op.obj, code)
            elif code == A_INS:
                eid = make_elem_id(c.actor, op.elem)
                elem_info.setdefault(op.obj, []).append(
                    (op.elem, actor_rank[c.actor], op.key, eid))
            elif code == A_SET:
                values.add(op.value)
            elif code == A_LINK:
                values.add(("__link__", op.value))
            elif code == A_MOVE:
                values.add(move_value_key(op))
    values.finalize()

    # -- canonical tables: content-keyed, delivery-order-independent -------
    objects: list[tuple[str, int]] = [(ROOT_ID, A_MAKE_MAP)]
    for oid in sorted(discovered):
        if oid != ROOT_ID:
            objects.append((oid, discovered[oid]))
    obj_index = {oid: i for i, (oid, _) in enumerate(objects)}

    # element slots per list, canonical (elem, actor) order; dedup eids
    list_elems: dict[int, dict[str, int]] = {}
    list_ins: dict[int, list] = {}
    for oid, entries in elem_info.items():
        oi = obj_index[oid]
        seen_eids: dict[str, tuple] = {}
        for entry in entries:
            seen_eids.setdefault(entry[3], entry)
        ordered = sorted(seen_eids.values(), key=lambda e: (e[0], e[1]))
        list_elems[oi] = {e[3]: slot for slot, e in enumerate(ordered)}
        list_ins[oi] = ordered

    # field ids in canonical (obj_idx, key) order
    field_keys: set[tuple[int, str]] = set()
    for c in ready:
        for op in c.ops:
            code = _ACTION_CODE[op.action]
            if code in ASSIGN_CODES:
                field_keys.add((obj_index[op.obj], op.key))
            elif code == A_MOVE:
                field_keys.add((0, move_loc_key(op)))
    fields = sorted(field_keys)
    fid_index = {fk: i for i, fk in enumerate(fields)}
    obj_uuids = [oid for oid, _ in objects]
    fid_hashes = [content_hash(f"{obj_uuids[oi]}\x00{key}")
                  for oi, key in fields]

    # -- op table -----------------------------------------------------------
    n_ops = sum(len(c.ops) for c in ready)
    max_ops = _pad_to(max(n_ops, 1))
    max_changes = _pad_to(max(len(ready), 1))
    n_actors = max(len(actors), 1)

    op_mask = np.zeros(max_ops, dtype=bool)
    action = np.full(max_ops, -1, dtype=np.int32)
    fid = np.full(max_ops, -1, dtype=np.int32)
    actor_arr = np.zeros(max_ops, dtype=np.int32)
    seq_arr = np.zeros(max_ops, dtype=np.int32)
    change_idx = np.zeros(max_ops, dtype=np.int32)
    value_arr = np.full(max_ops, -1, dtype=np.int32)
    fid_hash_arr = np.zeros(max_ops, dtype=np.int32)
    value_hash_arr = np.zeros(max_ops, dtype=np.int32)
    clock_mat = np.zeros((max_changes, n_actors), dtype=np.int32)
    obj_uuid = {i: oid for i, (oid, _) in enumerate(objects)}

    i = 0
    for ci, c in enumerate(ready):
        for a, s in state_clocks[(c.actor, c.seq)].items():
            if a in actor_rank:
                clock_mat[ci, actor_rank[a]] = s
        for op in c.ops:
            code = _ACTION_CODE[op.action]
            op_mask[i] = True
            action[i] = code
            actor_arr[i] = actor_rank[c.actor]
            seq_arr[i] = c.seq
            change_idx[i] = ci
            if code in ASSIGN_CODES:
                f = fid_index[(obj_index[op.obj], op.key)]
                fid[i] = f
                fid_hash_arr[i] = fid_hashes[f]
                if code == A_SET:
                    value_arr[i], value_hash_arr[i] = values.id_and_hash(op.value)
                elif code == A_LINK:
                    value_arr[i], value_hash_arr[i] = values.id_and_hash(
                        ("__link__", op.value))
            elif code == A_MOVE:
                f = fid_index[(0, move_loc_key(op))]
                fid[i] = f
                fid_hash_arr[i] = fid_hashes[f]
                value_arr[i], value_hash_arr[i] = values.id_and_hash(
                    move_value_key(op))
            i += 1

    # -- list tables --------------------------------------------------------
    list_objs = sorted(list_elems.keys())
    max_lists = _pad_to(max(len(list_objs), 1), minimum=1)
    max_elems = _pad_to(max((len(v) for v in list_elems.values()), default=1))

    ins_mask = np.zeros((max_lists, max_elems), dtype=bool)
    ins_elem = np.zeros((max_lists, max_elems), dtype=np.int32)
    ins_actor = np.zeros((max_lists, max_elems), dtype=np.int32)
    ins_parent = np.full((max_lists, max_elems), -1, dtype=np.int32)
    ins_fid = np.full((max_lists, max_elems), -1, dtype=np.int32)
    list_obj = np.full(max_lists, -1, dtype=np.int32)
    list_obj_hash = np.full(max_lists, -1, dtype=np.int32)

    ins_pos = np.full((max_lists, max_elems), -1, dtype=np.int32)

    for li, oi in enumerate(list_objs):
        list_obj[li] = oi
        list_obj_hash[li] = content_hash(obj_uuid[oi])
        slots = list_elems[oi]
        for (elem, arank, parent_eid, eid) in list_ins[oi]:
            slot = slots[eid]
            ins_mask[li, slot] = True
            ins_elem[li, slot] = elem
            ins_actor[li, slot] = arank
            ins_parent[li, slot] = -1 if parent_eid == HEAD else slots[parent_eid]
            ins_fid[li, slot] = fid_index.get((oi, eid), -1)
        # RGA order on the host, shipped as a position column
        ins_pos[li] = linearize_host(ins_mask[li], ins_elem[li],
                                     ins_actor[li], ins_parent[li])

    return DocEncoding(
        op_mask=op_mask, action=action, fid=fid, actor=actor_arr, seq=seq_arr,
        change_idx=change_idx, value=value_arr, fid_hash=fid_hash_arr,
        value_hash=value_hash_arr, clock=clock_mat,
        ins_mask=ins_mask, ins_elem=ins_elem, ins_actor=ins_actor,
        ins_parent=ins_parent, ins_fid=ins_fid, ins_pos=ins_pos,
        list_obj=list_obj, list_obj_hash=list_obj_hash,
        actors=list(actors), objects=objects,
        fields=fields, value_table=values, n_fids=len(fields), queued=queued)


def stack_docs(encodings: list[DocEncoding]) -> dict[str, np.ndarray]:
    """Stack per-doc encodings into batch arrays [n_docs, ...], padding each
    axis to the batch maximum."""
    def pad2(a, rows, cols, fill):
        out = np.full((rows, cols), fill, dtype=a.dtype)
        out[:a.shape[0], :a.shape[1]] = a
        return out

    def pad1(a, n, fill):
        out = np.full(n, fill, dtype=a.dtype)
        out[:a.shape[0]] = a
        return out

    max_ops = max(e.op_mask.shape[0] for e in encodings)
    max_changes = max(e.clock.shape[0] for e in encodings)
    n_actors = max(e.clock.shape[1] for e in encodings)
    max_lists = max(e.ins_mask.shape[0] for e in encodings)
    max_elems = max(e.ins_mask.shape[1] for e in encodings)
    max_fids = _pad_to(max(max(e.n_fids for e in encodings), 1))

    batch = {
        "op_mask": np.stack([pad1(e.op_mask, max_ops, False) for e in encodings]),
        "action": np.stack([pad1(e.action, max_ops, -1) for e in encodings]),
        "fid": np.stack([pad1(e.fid, max_ops, -1) for e in encodings]),
        "actor": np.stack([pad1(e.actor, max_ops, 0) for e in encodings]),
        "seq": np.stack([pad1(e.seq, max_ops, 0) for e in encodings]),
        "change_idx": np.stack([pad1(e.change_idx, max_ops, 0) for e in encodings]),
        "value": np.stack([pad1(e.value, max_ops, -1) for e in encodings]),
        "fid_hash": np.stack([pad1(e.fid_hash, max_ops, 0) for e in encodings]),
        "value_hash": np.stack([pad1(e.value_hash, max_ops, 0) for e in encodings]),
        "clock": np.stack([pad2(e.clock, max_changes, n_actors, 0) for e in encodings]),
        "ins_mask": np.stack([pad2(e.ins_mask, max_lists, max_elems, False) for e in encodings]),
        "ins_elem": np.stack([pad2(e.ins_elem, max_lists, max_elems, 0) for e in encodings]),
        "ins_actor": np.stack([pad2(e.ins_actor, max_lists, max_elems, 0) for e in encodings]),
        "ins_parent": np.stack([pad2(e.ins_parent, max_lists, max_elems, -1) for e in encodings]),
        "ins_fid": np.stack([pad2(e.ins_fid, max_lists, max_elems, -1) for e in encodings]),
        "ins_pos": np.stack([pad2(e.ins_pos, max_lists, max_elems, -1) for e in encodings]),
        "list_obj": np.stack([pad1(e.list_obj, max_lists, -1) for e in encodings]),
        "list_obj_hash": np.stack([pad1(e.list_obj_hash, max_lists, -1) for e in encodings]),
        # rank -> actor CONTENT hash, per doc's own rank basis: the state
        # hash mixes this (never the rank) so replicas holding different
        # doc subsets — hence different global actor tables — still hash
        # identical visible states identically (kernels.state_hash)
        "actor_hash": np.stack([pad1(np.asarray(
            [content_hash(a) for a in (e.actors or [])], dtype=np.int32),
            n_actors, 0) for e in encodings]),
    }
    batch["max_fids"] = max_fids
    return batch
