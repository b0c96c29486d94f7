"""BatchedDocSet: a whole DocSet as one columnar device computation
(counterpart of `automerge_tpu/engine/batchdoc.py`).

N documents' change sets are encoded into stacked integer arrays and one
batched program (`kernels.apply_doc`, its domination step the B5 kernel)
computes every document's converged state: field survivors, LWW winners,
list orders, tombstone ranks and a canonical state hash.

`decode_doc` rebuilds a document from the device outputs through the host
string tables; it serves parity checks and reads, not the hot loop. The
hot loop is: encode once, apply on the device, compare hashes.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.change import Change
from ..device import resolve_device
from ..utils import metrics
from .encode import (A_MAKE_MAP, A_MAKE_TEXT, DocEncoding, LOC_KEY_PREFIX,
                     encode_doc, stack_docs)
from .cuda_kernels import hashes_to_numpy
from .kernels import apply_doc


def apply_batch(doc_changes: list[list[Change]],
                actors: list[str] | None = None, device="cuda"):
    """Encode + apply a batch of documents' change sets on `device`.

    Returns (encodings, batch, out): `batch` holds the stacked input
    tensors and `out` apply_doc's per-doc outputs, both on the device;
    out["hash"] is the canonical per-document state hash ([D] int32
    holding the uint32 bits). List order comes from the host linearizer
    (host_order=True), as in the reference."""
    dev = resolve_device(device)
    if actors is None:
        actors = sorted({c.actor for changes in doc_changes for c in changes})
    with metrics.trace("engine_reconcile"):
        encodings = [encode_doc(changes, actors) for changes in doc_changes]
        batch = stack_docs(encodings)
        max_fids = batch.pop("max_fids")
        arrays = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        out = metrics.dispatch_jit("apply_doc", apply_doc, arrays,
                                   max_fids, host_order=True)
    metrics.bump("engine_docs_reconciled", len(doc_changes))
    metrics.bump("engine_ops_reconciled",
                 sum(len(c.ops) for changes in doc_changes for c in changes))
    return encodings, arrays, out


def doc_outputs(out: dict, i: int) -> dict[str, np.ndarray]:
    """Document i's slice of apply_doc's outputs, as numpy."""
    return {k: v[i].cpu().numpy() for k, v in out.items()}


class BatchedDocSet:
    """Columnar counterpart of sync.DocSet for bulk reconciliation."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.doc_ids: list[str] = []
        self.changes: dict[str, list[Change]] = {}
        self._encodings: list[DocEncoding] | None = None
        self._out = None

    def add_changes(self, doc_id: str, changes) -> None:
        if doc_id not in self.changes:
            self.changes[doc_id] = []
            self.doc_ids.append(doc_id)
        self.changes[doc_id].extend(changes)
        self._out = None

    def reconcile(self) -> np.ndarray:
        """Run the batched reconcile over every document; returns per-doc
        np.uint32 hashes aligned with self.doc_ids."""
        doc_changes = [self.changes[d] for d in self.doc_ids]
        self._encodings, _, self._out = apply_batch(doc_changes,
                                                    device=self.device)
        return hashes_to_numpy(self._out["hash"])

    def state_hash(self, doc_id: str) -> int:
        if self._out is None:
            self.reconcile()
        i = self.doc_ids.index(doc_id)
        return int(hashes_to_numpy(self._out["hash"][i:i + 1])[0])

    def materialize(self, doc_id: str) -> Any:
        """Decode one document's converged state into plain Python (dicts,
        lists, strings for text)."""
        if self._out is None:
            self.reconcile()
        i = self.doc_ids.index(doc_id)
        return decode_doc(self._encodings[i], doc_outputs(self._out, i))


def decode_doc(enc: DocEncoding, out: dict[str, np.ndarray]) -> Any:
    """Rebuild the nested document from device outputs + host tables."""
    present = out["present"]
    win_value = out["win_value"]
    candidate = out["candidate"]

    # conflicts: surviving value-carrying ops per fid, minus the winner
    ops_by_fid: dict[int, list[tuple[int, int]]] = {}
    fid_arr, actor_arr, value_arr = enc.fid, enc.actor, enc.value
    for op_i in np.nonzero(candidate[:len(fid_arr)])[0]:
        ops_by_fid.setdefault(int(fid_arr[op_i]), []).append(
            (int(actor_arr[op_i]), int(value_arr[op_i])))

    obj_type = {i: t for i, (_, t) in enumerate(enc.objects)}
    fields_of_obj: dict[int, list[tuple[int, str]]] = {}
    for f, (obj_idx, key) in enumerate(enc.fields):
        fields_of_obj.setdefault(obj_idx, []).append((f, key))

    # Move plane: `\x00loc\x00…` fields (engine/encode.py) are routing
    # metadata, not document keys. Decode each present map-move winner
    # (elem < 0) into a placement map and hide every loc field from the
    # visible tree — the single-location rule renders a moved child only
    # at its winning destination. List-move winners (elem >= 0) carry no
    # visible-state change here: element ranks are move-agnostic by
    # design (engine/diffs.py module docstring), so hiding the field is
    # the whole job.
    loc_fields: set[int] = set()
    moved_to: dict[str, tuple[str, str]] = {}
    for f, (obj_idx, key) in enumerate(enc.fields):
        if not key.startswith(LOC_KEY_PREFIX):
            continue
        loc_fields.add(f)
        if not present[f]:
            continue
        raw = enc.value_table.values[int(win_value[f])]
        if (isinstance(raw, tuple) and len(raw) == 4
                and raw[0] == "__move__" and raw[3] < 0):
            moved_to[key[len(LOC_KEY_PREFIX):]] = (raw[1], raw[2])
    moved_into: dict[str, list[tuple[str, str]]] = {}
    for child, (dobj, dkey) in moved_to.items():
        moved_into.setdefault(dobj, []).append((dkey, child))

    list_rows = {int(obj): row for row, obj in enumerate(enc.list_obj)
                 if obj >= 0}

    def decode_value(value_id: int):
        raw = enc.value_table.values[value_id]
        if isinstance(raw, tuple) and len(raw) == 2 and raw[0] == "__link__":
            return build(enc_obj_index(raw[1]))
        return raw

    obj_id_to_idx = {oid: i for i, (oid, _) in enumerate(enc.objects)}

    def enc_obj_index(object_id: str) -> int:
        return obj_id_to_idx[object_id]

    def build(obj_idx: int):
        t = obj_type[obj_idx]
        oid = enc.objects[obj_idx][0]
        if t == A_MAKE_MAP:
            data = {}
            conflicts = {}
            for f, key in fields_of_obj.get(obj_idx, []):
                if f in loc_fields or not present[f]:
                    continue
                raw = enc.value_table.values[int(win_value[f])]
                if (isinstance(raw, tuple) and len(raw) == 2
                        and raw[0] == "__link__"
                        and moved_to.get(raw[1]) not in (None, (oid, key))):
                    continue   # single-location: child lives at its dest
                data[key] = decode_value(int(win_value[f]))
                survivors = ops_by_fid.get(f, [])
                if len(survivors) > 1:
                    win_actor = max(a for a, _ in survivors)
                    conflicts[key] = {
                        enc.actors[a]: decode_value(v)
                        for a, v in survivors if a != win_actor}
            for dkey, child in moved_into.get(oid, []):
                if child in obj_id_to_idx:
                    data[dkey] = build(enc_obj_index(child))
            return (data, conflicts) if obj_idx == 0 else data
        # list or text
        row = list_rows.get(obj_idx)
        values: list = []
        if row is not None:
            vis = out["elem_visible"][row]
            ranks = out["vis_rank"][row]
            n_vis = int(vis.sum())
            values = [None] * n_vis
            for slot in np.nonzero(vis)[0]:
                f = int(enc.ins_fid[row][slot])
                values[int(ranks[slot])] = decode_value(int(win_value[f]))
        if t == A_MAKE_TEXT:
            return "".join(str(v) for v in values)
        return values

    data, conflicts = build(0)
    return {"data": data, "conflicts": conflicts}


def oracle_state(doc) -> dict:
    """The same {data, conflicts} shape produced from an oracle document (a
    document root of `api`), for parity assertions: maps become dicts,
    lists lists, text objects their string."""
    from .. import api
    from ..frontend.text import Text

    def convert(value):
        if isinstance(value, Text):
            return str(value)
        if isinstance(value, dict):
            return {k: convert(v) for k, v in value.items()}
        if isinstance(value, (list, tuple)):
            return [convert(v) for v in value]
        return value

    conflicts = {k: {a: convert(v) for a, v in c.items()}
                 for k, c in doc._conflicts.items()}
    return {"data": convert(api.inspect(doc)), "conflicts": conflicts}
