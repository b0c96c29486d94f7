"""DocSet: an observable registry of documents — the unit a Connection syncs.

Mirrors Automerge's src/doc_set.js. `apply_changes` auto-creates unknown
documents with a fresh actor ID (doc_set.js:24-29).

The DocSet is also the natural batch dimension of the device path: see
engine/batchdoc.py for the columnar BatchedDocSet that reconciles thousands
of documents in one batched call.

This is the port's copy of `automerge_tpu/sync/docset.py`. A DocSet lives on
a device (`device=`, default the card, resolved once): the documents it
creates for unknown ids live there.
"""

from __future__ import annotations

from typing import Callable

from .. import api
from ..device import resolve_device
from ..utils.uuid import make_uuid


class DocSet:
    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self.docs: dict[str, object] = {}
        self.handlers: list[Callable] = []

    @property
    def doc_ids(self):
        return list(self.docs.keys())

    def get_doc(self, doc_id: str):
        return self.docs.get(doc_id)

    def set_doc(self, doc_id: str, doc) -> None:
        self.docs[doc_id] = doc
        for handler in list(self.handlers):
            handler(doc_id, doc)

    def apply_changes(self, doc_id: str, changes):
        doc = self.docs.get(doc_id)
        if doc is None:
            doc = api.init(make_uuid(), self.device)
        doc = api.apply_changes(doc, changes) if changes else doc
        self.set_doc(doc_id, doc)
        return doc

    def register_handler(self, handler: Callable) -> None:
        if handler not in self.handlers:
            self.handlers.append(handler)

    def unregister_handler(self, handler: Callable) -> None:
        if handler in self.handlers:
            self.handlers.remove(handler)
