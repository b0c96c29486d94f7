"""WatchableDoc: a single-document observable (reference:
Automerge's src/watchable_doc.js)."""

from __future__ import annotations

from typing import Callable

from .. import api


class WatchableDoc:
    def __init__(self, doc):
        if doc is None:
            raise ValueError("doc argument is required")
        self.doc = doc
        self.handlers: list[Callable] = []

    def get(self):
        return self.doc

    def set(self, doc) -> None:
        self.doc = doc
        for handler in list(self.handlers):
            handler(doc)

    def apply_changes(self, changes):
        doc = api.apply_changes(self.doc, changes)
        self.set(doc)
        return doc

    def register_handler(self, handler: Callable) -> None:
        if handler not in self.handlers:
            self.handlers.append(handler)

    def unregister_handler(self, handler: Callable) -> None:
        if handler in self.handlers:
            self.handlers.remove(handler)
