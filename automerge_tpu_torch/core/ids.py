"""Identifier scheme (a copy of `automerge_tpu/core/ids.py`).

- The root object has a fixed all-zeros UUID (Automerge's op_set.js:3).
- Every other map/list/text object gets a fresh v4 UUID at creation time.
- List element IDs are `actorId + ':' + elem` where `elem` is a per-list
  Lamport counter (op_set.js:84).
"""

from __future__ import annotations

ROOT_ID = "00000000-0000-0000-0000-000000000000"
HEAD = "_head"


def make_elem_id(actor: str, elem: int) -> str:
    return f"{actor}:{elem}"

