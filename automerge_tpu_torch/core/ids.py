"""Identifier scheme.

- The root object has a fixed all-zeros UUID (Automerge's src/op_set.js:3,
  INTERNALS.md:124-126).
- Every other map/list/text object gets a fresh v4 UUID at creation time
  (Automerge's src/automerge.js:41).
- List element IDs are `actorId + ':' + elem` where `elem` is a per-list
  Lamport counter (Automerge's src/op_set.js:84, INTERNALS.md:133-162).
  Actor IDs may themselves contain ':' in principle, so parsing splits on the
  *last* colon (the reference uses the greedy regex /^(.*):(\\d+)$/,
  op_set.js:352).
"""

from __future__ import annotations

ROOT_ID = "00000000-0000-0000-0000-000000000000"
HEAD = "_head"


def make_elem_id(actor: str, elem: int) -> str:
    return f"{actor}:{elem}"


def parse_elem_id(elem_id: str) -> tuple[str, int] | None:
    """Return (actor, elem) or None if `elem_id` is not a valid element ID."""
    if not elem_id:
        return None
    actor, sep, num = elem_id.rpartition(":")
    if not sep or not num.isdigit():
        return None
    return actor, int(num)
