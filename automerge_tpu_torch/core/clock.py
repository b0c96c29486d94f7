"""Vector clock helpers.

Clocks are plain dicts mapping actorId -> highest applied sequence number.
Semantics mirror the reference: `less_or_equal` is the partial order used to
detect divergence (Automerge's src/automerge.js:264-268,
src/connection.js:7-11), `union` is the element-wise max merge used by the sync
protocol (src/connection.js:16-19).

In the columnar engine the same operations become masked integer compare-reduces
over `[n_docs, n_actors]` int32 matrices.
"""

from __future__ import annotations

from typing import Mapping


def less_or_equal(clock1: Mapping[str, int], clock2: Mapping[str, int]) -> bool:
    """True iff every component of clock1 is <= the matching component of clock2."""
    for actor in set(clock1) | set(clock2):
        if clock1.get(actor, 0) > clock2.get(actor, 0):
            return False
    return True


def union(clock1: Mapping[str, int], clock2: Mapping[str, int]) -> dict[str, int]:
    """Element-wise max of two clocks."""
    out = dict(clock1)
    for actor, seq in clock2.items():
        if seq > out.get(actor, 0):
            out[actor] = seq
    return out


def equal(clock1: Mapping[str, int], clock2: Mapping[str, int]) -> bool:
    """Clock equality, treating absent entries as 0."""
    for actor in set(clock1) | set(clock2):
        if clock1.get(actor, 0) != clock2.get(actor, 0):
            return False
    return True
