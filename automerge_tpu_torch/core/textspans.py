"""Span-table helpers of the text-merge plane (the pure part of
`automerge_tpu/core/textspans.py`).

A text document's visible order, run-length encoded, is a list of spans:
maximal runs of consecutively-numbered same-origin elements. A merge of
two divergent histories needs only the spans of the regions they touch
and the spans they typed concurrently; `merge_table` assembles them into
the rows `engine/pack.pack_spans` ships, and `engine/span_kernels.
merge_spans` orders them by a sort.
"""

from __future__ import annotations


def merge_table(base_spans, blocks) -> list[tuple]:
    """Assemble one document's merge span table (the 7-tuple rows
    engine/pack.pack_spans ships) from its region split.

    `base_spans` is the RLE of the common history in document order,
    already split at every concurrent anchor gap and deletion boundary:
    (origin, start_id, vis_len) rows, vis_len=0 for a tombstone run.
    `blocks` are the concurrent subtree blocks, each (gap, prio_elem,
    prio_actor, runs): `gap` is the index of the base span the block
    anchors AFTER (-1 for the head gap), (prio_elem, prio_actor) the RGA
    sibling priority of the block's head element, and `runs` the block's
    RLE spans in side-local document order.

    The merged document order is ``lexsort(slot, -prio_elem, -prio_actor,
    block_seq)`` over the returned rows; the table size is O(touched
    regions + concurrent spans), never O(document)."""
    rows = []
    for i, (origin, start, vis) in enumerate(base_spans):
        rows.append((origin, start, vis, 2 * i, 0, 0, i))
    for (gap, pelem, pactor, runs) in blocks:
        for j, (origin, start, vis) in enumerate(runs):
            rows.append((origin, start, vis, 2 * gap + 1, pelem, pactor, j))
    return rows


def rle_runs(keys):
    """Maximal runs of consecutively-numbered same-origin elem ids
    ("actor:n"), in order: yields (actor, start_elem, length,
    start_index)."""
    cur_actor: str | None = None
    cur_start = cur_len = cur_at = 0
    prev_elem = -2
    at = 0
    for key in keys:
        i = key.rindex(":")
        actor, elem = key[:i], int(key[i + 1:])
        if actor == cur_actor and elem == prev_elem + 1:
            cur_len += 1
        else:
            if cur_actor is not None:
                yield cur_actor, cur_start, cur_len, cur_at
            cur_actor, cur_start, cur_len, cur_at = actor, elem, 1, at
        prev_elem = elem
        at += 1
    if cur_actor is not None:
        yield cur_actor, cur_start, cur_len, cur_at


def spans_of_elems(elems, insertion) -> list[tuple[str, int, int]]:
    """Run-length encode a visible element index (anything with a `.keys`
    sequence of elem ids in document order) into (actor, start_elem,
    length) triples. `insertion` is accepted for the reference's
    signature; visibility is what the index already encodes."""
    return [(a, s, n) for a, s, n, _ in rle_runs(elems.keys)]
