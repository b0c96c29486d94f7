"""numpy model of the linearize kernel's algorithm (`csrc/linearize.cu`):
the CPU proof of that algorithm (`tests/test_torch_linearize.py` holds it
to `kernels.linearize_plain` and to the reference) and the counts of what
it runs, which `chip_smoke.py` prints beside the kernel's times. No
product path calls it: the engine's route is `kernels.linearize`.

`schedule_model` runs, on every row at once, what the kernel runs on each:

1. the row's parent nodes (p = parent + 1, 0 for the head, E + 1 for a
   parent past the array) and its causal verdict: every live slot's
   parent is the head or a live slot earlier in (key, actor, slot) order;
2. one sort of the slots by a record of (group, key, actor, slot), the
   group being the parent node on a causal row (E + 2 for a masked slot)
   and 0 on any other, so a causal row's children of one node are a
   contiguous run in ascending order and any other row is in the
   reference's (key, actor, slot) order. The record is wide (hi = group
   << 32 | key, lo = actor << 32 | slot, key and actor with the sign bit
   flipped) or, on a block row whose fields fit 31 bits, narrow: one
   uint32 of the four fields, key and actor less the row's live minima,
   each in as many bits as the row needs, a masked slot's key and actor 0
   (nothing orders by them: a causal row groups masked slots apart, the
   walk skips them);
3. on a causal row, the preorder's successor of every node in parallel:
   its first child (the last of its run), else the next sibling (the
   entry before it in its run) of its nearest ancestor-or-self that has
   one, found by pointer jumping on the parent chain, else -1;
4. on any other row, the reference's sequential walk over the sorted
   slots (head insertion after the parent, a parent past the array
   clamped on the load and dropped on the store);
5. pointer doubling of the successor list, which stops once no pointer
   is left (exact: a step with no live pointer changes nothing), and
   elem_pos = d[0] - d[s + 1] - 1, masked slots included.

A row with no live slot comes out -1 everywhere; the kernel writes that
without sorting or doubling.
"""

from __future__ import annotations

import numpy as np

from .engine.kernels import _ceil_log2

# Rows of at most this many slots run a slice of a warp each (a slice of
# the next power of two lanes); longer rows a block each.
SHORT_MAX = 32

_INT32_MAX = 2**31 - 1
_FLIP = 2**31
_LOW32 = 0xFFFFFFFF


def parent_nodes(ins_mask, ins_parent):
    """The parent node of each slot ([R, E] int64): parent + 1, 0 for a
    negative parent (the head), E + 1 for one past the array (its load
    clamped to node E, its store dropped), -1 for a masked slot."""
    e = ins_mask.shape[1]
    par = ins_parent.astype(np.int64)
    p = np.minimum(np.where(par >= 0, par + 1, 0), e + 1)
    return np.where(ins_mask, p, -1)


def causal_rows(ins_mask, ins_elem, ins_actor, ins_parent):
    """The kernel's verdict per row ([R] bool): every live slot's parent is
    the head or a live slot of the row that comes earlier in (key, actor,
    slot) order. On such a row the walk's list is the preorder of the
    parent forest, children in descending order."""
    r, e = ins_mask.shape
    slots = np.arange(e)
    key = np.where(ins_mask, ins_elem, _INT32_MAX).astype(np.int64)
    act = ins_actor.astype(np.int64)
    p = parent_nodes(ins_mask, ins_parent)
    q = np.clip(p - 1, 0, max(e - 1, 0))
    rows = np.arange(r)[:, None]
    qk, qa, qm = key[rows, q], act[rows, q], ins_mask[rows, q]
    earlier = (qk < key) | ((qk == key)
                            & ((qa < act) | ((qa == act) & (q < slots))))
    ok = ~ins_mask | (p == 0) | ((p <= e) & qm & earlier)
    return ok.all(1)


def _bits(x):
    """Bits to hold each value of x (int64 >= 0): 0 for 0."""
    out = np.zeros(np.shape(x), np.int64)
    x = np.asarray(x, np.int64).copy()
    while (x > 0).any():
        out += x > 0
        x >>= 1
    return out


def narrow_code(ins_mask, ins_elem, ins_actor):
    """Per row the kernel's record code: (narrow [R] bool, gshift, kshift,
    ashift, kmin, amin [R] int64). Narrow on a block row (E > SHORT_MAX)
    whose group (up to E + 2), key and actor ranges over its live slots
    and slot fit 31 bits."""
    r, e = ins_mask.shape
    big, small = 2**40, -2**40
    k = ins_elem.astype(np.int64)
    a = ins_actor.astype(np.int64)
    kmin = np.where(ins_mask, k, big).min(1) if e else np.zeros(r, np.int64)
    kmax = np.where(ins_mask, k, small).max(1) if e else kmin
    amin = np.where(ins_mask, a, big).min(1) if e else kmin
    amax = np.where(ins_mask, a, small).max(1) if e else kmin
    live = ins_mask.any(1)
    kspan = np.where(live, kmax - kmin, 0)
    aspan = np.where(live, amax - amin, 0)
    ashift = np.full(r, int(_bits(max(e - 1, 0))))
    kshift = ashift + _bits(aspan)
    gshift = kshift + _bits(kspan)
    narrow = (e > SHORT_MAX) & (gshift + int(_bits(e + 2)) <= 31)
    return narrow, gshift, kshift, ashift, kmin, amin


def schedule_model(ins_mask, ins_elem, ins_actor, ins_parent) -> dict:
    """elem_pos [R, E] int32, bit-equal to `kernels.linearize_plain`, by
    the kernel's algorithm, and what it ran per row: causal (the parallel
    path; False takes the walk), live (live slots), jumps (synchronous
    pointer-jumping steps that changed a pointer; the block kernel's
    in-place steps are at most these), doublings (doubling steps run
    before no pointer was left) and narrow (sorted by the narrow
    record)."""
    mask = np.asarray(ins_mask, bool)
    r, e = mask.shape
    slots = np.arange(e)
    nodes = e + 1
    live = mask.sum(1)
    p = parent_nodes(mask, np.asarray(ins_parent))
    causal = causal_rows(mask, ins_elem, ins_actor, ins_parent)

    # 2. the sort, by the wide record (hi, lo) or the narrow one (lo)
    key = np.where(mask, ins_elem, _INT32_MAX).astype(np.int64)
    act = ins_actor.astype(np.int64)
    group = np.where(causal[:, None], np.where(mask, p, e + 2), 0)
    hi = (group.astype(np.uint64) << np.uint64(32)) | (
        (key + _FLIP) & _LOW32).astype(np.uint64)
    lo = (((act + _FLIP) & _LOW32).astype(np.uint64)
          << np.uint64(32)) | slots.astype(np.uint64)
    narrow, gshift, kshift, ashift, kmin, amin = narrow_code(
        mask, ins_elem, ins_actor)
    if narrow.any():
        col = (lambda x: x[:, None])
        rec = ((group << col(gshift))
               | np.where(mask, ((key - col(kmin)) << col(kshift))
                          | ((act - col(amin)) << col(ashift)), 0)
               | slots)
        assert (rec[narrow] < 2**31).all()
        hi = np.where(narrow[:, None], np.uint64(0), hi)
        lo = np.where(narrow[:, None], rec.astype(np.uint64), lo)
    order = np.lexsort((lo, hi), axis=-1)
    s_slot = order
    s_group = np.take_along_axis(group, order, 1)

    nxt = np.full((r, nodes), -1, np.int64)
    jumps = np.zeros(r, np.int64)

    # 3. causal rows: the preorder's successors in parallel
    c = np.flatnonzero(causal)
    if c.size:
        cr = np.arange(c.size)[:, None]
        su = s_slot[c] + 1
        sg = s_group[c]
        entry = slots[None, :] < live[c, None]
        fc = np.full((c.size, nodes), -1, np.int64)
        ns = np.full((c.size, nodes), -1, np.int64)
        if e > 1:
            prev = entry[:, 1:] & (sg[:, :-1] == sg[:, 1:])
            ns[np.broadcast_to(cr, prev.shape)[prev], su[:, 1:][prev]] = \
                su[:, :-1][prev]
        nxt_g = np.concatenate([sg[:, 1:], np.full((c.size, 1), -1)], 1)
        last = entry & ((slots[None, :] == live[c, None] - 1)
                        | (nxt_g != sg))
        fc[np.broadcast_to(cr, last.shape)[last], sg[last]] = su[last]
        own = np.arange(1, nodes)[None, :]
        f = np.zeros((c.size, nodes), np.int64)
        f[:, 1:] = np.where(mask[c], np.where(ns[:, 1:] >= 0, own, p[c]), 0)
        while True:
            g = np.take_along_axis(f, f, 1)
            moved = (g != f).any(1)
            if not moved.any():
                break
            jumps[c] += moved
            f = g
        nxt[c] = np.where(fc >= 0, fc, np.where(
            f == 0, -1, np.take_along_axis(ns, f, 1)))

    # 4. other rows: the reference's walk in (key, actor, slot) order
    w = np.flatnonzero(~causal & (live > 0))
    if w.size:
        wr = np.arange(w.size)
        nw = nxt[w]
        for t in range(e):
            slot = s_slot[w, t]
            pt = p[w, slot]
            ok = pt >= 0
            node = slot + 1
            succ = nw[wr, np.minimum(pt, e)]
            nw[wr[ok], node[ok]] = succ[ok]
            put = ok & (pt <= e)
            nw[wr[put], pt[put]] = node[put]
        nxt[w] = nw

    # 5. doubling until no pointer is left, then the positions
    d = (nxt >= 0).astype(np.int64)
    doublings = np.zeros(r, np.int64)
    for _ in range(_ceil_log2(nodes)):
        on = nxt >= 0
        active = on.any(1)
        if not active.any():
            break
        doublings += active
        safe = np.maximum(nxt, 0)
        d = d + np.where(on, np.take_along_axis(d, safe, 1), 0)
        nxt = np.where(on, np.take_along_axis(nxt, safe, 1), -1)
    pos = (d[:, :1] - d[:, 1:] - 1).astype(np.int32)
    return {"elem_pos": pos, "causal": causal, "live": live,
            "jumps": jumps, "doublings": doublings, "narrow": narrow}
