"""numpy model of the move kernel's schedule (`csrc/move_round.cu`): the
CPU proof of that schedule (`tests/test_torch_moves.py` holds it to the
reference) and the rounds, doubling steps and gathers it runs, which
`chip_smoke.py` prints beside the kernel's times. No product path calls
it: the engine's routes are `engine/move_kernels.py`.

`schedule_model` runs, realm by realm, what the kernel runs: exact early
exit of the doubling, settled nodes skipped, resolved walks carried to
the next round, winners regathered only for dropped nodes, the narrow
label code, and the no-drop round reused as the final one.
"""

from __future__ import annotations

import numpy as np

from .engine.move_kernels import (F_BASE, F_CNT, F_HI, F_LO, F_MASK, F_OFF,
                                  F_PARENT, _ceil_log2, _table_hash_host)
from .engine.pack import MOVE_PRIO_PAD


def _wide_key(hi, lo):
    """The kernel's wide key of (hi, lo) int32 labels: sign bits flipped,
    hi in the high half (uint64)."""
    flip = np.uint32(0x80000000)
    return ((hi.astype(np.uint32) ^ flip).astype(np.uint64) << np.uint64(32)
            | (lo.astype(np.uint32) ^ flip).astype(np.uint64))


def narrow_code(cands):
    """Per realm, the kernel's narrow label code: (narrow, hmin, lmin,
    lbits) [D] arrays over the labels of its candidates whose hi is not
    PAD; narrow where the largest code ((hmax - hmin) << lbits | (lmax -
    lmin)) is below 0xFFFFFFFF."""
    hi = cands[:, F_HI].astype(np.int64)
    lo = cands[:, F_LO].astype(np.int64)
    real = hi != MOVE_PRIO_PAD
    big, small = np.int64(2**40), np.int64(-2**40)
    hmin = np.where(real, hi, big).min(1)
    hmax = np.where(real, hi, small).max(1)
    lmin = np.where(real, lo, big).min(1)
    lmax = np.where(real, lo, small).max(1)
    none = ~real.any(1)
    lspan = np.where(none, 0, lmax - lmin)
    hspan = np.where(none, 0, hmax - hmin)
    lbits = np.array([int(x).bit_length() for x in lspan], np.int64)
    narrow = none | ((lbits < 32) & ((hspan << lbits) + lspan < 0xFFFFFFFF))
    return (narrow, np.where(none, 0, hmin), np.where(none, 0, lmin),
            np.where(none, 0, lbits))


class _ModelRealms:
    """The kernel's state for every realm: the owned state (winner,
    label, walk state, flags) and the two (p, key) buffers, which keep
    what earlier walks left in them (the first walk finds them poisoned),
    and counters of what the schedule runs. Keys are the narrow code where
    the realm's labels fit and `narrow` allows it, else the wide key."""

    def __init__(self, nodes, cands, narrow=True):
        self.nodes, self.cands = nodes, cands
        d, _f, n = nodes.shape
        self.steps = _ceil_log2(n) + 1
        code = narrow_code(cands)
        self.narrow = code[0] & narrow
        self.code = code[1:]
        rng = np.random.default_rng(0)
        self.buf_p = rng.integers(0, n, (2, d, n)).astype(np.int32)
        self.buf_k = rng.integers(0, 2**63, (2, d, n)).astype(np.uint64)
        self.p = np.zeros((d, n), np.int32)
        self.key = np.zeros((d, n), np.uint64)
        self.parent = np.zeros((d, n), np.int32)
        self.ekey = np.zeros((d, n), np.uint64)
        self.has = np.zeros((d, n), bool)
        self.done = np.zeros((d, n), bool)
        self.again = np.zeros((d, n), bool)
        self.walks = np.zeros(d, np.int64)
        self.steps_run = np.zeros(d, np.int64)
        self.gathers = np.zeros(d, np.int64)
        self.winners = np.zeros(d, np.int64)

    def label(self, hi, lo):
        hmin, lmin, lbits = (c[:, None] for c in self.code)
        code = (((hi.astype(np.int64) - hmin) << lbits)
                + (lo.astype(np.int64) - lmin))
        code = np.where(hi == MOVE_PRIO_PAD, 0xFFFFFFFF, code)
        return np.where(self.narrow[:, None],
                        code.clip(0, 0xFFFFFFFF).astype(np.uint64),
                        _wide_key(hi, lo))

    def is_pad(self, key):
        return np.where(self.narrow[:, None], key == np.uint64(0xFFFFFFFF),
                        (key >> np.uint64(32)) == np.uint64(0xFFFFFFFF))

    def walk(self, ptr, active, first):
        """One round's walk for the `active` realms. Phase 1: a winner
        gather for every node of a first walk, later only for a node that
        dropped; a node whose last walk ended keeps its state (writing both
        buffers if only one holds it); every other node starts from its
        edge. Phase 2: doubling steps until no node of the realm has p >= 0
        or `steps` ran, a node skipping its gather and store once both
        buffers hold its ended walk. Returns cur [D], the buffer that holds
        each realm's final state."""
        nodes, cands = self.nodes, self.cands
        take = np.take_along_axis
        n = nodes.shape[2]
        act = active[:, None]
        regather = act & (np.ones_like(self.again) if first else self.again)
        mask = nodes[:, F_MASK] > 0
        cnt = nodes[:, F_CNT]
        has = mask & (ptr < cnt)
        sel = np.minimum(ptr, np.maximum(cnt - 1, 0))
        w = nodes[:, F_OFF].astype(np.int64) + sel
        w = ((w + 2**31) % 2**32 - 2**31).clip(0, cands.shape[2] - 1)
        parent = np.where(has, take(cands[:, F_PARENT], w, 1),
                          nodes[:, F_BASE])
        parent = np.where(mask, parent, -1).astype(np.int32)
        pad = np.full_like(ptr, MOVE_PRIO_PAD)
        ekey = self.label(np.where(has, take(cands[:, F_HI], w, 1), pad),
                          np.where(has, take(cands[:, F_LO], w, 1), pad))
        self.has = np.where(regather, has, self.has)
        self.parent = np.where(regather, parent, self.parent)
        self.ekey = np.where(regather, ekey, self.ekey)
        self.winners += regather.sum(1)
        carried = act & ~regather & (self.p < 0)
        fill = carried & ~self.done
        for b in (0, 1):
            self.buf_p[b] = np.where(fill, self.p, self.buf_p[b])
            self.buf_k[b] = np.where(fill, self.key, self.buf_k[b])
        fresh = act & ~carried
        self.done = np.where(carried, True, self.done)
        p = np.where(fresh, self.parent, self.p)
        key = np.where(fresh, self.ekey, self.key)
        self.buf_p[0] = np.where(fresh, p, self.buf_p[0])
        self.buf_k[0] = np.where(fresh, key, self.buf_k[0])
        settle = fresh & (p < 0)            # both buffers at once
        self.buf_p[1] = np.where(settle, p, self.buf_p[1])
        self.buf_k[1] = np.where(settle, key, self.buf_k[1])
        done = np.where(fresh, p < 0, self.done)
        cur = np.zeros(len(ptr), np.int64)
        go = active & (fresh & (p >= 0)).any(1)
        rows = np.arange(len(ptr))
        for _ in range(self.steps):
            if not go.any():
                break
            nxt = 1 - cur
            bp, bk = self.buf_p[cur, rows], self.buf_k[cur, rows]
            step = go[:, None] & ~done
            ended = p < 0
            gather = step & ~ended
            q = np.clip(p, 0, n - 1)
            nk, np_ = take(bk, q, 1), take(bp, q, 1)
            key = np.where(gather & (nk < key), nk, key)
            p = np.where(gather, np_, p)
            wp = self.buf_p[nxt, rows]
            wk = self.buf_k[nxt, rows]
            self.buf_p[nxt, rows] = np.where(step, p, wp)
            self.buf_k[nxt, rows] = np.where(step, key, wk)
            done = np.where(step, ended, done)
            self.gathers += gather.sum(1)
            self.steps_run += go
            cur = np.where(go, nxt, cur)
            go = go & (p >= 0).any(1)
        self.p = np.where(act, p, self.p)
        self.key = np.where(act, key, self.key)
        self.done = np.where(act, done, self.done)
        self.walks += active
        return cur

    def drop(self, cur):
        p = self.p
        rows = np.arange(len(p))[:, None]
        dk = self.buf_k[cur[:, None], rows, np.clip(p, 0, p.shape[1] - 1)]
        return (p >= 0) & self.has & (self.ekey == dk) & ~self.is_pad(dk)


def schedule_model(nodes, cands, ptr=None, narrow=True) -> dict:
    """numpy model of csrc/move_round.cu's schedule, realm by realm. With
    `ptr` ([D, N]), one round (move_round): {"out": [D, 3, N] int32}.
    Without it, the fixpoint (resolve_moves): the resolution schema (hash
    as np.uint32), plus per realm `rounds` (walks that looked for drops),
    `walks` (every walk run: rounds, plus one where the K + 1 round cap
    ended the loop), `capped`, `narrow` (labels in the narrow code),
    `steps` (doubling steps run), `gathers` (node steps that gathered) and
    `winners` (winner gathers from the candidates), and `steps_old` /
    `gathers_old`, the same for the plain schedule (every walk the full
    ceil(log2 N) + 1 steps over every node, and a final walk after the
    no-drop round). `narrow=False` keeps every realm in the wide key."""
    nodes = np.asarray(nodes, np.int32)
    cands = np.asarray(cands, np.int32)
    d, _f, n = nodes.shape
    m = _ModelRealms(nodes, cands, narrow)
    everyone = np.ones(d, bool)
    if ptr is not None:
        cur = m.walk(np.asarray(ptr, np.int32), everyone, True)
        drop = m.drop(cur)
        return {"out": np.stack([drop.astype(np.int32),
                                 (m.p >= 0).astype(np.int32), m.parent], 1)}
    ptr = np.zeros((d, n), np.int32)
    dropped = np.zeros(d, np.int32)
    active = everyone.copy()
    rounds = np.zeros(d, np.int64)
    for rnd in range(cands.shape[2] + 1):
        if not active.any():
            break
        cur = m.walk(ptr, active, rnd == 0)
        drop = m.drop(cur) & active[:, None]
        m.again = np.where(active[:, None], drop, m.again)
        rounds += active
        ptr = ptr + drop
        dropped = dropped + drop.sum(1).astype(np.int32)
        active &= drop.any(1)       # a round without drops is the final one
    if active.any():                # the round cap ended it
        m.walk(ptr, active, False)
    mask = nodes[:, F_MASK] > 0
    walks_old = rounds + 1
    return {"ptr": ptr, "parent": m.parent, "resolved": mask & (m.p < 0),
            "dropped": dropped, "hash": _table_hash_host(nodes, m.parent,
                                                         ptr),
            "rounds": rounds, "walks": m.walks,
            "capped": rounds == cands.shape[2] + 1, "narrow": m.narrow,
            "steps": m.steps_run, "gathers": m.gathers,
            "winners": m.winners, "steps_old": walks_old * m.steps,
            "gathers_old": walks_old * m.steps * mask.sum(1)}
