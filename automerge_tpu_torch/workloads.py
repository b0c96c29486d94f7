"""Seeded change streams that drive the rows engine at the sizes its users
run: `chip_smoke.py` drives them on the card at full size, and
`scripts/torch_reference_hashes.py` runs them small through the JAX
reference to fix the hashes the port must reproduce. Also `random_rows`,
the random kernel inputs of the tests and of `chip_smoke.py`.

- `map_storm`: the reference's bench config 20 (`bench.py::
  run_megabatch_config`): a 10,000-doc fleet, 8 heavy docs of 400 `set` ops
  each, then rounds of 3,000 zipf(1.1) draws (about 1K dirty docs a round),
  each a one-op `set`. The draws replay the bench's own generator.
- `text_fleet`: concurrent typing into one text object per document, so
  the list half of the kernel (visibility, ranks, the op -> element map)
  runs: every actor types `chars` characters after its own cursor, deletes
  about one in four of them, and the changes arrive interleaved over a few
  rounds.
"""

from __future__ import annotations

import bisect
import random

import numpy as np

from .core.change import Change, Op
from .core.ids import HEAD, ROOT_ID, make_elem_id
from .engine.encode import A_DEL, A_INS, A_MOVE, A_SET
from .engine.pack import row_bases, rows_count


def _zipf_picker(n: int, s: float, rng: random.Random):
    """Doc picker with zipf(s) popularity over n docs (the bench's own)."""
    weights = [1.0 / ((k + 1) ** s) for k in range(n)]
    total = sum(weights)
    cum, acc = [], 0.0
    for w in weights:
        acc += w / total
        cum.append(acc)

    def pick() -> int:
        return min(n - 1, bisect.bisect_left(cum, rng.random()))
    return pick


def map_storm(n_docs: int = 10_000, n_heavy: int = 8, heavy_ops: int = 400,
              rounds: int = 8, draws_per_round: int = 3000,
              zipf_s: float = 1.1, seed: int = 20):
    """Returns (doc_ids, heavy_round, storm_rounds): one round of heavy
    cold docs (they set the fleet's op capacity, then stay clean), then
    `rounds` storm rounds, each {doc_id: [Change]}."""
    rng = random.Random(seed)
    n_cold = n_docs - n_heavy
    pick = _zipf_picker(n_cold, zipf_s, rng)
    heavy = [f"heavy{h:02d}" for h in range(n_heavy)]
    doc_ids = heavy + [f"doc{d:05d}" for d in range(n_cold)]
    heavy_round = {h: [Change("storm", 1, {}, [
        Op("set", ROOT_ID, key=f"k{j}", value=j) for j in range(heavy_ops)])]
        for h in heavy}
    seqs: dict[str, int] = {}
    storm = []
    for r in range(rounds):
        rnd = {}
        for d in sorted({pick() for _ in range(draws_per_round)}):
            doc = f"doc{d:05d}"
            seqs[doc] = seqs.get(doc, 0) + 1
            rnd[doc] = [Change("storm", seqs[doc], {}, [
                Op("set", ROOT_ID, key=f"f{r % 4}", value=r)])]
        storm.append(rnd)
    return doc_ids, heavy_round, storm


def text_fleet(n_docs: int = 2048,
               actors: tuple = ("alice", "bob", "carol", "dave"),
               chars: int = 48, chars_per_change: int = 4, rounds: int = 4,
               seed: int = 3):
    """Returns (doc_ids, rounds). Per doc: actors[0] creates the text (seq
    1); then every actor, concurrently (each change depends only on the
    base and the actor's own history), types `chars` characters after its
    own cursor, `chars_per_change` per change, and from its second change
    on deletes one of its earlier characters. Round k delivers the k-th
    slice of every actor's changes, the base in round 0."""
    rng = np.random.default_rng(seed)
    doc_ids = [f"text{d:05d}" for d in range(n_docs)]
    n_changes = -(-chars // chars_per_change)
    out = [dict() for _ in range(rounds)]
    bounds = np.linspace(0, n_changes, rounds + 1).astype(int)
    for doc in doc_ids:
        text = f"{doc}/text"
        base = Change(actors[0], 1, {}, [
            Op("makeText", text), Op("link", ROOT_ID, key="text",
                                     value=text)])
        per_actor = []
        for a in actors:
            seq0 = 2 if a == actors[0] else 1
            live: list[str] = []
            prev = HEAD
            chs = []
            for c in range(n_changes):
                ops = []
                if c and live:
                    gone = live.pop(int(rng.integers(len(live))))
                    ops.append(Op("del", text, key=gone))
                for k in range(c * chars_per_change + 1,
                               min(chars, (c + 1) * chars_per_change) + 1):
                    eid = make_elem_id(a, k)
                    ops.append(Op("ins", text, key=prev, elem=k))
                    ops.append(Op("set", text, key=eid,
                                  value="abcdefgh"[int(rng.integers(8))]))
                    live.append(eid)
                    prev = eid
                chs.append(Change(a, seq0 + c, {actors[0]: 1}, ops))
            per_actor.append(chs)
        for r in range(rounds):
            rnd = [base] if r == 0 else []
            for chs in per_actor:
                rnd.extend(chs[bounds[r]:bounds[r + 1]])
            out[r][doc] = rnd
    return doc_ids, out


def random_rows(rng: np.random.Generator, i: int, a: int, le: int,
                d_pad: int, n_fids: int = 6, n_lists: int = 2):
    """A random docs-minor row buffer (numpy [ROWS, d_pad] int32) and its
    dims, with values in the ranges the packer produces plus a few
    out-of-range actor ranks, so every join of the kernel fires."""
    b = row_bases(i, a, le)
    x = np.zeros((rows_count(i, a, le), d_pad), np.int32)
    full = (-2**31, 2**31 - 1)
    ranges = {"om": (i, 0, 2), "ac": (i, A_INS, A_MOVE + 1),
              "fid": (i, -1, n_fids), "act": (i, 0, a + 1),
              "seq": (i, 1, 6), "chg": (i, 0, 6), "fh": (i, *full),
              "vh": (i, *full), "co": (a * i, 0, 6), "im": (le, 0, 2),
              "if": (le, -1, n_fids), "ip": (le, 0, max(le, 1)),
              "io": (le, *full), "il": (le, 0, n_lists), "ah": (a, *full)}
    for g, (n, lo, hi) in ranges.items():
        x[b[g]:b[g] + n] = rng.integers(lo, hi, size=(n, d_pad))
    return x, (i, a, le, int(A_SET), int(A_DEL))


# Small cuts of both streams whose reference hashes are committed in
# testdata/reference_hashes.npz (scripts/torch_reference_hashes.py).
SMALL_MAP = dict(n_docs=40, n_heavy=2, heavy_ops=20, rounds=3,
                 draws_per_round=30)
SMALL_TEXT = dict(n_docs=6, chars=12, chars_per_change=3, rounds=2, seed=11)


def reference_streams():
    """[(name, doc_ids, micro-batches)]: each micro-batch is one
    apply_rounds call; the committed hashes are hashes() after the last."""
    ids, heavy, storm = map_storm(**SMALL_MAP)
    tids, trounds = text_fleet(**SMALL_TEXT)
    return [("map", ids, [[heavy], storm]), ("text", tids, [trounds])]
