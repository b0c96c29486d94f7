"""Seeded change streams that drive the port's engines at the sizes their
users run: `chip_smoke.py` drives them on the card at full size, and
`scripts/torch_reference_hashes.py` runs them small through the JAX
reference to fix the hashes (and, for the diff plane, the records) the
port must reproduce. Also `random_rows`, `reconcile_cases`,
`random_dominated`, `random_linearize`, `causal_linearize` and
`mixed_linearize`, the random kernel inputs of the tests and of
`chip_smoke.py`.

- `map_storm`: the reference's bench config 20 (`bench.py::
  run_megabatch_config`): a 10,000-doc fleet, 8 heavy docs of 400 `set` ops
  each, then rounds of 3,000 zipf(1.1) draws (about 1K dirty docs a round),
  each a one-op `set`. The draws replay the bench's own generator.
- `text_fleet`: concurrent typing into one text object per document, so
  the list half of the kernel (visibility, ranks, the op -> element map)
  runs: every actor types `chars` characters after its own cursor, deletes
  about one in four of them, and the changes arrive interleaved over a few
  rounds. `text_fleet_acks` is a round in which every typist acknowledges
  the others, after which compaction can reclaim the tombstones.

- `long_lived_frame` / `long_lived_changes`: the corpus of the reference's
  bench config 15 (`bench.py::run_bootstrap_config`): 1,024 documents, doc
  j written by one of 4 writers (`w{j % 4:02d}`), its change s a `set` of
  root key `k{(s * 7) % 64}` to s, so a doc's history overwrites 64 fields
  again and again. `long_lived_frame(s)` is the AMR1 round frame of every
  doc's change s, built straight from numpy columns (byte-equal to
  `encode_round_frame` of the same changes).

The docs-major engine's workload:

- `docset_fleet`: the reference's bench config 5 (`bench.py::gen_docset`
  with the rounds of `run_resident_rounds`): 10,000 documents, each a
  2-actor concurrent map merge (A sets `n`, `tag` and a nested `flags`
  map, then `n` again; B, concurrently, `n` and `owner`: 3 changes, 8
  ops), then 12 rounds in which the same 20% of the documents (2,000,
  the bench's own draw) each receive one `set` of `n` by a third actor,
  "bench". The one difference from the bench: the nested map's object id
  is derived from the document's index, where the bench's frontend draws
  a random UUID.

- `lww_storm`, `trellis`, `text_trace`, `tombstone_list`
  (`BENCH_CONFIGS`): the reference's bench configs 1-4 (`bench.py:123-205`)
  replayed through the port's document API on the CPU: one document of
  2,000 LWW `set`s over 50 keys, a nested card board of 8 actors, a
  3-actor text trace of 300 edits, a 400-op tombstone-heavy list. The row
  wires and field sharding run on them.

The batched planes' workloads (span tables and move realms):

- `span_bulk_merge`: the reference's bench config 10 (`bench.py::
  run_bulk_merge_config`): one 1,000,000-char document, two sides at 1%
  concurrency (10,000 char ops each, bursts of 8-32 chars, p_delete
  0.12), merged as one span table.
- `span_fleet`: config 10's small-doc shape (4,096-char bases, max(8, 1%)
  char ops per side), widened to a fleet merged as one dispatch.
- `move_storm`: the storm of bench config 16(b) (`bench.py::
  run_move_config`): 1,536 mutually concurrent reparents of 1,600 map
  objects by 7 writers, built directly as the realm the reference's
  `_build_map_problem` makes of it; `move_fleet` is many such realms.

A span table depends only on the base length and the edit events, so the
generators replay the bench's event draws (`divergent_side_events`) and
build the table from them (`merge_table_from_events`) without building
any document.
"""

from __future__ import annotations

import bisect
import random
import struct

import numpy as np

from .core.change import Change, Op
from .core.ids import HEAD, ROOT_ID, make_elem_id
from .core.moves import MoveProblem
from .core.textspans import merge_table
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


LONG_LIVED_WRITERS = 4
LONG_LIVED_FIELDS = 64


def long_lived_changes(j: int, lo: int, hi: int) -> list:
    """Doc j's changes with seqs lo..hi (inclusive) of the long-lived
    fleet, as Change objects."""
    a = f"w{j % LONG_LIVED_WRITERS:02d}"
    return [Change(a, s, {}, [Op("set", ROOT_ID,
                                 key=f"k{(s * 7) % LONG_LIVED_FIELDS}",
                                 value=s)])
            for s in range(lo, hi + 1)]


def long_lived_frame(doc_ids: list, s: int) -> bytes:
    """The AMR1 round frame of change s of every doc of the long-lived
    fleet (doc_ids[j] is doc j), one change a doc."""
    from .native.wire import V_INT, WireColumns
    from .storage import _ACTION_IDX
    from .sync.frames import ROUND_MAGIC, _blob, columns_to_bytes

    n = len(doc_ids)
    w = min(n, LONG_LIVED_WRITERS)
    cols = WireColumns(
        change_actor=(np.arange(n) % LONG_LIVED_WRITERS).astype(np.int32),
        change_seq=np.full(n, s, np.int32),
        change_msg=np.full(n, -1, np.int32),
        deps_off=np.zeros(n + 1, np.int32),
        deps_actor=np.zeros(0, np.int32), deps_seq=np.zeros(0, np.int32),
        op_off=np.arange(n + 1, dtype=np.int32),
        op_action=np.full(n, _ACTION_IDX["set"], np.int8),
        op_obj=np.zeros(n, np.int32), op_key=np.zeros(n, np.int32),
        op_elem=np.full(n, -1, np.int32),
        op_vtag=np.full(n, V_INT, np.int8),
        op_vint=np.full(n, s, np.int64),
        op_vdbl=np.zeros(n, np.float64), op_vstr=np.full(n, -1, np.int32),
        actors=[f"w{k:02d}" for k in range(w)], objects=[ROOT_ID],
        keys=[f"k{(s * 7) % LONG_LIVED_FIELDS}"], messages=[], strings=[])
    id_off, id_blob = _blob(list(doc_ids))
    return b"".join([ROUND_MAGIC, struct.pack("<I", n),
                     np.arange(n + 1, dtype=np.int32).tobytes(),
                     id_off.tobytes(), id_blob, columns_to_bytes(cols)])


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


def text_fleet_acks(rounds) -> dict:
    """One change per actor per doc of a text fleet's rounds that
    acknowledges every other actor's last change (its deps: their heads),
    so that each doc's causal floor passes the typing and its tombstones
    (compaction can then reclaim them)."""
    heads: dict = {}
    for rnd in rounds:
        for d, chs in rnd.items():
            h = heads.setdefault(d, {})
            for c in chs:
                h[c.actor] = max(h.get(c.actor, 0), c.seq)
    return {d: [Change(a, s + 1, {b: t for b, t in h.items() if b != a},
                       [Op("set", ROOT_ID, key=f"seen-{a}", value=s)])
                for a, s in sorted(h.items())]
            for d, h in heads.items()}


def docset_fleet(n_docs: int = 10_000, rounds: int = 12,
                 fraction: float = 0.2, seed: int = 3):
    """Returns (doc_ids, initial, rounds): `initial` is {doc_id: [Change]}
    with each document's three changes, `rounds` a list of {doc_id:
    [Change]}. The changes are built from their wire dicts (the reference
    frontend's own shape for this history). "bench" sorts after "A" and
    "B", so its first round re-registers the actors (the remap keeps
    their ranks) and grows the actor capacity mid-stream."""
    doc_ids = [f"d{i}" for i in range(n_docs)]
    initial = {}
    for i, doc in enumerate(doc_ids):
        flags = f"{i:08x}-0005-4000-8000-000000000000"

        def setop(obj, key, value):
            return {"action": "set", "obj": obj, "key": key, "value": value}
        initial[doc] = [Change.from_dict(c) for c in (
            {"actor": "A", "seq": 1, "deps": {}, "ops": [
                setop(ROOT_ID, "n", i), setop(ROOT_ID, "tag", f"t{i % 7}"),
                {"action": "makeMap", "obj": flags},
                setop(flags, "hot", i % 2 == 0),
                {"action": "link", "obj": ROOT_ID, "key": "flags",
                 "value": flags}]},
            {"actor": "A", "seq": 2, "deps": {}, "ops": [
                setop(ROOT_ID, "n", i + 1)]},
            {"actor": "B", "seq": 1, "deps": {"A": 1}, "ops": [
                setop(ROOT_ID, "n", -i), setop(ROOT_ID, "owner", "B")]})]
    changed = random.Random(seed).sample(range(n_docs),
                                         max(1, int(n_docs * fraction)))
    out = []
    for r in range(rounds):
        deps = {"A": 2, "B": 1} if r == 0 else {}
        out.append({doc_ids[i]: [Change.from_dict({
            "actor": "bench", "seq": r + 1, "deps": deps, "ops": [{
                "action": "set", "obj": ROOT_ID, "key": "n",
                "value": r * 1000 + i}]})] for i in changed})
    return doc_ids, initial, out


# ---------------------------------------------------------------------------
# The reference's bench configs 1-4 (`bench.py:123-205`), built through the
# port's document API on the CPU (the changes are the workload; where a
# run sends them is the caller's). Each returns a list of per-document
# change lists, as the bench's generators do; with both packages' uuid
# factories set alike, the changes are the bench's own.


def _doc_api():
    from . import api
    from .frontend.text import Text

    def init(actor):
        return api.init(actor, device="cpu")
    return api, init, Text


def lww_storm(n_ops_per_actor: int = 1000) -> list:
    """Config 1: one document, 2 actors x N concurrent `set`s over 50 keys
    (LWW registers)."""
    api, init, _ = _doc_api()
    docs = []
    for actor in ("A", "B"):
        d = init(actor)
        for i in range(n_ops_per_actor):
            d = api.change(d, lambda doc, i=i, actor=actor: doc.__setitem__(
                f"k{i % 50}", f"{actor}{i}"))
        docs.append(d)
    merged = api.merge(docs[0], docs[1])
    return [merged._doc.opset.get_missing_changes({})]


def trellis(n_docs: int = 1) -> list:
    """Config 2: a nested JSON card board, 8 actors adding cards to one
    list concurrently, half of them marking the first card done."""
    api, init, _ = _doc_api()
    out = []
    for _ in range(n_docs):
        base = api.change(init("base"), lambda d: d.__setitem__(
            "board", {"lists": [{"title": "todo", "cards": []},
                                {"title": "done", "cards": []}]}))
        replicas = []
        for i in range(8):
            r = api.merge(init(f"actor{i}"), base)
            for j in range(5):
                r = api.change(r, lambda d, i=i, j=j: d["board"]["lists"][0][
                    "cards"].append({"title": f"card {i}.{j}", "done": False}))
            if i % 2 == 0:
                r = api.change(r, lambda d: d["board"]["lists"][0]["cards"][0]
                               .__setitem__("done", True))
            replicas.append(r)
        m = replicas[0]
        for r in replicas[1:]:
            m = api.merge(m, r)
        out.append(m._doc.opset.get_missing_changes({}))
    return out


def text_trace(n_edits: int = 300) -> list:
    """Config 3: a 3-actor concurrent character insert/delete trace on one
    text object, the replicas merging now and then."""
    api, init, Text = _doc_api()
    rng = random.Random(42)

    def mk(doc):
        doc["t"] = Text()
        doc["t"].insert_at(0, *"the quick brown fox")
    base = api.change(init("base"), mk)
    replicas = {a: api.merge(init(a), base) for a in ("A", "B", "C")}
    for step in range(n_edits):
        a = rng.choice("ABC")
        d = replicas[a]
        n = len(d["t"])
        if rng.random() < 0.7 or n == 0:
            pos = rng.randint(0, n)
            ch = rng.choice("abcdefgh ")
            d = api.change(d, lambda doc: doc["t"].insert_at(pos, ch))
        else:
            pos = rng.randint(0, n - 1)
            d = api.change(d, lambda doc: doc["t"].delete_at(pos))
        replicas[a] = d
        if step % 40 == 0:
            other = rng.choice([x for x in "ABC" if x != a])
            replicas[a] = api.merge(replicas[a], replicas[other])
    m = api.merge(api.merge(replicas["A"], replicas["B"]), replicas["C"])
    return [m._doc.opset.get_missing_changes({})]


def tombstone_list(n_ops: int = 400) -> list:
    """Config 4: a tombstone-heavy list history by one actor."""
    api, init, _ = _doc_api()
    rng = random.Random(7)
    d = api.change(init("A"), lambda doc: doc.__setitem__("xs", []))
    for _ in range(n_ops):
        n = len(d["xs"])
        if rng.random() < 0.55 or n < 2:
            pos = rng.randint(0, n)
            d = api.change(d, lambda doc: doc["xs"].insert_at(
                pos, rng.randint(0, 99)))
        else:
            pos = rng.randint(0, n - 1)
            d = api.change(d, lambda doc: doc["xs"].delete_at(pos))
    return [d._doc.opset.get_missing_changes({})]


#: bench configs 1-4 by number (config 5 is `docset` / `docset_fleet`)
BENCH_CONFIGS = {1: lww_storm, 2: trellis, 3: text_trace, 4: tombstone_list}


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


# The reconcile kernel's named cases: (I, A, LE, lanes) and what each one
# holds the kernel to.
RECONCILE_CASES = {
    "base": (64, 4, 64, 1024),            # random lanes, base envelope
    "xl_only": (512, 8, 512, 1024),       # past the base envelope, XL only
    "heavy_lane": (512, 2, 8, 1024),      # the map storm's shape
    "all_live": (256, 4, 64, 256),        # every op slot live
    "zero_ops": (64, 4, 32, 256),         # most lanes hold no op at all
    "no_elements": (64, 4, 0, 256),       # LE = 0
    "one_actor": (64, 1, 32, 256),        # A = 1
    "max_dims": (1024, 9, 1024, 256),     # I = LE = 1,024
    "tiled": (1024, 64, 1024, 128),       # a lane past the shared memory
    "long_list": (64, 4, 16384, 8),       # a lane that needs a whole block
    # the megabatch route's bucket dims (engine/dispatch.py
    # apply_round_adaptive): small op bands, LE = 0 in a fleet whose LE is
    # 8, lane counts from 128
    "bucket_one_op": (8, 2, 0, 1024),     # the map storm's one-op docs
    "bucket_small": (8, 2, 8, 128),       # one small list a doc
    "bucket_mid": (16, 4, 256, 256),      # a short op band, long lists
    "bucket_wide_ops": (64, 2, 8, 1024),  # a mid op band, XL-capable
}


def reconcile_case(name: str, seed: int = 0):
    """The row buffer (numpy [ROWS, lanes] int32) and dims of one of
    RECONCILE_CASES: random lanes (random_rows), reshaped where the name
    says. "heavy_lane": near-empty lanes (0-3 live ops) with every 128th
    lane holding 400 live `set`s on distinct fields, so no op is dominated
    and no walk ends early. "all_live": every op slot live. "zero_ops":
    three lanes in four hold no op. "tiled": enough actors that a lane's
    live ops and their clock rows do not fit one block's shared memory.
    "long_list": enough elements that a lane's per-slot state does not fit
    a quarter of a block's shared memory, so a block holds one lane.
    "bucket_*": random lanes at the megabatch route's bucket dims."""
    i, a, le, d = RECONCILE_CASES[name]
    rng = np.random.default_rng(seed)
    x, dims = random_rows(rng, i, a, le, d, n_fids=16, n_lists=4)
    b = row_bases(i, a, le)
    om = x[b["om"]:b["om"] + i]
    if name == "heavy_lane":
        n_live = rng.integers(0, 4, size=d)
        n_live[::128] = 400
        om[:] = np.arange(i)[:, None] < n_live[None]
        x[b["ac"]:b["ac"] + i] = A_SET
        x[b["fid"]:b["fid"] + i] = np.arange(i)[:, None]
        x[b["act"]:b["act"] + i] = 0
        x[b["chg"]:b["chg"] + i] = 0
    elif name == "all_live":
        om[:] = 1
        x[b["ac"]:b["ac"] + i] = rng.integers(A_SET, A_MOVE + 1, size=(i, d))
    elif name == "zero_ops":
        om[:, rng.random(d) < 0.75] = 0
    return x, dims


def random_dominated(rng: np.random.Generator, d: int, n: int, a: int,
                     full_range: bool = False):
    """Random inputs of the domination kernel (numpy clock_op [d, n, a],
    actor, fid, seq, change_idx [d, n] int32, amask [d, n] bool). Few
    fields and changes per document so that pairs meet; some actors fall
    outside [0, a). With full_range, clock and seq values span the whole
    int32 range and a third of the seqs sit within one of a clock value
    the op's pairs read."""
    fids = max(2, n // 8)
    if full_range:
        lo, hi = -2**31, 2**31
        clock = rng.integers(lo, hi, size=(d, n, a), dtype=np.int64)
        seq = rng.integers(lo, hi, size=(d, n), dtype=np.int64)
    else:
        clock = rng.integers(0, 6, size=(d, n, a))
        seq = rng.integers(1, 6, size=(d, n))
    actor = rng.integers(-1, a + 1, size=(d, n))
    if full_range:
        j = rng.integers(0, n, size=(d, n))
        ok = np.clip(actor, 0, a - 1)
        near = clock[np.arange(d)[:, None], j, ok] \
            + rng.integers(-1, 2, size=(d, n))
        seq = np.where(rng.random((d, n)) < 1 / 3,
                       np.clip(near, -2**31, 2**31 - 1), seq)
    return (clock.astype(np.int32), actor.astype(np.int32),
            rng.integers(0, fids, size=(d, n)).astype(np.int32),
            seq.astype(np.int32),
            rng.integers(0, max(2, n // 4), size=(d, n)).astype(np.int32),
            rng.random((d, n)) < 0.8)


# The linearize kernel's cases (R rows, E slots): E = 1, 8, 256 (the text
# fleet's), 257 (not a power of two), 4,096, 9,000 (past a block's shared
# memory: the global scratch) and 20,000 short rows.
LINEARIZE_CASES = ((64, 1), (512, 8), (512, 256), (64, 257), (4, 4096),
                   (2, 9000), (20_000, 8))


def random_linearize(rng: np.random.Generator, r: int, e: int):
    """Random inputs of `linearize` (numpy ins_mask [r, e] bool, ins_elem,
    ins_actor, ins_parent [r, e] int32), a kind of row by r % 4: 0 an RGA
    list as the encoder builds it (distinct counters, each parent an
    earlier slot or the head), 1 random parents in [-2, e + 3) (some past
    the array: detached nodes, self-loops) with few distinct elements and
    actors (equal keys), 2 all masked, 3 every slot live with one element
    and actor (every key equal). Other rows mask about a quarter of their
    slots."""
    mask = rng.random((r, e)) < 0.75
    elem = rng.integers(0, 4, size=(r, e))
    actor = rng.integers(0, 3, size=(r, e))
    parent = rng.integers(-2, e + 3, size=(r, e))
    kind = np.arange(r) % 4
    rga = kind == 0
    slots = np.arange(e)
    elem[rga] = slots + 1
    parent[rga] = np.floor(rng.random((int(rga.sum()), e))
                           * (slots + 1)).astype(np.int64) - 1
    mask[kind == 2] = False
    mask[kind == 3] = True
    elem[kind == 3] = 7
    actor[kind == 3] = 1
    return (mask, elem.astype(np.int32), actor.astype(np.int32),
            parent.astype(np.int32))


# Shapes of the linearize kernel's causal cases (causal_linearize, and
# mixed_linearize's batches of causal and other rows in one launch): a
# warp slice a row, a block a row, and E = 9,000 past a block's shared
# memory (the global scratch).
LINEARIZE_CAUSAL_CASES = ((512, 8), (256, 256), (4, 4096), (2, 9000))


def causal_linearize(rng: np.random.Generator, r: int, e: int):
    """Random causal inputs of `linearize` (as random_linearize's): every
    live slot's parent is the head or a live slot earlier in (elem, actor,
    slot) order, the rows the engine builds from change streams. A kind of
    row by r % 4: 0 a random tree over about three quarters of the slots
    (few distinct elements and actors: equal keys broken by the actor or
    the slot), 1 the same with every slot live, 2 every live slot a child
    of the head, 3 a single chain. Masked slots keep random parents. In
    rows r % 8 >= 4 elements and actors are spread over the int32 range
    (the same order), so the kernel sorts them by its wide record."""
    mask = (rng.random((r, e)) < 0.75) | (np.arange(r) % 4 != 0)[:, None]
    elem = rng.integers(0, max(2, e // 4), size=(r, e))
    actor = rng.integers(0, 4, size=(r, e))
    parent = rng.integers(-2, e + 3, size=(r, e))
    key = np.where(mask, elem, 2**31 - 1)
    order = np.lexsort((np.broadcast_to(np.arange(e), (r, e)), actor, key),
                       axis=-1)
    kind = np.arange(r) % 4
    for i in range(r):
        live = order[i, :int(mask[i].sum())]
        if kind[i] == 2:
            pick = np.full(live.size, -1)
        elif kind[i] == 3:
            pick = np.arange(live.size) - 1
        else:
            pick = np.floor(rng.random(live.size)
                            * (np.arange(live.size) + 1)).astype(int) - 1
        parent[i, live] = np.where(pick >= 0, live[np.maximum(pick, 0)], -1)
    wide = np.arange(r) % 8 >= 4
    elem[wide] = _spread(elem[wide], max(2, e // 4))
    actor[wide] = _spread(actor[wide], 4)
    return (mask, elem.astype(np.int32), actor.astype(np.int32),
            parent.astype(np.int32))


def _spread(x: np.ndarray, n: int) -> np.ndarray:
    """Values in [0, n) mapped in order over the int32 range."""
    return x.astype(np.int64) * ((2**32 - 1) // n) - 2**31


def mixed_linearize(rng: np.random.Generator, r: int, e: int):
    """causal_linearize's rows and random_linearize's, interleaved (even
    rows causal), so both of the kernel's paths share one launch; the
    elements and actors of every other random row are spread over the
    int32 range (the kernel's wide record on the walk)."""
    causal = causal_linearize(rng, (r + 1) // 2, e)
    other = list(random_linearize(rng, r // 2, e))
    for k, n in ((1, 4), (2, 3)):
        other[k][1::2] = _spread(other[k][1::2], n)
    out = []
    for c, o in zip(causal, other):
        x = np.empty((r, e), c.dtype)
        x[0::2], x[1::2] = c, o
        out.append(x)
    return tuple(out)


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


# Small cuts of the docs-major engine's workloads whose reference hashes
# are committed in testdata/reference_hashes.npz: the docset fleet at 512
# docs with all 12 rounds, and the text fleet at 64 docs.
SMALL_DOCSET = dict(n_docs=512)
SMALL_DOCS_TEXT = dict(n_docs=64)


def reference_docs_streams():
    """[(name, doc_ids, rounds)]: each round is one ResidentDocSet.
    apply_and_reconcile call; the committed hashes are hashes() after the
    last, under "docs_<name>"."""
    ids, initial, rounds = docset_fleet(**SMALL_DOCSET)
    tids, trounds = text_fleet(**SMALL_DOCS_TEXT)
    return [("docset", ids, [initial] + rounds), ("text", tids, trounds)]


def reference_diff_streams():
    """[(name, doc_ids, rounds)]: each round is one ResidentDocSet.
    apply_and_reconcile(..., diffs=True) call, and the committed records
    (testdata/reference_diffs.json) are each round's {doc_id: records}.
    The streams of reference_docs_streams, each with one more round: on
    the docset fleet a new actor "C" (it sorts between "B" and "bench",
    so the actor ranks remap) moves every 64th document's nested map from
    root "flags" to root "moved" (a map move); on the text fleet alice
    moves bob's third character after carol's fifth in every 8th document
    (a list move)."""
    (_, ids, rounds), (_, tids, trounds) = reference_docs_streams()
    moves = {}
    for i in range(0, len(ids), 64):
        flags = f"{i:08x}-0005-4000-8000-000000000000"
        moves[ids[i]] = [Change("C", 1, {"A": 2, "B": 1}, [
            Op("move", ROOT_ID, key="moved", value=flags)])]
    n_changes = 12  # text_fleet's defaults: 48 chars, 4 a change
    list_moves = {}
    for i in range(0, len(tids), 8):
        text = f"{tids[i]}/text"
        list_moves[tids[i]] = [Change(
            "alice", n_changes + 2,
            {a: n_changes for a in ("bob", "carol", "dave")},
            [Op("move", text, key=make_elem_id("carol", 5),
                value=make_elem_id("bob", 3), elem=49)])]
    return [("docset", ids, rounds + [moves]),
            ("text", tids, trounds + [list_moves])]


# ---------------------------------------------------------------------------
# span tables (the text-merge plane)

# the text object of the bench's generated load logs (configs 6 and 10)
TEXT_OBJ_ID = "11111111-2222-3333-4444-555555555555"


def text_load_log(n_edits: int = 65536, seed: int = 11,
                  variant: str = "random", actor: str = "A",
                  with_state: bool = False):
    """A single-actor text change log as JSON, the bench's
    `gen_text_load_log` (configs 6 and 10) draw for draw: returns
    (json_str, visible_len), or with `with_state` (json_str,
    visible_elem_ids, max_elem, n_changes).

    Variants: "random" (75% single-char inserts at uniform positions, 25%
    deletes), "delete_heavy" (50/50), "paste_burst" (bursts of 2..24 chars,
    one change a burst, 78% appended, ~17% pasted at random positions, 5%
    range deletes). A burst's elements enter the visible index in one
    slice, which keeps the paste_burst log at millions of characters
    linear-ish; the output is the bench's."""
    import json

    rng = random.Random(seed)
    tid = TEXT_OBJ_ID
    seq: list = []
    elem = 0
    changes = [{"actor": actor, "seq": 1, "deps": {}, "ops": [
        {"action": "makeText", "obj": tid},
        {"action": "link", "obj": ROOT_ID, "key": "t", "value": tid}]}]
    cseq = 1

    def burst_ops(pos, length):
        nonlocal elem
        ops, eids = [], []
        parent = seq[pos - 1] if pos else "_head"
        for _ in range(length):
            elem += 1
            eid = f"{actor}:{elem}"
            ops.append({"action": "ins", "obj": tid, "key": parent,
                        "elem": elem})
            ops.append({"action": "set", "obj": tid, "key": eid,
                        "value": rng.choice("abcdefgh ")})
            eids.append(eid)
            parent = eid
        seq[pos:pos] = eids
        return ops

    if variant in ("random", "delete_heavy"):
        p_ins = 0.75 if variant == "random" else 0.5
        for _ in range(n_edits):
            cseq += 1
            if rng.random() < p_ins or not seq:
                pos = rng.randint(0, len(seq))
                parent = seq[pos - 1] if pos else "_head"
                elem += 1
                eid = f"{actor}:{elem}"
                ops = [{"action": "ins", "obj": tid, "key": parent,
                        "elem": elem},
                       {"action": "set", "obj": tid, "key": eid,
                        "value": rng.choice("abcdefgh ")}]
                seq.insert(pos, eid)
            else:
                eid = seq.pop(rng.randrange(len(seq)))
                ops = [{"action": "del", "obj": tid, "key": eid}]
            changes.append({"actor": actor, "seq": cseq, "deps": {},
                            "ops": ops})
    elif variant == "paste_burst":
        edits = 0
        while edits < n_edits:
            cseq += 1
            r = rng.random()
            if r < 0.05 and seq:
                k = min(rng.randint(1, 24), len(seq), n_edits - edits)
                at = rng.randrange(len(seq) - k + 1)
                ops = [{"action": "del", "obj": tid, "key": eid}
                       for eid in seq[at:at + k]]
                del seq[at:at + k]
                edits += k
            else:
                k = min(rng.randint(2, 24), n_edits - edits)
                pos = len(seq) if r < 0.83 else rng.randint(0, len(seq))
                ops = burst_ops(pos, k)
                edits += k
            changes.append({"actor": actor, "seq": cseq, "deps": {},
                            "ops": ops})
    else:
        raise ValueError(f"unknown variant {variant!r}")
    wire = json.dumps(changes)
    if with_state:
        return wire, seq, elem, cseq
    return wire, len(seq)


def divergent_side(base_seq, base_max_elem: int, n_base_changes: int,
                   base_actor: str, actor: str, n_char_ops: int, seed: int,
                   burst=(8, 32), p_delete: float = 0.12):
    """One side of a divergent text history (config 10), the bench's
    `gen_divergent_side`: change dicts by `actor` forked off a generated
    base document (the first depends on the base's whole clock); bursts
    chain-insert 8..32 chars anchored at base positions, deletes remove
    contiguous windows of base characters. Returns (changes, events), the
    events those of divergent_side_events."""
    rng = random.Random(seed)
    elem = base_max_elem
    changes, events = [], []
    cseq = 0
    done = 0
    while done < n_char_ops:
        cseq += 1
        deps = {base_actor: n_base_changes} if cseq == 1 else {}
        if rng.random() < p_delete and base_seq and done:
            k = min(rng.randint(2, 16), n_char_ops - done, len(base_seq))
            at = rng.randrange(len(base_seq) - k + 1)
            ops = [{"action": "del", "obj": TEXT_OBJ_ID, "key": eid}
                   for eid in base_seq[at:at + k]]
            events.append(("del", at, k))
            done += k
        else:
            k = min(rng.randint(*burst), n_char_ops - done)
            pos = rng.randint(0, len(base_seq))
            parent = base_seq[pos - 1] if pos else "_head"
            head = elem + 1
            ops = []
            for _ in range(k):
                elem += 1
                eid = f"{actor}:{elem}"
                ops.append({"action": "ins", "obj": TEXT_OBJ_ID,
                            "key": parent, "elem": elem})
                ops.append({"action": "set", "obj": TEXT_OBJ_ID,
                            "key": eid, "value": "abcdefgh "[elem % 9]})
                parent = eid
            events.append(("ins", pos, head, k))
            done += k
        changes.append({"actor": actor, "seq": cseq, "deps": deps,
                        "ops": ops})
    return changes, events


# config 10's sibling ranks and origin hashes of its two sides
SPAN_ARANK = {"C": 2, "B": 1}
SPAN_ORIGINS = {"C": 2, "B": 3}


def divergent_side_events(base_len: int, base_max_elem: int,
                          n_char_ops: int, seed: int, burst=(8, 32),
                          p_delete: float = 0.12) -> list:
    """The edit events of one side of a divergent text history, with the
    rng draws of the bench's `gen_divergent_side`: bursts chain-insert
    8..32 chars anchored at base positions, deletes remove contiguous
    windows of base characters. Returns ("ins", base_pos, head_elem, len)
    and ("del", base_pos, len) events; element counters continue from
    `base_max_elem`."""
    rng = random.Random(seed)
    elem = base_max_elem
    events = []
    done = 0
    while done < n_char_ops:
        if rng.random() < p_delete and base_len and done:
            k = min(rng.randint(2, 16), n_char_ops - done, base_len)
            at = rng.randrange(base_len - k + 1)
            events.append(("del", at, k))
        else:
            k = min(rng.randint(*burst), n_char_ops - done)
            pos = rng.randint(0, base_len)
            events.append(("ins", pos, elem + 1, k))
            elem += k
        done += k
    return events


def merge_table_from_events(base_len: int, side_events: dict, arank: dict,
                            origins: dict):
    """The merge span table of a base of `base_len` chars and the sides'
    events (the bench's `_merge_table_from_events`): the base is cut at
    every concurrent anchor and deletion boundary, each region between
    cuts is one row (vis_len 0 when the merge deletes it), and each
    concurrent burst is one row with its head element's sibling priority.
    Returns (rows, n_base_rows, n_concurrent_rows, expected_visible_len).

    Every deletion window's ends are cuts, so a region between two cuts
    is deleted whole or not at all."""
    cuts = {0, base_len}
    deleted = set()
    for events in side_events.values():
        for ev in events:
            if ev[0] == "ins":
                cuts.add(ev[1])
            else:
                _, at, k = ev
                cuts.update((at, at + k))
                deleted.update(range(at, at + k))
    bounds = sorted(cuts)
    base_spans, gap_of = [], {0: -1}
    for lo, hi in zip(bounds, bounds[1:]):
        base_spans.append((1, lo + 1, 0 if lo in deleted else hi - lo))
        gap_of[hi] = len(base_spans) - 1
    blocks = []
    inserted = 0
    for side, events in side_events.items():
        for ev in events:
            if ev[0] == "ins":
                _, pos, head, k = ev
                blocks.append((gap_of[pos], head, arank[side],
                               [(origins[side], head, k)]))
                inserted += k
    rows = merge_table(base_spans, blocks)
    return rows, len(base_spans), len(blocks), \
        base_len - len(deleted) + inserted


def _divergent_table(base_len: int, n_side: int, seeds: tuple):
    """(rows, expected visible length) of one document whose base was
    typed as elements 1..base_len by one actor."""
    ev_c = divergent_side_events(base_len, base_len, n_side, seeds[0])
    ev_b = divergent_side_events(base_len, base_len, n_side, seeds[1])
    rows, _nb, _nc, expected = merge_table_from_events(
        base_len, {"C": ev_c, "B": ev_b}, SPAN_ARANK, SPAN_ORIGINS)
    return rows, expected


def span_bulk_merge(base_len: int = 1_000_000, concurrency: float = 0.01,
                    seeds: tuple = (21, 22)):
    """Config 10's bulk merge: returns ([rows], [expected visible
    length]) for one document."""
    rows, expected = _divergent_table(
        base_len, int(round(base_len * concurrency)), seeds)
    return [rows], [expected]


def span_fleet(n_docs: int = 10_000, base_len: int = 4096,
               concurrency: float = 0.01):
    """Config 10's small-doc shape over a fleet: document i's sides use
    the bench's seeds 300 + i and 600 + i. Returns (tables, expected
    visible lengths)."""
    n_side = max(8, int(round(base_len * concurrency)))
    tables, expected = [], []
    for i in range(n_docs):
        rows, exp = _divergent_table(base_len, n_side, (300 + i, 600 + i))
        tables.append(rows)
        expected.append(exp)
    return tables, expected


def random_span_tables(rng: np.random.Generator, n_docs: int, n_spans: int,
                       full_range: bool = False) -> list:
    """Random span tables of exactly `n_spans` rows. With `full_range`
    every column takes any int32 value (the sort keys' negation wraps,
    the sums overflow); otherwise the ranges of a real merge table."""
    if full_range:
        cols = rng.integers(-2**31, 2**31, size=(n_docs, n_spans, 7))
    else:
        cols = np.stack([
            rng.integers(1, 1 << 20, (n_docs, n_spans)),
            rng.integers(0, 1 << 20, (n_docs, n_spans)),
            rng.integers(0, 60, (n_docs, n_spans)),
            rng.integers(-1, 2 * n_spans, (n_docs, n_spans)),
            rng.integers(0, 1 << 15, (n_docs, n_spans)),
            rng.integers(0, 64, (n_docs, n_spans)),
            np.broadcast_to(np.arange(n_spans), (n_docs, n_spans))], -1)
    return [[tuple(int(v) for v in row) for row in doc] for doc in cols]


# ---------------------------------------------------------------------------
# move realms (the move plane)


def move_storm_ops(n_objs: int = 1600, n_moves: int = 1536,
                   writers: int = 7, seed: int = 16) -> list:
    """The draws of bench config 16(b)'s storm: `n_moves` distinct objects
    each moved once under a random other object, writer j % `writers`
    issuing move j as the next seq of its chain on the base. Returns
    [(writer, seq, dst, moved)] in the order the moves are made."""
    rng = random.Random(seed)
    movers = rng.sample(range(n_objs), n_moves)
    wseq: dict[str, int] = {}
    out = []
    for j, m in enumerate(movers):
        dst = rng.randrange(n_objs)
        while dst == m:
            dst = rng.randrange(n_objs)
        w = f"w{j % writers}"
        wseq[w] = wseq.get(w, 0) + 1
        out.append((w, wseq[w], dst, m))
    return out


def storm_key(obj: int) -> str:
    """The storm's object id for object number `obj`."""
    return f"o{obj:05d}"


def move_storm_changes(n_objs: int = 1600, n_moves: int = 1536,
                       writers: int = 7, seed: int = 16):
    """The storm of bench config 16(b) as changes: (base, storm). `base` is
    one change by "A" that makes `n_objs` maps and links each under the
    root at its own key; `storm` is one change a move (move_storm_ops),
    writer w's seq-s change depending on the base and on w's seq s-1, so
    every cross-writer pair is concurrent. Admitted by an OpSet, the map
    realm it resolves is move_storm's."""
    ops = []
    for i in range(n_objs):
        ops.append(Op("makeMap", storm_key(i)))
        ops.append(Op("link", ROOT_ID, key=storm_key(i), value=storm_key(i)))
    base = Change("A", 1, {}, ops)
    storm = []
    for j, (w, s, dst, m) in enumerate(
            move_storm_ops(n_objs, n_moves, writers, seed)):
        deps = {"A": 1, **({w: s - 1} if s > 1 else {})}
        storm.append(Change(w, s, deps, [Op("move", storm_key(dst),
                                            key=f"sub{j}",
                                            value=storm_key(m))]))
    return base, storm


def move_storm(n_objs: int = 1600, n_moves: int = 1536, writers: int = 7,
               seed: int = 16) -> MoveProblem:
    """The map realm of one storm (move_storm_ops), as the reference's
    `_build_map_problem` builds it after admitting the storm: every moved
    object and every destination is a node, every base edge is the root
    link (-1), and each moved object has its one move as candidate with
    priority (lamport, (writer, moved-id)); the lamport clock of a
    writer's seq-s change on the base is s."""
    p = MoveProblem()
    ops = move_storm_ops(n_objs, n_moves, writers, seed)
    for (_w, _s, _dst, m) in ops:
        p.moved.append(p.slot(storm_key(m)))
    for (w, s, dst, m) in ops:
        p.cands[p.index[storm_key(m)]] = [
            (s, (w, storm_key(m)), p.slot(storm_key(dst)), None)]
    return p


def move_fleet(n_realms: int = 1024, seed0: int = 1000, **storm) -> list:
    """`n_realms` storm realms, realm r drawn from seed seed0 + r."""
    return [move_storm(seed=seed0 + r, **storm) for r in range(n_realms)]


def random_move_problem(rng: random.Random, n_nodes: int,
                        n_moves: int) -> MoveProblem:
    """A random realm (the reference's tests' generator): random base
    forest, `n_moves` candidates with unique priorities on random nodes,
    random targets (cycles and self-loops included)."""
    p = MoveProblem()
    for i in range(n_nodes):
        p.slot(f"n{i}")
    for s in range(n_nodes):
        p.base[s] = rng.randrange(-1, s) if s else -1
    prios = rng.sample(range(max(10_000, n_moves)), n_moves)
    by_node: dict[int, list] = {}
    for m in range(n_moves):
        s = rng.randrange(n_nodes)
        by_node.setdefault(s, []).append(
            (prios[m] // 40, ("a%02d" % (prios[m] % 40), "v"),
             rng.randrange(-1, n_nodes)))
    for s, cl in by_node.items():
        cl.sort(key=lambda t: (t[0], t[1]), reverse=True)
        p.cands[s] = [(hi, lo, tgt, None) for (hi, lo, tgt) in cl]
        p.moved.append(s)
    return p


def random_move_lanes(rng: np.random.Generator, d: int, n_pad: int,
                      k_pad: int, labels: str = "ranks"):
    """Random packed move lanes (nodes [d, 4, n_pad], cands [d, 3, k_pad],
    ptr [d, n_pad], int32) in the ranges pack_moves produces: each realm
    a random node count, candidate runs tiling a prefix of the candidate
    axis, parents in [-1, n), priorities in [0, k_pad) or the pad, and
    winner pointers past a run's end too. `labels` "wide": priorities
    over the whole int32 range instead, a few with the pad as hi, so that
    no realm's labels fit the move kernel's narrow code; "pad_hi": ranks,
    but about a fifth of the candidates with the pad as hi (and their own
    lo), the labels that code collapses into one."""
    from .engine.pack import MOVE_PRIO_PAD
    nodes = np.zeros((d, 4, n_pad), np.int32)
    nodes[:, 1] = -1
    cands = np.full((d, 3, k_pad), MOVE_PRIO_PAD, np.int32)
    cands[:, 0] = -1
    ptr = np.zeros((d, n_pad), np.int32)
    for r in range(d):
        n = int(rng.integers(1, n_pad + 1))
        cnt = np.zeros(n, np.int64)
        k = int(rng.integers(0, k_pad + 1))
        np.add.at(cnt, rng.integers(0, n, k), 1)
        nodes[r, 0, :n] = 1
        nodes[r, 1, :n] = rng.integers(-1, n, n)
        nodes[r, 2, :n] = np.cumsum(cnt) - cnt
        nodes[r, 3, :n] = cnt
        cands[r, 0, :k] = rng.integers(-1, n, k)
        cands[r, 1, :k] = rng.integers(0, k_pad, k)
        cands[r, 2, :k] = rng.permutation(k_pad)[:k]
        if labels == "wide":
            # few distinct hi values, so that cycles still tie on hi
            his = rng.integers(-2**31, 2**31 - 1, 3)
            cands[r, 1, :k] = np.append(his, MOVE_PRIO_PAD)[
                rng.integers(0, 4, k)]
            cands[r, 2, :k] = rng.integers(-2**31, 2**31 - 1, k)
        elif labels == "pad_hi":
            cands[r, 1, :k][rng.random(k) < 0.2] = MOVE_PRIO_PAD
        ptr[r, :n] = rng.integers(0, cnt + 2)
    return nodes, cands, ptr


# Small span tables and move realms whose outputs the JAX reference
# computed, committed in testdata/reference_hashes.npz.


def reference_span_tables() -> list:
    """A small fleet of config-10 tables plus one random table of every
    range, an empty one and a padded one."""
    tables, _ = span_fleet(n_docs=6)
    rng = np.random.default_rng(10)
    tables += random_span_tables(rng, 1, 40, full_range=True)
    return tables + [[], [(7, 0, 3, 0, 0, 0, 0)]]


def reference_move_problems() -> list:
    """Small storm realms (seeds whose storms drop cycle edges) and random
    realms."""
    rng = random.Random(16)
    probs = [move_storm(n_objs=80, n_moves=64, seed=s) for s in (3, 4)]
    return probs + [random_move_problem(rng, rng.randrange(2, 48),
                                        rng.randrange(0, 40))
                    for _ in range(5)]
