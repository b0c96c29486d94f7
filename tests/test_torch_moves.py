"""The move plane: the port's pack_moves, move_round, resolve_moves
(device="cpu", the kernel's plain PyTorch versions), resolve_moves_host,
_resolve_walk and schedule_model (the CUDA kernel's schedule in numpy)
against the reference's pack_moves, XLA resolve_moves, resolve_moves_host,
move_round_pallas in interpret mode and _resolve_walk, on the same realms;
and the kernel's launch plan. Tolerance: exact (integer outputs, uint32
hashes bit for bit).

Realms: the reference tests' random generator, a 1,024-node realm (past
the Pallas kernel's 512-node cap, so against XLA only), the minimum-
priority-drop pin, and real problems the reference's OpSet builds from a
map storm and a kanban list-reorder storm admitted with move_batch=True."""

import random

import numpy as np
import pytest
import torch

from automerge_tpu.core.change import Change, Op
from automerge_tpu.core.ids import ROOT_ID
from automerge_tpu.core.moves import (MoveProblem as RefMoveProblem,
                                      _build_list_problem,
                                      _build_map_problem,
                                      _resolve_walk as ref_walk)
from automerge_tpu.core.opset import OpSet
from automerge_tpu.engine import move_kernels as ref_mk
from automerge_tpu.engine.pack import pack_moves as ref_pack_moves

from automerge_tpu_torch.core import moves
from automerge_tpu_torch.core.moves import MoveProblem, _resolve_walk
from automerge_tpu_torch.engine import move_kernels as mk
from automerge_tpu_torch.engine.dispatch import result_to_numpy
from automerge_tpu_torch.engine.pack import pack_moves
from automerge_tpu_torch.move_schedule import schedule_model
from automerge_tpu_torch.workloads import (
    move_fleet, move_storm, move_storm_ops, random_move_lanes,
    random_move_problem, reference_move_problems, storm_key)

from test_moves import _rand_problem
from torch_port_helpers import REPO, load_reference_script

KEYS = ("ptr", "parent", "resolved", "dropped", "hash")


def _reference_storm_opset(n_objs, n_moves, writers, seed):
    """The storm of move_storm_ops admitted by the reference's OpSet in
    one move_batch, as bench config 16(b) admits it."""
    ops = []
    for i in range(n_objs):
        ops.append(Op("makeMap", storm_key(i)))
        ops.append(Op("link", ROOT_ID, key=storm_key(i),
                      value=storm_key(i)))
    base, _ = OpSet.init().add_changes([Change("A", 1, {}, ops)])
    chs = []
    for j, (w, s, dst, m) in enumerate(
            move_storm_ops(n_objs, n_moves, writers, seed)):
        deps = {"A": 1, **({w: s - 1} if s > 1 else {})}
        chs.append(Change(w, s, deps, [Op("move", storm_key(dst),
                                          key=f"sub{j}",
                                          value=storm_key(m))]))
    out, diffs = base.add_changes(chs, move_batch=True)
    assert diffs and diffs[0]["action"] == "batch"
    return out


def _map_storm_problem():
    return _build_map_problem(_reference_storm_opset(60, 48, 7, 11).thaw())


def _kanban_problem():
    """A kanban list-reorder storm: 3 concurrent writers reorder the cards
    of one 12-card list, 60 moves; the reference builds its list realm."""
    ops = [Op("makeList", "L"), Op("link", ROOT_ID, key="cards", value="L")]
    prev = "_head"
    for e in range(1, 13):
        ops.append(Op("ins", "L", key=prev, elem=e))
        ops.append(Op("set", "L", key=f"K:{e}", value=f"card {e}"))
        prev = f"K:{e}"
    base, _ = OpSet.init().add_changes([Change("K", 1, {}, ops)])
    rng = random.Random(8)
    chs, wseq, elem = [], {}, 100
    for j in range(60):
        w = f"w{j % 3}"
        s = wseq[w] = wseq.get(w, 0) + 1
        e = rng.randrange(1, 13)
        a = rng.randrange(0, 13)
        anchor = "_head" if a in (0, e) else f"K:{a}"
        elem += 1
        chs.append(Change(w, s, {"K": 1, **({w: s - 1} if s > 1 else {})},
                          [Op("move", "L", key=anchor, value=f"K:{e}",
                              elem=elem)]))
    out, diffs = base.add_changes(chs, move_batch=True)
    assert diffs and diffs[0]["action"] == "batch"
    return _build_list_problem(out.thaw(), "L")


def _pin_problem():
    """0 -> 1 (prio 9) and 1 -> 0 (prio 5) cycle: the prio-5 edge drops."""
    p = RefMoveProblem()
    for i in range(4):
        p.slot(i)
        p.base[i] = -1
    p.cands[0] = [(9, ("b", "x"), 1, None)]
    p.cands[1] = [(5, ("a", "y"), 0, None)]
    p.moved = [0, 1]
    return [p]


def _random_problems():
    rng = random.Random(4242)
    return [_rand_problem(rng, rng.randrange(2, 48), rng.randrange(0, 40))
            for _ in range(20)]


def _large_problem():
    rng = random.Random(5)
    return [_rand_problem(rng, 1024, 700), _rand_problem(rng, 300, 200)]


CASES = {
    "random": _random_problems,
    "large_1024": _large_problem,
    "min_prio_pin": _pin_problem,
    "map_storm": lambda: [_map_storm_problem()],
    "kanban": lambda: [_kanban_problem()],
    "empty": lambda: [RefMoveProblem(), _pin_problem()[0]],
}


def _tensors(packed):
    return (torch.from_numpy(packed["nodes"]),
            torch.from_numpy(packed["cands"]))


@pytest.mark.parametrize("case", sorted(CASES))
def test_pack_moves_is_byte_equal(case):
    probs = CASES[case]()
    got, want = pack_moves(probs), ref_pack_moves(probs)
    for k in ("nodes", "cands"):
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == \
            want[k].tobytes(), k


@pytest.mark.parametrize("case", sorted(CASES))
def test_resolve_moves_matches_xla_host_and_walk(case):
    probs = CASES[case]()
    packed = ref_pack_moves(probs)
    xla = {k: np.asarray(v) for k, v in
           ref_mk.resolve_moves(packed["nodes"], packed["cands"]).items()}
    host = ref_mk.resolve_moves_host(packed)
    got = result_to_numpy(mk.resolve_moves(*_tensors(pack_moves(probs))))
    port_host = mk.resolve_moves_host(packed)
    for k in KEYS:
        np.testing.assert_array_equal(host[k], xla[k], err_msg=k)
        np.testing.assert_array_equal(got[k], xla[k], err_msg=k)
        np.testing.assert_array_equal(port_host[k], xla[k], err_msg=k)
        assert got[k].dtype == host[k].dtype, k
    for i, p in enumerate(probs):
        ptr, dropped = _resolve_walk(p)
        assert (ptr, dropped) == ref_walk(p)
        assert got["ptr"][i][:len(p.nodes)].tolist() == ptr
        assert int(got["dropped"][i]) == dropped


@pytest.mark.parametrize("case", sorted(c for c in CASES
                                        if c != "large_1024"))
def test_move_round_matches_pallas_interpret(case):
    """One round at three pointer states: all zero, the fixpoint's, and
    one past every candidate run (base edges only)."""
    packed = ref_pack_moves(CASES[case]())
    nodes, cands = _tensors(packed)
    fix = ref_mk.resolve_moves_host(packed)["ptr"]
    for ptr in (np.zeros_like(fix), fix, packed["nodes"][:, 3] + 1):
        ptr = np.ascontiguousarray(ptr, np.int32)
        want = np.asarray(ref_mk.move_round_pallas(
            packed["nodes"], packed["cands"], ptr, interpret=True))
        got = mk.move_round(nodes, cands, torch.from_numpy(ptr))
        np.testing.assert_array_equal(got.numpy(), want)


def test_move_round_on_random_lanes_matches_pallas_interpret():
    nodes, cands, ptr = random_move_lanes(np.random.default_rng(3), 6, 256,
                                          384)
    want = np.asarray(ref_mk.move_round_pallas(nodes, cands, ptr,
                                               interpret=True))
    got = mk.move_round(torch.from_numpy(nodes), torch.from_numpy(cands),
                        torch.from_numpy(ptr))
    np.testing.assert_array_equal(got.numpy(), want)
    xla = ref_mk.resolve_moves(nodes, cands)
    port = result_to_numpy(mk.resolve_moves(torch.from_numpy(nodes),
                                            torch.from_numpy(cands)))
    for k in KEYS:
        np.testing.assert_array_equal(port[k], np.asarray(xla[k]),
                                      err_msg=k)


def test_move_wrappers_reject_bad_lanes():
    nodes = torch.zeros((2, 4, 128), dtype=torch.int32)
    cands = torch.zeros((2, 3, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="move lanes"):
        mk.resolve_moves(nodes[:, :3], cands)
    with pytest.raises(ValueError, match="move lanes"):
        mk.resolve_moves(nodes, cands[:1])
    with pytest.raises(ValueError, match="ptr"):
        mk.move_round(nodes, cands, torch.zeros((2, 64), dtype=torch.int32))


def _canonical(p):
    """A realm as {node key: (base key, [(hi, lo, parent key)])}: slot
    order is the builder's own (the reference iterates a set), the realm
    is not."""
    def key(s):
        return None if s is None or s < 0 else p.nodes[s]
    return {p.nodes[s]: (key(p.base[s]),
                         [(c[0], c[1], key(c[2])) for c in p.cands[s]])
            for s in range(len(p.nodes))}, {p.nodes[s] for s in p.moved}


@pytest.mark.parametrize("n_objs,n_moves,seed", [(60, 48, 4), (200, 150, 9),
                                                 (120, 120, 1)])
def test_move_storm_builds_the_reference_problem(n_objs, n_moves, seed):
    """move_storm builds the realm the reference's OpSet + _build_map_
    problem make of the same storm, and both resolve to the same winners
    per node."""
    ref = _build_map_problem(
        _reference_storm_opset(n_objs, n_moves, 7, seed).thaw())
    port = move_storm(n_objs=n_objs, n_moves=n_moves, seed=seed)
    assert _canonical(port) == _canonical(ref)
    ptr_port, d_port = _resolve_walk(port)
    ptr_ref, d_ref = ref_walk(ref)
    assert d_port == d_ref
    assert dict(zip(port.nodes, ptr_port)) == dict(zip(ref.nodes, ptr_ref))


def test_resolve_problem_routes_by_moved_count():
    """Below MOVE_KERNEL_MIN_NODES moved nodes the walk, from there on the
    packed route on the given device: the same answer either way."""
    small = random_move_problem(random.Random(2), 40, 30)
    assert len(small.moved) < moves.MOVE_KERNEL_MIN_NODES
    assert moves.resolve_problem(small, device="cpu") == _resolve_walk(small)
    storm = move_storm(n_objs=200, n_moves=150, seed=4)
    assert len(storm.moved) >= moves.MOVE_KERNEL_MIN_NODES
    assert moves.resolve_problem(storm, device="cpu") == _resolve_walk(storm)


@pytest.mark.parametrize("case", ["map_storm", "kanban", "min_prio_pin"])
def test_real_realms_drop_cycle_edges(case):
    """The real realms are not trivial: their fixpoint drops cycle edges."""
    assert all(_resolve_walk(p)[1] > 0 for p in CASES[case]())


def test_move_problem_slots_are_stable():
    p = MoveProblem()
    assert [p.slot(k) for k in ("a", "b", "a", "c")] == [0, 1, 0, 2]
    assert p.base == [-1, -1, -1] and p.cands == [[], [], []]


def test_committed_move_outputs_hold_in_both_packages():
    """The move part of the .npz that chip_smoke.py holds the card to is
    what the reference computes today, and the port on the CPU reproduces
    it."""
    mod = load_reference_script()
    committed = np.load(mod.OUT)
    ref = mod.reference_move_outputs()
    got = result_to_numpy(mk.resolve_moves(
        *_tensors(pack_moves(reference_move_problems()))))
    for k in KEYS:
        np.testing.assert_array_equal(committed[f"moves_{k}"],
                                      ref[f"moves_{k}"])
        np.testing.assert_array_equal(got[k], committed[f"moves_{k}"])


# ---------------------------------------------------------------------------
# the CUDA kernel's schedule (move_schedule.schedule_model) against the
# reference: early exit, settled nodes skipped, resolved walks carried
# over, the narrow label code, the no-drop round reused


def _cycle_lanes(n: int, n_pad: int):
    """One realm that is a single n-node cycle: node i's one candidate
    moves it under node i + 1 (mod n), priorities all distinct."""
    nodes = np.zeros((1, 4, n_pad), np.int32)
    nodes[0, 1] = -1
    nodes[0, 0, :n] = 1
    nodes[0, 2, :n] = np.arange(n)
    nodes[0, 3, :n] = 1
    cands = np.full((1, 3, n_pad), np.iinfo(np.int32).max, np.int32)
    cands[0, 0] = -1
    cands[0, 0, :n] = (np.arange(n) + 1) % n
    cands[0, 1, :n] = np.arange(n)[::-1] // 3
    cands[0, 2, :n] = np.arange(n)
    return nodes, cands


def _capped_lanes(rng, d: int, n_pad: int, k_pad: int):
    """Lanes whose candidate counts run past the candidate axis, so that a
    node's clamped winner can drop round after round: random_move_lanes
    with inflated counts, and a last realm that reaches the K + 1 round
    cap. Its two nodes take the last two candidates, 0 -> 1 at (0, 0) and
    1 -> 0 at (1, 1); once 0 drops, both clamp to the last one, 0's self-
    loop, whose label each keeps matching."""
    nodes, cands, _ = random_move_lanes(rng, d, n_pad, k_pad)
    nodes[:, 3] = np.where(nodes[:, 0] > 0, nodes[:, 3] + 4 * k_pad, 0)
    nodes[-1] = 0
    nodes[-1, 1] = -1
    nodes[-1, :, :2] = [[1, 1], [-1, -1], [k_pad - 2, k_pad - 1],
                        [100, 100]]
    cands[-1] = np.iinfo(np.int32).max
    cands[-1, 0] = -1
    cands[-1, :, k_pad - 2:] = [[1, 0], [0, 1], [0, 1]]
    return nodes, cands


def _fleet_lanes():
    """Three storm realms small enough for the Pallas kernel's cap."""
    packed = pack_moves(move_fleet(n_realms=3, n_objs=300, n_moves=280))
    return packed["nodes"], packed["cands"]


SCHEDULE_CASES = {
    "random_lanes": lambda: random_move_lanes(np.random.default_rng(21), 6,
                                              384, 512)[:2],
    "wide_labels": lambda: random_move_lanes(np.random.default_rng(22), 6,
                                             384, 512, labels="wide")[:2],
    "pad_hi_labels": lambda: random_move_lanes(np.random.default_rng(23), 6,
                                               384, 512,
                                               labels="pad_hi")[:2],
    "fleet_realms": _fleet_lanes,
    "one_cycle": lambda: _cycle_lanes(500, 512),
    "round_cap": lambda: _capped_lanes(np.random.default_rng(8), 5, 256,
                                       12),
}


@pytest.mark.parametrize("case", sorted(SCHEDULE_CASES))
def test_schedule_model_matches_xla_and_pallas(case):
    """The kernel's schedule gives the reference's resolution (XLA, and
    the Pallas round kernel driven round by round in interpret mode) and
    its single rounds at three pointer states. The Pallas driver
    (resolve_moves_pallas) loops up to K + 2 rounds where XLA's contract,
    which the port keeps, stops at K + 1, so on a realm that reaches the
    cap only XLA is the yardstick of the resolution."""
    nodes, cands = SCHEDULE_CASES[case]()
    assert nodes.shape[2] <= ref_mk.PALLAS_MAX_NODES
    got = schedule_model(nodes, cands)
    xla = ref_mk.resolve_moves(nodes, cands)
    pallas = ref_mk.resolve_moves_pallas({"nodes": nodes, "cands": cands},
                                         interpret=True)
    free = ~got["capped"]
    for k in KEYS:
        np.testing.assert_array_equal(got[k], np.asarray(xla[k]),
                                      err_msg=k)
        np.testing.assert_array_equal(got[k][free], pallas[k][free],
                                      err_msg=k)
    for ptr in (np.zeros_like(got["ptr"]), got["ptr"],
                np.maximum(got["ptr"] - 1, 0)):
        want = ref_mk.move_round_pallas(nodes, cands, ptr, interpret=True)
        np.testing.assert_array_equal(
            schedule_model(nodes, cands, ptr)["out"], np.asarray(want))


def test_schedule_model_matches_xla_past_the_pallas_cap():
    nodes, cands = _cycle_lanes(3000, 3072)
    got = schedule_model(nodes, cands)
    xla = ref_mk.resolve_moves(nodes, cands)
    for k in KEYS:
        np.testing.assert_array_equal(got[k], np.asarray(xla[k]),
                                      err_msg=k)


def test_schedule_runs_what_it_claims():
    """What the schedule saves on each case, and where it saves nothing:
    the cycle's first round runs every step (its nodes never end), the
    capped lanes reach the K + 1 round cap and then walk once more."""
    steps = mk._ceil_log2(512) + 1
    cyc = schedule_model(*_cycle_lanes(500, 512))
    assert cyc["rounds"].tolist() == [2] and cyc["walks"].tolist() == [2]
    assert cyc["dropped"].tolist() == [1]
    # round 1 the full steps; round 2 a chain whose farthest node is 500
    # hops from the root: 2**9 >= 500, so 9 steps end every walk
    assert cyc["steps"].tolist() == [steps + 9]
    assert cyc["steps_old"].tolist() == [3 * steps]
    capped = schedule_model(*_capped_lanes(np.random.default_rng(8), 5,
                                              256, 12))
    assert capped["capped"].any()
    assert (capped["walks"] == capped["rounds"] + capped["capped"]).all()
    fleet = schedule_model(*_fleet_lanes())
    assert (fleet["steps"] < fleet["steps_old"]).all()
    assert (fleet["gathers"] < fleet["gathers_old"]).all()
    assert not fleet["capped"].any() and fleet["narrow"].all()
    # only the first walk and the dropped nodes gather their winners
    assert (fleet["winners"] == fleet["resolved"].shape[1]
            + fleet["dropped"] * (fleet["rounds"] > 1)).all()
    wide = schedule_model(*SCHEDULE_CASES["wide_labels"]())
    assert not wide["narrow"].any() and wide["dropped"].sum() > 0
    pad_hi = schedule_model(*SCHEDULE_CASES["pad_hi_labels"]())
    assert pad_hi["narrow"].all() and pad_hi["dropped"].sum() > 0


@pytest.mark.parametrize("n,want", [
    (1, (32, 1)), (32, (32, 1)), (33, (64, 1)), (512, (512, 1)),
    (513, (512, 4)), (1024, (512, 4)), (1025, (512, 4)), (1664, (512, 4)),
    (2048, (512, 4)), (2049, (1024, 4)), (mk.SMEM_MAX_NODES, (1024, 4)),
    (mk.SMEM_MAX_NODES + 1, (1024, 0)), (8192, (1024, 0)),
    (16384, (1024, 0))])
def test_move_launch_plan_at_its_boundaries(n, want):
    """The launch plan: threads and nodes a thread in registers, or the
    global scratch (npt 0) past SMEM_MAX_NODES, whose buffers fit the
    shared memory and whose nodes fit the register slots."""
    assert mk.SMEM_MAX_NODES == 4096
    assert mk.SMEM_MAX_NODES * mk.MOVE_SMEM_NODE_BYTES <= mk.MOVE_SMEM_BYTES
    assert mk.SMEM_MAX_NODES <= mk.MOVE_MAX_THREADS * mk.MOVE_NPTS[-1]
    threads, npt = mk.move_launch(n)
    assert (threads, npt) == want
    assert threads % 32 == 0 and threads <= mk.MOVE_MAX_THREADS
    if npt:
        assert threads * npt >= n
    nodes = torch.zeros((2, 4, n), dtype=torch.int32)
    scratch = mk._scratch(nodes, npt)
    if npt:
        assert scratch is None
    else:
        assert scratch.shape == (2, mk.MOVE_SCRATCH_NODE_BYTES * n)


def test_compare_kernels_loads_another_checkout():
    """compare_kernels loads a checkout's package under another module
    name, whose wrappers give this package's results (here this checkout
    itself, on the CPU); without a checkout to compare it prints its
    usage and exits 1."""
    from automerge_tpu_torch import compare_kernels
    from automerge_tpu_torch.engine import span_kernels as sk
    from automerge_tpu_torch.engine.pack import pack_spans
    from automerge_tpu_torch.workloads import random_span_tables
    other_mk, other_sk, other_ck = compare_kernels.load_other(
        REPO, "amt_other_test")
    assert other_mk.__name__ == "amt_other_test.engine.move_kernels"
    assert other_ck.__name__ == "amt_other_test.engine.cuda_kernels"
    assert other_mk is not mk
    rng = np.random.default_rng(5)
    nodes, cands, _ = (torch.from_numpy(a) for a in
                       random_move_lanes(rng, 4, 256, 256))
    got = other_mk.resolve_moves(nodes, cands)
    want = mk.resolve_moves(nodes, cands)
    for k in KEYS:
        assert torch.equal(got[k], want[k]), k
    spans = torch.from_numpy(pack_spans(random_span_tables(rng, 4, 100)))
    for g, w in zip(other_sk.span_rank_hash(spans), sk.span_rank_hash(spans)):
        assert torch.equal(g, w)
    assert compare_kernels.main([]) == 1
