"""The move plane: the port's pack_moves, move_round, resolve_moves
(device="cpu", the kernel's plain PyTorch versions), resolve_moves_host
and _resolve_walk against the reference's pack_moves, XLA resolve_moves,
resolve_moves_host, move_round_pallas in interpret mode and _resolve_walk,
on the same realms. Tolerance: exact (integer outputs, uint32 hashes bit
for bit).

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
from automerge_tpu_torch.workloads import (
    move_storm, move_storm_ops, random_move_lanes, random_move_problem,
    reference_move_problems, storm_key)

from test_moves import _rand_problem
from torch_port_helpers import load_reference_script

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
