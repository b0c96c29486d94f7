"""`perf move --smoke`: the move-plane smoke (`chip_smoke.py` phase 16
runs it on the card).

Proof, in seconds, that the r16 move plane works in this image: two
rows-backend services exchange a concurrent move storm (map reparents
that CYCLE + list reorders of the same element) over the columnar wire,
in BOTH delivery orders, and the smoke asserts byte-equal hashes and
materializations, a green ConvergenceAuditor round, at least one
deterministically dropped cycle edge, and resolution parity on a packed
cyclic realm: the host walk (`resolve_moves_host`) against
`move_kernels.resolve_moves` on the smoke's device (the CUDA kernel B4 on
the card, its plain version on the CPU) and against the single-realm
walk. Informational timing is printed; the smoke FAILS only on
correctness, never on this host's timing.
"""

from __future__ import annotations

import time


def smoke_main(argv=None) -> int:
    import argparse

    import numpy as np

    import torch

    from ..core.change import Change, Op
    from ..core.ids import ROOT_ID
    from ..core.moves import MoveProblem, _resolve_walk
    from ..device import resolve_device
    from ..engine.cuda_kernels import hashes_to_numpy
    from ..engine.move_kernels import resolve_moves, resolve_moves_host
    from ..engine.pack import pack_moves
    from ..sync.audit import ConvergenceAuditor
    from ..sync.connection import Connection
    from ..sync.service import EngineDocSet
    from ..utils import metrics

    ap = argparse.ArgumentParser(prog="automerge_tpu_torch.perf move")
    ap.add_argument("--smoke", action="store_true",
                    help="run the move-plane smoke (default)")
    ap.add_argument("--device", default="cuda",
                    help="the services' and the kernel's device (cuda, "
                         "or cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    t0 = time.perf_counter()
    base_ops = []
    for i in range(6):
        base_ops.append(Op("makeMap", f"f{i}"))
        base_ops.append(Op("link", ROOT_ID, key=f"k{i}", value=f"f{i}"))
    base_ops.append(Op("makeList", "L"))
    base_ops.append(Op("link", ROOT_ID, key="L", value="L"))
    prev = "_head"
    for e in range(1, 7):
        base_ops.append(Op("ins", "L", key=prev, elem=e))
        base_ops.append(Op("set", "L", key=f"A:{e}", value=f"v{e}"))
        prev = f"A:{e}"
    base = [Change("A", 1, {}, base_ops)]

    # the storm: a guaranteed A<->B reparent cycle + conflicting
    # reorders of ONE list element, from two concurrent writers
    side_b = [Change("B", 1, {"A": 1},
                     [Op("move", "f1", key="in", value="f0")]),
              Change("B", 2, {"B": 1},
                     [Op("move", "L", key="_head", value="A:4", elem=9)])]
    side_c = [Change("C", 1, {"A": 1},
                     [Op("move", "f0", key="in", value="f1")]),
              Change("C", 2, {"C": 1},
                     [Op("move", "L", key="A:6", value="A:4", elem=9)])]

    def run_pair(first, second):
        sx, sy = (EngineDocSet(backend="rows", device=device),
                  EngineDocSet(backend="rows", device=device))
        qx, qy = [], []
        cx = Connection(sx, qx.append, wire="columnar")
        cy = Connection(sy, qy.append, wire="columnar")
        cx.open()
        cy.open()

        def pump():
            for _ in range(100):
                moved = False
                while qx:
                    cy.receive_msg(qx.pop(0))
                    moved = True
                while qy:
                    cx.receive_msg(qy.pop(0))
                    moved = True
                if not moved:
                    return

        sx.apply_changes("d", base)
        pump()
        for c in first:
            sx.apply_changes("d", [c])
        for c in second:
            sy.apply_changes("d", [c])
        pump()
        aud = ConvergenceAuditor(sx, cx, period_s=0)
        aud.audit_once()
        pump()
        ok_aud = aud.rounds_clean == 1 and not aud.divergences
        hx, hy = sx.hashes(), sy.hashes()
        mx, my = sx.materialize("d"), sy.materialize("d")
        cx.close()
        cy.close()
        return ok_aud, hx == hy, hx, mx == my, mx

    ok1, heq1, h1, meq1, m1 = run_pair(side_b, side_c)
    ok2, heq2, h2, meq2, m2 = run_pair(side_c, side_b)
    dropped = metrics.snapshot().get("sync_move_cycles_dropped", 0)
    conv = ok1 and ok2 and heq1 and heq2 and meq1 and meq2 \
        and h1 == h2 and m1 == m2

    # resolution parity on a synthetic cyclic realm
    p = MoveProblem()
    for i in range(12):
        p.slot(i)
        p.base[i] = i - 1 if i else -1
    p.cands[3] = [(9, 1, 7, None)]
    p.cands[7] = [(8, 0, 3, None)]
    p.moved = [3, 7]
    packed = pack_moves([p])
    host = resolve_moves_host(packed)
    dev = resolve_moves(
        torch.from_numpy(np.asarray(packed["nodes"], np.int32)).to(device),
        torch.from_numpy(np.asarray(packed["cands"], np.int32)).to(device))
    wptr, _wd = _resolve_walk(p)
    parity = ((host["ptr"] == dev["ptr"].cpu().numpy()).all()
              and (host["hash"] == hashes_to_numpy(dev["hash"])).all()
              and (host["parent"] == dev["parent"].cpu().numpy()).all()
              and list(host["ptr"][0][:12]) == wptr)

    took = time.perf_counter() - t0
    print(f"move smoke: storm converged both orders={conv} "
          f"(cycle drops={int(dropped)}), host/{device.type} resolution "
          f"parity={bool(parity)}, {took:.1f}s")
    if not conv:
        print("FAIL: move storm did not converge byte-equal")
        return 1
    if dropped < 1:
        print("FAIL: the guaranteed cycle was never dropped")
        return 1
    if not parity:
        print(f"FAIL: host/{device.type} move resolution diverged")
        return 1
    return 0
