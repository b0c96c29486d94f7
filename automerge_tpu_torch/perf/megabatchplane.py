"""`perf megabatch --smoke`: the fused multi-doc round, proven end to end.

The seconds-scale proof for the megabatch plane: a heterogeneous rows
fleet (one large doc that grows the resident caps and a set of idle
docs, then a storm of small docs) runs through a service twice, once
with megabatch routing live and once with `AMTPU_MEGABATCH=0`, from the
SAME generated change sets (doc init is actor-random, so parity must
replay identical changes, never rebuild). Asserted:

- the storm round actually routed through the fused path (the dispatch
  ledger's cumulative megabatch account moved, with bucket count within
  `pack.MEGA_MAX_BUCKETS`);
- converged hashes are BYTE-IDENTICAL between the fused and disabled
  paths for every doc (the subset-row-map invariant);
- occupancy telemetry landed (docs/dispatch).

On the port the megabatch route serves a minority-dirty hash read (round
frames always reconcile the whole buffer, `engine/resident_rows.py`), so
the service defers its reconcile to the read (`lazy_dispatch`) and the
storm's docs are fewer than half the fleet. The planner is priced by
bytes for the run (and restored), not by the card's fixed costs, so its
route-or-gather comparison decides on any device.
"""

from __future__ import annotations

import numpy as np

#: storm width — enough small docs to make lane sharing the obvious win
SMOKE_DOCS = 24
#: ops in the cap-growing large doc (inflates the full layout the
#: classic path must gather)
BIG_OPS = 96


def _build_changes(device):
    """The fleet's two rounds as lists of (doc_id, changes) pairs,
    generated ONCE — both services replay exactly these. Round one: one
    large doc, 2 * SMOKE_DOCS + 1 idle docs and SMOKE_DOCS small docs;
    round two (the storm): one more change to each small doc, so the
    storm is a minority of the fleet and adds no doc and no actor (a new
    doc or actor re-lays the buffer out and dirties every doc)."""
    from .. import api as am

    first, storm = [], []
    big = am.init("big", device=device)
    big = am.change(big, lambda d: am.assign(
        d, {"items": list(range(BIG_OPS)), "meta": {"kind": "big"}}))
    first.append(("doc-big", big._doc.opset.get_missing_changes({})))
    for i in range(2 * SMOKE_DOCS + 1):
        doc = am.init("idle", device=device)   # one actor: the rows
        # envelope holds 64 actors across the fleet
        doc = am.change(doc, lambda d, i=i: d.__setitem__("idle", i))
        first.append((f"idle{i:03d}",
                      doc._doc.opset.get_missing_changes({})))
    for i in range(SMOKE_DOCS):
        doc = am.init(f"w{i:03d}", device=device)
        doc = am.change(doc, lambda d, i=i: am.assign(
            d, {"x": i, "tags": ["a", "b"]}))
        first.append((f"doc{i:03d}", doc._doc.opset.get_missing_changes({})))
        clock = dict(am.get_clock(doc))
        doc = am.change(doc, lambda d, i=i: d.__setitem__("x", i + 100))
        storm.append((f"doc{i:03d}",
                      doc._doc.opset.get_missing_changes(clock)))
    return first, storm


def _run_fleet(rounds, device):
    """Each round of `rounds` as ONE coalesced round, then a read. The
    service defers each round's reconcile to the read. Returns
    {doc_id: uint32 hash} after the last."""
    from ..sync.service import EngineDocSet

    svc = EngineDocSet(backend="rows", device=device)
    svc._lazy_resolved = True
    svc._resident.lazy_dispatch = True
    try:
        for pairs in rounds:
            with svc.batch():
                for did, chs in pairs:
                    svc.apply_changes(did, chs)
            hashes = svc.hashes()
        return {d: np.uint32(h) for d, h in hashes.items()}
    finally:
        svc.close()


def smoke_run(verbose: bool = True, device="cuda") -> int:
    import os

    from ..device import resolve_device
    from ..engine import dispatch, dispatchledger, pack

    device = resolve_device(device)
    if not dispatch.megabatch_enabled():
        print("perf megabatch --smoke: routing disabled "
              "(AMTPU_MEGABATCH=0) — nothing to prove")
        return 0
    changes = _build_changes(device)

    # price bytes, not the card's fixed costs: the reconcile at 1 KB/s
    # and the host gather at 1 MB/s, so the route's smaller buckets win
    # on any device
    keys = ("dev_bytes_per_s", "host_gather_bytes_per_s")
    saved = {k: dispatch._LINK[k] for k in keys}
    dispatch.calibrate(dev_bytes_per_s=1e3, host_gather_bytes_per_s=1e6)
    led = dispatchledger.ledger() if dispatchledger.enabled() else None
    base = (led.section() or {}) if led else {}
    base_mega = int(base.get("mega_rounds_total") or 0)
    try:
        fused = _run_fleet(changes, device)
    finally:
        dispatch.calibrate(**saved)

    # the disabled path, same change sets: byte parity or bust
    prev = os.environ.get("AMTPU_MEGABATCH")
    os.environ["AMTPU_MEGABATCH"] = "0"
    dispatch._reload_for_tests()
    dispatchledger._reload_for_tests()
    try:
        classic = _run_fleet(changes, device)
    finally:
        if prev is None:
            os.environ.pop("AMTPU_MEGABATCH", None)
        else:
            os.environ["AMTPU_MEGABATCH"] = prev
        dispatch._reload_for_tests()
        dispatchledger._reload_for_tests()

    assert set(fused) == set(classic)
    diverged = [d for d in fused if fused[d] != classic[d]]
    assert not diverged, (
        f"fused path diverged from the disabled path on {diverged}")

    summary = None
    if led:
        sec = led.section() or {}
        new_mega = int(sec.get("mega_rounds_total") or 0) - base_mega
        assert new_mega >= 1, (
            "the storm round never routed through the fused path "
            f"(mega_rounds_total moved by {new_mega})")
        summary = {
            "rounds": new_mega,
            "dispatches": (int(sec.get("mega_dispatches_total") or 0)
                           - int(base.get("mega_dispatches_total") or 0)),
            "docs": (int(sec.get("mega_docs_total") or 0)
                     - int(base.get("mega_docs_total") or 0)),
        }
        assert summary["docs"] >= SMOKE_DOCS, (
            f"fused rounds served {summary['docs']} doc(s); the "
            f"{SMOKE_DOCS}-doc storm should ride the fused path")
        assert summary["dispatches"] <= (summary["rounds"]
                                         * pack.MEGA_MAX_BUCKETS), (
            f"{summary['dispatches']} fused dispatch(es) over "
            f"{summary['rounds']} round(s) breaches the "
            f"{pack.MEGA_MAX_BUCKETS}-bucket cap")
    if verbose:
        if summary:
            per = (summary["docs"] / summary["dispatches"]
                   if summary["dispatches"] else 0.0)
            print(f"perf megabatch --smoke OK: {len(fused)} doc(s) "
                  f"byte-equal across paths; {summary['rounds']} fused "
                  f"round(s), {summary['docs']} doc(s) over "
                  f"{summary['dispatches']} dispatch(es) "
                  f"({per:.1f} docs/disp)")
        else:
            print(f"perf megabatch --smoke OK: {len(fused)} doc(s) "
                  "byte-equal across paths (dispatch ledger off — "
                  "occupancy not asserted)")
    return 0


def smoke_main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="automerge_tpu_torch.perf megabatch")
    ap.add_argument("--smoke", action="store_true",
                    help="fused-round liveness + byte parity vs the "
                         "disabled path (CI self-check)")
    ap.add_argument("--device", default="cuda",
                    help="the service's device (cuda, or cpu)")
    args = ap.parse_args(argv)
    # occupancy reporting lives in `perf dispatch` (projected vs
    # achieved); this command is the smoke alone
    return smoke_run(device=args.device)


if __name__ == "__main__":
    raise SystemExit(smoke_main())
