"""Race-plane smoke: the runtime proof that the committed lock hierarchy
holds under real traffic.

The lock ORDER is committed in `locks_manifest.json`; this smoke proves
it on live threads. One storm — concurrent writer threads pushing docs
through a TCP sync pair while a fleet collector scrapes — runs in two
modes, in turns:

1. **sanitizer off** (baseline): wall-time the writer loop;
2. **AMTPU_LOCKSAN=1**: the same storm with every named lock reporting
   to utils/locksan.py. Assertions:
   - **zero violations** — no committed-order inversion, no long hold
     with blocked waiters, anywhere in the storm;
   - **overhead < 5%** — the writer loop's wall with the sanitizer on
     against off, the median over STORM_REPS pairs of storms run one
     after the other (one full retry absorbs a noisy-neighbor timing
     blip, as the reference's does); the writer threads' CPU and the
     hooks' own seconds (`locksan.self_seconds()`) are printed beside
     it. A sanitizer the fleet can't afford to leave on is a sanitizer
     nobody runs.

Fresh DocSets/servers/collectors are built AFTER each mode flips, so
`locksan.named_lock` hands out the mode-correct flavor (plain
`threading.Lock` when off — the zero-overhead-when-disabled contract).
The documents live on the smoke's device (`--device`, default `cuda`).

Exit codes: 0 = clean, 1 = violations or overhead breach.
`python -m automerge_tpu_torch.perf race --smoke`; `chip_smoke.py`
phase 16 runs it on the card.
"""

from __future__ import annotations

import os
import statistics
import threading
import time

from ..utils import locksan

#: sanitized-vs-baseline writer-loop overhead bound
OVERHEAD_BOUND = 0.05


def _storm(device, n_threads: int = 3, n_docs: int = 6,
           ops_per_doc: int = 5, timeout_s: float = 20.0) -> float:
    """One threaded sync storm with documents on `device`; returns the
    writer-loop wall seconds, the writer threads' CPU seconds and the
    seconds every thread spent in the sanitizer's hooks during the loop.
    Raises on writer errors or non-convergence — the smoke's race
    assertions are meaningless over a broken storm."""
    from .. import api as am
    from ..sync.docset import DocSet
    from ..sync.tcp import TcpSyncClient, TcpSyncServer, sync_lock
    from .fleet import FleetCollector

    ds_server, ds_client = DocSet(device=device), DocSet(device=device)
    server = TcpSyncServer(ds_server)
    server.start()
    client = TcpSyncClient(ds_client, server.host, server.port).start()
    collector = FleetCollector(interval_s=3600.0)   # manual ticks only
    collector.add_local("race-smoke")
    stop = threading.Event()
    errors: list[BaseException] = []
    cpu: list[float] = []

    def writer(w: int) -> None:
        t0 = time.thread_time()
        try:
            for d in range(n_docs):
                doc = am.init(f"w{w}", device=device)
                for k in range(ops_per_doc):
                    doc = am.change(
                        doc, lambda dd, k=k: dd.__setitem__(f"k{k}", k))
                with sync_lock(ds_client):
                    ds_client.set_doc(f"race-{w}-{d}", doc)
        except BaseException as e:          # noqa: BLE001 — re-raised
            errors.append(e)
        cpu.append(time.thread_time() - t0)

    def scraper() -> None:
        while not stop.is_set():
            try:
                collector.scrape_once()
            except BaseException as e:      # noqa: BLE001 — re-raised
                errors.append(e)
                return
            stop.wait(0.02)

    scr = threading.Thread(target=scraper,
                           name="amtpu-torch-race-smoke-scraper",
                           daemon=True)
    scr.start()
    try:
        san0 = locksan.self_seconds()
        threads = [threading.Thread(target=writer, args=(w,),
                                    name=f"amtpu-torch-race-smoke-writer-{w}",
                                    daemon=True)
                   for w in range(n_threads)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        loop_s = time.perf_counter() - t0
        san_s = locksan.self_seconds() - san0
        if errors:
            raise errors[0]

        want = [f"race-{w}-{d}"
                for w in range(n_threads) for d in range(n_docs)]
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            got = [ds_server.get_doc(i) for i in want]
            if all(g is not None and g == ds_client.get_doc(i)
                   for g, i in zip(got, want)):
                return loop_s, sum(cpu), san_s
            time.sleep(0.05)
        raise RuntimeError(
            f"race smoke storm did not converge within {timeout_s}s")
    finally:
        stop.set()
        scr.join(timeout=5)
        client.close()
        server.close()


#: storms each sanitizer mode is timed over, in turns (pairs of one
#: storm a mode). On an H100 host the median pair moved by ±7% from run
#: to run at 20 pairs and by ±3.6% at 40 (scripts/race_spread.py).
STORM_REPS = 40
#: the storm's size: a writer's docs and changes a doc (the reference's 6
#: and 5 make a ~30 ms storm, which a shared host's scheduling swamps)
STORM_DOCS = 12
STORM_OPS = 20


def _set_mode(on: bool) -> None:
    if on:
        os.environ["AMTPU_LOCKSAN"] = "1"
    else:
        os.environ.pop("AMTPU_LOCKSAN", None)
    locksan._reload_for_tests()


def _timed_modes(device) -> dict:
    """{"off": runs, "on": runs}: STORM_REPS storms a mode, each run
    (wall, writer CPU, sanitizer seconds), the modes in turns (off, on,
    on, off, off, ...) so neither a drift in the host's load nor going
    first favors one, after one untimed storm (the process's first pays
    for warming up). The k-th runs of the two modes ran one after the
    other: they are a pair."""
    _set_mode(False)
    _storm(device, n_docs=STORM_DOCS, ops_per_doc=STORM_OPS)   # warm-up
    runs: dict = {"off": [], "on": []}
    for rep in range(STORM_REPS):
        for mode in (("off", "on") if rep % 2 == 0 else ("on", "off")):
            _set_mode(mode == "on")
            runs[mode].append(_storm(device, n_docs=STORM_DOCS,
                                     ops_per_doc=STORM_OPS))
    return runs


def smoke_main(argv=None) -> int:
    """The race smoke. Its overhead bound holds the sanitized writer
    loop's wall against the plain one's, end to end: the median, over
    the STORM_REPS pairs, of a pair's on/off difference. A storm here is
    ~0.3 s of a few threads whose sync traffic interleaves differently
    each time: on an H100's host one pair's difference ranged from -60%
    to +130%. A pair cancels the host's drift and the median its
    outliers (the reference bounds the best of 2 walls, one mode after
    the other, which favors the mode run second).
    Beside it: the spread of the pairs, the median walls and writer CPU
    seconds (`time.thread_time`) a mode, and the hooks' own seconds
    (`locksan.self_seconds()`) over the sanitized loops' wall."""
    import argparse

    ap = argparse.ArgumentParser(prog="automerge_tpu_torch.perf race")
    ap.add_argument("--smoke", action="store_true",
                    help="run the race-plane smoke (default)")
    ap.add_argument("--overhead-bound", type=float, default=OVERHEAD_BOUND)
    ap.add_argument("--device", default="cuda",
                    help="the documents' device (cuda, or cpu)")
    args = ap.parse_args(argv)
    from ..device import resolve_device
    device = resolve_device(args.device)

    prev = os.environ.get("AMTPU_LOCKSAN")
    try:
        for attempt in (1, 2):              # one retry for timing noise
            runs = _timed_modes(device)
            vs = locksan.violations()
            if vs:
                print("race smoke: FAILED — sanitizer violations under "
                      f"the storm ({len(vs)}):")
                for v in vs[:8]:
                    print(f"  [{v['kind']}] {v['detail']}")
                return 1
            wall = {m: statistics.median(r[0] for r in rs)
                    for m, rs in runs.items()}
            cpu = {m: statistics.median(r[1] for r in rs)
                   for m, rs in runs.items()}
            pairs = sorted(on[0] / off[0] - 1
                           for off, on in zip(runs["off"], runs["on"]))
            overhead = statistics.median(pairs)
            hooks = (sum(r[2] for r in runs["on"])
                     / sum(r[0] for r in runs["on"]))
            said = (f"writer loop wall on/off {overhead:+.1%} (median of "
                    f"{len(pairs)} pairs, bound {args.overhead_bound:.0%}, "
                    f"attempt {attempt}; pairs {pairs[0]:+.1%} to "
                    f"{pairs[-1]:+.1%}); median wall {wall['off']:.3f}s "
                    f"off / {wall['on']:.3f}s on, writer CPU "
                    f"{cpu['off']:.3f}s off / {cpu['on']:.3f}s on "
                    f"({cpu['on'] / cpu['off'] - 1:+.1%}); sanitizer "
                    f"hooks {hooks:.2%} of the sanitized writer loops")
            if overhead < args.overhead_bound:
                print(f"race smoke: CLEAN — 0 sanitizer violations; {said}")
                return 0
            print(f"race smoke: overhead past the bound; {said}")
        print("race smoke: FAILED — sanitizer overhead past the bound on "
              "both attempts")
        return 1
    finally:
        if prev is None:
            os.environ.pop("AMTPU_LOCKSAN", None)
        else:
            os.environ["AMTPU_LOCKSAN"] = prev
        locksan._reload_for_tests()


if __name__ == "__main__":
    raise SystemExit(smoke_main())
