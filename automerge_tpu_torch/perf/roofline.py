"""Roofline probe for the fused rows reconcile (B1, base body, and B2, the
XL body) on the card: the counterpart of `automerge_tpu/perf/roofline.py`.

The kernel streams the whole docs-minor row buffer once a pass, so
row_bytes / device_s is its bandwidth reading, held against two
yardsticks: the H100 SXM data sheet's HBM3 peak (3,350 GB/s) and the
card's own copy rate, measured in the same run by a device-to-device
`copy_` of COPY_BYTES (bytes read plus bytes written).

Timing: P chained launches of `cuda_kernels.reconcile_rows_hash`, each pass
feeding its hash back into the buffer on the device (`rows[0, 0] +=
h[0]`), so no pass can be skipped or reordered, and one readback at the
end; the chain is timed with CUDA events, twice: enqueued from the host
loop (`chain_s_per_pass`, where the host's enqueue can hold the card
back) and replayed as one CUDA graph (`device_s_per_pass`, the device
alone, the figure the bandwidth reading uses; on the CPU the host loop's
wall stands in). A pass is the kernel plus its feedback (a lane sum and a
one-element update). The H100's L2 holds 50 MB: a buffer that fits would
read from L2, not HBM, so for such a buffer each pass follows a read of
L2_FLUSH_BYTES and the same chain of those reads alone is subtracted (the
reading is cold); every probe reports `row_buffer_mb`, `fits_l2` and
`l2_flushed`. Each chain is also run on the plain version on the same
device, and its final hash must be equal.

    python -m automerge_tpu_torch.perf roofline [--docs N] [--xl-docs N]
        [--passes P]        # on the card; writes ROOFLINE_torch.json
    python -m automerge_tpu_torch.perf roofline --cpu-smoke
        # two tiny probes on the CPU through the plain version (timings
        # meaningless, nothing written)

Without a CUDA device the default path exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

#: H100 SXM HBM3 peak (NVIDIA data sheet), GB/s
HBM_PEAK_GB = 3350
#: the H100's L2 cache
L2_BYTES = 50 * 1000 * 1000
#: bytes read before each pass of a chain whose buffer fits in L2
L2_FLUSH_BYTES = 256 << 20
#: the measured-copy yardstick's buffer (each copy reads and writes it)
COPY_BYTES = 2 << 30

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUTPUT_NAME = "ROOFLINE_torch.json"


def _row_buffer(doc_changes):
    from ..engine.encode import encode_doc, stack_docs
    from ..engine.pack import pack_rows

    actors = sorted({c.actor for chs in doc_changes for c in chs})
    encs = [encode_doc(c, actors) for c in doc_changes]
    batch = stack_docs(encs)
    mf = batch.pop("max_fids")
    return pack_rows(batch, mf)


def _chain(rows, dims, force_xl: bool, passes: int, plain: bool, flush=None):
    """P chained passes over a copy of `rows`, all on its device: each
    pass's hash feeds the next pass's input. Returns the uint32 sum of
    every pass's lane hashes as a 0-d int64 tensor (not read back)."""
    import torch

    from ..engine.cuda_kernels import (reconcile_rows_hash,
                                       reconcile_rows_hash_plain)
    from ..engine.kernels import _int32_bits

    r = rows.clone()
    acc = torch.zeros((), dtype=torch.int64, device=r.device)
    for _ in range(passes):
        if flush is not None:
            flush.sum()
        h = (reconcile_rows_hash_plain(r, dims) if plain
             else reconcile_rows_hash(r, dims, force_xl))
        acc = (acc + (h.to(torch.int64) & 0xFFFFFFFF).sum()) & 0xFFFFFFFF
        r[0, 0] = _int32_bits(r[0, 0].to(torch.int64) + h[0])
    return acc


def _timed(fn, device) -> tuple:
    """(fn()'s result, seconds): CUDA events on the card, the host clock on
    the CPU."""
    import torch
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        out = fn()
        stop.record()
        torch.cuda.synchronize(device)
        return out, start.elapsed_time(stop) / 1e3
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _graph_s(fn, device, replays: int = 3) -> float:
    """Seconds of one fn() with the host out of the window: fn captured
    into a CUDA graph (the kernel wrappers launch on the current stream,
    the capture stream), replayed between CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize(device)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    g.replay()
    torch.cuda.synchronize(device)

    def run():
        for _ in range(replays):
            g.replay()
    _, s = _timed(run, device)
    return s / replays


def copy_rate(device, nbytes: int = COPY_BYTES, reps: int = 5) -> float:
    """The card's measured copy rate in GB/s: `reps` device-to-device
    `copy_` of an nbytes buffer after a warm-up, counting the bytes read
    and the bytes written."""
    import torch
    src = torch.empty(nbytes // 4, dtype=torch.float32, device=device)
    dst = torch.empty_like(src)
    dst.copy_(src)

    def run():
        for _ in range(reps):
            dst.copy_(src)
    _, s = _timed(run, device)
    del src, dst
    return 2 * nbytes * reps / s / 1e9


def probe(name, doc_changes, force_xl, passes, device="cuda",
          copy_gb_s=None):
    """One probe: the row buffer of `doc_changes`, P chained passes of B1
    (B2 with force_xl) timed, the same chain on the plain version, and
    the bandwidth reading against the spec and `copy_gb_s`."""
    import torch

    from ..device import resolve_device
    from ..engine.cuda_kernels import _XL_BI
    from ..engine.pack import rows_dims_eligible, rows_from_numpy
    from ..utils import metrics

    dev = resolve_device(device)
    rows, dims, n_docs = _row_buffer(doc_changes)
    I, A, LE = dims[0], dims[1], dims[2]
    if force_xl and I % _XL_BI:
        return {"probe": name, "skipped": f"I={I} not a multiple of "
                f"{_XL_BI} (XL block)"}
    if not force_xl and not rows_dims_eligible(I, A, LE):
        return {"probe": name, "skipped": f"dims I={I} A={A} LE={LE} "
                "exceed the base kernel's envelope"}

    r_dev = rows_from_numpy(rows, dims, dev)
    row_bytes = rows.shape[0] * rows.shape[1] * 4
    fits_l2 = dev.type == "cuda" and row_bytes <= L2_BYTES
    flush = (torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=dev) if fits_l2 else None)
    kernel = f"roofline_chained_{'xl' if force_xl else 'base'}"
    # the first chain through dispatch_jit, so the probe's build lands in
    # the perf section; then the timed chains
    got = int(metrics.dispatch_jit(kernel, _chain, r_dev, dims, force_xl,
                                   passes, False))

    def chain():
        return _chain(r_dev, dims, force_xl, passes, False, flush)

    def flushes():
        for _ in range(passes):
            flush.sum()

    chain_s = _timed(chain, dev)[1] - (
        _timed(flushes, dev)[1] if flush is not None else 0.0)
    device_s = chain_s
    if dev.type == "cuda":
        device_s = _graph_s(chain, dev) - (
            _graph_s(flushes, dev) if flush is not None else 0.0)
    want, plain_s = _timed(lambda: _chain(r_dev, dims, force_xl, passes,
                                          True), dev)
    want = int(want)
    eff = row_bytes * passes / device_s
    out = {
        "probe": name,
        "kernel": "xl" if force_xl else "base",
        "device": str(dev),
        "docs": int(n_docs),
        "doc_lanes": int(rows.shape[1]),
        "dims": {"I": int(I), "A": int(A), "LE": int(LE)},
        "row_buffer_mb": round(row_bytes / 1e6, 2),
        "fits_l2": fits_l2,
        "l2_flushed": flush is not None,
        "passes": passes,
        "device_s_per_pass": device_s / passes,
        "chain_s_per_pass": chain_s / passes,
        "plain_s_per_pass": plain_s / passes,
        "chain_hash": got,
        "plain_chain_hash": want,
        "chain_equal": got == want,
        "effective_GB_per_s": eff / 1e9,
        "hbm_peak_GB_per_s": HBM_PEAK_GB,
        "hbm_utilization_pct": eff / (HBM_PEAK_GB * 1e9) * 100,
    }
    if copy_gb_s:
        out["copy_GB_per_s"] = copy_gb_s
        out["copy_utilization_pct"] = eff / (copy_gb_s * 1e9) * 100
    return out


def probe_line(p: dict) -> str:
    if "skipped" in p:
        return f"# {p['probe']}: SKIPPED ({p['skipped']})"
    return (f"# {p['probe']}: {p['kernel']} kernel, {p['row_buffer_mb']} MB "
            f"rows (fits_l2 {p['fits_l2']}, "
            f"{'L2 flushed' if p['l2_flushed'] else 'warm'}), "
            f"{p['device_s_per_pass'] * 1e3:.4f} ms/pass (host-enqueued "
            f"chain {p['chain_s_per_pass'] * 1e3:.4f}, plain "
            f"{p['plain_s_per_pass'] * 1e3:.4f}), "
            f"{p['effective_GB_per_s']:.2f} GB/s = "
            f"{p['hbm_utilization_pct']:.2f}% of the {HBM_PEAK_GB} GB/s spec"
            + (f", {p['copy_utilization_pct']:.2f}% of the measured copy "
               f"{p['copy_GB_per_s']:.1f} GB/s" if "copy_GB_per_s" in p
               else "")
            + f"; chain hash {'equal' if p['chain_equal'] else 'DIFFERS'}")


def probes(docs: int, xl_docs: int, passes: int, device="cuda",
           copy_gb_s=None) -> list:
    """The reference's three probes: bench config 5 (docset fleet) on the
    base body, config 2 (trellis) on the base body and, on the same
    batch, forced onto the XL body."""
    from .. import workloads

    ids, initial, _ = workloads.docset_fleet(docs, rounds=0)
    out = [probe(f"config5-{docs}docs", [initial[d] for d in ids], False,
                 passes, device, copy_gb_s)]
    trellis = workloads.trellis() * xl_docs
    out.append(probe(f"trellis-{xl_docs}docs-base", trellis, False, passes,
                     device, copy_gb_s))
    out.append(probe(f"trellis-{xl_docs}docs-xl", trellis, True, passes,
                     device, copy_gb_s))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="automerge_tpu_torch.perf roofline")
    ap.add_argument("--docs", type=int, default=10000)
    ap.add_argument("--xl-docs", type=int, default=2048)
    ap.add_argument("--passes", type=int, default=8)
    ap.add_argument("--cpu-smoke", action="store_true",
                    help="run two tiny probes on the CPU through the plain "
                         "version: checks this module's plumbing where "
                         "there is no card (timings meaningless; nothing "
                         "is written)")
    args = ap.parse_args(argv)

    import torch

    from .. import workloads
    if args.cpu_smoke:
        ids, initial, _ = workloads.docset_fleet(64, rounds=0)
        out = [probe("smoke-base", [initial[d] for d in ids], False, 2,
                     device="cpu"),
               probe("smoke-trellis", workloads.trellis() * 8, False, 2,
                     device="cpu")]
        print(json.dumps({"smoke": True, "device": "cpu",
                          "probes": [{k: p[k] for k in p
                                      if k in ("probe", "skipped", "docs",
                                               "passes", "chain_equal")}
                                     for p in out]}))
        bad = [p["probe"] for p in out
               if "skipped" in p or not p["chain_equal"]]
        if bad:
            # a skipped probe validated nothing
            print(f"perf roofline: smoke probes skipped or unequal: {bad}",
                  file=sys.stderr)
            return 1
        return 0
    if not torch.cuda.is_available():
        print("perf roofline: no CUDA device (torch.cuda.is_available() is "
              "False); the probe reads the card's HBM (--cpu-smoke checks "
              "the plumbing on the CPU)", file=sys.stderr)
        return 1

    dev = torch.device("cuda", 0)
    copy_gb_s = copy_rate(dev)
    out = probes(args.docs, args.xl_docs, args.passes, dev, copy_gb_s)
    rec = {"device": torch.cuda.get_device_name(dev), "copy_GB_per_s":
           copy_gb_s, "hbm_peak_GB_per_s": HBM_PEAK_GB, "probes": out}
    with open(os.path.join(_ROOT, OUTPUT_NAME), "w") as f:
        json.dump(rec, f, indent=1)
    for p in out:
        print(probe_line(p))
    print(json.dumps(rec))
    bad = [p["probe"] for p in out if "skipped" not in p
           and not p["chain_equal"]]
    if bad:
        print(f"perf roofline: chain hash differs from the plain version's "
              f"on {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
