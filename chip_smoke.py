#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (automerge_tpu_torch) on one NVIDIA
GPU: builds the hand-written kernels from the checkout, holds each against
its plain PyTorch version, and drives the rows engine's main path
(`ResidentRowsDocSet.apply_rounds`, `hashes`, `hashes_for`) at fleet size.

    python3 chip_smoke.py

Phases:
  1. build (one nvcc per kernel source, all started together) and kernel
     parity on random buffers at the base shape and the XL-only shape;
  2. the map storm of the reference's bench config 20: 10,000 docs, 8 heavy
     docs of 400 ops, 8 zipf(1.1) rounds of ~1K dirty docs, then a
     minority-dirty hashes_for read;
  3. a text fleet of 2,048 docs, 4 concurrent typists each, so the list
     half of the kernel runs; its startup read takes the full-buffer path;
  4. both paths' final hashes recomputed from the device buffer by the plain
     version, and the launch counts of both paths;
  5. small fixed-seed streams against hashes the JAX reference computed
     (automerge_tpu_torch/testdata/reference_hashes.npz).
Then the kernel timings, a `kernels` JSON line, the card's name and power
limit, and the last line {"ok": true, "device": {...}}. Any failure exits
non-zero; without a CUDA device, or outside a checkout, it prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, and the
# non-tensor float32 rate, taken for the int32 compares (a bound: Hopper's
# int32 lanes are no faster than its float32 lanes).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12


def check(cond, msg: str) -> None:
    """Fail the run (a raise, unlike assert, survives python -O)."""
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over `reps` launches, after one
    warm-up, from CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def max_abs_err(got, want) -> int:
    import numpy as np
    return int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max(
        initial=0))


def bound(rows, dims):
    """(bound_ms, bound_by) of one reconcile of `rows`: its bytes (read
    once, hashes written once) over the HBM rate, against the pairwise
    compares its lanes' real ops and elements need (ops^2 + elems^2 +
    ops*elems per lane) over the compute rate."""
    import torch
    from automerge_tpu_torch.engine.pack import row_bases
    i, a, le = dims[:3]
    b = row_bases(i, a, le)
    n_ops = (rows[b["om"]:b["om"] + i] > 0).sum(0, dtype=torch.int64)
    n_el = ((rows[b["im"]:b["im"] + le] > 0)
            & (rows[b["if"]:b["if"] + le] >= 0)).sum(0, dtype=torch.int64)
    ops = int((n_ops * n_ops + n_el * n_el + n_ops * n_el).sum())
    nbytes = rows.numel() * 4 + rows.shape[1] * 4
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def phase_kernel_parity(torch, dev, report):
    import numpy as np
    from automerge_tpu_torch.engine import cuda_kernels as ck
    from automerge_tpu_torch.engine.pack import rows_dims_eligible
    from automerge_tpu_torch.workloads import random_rows

    t = ck.build()
    print(f"phase 1: built {sorted(ck.SOURCES)} in {t:.2f} s")
    for name, log in ck.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    rng = np.random.default_rng(1)
    for i, a, le, d in [(64, 4, 64, 1024), (512, 8, 512, 1024)]:
        rows_np, dims = random_rows(rng, i, a, le, d, n_fids=16, n_lists=4)
        rows = torch.from_numpy(rows_np).to(dev)
        before = ck.LAUNCHES["reconcile_rows_hash"]
        got = ck.hashes_to_numpy(ck.reconcile_rows_hash(rows, dims))
        launches = ck.LAUNCHES["reconcile_rows_hash"] - before
        want = ck.hashes_to_numpy(ck.reconcile_rows_hash_plain(rows, dims))
        err = max_abs_err(got, want)
        k_ms = cuda_ms(lambda: ck.reconcile_rows_hash(rows, dims), 10)
        p_ms = cuda_ms(lambda: ck.reconcile_rows_hash_plain(rows, dims), 2)
        b_ms, b_by = bound(rows, dims)[:2]
        print(f"phase 1: dims I={i} A={a} LE={le} D={d} "
              f"base_envelope={rows_dims_eligible(i, a, le)} "
              f"xl_envelope={ck.rows_dims_eligible_xl(i, a, le)} "
              f"launches={launches} kernel_ms={k_ms:.4f} plain_ms={p_ms:.3f} "
              f"bound_ms={b_ms:.5f} ({b_by}) max_abs_err={err}")
        check(launches == 1, "the wrapper did not launch its kernel")
        check(err == 0 and (got == want).all(), "kernel != plain version")
        report["errs"].append(err)
    check(not rows_dims_eligible(512, 8, 512)
          and ck.rows_dims_eligible_xl(512, 8, 512),
          "the XL-only shape is not XL-only")


def drive_map_storm(torch, dev):
    """Phase 2: the main path at bench config 20's scale. Returns the
    engine, its final hashes and the launch count of this path."""
    from automerge_tpu_torch.engine import cuda_kernels as ck
    from automerge_tpu_torch.engine.resident_rows import ResidentRowsDocSet
    from automerge_tpu_torch.workloads import map_storm

    ids, heavy, storm = map_storm()
    ds = ResidentRowsDocSet(ids, device=dev)
    ck.LAUNCHES["reconcile_rows_hash"] = 0
    t0 = time.perf_counter()
    ds.apply_rounds([heavy])
    ds.hashes()
    heavy_s = time.perf_counter() - t0
    walls = []
    for rnd in storm:
        t = time.perf_counter()
        ds.apply_rounds([rnd])
        walls.append(time.perf_counter() - t)
    # late docs fill padding lanes: a minority-dirty read gathers them
    fresh = [f"late{k:03d}"
             for k in range(min(100, ds.n_pad - len(ds.doc_ids)))]
    ds.add_docs(fresh)
    t = time.perf_counter()
    ds.hashes_for([ds.doc_index[d] for d in fresh] + [0, 9, 500])
    minority_s = time.perf_counter() - t
    final = ds.hashes()
    launches = ck.LAUNCHES["reconcile_rows_hash"]
    print(f"phase 2: {len(ds.doc_ids)} docs n_pad={ds.n_pad} dims={ds.dims()} "
          f"buffer_bytes={ds.rows_host.nbytes} "
          f"dirty_per_round={[len(r) for r in storm]}")
    print(f"phase 2: heavy round + read {heavy_s:.4f} s; storm round walls s "
          f"{[round(w, 4) for w in walls]} (p50 {sorted(walls)[len(walls) // 2]:.4f}); "
          f"minority hashes_for {minority_s:.4f} s; launches {launches}")
    return ds, final, launches


def drive_text_fleet(torch, dev):
    """Phase 3: concurrent text editing, so the list half runs."""
    from automerge_tpu_torch.engine import cuda_kernels as ck
    from automerge_tpu_torch.engine.pack import rows_dims_eligible
    from automerge_tpu_torch.engine.resident_rows import ResidentRowsDocSet
    from automerge_tpu_torch.workloads import text_fleet

    ids, rounds = text_fleet()
    ck.LAUNCHES["reconcile_rows_hash"] = 0
    t0 = time.perf_counter()
    ds = ResidentRowsDocSet(ids, device=dev)
    ds.hashes()                      # startup read: full-buffer branch
    t1 = time.perf_counter()
    per_round = ds.apply_rounds(rounds)
    t2 = time.perf_counter()
    final = ds.hashes()
    launches = ck.LAUNCHES["reconcile_rows_hash"]
    check(rows_dims_eligible(*ds.dims()[:3]), "text dims off the envelope")
    check((per_round[-1] == final).all(), "last round != hashes()")
    print(f"phase 3: {len(ids)} docs dims={ds.dims()} "
          f"buffer_bytes={ds.rows_host.nbytes} startup read "
          f"{t1 - t0:.4f} s; apply_rounds of {len(rounds)} rounds "
          f"{t2 - t1:.4f} s; launches {launches}")
    return ds, final, launches


def hold_to_plain(ds, final, name, report):
    """Phase 4 for one path: the device buffer equals the host mirror, and
    on that buffer the kernel's wrapper, its plain version and the engine's
    final hashes agree bit for bit."""
    import torch
    from automerge_tpu_torch.engine import cuda_kernels as ck
    check(torch.equal(ds.rows_dev.cpu(), torch.from_numpy(ds.rows_host)),
          f"{name}: device buffer != host mirror")
    n = len(final)
    plain = ck.hashes_to_numpy(
        ck.reconcile_rows_hash_plain(ds.rows_dev, ds.dims()))[:n]
    kernel = ck.hashes_to_numpy(
        ck.reconcile_rows_hash(ds.rows_dev, ds.dims()))[:n]
    err = max(max_abs_err(final, plain), max_abs_err(kernel, plain))
    report["errs"].append(err)
    check(err == 0, f"{name}: engine or kernel hashes != plain version")
    print(f"phase 4: {name}: {n} engine and kernel hashes equal to the plain "
          f"version")


def phase_reference(dev):
    import numpy as np
    from automerge_tpu_torch.engine.resident_rows import ResidentRowsDocSet
    from automerge_tpu_torch.workloads import reference_streams

    path = (Path(__file__).resolve().parent / "automerge_tpu_torch"
            / "testdata" / "reference_hashes.npz")
    committed = np.load(path)
    for name, ids, batches in reference_streams():
        ds = ResidentRowsDocSet(ids, device=dev)
        for batch in batches:
            ds.apply_rounds(batch)
        got = ds.hashes()
        check((got == committed[name]).all(), f"{name}: != reference")
        print(f"phase 5: {name}: {len(got)} hashes equal to the reference's")


def time_kernel(torch, ds, label):
    from automerge_tpu_torch.engine import cuda_kernels as ck
    rows, dims = ds.rows_dev, ds.dims()
    k_ms = cuda_ms(lambda: ck.reconcile_rows_hash(rows, dims), 20)
    p_ms = cuda_ms(lambda: ck.reconcile_rows_hash_plain(rows, dims), 1)
    b_ms, b_by, nbytes, ops = bound(rows, dims)
    print(f"timing {label}: dims={dims} lanes={rows.shape[1]} "
          f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.3f} bound_ms={b_ms:.5f} "
          f"({b_by}; bytes={nbytes} compares={ops})")
    return k_ms, p_ms, b_ms, b_by


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    repo = Path(__file__).resolve().parent
    if not (repo / "automerge_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(automerge_tpu_torch/ not found)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(repo))
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    report = {"errs": []}

    phase_kernel_parity(torch, dev, report)
    map_ds, map_final, map_launches = drive_map_storm(torch, dev)
    text_ds, text_final, text_launches = drive_text_fleet(torch, dev)
    check(map_launches > 0 and text_launches > 0, "a path skipped the kernel")
    hold_to_plain(map_ds, map_final, "map storm", report)
    hold_to_plain(text_ds, text_final, "text fleet", report)
    phase_reference(dev)

    k_ms, p_ms, b_ms, b_by = time_kernel(torch, map_ds, "map storm")
    time_kernel(torch, text_ds, "text fleet")
    print(json.dumps({"kernels": [{
        "name": "reconcile_rows_hash", "route": "cuda",
        "source": "automerge_tpu_torch/csrc/reconcile_rows.cu",
        "replaces": "automerge_tpu/engine/pallas_kernels.py:499",
        "launches": map_launches + text_launches,
        "max_abs_err": max(report["errs"]),
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None}]}))
    print(f"total {time.perf_counter() - t_all:.1f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
