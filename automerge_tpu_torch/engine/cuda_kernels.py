"""The build and launch of the port's hand-written CUDA kernels, and the
fused reconcile kernel (counterpart of `automerge_tpu/engine/
pallas_kernels.py`) with its plain PyTorch version.

`reconcile_rows_hash` dispatches on the device of the tensor it is given: a
CUDA tensor launches the kernel of `csrc/reconcile_rows.cu` (or raises), a
CPU tensor runs `reconcile_rows_hash_plain`. Nothing falls back. The span
and move kernels' wrappers (`span_kernels.span_rank_hash`,
`move_kernels.move_round` / `resolve_moves`) follow the same rule through
`launch` below.

Each source of `csrc/` is compiled at first use with `nvcc` for `sm_90a`
into its own library under `automerge_tpu_torch/build/` (named by the
source's content hash, so an edited source never loads a stale library),
and bound with ctypes: a plain C interface keeps the build to seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

from .kernels import _int32_bits, _mix4
from .pack import row_bases, rows_count, rows_dims_eligible, ROWS_VMEM_BUDGET

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = {"reconcile_rows": CSRC / "reconcile_rows.cu",
           "span_rank_hash": CSRC / "span_rank_hash.cu",
           "move_round": CSRC / "move_round.cu"}

# Launches of each kernel by its wrapper: one per launch, counted nowhere
# else, so a run can show that its main path went through the kernel.
LAUNCHES = {"reconcile_rows_hash": 0, "span_rank_hash": 0, "move_round": 0,
            "resolve_moves": 0}

# The C entry points of each source: argument types (every pointer and the
# stream as c_void_p, so ctypes never cuts a pointer to 32 bits); each
# returns cudaGetLastError() after its launch.
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "reconcile_rows": {
        "amt_reconcile_rows_hash": [_P] * 5 + [_I] * 6 + [_P]},
    "span_rank_hash": {
        "amt_span_rank_hash": [_P] * 5 + [_I] * 2 + [_P]},
    "move_round": {
        "amt_move_round": [_P] * 5 + [_I] * 4 + [_P],
        "amt_resolve_moves": [_P] * 8 + [_I] * 5 + [_P]},
}

# The reference's join block height: I and LE must be multiples of it.
_BLK = 8
# The reference's XL form blocks the op axis by 32 (pallas_kernels.py:446).
_XL_BI = 32
_XL_BJ = 32

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}


def rows_dims_eligible_xl(i: int, a: int, le: int) -> bool:
    """The reference's XL envelope (pallas_kernels.rows_dims_eligible_xl),
    kept numerically identical. The CUDA kernel has no such limit; the rows
    engine admits only `pack.rows_dims_eligible` dims."""
    inter = 3 * _XL_BI * _XL_BJ
    working = rows_count(i, a, le) + inter + 4 * i + 2 * le
    return (i % _XL_BI == 0 and (le % 8 == 0)
            and working <= ROWS_VMEM_BUDGET)


# ---------------------------------------------------------------------------
# build

def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the port's CUDA kernels are built at "
                           "first use")
    return found


def library_path(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _compile(name: str) -> tuple[str, subprocess.Popen]:
    """Start nvcc for one source into a temporary file in the build
    directory; returns that file's path and the running process."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-o", tmp, str(SOURCES[name])]
    return tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def build(names=None) -> float:
    """Compile every kernel source not yet built, one nvcc per source, all
    started together. Returns the wall seconds spent; the compiler's
    output (ptxas register and spill report) lands in BUILD_LOG."""
    names = list(SOURCES) if names is None else list(names)
    t0 = time.perf_counter()
    with _lock:
        todo = [n for n in names if not library_path(n).exists()]
        started = [(n, *_compile(n)) for n in todo]
        for n, tmp, proc in started:
            log, _ = proc.communicate()
            BUILD_LOG[n] = log
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"nvcc failed for {SOURCES[n]}:\n{log}")
            # atomic: a concurrent loader sees the old name or the whole file
            os.replace(tmp, library_path(n))
    return time.perf_counter() - t0


def _library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.amt_cuda_error_string.argtypes = [ctypes.c_int]
            lib.amt_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return _libs[name]


def launch(source: str, fn: str, counter: str, *args) -> None:
    """Call the C entry point `fn` of `source`'s library (building it at
    first use) with `args`, raise if the launch was refused, and count one
    launch of `counter`. Pointers are ints (tensor.data_ptr()) or None; the
    caller passes the stream last and keeps every tensor alive."""
    lib = _library(source)
    err = getattr(lib, fn)(*args)
    if err:
        raise RuntimeError(f"{fn} launch failed: "
                           f"{lib.amt_cuda_error_string(err).decode()} "
                           f"({err})")
    LAUNCHES[counter] += 1


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of t's device, as the int the C entry
    points take."""
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# reconcile_rows_hash

def _check_dims(rows: torch.Tensor, dims: tuple, force_xl: bool) -> None:
    i, a, le = dims[:3]
    if i % _BLK or le % _BLK:
        # the reference's blocked joins have no tail handling, so it rejects
        # unpadded dims; the port keeps the same contract
        raise ValueError(
            f"megakernel dims must be multiples of {_BLK}: I={i}, LE={le} "
            f"(pad ops/elements before packing)")
    if (force_xl or not rows_dims_eligible(i, a, le)) and i % _XL_BI:
        raise ValueError(f"XL kernel needs I % {_XL_BI} == 0, I={i}")
    if rows.dtype != torch.int32 or rows.dim() != 2:
        raise ValueError(f"row buffer must be 2-D int32, got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    if rows.shape[0] != rows_count(i, a, le):
        raise ValueError(f"row buffer has {rows.shape[0]} rows, dims {dims} "
                         f"need {rows_count(i, a, le)}")


def reconcile_rows_hash(rows: torch.Tensor, dims: tuple,
                        force_xl: bool = False) -> torch.Tensor:
    """Fused reconcile + state hash over a docs-minor row buffer.

    rows: [ROWS, D_pad] int32 (pack.pack_rows); dims is (I, A, LE, a_set,
    a_del). Returns [D_pad] int32 holding each lane's uint32 hash bits
    (`hashes_to_numpy` gives the np.uint32 view), bit-identical to the
    reference's reconcile_rows_hash. `force_xl` selects the reference's XL
    form, which the one CUDA kernel computes identically.
    """
    _check_dims(rows, dims, force_xl)
    if rows.device.type == "cpu":
        return reconcile_rows_hash_plain(rows, dims)
    if rows.device.type != "cuda":
        raise ValueError(f"unsupported device {rows.device}")
    if not rows.is_contiguous():
        raise ValueError("row buffer must be contiguous")
    i, a, le, a_set, a_del = dims
    d_pad = rows.shape[1]
    with torch.cuda.device(rows.device):
        out = torch.empty(d_pad, dtype=torch.int32, device=rows.device)
        st = torch.empty((i, d_pad), dtype=torch.int32, device=rows.device)
        vis = torch.empty((le, d_pad), dtype=torch.int32, device=rows.device)
        rank = torch.empty((le, d_pad), dtype=torch.int32, device=rows.device)
        launch("reconcile_rows", "amt_reconcile_rows_hash",
               "reconcile_rows_hash", rows.data_ptr(), out.data_ptr(),
               st.data_ptr(), vis.data_ptr() if le else None,
               rank.data_ptr() if le else None, d_pad, i, a, le, a_set,
               a_del, stream_of(rows))
    return out


def hashes_to_numpy(h: torch.Tensor):
    """Per-lane hash bits (int32 tensor, any device) as np.uint32."""
    return h.cpu().numpy().view("uint32")


# Most elements of one broadcasted [*, *, lanes] join intermediate of the
# plain version; it steps over lane chunks to stay under this.
_PLAIN_JOIN_ELEMS = 1 << 24


def reconcile_rows_hash_plain(rows: torch.Tensor, dims: tuple) -> torch.Tensor:
    """The plain PyTorch version of reconcile_rows_hash: the same function as
    broadcasted compares over lane chunks, on the tensor's own device."""
    i, a, le, a_set, a_del = dims
    b = row_bases(i, a, le)
    d_pad = rows.shape[1]
    chunk = max(1, _PLAIN_JOIN_ELEMS // max(i * i, le * le, i * le, 1))
    out = torch.empty(d_pad, dtype=torch.int32, device=rows.device)
    for d0 in range(0, d_pad, chunk):
        out[d0:d0 + chunk] = _plain_lanes(rows[:, d0:d0 + chunk], b, i, a, le,
                                          a_set, a_del)
    return out


def _plain_lanes(x, b, I, A, LE, a_set, a_del):
    def band(g, n):
        return x[b[g]:b[g] + n]

    om, ac, fid, act, seq, chg, fh, vh = (
        band(g, I) for g in ("om", "ac", "fid", "act", "seq", "chg", "fh",
                             "vh"))
    amask = (om > 0) & (ac >= a_set)
    # [j, i, lane]: op j dominates op i
    base = (amask[:, None] & amask[None] & (fid[:, None] == fid[None])
            & (chg[:, None] != chg[None]))
    co = band("co", A * I).reshape(A, I, -1)
    hit = torch.zeros_like(base)
    for r in range(A):
        hit |= (act == r)[None] & (co[r][:, None] >= seq[None])
    dominated = (base & hit).any(0)
    cand = amask & ~dominated & (ac != a_del)
    if LE:
        im, ifid, ipos, iobj, ilist = (
            band(g, LE) for g in ("im", "if", "ip", "io", "il"))
        valid = (im > 0) & (ifid >= 0)
        # [e, j, lane]: element e's field holds candidate op j
        vis = valid & ((ifid[:, None] == fid[None]) & cand[None]).any(1)
        # [e, f, lane]: f is visible, in e's list, before e
        rank = ((ilist[:, None] == ilist[None]) & vis[None]
                & (ipos[None] < ipos[:, None])).sum(1, dtype=torch.int32)
        vis_rank = torch.where(vis, rank, -1)
        # [i, e, lane]: op i writes element e
        m = (fid[:, None] == ifid[None]) & valid[None]
        is_list = m.any(1)
        oh = torch.where(m, iobj[None], -1).amax(1)
        rk = torch.where(m, vis_rank[None], -1).amax(1)
        key1 = torch.where(is_list, oh, -7)
        key2 = torch.where(is_list, rk, fh)
    else:
        key1 = torch.full_like(fh, -7)
        key2 = fh
    ah_rows = band("ah", A)
    ah = torch.zeros_like(act)
    for r in range(A):
        ah += torch.where(act == r, ah_rows[r][None], 0)
    contrib = _mix4(key1, key2, ah, vh)           # int64 in [0, 2**32)
    return _int32_bits(torch.where(cand, contrib, 0).sum(0))
