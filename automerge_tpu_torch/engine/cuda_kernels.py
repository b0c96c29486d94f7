"""The build and launch of the port's hand-written CUDA kernels, and the
two kernels of `automerge_tpu/engine/pallas_kernels.py` with their plain
PyTorch versions: the fused reconcile over a docs-minor row buffer and the
domination flags of the docs-major engine. Also the launch of the
docs-major engine's `linearize` kernel (`csrc/linearize.cu`), whose plain
version and device dispatch are `kernels.linearize_plain` and
`kernels.linearize`.

`reconcile_rows_hash` and `dominated` dispatch on the device of the tensor
they are given: a CUDA tensor launches the kernel of `csrc/reconcile_rows.
cu` or `csrc/dominated.cu` (or raises), a CPU tensor runs the plain
version. Nothing falls back. The span
and move kernels' wrappers (`span_kernels.span_rank_hash`,
`move_kernels.move_round` / `resolve_moves`) follow the same rule through
`launch` below.

Each source of `csrc/` is compiled at first use with `nvcc` for `sm_90a`
into its own library under `automerge_tpu_torch/build/` (named by the
content hash of the source and of every `csrc/` header it includes, so an
edited source or header never loads a stale library), and bound with
ctypes: a plain C interface keeps the build to seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
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
           "move_round": CSRC / "move_round.cu",
           "dominated": CSRC / "dominated.cu",
           "linearize": CSRC / "linearize.cu"}

# Launches of each kernel by its wrapper: one per launch, counted nowhere
# else, so a run can show that its main path went through the kernel.
LAUNCHES = {"reconcile_rows_hash": 0, "span_rank_hash": 0, "move_round": 0,
            "resolve_moves": 0, "dominated": 0, "linearize": 0}

# The C entry points of each source: argument types (every pointer and the
# stream as c_void_p, so ctypes never cuts a pointer to 32 bits); each
# returns cudaGetLastError() after its launch.
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "reconcile_rows": {
        "amt_reconcile_rows_hash": [_P] * 2 + [_I] * 6 + [_P]},
    "span_rank_hash": {
        "amt_span_rank_hash": [_P] * 5 + [_I] * 3 + [_P]},
    "move_round": {
        "amt_move_round": [_P] * 5 + [_I] * 6 + [_P],
        "amt_resolve_moves": [_P] * 8 + [_I] * 7 + [_P]},
    "dominated": {
        "amt_dominated": [_P] * 7 + [_I] * 3 + [_P]},
    "linearize": {
        "amt_linearize": [_P] * 6 + [_I] * 3 + [_P],
        "amt_linearize_uses_scratch": [_I],
        "amt_linearize_work_bytes": [_I]},
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


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _build_inputs(src: Path) -> list[Path]:
    """`src` and every file it includes with #include "...", transitively,
    each once, in the order first met."""
    seen, todo = [], [src]
    while todo:
        f = todo.pop(0)
        if f in seen:
            continue
        seen.append(f)
        todo += [f.parent / m.decode()
                 for m in _INCLUDE.findall(f.read_bytes())]
    return seen


def library_path(name: str) -> Path:
    """The library of source `name`, named by the hash of the source and of
    every header it includes."""
    h = hashlib.sha1()
    for f in _build_inputs(SOURCES[name]):
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


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
        if d_pad:
            launch("reconcile_rows", "amt_reconcile_rows_hash",
                   "reconcile_rows_hash", rows.data_ptr(), out.data_ptr(),
                   d_pad, i, a, le, a_set, a_del, stream_of(rows))
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


# ---------------------------------------------------------------------------
# dominated (B5)

def _check_dominated(clock_op, actor, fid, seq, change_idx, amask) -> None:
    if clock_op.dim() != 3 or clock_op.dtype != torch.int32:
        raise ValueError(f"clock_op must be [D, N, A] int32, got "
                         f"{clock_op.dtype} {tuple(clock_op.shape)}")
    shape = clock_op.shape[:2]
    for name, x, dt in (("actor", actor, torch.int32),
                        ("fid", fid, torch.int32), ("seq", seq, torch.int32),
                        ("change_idx", change_idx, torch.int32),
                        ("amask", amask, torch.bool)):
        if x.shape != shape or x.dtype != dt:
            raise ValueError(f"{name} must be {tuple(shape)} {dt}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != clock_op.device:
            raise ValueError(f"{name} is on {x.device}, clock_op on "
                             f"{clock_op.device}")


def dominated(clock_op, actor, fid, seq, change_idx, amask) -> torch.Tensor:
    """Per-op domination flags of a batch of documents (the contract of the
    reference's dominated_pallas):

        dominated[d, i] = exists j: amask[d, j] and amask[d, i]
                          and fid[d, j] == fid[d, i]
                          and change_idx[d, j] != change_idx[d, i]
                          and clock_op[d, j, actor[d, i]] >= seq[d, i]

    clock_op [D, N, A] int32 (each op's change-clock row); actor, fid, seq,
    change_idx [D, N] int32; amask [D, N] bool. Returns [D, N] bool. An
    actor outside [0, A) reads a clock of 0, as the reference's one-hot
    contraction does. Compares are int32 and exact over the whole range;
    the TPU kernel compares in float32, exact below 2**24 only, so the two
    agree on values below 2**24.

    A CUDA tensor launches the kernel of csrc/dominated.cu; a CPU tensor
    runs dominated_plain."""
    _check_dominated(clock_op, actor, fid, seq, change_idx, amask)
    if clock_op.device.type == "cpu":
        return dominated_plain(clock_op, actor, fid, seq, change_idx, amask)
    if clock_op.device.type != "cuda":
        raise ValueError(f"unsupported device {clock_op.device}")
    d, n, a = clock_op.shape
    args = [t.contiguous() for t in (clock_op, actor, fid, seq, change_idx)]
    am = amask.contiguous()
    with torch.cuda.device(clock_op.device):
        out = torch.empty((d, n), dtype=torch.bool, device=clock_op.device)
        if d and n:
            launch("dominated", "amt_dominated", "dominated",
                   *(t.data_ptr() for t in args), am.data_ptr(),
                   out.data_ptr(), d, n, a, stream_of(clock_op))
    return out


# Most elements of one [D, j-chunk, N] pairwise intermediate of the plain
# version; it steps over j (and docs) to stay under this.
_PLAIN_PAIR_ELEMS = 1 << 24


def dominated_plain(clock_op, actor, fid, seq, change_idx,
                    amask) -> torch.Tensor:
    """The plain PyTorch version of `dominated`: the pairwise definition
    over chunks of j (and of documents), on the tensors' own device, with
    memory bounded by _PLAIN_PAIR_ELEMS whatever N is."""
    d, n, a = clock_op.shape
    out = torch.zeros((d, n), dtype=torch.bool, device=clock_op.device)
    if not (d and n):
        return out
    # the clock of op j at op i's actor: clock_op[d, j, actor_i], 0 for an
    # actor outside [0, A)
    act_ok = (actor >= 0) & (actor < a)
    act = actor.clamp(0, max(a - 1, 0)).to(torch.int64)
    dc = max(1, _PLAIN_PAIR_ELEMS // (n * n))
    jc = max(1, min(n, _PLAIN_PAIR_ELEMS // n))
    for d0 in range(0, d, dc):
        ds = slice(d0, d0 + dc)
        for j0 in range(0, n, jc):
            js = slice(j0, j0 + jc)
            # [docs, j, i]
            cji = torch.gather(
                clock_op[ds, js], 2,
                act[ds, None, :].expand(-1, clock_op[ds, js].shape[1], -1))
            hit = (amask[ds, js, None] & amask[ds, None, :]
                   & (fid[ds, js, None] == fid[ds, None, :])
                   & (change_idx[ds, js, None] != change_idx[ds, None, :])
                   & (torch.where(act_ok[ds, None, :], cji, 0)
                      >= seq[ds, None, :]))
            out[ds] |= hit.any(1)
    return out


# ---------------------------------------------------------------------------
# linearize (the docs-major engine's RGA order; plain XLA in the reference)

# Rows past 4,096 slots or a block's shared memory work in a global
# scratch of LINEARIZE_SCRATCH_BLOCKS_PER_SM blocks an SM, each looping
# over rows.
LINEARIZE_SCRATCH_BLOCKS_PER_SM = 2


def linearize_work_bytes(e: int) -> int:
    """Bytes of one row's work area in csrc/linearize.cu for rows of E
    slots: 0 where a row runs on a warp slice (E <= 32), else the block
    path's sort records and node arrays."""
    b = _library("linearize").amt_linearize_work_bytes(e)
    if b < 0:
        raise ValueError(f"rows of {e} slots need more than 2 GiB of work")
    return b


def linearize_uses_scratch(e: int) -> bool:
    """Whether a row of E slots works in the global scratch on the current
    CUDA device: past 4,096 slots, or where its work area needs more
    shared memory than a block of the device may opt in to."""
    lib = _library("linearize")
    got = lib.amt_linearize_uses_scratch(e)
    if got < 0:
        raise RuntimeError("cudaDeviceGetAttribute failed: "
                           + lib.amt_cuda_error_string(-got).decode())
    return bool(got)


def linearize(ins_mask, ins_elem, ins_actor, ins_parent) -> torch.Tensor:
    """Launch the kernel of csrc/linearize.cu on CUDA tensors: the
    contract of `kernels.linearize` (ins_mask [R, E] bool, ins_elem,
    ins_actor, ins_parent [R, E] int32 -> elem_pos [R, E] int32), bit-equal
    to `kernels.linearize_plain`. Rows past 4,096 slots, or whose work
    does not fit a block's shared memory, run in a global scratch this
    wrapper allocates."""
    shape = ins_mask.shape
    if ins_mask.dim() != 2 or ins_mask.dtype != torch.bool:
        raise ValueError(f"ins_mask must be [R, E] bool, got "
                         f"{ins_mask.dtype} {tuple(shape)}")
    for name, x in (("ins_elem", ins_elem), ("ins_actor", ins_actor),
                    ("ins_parent", ins_parent)):
        if x.shape != shape or x.dtype != torch.int32:
            raise ValueError(f"{name} must be {tuple(shape)} int32, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != ins_mask.device:
            raise ValueError(f"{name} is on {x.device}, ins_mask on "
                             f"{ins_mask.device}")
    if ins_mask.device.type != "cuda":
        raise ValueError(f"the linearize kernel takes CUDA tensors, got "
                         f"{ins_mask.device} (kernels.linearize routes CPU "
                         f"tensors to linearize_plain)")
    r, e = shape
    dev = ins_mask.device
    args = [t.contiguous() for t in (ins_mask, ins_elem, ins_actor,
                                     ins_parent)]
    with torch.cuda.device(dev):
        out = torch.empty((r, e), dtype=torch.int32, device=dev)
        if not (r and e):
            return out
        scratch, grid = None, r
        if linearize_uses_scratch(e):
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            grid = min(r, LINEARIZE_SCRATCH_BLOCKS_PER_SM * sms)
            scratch = torch.empty(grid * linearize_work_bytes(e) // 4,
                                  dtype=torch.int32, device=dev)
        launch("linearize", "amt_linearize", "linearize",
               *(t.data_ptr() for t in args), out.data_ptr(),
               None if scratch is None else scratch.data_ptr(), r, e, grid,
               stream_of(ins_mask))
    return out
