"""Native host code (C++, bound with ctypes): the wire codec and host RGA
linearizer (`wirecodec.cpp`) and the columnar delta encoder
(`deltaenc.cpp`), copies of `automerge_tpu/native/`'s sources.

Each source is compiled at first use with `g++ -O2 -shared -fPIC
-std=c++17` into `automerge_tpu_torch/build/`, as a library named by the
content hash of its source, so an edited source never loads a stale
library. The compiler writes a process-unique temporary file that is then
renamed into place: several processes may build the same library at once.

There is no fallback: a library that cannot be built or loaded raises
RuntimeError with the compiler's message. The pure-Python encoder is
reached only by asking for it (`ResidentDocSet(..., native=False)`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

from ..utils import perfscope

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parent / "build"

_lock = threading.Lock()
_wire_state: dict = {}


def library_path(src_name: str, lib_name: str) -> Path:
    """The library of source `src_name`, named by its content hash."""
    digest = hashlib.sha1((_HERE / src_name).read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{lib_name}-{digest}.so"


def _build_shared(src: Path, lib_path: Path) -> None:
    """Compile one .cpp into a shared library, atomically installed, and
    report the build to `perfscope.note_build`."""
    t0 = time.perf_counter()
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", str(src),
           "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise RuntimeError(f"cannot build {src.name}: g++ could not run "
                           f"({exc})") from exc
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {src.name}:\n{proc.stderr}")
    os.replace(tmp, lib_path)
    # the dispatch open on this thread (metrics.dispatch_jit) counts this
    # build as its retrace
    perfscope.note_build(src.name, time.perf_counter() - t0)


def load_shared(src_name: str, lib_name: str, state: dict) -> ctypes.CDLL:
    """Build-if-missing and load a native library; `state` caches it so
    each library is loaded once per process. Raises RuntimeError."""
    lib = state.get("lib")
    if lib is not None:
        return lib
    lib_path = library_path(src_name, lib_name)
    if not lib_path.exists():
        _build_shared(_HERE / src_name, lib_path)
    try:
        state["lib"] = ctypes.CDLL(str(lib_path))
    except OSError as exc:
        raise RuntimeError(f"cannot load {lib_path}: {exc}") from exc
    return state["lib"]


def get_lib() -> ctypes.CDLL:
    """The wire codec library (building it at first use), bound."""
    with _lock:
        lib = load_shared("wirecodec.cpp", "amtpuwire", _wire_state)
        if getattr(lib, "_wire_ready", False):
            return lib
        # every pointer (input bytes, string buffers, arrays) is passed as
        # c_void_p, so ctypes never cuts one to 32 bits
        p = ctypes.c_void_p
        lib.amtpu_parse_changes.restype = p
        lib.amtpu_parse_changes.argtypes = [p, ctypes.c_int64, p,
                                            ctypes.c_int64]
        lib.amtpu_free.argtypes = [p]
        lib.amtpu_sizes.argtypes = [p, p]
        lib.amtpu_copy_columns.argtypes = [p] * 16
        lib.amtpu_copy_table.argtypes = [p, ctypes.c_int, p, p]
        lib.amtpu_linearize.argtypes = [ctypes.c_int64] + [p] * 5
        lib._wire_ready = True
        return lib
