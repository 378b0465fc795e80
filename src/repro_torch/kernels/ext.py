"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface under ``build/torch_ext/`` at the
root of the checkout, and loads with ``ctypes``: no PyTorch headers, so a
build takes seconds, not minutes. All sources build at once, one ``nvcc``
each, started together, at first use (or up front through
:func:`build_all`). A library's file name carries a hash of its sources
and flags, so an edit rebuilds it and nothing else does. A process-wide
lock guards the build (fragments call it from many threads), and a file
lock guards it across processes.

Launch counts: each kernel wrapper calls :func:`count_launch` under its
own name where it launches its kernel and nowhere else, so a run can
show that its main path went through the kernels (``groupby.cu`` serves
two wrappers, ``groupby`` and ``groupby_minmax``).
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from repro_torch.analysis.roofline import H100_SXM
from repro_torch.kernels.program import DTYPE_CODES, MAX_COLS

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"

SOURCES = {
    "filter_agg": "filter_agg.cu",
    "groupby": "groupby.cu",
}
HEADERS = ("scan_agg.cuh",)
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# C signature of each library's launch function: columns, mask and rows,
# program, [K,] partials and output, grid, stream
_ARGTYPES = {
    "filter_agg": [_P, _P, _I, _P, _L, _P, _P, _P, _P, _I, _P, _P, _I, _I,
                   _P],
    "groupby": [_P, _P, _I, _P, _L, _P, _P, _P, _P, _I, _I, _P, _P, _I, _I,
                _P],
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}

_launch_lock = threading.Lock()
_launches: collections.Counter = collections.Counter()


def count_launch(name: str) -> None:
    with _launch_lock:
        _launches[name] += 1


def launches() -> dict[str, int]:
    with _launch_lock:
        return dict(_launches)


def reset_launches() -> None:
    with _launch_lock:
        _launches.clear()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + \
            [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for f in (SOURCES[name],) + HEADERS:
        h.update((_CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all() -> dict[str, float]:
    """Build every missing library, one ``nvcc`` per source, all started
    together. Returns seconds per library built (empty if none was).
    Raises with the compiler's output if a build fails."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / "build.lock", "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            try:
                return _build_missing()
            finally:
                fcntl.flock(lk, fcntl.LOCK_UN)


def _build_missing() -> dict[str, float]:
    todo = {n: _lib_path(n) for n in SOURCES if not _lib_path(n).exists()}
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, out in todo.items():
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        log = open(BUILD_DIR / f"{name}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT),
                       log, tmp, out)
    seconds, failed = {}, []
    for name, (proc, log, tmp, out) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)
    if failed:
        logs = "\n".join(f"--- {n}\n" + (BUILD_DIR / f"{n}.log").read_text()
                         for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return seconds


def build_log(name: str) -> str:
    """The compiler's output of the last build of ``name`` (ptxas
    registers, shared memory and spills), or "" if it was not built in
    this checkout."""
    p = BUILD_DIR / f"{name}.log"
    return p.read_text() if p.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all()
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_lib_path(name)))
            fn = getattr(lib, f"{name}_launch")
            fn.argtypes = _ARGTYPES[name]
            fn.restype = ctypes.c_int
            lib.scan_agg_error_string.argtypes = [ctypes.c_int]
            lib.scan_agg_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return lib


def column_args(columns: dict, mask, prog) -> tuple:
    """Checked C arguments for a program's columns and the row mask:
    (column tensors kept alive, pointer array, type array, n_cols)."""
    if mask.dtype != torch.bool or mask.dim() != 1 \
            or not mask.is_contiguous():
        raise ValueError("mask must be a contiguous 1-D bool tensor")
    cols = []
    for name in prog.names:
        c = columns[name]
        if c.device != mask.device or c.shape != mask.shape:
            raise ValueError(f"column {name!r}: {tuple(c.shape)} on "
                             f"{c.device}, mask {tuple(mask.shape)} on "
                             f"{mask.device}")
        if c.dtype not in DTYPE_CODES:
            raise TypeError(f"column {name!r}: dtype {c.dtype} unsupported")
        cols.append(c.contiguous())
    ptrs = (ctypes.c_int64 * MAX_COLS)(*[c.data_ptr() for c in cols])
    types = (ctypes.c_int * MAX_COLS)(*[DTYPE_CODES[c.dtype] for c in cols])
    return cols, ptrs, types, len(cols)


def grid_ctas(tiling, n_rows: int, device) -> int:
    """CTAs to launch: the tiling's CTAs per SM times the SMs this card
    has, and no more than there are row blocks."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per_sm = max(1, tiling.ctas // H100_SXM["sm_count"])
    blocks = -(-max(n_rows, 1) // tiling.block_rows)
    return max(1, min(sms * per_sm, blocks))


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if rc != 0:
        msg = lib.scan_agg_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
