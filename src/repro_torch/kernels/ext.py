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
two wrappers, ``groupby`` and ``groupby_minmax``; the join and Bloom
wrappers count as ``join_probe_agg`` and ``bloom_filter``, the sort
kernels as ``sort_agg`` and ``topk``; the fixed-layout benchmark kernels
as ``filter_agg_q6`` and ``groupby_onehot``, the model kernels as
``flash_attention`` and ``ssd_scan``).

Every source builds with ``-fmad=false`` (the query kernels' multiplies
and adds round apart, as the reference's unfused arithmetic does) except
those in ``FMA_SOURCES``: the attention and SSD kernels contract
multiply-adds, as they are held to a tolerance, not to bit parity.
``flash_attention`` links ``-lcuda`` (``LIBS``; with the toolkit's stub
directory on the search path where it has one) for libcuda's
``cuTensorMapEncodeTiled``.
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
    "join_probe": "join_probe.cu",
    "bloom": "bloom.cu",
    "sort_agg": "sort_agg.cu",
    "topk": "topk.cu",
    "filter_agg_q6": "filter_agg_q6.cu",
    "groupby_onehot": "groupby_onehot.cu",
    "flash_attention": "flash_attention.cu",
    "ssd_scan": "ssd_scan.cu",
}
HEADERS = ("scan_agg.cuh", "sortnet.cuh", "cuda_error.cuh")
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]
FMA_SOURCES = ("flash_attention", "ssd_scan")
# libraries linked after the source: the bf16 attention kernel encodes its
# TMA tensor maps with libcuda's cuTensorMapEncodeTiled
LIBS = {"flash_attention": ["-lcuda"]}

_P, _I, _L, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, \
    ctypes.c_uint, ctypes.c_float
# C signature of each library's launch function: columns, mask and rows,
# program, [K,] partials and output, grid, stream (the join adds the
# gathered-column mask, the probe key, the sorted build keys and the
# probe-predicate slot; the Bloom probe takes the key, mask, words, bits,
# k and its output; the sort kernels take the mask and rows, key
# columns, their output lanes and positions, the radix block rows, the
# radix scratch and its bytes, then the sort-aggregate's values, scan
# scratch and outputs, or the top-k's columns, limit and mask; the
# fixed-layout and model kernels take their tensors, shapes and scalars)
_ARGTYPES = {
    "filter_agg": [_P, _P, _I, _P, _L, _P, _P, _P, _P, _I, _P, _P, _I, _I,
                   _P],
    "groupby": [_P, _P, _I, _P, _L, _P, _P, _P, _P, _I, _I, _P, _P, _I, _I,
                _P],
    "join_probe": [_P, _P, _I, _U, _P, _L, _P, _I, _P, _L, _P, _P, _P, _P,
                   _I, _I, _I, _P, _P, _I, _I, _P],
    "bloom": [_P, _I, _P, _L, _P, _L, _I, _P, _I, _I, _P],
    "sort_agg": [_P, _L, _P, _I, _P, _P, _I, _P, _P, _I, _P, _L, _P, _P,
                 _P, _P, _P, _P],
    "topk": [_P, _L, _P, _P, _P, _I, _P, _P, _I, _P, _L, _P, _P, _P, _I,
             _L, _P, _P],
    "filter_agg_q6": [_P, _P, _P, _P, _L, _I, _I, _F, _F, _F, _P, _P, _I,
                      _P],
    "groupby_onehot": [_P, _P, _L, _I, _I, _P, _P, _I, _P],
    "flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                        _P],
    "ssd_scan": [_P] * 10 + [_I] * 7 + [_P],
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


def nvcc_flags(name: str) -> list[str]:
    """The flags of source ``name``: ``NVCC_FLAGS``, without
    ``-fmad=false`` for the ``FMA_SOURCES``."""
    if name in FMA_SOURCES:
        return [f for f in NVCC_FLAGS if f != "-fmad=false"]
    return list(NVCC_FLAGS)


def _link_flags(name: str, nvcc: str) -> list[str]:
    """``LIBS[name]``, with the toolkit's stub directory on the search
    path where it has one."""
    libs = LIBS.get(name, [])
    root = Path(nvcc).resolve().parents[1]
    stubs = [d for d in (root / "lib64" / "stubs",
                         root / "targets" / "x86_64-linux" / "lib" / "stubs")
             if d.is_dir()]
    return ([f"-L{stubs[0]}"] if libs and stubs else []) + libs


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for f in (SOURCES[name],) + HEADERS:
        h.update((_CSRC / f).read_bytes())
    h.update(" ".join(nvcc_flags(name) + LIBS.get(name, [])).encode())
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
        cmd = [nvcc, *nvcc_flags(name), "-o", str(tmp),
               str(_CSRC / SOURCES[name]), *_link_flags(name, nvcc)]
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


def sass(name: str) -> str:
    """The SASS of library ``name`` (``cuobjdump -sass``), built first if
    needed: what the card runs, e.g. to count its tensor-core
    instructions."""
    build_all()
    cuobjdump = Path(_nvcc()).parent / "cuobjdump"
    return subprocess.run([str(cuobjdump), "-sass", str(_lib_path(name))],
                          capture_output=True, text=True, check=True).stdout


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
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return lib


def check_mask(mask) -> None:
    if mask.dtype != torch.bool or mask.dim() != 1 \
            or not mask.is_contiguous():
        raise ValueError("mask must be a contiguous 1-D bool tensor")


def column_args(columns: dict, mask, prog, payload: dict | None = None,
                build_rows: int = 0) -> tuple:
    """Checked C arguments for a program's columns and the row mask:
    (column tensors kept alive, pointer array, type array, n_cols). A
    column the program gathers on the build side (``prog.gathered``)
    comes from ``payload`` and has ``build_rows`` rows."""
    check_mask(mask)
    cols = []
    gathered = prog.gathered or (False,) * len(prog.names)
    for name, g in zip(prog.names, gathered):
        c = payload[name] if g else columns[name]
        want = (build_rows,) if g else tuple(mask.shape)
        if c.device != mask.device or tuple(c.shape) != want:
            raise ValueError(f"column {name!r}: {tuple(c.shape)} on "
                             f"{c.device}, want {tuple(want)} on "
                             f"{mask.device}")
        if c.dtype not in DTYPE_CODES:
            raise TypeError(f"column {name!r}: dtype {c.dtype} unsupported")
        cols.append(c.contiguous())
    ptrs = (ctypes.c_int64 * MAX_COLS)(*[c.data_ptr() for c in cols])
    types = (ctypes.c_int * MAX_COLS)(*[DTYPE_CODES[c.dtype] for c in cols])
    return cols, ptrs, types, len(cols)


def ptr_array(tensors) -> ctypes.c_void_p:
    """The tensors' device pointers (0 for None) as a C int64 array (the
    returned pointer keeps the array alive)."""
    arr = (ctypes.c_int64 * max(len(tensors), 1))(
        *[t.data_ptr() if t is not None else 0 for t in tensors])
    return ctypes.cast(arr, ctypes.c_void_p)


def int_array(values) -> ctypes.c_void_p:
    """``values`` as a C int array (kept alive by the returned pointer)."""
    arr = (ctypes.c_int * max(len(values), 1))(*values)
    return ctypes.cast(arr, ctypes.c_void_p)


def sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def grid_ctas(tiling, n_rows: int, device) -> int:
    """CTAs to launch: the tiling's CTAs per SM times the SMs this card
    has, and no more than there are row blocks."""
    sms = sm_count(device)
    per_sm = max(1, tiling.ctas // H100_SXM["sm_count"])
    blocks = -(-max(n_rows, 1) // tiling.block_rows)
    return max(1, min(sms * per_sm, blocks))


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
