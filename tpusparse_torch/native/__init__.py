"""The native host converters: ``converters.cpp`` through ctypes.

Counterpart of ``tpusparse/native/__init__.py``. ``converters.cpp`` is the
JAX package's source, copied: streaming C++ packers (OpenMP over column
tiles) for CSR-from-dense, SELL, RSELL, BELL's bitmap and AMG's Vanek
aggregation, each bit-identical to the numpy path beside it in
``formats/`` and ``amg.py``. The library is built with ``g++`` at first
use, never at import, into ``tpusparse_torch/_build/native/``, keyed by a
hash of the source and the flags; the build writes a name of its own and
``os.replace``s it, so that processes building at once cannot read a half-
written file.

``available()`` says whether the library built and loaded: the packers
take the native path exactly then, unless called with
``use_native=False``; ``use_native=True`` raises when it is unavailable.
``build_error()`` holds the compiler's message when the build failed.
Every wrapper returns None when the library is unavailable (or the input
is not fp32, for the fp32-only packers), and the caller takes its numpy
path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "converters.cpp"
BUILD_DIR = _DIR.parent / "_build" / "native"
# no -march=native: the build directory may be copied to another host, and
# no contraction into FMAs, which would round differently from numpy
FLAGS = ("-O3", "-shared", "-fPIC", "-fopenmp", "-ffp-contract=off")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | bool | None = None      # None: untried, False: failed
_ERROR: list[str] = []


def _build() -> Path | None:
    tag = hashlib.sha256(_SRC.read_bytes() + " ".join(FLAGS).encode()) \
        .hexdigest()[:16]
    so = BUILD_DIR / f"converters_{tag}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, "-o", str(tmp), str(_SRC)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=300)
        os.replace(tmp, so)
        return so
    except subprocess.CalledProcessError as e:
        _ERROR.append(f"{' '.join(cmd)}: {e.stderr.strip()}")
    except (subprocess.SubprocessError, OSError) as e:
        _ERROR.append(f"{' '.join(cmd)}: {e}")
    tmp.unlink(missing_ok=True)
    return None


def _lib() -> ctypes.CDLL | None:
    global _LIB
    with _LOCK:
        if _LIB is None:
            so = _build()
            if so is None:
                _LIB = False
            else:
                lib = ctypes.CDLL(str(so))
                _declare(lib)
                _LIB = lib
    return _LIB or None


def _declare(lib: ctypes.CDLL) -> None:
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    fp = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.sell_max_window_nnz.argtypes = [fp, i64, i64]
    lib.sell_max_window_nnz.restype = i32
    lib.sell_fill.argtypes = [fp, i64, i64, i64, fp, i8p]
    lib.sell_fill.restype = i32
    lib.csr_count.argtypes = [fp, i64, i64, i32p]
    lib.csr_count.restype = None
    lib.csr_fill.argtypes = [fp, i64, i64, i32p, i32p, fp]
    lib.csr_fill.restype = None
    lib.bell_bitmap.argtypes = [fp, i64, i64, i64, u32p]
    lib.bell_bitmap.restype = None
    lib.sell_fill_csr.argtypes = [i32p, i32p, fp, i64, i64, i64,
                                  ctypes.c_void_p, ctypes.c_void_p]
    lib.sell_fill_csr.restype = i32
    lib.rsell_demand_csr.argtypes = [i32p, i32p, i64, i64, i32p]
    lib.rsell_demand_csr.restype = None
    lib.rsell_fill_csr.argtypes = [i32p, i32p, fp, i64, i64, i64p, fp, i8p]
    lib.rsell_fill_csr.restype = None
    lib.amg_aggregate.argtypes = [i32p, i32p, f64p, f64p, i64,
                                  ctypes.c_double, i64p]
    lib.amg_aggregate.restype = i64


def available() -> bool:
    """True when the library built and loaded (the packers' native path
    runs); builds it on the first call."""
    return _lib() is not None


def build_error() -> str | None:
    """The failed build's command and message, or None."""
    return _ERROR[-1] if _ERROR else None


def sell_max_window_nnz(a: np.ndarray) -> int | None:
    lib = _lib()
    if lib is None or a.dtype != np.float32:
        return None
    a = np.ascontiguousarray(a)
    return int(lib.sell_max_window_nnz(a, a.shape[0], a.shape[1]))


def sell_fill(a: np.ndarray, w: int) -> tuple[np.ndarray, np.ndarray] | None:
    """(vals, idx) with shapes (nb, nt, w, 128) from a dense (mp, np) A,
    both multiples of 128."""
    lib = _lib()
    if lib is None or a.dtype != np.float32:
        return None
    a = np.ascontiguousarray(a)
    mp, np_ = a.shape
    nb, nt = np_ // 128, mp // 128
    vals = np.zeros((nb, nt, w, 128), np.float32)
    idx = np.zeros((nb, nt, w, 128), np.int8)
    if lib.sell_fill(a, mp, np_, w, vals, idx) != 0:
        raise ValueError(f"w={w} overflowed during native sell_fill")
    return vals, idx


def csr_from_dense(a: np.ndarray):
    """(row_ptr, col_idx, values) of the CSR of A.T."""
    lib = _lib()
    if lib is None or a.dtype != np.float32:
        return None
    a = np.ascontiguousarray(a)
    m, n = a.shape
    cnt = np.zeros(n, np.int32)
    lib.csr_count(a, m, n, cnt)
    row_ptr = np.zeros(n + 1, np.int32)
    np.cumsum(cnt, out=row_ptr[1:])
    nnz = int(row_ptr[-1])
    col_idx = np.zeros(nnz, np.int32)
    values = np.zeros(nnz, np.float32)
    lib.csr_fill(a, m, n, row_ptr, col_idx, values)
    return row_ptr, col_idx, values


def sell_fill_csr(row_ptr: np.ndarray, col_idx: np.ndarray,
                  values: np.ndarray, n: int, nt: int,
                  w: int | None) -> tuple | None:
    """(vals, idx, w) straight from CSR arrays (rows sorted); with
    ``w=None`` a first counting pass picks the width."""
    lib = _lib()
    if lib is None or values.dtype != np.float32:
        return None
    row_ptr = np.ascontiguousarray(row_ptr, np.int32)
    col_idx = np.ascontiguousarray(col_idx, np.int32)
    values = np.ascontiguousarray(values, np.float32)
    if w is None:
        mx = int(lib.sell_fill_csr(row_ptr, col_idx, values, n, nt, 0,
                                   None, None))
        w = max(((mx + 7) // 8) * 8, 8)
    nb = -(-n // 128)
    vals = np.zeros((nb, nt, w, 128), np.float32)
    idx = np.zeros((nb, nt, w, 128), np.int8)
    ret = int(lib.sell_fill_csr(row_ptr, col_idx, values, n, nt, w,
                                vals.ctypes.data, idx.ctypes.data))
    if ret < 0:
        raise ValueError(f"w={w} overflowed during native sell_fill_csr")
    return vals, idx, w


def rsell_demand_csr(row_ptr: np.ndarray, col_idx: np.ndarray, n: int,
                     nt: int) -> np.ndarray | None:
    """(nb, nt) int32 per-tile width demand from CSR arrays."""
    lib = _lib()
    if lib is None:
        return None
    row_ptr = np.ascontiguousarray(row_ptr, np.int32)
    col_idx = np.ascontiguousarray(col_idx, np.int32)
    nb = -(-n // 128)
    demand = np.zeros((nb, nt), np.int32)
    lib.rsell_demand_csr(row_ptr, col_idx, n, nt, demand)
    return demand


def rsell_fill_csr(row_ptr: np.ndarray, col_idx: np.ndarray,
                   values: np.ndarray, n: int, nt: int,
                   tile_chunk_base: np.ndarray,
                   nchunk: int) -> tuple | None:
    """(vals, idx) chunk payloads (fp32 only)."""
    lib = _lib()
    if lib is None or values.dtype != np.float32:
        return None
    row_ptr = np.ascontiguousarray(row_ptr, np.int32)
    col_idx = np.ascontiguousarray(col_idx, np.int32)
    values = np.ascontiguousarray(values, np.float32)
    base = np.ascontiguousarray(tile_chunk_base, np.int64)
    vals = np.zeros((nchunk, 8, 128), np.float32)
    idx = np.zeros((nchunk, 8, 128), np.int8)
    lib.rsell_fill_csr(row_ptr, col_idx, values, n, nt, base, vals, idx)
    return vals, idx


def bell_bitmap(a: np.ndarray, block_m: int) -> np.ndarray | None:
    """(nb, mb, 128, BM/32) uint32 bitmap of a dense (mp, np) A."""
    lib = _lib()
    if lib is None or a.dtype != np.float32:
        return None
    a = np.ascontiguousarray(a)
    mp, np_ = a.shape
    mb, nb = mp // block_m, np_ // 128
    bitmap = np.zeros((nb, mb, 128, block_m // 32), np.uint32)
    lib.bell_bitmap(a, mp, np_, block_m, bitmap)
    return bitmap


def amg_aggregate(indptr: np.ndarray, indices: np.ndarray,
                  absdata: np.ndarray, diagabs: np.ndarray,
                  theta: float) -> tuple[np.ndarray, int] | None:
    """Vanek 3-pass aggregation over CSR arrays (``amg._aggregate``):
    (agg ids, n_agg). None also when the arrays pass int32, which the C
    path takes."""
    lib = _lib()
    if lib is None:
        return None
    n = len(indptr) - 1
    if n > np.iinfo(np.int32).max or \
            (len(indptr) and int(indptr[-1]) > np.iinfo(np.int32).max):
        return None
    indptr = np.ascontiguousarray(indptr, np.int32)
    indices = np.ascontiguousarray(indices, np.int32)
    absdata = np.ascontiguousarray(absdata, np.float64)
    diagabs = np.ascontiguousarray(diagabs, np.float64)
    agg = np.empty(n, np.int64)
    n_agg = lib.amg_aggregate(indptr, indices, absdata, diagabs, n,
                              float(theta), agg)
    return agg, int(n_agg)
