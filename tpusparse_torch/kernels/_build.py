"""Build the CUDA sources into one shared library at first use, load it
with ctypes.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a``, then the objects are linked into
``tpusparse_torch/_build/<hash>/libtpusparse_torch.so``, keyed by a hash of
the sources and flags. The sources have a plain C interface: every pointer
and the stream are ``c_void_p``, every size a ``c_int``, and every entry
returns ``cudaGetLastError()`` after its launches, which ``check`` turns
into an exception. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from tpusparse_torch.utils import cdiv

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("sell_spmv.cu", "dense.cu", "awsp_spmv.cu", "rsell_spmv.cu",
           "permute.cu", "asp_spmv.cu", "bsr_spmv.cu", "bsell_spmv.cu",
           "dia_spmv.cu", "sell_grad.cu", "bell_spmv.cu",
           "sell_mxu_spmm.cu", "group_plan.cu")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "--ptxas-options=-v")

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # idx, vals, vals_kind, x, scales, part, y, nb, nt, w, batch, ldx,
    # slices, per_slice, n, bb, stages, device, stream
    "tps_sell_spmm": [_P, _P, _I, _P, _P, _P, _P] + [_I] * 11 + [_P],
    # plan, count, idx, vals, vals_kind, x, part, y, counters, nb, ntot, g,
    # plan_len, w, batch, ldx, slices, n, device, stream
    "tps_awsp_spmm": [_P] * 4 + [_I] + [_P] * 4 + [_I] * 10 + [_P],
    # x, plan, count, counters, batch, ldx, ng, span, device, stream
    "tps_group_plan": [_P] * 4 + [_I] * 5 + [_P],
    # a, x, part, y, counters, m, n, batch, slices, per_slice, device,
    # stream
    "tps_dense_spmm": [_P] * 5 + [_I] * 6 + [_P],
    # items, gptr, ct, idx, vals, x, part, y, src, nitems, batch, ldx, n,
    # ldy, device, stream
    "tps_rsell_spmm": [_P] * 9 + [_I] * 6 + [_P],
    # y0, y1, y2, src, out, ld0, ld1, ld2, batch, n, device, stream
    "tps_permute_columns": [_P] * 5 + [_I] * 6 + [_P],
    # plan, count, a, x, y, rows, lda, n, batch, ldx, plan_len, cluster,
    # device, stream
    "tps_asp_spmm": [_P] * 5 + [_I] * 8 + [_P],
    # items, gptr, bi, blocks, x, part, y, nitems, block_m, batch, ldx, n,
    # device, stream
    "tps_bsr_spmm": [_P] * 7 + [_I] * 6 + [_P],
    # items, gptr, bi, idx, vals, x, part, y, nitems, w, batch, ldx, n,
    # device, stream
    "tps_bsell_spmm": [_P] * 8 + [_I] * 6 + [_P],
    # offsets (host int32), vals, x, y, k, sym, n, ldv, device, stream
    "tps_dia_spmv": [_P] * 4 + [_I] * 5 + [_P],
    # idx_signed, x, g, out, nb, nt, w, batch, ldx, ldg, device, stream
    "tps_sell_dvals": [_P] * 4 + [_I] * 7 + [_P],
    # bitmap, vals, x, part, y, counters, nb, mb, block_m, w, batch, ldx,
    # slices, per_slice, n, bb, device, stream
    "tps_bell_spmm": [_P] * 6 + [_I] * 11 + [_P],
    # idx, vals, x, part, y, counters, nb, nt, w, batch, ldx, slices,
    # per_slice, n, device, stream
    "tps_sell_mxu_spmm": [_P] * 6 + [_I] * 9 + [_P],
}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build tpusparse_torch's kernels")
    return path


def _key() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if not built yet for these sources) and return the .so path.
    The compiler's register/shared-memory report is kept in build.log."""
    out_dir = BUILD_DIR / _key()
    lib_path = out_dir / "libtpusparse_torch.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cc = nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in SOURCES:
            obj = Path(tmp) / (Path(src).stem + ".o")
            cmd = [cc, *FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src}\n{text}")
            if proc.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [cc, "-shared", "-o", str(tmp_lib), *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (Path(tmp) / "build.log").write_text("\n".join(log))
        out_dir.mkdir(exist_ok=True)
        os.replace(Path(tmp) / "build.log", out_dir / "build.log")
        os.replace(tmp_lib, lib_path)   # last: its presence means "built"
    return lib_path


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    so = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(so, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    so.tps_error_string.argtypes = [ctypes.c_int]
    so.tps_error_string.restype = ctypes.c_char_p
    return so


def check(rc: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if rc != 0:
        msg = lib().tps_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_work(units: int, blocks: int, device: torch.device) -> tuple[int, int]:
    """(per_slice, slices): cut ``units`` (windows, plan items or rows) into
    slices so that ``blocks`` x slices blocks fill the card about eight
    blocks per SM deep."""
    return split_slices(units, blocks, sm_count(device))


def split_slices(units: int, blocks: int, sms: int) -> tuple[int, int]:
    """``split_work`` on a card of ``sms`` SMs."""
    want = max(1, min(units, cdiv(8 * sms, max(blocks, 1))))
    per = max(1, cdiv(units, want))
    return per, max(1, cdiv(units, per))


def sm_count(device: torch.device) -> int:
    return _sm_count(device.index)


# Dynamic shared memory a block may opt in to on an H100 (227 KB), less 1 KB
# for a kernel's static shared memory; and an SM's shared memory (228 KB),
# of which each resident block also takes 1 KB.
SMEM_LIMIT = 232448 - 1024
SM_SMEM = 233472


@functools.cache
def _smem_limit(index: int) -> int:
    props = torch.cuda.get_device_properties(index)
    return getattr(props, "shared_memory_per_block_optin", SMEM_LIMIT + 1024) \
        - 1024


def smem_limit(device: torch.device) -> int:
    """The dynamic shared memory a block of a kernel with up to 1 KB of
    static shared memory may use on ``device``."""
    return _smem_limit(device.index)


def launch_shape(units: int, groups: int, slots: int,
                 quantum: int = 1) -> tuple[int, int]:
    """(per_slice, slices) for a kernel whose blocks each own one of
    ``groups`` (column group, batch tile) pairs and a contiguous run of
    ``units`` (windows or rows): the most slices, each a multiple of
    ``quantum`` units, for which ``groups`` x slices blocks fit the card's
    ``slots`` resident blocks in one wave. Slice k covers units
    [k * per_slice, min(units, (k + 1) * per_slice)): every unit once."""
    want = max(1, min(cdiv(units, quantum), slots // max(groups, 1)))
    per = max(quantum, cdiv(cdiv(units, want), quantum) * quantum)
    return per, max(1, cdiv(units, per))


_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def arrival_counters(device: torch.device, count: int) -> torch.Tensor:
    """The int32 arrival counters of the fused split reduce
    (``csrc/split_reduce.cuh``) for the current stream of ``device``: at
    least ``count``, all 0 between calls. Allocated and zeroed once per
    (device, stream), and again only to grow; every call leaves them at 0."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    have = _COUNTERS.get(key)
    if have is None or have.numel() < count:
        have = torch.zeros(max(count, 4096), dtype=torch.int32, device=device)
        _COUNTERS[key] = have
    return have


def require_cuda(name: str, *tensors: torch.Tensor,
                 aligned: tuple[torch.Tensor, ...] = ()) -> torch.device:
    """All tensors contiguous on one CUDA device, and those in ``aligned``
    16-byte aligned (the kernels read them with vector loads); returns the
    device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: tensors must share one CUDA device, "
                             f"got {[str(u.device) for u in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in aligned):
        raise ValueError(f"{name}: packed arrays must be 16-byte aligned")
    return dev
