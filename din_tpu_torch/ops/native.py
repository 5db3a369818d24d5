"""Build and bind the hand-written CUDA kernels of ``din_tpu_torch/csrc``.

The sources have a plain C interface and include no PyTorch header, so they
build with ``nvcc`` alone in seconds (one ``nvcc -c`` per source, all started
together, then one link) into ``build/torch_kernels/`` at the checkout's
root, and load with ``ctypes``.  The library is keyed on a hash of the
sources and the flags, written under a temporary name and moved into place
with ``os.replace``, so a finished build is reused and a half-written one
is never loaded.

Nothing here runs at import: the CPU tests import every module on a host
with no ``nvcc`` and no card.  ``library()`` builds and loads on first use;
``check(code)`` turns a non-zero ``cudaGetLastError()`` returned by an entry
point into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas", "-v")

# dtype codes of csrc/common.cuh
DTYPE_F32 = 0
DTYPE_BF16 = 1

_c_i64 = ctypes.c_int64
_c_ptr = ctypes.c_void_p
_SIGNATURES = {
    # x, y, F, H, W, C, dtype, stream
    "din_max_pool_2x2": [_c_ptr, _c_ptr, _c_i64, _c_i64, _c_i64, _c_i64,
                         ctypes.c_int, _c_ptr],
    # x, g, dx, F, H, W, C, dtype, stream
    "din_max_pool_2x2_bwd": [_c_ptr, _c_ptr, _c_ptr, _c_i64, _c_i64, _c_i64,
                             _c_i64, ctypes.c_int, _c_ptr],
    # features, boxes, out, B, H, W, C, N, KH, KW, dtype, stream
    "din_roi_align": [_c_ptr, _c_ptr, _c_ptr, _c_i64, _c_i64, _c_i64, _c_i64,
                      _c_i64, _c_i64, _c_i64, ctypes.c_int, _c_ptr],
    # g, boxes, df, B, H, W, C, N, KH, KW, dtype, stream
    "din_roi_align_bwd": [_c_ptr, _c_ptr, _c_ptr, _c_i64, _c_i64, _c_i64,
                          _c_i64, _c_i64, _c_i64, _c_i64, ctypes.c_int,
                          _c_ptr],
    # x, w0, b0, w2, b2, out, F, H, W, dtype, stream
    "din_fused_stem": [_c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_i64,
                       _c_i64, _c_i64, ctypes.c_int, _c_ptr],
}

_lock = threading.Lock()
_lib = None


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                       "the CUDA kernels of din_tpu_torch cannot be built")


def library_path() -> Path:
    """Path of the library for the current sources and flags."""
    srcs, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libdin_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every ``csrc/*.cu`` in parallel and link one shared library.

    Returns its path; reuses a finished build of the same sources.  The
    compiler's output (``-Xptxas -v``: registers, shared memory, spills of
    each kernel) is kept beside it as ``<library>.log``.
    """
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    srcs, _ = _sources()
    work = Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_DIR))
    try:
        procs = []
        for src in srcs:
            obj = work / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xcompiler", "-fPIC", "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_so = work / so.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_so)] +
            [str(obj) for _, obj, _ in procs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (work / "build.log").write_text("\n".join(log))
        os.replace(work / "build.log", str(so) + ".log")
        os.replace(tmp_so, so)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.din_error_string.argtypes = [ctypes.c_int]
            lib.din_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = library().din_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def dtype_code(dtype) -> int:
    if dtype == torch.float32:
        return DTYPE_F32
    if dtype == torch.bfloat16:
        return DTYPE_BF16
    raise TypeError(f"CUDA kernels take float32 or bfloat16, got {dtype}")


def require_cuda_input(t: torch.Tensor, name: str, dtypes, ndim: int,
                       contiguous: bool = True) -> None:
    """Checks a CUDA kernel input; raises on anything the kernel does not
    take (no copy, no fallback).  ``contiguous=False`` leaves the layout to
    the caller."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (NHWC)")


def current_stream(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
