"""Host JPEG decode of the port (port of din_tpu/native/__init__.py:27-134).

``din_loader.cc`` (libjpeg with DCT prescale, then a half-pixel bilinear
resize; a batch is decoded by several threads inside one ctypes call, which
releases the interpreter lock) is built by g++ at first use into
``build/host_loader/<hash of the source and flags>/`` at the checkout's
root, under a temporary name moved into place with ``os.replace``, as
``ops/native.py`` builds the CUDA kernels: nothing is written beside the
source, and a half-written library is never loaded.

Where the build fails (no g++, no libjpeg headers) frames are decoded by
PIL, as in din_tpu.  That fallback is visible: ``decoder()`` names the
decoder in use, gives the build's error text, and counts the frames each
path decoded in this process.
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

SRC = Path(__file__).resolve().with_name("din_loader.cc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host_loader"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
LIBS = ("-ljpeg",)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_error: Optional[str] = None
_count_lock = threading.Lock()
_frames = {"native": 0, "pil": 0}


def library_path() -> Path:
    """Path of the library for the current source and flags."""
    h = hashlib.sha256(" ".join(GXX_FLAGS + LIBS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / "libdin_loader.so"


def build() -> Path:
    """Compile ``din_loader.cc`` (reusing a finished build of the same
    source); raises RuntimeError with the compiler's output on failure."""
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    cmd = ["g++", *GXX_FLAGS, str(SRC), *LIBS, "-o", tmp]
    try:
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=120)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
        if res.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed (exit "
                               f"{res.returncode}):\n{res.stdout}{res.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, built on first use; None when the build
    or the load failed (``decoder()`` says why)."""
    global _lib, _tried, _error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError) as e:
            _error = str(e)
            return None
        lib.din_decode_resize.restype = ctypes.c_int
        lib.din_decode_resize.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8)]
        lib.din_decode_resize_batch.restype = ctypes.c_int
        lib.din_decode_resize_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_long), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def decoder() -> dict:
    """The decoder in use: ``{"decoder": "native" | "pil" | None, "error":
    why the native one is not in use (None when it is), "frames":
    {"native": n, "pil": n}}``, the frames each path decoded so far in this
    process.  ``None`` means neither builds nor imports: decoding raises."""
    if available():
        name = "native"
    else:
        name = "pil" if importlib.util.find_spec("PIL") is not None else None
    with _count_lock:
        frames = dict(_frames)
    return {"decoder": name, "error": _error, "frames": frames}


def _count(path: str, n: int) -> None:
    with _count_lock:
        _frames[path] += n


def _require_lib() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_error}")
    return lib


def decode_resize(jpeg_bytes: bytes, out_h: int, out_w: int) -> np.ndarray:
    """Decode one JPEG to uint8 RGB [out_h, out_w, 3] (native path).
    Raises RuntimeError on a decode failure or with no native library."""
    lib = _require_lib()
    out = np.empty((out_h, out_w, 3), np.uint8)
    rc = lib.din_decode_resize(
        jpeg_bytes, len(jpeg_bytes), out_h, out_w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise RuntimeError(f"native jpeg decode failed (rc={rc})")
    _count("native", 1)
    return out


def decode_resize_batch(jpegs: List[bytes], out_h: int, out_w: int,
                        n_threads: int = 4) -> np.ndarray:
    """Decode a batch of JPEGs to uint8 [n, out_h, out_w, 3] with
    ``n_threads`` decoder threads; raises if any frame fails."""
    lib = _require_lib()
    n = len(jpegs)
    out = np.empty((n, out_h, out_w, 3), np.uint8)
    bufs = (ctypes.c_char_p * n)(*jpegs)
    lens = (ctypes.c_long * n)(*[len(j) for j in jpegs])
    failures = lib.din_decode_resize_batch(
        bufs, lens, n, out_h, out_w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n_threads)
    if failures:
        raise RuntimeError(f"native jpeg decode failed for {failures} frames")
    _count("native", n)
    return out


def load_frames(paths: List[str], out_h: int, out_w: int,
                n_threads: Optional[int] = None) -> np.ndarray:
    """Decode+resize a clip's JPEG files in one native batch call, else
    frame by frame through ``load_frame``.  Returns uint8
    [len(paths), out_h, out_w, 3].

    ``n_threads=None``: serial on a single core (thread thrash measured 4x
    slower there in din_tpu), else up to 4 decoder threads."""
    if n_threads is None:
        n_threads = max(1, min(4, (os.cpu_count() or 1) - 1))
    try:
        datas = [Path(p).read_bytes() for p in paths]
        return decode_resize_batch(datas, out_h, out_w, n_threads)
    except (RuntimeError, OSError):
        return np.stack([load_frame(p, out_h, out_w) for p in paths])


def load_frame(path: str, out_h: int, out_w: int) -> np.ndarray:
    """Decode+resize one image file: native, else PIL (a file libjpeg
    rejects, or no native library)."""
    try:
        return decode_resize(Path(path).read_bytes(), out_h, out_w)
    except (RuntimeError, OSError):
        from PIL import Image
        with Image.open(path) as img:
            rgb = img.convert("RGB").resize((out_w, out_h), Image.BILINEAR)
        _count("pil", 1)
        return np.asarray(rgb, np.uint8)
