"""JPEG decode through nvJPEG from the CUDA toolkit (`io/native/nvjpeg_decode.cpp`).

Built at first use with g++ into `build/io/` at the repository root (listed in
.gitignore), named by a hash of the source, and loaded with ctypes; ctypes releases the
GIL for the call, so the dataloader's prefetch threads decode in parallel. Where the
toolkit (nvjpeg.h, libnvjpeg) or g++ is missing, `decode_jpeg` raises and says what is
missing: there is no other JPEG decoder to fall back to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "native" / "nvjpeg_decode.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "io"
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def cuda_home() -> Path:
    """The CUDA toolkit that holds nvJPEG; raises when there is none."""
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "include" / "nvjpeg.h").exists():
            return Path(cand)
    raise RuntimeError(
        "JPEG decoding needs nvJPEG from the CUDA toolkit (include/nvjpeg.h and "
        "libnvjpeg under $CUDA_HOME or /usr/local/cuda), and none was found; PNG "
        "images decode without it")


def _build() -> Path:
    cuda = cuda_home()
    if shutil.which("g++") is None:
        raise RuntimeError("JPEG decoding builds its nvJPEG binding with g++, not found")
    digest = hashlib.sha256(_SRC.read_bytes() + str(cuda).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"nvjpeg_decode-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.parent / f"{lib.stem}.{os.getpid()}.tmp"
    libdir = cuda / "lib64"
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", str(_SRC), f"-I{cuda / 'include'}",
           f"-L{libdir}", f"-Wl,-rpath,{libdir}", "-lnvjpeg", "-lcudart", "-o", str(tmp)]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"building the nvJPEG binding failed:\n{r.stderr[-2000:]}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees the whole file or none
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            lib.tpu_splat_jpeg_size.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int)]
            lib.tpu_splat_jpeg_size.restype = ctypes.c_int
            lib.tpu_splat_jpeg_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            lib.tpu_splat_jpeg_decode.restype = ctypes.c_int
            _lib = lib
        return _lib


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> uint8 [H, W, 3] (RGB)."""
    lib = _library()
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.tpu_splat_jpeg_size(data, len(data), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise RuntimeError(f"nvJPEG could not read the JPEG header (code {rc})")
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.tpu_splat_jpeg_decode(data, len(data), out.ctypes.data, w.value, h.value)
    if rc != 0:
        raise RuntimeError(f"nvJPEG failed to decode the image (code {rc})")
    return out
