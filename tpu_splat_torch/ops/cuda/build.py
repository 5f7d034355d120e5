"""Build and load the port's CUDA kernels (`tpu_splat_torch/csrc/*.cu`).

Each source compiles with nvcc into its own shared library with a plain C interface,
loaded with ctypes. Libraries are built at first use into `build/kernels/` at the
repository root (listed in .gitignore), named by a hash of the source, the shared headers
(`csrc/*.cuh`) and the flags, so an edited source rebuilds and an unchanged one is reused.
`build_all()` starts one nvcc per source at once.

Flags: sm_90a (Hopper), -O3, and --fmad=false so that separate multiplies and adds
round exactly as PyTorch's elementwise ops do (the blend's stop decisions are compared
bit for bit with its plain version); kernels that want a fused multiply-add call fmaf.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


class Camera(ctypes.Structure):
    """`struct Camera` of csrc/gut_project.cu, passed by value: the camera's scalars."""

    _fields_ = [("model", _I), ("width", _I), ("height", _I), ("tile_size", _I),
                ("fx", _F), ("fy", _F), ("cx", _F), ("cy", _F), ("rfx", _F), ("rfy", _F),
                ("lo_x", _F), ("hi_x", _F), ("lo_y", _F), ("hi_y", _F), ("max_angle", _F),
                ("coef", _F * 12), ("dk", _F * 3)]


class UtConsts(ctypes.Structure):
    """`struct UtConsts` of csrc/gut_project.cu, passed by value: the UT's constants."""

    _fields_ = [("sqrt_dl", _F), ("wm0", _F), ("wc0", _F), ("wi", _F), ("eps2d", _F),
                ("min_alpha", _F), ("max_extent", _F), ("near", _F)]


class ProjCamera(ctypes.Structure):
    """`struct ProjCamera` of csrc/projection.cu, passed by value: the pinhole camera's
    scalars and the SH bands the projection evaluates."""

    _fields_ = [("width", _I), ("height", _I), ("tile_size", _I), ("sh_degree", _I),
                ("sh_rest", _I), ("fx", _F), ("fy", _F), ("cx", _F), ("cy", _F),
                ("lo_x", _F), ("hi_x", _F), ("lo_y", _F), ("hi_y", _F)]


class AdamLeaf(ctypes.Structure):
    """`struct AdamLeaf` of csrc/adam.cu: one leaf's seven tensors, its element count, its
    learning rate and bias corrections' reciprocals, and whether its pointers are 16-byte
    aligned."""

    _fields_ = [("p", _P), ("g", _P), ("m", _P), ("v", _P), ("p_out", _P), ("m_out", _P),
                ("v_out", _P), ("n", _L), ("lr", _F), ("inv_bc1", _F), ("inv_bc2", _F),
                ("vec", _I)]


ADAM_MAX_LEAVES = 6  # kMaxLeaves of csrc/adam.cu


class AdamArgs(ctypes.Structure):
    """`struct AdamArgs` of csrc/adam.cu, passed by value: the leaves of one launch."""

    _fields_ = [("leaf", AdamLeaf * ADAM_MAX_LEAVES), ("n_leaves", _I)]


# C entry point of each library: (symbol, argtypes), built from `csrc/<name>.cu` unless
# `_SOURCE` names another source; every one returns a cudaError_t
ENTRY_POINTS = {
    "expand": ("tpu_splat_expand", (_P, _P, _P, _I, _I, _P, _P, _P)),
    "blend_fwd": ("tpu_splat_blend_fwd",
                  (_P, _I, _L, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P)),
    "blend_bwd": ("tpu_splat_blend_bwd",
                  (_P, _I, _L, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _L, _P)),
    "segsum": ("tpu_splat_segsum", (_P, _I, _L, _P, _I, _I, _P, _P, _I, _P, _L, _P)),
    "gut_fwd": ("tpu_splat_gut_fwd",
                (_P, _L, _P, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P)),
    "gut_bwd": ("tpu_splat_gut_bwd",
                (_P, _L, _P, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _L, _P)),
    "segprefix": ("tpu_splat_segprefix", (_P, _I, _L, _P, _I, _I, _P, _P, _P, _P, _I, _P)),
    "gut_project": ("tpu_splat_ut_project",
                    (_P, _P, _P, _P, _P, _I, _P, _P, _P, Camera, UtConsts,
                     _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P)),
    "gut_rays": ("tpu_splat_gut_rays", (_P, _P, _P, Camera, _I, _I, _I, _P, _P)),
    "projection": ("tpu_splat_project_fwd",
                   (_P, _P, _P, _P, _P, _P, _P, _I, _P, _P, ProjCamera,
                    _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P)),
    "projection_bwd": ("tpu_splat_project_bwd",
                       (_P, _P, _P, _P, _P, _P, _I, _P, _P, ProjCamera,
                        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P)),
    "adam": ("tpu_splat_adam", (AdamArgs, _P)),
}
# the source of an entry point whose library is not `<name>.cu`
_SOURCE = {"gut_rays": "gut_project", "projection_bwd": "projection"}

_loaded: dict[str, ctypes._CFuncPtr] = {}
# one build and load at a time: the live viewer renders from HTTP threads while the
# trainer's thread may be loading the same library (the temporary file is per process)
_build_lock = threading.Lock()
_count_lock = threading.Lock()


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA "
                           "toolkit is installed")
    return found


def source_name(name: str) -> str:
    """The source (`csrc/<source>.cu`) that entry point `name` is built from."""
    return _SOURCE.get(name, name)


def library_path(name: str) -> Path:
    name = source_name(name)
    h = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _tmp_path(lib: Path) -> Path:
    return lib.parent / f"{lib.stem}.{os.getpid()}.tmp"


def _start_build(name: str) -> subprocess.Popen | None:
    lib = library_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _tmp_path(lib)
    log = open(lib.with_suffix(".log"), "w")
    try:
        return subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
             str(SRC_DIR / f"{source_name(name)}.cu")],
            stdout=log, stderr=subprocess.STDOUT,
        )
    finally:
        log.close()


def _finish_build(name: str, proc: subprocess.Popen | None) -> None:
    if proc is None:
        return
    lib = library_path(name)
    tmp = _tmp_path(lib)
    if proc.wait() != 0:
        raise RuntimeError(
            f"nvcc failed for {source_name(name)}.cu:\n{lib.with_suffix('.log').read_text()}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees the whole file or none


def build_all() -> dict[str, Path]:
    """Build every kernel library, one nvcc per source in parallel. -> {source: .so}"""
    procs = {src: _start_build(src) for src in dict.fromkeys(map(source_name, ENTRY_POINTS))}
    for name, proc in procs.items():
        _finish_build(name, proc)
    return {name: library_path(name) for name in procs}


def build_log(name: str) -> str:
    """nvcc/ptxas output of the last build of `name` (registers, spills), or ''."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def kernel(name: str):
    """The ctypes function of kernel library `name`, built and loaded at first use."""
    with _build_lock:
        if name not in _loaded:
            _finish_build(name, _start_build(name))
            symbol, argtypes = ENTRY_POINTS[name]
            fn = getattr(ctypes.CDLL(str(library_path(name))), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = fn
        return _loaded[name]


def count_launch(wrapper) -> None:
    """Add one to `wrapper.launches` (a kernel wrapper's launch count), under a lock: the
    wrappers run from the trainer's thread and from the live viewer's at once."""
    with _count_lock:
        wrapper.launches += 1


def check(err: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {err}")


def require_cuda(ref, **tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on `ref`'s device: what a
    kernel wrapper demands of a tensor that is not on the CPU."""
    for name, x in tensors.items():
        if not x.is_cuda or not x.is_contiguous() or x.device != ref.device:
            raise ValueError(f"{name} must be a contiguous CUDA tensor on {ref.device}")
