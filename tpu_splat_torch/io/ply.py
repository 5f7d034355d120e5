"""Gaussian PLY export/import — INRIA-compatible interchange schema.

Exact layout of SplatData::save_ply (src/core/splat_data.cpp:113-169,402-507, SURVEY.md §8.1):
binary-little-endian, one `vertex` element, all FLOAT32, attribute order
  x y z, nx ny nz (zeros), f_dc_0..2, f_rest_0..(3*(K-1)-1), opacity, scale_0..2, rot_0..3
f_rest is CHANNEL-MAJOR (all R coeffs, then G, then B — [N,K-1,3].transpose(1,2).flatten);
opacity is the raw logit, scale_* raw log, rot_* the quaternion normalized at export (wxyz).
Self-contained codec (no plyfile dependency).
"""

from __future__ import annotations

import io
from pathlib import Path

import numpy as np


def _attribute_names(sh_rest_coeffs: int) -> list[str]:
    names = ["x", "y", "z", "nx", "ny", "nz", "f_dc_0", "f_dc_1", "f_dc_2"]
    names += [f"f_rest_{i}" for i in range(3 * sh_rest_coeffs)]
    names += ["opacity", "scale_0", "scale_1", "scale_2", "rot_0", "rot_1", "rot_2", "rot_3"]
    return names


def save_splat_ply(
    path: str | Path,
    means: np.ndarray,  # [N,3]
    sh0: np.ndarray,  # [N,1,3]
    shN: np.ndarray,  # [N,K-1,3]
    scaling_raw: np.ndarray,  # [N,3] log
    rotation_raw: np.ndarray,  # [N,4] wxyz (normalized on write)
    opacity_raw: np.ndarray,  # [N,1] logit
) -> None:
    n = means.shape[0]
    k_rest = shN.shape[1]
    names = _attribute_names(k_rest)

    q = np.asarray(rotation_raw, np.float32)
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)

    cols = [
        np.asarray(means, np.float32),
        np.zeros((n, 3), np.float32),  # normals
        np.asarray(sh0, np.float32).reshape(n, 3),
        np.asarray(shN, np.float32).transpose(0, 2, 1).reshape(n, 3 * k_rest),  # channel-major
        np.asarray(opacity_raw, np.float32).reshape(n, 1),
        np.asarray(scaling_raw, np.float32),
        q,
    ]
    data = np.concatenate(cols, axis=1).astype("<f4")
    assert data.shape[1] == len(names)

    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {nm}" for nm in names]
    header += ["end_header"]

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(data.tobytes())


def _parse_header(f) -> tuple[int, list[tuple[str, str]], str]:
    line = f.readline().decode("ascii").strip()
    if line != "ply":
        raise ValueError("not a PLY file")
    fmt = None
    n_vertex = 0
    props: list[tuple[str, str]] = []
    in_vertex = False
    while True:
        line = f.readline().decode("ascii").strip()
        if line.startswith("format"):
            fmt = line.split()[1]
        elif line.startswith("element"):
            tok = line.split()
            in_vertex = tok[1] == "vertex"
            if in_vertex:
                n_vertex = int(tok[2])
        elif line.startswith("property") and in_vertex:
            tok = line.split()
            if tok[1] == "list":
                raise ValueError("list properties unsupported in vertex element")
            props.append((tok[2], tok[1]))
        elif line == "end_header":
            break
    return n_vertex, props, fmt


_PLY_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "ushort": "<u2", "int": "<i4", "int32": "<i4", "uint": "<u4",
}


def read_ply_vertex_table(path: str | Path) -> dict[str, np.ndarray]:
    """Read the vertex element of a binary/ascii PLY into {name: [N] float32}."""
    with open(path, "rb") as f:
        n, props, fmt = _parse_header(f)
        if fmt == "ascii":
            rows = np.loadtxt(io.StringIO(f.read().decode("ascii")), ndmin=2)[:n]
            return {nm: rows[:, i].astype(np.float32) for i, (nm, _) in enumerate(props)}
        if fmt != "binary_little_endian":
            raise ValueError(f"unsupported PLY format {fmt}")
        dtype = np.dtype([(nm, _PLY_DTYPES[tp]) for nm, tp in props])
        arr = np.frombuffer(f.read(dtype.itemsize * n), dtype=dtype, count=n)
        return {nm: arr[nm].astype(np.float32) for nm, _ in props}


def is_gaussian_ply(path: str | Path) -> bool:
    try:
        with open(path, "rb") as f:
            _, props, _ = _parse_header(f)
        names = {nm for nm, _ in props}
        return {"f_dc_0", "opacity", "scale_0", "rot_0"} <= names
    except Exception:
        return False


def load_splat_ply(path: str | Path) -> dict[str, np.ndarray]:
    """Gaussian PLY -> raw parameter dict (inverse of save_splat_ply; formats/ply.cpp)."""
    t = read_ply_vertex_table(path)
    n = t["x"].shape[0]
    means = np.stack([t["x"], t["y"], t["z"]], axis=1)
    sh0 = np.stack([t["f_dc_0"], t["f_dc_1"], t["f_dc_2"]], axis=1)[:, None, :]
    n_rest = 0
    while f"f_rest_{n_rest}" in t:
        n_rest += 1
    k_rest = n_rest // 3
    if k_rest:
        rest = np.stack([t[f"f_rest_{i}"] for i in range(n_rest)], axis=1)
        shN = rest.reshape(n, 3, k_rest).transpose(0, 2, 1)  # undo channel-major
    else:
        shN = np.zeros((n, 0, 3), np.float32)
    scaling = np.stack([t["scale_0"], t["scale_1"], t["scale_2"]], axis=1)
    rot = np.stack([t[f"rot_{i}"] for i in range(4)], axis=1)
    opacity = t["opacity"][:, None]
    return dict(means=means, sh0=sh0, shN=np.ascontiguousarray(shN),
                scaling_raw=scaling, rotation_raw=rot, opacity_raw=opacity)


def load_pointcloud_ply(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """Plain point-cloud PLY -> (points [N,3], colors[0,1] [N,3])."""
    t = read_ply_vertex_table(path)
    pts = np.stack([t["x"], t["y"], t["z"]], axis=1)
    if "red" in t:
        cols = np.stack([t["red"], t["green"], t["blue"]], axis=1)
        if cols.max() > 1.5:
            cols = cols / 255.0
    else:
        cols = np.full_like(pts, 0.5)
    return pts, cols
