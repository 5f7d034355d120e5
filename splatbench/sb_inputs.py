"""The benchmark's inputs, made from `--seed`: the scene, the cameras, and the files a
user's run starts from (PNG views, a COLMAP model, a training checkpoint).

Frozen copies, so that a later change to the repository's scripts cannot move the
yardstick:
  * `make_scene`: the distributions of `chip_smoke.py::build_workload` (itself
    `bench.py::build_workload`'s), drawn on the device with a `torch.Generator`;
  * `capture_views`: `chip_smoke.py::write_capture`'s pose perturbations;
  * `write_colmap`, `qvec_of`: `chip_smoke.py::write_colmap_model` and
    `rotation_to_qvec` (COLMAP's documented binary layout);
  * `encode_png`: a minimal PNG writer (one IDAT, filter 0 on every row);
  * `write_checkpoint`: the documented .npz layout of `training/checkpoint.py` (the JAX
    package's keys) and its JSON sidecar, written with numpy and zipfile.
"""

from __future__ import annotations

import json
import math
import struct
import zipfile
import zlib
from pathlib import Path

import numpy as np
import torch

from sb_reference import PARAMS


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on `device` for one named stream of the run's seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def make_scene(n: int, capacity: int, width: int, height: int, seed: int, device):
    """The seeded scene in `capacity` slots, the first `n` alive: positions fill the
    frustum of a camera at the origin with focal 0.85 width (z in [2, 12]), footprints of
    1-4 px sigma, SH degree 3. -> (params dict of [capacity, ...] float32, alive [capacity])"""
    g = generator(seed, device, 1)
    u = torch.rand((n, 5), generator=g, device=device)
    nrm = torch.randn((n, 53), generator=g, device=device)
    f = 0.85 * width
    z = 2.0 + 10.0 * u[:, 0]
    x = (u[:, 1] * 1.1 - 0.55) * z * (width / f)
    y = (u[:, 2] * 1.1 - 0.55) * z * (height / f)
    sigma = (1.0 + 3.0 * u[:, 3]) * z / f
    scaling = torch.log(torch.stack([sigma, sigma * (0.5 + 0.5 * u[:, 4]), sigma], 1))
    q = nrm[:, 0:4].clone()
    q[:, 0] += 2.0
    live = dict(means=torch.stack([x, y, z], 1), sh0=(0.5 * nrm[:, 5:8]).reshape(n, 1, 3),
                shN=(0.05 * nrm[:, 8:53]).reshape(n, 15, 3), scaling_raw=scaling,
                rotation_raw=q, opacity_raw=nrm[:, 4:5] - 1.0)
    params = {}
    for k in PARAMS:
        v = live[k]
        params[k] = torch.cat([v, torch.zeros((capacity - n,) + v.shape[1:], device=device)])
    alive = torch.arange(capacity, device=device) < n
    return params, alive


def perturbed(params: dict, alive, seed: int, device) -> dict:
    """A copy of the scene moved by a fraction of each footprint, its colours and
    opacities shifted: the scene the capture's photographs show."""
    g = generator(seed, device, 2)
    n = params["means"].shape[0]
    d = torch.randn((n, 7), generator=g, device=device) * alive[:, None].float()
    sigma = torch.exp(params["scaling_raw"]).mean(1, keepdim=True)
    return dict(params, means=params["means"] + 0.5 * sigma * d[:, 0:3],
                sh0=params["sh0"] + 0.1 * d[:, 3:6].reshape(n, 1, 3),
                opacity_raw=params["opacity_raw"] + 0.3 * d[:, 6:7])


def _rot(ax: float, ay: float, az: float) -> np.ndarray:
    c, s = np.cos([ax, ay, az]), np.sin([ax, ay, az])
    rx = np.array([[1, 0, 0], [0, c[0], -s[0]], [0, s[0], c[0]]])
    ry = np.array([[c[1], 0, s[1]], [0, 1, 0], [-s[1], 0, c[1]]])
    rz = np.array([[c[2], -s[2], 0], [s[2], c[2], 0], [0, 0, 1]])
    return rz @ ry @ rx


def capture_views(seed: int, n: int, rot: float, trans: float) -> list[np.ndarray]:
    """`n` world-to-camera poses around the identity camera (rotations within +-rot rad,
    translations within +-trans). -> [4, 4] float32 each"""
    rng = np.random.default_rng([int(seed), 3])
    out = []
    for _ in range(n):
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = _rot(*rng.uniform(-rot, rot, 3))
        w2c[:3, 3] = rng.uniform(-trans, trans, 3)
        out.append(w2c)
    return out


def orbit_poses(seed: int, views: list[np.ndarray], n: int, rot: float,
                trans: float) -> list[np.ndarray]:
    """`n` poses, each a capture view moved by a rotation within +-rot rad and a
    translation within +-trans. -> [4, 4] float32 each"""
    rng = np.random.default_rng([int(seed), 4])
    out = []
    for i in range(n):
        base = views[i % len(views)]
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = (_rot(*rng.uniform(-rot, rot, 3)) @ base[:3, :3]).astype(np.float32)
        w2c[:3, 3] = base[:3, 3] + rng.uniform(-trans, trans, 3)
        out.append(w2c)
    return out


def qvec_of(r: np.ndarray) -> np.ndarray:
    """COLMAP's (w, x, y, z) unit quaternion of a rotation matrix (Shepperd's method)."""
    r = np.asarray(r, np.float64)
    tr = np.trace(r)
    i = int(np.argmax([tr, r[0, 0], r[1, 1], r[2, 2]]))
    if i == 0:
        s = 2.0 * math.sqrt(1.0 + tr)
        q = [0.25 * s, (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s, (r[1, 0] - r[0, 1]) / s]
    else:
        j, k = (i % 3) + 1, ((i + 1) % 3) + 1
        a, b, c = i - 1, j - 1, k - 1
        s = 2.0 * math.sqrt(1.0 + r[a, a] - r[b, b] - r[c, c])
        q = [0.0] * 4
        q[0] = (r[c, b] - r[b, c]) / s
        q[i] = 0.25 * s
        q[j] = (r[b, a] + r[a, b]) / s
        q[k] = (r[c, a] + r[a, c]) / s
    q = np.asarray(q)
    return q / np.linalg.norm(q) * (1.0 if q[0] >= 0 else -1.0)


def rotmat_of(q: np.ndarray) -> np.ndarray:
    """The rotation of a COLMAP quaternion, as a reader of the file computes it (float64,
    then float32)."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)


def as_written(w2c: np.ndarray) -> np.ndarray:
    """The pose a COLMAP reader gets back for `w2c`: the rotation through its quaternion,
    the translation through float64."""
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = rotmat_of(qvec_of(w2c[:3, :3]))
    out[:3, 3] = w2c[:3, 3].astype(np.float64).astype(np.float32)
    return out


def write_colmap(sparse: Path, views: list[np.ndarray], names: list[str], focal: float,
                 width: int, height: int, points: np.ndarray, colors_u8: np.ndarray,
                 model: str = "PINHOLE", distortion=(0.0, 0.0, 0.0, 0.0)) -> None:
    """Binary cameras.bin / images.bin / points3D.bin, one camera per view; `model`
    PINHOLE (fx fy cx cy) or OPENCV (+ k1 k2 p1 p2)."""
    sparse.mkdir(parents=True, exist_ok=True)
    intr = (focal, focal, width / 2.0, height / 2.0)
    with open(sparse / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", len(views)))
        for i in range(len(views)):
            if model == "OPENCV":
                f.write(struct.pack("<iiQQ", i + 1, 4, width, height))
                f.write(struct.pack("<8d", *intr, *distortion))
            else:
                f.write(struct.pack("<iiQQ", i + 1, 1, width, height))
                f.write(struct.pack("<4d", *intr))
    with open(sparse / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", len(views)))
        for i, (v, name) in enumerate(zip(views, names)):
            f.write(struct.pack("<i4d3di", i + 1, *qvec_of(v[:3, :3]),
                                *v[:3, 3].astype(np.float64), i + 1))
            f.write(name.encode() + b"\x00" + struct.pack("<Q", 0))  # no 2D points
    n = points.shape[0]
    rec = np.zeros(n, np.dtype([("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3),
                                ("err", "<f8"), ("track", "<u8")]))
    rec["id"], rec["xyz"], rec["rgb"], rec["err"] = np.arange(1, n + 1), points, colors_u8, 0.5
    with open(sparse / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", n) + rec.tobytes())  # packed records, empty tracks


def encode_png(rgb: np.ndarray, level: int) -> bytes:
    """uint8 [H, W, 3] -> PNG bytes: 8-bit truecolor, every row filter 0 (none), one
    IDAT compressed at zlib `level`."""
    h, w, _ = rgb.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        crc = zlib.crc32(tag + data) & 0xFFFFFFFF
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)

    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + chunk(b"IEND", b""))


def to_u8(img: torch.Tensor) -> np.ndarray:
    """[3, H, W] float in [0, 1] -> uint8 [H, W, 3], rounded to nearest."""
    return torch.round(torch.clamp(img, 0, 1) * 255.0).to(torch.uint8).permute(1, 2, 0) \
        .cpu().numpy()


def from_u8(u8: np.ndarray, device) -> torch.Tensor:
    """uint8 [H, W, 3] -> [3, H, W] float32, u8 * float32(1/255), as an image reader
    scales it."""
    t = torch.as_tensor(u8, device=device).permute(2, 0, 1).float()
    return t * float(np.float32(1.0) / np.float32(255.0))


def _npy(arr: np.ndarray) -> bytes:
    import io

    buf = io.BytesIO()
    np.lib.format.write_array(buf, np.asarray(arr), allow_pickle=False)
    return buf.getvalue()


def write_checkpoint(path: Path, params: dict, alive: np.ndarray, step_count: int,
                     iteration: int, rng_state: np.ndarray, rng_device: str,
                     rng_seed: int, scene_scale: float, max_sh_degree: int,
                     extra: dict) -> None:
    """A training checkpoint of `params` (numpy [C, ...]) with zero Adam moments, each
    group's step count `step_count`, the state's next iteration `iteration`, the random
    stream's state, and the sidecar. Arrays that are all zero are deflated (level 1),
    the others stored."""
    arrays = {f"splat/{k}": params[k] for k in PARAMS}
    arrays["splat/alive"] = alive
    zeros = {}
    for k in PARAMS:
        zeros[f"adam/exp_avg/{k}"] = np.zeros_like(params[k])
        zeros[f"adam/exp_avg_sq/{k}"] = np.zeros_like(params[k])
        arrays[f"adam/step_count/{k}"] = np.int32(step_count)
    cap = alive.shape[0]
    zeros["dens_count"] = np.zeros(cap, np.float32)
    zeros["dens_grad2d"] = np.zeros(cap, np.float32)
    arrays["iteration"] = np.int32(iteration)
    arrays["__torch_rng_state__"] = rng_state
    arrays["__rng_key_data__"] = np.array([0, rng_seed & 0xFFFFFFFF], np.uint32)
    with zipfile.ZipFile(path, "w", allowZip64=True) as z:
        for k, v in arrays.items():
            z.writestr(k + ".npy", _npy(v), compress_type=zipfile.ZIP_STORED)
        for k, v in zeros.items():
            z.writestr(k + ".npy", _npy(v), compress_type=zipfile.ZIP_DEFLATED,
                       compresslevel=1)
    meta = dict(max_sh_degree=max_sh_degree, scene_scale=scene_scale, capacity=cap,
                has_bilateral=False, has_pose=False, pose_n_layers=0, has_admm=False,
                extra=extra, torch_rng_device=rng_device)
    Path(str(path) + ".json").write_text(json.dumps(meta, indent=2))
