"""The raytraced COLMAP capture: a checkerboard ground plane, three Lambertian spheres and a
gradient sky, rendered by a numpy raytracer that shares no code or model with the
splatting rasterizer, plus an SfM-like cloud of noisy surface points.

A copy of the numpy parts of the repository's `tests/synth_data.py` (`look_at_w2c`,
`rotmat_to_qvec`, `write_colmap_binary`, `_raytrace`, `make_raytraced_colmap`). The random
draws come in the same order and the PNGs quantise as `tpu_splat/io/image.py::save_image`
does, through the port's encoder (no PIL): the `sparse/0/*.bin` files are byte-equal and
the decoded images pixel-equal to the JAX package's.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from ..io.image import save_image

# (centre, radius, albedo) of the three spheres
SPHERES = (
    (np.array([0.0, -0.1, 5.0]), 0.55, np.array([0.85, 0.25, 0.2])),
    (np.array([0.9, 0.1, 5.6]), 0.35, np.array([0.2, 0.45, 0.85])),
    (np.array([-0.8, 0.25, 4.4]), 0.22, np.array([0.9, 0.8, 0.25])),
)
PLANE_Y = 0.5  # world y points DOWN in camera terms; the ground lies below the spheres


def look_at_w2c(eye, target, up=(0, 1, 0)):
    """World-to-camera (R, t) of a camera at `eye` looking at `target`; rows of R are the
    camera axes (x right, y down, z forward)."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    fwd = target - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    r = np.stack([right, down, fwd])
    t = -r @ eye
    return r.astype(np.float32), t.astype(np.float32)


def rotmat_to_qvec(r):
    """Rotation matrix -> COLMAP's (w, x, y, z) quaternion."""
    from scipy.spatial.transform import Rotation

    x, y, z, w = Rotation.from_matrix(np.asarray(r, np.float64)).as_quat()
    return np.array([w, x, y, z])


def write_colmap_binary(base: Path, cams: list[dict], points: np.ndarray, colors: np.ndarray,
                        camera_model: str = "PINHOLE", distortion=()):
    """cameras.bin, images.bin and points3D.bin under base/sparse/0 (COLMAP's binary
    layout; PINHOLE, or OPENCV with k1 k2 p1 p2 from `distortion`)."""
    sparse = Path(base) / "sparse" / "0"
    sparse.mkdir(parents=True, exist_ok=True)

    with open(sparse / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for i, c in enumerate(cams):
            if camera_model == "OPENCV":  # fx fy cx cy k1 k2 p1 p2
                f.write(struct.pack("<iiQQ", i + 1, 4, c["width"], c["height"]))
                k1, k2, p1, p2 = (tuple(distortion) + (0.0,) * 4)[:4]
                f.write(struct.pack("<8d", c["fx"], c["fy"], c["cx"], c["cy"], k1, k2, p1, p2))
            else:  # PINHOLE
                f.write(struct.pack("<iiQQ", i + 1, 1, c["width"], c["height"]))
                f.write(struct.pack("<4d", c["fx"], c["fy"], c["cx"], c["cy"]))

    with open(sparse / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for i, c in enumerate(cams):
            q = rotmat_to_qvec(c["R"])
            f.write(struct.pack("<i", i + 1))
            f.write(struct.pack("<4d", *q))
            f.write(struct.pack("<3d", *c["T"].astype(np.float64)))
            f.write(struct.pack("<i", i + 1))
            f.write(c["name"].encode() + b"\x00")
            f.write(struct.pack("<Q", 0))  # no 2D points

    with open(sparse / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", points.shape[0]))
        for i in range(points.shape[0]):
            f.write(struct.pack("<Q", i + 1))
            f.write(struct.pack("<3d", *points[i].astype(np.float64)))
            f.write(struct.pack("<3B", *np.clip(colors[i] * 255, 0, 255).astype(np.uint8)))
            f.write(struct.pack("<d", 0.5))
            f.write(struct.pack("<Q", 0))  # empty track


def _raytrace(eye, r, fx, fy, cx, cy, width, height):
    """Raytraced [H, W, 3] float32 image in [0, 1] of the ground, the spheres and the sky
    from a COLMAP pinhole camera (x right, y down, z forward; px = fx X/Z + cx)."""
    ys, xs = np.meshgrid(np.arange(height) + 0.5, np.arange(width) + 0.5, indexing="ij")
    d_cam = np.stack([(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs)], -1)
    d = d_cam @ r  # world directions (rows of r are the camera axes)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(eye, d.shape)

    light = np.array([0.45, 0.8, -0.35])  # propagates downward (+y)
    light = light / np.linalg.norm(light)

    t_hit = np.full(d.shape[:2], np.inf)
    albedo = np.zeros(d.shape)
    normal = np.zeros(d.shape)

    # ground plane y = PLANE_Y
    denom = d[..., 1]
    t_pl = np.where(np.abs(denom) > 1e-6, (PLANE_Y - o[..., 1]) / denom, np.inf)
    t_pl = np.where(t_pl > 1e-3, t_pl, np.inf)
    hit_p = o + t_pl[..., None] * d
    with np.errstate(invalid="ignore"):  # rays that miss the plane: inf - inf, then NaN
        check = ((np.floor(hit_p[..., 0] * 1.6) + np.floor(hit_p[..., 2] * 1.6)) % 2)
    pl_alb = np.where(check[..., None] > 0.5, 0.82, 0.28) * np.ones(3)
    m = t_pl < t_hit
    t_hit = np.where(m, t_pl, t_hit)
    albedo = np.where(m[..., None], pl_alb, albedo)
    normal = np.where(m[..., None], np.array([0.0, -1.0, 0.0]), normal)

    for c, rad, alb in SPHERES:
        oc = o - c
        b = np.sum(oc * d, -1)
        disc = b * b - (np.sum(oc * oc, -1) - rad * rad)
        t_s = np.where(disc > 0, -b - np.sqrt(np.maximum(disc, 0)), np.inf)
        t_s = np.where(t_s > 1e-3, t_s, np.inf)
        m = t_s < t_hit
        p = o + t_s[..., None] * d
        n = (p - c) / rad
        t_hit = np.where(m, t_s, t_hit)
        albedo = np.where(m[..., None], alb, albedo)
        normal = np.where(m[..., None], n, normal)

    lam = np.clip(np.sum(normal * (-light), -1), 0, 1)
    shaded = albedo * (0.35 + 0.65 * lam[..., None])
    sky_t = np.clip(0.5 - 0.5 * d[..., 1], 0, 1)[..., None]  # vertical gradient
    sky = (1 - sky_t) * np.array([0.9, 0.92, 0.98]) + sky_t * np.array([0.45, 0.6, 0.85])
    img = np.where(np.isfinite(t_hit)[..., None], shaded, sky)
    return np.clip(img, 0, 1).astype(np.float32)


def make_raytraced_colmap(base: Path, n_cams=8, size=64, seed=0, exposure_jitter=0.0,
                          sfm_noise=0.01, n_sfm=400, height=None):
    """Writes the capture under `base` (images/img_NNN.png, sparse/0/*.bin): `n_cams`
    cameras on a ring looking at the spheres, `size` the image width (`height` defaults
    to square), ~`n_sfm` surface points with noise `sfm_noise`. -> the camera dicts."""
    base = Path(base)
    w, h = size, height or size
    rng = np.random.default_rng(seed)
    center = np.array([0.0, 0.05, 5.0])
    (base / "images").mkdir(parents=True, exist_ok=True)
    f = 0.85 * w
    cams = []
    for i in range(n_cams):
        ang = 2 * np.pi * i / n_cams
        eye = center + np.array([2.3 * np.sin(ang), -0.9, 2.3 * np.cos(ang)])
        r, t = look_at_w2c(eye, center, up=(0, -1, 0))  # world -y is "up"
        img = _raytrace(eye, r, f, f, w / 2.0, h / 2.0, w, h)
        if exposure_jitter:
            img = np.clip(img * (1.0 + rng.uniform(-exposure_jitter, exposure_jitter)), 0, 1)
        name = f"img_{i:03d}.png"
        save_image(str(base / "images" / name), img.transpose(2, 0, 1))
        cams.append(dict(R=r, T=t, fx=f, fy=f, cx=w / 2.0, cy=h / 2.0,
                         width=w, height=h, name=name))

    # SfM-like sparse cloud: noisy surface samples with approximate colours
    pts, cols = [], []
    for c, rad, alb in SPHERES:
        nrm = rng.normal(size=(n_sfm // 4, 3))
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        pts.append(c + rad * nrm)
        cols.append(np.tile(alb, (nrm.shape[0], 1)))
    gx = rng.uniform(-2.2, 2.2, (n_sfm // 4, 1))
    gz = rng.uniform(3.0, 7.0, (n_sfm // 4, 1))
    gpts = np.concatenate([gx, np.full_like(gx, PLANE_Y), gz], 1)
    check = ((np.floor(gpts[:, 0] * 1.6) + np.floor(gpts[:, 2] * 1.6)) % 2)
    gcol = np.where(check[:, None] > 0.5, 0.82, 0.28) * np.ones(3)
    pts.append(gpts)
    cols.append(gcol)
    pts = np.concatenate(pts) + rng.normal(0, sfm_noise, np.concatenate(pts).shape)
    cols = np.clip(np.concatenate(cols) + rng.normal(0, 0.05, (pts.shape[0], 3)), 0, 1)
    write_colmap_binary(base, cams, pts.astype(np.float32), cols.astype(np.float32))
    return cams

