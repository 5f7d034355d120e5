"""Camera models for the GUT path (port of `tpu_splat/ops/cameras.py`): OpenCV pinhole
(radial6 / tangential2 / thin-prism4), OpenCV fisheye and orthographic, with point
projection and pixel -> ray generation, and rolling-shutter pose interpolation.

Reference: gsplat/Cameras.cuh — `compute_distortion` (:504-533), pinhole
`camera_ray_to_image_point` (:535-598), `compute_undistortion_iterative` (:600-629),
fisheye forward odd polynomial theta + k1 th^3 + k2 th^5 + k3 th^7 + k4 th^9 and Newton
inversion (:894-1000), shutter poses (:33-150, :253-414).

Plain functions on tensors over [..., 2/3] points. None of them is differentiated: the
GUT rasterizer calls them under `torch.no_grad()` (projection and rays carry no gradient
in the reference either). The distortion coefficients are Python floats (a static
`CameraParams`) or 0-dim tensors (`bind_coeffs` with a `dist` tensor, so that every view
of a mixed rig renders with its own coefficients); the model and the shutter type always
come from the static `CameraParams`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

N_UNDISTORT_ITERS = 20  # Cameras.cuh N_MAX_UNDISTORTION_ITERATIONS
N_NEWTON_ITERS = 10
N_SHUTTER_ITERS = 10  # Cameras.cuh N_ROLLING_SHUTTER_ITERATIONS
SHUTTER_TYPES = ("global", "top_to_bottom", "left_to_right", "bottom_to_top",
                 "right_to_left")
_MAX_ANGLE_GRID = 4096


@dataclass(frozen=True)
class CameraParams:
    """Static per-camera model description (hashable; coefficients as tuples)."""

    model: str = "pinhole"  # pinhole | fisheye | ortho
    radial: tuple = (0.0,) * 6
    tangential: tuple = (0.0, 0.0)
    thin_prism: tuple = (0.0,) * 4
    shutter: str = "global"  # one of SHUTTER_TYPES

    @classmethod
    def from_camera(cls, cam) -> "CameraParams":
        rad = tuple(float(v) for v in np.asarray(cam.radial_distortion).reshape(-1))
        tan = tuple(float(v) for v in np.asarray(cam.tangential_distortion).reshape(-1))
        name = cam.camera_model_type.name
        model = {"FISHEYE": "fisheye", "ORTHO": "ortho"}.get(name, "pinhole")
        rad = (rad + (0.0,) * 6)[:6] if model == "pinhole" else (rad + (0.0,) * 4)[:4]
        tan = (tan + (0.0, 0.0))[:2]
        return cls(model=model, radial=rad if model == "pinhole" else rad + (0.0, 0.0),
                   tangential=tan)

    def coeff_vector(self) -> np.ndarray:
        """The 12 distortion coefficients as one array (radial6 | tangential2 | tp4)."""
        return np.asarray(
            tuple(self.radial) + tuple(self.tangential) + tuple(self.thin_prism),
            np.float32,
        )


@dataclass
class BoundCameraParams:
    """CameraParams whose coefficients are tensors on the device: the model and shutter
    stay static (they select code paths), the distortion is a per-view value."""

    model: str
    shutter: str
    radial: torch.Tensor  # [6]
    tangential: torch.Tensor  # [2]
    thin_prism: torch.Tensor  # [4]
    coeffs: torch.Tensor  # [12], of which the three above are views


def bind_coeffs(params: CameraParams, dist=None):
    """Attach distortion coefficients `dist` [12] (tensor or array) to a CameraParams."""
    if dist is None:
        return params
    dist = torch.as_tensor(dist, dtype=torch.float32)
    return BoundCameraParams(
        model=params.model, shutter=params.shutter,
        radial=dist[0:6], tangential=dist[6:8], thin_prism=dist[8:12], coeffs=dist,
    )


def _pair(a, b, like: torch.Tensor) -> torch.Tensor:
    """[2] float32 tensor of two scalars (floats or 0-dim tensors) on `like`'s device."""
    return torch.stack([torch.as_tensor(v, dtype=like.dtype, device=like.device)
                        for v in (a, b)])


def _clip(x: torch.Tensor, lo: float, hi) -> torch.Tensor:
    """clamp(x, lo, hi) where `hi` is a float or a 0-dim tensor."""
    if isinstance(hi, torch.Tensor):
        return torch.minimum(torch.clamp_min(x, lo), hi)
    return torch.clamp(x, lo, hi)


# ------------------------------------------------------------------------ OpenCV pinhole


def _distortion(uv, radial, tangential, thin_prism):
    """(icD, delta, r2) of the OpenCV distortion model (Cameras.cuh:504-533).

    uv [..., 2] normalized camera-plane coordinates."""
    k1, k2, k3, k4, k5, k6 = radial
    p1, p2 = tangential
    s1, s2, s3, s4 = thin_prism
    x, y = uv[..., 0], uv[..., 1]
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    a1 = 2.0 * x * y
    a2 = r2 + 2.0 * x2
    a3 = r2 + 2.0 * y2
    icd_num = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    icd_den = 1.0 + r2 * (k4 + r2 * (k5 + r2 * k6))
    icd = icd_num / icd_den
    dx = p1 * a1 + p2 * a2 + r2 * (s1 + r2 * s2)
    dy = p1 * a3 + p2 * a1 + r2 * (s3 + r2 * s4)
    return icd, torch.stack([dx, dy], dim=-1), r2


def pinhole_project(cam_points, fx, fy, cx, cy, params, width: int, height: int,
                    margin: float = 0.15):
    """Camera-space points -> image points + validity (Cameras.cuh:535-598)."""
    z = cam_points[..., 2]
    safe_z = torch.where(z > 0, z, 1.0)
    uv = cam_points[..., :2] / safe_z[..., None]
    icd, delta, _ = _distortion(uv, params.radial, params.tangential, params.thin_prism)
    uv_nd = icd[..., None] * uv + delta
    img = uv_nd * _pair(fx, fy, uv) + _pair(cx, cy, uv)
    valid = (z > 0) & (icd > 0.8)
    valid = valid & _in_bounds_margin(img, width, height, margin)
    return img, valid


def pinhole_ray(image_points, fx, fy, cx, cy, params):
    """Image points -> unit camera-space rays via iterative undistortion
    (Cameras.cuh:600-629)."""
    uv0 = (image_points - _pair(cx, cy, image_points)) / _pair(fx, fy, image_points)
    uv = uv0
    for _ in range(N_UNDISTORT_ITERS):
        icd, delta, _ = _distortion(uv, params.radial, params.tangential, params.thin_prism)
        uv = (uv0 - delta) / torch.clamp_min(icd[..., None], 1e-6)
    d = torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


# ------------------------------------------------------------------------ OpenCV fisheye


def _fisheye_poly(theta, k):
    """theta + k1 th^3 + k2 th^5 + k3 th^7 + k4 th^9 (Cameras.cuh:136-137)."""
    t2 = theta * theta
    return theta * (1.0 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3]))))


def _fisheye_dpoly(theta, k):
    t2 = theta * theta
    return 1.0 + t2 * (3 * k[0] + t2 * (5 * k[1] + t2 * (7 * k[2] + t2 * 9 * k[3])))


def fisheye_max_angle(params):
    """Smallest positive root of the derivative polynomial, grid-searched (replaces the
    closed-form cubic of compute_opencv_fisheye_max_angle, Cameras.cuh:756-810). Caps at
    pi (omnidirectional). Static tuples -> host float; tensor coefficients
    (BoundCameraParams) -> a 0-dim tensor on their device, without a sync."""
    k = params.radial[:4]
    thetas = np.linspace(1e-4, np.pi, _MAX_ANGLE_GRID)
    if isinstance(params.radial, tuple):
        d = _fisheye_dpoly(thetas, k)
        bad = np.nonzero(d <= 0)[0]
        return float(thetas[bad[0]]) if len(bad) else float(np.pi)
    th = torch.from_numpy(thetas.astype(np.float32)).to(params.radial.device)
    d = _fisheye_dpoly(th, k)
    return torch.where(d <= 0, th, float(np.float32(np.pi))).min()


def fisheye_project(cam_points, fx, fy, cx, cy, params, width: int, height: int,
                    margin: float = 0.15, max_angle=None):
    """Camera-space points -> fisheye image points + validity (Cameras.cuh:894-960)."""
    if max_angle is None:
        max_angle = fisheye_max_angle(params)
    k = params.radial[:4]
    x, y, z = cam_points[..., 0], cam_points[..., 1], cam_points[..., 2]
    rxy = torch.clamp_min(torch.sqrt(x * x + y * y), 1e-12)
    theta_full = torch.atan2(rxy, z)
    theta = _clip(theta_full, -np.inf, max_angle)
    delta = _fisheye_poly(theta, k) / rxy
    img = torch.stack([fx * delta * x + cx, fy * delta * y + cy], dim=-1)
    valid = (z > 0) & (delta > 0) & (theta_full <= max_angle)
    valid = valid & _in_bounds_margin(img, width, height, margin)
    return img, valid


def fisheye_ray(image_points, fx, fy, cx, cy, params, max_angle=None):
    """Image points -> unit camera-space rays via Newton inversion of the odd polynomial
    (Cameras.cuh:962-1000)."""
    if max_angle is None:
        max_angle = fisheye_max_angle(params)
    k = params.radial[:4]
    uv = (image_points - _pair(cx, cy, image_points)) / _pair(fx, fy, image_points)
    delta = torch.linalg.vector_norm(uv, dim=-1)
    theta = _clip(delta, 0.0, max_angle)  # initial guess: identity poly
    for _ in range(N_NEWTON_ITERS):
        f = _fisheye_poly(theta, k) - delta
        df = torch.clamp_min(_fisheye_dpoly(theta, k), 1e-6)
        theta = _clip(theta - f / df, 0.0, max_angle)
    scale = torch.where(delta > 1e-9, torch.sin(theta) / torch.clamp_min(delta, 1e-12), 0.0)
    d = torch.stack([scale * uv[..., 0], scale * uv[..., 1], torch.cos(theta)], dim=-1)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


# -------------------------------------------------------------------------------- shared


def _in_bounds_margin(img, width: int, height: int, margin: float):
    mx, my = margin * width, margin * height
    return (
        (img[..., 0] >= -mx) & (img[..., 0] <= width + mx)
        & (img[..., 1] >= -my) & (img[..., 1] <= height + my)
    )


def ortho_project(cam_points, fx, fy, cx, cy, width: int, height: int,
                  margin: float = 0.15):
    """Orthographic camera (Cameras.cuh ortho branch): image point is
    (fx x + cx, fy y + cy), no z division."""
    x, y, z = cam_points[..., 0], cam_points[..., 1], cam_points[..., 2]
    img = torch.stack([fx * x + cx, fy * y + cy], dim=-1)
    valid = (z > 0) & _in_bounds_margin(img, width, height, margin)
    return img, valid


def ortho_ray_origins(image_points, fx, fy, cx, cy):
    """Per-pixel CAMERA-SPACE ray origins for the orthographic model (rays are all +z;
    origins vary instead — the inverse of ortho_project at z = 0)."""
    u = (image_points[..., 0] - cx) / fx
    v = (image_points[..., 1] - cy) / fy
    return torch.stack([u, v, torch.zeros_like(u)], dim=-1)


def project_points(cam_points, fx, fy, cx, cy, params, width: int, height: int,
                   margin: float = 0.15, max_angle=None):
    if params.model == "fisheye":
        return fisheye_project(cam_points, fx, fy, cx, cy, params, width, height, margin,
                               max_angle)
    if params.model == "ortho":
        return ortho_project(cam_points, fx, fy, cx, cy, width, height, margin)
    return pinhole_project(cam_points, fx, fy, cx, cy, params, width, height, margin)


def pixel_rays(image_points, fx, fy, cx, cy, params, max_angle=None):
    if params.model == "fisheye":
        return fisheye_ray(image_points, fx, fy, cx, cy, params, max_angle)
    if params.model == "ortho":
        # parallel rays along +z; per-pixel ORIGINS carry the offset (see gut.py)
        z = torch.tensor([0.0, 0.0, 1.0], dtype=image_points.dtype,
                         device=image_points.device)
        return z.expand(image_points.shape[:-1] + (3,))
    return pinhole_ray(image_points, fx, fy, cx, cy, params)


# ------------------------------------------------------------------- rolling shutter


def quat_slerp(q0, q1, t):
    """Quaternion slerp (wxyz), shortest arc; t broadcastable [..., 1]."""
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.abs(dot)
    theta = torch.acos(torch.clamp(dot, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-6
    safe_sin = torch.where(small, 1.0, sin_theta)
    w0 = torch.where(small, 1.0 - t, torch.sin((1.0 - t) * theta) / safe_sin)
    w1 = torch.where(small, t, torch.sin(t * theta) / safe_sin)
    q = w0 * q0 + w1 * q1
    return q / torch.clamp_min(torch.linalg.vector_norm(q, dim=-1, keepdim=True), 1e-12)


def quat_rotate(q, v):
    """Rotate vectors v [..., 3] by quaternions q [..., 4] (wxyz)."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    shape = torch.broadcast_shapes(u.shape, v.shape)
    u, v = u.expand(shape), v.expand(shape)
    uv = torch.linalg.cross(u, v)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv))


def shutter_relative_time(image_points, shutter: str, width: int, height: int):
    """Per-pixel relative frame time (Cameras.cuh shutter_relative_frame_time)."""
    x = image_points[..., 0]
    y = image_points[..., 1]
    if shutter == "top_to_bottom":
        return torch.floor(y) / (height - 1)
    if shutter == "left_to_right":
        return torch.floor(x) / (width - 1)
    if shutter == "bottom_to_top":
        return (height - torch.ceil(y)) / (height - 1)
    if shutter == "right_to_left":
        return (width - torch.ceil(x)) / (width - 1)
    return torch.zeros_like(x)


def interpolate_shutter_pose(q_start, t_start, q_end, t_end, t_rel):
    """Linear translation + slerp rotation (Cameras.cuh interpolate_shutter_pose).
    t_rel [...]; returns (q [..., 4], t [..., 3])."""
    tr = t_rel[..., None]
    t = (1.0 - tr) * t_start + tr * t_end
    q = quat_slerp(q_start.expand(tr.shape[:-1] + (4,)),
                   q_end.expand(tr.shape[:-1] + (4,)), tr)
    return q, t


def project_points_shutter(
    world_points, q_start, t_start, q_end, t_end,
    fx, fy, cx, cy, params, width: int, height: int, shutter: str,
    margin: float = 0.15, max_angle=None,
):
    """world_point_to_image_point_shutter_pose (Cameras.cuh:346-414).

    world_points [..., 3]. Iteratively refines the per-point readout time."""
    def proj(q, t):
        cam = quat_rotate(q, world_points) + t
        return project_points(cam, fx, fy, cx, cy, params, width, height, margin,
                              max_angle)

    img_start, valid_start = proj(q_start, t_start)
    if shutter == "global":
        return img_start, valid_start

    img_end, valid_end = proj(q_end, t_end)
    img = torch.where(valid_start[..., None], img_start, img_end)
    any_valid = valid_start | valid_end
    for _ in range(N_SHUTTER_ITERS):
        t_rel = torch.clamp(shutter_relative_time(img, shutter, width, height), 0.0, 1.0)
        q_rs, t_rs = interpolate_shutter_pose(q_start, t_start, q_end, t_end, t_rel)
        img, _ = proj(q_rs, t_rs)
    return img, any_valid


def pixel_world_rays_shutter(
    image_points, q_start, t_start, q_end, t_end,
    fx, fy, cx, cy, params, width: int, height: int, shutter: str, max_angle=None,
):
    """Per-pixel world rays under a (possibly rolling) shutter
    (image_point_to_world_ray_shutter_pose + ShutterPose.camera_ray_to_world_ray).

    Returns (ray_o [..., 3], ray_d [..., 3]) in world space."""
    cam_ray = pixel_rays(image_points, fx, fy, cx, cy, params, max_angle)
    t_rel = torch.clamp(shutter_relative_time(image_points, shutter, width, height), 0.0, 1.0)
    q, t = interpolate_shutter_pose(q_start, t_start, q_end, t_end, t_rel)
    q_inv = q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)
    ray_o = quat_rotate(q_inv, -t)
    ray_d = quat_rotate(q_inv, cam_ray)
    return ray_o, ray_d
