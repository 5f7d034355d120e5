"""EWA projection + per-Gaussian preprocess for the pinhole fast path (port of
`tpu_splat/ops/projection.py`).

Semantics of `preprocess_cu` (fastgs/rasterization/include/kernels_forward.cuh:18-205):
sigmoid opacity, quat -> rotmat -> 3D covariance in flat-column form, camera-space depth
cull, EWA projection with clamped Jacobian and 0.3 dilation, conic + opacity-aware screen
extent, tile-rect bounds. Everything is a masked dense tensor of capacity N.

Constants from fastgs/rasterization/include/rasterization_config.h:11-30. Every float
constant below is the float32 value the JAX package computes with (its Python floats
enter float32 arithmetic as weak types), so comparisons against them are exact in
either precision.

`project` is one kernel launch forward and one backward on a CUDA device
(`ProjectKernel`, through `cuda/projection.py`, with no host-to-device copy: the camera's
scalars are launch arguments). `project_plain`, the chain of column ops below with
autograd's backward, is their plain version: it runs on the CPU, under `impl="plain"`,
and where w2c or the camera position takes a gradient (pose optimisation: the kernel
computes no camera gradient).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .cuda.projection import camera_args, project_backward_kernel, project_kernel
from .quat import quat_to_rotmat_cols
from .sh import sh_to_color

DILATION = 0.3
MIN_ALPHA_RCP = 255.0
MIN_ALPHA = float(np.float32(1.0 / MIN_ALPHA_RCP))
MAX_FRAGMENT_ALPHA = float(np.float32(0.999))
TRANSMITTANCE_THRESHOLD = float(np.float32(1e-4))
NEAR_PLANE = 0.01  # fast_rasterizer.cpp:32
FAR_PLANE = 1e10


class Projected(NamedTuple):
    """Per-Gaussian screen-space quantities (dead/culled entries masked by `visible`)."""

    mean2d: torch.Tensor  # [N, 2] pixel coords
    conic: torch.Tensor  # [N, 3] upper-tri inverse 2D covariance (a, b, c)
    opacity: torch.Tensor  # [N] sigmoid opacity
    color: torch.Tensor  # [N, 3] SH color (unclamped)
    depth: torch.Tensor  # [N] camera-space z
    tile_min: torch.Tensor  # [N, 2] int32 (x, y) inclusive tile bounds
    tile_max: torch.Tensor  # [N, 2] int32 (x, y) exclusive tile bounds
    n_tiles: torch.Tensor  # [N] int32 conservative rect tile count (0 if culled)
    power_threshold: torch.Tensor  # [N] log(opacity * 255)
    visible: torch.Tensor  # [N] bool


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar tensor: `scalar / tensor` in PyTorch multiplies by a reciprocal,
    so divisions by a tensor go through this to stay true divisions."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


IMPLS = ("kernel", "plain")


class ProjectKernel(torch.autograd.Function):
    """`project` on the card: `project_kernel` forward, `project_backward_kernel`
    backward, the camera (`cuda/build.py::ProjCamera`) fixed. Differentiable in means,
    scaling_raw, rotation_raw, opacity_raw, sh0 and shN through mean2d, conic, opacity,
    color, depth and power_threshold; the tile rects, counts and `visible` carry none."""

    @staticmethod
    def forward(ctx, means, scaling_raw, rotation_raw, opacity_raw, sh0, shN, alive, w2c,
                cam_position, cam):
        out = project_kernel(means, scaling_raw, rotation_raw, opacity_raw, sh0, shN, alive,
                             w2c, cam_position, cam)
        ctx.save_for_backward(means, scaling_raw, rotation_raw, opacity_raw, sh0, shN, alive,
                              w2c, cam_position)
        ctx.cam = cam
        ctx.mark_non_differentiable(*out[5:8], out[9])
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, g_mean2d, g_conic, g_opacity, g_color, g_depth, _tile_min, _tile_max,
                 _n_tiles, g_power_threshold, _visible):
        grads = project_backward_kernel(*ctx.saved_tensors, ctx.cam, g_mean2d, g_conic,
                                        g_opacity, g_color, g_depth, g_power_threshold)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)),
                None, None, None, None)


def takes_kernels(means, w2c, cam_position, impl: str) -> bool:
    """Whether `project` runs its kernels: under `impl="kernel"` on a CUDA device, unless w2c
    or cam_position takes a gradient (the kernels compute none for the camera)."""
    return (impl == "kernel" and means.is_cuda
            and not (w2c.requires_grad or cam_position.requires_grad))


def project(
    means, scaling_raw, rotation_raw, opacity_raw, sh0, shN, alive, w2c, cam_position,
    fx: float, fy: float, cx: float, cy: float,
    width: int,
    height: int,
    active_sh_degree: int,
    tile_size: int = 16,
    impl: str = "kernel",  # "plain": the chain on any device
) -> Projected:
    """Per-Gaussian screen-space quantities of every slot (`project_plain`'s arguments).
    One kernel launch forward and one backward on a CUDA device; the chain on the CPU,
    under `impl="plain"` and where w2c or cam_position requires grad."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if takes_kernels(means, w2c, cam_position, impl):
        cam = camera_args(fx, fy, cx, cy, width, height, tile_size, active_sh_degree,
                          shN.shape[1])
        return Projected(*ProjectKernel.apply(means, scaling_raw, rotation_raw, opacity_raw,
                                              sh0, shN, alive, w2c, cam_position, cam))
    return project_plain(means, scaling_raw, rotation_raw, opacity_raw, sh0, shN, alive, w2c,
                         cam_position, fx, fy, cx, cy, width, height, active_sh_degree,
                         tile_size)


def project_plain(
    means: torch.Tensor,  # [N, 3]
    scaling_raw: torch.Tensor,  # [N, 3] log sigma
    rotation_raw: torch.Tensor,  # [N, 4] wxyz unnormalized
    opacity_raw: torch.Tensor,  # [N, 1] logit
    sh0: torch.Tensor,  # [N, 1, 3]
    shN: torch.Tensor,  # [N, K-1, 3]
    alive: torch.Tensor,  # [N] bool
    w2c: torch.Tensor,  # [4, 4]
    cam_position: torch.Tensor,  # [3]
    fx: float, fy: float, cx: float, cy: float,
    width: int,
    height: int,
    active_sh_degree: int,
    tile_size: int = 16,
) -> Projected:
    """Plain version of the projection: a chain of flat [N] column ops."""
    r1, r2, r3 = w2c[0], w2c[1], w2c[2]

    depth = means @ r3[:3] + r3[3]
    visible = alive & (depth >= NEAR_PLANE) & (depth <= FAR_PLANE)
    safe_depth = torch.where(visible, depth, 1.0)

    opacity = torch.sigmoid(opacity_raw[:, 0])
    visible = visible & (opacity >= MIN_ALPHA)

    # 3D covariance chain (kernels_forward.cuh:78-106) in flat column form:
    # cov2d = JW (R S^2 R^T) JW^T as u = R^T jw1, v = R^T jw2, cov_ij = sum_k var_k u_k v_k
    q = rotation_raw
    q_norm_sq = torch.sum(q * q, dim=-1)
    visible = visible & (q_norm_sq >= 1e-8)
    rc = quat_to_rotmat_cols(q)  # nine flat [N] columns, row-major
    var = torch.exp(2.0 * scaling_raw)  # [N,3]

    # normalized camera-plane coords
    x = (means @ r1[:3] + r1[3]) / safe_depth
    y = (means @ r2[:3] + r2[3]) / safe_depth

    # clamped Jacobian (kernels_forward.cuh:113-122)
    tx = torch.clamp(x, (-0.15 * width - cx) / fx, (1.15 * width - cx) / fx)
    ty = torch.clamp(y, (-0.15 * height - cy) / fy, (1.15 * height - cy) / fy)
    j11 = _f32(fx, means) / safe_depth
    j13 = -j11 * tx
    j22 = _f32(fy, means) / safe_depth
    j23 = -j22 * ty

    # JW rows (J @ W[:3,:3]) as flat columns; w2c row entries are per-camera scalars
    jw1 = tuple(j11 * r1[i] + j13 * r3[i] for i in range(3))  # 3 x [N]
    jw2 = tuple(j22 * r2[i] + j23 * r3[i] for i in range(3))

    u = tuple(jw1[0] * rc[0][k] + jw1[1] * rc[1][k] + jw1[2] * rc[2][k] for k in range(3))
    v = tuple(jw2[0] * rc[0][k] + jw2[1] * rc[1][k] + jw2[2] * rc[2][k] for k in range(3))
    v0, v1, v2 = var[:, 0], var[:, 1], var[:, 2]
    cov_a = v0 * u[0] * u[0] + v1 * u[1] * u[1] + v2 * u[2] * u[2] + DILATION
    cov_b = v0 * u[0] * v[0] + v1 * u[1] * v[1] + v2 * u[2] * v[2]
    cov_c = v0 * v[0] * v[0] + v1 * v[1] * v[1] + v2 * v[2] * v[2] + DILATION

    det = cov_a * cov_c - cov_b * cov_b
    visible = visible & (det >= 1e-8)
    safe_det = torch.where(det > 1e-12, det, 1.0)
    conic = torch.stack([cov_c / safe_det, -cov_b / safe_det, cov_a / safe_det], dim=-1)

    mean2d = torch.stack([x * fx + cx, y * fy + cy], dim=-1)

    # opacity-aware screen extent (kernels_forward.cuh:158-170)
    power_threshold = torch.log(torch.clamp_min(opacity, MIN_ALPHA) * MIN_ALPHA_RCP)
    ptf = torch.sqrt(torch.clamp_min(2.0 * power_threshold, 0.0))
    ext_x = torch.clamp_min(ptf * torch.sqrt(torch.clamp_min(cov_a, 0.0)) - 0.5, 0.0)
    ext_y = torch.clamp_min(ptf * torch.sqrt(torch.clamp_min(cov_c, 0.0)) - 0.5, 0.0)

    gw = (width + tile_size - 1) // tile_size
    gh = (height + tile_size - 1) // tile_size
    ts = _f32(float(tile_size), means)

    def tile_bound(v: torch.Tensor, rnd, hi: int) -> torch.Tensor:
        # clamp before the int cast too: XLA's cast saturates, PyTorch's CPU cast of an
        # out-of-range or NaN float does not
        return torch.clamp(torch.clamp(rnd(v / ts), 0, hi).to(torch.int32), 0, hi)

    x_min = tile_bound(mean2d[:, 0] - ext_x, torch.floor, gw)
    x_max = tile_bound(mean2d[:, 0] + ext_x, torch.ceil, gw)
    y_min = tile_bound(mean2d[:, 1] - ext_y, torch.floor, gh)
    y_max = tile_bound(mean2d[:, 1] + ext_y, torch.ceil, gh)

    n_tiles = (x_max - x_min) * (y_max - y_min)
    visible = visible & (n_tiles > 0)
    n_tiles = torch.where(visible, n_tiles, 0).to(torch.int32)

    dirs = means - cam_position[None, :]
    color = sh_to_color(sh0, shN, dirs, active_sh_degree)

    return Projected(
        mean2d=mean2d,
        conic=conic,
        opacity=opacity,
        color=color,
        depth=depth,
        tile_min=torch.stack([x_min, y_min], dim=-1),
        tile_max=torch.stack([x_max, y_max], dim=-1),
        n_tiles=n_tiles,
        power_threshold=power_threshold,
        visible=visible,
    )


def will_contribute(
    mean2d: torch.Tensor,  # [..., 2] (UNSHIFTED screen coords)
    conic: torch.Tensor,  # [..., 3]
    tile_x: torch.Tensor,  # [...] int
    tile_y: torch.Tensor,
    power_threshold: torch.Tensor,  # [...]
    tile_size: int = 16,
) -> torch.Tensor:
    """Exact per-tile contribution test (kernel_utils.cuh:108-143, StopThePop).

    The mean is shifted by -0.5 before testing (pixel-center convention,
    kernel_utils.cuh:153). Returns bool [...]."""
    mx = mean2d[..., 0] - 0.5
    my = mean2d[..., 1] - 0.5
    a, b, c = conic[..., 0], conic[..., 1], conic[..., 2]
    tsf = float(tile_size)

    rect_min_x = tile_x.to(mx.dtype) * tsf
    rect_min_y = tile_y.to(my.dtype) * tsf
    rect_max_x = rect_min_x + (tsf - 1.0)
    rect_max_y = rect_min_y + (tsf - 1.0)

    x_left = (rect_min_x - mx > 0).to(mx.dtype)
    not_in_x = x_left + (mx > rect_max_x).to(mx.dtype)
    y_above = (rect_min_y - my > 0).to(my.dtype)
    not_in_y = y_above + (my > rect_max_y).to(my.dtype)

    inside = (not_in_x + not_in_y) == 0.0

    ccx = rect_max_x + x_left * (rect_min_x - rect_max_x)  # lerp(max, min, x_left)
    ccy = rect_max_y + y_above * (rect_min_y - rect_max_y)
    dx = mx - ccx
    dy = my - ccy

    # copysign(tile_size-1, rect_min - mean): points from the closest corner into the tile
    d_x = torch.where(rect_min_x - mx > 0, tsf - 1.0, -(tsf - 1.0))
    d_y = torch.where(rect_min_y - my > 0, tsf - 1.0, -(tsf - 1.0))

    eps = 1e-12
    t_x = not_in_y * torch.clamp((d_x * a * dx + d_x * b * dy) / (d_x * a * d_x + eps), 0.0, 1.0)
    t_y = not_in_x * torch.clamp((d_y * b * dx + d_y * c * dy) / (d_y * c * d_y + eps), 0.0, 1.0)

    px = ccx + t_x * d_x
    py = ccy + t_y * d_y
    ddx = mx - px
    ddy = my - py
    max_power = 0.5 * (a * ddx * ddx + c * ddy * ddy) + b * ddx * ddy
    return inside | (max_power <= power_threshold)
