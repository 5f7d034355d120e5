"""GUT path: Unscented-Transform projection + world-space per-pixel ray rasterizer (port of
`tpu_splat/ops/gut.py` on its Pallas path).

Reference: the `--gut` pipeline (3DGUT, arXiv 2412.12507) —
  * UT projection `ProjectionUT3DGSFused.cu:17-289` + sigma points
    `Cameras.cuh:1035-1150`: 7 sigma points from the closed-form covariance sqrt
    (sqrt(Sigma) columns = s_i * R[:, i]), pushed through the (possibly distorted) camera
    model; image mean/cov recovered by UT weights (alpha=0.1, beta=2, kappa=0).
  * projection tail `ProjectionUT3DGSFused.cu:136-202`: eps2d=0.3 blur with
    compensation = sqrt(det_before/det_after), opacity *= compensation, alpha cull,
    opacity-aware extent min(3.33, sqrt(2 ln(opac*255))), anisotropic radii, depth = cam z.
  * world-space rasterizer `RasterizeToPixelsFromWorld3DGSFwd.cu:207-241`: per Gaussian
    M = S^-1 R^T; per pixel ray (o, d): gro = M (o - mu), grd = normalize(M d),
    power = -0.5 |grd x gro|^2 (max response along the ray),
    alpha = min(0.999, opac exp(power)).

  ut_project (no gradient) -> build_sorted_instances (K1, sort; cuda/raster.py)
    -> per-Gaussian G_* table (autograd) + per-pixel world rays (no gradient)
    -> GutBlendTiles (K5; backward K6 -> K4 or K7; cuda/gut_kernels.py) -> compose_output

Host spans: `ut_project` and `pixel_world_rays` add the host seconds spent inside them to
this thread's `host_seconds()` ("gut_project", "gut_rays"; the Trainer sums them into its
`timings`) and open profiler ranges of the same names, so a device trace names the idle
gaps inside them. `pixel_world_rays.builds` counts the ray tables built.

The UT projection and the pixel rays carry no gradient (as in the reference: the
projection is a plain kernel there); gradients reach the 3D parameters through the
world-space ray response and the SH colours. There is one pipeline on every device: on a
CUDA device the wrappers launch the kernels, on the CPU they run the plain versions;
`impl="plain"` runs the plain versions on any device.
"""

from __future__ import annotations

import functools
import math
import threading
import time

import torch

from ..device import resolve_device
from .cameras import (CameraParams, bind_coeffs, fisheye_max_angle, ortho_ray_origins,
                      pixel_rays, pixel_world_rays_shutter, project_points,
                      project_points_shutter)
from .cuda.blend import tile_pixel_centers
from .cuda.gut_kernels import GutBlendTiles
from .cuda.raster import SEGRED_IMPLS, build_sorted_instances
from .projection import MIN_ALPHA, Projected
from .quat import quat_to_rotmat, quat_to_rotmat_cols
from .rasterize import RENDER_MODES, RasterAux, RenderOutput, compose_output, to_device
from .sh import sh_to_color

UT_ALPHA = 0.1
UT_BETA = 2.0
UT_KAPPA = 0.0
EPS2D = 0.3
MAX_EXTENT = 3.33  # ProjectionUT3DGSFused.cu:160

HOST_SPANS = ("gut_project", "gut_rays")
_spans = threading.local()
_builds_lock = threading.Lock()


def host_seconds() -> dict[str, float]:
    """The calling thread's host seconds inside `ut_project` ("gut_project") and
    `pixel_world_rays` ("gut_rays") so far; a caller reads the difference across its
    own stretch."""
    if not hasattr(_spans, "seconds"):
        _spans.seconds = dict.fromkeys(HOST_SPANS, 0.0)
    return _spans.seconds


def _host_span(name: str):
    """Time each call of the decorated function into `host_seconds()[name]`, inside a
    profiler range of that name. The range has an operator's scope: a
    `torch.profiler.record_function` range is a user annotation, which the profiler also
    lays over the device timeline from the range's first kernel to its last, so a reader
    that unites the device's events would count the idle time inside it as busy."""
    def wrap(fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                with torch._C._profiler._RecordFunctionFast(name):
                    return fn(*args, **kwargs)
            finally:
                host_seconds()[name] += time.perf_counter() - t0
        return spanned
    return wrap


@_host_span("gut_project")
@torch.no_grad()
def ut_project(
    means, scaling_raw, rotation_raw, opacity_raw, alive,
    w2c, fx, fy, cx, cy, cam_params,
    width: int, height: int, tile_size: int, max_angle,
    shutter_pose=None,  # (q_start, t_start, q_end, t_end) when shutter != global
):
    """UT projection of all Gaussians -> (Projected, compensation [N])."""
    f32 = means.dtype
    dev = means.device
    d = 3
    lam = UT_ALPHA * UT_ALPHA * (d + UT_KAPPA) - d
    wm0 = lam / (d + lam)
    wc0 = wm0 + (1.0 - UT_ALPHA * UT_ALPHA + UT_BETA)
    wi = 1.0 / (2.0 * (d + lam))
    sqrt_dl = torch.sqrt(torch.tensor(d + lam, dtype=f32, device=dev))

    rot = quat_to_rotmat(rotation_raw)  # [N,3,3]
    scale = torch.exp(scaling_raw)  # [N,3]
    # sigma points [N, 7, 3]: mu, mu +- sqrt(d+lam) * s_i * R[:, i]; row i of R^T is
    # R[:, i], scaled by s_i, so the points' covariance is R diag(s^2) R^T
    deltas = sqrt_dl * scale[:, :, None] * rot.transpose(-1, -2)  # rows = s_i R[:, i]
    pts = torch.cat([means[:, None], means[:, None] + deltas, means[:, None] - deltas],
                    dim=1)  # [N,7,3]

    cam_pts = pts @ w2c[:3, :3].T + w2c[:3, 3]  # [N,7,3]
    if cam_params.shutter == "global" or shutter_pose is None:
        img_pts, pt_valid = project_points(
            cam_pts, fx, fy, cx, cy, cam_params, width, height, max_angle=max_angle
        )  # [N,7,2], [N,7]
    else:
        # iterative shutter-aware projection (Cameras.cuh:346-414)
        q_s, t_s, q_e, t_e = shutter_pose
        img_pts, pt_valid = project_points_shutter(
            pts, q_s, t_s, q_e, t_e, fx, fy, cx, cy, cam_params, width, height,
            cam_params.shutter, max_angle=max_angle,
        )

    weights_m = torch.tensor([wm0] + [wi] * 6, dtype=f32, device=dev)
    weights_c = torch.tensor([wc0] + [wi] * 6, dtype=f32, device=dev)
    mean2d = torch.einsum("s,nsk->nk", weights_m, img_pts)
    dev2 = img_pts - mean2d[:, None]
    cov2d = torch.einsum("s,nsi,nsj->nij", weights_c, dev2, dev2)  # [N,2,2]
    # require_all_sigma_points_valid = false default: any valid point suffices
    valid = alive & pt_valid.any(dim=1)

    depth = cam_pts[:, 0, 2]  # camera z of the mean
    valid = valid & (depth > 0.01)

    # ---- projection tail
    det_before = cov2d[:, 0, 0] * cov2d[:, 1, 1] - cov2d[:, 0, 1] * cov2d[:, 1, 0]
    cov_a = cov2d[:, 0, 0] + EPS2D
    cov_b = cov2d[:, 0, 1]
    cov_c = cov2d[:, 1, 1] + EPS2D
    det_after = cov_a * cov_c - cov_b * cov_b
    valid = valid & (det_after > 0)
    safe_det = torch.where(det_after > 1e-12, det_after, 1.0)
    compensation = torch.sqrt(torch.clamp_min(det_before, 0.0) / safe_det)
    conic = torch.stack([cov_c / safe_det, -cov_b / safe_det, cov_a / safe_det], dim=-1)

    opacity = torch.sigmoid(opacity_raw[:, 0]) * compensation
    valid = valid & (opacity >= MIN_ALPHA)

    extend = torch.clamp_max(
        torch.sqrt(torch.clamp_min(2.0 * torch.log(opacity * 255.0), 0.0)), MAX_EXTENT)
    rx = torch.ceil(extend * torch.sqrt(torch.clamp_min(cov_a, 0.0)))
    ry = torch.ceil(extend * torch.sqrt(torch.clamp_min(cov_c, 0.0)))
    valid = valid & (rx > 0) & (ry > 0)

    gw = -(-width // tile_size)
    gh = -(-height // tile_size)
    ts = torch.tensor(float(tile_size), dtype=f32, device=dev)

    def tile_bound(v, rnd, hi):
        # clamp before the int cast too: XLA's cast saturates, PyTorch's CPU cast of an
        # out-of-range or NaN float does not
        return torch.clamp(torch.clamp(rnd(v / ts), 0, hi).to(torch.int32), 0, hi)

    x_min = tile_bound(mean2d[:, 0] - rx, torch.floor, gw)
    x_max = tile_bound(mean2d[:, 0] + rx, torch.ceil, gw)
    y_min = tile_bound(mean2d[:, 1] - ry, torch.floor, gh)
    y_max = tile_bound(mean2d[:, 1] + ry, torch.ceil, gh)
    n_tiles = (x_max - x_min) * (y_max - y_min)
    valid = valid & (n_tiles > 0)
    n_tiles = torch.where(valid, n_tiles, 0).to(torch.int32)

    n = means.shape[0]
    proj = Projected(
        mean2d=mean2d,
        conic=conic,
        opacity=opacity,
        color=torch.zeros((n, 3), dtype=f32, device=dev),  # colours come from the SH node
        depth=depth,
        tile_min=torch.stack([x_min, y_min], dim=-1),
        tile_max=torch.stack([x_max, y_max], dim=-1),
        n_tiles=n_tiles,
        # gsplat's tile intersection is radius-rect based (IntersectTile.cu), no per-tile
        # contribution test: a +inf threshold makes will_contribute pass every rect tile
        power_threshold=torch.full((n,), math.inf, dtype=f32, device=dev),
        visible=valid,
    )
    return proj, compensation


def _tile_pixel_points(grid_w: int, grid_h: int, tile_size: int, dev, tile_y0: int = 0):
    """Pixel centres [T, P, 2] (x, y), row-major pixels within each tile, of grid_h tile
    rows from the image's tile row `tile_y0`."""
    return torch.stack(tile_pixel_centers(grid_w * grid_h, grid_w, tile_size, dev,
                                          first_tile=tile_y0 * grid_w), dim=-1)


def gut_feature_table(means, scaling_raw, rotation_raw, opacity_raw, sh0, shN,
                      cam_position, active_sh_degree: int, proj: Projected, compensation):
    """Differentiable per-Gaussian G_* table [17, N] of the world-ray blend: M = S^-1 R^T
    row-major, gro = M (ray_o - mean), opacity x compensation (a constant; 0 where culled), the SH colour clamped >= 0, and the (constant) camera depth. Built from
    flat [N] columns, as the projection's covariance chain is, so that autograd's backward
    stays a chain of elementwise passes."""
    rc = quat_to_rotmat_cols(rotation_raw)
    inv_scale = torch.exp(-scaling_raw)  # [N,3]
    # isr[k][j] = inv_s_k * R_jk (row k of S^-1 R^T)
    isr = [[inv_scale[:, k] * rc[j][k] for j in range(3)] for k in range(3)]
    d_o = cam_position[None, :] - means  # [N,3]
    gro = [isr[k][0] * d_o[:, 0] + isr[k][1] * d_o[:, 1] + isr[k][2] * d_o[:, 2]
           for k in range(3)]
    # AA compensation multiplies opacity (rasterizer.cpp:305-311); a constant factor.
    # Selected, not multiplied by the visibility: a culled Gaussian's compensation may be
    # NaN (a degenerate projection), and 0 * NaN would put a NaN into its gradient
    opacity = torch.sigmoid(opacity_raw[:, 0]) * torch.where(proj.visible, compensation, 0.0)
    dirs = means - cam_position[None, :]
    color = torch.clamp_min(sh_to_color(sh0, shN, dirs, active_sh_degree), 0.0)
    return torch.stack([*isr[0], *isr[1], *isr[2], *gro, opacity, *color.unbind(1),
                        proj.depth])


@_host_span("gut_rays")
@torch.no_grad()
def pixel_world_rays(w2c, cam_position, fx, fy, cx, cy, cam_params, max_angle,
                     shutter_pose, *, grid_w: int, grid_h: int, tile_size: int, width: int,
                     height: int, tile_y0: int = 0):
    """Per-pixel world rays of every tile through the camera model: [T, P, 4]
    (dx, dy, dz, 0), or [T, P, 8] with the per-pixel origin offsets (dox, doy, doz, 0) of
    a rolling shutter or an orthographic camera (Cameras.cuh:346-414). The tiles are
    grid_h rows from the image's tile row `tile_y0` (a window of the multi-device render)."""
    with _builds_lock:
        pixel_world_rays.builds += 1
    pix = _tile_pixel_points(grid_w, grid_h, tile_size, w2c.device, tile_y0)  # [T,P,2]
    delta_o = None
    if cam_params.shutter != "global" and shutter_pose is not None:
        q_s, t_s, q_e, t_e = shutter_pose
        ray_o_pp, rays_d = pixel_world_rays_shutter(
            pix, q_s, t_s, q_e, t_e, fx, fy, cx, cy, cam_params, width, height,
            cam_params.shutter, max_angle,
        )
        delta_o = ray_o_pp - cam_position[None, None, :]
    else:
        cam_rays = pixel_rays(pix, fx, fy, cx, cy, cam_params, max_angle)  # [T,P,3]
        rays_d = cam_rays @ w2c[:3, :3]  # world directions
        if cam_params.model == "ortho":
            # parallel rays: per-pixel world-space origin offsets
            delta_o = ortho_ray_origins(pix, fx, fy, cx, cy) @ w2c[:3, :3]
    pad1 = torch.zeros_like(rays_d[:, :, :1])
    cols = [rays_d, pad1] if delta_o is None else [rays_d, pad1, delta_o, pad1]
    return torch.cat(cols, dim=-1).contiguous()


pixel_world_rays.builds = 0


def rasterize_gut(
    means, scaling_raw, rotation_raw, opacity_raw, sh0, shN, alive,
    w2c, cam_position, fx, fy, cx, cy,
    active_sh_degree: int,
    bg_color,  # [3] or None
    *,
    width: int,
    height: int,
    max_instances: int,
    k_max: int,
    chunk: int = 8,  # the kernels take 128 or 256; any other value means 128
    tile_size: int = 16,
    cam_params: CameraParams = CameraParams(),
    render_mode: str = "RGB",
    max_angle: float | None = None,
    shutter_pose=None,  # (q_start [4], t_start [3], q_end [4], t_end [3])
    dist=None,  # [12] distortion coeffs (radial6|tan2|tp4) on the device; overrides cam_params
    device: str | torch.device | None = None,
    impl: str = "kernel",  # "kernel" (kernel wrappers) | "plain" (plain versions)
    segred_impl: str = "segsum",  # backward reduction lane: "segsum" (K4) | "prefix" (K7)
) -> RenderOutput:
    """Differentiable GUT render of one camera (distorted pinhole / fisheye / ortho,
    global or rolling shutter). Inputs may be numpy arrays or tensors; they are moved to
    `device` (the CUDA card when None; raises without one). Tensors that require grad are
    not detached: `image`, `alpha` and `depth` carry the graph back to them.

    `dist` makes the distortion coefficients per-view device values: heterogeneous
    multi-camera rigs render each view with its own coefficients."""
    if render_mode not in RENDER_MODES:
        raise ValueError(f"render_mode must be one of {RENDER_MODES}, got {render_mode!r}")
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    if segred_impl not in SEGRED_IMPLS:
        raise ValueError(f"segred_impl must be one of {SEGRED_IMPLS}, got {segred_impl!r}")
    dev = resolve_device(device)
    f32 = [to_device(x, dev) for x in (means, scaling_raw, rotation_raw, opacity_raw,
                                        sh0, shN, w2c, cam_position)]
    means, scaling_raw, rotation_raw, opacity_raw, sh0, shN, w2c, cam_position = f32
    alive = to_device(alive, dev, torch.bool)
    bg = None if bg_color is None else to_device(bg_color, dev)
    if shutter_pose is not None:
        shutter_pose = tuple(to_device(x, dev).detach() for x in shutter_pose)
    cam_params = bind_coeffs(cam_params, None if dist is None else to_device(dist, dev))
    if cam_params.model == "fisheye" and max_angle is None:
        max_angle = fisheye_max_angle(cam_params)
    grid_w = -(-width // tile_size)
    grid_h = -(-height // tile_size)
    chunk = chunk if chunk in (128, 256) else 128

    proj, compensation = ut_project(
        means.detach(), scaling_raw.detach(), rotation_raw.detach(), opacity_raw.detach(),
        alive, w2c.detach(), fx, fy, cx, cy, cam_params, width, height, tile_size,
        max_angle, shutter_pose=shutter_pose,
    )
    with torch.no_grad():
        inst = build_sorted_instances(proj, grid_w, grid_h, max_instances, tile_size,
                                      expand=impl)
    rays = pixel_world_rays(
        w2c.detach(), cam_position.detach(), fx, fy, cx, cy, cam_params, max_angle,
        shutter_pose, grid_w=grid_w, grid_h=grid_h, tile_size=tile_size, width=width,
        height=height)
    gtab = gut_feature_table(means, scaling_raw, rotation_raw, opacity_raw, sh0, shN,
                             cam_position, active_sh_degree, proj, compensation)
    dims = dict(n_tiles=grid_w * grid_h, tile_size=tile_size, k_max=k_max, chunk=chunk)
    out = GutBlendTiles.apply(gtab, rays, inst, dims, impl, segred_impl)
    image, alpha, depth = compose_output(
        out[:, :, 0:3], 1.0 - out[:, :, 3], out[:, :, 4], bg, grid_w=grid_w, grid_h=grid_h,
        tile_size=tile_size, width=width, height=height, render_mode=render_mode,
    )
    aux = RasterAux(
        total_instances=inst.total_instances,
        max_tile_count=inst.max_tile_count,
        n_visible=inst.n_visible,
        visible=proj.visible,
    )
    return RenderOutput(image=image, alpha=alpha, aux=aux, depth=depth)
