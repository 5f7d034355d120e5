"""GUT projection kernels: the UT projection of every Gaussian slot and the per-pixel world
rays of a window of tiles, each one launch of `csrc/gut_project.cu`.

`ut_project_kernel` and `pixel_world_rays_kernel` are what `ops/gut.py::ut_project` and
`pixel_world_rays` launch on a CUDA device under the global shutter; the chains in
`ops/gut.py` and `ops/cameras.py` are their plain versions, and the kernels compute each
value in the chains' operation order (the source says how), so on the card the two agree
bit for bit. The camera's scalars (fx, fy, cx, cy, the image and tile sizes, the model,
static distortion coefficients and max angle) are launch arguments; w2c, distortion
coefficients bound to a view (a [12] device tensor) and a max angle held in a 0-dim device
tensor are read from device memory. Nothing is copied from the host to the device, so
neither wrapper waits for the stream.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..cameras import BoundCameraParams, fisheye_max_angle
from ..projection import Projected
from .build import Camera, UtConsts, check, count_launch, kernel, require_cuda

MODELS = ("pinhole", "fisheye", "ortho")
MARGIN = 0.15  # cameras.py::project_points' default margin


def _f32(x) -> float:
    return float(np.float32(x))


def camera_args(fx, fy, cx, cy, cam_params, width: int, height: int, tile_size: int,
                max_angle, dev):
    """-> (Camera, dist [12] device tensor or None, max angle 0-dim device tensor or None),
    the two tensors to be kept alive until the launch is queued. A fisheye's max angle,
    when None, is `fisheye_max_angle`'s, as the plain chains take it."""
    if cam_params.model not in MODELS:
        raise ValueError(f"camera model must be one of {MODELS}, got {cam_params.model!r}")
    if cam_params.model == "fisheye" and max_angle is None:
        max_angle = fisheye_max_angle(cam_params)
    cam = Camera()
    cam.model = MODELS.index(cam_params.model)
    cam.width, cam.height, cam.tile_size = int(width), int(height), int(tile_size)
    cam.fx, cam.fy, cam.cx, cam.cy = (_f32(v) for v in (fx, fy, cx, cy))
    # a division by a host scalar: PyTorch multiplies by its float32 reciprocal
    cam.rfx = float(np.float32(1.0) / np.float32(fx))
    cam.rfy = float(np.float32(1.0) / np.float32(fy))
    mx, my = MARGIN * width, MARGIN * height
    cam.lo_x, cam.hi_x, cam.lo_y, cam.hi_y = (_f32(v) for v in (-mx, width + mx, -my,
                                                                 height + my))
    dist = None
    if isinstance(cam_params, BoundCameraParams):
        dist = cam_params.coeffs.to(dev, torch.float32).contiguous()
    else:
        k = tuple(cam_params.radial) + tuple(cam_params.tangential) + tuple(cam_params.thin_prism)
        cam.coef[:] = [_f32(v) for v in k]
        # the fisheye derivative's 3 k1, 5 k2, 7 k3: Python floats, rounded once
        cam.dk[:] = [_f32(3 * k[0]), _f32(5 * k[1]), _f32(7 * k[2])]
    angle = None
    if isinstance(max_angle, torch.Tensor) and max_angle.device.type != "cpu":
        angle = max_angle.reshape(()).to(torch.float32)
        require_cuda(angle, max_angle=angle)
        if angle.device != dev:
            raise ValueError(f"max_angle must be on {dev}, got {angle.device}")
    else:
        cam.max_angle = _f32(math.pi if max_angle is None else float(max_angle))
    return cam, dist, angle


def _ptr(x) -> int | None:
    return None if x is None else x.data_ptr()


@torch.no_grad()
def ut_project_kernel(means, scaling_raw, rotation_raw, opacity_raw, alive, w2c,
                      fx, fy, cx, cy, cam_params, width: int, height: int, tile_size: int,
                      max_angle, consts: UtConsts):
    """UT projection of every slot through `csrc/gut_project.cu` (one thread a slot) ->
    (Projected, compensation [N]). `max_angle`: None, a float or a 0-dim device tensor;
    `consts` holds the UT weights and the tail's constants."""
    dev = means.device
    means, scaling_raw, rotation_raw, opacity_raw = (
        x.detach().contiguous() for x in (means, scaling_raw, rotation_raw, opacity_raw))
    alive = alive.detach().to(torch.bool).contiguous()
    w2c = w2c.detach().to(torch.float32).contiguous()
    n = means.shape[0]
    if (means.shape != (n, 3) or scaling_raw.shape != (n, 3) or rotation_raw.shape != (n, 4)
            or opacity_raw.numel() != n or alive.shape != (n,) or w2c.shape != (4, 4)):
        raise ValueError("ut_project_kernel: means, scaling_raw [N, 3], rotation_raw [N, 4], "
                         "opacity_raw [N, 1], alive [N] and w2c [4, 4] expected")
    for name, x in (("means", means), ("scaling_raw", scaling_raw),
                    ("rotation_raw", rotation_raw), ("opacity_raw", opacity_raw)):
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
    require_cuda(means, means=means, scaling_raw=scaling_raw, rotation_raw=rotation_raw,
                 opacity_raw=opacity_raw, alive=alive, w2c=w2c)
    cam, dist, angle = camera_args(fx, fy, cx, cy, cam_params, width, height, tile_size,
                                   max_angle, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    proj = Projected(
        mean2d=torch.empty((n, 2), **f32), conic=torch.empty((n, 3), **f32),
        opacity=torch.empty((n,), **f32), color=torch.empty((n, 3), **f32),
        depth=torch.empty((n,), **f32), tile_min=torch.empty((n, 2), **i32),
        tile_max=torch.empty((n, 2), **i32), n_tiles=torch.empty((n,), **i32),
        power_threshold=torch.empty((n,), **f32),
        visible=torch.empty((n,), dtype=torch.bool, device=dev))
    comp = torch.empty((n,), **f32)
    err = kernel("gut_project")(
        means.data_ptr(), scaling_raw.data_ptr(), rotation_raw.data_ptr(),
        opacity_raw.data_ptr(), alive.data_ptr(), n, w2c.data_ptr(), _ptr(dist), _ptr(angle),
        cam, consts, proj.mean2d.data_ptr(), proj.conic.data_ptr(), proj.opacity.data_ptr(),
        proj.color.data_ptr(), proj.depth.data_ptr(), proj.tile_min.data_ptr(),
        proj.tile_max.data_ptr(), proj.n_tiles.data_ptr(), proj.power_threshold.data_ptr(),
        proj.visible.data_ptr(), comp.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    check(err, "gut_project")
    count_launch(ut_project_kernel)
    return proj, comp


ut_project_kernel.launches = 0


@torch.no_grad()
def pixel_world_rays_kernel(w2c, fx, fy, cx, cy, cam_params, max_angle, *, grid_w: int,
                            grid_h: int, tile_size: int, width: int, height: int,
                            tile_y0: int = 0):
    """World rays of every pixel of grid_h tile rows from tile row `tile_y0` through
    `csrc/gut_project.cu` (one thread a pixel) -> [T, P, 4] (dx, dy, dz, 0), or [T, P, 8]
    with the per-pixel origin offsets (dox, doy, doz, 0) of an ortho camera."""
    dev = w2c.device
    w2c = w2c.detach().to(torch.float32).contiguous()
    if w2c.shape != (4, 4):
        raise ValueError(f"w2c must be [4, 4], got {tuple(w2c.shape)}")
    require_cuda(w2c, w2c=w2c)
    cam, dist, angle = camera_args(fx, fy, cx, cy, cam_params, width, height, tile_size,
                                   max_angle, dev)
    n_tiles = grid_w * grid_h
    wide = 8 if cam_params.model == "ortho" else 4
    rays = torch.empty((n_tiles, tile_size * tile_size, wide), dtype=torch.float32,
                       device=dev)
    err = kernel("gut_rays")(
        w2c.data_ptr(), _ptr(dist), _ptr(angle), cam, grid_w, n_tiles, tile_y0,
        rays.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    check(err, "gut_rays")
    count_launch(pixel_world_rays_kernel)
    return rays


pixel_world_rays_kernel.launches = 0
