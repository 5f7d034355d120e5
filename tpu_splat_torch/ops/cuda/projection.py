"""Pinhole projection kernels: the EWA projection of every Gaussian slot with its SH colour,
and its backward, each one launch of `csrc/projection.cu`.

`project_kernel` and `project_backward_kernel` are what `ops/projection.py::project` runs
on a CUDA device (through `ProjectKernel`, its autograd function); the chain
`ops/projection.py::project_plain` and autograd's backward of it are their plain versions.
The forward computes each value in the chain's operation order (the source says how), so
on the card the two agree bit for bit; the backward is derived by hand. The camera's
scalars (fx, fy, cx, cy, the clamp of the normalised point, the image and tile sizes, the
SH bands) are launch arguments; w2c and the camera position are read from device memory.
Nothing is copied from the host to the device, so neither wrapper waits for the stream.
"""

from __future__ import annotations

import numpy as np
import torch

from ..sh import sh_bands
from .build import ProjCamera, check, count_launch, kernel, require_cuda


def _f32(x) -> float:
    return float(np.float32(x))


def camera_args(fx, fy, cx, cy, width: int, height: int, tile_size: int,
                active_sh_degree: int, sh_rest: int) -> ProjCamera:
    """The launch arguments: each the float32 value the chain computes with (the clamp's
    bounds are Python floats rounded once, as `torch.clamp` takes them)."""
    deg = sh_bands(active_sh_degree, sh_rest)
    cam = ProjCamera()
    cam.width, cam.height, cam.tile_size = int(width), int(height), int(tile_size)
    cam.sh_degree, cam.sh_rest = deg, int(sh_rest)
    cam.fx, cam.fy, cam.cx, cam.cy = (_f32(v) for v in (fx, fy, cx, cy))
    # the Jacobian's clamp, 0.15 of the image beyond each edge, as projection.py writes it
    cam.lo_x = _f32((-0.15 * width - cx) / fx)
    cam.hi_x = _f32((1.15 * width - cx) / fx)
    cam.lo_y = _f32((-0.15 * height - cy) / fy)
    cam.hi_y = _f32((1.15 * height - cy) / fy)
    return cam


def _inputs(means, scaling_raw, rotation_raw, opacity_raw, sh0, shN, alive, w2c,
            cam_position):
    """The kernels' inputs, detached and contiguous, checked: float32 [N, 3], [N, 3],
    [N, 4], [N, 1], [N, 1, 3], [N, K-1, 3], bool [N], [4, 4], [3], all on one card."""
    ts = [x.detach().contiguous() for x in (means, scaling_raw, rotation_raw, opacity_raw,
                                            sh0, shN, w2c, cam_position)]
    means, scaling_raw, rotation_raw, opacity_raw, sh0, shN, w2c, cam_position = ts
    alive = alive.detach().to(torch.bool).contiguous()
    n = means.shape[0]
    if (means.shape != (n, 3) or scaling_raw.shape != (n, 3) or rotation_raw.shape != (n, 4)
            or opacity_raw.shape != (n, 1) or sh0.shape != (n, 1, 3) or shN.dim() != 3
            or shN.shape[0] != n or shN.shape[2] != 3 or alive.shape != (n,)
            or w2c.shape != (4, 4) or cam_position.shape != (3,)):
        raise ValueError("project_kernel: means, scaling_raw [N, 3], rotation_raw [N, 4], "
                         "opacity_raw [N, 1], sh0 [N, 1, 3], shN [N, K-1, 3], alive [N], "
                         "w2c [4, 4] and cam_position [3] expected")
    for name, x in (("means", means), ("scaling_raw", scaling_raw),
                    ("rotation_raw", rotation_raw), ("opacity_raw", opacity_raw),
                    ("sh0", sh0), ("shN", shN), ("w2c", w2c), ("cam_position", cam_position)):
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
    require_cuda(means, means=means, scaling_raw=scaling_raw, rotation_raw=rotation_raw,
                 opacity_raw=opacity_raw, sh0=sh0, shN=shN, alive=alive, w2c=w2c,
                 cam_position=cam_position)
    return means, scaling_raw, rotation_raw, opacity_raw, sh0, shN, alive, w2c, cam_position


@torch.no_grad()
def project_kernel(means, scaling_raw, rotation_raw, opacity_raw, sh0, shN, alive, w2c,
                   cam_position, cam: ProjCamera):
    """The projection of every slot through `csrc/projection.cu` (one thread a slot) ->
    the ten fields of `Projected`, in its order."""
    (means, scaling_raw, rotation_raw, opacity_raw, sh0, shN, alive, w2c,
     cam_position) = _inputs(means, scaling_raw, rotation_raw, opacity_raw, sh0, shN, alive,
                             w2c, cam_position)
    n, dev = means.shape[0], means.device
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    out = (torch.empty((n, 2), **f32), torch.empty((n, 3), **f32), torch.empty((n,), **f32),
           torch.empty((n, 3), **f32), torch.empty((n,), **f32), torch.empty((n, 2), **i32),
           torch.empty((n, 2), **i32), torch.empty((n,), **i32), torch.empty((n,), **f32),
           torch.empty((n,), dtype=torch.bool, device=dev))
    err = kernel("projection")(
        means.data_ptr(), scaling_raw.data_ptr(), rotation_raw.data_ptr(),
        opacity_raw.data_ptr(), sh0.data_ptr(), shN.data_ptr(), alive.data_ptr(), n,
        w2c.data_ptr(), cam_position.data_ptr(), cam, *(x.data_ptr() for x in out),
        torch.cuda.current_stream(dev).cuda_stream)
    check(err, "projection")
    count_launch(project_kernel)
    return out


project_kernel.launches = 0


def _cotangent(g, shape, ref):
    """A cotangent (None: zero), contiguous, checked to be float32 of `shape` on `ref`'s
    card."""
    if g is None:
        return None
    if g.shape != shape or g.dtype != torch.float32:
        raise ValueError(f"a cotangent of shape {tuple(shape)} in float32 expected, got "
                         f"{tuple(g.shape)} {g.dtype}")
    g = g.contiguous()
    require_cuda(ref, cotangent=g)
    return g


@torch.no_grad()
def project_backward_kernel(means, scaling_raw, rotation_raw, opacity_raw, sh0, shN, alive,
                            w2c, cam_position, cam: ProjCamera, g_mean2d=None, g_conic=None,
                            g_opacity=None, g_color=None, g_depth=None,
                            g_power_threshold=None):
    """The gradients of means, scaling_raw, rotation_raw, opacity_raw, sh0 and shN from
    the cotangents of `Projected`'s mean2d, conic, opacity, color, depth and
    power_threshold (None: zero) through `csrc/projection.cu` (one thread a slot; sh0's
    values are not read)."""
    (means, scaling_raw, rotation_raw, opacity_raw, sh0, shN, alive, w2c,
     cam_position) = _inputs(means, scaling_raw, rotation_raw, opacity_raw, sh0, shN, alive,
                             w2c, cam_position)
    n, dev = means.shape[0], means.device
    gs = [_cotangent(g, shape, means) for g, shape in (
        (g_mean2d, (n, 2)), (g_conic, (n, 3)), (g_opacity, (n,)), (g_color, (n, 3)),
        (g_depth, (n,)), (g_power_threshold, (n,)))]
    grads = tuple(torch.empty_like(x) for x in (means, scaling_raw, rotation_raw,
                                                 opacity_raw, sh0, shN))
    err = kernel("projection_bwd")(
        means.data_ptr(), scaling_raw.data_ptr(), rotation_raw.data_ptr(),
        opacity_raw.data_ptr(), shN.data_ptr(), alive.data_ptr(), n, w2c.data_ptr(),
        cam_position.data_ptr(), cam, *(None if g is None else g.data_ptr() for g in gs),
        *(x.data_ptr() for x in grads), torch.cuda.current_stream(dev).cuda_stream)
    check(err, "projection_bwd")
    count_launch(project_backward_kernel)
    return grads


project_backward_kernel.launches = 0
