"""Tiled rasterizer — port of `tpu_splat/ops/rasterize.py::rasterize` on its Pallas path.

  project (projection.py) -> build_sorted_instances (K1, sort; cuda/raster.py)
    -> feature pack + blend_forward (K2; cuda/blend.py) -> assemble_image

It is differentiable: tensors that require grad keep their graph. The projection with its
SH colour is one `torch.autograd.Function` on the card (`projection.py::ProjectKernel`)
and a chain under autograd elsewhere; the image assembly goes through autograd; the tile
blend is one `torch.autograd.Function`
(`BlendTiles`, counterpart of `blend_tiles_pallas`'s custom VJP) whose backward is
blend_backward (K3) -> segmented_grad_reduce (K4, reading K3's tile-sorted rows through
the emission->column index). The instance lists
(which tile sees which Gaussian, in what order) carry no gradient, as in the JAX package.

There is one pipeline on every device: on a CUDA device the wrappers launch the kernels,
on the CPU they run the kernels' plain versions. `impl="plain"` runs the plain versions
of all the kernels (the projection's two, K1-K4) on any device, forward and backward (the
reference the kernels are held against on the card).

Static plan, as in the JAX package: `max_instances` (instance budget) and `k_max`
(per-tile list capacity) bound the work; the returned `aux` counters say whether a frame
fit (`total_instances <= max_instances`, `max_tile_count <= k_max`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from .cuda.blend import (blend_backward, blend_backward_plain, blend_forward,
                         blend_forward_plain, pack_features_bf16)
from .cuda.raster import (SortedInstances, build_sorted_instances, feature_table,
                          segmented_grad_reduce)
from .projection import Projected, project

RENDER_MODES = ("RGB", "D", "ED", "RGB_D", "RGB_ED")


class RasterAux(NamedTuple):
    total_instances: torch.Tensor  # [] int32 — compare against max_instances for overflow
    max_tile_count: torch.Tensor  # [] int32 — compare against k_max for truncation
    n_visible: torch.Tensor  # [] int32
    visible: torch.Tensor  # [N] bool — per-Gaussian visibility


class RenderOutput(NamedTuple):
    image: torch.Tensor  # [3, H, W]
    alpha: torch.Tensor  # [H, W]
    aux: RasterAux
    depth: torch.Tensor | None = None  # [H, W] accumulated (D) or expected (ED) depth


def assemble_image(
    tile_colors: torch.Tensor,  # [T, P, K]
    tile_alpha: torch.Tensor,  # [T, P]
    grid_w: int,
    grid_h: int,
    tile_size: int,
    width: int,
    height: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """[T, P, K] tiles -> (image [K, H, W], alpha [H, W]), cropping tile padding."""
    ts = tile_size
    k = tile_colors.shape[-1]
    img = tile_colors.reshape(grid_h, grid_w, ts, ts, k)
    img = img.permute(4, 0, 2, 1, 3).reshape(k, grid_h * ts, grid_w * ts)
    alpha = tile_alpha.reshape(grid_h, grid_w, ts, ts)
    alpha = alpha.permute(0, 2, 1, 3).reshape(grid_h * ts, grid_w * ts)
    return img[:, :height, :width], alpha[:height, :width]


def blend_inputs(inst: SortedInstances, gtab: torch.Tensor, *, k_max: int, chunk: int,
                 pack_bf16: bool = False):
    """K2's inputs from the sorted instances and the per-Gaussian F_* table `gtab`
    [NFEAT, N]: the feature pack (one gather of the per-Gaussian columns into tile-sorted
    order; with `pack_bf16` of the bf16 B_* table built from `gtab`), the per-tile
    segments with counts capped at the list capacity, and max_chunks.
    -> (flat [NFEAT, M] f32 or [16, M] bf16, seg_start [T], count [T], max_chunks)"""
    max_chunks = -(-k_max // chunk)
    table = pack_features_bf16(gtab) if pack_bf16 else gtab
    flat = table.index_select(1, inst.sorted_gid)
    count_capped = torch.clamp_max(inst.tile_count, max_chunks * chunk)
    return flat, inst.tile_start, count_capped, max_chunks


class BlendTiles(torch.autograd.Function):
    """Feature pack + K2 forward; K3 -> `segmented_grad_reduce` (K4) backward.

    forward(gtab [NFEAT, N], inst, dims) -> out [T, P, 8] (rgb, T_final, depth, 0, 0, 0);
    `dims` may carry `tile_y0`, the image's tile row of the first tile (a window of rows).
    The only differentiable input is `gtab`; its gradient is the per-Gaussian sum of the
    per-instance gradient rows, the exact transpose of the pack's gather (with
    `pack_bf16` the forward and the backward both see the bf16-rounded features, and the
    gradient is passed straight through the rounding, as in the JAX package)."""

    @staticmethod
    def forward(ctx, gtab, inst: SortedInstances, dims: dict, impl: str):
        flat, seg_start, count, max_chunks = blend_inputs(
            inst, gtab, k_max=dims["k_max"], chunk=dims["chunk"],
            pack_bf16=dims["pack_bf16"])
        kw = dict(n_tiles=dims["grid_w"] * dims["grid_h"], grid_w=dims["grid_w"],
                  tile_size=dims["tile_size"], max_chunks=max_chunks, chunk=dims["chunk"],
                  tile_y0=dims.get("tile_y0", 0))
        fwd = blend_forward if impl == "kernel" else blend_forward_plain
        out, chk = fwd(flat, seg_start, count, **kw)
        ctx.save_for_backward(flat, seg_start, count, chk, out)
        ctx.inst, ctx.kw, ctx.impl = inst, kw, impl
        return out

    @staticmethod
    def backward(ctx, gout):
        kernels = ctx.impl == "kernel"
        bwd = blend_backward if kernels else blend_backward_plain
        gflat = bwd(*ctx.saved_tensors, gout.contiguous(), **ctx.kw)
        return segmented_grad_reduce(gflat, ctx.inst, kernels=kernels), None, None, None


def blend_instances(inst: SortedInstances, gtab: torch.Tensor, *, grid_w: int, grid_h: int,
                    tile_size: int, k_max: int, chunk: int, impl: str = "kernel",
                    pack_bf16: bool = False, tile_y0: int = 0):
    """Feature pack + K2, differentiable in `gtab`, over grid_h tile rows from the image's
    tile row `tile_y0`. -> (tile_colors [T, P, 3], tile_alpha [T, P], tile_depth [T, P])."""
    dims = dict(grid_w=grid_w, grid_h=grid_h, tile_size=tile_size, k_max=k_max,
                chunk=chunk, pack_bf16=pack_bf16, tile_y0=tile_y0)
    out = BlendTiles.apply(gtab, inst, dims, impl)
    return out[:, :, 0:3], 1.0 - out[:, :, 3], out[:, :, 4]


def compose_output(tile_colors, tile_alpha, tile_depth, bg_color, *, grid_w: int,
                   grid_h: int, tile_size: int, width: int, height: int,
                   render_mode: str) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Tiles -> (image [3, H, W], alpha [H, W], depth [H, W] or None).

    Background is composited OUTSIDE the blend as image + (1-alpha)*bg
    (fast_rasterizer.cpp:63). D accumulates alpha-weighted camera-space depth, ED
    normalizes it by alpha (expected depth), as in rasterizer.hpp:25-32."""
    dims = dict(grid_w=grid_w, grid_h=grid_h, tile_size=tile_size, width=width,
                height=height)
    image, alpha = assemble_image(tile_colors, tile_alpha, **dims)
    depth = None
    if render_mode != "RGB":
        dimg, _ = assemble_image(tile_depth[:, :, None], tile_alpha, **dims)
        depth = dimg[0]
        if render_mode in ("ED", "RGB_ED"):
            depth = depth / torch.clamp_min(alpha, 1e-10)
    if bg_color is not None:
        image = image + (1.0 - alpha)[None] * bg_color.reshape(3, 1, 1)
    return image, alpha, depth


def to_device(x, device: torch.device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """numpy or tensor input -> tensor of `dtype` on `device` (no copy when already so)."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return torch.as_tensor(x, dtype=dtype, device=device)


def rasterize(
    means, scaling_raw, rotation_raw, opacity_raw, sh0, shN, alive,
    w2c, cam_position, fx, fy, cx, cy,
    active_sh_degree: int,
    bg_color,  # [3] or None
    *,
    width: int,
    height: int,
    max_instances: int,
    k_max: int,
    chunk: int = 64,
    tile_size: int = 16,
    render_mode: str = "RGB",  # RGB | D | ED | RGB_D | RGB_ED (rasterizer.hpp:25-32)
    mean2d_offset=None,  # [N, 2] zeros; pass (requiring grad) to read dL/dmean2d
    pack_bf16: bool = False,  # bf16 hi/lo feature pack (cuda/blend.py B_* layout)
    device: str | torch.device | None = None,
    impl: str = "kernel",  # "kernel" (kernel wrappers) | "plain" (plain versions)
) -> RenderOutput:
    """Differentiable render of one pinhole camera. Inputs may be numpy arrays or
    tensors; they are moved to `device` (the CUDA card when None; raises without one).
    Tensors that require grad are not detached: `image`, `alpha` and `depth` carry the
    graph back to them. `aux` carries no gradient."""
    if render_mode not in RENDER_MODES:
        raise ValueError(f"render_mode must be one of {RENDER_MODES}, got {render_mode!r}")
    if impl not in ("kernel", "plain"):
        raise ValueError(f"impl must be 'kernel' or 'plain', got {impl!r}")
    dev = resolve_device(device)
    f32 = [to_device(x, dev) for x in (means, scaling_raw, rotation_raw, opacity_raw,
                                        sh0, shN, w2c, cam_position)]
    means, scaling_raw, rotation_raw, opacity_raw, sh0, shN, w2c, cam_position = f32
    alive = to_device(alive, dev, torch.bool)
    bg = None if bg_color is None else to_device(bg_color, dev)
    grid_w = -(-width // tile_size)
    grid_h = -(-height // tile_size)

    proj: Projected = project(
        means, scaling_raw, rotation_raw, opacity_raw, sh0, shN, alive,
        w2c, cam_position, fx, fy, cx, cy, width, height, active_sh_degree,
        tile_size=tile_size, impl=impl,
    )
    if mean2d_offset is not None:
        proj = proj._replace(mean2d=proj.mean2d + to_device(mean2d_offset, dev))
    with torch.no_grad():
        inst = build_sorted_instances(proj, grid_w, grid_h, max_instances, tile_size,
                                      expand=impl)
    tile_colors, tile_alpha, tile_depth = blend_instances(
        inst, feature_table(proj), grid_w=grid_w, grid_h=grid_h, tile_size=tile_size,
        k_max=k_max,
        chunk=chunk if chunk in (128, 256) else 128,  # the kernel's chunk widths
        impl=impl, pack_bf16=pack_bf16,
    )
    image, alpha, depth = compose_output(
        tile_colors, tile_alpha, tile_depth, bg, grid_w=grid_w, grid_h=grid_h,
        tile_size=tile_size, width=width, height=height, render_mode=render_mode,
    )
    aux = RasterAux(
        total_instances=inst.total_instances,
        max_tile_count=inst.max_tile_count,
        n_visible=inst.n_visible,
        visible=proj.visible.detach(),
    )
    return RenderOutput(image=image, alpha=alpha, aux=aux, depth=depth)
