"""Tiled rasterizer — port of `tpu_splat/ops/rasterize.py::rasterize` on its Pallas path.

  project (projection.py) -> build_sorted_instances (K1, sort; cuda/raster.py)
    -> feature pack + blend_forward (K2; cuda/blend.py) -> assemble_image

There is one pipeline on every device: on a CUDA device the wrappers launch the kernels,
on the CPU they run the kernels' plain versions. `impl="plain"` runs the plain versions
on any device (the reference the kernels are held against on the card).

Static plan, as in the JAX package: `max_instances` (instance budget) and `k_max`
(per-tile list capacity) bound the work; the returned `aux` counters say whether a frame
fit (`total_instances <= max_instances`, `max_tile_count <= k_max`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from .cuda.blend import blend_forward, blend_forward_plain
from .cuda.raster import SortedInstances, build_sorted_instances
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


def blend_inputs(inst: SortedInstances, *, k_max: int, chunk: int):
    """K2's inputs from the sorted instances: the feature pack (one gather of the
    per-Gaussian F_* columns into tile-sorted order), the per-tile segments with counts
    capped at the list capacity, and max_chunks.
    -> (flat [NFEAT, M], seg_start [T], count [T], max_chunks)"""
    max_chunks = -(-k_max // chunk)
    flat = inst.gtab.index_select(1, inst.sorted_gid)
    count_capped = torch.clamp_max(inst.tile_count, max_chunks * chunk)
    return flat, inst.tile_start, count_capped, max_chunks


def blend_instances(inst: SortedInstances, *, grid_w: int, grid_h: int, tile_size: int,
                    k_max: int, chunk: int, impl: str = "kernel"):
    """Feature pack + K2. -> (tile_colors [T, P, 3], tile_alpha [T, P], tile_depth [T, P])."""
    flat, seg_start, count, max_chunks = blend_inputs(inst, k_max=k_max, chunk=chunk)
    fn = blend_forward if impl == "kernel" else blend_forward_plain
    out, _ = fn(flat, seg_start, count, n_tiles=grid_w * grid_h, grid_w=grid_w,
                tile_size=tile_size, max_chunks=max_chunks, chunk=chunk)
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
    device: str | torch.device | None = None,
    impl: str = "kernel",  # "kernel" (K1/K2 wrappers) | "plain" (plain versions)
) -> RenderOutput:
    """Forward render of one pinhole camera. Inputs may be numpy arrays or tensors; they
    are moved to `device` (the CUDA card when None; raises without one)."""
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
        tile_size=tile_size,
    )
    inst = build_sorted_instances(proj, grid_w, grid_h, max_instances, tile_size,
                                  expand=impl)
    tile_colors, tile_alpha, tile_depth = blend_instances(
        inst, grid_w=grid_w, grid_h=grid_h, tile_size=tile_size, k_max=k_max,
        chunk=chunk if chunk in (128, 256) else 128,  # the kernel's chunk widths
        impl=impl,
    )
    image, alpha, depth = compose_output(
        tile_colors, tile_alpha, tile_depth, bg, grid_w=grid_w, grid_h=grid_h,
        tile_size=tile_size, width=width, height=height, render_mode=render_mode,
    )
    aux = RasterAux(
        total_instances=inst.total_instances,
        max_tile_count=inst.max_tile_count,
        n_visible=inst.n_visible,
        visible=proj.visible,
    )
    return RenderOutput(image=image, alpha=alpha, aux=aux, depth=depth)
