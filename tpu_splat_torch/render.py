"""Offline rendering of a trained model — the serving path (port of `tpu_splat/render.py`).

`render_orbit` loads a Gaussian PLY or a SOG model, optionally crops it to a box, places a
turntable of cameras around its centroid and writes one PNG per frame; `render_view`
renders one camera through `rasterize`, optionally as a point cloud.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .convert import splat_from_numpy
from .core.geometry import BoundingBox, crop_splat_by_box
from .core.splat import SplatState
from .device import resolve_device
from .io.image import save_image
from .io.loader import load
from .ops.rasterize import RenderOutput, rasterize
from .utils.log import get_logger

log = get_logger(__name__)


def load_model(path: str | Path, device: str | torch.device | None = None) -> SplatState:
    """Load a Gaussian PLY or a SOG model (`.sog` zip or a directory with meta.json) into
    a SplatState on `device` (capacity = n, all alive)."""
    dev = resolve_device(device)
    raw = load(path).splat_params
    if raw is None:
        raise ValueError(f"{path} is not a renderable model (PLY/SOG)")
    n = raw["means"].shape[0]
    k_rest = raw["shN"].shape[1]
    sh_degree = int(round(math.sqrt(k_rest + 1))) - 1 if k_rest else 0
    return splat_from_numpy(raw, np.ones((n,), bool), sh_degree, dev)


def look_at(eye: np.ndarray, target: np.ndarray, up=np.array([0, -1.0, 0])) -> np.ndarray:
    """World-to-camera matrix looking from eye at target (y-down splat convention)."""
    f = target - eye
    f = f / np.linalg.norm(f)
    r = np.cross(f, up)
    r = r / np.linalg.norm(r)
    u = np.cross(f, r)
    w2c = np.eye(4, dtype=np.float32)
    w2c[0, :3], w2c[1, :3], w2c[2, :3] = r, u, f
    w2c[:3, 3] = -w2c[:3, :3] @ eye
    return w2c


def max_instances_for(n: int) -> int:
    """Instance budget of a frame of an n-Gaussian model (render.py:98)."""
    return max(1 << 16, 1 << int(np.ceil(np.log2(max(n * 16, 2)))))


def render_view(
    state: SplatState,
    w2c: np.ndarray,
    width: int,
    height: int,
    fov_deg: float = 60.0,
    bg: np.ndarray | None = None,
    render_mode: str = "RGB",
    sh_degree: Optional[int] = None,
    point_cloud: bool = False,
    device: str | torch.device | None = None,
    impl: str = "kernel",
) -> RenderOutput:
    """Render one view of `state` on `device` (the CUDA card when None).

    `point_cloud`: the point-cloud debug mode (reference viewer: point rendering toggle,
    include/rendering/rendering.hpp:42-57): every splat is drawn as a small opaque dot,
    its scales set to log(0.004 * extent + 1e-9) with the extent the RMS distance of the
    alive means from their centroid, its opacity logit to 8.0 (JAX render.py:84-96)."""
    dev = resolve_device(device)
    if state.device != dev:
        state = state.to(dev)
    f = 0.5 * width / math.tan(math.radians(fov_deg) / 2)
    cam_pos = (-w2c[:3, :3].T @ w2c[:3, 3]).astype(np.float32)
    scaling_raw, opacity_raw = state.scaling_raw, state.opacity_raw
    if point_cloud:
        alive_f = state.alive[:, None].float()
        n_alive = torch.clamp_min(torch.sum(alive_f), 1.0)
        center = torch.sum(state.means * alive_f, 0) / n_alive
        extent = torch.sqrt(
            torch.sum(torch.sum((state.means - center) ** 2, -1) * alive_f[:, 0]) / n_alive)
        scaling_raw = torch.log(0.004 * extent + 1e-9).expand_as(state.scaling_raw).clone()
        opacity_raw = torch.full_like(state.opacity_raw, 8.0)
    return rasterize(
        state.means, scaling_raw, state.rotation_raw, opacity_raw,
        state.sh0, state.shN, state.alive,
        w2c, cam_pos, f, f, width / 2.0, height / 2.0,
        state.max_sh_degree if sh_degree is None else sh_degree,
        np.zeros(3, np.float32) if bg is None else bg,
        width=width, height=height,
        max_instances=max_instances_for(state.capacity),
        k_max=4096,
        render_mode=render_mode,
        device=dev,
        impl=impl,
    )


def render_orbit(
    model_path: str | Path,
    output_dir: str | Path,
    n_frames: int = 60,
    width: int = 1280,
    height: int = 720,
    fov_deg: float = 60.0,
    elevation_deg: float = -15.0,
    radius_scale: float = 1.0,
    render_mode: str = "RGB",
    crop_box: BoundingBox | None = None,  # the viewer crop (rasterizer.cpp:84-136)
    device: str | torch.device | None = None,
) -> list[Path]:
    """Turntable render around the model's centroid; one PNG per frame. With `crop_box`,
    only the Gaussians inside the box stay alive, and the orbit centres on them."""
    dev = resolve_device(device)
    state = load_model(model_path, dev)
    if crop_box is not None:
        state = crop_splat_by_box(state, crop_box)
    means = state.means[state.alive].cpu().numpy()
    center = means.mean(axis=0)
    radius = float(np.percentile(np.linalg.norm(means - center, axis=1), 90)) * 2.0 * radius_scale

    out_dir = Path(output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    elev = math.radians(elevation_deg)
    for i in range(n_frames):
        theta = 2 * math.pi * i / n_frames
        eye = center + radius * np.array(
            [math.cos(theta) * math.cos(elev), math.sin(elev), math.sin(theta) * math.cos(elev)]
        )
        w2c = look_at(eye.astype(np.float32), center.astype(np.float32))
        out = render_view(state, w2c, width, height, fov_deg, render_mode=render_mode,
                          device=dev)
        img = np.clip(out.image.cpu().numpy(), 0, 1)
        p = out_dir / f"frame_{i:04d}.png"
        save_image(str(p), img)
        if out.depth is not None:
            d = out.depth.cpu().numpy()
            dn = (d - d.min()) / max(d.max() - d.min(), 1e-9)
            save_image(str(out_dir / f"depth_{i:04d}.png"), np.repeat(dn[None], 3, 0))
        paths.append(p)
    log.info("rendered %d frames to %s", n_frames, out_dir)
    return paths
