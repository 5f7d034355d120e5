"""Per-image learned bilateral color grids (appearance compensation), port of
`tpu_splat/training/bilateral_grid.py`.

Reference: src/training/components/bilateral_grid.cpp + kernels
src/training/kernels/bilateral_grid_{forward,backward,tv}.cu. Each training image owns a
[12, L, H, W] grid (default L=8, H=16, W=16) of 3x4 affine color matrices initialized to
identity; `slice_grid` trilinearly fetches a matrix per pixel at (x/(w-1)*(W-1),
y/(h-1)*(H-1), gray*(L-1)) with gray = 0.299 R + 0.587 G + 0.114 B of the *clamped*
rendered color (bilateral_grid_forward.cu:10-90), and applies rgb' = A @ [rgb, 1]. A
total-variation loss regularizes the grids (bilateral_grid_tv.cu:12-80).

Both are plain differentiable tensor ops: autograd takes the backward (the gather's is a
scatter-add). The JAX package has no Pallas kernel here either.

Applied AFTER rasterization, BEFORE the photometric loss (trainer.cpp:662-665). Optimized
by a separate Adam (lr 2e-3, eps 1e-15) with WarmupExponentialLR (1000 warmup steps from
1%, gamma 0.01^(1/iterations)) (trainer.cpp:66-101).
"""

from __future__ import annotations

import numpy as np
import torch

GRAY = (0.299, 0.587, 0.114)  # kC2G (bilateral_grid_forward.cu:11)


def init_grids(num_images: int, grid_w: int = 16, grid_h: int = 16, grid_l: int = 8,
               device: torch.device | str = "cpu") -> torch.Tensor:
    """[N, 12, L, H, W] grids, identity affine (bilateral_grid.cpp:82-93)."""
    eye = np.eye(4, dtype=np.float32)[:3].reshape(12)  # row-major 3x4
    grid = np.tile(eye, (grid_l, grid_h, grid_w, 1))  # [L,H,W,12]
    grid = np.transpose(grid, (3, 0, 1, 2))  # [12,L,H,W]
    return torch.as_tensor(np.tile(grid[None], (num_images, 1, 1, 1, 1)), device=device)


def slice_grid(grid: torch.Tensor, rgb: torch.Tensor) -> torch.Tensor:
    """Apply one image's grid to a rendered image.

    grid [12, L, H, W]; rgb [3, h, w] in [0,1] (clamped here like bilateral_grid.cpp:113).
    Returns [3, h, w].
    """
    twelve, L, H, W = grid.shape
    _, h, w = rgb.shape
    dev, dt = rgb.device, rgb.dtype
    rgb = torch.clamp(rgb, 0.0, 1.0)
    r, g, b = rgb[0], rgb[1], rgb[2]

    # uniform pixel coords (bilateral_grid_forward.cu:33-40)
    gx = torch.arange(w, dtype=dt, device=dev) / max(w - 1, 1)
    gy = torch.arange(h, dtype=dt, device=dev) / max(h - 1, 1)
    x = (gx[None, :] * (W - 1)).expand(h, w)
    y = (gy[:, None] * (H - 1)).expand(h, w)
    gray = GRAY[0] * r + GRAY[1] * g + GRAY[2] * b
    z = gray * (L - 1)

    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    z0 = torch.clamp_min(torch.floor(z).to(torch.int64), 0)
    x1 = torch.clamp_max(x0 + 1, W - 1)
    y1 = torch.clamp_max(y0 + 1, H - 1)
    z1 = torch.clamp(z0 + 1, 0, L - 1)
    fx = x - x0
    fy = y - y0
    fz = z - z0.to(dt)

    flat = grid.reshape(twelve, L * H * W)  # [12, LHW]

    def fetch(zi, yi, xi):
        idx = (zi * H + yi) * W + xi  # [h,w]
        return flat[:, idx]  # [12,h,w]

    val = (
        fetch(z0, y0, x0) * ((1 - fx) * (1 - fy) * (1 - fz))[None]
        + fetch(z0, y0, x1) * (fx * (1 - fy) * (1 - fz))[None]
        + fetch(z0, y1, x0) * ((1 - fx) * fy * (1 - fz))[None]
        + fetch(z0, y1, x1) * (fx * fy * (1 - fz))[None]
        + fetch(z1, y0, x0) * ((1 - fx) * (1 - fy) * fz)[None]
        + fetch(z1, y0, x1) * (fx * (1 - fy) * fz)[None]
        + fetch(z1, y1, x0) * ((1 - fx) * fy * fz)[None]
        + fetch(z1, y1, x1) * (fx * fy * fz)[None]
    )  # [12, h, w]

    a = val.reshape(3, 4, h, w)  # A[d, s]: d = ci//4 output, s = ci%4 source
    return a[:, 0] * r[None] + a[:, 1] * g[None] + a[:, 2] * b[None] + a[:, 3]  # [3,h,w]


def tv_loss(grids: torch.Tensor) -> torch.Tensor:
    """Total variation over [N, 12, L, H, W] grids (bilateral_grid_tv.cu:12-80).

    Each direction's squared diffs are normalized by the count of *cells along the other
    axes times (axis-1)*, then the sum is divided by 12*N.
    """
    n, c, L, H, W = grids.shape
    dx = grids[..., :, :, 1:] - grids[..., :, :, :-1]
    dy = grids[..., :, 1:, :] - grids[..., :, :-1, :]
    dz = grids[..., 1:, :, :] - grids[..., :-1, :, :]
    loss = (
        torch.sum(dx * dx) / (L * H * (W - 1))
        + torch.sum(dy * dy) / (L * (H - 1) * W)
        + torch.sum(dz * dz) / ((L - 1) * H * W)
    )
    return loss / (12.0 * n)


def warmup_exponential_lr(base_lr: float, step: int, gamma: float, warmup_steps: int = 1000,
                          start_factor: float = 0.01) -> float:
    """WarmupExponentialLR closed form (scheduler.cpp:27-53). `step` is 1-based. Computed
    in float32, as the JAX package computes it on the device; returned as a Python float."""
    f32 = np.float32
    stepf = f32(step)
    if stepf <= warmup_steps:
        lr = f32(base_lr) * (f32(start_factor) + f32(1.0 - start_factor) * stepf
                             / f32(max(warmup_steps, 1)))
    else:
        lr = f32(base_lr) * np.power(f32(gamma), stepf - f32(warmup_steps))
    return float(f32(lr))
