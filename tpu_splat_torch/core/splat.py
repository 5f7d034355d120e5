"""SplatState — the Gaussian-cloud parameters as a tensor dataclass (port of
`tpu_splat/core/splat.py`).

Fixed capacity with an alive mask, exactly as the JAX state: dead slots are masked out of
every op, so shapes never change. Parameterization (identical to the reference):
  means            [C, 3]    world positions
  sh0              [C, 1, 3] DC SH coefficient
  shN              [C, K-1, 3] rest SH coefficients (K = (sh_degree+1)^2)
  scaling_raw      [C, 3]    log(σ)
  rotation_raw     [C, 4]    unnormalized quaternion, wxyz
  opacity_raw      [C, 1]    logit(opacity)
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

C0 = 0.28209479177387814  # SH DC basis constant (kernel_utils.cuh:24)

PARAM_FIELDS = ("means", "sh0", "shN", "scaling_raw", "rotation_raw", "opacity_raw")


@dataclass
class SplatState:
    means: torch.Tensor
    sh0: torch.Tensor
    shN: torch.Tensor
    scaling_raw: torch.Tensor
    rotation_raw: torch.Tensor
    opacity_raw: torch.Tensor
    alive: torch.Tensor  # [C] bool — live slots
    max_sh_degree: int = 3
    scene_scale: float = 1.0

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    @property
    def device(self) -> torch.device:
        return self.means.device

    def n_alive(self) -> torch.Tensor:
        return torch.sum(self.alive, dtype=torch.int32)

    def params(self) -> dict[str, torch.Tensor]:
        return {k: getattr(self, k) for k in PARAM_FIELDS}

    def replace_params(self, params: dict[str, torch.Tensor]) -> "SplatState":
        return dataclasses.replace(self, **params)

    def to(self, device: torch.device | str) -> "SplatState":
        return dataclasses.replace(
            self, alive=self.alive.to(device),
            **{k: v.to(device) for k, v in self.params().items()})


def mean_neighbor_distances(points, chunk: int = 2048,
                            device: torch.device | str = "cpu") -> torch.Tensor:
    """Mean distance to the 3 nearest neighbors (excluding self / coincident points).

    Same chunked brute-force top-k as the JAX package's numpy version (O(N^2), it runs
    once at init); the reference uses a nanoflann KD-tree (`splat_data.cpp:63-112`)."""
    pts = torch.as_tensor(np.asarray(points, np.float32), device=device)
    n = pts.shape[0]
    if n <= 1:
        return torch.full((n,), 0.01, dtype=torch.float32, device=device)
    out = torch.empty((n,), dtype=torch.float32, device=device)
    sq = torch.sum(pts * pts, dim=1)
    k = min(4, n)
    for i0 in range(0, n, chunk):
        i1 = min(i0 + chunk, n)
        d2 = sq[i0:i1, None] - 2.0 * (pts[i0:i1] @ pts.T) + sq[None, :]
        d2 = d2.clamp_min(0.0)
        nd2 = torch.topk(d2, k, dim=1, largest=False, sorted=True).values
        valid = nd2 > 1e-8  # drops self-distance and coincident points (splat_data.cpp:102)
        dist = torch.sqrt(nd2) * valid
        cnt = valid.sum(dim=1).clamp_max(3)
        top3 = torch.where(torch.cumsum(valid, dim=1) <= 3, dist, 0.0).sum(dim=1)
        out[i0:i1] = torch.where(cnt > 0, top3 / cnt.clamp_min(1), 0.01)
    return out


def init_from_pointcloud(
    positions: np.ndarray,
    colors: np.ndarray,
    scene_center: np.ndarray,
    capacity: int,
    sh_degree: int = 3,
    init_opacity: float = 0.5,
    init_scaling: float = 0.1,
    device: torch.device | str = "cpu",
) -> SplatState:
    """Initialize a SplatState from SfM points (splat_data.cpp:508-614 semantics).

    colors are in [0,1]. Capacity must be >= len(positions); extra slots are dead."""
    positions = np.asarray(positions, np.float32)
    colors = np.asarray(colors, np.float32)
    n = positions.shape[0]
    if capacity < n:
        raise ValueError(f"capacity {capacity} < initial points {n}")

    dists = np.linalg.norm(positions - np.asarray(scene_center, np.float32)[None], axis=1)
    scene_scale = float(np.median(dists))

    nn_dist = mean_neighbor_distances(positions, device=device).clamp_min(1e-7)
    scaling = torch.log(torch.sqrt(nn_dist) * init_scaling)[:, None].repeat(1, 3)

    def dev(x):
        return torch.as_tensor(x, device=device)

    def pad(x: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
        tail = torch.full((capacity - n,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                          device=x.device)
        return torch.cat([x, tail], dim=0)

    k = (sh_degree + 1) ** 2
    sh0 = dev(((colors - 0.5) / C0)[:, None, :].astype(np.float32))
    shN = torch.zeros((n, k - 1, 3), dtype=torch.float32, device=device)
    rotation = torch.zeros((capacity, 4), dtype=torch.float32, device=device)
    # dead slots get identity quats too (avoid q_norm_sq < 1e-8 NaNs in masked math)
    rotation[:, 0] = 1.0
    opacity = torch.full((n, 1), float(np.log(init_opacity / (1.0 - init_opacity))),
                         dtype=torch.float32, device=device)
    alive = torch.zeros((capacity,), dtype=torch.bool, device=device)
    alive[:n] = True

    return SplatState(
        means=pad(dev(positions)),
        sh0=pad(sh0),
        shN=pad(shN),
        scaling_raw=pad(scaling),
        rotation_raw=rotation,
        opacity_raw=pad(opacity, fill=-15.0),
        alive=alive,
        max_sh_degree=sh_degree,
        scene_scale=scene_scale,
    )


def init_random(
    rng: np.random.Generator,
    num_points: int,
    extent: float,
    capacity: int,
    scene_center: np.ndarray | None = None,
    sh_degree: int = 3,
    init_opacity: float = 0.5,
    init_scaling: float = 0.1,
    device: torch.device | str = "cpu",
) -> SplatState:
    """Random init (`--random`): uniform cube of `extent`, random colors, then positions
    scaled by scene_scale (splat_data.cpp:516-547). Draws from the numpy generator in the
    JAX package's order, so the same generator gives the same cloud."""
    positions = (rng.random((num_points, 3), np.float32) * 2.0 - 1.0) * extent
    colors = rng.random((num_points, 3), np.float32)
    center = np.zeros(3, np.float32) if scene_center is None else scene_center
    dists = np.linalg.norm(positions - center[None], axis=1)
    scene_scale = float(np.median(dists))
    positions = positions * scene_scale
    return init_from_pointcloud(
        positions, colors, center, capacity, sh_degree, init_opacity, init_scaling,
        device=device,
    )
