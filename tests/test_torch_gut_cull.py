"""The cull of the GUT blend kernels K5 and K6, through its plain twin, on the CPU.

`ops/cuda/gut_kernels.py::gut_cull_spheres` / `gut_cull_cones` / `gut_cull_keep` compute
what `csrc/gut_common.cuh` computes: each instance's widened 1/255 sphere, each 8x4
sub-rectangle's ray cone, and whether the two may meet. The kernels skip a (pixel,
instance) pair only where the test says so, so the property held here is exact: no pair
that the blend's own arithmetic (`ray_response`: lane_valid & alpha >= 1/255) marks valid
is ever culled. Cases: Gaussians along the rays of the four camera models (distorted
pinhole, fisheye out to its max_angle, ortho and rolling shutter with rays 8 wide) with
anisotropy up to 1:200, nearly singular and singular M, opacities within 1e-6 of 1/255,
Gaussians behind the camera on a ray's line and one that holds the camera origin; Gaussians
grazing the cones' edges; NaN and Inf instances and rays, zero-length rays; chip_smoke.py's
random segments. The tests also check that the cull has teeth. Imports neither JAX nor the
JAX package; run alone with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gut_cull.py
"""

import math

import numpy as np
import pytest
import torch

from tpu_splat_torch.ops.cuda.gut_kernels import (gut_cull_cones, gut_cull_keep,
                                                  gut_cull_spheres, ray_columns,
                                                  ray_response)

from chip_smoke import (MIN_ALPHA_F32, gut_border_segments, gut_camera_rays,
                        gut_grazing_splats, gut_table, random_gut_segments, rotations)

GRID = (3, 2)  # tiles of each camera case
CHUNK = 128


def _gaussians_on_rays(rng, rays, cam_pos, focal, n, ortho=False):
    """n Gaussians placed on or near random pixels' rays (some behind the camera on the
    ray's line), 1-6 px footprints, anisotropy up to 1:200, plus nearly singular and
    singular ones, opacities within 1e-6 of 1/255, and one that holds the camera origin."""
    flat_rays = rays.reshape(-1, rays.shape[-1]).double().numpy()
    pick = flat_rays[rng.integers(0, len(flat_rays), n)]
    d = pick[:, :3] / np.linalg.norm(pick[:, :3], axis=1, keepdims=True)
    origin = cam_pos[None, :] + (pick[:, 4:7] if rays.shape[-1] == 8 else 0.0)
    depth = rng.uniform(1.0, 8.0, n) * np.where(rng.random(n) < 0.15, -1.0, 1.0)
    px = 1.0 / focal if ortho else np.abs(depth) / focal  # world size of a pixel
    sigma = px * rng.uniform(1.0, 6.0, n)
    aniso = np.stack([np.ones(n), rng.uniform(1 / 200, 1, n), rng.uniform(1 / 200, 1, n)], 1)
    kind = rng.integers(0, 10, n)
    aniso[kind == 0, 2] = 10.0 ** rng.uniform(-5, -3, int((kind == 0).sum()))  # nearly singular
    aniso[kind == 1, 1:] = 1e-7  # singular in float32 terms: kept everywhere
    scales = sigma[:, None] * aniso
    off = rng.normal(0, 1, (n, 3)) * sigma[:, None] * rng.uniform(0, 2.5, (n, 1))
    mean = origin + depth[:, None] * d + off
    op = rng.uniform(0.02, 1.0, n)
    near = kind == 2  # opacity within 1e-6 of 1/255, mean on the ray
    op[near] = MIN_ALPHA_F32 * (1 + rng.uniform(-1e-6, 1e-6, int(near.sum())))
    mean[near] = (origin + depth[:, None] * d)[near]
    mean[0], scales[0], op[0] = cam_pos + 0.1 * d[0], 0.5, 0.9  # holds the camera origin
    return torch.from_numpy(gut_table(mean, scales, rotations(rng, n), op, cam_pos, rng))


def _cull_check(flat, rays, tile_size):
    """Every tile sees every instance. Asserts that no valid pair is culled.
    -> (valid pairs, kept pairs) [n] of each instance"""
    n_tiles, n = rays.shape[0], flat.shape[1]
    cones, do_max = gut_cull_cones(rays, tile_size)
    d, do = ray_columns(rays)
    start = torch.zeros(n_tiles, dtype=torch.long)
    count = torch.full((n_tiles,), n, dtype=torch.long)
    n_valid, n_kept = [], []
    for j in range(-(-n // CHUNK)):
        f, _, lane_valid, _, valid, _ = ray_response(flat, d, do, start, count, j, CHUNK)
        keep = gut_cull_keep(gut_cull_spheres(f, do_max[:, None]), cones, tile_size)
        keep &= lane_valid[:, :, None]
        assert not bool((valid & ~keep).any()), f"{int((valid & ~keep).sum())} valid pairs culled"
        n_valid.append(valid.sum((0, 2))[lane_valid[0]])
        n_kept.append(keep.sum((0, 2))[lane_valid[0]])
    return torch.cat(n_valid), torch.cat(n_kept)


@pytest.mark.parametrize("tile_size", [16, 32])
@pytest.mark.parametrize("model", ["pinhole", "fisheye", "ortho", "rolling"])
def test_gut_cull_never_drops_a_valid_pair_through_each_camera(model, tile_size):
    rays, cam_pos, focal = gut_camera_rays(model, *GRID, tile_size)
    assert rays.shape[-1] == (8 if model in ("ortho", "rolling") else 4)
    flat = _gaussians_on_rays(np.random.default_rng(tile_size), rays, cam_pos, focal, 400,
                              ortho=model == "ortho")
    n_valid, n_kept = _cull_check(flat, rays, tile_size)
    assert int(n_valid.sum()) > 20_000
    # the cull has teeth: around each bounded sphere it keeps a few sub-rectangles
    bounded = torch.isfinite(gut_cull_spheres(flat)[3])
    assert 0.8 < float(bounded.float().mean()) < 0.95  # the singular ones keep everything
    kept, valid = int(n_kept[bounded].sum()), int(n_valid[bounded].sum())
    assert kept < 0.5 * int(bounded.sum()) * rays.shape[0] * rays.shape[1] and kept < 5 * valid


@pytest.mark.parametrize("model,tile_size", [("pinhole", 32), ("ortho", 16)])
def test_gut_cull_on_the_cone_edges(model, tile_size):
    """Gaussians just outside a sub-rectangle's cone, whose 1/255 ellipsoid grazes the ray
    of one of its corner pixels within a relative 1e-3 to 1e-7 of the level; the grazing
    axis is the Gaussian's longest, so the sphere is tight there."""
    rays, cam_pos, focal = gut_camera_rays(model, *GRID, tile_size)
    rng = np.random.default_rng(5)
    n = 600
    t = rng.integers(0, rays.shape[0], n)
    flat, corner = gut_grazing_splats(rng, rays, cam_pos, focal, t,
                                      rng.integers(0, tile_size * tile_size // 32, n),
                                      rng.choice([0, 7, 24, 31], n), model == "ortho")
    flat = torch.from_numpy(flat)
    # each Gaussian against its own tile's rays
    cones_t, do_max = gut_cull_cones(rays[t], tile_size)
    dd, do = ray_columns(rays[t])
    f, _, _, _, valid, _ = ray_response(flat, dd, do, torch.arange(n), torch.ones(n).long(), 0, 1)
    keep = gut_cull_keep(gut_cull_spheres(f, do_max[:, None]), cones_t, tile_size)
    assert not bool((valid & ~keep).any())
    grazed = valid[torch.arange(n), 0, torch.from_numpy(corner)]
    assert 0.2 < float(grazed.float().mean()) < 0.8  # both sides of the level


def test_gut_cull_keeps_everything_for_non_finite_values_and_zero_rays():
    rays, cam_pos, focal = gut_camera_rays("pinhole", *GRID, 16)
    flat = _gaussians_on_rays(np.random.default_rng(3), rays, cam_pos, focal, 64)
    nan, inf = math.nan, math.inf
    for i, (row, value) in enumerate([(0, nan), (4, inf), (10, -inf), (12, nan), (12, inf),
                                      (8, -inf)]):
        flat[row, i] = value
    flat[:9, 6] = torch.eye(3).reshape(9) * 2.0  # a round Gaussian on the camera origin
    flat[9:12, 6] = 0.0
    flat[12, 7] = 0.0  # op = 0 and op < 0: empty
    flat[12, 8] = -0.5
    bad = rays.clone()
    bad[0, :32, :3] = 0.0  # zero-length rays in tile 0's first cells
    bad[1, 5, 0] = nan
    bad[1, 40, 2] = inf
    bad[2, 100, :3] *= 1e4  # longer than the cones bound
    n_valid, _ = _cull_check(flat, bad, 16)
    assert int(n_valid.sum()) > 0
    sph = gut_cull_spheres(flat)
    assert bool(torch.isinf(sph[3, :6]).all() and (sph[3, :6] > 0).all())  # keep all
    assert float(sph[3, 7]) == -inf and float(sph[3, 8]) == -inf  # empty
    cones, _ = gut_cull_cones(bad, 16)
    cover = cones.new_tensor([0, 0, 0, 1, 0, 0, 0, 0, 0])
    for t, s in ((0, 0), (0, 1), (1, 0), (1, 1), (2, 2)):
        assert torch.equal(cones[t, s], cover), (t, s)
    # a zero ray accepts an instance with op >= 1/255 whatever its geometry: kept
    keep = gut_cull_keep(sph[:, None, :], cones, 16)
    assert bool(keep[0, :7][:, :32].all()) and not bool(keep[:, 7:9].any())


@pytest.mark.parametrize("case,tile_size,chunk", [
    ("rays4", 16, 128), ("rays8", 32, 128), ("pinhole", 32, 128), ("fisheye", 16, 128),
    ("ortho", 16, 256), ("rolling", 32, 128)])
def test_gut_cull_keeps_every_used_pair_of_random_segments(case, tile_size, chunk):
    """chip_smoke.py's random GUT blend inputs and its segments on the cones' borders
    through each camera model (a smaller grid), pair by pair over every chunk of every
    tile."""
    if case.startswith("rays"):
        (flat, rays, seg_start, count), kw = random_gut_segments(tile_size, chunk, 5, "cpu",
                                                                 int(case[4:]))
    else:
        (flat, rays, seg_start, count), kw = gut_border_segments(case, tile_size, chunk, 6,
                                                                 "cpu", grid=(3, 2))
    cones, do_max = gut_cull_cones(rays, tile_size)
    d, do = ray_columns(rays)
    n_valid = n_kept = n_pairs = 0
    for j in range(kw["max_chunks"]):
        f, _, lane_valid, _, valid, _ = ray_response(flat, d, do, seg_start.long(),
                                                     count.long(), j, chunk)
        keep = gut_cull_keep(gut_cull_spheres(f, do_max[:, None]), cones, tile_size)
        keep &= lane_valid[:, :, None]
        assert not bool((valid & ~keep).any())
        n_valid += int(valid.sum())
        n_kept += int(keep.sum())
        n_pairs += int(lane_valid.sum()) * tile_size * tile_size
    assert n_valid > 0 and n_kept < 0.6 * n_pairs and n_kept < 6 * n_valid
