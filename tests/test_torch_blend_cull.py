"""The cull of the blend kernels K2 and K3, through its plain twin, on the CPU.

`ops/cuda/blend.py::cull_boxes` / `cull_keep` compute what `csrc/blend_common.cuh` computes:
each instance's widened 1/255 box and whether it meets a pixel's 8x4 sub-rectangle. The
kernels skip a (pixel, instance) pair only where the test says so, so the property held
here is exact: no pair that the blend's own decision arithmetic (`_chunk_alphas`) marks
valid is ever culled — on random conics and on the cases nearest the threshold (pixels on
the ellipse's edge, opacity just above 1/255, nearly degenerate, non-definite and
non-finite conics). The tests also check that the cull has teeth where it should.
Imports neither JAX nor the JAX package.
"""

import math

import numpy as np
import pytest
import torch

from tpu_splat_torch.ops.cuda.blend import (F_CA, F_CB, F_CC, F_MX, F_MY, F_OP, NFEAT,
                                            SUB_H, SUB_W, _chunk_alphas, cull_boxes, cull_keep)

from chip_smoke import random_segments

MIN_ALPHA_F32 = float(np.float32(1.0 / 255.0))


def _valid_and_keep(feat, px, py):
    """valid and keep [N, P] for instances feat [10, N] and pixel centres px, py [N|1, P]."""
    n = feat.shape[1]
    valid = _chunk_alphas(feat, torch.arange(n), torch.ones(n, dtype=torch.long), 0, 1,
                          px[:, None, :], py[:, None, :])[-1][:, 0, :]
    keep = cull_keep(cull_boxes(feat)[:, :, None], px, py)
    return valid, keep


def _feat(mx, my, ca, cb, cc, op):
    n = len(mx)
    rest = np.random.default_rng(0).uniform(0, 1, (NFEAT - F_OP - 1, n))
    return torch.from_numpy(np.stack([mx, my, ca, cb, cc, op, *rest]).astype(np.float32))


def _conics(rng, n, sigma=(0.3, 20.0), aniso=(1.0, 30.0)):
    """Positive definite conics (inverse covariances) of random size, shape and angle."""
    s1 = rng.uniform(*sigma, n)
    s2 = s1 / rng.uniform(*aniso, n)
    th = rng.uniform(0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    cxx = c * c * s1 ** 2 + s * s * s2 ** 2
    cyy = s * s * s1 ** 2 + c * c * s2 ** 2
    cxy = c * s * (s1 ** 2 - s2 ** 2)
    det = cxx * cyy - cxy ** 2
    return cyy / det, -cxy / det, cxx / det


def _edge_case(rng, n, aniso):
    """Instances whose 1/255 ellipse has one of its four axis-extreme points within a
    relative 1e-3 of a pixel centre on the outer edge of its 8x4 cell (where a box edge
    that falls short of the pixel culls it), and the 5x5 pixels around that centre."""
    ca, cb, cc = (x.astype(np.float32).astype(np.float64) for x in _conics(rng, n, aniso=aniso))
    op = rng.uniform(MIN_ALPHA_F32, 1.0, n).astype(np.float32).astype(np.float64)
    s = np.log(op / MIN_ALPHA_F32)
    det = ca * cc - cb * cb
    rx, ry = np.sqrt(2 * s * cc / det), np.sqrt(2 * s * ca / det)
    side = rng.integers(0, 4, n)  # +x, -x, +y, -y extreme
    sign = np.where(side % 2 == 0, 1.0, -1.0)
    ex = np.where(side < 2, sign * rx, sign * -cb / ca * ry)  # pixel minus mean
    ey = np.where(side < 2, sign * -cb / cc * rx, sign * ry)
    scale = 1.0 + rng.uniform(-1e-3, 1e-3, n) * rng.choice([1.0, 1e-2, 1e-4, 1e-5], n)
    # +x: the cell's first column, -x: its last; +y: its first row, -y: its last
    cx = SUB_W * rng.integers(0, 25, n) + np.where(side == 1, SUB_W - 0.5, 0.5)
    cy = SUB_H * rng.integers(0, 50, n) + np.where(side == 3, SUB_H - 0.5, 0.5)
    off = np.arange(-2, 3, dtype=np.float64)
    px = (cx[:, None] + np.repeat(off, 5)[None, :]).astype(np.float32)
    py = (cy[:, None] + np.tile(off, 5)[None, :]).astype(np.float32)
    feat = _feat(cx - ex * scale, cy - ey * scale, ca, cb, cc, op)
    return feat, torch.from_numpy(px), torch.from_numpy(py)


def test_cull_never_drops_a_valid_pair_of_random_conics():
    rng = np.random.default_rng(0)
    n = 1500
    ca, cb, cc = _conics(rng, n)
    feat = _feat(rng.uniform(-20, 84, n), rng.uniform(-20, 84, n), ca, cb, cc,
                 rng.uniform(0.0, 1.0, n))
    xs = torch.arange(64, dtype=torch.float32) + 0.5
    py, px = (g.reshape(1, -1) for g in torch.meshgrid(xs, xs, indexing="ij"))
    valid, keep = _valid_and_keep(feat, px, py)
    assert int(valid.sum()) > 10_000
    assert not bool((valid & ~keep).any())
    # the cull has teeth: it keeps a few sub-rectangles around each ellipse, not the image
    assert float(keep.float().mean()) < 0.25
    assert int(keep.sum()) < 6 * int(valid.sum())


@pytest.mark.parametrize("aniso", [(1.0, 3.0), (20.0, 200.0)])
def test_cull_never_drops_a_valid_pair_on_the_ellipse_edge(aniso):
    feat, px, py = _edge_case(np.random.default_rng(1), 4000, aniso)
    valid, keep = _valid_and_keep(feat, px, py)
    assert not bool((valid & ~keep).any())
    # both sides of the threshold are exercised: some edge pixels pass, some do not
    centre = valid[:, 12]
    assert 0.2 < float(centre.float().mean()) < 0.8


def test_cull_at_opacity_near_one_over_255():
    """op a few ulps above, at and below float32(1/255): the box shrinks to the margin
    around the mean; it is empty once op is clearly below (by more than the 1e-5 margin
    on ln(255 op))."""
    ulps = np.arange(-4, 12)
    op = np.float32(MIN_ALPHA_F32) * np.concatenate([1.0 + ulps * 2.0 ** -23, [1 - 1e-4, 0.5]])
    n = len(op)
    rng = np.random.default_rng(2)
    ca, cb, cc = _conics(rng, n, sigma=(0.5, 3.0), aniso=(1.0, 4.0))
    cx = rng.integers(8, 40, n) + 0.5
    cy = rng.integers(8, 40, n) + 0.5
    d = np.array([0.0, 1e-3, -1e-3, 0.02, 1.0])
    mx = cx[:, None] + d[None, :]
    feat = _feat(mx.ravel(), np.repeat(cy, len(d)), np.repeat(ca, len(d)), np.repeat(cb, len(d)),
                 np.repeat(cc, len(d)), np.repeat(op, len(d)))
    off = np.arange(-3, 4, dtype=np.float32)
    pxs = np.repeat(cx, len(d))[:, None] + np.repeat(off, 7)[None, :]
    pys = np.repeat(cy, len(d))[:, None] + np.tile(off, 7)[None, :]
    px, py = (torch.from_numpy(a.astype(np.float32)) for a in (pxs, pys))
    valid, keep = _valid_and_keep(feat, px, py)
    assert not bool((valid & ~keep).any())
    assert bool(valid.any())  # the mean's own pixel passes at op >= 1/255
    below = torch.from_numpy(np.repeat(op, len(d)) < np.float32(MIN_ALPHA_F32) * (1 - 2e-5))
    assert int(below.sum()) == 2 * len(d) and not bool(keep[below].any())  # empty boxes
    box = cull_boxes(feat)
    half_w = (box[1] - box[0])[~below] / 2
    assert float(half_w.max()) < 0.25  # a tiny level set: the box is about the margin


@pytest.mark.parametrize("eps", [1e-2, 1e-4, 1e-6])
def test_cull_on_nearly_degenerate_conics(eps):
    """cb^2 = (1 - eps) ca cc: long thin splats, pixels along the major axis out to and past
    the tip, where sigma's float rounding grows with the condition number."""
    rng = np.random.default_rng(3)
    n = 600
    ca = rng.uniform(0.05, 2.0, n)
    cc = rng.uniform(0.05, 2.0, n)
    cb = rng.choice([-1.0, 1.0], n) * np.sqrt((1.0 - eps) * ca * cc)
    op = rng.uniform(0.05, 1.0, n)
    feat = _feat(rng.uniform(100, 150, n), rng.uniform(100, 150, n), ca, cb, cc, op)
    f = feat[:6].double()
    det = f[F_CA] * f[F_CC] - f[F_CB] ** 2
    s = torch.log(f[F_OP] / MIN_ALPHA_F32)
    # major axis direction (eigenvector of the small eigenvalue) and the tip's distance
    lmin = det / (0.5 * (f[F_CA] + f[F_CC]) + torch.sqrt(0.25 * (f[F_CA] - f[F_CC]) ** 2
                                                            + f[F_CB] ** 2))
    vx, vy = f[F_CB], lmin - f[F_CA]
    norm = torch.sqrt(vx * vx + vy * vy)
    vx, vy = vx / norm, vy / norm
    tip = torch.sqrt(2 * s / lmin).clamp_max(1e4)
    t = torch.linspace(0.0, 1.05, 64, dtype=torch.float64)[None, :] * tip[:, None]
    px = torch.floor(f[F_MX][:, None] + t * vx[:, None]) + 0.5
    py = torch.floor(f[F_MY][:, None] + t * vy[:, None]) + 0.5
    valid, keep = _valid_and_keep(feat, px.float(), py.float())
    assert int(valid.sum()) > 1000
    assert not bool((valid & ~keep).any())


def test_cull_keeps_everything_for_non_definite_and_non_finite_instances():
    nan, inf = math.nan, math.inf
    rows = [  # mx, my, ca, cb, cc, op
        (10.0, 10.0, 0.5, 0.6, 0.5, 0.9),     # cb^2 > ca cc
        (10.0, 10.0, 0.5, 0.5, 0.5, 0.9),     # det = 0
        (10.0, 10.0, -0.5, 0.0, 0.5, 0.9),    # ca < 0
        (10.0, 10.0, 0.5, 0.0, -0.5, 0.9),    # cc < 0
        (10.0, 10.0, 0.0, 0.0, 0.0, 0.9),     # zero conic: sigma = 0 everywhere
        (nan, 10.0, 0.5, 0.0, 0.5, 0.9),
        (10.0, inf, 0.5, 0.0, 0.5, 0.9),
        (10.0, 10.0, nan, 0.0, 0.5, 0.9),
        (10.0, 10.0, 0.5, inf, 0.5, 0.9),
        (10.0, 10.0, 0.5, 0.0, 0.5, nan),
        (10.0, 10.0, 0.5, 0.0, 0.5, inf),
        (10.0, 10.0, 1e-30, 0.0, 1e-30, 0.9),  # huge but definite: covers everything
    ]
    feat = _feat(*np.asarray(rows, np.float64).T)
    xs = torch.arange(0, 512, 3, dtype=torch.float32) + 0.5
    py, px = (g.reshape(1, -1) for g in torch.meshgrid(xs, xs, indexing="ij"))
    valid, keep = _valid_and_keep(feat, px, py)
    assert not bool((valid & ~keep).any())
    assert bool(keep.all())
    assert bool(valid[[0, 2, 3, 4, 11]].any(1).all())  # these do pass somewhere
    # and the empty box: op below 1/255 (or zero, or negative) culls every pixel
    low = _feat(*np.asarray([(10.0, 10.0, 0.5, 0.0, 0.5, op) for op in
                             (MIN_ALPHA_F32 * (1 - 1e-4), 0.0, -0.5)]).T)
    valid, keep = _valid_and_keep(low, px, py)
    assert not bool(valid.any()) and not bool(keep[:2].any()) and bool(keep[2].all())


@pytest.mark.parametrize("tile_size,chunk", [(16, 128), (32, 256)])
def test_cull_keeps_every_used_pair_of_random_segments(tile_size, chunk):
    """chip_smoke.py's random blend inputs, pair by pair over every chunk of every tile
    (the sub-rectangles are the cells of the image's 8x4 grid)."""
    (flat, seg_start, count), kw = random_segments(tile_size, chunk, 5, "cpu")
    t = torch.arange(kw["n_tiles"])[:, None]
    idx = torch.arange(tile_size * tile_size)[None, :]
    px = ((t % kw["grid_w"]) * tile_size + idx % tile_size).float() + 0.5
    py = ((t // kw["grid_w"]) * tile_size + idx // tile_size).float() + 0.5
    # the 8x4 cells tile each tile: a warp's sub-rectangle never straddles two tiles
    assert tile_size % SUB_W == 0 and tile_size % SUB_H == 0
    n_valid = n_kept = n_pairs = 0
    cnt = count.long()
    for j in range(kw["max_chunks"]):
        f, _, lane_valid, _, _, _, _, valid = _chunk_alphas(
            flat, seg_start.long(), cnt, j, chunk, px[:, None, :], py[:, None, :])
        box = cull_boxes(f)  # [4, T, C]
        keep = cull_keep(box[..., None], px[:, None, :], py[:, None, :]) & lane_valid[..., None]
        assert not bool((valid & ~keep).any())
        n_valid += int(valid.sum())
        n_kept += int(keep.sum())
        n_pairs += int(lane_valid.sum()) * tile_size * tile_size
    assert n_valid > 0 and n_kept < 0.75 * n_pairs
