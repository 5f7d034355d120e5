"""GUT world-space ray blend: forward (kernel K5) and replay backward (kernel K6).

Counterpart of `tpu_splat/ops/pallas/gut_kernels.py::gut_blend_forward` /
`gut_blend_backward` / `gut_blend_tiles_pallas`. Per tile, the depth-sorted instance
segment [seg_start, seg_start + count) of a feature-major instance table `flat` [17, M] is
composited per pixel in chunks of `chunk` instances. Per (pixel, instance), with the
pixel's world ray direction d (and, for rays 8 wide, its origin offset do):

  v = M d ; n = v / sqrt(max(|v|^2, 1e-24)) ; g = gro (+ M do) ; c = n x g
  alpha = min(opacity * exp(-0.5 |c|^2), 0.999)      ; skip if alpha < 1/255
  T_next = T * (1 - alpha)                           ; STOP (excluding this one) if < 1e-4
  rgb/depth += T * alpha * feature ; T = T_next

Feature rows (G_*): M = S^-1 R^T row-major 0-8, gro = M (ray_o - mean) 9-11, opacity 12,
rgb 13-15, depth 16. Rays [T, P, 4] hold (dx, dy, dz, 0); rays [T, P, 8] add the per-pixel
origin offset (dox, doy, doz, 0) of a rolling shutter or an orthographic camera.

`gut_blend_forward` returns out [T, P, 8] = (rgb, T_final, depth, 0, 0, 0) and
chk [T, P, max_chunks], each chunk's entry transmittance (0 once the pixel has stopped and
for chunks never visited); `gut_blend_backward` replays from them and returns the
per-instance gradient rows gflat [17, M] (float32; columns owned by no tile are 0).

The normalisation is written from correctly rounded operations, 1 / sqrt(max(vv, 1e-24))
(`torch.reciprocal(torch.sqrt(.))` here, `__fdiv_rn(1, __fsqrt_rn(.))` in the kernels): a
hardware rsqrt is not correctly rounded, and a stop decision that differs by an ulp flips
a pixel's whole remaining blend.

The wrappers launch `csrc/gut_fwd.cu` / `csrc/gut_bwd.cu` on a CUDA tensor and run the
plain versions (`*_plain`) on a CPU tensor. The plain versions are vectorised over batches
of tiles and keep no autograd graph. `GutBlendTiles` is the differentiable blend.

Both kernels cull: a warp evaluates an instance only on those of its 8x4-pixel
sub-rectangles whose ray cone the instance's widened 1/255 sphere may meet
(`csrc/gut_common.cuh`). `gut_cull_spheres`, `gut_cull_cones` and `gut_cull_keep` are the
plain twins of that sphere, cone and test; the wrappers do not call them (the cull changes
no output), tests and chip_smoke.py do.
"""

from __future__ import annotations

import math

import torch

from ..projection import MAX_FRAGMENT_ALPHA, MIN_ALPHA, TRANSMITTANCE_THRESHOLD
from .blend import (CHUNKS, SUB_H, SUB_W, TILE_SIZES, _check_backward_args, _tile_batches,
                    _to_f32, composite_chunk, feature_dot, weight_grads, weighted_features)
from .build import check, count_launch, kernel, require_cuda

(G_M00, G_M01, G_M02, G_M10, G_M11, G_M12, G_M20, G_M21, G_M22,
 G_GX, G_GY, G_GZ, G_OP, G_R, G_G, G_B, G_D) = range(17)
NFEAT_GUT = 17
MAX_CHUNKS_GUT = 128  # cap of the per-tile chunk count (gut_kernels.py:478)
VV_MIN = 1e-24
# elements of one [tiles, chunk, P] temporary of the plain versions (64 MB of float32;
# the backward keeps some forty of them alive)
_PLAIN_BATCH_ELEMS = 1 << 24


def _check_gut_args(flat, rays, seg_start, tile_count, n_tiles, tile_size, max_chunks, chunk):
    if flat.dim() != 2 or flat.shape[0] != NFEAT_GUT or flat.dtype != torch.float32:
        raise ValueError(f"flat must be float32 [{NFEAT_GUT}, M], got {flat.dtype} "
                         f"{tuple(flat.shape)}")
    p = tile_size * tile_size
    if (rays.dim() != 3 or rays.shape[:2] != (n_tiles, p) or rays.shape[2] not in (4, 8)
            or rays.dtype != torch.float32):
        raise ValueError(f"rays must be float32 [{n_tiles}, {p}, 4 or 8], got {rays.dtype} "
                         f"{tuple(rays.shape)}")
    for name, x in (("seg_start", seg_start), ("tile_count", tile_count)):
        if x.shape != (n_tiles,) or x.dtype != torch.int32:
            raise ValueError(f"{name} must be int32 [{n_tiles}], got {x.dtype} "
                             f"{tuple(x.shape)}")
    if tile_size not in TILE_SIZES:
        raise ValueError(f"tile_size must be one of {TILE_SIZES}, got {tile_size}")
    if chunk not in CHUNKS:
        raise ValueError(f"chunk must be one of {CHUNKS}, got {chunk}")
    if max_chunks < 1:
        raise ValueError("max_chunks must be >= 1")


def ray_columns(rays):
    """rays [T, P, 4|8] -> (d, do): three [T, 1, P] direction components and, for rays 8
    wide, three origin-offset components (else None)."""
    d = tuple(rays[:, None, :, i] for i in range(3))
    do = tuple(rays[:, None, :, i] for i in range(4, 7)) if rays.shape[2] == 8 else None
    return d, do


def ray_response(feat, d, do, seg_start, count, j, chunk):
    """One chunk of a batch of tiles. Gathered features f [17, T, C], the instance columns
    idx [T, C], lane_valid [T, C], and per (tile, instance, pixel) [T, C, P]: the alphas
    with invalid entries zeroed (a), the validity mask, and the residuals of the chain
    rule (n, inorm, g, c, e, alpha_raw)."""
    local = j * chunk + torch.arange(chunk, device=feat.device)
    lane_valid = local[None, :] < count[:, None]  # [T, C]
    idx = torch.where(lane_valid, seg_start[:, None] + local[None, :], 0)
    f = feat[:, idx]  # [17, T, C]
    m = [f[i][:, :, None] for i in range(G_GX)]  # nine [T, C, 1]
    dx, dy, dz = d
    v = [m[3 * i] * dx + m[3 * i + 1] * dy + m[3 * i + 2] * dz for i in range(3)]
    vv = v[0] * v[0] + v[1] * v[1] + v[2] * v[2]
    inorm = torch.reciprocal(torch.sqrt(torch.clamp_min(vv, VV_MIN)))
    n = [vi * inorm for vi in v]
    g = [f[G_GX + i][:, :, None] for i in range(3)]
    if do is not None:
        dox, doy, doz = do
        g = [g[i] + m[3 * i] * dox + m[3 * i + 1] * doy + m[3 * i + 2] * doz
             for i in range(3)]
    c = [n[1] * g[2] - n[2] * g[1], n[2] * g[0] - n[0] * g[2], n[0] * g[1] - n[1] * g[0]]
    power = -0.5 * (c[0] * c[0] + c[1] * c[1] + c[2] * c[2])
    e = torch.exp(power)
    alpha_raw = f[G_OP][:, :, None] * e
    alpha = torch.clamp_max(alpha_raw, MAX_FRAGMENT_ALPHA)
    valid = lane_valid[:, :, None] & (alpha >= MIN_ALPHA)
    a = torch.where(valid, alpha, 0.0)
    return f, idx, lane_valid, a, valid, dict(n=n, inorm=inorm, g=g, c=c, e=e,
                                              alpha_raw=alpha_raw)


# margins of the kernels' cull (csrc/gut_common.cuh, which states their reasons)
CULL_ABS, CULL_KAPPA, CULL_REL, CULL_COND_MAX = 1e-5, 34.0, 1e-3, 1e5
CULL_DIR_MIN, CULL_DIR_MAX, CULL_V_MIN, CULL_V_MAX = 1e-3, 1e3, 1e-11, 1e18
CULL_EPS = 1e-5
_U = 2.0 ** -24
(C_BX, C_BY, C_BZ, C_COS, C_SIN, C_OX, C_OY, C_OZ, C_RHO) = range(9)  # cone rows


@torch.no_grad()
def gut_cull_spheres(flat: torch.Tensor, do_max=0.0) -> torch.Tensor:
    """Plain twin of the kernels' cull sphere (`gut_common.cuh::cull_sphere`): from the
    float32 rows M, gro, opacity [>=13, ...] and the largest |do| of the tile's rays
    (`do_max`, broadcastable to flat.shape[1:]; 0 for rays 4 wide) the sphere [4, ...] =
    (centre m, radius R) that holds every point of a ray the kernel can accept the instance
    on, widened by the kernels' margins. R = -inf where op < 1/255 (no pair passes);
    m = 0, R = +inf (every pair kept) for any NaN / Inf, a (nearly) singular M, or an M
    whose |v| could reach the 1e-12 clamp or overflow."""
    f = flat[:G_OP + 1]
    finite = torch.isfinite(f).all(0)
    f = torch.where(finite, f, 0.0).double()
    m = [f[i] for i in range(9)]
    gro = f[G_GX:G_GZ + 1]
    s = torch.log(f[G_OP] / float(torch.tensor(MIN_ALPHA, dtype=torch.float32))) + CULL_ABS
    empty = finite & ~(s >= 0)
    adj = [m[4] * m[8] - m[5] * m[7], m[2] * m[7] - m[1] * m[8], m[1] * m[5] - m[2] * m[4],
           m[5] * m[6] - m[3] * m[8], m[0] * m[8] - m[2] * m[6], m[2] * m[3] - m[0] * m[5],
           m[3] * m[7] - m[4] * m[6], m[1] * m[6] - m[0] * m[7], m[0] * m[4] - m[1] * m[3]]
    det = m[0] * adj[0] + m[1] * adj[3] + m[2] * adj[6]
    inv = [a / det for a in adj]
    row = lambda i, k: inv[3 * i] * inv[3 * k] + inv[3 * i + 1] * inv[3 * k + 1] \
        + inv[3 * i + 2] * inv[3 * k + 2]
    a00, a11, a22, a01, a02, a12 = row(0, 0), row(1, 1), row(2, 2), row(0, 1), row(0, 2), row(1, 2)
    # largest eigenvalue of M^-1 M^-T, closed form, rounded up
    q = (a00 + a11 + a22) / 3.0
    b0, b1, b2 = a00 - q, a11 - q, a22 - q
    p = torch.sqrt((b0 * b0 + b1 * b1 + b2 * b2 + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12))
                   / 6.0)
    r = 0.5 * (b0 * (b1 * b2 - a12 * a12) - a01 * (a01 * b2 - a12 * a02)
               + a02 * (a01 * a12 - b1 * a02)) / (p * p * p)
    phi = torch.acos(torch.clamp(r, -1.0, 1.0)) / 3.0
    lam = torch.where(p > 0, q + 2.0 * p * torch.clamp_max(torch.cos(phi) + 1e-6, 1.0), q)
    sig = torch.sqrt(lam) * (1.0 + 1e-12)  # sigma_max(M^-1)
    nf = torch.sqrt(sum(x * x for x in m))  # ||M||_F
    bounded = ((det != 0) & (nf * sig <= CULL_COND_MAX) & (CULL_DIR_MIN / sig >= 2 * CULL_V_MIN)
               & (nf * CULL_DIR_MAX <= CULL_V_MAX))
    c = [-(inv[3 * i] * gro[0] + inv[3 * i + 1] * gro[1] + inv[3 * i + 2] * gro[2])
         for i in range(3)]
    cn = torch.sqrt(c[0] * c[0] + c[1] * c[1] + c[2] * c[2])
    rad = (sig * (torch.sqrt(2.0 * s) + CULL_KAPPA * _U * nf * (cn + do_max)) * (1.0 + CULL_REL)
           + 4.0 * _U * cn)
    sph = torch.stack([*(x.float() for x in c), _to_f32(rad, math.inf)])
    keep_all, cull_all = (sph.new_tensor([0.0, 0.0, 0.0, rad]).view(4, *[1] * s.dim())
                          for rad in (math.inf, -math.inf))
    return torch.where(empty, cull_all, torch.where(finite & bounded, sph, keep_all))


def gut_cull_cells(tile_size: int, dev=None) -> torch.Tensor:
    """The kernels' 8x4 sub-rectangles of a tile: [S, 32] row-major pixel indices, lane l
    of cell s at (8 (s % (tile / 8)) + l % 8, 4 (s // (tile / 8)) + l // 8)."""
    cw = tile_size // SUB_W
    s = torch.arange(cw * (tile_size // SUB_H), device=dev)[:, None]
    lane = torch.arange(SUB_W * SUB_H, device=dev)[None, :]
    return (4 * (s // cw) + lane // SUB_W) * tile_size + SUB_W * (s % cw) + lane % SUB_W


@torch.no_grad()
def gut_cull_cones(rays: torch.Tensor, tile_size: int):
    """Plain twin of the kernels' ray cones (`gut_common.cuh::warp_cone`): rays
    [T, P, 4|8] -> (cones [T, S, 9] float32 with rows C_* (axis, cos and sin of the
    half-angle rounded to widen, mean origin offset, its radius rho) for the S sub-rectangles
    of `gut_cull_cells`, do_max [T] the largest |do| of each tile's rays). A cell with a ray
    that is not finite or whose length is outside [1e-3, 1e3], or a cone of 90 degrees or
    more, gets the cone that covers everything (axis 0, cos 1, sin 0, offset 0, rho 0)."""
    cells = gut_cull_cells(tile_size, rays.device)
    r = rays[:, cells]  # [T, S, 32, W]
    d = r[..., :3].double()
    length = torch.linalg.vector_norm(d, dim=-1)
    bad = ~((length >= CULL_DIR_MIN) & (length <= CULL_DIR_MAX))
    origin = rays.shape[2] == 8
    if origin:
        bad |= ~torch.isfinite(r[..., 4:7]).all(-1)
    u = torch.where(bad[..., None], 0.0, d / length[..., None])
    ssum = u.sum(-2)  # [T, S, 3]
    sl = torch.linalg.vector_norm(ssum, dim=-1)
    b = (ssum / sl[..., None]).float()
    bd = b.double()[..., None, :]
    th = torch.atan2(torch.linalg.vector_norm(torch.cross(u, bd.expand_as(u), dim=-1), dim=-1),
                     (u * bd).sum(-1))
    phi = torch.where(bad, math.inf, th).amax(-1) + 1e-9
    everything = ~(phi < 0.5 * math.pi) | ~(sl > 0)
    cols = [b[..., 0], b[..., 1], b[..., 2], _to_f32(torch.cos(phi), -math.inf),
            torch.clamp_max(_to_f32(torch.sin(phi), math.inf), 1.0)]
    zero = torch.zeros_like(sl, dtype=torch.float32)
    if origin:
        o = torch.where(bad[..., None], 0.0, r[..., 4:7].double())
        delta = (o.sum(-2) / 32.0).float()
        rho = torch.linalg.vector_norm(o - delta.double()[..., None, :], dim=-1)
        rho = _to_f32(torch.where(bad, 0.0, rho).amax(-1), math.inf)
        do_max = _to_f32(torch.linalg.vector_norm(o, dim=-1).amax(-1), math.inf).amax(-1)
        cols += [delta[..., 0], delta[..., 1], delta[..., 2], rho]
    else:
        do_max = torch.zeros(rays.shape[0], dtype=torch.float32, device=rays.device)
        cols += [zero, zero, zero, zero]
    cones = torch.stack(cols, dim=-1)
    cover = cones.new_tensor([0, 0, 0, 1, 0, 0, 0, 0, 0])
    return torch.where(everything[..., None], cover, cones), do_max


def gut_cull_keep(sph: torch.Tensor, cones: torch.Tensor, tile_size: int) -> torch.Tensor:
    """Plain twin of the kernels' cull test (`gut_common.cuh::cone_mask`), in float32 in the
    kernels' operation order: sph [4, T, C] (each tile's instances' spheres), cones
    [T, S, 9] -> keep [T, C, P], True where the pair of instance c and pixel p survives,
    i.e. the sphere may meet the cone of the pixel's sub-rectangle. Culls only what is
    clearly outside: a NaN keeps the pair."""
    m = sph[:3, :, :, None]  # [3, T, C, 1]
    cn = cones[:, None, :, :]  # [T, 1, S, 9]
    ax, ay, az = (m[i] - cn[..., C_OX + i] for i in range(3))
    bx, by, bz = cn[..., C_BX], cn[..., C_BY], cn[..., C_BZ]
    h = torch.abs(ax * bx + ay * by + az * bz)
    ex, ey, ez = ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx
    r = torch.sqrt(ex * ex + ey * ey + ez * ez)
    mn = torch.sqrt(ax * ax + ay * ay + az * az)
    out = r * cn[..., C_COS] - h * cn[..., C_SIN] > sph[3, :, :, None] + cn[..., C_RHO] \
        + torch.tensor(CULL_EPS, dtype=torch.float32) * mn  # [T, C, S]
    cell_of = torch.argsort(gut_cull_cells(tile_size, sph.device).reshape(-1)) // (SUB_W * SUB_H)
    return ~out[:, :, cell_of]


@torch.no_grad()
def gut_blend_forward_plain(flat, rays, seg_start, tile_count, *, n_tiles: int,
                            tile_size: int, max_chunks: int, chunk: int = 128):
    """Plain version of K5, vectorised over batches of tiles: one [T, chunk, P]
    closed-form step per chunk (cumprod along the instance axis)."""
    _check_gut_args(flat, rays, seg_start, tile_count, n_tiles, tile_size, max_chunks, chunk)
    dev = flat.device
    p = tile_size * tile_size
    outs, chks = [], []
    for t0, t1 in _tile_batches(n_tiles, tile_size, chunk, _PLAIN_BATCH_ELEMS):
        nt = t1 - t0
        start = seg_start[t0:t1].long()
        count = tile_count[t0:t1].clamp(0, max_chunks * chunk).long()
        nch = (count + chunk - 1) // chunk
        d, do = ray_columns(rays[t0:t1])

        chk = torch.zeros((nt, p, max_chunks), dtype=torch.float32, device=dev)
        t_run = torch.ones((nt, p), dtype=torch.float32, device=dev)
        dead = torch.zeros((nt, p), dtype=torch.bool, device=dev)
        acc = torch.zeros((nt, p, 4), dtype=torch.float32, device=dev)
        for j in range(int(nch.max()) if nt else 0):
            chk[:, :, j] = torch.where(dead | (j >= nch)[:, None], 0.0, t_run)
            f, _, _, a, valid, _ = ray_response(flat, d, do, start, count, j, chunk)
            w, t_run, dead = composite_chunk(a, valid, t_run, dead)
            feat4 = f[G_R:G_D + 1].permute(1, 2, 0)  # [T, C, 4]
            acc = acc + weighted_features(w, feat4)

        zeros = torch.zeros((nt, p, 3), dtype=torch.float32, device=dev)
        outs.append(torch.cat([acc[:, :, :3], t_run[:, :, None], acc[:, :, 3:], zeros], dim=2))
        chks.append(chk)
    if not outs:
        return (torch.zeros((0, p, 8), dtype=torch.float32, device=dev),
                torch.zeros((0, p, max_chunks), dtype=torch.float32, device=dev))
    return torch.cat(outs), torch.cat(chks)


def gut_blend_forward(flat, rays, seg_start, tile_count, *, n_tiles: int, tile_size: int,
                      max_chunks: int, chunk: int = 128):
    """K5. CPU tensors run the plain version; CUDA tensors launch `csrc/gut_fwd.cu` (one
    256-thread block per tile) or raise.

    -> (out [T, P, 8], chk [T, P, max_chunks]), both float32."""
    if flat.device.type == "cpu":
        return gut_blend_forward_plain(flat, rays, seg_start, tile_count, n_tiles=n_tiles,
                                       tile_size=tile_size, max_chunks=max_chunks,
                                       chunk=chunk)
    _check_gut_args(flat, rays, seg_start, tile_count, n_tiles, tile_size, max_chunks, chunk)
    require_cuda(flat, flat=flat, rays=rays, seg_start=seg_start, tile_count=tile_count)
    p = tile_size * tile_size
    out = torch.empty((n_tiles, p, 8), dtype=torch.float32, device=flat.device)
    chk = torch.empty((n_tiles, p, max_chunks), dtype=torch.float32, device=flat.device)
    err = kernel("gut_fwd")(
        flat.data_ptr(), flat.stride(0), rays.data_ptr(), rays.shape[2],
        seg_start.data_ptr(), tile_count.data_ptr(), n_tiles, tile_size, chunk, max_chunks,
        out.data_ptr(), chk.data_ptr(),
        torch.cuda.current_stream(flat.device).cuda_stream,
    )
    check(err, "gut_fwd")
    count_launch(gut_blend_forward)
    return out, chk


gut_blend_forward.launches = 0


def _cross(a, b):
    return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0]]


@torch.no_grad()
def gut_blend_backward_plain(flat, rays, seg_start, tile_count, chk, out, gout, *,
                             n_tiles: int, tile_size: int, max_chunks: int,
                             chunk: int = 128):
    """Plain version of K6: an explicit replay from the checkpoints, chunk by chunk from
    the last to the first, vectorised over batches of tiles — the arithmetic of
    `tpu_splat/ops/pallas/gut_kernels.py::_gut_bwd_kernel` with exact products:

      use      = valid & (T_entry cp_incl >= 1e-4)         (T_entry = chk; 0 = never ran)
      w        = use a T_excl
      dL/da    = use (T_excl (g.col) - suffix / (1 - a)),  suffix seeded by T_final gout[3]
      dL/dpow  = dL/da alpha_raw where alpha_raw < 0.999 ;  dL/dc = -dL/dpow c
      dL/dn    = g x dL/dc ;  dL/dg = dL/dc x n ;  dL/dv = inorm (dL/dn - n (n . dL/dn))
      dL/dM_ij = sum_p dL/dv_i d_j (+ dL/dg_i do_j) ;  dL/dgro = sum_p dL/dg

    -> gflat [17, M] float32; columns owned by no tile are zero."""
    _check_gut_args(flat, rays, seg_start, tile_count, n_tiles, tile_size, max_chunks, chunk)
    _check_backward_args(chk, out, gout, n_tiles, tile_size, max_chunks)
    dev = flat.device
    gflat = torch.zeros((NFEAT_GUT, flat.shape[1]), dtype=torch.float32, device=dev)
    for t0, t1 in _tile_batches(n_tiles, tile_size, chunk, _PLAIN_BATCH_ELEMS):
        start = seg_start[t0:t1].long()
        count = tile_count[t0:t1].clamp(0, max_chunks * chunk).long()
        d, do = ray_columns(rays[t0:t1])
        g4 = gout[t0:t1][:, :, [0, 1, 2, 4]]  # [T, P, 4]: d/d(r, g, b, depth)
        carry = out[t0:t1, :, 3] * gout[t0:t1, :, 3]  # [T, P]: T_final * d/dT_final
        live = chk[t0:t1].amax(dim=(0, 1)) > 0  # [max_chunks]
        n_iter = int(live.nonzero().max()) + 1 if bool(live.any()) else 0
        for j in reversed(range(n_iter)):
            t_in = chk[t0:t1, :, j][:, None, :]  # [T, 1, P]
            f, idx, lane_valid, a, valid, rs = ray_response(flat, d, do, start, count, j,
                                                             chunk)
            one_m = 1.0 - a
            cp_incl = torch.cumprod(one_m, dim=1)
            use = valid & ~(t_in * cp_incl < TRANSMITTANCE_THRESHOLD) & (t_in > 0)
            t_excl = t_in * (cp_incl / one_m)
            w = torch.where(use, a * t_excl, 0.0)  # [T, C, P]
            feat4 = f[G_R:G_D + 1].permute(1, 2, 0)  # [T, C, 4]
            cdotg = feature_dot(feat4, g4)
            u = w * cdotg
            # strictly-later instances of this chunk, plus everything in later chunks
            later = torch.flip(torch.cumsum(torch.flip(u, (1,)), dim=1), (1,)) - u
            suffix = later + carry[:, None, :]
            dl_da = torch.where(use, t_excl * cdotg - suffix / one_m, 0.0)
            not_clamped = rs["alpha_raw"] < MAX_FRAGMENT_ALPHA
            dl_dpow = torch.where(not_clamped, dl_da * rs["alpha_raw"], 0.0)
            g_op = torch.where(not_clamped, dl_da * rs["e"], 0.0).sum(2)

            n, gv = rs["n"], rs["g"]
            dc = [-dl_dpow * ci for ci in rs["c"]]
            dn = _cross(gv, dc)
            dg = _cross(dc, n)
            ndn = n[0] * dn[0] + n[1] * dn[1] + n[2] * dn[2]
            dv = [rs["inorm"] * (dn[i] - n[i] * ndn) for i in range(3)]
            if do is None:
                m_terms = [dv[i] * d[k] for i in range(3) for k in range(3)]
            else:
                m_terms = [dv[i] * d[k] + dg[i] * do[k] for i in range(3) for k in range(3)]
            grads = torch.stack([
                *(x.sum(2) for x in m_terms),
                *(x.sum(2) for x in dg),
                g_op,
                *weight_grads(w, g4),
            ])  # [17, T, C]
            gflat[:, idx[lane_valid]] = grads[:, lane_valid]
            carry = carry + u.sum(1)
    return gflat


def gut_blend_backward(flat, rays, seg_start, tile_count, chk, out, gout, *, n_tiles: int,
                       tile_size: int, max_chunks: int, chunk: int = 128):
    """K6. CPU tensors run the plain version; CUDA tensors launch `csrc/gut_bwd.cu` (one
    256-thread block per tile) or raise. `flat`, `rays`, the segments, `chk` and `out` are
    the forward's; `gout` [T, P, 8] holds d/d(rgb) in 0-2, d/dT_final in 3, d/d(depth)
    in 4.

    -> gflat [17, M] float32: per-instance gradients of the seventeen G_* features in
    tile-sorted order; columns owned by no tile are zero."""
    kw = dict(n_tiles=n_tiles, tile_size=tile_size, max_chunks=max_chunks, chunk=chunk)
    if flat.device.type == "cpu":
        return gut_blend_backward_plain(flat, rays, seg_start, tile_count, chk, out, gout,
                                        **kw)
    _check_gut_args(flat, rays, seg_start, tile_count, **kw)
    _check_backward_args(chk, out, gout, n_tiles, tile_size, max_chunks)
    require_cuda(flat, flat=flat, rays=rays, seg_start=seg_start, tile_count=tile_count,
                 chk=chk, out=out, gout=gout)
    gflat = torch.zeros((NFEAT_GUT, flat.shape[1]), dtype=torch.float32, device=flat.device)
    err = kernel("gut_bwd")(
        flat.data_ptr(), flat.stride(0), rays.data_ptr(), rays.shape[2],
        seg_start.data_ptr(), tile_count.data_ptr(), n_tiles, tile_size, chunk, max_chunks,
        chk.data_ptr(), out.data_ptr(), gout.data_ptr(), gflat.data_ptr(), gflat.stride(0),
        torch.cuda.current_stream(flat.device).cuda_stream,
    )
    check(err, "gut_bwd")
    count_launch(gut_blend_backward)
    return gflat


gut_blend_backward.launches = 0


def gut_blend_inputs(inst, gtab, *, k_max: int, chunk: int):
    """K5's inputs from the sorted instances and the per-Gaussian G_* table `gtab`
    [17, N]: one gather of the per-Gaussian columns into tile-sorted order (segments are
    read unaligned, nothing is padded), the per-tile segments with counts capped at the
    list capacity, and max_chunks. -> (flat [17, M], seg_start [T], count [T], max_chunks)"""
    max_chunks = min(-(-k_max // chunk), MAX_CHUNKS_GUT)
    flat = gtab.index_select(1, inst.sorted_gid)
    return flat, inst.tile_start, torch.clamp_max(inst.tile_count, max_chunks * chunk), max_chunks


class GutBlendTiles(torch.autograd.Function):
    """Feature gather + K5 forward; K6 -> `segmented_grad_reduce` (K4 or K7) backward.

    forward(gtab [17, N], rays [T, P, 4|8], inst, dims) -> out [T, P, 8]
    (rgb, T_final, depth, 0, 0, 0). The only differentiable input is `gtab`; rays,
    instances and segments take no gradient."""

    @staticmethod
    def forward(ctx, gtab, rays, inst, dims: dict, impl: str, segred_impl: str):
        flat, seg_start, count, max_chunks = gut_blend_inputs(
            inst, gtab, k_max=dims["k_max"], chunk=dims["chunk"])
        kw = dict(n_tiles=dims["n_tiles"], tile_size=dims["tile_size"],
                  max_chunks=max_chunks, chunk=dims["chunk"])
        fwd = gut_blend_forward if impl == "kernel" else gut_blend_forward_plain
        out, chk = fwd(flat, rays, seg_start, count, **kw)
        ctx.save_for_backward(flat, rays, seg_start, count, chk, out)
        ctx.inst, ctx.kw, ctx.impl, ctx.segred_impl = inst, kw, impl, segred_impl
        return out

    @staticmethod
    def backward(ctx, gout):
        from .raster import segmented_grad_reduce

        kernels = ctx.impl == "kernel"
        bwd = gut_blend_backward if kernels else gut_blend_backward_plain
        gflat = bwd(*ctx.saved_tensors, gout.contiguous(), **ctx.kw)
        g_gtab = segmented_grad_reduce(gflat, ctx.inst, ctx.segred_impl, kernels=kernels)
        return g_gtab, None, None, None, None, None
