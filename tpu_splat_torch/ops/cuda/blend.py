"""Per-tile front-to-back blend: forward (kernel K2) and replay backward (kernel K3).

Counterpart of `tpu_splat/ops/pallas/blend.py::blend_forward` / `blend_backward`. Per
tile, the depth-sorted instance segment [seg_start, seg_start + count) of a feature-major
instance table is composited per pixel in chunks of `chunk` instances:

  sigma = 0.5*(A dx^2 + C dy^2) + B dx dy          ; skip if sigma < 0
  alpha = min(opacity * exp(-sigma), 0.999)        ; skip if alpha < 1/255
  T_next = T * (1 - alpha)                         ; STOP (excluding this one) if T_next < 1e-4
  rgb/depth += T * alpha * feature ; T = T_next

The table comes in two layouts, told apart by its dtype:
  float32  [>=10, M]: the F_* rows (mx, my, ca, cb, cc, op, r, g, b, depth);
  bfloat16 [>=15, M]: the B_* rows — mean and conic as hi/lo pairs that add back to
    ~float32, opacity/colour/depth as single bf16. `unpack_features` rebuilds the ten
    float32 rows; the forward AND the backward then run the same float32 arithmetic on
    those rounded values, so training differentiates a slightly perturbed rasterizer
    exactly.

Tile t covers tile column t % grid_w and tile row t // grid_w + tile_y0 of the image:
a window of tile rows (the multi-device render, `parallel/raster_mc.py`) blends at its
global pixel centres with `tile_y0` its first row (0: the whole image).

`blend_forward` returns out [T, P, 8] = (rgb, T_final, depth, 0, 0, 0) and
chk [T, P, max_chunks], each chunk's entry transmittance (0 once the pixel has stopped,
and for chunks never visited): the replay checkpoints of `blend_backward`, which returns
the per-instance gradient rows gflat [10, M] (float32; columns owned by no tile are 0).

The wrappers launch `csrc/blend_fwd.cu` / `csrc/blend_bwd.cu` on a CUDA tensor and run the
plain versions (`*_plain`) on a CPU tensor. The plain versions are the chunked closed
form of `tpu_splat/ops/blend.py` (cumprod of 1 - alpha within each chunk) vectorised over
batches of tiles; they keep no autograd graph.

Both kernels cull: a warp evaluates an instance only on those of its 8x4-pixel
sub-rectangles that the instance's widened 1/255 box meets (`csrc/blend_common.cuh`).
`cull_boxes` and `cull_keep` are the plain twins of that box and test; the wrappers do not
call them (the cull changes no output), tests and chip_smoke.py do.
"""

from __future__ import annotations

import math

import torch

from ..projection import MAX_FRAGMENT_ALPHA, MIN_ALPHA, TRANSMITTANCE_THRESHOLD
from .build import check, count_launch, kernel, require_cuda

# feature rows of the flat instance table (f32 layout of the JAX package's F_* rows)
F_MX, F_MY, F_CA, F_CB, F_CC, F_OP, F_R, F_G, F_B, F_D = range(10)
NFEAT = 10
# bf16 layout (the JAX package's B_* rows), padded to 16 rows
(B_MXH, B_MXL, B_MYH, B_MYL, B_CAH, B_CAL, B_CBH, B_CBL, B_CCH, B_CCL,
 B_OP, B_R, B_G, B_B, B_D) = range(15)
NFEAT_BF16 = 16
TILE_SIZES = (16, 32)
CHUNKS = (128, 256)
# elements of one [tiles, chunk, P] temporary of the plain versions (256 MB of float32)
_PLAIN_BATCH_ELEMS = 1 << 26


def pack_features_bf16(gtab: torch.Tensor) -> torch.Tensor:
    """F_* table [10, N] float32 -> B_* table [16, N] bfloat16: hi = bf16(x),
    lo = bf16(x - f32(hi)) for mean and conic, single bf16 for the rest, one zero row."""
    hi = gtab[:F_OP].to(torch.bfloat16)
    lo = (gtab[:F_OP] - hi.to(torch.float32)).to(torch.bfloat16)
    pairs = torch.stack([hi, lo], dim=1).reshape(2 * F_OP, -1)
    pad = torch.zeros((NFEAT_BF16 - B_D - 1, gtab.shape[1]), dtype=torch.bfloat16,
                      device=gtab.device)
    return torch.cat([pairs, gtab[F_OP:NFEAT].to(torch.bfloat16), pad])


def unpack_features(flat: torch.Tensor) -> torch.Tensor:
    """The ten float32 feature rows of either layout (the f32 table is returned as is)."""
    if flat.dtype == torch.float32:
        return flat
    f = flat[:B_D + 1].to(torch.float32)
    return torch.cat([f[B_MXH:B_OP:2] + f[B_MXL:B_OP:2], f[B_OP:]])


def _check_blend_args(flat, seg_start, tile_count, n_tiles, tile_size, max_chunks, chunk,
                      tile_y0=0):
    rows = {torch.float32: NFEAT, torch.bfloat16: B_D + 1}.get(flat.dtype)
    if rows is None or flat.dim() != 2 or flat.shape[0] < rows:
        raise ValueError(f"flat must be float32 [>={NFEAT}, M] or bfloat16 [>={B_D + 1}, M], "
                         f"got {flat.dtype} {tuple(flat.shape)}")
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
    if tile_y0 < 0:
        raise ValueError(f"tile_y0 must be >= 0, got {tile_y0}")


def tile_pixel_centers(n_tiles: int, grid_w: int, tile_size: int, dev, first_tile: int = 0):
    """Pixel centres [T, P] (x and y), row-major pixels within each tile."""
    t = torch.arange(first_tile, first_tile + n_tiles, device=dev)[:, None]
    idx = torch.arange(tile_size * tile_size, device=dev)[None, :]
    px = ((t % grid_w) * tile_size + idx % tile_size).to(torch.float32) + 0.5
    py = ((t // grid_w) * tile_size + idx // tile_size).to(torch.float32) + 0.5
    return px, py


def _tile_batches(n_tiles: int, tile_size: int, chunk: int, elems: int = _PLAIN_BATCH_ELEMS):
    """Tile ranges [t0, t1) whose [tiles, chunk, P] temporaries hold at most `elems`."""
    step = max(1, elems // (chunk * tile_size * tile_size))
    return [(t0, min(t0 + step, n_tiles)) for t0 in range(0, n_tiles, step)]


def _chunk_alphas(feat, seg_start, count, j, chunk, px, py):
    """One chunk of a batch of tiles: gathered features f [10, T, C], the instance
    columns idx [T, C], lane_valid [T, C], and per (tile, instance, pixel) [T, C, P]:
    dx, dy, gauss, alpha with invalid entries zeroed (a), and the validity mask."""
    local = j * chunk + torch.arange(chunk, device=feat.device)
    lane_valid = local[None, :] < count[:, None]  # [T, C]
    idx = torch.where(lane_valid, seg_start[:, None] + local[None, :], 0)
    f = feat[:, idx]  # [F, T, C]
    mx, my, ca, cb, cc, op = (f[i][:, :, None] for i in range(F_OP + 1))  # [T, C, 1]
    dx = mx - px  # [T, C, P]
    dy = my - py
    sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
    gauss = torch.exp(-torch.clamp_min(sigma, 0.0))
    alpha = torch.clamp_max(op * gauss, MAX_FRAGMENT_ALPHA)
    valid = lane_valid[:, :, None] & (sigma >= 0.0) & (alpha >= MIN_ALPHA)
    a = torch.where(valid, alpha, 0.0)
    return f, idx, lane_valid, dx, dy, gauss, a, valid


# margins of the kernels' cull box (csrc/blend_common.cuh, which states their reasons)
CULL_ABS, CULL_ULPS, CULL_REL, CULL_PX = 1e-5, 5.0, 1e-3, 1.0 / 64.0
SUB_W, SUB_H = 8, 4  # a warp's sub-rectangle in the kernels: one pixel a lane


def _to_f32(x: torch.Tensor, direction: float) -> torch.Tensor:
    """float64 -> float32 rounded towards `direction` (-inf or +inf)."""
    f = x.to(torch.float32)
    off = f.double() > x if direction < 0 else f.double() < x
    return torch.where(off, torch.nextafter(f, torch.full_like(f, direction)), f)


@torch.no_grad()
def cull_boxes(feat: torch.Tensor) -> torch.Tensor:
    """Plain twin of the kernels' cull box (`blend_common.cuh::cull_box`): from the float32
    rows mx, my, ca, cb, cc, op [>=6, ...] the box [4, ...] = (x lo, x hi, y lo, y hi) of
    the pixel centres an instance can pass the alpha test at, widened by the kernels'
    margins. Empty (lo = +inf, hi = -inf) where op < 1/255; everything (-inf, +inf) for a
    conic that is not positive definite, K too large, or any NaN / Inf."""
    mx, my, ca, cb, cc, op = (feat[i].double() for i in range(F_OP + 1))
    s = torch.log(op / float(torch.tensor(MIN_ALPHA, dtype=torch.float32))) + CULL_ABS
    det = ca * cc - cb * cb  # the products are exact in float64: its sign is right
    lmax = 0.5 * (ca + cc) + torch.sqrt(0.25 * (ca - cc) ** 2 + cb * cb)
    shrink = 1.0 - CULL_ULPS * 2.0 ** -24 * (lmax * lmax / det)
    finite = torch.stack([torch.isfinite(v) for v in (mx, my, ca, cb, cc)]).all(0)
    bounded = (s < 1e300) & finite & (ca > 0) & (cc > 0) & (det > 0) & (shrink >= 0.5)
    level = 2.0 * s / shrink
    rx = torch.sqrt(level * cc / det) * (1.0 + CULL_REL) + CULL_PX
    ry = torch.sqrt(level * ca / det) * (1.0 + CULL_REL) + CULL_PX
    box = torch.stack([_to_f32(mx - rx, -math.inf), _to_f32(mx + rx, math.inf),
                       _to_f32(my - ry, -math.inf), _to_f32(my + ry, math.inf)])
    every = torch.tensor([-math.inf, math.inf] * 2, device=box.device).view(4, *[1] * s.dim())
    box = torch.where(bounded, box, every)
    return torch.where(s < 0, -every, box)  # empty


def cull_keep(box: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Plain twin of the kernels' cull test (`blend_common.cuh::subrect_mask`): True where
    the pair of an instance of box [4, ...] and the pixel centre (px, py) survives, i.e.
    the box meets the pixel's cell of the image's 8x4 grid (the warp sub-rectangle that
    holds it). Culls only what is clearly outside: a NaN bound keeps the pair."""
    x0 = torch.floor(px / SUB_W) * SUB_W + 0.5
    y0 = torch.floor(py / SUB_H) * SUB_H + 0.5
    out = ((box[1] < x0) | (box[0] > x0 + (SUB_W - 1)) | (box[3] < y0)
           | (box[2] > y0 + (SUB_H - 1)))
    return ~out


def composite_chunk(a, valid, t_run, dead):
    """One chunk of front-to-back compositing, closed form along the instance axis.

    a [T, C, P] alphas (0 where invalid), valid [T, C, P], t_run [T, P] the entry
    transmittance, dead [T, P] pixels that have stopped. The stop fires before the first
    valid instance whose inclusive transmittance falls under the threshold.
    -> (w [T, C, P] blend weights, t_run and dead after the chunk)."""
    one_m = 1.0 - a
    cp_incl = torch.cumprod(one_m, dim=1)
    t_incl = t_run[:, None, :] * cp_incl
    below = t_incl < TRANSMITTANCE_THRESHOLD  # monotone along the chunk
    alive = ~dead
    use = valid & ~below & alive[:, None, :]
    t_excl = t_run[:, None, :] * (cp_incl / one_m)  # one_m >= 1e-3: safe
    w = torch.where(use, a * t_excl, 0.0)
    # T after the last accepted instance: the smallest not-yet-stopped T_incl
    t_cand = torch.where(below, t_run[:, None, :], t_incl).amin(dim=1)
    return w, torch.where(alive, t_cand, t_run), dead | (valid & below).any(dim=1)


# The plain versions' sums over features and instances: fixed-order elementwise products
# and reductions along one axis, never a BLAS contraction, whose blocking (and so its
# summation order) may follow the thread count.
def weighted_features(w, feat4):
    """sum over the chunk's instances of w [T, C, P] x feat4 [T, C, 4] -> [T, P, 4]."""
    return torch.stack([(w * feat4[:, :, k, None]).sum(1) for k in range(4)], dim=2)


def feature_dot(feat4, g4):
    """feat4 [T, C, 4] . g4 [T, P, 4] over the four features -> [T, C, P]."""
    f, g = feat4[:, :, None, :], g4[:, None, :, :]
    return (f[..., 0] * g[..., 0] + f[..., 1] * g[..., 1]) + (
        f[..., 2] * g[..., 2] + f[..., 3] * g[..., 3])


def weight_grads(w, g4):
    """The four feature gradients of each instance, sum over pixels of w [T, C, P] x
    g4 [T, P, 4] -> four [T, C]."""
    return [(w * g4[:, None, :, k]).sum(2) for k in range(4)]


@torch.no_grad()
def blend_forward_plain(flat, seg_start, tile_count, *, n_tiles: int, grid_w: int,
                        tile_size: int, max_chunks: int, chunk: int = 128, tile_y0: int = 0):
    """Plain version of K2, vectorised over batches of tiles: one [T, chunk, P]
    closed-form step per chunk (cumprod along the instance axis), as
    `tpu_splat/ops/blend.py` computes it. A bf16 table is unpacked to float32 first."""
    _check_blend_args(flat, seg_start, tile_count, n_tiles, tile_size, max_chunks, chunk,
                      tile_y0)
    dev = flat.device
    p = tile_size * tile_size
    feat = unpack_features(flat)[:NFEAT]
    outs, chks = [], []
    for t0, t1 in _tile_batches(n_tiles, tile_size, chunk):
        nt = t1 - t0
        start = seg_start[t0:t1].long()
        count = tile_count[t0:t1].clamp(0, max_chunks * chunk).long()
        nch = (count + chunk - 1) // chunk
        px, py = tile_pixel_centers(nt, grid_w, tile_size, dev,
                                    first_tile=t0 + tile_y0 * grid_w)
        px, py = px[:, None, :], py[:, None, :]  # [T, 1, P]

        chk = torch.zeros((nt, p, max_chunks), dtype=torch.float32, device=dev)
        t_run = torch.ones((nt, p), dtype=torch.float32, device=dev)
        dead = torch.zeros((nt, p), dtype=torch.bool, device=dev)
        acc = torch.zeros((nt, p, 4), dtype=torch.float32, device=dev)
        for j in range(int(nch.max()) if nt else 0):
            chk[:, :, j] = torch.where(dead | (j >= nch)[:, None], 0.0, t_run)
            f, _, _, _, _, _, a, valid = _chunk_alphas(feat, start, count, j, chunk, px, py)

            w, t_run, dead = composite_chunk(a, valid, t_run, dead)
            feat4 = f[F_R:F_D + 1].permute(1, 2, 0)  # [T, C, 4]
            acc = acc + weighted_features(w, feat4)

        zeros = torch.zeros((nt, p, 3), dtype=torch.float32, device=dev)
        outs.append(torch.cat([acc[:, :, :3], t_run[:, :, None], acc[:, :, 3:], zeros], dim=2))
        chks.append(chk)
    if not outs:
        return (torch.zeros((0, p, 8), dtype=torch.float32, device=dev),
                torch.zeros((0, p, max_chunks), dtype=torch.float32, device=dev))
    return torch.cat(outs), torch.cat(chks)


def blend_forward(flat, seg_start, tile_count, *, n_tiles: int, grid_w: int,
                  tile_size: int, max_chunks: int, chunk: int = 128, tile_y0: int = 0):
    """K2. CPU tensors run the plain version; CUDA tensors launch `csrc/blend_fwd.cu`
    (one 256-thread block per tile) or raise. `flat` is float32 (F_* rows) or bfloat16
    (B_* rows); `tile_y0` is the image's tile row of tile 0.

    -> (out [T, P, 8], chk [T, P, max_chunks]), both float32."""
    if flat.device.type == "cpu":
        return blend_forward_plain(flat, seg_start, tile_count, n_tiles=n_tiles,
                                   grid_w=grid_w, tile_size=tile_size,
                                   max_chunks=max_chunks, chunk=chunk, tile_y0=tile_y0)
    _check_blend_args(flat, seg_start, tile_count, n_tiles, tile_size, max_chunks, chunk,
                      tile_y0)
    require_cuda(flat, flat=flat, seg_start=seg_start, tile_count=tile_count)
    p = tile_size * tile_size
    out = torch.empty((n_tiles, p, 8), dtype=torch.float32, device=flat.device)
    chk = torch.empty((n_tiles, p, max_chunks), dtype=torch.float32, device=flat.device)
    err = kernel("blend_fwd")(
        flat.data_ptr(), int(flat.dtype == torch.bfloat16), flat.stride(0),
        seg_start.data_ptr(), tile_count.data_ptr(),
        n_tiles, grid_w, tile_y0, tile_size, chunk, max_chunks, out.data_ptr(),
        chk.data_ptr(),
        torch.cuda.current_stream(flat.device).cuda_stream,
    )
    check(err, "blend_fwd")
    count_launch(blend_forward)
    return out, chk


blend_forward.launches = 0


def _check_backward_args(chk, out, gout, n_tiles, tile_size, max_chunks):
    p = tile_size * tile_size
    for name, x, last in (("chk", chk, max_chunks), ("out", out, 8), ("gout", gout, 8)):
        if x.shape != (n_tiles, p, last) or x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 [{n_tiles}, {p}, {last}], got "
                             f"{x.dtype} {tuple(x.shape)}")


@torch.no_grad()
def blend_backward_plain(flat, seg_start, tile_count, chk, out, gout, *, n_tiles: int,
                         grid_w: int, tile_size: int, max_chunks: int, chunk: int = 128,
                         tile_y0: int = 0):
    """Plain version of K3: an explicit replay from the checkpoints, chunk by chunk from
    the last to the first, vectorised over batches of tiles — the exact lane of
    `tpu_splat/ops/pallas/blend.py::_bwd_kernel` (stacked products, exact divides):

      use     = valid & (T_entry cp_incl >= 1e-4)        (T_entry = chk; 0 = never ran)
      w       = use a T_excl
      dL/da   = use (T_excl (g.c) - suffix / (1 - a)),  suffix seeded by T_final gout[3]
      dL/dsig = -a dL/da where op gauss < 0.999

    -> gflat [10, M] float32; columns owned by no tile are zero."""
    _check_blend_args(flat, seg_start, tile_count, n_tiles, tile_size, max_chunks, chunk,
                      tile_y0)
    _check_backward_args(chk, out, gout, n_tiles, tile_size, max_chunks)
    dev = flat.device
    feat = unpack_features(flat)[:NFEAT]
    gflat = torch.zeros((NFEAT, flat.shape[1]), dtype=torch.float32, device=dev)
    for t0, t1 in _tile_batches(n_tiles, tile_size, chunk):
        nt = t1 - t0
        start = seg_start[t0:t1].long()
        count = tile_count[t0:t1].clamp(0, max_chunks * chunk).long()
        px, py = tile_pixel_centers(nt, grid_w, tile_size, dev,
                                    first_tile=t0 + tile_y0 * grid_w)
        px, py = px[:, None, :], py[:, None, :]  # [T, 1, P]
        g4 = gout[t0:t1][:, :, [0, 1, 2, 4]]  # [T, P, 4]: d/d(r, g, b, depth)
        carry = out[t0:t1, :, 3] * gout[t0:t1, :, 3]  # [T, P]: T_final * d/dT_final
        live = chk[t0:t1].amax(dim=(0, 1)) > 0  # [max_chunks]
        n_iter = int(live.nonzero().max()) + 1 if bool(live.any()) else 0
        for j in reversed(range(n_iter)):
            t_in = chk[t0:t1, :, j][:, None, :]  # [T, 1, P]
            f, idx, lane_valid, dx, dy, gauss, a, valid = _chunk_alphas(
                feat, start, count, j, chunk, px, py)
            ca, cb, cc, op = (f[i][:, :, None] for i in (F_CA, F_CB, F_CC, F_OP))

            one_m = 1.0 - a
            cp_incl = torch.cumprod(one_m, dim=1)
            use = valid & ~(t_in * cp_incl < TRANSMITTANCE_THRESHOLD) & (t_in > 0)
            t_excl = t_in * (cp_incl / one_m)
            w = torch.where(use, a * t_excl, 0.0)  # [T, C, P]
            feat4 = f[F_R:F_D + 1].permute(1, 2, 0)  # [T, C, 4]
            cdotg = feature_dot(feat4, g4)
            u = w * cdotg
            # strictly-later instances of this chunk, plus everything in later chunks
            later = torch.flip(torch.cumsum(torch.flip(u, (1,)), dim=1), (1,)) - u
            suffix = later + carry[:, None, :]
            dl_da = torch.where(use, t_excl * cdotg - suffix / one_m, 0.0)
            not_clamped = op * gauss < MAX_FRAGMENT_ALPHA
            dl_ds = torch.where(not_clamped, dl_da * -a, 0.0)
            grads = torch.stack([
                (dl_ds * (ca * dx + cb * dy)).sum(2),
                (dl_ds * (cc * dy + cb * dx)).sum(2),
                (dl_ds * (0.5 * dx * dx)).sum(2),
                (dl_ds * (dx * dy)).sum(2),
                (dl_ds * (0.5 * dy * dy)).sum(2),
                torch.where(not_clamped, dl_da * gauss, 0.0).sum(2),
                *weight_grads(w, g4),
            ])  # [10, T, C]
            gflat[:, idx[lane_valid]] = grads[:, lane_valid]
            carry = carry + u.sum(1)
    return gflat


def blend_backward(flat, seg_start, tile_count, chk, out, gout, *, n_tiles: int,
                   grid_w: int, tile_size: int, max_chunks: int, chunk: int = 128,
                   tile_y0: int = 0):
    """K3. CPU tensors run the plain version; CUDA tensors launch `csrc/blend_bwd.cu`
    (one 256-thread block per tile) or raise. `flat`, the segments, `chk` and `out` are
    the forward's; `gout` [T, P, 8] holds d/d(rgb) in 0-2, d/dT_final in 3, d/d(depth)
    in 4.

    -> gflat [10, M] float32: per-instance gradients of the ten F_* features in
    tile-sorted order; columns owned by no tile are zero."""
    if flat.device.type == "cpu":
        return blend_backward_plain(flat, seg_start, tile_count, chk, out, gout,
                                    n_tiles=n_tiles, grid_w=grid_w, tile_size=tile_size,
                                    max_chunks=max_chunks, chunk=chunk, tile_y0=tile_y0)
    _check_blend_args(flat, seg_start, tile_count, n_tiles, tile_size, max_chunks, chunk,
                      tile_y0)
    _check_backward_args(chk, out, gout, n_tiles, tile_size, max_chunks)
    require_cuda(flat, flat=flat, seg_start=seg_start, tile_count=tile_count, chk=chk,
                out=out, gout=gout)
    gflat = torch.zeros((NFEAT, flat.shape[1]), dtype=torch.float32, device=flat.device)
    err = kernel("blend_bwd")(
        flat.data_ptr(), int(flat.dtype == torch.bfloat16), flat.stride(0),
        seg_start.data_ptr(), tile_count.data_ptr(),
        n_tiles, grid_w, tile_y0, tile_size, chunk, max_chunks,
        chk.data_ptr(), out.data_ptr(), gout.data_ptr(), gflat.data_ptr(), gflat.stride(0),
        torch.cuda.current_stream(flat.device).cuda_stream,
    )
    check(err, "blend_bwd")
    count_launch(blend_backward)
    return gflat


blend_backward.launches = 0
