"""Per-tile front-to-back blend, forward (kernel K2).

Counterpart of `tpu_splat/ops/pallas/blend.py::blend_forward` in its f32 feature layout.
Per tile, the depth-sorted instance segment [seg_start, seg_start + count) of a
feature-major [>=NFEAT, M] table is composited per pixel in chunks of `chunk` instances:

  sigma = 0.5*(A dx^2 + C dy^2) + B dx dy          ; skip if sigma < 0
  alpha = min(opacity * exp(-sigma), 0.999)        ; skip if alpha < 1/255
  T_next = T * (1 - alpha)                         ; STOP (excluding this one) if T_next < 1e-4
  rgb/depth += T * alpha * feature ; T = T_next

Returns out [T, P, 8] = (rgb, T_final, depth, 0, 0, 0) and chk [T, P, max_chunks], each
chunk's entry transmittance (0 once the pixel has stopped, and for chunks never visited)
— the replay checkpoints of the backward kernel, which comes with the training slice.

`blend_forward` launches `csrc/blend_fwd.cu` on a CUDA tensor and runs the plain version,
`blend_forward_plain`, on a CPU tensor. The plain version is the chunked closed form of
`tpu_splat/ops/blend.py` (cumprod of 1 - alpha within each chunk) vectorised over tiles.
"""

from __future__ import annotations

import torch

from ..projection import MAX_FRAGMENT_ALPHA, MIN_ALPHA, TRANSMITTANCE_THRESHOLD
from .build import check, kernel

# feature rows of the flat instance table (f32 layout of the JAX package's F_* rows)
F_MX, F_MY, F_CA, F_CB, F_CC, F_OP, F_R, F_G, F_B, F_D = range(10)
NFEAT = 10
TILE_SIZES = (16, 32)
CHUNKS = (128, 256)


def _check_blend_args(flat, seg_start, tile_count, n_tiles, tile_size, max_chunks, chunk):
    if flat.dim() != 2 or flat.shape[0] < NFEAT or flat.dtype != torch.float32:
        raise ValueError(f"flat must be float32 [>={NFEAT}, M], got {flat.dtype} "
                         f"{tuple(flat.shape)}")
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


def tile_pixel_centers(n_tiles: int, grid_w: int, tile_size: int, dev):
    """Pixel centres [T, P] (x and y), row-major pixels within each tile."""
    t = torch.arange(n_tiles, device=dev)[:, None]
    idx = torch.arange(tile_size * tile_size, device=dev)[None, :]
    px = ((t % grid_w) * tile_size + idx % tile_size).to(torch.float32) + 0.5
    py = ((t // grid_w) * tile_size + idx // tile_size).to(torch.float32) + 0.5
    return px, py


def blend_forward_plain(flat, seg_start, tile_count, *, n_tiles: int, grid_w: int,
                        tile_size: int, max_chunks: int, chunk: int = 128):
    """Plain version of K2, vectorised over tiles: one [T, chunk, P] closed-form step per
    chunk (cumprod along the instance axis), as `tpu_splat/ops/blend.py` computes it."""
    _check_blend_args(flat, seg_start, tile_count, n_tiles, tile_size, max_chunks, chunk)
    dev = flat.device
    p = tile_size * tile_size
    count = tile_count.clamp(0, max_chunks * chunk).long()
    nch = (count + chunk - 1) // chunk
    px, py = tile_pixel_centers(n_tiles, grid_w, tile_size, dev)
    px, py = px[:, None, :], py[:, None, :]  # [T, 1, P]

    chk = torch.zeros((n_tiles, p, max_chunks), dtype=torch.float32, device=dev)
    t_run = torch.ones((n_tiles, p), dtype=torch.float32, device=dev)
    dead = torch.zeros((n_tiles, p), dtype=torch.bool, device=dev)
    acc = torch.zeros((n_tiles, p, 4), dtype=torch.float32, device=dev)
    lane = torch.arange(chunk, device=dev)
    n_iter = int(nch.max()) if n_tiles else 0
    for j in range(n_iter):
        chk[:, :, j] = torch.where(dead | (j >= nch)[:, None], 0.0, t_run)
        local = j * chunk + lane
        lane_valid = local[None, :] < count[:, None]  # [T, C]
        idx = torch.where(lane_valid, seg_start.long()[:, None] + local[None, :], 0)
        f = flat[:NFEAT, idx]  # [F, T, C]
        mx, my, ca, cb, cc, op = (f[i][:, :, None] for i in range(F_OP + 1))  # [T, C, 1]

        dx = mx - px  # [T, C, P]
        dy = my - py
        sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
        alpha = torch.clamp_max(op * torch.exp(-torch.clamp_min(sigma, 0.0)),
                                MAX_FRAGMENT_ALPHA)
        valid = lane_valid[:, :, None] & (sigma >= 0.0) & (alpha >= MIN_ALPHA)
        a = torch.where(valid, alpha, 0.0)

        one_m = 1.0 - a
        cp_incl = torch.cumprod(one_m, dim=1)
        t_incl = t_run[:, None, :] * cp_incl
        below = t_incl < TRANSMITTANCE_THRESHOLD  # monotone along the chunk
        alive = ~dead
        use = valid & ~below & alive[:, None, :]
        t_excl = t_run[:, None, :] * (cp_incl / one_m)  # one_m >= 1e-3: safe
        w = torch.where(use, a * t_excl, 0.0)
        feat4 = f[F_R:F_D + 1].permute(1, 2, 0)  # [T, C, 4]
        acc = acc + torch.einsum("tcp,tck->tpk", w, feat4)
        # T after the last accepted instance: the smallest not-yet-stopped T_incl
        t_cand = torch.where(below, t_run[:, None, :], t_incl).amin(dim=1)
        t_run = torch.where(alive, t_cand, t_run)
        dead = dead | (valid & below).any(dim=1)

    zeros = torch.zeros((n_tiles, p, 3), dtype=torch.float32, device=dev)
    out = torch.cat([acc[:, :, :3], t_run[:, :, None], acc[:, :, 3:], zeros], dim=2)
    return out, chk


def blend_forward(flat, seg_start, tile_count, *, n_tiles: int, grid_w: int,
                  tile_size: int, max_chunks: int, chunk: int = 128):
    """K2. CPU tensors run the plain version; CUDA tensors launch `csrc/blend_fwd.cu`
    (one 256-thread block per tile) or raise.

    -> (out [T, P, 8], chk [T, P, max_chunks]), both float32."""
    if flat.device.type == "cpu":
        return blend_forward_plain(flat, seg_start, tile_count, n_tiles=n_tiles,
                                   grid_w=grid_w, tile_size=tile_size,
                                   max_chunks=max_chunks, chunk=chunk)
    _check_blend_args(flat, seg_start, tile_count, n_tiles, tile_size, max_chunks, chunk)
    for name, x in (("flat", flat), ("seg_start", seg_start), ("tile_count", tile_count)):
        if not x.is_cuda or not x.is_contiguous() or x.device != flat.device:
            raise ValueError(f"{name} must be a contiguous CUDA tensor on {flat.device}")
    p = tile_size * tile_size
    out = torch.empty((n_tiles, p, 8), dtype=torch.float32, device=flat.device)
    chk = torch.empty((n_tiles, p, max_chunks), dtype=torch.float32, device=flat.device)
    err = kernel("blend_fwd")(
        flat.data_ptr(), flat.stride(0), seg_start.data_ptr(), tile_count.data_ptr(),
        n_tiles, grid_w, tile_size, chunk, max_chunks, out.data_ptr(), chk.data_ptr(),
        torch.cuda.current_stream(flat.device).cuda_stream,
    )
    check(err, "blend_fwd")
    blend_forward.launches += 1
    return out, chk


blend_forward.launches = 0
