"""The benchmark's plain reference of a 3DGS frame and an MCMC train step, in PyTorch.

It follows the published 3D Gaussian Splatting rasterizer (Kerbl et al. 2023) with the
choices this repository's JAX package states, and imports nothing of the program:

  * projection: EWA splatting with the Jacobian clamped to 1.15x the image, a 0.3 px
    dilation, culls at depth 0.01, opacity 1/255, |q|^2 1e-8 and det 1e-8; colour from
    SH degree <= 3 plus 0.5, clamped at 0; the opacity-aware tile rect
    sqrt(2 log(255 o) cov) - 0.5 px;
  * order: per tile by the top (31 - tile bits) bits of the float32 depth's bit pattern,
    ties in Gaussian order (the packed sort key the JAX package defines);
  * blend: alpha = min(o exp(-sigma), 0.999), skipped below 1/255 or for sigma < 0; a pixel
    stops before the pair that would take its transmittance below 1e-4;
  * loss: 0.8 L1 + 0.2 (1 - SSIM), SSIM on an 11-tap sigma-1.5 window, valid; plus
    0.01 mean(exp(scale)) + 0.01 mean(sigmoid(opacity)) over the alive slots;
  * Adam per group (betas 0.9/0.999, eps 1e-15), the means rate decayed by
    0.01^(it/iterations); MCMC noise lr * 5e5 * sigmoid gate * (R S^2 R^T eps), with eps
    one standard-normal [C, 3] draw a step from the run's generator;
  * MCMC refinement every refine_every steps (Kheradmand et al. 2024, eq. 9): dead slots
    relocated to sources drawn by opacity, then 5% growth up to the cap, each draw one
    multinomial over every slot from the same generator (`mcmc_refine`).

Every tile is evaluated densely over all its candidate Gaussians, in blocks of tiles, and
differentiated by autograd: the gradient needs no hand-written backward. `features`
selects the precision of the blend's per-Gaussian inputs: "f32"; "bf16_pack" (mean and
conic as a bf16 hi/lo pair, opacity and colour one bf16 each: the Trainer's default
pack); "lowered" (mean and conic one bf16, opacity and colour float8 e4m3) and "bf16"
(every input one bf16), the controls.

A camera that carries OpenCV distortion (`dist` = k1, k2, p1, p2) renders through 3DGUT
(Wu et al. 2025) as the JAX package states it: the unscented projection of seven sigma
points (alpha 0.1, beta 2, kappa 0) sets each Gaussian's tile rect (no per-tile test)
and its opacity compensation; each pixel's world ray meets the Gaussian at its largest
response, alpha = min(o exp(-|n x M(o - mean)|^2 / 2), 0.999) with n = normalise(M d) and
M = S^-1 R^T; the projection and the rays carry no gradient.
"""

from __future__ import annotations

import math

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.48860251190291987
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525251999,
         -1.0925484305920792, 0.54627421529603959)
SH_C3 = (0.59004358992664352, 2.8906114426405538, 0.45704579946446572,
         0.3731763325901154, 1.4453057213202769)
MIN_ALPHA = 1.0 / 255.0
MAX_ALPHA = 0.999
T_STOP = 1e-4
NEAR = 0.01
BLOCK_ELEMS = 1 << 25  # (tile, Gaussian, pixel) entries of one block's temporaries
PARAMS = ("means", "sh0", "shN", "scaling_raw", "rotation_raw", "opacity_raw")


def f32(x: float) -> float:
    """`x` rounded to float32, as a Python float."""
    return float(torch.tensor(x, dtype=torch.float32))


def sh_color(sh0, shN, dirs, degree: int):
    """RGB [N, 3] = 0.5 + SH(dir) for degree <= 3 (the 3DGS basis, as in its CUDA
    rasterizer's computeColorFromSH)."""
    d = dirs * torch.rsqrt(torch.clamp_min((dirs * dirs).sum(-1, keepdim=True), 1e-24))
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    c = shN
    out = 0.5 + SH_C0 * sh0[:, 0]
    if degree >= 1:
        out = out - SH_C1 * y * c[:, 0] + SH_C1 * z * c[:, 1] - SH_C1 * x * c[:, 2]
    if degree >= 2:
        xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
        out = (out + SH_C2[0] * xy * c[:, 3] + SH_C2[1] * yz * c[:, 4]
               + SH_C2[2] * (2.0 * zz - xx - yy) * c[:, 5] + SH_C2[3] * xz * c[:, 6]
               + SH_C2[4] * (xx - yy) * c[:, 7])
    if degree >= 3:
        out = (out - SH_C3[0] * y * (3.0 * xx - yy) * c[:, 8]
               + SH_C3[1] * xy * z * c[:, 9]
               - SH_C3[2] * y * (4.0 * zz - xx - yy) * c[:, 10]
               + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * c[:, 11]
               - SH_C3[2] * x * (4.0 * zz - xx - yy) * c[:, 12]
               + SH_C3[4] * z * (xx - yy) * c[:, 13]
               - SH_C3[0] * x * (xx - 3.0 * yy) * c[:, 14])
    return out


def rotmat(q):
    """Rotation matrices [N, 3, 3] of unnormalised wxyz quaternions."""
    q = q * torch.rsqrt(torch.clamp_min((q * q).sum(-1, keepdim=True), 1e-8))
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(q.shape[:-1] + (3, 3))


def project(p: dict, alive, cam: dict, degree: int, tile: int):
    """Per-Gaussian screen quantities. `cam`: w2c [4, 4] tensor, fx fy cx cy, width,
    height. -> dict(feat [N, 9] = (mx, my, ca, cb, cc, opacity, r, g, b), depth [N],
    visible [N], rect [N, 4] int (x0, y0, x1, y1) tiles, exclusive ends)"""
    w2c, fx, fy, cx, cy = cam["w2c"], cam["fx"], cam["fy"], cam["cx"], cam["cy"]
    width, height = cam["width"], cam["height"]
    means = p["means"]
    pc = means @ w2c[:3, :3].T + w2c[:3, 3]
    depth = pc[:, 2]
    opacity = torch.sigmoid(p["opacity_raw"][:, 0])
    q = p["rotation_raw"]
    visible = (alive & (depth >= NEAR) & (opacity >= f32(MIN_ALPHA))
               & ((q * q).sum(-1) >= 1e-8))
    z = torch.where(visible, depth, torch.ones_like(depth))
    x, y = pc[:, 0] / z, pc[:, 1] / z
    tx = torch.clamp(x, (-0.15 * width - cx) / fx, (1.15 * width - cx) / fx)
    ty = torch.clamp(y, (-0.15 * height - cy) / fy, (1.15 * height - cy) / fy)
    zeros = torch.zeros_like(z)
    jac = torch.stack([fx / z, zeros, -fx * tx / z, zeros, fy / z, -fy * ty / z],
                      -1).reshape(-1, 2, 3)
    t = jac @ w2c[:3, :3]  # [N, 2, 3]
    r = rotmat(q)
    m = t @ r * torch.exp(p["scaling_raw"])[:, None, :]  # J W R S
    cov = m @ m.transpose(1, 2)  # [N, 2, 2]
    ca, cb, cc = cov[:, 0, 0] + 0.3, cov[:, 0, 1], cov[:, 1, 1] + 0.3
    det = ca * cc - cb * cb
    visible = visible & (det >= 1e-8)
    det = torch.where(det > 1e-12, det, torch.ones_like(det))
    mx, my = x * fx + cx, y * fy + cy
    pth = torch.log(torch.clamp_min(opacity, f32(MIN_ALPHA)) * 255.0)
    ptf = torch.sqrt(torch.clamp_min(2.0 * pth, 0.0))
    ext_x = torch.clamp_min(ptf * torch.sqrt(torch.clamp_min(ca, 0.0)) - 0.5, 0.0)
    ext_y = torch.clamp_min(ptf * torch.sqrt(torch.clamp_min(cc, 0.0)) - 0.5, 0.0)
    gw, gh = -(-width // tile), -(-height // tile)
    with torch.no_grad():
        x0 = torch.clamp(torch.floor((mx - ext_x) / tile), 0, gw)
        x1 = torch.clamp(torch.ceil((mx + ext_x) / tile), 0, gw)
        y0 = torch.clamp(torch.floor((my - ext_y) / tile), 0, gh)
        y1 = torch.clamp(torch.ceil((my + ext_y) / tile), 0, gh)
        rect = torch.stack([x0, y0, x1, y1], -1).nan_to_num(0.0).long()
        visible = visible & ((rect[:, 2] - rect[:, 0]) * (rect[:, 3] - rect[:, 1]) > 0)
    color = torch.clamp_min(sh_color(p["sh0"], p["shN"], means - cam["position"], degree),
                            0.0)
    feat = torch.cat([torch.stack([mx, my, cc / det, -cb / det, ca / det, opacity], -1),
                      color], -1)
    return dict(feat=feat, depth=depth.detach(), visible=visible, rect=rect)


UT_ALPHA, UT_BETA, UT_KAPPA = 0.1, 2.0, 0.0  # 3DGUT's sigma-point weights
UT_EPS2D = 0.3
UT_MAX_EXTENT = 3.33


def _distort(uv, dist):
    """OpenCV's (k1, k2, p1, p2) distortion of normalised points: (radial factor,
    tangential offset)."""
    k1, k2, p1, p2 = dist
    x, y = uv[..., 0], uv[..., 1]
    r2 = x * x + y * y
    icd = 1.0 + r2 * (k1 + r2 * k2)
    dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return icd, torch.stack([dx, dy], -1)


@torch.no_grad()
def project_ut(p: dict, alive, cam: dict, tile: int):
    """3DGUT's projection: seven sigma points of each Gaussian through the distorted
    camera, the image mean and covariance by the unscented weights, a 0.3 px blur with
    its opacity compensation, the extent min(3.33, sqrt(2 ln(255 o))) sigma. No
    gradient. -> dict(comp [N], depth, visible, rect)"""
    w2c, dist = cam["w2c"], cam["dist"]
    width, height = cam["width"], cam["height"]
    means = p["means"]
    lam = UT_ALPHA ** 2 * (3 + UT_KAPPA) - 3
    wm = torch.tensor([lam / (3 + lam)] + [1 / (2 * (3 + lam))] * 6, device=means.device)
    wc = wm.clone()
    wc[0] += 1 - UT_ALPHA ** 2 + UT_BETA
    delta = math.sqrt(3 + lam) * torch.exp(p["scaling_raw"])[:, :, None] \
        * rotmat(p["rotation_raw"]).transpose(1, 2)  # row i: s_i R[:, i]
    pts = torch.cat([means[:, None], means[:, None] + delta, means[:, None] - delta], 1)
    pc = pts @ w2c[:3, :3].T + w2c[:3, 3]
    z = pc[..., 2]
    uv = pc[..., :2] / torch.where(z > 0, z, torch.ones_like(z))[..., None]
    icd, tang = _distort(uv, dist)
    f = torch.tensor([cam["fx"], cam["fy"]], device=means.device)
    c = torch.tensor([cam["cx"], cam["cy"]], device=means.device)
    img = (icd[..., None] * uv + tang) * f + c
    ok = ((z > 0) & (icd > 0.8) & (img[..., 0] >= -0.15 * width)
          & (img[..., 0] <= 1.15 * width) & (img[..., 1] >= -0.15 * height)
          & (img[..., 1] <= 1.15 * height))
    mean = (wm[None, :, None] * img).sum(1)
    dv = img - mean[:, None]
    cov = torch.einsum("s,nsi,nsj->nij", wc, dv, dv)
    depth = z[:, 0]
    visible = alive & ok.any(1) & (depth > NEAR)
    det0 = cov[:, 0, 0] * cov[:, 1, 1] - cov[:, 0, 1] * cov[:, 1, 0]
    ca, cb, cc = cov[:, 0, 0] + UT_EPS2D, cov[:, 0, 1], cov[:, 1, 1] + UT_EPS2D
    det = ca * cc - cb * cb
    visible = visible & (det > 0)
    comp = torch.sqrt(torch.clamp_min(det0, 0.0)
                      / torch.where(det > 1e-12, det, torch.ones_like(det)))
    op = torch.sigmoid(p["opacity_raw"][:, 0]) * comp
    visible = visible & (op >= f32(MIN_ALPHA))
    ext = torch.clamp_max(torch.sqrt(torch.clamp_min(2 * torch.log(op * 255.0), 0.0)),
                          UT_MAX_EXTENT)
    rx = torch.ceil(ext * torch.sqrt(torch.clamp_min(ca, 0.0)))
    ry = torch.ceil(ext * torch.sqrt(torch.clamp_min(cc, 0.0)))
    visible = visible & (rx > 0) & (ry > 0)
    gw, gh = -(-width // tile), -(-height // tile)
    x0 = torch.clamp(torch.floor((mean[:, 0] - rx) / tile), 0, gw)
    x1 = torch.clamp(torch.ceil((mean[:, 0] + rx) / tile), 0, gw)
    y0 = torch.clamp(torch.floor((mean[:, 1] - ry) / tile), 0, gh)
    y1 = torch.clamp(torch.ceil((mean[:, 1] + ry) / tile), 0, gh)
    rect = torch.stack([x0, y0, x1, y1], -1).nan_to_num(0.0).long()
    visible = visible & ((rect[:, 2] - rect[:, 0]) * (rect[:, 3] - rect[:, 1]) > 0)
    comp = torch.where(visible, comp, torch.zeros_like(comp))
    return dict(comp=comp, depth=depth, visible=visible, rect=rect)


def gut_features(p: dict, cam: dict, degree: int, ut: dict):
    """The ray blend's per-Gaussian inputs [N, 16]: M = S^-1 R^T (row-major), the ray
    origin in the Gaussian's frame M (o - mean), opacity x compensation, colour."""
    m = rotmat(p["rotation_raw"]).transpose(1, 2) * torch.exp(-p["scaling_raw"])[:, :, None]
    gro = (m @ (cam["position"] - p["means"])[:, :, None])[:, :, 0]
    op = torch.sigmoid(p["opacity_raw"][:, 0]) * ut["comp"]
    color = torch.clamp_min(sh_color(p["sh0"], p["shN"], p["means"] - cam["position"],
                                     degree), 0.0)
    return torch.cat([m.reshape(-1, 9), gro, op[:, None], color], -1)


@torch.no_grad()
def gut_rays(cam: dict, tile: int):
    """Each tile pixel's world ray direction [T, P, 3] through the distorted camera: the
    normalised point undistorted by 20 fixed-point steps (in float64), then rotated."""
    width, height = cam["width"], cam["height"]
    gw, gh = -(-width // tile), -(-height // tile)
    dev = cam["w2c"].device
    t = torch.arange(gw * gh, device=dev)[:, None]
    i = torch.arange(tile * tile, device=dev)[None, :]
    px = ((t % gw) * tile + i % tile).double() + 0.5
    py = ((t // gw) * tile + i // tile).double() + 0.5
    uv0 = torch.stack([(px - cam["cx"]) / cam["fx"], (py - cam["cy"]) / cam["fy"]], -1)
    uv = uv0
    for _ in range(20):
        icd, tang = _distort(uv, cam["dist"])
        uv = (uv0 - tang) / torch.clamp_min(icd, 1e-6)[..., None]
    d = torch.cat([uv, torch.ones_like(uv[..., :1])], -1)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return (d @ cam["w2c"][:3, :3].double()).float().contiguous()


def frame_inputs(p: dict, alive, cam: dict, degree: int, tile: int):
    """(per-Gaussian blend inputs, projection, rays or None) of a camera: the pinhole
    path, or 3DGUT's when the camera carries distortion `dist`."""
    if "dist" not in cam:
        proj = project(p, alive, cam, degree, tile)
        return proj["feat"], proj, None
    ut = project_ut(p, alive, cam, tile)
    return gut_features(p, cam, degree, ut), ut, gut_rays(cam, tile)


def round_features(feat, features: str):
    """The blend's inputs at the stated precision, the rounding passed straight through
    by the gradient."""
    if features == "f32":
        return feat
    if features == "bf16":
        return feat + (feat.to(torch.bfloat16).float() - feat).detach()
    geo, rest = feat[:, :5], feat[:, 5:]
    if features == "bf16_pack":
        hi = geo.to(torch.bfloat16).float()
        geo_r = hi + (geo - hi).to(torch.bfloat16).float()
        rest_r = rest.to(torch.bfloat16).float()
    elif features == "lowered":
        geo_r = geo.to(torch.bfloat16).float()
        rest_r = rest.to(torch.float8_e4m3fn).float()
    else:
        raise ValueError(f"unknown feature precision {features!r}")
    rounded = torch.cat([geo_r, rest_r], -1)
    return feat + (rounded - feat).detach()


@torch.no_grad()
def instances(proj: dict, gw: int, gh: int):
    """Every (tile, Gaussian) pair of the visible Gaussians' rects, sorted by tile, then
    by the packed depth key, then by Gaussian. -> (tile [M], gid [M], start [T], count [T])"""
    rect, vis = proj["rect"], proj["visible"]
    dev = rect.device
    gid0 = torch.nonzero(vis)[:, 0]
    r = rect[gid0]
    w = r[:, 2] - r[:, 0]
    n = w * (r[:, 3] - r[:, 1])
    gid = torch.repeat_interleave(gid0, n)
    first = torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
    k = torch.arange(gid.shape[0], device=dev) - first
    wg = torch.repeat_interleave(w, n)
    rg = torch.repeat_interleave(r, n, dim=0)
    tile = (rg[:, 1] + k // wg) * gw + rg[:, 0] + k % wg
    n_tiles = gw * gh
    db = 31 - max(int(n_tiles).bit_length(), 1)
    dbits = torch.clamp_min(proj["depth"], 0.0).contiguous().view(torch.int32).long()
    key = (tile << db) | (dbits[gid] >> (31 - db))
    # gid is ascending in emission order, so a stable sort of the key keeps it
    order = torch.sort(key, stable=True).indices
    tile, gid = tile[order], gid[order]
    bounds = torch.searchsorted(tile, torch.arange(n_tiles + 1, device=dev))
    return tile, gid, bounds[:-1], bounds[1:] - bounds[:-1]


def _blocks(count, tile_px: int):
    """Blocks of tiles (by count, largest first) whose dense temporaries (`tile_px`
    entries a pair) stay within BLOCK_ELEMS. -> list of (tile ids, K)"""
    order = torch.argsort(count, descending=True)
    counts = count[order].tolist()
    out, i = [], 0
    while i < len(counts):
        k = max(counts[i], 1)
        nt = max(1, BLOCK_ELEMS // (k * tile_px))
        out.append((order[i:i + nt], k))
        i += nt
    return out


def _blend_block(feat, gid_sorted, start, count, tiles, k, gw, tile, width, height,
                 rays=None):
    """Dense blend of one block of tiles; `rays` [T, P, 3] (the GUT frame's world ray
    directions) or None (screen-space splats). -> (rgb [nt, P, 3], T [nt, P], used
    [nt, K, P] bool, stops [nt, P] bool, inside [nt, P] bool)"""
    dev = feat.device
    lane = torch.arange(k, device=dev)
    cnt = count[tiles]
    lane_ok = lane[None, :] < cnt[:, None]
    idx = torch.where(lane_ok, start[tiles][:, None] + lane[None, :], 0)
    g = gid_sorted[idx] if gid_sorted.numel() else torch.zeros_like(idx)
    f = feat[g]  # [nt, K, F]: opacity and colour are its last four columns
    pix = torch.arange(tile * tile, device=dev)
    px = ((tiles % gw) * tile)[:, None] + pix[None, :] % tile
    py = ((tiles // gw) * tile)[:, None] + pix[None, :] // tile
    inside = (px < width) & (py < height)
    op = f[:, :, -4:-3]
    if rays is None:
        pxf, pyf = px.float()[:, None, :] + 0.5, py.float()[:, None, :] + 0.5
        mx, my, ca, cb, cc = (f[:, :, i:i + 1] for i in range(5))
        dx, dy = mx - pxf, my - pyf
        sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
        alpha = torch.clamp_max(op * torch.exp(-torch.clamp_min(sigma, 0.0)), MAX_ALPHA)
        valid = lane_ok[:, :, None] & (sigma >= 0.0) & (alpha >= f32(MIN_ALPHA))
    else:
        # 3DGUT: the Gaussian's largest response along the pixel's ray, in its own frame
        m = f[:, :, 0:9].reshape(f.shape[0], k, 3, 3)
        v = torch.einsum("tkij,tpj->tkpi", m, rays[tiles])
        n = v / torch.sqrt(torch.clamp_min((v * v).sum(-1, keepdim=True), 1e-24))
        c = torch.cross(n, f[:, :, None, 9:12].expand_as(n), dim=-1)
        alpha = torch.clamp_max(op * torch.exp(-0.5 * (c * c).sum(-1)), MAX_ALPHA)
        valid = lane_ok[:, :, None] & (alpha >= f32(MIN_ALPHA))
    a = torch.where(valid, alpha, torch.zeros_like(alpha))
    log1m = torch.log1p(-a)
    log_t = torch.cumsum(log1m, 1)  # log T after each pair
    with torch.no_grad():
        keep = torch.exp(log_t) >= T_STOP
        used = keep & valid
        stops = (valid & ~keep).any(1)
    t_before = torch.exp(log_t - log1m)
    w = torch.where(keep, a * t_before, torch.zeros_like(a))  # [nt, K, P]
    rgb = torch.einsum("tkp,tkc->tpc", w, f[:, :, -3:])
    t_final = torch.exp(torch.where(keep, log1m, torch.zeros_like(log1m)).sum(1))
    return rgb, t_final, used, stops, inside


class Frame:
    """One camera's rasterization of a scene, kept so that a gradient can be taken
    through it block by block."""

    def __init__(self, feat, proj, cam, tile: int, rays=None):
        self.cam, self.tile, self.rays = cam, tile, rays
        self.gw, self.gh = -(-cam["width"] // tile), -(-cam["height"] // tile)
        _, self.gid, self.start, self.count = instances(proj, self.gw, self.gh)
        self.feat = feat
        # a GUT pair's temporaries are three wide
        self.blocks = _blocks(self.count, tile * tile * (1 if rays is None else 4))

    def _run(self, feat, fn):
        for tiles, k in self.blocks:
            fn(tiles, *_blend_block(feat, self.gid, self.start, self.count, tiles, k,
                                    self.gw, self.tile, self.cam["width"],
                                    self.cam["height"], self.rays))

    @torch.no_grad()
    def render(self, bg=None):
        """-> (image [3, H, W], counts dict: used pairs, stopping pixels, needed
        instances, rect instances)"""
        nt, p = self.gw * self.gh, self.tile * self.tile
        dev = self.feat.device
        rgb = torch.zeros((nt, p, 3), device=dev)
        tfin = torch.ones((nt, p), device=dev)
        counts = dict(used=0, stops=0, needed=0, rect=int(self.count.sum()))

        def keep(tiles, c, t, used, stops, inside):
            rgb[tiles], tfin[tiles] = c, t
            used = used & inside[:, None, :]
            counts["used"] += int(used.sum())
            counts["stops"] += int((stops & inside).sum())
            counts["needed"] += int(used.any(2).sum())

        self._run(self.feat.detach(), keep)
        return self.assemble(rgb, tfin, bg), counts

    def assemble(self, rgb, tfin, bg=None):
        w, h, ts = self.cam["width"], self.cam["height"], self.tile
        img = rgb.reshape(self.gh, self.gw, ts, ts, 3).permute(4, 0, 2, 1, 3)
        img = img.reshape(3, self.gh * ts, self.gw * ts)[:, :h, :w]
        if bg is not None:
            t = tfin.reshape(self.gh, self.gw, ts, ts).permute(0, 2, 1, 3)
            t = t.reshape(self.gh * ts, self.gw * ts)[:h, :w]
            img = img + t[None] * bg.reshape(3, 1, 1)
        return img

    def backward(self, feat_leaf, g_img, bg=None):
        """Accumulate d(loss)/d(feat) into `feat_leaf.grad`, given d(loss)/d(image)."""
        w, h, ts = self.cam["width"], self.cam["height"], self.tile
        gpad = torch.zeros((3, self.gh * ts, self.gw * ts), device=g_img.device)
        gpad[:, :h, :w] = g_img
        g_rgb = gpad.reshape(3, self.gh, ts, self.gw, ts).permute(1, 3, 2, 4, 0)
        g_rgb = g_rgb.reshape(self.gh * self.gw, ts * ts, 3)
        g_t = None
        if bg is not None:
            g_t = (g_rgb * bg.reshape(1, 1, 3)).sum(-1)

        def back(tiles, c, t, *_):
            s = (c * g_rgb[tiles]).sum()
            if g_t is not None:
                s = s + (t * g_t[tiles]).sum()
            s.backward()

        self._run(feat_leaf, back)


def _gauss_window(dev):
    x = torch.arange(11, dtype=torch.float64, device=dev) - 5.0
    g = torch.exp(-x * x / (2 * 1.5 ** 2))
    return (g / g.sum()).float()


def ssim(a, b):
    """Mean SSIM of two [3, H, W] images, 11-tap Gaussian window (sigma 1.5), valid."""
    g = _gauss_window(a.device)

    def blur(x):  # [5, 3, H, W] -> valid separable blur, exact float32 multiply-adds
        h, w = x.shape[-2:]
        out = sum(g[i] * x[..., :, i:w - 10 + i] for i in range(11))
        return sum(g[i] * out[..., i:h - 10 + i, :] for i in range(11))

    mu1, mu2, e11, e22, e12 = blur(torch.stack([a, b, a * a, b * b, a * b]))
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    s1, s2, s12 = e11 - mu1 * mu1, e22 - mu2 * mu2, e12 - mu1 * mu2
    num = (2 * mu1 * mu2 + c1) * (2 * s12 + c2)
    den = (mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2)
    return (num / den).mean()


def photometric(img, target, lambda_dssim: float, half: bool = False):
    """(1 - l) L1 + l (1 - SSIM). `half`: a planted fault, the loss of the left half of
    the image alone."""
    if half:
        wd = img.shape[-1] // 2
        img, target = img[..., :wd], target[..., :wd]
    l1 = (img - target).abs().mean()
    return (1 - lambda_dssim) * l1 + lambda_dssim * (1 - ssim(img, target))


def regularisers(p: dict, alive, scale_reg: float, opacity_reg: float):
    a = alive.float()
    n = torch.clamp_min(a.sum(), 1.0)
    return (scale_reg * (torch.exp(p["scaling_raw"]) * a[:, None]).sum() / (n * 3.0)
            + opacity_reg * (torch.sigmoid(p["opacity_raw"][:, 0]) * a).sum() / n)


def render(p: dict, alive, cam: dict, degree: int, tile: int, features: str = "f32",
           bg=None):
    """A frame, no gradient. -> (image [3, H, W], counts)"""
    with torch.no_grad():
        feat, proj, rays = frame_inputs(p, alive, cam, degree, tile)
        return Frame(round_features(feat, features), proj, cam, tile, rays).render(bg)


def loss_and_grads(p: dict, alive, cam: dict, target, step: dict, features: str = "f32",
                   half: bool = False):
    """The step's loss and the gradient of every leaf of `p`. `step`: degree, tile,
    lambda_dssim, scale_reg, opacity_reg, bg. -> (loss, grads dict, counts)"""
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    feat, proj, rays = frame_inputs(leaves, alive, cam, step["degree"], step["tile"])
    feat = round_features(feat, features)
    feat_leaf = feat.detach().requires_grad_(True)
    frame = Frame(feat_leaf, proj, cam, step["tile"], rays)
    img, counts = frame.render(step["bg"])
    img = img.requires_grad_(True)
    loss_img = photometric(img, target, step["lambda_dssim"], half)
    (g_img,) = torch.autograd.grad(loss_img, img)
    frame.backward(feat_leaf, g_img, step["bg"])
    reg = regularisers(leaves, alive, step["scale_reg"], step["opacity_reg"])
    torch.autograd.backward([feat, reg], [feat_leaf.grad, None])
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             for k, v in leaves.items()}
    return float(loss_img.detach()) + float(reg.detach()), grads, counts


@torch.no_grad()
def adam(p: dict, grads: dict, m: dict, v: dict, counts: dict, lrs: dict, iteration: int):
    """One Adam step of every group. -> (params, m, v, counts)"""
    out = ({}, {}, {}, {})
    for k in PARAMS:
        c = counts[k] + 1
        if k == "shN" and iteration <= 1000:  # the SH rest bands wait 1000 iterations
            out[0][k], out[1][k], out[2][k], out[3][k] = p[k], m[k], v[k], c
            continue
        m2 = 0.9 * m[k] + 0.1 * grads[k]
        v2 = 0.999 * v[k] + 0.001 * grads[k] * grads[k]
        bc1, bc2 = 1.0 - 0.9 ** c, 1.0 - 0.999 ** c
        out[0][k] = p[k] - f32(lrs[k]) * (m2 / bc1) / (torch.sqrt(v2 / bc2) + 1e-15)
        out[1][k], out[2][k], out[3][k] = m2, v2, c
    return out


def group_lrs(opt: dict, scene_scale: float, iteration: int) -> dict:
    """Each group's rate at `iteration` (1-based): the means' decays by
    0.01^((iteration - 1) / iterations)."""
    decay = 0.01 ** ((iteration - 1) / opt["iterations"])
    return dict(means=opt["means_lr"] * scene_scale * decay, sh0=opt["shs_lr"],
                shN=opt["shs_lr"] / 20.0, scaling_raw=opt["scaling_lr"],
                rotation_raw=opt["rotation_lr"], opacity_raw=opt["opacity_lr"])


@torch.no_grad()
def mcmc_noise(p: dict, alive, means_lr: float, generator):
    """means + lr * 5e5 * gate(opacity) * (R S^2 R^T eps) on the alive slots."""
    eps = torch.randn(p["means"].shape, dtype=torch.float32, device=p["means"].device,
                      generator=generator)
    r = rotmat(p["rotation_raw"])
    var = torch.exp(2.0 * p["scaling_raw"])
    moved = (r @ (var * (r.transpose(1, 2) @ eps[:, :, None])[:, :, 0])[:, :, None])[:, :, 0]
    op = torch.sigmoid(p["opacity_raw"][:, 0])
    gate = 1.0 / (1.0 + torch.exp(100.0 * op - 0.5))
    factor = f32(means_lr) * 5e5 * gate * alive.float()
    return dict(p, means=p["means"] + factor[:, None] * moved)


RELOCATE_MAX = 51  # the largest ratio of eq. (9) that 3DGS-MCMC's kernel evaluates


def refining(it: int, opt: dict) -> bool:
    """MCMC refines after steps strictly inside (start_refine, stop_refine), every
    refine_every."""
    return opt["start_refine"] < it < opt["stop_refine"] and it % opt["refine_every"] == 0


@torch.no_grad()
def _sample(probs, generator):
    """One source a slot, with replacement, probability ~ `probs`; slot 0 for every one
    when no slot may be a source (nothing is drawn then)."""
    if not bool((probs > 0).any()):
        return torch.zeros(probs.shape, dtype=torch.long, device=probs.device)
    return torch.multinomial(probs, probs.shape[0], replacement=True, generator=generator)


@torch.no_grad()
def _move(p: dict, src, targets, min_opacity: float) -> tuple[dict, torch.Tensor]:
    """Each target slot takes a copy of its source `src`; a source drawn n times (n + 1
    copies in all) first takes 3DGS-MCMC's eq. (9): opacity 1 - (1 - o)^(1/(n+1)) and
    scale o / (sum_{i=1..n+1} sum_{k<i} C(i-1, k) (-1)^k new_o^(k+1) / sqrt(k+1)) x scale,
    evaluated in float64; the new opacity kept within [min_opacity, 1 - 1e-7].
    -> (params, touched sources)"""
    cap = targets.shape[0]
    drawn = torch.zeros(cap, dtype=torch.long, device=targets.device)
    drawn.index_add_(0, src[targets], torch.ones_like(src[targets]))
    touched = drawn > 0
    idx = torch.nonzero(touched)[:, 0]
    o = torch.sigmoid(p["opacity_raw"][idx, 0]).double()
    s = torch.exp(p["scaling_raw"][idx]).double()
    ratio = torch.clamp(drawn[idx] + 1, 1, RELOCATE_MAX).double()
    new_o = 1.0 - torch.pow(1.0 - o, 1.0 / ratio)
    denom = torch.zeros_like(o)
    for i in range(1, int(ratio.max().item() if idx.numel() else 1) + 1):
        on = ratio >= i
        for k in range(i):
            term = math.comb(i - 1, k) * (-1.0) ** k / math.sqrt(k + 1) * new_o ** (k + 1)
            denom = denom + torch.where(on, term, torch.zeros_like(term))
    new_s = (o / denom)[:, None] * s
    new_o = torch.clamp(new_o, min_opacity, 1.0 - 1e-7)
    q = {k: v.clone() for k, v in p.items()}
    q["opacity_raw"][idx, 0] = torch.log(new_o / (1.0 - new_o)).float()
    q["scaling_raw"][idx] = torch.log(new_s).float()
    tgt = torch.nonzero(targets)[:, 0]
    for k in PARAMS:  # targets are never sources: each copies its source's new values
        q[k][tgt] = q[k][src[tgt]]
    return q, touched


def _zero_at(moments: dict, mask) -> dict:
    return {k: torch.where(mask.reshape((-1,) + (1,) * (v.dim() - 1)), 0.0, v)
            for k, v in moments.items()}


def refine_targets(p: dict, alive, opt: dict):
    """MCMC's targets: the dead slots (alive, opacity <= min_opacity or |q|^2 < 1e-8) and
    the free slots that 5% growth up to max_cap claims, in slot order. -> (dead, claim)"""
    o = torch.sigmoid(p["opacity_raw"][:, 0])
    dead = alive & ((o <= opt["min_opacity"]) | ((p["rotation_raw"] ** 2).sum(-1) < 1e-8))
    n = alive.sum().to(torch.float32)
    cap = min(opt["max_cap"], alive.shape[0])
    n_new = max(min(int((1.05 * n).to(torch.int32)), cap) - int(n), 0)
    return dead, ~alive & (torch.cumsum(~alive, 0) <= n_new)


@torch.no_grad()
def mcmc_refine(p: dict, m: dict, v: dict, alive, opt: dict, generator, sources=None):
    """3DGS-MCMC's refinement after a step, as LichtFeld's mcmc.cpp runs it. Relocate:
    each dead slot copies a live source drawn by opacity; the sources' moments are zeroed
    (the dead slots keep theirs). Grow: each claimed slot copies a source drawn by opacity
    among the alive; the claimed slots' moments are zeroed (`refine_targets`). Each draw
    is one `torch.multinomial` over every slot from the run's generator, taken whether or
    not a slot moves. `sources`: [C] source slots (-1: none) that replace the relocation's
    draw where given; the generator draws all the same. -> (params, m, v, alive,
    relocated, grown)"""
    min_op = opt["min_opacity"]
    dead, claim = refine_targets(p, alive, opt)
    o = torch.sigmoid(p["opacity_raw"][:, 0])
    probs = torch.where(alive & ~dead, o, torch.zeros_like(o))
    src = _sample(probs, generator)
    if sources is not None:
        src = torch.where(sources >= 0, sources, src)
    n_dead = int(dead.sum())
    if n_dead and bool((probs > 0).any()):
        p, touched = _move(p, src, dead, min_op)
        m, v = _zero_at(m, touched), _zero_at(v, touched)
    o = torch.sigmoid(p["opacity_raw"][:, 0])
    src = _sample(torch.where(alive, o, torch.zeros_like(o)), generator)
    n_new = int(claim.sum())
    if n_new:
        p, _ = _move(p, src, claim, min_op)
        m, v = _zero_at(m, claim), _zero_at(v, claim)
        alive = alive | claim
    return p, m, v, alive, n_dead, n_new


@torch.no_grad()
def drawn_sources(p: dict, alive, refined_means, opt: dict):
    """The sources that a refinement of the state (`p`, `alive`) drew for its dead slots,
    read from the positions it left (`refined_means`): a relocated slot holds its
    source's position, which no other live slot holds. Growth's draw is not read.
    -> (sources [C], -1 where the slot is not dead or its position matches no live slot;
    the number of such unmatched dead slots)"""
    dead, _ = refine_targets(p, alive, opt)
    live = alive & ~dead
    src = torch.full(alive.shape, -1, dtype=torch.long, device=alive.device)
    unmatched = 0
    for i in torch.nonzero(dead)[:, 0].tolist():
        hit = torch.nonzero((refined_means == refined_means[i]).all(1) & live)[:, 0]
        if hit.numel():
            src[i] = hit[0]
        else:
            unmatched += 1
    return src, unmatched


def train_steps(p: dict, m: dict, v: dict, counts: dict, alive, views: list, first_it: int,
                opt: dict, step: dict, scene_scale: float, generator, features: str = "f32",
                half: bool = False, relocate: bool = True, follow: dict | None = None,
                sources=None):
    """Steps `first_it`, `first_it` + 1, ... over `views` (each (cam, target)), each from
    the last one's output, with MCMC's refinement before each step that follows one it
    falls on (`relocate` False: a planted fault that skips it). `follow`: the state
    (params, m, v, alive) that a side being judged holds after its first step; the
    refinement and the later steps then start from it, not from this chain's own first
    step. `sources`: the relocation's draw, taken as given (`mcmc_refine`).
    -> list of dicts (loss, grads, params, m, v, alive, after each step; relocated: the
    dead slots the refinement before the step moved, or None; refined: the positions it
    left, or None)"""
    out = []
    for j, (cam, target) in enumerate(views):
        it = first_it + j
        if j == 1 and follow is not None:
            p, m, v, alive = follow["params"], follow["m"], follow["v"], follow["alive"]
        relocated = refined = None
        if j and relocate and refining(it - 1, opt):
            p, m, v, alive, relocated, _ = mcmc_refine(p, m, v, alive, opt, generator,
                                                       sources)
            refined = p["means"]
        step_j = dict(step, degree=min(it // opt["sh_degree_interval"], 3))
        loss, grads, _ = loss_and_grads(p, alive, cam, target, step_j, features, half)
        lrs = group_lrs(opt, scene_scale, it)
        p, m, v, counts = adam(p, grads, m, v, counts, lrs, it)
        p = mcmc_noise(p, alive, lrs["means"], generator)
        out.append(dict(loss=loss, grads=grads, params=p, m=m, v=v, alive=alive,
                        relocated=relocated, refined=refined))
    return out


def fov_focal(width: int, fov_deg: float) -> float:
    return 0.5 * width / math.tan(math.radians(fov_deg) / 2)
