"""A plain float32 PyTorch reference of 3DGUT rendering and training, for the CPU tests of
`tpu_splat_torch`'s GUT path (`tests/test_torch_gut_reference.py`). It imports nothing of
JAX, of the JAX package or of the port: every function here is written from the paper
(3DGUT, Wu et al., CVPR 2025, arXiv:2412.12507) and from the stated choices of the
program it is held against, and runs per pixel and per Gaussian, so it is meant for
scenes of hundreds of Gaussians and images of thousands of pixels.

What it computes:

- the unscented projection: the seven sigma points mu and mu +- sqrt(3 + lambda) s_i
  R[:, i] (the columns of R diag(s), a square root of the covariance R diag(s^2) R^T),
  with alpha 0.1, beta 2, kappa 0, each pushed through the camera model (`project`);
  the image mean and covariance by the unscented weights;
- the projection's tail: a 0.3 px blur with the opacity compensation sqrt(det before /
  det after), the extent min(3.33, sqrt(2 ln(255 o))) standard deviations, and the rect of
  16 px tiles it covers;
- the per-pixel world rays (`pixel_rays`): the OPENCV pixel ray undistorted by
  fixed-point steps, the fisheye ray by Newton steps, parallel orthographic rays with
  per-pixel origins, and a rolling shutter's per-pixel pose;
- the ray blend: for each pixel, each visible Gaussian whose rect holds the pixel's tile,
  in depth order, alpha = min(o exp(-1/2 |n x M (o_ray - mu)|^2), 0.999) with
  M = S^-1 R^T and n = normalise(M d), skipped below 1/255; the pixel stops at the first
  Gaussian that would take its transmittance below 1e-4, which is not blended;
- the train step: 0.8 L1 + 0.2 (1 - SSIM) (11x11 window, sigma 1.5, valid), averaged
  over a batch of cameras, plus scale_reg mean(exp(scale)) and opacity_reg
  mean(sigmoid(opacity)) over live slots, its gradients by autograd, and one Adam step.

Departures from the paper, each the program's stated choice:

- a camera point is valid where z > 0, the OPENCV radial factor exceeds 0.8 (fisheye:
  the angle is within the largest the polynomial inverts), and the image point lies
  within 15% of the image's size of the frame; a Gaussian is projected when any of its
  seven points is valid and its mean's camera z exceeds 0.01;
- the sigma points' offsets, the unscented mean and the rotation matrix (its
  normalisation folded into the quadratic terms as 2 / |q|^2) are computed in the
  program's order of float32 operations: for a Gaussian a few hundredths of a pixel wide
  the unscented covariance is ill-conditioned in float32 (the mean weighs the centre point
  by -99), and another order moves its compensation by up to 5e-4 of itself;
- the depth order is that of the program's packed sort key: the top 31 - b bits of the
  positive float32 depth's bit pattern, b the bits of the tile count, ties by Gaussian
  index (an exact float sort where fewer than 16 bits would be left);
- a ray's origin enters as the camera's position plus the pixel's offset from it (zero
  but under an orthographic camera or a rolling shutter): M (o_ray - mu) is taken as
  M (position - mu) + M (o_ray - position);
- the depth that a pixel accumulates is the camera z of each Gaussian's mean;
- the projection (mean, covariance, compensation, rect) carries no gradient: gradients
  reach the parameters through the ray response and the colours, as in the program;
- the SH colour is 0.5 plus the bands up to the active degree, clamped at 0;
- Adam: betas 0.9 and 0.999, eps 1e-15, the means' rate decayed by 0.01^(i / iterations)
  at the i-th step (0-based), SH rest coefficients frozen for the first 1000 iterations.
"""

from __future__ import annotations

import math

import torch

UT_ALPHA, UT_BETA, UT_KAPPA = 0.1, 2.0, 0.0
EPS2D = 0.3
MAX_EXTENT = 3.33
MIN_ALPHA = 1.0 / 255.0
MAX_ALPHA = 0.999
T_MIN = 1e-4
NEAR = 0.01
MARGIN = 0.15
N_UNDISTORT, N_NEWTON, N_SHUTTER = 20, 10, 10
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525251999, -1.0925484305920792,
         0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
         -0.4570457994644658, 1.445305721320277, -0.5900435899266435)


def camera(w2c, fx, fy, cx, cy, width, height, model="pinhole", coeffs=None,
           shutter="global", pose=None, max_angle=None) -> dict:
    """A camera: `w2c` [4, 4] world to camera, the intrinsics, `model` "pinhole" (OPENCV:
    coefficients k1-k6, p1, p2, s1-s4), "fisheye" (k1-k4) or "ortho", and for a rolling
    `shutter` the `pose` (q_start, t_start, q_end, t_end) of its readout."""
    w2c = torch.as_tensor(w2c, dtype=torch.float32)
    coeffs = [0.0] * 12 if coeffs is None else [float(c) for c in coeffs]
    cam = dict(w2c=w2c, position=-w2c[:3, :3].T @ w2c[:3, 3], fx=float(fx), fy=float(fy),
               cx=float(cx), cy=float(cy), width=int(width), height=int(height), model=model,
               coeffs=coeffs, shutter=shutter,
               pose=None if pose is None else [torch.as_tensor(x, dtype=torch.float32)
                                               for x in pose])
    if model == "fisheye" and max_angle is None:
        max_angle = fisheye_max_angle(coeffs[:4])
    cam["max_angle"] = max_angle
    return cam


def rotmat(q):
    """wxyz quaternions [N, 4] -> rotation matrices [N, 3, 3], the normalisation folded
    into the quadratic terms as 2 / |q|^2 (the 3DGS preprocess's form)."""
    w, x, y, z = q.unbind(-1)
    s = 2.0 / (w * w + x * x + y * y + z * z)
    xx, yy, zz, xy, xz, yz = s * x * x, s * y * y, s * z * z, s * x * y, s * x * z, s * y * z
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    return torch.stack([1 - (yy + zz), xy - wz, wy + xz,
                        wz + xy, 1 - (xx + zz), yz - wx,
                        xz - wy, wx + yz, 1 - (xx + yy)], -1).reshape(q.shape[:-1] + (3, 3))


def quat_rotate(q, v):
    """Rotate v [..., 3] by unit quaternions q [..., 4] (wxyz)."""
    w, u = q[..., :1], q[..., 1:]
    u, v = torch.broadcast_tensors(u, v)
    uv = torch.linalg.cross(u, v)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv))


def slerp(q0, q1, t):
    """Shortest-arc slerp of unit quaternions, t [..., 1]."""
    dot = (q0 * q1).sum(-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    theta = torch.acos(dot.abs().clamp(max=1.0))
    s = torch.sin(theta)
    small = s < 1e-6
    s = torch.where(small, torch.ones_like(s), s)
    w0 = torch.where(small, 1 - t, torch.sin((1 - t) * theta) / s)
    w1 = torch.where(small, t, torch.sin(t * theta) / s)
    q = w0 * q0 + w1 * q1
    return q / q.norm(dim=-1, keepdim=True)


# ----------------------------------------------------------------------- camera models


def _opencv(uv, c):
    """OPENCV distortion of camera-plane points uv [..., 2]: (radial factor, offset).
    Polynomials in Horner's form, as the program evaluates them."""
    k1, k2, k3, k4, k5, k6, p1, p2, s1, s2, s3, s4 = c
    x, y = uv[..., 0], uv[..., 1]
    r2 = x * x + y * y
    radial = (1 + r2 * (k1 + r2 * (k2 + r2 * k3))) / (1 + r2 * (k4 + r2 * (k5 + r2 * k6)))
    xy2 = 2 * x * y
    dx = p1 * xy2 + p2 * (r2 + 2 * x * x) + r2 * (s1 + r2 * s2)
    dy = p1 * (r2 + 2 * y * y) + p2 * xy2 + r2 * (s3 + r2 * s4)
    return radial, torch.stack([dx, dy], -1)


def _theta_d(theta, k):
    t2 = theta * theta
    return theta * (1 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3]))))


def _theta_d_slope(theta, k):
    t2 = theta * theta
    return 1 + t2 * (3 * k[0] + t2 * (5 * k[1] + t2 * (7 * k[2] + t2 * 9 * k[3])))


def fisheye_max_angle(k) -> float:
    """The largest angle up to which the fisheye polynomial rises: its slope's first zero
    on a fine float64 grid, else pi."""
    th = torch.linspace(1e-4, math.pi, 200_001, dtype=torch.float64)
    bad = torch.nonzero(_theta_d_slope(th, k) <= 0)
    return float(th[bad[0, 0]]) if len(bad) else math.pi


def _in_frame(img, cam):
    mx, my = MARGIN * cam["width"], MARGIN * cam["height"]
    return ((img[..., 0] >= -mx) & (img[..., 0] <= cam["width"] + mx)
            & (img[..., 1] >= -my) & (img[..., 1] <= cam["height"] + my))


def _to_image(pc, cam):
    """Camera-space points [..., 3] -> image points [..., 2] and validity."""
    f = torch.tensor([cam["fx"], cam["fy"]])
    c = torch.tensor([cam["cx"], cam["cy"]])
    z = pc[..., 2]
    if cam["model"] == "ortho":
        return pc[..., :2] * f + c, (z > 0) & _in_frame(pc[..., :2] * f + c, cam)
    if cam["model"] == "fisheye":
        k = cam["coeffs"][:4]
        rxy = pc[..., :2].norm(dim=-1).clamp_min(1e-12)
        theta = torch.atan2(rxy, z)
        clipped = theta.clamp(max=cam["max_angle"])
        scale = _theta_d(clipped, k) / rxy
        img = pc[..., :2] * scale[..., None] * f + c
        return img, (z > 0) & (scale > 0) & (theta <= cam["max_angle"]) & _in_frame(img, cam)
    uv = pc[..., :2] / torch.where(z > 0, z, torch.ones_like(z))[..., None]
    radial, offset = _opencv(uv, cam["coeffs"])
    img = (radial[..., None] * uv + offset) * f + c
    return img, (z > 0) & (radial > 0.8) & _in_frame(img, cam)


def _readout_time(img, cam):
    """A rolling shutter's relative readout time of image points, in [0, 1]."""
    x, y, w, h = img[..., 0], img[..., 1], cam["width"], cam["height"]
    t = {"top_to_bottom": torch.floor(y) / (h - 1),
         "left_to_right": torch.floor(x) / (w - 1),
         "bottom_to_top": (h - torch.ceil(y)) / (h - 1),
         "right_to_left": (w - torch.ceil(x)) / (w - 1)}[cam["shutter"]]
    return t.clamp(0.0, 1.0)


def _pose_at(cam, t):
    q0, t0, q1, t1 = cam["pose"]
    t = t[..., None]
    return slerp(q0.expand(t.shape[:-1] + (4,)), q1.expand(t.shape[:-1] + (4,)), t), \
        (1 - t) * t0 + t * t1


def project(pts, cam):
    """World points [..., 3] -> image points [..., 2] and validity. Under a rolling
    shutter each point is projected at the pose of the row (or column) it lands on,
    found by fixed-point steps from the readout's start (or end) pose."""
    if cam["shutter"] == "global" or cam["pose"] is None:
        return _to_image(pts @ cam["w2c"][:3, :3].T + cam["w2c"][:3, 3], cam)
    q0, t0, q1, t1 = cam["pose"]
    img0, ok0 = _to_image(quat_rotate(q0, pts) + t0, cam)
    img1, ok1 = _to_image(quat_rotate(q1, pts) + t1, cam)
    img = torch.where(ok0[..., None], img0, img1)
    for _ in range(N_SHUTTER):
        q, t = _pose_at(cam, _readout_time(img, cam))
        img, _ = _to_image(quat_rotate(q, pts) + t, cam)
    return img, ok0 | ok1


def pixel_rays(cam):
    """World rays of every pixel centre, row-major: origins and unit directions
    [H * W, 3]."""
    ys, xs = torch.meshgrid(torch.arange(cam["height"]), torch.arange(cam["width"]),
                            indexing="ij")
    pix = torch.stack([xs, ys], -1).reshape(-1, 2).float() + 0.5
    f = torch.tensor([cam["fx"], cam["fy"]])
    c = torch.tensor([cam["cx"], cam["cy"]])
    uv0 = (pix - c) / f
    rot = cam["w2c"][:3, :3]
    origin = cam["position"].expand(pix.shape[0], 3)
    if cam["model"] == "ortho":
        d = torch.tensor([0.0, 0.0, 1.0]).expand(pix.shape[0], 3)
        origin = origin + torch.cat([uv0, torch.zeros_like(uv0[:, :1])], -1) @ rot
    elif cam["model"] == "fisheye":
        k, top = cam["coeffs"][:4], cam["max_angle"]
        r = uv0.norm(dim=-1)
        theta = r.clamp(0.0, top)
        for _ in range(N_NEWTON):
            step = (_theta_d(theta, k) - r) / _theta_d_slope(theta, k).clamp_min(1e-6)
            theta = (theta - step).clamp(0.0, top)
        s = torch.where(r > 1e-9, torch.sin(theta) / r.clamp_min(1e-12), torch.zeros_like(r))
        d = torch.cat([uv0 * s[:, None], torch.cos(theta)[:, None]], -1)
    else:
        uv = uv0
        for _ in range(N_UNDISTORT):
            radial, offset = _opencv(uv, cam["coeffs"])
            uv = (uv0 - offset) / radial.clamp_min(1e-6)[:, None]
        d = torch.cat([uv, torch.ones_like(uv[:, :1])], -1)
    d = d / d.norm(dim=-1, keepdim=True)
    if cam["shutter"] == "global" or cam["pose"] is None:
        return origin, d @ rot
    q, t = _pose_at(cam, _readout_time(pix, cam))
    q_inv = q * torch.tensor([1.0, -1.0, -1.0, -1.0])
    return quat_rotate(q_inv, -t), quat_rotate(q_inv, d)


# -------------------------------------------------------------------- UT projection


def sigma_offsets(scale, rot):
    """Row i of [N, 3, 3]: s_i R[:, i], the i-th column of a square root R diag(s) of the
    covariance R diag(s^2) R^T."""
    return scale[:, :, None] * rot.transpose(1, 2)


@torch.no_grad()
def ut_project(p: dict, alive, cam: dict, tile: int = 16) -> dict:
    """The unscented projection of every Gaussian. -> dict(mean2d [N, 2], conic [N, 3]
    (a, b, c of the blurred covariance's inverse), comp, opacity (sigmoid(o) x comp),
    depth, visible, rect [N, 4] (x0, y0, x1, y1), tiles)."""
    lam = UT_ALPHA ** 2 * (3 + UT_KAPPA) - 3
    wm = torch.tensor([lam / (3 + lam)] + [1 / (2 * (3 + lam))] * 6)
    wc = wm.clone()
    wc[0] += 1 - UT_ALPHA ** 2 + UT_BETA
    mu = p["means"]
    spread = torch.sqrt(torch.tensor(3 + lam)) * torch.exp(p["scaling_raw"])
    delta = sigma_offsets(spread, rotmat(p["rotation_raw"]))
    pts = torch.cat([mu[:, None], mu[:, None] + delta, mu[:, None] - delta], 1)
    img, ok = project(pts, cam)
    mean = torch.einsum("s,nsk->nk", wm, img)
    dev = img - mean[:, None]
    cov = torch.einsum("s,nsi,nsj->nij", wc, dev, dev)
    depth = (mu @ cam["w2c"][:3, :3].T + cam["w2c"][:3, 3])[:, 2]
    a, b, c = cov[:, 0, 0] + EPS2D, cov[:, 0, 1], cov[:, 1, 1] + EPS2D
    det0 = cov[:, 0, 0] * cov[:, 1, 1] - cov[:, 0, 1] * cov[:, 1, 0]
    det = a * c - b * b
    safe = torch.where(det > 1e-12, det, torch.ones_like(det))
    comp = torch.sqrt(det0.clamp_min(0.0) / safe)
    opacity = torch.sigmoid(p["opacity_raw"][:, 0]) * comp
    ext = torch.sqrt((2 * torch.log(opacity * 255.0)).clamp_min(0.0)).clamp(max=MAX_EXTENT)
    rx = torch.ceil(ext * a.clamp_min(0.0).sqrt())
    ry = torch.ceil(ext * c.clamp_min(0.0).sqrt())
    gw, gh = -(-cam["width"] // tile), -(-cam["height"] // tile)
    rect = torch.stack([torch.floor((mean[:, 0] - rx) / tile).clamp(0, gw),
                        torch.floor((mean[:, 1] - ry) / tile).clamp(0, gh),
                        torch.ceil((mean[:, 0] + rx) / tile).clamp(0, gw),
                        torch.ceil((mean[:, 1] + ry) / tile).clamp(0, gh)], -1)
    rect = rect.nan_to_num(0.0).long()
    tiles = (rect[:, 2] - rect[:, 0]) * (rect[:, 3] - rect[:, 1])
    visible = (alive & ok.any(1) & (depth > NEAR) & (det > 0) & (opacity >= MIN_ALPHA)
               & (rx > 0) & (ry > 0) & (tiles > 0))
    return dict(mean2d=mean, conic=torch.stack([c / safe, -b / safe, a / safe], -1),
                comp=comp, opacity=opacity, depth=depth, visible=visible, rect=rect,
                tiles=torch.where(visible, tiles, torch.zeros_like(tiles)))


# ---------------------------------------------------------------------------- blend


def sh_color(sh0, shN, dirs, degree: int):
    """0.5 + the real SH bands up to `degree` in the unit view direction [N, 3]."""
    x, y, z = (dirs / dirs.norm(dim=-1, keepdim=True).clamp_min(1e-12)).unbind(-1)
    x, y, z = x[:, None], y[:, None], z[:, None]
    out = 0.5 + SH_C0 * sh0[:, 0]
    if degree >= 1:
        out = out - SH_C1 * y * shN[:, 0] + SH_C1 * z * shN[:, 1] - SH_C1 * x * shN[:, 2]
    xx, yy, zz = x * x, y * y, z * z
    if degree >= 2:
        out = (out + SH_C2[0] * x * y * shN[:, 3] + SH_C2[1] * y * z * shN[:, 4]
               + SH_C2[2] * (2 * zz - xx - yy) * shN[:, 5] + SH_C2[3] * x * z * shN[:, 6]
               + SH_C2[4] * (xx - yy) * shN[:, 7])
    if degree >= 3:
        out = (out + SH_C3[0] * y * (3 * xx - yy) * shN[:, 8]
               + SH_C3[1] * x * y * z * shN[:, 9]
               + SH_C3[2] * y * (4 * zz - xx - yy) * shN[:, 10]
               + SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * shN[:, 11]
               + SH_C3[4] * x * (4 * zz - xx - yy) * shN[:, 12]
               + SH_C3[5] * z * (xx - yy) * shN[:, 13]
               + SH_C3[6] * x * (xx - 3 * yy) * shN[:, 14])
    return out


def depth_order(depth, n_tiles: int):
    """Indices in the program's depth order: the packed key's depth bits, ties by index."""
    db = 31 - max(int(n_tiles).bit_length(), 1)
    if db < 16:
        return torch.sort(depth, stable=True).indices
    key = depth.clamp_min(0.0).contiguous().view(torch.int32) >> (31 - db)
    return torch.sort(key, stable=True).indices


def render(p: dict, alive, cam: dict, degree: int, bg=None, tile: int = 16) -> dict:
    """The differentiable 3DGUT frame. -> dict(image [3, H, W] (over `bg` when given),
    alpha [H, W], depth [H, W] (the accumulated camera z), ut (the projection))."""
    ut = ut_project(p, alive, cam, tile)
    h, w = cam["height"], cam["width"]
    gw, gh = -(-w // tile), -(-h // tile)
    order = depth_order(ut["depth"], gw * gh)
    order = order[ut["visible"][order]]
    m = rotmat(p["rotation_raw"]).transpose(1, 2) * torch.exp(-p["scaling_raw"])[:, :, None]
    op = torch.sigmoid(p["opacity_raw"][:, 0]) * ut["comp"]
    color = sh_color(p["sh0"], p["shN"], p["means"] - cam["position"], degree).clamp_min(0.0)
    origin, d = pixel_rays(cam)  # [P, 3]
    offset = origin - cam["position"]
    ty = torch.arange(h)[:, None].expand(h, w).reshape(-1) // tile
    tx = torch.arange(w)[None, :].expand(h, w).reshape(-1) // tile

    trans = torch.ones(h * w)
    going = torch.ones(h * w, dtype=torch.bool)
    rgb = torch.zeros(h * w, 3)
    dep = torch.zeros(h * w)
    for g in order.tolist():
        x0, y0, x1, y1 = ut["rect"][g].tolist()
        inside = (tx >= x0) & (tx < x1) & (ty >= y0) & (ty < y1)
        md = d @ m[g].T
        n = md / md.norm(dim=-1, keepdim=True).clamp_min(1e-12)
        gro = m[g] @ (cam["position"] - p["means"][g]) + offset @ m[g].T
        power = -0.5 * torch.linalg.cross(n, gro).pow(2).sum(-1)
        alpha = (op[g] * torch.exp(power)).clamp(max=MAX_ALPHA)
        valid = inside & (alpha >= MIN_ALPHA)
        after = trans * (1 - alpha)
        going = going & ~(valid & (after < T_MIN))
        use = valid & going
        weight = torch.where(use, trans * alpha, torch.zeros_like(alpha))
        rgb = rgb + weight[:, None] * color[g]
        dep = dep + weight * ut["depth"][g]
        trans = torch.where(use, after, trans)
    alpha_img = (1 - trans).reshape(h, w)
    image = rgb.T.reshape(3, h, w)
    if bg is not None:
        image = image + (1 - alpha_img)[None] * torch.as_tensor(bg).reshape(3, 1, 1)
    return dict(image=image, alpha=alpha_img, depth=dep.reshape(h, w), ut=ut)


# ------------------------------------------------------------------------ train step


def ssim(a, b):
    """Mean SSIM of two [3, H, W] images: 11x11 Gaussian window (sigma 1.5), valid."""
    x = torch.arange(11, dtype=torch.float64) - 5
    g = torch.exp(-x * x / (2 * 1.5 ** 2))
    g = (g / g.sum()).float()
    win = (g[:, None] * g[None, :]).expand(3, 1, 11, 11)
    blur = lambda t: torch.nn.functional.conv2d(t[None], win, groups=3)[0]  # noqa: E731
    mu_a, mu_b = blur(a), blur(b)
    var_a = blur(a * a) - mu_a ** 2
    var_b = blur(b * b) - mu_b ** 2
    cov = blur(a * b) - mu_a * mu_b
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    return (((2 * mu_a * mu_b + c1) * (2 * cov + c2))
            / ((mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2))).mean()


def loss(p: dict, alive, cams: list, targets: list, degree: int, bg=None,
         lambda_dssim=0.2, scale_reg=0.01, opacity_reg=0.01, tile: int = 16):
    """The train step's loss over a batch of cameras (the mean of their photometric
    losses, plus the regularisers once) and the frames it was computed on."""
    outs = [render(p, alive, cam, degree, bg, tile) for cam in cams]
    value = sum((1 - lambda_dssim) * (o["image"] - t).abs().mean()
                + lambda_dssim * (1 - ssim(o["image"], t))
                for o, t in zip(outs, targets)) / len(cams)
    live = alive.float()
    n = live.sum().clamp_min(1.0)
    value = value + scale_reg * (torch.exp(p["scaling_raw"]) * live[:, None]).sum() / (3 * n)
    value = value + opacity_reg * (torch.sigmoid(p["opacity_raw"][:, 0]) * live).sum() / n
    return value, outs


def adam(p: dict, grads: dict, m: dict, v: dict, counts: dict, lrs: dict, iteration: int,
         total_iterations: int):
    """One Adam step of every group at 1-based `iteration`; `lrs` are the groups' base
    rates. -> (parameters, first moments, second moments, step counts)."""
    new_p, new_m, new_v, new_c = {}, {}, {}, {}
    for k in p:
        c = counts[k] + 1
        new_c[k] = c
        if k == "shN" and iteration <= 1000:
            new_p[k], new_m[k], new_v[k] = p[k], m[k], v[k]
            continue
        lr = lrs[k] * (0.01 ** ((iteration - 1) / total_iterations) if k == "means" else 1.0)
        new_m[k] = 0.9 * m[k] + 0.1 * grads[k]
        new_v[k] = 0.999 * v[k] + 0.001 * grads[k] ** 2
        step = (new_m[k] / (1 - 0.9 ** c)) / (torch.sqrt(new_v[k] / (1 - 0.999 ** c)) + 1e-15)
        new_p[k] = p[k] - lr * step
    return new_p, new_m, new_v, new_c


def train_step(p: dict, alive, m: dict, v: dict, counts: dict, cams: list, targets: list,
               iteration: int, total_iterations: int, lrs: dict, degree: int, bg=None,
               **loss_kw):
    """Loss over the cameras `cams` (their `targets`), its gradients by autograd, and one
    Adam step. -> dict(loss, grads, params, exp_avg, exp_avg_sq, counts, images)."""
    leaves = {k: t.detach().clone().requires_grad_(True) for k, t in p.items()}
    value, outs = loss(leaves, alive, cams, targets, degree, bg, **loss_kw)
    grads = dict(zip(leaves, torch.autograd.grad(value, list(leaves.values()),
                                                 allow_unused=True)))
    grads = {k: torch.zeros_like(p[k]) if g is None else g for k, g in grads.items()}
    new_p, new_m, new_v, new_c = adam({k: t.detach() for k, t in p.items()}, grads, m, v,
                                      counts, lrs, iteration, total_iterations)
    return dict(loss=value.detach(), grads=grads, params=new_p, exp_avg=new_m,
                exp_avg_sq=new_v, counts=new_c, images=[o["image"].detach() for o in outs])
