"""Spherical-harmonics color evaluation, degree <= 4 (port of `tpu_splat/ops/sh.py`).

Degrees <= 3 match `convert_sh_to_color` (fastgs/rasterization/include/kernel_utils.cuh:
15-39); degree 4 is the Sloan fast basis (gsplat/SphericalHarmonicsCUDA.cu:76-103), term by
term as in the JAX version. View direction = normalize(mean - cam_pos), color = 0.5 + sum
over the active bands. A band is present when `shN` holds its coefficients (3, 8, 15, 24
rest coefficients for degrees 1-4) and counts when the active degree reaches it. JAX
multiplies a band above the active degree by 0.0; here the degree is a host int, so that
band is not added at all, which gives the same sum and a zero gradient for its
coefficients (the bands are finite: the direction is a safe normalize).
"""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.48860251190291987
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525251999,
         -1.0925484305920792, 0.54627421529603959)
SH_C3 = (0.59004358992664352, 2.8906114426405538, 0.45704579946446572,
         0.3731763325901154, 1.4453057213202769)
SH_BAND_COEFFS = (3, 8, 15, 24)  # rest coefficients a slot of the bands up to degree 1-4


def sh_bands(active_sh_degree: int, sh_rest: int) -> int:
    """The SH degree `sh_to_color` evaluates: the highest band up to `active_sh_degree` whose
    coefficients `shN` holds (`sh_rest` of them a slot); every lower band with it."""
    deg = 0
    for d, need in enumerate(SH_BAND_COEFFS, start=1):
        if int(active_sh_degree) >= d and sh_rest >= need:
            deg = d
    return deg


def sh_to_color(
    sh0: torch.Tensor,  # [N, 1, 3]
    shN: torch.Tensor,  # [N, K-1, 3] (K-1 >= 15 for degree 3, >= 24 for degree 4)
    dirs: torch.Tensor,  # [N, 3] unnormalized (mean - cam_pos)
    active_sh_degree: int,
) -> torch.Tensor:
    """RGB [N, 3] = 0.5 + SH(dir); NOT clamped here — the blend clamps >= 0."""
    deg = sh_bands(active_sh_degree, shN.shape[1])
    # Safe normalize: dirs can be exactly 0 for dead/degenerate slots
    norm_sq = torch.sum(dirs * dirs, dim=-1, keepdim=True)
    d = dirs * torch.rsqrt(torch.clamp_min(norm_sq, 1e-24))
    x, y, z = d[..., 0:1], d[..., 1:2], d[..., 2:3]  # [N,1]

    result = 0.5 + SH_C0 * sh0[:, 0, :]
    c = shN  # [N, K-1, 3]
    if deg >= 1:
        b1 = (-SH_C1 * y) * c[:, 0] + (SH_C1 * z) * c[:, 1] + (-SH_C1 * x) * c[:, 2]
        result = result + b1

    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    if deg >= 2:
        b2 = (
            (SH_C2[0] * xy) * c[:, 3]
            + (SH_C2[1] * yz) * c[:, 4]
            + (0.94617469575755997 * zz - SH_C2[2]) * c[:, 5]
            + (SH_C2[3] * xz) * c[:, 6]
            + (SH_C2[4] * xx - SH_C2[4] * yy) * c[:, 7]
        )
        result = result + b2

    if deg >= 3:
        b3 = (
            (SH_C3[0] * y * (-3.0 * xx + yy)) * c[:, 8]
            + (SH_C3[1] * xy * z) * c[:, 9]
            + (SH_C3[2] * y * (1.0 - 5.0 * zz)) * c[:, 10]
            + (SH_C3[3] * z * (5.0 * zz - 3.0)) * c[:, 11]
            + (SH_C3[2] * x * (1.0 - 5.0 * zz)) * c[:, 12]
            + (SH_C3[4] * z * (xx - yy)) * c[:, 13]
            + (SH_C3[0] * x * (-xx + 3.0 * yy)) * c[:, 14]
        )
        result = result + b3

    if deg >= 4:
        # degree 4 (Sloan fast basis, gsplat/SphericalHarmonicsCUDA.cu:76-103)
        fc1 = xx - yy
        fs1 = 2.0 * xy
        fc2 = x * fc1 - y * fs1
        fs2 = x * fs1 + y * fc1
        fc3 = x * fc2 - y * fs2
        fs3 = x * fs2 + y * fc2
        tmp0d = z * (-4.683325804901025 * zz + 2.007139630671868)
        tmp1c = 3.31161143515146 * zz - 0.47308734787878
        tmp2b = -1.770130769779931 * z
        psh6 = 0.9461746957575601 * zz - 0.3153915652525201
        psh12 = z * (1.865881662950577 * zz - 1.119528997770346)
        b4 = (
            (0.6258357354491763 * fs3) * c[:, 15]
            + (tmp2b * fs2) * c[:, 16]
            + (tmp1c * fs1) * c[:, 17]
            + (tmp0d * y) * c[:, 18]
            + (1.984313483298443 * z * psh12 - 1.006230589874905 * psh6) * c[:, 19]
            + (tmp0d * x) * c[:, 20]
            + (tmp1c * fc1) * c[:, 21]
            + (tmp2b * fc2) * c[:, 22]
            + (0.6258357354491763 * fc3) * c[:, 23]
        )
        result = result + b4
    return result
