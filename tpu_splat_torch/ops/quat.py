"""Quaternion utilities (port of `tpu_splat/ops/quat.py`; reference: fastgs preprocess quat
math, kernels_forward.cuh:79-95)."""

from __future__ import annotations

import torch


def _scaled_products(q: torch.Tensor, eps: float):
    qr, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = torch.clamp_min(qr * qr + qx * qx + qy * qy + qz * qz, eps)
    s = 2.0 / n
    xx, yy, zz = s * qx * qx, s * qy * qy, s * qz * qz
    xy, xz, yz = s * qx * qy, s * qx * qz, s * qy * qz
    rx, ry, rz = s * qr * qx, s * qr * qy, s * qr * qz
    return xx, yy, zz, xy, xz, yz, rx, ry, rz


def quat_to_rotmat_cols(q: torch.Tensor, eps: float = 1e-8):
    """Rotation-matrix entries as nine flat [...] columns, row-major tuple-of-tuples.

    Normalization is folded in by dividing the quadratic terms by |q|^2, exactly as the
    reference preprocess does (kernels_forward.cuh:82-95); degenerate |q|^2 < eps is the
    caller's cull condition and is clamped here to stay finite."""
    xx, yy, zz, xy, xz, yz, rx, ry, rz = _scaled_products(q, eps)
    return (
        (1.0 - (yy + zz), xy - rz, ry + xz),
        (rz + xy, 1.0 - (xx + zz), yz - rx),
        (xz - ry, rx + yz, 1.0 - (xx + yy)),
    )


def quat_to_rotmat(q: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Unnormalized wxyz quaternion [..., 4] -> rotation matrix [..., 3, 3]."""
    cols = quat_to_rotmat_cols(q, eps)
    m = torch.stack([c for row in cols for c in row], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_scale_to_covar(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(quat [..., 4], scale sigma [..., 3]) -> 3D covariance R S^2 R^T [..., 3, 3]."""
    r = quat_to_rotmat(q)
    rs = r * (scales[..., None, :] ** 2)  # R @ diag(s^2)
    return rs @ r.transpose(-1, -2)
