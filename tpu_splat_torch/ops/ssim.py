"""SSIM loss: 11x11 Gaussian window, sigma 1.5, valid padding (port of
`tpu_splat/ops/ssim.py`).

Semantics of the reference CUDA kernel (src/training/kernels/ssim.cu:16-41): hardcoded
11-tap Gaussian (sigma=1.5), C1=0.01^2, C2=0.03^2, separable convolution, and "valid" mode
crops the 5-px border from the final mean.

The separable blur is written as 11 shifted adds per direction, as in the JAX package,
and not as `conv2d`: cuDNN runs float32 convolutions in TF32 unless told otherwise, and
the shifted-add form is the exact float32 Gaussian outer product on every device. The
five blurs of one SSIM go through the taps together as one stacked tensor. The blur's
gradient is written out (`_Blur`): the transpose of a valid correlation with a symmetric
kernel is the same blur of the zero-padded cotangent, which saves autograd from keeping
and scattering 22 slices.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

WINDOW = 11
SIGMA = 1.5
C1 = 0.01**2
C2 = 0.03**2


@functools.lru_cache(maxsize=None)
def _gauss_kernel_np() -> np.ndarray:
    x = np.arange(WINDOW) - (WINDOW - 1) / 2.0
    g = np.exp(-(x**2) / (2.0 * SIGMA**2))
    return (g / g.sum()).astype(np.float32)


def _shifted_adds(img: torch.Tensor) -> torch.Tensor:
    """[..., H, W] -> [..., H-10, W-10]: 11 shifted adds along W, then 11 along H."""
    k = [float(w) for w in _gauss_kernel_np()]
    h, w = img.shape[-2:]
    m = WINDOW - 1
    out_w = torch.zeros(img.shape[:-1] + (w - m,), dtype=img.dtype, device=img.device)
    for i, wgt in enumerate(k):
        out_w = torch.add(out_w, img[..., i:w - m + i], alpha=wgt)  # one pass a tap
    out = torch.zeros(img.shape[:-2] + (h - m, w - m), dtype=img.dtype, device=img.device)
    for i, wgt in enumerate(k):
        out = torch.add(out, out_w[..., i:h - m + i, :], alpha=wgt)
    return out


class _Blur(torch.autograd.Function):
    @staticmethod
    def forward(ctx, img):
        return _shifted_adds(img)

    @staticmethod
    def backward(ctx, gout):
        m = WINDOW - 1
        return _shifted_adds(torch.nn.functional.pad(gout, (m, m, m, m)))


def _blur(img: torch.Tensor) -> torch.Tensor:
    """Separable 11x11 Gaussian blur, valid padding. [..., H, W] -> [..., H-10, W-10]."""
    return _Blur.apply(img)


def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean SSIM between [C,H,W] or [B,C,H,W] images, valid padding (reference default:
    `fused_ssim(rendered, gt, "valid", train=true)`, trainer.cpp:123)."""
    if img1.dim() == 3:
        img1, img2 = img1[None], img2[None]

    mu1, mu2, e11, e22, e12 = _blur(
        torch.stack([img1, img2, img1 * img1, img2 * img2, img1 * img2]))
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu12 = mu1 * mu2
    sigma1_sq = e11 - mu1_sq
    sigma2_sq = e22 - mu2_sq
    sigma12 = e12 - mu12

    num = (2.0 * mu12 + C1) * (2.0 * sigma12 + C2)
    den = (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)
    return torch.mean(num / den)
