"""Training losses (port of `tpu_splat/training/losses.py`; trainer.cpp:103-197
semantics, one summed loss).

  photometric = (1-lambda_dssim) * L1 + lambda_dssim * (1 - SSIM_valid)
  scale_reg   = scale_reg * mean(exp(scaling_raw))        over alive slots
  opacity_reg = opacity_reg * mean(sigmoid(opacity_raw))  over alive slots
"""

from __future__ import annotations

import torch

from ..ops.ssim import ssim


def photometric_loss(rendered: torch.Tensor, gt: torch.Tensor, lambda_dssim: float):
    l1 = torch.mean(torch.abs(rendered - gt))
    if not lambda_dssim:  # skip the SSIM blurs entirely when unweighted
        return l1
    ssim_val = ssim(rendered, gt)
    return (1.0 - lambda_dssim) * l1 + lambda_dssim * (1.0 - ssim_val)


def regularization_losses(
    params: dict[str, torch.Tensor], alive: torch.Tensor, scale_reg: float, opacity_reg: float,
    n_alive: torch.Tensor | None = None,
):
    """scale_reg * mean(scaling) + opacity_reg * mean(opacity) (trainer.cpp:133-160).

    `n_alive`: the alive count the means divide by, when `params` are one shard of the
    pool (the batched step's gauss shard: its share of the whole pool's means)."""
    alive_f = alive.to(params["means"].dtype)
    n = torch.clamp_min(torch.sum(alive_f) if n_alive is None else n_alive, 1.0)
    loss = torch.zeros((), dtype=params["means"].dtype, device=alive.device)
    if scale_reg > 0:
        scaling = torch.exp(params["scaling_raw"])  # [C,3]
        loss = loss + scale_reg * torch.sum(scaling * alive_f[:, None]) / (n * 3.0)
    if opacity_reg > 0:
        opacity = torch.sigmoid(params["opacity_raw"][:, 0])
        loss = loss + opacity_reg * torch.sum(opacity * alive_f) / n
    return loss
