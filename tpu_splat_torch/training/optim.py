"""SplatAdam — the six-group Adam + exponential means-LR schedule (port of
`tpu_splat/training/optim.py`).

Reference: `FusedAdam` (src/training/optimizers/fused_adam.{hpp,cpp} + fastgs adam_step_cu):
six param groups {means, sh0, shN, scaling, rotation, opacity} with lrs
{means_lr*scene_scale, shs_lr, shs_lr/20, scaling_lr, rotation_lr, opacity_lr}, betas
(0.9, 0.999), eps 1e-15; shN is not updated for the first 1000 iterations
(fused_adam.cpp:69); an ExponentialLR with gamma = 0.01^(1/iterations) decays ONLY the means
group each step (mcmc.cpp:494-498, scheduler param_group_index 0).

The per-group step counts and the iteration live on the host as Python ints, so the bias
corrections and the means learning rate are host scalars; they are computed in float32,
as the JAX package computes them on the device, so the two agree to rounding. The step is
functional like the JAX one: it returns new parameter and moment tensors and leaves its
inputs untouched (a caller may keep the state of before a step, as the plan probe does).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

BETA1 = 0.9
BETA2 = 0.999
EPS = 1e-15
SHN_WARMUP_ITERS = 1000  # fused_adam.cpp:69

PARAM_ORDER = ("means", "sh0", "shN", "scaling_raw", "rotation_raw", "opacity_raw")


@dataclass
class AdamState:
    exp_avg: dict[str, torch.Tensor]
    exp_avg_sq: dict[str, torch.Tensor]
    step_count: dict[str, int]  # per-group (relocation zeroes moments, not counts)


def init_adam_state(params: dict[str, torch.Tensor]) -> AdamState:
    return AdamState(
        exp_avg={k: torch.zeros_like(v) for k, v in params.items()},
        exp_avg_sq={k: torch.zeros_like(v) for k, v in params.items()},
        step_count={k: 0 for k in params},
    )


def group_lrs(opt_params: Any, scene_scale: float) -> dict[str, float]:
    """Base learning rates per group (mcmc.cpp:487-493)."""
    return {
        "means": opt_params.means_lr * scene_scale,
        "sh0": opt_params.shs_lr,
        "shN": opt_params.shs_lr / 20.0,
        "scaling_raw": opt_params.scaling_lr,
        "rotation_raw": opt_params.rotation_lr,
        "opacity_raw": opt_params.opacity_lr,
    }


def means_lr_at(base_means_lr: float, iteration, total_iterations: int) -> float:
    """ExponentialLR, gamma = 0.01^(1/iterations), means group only (mcmc.cpp:494-498).

    The scheduler steps after each optimizer step, so step i uses gamma^i (0-based).
    A float32 product of float32 factors, returned as a Python float."""
    gamma = 0.01 ** (1.0 / total_iterations)
    return float(np.float32(base_means_lr)
                 * np.power(np.float32(gamma), np.float32(iteration)))


def _bias_correction(beta: float, count: int) -> float:
    return float(np.float32(1.0) - np.power(np.float32(beta), np.float32(count)))


@torch.no_grad()
def adam_step(
    params: dict[str, torch.Tensor],
    grads: dict[str, torch.Tensor],
    state: AdamState,
    lrs: dict[str, float],
    iteration: int,
) -> tuple[dict[str, torch.Tensor], AdamState]:
    """One Adam step over all six groups. `iteration` is the 1-based train iter."""
    new_params, new_m, new_v, new_c = {}, {}, {}, {}
    for k in params:
        m = state.exp_avg[k]
        v = state.exp_avg_sq[k]
        c = state.step_count[k] + 1
        new_c[k] = c
        if k == "shN" and iteration <= SHN_WARMUP_ITERS:
            # shN frozen for the first 1000 iters; step_count still advances
            # (fused_adam.cpp:66-70: increment precedes the skip).
            new_params[k], new_m[k], new_v[k] = params[k], m, v
            continue
        g = grads[k]
        m2 = BETA1 * m + (1.0 - BETA1) * g
        v2 = BETA2 * v + (1.0 - BETA2) * g * g
        bc1 = _bias_correction(BETA1, c)
        bc2 = _bias_correction(BETA2, c)
        update = float(np.float32(lrs[k])) * (m2 / bc1) / (torch.sqrt(v2 / bc2) + EPS)
        new_params[k] = params[k] - update
        new_m[k] = m2
        new_v[k] = v2
    return new_params, AdamState(exp_avg=new_m, exp_avg_sq=new_v, step_count=new_c)


def zero_moments_at(state: AdamState, idx_mask: torch.Tensor) -> AdamState:
    """Zero first/second moments at masked slots (relocation semantics,
    mcmc.cpp:update_optimizer_for_relocate). idx_mask: [C] bool."""

    def z(d):
        out = {}
        for k, v in d.items():
            mask = idx_mask.reshape((-1,) + (1,) * (v.dim() - 1))
            out[k] = torch.where(mask, 0.0, v)
        return out

    return dataclasses.replace(state, exp_avg=z(state.exp_avg), exp_avg_sq=z(state.exp_avg_sq))
