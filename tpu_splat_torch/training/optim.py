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
On the card the step is one kernel launch over every trained leaf (`ops/cuda/adam.py`),
bit for bit the chain of elementwise ops it runs on the CPU.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..ops.cuda.adam import adam_kernel

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


IMPLS = ("kernel", "plain")


def _adam_plain(p, g, m, v, lr: float, bc1: float, bc2: float):
    """One leaf's step as a chain of elementwise ops: the plain version of
    `ops/cuda/adam.py::adam_kernel`, which repeats these operations in this order."""
    m2 = BETA1 * m + (1.0 - BETA1) * g
    v2 = BETA2 * v + (1.0 - BETA2) * g * g
    update = float(np.float32(lr)) * (m2 / bc1) / (torch.sqrt(v2 / bc2) + EPS)
    return p - update, m2, v2


def takes_kernel(params: dict[str, torch.Tensor], impl: str) -> bool:
    """Whether `adam_step` launches `adam_kernel`: under `impl="kernel"` on CUDA leaves."""
    return impl == "kernel" and any(p.is_cuda for p in params.values())


@torch.no_grad()
def adam_step(
    params: dict[str, torch.Tensor],
    grads: dict[str, torch.Tensor],
    state: AdamState,
    lrs: dict[str, float],
    iteration: int,
    impl: str = "kernel",  # "plain" runs the chain on any device
) -> tuple[dict[str, torch.Tensor], AdamState]:
    """One Adam step over all six groups. `iteration` is the 1-based train iter. On a CUDA
    device every trained leaf is updated in one launch of `adam_kernel` (it raises on a
    leaf that is not contiguous float32 on the parameters' card); on the CPU and under
    `impl="plain"` each leaf by the chain `_adam_plain`."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    new_c = {k: state.step_count[k] + 1 for k in params}
    # shN frozen for the first 1000 iters, returned as it is; step_count still advances
    # (fused_adam.cpp:66-70: increment precedes the skip).
    trained = [k for k in params if not (k == "shN" and iteration <= SHN_WARMUP_ITERS)]
    args = [[d[k] for k in trained] for d in (params, grads, state.exp_avg, state.exp_avg_sq)]
    lr = [lrs[k] for k in trained]
    bc1 = [_bias_correction(BETA1, new_c[k]) for k in trained]
    bc2 = [_bias_correction(BETA2, new_c[k]) for k in trained]
    if takes_kernel(params, impl):
        outs = zip(*adam_kernel(*args, lr, bc1, bc2))
    else:
        outs = map(_adam_plain, *args, lr, bc1, bc2)
    new_params = dict(params)
    new_m = {k: state.exp_avg[k] for k in params}
    new_v = {k: state.exp_avg_sq[k] for k in params}
    for k, (p2, m2, v2) in zip(trained, outs):
        new_params[k], new_m[k], new_v[k] = p2, m2, v2
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
