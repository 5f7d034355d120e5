"""MCMC densification strategy ("3D Gaussian Splatting as MCMC"), fixed capacity (port
of `tpu_splat/training/strategy_mcmc.py`).

Reference: src/training/strategies/mcmc.cpp + gsplat/RelocationCUDA.cu. Behavior preserved:

  * relocate_gs (mcmc.cpp:112-190): dead = opacity <= min_opacity or |q|^2 < 1e-8; each dead
    slot is re-seeded from an alive gaussian sampled with replacement with prob ~ opacity;
    the source and its copies all get the MCMC eq.(9) relocation (new opacity
    1-(1-o)^(1/n), scale series correction); optimizer moments are zeroed at the *sampled*
    indices only (the reference's exact quirk — dead slots keep their stale moments).
  * add_new_gs (mcmc.cpp:192-347): grow 5% (capped at max_cap) by claiming dead-pool slots;
    sampled sources relocated with ratio = count+1; claimed slots start with zero moments.
  * inject_noise (mcmc.cpp:349-367, RelocationCUDA.cu:113-146): every step,
    means += lr_means * 5e5 * sigmoid_gate(opacity) * (R S^2 R^T @ eps).
  * is_refining (mcmc.cpp:501-505): strict (start, stop) window, every refine_every.

Capacity is static and relocation/growth are masked scatters, as in the JAX package.
Random draws: every function that draws takes the draw itself as an optional argument
(`eps`, `src`), else draws it from an explicit `torch.Generator`. `jax.random` and torch
give different numbers from the same seed, so a comparison feeds both sides one draw.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core.splat import PARAM_FIELDS, SplatState
from ..ops.quat import quat_to_rotmat
from .optim import AdamState, zero_moments_at

N_MAX = 51  # binomial table size (mcmc.cpp:459-472)
NOISE_LR = 5e5  # mcmc.hpp noise lr multiplier


@functools.lru_cache(maxsize=None)
def _relocation_table() -> np.ndarray:
    """A[n, k] = sum_{i=k+1..n} C(i-1, k): collapses the reference kernel's double loop
    (RelocationCUDA.cu:32-39) into one dot product over k per gaussian."""
    binom = np.zeros((N_MAX, N_MAX), np.float32)
    for i in range(N_MAX):
        b = 1.0
        for k in range(i + 1):
            binom[i, k] = b
            b = b * (i - k) / (k + 1)
    a = np.zeros((N_MAX + 1, N_MAX), np.float32)
    for n in range(1, N_MAX + 1):
        a[n] = a[n - 1]
        a[n, : n] += binom[n - 1, : n]
    return a


def relocation_new_params(opacity, scale, ratio):
    """MCMC eq.(9): (new_opacity, new_scale) for sources sampled `ratio` times.

    opacity [C] sigmoid, scale [C,3] sigma, ratio [C] int in [1, N_MAX].
    """
    dev = opacity.device
    table = torch.as_tensor(_relocation_table(), device=dev)  # [N_MAX+1, N_MAX]
    ratio = torch.clamp(ratio, 1, N_MAX).long()
    new_op = 1.0 - torch.pow(1.0 - opacity, 1.0 / ratio.to(opacity.dtype))

    k = torch.arange(N_MAX, dtype=opacity.dtype, device=dev)  # [K]
    sign = torch.where(k % 2 == 0, 1.0, -1.0) / torch.sqrt(k + 1.0)
    log_op = torch.log(torch.clamp_min(new_op, 1e-12))[:, None]  # [C,1]
    powers = torch.exp(log_op * (k + 1.0)[None, :])  # o^(k+1), [C,K]
    denom = torch.sum(table[ratio] * sign[None, :] * powers, dim=-1)  # [C]
    coeff = opacity / torch.where(denom != 0, denom, 1.0)
    return new_op, coeff[:, None] * scale


def _sample_sources(generator, probs, capacity):
    """One categorical sample per slot, prob ~ probs (multinomial with replacement,
    mcmc.cpp:136-138). All-zero probs (no source) give index 0, which no caller uses."""
    if not bool((probs > 0).any()):
        return torch.zeros((capacity,), dtype=torch.long, device=probs.device)
    return torch.multinomial(probs, capacity, replacement=True, generator=generator)


def _given(x, dtype, device) -> torch.Tensor:
    """A draw handed in by the caller (numpy, possibly read-only, or tensor)."""
    if isinstance(x, np.ndarray):
        x = np.array(x)
    return torch.as_tensor(x, device=device).to(dtype)


def _sources(src, generator, probs, capacity):
    if src is None:
        return _sample_sources(generator, probs, capacity)
    return _given(src, torch.long, probs.device).clamp(0, probs.shape[0] - 1)


def _apply_relocation(state: SplatState, src, target_mask, count_weight,
                      min_opacity: float):
    """Shared core of relocate/add: sources sampled `src[i]` for each target slot i in
    `target_mask`; ratio per source = count_weight + #times sampled; relocation applied at
    sources; all params copied source -> target. New opacities are clamped to
    [min_opacity, 1-1e-7] (mcmc.cpp:164,244)."""
    capacity = state.capacity
    counts = torch.zeros((capacity,), dtype=torch.int32, device=state.device)
    counts.scatter_add_(0, src, target_mask.to(torch.int32))
    touched = counts > 0
    ratio = counts + count_weight

    opacity = torch.sigmoid(state.opacity_raw[:, 0])
    scale = torch.exp(state.scaling_raw)
    new_op, new_scale = relocation_new_params(opacity, scale, ratio)
    new_op = torch.clamp(new_op, min_opacity, 1.0 - 1e-7)

    params = state.params()
    new_opacity_raw = torch.where(
        touched[:, None], torch.log(new_op / (1.0 - new_op))[:, None], params["opacity_raw"]
    )
    new_scaling_raw = torch.where(touched[:, None], torch.log(new_scale),
                                  params["scaling_raw"])
    params = dict(params, opacity_raw=new_opacity_raw, scaling_raw=new_scaling_raw)

    # copy updated source params into target slots
    for k in PARAM_FIELDS:
        v = params[k]
        mask = target_mask.reshape((-1,) + (1,) * (v.dim() - 1))
        params[k] = torch.where(mask, v[src], v)

    return state.replace_params(params), touched


@torch.no_grad()
def relocate_gs(
    state: SplatState, adam: AdamState, min_opacity: float, *, src=None, generator=None
) -> tuple[SplatState, AdamState, torch.Tensor]:
    """Re-seed dead gaussians from alive ones (mcmc.cpp:112-190). `src` [C]: the source
    slot sampled for each slot (drawn from `generator` when None)."""
    opacity = torch.sigmoid(state.opacity_raw[:, 0])
    qnorm2 = torch.sum(state.rotation_raw**2, dim=-1)
    dead = state.alive & ((opacity <= min_opacity) | (qnorm2 < 1e-8))
    alive_src = state.alive & ~dead

    probs = torch.where(alive_src, opacity, 0.0)
    has_sources = torch.any(probs > 0)
    n_dead = torch.sum(dead, dtype=torch.int32)
    do = (n_dead > 0) & has_sources
    dead = dead & do

    src = _sources(src, generator, probs, state.capacity)
    new_state, touched = _apply_relocation(state, src, dead, 1, min_opacity)
    adam = zero_moments_at(adam, touched)
    return new_state, adam, n_dead


@torch.no_grad()
def add_new_gs(
    state: SplatState, adam: AdamState, max_cap: int, min_opacity: float, *, src=None,
    generator=None,
) -> tuple[SplatState, AdamState, torch.Tensor]:
    """Grow by 5% up to max_cap by claiming dead-pool slots (mcmc.cpp:192-347)."""
    cap = min(max_cap, state.capacity)
    n = state.n_alive()
    n_target = torch.clamp_max((1.05 * n.to(torch.float32)).to(torch.int32), cap)
    n_new = torch.clamp_min(n_target - n, 0)

    free_rank = torch.cumsum(~state.alive, 0, dtype=torch.int32)
    claim = (~state.alive) & (free_rank <= n_new)

    opacity = torch.sigmoid(state.opacity_raw[:, 0])
    probs = torch.where(state.alive, opacity, 0.0)
    src = _sources(src, generator, probs, state.capacity)

    new_state, touched = _apply_relocation(state, src, claim, 1, min_opacity)
    new_state = dataclasses.replace(new_state, alive=state.alive | claim)
    # new slots start with zero optimizer state (mcmc.cpp:305-312); sources keep theirs
    adam = zero_moments_at(adam, claim)
    return new_state, adam, n_new


@torch.no_grad()
def inject_noise(state: SplatState, current_means_lr: float, *, eps=None,
                 generator=None) -> SplatState:
    """Covariance-shaped position noise, opacity-gated, every step
    (RelocationCUDA.cu:113-146). `eps` [C, 3]: the standard-normal draw (drawn from
    `generator` when None)."""
    if eps is None:
        eps = torch.randn(state.means.shape, dtype=state.means.dtype, device=state.device,
                          generator=generator)
    else:
        eps = _given(eps, state.means.dtype, state.device)
    rot = quat_to_rotmat(state.rotation_raw)
    var = torch.exp(2.0 * state.scaling_raw)
    # cov @ eps as two matvecs R (S^2 (R^T eps)), without the [N,3,3] covariance
    transformed = torch.einsum("nij,nj->ni", rot, var * torch.einsum("nji,nj->ni", rot, eps))

    opacity = torch.sigmoid(state.opacity_raw[:, 0])
    gate = 1.0 / (1.0 + torch.exp(100.0 * opacity - 0.5))  # RelocationCUDA.cu:139
    factor = current_means_lr * NOISE_LR * gate * state.alive.to(opacity.dtype)
    means = state.means + factor[:, None] * transformed
    return dataclasses.replace(state, means=means)


def is_refining(iteration: int, start: int, stop: int, every: int) -> bool:
    """Strict window (mcmc.cpp:501-505)."""
    return iteration < stop and iteration > start and iteration % every == 0


def refine(
    state: SplatState, adam: AdamState, min_opacity: float, max_cap: int, *, src=None,
    generator=None,
) -> tuple[SplatState, AdamState, torch.Tensor, torch.Tensor]:
    """relocate + grow, one refinement round (mcmc.cpp post_backward when is_refining).
    `src`: the pair (relocation draw, growth draw), each [C], or None to draw both."""
    src_relocate, src_add = (None, None) if src is None else src
    state, adam, n_relocated = relocate_gs(state, adam, min_opacity, src=src_relocate,
                                           generator=generator)
    state, adam, n_new = add_new_gs(state, adam, max_cap, min_opacity, src=src_add,
                                    generator=generator)
    return state, adam, n_relocated, n_new
