"""Default (ADC) densification strategy — original-3DGS adaptive density control, port of
`tpu_splat/training/strategy_default.py`.

Reference: src/training/strategies/default_strategy.cpp. Behavior preserved:

  * densification info (default_strategy.cpp:164-166, kernels_backward.cuh:232-236):
    per-primitive count of visible steps and accumulated NDC-scaled screen-grad magnitude
    ||dL/dmean2d * (0.5 W, 0.5 H)||; averaged at refine time; reset after each refine.
  * grow_gs (:164-192): candidates with avg grad > grad_threshold; duplicate if
    max(scale) <= grow_scale3d * scene_scale, else split into 2 children at
    mean + R @ (scale * eps), scale/1.6 (:87-162). Duplicates copy params and get
    zero optimizer moments; BOTH split children get zero moments and the original is
    replaced by child A. Optional revised_opacity: 1 - sqrt(1 - opacity) (:124-127).
  * prune_gs (:229-249): opacity < prune_opacity, degenerate quat (|q|^2 < 1e-8), and —
    only after the first opacity reset (iter > reset_every) — max(scale) >
    prune_scale3d * scene_scale.
  * reset_opacity (:251-290): every reset_every iters clamp opacity_raw to
    logit(2 * prune_opacity) and zero the opacity group's optimizer moments.
  * is_refining (:31-35): iter > start_refine, iter % refine_every == 0,
    iter % reset_every >= pause_refine_after_reset; post_backward is a no-op at
    iter >= stop_refine (:292-305).

Capacity is static, as in the JAX package: duplicates and split children claim dead-pool
slots by rank, pruning clears `alive`, everything is a masked scatter, and no count is
read back to the host. When the free pool cannot hold every candidate, the
highest-gradient candidates win, the free slots going in ascending order to the granted
candidates best first (ties broken by slot index: a stable sort, as `jnp.argsort`'s).
The Trainer keeps that case away: before each refinement it moves the state into a larger
pool when the candidates (`grad_candidates`) outnumber the free slots
(`training/trainer.py`), so every candidate is granted, as LichtFeld's appends grant them.

Two faults of the JAX version are not copied (ROADMAP.md Queue 3). Its `_claim_free_slots`
pads the free-slot list with slot C-1 and scatters with duplicate indices, so the last
slot is never granted; and it derives `did_split` by a scatter in which a candidate's
index is written twice, so a split whose free slot lies below its candidate loses child A.
Here only granted ranks are written (every slot index at most once), and `did_split` is
set from the granted candidates themselves.

Random draws: the split offsets' standard normals come from `eps` [2, C, 3] when given,
else from an explicit `torch.Generator`.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.splat import PARAM_FIELDS, SplatState
from ..ops.quat import quat_to_rotmat
from .optim import AdamState, zero_moments_at
from .strategy_mcmc import _given


def is_refining(iteration: int, start: int, stop: int, every: int, reset_every: int,
                pause_after_reset: int) -> bool:
    """default_strategy.cpp:31-35 plus the stop_refine gate in post_backward (:292-299)."""
    return (
        iteration < stop
        and iteration > start
        and iteration % every == 0
        and iteration % reset_every >= pause_after_reset
    )


def accumulate_densification(
    count: torch.Tensor,  # [C] f32
    grad2d: torch.Tensor,  # [C] f32
    mean2d_grads: torch.Tensor,  # [C, 2]
    visible: torch.Tensor,  # [C] bool
    width: int,
    height: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One step of _densification_info accumulation (kernels_backward.cuh:232-236)."""
    vis = visible.to(count.dtype)
    gx = mean2d_grads[:, 0] * (0.5 * width)
    gy = mean2d_grads[:, 1] * (0.5 * height)
    # the JAX package's norm rounds gx^2 and adds gy^2 in one fused multiply-add, then
    # takes a correctly rounded float32 square root; here both in float64 (gy^2 is exact
    # there, 48 bits) and rounded to float32: PyTorch's vectorised float32 sqrt on the
    # CPU is not correctly rounded
    sq = ((gx * gx).double() + gy.double() * gy.double()).to(gx.dtype)
    mag = torch.sqrt(sq.double()).to(gx.dtype)
    return count + vis, grad2d + vis * mag


def grad_candidates(alive: torch.Tensor, dens_count: torch.Tensor, dens_grad2d: torch.Tensor,
                    grad_threshold: float) -> torch.Tensor:
    """The slots a refinement grows from (duplicate or split): alive, with an average
    screen gradient above `grad_threshold` (the test of `grow_gs` on `refine`'s average)."""
    return alive & (dens_grad2d / torch.clamp_min(dens_count, 1.0) > grad_threshold)


def claim_free_slots(alive: torch.Tensor, want: torch.Tensor, priority: torch.Tensor):
    """Assign free slots to `want` candidates, highest `priority` first: the r-th free slot
    (ascending) serves the r-th candidate, for r below min(#candidates, #free slots).

    Returns (src_for_slot [C] int64, claimed [C] bool, granted [C] bool): for each claimed
    slot the candidate it serves (unclaimed slots map to themselves), and the candidates
    that got a slot."""
    capacity = alive.shape[0]
    free = ~alive
    key = torch.where(want, priority, -torch.inf)
    cand_order = torch.argsort(-key, stable=True)  # candidate indices, best first
    n_grant = torch.minimum(torch.sum(want, dtype=torch.int64),
                            torch.sum(free, dtype=torch.int64))
    slots = torch.arange(capacity, device=alive.device)
    free_rank = torch.cumsum(free, 0) - 1  # rank of each free slot among the free ones
    claimed = free & (free_rank < n_grant)
    src_for_slot = torch.where(claimed, cand_order[free_rank.clamp_min(0)], slots)
    # cand_order is a permutation: each candidate index is written once
    granted = torch.zeros_like(want).scatter_(0, cand_order, slots < n_grant)
    return src_for_slot, claimed, granted


def _scatter_from(params: dict, src_for_slot: torch.Tensor, claimed: torch.Tensor) -> dict:
    out = {}
    for k in PARAM_FIELDS:
        v = params[k]
        mask = claimed.reshape((-1,) + (1,) * (v.dim() - 1))
        out[k] = torch.where(mask, v[src_for_slot], v)
    return out


@torch.no_grad()
def grow_gs(
    state: SplatState,
    adam: AdamState,
    avg_grad: torch.Tensor,  # [C]
    grad_threshold: float,
    grow_scale3d: float,
    revised_opacity: bool,
    *,
    eps=None,  # [2, C, 3] standard normals for the split offsets; drawn when None
    generator: torch.Generator | None = None,
) -> tuple[SplatState, AdamState, torch.Tensor, torch.Tensor]:
    """duplicate + split (default_strategy.cpp:49-191). -> (state, adam, n_dup, n_split)"""
    capacity = state.capacity
    scaling = torch.exp(state.scaling_raw)
    max_scale = torch.amax(scaling, dim=-1)

    is_grad_high = state.alive & (avg_grad > grad_threshold)
    is_small = max_scale <= grow_scale3d * state.scene_scale
    is_dup = is_grad_high & is_small
    is_split = is_grad_high & ~is_small

    # ---- duplicates: each claims one free slot, exact param copy, zero moments at the copy
    src_dup, claimed_dup, _ = claim_free_slots(state.alive, is_dup, avg_grad)
    params = _scatter_from(state.params(), src_dup, claimed_dup)
    alive = state.alive | claimed_dup
    adam = zero_moments_at(adam, claimed_dup)
    n_dup = torch.sum(claimed_dup, dtype=torch.int32)

    # ---- splits: child B claims a free slot; child A overwrites the original slot.
    # Only splits whose second child got a slot happen at all (capacity-capped).
    src_split, claimed_split, did_split = claim_free_slots(alive, is_split, avg_grad)

    rot = quat_to_rotmat(params["rotation_raw"])  # [C,3,3]
    if eps is None:
        eps = torch.randn((2, capacity, 3), dtype=params["means"].dtype,
                          device=state.device, generator=generator)
    else:
        eps = _given(eps, params["means"].dtype, state.device)
    offsets = torch.einsum("nij,bnj->bni", rot, scaling[None] * eps)  # [2,C,3]

    new_scaling_raw = torch.log(torch.clamp_min(scaling / 1.6, 1e-30))
    if revised_opacity:
        op = torch.sigmoid(params["opacity_raw"])
        new_op = torch.clamp(1.0 - torch.sqrt(torch.clamp_min(1.0 - op, 0.0)),
                             1e-7, 1.0 - 1e-7)
        new_opacity_raw = torch.log(new_op / (1.0 - new_op))
    else:
        new_opacity_raw = params["opacity_raw"]

    # child A in place at the original slot
    mask_a = did_split[:, None]
    params_a = dict(params)
    params_a["means"] = torch.where(mask_a, params["means"] + offsets[0], params["means"])
    params_a["scaling_raw"] = torch.where(mask_a, new_scaling_raw, params["scaling_raw"])
    params_a["opacity_raw"] = torch.where(mask_a, new_opacity_raw, params["opacity_raw"])

    # child B at the claimed slot, from the ORIGINAL params
    donor = dict(params, means=params["means"] + offsets[1], scaling_raw=new_scaling_raw,
                 opacity_raw=new_opacity_raw)
    params_b = _scatter_from(donor, src_split, claimed_split)
    final_params = {
        k: torch.where(claimed_split.reshape((-1,) + (1,) * (params_a[k].dim() - 1)),
                       params_b[k], params_a[k])
        for k in PARAM_FIELDS
    }

    alive = alive | claimed_split
    # both children get zero moments (split output moments are zeros, :137-145)
    adam = zero_moments_at(adam, did_split | claimed_split)
    n_split = torch.sum(did_split, dtype=torch.int32)

    new_state = dataclasses.replace(state.replace_params(final_params), alive=alive)
    return new_state, adam, n_dup, n_split


@torch.no_grad()
def prune_gs(state: SplatState, iteration: int, prune_opacity: float, prune_scale3d: float,
             reset_every: int) -> tuple[SplatState, torch.Tensor]:
    """Clear `alive` on pruned slots (default_strategy.cpp:229-249)."""
    opacity = torch.sigmoid(state.opacity_raw[:, 0])
    qnorm2 = torch.sum(state.rotation_raw**2, dim=-1)
    is_prune = (opacity < prune_opacity) | (qnorm2 < 1e-8)
    if iteration > reset_every:
        max_scale = torch.amax(torch.exp(state.scaling_raw), dim=-1)
        is_prune = is_prune | (max_scale > prune_scale3d * state.scene_scale)
    is_prune = is_prune & state.alive
    n = torch.sum(is_prune, dtype=torch.int32)
    return dataclasses.replace(state, alive=state.alive & ~is_prune), n


@torch.no_grad()
def reset_opacity(state: SplatState, adam: AdamState,
                  prune_opacity: float) -> tuple[SplatState, AdamState]:
    """Clamp opacities to 2*prune_opacity, zero opacity moments (:251-290)."""
    threshold = 2.0 * prune_opacity
    logit_thr = torch.log(torch.tensor(threshold / (1.0 - threshold), dtype=torch.float32))
    new_raw = torch.clamp_max(state.opacity_raw, float(logit_thr))
    state = dataclasses.replace(state, opacity_raw=new_raw)
    adam = dataclasses.replace(
        adam,
        exp_avg=dict(adam.exp_avg, opacity_raw=torch.zeros_like(adam.exp_avg["opacity_raw"])),
        exp_avg_sq=dict(adam.exp_avg_sq,
                        opacity_raw=torch.zeros_like(adam.exp_avg_sq["opacity_raw"])),
    )
    return state, adam


def remove_gaussians(state: SplatState, mask: torch.Tensor) -> SplatState:
    """IStrategy::remove_gaussians (istrategy.hpp:29): clear alive where mask."""
    return dataclasses.replace(state, alive=state.alive & ~mask)


def refine(
    state: SplatState,
    adam: AdamState,
    dens_count: torch.Tensor,  # [C]
    dens_grad2d: torch.Tensor,  # [C]
    iteration: int,
    *,
    grad_threshold: float,
    grow_scale3d: float,
    prune_opacity: float,
    prune_scale3d: float,
    reset_every: int,
    revised_opacity: bool,
    eps=None,
    generator: torch.Generator | None = None,
) -> tuple[SplatState, AdamState, dict]:
    """One grow+prune round (post_backward when is_refining, :301-309). The counts in the
    returned dict are device tensors."""
    avg_grad = dens_grad2d / torch.clamp_min(dens_count, 1.0)
    state, adam, n_dup, n_split = grow_gs(
        state, adam, avg_grad, grad_threshold, grow_scale3d, revised_opacity, eps=eps,
        generator=generator,
    )
    state, n_pruned = prune_gs(state, iteration, prune_opacity, prune_scale3d, reset_every)
    info = {"n_dup": n_dup, "n_split": n_split, "n_pruned": n_pruned,
            "n_alive": state.n_alive()}
    return state, adam, info
