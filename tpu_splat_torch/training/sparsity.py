"""ADMM opacity sparsification, port of `tpu_splat/training/sparsity.py` (reference:
src/training/components/sparsity_optimizer.{hpp,cpp}).

Post-training phase appended after the base run: for `sparsify_steps` iterations starting at
`start_iteration` (= base `iterations`), an ADMM penalty drives the lowest opacities toward
zero, then exactly `prune_ratio` of the gaussians are removed:

  loss   = 0.5 * rho * || sigmoid(op) - z + u ||^2        (compute_loss, :46-68)
  update every 50 iters:  z = prune_z(sigmoid(op) + u) ; u += sigmoid(op) - z   (:71-105)
  prune_z(v): keep entries strictly above the `prune_ratio` quantile, zero the rest (:151-168)
  final prune at start+sparsify_steps: bottom prune_ratio by opacity (:107-143)

Fixed-capacity adaptation: u/z are [C] with dead slots ignored; quantile thresholds count
only alive slots (the reference arrays are exactly the alive set). Sorts are stable, as
`jnp.argsort`'s, so ties rank the same way in both packages. Everything stays on the
device: no count is read back to the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class ADMMState:
    u: torch.Tensor  # [C] dual variable
    z: torch.Tensor  # [C] auxiliary sparse variable


def _quantile_index(alive: torch.Tensor, prune_ratio: float) -> torch.Tensor:
    """int(prune_ratio * n_alive) in float32, as a device scalar."""
    n_alive = torch.sum(alive, dtype=torch.int32)
    return (prune_ratio * n_alive.to(torch.float32)).to(torch.int64)


def _prune_z(v: torch.Tensor, alive: torch.Tensor, prune_ratio: float) -> torch.Tensor:
    """Zero all entries <= the prune_ratio quantile among alive slots (:151-168)."""
    index = _quantile_index(alive, prune_ratio)
    big = torch.finfo(v.dtype).max
    masked = torch.where(alive, v, big)  # dead slots sort to the top, never the threshold
    v_sorted = torch.sort(masked, stable=True).values
    threshold = v_sorted[torch.clamp_min(index - 1, 0)]
    keep = (v > threshold) & (index > 0)
    return torch.where(keep & alive, v, 0.0)


def init_admm(opacity_raw: torch.Tensor, alive: torch.Tensor, prune_ratio: float) -> ADMMState:
    """u = 0, z = prune_z(sigmoid(op) + u) (initialize, :18-44)."""
    opa = torch.sigmoid(opacity_raw[:, 0])
    u = torch.zeros_like(opa)
    return ADMMState(u=u, z=_prune_z(opa + u, alive, prune_ratio))


def sparsity_loss(opacity_raw: torch.Tensor, alive: torch.Tensor, state: ADMMState,
                  rho: float) -> torch.Tensor:
    """0.5 * rho * ||sigmoid(op) - z + u||^2 over alive slots (compute_loss, :46-68)."""
    opa = torch.sigmoid(opacity_raw[:, 0])
    diff = (opa - state.z.detach() + state.u.detach()) * alive.to(opa.dtype)
    return 0.5 * rho * torch.sum(diff * diff)


def update_admm(opacity_raw: torch.Tensor, alive: torch.Tensor, state: ADMMState,
                prune_ratio: float) -> ADMMState:
    """z = prune_z(opa + u); u += opa - z (update_state, :71-105)."""
    opa = torch.sigmoid(opacity_raw[:, 0])
    z = _prune_z(opa + state.u, alive, prune_ratio)
    return ADMMState(u=state.u + opa - z, z=z)


def prune_mask(opacity_raw: torch.Tensor, alive: torch.Tensor,
               prune_ratio: float) -> torch.Tensor:
    """Bottom prune_ratio of alive slots by opacity (get_prune_mask, :107-143)."""
    opa = torch.sigmoid(opacity_raw[:, 0])
    n_prune = _quantile_index(alive, prune_ratio)
    masked = torch.where(alive, opa, torch.finfo(opa.dtype).max)
    order = torch.argsort(masked, stable=True)  # ascending: lowest alive opacities first
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(order.shape[0], dtype=order.dtype, device=order.device)
    return alive & (ranks < n_prune)


# Schedule predicates (sparsity_optimizer.hpp:101-118)
def should_update(iteration: int, start: int, sparsify_steps: int,
                  update_every: int = 50) -> bool:
    rel = iteration - start
    return iteration >= start and 0 < rel < sparsify_steps and rel % update_every == 0


def should_apply_loss(iteration: int, start: int, sparsify_steps: int) -> bool:
    return start <= iteration < start + sparsify_steps


def should_prune(iteration: int, start: int, sparsify_steps: int) -> bool:
    return iteration == start + sparsify_steps
