"""Carry a splat state across the framework boundary as numpy arrays.

`splat_from_numpy(np.asarray(...) of each JAX SplatState field)` builds the port's state
on a device; `splat_to_numpy` is its inverse. Nothing here imports JAX: the caller does
the `np.asarray` on its side.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.splat import PARAM_FIELDS, SplatState


def splat_from_numpy(
    params: dict[str, np.ndarray],
    alive: np.ndarray,
    max_sh_degree: int,
    device: torch.device | str,
    scene_scale: float = 1.0,
) -> SplatState:
    missing = set(PARAM_FIELDS) - set(params)
    if missing:
        raise KeyError(f"missing splat parameters: {sorted(missing)}")
    tensors = {
        k: torch.as_tensor(np.ascontiguousarray(params[k], np.float32), device=device)
        for k in PARAM_FIELDS
    }
    return SplatState(
        alive=torch.as_tensor(np.asarray(alive, bool), device=device),
        max_sh_degree=int(max_sh_degree), scene_scale=float(scene_scale), **tensors,
    )


def splat_to_numpy(state: SplatState) -> tuple[dict[str, np.ndarray], np.ndarray, int]:
    """-> (params, alive, max_sh_degree), the arguments of `splat_from_numpy`."""
    params = {k: v.detach().cpu().numpy() for k, v in state.params().items()}
    return params, state.alive.cpu().numpy(), state.max_sh_degree
