"""Carry a splat or train state across the framework boundary as numpy arrays.

`splat_from_numpy(np.asarray(...) of each JAX SplatState field)` builds the port's state
on a device; `splat_to_numpy` is its inverse. `train_state_from_numpy` /
`train_state_to_numpy` do the same for a train state: the splat, Adam's moments and
per-group step counts, the iteration, the ADC densification info and the optional
components (bilateral grids, pose parameters, their Adam states, the ADMM state).
Nothing here imports JAX: the caller does the `np.asarray` on its side.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.splat import PARAM_FIELDS, SplatState
from .device import resolve_device
from .ops.cameras import CameraParams
from .training.optim import AdamState
from .training.sparsity import ADMMState
from .training.train_step import AuxOptState, TrainState, tree_map


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
        k: torch.as_tensor(np.array(params[k], np.float32), device=device)
        for k in PARAM_FIELDS
    }
    return SplatState(
        alive=torch.as_tensor(np.array(alive, bool), device=device),
        max_sh_degree=int(max_sh_degree), scene_scale=float(scene_scale), **tensors,
    )


def splat_to_numpy(state: SplatState) -> tuple[dict[str, np.ndarray], np.ndarray, int]:
    """-> (params, alive, max_sh_degree), the arguments of `splat_from_numpy`."""
    params = {k: v.detach().cpu().numpy() for k, v in state.params().items()}
    return params, state.alive.cpu().numpy(), state.max_sh_degree


def train_state_from_numpy(
    splat_params: dict[str, np.ndarray],
    alive: np.ndarray,
    exp_avg: dict[str, np.ndarray],
    exp_avg_sq: dict[str, np.ndarray],
    step_count: dict[str, int],
    iteration: int,
    *,
    max_sh_degree: int = 3,
    scene_scale: float = 1.0,
    dens_count: np.ndarray | None = None,
    dens_grad2d: np.ndarray | None = None,
    bilateral_grids: np.ndarray | None = None,
    bilateral_opt: dict | None = None,
    pose_params: dict | None = None,
    pose_opt: dict | None = None,
    admm: dict | None = None,
    seed: int = 0,
    device: torch.device | str | None = None,
) -> TrainState:
    """A TrainState on `device` (the CUDA card when None; raises without one) from the
    numpy fields of a JAX TrainState: the densification info (zeros when None) and the
    optional components, each None when off. `pose_params` is the JAX pytree of numpy
    arrays ({"embeddings", "layers": [{"w", "b"}, ...]}); `bilateral_opt` and `pose_opt`
    are dicts {"m", "v", "count"} of an AuxOptState, `admm` {"u", "z"}. The random stream
    does not carry over: the state gets a new `torch.Generator` seeded with `seed`."""
    dev = resolve_device(device)
    splat = splat_from_numpy(splat_params, alive, max_sh_degree, dev, scene_scale)

    def tensor(x):
        return torch.as_tensor(np.array(x, np.float32), device=dev)

    def moments(d):
        return {k: tensor(d[k]) for k in PARAM_FIELDS}

    def aux_opt(d):
        return None if d is None else AuxOptState(
            m=tree_map(tensor, d["m"]), v=tree_map(tensor, d["v"]), count=int(d["count"]))

    def dens(x):
        return (torch.zeros((splat.capacity,), dtype=torch.float32, device=dev)
                if x is None else tensor(x))

    rng = torch.Generator(device=dev)
    rng.manual_seed(seed)
    adam = AdamState(exp_avg=moments(exp_avg), exp_avg_sq=moments(exp_avg_sq),
                     step_count={k: int(step_count[k]) for k in PARAM_FIELDS})
    return TrainState(
        splat=splat, adam=adam, rng=rng, iteration=int(iteration),
        dens_count=dens(dens_count), dens_grad2d=dens(dens_grad2d),
        bilateral_grids=None if bilateral_grids is None else tensor(bilateral_grids),
        bilateral_opt=aux_opt(bilateral_opt),
        pose_params=None if pose_params is None else tree_map(tensor, pose_params),
        pose_opt=aux_opt(pose_opt),
        admm=None if admm is None else ADMMState(u=tensor(admm["u"]), z=tensor(admm["z"])),
    )


def train_state_to_numpy(ts: TrainState) -> dict:
    """-> the keyword fields of `train_state_from_numpy` (without seed and device)."""
    params, alive, degree = splat_to_numpy(ts.splat)

    def arr(t):
        return t.detach().cpu().numpy()

    def moments(d):
        return {k: arr(v) for k, v in d.items()}

    def aux_opt(o):
        return None if o is None else dict(m=tree_map(arr, o.m), v=tree_map(arr, o.v),
                                           count=o.count)

    return dict(
        splat_params=params, alive=alive, exp_avg=moments(ts.adam.exp_avg),
        exp_avg_sq=moments(ts.adam.exp_avg_sq), step_count=dict(ts.adam.step_count),
        iteration=ts.iteration, max_sh_degree=degree, scene_scale=ts.splat.scene_scale,
        dens_count=arr(ts.dens_count), dens_grad2d=arr(ts.dens_grad2d),
        bilateral_grids=None if ts.bilateral_grids is None else arr(ts.bilateral_grids),
        bilateral_opt=aux_opt(ts.bilateral_opt),
        pose_params=None if ts.pose_params is None else tree_map(arr, ts.pose_params),
        pose_opt=aux_opt(ts.pose_opt),
        admm=None if ts.admm is None else dict(u=arr(ts.admm.u), z=arr(ts.admm.z)),
    )


def camera_params_from_numpy(model: str, shutter: str, coeffs: np.ndarray) -> CameraParams:
    """A static CameraParams from a camera model, a shutter type and the 12 distortion
    coefficients (radial6 | tangential2 | thin-prism4): the inverse of
    `CameraParams.coeff_vector`."""
    c = tuple(float(v) for v in np.asarray(coeffs, np.float32).reshape(-1))
    if len(c) != 12:
        raise ValueError(f"expected 12 distortion coefficients, got {len(c)}")
    return CameraParams(model=model, radial=c[0:6], tangential=c[6:8], thin_prism=c[8:12],
                        shutter=shutter)
