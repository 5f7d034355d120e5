"""The train step: render -> loss -> backward -> Adam -> MCMC noise (port of
`tpu_splat/training/train_step.py`, its default configuration).

Mirrors Trainer::train_step fast path (src/training/trainer.cpp:579-858) as one function
(the reference's separate .backward() calls sum into one loss); refinement (MCMC
relocate/grow) is dispatched by the host on the refine schedule as a separate function.

The whole step is static-shape: capacity-C parameter tensors, instance budget / per-tile
capacity from a host-managed `RasterPlan`; the step reports the actual counts (as device
tensors, without a sync) so the host can grow the plan and redo an overflowing step.

Supported here: `strategy="mcmc"`, the pinhole fast path or, with `gut=True`, the GUT
camera path (`ops/gut.py::rasterize_gut`: distorted pinhole, fisheye, ortho, rolling
shutter), no components. Pose optimization, the bilateral grid, ADMM sparsity and the ADC
strategy are still to port (ROADMAP.md, Queue 1 items 6-7): asking for one raises
NotImplementedError, the step never trains something else instead.

State: `TrainState` holds tensors on one device, the iteration and Adam's per-group step
counts as Python ints, and a `torch.Generator` on the state's device in place of the JAX
key. A step returns a new state and leaves the one it was given untouched (the generator
object is shared and advances).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from ..core.splat import SplatState
from ..device import resolve_device
from ..ops.cameras import CameraParams
from ..ops.gut import rasterize_gut
from ..ops.rasterize import rasterize, to_device
from . import strategy_mcmc
from .losses import photometric_loss, regularization_losses
from .optim import AdamState, adam_step, group_lrs, init_adam_state, means_lr_at


@dataclass
class TrainState:
    splat: SplatState
    adam: AdamState
    rng: torch.Generator  # on the state's device
    iteration: int  # 1-based

    @property
    def device(self) -> torch.device:
        return self.splat.device


def init_train_state(
    splat: SplatState,
    *,
    seed: int = 0,
    n_train_images: int = 0,
    opt=None,
    device: str | torch.device | None = None,
) -> TrainState:
    """Build a fresh TrainState on `device` (the CUDA card when None; raises without
    one). Components asked for through `opt` are not ported yet and raise."""
    _check_supported(opt)
    dev = resolve_device(device)
    if splat.device != dev:
        splat = splat.to(dev)
    rng = torch.Generator(device=dev)
    rng.manual_seed(seed)
    return TrainState(splat=splat, adam=init_adam_state(splat.params()), rng=rng,
                      iteration=1)


class StepStats(NamedTuple):
    loss: torch.Tensor
    total_instances: torch.Tensor
    max_tile_count: torch.Tensor
    n_visible: torch.Tensor


@dataclass(frozen=True)
class RasterPlan:
    """Host-side static-shape plan for the rasterizer."""

    max_instances: int
    k_max: int
    chunk: int = 64
    tile_size: int = 16
    # bf16 hi/lo feature pack (ops/cuda/blend.py B_* layout): halves the pack gather and
    # the kernels' feature reads at <=0.4% forward rounding on opacity/color/depth
    # (mean2d/conic reconstruct ~f32)
    pack_bf16: bool = False


@dataclass(frozen=True)
class StepConfig:
    """The slice of OptimizationParameters consumed by the step."""

    lambda_dssim: float = 0.2
    scale_reg: float = 0.01
    opacity_reg: float = 0.01
    sh_degree_interval: int = 1000
    strategy: str = "mcmc"
    means_lr: float = 0.00016
    shs_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    # components (not ported yet: any setting but these defaults raises)
    use_bilateral_grid: bool = False
    pose_optimization: str = "none"
    enable_sparsity: bool = False
    # GUT path (--gut): distorted / fisheye cameras (trainer.cpp:586-597)
    gut: bool = False
    cam_params: CameraParams = CameraParams()
    max_angle: float | None = None

    @classmethod
    def from_params(cls, p) -> "StepConfig":
        # the camera model is per dataset, not an optimization parameter: the caller
        # sets cam_params and max_angle with dataclasses.replace
        return cls(**{f.name: getattr(p, f.name) for f in dataclasses.fields(cls)
                      if f.name not in ("cam_params", "max_angle")})


_UNSUPPORTED = (
    ("strategy", "mcmc", "the ADC strategy (ROADMAP.md Queue 1 item 6)"),
    ("use_bilateral_grid", False, "the bilateral grid (ROADMAP.md Queue 1 item 7)"),
    ("pose_optimization", "none", "pose optimization (ROADMAP.md Queue 1 item 7)"),
    ("enable_sparsity", False, "ADMM sparsity (ROADMAP.md Queue 1 item 7)"),
)


def _check_supported(opt) -> None:
    for name, supported, what in _UNSUPPORTED:
        if opt is not None and getattr(opt, name, supported) != supported:
            raise NotImplementedError(
                f"{name}={getattr(opt, name)!r}: {what} is not ported yet")


def active_sh_degree(iteration: int, interval: int, max_degree: int) -> int:
    """SH degree schedule: +1 every `sh_degree_interval` iters (mcmc.cpp:370-373)."""
    return min(iteration // interval, max_degree)


def train_step(
    ts: TrainState,
    gt_image,  # [3, H, W]
    w2c,
    cam_position,
    fx, fy, cx, cy,
    bg_color,  # [3]
    cam_idx=0,  # index into the train split (used by the components; unused here)
    dist=None,  # [12] per-sample distortion coeffs (GUT path; model stays in opt)
    *,
    width: int,
    height: int,
    plan: RasterPlan,
    opt: Any,  # StepConfig
    total_iterations: int,
    noise=None,  # [C, 3] standard normal for the MCMC noise; drawn from ts.rng when None
    impl: str = "kernel",  # "plain" runs the kernels' plain versions on any device
    segred_impl: str = "segsum",  # GUT backward reduction lane: "segsum" (K4) | "prefix" (K7)
) -> tuple[TrainState, StepStats]:
    """One training iteration on the state's device. Camera inputs may be numpy arrays
    or tensors."""
    _check_supported(opt)
    splat = ts.splat
    dev = ts.device
    it = ts.iteration
    sh_deg = active_sh_degree(it, opt.sh_degree_interval, splat.max_sh_degree)
    gt_image = to_device(gt_image, dev)

    params = {k: v.detach().requires_grad_(True) for k, v in splat.params().items()}
    scene = (params["means"], params["scaling_raw"], params["rotation_raw"],
             params["opacity_raw"], params["sh0"], params["shN"], splat.alive,
             w2c, cam_position, fx, fy, cx, cy, sh_deg, bg_color)
    if getattr(opt, "gut", False):
        # pose opt is incompatible with GUT in the reference too (trainer.cpp:371)
        out = rasterize_gut(
            *scene, width=width, height=height,
            max_instances=plan.max_instances, k_max=plan.k_max, tile_size=plan.tile_size,
            cam_params=opt.cam_params, max_angle=opt.max_angle, dist=dist, device=dev,
            impl=impl, segred_impl=segred_impl,
        )
    else:
        out = rasterize(
            *scene, width=width, height=height,
            max_instances=plan.max_instances, k_max=plan.k_max, chunk=plan.chunk,
            tile_size=plan.tile_size, pack_bf16=plan.pack_bf16, device=dev, impl=impl,
        )
    loss = photometric_loss(out.image, gt_image, opt.lambda_dssim)
    loss = loss + regularization_losses(params, splat.alive, opt.scale_reg, opt.opacity_reg)
    names = list(params)
    grads = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)
    # bands above the active SH degree take no part in the render: zero gradient
    param_grads = {k: torch.zeros_like(params[k]) if g is None else g
                   for k, g in zip(names, grads)}

    lrs = dict(group_lrs(opt, splat.scene_scale))
    # ExponentialLR stepped once per iteration; iteration is 1-based so step i uses gamma^(i-1)
    lrs["means"] = means_lr_at(lrs["means"], it - 1, total_iterations)

    new_params, new_adam = adam_step(splat.params(), param_grads, ts.adam, lrs, it)
    new_splat = splat.replace_params(new_params)

    # MCMC noise injection every step, scaled by current means lr (mcmc.cpp:349-367)
    new_splat = strategy_mcmc.inject_noise(new_splat, lrs["means"], eps=noise,
                                           generator=ts.rng)

    new_ts = dataclasses.replace(ts, splat=new_splat, adam=new_adam, iteration=it + 1)
    stats = StepStats(
        loss=loss.detach(),
        total_instances=out.aux.total_instances,
        max_tile_count=out.aux.max_tile_count,
        n_visible=out.aux.n_visible,
    )
    return new_ts, stats


def train_step_many(
    ts: TrainState,
    gt_images,  # [K, 3, H, W]
    w2cs,  # [K, 4, 4]
    cam_positions,  # [K, 3]
    intrinsics,  # [K, 4] (fx, fy, cx, cy)
    bg_colors,  # [K, 3]
    cam_idxs,  # [K]
    dists=None,  # [K, 12] per-sample distortion coeffs (GUT path)
    *,
    width: int,
    height: int,
    plan: RasterPlan,
    opt: Any,
    total_iterations: int,
    impl: str = "kernel",
    segred_impl: str = "segsum",
) -> tuple[TrainState, StepStats]:
    """K sequential `train_step` calls over stacked camera inputs; the returned stats
    are stacked [K], so the overflow protocol checks `max()` over the stretch. A plain
    host loop: folding the stretch into one CUDA graph is a later optimisation."""
    stats = []
    for i in range(len(gt_images)):
        fx, fy, cx, cy = (float(v) for v in intrinsics[i])
        ts, st = train_step(
            ts, gt_images[i], w2cs[i], cam_positions[i], fx, fy, cx, cy, bg_colors[i],
            int(cam_idxs[i]), None if dists is None else dists[i], width=width,
            height=height, plan=plan, opt=opt, total_iterations=total_iterations, impl=impl,
            segred_impl=segred_impl,
        )
        stats.append(st)
    return ts, StepStats(*(torch.stack(field) for field in zip(*stats)))


def refine_step(ts: TrainState, *, min_opacity: float, max_cap: int,
                src=None) -> tuple[TrainState, dict]:
    """MCMC relocate + grow (host-dispatched on the refine schedule). `src`: the pair of
    source draws of `strategy_mcmc.refine`, drawn from ts.rng when None."""
    splat, adam, n_relocated, n_new = strategy_mcmc.refine(
        ts.splat, ts.adam, min_opacity, max_cap, src=src, generator=ts.rng
    )
    new_ts = dataclasses.replace(ts, splat=splat, adam=adam)
    return new_ts, {"n_relocated": n_relocated, "n_new": n_new, "n_alive": splat.n_alive()}
