"""The train step: pose opt -> render -> bilateral grid -> loss -> backward -> Adam (port of
`tpu_splat/training/train_step.py`).

Mirrors Trainer::train_step fast path (src/training/trainer.cpp:579-858) as one function
(the reference's separate .backward() calls sum into one loss); refinement (MCMC
relocate/grow, ADC grow/prune/reset, the ADMM updates and prune) is dispatched by the host
on its schedule as separate functions, keeping the step free of branches on the data.
The step's gradient head (`GradHead`: which leaves train) and update tail (`update_tail`:
the optimizers, the noise and ADC in their order) are shared with the batched step
(`parallel/step.py`), which differs only in rendering, loss composition and collectives.

The whole step is static-shape: capacity-C parameter tensors, instance budget / per-tile
capacity from a host-managed `RasterPlan`; the step reports the actual counts (as device
tensors, without a sync) so the host can grow the plan and redo an overflowing step.

Strategies: MCMC (noise injection every step) and ADC (`strategy="default"`: the step
accumulates the densification info from dL/dmean2d, which `rasterize` exposes through a
zero `mean2d_offset`). Cameras: the pinhole fast path or, with `gut=True`, the GUT camera
path (`ops/gut.py::rasterize_gut`); as in the JAX package the GUT path takes no
`mean2d_offset`, so ADC under GUT accumulates zero gradients and never grows.

Optional components (all None/off by default, matching trainer.cpp wiring):
  * pose optimization (components/poseopt.cpp): w2c = poseopt(w2c, cam_idx), separate Adam
    lr 1e-5 (trainer.cpp:384-386).
  * bilateral grid (components/bilateral_grid.cpp): rendered -> slice(grids[img_idx]) before
    the photometric loss; + tv_loss_weight * tv; separate Adam lr 2e-3 eps 1e-15 with
    WarmupExponentialLR (trainer.cpp:66-101).
  * ADMM sparsity loss during the appended sparsify phase (trainer.cpp:622-646).

State: `TrainState` holds tensors on one device, the iteration and the optimizers' step
counts as Python ints, and a `torch.Generator` on the state's device in place of the JAX
key. A step returns a new state and leaves the one it was given untouched (the generator
object is shared and advances). Every function that draws also takes the draw as an
optional argument (`noise=`, `eps=`, `src=`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..core.splat import SplatState
from ..device import resolve_device
from ..ops.cameras import CameraParams
from ..ops.gut import rasterize_gut
from ..ops.rasterize import rasterize, to_device
from . import bilateral_grid as bg
from . import poseopt as po
from . import sparsity as sp
from . import strategy_default, strategy_mcmc
from .losses import photometric_loss, regularization_losses
from .optim import AdamState, adam_step, group_lrs, init_adam_state, means_lr_at


def tree_map(fn, *trees):
    """`fn` over the tensors of nested dicts and lists of the same structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return [tree_map(fn, *items) for items in zip(*trees)]
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The tensors of nested dicts and lists, in `tree_map`'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree, leaves) -> Any:
    """A tree of `tree`'s structure holding `leaves` (in `tree_leaves`' order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


@dataclass
class AuxOptState:
    """Plain Adam state for a component's parameters (bilateral grids / pose params)."""

    m: Any
    v: Any
    count: int

    @classmethod
    def init(cls, params) -> "AuxOptState":
        return cls(m=tree_map(torch.zeros_like, params), v=tree_map(torch.zeros_like, params),
                   count=0)


@torch.no_grad()
def aux_adam_step(params, grads, state: AuxOptState, lr: float, eps: float = 1e-8,
                  b1: float = 0.9, b2: float = 0.999):
    """torch::optim::Adam semantics for component optimizers. The bias corrections and the
    learning rate are float32 host scalars, as the JAX package computes them on the
    device."""
    c = state.count + 1
    cf = np.float32(c)
    bc1 = float(np.float32(1.0) - np.power(np.float32(b1), cf))
    bc2 = float(np.float32(1.0) - np.power(np.float32(b2), cf))
    lr = float(np.float32(lr))

    def upd(p, g, m, v):
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * g * g
        return p - lr * (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps), m2, v2

    out = [upd(*a) for a in zip(tree_leaves(params), tree_leaves(grads),
                                tree_leaves(state.m), tree_leaves(state.v))]
    new_p = tree_unflatten(params, [o[0] for o in out])
    new_m = tree_unflatten(params, [o[1] for o in out])
    new_v = tree_unflatten(params, [o[2] for o in out])
    return new_p, AuxOptState(m=new_m, v=new_v, count=c)


@dataclass
class TrainState:
    splat: SplatState
    adam: AdamState
    rng: torch.Generator  # on the state's device
    iteration: int  # 1-based
    # ADC densification info (zeros when strategy != default)
    dens_count: torch.Tensor  # [C] f32
    dens_grad2d: torch.Tensor  # [C] f32
    # optional components (None = disabled)
    bilateral_grids: Optional[torch.Tensor] = None  # [n_images, 12, L, H, W]
    bilateral_opt: Optional[AuxOptState] = None
    pose_params: Optional[Any] = None
    pose_opt: Optional[AuxOptState] = None
    admm: Optional[sp.ADMMState] = None

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
    one), with the components that `opt` (OptimizationParameters) asks for. The pose
    MLP's random init draws from the state's generator."""
    dev = resolve_device(device)
    if splat.device != dev:
        splat = splat.to(dev)
    rng = torch.Generator(device=dev)
    rng.manual_seed(seed)
    bilateral_grids = bilateral_opt = pose_params = pose_opt = None
    if opt is not None and getattr(opt, "use_bilateral_grid", False):
        bilateral_grids = bg.init_grids(n_train_images, opt.bilateral_grid_X,
                                        opt.bilateral_grid_Y, opt.bilateral_grid_W, device=dev)
        bilateral_opt = AuxOptState.init(bilateral_grids)
    if opt is not None and getattr(opt, "pose_optimization", "none") != "none":
        pose_params = po.init(opt.pose_optimization, rng, n_train_images, device=dev)
        pose_opt = AuxOptState.init(pose_params)
    zeros = torch.zeros((splat.capacity,), dtype=torch.float32, device=dev)
    return TrainState(splat=splat, adam=init_adam_state(splat.params()), rng=rng,
                      iteration=1, dens_count=zeros, dens_grad2d=zeros.clone(),
                      bilateral_grids=bilateral_grids, bilateral_opt=bilateral_opt,
                      pose_params=pose_params, pose_opt=pose_opt)


class StepStats(NamedTuple):
    loss: torch.Tensor
    total_instances: torch.Tensor
    max_tile_count: torch.Tensor
    n_visible: torch.Tensor
    # the batched step's largest per-shard visible count, held against the plan's
    # gather_budget; == n_visible on the single-camera path
    n_shard_visible: Optional[torch.Tensor] = None


@dataclass(frozen=True)
class RasterPlan:
    """Host-side static-shape plan for the rasterizer."""

    max_instances: int
    k_max: int
    chunk: int = 64
    tile_size: int = 16
    # the batched step's per-shard slot budget of the visible compaction before the
    # all-gather (parallel/raster_mc.py::compact_visible); None gathers the whole shard
    gather_budget: Optional[int] = None
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
    # components
    use_bilateral_grid: bool = False
    tv_loss_weight: float = 10.0
    bilateral_grid_lr: float = 2e-3
    pose_optimization: str = "none"
    pose_lr: float = 1e-5
    enable_sparsity: bool = False
    init_rho: float = 5e-4
    sparsify_start: int = 30_000  # = base iterations (sparsity_optimizer.hpp:91)
    sparsify_steps: int = 15_000
    # GUT path (--gut): distorted / fisheye cameras (trainer.cpp:586-597)
    gut: bool = False
    cam_params: CameraParams = CameraParams()
    max_angle: float | None = None

    @classmethod
    def from_params(cls, p) -> "StepConfig":
        # the camera model is per dataset, not an optimization parameter: the caller
        # sets cam_params and max_angle with dataclasses.replace; pose_lr keeps its
        # default, as in the JAX package
        same = ("lambda_dssim", "scale_reg", "opacity_reg", "sh_degree_interval", "strategy",
                "means_lr", "shs_lr", "opacity_lr", "scaling_lr", "rotation_lr",
                "use_bilateral_grid", "tv_loss_weight", "bilateral_grid_lr",
                "pose_optimization", "enable_sparsity", "init_rho", "sparsify_steps", "gut")
        return cls(sparsify_start=p.iterations, **{k: getattr(p, k) for k in same})


def active_sh_degree(iteration: int, interval: int, max_degree: int) -> int:
    """SH degree schedule: +1 every `sh_degree_interval` iters (mcmc.cpp:370-373)."""
    return min(iteration // interval, max_degree)


def _leaves_requiring_grad(tree):
    return tree_map(lambda t: t.detach().requires_grad_(True), tree)


class StepGrads(NamedTuple):
    params: dict  # by parameter name
    mean2d: Optional[torch.Tensor]  # the mean2d offset's; None without the offset
    pose: Any  # a tree like the pose parameters; None without pose opt
    bilateral: Optional[torch.Tensor]  # the bilateral grids'; None without them


class GradHead:
    """What a train step differentiates, shared by `train_step` and the batched step
    (`parallel/step.py`): the component flags, the state's leaves that take gradients
    (the mean2d offset in `mean2d_shape`) and the split of `torch.autograd.grad`'s
    result into `StepGrads`."""

    def __init__(self, ts: TrainState, opt: Any, mean2d_shape: tuple):
        splat = ts.splat
        self.use_pose = opt.pose_optimization != "none" and ts.pose_params is not None
        self.use_bilateral = opt.use_bilateral_grid and ts.bilateral_grids is not None
        self.use_sparsity = (
            opt.enable_sparsity and ts.admm is not None
            and sp.should_apply_loss(ts.iteration, opt.sparsify_start, opt.sparsify_steps))
        # dL/dmean2d through a zero offset: only ADC reads it, and GUT takes no offset
        self.use_mean2d = opt.strategy == "default" and not opt.gut
        self.mean2d_shape = mean2d_shape
        self.params = _leaves_requiring_grad(splat.params())
        self.pose_params = _leaves_requiring_grad(ts.pose_params) if self.use_pose else None
        self.grids = _leaves_requiring_grad(ts.bilateral_grids) if self.use_bilateral else None
        self.mean2d_offset = (torch.zeros(mean2d_shape, dtype=splat.means.dtype,
                                          device=ts.device, requires_grad=True)
                              if self.use_mean2d else None)

    def grads(self, loss: torch.Tensor) -> StepGrads:
        names = list(self.params)
        inputs = [self.params[k] for k in names]
        if self.use_mean2d:
            inputs.append(self.mean2d_offset)
        pose_leaves = tree_leaves(self.pose_params) if self.use_pose else []
        inputs += pose_leaves
        if self.use_bilateral:
            inputs.append(self.grids)
        grads = list(torch.autograd.grad(loss, inputs, allow_unused=True))
        # bands above the active SH degree take no part in the render: zero gradient
        grads = [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, grads)]
        rest = grads[len(names):]
        mean2d = rest.pop(0) if self.use_mean2d else None
        return StepGrads(
            params=dict(zip(names, grads[:len(names)])), mean2d=mean2d,
            pose=tree_unflatten(self.pose_params, rest[:len(pose_leaves)])
            if self.use_pose else None,
            bilateral=rest[len(pose_leaves)] if self.use_bilateral else None)


def update_tail(ts: TrainState, opt: Any, head: GradHead, grads: StepGrads, *,
                total_iterations: int, noise_rows, adc_rows, width: int, height: int,
                impl: str) -> TrainState:
    """The update that both train steps end with, in this order: the learning rates, Adam
    (one kernel launch on the card, the chain under `impl="plain"`), the MCMC noise
    (`noise_rows()`: the state's rows of the draw, None to draw them from ts.rng), ADC's
    accumulation over `adc_rows(mean2d gradient)`'s (gradient, visibility) pairs in camera
    order, the pose and bilateral optimizers. -> the next state."""
    splat = ts.splat
    it = ts.iteration
    lrs = dict(group_lrs(opt, splat.scene_scale))
    # ExponentialLR stepped once per iteration; iteration is 1-based so step i uses gamma^(i-1)
    lrs["means"] = means_lr_at(lrs["means"], it - 1, total_iterations)

    new_params, new_adam = adam_step(splat.params(), grads.params, ts.adam, lrs, it, impl)
    new_splat = splat.replace_params(new_params)

    # MCMC noise injection every step, scaled by current means lr (mcmc.cpp:349-367)
    if opt.strategy == "mcmc":
        new_splat = strategy_mcmc.inject_noise(new_splat, lrs["means"], eps=noise_rows(),
                                               generator=ts.rng)

    # ADC densification info accumulation (kernels_backward.cuh:232-236); under GUT the
    # mean2d gradient is zero, as in the JAX package
    dens_count, dens_grad2d = ts.dens_count, ts.dens_grad2d
    if opt.strategy == "default":
        mean2d = grads.mean2d
        if mean2d is None:
            mean2d = torch.zeros(head.mean2d_shape, dtype=splat.means.dtype, device=ts.device)
        for grad, visible in adc_rows(mean2d):
            dens_count, dens_grad2d = strategy_default.accumulate_densification(
                dens_count, dens_grad2d, grad, visible, width, height)

    # component optimizers
    new_pose_params, new_pose_opt = ts.pose_params, ts.pose_opt
    if head.use_pose:
        new_pose_params, new_pose_opt = aux_adam_step(ts.pose_params, grads.pose, ts.pose_opt,
                                                      opt.pose_lr)
    new_grids, new_bopt = ts.bilateral_grids, ts.bilateral_opt
    if head.use_bilateral:
        gamma = 0.01 ** (1.0 / total_iterations)
        blr = bg.warmup_exponential_lr(opt.bilateral_grid_lr, it, gamma)
        new_grids, new_bopt = aux_adam_step(ts.bilateral_grids, grads.bilateral,
                                            ts.bilateral_opt, blr, eps=1e-15)

    return dataclasses.replace(
        ts, splat=new_splat, adam=new_adam, iteration=it + 1, dens_count=dens_count,
        dens_grad2d=dens_grad2d, bilateral_grids=new_grids, bilateral_opt=new_bopt,
        pose_params=new_pose_params, pose_opt=new_pose_opt,
    )


def train_step(
    ts: TrainState,
    gt_image,  # [3, H, W]
    w2c,
    cam_position,
    fx, fy, cx, cy,
    bg_color,  # [3]
    cam_idx=0,  # index into the train split (pose embedding / bilateral grid)
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
    splat = ts.splat
    dev = ts.device
    cam_idx = int(cam_idx)
    sh_deg = active_sh_degree(ts.iteration, opt.sh_degree_interval, splat.max_sh_degree)
    gt_image = to_device(gt_image, dev)
    head = GradHead(ts, opt, (splat.capacity, 2))
    params = head.params

    w2c = to_device(w2c, dev)
    cam_position = to_device(cam_position, dev)
    if head.use_pose:
        w2c = po.apply(opt.pose_optimization, head.pose_params, w2c, cam_idx)
        cam_position = -w2c[:3, :3].T @ w2c[:3, 3]
    scene = (params["means"], params["scaling_raw"], params["rotation_raw"],
             params["opacity_raw"], params["sh0"], params["shN"], splat.alive,
             w2c, cam_position, fx, fy, cx, cy, sh_deg, bg_color)
    if opt.gut:
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
            tile_size=plan.tile_size, pack_bf16=plan.pack_bf16,
            mean2d_offset=head.mean2d_offset, device=dev, impl=impl,
        )
    image = out.image
    if head.use_bilateral:
        image = bg.slice_grid(head.grids[cam_idx], image)
    loss = photometric_loss(image, gt_image, opt.lambda_dssim)
    loss = loss + regularization_losses(params, splat.alive, opt.scale_reg, opt.opacity_reg)
    if head.use_bilateral:
        loss = loss + opt.tv_loss_weight * bg.tv_loss(head.grids)
    if head.use_sparsity:
        loss = loss + sp.sparsity_loss(params["opacity_raw"], splat.alive, ts.admm,
                                       opt.init_rho)

    new_ts = update_tail(ts, opt, head, head.grads(loss), total_iterations=total_iterations,
                         noise_rows=lambda: noise,
                         adc_rows=lambda mean2d: [(mean2d, out.aux.visible)],
                         width=width, height=height, impl=impl)
    stats = StepStats(
        loss=loss.detach(),
        total_instances=out.aux.total_instances,
        max_tile_count=out.aux.max_tile_count,
        n_visible=out.aux.n_visible,
        n_shard_visible=out.aux.n_visible,
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


def adc_refine_step(
    ts: TrainState,
    *,
    grad_threshold: float,
    grow_scale3d: float,
    prune_opacity: float,
    prune_scale3d: float,
    reset_every: int,
    revised_opacity: bool,
    eps=None,  # [2, C, 3] split-offset normals; drawn from ts.rng when None
) -> tuple[TrainState, dict]:
    """ADC grow+prune round; resets densification info (default_strategy.cpp:301-309)."""
    splat, adam, info = strategy_default.refine(
        ts.splat, ts.adam, ts.dens_count, ts.dens_grad2d, ts.iteration,
        grad_threshold=grad_threshold, grow_scale3d=grow_scale3d,
        prune_opacity=prune_opacity, prune_scale3d=prune_scale3d,
        reset_every=reset_every, revised_opacity=revised_opacity, eps=eps,
        generator=ts.rng,
    )
    new_ts = dataclasses.replace(
        ts, splat=splat, adam=adam, dens_count=torch.zeros_like(ts.dens_count),
        dens_grad2d=torch.zeros_like(ts.dens_grad2d),
    )
    return new_ts, info


@torch.no_grad()
def grow_pool(ts: TrainState, capacity: int) -> TrainState:
    """The state in a pool of `capacity` slots (at least its own; ADC's pool grows, as
    LichtFeld's appends, default_strategy.cpp:49-227): the new slots dead
    (`SplatState.with_capacity`), their Adam moments, densification info and ADMM
    variables zero. The per-image components are unchanged."""
    n = capacity - ts.splat.capacity

    def pad(v: torch.Tensor) -> torch.Tensor:
        return torch.cat([v, v.new_zeros((n,) + tuple(v.shape[1:]))])

    adam = dataclasses.replace(ts.adam, exp_avg={k: pad(v) for k, v in ts.adam.exp_avg.items()},
                               exp_avg_sq={k: pad(v) for k, v in ts.adam.exp_avg_sq.items()})
    admm = None if ts.admm is None else sp.ADMMState(u=pad(ts.admm.u), z=pad(ts.admm.z))
    return dataclasses.replace(ts, splat=ts.splat.with_capacity(capacity), adam=adam,
                               dens_count=pad(ts.dens_count), dens_grad2d=pad(ts.dens_grad2d),
                               admm=admm)


def adc_reset_opacity_step(ts: TrainState, *, prune_opacity: float) -> TrainState:
    splat, adam = strategy_default.reset_opacity(ts.splat, ts.adam, prune_opacity)
    return dataclasses.replace(ts, splat=splat, adam=adam)


@torch.no_grad()
def admm_init_step(ts: TrainState, *, prune_ratio: float) -> TrainState:
    admm = sp.init_admm(ts.splat.opacity_raw, ts.splat.alive, prune_ratio)
    return dataclasses.replace(ts, admm=admm)


@torch.no_grad()
def admm_update_step(ts: TrainState, *, prune_ratio: float) -> TrainState:
    admm = sp.update_admm(ts.splat.opacity_raw, ts.splat.alive, ts.admm, prune_ratio)
    return dataclasses.replace(ts, admm=admm)


@torch.no_grad()
def sparsity_prune_step(ts: TrainState, *,
                        prune_ratio: float) -> tuple[TrainState, torch.Tensor]:
    mask = sp.prune_mask(ts.splat.opacity_raw, ts.splat.alive, prune_ratio)
    splat = strategy_default.remove_gaussians(ts.splat, mask)
    return dataclasses.replace(ts, splat=splat), torch.sum(mask, dtype=torch.int32)
