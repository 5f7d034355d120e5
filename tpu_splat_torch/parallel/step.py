"""The batched train step over the (data, gauss) mesh: cameras over "data", Gaussians and
each image's tile rows over "gauss" (port of `tpu_splat/parallel/step.py`).

A batch of B cameras renders through `raster_mc.render_batch_mc` (each data group its
B / D cameras); the loss is the mean of the B photometric losses plus the regularisers,
and one Adam update applies to each rank's rows. Every reduction that the single-camera
step takes over the whole pool sees the whole pool here:
  * the regularisers divide by the global alive count (losses.py:28-41): the shard sums
    and counts are summed over gauss;
  * the MCMC noise is drawn for the whole capacity from the replicated generator on every
    rank, and each rank keeps its rows: the result does not depend on the mesh;
  * parameter gradients are summed over the data group (the loss is already the mean over
    the global batch; the regularisers enter on data rank 0 alone); pose gradients flow
    through every shard's projection and are summed over the whole world; the bilateral
    grid acts on the gathered image, so its gradient is the same on every gauss rank and
    is summed over data alone;
  * ADC accumulates per camera with the batch mean's 1/B undone (step.py:132-141), in
    camera order: the data groups' per-camera rows are gathered first;
  * the step's counters are max-reduced over the world, so every rank takes the same plan
    decision; the loss is summed to the global value on every rank.
With the ADMM sparsity phase on, its loss is added as in the single-camera step (the JAX
batched step leaves it out: ROADMAP.md Queue 3).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from ..ops.rasterize import to_device
from ..training import bilateral_grid as bgrid
from ..training import poseopt as po
from ..training import sparsity as sp
from ..training import strategy_default, strategy_mcmc
from ..training.losses import photometric_loss, regularization_losses
from ..training.optim import adam_step, group_lrs, means_lr_at
from ..training.train_step import (RasterPlan, StepStats, TrainState, active_sh_degree,
                                   aux_adam_step, tree_leaves, tree_map, tree_unflatten)
from .distributed import local_batch_slice
from .mesh import Mesh
from .raster_mc import render_batch_mc


def make_batched_train_step(mesh: Mesh):
    """-> batched_train_step(ts, gt_images, w2cs, cam_positions, intr, bg_color,
    cam_idxs=None, dist=None, *, width, height, plan, opt, total_iterations, noise=None,
    impl="kernel") -> (ts, StepStats) over `mesh`; `ts` is this rank's part of the state
    (`mesh.shard_train_state`)."""
    return functools.partial(batched_train_step, mesh)


def _requiring_grad(tree):
    return tree_map(lambda t: t.detach().requires_grad_(True), tree)


def batched_train_step(
    mesh: Mesh,
    ts: TrainState,
    gt_images,  # [B, 3, H, W], the whole batch (each data group reads its cameras)
    w2cs,  # [B, 4, 4]
    cam_positions,  # [B, 3]
    intr,  # [B, 4] fx fy cx cy (host numbers)
    bg_color,  # [3]
    cam_idxs=None,  # [B] indices into the train split (pose embedding / bilateral grid)
    dist=None,  # [B, 12] per-camera distortion coefficients (GUT)
    *,
    width: int,
    height: int,
    plan: RasterPlan,
    opt: Any,  # StepConfig
    total_iterations: int,
    noise=None,  # [C, 3] standard normal for the MCMC noise (whole capacity); drawn when None
    impl: str = "kernel",
) -> tuple[TrainState, StepStats]:
    splat = ts.splat
    dev = ts.device
    it = ts.iteration
    sh_deg = active_sh_degree(it, opt.sh_degree_interval, splat.max_sh_degree)
    batch = len(gt_images)
    cams = local_batch_slice(batch, mesh)
    intr = np.asarray(intr, np.float32)
    cam_idxs = [0] * batch if cam_idxs is None else [int(i) for i in cam_idxs]
    d0 = mesh.d == 0  # the data rank of each gauss shard that adds the regularisers

    use_pose = opt.pose_optimization != "none" and ts.pose_params is not None
    use_bilateral = opt.use_bilateral_grid and ts.bilateral_grids is not None
    use_sparsity = (opt.enable_sparsity and ts.admm is not None
                    and sp.should_apply_loss(it, opt.sparsify_start, opt.sparsify_steps))
    use_mean2d = opt.strategy == "default" and not opt.gut

    params = _requiring_grad(splat.params())
    pose_params = _requiring_grad(ts.pose_params) if use_pose else None
    grids = _requiring_grad(ts.bilateral_grids) if use_bilateral else None
    b_loc = cams.stop - cams.start
    mean2d_offset = (torch.zeros((b_loc, splat.capacity, 2), dtype=splat.means.dtype,
                                 device=dev, requires_grad=True) if use_mean2d else None)

    w2c_l = to_device(w2cs[cams], dev)
    cpos_l = to_device(cam_positions[cams], dev)
    if use_pose:
        w2c_l = torch.stack([po.apply(opt.pose_optimization, pose_params, w, cam_idxs[i])
                             for i, w in zip(range(cams.start, cams.stop), w2c_l)])
        cpos_l = torch.stack([-w[:3, :3].T @ w[:3, 3] for w in w2c_l])
    out = render_batch_mc(
        mesh, params, splat.alive, mean2d_offset, w2c_l, cpos_l, intr[cams], sh_deg,
        to_device(bg_color, dev), width=width, height=height, plan=plan,
        dist=None if dist is None else to_device(dist[cams], dev),
        cam_params=opt.cam_params if opt.gut else None, max_angle=opt.max_angle, impl=impl,
    )
    images = out.images
    if use_bilateral:
        images = torch.stack([bgrid.slice_grid(grids[cam_idxs[i]], im)
                              for i, im in zip(range(cams.start, cams.stop), images)])
    gts = to_device(gt_images[cams], dev)
    photo = sum(photometric_loss(im, gt, opt.lambda_dssim)
                for im, gt in zip(images, gts)) / batch

    n_alive = mesh.all_reduce(splat.alive.sum(dtype=torch.float32), "gauss")
    shard_reg = regularization_losses(params, splat.alive, opt.scale_reg, opt.opacity_reg,
                                      n_alive=n_alive)
    if use_sparsity:
        rows = mesh.shard_rows(splat.capacity * mesh.gauss)
        admm = sp.ADMMState(u=ts.admm.u[rows], z=ts.admm.z[rows])
        shard_reg = shard_reg + sp.sparsity_loss(params["opacity_raw"], splat.alive, admm,
                                                 opt.init_rho)
    shared = bgrid.tv_loss(grids) * opt.tv_loss_weight if use_bilateral else None
    loss = photo + shard_reg if d0 else photo
    if d0 and shared is not None:
        loss = loss + shared

    names = list(params)
    inputs = [params[k] for k in names]
    if use_mean2d:
        inputs.append(mean2d_offset)
    pose_leaves = tree_leaves(pose_params) if use_pose else []
    inputs += pose_leaves
    if use_bilateral:
        inputs.append(grids)
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, grads)]
    param_grads = {k: mesh.all_reduce(g, "data") for k, g in zip(names, grads[:len(names)])}
    rest = grads[len(names):]
    mean2d_grads = rest.pop(0) if use_mean2d else None
    pose_grads = (tree_unflatten(ts.pose_params,
                                 [mesh.all_reduce(g, "world") for g in rest[:len(pose_leaves)]])
                  if use_pose else None)
    bilateral_grads = mesh.all_reduce(rest[len(pose_leaves)], "data") if use_bilateral else None

    lrs = dict(group_lrs(opt, splat.scene_scale))
    lrs["means"] = means_lr_at(lrs["means"], it - 1, total_iterations)
    new_params, new_adam = adam_step(splat.params(), param_grads, ts.adam, lrs, it)
    new_splat = splat.replace_params(new_params)

    if opt.strategy == "mcmc":
        capacity = splat.capacity * mesh.gauss
        if noise is None:
            noise = torch.randn((capacity, 3), dtype=splat.means.dtype, device=dev,
                                generator=ts.rng)
        eps = to_device(noise, dev)[mesh.shard_rows(capacity)]
        new_splat = strategy_mcmc.inject_noise(new_splat, lrs["means"], eps=eps)

    dens_count, dens_grad2d = ts.dens_count, ts.dens_grad2d
    if opt.strategy == "default":
        # per camera, with the batch mean's 1/B undone, in the global camera order
        if mean2d_grads is None:  # GUT takes no mean2d tap: zero gradients, as JAX's
            mean2d_grads = torch.zeros((b_loc, splat.capacity, 2), dtype=splat.means.dtype,
                                       device=dev)
        per_cam = mesh.all_gather(mean2d_grads * float(batch), "data")
        visible = mesh.all_gather(out.visible, "data")
        for b in range(batch):
            dens_count, dens_grad2d = strategy_default.accumulate_densification(
                dens_count, dens_grad2d, per_cam[b], visible[b], width, height)

    new_pose_params, new_pose_opt = ts.pose_params, ts.pose_opt
    if use_pose:
        new_pose_params, new_pose_opt = aux_adam_step(ts.pose_params, pose_grads,
                                                      ts.pose_opt, opt.pose_lr)
    new_grids, new_bopt = ts.bilateral_grids, ts.bilateral_opt
    if use_bilateral:
        gamma = 0.01 ** (1.0 / total_iterations)
        blr = bgrid.warmup_exponential_lr(opt.bilateral_grid_lr, it, gamma)
        new_grids, new_bopt = aux_adam_step(ts.bilateral_grids, bilateral_grads,
                                            ts.bilateral_opt, blr, eps=1e-15)

    new_ts = dataclasses.replace(
        ts, splat=new_splat, adam=new_adam, iteration=it + 1, dens_count=dens_count,
        dens_grad2d=dens_grad2d, bilateral_grids=new_grids, bilateral_opt=new_bopt,
        pose_params=new_pose_params, pose_opt=new_pose_opt,
    )
    # the global loss on every rank: the photometric part once a data group, the
    # regularisers once a gauss shard
    parts = torch.stack([photo.detach() if mesh.g == 0 else torch.zeros_like(photo),
                         shard_reg.detach() if d0 else torch.zeros_like(photo)])
    parts = mesh.all_reduce(parts, "world")
    total = parts[0] + parts[1] + (shared.detach() if shared is not None else 0.0)
    counts = mesh.all_reduce(torch.stack([
        out.total_instances.max(), out.max_tile_count.max(), out.n_visible.max(),
        out.n_shard_visible.max()]), "world", op="max")
    stats = StepStats(loss=total, total_instances=counts[0], max_tile_count=counts[1],
                      n_visible=counts[2], n_shard_visible=counts[3])
    return new_ts, stats
