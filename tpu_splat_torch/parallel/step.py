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

import functools
from typing import Any

import numpy as np
import torch

from ..ops.rasterize import to_device
from ..training import bilateral_grid as bgrid
from ..training import poseopt as po
from ..training import sparsity as sp
from ..training.losses import photometric_loss, regularization_losses
from ..training.train_step import (GradHead, RasterPlan, StepStats, TrainState,
                                   active_sh_degree, tree_map, update_tail)
from .distributed import local_batch_slice
from .mesh import Mesh
from .raster_mc import render_batch_mc


def make_batched_train_step(mesh: Mesh):
    """-> batched_train_step(ts, gt_images, w2cs, cam_positions, intr, bg_color,
    cam_idxs=None, dist=None, *, width, height, plan, opt, total_iterations, noise=None,
    impl="kernel") -> (ts, StepStats) over `mesh`; `ts` is this rank's part of the state
    (`mesh.shard_train_state`)."""
    return functools.partial(batched_train_step, mesh)


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
    """`train_step`'s gradient head and update tail (`GradHead`, `update_tail`) around the
    mesh's render, loss and collectives."""
    splat = ts.splat
    dev = ts.device
    sh_deg = active_sh_degree(ts.iteration, opt.sh_degree_interval, splat.max_sh_degree)
    batch = len(gt_images)
    cams = local_batch_slice(batch, mesh)
    intr = np.asarray(intr, np.float32)
    cam_idxs = [0] * batch if cam_idxs is None else [int(i) for i in cam_idxs]
    d0 = mesh.d == 0  # the data rank of each gauss shard that adds the regularisers
    head = GradHead(ts, opt, (cams.stop - cams.start, splat.capacity, 2))
    params = head.params

    w2c_l = to_device(w2cs[cams], dev)
    cpos_l = to_device(cam_positions[cams], dev)
    if head.use_pose:
        w2c_l = torch.stack([po.apply(opt.pose_optimization, head.pose_params, w, cam_idxs[i])
                             for i, w in zip(range(cams.start, cams.stop), w2c_l)])
        cpos_l = torch.stack([-w[:3, :3].T @ w[:3, 3] for w in w2c_l])
    out = render_batch_mc(
        mesh, params, splat.alive, head.mean2d_offset, w2c_l, cpos_l, intr[cams], sh_deg,
        to_device(bg_color, dev), width=width, height=height, plan=plan,
        dist=None if dist is None else to_device(dist[cams], dev),
        cam_params=opt.cam_params if opt.gut else None, max_angle=opt.max_angle, impl=impl,
    )
    images = out.images
    if head.use_bilateral:
        images = torch.stack([bgrid.slice_grid(head.grids[cam_idxs[i]], im)
                              for i, im in zip(range(cams.start, cams.stop), images)])
    gts = to_device(gt_images[cams], dev)
    photo = sum(photometric_loss(im, gt, opt.lambda_dssim)
                for im, gt in zip(images, gts)) / batch

    n_alive = mesh.all_reduce(splat.alive.sum(dtype=torch.float32), "gauss")
    shard_reg = regularization_losses(params, splat.alive, opt.scale_reg, opt.opacity_reg,
                                      n_alive=n_alive)
    if head.use_sparsity:
        rows = mesh.shard_rows(splat.capacity * mesh.gauss)
        admm = sp.ADMMState(u=ts.admm.u[rows], z=ts.admm.z[rows])
        shard_reg = shard_reg + sp.sparsity_loss(params["opacity_raw"], splat.alive, admm,
                                                 opt.init_rho)
    shared = bgrid.tv_loss(head.grids) * opt.tv_loss_weight if head.use_bilateral else None
    # photo + (reg + sparsity), then + tv: not train_step's order, whose bits it would move
    loss = photo + shard_reg if d0 else photo
    if d0 and shared is not None:
        loss = loss + shared

    grads = head.grads(loss)
    grads = grads._replace(
        params={k: mesh.all_reduce(g, "data") for k, g in grads.params.items()},
        pose=tree_map(lambda g: mesh.all_reduce(g, "world"), grads.pose)
        if head.use_pose else None,
        bilateral=mesh.all_reduce(grads.bilateral, "data") if head.use_bilateral else None)

    capacity = splat.capacity * mesh.gauss

    def noise_rows():  # the whole pool's draw on every rank; this shard keeps its rows
        pool = noise if noise is not None else torch.randn(
            (capacity, 3), dtype=splat.means.dtype, device=dev, generator=ts.rng)
        return to_device(pool, dev)[mesh.shard_rows(capacity)]

    def adc_rows(mean2d):  # per camera, with the batch mean's 1/B undone, in camera order
        per_cam = mesh.all_gather(mean2d * float(batch), "data")
        visible = mesh.all_gather(out.visible, "data")
        return ((per_cam[b], visible[b]) for b in range(batch))

    new_ts = update_tail(ts, opt, head, grads, total_iterations=total_iterations,
                         noise_rows=noise_rows, adc_rows=adc_rows, width=width,
                         height=height, impl=impl)
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
