"""Windowed render of a camera batch over the (data, gauss) mesh (port of
`tpu_splat/parallel/raster_mc.py`).

Per camera of this rank's data group, on each gauss rank:

  project the local shard (pinhole `project`, or the GUT `ut_project` + `gut_feature_table`)
    -> compact it to its visible rows (`compact_visible`, a fixed `gather_budget` of slots;
       skipped when the budget is not below the shard's rows)
    -> all-gather the packed [rows, 10 (+16 GUT) + 7] table over gauss (`GatherRows`; with
       one gauss rank and no compaction the projection goes on unpacked)
    -> cut the rects to this rank's window of tile rows (`_window_proj`)
    -> `build_sorted_instances(tile_y0=y0)` (K1; the sort key sized by the whole image's
       tiles, so each tile's list is the whole frame's) -> K2 with `tile_y0=y0` (or the GUT
       blend K5 on the window's world rays) -> assemble the window -> background
    -> all-gather the image rows over gauss (`GatherImageRows`).

The two gathers transpose differently, and a wrong gradient would come from confusing
them:
  * the projected table: every rank's window reads every shard's rows, so the backward
    SUMS each rank's gradient of the gathered table and hands each shard its rows (a
    reduce-scatter);
  * the image rows: SSIM's 11-pixel window crosses the cut, so the rows are gathered and
    every gauss rank computes the same loss from the same image. The backward takes the
    rank's OWN rows of that gradient: summing would count the loss G times.
Overflow of the compaction budget is reported (`n_shard_visible`) so that the Trainer can
grow the budget and redo the step, as it does for the instance budget.

On the CPU every kernel wrapper runs its plain version, the GUT blend included (the JAX
package runs its XLA chunk scan there).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.cameras import bind_coeffs, fisheye_max_angle
from ..ops.cuda.gut_kernels import GutBlendTiles
from ..ops.cuda.raster import build_sorted_instances, feature_table
from ..ops.gut import gut_feature_table, pixel_world_rays, ut_project
from ..ops.projection import Projected, project
from ..ops.rasterize import assemble_image, blend_instances
from .mesh import Mesh

N_PROJ_DIFF = 10  # mean2d 2, conic 3, opacity 1, colour 3, depth 1
N_GUT = 16  # the first 16 rows of the GUT G_* table (depth is the projection's)
N_PROJ_INT = 7  # tile_min 2, tile_max 2, n_tiles 1, power_threshold 1, visible 1
GUT_CHUNK = 128  # the single-camera GUT path's chunk (ops/gut.py::rasterize_gut)


def _window_proj(proj: Projected, y0: int, gh_local: int) -> Projected:
    """`proj` cut to tile rows [y0, y0 + gh_local): window-local tile rows, rect areas
    recomputed, Gaussians off the window culled (raster_mc.py:58-71)."""
    tmin_y = torch.clamp(proj.tile_min[:, 1] - y0, 0, gh_local)
    tmax_y = torch.clamp(proj.tile_max[:, 1] - y0, 0, gh_local)
    n_tiles = (proj.tile_max[:, 0] - proj.tile_min[:, 0]) * (tmax_y - tmin_y)
    visible = proj.visible & (n_tiles > 0)
    return proj._replace(
        tile_min=torch.stack([proj.tile_min[:, 0], tmin_y], dim=1),
        tile_max=torch.stack([proj.tile_max[:, 0], tmax_y], dim=1),
        n_tiles=torch.where(visible, n_tiles, 0).to(torch.int32),
        visible=visible,
    )


def pack_projection(proj: Projected, feats: torch.Tensor | None) -> torch.Tensor:
    """One [n, 10 (+16) + 7] float32 table of a projection (and the GUT features [n, 16]):
    the differentiable columns, then the integer and mask columns as exact floats (tile
    coordinates < 2^24) behind a detach."""
    cols = [proj.mean2d, proj.conic, proj.opacity[:, None], proj.color, proj.depth[:, None]]
    if feats is not None:
        cols.append(feats)
    f32 = proj.mean2d.dtype
    cols.append(torch.cat([
        proj.tile_min.to(f32), proj.tile_max.to(f32), proj.n_tiles.to(f32)[:, None],
        proj.power_threshold[:, None], proj.visible.to(f32)[:, None],
    ], dim=1).detach())
    return torch.cat(cols, dim=1)


def unpack_projection(table: torch.Tensor, gut: bool):
    """`pack_projection`'s inverse: -> (Projected, GUT features [n, 16] or None)."""
    off = N_PROJ_DIFF + (N_GUT if gut else 0)
    nd = table[:, off:off + N_PROJ_INT].detach()
    visible = nd[:, 6] > 0.5
    proj = Projected(
        mean2d=table[:, 0:2],
        conic=table[:, 2:5],
        opacity=table[:, 5],
        color=table[:, 6:9],
        depth=table[:, 9],
        tile_min=nd[:, 0:2].to(torch.int32),
        tile_max=nd[:, 2:4].to(torch.int32),
        n_tiles=torch.where(visible, nd[:, 4].to(torch.int32), 0),
        power_threshold=nd[:, 5],
        visible=visible,
    )
    return proj, (table[:, N_PROJ_DIFF:off] if gut else None)


def compact_visible(proj: Projected, feats: torch.Tensor | None, budget: int):
    """A local-shard projection (and its GUT features) compacted to its visible rows in
    `budget` slots -> (packed table [budget, W], n_visible_local []). Rows beyond the
    budget are DROPPED: the caller reports n_visible_local so that the host grows the
    budget and redoes the step (raster_mc.py:74-145).

    One row gather of the packed table; its backward is one `index_add_` into the owning
    rows. Dead slots (past n_visible) gather DISTINCT rows (slot i reads row i, masked
    invisible): one shared dummy row would make the backward a colliding scatter-add on
    one row, which serialises on the card's atomics as it does on the TPU. Callers skip
    the compaction when budget >= n: it would gather more rows than it saves."""
    vis = proj.visible
    n = vis.shape[0]
    if budget >= n:
        raise ValueError(f"compact_visible with budget {budget} >= {n} rows: skip it")
    pos = torch.cumsum(vis.to(torch.int32), 0) - 1
    n_vis = pos[-1] + 1
    keep = vis & (pos < budget)
    take = torch.arange(budget, dtype=torch.long, device=vis.device)
    take[pos[keep].long()] = torch.arange(n, device=vis.device)[keep]
    slot_ok = torch.arange(budget, device=vis.device) < n_vis
    packed = pack_projection(proj, feats).index_select(0, take)
    # the last column is the visibility: a dead slot's row is not visible
    ok = (slot_ok & (packed[:, -1] > 0.5)).to(packed.dtype)
    return torch.cat([packed[:, :-1], ok[:, None].detach()], dim=1), n_vis.to(torch.int32)


class GatherRows(torch.autograd.Function):
    """All-gather of the projected table over gauss; backward: a reduce-scatter (sum) of
    the gradient, each shard's rows to their owner."""

    @staticmethod
    def forward(ctx, table, mesh: Mesh):
        ctx.mesh = mesh
        return mesh.all_gather(table, "gauss")

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.reduce_scatter(grad.contiguous(), "gauss"), None


class GatherImageRows(torch.autograd.Function):
    """All-gather of each gauss rank's window of image rows ([K, h, W] -> [K, G h, W]);
    backward: this rank's own rows of the gradient (every rank computed the same loss)."""

    @staticmethod
    def forward(ctx, img, mesh: Mesh):
        ctx.mesh, ctx.rows = mesh, img.shape[1]
        return mesh.all_gather(img.transpose(0, 1), "gauss").transpose(0, 1)

    @staticmethod
    def backward(ctx, grad):
        g0 = ctx.mesh.g * ctx.rows
        return grad[:, g0:g0 + ctx.rows].contiguous(), None


class BatchRender(NamedTuple):
    images: torch.Tensor  # [B_loc, 3, H, W], every gauss rank the same
    total_instances: torch.Tensor  # [B_loc] int32 (this rank's window)
    max_tile_count: torch.Tensor  # [B_loc] int32
    n_visible: torch.Tensor  # [B_loc] int32 (window-visible rows of the gathered table)
    n_shard_visible: torch.Tensor  # [B_loc] int32 (visible rows of the local shard)
    visible: torch.Tensor  # [B_loc, C_loc] bool: full-image visibility of the shard's rows


def render_batch_mc(
    mesh: Mesh,
    params: dict,  # this rank's rows of the splat parameters
    alive: torch.Tensor,  # [C_loc] bool
    mean2d_offset,  # [B_loc, C_loc, 2] zeros requiring grad (ADC's dL/dmean2d), or None
    w2cs: torch.Tensor,  # [B_loc, 4, 4] this data group's cameras
    cam_positions: torch.Tensor,  # [B_loc, 3]
    intr,  # [B_loc, 4] fx fy cx cy (host numbers)
    sh_deg: int,
    bg_color: torch.Tensor,  # [3]
    *,
    width: int,
    height: int,
    plan,  # RasterPlan; max_instances / k_max / gather_budget are per-rank budgets
    dist=None,  # [B_loc, 12] per-camera distortion coefficients (GUT)
    cam_params=None,  # CameraParams (model, shutter): not None selects GUT
    max_angle: float | None = None,
    impl: str = "kernel",  # "plain": the kernels' plain versions on any device
) -> BatchRender:
    """Renders this data group's cameras over the gauss axis (raster_mc.py:168-339)."""
    g = mesh.gauss
    ts = plan.tile_size
    gw = -(-width // ts)
    gh = -(-height // ts)
    gh_loc = -(-gh // g)
    y0 = mesh.g * gh_loc
    budget = plan.gather_budget
    gut = cam_params is not None
    if gut and (cam_params.shutter != "global" or cam_params.model == "ortho"):
        raise NotImplementedError(
            "batched GUT supports global-shutter non-ortho models; rolling shutter and "
            "ORTHO use the single-camera path")
    chunk = plan.chunk if plan.chunk in (128, 256) else 128
    n_loc = alive.shape[0]
    prm = params
    images, tots, mxts, nvis, nshard, viss = [], [], [], [], [], []
    for b in range(w2cs.shape[0]):
        fx, fy, cx, cy = (float(v) for v in intr[b])
        w2c, cpos = w2cs[b], cam_positions[b]
        feats = None
        if gut:
            cp = bind_coeffs(cam_params, None if dist is None else dist[b])
            ma = fisheye_max_angle(cp) if cp.model == "fisheye" and max_angle is None \
                else max_angle
            proj, comp = ut_project(
                prm["means"].detach(), prm["scaling_raw"].detach(),
                prm["rotation_raw"].detach(), prm["opacity_raw"].detach(), alive,
                w2c.detach(), fx, fy, cx, cy, cp, width, height, ts, ma, impl=impl)
            feats = gut_feature_table(prm["means"], prm["scaling_raw"], prm["rotation_raw"],
                                      prm["opacity_raw"], prm["sh0"], prm["shN"], cpos,
                                      sh_deg, proj, comp)[:N_GUT].T
        else:
            proj = project(prm["means"], prm["scaling_raw"], prm["rotation_raw"],
                           prm["opacity_raw"], prm["sh0"], prm["shN"], alive, w2c, cpos,
                           fx, fy, cx, cy, width, height, sh_deg, tile_size=ts,
                           impl=impl)
            if mean2d_offset is not None:
                proj = proj._replace(mean2d=proj.mean2d + mean2d_offset[b])
        # full-image visibility of the shard's rows: ADC's signal, as RasterAux.visible
        viss.append(proj.visible.detach())
        # the packed table exists only for a row gather (compaction, or the gauss axis)
        table = None
        if budget is not None and budget < n_loc:
            table, n_vis_loc = compact_visible(proj, feats, budget)
        else:
            n_vis_loc = proj.visible.sum(dtype=torch.int32)
        if g > 1:
            table = GatherRows.apply(pack_projection(proj, feats) if table is None else table,
                                     mesh)
        projf, featf = (proj, feats) if table is None else unpack_projection(table, gut)
        wproj = _window_proj(projf, y0, gh_loc)
        with torch.no_grad():
            inst = build_sorted_instances(wproj, gw, gh_loc, plan.max_instances, ts,
                                          expand=impl, tile_y0=y0, image_tiles=gw * gh)
        if gut:
            rays = pixel_world_rays(w2c.detach(), cpos.detach(), fx, fy, cx, cy, cp, ma,
                                    None, grid_w=gw, grid_h=gh_loc, tile_size=ts,
                                    width=width, height=height, tile_y0=y0, impl=impl)
            gtab = torch.cat([featf.T, wproj.depth[None]])
            dims = dict(n_tiles=gw * gh_loc, tile_size=ts, k_max=plan.k_max,
                        chunk=GUT_CHUNK)
            # K6's rows reduce through K4, the lane the Trainer keeps
            out = GutBlendTiles.apply(gtab, rays, inst, dims, impl, "segsum")
            tc, ta = out[:, :, 0:3], 1.0 - out[:, :, 3]
        else:
            tc, ta, _ = blend_instances(inst, feature_table(wproj), grid_w=gw, grid_h=gh_loc,
                                        tile_size=ts, k_max=plan.k_max, chunk=chunk,
                                        impl=impl, pack_bf16=plan.pack_bf16, tile_y0=y0)
        img, alpha = assemble_image(tc, ta, gw, gh_loc, ts, gw * ts, gh_loc * ts)
        img = img + (1.0 - alpha)[None] * bg_color.reshape(3, 1, 1)
        if g > 1:
            img = GatherImageRows.apply(img, mesh)
        images.append(img[:, :height, :width])
        tots.append(inst.total_instances)
        mxts.append(inst.max_tile_count)
        nvis.append(inst.n_visible)
        nshard.append(n_vis_loc)
    stack = lambda xs: torch.stack([x.to(torch.int32) for x in xs])  # noqa: E731
    return BatchRender(images=torch.stack(images), total_instances=stack(tots),
                       max_tile_count=stack(mxts), n_visible=stack(nvis),
                       n_shard_visible=stack(nshard), visible=torch.stack(viss))
