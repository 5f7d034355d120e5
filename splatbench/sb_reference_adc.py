"""The benchmark's plain reference of a 3DGS train step under adaptive density control
(ADC, the original recipe: Kerbl et al., SIGGRAPH 2023; LichtFeld's `--strategy default`,
`default_strategy.cpp`), in PyTorch. It imports nothing of the program, and reuses
`sb_reference`'s frame, loss and Adam:

  * the step: `sb_reference`'s pinhole frame, 0.8 L1 + 0.2 (1 - SSIM) and the
    regularisers, Adam; no MCMC noise. dL/dmean2d is taken through a zero offset added to
    the projected means, the blend's first two inputs (the only place they enter);
  * the accumulation after each step (kernels_backward.cuh:232-236): count += visible,
    grad2d += visible * ||(dL/dx * W/2, dL/dy * H/2)||, the norm in float64 rounded to
    float32;
  * grow_gs (default_strategy.cpp:164-192): the alive slots whose average gradient
    grad2d / max(count, 1) exceeds grad_threshold; one whose largest scale is at most
    grow_scale3d x scene_scale is duplicated (an exact copy, zero Adam moments at the
    copy); any other is split (:87-162) into two children at mean + R (s * eps_b), b = 0,
    1, eps standard normal, scales s / 1.6, the opacity kept (revised_opacity off, as the
    preset has it), zero moments at both;
  * prune_gs (:229-249): alive slots with opacity < prune_opacity or |q|^2 < 1e-8, and,
    after the first opacity reset (the completed iteration > reset_every), a largest
    scale > prune_scale3d x scene_scale;
  * reset_opacity (:251-290), every reset_every iterations while refining: the opacity
    logits clamped to logit(2 x prune_opacity), the opacity group's moments zeroed;
  * the schedule: grow then prune after each step `it` with start_refine < it <
    stop_refine, it % refine_every == 0 and it % reset_every >= pause_refine_after_reset;
    the averages start again from zero after each; the reset after the refinement.

Departures, each the program's stated layout:

  * the pool is fixed: a new Gaussian takes a free slot, where LichtFeld appends it. The
    r-th free slot (ascending) takes the r-th candidate by descending average gradient,
    ties by slot: the duplicates' copies first, then the splits' second children; the first
    child replaces the split Gaussian in its own slot (LichtFeld removes it and appends
    both). A pool short of free slots for every candidate raises: the program moves into a
    larger pool first, and the cell's pool has room for its compared refinement;
  * eps is one standard-normal [2, C, 3] draw from the run's generator, row b of slot i
    for child b of the Gaussian in slot i;
  * LichtFeld's `iter` in the scale prune is the step just taken; the program passes the
    next one (and so prunes by scale one refinement earlier after the first reset, at
    reset_every itself). At the compared refinements (7100, 9000) both read alike.
"""

from __future__ import annotations

import math

import torch

import sb_reference as ref


def loss_and_grads(p: dict, alive, cam: dict, target, step: dict, features: str = "f32",
                   half: bool = False):
    """The step's loss, the gradient of every leaf of `p`, dL/dmean2d [C, 2] and the
    visible slots [C]. `step` as `sb_reference.loss_and_grads`'s."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    offset = torch.zeros((alive.shape[0], 2), device=alive.device, requires_grad=True)
    feat, proj, rays = ref.frame_inputs(leaves, alive, cam, step["degree"], step["tile"])
    feat = ref.round_features(torch.cat([feat[:, :2] + offset, feat[:, 2:]], 1), features)
    feat_leaf = feat.detach().requires_grad_(True)
    frame = ref.Frame(feat_leaf, proj, cam, step["tile"], rays)
    img, _ = frame.render(step["bg"])
    img = img.requires_grad_(True)
    loss_img = ref.photometric(img, target, step["lambda_dssim"], half)
    (g_img,) = torch.autograd.grad(loss_img, img)
    frame.backward(feat_leaf, g_img, step["bg"])
    reg = ref.regularisers(leaves, alive, step["scale_reg"], step["opacity_reg"])
    torch.autograd.backward([feat, reg], [feat_leaf.grad, None])
    grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
             for k, v in leaves.items()}
    mean2d = offset.grad if offset.grad is not None else torch.zeros_like(offset)
    return (float(loss_img.detach()) + float(reg.detach()), grads, mean2d,
            proj["visible"])


@torch.no_grad()
def accumulate(stats: dict, mean2d, visible, width: int, height: int) -> dict:
    """One step's densification info added to `stats` (count, grad2d)."""
    vis = visible.float()
    gx = mean2d[:, 0].double() * (0.5 * width)
    gy = mean2d[:, 1].double() * (0.5 * height)
    mag = torch.sqrt(gx * gx + gy * gy).float()
    return dict(count=stats["count"] + vis, grad2d=stats["grad2d"] + vis * mag)


def refining(it: int, opt: dict) -> bool:
    return (opt["start_refine"] < it < opt["stop_refine"] and it % opt["refine_every"] == 0
            and it % opt["reset_every"] >= opt["pause_refine_after_reset"])


def resetting(it: int, opt: dict) -> bool:
    return 0 < it < opt["stop_refine"] and it % opt["reset_every"] == 0


def _ranked(mask, avg):
    """The slots of `mask` by descending `avg`, ties by slot."""
    idx = torch.nonzero(mask)[:, 0]
    return idx[torch.sort(-avg[idx], stable=True).indices]


@torch.no_grad()
def grow(p: dict, m: dict, v: dict, alive, stats: dict, opt: dict, scene_scale: float, eps):
    """Duplicates and splits. `eps` [2, C, 3]. -> (params, m, v, alive, n_dup, n_split)"""
    avg = stats["grad2d"] / torch.clamp_min(stats["count"], 1.0)
    high = alive & (avg > opt["grad_threshold"])
    scale = torch.exp(p["scaling_raw"])
    small = scale.amax(-1) <= opt["grow_scale3d"] * scene_scale
    dup, split = _ranked(high & small, avg), _ranked(high & ~small, avg)
    free = torch.nonzero(~alive)[:, 0]
    n_dup, n_split = dup.numel(), split.numel()
    if n_dup + n_split > free.numel():
        raise ValueError(f"{n_dup + n_split} candidates and {free.numel()} free slots")
    to_dup, to_b = free[:n_dup], free[n_dup:n_dup + n_split]
    q = {k: x.clone() for k, x in p.items()}
    for k in ref.PARAMS:
        q[k][to_dup] = p[k][dup]
    r = ref.rotmat(p["rotation_raw"][split])
    s = scale[split]
    half_raw = torch.log(s / 1.6)
    for b, slots in ((0, split), (1, to_b)):
        if b:
            for k in ref.PARAMS:
                q[k][slots] = p[k][split]
        off = (r @ (s * eps[b][split])[:, :, None])[:, :, 0]
        q["means"][slots] = p["means"][split] + off
        q["scaling_raw"][slots] = half_raw
    touched = torch.zeros_like(alive)
    touched[torch.cat([to_dup, split, to_b])] = True
    alive = alive | touched  # the copies and second children join the split ones
    return q, ref._zero_at(m, touched), ref._zero_at(v, touched), alive, n_dup, n_split


@torch.no_grad()
def prune(p: dict, alive, it: int, opt: dict, scene_scale: float):
    """-> (alive, n_pruned) after the step `it`'s refinement."""
    o = torch.sigmoid(p["opacity_raw"][:, 0])
    out = (o < opt["prune_opacity"]) | ((p["rotation_raw"] ** 2).sum(-1) < 1e-8)
    if it > opt["reset_every"]:
        big = torch.exp(p["scaling_raw"]).amax(-1) > opt["prune_scale3d"] * scene_scale
        out = out | big
    out = out & alive
    return alive & ~out, int(out.sum())


@torch.no_grad()
def reset_opacity(p: dict, m: dict, v: dict, opt: dict):
    t = 2.0 * opt["prune_opacity"]
    q = dict(p, opacity_raw=torch.clamp_max(p["opacity_raw"], math.log(t / (1.0 - t))))
    zero = torch.zeros_like(m["opacity_raw"])
    return q, dict(m, opacity_raw=zero), dict(v, opacity_raw=zero.clone())


@torch.no_grad()
def decisions(before: dict, after: dict):
    """Per slot, what a refinement did: 1 (alive before) + 2 (alive after) + 4 (its
    position or scale changed). Copies taken by other slots do not enter, so the code is
    the same whichever free slot took which candidate. -> int8 [C]"""
    changed = ((after["means"] != before["means"]).any(1)
               | (after["scaling_raw"] != before["scaling_raw"]).any(1))
    return (before["alive"].to(torch.int8) + 2 * after["alive"].to(torch.int8)
            + 4 * changed.to(torch.int8))


def train_steps(p: dict, m: dict, v: dict, counts: dict, alive, stats: dict, views: list,
                first_it: int, opt: dict, step: dict, scene_scale: float, generator,
                features: str = "f32", half: bool = False, refine: bool = True,
                follow: dict | None = None):
    """Steps `first_it`, `first_it` + 1, ... over `views` (each (cam, target)), each from
    the last one's output, with ADC's refinement (and reset) before each step that follows
    one it falls on (`refine` False: a planted fault that skips the refinement). `stats`:
    the densification info (count, grad2d) the first step adds to. `follow`: the state
    (params, m, v, alive) that a side being judged holds after its first step; the
    refinement and the later steps start from it, with this chain's own densification
    info. -> list of dicts (loss, grads, params, m, v, alive, stats after each step; grown:
    (n_dup, n_split, n_pruned) of the refinement before the step or None; refined: the
    means, scales and alive slots it left, or None; codes: its `decisions`, or None)"""
    out = []
    for j, (cam, target) in enumerate(views):
        it = first_it + j
        if j == 1 and follow is not None:
            p, m, v, alive = follow["params"], follow["m"], follow["v"], follow["alive"]
        grown = codes = refined = None
        if j and refine and refining(it - 1, opt):
            eps = torch.randn((2,) + p["means"].shape, dtype=torch.float32,
                              device=p["means"].device, generator=generator)
            before = dict(means=p["means"], scaling_raw=p["scaling_raw"], alive=alive)
            p, m, v, alive, n_dup, n_split = grow(p, m, v, alive, stats, opt, scene_scale,
                                                  eps)
            alive, n_pruned = prune(p, alive, it - 1, opt, scene_scale)
            grown = (n_dup, n_split, n_pruned)
            refined = dict(means=p["means"], scaling_raw=p["scaling_raw"], alive=alive)
            codes = decisions(before, refined)
            stats = {k: torch.zeros_like(x) for k, x in stats.items()}
        if j and resetting(it - 1, opt):
            p, m, v = reset_opacity(p, m, v, opt)
        step_j = dict(step, degree=min(it // opt["sh_degree_interval"], 3))
        loss, grads, mean2d, visible = loss_and_grads(p, alive, cam, target, step_j,
                                                      features, half)
        lrs = ref.group_lrs(opt, scene_scale, it)
        p, m, v, counts = ref.adam(p, grads, m, v, counts, lrs, it)
        stats = accumulate(stats, mean2d, visible, cam["width"], cam["height"])
        out.append(dict(loss=loss, grads=grads, params=p, m=m, v=v, alive=alive,
                        stats=stats, grown=grown, codes=codes, refined=refined))
    return out
