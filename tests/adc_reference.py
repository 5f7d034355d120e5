"""A plain PyTorch reference of 3D Gaussian Splatting's adaptive density control (ADC:
Kerbl et al., SIGGRAPH 2023; LichtFeld's `default_strategy.cpp`, `--strategy default`),
for the CPU tests of `tpu_splat_torch`'s ADC path (`tests/test_torch_adc_reference.py`).
It imports nothing of JAX, of the JAX package or of the port, and works Gaussian by
Gaussian, so it is meant for pools of hundreds of slots. The train step's frame, loss,
dL/dmean2d and Adam are the benchmark's plain reference (`splatbench/sb_reference.py`,
`splatbench/sb_reference_adc.py`), which import nothing of the program either.

What it computes:

- the accumulation after a step (kernels_backward.cuh:232-236): each visible Gaussian's
  count + 1 and its screen gradient's norm ||(dL/dx W/2, dL/dy H/2)|| added;
- grow (default_strategy.cpp:164-192): the alive Gaussians whose average gradient
  (sum / max(count, 1)) exceeds the threshold; one whose largest scale is at most
  grow_scale3d x scene_scale is duplicated (an exact copy, zero Adam moments at the copy),
  any other split (:87-162) into two children at mean + R (s * eps_b), b = 0, 1, scales
  s / 1.6, the opacity kept, zero moments at both;
- prune (:229-249): opacity < prune_opacity or |q|^2 < 1e-8, and after the first opacity
  reset a largest scale > prune_scale3d x scene_scale;
- the opacity reset (:251-290): logits clamped to logit(2 prune_opacity), the opacity
  moments zeroed.

Departures, each the program's stated layout of a fixed pool: a new Gaussian takes a free
slot, where LichtFeld appends it. The r-th free slot (ascending) takes the r-th
duplicate by descending average gradient (ties by slot); the splits' second children
take the free slots left, in the same order, and the first child stays in the split
Gaussian's slot. A pool short of free slots grants the duplicates first and then the
splits, best first; a split whose second child finds no slot does not happen (LichtFeld's
pool is never short). The scale prune's iteration is the one passed in.
"""

from __future__ import annotations

import math
import sys
from pathlib import Path

import torch

sys.path.append(str(Path(__file__).resolve().parents[1] / "splatbench"))
import sb_reference as sbref  # noqa: E402
import sb_reference_adc as sbadc  # noqa: E402

PARAMS = sbref.PARAMS


def accumulate(count, grad2d, mean2d, visible, width: int, height: int):
    """-> (count, grad2d) after one step's screen gradients `mean2d` [C, 2]."""
    count, grad2d = count.clone(), grad2d.clone()
    for i in range(count.shape[0]):
        if bool(visible[i]):
            gx = float(mean2d[i, 0]) * (0.5 * width)
            gy = float(mean2d[i, 1]) * (0.5 * height)
            count[i] += 1.0
            grad2d[i] += math.sqrt(gx * gx + gy * gy)
    return count, grad2d


def rotation(q) -> torch.Tensor:
    """The rotation matrix of one unnormalised wxyz quaternion."""
    w, x, y, z = (float(c) for c in q / torch.linalg.vector_norm(q))
    return torch.tensor([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def grow(p: dict, m: dict, v: dict, alive, avg, grad_threshold: float, grow_scale3d: float,
         scene_scale: float, eps):
    """Duplicates and splits of the Gaussians whose average gradient `avg` [C] exceeds
    the threshold; `eps` [2, C, 3]. -> (params, m, v, alive, n_dup, n_split)"""
    cap = alive.shape[0]
    cands = [i for i in range(cap) if bool(alive[i]) and float(avg[i]) > grad_threshold]
    small = {i: float(torch.exp(p["scaling_raw"][i]).max()) <= grow_scale3d * scene_scale
             for i in cands}

    def ranked(ids):
        return sorted(ids, key=lambda i: (-float(avg[i]), i))

    dups = ranked(i for i in cands if small[i])
    splits = ranked(i for i in cands if not small[i])
    free = [i for i in range(cap) if not bool(alive[i])]
    q = {k: x.clone() for k, x in p.items()}
    m, v, alive = ({k: x.clone() for k, x in m.items()}, {k: x.clone() for k, x in v.items()},
                   alive.clone())

    def zero(slot):
        for d in (m, v):
            for x in d.values():
                x[slot] = 0.0

    n_dup = min(len(dups), len(free))
    for src, slot in zip(dups[:n_dup], free[:n_dup]):
        for k in PARAMS:
            q[k][slot] = p[k][src]
        zero(slot)
        alive[slot] = True
    free = free[n_dup:]
    n_split = min(len(splits), len(free))
    for src, slot_b in zip(splits[:n_split], free[:n_split]):
        r = rotation(p["rotation_raw"][src])
        s = torch.exp(p["scaling_raw"][src])
        for b, slot in ((0, src), (1, slot_b)):
            if b:
                for k in PARAMS:
                    q[k][slot] = p[k][src]
            q["means"][slot] = p["means"][src] + r @ (s * eps[b, src])
            q["scaling_raw"][slot] = torch.log(s / 1.6)
            zero(slot)
        alive[slot_b] = True
    return q, m, v, alive, n_dup, n_split


def prune(p: dict, alive, iteration: int, prune_opacity: float, prune_scale3d: float,
          reset_every: int, scene_scale: float):
    """-> (alive, n_pruned)"""
    alive = alive.clone()
    n = 0
    for i in range(alive.shape[0]):
        if not bool(alive[i]):
            continue
        o = 1.0 / (1.0 + math.exp(-float(p["opacity_raw"][i, 0])))
        out = o < prune_opacity or float((p["rotation_raw"][i] ** 2).sum()) < 1e-8
        if iteration > reset_every:
            big = float(torch.exp(p["scaling_raw"][i]).max()) > prune_scale3d * scene_scale
            out = out or big
        if out:
            alive[i] = False
            n += 1
    return alive, n


def reset_opacity(p: dict, m: dict, v: dict, prune_opacity: float):
    """-> (params, m, v)"""
    t = 2.0 * prune_opacity
    q = dict(p, opacity_raw=torch.clamp_max(p["opacity_raw"], math.log(t / (1.0 - t))))
    return (q, dict(m, opacity_raw=torch.zeros_like(m["opacity_raw"])),
            dict(v, opacity_raw=torch.zeros_like(v["opacity_raw"])))


def train_step(p: dict, m: dict, v: dict, counts: dict, alive, count, grad2d, cam: dict,
               target, iteration: int, opt: dict, scene_scale: float, tile: int = 16):
    """One ADC train step (no MCMC noise): the benchmark reference's frame, loss,
    dL/dmean2d and Adam, then this module's accumulation. `opt`: the optimisation preset
    (a dict). -> (loss, params, m, v, counts, count, grad2d)"""
    step = dict(degree=min(iteration // opt["sh_degree_interval"], 3), tile=tile,
                lambda_dssim=opt["lambda_dssim"], scale_reg=opt["scale_reg"],
                opacity_reg=opt["opacity_reg"], bg=torch.zeros(3))
    loss, grads, mean2d, visible = sbadc.loss_and_grads(p, alive, cam, target, step)
    p, m, v, counts = sbref.adam(p, grads, m, v, counts,
                                 sbref.group_lrs(opt, scene_scale, iteration), iteration)
    count, grad2d = accumulate(count, grad2d, mean2d, visible, cam["width"], cam["height"])
    return loss, p, m, v, counts, count, grad2d
