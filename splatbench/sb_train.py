"""The train cells' run: the program's `Trainer.train`, resumed through `Trainer.resume`
from a checkpoint the benchmark writes, on a COLMAP capture the benchmark writes.

Set-up makes the seeded scene, renders the capture's photographs with the plain
reference from a perturbed copy of it, writes them as PNGs with a COLMAP model, and
writes the scene as the checkpoint of iteration `resume_iteration` (zero Adam moments).
These inputs, which a user has on disk before starting, are left out of `setup_s`. The
Trainer is built on the capture, resumed, and trained: its own loop, loader and MCMC
schedule. A hook on the Trainer's dispatch of each chunk ends this warm-up once the plan
has stopped growing. The same Trainer is then resumed from the checkpoint again, under
the plan it has grown, and trained once more: the window opens at its first dispatch
(set-up ends there), closes after `seconds` (both ends behind a device synchronisation),
in a traced run profiles `trace_iters` more iterations, and then asks the Trainer to
stop, as a user's stop request does.

The window's first `compare_steps` steps are recorded as the Trainer takes them (a redo
overwrites them), with an MCMC refinement after the first when `resume_iteration` + 1
falls on the refine schedule. Once the window has closed and the Trainer is freed, the
plain reference takes the first step from the same checkpoint, view and generator state,
and the refinement and the later steps from the state the program held after its first
step (`gaps`).
"""

from __future__ import annotations

import math
import os
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import sb_inputs as inp
import sb_reference as ref


NOT_TAKEN = 1e9  # a compared number of steps the program never took


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def next_pow2(x: int) -> int:
    return 1 << max(int(math.ceil(math.log2(max(x, 1)))), 0)


def ref_camera(w2c: np.ndarray, focal: float, width: int, height: int, dev,
               dist=None) -> dict:
    """The reference's camera of a pose: fx = fy = focal, the principal point at the
    image centre; `dist` (k1, k2, p1, p2) makes it a distorted camera (3DGUT's path)."""
    pos = (-w2c[:3, :3].T @ w2c[:3, 3]).astype(np.float32)
    cam = dict(w2c=torch.as_tensor(w2c, device=dev), position=torch.as_tensor(pos, device=dev),
               fx=float(focal), fy=float(focal), cx=width / 2.0, cy=height / 2.0,
               width=width, height=height)
    if dist is not None:
        cam["dist"] = tuple(float(v) for v in dist)
    return cam


def camera_dist(cfg: dict):
    """The configuration's distortion (k1, k2, p1, p2), or None for a pinhole."""
    return None if cfg["camera_model"] == "PINHOLE" else cfg["distortion"]


class Recorder:
    """Wraps the program's `train_step` (as `train_step_many` and the Trainer call it) and
    keeps what the comparison needs of the steps `first` .. `first + n - 1`: each loss,
    the state after the first step (parameters, Adam's moments, the alive slots), the
    positions the second step starts from (after a refinement between the two, they show
    the sources it drew) and the parameters after the last."""

    def __init__(self, trainer, first: int, n: int):
        from tpu_splat_torch.training import train_step as ts_mod
        from tpu_splat_torch.training import trainer as tr_mod

        self.trainer, self.first, self.n = trainer, first, n
        self.active = False
        self.steps: dict[int, dict] = {}
        self.views: list[str] | None = None  # every step's view, while tracing
        self._mods = (ts_mod, tr_mod)
        self._orig = ts_mod.train_step
        for mod in self._mods:
            mod.train_step = self._step

    def close(self) -> None:
        for mod in self._mods:
            mod.train_step = self._orig

    def _step(self, ts, gt_image, w2c, cam_position, fx, fy, cx, cy, bg, cam_idx=0,
              dist=None, **kw):
        it = ts.iteration
        if self.active and it == self.first + 1:
            refined = ts.splat.means.detach().clone()
        new_ts, stats = self._orig(ts, gt_image, w2c, cam_position, fx, fy, cx, cy, bg,
                                   cam_idx, dist, **kw)
        name = self.trainer.train_cams[int(cam_idx)].image_name
        if self.active and self.first <= it < self.first + self.n:
            rec = dict(view=name, loss=stats.loss.detach().clone())
            if it == self.first + 1:
                rec["refined"] = refined
            if it == self.first:  # copies on the card: the window does not wait for them
                rec["after1"] = dict(
                    params={k: v.detach().clone() for k, v in new_ts.splat.params().items()},
                    m={k: v.detach().clone() for k, v in new_ts.adam.exp_avg.items()},
                    v={k: v.detach().clone() for k, v in new_ts.adam.exp_avg_sq.items()},
                    alive=new_ts.splat.alive.clone())
            if it == self.first + self.n - 1:
                rec["params"] = {k: v.detach().clone()
                                 for k, v in new_ts.splat.params().items()}
            self.steps[it] = rec
        if self.views is not None:
            self.views.append(name)
        return new_ts, stats


class WarmedUp(Exception):
    """Raised from the Trainer's dispatch once warm-up has settled: ends that `train`."""


class Window:
    """Warm-up and the measured window, driven from the Trainer's dispatch of each chunk.
    `t_start`: the process's start, less the seconds spent making the inputs."""

    def __init__(self, trainer, recorder, traffic: dict, seconds: float, trace: bool, dev,
                 t_start: float):
        from sb_trace import Capture

        self.t, self.rec, self.tr = trainer, recorder, traffic
        self.seconds, self.trace, self.dev, self.t_start = seconds, trace, dev, t_start
        self.phase = "warm"
        self.first = trainer.state.iteration
        self.plan, self.redos, self.stable_from = trainer.plan, trainer.n_redo, self.first
        self.capture = Capture(lambda: sync(dev))
        self.out: dict = {}
        orig = trainer._dispatch

        def dispatch(loader, it, total, progress_every, pending):
            self.on_dispatch(it)
            return orig(loader, it, total, progress_every, pending)

        trainer._dispatch = dispatch

    def _mark(self, it: int) -> dict:
        sync(self.dev)
        return dict(time=time.perf_counter(), it=it, timings=dict(self.t.timings),
                    redos=self.t.n_redo, dispatched=self.t.steps_dispatched)

    def _stop(self) -> None:
        self.phase = "done"
        self.t._stop_flag.set()

    def on_dispatch(self, it: int) -> None:
        t, tr = self.t, self.tr
        if self.phase == "warm":
            if t.plan != self.plan or t.n_redo != self.redos:
                self.plan, self.redos, self.stable_from = t.plan, t.n_redo, it
            settled = it - self.stable_from >= tr["warmup_stable_iters"]
            if (it - self.first >= tr["warmup_min_iters"] and settled
                    or it - self.first >= tr["warmup_max_iters"]):
                self.phase = "open"
                raise WarmedUp
        elif self.phase == "open":
            self.out["start"] = self._mark(it)
            self.out["setup_s"] = self.out["start"]["time"] - self.t_start
            self.phase = "window"
        elif self.phase == "window":
            if time.perf_counter() - self.out["start"]["time"] >= self.seconds:
                self.out["end"] = self._mark(it)
                if not self.trace:
                    self._stop()
                    return
                self.rec.views = []
                self.out["trace_first"] = it
                self.capture.start()
                self.phase = "trace"
        elif self.phase == "trace":
            if it - self.out["trace_first"] >= tr["trace_iters"]:
                self.out["trace"] = self.capture.stop()
                self.out["trace_views"] = list(self.rec.views)
                self.rec.views = None
                self._stop()


def build_inputs(cell: dict, seed: int, dev, root: Path, log=print) -> dict:
    """The scene, the capture on disk and the checkpoint. -> what the run and the
    reference share (host copies of the checkpoint's parameters among them)"""
    cfg, tr = cell["config"], cell["traffic"]
    opt = cfg["optimization"]
    w, h, tile = cfg["width"], cfg["height"], opt["tile_size"]
    cap = next_pow2(opt["max_cap"])
    focal = cfg["focal_ratio"] * w
    params, alive = inp.make_scene(cfg["n_gaussians"], cap, w, h, seed, dev)
    poses = [inp.as_written(v) for v in
             inp.capture_views(seed, cfg["views"], cfg["view_rot"], cfg["view_trans"])]
    names = [f"view_{i:03d}.png" for i in range(len(poses))]
    shown = inp.perturbed(params, alive, seed, dev)
    (root / "capture" / "images").mkdir(parents=True)
    targets = {}
    for w2c, name in zip(poses, names):
        img, _ = ref.render(shown, alive, ref_camera(w2c, focal, w, h, dev, camera_dist(cfg)),
                            3, tile)
        u8 = inp.to_u8(img)
        (root / "capture" / "images" / name).write_bytes(inp.encode_png(u8, tr["png_level"]))
        targets[name] = u8
    del shown
    log(f"capture written ({len(targets)} views)")
    n_sfm = min(tr["sfm_points"], cfg["n_gaussians"])
    pick = torch.randperm(cfg["n_gaussians"], generator=inp.generator(seed, dev, 3),
                          device=dev)[:n_sfm]
    points = params["means"][pick].cpu().numpy()
    colors = torch.clamp(0.5 + ref.SH_C0 * params["sh0"][pick, 0], 0, 1)
    colors_u8 = torch.round(colors * 255).to(torch.uint8).cpu().numpy()
    inp.write_colmap(root / "capture" / "sparse" / "0", poses, names, focal, w, h,
                     points.astype(np.float64), colors_u8, model=cfg["camera_model"],
                     distortion=tuple(cfg["distortion"]))
    # the scene scale a Trainer computes from this capture: the SfM points' median
    # distance from the cameras' mean position
    centre = np.mean(np.stack([-p[:3, :3].T @ p[:3, 3] for p in poses]), 0).astype(np.float32)
    scene_scale = float(np.median(np.linalg.norm(points.astype(np.float32) - centre, axis=1)))
    host = {k: v.cpu().numpy() for k, v in params.items()}
    alive_np = alive.cpu().numpy()
    g = inp.generator(seed, dev, 5)
    rng_state = g.get_state().clone()
    it0 = tr["resume_iteration"]
    ckpt = root / f"checkpoint_{it0}.npz"
    inp.write_checkpoint(ckpt, host, alive_np, step_count=it0, iteration=it0 + 1,
                         rng_state=rng_state.numpy(), rng_device=dev.type,
                         rng_seed=g.initial_seed(), scene_scale=scene_scale,
                         max_sh_degree=3, extra=dict(samples_drawn=it0))
    return dict(ckpt=ckpt, host=host, alive=alive_np, poses=dict(zip(names, poses)),
                targets=targets, rng_state=rng_state, scene_scale=scene_scale,
                focal=focal, first=it0 + 1, tile=tile, cap=cap)


def run(cell: dict, seed: int, seconds: float, trace: bool, dev, t_start: float,
        log=print, controls=()) -> dict:
    """One run of a train cell. `controls`: readings to take besides the program's
    (`control_readings`; control.py). -> the run's record (see run.py)"""
    from tpu_splat_torch.core.config import (DatasetConfig, OptimizationParameters,
                                             TrainingParameters)
    from tpu_splat_torch.training.trainer import Trainer

    cfg, tr = cell["config"], cell["traffic"]
    root = Path(tempfile.mkdtemp(prefix="splatbench-", dir=os.environ.get("TMPDIR")))
    try:
        t_in = time.perf_counter()
        data = build_inputs(cell, seed, dev, root, log)
        inputs_s = time.perf_counter() - t_in
        log(f"inputs made in {inputs_s:.1f} s, ready at {time.perf_counter() - t_start:.1f} s")
        tp = TrainingParameters(
            dataset=DatasetConfig(data_path=str(root / "capture"), output_path=str(root / "out")),
            optimization=OptimizationParameters.from_json(dict(cfg["optimization"])))
        trainer = Trainer(tp, device=dev)
        trainer.resume(data["ckpt"])
        rec = Recorder(trainer, data["first"], tr["compare_steps"])
        win = Window(trainer, rec, tr, seconds, trace, dev, t_start + inputs_s)
        try:
            try:
                trainer.train(progress_every=tr["progress_every"])
            except WarmedUp:
                pass
            if win.phase != "open":
                raise RuntimeError(f"the Trainer ended in warm-up, at iteration "
                                   f"{trainer.state.iteration}")
            log(f"warmed up at {time.perf_counter() - t_start:.1f} s: plan {trainer.plan}, "
                f"{trainer.n_redo} redo(s)")
            trainer.resume(data["ckpt"])
            data["ckpt"].unlink()
            Path(str(data["ckpt"]) + ".json").unlink()
            rec.active = True
            trainer.train(progress_every=tr["progress_every"])
        finally:
            rec.close()
        sync(dev)
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        out = win.out
        if "end" not in out:
            raise RuntimeError(f"the Trainer ended before the window closed (phase "
                               f"{win.phase}, iteration {trainer.state.iteration})")
        losses = np.asarray(trainer._loss_hist, np.float64)
        iterations = out["end"]["it"] - out["start"]["it"]
        record = dict(kind="train", setup_s=out["setup_s"], inputs_s=inputs_s,
                      memory_peak_bytes=peak, window_s=out["end"]["time"] - out["start"]["time"],
                      attempted=iterations, iterations=iterations,
                      redos=out["end"]["redos"] - out["start"]["redos"],
                      dispatched=out["end"]["dispatched"] - out["start"]["dispatched"],
                      timings={k: out["end"]["timings"][k] - out["start"]["timings"][k]
                               for k in out["start"]["timings"]},
                      failed=int((~np.isfinite(losses)).sum()),  # steps with no finite loss
                      plan=str(trainer.plan), n_redo_total=trainer.n_redo,
                      # the dead slots the program relocated after the window's first step
                      relocated=[r.get("n_relocated") for r in trainer.refine_log
                                 if r["iteration"] == data["first"]][-1:],
                      trace=out.get("trace"))
        # the compared steps are the window's first: a window that opened elsewhere
        # compares none
        steps = rec.steps if out["start"]["it"] == data["first"] else {}
        trace_views = out.get("trace_views")
        del trainer, win, rec
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        log(f"Trainer stopped at {time.perf_counter() - t_start:.1f} s")
        record["checks"] = compare_steps(cell, data, steps, dev)
        log(f"reference compared at {time.perf_counter() - t_start:.1f} s")
        if controls:
            record["controls"] = control_readings(cell, data, record["checks"]["views"],
                                                  dev, controls)
        if trace_views:
            record["work"] = work_of(cell, data, trace_views, dev)
        return record
    finally:
        shutil.rmtree(root, ignore_errors=True)


def step_config(cell: dict, dev) -> dict:
    opt = cell["config"]["optimization"]
    return dict(tile=opt["tile_size"], lambda_dssim=opt["lambda_dssim"],
                scale_reg=opt["scale_reg"], opacity_reg=opt["opacity_reg"],
                bg=torch.zeros(3, device=dev))


def reference_steps(cell: dict, data: dict, views: list[str], dev, features: str,
                    half: bool = False, relocate: bool = True,
                    follow: dict | None = None, sources=None) -> list[dict]:
    """The plain reference's steps from the checkpoint over `views` (view names);
    `follow`: the state a judged side holds after its first step, from which the
    refinement and the later steps start; `sources`: the refinement's draws, as given
    (`ref.train_steps`)."""
    cfg = cell["config"]
    w, h = cfg["width"], cfg["height"]
    p0 = {k: torch.as_tensor(v, device=dev) for k, v in data["host"].items()}
    alive = torch.as_tensor(data["alive"], device=dev)
    zeros = {k: torch.zeros_like(v) for k, v in p0.items()}
    counts = {k: data["first"] - 1 for k in p0}
    g = torch.Generator(device=dev)
    g.set_state(data["rng_state"])
    pairs = [(ref_camera(data["poses"][v], data["focal"], w, h, dev, camera_dist(cfg)),
              inp.from_u8(data["targets"][v], dev)) for v in views]
    return ref.train_steps(p0, zeros, dict(zeros), counts, alive, pairs, data["first"],
                           cfg["optimization"], step_config(cell, dev), data["scene_scale"],
                           g, features=features, half=half, relocate=relocate,
                           follow=follow, sources=sources)


def _norm(x) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def _leaf_gaps(side: dict, ref_: dict, p0: dict, leaves) -> dict:
    """Each leaf's |norm of the side's change - the reference's| over the larger of the
    reference's norm of that leaf and of its median leaf."""
    d_ref = {k: _norm(ref_[k] - p0[k]) for k in leaves}
    d_med = float(np.median(list(d_ref.values())))
    return {k: abs(_norm(side[k].to(p0[k].device) - p0[k]) - d_ref[k]) / max(d_ref[k], d_med)
            for k in leaves}


def judged(cell: dict, data: dict, side: dict, views: list[str], dev) -> tuple[list, dict]:
    """The reference's steps that judge a side, and the number of its refinement's
    targets whose copy matches no slot that could have been drawn (`unsourced`). The
    first step is the reference's own, from the checkpoint; the refinement and the
    later steps start from the side's state after the first step. The refinement's draws
    (`torch.multinomial` on the card, which does not repeat a draw from the same state)
    are read from the side's positions after it, as given; the generator draws all the
    same, so that the later steps' noise is the side's."""
    sources, unsourced = None, 0
    if side.get("refined") is not None:
        a1 = side["after1"]
        sources, unsourced = ref.drawn_sources(a1["params"], a1["alive"], side["refined"],
                                               cell["config"]["optimization"])
    base = reference_steps(cell, data, views, dev, cell["features"], follow=side["after1"],
                           sources=sources)
    return base, dict(unsourced=unsourced)


def gaps(side: dict, base: list[dict], p0: dict) -> dict:
    """The compared numbers of one side against the reference's steps `base` (taken with
    `follow` = the side's `after1`). `side`: losses [n], after1 (params, m, v, alive
    after the first step), params (after the last step).
      loss_gap: the largest |loss - reference| / reference over the steps;
      grad_gap: the first gradient (Adam's m after step 1 / 0.1), the worst leaf's
        |norm - reference's norm| over the larger of the reference's norm of that leaf
        and its median leaf's;
      step_gap: the same of each leaf's change in the first step, from the checkpoint;
      change_gap: the same of each leaf's change over all the steps: the refinement and
        the later steps the reference took from the side's state after the first;
    the last two leave out the leaves whose reference gradient is under a thousandth of
    the median leaf's. The worst leaves are named beside them (not compared)."""
    loss = max(abs(a - b["loss"]) / abs(b["loss"]) for a, b in zip(side["losses"], base))
    g_ref = {k: _norm(v) for k, v in base[0]["grads"].items()}
    g_med = float(np.median(list(g_ref.values())))
    grad = {k: abs(_norm(side["after1"]["m"][k].to(torch.float64) / (1.0 - 0.9)) - g_ref[k])
            / max(g_ref[k], g_med) for k in g_ref}
    moved = [k for k in g_ref if g_ref[k] >= 1e-3 * g_med]
    step = _leaf_gaps(side["after1"]["params"], base[0]["params"], p0, moved)
    change = _leaf_gaps(side["params"], base[-1]["params"], p0, moved)
    return dict(loss_gap=loss, grad_gap=max(grad.values()), step_gap=max(step.values()),
                change_gap=max(change.values()), grad_leaf=max(grad, key=grad.get),
                step_leaf=max(step, key=step.get), change_leaf=max(change, key=change.get),
                left_out=[k for k in g_ref if k not in moved])


def as_side(steps: list[dict]) -> dict:
    """A reference run put in the program's place."""
    first = steps[0]
    return dict(losses=[s["loss"] for s in steps], params=steps[-1]["params"],
                after1={k: first[k] for k in ("params", "m", "v", "alive")},
                refined=steps[1]["refined"] if len(steps) > 1 else None)


def compare_steps(cell: dict, data: dict, steps: dict, dev) -> dict:
    """The program's recorded steps against the reference's."""
    first, n = data["first"], cell["traffic"]["compare_steps"]
    if not all(first + j in steps for j in range(n)):  # the Trainer never took them
        return dict(loss_gap=NOT_TAKEN, grad_gap=NOT_TAKEN, step_gap=NOT_TAKEN,
                    change_gap=NOT_TAKEN, unsourced=NOT_TAKEN, views=[])
    views = [steps[first + j]["view"] for j in range(n)]
    refined = ref.refining(first, cell["config"]["optimization"]) and n > 1
    side = dict(losses=[float(steps[first + j]["loss"]) for j in range(n)],
                after1=steps[first]["after1"], params=steps[first + n - 1]["params"],
                refined=steps[first + 1]["refined"] if refined else None)
    base, extra = judged(cell, data, side, views, dev)
    p0 = {k: torch.as_tensor(v, device=dev) for k, v in data["host"].items()}
    out = dict(gaps(side, base, p0), **extra)
    out["views"] = views
    # the dead slots the reference's refinement moved before each step
    out["relocated"] = [s["relocated"] for s in base]
    return out


def control_readings(cell: dict, data: dict, views: list[str], dev, controls) -> dict:
    """The compared numbers of the reference put in the program's place: "lowered"
    computes it with the blend's inputs one precision below the stated one (mean and
    conic bf16, opacity and colour float8), "half" with the planted fault of a loss over
    half of the image, "norelocate" with the planted fault of an MCMC refinement
    skipped."""
    p0 = {k: torch.as_tensor(v, device=dev) for k, v in data["host"].items()}
    out = {}
    for c in controls:
        if c == "half":
            steps = reference_steps(cell, data, views, dev, cell["features"], half=True)
        elif c == "norelocate":
            steps = reference_steps(cell, data, views, dev, cell["features"], relocate=False)
        else:
            steps = reference_steps(cell, data, views, dev, c)
        side = as_side(steps)
        if side["refined"] is None and ref.refining(data["first"], cell["config"]["optimization"]):
            # a refinement skipped: the state the second step started from, unrefined
            side["refined"] = steps[0]["params"]["means"]
        base, extra = judged(cell, data, side, views, dev)
        out[c] = dict(gaps(side, base, p0), **extra)
    return out


def work_of(cell: dict, data: dict, views: list[str], dev) -> dict:
    """The work the traced steps needed, from the reference on the checkpoint's scene:
    pair and instance counts of each step's view, summed over the steps."""
    cfg = cell["config"]
    w, h, tile = cfg["width"], cfg["height"], data["tile"]
    p0 = {k: torch.as_tensor(v, device=dev) for k, v in data["host"].items()}
    alive = torch.as_tensor(data["alive"], device=dev)
    per_view = {}
    for v in sorted(set(views)):
        cam = ref_camera(data["poses"][v], data["focal"], w, h, dev, camera_dist(cfg))
        with torch.no_grad():
            _, proj, _ = ref.frame_inputs(p0, alive, cam, 3, tile)
        _, c = ref.render(p0, alive, cam, 3, tile, cell["features"])
        c["visible"] = int(proj["visible"].sum())
        per_view[v] = c
    total = {k: sum(per_view[v][k] for v in views) for k in per_view[views[0]]}
    gw, gh = -(-w // tile), -(-h // tile)
    total.update(steps=len(views), pixels=len(views) * w * h, tiles=len(views) * gw * gh,
                 alive=len(views) * int(data["alive"].sum()), gut=camera_dist(cfg) is not None)
    return total
