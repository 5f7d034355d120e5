"""The ADC train cells' run (loop `train_adc`): the program's `Trainer.train` under
adaptive density control (`strategy` "default"), resumed through `Trainer.resume` from a
checkpoint the benchmark writes, on a COLMAP capture the benchmark writes. The warm-up,
the window and the traced stretch are `sb_train`'s (`Window`).

Set-up makes the seeded scene in `pool_slots` slots, `n_gaussians` alive; widens a seeded
share of the Gaussians (`widened_share`: all three scales alike, so that the largest lies
`widened_max` x grow_scale3d x scene_scale, above the split test and below the scale
prune), as the drawn footprints all lie under the split test; renders the capture's
photographs with the plain reference from a perturbed copy; and writes the checkpoint of
iteration `resume_iteration` with zero Adam moments and the densification info of the
steps since the last refinement (`draw_stats`). These inputs, which a user has on disk
before starting, are left out of `setup_s`.

The window's first `compare_steps` steps are recorded as the Trainer takes them, with an
ADC refinement after the first when `resume_iteration` + 1 falls on the refine schedule
(and the opacity reset, when it falls on the reset schedule). Once the Trainer is freed,
the plain reference (`sb_reference_adc`) takes the first step from the same checkpoint and
view, and the refinement and the later steps from the state the program held after its
first step, with the reference's own densification info. The refinement's eps is redrawn
from the generator state the checkpoint holds: nothing else draws from it under ADC.

    python3 splatbench/sb_train_adc.py --workload garden-adc-3m.train --resume 8999 \\
        --seconds 10 --seeds <n> [<n> ...]

runs the cell resumed at another iteration (8999: the refinement and the opacity reset
after step 9000 among the compared steps) and prints each seed's compared numbers; the
benchmark's own runs never run this.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import tempfile
import time
import zipfile
from pathlib import Path

import numpy as np
import torch

import sb_inputs as inp
import sb_reference as ref
import sb_reference_adc as adc
from sb_train import (NOT_TAKEN, Recorder, WarmedUp, Window, camera_dist, gaps, ref_camera,
                      step_config, sync)

LIMITS = ("loss_gap", "grad_gap", "step_gap", "change_gap", "grown_gap")


@torch.no_grad()
def widen(params: dict, alive, cfg: dict, scene_scale: float, seed: int, dev):
    """The scene with a seeded share (`widened_share`) of its alive Gaussians scaled up,
    all three axes alike, so that the largest scale lies uniformly in `widened_max` x
    grow_scale3d x scene_scale. -> (params, the number widened)"""
    g = inp.generator(seed, dev, 6)
    u = torch.rand((alive.shape[0], 2), generator=g, device=dev)
    pick = alive & (u[:, 0] < cfg["widened_share"])
    lo, hi = cfg["widened_max"]
    target = (lo + (hi - lo) * u[:, 1]) * cfg["optimization"]["grow_scale3d"] * scene_scale
    gain = torch.log(target) - params["scaling_raw"].amax(1)
    scaling = torch.where(pick[:, None], params["scaling_raw"] + gain[:, None],
                          params["scaling_raw"])
    return dict(params, scaling_raw=scaling), int(pick.sum())


@torch.no_grad()
def draw_stats(alive, cfg: dict, since: int, seed: int, dev) -> dict:
    """The densification info of the `since` steps after the last refinement: each alive
    slot seen in every one (count = since) with an average gradient grad_threshold x
    exp(s (z - z_q)), z standard normal, s = `stats_log_sigma`, z_q the normal quantile at
    1 - `candidate_share`, so that that share of the alive slots lies above the
    threshold. -> dict(count, grad2d) [C] float32"""
    g = inp.generator(seed, dev, 7)
    z = torch.randn(alive.shape[0], generator=g, device=dev)
    zq = statistics.NormalDist().inv_cdf(1.0 - cfg["candidate_share"])
    count = since * alive.float()
    avg = cfg["optimization"]["grad_threshold"] * torch.exp(cfg["stats_log_sigma"] * (z - zq))
    return dict(count=count, grad2d=count * avg)


def write_checkpoint(path: Path, params: dict, alive: np.ndarray, stats: dict,
                     step_count: int, iteration: int, rng_state: np.ndarray,
                     rng_device: str, rng_seed: int, scene_scale: float,
                     max_sh_degree: int, extra: dict) -> None:
    """`sb_inputs.write_checkpoint`'s layout with the densification info `stats` (numpy
    count, grad2d) in place of zeros."""
    arrays = {f"splat/{k}": params[k] for k in ref.PARAMS}
    arrays["splat/alive"] = alive
    arrays["dens_count"], arrays["dens_grad2d"] = stats["count"], stats["grad2d"]
    zeros = {}
    for k in ref.PARAMS:
        zeros[f"adam/exp_avg/{k}"] = np.zeros_like(params[k])
        zeros[f"adam/exp_avg_sq/{k}"] = np.zeros_like(params[k])
        arrays[f"adam/step_count/{k}"] = np.int32(step_count)
    arrays["iteration"] = np.int32(iteration)
    arrays["__torch_rng_state__"] = rng_state
    arrays["__rng_key_data__"] = np.array([0, rng_seed & 0xFFFFFFFF], np.uint32)
    with zipfile.ZipFile(path, "w", allowZip64=True) as z:
        for k, v in arrays.items():
            z.writestr(k + ".npy", inp._npy(v), compress_type=zipfile.ZIP_STORED)
        for k, v in zeros.items():
            z.writestr(k + ".npy", inp._npy(v), compress_type=zipfile.ZIP_DEFLATED,
                       compresslevel=1)
    meta = dict(max_sh_degree=max_sh_degree, scene_scale=scene_scale, capacity=alive.shape[0],
                has_bilateral=False, has_pose=False, pose_n_layers=0, has_admm=False,
                extra=extra, torch_rng_device=rng_device)
    Path(str(path) + ".json").write_text(json.dumps(meta, indent=2))


def build_inputs(cell: dict, seed: int, dev, root: Path, log=print) -> dict:
    """The scene, the capture on disk and the checkpoint. -> what the run and the
    reference share (host copies of the checkpoint's parameters and info among them)"""
    cfg, tr = cell["config"], cell["traffic"]
    opt = cfg["optimization"]
    w, h, tile, n = cfg["width"], cfg["height"], opt["tile_size"], cfg["n_gaussians"]
    focal = cfg["focal_ratio"] * w
    params, alive = inp.make_scene(n, cfg["pool_slots"], w, h, seed, dev)
    poses = [inp.as_written(v) for v in
             inp.capture_views(seed, cfg["views"], cfg["view_rot"], cfg["view_trans"])]
    names = [f"view_{i:03d}.png" for i in range(len(poses))]
    n_sfm = min(tr["sfm_points"], n)
    pick = torch.randperm(n, generator=inp.generator(seed, dev, 3), device=dev)[:n_sfm]
    points = params["means"][pick].cpu().numpy()
    colors = torch.clamp(0.5 + ref.SH_C0 * params["sh0"][pick, 0], 0, 1)
    colors_u8 = torch.round(colors * 255).to(torch.uint8).cpu().numpy()
    # the scene scale a Trainer computes from this capture (as `sb_train.build_inputs`)
    centre = np.mean(np.stack([-p[:3, :3].T @ p[:3, 3] for p in poses]), 0).astype(np.float32)
    scene_scale = float(np.median(np.linalg.norm(points.astype(np.float32) - centre, axis=1)))
    params, n_wide = widen(params, alive, cfg, scene_scale, seed, dev)
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
    log(f"capture written ({len(targets)} views; {n_wide} Gaussians widened)")
    inp.write_colmap(root / "capture" / "sparse" / "0", poses, names, focal, w, h,
                     points.astype(np.float64), colors_u8, model=cfg["camera_model"],
                     distortion=tuple(cfg["distortion"]))
    host = {k: v.cpu().numpy() for k, v in params.items()}
    alive_np = alive.cpu().numpy()
    it0 = tr["resume_iteration"]
    stats = {k: v.cpu().numpy() for k, v in
             draw_stats(alive, cfg, it0 % opt["refine_every"], seed, dev).items()}
    g = inp.generator(seed, dev, 5)
    rng_state = g.get_state().clone()
    ckpt = root / f"checkpoint_{it0}.npz"
    write_checkpoint(ckpt, host, alive_np, stats, step_count=it0, iteration=it0 + 1,
                     rng_state=rng_state.numpy(), rng_device=dev.type,
                     rng_seed=g.initial_seed(), scene_scale=scene_scale, max_sh_degree=3,
                     extra=dict(samples_drawn=it0))
    return dict(ckpt=ckpt, host=host, alive=alive_np, stats=stats, widened=n_wide,
                poses=dict(zip(names, poses)), targets=targets, rng_state=rng_state,
                scene_scale=scene_scale, focal=focal, first=it0 + 1, tile=tile)


class AdcRecorder(Recorder):
    """`sb_train.Recorder`, keeping also the alive slots and scales that the refinement
    between the first two steps left."""

    def _step(self, ts, *a, **kw):
        it = ts.iteration
        if self.active and it == self.first + 1:
            left = dict(alive=ts.splat.alive.clone(),
                        scaling_raw=ts.splat.scaling_raw.detach().clone())
        new_ts, stats = super()._step(ts, *a, **kw)
        if self.active and it == self.first + 1:
            self.steps[it]["left"] = left
        return new_ts, stats


def run(cell: dict, seed: int, seconds: float, trace: bool, dev, t_start: float,
        log=print, controls=()) -> dict:
    """One run of an ADC train cell. `controls`: readings to take besides the program's
    ("lowered" or another feature precision, "half", "norefine"; control.py). -> the
    run's record (see run.py): `sb_train.run`'s, with the window's ADC refinements
    (`adc_refines`, each one's counts in `refinements`), the alive count and pool size at
    the close, and the pool's growths in the window (None where the program counts none)"""
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
        rec = AdcRecorder(trainer, data["first"], tr["compare_steps"])
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
            n_log, grows = len(trainer.refine_log), getattr(trainer, "pool_grows", None)
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
        start, end = out["start"], out["end"]
        iterations = end["it"] - start["it"]
        refines = [{k: r[k] for k in ("iteration", "n_dup", "n_split", "n_pruned", "n_alive")}
                   for r in trainer.refine_log[n_log:]
                   if r["kind"] == "adc" and start["it"] <= r["iteration"] < end["it"]]
        record = dict(kind="train", setup_s=out["setup_s"], inputs_s=inputs_s,
                      memory_peak_bytes=peak, window_s=end["time"] - start["time"],
                      attempted=iterations, iterations=iterations,
                      redos=end["redos"] - start["redos"],
                      dispatched=end["dispatched"] - start["dispatched"],
                      # spans the program sets at first use count from 0
                      timings={k: v - start["timings"].get(k, 0.0)
                               for k, v in end["timings"].items()},
                      failed=int((~np.isfinite(losses)).sum()),  # steps with no finite loss
                      plan=str(trainer.plan), n_redo_total=trainer.n_redo,
                      adc_refines=len(refines), refinements=refines,
                      alive_end=trainer.n_alive(), pool_end=trainer.state.splat.capacity,
                      pool_grows=None if grows is None else trainer.pool_grows - grows,
                      widened=data["widened"], trace=out.get("trace"))
        steps = rec.steps if start["it"] == data["first"] else {}
        del trainer, win, rec
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        log(f"Trainer stopped at {time.perf_counter() - t_start:.1f} s")
        record["checks"] = compare_steps(cell, data, steps, dev)
        log(f"reference compared at {time.perf_counter() - t_start:.1f} s")
        if controls:
            record["controls"] = control_readings(cell, data, record["checks"]["views"],
                                                  dev, controls)
        return record
    finally:
        shutil.rmtree(root, ignore_errors=True)


def reference_steps(cell: dict, data: dict, views: list[str], dev, features: str,
                    half: bool = False, refine: bool = True,
                    follow: dict | None = None) -> list[dict]:
    """The plain reference's ADC steps from the checkpoint over `views` (view names);
    `follow`: the state a judged side holds after its first step, from which the
    refinement and the later steps start (`sb_reference_adc.train_steps`)."""
    cfg = cell["config"]
    w, h = cfg["width"], cfg["height"]
    p0 = {k: torch.as_tensor(v, device=dev) for k, v in data["host"].items()}
    alive = torch.as_tensor(data["alive"], device=dev)
    stats = {k: torch.as_tensor(v, device=dev) for k, v in data["stats"].items()}
    zeros = {k: torch.zeros_like(v) for k, v in p0.items()}
    counts = {k: data["first"] - 1 for k in p0}
    g = torch.Generator(device=dev)
    g.set_state(data["rng_state"])
    pairs = [(ref_camera(data["poses"][v], data["focal"], w, h, dev, camera_dist(cfg)),
              inp.from_u8(data["targets"][v], dev)) for v in views]
    return adc.train_steps(p0, zeros, dict(zeros), counts, alive, stats, pairs, data["first"],
                           cfg["optimization"], step_config(cell, dev), data["scene_scale"],
                           g, features=features, half=half, refine=refine, follow=follow)


def grown_gap(side: dict, base: list[dict]) -> float:
    """The share of slots on which the side's refinement did otherwise than the
    reference's, by `sb_reference_adc.decisions`: a slot kept, grown into, moved (a split)
    or pruned on one side and not on the other. 0 where the compared steps hold no
    refinement."""
    if len(base) < 2 or base[1]["codes"] is None:
        return 0.0
    a1 = side["after1"]
    before = dict(means=a1["params"]["means"], scaling_raw=a1["params"]["scaling_raw"],
                  alive=a1["alive"])
    codes = adc.decisions(before, side["refined"] or before)
    return float((codes != base[1]["codes"]).float().mean())


def judged(cell: dict, data: dict, side: dict, views: list[str], dev) -> dict:
    """The compared numbers of a side against the reference's steps from its state after
    the first step (`sb_train.gaps` and `grown_gap`), with the reference's refinement
    counts (n_dup, n_split, n_pruned) before each step."""
    base = reference_steps(cell, data, views, dev, cell["features"], follow=side["after1"])
    p0 = {k: torch.as_tensor(v, device=dev) for k, v in data["host"].items()}
    return dict(gaps(side, base, p0), grown_gap=grown_gap(side, base),
                grown=[b["grown"] for b in base])


def compare_steps(cell: dict, data: dict, steps: dict, dev) -> dict:
    """The program's recorded steps against the reference's."""
    first, n = data["first"], cell["traffic"]["compare_steps"]
    if not all(first + j in steps for j in range(n)):  # the Trainer never took them
        return dict({k: NOT_TAKEN for k in LIMITS}, views=[])
    views = [steps[first + j]["view"] for j in range(n)]
    refined = adc.refining(first, cell["config"]["optimization"]) and n > 1
    left = steps[first + 1] if refined else None
    side = dict(losses=[float(steps[first + j]["loss"]) for j in range(n)],
                after1=steps[first]["after1"], params=steps[first + n - 1]["params"],
                refined=dict(left["left"], means=left["refined"]) if refined else None)
    return dict(judged(cell, data, side, views, dev), views=views)


def as_side(steps: list[dict]) -> dict:
    """A reference run put in the program's place."""
    first = steps[0]
    return dict(losses=[s["loss"] for s in steps], params=steps[-1]["params"],
                after1={k: first[k] for k in ("params", "m", "v", "alive")},
                refined=steps[1]["refined"] if len(steps) > 1 else None)


def control_readings(cell: dict, data: dict, views: list[str], dev, controls) -> dict:
    """The compared numbers of the reference put in the program's place: "half" with the
    planted fault of a loss over half of the image, "norefine" with the planted fault of
    the refinement skipped, any other name the reference with the blend's inputs at that
    precision ("lowered": mean and conic bf16, opacity and colour float8)."""
    out = {}
    for c in controls:
        if c == "half":
            steps = reference_steps(cell, data, views, dev, cell["features"], half=True)
        elif c == "norefine":
            steps = reference_steps(cell, data, views, dev, cell["features"], refine=False)
        else:
            steps = reference_steps(cell, data, views, dev, c)
        out[c] = judged(cell, data, as_side(steps), views, dev)
    return out


def main(argv=None) -> int:
    import argparse
    import sys

    import run as sbrun

    ap = argparse.ArgumentParser(description="an ADC train cell resumed at another iteration")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--resume", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sb_train_adc: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(1, str(sbrun.HERE.parent))
    bench = sbrun.read_json(sbrun.HERE.parent / "BENCHMARK.json")
    cell = sbrun.load_cell(bench, args.workload, listed=False)
    cell["traffic"] = dict(cell["traffic"], resume_iteration=args.resume)
    for seed in args.seeds:
        rec = sbrun.run_cell(cell, seed, args.seconds, False, torch.device("cuda"),
                             time.perf_counter())
        res = sbrun.result_line(bench, cell, rec, False, {})
        print(json.dumps(dict(seed=seed, resume=args.resume, correct=res["correct"],
                              checks=rec["checks"], refinements=rec["refinements"],
                              memory_peak_bytes=rec["memory_peak_bytes"])), flush=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
