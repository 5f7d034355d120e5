"""Quality-of-record run on the raytraced capture (`tools/synth_capture.py`: checkerboard
ground, spheres and sky from an independent raytracer, SfM-like noisy surface points), the
port's counterpart of the repository's `tools/eval_raytraced.py`. Mirrors the reference's
per-scene protocol (eval/benchmark_mipnerf360.sh:24-45): --test-every 8, PSNR/SSIM/LPIPS
at the eval steps, metrics.csv per run.

  python -m tpu_splat_torch.tools.eval_raytraced [--size 128] [--n-cams 24] \
      [--iterations 4000] [--out DIR] [--max-cap 60000] [--device cpu]

Writes the capture under <out>/capture, trains it through the `Trainer` (the config's
defaults: MCMC) into <out>/run, prints one EVAL line per eval step and a final JSON line
with the JAX script's keys (size, n_cams, iterations, elapsed_s, steady_iters_per_s,
results) and the port's (device, n_alive, n_redo, plan_history, peak_mem_bytes). The
steady rate is taken between `TrainingProgress` marks over the last half of the run; on a
card every clock reading waits for the stream, so it is the card's rate.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from pathlib import Path

import torch


def now(device: torch.device) -> float:
    """The wall clock, after the card's stream has drained when `device` is a card."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.time()


def steady_rate(marks: list[tuple[float, int]]) -> float | None:
    """Iterations a second between the (clock, iteration) marks over the last half of a
    run, which leaves the warm-up ticks out; None with fewer than three marks."""
    if len(marks) < 3:
        return None
    (t_a, it_a), (t_b, it_b) = marks[len(marks) // 2], marks[-1]
    return (it_b - it_a) / (t_b - t_a) if t_b > t_a else None


def write_capture(out: Path, n_cams: int, size: int, height: int | None = None,
                  n_sfm: int = 2000) -> Path:
    """Writes the raytraced capture this script trains under `out`/capture; returns it."""
    from .synth_capture import make_raytraced_colmap

    cap = Path(out) / "capture"
    make_raytraced_colmap(cap, n_cams=n_cams, size=size, height=height, seed=0,
                          exposure_jitter=0.0, sfm_noise=0.01, n_sfm=n_sfm)
    return cap


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=128, help="image width")
    ap.add_argument("--height", type=int, default=None, help="image height (default square)")
    ap.add_argument("--n-cams", type=int, default=24)
    ap.add_argument("--iterations", type=int, default=4000)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "rt_eval"))
    ap.add_argument("--max-cap", type=int, default=60_000)
    ap.add_argument("--n-sfm", type=int, default=2000)
    ap.add_argument("--eval-steps", type=int, nargs="*", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)

    from ..core.config import DatasetConfig, OptimizationParameters, TrainingParameters
    from ..device import resolve_device
    from ..training.trainer import Trainer
    from ..utils import events as ev

    device = resolve_device(args.device)  # no card and no --device cpu: raise first
    out = Path(args.out)
    cap = write_capture(out, args.n_cams, args.size, args.height, args.n_sfm)

    steps = args.eval_steps or sorted({args.iterations // 4, args.iterations // 2,
                                       args.iterations})
    params = TrainingParameters(
        dataset=DatasetConfig(data_path=str(cap), output_path=str(out / "run"),
                              test_every=8),
        optimization=OptimizationParameters(
            iterations=args.iterations, max_cap=args.max_cap, enable_eval=True,
            eval_steps=steps, save_steps=[args.iterations], num_workers=2,
            min_opacity=0.005,
        ),
    )

    marks = []  # (wall time, iteration) at each progress tick -> steady-state rate
    unsubscribe = ev.when(ev.TrainingProgress,
                          lambda e: marks.append((now(device), e.iteration)))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = now(device)
    try:
        trainer = Trainer(params, device=device)
        trainer.train(progress_every=100)
    finally:
        unsubscribe()
    elapsed = now(device) - t0
    steady = steady_rate(marks)
    rows = []
    for r in trainer.evaluator.results:
        rows.append(dict(step=r.iteration, psnr=round(float(r.psnr), 3),
                         ssim=round(float(r.ssim), 4),
                         lpips=None if r.lpips is None else round(float(r.lpips), 4),
                         n_images=r.num_images))
        print("EVAL", rows[-1], flush=True)
    summary = dict(size=args.size, n_cams=args.n_cams, iterations=args.iterations,
                   elapsed_s=round(elapsed, 1),
                   steady_iters_per_s=None if steady is None else round(steady, 3),
                   results=rows, device=str(device), n_alive=trainer.n_alive(),
                   n_redo=trainer.n_redo, plan_history=trainer.plan_history,
                   peak_mem_bytes=(torch.cuda.max_memory_allocated(device)
                                   if device.type == "cuda" else None))
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
