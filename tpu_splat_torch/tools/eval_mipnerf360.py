"""MipNeRF360 7-scene evaluation protocol, the port's counterpart of the repository's
`tools/eval_mipnerf360.py`. Mirrors the reference's eval/benchmark_mipnerf360.sh:5,24-45:

  * scenes: garden bicycle stump (outdoor, images_4) + bonsai counter kitchen room
    (indoor, images_2);
  * --test-every 8 --eval, metrics at iterations 7000 and 30000;
  * per-scene metrics.csv + a cross-scene summary table (summary.csv, summary.json).

  python -m tpu_splat_torch.tools.eval_mipnerf360 --data-root /path/to/360_v2 \
      --out /path/out [--scenes garden kitchen] [--iterations 30000] \
      [--config parameter/mcmc_optimization_params.json] [--device cpu]

Each scene directory must be a COLMAP layout (sparse/0 + images_2 / images_4); the
dataset is not redistributable and is fetched per eval/README.md.
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import json
import time
from pathlib import Path

OUTDOOR = ("garden", "bicycle", "stump")
INDOOR = ("bonsai", "counter", "kitchen", "room")
SCENES = OUTDOOR + INDOOR


def run_scene(scene: str, data_root: Path, out_root: Path, iterations: int,
              config: str | None, eval_steps, device=None) -> dict:
    """Trains one scene with evals at `eval_steps`. -> its summary row."""
    from ..core.config import DatasetConfig, OptimizationParameters, TrainingParameters
    from ..training.trainer import Trainer

    images = "images_4" if scene in OUTDOOR else "images_2"
    opt = (OptimizationParameters.from_file(config) if config
           else OptimizationParameters())
    opt = dataclasses.replace(
        opt, iterations=iterations, enable_eval=True,
        eval_steps=list(eval_steps), save_steps=[iterations],
    )
    params = TrainingParameters(
        dataset=DatasetConfig(
            data_path=str(data_root / scene), output_path=str(out_root / scene),
            images=images, test_every=8,
        ),
        optimization=opt,
    )
    t0 = time.time()
    trainer = Trainer(params, device=device)
    trainer.train()
    elapsed = time.time() - t0
    results = {}
    for r in trainer.evaluator.results:
        results[r.iteration] = dict(psnr=r.psnr, ssim=r.ssim, lpips=r.lpips)
    return dict(scene=scene, images=images, elapsed_s=round(elapsed, 1), **{
        f"it{it}": results.get(it) for it in eval_steps
    })


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-root", required=True, type=Path)
    ap.add_argument("--out", required=True, type=Path)
    ap.add_argument("--scenes", nargs="*", default=list(SCENES))
    ap.add_argument("--iterations", type=int, default=30_000)
    ap.add_argument("--eval-steps", nargs="*", type=int, default=[7_000, 30_000])
    ap.add_argument("--config", default=None,
                    help="optimization preset JSON (e.g. parameter/mcmc_optimization_params."
                         "json)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)

    from ..device import resolve_device

    device = resolve_device(args.device)  # no card and no --device cpu: raise first
    args.out.mkdir(parents=True, exist_ok=True)

    rows = []
    for scene in args.scenes:
        if not (args.data_root / scene).exists():
            print(f"!! missing scene {scene} under {args.data_root}, skipping")
            continue
        print(f"=== {scene} ===", flush=True)
        rows.append(run_scene(scene, args.data_root, args.out, args.iterations,
                              args.config, args.eval_steps, device))
        (args.out / "summary.json").write_text(json.dumps(rows, indent=2))

    if rows:
        with open(args.out / "summary.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["scene", "images", "elapsed_s"] + [
                f"{m}@{it}" for it in args.eval_steps for m in ("psnr", "ssim", "lpips")
            ])
            for r in rows:
                row = [r["scene"], r["images"], r["elapsed_s"]]
                for it in args.eval_steps:
                    e = r.get(f"it{it}") or {}
                    row += [e.get("psnr"), e.get("ssim"), e.get("lpips")]
                w.writerow(row)
        print(json.dumps(rows, indent=2))
    return rows


if __name__ == "__main__":
    main()
