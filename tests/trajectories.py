"""Eval-PSNR trajectories of the JAX `Trainer` and the port's on the same small raytraced
capture, on the CPU: where two long runs part, and whether a quality gap is the port's.

    JAX_PLATFORMS=cpu python tests/trajectories.py --side jax --strategy default --out DIR
    python tests/trajectories.py --side port --strategy default --out DIR

Run the two sides as two processes (the JAX side on one XLA host device, as
`tests/test_io_and_trainer.py`'s quality-floor test runs it); each writes the capture under
DIR/capture if it is missing (`tpu_splat_torch/tools/synth_capture.py`, byte-equal to
`tests/synth_data.py`'s) and prints one `RESULT side strategy seed [(step, psnr, ssim),
...] seconds` line. `--seed` reseeds the Trainer's generator (JAX: its key), which draws
the relocations and the noise, to show a trajectory's spread. The configuration is the
7000-iteration record's schedule at a quarter on a 32x32 capture of 16 views and 400 SfM
points: 1750 iterations, max_cap 2048, refines every 25 from 125, opacity resets every 750,
SH degree up every 250, evals before and after the first reset and every 250 after it. It is too slow for the test suite (~4 min
for the port, ~10 min for JAX on an 8-core CPU); nothing imports it.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SCHEDULE = dict(iterations=1750, max_cap=2048, start_refine=125, refine_every=25,
                stop_refine=6250, reset_every=750, sh_degree_interval=250,
                enable_eval=True, eval_steps=[500, 749, 1000, 1250, 1499, 1750],
                save_steps=[], num_workers=2, min_opacity=0.005)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--side", choices=["jax", "port"], required=True)
    ap.add_argument("--strategy", choices=["mcmc", "default"], default="default")
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--seed", type=int, default=None,
                    help="reseed the Trainer's generator (the port) or key (JAX)")
    a = ap.parse_args()
    sys.path.insert(0, str(REPO))
    from tpu_splat_torch.tools.synth_capture import make_raytraced_colmap

    cap = a.out / "capture"
    if not (cap / "sparse").exists():
        make_raytraced_colmap(cap, n_cams=16, size=32, seed=0, sfm_noise=0.01, n_sfm=400)
    if a.side == "port":
        from tpu_splat_torch.core.config import (DatasetConfig, OptimizationParameters,
                                                 TrainingParameters)
        from tpu_splat_torch.training.trainer import Trainer
    else:
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
        import jax

        jax.config.update("jax_platforms", "cpu")
        from tpu_splat.core.config import (DatasetConfig, OptimizationParameters,
                                           TrainingParameters)
        from tpu_splat.training.trainer import Trainer
    params = TrainingParameters(
        dataset=DatasetConfig(data_path=str(cap), test_every=8,
                              output_path=str(a.out / f"{a.side}_{a.strategy}_{a.seed}")),
        optimization=OptimizationParameters(strategy=a.strategy, **SCHEDULE))
    t0 = time.time()
    trainer = Trainer(params, device="cpu") if a.side == "port" else Trainer(params)
    if a.seed is not None and a.side == "port":
        trainer.state.rng.manual_seed(a.seed)
    elif a.seed is not None:
        trainer.state = dataclasses.replace(trainer.state, rng=jax.random.PRNGKey(a.seed))
    trainer.train(progress_every=200)
    evals = [(r.iteration, round(float(r.psnr), 3), round(float(r.ssim), 4))
             for r in trainer.evaluator.results]
    print("RESULT", a.side, a.strategy, a.seed, evals, round(time.time() - t0, 1), flush=True)


if __name__ == "__main__":
    main()
