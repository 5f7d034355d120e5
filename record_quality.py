"""Quality-of-record runs of the port on the raytraced capture, on the CUDA card.

  python3 record_quality.py [--out DIR] [--adc-eval-steps STEP ...]

Both runs take RESULTS.md's command: the capture at 200x200 with 28 cameras, 7000
iterations, max_cap 100,000.

- `mcmc`: `tpu_splat_torch.tools.eval_raytraced` with those flags (the config's default
  strategy, MCMC; evals at N/4, N/2 and N), which writes the capture under OUT/capture and
  trains it into OUT/run.
- `adc`: the CLI on the same capture (written again by `eval_raytraced.write_capture`),
  `python -m tpu_splat_torch -d OUT/capture -o OUT/adc --strategy default --eval
  --test-every 8 -i N --max-cap M --headless --config OUT/adc_eval_steps.json`, the config
  file holding only `eval_steps`: the MCMC run's (N/4, N/2, N) unless `--adc-eval-steps`
  names others.

Both run in this process, one after the other. For each, one line `RUN {json}`: PSNR and
SSIM at each eval step, the steady it/s (`eval_raytraced.steady_rate` over the
`TrainingProgress` marks, each clock reading after a `torch.cuda.synchronize()`), the wall
seconds, the peak `torch.cuda.max_memory_allocated`, the alive count at the end and the
plan redos. The ADC run's alive count is the row count of the `splat_final.ply` that the
CLI writes at the end (the alive rows). The first line names the card and its power limit
(nvidia-smi).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import tempfile
from pathlib import Path

import torch

SIZE, N_CAMS, ITERATIONS, MAX_CAP = 200, 28, 7000, 100_000  # RESULTS.md's command


class _Redos(logging.Handler):
    """Counts the Trainer's plan changes and redos from its log."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.changes, self.redos = 0, 0

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("raster plan"):
            self.changes += 1
            self.redos += "[REDO]" in msg


def run_mcmc(out: Path) -> dict:
    from tpu_splat_torch.tools import eval_raytraced

    s = eval_raytraced.main([
        "--size", str(SIZE), "--n-cams", str(N_CAMS), "--iterations", str(ITERATIONS),
        "--max-cap", str(MAX_CAP), "--out", str(out)])
    return dict(run="mcmc", evals=[dict(step=r["step"], psnr=r["psnr"], ssim=r["ssim"])
                                   for r in s["results"]],
                steady_iters_per_s=s["steady_iters_per_s"], wall_s=s["elapsed_s"],
                peak_mem_bytes=s["peak_mem_bytes"], n_alive=s["n_alive"],
                n_redo=s["n_redo"], plan_history=s["plan_history"])


def run_adc(out: Path, eval_steps: list[int] | None) -> dict:
    from tpu_splat_torch import cli
    from tpu_splat_torch.io.ply import read_ply_vertex_table
    from tpu_splat_torch.tools.eval_raytraced import now, steady_rate, write_capture
    from tpu_splat_torch.utils import events as ev

    cuda = torch.device("cuda")
    cap = write_capture(out, N_CAMS, SIZE)
    steps = eval_steps or sorted({ITERATIONS // 4, ITERATIONS // 2, ITERATIONS})
    config = out / "adc_eval_steps.json"
    config.write_text(json.dumps({"eval_steps": steps}))
    marks, evals = [], []
    handles = [
        ev.when(ev.TrainingProgress, lambda e: marks.append((now(cuda), e.iteration))),
        ev.when(ev.EvaluationCompleted,
                lambda e: evals.append(dict(step=e.iteration, psnr=round(float(e.psnr), 3),
                                            ssim=round(float(e.ssim), 4)))),
    ]
    counter = _Redos()
    logging.getLogger("tpu_splat_torch.training.trainer").addHandler(counter)
    torch.cuda.reset_peak_memory_stats()
    t0 = now(cuda)
    try:
        rc = cli.main(["-d", str(cap), "-o", str(out / "adc"), "--strategy", "default",
                       "--eval", "--test-every", "8", "-i", str(ITERATIONS),
                       "--max-cap", str(MAX_CAP), "--headless", "--config", str(config)])
    finally:
        for h in handles:
            h()
        logging.getLogger("tpu_splat_torch.training.trainer").removeHandler(counter)
    wall = now(cuda) - t0
    if rc != 0:
        raise RuntimeError(f"the CLI returned {rc}")
    final = read_ply_vertex_table(out / "adc" / "splat_final.ply")
    return dict(run="adc", evals=evals, steady_iters_per_s=steady_rate(marks), wall_s=wall,
                peak_mem_bytes=torch.cuda.max_memory_allocated(),
                n_alive=len(next(iter(final.values()))), n_redo=counter.redos,
                plan_changes=counter.changes)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path,
                    default=Path(tempfile.gettempdir()) / "record_quality")
    ap.add_argument("--adc-eval-steps", type=int, nargs="*", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("record_quality.py needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=30, check=True).stdout.strip()
    print("card:", smi, flush=True)
    os.makedirs(a.out, exist_ok=True)
    print("RUN", json.dumps(dict(run_mcmc(a.out), card=smi)), flush=True)
    print("RUN", json.dumps(dict(run_adc(a.out, a.adc_eval_steps), card=smi)), flush=True)


if __name__ == "__main__":
    main()
