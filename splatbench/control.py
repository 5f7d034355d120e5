#!/usr/bin/env python3
"""The readings that a cell's correctness limits are set from, on one CUDA card.

    python3 splatbench/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]
        [--controls <name> ...]

For each seed, in one process: one run of the cell as run.py makes it (with a window of
`--seconds`), its compared numbers (the lower readings), and the same numbers of each
control put in the program's place (the upper readings): for a train cell "lowered"
(the reference one precision below the stated one), "half" (the planted fault of a loss
over half of the image) and "norelocate" (the planted fault of an MCMC refinement
skipped), for a render cell the reference at the feature precisions named. One JSON line
a seed. The benchmark's own runs never run this.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run as sbrun  # noqa: E402


def readings(cell: dict, seeds, seconds: float, dev, controls=None) -> list[dict]:
    """One dict a seed: its program readings, each control's, and its run's metrics."""
    bench = sbrun.read_json(sbrun.HERE.parent / "BENCHMARK.json")
    ctl = controls or [cell["control"]] + (["half", "norelocate"]
                                           if cell["traffic"]["loop"] == "train" else [])
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        rec = sbrun.run_cell(cell, seed, seconds, False, dev, t0, controls=ctl)
        res = sbrun.result_line(bench, cell, rec, False, {})
        out.append(dict(seed=seed, program={k: rec["checks"][k] for k in cell["limits"]},
                        relocated=rec["checks"].get("relocated"),
                        controls={c: {k: v[k] for k in cell["limits"]}
                                  for c, v in rec["controls"].items()},
                        correct=res["correct"],
                        metrics={k: v["value"] for k, v in res["metrics"].items()}))
        print(json.dumps(out[-1]), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="lower and upper readings of a cell's checks")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", nargs="*")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(1, str(sbrun.HERE.parent))
    for line in sbrun.card_lines():
        print(f"card: {line}", file=sys.stderr, flush=True)
    bench = sbrun.read_json(sbrun.HERE.parent / "BENCHMARK.json")
    cell = sbrun.load_cell(bench, args.workload, listed=False)
    readings(cell, args.seeds, args.seconds, torch.device("cuda"), args.controls)
    return 0


if __name__ == "__main__":
    sys.exit(main())
