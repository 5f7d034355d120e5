#!/usr/bin/env python3
"""splatbench: one run of one cell of the benchmark of `tpu_splat_torch` on one CUDA card.

    python3 splatbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. A cell is an entry of `BENCHMARK.json`'s `workloads`;
its files are found by name: `splatbench/workloads/<cell>.json` (its configuration,
traffic, precision and correctness limits), `splatbench/configs/<config>.json`,
`splatbench/traffic/<traffic>.json` (whose `loop` names the module that runs it,
`splatbench/sb_<loop>.py`), and one reader `splatbench/metrics/<metric>.py` for each
metric.

Prints the run's progress and then the card (nvidia-smi name, power limit, clocks) on
standard error, then each compared number beside its limit as the last lines there, and
one JSON object as the last line of standard output: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its per-layer ones),
`device`, with `--trace 1` `breakdown`, and last `checks`. Exits non-zero, printing no
result, without a CUDA card, and when the process holds a module of JAX or of the JAX
package once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_splat")


def log(msg: str) -> None:
    print(f"splatbench: {msg}", file=sys.stderr, flush=True)


def read_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_cell(bench: dict, name: str, here: Path = HERE, listed: bool = True) -> dict:
    """The cell `name` of `bench` with its workload, configuration and traffic files
    (with `listed` False, also a cell that only its workload file names, on one chip)."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None and not listed:
        entry = dict(read_json(here / "workloads" / f"{name}.json"), chips=1)
    if entry is None:
        raise SystemExit(f"splatbench: no workload {name!r} in BENCHMARK.json")
    cell = dict(read_json(here / "workloads" / f"{name}.json"), name=name, chips=entry["chips"])
    if (cell["config"], cell["traffic"]) != (entry["config"], entry["traffic"]):
        raise SystemExit(f"splatbench: {name}: workload file and BENCHMARK.json disagree")
    cell["config"] = read_json(here / "configs" / f"{entry['config']}.json")
    cell["traffic"] = read_json(here / "traffic" / f"{entry['traffic']}.json")
    return cell


def load_metric(name: str, here: Path | None = None):
    """The reader module `metrics/<name>.py` (of `here`, the harness's folder)."""
    path = (here or HERE) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("sb_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of `cell` reports: its end-to-end ones, or its per-layer ones."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    e2e = {m["name"]: m for m in bench["end_to_end"]}

    def applies(m):
        if "workloads" in m:
            return cell in m["workloads"]
        if not trace:
            return True
        moves = e2e[m["moves"]]
        return "workloads" not in moves or cell in moves["workloads"]

    return [m for m in entries if applies(m)]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or the JAX
    package's (compared whole: `tpu_splat_torch` is not `tpu_splat`)."""
    return sorted({k for k in list(sys.modules) if k.split(".")[0] in FORBIDDEN})


def card_lines() -> list[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,clocks.mem",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines() or [out.stderr.strip()]
    except (OSError, subprocess.SubprocessError) as e:
        return [f"nvidia-smi failed: {e}"]


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, dev, t_start: float,
             **kw) -> dict:
    """One run of the cell through the loop module its traffic names, `sb_<loop>.py`,
    whose `run` returns the run's record: `attempted`, `failed` (where some can fail),
    `memory_peak_bytes`, `checks` and what the cell's metric readers read."""
    loop = cell["traffic"]["loop"]
    try:
        mod = importlib.import_module(f"sb_{loop}")
    except ModuleNotFoundError as e:
        raise SystemExit(f"splatbench: no loop {loop!r} (sb_{loop}.py)") from e
    return mod.run(cell, seed, seconds, trace, dev, t_start, log=log, **kw)


def result_line(bench: dict, cell: dict, rec: dict, trace: bool, device: dict) -> dict:
    """The contract's result object, `checks` last."""
    from sb_trace import breakdown

    metrics = {}
    for m in cell_metrics(bench, cell["name"], trace):
        value = load_metric(m["name"]).read(rec, cell)
        if value is not None:
            metrics[m["name"]] = dict(value=float(value), unit=m["unit"])
    checks = {k: dict(value=float(rec["checks"][k]), limit=float(lim))
              for k, lim in cell["limits"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    attempted = rec["attempted"]
    failed = rec.get("failed", 0)
    out = dict(correct=bool(correct and attempted > 0 and failed == 0), attempted=attempted,
               failed=failed, metrics=metrics, device=device)
    if trace and rec.get("trace"):
        device.update(busy_s=rec["trace"]["busy_s"], window_s=rec["trace"]["window_s"])
        out["breakdown"] = breakdown(rec["trace"])
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one splatbench cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = HERE.parent
    bench = read_json(root / "BENCHMARK.json")
    cell = load_cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"{args.workload} needs {cell['chips']} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(1, str(root))  # the program, tpu_splat_torch
    dev = torch.device("cuda")
    rec = run_cell(cell, args.seed, args.seconds, bool(args.trace), dev, T_START)
    for line in card_lines():  # after the run: nvidia-smi's seconds are no set-up
        log(f"card: {line}")
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(dev), count=1,
                  memory_peak_bytes=int(rec["memory_peak_bytes"]))
    log(f"peak max_memory_allocated: {rec['memory_peak_bytes']} bytes")
    summary = {k: v for k, v in rec.items()
               if k not in ("trace", "latencies_s", "checks", "work")}
    log(f"run: {json.dumps(summary)}")
    log(f"checks: {json.dumps(rec['checks'])}")
    if rec.get("work"):
        log(f"work: {json.dumps(rec['work'])}")
    out = result_line(bench, cell, rec, bool(args.trace), device)
    bad = forbidden_modules()
    if bad:
        log(f"the process holds modules of JAX or the JAX package: {', '.join(bad)}")
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
