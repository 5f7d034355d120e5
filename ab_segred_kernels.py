#!/usr/bin/env python3
"""K4 and K7 of this checkout, reading the blend backward's tile-sorted rows through the
emission->column index, against the gather followed by K4 and K7 built from other source
directories, in turns, on one CUDA card.

    python3 ab_segred_kernels.py BASE_CSRC [BASE_CSRC ...] [--reps 20]

Each BASE_CSRC holds another version's `segsum.cu` and `segprefix.cu` with the C interface
they had before the index (rows in emission order; K7's scratch `agg` [2, F, nb] and
`first_len` [2, nb]), for example `tpu_splat_torch/csrc` of an earlier commit unpacked with
`git archive` into a directory that .gitignore lists. The script builds every version (one
nvcc a source, all at once), prints ptxas' registers and spills of each, and on two
inputs:

  pinhole: K3's rows at the train step of chip_smoke.py's training workload at its initial
           state (1,000,000 Gaussians, 1296x840, tile 32, chunk 256, bf16 layout, 10 rows;
           `gout` random, as chip_smoke.py draws it);
  gut:     K6's rows at chip_smoke.py's GUT train step (pinhole with radial k1 = 0.05,
           tile 32, chunk 128, rays 4 wide, 17 rows),

checks for each base that its gather + K4 gives the same bits as this checkout's K4 on
every run of at most 64 slots and agrees within K4's tolerance on the others, and that
its gather + K7 agrees with this K7 within K7's tolerance; then times base, new, new, base
(each the median of --reps CUDA-event repetitions after warm-up): gather + K4 against K4
at both inputs, gather + K7 against K7 at the GUT input, and the pinhole train step and
the GUT train step on both reduction lanes with each version's reduction: the median wall
time of 7 synchronised steps and the device time (the sum of the kernels' times under
torch.profiler, the mean of 3 steps). At each input it also times this checkout's K4 and
K7 at every number of rows a grid pass may read (`raster.PASS_ROWS`), each giving the same
bits. Prints the card, one JSON line of pass times an input and one of times a base.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

from ab_blend_kernels import build_bases

NAMES = ("segsum", "segprefix")
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the C interface before the emission->column index
BASE_ARGTYPES = {
    "segsum": (_P, _I, _L, _I, _P, _P, _I, _P, _L, _P),
    "segprefix": (_P, _I, _L, _I, _P, _P, _P, _P, _I, _P),
}


def kernel_registers(log: str) -> dict:
    """chip_smoke.ptxas_summary of a K4/K7 build log, keyed by kernel, rows a pass and
    whether it reads through the index (e.g. "segsum_kernel rows3 cols")."""
    import re

    from chip_smoke import ptxas_summary

    out = {}
    for key, entry in ptxas_summary(log).items():
        t = re.search(r"\d([a-z][a-z_]*_kernel)ILi(\d+)E(?:Lb(\d)E)?", key)
        out[f"{t.group(1)} rows{t.group(2)}{' cols' if t.group(3) == '1' else ''}"
            if t else key] = entry
    return out


def base_reduction(fns: dict):
    """`segmented_grad_reduce` as it was before the index: `emission_order`, then the
    base's K4 or K7 on the gathered rows. -> (reduce, segsum, prefix)"""
    import torch

    from tpu_splat_torch.ops.cuda.build import check
    from tpu_splat_torch.ops.cuda.raster import SEGRED_IMPLS, emission_order

    def segsum(rows, start, end):
        out = torch.empty((rows.shape[0], start.shape[0]), device=rows.device)
        check(fns["segsum"](rows.data_ptr(), rows.shape[0], rows.stride(0), rows.shape[1],
                            start.data_ptr(), end.data_ptr(), start.shape[0], out.data_ptr(),
                            out.stride(0), torch.cuda.current_stream().cuda_stream),
              "base segsum")
        return out

    def prefix(rows, rank):
        m = rows.shape[1]
        nb = -(-m // 1024)
        out = torch.empty_like(rows)
        agg = torch.empty((2, rows.shape[0], nb), device=rows.device)
        first_len = torch.empty((2, nb), dtype=torch.int32, device=rows.device)
        check(fns["segprefix"](rows.data_ptr(), rows.shape[0], rows.stride(0), m,
                               rank.data_ptr(), out.data_ptr(), agg.data_ptr(),
                               first_len.data_ptr(), nb, torch.cuda.current_stream().cuda_stream),
              "base segprefix")
        return out

    def reduce(gflat, inst, impl="segsum", kernels=True):
        if impl not in SEGRED_IMPLS or not kernels:
            raise ValueError((impl, kernels))
        rows = emission_order(gflat, inst.sorted_emis)
        if impl == "segsum":
            return segsum(rows, inst.emis_start, inst.emis_end)
        x = prefix(rows, inst.emis_rank)
        last = (inst.emis_end.long() - 1).clamp(0, max(x.shape[1] - 1, 0))
        return x.index_select(1, last) * (inst.emis_end > inst.emis_start)

    return reduce, segsum, prefix


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("base_csrc", type=Path, nargs="+")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("ab_segred_kernels: no CUDA device is available", file=sys.stderr)
        return 1
    from chip_smoke import (HEIGHT, N_GAUSS, TILE_T, WIDTH, build_workload, check_prefix,
                            check_segsum, check_segsum_bits, cuda_ms, gut_kernel_inputs,
                            require, train_blend_inputs, train_setup)
    from tpu_splat_torch.ops import rasterize as rasterize_mod
    from tpu_splat_torch.ops.cameras import CameraParams
    from tpu_splat_torch.ops.cuda import build, raster
    from tpu_splat_torch.ops.cuda.blend import blend_backward, blend_forward
    from tpu_splat_torch.ops.cuda.gut_kernels import gut_blend_backward, gut_blend_forward
    from tpu_splat_torch.ops.cuda.raster import emission_order, segred_prefix, segsum_emission
    from tpu_splat_torch.training.train_step import train_step

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}", flush=True)
    build.build_all()
    bases = build_bases(args.base_csrc, NAMES)
    for fns, _ in bases:
        for name in NAMES:
            fns[name].argtypes = BASE_ARGTYPES[name]
    print(json.dumps({"ptxas_new": {n: kernel_registers(build.build_log(n)) for n in NAMES}}),
          flush=True)
    results = [{"base": str(src), "ptxas_base": kernel_registers(log)}
               for src, (_, log) in zip(args.base_csrc, bases)]
    reductions = [base_reduction(fns) for fns, _ in bases]

    def wall_ms(fn, reps):  # median wall time of fn() between two synchronisations
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def device_ms(fn, reps):  # mean over reps of the summed kernel times under the profiler
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        busy = [e.time_range.elapsed_us() for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        require(busy, "the profiler recorded no device activity")
        return sum(busy) / 1e3 / reps

    def in_turns(result, key, base_fn, new_fn, timer=cuda_ms, reps=args.reps):
        for side, fn in (("base", base_fn), ("new", new_fn), ("new", new_fn),
                         ("base", base_fn)):
            result.setdefault(f"{key}_{side}_ms", []).append(timer(fn, reps))

    def with_reduction(reduce, fn):  # run fn with `reduce` as segmented_grad_reduce
        def run():
            saved = raster.segmented_grad_reduce
            raster.segmented_grad_reduce = rasterize_mod.segmented_grad_reduce = reduce
            try:
                return fn()
            finally:
                raster.segmented_grad_reduce = rasterize_mod.segmented_grad_reduce = saved
        return run

    @contextlib.contextmanager
    def rows_per_pass_fixed(g):  # K4 and K7 read g rows a pass
        saved = raster.rows_per_pass
        raster.rows_per_pass = lambda rows, cols: g
        try:
            yield
        finally:
            raster.rows_per_pass = saved

    params, focal = build_workload(N_GAUSS, WIDTH, HEIGHT)

    def gflat_pinhole():
        ts0, target, cam, bg0, plan, step_kw = train_setup(params, focal, dev)
        inst, (flat, seg, cnt), gout, kw = train_blend_inputs(ts0.splat, cam, plan, dev)
        out, chk = blend_forward(flat, seg, cnt, **kw)
        gflat = blend_backward(flat, seg, cnt, chk, out, gout, **kw)
        return inst, gflat, (ts0, target, cam, bg0, plan, step_kw)

    def gflat_gut():
        cam_params = CameraParams(radial=(0.05, 0.0, 0.0, 0.0, 0.0, 0.0))
        ts0, target, cam, bg0, plan, step_kw = train_setup(params, focal, dev, cam_params)
        inst, kargs, kw = gut_kernel_inputs(
            ts0.splat, cam, cam_params, width=WIDTH, height=HEIGHT, tile_size=TILE_T,
            max_instances=plan.max_instances, k_max=plan.k_max, sh_degree=0, dev=dev)
        out, chk = gut_blend_forward(*kargs, **kw)
        gout = torch.randn(out.shape, device=dev, generator=torch.Generator(
            device=dev).manual_seed(8)) / (3 * WIDTH * HEIGHT)
        gflat = gut_blend_backward(*kargs, chk, out, gout, **kw)
        return inst, gflat, (ts0, target, cam, bg0, plan, step_kw)

    for label, setup, lanes in (("pinhole", gflat_pinhole, ("segsum",)),
                                ("gut", gflat_gut, ("segsum", "prefix"))):
        inst, gflat, (ts0, target, cam, bg0, plan, step_kw) = setup()
        start, end, cols = inst.emis_start, inst.emis_end, inst.emis_col
        rows = emission_order(gflat, inst.sorted_emis)
        k4 = segsum_emission(gflat, start, end, cols)
        k7 = segred_prefix(gflat, inst.emis_rank, cols) if "prefix" in lanes else None
        for (reduce, b_segsum, b_prefix), result in zip(reductions, results):
            tag = f"{label} {result['base']}"
            k4_base = b_segsum(rows, start, end)
            check_segsum(k4, k4_base, rows, start, end, f"K4 {tag}")
            result[f"{label}_k4_short_runs_bit_equal"] = check_segsum_bits(
                k4, {"the base's gather + K4": k4_base}, start, end, f"K4 {tag}")
            in_turns(result, f"{label}_gather_k4", lambda: b_segsum(
                emission_order(gflat, inst.sorted_emis), start, end),
                lambda: segsum_emission(gflat, start, end, cols))
            in_turns(result, f"{label}_k4_alone", lambda: b_segsum(rows, start, end),
                     lambda: segsum_emission(rows, start, end))
            if k7 is not None:
                k7_base = b_prefix(rows, inst.emis_rank)
                result[f"{label}_k7_max_abs_diff"] = check_prefix(
                    k7, k7_base, rows, inst.emis_rank, f"K7 {tag}")
                in_turns(result, f"{label}_gather_k7", lambda: b_prefix(
                    emission_order(gflat, inst.sorted_emis), inst.emis_rank),
                    lambda: segred_prefix(gflat, inst.emis_rank, cols))
            result[f"{label}_gather_ms"] = cuda_ms(
                lambda: emission_order(gflat, inst.sorted_emis), args.reps)
            for lane in lanes:
                def step(lane=lane):
                    train_step(ts0, target, *cam, bg0, 0, plan=plan, segred_impl=lane,
                               **step_kw)
                key = f"{label}_step_{lane}"
                in_turns(result, f"{key}_wall", with_reduction(reduce, step), step,
                         timer=wall_ms, reps=7)
                in_turns(result, f"{key}_device", with_reduction(reduce, step), step,
                         timer=device_ms, reps=3)
        # this tree's K4 and K7 through the index at each number of rows a pass reads:
        # the same bits, and their times
        passes = {"default_rows_per_pass": raster.rows_per_pass(gflat, cols)}
        for g in [g for g in raster.PASS_ROWS if g <= gflat.shape[0]]:
            with rows_per_pass_fixed(g):
                require(torch.equal(segsum_emission(gflat, start, end, cols), k4),
                        f"K4 with {g} rows a pass differs")
                passes[f"k4_rows{g}_ms"] = cuda_ms(
                    lambda: segsum_emission(gflat, start, end, cols), args.reps)
                if k7 is not None:
                    require(torch.equal(segred_prefix(gflat, inst.emis_rank, cols), k7),
                            f"K7 with {g} rows a pass differs")
                    passes[f"k7_rows{g}_ms"] = cuda_ms(
                        lambda: segred_prefix(gflat, inst.emis_rank, cols), args.reps)
        print(json.dumps({f"{label}_passes": passes}), flush=True)
        result_slots = dict(slots=int(inst.total_instances), m=int(gflat.shape[1]),
                            rows=int(gflat.shape[0]))
        for result in results:
            result[f"{label}_shape"] = result_slots
        del inst, gflat, rows, k4, k7, ts0, target
        torch.cuda.empty_cache()
    for result in results:
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
