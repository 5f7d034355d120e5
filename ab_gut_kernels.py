#!/usr/bin/env python3
"""K5 and K6 of this checkout against K5 and K6 built from other source directories, in
turns, on one CUDA card.

    python3 ab_gut_kernels.py BASE_CSRC [BASE_CSRC ...] [--reps 10]

Each BASE_CSRC holds another version's `gut_fwd.cu`, `gut_bwd.cu` and the headers they
include, with the same C interface, for example `tpu_splat_torch/csrc` of an earlier commit
unpacked with `git archive` into a directory that .gitignore lists. The script builds every
version (one nvcc a source, all at once), prints ptxas' registers and spills of each, and
on two inputs:

  step:    the GUT train step's blend of chip_smoke.py's GUT workload at its initial state
           (1,000,000 Gaussians, 1296x840, pinhole with radial k1 = 0.05, tile 32, chunk
           128, rays 4 wide, SH degree 0; `gout` random, as chip_smoke.py draws it);
  fisheye: chip_smoke.py's fisheye frame of the same scene (648x420, tile 16, SH degree 3),

checks for each base that its K5 gives the same bits (out and chk) as this checkout's and
its K6 agrees within 1e-4 of the largest gradient, then times base, new, new, base (each
the median of --reps CUDA-event repetitions after warm-up), and the same for the GUT frame
(`rasterize_gut` without gradient) and the GUT train step (`train_step`) with each
version's kernels: the median wall time of 7 synchronised runs, and the device time (the
sum of the kernels' times under torch.profiler, the mean of 3 runs). Prints the card, the pair counts of
`chip_smoke.gut_blend_pairs` (walked, kept by the cull, used, stops) and one JSON line of
times a base.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

from ab_blend_kernels import build_bases

NAMES = ("gut_fwd", "gut_bwd")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("base_csrc", type=Path, nargs="+")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("ab_gut_kernels: no CUDA device is available", file=sys.stderr)
        return 1
    from chip_smoke import (HEIGHT, N_GAUSS, TILE_T, WIDTH, build_workload, cuda_ms,
                            gut_blend_pairs, gut_kernel_inputs, ptxas_summary, require,
                            train_setup)
    from tpu_splat_torch.ops.cameras import CameraParams
    from tpu_splat_torch.ops.cuda import build, gut_kernels
    from tpu_splat_torch.ops.gut import rasterize_gut
    from tpu_splat_torch.training.train_step import train_step

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}", flush=True)
    build.build_all()
    new = {name: build.kernel(name) for name in NAMES}
    bases = build_bases(args.base_csrc, NAMES)
    print(json.dumps({"ptxas_new": {n: ptxas_summary(build.build_log(n)) for n in NAMES}}),
          flush=True)
    results = [{"base": str(src), "ptxas_base": ptxas_summary(log)}
               for src, (_, log) in zip(args.base_csrc, bases)]

    def using(fns, fn, *a, **kw):  # run a wrapper with the given kernel libraries
        saved = gut_kernels.kernel
        gut_kernels.kernel = fns.__getitem__
        try:
            return fn(*a, **kw)
        finally:
            gut_kernels.kernel = saved

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

    def in_turns(result, key, fns, fn, *a, timer=cuda_ms, reps=args.reps, **kw):
        for side in ("base", "new", "new", "base"):  # base, new, new, base
            lib = new if side == "new" else fns
            result.setdefault(f"{key}_{side}_ms", []).append(
                timer(lambda: using(lib, fn, *a, **kw), reps))

    params, focal = build_workload(N_GAUSS, WIDTH, HEIGHT)
    cam_params = CameraParams(radial=(0.05, 0.0, 0.0, 0.0, 0.0, 0.0))
    ts0, target, cam, bg0, plan, step_kw = train_setup(params, focal, dev, cam_params)
    half_cam = (cam[0], cam[1], focal / 2, focal / 2, WIDTH / 4.0, HEIGHT / 4.0)
    fish_params = CameraParams(model="fisheye", radial=(0.05, -0.01, 0.0, 0.0, 0.0, 0.0))
    inputs = {
        "step": gut_kernel_inputs(ts0.splat, cam, cam_params, width=WIDTH, height=HEIGHT,
                                  tile_size=TILE_T, max_instances=plan.max_instances,
                                  k_max=plan.k_max, sh_degree=0, dev=dev),
        "fisheye": gut_kernel_inputs(ts0.splat, half_cam, fish_params, width=WIDTH // 2,
                                     height=HEIGHT // 2, tile_size=16,
                                     max_instances=1 << 22, k_max=1 << 13, sh_degree=3,
                                     dev=dev),
    }
    for label, (_, kargs, kw) in inputs.items():
        f_new = using(new, gut_kernels.gut_blend_forward, *kargs, **kw)
        print(json.dumps({f"{label}_pairs": gut_blend_pairs(*kargs, f_new[1], **kw)}),
              flush=True)
        gout = torch.randn(f_new[0].shape, device=dev, generator=torch.Generator(
            device=dev).manual_seed(8)) / (3 * WIDTH * HEIGHT)
        bwd = (*kargs, f_new[1], f_new[0], gout)
        g_new = using(new, gut_kernels.gut_blend_backward, *bwd, **kw)
        for (fns, _), result in zip(bases, results):
            f_base = using(fns, gut_kernels.gut_blend_forward, *kargs, **kw)
            require(torch.equal(f_new[0], f_base[0]) and torch.equal(f_new[1], f_base[1]),
                    f"{label}: K5 of {result['base']} differs")
            g_base = using(fns, gut_kernels.gut_blend_backward, *bwd, **kw)
            rel = float((g_new - g_base).abs().max() / g_base.abs().max())
            require(math.isfinite(rel) and rel <= 1e-4,
                    f"{label}: K6 of {result['base']} differs by {rel}")
            result[f"{label}_k5_bit_equal"] = True
            result[f"{label}_k6_rel_diff"] = rel
            in_turns(result, f"k5_{label}", fns, gut_kernels.gut_blend_forward, *kargs, **kw)
            in_turns(result, f"k6_{label}", fns, gut_kernels.gut_blend_backward, *bwd, **kw)
        del f_new, f_base, g_new, g_base, bwd, gout
    del inputs
    torch.cuda.empty_cache()

    sp = ts0.splat
    scene = (sp.means, sp.scaling_raw, sp.rotation_raw, sp.opacity_raw, sp.sh0, sp.shN,
             sp.alive)
    ras_kw = dict(width=WIDTH, height=HEIGHT, max_instances=plan.max_instances,
                  k_max=plan.k_max, tile_size=TILE_T, device=dev, cam_params=cam_params)

    def frame():
        with torch.no_grad():
            rasterize_gut(*scene, *cam, 0, bg0, **ras_kw)

    def step():
        train_step(ts0, target, *cam, bg0, 0, plan=plan, **step_kw)

    for (fns, _), result in zip(bases, results):
        for key, fn in (("gut_frame", frame), ("gut_step", step)):
            in_turns(result, f"{key}_wall", fns, fn, timer=wall_ms, reps=7)
            in_turns(result, f"{key}_device", fns, fn, timer=device_ms, reps=3)
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
