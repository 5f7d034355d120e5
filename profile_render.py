#!/usr/bin/env python3
"""Device-time breakdown of the port's render path, or train step, on one CUDA card.

    python3 profile_render.py [--train | --gut] [--frames 3] [--trace PATH]

Renders chip_smoke.py's scene (1,000,000 Gaussians, SH degree 3, 1296x840, seed 0)
through `render_view` under torch.profiler, after two warm-up frames, and prints:
the card (nvidia-smi name and power limit); the kernels ranked by device time per
frame; one JSON line with frame wall time, summed kernel time per frame and the
device's idle share of the profiled window. `--trace` also writes a Chrome trace.
With `--train` a "frame" is one MCMC `train_step` of chip_smoke.py's training workload
(tile 32, chunk 256, bf16 pack, the plan sized from a probe step). With `--gut` it is one
GUT `train_step` of chip_smoke.py's GUT workload (`StepConfig(gut=True)`, a pinhole with
radial distortion 0.05, tile 32, chunk 128), and the camera-only work of a step (the
20-iteration undistortion of every pixel's ray) and the UT projection are also timed alone.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np


def gut_stage_times(splat, cam, cam_params, plan) -> dict:
    """CUDA-event times (ms, medians of 5) of the two stages of a GUT step that no kernel
    of the port covers: the UT projection of every Gaussian's seven sigma points, and the
    per-pixel world rays (20 undistortion iterations a pixel), which depend on the camera
    alone."""
    import torch

    from chip_smoke import HEIGHT, WIDTH, cuda_ms
    from tpu_splat_torch.ops.gut import pixel_world_rays, ut_project

    dev = splat.means.device
    w2c, pos = torch.as_tensor(cam[0], device=dev), torch.zeros(3, device=dev)
    ts = plan.tile_size
    grid = dict(grid_w=-(-WIDTH // ts), grid_h=-(-HEIGHT // ts), tile_size=ts, width=WIDTH,
                height=HEIGHT)
    return dict(
        ut_project_ms=cuda_ms(lambda: ut_project(
            splat.means, splat.scaling_raw, splat.rotation_raw, splat.opacity_raw,
            splat.alive, w2c, *cam[2:], cam_params, WIDTH, HEIGHT, ts, None), 5),
        pixel_rays_ms=cuda_ms(lambda: pixel_world_rays(
            w2c, pos, *cam[2:], cam_params, None, None, **grid), 5),
    )


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=3)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--train", action="store_true", help="profile train steps, not frames")
    mode.add_argument("--gut", action="store_true", help="profile GUT train steps")
    ap.add_argument("--trace", help="write a Chrome trace of the profiled frames here")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_render: no CUDA device is available", file=sys.stderr)
        return 1
    from chip_smoke import HEIGHT, N_GAUSS, WIDTH, build_workload, train_setup
    from tpu_splat_torch.convert import splat_from_numpy
    from tpu_splat_torch.ops.cuda.build import build_all
    from tpu_splat_torch.render import render_view
    from tpu_splat_torch.training.train_step import train_step

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {smi}", flush=True)
    build_all()
    params, focal = build_workload(N_GAUSS, WIDTH, HEIGHT)
    state = splat_from_numpy(params, np.ones(N_GAUSS, bool), 3, dev, scene_scale=3.0)
    w2c = np.eye(4, dtype=np.float32)
    fov = math.degrees(2 * math.atan(0.5 * WIDTH / focal))

    extra = {}
    if args.train or args.gut:
        del state
        cam_params = None
        if args.gut:
            from tpu_splat_torch.ops.cameras import CameraParams

            cam_params = CameraParams(radial=(0.05, 0.0, 0.0, 0.0, 0.0, 0.0))
        ts, target, cam, bg, plan, step_kw = train_setup(params, focal, dev, cam_params)
        print(f"plan: {plan}", flush=True)
        if args.gut:
            extra = gut_stage_times(ts.splat, cam, cam_params, plan)

        def frame():
            nonlocal ts
            ts, stats = train_step(ts, target, *cam, bg, 0, plan=plan, **step_kw)
            return stats
    else:
        def frame():
            return render_view(state, w2c, WIDTH, HEIGHT, fov, device=dev)

    for _ in range(2):
        frame()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.frames):
            frame()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if args.trace:
        prof.export_chrome_trace(args.trace)

    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print("profile_render: the profiler recorded no device activity", file=sys.stderr)
        return 2
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us() / 1e3)
    ranked = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))
    print(f"{'ms/frame':>9} {'share':>6} {'calls/frame':>11}  kernel")
    for name, times in ranked[:30]:
        print(f"{sum(times) / args.frames:9.3f} {sum(times) / busy_ms:6.1%} "
              f"{len(times) / args.frames:11.1f}  {name[:110]}")
    print(json.dumps(dict(
        mode="gut" if args.gut else "train" if args.train else "render", frames=args.frames,
        frame_wall_ms=wall_ms / args.frames,
        kernel_ms_per_frame=busy_ms / args.frames,
        kernels_per_frame=len(kernels) / args.frames,
        device_idle_share=max(0.0, 1.0 - busy_ms / wall_ms), **extra,
    )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
