#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (`tpu_splat_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA card and the CUDA toolkit:

1. prints the card (torch name; nvidia-smi name and power limit);
2. builds every kernel from `tpu_splat_torch/csrc` (one nvcc per source, in parallel)
   and prints ptxas' register counts;
3. holds the kernels against their plain PyTorch versions on random inputs: K2 forward
   (f32 and bf16 layouts) and K3 backward on random unaligned segments at (tile 16,
   chunk 128) and (tile 32, chunk 256), and on segments whose splats sit on the borders of
   the kernels' 8x4 warp sub-rectangles with opacities near 1/255; K2's stop decisions
   (the zero checkpoints and the pair counts of `blend_pairs`) equal to the plain
   version's, K3 bit-equal on two launches; K4 and K7 (10 and 17 rows) on random runs with
   empty runs and one run of 300,000 slots, reading rows in a random tile-sorted order
   through the emission->column index and in emission order: K4 bit-equal on every run of
   at most 64 slots to the plain version and to the gather followed by K4, both kernels
   bit-equal on two launches, K7 also on an axis shorter than one block and on one that
   ends in a partial block; K5 and K6 on random
   unaligned segments with rays 4 and 8 wide, and on segments whose splats graze the
   kernels' warp ray cones (opacities near 1/255 among them) through a distorted pinhole,
   a fisheye, an ortho and a rolling-shutter camera (`gut_border_segments`): K5's stop
   decisions and pair counts (walked, kept by the cull, used, stops) equal to the plain
   version's, K6 bit-equal on two launches;
4. drives the render path: `render_view` of a 1,000,000-Gaussian SH-degree-3 scene at
   1296x840 (the distributions of bench.py::build_workload, seed 0) with every launch
   count set to 0 just before and read just after; checks the aux counters, a finite
   image, that each kernel launched, and the image against the same frame through the
   plain versions on the card;
5. holds K1 (expansion, exact) and K2 (and its stop decisions) against their plain
   versions at the frame's own shapes, counts the (pixel, instance) pairs (walked without
   a cull, kept by the cull, used, stopping), and times kernels, plain versions and the
   library yardstick with CUDA events;
6. drives the CLI (`--view` of a 100k-Gaussian PLY written by the port, 3 frames);
6a. the serving side: `sog`, `save_sog` of the scene (palette 65,536, 10 iterations, the
   k-means on the card) with its split (Morton, k-means++ init, Lloyd, the three 1-d
   k-means, WebP encode, zip) and each plane's size, `load_sog` back (planes bit-equal,
   parameters within their quantization steps or on their codebooks), and `kmeans` /
   `kmeans_1d` on the card against the CPU at n = 20,000; `view-sog`, the CLI's `--view`
   of the .sog with `--crop-min/--crop-max` (3 frames), a point-cloud and an SH-degree-4
   frame through the kernels against the plain versions, 5 train steps at SH degree 4;
   `viewer`, `viewer.serve` of the scene's PLY on a free loopback port: `/`, `/info`,
   `/scene` and 12 `/frame`s at 960x540 (RGB, RGB_ED, PC, overlay, a compare split, the
   crop box on through `/scene_ctl`), each PNG equal to the quantized `render_view` image,
   with the latency's median and p90 split into render and encode; each with the launch
   counts set to 0 just before and read just after;
7. drives the training path: `init_train_state`, a probe `train_step`, the plan sized from
   the probe (tile 32, chunk 256, bf16 pack), 30 MCMC `train_step`s towards the port's own
   render of a perturbed copy of the scene and one `refine_step`, with every launch count
   set to 0 just before and read just after; checks one launch of K1-K4 a step, no call
   of `emission_order` (K4 reads K3's rows through `emis_col`), no overflow, finite state
   and a falling loss;
8. holds `rasterize`'s six parameter gradients through the kernels against the plain
   versions at the train step's shapes, and K2-bf16 (with its stop decisions and pair
   counts), K3 (and its repeatability) and K4 (through `emis_col`; bit-equal on runs of at
   most 64 slots to the plain version and to the gather followed by K4, and on two
   launches) against their plain versions on the step's own inputs, and times them, the
   path K4 replaces (gather + K4) and the library yardstick; times the step (wall) and its
   stages (CUDA events);
9. drives the GUT camera path (`gut_phases`): `rasterize_gut` of the same scene through a
   distorted pinhole at 1296x840, tile 32, chunk 128, and through a fisheye and a
   rolling-shutter camera at half the size, kernels against plain versions, and K5/K6
   with their stop decisions and pair counts at the frame's and the fisheye frame's own
   inputs; 20 GUT
   `train_step`s (`StepConfig(gut=True)`), the last six through the K7 lane, with every
   launch count set to 0 just before and read just after: K1, K5, K6 once a step and K4 or
   K7 once a step, the UT projection and world-ray kernels once a step, and no call of
   `emission_order`; the six parameter gradients of
   `rasterize_gut` under both reduction lanes; K5 (with its stop decisions and pair
   counts), K6 (and its repeatability), K7 and 17-row K4 (through `emis_col`, as at the
   pinhole step) against their plain versions on the step's own inputs, their times, the
   GUT frame's time and the GUT step's stage split; the UT projection and world-ray
   kernels (`csrc/gut_project.cu`) against their plain chains on the scene in 2^20 slots
   at 1296x840 (`gut_projection_phase`: an OPENCV camera with every coefficient
   non-zero, bound to a device tensor and static, tiles 16 and 32, a window of tile rows,
   a fisheye with its max angle as a float and on the card, an ortho camera), and their
   times at the GUT cell's camera and tile;
10. drives the product path (`trainer_phases`): writes a COLMAP capture with the port's own
   code (12 PNG views of the scene at 1296x840 from perturbed poses, 150k of its means as
   SfM points, binary model files; and the same capture declared OPENCV with k1 = 0.05),
   trains it through `Trainer` (96 iterations, capacity 2^20, SH degree 3 reached, refines,
   evals on 2 val views, started from a plan of one slot per SfM point so that the
   overflow->redo protocol runs) and through `Trainer` with `--gut` on the OPENCV
   declaration (32 iterations), with every launch count set to 0 just before each
   `train()` and read just after: K1-K4 once a step (K1, K2 also once an eval render), K1,
   K5, K6, K4 and the two GUT projection kernels once a GUT step; a replan and a redo, falling losses, a rising eval PSNR,
   `splat_final.ply` with n == n_alive, `metrics.csv`; then `python -m tpu_splat_torch -d
   CAPTURE -o OUT --headless -i 16` in a subprocess; then, on the same capture:
   `trainer-adc`, `Trainer` on the shipped ADC preset (`parameter/default_optimization_
   params.json`: tile 16, chunk 128, bf16 pack) for 96 iterations with refines every 16
   and an opacity reset at 48, evals scoring LPIPS from random VGG weights (each score held
   against the same module on the CPU); each refine's n_alive = the previous + n_dup +
   n_split - n_pruned; `dens_grad2d` of a step through K3/K4 against the plain versions,
   and the refine on the card against the refine on the CPU on the same dens_* and eps;
   `trainer-resume`, two MCMC runs of 32 iterations with a checkpoint at 16 and a third
   resumed from it (the loaded state bit-equal to the saved one, the resumed run within
   the two runs' spread); `trainer-components`, a run with the bilateral grid and the
   pose MLP and one with ADMM sparsity (init, one dual update, the prune of
   int(0.6 n_alive)); every run with the launch counts set to 0 just before and read just
   after: K1-K4 once a step, K1 and K2 once more an eval render; `trainer-live`, MCMC for
   48 iterations with the timelapse of two views every 16, `save_sog` and the live viewer
   attached while a client thread requests `/frame` and `/status` every 0.2 s and pauses
   and resumes training: the timelapse PNGs, `splat_final.sog` loaded and rendered,
   /status iterations rising, K1 and K2 once a step and once more each eval, timelapse and
   viewer render;
   `quality-floor`, the JAX package's CI quality gate (`tests/test_io_and_trainer.py::
   test_trainer_quality_floor_raytraced`) through `Trainer`: the raytraced capture of
   `tpu_splat_torch/tools/synth_capture.py` (8 views at 48x48), MCMC for 600 iterations,
   evals at 150 and 600; the final PSNR above 11.5 dB and 3 dB above the first, K1-K4
   once a step and K1, K2 once more an eval render; its line names the card and its
   power limit;
10a. the batched, multi-device path: `k2k3-window`, K2 (both layouts) and K3 with a
   tile-row offset (tile_y0 0, 3, 17) against their plain versions at (tile 16, chunk 128)
   and (tile 32, chunk 256), and the render frame as 2 and as 4 windows of tile rows
   (`parallel/raster_mc.py::_window_proj` -> `build_sorted_instances(tile_y0)` -> K2)
   stacked against the whole frame at atol 1e-5; `batched-step`, the batched step in a
   world of one process (`parallel/step.py`, a 1x1 mesh) on the scene in 2^20 slots, 4
   distinct cameras a step, tile 32, chunk 256, bf16 pack, a gather budget below the
   capacity (so `compact_visible` runs): its gradients against the mean of the 4
   single-camera steps' (within 1e-5 of each group's largest), K1-K4 4 times a step, the
   step's ms and cameras/s; `batched-gut-step` (after the GUT phases), the same step
   through the GUT blend (radial k1 = 0.05 handed over per camera, K5/K6 on the windows'
   world rays): its gradients against the plain versions' (1e-3) and the single-camera
   GUT steps' mean (1e-5), K1/K4/K5/K6 and the GUT projection kernels 4 times a step; `mesh-2rank`, `parallel/dryrun.py` at the scene's size over
   two gloo processes sharing the card as meshes (1, 2) and (2, 1) against a world of one
   (losses, the refine, the gathered parameters); `trainer-batched` (inside the trainer
   phases), the CLI with `--batch-size 4` on the capture: it/s, images/s, PSNR, launches
   (4 a step, one more an eval render);
11. prints a `kernels` JSON line (all seven kernels and the two GUT projection kernels; K2
   in both layouts, K4 at both row counts; K5 and K6 with their pair counts and ptxas'
   registers and spills; each kernel's
   launches in the trainer phases' runs and in the serving phases'), a `frame`
   JSON line (frame ms and per-stage split), a `train` JSON line (step
   ms, split, plan, counters, losses), a `gut` JSON line (the same for the GUT frame and
   step), a `trainer` JSON line (the capture, it/s with data loading and its split into
   data wait, dispatch, pending checks, hooks, eval and save, the plan history, redos,
   launches, losses, eval PSNR/SSIM of the pinhole run; the same for the GUT run; the CLI
   run's time; the ADC run's refines, LPIPS, checks and times, the resume spread, the
   component runs, the live run), a `serving` JSON line (the sog, view-sog and viewer
   phases), a `batched` JSON line (the four phases of 10a) and, last, {"ok": true,
   "device": {...}}.

Any failure raises and exits non-zero; without a CUDA device, or outside the repository,
it exits non-zero before printing any result. Times are medians over CUDA-event-timed
repetitions after warm-up, on the card named in the output.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import statistics
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

N_GAUSS, WIDTH, HEIGHT = 1_000_000, 1296, 840
CLI_GAUSS = 100_000
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and non-tensor-core FP32 FLOP/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# K2: ~20 FP32 operations and one exp per (pixel, instance) pair the data needs: the pairs
# a pixel uses and the one that stops it (`blend_pairs` "used" + "stops"); the pairs that
# fail the alpha test are work the cull avoids, not work the function needs
K2_OPS_PER_PAIR = 21
# K3, counted from blend_backward_plain: a needed pair costs the forward's 21; a pair that
# is used costs 47 more: g.c 7, w 2, running sum and suffix 2, dL/da 3 (one a divide),
# dL/dsigma 2, the ten products with their pixel sums 5+5+4+3+4+2+2+2+2+2
K3_OPS_PER_USED_PAIR = 47
# K5, counted from gut_blend_forward_plain: v = M d 15, |v|^2 5, max/sqrt/divide 3, n 3,
# the cross product 9, power 6, exp/alpha/min/test 4, compositing 4; for each pair the data
# needs (used + stops of `gut_blend_pairs`), as K2's
K5_OPS_PER_PAIR = 49
# K6, counted from gut_blend_backward_plain: a needed pair costs the forward's 49;
# a pair that is used costs 83 more: w 2, g.col 7, running sum and suffix 3, dL/da 3 (one a
# divide), dL/dpow and d/dop 4, dL/dc 3, the two cross products 18, n.dn 5, dL/dv 9, the
# nine outer products with their pixel sums 18, gro sums 3, colour and depth sums 8
K6_OPS_PER_USED_PAIR = 83
# The GUT projection kernels (csrc/gut_project.cu) through the pinhole model, FP32
# operations counted from the source (a fused multiply-add counts 2). ut_project, a slot:
# the rotation 40, the sigma points 33, seven points of w2c 21 and distorted projection 53
# each, the UT mean 28 and covariance 84, the projection tail 60; it reads 45 bytes a slot
# (means, scaling, rotation, opacity, alive) and writes 69 (Projected, the compensation).
# The world rays, a pixel: 20 undistortion steps of 41 (the distortion 36), the pixel
# centre 8, the norm 9, w2c 18; it writes 16 bytes a pixel.
GUT_PROJECT_OPS_PER_SLOT = 40 + 33 + 7 * (21 + 53) + 28 + 84 + 60
GUT_PROJECT_BYTES_PER_SLOT = 45 + 69
GUT_RAYS_OPS_PER_PIXEL = 20 * 41 + 8 + 9 + 18
GUT_RAYS_BYTES_PER_PIXEL = 16
# the cuBLAS kernel of the plain chain's UT-mean einsum at 2^16 slots and more, whose
# summation order the UT projection kernel repeats (csrc/gut_project.cu)
UT_MEAN_BLAS = "gemv2N"
# the wrappers a pinhole step or render never launches: K5, K6, K7 (the Trainer reduces
# through K4), the UT projection and the world rays
NO_PINHOLE_LAUNCH = ("gut_blend_forward", "gut_blend_backward", "segred_prefix",
                     "ut_project_kernel", "pixel_world_rays_kernel")
TRAIN_STEPS = 30
TILE_T, CHUNK_T = 32, 256  # the trainer's plan (bench.py:91)
TILE_F, CHUNK_F, K_MAX_F = 16, 128, 4096  # render_view's plan
CHUNK_GUT = 128  # the GUT blend's chunk (tpu_splat/ops/pallas/blend.py CHUNK)
GUT_STEPS, GUT_PREFIX_STEPS = 20, 6  # the last six through the K7 lane
# the trainer phase: a 12-view capture at WIDTH x HEIGHT with 150k SfM points (the order of
# a real sparse model: the kNN init is O(N^2)), and the iterations of its three runs
TRAINER_VIEWS, TRAINER_SFM = 12, 150_000
TRAINER_ITERS, TRAINER_GUT_ITERS, TRAINER_CLI_ITERS = 96, 32, 16
# the ADC preset's run, the resume phase's runs, the bilateral-grid + pose-MLP run
ADC_ITERS, RESUME_ITERS, COMPONENT_ITERS = 96, 32, 24
# the serving side: SOG export of the render scene (the Trainer's sog_iterations), the
# card-against-CPU k-means check, SH-degree-4 train steps, the --view crop box, the web
# viewer's frames, and the Trainer under the live viewer
SOG_ITERS = 10
KMEANS_CHECK_N, KMEANS_CHECK_K = 20_000, 1024
SH4_STEPS = 5
CROP_MIN, CROP_MAX = (-2.0, -1.5, 3.0), (2.0, 1.5, 8.0)
VIEWER_W, VIEWER_H, VIEWER_FRAMES = 960, 540, 12
LIVE_ITERS, LIVE_TIMELAPSE_EVERY = 48, 16
# the batched step: cameras a step, the steps of its counted run, the batched CLI's run
BATCH, BATCHED_STEPS, TRAINER_BATCHED_ITERS = 4, 8, 32
BATCHED_GUT_STEPS = 6
BATCHED_CAPACITY = 1 << 20  # the batched phases' slots: the scene's 1M and dead ones
QUALITY_ITERS = 600  # the quality-floor run (the JAX package's CI gate)


def build_workload(n: int, width: int, height: int, seed: int = 0):
    """bench.py::build_workload's scene, regenerated with numpy: positions fill the
    frustum (z in [2, 12]), footprints of 1-4 px sigma, SH degree 3. -> (params, focal)"""
    rng = np.random.default_rng(seed)
    z = rng.uniform(2.0, 12.0, n).astype(np.float32)
    f = 0.85 * width
    x = rng.uniform(-0.55, 0.55, n).astype(np.float32) * z * (width / f)
    y = rng.uniform(-0.55, 0.55, n).astype(np.float32) * z * (height / f)
    means = np.stack([x, y, z], axis=1)
    sigma_px = rng.uniform(1.0, 4.0, n).astype(np.float32)
    sigma = sigma_px * z / f
    scaling = np.log(np.stack([sigma, sigma * rng.uniform(0.5, 1.0, n).astype(np.float32),
                               sigma], axis=1))
    q = rng.normal(0, 1, (n, 4)).astype(np.float32)
    q[:, 0] += 2.0
    opacity = rng.normal(-1.0, 1.0, (n, 1)).astype(np.float32)
    sh0 = rng.normal(0, 0.5, (n, 1, 3)).astype(np.float32)
    shN = rng.normal(0, 0.05, (n, 15, 3)).astype(np.float32)
    params = dict(means=means, sh0=sh0, shN=shN, scaling_raw=scaling.astype(np.float32),
                  rotation_raw=q, opacity_raw=opacity)
    return params, f


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median CUDA-event time of fn() in ms."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median CUDA-event time of fn() in ms with the stream held by a ~1 ms spin before the
    start event, so that the host has queued fn's launches when the card reaches them: the
    card's time, without the host's cost of launching (which `cuda_ms` takes in for a
    launch shorter than that cost)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@contextlib.contextmanager
def calls_counted(module, name: str):
    """Count the calls of `module.name` made inside the block; yields [count]."""
    fn, count = getattr(module, name), [0]

    def wrapped(*args, **kwargs):
        count[0] += 1
        return fn(*args, **kwargs)

    setattr(module, name, wrapped)
    try:
        yield count
    finally:
        setattr(module, name, fn)


def require(ok, what) -> None:
    """A check of the run: raises (also under python -O, unlike assert)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def phase(name: str, **fields) -> None:
    print(f"phase {name}: ok " + json.dumps(fields), flush=True)


def ptxas_lines(log: str) -> list[str]:
    """The lines of an nvcc -Xptxas -v log that name a kernel, its registers, its spills."""
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "entry function" in ln]


def ptxas_summary(log: str) -> dict:
    """Registers and spill bytes of each kernel instantiation in an nvcc -Xptxas -v log,
    keyed by the kernel's name and its template arguments (tile 16 / 32 for PPT 1 / 4,
    rays 4 / 8 for ORIGIN false / true): {"gut_fwd_kernel tile32-rays4": {"registers": 88,
    "spill_stores": 0, "spill_loads": 0}, ...}."""
    import re

    out, key, entry = {}, None, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            entry = m.group(1)
            t = re.search(r"(gut_(?:fwd|bwd)_kernel)ILi(\d)ELb(\d)E", entry)
            key = (f"{t.group(1)} tile{16 if t.group(2) == '1' else 32}-rays"
                   f"{8 if t.group(3) == '1' else 4}" if t else entry)
            out[key] = {}
        m = re.search(r"Function properties for (\S+)", ln)
        if m and m.group(1) != entry:  # a device function the kernel calls, not the kernel
            key = None
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and key:
            out[key].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and key:
            out[key]["registers"] = int(m.group(1))
    return out


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def check_blend(got, want, label: str) -> float:
    """K2 tolerances: atol 1e-5 on rgb and T, rtol 1e-5 (and atol 1e-5 near zero) on
    depth, atol 1e-5 on chk."""
    import torch

    (out, chk), (out_p, chk_p) = got, want
    torch.testing.assert_close(out[..., :4], out_p[..., :4], rtol=0, atol=1e-5,
                               msg=lambda m: f"{label} rgb/T: {m}")
    torch.testing.assert_close(out[..., 4:], out_p[..., 4:], rtol=1e-5, atol=1e-5,
                               msg=lambda m: f"{label} depth: {m}")
    torch.testing.assert_close(chk, chk_p, rtol=0, atol=1e-5,
                               msg=lambda m: f"{label} chk: {m}")
    return max(max_err(out[..., :4], out_p[..., :4]), max_err(chk, chk_p))


def check_stops(chk, chk_plain, flat_f32, args, kw, label: str) -> dict:
    """Stop decisions of K2 against its plain version: the same (pixel, chunk) entries of
    `chk` are 0, and the checkpoints give the same pair counts (`blend_pairs`: walked,
    kept, used, stops). -> the counts."""
    import torch

    require(torch.equal(chk == 0, chk_plain == 0),
            f"{label}: {int(((chk == 0) != (chk_plain == 0)).sum())} (pixel, chunk) "
            "checkpoints are 0 on one side only")
    got = blend_pairs(flat_f32, *args, chk, **kw)
    want = blend_pairs(flat_f32, *args, chk_plain, **kw)
    require(got == want, f"{label}: pair counts {got} against the plain version's {want}")
    return want


def check_blend_bwd_repeats(fn, *args, label: str, **kw) -> None:
    """K3 gives the same bits on two launches (a fixed order of sums, no atomics)."""
    import torch

    require(torch.equal(fn(*args, **kw), fn(*args, **kw)), f"{label}: two launches differ")


def check_blend_bwd(gflat, gflat_plain, owned, label: str) -> float:
    """K3 tolerance: max abs error <= 1e-4 of the largest absolute gradient (float32
    pixel sums in another order; total-minus-prefix against a reverse running sum), and
    columns owned by no tile exactly zero. -> the relative error."""
    scale = float(gflat_plain.abs().max())
    rel = max_err(gflat, gflat_plain) / max(scale, 1e-30)
    require(scale > 0 and rel <= 1e-4, f"{label}: error {rel} of the max gradient {scale}")
    require(bool((gflat[:, ~owned] == 0).all()), f"{label}: an unowned column is not zero")
    return rel


def check_segsum(got, want, rows, start, end, label: str, cols=None) -> float:
    """K4 tolerance: rtol 1e-5, atol 1e-5 of the run's magnitude (the sum of its absolute
    values) plus 1e-35 (below float32's normal range a value keeps fewer bits): only the
    order of float32 adds differs (runs over 64 slots: a block-strided sum against float64).
    Empty runs exactly zero. -> max abs error."""
    from tpu_splat_torch.ops.cuda.raster import segsum_emission_plain

    magnitude = segsum_emission_plain(rows.abs(), start, end, cols)
    excess = (got - want).abs() - (1e-5 * want.abs() + 1e-5 * magnitude + 1e-35)
    worst = int(excess.argmax())
    require(bool((excess <= 0).all()),
            f"{label}: {int((excess > 0).sum())} sums out of tolerance, worst got "
            f"{float(got.flatten()[worst])!r} want {float(want.flatten()[worst])!r} "
            f"magnitude {float(magnitude.flatten()[worst])!r}")
    require(bool((got[:, end <= start] == 0).all()), f"{label}: an empty run is not zero")
    return max_err(got, want)


def check_segsum_bits(got, others: dict, start, end, label: str) -> int:
    """K4 sums every run of at most LONG_RUN slots slot by slot in run order, so on those
    runs it gives the same bits as each of `others` (the plain version, the gather followed
    by K4 on emission-order rows, a second launch). -> the number of such runs."""
    import torch

    from tpu_splat_torch.ops.cuda.raster import LONG_RUN

    short = (end - start) <= LONG_RUN
    for name, other in others.items():
        require(torch.equal(got[:, short], other[:, short]),
                f"{label}: a run of at most {LONG_RUN} slots differs from {name}")
    return int(short.sum())


def random_segments(tile_size: int, chunk: int, seed: int, dev, borders: bool = False):
    """Random blend inputs: 8x6 tiles, unaligned contiguous segments with gaps, up to
    4 chunks per tile, footprints of 1-6 px around each tile, opacities high enough
    that many pixels stop early. With `borders` the splats sit on the borders of the
    blend kernels' 8x4 warp sub-rectangles (means within 0.05 px of the grid lines,
    footprints of 0.5-3 px) and a third of them have an opacity within 1e-4 below to 1e-2
    above 1/255, where the cull box is smallest."""
    import torch

    rng = np.random.default_rng(seed)
    gw, gh, max_chunks = 8, 6, 4
    n_tiles = gw * gh
    count = rng.integers(0, max_chunks * chunk + 1, n_tiles)
    count[:3] = (0, 1, max_chunks * chunk)
    gaps = rng.integers(0, 200, n_tiles)
    seg_start = np.cumsum(gaps) + np.concatenate([[0], np.cumsum(count)[:-1]])
    m = int(seg_start[-1] + count[-1])
    tile_of = np.zeros(m, np.int64)
    for t in range(n_tiles):
        tile_of[seg_start[t]:seg_start[t] + count[t]] = t
    s = rng.uniform(1.0, 6.0, m)
    ca = 1 / (s * s)
    cc = 1 / (s * s * rng.uniform(0.5, 2.0, m))
    mx = (tile_of % gw) * tile_size + rng.uniform(-8, tile_size + 8, m)
    my = (tile_of // gw) * tile_size + rng.uniform(-8, tile_size + 8, m)
    op = rng.uniform(0.05, 1.0, m)
    if borders:
        ca, cc = ca * (s / rng.uniform(0.5, 3.0, m)) ** 2, cc * (s / rng.uniform(0.5, 3.0, m)) ** 2
        mx = 8 * np.round(mx / 8) + rng.uniform(-0.05, 0.05, m)
        my = 4 * np.round(my / 4) + rng.uniform(-0.05, 0.05, m)
        low = rng.random(m) < 1 / 3
        op[low] = rng.uniform(1 - 1e-4, 1 + 1e-2, int(low.sum())) / 255
    flat = np.stack([mx, my, ca, rng.uniform(-0.3, 0.3, m) * np.sqrt(ca * cc), cc, op,
                     *rng.uniform(0, 1, (3, m)), rng.uniform(1, 10, m)]).astype(np.float32)
    as_i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)
    kw = dict(n_tiles=n_tiles, grid_w=gw, tile_size=tile_size, max_chunks=max_chunks,
              chunk=chunk)
    return (torch.from_numpy(flat).to(dev), as_i32(seg_start), as_i32(count)), kw


def random_gut_segments(tile_size: int, chunk: int, seed: int, dev, ray_width: int = 4):
    """Random inputs of the world-ray blend: 8x6 tiles seen by a pinhole camera at the
    origin, unaligned contiguous segments with gaps, up to 4 chunks per tile, anisotropic
    Gaussians of 1-6 px footprint on rays through and around each tile, opacities high
    enough that many pixels stop early. `ray_width` 8 adds per-pixel origin offsets.
    -> ((flat [17, M], rays [T, P, 4|8], seg_start, count), kw)"""
    import torch

    rng = np.random.default_rng(seed)
    gw, gh, max_chunks = 8, 6, 4
    n_tiles, p = gw * gh, tile_size * tile_size
    focal, cx, cy = 1.2 * gw * tile_size, gw * tile_size / 2, gh * tile_size / 2
    count = rng.integers(0, max_chunks * chunk + 1, n_tiles)
    count[:3] = (0, 1, max_chunks * chunk)
    gaps = rng.integers(0, 200, n_tiles)
    seg_start = np.cumsum(gaps) + np.concatenate([[0], np.cumsum(count)[:-1]])
    m = int(seg_start[-1] + count[-1])
    tile_of = np.zeros(m, np.int64)
    for t in range(n_tiles):
        tile_of[seg_start[t]:seg_start[t] + count[t]] = t
    z = rng.uniform(2.0, 10.0, m)
    u = (tile_of % gw) * tile_size + rng.uniform(-8, tile_size + 8, m)
    v = (tile_of // gw) * tile_size + rng.uniform(-8, tile_size + 8, m)
    mean = np.stack([(u - cx) / focal * z, (v - cy) / focal * z, z], 1)
    sigma = rng.uniform(1.0, 6.0, (m, 1)) * z[:, None] / focal * rng.uniform(0.5, 1.0, (m, 3))
    q = rng.normal(0, 1, (m, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, zz = q.T
    rot = np.stack([1 - 2 * (y * y + zz * zz), 2 * (x * y - w * zz), 2 * (x * zz + w * y),
                    2 * (x * y + w * zz), 1 - 2 * (x * x + zz * zz), 2 * (y * zz - w * x),
                    2 * (x * zz - w * y), 2 * (y * zz + w * x), 1 - 2 * (x * x + y * y)],
                   1).reshape(m, 3, 3)
    mat = rot.transpose(0, 2, 1) / sigma[:, :, None]  # S^-1 R^T
    gro = np.einsum("mij,mj->mi", mat, -mean)
    flat = np.concatenate([mat.reshape(m, 9), gro, rng.uniform(0.05, 1.0, (m, 1)),
                           rng.uniform(0, 1, (m, 3)), z[:, None]], 1).T.astype(np.float32)
    t = np.arange(n_tiles)[:, None]
    idx = np.arange(p)[None, :]
    px = (t % gw) * tile_size + idx % tile_size + 0.5
    py = (t // gw) * tile_size + idx // tile_size + 0.5
    d = np.stack([(px - cx) / focal, (py - cy) / focal, np.ones_like(px)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cols = [d, np.zeros_like(px)[..., None]]
    if ray_width == 8:
        cols += [rng.normal(0, 0.01, (n_tiles, p, 3)), np.zeros_like(px)[..., None]]
    rays = np.concatenate(cols, -1).astype(np.float32)
    as_i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)
    kw = dict(n_tiles=n_tiles, tile_size=tile_size, max_chunks=max_chunks, chunk=chunk)
    return (torch.from_numpy(np.ascontiguousarray(flat)).to(dev),
            torch.from_numpy(rays).to(dev), as_i32(seg_start), as_i32(count)), kw


MIN_ALPHA_F32 = float(np.float32(1.0 / 255.0))


def gut_camera_rays(model: str, grid_w: int, grid_h: int, tile_size: int):
    """World rays [T, P, 4|8] (on the CPU) of a grid_w x grid_h grid of tiles seen by a
    tilted camera off the origin through one of the GUT camera models: "pinhole" (radial
    and tangential distortion), "fisheye" (the image corners at 98% of its max_angle),
    "ortho" (rays 8 wide), "rolling" (a distorted pinhole with a top-to-bottom rolling
    shutter, rays 8 wide). -> (rays, camera position [3], focal length in px)"""
    import torch

    from tpu_splat_torch.ops.cameras import CameraParams, fisheye_max_angle
    from tpu_splat_torch.ops.gut import pixel_world_rays

    width, height = grid_w * tile_size, grid_h * tile_size
    ang = 0.3
    rot = np.array([[math.cos(ang), 0, math.sin(ang)], [0, 1, 0],
                    [-math.sin(ang), 0, math.cos(ang)]], np.float32)
    cam_pos = np.array([0.4, -0.2, -1.0], np.float32)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3], w2c[:3, 3] = rot, -rot @ cam_pos
    params = CameraParams(radial=(0.1, -0.02, 0, 0, 0, 0), tangential=(1e-3, -2e-3))
    pose, max_angle, focal = None, None, 0.9 * width
    if model == "fisheye":
        params = CameraParams(model="fisheye", radial=(-0.05, 0, 0, 0, 0, 0))
        max_angle = fisheye_max_angle(params)
        theta = 0.98 * max_angle
        focal = math.hypot(width, height) / 2 / (theta * (1 - 0.05 * theta ** 2))
    elif model == "ortho":
        params, focal = CameraParams(model="ortho"), width / 3.0
    elif model == "rolling":
        params = CameraParams(radial=(0.05, 0, 0, 0, 0, 0), shutter="top_to_bottom")
        q0 = torch.tensor([math.cos(ang / 2), 0, -math.sin(ang / 2), 0])  # w2c, wxyz
        q1 = torch.tensor([math.cos(ang / 2 + 0.02), 0.01, -math.sin(ang / 2 + 0.02), 0])
        t0 = torch.from_numpy(w2c[:3, 3])
        pose = (q0, t0, q1 / torch.linalg.vector_norm(q1), t0 + torch.tensor([0.05, 0.02, 0]))
    rays = pixel_world_rays(torch.from_numpy(w2c), torch.from_numpy(cam_pos), focal, focal,
                            width / 2.0, height / 2.0, params, max_angle, pose, grid_w=grid_w,
                            grid_h=grid_h, tile_size=tile_size, width=width, height=height)
    return rays, cam_pos, focal


def rotations(rng, n: int, first_axis=None):
    """Random rotation matrices [n, 3, 3]; with `first_axis` [n, 3] (unit) their first
    column is that axis."""
    q = rng.normal(0, 1, (n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    rot = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                    2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                    2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                   1).reshape(n, 3, 3)
    if first_axis is not None:  # Gram-Schmidt against the given axis
        b = rot[:, :, 1] - np.sum(rot[:, :, 1] * first_axis, 1, keepdims=True) * first_axis
        b /= np.linalg.norm(b, axis=1, keepdims=True)
        rot = np.stack([first_axis, b, np.cross(first_axis, b)], axis=2)
    return rot


def gut_table(mean, scales, rot, op, cam_pos, rng):
    """G_* rows [17, n] float32 of Gaussians: M = S^-1 R^T, gro = M (cam_pos - mean),
    opacity, random rgb, depth |mean - cam_pos|."""
    mat = rot.transpose(0, 2, 1) / scales[:, :, None]
    gro = np.einsum("nij,nj->ni", mat, cam_pos[None, :] - mean)
    n = len(op)
    depth = np.linalg.norm(mean - cam_pos[None, :], axis=1, keepdims=True)
    return np.concatenate([mat.reshape(n, 9), gro, op[:, None], rng.uniform(0, 1, (n, 3)),
                           depth], 1).T.astype(np.float32)


def gut_grazing_splats(rng, rays, cam_pos, focal, tile, cell, lane, ortho: bool):
    """Splats whose 1/255 ellipsoid grazes, from outside the cone of its 8x4 sub-rectangle,
    the ray of pixel `lane` of cell `cell` of tile `tile` (arrays of one entry a splat),
    within a relative 1e-3 to 1e-7 of the level; the grazing axis is the splat's longest,
    so the kernels' sphere is tight there. -> (flat [17, n] numpy, the grazed pixel's index
    in its tile)"""
    from tpu_splat_torch.ops.cuda.gut_kernels import gut_cull_cells, gut_cull_cones

    n = len(tile)
    tile_size = int(round(math.sqrt(rays.shape[1])))
    pix = gut_cull_cells(tile_size).numpy()[cell, lane]
    r = rays.double().numpy()[tile, pix]
    d = r[:, :3] / np.linalg.norm(r[:, :3], axis=1, keepdims=True)
    origin = cam_pos[None, :] + (r[:, 4:7] if r.shape[1] == 8 else 0.0)
    axis = gut_cull_cones(rays, tile_size)[0].double().numpy()[tile, cell, :3]
    w = rng.normal(0, 1, (n, 3)) if ortho else d - axis  # away from the cone's axis
    w -= np.sum(w * d, 1, keepdims=True) * d
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    depth = rng.uniform(1.0, 8.0, n)
    sigma = (1.0 if ortho else depth) / focal * rng.uniform(1.0, 6.0, n)
    scales = sigma[:, None] * np.stack([np.ones(n), *rng.uniform(0.005, 1.0, (2, n))], 1)
    rot = rotations(rng, n, first_axis=w)
    op = rng.uniform(MIN_ALPHA_F32, 1.0, n)
    low = rng.random(n) < 1 / 3  # a third within 1e-4 below to 1e-2 above 1/255
    op[low] = MIN_ALPHA_F32 * rng.uniform(1 - 1e-4, 1 + 1e-2, int(low.sum()))
    mat = rot.transpose(0, 2, 1) / scales[:, :, None]
    nv = np.einsum("nij,nj->ni", mat, d)
    nv /= np.linalg.norm(nv, axis=1, keepdims=True)
    reach = np.linalg.norm(np.cross(nv, np.einsum("nij,nj->ni", mat, w)), axis=1)
    jitter = rng.uniform(-1, 1, n) * rng.choice([1e-3, 1e-5, 1e-7], n)
    level = np.sqrt(2 * np.log(np.maximum(op / MIN_ALPHA_F32, 1.0)))
    lam = level * (1 + jitter) / reach
    mean = origin + depth[:, None] * d + lam[:, None] * w
    return gut_table(mean, scales, rot, op, cam_pos, rng), pix


def gut_border_segments(model: str, tile_size: int, chunk: int, seed: int, dev,
                        grid=(8, 6)):
    """World-ray blend inputs on the borders of the GUT kernels' warp ray cones, through
    `model` (`gut_camera_rays`): unaligned contiguous segments with gaps, up to 4 chunks
    per tile; three quarters of a tile's splats graze the cone of one of its 8x4
    sub-rectangles at a corner pixel's ray (`gut_grazing_splats`: a third of those with an
    opacity within 1e-4 below to 1e-2 above 1/255), the rest are opaque splats on random
    pixels' rays, so that many pixels stop. -> ((flat [17, M], rays, seg_start, count), kw)"""
    import torch

    rng = np.random.default_rng(seed)
    gw, gh = grid
    max_chunks = 4
    n_tiles = gw * gh
    rays, cam_pos, focal = gut_camera_rays(model, gw, gh, tile_size)
    count = rng.integers(0, max_chunks * chunk + 1, n_tiles)
    count[:3] = (0, 1, max_chunks * chunk)
    seg_start = np.cumsum(rng.integers(0, 200, n_tiles)) + np.concatenate(
        [[0], np.cumsum(count)[:-1]])
    m = int(seg_start[-1] + count[-1])
    tile_of = np.zeros(m, np.int64)
    for t in range(n_tiles):
        tile_of[seg_start[t]:seg_start[t] + count[t]] = t
    n_cells = tile_size * tile_size // 32
    flat, _ = gut_grazing_splats(rng, rays, cam_pos, focal, tile_of, rng.integers(0, n_cells, m),
                                 rng.choice([0, 7, 24, 31], m), model == "ortho")
    opaque = rng.random(m) < 0.25
    r = rays.double().numpy()[tile_of, rng.integers(0, rays.shape[1], m)][opaque]
    d = r[:, :3] / np.linalg.norm(r[:, :3], axis=1, keepdims=True)
    k = int(opaque.sum())
    depth = rng.uniform(1.0, 8.0, k)
    sigma = (1.0 if model == "ortho" else depth) / focal * rng.uniform(2.0, 8.0, k)
    origin = cam_pos[None, :] + (r[:, 4:7] if r.shape[1] == 8 else 0.0)
    mean = origin + depth[:, None] * d + rng.normal(0, 1, (k, 3)) * sigma[:, None]
    flat[:, opaque] = gut_table(mean, sigma[:, None] * rng.uniform(0.5, 1.0, (k, 3)),
                                rotations(rng, k), rng.uniform(0.5, 1.0, k), cam_pos, rng)
    as_i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)
    kw = dict(n_tiles=n_tiles, tile_size=tile_size, max_chunks=max_chunks, chunk=chunk)
    return (torch.from_numpy(np.ascontiguousarray(flat)).to(dev), rays.to(dev),
            as_i32(seg_start), as_i32(count)), kw


def blend_pairs(flat, seg_start, count, chk, *, n_tiles, grid_w, tile_size, max_chunks,
                chunk) -> dict:
    """(pixel, instance) pair counts of the blend on these inputs, from the checkpoints
    `chk` (each chunk's entry transmittance); `flat` holds F_* rows:
      walked: per pixel, its tile's instances up to and including the one that stops it
        (all if none does): what a blend without a cull evaluates;
      kept:   those of them whose cull box meets the pixel's 8x4 sub-rectangle
        (`cull_keep`): what K2 and K3 evaluate;
      used:   those that pass the alpha test before the stop;
      stops:  the stopping pairs, one for each pixel that stops."""
    import torch

    from tpu_splat_torch.ops.cuda.blend import tile_pixel_centers

    dev = flat.device
    px, py = tile_pixel_centers(n_tiles, grid_w, tile_size, dev)
    px, py = px[:, None, :], py[:, None, :]
    cnt = count.long()
    lane = torch.arange(chunk, device=dev)
    counts = dict(walked=0, kept=0, used=0, stops=0)
    step = max(1, (1 << 26) // (chunk * tile_size * tile_size))
    for t0 in range(0, n_tiles, step):
        part = _blend_pairs_of(flat, seg_start[t0:t0 + step], cnt[t0:t0 + step],
                               chk[t0:t0 + step], px[t0:t0 + step], py[t0:t0 + step], lane,
                               chunk, max_chunks)
        counts = {k: v + part[k] for k, v in counts.items()}
    return counts


def _count_pairs(alpha, valid, t_entry, n_lanes, lane, chunk, keep=None) -> dict:
    """Pair counts (see `blend_pairs`) of one chunk of a batch of tiles, from its alphas
    and validity [T, C, P], its entry transmittance [T, P], its lane counts [T] and, for
    `kept`, the cull's verdict [T, C, P]."""
    import torch

    cp = torch.cumprod(1.0 - torch.where(valid, alpha, 0.0), dim=1)
    below = (t_entry[:, None, :] * cp < 1e-4) & valid
    stops = below.any(1)
    first = torch.argmax(below.to(torch.int8), dim=1) + 1
    entered = t_entry > 0
    pairs = torch.where(stops, first, n_lanes[:, None])
    before_stop = lane[None, :, None] < torch.where(stops, first - 1, chunk)[:, None, :]
    counts = dict(walked=int(torch.where(entered, pairs, 0).sum()),
                  used=int((valid & before_stop & entered[:, None, :]).sum()),
                  stops=int((stops & entered).sum()))
    if keep is not None:
        walked = (lane[None, :, None] < pairs[:, None, :]) & entered[:, None, :]
        counts["kept"] = int((walked & keep).sum())
    return counts


def _blend_pairs_of(flat, seg_start, cnt, chk, px, py, lane, chunk, max_chunks):
    import torch

    from tpu_splat_torch.ops.cuda.blend import cull_boxes, cull_keep
    from tpu_splat_torch.ops.projection import MAX_FRAGMENT_ALPHA, MIN_ALPHA

    counts = dict(walked=0, kept=0, used=0, stops=0)
    for j in range(max_chunks):
        t_entry = chk[:, :, j]  # [T, P]; 0 = stopped or not visited
        if not bool((t_entry > 0).any()):
            break
        local = j * chunk + lane
        lane_valid = local[None, :] < cnt[:, None]
        idx = torch.where(lane_valid, seg_start.long()[:, None] + local[None, :], 0)
        f = flat[:6, idx]
        mx, my, ca, cb, cc, op = (f[i][:, :, None] for i in range(6))
        dx, dy = mx - px, my - py
        sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
        alpha = torch.clamp_max(op * torch.exp(-torch.clamp_min(sigma, 0.0)),
                                MAX_FRAGMENT_ALPHA)
        valid = lane_valid[:, :, None] & (sigma >= 0.0) & (alpha >= MIN_ALPHA)
        keep = cull_keep(cull_boxes(f)[..., None], px, py)
        part = _count_pairs(alpha, valid, t_entry, lane_valid.sum(1), lane, chunk, keep)
        counts = {k: v + part[k] for k, v in counts.items()}
    return counts


def gut_blend_pairs(flat, rays, seg_start, count, chk, *, n_tiles, tile_size, max_chunks,
                    chunk) -> dict:
    """`blend_pairs` for the world-ray blend, from the checkpoints `chk`: the pairs a walk
    without a cull evaluates (walked), those the kernels' cull keeps (kept: the sphere of
    `gut_cull_spheres` may meet the cone of `gut_cull_cones` of the pixel's 8x4
    sub-rectangle), the used pairs and the stopping pairs."""
    import torch

    from tpu_splat_torch.ops.cuda.gut_kernels import (gut_cull_cones, gut_cull_keep,
                                                      gut_cull_spheres, ray_columns,
                                                      ray_response)

    lane = torch.arange(chunk, device=flat.device)
    counts = dict(walked=0, kept=0, used=0, stops=0)
    step = max(1, (1 << 24) // (chunk * tile_size * tile_size))
    for t0 in range(0, n_tiles, step):
        start = seg_start[t0:t0 + step].long()
        cnt = count[t0:t0 + step].clamp(0, max_chunks * chunk).long()
        d, do = ray_columns(rays[t0:t0 + step])
        cones, do_max = gut_cull_cones(rays[t0:t0 + step], tile_size)
        for j in range(max_chunks):
            t_entry = chk[t0:t0 + step, :, j]
            if not bool((t_entry > 0).any()):
                break
            f, _, lane_valid, a, valid, _ = ray_response(flat, d, do, start, cnt, j, chunk)
            keep = gut_cull_keep(gut_cull_spheres(f, do_max[:, None]), cones, tile_size)
            part = _count_pairs(a, valid, t_entry, lane_valid.sum(1), lane, chunk, keep)
            counts = {k: v + part[k] for k, v in counts.items()}
    return counts


def check_gut_stops(chk, chk_plain, args, kw, label: str) -> dict:
    """Stop decisions of K5 against its plain version: the same (pixel, chunk) entries of
    `chk` are 0, and the checkpoints give the same pair counts (`gut_blend_pairs`).
    -> the counts."""
    import torch

    require(torch.equal(chk == 0, chk_plain == 0),
            f"{label}: {int(((chk == 0) != (chk_plain == 0)).sum())} (pixel, chunk) "
            "checkpoints are 0 on one side only")
    got = gut_blend_pairs(*args, chk, **kw)
    want = gut_blend_pairs(*args, chk_plain, **kw)
    require(got == want, f"{label}: pair counts {got} against the plain version's {want}")
    # a used or stopping pair passed the alpha test: the cull must have kept it
    require(want["kept"] >= want["used"] + want["stops"],
            f"{label}: the cull keeps fewer pairs than are used: {want}")
    return want



def gut_test_cameras() -> dict:
    """The GUT projection kernels' camera models: an OpenCV pinhole with every radial,
    tangential and thin-prism coefficient non-zero, a fisheye, an ortho camera."""
    from tpu_splat_torch.ops.cameras import CameraParams

    return {
        "pinhole": CameraParams(radial=(0.05, -0.01, 0.002, 0.01, -0.002, 0.0005),
                                tangential=(0.001, -0.0015),
                                thin_prism=(0.0008, -0.0003, 0.0005, 0.0002)),
        "fisheye": CameraParams(model="fisheye",
                                radial=(0.05, -0.01, 0.002, -0.0005, 0.0, 0.0)),
        "ortho": CameraParams(model="ortho"),
    }


def near_tile_edge(proj, i: int, tile: int) -> bool:
    """Whether a rect edge of the projection's slot i lies within 1e-4 of a tile boundary,
    or its radius within 1e-4 of its rounding (float64 from its outputs)."""
    a, b, c = (float(v) for v in proj.conic[i].double())
    det = 1.0 / (a * c - b * b)
    op = float(proj.opacity[i])
    ext = min(np.sqrt(max(2.0 * np.log(op * 255.0), 0.0)), 3.33)
    for m, cov in ((float(proj.mean2d[i, 0]), c * det), (float(proj.mean2d[i, 1]), a * det)):
        e = ext * np.sqrt(max(cov, 0.0))
        r = np.ceil(e)
        if abs(e - np.round(e)) <= 1e-4:
            return True
        for edge in ((m - r) / tile, (m + r) / tile):
            if abs(edge - np.round(edge)) <= 1e-4:
                return True
    return False


def cuda_kernel_names(fn):
    """fn() under torch.profiler -> (its result, the names of the kernels it ran on the
    card)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, sorted({e.name for e in prof.events() if e.device_type.name == "CUDA"})


def check_gut_projection(slots, cam, tile: int, label: str) -> dict:
    """`ut_project` through its kernel against its plain chain on the same slots
    (means, scaling_raw, rotation_raw, opacity_raw, alive) and camera (w2c, fx, fy, cx,
    cy, cam_params, width, height, max_angle): the float fields rtol 1e-5, atol 1e-5 on
    the slots both call visible; `visible`, the tile rects and `n_tiles` equal but for at
    most 3 slots, each with a plain rect edge within 1e-4 of a tile boundary; `color` and
    `power_threshold` equal; dead slots invisible with no tiles. The float32 kernel and
    chain agree that closely only where they sum the UT mean in one order, so on the card
    the chain's must have run cuBLAS's UT_MEAN_BLAS, the order the kernel repeats; and,
    whatever the library picks, the kernel is held against the chain run in float64: no
    further from it than twice the float32 chain is (the UT's weights, -99 and 16.7,
    magnify a rounding), plus 1e-6 of the field's largest value. -> the largest gaps"""
    import torch

    from tpu_splat_torch.ops import gut
    from tpu_splat_torch.ops.cuda.gut_project import ut_project_kernel

    w2c, fx, fy, cx, cy, params, width, height, max_angle = cam
    args = (fx, fy, cx, cy, params, width, height, tile, max_angle)
    card = slots[0].is_cuda
    launches = ut_project_kernel.launches
    got, got_comp = gut.ut_project(*slots, w2c, *args, impl="kernel")
    require(ut_project_kernel.launches == launches + card,
            f"{label}: ut_project must launch its kernel once on the card")

    def chain():
        return gut.ut_project(*slots, w2c, *args, impl="plain")

    blas = []
    if card:
        (want, want_comp), names = cuda_kernel_names(chain)
        blas = [k[:64] for k in names if "gemv" in k or "gemm" in k]
        require(any(UT_MEAN_BLAS in k for k in blas),
                (f"{label}: the plain chain's UT mean ran another cuBLAS kernel than "
                 f"{UT_MEAN_BLAS}, whose summation order the kernel repeats", blas))
    else:
        want, want_comp = chain()
    ref, ref_comp = gut.ut_project(*(x.double() for x in slots[:4]), slots[4], w2c.double(),
                                   *args, impl="plain")
    alive = slots[4]
    require(not bool(got.visible[~alive].any()) and not bool(got.n_tiles[~alive].any()),
            f"{label}: a dead slot is visible or has tiles")
    vis = want.visible & got.visible
    both = vis & ref.visible
    gaps = dict(visible=int(vis.sum()))
    require(gaps["visible"] > 1000, f"{label}: {gaps['visible']} visible slots")
    for name in ("mean2d", "conic", "opacity", "depth", "compensation"):
        g, w, r = (c if name == "compensation" else getattr(p, name)
                   for p, c in ((got, got_comp), (want, want_comp), (ref, ref_comp)))
        torch.testing.assert_close(g[vis], w[vis], rtol=1e-5, atol=1e-5,
                                   msg=lambda m, name=name: f"{label}: {name}: {m}")
        d = (g[vis] - w[vis]).abs()
        e_kernel = float((g[both].double() - r[both]).abs().max())
        e_chain = float((w[both].double() - r[both]).abs().max())
        require(e_kernel <= 2.0 * e_chain + 1e-6 * float(r[both].abs().max()),
                (f"{label}: {name} further from the float64 chain than the float32 chain",
                 e_kernel, e_chain))
        gaps[name] = dict(max_abs=float(d.max()),
                          max_rel=float((d / w[vis].abs().clamp_min(1e-30)).max()),
                          not_bit_equal=int((g[vis] != w[vis]).sum()),
                          f64_kernel=e_kernel, f64_chain=e_chain)
    require(torch.equal(got.color, want.color)
            and torch.equal(got.power_threshold, want.power_threshold),
            f"{label}: color or power_threshold")
    off = ((got.visible != want.visible) | (got.n_tiles != want.n_tiles)
           | (got.tile_min != want.tile_min).any(1) | (got.tile_max != want.tile_max).any(1))
    off_idx = torch.nonzero(off).flatten().tolist()
    require(len(off_idx) <= 3 and all(near_tile_edge(want, i, tile) for i in off_idx),
            (f"{label}: visible, tile rects or n_tiles differ", off_idx))
    gaps.update(int_fields_off=len(off_idx), blas=blas)
    return gaps


def check_gut_rays(ray_args, kw: dict, label: str) -> dict:
    """`pixel_world_rays` through its kernel against its plain chain: the shape, rtol
    1e-5 (atol 1e-6), one launch on the card. -> the largest gap and the count of values
    not bit-equal"""
    import torch

    from tpu_splat_torch.ops import gut
    from tpu_splat_torch.ops.cuda.gut_project import pixel_world_rays_kernel

    card = ray_args[0].is_cuda
    launches = pixel_world_rays_kernel.launches
    got = gut.pixel_world_rays(*ray_args, **kw, impl="kernel")
    require(pixel_world_rays_kernel.launches == launches + card,
            f"{label}: pixel_world_rays must launch its kernel once on the card")
    want = gut.pixel_world_rays(*ray_args, **kw, impl="plain")
    wide = 8 if ray_args[6].model == "ortho" else 4
    require(got.shape == want.shape == (kw["grid_w"] * kw["grid_h"],
                                        kw["tile_size"] ** 2, wide),
            (label, tuple(got.shape), tuple(want.shape)))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6,
                               msg=lambda m: f"{label}: rays: {m}")
    return dict(max_abs=float((got - want).abs().max()),
                not_bit_equal=int((got != want).sum()))


def gut_projection_phase(sp, focal: float, dev) -> dict:
    """`gut-projection-kernels`: the UT projection and world-ray kernels against their
    plain chains (`check_gut_projection`, `check_gut_rays`) at the main path's shapes: the
    state's slots (the dead ones among them), WIDTH x HEIGHT, from a camera turned 0.1 rad
    and set 3 units into the scene, so that a tenth of it lies behind. Cameras: the OPENCV
    pinhole of `gut_test_cameras` with its coefficients bound to a [12] device tensor (the
    Trainer's path) at tiles 16 and 32 and over a window of 4 tile rows from row 3, and
    static; the fisheye with its max angle as a float and as a 0-dim device tensor; the
    ortho camera. Times both kernels (`queued_ms`: the card's time; `cuda_ms`: with the
    launch's host cost) and both chains (`cuda_ms`) at the GUT cell's camera and tile (the
    bound pinhole, tile 16). -> the phase's numbers"""
    import torch

    from tpu_splat_torch.ops import gut
    from tpu_splat_torch.ops.cameras import bind_coeffs, fisheye_max_angle

    c, s_ = math.cos(0.1), math.sin(0.1)
    w2c = torch.tensor([[c, 0, s_, 0.1], [0, 1, 0, -0.05], [-s_, 0, c, -3.0], [0, 0, 0, 1]],
                       dtype=torch.float32, device=dev)
    slots = (sp.means, sp.scaling_raw, sp.rotation_raw, sp.opacity_raw, sp.alive)
    cams = gut_test_cameras()
    fish_angle = fisheye_max_angle(cams["fisheye"])
    bound = bind_coeffs(cams["pinhole"],
                        torch.as_tensor(cams["pinhole"].coeff_vector(), device=dev))
    cases = (("pinhole-bound", bound, None, 16), ("pinhole-bound", bound, None, 32),
             ("pinhole", cams["pinhole"], None, 16),
             ("fisheye", cams["fisheye"], fish_angle, 32),
             ("fisheye-angle-on-card", cams["fisheye"],
              torch.tensor(fish_angle, dtype=torch.float32, device=dev), 16),
             ("ortho", cams["ortho"], None, 16))
    out = dict(slots=int(sp.means.shape[0]), width=WIDTH, height=HEIGHT, cases={})
    for name, params, max_angle, tile in cases:
        f = WIDTH / 16.0 if params.model == "ortho" else focal
        cam = (w2c, f, f, WIDTH / 2.0, HEIGHT / 2.0, params, WIDTH, HEIGHT, max_angle)
        label = f"GUT projection {name} tile {tile}"
        case = dict(projection=check_gut_projection(slots, cam, tile, label))
        gw, gh = -(-WIDTH // tile), -(-HEIGHT // tile)
        ray_args = (w2c, torch.zeros(3, device=dev), f, f, WIDTH / 2.0, HEIGHT / 2.0, params,
                    max_angle, None)
        ray_kw = dict(grid_w=gw, grid_h=gh, tile_size=tile, width=WIDTH, height=HEIGHT)
        windows = ((0, gh), (3, 4)) if (name, tile) == ("pinhole-bound", 16) else ((0, gh),)
        for y0, rows in windows:
            case[f"rays@{y0}"] = check_gut_rays(ray_args, dict(ray_kw, grid_h=rows,
                                                                tile_y0=y0),
                                                f"{label} rays from tile row {y0}")
        out["cases"][f"{name}-{tile}"] = case
        if (name, tile) != ("pinhole-bound", 16):
            continue
        proj_args = (*slots, w2c, f, f, WIDTH / 2.0, HEIGHT / 2.0, params, WIDTH, HEIGHT,
                     tile, max_angle)
        out["timed"] = f"{name}-{tile}"
        def project():
            return gut.ut_project(*proj_args, impl="kernel")

        def rays():
            return gut.pixel_world_rays(*ray_args, **ray_kw, impl="kernel")

        out["ut_project_ms"] = queued_ms(project, 20)
        out["ut_project_ms_with_launch"] = cuda_ms(project, 20)
        out["ut_project_plain_ms"] = cuda_ms(
            lambda: gut.ut_project(*proj_args, impl="plain"), 3, warmup=1)
        out["rays_ms"] = queued_ms(rays, 20)
        out["rays_ms_with_launch"] = cuda_ms(rays, 20)
        out["rays_plain_ms"] = cuda_ms(
            lambda: gut.pixel_world_rays(*ray_args, **ray_kw, impl="plain"), 3, warmup=1)
        out["pixels"] = gw * gh * tile * tile
    torch.cuda.synchronize()
    return out

def train_setup(params, focal, dev, cam_params=None, sh_degree=3):
    """bench.py's training workload on `dev`: a fresh TrainState of the scene, the target
    image, the camera, and the plan sized from a probe step as bench.py:90-112 sizes it
    (tile 32, chunk 256, bf16 pack). With `cam_params` it is the GUT workload: the same
    scene through that camera model (`StepConfig(gut=True)`, tile 32, chunk 128, float32
    features). -> (ts0, target, cam, bg, plan, step kwargs)"""
    import torch

    from tpu_splat_torch.convert import splat_from_numpy
    from tpu_splat_torch.ops.gut import rasterize_gut
    from tpu_splat_torch.ops.rasterize import rasterize
    from tpu_splat_torch.training.train_step import (RasterPlan, StepConfig,
                                                     init_train_state, train_step)

    gut = cam_params is not None
    chunk = CHUNK_GUT if gut else CHUNK_T
    n = params["means"].shape[0]
    cam = (np.eye(4, dtype=np.float32), np.zeros(3, np.float32), focal, focal, WIDTH / 2.0,
           HEIGHT / 2.0)
    bg0 = np.zeros(3, np.float32)
    splat = splat_from_numpy(params, np.ones(n, bool), sh_degree, dev, scene_scale=3.0)
    ts0 = init_train_state(splat, seed=0)
    probe_plan = RasterPlan(max_instances=1 << 22, k_max=1 << 12, chunk=chunk,
                            tile_size=TILE_T)
    # the target: the port's own render of a perturbed copy of the scene, so the loss can
    # fall (opacity logits + 1, sh0 * 0.5 + 0.3, as tests/test_mcmc.py does)
    render = (functools.partial(rasterize_gut, cam_params=cam_params) if gut
              else functools.partial(rasterize, chunk=chunk))
    with torch.no_grad():
        target = render(
            splat.means, splat.scaling_raw, splat.rotation_raw, splat.opacity_raw + 1.0,
            splat.sh0 * 0.5 + 0.3, splat.shN, splat.alive, *cam, 0, bg0, width=WIDTH,
            height=HEIGHT, max_instances=probe_plan.max_instances, k_max=probe_plan.k_max,
            tile_size=TILE_T, device=dev).image
    opt = StepConfig(gut=True, cam_params=cam_params) if gut else StepConfig()
    step_kw = dict(width=WIDTH, height=HEIGHT, opt=opt, total_iterations=30_000)
    _, probe = train_step(ts0, target, *cam, bg0, 0, plan=probe_plan, **step_kw)
    total, ktile = int(probe.total_instances), int(probe.max_tile_count)
    require(0 < total <= probe_plan.max_instances and 0 < ktile <= probe_plan.k_max,
            ("probe overflow", total, ktile))

    def bucket(v, steps=16):  # bench.py:101-109
        v = max(v, 256)
        p2 = 1 << int(np.floor(np.log2(v)))
        for i in range(steps + 1):
            if p2 * (1.0 + i / steps) >= v:
                return int((p2 * (1.0 + i / steps) + 127) // 128) * 128
        return 2 * p2

    plan = RasterPlan(max_instances=bucket(int(total * 1.1)), k_max=bucket(int(ktile * 1.2), 4),
                      chunk=chunk, tile_size=TILE_T, pack_bf16=not gut)
    return ts0, target, cam, bg0, plan, step_kw


def frame_blend_inputs(state, focal, dev):
    """K2's inputs at the render frame (`render_view`'s plan: tile 16, chunk 128, f32
    layout) for `state` seen by the identity camera. -> (proj, inst, (flat, seg_start,
    count), kw)"""
    import torch

    from tpu_splat_torch.ops.cuda.raster import build_sorted_instances, feature_table
    from tpu_splat_torch.ops.projection import project
    from tpu_splat_torch.ops.rasterize import blend_inputs
    from tpu_splat_torch.render import max_instances_for

    gw, gh = -(-WIDTH // TILE_F), -(-HEIGHT // TILE_F)
    with torch.no_grad():
        proj = project(state.means, state.scaling_raw, state.rotation_raw, state.opacity_raw,
                       state.sh0, state.shN, state.alive, torch.eye(4, device=dev),
                       torch.zeros(3, device=dev), focal, focal, WIDTH / 2.0, HEIGHT / 2.0,
                       WIDTH, HEIGHT, 3, tile_size=TILE_F)
        inst = build_sorted_instances(proj, gw, gh, max_instances_for(state.means.shape[0]),
                                      TILE_F)
        flat, seg, cnt, max_chunks = blend_inputs(inst, feature_table(proj), k_max=K_MAX_F,
                                                  chunk=CHUNK_F)
    kw = dict(n_tiles=gw * gh, grid_w=gw, tile_size=TILE_F, max_chunks=max_chunks,
              chunk=CHUNK_F)
    return proj, inst, (flat, seg, cnt), kw


def train_blend_inputs(sp, cam, plan, dev):
    """K2-bf16's and K3's inputs at the train step (tile 32, chunk 256, bf16 pack, SH degree
    0) for the splat `sp` seen by `cam`, and a random `gout` of the loss's scale.
    -> (inst, (flat, seg_start, count), gout, kw)"""
    import torch

    from tpu_splat_torch.ops.cuda.raster import build_sorted_instances, feature_table
    from tpu_splat_torch.ops.projection import project
    from tpu_splat_torch.ops.rasterize import blend_inputs

    gw, gh = -(-WIDTH // TILE_T), -(-HEIGHT // TILE_T)
    with torch.no_grad():
        proj = project(sp.means, sp.scaling_raw, sp.rotation_raw, sp.opacity_raw, sp.sh0,
                       sp.shN, sp.alive, torch.as_tensor(cam[0], device=dev),
                       torch.zeros(3, device=dev), *cam[2:], WIDTH, HEIGHT, 0, tile_size=TILE_T)
        inst = build_sorted_instances(proj, gw, gh, plan.max_instances, TILE_T)
        flat, seg, cnt, max_chunks = blend_inputs(inst, feature_table(proj), k_max=plan.k_max,
                                                  chunk=CHUNK_T, pack_bf16=True)
    kw = dict(n_tiles=gw * gh, grid_w=gw, tile_size=TILE_T, max_chunks=max_chunks,
              chunk=CHUNK_T)
    gout = torch.randn((gw * gh, TILE_T * TILE_T, 8), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(8)) / (3 * WIDTH * HEIGHT)
    return inst, (flat, seg, cnt), gout, kw


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of bytes over its memory rate and
    operations over its FP32 rate, and which of the two it is."""
    by_bytes, by_ops = n_bytes / PEAK_BYTES_S * 1e3, n_ops / PEAK_F32_S * 1e3
    return max(by_bytes, by_ops), "operations" if by_ops >= by_bytes else "bytes"


def check_prefix(got, want, rows, rank, label: str, cols=None) -> float:
    """K7 tolerance: rtol 1e-5 plus 1e-5 of the prefix of the rows' absolute values over
    the same run (plus 1e-35 below float32's normal range): a shuffle tree and a fold of
    block aggregates against masked shifted adds, only the order of float32 adds differs.
    A run head holds its own row exactly. -> max abs error."""
    import torch

    from tpu_splat_torch.ops.cuda.raster import segred_prefix_plain

    magnitude = segred_prefix_plain(rows.abs(), rank, cols)
    if cols is not None:
        rows = rows.index_select(1, cols)
    excess = (got - want).abs() - (1e-5 * want.abs() + 1e-5 * magnitude + 1e-35)
    worst = int(excess.argmax())
    require(bool((excess <= 0).all()),
            f"{label}: {int((excess > 0).sum())} prefixes out of tolerance, worst got "
            f"{float(got.flatten()[worst])!r} want {float(want.flatten()[worst])!r} "
            f"magnitude {float(magnitude.flatten()[worst])!r}")
    head = torch.ones_like(rank, dtype=torch.bool)
    head[1:] = rank[1:] != rank[:-1]
    require(torch.equal(got[:, head], rows[:, head]), f"{label}: a run head differs")
    return max_err(got, want)


def segsum_step_kernel(gflat, inst, label: str) -> dict:
    """K4 at a train step's own inputs: the blend backward's tile-sorted rows `gflat` read
    through `inst.emis_col`. Against the plain version; bit-equal on runs of at most 64
    slots to the plain version and to the gather followed by K4; the same bits on two
    launches. Times the kernel, the plain version, the path it replaces (`emission_order`
    and this tree's K4 on the gathered rows) and the library yardstick: the faster of two
    single `index_add_` calls over the tile-sorted rows by `sorted_gid`, into dim 1 of the
    [F, N] sums or into dim 0 of [N, F] from the rows' transpose. -> its numbers."""
    import torch

    from tpu_splat_torch.ops.cuda.raster import (emission_order, rows_per_pass,
                                                 segsum_emission, segsum_emission_plain)

    f, n, dev = gflat.shape[0], inst.emis_start.shape[0], gflat.device
    start, end, cols = inst.emis_start, inst.emis_end, inst.emis_col
    k4_in = (gflat, start, end, cols)
    k4 = segsum_emission(*k4_in)
    k4_plain = segsum_emission_plain(*k4_in)
    err = check_segsum(k4, k4_plain, gflat, start, end, label, cols=cols)
    require(torch.equal(segsum_emission(*k4_in), k4), f"{label}: two launches differ")

    def gather_path():
        return segsum_emission(emission_order(gflat, inst.sorted_emis), start, end)

    n_short = check_segsum_bits(k4, {"the plain version": k4_plain,
                                     "the gather + K4": gather_path()}, start, end, label)
    gid, gflat_t = inst.sorted_gid.long(), gflat.t()
    forms = {
        "index_add_ dim 1": lambda: torch.zeros((f, n), device=dev).index_add_(1, gid, gflat),
        "index_add_ dim 0 of the transpose":
            lambda: torch.zeros((n, f), device=dev).index_add_(0, gid, gflat_t),
    }
    lib_ms = {}
    for name, fn in forms.items():
        got = fn()
        check_segsum(got if got.shape[0] == f else got.t(), k4_plain, gflat, start, end,
                     f"{label}: library yardstick, {name}", cols=cols)
        lib_ms[name] = cuda_ms(fn, 20)
    form = min(lib_ms, key=lib_ms.get)
    n_slots = int(inst.total_instances)
    return dict(max_abs_err=err, ms=cuda_ms(lambda: segsum_emission(*k4_in), 20),
                plain_ms=cuda_ms(lambda: segsum_emission_plain(*k4_in), 5),
                gather_path_ms=cuda_ms(gather_path, 20), library_ms=lib_ms[form],
                library_form=form, library_forms_ms=lib_ms, short_runs_bit_equal=n_short,
                rows_per_pass=rows_per_pass(gflat, cols), slots=n_slots,
                bytes=(4 * f + 4) * n_slots + (4 * f + 8) * n,
                sector_bytes=32 * f * n_slots, ops=f * n_slots)


def prefix_step_kernel(gflat, inst, label: str) -> dict:
    """K7 at a train step's own inputs, through `inst.emis_col`, against its plain
    version; the same bits on two launches. Times the kernel, the plain version and the
    path it replaces (`emission_order` and this tree's K7 on the gathered rows). No single
    PyTorch call computes a segmented prefix. -> its numbers."""
    import torch

    from tpu_splat_torch.ops.cuda.raster import (emission_order, rows_per_pass,
                                                 segred_prefix, segred_prefix_plain)

    f, m = gflat.shape[0], inst.emis_rank.shape[0]
    k7_in = (gflat, inst.emis_rank, inst.emis_col)
    k7 = segred_prefix(*k7_in)
    err = check_prefix(k7, segred_prefix_plain(*k7_in), gflat, inst.emis_rank, label,
                       cols=inst.emis_col)
    require(torch.equal(segred_prefix(*k7_in), k7), f"{label}: two launches differ")

    def gather_path():
        return segred_prefix(emission_order(gflat, inst.sorted_emis), inst.emis_rank)

    return dict(max_abs_err=err, ms=cuda_ms(lambda: segred_prefix(*k7_in), 20),
                plain_ms=cuda_ms(lambda: segred_prefix_plain(*k7_in), 3),
                gather_path_ms=cuda_ms(gather_path, 20), library_ms=None,
                rows_per_pass=rows_per_pass(gflat, inst.emis_col), slots=m,
                bytes=2 * 4 * f * m + 8 * m, sector_bytes=32 * f * m, ops=f * m)


def kernel_entry(name: str, source: str, replaces: str, shapes: str, launches: int,
                 k: dict) -> dict:
    """A `kernels` line entry from a kernel's measured numbers `k` (max_abs_err, ms,
    plain_ms, library_ms, bytes, ops); bound_ms from this run's bytes and operations."""
    b_ms, b_by = bound_ms(k["bytes"], k["ops"])
    extra = {key: v for key, v in k.items()
             if key not in ("max_abs_err", "ms", "plain_ms", "library_ms")}
    return dict(name=name, route="cuda", source=f"tpu_splat_torch/csrc/{source}",
                shapes=shapes, replaces=f"tpu_splat/ops/pallas/{replaces}", launches=launches,
                max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
                bound_ms=b_ms, bound_by=b_by, library_ms=k["library_ms"], **extra)


def check_gut_kernels(args, kw, label: str, seed: int = 3):
    """K5 and K6 against their plain versions on one input: K5's out and chk (`check_blend`),
    its stop decisions and pair counts (`check_gut_stops`); K6 within `check_blend_bwd`'s
    tolerance of its plain version for a random `gout`, and the same bits on two launches.
    -> (K5 max abs error, K6 relative error, pair counts)"""
    import torch

    from tpu_splat_torch.ops.cuda.gut_kernels import (gut_blend_backward,
                                                      gut_blend_backward_plain,
                                                      gut_blend_forward,
                                                      gut_blend_forward_plain)

    dev = args[0].device
    fwd = gut_blend_forward(*args, **kw)
    fwd_plain = gut_blend_forward_plain(*args, **kw)
    torch.cuda.synchronize()
    k5_err = check_blend(fwd, fwd_plain, f"{label} K5")
    pairs = check_gut_stops(fwd[1], fwd_plain[1], args, kw, f"{label} K5")
    gout = 0.3 * torch.randn(fwd[0].shape, device=dev,
                             generator=torch.Generator(device=dev).manual_seed(seed))
    owned = torch.zeros(args[0].shape[1], dtype=torch.bool, device=dev)
    for s0, c in zip(args[2].tolist(), args[3].tolist()):
        owned[s0:s0 + c] = True
    bwd = (*args, fwd[1], fwd[0], gout)
    gflat = gut_blend_backward(*bwd, **kw)
    gflat_plain = gut_blend_backward_plain(*bwd, **kw)
    torch.cuda.synchronize()
    k6_err = check_blend_bwd(gflat, gflat_plain, owned, f"{label} K6")
    check_blend_bwd_repeats(gut_blend_backward, *bwd, label=f"{label} K6", **kw)
    return k5_err, k6_err, pairs


def gut_kernel_inputs(sp, cam, cam_params, *, width, height, tile_size, max_instances,
                      k_max, sh_degree, dev):
    """K5's and K6's inputs for the splat `sp` seen by `cam` through `cam_params` (global
    shutter), as `rasterize_gut` builds them (chunk 128). -> (inst, (flat, rays, seg_start,
    count), kw)"""
    import torch

    from tpu_splat_torch.ops.cameras import fisheye_max_angle
    from tpu_splat_torch.ops.cuda.gut_kernels import gut_blend_inputs
    from tpu_splat_torch.ops.cuda.raster import build_sorted_instances
    from tpu_splat_torch.ops.gut import gut_feature_table, pixel_world_rays, ut_project

    gw, gh = -(-width // tile_size), -(-height // tile_size)
    w2c, pos = torch.as_tensor(cam[0], device=dev), torch.as_tensor(cam[1], device=dev)
    max_angle = fisheye_max_angle(cam_params) if cam_params.model == "fisheye" else None
    with torch.no_grad():
        proj, comp = ut_project(sp.means, sp.scaling_raw, sp.rotation_raw, sp.opacity_raw,
                                sp.alive, w2c, *cam[2:], cam_params, width, height, tile_size,
                                max_angle)
        inst = build_sorted_instances(proj, gw, gh, max_instances, tile_size)
        rays = pixel_world_rays(w2c, pos, *cam[2:], cam_params, max_angle, None, grid_w=gw,
                                grid_h=gh, tile_size=tile_size, width=width, height=height)
        gtab = gut_feature_table(sp.means, sp.scaling_raw, sp.rotation_raw, sp.opacity_raw,
                                 sp.sh0, sp.shN, pos, sh_degree, proj, comp)
        flat, seg, cnt, max_chunks = gut_blend_inputs(inst, gtab, k_max=k_max, chunk=CHUNK_GUT)
    kw = dict(n_tiles=gw * gh, tile_size=tile_size, max_chunks=max_chunks, chunk=CHUNK_GUT)
    return inst, (flat, rays, seg, cnt), kw


def gut_phases(params, focal, dev, counted, kernels) -> dict:
    """The GUT camera path on the card: frames of three camera models through the kernels
    against the plain versions, gradients under both reduction lanes, GUT train steps with
    the launch counts read around them, K5/K6/K7 and 17-row K4 against their plain versions
    at the train frame's shapes, and their times. Appends the kernels' entries to `kernels`;
    -> the `gut` result line."""
    import torch

    from tpu_splat_torch.ops.cameras import CameraParams
    from tpu_splat_torch.ops.cuda.gut_kernels import (gut_blend_backward,
                                                      gut_blend_backward_plain,
                                                      gut_blend_forward,
                                                      gut_blend_forward_plain,
                                                      gut_blend_inputs)
    from tpu_splat_torch.ops.cuda import build, raster
    from tpu_splat_torch.ops.cuda.raster import build_sorted_instances, segmented_grad_reduce
    from tpu_splat_torch.ops.gut import (gut_feature_table, pixel_world_rays, rasterize_gut,
                                         ut_project)
    from tpu_splat_torch.ops.rasterize import compose_output
    from tpu_splat_torch.training import strategy_mcmc
    from tpu_splat_torch.training.losses import photometric_loss, regularization_losses
    from tpu_splat_torch.training.optim import adam_step, group_lrs, means_lr_at
    from tpu_splat_torch.training.train_step import train_step

    cam_params = CameraParams(radial=(0.05, 0.0, 0.0, 0.0, 0.0, 0.0))
    ts0, target, cam, bg0, plan, step_kw = train_setup(params, focal, dev, cam_params)
    sp0 = ts0.splat
    names = ("means", "scaling_raw", "rotation_raw", "opacity_raw", "sh0", "shN")
    scene = lambda sp: tuple(getattr(sp, k) for k in names) + (sp.alive,)
    ras_kw = dict(width=WIDTH, height=HEIGHT, max_instances=plan.max_instances,
                  k_max=plan.k_max, tile_size=TILE_T, device=dev)

    # -- the GUT frame through the kernels against the plain versions
    def frame_pair(label, sp_args, cam_args, kw, **extra):
        with torch.no_grad():
            out_k = rasterize_gut(*sp_args, *cam_args, 3, bg0, impl="kernel", **kw, **extra)
            out_p = rasterize_gut(*sp_args, *cam_args, 3, bg0, impl="plain", **kw, **extra)
        torch.cuda.synchronize()
        aux = {k: int(getattr(out_k.aux, k)) for k in ("total_instances", "max_tile_count",
                                                        "n_visible")}
        require(0 < aux["total_instances"] <= kw["max_instances"]
                and 0 < aux["max_tile_count"] <= kw["k_max"], (label, aux))
        require(bool(torch.isfinite(out_k.image).all()), f"{label}: non-finite image")
        errs = dict(image=max_err(out_k.image, out_p.image),
                    alpha=max_err(out_k.alpha, out_p.alpha))
        require(errs["image"] <= 1e-4 and errs["alpha"] <= 1e-4, (label, errs))
        require(0.05 < float(out_k.alpha.mean()) < 1.0, f"{label}: empty frame")
        return aux, errs

    frame_aux, frame_err = frame_pair("gut frame", scene(sp0), cam, ras_kw,
                                      cam_params=cam_params)
    # a fisheye frame (tile 16, rays 4 wide) and a rolling-shutter frame (tile 32, rays 8
    # wide: per-pixel origins) of the same scene at half the size
    half = dict(ras_kw, width=WIDTH // 2, height=HEIGHT // 2, max_instances=1 << 22,
                k_max=1 << 13)
    half_cam = (cam[0], cam[1], focal / 2, focal / 2, WIDTH / 4.0, HEIGHT / 4.0)
    fish_aux, fish_err = frame_pair(
        "fisheye frame", scene(sp0), half_cam, dict(half, tile_size=16),
        cam_params=CameraParams(model="fisheye", radial=(0.05, -0.01, 0.0, 0.0, 0.0, 0.0)))
    q_end = np.asarray([1.0, 0.002, -0.003, 0.001], np.float32)
    pose = (np.asarray([1.0, 0, 0, 0], np.float32), np.zeros(3, np.float32),
            q_end / np.linalg.norm(q_end), np.asarray([0.05, -0.02, 0.0], np.float32))
    roll_aux, roll_err = frame_pair(
        "rolling-shutter frame", scene(sp0), half_cam, half,
        cam_params=dataclasses.replace(cam_params, shutter="top_to_bottom"),
        shutter_pose=pose)
    phase("gut-frames", frame=dict(frame_aux, **frame_err), fisheye=dict(fish_aux, **fish_err),
          rolling=dict(roll_aux, **roll_err))

    # -- K5 and K6 at the GUT frame's own inputs (SH degree 3) and at the fisheye frame's
    # (tile 16): kernels against plain versions, stop decisions and pair counts
    fish_params = CameraParams(model="fisheye", radial=(0.05, -0.01, 0.0, 0.0, 0.0, 0.0))
    frame_k = {}
    for label, cam_args, cparams, kw in (("frame", cam, cam_params, ras_kw),
                                         ("fisheye", half_cam, fish_params,
                                          dict(half, tile_size=16))):
        _, args, kkw = gut_kernel_inputs(
            sp0, cam_args, cparams, width=kw["width"], height=kw["height"],
            tile_size=kw["tile_size"], max_instances=kw["max_instances"], k_max=kw["k_max"],
            sh_degree=3, dev=dev)
        k5_err, k6_err, pairs = check_gut_kernels(args, kkw, f"GUT {label}")
        frame_k[label] = dict(k5_max_abs_err=k5_err, k6_rel_err=k6_err, pairs=pairs)
        del args
    phase("gut-frame-kernels", **frame_k)
    torch.cuda.empty_cache()

    # -- the main path of this slice: GUT train steps, launches counted
    for fn in counted:
        fn.launches = 0
    ts, stats, step_wall = ts0, [], []
    with calls_counted(raster, "emission_order") as gathers:
        for i in range(GUT_STEPS):
            lane = "prefix" if i >= GUT_STEPS - GUT_PREFIX_STEPS else "segsum"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ts, st = train_step(ts, target, *cam, bg0, 0, plan=plan, segred_impl=lane,
                                **step_kw)
            torch.cuda.synchronize()
            step_wall.append((time.perf_counter() - t0) * 1e3)
            stats.append(st)
    require(gathers[0] == 0, "a GUT train step gathered its gradient rows to emission order")
    launches = {fn.__name__: fn.launches for fn in counted}
    losses = [float(st.loss) for st in stats]
    totals = [int(st.total_instances) for st in stats]
    ktiles = [int(st.max_tile_count) for st in stats]
    require(all(launches[k] == GUT_STEPS for k in ("expand_emission", "gut_blend_forward",
                                                   "gut_blend_backward")),
            f"K1, K5 and K6 must launch once a step: {launches}")
    require(launches["segred_prefix"] == GUT_PREFIX_STEPS
            and launches["segsum_emission"] == GUT_STEPS - GUT_PREFIX_STEPS,
            f"K4 or K7 must launch once a step: {launches}")
    require(launches["blend_forward"] == 0 and launches["blend_backward"] == 0, launches)
    require(all(launches[k] == GUT_STEPS for k in ("ut_project_kernel",
                                                   "pixel_world_rays_kernel")),
            f"the UT projection and world-ray kernels must launch once a step: {launches}")
    require(max(totals) <= plan.max_instances and max(ktiles) <= plan.k_max,
            ("overflow", max(totals), max(ktiles), plan))
    require(all(math.isfinite(v) for v in losses), "non-finite loss")
    for k, v in ts.splat.params().items():
        require(bool(torch.isfinite(v).all()), f"non-finite {k}")
    first5, last5 = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    require(last5 < first5, f"the GUT loss did not fall: {first5} -> {last5}")
    phase("gut-train", steps=GUT_STEPS, launches=launches, plan=dataclasses.asdict(plan),
          total_instances=max(totals), max_tile_count=max(ktiles),
          n_visible=int(stats[-1].n_visible), loss_first5=first5, loss_last5=last5)
    del stats

    # -- the UT projection and world-ray kernels against their plain chains on the scene in
    # 2^20 slots (the cell's capacity), through every camera model; their times at the
    # cell's camera
    proj_k = gut_projection_phase(padded_splat(params, 1 << 20, dev), focal, dev)
    phase("gut-projection-kernels", **proj_k)
    torch.cuda.empty_cache()

    # -- gradients of rasterize_gut: kernels against plain versions under both reduction
    # lanes, and the lanes against each other, at the train shapes on the trained state
    weight = torch.rand((3, HEIGHT, WIDTH), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(7))

    def gut_grads(impl, lane):
        leaves = [getattr(ts.splat, k).detach().requires_grad_(True) for k in names]
        img = rasterize_gut(*leaves, ts.splat.alive, *cam, 3, bg0, cam_params=cam_params,
                            impl=impl, segred_impl=lane, **ras_kw).image
        return img.detach(), torch.autograd.grad((img * weight).sum(), leaves)

    runs = {(impl, lane): gut_grads(impl, lane) for impl in ("kernel", "plain")
            for lane in ("segsum", "prefix")}
    torch.cuda.synchronize()
    grad_err = {}
    for label, a, b in (("segsum", ("kernel", "segsum"), ("plain", "segsum")),
                        ("prefix", ("kernel", "prefix"), ("plain", "prefix")),
                        ("lanes", ("kernel", "segsum"), ("kernel", "prefix"))):
        grad_err[label] = {}
        for k, ga, gb in zip(names, runs[a][1], runs[b][1]):
            scale = float(gb.abs().max())
            grad_err[label][k] = max_err(ga, gb) / max(scale, 1e-30)
            require(scale > 0 and grad_err[label][k] <= 1e-3,
                    f"GUT gradient of {k} ({label}): {grad_err[label][k]} of {scale}")
        require(max_err(runs[a][0], runs[b][0]) <= 1e-4, f"GUT image differs ({label})")
    phase("gut-gradient-parity", rel_err=grad_err)
    del runs, weight
    torch.cuda.empty_cache()

    # -- K5, K6, K7 and 17-row K4 against their plain versions on the step's own inputs
    gw, gh = -(-WIDTH // TILE_T), -(-HEIGHT // TILE_T)
    n_tiles = gw * gh
    sp = ts.splat
    w2c_t, pos_t = torch.as_tensor(cam[0], device=dev), torch.zeros(3, device=dev)
    intr = cam[2:]
    ray_kw = dict(grid_w=gw, grid_h=gh, tile_size=TILE_T, width=WIDTH, height=HEIGHT)
    inst, (flat, rays, seg, cnt), kkw = gut_kernel_inputs(
        sp, cam, cam_params, width=WIDTH, height=HEIGHT, tile_size=TILE_T,
        max_instances=plan.max_instances, k_max=plan.k_max, sh_degree=0, dev=dev)
    maxc = kkw["max_chunks"]
    k5 = gut_blend_forward(flat, rays, seg, cnt, **kkw)
    k5_plain = gut_blend_forward_plain(flat, rays, seg, cnt, **kkw)
    k5_err = check_blend(k5, k5_plain, "K5 train frame")
    pairs = check_gut_stops(k5[1], k5_plain[1], (flat, rays, seg, cnt), kkw, "K5 train frame")
    gout = torch.randn(k5[0].shape, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(8)) / (3 * WIDTH * HEIGHT)
    bwd = (flat, rays, seg, cnt, k5[1], k5[0], gout)
    k6 = gut_blend_backward(*bwd, **kkw)
    k6_plain = gut_blend_backward_plain(*bwd, **kkw)
    n_valid = int(cnt.sum())
    # the UT projection's threshold is +inf: every tile of a Gaussian's rect is an instance
    require(n_valid == int(inst.total_instances), ("a GUT rect tile was culled", n_valid))
    owned = torch.arange(flat.shape[1], device=dev) < n_valid  # segments lie back to back
    k6_err = check_blend_bwd(k6, k6_plain, owned, "K6 train frame")
    check_blend_bwd_repeats(gut_blend_backward, *bwd, label="K6 train frame", **kkw)
    torch.cuda.synchronize()

    k5_ms = cuda_ms(lambda: gut_blend_forward(flat, rays, seg, cnt, **kkw), 10)
    k5_plain_ms = cuda_ms(lambda: gut_blend_forward_plain(flat, rays, seg, cnt, **kkw), 2,
                          warmup=1)
    k6_ms = cuda_ms(lambda: gut_blend_backward(*bwd, **kkw), 10)
    k6_plain_ms = cuda_ms(lambda: gut_blend_backward_plain(*bwd, **kkw), 2, warmup=1)
    k4 = segsum_step_kernel(k6, inst, "K4 17 rows, GUT train frame")
    k7 = prefix_step_kernel(k6, inst, "K7 GUT train frame")
    n_gauss = sp.means.shape[0]
    n_slots, m = int(inst.total_instances), k6.shape[1]
    tp = n_tiles * TILE_T * TILE_T
    k5_bytes = 68 * n_valid + 8 * n_tiles + 16 * tp + 4 * tp * (8 + maxc)
    k6_bytes = 68 * n_valid + 8 * n_tiles + 16 * tp + 4 * tp * (16 + maxc) + 68 * n_valid
    k5_ops = K5_OPS_PER_PAIR * (pairs["used"] + pairs["stops"])
    k6_ops = k5_ops + K6_OPS_PER_USED_PAIR * pairs["used"]
    shapes = f"GUT train step, tile 32, chunk {CHUNK_GUT}, rays 4 wide"
    regs = {name: ptxas_summary(build.build_log(name)) for name in ("gut_fwd", "gut_bwd")}
    for name, source, replaces, fn_name, err, ms, plain_ms, (b_ms, b_by), lib in (
        ("gut_fwd", "gut_fwd.cu", "gut_kernels.py:108", "gut_blend_forward", k5_err, k5_ms,
         k5_plain_ms, bound_ms(k5_bytes, k5_ops), None),
        ("gut_bwd", "gut_bwd.cu", "gut_kernels.py:243", "gut_blend_backward", k6_err, k6_ms,
         k6_plain_ms, bound_ms(k6_bytes, k6_ops), None),
    ):
        kernels.append(dict(
            name=name, route="cuda", source=f"tpu_splat_torch/csrc/{source}", shapes=shapes,
            replaces=f"tpu_splat/ops/pallas/{replaces}", launches=launches[fn_name],
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib))
        kernels[-1].update(pairs=pairs, ptxas=regs[name])
    for name, source, replaces, fn_name, k in (
        ("segprefix", "segprefix.cu", "raster.py:454", "segred_prefix", k7),
        ("segsum_17", "segsum.cu", "raster.py:693", "segsum_emission", k4),
    ):
        kernels.append(kernel_entry(name, source, replaces,
                                    f"{shapes}: K6's tile-sorted rows through emis_col",
                                    launches[fn_name], k))
    # the UT projection and the world rays: their largest gaps to the plain chains over
    # every case, their times and bounds at the GUT cell's camera and tile
    n_slots_p, n_pix = proj_k["slots"], proj_k["pixels"]
    for name, replaces, fn_name, part, n_bytes, n_ops, unit in (
        ("gut_project", "gut.py:56", "ut_project_kernel", "ut_project",
         GUT_PROJECT_BYTES_PER_SLOT * n_slots_p, GUT_PROJECT_OPS_PER_SLOT * n_slots_p,
         f"{n_slots_p} slots"),
        ("gut_rays", "gut.py:332", "pixel_world_rays_kernel", "rays",
         GUT_RAYS_BYTES_PER_PIXEL * n_pix, GUT_RAYS_OPS_PER_PIXEL * n_pix,
         f"{n_pix} pixels"),
    ):
        errs = [v["max_abs"] if part == "rays" else max(f["max_abs"] for f in v.values()
                                                         if isinstance(f, dict))
                for case in proj_k["cases"].values() for key, v in case.items()
                if key.startswith("rays" if part == "rays" else "projection")]
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        kernels.append(dict(
            name=name, route="cuda", source="tpu_splat_torch/csrc/gut_project.cu",
            shapes=f"GUT train step: {unit}, {WIDTH}x{HEIGHT}, OPENCV bound to a device "
                   "tensor, tile 16", replaces=f"tpu_splat/ops/{replaces}",
            launches=launches[fn_name], max_abs_err=max(errs), ms=proj_k[f"{part}_ms"],
            plain_ms=proj_k[f"{part}_plain_ms"], bound_ms=b_ms, bound_by=b_by,
            library_ms=None, bytes=n_bytes, ops=n_ops,
            ms_with_launch=proj_k[f"{part}_ms_with_launch"]))
    # the bounds of a kernel without a cull, which evaluates every walked pair
    walked_bound_ms = dict(gut_fwd=bound_ms(k5_bytes, K5_OPS_PER_PAIR * pairs["walked"])[0],
                           gut_bwd=bound_ms(k6_bytes, K5_OPS_PER_PAIR * pairs["walked"]
                                            + K6_OPS_PER_USED_PAIR * pairs["used"])[0])
    phase("gut-kernel-times", k5_bytes=k5_bytes, k6_bytes=k6_bytes, k5_ops=k5_ops,
          k6_ops=k6_ops, walked_bound_ms=walked_bound_ms,
          pairs=pairs, tile_instances=n_valid, emission_slots=n_slots, slots=m,
          k6_rel_err=k6_err, k7=k7, k4_17=k4)
    del k5, k5_plain, k6, k6_plain, bwd, gout, flat
    torch.cuda.empty_cache()

    # -- the GUT frame's time (no gradient) and the step's split: the stages of
    # train_step, each between two CUDA events
    frame_ms = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            rasterize_gut(*scene(sp), *cam, 0, bg0, cam_params=cam_params, **ras_kw)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    stage_names = ("ut_project", "instances", "rays", "features", "gather", "gut_fwd", "loss",
                   "gut_bwd", "segsum", "features_bwd", "adam", "noise")
    split = {k: [] for k in stage_names}
    cfg = step_kw["opt"]
    lrs = dict(group_lrs(cfg, sp.scene_scale))
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(stage_names) + 1)]
        leaves = {k: v.detach().requires_grad_(True) for k, v in sp.params().items()}
        ev[0].record()
        pr, cp = ut_project(sp.means, sp.scaling_raw, sp.rotation_raw, sp.opacity_raw, sp.alive,
                            w2c_t, *intr, cam_params, WIDTH, HEIGHT, TILE_T, None)
        ev[1].record()
        with torch.no_grad():
            si = build_sorted_instances(pr, gw, gh, plan.max_instances, TILE_T)
        ev[2].record()
        ry = pixel_world_rays(w2c_t, pos_t, *intr, cam_params, None, None, **ray_kw)
        ev[3].record()
        gt = gut_feature_table(leaves["means"], leaves["scaling_raw"], leaves["rotation_raw"],
                               leaves["opacity_raw"], leaves["sh0"], leaves["shN"], pos_t, 0,
                               pr, cp)
        ev[4].record()
        with torch.no_grad():
            fl, sg, ct, _ = gut_blend_inputs(si, gt, k_max=plan.k_max, chunk=CHUNK_GUT)
            ev[5].record()
            o, c = gut_blend_forward(fl, ry, sg, ct, **kkw)
        ev[6].record()
        o_leaf = o.detach().requires_grad_(True)
        image, _, _ = compose_output(o_leaf[:, :, 0:3], 1.0 - o_leaf[:, :, 3], o_leaf[:, :, 4],
                                     torch.zeros(3, device=dev), grid_w=gw, grid_h=gh,
                                     tile_size=TILE_T, width=WIDTH, height=HEIGHT,
                                     render_mode="RGB")
        (go,) = torch.autograd.grad(photometric_loss(image, target, cfg.lambda_dssim), o_leaf)
        ev[7].record()
        gf = gut_blend_backward(fl, ry, sg, ct, c, o, go.contiguous(), **kkw)
        ev[8].record()
        g_gt = segmented_grad_reduce(gf, si, "segsum")
        ev[9].record()
        reg = regularization_losses(leaves, sp.alive, cfg.scale_reg, cfg.opacity_reg)
        grads = torch.autograd.grad([gt, reg], list(leaves.values()),
                                    [g_gt, torch.ones_like(reg)], allow_unused=True)
        grads = {k: torch.zeros_like(leaves[k]) if g is None else g
                 for k, g in zip(leaves, grads)}
        ev[10].record()
        lrs["means"] = means_lr_at(group_lrs(cfg, sp.scene_scale)["means"], ts.iteration - 1,
                                   30_000)
        new_params, _ = adam_step(sp.params(), grads, ts.adam, lrs, ts.iteration)
        ev[11].record()
        strategy_mcmc.inject_noise(sp.replace_params(new_params), lrs["means"],
                                   generator=ts.rng)
        ev[12].record()
        ev[12].synchronize()
        for i, k in enumerate(stage_names):
            split[k].append(ev[i].elapsed_time(ev[i + 1]))
    split_ms = {k: statistics.median(v[1:]) for k, v in split.items()}
    seg_ms = statistics.median(step_wall[3:GUT_STEPS - GUT_PREFIX_STEPS])
    pre_ms = statistics.median(step_wall[GUT_STEPS - GUT_PREFIX_STEPS + 1:])
    return dict(
        camera="pinhole, radial k1 = 0.05", frame_ms=statistics.median(frame_ms[1:]),
        step_ms=seg_ms, steps_per_s=1e3 / seg_ms, step_ms_prefix_lane=pre_ms,
        split_ms=split_ms, split_sum_ms=sum(split_ms.values()), steps=GUT_STEPS,
        prefix_steps=GUT_PREFIX_STEPS, gaussians=n_gauss, width=WIDTH, height=HEIGHT,
        plan=dataclasses.asdict(plan), launches=launches, total_instances=max(totals),
        max_tile_count=max(ktiles), frame=dict(frame_aux, **frame_err),
        fisheye_frame=dict(fish_aux, **fish_err), rolling_frame=dict(roll_aux, **roll_err),
        loss_first=losses[0], loss_last=losses[-1], loss_first5=first5, loss_last5=last5,
        gradient_rel_err=grad_err, step_pairs=pairs, frame_kernels=frame_k, ptxas=regs,
        projection_kernels=proj_k)


def rotation_to_qvec(r: np.ndarray) -> np.ndarray:
    """COLMAP's (w, x, y, z) unit quaternion of a rotation matrix (Shepperd's method)."""
    r = np.asarray(r, np.float64)
    tr = np.trace(r)
    cands = [tr, r[0, 0], r[1, 1], r[2, 2]]
    i = int(np.argmax(cands))
    if i == 0:
        s = 2.0 * math.sqrt(1.0 + tr)
        q = [0.25 * s, (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s, (r[1, 0] - r[0, 1]) / s]
    else:
        j, k = (i % 3) + 1, ((i + 1) % 3) + 1
        a, b, c = i - 1, j - 1, k - 1
        s = 2.0 * math.sqrt(1.0 + r[a, a] - r[b, b] - r[c, c])
        q = [0.0] * 4
        q[0] = (r[c, b] - r[b, c]) / s
        q[i] = 0.25 * s
        q[j] = (r[b, a] + r[a, b]) / s
        q[k] = (r[c, a] + r[a, c]) / s
    q = np.asarray(q)
    return q / np.linalg.norm(q) * (1.0 if q[0] >= 0 else -1.0)


def write_colmap_model(sparse: Path, views: list[dict], points: np.ndarray,
                       colors_u8: np.ndarray, model: str = "PINHOLE",
                       distortion=(0.0, 0.0, 0.0, 0.0)) -> None:
    """Binary cameras.bin / images.bin / points3D.bin (COLMAP's documented layout), one
    camera per view (dicts of R, T, fx, fy, cx, cy, width, height, name); `model` PINHOLE
    (fx fy cx cy) or OPENCV (+ k1 k2 p1 p2)."""
    sparse.mkdir(parents=True, exist_ok=True)
    with open(sparse / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", len(views)))
        for i, v in enumerate(views):
            intr = (v["fx"], v["fy"], v["cx"], v["cy"])
            if model == "OPENCV":
                f.write(struct.pack("<iiQQ", i + 1, 4, v["width"], v["height"]))
                f.write(struct.pack("<8d", *intr, *distortion))
            else:
                f.write(struct.pack("<iiQQ", i + 1, 1, v["width"], v["height"]))
                f.write(struct.pack("<4d", *intr))
    with open(sparse / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", len(views)))
        for i, v in enumerate(views):
            f.write(struct.pack("<i4d3di", i + 1, *rotation_to_qvec(v["R"]),
                                *v["T"].astype(np.float64), i + 1))
            f.write(v["name"].encode() + b"\x00" + struct.pack("<Q", 0))  # no 2D points
    n = points.shape[0]
    rec = np.zeros(n, np.dtype([("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3),
                                ("err", "<f8"), ("track", "<u8")]))
    rec["id"], rec["xyz"], rec["rgb"], rec["err"] = np.arange(1, n + 1), points, colors_u8, 0.5
    with open(sparse / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", n) + rec.tobytes())  # packed records, empty tracks


def write_capture(root: Path, params, focal, dev) -> dict:
    """A COLMAP capture of the scene written with the port's own code: TRAINER_VIEWS PNGs
    at WIDTH x HEIGHT (encode_png), rendered by the port from small pose perturbations of
    the identity camera the other phases use, and TRAINER_SFM of the scene's means with
    their SH-0 colours as the sparse points; `sparse/0` declares PINHOLE cameras and
    `opencv/sparse/0` (same images) OPENCV with k1 = 0.05. -> what was written"""
    import torch

    from tpu_splat_torch.convert import splat_from_numpy
    from tpu_splat_torch.core.splat import C0
    from tpu_splat_torch.io.image import save_image
    from tpu_splat_torch.ops.rasterize import rasterize
    from tpu_splat_torch.render import max_instances_for

    t0 = time.perf_counter()
    rng = np.random.default_rng(11)
    n = params["means"].shape[0]
    sp = splat_from_numpy(params, np.ones(n, bool), 3, dev)
    (root / "images").mkdir(parents=True)
    views = []
    for i in range(TRAINER_VIEWS):
        ax, ay, az = rng.uniform(-0.03, 0.03, 3)
        c, s_ = np.cos([ax, ay, az]), np.sin([ax, ay, az])
        rx = np.array([[1, 0, 0], [0, c[0], -s_[0]], [0, s_[0], c[0]]])
        ry = np.array([[c[1], 0, s_[1]], [0, 1, 0], [-s_[1], 0, c[1]]])
        rz = np.array([[c[2], -s_[2], 0], [s_[2], c[2], 0], [0, 0, 1]])
        r = (rz @ ry @ rx).astype(np.float32)
        t = rng.uniform(-0.15, 0.15, 3).astype(np.float32)
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3], w2c[:3, 3] = r, t
        with torch.no_grad():
            img = rasterize(sp.means, sp.scaling_raw, sp.rotation_raw, sp.opacity_raw, sp.sh0,
                            sp.shN, sp.alive, w2c, -r.T @ t, focal, focal, WIDTH / 2.0,
                            HEIGHT / 2.0, 3, np.zeros(3, np.float32), width=WIDTH,
                            height=HEIGHT, max_instances=max_instances_for(n), k_max=K_MAX_F,
                            tile_size=TILE_F, chunk=CHUNK_F, device=dev).image
        name = f"view_{i:03d}.png"
        save_image(str(root / "images" / name), img.cpu().numpy())
        views.append(dict(R=r, T=t, fx=focal, fy=focal, cx=WIDTH / 2.0, cy=HEIGHT / 2.0,
                          width=WIDTH, height=HEIGHT, name=name))
    del sp
    pick = rng.choice(n, TRAINER_SFM, replace=False)
    colors = np.clip(0.5 + C0 * params["sh0"][pick, 0], 0.0, 1.0)
    colors_u8 = np.round(colors * 255.0).astype(np.uint8)
    write_colmap_model(root / "sparse" / "0", views, params["means"][pick], colors_u8)
    opencv = root / "opencv"
    opencv.mkdir()
    (opencv / "images").symlink_to(root / "images")
    write_colmap_model(opencv / "sparse" / "0", views, params["means"][pick], colors_u8,
                       model="OPENCV", distortion=(0.05, 0.0, 0.0, 0.0))
    return dict(views=TRAINER_VIEWS, width=WIDTH, height=HEIGHT, sfm_points=TRAINER_SFM,
                png_bytes=sum(p.stat().st_size for p in (root / "images").iterdir()),
                write_s=time.perf_counter() - t0)


def trainer_run(params_kw: dict, data: Path, out: Path, dev, counted, plan=None,
                preset: str | None = None, setup=None, test_every: int = 6):
    """Train through the port's `Trainer` with every launch count set to 0 just before
    `train()` and read just after. `plan`: the initial RasterPlan, in place of the
    Trainer's own; `preset`: an optimization-parameters JSON that `params_kw` overrides;
    `setup(trainer)`: called before the counts are set to 0 (a resume, a checkpoint
    schedule); every `test_every`-th view is held out. -> (trainer, launches, wall seconds
    of train())"""
    import torch

    from tpu_splat_torch.core.config import (DatasetConfig, OptimizationParameters,
                                             TrainingParameters)
    from tpu_splat_torch.training.trainer import Trainer

    opt = (OptimizationParameters.from_file(Path(__file__).resolve().parent / preset)
           if preset else OptimizationParameters())
    tp = TrainingParameters(dataset=DatasetConfig(data_path=str(data), output_path=str(out),
                                                  test_every=test_every),
                            optimization=dataclasses.replace(opt, **params_kw))
    t = Trainer(tp, device=dev)
    t.initial_plan = t.plan
    if plan is not None:
        t.plan = plan
    if setup is not None:
        setup(t)
    t.n_alive_at_start = int(t.state.splat.n_alive())
    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    t.train(progress_every=10_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return t, {fn.__name__: fn.launches for fn in counted}, wall


def trainer_summary(t, launches: dict, wall: float) -> dict:
    iters = len(t._loss_hist)
    loop = wall - t.timings["eval"] - t.timings["save"]
    return dict(iterations=iters, wall_s=wall, it_per_s=iters / wall,
                it_per_s_without_eval_and_save=iters / loop,
                split_s=dict(t.timings), initial_plan=dataclasses.asdict(t.initial_plan),
                plan=dataclasses.asdict(t.plan), plan_history=t.plan_history,
                n_redo=t.n_redo, steps_dispatched=t.steps_dispatched,
                eval_renders=t.eval_renders, launches=launches,
                n_alive=int(t.state.splat.n_alive()), capacity=t.state.splat.capacity,
                loss_first8=statistics.mean(t._loss_hist[:8]),
                loss_last8=statistics.mean(t._loss_hist[-8:]),
                evals=[dict(iteration=r.iteration, psnr=r.psnr, ssim=r.ssim,
                            num_images=r.num_images, seconds=r.elapsed_s)
                       for r in t.evaluator.results])


def trainer_step_probe(t, reps: int = 6) -> dict:
    """Wall ms of one synchronised step dispatched as the Trainer dispatches it
    (`_dispatch_step`: the sample staged and uploaded, `train_step`) on the trained
    state and plan: alone, and while an `InfiniteDataLoader` over the train split (8
    prefetch threads decoding PNGs) hands it one sample a step. Medians after 2 warm-ups.
    What is not in these, of the Trainer's time a step, is its host loop."""
    import torch

    from tpu_splat_torch.training.dataset import InfiniteDataLoader

    def timed(next_sample):
        times = []
        for i in range(reps + 2):
            sample = next_sample()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t._dispatch_step(sample, t.state.iteration)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times[2:])

    fixed = t.train_dataset.get(0)
    alone = timed(lambda: fixed)
    loader = InfiniteDataLoader(t.train_dataset, num_workers=8, seed=3)
    try:
        with_loader = timed(lambda: next(loader))
    finally:
        loader.close()
    return dict(step_ms_alone=alone, step_ms_beside_loader=with_loader)


def trainer_phases(params, focal, dev, counted) -> dict:
    """The product path: `Trainer.train` on a COLMAP capture the port writes (pinhole,
    with evals, refines and the overflow->redo protocol), the same capture declared OPENCV
    through `--gut`, and `python -m tpu_splat_torch -d ... --headless` in a subprocess.
    -> the `trainer` result line"""
    import torch

    from tpu_splat_torch.io.image import load_image
    from tpu_splat_torch.io.ply import load_splat_ply
    from tpu_splat_torch.training.train_step import RasterPlan
    from tpu_splat_torch.training.trainer import _next_bucket

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        capture = write_capture(root / "capture", params, focal, dev)
        png = sorted((root / "capture" / "images").iterdir())[0]
        decode_ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            img = load_image(png)
            decode_ms.append((time.perf_counter() - t0) * 1e3)
        require(img.shape == (3, HEIGHT, WIDTH), img.shape)
        capture["png_load_ms"] = statistics.median(decode_ms)
        phase("trainer-capture", **capture)
        torch.cuda.empty_cache()

        # -- pinhole: SH degree 3 reached, refines, evals; started from a plan of one slot
        # per SfM point so that the overflow->redo protocol runs at this size
        run_kw = dict(iterations=TRAINER_ITERS, max_cap=1_000_000, sh_degree=3,
                      sh_degree_interval=TRAINER_ITERS // 4, scan_steps=8, refine_every=16,
                      start_refine=16, stop_refine=TRAINER_ITERS - 8, enable_eval=True,
                      eval_steps=[8, TRAINER_ITERS], save_steps=[TRAINER_ITERS],
                      enable_save_eval_images=False, num_workers=8)
        small = RasterPlan(max_instances=_next_bucket(TRAINER_SFM), k_max=1 << 12,
                           chunk=CHUNK_T, tile_size=TILE_T, pack_bf16=True)
        t, launches, wall = trainer_run(run_kw, root / "capture", root / "out", dev, counted,
                                        plan=small)
        pin = trainer_summary(t, launches, wall)
        steps, evals = t.steps_dispatched, t.eval_renders
        require(all(launches[k] == steps + evals for k in ("expand_emission", "blend_forward"))
                and all(launches[k] == steps for k in ("blend_backward", "segsum_emission"))
                and all(launches[k] == 0 for k in NO_PINHOLE_LAUNCH),
                f"K1-K4 must launch once a step (K1, K2 also once an eval render): "
                f"{launches}, {steps} steps, {evals} eval renders")
        require(len(t._loss_hist) == TRAINER_ITERS and steps >= TRAINER_ITERS, pin)
        require(all(math.isfinite(v) for v in t._loss_hist), "non-finite trainer loss")
        require(pin["loss_last8"] < pin["loss_first8"], ("the loss did not fall", pin))
        require(t.plan_history and t.n_redo >= 1, ("no replan or redo", pin))
        require(t.plan.pack_bf16, "the plan lost its bf16 pack on a replan")
        psnrs = [e["psnr"] for e in pin["evals"]]
        require(len(psnrs) == 2 and psnrs[-1] > psnrs[0], ("eval PSNR did not rise", psnrs))
        require(t.opt.sh_degree_interval * 3 <= TRAINER_ITERS, "SH degree 3 not reached")
        back = load_splat_ply(root / "out" / "splat_final.ply")
        require(back["means"].shape[0] == pin["n_alive"] and back["shN"].shape[1] == 15,
                ("splat_final.ply", back["means"].shape, pin["n_alive"]))
        require((root / "out" / "metrics.csv").read_text().count("\n") == 3, "metrics.csv")
        pin.update(trainer_step_probe(t))
        phase("trainer-pinhole", **{k: pin[k] for k in (
            "iterations", "it_per_s", "plan_history", "n_redo", "launches", "evals",
            "step_ms_alone", "step_ms_beside_loader")})
        del t, back
        torch.cuda.empty_cache()

        # -- GUT: the OPENCV declaration of the same capture
        gut_kw = dict(run_kw, iterations=TRAINER_GUT_ITERS, gut=True, enable_eval=False,
                      start_refine=1_000, save_steps=[])
        t, launches, wall = trainer_run(gut_kw, root / "capture" / "opencv", root / "gut", dev,
                                        counted)
        gut = trainer_summary(t, launches, wall)
        steps = t.steps_dispatched
        require(all(launches[k] == steps for k in ("expand_emission", "gut_blend_forward",
                                                    "gut_blend_backward", "segsum_emission",
                                                    "ut_project_kernel",
                                                    "pixel_world_rays_kernel"))
                and all(launches[k] == 0 for k in ("blend_forward", "blend_backward",
                                                    "segred_prefix")),
                f"K1, K5, K6, K4, the UT projection and the world rays must launch once a "
                f"GUT step: {launches}, {steps} steps")
        require(len(t._loss_hist) == TRAINER_GUT_ITERS
                and all(math.isfinite(v) for v in t._loss_hist), "GUT trainer losses")
        require(gut["loss_last8"] < gut["loss_first8"], ("the GUT loss did not fall", gut))
        gut.update(trainer_step_probe(t))
        phase("trainer-gut", **{k: gut[k] for k in ("iterations", "it_per_s", "launches",
                                                     "plan_history", "step_ms_alone",
                                                     "step_ms_beside_loader")})
        del t
        torch.cuda.empty_cache()

        # -- the CLI, as a user runs it
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_splat_torch", "-d", str(root / "capture"), "-o",
             str(root / "cli"), "--headless", "-i", str(TRAINER_CLI_ITERS)],
            cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        require(proc.returncode == 0, f"the training CLI failed:\n{proc.stderr[-3000:]}")
        for name in ("splat_final.ply", "training_params.json", "cli.ls"):
            require((root / "cli" / name).exists(), f"the CLI did not write {name}")
        cli = dict(seconds=cli_s, iterations=TRAINER_CLI_ITERS, returncode=proc.returncode)
        phase("trainer-cli", **cli)
        torch.cuda.empty_cache()

        # -- the CLI with --batch-size: B cameras an optimizer step on a 1x1 mesh
        batched = trainer_batched_phase(root, dev, counted)
        phase("trainer-batched", **{k: batched[k] for k in (
            "iterations", "batch", "it_per_s", "images_per_s", "psnr", "launches",
            "plan_history", "gather_budget")})
        torch.cuda.empty_cache()

        # -- the ADC preset with LPIPS, checkpoint and resume, the components
        adc = trainer_adc_phase(root, dev, counted)
        resume = trainer_resume_phase(root, dev, counted)
        components = trainer_components_phase(root, dev, counted)
        # -- the Trainer under the live viewer, with the timelapse and SOG export
        live = trainer_live_phase(root, dev, counted, pin["it_per_s_without_eval_and_save"])
        phase("trainer-live", **{k: live[k] for k in (
            "iterations", "it_per_s", "it_per_s_without_pause", "it_per_s_loop",
            "pinhole_it_per_s",
            "paused_s", "launches", "steps", "timelapse_renders", "viewer_renders",
            "client_frames", "sog_s", "sog_bytes", "live_render_ms", "live_encode_ms")})
        torch.cuda.empty_cache()
    return dict(capture=capture, pinhole=pin, gut=gut, cli=cli, batched=batched, adc=adc,
                resume=resume, components=components, live=live)


def require_launches(launches: dict, t, label: str) -> None:
    """K1-K4 once a pinhole step, K1 and K2 once more an eval render, no GUT kernel."""
    steps, evals = t.steps_dispatched, t.eval_renders
    require(all(launches[k] == steps + evals for k in ("expand_emission", "blend_forward"))
            and all(launches[k] == steps for k in ("blend_backward", "segsum_emission"))
            and all(launches[k] == 0 for k in NO_PINHOLE_LAUNCH),
            f"{label}: K1-K4 must launch once a step (K1, K2 also once an eval render): "
            f"{launches}, {steps} steps, {evals} eval renders")


def require_alive_chain(t, label: str) -> list:
    """Each refine's n_alive = the previous n_alive + n_dup + n_split - n_pruned (only
    the refines change the alive set in these schedules). -> the ADC refines"""
    refines = [r for r in t.refine_log if r["kind"] == "adc"]
    n_alive = t.n_alive_at_start
    for r in refines:
        require(r["n_alive"] == n_alive + r["n_dup"] + r["n_split"] - r["n_pruned"],
                (f"{label}: refine counts do not add up", n_alive, r))
        n_alive = r["n_alive"]
    require(int(t.state.splat.n_alive()) == n_alive, (f"{label}: n_alive", n_alive))
    return refines


class RecordingLPIPS:
    """The evaluator's LPIPS model, recording each pair it scores (on the host) and the
    score, so the same pairs can be scored again on the CPU."""

    def __init__(self, model):
        self.model, self.calls = model, []

    @property
    def available(self) -> bool:
        return self.model.available

    def __call__(self, a, b):
        out = self.model(a, b)
        self.calls.append((a.cpu(), b.cpu(), out))
        return out


def split_children(alive0: np.ndarray, sc0: np.ndarray, sc1: np.ndarray,
                   means0: np.ndarray, means1: np.ndarray) -> np.ndarray:
    """The rows a refine wrote as split children: children A are rows alive before whose
    scale changed; children B dead rows written with a scale no alive row had (a
    duplicate copies its candidate's scale)."""
    changed = (sc1 != sc0).any(-1) | (means1 != means0).any(-1)
    new_rows = np.nonzero(~alive0 & changed)[0]
    known = set(map(bytes, sc0[alive0]))
    child_b = np.zeros_like(alive0)
    child_b[new_rows] = [bytes(sc1[i]) not in known for i in new_rows]
    return (alive0 & (sc1 != sc0).any(-1)) | child_b


def adc_card_checks(t, dev) -> dict:
    """On the ADC run's final state: one train step through the kernels against the same
    step through their plain versions (`dens_count` exactly, `dens_grad2d` within 2e-3 of
    its largest value: K3's mean2d columns summed by K4 against the plain sums. K3 takes a
    pixel's suffix as total minus prefix, so its per-pixel terms carry an error of up to
    1e-4 of the largest term (`tests/test_torch_cuda.py`), and the mean2d gradient sums
    terms of both signs, which leaves up to ~1e-3 of its largest value; the plain path's
    own autograd scatter adds with atomics); then the
    refine on the card against the refine on the CPU on identical dens_* and eps: alive
    masks, counts, moments and every row but the split children bit for bit, the split
    children's means and scales rtol 1e-5 (einsum and exp/log on another device)."""
    import torch

    from tpu_splat_torch.ops.rasterize import to_device
    from tpu_splat_torch.training.train_step import adc_refine_step, train_step

    ts = dataclasses.replace(t.state, dens_count=torch.zeros_like(t.state.dens_count),
                             dens_grad2d=torch.zeros_like(t.state.dens_grad2d))
    sample = t.train_dataset.get(0)
    cam = sample.camera
    outs = {}
    for impl in ("kernel", "plain"):
        out, _ = train_step(ts, to_device(sample.image, dev),
                            to_device(cam.world_view_transform, dev),
                            to_device(cam.cam_position, dev), sample.fx, sample.fy, sample.cx,
                            sample.cy, torch.zeros(3, device=dev), sample.index,
                            width=cam.image_width, height=cam.image_height, plan=t.plan,
                            opt=t.step_cfg, total_iterations=t.opt.iterations, impl=impl)
        outs[impl] = out
    torch.cuda.synchronize()
    k, p = outs["kernel"], outs["plain"]
    require(torch.equal(k.dens_count, p.dens_count), "dens_count: kernels against plain")
    g_max = float(p.dens_grad2d.abs().max())
    dens_err = float((k.dens_grad2d - p.dens_grad2d).abs().max()) / g_max
    require(g_max > 0 and dens_err <= 2e-3, ("dens_grad2d: kernels against plain", dens_err))
    thr = t.opt.grad_threshold
    flips = int(((k.dens_grad2d > thr) != (p.dens_grad2d > thr)).sum())
    # and at a threshold that 5% of the Gaussians this step saw exceed
    seen_p = p.dens_grad2d[p.dens_count > 0]
    thr95 = float(torch.quantile(seen_p[:1 << 24], 0.95))
    flips95 = int(((k.dens_grad2d > thr95) != (p.dens_grad2d > thr95)).sum())

    # the refine on the card and on the CPU from the same state, dens_* and eps; at the
    # preset's threshold few Gaussians grow this early in a run, so the check refines at
    # the 95th percentile of the alive Gaussians' average gradient when that is lower; and
    # since this capture's Gaussians can all be larger than the preset's duplicate scale
    # (0.01 of the scene), the check raises that scale to the median of the candidates'
    # largest scales when it is lower, so that both the duplicate and the split path run
    src = dataclasses.replace(t.state)
    avg = src.dens_grad2d / torch.clamp_min(src.dens_count, 1.0)
    seen = src.splat.alive & (src.dens_count > 0)
    check_thr = min(thr, float(torch.quantile(avg[seen][:1 << 24], 0.95)))
    cand = seen & (avg > check_thr)
    max_scale = torch.amax(torch.exp(src.splat.scaling_raw), dim=-1)
    check_grow = max(t.opt.grow_scale3d,
                     float(torch.median(max_scale[cand])) / src.splat.scene_scale)
    gen = torch.Generator(device=dev).manual_seed(17)
    eps = torch.randn((2, src.splat.capacity, 3), device=dev, generator=gen)
    kw = dict(grad_threshold=check_thr, grow_scale3d=check_grow,
              prune_opacity=t.opt.prune_opacity, prune_scale3d=t.opt.prune_scale3d,
              reset_every=t.opt.reset_every, revised_opacity=t.opt.revised_opacity)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card, card_info = adc_refine_step(src, eps=eps, **kw)
    torch.cuda.synchronize()
    refine_ms = (time.perf_counter() - t0) * 1e3

    def to_cpu(x):
        if isinstance(x, torch.Tensor):
            return x.cpu()
        if isinstance(x, dict):
            return {k_: to_cpu(v) for k_, v in x.items()}
        return x

    cpu_splat = src.splat.to("cpu")
    cpu_adam = dataclasses.replace(src.adam, exp_avg=to_cpu(src.adam.exp_avg),
                                   exp_avg_sq=to_cpu(src.adam.exp_avg_sq))
    cpu_src = dataclasses.replace(src, splat=cpu_splat, adam=cpu_adam,
                                  rng=torch.Generator(), dens_count=src.dens_count.cpu(),
                                  dens_grad2d=src.dens_grad2d.cpu())
    host, host_info = adc_refine_step(cpu_src, eps=eps.cpu(), **kw)
    counts = {k_: int(v) for k_, v in card_info.items()}
    require(counts == {k_: int(v) for k_, v in host_info.items()},
            ("refine counts: card against CPU", counts, host_info))
    alive0 = cpu_splat.alive.numpy()
    require(np.array_equal(card.splat.alive.cpu().numpy(), host.splat.alive.numpy()),
            "refine alive mask: card against CPU")
    child = split_children(alive0, cpu_splat.scaling_raw.numpy(),
                           host.splat.scaling_raw.numpy(), cpu_splat.means.numpy(),
                           host.splat.means.numpy())
    require(int(child.sum()) == 2 * counts["n_split"], ("split children", int(child.sum())))
    require(counts["n_dup"] > 0 and counts["n_split"] > 0, ("the check grew nothing", counts))
    split_err = 0.0
    for name in ("means", "sh0", "shN", "scaling_raw", "rotation_raw", "opacity_raw"):
        a = getattr(card.splat, name).cpu().numpy()
        b = getattr(host.splat, name).numpy()
        if name in ("means", "scaling_raw"):
            require(np.array_equal(a[~child], b[~child]), f"refine {name}: copied rows")
            if child.any():
                split_err = max(split_err, float(np.max(np.abs(a[child] - b[child])
                                                        / (np.abs(b[child]) + 1e-6))))
                require(np.allclose(a[child], b[child], rtol=1e-5, atol=1e-6),
                        (f"refine {name}: split children", split_err))
        else:
            require(np.array_equal(a, b), f"refine {name}: card against CPU")
        for moments in ("exp_avg", "exp_avg_sq"):
            require(np.array_equal(getattr(card.adam, moments)[name].cpu().numpy(),
                                   getattr(host.adam, moments)[name].numpy()),
                    f"refine {moments} {name}: card against CPU")
    return dict(dens_grad2d_rel_err=dens_err, dens_grad2d_max=g_max,
                candidates_kernel=int((k.dens_grad2d > thr).sum()),
                candidates_plain=int((p.dens_grad2d > thr).sum()), threshold_flips=flips,
                p95_candidates=int((p.dens_grad2d > thr95).sum()), p95_threshold_flips=flips95,
                refine_threshold=check_thr, refine_grow_scale3d=check_grow,
                refine_counts=counts, refine_ms=refine_ms,
                split_children_rel_err=split_err)


def trainer_adc_phase(root: Path, dev, counted) -> dict:
    """`Trainer` on the shipped ADC preset (parameter/default_optimization_params.json:
    tile 16, so chunk 128, under the Trainer's bf16 pack), capacity 2^20, SH degree 3 at
    iteration 72, its schedule cut from 30,000 iterations to ADC_ITERS: refines every 16
    from 16 to 80 and an opacity reset at 48; evals at 8 and ADC_ITERS with LPIPS from
    random VGG weights, each held against the same module on the CPU (rtol 1e-3: 13
    float32 convolutions through cuDNN against the CPU's). -> the `trainer.adc` result"""
    import torch

    from tpu_splat_torch.training import lpips
    from tpu_splat_torch.training.metrics import LPIPSModel

    weights = root / "lpips" / "lpips_vgg.npz"
    weights.parent.mkdir()
    np.savez(weights, **lpips.random_params(0))
    recorder = []

    def with_lpips(t):
        t.evaluator.lpips = RecordingLPIPS(LPIPSModel(weights.with_suffix(".pt"), device=dev))
        recorder.append(t.evaluator.lpips)

    run_kw = dict(iterations=ADC_ITERS, max_cap=1_000_000, sh_degree=3,
                  sh_degree_interval=ADC_ITERS // 4, scan_steps=8, refine_every=16,
                  start_refine=8, stop_refine=ADC_ITERS - 8, reset_every=48, enable_eval=True,
                  eval_steps=[8, ADC_ITERS], save_steps=[ADC_ITERS],
                  enable_save_eval_images=False, num_workers=8)
    t, launches, wall = trainer_run(run_kw, root / "capture", root / "adc", dev, counted,
                                    preset="parameter/default_optimization_params.json",
                                    setup=with_lpips)
    res = trainer_summary(t, launches, wall)
    require(t.plan.tile_size == 16 and t.plan.chunk == 128 and t.plan.pack_bf16,
            ("the ADC preset's plan", t.plan))
    require_launches(launches, t, "trainer-adc")
    require(len(t._loss_hist) == ADC_ITERS and all(math.isfinite(v) for v in t._loss_hist),
            "ADC trainer losses")
    refines = require_alive_chain(t, "trainer-adc")
    require([r["iteration"] for r in refines] == [16, 32, 48, 64, 80], refines)
    require([r["iteration"] for r in t.refine_log if r["kind"] == "reset_opacity"] == [48],
            t.refine_log)
    grown = sum(r["n_dup"] + r["n_split"] for r in refines)
    require(grown > 0, ("ADC grew nothing", refines))
    # LPIPS: every eval scored on the card, each pair again on the CPU
    (rec,) = recorder
    require(len(rec.calls) == t.eval_renders and all(r.lpips is not None
                                                       for r in t.evaluator.results),
            ("LPIPS per eval", len(rec.calls), t.eval_renders))
    host = lpips.LPIPSTorch(weights, device="cpu")
    lpips_err = 0.0
    for a, b, got in rec.calls:
        want = host(a, b)
        lpips_err = max(lpips_err, abs(got - want) / abs(want))
    require(lpips_err <= 1e-3, ("LPIPS: card against CPU", lpips_err))
    a, b, _ = rec.calls[0]
    a, b = a.to(dev), b.to(dev)
    lpips_ms = cuda_ms(lambda: rec.model(a, b), 5)
    res.update(refines=refines, grown=grown, lpips_rel_err=lpips_err, lpips_eval_ms=lpips_ms,
               lpips=[r.lpips for r in t.evaluator.results],
               cuts=dict(iterations=f"30000 -> {ADC_ITERS}", refine="every 100 from 500 to "
                         f"15000 -> every 16 from 8 to {ADC_ITERS - 8}",
                         reset_every="3000 -> 48", sh_degree_interval=f"1000 -> {ADC_ITERS // 4}",
                         eval_steps=f"7000, 30000 -> 8, {ADC_ITERS}"))
    res.update(adc_card_checks(t, dev))
    res.update(trainer_step_probe(t))
    phase("trainer-adc", **{k: res[k] for k in (
        "iterations", "it_per_s", "split_s", "plan_history", "launches", "refines", "evals",
        "lpips", "lpips_rel_err", "lpips_eval_ms", "dens_grad2d_rel_err", "threshold_flips",
        "p95_candidates", "p95_threshold_flips", "refine_threshold", "refine_counts", "refine_ms", "split_children_rel_err",
        "step_ms_alone", "step_ms_beside_loader", "cuts")})
    del t
    torch.cuda.empty_cache()
    return res


def trainer_resume_phase(root: Path, dev, counted) -> dict:
    """Two uninterrupted MCMC runs of RESUME_ITERS iterations with a checkpoint at the
    half, and a third `Trainer` resumed from the first run's checkpoint (one loader worker
    each, so all three draw the same samples; no refine, whose relocation draws would turn
    a last-bit difference into a different Gaussian). The loaded state must equal the saved one
    bit for bit, and the resumed run must end within the spread of the two uninterrupted
    runs: for each parameter group, max |resumed - first| <= 3 max |second - first| plus
    1e-6 of the group's largest value (autograd's index backward adds with atomics on the
    card, so two runs of the same code differ in the last bits). -> `trainer.resume`"""
    import torch

    from tpu_splat_torch.training import checkpoint

    half = RESUME_ITERS // 2
    run_kw = dict(iterations=RESUME_ITERS, max_cap=1_000_000, sh_degree=3, scan_steps=8,
                  start_refine=RESUME_ITERS, eval_steps=[], save_steps=[], num_workers=1)
    saved = []

    def checkpointed(t):
        t.checkpoint_every = half
        save = t.save_checkpoint

        def save_and_keep(path, it):
            saved.append((path, checkpoint.state_arrays(t.state), t.state.rng.get_state()))
            return save(path, it)

        t.save_checkpoint = save_and_keep

    runs = []
    for i in range(2):
        t, launches, wall = trainer_run(run_kw, root / "capture", root / f"resume{i}", dev,
                                        counted, setup=checkpointed)
        require_launches(launches, t, f"trainer-resume run {i}")
        runs.append((t.state, list(t._loss_hist), wall))
        del t
    path, arrays, rng_state = saved[0]
    require(path.name == f"checkpoint_{half}.npz", path)
    loaded, extra = checkpoint.load_checkpoint(path, device=dev)
    got = checkpoint.state_arrays(loaded)
    require(sorted(got) == sorted(arrays) and all(np.array_equal(got[k], v)
                                                 for k, v in arrays.items())
            and torch.equal(loaded.rng.get_state(), rng_state),
            "the loaded checkpoint differs from the saved state")

    def resumed_from(t):
        t.resume(path)
        t.checkpoint_every = half

    t, launches, wall = trainer_run(run_kw, root / "capture", root / "resumed", dev, counted,
                                    setup=resumed_from)
    require_launches(launches, t, "trainer-resume resumed run")
    require(len(t._loss_hist) == RESUME_ITERS - half, len(t._loss_hist))
    first, second = checkpoint.state_arrays(runs[0][0]), checkpoint.state_arrays(runs[1][0])
    mine = checkpoint.state_arrays(t.state)
    spread = {}
    for k in ("splat/means", "splat/sh0", "splat/shN", "splat/scaling_raw",
              "splat/rotation_raw", "splat/opacity_raw"):
        d_runs = float(np.max(np.abs(second[k] - first[k])))
        d_resumed = float(np.max(np.abs(mine[k] - first[k])))
        spread[k] = dict(two_runs=d_runs, resumed=d_resumed)
        require(d_resumed <= 3 * d_runs + 1e-6 * float(np.max(np.abs(first[k]))),
                ("the resumed run ends outside the spread of two runs", k, spread[k]))
    alive_same = np.array_equal(second["splat/alive"], first["splat/alive"])
    require(not alive_same or np.array_equal(mine["splat/alive"], first["splat/alive"]),
            "the resumed run's alive mask differs where two runs agree")
    res = dict(iterations=RESUME_ITERS, checkpoint_at=half, spread=spread, launches=launches,
               loaded_bit_equal=True, loss_last=[runs[0][1][-1], runs[1][1][-1],
                                                 t._loss_hist[-1]],
               walls=[runs[0][2], runs[1][2], wall], plan=dataclasses.asdict(t.plan))
    phase("trainer-resume", **res)
    del t, runs
    torch.cuda.empty_cache()
    return res


def trainer_components_phase(root: Path, dev, counted) -> dict:
    """A pinhole run with the bilateral grid and the pose MLP (COMPONENT_ITERS), and one with
    ADMM sparsity, its schedule cut to 8 base iterations and 52 sparsify steps so that the
    ADMM init (8), one dual update (58) and the final prune (60) all happen. Requires
    finite losses, grids and pose parameters that moved from their init, and a prune of
    int(prune_ratio * n_alive) Gaussians. -> `trainer.components`"""
    import torch

    from tpu_splat_torch.training.bilateral_grid import init_grids

    base = dict(max_cap=1_000_000, sh_degree=3, scan_steps=8, refine_every=8, start_refine=4,
                stop_refine=1_000, eval_steps=[], save_steps=[], num_workers=8)
    t, launches, wall = trainer_run(dict(base, iterations=COMPONENT_ITERS,
                                         use_bilateral_grid=True, pose_optimization="mlp"),
                                    root / "capture", root / "components", dev, counted)
    require_launches(launches, t, "trainer-components grid+pose")
    ts = t.state
    require(all(math.isfinite(v) for v in t._loss_hist)
            and len(t._loss_hist) == COMPONENT_ITERS, "component run losses")
    grid0 = init_grids(ts.bilateral_grids.shape[0], device=dev)
    grid_moved = float((ts.bilateral_grids - grid0).abs().max())
    pose_moved = float(ts.pose_params["layers"][-1]["w"].abs().max())
    require(grid_moved > 0 and pose_moved > 0, ("grids or poses did not move", grid_moved,
                                                pose_moved))
    res = dict(grid_pose=dict(iterations=COMPONENT_ITERS, it_per_s=len(t._loss_hist) / wall,
                              launches=launches, grid_max_move=grid_moved,
                              pose_last_layer_max=pose_moved,
                              loss_first8=statistics.mean(t._loss_hist[:8]),
                              loss_last8=statistics.mean(t._loss_hist[-8:])))
    del t, ts
    torch.cuda.empty_cache()

    t, launches, wall = trainer_run(dict(base, iterations=8, enable_sparsity=True,
                                         sparsify_steps=52, prune_ratio=0.6),
                                    root / "capture", root / "sparsity", dev, counted)
    require_launches(launches, t, "trainer-components sparsity")
    require(len(t._loss_hist) == 60 and all(math.isfinite(v) for v in t._loss_hist),
            "sparsity run losses")
    kinds = [(r["iteration"], r["kind"]) for r in t.refine_log if r["kind"] != "mcmc"]
    require(kinds == [(8, "admm_init"), (58, "admm_update"), (60, "sparsity_prune")], kinds)
    prune = t.refine_log[-1]
    want = int(np.float32(np.float32(0.6) * np.float32(prune["n_before"])))
    require(prune["n_pruned"] == want > 0
            and int(t.state.splat.n_alive()) == prune["n_before"] - want,
            ("sparsity prune", prune, want))
    res["sparsity"] = dict(iterations=60, it_per_s=60 / wall, launches=launches,
                           schedule=kinds, prune=prune)
    phase("trainer-components", **res)
    del t
    torch.cuda.empty_cache()
    return res


# ======================= the serving side: SOG, crop, point cloud, SH 4, viewer ==========


def kmeans_card_check(dev) -> dict:
    """`kmeans` and `kmeans_1d` on the card against the same functions on the CPU, at
    n = KMEANS_CHECK_N points of 45 values around 300 centres (noise 0.02), a palette of
    KMEANS_CHECK_K (and 256 for `kmeans_1d` over the first three values of each point):
    the k-means++ init bit-equal (its distances are summed in float64 and rounded once);
    after one Lloyd step the labels equal except where a point's two labels score within
    1e-5 of each other (relative; `kmeans_1d`: equal, the same sorted edges on both), the
    centroids rtol 1e-5; after 10 steps the inertia within 1e-4 (relative: the card's
    atomic adds order differently, so a near-tie can go the other way and the two runs
    part by a point's share of a centroid now and then). -> the numbers"""
    import torch

    from tpu_splat_torch.io import sog

    rng = np.random.default_rng(9)
    centres = rng.normal(0, 0.1, (300, 45)).astype(np.float32)
    x = (centres[rng.integers(0, 300, KMEANS_CHECK_N)]
         + rng.normal(0, 0.02, (KMEANS_CHECK_N, 45))).astype(np.float32)
    v = x[:, :3].T.reshape(-1)
    k = KMEANS_CHECK_K
    init_card = sog.kmeans_init(x, k, device=dev).cpu()
    init_cpu = sog.kmeans_init(x, k, device="cpu")
    require(torch.equal(init_card, init_cpu), "k-means++ init differs between card and CPU")
    out = {}
    for name, fn, data, kk in (("kmeans", sog.kmeans, x, k), ("kmeans_1d", sog.kmeans_1d, v, 256)):
        pts = data.reshape(len(data), -1)
        for iters in (1, 10):
            t0 = time.perf_counter()
            c_card, l_card = fn(data, kk, iters, device=dev)
            card_s = time.perf_counter() - t0
            c_cpu, l_cpu = fn(data, kk, iters, device="cpu")
            c_card, c_cpu = c_card.reshape(kk, -1), c_cpu.reshape(kk, -1)
            i_card = float(np.sum((pts - c_card[l_card]).astype(np.float64) ** 2))
            i_cpu = float(np.sum((pts - c_cpu[l_cpu]).astype(np.float64) ** 2))
            rel = abs(i_card - i_cpu) / i_cpu
            differ = int((l_card != l_cpu).sum())
            if iters == 1:
                if name == "kmeans":
                    init = init_cpu.numpy().astype(np.float64)
                    score = pts.astype(np.float64) @ init.T - 0.5 * np.sum(init ** 2, axis=1)
                    rows = np.arange(len(pts))
                    sa, sb = score[rows, l_card], score[rows, l_cpu]
                    near = np.abs(sa - sb) <= 1e-5 * np.maximum(np.abs(sa), np.abs(sb))
                else:
                    near = np.zeros(len(pts), bool)
                require(not ((l_card != l_cpu) & ~near).any(),
                        f"{name} labels differ off near-ties after one step: {differ}")
                require(np.allclose(c_card, c_cpu, rtol=1e-5, atol=1e-6),
                        f"{name} one-step centroids")
            else:
                require(rel <= 1e-4, (f"{name} inertia, card against CPU", i_card, i_cpu))
            out[f"{name}_iters{iters}"] = dict(inertia_card=i_card, inertia_cpu=i_cpu,
                                               rel_diff=rel, labels_differing=differ,
                                               card_s=card_s)
    return dict(n=KMEANS_CHECK_N, k=k, **out)


def sog_phase(params, path: Path, dev) -> dict:
    """`save_sog` of the render scene on the card (palette 65,536, SOG_ITERS iterations),
    its split into Morton, k-means++ init, Lloyd, the three 1-d k-means, WebP encode and
    zip, each plane's size; `load_sog` back: the decoded planes bit-equal to the encoded
    ones, the means within a 16-bit step of their log range, the packed quaternion
    components within one 8-bit step (the rebuilt largest within 0.03), the opacity within
    1/255, scales, sh0 and shN on their codebooks; then `kmeans_card_check`."""
    from tpu_splat_torch.io import sog

    tm = {}
    t0 = time.perf_counter()
    planes, meta = sog.save_sog(path, params, kmeans_iterations=SOG_ITERS, device=dev,
                                timings=tm)
    save_s = time.perf_counter() - t0
    palette = min(64, 2 ** int(np.log2(N_GAUSS / 1024.0))) * 1024  # 65,536 at 1M
    require(meta["shN"]["palette_size"] == palette and meta["count"] == N_GAUSS, meta["shN"])
    blobs = sog.read_sog_files(path)
    t0 = time.perf_counter()
    back = sog.load_sog(path)
    load_s = time.perf_counter() - t0
    decoded = sog.decode_planes(blobs, list(planes))
    for name, plane in planes.items():
        require(np.array_equal(decoded[name], plane), f"{name} does not decode to itself")

    order = sog.morton_order(params["means"])
    span = np.asarray(meta["means"]["maxs"]) - np.asarray(meta["means"]["mins"])
    mean_err = np.abs(sog.log_transform(back["means"])
                      - sog.log_transform(params["means"][order])).max(axis=0)
    require((mean_err <= span / 65535.0 * 1.001 + 1e-6).all(), ("means", mean_err, span))
    q = params["rotation_raw"][order].astype(np.float64)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    big = np.argmax(np.abs(q), axis=1)
    q *= np.sign(q[np.arange(len(q)), big])[:, None]
    qerr = np.abs(back["rotation_raw"] - q)
    step = 2.0 / (255.0 * np.sqrt(2.0))
    largest = qerr[np.arange(len(q)), big]
    qerr[np.arange(len(q)), big] = 0.0
    require(qerr.max() <= step + 1e-6 and largest.max() <= 0.03, (qerr.max(), largest.max()))

    def sigmoid(v):
        return 1.0 / (1.0 + np.exp(-v.astype(np.float64)))

    op_err = np.abs(sigmoid(back["opacity_raw"]) - sigmoid(params["opacity_raw"][order])).max()
    require(op_err <= 1.0 / 255.0 + 1e-6, ("opacity", op_err))
    for key, book in (("scaling_raw", "scales"), ("sh0", "sh0"), ("shN", "shN")):
        cb = np.asarray(meta[book]["codebook"], np.float32)
        require(np.isin(back[key], cb).all(), f"{key} off its codebook")
    out = dict(
        n=N_GAUSS, palette=meta["shN"]["palette_size"], iterations=SOG_ITERS,
        seconds=dict(tm, total=save_s), load_s=load_s, file_bytes=path.stat().st_size,
        plane_bytes={name: len(blobs[name]) for name in planes},
        plane_shapes={name: list(p.shape[:2]) for name, p in planes.items()},
        errors=dict(means_log=mean_err.tolist(), means_step=(span / 65535.0).tolist(),
                    quat=float(qerr.max()), quat_largest=float(largest.max()),
                    opacity=float(op_err)))
    out["kmeans_card_vs_cpu"] = kmeans_card_check(dev)
    return out


def serving_frames(state, sh4_state, focal, dev, counted) -> dict:
    """A point-cloud frame of `state` and an SH-degree-4 frame of `sh4_state` through
    `render_view`, each through the kernels (K1 and K2 launched once) against the plain
    versions (image and alpha atol 1e-4, the frame gate)."""
    import torch

    from tpu_splat_torch.render import render_view

    fov = math.degrees(2 * math.atan(0.5 * WIDTH / focal))
    w2c = np.eye(4, dtype=np.float32)
    out = {}
    for label, st, kw in (("point_cloud", state, dict(point_cloud=True)),
                          ("sh_degree_4", sh4_state, {})):
        for fn in counted:
            fn.launches = 0
        got = render_view(st, w2c, WIDTH, HEIGHT, fov, device=dev, **kw)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counted}
        want = render_view(st, w2c, WIDTH, HEIGHT, fov, device=dev, impl="plain", **kw)
        torch.cuda.synchronize()
        img_err, alpha_err = max_err(got.image, want.image), max_err(got.alpha, want.alpha)
        require(launches["expand_emission"] == 1 and launches["blend_forward"] == 1,
                (label, launches))
        require(bool(torch.isfinite(got.image).all()) and img_err <= 1e-4
                and alpha_err <= 1e-4, (label, img_err, alpha_err))
        out[label] = dict(image_err=img_err, alpha_err=alpha_err, launches=launches,
                          mean_alpha=float(got.alpha.mean()))
    return out


def sh4_train_steps(params4, focal, dev, counted) -> dict:
    """SH4_STEPS `train_step`s of the scene with 24 rest coefficients at active degree 4
    (`sh_degree_interval` 1, from the iteration after shN's 1000-iteration freeze, so that
    Adam moves shN): K1-K4 once a step, finite state, the loss finite, and band 4's
    coefficients moved."""
    import torch

    from tpu_splat_torch.training.optim import SHN_WARMUP_ITERS
    from tpu_splat_torch.training.train_step import train_step

    ts, target, cam, bg0, plan, step_kw = train_setup(params4, focal, dev, sh_degree=4)
    step_kw["opt"] = dataclasses.replace(step_kw["opt"], sh_degree_interval=1)
    ts = dataclasses.replace(ts, iteration=SHN_WARMUP_ITERS + 1)
    band4 = ts.splat.shN[:, 15:].clone()
    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    losses = []
    for _ in range(SH4_STEPS):
        ts, st = train_step(ts, target, *cam, bg0, 0, plan=plan, **step_kw)
        losses.append(float(st.loss))
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counted}
    require(all(launches[fn.__name__] == (SH4_STEPS if fn in counted[:4] else 0)
                for fn in counted), f"SH 4 steps: K1-K4 once a step: {launches}")
    require(all(math.isfinite(v) for v in losses), "non-finite SH 4 loss")
    for k, v in ts.splat.params().items():
        require(bool(torch.isfinite(v).all()), f"non-finite {k} after SH 4 steps")
    moved = float((ts.splat.shN[:, 15:] - band4).abs().max())
    require(moved > 0, "band 4 did not move")
    return dict(steps=SH4_STEPS, launches=launches, losses=losses, band4_moved=moved,
                plan=dataclasses.asdict(plan))


def view_sog_phase(sog_path: Path, params, focal, dev, counted, tmp: Path) -> dict:
    """The CLI's `--view` of the written .sog with `--crop-min/--crop-max` (3 frames), a
    point-cloud and an SH-degree-4 frame, and SH 4 train steps."""
    import torch

    from tpu_splat_torch.cli import main as cli_main
    from tpu_splat_torch.convert import splat_from_numpy
    from tpu_splat_torch.render import load_model

    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    rc = cli_main(["--view", str(sog_path), "-o", str(tmp / "view_sog"), "--view-frames", "3",
                   "--crop-min", *map(str, CROP_MIN), "--crop-max", *map(str, CROP_MAX)])
    cli_s = time.perf_counter() - t0
    cli_launches = {fn.__name__: fn.launches for fn in counted}
    pngs = sorted((tmp / "view_sog").glob("frame_*.png"))
    require(rc == 0 and len(pngs) == 3, (rc, pngs))
    require(all(cli_launches[k] == 3 for k in ("expand_emission", "blend_forward")),
            cli_launches)
    state = load_model(sog_path, dev)
    require(state.capacity == N_GAUSS and state.max_sh_degree == 3, state.capacity)
    rng = np.random.default_rng(4)
    params4 = dict(params, shN=np.concatenate(
        [params["shN"], rng.normal(0, 0.05, (N_GAUSS, 9, 3)).astype(np.float32)], axis=1))
    sh4_state = splat_from_numpy(params4, np.ones(N_GAUSS, bool), 4, dev, scene_scale=3.0)
    frames = serving_frames(state, sh4_state, focal, dev, counted)
    del state, sh4_state
    torch.cuda.empty_cache()
    steps = sh4_train_steps(params4, focal, dev, counted)
    torch.cuda.empty_cache()
    return dict(cli=dict(frames=len(pngs), seconds=cli_s, launches=cli_launches,
                         crop_min=CROP_MIN, crop_max=CROP_MAX),
                frames=frames, sh4_steps=steps)


def _http_get(url: str, timeout: float = 300.0) -> tuple[bytes, str]:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read(), r.headers.get("Content-Type")


def _quantiles(values) -> dict:
    v = sorted(values)
    return dict(median=statistics.median(v), p90=v[min(len(v) - 1, int(0.9 * len(v)))],
                n=len(v))


def viewer_phase(model: Path, compare: Path, dev, counted) -> dict:
    """`viewer.serve` of the 1M-Gaussian PLY (and a compare model) on a free loopback
    port: `/`, `/info`, `/scene`, then VIEWER_FRAMES `/frame`s at VIEWER_W x VIEWER_H (RGB
    from several angles, RGB_ED, PC, the overlay, the crop box switched on through
    `/scene_ctl`, a compare split), each PNG decoded by `decode_png` and held equal to the
    quantized `render_view` image of the same camera; launches counted; the latency's
    median and p90, split into render and encode; the first frame's PNG encode time and
    size at zlib levels 0, 1 and 6."""
    import torch

    from tpu_splat_torch import viewer
    from tpu_splat_torch.core.geometry import BoundingBox, crop_splat_by_box
    from tpu_splat_torch.io.image import decode_png, encode_png
    from tpu_splat_torch.render import render_view

    t0 = time.perf_counter()
    server = viewer.serve(str(model), port=0, width=VIEWER_W, height=VIEWER_H,
                          compare_path=str(compare), device=dev, block=False)
    load_s = time.perf_counter() - t0
    v = server.viewer
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        page, ctype = _http_get(base + "/")
        require(ctype == "text/html" and b"/scene_ctl" in page, "viewer page")
        info = json.loads(_http_get(base + "/info")[0])
        require(info["n_alive"] == N_GAUSS and info["compare"], info)
        scene = json.loads(_http_get(base + "/scene")[0])
        require(scene["nodes"][0]["n"] == N_GAUSS and not scene["crop"]["on"], scene)
        lo, hi = v.center - 0.25 * v.base_radius, v.center + 0.25 * v.base_radius
        plan = [("RGB", 0.0, {}), ("RGB", 0.6, {}), ("RGB", 1.2, {}), ("RGB", -0.6, {}),
                ("RGB_ED", 0.3, {}), ("RGB_ED", 0.9, {}), ("PC", 0.0, {}), ("PC", 0.7, {}),
                ("RGB", 0.4, dict(overlay=1)), ("RGB", 0.2, dict(split=0.5)),
                ("crop", 0.0, {}), ("crop", 0.5, {})]  # the crop stays on once switched on
        require(len(plan) == VIEWER_FRAMES, "frame plan")
        for fn in counted:
            fn.launches = 0
        renders0 = v.renders
        got, latency = [], []
        for mode, theta, extra in plan:
            if mode == "crop" and not v.crop_on:
                ctl = (f"/scene_ctl?crop=1&cmin={','.join(f'{x:.6f}' for x in lo)}"
                       f"&cmax={','.join(f'{x:.6f}' for x in hi)}")
                require(json.loads(_http_get(base + ctl)[0]) == {"ok": True}, "scene_ctl")
            q = (f"/frame?theta={theta:.4f}&phi=-0.2500&radius=1.0000"
                 f"&mode={'RGB' if mode == 'crop' else mode}"
                 + "".join(f"&{k}={val}" for k, val in extra.items()))
            t0 = time.perf_counter()
            png, ctype = _http_get(base + q)
            latency.append((time.perf_counter() - t0) * 1e3)
            require(ctype == "image/png", ctype)
            got.append((mode, theta, extra, png))
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counted}
        renders = v.renders - renders0
        require(renders == VIEWER_FRAMES + 1, ("viewer renders", renders))
        require(all(launches[k] == renders for k in ("expand_emission", "blend_forward")),
                ("viewer launches", launches, renders))
        crop_state = crop_splat_by_box(v.nodes[0].state, BoundingBox(
            np.asarray([float(f"{x:.6f}") for x in lo], np.float32),
            np.asarray([float(f"{x:.6f}") for x in hi], np.float32)))
        uncropped = v.nodes[0].state
        f = 0.5 * VIEWER_W / math.tan(math.radians(60.0) / 2)
        for mode, theta, extra, png in got:
            w2c = viewer.orbit_w2c(v.center, v.base_radius, theta, -0.25, 1.0)
            st = crop_state if mode == "crop" else uncropped
            out = render_view(st, w2c, VIEWER_W, VIEWER_H, device=dev,
                              render_mode="RGB_ED" if mode == "RGB_ED" else "RGB",
                              point_cloud=mode == "PC")
            img = torch.clamp(out.image, 0, 1).cpu().numpy()
            if extra.get("overlay"):
                viewer.draw_world_overlay(img, w2c, f, f, VIEWER_W / 2, VIEWER_H / 2,
                                          v.center, v.base_radius)
            if mode == "RGB_ED":
                d = out.depth.cpu().numpy()
                dn = (d - d.min()) / max(float(d.max() - d.min()), 1e-9)
                img = np.concatenate([img[:, :, :VIEWER_W // 2],
                                      np.repeat(dn[None], 3, 0)[:, :, VIEWER_W // 2:]], axis=2)
            if "split" in extra:
                c = int(extra["split"] * VIEWER_W)
                other = render_view(v.compare, w2c, VIEWER_W, VIEWER_H, device=dev).image
                other = torch.clamp(other, 0, 1).cpu().numpy()
                img = np.concatenate([img[:, :, :c], other[:, :, c:]], axis=2)
                img[:, :, c - 1:c + 1] = 1.0
            require(np.array_equal(decode_png(png), viewer.quantize(img)),
                    f"viewer frame {mode} {theta} {extra} differs from render_view")
        split = list(v.frame_ms)[-VIEWER_FRAMES:]
        # the PNG's zlib level against its encode time and size, on the first frame
        rgb = decode_png(got[0][3])
        levels = {}
        for level in (0, 1, 6):
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                data = encode_png(rgb, level)
                times.append((time.perf_counter() - t0) * 1e3)
            levels[level] = dict(encode_ms=statistics.median(times), bytes=len(data))
    finally:
        server.shutdown()
        server.server_close()
    return dict(width=VIEWER_W, height=VIEWER_H, frames=VIEWER_FRAMES, renders=renders,
                launches=launches, model_load_s=load_s, png_level=viewer.PNG_LEVEL,
                png_bytes=_quantiles([len(p) for *_, p in got]),
                latency_ms=_quantiles(latency),
                render_ms=_quantiles([s["render_ms"] for s in split]),
                encode_ms=_quantiles([s["encode_ms"] for s in split]), png_levels=levels)


def trainer_live_phase(root: Path, dev, counted, pinhole_it_per_s: float) -> dict:
    """`Trainer` on the capture with MCMC, LIVE_ITERS iterations, the timelapse of two views
    every LIVE_TIMELAPSE_EVERY iterations, `save_sog`, and the live viewer attached on a
    free port, while a client thread requests `/frame` and `/status` every 0.2 s and posts
    pause then resume. Checks: the timelapse PNGs, `splat_final.sog` loads and renders,
    /status iterations rise, the launches exact with the viewer's renders counted."""
    import threading

    import torch

    from tpu_splat_torch import viewer
    from tpu_splat_torch.core.config import (DatasetConfig, OptimizationParameters,
                                             TrainingParameters)
    from tpu_splat_torch.io.image import decode_png
    from tpu_splat_torch.render import load_model, render_view
    from tpu_splat_torch.training.trainer import Trainer

    names = ["view_000.png", "view_005.png"]
    out = root / "live"
    opt = dataclasses.replace(OptimizationParameters(), iterations=LIVE_ITERS, max_cap=1_000_000,
                              scan_steps=8, save_steps=[], num_workers=8, save_sog=True)
    tp = TrainingParameters(
        dataset=DatasetConfig(data_path=str(root / "capture"), output_path=str(out),
                              timelapse_images=names, timelapse_every=LIVE_TIMELAPSE_EVERY),
        optimization=opt)
    t = Trainer(tp, device=dev)
    server = viewer.attach(t, port=0, width=VIEWER_W, height=VIEWER_H)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    stop, log_ = threading.Event(), dict(status=[], frames=0, errors=[], paused_s=0.0)

    def client():
        try:
            k = 0
            while not stop.is_set():
                s = json.loads(_http_get(base + "/status")[0])
                log_["status"].append(s)
                png, ctype = _http_get(base + f"/frame?theta={0.1 * (k % 4):.4f}&phi=-0.2"
                                              "&radius=1&mode=RGB")
                require(ctype == "image/png" and decode_png(png).shape == (VIEWER_H, VIEWER_W, 3),
                        "live frame")
                log_["frames"] += 1
                if k == 6:  # pause, look, resume
                    t0 = time.perf_counter()
                    _http_get(base + "/control?action=pause")
                    time.sleep(1.0)
                    log_["paused_status"] = json.loads(_http_get(base + "/status")[0])
                    _http_get(base + "/control?action=resume")
                    log_["paused_s"] = time.perf_counter() - t0
                k += 1
                stop.wait(0.2)
        except Exception as e:  # reported and failed below, with the train loop's result
            log_["errors"].append(repr(e))

    thread = threading.Thread(target=client, name="live-client", daemon=True)
    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    thread.start()
    t0 = time.perf_counter()
    try:
        t.train(progress_every=8)
    finally:
        wall = time.perf_counter() - t0
        stop.set()
        thread.join(timeout=120)
        server.shutdown()
        server.server_close()
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counted}
    require(not log_["errors"] and not thread.is_alive(), ("live client", log_["errors"]))
    steps, evals = t.steps_dispatched, t.eval_renders
    renders = evals + t.timelapse_renders + t.viewer_renders
    require(all(launches[k] == steps + renders for k in ("expand_emission", "blend_forward"))
            and all(launches[k] == steps for k in ("blend_backward", "segsum_emission"))
            and all(launches[k] == 0 for k in NO_PINHOLE_LAUNCH),
            ("trainer-live launches", launches, steps, evals, t.timelapse_renders,
             t.viewer_renders))
    require(len(t._loss_hist) == LIVE_ITERS and all(math.isfinite(v) for v in t._loss_hist),
            "trainer-live losses")
    its = [s["iteration"] for s in log_["status"]]
    require(len(its) >= 3 and max(its) > min(its), ("/status iterations", its))
    require(log_.get("paused_status", {}).get("paused") is True, log_.get("paused_status"))
    require(t.viewer_renders >= 1 and t.timelapse_renders == 2 * (LIVE_ITERS
                                                                 // LIVE_TIMELAPSE_EVERY),
            (t.viewer_renders, t.timelapse_renders))
    for name in names:
        stem = name.rsplit(".", 1)[0]
        frames = sorted(p.name for p in (out / "timelapse" / stem).iterdir())
        want = [f"{i:06d}.png" for i in range(LIVE_TIMELAPSE_EVERY, LIVE_ITERS + 1,
                                              LIVE_TIMELAPSE_EVERY)]
        require(frames == want, ("timelapse", stem, frames))
        require(decode_png((out / "timelapse" / stem / want[-1]).read_bytes()).shape
                == (HEIGHT, WIDTH, 3), "timelapse frame size")
    model = load_model(out / "splat_final.sog", dev)
    require(int(model.n_alive()) == int(t.state.splat.n_alive()), "splat_final.sog count")
    img = render_view(model, np.eye(4, dtype=np.float32), WIDTH, HEIGHT,
                      math.degrees(2 * math.atan(0.5 * WIDTH / (0.85 * WIDTH))), device=dev).image
    require(bool(torch.isfinite(img).all()) and float(img.std()) > 0.01, "splat_final.sog frame")
    iters = len(t._loss_hist)
    frame_ms = list(server.viewer.frame_ms)
    # the loop's rate: the wall without the client's pause and without the saves (the final
    # PLY and the .sog), as `trainer.pinhole`'s it_per_s_without_eval_and_save
    loop = wall - log_["paused_s"] - t.timings["save"]
    return dict(iterations=iters, wall_s=wall, paused_s=log_["paused_s"],
                it_per_s=iters / wall, it_per_s_without_pause=iters / (wall - log_["paused_s"]),
                it_per_s_loop=iters / loop, pinhole_it_per_s=pinhole_it_per_s,
                launches=launches, steps=steps,
                timelapse_renders=t.timelapse_renders, viewer_renders=t.viewer_renders,
                client_frames=log_["frames"], status_iterations=its,
                split_s=dict(t.timings), sog_s=dict(t.sog_timings),
                sog_bytes=(out / "splat_final.sog").stat().st_size,
                n_alive=int(t.state.splat.n_alive()),
                live_render_ms=_quantiles([s["render_ms"] for s in frame_ms]),
                live_encode_ms=_quantiles([s["encode_ms"] for s in frame_ms]))


def quality_floor_phase(dev, counted) -> dict:
    """The JAX package's CI quality gate (`tests/test_io_and_trainer.py::
    test_trainer_quality_floor_raytraced`) on the card through the port's `Trainer`: the
    raytraced capture of `tpu_splat_torch/tools/synth_capture.py` (8 views at 48x48, seed
    3, SfM noise 0.004, 2400 points; 7 train views, 1 val view), MCMC for 600 iterations
    with max_cap 6000, refines every 100 from 100 to 500, SH degree up every 300, evals at
    150 and 600, with every launch count set to 0 just before `train()` and read just
    after. The gate is the JAX test's: the final PSNR above 11.5 dB and 3 dB above the
    first; K1-K4 once a step, K1 and K2 once more an eval render."""
    from tpu_splat_torch.tools.synth_capture import make_raytraced_colmap

    with tempfile.TemporaryDirectory() as tmp:
        cap = Path(tmp) / "rt"
        make_raytraced_colmap(cap, n_cams=8, size=48, seed=3, sfm_noise=0.004, n_sfm=2400)
        t, launches, wall = trainer_run(
            dict(iterations=QUALITY_ITERS, max_cap=6000, refine_every=100,
                 start_refine=100, stop_refine=500, enable_eval=True,
                 eval_steps=[150, QUALITY_ITERS], save_steps=[], num_workers=2,
                 sh_degree_interval=300, min_opacity=0.005),
            cap, Path(tmp) / "out", dev, counted, test_every=8)
    require_launches(launches, t, "quality-floor")
    res = trainer_summary(t, launches, wall)
    require(len(res["evals"]) == 2 and res["evals"][0]["num_images"] == 1, res["evals"])
    first, last = (e["psnr"] for e in res["evals"])
    require(math.isfinite(first) and math.isfinite(last), (first, last))
    require(last > 11.5, f"quality-floor: PSNR {last:.2f} dB at {QUALITY_ITERS} (floor 11.5)")
    require(last > first + 3.0, f"quality-floor: no convergence, {first:.2f} -> {last:.2f} dB")
    return dict(res, psnr=[first, last], ssim=[e["ssim"] for e in res["evals"]])


def window_phases(state, focal, frame_image, dev) -> dict:
    """`k2k3-window`: K2 (f32 and bf16 layouts) and K3 with a tile-row offset tile_y0 in
    {0, 3, 17} against their plain versions on random segments at (tile 16, chunk 128) and
    (tile 32, chunk 256), the splats moved down with the window; then the render frame
    (`render_view`'s plan) as 2 and as 4 windows of tile rows, each `_window_proj` ->
    `build_sorted_instances(tile_y0)` -> K2 with tile_y0, the windows stacked and held
    against the whole frame at atol 1e-5. -> the phase's numbers"""
    import torch

    from tpu_splat_torch.ops.cuda.blend import (blend_backward, blend_backward_plain,
                                                blend_forward, blend_forward_plain,
                                                pack_features_bf16)
    from tpu_splat_torch.ops.cuda.raster import build_sorted_instances, feature_table
    from tpu_splat_torch.ops.projection import project
    from tpu_splat_torch.ops.rasterize import assemble_image, blend_instances
    from tpu_splat_torch.parallel.raster_mc import _window_proj
    from tpu_splat_torch.render import max_instances_for

    res = dict(k2_max_abs_err=0.0, k3_rel_err=0.0, cases=0)
    for ts, ch, seed in ((16, 128, 21), (32, 256, 22)):
        (flat, seg, cnt), kw = random_segments(ts, ch, seed, dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        gout = 0.3 * torch.randn((kw["n_tiles"], ts * ts, 8), device=dev, generator=gen)
        owned = torch.zeros(flat.shape[1], dtype=torch.bool, device=dev)
        for s0, c in zip(seg.tolist(), cnt.tolist()):
            owned[s0:s0 + c] = True
        for y0 in (0, 3, 17):
            moved = flat.clone()
            moved[1] += y0 * ts
            for layout, fl in (("f32", moved), ("bf16", pack_features_bf16(moved))):
                kwy = dict(kw, tile_y0=y0)
                fwd = blend_forward(fl, seg, cnt, **kwy)
                fwd_plain = blend_forward_plain(fl, seg, cnt, **kwy)
                err = check_blend(fwd, fwd_plain, f"K2 {layout} tile_y0 {y0} {ts}-{ch}")
                bwd_args = (fl, seg, cnt, fwd[1], fwd[0], gout)
                rel = check_blend_bwd(blend_backward(*bwd_args, **kwy),
                                      blend_backward_plain(*bwd_args, **kwy), owned,
                                      f"K3 {layout} tile_y0 {y0} {ts}-{ch}")
                res["k2_max_abs_err"] = max(res["k2_max_abs_err"], err)
                res["k3_rel_err"] = max(res["k3_rel_err"], rel)
                res["cases"] += 1
        # the offset is live: the same segments one window lower blend other pixels
        other = blend_forward(flat, seg, cnt, **dict(kw, tile_y0=3))[0]
        require(max_err(other, blend_forward(flat, seg, cnt, **kw)[0]) > 1e-2,
                "tile_y0 changed nothing")

    gw, gh, ts = -(-WIDTH // TILE_F), -(-HEIGHT // TILE_F), TILE_F
    max_inst = max_instances_for(state.means.shape[0])
    with torch.no_grad():
        proj = project(state.means, state.scaling_raw, state.rotation_raw, state.opacity_raw,
                       state.sh0, state.shN, state.alive, torch.eye(4, device=dev),
                       torch.zeros(3, device=dev), focal, focal, WIDTH / 2.0, HEIGHT / 2.0,
                       WIDTH, HEIGHT, 3, tile_size=ts)
        res["windows"] = {}
        for n_win in (2, 4):
            gh_loc = -(-gh // n_win)
            rows, instances = [], 0
            for w in range(n_win):
                y0 = w * gh_loc
                wproj = _window_proj(proj, y0, gh_loc)
                inst = build_sorted_instances(wproj, gw, gh_loc, max_inst, ts, tile_y0=y0,
                                              image_tiles=gw * gh)
                tc, ta, _ = blend_instances(inst, feature_table(wproj), grid_w=gw,
                                            grid_h=gh_loc, tile_size=ts, k_max=K_MAX_F,
                                            chunk=CHUNK_F, tile_y0=y0)
                rows.append(assemble_image(tc, ta, gw, gh_loc, ts, gw * ts, gh_loc * ts)[0])
                instances += int(inst.total_instances)
            img = torch.cat(rows, dim=1)[:, :HEIGHT, :WIDTH]
            torch.cuda.synchronize()
            err = max_err(img, frame_image)
            require(err <= 1e-5, f"{n_win} windows against the whole frame: {err}")
            res["windows"][n_win] = dict(max_abs_err=err, emitted_instances=instances)
    return res


def padded_splat(params, capacity: int, dev, sh_degree: int = 3):
    """The scene's Gaussians in the first rows of a state of `capacity` slots (the rest
    dead), scene scale 3 as `train_setup`'s."""
    from tpu_splat_torch.convert import splat_from_numpy

    n = params["means"].shape[0]
    padded = {}
    for k, v in params.items():
        pad = np.zeros((capacity - n, *v.shape[1:]), np.float32)
        if k == "rotation_raw":
            pad[:, 0] = 1.0
        padded[k] = np.concatenate([v, pad])
    return splat_from_numpy(padded, np.arange(capacity) < n, sh_degree, dev, scene_scale=3.0)


def batch_cameras(n: int, seed: int):
    """n distinct cameras: small rotations and shifts of the identity camera (as
    `write_capture`'s views). -> (w2cs [n, 4, 4], cam_positions [n, 3])"""
    rng = np.random.default_rng(seed)
    w2cs, cpos = [], []
    for _ in range(n):
        ax, ay, az = rng.uniform(-0.03, 0.03, 3)
        c, s_ = np.cos([ax, ay, az]), np.sin([ax, ay, az])
        rx = np.array([[1, 0, 0], [0, c[0], -s_[0]], [0, s_[0], c[0]]])
        ry = np.array([[c[1], 0, s_[1]], [0, 1, 0], [-s_[1], 0, c[1]]])
        rz = np.array([[c[2], -s_[2], 0], [s_[2], c[2], 0], [0, 0, 1]])
        r = (rz @ ry @ rx).astype(np.float32)
        t = rng.uniform(-0.15, 0.15, 3).astype(np.float32)
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3], w2c[:3, 3] = r, t
        w2cs.append(w2c)
        cpos.append(-r.T @ t)
    return np.stack(w2cs), np.stack(cpos).astype(np.float32)


def step_param_grads(fn, params: dict):
    """Runs `fn` (a train step -> (state, stats)) and returns the splat parameter gradients
    its first `torch.autograd.grad` call took (zeros where a leaf had none) and its stats."""
    import torch

    calls, grad = [], torch.autograd.grad

    def recording(*a, **k):
        out = grad(*a, **k)
        calls.append(out)
        return out

    torch.autograd.grad = recording
    try:
        _, st = fn()
    finally:
        torch.autograd.grad = grad
    return [torch.zeros_like(v) if g is None else g
            for v, g in zip(params.values(), calls[0])], st


def batched_step_phase(params, focal, dev, counted, plan) -> dict:
    """`batched-step`: the batched step in a world of one process (a 1x1 mesh) on the scene
    in a state of 2^20 slots, BATCH cameras a step (tile 32, chunk 256, bf16 pack, the
    train phase's plan with 20% more instances) and a gather budget below the capacity,
    so that `compact_visible` runs. Holds the step's parameter gradients against the mean
    of the BATCH single-camera `train_step`s' from the same state (the same kernels and the
    same sort on each camera; only the batch mean's order of adds differs: within 1e-5 of
    each group's largest), counts K1-K4 over BATCHED_STEPS steps with the counts set to 0
    just before (BATCH each a step) and times the step. -> the phase's numbers"""
    import torch

    from tpu_splat_torch.ops.rasterize import rasterize
    from tpu_splat_torch.parallel.mesh import make_mesh
    from tpu_splat_torch.parallel.step import make_batched_train_step
    from tpu_splat_torch.training.train_step import (StepConfig, init_train_state,
                                                     train_step)

    capacity = BATCHED_CAPACITY
    sp = padded_splat(params, capacity, dev, sh_degree=3)
    ts0 = init_train_state(sp, seed=0, device=dev)
    w2cs, cpos = batch_cameras(BATCH, seed=31)
    intr = np.tile(np.asarray([focal, focal, WIDTH / 2.0, HEIGHT / 2.0], np.float32),
                   (BATCH, 1))
    bg = np.zeros(3, np.float32)
    with torch.no_grad():  # targets: the perturbed copy of the scene, as train_setup's
        gts = torch.stack([rasterize(
            sp.means, sp.scaling_raw, sp.rotation_raw, sp.opacity_raw + 1.0,
            sp.sh0 * 0.5 + 0.3, sp.shN, sp.alive, w2cs[b], cpos[b], *intr[b], 0, bg,
            width=WIDTH, height=HEIGHT, max_instances=1 << 22, k_max=1 << 12, chunk=CHUNK_T,
            tile_size=TILE_T, device=dev).image for b in range(BATCH)])
    budget = -(-N_GAUSS // 128) * 128
    plan = dataclasses.replace(plan, max_instances=-(-int(plan.max_instances * 1.2) // 128)
                               * 128, gather_budget=budget)
    require(budget < capacity, "the gather budget must be below the capacity")
    kw = dict(width=WIDTH, height=HEIGHT, plan=plan, opt=StepConfig(), total_iterations=30_000)
    step = make_batched_train_step(make_mesh(1))
    grads_of = functools.partial(step_param_grads, params=ts0.splat.params())
    noise = torch.zeros((capacity, 3), device=dev)
    g_batch, st_b = grads_of(lambda: step(ts0, gts, w2cs, cpos, intr, bg, noise=noise, **kw))
    single = [grads_of(lambda b=b: train_step(ts0, gts[b], w2cs[b], cpos[b], *intr[b], bg,
                                              plan=dataclasses.replace(plan, gather_budget=None),
                                              noise=noise, **{k: v for k, v in kw.items()
                                                              if k != "plan"}))[0]
              for b in range(BATCH)]
    torch.cuda.synchronize()
    rel = {}
    for name, gb, *gs in zip(ts0.splat.params(), g_batch, *single):
        want = sum(gs) / BATCH
        scale = float(want.abs().max())
        rel[name] = max_err(gb, want) / scale if scale > 0 else max_err(gb, want)
        require(rel[name] <= 1e-5, f"batched gradient of {name}: {rel[name]} of {scale}")
    require(int(st_b.n_shard_visible) <= budget < capacity
            and int(st_b.total_instances) <= plan.max_instances
            and int(st_b.max_tile_count) <= plan.k_max, ("batched step overflow", st_b, plan))
    del single, g_batch

    for fn in counted:
        fn.launches = 0
    ts, wall, losses = ts0, [], []
    for _ in range(BATCHED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, st = step(ts, gts, w2cs, cpos, intr, bg, **kw)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(st.loss))
    launches = {fn.__name__: fn.launches for fn in counted}
    require(all(launches[fn.__name__] == (BATCH * BATCHED_STEPS if fn in counted[:4] else 0)
                for fn in counted), f"K1-K4 must launch {BATCH} times a step: {launches}")
    require(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
            ("batched losses", losses))
    step_ms = statistics.median(wall[2:])
    return dict(batch=BATCH, steps=BATCHED_STEPS, capacity=capacity, gaussians=N_GAUSS,
                width=WIDTH, height=HEIGHT, plan=dataclasses.asdict(plan),
                n_shard_visible=int(st_b.n_shard_visible), grad_rel_err=rel,
                grad_rel_err_bound=1e-5, step_ms=step_ms, step_ms_all=wall,
                cameras_per_s=BATCH * 1e3 / step_ms, launches=launches, losses=losses)


def batched_gut_step_phase(params, focal, dev, counted, plan) -> dict:
    """`batched-gut-step`: the batched step through the GUT blend in a world of one process
    (a 1x1 mesh) on the scene in 2^20 slots, BATCH cameras a step with radial k1 = 0.05
    handed over per camera as the Trainer hands it, the GUT phase's plan (tile 32, float32
    features) with 20% more instances and a gather budget below the capacity, so that
    `compact_visible` packs the 16 GUT feature columns beside the projection. K5 and K6
    run on each window's world rays (`pixel_world_rays(tile_y0=)`). Holds the step's
    parameter gradients through the kernels against the same step through the plain
    versions (within 1e-3 of each group's largest, as `gut-gradient-parity`) and against
    the mean of the BATCH single-camera GUT `train_step`s' (the same kernels on the same
    rays: within 1e-5), counts the kernels over BATCHED_GUT_STEPS steps with the counts set
    to 0 just before (K1, K5, K6, K4, the UT projection and the world rays BATCH times a
    step; K2, K3 and K7 none) and times
    the step. -> the phase's numbers"""
    import torch

    from tpu_splat_torch.ops.cameras import CameraParams
    from tpu_splat_torch.ops.gut import rasterize_gut
    from tpu_splat_torch.parallel.mesh import make_mesh
    from tpu_splat_torch.parallel.step import make_batched_train_step
    from tpu_splat_torch.training.train_step import (StepConfig, init_train_state,
                                                     train_step)

    coeffs = CameraParams(radial=(0.05, 0.0, 0.0, 0.0, 0.0, 0.0))
    d12 = np.asarray(coeffs.coeff_vector(), np.float32)
    dist = np.tile(d12, (BATCH, 1))
    capacity = BATCHED_CAPACITY
    sp = padded_splat(params, capacity, dev, sh_degree=3)
    ts0 = init_train_state(sp, seed=0, device=dev)
    w2cs, cpos = batch_cameras(BATCH, seed=37)
    intr = np.tile(np.asarray([focal, focal, WIDTH / 2.0, HEIGHT / 2.0], np.float32),
                   (BATCH, 1))
    bg = np.zeros(3, np.float32)
    with torch.no_grad():  # targets: the perturbed copy of the scene, as train_setup's
        gts = torch.stack([rasterize_gut(
            sp.means, sp.scaling_raw, sp.rotation_raw, sp.opacity_raw + 1.0,
            sp.sh0 * 0.5 + 0.3, sp.shN, sp.alive, w2cs[b], cpos[b], *intr[b], 0, bg,
            cam_params=coeffs, width=WIDTH, height=HEIGHT, max_instances=1 << 22,
            k_max=1 << 12, tile_size=TILE_T, device=dev).image for b in range(BATCH)])
    budget = -(-N_GAUSS // 128) * 128
    plan = dataclasses.replace(plan, max_instances=-(-int(plan.max_instances * 1.2) // 128)
                               * 128, gather_budget=budget)
    require(budget < capacity, "the gather budget must be below the capacity")
    kw = dict(width=WIDTH, height=HEIGHT, plan=plan, total_iterations=30_000,
              opt=StepConfig(gut=True, cam_params=CameraParams()))
    step = make_batched_train_step(make_mesh(1))
    grads_of = functools.partial(step_param_grads, params=ts0.splat.params())
    noise = torch.zeros((capacity, 3), device=dev)
    runs = {impl: grads_of(lambda impl=impl: step(ts0, gts, w2cs, cpos, intr, bg, None, dist,
                                                  noise=noise, impl=impl, **kw))
            for impl in ("kernel", "plain")}
    g_kernel, st_b = runs["kernel"]
    single_kw = dict(kw, plan=dataclasses.replace(plan, gather_budget=None))
    single = [grads_of(lambda b=b: train_step(ts0, gts[b], w2cs[b], cpos[b], *intr[b], bg, 0,
                                              d12, noise=noise, **single_kw))[0]
              for b in range(BATCH)]
    torch.cuda.synchronize()
    rel = dict(plain={}, single_mean={})
    for name, gk, gp, *gs in zip(ts0.splat.params(), g_kernel, runs["plain"][0], *single):
        for label, want, bound in (("plain", gp, 1e-3), ("single_mean", sum(gs) / BATCH, 1e-5)):
            scale = float(want.abs().max())
            rel[label][name] = max_err(gk, want) / scale if scale > 0 else max_err(gk, want)
            require(rel[label][name] <= bound,
                    f"batched GUT gradient of {name} ({label}): {rel[label][name]} of {scale}")
    require(int(st_b.n_shard_visible) <= budget < capacity
            and int(st_b.total_instances) <= plan.max_instances
            and int(st_b.max_tile_count) <= plan.k_max, ("batched GUT overflow", st_b, plan))
    require(abs(float(st_b.loss) - float(runs["plain"][1].loss)) <= 1e-5 * float(st_b.loss),
            ("batched GUT loss, kernels against plain", float(st_b.loss),
             float(runs["plain"][1].loss)))
    del single, runs, g_kernel

    for fn in counted:
        fn.launches = 0
    ts, wall, losses = ts0, [], []
    for _ in range(BATCHED_GUT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, st = step(ts, gts, w2cs, cpos, intr, bg, None, dist, **kw)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(st.loss))
    launches = {fn.__name__: fn.launches for fn in counted}
    per_step = ("expand_emission", "segsum_emission", "gut_blend_forward",
                "gut_blend_backward", "ut_project_kernel", "pixel_world_rays_kernel")
    require(all(n == (BATCH * BATCHED_GUT_STEPS if k in per_step else 0)
                for k, n in launches.items()),
            f"K1, K4, K5, K6, the UT projection and the world rays must launch {BATCH} "
            f"times a step, the others never: {launches}")
    require(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
            ("batched GUT losses", losses))
    step_ms = statistics.median(wall[2:])
    return dict(batch=BATCH, steps=BATCHED_GUT_STEPS, capacity=capacity, gaussians=N_GAUSS,
                camera="pinhole, radial k1 = 0.05 per camera", width=WIDTH, height=HEIGHT,
                plan=dataclasses.asdict(plan), n_shard_visible=int(st_b.n_shard_visible),
                grad_rel_err=rel, grad_rel_err_bound=dict(plain=1e-3, single_mean=1e-5),
                step_ms=step_ms, step_ms_all=wall, cameras_per_s=BATCH * 1e3 / step_ms,
                launches=launches, losses=losses)


def mesh_2rank_phase(dev) -> dict:
    """`mesh-2rank`: `parallel/dryrun.py` at the render scene's size (1M Gaussians, 2^20
    slots, 1296x840, tile 32, chunk 256, SH degree 1, B = 2 distinct cameras): two steps,
    a refine on the gathered state and one more step, in a world of one process and over
    two gloo processes sharing the card as meshes (1, 2) and (2, 1), against the world of
    one: the losses before the refine within 1e-5 and after it within 1e-3, the refine's
    counts and the alive mask equal, and the share of gathered parameter entries more than
    1e-5 + 1e-5 |x| away: at most 1e-3 before the refine (Adam's first steps move an entry
    by lr * sign(g), and a gradient summed over two windows in another order can change
    sign where it is near zero), reported after it (a relocation samples its sources from
    the opacities' running sum, which such an entry shifts, and the shifted picks are
    other Gaussians' copies). NCCL across cards is not run: the machine has one card."""
    from tpu_splat_torch.parallel import dryrun

    scene = dryrun.Scene(n_gauss=N_GAUSS, capacity=BATCHED_CAPACITY, width=WIDTH,
                         height=HEIGHT, batch=2, tile_size=TILE_T, chunk=CHUNK_T, sh_degree=1,
                         scale=0.004)
    device = f"cuda:{dev.index or 0}" if dev.type == "cuda" else str(dev)
    t0 = time.perf_counter()
    one = dryrun.run(1, 1, scene, device, steps=2)
    res = dict(scene=dataclasses.asdict(scene), world1=dict(
        losses=one["losses"], step_s=one["step_s"], refine=one["refine"],
        counts=one["counts"], seconds=time.perf_counter() - t0))
    for data in (1, 2):
        t0 = time.perf_counter()
        got = dryrun.run(2, data, scene, device, steps=2, timeout=900)
        far = {when: {k: float(np.mean(np.abs(got[when][k] - want)
                                       > 1e-5 + 1e-5 * np.abs(want)))
                      for k, want in one[when].items()}
               for when in ("params_before_refine", "params")}
        rel = [abs(a - b) / abs(b) for a, b in zip(got["losses"], one["losses"])]
        tag = f"mesh {data}x{2 // data}"
        res[f"mesh_{data}x{2 // data}"] = dict(
            losses=got["losses"], loss_rel_err=rel, step_s=got["step_s"],
            refine=got["refine"], counts=got["counts"],
            far_share_before_refine=far["params_before_refine"],
            far_share_after_refine=far["params"], seconds=time.perf_counter() - t0)
        require(got["mesh"] == (data, 2 // data), got["mesh"])
        require(max(rel[:-1]) <= 1e-5 and rel[-1] <= 1e-3, (f"{tag} losses", rel))
        require(got["refine"] == one["refine"] and np.array_equal(got["alive"], one["alive"]),
                (f"{tag} refine", got["refine"], one["refine"]))
        require(max(far["params_before_refine"].values()) <= 1e-3,
                (f"{tag} parameters before the refine", far))
    return res


def trainer_batched_phase(root: Path, dev, counted) -> dict:
    """`trainer-batched`: the CLI (in this process, so that launches are counted) with
    `--batch-size BATCH` on the trainer phase's capture: TRAINER_BATCHED_ITERS iterations,
    evals at 8 and the last. -> it/s, images/s, PSNR, launches"""
    import torch

    from tpu_splat_torch.cli import main as cli_main
    from tpu_splat_torch.training import trainer as trainer_mod

    cfg = root / "batched.json"
    last = TRAINER_BATCHED_ITERS
    cfg.write_text(json.dumps(dict(
        max_cap=1_000_000, sh_degree=3, sh_degree_interval=last // 4, refine_every=8,
        start_refine=8, stop_refine=last - 4, eval_steps=[8, last], save_steps=[last],
        enable_save_eval_images=False, num_workers=8)))
    kept, train = [], trainer_mod.Trainer.train

    def recording_train(self, *a, **k):
        kept.append(self)
        self.initial_plan = self.plan
        torch.cuda.synchronize()
        for fn in counted:
            fn.launches = 0
        t0 = time.perf_counter()
        try:
            return train(self, *a, **k)
        finally:
            torch.cuda.synchronize()
            self.wall_s = time.perf_counter() - t0

    trainer_mod.Trainer.train = recording_train
    try:
        rc = cli_main(["-d", str(root / "capture"), "-o", str(root / "batched"), "--headless",
                       "--config", str(cfg), "-i", str(last), "--eval", "--test-every", "6",
                       "--batch-size", str(BATCH)])
    finally:
        trainer_mod.Trainer.train = train
    launches = {fn.__name__: fn.launches for fn in counted}
    (t,) = kept
    require(rc == 0 and (root / "batched" / "splat_final.ply").exists(), "batched CLI run")
    require(t.mesh is not None and t.mesh.shape == {"data": 1, "gauss": 1}, t.mesh)
    steps, evals = t.steps_dispatched, t.eval_renders
    require(all(launches[k] == BATCH * steps + evals for k in ("expand_emission",
                                                               "blend_forward"))
            and all(launches[k] == BATCH * steps for k in ("blend_backward",
                                                           "segsum_emission"))
            and all(launches[k] == 0 for k in NO_PINHOLE_LAUNCH),
            f"K1-K4 must launch {BATCH} times a step (K1, K2 once more an eval render): "
            f"{launches}, {steps} steps, {evals} eval renders")
    require(len(t._loss_hist) == last and all(math.isfinite(v) for v in t._loss_hist),
            "batched trainer losses")
    res = trainer_summary(t, launches, t.wall_s)
    psnrs = [e["psnr"] for e in res["evals"]]
    require(len(psnrs) == 2 and psnrs[-1] > psnrs[0], ("batched eval PSNR did not rise", psnrs))
    res.update(batch=BATCH, images_per_s=BATCH * res["it_per_s"],
               images_per_s_without_eval_and_save=BATCH * res["it_per_s_without_eval_and_save"],
               psnr=psnrs, gather_budget=t.plan.gather_budget)
    return res


def segred_random_phases(dev) -> dict:
    """K4 and K7 on random runs: 200,000 Gaussians, a quarter of them with empty runs, one
    run of 300,000 slots (it spans 293 of K7's 1024-slot blocks), 1000 tail slots that
    repeat the last owner (K7's convention), rows over eleven decades of magnitude. The rows
    are tile-sorted by a random permutation and read through its inverse, the
    emission->column index, as the train step reads them, and also in emission order
    without it (the JAX kernels' contract). Each kernel against its plain version; K4
    bit-equal on runs of at most 64 slots to the plain version and to the gather followed
    by K4; both kernels bit-equal on two launches; K7 also on an axis shorter than one
    block and on one that ends in a partial block. -> the largest errors."""
    import torch

    from tpu_splat_torch.ops.cuda.raster import (emission_columns, emission_order,
                                                 segred_prefix, segred_prefix_plain,
                                                 segsum_emission, segsum_emission_plain)

    rng = np.random.default_rng(4)
    run_len = rng.integers(0, 9, 200_000)
    run_len[rng.random(run_len.size) < 0.25] = 0
    run_len[70_000] = 300_000
    run_end = np.cumsum(run_len)
    m = int(run_end[-1]) + 1000
    start = torch.from_numpy((run_end - run_len).astype(np.int32)).to(dev)
    end = torch.from_numpy(run_end.astype(np.int32)).to(dev)
    last_owner = int(np.nonzero(run_len)[0][-1])
    rank = torch.from_numpy(np.concatenate([
        np.repeat(np.arange(run_len.size, dtype=np.int32), run_len),
        np.full(1000, last_owner, np.int32)])).to(dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    result = dict(runs=int(run_len.size), empty_runs=int((run_len == 0).sum()),
                  longest_run=int(run_len.max()), slots=m, k4_max_abs_err=0.0,
                  k7_max_abs_err=0.0)
    for n_rows in (10, 17):
        rows = torch.randn((n_rows, m), device=dev, generator=gen)
        # magnitudes over eleven decades, as gradient rows have
        rows *= torch.pow(10.0, torch.randint(-8, 3, (1, m), device=dev,
                                                generator=gen).float())
        sorted_emis = torch.randperm(m, device=dev, generator=gen).to(torch.int32)
        gflat = rows.index_select(1, sorted_emis.long())  # column c is slot sorted_emis[c]
        cols = emission_columns(sorted_emis)
        require(torch.equal(emission_order(gflat, sorted_emis), rows), "emission_order")
        tag = f"random runs, {n_rows} rows"
        k4 = segsum_emission(gflat, start, end, cols)
        k4_plain = segsum_emission_plain(gflat, start, end, cols)
        k4_emis = segsum_emission(rows, start, end)
        err4 = max(check_segsum(k4, k4_plain, rows, start, end, f"K4 {tag}"),
                   check_segsum(k4_emis, k4_plain, rows, start, end, f"K4 {tag}, emission order"))
        require(torch.equal(segsum_emission(gflat, start, end, cols), k4), f"K4 {tag}: repeat")
        n_short = check_segsum_bits(k4, {"the plain version": k4_plain,
                                         "the gather + K4": k4_emis}, start, end, f"K4 {tag}")
        k7 = segred_prefix(gflat, rank, cols)
        k7_plain = segred_prefix_plain(rows, rank)
        err7 = max(check_prefix(k7, k7_plain, rows, rank, f"K7 {tag}"),
                   check_prefix(segred_prefix(rows, rank), k7_plain, rows, rank,
                                f"K7 {tag}, emission order"))
        require(torch.equal(segred_prefix(gflat, rank, cols), k7), f"K7 {tag}: repeat")
        # K7 on an axis shorter than one block, and on one of five blocks and a part
        for mm in (700, 5 * 1024 + 77):
            r_mm, k_mm = rows[:, :mm].contiguous(), rank[:mm].contiguous()
            perm_mm = torch.randperm(mm, device=dev, generator=gen).to(torch.int32)
            g_mm = r_mm.index_select(1, perm_mm.long())
            got = segred_prefix(g_mm, k_mm, emission_columns(perm_mm))
            err7 = max(err7, check_prefix(got, segred_prefix_plain(r_mm, k_mm), r_mm, k_mm,
                                          f"K7 {tag}, {mm} slots"))
        torch.cuda.synchronize()
        result["k4_max_abs_err"] = max(result["k4_max_abs_err"], err4)
        result["k7_max_abs_err"] = max(result["k7_max_abs_err"], err7)
        result[f"k4_{n_rows}_short_runs_bit_equal"] = n_short
    phase("k4-k7-random", **result)
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    from tpu_splat_torch.cli import main as cli_main
    from tpu_splat_torch.convert import splat_from_numpy
    from tpu_splat_torch.io.ply import save_splat_ply
    from tpu_splat_torch.ops.cuda import build
    from tpu_splat_torch.ops.cuda.blend import (blend_backward, blend_backward_plain,
                                                blend_forward, blend_forward_plain,
                                                pack_features_bf16, unpack_features)
    from tpu_splat_torch.ops.cuda.gut_kernels import (gut_blend_backward,
                                                      gut_blend_backward_plain,
                                                      gut_blend_forward,
                                                      gut_blend_forward_plain)
    from tpu_splat_torch.ops.cuda.gut_project import (pixel_world_rays_kernel,
                                                      ut_project_kernel)
    from tpu_splat_torch.ops.cuda import raster
    from tpu_splat_torch.ops.cuda.raster import (build_sorted_instances, emission_tables,
                                                 expand_emission, expand_emission_plain,
                                                 feature_table, segmented_grad_reduce,
                                                 segred_prefix, segsum_emission)
    from tpu_splat_torch.ops.projection import project
    from tpu_splat_torch.ops.rasterize import (blend_inputs, blend_instances, compose_output,
                                               rasterize)
    from tpu_splat_torch.render import max_instances_for, render_view
    from tpu_splat_torch.training import strategy_mcmc
    from tpu_splat_torch.training.losses import photometric_loss, regularization_losses
    from tpu_splat_torch.training.optim import adam_step, group_lrs, means_lr_at
    from tpu_splat_torch.training.train_step import RasterPlan, refine_step, train_step

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {kind} | nvidia-smi: {smi}", flush=True)
    counted = (expand_emission, blend_forward, blend_backward, segsum_emission,
               gut_blend_forward, gut_blend_backward, segred_prefix, ut_project_kernel,
               pixel_world_rays_kernel)
    render_kernels = ("expand_emission", "blend_forward")  # the render path's two

    # -- build every kernel of the path from the checkout's sources
    t0 = time.perf_counter()
    libs = build.build_all()
    regs = ptxas_lines("".join(build.build_log(name) for name in libs))
    phase("build", seconds=round(time.perf_counter() - t0, 3),
          libraries=[str(p.name) for p in libs.values()], ptxas=regs)

    # -- K2 against its plain version on random unaligned segments, and on segments whose
    # splats sit on the warp sub-rectangles' borders with opacities near 1/255
    k2_random_err = k2b_random_err = k3_random_err = 0.0
    for ts, ch, seed, borders in ((16, 128, 1, False), (32, 256, 2, False), (16, 128, 3, True),
                                  (32, 256, 4, True)):
        tag = f"{ts}-{ch}" + ("-borders" if borders else "")
        args, kw = random_segments(ts, ch, seed, dev, borders)
        got = blend_forward(*args, **kw)
        want = blend_forward_plain(*args, **kw)
        torch.cuda.synchronize()
        err = check_blend(got, want, f"K2 random {tag}")
        k2_random_err = max(k2_random_err, err)
        # pixels that stopped early: a zero checkpoint in a chunk their tile has
        n_chunks = (args[2] + ch - 1) // ch
        visited = torch.arange(kw["max_chunks"], device=dev) < n_chunks[:, None, None]
        stopped = float(((want[1] == 0) & visited).any(-1).float().mean())
        phase(f"k2-random-{tag}", max_abs_err=err, stopped_pixel_share=stopped)
        # K2 in the bf16 layout, and K3 in both layouts, on the same segments
        gen = torch.Generator(device=dev).manual_seed(seed)
        gout = 0.3 * torch.randn(got[0].shape, device=dev, generator=gen)
        owned = torch.zeros(args[0].shape[1], dtype=torch.bool, device=dev)
        for s0, c in zip(args[1].tolist(), args[2].tolist()):
            owned[s0:s0 + c] = True
        for layout, flat_l in (("f32", args[0]), ("bf16", pack_features_bf16(args[0]))):
            fwd = blend_forward(flat_l, *args[1:], **kw)
            fwd_plain = blend_forward_plain(flat_l, *args[1:], **kw)
            err = check_blend(fwd, fwd_plain, f"K2 {layout} random {tag}")
            k2b_random_err = max(k2b_random_err, err if layout == "bf16" else 0.0)
            pairs = check_stops(fwd[1], fwd_plain[1], unpack_features(flat_l), args[1:], kw,
                                f"K2 {layout} random {tag}")
            bwd_args = (flat_l, *args[1:], fwd[1], fwd[0], gout)
            gflat = blend_backward(*bwd_args, **kw)
            gflat_plain = blend_backward_plain(*bwd_args, **kw)
            torch.cuda.synchronize()
            rel = check_blend_bwd(gflat, gflat_plain, owned, f"K3 {layout} random {tag}")
            check_blend_bwd_repeats(blend_backward, *bwd_args, label=f"K3 {layout} {tag}", **kw)
            k3_random_err = max(k3_random_err, rel)
            phase(f"k3-random-{tag}-{layout}", k2_max_abs_err=err, k3_rel_err=rel,
                  k3_max_abs_grad=float(gflat_plain.abs().max()), pairs=pairs)

    # -- K4 and K7 against their plain versions on random runs, through the emission->column
    # index and in emission order
    segred_random = segred_random_phases(dev)

    # -- K5 and K6 against their plain versions on random unaligned segments, rays 4 and 8
    # wide (8: per-pixel origin offsets), and on segments whose splats graze the kernels'
    # warp ray cones through the four GUT camera models
    k5_random_err = k6_random_err = 0.0
    cases = [(f"random-{ts}-{ch}-rays{w}", random_gut_segments(ts, ch, seed, dev, w))
             for ts, ch, seed in ((16, 128, 11), (32, 256, 12)) for w in (4, 8)]
    cases += [(f"cull-border-{model}-{ts}-{ch}", gut_border_segments(model, ts, ch, seed, dev))
              for model, ts, ch, seed in (("pinhole", 32, 128, 13), ("fisheye", 16, 128, 14),
                                          ("ortho", 16, 256, 15), ("rolling", 32, 256, 16))]
    for tag, (args, kw) in cases:
        k5_err, k6_err, pairs = check_gut_kernels(args, kw, f"K5/K6 {tag}")
        k5_random_err, k6_random_err = max(k5_random_err, k5_err), max(k6_random_err, k6_err)
        phase(f"k5-k6-{tag}", k5_max_abs_err=k5_err, k6_rel_err=k6_err, pairs=pairs)
    del cases

    # -- the main path: render_view of the full-width scene
    params, focal = build_workload(N_GAUSS, WIDTH, HEIGHT)
    state = splat_from_numpy(params, np.ones(N_GAUSS, bool), 3, dev, scene_scale=3.0)
    w2c = np.eye(4, dtype=np.float32)
    fov = math.degrees(2 * math.atan(0.5 * WIDTH / focal))
    max_inst = max_instances_for(N_GAUSS)
    for fn in counted:
        fn.launches = 0
    out = render_view(state, w2c, WIDTH, HEIGHT, fov, device=dev)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counted}
    aux = {k: int(getattr(out.aux, k)) for k in ("total_instances", "max_tile_count",
                                                  "n_visible")}
    require(all(launches[k] > 0 for k in render_kernels),
            f"a kernel did not launch: {launches}")
    require(0 < aux["total_instances"] <= max_inst, aux)
    require(0 < aux["max_tile_count"] <= 4096, aux)
    require(out.image.shape == (3, HEIGHT, WIDTH), f"image shape {tuple(out.image.shape)}")
    require(bool(torch.isfinite(out.image).all()), "non-finite image")
    require(0.0 <= float(out.alpha.min()) and float(out.alpha.max()) <= 1.0, "alpha range")
    plain = render_view(state, w2c, WIDTH, HEIGHT, fov, device=dev, impl="plain")
    torch.cuda.synchronize()
    img_err = max_err(out.image, plain.image)
    alpha_err = max_err(out.alpha, plain.alpha)
    require(img_err <= 1e-4 and alpha_err <= 1e-4, (img_err, alpha_err))
    phase("render-view", launches=launches, max_instances=max_inst, **aux,
          mean_alpha=float(out.alpha.mean()), image_err_vs_plain=img_err,
          alpha_err_vs_plain=alpha_err)

    # -- both kernels against their plain versions at the frame's own shapes
    f = 0.5 * WIDTH / math.tan(math.radians(fov) / 2)
    proj, inst, (flat, seg_start, count), bkw = frame_blend_inputs(state, f, dev)
    gw, gh, ts, chunk = -(-WIDTH // TILE_F), -(-HEIGHT // TILE_F), TILE_F, CHUNK_F
    proj_args = (state.means, state.scaling_raw, state.rotation_raw, state.opacity_raw,
                 state.sh0, state.shN, state.alive, torch.eye(4, device=dev),
                 torch.zeros(3, device=dev), f, f, WIDTH / 2.0, HEIGHT / 2.0, WIDTH, HEIGHT, 3)
    ftab, itab, offs_incl = emission_tables(proj)
    k1 = expand_emission(ftab, itab, offs_incl, max_inst)
    k1_plain = expand_emission_plain(ftab, itab, offs_incl, max_inst)
    torch.cuda.synchronize()
    require(torch.equal(k1[0], k1_plain[0]) and torch.equal(k1[1], k1_plain[1]), "K1 differs")
    k1_err = max(max_err(k1[0], k1_plain[0]), max_err(k1[1], k1_plain[1]))
    require(int(k1[1][0].max()) < N_GAUSS and int(k1[1][1].max()) < max_inst,
            "K1 owner or rect-walk index out of range")
    k2 = blend_forward(flat, seg_start, count, **bkw)
    k2_plain = blend_forward_plain(flat, seg_start, count, **bkw)
    torch.cuda.synchronize()
    k2_err = check_blend(k2, k2_plain, "K2 frame")
    pairs = check_stops(k2[1], k2_plain[1], flat, (seg_start, count), bkw, "K2 frame")
    phase("kernel-parity-frame", k1_max_abs_err=k1_err, k2_max_abs_err=k2_err,
          k2_random_max_abs_err=k2_random_err, k2_pairs=pairs)

    # -- K2/K3 with a tile-row offset, and the frame as windows of tile rows
    window = window_phases(state, f, out.image, dev)
    phase("k2k3-window", **window)

    # -- times at the frame's shapes
    k1_ms = cuda_ms(lambda: expand_emission(ftab, itab, offs_incl, max_inst), 20)
    k1_plain_ms = cuda_ms(lambda: expand_emission_plain(ftab, itab, offs_incl, max_inst), 5)
    # one [11, N + 1] row table; column N catches the unowned tail slots
    table = torch.cat([ftab, itab.view(torch.float32)])
    table = torch.cat([table, table[:, -1:]], dim=1)
    slots = torch.arange(max_inst, dtype=torch.int32, device=dev)

    def library_expand():  # two PyTorch calls: searchsorted + one row index_select
        owner = torch.searchsorted(offs_incl, slots, right=True, out_int32=True)
        return table.index_select(1, owner)

    k1_lib_ms = cuda_ms(library_expand, 20)
    k2_ms = cuda_ms(lambda: blend_forward(flat, seg_start, count, **bkw), 20)
    k2_plain_ms = cuda_ms(lambda: blend_forward_plain(flat, seg_start, count, **bkw), 3,
                          warmup=1)

    n_inst = int(count.sum())
    k1_bytes = 4 * (12 * N_GAUSS + 13 * max_inst)
    k2_bytes = 4 * (10 * n_inst + 2 * gw * gh) + 4 * gw * gh * ts * ts * (8 + bkw["max_chunks"])
    k2_ops = K2_OPS_PER_PAIR * (pairs["used"] + pairs["stops"])
    k2_bound = bound_ms(k2_bytes, k2_ops)
    kernels = [
        dict(name="expand", route="cuda", source="tpu_splat_torch/csrc/expand.cu",
             shapes="render frame, 2^24 slots",
             replaces="tpu_splat/ops/pallas/raster.py:61", launches=launches["expand_emission"],
             max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain_ms,
             bound_ms=k1_bytes / PEAK_BYTES_S * 1e3, bound_by="bytes", library_ms=k1_lib_ms),
        dict(name="blend_fwd", route="cuda", source="tpu_splat_torch/csrc/blend_fwd.cu",
             shapes="render frame, f32 layout, tile 16, chunk 128",
             replaces="tpu_splat/ops/pallas/blend.py:370", launches=launches["blend_forward"],
             max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain_ms, bound_ms=k2_bound[0],
             bound_by=k2_bound[1], library_ms=None),
    ]
    phase("kernel-times", k1_bytes=k1_bytes, k2_bytes=k2_bytes, k2_ops=k2_ops,
          k2_pairs=pairs, k2_instances=n_inst, k2_pairs_if_no_stop=n_inst * ts * ts)

    # -- frame time and per-stage split (CUDA events around each stage of rasterize)
    frame_ms = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_view(state, w2c, WIDTH, HEIGHT, fov, device=dev)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
    stage_ms = {k: [] for k in ("project", "instances", "blend", "assemble")}
    bg = torch.zeros(3, device=dev)
    for _ in range(6):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        p = project(*proj_args, tile_size=ts)
        ev[1].record()
        si = build_sorted_instances(p, gw, gh, max_inst, ts)
        ev[2].record()
        tiles = blend_instances(si, feature_table(p), grid_w=gw, grid_h=gh, tile_size=ts,
                                k_max=K_MAX_F, chunk=chunk)
        ev[3].record()
        compose_output(*tiles, bg, grid_w=gw, grid_h=gh, tile_size=ts, width=WIDTH,
                       height=HEIGHT, render_mode="RGB")
        ev[4].record()
        ev[4].synchronize()
        for i, k in enumerate(stage_ms):
            stage_ms[k].append(ev[i].elapsed_time(ev[i + 1]))
    frame = dict(frame_ms=statistics.median(frame_ms[1:]),
                 stage_ms={k: statistics.median(v[1:]) for k, v in stage_ms.items()},
                 width=WIDTH, height=HEIGHT, gaussians=N_GAUSS, tile_size=ts, chunk=chunk,
                 max_instances=max_inst, **aux)
    del k1, k1_plain, k2, k2_plain, plain, table, slots
    torch.cuda.empty_cache()

    # -- the CLI: orbit of a 100k-Gaussian PLY written by the port
    cli_params, _ = build_workload(CLI_GAUSS, WIDTH, HEIGHT, seed=1)
    with tempfile.TemporaryDirectory() as tmp:
        ply = Path(tmp) / "model.ply"
        save_splat_ply(ply, **cli_params)
        for fn in counted:
            fn.launches = 0
        rc = cli_main(["--view", str(ply), "-o", str(Path(tmp) / "out"), "--view-frames",
                       "3"])
        cli_launches = {fn.__name__: fn.launches for fn in counted}
        pngs = sorted((Path(tmp) / "out").glob("frame_*.png"))
        require(rc == 0 and len(pngs) == 3, (rc, pngs))
        for png in pngs:
            head = png.read_bytes()[:24]
            require(head[:8] == b"\x89PNG\r\n\x1a\n", png)
            require(head[16:24] == struct.pack(">II", 1280, 720), png)  # the CLI's default
        require(all(cli_launches[k] == 3 for k in render_kernels), cli_launches)
    phase("cli", frames=len(pngs), launches=cli_launches)

    # ======================= the serving side =======================
    # SOG export and import of the scene, --view of the .sog with a crop box, a point-cloud
    # and an SH-degree-4 frame, SH 4 train steps, the web viewer
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        sog_res = sog_phase(params, tmp / "scene.sog", dev)
        phase("sog", **sog_res)
        torch.cuda.empty_cache()
        view_sog = view_sog_phase(tmp / "scene.sog", params, focal, dev, counted, tmp)
        phase("view-sog", **view_sog)
        save_splat_ply(tmp / "scene.ply", **params)
        save_splat_ply(tmp / "compare.ply", **cli_params)
        viewer_res = viewer_phase(tmp / "scene.ply", tmp / "compare.ply", dev, counted)
        phase("viewer", **viewer_res)
        torch.cuda.empty_cache()
    serving = dict(sog=sog_res, view_sog=view_sog, viewer=viewer_res)


    # ======================= the training path =======================
    del state, proj, inst, flat, ftab, itab, offs_incl, out
    torch.cuda.empty_cache()
    ts0, target, cam, bg0, plan, step_kw = train_setup(params, focal, dev)
    splat, cfg = ts0.splat, step_kw["opt"]
    n_alive0 = int(ts0.splat.n_alive())

    # -- the main path of this slice: train steps and a refine step, launches counted
    for fn in counted:
        fn.launches = 0
    ts, stats, step_wall = ts0, [], []
    with calls_counted(raster, "emission_order") as gathers:
        for _ in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ts, st = train_step(ts, target, *cam, bg0, 0, plan=plan, **step_kw)
            torch.cuda.synchronize()
            step_wall.append((time.perf_counter() - t0) * 1e3)
            stats.append(st)
    require(gathers[0] == 0, "a train step gathered its gradient rows to emission order")
    n_alive_trained = int(ts.splat.n_alive())
    ts_refined, info = refine_step(ts, min_opacity=0.005, max_cap=N_GAUSS)
    torch.cuda.synchronize()
    train_launches = {fn.__name__: fn.launches for fn in counted}
    losses = [float(st.loss) for st in stats]
    totals = [int(st.total_instances) for st in stats]
    ktiles = [int(st.max_tile_count) for st in stats]
    require(all(train_launches[fn.__name__] == (TRAIN_STEPS if fn in counted[:4] else 0)
                for fn in counted),
            f"K1-K4 must launch once a step and no GUT kernel: {train_launches}")
    require(max(totals) <= plan.max_instances and max(ktiles) <= plan.k_max,
            ("overflow", max(totals), max(ktiles), plan))
    require(all(math.isfinite(v) for v in losses), "non-finite loss")
    for state_i in (ts, ts_refined):
        for k, v in state_i.splat.params().items():
            require(bool(torch.isfinite(v).all()), f"non-finite {k}")
    first5, last5 = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    require(last5 < first5, f"the loss did not fall: {first5} -> {last5}")
    require(n_alive_trained == n_alive0 and ts.iteration == TRAIN_STEPS + 1,
            (n_alive_trained, n_alive0, ts.iteration))
    refine_info = {k: int(v) for k, v in info.items()}
    require(refine_info["n_alive"] == n_alive0 + refine_info["n_new"], refine_info)
    phase("train", steps=TRAIN_STEPS, launches=train_launches, plan=dataclasses.asdict(plan),
          total_instances=max(totals), max_tile_count=max(ktiles),
          n_visible=int(stats[-1].n_visible), loss_first5=first5, loss_last5=last5,
          n_alive=n_alive_trained, refine=refine_info)
    del ts_refined, stats
    torch.cuda.empty_cache()

    # -- gradients of rasterize through the kernels against the plain versions, at the
    # train step's own shapes: one forward + backward each, on the trained state
    weight = torch.rand((3, HEIGHT, WIDTH), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(7))
    names = ("means", "scaling_raw", "rotation_raw", "opacity_raw", "sh0", "shN")
    ras_kw = dict(width=WIDTH, height=HEIGHT, max_instances=plan.max_instances,
                  k_max=plan.k_max, chunk=CHUNK_T, tile_size=TILE_T, pack_bf16=True,
                  device=dev)

    def raster_grads(impl):
        leaves = {k: ts.splat.params()[k].detach().requires_grad_(True) for k in names}
        img = rasterize(*(leaves[k] for k in names), ts.splat.alive, *cam, 3, bg0, impl=impl,
                        **ras_kw).image
        return img.detach(), torch.autograd.grad((img * weight).sum(), list(leaves.values()))

    img_k, grads_k = raster_grads("kernel")
    img_p, grads_p = raster_grads("plain")
    torch.cuda.synchronize()
    grad_err = {}
    for k, gk, gp in zip(names, grads_k, grads_p):
        scale = float(gp.abs().max())
        grad_err[k] = max_err(gk, gp) / max(scale, 1e-30)
        # float32 sums in another order over up to 1024 pixels and thousands of instances
        require(scale > 0 and grad_err[k] <= 1e-3, f"gradient of {k}: {grad_err[k]} of {scale}")
    require(max_err(img_k, img_p) <= 1e-4, "train-shape image differs from the plain one")
    phase("gradient-parity", rel_err=grad_err, image_err=max_err(img_k, img_p))
    del img_k, img_p, grads_k, grads_p, weight
    torch.cuda.empty_cache()

    # -- K2-bf16, K3 and K4 against their plain versions on the step's own inputs; times
    sp = ts.splat
    inst_t, (flat_t, seg_t, count_t), gout_t, tkw = train_blend_inputs(sp, cam, plan, dev)
    gw_t, gh_t, maxc_t = -(-WIDTH // TILE_T), -(-HEIGHT // TILE_T), tkw["max_chunks"]
    k2b = blend_forward(flat_t, seg_t, count_t, **tkw)
    k2b_plain = blend_forward_plain(flat_t, seg_t, count_t, **tkw)
    k2b_err = max(check_blend(k2b, k2b_plain, "K2 bf16 train frame"), k2b_random_err)
    bwd_t = (flat_t, seg_t, count_t, k2b[1], k2b[0], gout_t)
    k3 = blend_backward(*bwd_t, **tkw)
    k3_plain = blend_backward_plain(*bwd_t, **tkw)
    n_valid_t = int(count_t.sum())
    # the sort leaves the tiles' segments back to back and none is capped (checked
    # above), so the owned columns are the first n_valid_t
    owned_t = torch.arange(flat_t.shape[1], device=dev) < n_valid_t
    k3_err = max(check_blend_bwd(k3, k3_plain, owned_t, "K3 train frame"), k3_random_err)
    check_blend_bwd_repeats(blend_backward, *bwd_t, label="K3 train frame", **tkw)
    pairs_t = check_stops(k2b[1], k2b_plain[1], unpack_features(flat_t), (seg_t, count_t),
                          tkw, "K2 bf16 train frame")
    torch.cuda.synchronize()

    k2b_ms = cuda_ms(lambda: blend_forward(flat_t, seg_t, count_t, **tkw), 10)
    k2b_plain_ms = cuda_ms(lambda: blend_forward_plain(flat_t, seg_t, count_t, **tkw), 2, warmup=1)
    k3_ms = cuda_ms(lambda: blend_backward(*bwd_t, **tkw), 10)
    k3_plain_ms = cuda_ms(lambda: blend_backward_plain(*bwd_t, **tkw), 2, warmup=1)
    k4 = segsum_step_kernel(k3, inst_t, "K4 train frame")

    n_slots_t = int(inst_t.total_instances)
    tp_t = gw_t * gh_t * TILE_T * TILE_T
    k2b_bytes = 32 * n_valid_t + 8 * gw_t * gh_t + 4 * tp_t * (8 + maxc_t)
    k3_bytes = 32 * n_valid_t + 8 * gw_t * gh_t + 4 * tp_t * (16 + maxc_t) + 40 * n_valid_t
    k2b_ops = K2_OPS_PER_PAIR * (pairs_t["used"] + pairs_t["stops"])
    k3_ops = k2b_ops + K3_OPS_PER_USED_PAIR * pairs_t["used"]

    for name, source, replaces, fn_name, err, ms, plain_ms, (b_ms, b_by), lib in (
        ("blend_fwd_bf16", "blend_fwd.cu", "blend.py:370", "blend_forward", k2b_err, k2b_ms,
         k2b_plain_ms, bound_ms(k2b_bytes, k2b_ops), None),
        ("blend_bwd", "blend_bwd.cu", "blend.py:564", "blend_backward", k3_err, k3_ms,
         k3_plain_ms, bound_ms(k3_bytes, k3_ops), None),
    ):
        kernels.append(dict(
            name=name, route="cuda", source=f"tpu_splat_torch/csrc/{source}",
            shapes="train step, bf16 layout, tile 32, chunk 256",
            replaces=f"tpu_splat/ops/pallas/{replaces}", launches=train_launches[fn_name],
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib))
    kernels.append(kernel_entry(
        "segsum", "segsum.cu", "raster.py:693",
        "train step: K3's tile-sorted rows through emis_col, 10 rows",
        train_launches["segsum_emission"], k4))
    phase("train-kernel-times", k2_bf16_bytes=k2b_bytes, k2_bf16_ops=k2b_ops, k3_bytes=k3_bytes,
          k3_ops=k3_ops, pairs=pairs_t, tile_instances=n_valid_t, emission_slots=n_slots_t,
          k3_rel_err=k3_err, k4=k4)
    del k2b, k2b_plain, k3, k3_plain, inst_t, flat_t, bwd_t
    torch.cuda.empty_cache()

    # -- the step's split: the stages of train_step, each between two CUDA events
    stage_names = ("project", "instances", "pack", "blend_fwd", "loss", "blend_bwd", "segsum",
                   "project_bwd", "adam", "noise")
    split = {k: [] for k in stage_names}
    target_t = target
    lrs = dict(group_lrs(cfg, sp.scene_scale))
    for _ in range(5):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(stage_names) + 1)]
        leaves = {k: v.detach().requires_grad_(True) for k, v in sp.params().items()}
        ev[0].record()
        pr = project(leaves["means"], leaves["scaling_raw"], leaves["rotation_raw"],
                     leaves["opacity_raw"], leaves["sh0"], leaves["shN"], sp.alive,
                     torch.as_tensor(cam[0], device=dev), torch.zeros(3, device=dev), focal,
                     focal, WIDTH / 2.0, HEIGHT / 2.0, WIDTH, HEIGHT, 0, tile_size=TILE_T)
        gtab = feature_table(pr)
        ev[1].record()
        with torch.no_grad():
            si = build_sorted_instances(pr, gw_t, gh_t, plan.max_instances, TILE_T)
            ev[2].record()
            fl, sg, ct, _ = blend_inputs(si, gtab, k_max=plan.k_max, chunk=CHUNK_T,
                                         pack_bf16=True)
            ev[3].record()
            o, c = blend_forward(fl, sg, ct, **tkw)
        ev[4].record()
        o_leaf = o.detach().requires_grad_(True)
        image, _, _ = compose_output(o_leaf[:, :, 0:3], 1.0 - o_leaf[:, :, 3], o_leaf[:, :, 4],
                                     torch.zeros(3, device=dev), grid_w=gw_t, grid_h=gh_t,
                                     tile_size=TILE_T, width=WIDTH, height=HEIGHT,
                                     render_mode="RGB")
        (go,) = torch.autograd.grad(photometric_loss(image, target_t, cfg.lambda_dssim), o_leaf)
        ev[5].record()
        gf = blend_backward(fl, sg, ct, c, o, go.contiguous(), **tkw)
        ev[6].record()
        g_gtab = segmented_grad_reduce(gf, si)
        ev[7].record()
        reg = regularization_losses(leaves, sp.alive, cfg.scale_reg, cfg.opacity_reg)
        grads = torch.autograd.grad([gtab, reg], list(leaves.values()),
                                    [g_gtab, torch.ones_like(reg)], allow_unused=True)
        grads = {k: torch.zeros_like(leaves[k]) if g is None else g
                 for k, g in zip(leaves, grads)}
        ev[8].record()
        lrs["means"] = means_lr_at(group_lrs(cfg, sp.scene_scale)["means"], ts.iteration - 1,
                                   30_000)
        new_params, _ = adam_step(sp.params(), grads, ts.adam, lrs, ts.iteration)
        ev[9].record()
        strategy_mcmc.inject_noise(sp.replace_params(new_params), lrs["means"],
                                   generator=ts.rng)
        ev[10].record()
        ev[10].synchronize()
        for i, k in enumerate(stage_names):
            split[k].append(ev[i].elapsed_time(ev[i + 1]))
    split_ms = {k: statistics.median(v[1:]) for k, v in split.items()}
    train = dict(step_ms=statistics.median(step_wall[3:]), steps_per_s=1e3 / statistics.median(
        step_wall[3:]), split_ms=split_ms, split_sum_ms=sum(split_ms.values()),
        steps=TRAIN_STEPS, gaussians=N_GAUSS, width=WIDTH, height=HEIGHT,
        plan=dataclasses.asdict(plan), launches=train_launches, total_instances=max(totals),
        max_tile_count=max(ktiles), loss_first=losses[0], loss_last=losses[-1],
        loss_first5=first5, loss_last5=last5, refine=refine_info,
        gradient_rel_err=grad_err)

    # ======================= the batched step and the mesh =======================
    del ts, sp, splat, ts0, target, target_t, leaves, grads, new_params
    torch.cuda.empty_cache()
    batched_step = batched_step_phase(params, focal, dev, counted, plan)
    phase("batched-step", **{k: batched_step[k] for k in (
        "batch", "steps", "grad_rel_err", "grad_rel_err_bound", "step_ms", "cameras_per_s",
        "launches", "n_shard_visible")})
    torch.cuda.empty_cache()
    mesh2 = mesh_2rank_phase(dev)
    phase("mesh-2rank", **mesh2)
    torch.cuda.empty_cache()

    # ======================= the GUT camera path =======================
    gut = gut_phases(params, focal, dev, counted, kernels)
    gut.update(k5_random_max_abs_err=k5_random_err, k6_random_rel_err=k6_random_err,
               segred_random=segred_random)
    torch.cuda.empty_cache()
    batched_gut = batched_gut_step_phase(params, focal, dev, counted,
                                         RasterPlan(**gut["plan"]))
    phase("batched-gut-step", **{k: batched_gut[k] for k in (
        "batch", "steps", "grad_rel_err", "grad_rel_err_bound", "step_ms", "cameras_per_s",
        "launches", "n_shard_visible")})

    # ======================= the trainer: capture -> Trainer -> CLI =======================
    torch.cuda.empty_cache()
    trainer = trainer_phases(params, focal, dev, counted)
    trainer.update(device=kind, nvidia_smi=smi)
    # -- the JAX package's CI quality gate on the raytraced capture
    quality = quality_floor_phase(dev, counted)
    phase("quality-floor", card=smi, **{k: quality[k] for k in (
        "iterations", "psnr", "ssim", "wall_s", "it_per_s", "launches", "steps_dispatched",
        "eval_renders", "n_alive", "plan_history")})
    trainer["quality_floor"] = quality
    # each kernel's launches in the product path's runs, beside its main path's
    wrapper_of = {"expand.cu": "expand_emission", "blend_fwd.cu": "blend_forward",
                  "blend_bwd.cu": "blend_backward", "segsum.cu": "segsum_emission",
                  "gut_fwd.cu": "gut_blend_forward", "gut_bwd.cu": "gut_blend_backward",
                  "segprefix.cu": "segred_prefix"}
    runs = dict(pinhole=trainer["pinhole"], gut=trainer["gut"], batched=trainer["batched"],
                batched_step=batched_step, batched_gut_step=batched_gut, adc=trainer["adc"],
                resumed=trainer["resume"], grid_pose=trainer["components"]["grid_pose"],
                sparsity=trainer["components"]["sparsity"], quality_floor=quality)
    serving_runs = dict(view_sog_cli=view_sog["cli"], point_cloud=view_sog["frames"]["point_cloud"],
                        sh4_frame=view_sog["frames"]["sh_degree_4"], sh4_steps=view_sog["sh4_steps"],
                        viewer=viewer_res, trainer_live=trainer["live"])
    # gut_project.cu holds two kernels: those go by their entries' names
    wrapper_of.update(gut_project="ut_project_kernel", gut_rays="pixel_world_rays_kernel")
    for entry in kernels:
        fn = wrapper_of.get(entry["name"]) or wrapper_of[entry["source"].rsplit("/", 1)[1]]
        entry["trainer_launches"] = {k: v["launches"][fn] for k, v in runs.items()}
        entry["serving_launches"] = {k: v["launches"][fn] for k, v in serving_runs.items()}

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"frame": frame}), flush=True)
    print(json.dumps({"train": train}), flush=True)
    print(json.dumps({"gut": gut}), flush=True)
    print(json.dumps({"trainer": trainer}), flush=True)
    print(json.dumps({"serving": serving}), flush=True)
    print(json.dumps({"batched": dict(window=window, step=batched_step, gut_step=batched_gut,
                                      mesh_2rank=mesh2, trainer=trainer["batched"])}),
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
