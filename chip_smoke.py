#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (`tpu_splat_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA card and the CUDA toolkit:

1. prints the card (torch name; nvidia-smi name and power limit);
2. builds every kernel of the render path from `tpu_splat_torch/csrc` (one nvcc per
   source, in parallel) and prints ptxas' register counts;
3. holds the blend kernel (K2) against its plain PyTorch version on random unaligned
   segments at (tile 16, chunk 128) and (tile 32, chunk 256);
4. drives the main path: `render_view` of a 1,000,000-Gaussian SH-degree-3 scene at
   1296x840 (the distributions of bench.py::build_workload, seed 0) with every launch
   count set to 0 just before and read just after; checks the aux counters, a finite
   image, that each kernel launched, and the image against the same frame through the
   plain versions on the card;
5. holds K1 (expansion, exact) and K2 against their plain versions at the frame's own
   shapes, and times kernels, plain versions and the library yardstick with CUDA events;
6. drives the CLI (`--view` of a 100k-Gaussian PLY written by the port, 3 frames);
7. prints a `kernels` JSON line, a `frame` JSON line (frame ms and per-stage split) and,
   last, {"ok": true, "device": {...}}.

Any failure raises and exits non-zero; without a CUDA device, or outside the repository,
it exits non-zero before printing any result. Times are medians over CUDA-event-timed
repetitions after warm-up, on the card named in the output.
"""

from __future__ import annotations

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
K2_OPS_PER_PAIR = 21  # ~20 FP32 operations and one exp per (pixel, instance) pair


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


def require(ok, what) -> None:
    """A check of the run: raises (also under python -O, unlike assert)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def phase(name: str, **fields) -> None:
    print(f"phase {name}: ok " + json.dumps(fields), flush=True)


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


def random_segments(tile_size: int, chunk: int, seed: int, dev):
    """Random blend inputs: 8x6 tiles, unaligned contiguous segments with gaps, up to
    4 chunks per tile, footprints of 1-6 px around each tile, opacities high enough
    that many pixels stop early."""
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
    flat = np.stack([mx, my, ca, rng.uniform(-0.3, 0.3, m) * np.sqrt(ca * cc), cc,
                     rng.uniform(0.05, 1.0, m), *rng.uniform(0, 1, (3, m)),
                     rng.uniform(1, 10, m)]).astype(np.float32)
    as_i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(dev)
    kw = dict(n_tiles=n_tiles, grid_w=gw, tile_size=tile_size, max_chunks=max_chunks,
              chunk=chunk)
    return (torch.from_numpy(flat).to(dev), as_i32(seg_start), as_i32(count)), kw


def blend_pairs(flat, seg_start, count, chk, *, n_tiles, grid_w, tile_size, max_chunks,
                chunk) -> int:
    """(pixel, instance) pairs the blend must evaluate on these inputs: per pixel, its
    tile's instances up to and including the one that stops it (all if none does).
    Uses the plain version's checkpoints `chk` as each chunk's entry transmittance."""
    import torch

    from tpu_splat_torch.ops.cuda.blend import tile_pixel_centers
    from tpu_splat_torch.ops.projection import MAX_FRAGMENT_ALPHA, MIN_ALPHA

    dev = flat.device
    px, py = tile_pixel_centers(n_tiles, grid_w, tile_size, dev)
    px, py = px[:, None, :], py[:, None, :]
    cnt = count.long()
    lane = torch.arange(chunk, device=dev)
    total = 0
    for j in range(max_chunks):
        t_entry = chk[:, :, j]  # [T, P]; 0 = stopped or not visited
        if not bool((t_entry > 0).any()):
            break
        local = j * chunk + lane
        lane_valid = local[None, :] < cnt[:, None]
        n_lanes = lane_valid.sum(1)  # [T]
        idx = torch.where(lane_valid, seg_start.long()[:, None] + local[None, :], 0)
        f = flat[:6, idx]
        mx, my, ca, cb, cc, op = (f[i][:, :, None] for i in range(6))
        dx, dy = mx - px, my - py
        sigma = 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy
        alpha = torch.clamp_max(op * torch.exp(-torch.clamp_min(sigma, 0.0)),
                                MAX_FRAGMENT_ALPHA)
        valid = lane_valid[:, :, None] & (sigma >= 0.0) & (alpha >= MIN_ALPHA)
        cp = torch.cumprod(1.0 - torch.where(valid, alpha, 0.0), dim=1)
        below = (t_entry[:, None, :] * cp < 1e-4) & valid
        stops = below.any(1)
        first = torch.argmax(below.to(torch.int8), dim=1) + 1
        pairs = torch.where(stops, first, n_lanes[:, None])
        total += int(torch.where(t_entry > 0, pairs, 0).sum())
    return total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1

    from tpu_splat_torch.cli import main as cli_main
    from tpu_splat_torch.convert import splat_from_numpy
    from tpu_splat_torch.io.ply import save_splat_ply
    from tpu_splat_torch.ops.cuda import build
    from tpu_splat_torch.ops.cuda.blend import blend_forward, blend_forward_plain
    from tpu_splat_torch.ops.cuda.raster import (build_sorted_instances, emission_tables,
                                                 expand_emission, expand_emission_plain)
    from tpu_splat_torch.ops.projection import project
    from tpu_splat_torch.ops.rasterize import blend_inputs, blend_instances, compose_output
    from tpu_splat_torch.render import max_instances_for, render_view

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {kind} | nvidia-smi: {smi}", flush=True)
    counted = (expand_emission, blend_forward)

    # -- build every kernel of the path from the checkout's sources
    t0 = time.perf_counter()
    libs = build.build_all()
    regs = [ln.strip() for name in libs for ln in build.build_log(name).splitlines()
            if "registers" in ln or "spill" in ln or "entry function" in ln]
    phase("build", seconds=round(time.perf_counter() - t0, 3),
          libraries=[str(p.name) for p in libs.values()], ptxas=regs)

    # -- K2 against its plain version on random unaligned segments
    k2_random_err = 0.0
    for ts, ch, seed in ((16, 128, 1), (32, 256, 2)):
        args, kw = random_segments(ts, ch, seed, dev)
        got = blend_forward(*args, **kw)
        want = blend_forward_plain(*args, **kw)
        torch.cuda.synchronize()
        err = check_blend(got, want, f"K2 random tile {ts} chunk {ch}")
        k2_random_err = max(k2_random_err, err)
        # pixels that stopped early: a zero checkpoint in a chunk their tile has
        n_chunks = (args[2] + ch - 1) // ch
        visited = torch.arange(kw["max_chunks"], device=dev) < n_chunks[:, None, None]
        stopped = float(((want[1] == 0) & visited).any(-1).float().mean())
        phase(f"k2-random-{ts}-{ch}", max_abs_err=err, stopped_pixel_share=stopped)

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
    require(all(v > 0 for v in launches.values()), f"a kernel did not launch: {launches}")
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
    gw, gh, ts, chunk, k_max = -(-WIDTH // 16), -(-HEIGHT // 16), 16, 128, 4096
    f = 0.5 * WIDTH / math.tan(math.radians(fov) / 2)
    proj_args = (state.means, state.scaling_raw, state.rotation_raw, state.opacity_raw,
                 state.sh0, state.shN, state.alive, torch.as_tensor(w2c, device=dev),
                 torch.zeros(3, device=dev), f, f, WIDTH / 2.0, HEIGHT / 2.0, WIDTH, HEIGHT,
                 3)
    proj = project(*proj_args, tile_size=ts)
    ftab, itab, offs_incl = emission_tables(proj)
    k1 = expand_emission(ftab, itab, offs_incl, max_inst)
    k1_plain = expand_emission_plain(ftab, itab, offs_incl, max_inst)
    torch.cuda.synchronize()
    require(torch.equal(k1[0], k1_plain[0]) and torch.equal(k1[1], k1_plain[1]), "K1 differs")
    k1_err = max(max_err(k1[0], k1_plain[0]), max_err(k1[1], k1_plain[1]))
    require(int(k1[1][0].max()) < N_GAUSS and int(k1[1][1].max()) < max_inst,
            "K1 owner or rect-walk index out of range")
    inst = build_sorted_instances(proj, gw, gh, max_inst, ts)
    flat, seg_start, count, max_chunks = blend_inputs(inst, k_max=k_max, chunk=chunk)
    bkw = dict(n_tiles=gw * gh, grid_w=gw, tile_size=ts, max_chunks=max_chunks, chunk=chunk)
    k2 = blend_forward(flat, seg_start, count, **bkw)
    k2_plain = blend_forward_plain(flat, seg_start, count, **bkw)
    torch.cuda.synchronize()
    k2_err = check_blend(k2, k2_plain, "K2 frame")
    phase("kernel-parity-frame", k1_max_abs_err=k1_err, k2_max_abs_err=k2_err,
          k2_random_max_abs_err=k2_random_err)

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
    pairs = blend_pairs(flat, seg_start, count, k2_plain[1], **bkw)
    k1_bytes = 4 * (12 * N_GAUSS + 13 * max_inst)
    k2_bytes = 4 * (10 * n_inst + 2 * gw * gh) + 4 * gw * gh * ts * ts * (8 + max_chunks)
    k2_ops = K2_OPS_PER_PAIR * pairs
    k2_bound_bytes, k2_bound_ops = k2_bytes / PEAK_BYTES_S * 1e3, k2_ops / PEAK_F32_S * 1e3
    kernels = [
        dict(name="expand", route="cuda", source="tpu_splat_torch/csrc/expand.cu",
             replaces="tpu_splat/ops/pallas/raster.py:61", launches=launches["expand_emission"],
             max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain_ms,
             bound_ms=k1_bytes / PEAK_BYTES_S * 1e3, bound_by="bytes", library_ms=k1_lib_ms),
        dict(name="blend_fwd", route="cuda", source="tpu_splat_torch/csrc/blend_fwd.cu",
             replaces="tpu_splat/ops/pallas/blend.py:370", launches=launches["blend_forward"],
             max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain_ms,
             bound_ms=max(k2_bound_bytes, k2_bound_ops),
             bound_by="operations" if k2_bound_ops >= k2_bound_bytes else "bytes",
             library_ms=None),
    ]
    phase("kernel-times", k1_bytes=k1_bytes, k2_bytes=k2_bytes, k2_pairs=pairs,
          k2_instances=n_inst, k2_pairs_if_no_stop=n_inst * ts * ts)

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
        tiles = blend_instances(si, grid_w=gw, grid_h=gh, tile_size=ts, k_max=k_max,
                                chunk=chunk)
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
        require(all(v == 3 for v in cli_launches.values()), cli_launches)
    phase("cli", frames=len(pngs), launches=cli_launches)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"frame": frame}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
