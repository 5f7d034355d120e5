#!/usr/bin/env python3
"""K2 and K3 of this checkout against K2 and K3 built from other source directories, in
turns, on one CUDA card.

    python3 ab_blend_kernels.py BASE_CSRC [BASE_CSRC ...] [--reps 10]

Each BASE_CSRC holds another version's `blend_fwd.cu`, `blend_bwd.cu` and
`blend_common.cuh` with the same C interface, for example `tpu_splat_torch/csrc` of an
earlier commit unpacked with `git archive` into a directory that .gitignore lists. The
script builds every version (one nvcc a source, all at once), prints ptxas' registers and
spills of each, and on two inputs:

  frame: chip_smoke.py's render frame (1,000,000 Gaussians, SH degree 3, 1296x840; tile 16,
         chunk 128, f32 layout);
  train: the train-step blend of chip_smoke.py's training workload at its initial state
         (tile 32, chunk 256, bf16 layout; `gout` random, as chip_smoke.py draws it),

checks for each base that its K2 gives the same bits (out and chk) as this checkout's and
its K3 agrees within 1e-4 of the largest gradient, then times base, new, new, base (each
the median of --reps CUDA-event repetitions after warm-up) and prints the card, the pair
counts of `chip_smoke.blend_pairs` and one JSON line of times a base.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np

NAMES = ("blend_fwd", "blend_bwd")


def build_bases(srcs: list[Path], names=NAMES) -> list[tuple[dict, str]]:
    """Build each BASE_CSRC's kernels `names` into build/ab/<i>/, one nvcc a source, all at
    once. -> [({name: ctypes fn}, ptxas log)] in the order of `srcs`"""
    from tpu_splat_torch.ops.cuda import build

    procs = []
    for i, src in enumerate(srcs):
        out_dir = build.BUILD_DIR.parent / "ab" / str(i)
        out_dir.mkdir(parents=True, exist_ok=True)
        procs.append({name: (out_dir / f"{name}.so", subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"),
             str(src / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)) for name in names})
    bases = []
    for src, libs in zip(srcs, procs):
        fns, log = {}, ""
        for name, (lib, proc) in libs.items():
            log += proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src / name}.cu:\n{log}")
            symbol, argtypes = build.ENTRY_POINTS[name]
            fns[name] = getattr(ctypes.CDLL(str(lib)), symbol)
            fns[name].argtypes, fns[name].restype = argtypes, ctypes.c_int
        bases.append((fns, log))
    return bases


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("base_csrc", type=Path, nargs="+")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("ab_blend_kernels: no CUDA device is available", file=sys.stderr)
        return 1
    from chip_smoke import (HEIGHT, N_GAUSS, WIDTH, blend_pairs, build_workload, cuda_ms,
                            frame_blend_inputs, ptxas_lines, require, train_blend_inputs,
                            train_setup)
    from tpu_splat_torch.convert import splat_from_numpy
    from tpu_splat_torch.ops.cuda import blend, build

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}", flush=True)
    build.build_all()
    new = {name: build.kernel(name) for name in NAMES}
    bases = build_bases(args.base_csrc)
    print(json.dumps({"ptxas_new": ptxas_lines("".join(build.build_log(n) for n in NAMES))}),
          flush=True)
    results = [{"base": str(src), "ptxas_base": ptxas_lines(log)}
               for src, (_, log) in zip(args.base_csrc, bases)]

    def using(fns, fn, *a, **kw):  # run a wrapper with the given kernel libraries
        saved = blend.kernel
        blend.kernel = fns.__getitem__
        try:
            return fn(*a, **kw)
        finally:
            blend.kernel = saved

    def in_turns(result, key, fns, fn, *a, **kw):  # base, new, new, base
        for side in ("base", "new", "new", "base"):
            lib = new if side == "new" else fns
            result.setdefault(f"{key}_{side}_ms", []).append(
                cuda_ms(lambda: using(lib, fn, *a, **kw), args.reps))

    params, focal = build_workload(N_GAUSS, WIDTH, HEIGHT)
    state = splat_from_numpy(params, np.ones(N_GAUSS, bool), 3, dev, scene_scale=3.0)
    _, _, (flat, seg, cnt), kw = frame_blend_inputs(state, focal, dev)
    f_new = using(new, blend.blend_forward, flat, seg, cnt, **kw)
    print(json.dumps({"frame_pairs": blend_pairs(flat, seg, cnt, f_new[1], **kw)}), flush=True)
    for (fns, _), result in zip(bases, results):
        f_base = using(fns, blend.blend_forward, flat, seg, cnt, **kw)
        require(torch.equal(f_new[0], f_base[0]) and torch.equal(f_new[1], f_base[1]),
                f"frame: K2 of {result['base']} differs")
        in_turns(result, "k2_f32_frame", fns, blend.blend_forward, flat, seg, cnt, **kw)
    del state, flat, seg, cnt, f_new, f_base
    torch.cuda.empty_cache()

    ts0, _, cam, _, plan, _ = train_setup(params, focal, dev)
    _, (flat, seg, cnt), gout, kw = train_blend_inputs(ts0.splat, cam, plan, dev)
    f_new = using(new, blend.blend_forward, flat, seg, cnt, **kw)
    print(json.dumps({"train_pairs": blend_pairs(blend.unpack_features(flat), seg, cnt,
                                                 f_new[1], **kw)}), flush=True)
    bwd = (flat, seg, cnt, f_new[1], f_new[0], gout)
    g_new = using(new, blend.blend_backward, *bwd, **kw)
    for (fns, _), result in zip(bases, results):
        f_base = using(fns, blend.blend_forward, flat, seg, cnt, **kw)
        require(torch.equal(f_new[0], f_base[0]) and torch.equal(f_new[1], f_base[1]),
                f"train: K2 of {result['base']} differs")
        g_base = using(fns, blend.blend_backward, *bwd, **kw)
        rel = float((g_new - g_base).abs().max() / g_base.abs().max())
        require(math.isfinite(rel) and rel <= 1e-4,
                f"train: K3 of {result['base']} differs by {rel}")
        result["k3_rel_diff"] = rel
        in_turns(result, "k2_bf16_train", fns, blend.blend_forward, flat, seg, cnt, **kw)
        in_turns(result, "k3_train", fns, blend.blend_backward, *bwd, **kw)
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
