#!/usr/bin/env python3
"""File sizes of the SOG planes under the port's lossless WebP encoder and under PIL's.

    python3 sog_sizes.py [--n 20000] [--seed 0]

Builds the scene `chip_smoke.build_workload` builds (the distributions of bench.py, SH
degree 3) at `--n` Gaussians, computes its SOG planes on the CPU
(`tpu_splat_torch.io.sog.sog_planes`, palette min(64, 2^floor(log2(n/1024))) * 1024),
and prints one JSON line: for each plane its shape, the bytes of
`encode_webp_lossless` (the port), and, where PIL is installed, of PIL's lossless WebP at
quality 100 (what the JAX package writes), each checked to decode back bit for bit.
"""

from __future__ import annotations

import argparse
import io
import json
import time

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    from chip_smoke import HEIGHT, WIDTH, build_workload
    from tpu_splat_torch.io.sog import sog_planes
    from tpu_splat_torch.io.webp import decode_webp_lossless, encode_webp_lossless

    params, _ = build_workload(args.n, WIDTH, HEIGHT, seed=args.seed)
    planes, meta = sog_planes(params, device="cpu")
    try:
        from PIL import Image
    except ImportError:
        Image = None
    out = {}
    for name, plane in planes.items():
        t0 = time.perf_counter()
        data = encode_webp_lossless(plane)
        row = dict(shape=list(plane.shape[:2]), port_bytes=len(data),
                   port_encode_s=time.perf_counter() - t0)
        if not np.array_equal(decode_webp_lossless(data), plane):
            raise RuntimeError(f"{name}: the port's file does not decode to the plane")
        if Image is not None:
            bio = io.BytesIO()
            Image.fromarray(plane, "RGBA").save(bio, format="WEBP", lossless=True, quality=100)
            row["pil_bytes"] = len(bio.getvalue())
            row["port_over_pil"] = row["port_bytes"] / row["pil_bytes"]
        out[name] = row
    total = {k: sum(r[k] for r in out.values()) for k in ("port_bytes", "pil_bytes")
             if all(k in r for r in out.values())}
    print(json.dumps(dict(n=args.n, palette=meta["shN"]["palette_size"], planes=out,
                          total=total)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
