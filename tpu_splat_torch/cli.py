"""Command-line interface of the port: the `--view` render mode of `tpu_splat.cli`.

    python -m tpu_splat_torch --view model.ply -o renders [--device cpu]

renders an orbit turntable of a Gaussian PLY to PNGs on the CUDA card (or on the CPU
when asked). Training mode and the crop-box flags are not ported yet.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu_splat_torch",
        description="3D Gaussian Splatting renderer (PyTorch / CUDA port of tpu_splat)",
    )
    p.add_argument("-v", "--view", metavar="PLY", help="render an orbit of a model file")
    p.add_argument("-o", "--output-path", help="output directory")
    p.add_argument("--view-frames", type=int, default=60)
    p.add_argument("--view-width", type=int, default=1280)
    p.add_argument("--view-height", type=int, default=720)
    p.add_argument("--render-mode", choices=["RGB", "D", "ED", "RGB_D", "RGB_ED"],
                   default="RGB")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs on the CPU)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if not args.view:
        build_parser().print_help()
        print("\nOnly rendering is ported so far: pass --view MODEL.ply.", file=sys.stderr)
        return 1

    from .render import render_orbit

    render_orbit(
        args.view, Path(args.output_path or "renders"), n_frames=args.view_frames,
        width=args.view_width, height=args.view_height, render_mode=args.render_mode,
        device=args.device,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
