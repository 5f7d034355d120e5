"""Command-line interface of the port (port of `tpu_splat/cli.py`): training and `--view`.

    python -m tpu_splat_torch -d DATA -o OUT [--headless] [--eval] [--gut] [--device cpu]
        [--batch-size B [--mesh-data D] [--mesh-gauss G]]
        [--strategy default | --config parameter/default_optimization_params.json]
        [--bilateral-grid] [--pose-opt direct|mlp] [--enable-sparsity]
        [--checkpoint-every N] [--resume OUT/checkpoint_N.npz] [--sog]
        [--timelapse-images NAME ... --timelapse-every N] [--port P --viewer-host H]
    python -m tpu_splat_torch --view model.ply|model.sog -o renders
        [--crop-min X Y Z --crop-max X Y Z] [--device cpu]

trains a COLMAP or Blender capture (`run_headless` -> `Trainer.train`), or renders an
orbit turntable of a Gaussian PLY or a SOG model to PNGs, on the CUDA card or, when asked,
on the CPU. Training without `--headless` attaches the live web viewer (`viewer.py::
attach`, on loopback port `--port` unless `--viewer-host` says otherwise). Config
precedence is the JAX CLI's: struct defaults <- `--config` JSON <- CLI flags; the resolved
parameters are saved to the output directory.

`--batch-size B` takes one optimizer step over B cameras (on one card a 1x1 mesh). Under
torchrun (`torchrun --nproc-per-node N -m tpu_splat_torch -d DATA -o OUT --headless
--batch-size B [--mesh-data D]`) every process joins the run's process group
(`parallel/distributed.py::initialize`: NCCL, a card a rank; gloo with `--device cpu`) and
the ranks form a (data, gauss) mesh; rank 0 writes the outputs. Several ranks train only
headless.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

from .core.config import DatasetConfig, OptimizationParameters, TrainingParameters
from .utils.log import configure as configure_logging, get_logger

log = get_logger(__name__)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu_splat_torch",
        description="3D Gaussian Splatting trainer/renderer (PyTorch/CUDA port of tpu_splat)",
    )
    # modes
    p.add_argument("-v", "--view", metavar="PLY_OR_SOG", help="render an orbit of a model file")
    p.add_argument("-d", "--data-path", help="path to training data (COLMAP or transforms.json)")
    p.add_argument("-o", "--output-path", help="output directory")
    p.add_argument("--proj_path", help="project file path (.ls)")
    p.add_argument("--config", help="optimization parameters JSON")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs on the CPU)")
    # core schedule
    p.add_argument("-i", "--iter", type=int, dest="iterations")
    p.add_argument("--sh-degree", type=int, dest="sh_degree")
    p.add_argument("--sh-degree-interval", type=int, dest="sh_degree_interval")
    p.add_argument("--max-cap", type=int, dest="max_cap")
    p.add_argument("--min-opacity", type=float, dest="min_opacity")
    p.add_argument("--num-workers", type=int, dest="num_workers")
    p.add_argument("--batch-size", type=int, dest="batch_size",
                   help="cameras per optimizer step (> 1: the batched step on a mesh)")
    p.add_argument("--mesh-data", type=int, dest="mesh_data")
    p.add_argument("--mesh-gauss", type=int, dest="mesh_gauss")
    p.add_argument("--scan-steps", type=int, dest="scan_steps",
                   help="steps folded into one dispatch between host hooks (1 = off)")
    p.add_argument("--steps-scaler", type=float, dest="steps_scaler")
    p.add_argument("--strategy", choices=["mcmc", "default"])
    # features
    p.add_argument("--headless", action="store_true", default=None)
    p.add_argument("--eval", action="store_true", default=None, dest="enable_eval")
    p.add_argument("--gut", action="store_true", default=None)
    p.add_argument("--bilateral-grid", action="store_true", default=None,
                   dest="use_bilateral_grid")
    p.add_argument("--pose-opt", choices=["none", "direct", "mlp"], dest="pose_optimization")
    p.add_argument("--bg-modulation", action="store_true", default=None, dest="bg_modulation")
    p.add_argument("--save-eval-images", action="store_true", default=None,
                   dest="enable_save_eval_images")
    p.add_argument("--skip-intermediate", action="store_true", default=None,
                   dest="skip_intermediate_saving")
    p.add_argument("--render-mode", choices=["RGB", "D", "ED", "RGB_D", "RGB_ED"],
                   dest="render_mode")
    # init
    p.add_argument("--init-ply")
    p.add_argument("--random", action="store_true", default=None)
    p.add_argument("--init-num-pts", type=int, dest="init_num_pts")
    p.add_argument("--init-extent", type=float, dest="init_extent")
    # sparsity
    p.add_argument("--enable-sparsity", action="store_true", default=None,
                   dest="enable_sparsity")
    p.add_argument("--sparsify-steps", type=int, dest="sparsify_steps")
    p.add_argument("--init-rho", type=float, dest="init_rho")
    p.add_argument("--prune-ratio", type=float, dest="prune_ratio")
    # export
    p.add_argument("--sog", action="store_true", default=None, dest="save_sog")
    p.add_argument("--sog-iterations", type=int, dest="sog_iterations")
    # dataset
    p.add_argument("--images", help="images folder name")
    p.add_argument("--resize_factor", type=int, dest="resize_factor")
    p.add_argument("--max-width", type=int, dest="max_width")
    p.add_argument("--test-every", type=int, dest="test_every")
    p.add_argument("--timelapse-images", nargs="*", dest="timelapse_images")
    p.add_argument("--timelapse-every", type=int, dest="timelapse_every")
    p.add_argument("--rc", action="store_true", default=None)
    # checkpointing (no reference counterpart; SURVEY.md §5.4)
    p.add_argument("--resume", metavar="CKPT", help="resume training from a checkpoint")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save a full training checkpoint every N iterations")
    # logging
    p.add_argument("--log-level", default="info",
                   choices=["trace", "debug", "info", "warn", "error"])
    p.add_argument("--log-file")
    # view-mode options
    p.add_argument("--crop-min", type=float, nargs=3, metavar=("X", "Y", "Z"),
                   help="crop box min bounds (world units) for --view")
    p.add_argument("--crop-max", type=float, nargs=3, metavar=("X", "Y", "Z"))
    p.add_argument("--view-frames", type=int, default=60)
    p.add_argument("--view-width", type=int, default=1280)
    p.add_argument("--view-height", type=int, default=720)
    # live training viewer (reference: GUI attach, application.cpp; here a web view)
    p.add_argument("--port", type=int, default=8080, help="live viewer port (non-headless)")
    p.add_argument("--viewer-host", default="127.0.0.1",
                   help="live viewer bind address (loopback by default: /control can "
                        "pause/stop training; 0.0.0.0 exposes it)")
    return p


def params_from_args(args: argparse.Namespace) -> TrainingParameters:
    """defaults <- config JSON <- CLI flags, with conflict detection."""
    if args.config:
        opt = OptimizationParameters.from_file(args.config)
    else:
        opt = OptimizationParameters()

    opt_fields = {f.name for f in dataclasses.fields(OptimizationParameters)}
    overrides = {}
    for key, val in vars(args).items():
        if val is None or key not in opt_fields:
            continue
        overrides[key] = val
    if args.config and overrides:
        # conflict detection (argument_parser.cpp:479): explicit CLI values win, but warn
        conflicting = [k for k in overrides if getattr(opt, k) != overrides[k]]
        if conflicting:
            log.warning("CLI flags override config file values: %s", ", ".join(conflicting))
    opt = dataclasses.replace(opt, **overrides)

    ds = DatasetConfig(
        data_path=args.data_path or "",
        output_path=args.output_path or "",
        project_path=args.proj_path or "",
    )
    ds_fields = {f.name for f in dataclasses.fields(DatasetConfig)}
    ds_overrides = {
        k: v for k, v in vars(args).items()
        if v is not None and k in ds_fields
        and k not in ("data_path", "output_path", "project_path")
    }
    ds = dataclasses.replace(ds, **ds_overrides)

    return TrainingParameters(dataset=ds, optimization=opt, init_ply=args.init_ply)


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    configure_logging(args.log_level, args.log_file)

    if args.view:
        from .render import render_orbit

        crop = None
        if args.crop_min and args.crop_max:
            import numpy as np

            from .core.geometry import BoundingBox

            crop = BoundingBox(np.asarray(args.crop_min), np.asarray(args.crop_max))
        render_orbit(
            args.view, Path(args.output_path or "renders"), n_frames=args.view_frames,
            width=args.view_width, height=args.view_height,
            render_mode=args.render_mode or "RGB", crop_box=crop, device=args.device,
        )
        return 0

    if not args.data_path:
        build_parser().print_help()
        print("\nPass -d/-o to train or --view to render.", file=sys.stderr)
        return 1

    return run_headless(args)


def run_headless(args: argparse.Namespace) -> int:
    """Mirrors run_headless_app (application.cpp:17-54): project -> setup -> train."""
    from .parallel.distributed import initialize, shutdown

    params = params_from_args(args)
    # a world of 1 unless torchrun (or TPU_SPLAT_*) names one; no card and no --device
    # cpu: raise before I/O
    runtime = initialize(device=args.device)
    try:
        if runtime.world > 1 and not args.headless:
            raise ValueError("the live viewer runs on one process: pass --headless when "
                             f"training on {runtime.world} ranks")
        return _train(args, params, runtime.device, lead=runtime.rank == 0)
    finally:
        shutdown()


def _train(args: argparse.Namespace, params, device, lead: bool) -> int:
    """Trains on this rank; rank 0 (`lead`) alone writes the parameters and the project."""
    from .core.project import create_new_project
    from .training.trainer import Trainer

    out_dir = Path(params.dataset.output_path or "output")
    if not lead:
        trainer = Trainer(params, device=device)
        if args.resume:
            trainer.resume(args.resume)
        trainer.checkpoint_every = args.checkpoint_every
        trainer.train()
        return 0

    out_dir.mkdir(parents=True, exist_ok=True)
    params.save(out_dir / "training_params.json")

    project = create_new_project(
        params.dataset.data_path, str(out_dir),
        project_path=params.dataset.project_path or None,
    )
    if not project.acquire_lock():
        log.error("project %s is locked by another process", project.path)
        return 2
    try:
        project.params = params.optimization.to_json()
        project.save()

        trainer = Trainer(params, device=device)
        if args.resume:
            trainer.resume(args.resume)
        trainer.checkpoint_every = args.checkpoint_every
        trainer.project = project
        server = None
        if not args.headless:
            # training under a live web viewer (the reference's GUI-attached training,
            # src/visualizer/training_manager.cpp:121,343); controls ride the event bus
            from .viewer import attach

            server = attach(trainer, port=args.port, host=args.viewer_host)
        try:
            trainer.train()
        finally:
            if server is not None:
                server.shutdown()
                server.server_close()
        final = out_dir / "splat_final.ply"
        if final.exists():
            project.add_ply("final", final, iteration=trainer.opt.iterations)
    finally:
        project.release_lock()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
