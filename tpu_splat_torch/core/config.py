"""Configuration dataclasses, JSON- and field-compatible with the reference (port of
`tpu_splat/core/config.py`; the same fields, so both packages read the same presets).

Mirrors `include/core/parameters.hpp:16-113` (field names and defaults) so the reference's
shipped JSON presets (`parameter/{default,mcmc}_optimization_params.json`) load unchanged.
Dead reference config noted in SURVEY.md §5.6 (`preload_to_ram`, `grow_scale2d`,
`prune_scale2d`) is kept for JSON compatibility but not wired to behavior.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional


@dataclass
class OptimizationParameters:
    # Core schedule (parameters.hpp:17-36)
    iterations: int = 30_000
    sh_degree_interval: int = 1_000
    means_lr: float = 0.00016
    shs_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    lambda_dssim: float = 0.2
    min_opacity: float = 0.005
    refine_every: int = 100
    start_refine: int = 500
    stop_refine: int = 25_000
    grad_threshold: float = 0.0002
    sh_degree: int = 3
    opacity_reg: float = 0.01
    scale_reg: float = 0.01
    init_opacity: float = 0.5
    init_scaling: float = 0.1
    num_workers: int = 16
    max_cap: int = 1_000_000
    eval_steps: list[int] = field(default_factory=lambda: [7_000, 30_000])
    save_steps: list[int] = field(default_factory=lambda: [7_000, 30_000])
    skip_intermediate_saving: bool = False
    bg_modulation: bool = False
    enable_eval: bool = False
    rc: bool = False
    enable_save_eval_images: bool = True
    headless: bool = False
    render_mode: str = "RGB"  # RGB, D, ED, RGB_D, RGB_ED
    strategy: str = "mcmc"  # mcmc | default
    preload_to_ram: bool = False  # dead in reference; kept for JSON compat
    pose_optimization: str = "none"  # none | direct | mlp

    # Bilateral grid (parameters.hpp:52-57)
    use_bilateral_grid: bool = False
    bilateral_grid_X: int = 16
    bilateral_grid_Y: int = 16
    bilateral_grid_W: int = 8
    bilateral_grid_lr: float = 2e-3
    tv_loss_weight: float = 10.0

    # Default (ADC) strategy (parameters.hpp:60-71)
    prune_opacity: float = 0.005
    grow_scale3d: float = 0.01
    grow_scale2d: float = 0.05  # dead in reference (SURVEY §5.6)
    prune_scale3d: float = 0.1
    prune_scale2d: float = 0.15  # dead in reference (SURVEY §5.6)
    reset_every: int = 3_000
    pause_refine_after_reset: int = 0
    revised_opacity: bool = False
    gut: bool = False
    steps_scaler: float = 0.0
    antialiasing: bool = False

    # Random initialization (parameters.hpp:74-76)
    random: bool = False
    init_num_pts: int = 100_000
    init_extent: float = 3.0

    # SOG export (parameters.hpp:79-80)
    save_sog: bool = False
    sog_iterations: int = 10

    # ADMM sparsity (parameters.hpp:81-85)
    enable_sparsity: bool = False
    sparsify_steps: int = 15_000
    init_rho: float = 0.0005
    prune_ratio: float = 0.6

    config_file: str = ""

    # Knobs of the JAX package with no reference counterpart, kept with its defaults
    # Rasterizer tile edge. The reference hardcodes 16 (rasterization_config.h:26); the
    # JAX package trains at 32 (32x32 tiles emit fewer instances for more per-tile pixel
    # work), and so does the port. Blend semantics are identical.
    tile_size: int = 32
    instance_budget: int = 0  # 0 = auto (pow2-bucketed from live counts)
    packed_backward: bool = True
    # Multi-device training (no reference counterpart — the reference is single-GPU,
    # trainer.cpp:253). batch_size cameras render per optimizer step, sharded over the
    # mesh "data" axis; gaussians shard over "gauss". 0 = auto (data = batch_size,
    # gauss = n_devices / data). Not ported yet (ROADMAP.md Queue 1 item 9): the port's
    # trainer raises for batch_size > 1.
    batch_size: int = 1
    mesh_data: int = 0
    mesh_gauss: int = 0
    # Steps per dispatch on the single-device path: the trainer folds uninterrupted
    # stretches between host hooks into one train_step_many call (in the port a host
    # loop of train_step; in the JAX package one lax.scan launch). 1 = off. Semantically
    # invisible; rollback/redo restarts from the chunk start.
    scan_steps: int = 8

    def apply_steps_scaler(self) -> "OptimizationParameters":
        """steps_scaler (>0) multiplies schedule lengths (argument_parser.cpp:422-439)."""
        s = self.steps_scaler
        if s <= 0:
            return self
        return dataclasses.replace(
            self,
            iterations=int(self.iterations * s),
            start_refine=int(self.start_refine * s),
            stop_refine=int(self.stop_refine * s),
            refine_every=int(self.refine_every * s),
            reset_every=int(self.reset_every * s),
            sh_degree_interval=int(self.sh_degree_interval * s),
            eval_steps=[int(v * s) for v in self.eval_steps],
            save_steps=[int(v * s) for v in self.save_steps],
        )

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, obj: dict) -> "OptimizationParameters":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in obj.items() if k in known}
        return cls(**kwargs)

    @classmethod
    def from_file(cls, path: str | Path) -> "OptimizationParameters":
        with open(path) as f:
            obj = json.load(f)
        p = cls.from_json(obj)
        p.config_file = str(path)
        return p


@dataclass
class DatasetConfig:
    """Mirrors `include/core/parameters.hpp:92-102`."""

    data_path: str = ""
    output_path: str = ""
    project_path: str = ""
    images: str = "images"
    resize_factor: int = -1
    test_every: int = 8
    timelapse_images: list[str] = field(default_factory=list)
    timelapse_every: int = 50
    max_width: int = 3840


@dataclass
class TrainingParameters:
    """Mirrors `include/core/parameters.hpp:104-113`."""

    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    optimization: OptimizationParameters = field(default_factory=OptimizationParameters)
    ply_path: str = ""
    init_ply: Optional[str] = None

    def save(self, path: str | Path) -> None:
        obj = {
            "dataset": dataclasses.asdict(self.dataset),
            "optimization": self.optimization.to_json(),
            "ply_path": self.ply_path,
            "init_ply": self.init_ply,
        }
        Path(path).write_text(json.dumps(obj, indent=2))
