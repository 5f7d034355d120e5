"""Trainer orchestration: dataset split, train loop, plan adaptation, eval/save hooks (port
of `tpu_splat/training/trainer.py`, one device).

The host loop keeps the JAX package's structure. Each step reports its instance counters
as device tensors; the host checks them one step behind, so reading them does not stall
the next dispatch, and it ROLLS BACK and re-runs any step whose budget overflowed. States
are immutable (`train_step` leaves its input untouched), so rollback is keeping the old
state. The port's random stream is a `torch.Generator` shared by every state, where the
JAX key is part of the state: each pending step records the generator's state at its
dispatch, and a rollback restores it, so a redo draws what the first try drew.

Uninterrupted stretches between host hooks go to `train_step_many` in chunks of
`scan_steps`; heterogeneous chunks (mixed image sizes or GUT camera configs) fall back to
one dispatch a step, as in the JAX package.

Schedule hooks (all host-dispatched between steps, against the reference's post_backward):
  * MCMC: refine (relocate+grow) on the strict (start, stop) window (mcmc.cpp:501-505).
  * ADC: grow/prune on is_refining (default_strategy.cpp:31-35) + reset_opacity every
    reset_every iters, both only while iter < stop_refine (:292-309).
  * ADMM sparsity: init at `iterations`, dual update every 50, final prune at
    iterations + sparsify_steps (sparsity_optimizer.hpp:101-118, trainer.cpp:622-646).
Each of these iterations ends a chunk of `scan_steps`, and the hook runs with no step in
flight. The densification info and the component states live in the `TrainState`, so a
rollback brings them back with the rest.

Checkpoints (`checkpoint_every`, the `SaveCheckpoint` event) are written after a flush of
the pending steps, with the plan and the data loader's position in `extra`; a run resumed
from one (`resume`) starts at the state's iteration with that plan, and its loader
continues the sample stream where the saved run's stood (the JAX Trainer restarts it), so
with one loader worker a resumed run repeats the uninterrupted one bit for bit.

At the end of `train` the splat is written as `splat_final.ply` and, with `save_sog`, as
`splat_final.sog` (k-means on the Trainer's device). The timelapse renders the watched
training views every `timelapse_every` iterations to `timelapse/<stem>/<it:06d>.png` (PNG
through the port's writer, where the JAX package writes JPEG through PIL). Every render
the Trainer's steps do not make is counted, so the kernels' launch counts can be held
exactly against `steps_dispatched`: `eval_renders`, `timelapse_renders`, and
`viewer_renders`, which the live viewer (`viewer.py::attach`) adds to from its HTTP
threads.

Batched steps (`--batch-size`, `--mesh-data`, `--mesh-gauss`, or a run of several
torch.distributed ranks, one process each) go through `parallel/step.py` on a (data,
gauss) mesh, built from the ranks with the JAX Trainer's rule (`parallel/mesh.py::
trainer_mesh_shape`): one card runs `--batch-size 4` on a 1x1 mesh. The state is sharded
over gauss; every rank draws the same sample sequence and keeps its data group's cameras;
a step also checks the per-shard visible count against the plan's `gather_budget`, which
grows (and the step is redone) as the instance budget does. The topology hooks run on the
gathered state, alike on every rank, which then re-shards it. Rank 0 alone evaluates,
saves, writes the timelapse and emits events, from the gathered state; the other ranks
wait at a barrier.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.config import TrainingParameters
from ..core.splat import SplatState, init_from_pointcloud, init_random
from ..device import resolve_device
from ..io.image import save_image
from ..io.loader import LoadResult, load
from ..io.ply import load_splat_ply, save_splat_ply
from ..ops.cameras import CameraParams
from ..ops.gut import rasterize_gut
from ..ops.rasterize import rasterize
from ..parallel.mesh import (gather_train_state, make_mesh, shard_train_state,
                             trainer_mesh_shape)
from ..parallel.step import make_batched_train_step
from ..utils import events as ev
from ..utils.async_io import writer
from ..utils.log import get_logger
from . import checkpoint
from . import sparsity as sp
from . import strategy_default, strategy_mcmc
from .dataset import CameraDataset, InfiniteDataLoader, split_cameras
from .metrics import MetricsEvaluator
from .train_step import (RasterPlan, StepConfig, StepStats, TrainState, active_sh_degree,
                         adc_refine_step, adc_reset_opacity_step, admm_init_step,
                         admm_update_step, init_train_state, refine_step,
                         sparsity_prune_step, train_step, train_step_many)

log = get_logger(__name__)

# the split of `Trainer.train`'s wall time (seconds), in `Trainer.timings`
TIMING_KEYS = ("data_wait", "dispatch", "pending_checks", "hooks", "eval", "timelapse",
               "save")


def _next_pow2(x: int) -> int:
    return 1 << max(int(math.ceil(math.log2(max(x, 1)))), 0)


def _next_bucket(x: int) -> int:
    """Quarter-pow2 buckets (1, 1.25, 1.5, 1.75 x 2^k), 128-aligned: the instance
    pipeline's cost scales with the BUDGET, so pow2 rounding wastes up to 2x."""
    x = max(x, 1)
    p2 = 1 << max(int(math.floor(math.log2(x))), 0)
    for frac in (1.0, 1.25, 1.5, 1.75, 2.0):
        cand = int(p2 * frac)
        if cand >= x:
            return ((cand + 127) // 128) * 128
    return 2 * p2


def _sine_background(step: int, jitter: np.random.Generator) -> np.ndarray:
    """sine_background_for_step (trainer.cpp:497-537): phase-shifted RGB + jitter."""
    two_pi = 2.0 * math.pi
    periods = (37, 41, 43)
    phases = [two_pi * ((step % p) / p) for p in periods]
    rgb = np.array(
        [
            0.5 * (1.0 + math.sin(phases[0])),
            0.5 * (1.0 + math.sin(phases[1] + two_pi / 3.0)),
            0.5 * (1.0 + math.sin(phases[2] + 2.0 * two_pi / 3.0)),
        ],
        np.float32,
    )
    rgb = rgb + (jitter.random(3).astype(np.float32) - 0.5) * 0.06
    return np.clip(rgb, 1e-4, 1.0 - 1e-4)


def _inv_weight_piecewise(step: int, max_steps: int) -> float:
    """Background-mix weight schedule (trainer.cpp:474-496)."""
    phase = max(0.0, min(1.0, step / max(1, max_steps)))
    if phase < 0.25:
        return 1.0
    if phase < 0.5:
        return 1.0 + (0.5 - 1.0) * (phase - 0.25) / 0.25
    return max(0.0, 0.5 + (0.0 - 0.5) * (phase - 0.5) / 0.25)


@dataclass
class PendingStep:
    iteration: int
    prev_state: TrainState  # densification info and component states included
    rng_state: torch.Tensor  # the generator's state before the step, restored on a redo
    stats: StepStats  # device tensors, read one step later
    plan: RasterPlan


class Trainer:
    def __init__(self, params: TrainingParameters, load_result: Optional[LoadResult] = None,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.world = dist.get_world_size() if dist.is_initialized() else 1
        self.is_lead = not dist.is_initialized() or dist.get_rank() == 0
        self.params = params
        opt = params.optimization.apply_steps_scaler()
        self.opt = opt
        self.step_cfg = StepConfig.from_params(opt)

        if load_result is None:
            self._emit(ev.DatasetLoadStarted(path=params.dataset.data_path))
            load_result = load(params.dataset.data_path, params.dataset.images, opt.rc)
            if load_result.scene is not None:
                self._emit(ev.DatasetLoadCompleted(
                    path=params.dataset.data_path,
                    n_cameras=len(load_result.scene.cameras),
                ))
                self._emit(ev.SceneLoaded(
                    path=params.dataset.data_path,
                    n_cameras=len(load_result.scene.cameras),
                    n_points=int(load_result.scene.points.shape[0]),
                ))
        if load_result.scene is None:
            raise ValueError(
                "Training requires a camera dataset (COLMAP/Blender), got a model file")
        scene = load_result.scene

        split = "train" if opt.enable_eval else "all"
        self.train_cams = split_cameras(scene.cameras, params.dataset.test_every, split)
        self.val_cams = (
            split_cameras(scene.cameras, params.dataset.test_every, "val")
            if opt.enable_eval
            else []
        )
        self.train_dataset = CameraDataset(
            self.train_cams, params.dataset.resize_factor, params.dataset.max_width
        )
        self.val_dataset = CameraDataset(
            self.val_cams, params.dataset.resize_factor, params.dataset.max_width
        )

        # distorted / fisheye cameras require the GUT path (trainer.cpp:586-597)
        needs_gut = any(c.requires_gut() for c in self.train_cams)
        if needs_gut and not opt.gut:
            raise ValueError(
                "dataset has distorted/fisheye cameras: pass --gut (trainer.cpp:586-597)"
            )
        if opt.gut:
            # the camera MODEL/shutter select the code path; the distortion coefficients
            # are a per-sample device tensor, so heterogeneous rigs render each view with
            # its own coefficients (include/core/camera.hpp:16-125)
            self.step_cfg = dataclasses.replace(self.step_cfg, gut=True)
            self._gut_cfg_cache: dict[tuple, tuple] = {}
            if opt.pose_optimization != "none":
                raise ValueError("pose optimization is incompatible with --gut (trainer.cpp:371)")

        # model init (training_setup.cpp:50-117): SfM points, --init-ply, or random
        dev = self.device
        capacity = _next_pow2(max(opt.max_cap, 1))
        if params.init_ply:
            raw = load_splat_ply(params.init_ply)
            n = raw["means"].shape[0]
            capacity = max(capacity, _next_pow2(n))
            splat = self._state_from_raw(raw, scene.scene_center, capacity, opt.sh_degree, dev)
        elif opt.random or scene.points.shape[0] == 0:
            rng = np.random.default_rng(42)
            splat = init_random(
                rng, opt.init_num_pts, opt.init_extent, capacity,
                scene.scene_center, opt.sh_degree, opt.init_opacity, opt.init_scaling,
                device=dev,
            )
        else:
            capacity = max(capacity, _next_pow2(scene.points.shape[0]))
            splat = init_from_pointcloud(
                scene.points, scene.colors, scene.scene_center, capacity,
                opt.sh_degree, opt.init_opacity, opt.init_scaling, device=dev,
            )

        self.state = init_train_state(
            splat, seed=0, n_train_images=len(self.train_cams), opt=opt, device=dev
        )
        n0 = int(splat.n_alive())
        self.plan = RasterPlan(
            max_instances=max(_next_bucket(n0 * 8), 1 << 16),
            k_max=1 << 12,
            chunk=256 if opt.tile_size >= 32 else 128,
            tile_size=opt.tile_size,
            pack_bf16=True,  # the JAX trainer's default (trainer.py:205)
        )
        # batched steps over a (data, gauss) mesh of the run's ranks (trainer.py:207-256)
        self.mesh = None
        self._batched_step = None
        self.batch_size = max(1, opt.batch_size)
        self.shard_capacity = splat.capacity
        if self.batch_size > 1 or opt.mesh_gauss > 1 or opt.mesh_data > 1 or self.world > 1:
            data_ax, gauss_ax = trainer_mesh_shape(self.world, self.batch_size,
                                                   opt.mesh_data, opt.mesh_gauss)
            if opt.gut:
                # one (model, shutter) for the whole batch; per-camera coefficients
                variants = {(CameraParams.from_camera(c).model,
                             CameraParams.from_camera(c).shutter) for c in self.train_cams}
                if len(variants) != 1:
                    raise ValueError(
                        f"batched GUT requires a uniform camera model; got {variants}")
                (model, shutter), = variants
                if shutter != "global" or model == "ortho":
                    raise ValueError(
                        "batched GUT supports global-shutter non-ortho models; use "
                        "--batch-size 1 for rolling shutter / ORTHO")
            self.mesh = make_mesh(self.world, data=data_ax)
            self.state = shard_train_state(self.mesh, self.state)
            self._batched_step = make_batched_train_step(self.mesh)
            self.shard_capacity = max(1, splat.capacity // gauss_ax)
            self.plan = dataclasses.replace(
                self.plan, gather_budget=min(_next_bucket(max(n0 // gauss_ax, 1) * 2),
                                             self.shard_capacity))
            log.info("batched steps on a mesh of %s (batch %d, gather_budget %d)",
                     self.mesh.shape, self.batch_size, self.plan.gather_budget)
        self.evaluator = MetricsEvaluator(params.dataset.output_path or ".", device=dev)
        self._bg_rng = np.random.default_rng(1234)
        self._loss_hist: list[float] = []
        self.checkpoint_every: int = 0  # 0 = off; full-state checkpoints (checkpoint.py)
        self.samples_drawn = 0  # the data loader's position (checkpoints carry it)
        self.project = None  # optional core.project.Project for artifact bookkeeping
        # what the run did: plan changes [(iteration, max_instances, k_max, redo)], steps
        # dispatched (redone ones included), eval renders, and the wall-time split
        self.plan_history: list[tuple[int, int, int, bool]] = []
        self.refine_log: list[dict] = []  # each topology hook that ran, with its counts
        self.n_redo = 0
        self.steps_dispatched = 0
        self.eval_renders = 0
        self.timelapse_renders = 0
        self.viewer_renders = 0  # the live viewer's frames (viewer.py), from its threads
        self._live_rate: float | None = None  # it/s at the last progress report
        self.timings = dict.fromkeys(TIMING_KEYS, 0.0)
        self.sog_timings: dict[str, float] = {}  # save_sog's split, when --sog
        # control flags (reference: pause/save/stop atomics, trainer.cpp:427-472),
        # driven by cmd::* events so a front-end thread can steer training
        self._stop_flag = threading.Event()
        self._pause_flag = threading.Event()
        self._save_flag = threading.Event()
        self._unsubscribe = [
            ev.when(ev.StopTraining, lambda e: self._stop_flag.set()),
            ev.when(ev.PauseTraining, lambda e: self._pause_flag.set()),
            ev.when(ev.ResumeTraining, lambda e: self._pause_flag.clear()),
            ev.when(ev.SaveCheckpoint, lambda e: self._save_flag.set()),
        ]
        log.info(
            "Trainer ready on %s: %d train / %d val cameras, %d gaussians, capacity %d, "
            "scene_scale %.3f", dev, len(self.train_cams), len(self.val_cams), n0,
            splat.capacity, splat.scene_scale,
        )
        self._emit(ev.TrainerReady(
            n_train_cameras=len(self.train_cams), n_val_cameras=len(self.val_cams),
            n_gaussians=n0,
        ))

    def resume(self, path: str | Path) -> None:
        """Continue from a checkpoint: its state, and the plan and data-loader position
        its `extra` holds (a checkpoint without them keeps this Trainer's)."""
        self.state, extra = checkpoint.load_checkpoint(path, device=self.device)
        if self.mesh is not None:
            self.state = shard_train_state(self.mesh, self.state)
        if "plan_max_instances" in extra:
            self.plan = dataclasses.replace(self.plan,
                                            max_instances=int(extra["plan_max_instances"]),
                                            k_max=int(extra["plan_k_max"]))
        self.samples_drawn = int(extra.get("samples_drawn", 0))
        if "bg_rng_state" in extra:
            self._bg_rng.bit_generator.state = extra["bg_rng_state"]
        log.info("resumed from %s at iteration %d", path, self.state.iteration)

    def save_checkpoint(self, path: Path, iteration: int) -> None:
        """The state with no step in flight, the plan and the loader's position; in a
        batched run the gathered state, written by rank 0 alone."""
        state = self.full_state()
        if not self.is_lead:
            return
        checkpoint.save_checkpoint(path, state, extra={
            "plan_max_instances": self.plan.max_instances,
            "plan_k_max": self.plan.k_max,
            "samples_drawn": self.samples_drawn,
            "bg_rng_state": self._bg_rng.bit_generator.state,
        })
        if self.project is not None:
            self.project.add_checkpoint(path)
        log.info("checkpoint saved: %s", path)
        self._emit(ev.CheckpointSaved(path=str(path), iteration=iteration))

    def _control_flags(self) -> tuple[bool, bool, bool]:
        """(stop, pause, save) as the event bus set them on this process, or in a run of
        several ranks on any of them, so that every rank leaves, waits or saves (a
        gather) at the same iteration: a rank alone in a collective would hang the run."""
        flags = [f.is_set() for f in (self._stop_flag, self._pause_flag, self._save_flag)]
        if self.mesh is not None:
            flags = self.mesh.any_rank(flags)
        return tuple(flags)

    def _emit(self, event) -> None:
        """Events come from rank 0 alone."""
        if self.is_lead:
            ev.emit(event)

    def full_state(self) -> TrainState:
        """The whole state: in a batched run gathered from the gauss shards (a collective:
        every rank calls it at the same point), else the state itself."""
        if self.mesh is None:
            return self.state
        return gather_train_state(self.mesh, self.state)

    def _barrier(self) -> None:
        if self.mesh is not None:
            self.mesh.barrier()

    @staticmethod
    def _state_from_raw(raw: dict, scene_center, capacity: int, sh_degree: int,
                        device: torch.device) -> SplatState:
        n = raw["means"].shape[0]
        state = init_from_pointcloud(
            raw["means"], np.zeros((n, 3), np.float32), scene_center, capacity, sh_degree,
            device=device,
        )
        pads = {}
        for k, v in raw.items():
            cur = getattr(state, k).clone()
            cur[:n] = torch.as_tensor(np.asarray(v, np.float32), device=device)
            pads[k] = cur
        return dataclasses.replace(state, **pads)

    # ------------------------------------------------------------------ train

    @property
    def total_iterations(self) -> int:
        """Base run + appended sparsify phase (trainer.cpp:332-361)."""
        extra = self.opt.sparsify_steps if self.opt.enable_sparsity else 0
        return self.opt.iterations + extra

    def background_for_step(self, iteration: int) -> np.ndarray:
        bg = np.zeros(3, np.float32)  # base background is black (trainer.cpp:363)
        if not self.opt.bg_modulation:
            return bg
        w = _inv_weight_piecewise(iteration, self.opt.iterations)
        if w <= 0:
            return bg
        return (1.0 - w) * bg + w * _sine_background(iteration, self._bg_rng)

    def _gut_cfg_for(self, cam):
        """Per-camera (StepConfig variant, distortion coefficients [12] on the device)."""
        # stable identity, not id(): a freed-and-reallocated camera object could reuse
        # an id and silently pick up another camera's distortion coefficients
        key = (cam.uid, cam.image_name)
        hit = self._gut_cfg_cache.get(key)
        if hit is not None:
            return hit
        full = CameraParams.from_camera(cam)
        static = CameraParams(model=full.model, shutter=full.shutter)
        cfg = dataclasses.replace(self.step_cfg, cam_params=static, max_angle=None)
        out = (cfg, torch.as_tensor(full.coeff_vector(), device=self.device))
        self._gut_cfg_cache[key] = out
        return out

    def _device(self, x: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(x, np.float32), device=self.device)

    def _dispatch_step(self, sample, iteration: int) -> PendingStep:
        prev, rng_state = self.state, self.state.rng.get_state()
        cam = sample.camera
        cfg, dist = (
            self._gut_cfg_for(cam) if self.step_cfg.gut else (self.step_cfg, None)
        )
        self.state, stats = train_step(
            self.state,
            self._device(sample.image),
            self._device(cam.world_view_transform),
            self._device(cam.cam_position),
            sample.fx, sample.fy, sample.cx, sample.cy,
            self._device(self.background_for_step(iteration)),
            sample.index,
            dist,
            width=cam.image_width, height=cam.image_height,
            plan=self.plan, opt=cfg,
            total_iterations=self.opt.iterations,
        )
        self.steps_dispatched += 1
        return PendingStep(iteration=iteration, prev_state=prev, rng_state=rng_state,
                           stats=stats, plan=self.plan)

    def _dispatch_batched(self, samples, iteration: int) -> PendingStep:
        """One optimizer step over `batch_size` cameras on the mesh (trainer.py:354-391).
        Every rank holds the same samples; the step renders its data group's."""
        prev, rng_state = self.state, self.state.rng.get_state()
        cams = [s.camera for s in samples]
        w, h = cams[0].image_width, cams[0].image_height
        if any(c.image_width != w or c.image_height != h for c in cams):
            raise ValueError("batched training requires uniform image sizes")
        cfg, dist_coeffs = self.step_cfg, None
        if self.step_cfg.gut:
            pairs = [self._gut_cfg_for(c) for c in cams]
            cfg = pairs[0][0]  # a uniform (model, shutter), checked at init
            dist_coeffs = torch.stack([p[1] for p in pairs])
        self.state, stats = self._batched_step(
            self.state,
            np.stack([s.image for s in samples]),
            np.stack([c.world_view_transform for c in cams]).astype(np.float32),
            np.stack([c.cam_position for c in cams]).astype(np.float32),
            np.asarray([[s.fx, s.fy, s.cx, s.cy] for s in samples], np.float32),
            self._device(self.background_for_step(iteration)),
            [s.index for s in samples],
            dist_coeffs,
            width=w, height=h, plan=self.plan, opt=cfg,
            total_iterations=self.opt.iterations,
        )
        self.steps_dispatched += 1
        return PendingStep(iteration=iteration, prev_state=prev, rng_state=rng_state,
                           stats=stats, plan=self.plan)

    def _scan_chunk(self, it: int, total: int, progress_every: int) -> int:
        """Steps foldable into one dispatch from `it`: stop at the FIRST iteration that
        any host hook fires on (that iteration becomes the chunk's last step, so the
        existing hook code runs at the right boundary)."""
        k_max = min(int(getattr(self.opt, "scan_steps", 1) or 1), total - it + 1)
        if k_max <= 1:
            return 1
        opt = self.opt
        for j in range(it, it + k_max):
            if (
                self._needs_topology_hook(j)
                or j % progress_every == 0
                or self._timelapse_due(j)
                or (opt.enable_eval and j in opt.eval_steps)
                or j in opt.save_steps
                or (self.checkpoint_every and j % self.checkpoint_every == 0)
                or j == total
            ):
                return j - it + 1
        return k_max

    def _dispatch_scan(self, samples, iteration: int) -> Optional[PendingStep]:
        """K steps in one `train_step_many` call. Returns None when the samples are
        heterogeneous (mixed image sizes, or mixed GUT camera configs) — the caller
        falls back to per-step dispatch."""
        cams = [s.camera for s in samples]
        w, h = cams[0].image_width, cams[0].image_height
        if any(c.image_width != w or c.image_height != h for c in cams):
            return None
        if self.step_cfg.gut:
            pairs = [self._gut_cfg_for(c) for c in cams]
            cfg = pairs[0][0]
            if any(p[0] != cfg for p in pairs[1:]):
                return None
            dists = torch.stack([p[1] for p in pairs])
        else:
            cfg, dists = self.step_cfg, None
        prev, rng_state = self.state, self.state.rng.get_state()
        k = len(samples)
        self.state, stats = train_step_many(
            self.state,
            self._device(np.stack([s.image for s in samples])),
            self._device(np.stack([c.world_view_transform for c in cams])),
            self._device(np.stack([c.cam_position for c in cams])),
            np.asarray([[s.fx, s.fy, s.cx, s.cy] for s in samples], np.float32),
            self._device(np.stack([self.background_for_step(iteration + j)
                                   for j in range(k)])),
            np.asarray([s.index for s in samples], np.int32),
            dists,
            width=w, height=h, plan=self.plan, opt=cfg,
            total_iterations=self.opt.iterations,
        )
        self.steps_dispatched += k
        # budget checks cover the whole chunk (max); loss keeps the full [K] vector so
        # the history records every step
        reduced = StepStats(
            loss=stats.loss,
            total_instances=stats.total_instances.max(),
            max_tile_count=stats.max_tile_count.max(),
            n_visible=stats.n_visible.max(),
            n_shard_visible=stats.n_shard_visible.max(),
        )
        return PendingStep(iteration=iteration, prev_state=prev, rng_state=rng_state,
                           stats=reduced, plan=self.plan)

    def _check_pending(self, pending: PendingStep) -> bool:
        """Validate a completed step's budget counters; grow plan / request redo."""
        total = int(pending.stats.total_instances)
        max_tile = int(pending.stats.max_tile_count)
        plan = pending.plan
        redo = False
        new_plan = plan
        # dataclasses.replace keeps pack_bf16 across replans
        if total > plan.max_instances:
            new_plan = dataclasses.replace(
                new_plan, max_instances=_next_bucket(int(total * 1.3)))
            redo = True
        elif total > 0.85 * plan.max_instances:
            new_plan = dataclasses.replace(
                new_plan, max_instances=_next_bucket(int(plan.max_instances * 1.3)))
        # the JAX blend kernel's per-tile checkpoint caps capacity at 512 chunks
        # (ops/pallas/raster.py); the port keeps the clamp so its plans equal JAX's
        k_cap = 512 * plan.chunk
        if max_tile > new_plan.k_max:
            k_want = _next_pow2(int(max_tile * 1.3))
            if k_want > k_cap:
                log.warning(
                    "k_max request %d exceeds kernel capacity %d (tile with %d "
                    "instances); clamping — denser tiles will be truncated",
                    k_want, k_cap, max_tile,
                )
            new_plan = dataclasses.replace(new_plan, k_max=min(k_want, k_cap))
            redo = max_tile <= k_cap  # beyond capacity a redo cannot help
        elif max_tile > 0.85 * new_plan.k_max and new_plan.k_max * 2 <= k_cap:
            new_plan = dataclasses.replace(new_plan, k_max=new_plan.k_max * 2)
        # batched: the per-shard visible count against the compaction budget
        if plan.gather_budget is not None:
            nsv = int(pending.stats.n_shard_visible)
            if nsv > plan.gather_budget:
                new_plan = dataclasses.replace(
                    new_plan,
                    gather_budget=min(_next_bucket(int(nsv * 1.3)), self.shard_capacity))
                redo = True
            elif nsv > 0.85 * plan.gather_budget and new_plan.gather_budget < self.shard_capacity:
                new_plan = dataclasses.replace(
                    new_plan, gather_budget=min(_next_bucket(int(plan.gather_budget * 1.3)),
                                                self.shard_capacity))
        if new_plan != plan:
            log.info(
                "raster plan %s -> %s at iter %d (instances %d, max tile %d)%s",
                (plan.max_instances, plan.k_max), (new_plan.max_instances, new_plan.k_max),
                pending.iteration, total, max_tile, " [REDO]" if redo else "",
            )
            self.plan = new_plan
        return redo

    def _check_or_roll_back(self, chk: PendingStep) -> bool:
        """Check one pending step; on overflow restore its input state and the generator,
        and return True (the caller redoes from chk.iteration)."""
        plan = self.plan
        redo = self._check_pending(chk)
        if self.plan != plan:
            self.plan_history.append((chk.iteration, self.plan.max_instances,
                                      self.plan.k_max, redo))
        if redo:
            self.n_redo += 1
            self.state = chk.prev_state
            self.state.rng.set_state(chk.rng_state)
            return True
        self._record_losses(chk)
        return False

    def _flush_pending(self, pending: list[PendingStep]) -> Optional[int]:
        """Drain all pending checks; on overflow roll back and return the redo iteration."""
        t0 = time.perf_counter()
        try:
            while pending:
                chk = pending.pop(0)
                if self._check_or_roll_back(chk):
                    pending.clear()
                    return chk.iteration
            return None
        finally:
            self.timings["pending_checks"] += time.perf_counter() - t0

    def _record_losses(self, chk: PendingStep) -> None:
        """Append a checked step's loss(es); scan chunks carry a [K] vector."""
        self._loss_hist.extend(chk.stats.loss.reshape(-1).tolist())

    def _topology_hooks(self, it: int) -> None:
        """Strategy + sparsity schedule (runs with no steps in flight). In a batched run
        on the gathered state, alike on every rank (the same state and generator), then
        re-sharded."""
        if self.mesh is not None:
            self.state = self.full_state()
        try:
            self._run_topology_hooks(it)
        finally:
            if self.mesh is not None:
                self.state = shard_train_state(self.mesh, self.state)

    def _run_topology_hooks(self, it: int) -> None:
        opt = self.opt
        if opt.strategy == "mcmc":
            if strategy_mcmc.is_refining(it, opt.start_refine, opt.stop_refine,
                                         opt.refine_every):
                self.state, info = refine_step(
                    self.state, min_opacity=opt.min_opacity, max_cap=opt.max_cap
                )
                self._refined(it, "mcmc", info)
        elif opt.strategy == "default":
            if strategy_default.is_refining(
                it, opt.start_refine, opt.stop_refine, opt.refine_every,
                opt.reset_every, opt.pause_refine_after_reset,
            ):
                self.state, info = adc_refine_step(
                    self.state,
                    grad_threshold=opt.grad_threshold, grow_scale3d=opt.grow_scale3d,
                    prune_opacity=opt.prune_opacity, prune_scale3d=opt.prune_scale3d,
                    reset_every=opt.reset_every, revised_opacity=opt.revised_opacity,
                )
                self._refined(it, "adc", info)
            if it < opt.stop_refine and it % opt.reset_every == 0 and it > 0:
                self.state = adc_reset_opacity_step(self.state,
                                                    prune_opacity=opt.prune_opacity)
                self.refine_log.append(dict(iteration=it, kind="reset_opacity"))
                log.info("opacity reset @%d", it)

        if opt.enable_sparsity:
            start, steps = opt.iterations, opt.sparsify_steps
            if it == start:  # lazy init on phase entry (trainer.cpp:629-634)
                self.state = admm_init_step(self.state, prune_ratio=opt.prune_ratio)
                self.refine_log.append(dict(iteration=it, kind="admm_init"))
                log.info("ADMM sparsity initialized @%d", it)
            elif sp.should_update(it, start, steps):
                self.state = admm_update_step(self.state, prune_ratio=opt.prune_ratio)
                self.refine_log.append(dict(iteration=it, kind="admm_update"))
            if sp.should_prune(it, start, steps):
                n_before = int(self.state.splat.n_alive())
                self.state, n = sparsity_prune_step(self.state, prune_ratio=opt.prune_ratio)
                self.refine_log.append(dict(iteration=it, kind="sparsity_prune",
                                            n_before=n_before, n_pruned=int(n)))
                log.info("sparsity prune @%d: removed %d gaussians", it, int(n))

    def _refined(self, it: int, kind: str, info: dict) -> None:
        counts = {k: int(v) for k, v in info.items()}
        self.refine_log.append(dict(iteration=it, kind=kind, **counts))
        log.debug("%s refine @%d: %s", kind, it, counts)
        self._emit(ev.ModelUpdated(iteration=it, n_alive=counts["n_alive"]))

    def _needs_topology_hook(self, it: int) -> bool:
        opt = self.opt
        if opt.strategy == "mcmc" and strategy_mcmc.is_refining(
            it, opt.start_refine, opt.stop_refine, opt.refine_every
        ):
            return True
        if opt.strategy == "default":
            if strategy_default.is_refining(
                it, opt.start_refine, opt.stop_refine, opt.refine_every,
                opt.reset_every, opt.pause_refine_after_reset,
            ):
                return True
            if it < opt.stop_refine and it % opt.reset_every == 0 and it > 0:
                return True
        if opt.enable_sparsity:
            start, steps = opt.iterations, opt.sparsify_steps
            if (it == start or sp.should_update(it, start, steps)
                    or sp.should_prune(it, start, steps)):
                return True
        return False

    def _next_sample(self, loader):
        t0 = time.perf_counter()
        sample = next(loader)
        self.samples_drawn += 1
        self.timings["data_wait"] += time.perf_counter() - t0
        return sample

    def _dispatch(self, loader, it: int, total: int, progress_every: int,
                  pending: list[PendingStep]) -> int:
        """Dispatch the step or chunk that starts at `it`; -> its last iteration."""
        if self.mesh is not None:
            samples = [self._next_sample(loader) for _ in range(self.batch_size)]
            t0 = time.perf_counter()
            pending.append(self._dispatch_batched(samples, it))
            self.timings["dispatch"] += time.perf_counter() - t0
            return it
        k = self._scan_chunk(it, total, progress_every)
        samples = [self._next_sample(loader) for _ in range(k)]
        t0 = time.perf_counter()
        ps = self._dispatch_scan(samples, it) if k > 1 else None
        if ps is not None:
            pending.append(ps)
        else:  # one step, or heterogeneous samples: per-step dispatch
            for j, s in enumerate(samples):
                pending.append(self._dispatch_step(s, it + j))
        self.timings["dispatch"] += time.perf_counter() - t0
        return it + k - 1

    def train(self, progress_every: int = 100) -> None:
        opt = self.opt
        loader = InfiniteDataLoader(
            self.train_dataset, num_workers=min(opt.num_workers, 8), seed=7,
            skip=self.samples_drawn,
        )
        out_dir = Path(self.params.dataset.output_path or "output")
        out_dir.mkdir(parents=True, exist_ok=True)
        self._emit(ev.TrainingStarted(total_iterations=self.total_iterations))
        pending: list[PendingStep] = []
        t0 = time.time()
        it = self.state.iteration  # > 1 when resumed from a checkpoint
        total = self.total_iterations
        try:
            while it <= total:
                it = self._dispatch(loader, it, total, progress_every, pending)

                # keep 2 steps in flight; check the older one
                if len(pending) >= 2:
                    t1 = time.perf_counter()
                    chk = pending.pop(0)
                    redo = self._check_or_roll_back(chk)
                    self.timings["pending_checks"] += time.perf_counter() - t1
                    if redo:
                        it = chk.iteration
                        pending.clear()
                        continue

                if self._needs_topology_hook(it):
                    redo = self._flush_pending(pending)
                    if redo is not None:
                        it = redo
                        continue
                    t1 = time.perf_counter()
                    self._topology_hooks(it)
                    self.timings["hooks"] += time.perf_counter() - t1

                if it % progress_every == 0 and self._loss_hist:
                    rate = it / (time.time() - t0)
                    self._live_rate = rate  # the live viewer's /status
                    n_alive = self.n_alive()
                    log.info(
                        "iter %d/%d loss %.4f alive %d %.2f it/s",
                        it, total, self._loss_hist[-1], n_alive, rate,
                    )
                    self._emit(ev.TrainingProgress(
                        iteration=it, total_iterations=total,
                        loss=self._loss_hist[-1], n_alive=n_alive, iters_per_s=rate,
                    ))
                if self._timelapse_due(it):
                    redo = self._flush_pending(pending)
                    if redo is not None:
                        it = redo
                        continue
                    t1 = time.perf_counter()
                    self._render_timelapse(it, out_dir)
                    self.timings["timelapse"] += time.perf_counter() - t1
                stop, pause, save = self._control_flags()
                if stop:
                    log.info("stop requested at iter %d", it)
                    self._emit(ev.TrainingStopped(iteration=it))
                    break
                if pause:
                    self._emit(ev.TrainingPaused(iteration=it))
                    while pause and not stop:
                        time.sleep(0.1)
                        stop, pause, save = self._control_flags()
                    self._emit(ev.TrainingResumed(iteration=it))
                if save:
                    self._save_flag.clear()
                    redo = self._flush_pending(pending)
                    if redo is not None:
                        it = redo
                        continue
                    t1 = time.perf_counter()
                    self.save_checkpoint(out_dir / f"checkpoint_{it}.npz", it)
                    self.timings["save"] += time.perf_counter() - t1
                if opt.enable_eval and it in opt.eval_steps:
                    redo = self._flush_pending(pending)
                    if redo is not None:
                        it = redo
                        continue
                    t1 = time.perf_counter()
                    self.evaluate(it)
                    self.timings["eval"] += time.perf_counter() - t1
                if it in opt.save_steps and not opt.skip_intermediate_saving and it != total:
                    t1 = time.perf_counter()
                    path = out_dir / f"splat_{it}.ply"
                    self.save_ply(path)
                    if self.project is not None:
                        self.project.add_ply(f"iter_{it}", path, iteration=it)
                    self.timings["save"] += time.perf_counter() - t1
                if self.checkpoint_every and it % self.checkpoint_every == 0:
                    redo = self._flush_pending(pending)
                    if redo is not None:
                        it = redo
                        continue
                    t1 = time.perf_counter()
                    self.save_checkpoint(out_dir / f"checkpoint_{it}.npz", it)
                    self.timings["save"] += time.perf_counter() - t1
                it += 1

            # a redo found here would have to re-run steps the loop has finished; as in
            # the JAX trainer, the last check only records, and the history shows it
            self._flush_pending(pending)
            t1 = time.perf_counter()
            final = self.full_state()
            self.save_ply(out_dir / "splat_final.ply", final)
            self.timings["save"] += time.perf_counter() - t1
            self._emit(ev.TrainingFinished(iteration=it - 1))
            if opt.save_sog and self.is_lead:
                from ..io.sog import save_sog

                t1 = time.perf_counter()
                save_sog(out_dir / "splat_final.sog", self._alive_arrays(final),
                         kmeans_iterations=opt.sog_iterations, device=self.device,
                         timings=self.sog_timings)
                self.timings["save"] += time.perf_counter() - t1
            if opt.enable_eval and self.is_lead:
                self.evaluator.save_report()
            self._barrier()
        finally:
            loader.close()
            for unsubscribe in self._unsubscribe:
                unsubscribe()
            writer().flush()  # all queued artifact writes are on disk before we return

    # ------------------------------------------------------------- eval/save

    def n_alive(self) -> int:
        """The alive count of the whole pool (a collective of the gauss group in a
        batched run)."""
        count = self.state.splat.n_alive()
        if self.mesh is not None:
            count = self.mesh.all_reduce(count, "gauss")
        return int(count)

    def render_camera(self, sample, state: TrainState | None = None) -> torch.Tensor:
        """An eval render of `sample`'s camera from `state` (the Trainer's when None;
        counted in `eval_renders`)."""
        self.eval_renders += 1
        return self._render_sample(sample, state)

    @torch.no_grad()
    def _render_sample(self, sample, state: TrainState | None = None) -> torch.Tensor:
        cam = sample.camera
        state = self.state if state is None else state
        splat = state.splat
        sh_deg = active_sh_degree(state.iteration, self.opt.sh_degree_interval,
                                  splat.max_sh_degree)
        args = (
            splat.means, splat.scaling_raw, splat.rotation_raw, splat.opacity_raw,
            splat.sh0, splat.shN, splat.alive,
            self._device(cam.world_view_transform), self._device(cam.cam_position),
            sample.fx, sample.fy, sample.cx, sample.cy,
            sh_deg, torch.zeros(3, device=self.device),
        )
        if self.step_cfg.gut:
            cfg, dist = self._gut_cfg_for(cam)
            out = rasterize_gut(
                *args, width=cam.image_width, height=cam.image_height,
                max_instances=self.plan.max_instances, k_max=self.plan.k_max,
                tile_size=self.plan.tile_size, cam_params=cfg.cam_params,
                max_angle=None, dist=dist, device=self.device,
            )
        else:
            out = rasterize(
                *args, width=cam.image_width, height=cam.image_height,
                max_instances=self.plan.max_instances, k_max=self.plan.k_max,
                chunk=self.plan.chunk, tile_size=self.plan.tile_size, device=self.device,
            )
        return out.image

    def evaluate(self, iteration: int):
        """Scores the val split on rank 0 (from the gathered state in a batched run; the
        other ranks return None at the barrier)."""
        state = self.full_state()
        if not self.is_lead:
            self._barrier()
            return None
        self._emit(ev.EvaluationStarted(iteration=iteration, num_images=len(self.val_dataset)))
        samples = (self.val_dataset.get(i) for i in range(len(self.val_dataset)))
        result = self.evaluator.evaluate(
            iteration, lambda s: self.render_camera(s, state), samples,
            save_images=self.opt.enable_save_eval_images,
        )
        log.info(
            "eval @%d: PSNR %.3f SSIM %.4f LPIPS %s (%d imgs, %.1fs)",
            iteration, result.psnr, result.ssim,
            f"{result.lpips:.4f}" if result.lpips is not None else "n/a",
            result.num_images, result.elapsed_s,
        )
        self._emit(ev.EvaluationCompleted(
            iteration=iteration, psnr=result.psnr, ssim=result.ssim,
            lpips=result.lpips, num_images=result.num_images,
        ))
        self._barrier()
        return result

    # -------------------------------------------------------------- timelapse

    def _timelapse_due(self, it: int) -> bool:
        ds = self.params.dataset
        return bool(ds.timelapse_images) and ds.timelapse_every > 0 and \
            it % ds.timelapse_every == 0

    def _render_timelapse(self, it: int, out_dir: Path) -> None:
        """Render the watched training views (trainer.cpp:812-846) to
        `timelapse/<image stem>/<it:06d>.png`; the PNG writes run on the artifact writer."""
        wanted = set(self.params.dataset.timelapse_images)
        state = self.full_state()
        if not self.is_lead:
            self._barrier()
            return
        for idx, cam in enumerate(self.train_cams):
            if cam.image_name not in wanted and Path(cam.image_name).stem not in wanted:
                continue
            sample = self.train_dataset.get(idx)
            self.timelapse_renders += 1
            img = torch.clamp(self._render_sample(sample, state), 0, 1).cpu().numpy()
            d = out_dir / "timelapse" / Path(cam.image_name).stem
            d.mkdir(parents=True, exist_ok=True)
            writer().submit(save_image, str(d / f"{it:06d}.png"), img)
        self._barrier()

    def _alive_arrays(self, state: TrainState | None = None) -> dict:
        splat = (self.state if state is None else state).splat
        alive = splat.alive
        return {k: v[alive].cpu().numpy() for k, v in splat.params().items()}

    def save_ply(self, path: str | Path, state: TrainState | None = None) -> None:
        """Device->host gather now; the disk write runs on the artifact writer thread
        (reference: detached save thread, splat_data.cpp:455-477). train() flushes the
        writer before returning. In a batched run rank 0 writes the gathered state
        (`state`, gathered here when None); the other ranks write nothing."""
        state = self.full_state() if state is None else state
        if not self.is_lead:
            return
        a = self._alive_arrays(state)
        n = a["means"].shape[0]

        def _write():
            save_splat_ply(
                path, a["means"], a["sh0"], a["shN"],
                a["scaling_raw"], a["rotation_raw"], a["opacity_raw"],
            )
            log.info("saved %d gaussians to %s", n, path)

        writer().submit(_write)
