"""The port's Trainer and training CLI, on the CPU.

Against the JAX package (its functions, never its `Trainer.train`, whose runs are the
tier-1 suite's long pole): `_next_pow2`, `_next_bucket`, `_sine_background` and
`_inv_weight_piecewise` exactly; the plan-growth decisions of `Trainer._check_pending`
(called unbound) over a table of (plan, total, max tile) cases, `pack_bf16` surviving and
the 512-chunk clamp included; `_scan_chunk`'s chunk boundaries over whole schedules; and
`cli.params_from_args` on the same argv.

The port on its own: a 60-iteration run at the size of `tests/test_io_and_trainer.py::
test_trainer_end_to_end` through `cli.main([... "--headless", "--device", "cpu"])` (finite,
falling loss, PSNR > 10 on the one val image, PLY with n == n_alive, the CLI's files); a
forced overflow that rolls back the state and the generator, grows the plan and keeps
`pack_bf16`, with one loss per iteration; a short `--gut` run on an OPENCV capture; that a
distorted capture without `--gut`, and training with no card and no `--device cpu`, raise;
each flag of the ADC / checkpoint / component slice trained for 12 iterations through
`cli.main` with its effect checked (`test_ported_flags_train`); `--batch-size 2` and `4`
through `cli.main` on a 1x1 mesh, the mesh over 1, 2, 4 and 8 ranks against the JAX
Trainer's own over as many virtual devices, the gather budget's growth and redo in the plan
table, the data loader's draw order with several threads, and the CLI over two gloo ranks
against one process.
"""

import csv
import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from tpu_splat import cli as jax_cli
from tpu_splat.core.config import OptimizationParameters as JaxOptimizationParameters
from tpu_splat.training import train_step as jax_ts
from tpu_splat.training import trainer as jax_trainer
from tpu_splat_torch import cli
from tpu_splat_torch.core.config import DatasetConfig, OptimizationParameters, TrainingParameters
from tpu_splat_torch.io import colmap
from tpu_splat_torch.io.ply import load_splat_ply, save_splat_ply
from tpu_splat_torch.training import trainer
from tpu_splat_torch.training.train_step import RasterPlan

from synth_data import make_raytraced_colmap, make_synthetic_colmap, write_colmap_binary


def test_buckets_and_schedules_match_jax():
    xs = list(range(0, 3000)) + [int(v) for v in np.geomspace(3000, 5e7, 400)]
    for x in xs:
        assert trainer._next_pow2(x) == jax_trainer._next_pow2(x), x
        assert trainer._next_bucket(x) == jax_trainer._next_bucket(x), x
    for total in (1, 60, 30_000):
        for step in range(0, 2 * total + 2, max(1, total // 97)):
            assert trainer._inv_weight_piecewise(step, total) == \
                jax_trainer._inv_weight_piecewise(step, total)
    got_rng, want_rng = np.random.default_rng(1234), np.random.default_rng(1234)
    for step in range(300):
        got = trainer._sine_background(step, got_rng)
        want = jax_trainer._sine_background(step, want_rng)
        assert got.dtype == want.dtype and np.array_equal(got, want), step


PLAN_CASES = [  # (max_instances, k_max, chunk, pack_bf16, total, max_tile[, gather
    # budget, shard visible, shard capacity])
    (1 << 16, 4096, 256, True, 1000, 100),  # well inside: no change
    (1 << 16, 4096, 256, True, 60_000, 100),  # > 0.85 budget: grow, no redo
    (1 << 16, 4096, 256, True, 70_000, 100),  # overflow: grow + redo
    (1 << 16, 4096, 256, True, 1000, 3600),  # > 0.85 k_max: double
    (1 << 16, 4096, 256, True, 1000, 5000),  # tile overflow: grow + redo
    (1 << 16, 65536, 128, False, 1000, 65000),  # at the 512-chunk cap (128): no doubling
    (1 << 16, 4096, 128, True, 1000, 70_000),  # beyond 512 * 128: clamp, no redo
    (1 << 16, 4096, 256, False, 99_000, 9000),  # both overflow
    (1 << 20, 1 << 17, 256, True, 10, 120_000),  # cap 2^17: no doubling past it
    (3 << 17, 4096, 256, True, 1 << 22, 4000),  # big jump
    # the batched step's gather budget (per-shard visible count against it)
    (1 << 16, 4096, 256, True, 1000, 100, 1024, 500, 4096),  # inside: no change
    (1 << 16, 4096, 256, True, 1000, 100, 1024, 900, 4096),  # > 0.85: grow, no redo
    (1 << 16, 4096, 256, True, 1000, 100, 1024, 1500, 4096),  # overflow: grow + redo
    (1 << 16, 4096, 256, True, 1000, 100, 1024, 5000, 4096),  # overflow past the shard
    (1 << 16, 4096, 256, True, 1000, 100, 4096, 4000, 4096),  # at the shard: no growth
    (1 << 16, 4096, 256, True, 70_000, 5000, 1024, 1500, 2048),  # all three overflow
]


@pytest.mark.parametrize("case", PLAN_CASES)
def test_plan_growth_matches_jax(case):
    max_inst, k_max, chunk, bf16, total, max_tile, *batched = case
    budget, nsv, shard_cap = batched or (None, 0, 1)
    kw = dict(max_instances=max_inst, k_max=k_max, chunk=chunk, tile_size=32, pack_bf16=bf16,
              gather_budget=budget)
    jplan, plan = jax_ts.RasterPlan(**kw), RasterPlan(**kw)
    stats = types.SimpleNamespace(total_instances=total, max_tile_count=max_tile,
                                  n_shard_visible=nsv)
    # the JAX Trainer reads a (data 1, gauss 4) mesh and the global capacity, the port's
    # its shard's capacity
    jself = types.SimpleNamespace(
        plan=jplan, mesh=types.SimpleNamespace(shape={"data": 1, "gauss": 4}) if batched
        else None, state=types.SimpleNamespace(splat=types.SimpleNamespace(
            capacity=4 * shard_cap)))
    pself = types.SimpleNamespace(plan=plan, shard_capacity=shard_cap)
    want = jax_trainer.Trainer._check_pending(
        jself, types.SimpleNamespace(stats=stats, plan=jplan, iteration=7))
    got = trainer.Trainer._check_pending(
        pself, types.SimpleNamespace(stats=stats, plan=plan, iteration=7))
    assert got == want
    assert dataclasses.asdict(pself.plan) == dataclasses.asdict(jself.plan)
    assert pself.plan.pack_bf16 == bf16


SCAN_CASES = [  # (scan_steps, progress_every, eval_on, checkpoint_every, other fields)
    (8, 100, True, 0, {}), (8, 7, False, 0, {}), (1, 100, True, 0, {}), (5, 20, True, 0, {}),
    (8, 100, True, 0, dict(strategy="default", reset_every=90, pause_refine_after_reset=20)),
    (8, 100, False, 45, dict(strategy="default", reset_every=60)),
    (8, 100, True, 0, dict(enable_sparsity=True, iterations=200, sparsify_steps=110)),
    (5, 33, False, 16, dict(strategy="default", enable_sparsity=True, iterations=170,
                            sparsify_steps=130, reset_every=64)),
]


@pytest.mark.parametrize("scan_steps,progress_every,eval_on,checkpoint_every,extra", SCAN_CASES)
def test_scan_chunks_match_jax(scan_steps, progress_every, eval_on, checkpoint_every, extra):
    fields = dict(iterations=300, refine_every=25, start_refine=30, stop_refine=250,
                  eval_steps=[50, 123, 300], save_steps=[77, 300], enable_eval=eval_on,
                  scan_steps=scan_steps)
    fields.update(extra)
    jopt = JaxOptimizationParameters(**fields)
    opt = OptimizationParameters(**fields)
    jself = types.SimpleNamespace(opt=jopt, checkpoint_every=checkpoint_every,
                                  _timelapse_due=lambda j: False)
    jself._needs_topology_hook = lambda j: jax_trainer.Trainer._needs_topology_hook(jself, j)
    jself.total_iterations = jax_trainer.Trainer.total_iterations.fget(jself)
    pself = types.SimpleNamespace(opt=opt, checkpoint_every=checkpoint_every,
                                  _timelapse_due=lambda j: False)
    pself._needs_topology_hook = lambda j: trainer.Trainer._needs_topology_hook(pself, j)
    total = trainer.Trainer.total_iterations.fget(pself)
    assert total == jself.total_iterations
    it, chunks, hooks = 1, [], 0
    while it <= total:
        k = trainer.Trainer._scan_chunk(pself, it, total, progress_every)
        assert k == jax_trainer.Trainer._scan_chunk(jself, it, total, progress_every), it
        chunks.append(k)
        it += k
        hooks += trainer.Trainer._needs_topology_hook(pself, it - 1)
    for j in range(1, total + 1):
        assert trainer.Trainer._needs_topology_hook(pself, j) == \
            jax_trainer.Trainer._needs_topology_hook(jself, j), j
    assert sum(chunks) == total and max(chunks) <= scan_steps and hooks > 3


ARGVS = [
    ["-d", "data", "-o", "out"],
    ["-d", "data", "-o", "out", "-i", "500", "--eval", "--test-every", "4", "--gut",
     "--sh-degree", "2", "--max-cap", "5000", "--resize_factor", "2", "--max-width", "800",
     "--images", "imgs", "--scan-steps", "4", "--bg-modulation", "--random",
     "--init-num-pts", "77", "--steps-scaler", "0.5", "--proj_path", "p.ls"],
    ["-d", "data", "-o", "out", "--config", "parameter/mcmc_optimization_params.json",
     "-i", "42", "--headless", "--skip-intermediate", "--init-ply", "x.ply"],
    ["-d", "data", "--config", "parameter/default_optimization_params.json", "--strategy",
     "default", "--timelapse-images", "a.png", "b.png", "--sog", "--batch-size", "2"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_params_from_args_matches_jax(argv):
    got = cli.params_from_args(cli.build_parser().parse_args(argv))
    want = jax_cli.params_from_args(jax_cli.build_parser().parse_args(argv))
    assert dataclasses.asdict(got.dataset) == dataclasses.asdict(want.dataset)
    assert got.optimization.to_json() == want.optimization.to_json()
    assert (got.ply_path, got.init_ply) == (want.ply_path, want.init_ply)


# ------------------------------------------------------------ the port's own runs


@pytest.fixture(scope="module")
def colmap_dir(tmp_path_factory):
    base = tmp_path_factory.mktemp("colmap_scene")
    make_synthetic_colmap(base, n_gauss=120, n_cams=6, size=48)
    return base


def _keep_trainer(monkeypatch) -> list:
    """Record the Trainer that cli.main builds."""
    kept, train = [], trainer.Trainer.train

    def recording_train(self, *a, **kw):
        kept.append(self)
        return train(self, *a, **kw)

    monkeypatch.setattr(trainer.Trainer, "train", recording_train)
    return kept


def test_cli_trains_end_to_end_on_cpu(colmap_dir, tmp_path, monkeypatch):
    cfg = tmp_path / "opt.json"
    cfg.write_text(json.dumps(dict(
        max_cap=256, refine_every=20, start_refine=9, stop_refine=55, eval_steps=[60],
        save_steps=[60], num_workers=2, enable_save_eval_images=False,
        sh_degree_interval=20)))
    kept = _keep_trainer(monkeypatch)
    out = tmp_path / "out"
    rc = cli.main(["-d", str(colmap_dir), "-o", str(out), "--config", str(cfg), "-i", "60",
                   "--eval", "--test-every", "6", "--headless", "--device", "cpu"])
    assert rc == 0
    (t,) = kept
    losses = t._loss_hist
    assert len(losses) == 60 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    assert t.state.iteration == 61
    back = load_splat_ply(out / "splat_final.ply")
    assert back["means"].shape[0] == int(t.state.splat.n_alive())
    res = t.evaluator.results[-1]
    assert res.num_images == 1 and res.psnr > 10, res
    with open(out / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    assert [r["iteration"] for r in rows] == ["60"] and rows[0]["lpips"] == ""
    assert json.loads((out / "training_params.json").read_text())["optimization"][
        "iterations"] == 60
    project = json.loads((out / "out.ls").read_text())
    assert [p["name"] for p in project["plys"]] == ["final"]
    assert not (out / "out.ls.lock").exists()


def _small_params(base, out, test_every=8, **opt):
    fields = dict(iterations=12, max_cap=256, refine_every=100, start_refine=500,
                  eval_steps=[], save_steps=[], num_workers=1, scan_steps=4)
    fields.update(opt)
    return TrainingParameters(
        dataset=DatasetConfig(data_path=str(base), output_path=str(out), test_every=test_every),
        optimization=OptimizationParameters(**fields))


def test_overflow_rolls_back_state_and_generator(colmap_dir, tmp_path):
    t = trainer.Trainer(_small_params(colmap_dir, tmp_path / "o"), device="cpu")
    t.plan = RasterPlan(max_instances=64, k_max=8, chunk=256, tile_size=32, pack_bf16=True)
    s0 = t.state
    snap = {k: v.clone() for k, v in s0.splat.params().items()}
    g0 = s0.rng.get_state().clone()
    samples = [t.train_dataset.get(i) for i in (0, 1)]
    first = t._dispatch_step(samples[0], 1)
    second = t._dispatch_step(samples[1], 2)
    assert t.state.iteration == 3 and not torch.equal(s0.rng.get_state(), g0)
    assert t._check_or_roll_back(first)  # overflow: redo from iteration 1
    assert t.state is s0 and torch.equal(t.state.rng.get_state(), g0)
    assert t.plan.pack_bf16 and t.plan.max_instances > 64 and t.plan.k_max > 8
    assert t.plan_history == [(1, t.plan.max_instances, t.plan.k_max, True)]
    for k, v in s0.splat.params().items():  # the step left its input state untouched
        assert torch.equal(v, snap[k]), k
    # the redo is a function of (state, sample): the same draws give the same state
    redo = t._dispatch_step(samples[0], 1)
    assert not t._check_or_roll_back(redo)
    after = t.state
    t.state = s0
    t.state.rng.set_state(g0)
    t._dispatch_step(samples[0], 1)
    for k, v in t.state.splat.params().items():
        assert torch.equal(v, after.splat.params()[k]), k
    del second

    # a whole run from the tiny plan: redone, one loss per iteration
    t = trainer.Trainer(_small_params(colmap_dir, tmp_path / "o2"), device="cpu")
    t.plan = RasterPlan(max_instances=64, k_max=8, chunk=256, tile_size=32, pack_bf16=True)
    t.train(progress_every=100)
    assert t.n_redo >= 1 and t.plan_history[0][3] and t.plan.pack_bf16
    assert len(t._loss_hist) == 12 and np.isfinite(t._loss_hist).all()
    assert t.steps_dispatched > 12
    # the redo ran through the scan path, its chunks in the reused staging buffers
    assert t.opt.scan_steps == 4 and t.stage_allocs == 1


@pytest.fixture(scope="module")
def opencv_dir(tmp_path_factory):
    base = tmp_path_factory.mktemp("opencv") / "rt"
    cams = make_raytraced_colmap(base, n_cams=4, size=32, seed=1, n_sfm=160)
    pts, cols = colmap._read_points3d_bin(base / "sparse" / "0" / "points3D.bin")
    write_colmap_binary(base, cams, pts, cols / 255.0, camera_model="OPENCV",
                        distortion=(0.05, 0.0, 0.0, 0.0))
    return base


def test_gut_run_on_opencv_capture(opencv_dir, tmp_path):
    t = trainer.Trainer(_small_params(opencv_dir, tmp_path / "g", iterations=6, gut=True,
                                      enable_eval=True, eval_steps=[6], test_every=4),
                        device="cpu")
    assert t.step_cfg.gut and t.val_cams
    t.train(progress_every=100)
    assert len(t._loss_hist) == 6 and np.isfinite(t._loss_hist).all()
    cfg, dist = t._gut_cfg_for(t.train_cams[0])
    assert cfg.cam_params.model == "pinhole" and float(dist[0]) == pytest.approx(0.05)
    assert t.evaluator.results[-1].num_images == 1
    assert (tmp_path / "g" / "splat_final.ply").exists()


def test_heterogeneous_chunk_falls_back_to_single_steps():
    """Mixed image sizes in a chunk: `_dispatch_scan` declines (None) before it touches the
    state, and the caller dispatches step by step, as in the JAX Trainer."""
    cams = [types.SimpleNamespace(image_width=w, image_height=32) for w in (48, 48, 40)]
    samples = [types.SimpleNamespace(camera=c) for c in cams]
    pself = types.SimpleNamespace(step_cfg=trainer.StepConfig())
    assert trainer.Trainer._dispatch_scan(pself, samples, 1) is None
    jself = types.SimpleNamespace(step_cfg=jax_ts.StepConfig())
    assert jax_trainer.Trainer._dispatch_scan(jself, samples, 1) is None


def test_init_from_ply_and_random(colmap_dir, tmp_path):
    """--init-ply puts the PLY's Gaussians in the first slots of a pow2 pool; --random
    draws init_num_pts points (the JAX package's numpy draws, seed 42)."""
    rng = np.random.default_rng(9)
    n = 300
    raw = dict(means=rng.normal(0, 1, (n, 3)), sh0=rng.normal(0, 1, (n, 1, 3)),
               shN=rng.normal(0, 0.1, (n, 15, 3)), scaling_raw=rng.normal(-3, 0.5, (n, 3)),
               rotation_raw=rng.normal(0, 1, (n, 4)), opacity_raw=rng.normal(0, 1, (n, 1)))
    raw["rotation_raw"] /= np.linalg.norm(raw["rotation_raw"], axis=1, keepdims=True)
    save_splat_ply(tmp_path / "init.ply", **raw)
    params = _small_params(colmap_dir, tmp_path / "o")
    params.init_ply = str(tmp_path / "init.ply")
    t = trainer.Trainer(params, device="cpu")
    sp = t.state.splat
    assert sp.capacity == 512 and int(sp.n_alive()) == n and bool(sp.alive[:n].all())
    for k, v in raw.items():
        np.testing.assert_allclose(getattr(sp, k)[:n].numpy(), v, rtol=1e-6, atol=1e-7)
    t = trainer.Trainer(_small_params(colmap_dir, tmp_path / "r", random=True,
                                      init_num_pts=77), device="cpu")
    assert int(t.state.splat.n_alive()) == 77


def test_distorted_capture_needs_gut(opencv_dir, tmp_path):
    with pytest.raises(ValueError, match="--gut"):
        trainer.Trainer(_small_params(opencv_dir, tmp_path / "x"), device="cpu")


@pytest.mark.parametrize("batch", [2, 4])
def test_batched_cli_trains(colmap_dir, tmp_path, monkeypatch, batch):
    """`--batch-size B` on one device: a 1x1 mesh, one optimizer step over B cameras a
    iteration, with the gather budget of the JAX Trainer's rule."""
    kept = _keep_trainer(monkeypatch)
    out = tmp_path / "o"
    rc = cli.main(["-d", str(colmap_dir), "-o", str(out), "--device", "cpu", "--headless",
                   "-i", "8", "--max-cap", "256", "--batch-size", str(batch)])
    assert rc == 0
    (t,) = kept
    assert t.mesh is not None and t.mesh.shape == {"data": 1, "gauss": 1}
    assert t.steps_dispatched == 8 and t.samples_drawn == 8 * batch
    assert t.state.iteration == 9 and len(t._loss_hist) == 8
    assert np.isfinite(t._loss_hist).all()
    n0 = _sfm_points(colmap_dir)
    assert t.plan.gather_budget == min(trainer._next_bucket(2 * n0), t.state.splat.capacity)
    back = load_splat_ply(out / "splat_final.ply")
    assert back["means"].shape[0] == int(t.state.splat.n_alive())


def _sfm_points(base) -> int:
    from tpu_splat_torch.io.loader import load

    return int(load(str(base)).scene.points.shape[0])


def test_two_ranks_train_as_one_process(colmap_dir, tmp_path):
    """The CLI over two gloo ranks on the CPU (TPU_SPLAT_* variables, a (1, 2) mesh: the
    state split over two gauss shards, refines on the gathered state, rank 0 writing)
    against one process with the same flags: the same alive count, the means within 1e-5
    (the two windows' gradient sums add in another order), rank 0's outputs only."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from tpu_splat_torch.parallel.dryrun import free_port

    cfg = tmp_path / "opt.json"
    cfg.write_text(json.dumps(dict(max_cap=256, refine_every=3, start_refine=2, stop_refine=5,
                                   eval_steps=[], save_steps=[], num_workers=2)))
    flags = ["-d", str(colmap_dir), "--config", str(cfg), "-i", "6", "--headless",
             "--device", "cpu", "--batch-size", "2", "--mesh-data", "1"]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert cli.main(flags + ["-o", str(tmp_path / "one")]) == 0
    finally:
        torch.set_num_threads(n)
    repo = Path(__file__).resolve().parent.parent
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", TPU_SPLAT_COORDINATOR=f"localhost:{free_port()}",
               TPU_SPLAT_NUM_PROCESSES="2")
    procs = [subprocess.Popen([sys.executable, "-m", "tpu_splat_torch", *flags, "-o",
                               str(tmp_path / "two")], cwd=repo,
                              env=dict(env, TPU_SPLAT_PROCESS_ID=str(r)),
                              stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
             for r in range(2)]
    errs = [p.communicate(timeout=240)[1] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], errs[0][-2000:] + errs[1][-2000:]
    one, two = (load_splat_ply(tmp_path / d / "splat_final.ply") for d in ("one", "two"))
    assert two["means"].shape == one["means"].shape and one["means"].shape[0] > 0
    np.testing.assert_allclose(two["means"], one["means"], rtol=0, atol=1e-5)
    assert sorted(p.name for p in (tmp_path / "two").iterdir()) == sorted(
        p.name.replace("one.ls", "two.ls") for p in (tmp_path / "one").iterdir())


# rank 1 alone asks for a checkpoint before its first step and for a stop after the save
_ONE_RANK_ASKS = """
import os, sys
from tpu_splat_torch import cli
from tpu_splat_torch.training.trainer import Trainer
from tpu_splat_torch.utils import events as ev

if os.environ["TPU_SPLAT_PROCESS_ID"] == "1":
    train, save = Trainer.train, Trainer.save_checkpoint

    def asking_train(self, *a, **k):
        ev.emit(ev.SaveCheckpoint())
        return train(self, *a, **k)

    def save_then_stop(self, *a, **k):
        save(self, *a, **k)
        ev.emit(ev.StopTraining())

    Trainer.train, Trainer.save_checkpoint = asking_train, save_then_stop
sys.exit(cli.main(sys.argv[1:]))
"""


def test_two_ranks_save_and_stop_when_one_asks(colmap_dir, tmp_path):
    """A SaveCheckpoint and a StopTraining seen by rank 1 alone: both ranks gather and save
    at iteration 1 (rank 0 writes the checkpoint) and stop at iteration 2, where a rank
    acting alone would wait forever in the other's collectives."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from tpu_splat_torch.parallel.dryrun import free_port

    cfg = tmp_path / "opt.json"
    cfg.write_text(json.dumps(dict(max_cap=256, eval_steps=[], save_steps=[], num_workers=1)))
    out = tmp_path / "two"
    flags = ["-d", str(colmap_dir), "--config", str(cfg), "-i", "6", "--headless",
             "--device", "cpu", "--batch-size", "2", "--mesh-data", "1", "-o", str(out)]
    repo = Path(__file__).resolve().parent.parent
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", TPU_SPLAT_COORDINATOR=f"localhost:{free_port()}",
               TPU_SPLAT_NUM_PROCESSES="2")
    procs = [subprocess.Popen([sys.executable, "-c", _ONE_RANK_ASKS, *flags], cwd=repo,
                              env=dict(env, TPU_SPLAT_PROCESS_ID=str(r)),
                              stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
             for r in range(2)]
    try:
        errs = [p.communicate(timeout=180)[1].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], errs[0][-2000:] + errs[1][-2000:]
    assert sorted(p.name for p in out.glob("*.npz")) == ["checkpoint_1.npz"]
    assert (out / "splat_final.ply").exists()
    assert "stop requested at iter 2" in errs[0] + errs[1]


MESH_CASES = [  # (batch, --mesh-data, --mesh-gauss)
    (1, 0, 0), (2, 0, 0), (4, 0, 0), (3, 0, 0), (4, 2, 0), (4, 0, 2), (2, 1, 0), (8, 0, 4),
]


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_mesh_shape_matches_jax_trainer(colmap_dir, tmp_path, monkeypatch, world):
    """`parallel/mesh.py::trainer_mesh_shape` against the JAX Trainer's own mesh over the
    first `world` of the conftest's 8 virtual devices. Where the JAX Trainer would leave
    devices idle, the port (whose ranks are launched processes) refuses."""
    import jax

    from tpu_splat.core.config import DatasetConfig as JaxDatasetConfig
    from tpu_splat.core.config import TrainingParameters as JaxTrainingParameters
    from tpu_splat_torch.parallel.mesh import trainer_mesh_shape

    devices = jax.devices()[:world]
    monkeypatch.setattr(jax, "devices", lambda *a: devices)
    for batch, mesh_data, mesh_gauss in MESH_CASES:
        opt = JaxOptimizationParameters(iterations=4, batch_size=batch, max_cap=256,
                                        mesh_data=mesh_data, mesh_gauss=mesh_gauss,
                                        eval_steps=[], save_steps=[])
        params = JaxTrainingParameters(
            dataset=JaxDatasetConfig(data_path=str(colmap_dir),
                                     output_path=str(tmp_path / "j"), test_every=100),
            optimization=opt)
        try:
            jt = jax_trainer.Trainer(params)
            want = None if jt.mesh is None else (jt.mesh.shape["data"], jt.mesh.shape["gauss"])
        except ValueError:
            want = "raises"
        if want is None:
            # no flag asks the JAX Trainer for a mesh; the port's world of 1 takes none
            # either, and launched ranks always form one: every rank on the gauss axis
            assert batch == 1 and not (mesh_data or mesh_gauss)
            want = (1, world)
        if want != "raises" and want[0] * want[1] < world:
            want = "raises"  # idle devices in JAX; the port has no idle rank
        try:
            got = trainer_mesh_shape(world, batch, mesh_data, mesh_gauss)
        except ValueError:
            got = "raises"
        assert got == want, (world, batch, mesh_data, mesh_gauss)


def test_loader_hands_samples_out_in_draw_order(colmap_dir):
    """Every process of a multi-device run draws the same sample sequence: with several
    loader threads the samples still come out in the order their indices were drawn,
    the one-thread sequence."""
    from tpu_splat_torch.training.dataset import CameraDataset, InfiniteDataLoader

    t = trainer.Trainer(_small_params(colmap_dir, colmap_dir / "unused"), device="cpu")
    ds = CameraDataset(t.train_cams)
    orders = []
    for workers in (1, 8):
        loader = InfiniteDataLoader(ds, num_workers=workers, prefetch=2, seed=5, skip=3)
        try:
            orders.append([next(loader).index for _ in range(40)])
        finally:
            loader.close()
    assert orders[0] == orders[1] and len(set(orders[0])) == len(ds)


def test_no_card_and_no_device_raises(colmap_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-d", str(colmap_dir), "-o", str(tmp_path / "o"), "--headless"])
    assert not (tmp_path / "o").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trainer.Trainer(_small_params(colmap_dir, tmp_path / "o"))


# The flags ported in this slice, each trained for 12 iterations through `cli.main` on the
# 48x48 capture with its effect checked; `--gut --pose-opt` is refused as in the JAX
# Trainer (trainer.py:190-191).
PORTED_FLAGS = {
    "checkpoint-every": ["--checkpoint-every", "6"],
    "resume": ["--checkpoint-every", "6", "--resume", "{first}/checkpoint_6.npz"],
    "save-checkpoint-event": [],
    "strategy-default": ["--strategy", "default"],
    "adc-preset": ["--config", "parameter/default_optimization_params.json"],
    "adc-gut": ["--strategy", "default", "--gut"],
    "bilateral-grid": ["--bilateral-grid"],
    "pose-opt-direct": ["--pose-opt", "direct"],
    "pose-opt-mlp": ["--pose-opt", "mlp"],
    "enable-sparsity": ["--enable-sparsity", "-i", "6", "--sparsify-steps", "6"],
    "eval-lpips": ["--eval", "--test-every", "3"],
    "gut-pose-opt": ["--gut", "--pose-opt", "direct"],
    "sh-degree-4": ["--sh-degree", "4", "--sh-degree-interval", "2", "--eval", "--test-every",
                    "3"],
}


def _short_config(path, preset=None):
    fields = json.loads(open(preset).read()) if preset else {}
    fields.update(max_cap=256, refine_every=4, start_refine=2, stop_refine=11, reset_every=8,
                  grad_threshold=2e-5, eval_steps=[12], save_steps=[], num_workers=1,
                  enable_save_eval_images=False, scan_steps=4)
    path.write_text(json.dumps(fields))
    return path


@pytest.mark.parametrize("case", list(PORTED_FLAGS))
def test_ported_flags_train(case, colmap_dir, tmp_path, monkeypatch):
    from tpu_splat_torch.training import checkpoint, lpips
    from tpu_splat_torch.utils import events as ev

    flags = list(PORTED_FLAGS[case])
    preset = None
    if case == "adc-preset":  # the shipped preset, its schedule cut to 12 iterations
        preset, flags = flags[1], []
    cfg = _short_config(tmp_path / "opt.json", preset)
    if case == "resume":
        first = tmp_path / "first"
        cli.main(["-d", str(colmap_dir), "-o", str(first), "--config", str(cfg), "-i", "12",
                  "--headless", "--device", "cpu", "--checkpoint-every", "6"])
        flags = [f.format(first=first) for f in flags]
    if case == "eval-lpips":  # random LPIPS weights where the evaluator looks for them
        monkeypatch.chdir(tmp_path)
        (tmp_path / "weights").mkdir()
        np.savez(tmp_path / "weights" / "lpips_vgg.npz", **lpips.random_params(0))
    kept, train = [], trainer.Trainer.train

    def recording_train(self, *a, **kw):
        kept.append(self)
        self.n_alive_at_start = int(self.state.splat.n_alive())
        if case == "save-checkpoint-event":  # a front end asks for a checkpoint
            ev.emit(ev.SaveCheckpoint())
        return train(self, *a, **kw)

    monkeypatch.setattr(trainer.Trainer, "train", recording_train)
    out = tmp_path / "out"
    argv = ["-d", str(colmap_dir), "-o", str(out), "--config", str(cfg), "-i", "12",
            "--headless", "--device", "cpu"] + flags
    if case == "gut-pose-opt":
        with pytest.raises(ValueError, match="incompatible with --gut"):
            cli.main(argv)
        return
    assert cli.main(argv) == 0
    (t,) = kept
    assert np.isfinite(t._loss_hist).all() and t.state.iteration == 13
    ts = t.state
    if case == "checkpoint-every":
        for it in (6, 12):
            back, extra = checkpoint.load_checkpoint(out / f"checkpoint_{it}.npz", device="cpu")
            assert back.iteration == it + 1 and extra["plan_k_max"] == t.plan.k_max
        assert json.loads((out / "out.ls").read_text())["checkpoints"] == [
            str(out / "checkpoint_6.npz"), str(out / "checkpoint_12.npz")]
        assert len(t._loss_hist) == 12
    elif case == "resume":
        assert len(t._loss_hist) == 6 and t.samples_drawn == 12
    elif case == "save-checkpoint-event":
        back, _ = checkpoint.load_checkpoint(out / "checkpoint_4.npz", device="cpu")
        assert back.iteration == 5  # the first chunk's end, with no step in flight
    elif case in ("strategy-default", "adc-preset", "adc-gut"):
        refines = [r for r in t.refine_log if r["kind"] == "adc"]
        assert [r["iteration"] for r in refines] == [4, 8]
        assert [r["iteration"] for r in t.refine_log if r["kind"] == "reset_opacity"] == [8]
        n_alive = t.n_alive_at_start
        for r in refines:  # only refines change the alive set in this schedule
            assert r["n_alive"] == n_alive + r["n_dup"] + r["n_split"] - r["n_pruned"], r
            n_alive = r["n_alive"]
        assert int(ts.splat.n_alive()) == n_alive
        grown = sum(r["n_dup"] + r["n_split"] for r in refines)
        if case == "adc-gut":  # zero mean2d gradients under GUT: nothing grows
            assert grown == 0 and not ts.dens_grad2d.any()
        else:
            assert grown > 0
        if case == "adc-preset":
            assert t.plan.tile_size == 16 and t.plan.chunk == 128 and t.plan.pack_bf16
    elif case == "bilateral-grid":
        assert ts.bilateral_grids.shape == (6, 12, 8, 16, 16) and ts.bilateral_opt.count == 12
        assert not torch.equal(ts.bilateral_grids, trainer.init_train_state(
            ts.splat, n_train_images=6, opt=t.opt, device="cpu").bilateral_grids)
    elif case == "pose-opt-direct":
        assert ts.pose_params["embeddings"].abs().max() > 0 and ts.pose_opt.count == 12
    elif case == "pose-opt-mlp":
        assert ts.pose_params["layers"][-1]["w"].abs().max() > 0
    elif case == "enable-sparsity":
        (prune,) = [r for r in t.refine_log if r["kind"] == "sparsity_prune"]
        assert prune["iteration"] == 12
        assert [r["iteration"] for r in t.refine_log if r["kind"] == "admm_init"] == [6]
        assert prune["n_pruned"] == int(0.6 * prune["n_before"]) > 0
        assert int(ts.splat.n_alive()) == prune["n_before"] - prune["n_pruned"]
    elif case == "sh-degree-4":  # degree 4 active from iteration 8, the eval at 12 included
        assert ts.splat.max_sh_degree == 4 and ts.splat.shN.shape[1] == 24
        assert trainer.active_sh_degree(12, 2, 4) == 4 and len(t.evaluator.results) == 1
        assert load_splat_ply(out / "splat_final.ply")["shN"].shape[1] == 24
    elif case == "eval-lpips":
        with open(out / "metrics.csv") as f:
            (row,) = list(csv.DictReader(f))
        assert row["iteration"] == "12" and float(row["lpips"]) > 0
        assert t.evaluator.results[-1].lpips == pytest.approx(float(row["lpips"]), abs=1e-4)
