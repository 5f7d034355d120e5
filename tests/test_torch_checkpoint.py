"""The port's checkpoints (`training/checkpoint.py`) against the JAX package's layout, and
resume, on the CPU.

  A checkpoint that the JAX package wrote (ADC info, bilateral grids, pose MLP, ADMM)
    loads into the port with every array equal and the generator seeded from the JAX key
    data (logged); a port checkpoint has the JAX package's keys and sidecar fields, and
    the JAX package loads it with every array equal.
  A port checkpoint round-trips bit for bit, the generator's state included.
  A run resumed from a checkpoint (one loader worker, so the sample stream is
    deterministic) ends in the uninterrupted run's state bit for bit, generator included,
    under MCMC with the background modulation (whose jitter stream the checkpoint carries)
    and under ADC with the bilateral grid and the pose MLP.
"""

import dataclasses
import json
import logging

import jax
import numpy as np
import pytest
import torch

from tpu_splat.core.config import OptimizationParameters as JaxOptimizationParameters
from tpu_splat.training import checkpoint as jck
from tpu_splat.training import train_step as jax_ts
from tpu_splat_torch.core.config import DatasetConfig, OptimizationParameters, TrainingParameters
from tpu_splat_torch.training import checkpoint as ck
from tpu_splat_torch.training import trainer

from synth_data import make_synthetic_colmap
from torch_fixtures import jax_splat

CASES = {
    "plain": dict(),
    "bilateral+direct": dict(use_bilateral_grid=True, pose_optimization="direct"),
    "mlp+admm": dict(pose_optimization="mlp", enable_sparsity=True),
}


def _jax_state(case):
    opt = JaxOptimizationParameters(bilateral_grid_X=4, bilateral_grid_Y=4, bilateral_grid_W=2,
                                    **CASES[case])
    ts = jax_ts.init_train_state(jax_splat(n=50, capacity=64), seed=3, n_train_images=3,
                                 opt=opt)
    rng = np.random.default_rng(4)
    ts = dataclasses.replace(
        ts, iteration=jax.numpy.int32(57),
        dens_count=jax.numpy.asarray(rng.integers(0, 9, 64).astype(np.float32)),
        dens_grad2d=jax.numpy.asarray(rng.random(64).astype(np.float32)),
        adam=dataclasses.replace(ts.adam, step_count={
            k: jax.numpy.int32(i + 40) for i, k in enumerate(ts.adam.step_count)}))
    if opt.enable_sparsity:
        ts = jax_ts.admm_init_step(ts, prune_ratio=0.5)
    return ts


def _arrays(path) -> dict:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("case", list(CASES))
def test_checkpoints_cross_between_packages(case, tmp_path, caplog):
    ts_j = _jax_state(case)
    jck.save_checkpoint(tmp_path / "j.npz", ts_j, extra={"plan_k_max": 512})
    with caplog.at_level(logging.INFO):
        ts_t, extra = ck.load_checkpoint(tmp_path / "j.npz", device="cpu")
    assert extra == {"plan_k_max": 512} and "seeded from its JAX key data" in caplog.text
    want = _arrays(tmp_path / "j.npz")
    key = want.pop(ck.JAX_RNG_KEY)
    assert ts_t.rng.initial_seed() == (int(key[0]) << 32) | int(key[1])
    got = ck.state_arrays(ts_t)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert ts_t.iteration == 57 and ts_t.adam.step_count["means"] == 40

    # the port's file: the JAX layout and sidecar, its own generator key, read back by JAX
    ts_t.rng.manual_seed(11)
    torch.randn(5, generator=ts_t.rng)  # a state that is not a fresh seed's
    ck.save_checkpoint(tmp_path / "t.npz", ts_t, extra={"plan_k_max": 1024})
    mine = _arrays(tmp_path / "t.npz")
    assert sorted(set(mine) - {ck.TORCH_RNG_KEY}) == sorted(set(want) | {ck.JAX_RNG_KEY})
    meta_j = json.loads((tmp_path / "j.npz.json").read_text())
    meta_t = json.loads((tmp_path / "t.npz.json").read_text())
    assert {k: meta_t[k] for k in meta_j if k != "extra"} == \
        {k: v for k, v in meta_j.items() if k != "extra"}
    back_j, extra_j = jck.load_checkpoint(tmp_path / "t.npz")
    assert extra_j == {"plan_k_max": 1024}
    flat = jck._flatten_with_paths(dataclasses.replace(back_j, rng=None))
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)
    assert int(jax.random.key_data(back_j.rng)[1]) == 11

    # the port's own file round-trips bit for bit, the generator included
    back, extra = ck.load_checkpoint(tmp_path / "t.npz", device="cpu")
    assert extra == {"plan_k_max": 1024}
    assert torch.equal(back.rng.get_state(), ts_t.rng.get_state())
    again = ck.state_arrays(back)
    for k, v in ck.state_arrays(ts_t).items():
        assert again[k].dtype == v.dtype, k
        np.testing.assert_array_equal(again[k], v, err_msg=k)
    assert torch.equal(torch.randn(3, generator=back.rng), torch.randn(3, generator=ts_t.rng))


@pytest.fixture(scope="module")
def colmap_dir(tmp_path_factory):
    base = tmp_path_factory.mktemp("colmap_scene")
    make_synthetic_colmap(base, n_gauss=120, n_cams=6, size=48)
    return base


def _params(base, out, **opt):
    fields = dict(iterations=12, max_cap=256, refine_every=4, start_refine=2, stop_refine=11,
                  reset_every=8, eval_steps=[], save_steps=[], num_workers=1, scan_steps=4)
    fields.update(opt)
    return TrainingParameters(dataset=DatasetConfig(data_path=str(base), output_path=str(out)),
                              optimization=OptimizationParameters(**fields))


@pytest.mark.parametrize("opt", [dict(bg_modulation=True),
                                 dict(strategy="default", use_bilateral_grid=True,
                                      pose_optimization="mlp", grad_threshold=1e-5)])
def test_resumed_run_equals_uninterrupted(colmap_dir, tmp_path, opt):
    full = trainer.Trainer(_params(colmap_dir, tmp_path / "a", **opt), device="cpu")
    full.checkpoint_every = 6
    full.train(progress_every=100)
    assert (tmp_path / "a" / "checkpoint_6.npz").exists()
    assert (tmp_path / "a" / "checkpoint_12.npz").exists()
    assert [r["kind"] for r in full.refine_log][:1] == ([opt.get("strategy", "mcmc")
                                                          .replace("default", "adc")])

    resumed = trainer.Trainer(_params(colmap_dir, tmp_path / "b", **opt), device="cpu")
    resumed.resume(tmp_path / "a" / "checkpoint_6.npz")
    assert resumed.state.iteration == 7 and resumed.samples_drawn == 6
    resumed.checkpoint_every = 6
    resumed.train(progress_every=100)
    assert resumed._loss_hist == full._loss_hist[6:]
    assert resumed.refine_log == [r for r in full.refine_log if r["iteration"] > 6]
    assert resumed.state.iteration == full.state.iteration == 13
    assert torch.equal(resumed.state.rng.get_state(), full.state.rng.get_state())
    got, want = ck.state_arrays(resumed.state), ck.state_arrays(full.state)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert resumed.plan == full.plan
