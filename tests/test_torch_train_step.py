"""The PyTorch port's train step as a whole against the JAX package, on the CPU.

Both sides start from the same 256-slot state and take the same three MCMC steps on a
48x48 view, the port fed the JAX side's noise draw. Tolerances:
  losses rtol 1e-4 (float32 rasterizer, SSIM and regularizers in another order);
  parameters: Adam's first steps move a parameter by lr * sign(g) wherever |g| is tiny
    against its own history, so a 1e-9 difference in a near-zero gradient flips a whole
    lr. Parameters are therefore compared only where |g| exceeds 1e-6 of the group's
    largest gradient at every step taken, with atol 4e-3 of the group's learning rate per
    step; the port's own gradients at each step's state pick those entries.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_splat.core.splat import init_from_pointcloud as jax_init_from_pointcloud
from tpu_splat.training import train_step as jax_ts
from tpu_splat_torch import convert
from tpu_splat_torch.core.splat import PARAM_FIELDS
from tpu_splat_torch.ops.rasterize import rasterize
from tpu_splat_torch.training import optim, train_step as ts_mod
from tpu_splat_torch.training.losses import photometric_loss, regularization_losses

from utils import make_camera

SIZE, CAPACITY, TOTAL = 48, 256, 100


def _jax_state(n=120, seed=7):
    rng = np.random.default_rng(seed)
    pts = rng.normal(0, 0.8, (n, 3)).astype(np.float32)
    pts[:, 2] += 5
    cols = rng.random((n, 3)).astype(np.float32)
    state = jax_init_from_pointcloud(pts, cols, np.array([0, 0, 5.0]), capacity=CAPACITY)
    # anisotropic scales and tilted rotations: with the init's isotropic splats the
    # rotation gradient is identically zero and only rounding noise would be compared
    q = rng.normal(0, 0.5, (CAPACITY, 4)).astype(np.float32)
    q[:, 0] += 2.0
    scaling = np.asarray(state.scaling_raw) + rng.normal(0, 0.4, (CAPACITY, 3)).astype(np.float32)
    return dataclasses.replace(state, rotation_raw=jnp.asarray(q),
                               scaling_raw=jnp.asarray(scaling))


def _to_port(ts_j, seed=0):
    nd = lambda d: {k: np.asarray(v) for k, v in d.items()}
    return convert.train_state_from_numpy(
        nd(ts_j.splat.params()), np.asarray(ts_j.splat.alive), nd(ts_j.adam.exp_avg),
        nd(ts_j.adam.exp_avg_sq), {k: int(v) for k, v in ts_j.adam.step_count.items()},
        int(ts_j.iteration), max_sh_degree=ts_j.splat.max_sh_degree,
        scene_scale=ts_j.splat.scene_scale, seed=seed, device="cpu")


def _port_grads(ts, gt, cam, plan, cfg):
    """The port's own gradients of the step's loss at state `ts`."""
    p = {k: v.detach().requires_grad_(True) for k, v in ts.splat.params().items()}
    out = rasterize(p["means"], p["scaling_raw"], p["rotation_raw"], p["opacity_raw"],
                    p["sh0"], p["shN"], ts.splat.alive, cam["w2c"], cam["cam_position"],
                    cam["fx"], cam["fy"], cam["cx"], cam["cy"],
                    ts_mod.active_sh_degree(ts.iteration, cfg.sh_degree_interval, 3),
                    np.zeros(3, np.float32), width=SIZE, height=SIZE,
                    max_instances=plan.max_instances, k_max=plan.k_max, chunk=plan.chunk,
                    tile_size=plan.tile_size, device="cpu")
    loss = photometric_loss(out.image, torch.from_numpy(gt), cfg.lambda_dssim)
    loss = loss + regularization_losses(p, ts.splat.alive, cfg.scale_reg, cfg.opacity_reg)
    grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
    return {k: torch.zeros_like(p[k]) if g is None else g for k, g in zip(p, grads)}


def test_train_step_matches_jax():
    cams = [make_camera(SIZE, SIZE, fov_deg=55.0 + 5.0 * i) for i in range(3)]
    gt = np.random.default_rng(2).random((3, SIZE, SIZE)).astype(np.float32)
    # the JAX CPU lane is the XLA scan blend (chunk 32); the port's kernels take chunks of
    # 128 or 256 and `rasterize` maps any other value to 128
    plan_j = jax_ts.RasterPlan(max_instances=1 << 14, k_max=256, chunk=32)
    plan_t = ts_mod.RasterPlan(max_instances=1 << 14, k_max=256, chunk=32)
    cfg_j, cfg_t = jax_ts.StepConfig(strategy="mcmc"), ts_mod.StepConfig(strategy="mcmc")
    kw = dict(width=SIZE, height=SIZE, total_iterations=TOTAL)

    ts_j = jax_ts.init_train_state(_jax_state(), seed=9)
    ts_t = _to_port(ts_j)
    lrs = optim.group_lrs(cfg_t, ts_t.splat.scene_scale)
    compared = {k: torch.ones_like(v, dtype=torch.bool) for k, v in ts_t.splat.params().items()}
    for step, cam in enumerate(cams):
        noise_key = jax.random.split(ts_j.rng)[1]  # tpu_splat/training/train_step.py:319
        noise = np.asarray(jax.random.normal(noise_key, ts_j.splat.means.shape, jnp.float32))
        for k, g in _port_grads(ts_t, gt, cam, plan_t, cfg_t).items():
            compared[k] &= g.abs() > 1e-6 * g.abs().max()
        cam_args = (cam["w2c"], cam["cam_position"], cam["fx"], cam["fy"], cam["cx"], cam["cy"])
        ts_j, st_j = jax_ts.train_step(ts_j, jnp.asarray(gt), *cam_args, jnp.zeros(3),
                                       jnp.int32(step), plan=plan_j, opt=cfg_j, **kw)
        before = ts_t
        ts_t, st_t = ts_mod.train_step(ts_t, gt, *cam_args, np.zeros(3, np.float32), step,
                                       plan=plan_t, opt=cfg_t, noise=noise, **kw)
        np.testing.assert_allclose(float(st_t.loss), float(st_j.loss), rtol=1e-4)
        for name in ("total_instances", "max_tile_count", "n_visible"):
            assert int(getattr(st_t, name)) == int(getattr(st_j, name)), name
        assert ts_t.iteration == int(ts_j.iteration) == step + 2
        assert before.iteration == step + 1  # a step leaves the state it was given alone
        for k in PARAM_FIELDS:
            want = np.asarray(getattr(ts_j.splat, k))
            got = getattr(ts_t.splat, k).numpy()
            mask = compared[k].numpy()
            if k == "shN":  # frozen for the first 1000 iterations: exactly unchanged
                np.testing.assert_array_equal(got, want)
                continue
            assert mask.mean() > 0.05, k  # half the slots are dead: zero gradient
            np.testing.assert_allclose(got[mask], want[mask], rtol=0,
                                       atol=4e-3 * lrs[k] * (step + 1) + 1e-7, err_msg=k)
            assert ts_t.adam.step_count[k] == int(ts_j.adam.step_count[k]) == step + 1


def test_refine_step_matches_jax():
    sj = _jax_state(n=150, seed=3)
    op = np.asarray(sj.opacity_raw).copy()
    op[20:40] = -10.0
    sj = dataclasses.replace(sj, opacity_raw=jnp.asarray(op))
    ts_j = jax_ts.init_train_state(sj, seed=4)
    ts_t = _to_port(ts_j)
    # the draws refine_step makes: tpu_splat/training/train_step.py:428, strategy_mcmc.py:183
    k1, k2 = jax.random.split(jax.random.split(ts_j.rng)[1])
    from tpu_splat.training import strategy_mcmc as jm

    opacity = jax.nn.sigmoid(sj.opacity_raw[:, 0])
    dead = sj.alive & (opacity <= 0.005)
    src1 = jm._sample_sources(k1, jnp.where(sj.alive & ~dead, opacity, 0.0), CAPACITY)
    mid, _, _ = jm.relocate_gs(sj, ts_j.adam, k1, 0.005)
    src2 = jm._sample_sources(
        k2, jnp.where(mid.alive, jax.nn.sigmoid(mid.opacity_raw[:, 0]), 0.0), CAPACITY)

    ts_j2, info_j = jax_ts.refine_step(ts_j, min_opacity=0.005, max_cap=200)
    ts_t2, info_t = ts_mod.refine_step(ts_t, min_opacity=0.005, max_cap=200,
                                       src=(np.asarray(src1), np.asarray(src2)))
    for name in ("n_relocated", "n_new", "n_alive"):
        assert int(info_t[name]) == int(info_j[name]), name
    assert int(info_t["n_relocated"]) == 20 and int(info_t["n_new"]) == 7
    for k in PARAM_FIELDS:
        np.testing.assert_allclose(getattr(ts_t2.splat, k).numpy(),
                                   np.asarray(getattr(ts_j2.splat, k)), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_array_equal(ts_t2.splat.alive.numpy(), np.asarray(ts_j2.splat.alive))
    assert ts_t2.iteration == ts_t.iteration and int(ts_t.splat.n_alive()) == 150


def test_train_step_many_is_the_loop_of_train_step():
    ts_j = jax_ts.init_train_state(_jax_state(), seed=1)
    cams = [make_camera(SIZE, SIZE, fov_deg=55.0 + 5.0 * i) for i in range(2)]
    gt = np.random.default_rng(2).random((3, SIZE, SIZE)).astype(np.float32)
    kw = dict(width=SIZE, height=SIZE, plan=ts_mod.RasterPlan(1 << 14, 256, chunk=128),
              opt=ts_mod.StepConfig(), total_iterations=TOTAL)
    ts_a, losses = _to_port(ts_j, seed=3), []
    for i, cam in enumerate(cams):
        ts_a, st = ts_mod.train_step(ts_a, gt, cam["w2c"], cam["cam_position"], cam["fx"],
                                     cam["fy"], cam["cx"], cam["cy"], np.zeros(3, np.float32),
                                     i, **kw)
        losses.append(float(st.loss))
    ts_b, stats = ts_mod.train_step_many(
        _to_port(ts_j, seed=3), np.stack([gt, gt]), np.stack([c["w2c"] for c in cams]),
        np.stack([c["cam_position"] for c in cams]),
        np.asarray([[c["fx"], c["fy"], c["cx"], c["cy"]] for c in cams], np.float64),
        np.zeros((2, 3), np.float32), np.arange(2), **kw)
    assert stats.loss.shape == (2,) and stats.max_tile_count.shape == (2,)
    np.testing.assert_allclose(stats.loss.numpy(), losses, rtol=1e-6)
    # the same seed gives the same noise: the two runs end in the same state
    np.testing.assert_array_equal(ts_b.splat.means.numpy(), ts_a.splat.means.numpy())
    assert ts_b.iteration == 3 and losses[1] != losses[0]


def test_train_state_round_trip_and_device_rule(monkeypatch):
    ts_j = jax_ts.init_train_state(_jax_state(), seed=1)
    ts = _to_port(ts_j)
    ts = dataclasses.replace(ts, iteration=41, adam=dataclasses.replace(
        ts.adam, step_count=dict(ts.adam.step_count, shN=40, means=7),
        exp_avg={k: v + 0.5 for k, v in ts.adam.exp_avg.items()}))
    fields = convert.train_state_to_numpy(ts)
    back = convert.train_state_from_numpy(**fields, device="cpu")
    assert back.iteration == 41 and back.adam.step_count == ts.adam.step_count
    assert back.splat.scene_scale == ts.splat.scene_scale and back.device.type == "cpu"
    for k in PARAM_FIELDS:
        np.testing.assert_array_equal(back.splat.params()[k].numpy(),
                                      np.asarray(ts_j.splat.params()[k]))
        np.testing.assert_array_equal(back.adam.exp_avg[k].numpy(),
                                      ts.adam.exp_avg[k].numpy())
        np.testing.assert_array_equal(back.adam.exp_avg_sq[k].numpy(),
                                      ts.adam.exp_avg_sq[k].numpy())
    np.testing.assert_array_equal(back.splat.alive.numpy(), np.asarray(ts_j.splat.alive))
    # the training entry points target the card and raise without one unless asked
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ts_mod.init_train_state(ts.splat)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.train_state_from_numpy(**fields)
    assert ts_mod.init_train_state(ts.splat, device="cpu").iteration == 1
