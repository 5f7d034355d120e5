"""Training ops of the PyTorch port against the JAX package, on the CPU: the rasterizer's
gradients, SSIM and the losses, Adam, and the MCMC strategy.

Inputs are made with numpy from a seed and fed to both sides; random draws (relocation
sources, noise) are made by the JAX side and handed to the port. Tolerances:
  rasterize image atol 1e-5 and gradients <= 1e-3 of each group's largest absolute
    gradient against `jax.value_and_grad` of the XLA lane (float32, the same math in
    another order); with `pack_bf16` against the Pallas bf16 lane: image 5e-3, gradients
    2e-2 (that lane's own budget, tests/test_rasterize.py: it also rounds its gradient
    rows to bf16, the port keeps them float32);
  SSIM and the losses rtol 1e-5 (values and gradients);
  Adam rtol 1e-6 plus atol 1e-6 of each tensor's scale (the same float32 formulas; a
    sum of two terms of opposite sign loses relative accuracy); `means_lr_at` rtol 1e-6;
  MCMC relocation, growth and noise rtol 1e-5 (pow/exp/log chains in float32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_splat.core.splat import SplatState as JaxSplatState
from tpu_splat.core.splat import init_random as jax_init_random
from tpu_splat.ops.rasterize import rasterize as jax_rasterize
from tpu_splat.ops.ssim import ssim as jax_ssim
from tpu_splat.training import losses as jax_losses
from tpu_splat.training import optim as jax_optim
from tpu_splat.training import strategy_mcmc as jax_mcmc
from tpu_splat_torch.convert import splat_from_numpy
from tpu_splat_torch.core.splat import PARAM_FIELDS, init_random
from tpu_splat_torch.ops.rasterize import rasterize
from tpu_splat_torch.ops.ssim import ssim
from tpu_splat_torch.training import losses, optim, strategy_mcmc

from utils import make_camera, make_scene

KW = dict(width=48, height=48, max_instances=1 << 13, k_max=256, chunk=128, tile_size=16)
BG = np.asarray([0.1, 0.2, 0.3], np.float32)
GRAD_FIELDS = ("means", "scaling_raw", "rotation_raw", "opacity_raw", "sh0", "shN")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("pack_bf16", [False, True])
def test_rasterize_gradients_match_jax(pack_bf16):
    scene = make_scene(400, 7)
    cam = make_camera(48, 48)
    cam_args = (cam["w2c"], cam["cam_position"], cam["fx"], cam["fy"], cam["cx"], cam["cy"])
    weight = np.random.default_rng(0).random((3, 48, 48)).astype(np.float32)
    lane = dict(backend="pallas", pack_bf16=True) if pack_bf16 else dict(backend="xla")

    def loss_fn(p, offset):
        out = jax_rasterize(*(p[k] for k in GRAD_FIELDS), scene["alive"], *cam_args, 3,
                            jnp.asarray(BG), mean2d_offset=offset, **lane, **KW)
        return jnp.sum(out.image * weight), out.image

    (_, want_img), (want, want_off) = jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(scene[k]) for k in GRAD_FIELDS}, jnp.zeros((400, 2), jnp.float32))

    p = {k: _t(scene[k]).requires_grad_(True) for k in GRAD_FIELDS}
    offset = torch.zeros((400, 2), requires_grad=True)
    out = rasterize(*(p[k] for k in GRAD_FIELDS), scene["alive"], *cam_args, 3, BG,
                    mean2d_offset=offset, pack_bf16=pack_bf16, device="cpu", **KW)
    assert out.image.requires_grad and not out.aux.visible.requires_grad
    grads = torch.autograd.grad((out.image * _t(weight)).sum(), [*p.values(), offset])

    img_tol, grad_tol = (5e-3, 2e-2) if pack_bf16 else (1e-5, 1e-3)
    np.testing.assert_allclose(out.image.detach().numpy(), np.asarray(want_img), rtol=0,
                               atol=img_tol)
    for name, got in zip(GRAD_FIELDS + ("mean2d_offset",), grads):
        ref = np.asarray(want_off if name == "mean2d_offset" else want[name])
        scale = np.abs(ref).max()
        assert scale > 1e-3, name
        assert np.abs(got.numpy() - ref).max() / scale <= grad_tol, name


def test_ssim_and_photometric_loss_match_jax():
    rng = np.random.default_rng(1)
    a = rng.random((3, 40, 56)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    np.testing.assert_allclose(float(ssim(_t(a), _t(b))), float(jax_ssim(a, b)), rtol=1e-5)
    np.testing.assert_allclose(float(ssim(_t(a)[None], _t(b)[None])), float(jax_ssim(a, b)),
                               rtol=1e-5)
    # one jitted build for each weight (eager value_and_grad dispatches SSIM op by op)
    value_and_grad = jax.jit(jax.value_and_grad(jax_losses.photometric_loss), static_argnums=2)
    for lam in (0.0, 0.2):
        want, want_g = value_and_grad(jnp.asarray(a), b, lam)
        x = _t(a).requires_grad_(True)
        got = losses.photometric_loss(x, _t(b), lam)
        (got_g,) = torch.autograd.grad(got, x)
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
        np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-9)


def test_regularization_losses_match_jax():
    scene = make_scene(300, 2)
    scene["alive"][::5] = False
    params = {k: scene[k] for k in PARAM_FIELDS}
    for scale_reg, opacity_reg in ((0.01, 0.01), (0.0, 0.02), (0.03, 0.0)):
        want, want_g = jax.value_and_grad(jax_losses.regularization_losses)(
            {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(scene["alive"]),
            scale_reg, opacity_reg)
        p = {k: _t(v).requires_grad_(True) for k, v in params.items()}
        got = losses.regularization_losses(p, _t(scene["alive"]), scale_reg, opacity_reg)
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
        got_g = torch.autograd.grad(got, [p["scaling_raw"], p["opacity_raw"]],
                                    allow_unused=True)
        for name, g in zip(("scaling_raw", "opacity_raw"), got_g):
            g = np.zeros_like(params[name]) if g is None else g.numpy()
            np.testing.assert_allclose(g, np.asarray(want_g[name]), rtol=1e-5, atol=1e-12)


def _adam_inputs(seed, counts):
    rng = np.random.default_rng(seed)
    scene = make_scene(200, seed)
    params = {k: scene[k] for k in PARAM_FIELDS}
    draw = lambda v, s: (rng.normal(0, s, v.shape)).astype(np.float32)
    grads = {k: draw(v, 1e-3) for k, v in params.items()}
    m = {k: draw(v, 1e-3) for k, v in params.items()}
    v2 = {k: np.abs(draw(v, 1e-6)) for k, v in params.items()}
    return params, grads, m, v2, dict(zip(PARAM_FIELDS, counts))


@pytest.mark.parametrize("iteration", [7, 1000, 1001])
def test_adam_step_matches_jax(iteration):
    """The same gradients through both; shN inside (<= 1000) and outside its freeze;
    per-group step counts that differ (relocation zeroes moments, not counts)."""
    params, grads, m, v, counts = _adam_inputs(iteration, (6, 6, 6, 3, 900, 0))
    lrs = jax_optim.group_lrs(type("Opt", (), dict(
        means_lr=0.00016, shs_lr=0.0025, scaling_lr=0.005, rotation_lr=0.001,
        opacity_lr=0.05)), 2.5)
    assert optim.group_lrs(type("Opt", (), dict(
        means_lr=0.00016, shs_lr=0.0025, scaling_lr=0.005, rotation_lr=0.001,
        opacity_lr=0.05)), 2.5) == lrs
    lrs_j = dict(lrs, means=jax_optim.means_lr_at(lrs["means"], jnp.float32(iteration - 1),
                                                  30_000))
    lrs_t = dict(lrs, means=optim.means_lr_at(lrs["means"], iteration - 1, 30_000))
    np.testing.assert_allclose(lrs_t["means"], float(lrs_j["means"]), rtol=1e-6)

    j = lambda d: {k: jnp.asarray(x) for k, x in d.items()}
    state_j = jax_optim.AdamState(exp_avg=j(m), exp_avg_sq=j(v),
                                  step_count={k: jnp.int32(c) for k, c in counts.items()})
    want_p, want_s = jax_optim.adam_step(j(params), j(grads), state_j, lrs_j,
                                         jnp.int32(iteration))
    t = lambda d: {k: _t(x) for k, x in d.items()}
    state_t = optim.AdamState(exp_avg=t(m), exp_avg_sq=t(v), step_count=dict(counts))
    p_in = t(params)
    got_p, got_s = optim.adam_step(p_in, t(grads), state_t, lrs_t, iteration)

    for k in PARAM_FIELDS:
        assert got_s.step_count[k] == int(want_s.step_count[k]) == counts[k] + 1
        for got, want in ((got_p[k], want_p[k]), (got_s.exp_avg[k], want_s.exp_avg[k]),
                          (got_s.exp_avg_sq[k], want_s.exp_avg_sq[k])):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max(), err_msg=k)
        np.testing.assert_array_equal(p_in[k].numpy(), params[k])  # inputs untouched
    frozen = iteration <= 1000
    assert np.array_equal(got_p["shN"].numpy(), params["shN"]) == frozen
    assert not np.array_equal(got_p["sh0"].numpy(), params["sh0"])


def test_zero_moments_at_matches_jax():
    params, _, m, v, counts = _adam_inputs(3, (4,) * 6)
    mask = np.random.default_rng(3).random(200) < 0.3
    state_j = jax_optim.AdamState(
        exp_avg={k: jnp.asarray(x) for k, x in m.items()},
        exp_avg_sq={k: jnp.asarray(x) for k, x in v.items()},
        step_count={k: jnp.int32(c) for k, c in counts.items()})
    want = jax_optim.zero_moments_at(state_j, jnp.asarray(mask))
    got = optim.zero_moments_at(
        optim.AdamState(exp_avg={k: _t(x) for k, x in m.items()},
                        exp_avg_sq={k: _t(x) for k, x in v.items()}, step_count=dict(counts)),
        _t(mask))
    for k in PARAM_FIELDS:
        np.testing.assert_array_equal(got.exp_avg[k].numpy(), np.asarray(want.exp_avg[k]))
        np.testing.assert_array_equal(got.exp_avg_sq[k].numpy(),
                                      np.asarray(want.exp_avg_sq[k]))
        assert (got.exp_avg[k].numpy()[mask] == 0).all() and got.step_count[k] == 4


def test_relocation_new_params_matches_jax():
    rng = np.random.default_rng(4)
    n = 500
    opacity = rng.uniform(0.01, 0.99, n).astype(np.float32)
    scale = rng.uniform(0.01, 0.5, (n, 3)).astype(np.float32)
    ratio = rng.integers(0, 60, n).astype(np.int32)  # clipped to [1, 51] on both sides
    want_op, want_scale = jax_mcmc.relocation_new_params(jnp.asarray(opacity),
                                                         jnp.asarray(scale), jnp.asarray(ratio))
    got_op, got_scale = strategy_mcmc.relocation_new_params(_t(opacity), _t(scale), _t(ratio))
    np.testing.assert_allclose(got_op.numpy(), np.asarray(want_op), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got_scale.numpy(), np.asarray(want_scale), rtol=1e-5)


def _mcmc_states(seed=0, n=100, capacity=256):
    """A JAX state and its copy in the port, with some slots killed by a low opacity and
    one by a zero quaternion; Adam moments are ones."""
    scene = make_scene(capacity, seed)
    alive = np.arange(capacity) < n
    scene["opacity_raw"][10:30] = -10.0
    scene["rotation_raw"][40] = 0.0
    sj = JaxSplatState(**{k: jnp.asarray(scene[k]) for k in PARAM_FIELDS},
                       alive=jnp.asarray(alive), max_sh_degree=3, scene_scale=1.5)
    st = splat_from_numpy(scene, alive, 3, "cpu", scene_scale=1.5)
    aj = jax_optim.init_adam_state(sj.params())
    aj = dataclasses.replace(aj, exp_avg={k: jnp.ones_like(v) for k, v in aj.exp_avg.items()})
    at = optim.init_adam_state(st.params())
    at = dataclasses.replace(at, exp_avg={k: torch.ones_like(v) for k, v in at.exp_avg.items()})
    return sj, aj, st, at


def _assert_states_match(st, at, sj, aj):
    np.testing.assert_array_equal(st.alive.numpy(), np.asarray(sj.alive))
    for k in PARAM_FIELDS:
        np.testing.assert_allclose(getattr(st, k).numpy(), np.asarray(getattr(sj, k)),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(at.exp_avg[k].numpy(), np.asarray(aj.exp_avg[k]))


def _relocate_src(sj, key, min_opacity):
    opacity = jax.nn.sigmoid(sj.opacity_raw[:, 0])
    dead = sj.alive & ((opacity <= min_opacity) | (jnp.sum(sj.rotation_raw**2, -1) < 1e-8))
    probs = jnp.where(sj.alive & ~dead, opacity, 0.0)
    return np.asarray(jax_mcmc._sample_sources(key, probs, sj.capacity))


def _add_src(sj, key):
    probs = jnp.where(sj.alive, jax.nn.sigmoid(sj.opacity_raw[:, 0]), 0.0)
    return np.asarray(jax_mcmc._sample_sources(key, probs, sj.capacity))


def test_relocate_gs_matches_jax():
    sj, aj, st, at = _mcmc_states()
    key = jax.random.key(0)
    want_s, want_a, want_n = jax_mcmc.relocate_gs(sj, aj, key, 0.005)
    got_s, got_a, got_n = strategy_mcmc.relocate_gs(st, at, 0.005,
                                                    src=_relocate_src(sj, key, 0.005))
    assert int(got_n) == int(want_n) == 21
    _assert_states_match(got_s, got_a, want_s, want_a)
    ea = got_a.exp_avg["means"].numpy()[:100]
    assert (ea == 0).all(1).sum() > 0 and (ea == 1).all(1).sum() > 0


@pytest.mark.parametrize("max_cap,n_new", [(1000, 4), (102, 2)])
def test_add_new_gs_matches_jax(max_cap, n_new):
    sj, aj, st, at = _mcmc_states()
    key = jax.random.key(1)
    want_s, want_a, want_n = jax_mcmc.add_new_gs(sj, aj, key, max_cap, 0.005)
    got_s, got_a, got_n = strategy_mcmc.add_new_gs(st, at, max_cap, 0.005,
                                                   src=_add_src(sj, key))
    assert int(got_n) == int(want_n) == n_new
    assert int(got_s.n_alive()) == int(want_s.n_alive()) == 100 + n_new
    _assert_states_match(got_s, got_a, want_s, want_a)


def test_refine_matches_jax_and_draws_its_own():
    sj, aj, st, at = _mcmc_states(seed=2)
    key = jax.random.key(5)
    k1, k2 = jax.random.split(key)
    mid_s, mid_a, _ = jax_mcmc.relocate_gs(sj, aj, k1, 0.005)
    src = (_relocate_src(sj, k1, 0.005), _add_src(mid_s, k2))
    want_s, want_a, want_r, want_n = jax_mcmc.refine(sj, aj, key, 0.005, 200)
    got_s, got_a, got_r, got_n = strategy_mcmc.refine(st, at, 0.005, 200, src=src)
    assert (int(got_r), int(got_n)) == (int(want_r), int(want_n))
    _assert_states_match(got_s, got_a, want_s, want_a)
    # without a draw handed in, the port samples sources itself, from live slots only
    gen = torch.Generator().manual_seed(0)
    own_s, _, own_r, own_n = strategy_mcmc.refine(st, at, 0.005, 200, generator=gen)
    assert (int(own_r), int(own_n)) == (int(want_r), int(want_n))
    assert int(own_s.n_alive()) == int(want_s.n_alive())
    assert float(torch.sigmoid(own_s.opacity_raw[own_s.alive, 0]).min()) >= 0.005 - 1e-6


def test_inject_noise_matches_jax():
    sj, _, st, _ = _mcmc_states(seed=3)
    key = jax.random.key(2)
    eps = np.asarray(jax.random.normal(key, sj.means.shape, sj.means.dtype))
    want = jax_mcmc.inject_noise(sj, key, jnp.float32(2.4e-4))
    got = strategy_mcmc.inject_noise(st, float(np.float32(2.4e-4)), eps=eps)
    delta = np.asarray(want.means) - np.asarray(sj.means)
    np.testing.assert_allclose(got.means.numpy() - st.means.numpy(), delta, rtol=1e-5,
                               atol=1e-6 * np.abs(delta).max())
    assert np.abs(delta[10:30]).max() > 0 and (delta[100:] == 0).all()
    own = strategy_mcmc.inject_noise(st, 2.4e-4, generator=torch.Generator().manual_seed(1))
    moved = (own.means - st.means).abs().sum(1).numpy()
    assert (moved[10:30] > 0).all() and (moved[100:] == 0).all()


def test_init_random_matches_jax():
    want = jax_init_random(np.random.default_rng(8), 120, 2.0, capacity=128)
    got = init_random(np.random.default_rng(8), 120, 2.0, capacity=128)
    for k in PARAM_FIELDS + ("alive",):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert got.scene_scale == want.scene_scale and int(got.n_alive()) == 120
