"""The PyTorch port's GUT path as a whole against the JAX package, on the CPU:
`rasterize_gut` (image, alpha, depth and the six parameter gradients) for a distorted
pinhole, a fisheye, an orthographic and a rolling-shutter camera, per-view `dist`
coefficients, and three GUT train steps.

The port runs its kernels' plain versions; the JAX side runs its XLA chunk-scan lane
(`backend="xla"`, normalising as v / max(|v|, 1e-12)) and, for one camera of each ray
width, its Pallas kernels in interpret mode (`backend="pallas"`,
rsqrt(max(|v|^2, 1e-24))). Each JAX function is jitted once per case.

Tolerances, each with its reason:
  image and alpha atol 1e-4 (float32 blend in another order; the UT mean and covariance
    weigh the centre sigma point by about -99, so the rounding of the projected points is
    amplified a hundredfold and moves opacities through the compensation factor by up to
    5e-5 relative; measured 4e-5); depth rtol 1e-4 of its range (accumulated terms up to 10);
    the instance counters equal;
  gradients: max abs error <= 2e-4 of each parameter group's largest absolute gradient,
    on both lanes (measured: 5e-5 on means and rotations, where the quaternion chain
    amplifies rounding, 2e-6 on opacities and colours). The JAX package's own
    Pallas-against-XLA tolerances are 1e-3 on the image and 5e-3 on gradients;
  train steps: losses rtol 1e-4; parameters where |g| exceeds 1e-6 of the group's
    largest gradient at every step, atol 4e-3 of the group's learning rate per step (Adam's
    first steps move a parameter by lr * sign(g) wherever |g| is tiny); Adam's two moments
    on the same entries, rtol 2e-2 plus 1e-4 of the group's largest moment (the second
    moment doubles a gradient's relative error).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_splat.ops import cameras as jc
from tpu_splat.ops.gut import rasterize_gut as jax_rasterize_gut
from tpu_splat.training import train_step as jax_ts
from tpu_splat_torch.convert import camera_params_from_numpy
from tpu_splat_torch.core.splat import PARAM_FIELDS
from tpu_splat_torch.ops.gut import rasterize_gut
from tpu_splat_torch.training import optim, train_step as ts_mod
from tpu_splat_torch.training.losses import photometric_loss, regularization_losses

from test_torch_train_step import _jax_state, _to_port
from utils import make_camera, make_scene

SIZE = 48
KEYS = ("means", "scaling_raw", "rotation_raw", "opacity_raw", "sh0", "shN")
KW = dict(width=SIZE, height=SIZE, max_instances=1 << 12, k_max=256, tile_size=16)
PINHOLE = np.asarray([0.05, -0.01, 0, 0, 0, 0, 0.001, -0.002, 0, 0, 0, 0], np.float32)
FISHEYE = np.asarray([0.05, -0.01, 0.002, 0, 0, 0, 0, 0, 0, 0, 0, 0], np.float32)
ZERO = np.zeros(12, np.float32)
BG = np.asarray([0.1, 0.2, 0.3], np.float32)


def _both_params(model, coeffs, shutter="global"):
    c = [float(v) for v in coeffs]
    pj = jc.CameraParams(model=model, radial=tuple(c[:6]), tangential=tuple(c[6:8]),
                         thin_prism=tuple(c[8:12]), shutter=shutter)
    return pj, camera_params_from_numpy(model, shutter, coeffs)


def _shutter_pose(w2c):
    """Start at the camera's pose, end translated and slightly rotated."""
    q0 = np.asarray([1.0, 0, 0, 0], np.float32)
    q1 = np.asarray([1.0, 0.01, -0.015, 0.005], np.float32)
    q1 /= np.linalg.norm(q1)
    t0 = w2c[:3, 3].copy()
    return q0, t0, q1, t0 + np.asarray([0.2, -0.05, 0.0], np.float32)


CASES = {
    # name: (model, coeffs, shutter, render_mode, background, intrinsics or None)
    "pinhole": ("pinhole", PINHOLE, "global", "RGB_ED", BG, None),
    "fisheye": ("fisheye", FISHEYE, "global", "RGB", None, None),
    "ortho": ("ortho", ZERO, "global", "RGB_D", None, (9.0, 9.0, SIZE / 2, SIZE / 2)),
    "rolling": ("pinhole", PINHOLE, "top_to_bottom", "RGB", BG, None),
}


def _run_both(case, backend, dist=None, seed=3):
    model, coeffs, shutter, mode, bg, intr = CASES[case]
    pj, pt = _both_params(model, ZERO if dist is not None else coeffs, shutter)
    scene = make_scene(150, seed=seed)
    cam = make_camera(SIZE, SIZE)
    intr = intr or (cam["fx"], cam["fy"], cam["cx"], cam["cy"])
    pose = _shutter_pose(cam["w2c"]) if shutter != "global" else None
    weight = np.random.default_rng(0).random((3, SIZE, SIZE)).astype(np.float32)
    extra = dict(render_mode=mode, **KW)

    def loss_j(*p):
        out = jax_rasterize_gut(
            *p, jnp.asarray(scene["alive"]), jnp.asarray(cam["w2c"]),
            jnp.asarray(cam["cam_position"]), *intr, 3, None if bg is None else jnp.asarray(bg),
            cam_params=pj, backend=backend, chunk=16,
            shutter_pose=None if pose is None else tuple(jnp.asarray(x) for x in pose),
            dist=None if dist is None else jnp.asarray(dist), **extra)
        loss = jnp.sum(out.image * weight)
        return (loss if out.depth is None else loss + 0.1 * jnp.sum(out.depth)), out

    (_, out_j), grads_j = jax.jit(jax.value_and_grad(loss_j, argnums=tuple(range(6)),
                                                     has_aux=True))(
        *(jnp.asarray(scene[k]) for k in KEYS))

    leaves = [torch.from_numpy(scene[k]).requires_grad_(True) for k in KEYS]
    out_t = rasterize_gut(*leaves, scene["alive"], cam["w2c"], cam["cam_position"], *intr, 3,
                          bg, cam_params=pt, shutter_pose=pose, dist=dist, device="cpu",
                          **extra)
    loss_t = (out_t.image * torch.from_numpy(weight)).sum()
    if out_t.depth is not None:
        loss_t = loss_t + 0.1 * out_t.depth.sum()
    grads_t = torch.autograd.grad(loss_t, leaves)
    return out_j, grads_j, out_t, grads_t


def _compare(out_j, grads_j, out_t, grads_t, want_depth):
    np.testing.assert_allclose(out_t.image.detach().numpy(), np.asarray(out_j.image), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(out_t.alpha.detach().numpy(), np.asarray(out_j.alpha), rtol=0,
                               atol=1e-4)
    assert 0.05 < float(out_t.alpha.detach().mean()) < 0.95
    assert (out_t.depth is not None) == want_depth == (out_j.depth is not None)
    if want_depth:
        depth_j = np.asarray(out_j.depth)
        np.testing.assert_allclose(out_t.depth.detach().numpy(), depth_j, rtol=0,
                                   atol=1e-4 * depth_j.max())
    for name in ("total_instances", "max_tile_count", "n_visible"):
        assert int(getattr(out_t.aux, name)) == int(getattr(out_j.aux, name)), name
    assert 0 < int(out_t.aux.max_tile_count) <= KW["k_max"]
    np.testing.assert_array_equal(out_t.aux.visible.numpy(), np.asarray(out_j.aux.visible))
    for k, gt, gj in zip(KEYS, grads_t, grads_j):
        gj = np.asarray(gj)
        scale = np.abs(gj).max()
        assert scale > 0 and np.isfinite(gj).all(), k
        assert np.abs(gt.numpy() - gj).max() / scale <= 2e-4, k


@pytest.mark.parametrize("case", list(CASES))
def test_rasterize_gut_matches_jax_xla_lane(case):
    out_j, grads_j, out_t, grads_t = _run_both(case, "xla")
    _compare(out_j, grads_j, out_t, grads_t, CASES[case][3] != "RGB")


@pytest.mark.parametrize("case", ["pinhole", "ortho"])  # rays 4 wide; 8 wide
def test_rasterize_gut_matches_jax_pallas_lane(case):
    out_j, grads_j, out_t, grads_t = _run_both(case, "pallas", seed=4)
    _compare(out_j, grads_j, out_t, grads_t, CASES[case][3] != "RGB")


def test_rasterize_gut_with_dist_coefficients_matches_jax():
    """Per-view coefficients as a tensor: equal to the JAX side given the same vector, and
    to the port's own render with the coefficients baked into CameraParams."""
    out_j, grads_j, out_t, grads_t = _run_both("pinhole", "xla", dist=PINHOLE, seed=5)
    _compare(out_j, grads_j, out_t, grads_t, True)
    out_static = _port_render("pinhole", 5)
    np.testing.assert_allclose(out_t.image.detach().numpy(), out_static.image.numpy(),
                               rtol=0, atol=1e-6)
    other = _port_render("pinhole", 5, dist=np.zeros(12, np.float32))
    assert float((other.image - out_static.image).abs().max()) > 1e-3  # distortion matters


def _port_render(case, seed, dist=None, **kw):
    model, coeffs, shutter, mode, bg, intr = CASES[case]
    _, pt = _both_params(model, coeffs, shutter)
    scene = make_scene(150, seed=seed)
    cam = make_camera(SIZE, SIZE)
    intr = intr or (cam["fx"], cam["fy"], cam["cx"], cam["cy"])
    with torch.no_grad():
        return rasterize_gut(*(scene[k] for k in KEYS), scene["alive"], cam["w2c"],
                             cam["cam_position"], *intr, 3, bg, cam_params=pt, dist=dist,
                             render_mode=mode, device="cpu", **{**KW, **kw})


def test_rasterize_gut_lanes_devices_and_arguments(monkeypatch):
    scene = make_scene(150, seed=6)
    cam = make_camera(SIZE, SIZE)
    _, pt = _both_params("pinhole", PINHOLE)
    weight = torch.from_numpy(np.random.default_rng(1).random((3, SIZE, SIZE)).astype(np.float32))
    args = (scene["alive"], cam["w2c"], cam["cam_position"], cam["fx"], cam["fy"], cam["cx"],
            cam["cy"], 3, BG)

    def grads(**kw):
        leaves = [torch.from_numpy(scene[k]).requires_grad_(True) for k in KEYS]
        out = rasterize_gut(*leaves, *args, cam_params=pt, device="cpu", **KW, **kw)
        return out, torch.autograd.grad((out.image * weight).sum(), leaves)

    out_a, g_a = grads(segred_impl="segsum")
    out_b, g_b = grads(segred_impl="prefix", impl="plain", chunk=256)
    # the chunk width changes nothing but the checkpoints; the two reduction lanes and the
    # plain lane differ only in the order of float32 adds
    np.testing.assert_allclose(out_b.image.detach().numpy(), out_a.image.detach().numpy(),
                               rtol=0, atol=1e-6)
    for k, a, b in zip(KEYS, g_a, g_b):
        assert float((a - b).abs().max() / a.abs().max()) <= 1e-5, k
    assert out_a.depth is None and out_a.image.shape == (3, SIZE, SIZE)

    with pytest.raises(ValueError, match="segred_impl"):
        grads(segred_impl="block_mm")
    with pytest.raises(ValueError, match="render_mode"):
        grads(render_mode="depth")
    with pytest.raises(ValueError, match="impl"):
        grads(impl="pallas")
    # the entry point targets the card and raises without one unless asked for the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rasterize_gut(*(scene[k] for k in KEYS), *args, cam_params=pt, **KW)


def _port_grads(ts, gt, cam, plan, cfg):
    """The port's own gradients of the GUT step's loss at state `ts`."""
    p = {k: v.detach().requires_grad_(True) for k, v in ts.splat.params().items()}
    out = rasterize_gut(p["means"], p["scaling_raw"], p["rotation_raw"], p["opacity_raw"],
                        p["sh0"], p["shN"], ts.splat.alive, cam["w2c"], cam["cam_position"],
                        cam["fx"], cam["fy"], cam["cx"], cam["cy"],
                        ts_mod.active_sh_degree(ts.iteration, cfg.sh_degree_interval, 3),
                        np.zeros(3, np.float32), width=SIZE, height=SIZE,
                        max_instances=plan.max_instances, k_max=plan.k_max,
                        tile_size=plan.tile_size, cam_params=cfg.cam_params, device="cpu")
    loss = photometric_loss(out.image, torch.from_numpy(gt), cfg.lambda_dssim)
    loss = loss + regularization_losses(p, ts.splat.alive, cfg.scale_reg, cfg.opacity_reg)
    grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
    return {k: torch.zeros_like(p[k]) if g is None else g for k, g in zip(p, grads)}


def test_gut_train_steps_match_jax():
    coeffs = np.asarray([0.02] + [0] * 11, np.float32)
    pj, pt = _both_params("pinhole", coeffs)
    cams = [make_camera(SIZE, SIZE, fov_deg=55.0 + 5.0 * i) for i in range(3)]
    gt = np.random.default_rng(2).random((3, SIZE, SIZE)).astype(np.float32)
    plan_j = jax_ts.RasterPlan(max_instances=1 << 14, k_max=256, chunk=16)
    plan_t = ts_mod.RasterPlan(max_instances=1 << 14, k_max=256, chunk=16)
    cfg_j = jax_ts.StepConfig(strategy="mcmc", gut=True, cam_params=pj)
    cfg_t = ts_mod.StepConfig(strategy="mcmc", gut=True, cam_params=pt)
    kw = dict(width=SIZE, height=SIZE, total_iterations=100)

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
        # alternate the two reduction lanes: they agree to rounding
        ts_t, st_t = ts_mod.train_step(ts_t, gt, *cam_args, np.zeros(3, np.float32), step,
                                       plan=plan_t, opt=cfg_t, noise=noise,
                                       segred_impl=("segsum", "prefix")[step % 2], **kw)
        np.testing.assert_allclose(float(st_t.loss), float(st_j.loss), rtol=1e-4)
        for name in ("total_instances", "max_tile_count", "n_visible"):
            assert int(getattr(st_t, name)) == int(getattr(st_j, name)), name
        assert ts_t.iteration == int(ts_j.iteration) == step + 2
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
            for moment in ("exp_avg", "exp_avg_sq"):
                want_m = np.asarray(getattr(ts_j.adam, moment)[k])
                np.testing.assert_allclose(getattr(ts_t.adam, moment)[k].numpy()[mask],
                                           want_m[mask], rtol=2e-2,
                                           atol=1e-4 * float(np.abs(want_m[mask]).max()),
                                           err_msg=f"{moment} {k}")
            assert ts_t.adam.step_count[k] == int(ts_j.adam.step_count[k]) == step + 1


def test_gut_train_step_many_takes_per_view_coefficients():
    """`dists` reaches each step: the stretch equals the loop of `train_step` calls with
    `dist`, and differs from the stretch without distortion."""
    _, pt = _both_params("pinhole", ZERO)
    cfg = ts_mod.StepConfig(gut=True, cam_params=pt)
    ts0 = _to_port(jax_ts.init_train_state(_jax_state(), seed=1), seed=3)
    cams = [make_camera(SIZE, SIZE, fov_deg=55.0 + 5.0 * i) for i in range(2)]
    gt = np.random.default_rng(2).random((3, SIZE, SIZE)).astype(np.float32)
    kw = dict(width=SIZE, height=SIZE, plan=ts_mod.RasterPlan(1 << 14, 256), opt=cfg,
              total_iterations=100)
    dists = np.stack([PINHOLE, 2 * PINHOLE])
    ts_a, losses = ts0, []
    for i, cam in enumerate(cams):
        ts_a, st = ts_mod.train_step(ts_a, gt, cam["w2c"], cam["cam_position"], cam["fx"],
                                     cam["fy"], cam["cx"], cam["cy"], np.zeros(3, np.float32),
                                     i, dists[i], **kw)
        losses.append(float(st.loss))
    stacked = (np.stack([gt, gt]), np.stack([c["w2c"] for c in cams]),
               np.stack([c["cam_position"] for c in cams]),
               np.asarray([[c["fx"], c["fy"], c["cx"], c["cy"]] for c in cams], np.float64),
               np.zeros((2, 3), np.float32), np.arange(2))
    ts_b, stats = ts_mod.train_step_many(_to_port(jax_ts.init_train_state(_jax_state(), seed=1),
                                                  seed=3), *stacked, dists, **kw)
    np.testing.assert_allclose(stats.loss.numpy(), losses, rtol=1e-6)
    np.testing.assert_array_equal(ts_b.splat.means.numpy(), ts_a.splat.means.numpy())
    _, plain_stats = ts_mod.train_step_many(
        _to_port(jax_ts.init_train_state(_jax_state(), seed=1), seed=3), *stacked, **kw)
    assert abs(float(plain_stats.loss[0]) - losses[0]) > 1e-6
    assert dataclasses.replace(cfg, max_angle=1.0).max_angle == 1.0
