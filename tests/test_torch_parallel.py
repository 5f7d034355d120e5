"""The port's batched, multi-device training (`tpu_splat_torch/parallel/`) on the CPU,
against the JAX package's `tpu_splat/parallel/` and against itself across worlds.

  * `_window_proj` and `compact_visible` on one projection made from a numpy seed: the
    forward exactly; the gradient of `compact_visible` within 1e-6 (one row gather and its
    scatter-add, the same float32 values in both packages).
  * K2 and K3 (their plain versions) with a tile-row offset `tile_y0` in {0, 1} against the
    JAX Pallas kernels in interpret mode with the same offset: K2 atol 1e-5 (as
    `test_torch_kernels.py`), K3 within 1e-4 of the largest gradient (as
    `test_torch_blend_bwd.py`).
  * The port's batched step in a world of one process (B = 2, a 1x1 mesh) against JAX's
    `make_batched_train_step` on the conftest's 8 virtual devices as a (data 2, gauss 4)
    mesh, each JAX step built once per module: pinhole MCMC with JAX's noise handed to the
    port and a gather budget below the shard, so both compact; ADC with two different
    cameras; a distorted pinhole through GUT (on Gaussians without rotation, where the JAX
    package's sigma points, rows S R[:, i], and the port's, s_i R[:, i], agree: ROADMAP.md,
    "JAX faults not copied"; its rotated twin is held to `tests/gut_reference.py`); pose
    optimisation with the bilateral grid.
    Losses rtol 1e-4 (float32 rasterisers and SSIM summed in another order); parameters as
    `test_torch_train_step.py` holds them (`check_params_like_jax`: Adam's first step moves
    a parameter by lr * sign(g), so only entries whose gradient reaches 1e-2 of the group's
    largest are compared, within 4e-3 of the learning rate: JAX's batched pinhole lane
    rounds the per-instance gradients to bf16 (`blend_tiles_pallas(grad_bf16=True)`), and
    gradients of 1e-4 to 5e-4 of the largest were seen to change sign there; the GUT case
    holds JAX's CPU lane, its XLA chunk scan, against the kernels' plain versions); the
    Adam moments, which carry the gradient's size, on the same entries within 1e-2 of the
    group's largest moment (the bf16 per-instance rounding: up to 6e-3 seen; single entries
    that sum terms of both signs differ by up to 25% of themselves, so no per-entry rtol)
    and within 1e-5 for GUT (float32 on both sides);
    ADC's counts exactly and `dens_grad2d` rtol 6e-3 against JAX (as `test_sharding.py`),
    both bit-equal to the sum of the port's two single-camera steps' terms (the batch's 1/2
    and its undoing are exact); the pose embeddings atol 1e-6, the grids atol 1e-5 rtol 1e-4
    (as `test_sharding.py`).
  * The batched step on a 1x1 mesh with one camera against `train_step` on the same state,
    camera and noise (MCMC and ADC, components off and pose opt + bilateral grid + ADMM
    sparsity on): every leaf of the new state and the loss bit for bit.
  * `parallel/dryrun.py` over 2 gloo processes, mesh (1, 2), and over 4, mesh (2, 2): two
    steps, a refine on the gathered state and one more step; the losses, the refine's
    counts and the alive mask equal the world of one's, the gathered parameters and Adam
    moments within 1e-6 (the gradient sums over windows and data ranks add in another
    order).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_splat.ops.pallas.blend import blend_backward as jax_blend_backward
from tpu_splat.ops.pallas.blend import blend_forward as jax_blend_forward
from tpu_splat.ops.projection import Projected as JaxProjected
from tpu_splat.parallel import raster_mc as jax_mc
from tpu_splat.parallel.mesh import make_mesh as jax_make_mesh
from tpu_splat.parallel.mesh import shard_train_state as jax_shard_train_state
from tpu_splat.parallel.step import make_batched_train_step as jax_make_batched_step
from tpu_splat.training import train_step as jax_ts
from tpu_splat_torch import convert
from tpu_splat_torch.core.config import OptimizationParameters
from tpu_splat_torch.core.splat import init_from_pointcloud
from tpu_splat_torch.ops.cameras import CameraParams
from tpu_splat_torch.ops.cuda.blend import blend_backward, blend_forward
from tpu_splat_torch.ops.projection import Projected
from tpu_splat_torch.parallel import dryrun, raster_mc
from tpu_splat_torch.parallel.mesh import make_mesh
from tpu_splat_torch.parallel.step import make_batched_train_step
from tpu_splat_torch.training import optim, train_step as ts_mod

import gut_reference as ref
from test_torch_gut_reference import rotated_scene
from torch_fixtures import (blend_fixture, check_params_like_jax, jax_splat, jax_state_fields,
                            recorded_grads)
from utils import make_camera

SIZE = 32
EXACT = dict(basis_red=False, approx_recip=False, lowp=False, grad_dtype=jnp.float32)


@pytest.fixture(autouse=True)
def one_thread():
    """PyTorch's CPU kernels on one thread in every test here, as each gloo rank of
    `dryrun._worker` runs. With several, the plain blend's stop decisions near the
    transmittance threshold were seen to move from run to run, by up to 3e-4 in a few
    pixels, which comparisons at 1e-5 or bit for bit cannot absorb; the cause is not
    found (ROADMAP.md Queue 3)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- window and compaction

def _projection(n=300, seed=4, grid=(4, 6)):
    """Projected fields from numpy: rects inside a grid_w x grid_h tile grid, a third of
    the rows invisible."""
    rng = np.random.default_rng(seed)
    gw, gh = grid
    tmin = np.stack([rng.integers(0, gw, n), rng.integers(0, gh, n)], 1).astype(np.int32)
    tmax = np.minimum(tmin + rng.integers(1, 4, (n, 2)), [gw, gh]).astype(np.int32)
    vis = rng.random(n) < 0.67
    n_tiles = np.where(vis, np.prod(tmax - tmin, 1), 0).astype(np.int32)
    f = lambda *s: rng.normal(0, 1, s).astype(np.float32)  # noqa: E731
    return dict(mean2d=f(n, 2), conic=f(n, 3), opacity=f(n), color=f(n, 3), depth=f(n),
                tile_min=tmin, tile_max=tmax, n_tiles=n_tiles, power_threshold=f(n),
                visible=vis)


def _assert_proj_equal(got: Projected, want: JaxProjected):
    for k in Projected._fields:
        np.testing.assert_array_equal(getattr(got, k).detach().numpy(),
                                      np.asarray(getattr(want, k)), err_msg=k)


@pytest.mark.parametrize("y0", [0, 2, 4])
def test_window_proj_matches_jax(y0):
    p = _projection()
    want = jax_mc._window_proj(JaxProjected(**{k: jnp.asarray(v) for k, v in p.items()}),
                               jnp.int32(y0), 2)
    got = raster_mc._window_proj(Projected(**{k: torch.from_numpy(v) for k, v in p.items()}),
                                 y0, 2)
    _assert_proj_equal(got, want)
    assert 0 < int(got.visible.sum()) < int(p["visible"].sum())


@pytest.mark.parametrize("gut", [False, True])
def test_compact_visible_matches_jax(gut):
    p = _projection()
    n, budget = p["visible"].shape[0], 256  # ~200 visible rows: every one fits
    rng = np.random.default_rng(5)
    feats = rng.normal(0, 1, (n, 16)).astype(np.float32) if gut else None
    diff = ("mean2d", "conic", "opacity", "color", "depth")
    w_proj = {k: rng.normal(0, 1, (budget, *p[k].shape[1:])).astype(np.float32) for k in diff}
    w_feat = rng.normal(0, 1, (budget, 16)).astype(np.float32)

    def jax_loss(dp, jf):
        jp = JaxProjected(**{k: jnp.asarray(v) for k, v in p.items()})._replace(**dp)
        cf = () if jf is None else jax_mc._GutFeats(
            isclrot=jf[:, 0:9].reshape(n, 3, 3), gro=jf[:, 9:12], opacity=jf[:, 12],
            color=jf[:, 13:16])
        cp, cfo, nv = jax_mc.compact_visible(jp, cf, budget)
        loss = sum(jnp.sum(getattr(cp, k) * w_proj[k]) for k in diff)
        flat = None
        if jf is not None:
            flat = jnp.concatenate([cfo.isclrot.reshape(budget, 9), cfo.gro,
                                    cfo.opacity[:, None], cfo.color], 1)
            loss = loss + jnp.sum(flat * w_feat)
        return loss, (cp, flat, nv)

    dp = {k: jnp.asarray(p[k]) for k in diff}
    if gut:
        (_, (cp_j, cf_j, nv_j)), (g_dp, g_f) = jax.value_and_grad(
            jax_loss, argnums=(0, 1), has_aux=True)(dp, jnp.asarray(feats))
    else:
        (_, (cp_j, cf_j, nv_j)), g_dp = jax.value_and_grad(
            lambda d: jax_loss(d, None), has_aux=True)(dp)

    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    leaves = {k: tp[k].clone().requires_grad_(True) for k in diff}
    tf = None if feats is None else torch.from_numpy(feats).requires_grad_(True)
    table, nv = raster_mc.compact_visible(Projected(**{**tp, **leaves}), tf, budget)
    cp, cf = raster_mc.unpack_projection(table, gut)
    _assert_proj_equal(cp, cp_j)
    assert int(nv) == int(nv_j) == int(p["visible"].sum())
    if gut:
        np.testing.assert_array_equal(cf.detach().numpy(), np.asarray(cf_j))
    loss = sum((getattr(cp, k) * torch.from_numpy(w_proj[k])).sum() for k in diff)
    if gut:
        loss = loss + (cf * torch.from_numpy(w_feat)).sum()
    grads = torch.autograd.grad(loss, list(leaves.values()) + ([tf] if gut else []))
    for k, g in zip(diff, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(g_dp[k]), rtol=0, atol=1e-6,
                                   err_msg=k)
    if gut:
        np.testing.assert_allclose(grads[-1].numpy(), np.asarray(g_f), rtol=0, atol=1e-6)


def test_compact_visible_drops_past_budget():
    """An insufficient budget keeps the first `budget` visible rows and reports the count
    (the Trainer grows the budget and redoes the step)."""
    p = _projection()
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    n_vis = int(p["visible"].sum())
    table, nv = raster_mc.compact_visible(Projected(**tp), None, 64)
    cp, _ = raster_mc.unpack_projection(table, False)
    assert int(nv) == n_vis > 64 and bool(cp.visible.all())
    np.testing.assert_array_equal(cp.mean2d.numpy(), p["mean2d"][p["visible"]][:64])
    with pytest.raises(ValueError, match="skip"):
        raster_mc.compact_visible(Projected(**tp), None, 300)


# ---------------------------------------------------------------- K2 / K3 with tile_y0

@pytest.mark.parametrize("tile_y0", [0, 1])
def test_blend_tile_y0_matches_pallas_interpret(tile_y0):
    flat, seg_start, count, kw = blend_fixture()
    flat = flat.copy()
    flat[1] += tile_y0 * kw["tile_size"]  # the splats follow the window down the image
    chunk, max_chunks = 256, 2
    kwj = dict(max_chunks=max_chunks, chunk=chunk, interpret=True, **kw)
    jargs = (jnp.asarray(flat), jnp.asarray(seg_start), jnp.asarray(count))
    out_j, chk_j = jax_blend_forward(*jargs, tile_y0=jnp.int32(tile_y0), **kwj)
    gout = np.random.default_rng(6).normal(0, 0.3, (kw["n_tiles"], 256, 8)).astype(np.float32)
    want = np.asarray(jax_blend_backward(*jargs, chk_j, out_j, jnp.asarray(gout),
                                         tile_y0=jnp.int32(tile_y0), **EXACT, **kwj))

    used = int((seg_start + count).max())
    targs = (torch.from_numpy(flat[:, :used].copy()), torch.from_numpy(seg_start),
             torch.from_numpy(count))
    kwt = dict(max_chunks=max_chunks, chunk=chunk, tile_y0=tile_y0, **kw)
    out, chk = blend_forward(*targs, **kwt)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(chk.numpy(), np.asarray(chk_j), rtol=0, atol=1e-5)
    got = blend_backward(*targs, chk, out, torch.from_numpy(gout), **kwt).numpy()
    scale = np.abs(want[:10, :used]).max()
    assert np.abs(got - want[:10, :used]).max() / scale <= 1e-4
    # the offset moves the pixel centres: a window one tile row down is another image
    other, _ = blend_forward(*targs, **dict(kwt, tile_y0=1 - tile_y0))
    assert np.abs(other.numpy() - out.numpy()).max() > 1e-2


@pytest.mark.parametrize("n_windows", [2, 3])
def test_windows_stack_to_the_whole_frame(n_windows):
    """A frame rendered as windows of tile rows (`_window_proj` -> instances with tile_y0
    and the whole image's sort key -> K2 with tile_y0) stacks to the whole frame bit for
    bit, through the plain versions."""
    from tpu_splat_torch.ops.cuda.raster import build_sorted_instances, feature_table
    from tpu_splat_torch.ops.projection import project
    from tpu_splat_torch.ops.rasterize import assemble_image, blend_instances, rasterize

    scene = dryrun.Scene(n_gauss=400, capacity=512, width=64, height=80, scale=0.1)
    sp = dryrun.random_splat(scene, "cpu")
    _, w2cs, cpos, intr = dryrun.cameras(scene)
    cam = (torch.from_numpy(w2cs[0]), torch.from_numpy(cpos[0]), *map(float, intr[0]))
    kw = dict(max_instances=1 << 14, k_max=256, chunk=128, tile_size=16)
    whole = rasterize(sp.means, sp.scaling_raw, sp.rotation_raw, sp.opacity_raw, sp.sh0,
                      sp.shN, sp.alive, *cam, 1, None, width=64, height=80, device="cpu",
                      **kw)
    gw, gh = 4, 5
    gh_loc = -(-gh // n_windows)
    proj = project(sp.means, sp.scaling_raw, sp.rotation_raw, sp.opacity_raw, sp.sh0, sp.shN,
                   sp.alive, *cam, 64, 80, 1, tile_size=16)
    rows = []
    for w in range(n_windows):
        wproj = raster_mc._window_proj(proj, w * gh_loc, gh_loc)
        inst = build_sorted_instances(wproj, gw, gh_loc, 1 << 14, 16, tile_y0=w * gh_loc,
                                      image_tiles=gw * gh)
        tc, ta, _ = blend_instances(inst, feature_table(wproj), grid_w=gw, grid_h=gh_loc,
                                    tile_size=16, k_max=256, chunk=128, tile_y0=w * gh_loc)
        rows.append(assemble_image(tc, ta, gw, gh_loc, 16, 64, 16 * gh_loc)[0])
    stacked = torch.cat(rows, dim=1)[:, :80]
    assert torch.equal(stacked, whole.image.detach())
    assert float(whole.alpha.mean()) > 0.2


# ---------------------------------------------------------------- the batched step vs JAX

@pytest.fixture(scope="module")
def jax_step():
    """JAX's batched step over the conftest's 8 virtual devices as (data 2, gauss 4)."""
    mesh = jax_make_mesh(jax.devices(), data=2)
    return mesh, jax_make_batched_step(mesh)


def _cameras():
    """Two different cameras: the test camera and a yawed, shifted view of the cloud
    (test_sharding.py:209-222)."""
    cam = make_camera(SIZE, SIZE)
    th = 0.15
    r = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]],
                 np.float32)
    p2 = np.array([0.8, 0.2, 0.3], np.float32)
    w2c2 = np.eye(4, dtype=np.float32)
    w2c2[:3, :3], w2c2[:3, 3] = r, -r @ p2
    w2cs = np.stack([cam["w2c"], w2c2]).astype(np.float32)
    cpos = np.stack([cam["cam_position"], p2]).astype(np.float32)
    intr = np.tile(np.asarray([cam["fx"], cam["fy"], SIZE / 2, SIZE / 2], np.float32), (2, 1))
    gts = np.random.default_rng(12).random((2, 3, SIZE, SIZE)).astype(np.float32)
    return gts, w2cs, cpos, intr


def _run_both(jax_step, cfg_j, cfg_t, *, capacity=256, budget=None, opt=None,
              cam_idxs=None, dist=None, unrotated=False):
    mesh_j, step_j = jax_step
    splat = jax_splat(n=100, capacity=capacity, seed=11)
    if unrotated:  # where the JAX package's sigma points and the port's agree
        q = np.zeros(splat.rotation_raw.shape, np.float32)
        q[:, 0] = np.asarray(splat.rotation_raw)[:, 0]
        splat = dataclasses.replace(splat, rotation_raw=jnp.asarray(q))
    ts_j = jax_ts.init_train_state(splat, seed=3, n_train_images=4, opt=opt)
    ts_t = convert.train_state_from_numpy(**jax_state_fields(ts_j), device="cpu")
    gts, w2cs, cpos, intr = _cameras()
    plan_kw = dict(max_instances=1 << 13, k_max=256, chunk=128, tile_size=16,
                   gather_budget=budget)
    kw = dict(width=SIZE, height=SIZE, total_iterations=100)
    noise = None
    if cfg_t.strategy == "mcmc":  # the key JAX's step splits off (parallel/step.py:97)
        key = jax.random.split(ts_j.rng)[1]
        noise = np.asarray(jax.random.normal(key, ts_j.splat.means.shape, jnp.float32))
    ci = None if cam_idxs is None else jnp.asarray(cam_idxs, jnp.int32)
    ts_j2, st_j = step_j(jax_shard_train_state(mesh_j, ts_j), jnp.asarray(gts),
                         jnp.asarray(w2cs), jnp.asarray(cpos), jnp.asarray(intr),
                         jnp.zeros(3), ci, None if dist is None else jnp.asarray(dist),
                         plan=jax_ts.RasterPlan(**plan_kw), opt=cfg_j, **kw)
    step_t = make_batched_train_step(make_mesh(1))
    with recorded_grads() as calls:
        ts_t2, st_t = step_t(ts_t, gts, w2cs, cpos, intr, np.zeros(3, np.float32), cam_idxs,
                             dist, plan=ts_mod.RasterPlan(**plan_kw), opt=cfg_t, noise=noise,
                             **kw)
    compared = {k: torch.zeros_like(v, dtype=torch.bool) if g is None
                else g.abs() > 1e-2 * g.abs().max()
                for (k, v), g in zip(ts_t.splat.params().items(), calls[0])}
    np.testing.assert_allclose(float(st_t.loss), float(st_j.loss), rtol=1e-4)
    assert ts_t2.iteration == int(ts_j2.iteration) == 2
    # JAX's pinhole lane rounds per-instance gradients to bf16 (up to 6e-3 of the largest
    # seen); its GUT lane on the CPU is float32 throughout (5e-6 seen)
    _check_moments_like_jax(ts_t2, ts_j2, compared, 1e-5 if cfg_t.gut else 1e-2)
    return ts_t, ts_t2, ts_j2, st_t, compared, (gts, w2cs, cpos, intr)


def _check_moments_like_jax(ts_t2, ts_j2, compared, tol):
    """Adam's moments after the first step, exp_avg = 0.1 g and exp_avg_sq = 0.001 g^2, on
    the compared entries, within `tol` of the group's largest: they carry the size of the
    batch-mean gradient, which the parameters (moved by lr * sign(g)) do not, so a gradient
    scaled by 1/B once too often or too rarely fails here by half of the largest."""
    for k, mask in compared.items():
        m = mask.numpy()
        if not m.any():
            continue
        for field in ("exp_avg", "exp_avg_sq"):
            got = getattr(ts_t2.adam, field)[k].numpy()[m]
            want = np.asarray(getattr(ts_j2.adam, field)[k])[m]
            np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max(),
                                       err_msg=f"{field}.{k}")


def test_batched_mcmc_matches_jax(jax_step):
    # capacity 512: 128 rows a JAX shard, budget 112; the port's one shard of 512 rows
    # compacts to the same 112 slots (100 alive Gaussians fit both)
    ts_t, ts_t2, ts_j2, st_t, compared, _ = _run_both(
        jax_step, jax_ts.StepConfig(), ts_mod.StepConfig(), capacity=512, budget=112)
    assert int(st_t.n_shard_visible) == 100 <= 112
    lrs = optim.group_lrs(ts_mod.StepConfig(), ts_t.splat.scene_scale)
    check_params_like_jax(ts_t2, ts_j2, compared, lrs, 1)


def test_batched_adc_accumulation_matches_jax_and_sequential(jax_step):
    cfg_t = ts_mod.StepConfig(strategy="default")
    ts_t, ts_t2, ts_j2, _, compared, (gts, w2cs, cpos, intr) = _run_both(
        jax_step, jax_ts.StepConfig(strategy="default"), cfg_t)
    np.testing.assert_array_equal(ts_t2.dens_count.numpy(), np.asarray(ts_j2.dens_count))
    np.testing.assert_allclose(ts_t2.dens_grad2d.numpy(), np.asarray(ts_j2.dens_grad2d),
                               rtol=6e-3, atol=1e-5)
    # the port's two single-camera steps from the same state: each adds its own term
    kw = dict(width=SIZE, height=SIZE, plan=ts_mod.RasterPlan(1 << 13, 256, chunk=128,
                                                              tile_size=16),
              opt=cfg_t, total_iterations=100)
    terms = [ts_mod.train_step(ts_t, gts[b], w2cs[b], cpos[b], *intr[b],
                               np.zeros(3, np.float32), b, **kw)[0] for b in range(2)]
    for k in ("dens_count", "dens_grad2d"):
        want = sum(getattr(t, k) for t in terms) - getattr(ts_t, k)
        torch.testing.assert_close(getattr(ts_t2, k), want, rtol=0, atol=0)
    assert int((ts_t2.dens_count == 2).sum()) > 20  # Gaussians both cameras see


def test_batched_gut_matches_jax(jax_step):
    from tpu_splat.ops.cameras import CameraParams as JaxCameraParams

    coeffs = CameraParams(radial=(0.05, -0.01, 0, 0, 0, 0), tangential=(0.001, 0.0))
    d12 = np.asarray(coeffs.coeff_vector(), np.float32)
    cfg_j = jax_ts.StepConfig(gut=True, cam_params=JaxCameraParams())
    cfg_t = ts_mod.StepConfig(gut=True, cam_params=CameraParams())
    ts_t, ts_t2, ts_j2, _, compared, _ = _run_both(jax_step, cfg_j, cfg_t,
                                                   dist=np.stack([d12, d12]), unrotated=True)
    lrs = optim.group_lrs(cfg_t, ts_t.splat.scene_scale)
    check_params_like_jax(ts_t2, ts_j2, compared, lrs, 1)


def test_batched_gut_rotated_matches_reference():
    """The twin of `test_batched_gut_matches_jax` on rotated, anisotropic Gaussians: the
    port's batched step (B = 2, a 1x1 mesh, no MCMC noise) held to the plain reference's
    step over the same two cameras at the same tolerances: the loss rtol 1e-4, the
    parameters as `check_params_like_jax` holds them, Adam's moments within 1e-5 of the
    group's largest."""
    coeffs = CameraParams(radial=(0.05, -0.01, 0, 0, 0, 0), tangential=(0.001, 0.0))
    d12 = np.asarray(coeffs.coeff_vector(), np.float32)
    cfg = ts_mod.StepConfig(gut=True, cam_params=CameraParams())
    scene, alive = rotated_scene(256, seed=11)
    zeros = {k: np.zeros_like(v) for k, v in scene.items()}
    ts = convert.train_state_from_numpy(scene, alive, zeros, zeros, dict.fromkeys(scene, 0), 1,
                                        max_sh_degree=3, scene_scale=1.5, device="cpu")
    gts, w2cs, cpos, intr = _cameras()
    plan = ts_mod.RasterPlan(max_instances=1 << 13, k_max=256, chunk=128, tile_size=16)
    step = make_batched_train_step(make_mesh(1))
    with recorded_grads() as calls:
        ts2, st = step(ts, gts, w2cs, cpos, intr, np.zeros(3, np.float32), None,
                       np.stack([d12, d12]), plan=plan, opt=cfg, noise=np.zeros((256, 3)),
                       width=SIZE, height=SIZE, total_iterations=100)
    lrs = optim.group_lrs(cfg, 1.5)
    cams = [ref.camera(w2cs[b], *intr[b], SIZE, SIZE, coeffs=d12) for b in range(2)]
    p = {k: torch.from_numpy(v) for k, v in scene.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    want = ref.train_step(p, torch.from_numpy(alive), m, m, dict.fromkeys(p, 0), cams,
                          [torch.from_numpy(g) for g in gts], 1, 100, lrs, 0,
                          np.zeros(3, np.float32))
    np.testing.assert_allclose(float(st.loss), float(want["loss"]), rtol=1e-4)
    took = dict(zip(ts.splat.params(), calls[0]))
    compared = {k: torch.zeros(1, dtype=torch.bool) if g is None else g.abs() > 1e-2 * g.abs().max()
                for k, g in took.items()}
    for k, mask in compared.items():
        mk = mask.numpy()
        if k == "shN":  # frozen for the first 1000 iterations
            np.testing.assert_array_equal(ts2.splat.shN.numpy(), scene["shN"])
            continue
        assert mk.mean() > 0.05, k
        np.testing.assert_allclose(getattr(ts2.splat, k).numpy()[mk],
                                   want["params"][k].numpy()[mk], rtol=0,
                                   atol=4e-3 * lrs[k] + 1e-7, err_msg=k)
        for field in ("exp_avg", "exp_avg_sq"):
            exp = want[field][k].numpy()[mk]
            np.testing.assert_allclose(getattr(ts2.adam, field)[k].numpy()[mk], exp, rtol=0,
                                       atol=1e-5 * np.abs(exp).max(), err_msg=f"{field}.{k}")


def test_batched_pose_bilateral_matches_jax(jax_step):
    from tpu_splat.core.config import OptimizationParameters as JaxOptimizationParameters

    op = JaxOptimizationParameters(pose_optimization="direct", use_bilateral_grid=True,
                                   bilateral_grid_X=4, bilateral_grid_Y=4,
                                   bilateral_grid_W=4)
    kw = dict(pose_optimization="direct", use_bilateral_grid=True, tv_loss_weight=10.0)
    ts_t, ts_t2, ts_j2, _, compared, _ = _run_both(
        jax_step, jax_ts.StepConfig(**kw), ts_mod.StepConfig(**kw), opt=op, cam_idxs=[1, 2])
    np.testing.assert_allclose(ts_t2.pose_params["embeddings"].numpy(),
                               np.asarray(ts_j2.pose_params["embeddings"]), atol=1e-6)
    assert float(ts_t2.pose_params["embeddings"][1:3].abs().max()) > 0  # both moved
    np.testing.assert_allclose(ts_t2.bilateral_grids.numpy(), np.asarray(ts_j2.bilateral_grids),
                               atol=1e-5, rtol=1e-4)
    lrs = optim.group_lrs(ts_mod.StepConfig(**kw), ts_t.splat.scene_scale)
    check_params_like_jax(ts_t2, ts_j2, compared, lrs, 1)


def _state_leaves(x, path="ts"):
    """(path, leaf) of a train state: tensors, generator states and host numbers."""
    if dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from _state_leaves(getattr(x, f.name), f"{path}.{f.name}")
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _state_leaves(v, f"{path}.{k}")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from _state_leaves(v, f"{path}[{i}]")
    elif isinstance(x, torch.Generator):
        yield path, x.get_state()
    else:
        yield path, x


@pytest.mark.parametrize("components", [False, True], ids=["plain", "pose-bilateral-sparsity"])
@pytest.mark.parametrize("strategy", ["mcmc", "default"])
def test_batched_step_of_one_camera_is_train_step(strategy, components):
    """One camera through `batched_train_step` on a 1x1 mesh and through `train_step`, from
    the same state with the same noise: the same next state, leaf for leaf, and the same
    loss, bit for bit. The two share their gradient head and update tail, and the batched
    step's mean over one camera, its collectives on a mesh of one and its undoing of the
    batch's 1/B are exact. Its loss adds the terms in another order (photo + (reg +
    sparsity), then + tv, against ((photo + reg) + tv) + sparsity); the gradients do not
    depend on that order, and on this scene the two sums round to the same float32."""
    w, h, capacity = 64, 48, 512
    rng = np.random.default_rng(5)
    pts = rng.normal(0, 0.8, (300, 3)).astype(np.float32)
    pts[:, 2] += 5
    splat = init_from_pointcloud(pts, rng.random((300, 3)).astype(np.float32),
                                 np.array([0, 0, 5.0], np.float32), capacity, 3, device="cpu")
    kw = dict(strategy=strategy)
    opt = None
    if components:
        kw.update(pose_optimization="direct", use_bilateral_grid=True, enable_sparsity=True,
                  sparsify_start=1, sparsify_steps=100)
        opt = OptimizationParameters(pose_optimization="direct", use_bilateral_grid=True,
                                     bilateral_grid_X=4, bilateral_grid_Y=4, bilateral_grid_W=4)
    ts = ts_mod.init_train_state(splat, seed=3, n_train_images=4, opt=opt, device="cpu")
    if components:  # grids off the identity and poses off zero: every term has a gradient
        gen = torch.Generator().manual_seed(1)
        ts = dataclasses.replace(
            ts_mod.admm_init_step(ts, prune_ratio=0.6),
            bilateral_grids=ts.bilateral_grids
            + 0.05 * torch.randn(ts.bilateral_grids.shape, generator=gen),
            pose_params={"embeddings": 0.01 * torch.randn(ts.pose_params["embeddings"].shape,
                                                          generator=gen)})
    cam = make_camera(w, h)
    intr = np.asarray([[cam["fx"], cam["fy"], cam["cx"], cam["cy"]]], np.float32)
    gt = rng.random((1, 3, h, w)).astype(np.float32)
    step_kw = dict(width=w, height=h, opt=ts_mod.StepConfig(**kw), total_iterations=100,
                   plan=ts_mod.RasterPlan(max_instances=1 << 14, k_max=256, chunk=128),
                   noise=torch.from_numpy(rng.normal(size=(capacity, 3)).astype(np.float32)),
                   impl="plain")
    bg = np.zeros(3, np.float32)
    want, st_want = ts_mod.train_step(ts, gt[0], cam["w2c"], cam["cam_position"],
                                      *map(float, intr[0]), bg, 1, **step_kw)
    got, st_got = make_batched_train_step(make_mesh(1))(
        ts, gt, cam["w2c"][None], cam["cam_position"][None], intr, bg, [1], **step_kw)
    assert torch.equal(st_got.loss, st_want.loss)
    assert [int(v) for v in st_got[1:]] == [int(v) for v in st_want[1:]]
    want_leaves, got_leaves = dict(_state_leaves(want)), dict(_state_leaves(got))
    assert got_leaves.keys() == want_leaves.keys()
    for path, v in want_leaves.items():
        g = got_leaves[path]
        if torch.is_tensor(v):
            assert g.dtype == v.dtype and torch.equal(g, v), path
        else:
            assert g == v, path
    assert got.iteration == 2 and not torch.equal(got.splat.means, ts.splat.means)
    if strategy == "default":
        assert int((got.dens_count > 0).sum()) > 100
    if components:
        assert not torch.equal(got.bilateral_grids, ts.bilateral_grids)
        assert not torch.equal(got.pose_params["embeddings"], ts.pose_params["embeddings"])


# ---------------------------------------------------------------- gloo worlds vs one

@pytest.fixture(scope="module")
def world_one():
    n = torch.get_num_threads()
    torch.set_num_threads(1)  # as each gloo rank (dryrun._worker)
    try:
        return dryrun.run(1, 1, dryrun.Scene(), "cpu", steps=2)
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("world,data", [(2, 1), (4, 2)])
def test_gloo_world_matches_world_of_one(world_one, world, data):
    got = dryrun.run(world, data, dryrun.Scene(), "cpu", steps=2, timeout=120)
    assert got["mesh"] == (data, world // data)
    np.testing.assert_allclose(got["losses"], world_one["losses"], rtol=1e-6)
    assert got["refine"] == world_one["refine"] and got["refine"]["n_new"] > 0
    np.testing.assert_array_equal(got["alive"], world_one["alive"])
    for group in ("params", "exp_avg"):
        for k, want in world_one[group].items():
            np.testing.assert_allclose(got[group][k], want, rtol=1e-6, atol=1e-6,
                                       err_msg=f"{group}.{k}")
    # every gauss shard holds alive rows, and the windows split the instances
    assert all(c[3] < 100 for c in got["counts"])
    assert all(math.isfinite(v) for v in got["losses"])


def test_mesh_shapes_and_batch_slices():
    from tpu_splat_torch.parallel.distributed import local_batch_slice
    from tpu_splat_torch.parallel.mesh import Mesh, mesh_shape

    assert mesh_shape(8, 2) == (2, 4) and mesh_shape(4) == (1, 4)
    with pytest.raises(ValueError, match="divisible"):
        mesh_shape(6, 4)
    m = Mesh(data=2, gauss=2, rank=3)
    assert (m.d, m.g) == (1, 1) and m.shard_rows(512) == slice(256, 512)
    assert local_batch_slice(4, m) == slice(2, 4)
    with pytest.raises(ValueError, match="divisible"):
        local_batch_slice(3, m)
    one = make_mesh(1)
    x = torch.arange(6.0)
    assert one.all_gather(x, "gauss") is x and one.reduce_scatter(x, "data") is x
    assert (one.data, one.gauss, one.rank, one.gauss_group) == (1, 1, 0, None)
