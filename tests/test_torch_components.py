"""The port's training components against the JAX package, on the CPU: the bilateral grid,
pose optimization, ADMM sparsity, the component Adam, the train step with components on,
and LPIPS.

Tolerances:
  `slice_grid`, `tv_loss` and their gradients: rtol 1e-5 (float32 trilinear weights and
    sums in another order); `init_grids` exactly.
  `warmup_exponential_lr`, the pose-opt functions (the MLP's weights carried across) and
    `aux_adam_step`: rtol 1e-6.
  The sparsity functions: masks exactly (the same sorts, stable), which entries of z are
    kept exactly, and z, u and `sparsity_loss` rtol 1e-6 (a sigmoid in another library).
  Three train steps with the bilateral grid + direct pose opt, with the pose MLP, and with
    the sparsity loss: losses rtol 1e-4, splat parameters as
    `tests/test_torch_train_step.py::test_train_step_matches_jax` holds them
    (`torch_fixtures.check_params_like_jax`), the component parameters the same way
    (where the port's gradient was zero or above 1e-6 of the leaf's largest at every step,
    within 4e-3 of the learning rate per step), step counts exactly.
  LPIPS with `random_params` weights written to an .npz: the port's equal to `LPIPSJax`
    to rtol 1e-4 on a 64x48 pair (13 float32 convolutions in another library).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_splat.core.config import OptimizationParameters as JaxOptimizationParameters
from tpu_splat.training import bilateral_grid as jbg
from tpu_splat.training import lpips as jlp
from tpu_splat.training import poseopt as jpo
from tpu_splat.training import sparsity as jsp
from tpu_splat.training import train_step as jax_ts
from tpu_splat_torch import convert
from tpu_splat_torch.core.splat import PARAM_FIELDS
from tpu_splat_torch.training import bilateral_grid as bg
from tpu_splat_torch.training import lpips as lp
from tpu_splat_torch.training import metrics
from tpu_splat_torch.training import optim
from tpu_splat_torch.training import poseopt as po
from tpu_splat_torch.training import sparsity as sp
from tpu_splat_torch.training import train_step as ts_mod

from torch_fixtures import check_params_like_jax, jax_splat, jax_state_fields, recorded_grads
from utils import make_camera

SIZE, TOTAL, N_IMAGES = 48, 100, 3
T5 = dict(rtol=1e-5, atol=1e-6)
T6 = dict(rtol=1e-6, atol=1e-7)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_bilateral_grid_matches_jax():
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(bg.init_grids(2, 6, 5, 4).numpy(),
                                  np.asarray(jbg.init_grids(2, 6, 5, 4)))
    grids = (np.asarray(jbg.init_grids(N_IMAGES, 16, 12, 8))
             + rng.normal(0, 0.1, (N_IMAGES, 12, 8, 12, 16))).astype(np.float32)
    rgb = rng.uniform(-0.1, 1.1, (3, 48, 64)).astype(np.float32)  # clamped inside
    w = rng.normal(0, 1, (3, 48, 64)).astype(np.float32)

    def jf(g, x):
        return jnp.sum(jbg.slice_grid(g[1], x) * w) + 3.0 * jbg.tv_loss(g)

    want = jbg.slice_grid(jnp.asarray(grids[1]), jnp.asarray(rgb))
    want_tv = jbg.tv_loss(jnp.asarray(grids))
    want_gg, want_gx = jax.grad(jf, argnums=(0, 1))(jnp.asarray(grids), jnp.asarray(rgb))

    g_t, x_t = _t(grids).requires_grad_(True), _t(rgb).requires_grad_(True)
    got = bg.slice_grid(g_t[1], x_t)
    got_tv = bg.tv_loss(g_t)
    (torch.sum(got * _t(w)) + 3.0 * got_tv).backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **T5)
    np.testing.assert_allclose(float(got_tv.detach()), float(want_tv), rtol=1e-5)
    np.testing.assert_allclose(g_t.grad.numpy(), np.asarray(want_gg), **T5)
    np.testing.assert_allclose(x_t.grad.numpy(), np.asarray(want_gx), **T5)
    assert np.abs(np.asarray(want_gx)).max() > 0.1
    # identity grids change nothing inside [0, 1]
    ident = bg.slice_grid(bg.init_grids(1, 16, 16, 8)[0], torch.clamp(_t(rgb), 0, 1))
    np.testing.assert_allclose(ident.numpy(), np.clip(rgb, 0, 1), rtol=1e-6, atol=1e-6)

    for base, gamma in ((2e-3, 0.01 ** (1 / 30_000)), (1e-2, 0.01 ** (1 / 100))):
        for step in (1, 2, 10, 999, 1000, 1001, 1500, 29_999):
            np.testing.assert_allclose(bg.warmup_exponential_lr(base, step, gamma),
                                       float(jbg.warmup_exponential_lr(base, step, gamma)),
                                       rtol=1e-6, err_msg=str(step))


def test_poseopt_matches_jax():
    rng = np.random.default_rng(1)
    r6 = rng.normal(0, 1, (5, 6)).astype(np.float32)
    np.testing.assert_allclose(po.rotation_6d_to_matrix(_t(r6)).numpy(),
                               np.asarray(jpo.rotation_6d_to_matrix(r6)), **T6)
    w2c = make_camera(SIZE, SIZE)["w2c"].astype(np.float32)
    direct = {"embeddings": rng.normal(0, 0.05, (N_IMAGES, 9)).astype(np.float32)}
    mlp = _np_tree(jpo.init_mlp(jax.random.key(4), N_IMAGES))
    mlp["embeddings"] = rng.normal(0, 0.3, mlp["embeddings"].shape).astype(np.float32)
    mlp["layers"][-1]["w"] = rng.normal(0, 0.05, (64, 9)).astype(np.float32)
    for mode, params in (("direct", direct), ("mlp", mlp), ("none", None)):
        for cam_idx in range(N_IMAGES):
            want = jpo.apply(mode, params, jnp.asarray(w2c), cam_idx)
            got = po.apply(mode, None if params is None else ts_mod.tree_map(_t, params),
                           _t(w2c), cam_idx)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **T6,
                                       err_msg=f"{mode} {cam_idx}")
    # inits: zero embeddings and last layer; U(+-1/8) hidden layers from the generator
    gen = torch.Generator().manual_seed(3)
    p = po.init("mlp", gen, N_IMAGES)
    assert not p["embeddings"].any() and not p["layers"][-1]["w"].any()
    h = p["layers"][0]["w"]
    assert h.shape == (64, 64) and h.abs().max() <= 0.125 and h.std() > 0.05
    again = po.init("mlp", torch.Generator().manual_seed(3), N_IMAGES)
    assert torch.equal(again["layers"][1]["b"], p["layers"][1]["b"])
    assert not po.init("direct", gen, N_IMAGES)["embeddings"].any()
    assert po.init("none", gen, N_IMAGES) is None
    with pytest.raises(ValueError, match="unknown pose"):
        po.apply("rot", direct, _t(w2c), 0)


def test_sparsity_matches_jax():
    rng = np.random.default_rng(2)
    c = 500
    op = rng.normal(0, 2, (c, 1)).astype(np.float32)
    op[::9] = op[3]  # ties
    alive = rng.random(c) < 0.8
    def check_z(got, want):  # which entries are kept exactly; their sigmoid to rtol 1e-6
        np.testing.assert_array_equal(got.numpy() == 0, np.asarray(want) == 0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **T6)

    for ratio in (0.0, 0.1, 0.6, 1.0):
        want = jsp.init_admm(jnp.asarray(op), jnp.asarray(alive), ratio)
        got = sp.init_admm(_t(op), _t(alive), ratio)
        check_z(got.z, want.z)
        want_m = jsp.prune_mask(jnp.asarray(op), jnp.asarray(alive), ratio)
        got_m = sp.prune_mask(_t(op), _t(alive), ratio)
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
        assert int(got_m.sum()) == int(ratio * np.float32(alive.sum()))
    state = jsp.ADMMState(u=jnp.asarray(rng.normal(0, 0.1, c).astype(np.float32)),
                          z=jnp.asarray(rng.random(c).astype(np.float32)))
    port = sp.ADMMState(u=_t(state.u), z=_t(state.z))
    want = jsp.update_admm(jnp.asarray(op), jnp.asarray(alive), state, 0.6)
    got = sp.update_admm(_t(op), _t(alive), port, 0.6)
    check_z(got.z, want.z)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(want.u), **T6)
    np.testing.assert_allclose(
        float(sp.sparsity_loss(_t(op), _t(alive), port, 5e-4)),
        float(jsp.sparsity_loss(jnp.asarray(op), jnp.asarray(alive), state, 5e-4)), rtol=1e-6)
    for it in range(0, 260):
        for fn, jfn in ((sp.should_update, jsp.should_update),
                        (sp.should_apply_loss, jsp.should_apply_loss),
                        (sp.should_prune, jsp.should_prune)):
            assert fn(it, 100, 120) == jfn(it, 100, 120), (fn.__name__, it)


def test_aux_adam_step_matches_jax():
    rng = np.random.default_rng(3)
    params = _np_tree(jpo.init_mlp(jax.random.key(1), N_IMAGES))
    jstate = jax_ts.AuxOptState.init(params)
    jp = jax.tree.map(jnp.asarray, params)
    tstate = ts_mod.AuxOptState.init(ts_mod.tree_map(_t, params))
    tp = ts_mod.tree_map(_t, params)
    for step in range(1, 4):
        grads = jax.tree.map(lambda a: rng.normal(0, 1, a.shape).astype(np.float32), params)
        lr = float(jbg.warmup_exponential_lr(2e-3, step, 0.999))
        jp, jstate = jax_ts.aux_adam_step(jp, jax.tree.map(jnp.asarray, grads), jstate, lr,
                                          eps=1e-15)
        tp, tstate = ts_mod.aux_adam_step(tp, ts_mod.tree_map(_t, grads), tstate,
                                          bg.warmup_exponential_lr(2e-3, step, 0.999),
                                          eps=1e-15)
        assert tstate.count == int(jstate.count) == step
        ts_mod.tree_map(lambda a, b: np.testing.assert_allclose(a.numpy(), np.asarray(b), **T6),
                        tp, jp)
        ts_mod.tree_map(lambda a, b: np.testing.assert_allclose(a.numpy(), np.asarray(b), **T6),
                        tstate.v, jstate.v)


COMPONENT_CASES = {
    "bilateral+direct": dict(use_bilateral_grid=True, pose_optimization="direct"),
    "mlp": dict(pose_optimization="mlp"),
    "sparsity": dict(enable_sparsity=True),
}


@pytest.mark.parametrize("case", list(COMPONENT_CASES))
def test_component_train_steps_match_jax(case):
    fields = COMPONENT_CASES[case]
    opt = JaxOptimizationParameters(bilateral_grid_X=8, bilateral_grid_Y=8, bilateral_grid_W=4,
                                    **fields)
    step_kw = dict(fields, sparsify_start=1, sparsify_steps=50, init_rho=0.05)
    cfg_j, cfg_t = jax_ts.StepConfig(**step_kw), ts_mod.StepConfig(**step_kw)
    ts_j = jax_ts.init_train_state(jax_splat(), seed=9, n_train_images=N_IMAGES, opt=opt)
    if cfg_j.enable_sparsity:
        ts_j = jax_ts.admm_init_step(ts_j, prune_ratio=0.6)
    ts_t = convert.train_state_from_numpy(**jax_state_fields(ts_j), device="cpu")
    cams = [make_camera(SIZE, SIZE, fov_deg=55.0 + 5.0 * i) for i in range(3)]
    gt = np.random.default_rng(2).random((3, SIZE, SIZE)).astype(np.float32)
    plan_j = jax_ts.RasterPlan(max_instances=1 << 14, k_max=256, chunk=32)
    plan_t = ts_mod.RasterPlan(max_instances=1 << 14, k_max=256, chunk=32)
    kw = dict(width=SIZE, height=SIZE, total_iterations=TOTAL)
    n_pose = len(ts_mod.tree_leaves(ts_t.pose_params)) if ts_t.pose_params else 0
    compared, comp_masks = {}, None
    for step, cam in enumerate(cams):
        cam_args = (cam["w2c"], cam["cam_position"], cam["fx"], cam["fy"], cam["cx"], cam["cy"])
        noise_key = jax.random.split(ts_j.rng)[1]  # tpu_splat/training/train_step.py:319
        noise = np.asarray(jax.random.normal(noise_key, ts_j.splat.means.shape, jnp.float32))
        ts_j, st_j = jax_ts.train_step(ts_j, jnp.asarray(gt), *cam_args, jnp.zeros(3),
                                       jnp.int32(step), plan=plan_j, opt=cfg_j, **kw)
        with recorded_grads() as calls:
            ts_t, st_t = ts_mod.train_step(ts_t, gt, *cam_args, np.zeros(3, np.float32), step,
                                           plan=plan_t, opt=cfg_t, noise=noise, **kw)
        np.testing.assert_allclose(float(st_t.loss), float(st_j.loss), rtol=1e-4)
        assert ts_t.iteration == int(ts_j.iteration) == step + 2
        # where the port's gradient exceeded 1e-6 of the leaf's largest at every step
        masks = [None if g is None else g.abs() > 1e-6 * g.abs().max() for g in calls[0]]
        for k, m in zip(PARAM_FIELDS, masks):
            if m is not None:  # None: shN above the active degree, compared exactly
                compared[k] = m if k not in compared else compared[k] & m
        # component leaves: a camera's row has a gradient only at its own step, and an
        # exactly zero gradient (the other rows) moves an entry by its moments alone
        rest = [m | (g == 0) for m, g in zip(masks[len(PARAM_FIELDS):],
                                            calls[0][len(PARAM_FIELDS):])]
        nonzero = [g != 0 for g in calls[0][len(PARAM_FIELDS):]]
        comp_masks = rest if comp_masks is None else [a & b for a, b in zip(comp_masks, rest)]
        moved = nonzero if step == 0 else [a | b for a, b in zip(moved, nonzero)]
    compared.setdefault("shN", None)
    check_params_like_jax(ts_t, ts_j, compared, optim.group_lrs(cfg_t, ts_t.splat.scene_scale),
                          3)

    def check(got, want, mask, moved, lr):
        got, mask, moved = got.numpy(), mask.numpy(), moved.numpy()
        assert (mask & moved).mean() > 0.2  # most entries took part and are compared
        np.testing.assert_allclose(got[mask], np.asarray(want)[mask], rtol=0,
                                   atol=4e-3 * lr * 3 + 1e-9)

    if n_pose:
        # leaf by leaf in the step's order; the JAX tree's dicts are matched by key
        for a, b, m, mv in zip(ts_mod.tree_leaves(ts_t.pose_params),
                               ts_mod.tree_leaves(ts_mod.tree_map(
                                   lambda x, y: y, ts_t.pose_params,
                                   _np_tree(ts_j.pose_params))),
                               comp_masks[:n_pose], moved[:n_pose]):
            if mv.any():  # the MLP's embeddings and hidden layers get no gradient while
                check(a, b, m, mv, cfg_t.pose_lr)  # its last layer is zero (step 1)
        assert ts_t.pose_opt.count == int(ts_j.pose_opt.count) == 3
        assert sum(int(mv.sum()) for mv in moved[:n_pose]) > 9
    if ts_t.bilateral_grids is not None:
        check(ts_t.bilateral_grids, ts_j.bilateral_grids, comp_masks[n_pose], moved[n_pose],
              bg.warmup_exponential_lr(cfg_t.bilateral_grid_lr, 3, 0.01 ** (1 / TOTAL)))
        assert ts_t.bilateral_opt.count == int(ts_j.bilateral_opt.count) == 3
    if cfg_t.enable_sparsity:
        np.testing.assert_array_equal(ts_t.admm.z.numpy(), np.asarray(ts_j.admm.z))


@pytest.fixture(scope="module")
def lpips_weights(tmp_path_factory):
    path = tmp_path_factory.mktemp("lpips") / "lpips_vgg.npz"
    np.savez(path, **lp.random_params(5))
    return path


def test_lpips_matches_jax(lpips_weights, tmp_path):
    want_params = jlp.random_params(5)
    for k, v in lp.random_params(5).items():
        np.testing.assert_array_equal(v, np.asarray(want_params[k]), err_msg=k)
    rng = np.random.default_rng(6)
    ys, xs = np.mgrid[0:48, 0:64] / 48.0
    a = np.stack([np.sin(3 * xs + c) * 0.4 + 0.5 for c in range(3)]).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    want = jlp.LPIPSJax(lpips_weights)(a, b)
    port = lp.LPIPSTorch(lpips_weights, device="cpu")
    got = port(a, b)
    assert want > 0 and np.isclose(got, want, rtol=1e-4), (got, want)
    assert port(a, a) == 0.0
    # the evaluator's model: the .npz beside the .pt path, on the render's device
    model = metrics.LPIPSModel(lpips_weights.with_suffix(".pt"), device="cpu")
    assert model.available and np.isclose(model(_t(a), _t(b)), want, rtol=1e-4)
    # the one-time converter writes what the JAX package's writes
    state = {}
    for i, base in enumerate(["net.slice1.0", "net.slice1.2", "net.slice2.5"]):
        state[base + ".weight"] = rng.normal(0, 1, (4, 3, 3, 3)).astype(np.float32)
        state[base + ".bias"] = rng.normal(0, 1, 4).astype(np.float32)
    for i in range(5):
        state[f"lin{i}.model.1.weight"] = rng.random((1, 4, 1, 1)).astype(np.float32)
    lp.convert_torch_lpips(state, tmp_path / "p.npz")
    jlp.convert_torch_lpips(state, tmp_path / "j.npz")
    with np.load(tmp_path / "p.npz") as p, np.load(tmp_path / "j.npz") as j:
        assert sorted(p.files) == sorted(j.files)
        for k in p.files:
            np.testing.assert_array_equal(p[k], j[k])


def test_lpips_weights_missing_or_corrupt(tmp_path):
    model = metrics.LPIPSModel(tmp_path / "weights" / "lpips_vgg.pt", device="cpu")
    assert not model.available and model(torch.zeros(3, 8, 8), torch.zeros(3, 8, 8)) is None
    (tmp_path / "lpips_vgg.npz").write_bytes(b"not an npz")
    with pytest.raises(Exception):
        metrics.LPIPSModel(tmp_path / "lpips_vgg.pt", device="cpu")
    np.savez(tmp_path / "short.npz", conv0_w=np.zeros((64, 3, 3, 3), np.float32))
    with pytest.raises(KeyError):
        lp.LPIPSTorch(tmp_path / "short.npz", device="cpu")
    (tmp_path / "ts.pt").write_bytes(b"not torchscript")
    with pytest.raises(Exception):
        metrics.LPIPSModel(tmp_path / "ts.pt", device="cpu")
