"""The port's 3DGUT path held to the plain reference `tests/gut_reference.py` on the CPU.

Scenes: 400 Gaussians drawn from a seed with random rotations and anisotropic scales (one
axis 4 to 12.5 times each of the other two), every ninth slot dead, seen at 64x48 through the benchmark
configuration's camera (`splatbench/configs/garden-gut-1m.json`): OPENCV, k1 = 0.05. Held
to the reference: `rasterize_gut` through both `impl`s that run on the CPU (image, alpha,
depth, the instance counters, the gradient of every leaf), `ut_project`, and the GUT
`train_step` at iteration 7100 with SH 3 (image, loss, the gradient of every leaf as the
step took it, and the state after one Adam step from warm moments); and, under the linear
orthographic camera, where the unscented transform is exact, the UT conic against its
closed form on the single-camera path and through the mesh path's projection transport.

Tolerances, each with its reason:
  image and alpha atol 1e-4, depth atol 1e-4 of its largest value: the same float32
    formulas blended in another order (the kernels' chunked closed form against one
    Gaussian at a time); measured 3e-6;
  gradients: max abs error <= 2e-4 of each leaf's largest absolute gradient, as the JAX
    parity tests allow (measured up to 6e-6);
  `ut_project` float fields rtol 1e-4 plus atol 1e-3, tile rects equal but for at most 3
    Gaussians, as `test_torch_gut_cameras.py` allows (the UT mean weighs the centre point
    by -99, which amplifies the rounding of ~50 px image points a hundredfold);
  loss rtol 1e-5 (float32 sums of 9216 terms in another order); the Adam step from warm
    moments: parameters atol 1e-3 of the group's learning rate beyond two float32 ulps
    of the parameter (the update is rounded into it), moments rtol 1e-3 plus
    1e-6 of the group's largest (an update is lr m / sqrt(v): relative gradient errors of
    1e-5 move it by far less);
  the ortho conic: its inverse within rtol 1e-4 of J W R diag(s^2) R^T W^T J^T + 0.3 I,
    atol 1e-4 of the matrix's largest entry (an off-diagonal entry may be near zero).

Run on the sigma points as first ported (rows S R[:, i], whose covariance is diag(s^2)
whatever the rotation), every test here but the last fails: the image by 0.17-0.27 (atol
1e-4), `ut_project`'s fields at 93-95% of their entries, the train step's loss by 3.8e-3 of
itself (rtol 1e-5), the ortho conic's inverse by up to 2e5. The last,
`test_the_unrotated_sigma_rows_fail_here`, shows on the reference itself that the two rules
lie far apart beyond these tolerances.
"""

import numpy as np
import pytest
import torch

import gut_reference as ref
from tpu_splat_torch import convert
from tpu_splat_torch.ops.cameras import CameraParams
from tpu_splat_torch.ops.gut import gut_feature_table, rasterize_gut, ut_project
from tpu_splat_torch.parallel import raster_mc
from tpu_splat_torch.training import train_step as ts_mod

from torch_fixtures import recorded_grads

W, H, TILE = 64, 48, 16
F = 0.85 * W
K1 = [0.05] + [0.0] * 11
KEYS = ("means", "scaling_raw", "rotation_raw", "opacity_raw", "sh0", "shN")
BG = np.asarray([0.1, 0.2, 0.3], np.float32)
KW = dict(width=W, height=H, max_instances=1 << 14, k_max=512, tile_size=TILE)


def rotated_scene(n=400, seed=0):
    """Gaussians in the camera's frustum (z 3-7) with random rotations and one axis at
    least 4 times each of the other two; every ninth slot dead."""
    g = np.random.default_rng(seed)
    means = np.stack([g.uniform(-1.6, 1.6, n), g.uniform(-1.2, 1.2, n), g.uniform(3, 7, n)], 1)
    scaling = np.log(g.uniform(0.03, 0.08, (n, 1)) * g.uniform(0.8, 1.0, (n, 3)))
    scaling[np.arange(n), g.integers(0, 3, n)] += np.log(g.uniform(4, 8, n) / 0.8)
    arrays = dict(means=means, scaling_raw=scaling, rotation_raw=g.normal(0, 1, (n, 4)),
                  opacity_raw=g.normal(0.5, 1.0, (n, 1)), sh0=g.normal(0, 0.7, (n, 1, 3)),
                  shN=g.normal(0, 0.1, (n, 15, 3)))
    alive = np.ones(n, bool)
    alive[::9] = False
    return {k: v.astype(np.float32) for k, v in arrays.items()}, alive


def _w2c(tilt=0.0):
    w2c = np.eye(4, dtype=np.float32)
    c, s = np.cos(tilt), np.sin(tilt)
    w2c[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    w2c[:3, 3] = (0.1, -0.05, 0.2)
    return w2c


def _ref_params(scene):
    return {k: torch.from_numpy(scene[k]) for k in KEYS}


def _compare_frames(out, want):
    np.testing.assert_allclose(out.image.detach().numpy(), want["image"].detach().numpy(),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(out.alpha.detach().numpy(), want["alpha"].detach().numpy(),
                               rtol=0, atol=1e-4)
    assert 0.2 < float(out.alpha.detach().mean()) < 0.95
    ut = want["ut"]
    assert int(out.aux.n_visible) == int(ut["visible"].sum())
    assert int(out.aux.total_instances) == int(ut["tiles"].sum())


def _compare_grads(got, want):
    for k, a, b in zip(KEYS, got, want):
        scale = float(b.abs().max())
        assert scale > 0, k
        assert float((a - b).abs().max()) <= 2e-4 * scale, k


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_rasterize_gut_matches_reference(impl, seed):
    scene, alive = rotated_scene(seed=seed)
    w2c = _w2c(0.05)
    cam = ref.camera(w2c, F, F, W / 2, H / 2, W, H, coeffs=K1)
    weight = torch.rand((3, H, W), generator=torch.Generator().manual_seed(seed))

    leaves = [torch.from_numpy(scene[k]).requires_grad_(True) for k in KEYS]
    out = rasterize_gut(*leaves, alive, w2c, cam["position"], F, F, W / 2, H / 2, 3, BG,
                        cam_params=CameraParams(radial=tuple(K1[:6])), render_mode="RGB_D",
                        device="cpu", impl=impl, **KW)
    got = torch.autograd.grad((out.image * weight).sum() + 0.1 * out.depth.sum(), leaves)

    p = {k: v.requires_grad_(True) for k, v in _ref_params(scene).items()}
    want = ref.render(p, torch.from_numpy(alive), cam, 3, BG)
    grads = torch.autograd.grad((want["image"] * weight).sum() + 0.1 * want["depth"].sum(),
                                list(p.values()))
    _compare_frames(out, want)
    depth = want["depth"].detach().numpy()
    np.testing.assert_allclose(out.depth.detach().numpy(), depth, rtol=0,
                               atol=1e-4 * depth.max())
    _compare_grads(got, grads)


def _projections(scene, alive, cam, cam_params, tile=TILE):
    got, comp = ut_project(*(torch.from_numpy(scene[k]) for k in KEYS[:4]),
                           torch.from_numpy(alive), torch.as_tensor(cam["w2c"]), cam["fx"],
                           cam["fy"], cam["cx"], cam["cy"], cam_params, W, H, tile,
                           cam["max_angle"])
    return got, comp, ref.ut_project(_ref_params(scene), torch.from_numpy(alive), cam, tile)


def compare_projections(got, comp, want, n_min=30):
    """`ut_project`'s fields against the reference's, at `test_torch_gut_cameras.py`'s
    tolerances."""
    both = (got.visible & want["visible"]).numpy()
    assert both.sum() > n_min
    assert int((got.visible != want["visible"]).sum()) <= 3
    tol = dict(rtol=1e-4, atol=1e-3)
    for name in ("mean2d", "conic", "opacity", "depth"):
        np.testing.assert_allclose(getattr(got, name).numpy()[both], want[name].numpy()[both],
                                   err_msg=name, **tol)
    np.testing.assert_allclose(comp.numpy()[both], want["comp"].numpy()[both], **tol)
    rect = torch.cat([got.tile_min, got.tile_max], 1).long()
    assert int(((rect != want["rect"]).any(1).numpy() & both).sum()) <= 3


@pytest.mark.parametrize("seed", [0, 2])
def test_ut_project_matches_reference(seed):
    scene, alive = rotated_scene(seed=seed)
    cam = ref.camera(_w2c(-0.05), F, F, W / 2, H / 2, W, H, coeffs=K1)
    compare_projections(*_projections(scene, alive, cam, CameraParams(radial=tuple(K1[:6]))))


def _state(scene, alive, seed):
    """The port's TrainState at iteration 7100 with warm Adam moments, and the same as
    reference dicts."""
    g = np.random.default_rng(seed)
    m = {k: (1e-3 * g.normal(0, 1, v.shape)).astype(np.float32) for k, v in scene.items()}
    v = {k: (1e-6 * (0.5 + g.random(v.shape))).astype(np.float32) for k, v in scene.items()}
    counts = {k: 7099 for k in scene}
    ts = convert.train_state_from_numpy(scene, alive, m, v, counts, 7100, max_sh_degree=3,
                                        scene_scale=2.0, device="cpu")
    t = lambda d: {k: torch.from_numpy(x) for k, x in d.items()}  # noqa: E731
    return ts, t(m), t(v), counts


@pytest.mark.parametrize("segred_impl", ["segsum", "prefix"])
def test_gut_train_step_matches_reference(segred_impl):
    scene, alive = rotated_scene(seed=3)
    ts, m, v, counts = _state(scene, alive, 3)
    w2c = _w2c(0.08)
    cam = ref.camera(w2c, F, F, W / 2, H / 2, W, H, coeffs=K1)
    target = np.random.default_rng(4).random((3, H, W)).astype(np.float32)
    cfg = ts_mod.StepConfig(gut=True, cam_params=CameraParams(radial=tuple(K1[:6])))
    plan = ts_mod.RasterPlan(max_instances=1 << 14, k_max=512, tile_size=TILE)
    noise = torch.zeros((len(alive), 3))  # no MCMC noise: the state is Adam's alone
    with recorded_grads() as calls:
        ts2, stats = ts_mod.train_step(ts, target, w2c, cam["position"], F, F, W / 2, H / 2,
                                       BG, width=W, height=H, plan=plan, opt=cfg,
                                       total_iterations=30000, noise=noise,
                                       segred_impl=segred_impl)
    lrs = {"means": cfg.means_lr * 2.0, "sh0": cfg.shs_lr, "shN": cfg.shs_lr / 20,
           "scaling_raw": cfg.scaling_lr, "rotation_raw": cfg.rotation_lr,
           "opacity_raw": cfg.opacity_lr}
    want = ref.train_step(_ref_params(scene), torch.from_numpy(alive), m, v, counts, [cam],
                          [torch.from_numpy(target)], 7100, 30000, lrs, 3, BG)
    np.testing.assert_allclose(float(stats.loss), float(want["loss"]), rtol=1e-5)
    took = dict(zip(ts.splat.params(), calls[0]))  # the step's grad call, in its order
    _compare_grads([took[k] for k in KEYS], [want["grads"][k] for k in KEYS])
    for k in KEYS:
        lr = lrs[k] * (0.01 ** (7099 / 30000) if k == "means" else 1.0)
        got, exp = getattr(ts2.splat, k).numpy(), want["params"][k].numpy()
        gap = np.abs(got - exp) - 2 * np.spacing(np.abs(exp))
        assert float(gap.max()) <= 1e-3 * lr, (k, float(gap.max()), lr)
        for field in ("exp_avg", "exp_avg_sq"):
            got, exp = getattr(ts2.adam, field)[k].numpy(), want[field][k].numpy()
            np.testing.assert_allclose(got, exp, rtol=1e-3, atol=1e-6 * np.abs(exp).max(),
                                       err_msg=f"{field} {k}")
        assert ts2.adam.step_count[k] == want["counts"][k] == 7100
        assert float((getattr(ts2.splat, k) - ts.splat.params()[k]).abs().max()) > 0, k
    assert ts2.iteration == 7101


def _ortho_covariance(scene, w2c, fx, fy):
    """J W R diag(s^2) R^T W^T J^T + 0.3 I in float64, J = diag(fx, fy) on the camera's
    x and y: the exact image covariance of each Gaussian under the orthographic camera."""
    q = torch.from_numpy(scene["rotation_raw"]).double()
    r = ref.rotmat(q)
    s2 = torch.exp(2 * torch.from_numpy(scene["scaling_raw"]).double())
    cov3 = r @ torch.diag_embed(s2) @ r.transpose(1, 2)
    j = torch.tensor([[fx, 0, 0], [0, fy, 0]], dtype=torch.float64) \
        @ torch.from_numpy(w2c[:3, :3]).double()
    return j @ cov3 @ j.T + ref.EPS2D * torch.eye(2, dtype=torch.float64)


def _conic_inverse(conic):
    a, b, c = conic.double().unbind(-1)
    det = a * c - b * b
    return torch.stack([c / det, -b / det, -b / det, a / det], -1).reshape(-1, 2, 2)


@pytest.mark.parametrize("path", ["single", "mesh"])
def test_ut_conic_under_ortho_is_the_rotated_covariance(path):
    """The ortho camera is linear, so the seven points carry the covariance exactly: the
    conic inverts to J W R diag(s^2) R^T W^T J^T + 0.3 I for every visible Gaussian. The
    mesh path calls `raster_mc.ut_project` and carries the projection through
    `compact_visible` and `unpack_projection` (its batched render takes no ortho camera,
    so the projection is checked through its own transport)."""
    scene, alive = rotated_scene(seed=5)
    w2c, fx, fy = _w2c(0.3), 9.0, 9.5
    args = [torch.from_numpy(scene[k]) for k in KEYS[:4]]
    cp = CameraParams(model="ortho")
    proj, comp = raster_mc.ut_project(*args, torch.from_numpy(alive), torch.from_numpy(w2c),
                                      fx, fy, W / 2, H / 2, cp, W, H, TILE, None)
    want = _ortho_covariance(scene, w2c, fx, fy)
    rows = torch.nonzero(proj.visible)[:, 0]
    conic = proj.conic
    if path == "mesh":
        feats = gut_feature_table(*args, *(torch.from_numpy(scene[k]) for k in KEYS[4:]),
                                  torch.zeros(3), 3, proj, comp)[:raster_mc.N_GUT].T
        table, n_vis = raster_mc.compact_visible(proj, feats, len(alive) - 1)
        got_proj, _ = raster_mc.unpack_projection(table, True)
        assert int(n_vis) == len(rows) and bool(got_proj.visible[:len(rows)].all())
        conic = torch.zeros_like(proj.conic).index_copy(0, rows, got_proj.conic[:len(rows)])
    assert len(rows) > 100
    got = _conic_inverse(conic[rows])
    exp = want[rows]
    scale = exp.abs().amax(dim=(1, 2), keepdim=True)
    np.testing.assert_array_less(((got - exp).abs() / (1e-4 * exp.abs() + 1e-4 * scale))
                                 .numpy(), 1.0)
    # the rotations matter here: diag(s^2) alone would be far off
    j = torch.tensor([[fx, 0, 0], [0, fy, 0]], dtype=torch.float64) \
        @ torch.from_numpy(w2c[:3, :3]).double()
    s2 = torch.exp(2 * torch.from_numpy(scene["scaling_raw"]).double())[rows]
    unrotated = j @ torch.diag_embed(s2) @ j.T + ref.EPS2D * torch.eye(2, dtype=torch.float64)
    assert float(((unrotated - exp).abs() / scale).amax()) > 0.1


def test_the_unrotated_sigma_rows_fail_here(monkeypatch):
    """The reference given the sigma rows as first ported (S R[:, i]) is held to itself
    with the right rows: the image and the rects move far beyond this file's
    tolerances, so the comparisons above separate the two rules."""
    scene, alive = rotated_scene(seed=0)
    cam = ref.camera(_w2c(0.05), F, F, W / 2, H / 2, W, H, coeffs=K1)
    p, live = _ref_params(scene), torch.from_numpy(alive)
    with torch.no_grad():
        right = ref.render(p, live, cam, 3, BG)
        monkeypatch.setattr(ref, "sigma_offsets",
                            lambda scale, rot: scale[:, None, :] * rot.transpose(1, 2))
        wrong = ref.render(p, live, cam, 3, BG)
    assert float((right["image"] - wrong["image"]).abs().max()) > 100 * 1e-4
    both = right["ut"]["visible"] & wrong["ut"]["visible"]
    assert int((right["ut"]["rect"] != wrong["ut"]["rect"]).any(1)[both].sum()) > 3
    gap = (right["ut"]["conic"] - wrong["ut"]["conic"]).abs() / (
        1e-3 + 1e-4 * right["ut"]["conic"].abs())
    assert float(gap[both].max()) > 100

