"""The PyTorch port's GUT camera models and UT projection against the JAX package, on the
CPU. Inputs are made with numpy from a seed and fed to both sides.

Tolerances, each with its reason:
  camera functions: points and rays rtol/atol 1e-5 (the same float32 formulas, another
    operation order inside norms, trigonometric functions and divisions; image points are
    compared only where both sides call the point valid, since an invalid point may sit
    on a pole of the distortion model); validity masks equal;
  rolling-shutter projection: atol 1e-3 px (ten fixed-point iterations of floor/ceil
    readout times amplify rounding, and a point whose readout row flips moves by the
    camera's motion over one row);
  `fisheye_max_angle`: the static search is the same float64 numpy code (equal); with
    tensor coefficients both sides search a 4096-point float32 grid (atol one grid step);
  `ut_project` float fields rtol 1e-4 plus atol 1e-3 (seven sigma points through a
    polynomial; the UT mean weighs the centre point by -99 and the six others by 16.7, so
    float32 rounding of ~50 px image points is amplified a hundredfold, to ~5e-4 px, and
    the covariance's terms cancel likewise); tile bounds, `n_tiles` and `visible`
    equal except for Gaussians whose rounded radius or tile edge sits on an integer
    within rounding: those are counted and bounded at 1% of the Gaussians.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_splat.ops import cameras as jc
from tpu_splat.ops.gut import ut_project as jax_ut_project
from tpu_splat_torch.convert import camera_params_from_numpy
from tpu_splat_torch.ops import cameras as tc
from tpu_splat_torch.ops.gut import ut_project

from utils import make_scene

W, H, F = 64, 48, 55.0
TOL = dict(rtol=1e-5, atol=1e-5)
INTR = (F, F * 1.05, W / 2 + 0.3, H / 2 - 0.2)

PINHOLE = np.asarray([0.1, -0.05, 0.001, 0.01, -0.002, 0.0005, 0.001, -0.002,
                      0.0008, -0.0003, 0.0005, 0.0002], np.float32)
FISHEYE = np.asarray([0.05, -0.01, 0.002, -0.0004, 0, 0, 0, 0, 0, 0, 0, 0], np.float32)
STRONG_FISHEYE = np.asarray([-0.3, -0.05, 0.0, 0.0, 0, 0, 0, 0, 0, 0, 0, 0], np.float32)


def _params(model, coeffs, shutter="global"):
    """The same camera on both sides, from one numpy coefficient vector."""
    c = [float(v) for v in coeffs]
    pj = jc.CameraParams(model=model, radial=tuple(c[:6]), tangential=tuple(c[6:8]),
                         thin_prism=tuple(c[8:12]), shutter=shutter)
    pt = camera_params_from_numpy(model, shutter, coeffs)
    np.testing.assert_array_equal(pt.coeff_vector(), pj.coeff_vector())
    return pj, pt


def _cam_points(n=400, seed=0):
    rng = np.random.default_rng(seed)
    z = rng.uniform(-1, 8, n).astype(np.float32)  # some behind the camera
    x = rng.uniform(-0.7, 0.7, n).astype(np.float32) * np.abs(z)
    y = rng.uniform(-0.7, 0.7, n).astype(np.float32) * np.abs(z)
    return np.stack([x, y, z], 1)


def _pixels():
    ys, xs = np.mgrid[0:H, 0:W]
    return (np.stack([xs, ys], -1).reshape(-1, 2) + 0.5).astype(np.float32)


def _pose(rng, tilt):
    q = np.asarray([1.0, *(tilt * rng.normal(0, 1, 3))], np.float32)
    return q / np.linalg.norm(q), rng.normal(0, 0.1, 3).astype(np.float32)


@pytest.mark.parametrize("model,coeffs", [("pinhole", PINHOLE), ("fisheye", FISHEYE),
                                          ("ortho", np.zeros(12, np.float32))])
def test_project_points_and_pixel_rays_match_jax(model, coeffs):
    pj, pt = _params(model, coeffs)
    pts = _cam_points()
    intr = (8.0, 8.0, W / 2, H / 2) if model == "ortho" else INTR
    img_j, valid_j = jax.jit(lambda p: jc.project_points(p, *intr, pj, W, H))(pts)
    img_t, valid_t = tc.project_points(torch.from_numpy(pts), *intr, pt, W, H)
    valid = np.asarray(valid_j)
    np.testing.assert_array_equal(valid_t.numpy(), valid)
    assert 20 < valid.sum() < len(pts)
    np.testing.assert_allclose(img_t.numpy()[valid], np.asarray(img_j)[valid], **TOL)

    pix = _pixels()
    rays_j = jax.jit(lambda p: jc.pixel_rays(p, *intr, pj))(pix)
    rays_t = tc.pixel_rays(torch.from_numpy(pix), *intr, pt)
    np.testing.assert_allclose(rays_t.numpy(), np.asarray(rays_j), **TOL)
    if model == "ortho":
        org_t = tc.ortho_ray_origins(torch.from_numpy(pix), *intr)
        np.testing.assert_allclose(org_t.numpy(),
                                   np.asarray(jc.ortho_ray_origins(jnp.asarray(pix), *intr)),
                                   **TOL)
    else:  # the rays invert the projection
        back, ok = tc.project_points(rays_t * 3.0, *intr, pt, W, H)
        assert float((back - torch.from_numpy(pix))[ok].abs().max()) < 2e-3


def test_pinhole_and_fisheye_with_tensor_coefficients_match_jax():
    """`bind_coeffs`: the coefficients as device values give the static result."""
    pts, pix = _cam_points(seed=2), _pixels()
    for model, coeffs in (("pinhole", PINHOLE), ("fisheye", FISHEYE)):
        pj, pt = _params(model, np.zeros(12, np.float32))
        bj = jc.bind_coeffs(pj, jnp.asarray(coeffs))
        bt = tc.bind_coeffs(pt, torch.from_numpy(coeffs))
        assert isinstance(bt, tc.BoundCameraParams) and tc.bind_coeffs(pt) is pt
        img_j, valid_j = jc.project_points(jnp.asarray(pts), *INTR, bj, W, H)
        img_t, valid_t = tc.project_points(torch.from_numpy(pts), *INTR, bt, W, H)
        valid = np.asarray(valid_j)
        np.testing.assert_array_equal(valid_t.numpy(), valid)
        np.testing.assert_allclose(img_t.numpy()[valid], np.asarray(img_j)[valid], **TOL)
        rays_j = jax.jit(lambda p: jc.pixel_rays(p, *INTR, bj))(pix)
        np.testing.assert_allclose(tc.pixel_rays(torch.from_numpy(pix), *INTR, bt).numpy(),
                                   np.asarray(rays_j), **TOL)
        # ... and equals the port's own static-coefficient result
        _, pt_static = _params(model, coeffs)
        np.testing.assert_allclose(tc.pixel_rays(torch.from_numpy(pix), *INTR, bt).numpy(),
                                   tc.pixel_rays(torch.from_numpy(pix), *INTR, pt_static).numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_fisheye_max_angle_matches_jax():
    for coeffs in (FISHEYE, STRONG_FISHEYE):
        pj, pt = _params("fisheye", coeffs)
        want = jc.fisheye_max_angle(pj)
        assert tc.fisheye_max_angle(pt) == want  # the same float64 host search
        bj = jc.bind_coeffs(pj, jnp.asarray(coeffs))
        bt = tc.bind_coeffs(pt, torch.from_numpy(coeffs))
        got = tc.fisheye_max_angle(bt)
        assert isinstance(got, torch.Tensor) and got.shape == ()
        step = np.pi / 4095
        np.testing.assert_allclose(float(got), float(jc.fisheye_max_angle(bj)), atol=step)
        np.testing.assert_allclose(float(got), want, atol=step)
    mild = np.asarray([0.05, 0.01] + [0] * 10, np.float32)  # monotone: omnidirectional
    assert tc.fisheye_max_angle(_params("fisheye", mild)[1]) == float(np.pi)
    assert float(tc.fisheye_max_angle(tc.bind_coeffs(tc.CameraParams("fisheye"),
                                                     torch.from_numpy(mild)))) == np.float32(np.pi)
    assert tc.fisheye_max_angle(_params("fisheye", STRONG_FISHEYE)[1]) < 1.2
    # a capped angle reaches projection and rays: points beyond it are invalid
    pj, pt = _params("fisheye", STRONG_FISHEYE)
    pts = _cam_points(seed=3)
    _, valid_j = jc.project_points(jnp.asarray(pts), *INTR, pj, W, H)
    _, valid_t = tc.project_points(torch.from_numpy(pts), *INTR, pt, W, H)
    np.testing.assert_array_equal(valid_t.numpy(), np.asarray(valid_j))
    rays_j = jax.jit(lambda p: jc.pixel_rays(p, *INTR, pj))(_pixels())
    np.testing.assert_allclose(tc.pixel_rays(torch.from_numpy(_pixels()), *INTR, pt).numpy(),
                               np.asarray(rays_j), **TOL)


@pytest.mark.parametrize("shutter", ["top_to_bottom", "right_to_left"])
def test_rolling_shutter_functions_match_jax(shutter):
    rng = np.random.default_rng(4)
    pj, pt = _params("pinhole", PINHOLE, shutter)
    (q0, t0), (q1, t1) = _pose(rng, 0.0), _pose(rng, 0.03)
    t0 = t0 * 0  # start at the identity pose
    pose_j = tuple(jnp.asarray(x) for x in (q0, t0, q1, t1))
    pose_t = tuple(torch.from_numpy(x) for x in (q0, t0, q1, t1))
    pts = _cam_points(seed=5)
    img_j, valid_j = jax.jit(lambda p: jc.project_points_shutter(
        p, *pose_j, *INTR, pj, W, H, shutter))(pts)
    img_t, valid_t = tc.project_points_shutter(torch.from_numpy(pts), *pose_t, *INTR, pt, W, H,
                                               shutter)
    valid = np.asarray(valid_j)
    np.testing.assert_array_equal(valid_t.numpy(), valid)
    assert valid.sum() > 20
    np.testing.assert_allclose(img_t.numpy()[valid], np.asarray(img_j)[valid], rtol=0,
                               atol=1e-3)

    pix = _pixels().reshape(H, W, 2)
    o_j, d_j = jax.jit(lambda p: jc.pixel_world_rays_shutter(
        p, *pose_j, *INTR, pj, W, H, shutter))(pix)
    o_t, d_t = tc.pixel_world_rays_shutter(torch.from_numpy(pix), *pose_t, *INTR, pt, W, H,
                                           shutter)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), **TOL)
    assert float(o_t.std(dim=(0, 1)).max()) > 1e-3  # origins do vary over the readout

    # the building blocks, on random inputs
    qa = rng.normal(0, 1, (50, 4)).astype(np.float32)
    qb = rng.normal(0, 1, (50, 4)).astype(np.float32)
    qa /= np.linalg.norm(qa, axis=1, keepdims=True)
    qb /= np.linalg.norm(qb, axis=1, keepdims=True)
    qb[:5] = qa[:5]  # the small-angle branch
    t = rng.random((50, 1)).astype(np.float32)
    np.testing.assert_allclose(
        tc.quat_slerp(torch.from_numpy(qa), torch.from_numpy(qb), torch.from_numpy(t)).numpy(),
        np.asarray(jc.quat_slerp(jnp.asarray(qa), jnp.asarray(qb), jnp.asarray(t))), **TOL)
    vec = rng.normal(0, 1, (50, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tc.quat_rotate(torch.from_numpy(qa), torch.from_numpy(vec)).numpy(),
        np.asarray(jc.quat_rotate(jnp.asarray(qa), jnp.asarray(vec))), **TOL)
    for sh in tc.SHUTTER_TYPES:
        np.testing.assert_allclose(
            tc.shutter_relative_time(torch.from_numpy(pix), sh, W, H).numpy(),
            np.asarray(jc.shutter_relative_time(jnp.asarray(pix), sh, W, H)), **TOL)
    assert tc.SHUTTER_TYPES == jc.SHUTTER_TYPES


UT_CASES = {
    "pinhole": ("pinhole", PINHOLE, "global", (F, F, W / 2, H / 2)),
    "fisheye": ("fisheye", FISHEYE, "global", (F, F, W / 2, H / 2)),
    "ortho": ("ortho", np.zeros(12, np.float32), "global", (8.0, 8.0, W / 2, H / 2)),
    "rolling": ("pinhole", PINHOLE, "left_to_right", (F, F, W / 2, H / 2)),
}


@pytest.mark.parametrize("case", list(UT_CASES))
@pytest.mark.parametrize("tile_size", [16, 32])
def test_ut_project_matches_jax(case, tile_size):
    model, coeffs, shutter, intr = UT_CASES[case]
    pj, pt = _params(model, coeffs, shutter)
    scene = make_scene(300, seed=11)
    scene["alive"][::9] = False
    keys = ("means", "scaling_raw", "rotation_raw", "opacity_raw", "alive")
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, 3] = (0.1, -0.05, 0.2)
    pose_j = pose_t = None
    if shutter != "global":
        rng = np.random.default_rng(6)
        q0 = np.asarray([1.0, 0, 0, 0], np.float32)
        q1, t1 = _pose(rng, 0.02)
        pose = (q0, w2c[:3, 3].copy(), q1, w2c[:3, 3] + t1)
        pose_j = tuple(jnp.asarray(x) for x in pose)
        pose_t = tuple(torch.from_numpy(x) for x in pose)
    max_angle = jc.fisheye_max_angle(pj) if model == "fisheye" else None

    proj_j, comp_j = jax.jit(lambda *a: jax_ut_project(
        *a, jnp.asarray(w2c), *intr, pj, W, H, tile_size, max_angle, shutter_pose=pose_j))(
        *(jnp.asarray(scene[k]) for k in keys))
    proj_t, comp_t = ut_project(*(torch.from_numpy(scene[k]) for k in keys),
                                torch.from_numpy(w2c), *intr, pt, W, H, tile_size, max_angle,
                                shutter_pose=pose_t)
    vis_j, vis_t = np.asarray(proj_j.visible), proj_t.visible.numpy()
    both = vis_j & vis_t
    assert 30 < both.sum() < 300
    assert (vis_j != vis_t).sum() <= 3
    tol = dict(rtol=1e-4, atol=1e-3)
    for name in ("mean2d", "conic", "opacity", "depth"):
        np.testing.assert_allclose(getattr(proj_t, name).numpy()[both],
                                   np.asarray(getattr(proj_j, name))[both], err_msg=name, **tol)
    np.testing.assert_allclose(comp_t.numpy()[both], np.asarray(comp_j)[both], **tol)
    assert bool(torch.isinf(proj_t.power_threshold).all()) and bool((proj_t.color == 0).all())
    differ = np.zeros(300, bool)
    for name in ("tile_min", "tile_max"):
        differ |= (getattr(proj_t, name).numpy() != np.asarray(getattr(proj_j, name))).any(1)
    differ |= proj_t.n_tiles.numpy() != np.asarray(proj_j.n_tiles)
    assert (differ & both).sum() <= 3, int((differ & both).sum())
    assert proj_t.n_tiles.dtype == torch.int32 and proj_t.tile_min.dtype == torch.int32
    assert (proj_t.n_tiles.numpy()[~vis_t] == 0).all()
