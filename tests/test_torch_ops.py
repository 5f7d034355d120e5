"""The PyTorch port's per-Gaussian ops, state and I/O against the JAX package, on the CPU.

Inputs are made with numpy from a seed (tests/utils.py) and fed to both sides.
Tolerances: float fields rtol/atol 1e-5 (float32 rounding of the same formulas in a
different operation order); integer and boolean fields exactly.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_splat.core.splat import init_from_pointcloud as jax_init_from_pointcloud
from tpu_splat.core.splat import mean_neighbor_distances as jax_mean_neighbor_distances
from tpu_splat.io.ply import save_splat_ply as jax_save_splat_ply
from tpu_splat.ops.projection import project as jax_project
from tpu_splat.ops.projection import will_contribute as jax_will_contribute
from tpu_splat.ops.quat import quat_to_rotmat as jax_quat_to_rotmat
from tpu_splat.ops.sh import sh_to_color as jax_sh_to_color
from tpu_splat_torch.convert import splat_from_numpy, splat_to_numpy
from tpu_splat_torch.core.splat import PARAM_FIELDS, init_from_pointcloud, mean_neighbor_distances
from tpu_splat_torch.io.image import save_image
from tpu_splat_torch.io.ply import load_splat_ply
from tpu_splat_torch.ops.projection import project, will_contribute
from tpu_splat_torch.ops.quat import quat_to_rotmat
from tpu_splat_torch.ops.sh import sh_to_color

from utils import make_camera, make_scene

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _project_both(scene, cam, sh_degree, tile_size):
    keys = ("means", "scaling_raw", "rotation_raw", "opacity_raw", "sh0", "shN", "alive")
    cam_args = (cam["w2c"], cam["cam_position"], cam["fx"], cam["fy"], cam["cx"], cam["cy"],
                cam["width"], cam["height"], sh_degree)
    pj = jax_project(*(jnp.asarray(scene[k]) for k in keys), *cam_args, tile_size=tile_size)
    cam_t = (_t(cam["w2c"]), _t(cam["cam_position"])) + cam_args[2:]
    pt = project(*(_t(scene[k]) for k in keys), *cam_t, tile_size=tile_size)
    return pj, pt


@pytest.mark.parametrize("n,seed,sh_degree,tile_size", [(300, 0, 3, 16), (500, 1, 1, 32)])
def test_project_matches_jax(n, seed, sh_degree, tile_size):
    scene = make_scene(n, seed)
    scene["alive"][::7] = False
    cam = make_camera(64, 48)
    pj, pt = _project_both(scene, cam, sh_degree, tile_size)
    assert 0 < int(pt.visible.sum()) < n
    for name in pj._fields:
        a, b = np.asarray(getattr(pj, name)), getattr(pt, name).numpy()
        assert a.shape == b.shape, name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, err_msg=name, **TOL)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


def test_will_contribute_matches_jax():
    rng = np.random.default_rng(5)
    m = 4000
    mean2d = rng.uniform(-20, 84, (m, 2)).astype(np.float32)
    s = rng.uniform(0.5, 6.0, m)
    ca, cc = 1 / s**2, 1 / (s**2 * rng.uniform(0.5, 2.0, m))
    conic = np.stack([ca, rng.uniform(-0.4, 0.4, m) * np.sqrt(ca * cc), cc], 1).astype(np.float32)
    tx = rng.integers(0, 4, m).astype(np.int32)
    ty = rng.integers(0, 3, m).astype(np.int32)
    pth = np.log(rng.uniform(1.0, 255.0, m)).astype(np.float32)
    want = np.asarray(jax_will_contribute(mean2d, conic, tx, ty, pth, 16))
    got = will_contribute(_t(mean2d), _t(conic), _t(tx), _t(ty), _t(pth), 16).numpy()
    assert 0 < want.sum() < m
    np.testing.assert_array_equal(got, want)


def test_quat_to_rotmat_matches_jax():
    q = np.random.default_rng(2).normal(0, 1, (256, 4)).astype(np.float32)
    np.testing.assert_allclose(quat_to_rotmat(_t(q)).numpy(),
                               np.asarray(jax_quat_to_rotmat(q)), **TOL)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_to_color_matches_jax(degree):
    rng = np.random.default_rng(degree)
    sh0 = rng.normal(0, 0.7, (200, 1, 3)).astype(np.float32)
    shN = rng.normal(0, 0.2, (200, 15, 3)).astype(np.float32)
    dirs = rng.normal(0, 1, (200, 3)).astype(np.float32)
    dirs[0] = 0.0  # degenerate direction stays finite
    got = sh_to_color(_t(sh0), _t(shN), _t(dirs), degree).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_sh_to_color(sh0, shN, dirs, degree)), **TOL)
    assert np.isfinite(got).all()


def test_init_from_pointcloud_matches_jax():
    rng = np.random.default_rng(4)
    pts = rng.normal(0, 1, (300, 3)).astype(np.float32)
    pts[1] = pts[0]  # coincident points are excluded from the neighbour mean
    cols = rng.random((300, 3)).astype(np.float32)
    center = pts.mean(0)
    np.testing.assert_allclose(mean_neighbor_distances(pts, chunk=128).numpy(),
                               jax_mean_neighbor_distances(pts, chunk=128), **TOL)
    want = jax_init_from_pointcloud(pts, cols, center, capacity=320, sh_degree=2)
    got = init_from_pointcloud(pts, cols, center, capacity=320, sh_degree=2)
    for k in PARAM_FIELDS + ("alive",):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   err_msg=k, **TOL)
    assert (got.max_sh_degree, got.scene_scale) == (want.max_sh_degree, want.scene_scale)


def test_splat_from_numpy_round_trip():
    scene = make_scene(64, 3)
    params = {k: scene[k] for k in PARAM_FIELDS}
    state = splat_from_numpy(params, scene["alive"], 3, "cpu")
    assert state.capacity == 64 and state.device.type == "cpu"
    back, alive, degree = splat_to_numpy(state)
    assert degree == 3
    np.testing.assert_array_equal(alive, scene["alive"])
    for k in PARAM_FIELDS:
        np.testing.assert_array_equal(back[k], params[k])


def test_ply_written_by_jax_loads_in_port(tmp_path):
    scene = make_scene(50, 8)
    path = tmp_path / "m.ply"
    jax_save_splat_ply(path, scene["means"], scene["sh0"], scene["shN"],
                       scene["scaling_raw"], scene["rotation_raw"], scene["opacity_raw"])
    got = load_splat_ply(path)
    q = scene["rotation_raw"] / np.linalg.norm(scene["rotation_raw"], axis=-1, keepdims=True)
    want = dict(scene, rotation_raw=q)
    for k in PARAM_FIELDS:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_png_writer_matches_pil_rounding(tmp_path):
    from PIL import Image

    img = np.random.default_rng(6).uniform(-0.2, 1.2, (3, 17, 23)).astype(np.float32)
    save_image(str(tmp_path / "a.png"), img)
    with Image.open(tmp_path / "a.png") as im:
        assert im.mode == "RGB" and im.size == (23, 17)
        got = np.asarray(im)
    want = (np.clip(img, 0, 1).transpose(1, 2, 0) * 255.0 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(got, want)


def test_port_imports_no_jax():
    code = (
        "import sys, tpu_splat_torch, tpu_splat_torch.cli, tpu_splat_torch.render\n"
        "import tpu_splat_torch.convert, tpu_splat_torch.ops.ssim\n"
        "import tpu_splat_torch.ops.cuda.blend, tpu_splat_torch.ops.cuda.raster\n"
        "import tpu_splat_torch.ops.cameras, tpu_splat_torch.ops.gut\n"
        "import tpu_splat_torch.ops.cuda.gut_kernels, tpu_splat_torch.ops.cuda.build\n"
        "from tpu_splat_torch.training import losses, optim, strategy_mcmc, train_step\n"
        "from tpu_splat_torch.training import dataset, metrics, trainer\n"
        "from tpu_splat_torch.training import bilateral_grid, checkpoint, lpips, poseopt\n"
        "from tpu_splat_torch.training import sparsity, strategy_default\n"
        "from tpu_splat_torch.io import colmap, image, loader, nvjpeg, ply, transforms\n"
        "from tpu_splat_torch.io import sog, webp\n"
        "from tpu_splat_torch.core import camera, config, geometry, project\n"
        "import tpu_splat_torch.viewer\n"
        "from tpu_splat_torch.utils import async_io, events\n"
        "from tpu_splat_torch.parallel import distributed, dryrun, mesh, raster_mc, step\n"
        "import chip_smoke, profile_render, ab_blend_kernels, ab_gut_kernels\n"
        "import ab_segred_kernels\n"
        "from tpu_splat_torch.tools import eval_mipnerf360, eval_raytraced, synth_capture\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'tpu_splat', 'PIL', 'synth_data',\n"
        "                                    'torch_fixtures', 'conftest'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True,
                   timeout=120)
