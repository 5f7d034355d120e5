"""The GUT projection layer's dispatch on the CPU (no JAX): `ops/gut.py::ut_project` and
`pixel_world_rays` run their plain chains on CPU tensors, by default and under
`impl="plain"`, bit for bit the same, and launch no kernel; a rolling shutter keeps its
chain. The kernels' launch arguments (`ops/cuda/gut_project.py::camera_args`) carry the
float32 values the chains compute with, and read distortion coefficients bound to a view
from `bind_coeffs`' own tensor. The kernels themselves are held to the chains on the card
(`tests/test_torch_cuda.py`).

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gut_project.py
"""

import ctypes

import numpy as np
import pytest
import torch

from tpu_splat_torch.ops import gut
from tpu_splat_torch.ops.cameras import CameraParams, bind_coeffs, fisheye_max_angle
from tpu_splat_torch.ops.cuda import build
from tpu_splat_torch.ops.cuda.gut_project import (camera_args, pixel_world_rays_kernel,
                                                  ut_project_kernel)

PINHOLE = CameraParams(radial=(0.05, -0.01, 0.002, 0.01, -0.002, 0.0005),
                       tangential=(0.001, -0.0015), thin_prism=(0.0008, -0.0003, 0.0005, 0.0002))
CAMERAS = {
    "pinhole": (PINHOLE, None),
    "bound": (bind_coeffs(PINHOLE, PINHOLE.coeff_vector()), None),
    "fisheye": (CameraParams(model="fisheye", radial=(0.05, -0.01, 0.002, -0.0005, 0, 0)), 1.9),
    "ortho": (CameraParams(model="ortho"), None),
    "rolling": (CameraParams(radial=(0.05, 0, 0, 0, 0, 0), shutter="top_to_bottom"), None),
}
W, H = 40, 30


def _scene(n=300, seed=0):
    gen = torch.Generator().manual_seed(seed)
    means = torch.rand((n, 3), generator=gen) * 2 - 1
    means[:, 2] = means[:, 2] * 2 + 4
    means[: n // 10, 2] *= -1
    return (means, torch.log(torch.rand((n, 3), generator=gen) * 0.2 + 0.01),
            torch.randn((n, 4), generator=gen), torch.randn((n, 1), generator=gen),
            torch.rand((n,), generator=gen) > 0.1)


def _pose(shutter):
    if shutter == "global":
        return None
    q_end = torch.tensor([1.0, 0.002, -0.003, 0.001])
    return (torch.tensor([1.0, 0, 0, 0]), torch.zeros(3), q_end / q_end.norm(),
            torch.tensor([0.05, -0.02, 0.0]))


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("name", list(CAMERAS))
@pytest.mark.parametrize("tile", [16, 8])
def test_cpu_runs_the_plain_chains_bit_for_bit(name, tile):
    params, max_angle = CAMERAS[name]
    pose = _pose(params.shutter)
    w2c = torch.eye(4)
    w2c[:3, 3] = torch.tensor([0.1, -0.05, 0.2])
    cam = (w2c, 30.0, 33.0, W / 2 + 1.0, H / 2 - 1.0, params, W, H, tile, max_angle)
    launches = ut_project_kernel.launches, pixel_world_rays_kernel.launches
    runs = [gut.ut_project(*_scene(), *cam, shutter_pose=pose),
            gut.ut_project(*_scene(), *cam, shutter_pose=pose, impl="plain"),
            gut.ut_project_plain(*_scene(), *cam, shutter_pose=pose)]
    for proj, comp in runs[1:]:
        assert _same(runs[0][0], proj) and torch.equal(runs[0][1], comp)
    assert int(runs[0][0].visible.sum()) > 10
    gw, gh = -(-W // tile), -(-H // tile)
    kw = dict(grid_w=gw, grid_h=gh - 1, tile_size=tile, width=W, height=H, tile_y0=1)
    args = (w2c, torch.tensor([0.0, 0.1, -0.2]), 30.0, 33.0, W / 2 + 1.0, H / 2 - 1.0, params,
            max_angle, pose)
    rays = [gut.pixel_world_rays(*args, **kw), gut.pixel_world_rays(*args, **kw, impl="plain"),
            gut.pixel_world_rays_plain(*args, **kw)]
    assert all(torch.equal(rays[0], r) for r in rays[1:])
    assert rays[0].shape[:2] == (gw * (gh - 1), tile * tile)
    assert (ut_project_kernel.launches, pixel_world_rays_kernel.launches) == launches


def test_impl_is_checked():
    cam = (torch.eye(4), 30.0, 30.0, 20.0, 15.0, PINHOLE, W, H, 16, None)
    with pytest.raises(ValueError, match="impl"):
        gut.ut_project(*_scene(), *cam, impl="fused")
    with pytest.raises(ValueError, match="impl"):
        gut.pixel_world_rays(torch.eye(4), torch.zeros(3), 30.0, 30.0, 20.0, 15.0, PINHOLE,
                             None, None, grid_w=3, grid_h=2, tile_size=16, width=W, height=H,
                             impl="fused")


def test_camera_args_carry_the_chains_float32_scalars():
    cam, dist, angle = camera_args(1000.1, 999.9, 648.3, 420.7, CameraParams(
        model="fisheye", radial=(0.1, 0.2, 0.3, 0.4, 0, 0)), 1296, 840, 16, 1.7, "cpu")
    assert dist is None and angle is None and cam.model == 1
    f32 = lambda v: float(np.float32(v))
    assert (cam.fx, cam.fy, cam.cx, cam.cy) == (f32(1000.1), f32(999.9), f32(648.3), f32(420.7))
    assert cam.rfx == float(np.float32(1) / np.float32(1000.1))
    assert (cam.lo_x, cam.hi_x, cam.lo_y, cam.hi_y) == (f32(-0.15 * 1296), f32(1296 + 0.15 * 1296),
                                                        f32(-0.15 * 840), f32(840 + 0.15 * 840))
    # the fisheye derivative's 3 k1, 5 k2, 7 k3 are Python floats rounded once, as the chain
    # adds them to a float32 tensor
    assert list(cam.dk) == [f32(3 * 0.1), f32(5 * 0.2), f32(7 * 0.3)]
    assert list(cam.coef)[:4] == [f32(0.1), f32(0.2), f32(0.3), f32(0.4)]
    assert cam.max_angle == f32(1.7) and ctypes.sizeof(cam) == 30 * 4
    with pytest.raises(ValueError, match="camera model"):
        camera_args(1.0, 1.0, 0.0, 0.0, CameraParams(model="equirect"), 8, 8, 16, None, "cpu")


def test_bound_coefficients_are_read_from_their_own_tensor():
    coeffs = torch.arange(12, dtype=torch.float32)
    _, dist, _ = camera_args(1.0, 1.0, 0.0, 0.0, bind_coeffs(PINHOLE, coeffs), 8, 8, 16, None,
                             torch.device("cpu"))
    assert dist.data_ptr() == coeffs.data_ptr()


def test_a_fisheye_without_max_angle_takes_the_chains_default():
    params = CameraParams(model="fisheye", radial=(0.05, -0.01, 0.002, -0.0005, 0, 0))
    cam, _, angle = camera_args(1.0, 1.0, 0.0, 0.0, params, 8, 8, 16, None, "cpu")
    assert angle is None and cam.max_angle == float(np.float32(fisheye_max_angle(params)))
    bound = bind_coeffs(params, params.coeff_vector())
    cam, _, angle = camera_args(1.0, 1.0, 0.0, 0.0, bound, 8, 8, 16, None, torch.device("cpu"))
    assert cam.max_angle == float(np.float32(fisheye_max_angle(params)))


def test_the_ray_kernel_is_built_from_the_projection_source():
    assert build.source_name("gut_rays") == build.source_name("gut_project") == "gut_project"
    assert build.library_path("gut_rays") == build.library_path("gut_project")
    assert build.source_name("gut_fwd") == "gut_fwd"
