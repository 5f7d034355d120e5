"""The pinhole projection's dispatch on the CPU (no JAX): `ops/projection.py::project` runs
its plain chain on CPU tensors, by default and under `impl="plain"`, bit for bit the same
forward and backward, and launches no kernel; the kernels are taken only on a CUDA device,
without a camera gradient, at every SH degree up to 4. The kernels' launch arguments
(`ops/cuda/projection.py::camera_args`) carry the float32 values the chain computes with,
the wrappers check their arguments before any launch, the source's constants are the
chain's, and `ProjectKernel` (the autograd function around the kernels) passes values and
gradients through as the chain does, with stand-ins for the kernels. The kernels themselves
are held to the chain on the card (`tests/test_torch_cuda.py`).

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_projection_kernels.py
"""

import ctypes
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tpu_splat_torch.ops import projection, sh
from tpu_splat_torch.ops.cuda import build
from tpu_splat_torch.ops.cuda.projection import (_cotangent, camera_args,
                                                 project_backward_kernel, project_kernel)
from tpu_splat_torch.ops.sh import sh_bands, sh_to_color

W, H, TILE = 40, 30, 8
FX, FY, CX, CY = 30.0, 33.0, W / 2 + 1.0, H / 2 - 1.0


def _scene(n=300, rest=15, seed=0, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    means = torch.rand((n, 3), generator=gen) * 2 - 1
    means[:, 2] = means[:, 2] * 2 + 4
    means[: n // 10, 2] *= -1
    leaves = (means, torch.log(torch.rand((n, 3), generator=gen) * 0.2 + 0.01),
              torch.randn((n, 4), generator=gen), torch.randn((n, 1), generator=gen),
              torch.randn((n, 1, 3), generator=gen) * 0.5,
              torch.randn((n, rest, 3), generator=gen) * 0.1)
    alive = torch.rand((n,), generator=gen) > 0.1
    return [x.to(dtype) for x in leaves], alive


def _camera(dtype=torch.float32):
    w2c = torch.eye(4, dtype=dtype)
    w2c[:3, 3] = torch.tensor([0.1, -0.05, 0.2], dtype=dtype)
    return w2c, torch.tensor([-0.1, 0.05, -0.2], dtype=dtype)


def _cotangents(n, seed=3):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen) for shape in ((n, 2), (n, 3), (n,), (n, 3), (n,),
                                                            (n,))]


def _differentiable(p):
    return (p.mean2d, p.conic, p.opacity, p.color, p.depth, p.power_threshold)


@pytest.mark.parametrize("degree,rest", [(0, 15), (1, 15), (2, 15), (3, 15), (4, 24)])
def test_cpu_runs_the_chain_bit_for_bit(degree, rest):
    leaves, alive = _scene(rest=rest)
    w2c, cpos = _camera()
    cot = _cotangents(alive.shape[0])
    launches = project_kernel.launches, project_backward_kernel.launches
    runs = []
    for fn, kw in ((projection.project, {}), (projection.project, dict(impl="plain")),
                   (projection.project_plain, {})):
        xs = [x.detach().requires_grad_(True) for x in leaves]
        p = fn(*xs, alive, w2c, cpos, FX, FY, CX, CY, W, H, degree, TILE, **kw)
        grads = torch.autograd.grad(_differentiable(p), xs, cot, allow_unused=True)
        runs.append((p, grads))
    (p0, g0) = runs[0]
    assert int(p0.visible.sum()) > 10
    for p, grads in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(p0, p))
        assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(g0, grads))
    assert (project_kernel.launches, project_backward_kernel.launches) == launches


def test_impl_is_checked():
    leaves, alive = _scene()
    with pytest.raises(ValueError, match="impl"):
        projection.project(*leaves, alive, *_camera(), FX, FY, CX, CY, W, H, 3, TILE,
                           impl="fused")


def _fake(is_cuda=True, requires_grad=False):
    return SimpleNamespace(is_cuda=is_cuda, requires_grad=requires_grad)


@pytest.mark.parametrize("case,kernels", [
    ("card", True), ("cpu", False), ("plain", False), ("pose", False), ("cam_position", False),
    ("sh4", True), ("sh4-inactive", True), ("sh3-short", True),
])
def test_the_kernels_run_on_the_card_without_a_camera_gradient_up_to_sh3(case, kernels):
    """The route: a CUDA device under `impl="kernel"`, whatever the SH bands (up to 4);
    not on the CPU, under `impl="plain"` or where w2c or cam_position requires grad (pose
    optimisation). The kernels evaluate the bands the chain does: an SH-4 state at active
    degree 4 all four, at degree 3 three, a state holding bands up to 2 two."""
    means, w2c, cpos = _fake(), _fake(), _fake()
    degree, rest, impl = 3, 15, "kernel"
    if case == "cpu":
        means = _fake(is_cuda=False)
    elif case == "plain":
        impl = "plain"
    elif case == "pose":
        w2c = _fake(requires_grad=True)
    elif case == "cam_position":
        cpos = _fake(requires_grad=True)
    elif case == "sh4":
        degree, rest = 4, 24
    elif case == "sh4-inactive":
        degree, rest = 3, 24
    elif case == "sh3-short":  # shN holds bands up to 2 only
        degree, rest = 3, 8
    assert projection.takes_kernels(means, w2c, cpos, impl) is kernels
    bands = camera_args(FX, FY, CX, CY, W, H, TILE, degree, rest).sh_degree
    assert bands == {"sh4": 4, "sh3-short": 2}.get(case, 3) == sh_bands(degree, rest)


def test_sh_bands_are_the_chains():
    """The degree the chain evaluates: up to the active degree, while shN holds the band."""
    assert [sh_bands(d, 15) for d in range(5)] == [0, 1, 2, 3, 3]
    assert [sh_bands(3, r) for r in (0, 2, 3, 7, 8, 14, 15, 24)] == [0, 0, 1, 1, 2, 2, 3, 3]
    assert sh_bands(4, 24) == 4 and sh_bands(4, 23) == 3
    # sh_to_color adds those bands and no other: a fifth band's coefficients held short of
    # 24 change nothing, nor does an active degree above the bands shN holds
    leaves, _ = _scene(n=64, rest=23)
    dirs = leaves[0] - torch.tensor([0.1, -0.2, 0.3])
    sh0, shN = leaves[4], leaves[5]
    assert torch.equal(sh_to_color(sh0, shN, dirs, 4), sh_to_color(sh0, shN, dirs, 3))
    assert torch.equal(sh_to_color(sh0, shN[:, :8], dirs, 3), sh_to_color(sh0, shN, dirs, 2))
    assert not torch.equal(sh_to_color(sh0, shN, dirs, 3), sh_to_color(sh0, shN, dirs, 2))


def test_camera_args_carry_the_chains_float32_scalars():
    cam = camera_args(1000.1, 999.9, 648.3, 420.7, 1296, 840, 16, 2, 15)
    f32 = lambda v: float(np.float32(v))
    assert (cam.fx, cam.fy, cam.cx, cam.cy) == (f32(1000.1), f32(999.9), f32(648.3), f32(420.7))
    # the Jacobian's clamp: Python floats as projection.py writes them, rounded once
    assert (cam.lo_x, cam.hi_x) == (f32((-0.15 * 1296 - 648.3) / 1000.1),
                                    f32((1.15 * 1296 - 648.3) / 1000.1))
    assert (cam.lo_y, cam.hi_y) == (f32((-0.15 * 840 - 420.7) / 999.9),
                                    f32((1.15 * 840 - 420.7) / 999.9))
    assert (cam.width, cam.height, cam.tile_size, cam.sh_degree, cam.sh_rest) == (
        1296, 840, 16, 2, 15)
    assert ctypes.sizeof(cam) == 13 * 4
    sh4 = camera_args(1.0, 1.0, 0.0, 0.0, 8, 8, 16, 4, 24)
    assert (sh4.sh_degree, sh4.sh_rest) == (4, 24)


def test_wrappers_check_their_arguments_before_launching():
    leaves, alive = _scene(n=64)
    w2c, cpos = _camera()
    cam = camera_args(FX, FY, CX, CY, W, H, TILE, 3, 15)
    with pytest.raises(ValueError, match="contiguous CUDA tensor"):
        project_kernel(*leaves, alive, w2c, cpos, cam)
    with pytest.raises(ValueError, match="contiguous CUDA tensor"):
        project_backward_kernel(*leaves, alive, w2c, cpos, cam)
    with pytest.raises(ValueError, match="float32"):
        project_kernel(*[x.double() for x in leaves], alive, w2c, cpos, cam)
    with pytest.raises(ValueError, match=r"shN \[N, K-1, 3\]"):
        project_kernel(*leaves[:5], leaves[5][:, :, :2], alive, w2c, cpos, cam)
    with pytest.raises(ValueError, match=r"cam_position \[3\]"):
        project_kernel(*leaves, alive, w2c, cpos[:2], cam)
    with pytest.raises(ValueError, match="cotangent of shape"):
        _cotangent(torch.zeros(64, 3), (64, 2), leaves[0])
    with pytest.raises(ValueError, match="cotangent of shape"):
        _cotangent(torch.zeros(64, 2, dtype=torch.float64), (64, 2), leaves[0])
    assert _cotangent(None, (64, 2), leaves[0]) is None


def test_the_projection_entry_points_share_one_source():
    assert build.source_name("projection_bwd") == build.source_name("projection") == "projection"
    assert build.library_path("projection_bwd") == build.library_path("projection")
    # forward: 7 inputs, n, w2c, cam_position, the camera, 10 outputs, the stream
    assert len(build.ENTRY_POINTS["projection"][1]) == 7 + 1 + 2 + 1 + 10 + 1
    # backward: 6 inputs, n, w2c, cam_position, the camera, 6 cotangents, 6 gradients, stream
    assert len(build.ENTRY_POINTS["projection_bwd"][1]) == 6 + 1 + 2 + 1 + 6 + 6 + 1


def test_the_kernels_constants_are_the_chains():
    """Each SH constant of `csrc/projection.cu` is the float32 value of sh.py's (band 4's
    written as the same decimal, which both round from a double to float32 once), and the
    culls' thresholds are projection.py's."""
    src = (build.SRC_DIR / "projection.cu").read_text()
    sh_src = (build.SRC_DIR.parent / "ops" / "sh.py").read_text()
    band4 = re.findall(r"constexpr float (kC4_\w+) = ([-0-9.e]+);", src)
    assert len(band4) == 12
    for name, v in band4:
        assert re.search(rf"(?<![0-9.]){re.escape(v.lstrip('-'))}(?![0-9])", sh_src), name
    assert {v for _, v in band4 if v.startswith("-")} == {"-4.683325804901025",
                                                         "-1.770130769779931"}
    assert "-4.683325804901025 * zz" in sh_src and "-1.770130769779931 * z" in sh_src
    consts = {k: np.float32(float(v)) for k, v in
              re.findall(r"constexpr float (k\w+) = ([-0-9.e]+)f;", src)}
    want = {"kC0": sh.SH_C0, "kC1": sh.SH_C1, "kC2_0": sh.SH_C2[0], "kC2_1": sh.SH_C2[1],
            "kC2_2": sh.SH_C2[2], "kC2_3": sh.SH_C2[3], "kC2_4": sh.SH_C2[4],
            "kC2_zz": 0.94617469575755997, "kC3_0": sh.SH_C3[0], "kC3_1": sh.SH_C3[1],
            "kC3_2": sh.SH_C3[2], "kC3_3": sh.SH_C3[3], "kC3_4": sh.SH_C3[4],
            "kNear": projection.NEAR_PLANE, "kFar": projection.FAR_PLANE, "kDilation":
            projection.DILATION, "kMinAlphaRcp": projection.MIN_ALPHA_RCP}
    assert {k: consts[k] for k in want} == {k: np.float32(v) for k, v in want.items()}
    assert "constexpr float kMinAlpha = 1.0f / 255.0f;" in src
    assert np.float32(1.0) / np.float32(255.0) == np.float32(projection.MIN_ALPHA)
    assert "0.94617469575755997 * zz" in sh_src


def _stand_ins(monkeypatch, degree):
    """`project` through `ProjectKernel` on the CPU, the kernels replaced by the chain and
    its autograd backward; -> the list of the cotangents each backward call was given."""
    seen = []

    def forward(means, scaling_raw, rotation_raw, opacity_raw, sh0, shN, alive, w2c,
                cam_position, cam):
        with torch.no_grad():
            return tuple(projection.project_plain(
                means, scaling_raw, rotation_raw, opacity_raw, sh0, shN, alive, w2c,
                cam_position, FX, FY, CX, CY, W, H, degree, TILE))

    def backward(means, scaling_raw, rotation_raw, opacity_raw, sh0, shN, alive, w2c,
                 cam_position, cam, *cot):
        seen.append(cot)
        xs = [x.detach().requires_grad_(True)
              for x in (means, scaling_raw, rotation_raw, opacity_raw, sh0, shN)]
        with torch.enable_grad():
            p = projection.project_plain(*xs, alive, w2c, cam_position, FX, FY, CX, CY, W, H,
                                         degree, TILE)
            pairs = [(o, c) for o, c in zip(_differentiable(p), cot) if c is not None]
            grads = torch.autograd.grad([o for o, _ in pairs], xs, [c for _, c in pairs],
                                        allow_unused=True)
        return tuple(torch.zeros_like(x) if g is None else g for x, g in zip(xs, grads))

    monkeypatch.setattr(projection, "project_kernel", forward)
    monkeypatch.setattr(projection, "project_backward_kernel", backward)
    monkeypatch.setattr(projection, "takes_kernels", lambda *a: True)
    return seen


@pytest.mark.parametrize("used", ["all", "color", "mean2d+pt"])
def test_the_autograd_function_passes_values_and_gradients_as_the_chain(monkeypatch, used):
    """`ProjectKernel` around stand-ins (the chain) gives the chain's values and gradients:
    the cotangents of outputs a loss does not use reach the backward as None (no zero
    tensors are made), a leaf that does not require grad gets none, a leaf the used outputs
    do not reach gets zeros (the chain: None), and the tile rects, counts and `visible`
    carry no gradient."""
    leaves, alive = _scene()
    w2c, cpos = _camera()
    n = alive.shape[0]
    cot_all = _cotangents(n)
    pick = dict(all=range(6), color=[3], **{"mean2d+pt": [0, 5]})[used]
    seen = _stand_ins(monkeypatch, 3)

    def run(fn):
        xs = [x.detach().requires_grad_(i != 4) for i, x in enumerate(leaves)]  # sh0 fixed
        p = fn(*xs, alive, w2c, cpos, FX, FY, CX, CY, W, H, 3, TILE)
        outs = [_differentiable(p)[i] for i in pick]
        grads = torch.autograd.grad(outs, [x for i, x in enumerate(xs) if i != 4],
                                    [cot_all[i] for i in pick], allow_unused=True)
        return p, grads

    p_k, g_k = run(projection.project)
    p_c, g_c = run(projection.project_plain)
    assert len(seen) == 1
    assert [c is not None for c in seen[0]] == [i in pick for i in range(6)]
    assert all(torch.equal(a, b) for a, b in zip(p_k, p_c))
    for a, b in zip(g_k, g_c):
        assert torch.allclose(a, torch.zeros_like(a) if b is None else b, atol=1e-6)
    for name in ("tile_min", "tile_max", "n_tiles", "visible"):
        assert not getattr(p_k, name).requires_grad
