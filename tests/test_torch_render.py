"""The PyTorch port's render path end to end against the JAX package, on the CPU.

`rasterize` is held against JAX `rasterize(backend="pallas")` (its kernels in interpret
mode) and against the naive O(N*P) oracle `render_naive`, at the setting of
test_pallas_interpret_matches_xla; the CLI's PNGs against JAX `render_orbit`'s.
Tolerances: image, alpha and expected depth atol 1e-5 (float32, same math in another
order); PNGs 1/255 (one 8-bit rounding step).
"""

import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_splat.io.ply import save_splat_ply as jax_save_splat_ply
from tpu_splat.ops.rasterize import rasterize as jax_rasterize
from tpu_splat.ops.reference import render_naive
from tpu_splat.render import render_orbit as jax_render_orbit
from tpu_splat_torch import render as torch_render
from tpu_splat_torch.convert import splat_from_numpy
from tpu_splat_torch.ops.rasterize import rasterize

from utils import make_camera, make_scene

REPO = Path(__file__).resolve().parents[1]
KW = dict(width=48, height=48, max_instances=1 << 13, k_max=256, chunk=128, tile_size=16)
BG = np.asarray([0.1, 0.2, 0.3], np.float32)


@functools.lru_cache(maxsize=1)
def _scene_and_jax_render():
    scene = make_scene(400, 7)
    cam = make_camera(48, 48)
    args = tuple(scene[k] for k in ("means", "scaling_raw", "rotation_raw", "opacity_raw",
                                     "sh0", "shN", "alive"))
    args += (cam["w2c"], cam["cam_position"], cam["fx"], cam["fy"], cam["cx"], cam["cy"])
    out = jax_rasterize(*args, 3, jnp.asarray(BG), backend="pallas", render_mode="RGB_ED",
                        **KW)
    naive = jax.jit(render_naive, static_argnames=("width", "height", "active_sh_degree"))(
        *args, width=48, height=48, active_sh_degree=3, bg_color=jnp.asarray(BG))
    return args, out, naive


@pytest.mark.parametrize("mode", ["RGB", "RGB_ED"])
def test_rasterize_matches_jax_pallas_and_naive(mode):
    args, want, (naive_img, naive_alpha) = _scene_and_jax_render()
    got = rasterize(*args, 3, BG, render_mode=mode, device="cpu", **KW)
    assert int(got.aux.total_instances) <= KW["max_instances"]
    assert int(got.aux.max_tile_count) <= KW["k_max"]
    for name in ("total_instances", "max_tile_count", "n_visible"):
        assert int(getattr(got.aux, name)) == int(getattr(want.aux, name)), name
    img, alpha = got.image.numpy(), got.alpha.numpy()
    assert img.shape == (3, 48, 48) and np.isfinite(img).all()
    assert 0.05 < float(alpha.mean()) < 0.999
    for ref_img, ref_alpha in ((want.image, want.alpha), (naive_img, naive_alpha)):
        np.testing.assert_allclose(img, np.asarray(ref_img), rtol=0, atol=1e-5)
        np.testing.assert_allclose(alpha, np.asarray(ref_alpha), rtol=0, atol=1e-5)
    if mode == "RGB":
        assert got.depth is None
    else:
        np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth), rtol=1e-5,
                                   atol=1e-5)


def test_render_view_needs_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = make_scene(20, 1)
    state = splat_from_numpy(scene, scene["alive"], 3, "cpu")
    w2c = np.eye(4, dtype=np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_render.render_view(state, w2c, 32, 32)
    out = torch_render.render_view(state, w2c, 32, 32, device="cpu")
    assert out.image.shape == (3, 32, 32) and out.image.device.type == "cpu"


def test_cli_view_matches_jax_render_orbit(tmp_path):
    from PIL import Image

    scene = make_scene(300, 11)
    model = tmp_path / "m.ply"
    jax_save_splat_ply(model, scene["means"], scene["sh0"], scene["shN"],
                       scene["scaling_raw"], scene["rotation_raw"], scene["opacity_raw"])
    subprocess.run(
        [sys.executable, "-m", "tpu_splat_torch", "--view", str(model), "-o",
         str(tmp_path / "torch"), "--view-frames", "2", "--view-width", "64",
         "--view-height", "48", "--device", "cpu"],
        cwd=REPO, check=True, timeout=300,
    )
    jax_render_orbit(model, tmp_path / "jax", n_frames=2, width=64, height=48)
    for i in range(2):
        name = f"frame_{i:04d}.png"
        with Image.open(tmp_path / "torch" / name) as a, Image.open(tmp_path / "jax" / name) as b:
            got, want = np.asarray(a, np.int16), np.asarray(b, np.int16)
        assert got.shape == (48, 64, 3) and got.std() > 1.0
        assert np.abs(got - want).max() <= 1
