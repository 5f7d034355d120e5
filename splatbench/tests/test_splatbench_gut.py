"""The cell `garden-gut-1m.train` on the CPU: the readers of its host spans, the
reference's 3DGUT frame held to the program's plain render on rotated Gaussians, and the
cell cut to a CPU size passing its limits where its control fails them."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from conftest import tiny_cell

import control
import run as sbrun
import sb_inputs as inp
import sb_reference as ref
from test_splatbench_reference import _camera, _scene


@pytest.mark.parametrize("name,key", [("gut.project_ms", "gut_project"),
                                      ("gut.rays_ms", "gut_rays")])
def test_span_readers_read_ms_an_iteration_or_nothing(name, key):
    reader = sbrun.load_metric(name)
    rec = dict(kind="train", iterations=40, timings={"dispatch": 2.0, key: 0.5})
    assert reader.read(rec, {}) == pytest.approx(12.5)
    # a program that keeps no such span (the parent of the change that added it)
    assert reader.read(dict(rec, timings={"dispatch": 2.0}), {}) is None
    assert reader.read(dict(rec, iterations=0), {}) is None
    assert reader.read(dict(kind="render", frames=10), {}) is None


def test_reference_gut_frame_matches_the_programs_plain_gut_render_rotated(cpu):
    """The twin of `test_reference_gut_frame_matches_the_programs_plain_gut_render_unrotated`
    on the scene's own rotations, which the program's sigma points now carry."""
    from tpu_splat_torch.ops.cameras import CameraParams
    from tpu_splat_torch.ops.gut import rasterize_gut

    params, alive = _scene()
    q = params["rotation_raw"][alive]
    assert float((q[:, 1:].norm(dim=1) / q.norm(dim=1)).median()) > 0.3  # rotated
    w2c = inp.capture_views(5, 1, 0.03, 0.15)[0]
    focal = 0.85 * 96
    cam = dict(_camera(w2c, focal, 96, 64), dist=(0.05, 0.0, 0.0, 0.0))
    got = rasterize_gut(*(params[k] for k in ref.PARAMS[:1]), params["scaling_raw"],
                        params["rotation_raw"], params["opacity_raw"], params["sh0"],
                        params["shN"], alive, w2c, cam["position"], focal, focal, 48.0, 32.0,
                        3, np.zeros(3, np.float32), width=96, height=64,
                        max_instances=1 << 17, k_max=4096, tile_size=16,
                        cam_params=CameraParams(radial=(0.05, 0, 0, 0, 0, 0)),
                        device="cpu").image
    want, counts = ref.render(params, alive, cam, 3, 16)
    assert counts["used"] > 10_000
    assert float((got - want).abs().mean()) < 1e-6


def test_a_sound_gut_run_is_correct_and_its_control_is_not(cpu):
    """As `test_a_sound_run_is_correct_and_its_control_is_not`, for the 3DGUT cell."""
    cell = tiny_cell("garden-gut-1m.train")
    assert cell["config"]["camera_model"] == "OPENCV" and cell["features"] == "f32"
    (r,) = control.readings(cell, [2**31 + 77], 1.0, cpu, [cell["control"]])
    assert r["correct"]
    low = r["controls"][cell["control"]]
    assert any(low[k] > lim for k, lim in cell["limits"].items())
    assert torch.get_num_threads() <= 4
