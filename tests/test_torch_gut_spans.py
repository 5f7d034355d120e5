"""The GUT path's host spans and ray counter on the CPU: a short `Trainer.train` under
`--gut` on a synthetic OPENCV capture (k1 = 0.05) sums the host seconds inside
`ops/gut.py::ut_project` and `pixel_world_rays` into `timings["gut_project"]` and
`timings["gut_rays"]`, parts of `timings["dispatch"]`, and builds one ray table a step
(`pixel_world_rays.builds`); a pinhole run leaves both spans at 0 and builds none. The
keys exist from the Trainer's construction, so a reader that differences `timings` across
a window finds them."""

import torch
from torch.profiler import ProfilerActivity, profile

from tpu_splat_torch.core.config import DatasetConfig, OptimizationParameters, TrainingParameters
from tpu_splat_torch.ops import gut
from tpu_splat_torch.training import trainer

from synth_data import make_synthetic_colmap, make_synthetic_colmap_distorted


def _params(base, out, use_gut):
    # chunks of 4, 4, 2 (cut by the progress report at 10) and a single step
    opt = OptimizationParameters(iterations=11, max_cap=256, refine_every=100,
                                 start_refine=500, eval_steps=[], save_steps=[],
                                 num_workers=1, scan_steps=4, gut=use_gut)
    return TrainingParameters(dataset=DatasetConfig(data_path=str(base), output_path=str(out)),
                              optimization=opt)


def test_gut_trainer_fills_its_spans_and_builds_one_ray_table_a_step(tmp_path):
    base = tmp_path / "capture"
    make_synthetic_colmap_distorted(base, n_gauss=120, n_cams=6, size=48, k1=0.05)
    t = trainer.Trainer(_params(base, tmp_path / "out", True), device="cpu")
    assert t.step_cfg.gut
    assert t.timings["gut_project"] == t.timings["gut_rays"] == 0.0
    builds = gut.pixel_world_rays.builds
    t.train(progress_every=10)
    assert t.steps_dispatched == 11 and t.n_redo == 0
    assert gut.pixel_world_rays.builds - builds == t.steps_dispatched
    spans = t.timings["gut_project"], t.timings["gut_rays"]
    assert min(spans) > 0 and sum(spans) < t.timings["dispatch"], (spans, t.timings)


def test_pinhole_trainer_leaves_the_gut_spans_at_zero(tmp_path):
    base = tmp_path / "capture"
    make_synthetic_colmap(base, n_gauss=120, n_cams=6, size=48)
    t = trainer.Trainer(_params(base, tmp_path / "out", False), device="cpu")
    builds = gut.pixel_world_rays.builds
    t.train(progress_every=10)
    assert not t.step_cfg.gut and t.timings["dispatch"] > 0
    assert t.timings["gut_project"] == t.timings["gut_rays"] == 0.0
    assert gut.pixel_world_rays.builds == builds


def test_the_spans_are_profiler_ranges_of_their_names():
    """Each span is a range in a profiler trace, of an operator's scope: on the card it
    names the host's work and the device's idle gaps inside it and lays no user annotation
    over the device's timeline."""
    from tpu_splat_torch.ops.cameras import CameraParams

    w2c = torch.eye(4)
    before = dict(gut.host_seconds())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gut.pixel_world_rays(w2c, torch.zeros(3), 40.0, 40.0, 16.0, 16.0,
                             CameraParams(radial=(0.05, 0, 0, 0, 0, 0)), None, None,
                             grid_w=2, grid_h=2, tile_size=16, width=32, height=32)
    ranges = [e for e in prof.events() if e.name == "gut_rays"]
    assert len(ranges) == 1 and not ranges[0].is_user_annotation
    assert ranges[0].cpu_parent is None and len(ranges[0].cpu_children) > 0
    assert gut.host_seconds()["gut_rays"] > before["gut_rays"]
    assert gut.host_seconds()["gut_project"] == before["gut_project"]
