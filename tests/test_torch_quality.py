"""The port's quality-of-record entry points (`tpu_splat_torch/tools/`) and the JAX
package's last public names, on the CPU against the JAX package:

- the raytraced capture writer (`tools/synth_capture.py`) against
  `tests/synth_data.py::make_raytraced_colmap`: `sparse/0/*.bin` byte-equal, the PNGs'
  decoded pixels equal;
- `tools/eval_raytraced.py` end to end at 32x32: the JAX script's `EVAL` lines and JSON
  keys, `metrics.csv` and `splat_final.ply`, finite PSNR;
- `tools/eval_mipnerf360.py` on a fake scene root (one outdoor scene in `images_4`, one
  indoor in `images_2`): its `summary.csv` equals the one the JAX script writes from the
  same rows;
- `PlySaved`, `RefinementCompleted`, `MemoryUsage`, `create_temp_project` and
  `quat_scale_to_covar` against their JAX counterparts (covariance at rtol 1e-6).
"""

import csv
import dataclasses
import importlib.util
import json
import math
import tempfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tpu_splat.core import project as jax_project
from tpu_splat.ops.quat import quat_scale_to_covar as jax_quat_scale_to_covar
from tpu_splat.utils import events as jax_events
from tpu_splat_torch.core import project
from tpu_splat_torch.ops.quat import quat_scale_to_covar
from tpu_splat_torch.tools import eval_mipnerf360, eval_raytraced, synth_capture
from tpu_splat_torch.utils import events

import synth_data

REPO = Path(__file__).resolve().parents[1]
# the final JSON line of tools/eval_raytraced.py (:91-94)
JAX_SUMMARY_KEYS = {"size", "n_cams", "iterations", "elapsed_s", "steady_iters_per_s",
                    "results"}
JAX_EVAL_KEYS = {"step", "psnr", "ssim", "lpips", "n_images"}


def _jax_tool(name):
    """A script of the repository's tools/ as a module (its top level imports no JAX)."""
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}",
                                                  REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kw", [dict(size=32, n_cams=4, n_sfm=200),
                                dict(size=40, height=24, n_cams=3, seed=5,
                                     exposure_jitter=0.1, sfm_noise=0.004, n_sfm=120)])
def test_writer_matches_synth_data(tmp_path, kw):
    want, got = tmp_path / "jax", tmp_path / "port"
    cams_j = synth_data.make_raytraced_colmap(want, **kw)
    cams_t = synth_capture.make_raytraced_colmap(got, **kw)
    assert len(cams_t) == len(cams_j) == kw["n_cams"]
    for f in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (got / "sparse/0" / f).read_bytes() == (want / "sparse/0" / f).read_bytes(), f
    names = sorted(p.name for p in (want / "images").iterdir())
    assert names == sorted(p.name for p in (got / "images").iterdir())
    for name in names:
        a = np.asarray(Image.open(want / "images" / name).convert("RGB"))
        b = np.asarray(Image.open(got / "images" / name).convert("RGB"))
        assert a.shape == (kw.get("height") or kw["size"], kw["size"], 3)
        np.testing.assert_array_equal(b, a, err_msg=name)


def test_eval_raytraced_end_to_end(tmp_path, capsys):
    out = tmp_path / "rt"
    summary = eval_raytraced.main([
        "--device", "cpu", "--size", "32", "--n-cams", "8", "--iterations", "40",
        "--eval-steps", "20", "40", "--max-cap", "2048", "--n-sfm", "400",
        "--out", str(out)])
    lines = capsys.readouterr().out.splitlines()
    evals = [ln for ln in lines if ln.startswith("EVAL ")]
    assert len(evals) == 2
    final = json.loads(lines[-1])
    assert JAX_SUMMARY_KEYS <= final.keys() and final == json.loads(json.dumps(summary))
    assert (final["size"], final["n_cams"], final["iterations"]) == (32, 8, 40)
    assert [r["step"] for r in final["results"]] == [20, 40]
    for r in final["results"]:
        assert r.keys() == JAX_EVAL_KEYS and math.isfinite(r["psnr"]) and r["psnr"] > 0
        assert r["n_images"] == 1 and r["lpips"] is None  # no VGG weights
    assert final["device"] == "cpu" and 0 < final["n_alive"] <= 2048
    with open(out / "run" / "metrics.csv") as f:
        assert [int(float(row["iteration"])) for row in csv.DictReader(f)] == [20, 40]
    assert (out / "run" / "splat_final.ply").stat().st_size > 0
    assert len(list((out / "capture" / "images").glob("*.png"))) == 8


def test_eval_mipnerf360_on_a_fake_root(tmp_path, monkeypatch, capsys):
    root = tmp_path / "360_v2"
    for scene, folder in (("garden", "images_4"), ("kitchen", "images_2")):
        synth_capture.make_raytraced_colmap(root / scene, n_cams=8, size=24, n_sfm=200)
        (root / scene / "images").rename(root / scene / folder)
    config = tmp_path / "small.json"
    config.write_text(json.dumps(dict(max_cap=1024, num_workers=2)))
    out = tmp_path / "out"
    rows = eval_mipnerf360.main([
        "--data-root", str(root), "--out", str(out), "--scenes", "garden", "kitchen",
        "bicycle", "--iterations", "20", "--eval-steps", "10", "20", "--config",
        str(config), "--device", "cpu"])
    assert "missing scene bicycle" in capsys.readouterr().out
    assert [(r["scene"], r["images"]) for r in rows] == [("garden", "images_4"),
                                                         ("kitchen", "images_2")]
    for r in rows:
        for it in (10, 20):
            assert math.isfinite(r[f"it{it}"]["psnr"]) and r[f"it{it}"]["lpips"] is None
        assert (out / r["scene"] / "metrics.csv").exists()
    assert json.loads((out / "summary.json").read_text()) == json.loads(json.dumps(rows))

    # the JAX script's summary.csv from the same rows
    jax_tool = _jax_tool("eval_mipnerf360")
    by_scene = {r["scene"]: r for r in rows}
    monkeypatch.setattr(jax_tool, "run_scene", lambda scene, *a, **k: by_scene[scene])
    jax_out = tmp_path / "jax_out"
    monkeypatch.setattr("sys.argv", [
        "eval_mipnerf360.py", "--data-root", str(root), "--out", str(jax_out),
        "--scenes", "garden", "kitchen", "--eval-steps", "10", "20"])
    jax_tool.main()
    got = (out / "summary.csv").read_text()
    assert got.splitlines()[0] == ("scene,images,elapsed_s,psnr@10,ssim@10,lpips@10,"
                                   "psnr@20,ssim@20,lpips@20")
    assert got == (jax_out / "summary.csv").read_text()
    assert eval_mipnerf360.SCENES == jax_tool.SCENES
    assert (eval_mipnerf360.OUTDOOR, eval_mipnerf360.INDOOR) == (jax_tool.OUTDOOR,
                                                                 jax_tool.INDOOR)


@pytest.mark.parametrize("name", ["PlySaved", "RefinementCompleted", "MemoryUsage"])
def test_events_match_jax(name):
    ours, theirs = getattr(events, name), getattr(jax_events, name)

    def shape(cls):
        return [(f.name, f.type, f.default, f.default_factory) for f in dataclasses.fields(cls)]

    assert shape(ours) == shape(theirs)
    args = {"PlySaved": dict(path="a.ply", iteration=7),
            "RefinementCompleted": dict(iteration=9, info={"split": 3}),
            "MemoryUsage": dict(bytes_in_use=123)}[name]
    seen = []
    unsubscribe = events.when(ours, seen.append)
    try:
        events.emit(ours(**args))
    finally:
        unsubscribe()
    assert dataclasses.asdict(seen[0]) == dataclasses.asdict(theirs(**args))


def test_quat_scale_to_covar_matches_jax():
    rng = np.random.default_rng(11)
    q = rng.normal(0, 1, (64, 4)).astype(np.float32)
    s = np.exp(rng.normal(-2, 1, (64, 3))).astype(np.float32)
    want = np.asarray(jax_quat_scale_to_covar(jnp.asarray(q), jnp.asarray(s)))
    got = quat_scale_to_covar(torch.from_numpy(q), torch.from_numpy(s)).numpy()
    assert got.shape == (64, 3, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_create_temp_project_round_trip(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    proj = project.create_temp_project("data/scene")
    want = jax_project.create_temp_project("data/scene")
    assert proj.path.parent.parent == tmp_path and proj.path.name == want.path.name
    assert (proj.name, proj.is_temporary, proj.data_path) == ("temp", True, "data/scene")
    assert proj.output_path == str(proj.path.parent)
    proj.add_ply("final", "x.ply", iteration=3)
    back = project.Project.load(proj.path)
    assert dataclasses.asdict(back) == dataclasses.asdict(proj)
    cross = jax_project.Project.load(proj.path)  # the JAX package reads the port's file
    assert dataclasses.asdict(cross) == dataclasses.asdict(back)
    keys = lambda p: sorted(json.loads(Path(p).read_text()))  # noqa: E731
    assert keys(proj.path) == keys(want.path)
