"""The harness's contract: files found by name, new cells and metrics as files only, the
result line's keys, the import checks and the refusal to run without a card."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest
from conftest import BENCH, ROOT

import run as sbrun

BENCH_JSON = sbrun.read_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_keeps_to_the_contract():
    b = BENCH_JSON
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["splatbench"] and 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert all(one_line(c[k]) for k in ("source", "why"))
        assert c["file"].startswith("splatbench/") and (ROOT / c["file"]).is_file()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1 and one_line(w["why"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        keys = {"name", "unit", "better", "source", "workloads"}
        keys |= {"bound"} if "bound" in m else {"layer", "moves"}
        assert set(m) - {"workloads"} == keys - {"workloads"}
        if "bound" in m:
            assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        else:
            assert m["moves"] in e2e and one_line(m["layer"])
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH_JSON["workloads"]])
def test_every_cell_and_its_files_are_found_by_name(cell):
    c = sbrun.load_cell(BENCH_JSON, cell)
    assert c["traffic"]["loop"] in ("train", "render")
    assert set(c["limits"]) and c["features"] in ("f32", "bf16_pack")
    names = [m["name"] for m in sbrun.cell_metrics(BENCH_JSON, cell, False)]
    assert "setup_s" in names and len(names) >= 2
    assert sbrun.cell_metrics(BENCH_JSON, cell, True)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH_JSON["end_to_end"]
                                    + BENCH_JSON["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(sbrun.load_metric(metric).read)


def test_a_new_cell_and_metric_need_new_files_only(tmp_path):
    """A copy of the benchmark with one more cell and one more metric, added as files
    and entries, finds both with no edit of a file it already had."""
    shutil.copytree(BENCH, tmp_path / "splatbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    here = tmp_path / "splatbench"
    (here / "traffic" / "render-far.json").write_text(json.dumps(
        dict(sbrun.read_json(here / "traffic" / "render.json"), pose_trans=1.0)))
    (here / "workloads" / "garden-mcmc-1m.render-far.json").write_text(json.dumps(
        dict(sbrun.read_json(here / "workloads" / "garden-mcmc-1m.render.json"),
             traffic="render-far")))
    (here / "metrics" / "frames.render.py").write_text(
        "def read(rec, cell):\n    return rec['frames']\n")
    b = json.loads(json.dumps(BENCH_JSON))
    b["workloads"].append(dict(name="garden-mcmc-1m.render-far", config="garden-mcmc-1m",
                               traffic="render-far", chips=1, why="farther poses"))
    b["per_layer"].append(dict(name="frames.render", unit="frames", better="higher",
                               source="host_clock", layer="view (render.py::render_view)",
                               moves="frame_ms", workloads=["garden-mcmc-1m.render-far"]))
    cell = sbrun.load_cell(b, "garden-mcmc-1m.render-far", here)
    assert cell["traffic"]["pose_trans"] == 1.0
    assert [m["name"] for m in sbrun.cell_metrics(b, cell["name"], True)] == ["frames.render"]
    assert sbrun.load_metric("frames.render", here).read(dict(frames=7), cell) == 7


def test_a_new_loop_needs_a_new_file_only(tmp_path, monkeypatch):
    """A traffic mix whose `loop` names a module no file of the harness mentions: the
    module, added as `sb_<loop>.py`, runs the cell, and its record's `attempted` reaches
    the result line."""
    shutil.copytree(BENCH, tmp_path / "splatbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    here = tmp_path / "splatbench"
    (here / "traffic" / "export.json").write_text(json.dumps(dict(loop="export_probe")))
    (here / "workloads" / "garden-mcmc-1m.export.json").write_text(json.dumps(dict(
        config="garden-mcmc-1m", traffic="export", features="f32", control="bf16",
        limits=dict(bytes_gap=0.0))))
    (here / "metrics" / "export_s.py").write_text(
        "def read(rec, cell):\n    return rec['window_s']\n")
    (here / "sb_export_probe.py").write_text(
        "def run(cell, seed, seconds, trace, dev, t_start, log=print):\n"
        "    return dict(attempted=3, window_s=seconds, memory_peak_bytes=0,\n"
        "                checks=dict(bytes_gap=0.0))\n")
    b = json.loads(json.dumps(BENCH_JSON))
    b["workloads"].append(dict(name="garden-mcmc-1m.export", config="garden-mcmc-1m",
                               traffic="export", chips=1, why="save_sog of the scene"))
    b["end_to_end"] = [dict(name="export_s", unit="s", better="lower", bound=0.1,
                            source="host_clock", workloads=["garden-mcmc-1m.export"])]
    monkeypatch.syspath_prepend(str(here))
    monkeypatch.setattr(sbrun, "HERE", here)
    cell = sbrun.load_cell(b, "garden-mcmc-1m.export", here)
    rec = sbrun.run_cell(cell, 1, 2.5, False, "cpu", 0.0)
    out = sbrun.result_line(b, cell, rec, False, {})
    assert out["attempted"] == 3 and out["correct"]
    assert out["metrics"] == {"export_s": {"value": 2.5, "unit": "s"}}


def test_result_line_has_the_contract_keys_and_checks_last():
    cell = sbrun.load_cell(BENCH_JSON, "garden-mcmc-1m.render")
    rec = dict(kind="render", setup_s=12.0, window_s=10.0, attempted=500, frames=500,
               latencies_s=[0.02] * 500, memory_peak_bytes=1,
               checks={k: 0.0 for k in cell["limits"]},
               trace=dict(busy_s=0.5, window_s=1.0, kernels=[("k", 0.5)], gaps=[("g", 0.1)]))
    dev = dict(platform="gpu", kind="x", count=1, memory_peak_bytes=1)
    out = sbrun.result_line(BENCH_JSON, cell, rec, False, dict(dev))
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["correct"] and out["metrics"]["frame_ms"]["value"] == 20.0
    traced = sbrun.result_line(BENCH_JSON, cell, rec, True, dict(dev))
    assert list(traced)[-2:] == ["breakdown", "checks"]
    assert traced["device"]["busy_s"] == 0.5 and traced["device"]["window_s"] == 1.0
    bad = dict(rec, checks={k: 2.0 * v for k, v in cell["limits"].items()})
    assert not sbrun.result_line(BENCH_JSON, cell, bad, False, dict(dev))["correct"]


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tpu_splat_torch_fake.x", object())
    assert sbrun.forbidden_modules() == [] or all(
        m.split(".")[0] in sbrun.FORBIDDEN for m in sbrun.forbidden_modules())
    monkeypatch.setitem(sys.modules, "tpu_splat.fake", object())
    assert "tpu_splat.fake" in sbrun.forbidden_modules()


IMPORT_CHECK = """
import sys
sys.path[:0] = [{bench!r}, {root!r}]
import {mods}
bad = sorted(m for m in sys.modules if m.split('.')[0] in {forbid!r})
print(bad)
"""


def _loaded_by(mods: str, forbid) -> list:
    code = IMPORT_CHECK.format(bench=str(BENCH), root=str(ROOT), mods=mods, forbid=forbid)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=300)
    return eval(out.stdout.strip().splitlines()[-1])


def test_the_harness_and_the_program_it_drives_import_no_jax():
    mods = ("run, control, sb_train, sb_render, sb_inputs, sb_trace, sb_counts, "
            "tpu_splat_torch.training.trainer, tpu_splat_torch.render")
    assert _loaded_by(mods, ("jax", "jaxlib", "flax", "tpu_splat")) == []


def test_the_reference_imports_nothing_of_the_program():
    assert _loaded_by("sb_reference, sb_counts", ("jax", "jaxlib", "flax", "tpu_splat",
                                                  "tpu_splat_torch")) == []


def test_a_run_without_a_card_fails_and_prints_no_result(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run([sys.executable, "splatbench/run.py", "--workload",
                          "garden-mcmc-1m.render", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_a_run_with_the_benchmark_alone_fails(tmp_path):
    """A directory that holds BENCHMARK.json and splatbench/ but not the program."""
    shutil.copytree(BENCH, tmp_path / "splatbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "splatbench/run.py", "--workload",
                          "garden-mcmc-1m.train", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
