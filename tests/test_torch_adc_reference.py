"""The port's ADC strategy held to the plain reference `tests/adc_reference.py` on seeded
random scenes at a small size (no JAX): the accumulation of a real step's screen
gradients, `grow_gs` with eps given (duplicates and splits, the pool short of slots or
not), `prune_gs` before and after the first opacity reset, `reset_opacity`, and three
train steps with an ADC refinement between the first and second. Then the Trainer's ADC
pool: candidates that outnumber the free slots grow it, every one is granted, and the run
equals, bit for bit, one that started in the larger pool; MCMC's pool still stops at
`max_cap`."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import adc_reference as ref
from tpu_splat_torch.core.config import (DatasetConfig, OptimizationParameters,
                                         TrainingParameters)
from tpu_splat_torch.core.splat import PARAM_FIELDS, SplatState
from tpu_splat_torch.training import strategy_default as sd
from tpu_splat_torch.training import trainer as tr_mod
from tpu_splat_torch.training.optim import AdamState
from tpu_splat_torch.training.train_step import (RasterPlan, StepConfig, adc_refine_step,
                                                 init_train_state, train_step)
from utils import make_scene

ROOT = Path(__file__).resolve().parents[1]
PRESET = json.loads((ROOT / "parameter" / "default_optimization_params.json").read_text())
SIZE = 48
SCENE_SCALE = 10.0  # grow_scale3d x 10 = 0.1: about half the scene's Gaussians split


def _state(n=300, cap=512, seed=0):
    """A seeded scene of `n` Gaussians in `cap` slots, 5 units in front of the camera at
    the origin, with random Adam moments (so that a step's update is not sign(g))."""
    s = make_scene(n, seed)
    params = {k: torch.cat([torch.as_tensor(s[k]), torch.zeros((cap - n,) + s[k].shape[1:])])
              for k in PARAM_FIELDS}
    params["rotation_raw"][n:, 0] = 1.0
    alive = torch.arange(cap) < n
    g = torch.Generator().manual_seed(seed + 1)
    m = {k: 0.01 * torch.randn(v.shape, generator=g) for k, v in params.items()}
    v = {k: 1e-4 * torch.rand(v.shape, generator=g) + 1e-6 for k, v in params.items()}
    return params, alive, m, v


def _train_state(params, alive, m, v, iteration, stats=None):
    ts = init_train_state(SplatState(alive=alive, scene_scale=SCENE_SCALE, **params),
                          device="cpu")
    count, grad2d = stats if stats is not None else (ts.dens_count, ts.dens_grad2d)
    adam = AdamState(exp_avg=dict(m), exp_avg_sq=dict(v),
                     step_count={k: iteration - 1 for k in params})
    return dataclasses.replace(ts, adam=adam, iteration=iteration, dens_count=count,
                               dens_grad2d=grad2d)


def _camera():
    f = 0.5 * SIZE / np.tan(np.radians(30.0))
    return dict(w2c=torch.eye(4), position=torch.zeros(3), fx=f, fy=f, cx=SIZE / 2.0,
                cy=SIZE / 2.0, width=SIZE, height=SIZE)


def _target(params, alive, seed=3):
    shown = dict(params, sh0=params["sh0"] + 0.2 * torch.randn(
        params["sh0"].shape, generator=torch.Generator().manual_seed(seed)))
    img, _ = ref.sbref.render(shown, alive, _camera(), 3, 16)
    return img


def _port_step(ts, target):
    cam = _camera()
    cfg = StepConfig.from_params(OptimizationParameters.from_json(dict(PRESET)))
    return train_step(ts, target, cam["w2c"].numpy(), cam["position"].numpy(), cam["fx"],
                      cam["fy"], cam["cx"], cam["cy"], np.zeros(3, np.float32), width=SIZE,
                      height=SIZE, plan=RasterPlan(max_instances=1 << 16, k_max=4096,
                                                   chunk=128, tile_size=16),
                      opt=cfg, total_iterations=PRESET["iterations"])


def _stats(alive, seed=4):
    """99 steps of densification info: average gradients at 0.3 or 3 x grad_threshold,
    far from it on either side."""
    g = torch.Generator().manual_seed(seed)
    high = torch.rand(alive.shape, generator=g) < 0.4
    avg = torch.where(high, 3.0, 0.3) * PRESET["grad_threshold"]
    count = 99.0 * alive.float()
    return count, count * avg


def test_accumulation_of_a_step_matches_the_reference():
    params, alive, m, v = _state()
    ts = _train_state(params, alive, m, v, 7100)
    got, _ = _port_step(ts, _target(params, alive))
    count, grad2d = ts.dens_count, ts.dens_grad2d
    _, *_, want_count, want_grad = ref.train_step(
        params, m, v, {k: 7099 for k in params}, alive, count, grad2d, _camera(),
        _target(params, alive), 7100, PRESET, SCENE_SCALE)
    assert torch.equal(got.dens_count, want_count) and want_count.sum() > 200
    torch.testing.assert_close(got.dens_grad2d, want_grad, rtol=1e-4,
                               atol=1e-5 * float(want_grad.max()))
    assert float((want_grad / want_count.clamp_min(1)).max()) > PRESET["grad_threshold"]


@pytest.mark.parametrize("n_alive", [300, 400], ids=["roomy", "short"])
def test_grow_gs_matches_the_reference(n_alive):
    """Duplicates and splits with eps given; with 400 of 512 slots alive the free slots
    hold the duplicates and only the best splits."""
    params, alive, m, v = _state(n_alive)
    count, grad2d = _stats(alive)
    avg = grad2d / torch.clamp_min(count, 1.0)
    eps = torch.randn((2, 512, 3), generator=torch.Generator().manual_seed(9))
    ts = _train_state(params, alive, m, v, 7101)
    st, adam, n_dup, n_split = sd.grow_gs(ts.splat, ts.adam, avg, PRESET["grad_threshold"],
                                          PRESET["grow_scale3d"], False, eps=eps)
    p, m2, v2, alive2, want_dup, want_split = ref.grow(
        params, m, v, alive, avg, PRESET["grad_threshold"], PRESET["grow_scale3d"],
        SCENE_SCALE, eps)
    assert (int(n_dup), int(n_split)) == (want_dup, want_split)
    assert want_dup > 10 and want_split > 10
    n_cand = int(sd.grad_candidates(alive, count, grad2d, PRESET["grad_threshold"]).sum())
    assert (want_dup + want_split < n_cand) == (n_alive == 400)
    assert torch.equal(st.alive, alive2)
    for k in PARAM_FIELDS:
        torch.testing.assert_close(st.params()[k], p[k], rtol=1e-6, atol=1e-6)
        assert torch.equal(adam.exp_avg[k], m2[k]) and torch.equal(adam.exp_avg_sq[k], v2[k])


@pytest.mark.parametrize("iteration", [2001, 7101], ids=["before-reset", "after-reset"])
def test_prune_gs_matches_the_reference(iteration):
    params, alive, m, v = _state()
    params["opacity_raw"][:20] = -7.0  # under prune_opacity
    params["rotation_raw"][20:25] = 1e-5  # degenerate
    params["scaling_raw"][25:45] = np.log(1.5)  # over prune_scale3d x scene_scale
    ts = _train_state(params, alive, m, v, iteration)
    st, n = sd.prune_gs(ts.splat, iteration, PRESET["prune_opacity"], PRESET["prune_scale3d"],
                        PRESET["reset_every"])
    want, want_n = ref.prune(params, alive, iteration, PRESET["prune_opacity"],
                             PRESET["prune_scale3d"], PRESET["reset_every"], SCENE_SCALE)
    assert torch.equal(st.alive, want) and int(n) == want_n
    assert want_n == (45 if iteration > PRESET["reset_every"] else 25)


def test_reset_opacity_matches_the_reference():
    params, alive, m, v = _state()
    ts = _train_state(params, alive, m, v, 9001)
    st, adam = sd.reset_opacity(ts.splat, ts.adam, PRESET["prune_opacity"])
    p, m2, v2 = ref.reset_opacity(params, m, v, PRESET["prune_opacity"])
    torch.testing.assert_close(st.opacity_raw, p["opacity_raw"], rtol=0, atol=1e-6)
    assert float((p["opacity_raw"] != params["opacity_raw"]).float().mean()) > 0.5
    for k in PARAM_FIELDS:
        assert torch.equal(adam.exp_avg[k], m2[k]) and torch.equal(adam.exp_avg_sq[k], v2[k])


def test_three_steps_with_a_refinement_match_the_reference():
    """Steps 7100-7102 with the refinement after 7100 (eps given): losses, the
    refinement's counts, the alive slots, the densification info and the parameters."""
    params, alive, m, v = _state()
    target = _target(params, alive)
    stats = _stats(alive)
    eps = torch.randn((2, 512, 3), generator=torch.Generator().manual_seed(9))
    ts = _train_state(params, alive, m, v, 7100, stats)
    kw = dict(grad_threshold=PRESET["grad_threshold"], grow_scale3d=PRESET["grow_scale3d"],
              prune_opacity=PRESET["prune_opacity"], prune_scale3d=PRESET["prune_scale3d"],
              reset_every=PRESET["reset_every"], revised_opacity=False)
    losses = []
    for j in range(3):
        if j == 1:
            ts, info = adc_refine_step(ts, eps=eps, **kw)
        ts, st = _port_step(ts, target)
        losses.append(float(st.loss))
    p, mm, vv, alive_r = params, m, v, alive
    counts = {k: 7099 for k in params}
    count, grad2d = stats
    want = []
    for j in range(3):
        if j == 1:
            avg = grad2d / torch.clamp_min(count, 1.0)
            p, mm, vv, alive_r, n_dup, n_split = ref.grow(
                p, mm, vv, alive_r, avg, kw["grad_threshold"], kw["grow_scale3d"],
                SCENE_SCALE, eps)
            alive_r, n_pruned = ref.prune(p, alive_r, 7101, kw["prune_opacity"],
                                          kw["prune_scale3d"], kw["reset_every"], SCENE_SCALE)
            count, grad2d = torch.zeros_like(count), torch.zeros_like(grad2d)
        loss, p, mm, vv, counts, count, grad2d = ref.train_step(
            p, mm, vv, counts, alive_r, count, grad2d, _camera(), target, 7100 + j, PRESET,
            SCENE_SCALE)
        want.append(loss)
    assert (int(info["n_dup"]), int(info["n_split"]), int(info["n_pruned"])) == \
        (n_dup, n_split, n_pruned)
    assert n_dup > 10 and n_split > 10
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    assert torch.equal(ts.splat.alive, alive_r)
    assert torch.equal(ts.dens_count, count)
    torch.testing.assert_close(ts.dens_grad2d, grad2d, rtol=1e-3,
                               atol=1e-4 * float(grad2d.max()))
    for k in PARAM_FIELDS:
        torch.testing.assert_close(ts.splat.params()[k], p[k], rtol=1e-4, atol=1e-5)


def _capture(tmp_path):
    from tpu_splat_torch.tools.synth_capture import make_raytraced_colmap

    base = tmp_path / "capture"
    make_raytraced_colmap(base, n_cams=6, size=32, n_sfm=200)
    return base


def _trainer(base, out, **fields):
    opt = OptimizationParameters.from_json(dict(
        PRESET, **dict(dict(iterations=12, refine_every=4, start_refine=2, stop_refine=11,
                            reset_every=8, grad_threshold=1e-6, eval_steps=[], save_steps=[],
                            num_workers=1, scan_steps=4), **fields)))
    params = TrainingParameters(dataset=DatasetConfig(data_path=str(base),
                                                      output_path=str(out)),
                                optimization=opt)
    return tr_mod.Trainer(params, device="cpu")


def test_adc_pool_grows_to_grant_every_candidate(tmp_path, monkeypatch):
    """200 SfM points in 256 slots (max_cap 256, MCMC's cap): the refinement at 4 has 200
    candidates for 56 free slots, so the pool moves to 512 slots and grants all 200; the
    one at 8, 400 for 112, moves it to 1024. The run equals, bit for bit, one started in
    512 slots (which grows at 8 alike)."""
    base = _capture(tmp_path)
    seen = []
    orig = tr_mod.adc_refine_step

    def counting(ts, **kw):
        seen.append(int(sd.grad_candidates(ts.splat.alive, ts.dens_count, ts.dens_grad2d,
                                           kw["grad_threshold"]).sum()))
        return orig(ts, **kw)

    monkeypatch.setattr(tr_mod, "adc_refine_step", counting)
    runs = []
    for max_cap in (256, 512):
        t = _trainer(base, tmp_path / f"out{max_cap}", max_cap=max_cap)
        assert t.state.splat.capacity == max_cap
        t.train(progress_every=100)
        runs.append(t)
    small, large = runs
    refines = [r for r in small.refine_log if r["kind"] == "adc"]
    assert [r["n_dup"] + r["n_split"] for r in refines] == seen[:2] and seen[0] > 56
    assert small.state.splat.capacity == 1024 > small.opt.max_cap
    assert (small.pool_grows, large.pool_grows) == (2, 1)
    assert small._loss_hist == large._loss_hist
    a, b = small.state, large.state
    for k in PARAM_FIELDS + ("alive",):
        assert torch.equal(getattr(a.splat, k), getattr(b.splat, k)), k
    for k in PARAM_FIELDS:
        assert torch.equal(a.adam.exp_avg[k], b.adam.exp_avg[k])
        assert torch.equal(a.adam.exp_avg_sq[k], b.adam.exp_avg_sq[k])
    assert torch.equal(a.dens_count, b.dens_count) and torch.equal(a.dens_grad2d,
                                                                  b.dens_grad2d)


def test_mcmc_pool_stops_at_max_cap(tmp_path):
    """MCMC grows 5% a refinement up to max_cap and no further: the pool keeps its
    2^k slots and grows none."""
    t = _trainer(_capture(tmp_path), tmp_path / "out", strategy="mcmc", max_cap=240,
                 iterations=40, stop_refine=39, min_opacity=0.005)
    t.train(progress_every=100)
    alive = [r["n_alive"] for r in t.refine_log if r["kind"] == "mcmc"]
    assert alive[0] > 200 and alive[-1] == 240 == max(alive)
    assert t.state.splat.capacity == 256 and t.pool_grows == 0
    assert "adc_refine" not in t.timings and "pool_grow" not in t.timings
