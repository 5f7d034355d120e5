"""The reference against the program's plain path on the CPU, the work counts on cases
worked by hand, and the comparison that decides `correct` failing its control and the
planted faults."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest
import torch
from conftest import ROOT, tiny_cell

import control
import run as sbrun
import sb_counts
import sb_inputs as inp
import sb_reference as ref

BENCH_JSON = sbrun.read_json(ROOT / "BENCHMARK.json")


def _camera(w2c, focal, w, h):
    pos = (-w2c[:3, :3].T @ w2c[:3, 3]).astype(np.float32)
    return dict(w2c=torch.as_tensor(w2c), position=torch.as_tensor(pos), fx=focal, fy=focal,
                cx=w / 2.0, cy=h / 2.0, width=w, height=h)


def _feat(mx, my, conic, op, rgb):
    return torch.tensor([[mx, my, *conic, op, *rgb]], dtype=torch.float32)


def test_counts_of_two_stacked_splats_worked_by_hand():
    """One 16x16 tile; two flat splats over every pixel at opacity 0.995: after the first,
    T = 0.005; the second would take it to 2.5e-5 < 1e-4, so every pixel stops there.
    used 256, stops 256, one needed instance of two."""
    feat = torch.cat([_feat(8.0, 8.0, (1e-9, 0.0, 1e-9), 0.995, (1.0, 0.5, 0.25))] * 2)
    proj = dict(feat=feat, depth=torch.tensor([1.0, 2.0]), visible=torch.tensor([True, True]),
                rect=torch.tensor([[0, 0, 1, 1], [0, 0, 1, 1]]))
    cam = dict(width=16, height=16)
    img, c = ref.Frame(feat, proj, cam, 16).render()
    assert c == dict(used=256, stops=256, needed=1, rect=2)
    assert torch.allclose(img[:, 3, 5], torch.tensor([0.995, 0.4975, 0.24875]))
    work = dict(c, pixels=256, tiles=1, visible=2)
    ops, nbytes = sb_counts.blend_fwd(work, "f32")
    assert ops == 21 * 512 and nbytes == 36 + 256 * 16 + 8
    ops, nbytes = sb_counts.blend_bwd(work, "bf16_pack")
    assert ops == 21 * 512 + 47 * 256 and nbytes == (28 + 36) + 256 * 16 + 8
    assert sb_counts.expand(work) == (0.0, 4.0 * (12 * 2 + 13 * 2))


def test_roofline_share_arithmetic():
    # 67 GFLOP take 1 ms at the peak; in 2 ms that is 50%; bytes bound when larger
    assert sb_counts.roofline_pct(67e9, 0.0, 2e-3) == pytest.approx(50.0)
    assert sb_counts.roofline_pct(0.0, 3.35e9, 4e-3) == pytest.approx(25.0)
    assert sb_counts.roofline_pct(1.0, 1.0, 0.0) is None


def test_the_depth_key_orders_near_ties_by_gaussian():
    """Two splats whose depths share the key's top bits keep Gaussian order, as the
    packed sort key does (one tile: all but the last of 31 bits): Gaussian 0, one ulp
    farther, is blended first."""
    feat = torch.cat([_feat(8.0, 8.0, (1e-9, 0.0, 1e-9), 0.5, (1.0, 0.0, 0.0)),
                      _feat(8.0, 8.0, (1e-9, 0.0, 1e-9), 0.5, (0.0, 1.0, 0.0))])
    proj = dict(feat=feat, depth=torch.tensor([np.nextafter(np.float32(5), np.float32(6)), 5.0]),
                visible=torch.tensor([True, True]), rect=torch.tensor([[0, 0, 1, 1]] * 2))
    img, _ = ref.Frame(feat, proj, dict(width=16, height=16), 16).render()
    assert torch.allclose(img[:, 0, 0], torch.tensor([0.5, 0.25, 0.0]))


def _scene(seed=7, n=3000, w=96, h=64):
    params, alive = inp.make_scene(n, 4096, w, h, seed, "cpu")
    return params, alive


def test_reference_frame_matches_the_programs_plain_render(cpu):
    from tpu_splat_torch.core.splat import SplatState
    from tpu_splat_torch.render import render_view

    params, alive = _scene()
    state = SplatState(alive=alive, **params)
    w2c = inp.orbit_poses(3, inp.capture_views(3, 2, 0.03, 0.15), 1, 0.05, 0.3)[0]
    got = render_view(state, w2c, 96, 64, 60.0, device="cpu").image
    want, counts = ref.render(params, alive, _camera(w2c, ref.fov_focal(96, 60.0), 96, 64),
                              3, 16)
    assert counts["used"] > 10_000
    assert float((got - want).abs().max()) < 2e-5


def test_reference_step_matches_the_programs_plain_step(cpu):
    from tpu_splat_torch.core.splat import SplatState
    from tpu_splat_torch.training.train_step import (RasterPlan, StepConfig, init_train_state,
                                                     train_step)

    params, alive = _scene()
    w2c = inp.capture_views(4, 1, 0.03, 0.15)[0]
    focal = 0.85 * 96
    cam = _camera(w2c, focal, 96, 64)
    target, _ = ref.render(inp.perturbed(params, alive, 4, "cpu"), alive, cam, 3, 16)
    ts = init_train_state(SplatState(alive=alive, scene_scale=2.0, **params), device="cpu")
    ts.iteration = 3001
    noise = torch.zeros_like(params["means"])
    plan = RasterPlan(max_instances=1 << 16, k_max=4096, chunk=128, tile_size=16)
    _, stats = train_step(ts, target, w2c, cam["position"].numpy(), focal, focal, 48.0, 32.0,
                          np.zeros(3, np.float32), width=96, height=64, plan=plan,
                          opt=StepConfig(), total_iterations=30000, noise=noise)
    step = dict(degree=3, tile=16, lambda_dssim=0.2, scale_reg=0.01, opacity_reg=0.01,
                bg=torch.zeros(3))
    loss, grads, _ = ref.loss_and_grads(params, alive, cam, target, step)
    assert abs(float(stats.loss) - loss) < 1e-5 * loss


def test_reference_refinement_matches_the_programs(cpu):
    """MCMC's relocation and growth from one generator state: 200 dead slots of 3000
    relocated, 149 slots grown into the free ones (1.05 x 3000 is 3149.9998 in float32;
    max_cap 3150); the parameters, the
    alive slots and the moments (zeroed at the sources and the claimed slots, kept at
    the dead ones) as the program's `refine_step` leaves them; and at the cap, the
    sources read from the positions it leaves reproduce them from another generator."""
    from tpu_splat_torch.core.splat import SplatState
    from tpu_splat_torch.training.train_step import init_train_state, refine_step

    params, alive = _scene()
    params["opacity_raw"][:200] = -7.0
    ts = init_train_state(SplatState(alive=alive, scene_scale=2.0, **params), seed=11,
                          device="cpu")
    g = torch.Generator().manual_seed(5)
    m = {k: torch.rand(v.shape, generator=g) for k, v in params.items()}
    v = {k: torch.rand(v.shape, generator=g) for k, v in params.items()}
    ts.adam = dataclasses.replace(ts.adam, exp_avg=dict(m), exp_avg_sq=dict(v))
    g.set_state(ts.rng.get_state())
    got, info = refine_step(ts, min_opacity=0.005, max_cap=3150)
    opt = dict(min_opacity=0.005, max_cap=3150)
    p, m2, v2, alive2, n_dead, n_new = ref.mcmc_refine(params, m, v, alive, opt, g)
    assert (n_dead, n_new) == (int(info["n_relocated"]), int(info["n_new"])) == (200, 149)
    assert torch.equal(got.splat.alive, alive2)
    for k in ref.PARAMS:
        assert torch.allclose(got.splat.params()[k], p[k], rtol=1e-5, atol=1e-6), k
        assert torch.equal(got.adam.exp_avg[k], m2[k]) and torch.equal(got.adam.exp_avg_sq[k],
                                                                        v2[k]), k
    assert torch.equal(got.rng.get_state(), g.get_state())
    # at the cap (no growth), the relocation's draw read back from the positions the
    # program left reproduces its state from another generator state
    opt = dict(min_opacity=0.005, max_cap=3000)
    got, _ = refine_step(ts, min_opacity=0.005, max_cap=3000)
    sources, unmatched = ref.drawn_sources(params, alive, got.splat.means, opt)
    assert unmatched == 0 and int((sources >= 0).sum()) == 200
    for given in (sources, None):
        p3, *_ = ref.mcmc_refine(params, m, v, alive, opt, torch.Generator().manual_seed(6),
                                 given)
        assert torch.allclose(got.splat.means, p3["means"]) == (given is not None)


def _run(cell, dev, **kw):
    rec = sbrun.run_cell(cell, 2**31 + 101, 1.0, False, dev, time.perf_counter(), **kw)
    return rec, sbrun.result_line(BENCH_JSON, cell, rec, False, {})


@pytest.mark.parametrize("name", ["garden-mcmc-1m.train", "garden-mcmc-1m.render"])
def test_a_sound_run_is_correct_and_its_control_is_not(name, cpu):
    """The program at a CPU size passes the cell's limits; the reference one precision
    below the stated one, put in its place, fails one of them."""
    cell = tiny_cell(name)
    (r,) = control.readings(cell, [2**31 + 77], 1.0, cpu, [cell["control"]])
    assert r["correct"]
    low = r["controls"][cell["control"]]
    assert any(low[k] > lim for k, lim in cell["limits"].items())


def test_a_step_that_returns_its_state_unchanged_is_not_correct(cpu, monkeypatch):
    from tpu_splat_torch.training import train_step as ts_mod

    orig = ts_mod.train_step

    def unchanged(ts, *a, **kw):  # parameters and moments as they came; the count moves on
        new, stats = orig(ts, *a, **kw)
        return dataclasses.replace(ts, iteration=new.iteration), stats

    monkeypatch.setattr(ts_mod, "train_step", unchanged)
    rec, res = _run(tiny_cell("garden-mcmc-1m.train"), cpu)
    assert not res["correct"] and rec["checks"]["grad_gap"] > 0.5


def test_a_loss_over_half_the_image_is_not_correct(cpu, monkeypatch):
    from tpu_splat_torch.training import train_step as ts_mod

    orig = ts_mod.photometric_loss

    def half(img, gt, lam):
        w = img.shape[-1] // 2
        return orig(img[..., :w], gt[..., :w], lam)

    monkeypatch.setattr(ts_mod, "photometric_loss", half)
    _, res = _run(tiny_cell("garden-mcmc-1m.train"), cpu)
    assert not res["correct"]


def _with_dead_slots(monkeypatch, n_dead=150):
    """The seeded scene with its first `n_dead` slots below MCMC's min_opacity, so that
    the compared steps' refinement relocates them."""
    orig = inp.make_scene

    def scene(*a, **kw):
        params, alive = orig(*a, **kw)
        params["opacity_raw"][:n_dead] = -7.0
        return params, alive

    monkeypatch.setattr(inp, "make_scene", scene)


def test_a_skipped_relocation_is_not_correct(cpu, monkeypatch):
    """The compared steps hold a refinement (resume_iteration + 1 on the schedule): with
    dead slots the program's run is correct, and a Trainer that skips the refinement
    (`refine_step` returning the state it was given) is not."""
    from tpu_splat_torch.training import trainer as tr_mod

    cell = tiny_cell("garden-mcmc-1m.train")
    assert ref.refining(cell["traffic"]["resume_iteration"] + 1,
                        cell["config"]["optimization"])
    _with_dead_slots(monkeypatch)
    rec, res = _run(cell, cpu)
    assert res["correct"] and rec["checks"]["relocated"][1] == 150
    assert rec["checks"]["unsourced"] == 0

    def skipped(ts, **kw):
        zero = torch.zeros((), dtype=torch.int32)
        return ts, dict(n_relocated=zero, n_new=zero, n_alive=ts.splat.n_alive())

    monkeypatch.setattr(tr_mod, "refine_step", skipped)
    rec, res = _run(cell, cpu)
    assert not res["correct"] and rec["checks"]["change_gap"] > 0.1
    assert rec["checks"]["unsourced"] == 150


def _redrawn_sources(monkeypatch, pick):
    """The program's refinement draws its sources by `pick(generator, probs, capacity)`
    after taking its own draw from the run's generator, as a draw on the card that does
    not repeat would."""
    from tpu_splat_torch.training import strategy_mcmc

    orig = strategy_mcmc._sample_sources

    def sample(generator, probs, capacity):
        orig(generator, probs, capacity)
        return pick(generator, probs, capacity)

    monkeypatch.setattr(strategy_mcmc, "_sample_sources", sample)


def test_a_draw_the_reference_cannot_repeat_is_read_not_redrawn(cpu, monkeypatch):
    """Sources drawn by opacity from another generator: the reference takes them from
    the program's state, and the run is correct."""
    other = torch.Generator().manual_seed(99)
    _redrawn_sources(monkeypatch, lambda g, probs, cap: torch.multinomial(
        probs, cap, replacement=True, generator=other))
    _with_dead_slots(monkeypatch)
    rec, res = _run(tiny_cell("garden-mcmc-1m.train"), cpu)
    assert res["correct"] and rec["checks"]["unsourced"] == 0


def test_a_relocation_from_a_dead_source_is_not_correct(cpu, monkeypatch):
    """Every dead slot (slot 0 among them) copied from slot 0, a dead slot, which no draw
    by opacity picks."""
    _redrawn_sources(monkeypatch, lambda g, probs, cap: torch.zeros(cap, dtype=torch.long))
    _with_dead_slots(monkeypatch)
    rec, res = _run(tiny_cell("garden-mcmc-1m.train"), cpu)
    assert not res["correct"] and rec["checks"]["unsourced"] == 150


def test_a_frame_altered_where_it_is_produced_is_not_correct(cpu):
    def alter(img):  # one colour channel 1% brighter
        img = img.copy()
        img[1] *= 1.01
        return img

    rec, res = _run(tiny_cell("garden-mcmc-1m.render"), cpu, alter=alter)
    assert not res["correct"]


def test_reference_gut_frame_matches_the_programs_plain_gut_render_unrotated(cpu):
    """3DGUT through a distorted pinhole (k1 = 0.05) on Gaussians without rotation, where
    the program's sigma points and the reference's coincide (with a rotation they do
    not: PERF.md, Open questions)."""
    from tpu_splat_torch.ops.cameras import CameraParams
    from tpu_splat_torch.ops.gut import rasterize_gut

    params, alive = _scene()
    params["rotation_raw"] = torch.zeros_like(params["rotation_raw"])
    params["rotation_raw"][:, 0] = 1.0
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
