"""The cell `garden-adc-3m.train` on the CPU: the loop `train_adc` cut to a CPU size,
passing its limits where its controls fail them; the reader of its ADC span; and the
reference's refinement held to the program's."""

from __future__ import annotations

import dataclasses

import pytest
import torch
from conftest import tiny_cell

import control
import run as sbrun
import sb_reference_adc as adc
from test_splatbench_reference import _scene


def tiny_adc_cell() -> dict:
    """The cell at 3000 Gaussians in 4096 slots, 96x64, 4 views."""
    cell = tiny_cell("garden-adc-3m.train")
    cell["config"]["pool_slots"] = 4096
    return cell


def test_span_reader_reads_ms_a_refinement_or_nothing():
    reader = sbrun.load_metric("adc.refine_ms")
    rec = dict(kind="train", iterations=400, adc_refines=4,
               timings={"hooks": 1.0, "adc_refine": 0.2})
    assert reader.read(rec, {}) == pytest.approx(50.0)
    # a program that keeps no such span (the parent of the change that added it)
    assert reader.read(dict(rec, timings={"hooks": 1.0}), {}) is None
    assert reader.read(dict(rec, adc_refines=0), {}) is None
    assert reader.read(dict(kind="render", frames=10), {}) is None


def test_reference_refinement_matches_the_programs(cpu):
    """Duplicates, splits and prunes from one generator state: the parameters, alive
    slots and moments the program's `adc_refine_step` leaves, and the reference's
    decisions equal to those read from the program's state."""
    from tpu_splat_torch.core.splat import SplatState
    from tpu_splat_torch.training.train_step import adc_refine_step, init_train_state

    params, alive = _scene()
    cap = alive.shape[0]
    n = int(alive.sum())
    g = torch.Generator().manual_seed(3)
    params["scaling_raw"][: n // 4] += 1.0  # a quarter, most large enough to split
    params["opacity_raw"][n - 40:n] = -8.0  # forty under prune_opacity
    ts = init_train_state(SplatState(alive=alive, scene_scale=20.0, **params), seed=5,
                          device="cpu")
    m = {k: torch.rand(v.shape, generator=g) for k, v in params.items()}
    v = {k: torch.rand(v.shape, generator=g) for k, v in params.items()}
    stats = dict(count=99.0 * alive.float(),
                 grad2d=99.0 * alive.float() * 2e-4 * torch.exp(torch.randn(cap, generator=g)
                                                               - 1.5))
    ts = dataclasses.replace(ts, adam=dataclasses.replace(ts.adam, exp_avg=dict(m),
                                                          exp_avg_sq=dict(v)),
                             dens_count=stats["count"], dens_grad2d=stats["grad2d"],
                             iteration=7101)
    opt = dict(grad_threshold=2e-4, grow_scale3d=0.01, prune_opacity=0.005,
               prune_scale3d=0.1, reset_every=3000, revised_opacity=False)
    gen = torch.Generator().manual_seed(0)
    gen.set_state(ts.rng.get_state())
    got, info = adc_refine_step(ts, **opt)
    eps = torch.randn((2, cap, 3), generator=gen)
    p, m2, v2, alive2, n_dup, n_split = adc.grow(params, m, v, alive, stats, opt, 20.0, eps)
    alive2, n_pruned = adc.prune(p, alive2, 7100, opt, 20.0)
    assert (n_dup, n_split, n_pruned) == (int(info["n_dup"]), int(info["n_split"]),
                                          int(info["n_pruned"]))
    assert n_dup > 10 and n_split > 10 and n_pruned >= 40
    assert torch.equal(got.splat.alive, alive2)
    for k in adc.ref.PARAMS:
        assert torch.allclose(got.splat.params()[k], p[k], rtol=1e-5, atol=1e-6), k
        assert torch.equal(got.adam.exp_avg[k], m2[k]) and torch.equal(got.adam.exp_avg_sq[k],
                                                                        v2[k]), k
    before = dict(params, alive=alive)
    assert torch.equal(adc.decisions(before, dict(got.splat.params(), alive=got.splat.alive)),
                       adc.decisions(before, dict(p, alive=alive2)))


def test_a_sound_adc_run_is_correct_and_its_controls_are_not(cpu):
    """The program at a CPU size passes the cell's limits, with duplicates and splits in
    the compared refinement; the reference one precision below the stated one, and the
    reference that skips the refinement, each put in its place, fail one of them."""
    cell = tiny_adc_cell()
    (r,) = control.readings(cell, [2**31 + 77], 1.0, cpu, ["lowered", "norefine"])
    assert r["correct"], r
    for c in ("lowered", "norefine"):
        assert any(r["controls"][c][k] > lim for k, lim in cell["limits"].items()), (c, r)
    assert r["controls"]["norefine"]["grown_gap"] > 100 * cell["limits"]["grown_gap"]
