"""The ADC refinement's host spans and counters on the CPU: a short `Trainer.train` under
`--strategy default` on a raytraced capture sums the host seconds of each refinement (the
candidate count, the pool's growth, the grow and prune, the counts' readback) into
`timings["adc_refine"]`, a part of `timings["hooks"]`, and of each growth into
`timings["pool_grow"]`; `pool_grows`, `adc_added` and `adc_pruned` match `refine_log`. A run
with no refinement, or under MCMC, has neither span."""

import pytest

from tpu_splat_torch.training import trainer as tr_mod

from test_torch_adc_reference import _capture, _trainer


def _check_counters(t):
    refines = [r for r in t.refine_log if r["kind"] == "adc"]
    assert t.adc_added == sum(r["n_dup"] + r["n_split"] for r in refines)
    assert t.adc_pruned == sum(r["n_pruned"] for r in refines)
    return refines


def test_adc_refinements_fill_their_spans_and_counters(tmp_path, monkeypatch):
    grows = []
    orig = tr_mod.grow_pool

    def counting(ts, capacity):
        grows.append(capacity)
        return orig(ts, capacity)

    monkeypatch.setattr(tr_mod, "grow_pool", counting)
    t = _trainer(_capture(tmp_path), tmp_path / "out", max_cap=256)
    assert "adc_refine" not in t.timings and "pool_grow" not in t.timings
    t.train(progress_every=100)
    refines = _check_counters(t)
    assert len(refines) == 2 and t.adc_added > 0 and t.adc_pruned > 0
    assert t.pool_grows == len(grows) == 2 and grows == [512, 1024]
    assert 0 < t.timings["pool_grow"] < t.timings["adc_refine"] <= t.timings["hooks"]


@pytest.mark.parametrize("fields", [dict(start_refine=20), dict(strategy="mcmc")],
                         ids=["adc-no-refinement", "mcmc"])
def test_no_adc_refinement_leaves_no_adc_span(fields, tmp_path):
    t = _trainer(_capture(tmp_path), tmp_path / "out", max_cap=256, **fields)
    t.train(progress_every=100)
    assert "adc_refine" not in t.timings and "pool_grow" not in t.timings
    assert not _check_counters(t) and t.adc_added == t.adc_pruned == t.pool_grows == 0
    assert t.timings["dispatch"] > 0


def test_refinements_without_growth_leave_no_growth_span(tmp_path):
    t = _trainer(_capture(tmp_path), tmp_path / "out", max_cap=2048)
    t.train(progress_every=100)
    assert len(_check_counters(t)) == 2 and t.adc_added > 0
    assert t.timings["adc_refine"] > 0 and "pool_grow" not in t.timings
    assert t.pool_grows == 0 and t.state.splat.capacity == 2048
