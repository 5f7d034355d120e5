"""The port's ADC strategy (`training/strategy_default.py`) and its train-step plumbing
against the JAX package, on the CPU.

Tolerances:
  `accumulate_densification`, `prune_gs`, `reset_opacity`, `is_refining`: exact.
  `grow_gs` and `refine` fed the JAX side's split-offset draw `eps`: alive masks, counts,
    optimizer moments and every row that is not a split child exactly; the split
    children's means and scales rtol 1e-6 (the offset is a 3-term float32 sum, the scale
    an exp/log pair, in another library). The fixtures have every claimed free slot above
    its candidate and slot C-1 alive, where the JAX version's two scatter faults do not
    show; each fault has its own test with the probe inputs that show it, and those pin
    the port's intended result by hand.
  Three ADC train steps: as `tests/test_torch_train_step.py::test_train_step_matches_jax`
    (losses rtol 1e-4, counters exactly, parameters on entries with a gradient, within
    4e-3 of the learning rate per step; `torch_fixtures.check_params_like_jax`);
    `dens_count` exactly;
    `dens_grad2d` rtol 2e-3 plus atol 1e-6 of its largest value (dL/dmean2d through two
    float32 rasterizers: the XLA scan lane and the port's plain versions).
  ADC under GUT: zero mean2d gradients on both sides, so the refine grows nothing.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_splat.ops.cameras import CameraParams as JaxCameraParams
from tpu_splat.training import strategy_default as jsd
from tpu_splat.training import train_step as jax_ts
from tpu_splat.training.optim import init_adam_state as jax_init_adam
from tpu_splat_torch import convert
from tpu_splat_torch.core.splat import PARAM_FIELDS
from tpu_splat_torch.ops.cameras import CameraParams
from tpu_splat_torch.training import strategy_default as sd
from tpu_splat_torch.training import train_step as ts_mod
from tpu_splat_torch.training.optim import AdamState

from chip_smoke import split_children
from torch_fixtures import check_params_like_jax, jax_splat, jax_state_fields, recorded_grads
from utils import make_camera

SIZE, TOTAL = 48, 100


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _port_splat(sj):
    return convert.splat_from_numpy({k: np.asarray(v) for k, v in sj.params().items()},
                                    np.asarray(sj.alive), sj.max_sh_degree, "cpu",
                                    sj.scene_scale)


def _port_adam(aj):
    nd = lambda d: {k: _t(v) for k, v in d.items()}  # noqa: E731
    return AdamState(exp_avg=nd(aj.exp_avg), exp_avg_sq=nd(aj.exp_avg_sq),
                     step_count={k: int(v) for k, v in aj.step_count.items()})


def _grow_fixture(n_alive, capacity=512, seed=5, ties=False, small_q=50):
    """A JAX state with slots [0, n_alive) and C-1 alive, random first moments, `small_q`
    percent of the alive splats below the dup/split scale line, and avg_grad over both
    sides of the
    threshold (slot C-1 never a candidate). ties: avg_grad on a few levels, so the
    stable order of equal priorities decides the grants."""
    rng = np.random.default_rng(seed)
    sj = jax_splat(n=n_alive, capacity=capacity, seed=seed)
    alive = np.asarray(sj.alive).copy()
    alive[-1] = True
    sj = dataclasses.replace(sj, alive=jnp.asarray(alive))
    adam = jax_init_adam(sj.params())
    adam = dataclasses.replace(adam, exp_avg={
        k: jnp.asarray(rng.normal(0, 1, v.shape).astype(np.float32))
        for k, v in adam.exp_avg.items()})
    max_scale = np.exp(np.asarray(sj.scaling_raw)).max(-1)
    grow_scale3d = float(np.percentile(max_scale[:n_alive], small_q) / sj.scene_scale)
    thr = 2e-4
    if ties:
        avg = rng.integers(0, 6, capacity).astype(np.float32) * np.float32(thr / 2)
    else:
        avg = rng.uniform(0, 3 * thr, capacity).astype(np.float32)
    avg[-1] = 0.0
    return sj, adam, avg, thr, grow_scale3d


def _split_children(sj, want_s) -> np.ndarray:
    """The rows the JAX result wrote as split children (`chip_smoke.split_children`)."""
    return split_children(np.asarray(sj.alive), np.asarray(sj.scaling_raw),
                          np.asarray(want_s.scaling_raw), np.asarray(sj.means),
                          np.asarray(want_s.means))


def _check_grown(got_state, got_adam, want_state, want_adam, child):
    """Rows of split children (`child`) within rtol 1e-6 on means and scales; every other
    entry exactly."""
    np.testing.assert_array_equal(got_state.alive.numpy(), np.asarray(want_state.alive))
    for k in PARAM_FIELDS:
        got, want = getattr(got_state, k).numpy(), np.asarray(getattr(want_state, k))
        if k in ("means", "scaling_raw"):
            np.testing.assert_array_equal(got[~child], want[~child], err_msg=k)
            np.testing.assert_allclose(got[child], want[child], rtol=1e-6, atol=1e-7,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
        np.testing.assert_array_equal(got_adam.exp_avg[k].numpy(),
                                      np.asarray(want_adam.exp_avg[k]), err_msg=k)
        np.testing.assert_array_equal(got_adam.exp_avg_sq[k].numpy(),
                                      np.asarray(want_adam.exp_avg_sq[k]), err_msg=k)


@pytest.mark.parametrize("n_alive,ties,revised", [(300, False, False), (300, True, True),
                                                  (400, True, False)])
def test_grow_gs_matches_jax(n_alive, ties, revised):
    sj, aj, avg, thr, g3d = _grow_fixture(n_alive, ties=ties, small_q=20 if n_alive == 400
                                          else 50)
    key = jax.random.key(3)
    eps = np.asarray(jax.random.normal(key, (2, sj.capacity, 3), jnp.float32))
    want_s, want_a, want_dup, want_split = jsd.grow_gs(sj, aj, key, jnp.asarray(avg), thr,
                                                       g3d, revised)
    got_s, got_a, n_dup, n_split = sd.grow_gs(_port_splat(sj), _port_adam(aj), _t(avg), thr,
                                              g3d, revised, eps=eps)
    assert (int(n_dup), int(n_split)) == (int(want_dup), int(want_split))
    assert int(n_dup) > 5 and int(n_split) > 5
    if n_alive == 400:  # capped: every free slot claimed, not every candidate granted
        assert int(got_s.n_alive()) == sj.capacity
        assert int(n_dup) + int(n_split) < int((avg > thr)[np.asarray(sj.alive)].sum())
    child = _split_children(sj, want_s)
    assert child.sum() == 2 * int(n_split)
    _check_grown(got_s, got_a, want_s, want_a, child)


def test_claim_free_slots_grants_the_last_slot():
    """JAX fault 1 (`_claim_free_slots` pads its free list with slot C-1, and the padding
    rows then clear `claimed[C-1]`): C = 8, slots 5 and 7 free, candidates 0 and 1 with
    priorities 2 and 1. The port gives slot 5 to candidate 0 and slot 7 to candidate 1."""
    alive = torch.tensor([1, 1, 1, 1, 1, 0, 1, 0], dtype=torch.bool)
    want = torch.tensor([1, 1, 0, 0, 0, 0, 0, 0], dtype=torch.bool)
    prio = torch.tensor([2.0, 1.0, 0, 0, 0, 0, 0, 0])
    src, claimed, granted = sd.claim_free_slots(alive, want, prio)
    assert claimed.tolist() == [False] * 5 + [True, False, True]
    assert src.tolist() == [0, 1, 2, 3, 4, 0, 6, 1]
    assert granted.tolist() == [True, True] + [False] * 6
    # through grow_gs: both small candidates duplicate, the copy of 1 lands in slot 7
    sj = jax_splat(n=8, capacity=8, seed=2)
    sp = dataclasses.replace(_port_splat(sj), alive=alive,
                             scaling_raw=torch.full((8, 3), -9.0))
    adam = _port_adam(jax_init_adam(sj.params()))
    avg = torch.tensor([3e-4, 2.5e-4, 0, 0, 0, 0, 0, 0])
    out, _, n_dup, n_split = sd.grow_gs(sp, adam, avg, 2e-4, 0.01, False,
                                        eps=np.zeros((2, 8, 3), np.float32))
    assert (int(n_dup), int(n_split)) == (2, 0)
    assert out.alive.all()
    for k in PARAM_FIELDS:
        assert torch.equal(getattr(out, k)[5], getattr(sp, k)[0]), k
        assert torch.equal(getattr(out, k)[7], getattr(sp, k)[1]), k


def test_split_below_its_free_slot_applies_child_a():
    """JAX fault 2 (`did_split` by a scatter that writes the candidate's index twice):
    C = 8, slot 0 the only free slot, split candidate 3. The port writes child B at slot 0
    and child A over slot 3, and counts one split."""
    alive = torch.tensor([0, 1, 1, 1, 1, 1, 1, 1], dtype=torch.bool)
    sj = jax_splat(n=8, capacity=8, seed=4)
    sp = dataclasses.replace(_port_splat(sj), alive=alive,
                             scaling_raw=torch.full((8, 3), -1.0))
    adam = _port_adam(jax_init_adam(sj.params()))
    adam = dataclasses.replace(adam, exp_avg={k: torch.ones_like(v)
                                              for k, v in adam.exp_avg.items()})
    avg = torch.tensor([0, 0, 0, 3e-4, 0, 0, 0, 0])
    eps = np.random.default_rng(1).normal(0, 1, (2, 8, 3)).astype(np.float32)
    out, out_adam, n_dup, n_split = sd.grow_gs(sp, adam, avg, 2e-4, 0.01, False, eps=eps)
    assert (int(n_dup), int(n_split)) == (0, 1) and out.alive.all()
    rot = sd.quat_to_rotmat(sp.rotation_raw[3:4])[0]
    scale = torch.exp(sp.scaling_raw[3])
    for child, slot in ((0, 3), (1, 0)):  # child A over the original, child B at slot 0
        want = sp.means[3] + rot @ (scale * torch.from_numpy(eps[child, 3]))
        torch.testing.assert_close(out.means[slot], want, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(out.scaling_raw[slot], torch.log(scale / 1.6))
        for k in ("sh0", "shN", "rotation_raw", "opacity_raw"):
            assert torch.equal(getattr(out, k)[slot], getattr(sp, k)[3]), k
        for k in PARAM_FIELDS:  # both children start with zero moments
            assert not out_adam.exp_avg[k][slot].any(), k
    assert out_adam.exp_avg["means"][1].eq(1).all()


def test_prune_reset_accumulate_and_schedule_match_jax():
    rng = np.random.default_rng(8)
    sj = jax_splat(n=400, capacity=512, seed=8)
    op = rng.uniform(-7.0, 3.0, (512, 1)).astype(np.float32)
    op[::17] = np.log(0.005 / 0.995)  # at the prune threshold
    q = np.asarray(sj.rotation_raw).copy()
    q[::23] = 1e-5  # degenerate quaternions
    sc = np.asarray(sj.scaling_raw).copy()
    sc[::11] += 4.0  # too big after the first reset
    sj = dataclasses.replace(sj, opacity_raw=jnp.asarray(op), rotation_raw=jnp.asarray(q),
                             scaling_raw=jnp.asarray(sc))
    sp = _port_splat(sj)
    for it in (2999, 3000, 3001):
        want_s, want_n = jsd.prune_gs(sj, it, 0.005, 0.1, 3000)
        got_s, got_n = sd.prune_gs(sp, it, 0.005, 0.1, 3000)
        assert int(got_n) == int(want_n) > 0, it
        np.testing.assert_array_equal(got_s.alive.numpy(), np.asarray(want_s.alive))
    assert int(sd.prune_gs(sp, 3001, 0.005, 0.1, 3000)[1]) > int(
        sd.prune_gs(sp, 3000, 0.005, 0.1, 3000)[1])

    aj = jax_init_adam(sj.params())
    aj = dataclasses.replace(aj, exp_avg={k: v + 1.0 for k, v in aj.exp_avg.items()})
    for prune_opacity in (0.005, 0.01, 0.1):
        want_s, want_a = jsd.reset_opacity(sj, aj, prune_opacity)
        got_s, got_a = sd.reset_opacity(sp, _port_adam(aj), prune_opacity)
        np.testing.assert_array_equal(got_s.opacity_raw.numpy(), np.asarray(want_s.opacity_raw))
        for k in PARAM_FIELDS:
            np.testing.assert_array_equal(got_a.exp_avg[k].numpy(),
                                          np.asarray(want_a.exp_avg[k]), err_msg=k)

    count = rng.integers(0, 9, 512).astype(np.float32)
    grad2d = rng.uniform(0, 1e-2, 512).astype(np.float32)
    g = (rng.normal(0, 1e-4, (512, 2)) * 10.0 ** rng.integers(-3, 3, (512, 1))).astype(
        np.float32)
    vis = rng.random(512) < 0.6
    for w, h in ((48, 48), (64, 48), (1296, 840)):
        want = jsd.accumulate_densification(jnp.asarray(count), jnp.asarray(grad2d),
                                            jnp.asarray(g), jnp.asarray(vis), w, h)
        got = sd.accumulate_densification(_t(count), _t(grad2d), _t(g), _t(vis), w, h)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    for args in ((500, 15000, 100, 3000, 0), (600, 15000, 100, 3000, 400),
                 (5, 40, 4, 12, 0), (5, 40, 4, 12, 3)):
        for it in range(0, 16000, 7) if args[1] > 100 else range(0, 60):
            assert sd.is_refining(it, *args) == jsd.is_refining(it, *args), (it, args)


@pytest.fixture(scope="module")
def refine_jit():
    return jax_ts.adc_refine_step


def test_adc_refine_step_matches_jax(refine_jit):
    sj, aj, avg, thr, g3d = _grow_fixture(300, seed=9, ties=True)
    rng = np.random.default_rng(9)
    count = rng.integers(0, 6, sj.capacity).astype(np.float32)
    dens = (avg * np.maximum(count, 1.0)).astype(np.float32)
    op = np.asarray(sj.opacity_raw).copy()
    op[:300:13] = -7.0  # pruned after the grow
    sj = dataclasses.replace(sj, opacity_raw=jnp.asarray(op))
    ts_j = jax_ts.init_train_state(sj, seed=2)
    ts_j = dataclasses.replace(ts_j, adam=aj, iteration=jnp.int32(3201),
                               dens_count=jnp.asarray(count), dens_grad2d=jnp.asarray(dens))
    eps = np.asarray(jax.random.normal(jax.random.split(ts_j.rng)[1], (2, sj.capacity, 3),
                                       jnp.float32))  # train_step.py:454, grow_gs :140
    kw = dict(grad_threshold=thr, grow_scale3d=g3d, prune_opacity=0.005, prune_scale3d=0.1,
              reset_every=3000, revised_opacity=False)
    want_ts, want_info = refine_jit(ts_j, **kw)
    ts_t = convert.train_state_from_numpy(**jax_state_fields(ts_j), device="cpu")
    got_ts, got_info = ts_mod.adc_refine_step(ts_t, eps=eps, **kw)
    assert {k: int(v) for k, v in got_info.items()} == {k: int(v)
                                                         for k, v in want_info.items()}
    assert int(got_info["n_pruned"]) > 10 and int(got_info["n_split"]) > 5
    assert not got_ts.dens_count.any() and not got_ts.dens_grad2d.any()
    assert got_ts.iteration == 3201 and ts_t.dens_count.any()  # the input is untouched
    child = _split_children(sj, want_ts.splat)
    assert child.sum() == 2 * int(got_info["n_split"])
    _check_grown(got_ts.splat, got_ts.adam, want_ts.splat, want_ts.adam, child)


@pytest.fixture(scope="module")
def adc_steps():
    """Three ADC train steps of each package from the same 256-slot state."""
    cams = [make_camera(SIZE, SIZE, fov_deg=55.0 + 5.0 * i) for i in range(3)]
    gt = np.random.default_rng(2).random((3, SIZE, SIZE)).astype(np.float32)
    plan_j = jax_ts.RasterPlan(max_instances=1 << 14, k_max=256, chunk=32)
    plan_t = ts_mod.RasterPlan(max_instances=1 << 14, k_max=256, chunk=32)
    cfg_j = jax_ts.StepConfig(strategy="default")
    cfg_t = ts_mod.StepConfig(strategy="default")
    kw = dict(width=SIZE, height=SIZE, total_iterations=TOTAL)
    ts_j = jax_ts.init_train_state(jax_splat(), seed=9)
    ts_t = convert.train_state_from_numpy(**jax_state_fields(ts_j), device="cpu")
    out = []
    compared = {k: torch.ones_like(v, dtype=torch.bool) for k, v in ts_t.splat.params().items()}
    for step, cam in enumerate(cams):
        cam_args = (cam["w2c"], cam["cam_position"], cam["fx"], cam["fy"], cam["cx"],
                    cam["cy"])
        ts_j, st_j = jax_ts.train_step(ts_j, jnp.asarray(gt), *cam_args, jnp.zeros(3),
                                       jnp.int32(step), plan=plan_j, opt=cfg_j, **kw)
        with recorded_grads() as calls:
            ts_t, st_t = ts_mod.train_step(ts_t, gt, *cam_args, np.zeros(3, np.float32), step,
                                           plan=plan_t, opt=cfg_t, **kw)
        for k, g in zip(PARAM_FIELDS, calls[0]):
            if g is not None:  # None: shN above the active degree, compared exactly
                compared[k] = compared[k] & (g.abs() > 1e-6 * g.abs().max())
        out.append((ts_j, st_j, ts_t, st_t, dict(compared)))
    return out


def test_adc_train_steps_match_jax(adc_steps):
    from tpu_splat_torch.training import optim

    g_before = None
    lrs = optim.group_lrs(ts_mod.StepConfig(), adc_steps[0][2].splat.scene_scale)
    for step, (ts_j, st_j, ts_t, st_t, compared) in enumerate(adc_steps):
        np.testing.assert_allclose(float(st_t.loss), float(st_j.loss), rtol=1e-4)
        for name in ("total_instances", "max_tile_count", "n_visible"):
            assert int(getattr(st_t, name)) == int(getattr(st_j, name)), name
        check_params_like_jax(ts_t, ts_j, compared, lrs, step + 1)
        assert ts_t.iteration == int(ts_j.iteration) == step + 2
        count = ts_t.dens_count.numpy()
        np.testing.assert_array_equal(count, np.asarray(ts_j.dens_count))
        assert count.max() == step + 1 and (count > 0).sum() > 50
        g_t, g_j = ts_t.dens_grad2d.numpy(), np.asarray(ts_j.dens_grad2d)
        np.testing.assert_allclose(g_t, g_j, rtol=2e-3, atol=1e-6 * g_j.max())
        assert g_before is None or (g_t >= g_before).all()
        g_before = g_t


def test_adc_under_gut_grows_nothing():
    """The GUT path takes no mean2d offset (tpu_splat/training/train_step.py:261-272), so
    ADC accumulates zero gradients there and its refine never grows, in both packages."""
    w, h = 32, 24
    cam = make_camera(w, h, fov_deg=60.0)
    gt = np.random.default_rng(3).random((3, h, w)).astype(np.float32)
    cam_args = (cam["w2c"], cam["cam_position"], cam["fx"], cam["fy"], cam["cx"], cam["cy"])
    plan = dict(max_instances=1 << 13, k_max=256)
    ts_j = jax_ts.init_train_state(jax_splat(n=100, capacity=128), seed=1)
    ts_t = convert.train_state_from_numpy(**jax_state_fields(ts_j), device="cpu")
    ts_j, _ = jax_ts.train_step(
        ts_j, jnp.asarray(gt), *cam_args, jnp.zeros(3), jnp.int32(0), width=w, height=h,
        plan=jax_ts.RasterPlan(**plan, chunk=32),
        opt=jax_ts.StepConfig(strategy="default", gut=True, cam_params=JaxCameraParams()),
        total_iterations=TOTAL)
    cfg = ts_mod.StepConfig(strategy="default", gut=True, cam_params=CameraParams())
    for i in range(2):
        ts_t, _ = ts_mod.train_step(ts_t, gt, *cam_args, np.zeros(3, np.float32), i, width=w,
                                    height=h, plan=ts_mod.RasterPlan(**plan, chunk=128),
                                    opt=cfg, total_iterations=TOTAL)
    assert not np.asarray(ts_j.dens_grad2d).any() and np.asarray(ts_j.dens_count).max() == 1
    assert not ts_t.dens_grad2d.any() and ts_t.dens_count.max() == 2
    n0 = int(ts_t.splat.n_alive())
    out, info = ts_mod.adc_refine_step(ts_t, grad_threshold=0.0, grow_scale3d=0.01,
                                       prune_opacity=0.0, prune_scale3d=1e9,
                                       reset_every=3000, revised_opacity=False)
    assert (int(info["n_dup"]), int(info["n_split"]), int(info["n_pruned"])) == (0, 0, 0)
    assert int(out.splat.n_alive()) == n0
