"""The Trainer's input staging (`tpu_splat_torch/training/staging.py`) on the CPU.

`InputStaging.stage` against the host stack the Trainer built before it (`np.stack` of the
images, cameras and backgrounds as float32): the same values bit for bit, in buffers kept
across chunks of one shape (the same storage, one allocation), a shorter chunk in their
prefix, a new shape or a longer chunk in new buffers, the fill's threads stopped by
`close` and started again. A Trainer run over two whole chunks, a chunk cut by a progress
report and a single step against the same run fed the host stacks: the same parameters,
Adam moments and losses, bit for bit; the same for a batched run (`--batch-size` 2 and 4 on a
1x1 mesh). The pinned route is the card's
(`tests/test_torch_cuda.py::test_input_staging_pinned_on_card`).
"""

import types

import numpy as np
import pytest
import torch

from tpu_splat_torch.core.config import DatasetConfig, OptimizationParameters, TrainingParameters
from tpu_splat_torch.training import trainer
from tpu_splat_torch.training.staging import InputStaging

from synth_data import make_synthetic_colmap


def _chunk(rng, k, h, w):
    """k images, cameras and backgrounds as the Trainer holds them: images in the loader's
    memory order ([3, H, W] views of [H, W, 3]) and, every other one, contiguous; the
    cameras in float64 here, to cover the rounding to float32."""
    return ([rng.random((h, w, 3), dtype=np.float32).transpose(2, 0, 1) if i % 2 == 0
             else rng.random((3, h, w), dtype=np.float32) for i in range(k)],
            [rng.normal(size=(4, 4)) for _ in range(k)],
            [rng.normal(size=3) for _ in range(k)],
            [rng.random(3, dtype=np.float32) for _ in range(k)])


def _host_stack(images, w2cs, positions, backgrounds):
    """The inputs as the Trainer's dispatch stacked them before the staging buffers."""
    return tuple(torch.from_numpy(np.ascontiguousarray(np.stack(x), np.float32))
                 for x in (images, w2cs, positions, backgrounds))


def _assert_bits(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("k,slots", [(4, 4), (1, 4), (3, 8), (5, 1)])
def test_staged_chunk_equals_a_host_stack(k, slots):
    rng = np.random.default_rng(k * 10 + slots)
    st = InputStaging(torch.device("cpu"), slots)
    chunk = _chunk(rng, k, 6, 10)
    got = st.stage(*chunk)
    _assert_bits(got, _host_stack(*chunk))
    assert st.allocs == 1 and st.waits == 0 and not st.pinned
    # every step of a chunk reads contiguous views, as the stack's slices were
    assert all(x[j].is_contiguous() for x in got for j in range(k))


def test_staging_reuses_its_buffers_per_shape():
    rng = np.random.default_rng(3)
    st = InputStaging(torch.device("cpu"), 4)
    first = st.stage(*_chunk(rng, 4, 6, 10))
    ptrs = (first[0].data_ptr(), first[1].data_ptr())
    chunk = _chunk(rng, 4, 6, 10)
    again = st.stage(*chunk)
    assert (again[0].data_ptr(), again[1].data_ptr()) == ptrs and st.allocs == 1
    _assert_bits(again, _host_stack(*chunk))
    cut = _chunk(rng, 2, 6, 10)  # a chunk cut short by a hook: the buffers' prefix
    got = st.stage(*cut)
    assert got[0].data_ptr() == ptrs[0] and len(got[0]) == 2 and st.allocs == 1
    _assert_bits(got, _host_stack(*cut))
    other = _chunk(rng, 4, 8, 10)  # another image shape: new buffers
    _assert_bits(st.stage(*other), _host_stack(*other))
    assert st.allocs == 2
    longer = _chunk(rng, 6, 8, 10)  # more steps than the buffers hold: new buffers
    _assert_bits(st.stage(*longer), _host_stack(*longer))
    assert st.allocs == 3
    back = _chunk(rng, 4, 8, 10)  # kept while they fit
    _assert_bits(st.stage(*back), _host_stack(*back))
    assert st.allocs == 3 and st.waits == 0
    st.close()  # the fill's threads stop; the next call starts them again
    assert st._pool is None
    _assert_bits(st.stage(*back), _host_stack(*back))
    st.close()


def _params(base, out):
    # chunks 1-4 and 5-8 whole, 9-10 cut by the progress report at 10, 11 a single step
    opt = OptimizationParameters(iterations=11, max_cap=256, refine_every=100,
                                 start_refine=500, eval_steps=[], save_steps=[],
                                 num_workers=1, scan_steps=4)
    return TrainingParameters(dataset=DatasetConfig(data_path=str(base), output_path=str(out)),
                              optimization=opt)


def _host_stacked_stage(self, samples, backgrounds):
    """The Trainer's inputs as numpy stacks, handed to `train_step_many` (and, sliced, to
    `train_step` and the batched step) as the Trainer did before the staging buffers."""
    cams = [s.camera for s in samples]
    return (np.stack([s.image for s in samples]),
            np.stack([c.world_view_transform for c in cams]).astype(np.float32),
            np.stack([c.cam_position for c in cams]).astype(np.float32),
            np.stack(backgrounds))


def test_trainer_through_staging_equals_host_stacks(tmp_path):
    base = tmp_path / "capture"
    make_synthetic_colmap(base, n_gauss=120, n_cams=6, size=48)
    runs = []
    for name in ("staged", "stacked"):
        t = trainer.Trainer(_params(base, tmp_path / name), device="cpu")
        if name == "stacked":
            t._stage = types.MethodType(_host_stacked_stage, t)
        t.train(progress_every=10)
        runs.append(t)
    staged, stacked = runs
    assert staged.steps_dispatched == stacked.steps_dispatched == 11
    assert staged.n_redo == stacked.n_redo == 0
    assert staged._loss_hist == stacked._loss_hist and len(staged._loss_hist) == 11
    for got, want in ((staged.state.splat.params(), stacked.state.splat.params()),
                      (staged.state.adam.exp_avg, stacked.state.adam.exp_avg),
                      (staged.state.adam.exp_avg_sq, stacked.state.adam.exp_avg_sq)):
        assert got.keys() == want.keys()
        for key in got:
            assert torch.equal(got[key], want[key]), key
    # one allocation for the whole-, cut- and single-step dispatches; staging is timed
    # inside the dispatch
    assert staged.stage_allocs == 1 and staged.stage_waits == 0
    assert 0 < staged.timings["stage"] < staged.timings["dispatch"]
    assert stacked.stage_allocs == 0
    assert staged._staging._pool is None  # `train` stopped the fill's threads


@pytest.mark.parametrize("batch", [2, 4])
def test_batched_trainer_through_staging_equals_host_stacks(tmp_path, batch):
    """`--batch-size B` on a 1x1 mesh takes its images, cameras and background through the
    staging buffers, allocated once for the run's one image shape, and trains to the same
    parameters, Adam moments and losses, bit for bit, as the same run fed the host stacks."""
    base = tmp_path / "capture"
    make_synthetic_colmap(base, n_gauss=120, n_cams=6, size=48)
    runs = []
    for name in ("staged", "stacked"):
        params = _params(base, tmp_path / name)
        params.optimization.iterations = 6
        params.optimization.batch_size = batch
        t = trainer.Trainer(params, device="cpu")
        if name == "stacked":
            t._stage = types.MethodType(_host_stacked_stage, t)
        t.train(progress_every=10)
        runs.append(t)
    staged, stacked = runs
    assert staged.mesh.shape == {"data": 1, "gauss": 1}
    assert staged.steps_dispatched == stacked.steps_dispatched == 6
    assert staged.samples_drawn == 6 * batch
    assert staged._loss_hist == stacked._loss_hist and len(staged._loss_hist) == 6
    for got, want in ((staged.state.splat.params(), stacked.state.splat.params()),
                      (staged.state.adam.exp_avg, stacked.state.adam.exp_avg),
                      (staged.state.adam.exp_avg_sq, stacked.state.adam.exp_avg_sq)):
        for key in want:
            assert torch.equal(got[key], want[key]), key
    assert staged.stage_allocs == 1 and stacked.stage_allocs == 0
    assert 0 < staged.timings["stage"] < staged.timings["dispatch"]
