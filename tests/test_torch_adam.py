"""The fused Adam's dispatch on the CPU (no JAX): `training/optim.py::adam_step` runs its
chain of elementwise ops on CPU tensors, by default and under `impl="plain"`, bit for bit
the same, and launches no kernel; on a CUDA device it hands every trained leaf to one call
of `ops/cuda/adam.py::adam_kernel` (here a stand-in that runs the chain), shN left out
while it is frozen; both train steps pass their `impl` through `update_tail` to it. The
wrapper checks its arguments before any launch, its launch arguments carry the chain's
float32 scalars, and the source's constants are optim.py's. The kernel itself is held to
the chain on the card (`tests/test_torch_cuda.py`).

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_adam.py
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from tpu_splat_torch.ops.cuda import build
from tpu_splat_torch.ops.cuda.adam import adam_kernel, leaf_scalars
from tpu_splat_torch.training import optim
from tpu_splat_torch.training import train_step as train_step_mod

SHAPES = {"means": (3,), "sh0": (1, 3), "shN": (15, 3), "scaling_raw": (3,),
          "rotation_raw": (4,), "opacity_raw": (1,)}
LRS = {"means": 4e-4, "sh0": 0.0025, "shN": 0.0025 / 20, "scaling_raw": 0.005,
       "rotation_raw": 0.001, "opacity_raw": 0.05}


def _state(n=257, seed=0, counts=(6, 6, 6, 3, 900, 0)):
    """Parameters, gradients (zero on the dead tenth of the slots) and an Adam state with
    moments and per-group step counts that differ."""
    gen = torch.Generator().manual_seed(seed)
    dead = torch.rand((n,), generator=gen) < 0.1
    params, grads, m, v = {}, {}, {}, {}
    for k, shape in SHAPES.items():
        params[k] = torch.randn((n, *shape), generator=gen)
        g = torch.randn((n, *shape), generator=gen) * 1e-3
        grads[k] = torch.where(dead.view(-1, *[1] * len(shape)), 0.0, g)
        m[k] = torch.randn((n, *shape), generator=gen) * 1e-3
        v[k] = torch.randn((n, *shape), generator=gen).abs() * 1e-6
    return params, grads, optim.AdamState(exp_avg=m, exp_avg_sq=v,
                                          step_count=dict(zip(SHAPES, counts)))


def _chain(params, grads, state, iteration):
    """The step leaf by leaf through `_adam_plain`, written out: -> (params, m, v)."""
    out = ({}, {}, {})
    for k in params:
        if k == "shN" and iteration <= optim.SHN_WARMUP_ITERS:
            res = params[k], state.exp_avg[k], state.exp_avg_sq[k]
        else:
            c = state.step_count[k] + 1
            res = optim._adam_plain(params[k], grads[k], state.exp_avg[k],
                                    state.exp_avg_sq[k], LRS[k],
                                    optim._bias_correction(optim.BETA1, c),
                                    optim._bias_correction(optim.BETA2, c))
        for d, x in zip(out, res):
            d[k] = x
    return out


@pytest.mark.parametrize("impl", ["kernel", "plain"])
@pytest.mark.parametrize("iteration", [7, 1000, 1001, 7100])
def test_cpu_runs_the_chain_bit_for_bit(impl, iteration):
    params, grads, state = _state()
    before = {k: v.clone() for k, v in params.items()}
    launches = adam_kernel.launches
    got, st = optim.adam_step(params, grads, state, LRS, iteration, impl)
    want = _chain(params, grads, state, iteration)
    assert adam_kernel.launches == launches
    for k in SHAPES:
        for d_got, d_want in zip((got, st.exp_avg, st.exp_avg_sq), want):
            assert torch.equal(d_got[k], d_want[k]), k
        assert torch.equal(params[k], before[k])  # inputs untouched
        assert st.step_count[k] == state.step_count[k] + 1
    assert list(got) == list(SHAPES)
    frozen = iteration <= optim.SHN_WARMUP_ITERS
    assert (got["shN"] is params["shN"]) == frozen
    assert (st.exp_avg["shN"] is state.exp_avg["shN"]) == frozen
    assert not torch.equal(got["sh0"], params["sh0"])


def test_impl_is_checked():
    params, grads, state = _state(n=8)
    with pytest.raises(ValueError, match="impl must be one of"):
        optim.adam_step(params, grads, state, LRS, 7, "fused")


@pytest.mark.parametrize("iteration", [1000, 7100])
def test_the_card_route_takes_one_call_of_the_trained_leaves(monkeypatch, iteration):
    """With the kernel taken (CUDA leaves; the test forces the decision), `adam_step`
    calls `adam_kernel` once with the trained leaves in the parameters' order, their
    learning rates and bias corrections, and assembles its outputs as the chain does;
    shN, frozen at 1000, is not handed over and comes back as the same tensors."""
    calls = []

    def stand_in(ps, gs, ms, vs, lrs, bc1s, bc2s):
        calls.append((len(ps), list(lrs), list(bc1s), list(bc2s)))
        outs = [optim._adam_plain(*leaf) for leaf in zip(ps, gs, ms, vs, lrs, bc1s, bc2s)]
        return [o[0] for o in outs], [o[1] for o in outs], [o[2] for o in outs]

    monkeypatch.setattr(optim, "adam_kernel", stand_in)
    monkeypatch.setattr(optim, "takes_kernel", lambda params, impl: impl == "kernel")
    params, grads, state = _state()
    got, st = optim.adam_step(params, grads, state, LRS, iteration)
    frozen = iteration <= optim.SHN_WARMUP_ITERS
    trained = [k for k in SHAPES if not (frozen and k == "shN")]
    assert len(calls) == 1
    n, lrs, bc1s, bc2s = calls[0]
    assert n == len(trained) and lrs == [LRS[k] for k in trained]
    assert bc1s == [optim._bias_correction(optim.BETA1, state.step_count[k] + 1)
                    for k in trained]
    assert bc2s == [optim._bias_correction(optim.BETA2, state.step_count[k] + 1)
                    for k in trained]
    want = _chain(params, grads, state, iteration)
    for k in SHAPES:
        for d_got, d_want in zip((got, st.exp_avg, st.exp_avg_sq), want):
            assert torch.equal(d_got[k], d_want[k]), k
    assert (got["shN"] is params["shN"]) == frozen
    optim.adam_step(params, grads, state, LRS, iteration, "plain")
    assert len(calls) == 1


def test_takes_kernel_only_on_a_card_under_kernel():
    params, _, _ = _state(n=4)
    assert not optim.takes_kernel(params, "kernel")
    assert not optim.takes_kernel(params, "plain")


def test_leaf_scalars_are_the_chains_float32_values():
    """The learning rate rounded to float32, as the chain's `float(np.float32(lr))`, and
    each bias correction's float32 reciprocal, as PyTorch's CUDA division by a Python
    scalar takes it (`1.0f / (float)bc` on the host)."""
    lr, bc1, bc2 = 4.0e-4 * 0.731, optim._bias_correction(0.9, 7), \
        optim._bias_correction(0.999, 7)
    got = leaf_scalars(lr, bc1, bc2)
    assert got == (float(np.float32(lr)), float(np.float32(1) / np.float32(bc1)),
                   float(np.float32(1) / np.float32(bc2)))
    assert all(float(np.float32(x)) == x for x in got)
    assert leaf_scalars(0.05, 1.0, 1.0)[1:] == (1.0, 1.0)


def test_wrapper_checks_its_arguments_before_launching():
    params, grads, state = _state(n=16)
    k = list(SHAPES)
    leaves = [[params[x] for x in k], [grads[x] for x in k], [state.exp_avg[x] for x in k],
              [state.exp_avg_sq[x] for x in k]]
    scalars = [[1e-3] * 6, [0.5] * 6, [0.01] * 6]
    launches = adam_kernel.launches
    with pytest.raises(ValueError, match="contiguous CUDA tensor"):
        adam_kernel(*leaves, *scalars)
    double = [list(x) for x in leaves]
    double[1][2] = double[1][2].double()
    with pytest.raises(ValueError, match="leaf 2: grad must be float32"):
        adam_kernel(*double, *scalars)
    strided = [list(x) for x in leaves]
    strided[0][0] = torch.randn(3, 16).T
    with pytest.raises(ValueError, match="contiguous CUDA tensor"):
        adam_kernel(*strided, *scalars)
    shaped = [list(x) for x in leaves]
    shaped[3][4] = shaped[3][4][:8]
    with pytest.raises(ValueError, match="leaf 4: exp_avg_sq of shape"):
        adam_kernel(*shaped, *scalars)
    with pytest.raises(ValueError, match="1 to 6 leaves"):
        adam_kernel(*[x + x[:1] for x in leaves], *[s + s[:1] for s in scalars])
    with pytest.raises(ValueError, match="1 to 6 leaves"):
        adam_kernel([], [], [], [], [], [], [])
    with pytest.raises(ValueError, match="a leaf expected"):
        adam_kernel(*leaves, *scalars[:2], scalars[2][:5])
    assert adam_kernel.launches == launches


def test_the_entry_point_and_its_arguments_match_the_source():
    """`tpu_splat_adam(AdamArgs, stream)`, built by `build_all` from `csrc/adam.cu`; the
    ctypes structs have the C structs' fields in their order (80 bytes a leaf)."""
    assert build.ENTRY_POINTS["adam"] == ("tpu_splat_adam", (build.AdamArgs, ctypes.c_void_p))
    assert build.source_name("adam") == "adam"
    src = (build.SRC_DIR / "adam.cu").read_text()
    assert f"constexpr int kMaxLeaves = {build.ADAM_MAX_LEAVES};" in src
    body = re.search(r"struct AdamLeaf \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r"(\w+);", body)
    assert names == [f for f, _ in build.AdamLeaf._fields_]
    assert ctypes.sizeof(build.AdamLeaf) == 80
    assert ctypes.sizeof(build.AdamArgs) == 6 * 80 + 8
    assert 'extern "C" int tpu_splat_adam(AdamArgs args, cudaStream_t stream)' in src


def test_the_kernels_constants_are_the_chains():
    """Each constant of `csrc/adam.cu` is the float32 value of the Python number the
    chain's op takes: BETA1, 1.0 - BETA1, BETA2, 1.0 - BETA2 and EPS."""
    src = (build.SRC_DIR / "adam.cu").read_text()
    consts = {k: np.float32(float(v)) for k, v in
              re.findall(r"constexpr float (k\w+) = ([-0-9.e]+)f;", src)}
    want = {"kBeta1": optim.BETA1, "kOneMinusBeta1": 1.0 - optim.BETA1,
            "kBeta2": optim.BETA2, "kOneMinusBeta2": 1.0 - optim.BETA2, "kEps": optim.EPS}
    assert consts == {k: np.float32(v) for k, v in want.items()}


def _small_step(kind):
    """One step of a 100-Gaussian scene at 32x32 on the CPU through `train_step` or the
    batched step on a 1x1 mesh, as a function of `impl`."""
    from tpu_splat_torch.parallel import dryrun
    from tpu_splat_torch.parallel.mesh import make_mesh
    from tpu_splat_torch.parallel.step import make_batched_train_step

    scene = dryrun.Scene()
    gts, w2cs, cpos, intr = dryrun.cameras(scene)
    kw = dict(width=scene.width, height=scene.height, plan=dryrun.plan_for(scene, 1),
              opt=train_step_mod.StepConfig(), total_iterations=100)
    bg = np.zeros(3, np.float32)

    def run(impl):
        ts = train_step_mod.init_train_state(dryrun.random_splat(scene, "cpu"), seed=5,
                                             device="cpu")
        if kind == "train_step":
            return train_step_mod.train_step(ts, gts[0], w2cs[0], cpos[0], *intr[0], bg,
                                             impl=impl, **kw)
        step = make_batched_train_step(make_mesh(1))
        return step(ts, gts, w2cs, cpos, intr, bg, impl=impl, **kw)

    return run


@pytest.mark.parametrize("kind", ["train_step", "batched"])
def test_train_steps_pass_impl_through_update_tail_to_adam(monkeypatch, kind):
    seen = []
    real = train_step_mod.adam_step

    def recorder(*args):
        seen.append(args[5])
        return real(*args)

    monkeypatch.setattr(train_step_mod, "adam_step", recorder)
    run = _small_step(kind)
    launches = adam_kernel.launches
    results = [run(impl) for impl in ("plain", "kernel")]
    assert seen == ["plain", "kernel"]
    assert adam_kernel.launches == launches
    (a, _), (b, _) = results
    for k, v in a.splat.params().items():
        assert torch.equal(v, b.splat.params()[k]), k
