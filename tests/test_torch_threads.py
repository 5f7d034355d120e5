"""The plain versions of the blend kernels (K2, K3, K5, K6 as they run on the CPU) give the
same bits under one and under eight PyTorch threads, call after call, in a process that
has run the JAX package's Pallas kernels first (the module fixture runs the JAX blend in
interpret mode, and the pinhole case holds the plain forward against it at atol 1e-5).

Their decisions (sigma, alpha, the in-chunk cumprod, the 1e-4 stop) are elementwise ops
and an ordered scan; their sums over features and instances are elementwise products and
one-axis reductions (`ops/cuda/blend.py::weighted_features`, `feature_dot`,
`weight_grads`), never a BLAS contraction whose blocking may follow the thread count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_splat.ops.pallas.blend import blend_forward as jax_blend_forward
from tpu_splat_torch.ops.cuda.blend import (blend_backward_plain, blend_forward_plain,
                                            pack_features_bf16)
from tpu_splat_torch.ops.cuda.gut_kernels import (gut_blend_backward_plain,
                                                  gut_blend_forward_plain)

from chip_smoke import random_gut_segments
from torch_fixtures import blend_fixture

THREADS = (1, 8, 1, 8)
CHUNK, MAX_CHUNKS = 256, 2


@pytest.fixture(scope="module")
def jax_blend():
    """The JAX Pallas forward (interpret mode) of the pinhole fixture at chunk 256."""
    flat, seg_start, count, kw = blend_fixture()
    out, chk = jax_blend_forward(jnp.asarray(flat), jnp.asarray(seg_start),
                                 jnp.asarray(count), max_chunks=MAX_CHUNKS, chunk=CHUNK,
                                 interpret=True, tile_y0=jnp.int32(0), **kw)
    return np.asarray(out), np.asarray(chk)


def _under_threads(fn):
    """fn() under each thread count of THREADS; every result bit-equal to the first."""
    n = torch.get_num_threads()
    results = []
    try:
        for nt in THREADS:
            torch.set_num_threads(nt)
            results.append(fn())
    finally:
        torch.set_num_threads(n)
    for nt, res in zip(THREADS[1:], results[1:]):
        for name, a, b in zip(("out", "chk", "grad"), results[0], res):
            assert torch.equal(a, b), (nt, name, float((a - b).abs().max()))
    return results[0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blend_plains_ignore_the_thread_count(jax_blend, dtype):
    flat, seg_start, count, kw = blend_fixture()
    used = int((seg_start + count).max())
    table = torch.from_numpy(flat[:, :used].copy())
    if dtype == "bfloat16":
        table = pack_features_bf16(table[:10])
    args = (table, torch.from_numpy(seg_start), torch.from_numpy(count))
    kwt = dict(max_chunks=MAX_CHUNKS, chunk=CHUNK, **kw)
    gout = torch.from_numpy(np.random.default_rng(6).normal(
        0, 0.3, (kw["n_tiles"], kw["tile_size"] ** 2, 8)).astype(np.float32))

    def run():
        out, chk = blend_forward_plain(*args, **kwt)
        return out, chk, blend_backward_plain(*args, chk, out, gout, **kwt)

    out, chk, grad = _under_threads(run)
    assert torch.isfinite(grad).all() and grad.abs().max() > 0
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), jax_blend[0], rtol=0, atol=1e-5)
        np.testing.assert_allclose(chk.numpy(), jax_blend[1], rtol=0, atol=1e-5)


@pytest.mark.parametrize("ray_width", [4, 8])
def test_gut_plains_ignore_the_thread_count(jax_blend, ray_width):
    (flat, rays, seg_start, count), kw = random_gut_segments(16, 128, 5, "cpu",
                                                             ray_width=ray_width)
    gout = torch.from_numpy(np.random.default_rng(7).normal(
        0, 0.3, (kw["n_tiles"], 256, 8)).astype(np.float32))

    def run():
        out, chk = gut_blend_forward_plain(flat, rays, seg_start, count, **kw)
        return out, chk, gut_blend_backward_plain(flat, rays, seg_start, count, chk, out,
                                                  gout, **kw)

    out, chk, grad = _under_threads(run)
    assert torch.isfinite(grad).all() and grad.abs().max() > 0
    assert (chk[:, :, 1:] == 0).any() and (out[:, :, 3] < 0.5).any()  # pixels stop
