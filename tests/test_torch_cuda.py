"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card (the kernels have no CPU mode) and skip without one.
They import neither JAX nor the JAX package, so they run where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: K1 exactly (integer bookkeeping and row copies); K2 `out` and `chk` atol 1e-5.
"""

import numpy as np
import pytest
import torch

from tpu_splat_torch.ops.cuda.blend import blend_forward, blend_forward_plain
from tpu_splat_torch.ops.cuda.raster import expand_emission, expand_emission_plain

from torch_fixtures import blend_fixture


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


@pytest.mark.cuda
def test_expand_kernel_matches_plain_on_card():
    _require_cuda()
    rng = np.random.default_rng(1)
    n, max_inst = 50_000, 1 << 20
    counts = rng.integers(0, 30, n).astype(np.int32)
    dev = torch.device("cuda")
    args = (torch.from_numpy(rng.normal(0, 1, (7, n)).astype(np.float32)).to(dev),
            torch.from_numpy(np.stack([counts, *rng.integers(0, 80, (3, n))]).astype(
                np.int32)).to(dev),
            torch.from_numpy(np.cumsum(counts).astype(np.int32)).to(dev))
    got = expand_emission(*args, max_inst)
    want = expand_emission_plain(*args, max_inst)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [128, 256])
def test_blend_kernel_matches_plain_on_card(chunk):
    _require_cuda()
    flat, seg_start, count, kw = blend_fixture()
    dev = torch.device("cuda")
    args = (torch.from_numpy(flat).to(dev), torch.from_numpy(seg_start).to(dev),
            torch.from_numpy(count).to(dev))
    out, chk = blend_forward(*args, max_chunks=512 // chunk, chunk=chunk, **kw)
    want_out, want_chk = blend_forward_plain(*args, max_chunks=512 // chunk, chunk=chunk, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want_out, rtol=0, atol=1e-5)
    torch.testing.assert_close(chk, want_chk, rtol=0, atol=1e-5)
