"""Numpy fixtures shared by the PyTorch port's tests; imports neither JAX nor the port."""

import numpy as np


def blend_fixture():
    """The 6-tile unaligned-segment fixture of test_blend_kernel_variants_parity."""
    rng = np.random.default_rng(3)
    TS, GW, GH, CH = 16, 3, 2, 256
    n_rows, max_chunks = 12, 2
    N = n_rows * CH
    s = rng.uniform(1.0, 4.0, N)
    ca = 1 / (s * s)
    cc = 1 / (s * s * rng.uniform(0.5, 2.0, N))
    feats = np.stack(
        [rng.uniform(0, GW * TS, N), rng.uniform(0, GH * TS, N), ca,
         rng.uniform(-0.3, 0.3, N) * np.sqrt(ca * cc), cc,
         rng.uniform(0.1, 1.0, N)] + [rng.uniform(0, 1, N)] * 3
        + [rng.uniform(1, 10, N)], 1).astype(np.float32)
    flat = np.zeros((16, N + max_chunks * CH + 128), np.float32)
    flat[:10, :N] = feats.T
    count = np.asarray([512, 512, 500, 512, 100, 300], np.int32)
    seg_start = np.asarray([0, 512, 1024, 1524, 2036, 2136], np.int32)
    return flat, seg_start, count, dict(n_tiles=GW * GH, grid_w=GW, tile_size=TS)


def to_jax_bf16(t):
    """A torch bfloat16 tensor as a JAX bfloat16 array with the same bits."""
    import jax.numpy as jnp
    import torch

    return jnp.asarray(t.contiguous().view(torch.int16).numpy()).view(jnp.bfloat16)


def emission_runs(seed=0, n=700, long_run=1500):
    """Random contiguous emission runs over n Gaussians: short runs, empty runs and one
    very long run. -> (counts, start, end, total), int32 arrays and an int."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 9, n).astype(np.int32)
    counts[rng.random(n) < 0.25] = 0
    counts[n // 3] = long_run
    counts[-3:] = 0  # the last owner is not the last Gaussian
    end = np.cumsum(counts).astype(np.int32)
    return counts, (end - counts).astype(np.int32), end, int(end[-1])
