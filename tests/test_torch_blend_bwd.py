"""Training kernels of the PyTorch port on the CPU: K2's bf16 layout, K3 (blend
backward) and K4 (segment sum), each through its plain version, against the JAX package's
Pallas kernels in interpret mode and against independent oracles.

Tolerances, each with its reason:
  K2 bf16 `out`/`chk`: atol 1e-5 on rgb, T and chk, the f32 layout's tolerance (both
    sides rebuild the same float32 rows from the same bf16 bits; cumprod against the
    log-space prefix); the accumulated depth, whose terms are up to 10 where a colour's
    are below 1, rtol 1e-4 (XLA's CPU matmul that accumulates it is not always the
    full-float32 one: its error was seen to reach 5e-5 relative from one process to the
    next on the same inputs);
  the bf16 pack: bit-equal (two roundings of the same float32 values);
  K3: max abs error <= 1e-4 of the largest absolute gradient against the exact Pallas
    lane (float32 sums over 256 pixels in another order, a reverse cumsum against
    suffix matmuls) and against autograd through the plain forward; unowned columns
    exactly zero on both sides. With bf16 features the Pallas kernel rounds `gout` to
    bf16 in every lane (blend.py:624-625), so that case feeds both sides a bf16-valued
    `gout`;
  K4: rtol 1e-5 / atol 1e-4 against the Pallas kernel fed the same bf16-rounded rows
    (only the order of float32 adds differs), and against a float32 numpy oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_splat.ops.pallas.blend import blend_backward as jax_blend_backward
from tpu_splat.ops.pallas.blend import blend_forward as jax_blend_forward
from tpu_splat.ops.pallas.raster import SEGSUM_BLK, SEGSUM_WIN
from tpu_splat.ops.pallas.raster import segsum_emission as jax_segsum_emission
from tpu_splat_torch.ops.cuda.blend import (NFEAT, blend_backward, blend_backward_plain,
                                            blend_forward, blend_forward_plain,
                                            pack_features_bf16, unpack_features)
from tpu_splat_torch.ops.cuda.raster import segsum_emission

from torch_fixtures import blend_fixture, emission_runs, to_jax_bf16

EXACT = dict(basis_red=False, approx_recip=False, lowp=False, grad_dtype=jnp.float32)


def _fixture(layout):
    """The blend fixture in either layout, for both sides: (torch flat, jax flat,
    seg_start, count, kw). The fixture has unaligned segments, gaps and a capped tile."""
    flat, seg_start, count, kw = blend_fixture()
    count = count.copy()
    count[3] = 600  # past max_chunks * chunk = 512: the cap applies
    seg_start = seg_start.copy()
    seg_start[4:] += 100  # room for the longer tile, and a gap after it
    t = torch.from_numpy(flat)
    if layout == "bf16":
        t = pack_features_bf16(t[:NFEAT])
        return t, to_jax_bf16(t), seg_start, count, kw
    return t, jnp.asarray(flat), seg_start, count, kw


@pytest.mark.parametrize("chunk", [128, 256])
def test_blend_plain_bf16_matches_pallas_interpret(chunk):
    flat, jflat, seg_start, count, kw = _fixture("bf16")
    max_chunks = 512 // chunk
    want_out, want_chk = jax_blend_forward(
        jflat, jnp.asarray(seg_start), jnp.asarray(np.minimum(count, 512)),
        max_chunks=max_chunks, chunk=chunk, interpret=True, **kw)
    out, chk = blend_forward(flat, torch.from_numpy(seg_start), torch.from_numpy(count),
                             max_chunks=max_chunks, chunk=chunk, **kw)
    want_out = np.asarray(want_out)
    np.testing.assert_allclose(out.numpy()[..., :4], want_out[..., :4], rtol=0, atol=1e-5)
    np.testing.assert_allclose(out.numpy()[..., 4:], want_out[..., 4:], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(chk.numpy(), np.asarray(want_chk), rtol=0, atol=1e-5)
    # the bf16 rounding is visible: the f32 layout gives another image
    out32, _ = blend_forward(torch.from_numpy(blend_fixture()[0]), torch.from_numpy(seg_start),
                             torch.from_numpy(count), max_chunks=max_chunks, chunk=chunk, **kw)
    assert 1e-4 < float((out - out32).abs().max()) < 2e-2


def test_bf16_pack_is_bit_equal_to_jax():
    rng = np.random.default_rng(11)
    n = 1000
    gtab = (rng.normal(0, 1, (NFEAT, n)) * rng.choice([1e-3, 1.0, 700.0], (NFEAT, n))).astype(
        np.float32)
    got = pack_features_bf16(torch.from_numpy(gtab))

    def split(x):  # tpu_splat/ops/pallas/raster.py:856-858
        hi = x.astype(jnp.bfloat16)
        return hi, (x - hi.astype(jnp.float32)).astype(jnp.bfloat16)

    j = jnp.asarray(gtab)
    rows = [h for i in range(5) for h in split(j[i])] + [j[i].astype(jnp.bfloat16)
                                                        for i in range(5, 10)]
    want = jnp.pad(jnp.stack(rows, axis=1), ((0, 0), (0, 1)))  # [N, 16], as ptab
    np.testing.assert_array_equal(got.T.contiguous().view(torch.int16).numpy(),
                                  np.asarray(want.view(jnp.int16)))
    # hi + lo rebuilds mean and conic to ~2^-17; the single-bf16 rows to 2^-9
    back = unpack_features(got).numpy()
    np.testing.assert_allclose(back[:5], gtab[:5], rtol=2**-16, atol=0)
    np.testing.assert_allclose(back[5:], gtab[5:], rtol=2**-8, atol=0)


def _unowned(seg_start, count, cap, m):
    mask = np.ones(m, bool)
    for s, c in zip(seg_start, np.minimum(count, cap)):
        mask[s:s + c] = False
    return mask


@pytest.mark.parametrize("layout", ["f32", "bf16"])
def test_blend_backward_plain_matches_pallas_interpret(layout):
    flat, jflat, seg_start, count, kw = _fixture(layout)
    chunk, max_chunks = 256, 2
    kwj = dict(max_chunks=max_chunks, chunk=chunk, interpret=True, **kw)
    jargs = (jflat, jnp.asarray(seg_start), jnp.asarray(np.minimum(count, 512)))
    out_j, chk_j = jax_blend_forward(*jargs, **kwj)
    rng = np.random.default_rng(5)
    gout = rng.normal(0, 0.3, (kw["n_tiles"], 256, 8)).astype(np.float32)
    if layout == "bf16":
        gout = torch.from_numpy(gout).to(torch.bfloat16).to(torch.float32).numpy()
    want = np.asarray(jax_blend_backward(*jargs, chk_j, out_j, jnp.asarray(gout), **EXACT,
                                         **kwj))

    targs = (flat, torch.from_numpy(seg_start), torch.from_numpy(count))
    kwt = dict(max_chunks=max_chunks, chunk=chunk, **kw)
    out, chk = blend_forward(*targs, **kwt)
    got = blend_backward(*targs, chk, out, torch.from_numpy(gout), **kwt).numpy()
    assert got.shape == (NFEAT, flat.shape[1])
    scale = np.abs(want[:NFEAT]).max()
    assert np.abs(got - want[:NFEAT]).max() / scale <= 1e-4
    assert all(np.abs(want[f]).max() > 0 for f in range(NFEAT))  # every feature is live
    unowned = _unowned(seg_start, count, max_chunks * chunk, flat.shape[1])
    assert unowned.sum() > 100
    assert (got[:, unowned] == 0).all() and (want[:, unowned] == 0).all()


@pytest.mark.parametrize("tile_size,chunk", [(16, 128), (32, 256)])
def test_blend_backward_plain_matches_autograd(tile_size, chunk):
    """Independent oracle: autograd through the plain forward (the decisions are
    constants of the graph, as in the kernels)."""
    rng = np.random.default_rng(tile_size)
    gw, gh, max_chunks = 2, 2, 2
    n_tiles = gw * gh
    count = np.asarray([0, 37, max_chunks * chunk, chunk + 3], np.int32)
    seg_start = (np.cumsum(count) - count + np.arange(n_tiles) * 7).astype(np.int32)
    m = int(seg_start[-1] + count[-1]) + 5
    tile_of = np.zeros(m, np.int64)
    for t in range(n_tiles):
        tile_of[seg_start[t]:seg_start[t] + count[t]] = t
    s = rng.uniform(1.0, 6.0, m)
    ca, cc = 1 / (s * s), 1 / (s * s * rng.uniform(0.5, 2.0, m))
    flat = torch.from_numpy(np.stack([
        (tile_of % gw) * tile_size + rng.uniform(-4, tile_size + 4, m),
        (tile_of // gw) * tile_size + rng.uniform(-4, tile_size + 4, m),
        ca, rng.uniform(-0.3, 0.3, m) * np.sqrt(ca * cc), cc, rng.uniform(0.05, 1.2, m),
        *rng.uniform(0, 1, (3, m)), rng.uniform(1, 10, m)]).astype(np.float32))
    args = (torch.from_numpy(seg_start), torch.from_numpy(count))
    kw = dict(n_tiles=n_tiles, grid_w=gw, tile_size=tile_size, max_chunks=max_chunks,
              chunk=chunk)
    gout = torch.from_numpy(rng.normal(0, 0.3, (n_tiles, tile_size**2, 8)).astype(np.float32))

    leaf = flat.clone().requires_grad_(True)
    with torch.enable_grad():
        out, chk = blend_forward_plain.__wrapped__(leaf, *args, **kw)
        (want,) = torch.autograd.grad((out * gout).sum(), leaf)
    got = blend_backward_plain(flat, *args, chk.detach(), out.detach(), gout, **kw)
    assert (out[:, :, 3] < 1e-3).any()  # some pixels ran into the stop
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-4
    unowned = torch.from_numpy(_unowned(seg_start, count, max_chunks * chunk, m))
    assert bool((got[:, unowned] == 0).all())


def _segsum_inputs():
    counts, start, end, total = emission_runs()
    rng = np.random.default_rng(3)
    rows = torch.from_numpy(rng.normal(0, 1, (NFEAT, total + 40)).astype(np.float32))
    rows = rows.to(torch.bfloat16)  # the JAX kernel takes bf16 rows: round on both sides
    return counts, start, end, total, rows


def test_segsum_plain_matches_pallas_interpret():
    counts, start, end, total, rows = _segsum_inputs()
    n, m = len(counts), rows.shape[1]
    rank = np.concatenate([np.repeat(np.arange(n, dtype=np.int32), counts),
                           np.full(m - total, n - 1, np.int32)])
    jrows = jnp.pad(to_jax_bf16(rows), ((0, 16 - NFEAT), (0, 2 * SEGSUM_WIN)))
    jrows = jrows.at[:, total:].set(0)  # junk rows are zero on the JAX side
    jrank = jnp.concatenate([jnp.asarray(rank), jnp.full((2 * SEGSUM_WIN,), 2**30, jnp.int32)])
    nb = -(-n // SEGSUM_BLK)
    bidx = np.arange(nb) * SEGSUM_BLK
    ws = np.where(bidx < n, start[np.minimum(bidx, n - 1)], m).astype(np.int32)
    want = np.asarray(jax_segsum_emission(jrows, jrank[None, :], jnp.asarray(ws),
                                          interpret=True))[:NFEAT, :n]
    got = segsum_emission(rows.to(torch.float32), torch.from_numpy(start),
                          torch.from_numpy(end)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    assert (got[:, counts == 0] == 0).all() and (counts == 0).sum() > 100


def test_segsum_plain_matches_numpy_oracle():
    counts, start, end, total, rows = _segsum_inputs()
    r = rows.to(torch.float32)
    got = segsum_emission(r, torch.from_numpy(start), torch.from_numpy(end)).numpy()
    oracle = np.stack([r.numpy()[:, s:e].sum(1) for s, e in zip(start, end)], axis=1)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-4)
    assert counts.max() >= 1500 and got.shape == (NFEAT, len(counts))


def test_training_kernel_wrappers_never_fall_back():
    """A tensor that is neither on the CPU nor a valid CUDA tensor raises; it is never
    handed to the plain version."""
    meta = dict(device="meta")
    i32 = lambda *shape: torch.zeros(shape, dtype=torch.int32, **meta)
    f32 = lambda *shape: torch.empty(shape, **meta)
    with pytest.raises(ValueError, match="CUDA"):
        blend_forward(torch.empty((16, 64), dtype=torch.bfloat16, **meta), i32(2), i32(2),
                      n_tiles=2, grid_w=2, tile_size=16, max_chunks=1)
    with pytest.raises(ValueError, match="CUDA"):
        blend_backward(f32(10, 64), i32(2), i32(2), f32(2, 256, 1), f32(2, 256, 8),
                       f32(2, 256, 8), n_tiles=2, grid_w=2, tile_size=16, max_chunks=1)
    with pytest.raises(ValueError, match="CUDA"):
        segsum_emission(f32(10, 64), i32(5), i32(5))
    with pytest.raises(ValueError, match="float32"):
        blend_forward(torch.empty((10, 64), dtype=torch.float16), i32(2), i32(2), n_tiles=2,
                      grid_w=2, tile_size=16, max_chunks=1)
