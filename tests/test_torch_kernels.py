"""Kernels K1 (instance expansion) and K2 (blend forward) of the PyTorch port.

On the CPU the port's wrappers run the kernels' plain versions; these are held against
the JAX package's Pallas kernels in interpret mode (as the JAX tests run them on the CPU)
and against its XLA lane. The CUDA kernels themselves are held against the plain versions
by tests/test_torch_cuda.py, which skips without a card, and by chip_smoke.py.

Tolerances: instance arrays exactly (integer bookkeeping and a stable sort); blend `out`
and `chk` atol 1e-5 (the plain version's cumprod against the kernel's log-space prefix).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_splat.ops.pallas.blend import blend_forward as jax_blend_forward
from tpu_splat.ops.pallas.raster import build_sorted_instances as jax_build_sorted_instances
from tpu_splat.ops.projection import project as jax_project
from tpu_splat_torch.ops.cuda.blend import blend_forward
from tpu_splat_torch.ops.cuda.raster import build_sorted_instances, expand_emission
from tpu_splat_torch.ops.projection import Projected

from torch_fixtures import blend_fixture

from utils import make_camera, make_scene

EXACT_FIELDS = ("sorted_tile_id", "tile_start", "tile_count", "total_instances",
                "max_tile_count", "n_visible", "emis_start", "emis_end")


def _jax_projected(n, seed, width, height, tile_size, n_scene, spread=1.0):
    """The JAX projection of make_scene(n) padded to n_scene Gaussians with dead ones."""
    scene = make_scene(n, seed, spread=spread)
    scene = {k: np.concatenate([v, np.zeros_like(v[:1]).repeat(n_scene - n, 0)])
             for k, v in scene.items()}  # alive False, so projected invisible
    cam = make_camera(width, height)
    keys = ("means", "scaling_raw", "rotation_raw", "opacity_raw", "sh0", "shN", "alive")
    return jax_project(*(jnp.asarray(scene[k]) for k in keys), cam["w2c"],
                       cam["cam_position"], cam["fx"], cam["fy"], cam["cx"], cam["cy"],
                       width, height, 3, tile_size=tile_size)


# Every case pads its scene to N_SCENE Gaussians and uses MAX_INST slots: the Pallas
# expansion's build depends on both, so it compiles once for the three cases.
N_SCENE, MAX_INST = 600, 4096


# (n, seed, width, height, tile_size, what the case exercises): "two" fills two 512-slot
# expansion windows, "windows" spreads over several, "sparse" fits in the first window
# and leaves the other windows empty (tile 32)
@pytest.mark.parametrize("case", [(300, 0, 64, 48, 16, "two"), (600, 1, 96, 64, 16, "windows"),
                                  (40, 2, 48, 32, 32, "sparse")])
@pytest.mark.parametrize("lane", ["pallas", "xla"])
def test_instances_match_jax(case, lane):
    n, seed, width, height, ts, what = case
    pj = _jax_projected(n, seed, width, height, ts, N_SCENE)
    gw, gh = -(-width // ts), -(-height // ts)
    want = jax_build_sorted_instances(pj, gw, gh, MAX_INST, ts, expand=lane)
    got = build_sorted_instances(Projected(*(torch.from_numpy(np.array(x)) for x in pj)),
                                 gw, gh, MAX_INST, ts)
    total = int(want.total_instances)
    windows = {"two": (512, 1024), "windows": (1024, MAX_INST), "sparse": (0, 512)}[what]
    assert windows[0] < total <= windows[1]
    for name in EXACT_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    # slots past `total` have no owner; the XLA lane (and the port) fill them with the
    # last owner, the Pallas lane with 0 — they sort to the tail, after position total
    upto = MAX_INST if lane == "xla" else total
    for name in ("sorted_gid", "sorted_emis", "emis_rank"):
        np.testing.assert_array_equal(getattr(got, name).numpy()[:upto],
                                      np.asarray(getattr(want, name))[:upto], err_msg=name)


def test_expand_plain_slots_are_exact():
    """K1's contract at slot level: owner and rect-walk index of every slot, the tail
    convention, and bit-exact row copies."""
    rng = np.random.default_rng(0)
    n, max_inst = 700, 4096
    counts = rng.integers(0, 12, n).astype(np.int32)
    counts[-5:] = 0  # the last owner is not the last Gaussian
    offs_incl = np.cumsum(counts).astype(np.int32)
    ftab = rng.normal(0, 1, (7, n)).astype(np.float32)
    itab = np.stack([counts, *rng.integers(0, 50, (3, n))]).astype(np.int32)
    frows, irows = expand_emission(torch.from_numpy(ftab), torch.from_numpy(itab),
                                   torch.from_numpy(offs_incl), max_inst)
    total = int(offs_incl[-1])
    owner = np.repeat(np.arange(n), counts)
    owner = np.concatenate([owner, np.full(max_inst - total, owner[-1])])
    k = np.arange(max_inst) - (offs_incl - counts)[owner]
    np.testing.assert_array_equal(irows[0].numpy(), owner)
    np.testing.assert_array_equal(irows[1].numpy(), k)
    np.testing.assert_array_equal(irows[2:].numpy(), itab[:, owner])
    np.testing.assert_array_equal(frows.numpy(), ftab[:, owner])
    assert (k[:total] < counts[owner[:total]]).all() and (k[total:] >= 0).all()


@pytest.mark.parametrize("chunk", [128, 256])
def test_blend_plain_matches_pallas_interpret(chunk):
    flat, seg_start, count, kw = blend_fixture()
    max_chunks = 512 // chunk
    want_out, want_chk = jax_blend_forward(
        jnp.asarray(flat), jnp.asarray(seg_start), jnp.asarray(count),
        max_chunks=max_chunks, chunk=chunk, interpret=True, **kw)
    # the port reads exactly [seg_start, seg_start + count): no padding columns
    used = int((seg_start + count).max())
    out, chk = blend_forward(torch.from_numpy(flat[:, :used].copy()),
                             torch.from_numpy(seg_start), torch.from_numpy(count),
                             max_chunks=max_chunks, chunk=chunk, **kw)
    want_out, want_chk = np.asarray(want_out), np.asarray(want_chk)
    np.testing.assert_allclose(out.numpy(), want_out, rtol=0, atol=1e-5)
    np.testing.assert_allclose(chk.numpy(), want_chk, rtol=0, atol=1e-5)
    # the fixture exercises early stops: stopped pixels checkpoint 0 in later chunks
    assert (want_chk[:, :, -1] == 0).any() and (want_out[:, :, 3] < 0.5).any()


def test_wrappers_never_fall_back():
    """A tensor that is neither on the CPU nor a valid CUDA tensor raises; it is never
    handed to the plain version."""
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        expand_emission(torch.empty((7, 4), **meta), torch.empty((4, 4), dtype=torch.int32, **meta),
                        torch.empty((4,), dtype=torch.int32, **meta), 512)
    with pytest.raises(ValueError, match="CUDA"):
        blend_forward(torch.empty((10, 64), **meta), torch.zeros(2, dtype=torch.int32, **meta),
                      torch.zeros(2, dtype=torch.int32, **meta), n_tiles=2, grid_w=2,
                      tile_size=16, max_chunks=1)
