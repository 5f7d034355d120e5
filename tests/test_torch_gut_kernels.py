"""GUT kernels of the PyTorch port on the CPU: K5 (world-ray blend forward), K6 (its
backward) and K7 (segmented prefix), each through its plain version, against the JAX
package's Pallas kernels in interpret mode and against independent oracles; K4 with
seventeen rows; both lanes of `segmented_grad_reduce`.

The Pallas GUT kernels read chunk-aligned [R, 32, 128] blocks; the port reads unaligned
segments of a [17, M] gather. Both are built here from the same sorted instances, so the
comparison covers the layout translation too. The Pallas lane normalises with
rsqrt(max(|v|^2, 1e-24)), the port with 1 / sqrt(max(|v|^2, 1e-24)): the same threshold,
another rounding.

Tolerances, each with its reason:
  K5 `out`/`chk`: atol 1e-5 on rgb, T and chk (cumprod against a log-space prefix, rsqrt
    against 1/sqrt), rtol 1e-4 on the accumulated depth (terms up to 10; XLA's CPU matmul
    that accumulates it is not always the full-float32 one);
  K6: max abs error <= 1e-4 of the largest absolute gradient of each feature group
    against the Pallas kernel (float32 sums over 256 pixels in another order, a reverse
    cumsum against suffix matmuls) and against autograd through the plain forward; unowned
    columns exactly zero;
  K7 / K4 / `segmented_grad_reduce`: rtol 1e-5, atol 1e-4 on unit-variance rows (only the
    order of float32 adds differs), as the JAX package's own parity test allows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_splat.ops.pallas import gut_kernels as jg
from tpu_splat.ops.pallas import raster as jr
from tpu_splat_torch.ops.cameras import CameraParams
from tpu_splat_torch.ops.cuda.gut_kernels import (NFEAT_GUT, gut_blend_backward,
                                                  gut_blend_backward_plain,
                                                  gut_blend_forward, gut_blend_forward_plain,
                                                  gut_blend_inputs)
from tpu_splat_torch.ops.cuda.raster import (SortedInstances, build_sorted_instances,
                                             segmented_grad_reduce, segred_prefix,
                                             segred_prefix_plain, segsum_emission)
from tpu_splat_torch.ops.gut import gut_feature_table, pixel_world_rays, ut_project

from chip_smoke import random_gut_segments
from torch_fixtures import emission_runs
from utils import make_scene

SIZE, TS, K_MAX, CHUNK = 48, 16, 384, 128
GROUPS = dict(M=slice(0, 9), gro=slice(9, 12), opacity=slice(12, 13), rgb=slice(13, 16),
              depth=slice(16, 17))


def _blend_case(model):
    """Sorted instances, the G_* table and the rays of a 48x48 view of 300 Gaussians
    crowded on the centre (so a tile's list takes three chunks), built by the port. No
    list exceeds the capacity: `align_segments` spills an overflowing tile's instances
    into the next tile's aligned range, which the port's unaligned segments do not copy."""
    scene = {k: torch.from_numpy(v) for k, v in make_scene(300, seed=21, spread=0.5).items()}
    scene["opacity_raw"] += 4.0  # opaque and large enough that pixels run into the stop
    scene["scaling_raw"] += 0.7
    cam_params = CameraParams(model=model, radial=(0.05, 0, 0, 0, 0, 0))
    intr = (12.0, 12.0, SIZE / 2, SIZE / 2) if model == "ortho" else (40.0, 40.0, 24.0, 24.0)
    w2c, cam_pos = torch.eye(4), torch.zeros(3)
    proj, comp = ut_project(scene["means"], scene["scaling_raw"], scene["rotation_raw"],
                            scene["opacity_raw"], scene["alive"], w2c, *intr, cam_params,
                            SIZE, SIZE, TS, None)
    grid = SIZE // TS
    inst = build_sorted_instances(proj, grid, grid, 1 << 12, TS)
    gtab = gut_feature_table(scene["means"], scene["scaling_raw"], scene["rotation_raw"],
                             scene["opacity_raw"], scene["sh0"], scene["shN"], cam_pos, 3,
                             proj, comp)
    rays = pixel_world_rays(w2c, cam_pos, *intr, cam_params, None, None, grid_w=grid,
                            grid_h=grid, tile_size=TS, width=SIZE, height=SIZE)
    assert 2 * CHUNK < int(inst.max_tile_count) <= K_MAX
    # the +inf power threshold passes every tile of every rect through the contribution
    # test, and K1 carries it through its float rows
    assert int(inst.tile_count.sum()) == int(inst.total_instances) < 1 << 12
    return inst, gtab, rays, grid * grid


def _jax_pack(inst, gtab, n_tiles, max_chunks):
    """The JAX side's chunk-aligned pack of the same instances, and for every column of
    the port's `flat` its aligned slot (-1 for columns that no tile owns)."""
    as_j = lambda x: jnp.asarray(x.numpy())
    inst_j = jr.SortedInstances(**{k: as_j(getattr(inst, k)) for k in jr.SortedInstances._fields
                                   if k != "gtab"}, gtab=None)
    row_start, count, aligned_gid, _, max_aligned, n_rows = jr.align_segments(
        inst_j, n_tiles, max_chunks)
    feats = jnp.pad(as_j(gtab).T[aligned_gid], ((0, 0), (0, jg.NFEAT_GUT - NFEAT_GUT)))
    packed = feats.reshape(n_rows, CHUNK, jg.NFEAT_GUT).transpose(0, 2, 1)
    slot = np.full(inst.sorted_gid.shape[0], -1, np.int64)
    for t in range(n_tiles):
        s0, c = int(inst.tile_start[t]), int(count[t])
        slot[s0:s0 + c] = int(row_start[t]) * CHUNK + np.arange(c)
    return packed, row_start, count, slot


@pytest.mark.parametrize("model", ["pinhole", "ortho"])  # rays 4 wide; 8 wide
def test_gut_blend_plain_matches_pallas_interpret(model):
    inst, gtab, rays, n_tiles = _blend_case(model)
    assert rays.shape[2] == (8 if model == "ortho" else 4)
    flat, seg_start, count, max_chunks = gut_blend_inputs(inst, gtab, k_max=K_MAX, chunk=CHUNK)
    assert max_chunks == 3
    kw = dict(n_tiles=n_tiles, tile_size=TS, max_chunks=max_chunks)
    packed, row_start, count_j, slot = _jax_pack(inst, gtab, n_tiles, max_chunks)
    np.testing.assert_array_equal(np.asarray(count_j), count.numpy())
    rays_j = jnp.asarray(rays.numpy())
    out_j, chk_j = jg.gut_blend_forward(packed, rays_j, row_start, count_j, interpret=True, **kw)

    out, chk = gut_blend_forward(flat, rays, seg_start, count, chunk=CHUNK, **kw)
    want = np.asarray(out_j)
    np.testing.assert_allclose(out.numpy()[..., :4], want[..., :4], rtol=0, atol=1e-5)
    np.testing.assert_allclose(out.numpy()[..., 4:], want[..., 4:], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(chk.numpy(), np.asarray(chk_j), rtol=0, atol=1e-5)
    visited = torch.arange(max_chunks) < ((count + CHUNK - 1) // CHUNK)[:, None, None]
    assert int(((chk == 0) & visited).any(-1).sum()) > 20  # pixels that ran into the stop
    assert float((chk[..., 2] > 0).float().mean()) > 0.003  # and pixels in a third chunk

    gout = np.random.default_rng(5).normal(0, 0.3, out.shape).astype(np.float32)
    gout[..., 5:] = 0
    gpacked = np.asarray(jg.gut_blend_backward(packed, rays_j, row_start, count_j, chk_j, out_j,
                                               jnp.asarray(gout), interpret=True, **kw))
    per_slot = gpacked[:, :NFEAT_GUT, :].transpose(1, 0, 2).reshape(NFEAT_GUT, -1)
    got = gut_blend_backward(flat, rays, seg_start, count, chk, out, torch.from_numpy(gout),
                             chunk=CHUNK, **kw).numpy()
    assert got.shape == (NFEAT_GUT, flat.shape[1])
    owned = slot >= 0
    assert owned.sum() == int(count.sum()) and (~owned).sum() > 100
    assert (got[:, ~owned] == 0).all()
    for name, rows in GROUPS.items():
        want_g = per_slot[rows][:, slot[owned]]
        scale = np.abs(want_g).max()
        assert scale > 0, name
        assert np.abs(got[rows][:, owned] - want_g).max() / scale <= 1e-4, name


@pytest.mark.parametrize("ray_width", [4, 8])
def test_gut_backward_plain_matches_autograd(ray_width):
    """Independent oracle: autograd through the plain forward (the decisions are
    constants of the graph, as in the kernels), on random unaligned segments."""
    (flat, rays, seg_start, count), kw = random_gut_segments(16, 128, 3, "cpu", ray_width)
    gout = torch.from_numpy(np.random.default_rng(2).normal(0, 0.3, (kw["n_tiles"], 256, 8))
                            .astype(np.float32))
    leaf = flat.clone().requires_grad_(True)
    with torch.enable_grad():
        out, chk = gut_blend_forward_plain.__wrapped__(leaf, rays, seg_start, count, **kw)
        (want,) = torch.autograd.grad((out * gout).sum(), leaf)
    got = gut_blend_backward_plain(flat, rays, seg_start, count, chk.detach(), out.detach(),
                                   gout, **kw)
    assert (out[:, :, 3] < 1e-3).any()  # some pixels ran into the stop
    for name, rows in GROUPS.items():
        assert float((got[rows] - want[rows]).abs().max() / want[rows].abs().max()) <= 1e-4, name
    owned = torch.zeros(flat.shape[1], dtype=torch.bool)
    for s0, c in zip(seg_start.tolist(), count.tolist()):
        owned[s0:s0 + c] = True
    assert bool((got[:, ~owned] == 0).all()) and int((~owned).sum()) > 0


def _segred_fixture(width):
    """The fixture of the JAX package's segmented-reduce parity test: 50 contiguous
    emission runs over 512 slots, some empty, some crossing 128-slot blocks; the tail
    slots repeat the last owner's rank. -> (ge [512, W], rank, seg_s, seg_e, used)"""
    rng = np.random.default_rng(7)
    n, max_inst = 50, 512
    counts = rng.integers(0, 40, n)
    counts[rng.random(n) < 0.2] = 0
    counts = (counts * (max_inst - 1) // max(counts.sum(), 1)).astype(np.int32)
    seg_e = np.cumsum(counts).astype(np.int32)
    seg_s = (seg_e - counts).astype(np.int32)
    used = int(counts.sum())
    rank = np.repeat(np.arange(n, dtype=np.int32), counts)
    rank = np.pad(rank, (0, max_inst - used), constant_values=int(np.nonzero(counts)[0][-1]))
    ge = rng.normal(0, 1, (max_inst, width)).astype(np.float32)
    assert (counts == 0).sum() > 3 and used < max_inst - 20
    assert any(s // 128 != (e - 1) // 128 for s, e in zip(seg_s, seg_e) if e > s)
    return ge, rank, seg_s, seg_e, used


@pytest.mark.parametrize("width", [10, 17])
def test_segred_prefix_plain_matches_pallas_interpret(width):
    ge, rank, seg_s, seg_e, used = _segred_fixture(width)
    want = np.asarray(jr.segred_prefix_pallas(jnp.asarray(ge), jnp.asarray(rank), exact=True,
                                              interpret=True))
    got = segred_prefix(torch.from_numpy(ge.T.copy()), torch.from_numpy(rank)).numpy().T
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    # a sequential oracle; the tail rows (nonzero here) join the last owner's run, which
    # is why the per-Gaussian total is read at the run's last real slot
    oracle = np.zeros_like(ge, dtype=np.float64)
    for i in range(len(ge)):
        oracle[i] = ge[i] + (oracle[i - 1] if i and rank[i] == rank[i - 1] else 0)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-4)
    last = int(seg_e[rank[-1]]) - 1
    assert np.abs(got[-1] - got[last]).max() > 0.1


@pytest.mark.parametrize("width", [10, 17])
def test_segmented_grad_reduce_lanes_match_jax_and_oracle(width):
    ge, rank, seg_s, seg_e, used = _segred_fixture(width)
    ge[used:] = 0  # unowned slots carry zero gradient rows on both sides
    rng = np.random.default_rng(8)
    # JAX side: rows live in 640 aligned slots, `qem` maps emission slots to them
    max_al = 640
    qem = np.full(len(ge), max_al, np.int32)
    qem[:used] = rng.permutation(max_al)[:used]
    ginst = rng.normal(0, 1, (max_al, width)).astype(np.float32)
    ginst[qem[:used]] = ge[:used]
    jargs = tuple(jnp.asarray(x) for x in (ginst, qem, rank, seg_s, seg_e))
    want_mm = np.asarray(jr.segmented_grad_reduce(*jargs, gather_dtype=jnp.float32,
                                                  impl="block_mm"))
    want_pallas = np.asarray(jr.segmented_grad_reduce(*jargs, gather_dtype=jnp.float32,
                                                      impl="pallas_mm"))
    # port side: rows in tile-sorted order, `sorted_emis` maps them to emission slots
    sorted_emis = rng.permutation(len(ge)).astype(np.int32)
    none = torch.zeros(0)
    inst = SortedInstances(
        sorted_tile_id=none, sorted_gid=none, sorted_emis=torch.from_numpy(sorted_emis),
        emis_rank=torch.from_numpy(rank), emis_start=torch.from_numpy(seg_s),
        emis_end=torch.from_numpy(seg_e), tile_start=none, tile_count=none,
        total_instances=none, max_tile_count=none, n_visible=none)
    gflat = torch.from_numpy(ge[sorted_emis].T.copy())
    oracle = np.stack([ge[s:e].sum(0) for s, e in zip(seg_s, seg_e)])
    for impl in ("segsum", "prefix"):
        got = segmented_grad_reduce(gflat, inst, impl).numpy().T
        assert got.shape == (50, width)
        np.testing.assert_allclose(got, oracle, rtol=1e-4, atol=1e-4, err_msg=impl)
        np.testing.assert_allclose(got, want_mm, rtol=1e-5, atol=1e-4, err_msg=impl)
        np.testing.assert_allclose(got, want_pallas, rtol=1e-5, atol=1e-4, err_msg=impl)
        assert (got[seg_e == seg_s] == 0).all()
    with pytest.raises(ValueError, match="impl"):
        segmented_grad_reduce(gflat, inst, "block_mm")


def test_segsum_plain_with_seventeen_rows_matches_numpy_oracle():
    counts, start, end, total = emission_runs()
    rows = np.random.default_rng(3).normal(0, 1, (17, total + 40)).astype(np.float32)
    got = segsum_emission(torch.from_numpy(rows), torch.from_numpy(start),
                          torch.from_numpy(end)).numpy()
    oracle = np.stack([rows[:, s:e].sum(1) for s, e in zip(start, end)], axis=1)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-4)
    assert got.shape == (17, len(counts)) and (got[:, counts == 0] == 0).all()
    with pytest.raises(ValueError, match="10 or 17"):
        segsum_emission(torch.zeros(12, 8), torch.from_numpy(start), torch.from_numpy(end))


def test_segred_prefix_plain_survives_ten_decades():
    """A run of tiny rows after a run twelve decades larger keeps its own precision: the
    scan restarts at every run head (differences of one long cumsum would lose it)."""
    rows = torch.cat([torch.full((10, 300), 1e6), torch.full((10, 300), 1e-7)], dim=1)
    rank = torch.cat([torch.zeros(300), torch.ones(300)]).to(torch.int32)
    got = segred_prefix_plain(rows, rank)
    np.testing.assert_allclose(got[:, -1].numpy(), 300e-7, rtol=1e-5)
    np.testing.assert_allclose(got[:, 299].numpy(), 300e6, rtol=1e-5)


def test_gut_kernel_wrappers_never_fall_back():
    """A tensor that is neither on the CPU nor a valid CUDA tensor raises; it is never
    handed to the plain version."""
    meta = dict(device="meta")
    i32 = lambda *shape: torch.zeros(shape, dtype=torch.int32, **meta)
    f32 = lambda *shape: torch.empty(shape, **meta)
    kw = dict(n_tiles=2, tile_size=16, max_chunks=1)
    with pytest.raises(ValueError, match="CUDA"):
        gut_blend_forward(f32(17, 64), f32(2, 256, 4), i32(2), i32(2), **kw)
    with pytest.raises(ValueError, match="CUDA"):
        gut_blend_backward(f32(17, 64), f32(2, 256, 8), i32(2), i32(2), f32(2, 256, 1),
                           f32(2, 256, 8), f32(2, 256, 8), **kw)
    with pytest.raises(ValueError, match="CUDA"):
        segred_prefix(f32(17, 64), i32(64))
    with pytest.raises(ValueError, match="CUDA"):
        segsum_emission(f32(17, 64), i32(5), i32(5))
    with pytest.raises(ValueError, match=r"\[17, M\]"):
        gut_blend_forward(torch.zeros(10, 64), torch.zeros(2, 256, 4), i32(2), i32(2), **kw)
    with pytest.raises(ValueError, match="4 or 8"):
        gut_blend_forward(torch.zeros(17, 64), torch.zeros(2, 256, 3),
                          torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=torch.int32),
                          **kw)
