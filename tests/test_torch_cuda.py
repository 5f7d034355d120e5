"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card (the kernels have no CPU mode) and skip without one.
They import neither JAX nor the JAX package, so they run where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: K1 exactly (integer bookkeeping and row copies); K2 `out` and `chk` atol 1e-5
in both layouts (rtol 1e-5 on the accumulated depth), its stop decisions (zero checkpoints)
exactly, also over a window of tile rows (`tile_y0` 3 and 17); K3 bit-equal on two launches, and max abs error <= 1e-4 of the
largest absolute gradient and unowned columns exactly zero (float32 pixel sums in another
order; the kernel takes the suffix as total minus prefix, the plain version as a reverse
running sum); K4 rtol 1e-5, atol 1e-5 of the rows' magnitude (order of float32 adds), and
bit-equal to the plain version on every run of at most LONG_RUN slots (the same adds in the
same order);
K5 as K2 and K6 as K3, for rays 4 and 8 wide, on random segments and on splats that graze
the kernels' warp ray cones through each camera model (a decision mismatch would show as a
whole instance's colour, far above 1e-5); K7 rtol 1e-5 plus 1e-5 of the prefix of the rows'
absolute values over the same run (a shuffle tree and a fold of block aggregates against
masked shifted adds: only the order of float32 adds differs); K4 and K7 also through the
emission->column index (rows in a random tile-sorted order), and the same bits on two
launches;
the train step (and the batched step on a 1x1 mesh) through the kernels against the same
step through the plain versions: loss rtol 1e-5; parameters atol 1e-5 on at least 99% of each group (Adam's first steps
move a parameter by lr * sign(g) where |g| is tiny, so a rounding-level difference in a
near-zero gradient moves that one parameter by a whole lr);
ADC's `dens_grad2d` through K3/K4 within 1e-3 of its largest value of the plain versions',
`dens_count` exactly; the ADC refine on the card bit-equal to the CPU's outside the split
children (rtol 1e-5 there); LPIPS on the card rtol 1e-3 of the CPU's; a checkpoint of a
card state bit for bit, the CUDA generator's state included; the Trainer's pinned input
staging bit for bit against a host stack, its refill waiting for an upload still queued;
the GUT projection kernels (`ut_project`, `pixel_world_rays`) against their plain chains on
every camera model: float fields rtol 1e-5 and atol 1e-5 on visible slots, the visibility
and tile rects equal but for at most 3 slots with a plain rect edge within 1e-4 of a tile
boundary, rays rtol 1e-5 (atol 1e-6); the chains' cuBLAS calls take the UT mean's fused
sequence (gemv2N, checked) at 2^16 slots and more, so the scenes hold 2^17 slots
(csrc/gut_project.cu), and the kernel is also held against the chain in float64, no
further from it than twice the float32 chain; neither kernel path synchronises;
the pinhole projection's kernels (`project`) against its plain chain: the forward bit-equal
(NaN where NaN) at SH 0-4 on 2^17 slots (the chain's `means @ w2c` through cuBLAS's gemvx,
checked, whose order the kernel repeats), the backward's six gradients within 1e-4 of each
leaf's largest (K3's convention), finite where the chain's are, zero on dead slots and above
the active degree, and no further from the chain in float64 than twice the float32 chain;
neither projection kernel synchronises; each launches once a train step, at SH 3 and at SH 4,
and a step with pose optimisation takes the chain;
the fused Adam (`csrc/adam.cu`) against `adam_step`'s chain: parameters and moments of every
leaf bit for bit at 1003 (a ragged count), 2^16 and 2^22 slots, SH 3 and 4, shN frozen at
iteration 1000 and trained at 7100, zero gradients and moments left unmoved, leaves that
start off a 16-byte boundary; one launch a train step, no synchronisation, and a
`ValueError` for a leaf that is not contiguous float32 on the parameters' card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_splat_torch.convert import splat_from_numpy
from tpu_splat_torch.ops.cuda.blend import (NFEAT, blend_backward, blend_backward_plain,
                                            blend_forward, blend_forward_plain,
                                            pack_features_bf16, unpack_features)
from tpu_splat_torch.ops import gut
from tpu_splat_torch.ops.cuda.gut_kernels import gut_blend_forward
from tpu_splat_torch.ops.cuda.gut_project import pixel_world_rays_kernel, ut_project_kernel
from tpu_splat_torch.ops.cuda.adam import adam_kernel
from tpu_splat_torch.ops.cuda.projection import project_backward_kernel, project_kernel
from tpu_splat_torch.ops.projection import project
from tpu_splat_torch.ops.cameras import CameraParams, bind_coeffs, fisheye_max_angle
from tpu_splat_torch.ops.cuda.raster import (LONG_RUN, emission_columns, expand_emission,
                                             expand_emission_plain, segred_prefix,
                                             segred_prefix_plain, segsum_emission,
                                             segsum_emission_plain)
from tpu_splat_torch.training.staging import InputStaging
from tpu_splat_torch.core.config import OptimizationParameters
from tpu_splat_torch.training.train_step import (RasterPlan, StepConfig, init_train_state,
                                                 train_step)

from chip_smoke import (adam_case, blend_pairs, check_adam, check_gut_kernels,
                        check_gut_projection, check_gut_rays, check_projection,
                        gut_border_segments, gut_test_cameras, projection_cotangents,
                        projection_grads, random_gut_segments, random_segments)
from torch_fixtures import blend_fixture, emission_runs


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


@pytest.mark.cuda
@pytest.mark.parametrize("borders", [False, True])
@pytest.mark.parametrize("layout", ["f32", "bf16"])
@pytest.mark.parametrize("tile_size,chunk", [(16, 128), (32, 256)])
def test_blend_backward_kernel_matches_plain_on_card(tile_size, chunk, layout, borders):
    """K2 and K3 against their plain versions on random segments; with `borders` the
    splats sit on the kernels' 8x4 warp sub-rectangle borders, a third of them with an
    opacity near 1/255. K2's stop decisions equal the plain version's (the same zero
    checkpoints and pair counts); K3 gives the same bits on two launches."""
    _require_cuda()
    dev = torch.device("cuda")
    (flat, seg_start, count), kw = random_segments(tile_size, chunk, 7, dev, borders)
    if layout == "bf16":
        flat = pack_features_bf16(flat)
    out, chk = blend_forward(flat, seg_start, count, **kw)
    want_out, want_chk = blend_forward_plain(flat, seg_start, count, **kw)
    torch.testing.assert_close(out[..., :4], want_out[..., :4], rtol=0, atol=1e-5)
    torch.testing.assert_close(out[..., 4:], want_out[..., 4:], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(chk, want_chk, rtol=0, atol=1e-5)
    assert torch.equal(chk == 0, want_chk == 0)
    feat = unpack_features(flat)
    pairs = blend_pairs(feat, seg_start, count, want_chk, **kw)
    assert blend_pairs(feat, seg_start, count, chk, **kw) == pairs
    assert pairs["stops"] > 0 and pairs["kept"] < pairs["walked"]
    gen = torch.Generator(device=dev).manual_seed(3)
    gout = 0.3 * torch.randn(out.shape, device=dev, generator=gen)
    args = (flat, seg_start, count, chk, out, gout)
    got = blend_backward(*args, **kw)
    assert torch.equal(got, blend_backward(*args, **kw))
    want = blend_backward_plain(*args, **kw)
    torch.cuda.synchronize()
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-4
    owned = torch.zeros(flat.shape[1], dtype=torch.bool, device=dev)
    for s0, c in zip(seg_start.tolist(), count.tolist()):
        owned[s0:s0 + c] = True
    assert bool((got[:, ~owned] == 0).all()) and int((~owned).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("tile_y0", [3, 17])
@pytest.mark.parametrize("layout", ["f32", "bf16"])
@pytest.mark.parametrize("tile_size,chunk", [(16, 128), (32, 256)])
def test_blend_kernels_with_tile_y0_match_plain_on_card(tile_size, chunk, layout, tile_y0):
    """K2 and K3 over a window of tile rows starting at `tile_y0` (the splats moved down
    with it) against their plain versions; the same tolerances as at tile_y0 = 0, and
    K2's stop decisions equal."""
    _require_cuda()
    dev = torch.device("cuda")
    (flat, seg_start, count), kw = random_segments(tile_size, chunk, 9, dev)
    flat = flat.clone()
    flat[1] += tile_y0 * tile_size
    if layout == "bf16":
        flat = pack_features_bf16(flat)
    kw = dict(kw, tile_y0=tile_y0)
    out, chk = blend_forward(flat, seg_start, count, **kw)
    want_out, want_chk = blend_forward_plain(flat, seg_start, count, **kw)
    torch.testing.assert_close(out[..., :4], want_out[..., :4], rtol=0, atol=1e-5)
    torch.testing.assert_close(out[..., 4:], want_out[..., 4:], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(chk, want_chk, rtol=0, atol=1e-5)
    assert torch.equal(chk == 0, want_chk == 0) and bool((want_chk == 0).any())
    gout = 0.3 * torch.randn(out.shape, device=dev,
                             generator=torch.Generator(device=dev).manual_seed(4))
    args = (flat, seg_start, count, chk, out, gout)
    got = blend_backward(*args, **kw)
    want = blend_backward_plain(*args, **kw)
    torch.cuda.synchronize()
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-4


def _check_gut_kernels_on_card(args, kw):
    """`chip_smoke.check_gut_kernels`: K5's out, chk, stop decisions and pair counts against
    the plain version's; K6 within 1e-4 of the largest gradient, bit-equal on two launches,
    unowned columns zero. Then: some pixels stop, and the cull skips pairs."""
    _, _, pairs = check_gut_kernels(args, kw, "card test")
    assert pairs["stops"] > 0 and pairs["kept"] < pairs["walked"]


@pytest.mark.cuda
@pytest.mark.parametrize("ray_width", [4, 8])
@pytest.mark.parametrize("tile_size,chunk", [(16, 128), (32, 128), (32, 256)])
def test_gut_blend_kernels_match_plain_on_card(tile_size, chunk, ray_width):
    _require_cuda()
    _check_gut_kernels_on_card(*random_gut_segments(tile_size, chunk, 11, torch.device("cuda"),
                                                    ray_width))


@pytest.mark.cuda
@pytest.mark.parametrize("model,tile_size,chunk", [("pinhole", 32, 128), ("fisheye", 16, 128),
                                                   ("ortho", 16, 256), ("rolling", 32, 256)])
def test_gut_blend_kernels_on_the_cull_border_on_card(model, tile_size, chunk):
    """Splats whose 1/255 ellipsoid grazes the kernels' warp ray cones, a third of them with
    an opacity near 1/255, through each GUT camera model: the cull changes no decision."""
    _require_cuda()
    _check_gut_kernels_on_card(*gut_border_segments(model, tile_size, chunk, 17,
                                                    torch.device("cuda")))


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows", [10, 17])
def test_segprefix_kernel_matches_plain_on_card(n_rows):
    _require_cuda()
    dev = torch.device("cuda")
    counts, _, _, total = emission_runs(seed=6, n=50_000, long_run=120_000)
    n = len(counts)
    last_owner = int(np.nonzero(counts)[0][-1])
    rank = np.concatenate([np.repeat(np.arange(n, dtype=np.int32), counts),
                           np.full(3000, last_owner, np.int32)])  # the tail convention
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = torch.randn((n_rows, rank.size), device=dev, generator=gen)
    rows *= torch.pow(10.0, torch.randint(-8, 3, (1, rank.size), device=dev, generator=gen))
    rank_t = torch.from_numpy(rank).to(dev)
    got = segred_prefix(rows, rank_t)
    want = segred_prefix_plain(rows, rank_t)
    magnitude = segred_prefix_plain(rows.abs(), rank_t)
    torch.cuda.synchronize()
    assert bool(((got - want).abs() <= 1e-5 * want.abs() + 1e-5 * magnitude).all())
    heads = torch.from_numpy(np.concatenate([[True], rank[1:] != rank[:-1]])).to(dev)
    assert torch.equal(got[:, heads], rows[:, heads])  # a run head holds its own row


@pytest.mark.cuda
def test_kernel_wrappers_raise_on_mixed_devices_on_card():
    _require_cuda()
    (flat, rays, seg_start, count), kw = random_gut_segments(16, 128, 1, "cuda")
    with pytest.raises(ValueError, match="CUDA"):
        gut_blend_forward(flat, rays.cpu(), seg_start, count, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        segred_prefix(flat, torch.zeros(flat.shape[1], dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows", [NFEAT, 17])
def test_segsum_kernel_matches_plain_on_card(n_rows):
    _require_cuda()
    dev = torch.device("cuda")
    counts, start, end, total = emission_runs(seed=4, n=50_000, long_run=40_000)
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = torch.randn((n_rows, total + 1000), device=dev, generator=gen)
    args = (rows, torch.from_numpy(start).to(dev), torch.from_numpy(end).to(dev))
    got = segsum_emission(*args)
    want = segsum_emission_plain(*args)
    torch.cuda.synchronize()
    scale = torch.from_numpy(np.sqrt(np.maximum(counts, 1)).astype(np.float32)).to(dev)
    assert bool(((got - want).abs() <= 1e-5 * want.abs() + 1e-5 * scale).all())
    assert bool((got[:, torch.from_numpy(counts == 0).to(dev)] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "bf16", "gut-segsum", "gut-prefix"])
def test_train_step_through_kernels_matches_plain_on_card(mode):
    _require_cuda()
    pack_bf16 = mode == "bf16"
    gut = mode.startswith("gut")
    rng = np.random.default_rng(0)
    n, cap, size = 3000, 4096, 128
    pts = rng.normal(0, 0.8, (n, 3)).astype(np.float32)
    pts[:, 2] += 5
    params = dict(
        means=pts, sh0=rng.normal(0, 0.5, (n, 1, 3)).astype(np.float32),
        shN=rng.normal(0, 0.05, (n, 15, 3)).astype(np.float32),
        scaling_raw=np.log(rng.uniform(0.02, 0.1, (n, 3))).astype(np.float32),
        rotation_raw=rng.normal(0, 1, (n, 4)).astype(np.float32),
        opacity_raw=rng.normal(0, 1, (n, 1)).astype(np.float32))
    pad = lambda x: np.concatenate([x, np.ones((cap - n,) + x.shape[1:], np.float32)])
    alive = np.arange(cap) < n
    splat = splat_from_numpy({k: pad(v) for k, v in params.items()}, alive, 3, "cuda")
    f = 0.5 * size / np.tan(np.radians(30.0))
    gt = rng.random((3, size, size)).astype(np.float32)
    plan = RasterPlan(max_instances=1 << 17, k_max=2048, chunk=256, tile_size=32,
                      pack_bf16=pack_bf16)
    args = (gt, np.eye(4, dtype=np.float32), np.zeros(3, np.float32), f, f, size / 2,
            size / 2, np.zeros(3, np.float32))
    opt = StepConfig(gut=gut, cam_params=CameraParams(radial=(0.05, 0, 0, 0, 0, 0)))
    kw = dict(width=size, height=size, plan=plan, opt=opt, total_iterations=100,
              noise=rng.normal(0, 1, (cap, 3)).astype(np.float32),
              segred_impl="prefix" if mode == "gut-prefix" else "segsum")
    results = []
    for impl in ("kernel", "plain"):
        ts = init_train_state(splat, seed=1)
        for _ in range(2):
            ts, stats = train_step(ts, *args, impl=impl, **kw)
        assert int(stats.total_instances) <= plan.max_instances
        assert int(stats.max_tile_count) <= plan.k_max
        results.append((float(stats.loss), ts))
    (loss_k, ts_k), (loss_p, ts_p) = results
    assert np.isfinite(loss_k) and abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    for k, v in ts_k.splat.params().items():
        off = ((v - ts_p.splat.params()[k]).abs() > 1e-5).float().mean()
        assert float(off) <= 1e-2, (k, float(off))


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["mcmc", "default", "gut"])
def test_batched_step_through_kernels_matches_plain_on_card(strategy):
    """The batched step (a 1x1 mesh, B = 2 cameras, a gather budget below the capacity)
    through the kernels against the same step through the plain versions: as the train
    step's test above, and ADC's densification counts exactly. "gut" is the MCMC step
    through the GUT blend (K5/K6 on the window's world rays, each camera's distortion
    coefficients passed as the Trainer passes them), K1/K4/K5/K6 launched twice a step."""
    _require_cuda()
    from tpu_splat_torch.ops.cuda import gut_kernels
    from tpu_splat_torch.parallel import dryrun
    from tpu_splat_torch.parallel.mesh import make_mesh
    from tpu_splat_torch.parallel.step import make_batched_train_step

    gut = strategy == "gut"
    scene = dryrun.Scene(n_gauss=3000, capacity=4096, width=128, height=96, tile_size=32,
                         chunk=256, scale=0.03)
    gts, w2cs, cpos, intr = dryrun.cameras(scene)
    plan = dataclasses.replace(dryrun.plan_for(scene, 1), gather_budget=3072)
    step = make_batched_train_step(make_mesh(1))
    if gut:
        opt = StepConfig(gut=True, cam_params=CameraParams())
        coeffs = CameraParams(radial=(0.05, -0.01, 0, 0, 0, 0), tangential=(0.001, 0.0))
        dist = np.tile(np.asarray(coeffs.coeff_vector(), np.float32), (scene.batch, 1))
    else:
        opt, dist = StepConfig(strategy=strategy), None
    kw = dict(width=scene.width, height=scene.height, plan=plan, opt=opt,
              total_iterations=100,
              noise=np.random.default_rng(2).normal(0, 1, (4096, 3)).astype(np.float32))
    wrappers = (expand_emission, segsum_emission, blend_forward, blend_backward,
                gut_kernels.gut_blend_forward, gut_kernels.gut_blend_backward)
    results = []
    for impl in ("kernel", "plain"):
        ts = init_train_state(dryrun.random_splat(scene, "cuda"), seed=1)
        for fn in wrappers:
            fn.launches = 0
        for _ in range(2):
            ts, stats = step(ts, gts, w2cs, cpos, intr, np.zeros(3, np.float32), None, dist,
                             impl=impl, **kw)
        if impl == "kernel":
            used = wrappers[:2] + (wrappers[4:] if gut else wrappers[2:4])
            assert all(fn.launches == 2 * scene.batch for fn in used), \
                {fn.__name__: fn.launches for fn in wrappers}
            assert all(fn.launches == 0 for fn in wrappers if fn not in used)
        assert int(stats.n_shard_visible) <= plan.gather_budget
        assert int(stats.total_instances) <= plan.max_instances
        results.append((float(stats.loss), ts))
    (loss_k, ts_k), (loss_p, ts_p) = results
    assert np.isfinite(loss_k) and abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    for k, v in ts_k.splat.params().items():
        off = ((v - ts_p.splat.params()[k]).abs() > 1e-5).float().mean()
        assert float(off) <= 1e-2, (k, float(off))
    assert torch.equal(ts_k.dens_count, ts_p.dens_count)


def _tile_sorted_on_card(rows, gen):
    """Rows in a random tile-sorted order and the emission->column index that reads them
    back in emission order."""
    sorted_emis = torch.randperm(rows.shape[1], device=rows.device, generator=gen)
    return rows.index_select(1, sorted_emis), emission_columns(sorted_emis.to(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows", [NFEAT, 17])
def test_segsum_kernel_through_cols_matches_plain_on_card(n_rows):
    _require_cuda()
    dev = torch.device("cuda")
    counts, start, end, total = emission_runs(seed=4, n=50_000, long_run=40_000)
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = torch.randn((n_rows, total + 1000), device=dev, generator=gen)
    gflat, cols = _tile_sorted_on_card(rows, gen)
    args = (gflat, torch.from_numpy(start).to(dev), torch.from_numpy(end).to(dev), cols)
    got = segsum_emission(*args)
    want = segsum_emission_plain(*args)
    again = segsum_emission(*args)
    torch.cuda.synchronize()
    scale = torch.from_numpy(np.sqrt(np.maximum(counts, 1)).astype(np.float32)).to(dev)
    assert bool(((got - want).abs() <= 1e-5 * want.abs() + 1e-5 * scale).all())
    assert bool((got[:, torch.from_numpy(counts == 0).to(dev)] == 0).all())
    short = torch.from_numpy(counts <= LONG_RUN).to(dev)
    assert torch.equal(got[:, short], want[:, short])
    assert torch.equal(again, got)


def _prefix_case(dev, n_rows, n, long_run, tail, seed):
    counts, _, _, _ = emission_runs(seed=seed, n=n, long_run=long_run)
    last_owner = int(np.nonzero(counts)[0][-1])
    rank = np.concatenate([np.repeat(np.arange(n, dtype=np.int32), counts),
                           np.full(tail, last_owner, np.int32)])  # the tail convention
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.randn((n_rows, rank.size), device=dev, generator=gen)
    rows *= torch.pow(10.0, torch.randint(-8, 3, (1, rank.size), device=dev, generator=gen))
    return rows, torch.from_numpy(rank).to(dev), gen


def _check_prefix_on_card(got, rows, rank):
    want = segred_prefix_plain(rows, rank)
    magnitude = segred_prefix_plain(rows.abs(), rank)
    torch.cuda.synchronize()
    assert bool(((got - want).abs() <= 1e-5 * want.abs() + 1e-5 * magnitude).all())
    heads = torch.ones_like(rank, dtype=torch.bool)
    heads[1:] = rank[1:] != rank[:-1]
    assert torch.equal(got[:, heads], rows[:, heads])  # a run head holds its own row


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows", [10, 17])
def test_segprefix_kernel_through_cols_matches_plain_on_card(n_rows):
    """A run of 120,000 slots spans 118 blocks of 1024; about 500 blocks in all."""
    _require_cuda()
    rows, rank, gen = _prefix_case(torch.device("cuda"), n_rows, 50_000, 120_000, 3000, 6)
    gflat, cols = _tile_sorted_on_card(rows, gen)
    got = segred_prefix(gflat, rank, cols)
    again = segred_prefix(gflat, rank, cols)
    _check_prefix_on_card(got, rows, rank)
    assert torch.equal(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows", [10, 17])
@pytest.mark.parametrize("m", [700, 1024, 5 * 1024 + 77])
def test_segprefix_kernel_on_short_and_ragged_axes_on_card(n_rows, m):
    """An axis shorter than one block, exactly one block, and five blocks and a part."""
    _require_cuda()
    rows, rank, gen = _prefix_case(torch.device("cuda"), n_rows, 2000, 300, 0, 7)
    rows, rank = rows[:, :m].contiguous(), rank[:m].contiguous()
    gflat, cols = _tile_sorted_on_card(rows, gen)
    for got in (segred_prefix(rows, rank), segred_prefix(gflat, rank, cols)):
        _check_prefix_on_card(got, rows, rank)


@pytest.mark.cuda
def test_quality_floor_capture_trains_on_card(tmp_path):
    """The quality-floor configuration of `chip_smoke.py` (the JAX package's CI gate:
    the raytraced capture of `tools/synth_capture.py` at 48x48, 8 views, test_every 8,
    max_cap 6000, refines every 100) for 150 iterations through the Trainer on the card:
    the eval PSNR is finite and rises from iteration 30 to 150; K1-K4 launch once a step,
    K1 and K2 once more an eval render."""
    _require_cuda()
    from tpu_splat_torch.core.config import (DatasetConfig, OptimizationParameters,
                                             TrainingParameters)
    from tpu_splat_torch.ops.cuda import blend, raster
    from tpu_splat_torch.tools.synth_capture import make_raytraced_colmap
    from tpu_splat_torch.training.trainer import Trainer

    make_raytraced_colmap(tmp_path / "rt", n_cams=8, size=48, seed=3, sfm_noise=0.004,
                          n_sfm=2400)
    tp = TrainingParameters(
        dataset=DatasetConfig(data_path=str(tmp_path / "rt"),
                              output_path=str(tmp_path / "out"), test_every=8),
        optimization=OptimizationParameters(
            iterations=150, max_cap=6000, refine_every=100, start_refine=100,
            stop_refine=500, enable_eval=True, eval_steps=[30, 150], save_steps=[],
            num_workers=2, sh_degree_interval=300, min_opacity=0.005))
    trainer = Trainer(tp)
    counted = (raster.expand_emission, blend.blend_forward, blend.blend_backward,
               raster.segsum_emission)
    for fn in counted:
        fn.launches = 0
    trainer.train(progress_every=1000)
    torch.cuda.synchronize()
    steps, evals = trainer.steps_dispatched, trainer.eval_renders
    assert [fn.launches for fn in counted] == [steps + evals] * 2 + [steps] * 2
    first, last = (r.psnr for r in trainer.evaluator.results)
    assert np.isfinite([first, last]).all() and last > first, (first, last)


@pytest.mark.cuda
def test_trainer_runs_through_the_kernels_on_card(tmp_path):
    """A 10-step Trainer run (two dispatch chunks and an eval) on a 6-view 96x64 capture
    the port renders: K1-K4 launch once a step, K1 and K2 also once an eval render, no
    GUT kernel; finite losses, one a step; the PLY holds the alive Gaussians."""
    _require_cuda()
    from chip_smoke import write_colmap_model
    from tpu_splat_torch.core.config import (DatasetConfig, OptimizationParameters,
                                             TrainingParameters)
    from tpu_splat_torch.io.image import save_image
    from tpu_splat_torch.io.ply import load_splat_ply
    from tpu_splat_torch.ops.cuda import blend, raster
    from tpu_splat_torch.ops.rasterize import rasterize
    from tpu_splat_torch.training.trainer import Trainer

    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    n, w, h, f = 2000, 96, 64, 80.0
    z = rng.uniform(2, 6, n).astype(np.float32)
    means = np.stack([rng.uniform(-0.5, 0.5, n) * z, rng.uniform(-0.35, 0.35, n) * z, z],
                     1).astype(np.float32)
    params = dict(means=means, sh0=rng.normal(0, 0.5, (n, 1, 3)),
                  shN=np.zeros((n, 15, 3)), scaling_raw=np.log(np.full((n, 3), 0.03)),
                  rotation_raw=np.tile([1.0, 0, 0, 0], (n, 1)),
                  opacity_raw=rng.normal(0, 1, (n, 1)))
    sp = splat_from_numpy(params, np.ones(n, bool), 3, dev)
    (tmp_path / "images").mkdir()
    views = []
    for i in range(6):
        t = np.array([0.05 * i, 0.0, 0.0], np.float32)
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, 3] = t
        with torch.no_grad():
            img = rasterize(sp.means, sp.scaling_raw, sp.rotation_raw, sp.opacity_raw, sp.sh0,
                            sp.shN, sp.alive, w2c, -t, f, f, w / 2, h / 2, 3, None, width=w,
                            height=h, max_instances=1 << 16, k_max=2048, device=dev).image
        save_image(str(tmp_path / "images" / f"v{i}.png"), img.cpu().numpy())
        views.append(dict(R=np.eye(3), T=t, fx=f, fy=f, cx=w / 2, cy=h / 2, width=w, height=h,
                          name=f"v{i}.png"))
    write_colmap_model(tmp_path / "sparse" / "0", views, means[::4],
                       np.full((n // 4, 3), 128, np.uint8))
    tp = TrainingParameters(
        dataset=DatasetConfig(data_path=str(tmp_path), output_path=str(tmp_path / "out"),
                              test_every=6),
        optimization=OptimizationParameters(iterations=10, max_cap=4096, enable_eval=True,
                                            eval_steps=[10], save_steps=[], num_workers=2,
                                            enable_save_eval_images=False))
    trainer = Trainer(tp)
    counted = (raster.expand_emission, blend.blend_forward, blend.blend_backward,
               raster.segsum_emission)
    for fn in counted + (gut_blend_forward, segred_prefix, adam_kernel):
        fn.launches = 0
    trainer.train()
    torch.cuda.synchronize()
    steps, evals = trainer.steps_dispatched, trainer.eval_renders
    assert steps >= 10 and evals == 1
    assert [fn.launches for fn in counted] == [steps + evals] * 2 + [steps] * 2
    assert adam_kernel.launches == steps
    assert gut_blend_forward.launches == 0 and segred_prefix.launches == 0
    assert len(trainer._loss_hist) == 10 and np.isfinite(trainer._loss_hist).all()
    back = load_splat_ply(tmp_path / "out" / "splat_final.ply")
    assert back["means"].shape[0] == int(trainer.state.splat.n_alive())
    assert trainer.evaluator.results[-1].num_images == 1


@pytest.mark.cuda
def test_jpeg_decodes_through_nvjpeg_on_card(tmp_path):
    """nvJPEG against libjpeg's decode of a 4:4:4 fixture (IDCT and colour conversion
    round differently): within 3/255 per channel; the loader's output shape and range."""
    _require_cuda()
    from tpu_splat_torch.io.image import decode_file, load_image
    from torch_fixtures import jpeg_fixture

    data, want = jpeg_fixture()
    p = tmp_path / "fixture.jpg"
    p.write_bytes(data)
    got = decode_file(p)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(np.int16) - want).max() <= 3
    img = load_image(p, 2)
    assert img.shape == (3, 12, 16) and img.dtype == np.float32


def _card_splat(rng, n=3000, cap=4096):
    """n random Gaussians in front of the identity camera in a `cap`-slot pool on the card."""
    pts = rng.normal(0, 0.8, (n, 3)).astype(np.float32)
    pts[:, 2] += 5
    params = dict(
        means=pts, sh0=rng.normal(0, 0.5, (n, 1, 3)).astype(np.float32),
        shN=rng.normal(0, 0.05, (n, 15, 3)).astype(np.float32),
        scaling_raw=np.log(rng.uniform(0.02, 0.1, (n, 3))).astype(np.float32),
        rotation_raw=rng.normal(0, 1, (n, 4)).astype(np.float32),
        opacity_raw=rng.normal(0, 1, (n, 1)).astype(np.float32))
    pad = lambda x: np.concatenate([x, np.ones((cap - n,) + x.shape[1:], np.float32)])
    return splat_from_numpy({k: pad(v) for k, v in params.items()}, np.arange(cap) < n, 3,
                            "cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("tile,chunk", [(16, 128), (32, 256)])
def test_adc_dens_grad2d_through_kernels_matches_plain_on_card(tile, chunk):
    """ADC's densification info from K3's mean2d columns summed by K4 (bf16 pack) against
    the plain versions: dens_count exactly, dens_grad2d within 1e-3 of its largest value
    (float32 pixel sums in another order)."""
    _require_cuda()
    from tpu_splat_torch.training.train_step import TrainState

    rng = np.random.default_rng(5)
    size = 128
    f = 0.5 * size / np.tan(np.radians(30.0))
    args = (rng.random((3, size, size)).astype(np.float32), np.eye(4, dtype=np.float32),
            np.zeros(3, np.float32), f, f, size / 2, size / 2, np.zeros(3, np.float32))
    plan = RasterPlan(max_instances=1 << 17, k_max=2048, chunk=chunk, tile_size=tile,
                      pack_bf16=True)
    kw = dict(width=size, height=size, plan=plan, opt=StepConfig(strategy="default"),
              total_iterations=100)
    splat = _card_splat(rng)
    out = {}
    for impl in ("kernel", "plain"):
        ts = init_train_state(splat, seed=1)
        for _ in range(2):
            ts, _ = train_step(ts, *args, impl=impl, **kw)
        out[impl] = ts
    k, p = out["kernel"], out["plain"]
    assert isinstance(k, TrainState) and torch.equal(k.dens_count, p.dens_count)
    assert int((k.dens_count == 2).sum()) > 1000
    scale = float(p.dens_grad2d.abs().max())
    assert scale > 0 and float((k.dens_grad2d - p.dens_grad2d).abs().max()) <= 1e-3 * scale


@pytest.mark.cuda
def test_adc_refine_on_card_matches_cpu():
    """The refine on the card against the refine on the CPU on identical dens_* and eps:
    counts, alive mask, moments and the rows that are not split children bit for bit;
    split children's means and scales rtol 1e-5."""
    _require_cuda()
    from tpu_splat_torch.training.train_step import adc_refine_step

    rng = np.random.default_rng(6)
    splat = _card_splat(rng, n=3000, cap=4096)
    ts = init_train_state(splat, seed=2)
    count = torch.from_numpy(rng.integers(0, 6, 4096).astype(np.float32)).cuda()
    grad = torch.from_numpy(rng.uniform(0, 3e-4, 4096).astype(np.float32)).cuda() * count
    ts = dataclasses.replace(ts, dens_count=count, dens_grad2d=grad, iteration=3001)
    eps = torch.randn((2, 4096, 3), device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(3))
    kw = dict(grad_threshold=2e-4, grow_scale3d=0.05, prune_opacity=0.3, prune_scale3d=0.05,
              reset_every=3000, revised_opacity=False)
    card, card_info = adc_refine_step(ts, eps=eps, **kw)
    cpu_ts = dataclasses.replace(
        ts, splat=ts.splat.to("cpu"), rng=torch.Generator(), dens_count=count.cpu(),
        dens_grad2d=grad.cpu(), adam=dataclasses.replace(
            ts.adam, exp_avg={k: v.cpu() for k, v in ts.adam.exp_avg.items()},
            exp_avg_sq={k: v.cpu() for k, v in ts.adam.exp_avg_sq.items()}))
    host, host_info = adc_refine_step(cpu_ts, eps=eps.cpu(), **kw)
    counts = {k: int(v) for k, v in card_info.items()}
    assert counts == {k: int(v) for k, v in host_info.items()}
    assert counts["n_dup"] > 10 and counts["n_split"] > 10 and counts["n_pruned"] > 10
    assert torch.equal(card.splat.alive.cpu(), host.splat.alive)
    from chip_smoke import split_children

    child = split_children(cpu_ts.splat.alive.numpy(), cpu_ts.splat.scaling_raw.numpy(),
                           host.splat.scaling_raw.numpy(), cpu_ts.splat.means.numpy(),
                           host.splat.means.numpy())
    assert child.sum() == 2 * counts["n_split"]
    for k in ("means", "sh0", "shN", "scaling_raw", "rotation_raw", "opacity_raw"):
        a, b = getattr(card.splat, k).cpu().numpy(), getattr(host.splat, k).numpy()
        if k in ("means", "scaling_raw"):
            np.testing.assert_array_equal(a[~child], b[~child], err_msg=k)
            np.testing.assert_allclose(a[child], b[child], rtol=1e-5, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)
        np.testing.assert_array_equal(card.adam.exp_avg[k].cpu().numpy(),
                                      host.adam.exp_avg[k].numpy(), err_msg=k)


@pytest.mark.cuda
def test_lpips_on_card_matches_cpu(tmp_path):
    """LPIPS-VGG from random weights on the card against the same module on the CPU:
    rtol 1e-3 (13 float32 convolutions through cuDNN, TF32 off, against the CPU's)."""
    _require_cuda()
    from tpu_splat_torch.training import lpips

    np.savez(tmp_path / "w.npz", **lpips.random_params(1))
    rng = np.random.default_rng(7)
    a = rng.random((3, 96, 128)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    got = lpips.LPIPSTorch(tmp_path / "w.npz", device="cuda")(a, b)
    want = lpips.LPIPSTorch(tmp_path / "w.npz", device="cpu")(a, b)
    assert want > 0 and abs(got - want) <= 1e-3 * want


@pytest.mark.cuda
def test_checkpoint_round_trips_on_card(tmp_path, caplog):
    """A card state with the bilateral grid and the pose MLP round-trips bit for bit, the
    CUDA generator's state included; loaded on the CPU, the generator is seeded from the
    key data instead (its state cannot cross device types), and that is logged."""
    _require_cuda()
    import logging

    from tpu_splat_torch.core.config import OptimizationParameters
    from tpu_splat_torch.training import checkpoint

    opt = OptimizationParameters(use_bilateral_grid=True, pose_optimization="mlp")
    ts = init_train_state(_card_splat(np.random.default_rng(8)), seed=4, n_train_images=3,
                          opt=opt)
    torch.randn(7, device="cuda", generator=ts.rng)
    checkpoint.save_checkpoint(tmp_path / "c.npz", ts, extra={"plan_k_max": 4096})
    back, extra = checkpoint.load_checkpoint(tmp_path / "c.npz", device="cuda")
    assert extra == {"plan_k_max": 4096} and back.device.type == "cuda"
    assert torch.equal(back.rng.get_state(), ts.rng.get_state())
    want, got = checkpoint.state_arrays(ts), checkpoint.state_arrays(back)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    with caplog.at_level(logging.INFO):
        on_cpu, _ = checkpoint.load_checkpoint(tmp_path / "c.npz", device="cpu")
    assert "seeded from its JAX key data" in caplog.text and on_cpu.rng.initial_seed() == 4


@pytest.mark.cuda
def test_kmeans_on_card_matches_cpu():
    """`chip_smoke.kmeans_card_check`: the k-means++ init bit-equal; after one Lloyd step
    the labels equal outside near-ties (top-two scores within 1e-5, relative) and the
    centroids rtol 1e-5; after 10 steps the inertia within 1e-4 (relative), for `kmeans`
    and `kmeans_1d`."""
    _require_cuda()
    from chip_smoke import kmeans_card_check

    kmeans_card_check(torch.device("cuda"))


@pytest.mark.cuda
def test_viewer_frame_on_card(tmp_path):
    """A /frame of the viewer served on the card decodes to the quantized render_view
    image of the same camera, and each frame launched K1 and K2 once."""
    _require_cuda()
    import json
    import urllib.request

    from tpu_splat_torch import viewer
    from tpu_splat_torch.io.image import decode_png
    from tpu_splat_torch.io.ply import save_splat_ply
    from tpu_splat_torch.render import render_view

    rng = np.random.default_rng(10)
    n = 20_000
    means = rng.normal(0, 1, (n, 3)).astype(np.float32)
    save_splat_ply(tmp_path / "m.ply", means, rng.normal(0, 0.5, (n, 1, 3)).astype(np.float32),
                   rng.normal(0, 0.1, (n, 15, 3)).astype(np.float32),
                   np.log(rng.uniform(0.01, 0.05, (n, 3))).astype(np.float32),
                   rng.normal(0, 1, (n, 4)).astype(np.float32),
                   rng.normal(0, 1, (n, 1)).astype(np.float32))
    server = viewer.serve(str(tmp_path / "m.ply"), port=0, width=320, height=240,
                          block=False)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/info", timeout=120) as r:
            assert json.loads(r.read())["n_alive"] == n
        v = server.viewer
        assert v.device.type == "cuda"
        expand_emission.launches = blend_forward.launches = 0
        for mode in ("RGB", "PC"):
            with urllib.request.urlopen(base + f"/frame?theta=0.3&phi=-0.2&radius=1&mode={mode}",
                                        timeout=120) as r:
                assert r.headers.get("Content-Type") == "image/png"
                got = decode_png(r.read())
            w2c = viewer.orbit_w2c(v.center, v.base_radius, 0.3, -0.2, 1.0)
            want = render_view(v.scene_state(), w2c, 320, 240, point_cloud=mode == "PC").image
            np.testing.assert_array_equal(
                got, viewer.quantize(torch.clamp(want, 0, 1).cpu().numpy()))
        assert expand_emission.launches == blend_forward.launches == 4
    finally:
        server.shutdown()
        server.server_close()


def test_webp_decoder_raises_when_it_cannot_build(tmp_path, monkeypatch):
    """No g++, or a build that fails: decoding raises and names the cause; nothing decodes
    the file another way (PIL is made unimportable)."""
    import sys

    from tpu_splat_torch.io import webp

    data = webp.encode_webp_lossless(np.full((3, 5, 4), 7, np.uint8))
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setattr(webp, "_lib", None)
    monkeypatch.setattr(webp, "BUILD_DIR", tmp_path / "build")
    broken = tmp_path / "vp8l_decode.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(webp, "_SRC", broken)
    with pytest.raises(RuntimeError, match="building the VP8L decoder failed"):
        webp.decode_webp_lossless(data)
    monkeypatch.setattr(webp.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+, not found"):
        webp.decode_webp_lossless(data)
    assert webp._lib is None and not list((tmp_path / "build").glob("*.so"))


def test_launch_counts_stay_exact_across_threads():
    """The kernel wrappers count launches from the trainer's thread and the live viewer's
    HTTP threads at once: `count_launch` loses no update (16 threads, a short switch
    interval)."""
    import sys
    import threading

    from tpu_splat_torch.ops.cuda.build import count_launch

    def wrapper():
        pass

    wrapper.launches = 0
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [count_launch(wrapper) for _ in range(5000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert wrapper.launches == 16 * 5000


@pytest.mark.cuda
def test_input_staging_pinned_on_card():
    """`InputStaging` on the card: pinned host buffers, one upload a chunk that does not
    block the host. The device buffers hold the host stack's bits; with the stream kept
    busy, the next refill waits for the last upload (`waits`), and work queued on the
    staged views before it reads the chunk they held; the buffers are kept across chunks
    of one shape, a shorter chunk in their prefix."""
    _require_cuda()
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)

    def chunk(k):
        return ([rng.random((3, 64, 96), dtype=np.float32) for _ in range(k)],
                [rng.normal(size=(4, 4)) for _ in range(k)],
                [rng.normal(size=3) for _ in range(k)],
                [rng.random(3, dtype=np.float32) for _ in range(k)])

    def host_stack(c):
        return [torch.from_numpy(np.ascontiguousarray(np.stack(x), np.float32)) for x in c]

    st = InputStaging(dev, 4)
    assert st.pinned
    first, a, b, cut = chunk(4), chunk(4), chunk(4), chunk(2)
    st.stage(*first)  # the buffers' allocation, which may synchronise the device
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # the next upload queues behind ~0.1 s of device work
    got_a = st.stage(*a)
    kept = [x.clone() for x in got_a]
    got_b = st.stage(*b)
    torch.cuda.synchronize()
    assert st.waits == 1 and st.allocs == 1
    for got, want in zip(kept, host_stack(a)):
        assert got.device.type == "cuda" and torch.equal(got.cpu(), want)
    for got, want in zip(got_b, host_stack(b)):
        assert torch.equal(got.cpu(), want)
    assert got_b[0].data_ptr() == got_a[0].data_ptr()
    got_cut = st.stage(*cut)
    torch.cuda.synchronize()
    assert got_cut[0].data_ptr() == got_a[0].data_ptr() and st.allocs == 1
    for got, want in zip(got_cut, host_stack(cut)):
        assert torch.equal(got.cpu(), want)


# (camera, coefficients bound to a [12] device tensor, max angle as a 0-dim device tensor)
_GUT_CASES = [("pinhole", False, False), ("pinhole", True, False), ("fisheye", False, False),
              ("fisheye", False, True), ("ortho", False, False)]
_GUT_W, _GUT_H = 200, 150


def _gut_projection_case(model, bound, angle_on_card, dev, n=1 << 17, seed=3):
    """2^17 slots, a tenth of them dead, a tenth behind the camera, seen by a rotated camera
    through `model` -> (the slot arrays, the camera's arguments after the slots)."""
    gen = torch.Generator().manual_seed(seed)
    ortho = model == "ortho"
    means = torch.rand((n, 3), generator=gen) * 2 - 1
    means[:, 2] = means[:, 2] * 2 + 5
    means[: n // 10, 2] *= -1  # behind the camera
    scaling = torch.log(torch.rand((n, 3), generator=gen) * 0.1 + 0.005)
    rotation = torch.randn((n, 4), generator=gen)
    opacity = torch.randn((n, 1), generator=gen) * 2
    alive = torch.rand((n,), generator=gen) > 0.1
    c, s_ = np.cos(0.2), np.sin(0.2)
    w2c = torch.tensor([[c, 0, s_, 0.1], [0, 1, 0, -0.05], [-s_, 0, c, 0.3], [0, 0, 0, 1]],
                       dtype=torch.float32)
    focal = 0.25 * _GUT_W if ortho else 0.8 * _GUT_W
    params = gut_test_cameras()[model]
    max_angle = fisheye_max_angle(params) if model == "fisheye" else None
    if angle_on_card:
        max_angle = torch.tensor(max_angle, dtype=torch.float32, device=dev)
    if bound:
        params = bind_coeffs(params, torch.as_tensor(params.coeff_vector(), device=dev))
    slots = [x.to(dev) for x in (means, scaling, rotation, opacity, alive)]
    return slots, (w2c.to(dev), focal, 1.1 * focal, _GUT_W / 2 + 3.0, _GUT_H / 2 - 2.0,
                   params, max_angle)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("model,bound,angle_on_card", _GUT_CASES)
def test_gut_projection_kernels_match_plain_on_card(model, bound, angle_on_card, tile):
    """`ut_project` and `pixel_world_rays` through their kernels against their plain chains
    on the card (`chip_smoke.check_gut_projection`, `check_gut_rays`: the chain's UT mean
    through cuBLAS's gemv2N, and the kernel held against the chain in float64 too); the
    rays over the whole image and over a window of 4 tile rows from tile row 3. Prints the
    largest gaps and the share of bit-equal values."""
    _require_cuda()
    dev = torch.device("cuda")
    slots, (w2c, fx, fy, cx, cy, params, max_angle) = _gut_projection_case(
        model, bound, angle_on_card, dev)
    label = f"{model} bound={bound} angle_on_card={angle_on_card} tile={tile}"
    gaps = check_gut_projection(slots, (w2c, fx, fy, cx, cy, params, _GUT_W, _GUT_H,
                                        max_angle), tile, label)
    behind = (slots[0][:, 2] < 0) & slots[4]
    got, _ = gut.ut_project(*slots, w2c, fx, fy, cx, cy, params, _GUT_W, _GUT_H, tile,
                            max_angle)
    assert int(behind.sum()) > 0 and not bool(got.visible[behind].any())

    gw, gh = -(-_GUT_W // tile), -(-_GUT_H // tile)
    args = (w2c, torch.zeros(3, device=dev), fx, fy, cx, cy, params, max_angle, None)
    for tile_y0, rows in ((0, gh), (3, 4)):
        kw = dict(grid_w=gw, grid_h=rows, tile_size=tile, width=_GUT_W, height=_GUT_H,
                  tile_y0=tile_y0)
        gaps[f"rays@{tile_y0}"] = check_gut_rays(args, kw, f"{label} rays@{tile_y0}")
    print(f"GUT_PROJECTION_GAPS {label} {gaps}")


@pytest.mark.cuda
def test_gut_projection_kernels_do_not_synchronise_on_card():
    """`ut_project` and `pixel_world_rays` on a bound-coefficient OPENCV camera (the
    Trainer's path) under `torch.cuda.set_sync_debug_mode("error")`, after a warm-up call:
    neither raises, i.e. neither synchronises, and each launches its kernel once a call.
    The plain chain, which copies host scalars to the card, raises there."""
    _require_cuda()
    dev = torch.device("cuda")
    slots, (w2c, fx, fy, cx, cy, params, max_angle) = _gut_projection_case(
        "pinhole", True, False, dev)
    cam = (w2c, fx, fy, cx, cy, params, _GUT_W, _GUT_H, 16, max_angle)
    gw, gh = -(-_GUT_W // 16), -(-_GUT_H // 16)
    ray_args = (w2c, torch.zeros(3, device=dev), fx, fy, cx, cy, params, max_angle, None)
    ray_kw = dict(grid_w=gw, grid_h=gh, tile_size=16, width=_GUT_W, height=_GUT_H)
    gut.ut_project(*slots, *cam)
    gut.pixel_world_rays(*ray_args, **ray_kw)
    torch.cuda.synchronize()
    launches = ut_project_kernel.launches, pixel_world_rays_kernel.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            gut.ut_project(*slots, *cam)
            gut.pixel_world_rays(*ray_args, **ray_kw)
        with pytest.raises(RuntimeError):
            gut.ut_project(*slots, *cam, impl="plain")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert (ut_project_kernel.launches, pixel_world_rays_kernel.launches) == (
        launches[0] + 2, launches[1] + 2)


_PROJ_W, _PROJ_H, _PROJ_TILE = 320, 200, 16


def _projection_case(dev, n=1 << 17, seed=4, rest=15):
    """2^17 slots with SH 3 coefficients seen through a rotated pinhole camera, built in
    camera space. In groups of n // 16: behind the camera; on the near plane (the rounding
    of the camera transform puts them on both sides); on the image's edges and on tile boundaries; opacities within 64 ulps of 1/255;
    rotations with |q|^2 within 64 ulps of the 1e-8 cull; needles of 400 units by 1e-4 a
    unit from the camera, diagonal in the image, whose 2D covariance is rank one up to
    rounding, so that its determinant (with the dilation, at least 0.09 in exact
    arithmetic) is rounding noise about the 1e-8 cull; the rest inside a frustum 20% wider
    than the image; a tenth of all slots dead; `rest` SH coefficients a slot in shN.
    -> (slots on `dev`, camera, the groups' slices)"""
    gen = torch.Generator().manual_seed(seed)
    w, h = _PROJ_W, _PROJ_H
    fx, fy, cx, cy = 0.8 * w, 0.85 * w, w / 2 + 3.0, h / 2 - 2.0
    rand = lambda *shape: torch.rand(shape, generator=gen)
    u, v, z = rand(n) * 1.4 * w - 0.2 * w, rand(n) * 1.4 * h - 0.2 * h, rand(n) * 8 + 0.5
    scaling = torch.log(rand(n, 3) * 0.05 + 0.002)
    rotation = torch.randn((n, 4), generator=gen)
    opacity = torch.randn((n, 1), generator=gen) * 2
    g = n // 16
    groups = [slice(i * g, (i + 1) * g) for i in range(6)]
    z[groups[0]] = rand(g) * 3.0 - 3.0
    z[groups[1]] = 0.01  # the camera transform's rounding puts them on both sides
    edge = groups[2]
    u[edge] = (torch.randint(0, w // _PROJ_TILE + 1, (g,), generator=gen) * _PROJ_TILE
               + (rand(g) - 0.5) * 1e-3).float()
    v[edge] = (torch.randint(0, h // _PROJ_TILE + 1, (g,), generator=gen) * _PROJ_TILE
               + (rand(g) - 0.5) * 1e-3).float()
    logit = np.float32(np.log(1.0 / 254.0))
    step = float(np.nextafter(logit, np.float32(0)) - logit)
    opacity[groups[3], 0] = float(logit) + torch.randint(-64, 65, (g,), generator=gen) * step
    q = torch.nn.functional.normalize(torch.randn((g, 4), generator=gen), dim=1) * 1e-4
    rotation[groups[4]] = q * (1 + torch.randint(-64, 65, (g, 1), generator=gen) * 2.0 ** -23)
    needle = groups[5]
    z[needle] = rand(g) + 0.5
    scaling[needle] = torch.tensor([np.log(400.0), np.log(1e-4), np.log(1e-4)],
                                   dtype=torch.float32)
    rotation[needle] = torch.tensor([np.cos(np.pi / 8), 0, 0, np.sin(np.pi / 8)],
                                    dtype=torch.float32)
    opacity[needle] = 3.0
    p_cam = torch.stack([(u - cx) / fx * z, (v - cy) / fy * z, z], dim=1)
    c, s_ = np.cos(0.2), np.sin(0.2)
    w2c = torch.tensor([[c, 0, s_, 0.1], [0, 1, 0, -0.05], [-s_, 0, c, 0.3], [0, 0, 0, 1]],
                       dtype=torch.float32)
    means = (p_cam - w2c[:3, 3]) @ w2c[:3, :3]  # R^T (p - t), row by row
    alive = rand(n) > 0.1
    alive[needle] = True
    sh0 = torch.randn((n, 1, 3), generator=gen) * 0.5
    shN = torch.randn((n, rest, 3), generator=gen) * 0.1
    slots = [x.to(dev) for x in (means, scaling, rotation, opacity, sh0, shN, alive)]
    w2c = w2c.to(dev)
    cam_position = -w2c[:3, :3].T @ w2c[:3, 3]
    return slots, (w2c, cam_position, fx, fy, cx, cy, w, h, _PROJ_TILE), groups


@pytest.mark.cuda
@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_projection_kernels_match_chain_on_card(degree):
    """`project` through its two kernels against its plain chain on the card
    (`chip_smoke.check_projection`) at SH `degree` (SH 4 on 24 coefficients a slot, the rest
    on 15): every field bit-equal, the backward's six
    gradients within 1e-4 of each leaf's largest and as close to the float64 chain as the
    float32 chain (twice its distance), zero on dead slots and above the degree, over all
    slots and again with cotangents on the ordinary slots alone. The
    special groups decide both ways: near-plane, opacity and |q|^2 slots on both sides of
    their culls, and needles culled by their determinant as well as kept. Prints the gaps."""
    _require_cuda()
    dev = torch.device("cuda")
    slots, cam, groups = _projection_case(dev, rest=24 if degree == 4 else 15)
    cot = projection_cotangents(slots[0].shape[0], slots[6], dev)
    gaps = check_projection(slots, cam, degree, f"SH {degree}", cot)
    # the same with cotangents on the ordinary slots alone, whose largest gradients are
    # not the needles' and the near plane's (~1e11): the tolerance is then their own
    ordinary = torch.zeros_like(slots[6])
    ordinary[groups[-1].stop:] = True
    cot = [c * ordinary.view(-1, *[1] * (c.dim() - 1)) for c in cot]
    gaps["ordinary"] = check_projection(slots, cam, degree, f"SH {degree} ordinary", cot)
    proj = project(*slots, *cam[:8], degree, tile_size=cam[8])
    alive = slots[6]
    for name, grp in (("near plane", groups[1]), ("opacity", groups[3]), ("|q|^2", groups[4]),
                      ("needles", groups[5])):
        vis = proj.visible[grp][alive[grp]]
        assert 0 < int(vis.sum()) < vis.numel(), (name, int(vis.sum()), vis.numel())
    assert not bool(proj.visible[groups[0]].any())
    print(f"PROJECTION_GAPS SH {degree} {gaps}")


@pytest.mark.cuda
@pytest.mark.parametrize("rest", [0, 8, 24])
def test_projection_kernels_match_chain_for_other_sh_layouts_on_card(rest):
    """As `test_projection_kernels_match_chain_on_card` at active degree 3 on a state whose
    shN holds no band (SH 0), bands 1-2 only (the chain evaluates up to 2) or bands 1-4
    (24 coefficients a slot, the widest shared-memory rows): bit-equal forward, the
    backward's gradients, band 3's or band 4's coefficients exactly zero."""
    _require_cuda()
    dev = torch.device("cuda")
    slots, cam, _ = _projection_case(dev, n=1 << 16, rest=rest)
    cot = projection_cotangents(slots[0].shape[0], slots[6], dev)
    gaps = check_projection(slots, cam, 3, f"shN of {rest}", cot)
    print(f"PROJECTION_GAPS rest {rest} {gaps}")


@pytest.mark.cuda
def test_projection_kernels_do_not_synchronise_on_card():
    """`project` forward and backward through its kernels under
    `torch.cuda.set_sync_debug_mode("error")`, after a warm-up call: nothing raises, i.e.
    neither kernel path synchronises, and each kernel launches once a call. The plain
    chain, which copies host scalars to the card, raises there."""
    _require_cuda()
    dev = torch.device("cuda")
    slots, cam, _ = _projection_case(dev, n=1 << 16)
    cot = projection_cotangents(slots[0].shape[0], slots[6], dev)
    projection_grads(slots, cam, 3, "kernel", cot)
    torch.cuda.synchronize()
    launches = project_kernel.launches, project_backward_kernel.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            projection_grads(slots, cam, 3, "kernel", cot)
        with pytest.raises(RuntimeError):
            project(*slots, *cam[:8], 3, tile_size=cam[8], impl="plain")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert (project_kernel.launches, project_backward_kernel.launches) == (
        launches[0] + 2, launches[1] + 2)


def _small_train_case(pose: str = "none", sh_degree: int = 3):
    """A 3000-Gaussian scene in 4096 slots at 128x128 and a fresh state (with `pose`
    optimisation; SH up to `sh_degree`) and the step's arguments, as
    `test_train_step_through_kernels_...`'s."""
    rng = np.random.default_rng(0)
    n, cap, size = 3000, 4096, 128
    pts = rng.normal(0, 0.8, (n, 3)).astype(np.float32)
    pts[:, 2] += 5
    params = dict(
        means=pts, sh0=rng.normal(0, 0.5, (n, 1, 3)).astype(np.float32),
        shN=rng.normal(0, 0.05, (n, (sh_degree + 1) ** 2 - 1, 3)).astype(np.float32),
        scaling_raw=np.log(rng.uniform(0.02, 0.1, (n, 3))).astype(np.float32),
        rotation_raw=rng.normal(0, 1, (n, 4)).astype(np.float32),
        opacity_raw=rng.normal(0, 1, (n, 1)).astype(np.float32))
    pad = lambda x: np.concatenate([x, np.ones((cap - n,) + x.shape[1:], np.float32)])
    splat = splat_from_numpy({k: pad(v) for k, v in params.items()}, np.arange(cap) < n,
                             sh_degree, "cuda")
    f = 0.5 * size / np.tan(np.radians(30.0))
    args = (rng.random((3, size, size)).astype(np.float32), np.eye(4, dtype=np.float32),
            np.zeros(3, np.float32), f, f, size / 2, size / 2, np.zeros(3, np.float32))
    plan = RasterPlan(max_instances=1 << 17, k_max=2048, chunk=256, tile_size=32,
                      pack_bf16=True)
    ts = init_train_state(splat, seed=1, n_train_images=2,
                          opt=OptimizationParameters(pose_optimization=pose))
    kw = dict(width=size, height=size, plan=plan, total_iterations=100,
              opt=StepConfig(pose_optimization=pose))
    return ts, args, kw


@pytest.mark.cuda
@pytest.mark.parametrize("pose", ["none", "direct"])
def test_projection_kernels_launch_once_a_step_on_card(pose):
    """Three train steps launch the projection's forward and backward kernels once each a
    step; with pose optimisation (w2c takes a gradient) the steps take the chain and launch
    neither, and the pose parameters move."""
    _require_cuda()
    ts, args, kw = _small_train_case(pose)
    launches = project_kernel.launches, project_backward_kernel.launches
    for _ in range(3):
        ts, stats = train_step(ts, *args, 1, **kw)
    torch.cuda.synchronize()
    assert np.isfinite(float(stats.loss))
    steps = 0 if pose == "direct" else 3
    assert (project_kernel.launches, project_backward_kernel.launches) == (
        launches[0] + steps, launches[1] + steps)
    if pose == "direct":
        assert float(ts.pose_params["embeddings"][1].abs().max()) > 0


@pytest.mark.cuda
def test_projection_kernels_launch_once_a_step_at_sh4_on_card():
    """Three train steps of a state with 24 rest coefficients at active degree 4 launch the
    projection's forward and backward kernels once each a step (band 4 takes the kernels,
    not the chain), and the loss stays finite."""
    _require_cuda()
    ts, args, kw = _small_train_case(sh_degree=4)
    kw["opt"] = dataclasses.replace(kw["opt"], sh_degree_interval=1)
    ts = dataclasses.replace(ts, iteration=4)
    launches = project_kernel.launches, project_backward_kernel.launches
    for _ in range(3):
        ts, stats = train_step(ts, *args, 1, **kw)
    torch.cuda.synchronize()
    assert np.isfinite(float(stats.loss))
    assert (project_kernel.launches, project_backward_kernel.launches) == (
        launches[0] + 3, launches[1] + 3)


@pytest.mark.cuda
@pytest.mark.parametrize("iteration", [1000, 7100])
@pytest.mark.parametrize("rest", [15, 24])
@pytest.mark.parametrize("slots", [1003, 1 << 16, 1 << 22])
def test_adam_kernel_matches_chain_bit_for_bit_on_card(slots, rest, iteration):
    """The fused Adam against `adam_step`'s chain (`chip_smoke.check_adam`): parameters and
    both moments of all six leaves bit for bit, one launch; 1003 slots leave a ragged tail
    in every leaf of 3 or 45 floats a slot (the kernel's scalar path); SH 3 and 4 (15 and 24
    rest coefficients); shN frozen at 1000 (the same tensors back) and trained at 7100; the
    dead tenth of the slots, with zero gradients and moments, unmoved."""
    _require_cuda()
    case = adam_case(slots, rest, torch.device("cuda"), seed=slots + rest)
    check_adam(*case, iteration, f"{slots} slots, {rest} rest coefficients, it {iteration}")


@pytest.mark.cuda
@pytest.mark.parametrize("leaf", ["means", "shN", "opacity_raw"])
def test_adam_kernel_takes_unaligned_leaves_on_card(leaf):
    """A leaf whose tensors start 4 bytes past a 16-byte boundary (contiguous views at an
    offset) takes the kernel's scalar path, bit for bit with the chain; the others keep
    their vector path in the same launch."""
    _require_cuda()
    case = adam_case(1 << 16, 15, torch.device("cuda"), unaligned=leaf)
    assert case[0][leaf].data_ptr() % 16 == 4
    check_adam(*case, 7100, f"{leaf} unaligned")


@pytest.mark.cuda
def test_adam_kernel_launches_once_a_step_without_synchronising_on_card():
    """Three train steps launch the fused Adam once each; under
    `torch.cuda.set_sync_debug_mode("error")` an `adam_step` through the kernel raises
    nothing (its scalars are launch arguments), and the state stays finite."""
    _require_cuda()
    from tpu_splat_torch.training.optim import adam_step

    ts, args, kw = _small_train_case()
    launches = adam_kernel.launches
    for _ in range(3):
        ts, stats = train_step(ts, *args, 1, **kw)
    torch.cuda.synchronize()
    assert adam_kernel.launches == launches + 3
    assert np.isfinite(float(stats.loss))
    params, grads, state, lrs = adam_case(1 << 16, 15, torch.device("cuda"))
    adam_step(params, grads, state, lrs, 7100)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            new_params, _ = adam_step(params, grads, state, lrs, 7100)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert adam_kernel.launches == launches + 6
    assert all(bool(torch.isfinite(v).all()) for v in new_params.values())


@pytest.mark.cuda
def test_adam_kernel_raises_on_leaves_it_does_not_take_on_card():
    """On the card `adam_step` launches the kernel or raises, with no fallback: a leaf that is
    not contiguous, not float32, or on the CPU beside CUDA leaves is a `ValueError`, and
    nothing launches."""
    _require_cuda()
    from tpu_splat_torch.training.optim import adam_step

    params, grads, state, lrs = adam_case(1024, 15, torch.device("cuda"))
    launches = adam_kernel.launches
    strided = dict(grads, means=grads["means"].T.contiguous().T)
    assert not strided["means"].is_contiguous()
    cases = [(params, strided, "contiguous CUDA tensor"),
             (dict(params, sh0=params["sh0"].double()), grads, "float32"),
             (dict(params, opacity_raw=params["opacity_raw"].cpu()), grads,
              "contiguous CUDA tensor")]
    for p, g, match in cases:
        with pytest.raises(ValueError, match=match):
            adam_step(p, g, state, lrs, 7100)
    assert adam_kernel.launches == launches
