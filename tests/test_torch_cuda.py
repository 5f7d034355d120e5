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
staging bit for bit against a host stack, its refill waiting for an upload still queued.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_splat_torch.convert import splat_from_numpy
from tpu_splat_torch.ops.cuda.blend import (NFEAT, blend_backward, blend_backward_plain,
                                            blend_forward, blend_forward_plain,
                                            pack_features_bf16, unpack_features)
from tpu_splat_torch.ops.cuda.gut_kernels import gut_blend_forward
from tpu_splat_torch.ops.cameras import CameraParams
from tpu_splat_torch.ops.cuda.raster import (LONG_RUN, emission_columns, expand_emission,
                                             expand_emission_plain, segred_prefix,
                                             segred_prefix_plain, segsum_emission,
                                             segsum_emission_plain)
from tpu_splat_torch.training.staging import InputStaging
from tpu_splat_torch.training.train_step import (RasterPlan, StepConfig, init_train_state,
                                                 train_step)

from chip_smoke import (blend_pairs, check_gut_kernels, gut_border_segments,
                        random_gut_segments, random_segments)
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
    for fn in counted + (gut_blend_forward, segred_prefix):
        fn.launches = 0
    trainer.train()
    torch.cuda.synchronize()
    steps, evals = trainer.steps_dispatched, trainer.eval_renders
    assert steps >= 10 and evals == 1
    assert [fn.launches for fn in counted] == [steps + evals] * 2 + [steps] * 2
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
