"""K4 and K7 reading tile-sorted rows through the emission->column index, on the CPU.

The train step hands K4 (`segsum_emission`) and K7 (`segred_prefix`) the blend backward's
tile-sorted rows and `SortedInstances.emis_col`, in place of rows gathered to emission
order by `emission_order`. Both move exact copies, so the plain versions must give the
same bits either way: checked at 10 and 17 rows, with empty runs, runs over LONG_RUN
slots and K7's tail convention. Also: `emis_col` inverts `sorted_emis` on a small scene,
the plain twin of K7's block composition (`segred_prefix_blocks`) equals the plain
version on runs spanning one, two and five blocks (exactly, on integer-valued rows), and
the pinhole backward reaches K4 without the gather. Imports neither JAX nor the JAX
package.
"""

import numpy as np
import pytest
import torch

from tpu_splat_torch.convert import splat_from_numpy
from tpu_splat_torch.ops.cuda import raster
from tpu_splat_torch.ops.cuda.raster import (LONG_RUN, PREFIX_TILE, SortedInstances,
                                             build_sorted_instances, emission_columns,
                                             emission_order, segmented_grad_reduce,
                                             segred_prefix, segred_prefix_blocks,
                                             segred_prefix_plain, segsum_emission,
                                             segsum_emission_plain)
from tpu_splat_torch.ops.projection import project
from tpu_splat_torch.ops.rasterize import rasterize

from torch_fixtures import emission_runs


def _tile_sorted(rng, rows_emis):
    """A random permutation `sorted_emis` and the tile-sorted rows it came from: column c
    of `gflat` is slot sorted_emis[c] of `rows_emis`."""
    sorted_emis = torch.from_numpy(rng.permutation(rows_emis.shape[1]).astype(np.int32))
    return rows_emis[:, sorted_emis.long()].contiguous(), sorted_emis


def _runs(seed):
    """emission_runs plus a few runs just over LONG_RUN slots: empty runs, short runs,
    one of 1500 slots, and the last owner not the last Gaussian."""
    counts, _, _, _ = emission_runs(seed=seed, n=500)
    counts[[40, 41, 200]] = (LONG_RUN + 1, LONG_RUN, 3 * LONG_RUN)
    end = np.cumsum(counts).astype(np.int32)
    return counts, (end - counts).astype(np.int32), end, int(end[-1])


def _rows(rng, n_rows, m):
    """Gradient-like rows: mixed signs over eleven decades of magnitude."""
    rows = rng.normal(0, 1, (n_rows, m)) * 10.0 ** rng.integers(-8, 3, (1, m))
    return torch.from_numpy(rows.astype(np.float32))


@pytest.mark.parametrize("n_rows", [10, 17])
def test_segsum_through_cols_equals_gather_then_plain(n_rows):
    rng = np.random.default_rng(n_rows)
    counts, start, end, total = _runs(seed=1)
    rows_emis = _rows(rng, n_rows, total + 300)  # the tail slots own nothing
    gflat, sorted_emis = _tile_sorted(rng, rows_emis)
    cols = emission_columns(sorted_emis)
    args = (torch.from_numpy(start), torch.from_numpy(end))
    gathered = emission_order(gflat, sorted_emis)
    assert torch.equal(gathered, rows_emis)
    want = segsum_emission_plain(gathered, *args)
    got = segsum_emission(gflat, *args, cols)
    assert torch.equal(got, want)
    assert (got[:, counts == 0] == 0).all() and (counts > LONG_RUN).sum() >= 3


@pytest.mark.parametrize("n_rows", [10, 17])
def test_segred_prefix_through_cols_equals_gather_then_plain(n_rows):
    rng = np.random.default_rng(20 + n_rows)
    counts, start, end, total = _runs(seed=2)
    last_owner = int(np.nonzero(counts)[0][-1])
    # the tail convention: slots past the last run repeat the last owner's rank
    rank = torch.from_numpy(np.concatenate([
        np.repeat(np.arange(len(counts), dtype=np.int32), counts),
        np.full(300, last_owner, np.int32)]))
    rows_emis = _rows(rng, n_rows, rank.shape[0])
    gflat, sorted_emis = _tile_sorted(rng, rows_emis)
    cols = emission_columns(sorted_emis)
    want = segred_prefix_plain(emission_order(gflat, sorted_emis), rank)
    got = segred_prefix(gflat, rank, cols)
    assert got.shape == (n_rows, rank.shape[0]) and torch.equal(got, want)
    # the per-Gaussian totals of both lanes through segmented_grad_reduce
    inst = SortedInstances(
        sorted_tile_id=None, sorted_gid=None, sorted_emis=sorted_emis, emis_rank=rank,
        emis_start=torch.from_numpy(start), emis_end=torch.from_numpy(end), tile_start=None,
        tile_count=None, total_instances=None, max_tile_count=None, n_visible=None)
    for impl in ("segsum", "prefix"):
        built = segmented_grad_reduce(gflat, inst, impl)  # emis_col built from sorted_emis
        given = segmented_grad_reduce(gflat, inst._replace(emis_col=cols), impl)
        assert torch.equal(built, given), impl
    np.testing.assert_allclose(segmented_grad_reduce(gflat, inst, "prefix").numpy(),
                               segmented_grad_reduce(gflat, inst, "segsum").numpy(),
                               rtol=1e-5, atol=1e-5 * float(rows_emis.abs().max()))


def _small_scene(n=500, size=64, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.normal(0, 0.8, (n, 3)).astype(np.float32)
    pts[:, 2] += 5
    params = dict(
        means=pts, sh0=rng.normal(0, 0.5, (n, 1, 3)).astype(np.float32),
        shN=rng.normal(0, 0.05, (n, 15, 3)).astype(np.float32),
        scaling_raw=np.log(rng.uniform(0.02, 0.2, (n, 3))).astype(np.float32),
        rotation_raw=rng.normal(0, 1, (n, 4)).astype(np.float32),
        opacity_raw=rng.normal(0, 1, (n, 1)).astype(np.float32))
    splat = splat_from_numpy(params, np.ones(n, bool), 3, "cpu")
    f = 0.5 * size / np.tan(np.radians(30.0))
    cam = (torch.eye(4), torch.zeros(3), f, f, size / 2, size / 2)
    return splat, cam, size


def test_emis_col_inverts_sorted_emis():
    splat, cam, size = _small_scene()
    ts = 16
    proj = project(splat.means, splat.scaling_raw, splat.rotation_raw, splat.opacity_raw,
                   splat.sh0, splat.shN, splat.alive, *cam, size, size, 0, tile_size=ts)
    grid = size // ts
    inst = build_sorted_instances(proj, grid, grid, 1 << 12, ts)
    m = inst.sorted_emis.shape[0]
    assert 0 < int(inst.total_instances) < m and inst.emis_col.dtype == torch.int32
    slots = torch.arange(m, dtype=torch.int32)
    assert torch.equal(inst.emis_col[inst.sorted_emis.long()], slots)
    assert torch.equal(inst.sorted_emis[inst.emis_col.long()], slots)
    assert torch.equal(inst.emis_col, emission_columns(inst.sorted_emis))


@pytest.mark.parametrize("spans", [1, 2, 5])
def test_segred_prefix_blocks_twin_equals_plain(spans):
    """Integer-valued rows sum exactly in any order, so the twin's block composition must
    give the plain version's bits. Runs of 1-9 slots around one run spanning `spans`
    blocks; the slot count is no multiple of the tile."""
    rng = np.random.default_rng(spans)
    before = rng.integers(1, 10, 200)
    before = before[: np.searchsorted(np.cumsum(before), PREFIX_TILE // 2)]
    long_run = spans * PREFIX_TILE - int(before.sum()) - 37  # ends 37 slots short of a tile
    counts = np.concatenate([before, [long_run], rng.integers(1, 10, 80)])
    rank = torch.from_numpy(np.repeat(np.arange(len(counts), dtype=np.int32), counts))
    m = rank.shape[0]
    assert m % PREFIX_TILE != 0 and -(-m // PREFIX_TILE) >= spans
    for n_rows in (10, 17):
        rows = torch.from_numpy(rng.integers(-64, 65, (n_rows, m)).astype(np.float32))
        want = segred_prefix_plain(rows, rank)
        assert torch.equal(segred_prefix_blocks(rows, rank), want)
        # the same composition at a small tile: many blocks, runs across many of them
        assert torch.equal(segred_prefix_blocks(rows, rank, tile=64), want)
        gflat, sorted_emis = _tile_sorted(rng, rows)
        assert torch.equal(segred_prefix_blocks(gflat, rank, emission_columns(sorted_emis)),
                           want)
    # float rows of mixed magnitude: only the order of float32 adds differs
    rows = _rows(rng, 17, m)
    want = segred_prefix_plain(rows, rank)
    magnitude = segred_prefix_plain(rows.abs(), rank)
    got = segred_prefix_blocks(rows, rank, tile=64)
    assert bool(((got - want).abs() <= 1e-5 * want.abs() + 1e-5 * magnitude).all())


def test_pinhole_backward_reduces_without_the_gather(monkeypatch):
    """`BlendTiles.backward` goes through segmented_grad_reduce and K4 reads the tile-sorted
    rows through emis_col: emission_order is never called, and the gradient equals the
    reference (the same render with every kernel's plain version)."""
    splat, cam, size = _small_scene(n=300, seed=1)
    names = ("means", "scaling_raw", "rotation_raw", "opacity_raw", "sh0", "shN")

    def grads(impl):
        leaves = [getattr(splat, k).detach().requires_grad_(True) for k in names]
        img = rasterize(*leaves, splat.alive, *cam, 3, None, width=size, height=size,
                        max_instances=1 << 12, k_max=512, chunk=64, tile_size=16,
                        device="cpu", impl=impl).image
        weight = torch.linspace(0.0, 1.0, img.numel()).reshape(img.shape)
        return torch.autograd.grad((img * weight).sum(), leaves)

    want = grads("plain")

    def no_gather(*args):
        raise AssertionError("emission_order called on the train path")

    monkeypatch.setattr(raster, "emission_order", no_gather)
    got = grads("kernel")
    for k, a, b in zip(names, got, want):
        assert torch.equal(a, b), k
