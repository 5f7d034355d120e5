"""Instance pipeline: expansion (kernel K1), exact contribution test, tile|depth sort,
and the per-Gaussian reduction of per-instance gradient rows (kernels K4 and K7).

Counterpart of `tpu_splat/ops/pallas/raster.py::build_sorted_instances`. Emission stays
in Gaussian-id order: Gaussian g owns emission slots [offs_excl[g], offs_incl[g]), one
per tile of its conservative rect. Each slot is expanded to its owner's rows (K1), tested
against its tile exactly (StopThePop), and the valid ones are sorted by a packed
(tile | depth-bits) int32 key; the stable sort breaks depth ties in emission order. The
sort and the per-tile range search are PyTorch library calls, as they are XLA ops (not
Pallas) in the JAX package.

K1 `expand_emission` launches `csrc/expand.cu` on a CUDA tensor and runs its plain
version, `expand_emission_plain`, on a CPU tensor. K4 `segsum_emission` (counterpart of
`tpu_splat/ops/pallas/raster.py::segsum_emission`) does the same with `csrc/segsum.cu` and
`segsum_emission_plain`: the backward of the feature pack, which sums each Gaussian's
contiguous run of emission slots (10 gradient rows on the pinhole path, 17 on the GUT
path). K7 `segred_prefix` (counterpart of `segred_prefix_pallas`, `csrc/segprefix.cu`,
`segred_prefix_plain`) is the segmented inclusive prefix over the same runs. Both read
slot e's rows either at column e (emission-order rows, the JAX kernels' contract) or,
given the emission->column index `cols` (`SortedInstances.emis_col`), at column cols[e]
of the tile-sorted rows the blend backward wrote, so no gather to emission order precedes
them. `segmented_grad_reduce` (counterpart of the JAX function of that name) turns
tile-sorted per-instance rows into per-Gaussian totals through either of them, chosen by
its `impl` argument.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..projection import Projected, will_contribute
from .blend import NFEAT
from .build import check, count_launch, kernel, require_cuda

# K1 float rows (per-Gaussian table `ftab` [7, N] and per-slot output `frows` [7, M])
R_MX, R_MY, R_CA, R_CB, R_CC, R_PTH, R_DEPTH = range(7)
# K1 int rows: per-Gaussian `itab` [4, N] is (count, tile_min x, tile_min y, rect_w);
# the per-slot output `irows` [6, M] prepends the owner id and the rect-walk index
I_POS, I_K, I_COUNT, I_TMINX, I_TMINY, I_RECTW = range(6)
N_FROWS, N_IROWS = 7, 6


def _check_expand_inputs(ftab, itab, offs_incl, max_instances):
    n = ftab.shape[1]
    if n == 0:
        raise ValueError("expand_emission needs at least one Gaussian")
    if ftab.shape != (N_FROWS, n) or ftab.dtype != torch.float32:
        raise ValueError(f"ftab must be float32 [{N_FROWS}, N], got {ftab.dtype} "
                         f"{tuple(ftab.shape)}")
    if itab.shape != (N_IROWS - 2, n) or itab.dtype != torch.int32:
        raise ValueError(f"itab must be int32 [{N_IROWS - 2}, N], got {itab.dtype} "
                         f"{tuple(itab.shape)}")
    if offs_incl.shape != (n,) or offs_incl.dtype != torch.int32:
        raise ValueError("offs_incl must be int32 [N]")
    if not 0 < max_instances < 2**31:
        raise ValueError(f"max_instances {max_instances} out of int32 range")


def expand_emission_plain(ftab, itab, offs_incl, max_instances: int):
    """Plain version of K1 — the JAX package's XLA lane (raster.py:315-326): scatter-max
    of each Gaussian's id at its start slot, cummax fill, then one row gather.

    -> (frows [7, M] float32, irows [6, M] int32)."""
    _check_expand_inputs(ftab, itab, offs_incl, max_instances)
    dev = ftab.device
    n = ftab.shape[1]
    counts = itab[0]
    offs_excl = offs_incl - counts
    starts = torch.where(counts > 0, offs_excl, max_instances).clamp_max(max_instances)
    pos = torch.zeros(max_instances + 1, dtype=torch.int32, device=dev)  # +1: drop slot
    pos.scatter_reduce_(0, starts.long(), torch.arange(n, dtype=torch.int32, device=dev),
                        reduce="amax")
    pos = torch.cummax(pos[:max_instances], dim=0).values
    slot = torch.arange(max_instances, dtype=torch.int32, device=dev)
    k = slot - offs_excl.index_select(0, pos)
    irows = torch.cat([pos[None], k[None], itab.index_select(1, pos)], dim=0)
    return ftab.index_select(1, pos), irows


def expand_emission(ftab, itab, offs_incl, max_instances: int):
    """K1: per-emission-slot rows. CPU tensors run the plain version; CUDA tensors launch
    `csrc/expand.cu` (one thread per slot, binary search of offs_incl) or raise.

    -> (frows [7, M] float32, irows [6, M] int32: pos, k, count, tile_min x/y, rect_w)."""
    if ftab.device.type == "cpu":
        return expand_emission_plain(ftab, itab, offs_incl, max_instances)
    _check_expand_inputs(ftab, itab, offs_incl, max_instances)
    require_cuda(ftab, ftab=ftab, itab=itab, offs_incl=offs_incl)
    frows = torch.empty((N_FROWS, max_instances), dtype=torch.float32, device=ftab.device)
    irows = torch.empty((N_IROWS, max_instances), dtype=torch.int32, device=ftab.device)
    err = kernel("expand")(
        ftab.data_ptr(), itab.data_ptr(), offs_incl.data_ptr(), ftab.shape[1],
        max_instances, frows.data_ptr(), irows.data_ptr(),
        torch.cuda.current_stream(ftab.device).cuda_stream,
    )
    check(err, "expand")
    count_launch(expand_emission)
    return frows, irows


expand_emission.launches = 0


class SortedInstances(NamedTuple):
    sorted_tile_id: torch.Tensor  # [MAX_INST] int32 (sentinel n_tiles at the tail)
    sorted_gid: torch.Tensor  # [MAX_INST] int32
    sorted_emis: torch.Tensor  # [MAX_INST] int32 — emission index of each sorted instance
    emis_rank: torch.Tensor  # [MAX_INST] int32 — Gaussian id (segment id) per emission slot
    emis_start: torch.Tensor  # [N] int32 — per-Gaussian start in emission order
    emis_end: torch.Tensor  # [N] int32 — per-Gaussian exclusive end in emission order
    tile_start: torch.Tensor  # [T] int32
    tile_count: torch.Tensor  # [T] int32 (uncapped)
    total_instances: torch.Tensor  # [] int32 (conservative rect total)
    max_tile_count: torch.Tensor  # [] int32
    n_visible: torch.Tensor  # [] int32
    # [MAX_INST] int32 — tile-sorted column of each emission slot, the inverse of
    # sorted_emis (None: segmented_grad_reduce builds it from sorted_emis)
    emis_col: torch.Tensor | None = None


def emission_columns(sorted_emis: torch.Tensor) -> torch.Tensor:
    """The emission->column index: the inverse permutation of `sorted_emis`,
    emis_col[sorted_emis[c]] = c. One int32 scatter of M."""
    m = sorted_emis.shape[0]
    cols = torch.empty_like(sorted_emis, dtype=torch.int32)
    return cols.scatter_(0, sorted_emis.long(),
                         torch.arange(m, dtype=torch.int32, device=sorted_emis.device))


def feature_table(proj: Projected) -> torch.Tensor:
    """Per-Gaussian blend features [NFEAT, N] in the F_* row layout, colour clamped >= 0."""
    return torch.stack([
        proj.mean2d[:, 0], proj.mean2d[:, 1],
        proj.conic[:, 0], proj.conic[:, 1], proj.conic[:, 2],
        proj.opacity,
        *torch.clamp_min(proj.color, 0.0).unbind(1),
        proj.depth,
    ]).contiguous()


def emission_tables(proj: Projected):
    """K1's per-Gaussian inputs: ftab [7, N] f32, itab [4, N] i32 (count, tile_min x/y,
    rect_w) and offs_incl [N] i32, the inclusive cumsum of the visible rect counts."""
    counts = torch.where(proj.visible, proj.n_tiles, 0).to(torch.int32)
    offs_incl = torch.cumsum(counts, 0, dtype=torch.int32)
    rect_w = torch.clamp_min(proj.tile_max[:, 0] - proj.tile_min[:, 0], 1)
    ftab = torch.stack([
        proj.mean2d[:, 0], proj.mean2d[:, 1],
        proj.conic[:, 0], proj.conic[:, 1], proj.conic[:, 2],
        proj.power_threshold, proj.depth,
    ]).contiguous()
    itab = torch.stack([counts, proj.tile_min[:, 0], proj.tile_min[:, 1], rect_w]).to(
        torch.int32).contiguous()
    return ftab, itab, offs_incl


def build_sorted_instances(
    proj: Projected, grid_w: int, grid_h: int, max_instances: int, tile_size: int,
    expand: str = "kernel", tile_y0: int = 0, image_tiles: int | None = None,
) -> SortedInstances:
    """Instance emission + (tile, depth) sort.

    expand="kernel" goes through K1's wrapper (the kernel on a CUDA tensor, its plain
    version on a CPU tensor); expand="plain" runs the plain version on any device.
    `tile_y0`: the image's tile row of the grid's first row. Under the multi-device
    window (`parallel/raster_mc.py::_window_proj`) `proj`'s tile rects are window-local
    and the contribution test runs at the global rows, as the JAX package's
    (raster.py:339-343). `image_tiles`: the tile count of the whole image the grid is a
    window of, which sizes the packed sort key's tile and depth bits, so that each tile's
    instances sort as they do in the whole frame (None: the grid is the whole image)."""
    if expand not in ("kernel", "plain"):
        raise ValueError(f"expand must be 'kernel' or 'plain', got {expand!r}")
    dev = proj.depth.device
    n_tiles = grid_w * grid_h

    # 1. per-Gaussian emission tables (Gaussian-id order)
    ftab, itab, offs_incl = emission_tables(proj)
    offs_excl = offs_incl - itab[0]

    # 2. instance expansion (K1)
    fn = expand_emission if expand == "kernel" else expand_emission_plain
    frows, irows = fn(ftab, itab, offs_incl, max_instances)
    pos, k = irows[I_POS], irows[I_K]
    total = offs_incl[-1]
    inst_id = torch.arange(max_instances, dtype=torch.int32, device=dev)
    in_range = (inst_id < total) & (k < irows[I_COUNT])

    # tile coordinates of the rect walk (exact integer division)
    rw = irows[I_RECTW]
    ky = torch.div(k, rw, rounding_mode="floor")
    kx = k - ky * rw
    tile_x = irows[I_TMINX] + kx
    tile_y = irows[I_TMINY] + ky

    # 3. exact per-tile contribution test
    contrib = will_contribute(
        frows[R_MX:R_MY + 1].T, frows[R_CA:R_CC + 1].T, tile_x, tile_y + tile_y0,
        frows[R_PTH], tile_size,
    )
    valid = in_range & contrib
    tile_id = torch.where(valid, tile_y * grid_w + tile_x, n_tiles)

    # 4. (tile id, depth) sort, stable: depth ties break in emission order. When tile and
    # depth bits fit one int32 the two keys pack into one: tile id high, the top bits of
    # the positive float32 depth's bit pattern (monotone for positive floats) below.
    # bits for the tile id incl. the sentinel n_tiles (the whole image's, under a window)
    tb = max(int(max(n_tiles, image_tiles or 0)).bit_length(), 1)
    db = 31 - tb
    if db >= 16:
        depth_bits = torch.clamp_min(frows[R_DEPTH], 0.0).view(torch.int32)
        key = torch.where(valid, (tile_id << db) | (depth_bits >> (31 - db)),
                          n_tiles << db)
        sorted_key, perm = torch.sort(key, stable=True)
        sorted_tile_id = sorted_key >> db
    else:
        depth_key = torch.where(valid, frows[R_DEPTH], float("inf"))
        by_depth = torch.sort(depth_key, stable=True).indices
        by_tile = torch.sort(tile_id.index_select(0, by_depth), stable=True).indices
        perm = by_depth.index_select(0, by_tile)
        sorted_tile_id = tile_id.index_select(0, perm)
    sorted_emis = perm.to(torch.int32)
    sorted_gid = pos.index_select(0, perm)

    # 5. per-tile ranges
    tiles = torch.arange(n_tiles + 1, dtype=torch.int32, device=dev)
    bounds = torch.searchsorted(sorted_tile_id.contiguous(), tiles, side="left",
                                out_int32=True)
    tile_start = bounds[:-1]
    tile_count = bounds[1:] - tile_start

    return SortedInstances(
        sorted_tile_id=sorted_tile_id.to(torch.int32),
        sorted_gid=sorted_gid,
        sorted_emis=sorted_emis,
        emis_rank=pos,
        emis_start=torch.clamp_max(offs_excl, max_instances),
        emis_end=torch.clamp_max(offs_incl, max_instances),
        tile_start=tile_start,
        tile_count=tile_count,
        total_instances=total,
        max_tile_count=tile_count.max(),
        n_visible=proj.visible.sum(dtype=torch.int32),
        emis_col=emission_columns(sorted_emis),
    )


ROW_COUNTS = (NFEAT, 17)  # gradient rows of the pinhole blend and of the GUT blend


def _check_rows(rows, cols):
    if rows.dim() != 2 or rows.shape[0] not in ROW_COUNTS or rows.dtype != torch.float32:
        raise ValueError(f"rows must be float32 [{ROW_COUNTS[0]} or {ROW_COUNTS[1]}, M], "
                         f"got {rows.dtype} {tuple(rows.shape)}")
    if cols is not None and (cols.dim() != 1 or cols.dtype != torch.int32):
        raise ValueError(f"cols must be int32 [M], got {cols.dtype} {tuple(cols.shape)}")


def _n_slots(rows, cols) -> int:
    """Length of the emission axis: one slot per column of `rows`, or per entry of `cols`."""
    return rows.shape[1] if cols is None else cols.shape[0]


PASS_ROWS = (1, 2, 3, 5, 10, 17)  # rows a grid pass of K4 or K7 may read (csrc launch_rows)
L2_PASS_BYTES = 24 << 20  # half the H100's 50 MB L2


def rows_per_pass(rows, cols) -> int:
    """Rows of `rows` one grid pass of K4 or K7 reads. Through `cols` the reads land at
    random columns, each value in a 32-byte sector of its row: a pass reads as many rows as
    fit in L2_PASS_BYTES (at least one), so a sector read for one column stays in L2 for the
    other seven it holds. In emission order the reads are coalesced and one pass reads all
    the rows."""
    n_rows, width = rows.shape
    if cols is None:
        return n_rows
    return max(g for g in PASS_ROWS
               if g <= n_rows and (g == 1 or 4 * g * width <= L2_PASS_BYTES))


def _emission_rows(rows, cols):
    """Emission-order rows: `rows` itself, or its columns cols[e] (exact copies, the same
    values `emission_order` leaves at slot e)."""
    return rows if cols is None else rows.index_select(1, cols)


def _check_segsum_inputs(rows, emis_start, emis_end, cols):
    _check_rows(rows, cols)
    n = emis_start.shape[0]
    for name, x in (("emis_start", emis_start), ("emis_end", emis_end)):
        if x.shape != (n,) or x.dtype != torch.int32:
            raise ValueError(f"{name} must be int32 [N], got {x.dtype} {tuple(x.shape)}")


LONG_RUN = 64  # runs up to this length are summed slot by slot (csrc/segsum.cu kLongRun)


@torch.no_grad()
def segsum_emission_plain(rows, emis_start, emis_end, cols=None):
    """Plain version of K4. Runs of up to LONG_RUN slots are summed slot by slot, all
    Gaussians at once: step k adds slot start + k of every run that has one, the order
    the kernel's thread walks its run in. The few longer runs are summed one by one in
    float64. (A difference of two running sums over the whole emission axis would not do:
    gradient magnitudes span more than ten decades, and a small run's sum drowns in the
    rounding of a large prefix.) With `cols`, slot e's rows are column cols[e] of `rows`,
    gathered first.

    -> [F, N] float32, out[f, g] = sum of the rows of slots emis_start[g]:emis_end[g]."""
    _check_segsum_inputs(rows, emis_start, emis_end, cols)
    rows = _emission_rows(rows, cols)
    m = rows.shape[1]
    end = emis_end.long().clamp(0, m)
    start = torch.minimum(emis_start.long().clamp_min(0), end)
    length = end - start
    short = length <= LONG_RUN
    out = torch.zeros((rows.shape[0], start.shape[0]), dtype=torch.float32,
                      device=rows.device)
    if m == 0 or start.shape[0] == 0:
        return out
    n_steps = int(torch.where(short, length, 0).max())
    for k in range(n_steps):
        has = short & (k < length)
        out = out + torch.where(has, rows.index_select(1, (start + k).clamp_max(m - 1)), 0.0)
    for g in torch.nonzero(~short)[:, 0].tolist():
        out[:, g] = rows[:, int(start[g]):int(end[g])].sum(dim=1, dtype=torch.float64)
    return out


def segsum_emission(rows, emis_start, emis_end, cols=None):
    """K4: per-Gaussian sums over emission slots. CPU tensors run the plain version; CUDA
    tensors launch `csrc/segsum.cu` (a block stages the slots of 256 Gaussians' runs in
    shared memory and each thread sums its own run; the block strides over a long run
    together; grid passes of `rows_per_pass` rows) or raise.

    rows [F, M'] float32, F = 10 or 17: slot e's rows are column e (emission order, M' =
    M) or, given cols [M] int32, column cols[e] (the tile-sorted rows of the blend
    backward and `SortedInstances.emis_col`). Gaussian g owns slots
    [emis_start[g], emis_end[g]). -> [F, N] float32, zero for an empty run."""
    if rows.device.type == "cpu":
        return segsum_emission_plain(rows, emis_start, emis_end, cols)
    _check_segsum_inputs(rows, emis_start, emis_end, cols)
    require_cuda(rows, rows=rows, emis_start=emis_start, emis_end=emis_end,
                 **({} if cols is None else dict(cols=cols)))
    n = emis_start.shape[0]
    out = torch.empty((rows.shape[0], n), dtype=torch.float32, device=rows.device)
    err = kernel("segsum")(
        rows.data_ptr(), rows.shape[0], rows.stride(0),
        None if cols is None else cols.data_ptr(), _n_slots(rows, cols),
        rows_per_pass(rows, cols), emis_start.data_ptr(), emis_end.data_ptr(), n,
        out.data_ptr(), out.stride(0),
        torch.cuda.current_stream(rows.device).cuda_stream,
    )
    check(err, "segsum")
    count_launch(segsum_emission)
    return out


segsum_emission.launches = 0


def _run_ids(rank):
    """[M] int64 run index of each slot: slots i-1 and i share a run iff their ranks are
    equal (runs are contiguous)."""
    head = torch.ones_like(rank, dtype=torch.bool)
    head[1:] = rank[1:] != rank[:-1]
    return torch.cumsum(head, 0) - 1


def _check_prefix_inputs(rows, rank, cols):
    _check_rows(rows, cols)
    m = _n_slots(rows, cols)
    if rank.shape != (m,) or rank.dtype != torch.int32:
        raise ValueError(f"rank must be int32 [{m}], got {rank.dtype} {tuple(rank.shape)}")


@torch.no_grad()
def segred_prefix_plain(rows, rank, cols=None):
    """Plain version of K7: a Hillis-Steele segmented scan over the whole slot axis,
    ceil(log2(longest run)) passes of masked shifted adds; every run restarts at its
    head. (Differences of one long cumsum would not do: gradient magnitudes span more than
    ten decades and a small run's prefix drowns in the rounding of a large one.) With
    `cols`, slot e's rows are column cols[e] of `rows`, gathered first.

    -> [F, M] float32, x[f, i] = sum of the rows of slots j <= i in the run of i."""
    _check_prefix_inputs(rows, rank, cols)
    x = _emission_rows(rows, cols).clone()
    if x.shape[1] == 0:
        return x
    rid = _run_ids(rank)
    longest = int(torch.bincount(rid).max())
    step = 1
    while step < longest:
        same = rid[step:] == rid[:-step]
        x = torch.cat([x[:, :step], x[:, step:] + torch.where(same, x[:, :-step], 0.0)],
                      dim=1)
        step *= 2
    return x


PREFIX_TILE = 1024  # slots a block scans (csrc/segprefix.cu kTile)


@torch.no_grad()
def segred_prefix_blocks(rows, rank, cols=None, tile: int = PREFIX_TILE):
    """Plain twin of K7's block composition: each tile of `tile` slots is scanned on its
    own (its runs restart at the tile's first slot) and publishes its aggregate, the sums
    of its trailing run, and whether it holds a run head. The slots before a tile's first
    head then add the carry: walking back over the tiles before it, c = agg[p] + c, until
    a tile with a head. Only aggregates are combined, in that fixed order, as the kernel
    does. -> the same as `segred_prefix_plain`, up to the order of float32 adds."""
    _check_prefix_inputs(rows, rank, cols)
    rows = _emission_rows(rows, cols)
    m, dev = rows.shape[1], rows.device
    if m == 0:
        return rows.clone()
    slot = torch.arange(m, device=dev)
    block = torch.div(slot, tile, rounding_mode="floor")
    local = segred_prefix_plain(rows, (_run_ids(rank) + block).to(torch.int32))
    nb = -(-m // tile)
    head = torch.ones(m, dtype=torch.bool, device=dev)
    head[1:] = rank[1:] != rank[:-1]
    starts = torch.arange(nb, device=dev) * tile
    agg = local[:, (starts + tile).clamp_max(m) - 1]  # [F, nb] trailing-run sums
    first = torch.full((nb,), tile, dtype=torch.long, device=dev).scatter_reduce(
        0, block[head], slot[head] - block[head] * tile, reduce="amin")
    has_head = first < (starts + tile).clamp_max(m) - starts
    out = local
    for b in range(1, nb):
        n_before = int(first[b].clamp_max(m - b * tile))
        if n_before == 0:
            continue
        carry = torch.zeros_like(agg[:, 0])
        for p in range(b - 1, -1, -1):
            carry = agg[:, p] + carry
            if bool(has_head[p]):
                break
        s0 = b * tile
        out[:, s0:s0 + n_before] = local[:, s0:s0 + n_before] + carry[:, None]
    return out


def segred_prefix(rows, rank, cols=None):
    """K7: segmented inclusive prefix over contiguous equal-rank runs. CPU tensors run the
    plain version; CUDA tensors launch `csrc/segprefix.cu` or raise: one kernel (a
    single-pass scan with a look-back over the blocks' aggregates, in passes of
    `rows_per_pass` rows) after one cudaMemsetAsync of its flags.

    rows [F, M'] float32, F = 10 or 17: slot e's rows are column e (emission order, M' =
    M) or, given cols [M] int32, column cols[e]; rank [M] int32.
    -> [F, M] float32, x[f, i] = sum of the rows of slots j <= i in the run of i."""
    if rows.device.type == "cpu":
        return segred_prefix_plain(rows, rank, cols)
    _check_prefix_inputs(rows, rank, cols)
    require_cuda(rows, rows=rows, rank=rank, **({} if cols is None else dict(cols=cols)))
    m, g = _n_slots(rows, cols), rows_per_pass(rows, cols)
    nb = -(-m // PREFIX_TILE)
    blocks = -(-rows.shape[0] // g) * nb  # passes of g rows, nb tiles each
    out = torch.empty((rows.shape[0], m), dtype=torch.float32, device=rows.device)
    # scratch: each block's trailing-run sums; one flag a block and, last, the ticket
    # counter that orders the blocks (zeroed by the kernel's call)
    agg = torch.empty((max(blocks, 1), g), dtype=torch.float32, device=rows.device)
    state = torch.empty(blocks + 1, dtype=torch.int32, device=rows.device)
    err = kernel("segprefix")(
        rows.data_ptr(), rows.shape[0], rows.stride(0),
        None if cols is None else cols.data_ptr(), m, g, rank.data_ptr(), out.data_ptr(),
        agg.data_ptr(), state.data_ptr(), nb,
        torch.cuda.current_stream(rows.device).cuda_stream,
    )
    check(err, "segprefix")
    count_launch(segred_prefix)
    return out


segred_prefix.launches = 0


def emission_order(gflat: torch.Tensor, sorted_emis: torch.Tensor) -> torch.Tensor:
    """Per-instance rows [F, M] in tile-sorted order -> emission order: column
    sorted_emis[c] of the result is column c of `gflat` (sorted_emis is a permutation of
    the M slots). Slots that failed the contribution test sorted to the unowned tail, so
    they receive the backward kernel's zero columns. The train step does not call it: K4
    and K7 read `gflat` through `emis_col`; it stays as the reference of that index."""
    rows = torch.empty_like(gflat)
    rows.index_copy_(1, sorted_emis.long(), gflat)
    return rows


SEGRED_IMPLS = ("segsum", "prefix")


def segmented_grad_reduce(gflat, inst: SortedInstances, impl: str = "segsum",
                          kernels: bool = True):
    """Per-Gaussian gradient totals [F, N] from tile-sorted per-instance rows `gflat`
    [F, M], read in emission order (each Gaussian's slots contiguous, in id order) through
    the emission->column index `inst.emis_col` (built from `sorted_emis` when None), by
    one of two lanes, named by `impl`:

      "segsum" (default): K4, the sum of each Gaussian's run;
      "prefix": K7, the segmented inclusive prefix, read at each run's last slot,
        x[:, emis_end - 1] * (emis_end > emis_start). A prefix and not a run total because
        the slots past the last emitted one repeat the last owner's rank.

    `kernels=False` runs the plain versions on any device."""
    if impl not in SEGRED_IMPLS:
        raise ValueError(f"impl must be one of {SEGRED_IMPLS}, got {impl!r}")
    cols = inst.emis_col if inst.emis_col is not None else emission_columns(inst.sorted_emis)
    if impl == "segsum":
        fn = segsum_emission if kernels else segsum_emission_plain
        return fn(gflat, inst.emis_start, inst.emis_end, cols)
    x = (segred_prefix if kernels else segred_prefix_plain)(gflat, inst.emis_rank, cols)
    last = (inst.emis_end.long() - 1).clamp(0, max(x.shape[1] - 1, 0))
    return x.index_select(1, last) * (inst.emis_end > inst.emis_start)


__all__ = ["NFEAT", "SortedInstances", "build_sorted_instances", "emission_columns",
           "emission_order", "emission_tables", "expand_emission", "expand_emission_plain",
           "feature_table", "rows_per_pass", "segmented_grad_reduce", "segred_prefix",
           "segred_prefix_blocks", "segred_prefix_plain", "segsum_emission",
           "segsum_emission_plain"]
