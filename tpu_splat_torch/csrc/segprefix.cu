// K7 — segmented inclusive prefix over contiguous equal-rank runs, for Hopper (sm_90a).
//
// Replaces: tpu_splat/ops/pallas/raster.py::_segred_prefix_kernel (wrapper
// segred_prefix_pallas), its exact float32 lane.
//
// Slot i's F values (F = 10 or 17) are column col(i) of rows [F, rstride]: col(i) =
// cols[i], the emission->column index into the tile-sorted rows the blend backward wrote,
// or col(i) = i for rows already in emission order (cols null). rank [M] int is the owner
// of each slot; equal ranks are contiguous:
//   out[f, i] = sum of rows[f, col(j)] over j <= i in the run of i,      out [F, M],
// a run being a maximal stretch of equal consecutive ranks. A prefix and not a run total:
// the slots past the last emitted one repeat the last owner's rank, and the caller reads
// each owner's sum at its run's last real slot.
//
// Bound on the H100: bytes. Every value is read once and written once (2 x 4 F B a slot),
// plus the rank and the column index (8 B a slot); one add per value. Through cols the
// reads land at random columns: each 4-byte value takes a 32-byte sector. As in K4
// (segsum.cu), the scan runs in passes of G rows (G = rows_per_pass, so that a pass's rows
// fit in half the L2) and a sector fetched for one column stays in L2 for the other seven.
//
// Design: one launch, a single-pass scan with a look-back over the blocks' aggregates.
// The TPU kernel carries a run's partial sum from block to block across a sequential
// grid; a GPU grid has no order, and the earlier design took three launches (block scans,
// a one-block scan of their carries, a carry add).
//  1. Each block takes a ticket from an atomic counter and scans tile ticket % nb of
//     kTile slots in the rows of pass ticket / nb, so the passes run one after the other
//     and a block waits only on blocks that have started. The tile is four sub-tiles of
//     256: each thread reads its slot's column index and issues the slot's G loads back to
//     back; a segmented Hillis-Steele scan by warp shuffles (whether a lane adds at a step
//     follows from the ballot of run heads, computed once for all G rows), the eight
//     warps' trailing sums folded in warp order, the tile's running trailing sum carried
//     from sub-tile to sub-tile in registers. The block writes its tile's local prefixes.
//  2. It publishes its aggregate, the trailing run's G sums, and whether the tile holds a
//     run head: the sums first, then a flag with release ordering (1: no head, 2: a head).
//     The aggregate needs nothing from other blocks, so no block's publication waits.
//  3. Only a tile whose first slot is no run head needs a carry. Warp 0 walks back over
//     the aggregates of its pass's earlier tiles 32 at a time (lane l waits for tile
//     p - l's flag, with acquire ordering, and loads its sums), folds them nearest first,
//     c = agg[p] + c, and stops at the nearest tile that holds a head. The block adds the carry to its
//     slots before its first head. Runs are short, so the walk is usually one step and
//     the fix-up a few slots; a run over B tiles costs each of its tiles B / 32 steps.
// Only aggregates are combined, in that fixed order, never a predecessor's inclusive
// prefix (which might or might not be ready yet), so a launch repeats its bits. The
// flags and the ticket are zeroed by one cudaMemsetAsync in this call, before the
// launch, on the same stream; its time counts in the kernel's. The one-hot [128, 128]
// matmul, the bf16 lane and the requirement M % 128 == 0 of the TPU kernel have no
// counterpart.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kNoHead = 1, kHasHead = 2;  // published flags; 0: not yet

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Rows [f0, f0 + G) of tile b: the ticket t gives the pass t / nb (f0 = pass * G, rows past
// nfeat are skipped) and the tile b = t % nb, so the passes run one after the other.
template <int G, bool kCols>
__global__ void __launch_bounds__(kThreads) segprefix_kernel(
    const float* __restrict__ rows, long long rstride, int nfeat,  // [nfeat, rstride]
    const int* __restrict__ cols, int m,                           // [m] or null
    const int* __restrict__ rank,                                  // [m]
    float* __restrict__ out, long long ostride,                    // [nfeat, ostride]
    int nb,                                                        // tiles a pass
    float* __restrict__ agg,  // [gridDim.x, G] trailing-run sums, by ticket
    int* __restrict__ state) {  // [gridDim.x] flags by ticket, then the ticket counter
  __shared__ float s_wagg[G][kWarps];
  __shared__ int s_wflag[kWarps];
  __shared__ int s_first, s_ticket;
  __shared__ float s_carry[G];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_ticket = atomicAdd(state + gridDim.x, 1);
  __syncthreads();
  const int ticket = s_ticket;
  const int pass = ticket / nb, b = ticket - pass * nb;
  const int f0 = pass * G;
  const int n_rows = min(G, nfeat - f0);
  rows += f0 * rstride;
  out += f0 * ostride;
  const long long t0 = static_cast<long long>(b) * kTile;
  const int len = static_cast<int>(min(static_cast<long long>(kTile), m - t0));
  if (threadIdx.x == 0) s_first = len;
  __syncthreads();

  float run[G];  // the tile's trailing-run sums so far (the same in every thread)
#pragma unroll
  for (int f = 0; f < G; ++f) run[f] = 0.0f;

  for (int s0 = 0; s0 < len; s0 += kThreads) {
    const int i = s0 + threadIdx.x;
    const bool inside = i < len;
    const long long slot = t0 + i;
    float v[G];
    bool head = false;
    if (inside) {
      const long long c = kCols ? __ldg(cols + slot) : slot;
#pragma unroll
      for (int f = 0; f < G; ++f) v[f] = f < n_rows ? __ldg(rows + f * rstride + c) : 0.0f;
      head = slot == 0 || __ldg(rank + slot) != __ldg(rank + slot - 1);
      if (head) atomicMin(&s_first, i);
    } else {
#pragma unroll
      for (int f = 0; f < G; ++f) v[f] = 0.0f;
    }
    const unsigned heads = __ballot_sync(kFullMask, head);
    // step k adds the partial of lane - 2^k iff no run starts in (lane - 2^k, lane]
    bool add[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const int d = 1 << k;
      add[k] = lane >= d && ((heads >> (lane - d + 1)) & ((1u << d) - 1u)) == 0u;
    }
    const bool head_before = (heads & (kFullMask >> (31 - lane))) != 0u;  // at or before me

#pragma unroll
    for (int f = 0; f < G; ++f) {
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        const float pv = __shfl_up_sync(kFullMask, v[f], 1 << k);
        if (add[k]) v[f] += pv;
      }
      if (lane == 31) s_wagg[f][warp] = v[f];
    }
    if (lane == 0) s_wflag[warp] = heads != 0u;
    __syncthreads();
#pragma unroll
    for (int f = 0; f < G; ++f) {
      // fold (running, warp 0, ..., warp 7) in order; `before` is what precedes my warp
      float p = run[f], before = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (w == warp) before = p;
        p = s_wflag[w] ? s_wagg[f][w] : p + s_wagg[f][w];
      }
      run[f] = p;
      if (!head_before) v[f] += before;
      if (inside && f < n_rows) out[f * ostride + slot] = v[f];
    }
    __syncthreads();  // before the next sub-tile overwrites s_wagg
  }

  // -- publish the aggregate: the sums, then the flag (release)
  const int first = s_first;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int f = 0; f < G; ++f) agg[static_cast<long long>(ticket) * G + f] = run[f];
    __threadfence();
    store_release(state + ticket, first < len ? kHasHead : kNoHead);
  }
  if (first == 0) return;  // the tile starts with a head: no carry (always so for tile 0)

  // -- look back over the pass's earlier tiles until one with a head, 32 at a time: lane
  // l waits for tile p - l's flag (acquire) and loads its G sums; the warp then folds them
  // nearest first, c = agg[p] + c, c = agg[p - 1] + c, ..., up to the nearest tile with a
  // head (tile 0 always has one)
  if (warp == 0) {
    float c[G];
#pragma unroll
    for (int f = 0; f < G; ++f) c[f] = 0.0f;
    for (int p = b - 1;; p -= 32) {
      const int q = p - lane;
      int flag = kHasHead;
      float a[G];
#pragma unroll
      for (int f = 0; f < G; ++f) a[f] = 0.0f;
      if (q >= 0) {
        const int tq = pass * nb + q;
        while ((flag = load_acquire(state + tq)) == 0) {
        }
#pragma unroll
        for (int f = 0; f < G; ++f) a[f] = __ldcg(agg + static_cast<long long>(tq) * G + f);
      }
      const unsigned heads = __ballot_sync(kFullMask, flag == kHasHead);
      const int last = heads != 0u ? __ffs(heads) - 1 : 31;
      for (int j = 0; j <= last; ++j) {
#pragma unroll
        for (int f = 0; f < G; ++f) c[f] = __shfl_sync(kFullMask, a[f], j) + c[f];
      }
      if (heads != 0u) break;
    }
    if (lane == 0) {
#pragma unroll
      for (int f = 0; f < G; ++f) s_carry[f] = c[f];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < first; i += kThreads) {
#pragma unroll
    for (int f = 0; f < G; ++f) {
      if (f < n_rows) out[f * ostride + t0 + i] += s_carry[f];
    }
  }
}

template <int G, bool kCols>
int launch(const float* rows, long long rstride, int nfeat, const int* cols, int m,
           const int* rank, float* out, int nb, float* agg, int* state, cudaStream_t stream) {
  const int blocks = (nfeat + G - 1) / G * nb;
  segprefix_kernel<G, kCols><<<blocks, kThreads, 0, stream>>>(
      rows, rstride, nfeat, cols, m, rank, out, m, nb, agg, state);
  return static_cast<int>(cudaGetLastError());
}

template <bool kCols>
int launch_rows(int rows_per_pass, const float* rows, long long rstride, int nfeat,
                const int* cols, int m, const int* rank, float* out, int nb, float* agg,
                int* state, cudaStream_t stream) {
  switch (rows_per_pass) {
#define TPU_SPLAT_SEGPREFIX_CASE(G) \
  case G:                           \
    return launch<G, kCols>(rows, rstride, nfeat, cols, m, rank, out, nb, agg, state, stream);
    TPU_SPLAT_SEGPREFIX_CASE(1)
    TPU_SPLAT_SEGPREFIX_CASE(2)
    TPU_SPLAT_SEGPREFIX_CASE(3)
    TPU_SPLAT_SEGPREFIX_CASE(5)
    TPU_SPLAT_SEGPREFIX_CASE(10)
    TPU_SPLAT_SEGPREFIX_CASE(17)
#undef TPU_SPLAT_SEGPREFIX_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// cols: the emission->column index [m], or null for rows in emission order; out [nfeat, m].
// rows_per_pass: rows of `rows` a pass reads, one of 1, 2, 3, 5, 10, 17; passes =
// ceil(nfeat / rows_per_pass), nb = ceil(m / 1024) tiles a pass. agg: float scratch
// [passes * nb, rows_per_pass]; state: int scratch [passes * nb + 1].
extern "C" int tpu_splat_segprefix(const float* rows, int nfeat, long long rstride,
                                   const int* cols, int m, int rows_per_pass, const int* rank,
                                   float* out, float* agg, int* state, int nb,
                                   cudaStream_t stream) {
  if (m <= 0) return 0;
  if (nb != (m + kTile - 1) / kTile || (nfeat != 10 && nfeat != 17) ||
      rows_per_pass < 1 || rows_per_pass > nfeat) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (nfeat + rows_per_pass - 1) / rows_per_pass * nb;
  const cudaError_t err = cudaMemsetAsync(state, 0, sizeof(int) * (blocks + 1), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return cols ? launch_rows<true>(rows_per_pass, rows, rstride, nfeat, cols, m, rank, out, nb,
                                  agg, state, stream)
              : launch_rows<false>(rows_per_pass, rows, rstride, nfeat, cols, m, rank, out, nb,
                                   agg, state, stream);
}
