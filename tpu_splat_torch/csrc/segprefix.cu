// K7 — segmented inclusive prefix over contiguous equal-rank runs, for Hopper (sm_90a).
//
// Replaces: tpu_splat/ops/pallas/raster.py::_segred_prefix_kernel (wrapper
// segred_prefix_pallas), its exact float32 lane.
//
// rows [F, M] float (feature-major gradient rows in emission order, F = 10 or 17),
// rank [M] int (the owner of each slot; equal ranks are contiguous):
//   out[f, i] = sum of rows[f, j] over j <= i in the run of i,
// a run being a maximal stretch of equal consecutive ranks. A prefix and not a run total:
// the slots past the last emitted one repeat the last owner's rank, and the caller reads
// each owner's sum at its run's last real slot.
//
// Bound on the H100: bytes. Every value is read once and written once, plus the ranks;
// one add per value.
//
// Design. The TPU kernel carries a run's partial sum from block to block across a
// sequential grid; a GPU grid has no order, so the carry takes three launches:
//  1. Each block scans its own tile of 1024 slots as four sub-tiles of 256: a segmented
//     Hillis-Steele scan by warp shuffles (whether a lane adds at a step follows from the
//     ballot of run heads, computed once for all F rows), the eight warps' trailing sums
//     folded in warp order, and the tile's running trailing sum carried from sub-tile to
//     sub-tile in registers. It publishes the trailing run's F sums and the number of
//     slots before its first run head.
//  2. One block scans those per-block pairs (has a head, trailing sums) with the same
//     code: the pair of a block composes exactly like the pair of a slot,
//     (f1, v1) o (f2, v2) = (f1 | f2, f2 ? v2 : v1 + v2).
//  3. Each block adds the carry of the blocks before it to the slots before its first
//     head. Runs are short, so this touches few slots.
// Every sum has a fixed order: no atomics on values, the same bits from run to run. The
// one-hot [128, 128] matmul, the bf16 lane and the requirement M % 128 == 0 of the TPU
// kernel have no counterpart.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;
constexpr unsigned kFullMask = 0xffffffffu;

// Segmented inclusive scan of the `tile_len` elements starting at blockIdx.x * tile_len.
// FROM_RANK: element i starts a run iff key[i] != key[i - 1] (element 0 always does).
// Otherwise key[i] != 0 says so directly.
template <int F, bool FROM_RANK>
__global__ void __launch_bounds__(kThreads) seg_scan_kernel(
    const float* __restrict__ in, float* __restrict__ out, long long stride,  // [F, stride]
    int m, const int* __restrict__ key, int tile_len,
    float* __restrict__ agg, long long agg_stride,  // [F, agg_stride] trailing sums, or null
    int* __restrict__ first_len,                    // [blocks] slots before the first head
    int* __restrict__ has_head) {                   // [blocks]
  __shared__ float s_wagg[F][kWarps];
  __shared__ int s_wflag[kWarps];
  __shared__ int s_first;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long t0 = static_cast<long long>(blockIdx.x) * tile_len;
  const int len = static_cast<int>(min(static_cast<long long>(tile_len), m - t0));
  if (threadIdx.x == 0) s_first = len;
  __syncthreads();

  float run[F];  // the tile's trailing-run sums so far (the same in every thread)
#pragma unroll
  for (int f = 0; f < F; ++f) run[f] = 0.0f;

  for (int s0 = 0; s0 < len; s0 += kThreads) {
    const int i = s0 + threadIdx.x;
    const bool inside = i < len;
    const long long slot = t0 + i;
    bool head = false;
    if (inside) {
      head = FROM_RANK ? (slot == 0 || key[slot] != key[slot - 1]) : key[slot] != 0;
      if (head) atomicMin(&s_first, i);
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

    float v[F];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      v[f] = inside ? __ldg(in + f * stride + slot) : 0.0f;
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
    for (int f = 0; f < F; ++f) {
      // fold (running, warp 0, ..., warp 7) in order; `before` is what precedes my warp
      float p = run[f], before = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (w == warp) before = p;
        p = s_wflag[w] ? s_wagg[f][w] : p + s_wagg[f][w];
      }
      run[f] = p;
      if (!head_before) v[f] += before;
      if (inside) out[f * stride + slot] = v[f];
    }
    __syncthreads();  // before the next sub-tile overwrites s_wagg
  }

  if (threadIdx.x == 0) {
    if (agg != nullptr) {
#pragma unroll
      for (int f = 0; f < F; ++f) agg[f * agg_stride + blockIdx.x] = run[f];
    }
    if (first_len != nullptr) {
      first_len[blockIdx.x] = s_first;
      has_head[blockIdx.x] = s_first < len;
    }
  }
}

// out[f, slot] += carry[f, b - 1] for the slots of block b before its first run head.
template <int F>
__global__ void add_carry_kernel(float* __restrict__ out, long long stride,
                                 const float* __restrict__ carry, long long carry_stride,
                                 const int* __restrict__ first_len, int tile_len) {
  const int b = blockIdx.x + 1;
  const int n = first_len[b];
  const long long t0 = static_cast<long long>(b) * tile_len;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
#pragma unroll
    for (int f = 0; f < F; ++f) out[f * stride + t0 + i] += carry[f * carry_stride + b - 1];
  }
}

template <int F>
int run(const float* rows, long long stride, int m, const int* rank, float* out, float* agg,
        int* first_len, int nb, cudaStream_t stream) {
  float* carry = agg + static_cast<long long>(F) * nb;
  int* has_head = first_len + nb;
  seg_scan_kernel<F, true><<<nb, kThreads, 0, stream>>>(
      rows, out, stride, m, rank, kTile, agg, nb, first_len, has_head);
  if (nb > 1) {
    seg_scan_kernel<F, false><<<1, kThreads, 0, stream>>>(
        agg, carry, nb, nb, has_head, nb, nullptr, 0, nullptr, nullptr);
    add_carry_kernel<F><<<nb - 1, 128, 0, stream>>>(out, stride, carry, nb, first_len, kTile);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// agg: float scratch [2, nfeat, nb]; first_len: int scratch [2, nb]; nb = ceil(m / 1024).
extern "C" int tpu_splat_segprefix(const float* rows, int nfeat, long long stride, int m,
                                   const int* rank, float* out, float* agg, int* first_len,
                                   int nb, cudaStream_t stream) {
  if (m <= 0) return 0;
  if (nb != (m + kTile - 1) / kTile) return static_cast<int>(cudaErrorInvalidValue);
  if (nfeat == 10) return run<10>(rows, stride, m, rank, out, agg, first_len, nb, stream);
  if (nfeat == 17) return run<17>(rows, stride, m, rank, out, agg, first_len, nb, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
