// K1 — instance expansion for Hopper (sm_90a).
//
// Replaces: tpu_splat/ops/pallas/raster.py::_expand_kernel (wrapper expand_emission).
// For every emission slot i of [0, max_inst): the owning Gaussian g, i.e. the one with
// offs_excl[g] <= i < offs_incl[g], the rect-walk index k = i - offs_excl[g], and g's
// per-Gaussian rows copied to the slot. Slots >= total take the owner of slot total-1
// (the last Gaussian with a nonzero count; Gaussian 0 when total == 0), exactly what the
// plain version's scatter-max + cummax fill gives; callers mask them with `slot < total`.
//
// Bound on the H100: bytes. Every slot writes 13 words (7 float rows, pos, k and 4 int
// rows) and reads one per-Gaussian row, so at 2^24 slots the kernel moves ~0.9 GB: about
// 0.27 ms at 3.35 TB/s. The arithmetic is a few integer ops and a short binary search.
//
// Design: one thread per slot, feature-major output so a warp's stores to each row are
// 128 contiguous bytes. The TPU kernel's one-hot matmuls, bf16 three-way splits,
// 128-rounded windows and inf/NaN clipping do not carry over: a gather copies f32 rows
// bit-exactly, and pos/k are exact int32. Two threads of each block first locate the
// owners of the block's first and last slot (offs_incl is monotone), so every other
// thread searches only that narrow range (a few steps instead of log2(n) ~ 20).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kFloatRows = 7;  // mean2d x/y, conic a/b/c, power threshold, depth
constexpr int kIntRows = 4;    // count, tile_min x/y, rect_w

// first g in [lo, hi) with offs_incl[g] > q (offs_incl non-decreasing)
__device__ __forceinline__ int upper_bound(const int* __restrict__ offs_incl, int lo,
                                           int hi, int q) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(offs_incl + mid) > q) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kBlock) expand_kernel(
    const float* __restrict__ ftab,       // [kFloatRows, n]
    const int* __restrict__ itab,         // [kIntRows, n], row 0 = count
    const int* __restrict__ offs_incl,    // [n] inclusive cumsum of counts
    int n, int max_inst,
    float* __restrict__ frows,            // [kFloatRows, max_inst]
    int* __restrict__ irows) {            // [2 + kIntRows, max_inst]: pos, k, itab rows
  __shared__ int s_owner[2];
  const int total = __ldg(offs_incl + n - 1);
  const int last = total - 1;
  const int i0 = blockIdx.x * kBlock;
  if (threadIdx.x < 2) {
    const int q = min(i0 + (threadIdx.x == 0 ? 0 : kBlock - 1), last);
    s_owner[threadIdx.x] = total > 0 ? upper_bound(offs_incl, 0, n, q) : 0;
  }
  __syncthreads();
  const int i = i0 + threadIdx.x;
  if (i >= max_inst) return;

  const int g = total > 0
      ? upper_bound(offs_incl, s_owner[0], s_owner[1] + 1, min(i, last)) : 0;
  const size_t m = static_cast<size_t>(max_inst);
  const size_t nn = static_cast<size_t>(n);
  const int count = __ldg(itab + g);
  const int offs_excl = __ldg(offs_incl + g) - count;

#pragma unroll
  for (int r = 0; r < kFloatRows; ++r) {
    frows[r * m + i] = __ldg(ftab + r * nn + g);
  }
  irows[i] = g;
  irows[m + i] = i - offs_excl;
#pragma unroll
  for (int r = 0; r < kIntRows; ++r) {
    irows[(2 + r) * m + i] = __ldg(itab + r * nn + g);
  }
}

}  // namespace

extern "C" int tpu_splat_expand(const float* ftab, const int* itab, const int* offs_incl,
                                int n, int max_inst, float* frows, int* irows,
                                cudaStream_t stream) {
  if (n <= 0 || max_inst <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (max_inst + kBlock - 1) / kBlock;
  expand_kernel<<<grid, kBlock, 0, stream>>>(ftab, itab, offs_incl, n, max_inst, frows,
                                             irows);
  return static_cast<int>(cudaGetLastError());
}
