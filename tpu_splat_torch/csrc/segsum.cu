// K4 — per-Gaussian sums of emission-order gradient rows, for Hopper (sm_90a).
//
// Replaces: tpu_splat/ops/pallas/raster.py::_segsum_kernel (wrapper segsum_emission).
//
// Emission order is Gaussian-id order: Gaussian g owns the contiguous run of emission
// slots [start[g], end[g]). For the F gradient features f (F = 10 on the pinhole path,
// 17 on the GUT path),
//   out[f, g] = sum over e in [start[g], end[g]) of rows[f, e],   0 for an empty run.
//
// Bound on the H100: bytes. Every owned slot's F floats are read once, F floats a
// Gaussian are written, plus the two run bounds; one add per value read.
//
// Design: one thread per Gaussian walks its own run, feature by feature. Neighbouring
// threads own neighbouring runs, so a warp's reads of one feature row fall in one short
// contiguous span. Runs are short on average but skewed, and no maximum is assumed: a
// run longer than kLongRun slots is left to the whole warp, which strides over it with
// 32 lanes and reduces by shuffles. Every sum has a fixed order, so results are the same
// from run to run. The TPU kernel's windowed one-hot matmuls, its padding, its rank
// sentinel and its per-block window starts have no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLongRun = 64;
constexpr unsigned kFullMask = 0xffffffffu;

template <int kFeat>
__global__ void __launch_bounds__(kThreads) segsum_kernel(
    const float* __restrict__ rows, long long rstride, int n_slots,  // [kFeat, rstride]
    const int* __restrict__ start, const int* __restrict__ end, int n,  // [n]
    float* __restrict__ out, long long ostride) {  // [kFeat, ostride]
  const int g = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  int s = 0, e = 0;
  if (g < n) {
    e = min(max(end[g], 0), n_slots);
    s = min(max(start[g], 0), e);
  }
  const bool is_long = e - s > kLongRun;
  if (g < n && !is_long) {
#pragma unroll
    for (int f = 0; f < kFeat; ++f) {
      const float* row = rows + f * rstride;
      float sum = 0.0f;
      for (int k = s; k < e; ++k) sum += __ldg(row + k);
      out[f * ostride + g] = sum;
    }
  }
  // long runs, one after the other, by the whole warp
  unsigned todo = __ballot_sync(kFullMask, is_long);
  while (todo != 0) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const int ls = __shfl_sync(kFullMask, s, src);
    const int le = __shfl_sync(kFullMask, e, src);
    const int lg = __shfl_sync(kFullMask, g, src);
    for (int f = 0; f < kFeat; ++f) {
      const float* row = rows + f * rstride;
      float sum = 0.0f;
      for (int k = ls + lane; k < le; k += 32) sum += __ldg(row + k);
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1) sum += __shfl_xor_sync(kFullMask, sum, sh);
      if (lane == 0) out[f * ostride + lg] = sum;
    }
  }
}

}  // namespace

extern "C" int tpu_splat_segsum(const float* rows, int nfeat, long long rstride, int n_slots,
                                const int* start, const int* end, int n, float* out,
                                long long ostride, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  if (nfeat == 10) {
    segsum_kernel<10><<<blocks, kThreads, 0, stream>>>(rows, rstride, n_slots, start, end, n,
                                                       out, ostride);
  } else if (nfeat == 17) {
    segsum_kernel<17><<<blocks, kThreads, 0, stream>>>(rows, rstride, n_slots, start, end, n,
                                                       out, ostride);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
