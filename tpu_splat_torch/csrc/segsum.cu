// K4 — per-Gaussian sums over emission slots, for Hopper (sm_90a).
//
// Replaces: tpu_splat/ops/pallas/raster.py::_segsum_kernel (wrapper segsum_emission).
//
// Emission order is Gaussian-id order: Gaussian g owns the contiguous run of emission
// slots [start[g], end[g]). Slot e's F values (F = 10 on the pinhole path, 17 on the GUT
// path) are column col(e) of rows [F, rstride]: col(e) = cols[e], the emission->column
// index, when the rows are the tile-sorted per-instance rows the blend backward wrote, or
// col(e) = e for rows already in emission order (cols null).
//   out[f, g] = sum over e in [start[g], end[g]) of rows[f, col(e)],   0 for an empty run.
//
// Bound on the H100: bytes. Each owned slot's F floats are read once (4 F B) with its
// column index (4 B); each Gaussian's F sums are written and its two bounds read
// (4 F + 8 B). One add per value read. Through cols the reads of rows land at random
// columns: each 4-byte value takes a 32-byte sector (at most 8x the values' bytes). That
// sector traffic, not the bound, is what the kernel pays for; it replaces a gather that
// wrote every row at random columns of an emission-order copy and read the copy back.
//
// Design. The sums run in grid passes of G rows (blockIdx.y; G = rows_per_pass, chosen
// by the wrapper so that a pass's rows fit in half the 50 MB L2: 3 rows of 2M columns).
// Blocks are dispatched in grid order, so the card works on one pass at a time and a
// sector fetched for one column stays in L2 for the other seven columns it holds. With all
// the rows in one pass (79 MB at 10 rows, 138 MB at 17) a sector leaves L2 before its
// other columns are read, and the kernel was slower than the gather it replaces
// (ab_segred_kernels.py times every pass size). In emission order (cols null) the reads
// are coalesced and one pass takes every row.
// A block owns 256 consecutive Gaussians, one a thread; their runs lie back to back, so
// the block's short runs (at most kLongRun slots) form one window of emission slots. The
// block stages the window kWindow slots at a time in shared memory [G][kWindow]: thread i
// reads the column index of slot lo + i (coalesced) and then issues the G loads of its
// slot back to back, so a thread has all its slot's random reads in flight at once, where
// the earlier design (one thread walking its run feature by feature) waited on each. Each
// thread then sums its own run from shared memory, feature by feature, slot by slot in run
// order: the same adds in the same order as the plain version and as the earlier gather +
// K4, so every run of at most kLongRun slots gives the same bits. Runs are skewed and no
// maximum is assumed. A window skips what no short run of the block needs (it jumps past a
// long run), so a long run is never staged whole. The block then takes its long runs one
// after the other, all 256 threads together: thread t adds slots s + t, s + t + 256, ...
// in order (kUnroll of them in flight), the 32 lanes of a warp combine by a butterfly of
// shuffles, and the eight warps' sums add in warp order. That order is fixed, so a launch
// repeats its bits; against the float64 plain version its error is at most
// (L / 256 + 13) u of the run's magnitude (u = 2^-24, L slots), far less for gradient rows
// of mixed sign. The TPU kernel's windowed one-hot matmuls, padding, rank sentinel and
// per-block window starts have no counterpart here.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWindow = 1024;
constexpr int kLongRun = 64;
constexpr int kUnroll = 2;
constexpr unsigned kFullMask = 0xffffffffu;

template <bool kCols>
__device__ __forceinline__ int column(const int* __restrict__ cols, int e) {
  return kCols ? __ldg(cols + e) : e;
}

// Rows [f0, f0 + G) of the sums, f0 = blockIdx.y * G (rows past nfeat are skipped).
template <int G, bool kCols>
__global__ void __launch_bounds__(kThreads) segsum_kernel(
    const float* __restrict__ rows, long long rstride, int nfeat,  // [nfeat, rstride]
    const int* __restrict__ cols, int n_slots,                     // [n_slots] or null
    const int* __restrict__ start, const int* __restrict__ end, int n,  // [n]
    float* __restrict__ out, long long ostride) {  // [nfeat, ostride]
  extern __shared__ float s_val[];  // [G][kWindow]
  __shared__ int s_lo, s_hi;
  __shared__ int2 s_run[kThreads];
  __shared__ unsigned s_long[kWarps];
  __shared__ float s_part[kWarps][G];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int f0 = blockIdx.y * G;
  const int n_rows = min(G, nfeat - f0);
  rows += f0 * rstride;
  out += f0 * ostride;
  const int g = blockIdx.x * kThreads + threadIdx.x;
  int s = 0, e = 0;
  if (g < n) {
    e = min(max(end[g], 0), n_slots);
    s = min(max(start[g], 0), e);
  }
  const bool is_long = e - s > kLongRun;
  const bool is_short = e > s && !is_long;

  // -- the short runs: windows of staged slots
  if (threadIdx.x == 0) {
    s_lo = INT_MAX;
    s_hi = 0;
  }
  __syncthreads();
  if (is_short) {
    atomicMin(&s_lo, s);
    atomicMax(&s_hi, e);
  }
  __syncthreads();
  const int hi = s_hi;
  int lo = s_lo;
  float sum[G];
#pragma unroll
  for (int f = 0; f < G; ++f) sum[f] = 0.0f;
  while (lo < hi) {
    const int len = min(kWindow, hi - lo);
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const int c = column<kCols>(cols, lo + i);
      float v[G];
#pragma unroll
      for (int f = 0; f < G; ++f) v[f] = f < n_rows ? __ldg(rows + f * rstride + c) : 0.0f;
#pragma unroll
      for (int f = 0; f < G; ++f) s_val[f * kWindow + i] = v[f];
    }
    __syncthreads();
    if (is_short) {
      const int a = max(s, lo) - lo, b = min(e, lo + len) - lo;
#pragma unroll
      for (int f = 0; f < G; ++f) {
        for (int k = a; k < b; ++k) sum[f] += s_val[f * kWindow + k];
      }
    }
    const int done = lo + len;
    __syncthreads();  // every thread has read s_lo and its slots before they change
    if (threadIdx.x == 0) s_lo = INT_MAX;
    __syncthreads();
    if (is_short && e > done) atomicMin(&s_lo, max(s, done));
    __syncthreads();
    lo = s_lo;
  }
  if (g < n && !is_long) {
#pragma unroll
    for (int f = 0; f < G; ++f) {
      if (f < n_rows) out[f * ostride + g] = sum[f];
    }
  }

  // -- the long runs, one after the other, by the whole block
  s_run[threadIdx.x] = make_int2(s, e);
  const unsigned ballot = __ballot_sync(kFullMask, is_long);
  if (lane == 0) s_long[warp] = ballot;
  __syncthreads();
  for (int w = 0; w < kWarps; ++w) {
    unsigned todo = s_long[w];
    while (todo != 0) {
      const int t = w * 32 + __ffs(todo) - 1;
      todo &= todo - 1;
      const int ls = s_run[t].x, le = s_run[t].y;
      float acc[G];
#pragma unroll
      for (int f = 0; f < G; ++f) acc[f] = 0.0f;
      for (int k0 = ls + threadIdx.x; k0 < le; k0 += kUnroll * kThreads) {
        int c[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int k = k0 + u * kThreads;
          c[u] = k < le ? column<kCols>(cols, k) : -1;
        }
        float v[kUnroll][G];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
          for (int f = 0; f < G; ++f) {
            v[u][f] = c[u] >= 0 && f < n_rows ? __ldg(rows + f * rstride + c[u]) : 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
          for (int f = 0; f < G; ++f) acc[f] += v[u][f];
        }
      }
#pragma unroll
      for (int f = 0; f < G; ++f) {
#pragma unroll
        for (int sh = 16; sh > 0; sh >>= 1) acc[f] += __shfl_xor_sync(kFullMask, acc[f], sh);
      }
      if (lane == 0) {
#pragma unroll
        for (int f = 0; f < G; ++f) s_part[warp][f] = acc[f];
      }
      __syncthreads();
      if (threadIdx.x < n_rows) {
        float total = 0.0f;
#pragma unroll
        for (int w2 = 0; w2 < kWarps; ++w2) total += s_part[w2][threadIdx.x];
        out[threadIdx.x * ostride + blockIdx.x * kThreads + t] = total;
      }
      __syncthreads();  // before the next long run overwrites s_part
    }
  }
}

template <int G, bool kCols>
int launch(const float* rows, long long rstride, int nfeat, const int* cols, int n_slots,
           const int* start, const int* end, int n, float* out, long long ostride,
           cudaStream_t stream) {
  constexpr size_t kSmem = sizeof(float) * G * kWindow;  // 68 KB at G = 17
  static const cudaError_t attr = cudaFuncSetAttribute(
      segsum_kernel<G, kCols>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((n + kThreads - 1) / kThreads, (nfeat + G - 1) / G);
  segsum_kernel<G, kCols><<<grid, kThreads, kSmem, stream>>>(
      rows, rstride, nfeat, cols, n_slots, start, end, n, out, ostride);
  return static_cast<int>(cudaGetLastError());
}

template <bool kCols>
int launch_rows(int rows_per_pass, const float* rows, long long rstride, int nfeat,
                const int* cols, int n_slots, const int* start, const int* end, int n,
                float* out, long long ostride, cudaStream_t stream) {
  switch (rows_per_pass) {
#define TPU_SPLAT_SEGSUM_CASE(G) \
  case G:                        \
    return launch<G, kCols>(rows, rstride, nfeat, cols, n_slots, start, end, n, out, ostride, stream);
    TPU_SPLAT_SEGSUM_CASE(1)
    TPU_SPLAT_SEGSUM_CASE(2)
    TPU_SPLAT_SEGSUM_CASE(3)
    TPU_SPLAT_SEGSUM_CASE(5)
    TPU_SPLAT_SEGSUM_CASE(10)
    TPU_SPLAT_SEGSUM_CASE(17)
#undef TPU_SPLAT_SEGSUM_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// cols: the emission->column index [n_slots], or null for rows in emission order.
// rows_per_pass: rows of `rows` a grid pass reads, one of 1, 2, 3, 5, 10, 17.
extern "C" int tpu_splat_segsum(const float* rows, int nfeat, long long rstride,
                                const int* cols, int n_slots, int rows_per_pass,
                                const int* start, const int* end, int n, float* out,
                                long long ostride, cudaStream_t stream) {
  if (n <= 0) return 0;
  if ((nfeat != 10 && nfeat != 17) || rows_per_pass > nfeat) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return cols ? launch_rows<true>(rows_per_pass, rows, rstride, nfeat, cols, n_slots, start,
                                  end, n, out, ostride, stream)
              : launch_rows<false>(rows_per_pass, rows, rstride, nfeat, cols, n_slots, start,
                                   end, n, out, ostride, stream);
}
