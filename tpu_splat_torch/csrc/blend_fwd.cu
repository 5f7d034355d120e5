// K2 — per-tile front-to-back blend, forward, for Hopper (sm_90a).
//
// Replaces: tpu_splat/ops/pallas/blend.py::_fwd_kernel (wrapper blend_forward), in both
// layouts of the feature-major instance table: the f32 F_* rows ([>=10, M] float) and
// the bf16 B_* rows ([>=15, M] __nv_bfloat16, mean and conic as hi/lo pairs). The loader
// in blend_common.cuh rebuilds float features once per staged instance; the arithmetic
// below is the same for both.
//
// Per tile t and pixel p (centre tile*ts + idx + 0.5), over the depth-sorted segment
// [seg_start[t], seg_start[t] + count[t]) walked in chunks of `chunk` instances:
//   sigma = 0.5 (a dx^2 + c dy^2) + b dx dy,  alpha = min(op exp(-max(sigma, 0)), 0.999)
//   skip if sigma < 0 or alpha < 1/255; stop BEFORE the instance with T (1 - alpha) < 1e-4
//   rgb and depth accumulate alpha * T.
// out [T, P, 8] = (rgb, T_final, depth, 0, 0, 0); chk [T, P, max_chunks] = each chunk's
// entry transmittance, 0 where the pixel has stopped or the chunk was never visited.
//
// Bound on the H100: operations. About 20 FP32 operations and one exp per
// (pixel, instance) pair; the bytes (a 40-byte feature column per instance per tile,
// plus out and chk) are far smaller.
//
// Design: one block of 256 threads per tile; at tile 16 a thread owns one pixel, at
// tile 32 four (a 1024-thread block would have to fit in 64 registers a thread). Each
// chunk's feature columns are staged cooperatively and coalesced in shared memory, then
// every thread composites its pixels sequentially, reading each instance's features as
// a shared-memory broadcast once for all of its pixels. After each chunk the block
// leaves together once no pixel is still blending (__syncthreads_or). Segments are
// unaligned and read exactly; nothing is padded or overread.
//
// Stop decisions follow the chunked closed form of the plain version bit for bit: the
// within-chunk product cp restarts at 1 at every chunk, T_incl = T_entry * cp, and the
// transmittance carried to the next chunk is T_entry * cp at the last accepted instance.
// The library is compiled with --fmad=false so that sigma, alpha and these products round
// exactly as PyTorch's separate elementwise ops do; only the colour/depth accumulation
// uses explicit fmaf.

#include "blend_common.cuh"

namespace {

using namespace blend;

template <int PPT>
__global__ void __launch_bounds__(kThreads) blend_fwd_kernel(
    const void* __restrict__ flat, bool is_bf16, long long stride,  // [rows, stride]
    const int* __restrict__ seg_start, const int* __restrict__ count,  // [T]
    int grid_w, int tile_size, int chunk, int max_chunks,
    float* __restrict__ out,   // [T, P, 8]
    float* __restrict__ chk) { // [T, P, max_chunks]
  __shared__ float s_feat[kFeat][kMaxChunk];
  constexpr int P = kThreads * PPT;
  const int t = blockIdx.x;
  const int seg0 = seg_start[t];
  const int cnt = min(max(count[t], 0), max_chunks * chunk);
  const int nch = (cnt + chunk - 1) / chunk;
  const int tx = t % grid_w;
  const int ty = t / grid_w;

  float px[PPT], py[PPT], tr[PPT], acc[PPT][4];
  bool dead[PPT];
  size_t chk_row[PPT];
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const int p = threadIdx.x + q * kThreads;
    px[q] = static_cast<float>(tx * tile_size + p % tile_size) + 0.5f;
    py[q] = static_cast<float>(ty * tile_size + p / tile_size) + 0.5f;
    tr[q] = 1.0f;
    dead[q] = false;
    acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.0f;
    chk_row[q] = (static_cast<size_t>(t) * P + p) * max_chunks;
  }

  int j = 0;
  bool block_alive = true;
  for (; j < nch && block_alive; ++j) {
    const int n = min(chunk, cnt - j * chunk);
    const long long base = static_cast<long long>(seg0) + static_cast<long long>(j) * chunk;
    if (threadIdx.x < n) {
      stage_features(flat, is_bf16, stride, base + threadIdx.x, s_feat, threadIdx.x);
    }
#pragma unroll
    for (int q = 0; q < PPT; ++q) chk[chk_row[q] + j] = dead[q] ? 0.0f : tr[q];
    __syncthreads();

    float cp[PPT];
    bool live[PPT];
    bool any_live = false;
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      cp[q] = 1.0f;
      live[q] = !dead[q];
      any_live |= live[q];
    }
    for (int c = 0; c < n && any_live; ++c) {
      const float mx = s_feat[0][c], my = s_feat[1][c];
      const float ca = s_feat[2][c], cb = s_feat[3][c], cc = s_feat[4][c];
      const float op = s_feat[5][c];
      any_live = false;
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
        if (!live[q]) continue;
        const float dx = mx - px[q];
        const float dy = my - py[q];
        const float sigma = 0.5f * (ca * dx * dx + cc * dy * dy) + cb * dx * dy;
        const float alpha = fminf(op * expf(-fmaxf(sigma, 0.0f)), kMaxAlpha);
        if (sigma >= 0.0f && alpha >= kMinAlpha) {
          const float cp_next = cp[q] * (1.0f - alpha);
          if (tr[q] * cp_next < kTransmittanceMin) {
            live[q] = false;  // excluded: the stop fires before this instance
            dead[q] = true;
          } else {
            const float w = alpha * (tr[q] * cp[q]);
            acc[q][0] = fmaf(w, s_feat[6][c], acc[q][0]);
            acc[q][1] = fmaf(w, s_feat[7][c], acc[q][1]);
            acc[q][2] = fmaf(w, s_feat[8][c], acc[q][2]);
            acc[q][3] = fmaf(w, s_feat[9][c], acc[q][3]);
            cp[q] = cp_next;
          }
        }
        any_live |= live[q];
      }
    }
    bool thread_alive = false;
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      tr[q] = tr[q] * cp[q];  // T after the last accepted instance of this chunk
      thread_alive |= !dead[q];
    }
    // also the barrier before the next chunk overwrites s_feat
    block_alive = __syncthreads_or(thread_alive) != 0;
  }

#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    for (int jj = j; jj < max_chunks; ++jj) chk[chk_row[q] + jj] = 0.0f;
    const int p = threadIdx.x + q * kThreads;
    float4* o = reinterpret_cast<float4*>(out + (static_cast<size_t>(t) * P + p) * 8);
    o[0] = make_float4(acc[q][0], acc[q][1], acc[q][2], tr[q]);
    o[1] = make_float4(acc[q][3], 0.0f, 0.0f, 0.0f);
  }
}

}  // namespace

extern "C" int tpu_splat_blend_fwd(const void* flat, int is_bf16, long long stride,
                                   const int* seg_start, const int* count, int n_tiles,
                                   int grid_w, int tile_size, int chunk, int max_chunks,
                                   float* out, float* chk, cudaStream_t stream) {
  if (n_tiles <= 0) return 0;
  if (chunk <= 0 || chunk > kMaxChunk || max_chunks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int p = tile_size * tile_size;
  if (p == kThreads) {
    blend_fwd_kernel<1><<<n_tiles, kThreads, 0, stream>>>(
        flat, is_bf16 != 0, stride, seg_start, count, grid_w, tile_size, chunk, max_chunks,
        out, chk);
  } else if (p == 4 * kThreads) {
    blend_fwd_kernel<4><<<n_tiles, kThreads, 0, stream>>>(
        flat, is_bf16 != 0, stride, seg_start, count, grid_w, tile_size, chunk, max_chunks,
        out, chk);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
