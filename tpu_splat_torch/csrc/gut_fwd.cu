// K5 — GUT world-space ray blend, forward, for Hopper (sm_90a).
//
// Replaces: tpu_splat/ops/pallas/gut_kernels.py::_gut_fwd_kernel (wrapper
// gut_blend_forward).
//
// Per tile t and pixel p with world ray direction d (and origin offset do when the rays
// are 8 wide), over the depth-sorted segment [seg_start[t], seg_start[t] + count[t]) of
// the [17, M] instance table, walked in chunks of `chunk` instances:
//   v = M d,  n = v / sqrt(max(|v|^2, 1e-24)),  g = gro (+ M do),  c = n x g
//   alpha = min(op exp(-|c|^2 / 2), 0.999); skip if alpha < 1/255
//   stop BEFORE the instance with T (1 - alpha) < 1e-4; rgb and depth accumulate alpha T.
// out [T, P, 8] = (rgb, T_final, depth, 0, 0, 0); chk [T, P, max_chunks] = each chunk's
// entry transmittance, 0 where the pixel has stopped or the chunk was never visited.
//
// Bound on the H100: operations. About 50 FP32 operations, one square root, one divide
// and one exp per (pixel, instance) pair (68 with per-pixel origins); the bytes (a
// 68-byte feature column per instance per tile, 16 or 32 bytes of ray a pixel, out and
// chk) are far smaller.
//
// Design: as K2 (blend_fwd.cu). One block of 256 threads per tile; at tile 16 a thread
// owns one pixel, at tile 32 four. Each chunk's feature columns are staged coalesced in
// shared memory; every thread then walks the chunk, reading each instance's thirteen
// geometry values once as shared-memory broadcasts for all of its pixels. After each
// chunk the block leaves together once no pixel is still blending. Segments are
// unaligned and read exactly: the TPU kernel's 32-row padded [R, 32, 128] blocks, its
// chunk-aligned segments and its MXU lane for v = M d have no counterpart.
//
// Stop decisions follow the chunked closed form of the plain version bit for bit: the
// within-chunk product cp restarts at 1 at every chunk, T_incl = T_entry * cp, the
// transmittance carried on is T_entry * cp at the last accepted instance, and alpha is
// computed in the plain version's operation order (gut_common.cuh, --fmad=false). Only
// the colour/depth accumulation uses explicit fmaf.

#include "gut_common.cuh"

namespace {

using namespace gut;

template <int PPT, bool ORIGIN>
__global__ void __launch_bounds__(kThreads) gut_fwd_kernel(
    const float* __restrict__ flat, long long stride,  // [17, stride]
    const float* __restrict__ rays,                    // [T, P, 4 | 8]
    const int* __restrict__ seg_start, const int* __restrict__ count,  // [T]
    int chunk, int max_chunks,
    float* __restrict__ out,   // [T, P, 8]
    float* __restrict__ chk) { // [T, P, max_chunks]
  __shared__ float s_feat[kFeat][kMaxChunk];
  constexpr int P = kThreads * PPT;
  const int t = blockIdx.x;
  const int seg0 = seg_start[t];
  const int cnt = min(max(count[t], 0), max_chunks * chunk);
  const int nch = (cnt + chunk - 1) / chunk;

  Ray ray[PPT];
  float tr[PPT], acc[PPT][4];
  bool dead[PPT];
  size_t chk_row[PPT];
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const size_t pix = static_cast<size_t>(t) * P + threadIdx.x + q * kThreads;
    ray[q] = load_ray<ORIGIN>(rays, pix);
    tr[q] = 1.0f;
    dead[q] = false;
    acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.0f;
    chk_row[q] = pix * max_chunks;
  }

  int j = 0;
  bool block_alive = true;
  for (; j < nch && block_alive; ++j) {
    const int n = min(chunk, cnt - j * chunk);
    const long long base = static_cast<long long>(seg0) + static_cast<long long>(j) * chunk;
    if (threadIdx.x < n) stage_features(flat, stride, base + threadIdx.x, s_feat, threadIdx.x);
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
      const Instance in = load_instance(s_feat, c);
      any_live = false;
#pragma unroll
      for (int q = 0; q < PPT; ++q) {
        if (!live[q]) continue;
        const Response s = ray_response<ORIGIN>(in, ray[q]);
        // alpha >= 1/255 iff alpha_raw >= 1/255; a NaN fails both here and in torch
        if (s.alpha_raw >= kMinAlpha) {
          const float alpha = fminf(s.alpha_raw, kMaxAlpha);
          const float cp_next = cp[q] * (1.0f - alpha);
          if (tr[q] * cp_next < kTransmittanceMin) {
            live[q] = false;  // excluded: the stop fires before this instance
            dead[q] = true;
          } else {
            const float w = alpha * (tr[q] * cp[q]);
            acc[q][0] = fmaf(w, s_feat[13][c], acc[q][0]);
            acc[q][1] = fmaf(w, s_feat[14][c], acc[q][1]);
            acc[q][2] = fmaf(w, s_feat[15][c], acc[q][2]);
            acc[q][3] = fmaf(w, s_feat[16][c], acc[q][3]);
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
    const size_t pix = static_cast<size_t>(t) * P + threadIdx.x + q * kThreads;
    float4* o = reinterpret_cast<float4*>(out + pix * 8);
    o[0] = make_float4(acc[q][0], acc[q][1], acc[q][2], tr[q]);
    o[1] = make_float4(acc[q][3], 0.0f, 0.0f, 0.0f);
  }
}

template <int PPT, bool ORIGIN>
void launch(const float* flat, long long stride, const float* rays, const int* seg_start,
            const int* count, int n_tiles, int chunk, int max_chunks, float* out, float* chk,
            cudaStream_t stream) {
  gut_fwd_kernel<PPT, ORIGIN><<<n_tiles, kThreads, 0, stream>>>(
      flat, stride, rays, seg_start, count, chunk, max_chunks, out, chk);
}

}  // namespace

extern "C" int tpu_splat_gut_fwd(const float* flat, long long stride, const float* rays,
                                 int ray_width, const int* seg_start, const int* count,
                                 int n_tiles, int tile_size, int chunk, int max_chunks,
                                 float* out, float* chk, cudaStream_t stream) {
  if (n_tiles <= 0) return 0;
  const int p = tile_size * tile_size;
  if (chunk <= 0 || chunk > kMaxChunk || max_chunks <= 0 ||
      (ray_width != 4 && ray_width != 8) || (p != kThreads && p != 4 * kThreads)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool origin = ray_width == 8;
  if (p == kThreads) {
    (origin ? launch<1, true> : launch<1, false>)(flat, stride, rays, seg_start, count,
                                                  n_tiles, chunk, max_chunks, out, chk, stream);
  } else {
    (origin ? launch<4, true> : launch<4, false>)(flat, stride, rays, seg_start, count,
                                                  n_tiles, chunk, max_chunks, out, chk, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
