// K2 — per-tile front-to-back blend, forward, for Hopper (sm_90a).
//
// Replaces: tpu_splat/ops/pallas/blend.py::_fwd_kernel (wrapper blend_forward), in both
// layouts of the feature-major instance table: the f32 F_* rows ([>=10, M] float) and
// the bf16 B_* rows ([>=15, M] __nv_bfloat16, mean and conic as hi/lo pairs). The loader
// in blend_common.cuh rebuilds float features once per staged instance; the arithmetic
// below is the same for both.
//
// Per tile t and pixel p (centre tile*ts + idx + 0.5; tile t sits at tile row
// t / grid_w + tile_y0 of the image, so a window of tile rows blends at its global pixel
// centres and culls on the global 8x4 sub-rectangle grid), over the depth-sorted segment
// [seg_start[t], seg_start[t] + count[t]) walked in chunks of `chunk` instances:
//   sigma = 0.5 (a dx^2 + c dy^2) + b dx dy,  alpha = min(op exp(-max(sigma, 0)), 0.999)
//   skip if sigma < 0 or alpha < 1/255; stop BEFORE the instance with T (1 - alpha) < 1e-4
//   rgb and depth accumulate alpha * T.
// out [T, P, 8] = (rgb, T_final, depth, 0, 0, 0); chk [T, P, max_chunks] = each chunk's
// entry transmittance, 0 where the pixel has stopped or the chunk was never visited.
//
// Bound on the H100: bytes at the render frame (the feature columns once a tile, out and
// chk: 283 MB, 0.084 ms, twice the operation bound); at the train step bytes and operations
// are about even (0.037 and 0.040 ms). The operations the data needs are about 20 FP32
// operations and one exp for each pair a pixel uses and for the pair that stops it; most
// of a tile's (pixel, instance) pairs fail the alpha test, and the cull below keeps the
// kernel from evaluating most of those (PERF.md has the pair counts).
//
// Design: one block of 256 threads per tile; at tile 16 a thread owns one pixel, at
// tile 32 four (a 1024-thread block would have to fit in 64 registers a thread). Each warp
// owns a compact rectangle of 8x4-pixel sub-rectangles (blend_common.cuh). Each chunk's
// feature columns are staged cooperatively and coalesced in shared memory, and the staging
// thread computes the instance's cull box beside them. A warp then tests the chunk's
// instances 32 at a time against its sub-rectangles (one lane an instance, one ballot),
// walks the set bits in depth order, and composites only the sub-rectangles each instance
// meets; every thread reads the instance's features as a shared-memory broadcast once for
// all of its pixels. A warp stops walking a chunk once none of its pixels is still
// blending; after each chunk the block leaves together once no pixel is (__syncthreads_or).
// Segments are unaligned and read exactly; nothing is padded or overread. The zeros of
// the chunks the block never entered are written last, coalesced along the tile's chk
// rows (a pixel's own row is max_chunks floats long: written pixel by pixel, every lane
// of a store would land in a different 32-byte sector).
//
// Stop decisions follow the chunked closed form of the plain version bit for bit: the
// within-chunk product cp restarts at 1 at every chunk, T_incl = T_entry * cp, and the
// transmittance carried to the next chunk is T_entry * cp at the last accepted instance.
// The library is compiled with --fmad=false so that sigma, alpha and these products round
// exactly as PyTorch's separate elementwise ops do; only the colour/depth accumulation
// uses explicit fmaf. The cull skips only pairs this arithmetic rejects, so a pixel accepts
// the same instances in the same order as a walk of every pair.
//
// ptxas (-Xptxas -v, CUDA 12.9, sm_90a): tile 16 64 registers, tile 32 76 registers, no
// spills. At tile 32 __launch_bounds__(256, 3) keeps three blocks an SM (96 registers
// without it); a fourth block (64 registers, 28 bytes of spills) was no faster. At tile 16
// a bound of 32 registers (eight blocks) spilled 108 bytes and was 4% slower.

#include "blend_common.cuh"

namespace {

using namespace blend;

template <int PPT>
__global__ void __launch_bounds__(kThreads, PPT == 1 ? 1 : 3) blend_fwd_kernel(
    const void* __restrict__ flat, bool is_bf16, long long stride,  // [rows, stride]
    const int* __restrict__ seg_start, const int* __restrict__ count,  // [T]
    int grid_w, int tile_y0, int chunk, int max_chunks,
    float* __restrict__ out,   // [T, P, 8]
    float* __restrict__ chk) { // [T, P, max_chunks]
  using L = Layout<PPT>;
  __shared__ float s_feat[kFeat][kMaxChunk];
  __shared__ float s_box[kBox][kMaxChunk];
  constexpr int P = kThreads * PPT;
  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int seg0 = seg_start[t];
  const int cnt = min(max(count[t], 0), max_chunks * chunk);
  const int nch = (cnt + chunk - 1) / chunk;
  const int tx0 = (t % grid_w) * L::kTile;
  const int ty0 = (t / grid_w + tile_y0) * L::kTile;  // global row of the tile
  // pixel centre of the warp rectangle's top-left pixel
  const float rx0 = static_cast<float>(tx0 + L::rect_x(warp)) + 0.5f;
  const float ry0 = static_cast<float>(ty0 + L::rect_y(warp)) + 0.5f;

  float px[PPT], py[PPT], tr[PPT], acc[PPT][4];
  bool dead[PPT];
  int pix[PPT];
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const int x = L::x(warp, lane, q), y = L::y(warp, lane, q);
    pix[q] = y * L::kTile + x;
    px[q] = static_cast<float>(tx0 + x) + 0.5f;
    py[q] = static_cast<float>(ty0 + y) + 0.5f;
    tr[q] = 1.0f;
    dead[q] = false;
    acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.0f;
  }
  const size_t chk0 = static_cast<size_t>(t) * P * max_chunks;

  int j = 0;
  bool block_alive = true;
  for (; j < nch && block_alive; ++j) {
    const int n = min(chunk, cnt - j * chunk);
    const long long base = static_cast<long long>(seg0) + static_cast<long long>(j) * chunk;
    if (threadIdx.x < n) {
      stage_instance(flat, is_bf16, stride, base + threadIdx.x, s_feat, s_box, threadIdx.x);
    }
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      chk[chk0 + static_cast<size_t>(pix[q]) * max_chunks + j] = dead[q] ? 0.0f : tr[q];
    }
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
    for (int b0 = 0; b0 < n && __any_sync(kFullMask, any_live); b0 += 32) {
      // which of these 32 instances meet which of the warp's sub-rectangles
      const unsigned mine =
          b0 + lane < n ? subrect_mask<PPT>(s_box, b0 + lane, rx0, ry0) : 0u;
      unsigned bits = __ballot_sync(kFullMask, mine != 0u);
      while (bits != 0u) {
        const int k = __ffs(bits) - 1;
        bits &= bits - 1u;
        const unsigned qmask = PPT == 1 ? 1u : __shfl_sync(kFullMask, mine, k);
        const int c = b0 + k;
        const float mx = s_feat[0][c], my = s_feat[1][c];
        const float ca = s_feat[2][c], cb = s_feat[3][c], cc = s_feat[4][c];
        const float op = s_feat[5][c];
#pragma unroll
        for (int q = 0; q < PPT; ++q) {
          if (!live[q] || !((qmask >> q) & 1u)) continue;
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
        }
      }
      any_live = false;
#pragma unroll
      for (int q = 0; q < PPT; ++q) any_live |= live[q];
    }
    bool thread_alive = false;
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      tr[q] = tr[q] * cp[q];  // T after the last accepted instance of this chunk
      thread_alive |= !dead[q];
    }
    // also the barrier before the next chunk overwrites s_feat and s_box
    block_alive = __syncthreads_or(thread_alive) != 0;
  }

  // the chunks the block never entered: zeros, written coalesced along the tile's chk rows
  if (j < max_chunks) {
    for (int i = threadIdx.x; i < P * max_chunks; i += kThreads) {
      if (i % max_chunks >= j) chk[chk0 + i] = 0.0f;
    }
  }
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    float4* o = reinterpret_cast<float4*>(out + (static_cast<size_t>(t) * P + pix[q]) * 8);
    o[0] = make_float4(acc[q][0], acc[q][1], acc[q][2], tr[q]);
    o[1] = make_float4(acc[q][3], 0.0f, 0.0f, 0.0f);
  }
}

}  // namespace

extern "C" int tpu_splat_blend_fwd(const void* flat, int is_bf16, long long stride,
                                   const int* seg_start, const int* count, int n_tiles,
                                   int grid_w, int tile_y0, int tile_size, int chunk,
                                   int max_chunks, float* out, float* chk,
                                   cudaStream_t stream) {
  if (n_tiles <= 0) return 0;
  if (chunk <= 0 || chunk > kMaxChunk || max_chunks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tile_size == Layout<1>::kTile) {
    blend_fwd_kernel<1><<<n_tiles, kThreads, 0, stream>>>(
        flat, is_bf16 != 0, stride, seg_start, count, grid_w, tile_y0, chunk, max_chunks,
        out, chk);
  } else if (tile_size == Layout<4>::kTile) {
    blend_fwd_kernel<4><<<n_tiles, kThreads, 0, stream>>>(
        flat, is_bf16 != 0, stride, seg_start, count, grid_w, tile_y0, chunk, max_chunks,
        out, chk);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
