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
// Bound on the H100: operations. About 49 FP32 operations, one square root, one divide and
// one exp for each (pixel, instance) pair the data needs: the pairs a pixel uses and the one
// that stops it. Most of a tile's pairs fail the alpha test; the cull below keeps the kernel
// from evaluating most of those (PERF.md has the pair counts). The bytes (a 68-byte feature
// column per instance per tile, 16 or 32 bytes of ray a pixel, out and chk) are smaller.
//
// Design: K2's (blend_fwd.cu). One block of 256 threads per tile; at tile 16 a thread owns
// one pixel, at tile 32 four. Each warp owns 8x4-pixel sub-rectangles (gut_common.cuh) and
// computes, at kernel start, one ray cone per sub-rectangle in double from its 32 rays,
// kept in shared memory. Each chunk's feature columns are staged coalesced in shared
// memory, and the staging thread computes the instance's cull sphere beside them. A warp
// then tests the chunk's instances 32 at a time against its cones (one lane an instance,
// one ballot), walks the set bits in depth order, and evaluates only the sub-rectangles
// each instance may meet; every thread reads the instance's thirteen geometry values once
// as shared-memory broadcasts for all of its pixels. A warp stops walking a chunk once none
// of its pixels is still blending; after each chunk the block leaves together once no pixel
// is. Segments are unaligned and read exactly: the TPU kernel's 32-row padded
// [R, 32, 128] blocks, its chunk-aligned segments and its MXU lane for v = M d have no
// counterpart. The zeros of the chunks the block never entered are written last, coalesced
// along the tile's chk rows.
//
// Stop decisions follow the chunked closed form of the plain version bit for bit: the
// within-chunk product cp restarts at 1 at every chunk, T_incl = T_entry * cp, the
// transmittance carried on is T_entry * cp at the last accepted instance, and alpha is
// computed in the plain version's operation order (gut_common.cuh, --fmad=false). Only
// the colour/depth accumulation uses explicit fmaf. The cull skips only pairs this
// arithmetic rejects, so a pixel accepts the same instances in the same order as a walk
// of every pair.
//
// Occupancy: the double-precision cone and sphere code raises the register count (ptxas
// -v, CUDA 12.9: from 88 to 126 at tile 32 and from 47 to 102 at tile 16, rays 4 wide), so
// __launch_bounds__ asks for three blocks an SM at tile 32 and four at tile 16 when the
// rays are 4 wide, as K2 does (PERF.md has the measured effect). Rays 8 wide (ortho,
// rolling shutter) keep the compiler's choice. Putting the sphere in a __noinline__
// function left the count where it was.

#include "gut_common.cuh"

namespace {

using namespace gut;

template <int PPT, bool ORIGIN>
__global__ void __launch_bounds__(kThreads, ORIGIN ? 1 : (PPT == 1 ? 4 : 3)) gut_fwd_kernel(
    const float* __restrict__ flat, long long stride,  // [17, stride]
    const float* __restrict__ rays,                    // [T, P, 4 | 8]
    const int* __restrict__ seg_start, const int* __restrict__ count,  // [T]
    int chunk, int max_chunks,
    float* __restrict__ out,   // [T, P, 8]
    float* __restrict__ chk) { // [T, P, max_chunks]
  using L = Layout<PPT>;
  __shared__ float s_feat[kFeat][kMaxChunk];
  __shared__ float s_sph[kSph][kMaxChunk];
  __shared__ float s_cone[kWarps][PPT][kCone];
  __shared__ float s_domax[kWarps];
  constexpr int P = kThreads * PPT;
  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int seg0 = seg_start[t];
  const int cnt = min(max(count[t], 0), max_chunks * chunk);
  const int nch = (cnt + chunk - 1) / chunk;

  Ray ray[PPT];
  float tr[PPT], acc[PPT][4];
  bool dead[PPT];
  int pix[PPT];
  float domax = 0.0f;
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    pix[q] = L::y(warp, lane, q) * L::kTile + L::x(warp, lane, q);
    ray[q] = load_ray<ORIGIN>(rays, static_cast<size_t>(t) * P + pix[q]);
    domax = fmaxf(domax, warp_cone<ORIGIN>(ray[q].d, ray[q].o, s_cone[warp][q], lane));
    tr[q] = 1.0f;
    dead[q] = false;
    acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.0f;
  }
  double do_max = 0.0;  // the tile's largest |do|, for the spheres' rounding term
  if (ORIGIN) {
    if (lane == 0) s_domax[warp] = domax;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) do_max = fmax(do_max, static_cast<double>(s_domax[w]));
  }
  const size_t chk0 = static_cast<size_t>(t) * P * max_chunks;

  int j = 0;
  bool block_alive = true;
  for (; j < nch && block_alive; ++j) {
    const int n = min(chunk, cnt - j * chunk);
    const long long base = static_cast<long long>(seg0) + static_cast<long long>(j) * chunk;
    if (threadIdx.x < n) {
      stage_instance(flat, stride, base + threadIdx.x, s_feat, s_sph, threadIdx.x, do_max);
    }
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      chk[chk0 + static_cast<size_t>(pix[q]) * max_chunks + j] = dead[q] ? 0.0f : tr[q];
    }
    __syncthreads();  // also publishes s_cone before the first chunk

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
      // which of these 32 instances may meet which of the warp's sub-rectangles
      const unsigned mine = b0 + lane < n ? cone_mask<PPT>(s_sph, b0 + lane, s_cone[warp]) : 0u;
      unsigned bits = __ballot_sync(kFullMask, mine != 0u);
      while (bits != 0u) {
        const int k = __ffs(bits) - 1;
        bits &= bits - 1u;
        const unsigned qmask = PPT == 1 ? 1u : __shfl_sync(kFullMask, mine, k);
        const int c = b0 + k;
        const Instance in = load_instance(s_feat, c);
#pragma unroll
        for (int q = 0; q < PPT; ++q) {
          if (!live[q] || !((qmask >> q) & 1u)) continue;
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
    // also the barrier before the next chunk overwrites s_feat and s_sph
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
  if (chunk <= 0 || chunk > kMaxChunk || max_chunks <= 0 ||
      (ray_width != 4 && ray_width != 8) ||
      (tile_size != Layout<1>::kTile && tile_size != Layout<4>::kTile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool origin = ray_width == 8;
  if (tile_size == Layout<1>::kTile) {
    (origin ? launch<1, true> : launch<1, false>)(flat, stride, rays, seg_start, count,
                                                  n_tiles, chunk, max_chunks, out, chk, stream);
  } else {
    (origin ? launch<4, true> : launch<4, false>)(flat, stride, rays, seg_start, count,
                                                  n_tiles, chunk, max_chunks, out, chk, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
