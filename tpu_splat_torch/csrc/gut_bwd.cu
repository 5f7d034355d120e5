// K6 — GUT world-space ray blend, replay backward, for Hopper (sm_90a).
//
// Replaces: tpu_splat/ops/pallas/gut_kernels.py::_gut_bwd_kernel (wrapper
// gut_blend_backward).
//
// For every tile t and every instance column c of its segment
// [seg_start[t], seg_start[t] + count[t]), gflat[0:17, c] is the gradient of
// sum_pixels gout . out with respect to that column's seventeen features (M row-major,
// gro, opacity, rgb, depth), through exactly the (pixel, instance) pairs the forward used:
//   w        = alpha T_excl
//   dL/da    = T_excl (g . col) - suffix / (1 - alpha),  g . col = gr r + gg g + gb b + gd depth
//              suffix = sum over later used instances of w (g . col), plus T_final gT
//   dL/dpow  = dL/da alpha_raw where alpha_raw < 0.999 (alpha not clamped), else 0
//   dL/dc    = -dL/dpow c ;  dL/dn = g x dL/dc ;  dL/dg = dL/dc x n
//   dL/dv    = inorm (dL/dn - n (n . dL/dn))
//   d/dM_ij  = dL/dv_i d_j (+ dL/dg_i do_j)    d/dgro = dL/dg
//   d/dop    = dL/da e (not clamped)            d/d(r, g, b, depth) = w (gr, gg, gb, gd)
// each summed over the tile's pixels, in float32. Columns that no tile owns, and columns
// of chunks the forward never reached, are not written: the wrapper hands in a zeroed
// gflat.
//
// Bound on the H100: operations. The forward's ~49 operations for each pair a pixel uses
// or stops at, plus 83 and one more divide for each used pair (the pixel sums included);
// the bytes (feature columns, rays, chk, out, gout read, seventeen floats an instance
// written) are smaller.
//
// Design: K3's (blend_bwd.cu), with seventeen sums an instance instead of ten.
//  * The used set is the forward's: each chunk is replayed front to back from its entry
//    transmittance chk[.., j] (0 = the pixel had stopped or the chunk never ran) with the
//    forward kernel's own decision arithmetic (gut_common.cuh; cp restarts at 1, the test
//    is T_entry (cp (1 - alpha)) < 1e-4). The TPU kernel's reverse chunk order and its
//    triangular suffix matmul have no counterpart.
//  * suffix = total - running prefix, the pixel's total g . out + gT T_final being known
//    from the forward: one front-to-back pass.
//  * The cull of the forward (gut_common.cuh): the same warp sub-rectangles and ray cones,
//    the staging thread computes each instance's sphere beside its features, and a warp
//    replays only the instances its ballot keeps, each only on the sub-rectangles it may
//    meet. The cull skips only pairs the decision arithmetic rejects, so the replay sees
//    the forward's used set.
//  * The pixel reduction: nine of the sums are outer products with the pixel's own ray, so
//    nothing factors out of the pixel sum. A thread adds its own pixels' products; a warp
//    that walked an instance and used it on some lane reduces them by shuffles, and lane 0
//    parks the sums in the warp's shared-memory slice (warps that skip the instance do
//    neither: their slice keeps its zero); after each batch of 32 instances the block adds
//    the eight slices in warp order and writes the columns. No atomics; a fixed order,
//    the same bits from run to run. Shared memory: 17 x 256 staged features, 4 x 256
//    sphere values, 8 x 17 x 32 partial sums and the cones, 39 KB.
//  * 256 threads a block, one pixel a thread at tile 16 and four at tile 32, in the
//    forward's warp sub-rectangles. The block stops at the first chunk that no pixel
//    enters alive. With rays 4 wide __launch_bounds__ asks for three blocks an SM at tile
//    16 (98 registers otherwise: two blocks) and two at tile 32: asked for one, ptxas took
//    137 registers instead of 128, and one block an SM made K6 1.5x slower (PERF.md).

#include "gut_common.cuh"

namespace {

using namespace gut;

constexpr int kBatch = 32;  // instances per cross-warp reduction: one ballot

template <int PPT, bool ORIGIN>
__global__ void __launch_bounds__(kThreads, ORIGIN ? 1 : (PPT == 1 ? 3 : 2)) gut_bwd_kernel(
    const float* __restrict__ flat, long long stride,  // [17, stride]
    const float* __restrict__ rays,                    // [T, P, 4 | 8]
    const int* __restrict__ seg_start, const int* __restrict__ count,  // [T]
    int chunk, int max_chunks,
    const float* __restrict__ chk,   // [T, P, max_chunks]
    const float* __restrict__ out,   // [T, P, 8]
    const float* __restrict__ gout,  // [T, P, 8]
    float* __restrict__ gflat, long long gstride) {  // [17, gstride], zeroed
  using L = Layout<PPT>;
  __shared__ float s_feat[kFeat][kMaxChunk];
  __shared__ float s_sph[kSph][kMaxChunk];
  __shared__ float s_part[kWarps][kFeat][kBatch];
  __shared__ float s_cone[kWarps][PPT][kCone];
  __shared__ float s_domax[kWarps];
  constexpr int P = kThreads * PPT;
  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int seg0 = seg_start[t];
  const int cnt = min(max(count[t], 0), max_chunks * chunk);
  const int nch = (cnt + chunk - 1) / chunk;

  for (int i = threadIdx.x; i < kWarps * kFeat * kBatch; i += kThreads) {
    (&s_part[0][0][0])[i] = 0.0f;
  }

  Ray ray[PPT];
  float g_r[PPT], g_g[PPT], g_b[PPT], g_d[PPT];
  float total[PPT], prefix[PPT], tr[PPT], cp[PPT];
  bool live[PPT];
  size_t chk_row[PPT];
  float domax = 0.0f;
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const size_t pix =
        static_cast<size_t>(t) * P + L::y(warp, lane, q) * L::kTile + L::x(warp, lane, q);
    ray[q] = load_ray<ORIGIN>(rays, pix);
    domax = fmaxf(domax, warp_cone<ORIGIN>(ray[q].d, ray[q].o, s_cone[warp][q], lane));
    const float4 g0 = *reinterpret_cast<const float4*>(gout + pix * 8);
    const float g4 = gout[pix * 8 + 4];
    const float4 o0 = *reinterpret_cast<const float4*>(out + pix * 8);
    const float o4 = out[pix * 8 + 4];
    g_r[q] = g0.x;
    g_g[q] = g0.y;
    g_b[q] = g0.z;
    g_d[q] = g4;
    // sum over all used instances of w (g . col), plus the T_final term
    total[q] = g0.x * o0.x + g0.y * o0.y + g0.z * o0.z + g4 * o4 + g0.w * o0.w;
    prefix[q] = 0.0f;
    chk_row[q] = pix * max_chunks;
  }
  double do_max = 0.0;  // the tile's largest |do|, for the spheres' rounding term
  if (ORIGIN) {
    if (lane == 0) s_domax[warp] = domax;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) do_max = fmax(do_max, static_cast<double>(s_domax[w]));
  }

  for (int j = 0; j < nch; ++j) {
    bool thread_live = false;
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      tr[q] = chk[chk_row[q] + j];
      live[q] = tr[q] > 0.0f;
      cp[q] = 1.0f;
      thread_live |= live[q];
    }
    // also the barrier before s_feat is overwritten and after s_part was zeroed
    if (__syncthreads_or(thread_live) == 0) break;

    const int n = min(chunk, cnt - j * chunk);
    const long long base = static_cast<long long>(seg0) + static_cast<long long>(j) * chunk;
    if (threadIdx.x < n) {
      stage_instance(flat, stride, base + threadIdx.x, s_feat, s_sph, threadIdx.x, do_max);
    }
    __syncthreads();

    for (int b0 = 0; b0 < n; b0 += kBatch) {
      const int m = min(kBatch, n - b0);
      if (__any_sync(kFullMask, thread_live)) {
        // which of these 32 instances may meet which of the warp's sub-rectangles
        const unsigned mine = lane < m ? cone_mask<PPT>(s_sph, b0 + lane, s_cone[warp]) : 0u;
        unsigned bits = __ballot_sync(kFullMask, mine != 0u);
        while (bits != 0u) {
          const int k = __ffs(bits) - 1;
          bits &= bits - 1u;
          const unsigned qmask = PPT == 1 ? 1u : __shfl_sync(kFullMask, mine, k);
          const int c = b0 + k;
          const Instance in = load_instance(s_feat, c);
          float v[kFeat];
#pragma unroll
          for (int f = 0; f < kFeat; ++f) v[f] = 0.0f;
          bool used = false;
#pragma unroll
          for (int q = 0; q < PPT; ++q) {
            if (!live[q] || !((qmask >> q) & 1u)) continue;
            const Response s = ray_response<ORIGIN>(in, ray[q]);
            if (s.alpha_raw >= kMinAlpha) {
              const float alpha = fminf(s.alpha_raw, kMaxAlpha);
              const float one_m = 1.0f - alpha;
              const float cp_next = cp[q] * one_m;
              if (tr[q] * cp_next < kTransmittanceMin) {
                live[q] = false;  // the forward stopped before this instance
              } else {
                const float t_excl = tr[q] * cp[q];
                const float w = alpha * t_excl;
                const float gc = g_r[q] * s_feat[13][c] + g_g[q] * s_feat[14][c] +
                                 g_b[q] * s_feat[15][c] + g_d[q] * s_feat[16][c];
                prefix[q] += w * gc;
                const float suffix = total[q] - prefix[q];
                const float dl_da = t_excl * gc - suffix / one_m;
                const bool not_clamped = s.alpha_raw < kMaxAlpha;
                const float dl_dpow = not_clamped ? dl_da * s.alpha_raw : 0.0f;
                const float dc0 = -dl_dpow * s.c[0];
                const float dc1 = -dl_dpow * s.c[1];
                const float dc2 = -dl_dpow * s.c[2];
                // dL/dn = g x dL/dc ; dL/dg = dL/dc x n
                const float dn0 = s.g[1] * dc2 - s.g[2] * dc1;
                const float dn1 = s.g[2] * dc0 - s.g[0] * dc2;
                const float dn2 = s.g[0] * dc1 - s.g[1] * dc0;
                const float dg[3] = {dc1 * s.n[2] - dc2 * s.n[1],
                                     dc2 * s.n[0] - dc0 * s.n[2],
                                     dc0 * s.n[1] - dc1 * s.n[0]};
                // n = v / |v|: dL/dv = inorm (dL/dn - n (n . dL/dn))
                const float ndn = s.n[0] * dn0 + s.n[1] * dn1 + s.n[2] * dn2;
                const float dv[3] = {s.inorm * (dn0 - s.n[0] * ndn),
                                     s.inorm * (dn1 - s.n[1] * ndn),
                                     s.inorm * (dn2 - s.n[2] * ndn)};
#pragma unroll
                for (int i = 0; i < 3; ++i) {
#pragma unroll
                  for (int kk = 0; kk < 3; ++kk) {
                    v[3 * i + kk] += dv[i] * ray[q].d[kk];
                    if (ORIGIN) v[3 * i + kk] += dg[i] * ray[q].o[kk];
                  }
                  v[9 + i] += dg[i];
                }
                v[12] += not_clamped ? dl_da * s.e : 0.0f;
                v[13] += w * g_r[q];
                v[14] += w * g_g[q];
                v[15] += w * g_b[q];
                v[16] += w * g_d[q];
                cp[q] = cp_next;
                used = true;
              }
            }
          }
          if (__any_sync(kFullMask, used)) {
#pragma unroll
            for (int f = 0; f < kFeat; ++f) {
#pragma unroll
              for (int sh = 16; sh > 0; sh >>= 1) v[f] += __shfl_xor_sync(kFullMask, v[f], sh);
            }
            if (lane == 0) {
#pragma unroll
              for (int f = 0; f < kFeat; ++f) s_part[warp][f][k] = v[f];
            }
          }
        }
        thread_live = false;
#pragma unroll
        for (int q = 0; q < PPT; ++q) thread_live |= live[q];
      }
      __syncthreads();
      // add the warps' slices in warp order, write this batch's columns, re-zero
      for (int i = threadIdx.x; i < kFeat * kBatch; i += kThreads) {
        const int f = i / kBatch;
        const int cb = i % kBatch;
        float sum = 0.0f;
#pragma unroll
        for (int wv = 0; wv < kWarps; ++wv) {
          sum += s_part[wv][f][cb];
          s_part[wv][f][cb] = 0.0f;
        }
        if (cb < m) gflat[f * gstride + base + b0 + cb] = sum;
      }
      __syncthreads();
    }
  }
}

template <int PPT, bool ORIGIN>
void launch(const float* flat, long long stride, const float* rays, const int* seg_start,
            const int* count, int n_tiles, int chunk, int max_chunks, const float* chk,
            const float* out, const float* gout, float* gflat, long long gstride,
            cudaStream_t stream) {
  gut_bwd_kernel<PPT, ORIGIN><<<n_tiles, kThreads, 0, stream>>>(
      flat, stride, rays, seg_start, count, chunk, max_chunks, chk, out, gout, gflat, gstride);
}

}  // namespace

extern "C" int tpu_splat_gut_bwd(const float* flat, long long stride, const float* rays,
                                 int ray_width, const int* seg_start, const int* count,
                                 int n_tiles, int tile_size, int chunk, int max_chunks,
                                 const float* chk, const float* out, const float* gout,
                                 float* gflat, long long gstride, cudaStream_t stream) {
  if (n_tiles <= 0) return 0;
  if (chunk <= 0 || chunk > kMaxChunk || max_chunks <= 0 ||
      (ray_width != 4 && ray_width != 8) ||
      (tile_size != Layout<1>::kTile && tile_size != Layout<4>::kTile)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool origin = ray_width == 8;
  if (tile_size == Layout<1>::kTile) {
    (origin ? launch<1, true> : launch<1, false>)(flat, stride, rays, seg_start, count,
                                                  n_tiles, chunk, max_chunks, chk, out, gout,
                                                  gflat, gstride, stream);
  } else {
    (origin ? launch<4, true> : launch<4, false>)(flat, stride, rays, seg_start, count,
                                                  n_tiles, chunk, max_chunks, chk, out, gout,
                                                  gflat, gstride, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
