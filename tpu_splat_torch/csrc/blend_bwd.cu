// K3 — per-tile blend, replay backward, for Hopper (sm_90a).
//
// Replaces: tpu_splat/ops/pallas/blend.py::_bwd_kernel (wrapper blend_backward), its
// exact lane (basis_red=False, approx_recip=False, lowp=False), for both layouts of the
// instance table (blend_common.cuh).
//
// For every tile t and every instance column c of its segment
// [seg_start[t], seg_start[t] + count[t]), gflat[0:10, c] is the gradient of
// sum_pixels gout . out with respect to that column's ten features
// (mx, my, ca, cb, cc, op, r, g, b, depth), through exactly the (pixel, instance) pairs
// the forward used:
//   w       = alpha T_excl
//   dL/da   = T_excl (g . c) - suffix / (1 - alpha),   g . c = gr r + gg g + gb b + gd depth
//             suffix = sum over later used instances of w (g . c), plus T_final gT
//   dL/dsig = -alpha dL/da where op gauss < 0.999 (alpha not clamped), else 0
//   d/dmx = dL/dsig (ca dx + cb dy)   d/dmy = dL/dsig (cc dy + cb dx)
//   d/dca = dL/dsig dx^2 / 2          d/dcb = dL/dsig dx dy      d/dcc = dL/dsig dy^2 / 2
//   d/dop = dL/da gauss (not clamped) d/d(r, g, b, depth) = w (gr, gg, gb, gd)
// each summed over the tile's pixels. Gradients are computed and stored in float32.
// Pixel centres are K2's: tile t sits at tile row t / grid_w + tile_y0 of the image.
// Columns that no tile owns, and columns of chunks the forward never reached, are not
// written: the wrapper hands in a zeroed gflat.
//
// Bound on the H100: operations at the step's shapes (0.128 ms against 0.067 ms for the
// bytes: feature columns once a tile, chk, out, gout read, ten floats an instance
// written): about 21 FP32 operations for each pair a pixel uses or stops at, and 47 more
// (one exp, one divide, the pixel sums) for each used pair.
//
// Design.
//  * The used set is the forward's. Each chunk is replayed front to back from its entry
//    transmittance chk[.., j] (0 = the pixel had stopped or the chunk never ran) with the
//    forward kernel's own decision arithmetic: the within-chunk product cp restarts at 1,
//    the stop test is T_entry (cp (1 - alpha)) < 1e-4, T_excl = T_entry cp. Dividing T
//    back by (1 - alpha), as a back-to-front walk would, does not reproduce those
//    decisions near the threshold.
//  * No back-to-front walk is needed: the suffix of instance i is the pixel's total
//    minus the prefix through i, and the total is known from the forward's output:
//    g . out + gT T_final. One front-to-back pass carries the prefix in a register.
//  * The cull of the forward (blend_common.cuh): the staging thread computes each
//    instance's box beside its features; a warp tests 32 instances at a time against its
//    8x4 sub-rectangles with one ballot and replays only the instances whose box meets
//    one, and for each only the sub-rectangles it meets. The cull skips only pairs the
//    decision arithmetic rejects, so the replay sees the forward's used set.
//  * The pixel reduction. A thread sums its own pixels' ten products; a warp that walked an
//    instance and used it on some lane reduces them by shuffles, and lane 0 parks the
//    warp's sums in its own shared-memory slice (warps whose rectangle the instance misses
//    do neither: their slice keeps its zero). After each batch of 64 instances the block
//    adds the eight slices in warp order, writes the columns and re-zeroes the slices. No
//    atomics: the sums have a fixed order and the result is the same from run to run.
//  * Blocks write only their own tile's columns; tiles' column ranges are disjoint.
//  * As in the forward, 256 threads a block, one pixel a thread at tile 16 and four at
//    tile 32, in the same warp rectangles. The block stops at the first chunk that no pixel
//    enters alive.
//
// ptxas (-Xptxas -v, CUDA 12.9, sm_90a): tile 32 80 registers and 10 bytes of spills under
// __launch_bounds__(256, 3) (three blocks an SM: 2.40 ms at the train step against 2.8 ms
// with 107 registers and two blocks; four blocks, 64 registers, spilled 74 bytes and took
// 3.17 ms); tile 16 62 registers, no spills.

#include "blend_common.cuh"

namespace {

using namespace blend;

constexpr int kBatch = 64;  // instances per cross-warp reduction

template <int PPT>
__global__ void __launch_bounds__(kThreads, PPT == 1 ? 1 : 3) blend_bwd_kernel(
    const void* __restrict__ flat, bool is_bf16, long long stride,  // [rows, stride]
    const int* __restrict__ seg_start, const int* __restrict__ count,  // [T]
    int grid_w, int tile_y0, int chunk, int max_chunks,
    const float* __restrict__ chk,   // [T, P, max_chunks]
    const float* __restrict__ out,   // [T, P, 8]
    const float* __restrict__ gout,  // [T, P, 8]
    float* __restrict__ gflat, long long gstride) {  // [kFeat, gstride], zeroed
  using L = Layout<PPT>;
  __shared__ float s_feat[kFeat][kMaxChunk];
  __shared__ float s_box[kBox][kMaxChunk];
  __shared__ float s_part[kWarps][kFeat][kBatch];
  constexpr int P = kThreads * PPT;
  const int t = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int seg0 = seg_start[t];
  const int cnt = min(max(count[t], 0), max_chunks * chunk);
  const int nch = (cnt + chunk - 1) / chunk;
  const int tx0 = (t % grid_w) * L::kTile;
  const int ty0 = (t / grid_w + tile_y0) * L::kTile;  // global row of the tile
  const float rx0 = static_cast<float>(tx0 + L::rect_x(warp)) + 0.5f;
  const float ry0 = static_cast<float>(ty0 + L::rect_y(warp)) + 0.5f;

  for (int i = threadIdx.x; i < kWarps * kFeat * kBatch; i += kThreads) {
    (&s_part[0][0][0])[i] = 0.0f;
  }

  float px[PPT], py[PPT], g_r[PPT], g_g[PPT], g_b[PPT], g_d[PPT];
  float total[PPT], prefix[PPT], tr[PPT], cp[PPT];
  bool live[PPT];
  size_t chk_row[PPT];
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const int x = L::x(warp, lane, q), y = L::y(warp, lane, q);
    px[q] = static_cast<float>(tx0 + x) + 0.5f;
    py[q] = static_cast<float>(ty0 + y) + 0.5f;
    const size_t pix = static_cast<size_t>(t) * P + y * L::kTile + x;
    const float4 g0 = *reinterpret_cast<const float4*>(gout + pix * 8);
    const float g4 = gout[pix * 8 + 4];
    const float4 o0 = *reinterpret_cast<const float4*>(out + pix * 8);
    const float o4 = out[pix * 8 + 4];
    g_r[q] = g0.x;
    g_g[q] = g0.y;
    g_b[q] = g0.z;
    g_d[q] = g4;
    // sum over all used instances of w (g . c), plus the T_final term
    total[q] = g0.x * o0.x + g0.y * o0.y + g0.z * o0.z + g4 * o4 + g0.w * o0.w;
    prefix[q] = 0.0f;
    chk_row[q] = pix * max_chunks;
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
      stage_instance(flat, is_bf16, stride, base + threadIdx.x, s_feat, s_box, threadIdx.x);
    }
    __syncthreads();

    for (int b0 = 0; b0 < n; b0 += kBatch) {
      const int m = min(kBatch, n - b0);
      for (int r0 = b0; r0 < b0 + m && __any_sync(kFullMask, thread_live); r0 += 32) {
        // which of these 32 instances meet which of the warp's sub-rectangles
        const unsigned mine =
            r0 + lane < b0 + m ? subrect_mask<PPT>(s_box, r0 + lane, rx0, ry0) : 0u;
        unsigned bits = __ballot_sync(kFullMask, mine != 0u);
        while (bits != 0u) {
          const int k = __ffs(bits) - 1;
          bits &= bits - 1u;
          const unsigned qmask = PPT == 1 ? 1u : __shfl_sync(kFullMask, mine, k);
          const int c = r0 + k;
          const float mx = s_feat[0][c], my = s_feat[1][c];
          const float ca = s_feat[2][c], cb = s_feat[3][c], cc = s_feat[4][c];
          const float op = s_feat[5][c];
          float v[kFeat];
#pragma unroll
          for (int f = 0; f < kFeat; ++f) v[f] = 0.0f;
          bool used = false;
#pragma unroll
          for (int q = 0; q < PPT; ++q) {
            if (!live[q] || !((qmask >> q) & 1u)) continue;
            const float dx = mx - px[q];
            const float dy = my - py[q];
            const float sigma = 0.5f * (ca * dx * dx + cc * dy * dy) + cb * dx * dy;
            const float gauss = expf(-fmaxf(sigma, 0.0f));
            const float og = op * gauss;
            const float alpha = fminf(og, kMaxAlpha);
            if (sigma >= 0.0f && alpha >= kMinAlpha) {
              const float one_m = 1.0f - alpha;
              const float cp_next = cp[q] * one_m;
              if (tr[q] * cp_next < kTransmittanceMin) {
                live[q] = false;  // the forward stopped before this instance
              } else {
                const float t_excl = tr[q] * cp[q];
                const float w = alpha * t_excl;
                const float gc = g_r[q] * s_feat[6][c] + g_g[q] * s_feat[7][c] +
                                 g_b[q] * s_feat[8][c] + g_d[q] * s_feat[9][c];
                prefix[q] += w * gc;
                const float suffix = total[q] - prefix[q];
                const float dl_da = t_excl * gc - suffix / one_m;
                const bool not_clamped = og < kMaxAlpha;
                const float dl_ds = not_clamped ? -alpha * dl_da : 0.0f;
                v[0] += dl_ds * (ca * dx + cb * dy);
                v[1] += dl_ds * (cc * dy + cb * dx);
                v[2] += dl_ds * (0.5f * dx * dx);
                v[3] += dl_ds * (dx * dy);
                v[4] += dl_ds * (0.5f * dy * dy);
                v[5] += not_clamped ? dl_da * gauss : 0.0f;
                v[6] += w * g_r[q];
                v[7] += w * g_g[q];
                v[8] += w * g_b[q];
                v[9] += w * g_d[q];
                cp[q] = cp_next;
                used = true;
              }
            }
          }
          if (__any_sync(kFullMask, used)) {
#pragma unroll
            for (int f = 0; f < kFeat; ++f) {
#pragma unroll
              for (int s = 16; s > 0; s >>= 1) v[f] += __shfl_xor_sync(kFullMask, v[f], s);
            }
            if (lane == 0) {
#pragma unroll
              for (int f = 0; f < kFeat; ++f) s_part[warp][f][c - b0] = v[f];
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
        const int cc_ = i % kBatch;
        float sum = 0.0f;
#pragma unroll
        for (int wv = 0; wv < kWarps; ++wv) {
          sum += s_part[wv][f][cc_];
          s_part[wv][f][cc_] = 0.0f;
        }
        if (cc_ < m) gflat[f * gstride + base + b0 + cc_] = sum;
      }
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" int tpu_splat_blend_bwd(const void* flat, int is_bf16, long long stride,
                                   const int* seg_start, const int* count, int n_tiles,
                                   int grid_w, int tile_y0, int tile_size, int chunk,
                                   int max_chunks, const float* chk, const float* out,
                                   const float* gout, float* gflat, long long gstride,
                                   cudaStream_t stream) {
  if (n_tiles <= 0) return 0;
  if (chunk <= 0 || chunk > kMaxChunk || max_chunks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tile_size == Layout<1>::kTile) {
    blend_bwd_kernel<1><<<n_tiles, kThreads, 0, stream>>>(
        flat, is_bf16 != 0, stride, seg_start, count, grid_w, tile_y0, chunk, max_chunks, chk,
        out, gout, gflat, gstride);
  } else if (tile_size == Layout<4>::kTile) {
    blend_bwd_kernel<4><<<n_tiles, kThreads, 0, stream>>>(
        flat, is_bf16 != 0, stride, seg_start, count, grid_w, tile_y0, chunk, max_chunks, chk,
        out, gout, gflat, gstride);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
