// Shared by the blend kernels (blend_fwd.cu, blend_bwd.cu): constants of the blend, the
// pixel layout of a block, the loader that stages one instance's ten features in shared
// memory from either layout of the instance table, and the per-instance cull box.
//
//   f32 layout  (F_* rows): a [>=10, M] float table, rows
//       mx, my, ca, cb, cc, op, r, g, b, depth
//   bf16 layout (B_* rows): a [>=15, M] __nv_bfloat16 table, rows
//       mx hi/lo, my hi/lo, ca hi/lo, cb hi/lo, cc hi/lo, op, r, g, b, depth
//     mean and conic are rebuilt as float(hi) + float(lo) with one plain float add, the
//     other rows are upcast; everything downstream is the same float arithmetic, so the
//     stop decisions match the plain version (which rebuilds the rows the same way).
//
// Pixel layout. A block of 256 threads blends one tile. Each warp owns a compact
// rectangle of the tile built from 8x4-pixel sub-rectangles, one pixel a lane in each:
//   tile 16 (one pixel a thread):   warp w owns the 8x4 rectangle at (8 (w % 2), 4 (w / 2));
//   tile 32 (four pixels a thread): warp w owns the 16x8 rectangle at (16 (w % 2), 8 (w / 2)),
//     its pixel q lies in the sub-rectangle at (8 (q % 2), 4 (q / 2)) of that rectangle.
// Lane l is pixel (l % 8, l / 8) of a sub-rectangle. Tile origins are multiples of 16, so
// every sub-rectangle is a cell of the image's global 8x4 grid; pixels are still read and
// written at their row-major index p = y * tile_size + x within the tile.
//
// The cull. The pair (pixel, instance) is valid when sigma >= 0 and
// min(op exp(-sigma), 0.999) >= 1/255, with sigma = 0.5 (ca dx^2 + cc dy^2) + cb dx dy =
// 0.5 d^T Q d, Q = [[ca, cb], [cb, cc]]. Exactly, that is sigma <= s = ln(255 op): the inside
// of an ellipse whose axis-aligned box is mean +- (sqrt(2 s cc / det), sqrt(2 s ca / det)),
// det = ca cc - cb^2. The staging thread computes that box once per instance and chunk, in
// double, and stores it beside the features; a warp then walks only the instances whose
// box meets one of its sub-rectangles. The box is widened so that it never drops a pair
// the kernel's own float arithmetic would accept:
//  * threshold: expf is within 2 ulp and the product op * gauss rounds once, so an accepted
//    pair has sigma_f <= ln(op / kMinAlpha) + 3e-7; the box uses s + kCullAbs (1e-5);
//  * sigma's rounding: with --fmad=false sigma_f is within 4u M of the exact sigma at the
//    float offsets (u = 2^-24, M = 0.5 (ca dx^2 + cc dy^2) + |cb dx dy|), and M <= K sigma
//    for the condition number K = lambda_max^2 / det of Q; so the box is that of the level
//    (s + kCullAbs) / (1 - kCullUlps u K) with kCullUlps = 5, and covers everything once
//    kCullUlps u K > 1/2 (a splat about 1000 times longer than wide);
//  * the offsets dx = mx - px round once (relative u), the double arithmetic and the
//    conversion of the bounds to float: half-widths times (1 + kCullRel), kCullRel = 1e-3,
//    plus kCullPx = 1/64 px, and the float bounds rounded outwards.
// op below 1/255 (by more than kCullAbs in the log) gives an empty box: no pixel passes.
// A conic that is not positive definite, and any NaN or Inf among the six values, gives a
// box that covers everything. The test culls only what is clearly outside
// (xhi < x0 || xlo > x1 || ...), so a NaN bound keeps the pair. Under these margins every
// pixel accepts the same instances in the same order as without the cull.
// `ops/cuda/blend.py::cull_boxes` / `cull_keep` are the plain twins of this box and test.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace blend {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 256;
constexpr int kFeat = 10;  // mx, my, ca, cb, cc, op, r, g, b, depth
constexpr int kBox = 4;    // cull box: x lo, x hi, y lo, y hi
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kSubW = 8, kSubH = 4;  // a warp's sub-rectangle: one pixel a lane

// float32 values of the reference's double constants (rasterization_config.h:11-30)
constexpr float kMinAlpha = static_cast<float>(1.0 / 255.0);
constexpr float kMaxAlpha = static_cast<float>(0.999);
constexpr float kTransmittanceMin = static_cast<float>(1e-4);

// margins of the cull box (see the note above; blend.py's twin uses the same values)
constexpr double kCullAbs = 1e-5;
constexpr double kCullUlps = 5.0;
constexpr double kCullRel = 1e-3;
constexpr double kCullPx = 1.0 / 64.0;
constexpr double kUnitRoundoff = 1.0 / 16777216.0;  // 2^-24

// Pixel layout of a block with PPT pixels a thread (1 at tile 16, 4 at tile 32).
template <int PPT>
struct Layout {
  static constexpr int kQW = PPT == 4 ? 2 : 1;  // sub-rectangles across a warp's rectangle
  static constexpr int kRectW = kSubW * kQW;
  static constexpr int kRectH = kSubH * (PPT / kQW);
  static constexpr int kTile = 2 * kRectW;  // 2 x 4 warp rectangles a tile
  static_assert(4 * kRectH == kTile, "a tile is 2 x 4 warp rectangles");
  // tile-local column and row of the warp's rectangle, and of pixel q of a lane
  __device__ static int rect_x(int warp) { return (warp & 1) * kRectW; }
  __device__ static int rect_y(int warp) { return (warp >> 1) * kRectH; }
  __device__ static int sub_x(int q) { return (q % kQW) * kSubW; }
  __device__ static int sub_y(int q) { return (q / kQW) * kSubH; }
  __device__ static int x(int warp, int lane, int q) {
    return rect_x(warp) + sub_x(q) + (lane & 7);
  }
  __device__ static int y(int warp, int lane, int q) {
    return rect_y(warp) + sub_y(q) + (lane >> 3);
  }
};

// Stage the ten features of instance column `col` into s_feat[.][lane].
__device__ __forceinline__ void stage_features(const void* __restrict__ flat, bool is_bf16,
                                               long long stride, long long col,
                                               float (*s_feat)[kMaxChunk], int lane) {
  if (!is_bf16) {
    const float* f = static_cast<const float*>(flat);
#pragma unroll
    for (int r = 0; r < kFeat; ++r) s_feat[r][lane] = __ldg(f + r * stride + col);
  } else {
    const __nv_bfloat16* b = static_cast<const __nv_bfloat16*>(flat);
#pragma unroll
    for (int r = 0; r < 5; ++r) {
      const float hi = __bfloat162float(b[(2 * r) * stride + col]);
      const float lo = __bfloat162float(b[(2 * r + 1) * stride + col]);
      s_feat[r][lane] = __fadd_rn(hi, lo);
    }
#pragma unroll
    for (int r = 5; r < kFeat; ++r) {
      s_feat[r][lane] = __bfloat162float(b[(5 + r) * stride + col]);
    }
  }
}

// The cull box of one instance from its staged float features (see the note above).
__device__ __forceinline__ void cull_box(float mx, float my, float ca, float cb, float cc,
                                         float op, float* box) {
  const float inf = __int_as_float(0x7f800000);
  float xlo = -inf, xhi = inf, ylo = -inf, yhi = inf;  // covers everything
  const double s = log(static_cast<double>(op) / static_cast<double>(kMinAlpha)) + kCullAbs;
  // false for NaN and +-inf
  const bool finite = fabsf(mx) < inf && fabsf(my) < inf && fabsf(ca) < inf &&
                      fabsf(cb) < inf && fabsf(cc) < inf;
  if (s < 0.0) {  // op < 1/255: no pixel passes
    xlo = inf, xhi = -inf, ylo = inf, yhi = -inf;
  } else if (s < 1e300 && finite) {
    const double a = ca, b = cb, c = cc;
    const double det = a * c - b * b;  // the products are exact in double: its sign is right
    if (a > 0.0 && c > 0.0 && det > 0.0) {
      const double lmax = 0.5 * (a + c) + sqrt(0.25 * (a - c) * (a - c) + b * b);
      const double shrink = 1.0 - kCullUlps * kUnitRoundoff * (lmax * lmax / det);
      if (shrink >= 0.5) {
        const double level = 2.0 * s / shrink;
        const double rx = sqrt(level * c / det) * (1.0 + kCullRel) + kCullPx;
        const double ry = sqrt(level * a / det) * (1.0 + kCullRel) + kCullPx;
        xlo = __double2float_rd(mx - rx), xhi = __double2float_ru(mx + rx);
        ylo = __double2float_rd(my - ry), yhi = __double2float_ru(my + ry);
      }
    }
  }
  box[0] = xlo, box[1] = xhi, box[2] = ylo, box[3] = yhi;
}

// Stage instance column `col` into lane `lane` of the chunk: its features and its box.
__device__ __forceinline__ void stage_instance(const void* __restrict__ flat, bool is_bf16,
                                               long long stride, long long col,
                                               float (*s_feat)[kMaxChunk],
                                               float (*s_box)[kMaxChunk], int lane) {
  stage_features(flat, is_bf16, stride, col, s_feat, lane);
  float box[kBox];
  cull_box(s_feat[0][lane], s_feat[1][lane], s_feat[2][lane], s_feat[3][lane],
           s_feat[4][lane], s_feat[5][lane], box);
#pragma unroll
  for (int k = 0; k < kBox; ++k) s_box[k][lane] = box[k];
}

// Bit q is set when staged instance i's box meets the warp's q-th sub-rectangle; (x0, y0)
// is the pixel centre of the warp rectangle's top-left pixel in image coordinates.
template <int PPT>
__device__ __forceinline__ unsigned subrect_mask(const float (*s_box)[kMaxChunk], int i,
                                                 float x0, float y0) {
  const float xlo = s_box[0][i], xhi = s_box[1][i], ylo = s_box[2][i], yhi = s_box[3][i];
  unsigned m = 0;
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const float sx0 = x0 + static_cast<float>(Layout<PPT>::sub_x(q));
    const float sy0 = y0 + static_cast<float>(Layout<PPT>::sub_y(q));
    const bool out = xhi < sx0 || xlo > sx0 + static_cast<float>(kSubW - 1) || yhi < sy0 ||
                     ylo > sy0 + static_cast<float>(kSubH - 1);
    m |= out ? 0u : (1u << q);
  }
  return m;
}

}  // namespace blend
