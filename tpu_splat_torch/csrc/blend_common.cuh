// Shared by the blend kernels (blend_fwd.cu, blend_bwd.cu): constants of the blend and
// the loader that stages one instance's ten features in shared memory from either
// layout of the instance table.
//
//   f32 layout  (F_* rows): a [>=10, M] float table, rows
//       mx, my, ca, cb, cc, op, r, g, b, depth
//   bf16 layout (B_* rows): a [>=15, M] __nv_bfloat16 table, rows
//       mx hi/lo, my hi/lo, ca hi/lo, cb hi/lo, cc hi/lo, op, r, g, b, depth
//     mean and conic are rebuilt as float(hi) + float(lo) with one plain float add, the
//     other rows are upcast; everything downstream is the same float arithmetic, so the
//     stop decisions match the plain version (which rebuilds the rows the same way).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace blend {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 256;
constexpr int kFeat = 10;  // mx, my, ca, cb, cc, op, r, g, b, depth
constexpr unsigned kFullMask = 0xffffffffu;

// float32 values of the reference's double constants (rasterization_config.h:11-30)
constexpr float kMinAlpha = static_cast<float>(1.0 / 255.0);
constexpr float kMaxAlpha = static_cast<float>(0.999);
constexpr float kTransmittanceMin = static_cast<float>(1e-4);

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

}  // namespace blend
