// Shared by the GUT world-ray blend kernels (gut_fwd.cu, gut_bwd.cu): constants, the
// loader that stages one instance's seventeen features in shared memory, and the ray
// response of one (pixel, instance) pair.
//
// Feature rows of the [17, M] float instance table (G_* in ops/cuda/gut_kernels.py):
//   0-8 M = S^-1 R^T row-major | 9-11 gro = M (ray_o - mean) | 12 opacity | 13-15 rgb |
//   16 depth
// Rays: [T, P, 4] = (dx, dy, dz, 0) world directions, or [T, P, 8] with the per-pixel
// origin offset (dox, doy, doz, 0) of a rolling shutter or an orthographic camera.
//
// Every expression below is written in the operation order of the plain PyTorch version
// (`ray_response` in ops/cuda/gut_kernels.py) and the library is compiled with
// --fmad=false, so alpha and with it the stop decisions round as the plain version's do.
// The normalisation is 1 / sqrt(max(|v|^2, 1e-24)) from correctly rounded operations: the
// hardware rsqrt is not correctly rounded and need not equal torch's.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gut {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 256;
constexpr int kFeat = 17;
constexpr unsigned kFullMask = 0xffffffffu;

constexpr float kMinAlpha = static_cast<float>(1.0 / 255.0);
constexpr float kMaxAlpha = static_cast<float>(0.999);
constexpr float kTransmittanceMin = static_cast<float>(1e-4);
constexpr float kVvMin = 1e-24f;

// Stage the seventeen features of instance column `col` into s_feat[.][lane].
__device__ __forceinline__ void stage_features(const float* __restrict__ flat,
                                               long long stride, long long col,
                                               float (*s_feat)[kMaxChunk], int lane) {
#pragma unroll
  for (int r = 0; r < kFeat; ++r) s_feat[r][lane] = __ldg(flat + r * stride + col);
}

// One instance's geometry, read once from shared memory for all of a thread's pixels.
struct Instance {
  float m[9], g[3], op;
};

__device__ __forceinline__ Instance load_instance(const float (*s_feat)[kMaxChunk], int c) {
  Instance in;
#pragma unroll
  for (int i = 0; i < 9; ++i) in.m[i] = s_feat[i][c];
#pragma unroll
  for (int i = 0; i < 3; ++i) in.g[i] = s_feat[9 + i][c];
  in.op = s_feat[12][c];
  return in;
}

// One pixel's ray: direction d and, when ORIGIN, origin offset o.
struct Ray {
  float d[3], o[3];
};

template <bool ORIGIN>
__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays, size_t pix) {
  Ray r;
  const float4* p = reinterpret_cast<const float4*>(rays + pix * (ORIGIN ? 8 : 4));
  const float4 a = p[0];
  r.d[0] = a.x; r.d[1] = a.y; r.d[2] = a.z;
  if (ORIGIN) {
    const float4 b = p[1];
    r.o[0] = b.x; r.o[1] = b.y; r.o[2] = b.z;
  } else {
    r.o[0] = r.o[1] = r.o[2] = 0.0f;
  }
  return r;
}

// The ray response and the residuals the backward's chain rule needs.
struct Response {
  float n[3], inorm, g[3], c[3], e, alpha_raw;
};

template <bool ORIGIN>
__device__ __forceinline__ Response ray_response(const Instance& in, const Ray& r) {
  Response s;
  float v[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    v[i] = in.m[3 * i] * r.d[0] + in.m[3 * i + 1] * r.d[1] + in.m[3 * i + 2] * r.d[2];
  }
  const float vv = v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
  s.inorm = __fdiv_rn(1.0f, __fsqrt_rn(fmaxf(vv, kVvMin)));
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    s.n[i] = v[i] * s.inorm;
    s.g[i] = in.g[i];
    if (ORIGIN) {
      s.g[i] = s.g[i] + in.m[3 * i] * r.o[0] + in.m[3 * i + 1] * r.o[1] +
               in.m[3 * i + 2] * r.o[2];
    }
  }
  s.c[0] = s.n[1] * s.g[2] - s.n[2] * s.g[1];
  s.c[1] = s.n[2] * s.g[0] - s.n[0] * s.g[2];
  s.c[2] = s.n[0] * s.g[1] - s.n[1] * s.g[0];
  const float power = -0.5f * (s.c[0] * s.c[0] + s.c[1] * s.c[1] + s.c[2] * s.c[2]);
  s.e = expf(power);
  s.alpha_raw = in.op * s.e;
  return s;
}

}  // namespace gut
