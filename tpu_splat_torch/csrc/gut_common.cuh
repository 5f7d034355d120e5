// Shared by the GUT world-ray blend kernels (gut_fwd.cu, gut_bwd.cu): constants, the pixel
// layout of a block, the loader that stages one instance's seventeen features in shared
// memory with its cull sphere, the per-warp ray cones, the cull test, and the ray response
// of one (pixel, instance) pair.
//
// Feature rows of the [17, M] float instance table (G_* in ops/cuda/gut_kernels.py):
//   0-8 M = S^-1 R^T row-major | 9-11 gro = M (ray_o - mean) | 12 opacity | 13-15 rgb |
//   16 depth
// Rays: [T, P, 4] = (dx, dy, dz, 0) world directions, or [T, P, 8] with the per-pixel
// origin offset (dox, doy, doz, 0) of a rolling shutter or an orthographic camera.
//
// Every expression of the ray response is written in the operation order of the plain
// PyTorch version (`ray_response` in ops/cuda/gut_kernels.py) and the library is compiled
// with --fmad=false, so alpha and with it the stop decisions round as the plain version's
// do. The normalisation is 1 / sqrt(max(|v|^2, 1e-24)) from correctly rounded operations:
// the hardware rsqrt is not correctly rounded and need not equal torch's.
//
// Pixel layout: the blend kernels' (blend_common.cuh, Layout<PPT>). Each warp owns
// 8x4-pixel sub-rectangles, one pixel a lane: one at tile 16, four (a 16x8 rectangle) at
// tile 32.
// Pixels keep their row-major index p = y * tile_size + x in rays, out, chk and gout.
//
// The cull. Relative to the camera position, the kernel's response is that of the line
// L = {do + t d}: with m = -M^-1 gro, g = gro + M do = M (do - m) and v = M d, |c| = |n x g|
// is the distance from the origin of the Gaussian's whitened space to the whitened line,
// and the pair is valid when alpha_raw = op exp(-|c|^2 / 2) >= 1/255, i.e. |c|^2 <= 2 s with
// s = ln(255 op): the line meets the ellipsoid {x : |M (x - m)|^2 <= 2 s}. The response
// does not depend on the sign of t (line semantics): an instance behind the camera on the
// line is valid too. That ellipsoid lies in the ball of radius sigma_max(M^-1) sqrt(2 s)
// around m. So:
//  * Sphere (cull_sphere, once per staged instance, in double from the staged float values):
//    centre m = -adj(M) gro / det(M), radius
//      R = sigma_max(M^-1) (sqrt(2 s') + kappa u ||M||_F (|m| + D)) (1 + kCullRel) + 4 u |m|
//    with s' = ln(op / (1/255)) + kCullAbs (expf is within 2 ulp and op * e rounds once:
//    an accepted pair has |c_f|^2 <= 2 (s + 5u) / (1 - 3u)); sigma_max(M^-1)^2 the largest
//    eigenvalue of M^-1 M^-T in closed form, rounded up; u = 2^-24; D the largest |do| of
//    the tile's rays (0 when the rays are 4 wide). The kappa term covers the kernel's float
//    rounding. Under --fmad=false v_f = (M + E) d with |E_ik| <= 3u |M_ik|, which is the
//    exact response of the direction d' = d + M^-1 E d, |d' - d| <= 3u K |d| with
//    K = ||M||_F sigma_max(M^-1): that moves the line by at most 3u K |m - do| at m;
//    normalising v and the cross product add 6u and 3u of |g|, g's own rounding (rays 8
//    wide) 4u (|gro| + ||M||_F |do|), and |gro| <= ||M||_F |m|. In all 16.1 u ||M||_F
//    (|m| + |do|) in whitened units, sigma_max(M^-1) times that in world units; kappa =
//    kCullKappa = 34 is that, rounded up and doubled. The 4u |m| term covers the rounding
//    of m to float.
//  * Empty: op below 1/255 (s' < 0, or op <= 0): no pair can pass; R = -inf culls the
//    instance for every warp.
//  * Everything (R = +inf): any NaN or Inf among the thirteen values; det(M) = 0 or
//    K > kCullCondMax (nearly singular); a |v| that could fall to the 1e-12 clamp
//    (sigma_min(M) kDirMin < 2 kVMin) or |v|^2 that could overflow (||M||_F kDirMax >
//    kVMax) for a ray of length in [kDirMin, kDirMax].
//  * Cone (warp_cone, once per sub-rectangle q at kernel start, in double from its 32
//    rays): the unit axis b_q (the float rounding of the mean unit direction), the largest
//    angle phi_q of a ray to that float axis (atan2 of |u x b| and u . b), cos phi_q rounded
//    down and sin phi_q rounded up; for rays 8 wide the mean origin offset delta_q (float)
//    and rho_q = max |do_p - delta_q| rounded up, for rays 4 wide delta = 0 and rho = 0.
//    A sub-rectangle with a ray whose direction is not finite or whose length is outside
//    [kDirMin, kDirMax] (a zero ray has v = 0, n = 0, c = 0 and alpha = op for every
//    instance), an origin offset that is not finite, or a cone of 90 degrees or more gets
//    the cone that covers everything (b = 0, delta = 0, rho = 0: the test below reads
//    0 > R + ..., which culls only the empty instances).
//  * Test (cone_mask): m' = m - delta_q, h = |m' . b_q|, r = |m' x b_q|; cull only if
//      r cos phi_q - h sin phi_q > R + rho_q + kCullEps |m'|.
//    For a point outside the double cone around b_q of half-angle phi_q the left side is
//    its distance to that cone, so no ray of the sub-rectangle (a line through a point
//    within rho_q of delta_q, with a direction within phi_q of b_q) comes within R of m.
//    kCullEps = 1e-5 covers the float rounding of this test (about 13u |m'|), |b_q| != 1
//    and the rounding of phi_q's cosine and sine. A NaN anywhere keeps the pair.
// Under these margins every pixel accepts the same instances in the same order as a walk of
// every pair. `ops/cuda/gut_kernels.py::gut_cull_spheres`, `gut_cull_cones` and
// `gut_cull_keep` are the plain twins of the sphere, the cone and the test; the margins
// below and there change together.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "blend_common.cuh"

namespace gut {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 256;
constexpr int kFeat = 17;
constexpr int kSph = 4;   // cull sphere: centre m (3), radius R
constexpr int kCone = 9;  // cone: axis b (3), cos phi, sin phi, delta (3), rho
constexpr unsigned kFullMask = 0xffffffffu;

template <int PPT>
using Layout = blend::Layout<PPT>;

constexpr float kMinAlpha = static_cast<float>(1.0 / 255.0);
constexpr float kMaxAlpha = static_cast<float>(0.999);
constexpr float kTransmittanceMin = static_cast<float>(1e-4);
constexpr float kVvMin = 1e-24f;

// margins of the cull (see the note above; gut_kernels.py's twin uses the same values)
constexpr double kCullAbs = 1e-5;
constexpr double kCullKappa = 34.0;
constexpr double kCullRel = 1e-3;
constexpr double kCullCondMax = 1e5;
constexpr double kDirMin = 1e-3, kDirMax = 1e3;
constexpr double kVMin = 1e-11, kVMax = 1e18;
constexpr float kCullEps = 1e-5f;
constexpr double kUnitRoundoff = 1.0 / 16777216.0;  // 2^-24

// The cull sphere of one instance from its thirteen geometry values (see the note above):
// (m, R), R = +inf to keep every pair, -inf to cull every pair.
__device__ inline float4 cull_sphere(const float* mf, const float* gf, float opf,
                                     double do_max) {
  const float inf = CUDART_INF_F;
  const float4 all = make_float4(0.0f, 0.0f, 0.0f, inf);
  bool finite = fabsf(opf) < inf;
#pragma unroll
  for (int i = 0; i < 9; ++i) finite &= fabsf(mf[i]) < inf;
#pragma unroll
  for (int i = 0; i < 3; ++i) finite &= fabsf(gf[i]) < inf;
  if (!finite) return all;
  const double s = log(static_cast<double>(opf) / static_cast<double>(kMinAlpha)) + kCullAbs;
  if (!(s >= 0.0)) return make_float4(0.0f, 0.0f, 0.0f, -inf);  // op < 1/255, or op <= 0
  double m[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) m[i] = mf[i];
  // adjugate and determinant: M^-1 = adj / det
  const double a[9] = {m[4] * m[8] - m[5] * m[7], m[2] * m[7] - m[1] * m[8],
                       m[1] * m[5] - m[2] * m[4], m[5] * m[6] - m[3] * m[8],
                       m[0] * m[8] - m[2] * m[6], m[2] * m[3] - m[0] * m[5],
                       m[3] * m[7] - m[4] * m[6], m[1] * m[6] - m[0] * m[7],
                       m[0] * m[4] - m[1] * m[3]};
  const double det = m[0] * a[0] + m[1] * a[3] + m[2] * a[6];
  if (det == 0.0) return all;
  double inv[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) inv[i] = a[i] / det;
  // largest eigenvalue of A = M^-1 M^-T (symmetric), closed form, rounded up
  double A[6];  // a00 a11 a22 a01 a02 a12
  A[0] = inv[0] * inv[0] + inv[1] * inv[1] + inv[2] * inv[2];
  A[1] = inv[3] * inv[3] + inv[4] * inv[4] + inv[5] * inv[5];
  A[2] = inv[6] * inv[6] + inv[7] * inv[7] + inv[8] * inv[8];
  A[3] = inv[0] * inv[3] + inv[1] * inv[4] + inv[2] * inv[5];
  A[4] = inv[0] * inv[6] + inv[1] * inv[7] + inv[2] * inv[8];
  A[5] = inv[3] * inv[6] + inv[4] * inv[7] + inv[5] * inv[8];
  const double q = (A[0] + A[1] + A[2]) / 3.0;
  const double p1 = A[3] * A[3] + A[4] * A[4] + A[5] * A[5];
  const double b0 = A[0] - q, b1 = A[1] - q, b2 = A[2] - q;
  const double p = sqrt((b0 * b0 + b1 * b1 + b2 * b2 + 2.0 * p1) / 6.0);
  double lam = q;
  if (p > 0.0) {
    const double r = 0.5 * (b0 * (b1 * b2 - A[5] * A[5]) - A[3] * (A[3] * b2 - A[5] * A[4]) +
                            A[4] * (A[3] * A[5] - b1 * A[4])) / (p * p * p);
    const double phi = acos(fmin(fmax(r, -1.0), 1.0)) / 3.0;
    lam = q + 2.0 * p * fmin(1.0, cos(phi) + 1e-6);
  }
  const double sig = sqrt(lam) * (1.0 + 1e-12);  // sigma_max(M^-1)
  double nf = 0.0;
#pragma unroll
  for (int i = 0; i < 9; ++i) nf += m[i] * m[i];
  nf = sqrt(nf);  // ||M||_F
  if (!(nf * sig <= kCullCondMax) || !(kDirMin / sig >= 2.0 * kVMin) ||
      !(nf * kDirMax <= kVMax)) {
    return all;
  }
  const double c0 = -(inv[0] * gf[0] + inv[1] * gf[1] + inv[2] * gf[2]);
  const double c1 = -(inv[3] * gf[0] + inv[4] * gf[1] + inv[5] * gf[2]);
  const double c2 = -(inv[6] * gf[0] + inv[7] * gf[1] + inv[8] * gf[2]);
  const double cn = sqrt(c0 * c0 + c1 * c1 + c2 * c2);
  const double rad = sig * (sqrt(2.0 * s) + kCullKappa * kUnitRoundoff * nf * (cn + do_max)) *
                         (1.0 + kCullRel) + 4.0 * kUnitRoundoff * cn;
  return make_float4(static_cast<float>(c0), static_cast<float>(c1), static_cast<float>(c2),
                     __double2float_ru(rad));
}

// Stage instance column `col` into lane `lane` of the chunk: its features and its sphere.
__device__ __forceinline__ void stage_instance(const float* __restrict__ flat, long long stride,
                                               long long col, float (*s_feat)[kMaxChunk],
                                               float (*s_sph)[kMaxChunk], int lane,
                                               double do_max) {
  float f[13];
#pragma unroll
  for (int r = 0; r < kFeat; ++r) {
    const float x = __ldg(flat + r * stride + col);
    s_feat[r][lane] = x;
    if (r < 13) f[r] = x;
  }
  const float4 sph = cull_sphere(f, f + 9, f[12], do_max);
  s_sph[0][lane] = sph.x;
  s_sph[1][lane] = sph.y;
  s_sph[2][lane] = sph.z;
  s_sph[3][lane] = sph.w;
}

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) x += __shfl_xor_sync(kFullMask, x, sh);
  return x;  // the same bits on every lane: fl(a + b) = fl(b + a)
}

__device__ __forceinline__ double warp_max(double x) {
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) x = fmax(x, __shfl_xor_sync(kFullMask, x, sh));
  return x;
}

// The cone of the warp's sub-rectangle from each lane's ray (see the note above), written
// by lane 0 to `cone`; every lane of the warp calls it. -> this warp's largest |do|.
template <bool ORIGIN>
__device__ float warp_cone(const float* d, const float* o, float* cone, int lane) {
  const double dx = d[0], dy = d[1], dz = d[2];
  const double len = sqrt(dx * dx + dy * dy + dz * dz);
  bool bad = !(len >= kDirMin && len <= kDirMax);  // also NaN and Inf
  double dn = 0.0;
  if (ORIGIN) {
    bad |= !(fabsf(o[0]) < CUDART_INF_F && fabsf(o[1]) < CUDART_INF_F &&
             fabsf(o[2]) < CUDART_INF_F);
    dn = bad ? 0.0 : sqrt(static_cast<double>(o[0]) * o[0] + static_cast<double>(o[1]) * o[1] +
                          static_cast<double>(o[2]) * o[2]);
  }
  const double ux = bad ? 0.0 : dx / len, uy = bad ? 0.0 : dy / len, uz = bad ? 0.0 : dz / len;
  const double sx = warp_sum(ux), sy = warp_sum(uy), sz = warp_sum(uz);
  const double sl = sqrt(sx * sx + sy * sy + sz * sz);
  const float bx = static_cast<float>(sx / sl), by = static_cast<float>(sy / sl),
              bz = static_cast<float>(sz / sl);
  // angle of this lane's ray to the float axis
  const double ex = uy * bz - uz * by, ey = uz * bx - ux * bz, ez = ux * by - uy * bx;
  const double th = atan2(sqrt(ex * ex + ey * ey + ez * ez), ux * bx + uy * by + uz * bz);
  const double phi = warp_max(bad ? CUDART_INF : th) + 1e-9;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, rho = 0.0f;
  if (ORIGIN) {
    ox = static_cast<float>(warp_sum(bad ? 0.0 : o[0]) / 32.0);
    oy = static_cast<float>(warp_sum(bad ? 0.0 : o[1]) / 32.0);
    oz = static_cast<float>(warp_sum(bad ? 0.0 : o[2]) / 32.0);
    const double qx = static_cast<double>(o[0]) - ox, qy = static_cast<double>(o[1]) - oy,
                 qz = static_cast<double>(o[2]) - oz;
    rho = __double2float_ru(warp_max(bad ? 0.0 : sqrt(qx * qx + qy * qy + qz * qz)));
  }
  const bool everything = !(phi < 0.5 * CUDART_PI) || !(sl > 0.0);  // all lanes agree
  if (lane == 0) {
    if (everything) {
      cone[0] = cone[1] = cone[2] = 0.0f;
      cone[3] = 1.0f;
      cone[4] = 0.0f;
      cone[5] = cone[6] = cone[7] = cone[8] = 0.0f;
    } else {
      cone[0] = bx, cone[1] = by, cone[2] = bz;
      cone[3] = __double2float_rd(cos(phi));
      cone[4] = fminf(__double2float_ru(sin(phi)), 1.0f);
      cone[5] = ox, cone[6] = oy, cone[7] = oz, cone[8] = rho;
    }
  }
  return ORIGIN ? __double2float_ru(warp_max(dn)) : 0.0f;
}

// Bit q is set when staged instance i's sphere may meet a ray of the warp's q-th
// sub-rectangle (`cone` holds the warp's PPT cones).
template <int PPT>
__device__ __forceinline__ unsigned cone_mask(const float (*s_sph)[kMaxChunk], int i,
                                              const float (*cone)[kCone]) {
  const float mx = s_sph[0][i], my = s_sph[1][i], mz = s_sph[2][i], rad = s_sph[3][i];
  unsigned msk = 0;
#pragma unroll
  for (int q = 0; q < PPT; ++q) {
    const float* c = cone[q];
    const float ax = mx - c[5], ay = my - c[6], az = mz - c[7];
    const float h = fabsf(ax * c[0] + ay * c[1] + az * c[2]);
    const float ex = ay * c[2] - az * c[1], ey = az * c[0] - ax * c[2],
                ez = ax * c[1] - ay * c[0];
    const float r = sqrtf(ex * ex + ey * ey + ez * ez);
    const float mn = sqrtf(ax * ax + ay * ay + az * az);
    const bool out = r * c[3] - h * c[4] > rad + c[8] + kCullEps * mn;
    msk |= out ? 0u : (1u << q);
  }
  return msk;
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
