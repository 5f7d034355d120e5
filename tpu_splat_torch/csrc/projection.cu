// Pinhole projection layer for Hopper (sm_90a): the EWA projection of every Gaussian slot
// with its SH colour (forward), and the gradients of its inputs (backward).
//
// Replaces the host-dispatched chain of `tpu_splat_torch/ops/projection.py::project_plain`
// and its autograd backward on the card. Counterpart of `tpu_splat/ops/projection.py` and
// of the reference's `preprocess_cu` (fastgs/rasterization/include/kernels_forward.cuh:
// 18-205) and its backward (kernels_backward.cuh).
//
// tpu_splat_project_fwd: one thread per slot. Depth and the near/far cull, the sigmoid
// opacity, the rotation from the quaternion (|q|^2 folded in), the variances, the
// normalised camera-plane point, the clamped Jacobian, JW, the 2D covariance in flat
// column form with the 0.3 dilation, its conic, the opacity-aware extent and the clamped
// tile rect, then the SH colour up to the active degree (<= 4). Writes every field of
// `Projected` in one pass.
//
// tpu_splat_project_bwd: one thread per slot. Recomputes the forward's intermediates from
// the inputs and takes the cotangents of mean2d, conic, opacity, colour, depth and the
// power threshold (any of them may be absent: zero) back to the gradients of means,
// scaling_raw, rotation_raw, opacity_raw, sh0 and shN, derived by hand in float32. Where
// the chain's autograd masks a gradient (a clamp outside its range, a `where`'s other
// branch) the kernel masks it at the same test; the coefficients of bands above the
// active degree get zero.
//
// Arithmetic of the forward: each value is computed as the plain chain computes it on the
// card, in its operation order, so that the two agree bit for bit (--fmad=false keeps
// separate multiplies and adds). The fused steps and orders are those the chain's library
// calls take on the card (probed there): `means @ w2c[i, :3]` is cuBLAS's gemvx, a fused
// multiply-add of k = 1 onto the product of k = 0, then the product of k = 2 added; a
// `torch.sum` over the last axis pairs its elements as the reduction's warp shuffle does,
// (a0 + a2) + a1 over three and (a0 + a2) + (a1 + a3) over four. A division by the focal
// length or the tile size is a true division because the chain divides by a 0-dim device
// tensor; clamps keep a NaN, as PyTorch's do; the int cast of a tile bound takes a NaN to
// 0, as the card's cast does.
//
// Bound on the H100 by bytes. The forward reads 57 bytes a slot and shN (180 at SH 3) and
// writes 65; the backward reads the same but sh0, 40 bytes of cotangents in a train step,
// and writes the gradients, 236 bytes (chip_smoke.py counts both). At 2^20 slots: 0.32 GB
// forward and 0.53 GB backward, 0.095 and 0.157 ms at 3.35 TB/s. A warp stages its 32 rows
// of shN (and of its gradient) through shared memory, so that those loads and stores are
// coalesced. Neither kernel synchronises: the camera's scalars are launch arguments, w2c
// and the camera position are read from device memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;
constexpr int kMaxRest = 24;  // shN's rest coefficients a slot at SH degree 4

constexpr float kNear = 0.01f;      // projection.py NEAR_PLANE
constexpr float kFar = 1e10f;       // FAR_PLANE
constexpr float kMinAlpha = 1.0f / 255.0f;
constexpr float kMinAlphaRcp = 255.0f;
constexpr float kDilation = 0.3f;

// sh.py's constants, each the float32 value the chain multiplies by
constexpr float kC0 = 0.28209479177387814f;
constexpr float kC1 = 0.48860251190291987f;
constexpr float kC2_0 = 1.0925484305920792f;
constexpr float kC2_1 = -1.0925484305920792f;
constexpr float kC2_2 = 0.31539156525251999f;
constexpr float kC2_3 = -1.0925484305920792f;
constexpr float kC2_4 = 0.54627421529603959f;
constexpr float kC2_zz = 0.94617469575755997f;
constexpr float kC3_0 = 0.59004358992664352f;
constexpr float kC3_1 = 2.8906114426405538f;
constexpr float kC3_2 = 0.45704579946446572f;
constexpr float kC3_3 = 0.3731763325901154f;
constexpr float kC3_4 = 1.4453057213202769f;
// band 4's (Sloan's basis), written as sh.py writes them: the chain rounds each Python float
// to float32 once, as this double-to-float conversion does
constexpr float kC4_fc = 0.6258357354491763;
constexpr float kC4_0d_zz = -4.683325804901025;
constexpr float kC4_0d = 2.007139630671868;
constexpr float kC4_1c_zz = 3.31161143515146;
constexpr float kC4_1c = 0.47308734787878;
constexpr float kC4_2b = -1.770130769779931;
constexpr float kC4_6_zz = 0.9461746957575601;
constexpr float kC4_6 = 0.3153915652525201;
constexpr float kC4_12_zz = 1.865881662950577;
constexpr float kC4_12 = 1.119528997770346;
constexpr float kC4_19z = 1.984313483298443;
constexpr float kC4_19 = 1.006230589874905;

}  // namespace

// Launch arguments. Mirrored by `tpu_splat_torch/ops/cuda/build.py::ProjCamera`.
struct ProjCamera {
  int width, height, tile_size;
  int sh_degree;                 // bands evaluated, 0-4 (the active degree shN holds)
  int sh_rest;                   // coefficients a slot in shN (K - 1)
  float fx, fy, cx, cy;          // float32 of the host values
  float lo_x, hi_x, lo_y, hi_y;  // the clamp of the normalised x and y, as the chain's
};

namespace {

__device__ __forceinline__ float clamp_min_nan(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// means @ w[:3] + w[3], as the chain's cuBLAS gemv (gemvx: a fused multiply-add of k = 1
// onto the product of k = 0, then the product of k = 2 added) and add take it
__device__ __forceinline__ float affine_row(const float* w, float x, float y, float z) {
  return (fmaf(y, w[1], x * w[0]) + z * w[2]) + w[3];
}

// A warp's `count` consecutive floats from `src` into shared memory, coalesced
__device__ __forceinline__ void load_rows(const float* __restrict__ src, int count,
                                          float* dst, int lane) {
  for (int i = lane; i < count; i += 32) dst[i] = __ldg(src + i);
}

// ... and back out to global memory
__device__ __forceinline__ void store_rows(const float* src, int count,
                                           float* __restrict__ dst, int lane) {
  for (int i = lane; i < count; i += 32) dst[i] = src[i];
}

// floor / ceil(v / tile) clamped to [0, hi] (a NaN to 0, as the chain's int cast takes it)
__device__ __forceinline__ int tile_bound(float t, int hi) {
  const float f = fminf(fmaxf(t, 0.0f), static_cast<float>(hi));
  return min(max(static_cast<int>(f), 0), hi);
}

// The forward's per-slot intermediates, as the chain names them.
struct Geo {
  float m[3];            // the mean
  float q[4];            // wxyz
  float s;               // 2 / max(|q|^2, 1e-8)
  float nq_raw;          // |q|^2 before the clamp
  float rc[3][3];        // rotation
  float var[3];          // exp(2 scaling)
  float depth, sd;       // camera z; the safe depth (1 where culled by depth)
  bool vis0;             // alive and within the near and far planes
  float x, y, tx, ty;    // normalised point; clamped
  float j11, j13, j22, j23;
  float jw1[3], jw2[3];
  float u[3], v[3];
  float cov_a, cov_b, cov_c, det, sdet;
  float op;              // sigmoid opacity
};

__device__ __forceinline__ void geometry(const float* __restrict__ means,
                                         const float* __restrict__ scaling,
                                         const float* __restrict__ rotation,
                                         const float* __restrict__ opac_raw,
                                         const bool* __restrict__ alive, const float* w,
                                         const ProjCamera& cam, int g, Geo& o) {
  const float* r1 = w;
  const float* r2 = w + 4;
  const float* r3 = w + 8;
#pragma unroll
  for (int i = 0; i < 3; ++i) o.m[i] = __ldg(means + 3 * g + i);
  o.depth = affine_row(r3, o.m[0], o.m[1], o.m[2]);
  o.vis0 = alive[g] && o.depth >= kNear && o.depth <= kFar;
  o.sd = o.vis0 ? o.depth : 1.0f;
  o.op = 1.0f / (1.0f + expf(-__ldg(opac_raw + g)));

  // rotation (quat.py::quat_to_rotmat_cols)
#pragma unroll
  for (int i = 0; i < 4; ++i) o.q[i] = __ldg(rotation + 4 * g + i);
  const float qr = o.q[0], qx = o.q[1], qy = o.q[2], qz = o.q[3];
  o.nq_raw = ((qr * qr + qx * qx) + qy * qy) + qz * qz;
  o.s = (1.0f / clamp_min_nan(o.nq_raw, 1e-8f)) * 2.0f;
  const float s = o.s;
  const float xx = (s * qx) * qx, yy = (s * qy) * qy, zz = (s * qz) * qz;
  const float xy = (s * qx) * qy, xz = (s * qx) * qz, yz = (s * qy) * qz;
  const float rx = (s * qr) * qx, ry = (s * qr) * qy, rz = (s * qr) * qz;
  o.rc[0][0] = 1.0f - (yy + zz);
  o.rc[0][1] = xy - rz;
  o.rc[0][2] = ry + xz;
  o.rc[1][0] = rz + xy;
  o.rc[1][1] = 1.0f - (xx + zz);
  o.rc[1][2] = yz - rx;
  o.rc[2][0] = xz - ry;
  o.rc[2][1] = rx + yz;
  o.rc[2][2] = 1.0f - (xx + yy);
#pragma unroll
  for (int i = 0; i < 3; ++i) o.var[i] = expf(2.0f * __ldg(scaling + 3 * g + i));

  o.x = affine_row(r1, o.m[0], o.m[1], o.m[2]) / o.sd;
  o.y = affine_row(r2, o.m[0], o.m[1], o.m[2]) / o.sd;
  o.tx = clamp_nan(o.x, cam.lo_x, cam.hi_x);
  o.ty = clamp_nan(o.y, cam.lo_y, cam.hi_y);
  o.j11 = cam.fx / o.sd;
  o.j13 = -o.j11 * o.tx;
  o.j22 = cam.fy / o.sd;
  o.j23 = -o.j22 * o.ty;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    o.jw1[i] = o.j11 * r1[i] + o.j13 * r3[i];
    o.jw2[i] = o.j22 * r2[i] + o.j23 * r3[i];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o.u[k] = (o.jw1[0] * o.rc[0][k] + o.jw1[1] * o.rc[1][k]) + o.jw1[2] * o.rc[2][k];
    o.v[k] = (o.jw2[0] * o.rc[0][k] + o.jw2[1] * o.rc[1][k]) + o.jw2[2] * o.rc[2][k];
  }
  const float* vr = o.var;
  o.cov_a = ((vr[0] * o.u[0] * o.u[0] + vr[1] * o.u[1] * o.u[1]) + vr[2] * o.u[2] * o.u[2])
            + kDilation;
  o.cov_b = (vr[0] * o.u[0] * o.v[0] + vr[1] * o.u[1] * o.v[1]) + vr[2] * o.u[2] * o.v[2];
  o.cov_c = ((vr[0] * o.v[0] * o.v[0] + vr[1] * o.v[1] * o.v[1]) + vr[2] * o.v[2] * o.v[2])
            + kDilation;
  o.det = o.cov_a * o.cov_c - o.cov_b * o.cov_b;
  o.sdet = o.det > 1e-12f ? o.det : 1.0f;
}

// The normalised view direction (sh.py::sh_to_color's safe normalize).
struct Dir {
  float d[3];   // mean - camera position
  float ns;     // |d|^2, summed as the chain's reduction pairs three elements
  float r;      // rsqrt(max(ns, 1e-24))
  float x, y, z;
};

__device__ __forceinline__ void view_dir(const float* m, const float* cp, Dir& o) {
#pragma unroll
  for (int i = 0; i < 3; ++i) o.d[i] = m[i] - cp[i];
  o.ns = (o.d[0] * o.d[0] + o.d[2] * o.d[2]) + o.d[1] * o.d[1];
  o.r = rsqrtf(clamp_min_nan(o.ns, 1e-24f));
  o.x = o.d[0] * o.r;
  o.y = o.d[1] * o.r;
  o.z = o.d[2] * o.r;
}

// The SH basis of the rest coefficients 0-14 (bands 1-3), each as the chain computes the
// factor it multiplies the coefficient by.
__device__ __forceinline__ void sh_basis(const Dir& d, float b[15]) {
  const float x = d.x, y = d.y, z = d.z;
  b[0] = -kC1 * y;
  b[1] = kC1 * z;
  b[2] = -kC1 * x;
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  b[3] = kC2_0 * xy;
  b[4] = kC2_1 * yz;
  b[5] = kC2_zz * zz - kC2_2;
  b[6] = kC2_3 * xz;
  b[7] = kC2_4 * xx - kC2_4 * yy;
  const float one5zz = 1.0f - 5.0f * zz;
  b[8] = (kC3_0 * y) * (-3.0f * xx + yy);
  b[9] = (kC3_1 * xy) * z;
  b[10] = (kC3_2 * y) * one5zz;
  b[11] = (kC3_3 * z) * (5.0f * zz - 3.0f);
  b[12] = (kC3_2 * x) * one5zz;
  b[13] = (kC3_4 * z) * (xx - yy);
  b[14] = (kC3_0 * x) * (-xx + 3.0f * yy);
}

// d b / d (x, y, z) of the basis above
__device__ __forceinline__ void sh_basis_grad(const Dir& d, float db[15][3]) {
  const float x = d.x, y = d.y, z = d.z;
  const float xx = x * x, yy = y * y, zz = z * z;
  db[0][0] = 0.0f; db[0][1] = -kC1; db[0][2] = 0.0f;
  db[1][0] = 0.0f; db[1][1] = 0.0f; db[1][2] = kC1;
  db[2][0] = -kC1; db[2][1] = 0.0f; db[2][2] = 0.0f;
  db[3][0] = kC2_0 * y; db[3][1] = kC2_0 * x; db[3][2] = 0.0f;
  db[4][0] = 0.0f; db[4][1] = kC2_1 * z; db[4][2] = kC2_1 * y;
  db[5][0] = 0.0f; db[5][1] = 0.0f; db[5][2] = 2.0f * kC2_zz * z;
  db[6][0] = kC2_3 * z; db[6][1] = 0.0f; db[6][2] = kC2_3 * x;
  db[7][0] = 2.0f * kC2_4 * x; db[7][1] = -2.0f * kC2_4 * y; db[7][2] = 0.0f;
  db[8][0] = kC3_0 * (-6.0f * x * y);
  db[8][1] = kC3_0 * (3.0f * (yy - xx));
  db[8][2] = 0.0f;
  db[9][0] = kC3_1 * y * z; db[9][1] = kC3_1 * x * z; db[9][2] = kC3_1 * x * y;
  db[10][0] = 0.0f;
  db[10][1] = kC3_2 * (1.0f - 5.0f * zz);
  db[10][2] = kC3_2 * (-10.0f * y * z);
  db[11][0] = 0.0f; db[11][1] = 0.0f; db[11][2] = kC3_3 * (15.0f * zz - 3.0f);
  db[12][0] = kC3_2 * (1.0f - 5.0f * zz);
  db[12][1] = 0.0f;
  db[12][2] = kC3_2 * (-10.0f * x * z);
  db[13][0] = kC3_4 * (2.0f * x * z);
  db[13][1] = kC3_4 * (-2.0f * y * z);
  db[13][2] = kC3_4 * (xx - yy);
  db[14][0] = kC3_0 * (3.0f * (yy - xx));
  db[14][1] = kC3_0 * (6.0f * x * y);
  db[14][2] = 0.0f;
}

// Band 4's factors of the rest coefficients 15-23, as the chain computes them
// (sh.py::sh_to_color: Sloan's basis through the cos/sin recurrences fc and fs).
struct Band4 {
  float fc1, fs1, fc2, fs2, fc3, fs3, tmp0d, tmp1c, tmp2b, psh6, psh12;
};

__device__ __forceinline__ void band4_terms(const Dir& d, Band4& t) {
  const float x = d.x, y = d.y, z = d.z;
  const float xx = x * x, yy = y * y, zz = z * z, xy = x * y;
  t.fc1 = xx - yy;
  t.fs1 = 2.0f * xy;
  t.fc2 = x * t.fc1 - y * t.fs1;
  t.fs2 = x * t.fs1 + y * t.fc1;
  t.fc3 = x * t.fc2 - y * t.fs2;
  t.fs3 = x * t.fs2 + y * t.fc2;
  t.tmp0d = z * (kC4_0d_zz * zz + kC4_0d);
  t.tmp1c = kC4_1c_zz * zz - kC4_1c;
  t.tmp2b = kC4_2b * z;
  t.psh6 = kC4_6_zz * zz - kC4_6;
  t.psh12 = z * (kC4_12_zz * zz - kC4_12);
}

__device__ __forceinline__ void sh_basis4(const Dir& d, float b[9]) {
  Band4 t;
  band4_terms(d, t);
  b[0] = kC4_fc * t.fs3;
  b[1] = t.tmp2b * t.fs2;
  b[2] = t.tmp1c * t.fs1;
  b[3] = t.tmp0d * d.y;
  b[4] = (kC4_19z * d.z) * t.psh12 - kC4_19 * t.psh6;
  b[5] = t.tmp0d * d.x;
  b[6] = t.tmp1c * t.fc1;
  b[7] = t.tmp2b * t.fc2;
  b[8] = kC4_fc * t.fc3;
}

// d b / d (x, y, z) of band 4's factors: fc_k + i fs_k = (x + i y)^(k + 1), so
// d fc_k / dx = (k + 1) fc_(k-1), d fc_k / dy = -(k + 1) fs_(k-1), d fs_k / dx = (k + 1)
// fs_(k-1), d fs_k / dy = (k + 1) fc_(k-1), with fc_0 = x, fs_0 = y
__device__ __forceinline__ void sh_basis4_grad(const Dir& d, float db[9][3]) {
  Band4 t;
  band4_terms(d, t);
  const float x = d.x, y = d.y, z = d.z, zz = z * z;
  const float d0d = 3.0f * kC4_0d_zz * zz + kC4_0d;   // d tmp0d / dz
  const float d1c = 2.0f * kC4_1c_zz * z;             // d tmp1c / dz
  const float d12 = 3.0f * kC4_12_zz * zz - kC4_12;   // d psh12 / dz
  db[0][0] = 4.0f * kC4_fc * t.fs2; db[0][1] = 4.0f * kC4_fc * t.fc2; db[0][2] = 0.0f;
  db[1][0] = 3.0f * t.tmp2b * t.fs1; db[1][1] = 3.0f * t.tmp2b * t.fc1;
  db[1][2] = kC4_2b * t.fs2;
  db[2][0] = 2.0f * t.tmp1c * y; db[2][1] = 2.0f * t.tmp1c * x; db[2][2] = d1c * t.fs1;
  db[3][0] = 0.0f; db[3][1] = t.tmp0d; db[3][2] = d0d * y;
  db[4][0] = 0.0f; db[4][1] = 0.0f;
  db[4][2] = kC4_19z * (t.psh12 + z * d12) - kC4_19 * (2.0f * kC4_6_zz * z);
  db[5][0] = t.tmp0d; db[5][1] = 0.0f; db[5][2] = d0d * x;
  db[6][0] = 2.0f * t.tmp1c * x; db[6][1] = -2.0f * t.tmp1c * y; db[6][2] = d1c * t.fc1;
  db[7][0] = 3.0f * t.tmp2b * t.fc1; db[7][1] = -3.0f * t.tmp2b * t.fs1;
  db[7][2] = kC4_2b * t.fc2;
  db[8][0] = 4.0f * kC4_fc * t.fc2; db[8][1] = -4.0f * kC4_fc * t.fs2; db[8][2] = 0.0f;
}

// rest coefficients of the bands up to `deg`
__host__ __device__ __forceinline__ int sh_coeffs(int deg) {
  return deg >= 4 ? 24 : deg == 3 ? 15 : deg == 2 ? 8 : deg == 1 ? 3 : 0;
}

__global__ void __launch_bounds__(kBlock) project_fwd_kernel(
    const float* __restrict__ means, const float* __restrict__ scaling,
    const float* __restrict__ rotation, const float* __restrict__ opac_raw,
    const float* __restrict__ sh0, const float* __restrict__ shN,
    const bool* __restrict__ alive, int n, const float* __restrict__ w2c_dev,
    const float* __restrict__ cam_pos, const ProjCamera cam,
    float* __restrict__ mean2d, float* __restrict__ conic, float* __restrict__ opacity,
    float* __restrict__ color, float* __restrict__ depth, int* __restrict__ tile_min,
    int* __restrict__ tile_max, int* __restrict__ n_tiles,
    float* __restrict__ power_threshold, bool* __restrict__ visible) {
  // the warp's rows of shN, staged through shared memory (a row is 3 x sh_rest floats)
  extern __shared__ float stage[];
  const int lane = threadIdx.x & 31;
  const int first = blockIdx.x * kBlock + (threadIdx.x & ~31);
  if (first >= n) return;
  const int rows = min(32, n - first);
  const int r3 = 3 * cam.sh_rest;
  float* rest = stage + (threadIdx.x & ~31) * r3;
  load_rows(shN + static_cast<long long>(first) * r3, rows * r3, rest, lane);
  __syncwarp();
  if (lane >= rows) return;
  const int g = first + lane;
  float w[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) w[i] = __ldg(w2c_dev + i);
  Geo o;
  geometry(means, scaling, rotation, opac_raw, alive, w, cam, g, o);

  bool vis = o.vis0 && o.op >= kMinAlpha;
  // the chain's torch.sum(q * q, -1), which pairs four elements
  const float q2 = (o.q[0] * o.q[0] + o.q[2] * o.q[2]) + (o.q[1] * o.q[1] + o.q[3] * o.q[3]);
  vis = vis && q2 >= 1e-8f;
  vis = vis && o.det >= 1e-8f;

  const float m2x = o.x * cam.fx + cam.cx;
  const float m2y = o.y * cam.fy + cam.cy;

  // opacity-aware screen extent (kernels_forward.cuh:158-170)
  const float pt = logf(clamp_min_nan(o.op, kMinAlpha) * kMinAlphaRcp);
  const float ptf = sqrtf(clamp_min_nan(2.0f * pt, 0.0f));
  const float ext_x = clamp_min_nan(ptf * sqrtf(clamp_min_nan(o.cov_a, 0.0f)) - 0.5f, 0.0f);
  const float ext_y = clamp_min_nan(ptf * sqrtf(clamp_min_nan(o.cov_c, 0.0f)) - 0.5f, 0.0f);

  const int gw = (cam.width + cam.tile_size - 1) / cam.tile_size;
  const int gh = (cam.height + cam.tile_size - 1) / cam.tile_size;
  const float ts = static_cast<float>(cam.tile_size);
  const int x0 = tile_bound(floorf((m2x - ext_x) / ts), gw);
  const int x1 = tile_bound(ceilf((m2x + ext_x) / ts), gw);
  const int y0 = tile_bound(floorf((m2y - ext_y) / ts), gh);
  const int y1 = tile_bound(ceilf((m2y + ext_y) / ts), gh);
  const int nt = (x1 - x0) * (y1 - y0);
  vis = vis && nt > 0;

  // SH colour (sh.py::sh_to_color)
  const float cp[3] = {__ldg(cam_pos), __ldg(cam_pos + 1), __ldg(cam_pos + 2)};
  Dir d;
  view_dir(o.m, cp, d);
  float b[15], b4[9];
  sh_basis(d, b);
  const int nb = sh_coeffs(cam.sh_degree);
  if (nb >= 24) sh_basis4(d, b4);
  const float* c = rest + lane * r3;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float col = kC0 * __ldg(sh0 + 3 * g + ch) + 0.5f;
    // each band is summed on its own, then added to the colour
    if (nb >= 3) {
      col = col + ((b[0] * c[ch] + b[1] * c[3 + ch]) + b[2] * c[6 + ch]);
    }
    if (nb >= 8) {
      float s = b[3] * c[9 + ch];
#pragma unroll
      for (int j = 4; j < 8; ++j) s = s + b[j] * c[3 * j + ch];
      col = col + s;
    }
    if (nb >= 15) {
      float s = b[8] * c[24 + ch];
#pragma unroll
      for (int j = 9; j < 15; ++j) s = s + b[j] * c[3 * j + ch];
      col = col + s;
    }
    if (nb >= 24) {
      float s = b4[0] * c[45 + ch];
#pragma unroll
      for (int j = 1; j < 9; ++j) s = s + b4[j] * c[3 * (15 + j) + ch];
      col = col + s;
    }
    color[3 * g + ch] = col;
  }

  mean2d[2 * g] = m2x;
  mean2d[2 * g + 1] = m2y;
  conic[3 * g] = o.cov_c / o.sdet;
  conic[3 * g + 1] = -o.cov_b / o.sdet;
  conic[3 * g + 2] = o.cov_a / o.sdet;
  opacity[g] = o.op;
  depth[g] = o.depth;
  tile_min[2 * g] = x0;
  tile_min[2 * g + 1] = y0;
  tile_max[2 * g] = x1;
  tile_max[2 * g + 1] = y1;
  n_tiles[g] = vis ? nt : 0;
  power_threshold[g] = pt;
  visible[g] = vis;
}

__device__ __forceinline__ float load_or_zero(const float* p, long long i) {
  return p != nullptr ? __ldg(p + i) : 0.0f;
}

// The backward of slot g; `c` holds its row of shN on entry and its gradient on exit.
__device__ __forceinline__ void backward_slot(
    const float* __restrict__ means, const float* __restrict__ scaling,
    const float* __restrict__ rotation, const float* __restrict__ opac_raw,
    const bool* __restrict__ alive, const float* __restrict__ w2c_dev,
    const float* __restrict__ cam_pos, const ProjCamera& cam,
    const float* __restrict__ g_mean2d, const float* __restrict__ g_conic,
    const float* __restrict__ g_opacity, const float* __restrict__ g_color,
    const float* __restrict__ g_depth, const float* __restrict__ g_pt,
    float* __restrict__ d_means, float* __restrict__ d_scaling,
    float* __restrict__ d_rotation, float* __restrict__ d_opac, float* __restrict__ d_sh0,
    int g, float* c) {
  float w[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) w[i] = __ldg(w2c_dev + i);
  const float* r1 = w;
  const float* r2 = w + 4;
  const float* r3 = w + 8;
  Geo o;
  geometry(means, scaling, rotation, opac_raw, alive, w, cam, g, o);

  float gx = 0.0f, gy = 0.0f, g_sd = 0.0f;
  float g_dep = load_or_zero(g_depth, g);
  // mean2d = (x fx + cx, y fy + cy)
  gx += load_or_zero(g_mean2d, 2 * g) * cam.fx;
  gy += load_or_zero(g_mean2d, 2 * g + 1) * cam.fy;

  // conic = (c, -b, a) / safe_det
  const float gc0 = load_or_zero(g_conic, 3 * g);
  const float gc1 = load_or_zero(g_conic, 3 * g + 1);
  const float gc2 = load_or_zero(g_conic, 3 * g + 2);
  float g_ca = gc2 / o.sdet;
  float g_cb = -gc1 / o.sdet;
  float g_cc = gc0 / o.sdet;
  if (o.det > 1e-12f) {
    const float g_det = -(gc0 * o.cov_c - gc1 * o.cov_b + gc2 * o.cov_a) / (o.sdet * o.sdet);
    g_ca += g_det * o.cov_c;
    g_cc += g_det * o.cov_a;
    g_cb -= 2.0f * g_det * o.cov_b;
  }

  // opacity and the power threshold log(max(op, 1/255) 255)
  float g_op = load_or_zero(g_opacity, g);
  if (g_pt != nullptr && o.op >= kMinAlpha) g_op += __ldg(g_pt + g) / o.op;
  d_opac[g] = g_op * o.op * (1.0f - o.op);

  // the covariance: cov = sum_k var_k (u_k u_k, u_k v_k, v_k v_k)
  float g_u[3], g_v[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float u = o.u[k], v = o.v[k], var = o.var[k];
    const float g_var = g_ca * u * u + g_cb * u * v + g_cc * v * v;
    d_scaling[3 * g + k] = 2.0f * var * g_var;
    g_u[k] = var * (2.0f * g_ca * u + g_cb * v);
    g_v[k] = var * (g_cb * u + 2.0f * g_cc * v);
  }
  // u_k = sum_i jw1_i R_ik, v_k = sum_i jw2_i R_ik
  float g_jw1[3], g_jw2[3], g_rc[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g_jw1[i] = g_u[0] * o.rc[i][0] + g_u[1] * o.rc[i][1] + g_u[2] * o.rc[i][2];
    g_jw2[i] = g_v[0] * o.rc[i][0] + g_v[1] * o.rc[i][1] + g_v[2] * o.rc[i][2];
#pragma unroll
    for (int k = 0; k < 3; ++k) g_rc[i][k] = g_u[k] * o.jw1[i] + g_v[k] * o.jw2[i];
  }
  // jw1_i = j11 r1_i + j13 r3_i, jw2_i = j22 r2_i + j23 r3_i
  float g_j11 = 0.0f, g_j13 = 0.0f, g_j22 = 0.0f, g_j23 = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g_j11 += g_jw1[i] * r1[i];
    g_j13 += g_jw1[i] * r3[i];
    g_j22 += g_jw2[i] * r2[i];
    g_j23 += g_jw2[i] * r3[i];
  }
  // j13 = -j11 tx, j23 = -j22 ty; j11 = fx / sd, j22 = fy / sd
  g_j11 -= g_j13 * o.tx;
  g_j22 -= g_j23 * o.ty;
  const float g_tx = -g_j13 * o.j11;
  const float g_ty = -g_j23 * o.j22;
  g_sd -= (g_j11 * o.j11 + g_j22 * o.j22) / o.sd;
  // the clamps pass the gradient within their closed range
  if (o.x >= cam.lo_x && o.x <= cam.hi_x) gx += g_tx;
  if (o.y >= cam.lo_y && o.y <= cam.hi_y) gy += g_ty;
  // x = X / sd, y = Y / sd
  const float gX = gx / o.sd;
  const float gY = gy / o.sd;
  g_sd -= (gx * o.x + gy * o.y) / o.sd;
  // sd = depth where vis0
  if (o.vis0) g_dep += g_sd;

  // the rotation's entries from the quaternion's scaled products
  const float g_xx = -(g_rc[1][1] + g_rc[2][2]);
  const float g_yy = -(g_rc[0][0] + g_rc[2][2]);
  const float g_zz = -(g_rc[0][0] + g_rc[1][1]);
  const float g_xy = g_rc[0][1] + g_rc[1][0];
  const float g_xz = g_rc[0][2] + g_rc[2][0];
  const float g_yz = g_rc[1][2] + g_rc[2][1];
  const float g_rx = g_rc[2][1] - g_rc[1][2];
  const float g_ry = g_rc[0][2] - g_rc[2][0];
  const float g_rz = g_rc[1][0] - g_rc[0][1];
  const float qr = o.q[0], qx = o.q[1], qy = o.q[2], qz = o.q[3];
  const float g_s = g_xx * qx * qx + g_yy * qy * qy + g_zz * qz * qz + g_xy * qx * qy
                    + g_xz * qx * qz + g_yz * qy * qz + g_rx * qr * qx + g_ry * qr * qy
                    + g_rz * qr * qz;
  float gq[4];
  gq[0] = o.s * (g_rx * qx + g_ry * qy + g_rz * qz);
  gq[1] = o.s * (2.0f * g_xx * qx + g_xy * qy + g_xz * qz + g_rx * qr);
  gq[2] = o.s * (2.0f * g_yy * qy + g_xy * qx + g_yz * qz + g_ry * qr);
  gq[3] = o.s * (2.0f * g_zz * qz + g_xz * qx + g_yz * qy + g_rz * qr);
  // s = 2 / max(|q|^2, 1e-8)
  if (o.nq_raw >= 1e-8f) {
    const float g_n = -g_s * o.s * 0.5f * o.s;
#pragma unroll
    for (int i = 0; i < 4; ++i) gq[i] += 2.0f * g_n * o.q[i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) d_rotation[4 * g + i] = gq[i];

  // SH colour
  const float cp[3] = {__ldg(cam_pos), __ldg(cam_pos + 1), __ldg(cam_pos + 2)};
  Dir d;
  view_dir(o.m, cp, d);
  float gcol[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    gcol[ch] = load_or_zero(g_color, 3 * g + ch);
    d_sh0[3 * g + ch] = kC0 * gcol[ch];
  }
  const int nb = sh_coeffs(cam.sh_degree);
  float gdir[3] = {0.0f, 0.0f, 0.0f};
  if (nb > 0) {
    float b[15], db[15][3];
    sh_basis(d, b);
    sh_basis_grad(d, db);
#pragma unroll
    for (int j = 0; j < 15; ++j) {
      if (j < nb) {
        float wj = 0.0f;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          wj += gcol[ch] * c[3 * j + ch];
          c[3 * j + ch] = b[j] * gcol[ch];
        }
#pragma unroll
        for (int a = 0; a < 3; ++a) gdir[a] += wj * db[j][a];
      }
    }
  }
  if (nb >= 24) {
    float b4[9], db4[9][3];
    sh_basis4(d, b4);
    sh_basis4_grad(d, db4);
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      float wj = 0.0f;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        wj += gcol[ch] * c[3 * (15 + j) + ch];
        c[3 * (15 + j) + ch] = b4[j] * gcol[ch];
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) gdir[a] += wj * db4[j][a];
    }
  }
  for (int i = 3 * nb; i < 3 * cam.sh_rest; ++i) c[i] = 0.0f;
  // (x, y, z) = dirs r, r = rsqrt(max(|dirs|^2, 1e-24))
  const float g_r = gdir[0] * d.d[0] + gdir[1] * d.d[1] + gdir[2] * d.d[2];
  float g_dirs[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) g_dirs[i] = gdir[i] * d.r;
  if (d.ns >= 1e-24f) {
    const float g_ns = g_r * (-0.5f * d.r * d.r * d.r);
#pragma unroll
    for (int i = 0; i < 3; ++i) g_dirs[i] += 2.0f * g_ns * d.d[i];
  }

  // means: depth, X, Y rows of w2c, and the view direction
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    d_means[3 * g + i] = gX * r1[i] + gY * r2[i] + g_dep * r3[i] + g_dirs[i];
  }
}

__global__ void __launch_bounds__(kBlock) project_bwd_kernel(
    const float* __restrict__ means, const float* __restrict__ scaling,
    const float* __restrict__ rotation, const float* __restrict__ opac_raw,
    const float* __restrict__ shN, const bool* __restrict__ alive, int n,
    const float* __restrict__ w2c_dev, const float* __restrict__ cam_pos,
    const ProjCamera cam, const float* __restrict__ g_mean2d,
    const float* __restrict__ g_conic, const float* __restrict__ g_opacity,
    const float* __restrict__ g_color, const float* __restrict__ g_depth,
    const float* __restrict__ g_pt, float* __restrict__ d_means,
    float* __restrict__ d_scaling, float* __restrict__ d_rotation,
    float* __restrict__ d_opac, float* __restrict__ d_sh0, float* __restrict__ d_shN) {
  // the warp's rows of shN in, and of its gradient out, through shared memory
  extern __shared__ float stage[];
  const int lane = threadIdx.x & 31;
  const int first = blockIdx.x * kBlock + (threadIdx.x & ~31);
  if (first >= n) return;
  const int rows = min(32, n - first);
  const int r3 = 3 * cam.sh_rest;
  float* rest = stage + (threadIdx.x & ~31) * r3;
  const long long offset = static_cast<long long>(first) * r3;
  load_rows(shN + offset, rows * r3, rest, lane);
  __syncwarp();
  if (lane < rows) {
    backward_slot(means, scaling, rotation, opac_raw, alive, w2c_dev, cam_pos, cam,
                  g_mean2d, g_conic, g_opacity, g_color, g_depth, g_pt, d_means, d_scaling,
                  d_rotation, d_opac, d_sh0, first + lane, rest + lane * r3);
  }
  __syncwarp();
  store_rows(rest, rows * r3, d_shN + offset, lane);
}

}  // namespace

extern "C" int tpu_splat_project_fwd(const float* means, const float* scaling,
                                     const float* rotation, const float* opac_raw,
                                     const float* sh0, const float* shN, const bool* alive,
                                     int n, const float* w2c, const float* cam_pos,
                                     ProjCamera cam, float* mean2d, float* conic,
                                     float* opacity, float* color, float* depth,
                                     int* tile_min, int* tile_max, int* n_tiles,
                                     float* power_threshold, bool* visible,
                                     cudaStream_t stream) {
  if (n <= 0) return 0;
  if (cam.tile_size <= 0 || cam.width <= 0 || cam.height <= 0 || cam.sh_degree < 0
      || cam.sh_degree > 4 || cam.sh_rest < sh_coeffs(cam.sh_degree)
      || cam.sh_rest > kMaxRest) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = (n + kBlock - 1) / kBlock;
  const size_t stage = sizeof(float) * kBlock * 3 * cam.sh_rest;
  project_fwd_kernel<<<grid, kBlock, stage, stream>>>(
      means, scaling, rotation, opac_raw, sh0, shN, alive, n, w2c, cam_pos, cam, mean2d,
      conic, opacity, color, depth, tile_min, tile_max, n_tiles, power_threshold, visible);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpu_splat_project_bwd(const float* means, const float* scaling,
                                     const float* rotation, const float* opac_raw,
                                     const float* shN, const bool* alive, int n,
                                     const float* w2c, const float* cam_pos, ProjCamera cam,
                                     const float* g_mean2d, const float* g_conic,
                                     const float* g_opacity, const float* g_color,
                                     const float* g_depth, const float* g_pt,
                                     float* d_means, float* d_scaling, float* d_rotation,
                                     float* d_opac, float* d_sh0, float* d_shN,
                                     cudaStream_t stream) {
  if (n <= 0) return 0;
  if (cam.tile_size <= 0 || cam.width <= 0 || cam.height <= 0 || cam.sh_degree < 0
      || cam.sh_degree > 4 || cam.sh_rest < sh_coeffs(cam.sh_degree)
      || cam.sh_rest > kMaxRest) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = (n + kBlock - 1) / kBlock;
  const size_t stage = sizeof(float) * kBlock * 3 * cam.sh_rest;
  project_bwd_kernel<<<grid, kBlock, stage, stream>>>(
      means, scaling, rotation, opac_raw, shN, alive, n, w2c, cam_pos, cam, g_mean2d,
      g_conic, g_opacity, g_color, g_depth, g_pt, d_means, d_scaling, d_rotation, d_opac,
      d_sh0, d_shN);
  return static_cast<int>(cudaGetLastError());
}
