// GUT projection layer for Hopper (sm_90a): the unscented-transform projection of every
// Gaussian slot and the per-pixel world rays of a window of tiles.
//
// Replaces the host-dispatched chains of `tpu_splat_torch/ops/gut.py::ut_project` and
// `pixel_world_rays` (global shutter; a rolling shutter keeps the chains). Counterparts
// of `tpu_splat/ops/gut.py` and of the reference's `ProjectionUT3DGSFused.cu:17-289` and
// `Cameras.cuh` (pinhole :504-629, fisheye :894-1000).
//
// tpu_splat_ut_project: one thread per slot. Rotation from the quaternion, the seven sigma
// points mu, mu +- sqrt(3 + lambda) s_i R[:, i], w2c, the camera model (OpenCV pinhole
// with radial6 / tangential2 / thin-prism4, fisheye with its max angle, or ortho) with
// its validity tests, the UT mean and covariance, then the projection tail: the eps2d
// blur, compensation, the 1/255 cull, the opacity-aware extent, the radii and the
// clamped tile rect. Writes every field of `Projected` and the compensation in one pass.
//
// tpu_splat_gut_rays: one thread per pixel of grid_h tile rows from tile row tile_y0.
// The pixel centre, the camera ray (pinhole: 20 undistortion steps; fisheye: 10 Newton
// steps with the clip; ortho: +z, with the per-pixel origin offset), w2c[:3, :3] applied,
// written as (dx, dy, dz, 0) or (dx, dy, dz, 0, dox, doy, doz, 0) in 16-byte stores.
//
// Arithmetic: each value is computed as the plain chain computes it on the card, in its
// operation order, so that the two agree bit for bit (--fmad=false keeps separate
// multiplies and adds; the fused steps below are those the chain's cuBLAS calls take, and
// PERF.md records the probe that found them): the products with w2c are sequences of
// fused multiply-adds from zero over k = 0, 1, 2, as cuBLAS's SIMT gemm takes them; the UT
// mean is such a sequence over the seven points (cuBLAS's gemv2N, which the chain's
// einsum reaches at 2^16 slots and more); the covariance is such a sequence over the
// points of the products (w_s dev_i) dev_j (the einsum's bmm). The norm of a ray is
// sqrt((x^2 + z^2) + y^2), as PyTorch's reduction pairs three elements. A division by a
// host scalar is a product with its float32 reciprocal, as PyTorch takes it; clamps keep
// a NaN, as PyTorch's do.
//
// Bound on the H100: the projection by bytes, the rays by operations. The projection reads
// 45 bytes a slot and writes 69 (~120 MB at 2^20 slots, ~0.036 ms at 3.35 TB/s); the rays
// kernel writes 16 or 32 bytes a pixel (17.6 MB at 1296x840, tile 16, ~0.005 ms) and reads
// nothing but the camera, and its ~855 FP32 operations a pixel (820 in the 20 undistortion
// steps; chip_smoke.py counts them) are ~0.94 GFLOP a table, ~0.014 ms at 67 TFLOP/s.
// Neither kernel synchronises: the camera's scalars are launch arguments, w2c, the
// distortion coefficients bound to a view and a fisheye's max angle computed on the card
// are read from device memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kPinhole = 0, kFisheye = 1, kOrtho = 2;
constexpr int kPoints = 7;
constexpr int kUndistortIters = 20;  // cameras.py N_UNDISTORT_ITERS
constexpr int kNewtonIters = 10;     // cameras.py N_NEWTON_ITERS

}  // namespace

// Launch arguments. Mirrored by `tpu_splat_torch/ops/cuda/build.py::Camera` / `UtConsts`.
struct Camera {
  int model;                     // kPinhole | kFisheye | kOrtho
  int width, height, tile_size;
  float fx, fy, cx, cy;          // float32 of the host values
  float rfx, rfy;                // 1 / fx, 1 / fy in float32 (ortho ray origins)
  float lo_x, hi_x, lo_y, hi_y;  // the image bounds with the 0.15 margin
  float max_angle;               // fisheye, unless a device scalar is given
  float coef[12];                // radial6 | tangential2 | thin-prism4, unless bound
  float dk[3];                   // 3 k1, 5 k2, 7 k3 of the fisheye derivative, unless bound
};

struct UtConsts {
  float sqrt_dl;                 // sqrt(3 + lambda)
  float wm0, wc0, wi;            // UT weights of the mean point and of the others
  float eps2d, min_alpha, max_extent, near;
};

namespace {

struct Coeffs {
  float k[12];
  float dk[3];
  float max_angle;
};

__device__ __forceinline__ float clamp_min_nan(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float clamp_max_nan(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}

__device__ __forceinline__ Coeffs load_coeffs(const Camera& cam, const float* dist,
                                              const float* max_angle) {
  Coeffs c;
  if (dist != nullptr) {
#pragma unroll
    for (int i = 0; i < 12; ++i) c.k[i] = __ldg(dist + i);
    c.dk[0] = c.k[0] * 3.0f;
    c.dk[1] = c.k[1] * 5.0f;
    c.dk[2] = c.k[2] * 7.0f;
  } else {
#pragma unroll
    for (int i = 0; i < 12; ++i) c.k[i] = cam.coef[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) c.dk[i] = cam.dk[i];
  }
  c.max_angle = max_angle != nullptr ? __ldg(max_angle) : cam.max_angle;
  return c;
}

// cameras.py::_distortion (Cameras.cuh:504-533): icd and (dx, dy) at (x, y)
__device__ __forceinline__ void distortion(float x, float y, const float* k, float& icd,
                                           float& dx, float& dy) {
  const float x2 = x * x;
  const float y2 = y * y;
  const float r2 = x2 + y2;
  const float a1 = (2.0f * x) * y;
  const float a2 = r2 + 2.0f * x2;
  const float a3 = r2 + 2.0f * y2;
  const float num = 1.0f + r2 * (k[0] + r2 * (k[1] + r2 * k[2]));
  const float den = 1.0f + r2 * (k[3] + r2 * (k[4] + r2 * k[5]));
  icd = num / den;
  dx = (k[6] * a1 + k[7] * a2) + r2 * (k[8] + r2 * k[9]);
  dy = (k[6] * a3 + k[7] * a1) + r2 * (k[10] + r2 * k[11]);
}

__device__ __forceinline__ float fisheye_poly(float th, const Coeffs& c) {
  const float t2 = th * th;
  return th * (1.0f + t2 * (c.k[0] + t2 * (c.k[1] + t2 * (c.k[2] + t2 * c.k[3]))));
}

__device__ __forceinline__ float fisheye_dpoly(float th, const Coeffs& c) {
  const float t2 = th * th;
  return 1.0f + t2 * (c.dk[0] + t2 * (c.dk[1] + t2 * (c.dk[2] + (t2 * 9.0f) * c.k[3])));
}

__device__ __forceinline__ bool in_bounds(const Camera& cam, float ix, float iy) {
  return ix >= cam.lo_x && ix <= cam.hi_x && iy >= cam.lo_y && iy <= cam.hi_y;
}

// w2c[:3, :3] p + w2c[:3, 3], as the chain's `pts @ w2c[:3, :3].T + w2c[:3, 3]`
__device__ __forceinline__ float affine_row(const float* w, float x, float y, float z) {
  return fmaf(z, w[2], fmaf(y, w[1], fmaf(x, w[0], 0.0f))) + w[3];
}

// camera-space point -> image point and validity (cameras.py::project_points)
template <int MODEL>
__device__ __forceinline__ bool project(const Camera& cam, const Coeffs& c, float x, float y,
                                        float z, float& ix, float& iy) {
  if (MODEL == kPinhole) {
    const float sz = z > 0.0f ? z : 1.0f;
    const float u = x / sz;
    const float v = y / sz;
    float icd, dx, dy;
    distortion(u, v, c.k, icd, dx, dy);
    ix = (icd * u + dx) * cam.fx + cam.cx;
    iy = (icd * v + dy) * cam.fy + cam.cy;
    return z > 0.0f && icd > 0.8f && in_bounds(cam, ix, iy);
  } else if (MODEL == kFisheye) {
    const float rxy = clamp_min_nan(sqrtf(x * x + y * y), 1e-12f);
    const float th_full = atan2f(rxy, z);
    const float th = clamp_max_nan(th_full, c.max_angle);
    const float delta = fisheye_poly(th, c) / rxy;
    ix = (cam.fx * delta) * x + cam.cx;
    iy = (cam.fy * delta) * y + cam.cy;
    return z > 0.0f && delta > 0.0f && th_full <= c.max_angle && in_bounds(cam, ix, iy);
  } else {
    ix = cam.fx * x + cam.cx;
    iy = cam.fy * y + cam.cy;
    return z > 0.0f && in_bounds(cam, ix, iy);
  }
}

// floor / ceil(v / tile) clamped to [0, hi] (a NaN to 0, as the chain's int cast takes it)
__device__ __forceinline__ int tile_bound(float t, int hi) {
  const float f = fminf(fmaxf(t, 0.0f), static_cast<float>(hi));
  return min(max(static_cast<int>(f), 0), hi);
}

template <int MODEL>
__global__ void __launch_bounds__(kBlock) ut_project_kernel(
    const float* __restrict__ means,     // [N, 3]
    const float* __restrict__ scaling,   // [N, 3] log sigma
    const float* __restrict__ rotation,  // [N, 4] wxyz, unnormalised
    const float* __restrict__ opac_raw,  // [N] logit
    const bool* __restrict__ alive,      // [N]
    int n, const float* __restrict__ w2c_dev, const float* __restrict__ dist,
    const float* __restrict__ max_angle, const Camera cam, const UtConsts k,
    float* __restrict__ mean2d, float* __restrict__ conic, float* __restrict__ opacity,
    float* __restrict__ color, float* __restrict__ depth, int* __restrict__ tile_min,
    int* __restrict__ tile_max, int* __restrict__ n_tiles,
    float* __restrict__ power_threshold, bool* __restrict__ visible,
    float* __restrict__ compensation) {
  const int g = blockIdx.x * kBlock + threadIdx.x;
  if (g >= n) return;
  const Coeffs c = load_coeffs(cam, dist, max_angle);
  float w[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) w[i] = __ldg(w2c_dev + i);

  // rotation (quat.py::quat_to_rotmat_cols), |q|^2 folded in, clamped at 1e-8
  const float qr = __ldg(rotation + 4 * g), qx = __ldg(rotation + 4 * g + 1);
  const float qy = __ldg(rotation + 4 * g + 2), qz = __ldg(rotation + 4 * g + 3);
  const float nq = clamp_min_nan(((qr * qr + qx * qx) + qy * qy) + qz * qz, 1e-8f);
  const float s = (1.0f / nq) * 2.0f;
  const float xx = (s * qx) * qx, yy = (s * qy) * qy, zz = (s * qz) * qz;
  const float xy = (s * qx) * qy, xz = (s * qx) * qz, yz = (s * qy) * qz;
  const float rx = (s * qr) * qx, ry = (s * qr) * qy, rz = (s * qr) * qz;
  const float rot[3][3] = {{1.0f - (yy + zz), xy - rz, ry + xz},
                           {rz + xy, 1.0f - (xx + zz), yz - rx},
                           {xz - ry, rx + yz, 1.0f - (xx + yy)}};

  // sigma points: mu, mu + d_i, mu - d_i with d_i = (sqrt_dl s_i) R[:, i]
  const float mu[3] = {__ldg(means + 3 * g), __ldg(means + 3 * g + 1),
                       __ldg(means + 3 * g + 2)};
  float pts[kPoints][3];
#pragma unroll
  for (int j = 0; j < 3; ++j) pts[0][j] = mu[j];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float si = k.sqrt_dl * expf(__ldg(scaling + 3 * g + i));
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float d = si * rot[j][i];
      pts[1 + i][j] = mu[j] + d;
      pts[4 + i][j] = mu[j] - d;
    }
  }

  float img[kPoints][2];
  bool any_valid = false;
  float cam_z0 = 0.0f;
#pragma unroll
  for (int p = 0; p < kPoints; ++p) {
    const float cx = affine_row(w, pts[p][0], pts[p][1], pts[p][2]);
    const float cy = affine_row(w + 4, pts[p][0], pts[p][1], pts[p][2]);
    const float cz = affine_row(w + 8, pts[p][0], pts[p][1], pts[p][2]);
    if (p == 0) cam_z0 = cz;
    any_valid |= project<MODEL>(cam, c, cx, cy, cz, img[p][0], img[p][1]);
  }

  // UT mean and covariance
  float m[2] = {0.0f, 0.0f};
#pragma unroll
  for (int p = 0; p < kPoints; ++p) {
    const float wp = p == 0 ? k.wm0 : k.wi;
    m[0] = fmaf(wp, img[p][0], m[0]);
    m[1] = fmaf(wp, img[p][1], m[1]);
  }
  float cov[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
  for (int p = 0; p < kPoints; ++p) {
    const float wp = p == 0 ? k.wc0 : k.wi;
    const float d0 = img[p][0] - m[0];
    const float d1 = img[p][1] - m[1];
    const float t0 = wp * d0, t1 = wp * d1;
    cov[0][0] = fmaf(t0, d0, cov[0][0]);
    cov[0][1] = fmaf(t0, d1, cov[0][1]);
    cov[1][0] = fmaf(t1, d0, cov[1][0]);
    cov[1][1] = fmaf(t1, d1, cov[1][1]);
  }
  bool valid = alive[g] && any_valid;
  valid = valid && cam_z0 > k.near;

  // projection tail (ProjectionUT3DGSFused.cu:136-202)
  const float det_before = cov[0][0] * cov[1][1] - cov[0][1] * cov[1][0];
  const float cov_a = cov[0][0] + k.eps2d;
  const float cov_b = cov[0][1];
  const float cov_c = cov[1][1] + k.eps2d;
  const float det_after = cov_a * cov_c - cov_b * cov_b;
  valid = valid && det_after > 0.0f;
  const float safe_det = det_after > 1e-12f ? det_after : 1.0f;
  const float comp = sqrtf(clamp_min_nan(det_before, 0.0f) / safe_det);
  const float sig = 1.0f / (1.0f + expf(-__ldg(opac_raw + g)));
  const float op = sig * comp;
  valid = valid && op >= k.min_alpha;
  const float extend =
      clamp_max_nan(sqrtf(clamp_min_nan(2.0f * logf(op * 255.0f), 0.0f)), k.max_extent);
  const float rad_x = ceilf(extend * sqrtf(clamp_min_nan(cov_a, 0.0f)));
  const float rad_y = ceilf(extend * sqrtf(clamp_min_nan(cov_c, 0.0f)));
  valid = valid && rad_x > 0.0f && rad_y > 0.0f;

  const int gw = (cam.width + cam.tile_size - 1) / cam.tile_size;
  const int gh = (cam.height + cam.tile_size - 1) / cam.tile_size;
  const float ts = static_cast<float>(cam.tile_size);
  const int x0 = tile_bound(floorf((m[0] - rad_x) / ts), gw);
  const int x1 = tile_bound(ceilf((m[0] + rad_x) / ts), gw);
  const int y0 = tile_bound(floorf((m[1] - rad_y) / ts), gh);
  const int y1 = tile_bound(ceilf((m[1] + rad_y) / ts), gh);
  const int nt = (x1 - x0) * (y1 - y0);
  valid = valid && nt > 0;

  mean2d[2 * g] = m[0];
  mean2d[2 * g + 1] = m[1];
  conic[3 * g] = cov_c / safe_det;
  conic[3 * g + 1] = -cov_b / safe_det;
  conic[3 * g + 2] = cov_a / safe_det;
  opacity[g] = op;
  color[3 * g] = 0.0f;
  color[3 * g + 1] = 0.0f;
  color[3 * g + 2] = 0.0f;
  depth[g] = cam_z0;
  tile_min[2 * g] = x0;
  tile_min[2 * g + 1] = y0;
  tile_max[2 * g] = x1;
  tile_max[2 * g + 1] = y1;
  n_tiles[g] = valid ? nt : 0;
  power_threshold[g] = INFINITY;
  visible[g] = valid;
  compensation[g] = comp;
}

// w2c[:3, :3]^T d, as the chain's `rays @ w2c[:3, :3]`: column j of the rotation
__device__ __forceinline__ float rotate_col(const float* w, int j, float x, float y, float z) {
  return fmaf(z, w[8 + j], fmaf(y, w[4 + j], fmaf(x, w[j], 0.0f)));
}

__device__ __forceinline__ float norm3(float x, float y, float z) {
  return sqrtf((x * x + z * z) + y * y);
}

template <int MODEL>
__global__ void __launch_bounds__(kBlock) gut_rays_kernel(
    const float* __restrict__ w2c_dev, const float* __restrict__ dist,
    const float* __restrict__ max_angle, const Camera cam, int grid_w, int n_tiles,
    int tile_y0, float* __restrict__ rays) {
  const int ts = cam.tile_size;
  const int pix = ts * ts;
  const long long i = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= static_cast<long long>(n_tiles) * pix) return;
  const int t = static_cast<int>(i / pix) + tile_y0 * grid_w;
  const int p = static_cast<int>(i % pix);
  const float px = static_cast<float>((t % grid_w) * ts + p % ts) + 0.5f;
  const float py = static_cast<float>((t / grid_w) * ts + p / ts) + 0.5f;
  float w[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) w[j] = __ldg(w2c_dev + j);

  float d[3];
  if (MODEL == kOrtho) {
    d[0] = 0.0f;
    d[1] = 0.0f;
    d[2] = 1.0f;
  } else {
    const Coeffs c = load_coeffs(cam, dist, max_angle);
    const float u0 = (px - cam.cx) / cam.fx;
    const float v0 = (py - cam.cy) / cam.fy;
    if (MODEL == kPinhole) {
      float u = u0, v = v0;
      for (int it = 0; it < kUndistortIters; ++it) {
        float icd, dx, dy;
        distortion(u, v, c.k, icd, dx, dy);
        const float den = clamp_min_nan(icd, 1e-6f);
        u = (u0 - dx) / den;
        v = (v0 - dy) / den;
      }
      const float nrm = norm3(u, v, 1.0f);
      d[0] = u / nrm;
      d[1] = v / nrm;
      d[2] = 1.0f / nrm;
    } else {
      const float delta = sqrtf(u0 * u0 + v0 * v0);
      float th = clamp_max_nan(clamp_min_nan(delta, 0.0f), c.max_angle);
      for (int it = 0; it < kNewtonIters; ++it) {
        const float f = fisheye_poly(th, c) - delta;
        const float df = clamp_min_nan(fisheye_dpoly(th, c), 1e-6f);
        th = clamp_max_nan(clamp_min_nan(th - f / df, 0.0f), c.max_angle);
      }
      const float scale = delta > 1e-9f ? sinf(th) / clamp_min_nan(delta, 1e-12f) : 0.0f;
      const float dx = scale * u0, dy = scale * v0, dz = cosf(th);
      const float nrm = norm3(dx, dy, dz);
      d[0] = dx / nrm;
      d[1] = dy / nrm;
      d[2] = dz / nrm;
    }
  }
  const float4 dir = make_float4(rotate_col(w, 0, d[0], d[1], d[2]),
                                 rotate_col(w, 1, d[0], d[1], d[2]),
                                 rotate_col(w, 2, d[0], d[1], d[2]), 0.0f);
  if (MODEL == kOrtho) {
    // parallel rays; the per-pixel origin offset (x - cx) / fx, (y - cy) / fy, 0 in world
    const float u = (px - cam.cx) * cam.rfx;
    const float v = (py - cam.cy) * cam.rfy;
    float4* out = reinterpret_cast<float4*>(rays) + 2 * i;
    out[0] = dir;
    out[1] = make_float4(rotate_col(w, 0, u, v, 0.0f), rotate_col(w, 1, u, v, 0.0f),
                         rotate_col(w, 2, u, v, 0.0f), 0.0f);
  } else {
    reinterpret_cast<float4*>(rays)[i] = dir;
  }
}

}  // namespace

extern "C" int tpu_splat_ut_project(const float* means, const float* scaling,
                                    const float* rotation, const float* opac_raw,
                                    const bool* alive, int n, const float* w2c,
                                    const float* dist, const float* max_angle, Camera cam,
                                    UtConsts k, float* mean2d, float* conic, float* opacity,
                                    float* color, float* depth, int* tile_min, int* tile_max,
                                    int* n_tiles, float* power_threshold, bool* visible,
                                    float* compensation, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (cam.tile_size <= 0 || cam.width <= 0 || cam.height <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = (n + kBlock - 1) / kBlock;
#define UT_LAUNCH(M)                                                                     \
  ut_project_kernel<M><<<grid, kBlock, 0, stream>>>(                                     \
      means, scaling, rotation, opac_raw, alive, n, w2c, dist, max_angle, cam, k, mean2d, \
      conic, opacity, color, depth, tile_min, tile_max, n_tiles, power_threshold, visible, \
      compensation)
  switch (cam.model) {
    case kPinhole: UT_LAUNCH(kPinhole); break;
    case kFisheye: UT_LAUNCH(kFisheye); break;
    case kOrtho: UT_LAUNCH(kOrtho); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef UT_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tpu_splat_gut_rays(const float* w2c, const float* dist, const float* max_angle,
                                  Camera cam, int grid_w, int n_tiles, int tile_y0,
                                  float* rays, cudaStream_t stream) {
  if (n_tiles <= 0) return 0;
  if (cam.tile_size <= 0 || grid_w <= 0 || tile_y0 < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long total = static_cast<long long>(n_tiles) * cam.tile_size * cam.tile_size;
  const unsigned grid = static_cast<unsigned>((total + kBlock - 1) / kBlock);
  switch (cam.model) {
    case kPinhole:
      gut_rays_kernel<kPinhole><<<grid, kBlock, 0, stream>>>(w2c, dist, max_angle, cam,
                                                             grid_w, n_tiles, tile_y0, rays);
      break;
    case kFisheye:
      gut_rays_kernel<kFisheye><<<grid, kBlock, 0, stream>>>(w2c, dist, max_angle, cam,
                                                             grid_w, n_tiles, tile_y0, rays);
      break;
    case kOrtho:
      gut_rays_kernel<kOrtho><<<grid, kBlock, 0, stream>>>(w2c, dist, max_angle, cam,
                                                           grid_w, n_tiles, tile_y0, rays);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
