// Fused Adam for Hopper (sm_90a): one launch updates every parameter leaf a train step
// trains (means, sh0, shN, scaling, rotation, opacity; shN left out while it is frozen).
//
// Replaces no Pallas kernel: the JAX package leaves Adam to XLA, which fuses it. On the
// card the port's plain version, the chain of `tpu_splat_torch/training/optim.py::adam_step`
// (`_adam_plain`), is 14 elementwise ops a leaf, each reading one or two whole tensors and
// writing a new one. The reference fuses it too (LichtFeld's FusedAdam, fastgs
// `adam_step_wrapper`).
//
// Bound on the H100 by bytes: a float reads p, g, m and v once and writes p', m' and v'
// once, 28 bytes, against 14 floating-point operations. At 2^22 slots of 59 floats (SH 3)
// that is 6.93 GB, 2.07 ms at 3.35 TB/s (chip_smoke.py counts it). The design streams:
// blocks are assigned to the leaves by the leaves' cumulative counts of 16-byte chunks, a
// thread takes kUnroll chunks of its leaf a block-width apart and issues the float4 loads
// of all of them, four streams each, before it computes, so that kUnroll x 64 bytes of
// each thread are in flight; the loads and stores are evict-first (`__ldcs`, `__stcs`):
// no stream is read again within the step. A leaf whose pointers are not 16-byte aligned,
// and the last chunk of a leaf whose count is not a multiple of 4, take a scalar path.
//
// Arithmetic: each value is computed as the chain computes it on the card, in its
// operation order, with the round-to-nearest intrinsics, so that the two agree bit for bit:
//   m' = 0.9 m + 0.1 g                         (two scalar products, then the add)
//   v' = 0.999 v + (0.001 g) g                 ((1 - b2) * g * g, left to right)
//   q  = lr (m' x inv_bc1)
//   d  = sqrt(v' x inv_bc2) + 1e-15
//   p' = p - q / d
// A tensor divided by a Python scalar is, in PyTorch's CUDA kernel, a product with the
// float reciprocal 1.0f / (float)bc computed on the host: the wrapper passes that
// reciprocal (`inv_bc1`, `inv_bc2`). The tensor division and the square root are
// IEEE-rounded, as PyTorch's are. The constants are the float32 roundings of the Python
// values the chain passes (tests/test_torch_adam.py holds them to optim.py's).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 6;
constexpr int kBlock = 256;
constexpr int kUnroll = 4;  // 16-byte chunks a thread
constexpr long long kChunksPerBlock = static_cast<long long>(kBlock) * kUnroll;

constexpr float kBeta1 = 0.9f;           // optim.py BETA1
constexpr float kOneMinusBeta1 = 0.1f;   // 1.0 - BETA1, rounded to float32
constexpr float kBeta2 = 0.999f;         // BETA2
constexpr float kOneMinusBeta2 = 0.001f; // 1.0 - BETA2, rounded to float32
constexpr float kEps = 1e-15f;           // EPS

}  // namespace

// one leaf: its tensors (n floats each), its learning rate and the reciprocals of its bias
// corrections; `vec` when all seven pointers are 16-byte aligned (ops/cuda/build.py
// AdamLeaf)
struct AdamLeaf {
  const float* p;
  const float* g;
  const float* m;
  const float* v;
  float* p_out;
  float* m_out;
  float* v_out;
  long long n;
  float lr;
  float inv_bc1;
  float inv_bc2;
  int vec;
};

// the launch's leaves, passed by value (ops/cuda/build.py AdamArgs)
struct AdamArgs {
  AdamLeaf leaf[kMaxLeaves];
  int n_leaves;
};

namespace {

// leaf l owns blocks [start[l], start[l + 1])
struct BlockStarts {
  long long start[kMaxLeaves + 1];
};

__device__ __forceinline__ void adam1(float p, float g, float m, float v, float lr,
                                      float inv_bc1, float inv_bc2, float& p2, float& m2,
                                      float& v2) {
  m2 = __fadd_rn(__fmul_rn(kBeta1, m), __fmul_rn(kOneMinusBeta1, g));
  v2 = __fadd_rn(__fmul_rn(kBeta2, v), __fmul_rn(__fmul_rn(kOneMinusBeta2, g), g));
  const float q = __fmul_rn(lr, __fmul_rn(m2, inv_bc1));
  const float d = __fadd_rn(__fsqrt_rn(__fmul_rn(v2, inv_bc2)), kEps);
  p2 = __fsub_rn(p, __fdiv_rn(q, d));
}

__device__ __forceinline__ float4 adam4(const float4 p, const float4 g, const float4 m,
                                        const float4 v, const AdamLeaf& a, float4& m2,
                                        float4& v2) {
  float4 p2;
  adam1(p.x, g.x, m.x, v.x, a.lr, a.inv_bc1, a.inv_bc2, p2.x, m2.x, v2.x);
  adam1(p.y, g.y, m.y, v.y, a.lr, a.inv_bc1, a.inv_bc2, p2.y, m2.y, v2.y);
  adam1(p.z, g.z, m.z, v.z, a.lr, a.inv_bc1, a.inv_bc2, p2.z, m2.z, v2.z);
  adam1(p.w, g.w, m.w, v.w, a.lr, a.inv_bc1, a.inv_bc2, p2.w, m2.w, v2.w);
  return p2;
}

// both arguments are indexed by the block's leaf: __grid_constant__ reads them in place
// rather than copying them to each thread's local memory
__global__ void __launch_bounds__(kBlock)
    adam_kernel(const __grid_constant__ AdamArgs args,
                const __grid_constant__ BlockStarts blocks) {
  const long long b = blockIdx.x;
  int l = 0;
  while (l + 1 < args.n_leaves && b >= blocks.start[l + 1]) ++l;
  const AdamLeaf& a = args.leaf[l];
  const long long first = (b - blocks.start[l]) * kChunksPerBlock + threadIdx.x;

  float4 p[kUnroll], g[kUnroll], m[kUnroll], v[kUnroll];
  bool full[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long c = first + static_cast<long long>(u) * kBlock;
    full[u] = a.vec && 4 * c + 4 <= a.n;
    if (full[u]) {
      p[u] = __ldcs(reinterpret_cast<const float4*>(a.p) + c);
      g[u] = __ldcs(reinterpret_cast<const float4*>(a.g) + c);
      m[u] = __ldcs(reinterpret_cast<const float4*>(a.m) + c);
      v[u] = __ldcs(reinterpret_cast<const float4*>(a.v) + c);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long c = first + static_cast<long long>(u) * kBlock;
    if (full[u]) {
      float4 m2, v2;
      const float4 p2 = adam4(p[u], g[u], m[u], v[u], a, m2, v2);
      __stcs(reinterpret_cast<float4*>(a.p_out) + c, p2);
      __stcs(reinterpret_cast<float4*>(a.m_out) + c, m2);
      __stcs(reinterpret_cast<float4*>(a.v_out) + c, v2);
    } else {
      const long long end = 4 * c + 4 < a.n ? 4 * c + 4 : a.n;
      for (long long i = 4 * c; i < end; ++i) {
        float p2, m2, v2;
        adam1(__ldcs(a.p + i), __ldcs(a.g + i), __ldcs(a.m + i), __ldcs(a.v + i), a.lr,
              a.inv_bc1, a.inv_bc2, p2, m2, v2);
        __stcs(a.p_out + i, p2);
        __stcs(a.m_out + i, m2);
        __stcs(a.v_out + i, v2);
      }
    }
  }
}

}  // namespace

extern "C" int tpu_splat_adam(AdamArgs args, cudaStream_t stream) {
  if (args.n_leaves < 0 || args.n_leaves > kMaxLeaves) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BlockStarts blocks = {};
  for (int l = 0; l < args.n_leaves; ++l) {
    const long long n = args.leaf[l].n;
    if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
    const long long chunks = (n + 3) / 4;
    blocks.start[l + 1] = blocks.start[l] + (chunks + kChunksPerBlock - 1) / kChunksPerBlock;
  }
  const long long grid = blocks.start[args.n_leaves];
  if (grid == 0) return 0;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  adam_kernel<<<static_cast<unsigned>(grid), kBlock, 0, stream>>>(args, blocks);
  return static_cast<int>(cudaGetLastError());
}
