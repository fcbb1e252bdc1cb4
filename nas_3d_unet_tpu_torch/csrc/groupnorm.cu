// GroupNorm's two elementwise passes, fp32 or bf16 in and out, fp32 math.
//
// Replaces (nas_3d_unet_tpu/ops/pallas/groupnorm.py, the fused GroupNorm
// of the use_pallas path):
//   K3 apply group_norm_apply_{f32,bf16} <- _lane_affine (:124, body
//       _affine_kernel :70): y = x*s + t per (batch, channel), optional
//       ReLU, rounded once to the element type;
//   K3 dx group_norm_dx_{f32,bf16}       <- _lane_dx (:144, body _dx_kernel
//       :78): dx = A*g + B*x + C per (batch, channel), g masked by y > 0
//       when the ReLU was fused, rounded once.
// K3's two reductions (Σx, Σx² and Σg, Σg·x) are K5a and K5b (stats.cu).
// s, t, A, B, C are (batch, channel) fp32 vectors the caller folds from
// those sums.
//
// What bounds them on the H100: bytes.  Each element costs 2 (apply) or 5
// (dx) flops for 4-12 bytes moved, far below the 20 flop/B balance of
// fp32, so the floor is the tensors' bytes over 3.35 TB/s.
//
// What the design does about it: the TPU kernels pack 128/C voxels into
// each 128-lane row so per-channel vectors line up with the lanes.  Here a
// thread takes 8 consecutive elements of one voxel row (channels c..c+7,
// C a multiple of 8) as 16- or 32-byte vector loads and stores, and reads
// its 8 channels' coefficients once, so a warp moves 512 contiguous bytes
// (bf16) per access and no element needs a division.  Other channel
// counts, or tensors not 16-byte aligned, take a scalar variant of the
// same kernel.  A 2D grid puts the batch item on blockIdx.y; blocks stride
// over the item's elements.  Simple first: no shared memory, no
// persistence.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using nas3d::load_f32;
using nas3d::store_rounded;

constexpr int kThreads = 256;
constexpr int kVec = 8;
constexpr int kBlocksPerItem = 132 * 4;   // SMs x blocks in flight, / batch

// 8 consecutive elements widened to fp32
__device__ __forceinline__ void load8(const float* p, float v[kVec]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[kVec]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 8 fp32 values rounded once to the element type and stored together
__device__ __forceinline__ void store8(float* p, const float v[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[kVec]) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i]));
    const unsigned hi =
        __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1]));
    w[i] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// y[b, v, c] = relu?(x * s[b, c] + t[b, c]); n = V * C elements per item.
// VEC: a thread covers 8 consecutive elements (C % 8 == 0, 16-byte
// aligned); else one element per step.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const T* __restrict__ x, const float* __restrict__ s,
             const float* __restrict__ t, T* __restrict__ y, long long n,
             int C, int relu) {
  const int b = blockIdx.y;
  const T* xb = x + (size_t)b * n;
  T* yb = y + (size_t)b * n;
  const float* sb = s + (size_t)b * C;
  const float* tb = t + (size_t)b * C;
  const long long step = (long long)gridDim.x * kThreads;
  if constexpr (VEC) {
    for (long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) *
                       kVec; i < n; i += step * kVec) {
      const int c = (int)(i % C);
      float v[kVec], sv[kVec], tv[kVec];
      load8(xb + i, v);
      load8(sb + c, sv);
      load8(tb + c, tv);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        v[k] = fmaf(v[k], sv[k], tv[k]);
        if (relu) v[k] = fmaxf(v[k], 0.f);
      }
      store8(yb + i, v);
    }
  } else {
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
         i += step) {
      const int c = (int)(i % C);
      float v = fmaf(load_f32(xb + i), __ldg(sb + c), __ldg(tb + c));
      if (relu) v = fmaxf(v, 0.f);
      store_rounded(yb + i, v);
    }
  }
}

// dx = a*g' + bx*x + c, g' = g where y > 0 (MASK) else g; coefficients
// (B, C) fp32.
template <typename T, bool VEC, bool MASK>
__global__ void __launch_bounds__(kThreads)
dx_kernel(const T* __restrict__ g, const T* __restrict__ x,
          const T* __restrict__ y, const float* __restrict__ a,
          const float* __restrict__ bx, const float* __restrict__ c0,
          T* __restrict__ dx, long long n, int C) {
  const int b = blockIdx.y;
  const size_t off = (size_t)b * n;
  const float* ab = a + (size_t)b * C;
  const float* bb = bx + (size_t)b * C;
  const float* cb = c0 + (size_t)b * C;
  const long long step = (long long)gridDim.x * kThreads;
  if constexpr (VEC) {
    for (long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) *
                       kVec; i < n; i += step * kVec) {
      const int c = (int)(i % C);
      float gv[kVec], xv[kVec], av[kVec], bv[kVec], cv[kVec];
      load8(g + off + i, gv);
      load8(x + off + i, xv);
      load8(ab + c, av);
      load8(bb + c, bv);
      load8(cb + c, cv);
      if constexpr (MASK) {
        float yv[kVec];
        load8(y + off + i, yv);
#pragma unroll
        for (int k = 0; k < kVec; ++k)
          if (!(yv[k] > 0.f)) gv[k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < kVec; ++k)
        gv[k] = av[k] * gv[k] + bv[k] * xv[k] + cv[k];
      store8(dx + off + i, gv);
    }
  } else {
    for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
         i += step) {
      const int c = (int)(i % C);
      float gv = load_f32(g + off + i);
      if constexpr (MASK)
        if (!(load_f32(y + off + i) > 0.f)) gv = 0.f;
      store_rounded(dx + off + i, __ldg(ab + c) * gv +
                                      __ldg(bb + c) * load_f32(x + off + i) +
                                      __ldg(cb + c));
    }
  }
}

dim3 grid_for(int B, long long n, bool vec) {
  const long long per = vec ? (long long)kThreads * kVec : kThreads;
  long long blocks = (n + per - 1) / per;
  const long long cap = (kBlocksPerItem + B - 1) / B;
  if (blocks > cap) blocks = cap;
  return dim3((unsigned)(blocks > 0 ? blocks : 1), B);
}

}  // namespace

extern "C" {

// K3 apply: x, y (B, V, C) in the element type, s, t (B, C) fp32; vec
// nonzero takes the 8-wide variant (C % 8 == 0, all pointers 16-byte
// aligned: the caller checks).
#define NAS3D_APPLY(NAME, T)                                                  \
  int NAME(const T* x, const float* s, const float* t, T* y, int B, int V,    \
           int C, int relu, int vec, void* stream) {                          \
    const long long n = (long long)V * C;                                     \
    const dim3 grid = grid_for(B, n, vec);                                    \
    if (vec)                                                                  \
      apply_kernel<T, true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(     \
          x, s, t, y, n, C, relu);                                            \
    else                                                                      \
      apply_kernel<T, false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(    \
          x, s, t, y, n, C, relu);                                            \
    return (int)cudaGetLastError();                                           \
  }
NAS3D_APPLY(group_norm_apply_f32, float)
NAS3D_APPLY(group_norm_apply_bf16, __nv_bfloat16)
#undef NAS3D_APPLY

// K3 dx: g, x, y, dx (B, V, C) in the element type (y read only with
// relu), a, b, c (B, C) fp32.
#define NAS3D_DX(NAME, T)                                                     \
  int NAME(const T* g, const T* x, const T* y, const float* a,                \
           const float* b, const float* c, T* dx, int B, int V, int C,        \
           int relu, int vec, void* stream) {                                 \
    const long long n = (long long)V * C;                                     \
    const dim3 grid = grid_for(B, n, vec);                                    \
    cudaStream_t st = (cudaStream_t)stream;                                   \
    if (vec && relu)                                                          \
      dx_kernel<T, true, true><<<grid, kThreads, 0, st>>>(g, x, y, a, b, c,   \
                                                          dx, n, C);          \
    else if (vec)                                                             \
      dx_kernel<T, true, false><<<grid, kThreads, 0, st>>>(g, x, y, a, b, c,  \
                                                           dx, n, C);         \
    else if (relu)                                                            \
      dx_kernel<T, false, true><<<grid, kThreads, 0, st>>>(g, x, y, a, b, c,  \
                                                           dx, n, C);         \
    else                                                                      \
      dx_kernel<T, false, false><<<grid, kThreads, 0, st>>>(g, x, y, a, b, c, \
                                                            dx, n, C);        \
    return (int)cudaGetLastError();                                           \
  }
NAS3D_DX(group_norm_dx_f32, float)
NAS3D_DX(group_norm_dx_bf16, __nv_bfloat16)
#undef NAS3D_DX

}  // extern "C"
