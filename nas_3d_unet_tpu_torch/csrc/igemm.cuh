// The implicit-GEMM kernel template behind the package's last fp32 GEMM
// on the old FMA design: K4 fp32 (conv3d.cu conv_transpose2x_f32, the
// depth-to-space store), its only user.  K2 and K7 in fp32 run on the
// voxel-row FMA tile, gemm_fma.cuh; the fp32 3^3 convs (K1, K1-dx, K6) on
// the FMA conv tile, conv_fma.cuh; every bf16 kernel on the tensor cores
// (conv_mma.cuh, gemm_mma.cuh).  K4 fp32 is queued next for a tile of its
// own, after which this file goes.
//
// Replaces (nas_3d_unet_tpu/ops/pallas/), in fp32: conv3d.py:356
// conv_transpose2x (K4).
//
// What bounds it on the H100: the bytes.  In fp32 the tensor cores
// (bf16/TF32) are off limits and the ceiling is the 67 TFLOP/s of fp32 FMA
// against 3.35 TB/s (balance ~20 flop/B); a voxel row does 2*Cin*8*Cout
// flops for (Cin + 8*Cout) * 4 bytes, most of them the output.
//
// What the design does about it:
//   Y[m, n] = sum_k X[m, k] * W[k, n]
// over the voxel rows of x, with N = 8*Cout.  A block computes a BM x BN
// tile of Y with 256 threads, each holding an 8x4 register tile (8x2 at
// BN=16), from 8-deep K slices double-buffered in shared memory: the next
// slice's global loads are in flight in registers while the current one is
// multiplied.  BN follows N (16/32/64).  The store writes each row's
// columns depth-to-space, so the 8x larger output is written once and
// never permuted; a bias/ReLU step (EPI) is compiled in only for a call
// that asks for it.  Simple first: no cp.async/TMA, no tensor cores.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

// Internal linkage: each source that includes this gets its own kernels,
// so the two sources' instantiations never meet at link time.
namespace {

using nas3d::load_f32;
using nas3d::store_rounded;

constexpr int kThreads = 256;
constexpr int kBK = 8;   // K slice staged per iteration
constexpr int kTM = 8;   // rows of Y per thread

// the input volume (D, H, W) whose voxels are the rows
struct ConvGeom {
  int D, H, W;
};

// columns of Y per thread: 2 at BN=16 keeps the block at 256 rows (8 A
// values staged per thread, not 16), which holds registers under the
// 2-blocks-per-SM bound
__host__ __device__ constexpr int tile_n(int bn) { return bn == 16 ? 2 : 4; }

__host__ __device__ constexpr int row_block(int bn) {
  return kThreads * kTM * tile_n(bn) / bn;
}

inline int pick_bn(int n) {
  if (n % 64 == 0) return 64;
  if (n % 32 == 0) return 32;
  return 16;
}

// rows = D*H*W voxel rows of one batch item, A = x[b] as (rows, K); N =
//   8*Cout; column n = (kd*4 + kh*2 + kw)*Cout + co of row (d, h, w) is
//   stored at (2d+kd, 2h+kh, 2w+kw, co) of the (2D, 2H, 2W, Cout) output.
// EPI: adds bias (N,) fp32 (or none if null) to the fp32 sum and clamps at
//   0 if relu, before the rounding; without EPI both are ignored.
// T: the element type of x, w and y (only float is instantiated); shared
//    memory and the accumulators are fp32.
//
// Pipeline: shared memory holds two K slices; while the block multiplies
// slice i, each thread's global loads for slice i+1 are already in flight
// into registers, and land in the other buffer after the FMAs.
template <int BN, typename T, bool EPI>
__global__ void __launch_bounds__(kThreads, 2)
gemm_moments_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ bias, T* __restrict__ y,
                    int rows, int K, int N, int relu, ConvGeom g) {
  constexpr int TN = tile_n(BN);
  constexpr int BM = row_block(BN);
  constexpr int TX = BN / TN;               // threads along N
  constexpr int LR = BM * kBK / kThreads;   // A rows each thread stages
  constexpr int RSTEP = kThreads / kBK;     // 32: row stride between them
  constexpr int LB = (kBK * BN + kThreads - 1) / kThreads;  // B per thread
  // +4 floats per As row: the 8 K-lanes of a warp's stores land in 8
  // distinct bank quads, and rows stay 16-byte aligned for float4 reads
  __shared__ __align__(16) float As[2][kBK][BM + 4];
  __shared__ __align__(16) float Bs[2][kBK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int kk = tid % kBK;                 // this thread's K lane when staging
  const int r_base = tid / kBK;

  const T* xb = x + (size_t)b * rows * K;

  // staged rows, or -1 for a row past the end (the ragged tail), which
  // stages zeros
  int rc[LR];
#pragma unroll
  for (int i = 0; i < LR; ++i) {
    const int m = m0 + r_base + RSTEP * i;
    rc[i] = m >= rows ? -1 : m;
  }

  float a_reg[LR], b_reg[LB];
  // global -> registers for the K slice starting at k0
  auto load = [&](int k0) {
    const int k = k0 + kk;
#pragma unroll
    for (int i = 0; i < LR; ++i) {
      const int p = rc[i];
      a_reg[i] = (k < K && p >= 0) ? load_f32(xb + (size_t)p * K + k) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < LB; ++i) {
      const int e = tid + i * kThreads;
      const int kg = k0 + e / BN, ng = n0 + e % BN;
      b_reg[i] = (e < kBK * BN && kg < K && ng < N)
                     ? load_f32(w + (size_t)kg * N + ng) : 0.f;
    }
  };
  // registers -> shared buffer `s`
  auto stage = [&](int s) {
#pragma unroll
    for (int i = 0; i < LR; ++i) As[s][kk][r_base + RSTEP * i] = a_reg[i];
#pragma unroll
    for (int i = 0; i < LB; ++i) {
      const int e = tid + i * kThreads;
      if (e < kBK * BN) Bs[s][e / BN][e % BN] = b_reg[i];
    }
  };

  float acc[kTM][TN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  load(0);
  stage(0);
  __syncthreads();
  int s = 0;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    const bool more = k0 + kBK < K;
    if (more) load(k0 + kBK);
#pragma unroll
    for (int q = 0; q < kBK; ++q) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[s][q][ty * kTM]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[s][q][ty * kTM + 4]);
      const float a[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float bb[TN];
      if constexpr (TN == 4) {
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[s][q][tx * 4]);
        bb[0] = bv.x; bb[1] = bv.y; bb[2] = bv.z; bb[3] = bv.w;
      } else {
        const float2 bv = *reinterpret_cast<const float2*>(&Bs[s][q][tx * 2]);
        bb[0] = bv.x; bb[1] = bv.y;
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    if (more) stage(s ^ 1);
    __syncthreads();
    s ^= 1;
  }

  // epilogue: (EPI) bias and ReLU in fp32, store y (rounded once to T)
  // depth-to-space
  float bv[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int n = n0 + tx * TN + j;
    bv[j] = (EPI && bias != nullptr && n < N) ? __ldg(bias + n) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + ty * kTM + i;
    if (m >= rows) continue;
    // the row's (2d, 2h, 2w) output corner; columns add their offset
    const int hw = g.H * g.W;
    const int d = m / hw;
    const int rem = m - d * hw;
    const int h = rem / g.W;
    T* const yrow =
        y + ((((size_t)b * 2 * g.D + 2 * d) * 2 * g.H + 2 * h) * 2 * g.W +
             2 * (rem - h * g.W)) * (N / 8);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < N) {
        float a = acc[i][j];
        if constexpr (EPI) {
          if (bias != nullptr) a += bv[j];
          if (relu) a = fmaxf(a, 0.f);
        }
        const int cout = N / 8;
        const int tap = n / cout;
        const size_t off = ((((size_t)(tap >> 2) * 2 * g.H +
                              ((tap >> 1) & 1)) * 2 * g.W) + (tap & 1)) *
                               cout + (n - tap * cout);
        store_rounded(yrow + off, a);
      }
    }
  }
}

// Launch over B batch items of `rows` input voxels each; returns the
// launch's cudaError_t.
template <bool EPI, typename T>
int launch_gemm(const T* x, const T* w, const float* bias, T* y, int B,
                int rows, int K, int N, int relu, ConvGeom g,
                cudaStream_t st) {
  const int bn = pick_bn(N);
  const dim3 grid((rows + row_block(bn) - 1) / row_block(bn),
                  (N + bn - 1) / bn, B);
  switch (bn) {
    case 64:
      gemm_moments_kernel<64, T, EPI><<<grid, kThreads, 0, st>>>(
          x, w, bias, y, rows, K, N, relu, g);
      break;
    case 32:
      gemm_moments_kernel<32, T, EPI><<<grid, kThreads, 0, st>>>(
          x, w, bias, y, rows, K, N, relu, g);
      break;
    default:
      gemm_moments_kernel<16, T, EPI><<<grid, kThreads, 0, st>>>(
          x, w, bias, y, rows, K, N, relu, g);
  }
  return (int)cudaGetLastError();
}

}  // namespace
