// The implicit-GEMM kernel template behind the package's conv and GEMM
// kernels on the FMA units, fp32 or bf16 elements with fp32 accumulation:
// in fp32 (serving) K1, K1-dx and K2 (pgemm.cu) and K6, K7 and K4
// (conv3d.cu); in bf16 (training) K7 and K4 only.  The other bf16 kernels
// run on the tensor cores: the 3^3 convs K1, K1-dx and K6 on conv_mma.cuh,
// K2 on gemm_mma.cuh.
//
// Replaces (nas_3d_unet_tpu/ops/pallas/): pgemm.py:174 conv_pgemm (K1,
// with and without its moments: K1-dx) and :311 gemm_stats (K2) in fp32;
// conv3d.py:201 conv3d (K6) in fp32, :279 pointwise_conv (K7) and :356
// conv_transpose2x (K4) in both types.
//
// What bounds them on the H100: in fp32 the tensor cores (bf16/TF32) are
// off limits and the ceiling is the 67 TFLOP/s of fp32 FMA against 3.35
// TB/s (balance ~20 flop/B).  The 3^3 convs (K1, K6) are compute-bound: a
// 3^3 conv does 54*Cin flops per output value (16->16: 216 flop/B in
// fp32).  The GEMMs (K2, K7, K4) straddle the balance: a voxel row does
// 2*K*N flops for (K+N)*4 bytes, 6 flop/B at 48->16 up to 38 at 192->128.
// In bf16 the bound is the tensor cores' 989 TFLOP/s and half the bytes;
// the bf16 users left on this template (K7, K4: bytes-bound GEMMs) still
// widen bf16 to fp32 and run the same FMA tiling, so they are far from
// that bound: bf16 here halves the bytes moved, not the FMA count
// (gemm_mma.cuh's tensor-core tile is their next home).
//
// What the design does about it: one implicit-GEMM kernel for all,
//   Y[m, n] = sum_k A[m, k] * Wt[k, n],  k = tap * Cin + ci,
// where A is gathered on the fly from NDHWC x (the 3^3 convs, zero outside
// the volume) or read directly (the GEMMs), and Wt is the DHWIO kernel
// read as (27*Cin, Cout).  Flattening (tap, ci) into one K axis keeps the
// 4-channel stem as dense as the 128-channel bottleneck.  A block computes
// a BM x BN tile of Y with 256 threads, each holding an 8x4 register tile
// (8x2 at BN=16), from 8-deep K slices double-buffered in shared memory:
// the next slice's global loads are in flight in registers while the
// current one is multiplied.  BN follows N (16/32/64) so narrow layers
// waste no columns.  The epilogue rounds y once to the element type and
// stores it, then reduces the tile's column sums in a fixed order into
// per-block partials (the moments; the caller sums the partials in a
// fixed order, so they are the same bits run to run, no atomics).  What
// varies by caller is compiled in or out by template flags, so K1's and
// K2's code is not burdened by K6's: the gather (stride 1 with pad = dil,
// or any stride with lax's low-side pads), the store (rows, or the 2^3
// output block of each voxel for K4), the moments, and a bias/ReLU step.
// Simple first: no cp.async/TMA, no tensor cores (conv_mma.cuh and
// gemm_mma.cuh have them for bf16; the fp32 path is held to TF32-off
// numbers, so it stays on the FMA units).
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

// How A is read and Y written (the template's LAYOUT):
constexpr int kGemm = 0;     // A = x[b] as (rows, K); Y stored as rows
constexpr int kConvS1 = 1;   // A gathered, stride 1, pad = dil (K1; fp32
                             // K1-dx and K6)
constexpr int kConv = 2;     // A gathered, g's stride and low pads (fp32 K6)
constexpr int kGemmD2S = 3;  // A as rows; Y stored depth-to-space (K4)

// kConvS1/kConv: input volume (D, H, W) x Cin and dilation; kConv also
//   the stride, the low-side pads and the output plane (Ho, Wo): rows are
//   (Do, Ho, Wo) output voxels.
// kGemmD2S: (D, H, W) is the input volume whose voxels are the rows.
struct ConvGeom {
  int D, H, W, Cin, dil;
  int stride, pd, ph, pw, Ho, Wo;
};

// kConv: offset added to each row coordinate so that o * stride - pad +
// tap * dil (>= -2) stays non-negative in its 10-bit field.
constexpr int kCoordBias = 2;

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

// kConvS1/kConv: rows = output voxels of one batch item, K = 27*Cin, A
//   gathered from x with SAME zero padding.
// kGemm: rows = V voxel rows of one batch item, A = x[b] as (V, K).
// kGemmD2S: N = 8*Cout; column n = (kd*4 + kh*2 + kw)*Cout + co of row
//   (d, h, w) is stored at (2d+kd, 2h+kh, 2w+kw, co) of the (2D, 2H, 2W,
//   Cout) output.
// EPI: adds bias (N,) fp32 (or none if null) to the fp32 sum and clamps at
//   0 if relu, before the rounding; without EPI both are ignored.
// partial: (B, gridDim.x, 2, N) per-block column sums of y and y^2 (STATS
//          only; unused otherwise).
// T: float or __nv_bfloat16 for x, w and y; shared memory and the
//    accumulators are fp32 either way.
//
// Pipeline: shared memory holds two K slices; while the block multiplies
// slice i, each thread's global loads for slice i+1 are already in flight
// into registers, and land in the other buffer after the FMAs.
template <int BN, int LAYOUT, typename T, bool STATS, bool EPI>
__global__ void __launch_bounds__(kThreads, 2)
gemm_moments_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ bias, T* __restrict__ y,
                    float* __restrict__ partial, int rows, int K, int N,
                    int relu, ConvGeom g) {
  constexpr bool CONV = LAYOUT == kConvS1 || LAYOUT == kConv;
  constexpr int TN = tile_n(BN);
  constexpr int BM = row_block(BN);
  constexpr int TX = BN / TN;               // threads along N
  constexpr int TY = kThreads / TX;         // threads along M (= BM / kTM)
  constexpr int LR = BM * kBK / kThreads;   // A rows each thread stages
  constexpr int RSTEP = kThreads / kBK;     // 32: row stride between them
  constexpr int LB = (kBK * BN + kThreads - 1) / kThreads;  // B per thread
  // +4 floats per As row: the 8 K-lanes of a warp's stores land in 8
  // distinct bank quads, and rows stay 16-byte aligned for float4 reads
  __shared__ __align__(16) float As[2][kBK][BM + 4];
  __shared__ __align__(16) float Bs[2][kBK][BN];
  __shared__ float red[2][TY][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int kk = tid % kBK;                 // this thread's K lane when staging
  const int r_base = tid / kBK;

  const T* xb = x + (size_t)b * (LAYOUT == kConv
                                     ? (size_t)g.D * g.H * g.W * g.Cin
                                     : (size_t)rows * (CONV ? g.Cin : K));

  // staged rows: kConvS1 packs the output voxel (d, h, w) into 10-bit
  // fields, kConv its input corner (o * stride + kCoordBias per axis),
  // the GEMMs keep m; -1 marks a row past the end (the ragged tail), which
  // stages zeros
  int rc[LR];
#pragma unroll
  for (int i = 0; i < LR; ++i) {
    const int m = m0 + r_base + RSTEP * i;
    if (m >= rows) {
      rc[i] = -1;
    } else if constexpr (LAYOUT == kConvS1) {
      const int hw = g.H * g.W;
      const int d = m / hw;
      const int rem = m - d * hw;
      const int h = rem / g.W;
      rc[i] = (d << 20) | (h << 10) | (rem - h * g.W);
    } else if constexpr (LAYOUT == kConv) {
      const int hw = g.Ho * g.Wo;
      const int d = m / hw;
      const int rem = m - d * hw;
      const int h = rem / g.Wo;
      const int ww = rem - h * g.Wo;
      rc[i] = ((d * g.stride + kCoordBias) << 20) |
              ((h * g.stride + kCoordBias) << 10) |
              (ww * g.stride + kCoordBias);
    } else {
      rc[i] = m;
    }
  }

  float a_reg[LR], b_reg[LB];
  // global -> registers for the K slice starting at k0
  auto load = [&](int k0) {
    const int k = k0 + kk;
    if constexpr (CONV) {
      int od = 0, oh = 0, ow = 0, ci = 0;
      const bool kval = k < K;
      if (kval) {
        const int tap = k / g.Cin;
        ci = k - tap * g.Cin;
        if constexpr (LAYOUT == kConvS1) {
          od = (tap / 9 - 1) * g.dil;
          oh = ((tap / 3) % 3 - 1) * g.dil;
          ow = (tap % 3 - 1) * g.dil;
        } else {
          od = (tap / 9) * g.dil - g.pd - kCoordBias;
          oh = ((tap / 3) % 3) * g.dil - g.ph - kCoordBias;
          ow = (tap % 3) * g.dil - g.pw - kCoordBias;
        }
      }
#pragma unroll
      for (int i = 0; i < LR; ++i) {
        float v = 0.f;
        const int p = rc[i];
        if (kval && p >= 0) {
          const int d = (p >> 20) + od;
          const int h = ((p >> 10) & 1023) + oh;
          const int ww = (p & 1023) + ow;
          if (d >= 0 && d < g.D && h >= 0 && h < g.H && ww >= 0 && ww < g.W)
            v = load_f32(xb + (((size_t)d * g.H + h) * g.W + ww) * g.Cin +
                         ci);
        }
        a_reg[i] = v;
      }
    } else {
#pragma unroll
      for (int i = 0; i < LR; ++i) {
        const int p = rc[i];
        a_reg[i] = (k < K && p >= 0) ? load_f32(xb + (size_t)p * K + k)
                                     : 0.f;
      }
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

  // epilogue: (EPI) bias and ReLU in fp32, store y (rounded once to T),
  // then this tile's column sums of the rounded values in a fixed order
  float bv[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int n = n0 + tx * TN + j;
    bv[j] = (EPI && bias != nullptr && n < N) ? __ldg(bias + n) : 0.f;
  }
  float c1[TN], c2[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) c1[j] = c2[j] = 0.f;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + ty * kTM + i;
    if (m >= rows) continue;
    T* yrow;
    if constexpr (LAYOUT == kGemmD2S) {
      // the row's (2d, 2h, 2w) output corner; columns add their offset
      const int hw = g.H * g.W;
      const int d = m / hw;
      const int rem = m - d * hw;
      const int h = rem / g.W;
      yrow = y + ((((size_t)b * 2 * g.D + 2 * d) * 2 * g.H + 2 * h) * 2 * g.W +
                  2 * (rem - h * g.W)) * (N / 8);
    } else {
      yrow = y + ((size_t)b * rows + m) * N;
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < N) {
        float a = acc[i][j];
        if constexpr (EPI) {
          if (bias != nullptr) a += bv[j];
          if (relu) a = fmaxf(a, 0.f);
        }
        size_t off = n;
        if constexpr (LAYOUT == kGemmD2S) {
          const int cout = N / 8;
          const int tap = n / cout;
          off = ((((size_t)(tap >> 2) * 2 * g.H + ((tap >> 1) & 1)) * 2 *
                  g.W) + (tap & 1)) * cout + (n - tap * cout);
        }
        const float v = store_rounded(yrow + off, a);
        c1[j] += v;
        c2[j] += v * v;
      }
    }
  }
  if constexpr (STATS) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      red[0][ty][tx * TN + j] = c1[j];
      red[1][ty][tx * TN + j] = c2[j];
    }
    __syncthreads();
    if (tid < 2 * BN) {
      const int s2 = tid / BN, nc = tid % BN;
      float t = 0.f;
      for (int r = 0; r < TY; ++r) t += red[s2][r][nc];
      if (n0 + nc < N)
        partial[(((size_t)b * gridDim.x + blockIdx.x) * 2 + s2) * N + n0 +
                nc] = t;
    }
  }
}

// Launch over B batch items of `rows` rows each; returns the launch's
// cudaError_t.  The grid's x extent (row blocks) sizes `partial`.
template <int LAYOUT, bool STATS, bool EPI, typename T>
int launch_gemm(const T* x, const T* w, const float* bias, T* y,
                float* partial, int B, int rows, int K, int N, int relu,
                ConvGeom g, cudaStream_t st) {
  const int bn = pick_bn(N);
  const dim3 grid((rows + row_block(bn) - 1) / row_block(bn),
                  (N + bn - 1) / bn, B);
  switch (bn) {
    case 64:
      gemm_moments_kernel<64, LAYOUT, T, STATS, EPI>
          <<<grid, kThreads, 0, st>>>(x, w, bias, y, partial, rows, K, N,
                                      relu, g);
      break;
    case 32:
      gemm_moments_kernel<32, LAYOUT, T, STATS, EPI>
          <<<grid, kThreads, 0, st>>>(x, w, bias, y, partial, rows, K, N,
                                      relu, g);
      break;
    default:
      gemm_moments_kernel<16, LAYOUT, T, STATS, EPI>
          <<<grid, kThreads, 0, st>>>(x, w, bias, y, partial, rows, K, N,
                                      relu, g);
  }
  return (int)cudaGetLastError();
}

}  // namespace
