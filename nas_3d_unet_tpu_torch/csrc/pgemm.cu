// GEMM-with-moments kernels for the stride-1 ConvNormAct convs, fp32 or
// bf16 elements with fp32 accumulation.
//
// Replaces (nas_3d_unet_tpu/ops/pallas/pgemm.py):
//   K1 conv3x3x3_stats_{f32,bf16} <- conv_pgemm (:174, body _kernel :74)
//      with its GroupNorm-moments epilogue: stride-1 3^3 SAME conv,
//      dilation 1 or 2.
//   K1-dx conv3x3x3_{f32,bf16}    <- the same conv_pgemm with
//      with_stats=False, as _pg_stats_fn's backward runs it for dx
//      (ops/packed.py:491-504): the conv of dy with the flip-transposed
//      kernel.  The epilogue and the moments reduce are compiled out.
//   K2 gemm_stats_{f32,bf16}      <- gemm_stats (:311, body _gemm_kernel
//      :287): y = x @ W over voxel rows (the 1^3 conv), same epilogue.
// The moments are per-(batch, channel) sums of y and y^2, which GroupNorm
// folds into mean and variance without another pass over y.  In bf16 they
// are fp32 sums of the ROUNDED y, as the reference's are (packed.py:408).
//
// What bounds them on the H100: in fp32 the tensor cores (bf16/TF32) are
// off limits and the ceiling is the 67 TFLOP/s of fp32 FMA against 3.35
// TB/s (balance ~20 flop/B).  K1 is compute-bound: a 3^3 conv does 54*Cin
// flops per output value (16->16: 216 flop/B in fp32).  K2 straddles the
// balance: a voxel row does 2*K*N flops for (K+N)*4 bytes, 6 flop/B at
// 48->16 up to 38 at 192->128.  In bf16 the bound is the tensor cores' 989
// TFLOP/s and half the bytes; this version still widens bf16 to fp32 and
// runs the same FMA tiling, so it is far from that bound (wgmma is later
// work): bf16 here halves the bytes moved, not the FMA count.
//
// What the design does about it: one implicit-GEMM kernel for both,
//   Y[m, n] = sum_k A[m, k] * Wt[k, n],  k = tap * Cin + ci,
// where A is gathered on the fly from NDHWC x (K1, zero outside the volume)
// or read directly (K2), and Wt is the DHWIO kernel read as (27*Cin, Cout).
// Flattening (tap, ci) into one K axis keeps the 4-channel stem as dense as
// the 128-channel bottleneck.  A block computes a BM x BN tile of Y with 256
// threads, each holding an 8x4 register tile (8x2 at BN=16), from 8-deep K
// slices double-buffered in shared memory: the next slice's global loads
// are in flight in registers while the current one is multiplied.  BN
// follows Cout (16/32/64) so narrow layers waste no columns.  The epilogue
// writes y and reduces the tile's column sums in a fixed order into
// per-block partials; a second kernel sums the partials in double, in a
// fixed order, so the moments are the same bits run to run (no atomics).
// For the bandwidth-bound K2 shapes the fused epilogue is the gain: the
// plain version reads y twice more for its moments.  Simple first: no cp.async/TMA, no wgmma (later PRs, with bf16).

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using nas3d::load_f32;
using nas3d::store_rounded;

constexpr int kThreads = 256;
constexpr int kBK = 8;   // K slice staged per iteration
constexpr int kTM = 8;   // rows of Y per thread

struct ConvGeom {
  int D, H, W, Cin, dil;
};

// columns of Y per thread: 2 at BN=16 keeps the block at 256 rows (8 A
// values staged per thread, not 16), which holds registers under the
// 2-blocks-per-SM bound
__host__ __device__ constexpr int tile_n(int bn) { return bn == 16 ? 2 : 4; }

__host__ __device__ constexpr int row_block(int bn) {
  return kThreads * kTM * tile_n(bn) / bn;
}

int pick_bn(int n) {
  if (n % 64 == 0) return 64;
  if (n % 32 == 0) return 32;
  return 16;
}

// CONV: rows = D*H*W voxels of one batch item, K = 27*Cin, A gathered from x
//       with SAME zero padding (pad = dil on both sides, stride 1).
// GEMM: rows = V voxel rows of one batch item, A = x[b] as (V, K).
// partial: (B, gridDim.x, 2, N) per-block column sums of y and y^2 (STATS
//          only; unused otherwise).
// T: float or __nv_bfloat16 for x, w and y; shared memory and the
//    accumulators are fp32 either way.
//
// Pipeline: shared memory holds two K slices; while the block multiplies
// slice i, each thread's global loads for slice i+1 are already in flight
// into registers, and land in the other buffer after the FMAs.
template <int BN, bool CONV, typename T, bool STATS>
__global__ void __launch_bounds__(kThreads, 2)
gemm_moments_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    T* __restrict__ y, float* __restrict__ partial,
                    int rows, int K, int N, ConvGeom g) {
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

  const T* xb = x + (size_t)b * rows * (CONV ? g.Cin : K);

  // staged rows: CONV packs (d, h, w) into 10-bit fields, GEMM keeps m;
  // -1 marks a row past the end (the ragged tail), which stages zeros
  int rc[LR];
#pragma unroll
  for (int i = 0; i < LR; ++i) {
    const int m = m0 + r_base + RSTEP * i;
    if (m >= rows) {
      rc[i] = -1;
    } else if constexpr (CONV) {
      const int hw = g.H * g.W;
      const int d = m / hw;
      const int rem = m - d * hw;
      const int h = rem / g.W;
      rc[i] = (d << 20) | (h << 10) | (rem - h * g.W);
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
        od = (tap / 9 - 1) * g.dil;
        oh = ((tap / 3) % 3 - 1) * g.dil;
        ow = (tap % 3 - 1) * g.dil;
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

  // epilogue: store y (rounded once to T), then this tile's column sums of
  // the rounded values in a fixed order
  float c1[TN], c2[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) c1[j] = c2[j] = 0.f;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + ty * kTM + i;
    if (m >= rows) continue;
    T* yrow = y + ((size_t)b * rows + m) * N;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < N) {
        const float v = store_rounded(yrow + n, acc[i][j]);
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

// s1/s2[b, n] = sum over blocks of partial[b, :, 0/1, n]; one block per
// (n, b, moment), double accumulation, fixed-order tree -> deterministic.
__global__ void __launch_bounds__(256)
moments_reduce_kernel(const float* __restrict__ partial, float* __restrict__ s1,
                      float* __restrict__ s2, int nblk, int N) {
  const int n = blockIdx.x, b = blockIdx.y, s = blockIdx.z;
  double t = 0.0;
  for (int i = threadIdx.x; i < nblk; i += blockDim.x)
    t += partial[(((size_t)b * nblk + i) * 2 + s) * N + n];
  __shared__ double sh[256];
  sh[threadIdx.x] = t;
  __syncthreads();
  for (int off = 128; off > 0; off >>= 1) {
    if (threadIdx.x < off) sh[threadIdx.x] += sh[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) (s ? s2 : s1)[(size_t)b * N + n] = (float)sh[0];
}

// STATS: also sum the per-block partials into s1/s2; otherwise partial, s1
// and s2 are unused (may be null)
template <bool CONV, bool STATS, typename T>
int launch(const T* x, const T* w, T* y, float* partial, float* s1, float* s2,
           int B, int rows, int K, int N, ConvGeom g, cudaStream_t st) {
  const int bn = pick_bn(N);
  const dim3 grid((rows + row_block(bn) - 1) / row_block(bn),
                  (N + bn - 1) / bn, B);
  switch (bn) {
    case 64:
      gemm_moments_kernel<64, CONV, T, STATS><<<grid, kThreads, 0, st>>>(
          x, w, y, partial, rows, K, N, g);
      break;
    case 32:
      gemm_moments_kernel<32, CONV, T, STATS><<<grid, kThreads, 0, st>>>(
          x, w, y, partial, rows, K, N, g);
      break;
    default:
      gemm_moments_kernel<16, CONV, T, STATS><<<grid, kThreads, 0, st>>>(
          x, w, y, partial, rows, K, N, g);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !STATS) return (int)err;
  moments_reduce_kernel<<<dim3(N, B, 2), 256, 0, st>>>(partial, s1, s2,
                                                       (int)grid.x, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of Y per block for an output width n; the caller sizes `partial`
// as (B, ceil(rows / pgemm_row_block(n)), 2, n) fp32.
int pgemm_row_block(int n) { return row_block(pick_bn(n)); }

// K1: x (B, D, H, W, Cin), w (3, 3, 3, Cin, Cout), y (B, D, H, W, Cout) in
// the element type; s1/s2 (B, Cout) fp32; all contiguous, on the device of
// `stream`.
#define NAS3D_CONV(NAME, T, STATS)                                            \
  int NAME(const T* x, const T* w, T* y, float* partial, float* s1,           \
           float* s2, int B, int D, int H, int W, int Cin, int Cout, int dil, \
           void* stream) {                                                    \
    const ConvGeom g{D, H, W, Cin, dil};                                      \
    return launch<true, STATS>(x, w, y, partial, s1, s2, B, D * H * W,        \
                               27 * Cin, Cout, g, (cudaStream_t)stream);      \
  }
NAS3D_CONV(conv3x3x3_stats_f32, float, true)
NAS3D_CONV(conv3x3x3_stats_bf16, __nv_bfloat16, true)
// K1-dx: the same conv without the moments (partial, s1, s2 unused)
NAS3D_CONV(conv3x3x3_f32, float, false)
NAS3D_CONV(conv3x3x3_bf16, __nv_bfloat16, false)
#undef NAS3D_CONV

// K2: x (B, V, K), w (K, N), y (B, V, N) in the element type; s1/s2 (B, N)
// fp32.
#define NAS3D_GEMM(NAME, T)                                                   \
  int NAME(const T* x, const T* w, T* y, float* partial, float* s1,           \
           float* s2, int B, int V, int K, int N, void* stream) {             \
    const ConvGeom g{0, 0, 0, 0, 0};                                          \
    return launch<false, true>(x, w, y, partial, s1, s2, B, V, K, N, g,       \
                               (cudaStream_t)stream);                         \
  }
NAS3D_GEMM(gemm_stats_f32, float)
NAS3D_GEMM(gemm_stats_bf16, __nv_bfloat16)
#undef NAS3D_GEMM

}  // extern "C"
