// The fp32 voxel-row GEMM on the FMA units, behind two kernels:
//   K2 fp32 (pgemm.cu gemm_stats_f32): y (B, V, N) = x (B, V, K) @ w (K,
//      N), with each tile's Σy and Σy² of the stored y (the GroupNorm
//      moments; flag STATS);
//   K7 fp32 (conv3d.cu pointwise_conv_f32): the same product with an fp32
//      bias added to the fp32 sum, then a ReLU (flag EPI).
// fp32 in, fp32 sums, fp32 y; no TF32.
//
// Replaces (nas_3d_unet_tpu/ops/pallas/), in fp32: pgemm.py:311
// gemm_stats (body _gemm_kernel :287, pallas_call :330) and conv3d.py:279
// pointwise_conv (body _pointwise_kernel :251, pallas_call :314).
//
// What bounds them on the H100: the bytes, at the shapes that matter.  A
// voxel row does 2*K*N flops for (K + N) * 4 bytes: 6 to 10 flop/B at 48
// -> 16 and 48 -> 32 over 128^3 (three quarters of K2's bound), 4 at K7's
// 16 -> 16, against the card's fp32 balance of ~20 (67 TFLOP/s of FMA
// against 3.35 TB/s).  Only 192 -> 128, 192 -> 64 and 384 -> 64, at 32^3
// and 16^3, lean on the FMA rate.  The FMA template these replace
// (igemm.cuh) staged 8-deep K slices through registers with scalar loads,
// one tile per block, and stored y one scalar at a time.
//
// What the design does about it (gemm_mma.cuh's skeleton, in FFMA):
//   - V is cut into tiles of BM rows; a block owns BN columns, BN = N
//     rounded up to 16/32/64/128, so at N <= 128 one block covers N and x
//     is read once (N > 128 takes ceil(N / 128) column blocks).  Each of
//     the 256 threads holds a TM x TN register tile: rows ty + i * TY (i <
//     TM) of the tile, columns tx * 4 .. + 3 (and BN / 2 + tx * 4 .. + 3 at
//     TN = 8).  BN 16: 4 x 4, BM 256; 32: 8 x 4, BM 256; 64: 4 x 8, BM 128;
//     128: 8 x 8, BM 128.
//   - The grid holds as many blocks as stay resident; each walks over its
//     tiles.  w is staged once per block (all of K; the plan refuses a w
//     that does not fit); x streams in K chunks of 16 through a ring of
//     2-4 stages by zero-filling 16-byte cp.async copies (rows past V,
//     columns past K or N read as zeros; a K or N not a multiple of 4, or
//     a misaligned base, takes 4-byte copies with the same padding).  The
//     copies run stages - 1 chunks ahead across tile boundaries, so the
//     next tile's x is in flight during this tile's FMAs and epilogue.
//     The plan takes the most stages (4 or 3) with which two blocks fit an
//     SM, else 4 (or fewer where w is large) with one.
//   - Inner loop, per pair of K: a thread reads TM float2 of x (its rows
//     are a stage row of 80 bytes apart: 8 consecutive rows fall in
//     distinct bank groups) and 2 x TN floats of w (16-byte vectors a warp
//     reads contiguously), for 2 x TM x TN FMAs: 2.7 FMAs a float read
//     from shared memory at 8 x 4 and 4 x 8, 4 at 8 x 8.
//   - The summation order is the template's: one fp32 accumulator per
//     output, fmaf over k in increasing order (the zero padding past K
//     adds +0), no split-K; then the bias, then the ReLU.  So y is the
//     same bits as igemm.cuh's.
//   - Epilogue: the tile's y goes to shared memory, then out as one run of
//     rows x N floats (the tile's rows are contiguous in y) in 16-byte
//     vectors, or scalars where N is not a multiple of 4; rows past V and
//     columns past N are not stored.  STATS: each thread sums its rows'
//     stored values (rows < V, columns < N) in row order, a butterfly of
//     __shfl_xor sums the warp's thread rows, and the 8 warps are summed
//     in order into one partial row per tile, (B, tiles, 2, N): the bits
//     depend on neither the grid nor the card.  pgemm.cu's
//     moments_reduce_kernel folds the partials in double.  No atomics.
//   - The host side queries the resident blocks and sets the shared-memory
//     attribute once per instantiation, device and K chunk count, so a
//     launch is the launch alone.
// Simple first: no TF32 or 3xTF32 (they would change the fp32 path's
// contract and its bound), no TMA.  ops/gemm_fma.py mirrors the plan and
// the algorithm in plain PyTorch.
#pragma once

#include <atomic>

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {
namespace gfma {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 16;              // K per x stage
constexpr int kLdX = kKC + 4;        // x stage row, floats: 80 bytes
constexpr int kSmemMax = 232448;     // 227 KB: the most a block may have
constexpr int kSmemTwoBlocks = 113 * 1024;   // two such blocks fit an SM

// --- the plan (host), mirrored by ops/gemm_fma.py:plan ---------------------

// a thread's columns and rows, and the tile's rows, for BN columns
__host__ __device__ constexpr int tile_n(int bn) { return bn >= 64 ? 8 : 4; }
__host__ __device__ constexpr int tile_m(int bn) {
  return bn == 32 || bn == 128 ? 8 : 4;
}
__host__ __device__ constexpr int tile_rows(int bn) {
  return kThreads / (bn / tile_n(bn)) * tile_m(bn);
}

struct Plan {
  int bn;         // columns per block
  int bm;         // rows per tile (one moments partial row each)
  int nchunks;    // K chunks of 16
  int stages;     // x stages in the ring
  size_t smem;    // bytes of shared memory per block
};

// w (all chunks), the x stages, the epilogue's y tile, then STATS' warp rows
inline size_t plan_smem(int bn, int nchunks, int stages, bool stats) {
  return ((size_t)nchunks * kKC * bn + (size_t)stages * tile_rows(bn) * kLdX +
          (size_t)tile_rows(bn) * bn + (stats ? kWarps * 2 * bn : 0)) *
         sizeof(float);
}

inline Plan make_plan(int k, int n, bool stats) {
  Plan p;
  p.bn = n <= 16 ? 16 : n <= 32 ? 32 : n <= 64 ? 64 : 128;
  p.bm = tile_rows(p.bn);
  p.nchunks = (k + kKC - 1) / kKC;
  p.stages = 0;
  for (int s = 4; s >= 3 && !p.stages; --s)
    if (plan_smem(p.bn, p.nchunks, s, stats) <= (size_t)kSmemTwoBlocks)
      p.stages = s;
  for (int s = 4; s >= 2 && !p.stages; --s)
    if (plan_smem(p.bn, p.nchunks, s, stats) <= (size_t)kSmemMax)
      p.stages = s;
  if (!p.stages) p.stages = 2;   // w does not fit: the launch refuses it
  p.smem = plan_smem(p.bn, p.nchunks, p.stages, stats);
  return p;
}

// tiles of V rows: the row count of K2's moments partials per batch item
inline int tiles(int v, int n) {
  const int bm = tile_rows(make_plan(1, n, true).bn);
  return (v + bm - 1) / bm;
}

struct Geom {
  int V, K, N;
  int nchunks, stages, ntiles;   // the plan's side
  int vec_x, vec_w, vec_y;       // 16-byte copies for x, w; 16-byte stores
  int relu;                      // EPI
};

// --- the kernel ------------------------------------------------------------

// Block (x, y, z) takes the tiles x, x + gridDim.x, ... of batch item z,
// columns [y * BN, y * BN + BN); its (tile, chunk) steps run through one
// ring of g.stages x stages, so copies run g.stages - 1 steps ahead across
// tile boundaries.  STATS: partial (B, ntiles, 2, N), one row per tile.
// EPI: bias (N,) fp32 or null, added before the ReLU (g.relu).  Registers
// for two blocks an SM (128 a thread), but at BN = 128, whose 8 x 8 tile
// would spill there and whose w and y tile keep one block an SM at the
// path's shapes (measured on the H100: 0.1167 against 0.1265 ms at 192 ->
// 128 over 32^3, no spill at 168 registers).
template <int BN, bool STATS, bool EPI>
__global__ void __launch_bounds__(kThreads, BN == 128 ? 1 : 2)
gemm_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ y,
                float* __restrict__ partial, const Geom g) {
  constexpr int TN = tile_n(BN), TM = tile_m(BN);
  constexpr int TX = BN / TN;           // threads along N
  constexpr int TY = kThreads / TX;     // thread rows
  constexpr int BM = TY * TM;
  using nas3d::cp_async16_zfill;
  using nas3d::cp_async4_zfill;
  extern __shared__ __align__(16) float smem[];
  float* const ws = smem;                              // K chunks x BN
  float* const xs0 = ws + g.nchunks * kKC * BN;        // stages x BM x kLdX
  float* const ytile = xs0 + g.stages * BM * kLdX;     // BM x BN
  float* const red = ytile + BM * BN;                  // kWarps x 2 x BN
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int n0 = blockIdx.y * BN, b = blockIdx.z;
  const float* const xb = x + (size_t)b * g.V * g.K;
  float* const yb = y + (size_t)b * g.V * g.N;
  const int nsteps =
      (g.ntiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x *
      g.nchunks;

  // w rows [0, 16 * nchunks) x columns [n0, n0 + BN), zero past K and N
  if (g.vec_w) {
    constexpr int VPR = BN / 4;
    for (int i = tid; i < g.nchunks * kKC * VPR; i += kThreads) {
      const int k = i / VPR, j = i - k * VPR, n = n0 + j * 4;
      const bool ok = k < g.K && n < g.N;
      cp_async16_zfill(ws + k * BN + j * 4, ok ? w + (size_t)k * g.N + n : w,
                       ok);
    }
  } else {
    for (int i = tid; i < g.nchunks * kKC * BN; i += kThreads) {
      const int k = i / BN, n = n0 + i - k * BN;
      const bool ok = k < g.K && n < g.N;
      cp_async4_zfill(ws + i, ok ? w + (size_t)k * g.N + n : w, ok);
    }
  }
  // step s: x rows of tile blockIdx.x + (s / nchunks) * gridDim.x, K chunk
  // s % nchunks, into stage s % stages, zero past V and K; one cp.async
  // group per step, empty past the last step
  auto load_step = [&](int s) {
    if (s < nsteps) {
      const int m0 = ((int)blockIdx.x + s / g.nchunks * (int)gridDim.x) * BM;
      const int k0 = s % g.nchunks * kKC;
      float* const xs = xs0 + s % g.stages * BM * kLdX;
      if (g.vec_x) {
        for (int i = tid; i < BM * (kKC / 4); i += kThreads) {
          const int r = i / (kKC / 4), kk = (i % (kKC / 4)) * 4;
          const bool ok = m0 + r < g.V && k0 + kk < g.K;
          cp_async16_zfill(xs + r * kLdX + kk,
                           ok ? xb + (size_t)(m0 + r) * g.K + k0 + kk : xb,
                           ok);
        }
      } else {
        for (int i = tid; i < BM * kKC; i += kThreads) {
          const int r = i / kKC, kk = i - r * kKC;
          const bool ok = m0 + r < g.V && k0 + kk < g.K;
          cp_async4_zfill(xs + r * kLdX + kk,
                          ok ? xb + (size_t)(m0 + r) * g.K + k0 + kk : xb,
                          ok);
        }
      }
    }
    nas3d::cp_async_commit();
  };

  float acc[TM][TN];
  for (int s = 0; s < g.stages - 1; ++s) load_step(s);   // w joins step 0
  for (int s = 0; s < nsteps; ++s) {
    // step s (and w) have landed: stages - 2 later groups may be in flight
    if (g.stages == 4)
      nas3d::cp_async_wait<2>();
    else if (g.stages == 3)
      nas3d::cp_async_wait<1>();
    else
      nas3d::cp_async_wait<0>();
    __syncthreads();   // ... for every thread; and every thread is done with
                       // step s - 1's stage and the last epilogue's tile
    load_step(s + g.stages - 1);
    const int c = s % g.nchunks;
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    }
    const float* const xs = xs0 + s % g.stages * BM * kLdX + ty * kLdX;
    const float* const wc = ws + c * kKC * BN + tx * 4;
#pragma unroll
    for (int kp = 0; kp < kKC; kp += 2) {
      float2 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float2*>(xs + i * TY * kLdX + kp);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float* const wr = wc + (kp + q) * BN;
        float bv[TN];
        const float4 b0 = *reinterpret_cast<const float4*>(wr);
        bv[0] = b0.x, bv[1] = b0.y, bv[2] = b0.z, bv[3] = b0.w;
        if constexpr (TN == 8) {
          const float4 b1 = *reinterpret_cast<const float4*>(wr + BN / 2);
          bv[4] = b1.x, bv[5] = b1.y, bv[6] = b1.z, bv[7] = b1.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float av = q ? a[i].y : a[i].x;
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    }
    if (c != g.nchunks - 1) continue;

    // epilogue of tile t: (EPI) bias and ReLU on the fp32 sums, the tile
    // into shared memory, (STATS) each thread's moments of its rows < V
    const int t = (int)blockIdx.x + s / g.nchunks * (int)gridDim.x;
    const int m0 = t * BM;
    const int nrows = min(BM, g.V - m0);
    float mom[2][TN];
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int col = h * (BN / 2) + tx * 4;   // its first of 4 columns
      float bv[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (EPI) {
        if (bias != nullptr) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (n0 + col + q < g.N) bv[q] = __ldg(bias + n0 + col + q);
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) mom[0][h * 4 + q] = mom[1][h * 4 + q] = 0.f;
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = ty + i * TY;
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          v[q] = acc[i][h * 4 + q];
          if constexpr (EPI) {
            if (bias != nullptr) v[q] += bv[q];
            if (g.relu) v[q] = fmaxf(v[q], 0.f);
          }
        }
        *reinterpret_cast<float4*>(ytile + r * BN + col) =
            make_float4(v[0], v[1], v[2], v[3]);
        if constexpr (STATS) {
          if (r < nrows) {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (n0 + col + q < g.N) {
                mom[0][h * 4 + q] += v[q];
                mom[1][h * 4 + q] += __fmul_rn(v[q], v[q]);
              }
          }
        }
      }
    }
    if constexpr (STATS) {
      // the warp's thread rows (lane bits from log2(TX) up), pairwise, then
      // its first thread row writes the warp's sums
#pragma unroll
      for (int off = TX; off < 32; off <<= 1)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          mom[0][j] += __shfl_xor_sync(0xffffffffu, mom[0][j], off);
          mom[1][j] += __shfl_xor_sync(0xffffffffu, mom[1][j], off);
        }
      if ((tid & 31) < TX) {
        float* const rw = red + (tid >> 5) * 2 * BN;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int col = (j / 4) * (BN / 2) + tx * 4 + j % 4;
          rw[col] = mom[0][j];
          rw[BN + col] = mom[1][j];
        }
      }
    }
    __syncthreads();
    if constexpr (STATS) {   // the warps in order: the tile's partial row
      if (tid < 2 * BN) {
        const int sm = tid / BN, col = tid - sm * BN;
        float tot = 0.f;
#pragma unroll
        for (int wp = 0; wp < kWarps; ++wp) tot += red[(wp * 2 + sm) * BN + col];
        if (n0 + col < g.N)
          partial[(((size_t)b * g.ntiles + t) * 2 + sm) * g.N + n0 + col] =
              tot;
      }
    }
    // the tile's rows < V, columns [n0, n0 + ncols): one run of rows x N
    // floats where the block covers N
    const int ncols = min(BN, g.N - n0);
    float* const yt = yb + (size_t)m0 * g.N + n0;
    if (g.vec_y) {
      for (int f = tid * 4; f < nrows * ncols; f += kThreads * 4) {
        const int r = f / ncols, col = f - r * ncols;
        *reinterpret_cast<float4*>(yt + (size_t)r * g.N + col) =
            *reinterpret_cast<const float4*>(ytile + r * BN + col);
      }
    } else {
      for (int f = tid; f < nrows * ncols; f += kThreads) {
        const int r = f / ncols, col = f - r * ncols;
        yt[(size_t)r * g.N + col] = ytile[r * BN + col];
      }
    }
  }
}

// --- the launch (host) -----------------------------------------------------

constexpr int kMaxDevices = 16;
constexpr int kMaxChunks = 64;

// The blocks of one instantiation that stay resident on the card at
// `nchunks` K chunks (the plan's stages follow from them), into *out.  The
// first query on a device also sets the instantiation's shared-memory
// limit there to the most a block may have (so no later launch needs it
// raised); the count is kept per device and chunk count, so later
// launches ask the runtime nothing.
template <int BN, bool STATS, bool EPI>
int resident_blocks(int nchunks, size_t smem, int* out) {
  static std::atomic<int> known[kMaxDevices][kMaxChunks + 1];  // 0: unknown
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const bool keep = dev < kMaxDevices && nchunks <= kMaxChunks;
  if (keep && (*out = known[dev][nchunks].load(std::memory_order_relaxed)))
    return 0;
  const void* fn = reinterpret_cast<const void*>(gemm_fma_kernel<BN, STATS, EPI>);
  int sms = 0, per_sm = 0;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemMax);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                      smem);
  if (e != cudaSuccess) return (int)e;
  *out = (per_sm > 0 ? per_sm : 1) * sms;
  if (keep) known[dev][nchunks].store(*out, std::memory_order_relaxed);
  return 0;
}

// As many blocks as stay resident on the card (each walks over tiles), at
// most one per tile
template <int BN, bool STATS, bool EPI>
int launch_bn(const float* x, const float* w, const float* bias, float* y,
              float* partial, const Geom& g, int B, size_t smem,
              cudaStream_t st) {
  int resident = 0;
  const int e = resident_blocks<BN, STATS, EPI>(g.nchunks, smem, &resident);
  if (e != 0) return e;
  const int ny = (g.N + BN - 1) / BN;
  const int nx = (resident + ny * B - 1) / (ny * B);
  const dim3 grid(nx < g.ntiles ? nx : g.ntiles, ny, B);
  gemm_fma_kernel<BN, STATS, EPI>
      <<<grid, kThreads, smem, st>>>(x, w, bias, y, partial, g);
  return (int)cudaGetLastError();
}

// The launch of one variant: g holds the shapes (V, K, N; EPI's relu), the
// plan's side (chunks, stages, tiles, vector copies) is filled in here.
// STATS needs partial (B, tiles(V, N), 2, N).  All tensors contiguous on
// the device of `st` (the current device).  Returns the launch's
// cudaError_t.  Each source instantiates only what it calls.
template <bool STATS, bool EPI>
int launch(const float* x, const float* w, const float* bias, float* y,
           float* partial, Geom g, int B, cudaStream_t st) {
  if (B < 1 || g.V < 1 || g.K < 1 || g.N < 1 ||
      (STATS && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(g.K, g.N, STATS);
  if (p.smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  g.nchunks = p.nchunks;
  g.stages = p.stages;
  g.ntiles = (g.V + p.bm - 1) / p.bm;
  g.vec_x = g.K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  g.vec_w = g.N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  g.vec_y = g.N % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  switch (p.bn) {
    case 16: return launch_bn<16, STATS, EPI>(x, w, bias, y, partial, g, B,
                                              p.smem, st);
    case 32: return launch_bn<32, STATS, EPI>(x, w, bias, y, partial, g, B,
                                              p.smem, st);
    case 64: return launch_bn<64, STATS, EPI>(x, w, bias, y, partial, g, B,
                                              p.smem, st);
    default: return launch_bn<128, STATS, EPI>(x, w, bias, y, partial, g, B,
                                               p.smem, st);
  }
}

}  // namespace gfma
}  // namespace
