// The two measuring probes of the JAX era, as kernels for the H100.
//
// Replaces:
//   E1 copy_rows_bf16 <- experiments/r3_dma_probe.py:27 run (pallas_call :28,
//       body copy_kernel :24): o = x over a (rows, lanes) bf16 array, one
//       block of rows_per_block rows per grid step.  The probe times it to
//       learn what bandwidth a hand-written copy reaches.
//   E2 pg_{full,c6,nodot,mt4,fold1536}_bf16 <- experiments/r3_pg_variants.py
//       :122 run (pallas_call :129; bodies k_full :54, k_c6 :68, k_nodot :80,
//       k_fold :84, k_mt :103): five variants of K1's shifted-GEMM conv on
//       the level-0 plane geometry, per plane bd with P_k = clip(bd + k, 0,
//       NB - 1):
//         full:  y[bd] = sum_{kh<3, k<3} x[P_k, kh*WP : kh*WP+M] @ ac[k, kh]
//                                      + xe[P_k, kh*WP : kh*WP+M] @ ae[k, kh]
//         c6:    kh < 2, centre terms only (two thirds of the flops)
//         nodot: y[bd] = x[P_1, WP : WP+M] (data movement only)
//         mt4:   full with a quarter of the M-tile per block
//         fold1536: xcat = [9 centre slices | 9 edge slices | zeros] (M, 1536),
//                y[bd] = xcat @ ac2 (one long-K product)
//       bf16 operands, fp32 accumulation, y rounded once to bf16.
//
// What bounds them on the H100: E1 and nodot move bytes only (3.35 TB/s);
// full, c6, mt4 and fold1536 do 51-103 GFLOP at NB = 128 for ~150 MB, far
// above the bf16 balance of ~295 flop/B, so the tensor cores' 989 TFLOP/s
// bound them.
//
// What the design does about it:
//   E1: each block copies its rows with 16-byte loads and stores, four in
//   flight per thread.  rows_per_block sets the block count (64 MiB / 2 MiB
//   blocks = 32 blocks for 132 SMs), which is what the sweep measures.
//   E2: the dots run on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
//   accumulate), operands staged in shared memory by cp.async and fed to the
//   MMAs by ldmatrix; rows are padded by 16 bytes so ldmatrix's eight rows
//   fall in distinct banks.  A block owns one plane and a BM x 128 tile of
//   y.  The shifted variants stage a plane's x rows once for all kh (the
//   three kh windows overlap but for 2*WP rows) and each term's weight
//   tile in turn; mt4 is the same code at BM = 32 (4x the blocks, a quarter
//   of the accumulators).  fold1536 builds xcat for its 128 rows in shared
//   memory 64 columns at a time, gathered from x and xe by cp.async beside
//   the same 64 rows of ac2, in a 3-stage pipeline (two stages in flight
//   under the MMAs): the whole (128, 1536) xcat would take 393 KB, and
//   64 rows of it at once (197 KB) leave one block per SM with the build
//   exposed (2.5x slower than full on an H100).  The variant is a
//   compile-time flag: nodot carries no MMA code, full no fold scratch.
//   Simple first: no wgmma or TMA; the shifted variants do not overlap a
//   term's loads with the previous term's MMAs beyond what a second
//   resident block gives.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

using nas3d::cp_async16;
using nas3d::cp_async16_zfill;
using nas3d::cp_async_commit;
using nas3d::cp_async_wait;
using nas3d::ldsm_x4;
using nas3d::ldsm_x4_trans;
using nas3d::mma_bf16;

// ---------------------------------------------------------------------------
// E1: the copy
// ---------------------------------------------------------------------------

constexpr int kCopyThreads = 256;
constexpr int kCopyUnroll = 4;   // 16-byte loads in flight per thread

__global__ void __launch_bounds__(kCopyThreads)
copy_rows_kernel(const uint4* __restrict__ x, uint4* __restrict__ y,
                 int vec_per_block) {
  const size_t base = (size_t)blockIdx.x * vec_per_block;
  const int tid = threadIdx.x;
  for (int i = tid; i < vec_per_block; i += kCopyUnroll * kCopyThreads) {
    uint4 v[kCopyUnroll];
#pragma unroll
    for (int u = 0; u < kCopyUnroll; ++u) {
      const int j = i + u * kCopyThreads;
      if (j < vec_per_block) v[u] = __ldg(x + base + j);
    }
#pragma unroll
    for (int u = 0; u < kCopyUnroll; ++u) {
      const int j = i + u * kCopyThreads;
      if (j < vec_per_block) y[base + j] = v[u];
    }
  }
}

// ---------------------------------------------------------------------------
// E2: the shifted-GEMM variants
// ---------------------------------------------------------------------------

constexpr int kRC = 128;           // centre channels: N, and K of a centre dot
constexpr int kKE = 32;            // edge channels: K of an edge dot
constexpr int kFoldK = 1536;       // fold1536's K: 9*128 + 9*32 = 1440, padded
constexpr int kThreads = 256;      // 8 warps
constexpr int kPad = 8;            // bf16 of padding per shared-memory row
constexpr int kLdC = kRC + kPad;   // 272-byte rows: ldmatrix conflict-free
constexpr int kLdE = kKE + kPad;   // 80-byte rows
constexpr int kFoldKC = 64;        // fold1536's K per pipeline stage

enum Variant { kFull, kC6, kNodot, kMt4, kFold };

// BM rows of y per block; WM warps along M (8 / WM along N); the shifted
// variants' KH kernel rows, and EDGE: the edge terms are summed
template <int V> struct Tile;
template <> struct Tile<kFull> {
  static constexpr int BM = 128, WM = 4, KH = 3;
  static constexpr bool EDGE = true;
};
template <> struct Tile<kC6> {
  static constexpr int BM = 128, WM = 4, KH = 2;
  static constexpr bool EDGE = false;
};
template <> struct Tile<kMt4> {
  static constexpr int BM = 32, WM = 2, KH = 3;
  static constexpr bool EDGE = true;
};
template <> struct Tile<kFold> { static constexpr int BM = 128, WM = 4; };
template <> struct Tile<kNodot> { static constexpr int BM = 128; };

// rows x cols bf16 from global (row stride cols) into shared memory (row
// stride ld), 16 bytes per cp.async, all threads of the block
__device__ __forceinline__ void stage(bf16* dst, int ld, const bf16* src,
                                      int cols, int rows) {
  const int cpr = cols / 8;
  for (int i = threadIdx.x; i < rows * cpr; i += kThreads) {
    const int r = i / cpr, c = (i % cpr) * 8;
    cp_async16(dst + r * ld + c, src + (size_t)r * cols + c);
  }
}

// One warp: acc[MI][NI] (its (16*MI) x (8*NI) tile) += A @ B over K, A
// (shared, row stride lda) at the warp's first row, B (shared, K x N, row
// stride ldb) at the warp's first column.
template <int MI, int NI, int K>
__device__ __forceinline__ void warp_mma(float (&acc)[MI][NI][4],
                                         const bf16* A, int lda,
                                         const bf16* B, int ldb, int lane) {
  const int r = lane & 15, c = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
    uint32_t a[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
      ldsm_x4(a[mi], A + (mi * 16 + r) * lda + kk + c);
#pragma unroll
    for (int np = 0; np < NI / 2; ++np) {
      uint32_t b[4];   // n-tile 2np: b[0], b[1]; n-tile 2np + 1: b[2], b[3]
      ldsm_x4_trans(b, B + (kk + r) * ldb + np * 16 + c);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        mma_bf16(acc[mi][2 * np], a[mi], b[0], b[1]);
        mma_bf16(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
      }
    }
  }
}

// y rows [row0, ...) of the warp's tile, rounded once to bf16
template <int MI, int NI>
__device__ __forceinline__ void store_tile(bf16* y, const float (&acc)[MI][NI][4],
                                           size_t row0, int col0, int lane) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const size_t r = row0 + mi * 16 + (lane >> 2);
      const int c = col0 + ni * 8 + 2 * (lane & 3);
      const float* d = acc[mi][ni];
      *reinterpret_cast<__nv_bfloat162*>(y + r * kRC + c) =
          __floats2bfloat162_rn(d[0], d[1]);
      *reinterpret_cast<__nv_bfloat162*>(y + (r + 8) * kRC + c) =
          __floats2bfloat162_rn(d[2], d[3]);
    }
}

// x (NB, HPWP, kRC), xe (NB, HPWP, kKE), y (NB, M, kRC)
#define PG_PARAMS                                                             \
  const bf16 *__restrict__ x, const bf16 *__restrict__ xe,                    \
      const bf16 *__restrict__ w, const bf16 *__restrict__ we,                \
      bf16 *__restrict__ y, int NB, int HPWP, int WP, int M

// Shared-memory bytes of a shifted variant: the plane's x rows (and xe
// rows), one centre weight tile (and one edge weight tile)
template <int V>
size_t shifted_smem(int WP) {
  using T = Tile<V>;
  const size_t xr = T::BM + (T::KH - 1) * WP;
  size_t n = xr * kLdC + (size_t)kRC * kLdC;
  if (T::EDGE) n += xr * kLdE + (size_t)kKE * kLdC;
  return n * sizeof(bf16);
}

// full, c6, mt4: w = ac (3, 3, kRC, kRC), we = ae (3, 3, kKE, kRC)
template <int V>
__device__ __forceinline__ void pg_shifted(PG_PARAMS) {
  using T = Tile<V>;
  constexpr int BM = T::BM, KH = T::KH, WARPS_N = 8 / T::WM;
  constexpr int MI = BM / T::WM / 16, NI = kRC / WARPS_N / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int xr = BM + (KH - 1) * WP;
  bf16* xs = reinterpret_cast<bf16*>(smem);   // xr x kLdC
  bf16* ws = xs + xr * kLdC;                   // kRC x kLdC: ac[k, kh]
  bf16* xes = ws + kRC * kLdC;                 // xr x kLdE
  bf16* wes = xes + xr * kLdE;                 // kKE x kLdC: ae[k, kh]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm0 = (warp / WARPS_N) * (BM / T::WM);
  const int wn0 = (warp % WARPS_N) * (kRC / WARPS_N);
  const int m0 = blockIdx.x * BM, bd = blockIdx.y;
  float acc[MI][NI][4] = {};
  for (int k = 0; k < 3; ++k) {
    const int p = min(bd + k, NB - 1);        // clip(bd + k, 0, NB - 1)
    for (int kh = 0; kh < KH; ++kh) {
      __syncthreads();   // every warp is done with the previous term's tiles
      if (kh == 0) {
        stage(xs, kLdC, x + ((size_t)p * HPWP + m0) * kRC, kRC, xr);
        if (T::EDGE)
          stage(xes, kLdE, xe + ((size_t)p * HPWP + m0) * kKE, kKE, xr);
      }
      stage(ws, kLdC, w + (size_t)(k * 3 + kh) * kRC * kRC, kRC, kRC);
      if (T::EDGE)
        stage(wes, kLdC, we + (size_t)(k * 3 + kh) * kKE * kRC, kRC, kKE);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      warp_mma<MI, NI, kRC>(acc, xs + (kh * WP + wm0) * kLdC, kLdC, ws + wn0,
                            kLdC, lane);
      if (T::EDGE)
        warp_mma<MI, NI, kKE>(acc, xes + (kh * WP + wm0) * kLdE, kLdE,
                              wes + wn0, kLdC, lane);
    }
  }
  store_tile(y, acc, (size_t)bd * M + m0 + wm0, wn0, lane);
}

// fold1536's pipeline: xcat and ac2 stream through kFoldStages shared-memory
// stages of kFoldKC columns (rows of ac2) each
constexpr int kLdA = kFoldKC + kPad;   // 144-byte rows
constexpr int kFoldStages = 3;
constexpr int kStageElems = Tile<kFold>::BM * kLdA + kFoldKC * kLdC;
constexpr size_t kFoldSmem = (size_t)kFoldStages * kStageElems * sizeof(bf16);

// xcat's columns [j*kFoldKC, (j+1)*kFoldKC) of the block's rows, and ac2's
// rows of the same range, into one stage (one cp.async group).  Column c of
// xcat: c < 9*kRC is centre slice (kh, k) = divmod(c / kRC, 3), column
// c % kRC of x[P_k, kh*WP + row]; then edge slices of kKE columns from xe;
// from 9*(kRC + kKE) zeros (a cp.async that reads 0 bytes zero-fills).
__device__ __forceinline__ void fold_stage(bf16* st, int j, const bf16* x,
                                           const bf16* xe, const bf16* w,
                                           int NB, int HPWP, int WP, int m0,
                                           int bd) {
  constexpr int BM = Tile<kFold>::BM, kVecs = kFoldKC / 8;
  bf16* as = st;
  bf16* bs = st + BM * kLdA;
  for (int i = threadIdx.x; i < BM * kVecs; i += kThreads) {
    const int r = i / kVecs, v = i % kVecs;
    const int c = j * kFoldKC + v * 8;
    const bf16* src = x;
    bool full = true;
    if (c < 9 * kRC) {
      const int seg = c / kRC, kh = seg / 3, k = seg % 3;
      src = x + ((size_t)min(bd + k, NB - 1) * HPWP + kh * WP + m0 + r) * kRC
            + c % kRC;
    } else if (c < 9 * (kRC + kKE)) {
      const int e = c - 9 * kRC, seg = e / kKE, kh = seg / 3, k = seg % 3;
      src = xe + ((size_t)min(bd + k, NB - 1) * HPWP + kh * WP + m0 + r) * kKE
            + e % kKE;
    } else {
      full = false;
    }
    cp_async16_zfill(as + r * kLdA + v * 8, src, full);
  }
  stage(bs, kLdC, w + (size_t)j * kFoldKC * kRC, kRC, kFoldKC);
  cp_async_commit();
}

// fold1536: w = ac2 (kFoldK, kRC).  One long-K GEMM y = xcat @ ac2 per
// BM x kRC tile, xcat built in shared memory kFoldKC columns at a time,
// kFoldStages - 1 stages in flight under the MMAs.
__device__ __forceinline__ void pg_fold(PG_PARAMS) {
  constexpr int BM = Tile<kFold>::BM, WARPS_N = 8 / Tile<kFold>::WM;
  constexpr int MI = BM / Tile<kFold>::WM / 16, NI = kRC / WARPS_N / 8;
  constexpr int kChunks = kFoldK / kFoldKC;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm0 = (warp / WARPS_N) * (BM / Tile<kFold>::WM);
  const int wn0 = (warp % WARPS_N) * (kRC / WARPS_N);
  const int m0 = blockIdx.x * BM, bd = blockIdx.y;
  for (int j = 0; j < kFoldStages - 1; ++j)
    fold_stage(stages + j * kStageElems, j, x, xe, w, NB, HPWP, WP, m0, bd);
  float acc[MI][NI][4] = {};
  for (int j = 0; j < kChunks; ++j) {
    cp_async_wait<kFoldStages - 2>();   // chunk j has landed
    __syncthreads();   // ... for every thread; chunk j - 1's stage is free
    const int next = j + kFoldStages - 1;
    if (next < kChunks)
      fold_stage(stages + (next % kFoldStages) * kStageElems, next, x, xe, w,
                 NB, HPWP, WP, m0, bd);
    else
      cp_async_commit();   // an empty group keeps the count of groups
    const bf16* st = stages + (j % kFoldStages) * kStageElems;
    warp_mma<MI, NI, kFoldKC>(acc, st + wm0 * kLdA, kLdA,
                              st + BM * kLdA + wn0, kLdC, lane);
  }
  store_tile(y, acc, (size_t)bd * M + m0 + wm0, wn0, lane);
}

// nodot: y[bd, m0 : m0+BM] = x[P_1, WP + m0 : WP + m0 + BM]
__device__ __forceinline__ void pg_nodot(PG_PARAMS) {
  constexpr int BM = Tile<kNodot>::BM;
  const int m0 = blockIdx.x * BM, bd = blockIdx.y;
  const uint4* src = reinterpret_cast<const uint4*>(
      x + ((size_t)min(bd + 1, NB - 1) * HPWP + WP + m0) * kRC);
  uint4* dst = reinterpret_cast<uint4*>(y + ((size_t)bd * M + m0) * kRC);
  for (int i = threadIdx.x; i < BM * kRC / 8; i += kThreads)
    dst[i] = __ldg(src + i);
}

// One __global__ per variant, so each has its own name in the SASS.
#define PG_ARGS x, xe, w, we, y, NB, HPWP, WP, M
__global__ void __launch_bounds__(kThreads, 2) pg_full_kernel(PG_PARAMS) {
  pg_shifted<kFull>(PG_ARGS);
}
__global__ void __launch_bounds__(kThreads, 2) pg_c6_kernel(PG_PARAMS) {
  pg_shifted<kC6>(PG_ARGS);
}
__global__ void __launch_bounds__(kThreads, 2) pg_mt4_kernel(PG_PARAMS) {
  pg_shifted<kMt4>(PG_ARGS);
}
__global__ void __launch_bounds__(kThreads, 2) pg_fold1536_kernel(PG_PARAMS) {
  pg_fold(PG_ARGS);
}
__global__ void __launch_bounds__(kThreads) pg_nodot_kernel(PG_PARAMS) {
  pg_nodot(PG_ARGS);
}
#undef PG_ARGS

typedef void (*PgKernel)(const bf16*, const bf16*, const bf16*, const bf16*,
                         bf16*, int, int, int, int);

int launch_pg(PgKernel kernel, int bm, size_t smem, const bf16* x,
              const bf16* xe, const bf16* w, const bf16* we, bf16* y, int NB,
              int HPWP, int WP, int M, cudaStream_t st) {
  if (NB < 1 || M < 1 || M % bm != 0 || HPWP < M + 2 * WP)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(M / bm, NB), kThreads, smem, st>>>(x, xe, w, we, y, NB, HPWP,
                                                   WP, M);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// E1: y = x, (rows, lanes) bf16, contiguous and 16-byte aligned, lanes a
// multiple of 8, rows a multiple of rows_per_block (one block each).
int copy_rows_bf16(const bf16* x, bf16* y, int rows, int lanes,
                   int rows_per_block, void* stream) {
  if (lanes % 8 != 0 || rows_per_block < 1 || rows % rows_per_block != 0)
    return (int)cudaErrorInvalidValue;
  copy_rows_kernel<<<rows / rows_per_block, kCopyThreads, 0,
                     (cudaStream_t)stream>>>(
      reinterpret_cast<const uint4*>(x), reinterpret_cast<uint4*>(y),
      rows_per_block * lanes / 8);
  return (int)cudaGetLastError();
}

// E2: x (NB, HPWP, 128), xe (NB, HPWP, 32), y (NB, M, 128) bf16 with
// HPWP >= M + 2*WP; w, we = ac (3, 3, 128, 128), ae (3, 3, 32, 128) for
// full/c6/mt4, w = ac2 (1536, 128) for fold1536 (we unused), neither for
// nodot; all contiguous, on the device of `stream`.  M a multiple of 128.
#define NAS3D_PG(NAME, KERNEL, V, SMEM)                                       \
  int NAME(const bf16* x, const bf16* xe, const bf16* w, const bf16* we,      \
           bf16* y, int NB, int HPWP, int WP, int M, void* stream) {          \
    return launch_pg(KERNEL, Tile<V>::BM, SMEM, x, xe, w, we, y, NB, HPWP,    \
                     WP, M, (cudaStream_t)stream);                            \
  }
NAS3D_PG(pg_full_bf16, pg_full_kernel, kFull, shifted_smem<kFull>(WP))
NAS3D_PG(pg_c6_bf16, pg_c6_kernel, kC6, shifted_smem<kC6>(WP))
NAS3D_PG(pg_mt4_bf16, pg_mt4_kernel, kMt4, shifted_smem<kMt4>(WP))
NAS3D_PG(pg_fold1536_bf16, pg_fold1536_kernel, kFold, kFoldSmem)
NAS3D_PG(pg_nodot_bf16, pg_nodot_kernel, kNodot, 0)
#undef NAS3D_PG

}  // extern "C"
