// The bf16 voxel-row GEMM on the tensor cores, behind K2 bf16 (pgemm.cu
// gemm_stats_bf16): y (B, V, N) = x (B, V, K) @ w (K, N), bf16 operands,
// fp32 accumulation, y rounded once to bf16, with each 128-row tile's Σy
// and Σy² of the rounded y (the GroupNorm moments).
//
// Replaces (nas_3d_unet_tpu/): ops/pallas/pgemm.py:311 gemm_stats (body
// _gemm_kernel :287, pallas_call :330) in bf16: the 1^3 conv with its
// moments epilogue.
//
// What bounds it on the H100: the bytes.  A voxel row does 2*K*N flops for
// (K + N) * 2 bytes, 16 to 43 flop/B at the train step's shapes
// (chip_smoke.py's K2_TRAIN, K 48-384, N 16-128) against the card's ~295
// flop/B balance: 0.72 ms of bytes per step at 3.35 TB/s.  The FMA tile
// this replaces (igemm.cuh) sat at 5.6x that, staging 8-deep K slices
// through registers with 4-byte loads.
//
// What the design does about it: keep bytes in flight.
//   - V is cut into tiles of 128 rows; a block owns BN columns, BN = N
//     rounded up to 16/32/64/128 (every K2 shape has N <= 128: one block
//     covers N, and x is read once); 8 warps, each 32 rows (16 at BN = 16)
//     x BN / WN columns of mma.sync m16n8k16 accumulators.
//   - w is staged once per block; x in K chunks of 32 through a ring of
//     four stages, by zero-filling 16-byte cp.async copies (rows past V or
//     K, columns past K or N read as zeros; a K or N not a multiple of 8,
//     or a misaligned base, takes scalar copies with the same padding).
//     Rows of 80 bytes (x) and (BN + 8) * 2 (w) put ldmatrix's 8 rows in
//     distinct banks.  A comes from ldmatrix, B from ldmatrix.trans.
//   - The grid holds as many blocks as stay resident; each walks over its
//     tiles, its copies three chunks ahead across tile boundaries, so the
//     next tile's x is in flight during this tile's epilogue (measured on
//     the H100 against one tile per block with x double-buffered: 0.159
//     against 0.235 ms at 48 -> 16 over 128^3).
//   - The epilogue rounds y once, stages the bf16 tile in shared memory
//     and stores it as 16-byte row vectors (or scalars where N is not a
//     multiple of 8), and sums the moments of the rounded values of rows
//     < V and columns < N in its store loop, reduced in the fixed order of
//     moments.cuh into one partial row per tile.  No atomics: the same
//     bits on every launch, whatever the grid.
// Simple first: no wgmma or TMA (later work).  ops/gemm_mma.py mirrors the
// plan and the algorithm in plain PyTorch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "moments.cuh"

namespace {
namespace gmma {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;   // 8 warps
constexpr int kBM = 128;        // rows per tile
constexpr int kKC = 32;         // K per x stage: two MMA K steps
constexpr int kLdX = kKC + 8;   // x stage row, bf16: 80 bytes
constexpr int kStages = 4;      // x stages: 3 chunks in flight ahead
constexpr int kSmemMax = 232448;

// warps: WN along N (2 from BN = 32), WM = 8 / WN along M
template <int BN>
struct Tile {
  static constexpr int WN = BN >= 32 ? 2 : 1;
  static constexpr int WM = 8 / WN;
  static constexpr int MI = kBM / WM / 16;   // 16-row MMA tiles per warp
  static constexpr int NI = BN / WN / 8;     // 8-column MMA tiles per warp
  static constexpr int LDW = BN + 8;         // w and y-tile row, bf16
};

// --- the plan (host), mirrored by ops/gemm_mma.py:plan ---------------------

struct Plan {
  int bn;         // columns per block
  int nchunks;    // K chunks of 32
  size_t smem;    // bytes of shared memory per block
};

inline Plan make_plan(int k, int n) {
  Plan p;
  p.bn = n <= 16 ? 16 : n <= 32 ? 32 : n <= 64 ? 64 : 128;
  p.nchunks = (k + kKC - 1) / kKC;
  const int wm = 8 / (p.bn >= 32 ? 2 : 1);
  // w (all chunks), the x stages, the epilogue's y tile and the moments'
  // warp rows, side by side: the next tile's copies land during this
  // tile's epilogue
  p.smem = ((size_t)p.nchunks * kKC * (p.bn + 8) +
            (size_t)kStages * kBM * kLdX + (size_t)kBM * (p.bn + 8)) *
               sizeof(bf16) +
           (size_t)wm * 2 * p.bn * sizeof(float);
  return p;
}

struct Geom {
  int V, K, N;
  int nchunks, ntiles;        // K chunks; 128-row tiles of V
  int vec_x, vec_w, vec_y;    // 16-byte copies for x, w; 16-byte y stores
};

// --- the kernel ------------------------------------------------------------

// Block (x, y, z) takes the tiles x, x + gridDim.x, ... of batch item z,
// columns [y * BN, y * BN + BN); its (tile, chunk) steps run through one
// ring of kStages x stages, so copies run kStages - 1 steps ahead across
// tile boundaries.  partial (B, ntiles, 2, N): one row per tile.
template <int BN>
__global__ void __launch_bounds__(kThreads, 2)
gemm_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                bf16* __restrict__ y, float* __restrict__ partial,
                const Geom g) {
  using T = Tile<BN>;
  using nas3d::cp_async16_zfill;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const ws = reinterpret_cast<bf16*>(smem);
  bf16* const xs0 = ws + g.nchunks * kKC * T::LDW;
  bf16* const ytile = xs0 + kStages * kBM * kLdX;
  float* const red = reinterpret_cast<float*>(ytile + kBM * T::LDW);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / T::WN;
  const int wm0 = wm * (kBM / T::WM);
  const int wn0 = (warp % T::WN) * (BN / T::WN);
  const int n0 = blockIdx.y * BN, b = blockIdx.z;
  const bf16* const xb = x + (size_t)b * g.V * g.K;
  bf16* const yb = y + (size_t)b * g.V * g.N;
  const int nsteps =
      (g.ntiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x *
      g.nchunks;

  // w rows [0, 32 * nchunks) x columns [n0, n0 + BN), zero past K and N
  if (g.vec_w) {
    constexpr int VPR = BN / 8;
    for (int i = tid; i < g.nchunks * kKC * VPR; i += kThreads) {
      const int k = i / VPR, j = i - k * VPR, n = n0 + j * 8;
      const bool ok = k < g.K && n < g.N;
      cp_async16_zfill(ws + k * T::LDW + j * 8,
                       ok ? w + (size_t)k * g.N + n : w, ok);
    }
  } else {
    const unsigned short* wu = reinterpret_cast<const unsigned short*>(w);
    unsigned short* wsu = reinterpret_cast<unsigned short*>(ws);
    for (int i = tid; i < g.nchunks * kKC * BN; i += kThreads) {
      const int k = i / BN, j = i - k * BN, n = n0 + j;
      wsu[k * T::LDW + j] =
          k < g.K && n < g.N ? __ldg(wu + (size_t)k * g.N + n)
                             : (unsigned short)0;
    }
  }
  // step s: x rows of tile blockIdx.x + (s / nchunks) * gridDim.x, K chunk
  // s % nchunks, into stage s % kStages, zero past V and K; one cp.async
  // group per step, empty past the last step
  auto load_step = [&](int s) {
    if (s < nsteps) {
      const int m0 = (blockIdx.x + s / g.nchunks * gridDim.x) * kBM;
      const int k0 = s % g.nchunks * kKC;
      bf16* const xs = xs0 + s % kStages * kBM * kLdX;
      if (g.vec_x) {
        for (int i = tid; i < kBM * (kKC / 8); i += kThreads) {
          const int r = i / (kKC / 8), k = k0 + (i % (kKC / 8)) * 8;
          const bool ok = m0 + r < g.V && k < g.K;
          cp_async16_zfill(xs + r * kLdX + (k - k0),
                           ok ? xb + (size_t)(m0 + r) * g.K + k : xb, ok);
        }
      } else {
        const unsigned short* xu = reinterpret_cast<const unsigned short*>(xb);
        unsigned short* xsu = reinterpret_cast<unsigned short*>(xs);
        for (int i = tid; i < kBM * kKC; i += kThreads) {
          const int r = i / kKC, kk = i - r * kKC, k = k0 + kk;
          xsu[r * kLdX + kk] =
              m0 + r < g.V && k < g.K
                  ? __ldg(xu + (size_t)(m0 + r) * g.K + k) : (unsigned short)0;
        }
      }
    }
    nas3d::cp_async_commit();
  };

  float acc[T::MI][T::NI][4];
  const int col8 = (lane >> 4) * 8;   // ldmatrix: k (A) or n (B) half
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load_step(s);   // w joins step 0
  for (int s = 0; s < nsteps; ++s) {
    nas3d::cp_async_wait<kStages - 2>();  // step s (and w) have landed
    __syncthreads();   // ... for every thread; and every warp is done with
                       // step s - 1's stage and the last epilogue's tile
    load_step(s + kStages - 1);
    const int c = s % g.nchunks;
    if (c == 0) {
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;
    }
    const bf16* xs = xs0 + s % kStages * kBM * kLdX;
#pragma unroll
    for (int ks = 0; ks < kKC / 16; ++ks) {
      uint32_t bfr[T::NI / 2][4];     // n-tiles 2np, 2np + 1
#pragma unroll
      for (int np = 0; np < T::NI / 2; ++np)
        nas3d::ldsm_x4_trans(
            bfr[np], ws + (c * kKC + ks * 16 + (lane & 15)) * T::LDW + wn0 +
                         np * 16 + col8);
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi) {
        uint32_t a[4];
        nas3d::ldsm_x4(a, xs + (wm0 + mi * 16 + (lane & 15)) * kLdX +
                              ks * 16 + col8);
#pragma unroll
        for (int np = 0; np < T::NI / 2; ++np) {
          nas3d::mma_bf16(acc[mi][2 * np], a, bfr[np][0], bfr[np][1]);
          nas3d::mma_bf16(acc[mi][2 * np + 1], a, bfr[np][2], bfr[np][3]);
        }
      }
    }
    if (c != g.nchunks - 1) continue;

    // epilogue of tile t: accumulator (mi, ni) holds rows lane/4 and
    // lane/4 + 8 of its 16-row tile at columns 2*(lane%4) and +1 of its
    // 8-column tile.  The rounded tile goes to shared memory (rows of
    // LDW), the moments' warp rows beside it
    const int t = blockIdx.x + s / g.nchunks * gridDim.x;
    const int m0 = t * kBM;
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni) {
      const int col = wn0 + ni * 8 + 2 * (lane & 3);   // column in the tile
      const bool ok0 = n0 + col < g.N, ok1 = n0 + col + 1 < g.N;
      float mom[4] = {0.f, 0.f, 0.f, 0.f};           // Σy, Σy² at col, +1
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = wm0 + mi * 16 + (lane >> 2) + hr * 8;
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              acc[mi][ni][2 * hr], acc[mi][ni][2 * hr + 1]);
          *reinterpret_cast<__nv_bfloat162*>(ytile + r * T::LDW + col) = v;
          if (m0 + r >= g.V) continue;
          const float f0 = __low2float(v), f1 = __high2float(v);
          if (ok0) {
            mom[0] += f0;
            mom[2] += f0 * f0;
          }
          if (ok1) {
            mom[1] += f1;
            mom[3] += f1 * f1;
          }
        }
      nas3d::moments_warp_put<BN>(red, wm, wn0 + ni * 8, mom);
    }
    __syncthreads();
    nas3d::moments_block_put<BN, T::WM>(red, partial,
                                        (size_t)b * g.ntiles + t, n0, g.N);
    // the tile's rows < V, columns < N, to y
    if (g.vec_y) {
      constexpr int VPR = BN / 8;
      for (int i = tid; i < kBM * VPR; i += kThreads) {
        const int r = i / VPR, j = (i - r * VPR) * 8;
        if (m0 + r < g.V && n0 + j < g.N)
          *reinterpret_cast<uint4*>(yb + (size_t)(m0 + r) * g.N + n0 + j) =
              *reinterpret_cast<const uint4*>(ytile + r * T::LDW + j);
      }
    } else {
      for (int i = tid; i < kBM * BN; i += kThreads) {
        const int r = i / BN, j = i - r * BN;
        if (m0 + r < g.V && n0 + j < g.N)
          yb[(size_t)(m0 + r) * g.N + n0 + j] = ytile[r * T::LDW + j];
      }
    }
  }
}

// As many blocks as stay resident on the card (each walks over tiles), at
// most one per tile
template <int BN>
int launch_bn(const bf16* x, const bf16* w, bf16* y, float* partial,
              const Geom& g, int B, size_t smem, cudaStream_t st) {
  const void* fn = reinterpret_cast<const void*>(gemm_mma_kernel<BN>);
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                      smem);
  if (e != cudaSuccess) return (int)e;
  const int ny = (g.N + BN - 1) / BN;
  const int resident = (per_sm > 0 ? per_sm : 1) * sms;
  const int nx = (resident + ny * B - 1) / (ny * B);
  const dim3 grid(nx < g.ntiles ? nx : g.ntiles, ny, B);
  gemm_mma_kernel<BN><<<grid, kThreads, smem, st>>>(x, w, y, partial, g);
  return (int)cudaGetLastError();
}

// Launch: x (B, V, K), w (K, N), y (B, V, N) bf16; partial (B, ceil(V /
// 128), 2, N) fp32 gets each tile's moments; all contiguous on the device
// of `st` (the current device).  Returns the launch's cudaError_t.
inline int launch_gemm_mma(const bf16* x, const bf16* w, bf16* y,
                           float* partial, int B, int V, int K, int N,
                           cudaStream_t st) {
  if (B < 1 || V < 1 || K < 1 || N < 1 || partial == nullptr)
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(K, N);
  if (p.smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  Geom g{};
  g.V = V, g.K = K, g.N = N, g.nchunks = p.nchunks;
  g.ntiles = (V + kBM - 1) / kBM;
  g.vec_x = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  g.vec_w = N % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  g.vec_y = N % 8 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  switch (p.bn) {
    case 16: return launch_bn<16>(x, w, y, partial, g, B, p.smem, st);
    case 32: return launch_bn<32>(x, w, y, partial, g, B, p.smem, st);
    case 64: return launch_bn<64>(x, w, y, partial, g, B, p.smem, st);
    default: return launch_bn<128>(x, w, y, partial, g, B, p.smem, st);
  }
}

}  // namespace gmma
}  // namespace
