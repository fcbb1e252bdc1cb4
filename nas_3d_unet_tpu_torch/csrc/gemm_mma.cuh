// The bf16 voxel-row GEMM on the tensor cores, behind three kernels:
//   K2 bf16 (pgemm.cu gemm_stats_bf16): y (B, V, N) = x (B, V, K) @ w (K,
//      N), with each 128-row tile's Σy and Σy² of the rounded y (the
//      GroupNorm moments; flag STATS);
//   K7 bf16 (conv3d.cu pointwise_conv_bf16): the same product with a
//      bias/ReLU epilogue (flag EPI);
//   K4 bf16 (conv3d.cu conv_transpose2x_bf16): x (B, D, H, W, Cin) @ the
//      DHWIO kernel read as (Cin, 8 Cout), ReLU, stored depth-to-space
//      into (B, 2D, 2H, 2W, Cout) (flags EPI and D2S).
// bf16 operands, fp32 accumulation, y rounded once to bf16.
//
// Replaces (nas_3d_unet_tpu/ops/pallas/): pgemm.py:311 gemm_stats (body
// _gemm_kernel :287, pallas_call :330), conv3d.py:279 pointwise_conv (body
// _pointwise_kernel :251, pallas_call :314) and conv3d.py:356
// conv_transpose2x (body _transpose2x_kernel :338, pallas_call :394), each
// in bf16.
//
// What bounds them on the H100: the bytes.  A voxel row does 2*K*N flops
// for (K + N) * 2 bytes (K4: (Cin + 8*Cout) * 2), 8 to 64 flop/B at the
// train step's shapes (K 16-384, N 16-128; K4 N = 8*Cout up to 512)
// against the card's ~295 flop/B balance.  The FMA tile these replace
// (since deleted) staged 8-deep K slices through registers with 2- and 4-byte
// loads and stored y as scalars: 6.7x (K7) and 14x (K4) their bounds
// (measured on the H100 at the train step's shapes).
//
// What the design does about it: keep bytes in flight.
//   - V is cut into tiles of 128 rows; a block owns BN columns, BN = N
//     rounded up to 16/32/64/128, so at N <= 128 (K2, K7) one block covers
//     N and x is read once; 8 warps, each 32 rows (16 at BN = 16) x BN /
//     WN columns of mma.sync m16n8k16 accumulators.  K4's N = 8*Cout runs
//     ceil(N / 128) column blocks (grid.y; 2 and 4 at 32 -> 32 and 64 ->
//     64); each re-reads x, at most 2 MB at those shapes (32^3 x 32 and
//     16^3 x 64 voxels), from the 50 MB L2, so no N loop in the block.
//   - w is staged once per block; x in K chunks of 32 through a ring of
//     four stages, by zero-filling 16-byte cp.async copies (rows past V or
//     K, columns past K or N read as zeros; a K or N not a multiple of 8,
//     or a misaligned base, takes scalar copies with the same padding).
//     K4 stages the DHWIO kernel as it is: column (kd*4 + kh*2 + kw)*Cout +
//     co is tap w[1-kd, 1-kh, 1-kw, :, co], lax's flip, so the caller
//     builds no flipped copy.  Rows of 80 bytes (x) and (BN + 8) * 2 (w)
//     put ldmatrix's 8 rows in distinct banks.  A comes from ldmatrix, B
//     from ldmatrix.trans.
//   - The grid holds as many blocks as stay resident; each walks over its
//     tiles, its copies three chunks ahead across tile boundaries, so the
//     next tile's x is in flight during this tile's epilogue (measured on
//     the H100 against one tile per block with x double-buffered: 0.159
//     against 0.235 ms at 48 -> 16 over 128^3).
//   - The epilogue adds the bias and clamps (EPI: the bias an fp32 vector,
//     bias and ReLU read at run time) on the fp32 accumulator, rounds y
//     once, stages the bf16 tile in shared memory and stores it as 16-byte
//     vectors (or scalars where N, or K4's Cout, is not a multiple of 8).
//     Rows store as rows; D2S stores row (d, h, w)'s columns at (2d + kd,
//     2h + kh, 2w + kw, co): 8 columns of one tap are 8 contiguous
//     channels, and the kw = 0 and 1 taps of one (kd, kh) sit side by side
//     (2*Cout contiguous elements).  Each row's output corner is computed
//     once per tile into shared memory, each thread's column offset (the
//     same in all its rows) once per tile, in the store.
//   - STATS sums the moments of the rounded values of rows < V and columns
//     < N in the store loop, reduced in the fixed order of moments.cuh
//     into one partial row per tile.  No atomics: the same bits on every
//     launch, whatever the grid.
//   - The host side queries the resident blocks and sets the shared-memory
//     attribute once per instantiation, device and K chunk count, so a
//     launch is the launch alone.
// Simple first: no wgmma or TMA (later work).  ops/gemm_mma.py mirrors the
// plan and the algorithm in plain PyTorch.
#pragma once

#include <atomic>
#include <climits>

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

inline Plan make_plan(int k, int n, bool stats, bool d2s) {
  Plan p;
  p.bn = n <= 16 ? 16 : n <= 32 ? 32 : n <= 64 ? 64 : 128;
  p.nchunks = (k + kKC - 1) / kKC;
  const int wm = 8 / (p.bn >= 32 ? 2 : 1);
  // w (all chunks), the x stages and the epilogue's y tile side by side
  // (the next tile's copies land during this tile's epilogue), then STATS'
  // moments warp rows and D2S's row corners
  p.smem = ((size_t)p.nchunks * kKC * (p.bn + 8) +
            (size_t)kStages * kBM * kLdX + (size_t)kBM * (p.bn + 8)) *
               sizeof(bf16) +
           (stats ? (size_t)wm * 2 * p.bn * sizeof(float) : 0) +
           (d2s ? (size_t)kBM * sizeof(int) : 0);
  return p;
}

struct Geom {
  int V, K, N;
  int nchunks, ntiles;        // K chunks; 128-row tiles of V
  int vec_x, vec_w, vec_y;    // 16-byte copies for x, w; 16-byte y stores
  int relu;                   // EPI
  int H, W, cout;             // D2S: V = D*H*W input voxels, N = 8*cout
};

// --- the kernel ------------------------------------------------------------

// Block (x, y, z) takes the tiles x, x + gridDim.x, ... of batch item z,
// columns [y * BN, y * BN + BN); its (tile, chunk) steps run through one
// ring of kStages x stages, so copies run kStages - 1 steps ahead across
// tile boundaries.  STATS: partial (B, ntiles, 2, N), one row per tile.
// EPI: bias (N,) fp32 or null, added before the ReLU (g.relu).
template <int BN, bool STATS, bool EPI, bool D2S>
__global__ void __launch_bounds__(kThreads, 2)
gemm_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const float* __restrict__ bias, bf16* __restrict__ y,
                float* __restrict__ partial, const Geom g) {
  using T = Tile<BN>;
  using nas3d::cp_async16_zfill;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const ws = reinterpret_cast<bf16*>(smem);
  bf16* const xs0 = ws + g.nchunks * kKC * T::LDW;
  bf16* const ytile = xs0 + kStages * kBM * kLdX;
  float* const red = reinterpret_cast<float*>(ytile + kBM * T::LDW);
  int* const corner = reinterpret_cast<int*>(ytile + kBM * T::LDW);
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

  // w rows [0, 32 * nchunks) x columns [n0, n0 + BN), zero past K and N.
  // D2S: column n = tap * cout + co is w[7 - tap][k][co] of the DHWIO
  // kernel (taps (kd, kh, kw) flattened, flipped on all three axes)
  auto w_at = [&](int k, int n) -> size_t {
    if constexpr (D2S) {
      const int tap = n / g.cout;
      return ((size_t)(7 - tap) * g.K + k) * g.cout + (n - tap * g.cout);
    } else {
      return (size_t)k * g.N + n;
    }
  };
  if (g.vec_w) {
    constexpr int VPR = BN / 8;
    for (int i = tid; i < g.nchunks * kKC * VPR; i += kThreads) {
      const int k = i / VPR, j = i - k * VPR, n = n0 + j * 8;
      const bool ok = k < g.K && n < g.N;
      cp_async16_zfill(ws + k * T::LDW + j * 8, ok ? w + w_at(k, n) : w, ok);
    }
  } else {
    const unsigned short* wu = reinterpret_cast<const unsigned short*>(w);
    unsigned short* wsu = reinterpret_cast<unsigned short*>(ws);
    for (int i = tid; i < g.nchunks * kKC * BN; i += kThreads) {
      const int k = i / BN, j = i - k * BN, n = n0 + j;
      wsu[k * T::LDW + j] =
          k < g.K && n < g.N ? __ldg(wu + w_at(k, n)) : (unsigned short)0;
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
    // LDW), the moments' warp rows or the rows' output corners beside it
    const int t = blockIdx.x + s / g.nchunks * gridDim.x;
    const int m0 = t * kBM;
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni) {
      const int col = wn0 + ni * 8 + 2 * (lane & 3);   // column in the tile
      const bool ok0 = n0 + col < g.N, ok1 = n0 + col + 1 < g.N;
      float b0 = 0.f, b1 = 0.f;
      if constexpr (EPI) {
        if (bias != nullptr) {
          if (ok0) b0 = __ldg(bias + n0 + col);
          if (ok1) b1 = __ldg(bias + n0 + col + 1);
        }
      }
      float mom[4] = {0.f, 0.f, 0.f, 0.f};           // Σy, Σy² at col, +1
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int r = wm0 + mi * 16 + (lane >> 2) + hr * 8;
          float v0 = acc[mi][ni][2 * hr], v1 = acc[mi][ni][2 * hr + 1];
          if constexpr (EPI) {
            if (bias != nullptr) {
              v0 += b0;
              v1 += b1;
            }
            if (g.relu) {
              v0 = fmaxf(v0, 0.f);
              v1 = fmaxf(v1, 0.f);
            }
          }
          const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
          *reinterpret_cast<__nv_bfloat162*>(ytile + r * T::LDW + col) = v;
          if constexpr (STATS) {
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
        }
      if constexpr (STATS)
        nas3d::moments_warp_put<BN>(red, wm, wn0 + ni * 8, mom);
    }
    if constexpr (D2S) {   // row r = voxel (d, h, w): corner (2d, 2h, 2w)
      if (tid < kBM && m0 + tid < g.V) {
        const int m = m0 + tid, hw = g.H * g.W;
        const int d = m / hw, rem = m - d * hw, h = rem / g.W;
        corner[tid] =
            ((2 * d * 2 * g.H + 2 * h) * 2 * g.W + 2 * (rem - h * g.W)) *
            g.cout;
      }
    }
    __syncthreads();
    if constexpr (STATS)
      nas3d::moments_block_put<BN, T::WM>(red, partial,
                                          (size_t)b * g.ntiles + t, n0, g.N);
    if constexpr (D2S) {
      // the tile's rows < V, columns < N, each at its corner + the
      // thread's column offset (yb: batch item b's 8*V*cout outputs).
      // The thread's column is the same in every row it stores (kThreads
      // is a multiple of the vectors or scalars per row); tap (kd, kh, kw)
      // lands kd planes, kh rows and kw voxels past the corner
      const int jcol = g.vec_y ? tid % (BN / 8) * 8 : tid % BN;
      const int n = n0 + jcol, tap = n / g.cout;
      const bool col_ok = n < g.N;
      const int coloff = (((tap >> 2) * 2 * g.H + ((tap >> 1) & 1)) * 2 *
                          g.W + (tap & 1)) * g.cout + (n - tap * g.cout);
      if (g.vec_y) {
        for (int r = tid / (BN / 8); r < kBM; r += kThreads / (BN / 8))
          if (m0 + r < g.V && col_ok)
            *reinterpret_cast<uint4*>(yb + corner[r] + coloff) =
                *reinterpret_cast<const uint4*>(ytile + r * T::LDW + jcol);
      } else {
        for (int r = tid / BN; r < kBM; r += kThreads / BN)
          if (m0 + r < g.V && col_ok)
            yb[corner[r] + coloff] = ytile[r * T::LDW + jcol];
      }
    } else if (g.vec_y) {  // the tile's rows < V, columns < N, to y
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

// --- the launch (host) -----------------------------------------------------

constexpr int kMaxDevices = 16;
constexpr int kMaxChunks = 64;

// The blocks of one instantiation that stay resident on the card at
// `nchunks` K chunks, into *out.  The first query on a device also sets
// the instantiation's shared-memory limit there to the most a block may
// have (so no later launch needs it raised); the count is kept per device
// and chunk count, so later launches ask the runtime nothing.
template <int BN, bool STATS, bool EPI, bool D2S>
int resident_blocks(int nchunks, size_t smem, int* out) {
  static std::atomic<int> known[kMaxDevices][kMaxChunks + 1];  // 0: unknown
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const bool keep = dev < kMaxDevices && nchunks <= kMaxChunks;
  if (keep && (*out = known[dev][nchunks].load(std::memory_order_relaxed)))
    return 0;
  const void* fn =
      reinterpret_cast<const void*>(gemm_mma_kernel<BN, STATS, EPI, D2S>);
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
template <int BN, bool STATS, bool EPI, bool D2S>
int launch_bn(const bf16* x, const bf16* w, const float* bias, bf16* y,
              float* partial, const Geom& g, int B, size_t smem,
              cudaStream_t st) {
  int resident = 0;
  const int e = resident_blocks<BN, STATS, EPI, D2S>(g.nchunks, smem,
                                                     &resident);
  if (e != 0) return e;
  const int ny = (g.N + BN - 1) / BN;
  const int nx = (resident + ny * B - 1) / (ny * B);
  const dim3 grid(nx < g.ntiles ? nx : g.ntiles, ny, B);
  gemm_mma_kernel<BN, STATS, EPI, D2S>
      <<<grid, kThreads, smem, st>>>(x, w, bias, y, partial, g);
  return (int)cudaGetLastError();
}

// The launch of one variant: g holds the shapes (V, K, N; EPI's relu;
// D2S's H, W, cout), the plan's side (chunks, tiles, vector copies) is
// filled in here.  STATS needs partial (B, ceil(V / 128), 2, N); D2S needs
// 8 * V * cout < 2^31 (offsets within a batch item are ints).  All
// tensors contiguous on the device of `st` (the current device).  Returns
// the launch's cudaError_t.  Each source instantiates only what it calls.
template <bool STATS, bool EPI, bool D2S>
int launch(const bf16* x, const bf16* w, const float* bias, bf16* y,
           float* partial, Geom g, int B, cudaStream_t st) {
  if (B < 1 || g.V < 1 || g.K < 1 || g.N < 1 ||
      (STATS && partial == nullptr) ||
      (D2S && (g.cout < 1 || g.N != 8 * g.cout ||
               (long long)g.V * g.N > INT_MAX)))
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(g.K, g.N, STATS, D2S);
  if (p.smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  g.nchunks = p.nchunks;
  g.ntiles = (g.V + kBM - 1) / kBM;
  // D2S: 8 columns are one tap's channels only where Cout % 8 == 0
  const int nvec = D2S ? g.cout : g.N;
  g.vec_x = g.K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  g.vec_w = nvec % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  g.vec_y = nvec % 8 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  switch (p.bn) {
    case 16: return launch_bn<16, STATS, EPI, D2S>(x, w, bias, y, partial, g,
                                                   B, p.smem, st);
    case 32: return launch_bn<32, STATS, EPI, D2S>(x, w, bias, y, partial, g,
                                                   B, p.smem, st);
    case 64: return launch_bn<64, STATS, EPI, D2S>(x, w, bias, y, partial, g,
                                                   B, p.smem, st);
    default: return launch_bn<128, STATS, EPI, D2S>(x, w, bias, y, partial,
                                                    g, B, p.smem, st);
  }
}

}  // namespace gmma
}  // namespace
