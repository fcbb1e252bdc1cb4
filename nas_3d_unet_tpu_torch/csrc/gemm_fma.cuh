// The fp32 voxel-row GEMM on the FMA units, behind three kernels:
//   K2 fp32 (pgemm.cu gemm_stats_f32): y (B, V, N) = x (B, V, K) @ w (K,
//      N), with each tile's Σy and Σy² of the stored y (the GroupNorm
//      moments; flag STATS);
//   K7 fp32 (conv3d.cu pointwise_conv_f32): the same product with an fp32
//      bias added to the fp32 sum, then a ReLU (flag EPI);
//   K4 fp32 (conv3d.cu conv_transpose2x_f32): x (B, D, H, W, Cin) @ the
//      DHWIO kernel read as (Cin, 8 Cout), ReLU (EPI), stored
//      depth-to-space into (B, 2D, 2H, 2W, Cout) (flag D2S).
// fp32 in, fp32 sums, fp32 y; no TF32.
//
// Replaces (nas_3d_unet_tpu/ops/pallas/), in fp32: pgemm.py:311
// gemm_stats (body _gemm_kernel :287, pallas_call :330), conv3d.py:279
// pointwise_conv (body _pointwise_kernel :251, pallas_call :314) and
// conv3d.py:356 conv_transpose2x (body _transpose2x_kernel :338,
// pallas_call :394).
//
// What bounds them on the H100: the bytes, at the shapes that matter.  A
// voxel row does 2*K*N flops for (K + N) * 4 bytes: 6 to 10 flop/B at 48
// -> 16 and 48 -> 32 over 128^3 (three quarters of K2's bound), 4 at K7's
// 16 -> 16, 3.6 at K4's 16 -> 8 x 16 into 128^3, against the card's fp32
// balance of ~20 (67 TFLOP/s of FMA against 3.35 TB/s).  Only 192 -> 128,
// 192 -> 64 and 384 -> 64, at 32^3 and 16^3, and K4's 64 -> 8 x 64 lean
// on the FMA rate.  K4's output is 8x its input: at 16 -> 16 into 128^3,
// 268 of its 302 MB.  The FMA template these replace staged 8-deep K
// slices through registers with scalar loads, one tile per block, and
// stored y one scalar at a time (K4: 21 % of its bound, measured on the
// H100).
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
//     SM, else 4 (or fewer where w is large) with one.  D2S stages the
//     DHWIO kernel as it is: column (kd*4 + kh*2 + kw)*Cout + co is tap
//     w[1-kd, 1-kh, 1-kw, :, co], lax's flip, so the caller builds no
//     flipped copy.
//   - Inner loop, per pair of K: a thread reads TM float2 of x (its rows
//     are a stage row of 80 bytes apart: 8 consecutive rows fall in
//     distinct bank groups) and 2 x TN floats of w (16-byte vectors a warp
//     reads contiguously), for 2 x TM x TN FMAs: 2.7 FMAs a float read
//     from shared memory at 8 x 4 and 4 x 8, 4 at 8 x 8.
//   - The summation order is the template's: one fp32 accumulator per
//     output, fmaf over k in increasing order (the zero padding past K
//     adds +0), no split-K; then the bias, then the ReLU.  So y is the
//     same bits as the template's.
//   - Epilogue: the tile's y goes to shared memory, then out in 16-byte
//     vectors, or scalars where N (D2S: Cout) is not a multiple of 4 or
//     the base is misaligned; rows past V and columns past N are not
//     stored.  Rows store as one run of rows x N floats (the tile's rows
//     are contiguous in y).  D2S stores row (d, h, w)'s column n = tap *
//     Cout + co at (2d + kd, 2h + kh, 2w + kw, co): the kw = 0 and 1 taps
//     of one (kd, kh) are 2*Cout contiguous floats, and the next w of the
//     same (d, h) line continues them, so each (kd, kh) the block owns
//     and each line of the tile's rows is one contiguous span of 2*W*Cout
//     floats.  The block's columns go out in runs of R = gcd(2*Cout, BN)
//     (a power of two, 2*Cout at every K4 shape of the path), each run's
//     rows in order, so consecutive threads write consecutive 16-byte
//     vectors of one span; each row's output corner is computed once per
//     tile into shared memory.  STATS: each thread sums its rows'
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
#include <climits>

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

// w (all chunks), the x stages, the epilogue's y tile, then STATS' warp
// rows or D2S's row corners
inline size_t plan_smem(int bn, int nchunks, int stages, bool stats,
                        bool d2s) {
  return ((size_t)nchunks * kKC * bn + (size_t)stages * tile_rows(bn) * kLdX +
          (size_t)tile_rows(bn) * bn + (stats ? kWarps * 2 * bn : 0)) *
             sizeof(float) +
         (d2s ? (size_t)tile_rows(bn) * sizeof(int) : 0);
}

inline Plan make_plan(int k, int n, bool stats, bool d2s) {
  Plan p;
  p.bn = n <= 16 ? 16 : n <= 32 ? 32 : n <= 64 ? 64 : 128;
  p.bm = tile_rows(p.bn);
  p.nchunks = (k + kKC - 1) / kKC;
  p.stages = 0;
  for (int s = 4; s >= 3 && !p.stages; --s)
    if (plan_smem(p.bn, p.nchunks, s, stats, d2s) <= (size_t)kSmemTwoBlocks)
      p.stages = s;
  for (int s = 4; s >= 2 && !p.stages; --s)
    if (plan_smem(p.bn, p.nchunks, s, stats, d2s) <= (size_t)kSmemMax)
      p.stages = s;
  if (!p.stages) p.stages = 2;   // w does not fit: the launch refuses it
  p.smem = plan_smem(p.bn, p.nchunks, p.stages, stats, d2s);
  return p;
}

// tiles of V rows: the row count of K2's moments partials per batch item
inline int tiles(int v, int n) {
  const int bm = tile_rows(make_plan(1, n, true, false).bn);
  return (v + bm - 1) / bm;
}

struct Geom {
  int V, K, N;
  int nchunks, stages, ntiles;   // the plan's side
  int vec_x, vec_w, vec_y;       // 16-byte copies for x, w; 16-byte stores
  int relu;                      // EPI
  int H, W, cout;                // D2S: V = D*H*W input voxels, N = 8*cout
  int run_shift;                 // D2S: log2 of the store's run, in floats
};

// --- the kernel ------------------------------------------------------------

// Block (x, y, z) takes the tiles x, x + gridDim.x, ... of batch item z,
// columns [y * BN, y * BN + BN); its (tile, chunk) steps run through one
// ring of g.stages x stages, so copies run g.stages - 1 steps ahead across
// tile boundaries.  STATS: partial (B, ntiles, 2, N), one row per tile.
// EPI: bias (N,) fp32 or null, added before the ReLU (g.relu).  D2S: w is
// the DHWIO kernel (2, 2, 2, K, cout), y (B, 2D, 2H, 2W, cout).  Registers
// for two blocks an SM (128 a thread), but at BN = 128, whose 8 x 8 tile
// would spill there and whose w and y tile keep one block an SM at the
// path's shapes (measured on the H100: 0.1167 against 0.1265 ms at 192 ->
// 128 over 32^3, no spill at 168 registers).
template <int BN, bool STATS, bool EPI, bool D2S>
__global__ void __launch_bounds__(kThreads, BN == 128 ? 1 : 2)
gemm_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ y,
                float* __restrict__ partial, const Geom g) {
  constexpr int TN = tile_n(BN), TM = tile_m(BN);
  constexpr int TX = BN / TN;           // threads along N
  constexpr int TY = kThreads / TX;     // thread rows
  constexpr int BM = TY * TM;
  static_assert(!(STATS && D2S), "the corners sit where the moments do");
  using nas3d::cp_async16_zfill;
  using nas3d::cp_async4_zfill;
  extern __shared__ __align__(16) float smem[];
  float* const ws = smem;                              // K chunks x BN
  float* const xs0 = ws + g.nchunks * kKC * BN;        // stages x BM x kLdX
  float* const ytile = xs0 + g.stages * BM * kLdX;     // BM x BN
  float* const red = ytile + BM * BN;                  // kWarps x 2 x BN
  int* const corner = reinterpret_cast<int*>(red);     // D2S: BM
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int n0 = blockIdx.y * BN, b = blockIdx.z;
  const float* const xb = x + (size_t)b * g.V * g.K;
  float* const yb = y + (size_t)b * g.V * g.N;
  const int nsteps =
      (g.ntiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x *
      g.nchunks;

  // w rows [0, 16 * nchunks) x columns [n0, n0 + BN), zero past K and N.
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
    constexpr int VPR = BN / 4;
    for (int i = tid; i < g.nchunks * kKC * VPR; i += kThreads) {
      const int k = i / VPR, j = i - k * VPR, n = n0 + j * 4;
      const bool ok = k < g.K && n < g.N;
      cp_async16_zfill(ws + k * BN + j * 4, ok ? w + w_at(k, n) : w, ok);
    }
  } else {
    for (int i = tid; i < g.nchunks * kKC * BN; i += kThreads) {
      const int k = i / BN, n = n0 + i - k * BN;
      const bool ok = k < g.K && n < g.N;
      cp_async4_zfill(ws + i, ok ? w + w_at(k, n) : w, ok);
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
    // into shared memory, (STATS) each thread's moments of its rows < V,
    // (D2S) each row's output corner
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
    if constexpr (D2S) {   // row r = voxel (d, h, w): corner (2d, 2h, 2w)
      for (int r = tid; r < nrows; r += kThreads) {
        const int m = m0 + r, hw = g.H * g.W;
        const int d = m / hw, rem = m - d * hw, h = rem / g.W;
        corner[r] =
            ((2 * d * 2 * g.H + 2 * h) * 2 * g.W + 2 * (rem - h * g.W)) *
            g.cout;
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
    const int ncols = min(BN, g.N - n0);
    if constexpr (D2S) {
      // the tile's rows < V, the block's columns in runs of R = 2^run_shift
      // (R divides 2*cout and BN: a run never crosses a (kd, kh) pair), run
      // by run, each run's rows in order, each row's R floats in order.  A
      // run from column n of pair pr = n / (2*cout) = kd*2 + kh lands kd
      // planes and kh rows past each row's corner; the pair's kw = 0 and 1
      // taps lie side by side, so its column j lands j floats further, and
      // the next row of a line continues where the row's 2*cout floats end.
      // yb: batch item b's 8*V*cout outputs
      const int run = 1 << g.run_shift, two_c = 2 * g.cout;
      for (int c0 = 0; c0 < ncols; c0 += run) {
        const int n = n0 + c0, pr = n / two_c;
        float* const yq =
            yb + ((pr >> 1) * 2 * g.H + (pr & 1)) * 2 * g.W * g.cout +
            (n - pr * two_c);
        const float* const tq = ytile + c0;
        if (g.vec_y) {   // 16-byte vectors: run / 4 a row
          const int sh = g.run_shift - 2, jm = (1 << sh) - 1;
          for (int f = tid; f < nrows << sh; f += kThreads) {
            const int r = f >> sh, j = (f & jm) * 4;
            *reinterpret_cast<float4*>(yq + corner[r] + j) =
                *reinterpret_cast<const float4*>(tq + r * BN + j);
          }
        } else {
          for (int f = tid; f < nrows << g.run_shift; f += kThreads) {
            const int r = f >> g.run_shift, j = f & (run - 1);
            yq[corner[r] + j] = tq[r * BN + j];
          }
        }
      }
    } else {
      // the tile's rows < V, columns [n0, n0 + ncols): one run of rows x N
      // floats where the block covers N
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
      reinterpret_cast<const void*>(gemm_fma_kernel<BN, STATS, EPI, D2S>);
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

// One wave: at most as many blocks as stay resident on the card (each
// walks over tiles), at least one per (column block, batch item), at most
// one per tile.  Rounding the blocks along V down, not up, matters where
// ny * B does not divide the resident count: K4's 64 -> 8 x 64 at 16^3
// (ny * B = 8, 132 resident), where rounding up left 4 blocks to a second
// wave that held the whole launch back (measured on the H100)
template <int BN, bool STATS, bool EPI, bool D2S>
int launch_bn(const float* x, const float* w, const float* bias, float* y,
              float* partial, const Geom& g, int B, size_t smem,
              cudaStream_t st) {
  int resident = 0;
  const int e =
      resident_blocks<BN, STATS, EPI, D2S>(g.nchunks, smem, &resident);
  if (e != 0) return e;
  const int ny = (g.N + BN - 1) / BN;
  const int nx = resident / (ny * B) > 1 ? resident / (ny * B) : 1;
  const dim3 grid(nx < g.ntiles ? nx : g.ntiles, ny, B);
  gemm_fma_kernel<BN, STATS, EPI, D2S>
      <<<grid, kThreads, smem, st>>>(x, w, bias, y, partial, g);
  return (int)cudaGetLastError();
}

// The launch of one variant: g holds the shapes (V, K, N; EPI's relu;
// D2S's H, W, cout), the plan's side (chunks, stages, tiles, vector
// copies, D2S's store run) is filled in here.  STATS needs partial (B,
// tiles(V, N), 2, N); D2S needs 8 * V * cout < 2^31 (offsets within a
// batch item are ints).  All tensors contiguous on the device of `st` (the
// current device).  Returns the launch's cudaError_t.  Each source
// instantiates only what it calls.
template <bool STATS, bool EPI, bool D2S>
int launch(const float* x, const float* w, const float* bias, float* y,
           float* partial, Geom g, int B, cudaStream_t st) {
  if (B < 1 || g.V < 1 || g.K < 1 || g.N < 1 ||
      (STATS && partial == nullptr) ||
      (D2S && (g.cout < 1 || g.N != 8 * g.cout ||
               (long long)g.V * g.N > INT_MAX)))
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(g.K, g.N, STATS, D2S);
  if (p.smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  g.nchunks = p.nchunks;
  g.stages = p.stages;
  g.ntiles = (g.V + p.bm - 1) / p.bm;
  // D2S: 4 columns are one tap's channels only where cout % 4 == 0; the
  // store's run is gcd(2 * cout, BN), a power of two since BN is one
  const int nvec = D2S ? g.cout : g.N;
  g.vec_x = g.K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  g.vec_w = nvec % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  g.vec_y = nvec % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  g.run_shift = 0;
  while (D2S && (1 << (g.run_shift + 1)) <= p.bn &&
         (2 * g.cout) % (1 << (g.run_shift + 1)) == 0)
    ++g.run_shift;
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

}  // namespace gfma
}  // namespace
