// The fp32 3^3 conv on the FMA units, behind K1 fp32 (pgemm.cu
// conv3x3x3_stats_f32, with the GroupNorm moments), K1-dx fp32 (pgemm.cu
// conv3x3x3_f32) and K6 in fp32 (conv3d.cu conv3d_f32): NDHWC x (B, D, H,
// W, Cin), DHWIO w (3, 3, 3, Cin, Cout), stride 1 or 2, dilation 1 or 2,
// lax's low-side pads (pd, ph, pw), optional fp32 bias and ReLU; fp32 in,
// fp32 sums, fp32 y (B, Do, Ho, Wo, Cout); with STATS also each block's
// Σy and Σy² of the stored y.
//
// Replaces (nas_3d_unet_tpu/), in fp32:
//   ops/pallas/pgemm.py:174 conv_pgemm (body _kernel :74, pallas_call :252)
//     with its moments epilogue, stride 1, pad = dilation: K1;
//   the same conv_pgemm as the dx of ops/packed.py:491-504 runs it
//     (with_stats=False, on dy with the flip-transposed kernel): K1-dx;
//   ops/pallas/conv3d.py:201 conv3d (body _conv3d_kernel :51, pallas_call
//     :172): K6, every stride, dilation and epilogue it takes.
//
// What bounds it on the H100: the operations.  The fp32 path is held to
// TF32-off numbers, so the ceiling is the FMA units' 67 TFLOP/s against
// 3.35 TB/s (~20 flop/B), and a 3^3 conv does 54*Cin flops per output
// value (108 flop/B at 16->16).  The job is to keep the FMA pipes fed from
// shared memory: one FFMA warp instruction per cycle per SM sub-partition,
// against one 128-byte shared-memory wavefront per cycle per SM.
//
// What the design does about it (conv_mma.cuh's structure, in fp32):
//   - One block (256 threads) owns a brick of BD x 8 x 8 output voxels and
//     BN output channels, BN = 16/32/64/128 covering Cout (the stem's 48
//     takes 64, its last 16 columns masked; Cout > 128 takes several column
//     blocks).  Each thread holds an 8 x TN register tile: the brick's 8
//     output voxels along W at one (d, h), times TN = 4 (BN <= 32) or 8
//     (BN >= 64) channels; BD = 256 / (BN / TN) / 8 (8, 4, 4, 2).
//   - The brick's input halo ((BD-1)*s + 2*dil + 1) x (7*s + 2*dil + 1)^2
//     voxels is staged into shared memory once per 4-channel chunk, for all
//     27 taps, by cp.async copies that zero-fill outside the volume and past
//     Cin: 16 bytes (one voxel's 4 channels) where Cin % 4 == 0 and x is
//     16-byte aligned, else 4 bytes.  A halo voxel is 4 floats; the W pitch
//     is odd, so the rows a warp reads fall in distinct banks at stride 1.
//     The chunk's 4 x 27 x BN weights are staged beside it the same way.
//   - Inner loop, per channel pair and (kd, kh): the thread reads its W row
//     segment of the halo once, 7*s + 2*dil + 1 float2 (both channels), and
//     reuses it for the three kw taps: 3 x 2 x 8 x TN FMAs per (7*s + 2*dil
//     + 1) x 2 + 6 x TN floats read (5.6 FMAs a float at s = 1, dil = 1,
//     TN = 8; 4.4 at TN = 4).  Stride, dilation and the halo's shape are
//     template constants, so every shared-memory offset in the loop is an
//     immediate and no integer division is left in it.
//   - Two chunks' stages are double-buffered (the next one's copies in
//     flight under this one's FMAs) where both fit in half the SM's shared
//     memory, so two blocks stay resident; otherwise one stage, and the
//     second resident block overlaps the copies.
//   - Epilogue: fp32 bias and ReLU where asked, stores masked at the
//     volume's ragged edge and at Cout (16-byte vectors where Cout % 4 ==
//     0); with STATS each thread sums Σy, Σy² of its stored values over its
//     8 voxels in W order, and the block's 8 x BD rows of threads are summed
//     in row order into per-block partials (B, nblk, 2, Cout), which
//     pgemm.cu's moments_reduce_kernel folds in double.  No atomics: the
//     same bits on every launch.
// Simple first: no TF32 or 3xTF32 (they would change the fp32 path's
// contract), no TMA.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {
namespace cfma {

constexpr int kThreads = 256;
constexpr int kKC = 4;               // input channels per stage
constexpr int kTaps = 27;
constexpr int kBH = 8;               // output brick, H
constexpr int kBW = 8;               // and W: a thread's row of voxels
constexpr int kSmemMax = 232448;     // 227 KB: the most a block may have
constexpr int kSmemTwoBlocks = 113 * 1024;   // two such blocks fit an SM

// --- the plan (host), mirrored by ops/conv_fma.py:plan --------------------

// a thread's channels, and the output brick's depth, for BN columns
__host__ __device__ constexpr int tile_n(int bn) { return bn >= 64 ? 8 : 4; }
__host__ __device__ constexpr int brick_depth(int bn) {
  return kThreads / (bn / tile_n(bn)) / kBH;
}
__host__ __device__ constexpr int halo_edge(int edge, int stride, int dil) {
  return (edge - 1) * stride + 2 * dil + 1;
}
// the halo's W extent in shared memory: odd, so a warp's rows (S * pitch
// voxels of 4 floats apart) spread over the banks
__host__ __device__ constexpr int halo_pitch(int stride, int dil) {
  return halo_edge(kBW, stride, dil) | 1;
}
__host__ __device__ constexpr int halo_voxels(int bn, int stride, int dil) {
  return halo_edge(brick_depth(bn), stride, dil) *
         halo_edge(kBH, stride, dil) * halo_pitch(stride, dil);
}
// floats of one chunk's stage: the halo (4 channels a voxel), the weights
__host__ __device__ constexpr int stage_floats(int bn, int stride, int dil) {
  return halo_voxels(bn, stride, dil) * kKC + kKC * kTaps * bn;
}

struct Plan {
  int bn;        // output channels per block
  int bd;        // output brick depth (x 8 x 8)
  int nchunks;   // 4-channel chunks of Cin
  int nbuf;      // chunk stages in shared memory
  size_t smem;   // bytes of shared memory per block
};

// BN the narrowest of 16/32/64/128 that covers Cout (every stage fits:
// the largest, BN 16 at stride 2 and dilation 2, is 116.6 KB); two stages
// where both fit half an SM
inline Plan make_plan(int cin, int cout, int stride, int dil) {
  Plan p;
  p.bn = cout <= 16 ? 16 : cout <= 32 ? 32 : cout <= 64 ? 64 : 128;
  p.bd = brick_depth(p.bn);
  p.nchunks = (cin + kKC - 1) / kKC;
  const size_t stage = (size_t)stage_floats(p.bn, stride, dil) * 4;
  p.nbuf = p.nchunks > 1 && 2 * stage <= (size_t)kSmemTwoBlocks ? 2 : 1;
  p.smem = p.nbuf * stage;
  return p;
}

struct Geom {
  int D, H, W, Cin, Cout;     // input volume and channels
  int Do, Ho, Wo;             // output volume
  int pd, ph, pw;             // low-side pads
  int nbh, nbw;               // bricks along H and W
  int nchunks, nbuf;
  int vec_x, vec_w, vec_y;    // 16-byte copies and stores
  int relu;
};

// --- the kernel ------------------------------------------------------------

// STATS: also the moments of y, per block, into partial (B, gridDim.x, 2,
// Cout); otherwise partial is unused.
template <int BN, int S, int DIL, bool STATS>
__global__ void __launch_bounds__(kThreads, 2)
conv_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ bias, float* __restrict__ y,
                float* __restrict__ partial, const Geom g) {
  constexpr int TN = tile_n(BN);
  constexpr int TX = BN / TN;                 // threads along N
  constexpr int TY = kThreads / TX;           // rows of 8 voxels
  constexpr int BD = brick_depth(BN);
  constexpr int HH = halo_edge(kBH, S, DIL);
  constexpr int HW = halo_edge(kBW, S, DIL);  // a thread's row segment
  constexpr int HWP = halo_pitch(S, DIL);
  constexpr int HALO = halo_voxels(BN, S, DIL);
  constexpr int STAGE = stage_floats(BN, S, DIL);
  static_assert(TY == BD * kBH, "one thread per brick row");
  static_assert(!STATS || 2 * TY * BN <= STAGE, "moments rows fit a stage");
  using nas3d::cp_async16_zfill;
  using nas3d::cp_async4_zfill;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int rd = ty / kBH, rh = ty % kBH;

  // this block's brick: output corner, input (halo) corner
  int bx = blockIdx.x;
  const int bw = bx % g.nbw;
  bx /= g.nbw;
  const int bh = bx % g.nbh;
  const int od0 = (bx / g.nbh) * BD, oh0 = bh * kBH, ow0 = bw * kBW;
  const int id0 = od0 * S - g.pd, ih0 = oh0 * S - g.ph, iw0 = ow0 * S - g.pw;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const float* const xb = x + (size_t)b * g.D * g.H * g.W * g.Cin;

  // chunk c (input channels [4c, 4c + 4)): the halo, then the 27 taps' 4 x
  // BN weights, zero outside the volume, past Cin and past Cout; one
  // cp.async group
  auto load = [&](int c, float* st) {
    const int ci0 = c * kKC;
    float* const xs = st;
    float* const ws = st + HALO * kKC;
    for (int v = tid; v < HALO; v += kThreads) {
      const int vd = v / (HH * HWP), rem = v - vd * (HH * HWP);
      const int vh = rem / HWP, vw = rem - vh * HWP;
      const int d = id0 + vd, h = ih0 + vh, ww = iw0 + vw;
      const bool in = vw < HW && d >= 0 && d < g.D && h >= 0 && h < g.H &&
                      ww >= 0 && ww < g.W;
      const float* src =
          in ? xb + (((size_t)d * g.H + h) * g.W + ww) * g.Cin + ci0 : x;
      if (g.vec_x) {
        cp_async16_zfill(xs + v * kKC, src, in && ci0 < g.Cin);
      } else {
#pragma unroll
        for (int k = 0; k < kKC; ++k) {
          const bool ok = in && ci0 + k < g.Cin;
          cp_async4_zfill(xs + v * kKC + k, ok ? src + k : x, ok);
        }
      }
    }
    if (g.vec_w) {
      constexpr int VPR = BN / 4;          // 16-byte vectors per weight row
      for (int i = tid; i < kKC * kTaps * VPR; i += kThreads) {
        const int row = i / VPR, j = i - row * VPR;   // row = k * 27 + tap
        const int k = row / kTaps, t = row - k * kTaps;
        const int ci = ci0 + k, co = n0 + j * 4;
        const bool ok = ci < g.Cin && co < g.Cout;
        cp_async16_zfill(ws + row * BN + j * 4,
                         ok ? w + ((size_t)t * g.Cin + ci) * g.Cout + co : w,
                         ok);
      }
    } else {
      for (int i = tid; i < kKC * kTaps * BN; i += kThreads) {
        const int row = i / BN, j = i - row * BN;
        const int k = row / kTaps, t = row - k * kTaps;
        const int ci = ci0 + k, co = n0 + j;
        const bool ok = ci < g.Cin && co < g.Cout;
        cp_async4_zfill(ws + i,
                        ok ? w + ((size_t)t * g.Cin + ci) * g.Cout + co : w,
                        ok);
      }
    }
    nas3d::cp_async_commit();
  };

  float acc[kBW][TN];
#pragma unroll
  for (int j = 0; j < kBW; ++j)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[j][n] = 0.f;

  // this thread's halo row at tap (0, 0, *), and its first weight column
  // (TN = 8: columns tx*4 .. +3 and BN/2 + tx*4 .. +3)
  const int xrow = ((rd * S) * HH + rh * S) * HWP * kKC;
  const int wcol = tx * 4;

  load(0, smem);
  for (int c = 0; c < g.nchunks; ++c) {
    const float* st = smem + (g.nbuf == 2 ? (c & 1) : 0) * STAGE;
    if (g.nbuf == 2 && c + 1 < g.nchunks) {
      load(c + 1, smem + ((c + 1) & 1) * STAGE);
      nas3d::cp_async_wait<1>();       // chunk c has landed
    } else {
      nas3d::cp_async_wait<0>();
    }
    __syncthreads();                   // ... for every thread's copies
    const float* const xs = st + xrow;
    const float* const ws = st + HALO * kKC + wcol;
    const int kc = min(kKC, g.Cin - c * kKC);   // channels past it are 0
    for (int p = 0; p < kc; p += 2) {
#pragma unroll
      for (int kd = 0; kd < 3; ++kd)
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
          // the row segment at (kd, kh): channels p, p + 1 of HW voxels
          const float* ar = xs + (kd * DIL * HH + kh * DIL) * HWP * kKC + p;
          float2 a[HW];
#pragma unroll
          for (int i = 0; i < HW; ++i)
            a[i] = *reinterpret_cast<const float2*>(ar + i * kKC);
#pragma unroll
          for (int kw = 0; kw < 3; ++kw)
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const float* wr = ws + ((p + q) * kTaps + (kd * 3 + kh) * 3 + kw)
                                         * BN;
              float bv[TN];
              const float4 b0 = *reinterpret_cast<const float4*>(wr);
              bv[0] = b0.x, bv[1] = b0.y, bv[2] = b0.z, bv[3] = b0.w;
              if constexpr (TN == 8) {
                const float4 b1 = *reinterpret_cast<const float4*>(wr + BN / 2);
                bv[4] = b1.x, bv[5] = b1.y, bv[6] = b1.z, bv[7] = b1.w;
              }
#pragma unroll
              for (int j = 0; j < kBW; ++j) {
                const float2 av = a[j * S + kw * DIL];
                const float an = q ? av.y : av.x;
#pragma unroll
                for (int n = 0; n < TN; ++n)
                  acc[j][n] = fmaf(an, bv[n], acc[j][n]);
              }
            }
        }
    }
    __syncthreads();                   // every thread is done with stage c
    if (g.nbuf == 1 && c + 1 < g.nchunks) load(c + 1, smem);
  }

  // epilogue: this thread's row of output voxels, stored where inside the
  // volume and below Cout, bias and ReLU first
  const int od = od0 + rd, oh = oh0 + rh;
  const bool row_in = od < g.Do && oh < g.Ho;
  float* const yrow =
      y + ((((size_t)b * g.Do + od) * g.Ho + oh) * g.Wo + ow0) * g.Cout;
  float s1[TN], s2[TN];
#pragma unroll
  for (int half = 0; half < TN / 4; ++half) {
    const int col = n0 + half * (BN / 2) + wcol;   // its first of 4 columns
    float bv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      bv[k] = bias != nullptr && col + k < g.Cout ? __ldg(bias + col + k)
                                                  : 0.f;
      s1[half * 4 + k] = s2[half * 4 + k] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBW; ++j) {
      if (!row_in || ow0 + j >= g.Wo) continue;
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[k] = acc[j][half * 4 + k] + bv[k];
        if (g.relu) v[k] = fmaxf(v[k], 0.f);
      }
      float* const yv = yrow + (size_t)j * g.Cout + col;
      if (g.vec_y) {
        if (col < g.Cout)
          *reinterpret_cast<float4*>(yv) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (col + k < g.Cout) yv[k] = v[k];
      }
      if constexpr (STATS) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (col + k < g.Cout) {
            s1[half * 4 + k] += v[k];
            s2[half * 4 + k] += v[k] * v[k];
          }
      }
    }
  }
  if constexpr (STATS) {
    // the stages are free once every thread has passed the loop's last
    // __syncthreads: row ty of red holds this thread's sums at its columns
    float* const red = smem;
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const int c = (n / 4) * (BN / 2) + wcol + n % 4;
      red[(ty * 2) * BN + c] = s1[n];
      red[(ty * 2 + 1) * BN + c] = s2[n];
    }
    __syncthreads();
    if (tid < 2 * BN) {
      const int s = tid / BN, c = tid - s * BN;
      float t = 0.f;
      for (int r = 0; r < TY; ++r) t += red[(r * 2 + s) * BN + c];
      if (n0 + c < g.Cout)
        partial[(((size_t)b * gridDim.x + blockIdx.x) * 2 + s) * g.Cout +
                n0 + c] = t;
    }
  }
}

// Blocks along blockIdx.x: the output bricks of one batch item (the row
// count of K1's moments partials, pgemm.cu conv_fma_blocks)
inline int grid_bricks(const Plan& p, int Do, int Ho, int Wo) {
  return ((Do + p.bd - 1) / p.bd) * ((Ho + kBH - 1) / kBH) *
         ((Wo + kBW - 1) / kBW);
}

template <int BN, int S, int DIL, bool STATS>
int launch_tile(const float* x, const float* w, const float* bias, float* y,
                float* partial, const Geom& g, int B, int nblk, size_t smem,
                cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(conv_fma_kernel<BN, S, DIL, STATS>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(nblk, (g.Cout + BN - 1) / BN, B);
  conv_fma_kernel<BN, S, DIL, STATS><<<grid, kThreads, smem, st>>>(
      x, w, bias, y, partial, g);
  return (int)cudaGetLastError();
}

template <int S, int DIL, bool STATS>
int launch_bn(int bn, const float* x, const float* w, const float* bias,
              float* y, float* partial, const Geom& g, int B, int nblk,
              size_t smem, cudaStream_t st) {
  switch (bn) {
    case 16:
      return launch_tile<16, S, DIL, STATS>(x, w, bias, y, partial, g, B,
                                            nblk, smem, st);
    case 32:
      return launch_tile<32, S, DIL, STATS>(x, w, bias, y, partial, g, B,
                                            nblk, smem, st);
    case 64:
      return launch_tile<64, S, DIL, STATS>(x, w, bias, y, partial, g, B,
                                            nblk, smem, st);
    default:
      return launch_tile<128, S, DIL, STATS>(x, w, bias, y, partial, g, B,
                                             nblk, smem, st);
  }
}

// Launch at stride S: x (B, D, H, W, Cin), w (3, 3, 3, Cin, Cout), bias
// (Cout,) fp32 or null, y (B, ceil(D/S), ceil(H/S), ceil(W/S), Cout);
// STATS: partial (B, grid_bricks, 2, Cout) fp32 gets each block's moments
// (otherwise unused, may be null); all contiguous on the device of `st`.
// Returns the launch's cudaError_t.
template <int S, bool STATS>
int launch_conv_fma(const float* x, const float* w, const float* bias,
                    float* y, float* partial, int B, int D, int H, int W,
                    int Cin, int Cout, int dil, int pd, int ph, int pw,
                    int relu, cudaStream_t st) {
  if (B < 1 || D < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || dil < 1 ||
      dil > 2 || (STATS && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  Geom g{};
  g.D = D, g.H = H, g.W = W, g.Cin = Cin, g.Cout = Cout;
  g.Do = (D + S - 1) / S, g.Ho = (H + S - 1) / S, g.Wo = (W + S - 1) / S;
  g.pd = pd, g.ph = ph, g.pw = pw;
  const Plan p = make_plan(Cin, Cout, S, dil);
  g.nbh = (g.Ho + kBH - 1) / kBH, g.nbw = (g.Wo + kBW - 1) / kBW;
  g.nchunks = p.nchunks, g.nbuf = p.nbuf;
  g.vec_x = Cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  g.vec_w = Cout % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  g.vec_y = Cout % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  g.relu = relu;
  if (p.smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  const int nblk = grid_bricks(p, g.Do, g.Ho, g.Wo);
  if (dil == 1)
    return launch_bn<S, 1, STATS>(p.bn, x, w, bias, y, partial, g, B, nblk,
                                  p.smem, st);
  return launch_bn<S, 2, STATS>(p.bn, x, w, bias, y, partial, g, B, nblk,
                                p.smem, st);
}

}  // namespace cfma
}  // namespace
