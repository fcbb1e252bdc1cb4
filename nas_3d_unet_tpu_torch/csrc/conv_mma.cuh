// The bf16 3^3 conv on the tensor cores, behind K1 bf16 (pgemm.cu
// conv3x3x3_stats_bf16, with the GroupNorm moments), K1-dx (pgemm.cu
// conv3x3x3_bf16) and K6 in bf16 (conv3d.cu conv3d_bf16): NDHWC x (B, D,
// H, W, Cin), DHWIO w (3, 3, 3, Cin, Cout), stride 1 or 2, dilation 1 or
// 2, lax's low-side pads (pd, ph, pw), optional fp32 bias and ReLU; bf16
// operands, fp32 accumulation, y (B, Do, Ho, Wo, Cout) rounded once to
// bf16; with STATS also each block's Σy and Σy² of the rounded y.
//
// Replaces (nas_3d_unet_tpu/):
//   ops/pallas/pgemm.py:174 conv_pgemm (body _kernel :74, pallas_call :252)
//     in bf16 with its moments epilogue, stride 1, pad = dilation: K1;
//   ops/pallas/pgemm.py:174 conv_pgemm as the dx of ops/packed.py:491-504
//     runs it (with_stats=False, on dy with the flip-transposed kernel,
//     stride 1, pad = dilation): K1-dx;
//   ops/pallas/conv3d.py:201 conv3d (body _conv3d_kernel :51, pallas_call
//     :172) in bf16: K6, every stride, dilation and epilogue it takes.
//
// What bounds it on the H100: at the train step's shapes (chip_smoke.py's
// K1_TRAIN, K1DX_TRAIN, P_K6) the bytes, 0.61 ms (K1), 0.47 ms (K1-dx) and
// 0.74 ms (K6) per step at 3.35 TB/s, against 0.45, 0.41 and 0.56 ms of
// flops at the tensor cores' 989 TFLOP/s; the narrow levels (16 and 32
// channels, ~79 % of the flops) give a block little arithmetic per staged
// byte, and K1's stem (Cin 4) fills 4 of each MMA's 16 K columns.  The FMA
// tile this replaces (igemm.cuh) ran ~11-12 TFLOP/s, under the 67 TFLOP/s
// fp32 ceiling, and read each input voxel 27 times through a bounds test
// per element.
//
// What the design does about it (set by the E2 probe, probes.cu: short-K
// MMAs over an input staged once beat a folded K; 128-row tiles beat 32):
//   - One block owns a brick of BM = BD x 8 x 8 output voxels (BD = 4 at
//     BN = 16, else 2) and BN output channels (16/32/64/128 as Cout asks,
//     halved where the stage would not fit 227 KB); 8 warps, each 32 rows x
//     BN / (8 / (BM / 32)) columns of mma.sync m16n8k16 accumulators.
//   - The input halo brick ((BD-1)*s + 2*dil + 1) x ((8-1)*s + 2*dil + 1)^2
//     voxels is staged into shared memory once per 16-channel chunk, for all
//     27 taps, by cp.async 16-byte copies that zero-fill outside the volume
//     and past Cin (a Cin not a multiple of 8, or a misaligned x, takes a
//     scalar copy instead: the zero-padding is the same).  The chunk's
//     27 x 16 x BN weight slices are staged beside it the same way.
//   - Each tap is one K = 16 product over the brick, no im2col: ldmatrix
//     takes one row address per lane, so the A fragment of tap (kd, kh, kw)
//     is read straight from the brick at each output voxel's shifted halo
//     position (48-byte rows: ldmatrix's 8 rows fall in distinct banks at
//     stride 1); B comes from the weight slice by ldmatrix.trans.
//   - Two chunks' stages are double-buffered (the next one's copies in
//     flight under this one's MMAs) where both fit in half the SM's shared
//     memory, so two blocks stay resident; otherwise one stage, and the
//     second resident block overlaps the copies.
//   - Epilogue, one accumulator column at a time: fp32 bias and ReLU where
//     asked, one rounding to bf16, stores masked at the volume's ragged
//     edge and at Cout; with STATS the moments of the rounded values of
//     the stored rows and columns only, summed in the store loop (so only
//     four sums live beside the accumulators) and reduced in the fixed
//     order of moments.cuh into per-block partials.  No atomics: the same
//     bits on every launch.
// Simple first: no wgmma or TMA (later work).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "moments.cuh"

namespace {
namespace cmma {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;        // 8 warps
constexpr int kKC = 16;              // input channels per stage: one MMA K
constexpr int kLdX = kKC + 8;        // brick row, bf16: 48 bytes
constexpr int kTaps = 27;
constexpr int kBH = 8;               // output brick, H
constexpr int kBW = 8;               // and W
constexpr int kSmemMax = 232448;     // 227 KB: the most a block may have
constexpr int kSmemTwoBlocks = 113 * 1024;   // two such blocks fit an SM

// BM output voxels (a BD x 8 x 8 brick) x BN output channels per block;
// warps: WM along M (32 rows each), WN along N
template <int BN>
struct Tile {
  static constexpr int BD = BN == 16 ? 4 : 2;
  static constexpr int BM = BD * kBH * kBW;
  static constexpr int WM = BM / 32;
  static constexpr int WN = 8 / WM;
  static constexpr int MI = 2;                // 16-row MMA tiles per warp
  static constexpr int NI = BN / WN / 8;      // 8-column MMA tiles per warp
  static constexpr int LDW = BN + 8;          // weight row, bf16
};

struct Geom {
  int D, H, W, Cin, Cout;     // input volume and channels
  int Do, Ho, Wo;             // output volume
  int stride, dil, pd, ph, pw;
  int HH, HW, halo;           // halo brick's H and W, its voxel count
  int nbh, nbw;               // bricks along H and W
  int nchunks;                // 16-channel chunks of Cin
  int nbuf;                   // stages in shared memory: 1 or 2
  int vec_x, vec_w;           // 16-byte copies for x, for w
  int relu;
};

// --- the plan (host), mirrored by ops/conv_mma.py:plan --------------------

inline int brick_depth(int bn) { return bn == 16 ? 4 : 2; }

inline int halo_edge(int edge, int stride, int dil) {
  return (edge - 1) * stride + 2 * dil + 1;
}

inline size_t stage_bytes(int bn, int stride, int dil) {
  const size_t halo = (size_t)halo_edge(brick_depth(bn), stride, dil) *
                      halo_edge(kBH, stride, dil) * halo_edge(kBW, stride, dil);
  return (halo * kLdX + (size_t)kTaps * kKC * (bn + 8)) * sizeof(bf16);
}

struct Plan {
  int bn;        // output channels per block
  int bd;        // output brick depth (x 8 x 8)
  int nchunks;   // 16-channel chunks of Cin
  int nbuf;      // chunk stages in shared memory
  int hd, hh, hw;  // the halo brick
  size_t smem;   // bytes of shared memory per block
};

// BN the narrowest of 16/32/64/128 that covers Cout, halved while one
// stage would not fit; two stages where both fit half an SM
inline Plan make_plan(int cin, int cout, int stride, int dil) {
  Plan p;
  p.bn = cout <= 16 ? 16 : cout <= 32 ? 32 : cout <= 64 ? 64 : 128;
  while (p.bn > 32 && stage_bytes(p.bn, stride, dil) > (size_t)kSmemMax)
    p.bn /= 2;
  p.bd = brick_depth(p.bn);
  p.nchunks = (cin + kKC - 1) / kKC;
  const size_t stage = stage_bytes(p.bn, stride, dil);
  p.nbuf = p.nchunks > 1 && 2 * stage <= (size_t)kSmemTwoBlocks ? 2 : 1;
  p.hd = halo_edge(p.bd, stride, dil);
  p.hh = halo_edge(kBH, stride, dil);
  p.hw = halo_edge(kBW, stride, dil);
  p.smem = p.nbuf * stage;
  return p;
}

// --- the kernel ------------------------------------------------------------

// STATS: also the moments of the rounded y, per block, into partial (B,
// gridDim.x, 2, Cout) (moments.cuh); otherwise partial is unused.
template <int BN, bool STATS>
__global__ void __launch_bounds__(kThreads, BN == 128 ? 1 : 2)
conv_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const float* __restrict__ bias, bf16* __restrict__ y,
                float* __restrict__ partial, const Geom g) {
  using T = Tile<BN>;
  using nas3d::cp_async16_zfill;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const stages = reinterpret_cast<bf16*>(smem);
  const int stage_elems = g.halo * kLdX + kTaps * kKC * T::LDW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm0 = (warp / T::WN) * 32;
  const int wn0 = (warp % T::WN) * (BN / T::WN);

  // this block's brick: output corner, input (halo) corner
  int bx = blockIdx.x;
  const int bw = bx % g.nbw;
  bx /= g.nbw;
  const int bh = bx % g.nbh;
  const int od0 = (bx / g.nbh) * T::BD, oh0 = bh * kBH, ow0 = bw * kBW;
  const int id0 = od0 * g.stride - g.pd, ih0 = oh0 * g.stride - g.ph;
  const int iw0 = ow0 * g.stride - g.pw;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const bf16* const xb = x + (size_t)b * g.D * g.H * g.W * g.Cin;

  // chunk c (input channels [16c, 16c + 16)): the halo brick, then the 27
  // taps' 16 x BN weight slices, zero outside the volume, past Cin and
  // past Cout; one cp.async group (the scalar copies land at once)
  auto load = [&](int c, bf16* st) {
    const int ci0 = c * kKC;
    bf16* const xs = st;
    bf16* const ws = st + g.halo * kLdX;
    const int plane = g.HH * g.HW;
    if (g.vec_x) {
      for (int i = tid; i < g.halo * 2; i += kThreads) {
        const int v = i >> 1, ci = ci0 + (i & 1) * 8;
        const int vd = v / plane, rem = v - vd * plane;
        const int vh = rem / g.HW;
        const int d = id0 + vd, h = ih0 + vh, ww = iw0 + rem - vh * g.HW;
        const bool ok = d >= 0 && d < g.D && h >= 0 && h < g.H && ww >= 0 &&
                        ww < g.W && ci < g.Cin;
        const bf16* src =
            ok ? xb + (((size_t)d * g.H + h) * g.W + ww) * g.Cin + ci : xb;
        cp_async16_zfill(xs + v * kLdX + (i & 1) * 8, src, ok);
      }
    } else {
      const unsigned short* xu = reinterpret_cast<const unsigned short*>(xb);
      unsigned short* xsu = reinterpret_cast<unsigned short*>(xs);
      for (int i = tid; i < g.halo * kKC; i += kThreads) {
        const int v = i / kKC, k = i - v * kKC, ci = ci0 + k;
        const int vd = v / plane, rem = v - vd * plane;
        const int vh = rem / g.HW;
        const int d = id0 + vd, h = ih0 + vh, ww = iw0 + rem - vh * g.HW;
        const bool ok = d >= 0 && d < g.D && h >= 0 && h < g.H && ww >= 0 &&
                        ww < g.W && ci < g.Cin;
        xsu[v * kLdX + k] =
            ok ? __ldg(xu + (((size_t)d * g.H + h) * g.W + ww) * g.Cin + ci)
               : (unsigned short)0;
      }
    }
    if (g.vec_w) {
      constexpr int VPR = BN / 8;          // 16-byte vectors per slice row
      for (int i = tid; i < kTaps * kKC * VPR; i += kThreads) {
        const int row = i / VPR, j = i - row * VPR;   // row = tap * 16 + k
        const int t = row / kKC, ci = ci0 + row - t * kKC, co = n0 + j * 8;
        const bool ok = ci < g.Cin && co < g.Cout;
        const bf16* src =
            ok ? w + ((size_t)t * g.Cin + ci) * g.Cout + co : w;
        cp_async16_zfill(ws + row * T::LDW + j * 8, src, ok);
      }
    } else {
      const unsigned short* wu = reinterpret_cast<const unsigned short*>(w);
      unsigned short* wsu = reinterpret_cast<unsigned short*>(ws);
      for (int i = tid; i < kTaps * kKC * BN; i += kThreads) {
        const int row = i / BN, j = i - row * BN;
        const int t = row / kKC, ci = ci0 + row - t * kKC, co = n0 + j;
        wsu[row * T::LDW + j] =
            ci < g.Cin && co < g.Cout
                ? __ldg(wu + ((size_t)t * g.Cin + ci) * g.Cout + co)
                : (unsigned short)0;
      }
    }
    nas3d::cp_async_commit();
  };

  // the halo index of this lane's A row (row lane & 15 of each 16-row
  // tile) at tap (0, 0, 0); tap (kd, kh, kw) adds dil * ((kd * HH + kh) *
  // HW + kw)
  int hb[T::MI];
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi) {
    const int r = wm0 + mi * 16 + (lane & 15);
    const int rd = r / (kBH * kBW), rh = (r / kBW) % kBH, rw = r % kBW;
    hb[mi] = (rd * g.stride * g.HH + rh * g.stride) * g.HW + rw * g.stride;
  }
  const int col8 = (lane >> 4) * 8;   // ldmatrix: k (A) or n (B) half

  float acc[T::MI][T::NI][4];
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

  load(0, stages);
  for (int c = 0; c < g.nchunks; ++c) {
    const bf16* st = stages + (g.nbuf == 2 ? (c & 1) : 0) * stage_elems;
    if (g.nbuf == 2 && c + 1 < g.nchunks) {
      load(c + 1, stages + ((c + 1) & 1) * stage_elems);
      nas3d::cp_async_wait<1>();       // chunk c has landed
    } else {
      nas3d::cp_async_wait<0>();
    }
    __syncthreads();                   // ... for every thread's copies
    const bf16* xs = st;
    const bf16* ws = st + g.halo * kLdX + wn0 + col8;
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      const int toff = g.dil * (((t / 9) * g.HH + (t / 3) % 3) * g.HW + t % 3);
      uint32_t bfr[T::NI / 2][4];      // n-tiles 2np, 2np + 1
#pragma unroll
      for (int np = 0; np < T::NI / 2; ++np)
        nas3d::ldsm_x4_trans(bfr[np],
                             ws + (t * kKC + (lane & 15)) * T::LDW + np * 16);
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi) {
        uint32_t a[4];
        nas3d::ldsm_x4(a, xs + (hb[mi] + toff) * kLdX + col8);
#pragma unroll
        for (int np = 0; np < T::NI / 2; ++np) {
          nas3d::mma_bf16(acc[mi][2 * np], a, bfr[np][0], bfr[np][1]);
          nas3d::mma_bf16(acc[mi][2 * np + 1], a, bfr[np][2], bfr[np][3]);
        }
      }
    }
    __syncthreads();                   // every warp is done with stage c
    if (g.nbuf == 1 && c + 1 < g.nchunks) load(c + 1, stages);
  }

  // epilogue: accumulator (mi, ni) holds rows lane/4 and lane/4 + 8 of its
  // 16-row tile at columns 2*(lane%4) and +1 of its 8-column tile.  This
  // thread's four rows: their output voxel in batch item b, or -1 past the
  // volume's ragged edge (neither stored nor summed)
  int vox[T::MI][2];
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = wm0 + mi * 16 + (lane >> 2) + hr * 8;
      const int od = od0 + r / (kBH * kBW), oh = oh0 + (r / kBW) % kBH;
      const int ow = ow0 + r % kBW;
      vox[mi][hr] = od < g.Do && oh < g.Ho && ow < g.Wo
                        ? (od * g.Ho + oh) * g.Wo + ow : -1;
    }
  bf16* const yb = y + (size_t)b * g.Do * g.Ho * g.Wo * g.Cout;
  // the stages are free once every warp has passed the loop's last
  // __syncthreads: the moments' warp rows go there
  float* const red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int ni = 0; ni < T::NI; ++ni) {
    const int n = n0 + wn0 + ni * 8 + 2 * (lane & 3);
    float b0 = 0.f, b1 = 0.f;
    if (bias != nullptr) {
      if (n < g.Cout) b0 = __ldg(bias + n);
      if (n + 1 < g.Cout) b1 = __ldg(bias + n + 1);
    }
    float mom[4] = {0.f, 0.f, 0.f, 0.f};   // STATS: Σy, Σy² at n, n + 1
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        if (vox[mi][hr] < 0) continue;
        float v0 = acc[mi][ni][2 * hr], v1 = acc[mi][ni][2 * hr + 1];
        if (bias != nullptr) {
          v0 += b0;
          v1 += b1;
        }
        if (g.relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        const __nv_bfloat162 r = __floats2bfloat162_rn(v0, v1);
        bf16* yrow = yb + (size_t)vox[mi][hr] * g.Cout;
        if (n + 1 < g.Cout && (g.Cout & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(yrow + n) = r;
        } else {
          if (n < g.Cout) yrow[n] = __low2bfloat16(r);
          if (n + 1 < g.Cout) yrow[n + 1] = __high2bfloat16(r);
        }
        if constexpr (STATS) {
          const float f0 = __low2float(r), f1 = __high2float(r);
          if (n < g.Cout) {
            mom[0] += f0;
            mom[2] += f0 * f0;
          }
          if (n + 1 < g.Cout) {
            mom[1] += f1;
            mom[3] += f1 * f1;
          }
        }
      }
    if constexpr (STATS)
      nas3d::moments_warp_put<BN>(red, warp / T::WN, wn0 + ni * 8, mom);
  }
  if constexpr (STATS) {
    __syncthreads();
    nas3d::moments_block_put<BN, T::WM>(
        red, partial, (size_t)b * gridDim.x + blockIdx.x, n0, g.Cout);
  }
}

// Blocks along blockIdx.x: the output bricks of one batch item (the row
// count of K1's moments partials, conv3d.cu conv_mma_blocks)
inline int grid_bricks(const Plan& p, int Do, int Ho, int Wo) {
  return ((Do + p.bd - 1) / p.bd) * ((Ho + kBH - 1) / kBH) *
         ((Wo + kBW - 1) / kBW);
}

template <int BN, bool STATS>
int launch_bn(const bf16* x, const bf16* w, const float* bias, bf16* y,
              float* partial, const Geom& g, int B, int nblk, size_t smem,
              cudaStream_t st) {
  const cudaError_t e = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(conv_mma_kernel<BN, STATS>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(nblk, (g.Cout + BN - 1) / BN, B);
  conv_mma_kernel<BN, STATS><<<grid, kThreads, smem, st>>>(x, w, bias, y,
                                                           partial, g);
  return (int)cudaGetLastError();
}

// Launch: x (B, D, H, W, Cin), w (3, 3, 3, Cin, Cout), bias (Cout,) fp32
// or null, y (B, ceil(D/stride), ceil(H/stride), ceil(W/stride), Cout);
// STATS: partial (B, grid_bricks, 2, Cout) fp32 gets each block's moments
// (otherwise unused, may be null); all contiguous on the device of `st`.
// Returns the launch's cudaError_t.
template <bool STATS>
int launch_conv_mma(const bf16* x, const bf16* w, const float* bias, bf16* y,
                    float* partial, int B, int D, int H, int W, int Cin,
                    int Cout, int stride, int dil, int pd, int ph, int pw,
                    int relu, cudaStream_t st) {
  if (B < 1 || D < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 ||
      stride < 1 || stride > 2 || dil < 1 || dil > 2 ||
      (STATS && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  Geom g{};
  g.D = D, g.H = H, g.W = W, g.Cin = Cin, g.Cout = Cout;
  g.Do = (D + stride - 1) / stride, g.Ho = (H + stride - 1) / stride;
  g.Wo = (W + stride - 1) / stride;
  g.stride = stride, g.dil = dil, g.pd = pd, g.ph = ph, g.pw = pw;
  const Plan p = make_plan(Cin, Cout, stride, dil);
  g.HH = p.hh, g.HW = p.hw, g.halo = p.hd * p.hh * p.hw;
  g.nbh = (g.Ho + kBH - 1) / kBH, g.nbw = (g.Wo + kBW - 1) / kBW;
  g.nchunks = p.nchunks, g.nbuf = p.nbuf;
  g.vec_x = Cin % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  g.vec_w = Cout % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  g.relu = relu;
  if (p.smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  const int nblk = grid_bricks(p, g.Do, g.Ho, g.Wo);
  switch (p.bn) {
    case 16:
      return launch_bn<16, STATS>(x, w, bias, y, partial, g, B, nblk, p.smem,
                                  st);
    case 32:
      return launch_bn<32, STATS>(x, w, bias, y, partial, g, B, nblk, p.smem,
                                  st);
    case 64:
      return launch_bn<64, STATS>(x, w, bias, y, partial, g, B, nblk, p.smem,
                                  st);
    default:
      return launch_bn<128, STATS>(x, w, bias, y, partial, g, B, nblk,
                                   p.smem, st);
  }
}

}  // namespace cmma
}  // namespace
