// The depthwise 3^3 SAME conv of SepConv, on NDHWC, fp32 or bf16: its
// forward, its adjoint in x (dx) and its weight gradient (dw), with fp32
// sums rounded once to the element type.
//
// Replaces no TPU kernel: the JAX package leaves this conv to XLA
// (nas_3d_unet_tpu/ops/primitives.py SepConv, ops/packed.py
// packed_depthwise3).  It replaces cuDNN's grouped conv, which ran it on a
// padded, permuted NCDHW view in a generic engine.
//
//   dw3_fwd_{f32,bf16}    y[o]  = sum_k x[s*o + k - p] * w[k]
//   dw3_dgrad_{f32,bf16}  dx[i] = sum over (o, k) with s*o + k - p = i of
//                         dy[o] * w[k]: at stride 1 the forward with the
//                         taps flipped and pads 2 - p; at stride 2 a
//                         gather of the 1 or 2 taps a dimension whose
//                         parity matches (dw3_dgrad_kernel); no atomics
//   dw3_wgrad_{f32,bf16}  fp32 partials, one (27, C) block a block, of
//                         dw[k] = sum_o x[s*o + k - p] * dy[o]
//   dw3_wsum_{f32,bf16}   their sum in a fixed order, rounded once to the
//                         element type
// (per dimension; the 27 taps k = (kd, kh, kw) are the product of the
// three).  Stride 1 or 2, any pads before (p) on each dimension, any batch
// and channel count; w is DHW1C, (27, C) contiguous.  Reads outside the
// input are zeros: the kernels mask the pad themselves.
//
// What bounds them on the H100: bytes.  Each element read costs 27 FMAs
// in fp32 (54 flops), under the 20 flop/B of the FMA pipes in fp32 and far
// under it in bf16; reading x once and writing y once is the floor.
//
// What the design does about it:
//   - Channels innermost: a block takes a slice of CS = 8 * CPT channels
//     (16 on the fast path), thread groups of CPT = 2 channels; the tile's
//     planes come in as 16-byte cp.async pieces (zero-filled outside the
//     input), where C is a multiple of 16 and every pointer is 16-byte
//     aligned; else the scalar path: CPT = 1, element loads, channel masks.
//   - Tiles: a block owns a tile of output rows and columns and
//     a run of output planes (a D chunk), and walks along D.  Each input
//     plane of its tile (with the 3^3 halo) is copied into shared memory
//     once, into a ring of NST planes kept NST - 1 planes ahead by cp.async.
//   - Rolling sums: a thread reads its 9 (kh, kw) inputs of a plane once
//     and forms the plane's three per-kd partial sums; they are added to
//     the output planes they belong to (1, 2 or 3 in flight), so each
//     input plane is read from shared memory once, not three times.
//   - The weights sit in registers (27 x CPT fp32) for the whole walk.
//   - dw: a block sums its (27, CS) partials over its threads (a fixed
//     shuffle tree, then warps in order) and writes them, fp32, to its row
//     of a workspace the wrapper allocates; dw3_wsum adds the rows in a
//     fixed order.  Every sum of every kernel has a fixed order: the bits
//     repeat from run to run.  No atomics, no tickets, no allocation, no
//     host sync: a CUDA graph captures every launch.
//
// The plan (D chunks, dw blocks) comes from the wrapper
// (nas_3d_unet_tpu_torch/ops/depthwise.py `plan`), which sizes the
// workspace by it; the launchers refuse one they would not run as given.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 2;                   // resident blocks an SM
constexpr int kRingBytes = 32768;               // planes in flight a block
constexpr int kCQ = 8;                          // channel groups a block
constexpr int kTWT = 8;                         // threads along W
constexpr int kTHT = kThreads / (kCQ * kTWT);   // threads along H: 4

struct Geo {
  int N, C;
  int id, ih, iw;       // the streamed tensor's D, H, W
  int od, oh, ow;       // the grid the threads own
  int pd, ph, pw;       // pads before, in the streamed tensor
  int nchunk;           // D chunks of the owned grid
};

// ring depth: about 32 KB of planes in flight a block, 3 to 8 planes
__host__ __device__ constexpr int ring(int tile_bytes) {
  return kRingBytes / tile_bytes + 1 < 3   ? 3
         : kRingBytes / tile_bytes + 1 > 8 ? 8
                                           : kRingBytes / tile_bytes + 1;
}

__device__ __forceinline__ int floordiv2(int v) { return v >> 1; }

// CPT elements of T, widened to fp32 (bf16 -> fp32 is exact: the high half)
__device__ __forceinline__ void widen(const float* p, float (&v)[1]) {
  v[0] = *p;
}
__device__ __forceinline__ void widen(const float* p, float (&v)[2]) {
  const float2 r = *reinterpret_cast<const float2*>(p);
  v[0] = r.x;
  v[1] = r.y;
}
__device__ __forceinline__ void widen(const __nv_bfloat16* p, float (&v)[1]) {
  const unsigned u = *reinterpret_cast<const unsigned short*>(p);
  v[0] = __uint_as_float(u << 16);
}
__device__ __forceinline__ void widen(const __nv_bfloat16* p, float (&v)[2]) {
  const unsigned u = *reinterpret_cast<const unsigned*>(p);
  v[0] = __uint_as_float(u << 16);
  v[1] = __uint_as_float(u & 0xffff0000u);
}

// the same from device memory, through the read-only path
__device__ __forceinline__ void widen_ldg(const float* p, float (&v)[1]) {
  v[0] = __ldg(p);
}
__device__ __forceinline__ void widen_ldg(const float* p, float (&v)[2]) {
  const float2 r = __ldg(reinterpret_cast<const float2*>(p));
  v[0] = r.x;
  v[1] = r.y;
}
__device__ __forceinline__ void widen_ldg(const __nv_bfloat16* p,
                                          float (&v)[1]) {
  const unsigned u = __ldg(reinterpret_cast<const unsigned short*>(p));
  v[0] = __uint_as_float(u << 16);
}
__device__ __forceinline__ void widen_ldg(const __nv_bfloat16* p,
                                          float (&v)[2]) {
  const unsigned u = __ldg(reinterpret_cast<const unsigned*>(p));
  v[0] = __uint_as_float(u << 16);
  v[1] = __uint_as_float(u & 0xffff0000u);
}

// fp32 sums rounded once to the element type
__device__ __forceinline__ void store(float* p, const float (&v)[1]) {
  *p = v[0];
}
__device__ __forceinline__ void store(float* p, const float (&v)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[1]) {
  *p = __float2bfloat16_rn(v[0]);
}
__device__ __forceinline__ void store(__nv_bfloat16* p, const float (&v)[2]) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One tile of R x Q voxels, channels c0..c0 + CS, of a plane of an
// (N, D, H, W, C) tensor, copied into sm [R][Q][CS]; zeros outside the
// tensor (rows, columns, planes pl >= `planes`).  V16: 16-byte cp.async
// pieces (C a multiple of CS, 16-byte aligned), each thread's pieces and
// their offsets worked out once (`init`), so that a plane's copy costs a
// few instructions a piece; else element loads, masked by channel too.
template <typename T, int CS, bool V16, int R, int Q>
struct Tile {
  static constexpr int kE = 16 / sizeof(T);            // elements a piece
  static constexpr int kPer = CS / kE;                 // pieces a voxel
  static constexpr int kMax = (R * Q * kPer + kThreads - 1) / kThreads;
  int soff[kMax], goff[kMax];
  unsigned ok = 0;
  int r0, q0, c0, H, W, C;

  __device__ __forceinline__ void init(int r0_, int q0_, int c0_, int H_,
                                       int W_, int C_) {
    r0 = r0_, q0 = q0_, c0 = c0_, H = H_, W = W_, C = C_;
    if constexpr (V16) {
#pragma unroll
      for (int i = 0; i < kMax; ++i) {
        const int e = threadIdx.x + i * kThreads;
        const int v = e / kPer, part = e - v * kPer;
        const int r = v / Q, q = v - r * Q;
        const int gr = r0 + r, gq = q0 + q;
        const bool in = e < R * Q * kPer && gr >= 0 && gr < H && gq >= 0 &&
                        gq < W;
        soff[i] = v * CS + part * kE;
        goff[i] = in ? (gr * W + gq) * C + c0 + part * kE : 0;
        ok |= (unsigned)in << i;
      }
    }
  }

  // plane pl of base (batch item n's (D, H, W, C)), planes pl >= planes
  // and pl < 0 read as zeros
  __device__ __forceinline__ void load(T* sm, const T* base, int pl,
                                       int planes) const {
    const bool pin = pl >= 0 && pl < planes;
    const T* pb = base + (size_t)(pin ? pl : 0) * H * W * C;
    if constexpr (V16) {
#pragma unroll
      for (int i = 0; i < kMax; ++i) {
        const int e = threadIdx.x + i * kThreads;
        if (e < R * Q * kPer) {
          const bool in = pin && ((ok >> i) & 1u);
          cp16(sm + soff[i], pb + goff[i], in);
        }
      }
    } else {
      for (int e = threadIdx.x; e < R * Q * CS; e += kThreads) {
        const int v = e / CS, ch = e - v * CS;
        const int r = v / Q, q = v - r * Q;
        const int gr = r0 + r, gq = q0 + q;
        const bool in = pin && gr >= 0 && gr < H && gq >= 0 && gq < W &&
                        c0 + ch < C;
        sm[e] = in ? pb[((size_t)gr * W + gq) * C + c0 + ch] : zero<T>();
      }
    }
  }
};

// the owned grid's D chunk `chunk`: [o0, o1)
__device__ __forceinline__ void chunk_of(const Geo& g, int chunk, int& o0,
                                         int& o1) {
  const int len = (g.od + g.nchunk - 1) / g.nchunk;
  o0 = chunk * len;
  o1 = min(g.od, o0 + len);
}

// the weights of channels c.. (27 x CPT fp32), reversed with flip
template <typename T, int CPT>
__device__ __forceinline__ void load_weights(float (&wr)[27][CPT],
                                             const T* w, int c, int C,
                                             int flip) {
#pragma unroll
  for (int k = 0; k < 27; ++k)
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      float v[1] = {0.f};
      if (c + j < C) widen_ldg(w + (flip ? 26 - k : k) * C + c + j, v);
      wr[k][j] = v[0];
    }
}

// The forward's and dw's tile of outputs: NH rows a thread at stride 1
// (its 4 x 3 inputs give 2 x 27 taps), one at stride 2
template <int S> struct FwdTile {
  static constexpr int NH = S == 1 ? 2 : 1;
  static constexpr int TH = kTHT * NH, TW = kTWT;
  static constexpr int R = (TH - 1) * S + 3, Q = (TW - 1) * S + 3;
};

// Forward (flip 0) and stride-1 dx (flip 1: the taps reversed).  Block
// (tile, channel slice, batch item x D chunk); thread (cq, tw, th) owns
// outputs (o, h0 + th * NH + u, w0 + tw), u < NH, channels c0 + cq *
// CPT.. of each output plane o of its chunk.  Input planes i = S*o0 - pd
// .. S*(o1 - 1) - pd + 2 stream through the ring; plane i's partial sum
// P_kd goes to output (i + pd - kd) / S where that divides.
template <typename T, int S, int CPT, bool V16>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dw3_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ y, Geo g, int flip) {
  using F = FwdTile<S>;
  constexpr int CS = kCQ * CPT, NH = F::NH, R = F::R, Q = F::Q;
  constexpr int NST = ring(R * Q * CS * (int)sizeof(T));
  __shared__ __align__(16) T sm[NST][R * Q * CS];

  const int tid = threadIdx.x;
  const int cq = tid % kCQ, tw = (tid / kCQ) % kTWT, th = tid / (kCQ * kTWT);
  const int tiles_w = (g.ow + F::TW - 1) / F::TW;
  const int h0 = (blockIdx.x / tiles_w) * F::TH;
  const int w0 = (blockIdx.x % tiles_w) * F::TW;
  const int c0 = blockIdx.y * CS, c = c0 + cq * CPT;
  const int n = blockIdx.z / g.nchunk;
  int o0, o1;
  chunk_of(g, blockIdx.z % g.nchunk, o0, o1);
  if (o0 >= o1) return;

  float wr[27][CPT];
  load_weights<T, CPT>(wr, w, c, g.C, flip);
  Tile<T, CS, V16, R, Q> tile;
  tile.init(S * h0 - g.ph, S * w0 - g.pw, c0, g.ih, g.iw, g.C);
  const T* xb = x + (size_t)n * g.id * g.ih * g.iw * g.C;
  const int i0 = S * o0 - g.pd;
  const int np = S * (o1 - o0) + 3 - S;
  const int ow = w0 + tw;
  bool mine[NH];
  T* yb[NH];
#pragma unroll
  for (int u = 0; u < NH; ++u) {
    const int oh = h0 + th * NH + u;
    mine[u] = oh < g.oh && ow < g.ow && c < g.C;
    yb[u] = y + (((size_t)n * g.od * g.oh + oh) * g.ow + ow) * g.C + c;
  }
  const size_t yplane = (size_t)g.oh * g.ow * g.C;

#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < np) tile.load(sm[s], xb, i0 + s, g.id);
    cp_commit();
  }
  float A[NH][CPT], B[NH][CPT];
#pragma unroll
  for (int u = 0; u < NH; ++u)
#pragma unroll
    for (int j = 0; j < CPT; ++j) A[u][j] = B[u][j] = 0.f;

  for (int p = 0; p < np; ++p) {
    cp_wait<NST - 2>();
    __syncthreads();
    if (p + NST - 1 < np)
      tile.load(sm[(p + NST - 1) % NST], xb, i0 + p + NST - 1, g.id);
    cp_commit();
    const T* t = sm[p % NST];
    // the thread's (NH + 2) x 3 inputs of the plane
    float v[NH + 2][3][CPT];
#pragma unroll
    for (int r = 0; r < NH + 2; ++r)
#pragma unroll
      for (int kw = 0; kw < 3; ++kw)
        widen(t + ((S * th * NH + r) * Q + S * tw + kw) * CS + cq * CPT,
              v[r][kw]);
    if constexpr (S == 1) {
      // plane i: P_2 completes output i + pd - 2 (o0 + p - 2)
#pragma unroll
      for (int u = 0; u < NH; ++u) {
        float P[3][CPT];
#pragma unroll
        for (int kd = 0; kd < 3; ++kd)
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            float a = 0.f;
#pragma unroll
            for (int kh = 0; kh < 3; ++kh)
#pragma unroll
              for (int kw = 0; kw < 3; ++kw)
                a = fmaf(wr[kd * 9 + kh * 3 + kw][j], v[u + kh][kw][j], a);
            P[kd][j] = a;
          }
        if (p >= 2 && mine[u]) {
          float out[CPT];
#pragma unroll
          for (int j = 0; j < CPT; ++j) out[j] = A[u][j] + P[2][j];
          store(yb[u] + (size_t)(o0 + p - 2) * yplane, out);
        }
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          A[u][j] = B[u][j] + P[1][j];
          B[u][j] = P[0][j];
        }
      }
    } else if ((p & 1) == 0) {
      // i + pd even: P_2 completes output o0 + p/2 - 1, P_0 opens o0 + p/2
      float P0[CPT], P2[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        float a = 0.f, b = 0.f;
#pragma unroll
        for (int kh = 0; kh < 3; ++kh)
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            a = fmaf(wr[kh * 3 + kw][j], v[kh][kw][j], a);
            b = fmaf(wr[18 + kh * 3 + kw][j], v[kh][kw][j], b);
          }
        P0[j] = a;
        P2[j] = b;
      }
      if (p >= 2 && mine[0]) {
        float out[CPT];
#pragma unroll
        for (int j = 0; j < CPT; ++j) out[j] = A[0][j] + P2[j];
        store(yb[0] + (size_t)(o0 + p / 2 - 1) * yplane, out);
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) A[0][j] = P0[j];
    } else {
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        float a = 0.f;
#pragma unroll
        for (int kh = 0; kh < 3; ++kh)
#pragma unroll
          for (int kw = 0; kw < 3; ++kw)
            a = fmaf(wr[9 + kh * 3 + kw][j], v[kh][kw][j], a);
        A[0][j] += a;
      }
    }
  }
}

// Stride-2 dx: dx[i] = sum over k with i + p - k even of dy[(i + p - k)/2]
// * w[k], per dimension.  Write i = 2m - p + r, r in {0, 1}: dx[2m - p] =
// w[0] dy[m] + w[2] dy[m - 1], dx[2m - p + 1] = w[1] dy[m].  So a thread
// owns dy position (m_h, m_w) of the grid MH x MW that covers dx, reads
// the 2 x 2 dy values (m_h - 1.., m_w - 1..) of a dy plane, and forms the
// 3 x 3 taps of its 2 x 2 dx positions, the same for every thread: no
// lane idles on a parity.  Along D dy plane q feeds dx planes 2q - pd +
// kd: T_0 completes 2q - pd (with plane q - 1's T_2), T_1 is all of 2q -
// pd + 1, T_2 opens 2q - pd + 2.  The streamed tensor is dy, the owned
// grid dx (D chunks of dx planes).
template <typename T, int CPT, bool V16>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dw3_dgrad_kernel(const T* __restrict__ dy, const T* __restrict__ w,
                 T* __restrict__ dx, Geo g) {
  constexpr int CS = kCQ * CPT;
  constexpr int TH = kTHT, TW = kTWT, R = TH + 1, Q = TW + 1;
  constexpr int NST = ring(R * Q * CS * (int)sizeof(T));
  __shared__ __align__(16) T sm[NST][R * Q * CS];

  const int tid = threadIdx.x;
  const int cq = tid % kCQ, tw = (tid / kCQ) % kTWT, th = tid / (kCQ * kTWT);
  const int mw_n = (g.ow + g.pw + 1) / 2;
  const int tiles_w = (mw_n + TW - 1) / TW;
  const int m0h = (blockIdx.x / tiles_w) * TH, m0w = (blockIdx.x % tiles_w) * TW;
  const int c0 = blockIdx.y * CS, c = c0 + cq * CPT;
  const int n = blockIdx.z / g.nchunk;
  int i0, i1;
  chunk_of(g, blockIdx.z % g.nchunk, i0, i1);
  if (i0 >= i1) return;

  float wr[27][CPT];
  load_weights<T, CPT>(wr, w, c, g.C, 0);
  Tile<T, CS, V16, R, Q> tile;
  tile.init(m0h - 1, m0w - 1, c0, g.ih, g.iw, g.C);
  const int q_lo = floordiv2(i0 + g.pd - 1);
  const int np = floordiv2(i1 - 1 + g.pd) - q_lo + 1;
  const T* db = dy + (size_t)n * g.id * g.ih * g.iw * g.C;
  // dx positions (2 m - p + r) of the thread's rows and columns
  const int hr0 = 2 * (m0h + th) - g.ph, wr0 = 2 * (m0w + tw) - g.pw;
  bool mine[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
      mine[a][b] = hr0 + a >= 0 && hr0 + a < g.oh && wr0 + b >= 0 &&
                   wr0 + b < g.ow && c < g.C;
  // (hr0 or wr0 may be -1: the pointer is used only where `mine` holds)
  T* xb = dx + (((ptrdiff_t)n * g.od * g.oh + hr0) * g.ow + wr0) * g.C + c;
  const ptrdiff_t xplane = (ptrdiff_t)g.oh * g.ow * g.C;
  const ptrdiff_t xrow = (ptrdiff_t)g.ow * g.C;

#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < np) tile.load(sm[s], db, q_lo + s, g.id);
    cp_commit();
  }
  float Cr[2][2][CPT];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int j = 0; j < CPT; ++j) Cr[a][b][j] = 0.f;

  for (int p = 0; p < np; ++p) {
    cp_wait<NST - 2>();
    __syncthreads();
    if (p + NST - 1 < np)
      tile.load(sm[(p + NST - 1) % NST], db, q_lo + p + NST - 1, g.id);
    cp_commit();
    const T* t = sm[p % NST];
    // v[a][b] = dy(m_h - 1 + a, m_w - 1 + b)
    float v[2][2][CPT];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b)
        widen(t + ((th + a) * Q + tw + b) * CS + cq * CPT, v[a][b]);
    const int pa = 2 * (q_lo + p) - g.pd;    // the plane T_0 completes
#pragma unroll
    for (int kd = 0; kd < 3; ++kd) {
#pragma unroll
      for (int rh = 0; rh < 2; ++rh)
#pragma unroll
        for (int rw = 0; rw < 2; ++rw) {
          float out[CPT];
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            // r = 0: taps 0 (dy m) and 2 (dy m - 1); r = 1: tap 1 (dy m)
            float a = 0.f;
#pragma unroll
            for (int kh = rh; kh < 3; kh += 2)
#pragma unroll
              for (int kw = rw; kw < 3; kw += 2)
                a = fmaf(wr[kd * 9 + kh * 3 + kw][j],
                         v[kh == 2 ? 0 : 1][kw == 2 ? 0 : 1][j], a);
            out[j] = a;
          }
          if (kd == 0) {
#pragma unroll
            for (int j = 0; j < CPT; ++j) out[j] += Cr[rh][rw][j];
            if (mine[rh][rw] && pa >= i0 && pa < i1)
              store(xb + pa * xplane + rh * xrow + rw * g.C, out);
          } else if (kd == 1) {
            if (mine[rh][rw] && pa + 1 >= i0 && pa + 1 < i1)
              store(xb + (pa + 1) * xplane + rh * xrow + rw * g.C, out);
          } else {
#pragma unroll
            for (int j = 0; j < CPT; ++j) Cr[rh][rw][j] = out[j];
          }
        }
    }
  }
}

// dw partials.  Block (b, channel slice) takes work items it = b, b +
// gridDim.x, ... of (tile, batch item x D chunk), in that order; thread
// (cq, tw, th) owns dy positions (o, h0 + th * NH + u, w0 + tw) and sums x
// * dy into acc[k] over its items.  x planes and dy planes stream through
// one ring (a stage: an x plane and, at stride 1 each and at stride 2
// every other, a dy plane); a dy value stays in registers for the 3 (or
// 2) x planes it meets.  part: (gridDim.x, 27, C) fp32.
template <typename T, int S, int CPT, bool V16>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dw3_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                 float* __restrict__ part, Geo g) {
  using F = FwdTile<S>;
  constexpr int CS = kCQ * CPT, NH = F::NH, TH = F::TH, TW = F::TW;
  constexpr int R = F::R, Q = F::Q;
  constexpr int XB = R * Q * CS, YB = TH * TW * CS;    // a stage: x, dy
  constexpr int NST = ring((XB + YB) * (int)sizeof(T));
  constexpr int kRing = NST * (XB + YB) * (int)sizeof(T);
  constexpr int kWarps = kThreads / 32;
  constexpr int kRed = kWarps * 27 * CS * (int)sizeof(float);
  __shared__ __align__(16) unsigned char raw[kRing > kRed ? kRing : kRed];
  T* const sm = reinterpret_cast<T*>(raw);

  const int tid = threadIdx.x;
  const int cq = tid % kCQ, tw = (tid / kCQ) % kTWT, th = tid / (kCQ * kTWT);
  const int tiles_w = (g.ow + TW - 1) / TW;
  const int tiles = tiles_w * ((g.oh + TH - 1) / TH);
  const int items = tiles * g.N * g.nchunk;
  const int c0 = blockIdx.y * CS, c = c0 + cq * CPT;

  float acc[27][CPT];
#pragma unroll
  for (int k = 0; k < 27; ++k)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[k][j] = 0.f;

  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int tile_i = it % tiles, z = it / tiles;
    const int h0 = (tile_i / tiles_w) * TH, w0 = (tile_i % tiles_w) * TW;
    const int n = z / g.nchunk;
    int o0, o1;
    chunk_of(g, z % g.nchunk, o0, o1);
    if (o0 >= o1) continue;
    Tile<T, CS, V16, R, Q> xt;
    xt.init(S * h0 - g.ph, S * w0 - g.pw, c0, g.ih, g.iw, g.C);
    Tile<T, CS, V16, TH, TW> yt;
    yt.init(h0, w0, c0, g.oh, g.ow, g.C);
    const T* xb = x + (size_t)n * g.id * g.ih * g.iw * g.C;
    const T* yb = dy + (size_t)n * g.od * g.oh * g.ow * g.C;
    const int i0 = S * o0 - g.pd;
    const int np = S * (o1 - o0) + 3 - S;
    // stage s: x plane i0 + s and dy plane o0 + s / S (at stride 2 on even
    // s only); dy planes from o1 on read as zeros
    auto stage = [&](int s) {
      T* st = sm + (s % NST) * (XB + YB);
      xt.load(st, xb, i0 + s, g.id);
      if (S == 1 || (s & 1) == 0) yt.load(st + XB, yb, o0 + s / S, o1);
    };

    __syncthreads();      // the previous item's reads of the ring are done
#pragma unroll
    for (int s = 0; s < NST - 1; ++s) {
      if (s < np) stage(s);
      cp_commit();
    }
    // dy of planes o0 + p (kd 0), o0 + p - 1 (kd 1), o0 + p - 2 (kd 2) at
    // stride 1; at stride 2 the plane of kd 0 (and 1) and the one before
    float D[3][NH][CPT];
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int u = 0; u < NH; ++u)
#pragma unroll
        for (int j = 0; j < CPT; ++j) D[k][u][j] = 0.f;

    for (int p = 0; p < np; ++p) {
      cp_wait<NST - 2>();
      __syncthreads();
      if (p + NST - 1 < np) stage(p + NST - 1);
      cp_commit();
      const T* st = sm + (p % NST) * (XB + YB);
      if (S == 1 || (p & 1) == 0) {
#pragma unroll
        for (int u = 0; u < NH; ++u) {
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            D[2][u][j] = D[1][u][j];
            D[1][u][j] = D[0][u][j];
          }
          widen(st + XB + ((th * NH + u) * TW + tw) * CS + cq * CPT, D[0][u]);
        }
      }
      float v[NH + 2][3][CPT];
#pragma unroll
      for (int r = 0; r < NH + 2; ++r)
#pragma unroll
        for (int kw = 0; kw < 3; ++kw)
          widen(st + ((S * th * NH + r) * Q + S * tw + kw) * CS + cq * CPT,
                v[r][kw]);
      if constexpr (S == 1) {
#pragma unroll
        for (int k = 0; k < 9; ++k)
#pragma unroll
          for (int j = 0; j < CPT; ++j)
#pragma unroll
            for (int u = 0; u < NH; ++u) {
              const float xv = v[u + k / 3][k % 3][j];
              acc[k][j] = fmaf(xv, D[0][u][j], acc[k][j]);
              acc[9 + k][j] = fmaf(xv, D[1][u][j], acc[9 + k][j]);
              acc[18 + k][j] = fmaf(xv, D[2][u][j], acc[18 + k][j]);
            }
      } else if ((p & 1) == 0) {
        // kd 0 with dy plane o0 + p/2 (D[0]), kd 2 with the one before
#pragma unroll
        for (int k = 0; k < 9; ++k)
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            const float xv = v[k / 3][k % 3][j];
            acc[k][j] = fmaf(xv, D[0][0][j], acc[k][j]);
            acc[18 + k][j] = fmaf(xv, D[1][0][j], acc[18 + k][j]);
          }
      } else {
#pragma unroll
        for (int k = 0; k < 9; ++k)
#pragma unroll
          for (int j = 0; j < CPT; ++j)
            acc[9 + k][j] =
                fmaf(v[k / 3][k % 3][j], D[0][0][j], acc[9 + k][j]);
      }
    }
  }

  // the block's sum over its threads of each channel: lanes cq + 8m of a
  // warp by a fixed shuffle tree, then the warps in order
  __syncthreads();      // the last item's reads of the ring are done
  float* red = reinterpret_cast<float*>(raw);   // [warp][27][CS]
  const int lane = tid % 32, warp = tid / 32;
#pragma unroll
  for (int k = 0; k < 27; ++k)
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      float a = acc[k][j];
      a += __shfl_xor_sync(0xffffffffu, a, 16);
      a += __shfl_xor_sync(0xffffffffu, a, 8);
      if (lane < kCQ) red[(warp * 27 + k) * CS + cq * CPT + j] = a;
    }
  __syncthreads();
  for (int e = tid; e < 27 * CS; e += kThreads) {
    const int k = e / CS, ch = e - k * CS;
    float s = 0.f;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) s += red[(wp * 27 + k) * CS + ch];
    if (c0 + ch < g.C)
      part[((size_t)blockIdx.x * 27 + k) * g.C + c0 + ch] = s;
  }
}

// dw[o] = sum over rows b of part[b][o], o < 27 * C: 8 threads an output,
// thread g taking rows g, g + 8, ..., then the 8 in order; rounded once.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dw3_wsum_kernel(const float* __restrict__ part, T* __restrict__ dw, int rows,
                int n_out) {
  __shared__ float sh[kThreads / 32][32];
  const int lane = threadIdx.x % 32, grp = threadIdx.x / 32;
  const int o = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (o < n_out)
    for (int b = grp; b < rows; b += kThreads / 32)
      s += __ldg(part + (size_t)b * n_out + o);
  sh[grp][lane] = s;
  __syncthreads();
  if (grp == 0 && o < n_out) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < kThreads / 32; ++q) t += sh[q][lane];
    const float v[1] = {t};
    store(dw + o, v);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

// the checks every launcher makes: shapes, the plan, the fast path's
// conditions
int check(const Geo& g, int vec, const void* a, const void* b,
          const void* c) {
  if (g.N < 1 || g.C < 1 || g.id < 1 || g.ih < 1 || g.iw < 1 || g.od < 1 ||
      g.oh < 1 || g.ow < 1 || g.nchunk < 1 || g.nchunk > g.od)
    return (int)cudaErrorInvalidValue;
  if ((long long)g.N * g.nchunk > 65535) return (int)cudaErrorInvalidValue;
  if (vec != 0 && vec != 1) return (int)cudaErrorInvalidValue;
  if (vec && (g.C % (2 * kCQ) || !aligned16(a) || !aligned16(b) ||
              !aligned16(c)))
    return (int)cudaErrorMisalignedAddress;
  return 0;
}

// the grid of a kernel whose blocks tile rows x cols of the owned grid
dim3 grid_of(const Geo& g, int rows, int cols, int th, int tw, int cs) {
  return dim3(((rows + th - 1) / th) * ((cols + tw - 1) / tw),
              (g.C + cs - 1) / cs, g.N * g.nchunk);
}

template <typename T, int S, int CPT, bool V16>
void fwd(const T* x, const T* w, T* y, const Geo& g, int flip,
         cudaStream_t st) {
  using F = FwdTile<S>;
  dw3_fwd_kernel<T, S, CPT, V16>
      <<<grid_of(g, g.oh, g.ow, F::TH, F::TW, kCQ * CPT), kThreads, 0, st>>>(
          x, w, y, g, flip);
}

template <typename T>
int launch_fwd(const T* x, const T* w, T* y, Geo g, int stride, int flip,
               int vec, cudaStream_t st) {
  if (int e = check(g, vec, x, w, y)) return e;
  if (stride == 1) {
    if (vec) fwd<T, 1, 2, true>(x, w, y, g, flip, st);
    else fwd<T, 1, 1, false>(x, w, y, g, flip, st);
  } else if (stride == 2) {
    if (vec) fwd<T, 2, 2, true>(x, w, y, g, flip, st);
    else fwd<T, 2, 1, false>(x, w, y, g, flip, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T, int CPT, bool V16>
void dgrad2(const T* dy, const T* w, T* dx, const Geo& g, cudaStream_t st) {
  // the dy positions that cover dx: (size + pad + 1) / 2 a dimension
  dw3_dgrad_kernel<T, CPT, V16>
      <<<grid_of(g, (g.oh + g.ph + 1) / 2, (g.ow + g.pw + 1) / 2, kTHT,
                 kTWT, kCQ * CPT),
         kThreads, 0, st>>>(dy, w, dx, g);
}

template <typename T>
int launch_dgrad(const T* dy, const T* w, T* dx, Geo g, int stride, int vec,
                 cudaStream_t st) {
  if (stride == 1) {
    // the forward of dy with the taps flipped: pads 2 - p
    g.pd = 2 - g.pd;
    g.ph = 2 - g.ph;
    g.pw = 2 - g.pw;
    return launch_fwd<T>(dy, w, dx, g, 1, 1, vec, st);
  }
  if (stride != 2) return (int)cudaErrorInvalidValue;
  if (int e = check(g, vec, dy, w, dx)) return e;
  if (vec) dgrad2<T, 2, true>(dy, w, dx, g, st);
  else dgrad2<T, 1, false>(dy, w, dx, g, st);
  return (int)cudaGetLastError();
}

template <typename T, int S, int CPT, bool V16>
int wgrad(const T* x, const T* dy, float* part, const Geo& g, int nblk,
          cudaStream_t st) {
  using F = FwdTile<S>;
  const dim3 grid = grid_of(g, g.oh, g.ow, F::TH, F::TW, kCQ * CPT);
  // every block takes at least one item
  if (nblk < 1 || (long long)nblk > (long long)grid.x * grid.z)
    return (int)cudaErrorInvalidValue;
  dw3_wgrad_kernel<T, S, CPT, V16>
      <<<dim3(nblk, grid.y), kThreads, 0, st>>>(x, dy, part, g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wgrad(const T* x, const T* dy, float* part, Geo g, int stride,
                 int vec, int nblk, cudaStream_t st) {
  if (int e = check(g, vec, x, dy, part)) return e;
  if (stride == 1)
    return vec ? wgrad<T, 1, 2, true>(x, dy, part, g, nblk, st)
               : wgrad<T, 1, 1, false>(x, dy, part, g, nblk, st);
  if (stride == 2)
    return vec ? wgrad<T, 2, 2, true>(x, dy, part, g, nblk, st)
               : wgrad<T, 2, 1, false>(x, dy, part, g, nblk, st);
  return (int)cudaErrorInvalidValue;
}

Geo geo(int N, int C, int D, int H, int W, int OD, int OH, int OW, int pd,
        int ph, int pw, int nchunk) {
  return Geo{N, C, D, H, W, OD, OH, OW, pd, ph, pw, nchunk};
}

}  // namespace

extern "C" {

// y = DW(x, w): x (N, D, H, W, C), w (27, C), y (N, OD, OH, OW, C); pads
// before (pd, ph, pw); vec 1 takes the 16-byte path; nchunk D chunks.
#define NAS3D_DW3_FWD(NAME, T)                                                \
  int NAME(const T* x, const T* w, T* y, int N, int C, int D, int H, int W,   \
           int OD, int OH, int OW, int stride, int pd, int ph, int pw,        \
           int vec, int nchunk, void* stream) {                               \
    return launch_fwd<T>(x, w, y, geo(N, C, D, H, W, OD, OH, OW, pd, ph, pw,  \
                                      nchunk),                                \
                         stride, 0, vec, (cudaStream_t)stream);               \
  }
NAS3D_DW3_FWD(dw3_fwd_f32, float)
NAS3D_DW3_FWD(dw3_fwd_bf16, __nv_bfloat16)
#undef NAS3D_DW3_FWD

// dx = DWT(dy, w): the forward's shapes (x (N, D, H, W, C), dy (N, OD, OH,
// OW, C)) and pads; nchunk D chunks of dx.
#define NAS3D_DW3_DGRAD(NAME, T)                                              \
  int NAME(const T* dy, const T* w, T* dx, int N, int C, int D, int H,       \
           int W, int OD, int OH, int OW, int stride, int pd, int ph, int pw, \
           int vec, int nchunk, void* stream) {                               \
    return launch_dgrad<T>(dy, w, dx, geo(N, C, OD, OH, OW, D, H, W, pd, ph,  \
                                          pw, nchunk),                        \
                           stride, vec, (cudaStream_t)stream);                \
  }
NAS3D_DW3_DGRAD(dw3_dgrad_f32, float)
NAS3D_DW3_DGRAD(dw3_dgrad_bf16, __nv_bfloat16)
#undef NAS3D_DW3_DGRAD

// part = the dw partials of DWW(x, dy), (nblk, 27, C) fp32: the forward's
// shapes and pads; nchunk D chunks of dy, nblk blocks a channel slice.
#define NAS3D_DW3_WGRAD(NAME, T)                                              \
  int NAME(const T* x, const T* dy, float* part, int N, int C, int D, int H, \
           int W, int OD, int OH, int OW, int stride, int pd, int ph, int pw, \
           int vec, int nchunk, int nblk, void* stream) {                     \
    return launch_wgrad<T>(x, dy, part, geo(N, C, D, H, W, OD, OH, OW, pd,    \
                                            ph, pw, nchunk),                  \
                           stride, vec, nblk, (cudaStream_t)stream);          \
  }
NAS3D_DW3_WGRAD(dw3_wgrad_f32, float)
NAS3D_DW3_WGRAD(dw3_wgrad_bf16, __nv_bfloat16)
#undef NAS3D_DW3_WGRAD

// dw = the rows of part summed in order, (27, C) in the element type.
#define NAS3D_DW3_WSUM(NAME, T)                                               \
  int NAME(const float* part, T* dw, int rows, int n_out, void* stream) {     \
    if (rows < 1 || n_out < 1) return (int)cudaErrorInvalidValue;             \
    dw3_wsum_kernel<T><<<(n_out + 31) / 32, kThreads, 0,                      \
                         (cudaStream_t)stream>>>(part, dw, rows, n_out);      \
    return (int)cudaGetLastError();                                           \
  }
NAS3D_DW3_WSUM(dw3_wsum_f32, float)
NAS3D_DW3_WSUM(dw3_wsum_bf16, __nv_bfloat16)
#undef NAS3D_DW3_WSUM

}  // extern "C"
