// Per-(batch, channel) sums for GroupNorm, one read of the volume each.
//
// Replaces (nas_3d_unet_tpu/ops/pallas/stats.py):
//   K5a moments_{f32,bf16}       <- moments (:65, body _moments_kernel :41):
//       (sum x, sum x^2), the forward statistics of a GroupNorm whose
//       producer emits no moments (ops/packed.py:744-770);
//   K5b weighted_sums_{f32,bf16} <- weighted_sums (:87, body
//       _weighted_kernel :48): (sum g, sum g*x), the two reductions of every
//       GroupNorm's backward (ops/packed.py:816-839);
//   and K3's two reductions (nas_3d_unet_tpu/ops/pallas/groupnorm.py), the
//       same functions on the use_pallas path: _lane_sums (:94, body
//       _sum_kernel :51) is K5a, and _grad_lane_sums (:109, body
//       _gsum_kernel :59) is K5b, with g masked by y > 0 when the ReLU was
//       fused: weighted_sums_masked_{f32,bf16}.
// All reduce a (B, V, C) tensor over V to (B, C) fp32 sums.
//
// What bounds them on the H100: bytes.  Each element is read once and
// costs 2 flops, far below the 20 flop/B balance of fp32, so the floor is
// the volume's bytes over 3.35 TB/s.  Most calls of a train step read
// under 35 MB (under 10 us at that rate), so the fixed cost of a call
// (launches, the cross-block sum, the host) weighs as much as the stream.
//
// What the design does about it: ONE launch a call, whose grid is sized by
// bytes (ops/stats.py `plan`, passed in and validated here).
//   - A block (span, channel tile, b) sums `rows` consecutive rows of its
//     tile's channels: at least SPAN_BYTES of one input, and no more blocks
//     than two an SM, so its partial (2 x channels doubles) is a small
//     share of what it reads.
//   - A thread loads VEC channels of a row in one 16-byte load (8 bf16 or
//     4 fp32) where C * element size is a multiple of 16 and every pointer
//     is 16-byte aligned; else VEC = 1, the same kernel with 2- or 4-byte
//     loads (odd C, or a view at an unaligned offset).  Threads run
//     channel-group fastest, so a warp's load is one contiguous run of 512
//     bytes when the block spans the row.  U rows (8; 4 for the masked
//     form's three inputs) are loaded together, then summed in fp32 in row
//     order and added to the thread's double sums, so U * inputs 16-byte
//     loads are in flight per thread and conversions to double stay 1 in
//     U rows.  (16 rows for K5a's one input spilled at 128 registers and
//     gained nothing.)
//   - The block's threads that share channels are summed by a fixed tree in
//     shared memory, and the block writes one double partial per (sum,
//     channel) of its tile: (B, nspan, 2, C), channel fastest.
//   - The cross-block sum runs in the same launch: after a barrier, one
//     thread of each block fences the block's partial (__threadfence) and
//     takes a ticket (atomicInc on the (b, tile) counter); the block that
//     draws the last ticket fences again and sums all nspan partials of
//     its (b, tile), read through L2 (__ldcg), in a fixed order, into out
//     (2, B, C) fp32.  atomicInc with
//     limit nspan - 1 wraps the counter back to 0 as that last ticket is
//     drawn, so a finished launch leaves every counter at 0: nothing is
//     re-zeroed from the host, and a CUDA graph can capture the call.
// The sums are the same bits run to run: every order is fixed by the plan,
// and the only atomic is on an integer ticket, never on a float.
//
// Streams: the counters are one static array per device, shared by every
// K5 launch.  Two launches on one stream run one after the other, so they
// never share a counter mid-flight; two K5 launches running at once on two
// streams of one device would.  The port launches every K5 call on the
// caller's current stream (ops/stats.py, via _cuda.run) and runs its
// passes on one stream; a caller that overlaps K5 calls on several streams
// must order them with events.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTickets = 4096;        // (b, tile) counters
// rows a thread has in flight: 8, or 4 for the masked form's 3 inputs
template <bool MASKED> constexpr int kUnroll = MASKED ? 4 : 8;

// zero at load; every finished launch leaves its counters at zero again
__device__ unsigned int g_tickets[kMaxTickets];

// the register type of one load of VEC elements
template <typename T, int VEC> struct Raw;
template <> struct Raw<float, 1> { using type = float; };
template <> struct Raw<float, 4> { using type = float4; };
template <> struct Raw<__nv_bfloat16, 1> { using type = unsigned short; };
template <> struct Raw<__nv_bfloat16, 8> { using type = uint4; };

template <typename T, int VEC>
__device__ __forceinline__ typename Raw<T, VEC>::type load(const T* p) {
  return __ldg(reinterpret_cast<const typename Raw<T, VEC>::type*>(p));
}

__device__ __forceinline__ void unpack(float r, float (&v)[1]) { v[0] = r; }

__device__ __forceinline__ void unpack(float4 r, float (&v)[4]) {
  v[0] = r.x;
  v[1] = r.y;
  v[2] = r.z;
  v[3] = r.w;
}

// bf16 -> fp32 is exact: the bf16 bits are the high half of the fp32 word
__device__ __forceinline__ void unpack(unsigned short r, float (&v)[1]) {
  v[0] = __uint_as_float(static_cast<unsigned>(r) << 16);
}

__device__ __forceinline__ void unpack(uint4 r, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(h[q]);
    v[2 * q] = f.x;
    v[2 * q + 1] = f.y;
  }
}

// sum of p[i * stride] over i = i0, i0 + di, ... below n, in that order,
// read through L2: kBatch loads in flight before any is added (a partial
// written by another block is an L2 hit, not a cheap one)
constexpr int kBatch = 16;

__device__ __forceinline__ double span_sum(const double* p, size_t stride,
                                           int i0, int di, int n) {
  double t = 0.0;
  for (int i = i0; i < n; i += kBatch * di) {
    double v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      v[k] = i + k * di < n ? __ldcg(p + (size_t)(i + k * di) * stride)
                            : 0.0;
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (i + k * di < n) t += v[k];
  }
  return t;
}

// WEIGHTED: sums of g and g*x; else of x and x*x (g unused).  MASKED
// (WEIGHTED only): g counts where y > 0.  Block (span, tile, b); thread
// tid = trow * cgt + cl sums channels [c0, c0 + VEC) of rows r0 + trow +
// m * tr, m >= 0, below r1.  partial: (B, nspan, 2, C) double; out: (2, B,
// C) fp32.
template <typename T, bool WEIGHTED, bool MASKED, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
stats_sums_kernel(const T* __restrict__ g, const T* __restrict__ x,
                  const T* __restrict__ y, float* __restrict__ out,
                  double* __restrict__ partial, int B, int V, int C,
                  int rows, int cgt, int tr) {
  constexpr int U = kUnroll<MASKED>;
  using R = typename Raw<T, VEC>::type;
  __shared__ double sh[2 * VEC * kThreads];    // [s][j][thread]
  __shared__ bool last;
  const int span = blockIdx.x, tile = blockIdx.y, b = blockIdx.z;
  const int nspan = gridDim.x;
  const int tid = threadIdx.x;
  const int cl = tid % cgt, trow = tid / cgt;
  const int cbase = tile * cgt * VEC;
  const int c0 = cbase + cl * VEC;
  const int r0 = span * rows;
  const int r1 = min(V, r0 + rows);

  double a1[VEC], a2[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) a1[j] = a2[j] = 0.0;
  if (trow < tr && c0 < C) {
    const size_t off = (size_t)b * V * C + c0;
    const T* xb = x + off;
    const T* gb = WEIGHTED ? g + off : nullptr;
    const T* yb = MASKED ? y + off : nullptr;
    for (int r = r0 + trow; r < r1; r += U * tr) {
      // U rows' loads in flight together, then summed in row order
      R rx[U], rg[U], ry[U];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int rr = r + k * tr;
        if (rr < r1) {
          const size_t o = (size_t)rr * C;
          rx[k] = load<T, VEC>(xb + o);
          if constexpr (WEIGHTED) rg[k] = load<T, VEC>(gb + o);
          if constexpr (MASKED) ry[k] = load<T, VEC>(yb + o);
        }
      }
      float f1[VEC], f2[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) f1[j] = f2[j] = 0.f;
#pragma unroll
      for (int k = 0; k < U; ++k) {
        if (r + k * tr >= r1) continue;
        float xv[VEC];
        unpack(rx[k], xv);
        if constexpr (WEIGHTED) {
          float gv[VEC];
          unpack(rg[k], gv);
          if constexpr (MASKED) {
            float yv[VEC];
            unpack(ry[k], yv);
#pragma unroll
            for (int j = 0; j < VEC; ++j)
              if (!(yv[j] > 0.f)) gv[j] = 0.f;
          }
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            f1[j] += gv[j];
            f2[j] = fmaf(gv[j], xv[j], f2[j]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            f1[j] += xv[j];
            f2[j] = fmaf(xv[j], xv[j], f2[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        a1[j] += (double)f1[j];
        a2[j] += (double)f2[j];
      }
    }
  }

  // the tr threads of each channel group, summed by a fixed tree: at each
  // step, row trow < step adds row trow + step
  if (trow < tr) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      sh[j * kThreads + tid] = a1[j];
      sh[(VEC + j) * kThreads + tid] = a2[j];
    }
  }
  int p = 1;
  while (p < tr) p <<= 1;
  for (int step = p >> 1; step > 0; step >>= 1) {
    __syncthreads();
    if (trow < step && trow + step < tr) {
      const int from = tid + step * cgt;
#pragma unroll
      for (int q = 0; q < 2 * VEC; ++q)
        sh[q * kThreads + tid] += sh[q * kThreads + from];
    }
  }
  __syncthreads();
  if (trow == 0 && c0 < C) {
    double* pb = partial + ((size_t)b * nspan + span) * 2 * C + c0;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      pb[j] = sh[j * kThreads + tid];
      pb[C + j] = sh[(VEC + j) * kThreads + tid];
    }
  }

  // the ticket: the block that draws the last one sums the partials.  One
  // thread fences for the block, as a grid barrier does: the barrier
  // orders the block's partial stores before its fence, the fence (a
  // cumulative one) before the ticket, and on the last block the second
  // fence orders the ticket before every thread's reads (through L2)
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    const unsigned t = atomicInc(&g_tickets[b * gridDim.y + tile],
                                 (unsigned)(nspan - 1));
    last = t == (unsigned)(nspan - 1);
    __threadfence();
  }
  __syncthreads();
  if (!last) return;

  // outputs o = s * ct + cc of this (b, tile), each the sum over spans in
  // a fixed order: with fewer outputs than threads, nsplit threads take
  // every nsplit-th span and their sums are added in split order
  const int ct = min(cgt * VEC, C - cbase);
  const int O = 2 * ct;
  const double* pb = partial + (size_t)b * nspan * 2 * C + cbase;
  if (O >= kThreads) {
    for (int o = tid; o < O; o += kThreads) {
      const int s = o / ct, cc = o - s * ct;
      const double t =
          span_sum(pb + (size_t)s * C + cc, 2 * (size_t)C, 0, 1, nspan);
      out[((size_t)s * B + b) * C + cbase + cc] = (float)t;
    }
    return;
  }
  const int nsplit = kThreads / O;
  const int o = tid % O, part = tid / O;
  const int s = o / ct, cc = o - s * ct;
  if (part < nsplit)
    sh[part * O + o] = span_sum(pb + (size_t)s * C + cc, 2 * (size_t)C,
                                part, nsplit, nspan);
  __syncthreads();
  if (tid < O) {
    double t = 0.0;
    for (int q = 0; q < nsplit; ++q) t += sh[q * O + o];
    out[((size_t)s * B + b) * C + cbase + cc] = (float)t;
  }
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

// Validates the plan it is given (ops/stats.py `plan`, the one place the
// tiling is decided) and launches once; a plan this kernel would not run
// as planned is refused.  buf: (2 + 4 * nspan, B, C) fp32: out (2, B, C),
// then the partials.
template <typename T, bool WEIGHTED, bool MASKED>
int launch(const T* g, const T* x, const T* y, float* buf, int B, int V,
           int C, int vec, int unroll, int cgt, int ctiles, int tr,
           int rows, int nspan, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kU = kUnroll<MASKED>;
  if (B < 1 || V < 1 || C < 1 || rows < 1 || nspan < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if ((vec != 1 && vec != kVec) || C % vec || unroll != kU)
    return (int)cudaErrorInvalidValue;
  // channel tiles of cgt groups of vec channels cover C, each tile's
  // groups once; the block's threads are kThreads / cgt rows of them
  const int cg = C / vec;
  if (cgt < 1 || cgt > kThreads || tr != kThreads / cgt || ctiles < 1 ||
      (long long)ctiles * cgt < cg || (long long)(ctiles - 1) * cgt >= cg)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * ctiles > kMaxTickets) return (int)cudaErrorInvalidValue;
  // spans of whole passes of U rows a thread cover V, none of them empty
  if (rows % (kU * tr) || (long long)nspan * rows < V ||
      (long long)(nspan - 1) * rows >= V)
    return (int)cudaErrorInvalidValue;
  if (vec > 1 && !(aligned16(g) && aligned16(x) && aligned16(y)))
    return (int)cudaErrorMisalignedAddress;
  double* partial = reinterpret_cast<double*>(buf + 2 * (size_t)B * C);
  if (reinterpret_cast<std::uintptr_t>(partial) & 7)
    return (int)cudaErrorMisalignedAddress;
  const dim3 grid(nspan, ctiles, B);
  if (vec == 1)
    stats_sums_kernel<T, WEIGHTED, MASKED, 1><<<grid, kThreads, 0, st>>>(
        g, x, y, buf, partial, B, V, C, rows, cgt, tr);
  else
    stats_sums_kernel<T, WEIGHTED, MASKED, kVec><<<grid, kThreads, 0, st>>>(
        g, x, y, buf, partial, B, V, C, rows, cgt, tr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K5a: x (B, V, C) in the element type -> buf rows 0, 1: s1 = sum x, s2 =
// sum x^2, (B, C) fp32; all contiguous, on the device of `stream`; the
// plan (vec ... nspan) is ops/stats.py `Plan`, in its field order.
#define NAS3D_MOMENTS(NAME, T)                                                \
  int NAME(const T* x, float* buf, int B, int V, int C, int vec, int unroll, \
           int cgt, int ctiles, int tr, int rows, int nspan, void* stream) {  \
    return launch<T, false, false>(nullptr, x, nullptr, buf, B, V, C, vec,    \
                                   unroll, cgt, ctiles, tr, rows, nspan,      \
                                   (cudaStream_t)stream);                     \
  }
NAS3D_MOMENTS(moments_f32, float)
NAS3D_MOMENTS(moments_bf16, __nv_bfloat16)
#undef NAS3D_MOMENTS

// K5b: g, x (B, V, C) in the element type -> r1 = sum g, r2 = sum g*x.
#define NAS3D_WEIGHTED(NAME, T)                                               \
  int NAME(const T* g, const T* x, float* buf, int B, int V, int C, int vec,  \
           int unroll, int cgt, int ctiles, int tr, int rows, int nspan,      \
           void* stream) {                                                    \
    return launch<T, true, false>(g, x, nullptr, buf, B, V, C, vec, unroll,   \
                                  cgt, ctiles, tr, rows, nspan,               \
                                  (cudaStream_t)stream);                      \
  }
NAS3D_WEIGHTED(weighted_sums_f32, float)
NAS3D_WEIGHTED(weighted_sums_bf16, __nv_bfloat16)
#undef NAS3D_WEIGHTED

// K3's backward sums with the ReLU fused: g, x, y (B, V, C) -> r1 = sum of
// g where y > 0, r2 = sum of g*x where y > 0.
#define NAS3D_MASKED(NAME, T)                                                 \
  int NAME(const T* g, const T* x, const T* y, float* buf, int B, int V,      \
           int C, int vec, int unroll, int cgt, int ctiles, int tr, int rows, \
           int nspan, void* stream) {                                         \
    return launch<T, true, true>(g, x, y, buf, B, V, C, vec, unroll, cgt,     \
                                 ctiles, tr, rows, nspan,                     \
                                 (cudaStream_t)stream);                       \
  }
NAS3D_MASKED(weighted_sums_masked_f32, float)
NAS3D_MASKED(weighted_sums_masked_bf16, __nv_bfloat16)
#undef NAS3D_MASKED

}  // extern "C"
