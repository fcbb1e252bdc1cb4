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
// the volume's bytes over 3.35 TB/s.
//
// What the design does about it: the TPU kernel sums a tile's rows on the
// MXU and carries nothing across its sequential grid.  Here blocks run in
// no order, so each block sums one chunk of rows into per-block partials
// and a second small kernel sums the partials; both in a fixed order, so
// the sums are the same bits run to run with no atomics.  A thread sums 8
// rows at a time in fp32 and adds those to double sums (conversions to
// double stay 1 in 8 loads, below the card's conversion rate), and the
// partials are double, so a 2M-voxel sum keeps fp32 precision.  A
// block's threads are laid out channel-fastest (thread t reads channel
// t % cw of row t / cw), so when the block spans all C channels a warp's
// loads are one contiguous run of memory.  Enough chunks are made to put
// several blocks on every SM.  Simple first: no vector loads.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using nas3d::load_f32;

constexpr int kThreads = 256;
constexpr int kUnroll = 8;               // rows a thread has in flight
constexpr int kTargetBlocks = 132 * 8;   // SMs x blocks in flight per SM

// channel tiles: cw channels per block, ctiles tiles cover C
int channel_width(int C) {
  const int ctiles = (C + kThreads - 1) / kThreads;
  return (C + ctiles - 1) / ctiles;
}

// rows of one chunk: a multiple of the rows a block covers per pass
int chunk_rows(int B, int V, int C) {
  const int cw = channel_width(C);
  const int ctiles = (C + cw - 1) / cw;
  const int rb = kThreads / cw;
  const int passes = (V + rb - 1) / rb;
  int chunks = (kTargetBlocks + B * ctiles - 1) / (B * ctiles);
  if (chunks > passes) chunks = passes;
  const int per = (passes + chunks - 1) / chunks;
  return per * rb;
}

// partial: (B, nchunk, 2, C) double.  WEIGHTED: sums of g and g*x; else of
// x and x*x (g unused).  MASKED (WEIGHTED only): g counts where y > 0.
template <typename T, bool WEIGHTED, bool MASKED>
__global__ void __launch_bounds__(kThreads)
channel_sums_kernel(const T* __restrict__ g, const T* __restrict__ x,
                    const T* __restrict__ y, double* __restrict__ partial,
                    int V, int C, int cw, int rows) {
  const int chunk = blockIdx.x, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int rb = kThreads / cw;
  const int lane = tid % cw, roff = tid / cw;
  const int c = blockIdx.y * cw + lane;
  const int r0 = chunk * rows;
  const int r1 = min(V, r0 + rows);
  // kUnroll rows per step: their loads are in flight together, summed in
  // fp32, then added to the thread's double sums
  double a1 = 0.0, a2 = 0.0;
  if (roff < rb && c < C) {
    const T* xb = x + (size_t)b * V * C + c;
    const T* gb = WEIGHTED ? g + (size_t)b * V * C + c : nullptr;
    const T* yb = MASKED ? y + (size_t)b * V * C + c : nullptr;
    for (int r = r0 + roff; r < r1; r += kUnroll * rb) {
      float f1 = 0.f, f2 = 0.f;
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int rr = r + k * rb;
        if (rr < r1) {
          const float xv = load_f32(xb + (size_t)rr * C);
          if constexpr (WEIGHTED) {
            float gv = load_f32(gb + (size_t)rr * C);
            if constexpr (MASKED)
              if (!(load_f32(yb + (size_t)rr * C) > 0.f)) gv = 0.f;
            f1 += gv;
            f2 = fmaf(gv, xv, f2);
          } else {
            f1 += xv;
            f2 = fmaf(xv, xv, f2);
          }
        }
      }
      a1 += f1;
      a2 += f2;
    }
  }
  __shared__ double sh[2][kThreads];
  sh[0][tid] = a1;
  sh[1][tid] = a2;
  __syncthreads();
  for (int e = tid; e < 2 * cw; e += kThreads) {
    const int s = e / cw, ln = e % cw;
    const int cc = blockIdx.y * cw + ln;
    double t = 0.0;
    for (int k = 0; k < rb; ++k) t += sh[s][k * cw + ln];
    if (cc < C)
      partial[(((size_t)b * gridDim.x + chunk) * 2 + s) * C + cc] = t;
  }
}

// out1/out2[b, c] = sum over chunks of partial[b, :, 0/1, c]; one block per
// (c, b, sum), fixed-order tree -> deterministic.
__global__ void __launch_bounds__(kThreads)
partial_reduce_kernel(const double* __restrict__ partial,
                      float* __restrict__ out1, float* __restrict__ out2,
                      int nchunk, int C) {
  const int c = blockIdx.x, b = blockIdx.y, s = blockIdx.z;
  double t = 0.0;
  for (int i = threadIdx.x; i < nchunk; i += blockDim.x)
    t += partial[(((size_t)b * nchunk + i) * 2 + s) * C + c];
  __shared__ double sh[kThreads];
  sh[threadIdx.x] = t;
  __syncthreads();
  for (int off = kThreads / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) sh[threadIdx.x] += sh[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) (s ? out2 : out1)[(size_t)b * C + c] = (float)sh[0];
}

template <typename T, bool WEIGHTED, bool MASKED>
int launch(const T* g, const T* x, const T* y, double* partial, float* out1,
           float* out2, int B, int V, int C, cudaStream_t st) {
  const int cw = channel_width(C);
  const int rows = chunk_rows(B, V, C);
  const dim3 grid((V + rows - 1) / rows, (C + cw - 1) / cw, B);
  channel_sums_kernel<T, WEIGHTED, MASKED><<<grid, kThreads, 0, st>>>(
      g, x, y, partial, V, C, cw, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  partial_reduce_kernel<<<dim3(C, B, 2), kThreads, 0, st>>>(
      partial, out1, out2, (int)grid.x, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Chunks along V for a (B, V, C) input; the caller sizes `partial` as
// (B, stats_chunks(B, V, C), 2, C) float64.
int stats_chunks(int B, int V, int C) {
  const int rows = chunk_rows(B, V, C);
  return (V + rows - 1) / rows;
}

// K5a: x (B, V, C) in the element type -> s1 = sum x, s2 = sum x^2, (B, C)
// fp32; all contiguous, on the device of `stream`.
#define NAS3D_MOMENTS(NAME, T)                                                \
  int NAME(const T* x, double* partial, float* s1, float* s2, int B, int V,   \
           int C, void* stream) {                                             \
    return launch<T, false, false>(nullptr, x, nullptr, partial, s1, s2, B,   \
                                   V, C, (cudaStream_t)stream);               \
  }
NAS3D_MOMENTS(moments_f32, float)
NAS3D_MOMENTS(moments_bf16, __nv_bfloat16)
#undef NAS3D_MOMENTS

// K5b: g, x (B, V, C) in the element type -> r1 = sum g, r2 = sum g*x.
#define NAS3D_WEIGHTED(NAME, T)                                               \
  int NAME(const T* g, const T* x, double* partial, float* r1, float* r2,     \
           int B, int V, int C, void* stream) {                               \
    return launch<T, true, false>(g, x, nullptr, partial, r1, r2, B, V, C,    \
                                  (cudaStream_t)stream);                      \
  }
NAS3D_WEIGHTED(weighted_sums_f32, float)
NAS3D_WEIGHTED(weighted_sums_bf16, __nv_bfloat16)
#undef NAS3D_WEIGHTED

// K3's backward sums with the ReLU fused: g, x, y (B, V, C) -> r1 = sum of
// g where y > 0, r2 = sum of g*x where y > 0.
#define NAS3D_MASKED(NAME, T)                                                 \
  int NAME(const T* g, const T* x, const T* y, double* partial, float* r1,    \
           float* r2, int B, int V, int C, void* stream) {                    \
    return launch<T, true, true>(g, x, y, partial, r1, r2, B, V, C,           \
                                 (cudaStream_t)stream);                       \
  }
NAS3D_MASKED(weighted_sums_masked_f32, float)
NAS3D_MASKED(weighted_sums_masked_bf16, __nv_bfloat16)
#undef NAS3D_MASKED

}  // extern "C"
