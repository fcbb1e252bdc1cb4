// GEMM-with-moments kernels for the stride-1 ConvNormAct convs, fp32 or
// bf16 elements with fp32 accumulation (the template, its bound and its
// design: igemm.cuh), and K1's dx (in bf16 on the tensor cores:
// conv_mma.cuh).
//
// Replaces (nas_3d_unet_tpu/ops/pallas/pgemm.py):
//   K1 conv3x3x3_stats_{f32,bf16} <- conv_pgemm (:174, body _kernel :74)
//      with its GroupNorm-moments epilogue: stride-1 3^3 SAME conv,
//      dilation 1 or 2.
//   K1-dx conv3x3x3_{f32,bf16}    <- the same conv_pgemm with
//      with_stats=False, as _pg_stats_fn's backward runs it for dx
//      (ops/packed.py:491-504): the conv of dy with the flip-transposed
//      kernel.  fp32: the template with the epilogue and the moments
//      reduce compiled out; bf16: the tensor-core conv at stride 1, pad =
//      dilation.
//   K2 gemm_stats_{f32,bf16}      <- gemm_stats (:311, body _gemm_kernel
//      :287): y = x @ W over voxel rows (the 1^3 conv), same epilogue.
// The moments are per-(batch, channel) sums of y and y^2, which GroupNorm
// folds into mean and variance without another pass over y.  In bf16 they
// are fp32 sums of the ROUNDED y, as the reference's are (packed.py:408).
// The epilogue reduces each tile's column sums into per-block partials; a
// second kernel sums the partials in double, in a fixed order, so the
// moments are the same bits run to run (no atomics).  For the
// bandwidth-bound K2 shapes the fused epilogue is the gain: the plain
// version reads y twice more for its moments.

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_mma.cuh"
#include "igemm.cuh"

namespace {

// s1/s2[b, n] = sum over blocks of partial[b, :, 0/1, n]; one block per
// (n, b, moment), double accumulation, fixed-order tree -> deterministic.
__global__ void __launch_bounds__(256)
moments_reduce_kernel(const float* __restrict__ partial, float* __restrict__ s1,
                      float* __restrict__ s2, int nblk, int N) {
  const int n = blockIdx.x, b = blockIdx.y, s = blockIdx.z;
  double t = 0.0;
  for (int i = threadIdx.x; i < nblk; i += blockDim.x)
    t += partial[(((size_t)b * nblk + i) * 2 + s) * N + n];
  __shared__ double sh[256];
  sh[threadIdx.x] = t;
  __syncthreads();
  for (int off = 128; off > 0; off >>= 1) {
    if (threadIdx.x < off) sh[threadIdx.x] += sh[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) (s ? s2 : s1)[(size_t)b * N + n] = (float)sh[0];
}

// STATS: also sum the per-block partials into s1/s2; otherwise partial, s1
// and s2 are unused (may be null)
template <int LAYOUT, bool STATS, typename T>
int launch(const T* x, const T* w, T* y, float* partial, float* s1, float* s2,
           int B, int rows, int K, int N, ConvGeom g, cudaStream_t st) {
  const int err = launch_gemm<LAYOUT, STATS, false>(
      x, w, nullptr, y, partial, B, rows, K, N, 0, g, st);
  if (err != cudaSuccess || !STATS) return err;
  const int nblk = (rows + row_block(pick_bn(N)) - 1) / row_block(pick_bn(N));
  moments_reduce_kernel<<<dim3(N, B, 2), 256, 0, st>>>(partial, s1, s2, nblk,
                                                       N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of Y per block for an output width n; the caller sizes `partial`
// as (B, ceil(rows / pgemm_row_block(n)), 2, n) fp32.
int pgemm_row_block(int n) { return row_block(pick_bn(n)); }

// K1: x (B, D, H, W, Cin), w (3, 3, 3, Cin, Cout), y (B, D, H, W, Cout) in
// the element type; s1/s2 (B, Cout) fp32; all contiguous, on the device of
// `stream`.
#define NAS3D_CONV(NAME, T, STATS)                                            \
  int NAME(const T* x, const T* w, T* y, float* partial, float* s1,           \
           float* s2, int B, int D, int H, int W, int Cin, int Cout, int dil, \
           void* stream) {                                                    \
    const ConvGeom g{D, H, W, Cin, dil};                                      \
    return launch<kConvS1, STATS>(x, w, y, partial, s1, s2, B, D * H * W,    \
                                  27 * Cin, Cout, g, (cudaStream_t)stream);  \
  }
NAS3D_CONV(conv3x3x3_stats_f32, float, true)
NAS3D_CONV(conv3x3x3_stats_bf16, __nv_bfloat16, true)
// K1-dx: the same conv without the moments (partial, s1, s2 unused)
NAS3D_CONV(conv3x3x3_f32, float, false)
#undef NAS3D_CONV

int conv3x3x3_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                   __nv_bfloat16* y, float* partial, float* s1, float* s2,
                   int B, int D, int H, int W, int Cin, int Cout, int dil,
                   void* stream) {
  return cmma::launch_conv_mma(x, w, nullptr, y, B, D, H, W, Cin, Cout, 1,
                               dil, dil, dil, dil, 0, (cudaStream_t)stream);
}

// K2: x (B, V, K), w (K, N), y (B, V, N) in the element type; s1/s2 (B, N)
// fp32.
#define NAS3D_GEMM(NAME, T)                                                   \
  int NAME(const T* x, const T* w, T* y, float* partial, float* s1,           \
           float* s2, int B, int V, int K, int N, void* stream) {             \
    return launch<kGemm, true>(x, w, y, partial, s1, s2, B, V, K, N,         \
                               ConvGeom{}, (cudaStream_t)stream);             \
  }
NAS3D_GEMM(gemm_stats_f32, float)
NAS3D_GEMM(gemm_stats_bf16, __nv_bfloat16)
#undef NAS3D_GEMM

}  // extern "C"
