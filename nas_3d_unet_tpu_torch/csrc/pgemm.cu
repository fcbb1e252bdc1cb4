// K1, K1-dx and K2: the stride-1 ConvNormAct convs with their GroupNorm
// moments, and K1's dx.  fp32 (serving) runs on the FMA units: the 3^3
// convs on the FMA conv tile (conv_fma.cuh), the 1^3 GEMM on the voxel-row
// FMA tile (gemm_fma.cuh); bf16 (training) runs on the tensor cores: the
// 3^3 convs on conv_mma.cuh, the 1^3 GEMM on gemm_mma.cuh.  Each has a
// moments epilogue (the tensor-core kernels share moments.cuh's).
//
// Replaces (nas_3d_unet_tpu/ops/pallas/pgemm.py):
//   K1 conv3x3x3_stats_{f32,bf16} <- conv_pgemm (:174, body _kernel :74)
//      with its GroupNorm-moments epilogue: stride-1 3^3 SAME conv,
//      dilation 1 or 2.
//   K1-dx conv3x3x3_{f32,bf16}    <- the same conv_pgemm with
//      with_stats=False, as _pg_stats_fn's backward runs it for dx
//      (ops/packed.py:491-504): the conv of dy with the flip-transposed
//      kernel; the conv tiles at stride 1, pad = dilation, no moments.
//   K2 gemm_stats_{f32,bf16}      <- gemm_stats (:311, body _gemm_kernel
//      :287): y = x @ W over voxel rows (the 1^3 conv), same epilogue.
// The moments are per-(batch, channel) sums of y and y^2, which GroupNorm
// folds into mean and variance without another pass over y.  In bf16 they
// are fp32 sums of the ROUNDED y, as the reference's are (packed.py:408).
// Every kernel reduces its tile's column sums in a fixed order into
// per-block partials; moments_reduce_kernel sums the partials in double,
// in a fixed order, so the moments are the same bits run to run (no
// atomics).  What bounds each: K1 the bytes in bf16 and the fp32 FMA rate
// in fp32 (a 3^3 conv does 54*Cin flops per output value); K2 the bytes in
// both, so the fused epilogue is the gain: the plain version reads y twice
// more for its moments.

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_fma.cuh"
#include "conv_mma.cuh"
#include "gemm_fma.cuh"
#include "gemm_mma.cuh"

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

// s1/s2 from the (B, nblk, 2, N) partials, after the kernel that wrote
// them, on the same stream
int reduce_moments(int err, const float* partial, float* s1, float* s2,
                   int B, int nblk, int N, cudaStream_t st) {
  if (err != cudaSuccess) return err;
  moments_reduce_kernel<<<dim3(N, B, 2), 256, 0, st>>>(partial, s1, s2, nblk,
                                                       N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks per batch item of the FMA conv tile at stride 1 (K1 fp32) for a
// (D, H, W) volume: the caller sizes `partial` as (B, blocks, 2, Cout).
int conv_fma_blocks(int cin, int cout, int dil, int D, int H, int W) {
  if (cin < 1 || cout < 1 || dil < 1 || dil > 2 || D < 1 || H < 1 || W < 1)
    return -(int)cudaErrorInvalidValue;
  return cfma::grid_bricks(cfma::make_plan(cin, cout, 1, dil), D, H, W);
}

// Blocks per batch item of the tensor-core conv at stride 1 (K1 bf16) for
// a (D, H, W) volume: the caller sizes `partial` as (B, blocks, 2, Cout).
int conv_mma_blocks(int cin, int cout, int dil, int D, int H, int W) {
  if (cin < 1 || cout < 1 || dil < 1 || dil > 2 || D < 1 || H < 1 || W < 1)
    return -(int)cudaErrorInvalidValue;
  return cmma::grid_bricks(cmma::make_plan(cin, cout, 1, dil), D, H, W);
}

// The tensor-core GEMM's plan for (K, N), with or without the moments
// (stats) and the depth-to-space store (d2s), into out[4]: BN, the rows
// per block (the caller of K2 bf16 sizes `partial` as (B, ceil(V / rows),
// 2, N)), the K chunks, the bytes of shared memory (ops/gemm_mma.py:plan
// mirrors it).
int gemm_mma_plan(int k, int n, int stats, int d2s, int* out) {
  if (k < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const gmma::Plan p = gmma::make_plan(k, n, stats != 0, d2s != 0);
  out[0] = p.bn;
  out[1] = gmma::kBM;
  out[2] = p.nchunks;
  out[3] = (int)p.smem;
  return 0;
}

// The fp32 voxel-row FMA tile's plan for (K, N), with or without the
// moments (stats) and the depth-to-space store (d2s), into out[5]: BN, the
// rows per tile (the caller of K2 fp32 sizes `partial` as (B, ceil(V /
// rows), 2, N)), the K chunks, the x stages, the bytes of shared memory
// (ops/gemm_fma.py:plan mirrors it).
int gemm_fma_plan(int k, int n, int stats, int d2s, int* out) {
  if (k < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const gfma::Plan p = gfma::make_plan(k, n, stats != 0, d2s != 0);
  out[0] = p.bn;
  out[1] = p.bm;
  out[2] = p.nchunks;
  out[3] = p.stages;
  out[4] = (int)p.smem;
  return 0;
}

// K1: x (B, D, H, W, Cin), w (3, 3, 3, Cin, Cout), y (B, D, H, W, Cout) in
// the element type; s1/s2 (B, Cout) fp32; all contiguous, on the device of
// `stream`.
int conv3x3x3_stats_f32(const float* x, const float* w, float* y,
                        float* partial, float* s1, float* s2, int B, int D,
                        int H, int W, int Cin, int Cout, int dil,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int err = cfma::launch_conv_fma<1, true>(
      x, w, nullptr, y, partial, B, D, H, W, Cin, Cout, dil, dil, dil, dil,
      0, st);
  return reduce_moments(err, partial, s1, s2, B,
                        conv_fma_blocks(Cin, Cout, dil, D, H, W), Cout, st);
}

int conv3x3x3_stats_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                         __nv_bfloat16* y, float* partial, float* s1,
                         float* s2, int B, int D, int H, int W, int Cin,
                         int Cout, int dil, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int err = cmma::launch_conv_mma<true>(
      x, w, nullptr, y, partial, B, D, H, W, Cin, Cout, 1, dil, dil, dil, dil,
      0, st);
  return reduce_moments(err, partial, s1, s2, B,
                        conv_mma_blocks(Cin, Cout, dil, D, H, W), Cout, st);
}

// K1-dx: the same conv without the moments (partial, s1, s2 unused)
int conv3x3x3_f32(const float* x, const float* w, float* y, float* partial,
                  float* s1, float* s2, int B, int D, int H, int W, int Cin,
                  int Cout, int dil, void* stream) {
  return cfma::launch_conv_fma<1, false>(x, w, nullptr, y, nullptr, B, D, H,
                                         W, Cin, Cout, dil, dil, dil, dil, 0,
                                         (cudaStream_t)stream);
}

int conv3x3x3_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                   __nv_bfloat16* y, float* partial, float* s1, float* s2,
                   int B, int D, int H, int W, int Cin, int Cout, int dil,
                   void* stream) {
  return cmma::launch_conv_mma<false>(x, w, nullptr, y, nullptr, B, D, H, W,
                                      Cin, Cout, 1, dil, dil, dil, dil, 0,
                                      (cudaStream_t)stream);
}

// K2: x (B, V, K), w (K, N), y (B, V, N) in the element type; s1/s2 (B, N)
// fp32.
int gemm_stats_f32(const float* x, const float* w, float* y, float* partial,
                   float* s1, float* s2, int B, int V, int K, int N,
                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  gfma::Geom g{};
  g.V = V, g.K = K, g.N = N;
  const int err = gfma::launch<true, false, false>(x, w, nullptr, y, partial,
                                                   g, B, st);
  return reduce_moments(err, partial, s1, s2, B, gfma::tiles(V, N), N, st);
}

int gemm_stats_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                    __nv_bfloat16* y, float* partial, float* s1, float* s2,
                    int B, int V, int K, int N, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  gmma::Geom g{};
  g.V = V, g.K = K, g.N = N;
  const int err = gmma::launch<true, false, false>(x, w, nullptr, y, partial,
                                                   g, B, st);
  return reduce_moments(err, partial, s1, s2, B,
                        (V + gmma::kBM - 1) / gmma::kBM, N, st);
}

}  // extern "C"
