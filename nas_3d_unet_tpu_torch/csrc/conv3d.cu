// The use_pallas configuration's conv kernels, fp32 or bf16 elements with
// fp32 accumulation, rounded once.  In fp32 they run on the FMA units: K6
// on the conv tile (its bound and design: conv_fma.cuh), K7 and K4 on the
// voxel-row FMA tile (gemm_fma.cuh); in bf16 they run on the tensor cores:
// K6 on the conv tile (conv_mma.cuh), K7 and K4 on the voxel-row GEMM tile
// (gemm_mma.cuh).
//
// Replaces (nas_3d_unet_tpu/ops/pallas/conv3d.py):
//   K6 conv3d_{f32,bf16}           <- conv3d (:201, _conv3d_pallas_fwd
//      :139, body _conv3d_kernel :51): 3^3 SAME conv, stride 1 or 2,
//      dilation 1 or 2, lax's pads (the odd one high), optional bias and
//      ReLU: conv_fma.cuh (fp32) or conv_mma.cuh (bf16) at every stride,
//      dilation and epilogue.
//   K7 pointwise_conv_{f32,bf16}   <- pointwise_conv (:279,
//      _pointwise_fwd :300, body :251): the K2 GEMM without the moments,
//      optional bias and ReLU.  Bytes-bound: 2*K*N flops per (K + N) * 2
//      bytes of a voxel row in bf16 (8 to 64 flop/B at the path's 16-128
//      channels), far below the card's ~295.
//   K4 conv_transpose2x_{f32,bf16} <- conv_transpose2x (:356,
//      _transpose2x_fwd :373, body :338): (voxels, Cin) @ (Cin, 8*Cout)
//      whose store writes the depth-to-space layout directly, so the 8x
//      larger output is written once and never permuted; optional ReLU.
//      Bytes-bound: (Cin + 8*Cout) * 2 bytes a voxel in bf16 (* 4 in
//      fp32), most of them the output.  Both tiles read the DHWIO kernel
//      with lax's flip themselves; the kw = 0 and 1 taps of one (kd, kh)
//      land side by side, 2*Cout contiguous elements a voxel.
// The TPU kernels fuse bias and ReLU into the matmul's epilogue; so do
// these: gemm_fma.cuh compiles its EPI step in only for a call that asks
// for either; the conv tiles' and gemm_mma.cuh's epilogues read the flags
// at run time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_fma.cuh"
#include "conv_mma.cuh"
#include "gemm_fma.cuh"
#include "gemm_mma.cuh"

extern "C" {

// K6: x (B, D, H, W, Cin), w (3, 3, 3, Cin, Cout), bias (Cout,) fp32 or
// null, y (B, ceil(D/stride), ceil(H/stride), ceil(W/stride), Cout) in the
// element type; pd/ph/pw the low-side SAME pads; all contiguous, on the
// device of `stream`.
int conv3d_f32(const float* x, const float* w, const float* bias, float* y,
               int B, int D, int H, int W, int Cin, int Cout, int stride,
               int dil, int pd, int ph, int pw, int relu, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (stride == 1)
    return cfma::launch_conv_fma<1, false>(x, w, bias, y, nullptr, B, D, H, W,
                                           Cin, Cout, dil, pd, ph, pw, relu,
                                           st);
  if (stride == 2)
    return cfma::launch_conv_fma<2, false>(x, w, bias, y, nullptr, B, D, H, W,
                                           Cin, Cout, dil, pd, ph, pw, relu,
                                           st);
  return (int)cudaErrorInvalidValue;
}

int conv3d_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                const float* bias, __nv_bfloat16* y, int B, int D, int H,
                int W, int Cin, int Cout, int stride, int dil, int pd, int ph,
                int pw, int relu, void* stream) {
  return cmma::launch_conv_mma<false>(x, w, bias, y, nullptr, B, D, H, W, Cin,
                                      Cout, stride, dil, pd, ph, pw, relu,
                                      (cudaStream_t)stream);
}

// The tensor-core conv's plan for (Cin, Cout, stride, dil) into out[5]:
// BN, the output brick's depth, the shared-memory stages, the bytes of
// shared memory, the halo brick's voxels (ops/conv_mma.py:plan mirrors it).
int conv_mma_plan(int cin, int cout, int stride, int dil, int* out) {
  if (cin < 1 || cout < 1 || stride < 1 || stride > 2 || dil < 1 || dil > 2)
    return (int)cudaErrorInvalidValue;
  const cmma::Plan p = cmma::make_plan(cin, cout, stride, dil);
  out[0] = p.bn;
  out[1] = p.bd;
  out[2] = p.nbuf;
  out[3] = (int)p.smem;
  out[4] = p.hd * p.hh * p.hw;
  return 0;
}

// The FMA conv tile's plan for (Cin, Cout, stride, dil) into out[5]: BN,
// the output brick's depth, the input channels per chunk, the
// shared-memory stages, the bytes of shared memory (ops/conv_fma.py:plan
// mirrors it).
int conv_fma_plan(int cin, int cout, int stride, int dil, int* out) {
  if (cin < 1 || cout < 1 || stride < 1 || stride > 2 || dil < 1 || dil > 2)
    return (int)cudaErrorInvalidValue;
  const cfma::Plan p = cfma::make_plan(cin, cout, stride, dil);
  out[0] = p.bn;
  out[1] = p.bd;
  out[2] = cfma::kKC;
  out[3] = p.nbuf;
  out[4] = (int)p.smem;
  return 0;
}

// K7: x (rows, K), w (K, N), bias (N,) fp32 or null, y (rows, N); the
// bias/ReLU epilogue variant only when one is asked for.
int pointwise_conv_f32(const float* x, const float* w, const float* bias,
                       float* y, int rows, int K, int N, int relu,
                       void* stream) {
  gfma::Geom g{};
  g.V = rows, g.K = K, g.N = N, g.relu = relu;
  cudaStream_t st = (cudaStream_t)stream;
  if (bias != nullptr || relu)
    return gfma::launch<false, true, false>(x, w, bias, y, nullptr, g, 1,
                                            st);
  return gfma::launch<false, false, false>(x, w, bias, y, nullptr, g, 1, st);
}

// K7 in bf16, on the tensor cores: the bias comes rounded to bf16 (the
// reference adds its bias row in w's dtype).
int pointwise_conv_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                        const float* bias, __nv_bfloat16* y, int rows, int K,
                        int N, int relu, void* stream) {
  gmma::Geom g{};
  g.V = rows, g.K = K, g.N = N, g.relu = relu;
  return gmma::launch<false, true, false>(x, w, bias, y, nullptr, g, 1,
                                          (cudaStream_t)stream);
}

// K4: x (B, D, H, W, Cin), w (2, 2, 2, Cin, Cout) DHWIO as the caller
// holds it (gemm_fma.cuh stages it with lax's flip), y (B, 2D, 2H, 2W,
// Cout); the ReLU epilogue variant only when it is asked for.
int conv_transpose2x_f32(const float* x, const float* w, float* y, int B,
                         int D, int H, int W, int Cin, int Cout, int relu,
                         void* stream) {
  gfma::Geom g{};
  g.V = D * H * W, g.K = Cin, g.N = 8 * Cout, g.relu = relu;
  g.H = H, g.W = W, g.cout = Cout;
  cudaStream_t st = (cudaStream_t)stream;
  if (relu)
    return gfma::launch<false, true, true>(x, w, nullptr, y, nullptr, g, B,
                                           st);
  return gfma::launch<false, false, true>(x, w, nullptr, y, nullptr, g, B,
                                          st);
}

// K4 in bf16, on the tensor cores: w (2, 2, 2, Cin, Cout) DHWIO as the
// caller holds it (gemm_mma.cuh stages it with lax's flip).
int conv_transpose2x_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                          __nv_bfloat16* y, int B, int D, int H, int W,
                          int Cin, int Cout, int relu, void* stream) {
  gmma::Geom g{};
  g.V = D * H * W, g.K = Cin, g.N = 8 * Cout, g.relu = relu;
  g.H = H, g.W = W, g.cout = Cout;
  return gmma::launch<false, true, true>(x, w, nullptr, y, nullptr, g, B,
                                         (cudaStream_t)stream);
}

}  // extern "C"
