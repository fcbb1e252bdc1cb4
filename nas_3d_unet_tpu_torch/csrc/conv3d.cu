// The use_pallas configuration's conv kernels, fp32 or bf16 elements with
// fp32 accumulation, rounded once.  In fp32 they instantiate the FMA
// implicit-GEMM template (its bound and design: igemm.cuh); K6 in bf16 is
// the tensor-core conv (conv_mma.cuh), K7 and K4 in bf16 the template.
//
// Replaces (nas_3d_unet_tpu/ops/pallas/conv3d.py):
//   K6 conv3d_{f32,bf16}           <- conv3d (:201, _conv3d_pallas_fwd
//      :139, body _conv3d_kernel :51): 3^3 SAME conv, stride 1 or 2,
//      dilation 1 or 2, lax's pads (the odd one high), optional bias and
//      ReLU.  fp32: at stride 1 without either it is K1-dx's fp32 kernel
//      (pad = dil on both sides); otherwise the general gather, whose
//      stride and low pads ride in the row coordinates each thread
//      computes once, so the per-load work is the same add and bounds
//      test.  bf16: conv_mma.cuh at every stride, dilation and epilogue.
//   K7 pointwise_conv_{f32,bf16}   <- pointwise_conv (:279,
//      _pointwise_fwd :300, body :251): the K2 GEMM without the moments,
//      optional bias and ReLU.
//   K4 conv_transpose2x_{f32,bf16} <- conv_transpose2x (:356,
//      _transpose2x_fwd :373, body :338): (voxels, Cin) @ (Cin, 8*Cout)
//      whose store writes the depth-to-space layout directly, so the 8x
//      larger output is written once and never permuted; optional ReLU.
//      The caller passes the flipped, flattened kernel.
// The TPU kernels fuse bias and ReLU into the matmul's epilogue; so do
// these, compiled in only for a call that asks for either (the template's
// EPI flag; conv_mma.cuh's epilogue reads the flags at run time).

#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_mma.cuh"
#include "igemm.cuh"

namespace {

// The bias/ReLU epilogue variant only when one is asked for.
template <int LAYOUT, typename T>
int launch(const T* x, const T* w, const float* bias, T* y, int B, int rows,
           int K, int N, int relu, ConvGeom g, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bias != nullptr || relu)
    return launch_gemm<LAYOUT, false, true>(x, w, bias, y, nullptr, B, rows,
                                            K, N, relu, g, st);
  return launch_gemm<LAYOUT, false, false>(x, w, bias, y, nullptr, B, rows, K,
                                           N, relu, g, st);
}

}  // namespace

extern "C" {

// K6: x (B, D, H, W, Cin), w (3, 3, 3, Cin, Cout), bias (Cout,) fp32 or
// null, y (B, ceil(D/stride), ceil(H/stride), ceil(W/stride), Cout) in the
// element type; pd/ph/pw the low-side SAME pads; all contiguous, on the
// device of `stream`.
int conv3d_f32(const float* x, const float* w, const float* bias, float* y,
               int B, int D, int H, int W, int Cin, int Cout, int stride,
               int dil, int pd, int ph, int pw, int relu, void* stream) {
  if (stride == 1 && bias == nullptr && !relu) {
    const ConvGeom g{D, H, W, Cin, dil};
    return launch<kConvS1>(x, w, bias, y, B, D * H * W, 27 * Cin, Cout, 0, g,
                           stream);
  }
  const int Do = (D + stride - 1) / stride, Ho = (H + stride - 1) / stride;
  const int Wo = (W + stride - 1) / stride;
  const ConvGeom g{D, H, W, Cin, dil, stride, pd, ph, pw, Ho, Wo};
  return launch<kConv>(x, w, bias, y, B, Do * Ho * Wo, 27 * Cin, Cout, relu,
                       g, stream);
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

// K7: x (rows, K), w (K, N), bias (N,) fp32 or null, y (rows, N).
#define NAS3D_POINTWISE(NAME, T)                                              \
  int NAME(const T* x, const T* w, const float* bias, T* y, int rows, int K,  \
           int N, int relu, void* stream) {                                   \
    return launch<kGemm>(x, w, bias, y, 1, rows, K, N, relu, ConvGeom{},      \
                         stream);                                             \
  }
NAS3D_POINTWISE(pointwise_conv_f32, float)
NAS3D_POINTWISE(pointwise_conv_bf16, __nv_bfloat16)
#undef NAS3D_POINTWISE

// K4: x (B, D, H, W, Cin), w (Cin, 8*Cout) with column (kd*4 + kh*2 + kw)*
// Cout + co the tap that lands at output offset (kd, kh, kw), y (B, 2D, 2H,
// 2W, Cout).
#define NAS3D_TRANSPOSE2X(NAME, T)                                            \
  int NAME(const T* x, const T* w, T* y, int B, int D, int H, int W, int Cin, \
           int Cout, int relu, void* stream) {                                \
    return launch<kGemmD2S>(x, w, nullptr, y, B, D * H * W, Cin, 8 * Cout,    \
                            relu, ConvGeom{D, H, W}, stream);                 \
  }
NAS3D_TRANSPOSE2X(conv_transpose2x_f32, float)
NAS3D_TRANSPOSE2X(conv_transpose2x_bf16, __nv_bfloat16)
#undef NAS3D_TRANSPOSE2X

}  // extern "C"
