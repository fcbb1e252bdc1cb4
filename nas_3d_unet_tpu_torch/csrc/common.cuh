// Element-type helpers shared by the kernels: loads widen to fp32, stores
// round once to the element type and hand back the rounded value (what a
// consumer of y will see, so moments can be taken of exactly that).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace nas3d {

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }

// bf16 -> fp32 is exact: the bf16 bits are the high half of the fp32 word
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  const unsigned short u = __ldg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(u) << 16);
}

__device__ __forceinline__ float store_rounded(float* p, float v) {
  *p = v;
  return v;
}

__device__ __forceinline__ float store_rounded(__nv_bfloat16* p, float v) {
  const __nv_bfloat16 r = __float2bfloat16_rn(v);
  *p = r;
  return __bfloat162float(r);
}

}  // namespace nas3d
