// The GroupNorm-moments epilogue of the tensor-core kernels (conv_mma.cuh
// for K1 bf16, gemm_mma.cuh for K2 bf16): per-block column sums of y and
// y^2, taken of the ROUNDED y (what a consumer of y sees; the reference's
// moments are fp32 sums of the bf16 y, ops/packed.py:408), in a fixed
// order, so a second launch gives the same bits:
//   1. each thread sums its own rows of each accumulator column (the
//      caller, inside its store loop, so the sums never sit beside all of
//      the accumulators);
//   2. moments_warp_put: __shfl_xor over the eight row groups of the
//      m16n8 fragment (lane bits 2-4: xor 4, then 8, then 16), then lanes
//      0-3 write the warp's column sums into shared memory;
//   3. moments_block_put: after a __syncthreads, the WM warps along M are
//      summed in warp order into the block's partial (B, nblk, 2, N) row.
// pgemm.cu's moments_reduce_kernel then folds the partials over the blocks
// in double, in a fixed order.  No atomics anywhere.
#pragma once

#include <cuda_runtime.h>

namespace nas3d {

// v = {sum y at column c, at c + 1, sum y^2 at c, at c + 1} of this
// thread's rows of one 8-column fragment; c = col0 + 2 * (lane & 3).
// red (shared, WM x 2 x BN floats) row wm gets the warp's sums at columns
// col0 .. col0 + 7; each slot is written once per launch.
template <int BN>
__device__ __forceinline__ void moments_warp_put(float* red, int wm, int col0,
                                                 float (&v)[4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 4; off < 32; off <<= 1)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[q] += __shfl_xor_sync(0xffffffffu, v[q], off);
  if (lane < 4) {
    const int c = col0 + 2 * lane;
    float* r = red + (size_t)wm * 2 * BN;
    r[c] = v[0];
    r[c + 1] = v[1];
    r[BN + c] = v[2];
    r[BN + c + 1] = v[3];
  }
}

// After a __syncthreads: threads 0 .. 2*BN-1 sum the WM warps' rows of red
// in order and store the block's sums of columns n0 + c < N into
// partial row `row` of (rows, 2, N) (row = b * nblk + block).
template <int BN, int WM>
__device__ __forceinline__ void moments_block_put(const float* red,
                                                  float* partial, size_t row,
                                                  int n0, int N) {
  const int tid = threadIdx.x;
  if (tid < 2 * BN) {
    const int s = tid / BN, c = tid - s * BN;
    float t = 0.f;
#pragma unroll
    for (int wm = 0; wm < WM; ++wm) t += red[(wm * 2 + s) * BN + c];
    if (n0 + c < N) partial[(row * 2 + s) * N + n0 + c] = t;
  }
}

}  // namespace nas3d
