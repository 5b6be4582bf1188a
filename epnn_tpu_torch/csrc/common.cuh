// Shared device helpers of the epnn_tpu_torch kernels.
//
// Every kernel here is float32 on the CUDA cores, compiled without
// --use_fast_math.  Products are written as explicit fmaf() chains in a
// fixed k order, so the same inputs give the same bits in every thread —
// the property the electron-passing kernel's exact antisymmetry rests on.
#pragma once

#include <cuda_runtime.h>

namespace epnn {

__device__ __forceinline__ float relu(float x) { return fmaxf(x, 0.0f); }

// y[o] = b[o] + sum_k z[k] * W[k][o], W row-major (K, H) staged in shared
// memory as float4 rows; every lane of a warp reads the same W entry, so
// the reads are broadcasts.
template <int K, int H>
__device__ __forceinline__ void matvec_bias(const float (&z)[K],
                                            const float4* __restrict__ w,
                                            const float* __restrict__ b,
                                            float (&y)[H]) {
#pragma unroll
  for (int o = 0; o < H; ++o) y[o] = b[o];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float zk = z[k];
#pragma unroll
    for (int o4 = 0; o4 < H / 4; ++o4) {
      const float4 wv = w[k * (H / 4) + o4];
      y[4 * o4 + 0] = fmaf(zk, wv.x, y[4 * o4 + 0]);
      y[4 * o4 + 1] = fmaf(zk, wv.y, y[4 * o4 + 1]);
      y[4 * o4 + 2] = fmaf(zk, wv.z, y[4 * o4 + 2]);
      y[4 * o4 + 3] = fmaf(zk, wv.w, y[4 * o4 + 3]);
    }
  }
}

// The same product for two inputs sharing each W read.  Each output is its
// own fmaf chain in the same k order as matvec_bias, so
// matvec2_bias(a, b) gives bitwise matvec_bias(a) and matvec_bias(b).
template <int K, int H>
__device__ __forceinline__ void matvec2_bias(const float (&za)[K],
                                             const float (&zb)[K],
                                             const float4* __restrict__ w,
                                             const float* __restrict__ b,
                                             float (&ya)[H], float (&yb)[H]) {
#pragma unroll
  for (int o = 0; o < H; ++o) {
    ya[o] = b[o];
    yb[o] = b[o];
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float a = za[k];
    const float c = zb[k];
#pragma unroll
    for (int o4 = 0; o4 < H / 4; ++o4) {
      const float4 wv = w[k * (H / 4) + o4];
      ya[4 * o4 + 0] = fmaf(a, wv.x, ya[4 * o4 + 0]);
      ya[4 * o4 + 1] = fmaf(a, wv.y, ya[4 * o4 + 1]);
      ya[4 * o4 + 2] = fmaf(a, wv.z, ya[4 * o4 + 2]);
      ya[4 * o4 + 3] = fmaf(a, wv.w, ya[4 * o4 + 3]);
      yb[4 * o4 + 0] = fmaf(c, wv.x, yb[4 * o4 + 0]);
      yb[4 * o4 + 1] = fmaf(c, wv.y, yb[4 * o4 + 1]);
      yb[4 * o4 + 2] = fmaf(c, wv.z, yb[4 * o4 + 2]);
      yb[4 * o4 + 3] = fmaf(c, wv.w, yb[4 * o4 + 3]);
    }
  }
}

// Stage n floats (n % 4 == 0, 16-byte aligned) from global into shared.
__device__ __forceinline__ void stage(float4* __restrict__ dst,
                                      const float* __restrict__ src, int n) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  for (int t = threadIdx.x; t < n / 4; t += blockDim.x) dst[t] = s4[t];
}

}  // namespace epnn
