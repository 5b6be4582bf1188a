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

// ---- pair featurization of the fused dense kernels ------------------------
//
// The same ops, in the same order, as the plain versions
// (kernels.pair_d2, kernels.envelope_rbf): d^2 axis by axis as (a_i - a_j)^2 — the same
// bits for (j, i) as for (i, j) — then d, the cosine envelope with the
// coincident-atom rules, and the Gaussian channels.  Round-to-nearest
// intrinsics keep the compiler from contracting any step into an FMA, so a
// pair's features are one function of its d^2 wherever it lands in a grid.

__device__ __forceinline__ float pair_d2(float xi, float yi, float zi,
                                         float xj, float yj, float zj) {
  const float dx = __fsub_rn(xi, xj), dy = __fsub_rn(yi, yj),
              dz = __fsub_rn(zi, zj);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// d = sqrt(d^2) where d^2 > 0, else 0; returns the (unmasked) envelope
// (cos(pi d / cutoff) + 1) / 2, 0 from the cutoff on, 1 at d = 0.
__device__ __forceinline__ float envelope(float d2, float cutoff, float& d) {
  d = d2 > 0.0f ? __fsqrt_rn(d2) : 0.0f;
  float c = __fmul_rn(
      __fadd_rn(cosf(__fdiv_rn(__fmul_rn(3.14159265358979f, d), cutoff)),
                1.0f),
      0.5f);
  if (d >= cutoff) c = 0.0f;
  if (d <= 0.0f) c = 1.0f;
  return c;
}

// channel e: c * exp(-eta * (d - mu_e)^2)
__device__ __forceinline__ float rbf_channel(float c, float d, float mu,
                                             float neg_eta) {
  const float t = __fsub_rn(d, mu);
  return __fmul_rn(c, expf(__fmul_rn(neg_eta, __fmul_rn(t, t))));
}

// ---- the 16 x 16 pair tile of the fused dense kernels ---------------------
//
// A tile row k holds one feature of 256 pairs; pair p = g * 8 + q * 4 + r
// (g < 32, q < 2, r < 4) sits at float4 q * 32 + g, lane r, so the 8 pairs
// of pair group g are the float4s g and 32 + g of every row.
constexpr int kTilePairs = 256;

__device__ __forceinline__ int tile_slot(int p) {
  return ((((p >> 2) & 1) * 32 + (p >> 3)) << 2) | (p & 3);
}

// y[p][u] += sum_k tile[k][pair pg * 8 + p] * w[k][og * 4 + u] for k = 0 ..
// K - 1 in that order: one fmaf chain per output, the same for every pair.
template <int K, int H>
__device__ __forceinline__ void tile_mac(const float4* __restrict__ tile,
                                         const float4* __restrict__ w, int pg,
                                         int og, float (&y)[8][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float4 za = tile[k * (kTilePairs / 4) + pg];
    const float4 zb = tile[k * (kTilePairs / 4) + 32 + pg];
    const float4 wv = w[k * (H / 4) + og];
    const float zv[8] = {za.x, za.y, za.z, za.w, zb.x, zb.y, zb.z, zb.w};
    const float ww[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int u = 0; u < 4; ++u) y[p][u] = fmaf(zv[p], ww[u], y[p][u]);
  }
}

// out[t] = sum_p part[p * count + t] for p = 0 .. parts - 1 in that order:
// the second pass of the kernels that split a reduction into fixed parts.
__global__ void sum_parts(const float* __restrict__ part,
                          float* __restrict__ out, int count, int parts) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= count) return;
  float s = part[t];
  for (int p = 1; p < parts; ++p) s += part[(size_t)p * count + t];
  out[t] = s;
}

}  // namespace epnn
