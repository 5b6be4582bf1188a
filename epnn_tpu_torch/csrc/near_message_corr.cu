// near_message_corr — the gathered near-field correction of one message
// round of the neighbor-split forward:
//
//   out_i = sum_s mask_is * [mlp(pi_i + pjn_is + rbf_is @ W1e)
//                            - mlp(pi_i + pjn_is)]              (N, H)
//   mlp(z) = relu(relu(z) @ W2 + b2)
//
// over the K neighbor slots s of row i; pjn and rbf are pre-gathered flat
// (N*K, .) arrays, as in the JAX function.
//
// Replaces the TPU kernel epnn_tpu/ops/pallas_kernels.py:
// near_message_corr (:1286) -> _near_msg_impl (:1228), whose pallas_call
// (:1245) runs _near_msg_kernel (:1189).
//
// Bound on the H100: bytes and operations about equally.  Only live slots
// (mask != 0) are read: each reads (H + E) floats and costs about
// 2EH + 4H^2 FLOP (7.2 kFLOP at H = 32, E = 48).  The 2,220-atom water box
// at K = 24 has about 17k live slots of N*K = 53k: about 6.3 MB (1.9 us at
// 3.35 TB/s) against 0.13 GFLOP (1.9 us at 67 TFLOP/s), below the cost of
// a launch.
//
// Design: one warp per row, one lane per slot (slots beyond 32 take more
// passes).  A lane computes epart = rbf_s @ W1e once and runs both MLP
// chains with one read of each W2 entry (shared-memory broadcasts).  The
// lanes' H-vectors go through shared memory and lane o adds column o over
// the slots in order, so the row sum is a fixed sequential order over s:
// deterministic, no atomics.  Masked slots skip the arithmetic.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;

template <int H, int E>
__global__ void __launch_bounds__(kWarps * 32)
nmc_kernel(const float* __restrict__ pi, const float* __restrict__ pjn,
           const float* __restrict__ rbf, const float* __restrict__ mask,
           const float* __restrict__ w1e, const float* __restrict__ w2,
           const float* __restrict__ b2, float* __restrict__ out, int N,
           int K) {
  __shared__ float4 s_w1e[E * H / 4];
  __shared__ float4 s_w2[H * H / 4];
  __shared__ float s_b2[H];
  __shared__ float s_pi[kWarps][H];
  __shared__ float s_slot[kWarps][32][H + 1];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * kWarps + warp;

  epnn::stage(s_w1e, w1e, E * H);
  epnn::stage(s_w2, w2, H * H);
  for (int t = threadIdx.x; t < H; t += blockDim.x) s_b2[t] = b2[t];
  if (i < N)
    for (int k = lane; k < H; k += 32) s_pi[warp][k] = pi[(size_t)i * H + k];
  __syncthreads();
  if (i >= N) return;  // no block-wide barrier follows

  constexpr int kOut = (H + 31) / 32;
  float row[kOut];
#pragma unroll
  for (int r = 0; r < kOut; ++r) row[r] = 0.0f;

  for (int s0 = 0; s0 < K; s0 += 32) {
    const int s = s0 + lane;
    const size_t slot = (size_t)i * K + s;
    const float m = s < K ? mask[slot] : 0.0f;
    float d[H];
    if (m != 0.0f) {
      float ep[H];
#pragma unroll
      for (int o = 0; o < H; ++o) ep[o] = 0.0f;
      const float4* rb = reinterpret_cast<const float4*>(rbf + slot * E);
#pragma unroll
      for (int e4 = 0; e4 < E / 4; ++e4) {
        const float4 r4 = rb[e4];
        const float rv[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int o4 = 0; o4 < H / 4; ++o4) {
            const float4 wv = s_w1e[(4 * e4 + u) * (H / 4) + o4];
            ep[4 * o4 + 0] = fmaf(rv[u], wv.x, ep[4 * o4 + 0]);
            ep[4 * o4 + 1] = fmaf(rv[u], wv.y, ep[4 * o4 + 1]);
            ep[4 * o4 + 2] = fmaf(rv[u], wv.z, ep[4 * o4 + 2]);
            ep[4 * o4 + 3] = fmaf(rv[u], wv.w, ep[4 * o4 + 3]);
          }
        }
      }
      float zf[H], zn[H];
      const float4* pn = reinterpret_cast<const float4*>(pjn + slot * H);
#pragma unroll
      for (int k4 = 0; k4 < H / 4; ++k4) {
        const float4 p = pn[k4];
        const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int k = 4 * k4 + u;
          const float base = s_pi[warp][k] + pv[u];
          zf[k] = epnn::relu(base + ep[k]);
          zn[k] = epnn::relu(base);
        }
      }
      float yf[H], yn[H];
      epnn::matvec2_bias<H, H>(zf, zn, s_w2, s_b2, yf, yn);
#pragma unroll
      for (int o = 0; o < H; ++o)
        d[o] = (epnn::relu(yf[o]) - epnn::relu(yn[o])) * m;
    } else {
#pragma unroll
      for (int o = 0; o < H; ++o) d[o] = 0.0f;
    }
#pragma unroll
    for (int o = 0; o < H; ++o) s_slot[warp][lane][o] = d[o];
    __syncwarp();
    const int ns = min(32, K - s0);
#pragma unroll
    for (int r = 0; r < kOut; ++r) {
      const int o = lane + 32 * r;
      if (o < H)
        for (int l = 0; l < ns; ++l) row[r] += s_slot[warp][l][o];
    }
    __syncwarp();
  }
#pragma unroll
  for (int r = 0; r < kOut; ++r) {
    const int o = lane + 32 * r;
    if (o < H) out[(size_t)i * H + o] = row[r];
  }
}

}  // namespace

extern "C" int epnn_near_message_corr(const float* pi, const float* pjn,
                                      const float* rbf, const float* mask,
                                      const float* w1e, const float* w2,
                                      const float* b2, float* out, int N,
                                      int K, int H, int E,
                                      cudaStream_t stream) {
  if (H != 32 || E != 48 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  const int blocks = (N + kWarps - 1) / kWarps;
  nmc_kernel<32, 48><<<blocks, kWarps * 32, 0, stream>>>(
      pi, pjn, rbf, mask, w1e, w2, b2, out, N, K);
  return cudaGetLastError();
}
