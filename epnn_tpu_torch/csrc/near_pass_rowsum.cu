// near_pass_rowsum — one electron-passing round's antisymmetric row sums
// over the gathered near pairs:
//
//   out_i = sum_s gh_is * (mlp(pi_i + pj_j + e_s) - mlp(pi_j + pj_i + e_s))
//   j = idx_is, e_s = rbf_s @ W1e, mlp(z) = relu(relu(z) @ W2 + b2)
//
// from rs = [pi | pj] (N, 2H) and its gathered rows ppn = rs[idx] (N*K, 2H);
// gh = 0.5 * gate with the slot mask folded in.  The caller applies W_out
// (b_out cancels in the difference).
//
// Replaces the TPU kernel epnn_tpu/ops/pallas_kernels.py: near_pass_rowsum
// (:1410) -> _near_pass_impl (:1347), whose pallas_call (:1368) runs
// _near_pass_kernel (:1312).  The v5e lane roll of [pi | pj] is not carried
// over: the two orderings are two register chains here.
//
// Bound on the H100: bytes.  Only live slots (gh != 0) are read: each
// reads (2H + E) floats and costs about 2EH + 4H^2 FLOP.  The 2,220-atom
// water box at K = 24 has about 17k live slots of N*K = 53k: about 8.8 MB
// (2.6 us at 3.35 TB/s) against 0.13 GFLOP (1.9 us at 67 TFLOP/s).
//
// Hazard: charge conservation needs the pair (i, j)'s term in row i to be
// the exact negation of its term in row j.  Per slot the lane computes one
// epart, then zn = (pi_i + pj_j) + epart and zt = (pi_j + pj_i) + epart in
// that add order, and runs both through the same fmaf chain
// (matvec2_bias).  Row j's slot for i sees the same d^2, hence the same
// rbf, epart and gate, and swapped zn/zt; so its (hn - ht) is the exact
// negation of row i's.  The row sum itself is a fixed sequential order
// over the slots (one warp per row, lanes per slot, the sum by column
// through shared memory): deterministic, no atomics.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;

template <int H, int E>
__global__ void __launch_bounds__(kWarps * 32)
npr_kernel(const float* __restrict__ rs, const float* __restrict__ ppn,
           const float* __restrict__ rbf, const float* __restrict__ gh,
           const float* __restrict__ w1e, const float* __restrict__ w2,
           const float* __restrict__ b2, float* __restrict__ out, int N,
           int K) {
  __shared__ float4 s_w1e[E * H / 4];
  __shared__ float4 s_w2[H * H / 4];
  __shared__ float s_b2[H];
  __shared__ float s_row[kWarps][2 * H];  // [pi_i | pj_i]
  __shared__ float s_slot[kWarps][32][H + 1];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * kWarps + warp;

  epnn::stage(s_w1e, w1e, E * H);
  epnn::stage(s_w2, w2, H * H);
  for (int t = threadIdx.x; t < H; t += blockDim.x) s_b2[t] = b2[t];
  if (i < N)
    for (int k = lane; k < 2 * H; k += 32)
      s_row[warp][k] = rs[(size_t)i * 2 * H + k];
  __syncthreads();
  if (i >= N) return;  // no block-wide barrier follows

  constexpr int kOut = (H + 31) / 32;
  float row[kOut];
#pragma unroll
  for (int r = 0; r < kOut; ++r) row[r] = 0.0f;

  for (int s0 = 0; s0 < K; s0 += 32) {
    const int s = s0 + lane;
    const size_t slot = (size_t)i * K + s;
    const float g = s < K ? gh[slot] : 0.0f;
    float d[H];
    if (g != 0.0f) {
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
      float zn[H], zt[H];
      const float4* pn = reinterpret_cast<const float4*>(ppn + slot * 2 * H);
#pragma unroll
      for (int k4 = 0; k4 < H / 4; ++k4) {
        const float4 pin = pn[k4];           // pi_j
        const float4 pjn = pn[H / 4 + k4];   // pj_j
        const float vi[4] = {pin.x, pin.y, pin.z, pin.w};
        const float vj[4] = {pjn.x, pjn.y, pjn.z, pjn.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int k = 4 * k4 + u;
          zn[k] = epnn::relu(__fadd_rn(__fadd_rn(s_row[warp][k], vj[u]), ep[k]));
          zt[k] = epnn::relu(__fadd_rn(__fadd_rn(vi[u], s_row[warp][H + k]), ep[k]));
        }
      }
      float yn[H], yt[H];
      epnn::matvec2_bias<H, H>(zn, zt, s_w2, s_b2, yn, yt);
#pragma unroll
      for (int o = 0; o < H; ++o)
        d[o] = __fmul_rn(g, __fsub_rn(epnn::relu(yn[o]), epnn::relu(yt[o])));
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

extern "C" int epnn_near_pass_rowsum(const float* rs, const float* ppn,
                                     const float* rbf, const float* gh,
                                     const float* w1e, const float* w2,
                                     const float* b2, float* out, int N, int K,
                                     int H, int E, cudaStream_t stream) {
  if (H != 32 || E != 48 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  const int blocks = (N + kWarps - 1) / kWarps;
  npr_kernel<32, 48><<<blocks, kWarps * 32, 0, stream>>>(
      rs, ppn, rbf, gh, w1e, w2, b2, out, N, K);
  return cudaGetLastError();
}
