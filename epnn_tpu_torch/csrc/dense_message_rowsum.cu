// dense_message_rowsum — the far-field (beyond-cutoff) message reduction of
// the neighbor-split forward:
//
//   out_i = sum_j cv_j * relu(relu(pi_i + pj_j) @ W2 + b2)     (R, H)
//
// pi already carries the first-layer bias; cv_j is the column weight
// (node mask, or ones in reference-compat mode).
//
// Replaces the TPU kernel epnn_tpu/ops/pallas_kernels.py:
// dense_message_rowsum (:98) -> _dense_message_rowsum_impl (:978), whose
// pallas_call (:1040) runs _msg_kernel (:42).  The v5e lane packing
// (kron(I_P, W2), pltpu.repeat) is not carried over.
//
// Bound on the H100: operations.  Each live pair needs the H x H product
// relu(z1) @ W2 (2H^2 = 2,048 FLOP at H = 32) against O((R + N) H) bytes.
// On the tensor cores in 3xTF32 that is three products, 6H^2 FLOP at
// 495 TFLOP/s (1.24e-11 s a pair), plus ~4H elementwise FLOP at 67 TFLOP/s
// on the CUDA cores: >= 0.06 ms at 2,220 atoms, >= 3.9 ms at 17,760.  In
// fp32 on the CUDA cores alone the same work is bound at 0.16 / 10.2 ms.
//
// Design: wgmma m64n32k8 TF32, split 3x (common.cuh) for fp32 grade.  A
// block is one warpgroup: 4 warps, 64 rows i, 16 a warp; it walks the
// columns j.  For each j, A = relu(pi_i + pj_j) (64 x 32) is built in
// registers (far_a: the m16n8k8 fragment each warp already uses for
// mma.sync) from the 16 pi values a thread keeps for the whole kernel and
// 8 pj values broadcast from shared memory, split into hi and lo, and
// multiplied by the constant W2, whose split B tiles sit in shared memory
// (4 k-steps x hi/lo, 8 KB, written once a block).  The product starts
// from b2, and each thread folds cv_j * relu(z2) into the 16 sums it owns
// in the C layout, so the sum over j is a register accumulation: no
// shuffle, no shared-memory reduction.  Per column that is 12 wgmma (4
// k-steps x 3 products): the products the backward's far_z2 makes with
// mma.sync, in the same order, and on the H100 the same bits.  wgmma and
// not mma.sync because the tensor-core products set this kernel's pace and
// mma.sync issues TF32 at a fraction of the tensor cores' rate
// (tools/far_field_pace.py times what sets the pace).  Two columns are in
// flight at a time: the second column's A is built while the first one's
// products run, and the first one's sums are folded while the second
// one's run.  The pj and cv chunks (32 columns) are staged with cp.async
// into a double-buffered ring, so the next chunk loads while this one
// computes.  Rows give too few blocks for
// 132 SMs at 2,220 atoms, so the column range also splits into a fixed
// number of parts (gridDim.y); epnn::sum_parts adds them in order —
// deterministic, no atomics.  Columns past N enter as pj = 0, cv = 0 and
// add exactly zero.
#include "common.cuh"

namespace {

constexpr int kH = epnn::kFarH;
constexpr int kThreads = 128;               // one warpgroup
constexpr int kRowsPerBlock = 64;           // 16 a warp
constexpr int kChunk = 32;                  // columns per staged chunk
constexpr int kTile = 8 * kH;               // floats of a k-step's B tile
// B tile of a k-step: element (n, k) at (n / 8) * 64 + (k / 4) * 32 +
// (n % 8) * 4 + k % 4 — core matrices of 8 n x 4 k, the k halves 128 bytes
// apart, the 8-row groups 256 bytes apart
constexpr int kLbo = 128, kSbo = 256;
static_assert(kChunk % 2 == 0, "columns go two at a time");

__global__ void __launch_bounds__(kThreads, 3)
dmr_partial(const float* __restrict__ pi, const float* __restrict__ pj,
            const float* __restrict__ cv, const float* __restrict__ w2,
            const float* __restrict__ b2, float* __restrict__ part, int R,
            int N, int cols_per_split) {
  __shared__ __align__(128) float s_b[2][4][kTile];  // W2 hi, lo; k-step
  __shared__ __align__(16) float s_pj[2][kChunk][kH];
  __shared__ float s_cv[2][kChunk];

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5) * 16;
  const int j0 = blockIdx.y * cols_per_split;
  const int j1 = min(N, j0 + cols_per_split);
  const int chunks = (j1 - j0 + kChunk - 1) / kChunk;

  // chunk c's columns into ring slot c % 2; past j1: zeros
  auto stage = [&](int c) {
    const int jt = j0 + c * kChunk;
    float* dst = &s_pj[c & 1][0][0];
    for (int e = threadIdx.x; e < kChunk * kH; e += kThreads) {
      const bool in = jt + e / kH < j1;
      epnn::cp_async4(dst + e, pj + (in ? (size_t)jt * kH + e : 0), in);
    }
    for (int e = threadIdx.x; e < kChunk; e += kThreads) {
      const bool in = jt + e < j1;
      epnn::cp_async4(&s_cv[c & 1][e], cv + (in ? jt + e : 0), in);
    }
    epnn::cp_async_commit();
  };
  stage(0);

  // W2's B tiles, split; column k of k-step ks is feature 8 (k % 4) + 2ks +
  // k / 4, far_a's order
  for (int e = threadIdx.x; e < 4 * kTile; e += kThreads) {
    const int ks = e / kTile, o = e % kTile;
    const int n = (o / 64) * 8 + (o / 4) % 8;
    const int f = 8 * (o % 4) + 2 * ks + (o / 32) % 2;
    uint32_t hi, lo;
    epnn::tf32_split(w2[f * kH + n], hi, lo);
    s_b[0][ks][o] = __uint_as_float(hi);
    s_b[1][ks][o] = __uint_as_float(lo);
  }
  epnn::wg::fence_proxy_async();
  uint64_t b_hi[4], b_lo[4];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    b_hi[ks] = epnn::wg::desc(&s_b[0][ks][0], kLbo, kSbo);
    b_lo[ks] = epnn::wg::desc(&s_b[1][ks][0], kLbo, kSbo);
  }
  float bias[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    bias[nt][0] = b2[8 * nt + 2 * t];
    bias[nt][1] = b2[8 * nt + 2 * t + 1];
  }
  float xa[8], xb[8];
  epnn::load_row8(pi + (size_t)(r0 + g) * kH, t, r0 + g < R, xa);
  epnn::load_row8(pi + (size_t)(r0 + g + 8) * kH, t, r0 + g + 8 < R, xb);

  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.0f;

  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      stage(c + 1);
      epnn::cp_async_wait<1>();
    } else {
      epnn::cp_async_wait<0>();
    }
    __syncthreads();  // chunk c (and, the first time, the B tiles) landed
    const float* sp = &s_pj[c & 1][0][0];
    const float* scv = &s_cv[c & 1][0];
    // column j's A and accumulator (b2), then its 12 products as a group
    auto issue = [&](int j, uint32_t (&ah)[4][4], uint32_t (&al)[4][4],
                     float (&d)[16]) {
      const float4 p0 = *reinterpret_cast<const float4*>(sp + j * kH + 8 * t);
      const float4 p1 =
          *reinterpret_cast<const float4*>(sp + j * kH + 8 * t + 4);
      const float xs[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) epnn::far_a(xa, xb, xs, ks, ah[ks], al[ks]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        d[4 * nt] = d[4 * nt + 2] = bias[nt][0];
        d[4 * nt + 1] = d[4 * nt + 3] = bias[nt][1];
      }
      epnn::wg::fence_regs(d);
      epnn::wg::fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        epnn::wg::mma_3xtf32(d, ah[ks], al[ks], b_hi[ks], b_lo[ks]);
      epnn::wg::commit();
    };
    auto fold = [&](int j, float (&d)[16]) {
      epnn::wg::fence_regs(d);
      const float cj = scv[j];
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] = fmaf(cj, epnn::relu(d[i]), acc[i]);
    };
    uint32_t ah0[4][4], al0[4][4], ah1[4][4], al1[4][4];
    for (int j = 0; j < kChunk; j += 2) {
      float d0[16], d1[16];
      issue(j, ah0, al0, d0);
      issue(j + 1, ah1, al1, d1);
      epnn::wg::wait<1>();
      fold(j, d0);
      epnn::wg::wait<0>();
      fold(j + 1, d1);
    }
    __syncthreads();  // slot c % 2 is free for chunk c + 2
  }

  float* dst = part + (size_t)blockIdx.y * R * kH;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + g + 8 * half;
    if (row < R) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        *reinterpret_cast<float2*>(dst + (size_t)row * kH + 8 * nt + 2 * t) =
            make_float2(acc[4 * nt + 2 * half], acc[4 * nt + 2 * half + 1]);
    }
  }
}

}  // namespace

// part: (splits, R, H) scratch; out: (R, H); the column range splits into
// parts of cols_per_split.  Returns cudaGetLastError().
extern "C" int epnn_dense_message_rowsum(const float* pi, const float* pj,
                                         const float* cv, const float* w2,
                                         const float* b2, float* part,
                                         float* out, int R, int N, int H,
                                         int splits, int cols_per_split,
                                         cudaStream_t stream) {
  if (H != kH || R <= 0 || N <= 0 || splits <= 0 || cols_per_split <= 0 ||
      (long long)(splits - 1) * cols_per_split >= N)
    return cudaErrorInvalidValue;
  const dim3 grid((R + kRowsPerBlock - 1) / kRowsPerBlock, splits);
  dmr_partial<<<grid, kThreads, 0, stream>>>(pi, pj, cv, w2, b2, part, R, N,
                                             cols_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rh = R * H;
  epnn::sum_parts<<<(rh + 255) / 256, 256, 0, stream>>>(part, out, rh,
                                                        splits);
  return cudaGetLastError();
}
