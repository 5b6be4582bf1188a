// fused_message_rowsum — one dense message round with the pair
// featurization in the tile:
//
//   out_i = sum_j w_ij * relu(relu(pi_i + pj_j + rbf_ij @ W1e) @ W2 + b2)
//
// rbf_ij: d^2 from the coordinates, the cosine envelope (cleared for self
// pairs and masked atoms) and E Gaussian channels around mu.  w_ij is the
// pair mask m_i m_j, diagonal kept (masked = 1), or cv_j (masked = 0,
// reference-compat mode).  pi carries the first-layer bias; the caller
// applies W_out and the sum_j b_out term.
//
// Replaces the TPU kernel epnn_tpu/ops/pallas_kernels.py:
// fused_message_rowsum (:490), whose pallas_call (:591) runs _msg_rbf_kernel
// (:308) with the featurization _tile_rbf_flat (:178); the lane-packed
// variant (_msg_packed_kernel :874, pallas_call :561) is a v5e layout of the
// same math and is not carried over.
//
// Bound on the H100: operations.  A pair costs 2EH (the W1e contraction)
// + 2H^2 (the mid layer) + about 400 elementwise FLOP, 5.6 kFLOP at H = 32,
// E = 48, against O((R + N) H) bytes; fp32 runs on the CUDA cores (TF32 is
// off): 27 GFLOP, >= 0.41 ms at 67 TFLOP/s, for the 2,220-atom box.  The
// E exps a pair are a few percent of that at the SFU rate.
//
// Design: the far field's layout (dense_message_rowsum.cu) with the
// featurization in front.  A block of 256 threads owns 16 rows and streams
// its part of the columns in chunks of 16.  Per chunk: each thread
// featurizes one of the 256 pairs into an (E, 256) tile in shared memory;
// the W1e product is register-tiled (8 pairs x 4 outputs a thread), its
// result Z = relu((pi_i + pj_j) + epart) overwrites the tile, and the mid
// layer runs on Z the same way.  The epilogue folds relu(. + b2) * w_ij
// into per-row sums, the two column halves of a row are added in a fixed
// order, and the column parts (gridDim.y) are added in order by a second
// kernel: deterministic, no atomics.  Columns past N enter with mask 0,
// cv 0 and pj 0 and add exactly zero.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;                       // rows per block
constexpr int kCols = 16;                       // columns per chunk
constexpr int kH = 32;
constexpr int kE = 48;

struct Smem {
  float4 w1e[kE * kH / 4];                      // W1e [e][o]
  float4 w2[kH * kH / 4];                       // W2 [k][o]
  float4 tile[kE * epnn::kTilePairs / 4];       // rbf, then Z in rows < H
  float b2[kH];
  float mu[kE];
  float pi[kRows][kH + 1];
  float pj[kCols][kH + 1];
  float xr[kRows][4];                           // x, y, z, mask of the rows
  float xc[kCols][4];                           // ... of the chunk's columns
  float wc[kCols];                              // cv of the chunk's columns
  float half[kRows][kH];                        // second column half sums
};

__global__ void __launch_bounds__(kThreads, 2)
fmr_partial(const float* __restrict__ pi, const float* __restrict__ pj,
            const float* __restrict__ xyz, const float* __restrict__ mask,
            const float* __restrict__ cv, const float* __restrict__ w1e,
            const float* __restrict__ w2, const float* __restrict__ b2,
            const float* __restrict__ mu, float* __restrict__ part, int N,
            int cols_per_split, int masked, float cutoff, float eta) {
  static_assert(kRows * kCols == epnn::kTilePairs, "one pair a thread");
  static_assert((kH / 4) * (epnn::kTilePairs / 8) == kThreads, "tiling");
  extern __shared__ float4 smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x;
  const int og = tid % (kH / 4);     // outputs og*4 .. og*4+3
  const int pg = tid / (kH / 4);     // pairs pg*8 .. pg*8+7
  const int il = pg / 2;             // their row within the block
  const int jh = pg % 2;             // their column half within the chunk
  const int i0 = blockIdx.x * kRows;
  const int j0 = blockIdx.y * cols_per_split;
  const int j1 = min(N, j0 + cols_per_split);
  const float neg_eta = -eta;

  epnn::stage(s.w1e, w1e, kE * kH);
  epnn::stage(s.w2, w2, kH * kH);
  for (int t = tid; t < kH; t += kThreads) s.b2[t] = b2[t];
  for (int t = tid; t < kE; t += kThreads) s.mu[t] = mu[t];
  for (int t = tid; t < kRows * kH; t += kThreads) {
    const int r = t / kH, k = t % kH;
    s.pi[r][k] = i0 + r < N ? pi[(size_t)(i0 + r) * kH + k] : 0.0f;
  }
  for (int t = tid; t < kRows * 4; t += kThreads) {
    const int r = t / 4, a = t % 4;
    const bool ok = i0 + r < N;
    s.xr[r][a] = !ok ? 0.0f : a < 3 ? xyz[(size_t)(i0 + r) * 3 + a]
                                    : mask[i0 + r];
  }

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float* tile = reinterpret_cast<float*>(s.tile);

  for (int jt = j0; jt < j1; jt += kCols) {
    const int nj = min(kCols, j1 - jt);
    __syncthreads();  // the previous chunk's tile and columns are consumed
    for (int t = tid; t < kCols * kH; t += kThreads) {
      const int j = t / kH, k = t % kH;
      s.pj[j][k] = j < nj ? pj[(size_t)(jt + j) * kH + k] : 0.0f;
    }
    for (int t = tid; t < kCols * 4; t += kThreads) {
      const int j = t / 4, a = t % 4;
      s.xc[j][a] = j >= nj ? 0.0f : a < 3 ? xyz[(size_t)(jt + j) * 3 + a]
                                          : mask[jt + j];
    }
    for (int t = tid; t < kCols; t += kThreads)
      s.wc[t] = t < nj ? cv[jt + t] : 0.0f;
    __syncthreads();

    {  // featurize pair tid: row tid / 16, column tid % 16
      const int r = tid / kCols, j = tid % kCols;
      const float d2 = epnn::pair_d2(s.xr[r][0], s.xr[r][1], s.xr[r][2],
                                     s.xc[j][0], s.xc[j][1], s.xc[j][2]);
      const float cm = i0 + r != jt + j ? __fmul_rn(s.xr[r][3], s.xc[j][3])
                                        : 0.0f;
      float d;
      const float c = __fmul_rn(epnn::envelope(d2, cutoff, d), cm);
      const int slot = epnn::tile_slot(tid);
#pragma unroll 8
      for (int e = 0; e < kE; ++e)
        tile[e * epnn::kTilePairs + slot] =
            epnn::rbf_channel(c, d, s.mu[e], neg_eta);
    }
    __syncthreads();

    float y[8][4];
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int u = 0; u < 4; ++u) y[p][u] = 0.0f;
    epnn::tile_mac<kE, kH>(s.tile, s.w1e, pg, og, y);
    __syncthreads();  // every thread has read the rbf tile

    // Z = relu((pi_i + pj_j) + epart) into rows og*4 .. og*4+3 of the tile
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = og * 4 + u;
      float z[8];
#pragma unroll
      for (int p = 0; p < 8; ++p)
        z[p] = epnn::relu(__fadd_rn(
            __fadd_rn(s.pi[il][k], s.pj[jh * 8 + p][k]), y[p][u]));
      s.tile[k * (epnn::kTilePairs / 4) + pg] =
          make_float4(z[0], z[1], z[2], z[3]);
      s.tile[k * (epnn::kTilePairs / 4) + 32 + pg] =
          make_float4(z[4], z[5], z[6], z[7]);
    }
    __syncthreads();

#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int u = 0; u < 4; ++u) y[p][u] = s.b2[og * 4 + u];
    epnn::tile_mac<kH, kH>(s.tile, s.w2, pg, og, y);
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int j = jh * 8 + p;
      const float w = masked ? __fmul_rn(s.xr[il][3], s.xc[j][3]) : s.wc[j];
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u] = fmaf(w, epnn::relu(y[p][u]), acc[u]);
    }
  }

  // add the second column half of each row to the first, in that order
  if (jh == 1) {
#pragma unroll
    for (int u = 0; u < 4; ++u) s.half[il][og * 4 + u] = acc[u];
  }
  __syncthreads();
  if (jh == 0 && i0 + il < N) {
    float* dst = part + ((size_t)blockIdx.y * N + i0 + il) * kH + og * 4;
#pragma unroll
    for (int u = 0; u < 4; ++u) dst[u] = acc[u] + s.half[il][og * 4 + u];
  }
}

}  // namespace

// xyz (N, 3), mask and cv (N,), mu (E,) the RBF centers; part: (splits, N,
// H) scratch; out: (N, H); cols_per_split a multiple of 16.  Returns
// cudaGetLastError().
extern "C" int epnn_fused_message_rowsum(
    const float* pi, const float* pj, const float* xyz, const float* mask,
    const float* cv, const float* w1e, const float* w2, const float* b2,
    const float* mu, float* part, float* out, int N, int H, int E,
    int splits, int cols_per_split, int masked, float cutoff, float eta,
    cudaStream_t stream) {
  if (H != kH || E != kE || N <= 0 || splits <= 0 || cols_per_split % kCols)
    return cudaErrorInvalidValue;
  const int smem = sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      fmr_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kRows - 1) / kRows, splits);
  fmr_partial<<<grid, kThreads, smem, stream>>>(
      pi, pj, xyz, mask, cv, w1e, w2, b2, mu, part, N, cols_per_split,
      masked, cutoff, eta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int count = N * kH;
  epnn::sum_parts<<<(count + 255) / 256, 256, 0, stream>>>(part, out, count,
                                                            splits);
  return cudaGetLastError();
}
