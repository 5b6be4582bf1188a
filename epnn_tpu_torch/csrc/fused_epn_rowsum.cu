// fused_epn_rowsum — one dense electron-passing round with the pair
// featurization in the tile:
//
//   out_i = sum_j 0.5 * gate_ij * (hid(i, j) - hid(j, i))
//   hid(i, j) = relu(relu(pi_i + pj_j + rbf_ij @ W1e) @ W2 + b2)
//
// rbf_ij as in fused_message_rowsum.cu (envelope cleared for self pairs and
// masked atoms); gate_ij is the hard is-near gate (any channel above tol)
// or, with soft_gate, the masked envelope.  pi carries the first-layer
// bias; the caller applies W_out (b_out cancels in the difference).
//
// Replaces the TPU kernel epnn_tpu/ops/pallas_kernels.py: fused_epn_rowsum
// (:368), whose pallas_call (:469) runs _epn_kernel (:268) with the
// featurization _tile_rbf_flat (:178); the lane-packed variant
// (_epn_packed_kernel :829, pallas_call :442) is a v5e layout of the same
// math and is not carried over.
//
// Bound on the H100: operations.  A pair costs one W1e contraction (2EH)
// and two mid layers (4H^2) plus about 500 elementwise FLOP, 7.7 kFLOP at
// H = 32, E = 48: 38 GFLOP, >= 0.57 ms at 67 TFLOP/s (fp32 on the CUDA
// cores, TF32 off), for the 2,220-atom box.
//
// Hazard: charge conservation needs the transfer of (i, j) in row i to be
// the exact negation of that of (j, i) in row j, wherever the two land in
// the grid.  The pair's d^2 is taken axis by axis as (a_i - a_j)^2, the same
// bits both ways, and every later step of the featurization is a
// deterministic function of d^2 alone (common.cuh), so both positions
// see the same rbf, gate and epart (one fmaf chain over e per output).
// zn = (pi_i + pj_j) + epart and zt = (pj_i + pi_j) + epart: row j's zn is
// row i's zt (IEEE addition commutes) and the reverse.  Both go through the
// same fmaf chain (tile_mac), so hid(i, j) and hid(j, i) have the same bits
// in both rows and 0.5 * gate * (relu(yn) - relu(yt)) is negated exactly.
// Only the row sums are reordered, so sum_i out_i conserves to f32 grade.
// Build without --use_fast_math: expf, cosf, sqrt at full precision.
//
// Design: fused_message_rowsum.cu's tile (16 rows x 16 columns a chunk, 256
// threads, 8 pairs x 4 outputs a thread, W1e and W2 in shared memory, the
// column range split into a fixed number of parts added in order by a
// second kernel), with both orderings' first layers written into two
// (H, 256) tiles that overwrite the rbf tile, and the mid layer run on each.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;
constexpr int kCols = 16;
constexpr int kH = 32;
constexpr int kE = 48;
constexpr int kTileRows = kE > 2 * kH ? kE : 2 * kH;

struct Smem {
  float4 w1e[kE * kH / 4];
  float4 w2[kH * kH / 4];
  float4 tile[kTileRows * epnn::kTilePairs / 4];  // rbf; then Zn, Zt
  float b2[kH];
  float mu[kE];
  float pir[kRows][kH + 1];                       // pi of the rows
  float pjr[kRows][kH + 1];                       // pj of the rows
  float pic[kCols][kH + 1];                       // pi of the columns
  float pjc[kCols][kH + 1];                       // pj of the columns
  float xr[kRows][4];
  float xc[kCols][4];
  float gh[epnn::kTilePairs];                     // 0.5 * gate, by pair
  float half[kRows][kH];
};

__global__ void __launch_bounds__(kThreads, 2)
fepn_partial(const float* __restrict__ pi, const float* __restrict__ pj,
             const float* __restrict__ xyz, const float* __restrict__ mask,
             const float* __restrict__ w1e, const float* __restrict__ w2,
             const float* __restrict__ b2, const float* __restrict__ mu,
             float* __restrict__ part, int N, int cols_per_split,
             int soft_gate, float cutoff, float eta, float tol) {
  static_assert(kRows * kCols == epnn::kTilePairs, "one pair a thread");
  static_assert((kH / 4) * (epnn::kTilePairs / 8) == kThreads, "tiling");
  extern __shared__ float4 smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x;
  const int og = tid % (kH / 4);
  const int pg = tid / (kH / 4);
  const int il = pg / 2;
  const int jh = pg % 2;
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
    const bool ok = i0 + r < N;
    s.pir[r][k] = ok ? pi[(size_t)(i0 + r) * kH + k] : 0.0f;
    s.pjr[r][k] = ok ? pj[(size_t)(i0 + r) * kH + k] : 0.0f;
  }
  for (int t = tid; t < kRows * 4; t += kThreads) {
    const int r = t / 4, a = t % 4;
    const bool ok = i0 + r < N;
    s.xr[r][a] = !ok ? 0.0f : a < 3 ? xyz[(size_t)(i0 + r) * 3 + a]
                                    : mask[i0 + r];
  }

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float* tile = reinterpret_cast<float*>(s.tile);
  float4* zn_tile = s.tile;
  float4* zt_tile = s.tile + kH * epnn::kTilePairs / 4;

  for (int jt = j0; jt < j1; jt += kCols) {
    const int nj = min(kCols, j1 - jt);
    __syncthreads();
    for (int t = tid; t < kCols * kH; t += kThreads) {
      const int j = t / kH, k = t % kH;
      const bool ok = j < nj;
      s.pic[j][k] = ok ? pi[(size_t)(jt + j) * kH + k] : 0.0f;
      s.pjc[j][k] = ok ? pj[(size_t)(jt + j) * kH + k] : 0.0f;
    }
    for (int t = tid; t < kCols * 4; t += kThreads) {
      const int j = t / 4, a = t % 4;
      s.xc[j][a] = j >= nj ? 0.0f : a < 3 ? xyz[(size_t)(jt + j) * 3 + a]
                                          : mask[jt + j];
    }
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
      bool near = false;
#pragma unroll 8
      for (int e = 0; e < kE; ++e) {
        const float v = epnn::rbf_channel(c, d, s.mu[e], neg_eta);
        near |= v > tol;
        tile[e * epnn::kTilePairs + slot] = v;
      }
      s.gh[tid] = __fmul_rn(0.5f, soft_gate ? c : (near ? 1.0f : 0.0f));
    }
    __syncthreads();

    float y[8][4];
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int u = 0; u < 4; ++u) y[p][u] = 0.0f;
    epnn::tile_mac<kE, kH>(s.tile, s.w1e, pg, og, y);
    __syncthreads();  // every thread has read the rbf tile

    // both orderings' first layers into rows og*4 .. og*4+3 of Zn and Zt
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = og * 4 + u;
      float zn[8], zt[8];
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const int j = jh * 8 + p;
        zn[p] = epnn::relu(
            __fadd_rn(__fadd_rn(s.pir[il][k], s.pjc[j][k]), y[p][u]));
        zt[p] = epnn::relu(
            __fadd_rn(__fadd_rn(s.pjr[il][k], s.pic[j][k]), y[p][u]));
      }
      const int row = k * (epnn::kTilePairs / 4);
      zn_tile[row + pg] = make_float4(zn[0], zn[1], zn[2], zn[3]);
      zn_tile[row + 32 + pg] = make_float4(zn[4], zn[5], zn[6], zn[7]);
      zt_tile[row + pg] = make_float4(zt[0], zt[1], zt[2], zt[3]);
      zt_tile[row + 32 + pg] = make_float4(zt[4], zt[5], zt[6], zt[7]);
    }
    __syncthreads();

    float yt[8][4];
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int u = 0; u < 4; ++u) y[p][u] = yt[p][u] = s.b2[og * 4 + u];
    epnn::tile_mac<kH, kH>(zn_tile, s.w2, pg, og, y);
    epnn::tile_mac<kH, kH>(zt_tile, s.w2, pg, og, yt);
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const float g = s.gh[pg * 8 + p];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        acc[u] = __fadd_rn(acc[u], __fmul_rn(g, __fsub_rn(
                                       epnn::relu(y[p][u]),
                                       epnn::relu(yt[p][u]))));
    }
  }

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

// xyz (N, 3), mask (N,), mu (E,) the RBF centers; part: (splits, N, H)
// scratch; out: (N, H); cols_per_split a multiple of 16.  Returns
// cudaGetLastError().
extern "C" int epnn_fused_epn_rowsum(
    const float* pi, const float* pj, const float* xyz, const float* mask,
    const float* w1e, const float* w2, const float* b2, const float* mu,
    float* part, float* out, int N, int H, int E, int splits,
    int cols_per_split, int soft_gate, float cutoff, float eta, float tol,
    cudaStream_t stream) {
  if (H != kH || E != kE || N <= 0 || splits <= 0 || cols_per_split % kCols)
    return cudaErrorInvalidValue;
  const int smem = sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      fepn_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kRows - 1) / kRows, splits);
  fepn_partial<<<grid, kThreads, smem, stream>>>(
      pi, pj, xyz, mask, w1e, w2, b2, mu, part, N, cols_per_split, soft_gate,
      cutoff, eta, tol);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int count = N * kH;
  epnn::sum_parts<<<(count + 255) / 256, 256, 0, stream>>>(part, out, count,
                                                            splits);
  return cudaGetLastError();
}
