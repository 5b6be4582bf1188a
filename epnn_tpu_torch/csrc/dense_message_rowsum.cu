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
// Bound on the H100: operations.  Each pair costs about 2H^2 + 4H FLOP
// (2.2 kFLOP at H = 32) against O((R + N) H) bytes, and fp32 runs on the
// CUDA cores (67 TFLOP/s) because TF32 is off: 10.7 GFLOP, >= 0.16 ms, at
// 2,220 atoms; 690 GFLOP, >= 10.3 ms, at 17,760.
//
// Design: a block owns 16 rows and streams the columns in chunks of 16.
// Per chunk it builds the first-layer activations Z = relu(pi_i + pj_j) of
// its 256 pairs once, into shared memory, then runs Z @ W2 as a
// register-tiled product: each thread holds 8 pairs (one row, 8 columns)
// x 8 outputs, so every k step is 4 shared-memory vector loads for 64
// fmaf.  The epilogue folds relu(. + b2) * cv_j into 8 per-row sums; the
// two column halves of a row are added in a fixed order at the end.  Rows
// give too few blocks for 132 SMs at 2,220 atoms, so the column range is
// also split into a fixed number of chunks (gridDim.y): each writes its
// partial sums and a second kernel adds them in order — deterministic, no
// atomics.  Columns past N enter as pj = 0, cv = 0 and add exactly zero.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRowsPerBlock = 16;
constexpr int kCols = 16;                       // columns per chunk
constexpr int kPairs = kRowsPerBlock * kCols;   // 256 pairs per chunk
constexpr int kTileP = 8;                       // pairs per thread
constexpr int kTileO = 8;                       // outputs per thread

template <int H>
__global__ void __launch_bounds__(kThreads, 4)
dmr_partial(const float* __restrict__ pi, const float* __restrict__ pj,
            const float* __restrict__ cv, const float* __restrict__ w2,
            const float* __restrict__ b2, float* __restrict__ part, int R,
            int N, int cols_per_split) {
  constexpr int kOutGroups = H / kTileO;            // 4
  constexpr int kHalves = kCols / kTileP;           // 2 column halves per row
  static_assert(kOutGroups * (kPairs / kTileP) == kThreads, "thread tiling");

  __shared__ float4 s_w2[H * H / 4];                // W2 [k][o]
  __shared__ float s_b2[H];
  __shared__ float s_pi[kRowsPerBlock][H + 1];      // [i][k], padded
  __shared__ float s_pjT[H][kCols + 1];             // [k][j], padded
  __shared__ float s_cv[kCols];
  // Z [k][slot]: slot (q * 32 + g) * 4 + r holds pair g * 8 + q * 4 + r, so
  // the first (q = 0) and second (q = 1) float4 of the 8 pair groups a warp
  // reads are each one contiguous 128-byte row: no bank conflicts
  __shared__ float4 s_z[H][kPairs / 4];
  __shared__ float s_half[kRowsPerBlock][H];

  const int tid = threadIdx.x;
  const int og = tid % kOutGroups;   // outputs og*8 .. og*8+7
  const int pg = tid / kOutGroups;   // pairs pg*8 .. pg*8+7
  const int il = pg / kHalves;       // their row within the block
  const int jh = pg % kHalves;       // their column half within the chunk
  const int i0 = blockIdx.x * kRowsPerBlock;
  const int j0 = blockIdx.y * cols_per_split;
  const int j1 = min(N, j0 + cols_per_split);

  epnn::stage(s_w2, w2, H * H);
  for (int t = tid; t < H; t += kThreads) s_b2[t] = b2[t];
  for (int t = tid; t < kRowsPerBlock * H; t += kThreads) {
    const int r = t / H, k = t % H;
    s_pi[r][k] = i0 + r < R ? pi[(size_t)(i0 + r) * H + k] : 0.0f;
  }

  float acc[kTileO];
#pragma unroll
  for (int o = 0; o < kTileO; ++o) acc[o] = 0.0f;

  for (int jt = j0; jt < j1; jt += kCols) {
    const int nj = min(kCols, j1 - jt);
    __syncthreads();  // the previous chunk's Z and pj are consumed
    for (int t = tid; t < kCols * H; t += kThreads) {
      const int j = t / H, k = t % H;
      s_pjT[k][j] = j < nj ? pj[(size_t)(jt + j) * H + k] : 0.0f;
    }
    for (int t = tid; t < kCols; t += kThreads)
      s_cv[t] = t < nj ? cv[jt + t] : 0.0f;
    __syncthreads();
    for (int e = tid; e < H * kPairs; e += kThreads) {
      const int k = e / kPairs, s = e % kPairs;
      const int q = s / (kPairs / 2), g = (s % (kPairs / 2)) / 4, r = s % 4;
      const int p = g * kTileP + q * 4 + r;
      reinterpret_cast<float*>(s_z[k])[s] =
          epnn::relu(s_pi[p / kCols][k] + s_pjT[k][p % kCols]);
    }
    __syncthreads();

    float y[kTileP][kTileO];
#pragma unroll
    for (int p = 0; p < kTileP; ++p)
#pragma unroll
      for (int o = 0; o < kTileO; ++o) y[p][o] = s_b2[og * kTileO + o];
#pragma unroll
    for (int k = 0; k < H; ++k) {
      const float4 za = s_z[k][pg];
      const float4 zb = s_z[k][kPairs / 8 + pg];
      const float4 wa = s_w2[k * (H / 4) + og * 2];
      const float4 wb = s_w2[k * (H / 4) + og * 2 + 1];
      const float zv[kTileP] = {za.x, za.y, za.z, za.w, zb.x, zb.y, zb.z, zb.w};
      const float wv[kTileO] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int p = 0; p < kTileP; ++p)
#pragma unroll
        for (int o = 0; o < kTileO; ++o) y[p][o] = fmaf(zv[p], wv[o], y[p][o]);
    }
#pragma unroll
    for (int p = 0; p < kTileP; ++p) {
      const float c = s_cv[jh * kTileP + p];
#pragma unroll
      for (int o = 0; o < kTileO; ++o)
        acc[o] = fmaf(c, epnn::relu(y[p][o]), acc[o]);
    }
  }

  // add the second column half of each row to the first, in that order
  if (jh == 1) {
#pragma unroll
    for (int o = 0; o < kTileO; ++o) s_half[il][og * kTileO + o] = acc[o];
  }
  __syncthreads();
  if (jh == 0 && i0 + il < R) {
    float* dst = part + ((size_t)blockIdx.y * R + i0 + il) * H + og * kTileO;
#pragma unroll
    for (int o = 0; o < kTileO; ++o)
      dst[o] = acc[o] + s_half[il][og * kTileO + o];
  }
}

}  // namespace

// part: (splits, R, H) scratch; out: (R, H); cols_per_split a multiple of
// 16.  Returns cudaGetLastError().
extern "C" int epnn_dense_message_rowsum(const float* pi, const float* pj,
                                         const float* cv, const float* w2,
                                         const float* b2, float* part,
                                         float* out, int R, int N, int H,
                                         int splits, int cols_per_split,
                                         cudaStream_t stream) {
  if (H != 32 || R <= 0 || N <= 0 || splits <= 0 || cols_per_split % kCols)
    return cudaErrorInvalidValue;
  const dim3 grid((R + kRowsPerBlock - 1) / kRowsPerBlock, splits);
  dmr_partial<32><<<grid, kThreads, 0, stream>>>(pi, pj, cv, w2, b2, part, R,
                                                 N, cols_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rh = R * H;
  epnn::sum_parts<<<(rh + 255) / 256, 256, 0, stream>>>(part, out, rh,
                                                        splits);
  return cudaGetLastError();
}
