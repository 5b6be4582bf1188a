// dense_message_rowsum_bwd — the backward of the far-field message
// reduction out_i = sum_j cv_j * relu(z2_ij), z2 = relu(z1) @ W2 + b2,
// z1 = pi_i + pj_j.  From the cotangent g (R, H):
//
//   e2  = cv_j * g_i (.) 1[z2 > 0]       dpi_i = sum_j z1bar_ij    (R, H)
//   z1bar = (e2 @ W2^T) (.) 1[z1 > 0]     dpj_j = sum_i z1bar_ij    (N, H)
//   dW2 = sum_ij relu(z1)^T e2            db2   = sum_ij e2          (H,)
//
// cv gets no gradient (the caller passes the node mask).  z1 and z2 are
// recomputed in the tile; no (R, N, H) residual ever exists.
//
// Replaces the TPU kernel epnn_tpu/ops/pallas_kernels.py: _dmr_bwd (:1079),
// whose pallas_call (:1119) runs _msg_bwd_kernel (:921).  The v5e lane
// packing (kron(I_P, W2), pltpu.repeat) is not carried over.
//
// Bound on the H100: operations.  Each pair needs three H x H contractions
// (z2, e2 @ W2^T, the dW2 outer product) plus ~9H elementwise: 6H^2 + 9H
// = 6.4 kFLOP at H = 32, fp32 on the CUDA cores (67 TFLOP/s, TF32 off):
// 31.8 GFLOP, >= 0.47 ms, at 2,220 atoms.
//
// Design: two passes over the pair grid, each in the forward's
// register-tiled layout (16 x 16 pairs per chunk, 128 threads, each thread
// 8 pairs x 8 outputs, relu(z1) built once per chunk into shared memory).
//   * Pass R owns 16 rows and streams column chunks.  It computes z2, e2
//     (kept in shared memory), z1bar = e2 @ W2^T, and sums z1bar over its
//     8 pairs of one row (dpi), e2 over its pairs (db2) and the chunk's
//     relu(z1)^T e2 (dW2; thread = one output column o, 8 k).
//   * Pass C owns 16 columns and streams row chunks; the same arithmetic
//     summed over a thread's 8 pairs of one column gives dpj.
// Both passes give their pairs identical z2 and e2 (the same fmaf chains
// over the same values).  Too few blocks fill the card from rows or
// columns alone, so each pass also splits its streamed range into a fixed
// number of parts.  Partial sums land in scratch — per split for dpi and
// dpj, per pass-R block for dW2 and db2 — and a second kernel adds them in
// a fixed order: no atomics, the same bits on every launch.  Scratch is
// splits_r * R * H + splits_c * N * H + blocks_r * (H^2 + H) floats.
// Rows past R enter as pi = 0, g = 0 and columns past N as pj = 0, cv = 0;
// both give e2 = 0 and add exactly zero.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kOwn = 16;                    // owned rows (pass R) / cols (C)
constexpr int kStream = 16;                 // streamed entries per chunk
constexpr int kPairs = kOwn * kStream;      // 256 pairs per chunk
constexpr int kTileP = 8;                   // pairs per thread
constexpr int kTileO = 8;                   // outputs per thread
constexpr int kH = 32;
constexpr int kSlots4 = kPairs / 4;         // float4 slots per tile row
constexpr int kEPad = 1;                    // float4 pad per e2 row

// shared-memory layout (floats), dynamic: above the 48 KB static limit
struct Smem {
  float4 w2[kH * kH / 4];          // W2 [k][o]
  float4 w2t[kH * kH / 4];         // W2^T [o][k]
  float4 z[kH][kSlots4];           // relu(z1) [k][slot]
  float4 e[kH][kSlots4 + kEPad];   // e2 [o][slot], padded rows
  float b2[kH];
  float own[kOwn][kH + 1];         // owned projections (pi or pj)
  float strT[kH][kStream + 1];     // streamed projections, transposed
  float g[kOwn][kH + 1];           // g of the tile's 16 rows
  float cv[kStream];               // cv of the tile's 16 columns
  float half[kOwn][kH];            // second-half sums
  float db2[kThreads / (kH / kTileO)][kH];
};

// Slot s of a tile row holds pair p = g * 8 + q * 4 + r (q = s / 128,
// g = (s % 128) / 4, r = s % 4), so pair group pg's 8 pairs are the float4
// slots pg and 32 + pg: a warp's reads are contiguous 128-byte rows.
__device__ __forceinline__ int slot_pair(int s) {
  const int q = s / (kPairs / 2), g = (s % (kPairs / 2)) / 4, r = s % 4;
  return g * kTileP + q * 4 + r;
}

// kRows: pass R (owns rows; dpi, dW2, db2), else pass C (owns cols; dpj).
template <bool kRows>
__global__ void __launch_bounds__(kThreads, 2)
dmr_bwd_partial(const float* __restrict__ pi, const float* __restrict__ pj,
                const float* __restrict__ cv, const float* __restrict__ w2,
                const float* __restrict__ b2, const float* __restrict__ g,
                float* __restrict__ part_d, float* __restrict__ part_w,
                float* __restrict__ part_b, int R, int N, int per_split) {
  constexpr int H = kH;
  constexpr int kOutGroups = H / kTileO;          // 4
  constexpr int kHalves = kStream / kTileP;       // 2
  static_assert(kOutGroups * (kPairs / kTileP) == kThreads, "tiling");
  extern __shared__ float4 smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);

  const int n_own = kRows ? R : N;
  const int n_str = kRows ? N : R;
  const float* own_src = kRows ? pi : pj;
  const float* str_src = kRows ? pj : pi;

  const int tid = threadIdx.x;
  const int og = tid % kOutGroups;
  const int pg = tid / kOutGroups;
  const int ol = pg / kHalves;     // the thread's owned entry
  const int sh = pg % kHalves;     // its half of the streamed chunk
  const int o0 = blockIdx.x * kOwn;
  const int s0 = blockIdx.y * per_split;
  const int s1 = min(n_str, s0 + per_split);

  epnn::stage(s.w2, w2, H * H);
  for (int t = tid; t < H; t += kThreads) s.b2[t] = b2[t];
  for (int t = tid; t < kOwn * H; t += kThreads) {
    const int r = t / H, k = t % H;
    const bool in = o0 + r < n_own;
    s.own[r][k] = in ? own_src[(size_t)(o0 + r) * H + k] : 0.0f;
    if (kRows) s.g[r][k] = in ? g[(size_t)(o0 + r) * H + k] : 0.0f;
  }
  if (!kRows)
    for (int t = tid; t < kOwn; t += kThreads)
      s.cv[t] = o0 + t < N ? cv[o0 + t] : 0.0f;
  __syncthreads();
  {
    const float* w = reinterpret_cast<const float*>(s.w2);
    float* wt = reinterpret_cast<float*>(s.w2t);
    for (int t = tid; t < H * H; t += kThreads)
      wt[(t % H) * H + t / H] = w[t];
  }

  float acc_d[kTileO], acc_b[kTileO], acc_w[kTileO];
#pragma unroll
  for (int o = 0; o < kTileO; ++o) acc_d[o] = acc_b[o] = acc_w[o] = 0.0f;
  // dW2 mapping (pass R): warp kg owns k = kg*8 .. kg*8+7, lane = column o
  const int wk0 = (tid / 32) * kTileO;
  const int wo = tid % 32;

  for (int st = s0; st < s1; st += kStream) {
    const int ns = min(kStream, s1 - st);
    __syncthreads();  // the previous chunk's tiles are consumed
    for (int t = tid; t < kStream * H; t += kThreads) {
      const int j = t / H, k = t % H;
      const bool in = j < ns;
      s.strT[k][j] = in ? str_src[(size_t)(st + j) * H + k] : 0.0f;
      if (!kRows) s.g[j][k] = in ? g[(size_t)(st + j) * H + k] : 0.0f;
    }
    if (kRows)
      for (int t = tid; t < kStream; t += kThreads)
        s.cv[t] = t < ns ? cv[st + t] : 0.0f;
    __syncthreads();
    for (int e = tid; e < H * kPairs; e += kThreads) {
      const int k = e / kPairs, sl = e % kPairs;
      const int p = slot_pair(sl);
      reinterpret_cast<float*>(s.z[k])[sl] =
          epnn::relu(s.own[p / kStream][k] + s.strT[k][p % kStream]);
    }
    __syncthreads();

    // z2 = relu(z1) @ W2 + b2, then e2 = cv_j * g_i * 1[z2 > 0] in place
    float y[kTileP][kTileO];
#pragma unroll
    for (int p = 0; p < kTileP; ++p)
#pragma unroll
      for (int o = 0; o < kTileO; ++o) y[p][o] = s.b2[og * kTileO + o];
#pragma unroll
    for (int k = 0; k < H; ++k) {
      const float4 za = s.z[k][pg];
      const float4 zb = s.z[k][kPairs / 8 + pg];
      const float4 wa = s.w2[k * (H / 4) + og * 2];
      const float4 wb = s.w2[k * (H / 4) + og * 2 + 1];
      const float zv[kTileP] = {za.x, za.y, za.z, za.w, zb.x, zb.y, zb.z, zb.w};
      const float wv[kTileO] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int p = 0; p < kTileP; ++p)
#pragma unroll
        for (int o = 0; o < kTileO; ++o) y[p][o] = fmaf(zv[p], wv[o], y[p][o]);
    }
#pragma unroll
    for (int p = 0; p < kTileP; ++p) {
      const int si = sh * kTileP + p;        // streamed index of pair p
      const int row = kRows ? ol : si;
      const float c = s.cv[kRows ? si : ol];
#pragma unroll
      for (int o = 0; o < kTileO; ++o) {
        const float e2 = y[p][o] > 0.0f ? s.g[row][og * kTileO + o] * c : 0.0f;
        y[p][o] = e2;
        if (kRows) acc_b[o] += e2;
      }
    }
#pragma unroll
    for (int o = 0; o < kTileO; ++o) {
      s.e[og * kTileO + o][pg] = make_float4(y[0][o], y[1][o], y[2][o], y[3][o]);
      s.e[og * kTileO + o][kPairs / 8 + pg] =
          make_float4(y[4][o], y[5][o], y[6][o], y[7][o]);
    }
    __syncthreads();

    // z1bar = (e2 @ W2^T) * 1[z1 > 0], summed over the thread's 8 pairs
#pragma unroll
    for (int p = 0; p < kTileP; ++p)
#pragma unroll
      for (int o = 0; o < kTileO; ++o) y[p][o] = 0.0f;
#pragma unroll
    for (int o = 0; o < H; ++o) {
      const float4 ea = s.e[o][pg];
      const float4 eb = s.e[o][kPairs / 8 + pg];
      const float4 wa = s.w2t[o * (H / 4) + og * 2];
      const float4 wb = s.w2t[o * (H / 4) + og * 2 + 1];
      const float ev[kTileP] = {ea.x, ea.y, ea.z, ea.w, eb.x, eb.y, eb.z, eb.w};
      const float wv[kTileO] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int p = 0; p < kTileP; ++p)
#pragma unroll
        for (int k = 0; k < kTileO; ++k) y[p][k] = fmaf(ev[p], wv[k], y[p][k]);
    }
#pragma unroll
    for (int k = 0; k < kTileO; ++k) {
      const float4 za = s.z[og * kTileO + k][pg];
      const float4 zb = s.z[og * kTileO + k][kPairs / 8 + pg];
      const float zv[kTileP] = {za.x, za.y, za.z, za.w, zb.x, zb.y, zb.z, zb.w};
#pragma unroll
      for (int p = 0; p < kTileP; ++p)
        acc_d[k] += zv[p] > 0.0f ? y[p][k] : 0.0f;
    }

    if (kRows) {
      // dW2[k][o] += sum over the chunk's pairs of relu(z1)[k] * e2[o]
#pragma unroll 4
      for (int s4 = 0; s4 < kSlots4; ++s4) {
        const float4 ev = s.e[wo][s4];
#pragma unroll
        for (int k = 0; k < kTileO; ++k) {
          const float4 zv = s.z[wk0 + k][s4];
          float a = fmaf(zv.x, ev.x, acc_w[k]);
          a = fmaf(zv.y, ev.y, a);
          a = fmaf(zv.z, ev.z, a);
          acc_w[k] = fmaf(zv.w, ev.w, a);
        }
      }
    }
  }

  // dpi / dpj: add the second streamed half to the first, in that order
  if (sh == 1) {
#pragma unroll
    for (int k = 0; k < kTileO; ++k) s.half[ol][og * kTileO + k] = acc_d[k];
  }
  if (kRows) {
#pragma unroll
    for (int o = 0; o < kTileO; ++o) s.db2[pg][og * kTileO + o] = acc_b[o];
  }
  __syncthreads();
  if (sh == 0 && o0 + ol < n_own) {
    float* dst = part_d + ((size_t)blockIdx.y * n_own + o0 + ol) * H +
                 og * kTileO;
#pragma unroll
    for (int k = 0; k < kTileO; ++k)
      dst[k] = acc_d[k] + s.half[ol][og * kTileO + k];
  }
  if (kRows) {
    const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
#pragma unroll
    for (int k = 0; k < kTileO; ++k)
      part_w[blk * H * H + (wk0 + k) * H + wo] = acc_w[k];
    if (tid < H) {
      float b = 0.0f;
      for (int q = 0; q < kThreads / kOutGroups; ++q) b += s.db2[q][tid];
      part_b[blk * H + tid] = b;
    }
  }
}

cudaError_t launch_sum(const float* part, float* out, int count, int parts,
                       cudaStream_t stream) {
  epnn::sum_parts<<<(count + 255) / 256, 256, 0, stream>>>(part, out, count,
                                                           parts);
  return cudaGetLastError();
}

}  // namespace

// work: scratch of splits_r*R*H + splits_c*N*H + blocks_r*(H*H + H) floats,
// blocks_r = ceil(R/16) * splits_r; rows_per_split / cols_per_split are
// multiples of 16.  Writes dpi (R, H), dpj (N, H), dw2 (H, H), db2 (H,).
// Returns the first CUDA error (0 on success).
extern "C" int epnn_dense_message_rowsum_bwd(
    const float* pi, const float* pj, const float* cv, const float* w2,
    const float* b2, const float* g, float* work, float* dpi, float* dpj,
    float* dw2, float* db2, int R, int N, int H, int splits_r,
    int cols_per_split, int splits_c, int rows_per_split,
    cudaStream_t stream) {
  if (H != kH || R <= 0 || N <= 0 || splits_r <= 0 || splits_c <= 0 ||
      cols_per_split % kStream || rows_per_split % kStream)
    return cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      dmr_bwd_partial<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dmr_bwd_partial<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;

  const int row_blocks = (R + kOwn - 1) / kOwn;
  const int col_blocks = (N + kOwn - 1) / kOwn;
  const int blocks_r = row_blocks * splits_r;
  float* part_dpi = work;
  float* part_dpj = part_dpi + (size_t)splits_r * R * H;
  float* part_w = part_dpj + (size_t)splits_c * N * H;
  float* part_b = part_w + (size_t)blocks_r * H * H;

  dmr_bwd_partial<true><<<dim3(row_blocks, splits_r), kThreads, smem,
                          stream>>>(pi, pj, cv, w2, b2, g, part_dpi, part_w,
                                    part_b, R, N, cols_per_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dmr_bwd_partial<false><<<dim3(col_blocks, splits_c), kThreads, smem,
                           stream>>>(pi, pj, cv, w2, b2, g, part_dpj,
                                     nullptr, nullptr, R, N, rows_per_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = launch_sum(part_dpi, dpi, R * H, splits_r, stream))) return err;
  if ((err = launch_sum(part_dpj, dpj, N * H, splits_c, stream))) return err;
  if ((err = launch_sum(part_w, dw2, H * H, blocks_r, stream))) return err;
  return launch_sum(part_b, db2, H, blocks_r, stream);
}
