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
// Tiers: the JAX kernel's precision argument is the library's TF32 tier
// (EPNN_TF32_PASSES, common.cuh), both built from this source: 3xTF32
// for "high" and "highest", one TF32 product a k-step for "default",
// a third of the products (6H^2 FLOP a live pair).
//
// Bound on the H100: operations.  Each live pair needs three H x H
// contractions (z2, e2 @ W2^T, the dW2 outer product), 3 x 2H^2 FLOP,
// each three tensor-core products in 3xTF32 (18H^2 FLOP at 495 TFLOP/s),
// plus ~20H elementwise FLOP on the CUDA cores (67 TFLOP/s): >= 0.19 ms at
// 2,220 atoms.  In fp32 on the CUDA cores alone: >= 0.47 ms.
//
// Design: the forward's per-warp layout on mma.sync m16n8k8 TF32, split 3x
// for fp32 grade (common.cuh), in two passes over the pair grid.
//   * Pass R: a warp owns 16 rows i and walks the columns j.  For each j it
//     builds z2 with far_z2 — the forward's A (far_a) and its products in
//     its order, which on the H100 give wgmma's bits, so a pair gets the
//     same z2 in both kernels — and e2 = cv_j * g_i * 1[z2 > 0] in the C
//     layout.
//     That C fragment is the A fragment of z1bar = e2 @ W2^T once the
//     contraction index is relabelled (A column t <-> o = 2t, t + 4 <->
//     2t + 1 within each 8-block: (a0, a1, a2, a3) = (c0, c2, c1, c3)), and
//     the output columns are permuted so that the thread gets z1bar at the
//     features 8t .. 8t + 7 it already holds: the mask 1[z1 > 0] is one add
//     away, and dpi is a register sum over j.  dW2 = relu(z1)^T e2
//     contracts over the pairs, so its B operand needs e2 transposed: the
//     warp stages e2 (hi and lo) in shared memory under __syncwarp and
//     builds relu(z1)^T as A from pi and pj on the fly, two columns (32
//     pairs, 12 products) a tensor-core chain, then adds that into fp32
//     sums on the CUDA cores: the tensor cores' accumulation truncates, so
//     a long chain's error grows with its length.  db2 sums e2 a chunk at
//     a time in registers, then into fp32 sums per warp.
//   * Pass C owns 16 columns j a warp and walks the rows i: the same
//     arithmetic, summed over i, gives dpj.
// The constant B fragments (W2 and W2^T, split) sit in shared memory; the
// streamed projections (and g, in pass C) are staged in chunks of 32 with
// cp.async into a double-buffered ring.  Each pass splits its streamed
// range into a fixed number of parts; partial sums land in scratch — per
// split for dpi and dpj, per pass-R block for dW2 and db2 (the block's four
// warps added in order first) — and epnn::sum_parts adds them in a fixed
// order: no atomics, the same bits on every launch.  Scratch is
// splits_r * R * H + splits_c * N * H + blocks_r * (H^2 + H) floats.
// Rows past R enter as pi = 0, g = 0 and columns past N as pj = 0, cv = 0;
// both give e2 = 0 and add exactly zero.
//
// Widths (common.cuh): up to 64 (padded), the products at H padded to 8
// (W2, b2 padded; pi, pj, g read at their real width, zeros past it; only
// the real H x H of dW2 is written).  dW2's rows f run in m-tiles of 16
// (padded to 16 where H is not a multiple of 16).  Up to 8 m x n tiles
// (H <= 32) its sums stay in registers over two columns as above; wider,
// each column's chain of 6 products goes straight into the warp's fp32
// sums in shared memory, one m-tile at a time.  Products of more than 4
// k-steps run as two chains added in fp32.
//
// Widths past 64 (padded): three kernels on wide.cuh's streamed products,
// nothing growing with H.  Pass R and pass C (dpi, dpj) each take one
// chunk of 32 features of z1bar a block (blockIdx.z); for each streamed
// entry a warp rebuilds z2 four n-tiles at a time (one A fragment a k-step
// for the four), forms each n-tile's e2, which is the A fragment of
// z1bar's k-step (wide.cuh's relabelled order), and contracts it with
// W2^T's fragments, read and split where needed.
// Pass W owns a 32 x 32 tile of dW2 (and, in the tiles of the first
// feature chunk, 32 entries of db2) for 64 rows a block, walks every
// column, and contracts relu(z1)^T with e2 over each column's 16 pairs a
// warp as the narrow pass R does (e2 through shared memory); the four
// warps' sums are added in order and the row blocks' by sum_parts.
#include "common.cuh"

#if EPNN_WIDE
#include "wide.cuh"

namespace {

using epnn::kH;
using epnn::kHp;
using epnn::kNT;
namespace wide = epnn::wide;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kOwnPerBlock = 16 * kWarps;
constexpr int kChunks = wide::kChunks;
constexpr int kES = wide::kNC + 8;  // e2 tile row stride: conflict-free

// z2's n-tiles kk0 .. kk0 + 3 (outputs 8kk0 .. 8kk0 + 31, b2 added; 0 past
// Hp) of a warp's 16 pairs, rows g (own row oa) and g + 8 (ob) against the
// streamed row st: z1 = own + streamed, each k-step's A fragment built
// once for the four; z[q] in the C layout
__device__ __forceinline__ void z2_tiles(const float* __restrict__ w2,
                                         const float* __restrict__ b2,
                                         int kk0, int lane, const float* oa,
                                         bool va, const float* ob, bool vb,
                                         const float* st, float (&z)[4][4]) {
  const int t = lane & 3;
  float y[1][4][4];
  wide::mid<1>(w2, b2, 8 * kk0, lane,
               [&](int ks, float (&a)[1][4]) {
                 const int f = 8 * ks + 2 * t;
                 const float s0 = wide::at(st, f, kH, true);
                 const float s1 = wide::at(st, f + 1, kH, true);
                 a[0][0] = epnn::relu(wide::at(oa, f, kH, va) + s0);
                 a[0][1] = epnn::relu(wide::at(ob, f, kH, vb) + s0);
                 a[0][2] = epnn::relu(wide::at(oa, f + 1, kH, va) + s1);
                 a[0][3] = epnn::relu(wide::at(ob, f + 1, kH, vb) + s1);
               },
               y);
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int r = 0; r < 4; ++r) z[q][r] = y[0][q][r];
}

// kRows: pass R (owns rows, streams columns: dpi), else pass C (dpj).
template <bool kRows>
__global__ void __launch_bounds__(kThreads)
dmr_bwd_d(const float* __restrict__ pi, const float* __restrict__ pj,
          const float* __restrict__ cv, const float* __restrict__ w2,
          const float* __restrict__ b2, const float* __restrict__ g,
          float* __restrict__ part_d, int R, int N, int per_split) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int n_own = kRows ? R : N;
  const int n_str = kRows ? N : R;
  const float* own_src = kRows ? pi : pj;
  const float* str_src = kRows ? pj : pi;
  const int o0 = blockIdx.x * kOwnPerBlock + warp * 16;
  if (o0 >= n_own) return;  // no block-wide barrier follows
  const int s0 = blockIdx.y * per_split;
  const int s1 = min(n_str, s0 + per_split);
  const int n0 = wide::kNC * blockIdx.z;
  const bool va = o0 + gq < n_own, vb = o0 + gq + 8 < n_own;
  const float* oa = own_src + (size_t)(va ? o0 + gq : 0) * kH;
  const float* ob = own_src + (size_t)(vb ? o0 + gq + 8 : 0) * kH;
  // pass R: g of the own rows; pass C: cv of the own columns
  const float* ga = g + (size_t)(va ? o0 + gq : 0) * kH;
  const float* gb = g + (size_t)(vb ? o0 + gq + 8 : 0) * kH;
  const float cvown[2] = {!kRows && va ? cv[o0 + gq] : 0.0f,
                          !kRows && vb ? cv[o0 + gq + 8] : 0.0f};
  float acc[4][4];
#pragma unroll
  for (int nf = 0; nf < 4; ++nf)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nf][r] = 0.0f;

  for (int s = s0; s < s1; ++s) {
    const float* st = str_src + (size_t)s * kH;
    const float* gs = g + (size_t)s * kH;  // pass C: g of the streamed row
    const float cj = kRows ? cv[s] : 0.0f;
    // z1bar's chunk = e2 @ W2^T: k-steps kk over the outputs o
    float zb[4][4], c[4][4];
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int r = 0; r < 4; ++r) c[nf][r] = 0.0f;
#pragma unroll 1
    for (int k0 = 0; k0 < kNT; k0 += 4) {
      float z4[4][4];
      z2_tiles(w2, b2, k0, lane, oa, va, ob, vb, st, z4);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int kk = k0 + q;
        if (kNT % 4 != 0 && kk >= kNT) break;
        const float(&z)[4] = z4[q];
        const int o = 8 * kk + 2 * t;
        float e[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int col = o + (r & 1);
          float gv;
          if (kRows)
            gv = wide::at(r < 2 ? ga : gb, col, kH, r < 2 ? va : vb);
          else
            gv = wide::at(gs, col, kH, true);
          e[r] = z[r] > 0.0f ? gv * (kRows ? cj : cvown[r >> 1]) : 0.0f;
        }
        const float a[4] = {e[0], e[2], e[1], e[3]};
        uint32_t ah[4], al[4];
        wide::split_a(a, ah, al);
#pragma unroll
        for (int nf = 0; nf < 4; ++nf) {
          const int f = n0 + 8 * nf + gq;
          const uint4 b =
              f < kHp ? epnn::split_b(w2[(size_t)f * kHp + o],
                                      w2[(size_t)f * kHp + o + 1])
                      : make_uint4(0u, 0u, 0u, 0u);
          epnn::mma_tier(c[nf], ah, al, b);
        }
      }
#pragma unroll
      for (int nf = 0; nf < 4; ++nf) wide::fold(zb[nf], c[nf], k0 == 0);
    }
    // mask 1[z1 > 0] at features n0 + 8nf + 2t + h, sum over the streamed
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int f = n0 + 8 * nf + 2 * t + h;
        const float sf = wide::at(st, f, kH, true);
        acc[nf][h] += wide::at(oa, f, kH, va) + sf > 0.0f ? zb[nf][h] : 0.0f;
        acc[nf][2 + h] +=
            wide::at(ob, f, kH, vb) + sf > 0.0f ? zb[nf][2 + h] : 0.0f;
      }
  }

  float* dst = part_d + (size_t)blockIdx.y * n_own * kH;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (!(half ? vb : va)) continue;
    float* drow = dst + (size_t)(o0 + gq + 8 * half) * kH;
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int f = n0 + 8 * nf + 2 * t + h;
        if (f < kH) drow[f] = acc[nf][2 * half + h];
      }
  }
}

// Pass W: block (tile, row block); tile = fc * kChunks + oc, dW2 rows f0 =
// 32fc .., columns o0 = 32oc ..; db2 entries o0 .. where fc == 0.
__global__ void __launch_bounds__(kThreads)
dmr_bwd_w(const float* __restrict__ pi, const float* __restrict__ pj,
          const float* __restrict__ cv, const float* __restrict__ w2,
          const float* __restrict__ b2, const float* __restrict__ g,
          float* __restrict__ part_w, float* __restrict__ part_b, int R,
          int N) {
  __shared__ float se[kWarps][2][16][kES];      // e2 hi, lo [pair][o]
  __shared__ float red_w[kWarps][32][32];       // [entry][lane]
  __shared__ float red_b[kWarps][8][32];        // [2no + u][lane]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int fc = blockIdx.x / kChunks, oc = blockIdx.x % kChunks;
  const int f0 = wide::kNC * fc, o0 = wide::kNC * oc;
  const int i0 = blockIdx.y * kOwnPerBlock + warp * 16;
  const bool va = i0 + gq < R, vb = i0 + gq + 8 < R;
  const float* pa = pi + (size_t)(va ? i0 + gq : 0) * kH;
  const float* pb = pi + (size_t)(vb ? i0 + gq + 8 : 0) * kH;
  const float* ga = g + (size_t)(va ? i0 + gq : 0) * kH;
  const float* gb = g + (size_t)(vb ? i0 + gq + 8 : 0) * kH;
  // relu(z1)^T's pairs 8kp + t (pp = 2kp) and 8kp + t + 4 (pp = 2kp + 1)
  const float* pt[4];
  bool vt[4];
#pragma unroll
  for (int pp = 0; pp < 4; ++pp) {
    const int row = i0 + 8 * (pp >> 1) + t + 4 * (pp & 1);
    vt[pp] = row < R;
    pt[pp] = pi + (size_t)(vt[pp] ? row : 0) * kH;
  }
  float (*const eh)[kES] = se[warp][0];
  float (*const el)[kES] = se[warp][1];
  float sw[2][4][4], sb[4][2];
#pragma unroll
  for (int no = 0; no < 4; ++no) {
    sb[no][0] = sb[no][1] = 0.0f;
#pragma unroll
    for (int r = 0; r < 4; ++r) sw[0][no][r] = sw[1][no][r] = 0.0f;
  }

  if (i0 < R) {
    for (int j = 0; j < N; ++j) {
      const float* st = pj + (size_t)j * kH;
      const float cj = cv[j];
      float e2[4][4];
      z2_tiles(w2, b2, 4 * oc, lane, pa, va, pb, vb, st, e2);
#pragma unroll
      for (int no = 0; no < 4; ++no) {
        const int o = 8 * (4 * oc + no) + 2 * t;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float gv =
              wide::at(r < 2 ? ga : gb, o + (r & 1), kH, r < 2 ? va : vb);
          e2[no][r] = e2[no][r] > 0.0f ? gv * cj : 0.0f;
        }
      }
      if (fc == 0)
#pragma unroll
        for (int no = 0; no < 4; ++no) {
          sb[no][0] += e2[no][0];
          sb[no][1] += e2[no][1];
          sb[no][0] += e2[no][2];
          sb[no][1] += e2[no][3];
        }
      __syncwarp();  // the previous column's e2 tile is consumed
#pragma unroll
      for (int no = 0; no < 4; ++no)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          uint32_t hi, lo;
          epnn::tf32_split(e2[no][r], hi, lo);
          const int p = gq + 8 * (r >> 1), o = 8 * no + 2 * t + (r & 1);
          eh[p][o] = __uint_as_float(hi);
          el[p][o] = __uint_as_float(lo);
        }
      __syncwarp();
      float cw[2][4][4];
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
#pragma unroll
        for (int no = 0; no < 4; ++no)
#pragma unroll
          for (int r = 0; r < 4; ++r) cw[mf][no][r] = 0.0f;
#pragma unroll
      for (int kp = 0; kp < 2; ++kp) {
        uint4 bfr[4];
#pragma unroll
        for (int no = 0; no < 4; ++no) {
          const int p = 8 * kp + t, o = 8 * no + gq;
          bfr[no] = make_uint4(__float_as_uint(eh[p][o]),
                               __float_as_uint(eh[p + 4][o]),
                               __float_as_uint(el[p][o]),
                               __float_as_uint(el[p + 4][o]));
        }
#pragma unroll
        for (int mf = 0; mf < 2; ++mf) {
          const int f = f0 + 16 * mf + gq;
          const float s0 = wide::at(st, f, kH, true);
          const float s8 = wide::at(st, f + 8, kH, true);
          const float a[4] = {
              epnn::relu(wide::at(pt[2 * kp], f, kH, vt[2 * kp]) + s0),
              epnn::relu(wide::at(pt[2 * kp], f + 8, kH, vt[2 * kp]) + s8),
              epnn::relu(wide::at(pt[2 * kp + 1], f, kH, vt[2 * kp + 1]) + s0),
              epnn::relu(wide::at(pt[2 * kp + 1], f + 8, kH, vt[2 * kp + 1]) +
                         s8)};
          uint32_t ah[4], al[4];
          wide::split_a(a, ah, al);
#pragma unroll
          for (int no = 0; no < 4; ++no)
            epnn::mma_tier(cw[mf][no], ah, al, bfr[no]);
        }
      }
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
#pragma unroll
        for (int no = 0; no < 4; ++no)
#pragma unroll
          for (int r = 0; r < 4; ++r) sw[mf][no][r] += cw[mf][no][r];
    }
  }

  // the block's four warps in order; db2 then over the eight row groups
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int no = 0; no < 4; ++no)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        red_w[warp][(mf * 4 + no) * 4 + r][lane] = sw[mf][no][r];
#pragma unroll
  for (int no = 0; no < 4; ++no)
#pragma unroll
    for (int u = 0; u < 2; ++u) red_b[warp][2 * no + u][lane] = sb[no][u];
  __syncthreads();
  for (int e = threadIdx.x; e < wide::kNC * wide::kNC; e += kThreads) {
    const int fl = e / wide::kNC, ol = e % wide::kNC;
    const int f = f0 + fl, o = o0 + ol;
    if (f >= kH || o >= kH) continue;
    const int mf = fl >> 4, rr = fl & 15, no = ol >> 3, q = ol & 7;
    const int entry = (mf * 4 + no) * 4 + 2 * (rr >> 3) + (q & 1);
    const int ln = 4 * (rr & 7) + (q >> 1);
    float w = red_w[0][entry][ln];
    for (int q2 = 1; q2 < kWarps; ++q2) w += red_w[q2][entry][ln];
    part_w[(size_t)blockIdx.y * kH * kH + (size_t)f * kH + o] = w;
  }
  if (fc == 0 && threadIdx.x < wide::kNC) {
    const int ol = threadIdx.x, o = o0 + ol;
    if (o < kH) {
      const int ent = 2 * (ol >> 3) + (ol & 1), tt = (ol & 7) >> 1;
      float b = 0.0f;
      for (int q2 = 0; q2 < kWarps; ++q2)
        for (int gg = 0; gg < 8; ++gg) b += red_b[q2][ent][4 * gg + tt];
      part_b[(size_t)blockIdx.y * kH + o] = b;
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

// as the narrow entry below: the same arguments and scratch (pass W uses
// ceil(R / 64) of the blocks_r dW2 and db2 parts)
extern "C" int epnn_dense_message_rowsum_bwd(
    const float* pi, const float* pj, const float* cv, const float* w2,
    const float* b2, const float* g, float* work, float* dpi, float* dpj,
    float* dw2, float* db2, int R, int N, int H, int splits_r,
    int cols_per_split, int splits_c, int rows_per_split,
    cudaStream_t stream) {
  if (H != kH || R <= 0 || N <= 0 || splits_r <= 0 || splits_c <= 0 ||
      cols_per_split <= 0 || rows_per_split <= 0 ||
      (long long)(splits_r - 1) * cols_per_split >= N ||
      (long long)(splits_c - 1) * rows_per_split >= R)
    return cudaErrorInvalidValue;
  const int row_blocks = (R + kOwnPerBlock - 1) / kOwnPerBlock;
  const int col_blocks = (N + kOwnPerBlock - 1) / kOwnPerBlock;
  const int blocks_r = row_blocks * splits_r;
  float* part_dpi = work;
  float* part_dpj = part_dpi + (size_t)splits_r * R * H;
  float* part_w = part_dpj + (size_t)splits_c * N * H;
  float* part_b = part_w + (size_t)blocks_r * H * H;
  cudaError_t err;
  dmr_bwd_d<true><<<dim3(row_blocks, splits_r, kChunks), kThreads, 0,
                    stream>>>(pi, pj, cv, w2, b2, g, part_dpi, R, N,
                              cols_per_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dmr_bwd_d<false><<<dim3(col_blocks, splits_c, kChunks), kThreads, 0,
                     stream>>>(pi, pj, cv, w2, b2, g, part_dpj, R, N,
                               rows_per_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dmr_bwd_w<<<dim3(kChunks * kChunks, row_blocks), kThreads, 0, stream>>>(
      pi, pj, cv, w2, b2, g, part_w, part_b, R, N);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = launch_sum(part_dpi, dpi, R * H, splits_r, stream))) return err;
  if ((err = launch_sum(part_dpj, dpj, N * H, splits_c, stream))) return err;
  if ((err = launch_sum(part_w, dw2, H * H, row_blocks, stream))) return err;
  return launch_sum(part_b, db2, H, row_blocks, stream);
}

#else

namespace {

using epnn::kFH;
using epnn::kH;
using epnn::kHp;
using epnn::kNT;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kOwnPerBlock = 16 * kWarps;  // a warp owns 16 rows / columns
constexpr int kChunk = 32;                 // streamed entries per chunk
constexpr int kEStride = kHp + 8;  // e2 tile row stride: conflict-free reads
// dW2's A = relu(z1)^T has rows f in kMF m-tiles of 16; row group gq holds
// features kFW gq .. kFW gq + kFW - 1 (f = kFW gq + 2mf + {0, 1})
constexpr int kMF = (kHp + 15) / 16;
constexpr int kFW = 2 * kMF;
// dW2's sums in registers over two columns where its tiles are few
constexpr bool kWInRegs = kMF * kNT <= 8;
constexpr int kWEntries = kMF * kNT * 4;   // dW2 sums a lane

// shared-memory layout, dynamic: above the 48 KB static limit
struct Smem {
  uint4 bw[kNT * kNT][32];  // far_z2's W2 fragments (ks * kNT + nt, lane)
  uint4 bt[kNT * kNT][32];  // z1bar's W2^T fragments (kk * kNT + nf, lane)
  float str[2][kChunk][kHp];  // streamed pj (pass R) or pi (pass C)
  float gs[2][kChunk][kHp];   // pass C: g of the streamed rows
  float cv[2][kChunk];        // pass R: cv of the streamed columns
  // pass R: each warp's e2 tile, hi and lo [pair][o]
  float e[kWarps][2][16][kEStride];
  // pass R: each warp's dW2 and db2 sums in fp32 [entry][lane]
  float accw[kWarps][kWEntries][32];
  float accb[kWarps][2 * kNT][32];
};
static_assert(kChunk % 2 == 0, "dW2 chains close on every second column");

// z1bar's B = W2^T (k = o, n = f), split, in the relabelled order: k-step
// kk, B row t <-> o = 8kk + 2t, row t + 4 <-> o = 8kk + 2t + 1; n-tile nf,
// column n <-> f = kFH (n / 2) + 2nf + n % 2, so that the output's C column
// 2t + h is feature kFH t + 2nf + h.
__device__ __forceinline__ uint4 w2t_frag(const float* __restrict__ w2,
                                          int kk, int nf, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int f = kFH * (g >> 1) + 2 * nf + (g & 1);
  return epnn::split_b(w2[f * kHp + 8 * kk + 2 * t],
                       w2[f * kHp + 8 * kk + 2 * t + 1]);
}

// kFH features kFH t .. of a staged row (stride kHp)
__device__ __forceinline__ void smem_row(const float* row, int t,
                                         float (&x)[kFH]) {
  if constexpr (kFH % 4 == 0) {
#pragma unroll
    for (int q = 0; q < kFH / 4; ++q) {
      const float4 p = *reinterpret_cast<const float4*>(row + kFH * t + 4 * q);
      x[4 * q] = p.x;
      x[4 * q + 1] = p.y;
      x[4 * q + 2] = p.z;
      x[4 * q + 3] = p.w;
    }
  } else {
#pragma unroll
    for (int m = 0; m < kFH; ++m) x[m] = row[kFH * t + m];
  }
}

// kRows: pass R (owns rows; dpi, dW2, db2), else pass C (owns cols; dpj).
template <bool kRows>
__global__ void __launch_bounds__(kThreads, 2)
dmr_bwd_partial(const float* __restrict__ pi, const float* __restrict__ pj,
                const float* __restrict__ cv, const float* __restrict__ w2,
                const float* __restrict__ b2, const float* __restrict__ g,
                float* __restrict__ part_d, float* __restrict__ part_w,
                float* __restrict__ part_b, int R, int N, int per_split) {
  extern __shared__ uint4 smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);

  const int n_own = kRows ? R : N;
  const int n_str = kRows ? N : R;
  const float* own_src = kRows ? pi : pj;
  const float* str_src = kRows ? pj : pi;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int o0 = blockIdx.x * kOwnPerBlock + warp * 16;  // the warp's own
  const int s0 = blockIdx.y * per_split;
  const int s1 = min(n_str, s0 + per_split);
  const int chunks = (s1 - s0 + kChunk - 1) / kChunk;

  // chunk c's streamed entries into ring slot c % 2; past s1 and past H:
  // zeros
  auto stage = [&](int c) {
    const int st = s0 + c * kChunk;
    for (int e = threadIdx.x; e < kChunk * kHp; e += kThreads) {
      const int r = e / kHp, col = e % kHp;
      const bool in = st + r < s1 && (kH == kHp || col < kH);
      const size_t at = in ? (size_t)(st + r) * kH + col : 0;
      epnn::cp_async4(&s.str[c & 1][0][0] + e, str_src + at, in);
      if (!kRows) epnn::cp_async4(&s.gs[c & 1][0][0] + e, g + at, in);
    }
    if (kRows)
      for (int e = threadIdx.x; e < kChunk; e += kThreads) {
        const bool in = st + e < s1;
        epnn::cp_async4(&s.cv[c & 1][e], cv + (in ? st + e : 0), in);
      }
    epnn::cp_async_commit();
  };
  stage(0);

  for (int e = threadIdx.x; e < kNT * kNT * 32; e += kThreads) {
    s.bw[e >> 5][e & 31] =
        epnn::w2_frag(w2, (e >> 5) / kNT, (e >> 5) % kNT, e & 31);
    s.bt[e >> 5][e & 31] = w2t_frag(w2, (e >> 5) / kNT, (e >> 5) % kNT,
                                    e & 31);
  }
  float bias[kNT][2];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    bias[nt][0] = b2[8 * nt + 2 * t];
    bias[nt][1] = b2[8 * nt + 2 * t + 1];
  }
  const bool in_a = o0 + gq < n_own, in_b = o0 + gq + 8 < n_own;
  float xa[kFH], xb[kFH];  // own rows gq, gq + 8: features kFH t ..
  epnn::load_row<kFH, kH>(own_src + (size_t)(o0 + gq) * kH, t, in_a, xa);
  epnn::load_row<kFH, kH>(own_src + (size_t)(o0 + gq + 8) * kH, t, in_b,
                          xb);
  // pass R: g of the own rows in the C layout; relu(z1)^T's pi: own rows
  // t + 4pp, features kFW gq .. kFW gq + kFW - 1.  Pass C: cv of the own
  // columns.
  float gown[kNT][4], piT[4][kFW], cvown[2];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = o0 + gq + 8 * (r >> 1);
      const int col = 8 * nt + 2 * t + (r & 1);
      gown[nt][r] = kRows && row < R && (kH == kHp || col < kH)
                        ? g[(size_t)row * kH + col]
                        : 0.0f;
    }
#pragma unroll
  for (int pp = 0; pp < 4; ++pp)
#pragma unroll
    for (int r = 0; r < kFW; ++r) {
      const int prow = o0 + t + 4 * pp;
      const int f = kFW * gq + r;
      piT[pp][r] = kRows && prow < R && (16 * kMF == kH || f < kH)
                       ? pi[(size_t)prow * kH + f]
                       : 0.0f;
    }
  cvown[0] = !kRows && in_a ? cv[o0 + gq] : 0.0f;
  cvown[1] = !kRows && in_b ? cv[o0 + gq + 8] : 0.0f;

  // acc_w: dW2 of the last two columns, a tensor-core chain of 12
  // products; it is added into the warp's fp32 sums (s.accw) and cleared
  // every second column, because the tensor cores' fp32 accumulation
  // truncates, and over a whole column range its error would grow with
  // the range (at 17,760 atoms, past the float64 bar of chip_smoke.py)
  float acc_d[kNT][4], acc_b[kNT][2];
  float acc_w[kWInRegs ? kMF : 1][kNT][4];
#pragma unroll
  for (int a = 0; a < kNT; ++a) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      acc_d[a][r] = 0.0f;
#pragma unroll
      for (int mf = 0; mf < (kWInRegs ? kMF : 1); ++mf) acc_w[mf][a][r] = 0.0f;
    }
    acc_b[a][0] = acc_b[a][1] = 0.0f;
  }
  float(*const ehl)[16][kEStride] = s.e[warp];
  // acc_b: db2 of the current chunk, added into s.accb at its end
  float* const accw = &s.accw[warp][0][lane];
  float* const accb = &s.accb[warp][0][lane];
  if (kRows) {
#pragma unroll
    for (int q = 0; q < kWEntries; ++q) accw[32 * q] = 0.0f;
#pragma unroll
    for (int q = 0; q < 2 * kNT; ++q) accb[32 * q] = 0.0f;
  }

  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      stage(c + 1);
      epnn::cp_async_wait<1>();
    } else {
      epnn::cp_async_wait<0>();
    }
    __syncthreads();  // chunk c (and the B fragments) landed
    if (o0 < n_own) {
      const float* sp = &s.str[c & 1][0][0];
      for (int j = 0; j < kChunk; ++j) {
        const float* row = sp + j * kHp;
        float xs[kFH];
        smem_row(row, t, xs);

        // z2 (the forward's products), then e2 = cv_j * g_i * 1[z2 > 0]
        float e2[kNT][4];
        epnn::far_z2(xa, xb, xs, bias,
                     [&](int ks, int nt) {
                       return s.bw[ks * kNT + nt][lane];
                     },
                     e2);
        if (kRows) {
          const float cj = s.cv[c & 1][j];
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
            for (int r = 0; r < 4; ++r)
              e2[nt][r] = e2[nt][r] > 0.0f ? gown[nt][r] * cj : 0.0f;
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            acc_b[nt][0] += e2[nt][0];
            acc_b[nt][1] += e2[nt][1];
            acc_b[nt][0] += e2[nt][2];
            acc_b[nt][1] += e2[nt][3];
          }
        } else {
          const float* gi = &s.gs[c & 1][j][0];
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            const float2 gv =
                *reinterpret_cast<const float2*>(gi + 8 * nt + 2 * t);
            e2[nt][0] = e2[nt][0] > 0.0f ? gv.x * cvown[0] : 0.0f;
            e2[nt][1] = e2[nt][1] > 0.0f ? gv.y * cvown[0] : 0.0f;
            e2[nt][2] = e2[nt][2] > 0.0f ? gv.x * cvown[1] : 0.0f;
            e2[nt][3] = e2[nt][3] > 0.0f ? gv.y * cvown[1] : 0.0f;
          }
        }

        // z1bar = e2 @ W2^T: the C fragment relabelled as A
        uint32_t eh[kNT][4], el[kNT][4];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            epnn::tf32_split(e2[nt][r], eh[nt][r], el[nt][r]);
        constexpr int kC = epnn::chains(kNT);
        float zc[kC][kNT][4];
#pragma unroll
        for (int h = 0; h < kC; ++h)
#pragma unroll
          for (int nf = 0; nf < kNT; ++nf)
#pragma unroll
            for (int r = 0; r < 4; ++r) zc[h][nf][r] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < kNT; ++kk) {
          const uint32_t ah[4] = {eh[kk][0], eh[kk][2], eh[kk][1], eh[kk][3]};
          const uint32_t al[4] = {el[kk][0], el[kk][2], el[kk][1], el[kk][3]};
#pragma unroll
          for (int nf = 0; nf < kNT; ++nf)
            epnn::mma_tier(zc[epnn::chain_of(kk, kNT)][nf], ah, al,
                           s.bt[kk * kNT + nf][lane]);
        }
        // mask 1[z1 > 0] at features kFH t + 2nf + h, sum over the streamed
#pragma unroll
        for (int nf = 0; nf < kNT; ++nf)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = 2 * nf + h;
            float za = zc[0][nf][h], zb = zc[0][nf][2 + h];
#pragma unroll
            for (int q = 1; q < kC; ++q) {
              za += zc[q][nf][h];
              zb += zc[q][nf][2 + h];
            }
            acc_d[nf][h] += xa[m] + xs[m] > 0.0f ? za : 0.0f;
            acc_d[nf][2 + h] += xb[m] + xs[m] > 0.0f ? zb : 0.0f;
          }

        if (kRows) {
          // dW2 += relu(z1)^T e2 over the warp's 16 pairs: e2 (hi, lo)
          // through shared memory as B [pair][o], relu(z1)^T built as A
          // [f][pair] with f = kFW gq + 2mf (+1 for A rows gq + 8)
          __syncwarp();  // the previous column's e2 tile is consumed
          auto put = [&](int hl, int r, uint32_t v0, uint32_t v1, int nt) {
            *reinterpret_cast<float2*>(&ehl[hl][gq + 8 * r][8 * nt + 2 * t]) =
                make_float2(__uint_as_float(v0), __uint_as_float(v1));
          };
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            put(0, 0, eh[nt][0], eh[nt][1], nt);
            put(0, 1, eh[nt][2], eh[nt][3], nt);
            put(1, 0, el[nt][0], el[nt][1], nt);
            put(1, 1, el[nt][2], el[nt][3], nt);
          }
          __syncwarp();
          float pjq[kFW];
          if constexpr (16 * kMF == kHp && kFW % 4 == 0) {
#pragma unroll
            for (int q = 0; q < kFW / 4; ++q) {
              const float4 p =
                  *reinterpret_cast<const float4*>(row + kFW * gq + 4 * q);
              pjq[4 * q] = p.x;
              pjq[4 * q + 1] = p.y;
              pjq[4 * q + 2] = p.z;
              pjq[4 * q + 3] = p.w;
            }
          } else {
#pragma unroll
            for (int r = 0; r < kFW; ++r)
              pjq[r] = kFW * gq + r < kHp ? row[kFW * gq + r] : 0.0f;
          }
          // the A fragment of m-tile mf, k-step kp (pairs 8kp .. 8kp + 7)
          auto a_frag = [&](int kp, int mf, uint32_t (&ah)[4],
                            uint32_t (&al)[4]) {
            epnn::tf32_split(epnn::relu(piT[2 * kp][2 * mf] + pjq[2 * mf]),
                             ah[0], al[0]);
            epnn::tf32_split(
                epnn::relu(piT[2 * kp][2 * mf + 1] + pjq[2 * mf + 1]), ah[1],
                al[1]);
            epnn::tf32_split(
                epnn::relu(piT[2 * kp + 1][2 * mf] + pjq[2 * mf]), ah[2],
                al[2]);
            epnn::tf32_split(
                epnn::relu(piT[2 * kp + 1][2 * mf + 1] + pjq[2 * mf + 1]),
                ah[3], al[3]);
          };
          // e2's B fragment of k-step kp, n-tile no
          auto b_frag = [&](int kp, int no) {
            const int p = 8 * kp + t, o = 8 * no + gq;
            return make_uint4(__float_as_uint(ehl[0][p][o]),
                              __float_as_uint(ehl[0][p + 4][o]),
                              __float_as_uint(ehl[1][p][o]),
                              __float_as_uint(ehl[1][p + 4][o]));
          };
          if constexpr (kWInRegs) {
#pragma unroll
            for (int kp = 0; kp < 2; ++kp) {
              uint4 bfr[kNT];
#pragma unroll
              for (int no = 0; no < kNT; ++no) bfr[no] = b_frag(kp, no);
#pragma unroll
              for (int mf = 0; mf < kMF; ++mf) {
                uint32_t ah[4], al[4];
                a_frag(kp, mf, ah, al);
#pragma unroll
                for (int no = 0; no < kNT; ++no)
                  epnn::mma_tier(acc_w[mf][no], ah, al, bfr[no]);
              }
            }
            if (j & 1) {
#pragma unroll
              for (int mf = 0; mf < kMF; ++mf)
#pragma unroll
                for (int no = 0; no < kNT; ++no)
#pragma unroll
                  for (int r = 0; r < 4; ++r) {
                    accw[32 * ((mf * kNT + no) * 4 + r)] += acc_w[mf][no][r];
                    acc_w[mf][no][r] = 0.0f;
                  }
            }
          } else {
            for (int mf = 0; mf < kMF; ++mf) {
              float cw[kNT][4];
#pragma unroll
              for (int no = 0; no < kNT; ++no)
#pragma unroll
                for (int r = 0; r < 4; ++r) cw[no][r] = 0.0f;
#pragma unroll
              for (int kp = 0; kp < 2; ++kp) {
                uint32_t ah[4], al[4];
                a_frag(kp, mf, ah, al);
#pragma unroll
                for (int no = 0; no < kNT; ++no)
                  epnn::mma_tier(cw[no], ah, al, b_frag(kp, no));
              }
#pragma unroll
              for (int no = 0; no < kNT; ++no)
#pragma unroll
                for (int r = 0; r < 4; ++r)
                  accw[32 * ((mf * kNT + no) * 4 + r)] += cw[no][r];
            }
          }
        }
      }
      if (kRows)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            accb[32 * (2 * nt + h)] += acc_b[nt][h];
            acc_b[nt][h] = 0.0f;
          }
    }
    __syncthreads();  // slot c % 2 is free for chunk c + 2
  }

  // dpi / dpj: the thread's features kFH t + 2nf + h of rows gq, gq + 8
  float* dst = part_d + (size_t)blockIdx.y * n_own * kH;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (!(half ? in_b : in_a)) continue;
    float* drow = dst + (size_t)(o0 + gq + 8 * half) * kH + kFH * t;
    if constexpr (kH == kHp && kFH % 4 == 0) {
#pragma unroll
      for (int q = 0; q < kFH / 4; ++q)
        reinterpret_cast<float4*>(drow)[q] = make_float4(
            acc_d[2 * q][2 * half], acc_d[2 * q][2 * half + 1],
            acc_d[2 * q + 1][2 * half], acc_d[2 * q + 1][2 * half + 1]);
    } else {
#pragma unroll
      for (int m = 0; m < kFH; ++m)
        if (kFH * t + m < kH) drow[m] = acc_d[m >> 1][2 * half + (m & 1)];
    }
  }
  if (kRows) {
    // the block's four warps, then (db2) the eight row groups, in order,
    // from each warp's sums: dW2 entry (f, o) sits at row group gq = f /
    // kFW, m-tile mf = (f % kFW) / 2, n-tile o / 8, thread (o % 8) / 2
    __syncthreads();  // every warp's sums are complete
    const size_t blk = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    for (int e = threadIdx.x; e < kH * kH; e += kThreads) {
      const int f = e / kH, o = e % kH;
      const int fg = f / kFW, fr = f % kFW;
      const int r = 2 * (fr & 1) + (o & 1);
      const int entry = (((fr >> 1) * kNT + (o >> 3)) * 4 + r);
      const int ln = 4 * fg + ((o & 7) >> 1);
      float w = s.accw[0][entry][ln];
      for (int q = 1; q < kWarps; ++q) w += s.accw[q][entry][ln];
      part_w[blk * kH * kH + e] = w;
    }
    if (threadIdx.x < kH) {
      const int o = threadIdx.x;
      const int ent = 2 * (o >> 3) + (o & 1), tt = (o & 7) >> 1;
      float b = 0.0f;
      for (int q = 0; q < kWarps; ++q)
        for (int gg = 0; gg < 8; ++gg) b += s.accb[q][ent][4 * gg + tt];
      part_b[blk * kH + o] = b;
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

// w2 (Hp, Hp), b2 (Hp,) zero-padded; work: scratch of splits_r*R*H +
// splits_c*N*H + blocks_r*(H*H + H) floats, blocks_r = ceil(R/64) *
// splits_r; the streamed ranges split into parts of cols_per_split (pass R)
// and rows_per_split (pass C).  Writes dpi (R, H), dpj (N, H), dw2 (H, H),
// db2 (H,).  Returns the first CUDA error (0 on success).
extern "C" int epnn_dense_message_rowsum_bwd(
    const float* pi, const float* pj, const float* cv, const float* w2,
    const float* b2, const float* g, float* work, float* dpi, float* dpj,
    float* dw2, float* db2, int R, int N, int H, int splits_r,
    int cols_per_split, int splits_c, int rows_per_split,
    cudaStream_t stream) {
  if (H != kH || R <= 0 || N <= 0 || splits_r <= 0 || splits_c <= 0 ||
      cols_per_split <= 0 || rows_per_split <= 0 ||
      (long long)(splits_r - 1) * cols_per_split >= N ||
      (long long)(splits_c - 1) * rows_per_split >= R)
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

  const int row_blocks = (R + kOwnPerBlock - 1) / kOwnPerBlock;
  const int col_blocks = (N + kOwnPerBlock - 1) / kOwnPerBlock;
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

#endif  // EPNN_WIDE
