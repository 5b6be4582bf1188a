// The far field's block body on wgmma at the library's TF32 tier
// (common.cuh: 3xTF32, or one TF32 product a k-step): a block of one
// warpgroup (64 rows i, 16 a warp) against one column range of the pair
// grid,
//
//   part_i = rw_i * sum_j cv_j * relu(relu(pi_i + pj_j) @ W2 + b2)
//
// shared by dense_message_rowsum.cu (rw = 1) and fused_message_rowsum.cu
// (its all-pairs term; rw = the row mask in masked mode).  See
// dense_message_rowsum.cu for the design.
#pragma once

#include "common.cuh"

#if EPNN_WIDE
#include "wide.cuh"
#endif

namespace epnn {
namespace far {

#if !EPNN_WIDE

constexpr int kThreads = 128;               // one warpgroup
constexpr int kRowsPerBlock = 64;           // 16 a warp
constexpr int kChunk = kHp <= 32 ? 32 : 16;  // columns per staged chunk
constexpr int kTile = 8 * kHp;              // floats of a k-step's B tile
// B tile of a k-step: element (n, k) at (n / 8) * 64 + (k / 4) * 32 +
// (n % 8) * 4 + k % 4 — core matrices of 8 n x 4 k, the k halves 128 bytes
// apart, the 8-row groups 256 bytes apart
constexpr int kLbo = 128, kSbo = 256;
constexpr int kD = kHp / 2;                 // accumulators a thread, a chain
constexpr int kC = chains(kNT);             // chains of a column's product
// columns in flight: two up to H = 32 (one's A is built while the other's
// products run); one above, where two would not fit in the registers
constexpr int kInFlight = kHp <= 32 ? 2 : 1;
static_assert(kChunk % 2 == 0, "columns go two at a time");

struct Smem {
  // W2 hi (and lo in 3xTF32), k-step by k-step: one pass stages no lo tiles
  __align__(128) float b[kSplit ? 2 : 1][kNT][kTile];
  __align__(16) float pj[2][kChunk][kHp];
  float cv[2][kChunk];
};

// The block (bx, by): rows bx * 64 .., columns [by * cols_per_split, ..).
// W2 (kHp, kHp) and b2 (kHp) padded; pi (R, kH), pj (N, kH) at their real
// width.  part: (splits, R, kH).
template <bool kRowWeight>
__device__ __forceinline__ void rows(Smem& s, const float* __restrict__ pi,
                                     const float* __restrict__ pj,
                                     const float* __restrict__ cv,
                                     const float* __restrict__ w2,
                                     const float* __restrict__ b2,
                                     const float* __restrict__ rw,
                                     float* __restrict__ part, int R, int N,
                                     int cols_per_split, int bx, int by) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = bx * kRowsPerBlock + (threadIdx.x >> 5) * 16;
  const int j0 = by * cols_per_split;
  const int j1 = min(N, j0 + cols_per_split);
  const int chunks = (j1 - j0 + kChunk - 1) / kChunk;

  // chunk c's columns into ring slot c % 2; past j1: zeros
  auto stage = [&](int c) {
    const int jt = j0 + c * kChunk;
    float* dst = &s.pj[c & 1][0][0];
    for (int e = threadIdx.x; e < kChunk * kHp; e += kThreads) {
      const int r = e / kHp, col = e % kHp;
      const bool in = jt + r < j1 && (kH == kHp || col < kH);
      cp_async4(dst + e, pj + (in ? (size_t)(jt + r) * kH + col : 0), in);
    }
    for (int e = threadIdx.x; e < kChunk; e += kThreads) {
      const bool in = jt + e < j1;
      cp_async4(&s.cv[c & 1][e], cv + (in ? jt + e : 0), in);
    }
    cp_async_commit();
  };
  stage(0);

  // W2's B tiles, split (hi only at one pass); column k of k-step ks is
  // feature kFH (k % 4) + 2ks + k / 4, far_a's order
  for (int e = threadIdx.x; e < kNT * kTile; e += kThreads) {
    const int ks = e / kTile, o = e % kTile;
    const int n = (o / 64) * 8 + (o / 4) % 8;
    const int f = kFH * (o % 4) + 2 * ks + (o / 32) % 2;
    uint32_t hi, lo;
    tf32_split(w2[f * kHp + n], hi, lo);
    s.b[0][ks][o] = __uint_as_float(hi);
    if constexpr (kSplit) s.b[kSplit ? 1 : 0][ks][o] = __uint_as_float(lo);
  }
  wg::fence_proxy_async();
  uint64_t b_hi[kNT], b_lo[kNT];
#pragma unroll
  for (int ks = 0; ks < kNT; ++ks) {
    b_hi[ks] = wg::desc(&s.b[0][ks][0], kLbo, kSbo);
    b_lo[ks] = kSplit ? wg::desc(&s.b[kSplit ? 1 : 0][ks][0], kLbo, kSbo)
                      : b_hi[ks];
  }
  float bias[kNT][2];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    bias[nt][0] = b2[8 * nt + 2 * t];
    bias[nt][1] = b2[8 * nt + 2 * t + 1];
  }
  float xa[kFH], xb[kFH];
  load_row<kFH, kH>(pi + (size_t)(r0 + g) * kH, t, r0 + g < R, xa);
  load_row<kFH, kH>(pi + (size_t)(r0 + g + 8) * kH, t, r0 + g + 8 < R, xb);

  float acc[kD];
#pragma unroll
  for (int i = 0; i < kD; ++i) acc[i] = 0.0f;

  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      stage(c + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk c (and, the first time, the B tiles) landed
    const float* sp = &s.pj[c & 1][0][0];
    const float* scv = &s.cv[c & 1][0];
    // column j's A and accumulators (b2, then 0 for further chains), then
    // its kNT k-steps' products (3 each in 3xTF32, 1 at one pass) as a group
    auto issue = [&](int j, uint32_t (&ah)[kNT][4], uint32_t (&al)[kNT][4],
                     float (&d)[kC][kD]) {
      float xs[kFH];
      if constexpr (kFH % 4 == 0) {
#pragma unroll
        for (int q = 0; q < kFH / 4; ++q) {
          const float4 p =
              *reinterpret_cast<const float4*>(sp + j * kHp + kFH * t + 4 * q);
          xs[4 * q] = p.x;
          xs[4 * q + 1] = p.y;
          xs[4 * q + 2] = p.z;
          xs[4 * q + 3] = p.w;
        }
      } else {
#pragma unroll
        for (int m = 0; m < kFH; ++m) xs[m] = sp[j * kHp + kFH * t + m];
      }
#pragma unroll
      for (int ks = 0; ks < kNT; ++ks) far_a(xa, xb, xs, ks, ah[ks], al[ks]);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        d[0][4 * nt] = d[0][4 * nt + 2] = bias[nt][0];
        d[0][4 * nt + 1] = d[0][4 * nt + 3] = bias[nt][1];
      }
#pragma unroll
      for (int h = 1; h < kC; ++h)
#pragma unroll
        for (int i = 0; i < kD; ++i) d[h][i] = 0.0f;
#pragma unroll
      for (int h = 0; h < kC; ++h) wg::fence_regs(d[h]);
      wg::fence();
#pragma unroll
      for (int ks = 0; ks < kNT; ++ks)
        wg::mma_tier<kHp>(d[chain_of(ks, kNT)], ah[ks], al[ks], b_hi[ks],
                            b_lo[ks]);
      wg::commit();
    };
    auto fold = [&](int j, float (&d)[kC][kD]) {
#pragma unroll
      for (int h = 0; h < kC; ++h) wg::fence_regs(d[h]);
      const float cj = scv[j];
#pragma unroll
      for (int i = 0; i < kD; ++i) {
        float z = d[0][i];
#pragma unroll
        for (int h = 1; h < kC; ++h) z += d[h][i];
        acc[i] = fmaf(cj, relu(z), acc[i]);
      }
    };
    if constexpr (kInFlight == 2) {
      uint32_t ah0[kNT][4], al0[kNT][4], ah1[kNT][4], al1[kNT][4];
      for (int j = 0; j < kChunk; j += 2) {
        float d0[kC][kD], d1[kC][kD];
        issue(j, ah0, al0, d0);
        issue(j + 1, ah1, al1, d1);
        wg::wait<1>();
        fold(j, d0);
        wg::wait<0>();
        fold(j + 1, d1);
      }
    } else {
      uint32_t ah[kNT][4], al[kNT][4];
      for (int j = 0; j < kChunk; ++j) {
        float d[kC][kD];
        issue(j, ah, al, d);
        wg::wait<0>();
        fold(j, d);
      }
    }
    __syncthreads();  // slot c % 2 is free for chunk c + 2
  }

  float* dst = part + (size_t)by * R * kH;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + g + 8 * half;
    if (row < R) {
      const float w = kRowWeight ? rw[row] : 1.0f;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int o = 8 * nt + 2 * t;
        float v0 = acc[4 * nt + 2 * half], v1 = acc[4 * nt + 2 * half + 1];
        if (kRowWeight) {
          v0 *= w;
          v1 *= w;
        }
        if constexpr (kH % 2 == 0) {
          if (kH == kHp || o < kH)
            *reinterpret_cast<float2*>(dst + (size_t)row * kH + o) =
                make_float2(v0, v1);
        } else {
          if (o < kH) dst[(size_t)row * kH + o] = v0;
          if (o + 1 < kH) dst[(size_t)row * kH + o + 1] = v1;
        }
      }
    }
  }
}

#else  // EPNN_WIDE

// The wide path (wide.cuh): a block is 4 warps, 64 rows (16 a warp), one
// column range and one output chunk of 32 columns (blockIdx.z in
// dense_message_rowsum.cu).  For each column j a warp builds z2's chunk
// with mma.sync m16n8k8 at the library's tier, k-step by k-step from pi and pj read where
// they are needed, and folds cv_j * relu(z2) into its 16 sums in order.
constexpr int kThreads = 128;
constexpr int kRowsPerBlock = 64;

template <bool kRowWeight>
__device__ __forceinline__ void rows(const float* __restrict__ pi,
                                     const float* __restrict__ pj,
                                     const float* __restrict__ cv,
                                     const float* __restrict__ w2,
                                     const float* __restrict__ b2,
                                     const float* __restrict__ rw,
                                     float* __restrict__ part, int R, int N,
                                     int cols_per_split, int bx, int by,
                                     int oc) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = bx * kRowsPerBlock + (threadIdx.x >> 5) * 16;
  const int j0 = by * cols_per_split;
  const int j1 = min(N, j0 + cols_per_split);
  const int n0 = wide::kNC * oc;
  const bool va = r0 + g < R, vb = r0 + g + 8 < R;
  const float* pa = pi + (size_t)(va ? r0 + g : 0) * kH;
  const float* pb = pi + (size_t)(vb ? r0 + g + 8 : 0) * kH;
  float acc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nt][r] = 0.0f;
  for (int j = j0; j < j1; ++j) {
    const float* ps = pj + (size_t)j * kH;
    float y[1][4][4];
    wide::mid<1>(w2, b2, n0, lane,
                 [&](int ks, float (&z)[1][4]) {
                   const int f = 8 * ks + 2 * t;
                   const float s0 = wide::at(ps, f, kH, true);
                   const float s1 = wide::at(ps, f + 1, kH, true);
                   z[0][0] = relu(wide::at(pa, f, kH, va) + s0);
                   z[0][1] = relu(wide::at(pb, f, kH, vb) + s0);
                   z[0][2] = relu(wide::at(pa, f + 1, kH, va) + s1);
                   z[0][3] = relu(wide::at(pb, f + 1, kH, vb) + s1);
                 },
                 y);
    const float cj = cv[j];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        acc[nt][r] = fmaf(cj, relu(y[0][nt][r]), acc[nt][r]);
  }
  float* dst = part + (size_t)by * R * kH;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + g + 8 * half;
    if (row >= R) continue;
    const float w = kRowWeight ? rw[row] : 1.0f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int o = n0 + 8 * nt + 2 * t + u;
        float v = acc[nt][2 * half + u];
        if (kRowWeight) v *= w;
        if (o < kH) dst[(size_t)row * kH + o] = v;
      }
  }
}

#endif  // EPNN_WIDE

}  // namespace far
}  // namespace epnn
