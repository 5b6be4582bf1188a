// The wide path: the width-carrying kernels where a padded width passes 64
// (EPNN_WIDE, common.cuh).
//
// The narrow designs keep every feature of a row that a thread needs in
// registers (kFH = Hp / 4 a row), stage the weights' split fragments whole
// in shared memory and hold a whole output row's sums: at H = E = 256 that
// is 128 registers of operands, 512 KB of fragments.  Here nothing grows
// with the widths but loop counts:
//   * the output columns go in chunks of kNC = 32 (four n-tiles of
//     mma.sync m16n8k8), one chunk at a time or one chunk a block;
//   * each contraction is streamed k-step by k-step: its A fragment is
//     built from the activations where it is needed (read from global
//     memory, L1-resident), its B fragment read from the padded weights
//     and split on the spot;
//   * epart = rbf @ W1e, which the mid layers contract over, is built once
//     a tile, a chunk of output features at a time, into the warp's slice
//     of a global scratch (16 x Hp floats a warp, L1/L2-resident; the
//     wrapper sizes it by the grid's warps), and the mid layers read it
//     back k-step by k-step; z2, which the backward's z1bar contracts
//     over, is rebuilt four n-tiles at a time as the k-steps that take
//     them (an n-tile's C fragment is z1bar's A fragment in the relabelled
//     k order below).  Both depend only on their own inputs.
// Every relu, b2 add, mask and weighted row sum is local to a column, so
// chunking is exact; each output column keeps its k order.  Tensor-core
// chains are at most 4 k-steps (12 products in 3xTF32), added in fp32 in
// order (common.cuh).  Registers and shared memory are the same at every
// width past 64.
//
// The relabelled k order, used for every operand: in k-step ks, A column
// (and B row) t is feature 8ks + 2t, column t + 4 feature 8ks + 2t + 1.
// Then a C fragment (row g: columns 2t, 2t + 1; row g + 8: the same) is an
// A fragment as it stands: a0 = c0, a1 = c2, a2 = c1, a3 = c3.
#pragma once

#include "common.cuh"

namespace epnn {
namespace wide {

constexpr int kNC = 32;                         // output columns a chunk
constexpr int kChunks = (kHp + kNC - 1) / kNC;  // chunks of the H outputs
constexpr int kDS = kNC + 4;                    // term-tile row stride

// feature f of a row of real width w, 0 past it or for an idle entry
__device__ __forceinline__ float at(const float* __restrict__ row, int f,
                                    int w, bool valid) {
  return valid && f < w ? row[f] : 0.0f;
}

// the split A fragment of four values (a0: row g, a1: row g + 8 at
// feature 8ks + 2t; a2, a3 the same at 8ks + 2t + 1)
__device__ __forceinline__ void split_a(const float (&a)[4], uint32_t (&ah)[4],
                                        uint32_t (&al)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) tf32_split(a[r], ah[r], al[r]);
}

// the split B fragment of k-step ks, column n of w (rows x kHp, zero-padded
// rows): B rows t and t + 4 are w's rows 8ks + 2t and 8ks + 2t + 1; a
// column past kHp is 0
__device__ __forceinline__ uint4 bfrag(const float* __restrict__ w, int ks,
                                       int n, int t) {
  if (n >= kHp) return make_uint4(0u, 0u, 0u, 0u);
  const float* p = w + (size_t)(8 * ks + 2 * t) * kHp + n;
  return split_b(p[0], p[kHp]);
}

// v = c (first chain) or v + c, then c = 0: chains added in fp32 in order
template <int n>
__device__ __forceinline__ void fold(float (&v)[n], float (&c)[n],
                                     bool first) {
#pragma unroll
  for (int r = 0; r < n; ++r) {
    v[r] = first ? c[r] : v[r] + c[r];
    c[r] = 0.0f;
  }
}

// y[m] = b2 + z_m @ W2 over the output chunk n0 .. n0 + 31 for nz A
// operands at once (the same B fragments): zv(ks, z) gives their k-step
// ks (z[m][4], a0 .. a3 order).  y[m][nt]: C fragment of n-tile nt.
template <int nz, class ZV>
__device__ __forceinline__ void mid(const float* __restrict__ w2,
                                    const float* __restrict__ b2, int n0,
                                    int lane, ZV&& zv,
                                    float (&y)[nz][4][4]) {
  const int g = lane >> 2, t = lane & 3;
  float c[nz][4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = n0 + 8 * nt + 2 * t;
    const float b0 = col < kHp ? b2[col] : 0.0f;
    const float b1 = col < kHp ? b2[col + 1] : 0.0f;
#pragma unroll
    for (int m = 0; m < nz; ++m) {
      c[m][nt][0] = c[m][nt][2] = b0;
      c[m][nt][1] = c[m][nt][3] = b1;
    }
  }
#pragma unroll 1
  for (int k0 = 0; k0 < kNT; k0 += 4) {
#pragma unroll 1
    for (int kk = 0; kk < 4; ++kk) {
      const int ks = k0 + kk;
      if (kNT % 4 == 0 || ks < kNT) {
        float z[nz][4];
        zv(ks, z);
        uint32_t ah[nz][4], al[nz][4];
#pragma unroll
        for (int m = 0; m < nz; ++m) split_a(z[m], ah[m], al[m]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const uint4 b = bfrag(w2, ks, n0 + 8 * nt + g, t);
#pragma unroll
          for (int m = 0; m < nz; ++m) mma_tier(c[m][nt], ah[m], al[m], b);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < nz; ++m)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) fold(y[m][nt], c[m][nt], k0 == 0);
  }
}

// ---- the near tiles, wide ---------------------------------------------------
//
// As common.cuh's near tiles (rings of live slots or pairs, 16 a tile, a
// warp's rows contiguous), but a tile runs chunk by chunk: epart of its 16
// entries goes to the warp's scratch (epart_rows), then for output chunk
// oc each k-step of the mid layers adds epart's values to the two bases
// (wide::tile), the chunk's 16 x 32 terms go to the warp's term tile, and
// lane o adds column 32oc + o of them into the rows' sums in out, in
// ascending order: a warp zeroes its rows of out first, and each column of
// a row is read, added to and written by one lane, so the sums are those
// of a register accumulation, in the same order, on every launch.

struct NearSmem {
  int ring[kNearWarps][kNearRing];  // flat slot indices of live slots
  int rows[kNearWarps][kNearRing];  // and their rows
  float d[kNearWarps][16][kDS];     // a chunk's weighted terms
};

// out[row, n0 + lane] += the chunk's terms of entries 0 .. n - 1, in order
__device__ __forceinline__ void row_add(const float (*d)[kDS], const int* rows,
                                        int ring_mask, int head, int n,
                                        int n0, float* __restrict__ out,
                                        int lane) {
  const int col = n0 + lane;
  if (col >= kH) return;
  int prev = -1;
  float acc = 0.0f;
  for (int e = 0; e < n; ++e) {
    const int row = rows[(head + e) & ring_mask];
    if (row != prev) {
      if (prev >= 0) out[(size_t)prev * kH + col] = acc;
      acc = out[(size_t)row * kH + col];
      prev = row;
    }
    acc += d[e][lane];
  }
  if (prev >= 0) out[(size_t)prev * kH + col] = acc;
}

// rows [r0, r1) of out (N, kH) to 0, lane o taking the columns it sums
__device__ __forceinline__ void zero_rows(float* __restrict__ out, int r0,
                                          int r1, int lane) {
  for (int r = r0; r < r1; ++r)
    for (int c = lane; c < kH; c += 32) out[(size_t)r * kH + c] = 0.0f;
}

// epart = rbf @ W1e of a tile's 16 entries into ep (16 x kHp, the warp's
// scratch), the four n-tiles of an output chunk at a time on one A
// fragment: rbf(s, e) is channel e of entry g + 8s (0 past E)
template <class Rbf>
__device__ __forceinline__ void epart_rows(const float* __restrict__ w1e,
                                           int lane, Rbf&& rbf, float* ep) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int oc = 0; oc < kChunks; ++oc) {
    float c[4][4], v[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) c[nt][r] = 0.0f;
#pragma unroll 1
    for (int k0 = 0; k0 < kKE; k0 += 4) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int ke = k0 + kk;
        if (kKE % 4 == 0 || ke < kKE) {
          const int e0 = 8 * ke + 2 * t;
          const float a[4] = {rbf(0, e0), rbf(1, e0), rbf(0, e0 + 1),
                              rbf(1, e0 + 1)};
          uint32_t ah[4], al[4];
          split_a(a, ah, al);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_tier(c[nt], ah, al,
                     bfrag(w1e, ke, kNC * oc + 8 * nt + g, t));
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) fold(v[nt], c[nt], k0 == 0);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = kNC * oc + 8 * nt + 2 * t;
      if (col < kHp) {
        ep[g * kHp + col] = v[nt][0];
        ep[g * kHp + col + 1] = v[nt][1];
        ep[(g + 8) * kHp + col] = v[nt][2];
        ep[(g + 8) * kHp + col + 1] = v[nt][3];
      }
    }
  }
  __syncwarp();  // the tile's epart is visible to the whole warp
}

// One tile of a near kernel: entries g (s = 0) and g + 8 (s = 1).
// rbf(s, e): the entry's channel e (0 past E); zpair(s, f, ep, z1, z2):
// the two mid-layer inputs (already through relu) at feature f from
// epart's value ep there; term(s, y1, y2): the entry's weighted term from
// the two mid layers' outputs; ep: the warp's scratch (16 x kHp).  Sums
// the terms into out's rows.
template <class Rbf, class ZPair, class Term>
__device__ __forceinline__ void tile(const float* __restrict__ w1e,
                                     const float* __restrict__ w2,
                                     const float* __restrict__ b2, int lane,
                                     Rbf&& rbf, ZPair&& zpair, Term&& term,
                                     float* ep,
                                     float (*d)[kDS], const int* rows,
                                     int ring_mask, int head, int n,
                                     float* __restrict__ out) {
  const int g = lane >> 2, t = lane & 3;
  epart_rows(w1e, lane, rbf, ep);
  auto zv = [&](int ks, float (&z)[2][4]) {
    const int f0 = 8 * ks + 2 * t;
    const float e[4] = {ep[g * kHp + f0], ep[g * kHp + f0 + 1],
                        ep[(g + 8) * kHp + f0], ep[(g + 8) * kHp + f0 + 1]};
    zpair(0, f0, e[0], z[0][0], z[1][0]);
    zpair(1, f0, e[2], z[0][1], z[1][1]);
    zpair(0, f0 + 1, e[1], z[0][2], z[1][2]);
    zpair(1, f0 + 1, e[3], z[0][3], z[1][3]);
  };
#pragma unroll 1
  for (int oc = 0; oc < kChunks; ++oc) {
    float y[2][4][4];
    mid<2>(w2, b2, kNC * oc, lane, zv, y);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int o = 8 * nt + 2 * t;
      d[g][o] = term(0, y[0][nt][0], y[1][nt][0]);
      d[g][o + 1] = term(0, y[0][nt][1], y[1][nt][1]);
      d[g + 8][o] = term(1, y[0][nt][2], y[1][nt][2]);
      d[g + 8][o + 1] = term(1, y[0][nt][3], y[1][nt][3]);
    }
    __syncwarp();
    row_add(d, rows, ring_mask, head, n, kNC * oc, out, lane);
    __syncwarp();  // d is consumed
  }
}

// a warp's slice of the near kernels' epart scratch
constexpr int kScratch = 16 * kHp;

// common.cuh's near_walk with the wide tiles: live slots (flat index and
// row) into the ring, tile(head, n) for every 16 (n < 16 only for the
// last); the tile sums its terms into out itself.
template <class Tile>
__device__ __forceinline__ void near_walk(NearSmem& s, int warp, int lane,
                                          const float* __restrict__ wgt,
                                          int K, int r0, int r1,
                                          float* __restrict__ out,
                                          Tile&& tile) {
  int* ring = s.ring[warp];
  int* rows = s.rows[warp];
  zero_rows(out, r0, r1, lane);
  int head = 0, tail = 0;
  const int f1 = r1 * K;
  for (int base = r0 * K; base < f1; base += 32) {
    const int f = base + lane;
    const bool live = f < f1 && wgt[f] != 0.0f;
    const unsigned bal = __ballot_sync(0xffffffffu, live);
    if (live) {
      const int at =
          (tail + __popc(bal & ((1u << lane) - 1))) & (kNearRing - 1);
      ring[at] = f;
      rows[at] = f / K;
    }
    tail += __popc(bal);
    __syncwarp();
    while (tail - head >= 16) {
      tile(head, 16);
      head += 16;
      __syncwarp();
    }
  }
  if (tail > head) tile(head, tail - head);
}

// common.cuh's pair_walk with the wide tiles (the same scan of the pair
// grid over columns staged in shared memory, in segments; the tiles run
// between them).  Every warp of the block calls it.
template <class Tile>
__device__ __forceinline__ void pair_walk(ScanSmem& sc, int warp, int lane,
                                          const float* __restrict__ xyz,
                                          const float* __restrict__ mask,
                                          float cut2, int N, int n_warps,
                                          int r0, int r1,
                                          float* __restrict__ out,
                                          Tile&& tile) {
  int* ring = sc.ring[warp];
  int* rows = sc.rows[warp];
  zero_rows(out, r0, r1, lane);
  int head = 0, tail = 0;
  auto stage = [&](int st, int b) {
    for (int e = threadIdx.x; e < kScanCols; e += blockDim.x) {
      const int j = st * kScanCols + e;
      const bool in = j < N;
      float* dst = &sc.col[b][e].x;
      cp_async4(dst, xyz + (in ? 3 * j : 0), in);
      cp_async4(dst + 1, xyz + (in ? 3 * j + 1 : 0), in);
      cp_async4(dst + 2, xyz + (in ? 3 * j + 2 : 0), in);
      cp_async4(dst + 3, mask + (in ? j : 0), in);
    }
    cp_async_commit();
  };
  const int steps = (N + n_warps - 1) / n_warps;
  const int stages = (N + kScanCols - 1) / kScanCols;
  const int total = steps * stages;
  stage(0, 0);
  int it = 0;
  bool more = true;
  while (more) {
    more = false;
    for (; it < total; ++it) {
      if (it + 1 < total) {
        stage((it + 1) % stages, (it + 1) & 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int i = r0 + it / stages, st = it % stages;
      if (i < r1) {
        const float4* col = sc.col[it & 1];
        const float xi = xyz[3 * i], yi = xyz[3 * i + 1], zi = xyz[3 * i + 2];
        const bool vi = mask[i] != 0.0f;
        for (int c = 0; c < kScanCols; c += 32) {
          const int j = st * kScanCols + c + lane;
          const float4 cj = col[c + lane];
          const bool lv = j < N && vi && i != j && cj.w != 0.0f &&
                          pair_d2(xi, yi, zi, cj.x, cj.y, cj.z) < cut2;
          const unsigned bal = __ballot_sync(0xffffffffu, lv);
          if (lv) {
            const int at =
                (tail + __popc(bal & ((1u << lane) - 1))) & (kPairRing - 1);
            ring[at] = j;
            rows[at] = i;
          }
          tail += __popc(bal);
        }
      }
      if (__syncthreads_or(tail - head > kPairRing - kScanCols)) {
        ++it;
        more = it < total;
        break;
      }
    }
    __syncwarp();
    while (tail - head >= 16) {
      tile(head, 16);
      head += 16;
      __syncwarp();
    }
  }
  if (tail > head) tile(head, tail - head);
}

// The fused kernels' pair (i, j) as the plain versions featurize it: the
// masked envelope c (0 for i == j) and d = sqrt(d^2), pm = m_i * m_j
// (common.cuh's pair_channels without the channels, which rbf_of builds
// one at a time)
__device__ __forceinline__ float pair_env(const float* __restrict__ xyz,
                                          const float* __restrict__ mask,
                                          int i, int j, float cutoff,
                                          float& d, float& pm) {
  const float d2 = pair_d2(xyz[3 * i], xyz[3 * i + 1], xyz[3 * i + 2],
                           xyz[3 * j], xyz[3 * j + 1], xyz[3 * j + 2]);
  pm = __fmul_rn(mask[i], mask[j]);
  return __fmul_rn(envelope(d2, cutoff, d), i != j ? pm : 0.0f);
}

// channel e of a pair with envelope c at distance d, or the doubling's
// (a, u) (common.cuh, channel; tab: mu or the gains g); 0 past E
template <bool dbl>
__device__ __forceinline__ float rbf_of(float c, float d, float a, float u,
                                        const float* __restrict__ tab, int e,
                                        float neg_eta) {
  return e < kE ? channel<dbl>(c, d, a, u, tab[e], e, neg_eta) : 0.0f;
}

}  // namespace wide
}  // namespace epnn
