// Shared device helpers of the epnn_tpu_torch kernels.
//
// Every kernel here is float32-grade and compiled without --use_fast_math.
// On the CUDA cores, products are written as explicit fmaf() chains in a
// fixed k order, so the same inputs give the same bits in every thread —
// the property the dense electron-passing kernel's exact antisymmetry rests
// on.  The far-field kernels (dense_message_rowsum and its backward) and
// the two near kernels run their products on the tensor cores in 3xTF32
// (below), which keeps fp32 grade; TF32 alone would not.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace epnn {

__device__ __forceinline__ float relu(float x) { return fmaxf(x, 0.0f); }

// Stage n floats (n % 4 == 0, 16-byte aligned) from global into shared.
__device__ __forceinline__ void stage(float4* __restrict__ dst,
                                      const float* __restrict__ src, int n) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  for (int t = threadIdx.x; t < n / 4; t += blockDim.x) dst[t] = s4[t];
}

// ---- pair featurization of the fused dense kernels ------------------------
//
// The same ops, in the same order, as the plain versions
// (kernels.pair_d2, kernels.envelope_rbf): d^2 axis by axis as (a_i - a_j)^2 — the same
// bits for (j, i) as for (i, j) — then d, the cosine envelope with the
// coincident-atom rules, and the Gaussian channels.  Round-to-nearest
// intrinsics keep the compiler from contracting any step into an FMA, so a
// pair's features are one function of its d^2 wherever it lands in a grid.

__device__ __forceinline__ float pair_d2(float xi, float yi, float zi,
                                         float xj, float yj, float zj) {
  const float dx = __fsub_rn(xi, xj), dy = __fsub_rn(yi, yj),
              dz = __fsub_rn(zi, zj);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// d = sqrt(d^2) where d^2 > 0, else 0; returns the (unmasked) envelope
// (cos(pi d / cutoff) + 1) / 2, 0 from the cutoff on, 1 at d = 0.
__device__ __forceinline__ float envelope(float d2, float cutoff, float& d) {
  d = d2 > 0.0f ? __fsqrt_rn(d2) : 0.0f;
  float c = __fmul_rn(
      __fadd_rn(cosf(__fdiv_rn(__fmul_rn(3.14159265358979f, d), cutoff)),
                1.0f),
      0.5f);
  if (d >= cutoff) c = 0.0f;
  if (d <= 0.0f) c = 1.0f;
  return c;
}

// channel e: c * exp(-eta * (d - mu_e)^2)
__device__ __forceinline__ float rbf_channel(float c, float d, float mu,
                                             float neg_eta) {
  const float t = __fsub_rn(d, mu);
  return __fmul_rn(c, expf(__fmul_rn(neg_eta, __fmul_rn(t, t))));
}

// ---- the 16 x 16 pair tile of the fused dense kernels ---------------------
//
// A tile row k holds one feature of 256 pairs; pair p = g * 8 + q * 4 + r
// (g < 32, q < 2, r < 4) sits at float4 q * 32 + g, lane r, so the 8 pairs
// of pair group g are the float4s g and 32 + g of every row.
constexpr int kTilePairs = 256;

__device__ __forceinline__ int tile_slot(int p) {
  return ((((p >> 2) & 1) * 32 + (p >> 3)) << 2) | (p & 3);
}

// y[p][u] += sum_k tile[k][pair pg * 8 + p] * w[k][og * 4 + u] for k = 0 ..
// K - 1 in that order: one fmaf chain per output, the same for every pair.
template <int K, int H>
__device__ __forceinline__ void tile_mac(const float4* __restrict__ tile,
                                         const float4* __restrict__ w, int pg,
                                         int og, float (&y)[8][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float4 za = tile[k * (kTilePairs / 4) + pg];
    const float4 zb = tile[k * (kTilePairs / 4) + 32 + pg];
    const float4 wv = w[k * (H / 4) + og];
    const float zv[8] = {za.x, za.y, za.z, za.w, zb.x, zb.y, zb.z, zb.w};
    const float ww[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int u = 0; u < 4; ++u) y[p][u] = fmaf(zv[p], ww[u], y[p][u]);
  }
}

// out[t] = sum_p part[p * count + t] for p = 0 .. parts - 1 in that order:
// the second pass of the kernels that split a reduction into fixed parts.
__global__ void sum_parts(const float* __restrict__ part,
                          float* __restrict__ out, int count, int parts) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= count) return;
  float s = part[t];
  for (int p = 1; p < parts; ++p) s += part[(size_t)p * count + t];
  out[t] = s;
}

// ---- cp.async: 4-byte copies into shared memory ---------------------------
//
// 4 bytes a copy, so a source needs no 16-byte alignment (a row of a batch
// may start anywhere).  src_bytes = 0 writes zeros and reads nothing.

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most n of this thread's committed groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// ---- 3xTF32 on the tensor cores (the far-field kernels) -------------------
//
// A float x splits into hi = tf32(x) and lo = tf32(x - hi), each rounded to
// nearest with ties away from zero on the low 13 bits: the rounding of
// cvt.rna.tf32.f32, written as two integer ops (the same expression as
// kernels.tf32_round); x - hi is exact.  A product a * b is then
// lo_a * hi_b + hi_a * lo_b + hi_a * hi_b, the small terms first (the order
// of CUTLASS's OpMultiplyAddFastF32), accumulated in fp32 by mma.sync.  The
// dropped lo_a * lo_b is ~2^-22 relative, so the result is fp32-grade; one
// TF32 pass keeps ~2^-11.
// The tensor cores' fp32 accumulation truncates, so its error grows with
// the length of a chain: every chain here is at most 12 products (4 k-steps
// x 3), and longer sums are fp32 adds on the CUDA cores.

constexpr int kFarH = 32;  // the far-field kernels' width H

__device__ __forceinline__ float tf32_round(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  const float h = tf32_round(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(tf32_round(x - h));
}

// (hi(w0), hi(w1), lo(w0), lo(w1)): a B fragment, split
__device__ __forceinline__ uint4 split_b(float w0, float w1) {
  uint4 b;
  tf32_split(w0, b.x, b.z);
  tf32_split(w1, b.y, b.w);
  return b;
}

// d += a b, m16n8k8, TF32 in, fp32 accumulate.  Fragments (g = lane / 4,
// t = lane % 4): a0 (row g, col t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4); b0 (k t, n g), b1 (k t + 4, n g); c0, c1 (g,
// 2t + {0, 1}), c2, c3 (g + 8, 2t + {0, 1}).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32; b = split_b(...) of the two B values
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint4 b) {
  mma_tf32(d, al, b.x, b.y);
  mma_tf32(d, ah, b.z, b.w);
  mma_tf32(d, ah, b.x, b.y);
}

// The far field's pair layers on a warp's 16-row tile against one
// streamed entry s: c = b2 + relu(x_own + x_s) @ W2, with own rows g and
// g + 8 (xa, xb) and c in the C layout (c[nt] = outputs 8nt + 2t + {0, 1}
// of row g, then of row g + 8).  The contraction index is permuted so that
// thread t holds features 8t .. 8t + 7 of every row: in k-step ks, A
// column t is feature 8t + 2ks and column t + 4 feature 8t + 2ks + 1, and
// bfrag(ks, nt) must be w2_frag(ks, nt) in that order.  The forward and
// both passes of the backward run this on the same values, so they give a
// pair the same z2, bit for bit.
__device__ __forceinline__ uint4 w2_frag(const float* __restrict__ w2, int ks,
                                         int nt, int lane) {
  const int g = lane >> 2, t = lane & 3;
  return split_b(w2[(8 * t + 2 * ks) * kFarH + 8 * nt + g],
                 w2[(8 * t + 2 * ks + 1) * kFarH + 8 * nt + g]);
}

// k-step ks of A = relu(x_own + x_s), split, in far_z2's order
__device__ __forceinline__ void far_a(const float (&xa)[8],
                                      const float (&xb)[8],
                                      const float (&xs)[8], int ks,
                                      uint32_t (&ah)[4], uint32_t (&al)[4]) {
  tf32_split(relu(xa[2 * ks] + xs[2 * ks]), ah[0], al[0]);
  tf32_split(relu(xb[2 * ks] + xs[2 * ks]), ah[1], al[1]);
  tf32_split(relu(xa[2 * ks + 1] + xs[2 * ks + 1]), ah[2], al[2]);
  tf32_split(relu(xb[2 * ks + 1] + xs[2 * ks + 1]), ah[3], al[3]);
}

template <class BFrag>
__device__ __forceinline__ void far_z2(const float (&xa)[8],
                                       const float (&xb)[8],
                                       const float (&xs)[8],
                                       const float (&bias)[4][2],
                                       BFrag&& bfrag, float (&c)[4][4]) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    c[nt][0] = c[nt][2] = bias[nt][0];
    c[nt][1] = c[nt][3] = bias[nt][1];
  }
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t ah[4], al[4];
    far_a(xa, xb, xs, ks, ah, al);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) mma_3xtf32(c[nt], ah, al, bfrag(ks, nt));
  }
}

// ---- wgmma: warpgroup products m64n32k8, TF32 ------------------------------
//
// A (64 x 8) from registers — each warp of the warpgroup holds 16 rows as
// the m16n8k8 A fragment, so far_z2's A serves unchanged — B (8 x 32) from
// shared memory through a descriptor, D (64 x 32, fp32) in each warp's
// m16n8 C layout (d[4nt + r] = c[nt][r]).  Asynchronous: fence before the
// first product of a group when its registers were written, commit the
// group, wait before reading d.  On the H100 a chain of wgmma gives the same
// bits as the same chain of mma.sync.

namespace wg {

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most n committed groups are in flight
template <int n>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(n) : "memory");
}
// shared-memory stores made visible to wgmma's (asynchronous) reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of d across a wait
template <int n>
__device__ __forceinline__ void fence_regs(float (&d)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptor of a K-major B tile without swizzle: core matrices of 8 rows
// (n) x 16 bytes (4 k), the second k half lbo bytes on, the next 8 rows sbo
// bytes on.
__device__ __forceinline__ uint64_t desc(const void* tile, int lbo, int sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  return (uint64_t)((a & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

// d += a b, m64n32k8 TF32, fp32 accumulate
__device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4],
                                    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += a b in 3xTF32: lo_a hi_b + hi_a lo_b + hi_a hi_b, as mma_3xtf32
__device__ __forceinline__ void mma_3xtf32(float (&d)[16],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint64_t b_hi, uint64_t b_lo) {
  mma(d, al, b_hi);
  mma(d, ah, b_lo);
  mma(d, ah, b_hi);
}

}  // namespace wg

// features 8t .. 8t + 7 of one row of width kFarH (any alignment)
__device__ __forceinline__ void load_row8(const float* __restrict__ row,
                                          int t, bool valid, float (&x)[8]) {
#pragma unroll
  for (int m = 0; m < 8; ++m) x[m] = valid ? row[8 * t + m] : 0.0f;
}

// n floats from a 16-byte-aligned address as float4s; zeros if !valid
template <int n>
__device__ __forceinline__ void load_vec(const float* __restrict__ p,
                                         bool valid, float (&x)[n]) {
  static_assert(n % 4 == 0, "whole float4s");
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int q = 0; q < n / 4; ++q) {
    const float4 v = valid ? p4[q] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    x[4 * q] = v.x;
    x[4 * q + 1] = v.y;
    x[4 * q + 2] = v.z;
    x[4 * q + 3] = v.w;
  }
}

// ---- the near kernels: live slots in tiles of 16 (mma.sync, 3xTF32) -------
//
// near_message_corr and near_pass_rowsum run the same chain per neighbor
// slot: epart = rbf @ W1e (E = 48 -> H = 32), then one or two H x H mid
// layers.  A warp owns a contiguous range of rows; it walks their (N, K)
// weights 32 slots at a time, appends the live ones (weight != 0) to a ring
// in shared memory with a ballot prefix count — in ascending flat order,
// so row by row, slot by slot — and runs every 16 of them as the M rows of
// m16n8k8 products.  Only the last tile of a range has idle rows.  Lane o
// then adds column o of the tile's terms into its current row's sum in
// that order, and writes each row (0 for a row with no live slot) once it
// is complete: one fixed order, no atomics, a row never split across warps.
// A slot's terms depend only on its own inputs (the products of a row of A
// do not depend on its position among the 16), so the output does not
// depend on the grid.

constexpr int kNearH = 32;   // the near kernels' width H
constexpr int kNearE = 48;   // and RBF width E
constexpr int kNearWarps = 4;
constexpr int kNearThreads = 32 * kNearWarps;
constexpr int kNearRing = 64;      // >= 15 pending + 32 appended
constexpr int kNearMinRows = 2;    // rows a warp owns at the least
constexpr int kNearDStride = 40;   // term-tile row stride: conflict-free

struct NearSmem {
  uint4 b1[24][32];  // W1e, split: [ks * 4 + nt][lane] (near_w1e_frag)
  uint4 b2[16][32];  // W2, split: [ks * 4 + nt][lane] (w2_frag)
  int ring[kNearWarps][kNearRing];  // flat slot indices of live slots
  int rows[kNearWarps][kNearRing];  // and their rows
  float d[kNearWarps][16][kNearDStride];  // a tile's weighted terms
};

// epart's B = W1e (k = E feature, n = output feature), split.  k-step ks:
// B row t <-> feature 12t + 2ks, row t + 4 <-> 12t + 2ks + 1 (thread t
// holds features 12t .. 12t + 11 of its A rows); n-tile nt, column n <->
// output feature 8 (n / 2) + 2nt + n % 2, so that the C column 2t + h is
// output feature 8t + 2nt + h: the thread gets epart at the features
// 8t .. 8t + 7 that the mid layer's A (far_a's order) wants.
__device__ __forceinline__ uint4 near_w1e_frag(const float* __restrict__ w1e,
                                               int ks, int nt, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int o = 8 * (g >> 1) + 2 * nt + (g & 1);
  return split_b(w1e[(12 * t + 2 * ks) * kNearH + o],
                 w1e[(12 * t + 2 * ks + 1) * kNearH + o]);
}

// W1e's and W2's split B fragments into shared memory, once per block of
// kNearThreads (every load in flight at once); b2 of the thread's C
// columns into bias
__device__ __forceinline__ void near_stage(NearSmem& s,
                                           const float* __restrict__ w1e,
                                           const float* __restrict__ w2,
                                           const float* __restrict__ b2,
                                           float (&bias)[4][2]) {
#pragma unroll
  for (int i = 0; i < 24 * 32 / kNearThreads; ++i) {
    const int e = threadIdx.x + i * kNearThreads;
    s.b1[e >> 5][e & 31] = near_w1e_frag(w1e, e >> 7, (e >> 5) & 3, e & 31);
  }
#pragma unroll
  for (int i = 0; i < 16 * 32 / kNearThreads; ++i) {
    const int e = threadIdx.x + i * kNearThreads;
    s.b2[e >> 5][e & 31] = w2_frag(w2, e >> 7, (e >> 5) & 3, e & 31);
  }
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    bias[nt][0] = b2[8 * nt + 2 * t];
    bias[nt][1] = b2[8 * nt + 2 * t + 1];
  }
}

// epart = rbf @ W1e for a tile, in 3xTF32: A from the thread's features
// 12t .. 12t + 11 of entries g (ra) and g + 8 (rb).  Six k-steps are 18
// products an n-tile, so two chains of 9, added in fp32.  ep in the C
// layout with near_w1e_frag's columns: entry g's feature 8t + m is
// ep[m / 2][m % 2], entry g + 8's ep[m / 2][2 + m % 2].
__device__ __forceinline__ void near_epart(const float (&ra)[12],
                                           const float (&rb)[12],
                                           const uint4 (*b1)[32], int lane,
                                           float (&ep)[4][4]) {
  float c[2][4][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) c[h][nt][r] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < 6; ++ks) {
    uint32_t ah[4], al[4];
    tf32_split(ra[2 * ks], ah[0], al[0]);
    tf32_split(rb[2 * ks], ah[1], al[1]);
    tf32_split(ra[2 * ks + 1], ah[2], al[2]);
    tf32_split(rb[2 * ks + 1], ah[3], al[3]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      mma_3xtf32(c[ks / 3][nt], ah, al, b1[ks * 4 + nt][lane]);
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) ep[nt][r] = c[0][nt][r] + c[1][nt][r];
}

// entry g's (a) and g + 8's (b) epart at the thread's features 8t .. 8t + 7
__device__ __forceinline__ void near_ep_rows(const float (&ep)[4][4],
                                             float (&ea)[8], float (&eb)[8]) {
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    ea[m] = ep[m >> 1][m & 1];
    eb[m] = ep[m >> 1][2 + (m & 1)];
  }
}

// y = b2 + z @ W2 for a tile, in 3xTF32: A = z (already through relu) at
// the thread's features 8t .. 8t + 7 of entries g (za) and g + 8 (zb), in
// far_a's order; y in the C layout (y[nt]: outputs 8nt + 2t + {0, 1} of
// entry g, then of g + 8).  One chain of 12 products an n-tile.
__device__ __forceinline__ void near_mid(const float (&za)[8],
                                         const float (&zb)[8],
                                         const float (&bias)[4][2],
                                         const uint4 (*b2)[32], int lane,
                                         float (&y)[4][4]) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    y[nt][0] = y[nt][2] = bias[nt][0];
    y[nt][1] = y[nt][3] = bias[nt][1];
  }
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t ah[4], al[4];
    tf32_split(za[2 * ks], ah[0], al[0]);
    tf32_split(zb[2 * ks], ah[1], al[1]);
    tf32_split(za[2 * ks + 1], ah[2], al[2]);
    tf32_split(zb[2 * ks + 1], ah[3], al[3]);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      mma_3xtf32(y[nt], ah, al, b2[ks * 4 + nt][lane]);
  }
}

// The rows [r0, r1) of global warp gw of n_warps (N rows split evenly).
__device__ __forceinline__ void near_range(int N, int gw, int n_warps,
                                           int& r0, int& r1) {
  r0 = (int)((long long)N * gw / n_warps);
  r1 = (int)((long long)N * (gw + 1) / n_warps);
}

// The warp's walk over rows [r0, r1): live slots (flat index and row)
// into the ring, tile(h0, n) for every 16 (n < 16 only for the last), each
// tile's terms (d, written by tile) into lane o's row sums and out
// (N, kNearH).  The next 32 weights are loaded while a tile runs.
template <class Tile>
__device__ __forceinline__ void near_walk(NearSmem& s, int warp, int lane,
                                          const float* __restrict__ wgt,
                                          int K, int r0, int r1,
                                          float* __restrict__ out,
                                          Tile&& tile) {
  int* ring = s.ring[warp];
  int* rows = s.rows[warp];
  const float(*d)[kNearDStride] = s.d[warp];
  int head = 0, tail = 0, cur = r0;
  float acc = 0.0f;
  auto run = [&](int n) {
    tile(head, n);  // ends with the terms in d, after a __syncwarp
    for (int e = 0; e < n; ++e) {
      const int row = rows[(head + e) & (kNearRing - 1)];
      while (cur < row) {
        out[(size_t)cur * kNearH + lane] = acc;
        acc = 0.0f;
        ++cur;
      }
      acc += d[e][lane];
    }
    head += n;
    __syncwarp();  // d and the ring entries are consumed
  };
  const int f1 = r1 * K;
  float w_next = r0 * K + lane < f1 ? wgt[r0 * K + lane] : 0.0f;
  for (int base = r0 * K; base < f1; base += 32) {
    const int f = base + lane;
    const bool in = f < f1;
    const float w = w_next;
    if (f + 32 < f1) w_next = wgt[f + 32];
    const bool live = in && w != 0.0f;
    const unsigned bal = __ballot_sync(0xffffffffu, live);
    if (live) {
      const int at =
          (tail + __popc(bal & ((1u << lane) - 1))) & (kNearRing - 1);
      ring[at] = f;
      rows[at] = f / K;
    }
    tail += __popc(bal);
    __syncwarp();
    while (tail - head >= 16) run(16);
  }
  if (tail > head) run(tail - head);
  for (; cur < r1; ++cur) {
    out[(size_t)cur * kNearH + lane] = acc;
    acc = 0.0f;
  }
}

// The warps a near kernel's launch runs: a few resident blocks an SM (its
// occupancy), at most one warp a kNearMinRows rows.  resident caches the
// warps a card holds at once, per device (0: not yet asked).
constexpr int kNearMaxDevices = 64;

template <class Kernel>
cudaError_t near_warps(Kernel kernel, int (&resident)[kNearMaxDevices], int N,
                       int& n_warps) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kNearMaxDevices) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kNearThreads, 0);
    if (err != cudaSuccess) return err;
    resident[dev] = (per_sm > 0 ? per_sm : 1) * sms * kNearWarps;
  }
  const int by_rows = (N + kNearMinRows - 1) / kNearMinRows;
  n_warps = by_rows < resident[dev] ? by_rows : resident[dev];
  return cudaSuccess;
}

}  // namespace epnn
