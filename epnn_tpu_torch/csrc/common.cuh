// Shared device helpers of the epnn_tpu_torch kernels.
//
// Every kernel here is float32-grade and compiled without --use_fast_math.
// On the CUDA cores, products are written as explicit fmaf() chains in a
// fixed k order, so the same inputs give the same bits in every thread —
// the property the electron-passing kernel's exact antisymmetry rests on.
// The far-field kernels (dense_message_rowsum and its backward) run their
// H x H products on the tensor cores in 3xTF32 (below), which keeps fp32
// grade; TF32 alone would not.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace epnn {

__device__ __forceinline__ float relu(float x) { return fmaxf(x, 0.0f); }

// y[o] = b[o] + sum_k z[k] * W[k][o], W row-major (K, H) staged in shared
// memory as float4 rows; every lane of a warp reads the same W entry, so
// the reads are broadcasts.
template <int K, int H>
__device__ __forceinline__ void matvec_bias(const float (&z)[K],
                                            const float4* __restrict__ w,
                                            const float* __restrict__ b,
                                            float (&y)[H]) {
#pragma unroll
  for (int o = 0; o < H; ++o) y[o] = b[o];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float zk = z[k];
#pragma unroll
    for (int o4 = 0; o4 < H / 4; ++o4) {
      const float4 wv = w[k * (H / 4) + o4];
      y[4 * o4 + 0] = fmaf(zk, wv.x, y[4 * o4 + 0]);
      y[4 * o4 + 1] = fmaf(zk, wv.y, y[4 * o4 + 1]);
      y[4 * o4 + 2] = fmaf(zk, wv.z, y[4 * o4 + 2]);
      y[4 * o4 + 3] = fmaf(zk, wv.w, y[4 * o4 + 3]);
    }
  }
}

// The same product for two inputs sharing each W read.  Each output is its
// own fmaf chain in the same k order as matvec_bias, so
// matvec2_bias(a, b) gives bitwise matvec_bias(a) and matvec_bias(b).
template <int K, int H>
__device__ __forceinline__ void matvec2_bias(const float (&za)[K],
                                             const float (&zb)[K],
                                             const float4* __restrict__ w,
                                             const float* __restrict__ b,
                                             float (&ya)[H], float (&yb)[H]) {
#pragma unroll
  for (int o = 0; o < H; ++o) {
    ya[o] = b[o];
    yb[o] = b[o];
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float a = za[k];
    const float c = zb[k];
#pragma unroll
    for (int o4 = 0; o4 < H / 4; ++o4) {
      const float4 wv = w[k * (H / 4) + o4];
      ya[4 * o4 + 0] = fmaf(a, wv.x, ya[4 * o4 + 0]);
      ya[4 * o4 + 1] = fmaf(a, wv.y, ya[4 * o4 + 1]);
      ya[4 * o4 + 2] = fmaf(a, wv.z, ya[4 * o4 + 2]);
      ya[4 * o4 + 3] = fmaf(a, wv.w, ya[4 * o4 + 3]);
      yb[4 * o4 + 0] = fmaf(c, wv.x, yb[4 * o4 + 0]);
      yb[4 * o4 + 1] = fmaf(c, wv.y, yb[4 * o4 + 1]);
      yb[4 * o4 + 2] = fmaf(c, wv.z, yb[4 * o4 + 2]);
      yb[4 * o4 + 3] = fmaf(c, wv.w, yb[4 * o4 + 3]);
    }
  }
}

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

}  // namespace epnn
