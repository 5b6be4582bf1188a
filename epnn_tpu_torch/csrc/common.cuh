// Shared device helpers of the epnn_tpu_torch kernels.
//
// Every kernel here is compiled without --use_fast_math.  On the CUDA
// cores, products are written as explicit fmaf() chains in a fixed k order,
// so the same inputs give the same bits in every thread.  The far-field
// kernels (dense_message_rowsum and its backward), the two near kernels and
// the two fused dense kernels run their products on the tensor cores at the
// library's TF32 tier (EPNN_TF32_PASSES, below): 3xTF32, which keeps fp32
// grade (precision "high" and "highest"), or one TF32 product (precision
// "default", ~2^-11 relative a product).
//
// Widths.  A library is compiled for one mid width H and one RBF width E,
// the macros EPNN_H and EPNN_E (any width from 1; default 32 and 48, the
// shipped model's); kernels.build() passes them.  The products run at the
// widths
// padded to the tensor cores' granularity, kHp and kEp (multiples of 8:
// mma.sync m16n8k8 and wgmma take N and K in 8s).  Padding is exact: the
// weights come zero-padded (kernels.pad_weights, made once per set of
// weights), activations are read at their real width and row stride with
// the tail filled with zeros on chip, so a padded hidden unit is relu(0) = 0
// all the way through, and only the real H outputs are written.  At H = 32,
// E = 48 kH == kHp and every tail test folds away at compile time.
// Where a padded width passes 64 (EPNN_WIDE) a library takes the wide path
// of wide.cuh instead of the designs below: the preprocessor keeps every
// kernel body out of the other path's libraries, so the narrow libraries
// compile to the code they had before the wide path existed.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#ifndef EPNN_H
#define EPNN_H 32
#endif
#ifndef EPNN_E
#define EPNN_E 48
#endif
#if (EPNN_H + 7) / 8 * 8 > 64 || (EPNN_E + 7) / 8 * 8 > 64
#define EPNN_WIDE 1
#else
#define EPNN_WIDE 0
#endif

namespace epnn {

constexpr int kH = EPNN_H;               // mid width H
constexpr int kE = EPNN_E;               // RBF width E
static_assert(kH >= 1 && kE >= 1, "widths from 1");
constexpr int kHp = (kH + 7) / 8 * 8;    // H padded: the n-tiles of 8
constexpr int kEp = (kE + 7) / 8 * 8;    // E padded: the k-steps of 8
constexpr int kNT = kHp / 8;             // n-tiles (= k-steps) of an H x H
constexpr int kKE = kEp / 8;             // k-steps of rbf @ W1e
// Thread t (= lane % 4) of an m16n8k8 fragment holds kFH consecutive
// features kFH t .. kFH t + kFH - 1 of each of its A rows (kFE of an RBF
// row): the contraction index is permuted so (see far_a).
constexpr int kFH = kHp / 4;
constexpr int kFE = kEp / 4;

// Tensor-core chains of at most 4 k-steps (12 products in 3xTF32, 4 at one
// pass): a
// product of `ksteps` k-steps runs as chains(ksteps) chains, k-step ks in
// chain chain_of(ks, ksteps), their sums added in fp32 in order.
__host__ __device__ constexpr int chains(int ksteps) {
  return (ksteps + 3) / 4;
}
__host__ __device__ constexpr int chain_of(int ks, int ksteps) {
  return ks * chains(ksteps) / ksteps;
}

__device__ __forceinline__ float relu(float x) { return fmaxf(x, 0.0f); }

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

// The doubling (the JAX kernels' rbf_method "doubling", _tile_rbf_flat,
// pallas_kernels.py:238-250; kernels.envelope_rbf_doubling).  On the
// uniform centers mu_ch = 0.1 + ch D, D = (cutoff - 0.1) / (E - 1), the
// channels are a geometric sequence:
//   dc = min(d, cutoff) - 0.1,  a = c exp((-eta dc) dc),  u = exp(2 eta D dc),
//   rbf_ch = (a g_ch) u^ch,  g_ch = exp(-eta D^2 ch^2)
// — two exps a pair (doubling_pair) instead of one a channel; g is a table
// the kernel reads where "direct" reads mu (kernels.doubling_gains), and
// u^ch is multiplied in from u, u^2, u^4, ... (by repeated squaring) for
// the set bits of ch in ascending order (doubling_channel): JAX's masked
// squarings, in its order, so every rounding is the plain version's.  d
// is clamped to the cutoff (the envelope is 0 there) so u^ch stays finite
// for far atoms.  Each step is a function of d, and so of the pair's d^2:
// a pair's two orderings get the same channels under either method.

// bits of E - 1 (at least 1): the squarings u^ch takes
__host__ __device__ constexpr int bit_length(int x) {
  return x > 0 ? 1 + bit_length(x >> 1) : 0;
}
constexpr int kBits = bit_length(kE - 1) > 0 ? bit_length(kE - 1) : 1;

__device__ __forceinline__ void doubling_pair(float c, float d, float cutoff,
                                              float neg_eta, float u_scale,
                                              float& a, float& u) {
  const float dc = __fsub_rn(fminf(d, cutoff), 0.1f);
  a = __fmul_rn(c, expf(__fmul_rn(__fmul_rn(neg_eta, dc), dc)));
  u = expf(__fmul_rn(u_scale, dc));
}

__device__ __forceinline__ float doubling_channel(float a, float u, float g,
                                                  int ch) {
  float r = __fmul_rn(a, g), p = u;
#pragma unroll
  for (int b = 0; b < kBits; ++b) {
    if ((ch >> b) & 1) r = __fmul_rn(r, p);
    if (b + 1 < kBits) p = __fmul_rn(p, p);
  }
  return r;
}

// channel e of a pair under the method dbl: direct from (c, d) and mu_e,
// or the doubling from (a, u) and g_e (tab_e is mu_e or g_e).  The method
// is a template argument of the fused kernels (each library holds both
// instantiations, the host picks one a launch), so direct compiles to the
// code it had without the doubling.
template <bool dbl>
__device__ __forceinline__ float channel(float c, float d, float a, float u,
                                         float tab_e, int e, float neg_eta) {
  return dbl ? doubling_channel(a, u, tab_e, e)
             : rbf_channel(c, d, tab_e, neg_eta);
}

// Pair (i, j) of a fused kernel's tile, as the plain versions featurize
// it: the masked envelope c (0 for i == j), with pm = m_i * m_j, and the
// thread's channels n t .. n t + n - 1 (t = lane % 4) of its E channels
// (tab: the centers mu, or the doubling's gains g; shared memory, zeros
// past E) into r; channels past the real E are 0.  An idle M row comes as
// (0, 0): a self pair, all zeros.  dbl: the method (channel); u_scale = 2
// eta D, read by the doubling only.
template <int n, int e_real, bool dbl>
__device__ __forceinline__ float pair_channels(const float* __restrict__ xyz,
                                               const float* __restrict__ mask,
                                               const float* tab, int i, int j,
                                               int t, float cutoff,
                                               float neg_eta, float u_scale,
                                               float& pm, float (&r)[n]) {
  const float d2 = pair_d2(xyz[3 * i], xyz[3 * i + 1], xyz[3 * i + 2],
                           xyz[3 * j], xyz[3 * j + 1], xyz[3 * j + 2]);
  pm = __fmul_rn(mask[i], mask[j]);
  float d;
  const float c = __fmul_rn(envelope(d2, cutoff, d), i != j ? pm : 0.0f);
  float a = 0.0f, u = 0.0f;
  if (dbl) doubling_pair(c, d, cutoff, neg_eta, u_scale, a, u);
#pragma unroll
  for (int m = 0; m < n; ++m) {
    const int e = n * t + m;
    r[m] = (e_real == 4 * n || e < e_real)
               ? channel<dbl>(c, d, a, u, tab[e], e, neg_eta)
               : 0.0f;
  }
  return c;
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

// ---- TF32 tiers on the tensor cores ---------------------------------------
//
// A float x splits into hi = tf32(x) and lo = tf32(x - hi), each rounded to
// nearest with ties away from zero on the low 13 bits: the rounding of
// cvt.rna.tf32.f32, written as two integer ops (the same expression as
// kernels.tf32_round); x - hi is exact.  In 3xTF32 (EPNN_TF32_PASSES = 3,
// the default) a product a * b is then lo_a * hi_b + hi_a * lo_b + hi_a *
// hi_b, the small terms first (the order of CUTLASS's OpMultiplyAddFastF32),
// accumulated in fp32 by mma.sync.  The dropped lo_a * lo_b is ~2^-22
// relative, so the result is fp32-grade.  At one pass (EPNN_TF32_PASSES = 1,
// the "default" tier) a product is hi_a * hi_b alone, ~2^-11 relative: the
// operands are still rounded to nearest here, as the plain twins
// (kernels._mm_tf32) round them.  The tensor cores read a .tf32 operand's
// top 19 bits and drop the low 13 unrounded, which CUTLASS's
// tfloat32_t::round_half_ulp_truncate (cutlass/tfloat32.h) rests on too:
// it adds half an ulp and leaves the rest to them.  So an operand that
// meets nothing but the tensor cores may skip the rounding's last step,
// the mask (tf32_split<true>, one integer op fewer): the far field's
// forward walk builds A so (far_field.cuh), and on the H100 its outputs
// are the masked form's, bit for bit, at both tiers.
// Every kernel body reaches the tier through tf32_split, split_b, mma_tier
// and wg::mma_tier, so one macro sets it for all of them; lo is 0 at one
// pass and its products are left out.
// The tensor cores' fp32 accumulation truncates, so its error grows with
// the length of a chain: every chain here is at most 4 k-steps (12 products
// in 3xTF32), and longer sums are fp32 adds on the CUDA cores (chains()).

#ifndef EPNN_TF32_PASSES
#define EPNN_TF32_PASSES 3
#endif
static_assert(EPNN_TF32_PASSES == 3 || EPNN_TF32_PASSES == 1,
              "EPNN_TF32_PASSES is 3 (3xTF32) or 1 (one TF32 product)");
constexpr bool kSplit = EPNN_TF32_PASSES == 3;  // lo parts and their products

__device__ __forceinline__ float tf32_round(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// x = hi + lo at the library's tier (lo = 0 at one pass).  kTc, for an
// operand that meets nothing but the tensor cores: each rounding's last
// step, the mask, is left to them (above); hi stays masked in 3xTF32,
// where lo is taken from it
template <bool kTc = false>
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  if constexpr (kTc && !kSplit) {
    hi = __float_as_uint(x) + 0x1000u;
    lo = 0u;
  } else {
    const float h = tf32_round(x);
    hi = __float_as_uint(h);
    lo = !kSplit ? 0u
         : kTc   ? __float_as_uint(x - h) + 0x1000u
                 : __float_as_uint(tf32_round(x - h));
  }
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

// d += a b at the library's tier; b = split_b(...) of the two B values
__device__ __forceinline__ void mma_tier(float (&d)[4],
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4], uint4 b) {
  if constexpr (kSplit) {
    mma_tf32(d, al, b.x, b.y);
    mma_tf32(d, ah, b.z, b.w);
  }
  mma_tf32(d, ah, b.x, b.y);
}

// The far field's pair layers on a warp's 16-row tile against one
// streamed entry s: c = b2 + relu(x_own + x_s) @ W2, with own rows g and
// g + 8 (xa, xb) and c in the C layout (c[nt] = outputs 8nt + 2t + {0, 1}
// of row g, then of row g + 8).  The contraction index is permuted so that
// thread t holds features kFH t .. kFH t + kFH - 1 of every row: in k-step
// ks, A column t is feature kFH t + 2ks and column t + 4 feature kFH t +
// 2ks + 1, and bfrag(ks, nt) must be w2_frag(ks, nt) in that order.  The
// forward and both passes of the backward run this on the same values, so
// they give a pair the same z2, bit for bit.  W2 comes padded (kHp, kHp).
__device__ __forceinline__ uint4 w2_frag(const float* __restrict__ w2, int ks,
                                         int nt, int lane) {
  const int g = lane >> 2, t = lane & 3;
  return split_b(w2[(kFH * t + 2 * ks) * kHp + 8 * nt + g],
                 w2[(kFH * t + 2 * ks + 1) * kHp + 8 * nt + g]);
}

// k-step ks of A = relu(x_own + x_s), split, in far_z2's order; kTc as in
// tf32_split (the forward's two-column walk, far_field.cuh)
template <bool kTc = false>
__device__ __forceinline__ void far_a(const float (&xa)[kFH],
                                      const float (&xb)[kFH],
                                      const float (&xs)[kFH], int ks,
                                      uint32_t (&ah)[4], uint32_t (&al)[4]) {
  tf32_split<kTc>(relu(xa[2 * ks] + xs[2 * ks]), ah[0], al[0]);
  tf32_split<kTc>(relu(xb[2 * ks] + xs[2 * ks]), ah[1], al[1]);
  tf32_split<kTc>(relu(xa[2 * ks + 1] + xs[2 * ks + 1]), ah[2], al[2]);
  tf32_split<kTc>(relu(xb[2 * ks + 1] + xs[2 * ks + 1]), ah[3], al[3]);
}

template <class BFrag>
__device__ __forceinline__ void far_z2(const float (&xa)[kFH],
                                       const float (&xb)[kFH],
                                       const float (&xs)[kFH],
                                       const float (&bias)[kNT][2],
                                       BFrag&& bfrag, float (&c)[kNT][4]) {
  constexpr int kC = chains(kNT);
  float p[kC][kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    p[0][nt][0] = p[0][nt][2] = bias[nt][0];
    p[0][nt][1] = p[0][nt][3] = bias[nt][1];
#pragma unroll
    for (int h = 1; h < kC; ++h)
#pragma unroll
      for (int r = 0; r < 4; ++r) p[h][nt][r] = 0.0f;
  }
#pragma unroll
  for (int ks = 0; ks < kNT; ++ks) {
    uint32_t ah[4], al[4];
    far_a(xa, xb, xs, ks, ah, al);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
      mma_tier(p[chain_of(ks, kNT)][nt], ah, al, bfrag(ks, nt));
  }
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float v = p[0][nt][r];
#pragma unroll
      for (int h = 1; h < kC; ++h) v += p[h][nt][r];
      c[nt][r] = v;
    }
}

// ---- wgmma: warpgroup products m64nNk8, TF32 --------------------------------
//
// A (64 x 8) from registers — each warp of the warpgroup holds 16 rows as
// the m16n8k8 A fragment, so far_z2's A serves unchanged — B (8 x N) from
// shared memory through a descriptor, D (64 x N, fp32) in each warp's
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

// d += a b, m64nNk8 TF32, fp32 accumulate (N = 8 .. 64)
template <int N>
struct Mma;

template <>
struct Mma<8> {
  static __device__ __forceinline__ void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Mma<16> {
  static __device__ __forceinline__ void run(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, "
        "p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Mma<24> {
  static __device__ __forceinline__ void run(float (&d)[12],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, {%12, "
        "%13, %14, %15}, %16, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Mma<32> {
  static __device__ __forceinline__ void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Mma<40> {
  static __device__ __forceinline__ void run(float (&d)[20],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19}, {%20, %21, %22, %23}, %24, p, "
        "1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Mma<48> {
  static __device__ __forceinline__ void run(float (&d)[24],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, {%24, "
        "%25, %26, %27}, %28, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Mma<56> {
  static __device__ __forceinline__ void run(float (&d)[28],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27}, {%28, %29, %30, %31}, %32, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, "
        "1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// d += a b at the library's tier, as mma_tier: in 3xTF32 lo_a hi_b +
// hi_a lo_b + hi_a hi_b; at one pass hi_a hi_b (b_lo is then not read)
template <int N>
__device__ __forceinline__ void mma_tier(float (&d)[N / 2],
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         uint64_t b_hi, uint64_t b_lo) {
  if constexpr (kSplit) {
    Mma<N>::run(d, al, b_hi);
    Mma<N>::run(d, ah, b_lo);
  }
  Mma<N>::run(d, ah, b_hi);
}

}  // namespace wg

// n features n t .. n t + n - 1 of one row of real width `width` (any
// alignment, one float at a time); zeros past the width, or if !valid
template <int n, int width>
__device__ __forceinline__ void load_row(const float* __restrict__ row,
                                         int t, bool valid, float (&x)[n]) {
#pragma unroll
  for (int m = 0; m < n; ++m)
    x[m] = valid && (width == 4 * n || n * t + m < width) ? row[n * t + m]
                                                          : 0.0f;
}

// the same, as float4s where width % 16 == 0 (then the row and the thread's
// part of it start on 16 bytes if the tensor does: kernels._launch checks);
// one float at a time otherwise
template <int n, int width>
__device__ __forceinline__ void load_vec(const float* __restrict__ row, int t,
                                         bool valid, float (&x)[n]) {
  if constexpr (width % 16 == 0 && width == 4 * n) {
    const float4* p4 = reinterpret_cast<const float4*>(row + n * t);
#pragma unroll
    for (int q = 0; q < n / 4; ++q) {
      const float4 v = valid ? p4[q] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      x[4 * q] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
  } else {
    load_row<n, width>(row, t, valid, x);
  }
}

// ---- the near tiles: live slots or pairs in tiles of 16 (mma.sync) --------
//
// near_message_corr and near_pass_rowsum (and the live part of the two
// fused dense kernels) run the same chain per neighbor slot: epart = rbf @
// W1e (E -> H), then one or two H x H mid layers.  A warp owns a
// contiguous range of rows; it walks their slots (or, in the fused
// kernels, their row of the pair grid) 32 at a time, appends the live ones
// (weight != 0, or within the cutoff) to a ring in shared memory with a
// ballot prefix count — in ascending flat order, so row by row, slot by
// slot — and runs every 16 of them as the M rows of m16n8k8 products.
// Only the last tile of a range has idle rows.  Lane o then adds column o
// (o + 32, ...) of the tile's terms into its current row's sum in that
// order, and writes each row (0 for a row with no live slot) once it is
// complete: one fixed order, no atomics, a row never split across warps.
// A slot's terms depend only on its own inputs (the products of a row of A
// do not depend on its position among the 16), so the output does not
// depend on the grid.

constexpr int kNearWarps = 4;
constexpr int kNearThreads = 32 * kNearWarps;
constexpr int kNearRing = 64;          // >= 15 pending + 32 appended
constexpr int kNearMinRows = 2;        // rows a warp owns at the least
constexpr int kNearDStride = kHp + 8;  // term-tile row stride: conflict-free
constexpr int kNearOut = (kH + 31) / 32;  // output columns a lane sums

// shared memory of a near block: dynamic (kernels launch with
// sizeof(NearSmem) bytes), as it passes 48 KB at the widest widths
struct NearSmem {
  uint4 b1[kKE * kNT][32];  // W1e, split: [ks * kNT + nt][lane]
  uint4 b2[kNT * kNT][32];  // W2, split: [ks * kNT + nt][lane] (w2_frag)
  int ring[kNearWarps][kNearRing];  // flat slot indices of live slots
  int rows[kNearWarps][kNearRing];  // and their rows
  float d[kNearWarps][16][kNearDStride];  // a tile's weighted terms
};

// epart's B = W1e (k = E feature, n = output feature), split, W1e padded
// (kEp, kHp).  k-step ks: B row t <-> feature kFE t + 2ks, row t + 4 <->
// kFE t + 2ks + 1 (thread t holds features kFE t .. of its A rows); n-tile
// nt, column n <-> output feature kFH (n / 2) + 2nt + n % 2, so that the C
// column 2t + h is output feature kFH t + 2nt + h: the thread gets epart at
// the features kFH t .. that the mid layer's A (far_a's order) wants.
__device__ __forceinline__ uint4 near_w1e_frag(const float* __restrict__ w1e,
                                               int ks, int nt, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int o = kFH * (g >> 1) + 2 * nt + (g & 1);
  return split_b(w1e[(kFE * t + 2 * ks) * kHp + o],
                 w1e[(kFE * t + 2 * ks + 1) * kHp + o]);
}

// W1e's and W2's split B fragments into shared memory, once per block of
// kNearThreads (every load in flight at once); b2 of the thread's C
// columns into bias
__device__ __forceinline__ void near_stage(NearSmem& s,
                                           const float* __restrict__ w1e,
                                           const float* __restrict__ w2,
                                           const float* __restrict__ b2,
                                           float (&bias)[kNT][2]) {
  constexpr int n1 = kKE * kNT * 32, n2 = kNT * kNT * 32;
  if constexpr (n1 % kNearThreads == 0) {
#pragma unroll
    for (int i = 0; i < n1 / kNearThreads; ++i) {
      const int e = threadIdx.x + i * kNearThreads;
      s.b1[e >> 5][e & 31] =
          near_w1e_frag(w1e, (e >> 5) / kNT, (e >> 5) % kNT, e & 31);
    }
  } else {
    for (int e = threadIdx.x; e < n1; e += kNearThreads)
      s.b1[e >> 5][e & 31] =
          near_w1e_frag(w1e, (e >> 5) / kNT, (e >> 5) % kNT, e & 31);
  }
  if constexpr (n2 % kNearThreads == 0) {
#pragma unroll
    for (int i = 0; i < n2 / kNearThreads; ++i) {
      const int e = threadIdx.x + i * kNearThreads;
      s.b2[e >> 5][e & 31] =
          w2_frag(w2, (e >> 5) / kNT, (e >> 5) % kNT, e & 31);
    }
  } else {
    for (int e = threadIdx.x; e < n2; e += kNearThreads)
      s.b2[e >> 5][e & 31] =
          w2_frag(w2, (e >> 5) / kNT, (e >> 5) % kNT, e & 31);
  }
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    bias[nt][0] = b2[8 * nt + 2 * t];
    bias[nt][1] = b2[8 * nt + 2 * t + 1];
  }
}

// epart = rbf @ W1e for a tile, at the library's tier: A from the thread's features
// kFE t .. kFE t + kFE - 1 of entries g (ra) and g + 8 (rb).  Chains of at
// most 4 k-steps (at E = 48: two of 3), added in fp32.  ep in the C layout
// with near_w1e_frag's columns: entry g's feature kFH t + m is
// ep[m / 2][m % 2], entry g + 8's ep[m / 2][2 + m % 2].
__device__ __forceinline__ void near_epart(const float (&ra)[kFE],
                                           const float (&rb)[kFE],
                                           const uint4 (*b1)[32], int lane,
                                           float (&ep)[kNT][4]) {
  constexpr int kC = chains(kKE);
  float c[kC][kNT][4];
#pragma unroll
  for (int h = 0; h < kC; ++h)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) c[h][nt][r] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < kKE; ++ks) {
    uint32_t ah[4], al[4];
    tf32_split(ra[2 * ks], ah[0], al[0]);
    tf32_split(rb[2 * ks], ah[1], al[1]);
    tf32_split(ra[2 * ks + 1], ah[2], al[2]);
    tf32_split(rb[2 * ks + 1], ah[3], al[3]);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
      mma_tier(c[chain_of(ks, kKE)][nt], ah, al, b1[ks * kNT + nt][lane]);
  }
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float v = c[0][nt][r];
#pragma unroll
      for (int h = 1; h < kC; ++h) v += c[h][nt][r];
      ep[nt][r] = v;
    }
}

// entry g's (a) and g + 8's (b) epart at the thread's features kFH t ..
__device__ __forceinline__ void near_ep_rows(const float (&ep)[kNT][4],
                                             float (&ea)[kFH],
                                             float (&eb)[kFH]) {
#pragma unroll
  for (int m = 0; m < kFH; ++m) {
    ea[m] = ep[m >> 1][m & 1];
    eb[m] = ep[m >> 1][2 + (m & 1)];
  }
}

// y = b2 + z @ W2 for a tile, at the library's tier: A = z (already through relu) at
// the thread's features kFH t .. of entries g (za) and g + 8 (zb), in
// far_a's order; y in the C layout (y[nt]: outputs 8nt + 2t + {0, 1} of
// entry g, then of g + 8).  Chains of at most 4 k-steps (at H = 32 one of
// 12 products, from b2), added in fp32.
__device__ __forceinline__ void near_mid(const float (&za)[kFH],
                                         const float (&zb)[kFH],
                                         const float (&bias)[kNT][2],
                                         const uint4 (*b2)[32], int lane,
                                         float (&y)[kNT][4]) {
  constexpr int kC = chains(kNT);
  float c[kC][kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    c[0][nt][0] = c[0][nt][2] = bias[nt][0];
    c[0][nt][1] = c[0][nt][3] = bias[nt][1];
#pragma unroll
    for (int h = 1; h < kC; ++h)
#pragma unroll
      for (int r = 0; r < 4; ++r) c[h][nt][r] = 0.0f;
  }
#pragma unroll
  for (int ks = 0; ks < kNT; ++ks) {
    uint32_t ah[4], al[4];
    tf32_split(za[2 * ks], ah[0], al[0]);
    tf32_split(zb[2 * ks], ah[1], al[1]);
    tf32_split(za[2 * ks + 1], ah[2], al[2]);
    tf32_split(zb[2 * ks + 1], ah[3], al[3]);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
      mma_tier(c[chain_of(ks, kNT)][nt], ah, al, b2[ks * kNT + nt][lane]);
  }
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float v = c[0][nt][r];
#pragma unroll
      for (int h = 1; h < kC; ++h) v += c[h][nt][r];
      y[nt][r] = v;
    }
}

// a tile's weighted terms into the warp's term tile d: entry g's (a) and
// g + 8's (b) outputs 8nt + 2t + {0, 1}, term(w, y) of the two C values
template <class Term>
__device__ __forceinline__ void near_put(float (*d)[kNearDStride],
                                         Term&& term) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int o = 8 * nt + 2 * t;
    *reinterpret_cast<float2*>(&d[g][o]) =
        make_float2(term(nt, 0), term(nt, 1));
    *reinterpret_cast<float2*>(&d[g + 8][o]) =
        make_float2(term(nt, 2), term(nt, 3));
  }
  __syncwarp();
}

// The rows [r0, r1) of global warp gw of n_warps (N rows split evenly).
__device__ __forceinline__ void near_range(int N, int gw, int n_warps,
                                           int& r0, int& r1) {
  r0 = (int)((long long)N * gw / n_warps);
  r1 = (int)((long long)N * (gw + 1) / n_warps);
}

// A warp's ordered row sums over its tiles: lane o owns output columns o,
// o + 32, ... (< kH) of the current row and writes each finished row of
// out (N, kH) once.
struct NearRowSums {
  int cur;
  float acc[kNearOut];

  __device__ __forceinline__ explicit NearRowSums(int r0) : cur(r0) {
#pragma unroll
    for (int q = 0; q < kNearOut; ++q) acc[q] = 0.0f;
  }
  __device__ __forceinline__ void flush(float* __restrict__ out, int lane) {
#pragma unroll
    for (int q = 0; q < kNearOut; ++q) {
      if (kH % 32 == 0 || lane + 32 * q < kH)
        out[(size_t)cur * kH + lane + 32 * q] = acc[q];
      acc[q] = 0.0f;
    }
    ++cur;
  }
  // entries 0 .. n - 1 of the term tile d, of rows rows[(head + e) &
  // ring_mask]
  __device__ __forceinline__ void add(const float (*d)[kNearDStride],
                                      const int* rows, int ring_mask,
                                      int head, int n,
                                      float* __restrict__ out, int lane) {
    for (int e = 0; e < n; ++e) {
      const int row = rows[(head + e) & ring_mask];
      while (cur < row) flush(out, lane);
#pragma unroll
      for (int q = 0; q < kNearOut; ++q)
        if (kH % 32 == 0 || lane + 32 * q < kH) acc[q] += d[e][lane + 32 * q];
    }
  }
  __device__ __forceinline__ void finish(int r1, float* __restrict__ out,
                                         int lane) {
    while (cur < r1) flush(out, lane);
  }
};

// The warp's walk over rows [r0, r1): live slots (flat index and row)
// into the ring, tile(h0, n) for every 16 (n < 16 only for the last), each
// tile's terms (d, written by tile) into lane o's row sums and out
// (N, kH).  The next 32 weights are loaded while a tile runs.
template <class Tile>
__device__ __forceinline__ void near_walk(NearSmem& s, int warp, int lane,
                                          const float* __restrict__ wgt,
                                          int K, int r0, int r1,
                                          float* __restrict__ out,
                                          Tile&& tile) {
  int* ring = s.ring[warp];
  int* rows = s.rows[warp];
  int head = 0, tail = 0;
  NearRowSums sums(r0);
  auto run = [&](int n) {
    tile(head, n);  // ends with the terms in d, after a __syncwarp
    sums.add(s.d[warp], rows, kNearRing - 1, head, n, out, lane);
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
  sums.finish(r1, out, lane);
}

// The fused dense kernels' walk over the N x N pair grid.  The block's
// warps each own rows [r0, r1) (empty for a warp past the grid's warps)
// and take them in step: for the rr-th row of every warp, the block stages
// the columns kScanCols at a time — x, y, z and the mask of each, by
// cp.async into a double-buffered ring in shared memory, so the next
// columns load while these are scanned, and each column is read from L2
// once for the block's four rows — and each warp tests its row against
// them 32 at a time — (i, j) is live if i != j, both atoms are valid and d^2
// is under cut2 (the cutoff squared rounded up: a superset of the pairs
// whose envelope is not 0) — and appends live pairs to its ring (column
// j, row i) of kPairRing entries.  The scan runs in segments:
// one ends, for the whole block, only when some warp's ring could not take
// another stage's live pairs; then (and after the last) the tiles run, as
// near_walk's, the warps independent.  No tile code sits inside the scan
// loop: inlined there it slowed the scan ~2x (tools/fused_pace.py,
// no_inloop_run).  Every warp of the block calls it (it holds block-wide
// barriers).
constexpr int kScanCols = 256;
constexpr int kPairRing = 512;  // live pairs a warp holds (power of 2)
static_assert(kPairRing >= 2 * kScanCols, "a segment ends with room left");

struct ScanSmem {
  float4 col[2][kScanCols];  // x, y, z, mask of the staged columns
  int ring[kNearWarps][kPairRing];  // columns of the live pairs
  int rows[kNearWarps][kPairRing];  // and their rows
};

template <class Tile>
__device__ __forceinline__ void pair_walk(NearSmem& s, ScanSmem& sc,
                                          int warp, int lane,
                                          const float* __restrict__ xyz,
                                          const float* __restrict__ mask,
                                          float cut2, int N, int n_warps,
                                          int r0, int r1,
                                          float* __restrict__ out,
                                          Tile&& tile) {
  int* ring = sc.ring[warp];
  int* rows = sc.rows[warp];
  int head = 0, tail = 0;
  NearRowSums sums(r0);
  auto run = [&](int n) {
    tile(head, n);
    sums.add(s.d[warp], rows, kPairRing - 1, head, n, out, lane);
    head += n;
    __syncwarp();
  };
  // stage st of the columns into ring slot b
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
  const int steps = (N + n_warps - 1) / n_warps;  // rows a warp, at most
  const int stages = (N + kScanCols - 1) / kScanCols;
  const int total = steps * stages;
  stage(0, 0);
  int it = 0;
  bool more = true;
  while (more) {
    more = false;
    for (; it < total; ++it) {  // a segment of the scan
      if (it + 1 < total) {
        stage((it + 1) % stages, (it + 1) & 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // stage it landed
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
      // slot it % 2 is free for stage it + 2; the segment ends when a ring
      // could not take the next stage's live pairs
      if (__syncthreads_or(tail - head > kPairRing - kScanCols)) {
        ++it;
        more = it < total;
        break;
      }
    }
    __syncwarp();
    while (tail - head >= 16) run(16);
  }
  if (tail > head) run(tail - head);
  sums.finish(r1, out, lane);
}

// The warps a near kernel's launch runs: a few resident blocks an SM (its
// occupancy with smem bytes of dynamic shared memory), at most one warp a
// kNearMinRows rows.  resident caches the warps a card holds at once, per
// device (0: not yet asked); each library is one width, so the cache is per
// width too.
constexpr int kNearMaxDevices = 64;

template <class Kernel>
cudaError_t near_warps(Kernel kernel, int (&resident)[kNearMaxDevices], int N,
                       int smem, int& n_warps) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kNearMaxDevices) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kNearThreads, smem);
    if (err != cudaSuccess) return err;
    resident[dev] = (per_sm > 0 ? per_sm : 1) * sms * kNearWarps;
  }
  const int by_rows = (N + kNearMinRows - 1) / kNearMinRows;
  n_warps = by_rows < resident[dev] ? by_rows : resident[dev];
  return cudaSuccess;
}

}  // namespace epnn
