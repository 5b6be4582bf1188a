// dense_message_rowsum_int8 — the far-field message reduction of the
// neighbor-split forward in the int8 serving tier:
//
//   q_ij  = trunc(clip(relu(pi_i + pj_j) * inv, 0, 127) + 0.5)   (int8)
//   out_i = sum_j cv_j * relu(float(q_ij @ w2q) * dq + b2)        (R, H)
//
// pi already carries the first-layer bias; cv_j is the column weight.
// W2q (W2 quantized per output column to [-127, 127]) and its column scales
// sw come from kernels.int8_weights, made once per set of weights.  The
// kernel forms the rest of the quantization in its prologue, as JAX does
// outside its kernel: s_in = max(relu(pi_max + pj_max), 1e-30) / 127 from
// the two maxima the wrapper reduces (and, with pad_pi, from the padding
// rows JAX's operands carry: pi = *pad_pi, pj = 0), inv = 1 / s_in for the
// activations (one scale for the whole tensor), dq = s_in * sw.
//
// Replaces the int8 body of the TPU kernel epnn_tpu/ops/pallas_kernels.py:
// _msg_kernel (:59-75), whose quantization is set up in
// _dense_message_rowsum_impl (:1023-1033) and which the fp32 body's
// counterpart dense_message_rowsum.cu does not cover.
//
// Numerics: the same steps as JAX, in the same order, in float32 — the
// scales by IEEE-rounded adds, divisions and multiplies (__fdiv_rn,
// __fmul_rn); relu(pi + pj), times inv, clipped, + 0.5 rounded to nearest,
// truncated (__fmul_rn / __fadd_rn: no step is contracted into an FMA).  The
// integer product is exact (|q|, |w2q| <= 127, a row of at most 64 products
// <= 1,032,256 < 2^22), so z2 = float(acc) * dq + b2, multiply then add as
// in JAX, has JAX's bits; only the float32 order of the sum over j differs.
//
// Bound on the H100: the CUDA cores.  A pair needs 2H^2 = 2,048 integer
// operations on the tensor cores (1,979 TOPS dense int8: 1.0e-12 s a pair),
// but each of its H = 32 activations takes ~7 instructions to quantize and
// pack, and each of its 32 outputs ~5 to dequantize and add: ~376
// instructions a pair at one a lane a clock (132 SMs x 128 lanes, ~33.5e12
// a second at 1,980 MHz), 1.1e-11 s — ten times the products' time.
// Conversions would cost 8x that (16 a clock an SM), so the kernel has
// none: the float -> int rounding adds 2^23 rounding down and reads the low
// byte of the sum's bits; the int -> float conversion starts the integer
// accumulator at the bits of 2^23 + 2^22 and subtracts that float.
//
// Design: 64 rows a block, 16 a warp, the columns walked in chunks of 32
// staged with cp.async into a double-buffered ring, as in
// dense_message_rowsum.cu; the column range splits into parts added in
// order by epnn::sum_parts (deterministic, no atomics); columns past N
// enter as pj = 0, cv = 0 and add exactly zero.  Per column j a warp runs
// mma.sync m16n8k32 s8 x s8 -> s32: K = H = 32 is one k-step, H = 32
// output columns four n-tiles.  The A fragment, the quantized relu(pi_i +
// pj_j) of the warp's 16 rows, is built and packed in registers from the 16
// pi values a thread keeps and 8 pj values broadcast from shared memory;
// W2q's B fragments (1 KB of int8) are loaded into registers once.  The
// int32 C fragment is dequantized, biased, relu'd, weighted by cv_j and
// folded into the thread's 16 float32 row sums.  wgmma with s8 operands,
// TMA and overlapping the quantization with the products are left for a
// redesign.
//
// Widths (common.cuh): up to 64 (padded) here.  The contraction runs at H
// padded to 32 (kHq: m16n8k32's K), the outputs at H padded to 8 (kHp):
// W2q comes as (kHq, kHp) int8 and sw, b2 as (kHp,), zero-padded, pi and pj
// are read at their real width with zeros past it (relu(0) quantizes to 0).
// The maxima behind s_in are the wrapper's, over the real columns only, as
// JAX takes them: a zero padding column would raise a negative maximum to
// 0.  A padded W2 column has sw = 1e-30 / 127 from the clamp, w2q 0 and b2
// 0, so its z2 is 0 (and it is not written).
//
// Widths past 64 (padded): the output columns in chunks of 32, one a block
// (blockIdx.z); a block reads pi, pj and W2q where it needs them (no staged
// columns, no fragments kept in registers), so nothing grows with H.  The
// accumulator starts at 0 and is converted by __int2float_rn: past H = 260
// a row's sum may leave the 2^22 the bias trick needs; the conversion is
// exact up to 2^24 and rounds to nearest past it, as JAX's astype does.
#include "common.cuh"

namespace {

using epnn::kH;
using epnn::kHp;
using epnn::kNT;
constexpr int kHq = (kH + 31) / 32 * 32;  // the contraction, padded to 32
constexpr int kKQ = kHq / 32;             // its k-steps of m16n8k32
constexpr int kThreads = 128;      // 4 warps
constexpr int kRowsPerBlock = 64;  // 16 a warp
// bits of 2^23 + 2^22 = 12,582,912.0f: any int32 |a| < 2^22 added to them
// gives the bits of 12,582,912 + a
constexpr int kBiasBits = 0x4B400000;
constexpr float kBias = 12582912.0f;

// q = trunc(clip(relu(x) * inv, 0, 127) + 0.5) as an integer 0 .. 127 in
// the low byte (the rest of the word is the exponent of 2^23): t + 2^23
// rounded down is 2^23 + floor(t), exact for 0 <= t < 2^23, and floor =
// trunc for t >= 0.  relu first, so the clip's lower bound holds already.
__device__ __forceinline__ uint32_t quant(float x, float inv) {
  const float y = fminf(__fmul_rn(epnn::relu(x), inv), 127.0f);
  return __float_as_uint(__fadd_rd(__fadd_rn(y, 0.5f), 8388608.0f));
}

// four quantized values, low bytes of a .. d, into one register (a lowest)
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// d += a b, m16n8k32, s8 x s8 -> s32.  Fragments (g = lane / 4, t = lane %
// 4): a0 row g, k 4t .. 4t + 3 (byte 0 first); a1 row g + 8, same k; a2 row
// g, k 16 + 4t ..; a3 row g + 8, k 16 + 4t ..; b0 k 4t .. 4t + 3, n g; b1 k
// 16 + 4t .., n g; d0, d1 (g, 2t + {0, 1}), d2, d3 (g + 8, 2t + {0, 1}).
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

#if EPNN_WIDE

constexpr int kNC = 32;  // output columns a block
constexpr int kOutChunks = (kHp + kNC - 1) / kNC;

__global__ void __launch_bounds__(kThreads)
dmr_int8_partial(const float* __restrict__ pi, const float* __restrict__ pj,
                 const float* __restrict__ cv,
                 const int8_t* __restrict__ w2q, const float* __restrict__ sw,
                 const float* __restrict__ b2,
                 const float* __restrict__ pi_max,
                 const float* __restrict__ pj_max,
                 const float* __restrict__ pad_pi,
                 float* __restrict__ part, int R, int N,
                 int cols_per_split) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5) * 16;
  const int j0 = blockIdx.y * cols_per_split;
  const int j1 = min(N, j0 + cols_per_split);
  const int n0 = kNC * blockIdx.z;
  const bool va = r0 + g < R, vb = r0 + g + 8 < R;
  const float* pa = pi + (size_t)(va ? r0 + g : 0) * kH;
  const float* pb = pi + (size_t)(vb ? r0 + g + 8 : 0) * kH;

  float pim = *pi_max, pjm = *pj_max;
  if (pad_pi != nullptr) {
    pim = fmaxf(pim, *pad_pi);
    pjm = fmaxf(pjm, 0.0f);
  }
  const float s_in =
      __fdiv_rn(fmaxf(epnn::relu(__fadd_rn(pim, pjm)), 1e-30f), 127.0f);
  const float inv = __fdiv_rn(1.0f, s_in);
  float sc[4][2], bias[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int o = n0 + 8 * nt + 2 * t + u;
      sc[nt][u] = o < kHp ? __fmul_rn(s_in, sw[o]) : 0.0f;
      bias[nt][u] = o < kHp ? b2[o] : 0.0f;
    }
  // W2q's B fragment of n-tile nt, k-step kq, half h (as the narrow path's)
  auto bq = [&](int nt, int kq, int h) {
    const int n = n0 + 8 * nt + g;
    uint32_t v = 0;
    if (n < kHp)
#pragma unroll
      for (int m = 0; m < 4; ++m)
        v |= (uint32_t)(uint8_t)w2q[(size_t)(32 * kq + 8 * t + 4 * h + m) *
                                        kHp + n]
             << (8 * m);
    return v;
  };

  float acc[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nt][r] = 0.0f;

  for (int j = j0; j < j1; ++j) {
    const float* ps = pj + (size_t)j * kH;
    int d[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) d[nt][r] = 0;
#pragma unroll 1
    for (int kq = 0; kq < kKQ; ++kq) {
      uint32_t qa[8], qb[8];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int f = 32 * kq + 8 * t + m;
        const bool in = kH == kHq || f < kH;
        const float s = in ? ps[f] : 0.0f;
        qa[m] = quant((in && va ? pa[f] : 0.0f) + s, inv);
        qb[m] = quant((in && vb ? pb[f] : 0.0f) + s, inv);
      }
      const uint32_t a[4] = {pack4(qa[0], qa[1], qa[2], qa[3]),
                             pack4(qb[0], qb[1], qb[2], qb[3]),
                             pack4(qa[4], qa[5], qa[6], qa[7]),
                             pack4(qb[4], qb[5], qb[6], qb[7])};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        mma_s8(d[nt], a, bq(nt, kq, 0), bq(nt, kq, 1));
    }
    const float cj = cv[j];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float z = epnn::relu(__fadd_rn(
            __fmul_rn(__int2float_rn(d[nt][r]), sc[nt][r & 1]),
            bias[nt][r & 1]));
        acc[nt][r] = fmaf(cj, z, acc[nt][r]);
      }
  }

  float* dst = part + (size_t)blockIdx.y * R * kH;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + g + 8 * half;
    if (row >= R) continue;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int o = n0 + 8 * nt + 2 * t + u;
        if (o < kH) dst[(size_t)row * kH + o] = acc[nt][2 * half + u];
      }
  }
}

#else

constexpr int kOutChunks = 1;
constexpr int kChunk = 32;         // columns per staged chunk

// The contraction index is permuted so that thread t holds features 32kq +
// 8t .. 32kq + 8t + 7 of every row in k-step kq (as far_a does): k 4t + m
// is feature 32kq + 8t + m and k 16 + 4t + m feature 32kq + 8t + 4 + m (m
// < 4), in A and in B alike.
__global__ void __launch_bounds__(kThreads, 4)
dmr_int8_partial(const float* __restrict__ pi, const float* __restrict__ pj,
                 const float* __restrict__ cv,
                 const int8_t* __restrict__ w2q, const float* __restrict__ sw,
                 const float* __restrict__ b2,
                 const float* __restrict__ pi_max,
                 const float* __restrict__ pj_max,
                 const float* __restrict__ pad_pi,
                 float* __restrict__ part, int R, int N,
                 int cols_per_split) {
  __shared__ __align__(16) float s_pj[2][kChunk][kHq];
  __shared__ float s_cv[2][kChunk];

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5) * 16;
  const int j0 = blockIdx.y * cols_per_split;
  const int j1 = min(N, j0 + cols_per_split);
  const int chunks = (j1 - j0 + kChunk - 1) / kChunk;

  // chunk c's columns into ring slot c % 2; past j1 and past H: zeros
  auto stage = [&](int c) {
    const int jt = j0 + c * kChunk;
    float* dst = &s_pj[c & 1][0][0];
    for (int e = threadIdx.x; e < kChunk * kHq; e += kThreads) {
      const int r = e / kHq, col = e % kHq;
      const bool in = jt + r < j1 && (kH == kHq || col < kH);
      epnn::cp_async4(dst + e, pj + (in ? (size_t)(jt + r) * kH + col : 0),
                      in);
    }
    for (int e = threadIdx.x; e < kChunk; e += kThreads) {
      const bool in = jt + e < j1;
      epnn::cp_async4(&s_cv[c & 1][e], cv + (in ? jt + e : 0), in);
    }
    epnn::cp_async_commit();
  };
  stage(0);

  // W2q's B fragments, n-tile nt, k-step kq: output column 8nt + g,
  // features 32kq + 8t .. + 3 (b0) and 32kq + 8t + 4 .. + 7 (b1)
  uint32_t bf[kNT][kKQ][2];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int kq = 0; kq < kKQ; ++kq)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t v = 0;
#pragma unroll
        for (int m = 0; m < 4; ++m)
          v |= (uint32_t)(uint8_t)w2q[(32 * kq + 8 * t + 4 * h + m) * kHp +
                                      8 * nt + g]
               << (8 * m);
        bf[nt][kq][h] = v;
      }
  // the activation scale (kernels.int8_activation_scale): the maxima, with
  // the padding rows' where there are some
  float pim = *pi_max, pjm = *pj_max;
  if (pad_pi != nullptr) {
    pim = fmaxf(pim, *pad_pi);
    pjm = fmaxf(pjm, 0.0f);
  }
  const float s_in =
      __fdiv_rn(fmaxf(epnn::relu(__fadd_rn(pim, pjm)), 1e-30f), 127.0f);
  const float inv = __fdiv_rn(1.0f, s_in);
  // dequantization scale and bias of the thread's C columns 8nt + 2t + {0,1}
  float sc[kNT][2], bias[kNT][2];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      sc[nt][u] = __fmul_rn(s_in, sw[8 * nt + 2 * t + u]);
      bias[nt][u] = b2[8 * nt + 2 * t + u];
    }
  // the thread's features 32kq + 8t + m of own rows g (xa), g + 8 (xb)
  float xa[8 * kKQ], xb[8 * kKQ];
#pragma unroll
  for (int kq = 0; kq < kKQ; ++kq)
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int f = 32 * kq + 8 * t + m;
      const bool in = kH == kHq || f < kH;
      xa[8 * kq + m] =
          in && r0 + g < R ? pi[(size_t)(r0 + g) * kH + f] : 0.0f;
      xb[8 * kq + m] =
          in && r0 + g + 8 < R ? pi[(size_t)(r0 + g + 8) * kH + f] : 0.0f;
    }

  float acc[kNT][4];
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nt][r] = 0.0f;

  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      stage(c + 1);
      epnn::cp_async_wait<1>();
    } else {
      epnn::cp_async_wait<0>();
    }
    __syncthreads();  // chunk c landed
    const float* sp = &s_pj[c & 1][0][0];
    const float* scv = &s_cv[c & 1][0];
#pragma unroll 2
    for (int j = 0; j < kChunk; ++j) {
      uint32_t a[kKQ][4];
#pragma unroll
      for (int kq = 0; kq < kKQ; ++kq) {
        const float* x = sp + j * kHq + 32 * kq + 8 * t;
        const float4 p0 = *reinterpret_cast<const float4*>(x);
        const float4 p1 = *reinterpret_cast<const float4*>(x + 4);
        const int q = 8 * kq;
        a[kq][0] = pack4(quant(xa[q] + p0.x, inv), quant(xa[q + 1] + p0.y, inv),
                         quant(xa[q + 2] + p0.z, inv),
                         quant(xa[q + 3] + p0.w, inv));
        a[kq][1] = pack4(quant(xb[q] + p0.x, inv), quant(xb[q + 1] + p0.y, inv),
                         quant(xb[q + 2] + p0.z, inv),
                         quant(xb[q + 3] + p0.w, inv));
        a[kq][2] = pack4(quant(xa[q + 4] + p1.x, inv),
                         quant(xa[q + 5] + p1.y, inv),
                         quant(xa[q + 6] + p1.z, inv),
                         quant(xa[q + 7] + p1.w, inv));
        a[kq][3] = pack4(quant(xb[q + 4] + p1.x, inv),
                         quant(xb[q + 5] + p1.y, inv),
                         quant(xb[q + 6] + p1.z, inv),
                         quant(xb[q + 7] + p1.w, inv));
      }
      const float cj = scv[j];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        int d[4] = {kBiasBits, kBiasBits, kBiasBits, kBiasBits};
#pragma unroll
        for (int kq = 0; kq < kKQ; ++kq)
          mma_s8(d, a[kq], bf[nt][kq][0], bf[nt][kq][1]);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float v = __fsub_rn(__int_as_float(d[r]), kBias);  // exact
          const float z = epnn::relu(
              __fadd_rn(__fmul_rn(v, sc[nt][r & 1]), bias[nt][r & 1]));
          acc[nt][r] = fmaf(cj, z, acc[nt][r]);
        }
      }
    }
    __syncthreads();  // slot c % 2 is free for chunk c + 2
  }

  float* dst = part + (size_t)blockIdx.y * R * kH;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + g + 8 * half;
    if (row < R) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int o = 8 * nt + 2 * t;
        const float v0 = acc[nt][2 * half], v1 = acc[nt][2 * half + 1];
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

#endif  // EPNN_WIDE

}  // namespace

// w2q: (Hq, Hp) int8 (Hq = H padded to 32, Hp to 8); sw, b2: (Hp,); pi_max,
// pj_max: one float each (max(pi), max(pj) over the real columns); pad_pi:
// one float (the padding rows' pi) or null (no padding rows); part:
// (splits, R, H) scratch; out: (R, H); the column range splits into parts
// of cols_per_split.  Returns cudaGetLastError().
extern "C" int epnn_dense_message_rowsum_int8(
    const float* pi, const float* pj, const float* cv, const int8_t* w2q,
    const float* sw, const float* b2, const float* pi_max,
    const float* pj_max, const float* pad_pi, float* part, float* out, int R,
    int N, int H, int splits, int cols_per_split, cudaStream_t stream) {
  if (H != kH || R <= 0 || N <= 0 || splits <= 0 || cols_per_split <= 0 ||
      (long long)(splits - 1) * cols_per_split >= N)
    return cudaErrorInvalidValue;
  const dim3 grid((R + kRowsPerBlock - 1) / kRowsPerBlock, splits,
                  kOutChunks);
  dmr_int8_partial<<<grid, kThreads, 0, stream>>>(
      pi, pj, cv, w2q, sw, b2, pi_max, pj_max, pad_pi, part, R, N,
      cols_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rh = R * H;
  epnn::sum_parts<<<(rh + 255) / 256, 256, 0, stream>>>(part, out, rh,
                                                        splits);
  return cudaGetLastError();
}
