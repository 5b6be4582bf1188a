// near_message_corr — the gathered near-field correction of one message
// round of the neighbor-split forward:
//
//   out_i = sum_s mask_is * [mlp(pi_i + pjn_is + rbf_is @ W1e)
//                            - mlp(pi_i + pjn_is)]              (N, H)
//   mlp(z) = relu(relu(z) @ W2 + b2)
//
// over the K neighbor slots s of row i; pjn and rbf are pre-gathered flat
// (N*K, .) arrays, as in the JAX function.
//
// Replaces the TPU kernel epnn_tpu/ops/pallas_kernels.py:
// near_message_corr (:1286) -> _near_msg_impl (:1228), whose pallas_call
// (:1245) runs _near_msg_kernel (:1189).
//
// Tiers: the JAX kernel's precision argument is the library's TF32 tier
// (EPNN_TF32_PASSES, common.cuh), both built from this source: 3xTF32
// for "high" and "highest", one TF32 product a k-step for "default",
// a third of the products; the kernel stays bound by bytes.
//
// Bound on the H100: bytes.  Only live slots (mask != 0) are read: each
// reads (H + E) floats (320 B) and needs rbf @ W1e and two H x H products,
// 2EH + 4H^2 = 7.2 kFLOP, three tensor-core products each in 3xTF32
// (21.5 kFLOP at 495 TFLOP/s), plus ~8H elementwise FLOP.  The 17,760-atom
// water box at K = 24 has about 136k live slots of N*K = 426k: ~45 MB
// (13 us at 3.35 TB/s) against 2.9 GFLOP of TF32 products (5.9 us).
//
// Design (common.cuh, "the near kernels"): a persistent grid — a few
// blocks an SM, each warp a contiguous range of rows — with W1e's and W2's
// split B fragments staged in shared memory once per block.  The warp
// compacts its live slots with a ballot prefix count and runs them 16 at a
// time as the M rows of mma.sync m16n8k8 in 3xTF32: epart = rbf @ W1e (A
// from the gathered rbf rows, two chains of 9 products), then the two mid
// layers relu(base + epart) @ W2 and relu(base) @ W2, whose A fragments are
// epart's C fragment plus the gathered base (one chain of 12 each).  The
// tile's terms go through shared memory and lane o adds column o over the
// slots in ascending order: deterministic, no atomics.  No lane or MMA row
// works on a dead slot, but for the tail of a warp's last tile.
//
// Widths (common.cuh): up to 64 (padded); W1e (Ep, Hp), W2 and b2
// come zero-padded, the activations are read at their real width (pjn and
// rbf as float4s where that width is a multiple of 16).  The staged
// fragments grow with the widths (20 KB at 32/48, 83 KB at 64/64), so
// shared memory is dynamic.
//
// Widths past 64 (padded H or E): the wide tiles of wide.cuh (the same
// rings and walk; per output chunk of 32 columns each mid-layer k-step
// rebuilds epart's n-tile from the rbf rows; no staged fragments).
#include "common.cuh"

#if EPNN_WIDE
#include "wide.cuh"

namespace {

using epnn::kE;
using epnn::kH;
namespace wide = epnn::wide;

__global__ void __launch_bounds__(epnn::kNearThreads, 3)
nmc_kernel(const float* __restrict__ pi, const float* __restrict__ pjn,
           const float* __restrict__ rbf, const float* __restrict__ wgt,
           const float* __restrict__ w1e, const float* __restrict__ w2,
           const float* __restrict__ b2, float* __restrict__ out,
           float* work, int N, int K, int n_warps) {
  extern __shared__ uint4 smem_raw[];
  wide::NearSmem& s = *reinterpret_cast<wide::NearSmem*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gw = blockIdx.x * epnn::kNearWarps + warp;
  if (gw >= n_warps) return;  // no block-wide barrier follows
  const int g = lane >> 2;
  int r0, r1;
  epnn::near_range(N, gw, n_warps, r0, r1);

  auto tile = [&](int h0, int n) {
    const int* ring = s.ring[warp];
    const int* rows = s.rows[warp];
    const int ia = (h0 + g) & (epnn::kNearRing - 1);
    const int ib = (h0 + g + 8) & (epnn::kNearRing - 1);
    const bool v[2] = {g < n, g + 8 < n};
    const int fa = v[0] ? ring[ia] : 0, fb = v[1] ? ring[ib] : 0;
    const int rwa = v[0] ? rows[ia] : 0, rwb = v[1] ? rows[ib] : 0;
    const float* rb[2] = {rbf + (size_t)fa * kE, rbf + (size_t)fb * kE};
    const float* xs[2] = {pjn + (size_t)fa * kH, pjn + (size_t)fb * kH};
    const float* ps[2] = {pi + (size_t)rwa * kH, pi + (size_t)rwb * kH};
    const float w[2] = {v[0] ? wgt[fa] : 0.0f, v[1] ? wgt[fb] : 0.0f};
    wide::tile(
        w1e, w2, b2, lane,
        [&](int e, int c) { return wide::at(rb[e], c, kE, v[e]); },
        [&](int e, int f, float ep, float& zf, float& zn) {
          const float base = __fadd_rn(wide::at(ps[e], f, kH, v[e]),
                                       wide::at(xs[e], f, kH, v[e]));
          zf = epnn::relu(__fadd_rn(base, ep));
          zn = epnn::relu(base);
        },
        [&](int e, float yf, float yn) {
          return __fmul_rn(__fsub_rn(epnn::relu(yf), epnn::relu(yn)), w[e]);
        },
        work + (size_t)gw * wide::kScratch, s.d[warp], rows,
        epnn::kNearRing - 1, h0, n, out);
  };
  wide::near_walk(s, warp, lane, wgt, K, r0, r1, out, tile);
}

int g_resident[epnn::kNearMaxDevices] = {};  // epnn::near_warps's cache
constexpr int kSmem = (int)sizeof(wide::NearSmem);

}  // namespace

#else

namespace {

using epnn::kE;
using epnn::kFE;
using epnn::kFH;
using epnn::kH;
using epnn::kNT;
// resident blocks an SM the registers are budgeted for: four (128
// registers a thread) beat three (tools/near_field_pace.py)
constexpr int kMinBlocks = 4;

__global__ void __launch_bounds__(epnn::kNearThreads, kMinBlocks)
nmc_kernel(const float* __restrict__ pi, const float* __restrict__ pjn,
           const float* __restrict__ rbf, const float* __restrict__ wgt,
           const float* __restrict__ w1e, const float* __restrict__ w2,
           const float* __restrict__ b2, float* __restrict__ out,
           float* /* work: the wide path's */, int N, int K, int n_warps) {
  extern __shared__ uint4 smem_raw[];
  epnn::NearSmem& s = *reinterpret_cast<epnn::NearSmem*>(smem_raw);
  float bias[kNT][2];
  epnn::near_stage(s, w1e, w2, b2, bias);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gw = blockIdx.x * epnn::kNearWarps + warp;
  if (gw >= n_warps) return;  // no block-wide barrier follows
  const int g = lane >> 2, t = lane & 3;
  int r0, r1;
  epnn::near_range(N, gw, n_warps, r0, r1);

  // one tile: entries g (a) and g + 8 (b) of the ring from h0, n of them
  auto tile = [&](int h0, int n) {
    const int* ring = s.ring[warp];
    const int* rows = s.rows[warp];
    const int ia = (h0 + g) & (epnn::kNearRing - 1);
    const int ib = (h0 + g + 8) & (epnn::kNearRing - 1);
    const bool va = g < n, vb = g + 8 < n;
    const int fa = va ? ring[ia] : 0, fb = vb ? ring[ib] : 0;
    const int rwa = va ? rows[ia] : 0, rwb = vb ? rows[ib] : 0;
    float ra[kFE], rb[kFE], xa[kFH], xb[kFH], pa[kFH], pb[kFH];
    epnn::load_vec<kFE, kE>(rbf + (size_t)fa * kE, t, va, ra);
    epnn::load_vec<kFE, kE>(rbf + (size_t)fb * kE, t, vb, rb);
    epnn::load_vec<kFH, kH>(pjn + (size_t)fa * kH, t, va, xa);
    epnn::load_vec<kFH, kH>(pjn + (size_t)fb * kH, t, vb, xb);
    epnn::load_row<kFH, kH>(pi + (size_t)rwa * kH, t, va, pa);
    epnn::load_row<kFH, kH>(pi + (size_t)rwb * kH, t, vb, pb);
    const float wa = va ? wgt[fa] : 0.0f, wb = vb ? wgt[fb] : 0.0f;
    float ba[kFH], bb[kFH];  // base = pi_i + pjn_is
#pragma unroll
    for (int m = 0; m < kFH; ++m) {
      ba[m] = pa[m] + xa[m];
      bb[m] = pb[m] + xb[m];
    }

    float ep[kNT][4], ea[kFH], eb[kFH];
    epnn::near_epart(ra, rb, s.b1, lane, ep);
    epnn::near_ep_rows(ep, ea, eb);
    float zfa[kFH], zfb[kFH], zna[kFH], znb[kFH];
#pragma unroll
    for (int m = 0; m < kFH; ++m) {
      zfa[m] = epnn::relu(ba[m] + ea[m]);
      zfb[m] = epnn::relu(bb[m] + eb[m]);
      zna[m] = epnn::relu(ba[m]);
      znb[m] = epnn::relu(bb[m]);
    }
    float yf[kNT][4], yn[kNT][4];
    epnn::near_mid(zfa, zfb, bias, s.b2, lane, yf);
    epnn::near_mid(zna, znb, bias, s.b2, lane, yn);
    epnn::near_put(s.d[warp], [&](int nt, int r) {
      return (epnn::relu(yf[nt][r]) - epnn::relu(yn[nt][r])) *
             (r < 2 ? wa : wb);
    });
  };
  epnn::near_walk(s, warp, lane, wgt, K, r0, r1, out, tile);
}

int g_resident[epnn::kNearMaxDevices] = {};  // epnn::near_warps's cache
constexpr int kSmem = (int)sizeof(epnn::NearSmem);

}  // namespace

#endif  // EPNN_WIDE

// The warps a launch runs for N rows (near_tile_positions mirrors the
// walk with it); negative on a CUDA error.
extern "C" int epnn_near_message_corr_warps(int N) {
  int n_warps = 0;
  const cudaError_t err =
      epnn::near_warps(nmc_kernel, g_resident, N, kSmem, n_warps);
  return err == cudaSuccess ? n_warps : -1;
}

// w1e (Ep, Hp), w2 (Hp, Hp), b2 (Hp,) zero-padded; out (N, H); work: the
// wide path's scratch, 16 Hp floats a warp of the launch (unused below 64
// padded; may be null there).
extern "C" int epnn_near_message_corr(const float* pi, const float* pjn,
                                      const float* rbf, const float* mask,
                                      const float* w1e, const float* w2,
                                      const float* b2, float* out,
                                      float* work, int N, int K, int H,
                                      int E, cudaStream_t stream) {
  if (H != kH || E != kE || N <= 0 || K <= 0 ||
      (long long)N * K + 32 > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  int n_warps = 0;
  cudaError_t err =
      epnn::near_warps(nmc_kernel, g_resident, N, kSmem, n_warps);
  if (err != cudaSuccess) return err;
  const int blocks = (n_warps + epnn::kNearWarps - 1) / epnn::kNearWarps;
  nmc_kernel<<<blocks, epnn::kNearThreads, kSmem, stream>>>(
      pi, pjn, rbf, mask, w1e, w2, b2, out, work, N, K, n_warps);
  return cudaGetLastError();
}
