// near_pass_rowsum — one electron-passing round's antisymmetric row sums
// over the gathered near pairs:
//
//   out_i = sum_s gh_is * (mlp(pi_i + pj_j + e_s) - mlp(pi_j + pj_i + e_s))
//   j = idx_is, e_s = rbf_s @ W1e, mlp(z) = relu(relu(z) @ W2 + b2)
//
// from rs = [pi | pj] (N, 2H) and its gathered rows ppn = rs[idx] (N*K, 2H);
// gh = 0.5 * gate with the slot mask folded in.  The caller applies W_out
// (b_out cancels in the difference).
//
// Replaces the TPU kernel epnn_tpu/ops/pallas_kernels.py: near_pass_rowsum
// (:1410) -> _near_pass_impl (:1347), whose pallas_call (:1368) runs
// _near_pass_kernel (:1312).  The v5e lane roll of [pi | pj] is not carried
// over: the two orderings are two chains of products here.
//
// Tiers: the JAX kernel's precision argument is the library's TF32 tier
// (EPNN_TF32_PASSES, common.cuh), both built from this source: 3xTF32
// for "high" and "highest", one TF32 product a k-step for "default",
// a third of the products; a pair's two orderings keep one
// rounding and one k order at either tier, so they stay exact negations.
//
// Bound on the H100: bytes.  Only live slots (gh != 0) are read: each
// reads (2H + E) floats (448 B) and needs rbf @ W1e and two H x H
// products, 2EH + 4H^2 = 7.2 kFLOP, three tensor-core products each in
// 3xTF32, plus ~10H elementwise FLOP.  The 17,760-atom water box at K = 24
// has about 136k live slots: ~62 MB (19 us at 3.35 TB/s) against 2.9 GFLOP
// of TF32 products (5.9 us at 495 TFLOP/s).
//
// Design: that of near_message_corr (common.cuh, "the near kernels"): a
// persistent grid, the weights' split B fragments staged once per block,
// each warp compacting its rows' live slots and running 16 at a time as
// the M rows of mma.sync m16n8k8 in 3xTF32 — epart from the gathered rbf
// rows, then zn = relu((pi_i + pj_j) + epart) and zt = relu((pi_j + pj_i)
// + epart), relabelled from epart's C fragment into two A fragments, through
// W2 — and the row sums over the slots in ascending order from shared
// memory.
//
// Hazard: charge conservation needs the pair (i, j)'s term in row i to be
// the exact negation of its term in row j.  Row j's slot for i sees the
// same d^2, hence the same rbf row and gate, so its epart has the same
// bits: the same values in an A row, the same products in the same order,
// and the product of a row of A does not depend on which of the 16 M rows
// it sits in or on the other rows.  Its zn and zt are row i's zt and zn
// bit for bit (the same two fp32 adds, (pi + pj) first, then + epart), so
// its (hn - ht) is the exact negation of row i's, and gh is the same.
// chip_smoke.py's disjoint-pair probe checks this on the card and reports
// how many pairs sat at different M positions, at the shipped widths and at
// one other.
//
// Widths: as near_message_corr.cu (up to 64 padded here, padded weights,
// dynamic shared memory).
//
// Widths past 64 (padded H or E): the wide tiles of wide.cuh, as
// near_message_corr.cu's; both orderings still see the same epart and the
// same products in every chunk, so the pair's terms stay exact negations.
#include "common.cuh"

#if EPNN_WIDE
#include "wide.cuh"

namespace {

using epnn::kE;
using epnn::kH;
namespace wide = epnn::wide;

__global__ void __launch_bounds__(epnn::kNearThreads, 3)
npr_kernel(const float* __restrict__ rs, const float* __restrict__ ppn,
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
    // the slot's gathered row j: pi_j, then pj_j; its own row i: pi_i, pj_i
    const float* jr[2] = {ppn + (size_t)fa * 2 * kH,
                          ppn + (size_t)fb * 2 * kH};
    const float* ir[2] = {rs + (size_t)rwa * 2 * kH,
                          rs + (size_t)rwb * 2 * kH};
    const float w[2] = {v[0] ? wgt[fa] : 0.0f, v[1] ? wgt[fb] : 0.0f};
    wide::tile(
        w1e, w2, b2, lane,
        [&](int e, int c) { return wide::at(rb[e], c, kE, v[e]); },
        [&](int e, int f, float ep, float& zn, float& zt) {
          const bool in = v[e] && f < kH;
          const float pii = in ? ir[e][f] : 0.0f;
          const float pji = in ? ir[e][kH + f] : 0.0f;
          const float pij = in ? jr[e][f] : 0.0f;
          const float pjj = in ? jr[e][kH + f] : 0.0f;
          zn = epnn::relu(__fadd_rn(__fadd_rn(pii, pjj), ep));
          zt = epnn::relu(__fadd_rn(__fadd_rn(pij, pji), ep));
        },
        [&](int e, float yn, float yt) {
          return __fmul_rn(w[e], __fsub_rn(epnn::relu(yn), epnn::relu(yt)));
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
// resident blocks an SM the registers are budgeted for: three (up to 168
// registers a thread) beat four (128, with spills; tools/near_field_pace.py)
constexpr int kMinBlocks = 3;

__global__ void __launch_bounds__(epnn::kNearThreads, kMinBlocks)
npr_kernel(const float* __restrict__ rs, const float* __restrict__ ppn,
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
    // the slot's gathered row j: pi_j, pj_j; its own row i: pi_i, pj_i
    float ra[kFE], rb[kFE], ija[kFH], ijb[kFH], jja[kFH], jjb[kFH];
    float iia[kFH], iib[kFH], jia[kFH], jib[kFH];
    epnn::load_vec<kFE, kE>(rbf + (size_t)fa * kE, t, va, ra);
    epnn::load_vec<kFE, kE>(rbf + (size_t)fb * kE, t, vb, rb);
    epnn::load_vec<kFH, kH>(ppn + (size_t)fa * 2 * kH, t, va, ija);
    epnn::load_vec<kFH, kH>(ppn + (size_t)fb * 2 * kH, t, vb, ijb);
    epnn::load_vec<kFH, kH>(ppn + (size_t)fa * 2 * kH + kH, t, va, jja);
    epnn::load_vec<kFH, kH>(ppn + (size_t)fb * 2 * kH + kH, t, vb, jjb);
    const float* rsa = rs + (size_t)rwa * 2 * kH;
    const float* rsb = rs + (size_t)rwb * 2 * kH;
    epnn::load_row<kFH, kH>(rsa, t, va, iia);
    epnn::load_row<kFH, kH>(rsb, t, vb, iib);
    epnn::load_row<kFH, kH>(rsa + kH, t, va, jia);
    epnn::load_row<kFH, kH>(rsb + kH, t, vb, jib);
    const float wa = va ? wgt[fa] : 0.0f, wb = vb ? wgt[fb] : 0.0f;
    float na[kFH], nb[kFH], ta[kFH], tb[kFH];  // pi_i + pj_j, pi_j + pj_i
#pragma unroll
    for (int m = 0; m < kFH; ++m) {
      na[m] = __fadd_rn(iia[m], jja[m]);
      nb[m] = __fadd_rn(iib[m], jjb[m]);
      ta[m] = __fadd_rn(ija[m], jia[m]);
      tb[m] = __fadd_rn(ijb[m], jib[m]);
    }

    float ep[kNT][4], ea[kFH], eb[kFH];
    epnn::near_epart(ra, rb, s.b1, lane, ep);
    epnn::near_ep_rows(ep, ea, eb);
    float zna[kFH], znb[kFH], zta[kFH], ztb[kFH];
#pragma unroll
    for (int m = 0; m < kFH; ++m) {
      zna[m] = epnn::relu(__fadd_rn(na[m], ea[m]));
      znb[m] = epnn::relu(__fadd_rn(nb[m], eb[m]));
      zta[m] = epnn::relu(__fadd_rn(ta[m], ea[m]));
      ztb[m] = epnn::relu(__fadd_rn(tb[m], eb[m]));
    }
    float yn[kNT][4], yt[kNT][4];
    epnn::near_mid(zna, znb, bias, s.b2, lane, yn);
    epnn::near_mid(zta, ztb, bias, s.b2, lane, yt);
    epnn::near_put(s.d[warp], [&](int nt, int r) {
      return __fmul_rn(r < 2 ? wa : wb,
                       __fsub_rn(epnn::relu(yn[nt][r]),
                                 epnn::relu(yt[nt][r])));
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
extern "C" int epnn_near_pass_rowsum_warps(int N) {
  int n_warps = 0;
  const cudaError_t err =
      epnn::near_warps(npr_kernel, g_resident, N, kSmem, n_warps);
  return err == cudaSuccess ? n_warps : -1;
}

// w1e (Ep, Hp), w2 (Hp, Hp), b2 (Hp,) zero-padded; out (N, H); work: as
// near_message_corr's.
extern "C" int epnn_near_pass_rowsum(const float* rs, const float* ppn,
                                     const float* rbf, const float* gh,
                                     const float* w1e, const float* w2,
                                     const float* b2, float* out, float* work,
                                     int N, int K, int H, int E,
                                     cudaStream_t stream) {
  if (H != kH || E != kE || N <= 0 || K <= 0 ||
      (long long)N * K + 32 > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  int n_warps = 0;
  cudaError_t err =
      epnn::near_warps(npr_kernel, g_resident, N, kSmem, n_warps);
  if (err != cudaSuccess) return err;
  const int blocks = (n_warps + epnn::kNearWarps - 1) / epnn::kNearWarps;
  npr_kernel<<<blocks, epnn::kNearThreads, kSmem, stream>>>(
      rs, ppn, rbf, gh, w1e, w2, b2, out, work, N, K, n_warps);
  return cudaGetLastError();
}
