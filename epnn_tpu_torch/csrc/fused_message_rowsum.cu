// fused_message_rowsum — one dense message round with the pair
// featurization in the kernel:
//
//   out_i = sum_j w_ij * relu(relu(pi_i + pj_j + rbf_ij @ W1e) @ W2 + b2)
//
// rbf_ij: d^2 from the coordinates, the cosine envelope (cleared for self
// pairs and masked atoms) and E Gaussian channels around mu.  w_ij is the
// pair mask m_i m_j, diagonal kept (masked = 1), or cv_j (masked = 0,
// reference-compat mode: masked atoms still count).  pi carries the
// first-layer bias; the caller applies W_out and the sum_j b_out term.
//
// Replaces the TPU kernel epnn_tpu/ops/pallas_kernels.py:
// fused_message_rowsum (:490), whose pallas_call (:591) runs _msg_rbf_kernel
// (:308) with the featurization _tile_rbf_flat (:178); the lane-packed
// variant (_msg_packed_kernel :874, pallas_call :561) is a v5e layout of the
// same math and is not carried over.
//
// Tiers: the JAX kernel's precision argument is the library's TF32 tier
// (EPNN_TF32_PASSES, common.cuh), both built from this source: 3xTF32
// for "high" and "highest", one TF32 product a k-step for "default",
// a third of the products in both block kinds.
//
// The split.  Where rbf_ij = 0 — beyond the cutoff, on the diagonal, for
// masked atoms: all but ~17 thousand of the 4.9 M pairs of the 2,224-atom
// water box — the pair's term is the far field's, relu(relu(pi_i + pj_j)
// @ W2 + b2).  w_ij is separable in both modes (m_i * m_j, or 1 * cv_j).
// So out = rw_i * sum_j cv_j far(i, j) over every pair (rw = m, cv = m when
// masked; rw = 1, cv = cv otherwise) plus sum_j w_ij (hid(i, j) - far(i,
// j)) over the pairs within the cutoff, both atoms valid, i != j.
//
// Bound on the H100: operations.  Every pair needs the far field's H x H
// product (2H^2 FLOP, three TF32 products in 3xTF32) and a d^2 scan; a
// live pair also its E channels (E exps; under the doubling two exps and
// ~E (1 + popcount) multiplies), rbf @ W1e and two mid layers (2EH +
// 4H^2).  chip_smoke.py prints the bound on its data.
//
// RBF methods: the JAX kernel's rbf_method, the kernel's template
// argument kDbl, both instantiations in one library, as in
// fused_epn_rowsum.cu: tab holds the centers mu ("direct") or the
// doubling's gains g (common.cuh, doubling_channel).  Only live pairs
// build channels, so the far field is the same under both.
//
// Design: one launch, two kinds of blocks of one warpgroup each.
//   * blocks [0, far_blocks): the far field on wgmma in 3xTF32,
//     dense_message_rowsum.cu's block body (far_field.cuh), into the
//     fixed column parts part[0 .. splits);
//   * the rest: the live correction on the near tiles (common.cuh, "the
//     near tiles") fed by a d^2 scan of the pair grid (pair_walk, its
//     columns staged in shared memory by the block), as in
//     fused_epn_rowsum.cu: for each live pair the four threads of its M
//     row build its envelope and channels, then epart = rbf @ W1e and the
//     two mid layers relu(base + epart) @ W2 and relu(base) @ W2 (base =
//     pi_i + pj_j) in mma.sync m16n8k8 3xTF32, the weighted difference
//     summed over the row's live pairs in ascending order into part[splits].
// epnn::sum_parts then adds the splits + 1 parts in order: deterministic,
// no atomics.  The order of summation differs from the plain version's, so
// the check against it is the fp32 bar, not its bits.
//
// Widths: up to 64 padded (common.cuh); W1e (Ep, Hp), W2 and b2
// come zero-padded, tab (E,) is read into shared memory with zeros past E.
//
// Widths past 64 (padded H or E): the far blocks run far_field.cuh's wide
// body (one output chunk of 32 a block), the near blocks wide.cuh's tiles
// fed by the same scan.
#include "far_field.cuh"

#if EPNN_WIDE

namespace {

using epnn::kE;
using epnn::kH;
namespace wide = epnn::wide;

struct NearPart {
  float d[epnn::kNearWarps][16][wide::kDS];
  epnn::ScanSmem scan;
};
constexpr int kSmem = (int)sizeof(NearPart);
constexpr int kOutChunks = wide::kChunks;
static_assert(epnn::far::kThreads == epnn::kNearThreads, "one block size");

template <bool kDbl>
__global__ void __launch_bounds__(epnn::kNearThreads, 3)
fmr_kernel(const float* __restrict__ pi, const float* __restrict__ pj,
           const float* __restrict__ xyz, const float* __restrict__ mask,
           const float* __restrict__ cv, const float* __restrict__ w1e,
           const float* __restrict__ w2, const float* __restrict__ b2,
           const float* __restrict__ tab, float* __restrict__ part,
           float* work, int N,
           int splits, int cols_per_split, int far_blocks, int n_warps,
           int masked, float cutoff, float eta, float cut2, float u_scale) {
  extern __shared__ __align__(128) uint4 smem_raw[];
  if ((int)blockIdx.x < far_blocks) {
    const int row_blocks = (N + epnn::far::kRowsPerBlock - 1) /
                           epnn::far::kRowsPerBlock;
    const int bx = blockIdx.x % row_blocks, rest = blockIdx.x / row_blocks;
    const int by = rest % splits, oc = rest / splits;
    if (masked)
      epnn::far::rows<true>(pi, pj, mask, w2, b2, mask, part, N, N,
                            cols_per_split, bx, by, oc);
    else
      epnn::far::rows<false>(pi, pj, cv, w2, b2, nullptr, part, N, N,
                             cols_per_split, bx, by, oc);
    return;
  }

  NearPart& sm = *reinterpret_cast<NearPart*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gw = (blockIdx.x - far_blocks) * epnn::kNearWarps + warp;
  const int g = lane >> 2;
  const float neg_eta = -eta;
  int r0 = N, r1 = N;  // a warp past the grid's owns no rows
  if (gw < n_warps) epnn::near_range(N, gw, n_warps, r0, r1);

  auto tile = [&](int h0, int n) {
    const int ia = (h0 + g) & (epnn::kPairRing - 1);
    const int ib = (h0 + g + 8) & (epnn::kPairRing - 1);
    const bool v[2] = {g < n, g + 8 < n};
    const int j[2] = {v[0] ? sm.scan.ring[warp][ia] : 0,
                      v[1] ? sm.scan.ring[warp][ib] : 0};
    const int i[2] = {v[0] ? sm.scan.rows[warp][ia] : 0,
                      v[1] ? sm.scan.rows[warp][ib] : 0};
    float c[2], d[2], a[2] = {0.0f, 0.0f}, u[2] = {0.0f, 0.0f}, w[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float pm;
      c[e] = wide::pair_env(xyz, mask, i[e], j[e], cutoff, d[e], pm);
      if (kDbl)
        epnn::doubling_pair(c[e], d[e], cutoff, neg_eta, u_scale, a[e], u[e]);
      w[e] = i[e] == j[e] ? 0.0f : masked ? pm : cv[j[e]];
    }
    const float* pir[2] = {pi + (size_t)i[0] * kH, pi + (size_t)i[1] * kH};
    const float* pjc[2] = {pj + (size_t)j[0] * kH, pj + (size_t)j[1] * kH};
    wide::tile(
        w1e, w2, b2, lane,
        [&](int e, int ch) {
          return wide::rbf_of<kDbl>(c[e], d[e], a[e], u[e], tab, ch,
                                    neg_eta);
        },
        [&](int e, int f, float ep, float& zf, float& zn) {
          const bool in = v[e] && f < kH;
          const float base = __fadd_rn(in ? pir[e][f] : 0.0f,
                                       in ? pjc[e][f] : 0.0f);
          zf = epnn::relu(__fadd_rn(base, ep));
          zn = epnn::relu(base);
        },
        [&](int e, float yf, float yn) {
          return __fmul_rn(__fsub_rn(epnn::relu(yf), epnn::relu(yn)), w[e]);
        },
        work + (size_t)gw * wide::kScratch, sm.d[warp], sm.scan.rows[warp],
        epnn::kPairRing - 1, h0, n,
        part + (size_t)splits * N * kH);
  };
  wide::pair_walk(sm.scan, warp, lane, xyz, mask, cut2, N, n_warps, r0, r1,
                  part + (size_t)splits * N * kH, tile);
}

}  // namespace

#else

namespace {

using epnn::kE;
using epnn::kEp;
using epnn::kFE;
using epnn::kFH;
using epnn::kH;
using epnn::kNT;

struct NearPart {
  epnn::NearSmem near;
  epnn::ScanSmem scan;
  float tab[kEp];  // mu, or the doubling's gains
};
// the two kinds of blocks share one dynamic allocation
constexpr int kSmem = (int)(sizeof(NearPart) > sizeof(epnn::far::Smem)
                                ? sizeof(NearPart)
                                : sizeof(epnn::far::Smem));
static_assert(epnn::far::kThreads == epnn::kNearThreads, "one block size");

template <bool kDbl>
__global__ void __launch_bounds__(epnn::kNearThreads, 3)
fmr_kernel(const float* __restrict__ pi, const float* __restrict__ pj,
           const float* __restrict__ xyz, const float* __restrict__ mask,
           const float* __restrict__ cv, const float* __restrict__ w1e,
           const float* __restrict__ w2, const float* __restrict__ b2,
           const float* __restrict__ tab, float* __restrict__ part,
           float* work, int N,
           int splits, int cols_per_split, int far_blocks, int n_warps,
           int masked, float cutoff, float eta, float cut2, float u_scale) {
  extern __shared__ __align__(128) uint4 smem_raw[];
  if ((int)blockIdx.x < far_blocks) {
    const int row_blocks = (N + epnn::far::kRowsPerBlock - 1) /
                           epnn::far::kRowsPerBlock;
    auto& fs = *reinterpret_cast<epnn::far::Smem*>(smem_raw);
    const int bx = blockIdx.x % row_blocks, by = blockIdx.x / row_blocks;
    if (masked)
      epnn::far::rows<true>(fs, pi, pj, mask, w2, b2, mask, part, N, N,
                            cols_per_split, bx, by);
    else
      epnn::far::rows<false>(fs, pi, pj, cv, w2, b2, nullptr, part, N, N,
                             cols_per_split, bx, by);
    return;
  }

  NearPart& sm = *reinterpret_cast<NearPart*>(smem_raw);
  epnn::NearSmem& s = sm.near;
  float bias[kNT][2];
  epnn::near_stage(s, w1e, w2, b2, bias);
  for (int e = threadIdx.x; e < kEp; e += epnn::kNearThreads)
    sm.tab[e] = e < kE ? tab[e] : 0.0f;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gw = (blockIdx.x - far_blocks) * epnn::kNearWarps + warp;
  const int g = lane >> 2, t = lane & 3;
  const float neg_eta = -eta;
  int r0 = N, r1 = N;  // a warp past the grid's owns no rows
  if (gw < n_warps) epnn::near_range(N, gw, n_warps, r0, r1);

  // a pair's channels (kFE t .. of them) and its weight w_ij
  auto features = [&](int i, int j, float (&r)[kFE]) {
    float pm;
    epnn::pair_channels<kFE, kE, kDbl>(xyz, mask, sm.tab, i, j, t, cutoff,
                                       neg_eta, u_scale, pm, r);
    return i == j ? 0.0f : masked ? pm : cv[j];
  };

  // one tile: pairs g (a) and g + 8 (b) of the ring from h0, n of them
  auto tile = [&](int h0, int n) {
    const int ia = (h0 + g) & (epnn::kPairRing - 1);
    const int ib = (h0 + g + 8) & (epnn::kPairRing - 1);
    const bool va = g < n, vb = g + 8 < n;
    const int ja = va ? sm.scan.ring[warp][ia] : 0;
    const int jb = vb ? sm.scan.ring[warp][ib] : 0;
    const int ra_ = va ? sm.scan.rows[warp][ia] : 0;
    const int rb_ = vb ? sm.scan.rows[warp][ib] : 0;
    float ra[kFE], rb[kFE];
    const float wa = features(ra_, ja, ra);
    const float wb = features(rb_, jb, rb);
    float pa[kFH], pb[kFH], xa[kFH], xb[kFH];
    epnn::load_row<kFH, kH>(pi + (size_t)ra_ * kH, t, va, pa);
    epnn::load_row<kFH, kH>(pi + (size_t)rb_ * kH, t, vb, pb);
    epnn::load_row<kFH, kH>(pj + (size_t)ja * kH, t, va, xa);
    epnn::load_row<kFH, kH>(pj + (size_t)jb * kH, t, vb, xb);
    float ba[kFH], bb[kFH];  // base = pi_i + pj_j
#pragma unroll
    for (int m = 0; m < kFH; ++m) {
      ba[m] = __fadd_rn(pa[m], xa[m]);
      bb[m] = __fadd_rn(pb[m], xb[m]);
    }

    float ep[kNT][4], ea[kFH], eb[kFH];
    epnn::near_epart(ra, rb, s.b1, lane, ep);
    epnn::near_ep_rows(ep, ea, eb);
    float zfa[kFH], zfb[kFH], zna[kFH], znb[kFH];
#pragma unroll
    for (int m = 0; m < kFH; ++m) {
      zfa[m] = epnn::relu(__fadd_rn(ba[m], ea[m]));
      zfb[m] = epnn::relu(__fadd_rn(bb[m], eb[m]));
      zna[m] = epnn::relu(ba[m]);
      znb[m] = epnn::relu(bb[m]);
    }
    float yf[kNT][4], yn[kNT][4];
    epnn::near_mid(zfa, zfb, bias, s.b2, lane, yf);
    epnn::near_mid(zna, znb, bias, s.b2, lane, yn);
    epnn::near_put(s.d[warp], [&](int nt, int r) {
      return __fmul_rn(__fsub_rn(epnn::relu(yf[nt][r]),
                                 epnn::relu(yn[nt][r])),
                       r < 2 ? wa : wb);
    });
  };
  epnn::pair_walk(s, sm.scan, warp, lane, xyz, mask, cut2, N, n_warps, r0,
                  r1, part + (size_t)splits * N * kH, tile);
}

constexpr int kOutChunks = 1;

}  // namespace

#endif  // EPNN_WIDE

namespace {

// epnn::near_warps's cache, an instantiation (direct, doubling) each
int g_resident[2][epnn::kNearMaxDevices] = {};

cudaError_t warps(bool dbl, int N, int& n_warps) {
  return dbl ? epnn::near_warps(fmr_kernel<true>, g_resident[1], N, kSmem,
                                n_warps)
             : epnn::near_warps(fmr_kernel<false>, g_resident[0], N, kSmem,
                                n_warps);
}

}  // namespace

// The warps of a launch's near blocks for N rows, of either method at
// most (the wide path's scratch holds 16 Hp floats for each); negative on
// a CUDA error.
extern "C" int epnn_fused_message_rowsum_warps(int N) {
  int direct = 0, doubled = 0;
  if (warps(false, N, direct) != cudaSuccess ||
      warps(true, N, doubled) != cudaSuccess)
    return -1;
  return direct > doubled ? direct : doubled;
}

// xyz (N, 3), mask and cv (N,), tab (E,) the RBF centers mu (doubling =
// 0) or the doubling's gains g (doubling = 1, u_scale = 2 eta D); w1e (Ep,
// Hp), w2 (Hp, Hp), b2 (Hp,) zero-padded; part: (splits + 1, N, H)
// scratch; out: (N, H); work: the wide path's scratch (16 Hp floats a near
// warp; unused below 64 padded, may be null there); the far field's column
// range splits into parts of cols_per_split; cut2 the squared cutoff
// rounded up.  N * N must fit an int.  Returns cudaGetLastError().
extern "C" int epnn_fused_message_rowsum(
    const float* pi, const float* pj, const float* xyz, const float* mask,
    const float* cv, const float* w1e, const float* w2, const float* b2,
    const float* tab, float* part, float* out, float* work, int N, int H,
    int E,
    int splits, int cols_per_split, int masked, int doubling, float cutoff,
    float eta, float cut2, float u_scale, cudaStream_t stream) {
  if (H != kH || E != kE || N <= 0 || splits <= 0 || cols_per_split <= 0 ||
      (long long)(splits - 1) * cols_per_split >= N ||
      (long long)N * N > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  int n_warps = 0;
  cudaError_t err = warps(doubling != 0, N, n_warps);
  if (err != cudaSuccess) return err;
  const int row_blocks =
      (N + epnn::far::kRowsPerBlock - 1) / epnn::far::kRowsPerBlock;
  const int far_blocks = row_blocks * splits * kOutChunks;
  const int near_blocks =
      (n_warps + epnn::kNearWarps - 1) / epnn::kNearWarps;
  const auto kernel = doubling ? fmr_kernel<true> : fmr_kernel<false>;
  kernel<<<far_blocks + near_blocks, epnn::kNearThreads, kSmem, stream>>>(
      pi, pj, xyz, mask, cv, w1e, w2, b2, tab, part, work, N, splits,
      cols_per_split, far_blocks, n_warps, masked, cutoff, eta, cut2,
      u_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int count = N * kH;
  epnn::sum_parts<<<(count + 255) / 256, 256, 0, stream>>>(part, out, count,
                                                            splits + 1);
  return cudaGetLastError();
}
