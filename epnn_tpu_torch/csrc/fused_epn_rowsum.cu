// fused_epn_rowsum — one dense electron-passing round with the pair
// featurization in the kernel:
//
//   out_i = sum_j 0.5 * gate_ij * (hid(i, j) - hid(j, i))
//   hid(i, j) = relu(relu(pi_i + pj_j + rbf_ij @ W1e) @ W2 + b2)
//
// rbf_ij as in fused_message_rowsum.cu (envelope cleared for self pairs and
// masked atoms); gate_ij is the hard is-near gate (any channel above tol)
// or, with soft_gate, the masked envelope.  pi carries the first-layer
// bias; the caller applies W_out (b_out cancels in the difference).
//
// Replaces the TPU kernel epnn_tpu/ops/pallas_kernels.py: fused_epn_rowsum
// (:368), whose pallas_call (:469) runs _epn_kernel (:268) with the
// featurization _tile_rbf_flat (:178); the lane-packed variant
// (_epn_packed_kernel :829, pallas_call :442) is a v5e layout of the same
// math and is not carried over.
//
// Tiers: the JAX kernel's precision argument is the library's TF32 tier
// (EPNN_TF32_PASSES, common.cuh), both built from this source: 3xTF32
// for "high" and "highest", one TF32 product a k-step for "default",
// a third of the products; a pair's two orderings keep one
// rounding and one k order at either tier, so they stay exact negations.
//
// Both gates are exactly 0 beyond the cutoff, on the diagonal and for
// masked atoms (the envelope is, and so is every channel), so only pairs
// within the cutoff add anything: ~17 thousand of the 4.9 M pairs of the
// 2,224-atom water box.  The TPU kernel pays every pair in full; here only
// live pairs pay.
//
// Bound on the H100: operations, of two kinds.  Deciding which pairs are
// live takes every valid pair a d^2 and a compare (~10 instructions on the
// CUDA cores); a live pair needs its E channels (E exps, a sqrt, a cos;
// under the doubling two exps, a sqrt, a cos and ~E (1 + popcount)
// multiplies) and rbf @ W1e and both orderings' mid layers, 2EH + 4H^2
// FLOP of tensor-core products, three TF32 products each in 3xTF32.  At
// 2,224 atoms both are microseconds (chip_smoke.py prints the bound).
//
// RBF methods: the JAX kernel's rbf_method, the kernel's template
// argument kDbl; one library holds both instantiations and the entry
// picks one a launch (its doubling argument), so direct runs the code it
// had before the doubling existed.  "direct" reads the centers mu from
// tab and takes an exp a channel, "doubling" reads the gains g and builds
// the channels from two exps a pair (common.cuh, doubling_channel).  The
// hard gate reads the channels the method built.
//
// Design: the near kernels' tiles (common.cuh, "the near tiles"), fed by a
// d^2 scan of the pair grid (pair_walk).  A persistent grid: a few blocks
// an SM, each warp a contiguous range of rows, W1e's and W2's split B
// fragments staged once per block.  The block's four warps take their rows
// in step, and the block stages the columns' coordinates and mask 256 at a
// time into shared memory (cp.async, double-buffered: the scan was bound
// by the latency of reading them from L2, 3.5 ms at 17,760 atoms when each
// warp read them itself).  Each warp tests its row against them 32 at a
// time, computes d^2 (common.cuh's pair_d2, the same bits both ways) and
// ballots the pairs within the cutoff with both atoms valid into its ring
// of 512; between segments of the scan (common.cuh, pair_walk) every 16 of
// them run as the M rows of mma.sync m16n8k8 3xTF32 products.  In a tile, the four threads of a pair build
// its envelope and their share of its E channels (a pair's channels go to
// the A fragment of epart directly; channels past the real E are 0 and
// stay out of the gate, which the four threads combine by shuffles), then
// epart = rbf @ W1e, zn = relu((pi_i + pj_j) + epart), zt = relu((pi_j +
// pj_i) + epart) and both through W2, as near_pass_rowsum.cu does.  The
// tile's terms 0.5 gate (relu(yn) - relu(yt)) go to shared memory and lane
// o adds column o over the pairs in ascending order: deterministic, no
// atomics, one launch.  A pair inside the cutoff whose channels are all
// under tol has a hard gate of 0 and adds exactly 0, as in the plain
// version.
//
// Hazard: charge conservation needs the transfer of (i, j) in row i to be
// the exact negation of that of (j, i) in row j, wherever the two land.
// The pair's d^2 has the same bits both ways, and every later step of the
// featurization is a deterministic function of d^2 alone (common.cuh), so
// both positions see the same rbf, gate and epart (the products of a row of
// A do not depend on its M position or on the other rows).  zn = (pi_i +
// pj_j) + epart and zt = (pi_j + pj_i) + epart: row j's zn is row i's zt
// (IEEE addition commutes) and the reverse, through the same products, so
// 0.5 gate (relu(yn) - relu(yt)) is negated exactly.  Only the row sums
// are reordered, so sum_i out_i conserves to f32 grade.  The dense dimer
// probe of chip_smoke.py checks this on the card at two widths.  Build
// without --use_fast_math: expf, cosf, sqrt at full precision.
//
// Widths: up to 64 padded (common.cuh); W1e (Ep, Hp), W2 and b2
// come zero-padded, tab (E,) is read into shared memory with zeros past E.
//
// Widths past 64 (padded H or E): the wide tiles of wide.cuh fed by the
// same scan (wide::pair_walk); a pair's channels are built one at a time
// where a k-step of epart takes them (tab from global memory), its gate
// once a tile.  Every step stays a function of the pair's d^2 and of the
// two orderings' bases, so the transfers stay exact negations.
#include "common.cuh"

#if EPNN_WIDE
#include "wide.cuh"

namespace {

using epnn::kE;
using epnn::kH;
namespace wide = epnn::wide;

struct Smem {
  float d[epnn::kNearWarps][16][wide::kDS];
  epnn::ScanSmem scan;
};

template <bool kDbl>
__global__ void __launch_bounds__(epnn::kNearThreads, 3)
fepn_kernel(const float* __restrict__ pi, const float* __restrict__ pj,
            const float* __restrict__ xyz, const float* __restrict__ mask,
            const float* __restrict__ w1e, const float* __restrict__ w2,
            const float* __restrict__ b2, const float* __restrict__ tab,
            float* __restrict__ out, float* work, int N, int n_warps,
            int soft_gate,
            float cutoff, float eta, float tol, float cut2, float u_scale) {
  extern __shared__ uint4 smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gw = blockIdx.x * epnn::kNearWarps + warp;
  const int g = lane >> 2, t = lane & 3;
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
    float c[2], d[2], a[2] = {0.0f, 0.0f}, u[2] = {0.0f, 0.0f}, gh[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float pm;
      c[e] = wide::pair_env(xyz, mask, i[e], j[e], cutoff, d[e], pm);
      if (kDbl)
        epnn::doubling_pair(c[e], d[e], cutoff, neg_eta, u_scale, a[e], u[e]);
      // the hard gate: any real channel above tol, over the four threads
      int near = 0;
      for (int ch = t; ch < kE; ch += 4)
        near |= wide::rbf_of<kDbl>(c[e], d[e], a[e], u[e], tab, ch,
                                   neg_eta) > tol;
      near |= __shfl_xor_sync(0xffffffffu, near, 1);
      near |= __shfl_xor_sync(0xffffffffu, near, 2);
      gh[e] = __fmul_rn(0.5f, soft_gate ? c[e] : (near ? 1.0f : 0.0f));
    }
    const float* pir[2] = {pi + (size_t)i[0] * kH, pi + (size_t)i[1] * kH};
    const float* pjr[2] = {pj + (size_t)i[0] * kH, pj + (size_t)i[1] * kH};
    const float* pic[2] = {pi + (size_t)j[0] * kH, pi + (size_t)j[1] * kH};
    const float* pjc[2] = {pj + (size_t)j[0] * kH, pj + (size_t)j[1] * kH};
    wide::tile(
        w1e, w2, b2, lane,
        [&](int e, int ch) {
          return wide::rbf_of<kDbl>(c[e], d[e], a[e], u[e], tab, ch,
                                    neg_eta);
        },
        [&](int e, int f, float ep, float& zn, float& zt) {
          const bool in = v[e] && f < kH;
          const float n_ = __fadd_rn(in ? pir[e][f] : 0.0f,
                                     in ? pjc[e][f] : 0.0f);
          const float t_ = __fadd_rn(in ? pic[e][f] : 0.0f,
                                     in ? pjr[e][f] : 0.0f);
          zn = epnn::relu(__fadd_rn(n_, ep));
          zt = epnn::relu(__fadd_rn(t_, ep));
        },
        [&](int e, float yn, float yt) {
          return __fmul_rn(gh[e], __fsub_rn(epnn::relu(yn), epnn::relu(yt)));
        },
        work + (size_t)gw * wide::kScratch, sm.d[warp], sm.scan.rows[warp],
        epnn::kPairRing - 1, h0, n, out);
  };
  wide::pair_walk(sm.scan, warp, lane, xyz, mask, cut2, N, n_warps, r0, r1,
                  out, tile);
}

constexpr int kSmem = (int)sizeof(Smem);

}  // namespace

#else

namespace {

using epnn::kE;
using epnn::kEp;
using epnn::kFE;
using epnn::kFH;
using epnn::kH;
using epnn::kNT;
// resident blocks an SM the registers are budgeted for (as near_pass_rowsum)
constexpr int kMinBlocks = 3;

struct Smem {
  epnn::NearSmem near;
  epnn::ScanSmem scan;
  float tab[kEp];  // mu, or the doubling's gains
};

template <bool kDbl>
__global__ void __launch_bounds__(epnn::kNearThreads, kMinBlocks)
fepn_kernel(const float* __restrict__ pi, const float* __restrict__ pj,
            const float* __restrict__ xyz, const float* __restrict__ mask,
            const float* __restrict__ w1e, const float* __restrict__ w2,
            const float* __restrict__ b2, const float* __restrict__ tab,
            float* __restrict__ out, float* work, int N, int n_warps,
            int soft_gate,
            float cutoff, float eta, float tol, float cut2, float u_scale) {
  extern __shared__ uint4 smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  epnn::NearSmem& s = sm.near;
  float bias[kNT][2];
  epnn::near_stage(s, w1e, w2, b2, bias);
  for (int e = threadIdx.x; e < kEp; e += epnn::kNearThreads)
    sm.tab[e] = e < kE ? tab[e] : 0.0f;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gw = blockIdx.x * epnn::kNearWarps + warp;
  const int g = lane >> 2, t = lane & 3;
  const float neg_eta = -eta;
  int r0 = N, r1 = N;  // a warp past the grid's owns no rows
  if (gw < n_warps) epnn::near_range(N, gw, n_warps, r0, r1);

  // a pair's channels (kFE t .. of them) and 0.5 * gate, the hard gate's
  // channels (the real E only) combined over the pair's four threads
  auto features = [&](int i, int j, float (&r)[kFE]) {
    float pm;
    const float c = epnn::pair_channels<kFE, kE, kDbl>(
        xyz, mask, sm.tab, i, j, t, cutoff, neg_eta, u_scale, pm, r);
    int near = 0;
#pragma unroll
    for (int m = 0; m < kFE; ++m)
      if (kE == kEp || kFE * t + m < kE) near |= r[m] > tol;
    near |= __shfl_xor_sync(0xffffffffu, near, 1);
    near |= __shfl_xor_sync(0xffffffffu, near, 2);
    return __fmul_rn(0.5f, soft_gate ? c : (near ? 1.0f : 0.0f));
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
    const float gha = features(ra_, ja, ra);
    const float ghb = features(rb_, jb, rb);
    // own row i: pi_i, pj_i; the column j: pi_j, pj_j
    float iia[kFH], iib[kFH], jia[kFH], jib[kFH];
    float ija[kFH], ijb[kFH], jja[kFH], jjb[kFH];
    epnn::load_row<kFH, kH>(pi + (size_t)ra_ * kH, t, va, iia);
    epnn::load_row<kFH, kH>(pi + (size_t)rb_ * kH, t, vb, iib);
    epnn::load_row<kFH, kH>(pj + (size_t)ra_ * kH, t, va, jia);
    epnn::load_row<kFH, kH>(pj + (size_t)rb_ * kH, t, vb, jib);
    epnn::load_row<kFH, kH>(pi + (size_t)ja * kH, t, va, ija);
    epnn::load_row<kFH, kH>(pi + (size_t)jb * kH, t, vb, ijb);
    epnn::load_row<kFH, kH>(pj + (size_t)ja * kH, t, va, jja);
    epnn::load_row<kFH, kH>(pj + (size_t)jb * kH, t, vb, jjb);
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
      return __fmul_rn(r < 2 ? gha : ghb,
                       __fsub_rn(epnn::relu(yn[nt][r]),
                                 epnn::relu(yt[nt][r])));
    });
  };
  epnn::pair_walk(s, sm.scan, warp, lane, xyz, mask, cut2, N, n_warps, r0,
                  r1, out, tile);
}

constexpr int kSmem = (int)sizeof(Smem);

}  // namespace

#endif  // EPNN_WIDE

namespace {

// epnn::near_warps's cache, an instantiation (direct, doubling) each
int g_resident[2][epnn::kNearMaxDevices] = {};

cudaError_t warps(bool dbl, int N, int& n_warps) {
  return dbl ? epnn::near_warps(fepn_kernel<true>, g_resident[1], N, kSmem,
                                n_warps)
             : epnn::near_warps(fepn_kernel<false>, g_resident[0], N, kSmem,
                                n_warps);
}

}  // namespace

// The warps a launch of either method runs for N rows at most (the wide
// path's scratch holds 16 Hp floats for each); negative on a CUDA error.
extern "C" int epnn_fused_epn_rowsum_warps(int N) {
  int direct = 0, doubled = 0;
  if (warps(false, N, direct) != cudaSuccess ||
      warps(true, N, doubled) != cudaSuccess)
    return -1;
  return direct > doubled ? direct : doubled;
}

// xyz (N, 3), mask (N,), tab (E,) the RBF centers mu (doubling = 0) or
// the doubling's gains g (doubling = 1, u_scale = 2 eta D); w1e (Ep, Hp),
// w2 (Hp, Hp), b2 (Hp,) zero-padded; out: (N, H); work: the wide path's
// scratch (16 Hp floats a warp; unused below 64 padded, may be null
// there); cut2 the squared cutoff rounded up.  N * N must fit an int.
// Returns cudaGetLastError().
extern "C" int epnn_fused_epn_rowsum(
    const float* pi, const float* pj, const float* xyz, const float* mask,
    const float* w1e, const float* w2, const float* b2, const float* tab,
    float* out, float* work, int N, int H, int E, int soft_gate,
    int doubling, float cutoff, float eta, float tol, float cut2,
    float u_scale, cudaStream_t stream) {
  if (H != kH || E != kE || N <= 0 || (long long)N * N > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  int n_warps = 0;
  cudaError_t err = warps(doubling != 0, N, n_warps);
  if (err != cudaSuccess) return err;
  const int blocks = (n_warps + epnn::kNearWarps - 1) / epnn::kNearWarps;
  const auto kernel = doubling ? fepn_kernel<true> : fepn_kernel<false>;
  kernel<<<blocks, epnn::kNearThreads, kSmem, stream>>>(
      pi, pj, xyz, mask, w1e, w2, b2, tab, out, work, N, n_warps, soft_gate,
      cutoff, eta, tol, cut2, u_scale);
  return cudaGetLastError();
}
