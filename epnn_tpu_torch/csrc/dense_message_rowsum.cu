// dense_message_rowsum — the far-field (beyond-cutoff) message reduction of
// the neighbor-split forward:
//
//   out_i = sum_j cv_j * relu(relu(pi_i + pj_j) @ W2 + b2)     (R, H)
//
// pi already carries the first-layer bias; cv_j is the column weight
// (node mask, or ones in reference-compat mode).
//
// Replaces the TPU kernel epnn_tpu/ops/pallas_kernels.py:
// dense_message_rowsum (:98) -> _dense_message_rowsum_impl (:978), whose
// pallas_call (:1040) runs _msg_kernel (:42).  The v5e lane packing
// (kron(I_P, W2), pltpu.repeat) is not carried over.
//
// Tiers: the JAX kernel's precision argument is the library's TF32 tier
// (EPNN_TF32_PASSES, common.cuh), both built from this source: 3xTF32
// for "high" and "highest", one TF32 product a k-step for "default",
// a third of the products (bound >= 1.31 ms at 17,760 atoms).
//
// Bound on the H100: operations.  Each live pair needs the H x H product
// relu(z1) @ W2 (2H^2 = 2,048 FLOP at H = 32) against O((R + N) H) bytes.
// On the tensor cores in 3xTF32 that is three products, 6H^2 FLOP at
// 495 TFLOP/s (1.24e-11 s a pair), plus ~4H elementwise FLOP at 67 TFLOP/s
// on the CUDA cores: >= 0.06 ms at 2,220 atoms, >= 3.9 ms at 17,760.  In
// fp32 on the CUDA cores alone the same work is bound at 0.16 / 10.2 ms.
//
// Design: wgmma m64n32k8 TF32, split 3x (common.cuh) for fp32 grade.  A
// block is one warpgroup: 4 warps, 64 rows i, 16 a warp; it walks the
// columns j.  For each j, A = relu(pi_i + pj_j) (64 x 32) is built in
// registers (common.cuh far_a: the m16n8k8 fragment each warp already
// uses for mma.sync) from the 16 pi values a thread keeps for the whole
// kernel and 8 pj values broadcast from shared memory, split into hi and
// lo, and multiplied by the constant W2, whose split B tiles sit in shared
// memory (4 k-steps x hi/lo, 8 KB, written once a block).  The product
// starts from b2, and each thread folds cv_j * relu(z2) into the 16 sums
// it owns in the C layout, so the sum over j is a register accumulation:
// no shuffle, no shared-memory reduction.  Per column that is 12 wgmma (4
// k-steps x 3 products): the products the backward's far_z2 makes with
// mma.sync, in the same order, and on the H100 the same bits.  wgmma and
// not mma.sync because the tensor-core products set this kernel's pace and
// mma.sync issues TF32 at a fraction of the tensor cores' rate
// (tools/far_field_pace.py times what sets the pace).
//
// Schedule (far_field.cuh rows): column j's products run while the thread
// folds column j - 1 and builds column j + 1, with two sets of A and
// accumulators; the walk goes 16 columns a block, unrolled, and a block
// ends with no group in flight, since ptxas serializes every wgmma of a
// loop whose in-flight accumulators cross its back edge.  On the H100 the
// products and the CUDA-core work mostly add up all the same: blocks of
// products alone and blocks of build and fold alone, run side by side on
// the SMs, take 92-93% of the sum of their times (with A in shared memory
// instead of registers, more than the sum).  So the build spends the
// fewest CUDA-core instructions it can: A's rounding leaves its mask to
// the tensor cores, which read a TF32 operand's top 19 bits (far_a<true>;
// the same round to nearest, ties away, one integer op fewer an element;
// common.cuh says why the bits are the same), and at one pass and H = 32
// the walk fits four blocks an SM (128 registers, 16 B spilled; 168 and
// 40 B in 3xTF32, three blocks).  The backward (far_z2) keeps the masked
// form.
//
// The pj and cv chunks (32 columns) are staged with cp.async
// into a double-buffered ring, so the next chunk loads while this one
// computes.  Rows give too few blocks for
// 132 SMs at 2,220 atoms, so the column range also splits into a fixed
// number of parts (gridDim.y); epnn::sum_parts adds them in order —
// deterministic, no atomics.  Columns past N enter as pj = 0, cv = 0 and
// add exactly zero.
//
// Widths (common.cuh): up to 64 (padded), the products at H padded to 8
// (wgmma m64nHpk8; W2 and b2 come padded, pi and pj are read at their real
// width with zeros past it).  Above H = 32 a product of more than 4
// k-steps runs as two chains added in fp32, one column is in flight at a
// time (two would not fit in the registers: a column's products, then its
// fold) and the chunks are 16 columns.
// The block body is far_field.cuh's, shared with fused_message_rowsum.cu.
//
// Widths past 64 (padded): far_field.cuh's wide body, the output columns in
// chunks of 32 as a third grid dimension, mma.sync m16n8k8 in 3xTF32 with
// every operand streamed k-step by k-step (wide.cuh).
#include "far_field.cuh"

namespace {

using epnn::kH;

#if EPNN_WIDE

__global__ void __launch_bounds__(epnn::far::kThreads)
dmr_partial(const float* __restrict__ pi, const float* __restrict__ pj,
            const float* __restrict__ cv, const float* __restrict__ w2,
            const float* __restrict__ b2, float* __restrict__ part, int R,
            int N, int cols_per_split) {
  epnn::far::rows<false>(pi, pj, cv, w2, b2, nullptr, part, R, N,
                         cols_per_split, blockIdx.x, blockIdx.y, blockIdx.z);
}

constexpr int kOutChunks = epnn::wide::kChunks;

#else

__global__ void __launch_bounds__(epnn::far::kThreads,
                                  epnn::far::kMinBlocks)
dmr_partial(const float* __restrict__ pi, const float* __restrict__ pj,
            const float* __restrict__ cv, const float* __restrict__ w2,
            const float* __restrict__ b2, float* __restrict__ part, int R,
            int N, int cols_per_split) {
  __shared__ epnn::far::Smem s;
  epnn::far::rows<false>(s, pi, pj, cv, w2, b2, nullptr, part, R, N,
                         cols_per_split, blockIdx.x, blockIdx.y);
}

constexpr int kOutChunks = 1;

#endif  // EPNN_WIDE

}  // namespace

// w2 (Hp, Hp), b2 (Hp,) zero-padded; part: (splits, R, H) scratch; out:
// (R, H); the column range splits into parts of cols_per_split.  Returns
// cudaGetLastError().
extern "C" int epnn_dense_message_rowsum(const float* pi, const float* pj,
                                         const float* cv, const float* w2,
                                         const float* b2, float* part,
                                         float* out, int R, int N, int H,
                                         int splits, int cols_per_split,
                                         cudaStream_t stream) {
  if (H != kH || R <= 0 || N <= 0 || splits <= 0 || cols_per_split <= 0 ||
      (long long)(splits - 1) * cols_per_split >= N)
    return cudaErrorInvalidValue;
  const dim3 grid((R + epnn::far::kRowsPerBlock - 1) / epnn::far::kRowsPerBlock,
                  splits, kOutChunks);
  dmr_partial<<<grid, epnn::far::kThreads, 0, stream>>>(pi, pj, cv, w2, b2,
                                                        part, R, N,
                                                        cols_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rh = R * H;
  epnn::sum_parts<<<(rh + 255) / 256, 256, 0, stream>>>(part, out, rh,
                                                        splits);
  return cudaGetLastError();
}
