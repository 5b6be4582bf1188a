// neighbor_compact — the within-cutoff neighbor list in one pass over the
// pair grid: for each atom i, every column j with d^2_ij < cutoff^2, j != i
// and both atoms valid, in ascending column order, at most k of them.  Hits
// beyond k are dropped, as top-k drops them (the caller's k must be at
// least the true maximum count).  idx (N, k) int64 and mask (N, k) float32;
// unused slots hold idx 0 and mask 0.
//
// Replaces the TPU kernel epnn_tpu/ops/pallas_kernels.py: neighbor_compact
// (:685), whose pallas_call (:723) runs _nbr_compact_kernel (:644).  The
// TPU kernel counts each tile's prefix with a triangular matmul and emits
// through a (BI, BJ, k) one-hot; here a warp owns a row and the prefix is a
// ballot.
//
// Bound on the H100: operations.  About 9 FLOP a pair (3 subtractions,
// 3 products, 2 additions, the compare) against 16 bytes an atom and 12
// bytes a slot: at 2,220 atoms 44.5 MFLOP (0.7 us at 67 TFLOP/s) against
// 0.7 MB (0.2 us at 3.35 TB/s).
//
// Design: a block of 8 warps owns 8 rows and stages the columns' (x, y, z,
// mask) in shared memory, 256 at a time.  Each warp walks its row's columns
// 32 at a time: a lane tests one column, __ballot_sync gives the warp's hit
// mask, __popc of the lanes below gives a hit's place, and a running count
// carries the row's total across steps.  A hit whose slot is below k writes
// its column.  Columns come in ascending order, so the list does too.  d^2
// is the neighbor selection's own formula ((a_i - a_j)^2 axis by axis, in
// x, y, z order, round-to-nearest), so the candidate set is the one
// build_neighbors selects.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kStage = 256;   // columns staged per step

__global__ void __launch_bounds__(kWarps * 32)
nc_kernel(const float* __restrict__ xyz, const float* __restrict__ mask,
          long long* __restrict__ idx, float* __restrict__ nmask, int N,
          int K, float cutoff2) {
  __shared__ float4 s_col[kStage];  // x, y, z, mask

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int i = blockIdx.x * kWarps + warp;
  const bool row_ok = i < N;
  const float xi = row_ok ? xyz[(size_t)i * 3 + 0] : 0.0f;
  const float yi = row_ok ? xyz[(size_t)i * 3 + 1] : 0.0f;
  const float zi = row_ok ? xyz[(size_t)i * 3 + 2] : 0.0f;
  const bool live = row_ok && mask[i] > 0.0f;

  int count = 0;
  for (int c0 = 0; c0 < N; c0 += kStage) {
    __syncthreads();  // the previous columns are consumed
    for (int t = threadIdx.x; t < kStage; t += blockDim.x) {
      const int j = c0 + t;
      s_col[t] = j < N ? make_float4(xyz[(size_t)j * 3 + 0],
                                     xyz[(size_t)j * 3 + 1],
                                     xyz[(size_t)j * 3 + 2], mask[j])
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    __syncthreads();
    if (!live) continue;  // the whole warp: no hits in this row
    for (int t0 = 0; t0 < kStage && c0 + t0 < N; t0 += 32) {
      const int j = c0 + t0 + lane;
      const float4 cj = s_col[t0 + lane];
      const bool hit = j < N && j != i && cj.w > 0.0f &&
                       epnn::pair_d2(xi, yi, zi, cj.x, cj.y, cj.z) < cutoff2;
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      const int slot = count + __popc(ballot & ((1u << lane) - 1u));
      if (hit && slot < K) {
        idx[(size_t)i * K + slot] = j;
        nmask[(size_t)i * K + slot] = 1.0f;
      }
      count += __popc(ballot);
    }
  }
  if (!row_ok) return;
  for (int s = min(count, K) + lane; s < K; s += 32) {
    idx[(size_t)i * K + s] = 0;
    nmask[(size_t)i * K + s] = 0.0f;
  }
}

}  // namespace

// xyz (N, 3), mask (N,); idx (N, K) int64 and nmask (N, K) out; cutoff2 the
// squared cutoff in float32.  Returns cudaGetLastError().
extern "C" int epnn_neighbor_compact(const float* xyz, const float* mask,
                                     long long* idx, float* nmask, int N,
                                     int K, float cutoff2,
                                     cudaStream_t stream) {
  if (N <= 0 || K <= 0) return cudaErrorInvalidValue;
  const int blocks = (N + kWarps - 1) / kWarps;
  nc_kernel<<<blocks, kWarps * 32, 0, stream>>>(xyz, mask, idx, nmask, N, K,
                                                cutoff2);
  return cudaGetLastError();
}
