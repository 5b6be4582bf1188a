// neighbor_compact — the within-cutoff neighbor list: for each atom i,
// every column j with d^2_ij < cutoff^2, j != i and both atoms valid, in
// ascending column order, at most k of them.  Hits beyond k are dropped,
// as top-k drops them (the caller's k must be at least the true maximum
// count).  idx (N, k) int64 and mask (N, k) float32; unused slots hold idx
// 0 and mask 0.
//
// Replaces the TPU kernel epnn_tpu/ops/pallas_kernels.py: neighbor_compact
// (:685), whose pallas_call (:723) runs _nbr_compact_kernel (:644).  The
// TPU kernel counts each tile's prefix with a triangular matmul and emits
// through a (BI, BJ, k) one-hot; here a thread owns a row and walks its
// columns in order, so its hits come in ascending order with no prefix.
//
// Bound on the H100: operations.  About 9 FLOP a pair (3 subtractions,
// 3 products, 2 additions, the compare) against 16 bytes an atom and 12
// bytes a slot: at 17,760 atoms 2.8 GFLOP (0.042 ms at 67 TFLOP/s)
// against 0.6 MB.  On the CUDA cores that is also ~9 instructions a pair
// at one a lane a clock (132 SMs x 128 lanes at 1,980 MHz): 0.085 ms.
//
// Design: two kernels.
//   * nc_scan: a block of 128 threads owns 128 rows, one a thread, and one
//     of a fixed number of column ranges (gridDim.y, the splits: at 2,224
//     atoms rows alone give 70 warps, too few for 132 SMs).  It stages its
//     columns 128 at a time in shared memory as float4 (x, y, z, 0), the
//     column mask folded in (a masked column, or one past the range, sits
//     1e18 away: its d^2 is ~3e36, never under the cutoff, and a valid
//     pair's d^2 keeps its bits), double-buffered: each thread loads the
//     next stage's column into registers before it scans this one, so one
//     barrier a stage suffices and the loads' latency hides behind the
//     scan.  Every thread reads each staged column as a broadcast and
//     computes d^2 with the selection's own formula ((a_i - a_j)^2 axis by
//     axis, x, y, z, round to nearest: common.cuh's pair_d2), so the
//     candidate set is bit for bit top-k's.  A group of 32 columns sets
//     one bit a hit (a predicated OR, no branch: a branch a hit diverged
//     wherever a warp's rows hit in different columns, most of the scan's
//     time on ordered atoms); then the thread takes its bits in ascending
//     order, j != i tested only there (the self pair's d^2 is 0).  A hit
//     is appended to the row's list for the split, its first 32 in shared
//     memory (a column of the block's [32][128] table, conflict-free), the
//     rest straight to hits[(split k + c) N + i] (c < k); at the end each
//     thread writes its list there, the block's rows side by side
//     (coalesced).  The split's count goes to cnt[split N + i].
//   * The cull: the block's valid rows and each stage's valid columns
//     have bounding boxes (warp shuffles, then the four warps' boxes
//     through shared memory under the stage's own barrier); a stage whose
//     box lies farther than the cutoff from the rows' box (its gap squared
//     above 1.001 cutoff^2, far beyond the rounding of any d^2 under the
//     cutoff) is not scanned.  It skips only pairs that cannot be hits, so
//     the lists are unchanged.  It helps where atoms come in spatial order
//     (a lattice-ordered water box: a block's rows and a stage's columns
//     are each a small region); on shuffled atoms every box spans the
//     whole system and nothing is culled (chip_smoke.py times both).
//   * nc_merge: a warp a row; lane s takes split s's count, a shuffle scan
//     gives each split its first slot, and each lane copies its split's
//     hits (the first k over the splits in order), then the warp fills the
//     unused slots with 0 / 0.
// Both are deterministic: the lists are a function of the data alone.
#include "common.cuh"

namespace {

constexpr int kRows = 128;    // threads a scan block: one row each
constexpr int kStage = 128;   // columns staged at a time: one a thread
constexpr int kWarps = kRows / 32;
constexpr int kList = 32;     // hits a row keeps in shared memory
constexpr float kFar = 1e18f;  // where a masked column is staged
constexpr int kMergeWarps = 8;

// the bounding box (lo x, y, z, hi x, y, z) over a warp of points, each
// lane's point counted if v (else it adds nothing: +inf / -inf)
__device__ __forceinline__ void warp_box(float x, float y, float z, bool v,
                                         float (&b)[6]) {
  const float inf = __int_as_float(0x7f800000);
  b[0] = v ? x : inf;
  b[1] = v ? y : inf;
  b[2] = v ? z : inf;
  b[3] = v ? x : -inf;
  b[4] = v ? y : -inf;
  b[5] = v ? z : -inf;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      const float o = __shfl_xor_sync(0xffffffffu, b[a], d);
      b[a] = a < 3 ? fminf(b[a], o) : fmaxf(b[a], o);
    }
}

// the block's box from its warps' boxes in shared memory
__device__ __forceinline__ void block_box(const float (*wb)[6],
                                          float (&b)[6]) {
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    b[a] = wb[0][a];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      b[a] = a < 3 ? fminf(b[a], wb[w][a]) : fmaxf(b[a], wb[w][a]);
  }
}

// whether two boxes are farther apart than the cutoff, with a margin far
// beyond rounding (an empty box is +inf / -inf: always apart)
__device__ __forceinline__ bool apart(const float (&r)[6], const float (&c)[6],
                                      float cutoff2) {
  float gap2 = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float g = fmaxf(0.0f, fmaxf(c[a] - r[a + 3], r[a] - c[a + 3]));
    gap2 += g * g;
  }
  return gap2 > 1.001f * cutoff2;
}

__global__ void __launch_bounds__(kRows)
nc_scan(const float* __restrict__ xyz, const float* __restrict__ mask,
        int* __restrict__ cnt, int* __restrict__ hits, int N, int K,
        int cols_per_split, float cutoff2) {
  __shared__ float4 s_col[2][kStage];
  __shared__ float s_box[3][kWarps][6];  // rows; stage columns, two slots
  __shared__ int s_list[kList][kRows];   // each row's first hits
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kRows + threadIdx.x;
  const int split = blockIdx.y;
  const int j0 = split * cols_per_split;
  const int j1 = min(N, j0 + cols_per_split);
  const int stages = (j1 - j0 + kStage - 1) / kStage;
  const bool live = i < N && mask[i] > 0.0f;
  const float xi = live ? xyz[(size_t)i * 3 + 0] : 0.0f;
  const float yi = live ? xyz[(size_t)i * 3 + 1] : 0.0f;
  const float zi = live ? xyz[(size_t)i * 3 + 2] : 0.0f;
  float rbox[6];
  warp_box(xi, yi, zi, live, rbox);
  if (lane == 0)
#pragma unroll
    for (int a = 0; a < 6; ++a) s_box[0][warp][a] = rbox[a];

  // this thread's column of stage st, as loaded (folded when stored)
  float cx, cy, cz, cm;
  auto fetch = [&](int st) {
    const int j = j0 + st * kStage + threadIdx.x;
    const bool in = j < j1;
    cx = in ? xyz[(size_t)j * 3 + 0] : 0.0f;
    cy = in ? xyz[(size_t)j * 3 + 1] : 0.0f;
    cz = in ? xyz[(size_t)j * 3 + 2] : 0.0f;
    cm = in ? mask[j] : 0.0f;
  };
  fetch(0);
  int c = 0;
  int* const out = hits + (size_t)split * K * N + i;
  for (int st = 0; st < stages; ++st) {
    float4* col = s_col[st & 1];
    const bool vc = cm > 0.0f;
    float cbox[6];
    warp_box(cx, cy, cz, vc, cbox);
    // the slots were last read in stage st - 2, before the barrier of
    // st - 1
    col[threadIdx.x] = vc ? make_float4(cx, cy, cz, 0.0f)
                          : make_float4(kFar, kFar, kFar, 0.0f);
    if (lane == 0)
#pragma unroll
      for (int a = 0; a < 6; ++a) s_box[1 + (st & 1)][warp][a] = cbox[a];
    __syncthreads();
    if (st + 1 < stages) fetch(st + 1);
    block_box(s_box[0], rbox);
    block_box(s_box[1 + (st & 1)], cbox);
    if (live && !apart(rbox, cbox, cutoff2)) {
      for (int g0 = 0; g0 < kStage; g0 += 32) {
        // the group's hits as bits, without a branch a column
        unsigned m = 0;
#pragma unroll
        for (int q = 0; q < 32; ++q) {
          const float4 p = col[g0 + q];
          if (epnn::pair_d2(xi, yi, zi, p.x, p.y, p.z) < cutoff2)
            m |= 1u << q;
        }
        const int jb = j0 + st * kStage + g0;
        while (m) {  // ascending columns
          const int j = jb + __ffs(m) - 1;
          m &= m - 1;
          if (j != i) {
            if (c < K) {
              if (c < kList)
                s_list[c][threadIdx.x] = j;
              else
                out[(size_t)c * N] = j;
            }
            ++c;
          }
        }
      }
    }
  }
  if (i >= N) return;
  const int kept = min(min(c, K), kList);
  for (int q = 0; q < kept; ++q) out[(size_t)q * N] = s_list[q][threadIdx.x];
  cnt[(size_t)split * N + i] = c;
}

__global__ void __launch_bounds__(32 * kMergeWarps)
nc_merge(const int* __restrict__ cnt, const int* __restrict__ hits,
         long long* __restrict__ idx, float* __restrict__ nmask, int N,
         int K, int splits) {
  const int i = blockIdx.x * kMergeWarps + (threadIdx.x >> 5);
  if (i >= N) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  long long* const row = idx + (size_t)i * K;
  float* const mrow = nmask + (size_t)i * K;
  int base = 0;  // slots filled by the splits before s0
  for (int s0 = 0; s0 < splits && base < K; s0 += 32) {
    const int s = s0 + lane;
    const int n = s < splits ? min(cnt[(size_t)s * N + i], K) : 0;
    int incl = n;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    const int first = base + incl - n;
    for (int q = 0; q < n && first + q < K; ++q) {
      row[first + q] = hits[((size_t)s * K + q) * N + i];
      mrow[first + q] = 1.0f;
    }
    base += __shfl_sync(0xffffffffu, incl, 31);
  }
  for (int o = min(base, K) + lane; o < K; o += 32) {
    row[o] = 0;
    mrow[o] = 0.0f;
  }
}

}  // namespace

// xyz (N, 3), mask (N,); work: int32 scratch of splits * N * (K + 1); idx
// (N, K) int64 and nmask (N, K) out; the columns split into ranges of
// cols_per_split; cutoff2 the squared cutoff in float32.  Returns
// cudaGetLastError().
extern "C" int epnn_neighbor_compact(const float* xyz, const float* mask,
                                     int* work, long long* idx, float* nmask,
                                     int N, int K, int splits,
                                     int cols_per_split, float cutoff2,
                                     cudaStream_t stream) {
  if (N <= 0 || K <= 0 || splits <= 0 || cols_per_split <= 0 ||
      (long long)(splits - 1) * cols_per_split >= N ||
      (long long)splits * N * (K + 1) > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  int* cnt = work;
  int* hits = work + (size_t)splits * N;
  nc_scan<<<dim3((N + kRows - 1) / kRows, splits), kRows, 0, stream>>>(
      xyz, mask, cnt, hits, N, K, cols_per_split, cutoff2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  nc_merge<<<(N + kMergeWarps - 1) / kMergeWarps, 32 * kMergeWarps, 0,
             stream>>>(cnt, hits, idx, nmask, N, K, splits);
  return cudaGetLastError();
}
