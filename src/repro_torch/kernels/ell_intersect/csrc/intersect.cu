// Sorted-row intersection counts for degree-ordered triangle counting, for
// Hopper (sm_90a).
//
//     c[e] = | nbr[eu[e]] ∩ nbr[ev[e]] |
//
// over rows that are sorted ascending, deduplicated and padded with the
// sentinel, which is greater than every valid id and never matches.
// Summed over the oriented edges of an OrientedELL, c is the triangle
// count.
//
// Replaces the TPU kernel src/repro/kernels/ell_intersect/kernel.py:43
// (_intersect_kernel, launched by ell_intersect_pallas).  The plain
// PyTorch version is ref.py (ell_intersect_plain for two row matrices,
// ell_intersect_counts_plain for an OrientedELL); ops.py checks arguments,
// allocates the output and launches this file's entry point through ctypes.
//
// What bounds it on the H100: bytes.  The function must read eu, ev (4 B
// each per edge), write c (4 B per edge) and read each row's ids once;
// about two comparisons per id, far below the card's operation rate.  But
// every edge gathers two rows, and nbr (about 0.6 GB for the 2^24-vertex
// graph) does not fit the 50 MB L2, so the loads' pattern and the
// instructions spent per edge decide how close a kernel comes.
//
// Two paths, chosen by the wrapper from K (ops.py:_lanes_log2):
//   * K <= 32 (the main path; K = 9 at 2^24): a lane an edge, a task of
//     32 consecutive edges a warp, nothing synchronised beyond the warp.
//     The task's eu/ev are loaded coalesced and clamped into [0, rows).
//     Edges come grouped by eu, so the warp marks where a run of one eu
//     starts (a ballot) and copies each run's row u once, and each
//     distinct row v once (edges that share v match), into shared memory
//     with cp.async: a row as the aligned
//     16-byte pieces that cover it (3 for K = 9), lanes on a row's
//     neighbouring pieces, 32/pieces rows a step; every copy of the task
//     in flight at once and none holding a register.  A piece that would
//     reach past either end of nbr goes id by id.  Each lane then merges
//     its two rows: one comparison a step, stopping at the first sentinel
//     of either row (rows are sorted with the sentinel last, so no length
//     is needed), about len(u) + len(v) steps and no dependent search.  c
//     is stored coalesced.
//   * K > 32 (hub-heavy orientations, and the two-row-matrix form up to
//     any K): a group of G lanes an edge (the wrapper picks G, the power
//     of two at or above K/16, between 2 and 32).  Both rows' lengths come
//     from a binary search for the first sentinel; each lane takes every
//     G-th id of the shorter row and binary-searches it in the longer
//     one, each search starting where the lane's previous one ended; a
//     sum over the group gives c.
//   * Both paths clamp eu/ev into [0, rows) before a row is addressed, as
//     the plain version does, so a bad index cannot read past nbr.
//     Padding edges carry eu = ev = V and gather the all-sentinel row V:
//     they count 0.  Counts are exact int32.  Nothing is allocated; the
//     launch goes to the caller's stream and the entry point returns
//     cudaGetLastError().
//
// TPU-only behaviour left out on purpose: the [chunk, K] row tiles that the
// reference gathers into device memory before each call (this kernel reads
// nbr in place); the host loop over chunks of 2^18 edges with one
// device-to-host copy per chunk (one launch covers every edge, and the
// total stays on the device); the padding of edges to 256 and K to 128
// lanes (the kernel masks its ragged edge itself); and MAX_KERNEL_K = 2048
// with its fallback to the reference, a VMEM bound that does not exist
// here: the kernel takes any K.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStagedMaxK = 32;

__device__ __forceinline__ int clamp_row(int r, int rows) {
  return r < 0 ? 0 : (r >= rows ? rows - 1 : r);
}

__device__ __forceinline__ void cp_async4(int* smem, const int* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async16(int* smem, const int* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// A row of K ids is copied as the aligned 16-byte pieces that cover it:
// at most pieces_of(K), whatever its alignment; in shared memory it keeps
// its offset within the first piece, rows row_ints(K) apart.
__host__ __device__ __forceinline__ int pieces_of(int K) {
  return (4 * K + 12 + 15) / 16;
}
__host__ __device__ __forceinline__ int row_ints(int K) {
  return 4 * pieces_of(K);
}
// Where row r starts within its first aligned 16-byte piece, in ids.
__device__ __forceinline__ int offset_in_piece(const int* nbr, int r, int K) {
  return static_cast<int>(
      (reinterpret_cast<uintptr_t>(nbr + static_cast<long long>(r) * K) >> 2) &
      3);
}
// Shared memory of one warp, in ints: 64 rows (the task's runs' rows u in
// the first 32, its edges' rows v in the last 32) and their 64 ids.
__host__ __device__ __forceinline__ int warp_ints(int K) {
  return 64 * row_ints(K) + 64;
}

__global__ void __launch_bounds__(kThreads) intersect_staged_kernel(
    const int* __restrict__ nbr, const int* __restrict__ eu,
    const int* __restrict__ ev, int* __restrict__ out, long long E, int K,
    int rows, int sentinel) {
  extern __shared__ __align__(16) int smem[];
  const int RS = row_ints(K), P = pieces_of(K);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* const row = smem + warp * warp_ints(K);
  int* const ids = row + 64 * RS;
  const int* const nbr_end = nbr + static_cast<long long>(rows) * K;
  const long long e0 = (static_cast<long long>(blockIdx.x) * kWarps + warp)
                       * 32;
  if (e0 >= E) return;                      // the whole warp leaves
  const long long left = E - e0;
  const int n = left < 32 ? static_cast<int>(left) : 32;
  const bool live = lane < n;
  int u = -1, v = 0;
  if (live) {
    u = clamp_row(__ldg(eu + e0 + lane), rows);
    v = clamp_row(__ldg(ev + e0 + lane), rows);
  }
  // runs of one eu: the first edge of a run (in this task) is its head
  const int prev = __shfl_up_sync(0xffffffffu, u, 1);
  const bool head = live && (lane == 0 || prev != u);
  const unsigned heads = __ballot_sync(0xffffffffu, head);
  const int run = __popc(heads & ((2u << lane) - 1u)) - 1;  // heads up to me
  const int runs = __popc(heads);
  if (head) ids[run] = u;
  // edges of the task that share a row v share its copy: the first of
  // them (the leader) numbers it
  const unsigned same = __match_any_sync(0xffffffffu, live ? v : -1);
  const int lead = __ffs(same) - 1;
  const bool leader = live && lane == lead;
  const unsigned leaders = __ballot_sync(0xffffffffu, leader);
  const int vrow = __shfl_sync(0xffffffffu,
                               __popc(leaders & ((1u << lane) - 1u)), lead);
  if (leader) ids[32 + vrow] = v;
  __syncwarp();
  // copy row u once per run and row v once per edge with cp.async (every
  // copy of the warp in flight at once, none holding a register): the
  // lanes on a row's neighbouring 16-byte pieces, 32/P rows a step; a
  // piece that sticks out of nbr (only at its ends) goes id by id
  const int per = 32 / P;
  const int lr = lane / P, lc = lane - lr * P;
  const int jobs = runs + __popc(leaders);
  if (lr < per) {
    for (int i = lr; i < jobs; i += per) {
      const int slot = i < runs ? i : 32 + i - runs;
      const int* const first = nbr + static_cast<long long>(ids[slot]) * K;
      const int* const src = reinterpret_cast<const int*>(
          reinterpret_cast<uintptr_t>(first) & ~static_cast<uintptr_t>(15)) +
          4 * lc;
      int* const dst = row + slot * RS + 4 * lc;
      if (src >= nbr && src + 4 <= nbr_end) {
        cp_async16(dst, src);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (src + q >= nbr && src + q < nbr_end) cp_async4(dst + q, src + q);
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();
  if (!live) return;
  // each row from its offset within its first piece
  const int* a = row + run * RS + offset_in_piece(nbr, u, K);
  const int* b = row + (32 + vrow) * RS + offset_in_piece(nbr, v, K);
  int i = 0, j = 0, count = 0;
  while (i < K && j < K) {
    const int x = a[i], y = b[j];
    if (x == sentinel || y == sentinel) break;
    count += x == y ? 1 : 0;
    i += x <= y ? 1 : 0;
    j += y <= x ? 1 : 0;
  }
  out[e0 + lane] = count;
}

// First index in row[lo, n) whose value is not below key.
__device__ __forceinline__ int lower_bound(const int* __restrict__ row,
                                           int lo, int n, int key) {
  int hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(row + mid) < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads) intersect_search_kernel(
    const int* __restrict__ nbr, const int* __restrict__ eu,
    const int* __restrict__ ev, int* __restrict__ out, long long E, int K,
    int rows, int sentinel, int lanes_log2) {
  const int group = 1 << lanes_log2;
  const int sub = threadIdx.x & (group - 1);
  const long long e =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >>
      lanes_log2;
  const bool live = e < E;
  int count = 0;
  if (live) {
    const int u = clamp_row(__ldg(eu + e), rows);
    const int v = clamp_row(__ldg(ev + e), rows);
    const int* a = nbr + static_cast<long long>(u) * K;
    const int* b = nbr + static_cast<long long>(v) * K;
    int na = lower_bound(a, 0, K, sentinel);
    int nb = lower_bound(b, 0, K, sentinel);
    if (nb < na) {  // walk the shorter row, search the longer one
      const int* t = a;
      a = b;
      b = t;
      const int tn = na;
      na = nb;
      nb = tn;
    }
    int lo = 0;
    for (int j = sub; j < na && lo < nb; j += group) {
      const int x = __ldg(a + j);
      lo = lower_bound(b, lo, nb, x);
      count += (lo < nb && __ldg(b + lo) == x) ? 1 : 0;
    }
  }
  // every lane of the warp reaches the shuffles (no early return above)
  for (int o = group >> 1; o > 0; o >>= 1) {
    count += __shfl_xor_sync(0xffffffffu, count, o);
  }
  if (live && sub == 0) out[e] = count;
}

}  // namespace

// C entry point (bound with ctypes).  Every pointer and the stream come in
// as void*; lanes_log2 (ops.py:_lanes_log2) is 0 for the staged path (a
// lane an edge, K <= 32) and log2 of the lanes an edge of the search
// path otherwise.  Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue / cudaErrorInvalidConfiguration for
// arguments this file does not take.
extern "C" int ell_intersect(const void* nbr, const void* eu, const void* ev,
                             void* out, long long E, long long K,
                             long long rows, long long sentinel,
                             int lanes_log2, void* stream) {
  if (E <= 0) return 0;
  if (K < 0 || K > INT_MAX || rows < 1 || rows > INT_MAX ||
      sentinel < INT_MIN || sentinel > INT_MAX || lanes_log2 < 0 ||
      lanes_log2 > 5 || (lanes_log2 == 0 && (K < 1 || K > kStagedMaxK))) {
    return cudaErrorInvalidValue;
  }
  const int k = static_cast<int>(K);
  const auto* n = static_cast<const int*>(nbr);
  const auto* u = static_cast<const int*>(eu);
  const auto* v = static_cast<const int*>(ev);
  auto* o = static_cast<int*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes_log2 == 0) {
    // above 48 KB of shared memory only after opting in, once a device
    // (a benign race: concurrent first calls set the same value)
    static bool opted[64] = {false};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
    if (!opted[dev]) {
      err = cudaFuncSetAttribute(
          intersect_staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kWarps * warp_ints(kStagedMaxK) * static_cast<int>(sizeof(int)));
      if (err != cudaSuccess) return err;
      opted[dev] = true;
    }
    const long long blocks = (E + kThreads - 1) / kThreads;  // 32 edges a warp
    if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
    intersect_staged_kernel<<<static_cast<unsigned>(blocks), kThreads,
                              kWarps * warp_ints(k) * sizeof(int), s>>>(
        n, u, v, o, E, k, static_cast<int>(rows),
        static_cast<int>(sentinel));
  } else {
    const long long blocks = ((E << lanes_log2) + kThreads - 1) / kThreads;
    if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
    intersect_search_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                              s>>>(n, u, v, o, E, k, static_cast<int>(rows),
                                   static_cast<int>(sentinel), lanes_log2);
  }
  return static_cast<int>(cudaGetLastError());
}
