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
// What bounds it on the H100: bytes, and the latency of dependent loads.
// The function must read eu, ev (4 B each per edge), write c (4 B per
// edge) and read nbr once ((V+1)*K*4 B): that compulsory traffic over
// 3.35 TB/s is the bound.  But every edge gathers two rows, and nbr (about
// 1 GB for the 2^24-vertex graph) does not fit the 50 MB L2, so a row that
// misses L2 costs up to K*4 B more per endpoint; and a binary search is a
// chain of dependent loads.  The design keeps many independent chains in
// flight rather than moving fewer bytes:
//   * A group of G lanes owns one edge; a warp holds 32/G edges.  The
//     wrapper picks G, the power of two at or above K/16 (between 2 and
//     32), as the superstep wrapper does.
//   * Each lane finds both rows' lengths (the first sentinel, by binary
//     search: rows are sorted with the sentinel last), takes every G-th
//     slot of the shorter row, and binary-searches it in the longer one.
//     A lane's slots ascend, so each search starts where the lane's
//     previous one ended.  Work per edge is min(len) * log(max(len)),
//     not the K*K all-pairs compare of the TPU kernel.
//   * The lanes' counts are summed with xor shuffles inside the group;
//     lane 0 of the group stores.  Nothing is allocated and nothing
//     synchronises; the launch goes to the caller's stream and the entry
//     point returns cudaGetLastError().
//   * eu/ev are clamped into [0, rows) before the row is addressed, as the
//     plain version clamps them, so a bad index cannot read past nbr.
//     Padding edges carry eu = ev = V and gather the all-sentinel row V:
//     both lengths are 0 and they count 0.
//
// TPU-only behaviour left out on purpose: the [chunk, K] row tiles that the
// reference gathers into device memory before each call (this kernel reads
// nbr in place, through the read-only path); the host loop over chunks of
// 2^18 edges with one device-to-host copy per chunk (one launch covers
// every edge, and the total stays on the device); the padding of edges to
// 256 and K to 128 lanes (the kernel masks its ragged edge itself); and
// MAX_KERNEL_K = 2048 with its fallback to the reference, a VMEM bound of
// the (R, K) tiles that does not exist here: the kernel takes any K.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

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

__global__ void __launch_bounds__(kThreads) intersect_kernel(
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
    int u = __ldg(eu + e);
    int v = __ldg(ev + e);
    u = u < 0 ? 0 : (u >= rows ? rows - 1 : u);
    v = v < 0 ? 0 : (v >= rows ? rows - 1 : v);
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
  if (live && sub == 0) {
    out[e] = count;
  }
}

}  // namespace

// C entry point (bound with ctypes).  Every pointer and the stream come in
// as void*; the return value is cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue / cudaErrorInvalidConfiguration for
// arguments this file does not take.
extern "C" int ell_intersect(const void* nbr, const void* eu, const void* ev,
                             void* out, long long E, long long K,
                             long long rows, long long sentinel,
                             int lanes_log2, void* stream) {
  if (E <= 0) return 0;
  if (K < 0 || K > INT_MAX || rows < 1 || rows > INT_MAX ||
      sentinel < INT_MIN || sentinel > INT_MAX || lanes_log2 < 0 ||
      lanes_log2 > 5) {
    return cudaErrorInvalidValue;
  }
  const long long blocks = ((E << lanes_log2) + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  intersect_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nbr), static_cast<const int*>(eu),
      static_cast<const int*>(ev), static_cast<int*>(out), E,
      static_cast<int>(K), static_cast<int>(rows),
      static_cast<int>(sentinel), lanes_log2);
  return static_cast<int>(cudaGetLastError());
}
