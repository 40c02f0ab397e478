// ELL gather + monoid combine (ell_spmv) for Hopper (sm_90a).
//
//     y[v] = sum_k  (mask[v,k] ? w[v,k] * x[nbr[v,k]] : 0)        (sum)
//     y[v] = min_k / max_k (mask[v,k] ? x[nbr[v,k]] : +-inf)      (min/max)
//
// Replaces the TPU kernel src/repro/kernels/ell_combine/kernel.py:37
// (_ell_kernel, launched by ell_combine_pallas).  The plain PyTorch
// version is ref.py:ell_combine_plain; ops.py:ell_spmv checks arguments,
// allocates the output and launches this file's entry point via ctypes.
//
// What bounds it on the H100: bytes.  The function takes a bool [V, K]
// mask in which any slot may be live, so the whole mask must be read
// (V * K bytes); nbr and, for sum, w are needed only at the live slots;
// x is gathered once per live slot and y written once.  On the capped
// ELL of the main path (V = 2^24, K = 128, ~7.7 live slots a row) the
// mask alone is 2.15 GB, 0.64 ms at 3.35 TB/s.  torch.sparse.mm over a
// prebuilt CSR of the same live slots reads no mask at all, so no kernel
// of this function can match it there: the mask costs more than that
// call takes for everything.  Nor do a row's live ids and weights come
// at 4 bytes a slot: they are the first few of its 512-byte rows of nbr
// and w, and device memory serves each row's run as whole sectors.
//
// Design, for few instructions per mask byte and coalesced gathers:
//   * A warp owns 32 rows, one a lane.  A lane reads its row's mask in
//     aligned 16-byte windows, 8 at once (all 128 bytes of an aligned
//     row of K = 128; a ragged or longer row in batches, its bytes
//     outside the row masked off as bits).  Only a window that sticks out
//     of the tensor itself (an unaligned first or last row) is read byte
//     by byte.  A window with no live byte costs one test.
//   * Each lane turns its windows into bitmaps of live slots; a prefix
//     sum over the warp (shuffles) places every lane's live slots in one
//     list in shared memory, row after row (at most kList a pass; more
//     take further passes).  Nothing assumes live slots form a prefix of
//     the row: holes are listed the same way.
//   * The warp then gathers the list with neighbouring lanes on
//     neighbouring entries, so a row's live ids and weights are read
//     together, coalesced, and kGather loads are in flight a lane.  Only
//     a live slot loads nbr and w and gathers x.  nbr is clamped into
//     [0, Vx) before the gather, as the plain version clamps.  Each value
//     goes back into the list in place.
//   * Each lane then combines its own row's values in slot order, so a
//     sum's order is fixed.  sum uses where(mask, w * x, 0): a dead slot
//     is never multiplied, so an inf or NaN of x behind a dead slot
//     cannot reach the sum.  min and max select among exactly the plain
//     version's values (NaN propagates, as torch.amin/amax), so they are
//     bit-identical; a sum differs from it only in summation order.
//   * Nothing is allocated and nothing synchronises; the launch goes to
//     the caller's stream, and the entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

enum Op { SUM = 0, MIN = 1, MAX = 2 };

constexpr int kThreads = 256;
constexpr int kWindow = 16;              // mask bytes per vector load
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;                // windows a lane loads at once
constexpr int kList = 512;               // live slots a warp gathers per pass
constexpr int kGather = 4;               // gathers in flight a lane

template <int OP>
__device__ __forceinline__ float neutral() {
  return OP == SUM ? 0.f : (OP == MIN ? INFINITY : -INFINITY);
}

template <int OP>
__device__ __forceinline__ float combine(float a, float b) {
  if constexpr (OP == SUM) {
    return __fadd_rn(a, b);
  } else if constexpr (OP == MIN) {
    return (isnan(b) || b < a) ? b : a;
  } else {
    return (isnan(b) || b > a) ? b : a;
  }
}

// Live-slot bits of the 16 mask bytes in v: bit i for byte i nonzero.
__device__ __forceinline__ uint32_t vector_bits(uint4 v) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
  uint32_t bits = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    // the top bit of each byte set where the byte is nonzero; the product
    // moves bits 7, 15, 23, 31 to bits 28-31 (its other partial products
    // land on distinct bits below 24 or above 31, so nothing carries)
    const uint32_t t =
        (((words[q] & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | words[q]) & 0x80808080u;
    bits |= ((t * 0x00204081u) >> 28) << (4 * q);
  }
  return bits;
}

// The aligned window at wp, as loaded: zeros when it holds no byte of the
// row [lo, hi); one vector load when it lies inside the tensor [begin,
// end); else (the tensor's own unaligned first or last window) the row's
// bytes one by one, so nothing outside the tensor is touched.
__device__ __forceinline__ uint4 load_window(const uint8_t* wp,
                                             const uint8_t* lo,
                                             const uint8_t* hi,
                                             const uint8_t* begin,
                                             const uint8_t* end) {
  if (lo >= hi || wp >= hi || wp + kWindow <= lo) {
    return make_uint4(0, 0, 0, 0);
  }
  if (wp >= begin && wp + kWindow <= end) {
    return __ldg(reinterpret_cast<const uint4*>(wp));
  }
  uint32_t words[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < kWindow; ++i) {
    const uint8_t* p = wp + i;
    if (p >= lo && p < hi && *p) words[i >> 2] |= 1u << (8 * (i & 3));
  }
  return make_uint4(words[0], words[1], words[2], words[3]);
}

// Bits of the window at wp that fall inside the row [lo, hi).
__device__ __forceinline__ uint32_t row_bits(const uint8_t* wp,
                                             const uint8_t* lo,
                                             const uint8_t* hi) {
  const long long b = lo - wp;
  const long long e = hi - wp;
  const int beg = b < 0 ? 0 : (b > kWindow ? kWindow : static_cast<int>(b));
  const int end = e < 0 ? 0 : (e > kWindow ? kWindow : static_cast<int>(e));
  return ((1u << end) - 1u) & ~((1u << beg) - 1u);
}

template <int OP>
__global__ void __launch_bounds__(kThreads) ell_combine_kernel(
    const int* __restrict__ nbr, const uint8_t* __restrict__ mask,
    const float* __restrict__ w, const float* __restrict__ x,
    float* __restrict__ out, long long V, int K, int Vx) {
  // per warp: a pass's live slots (each as its flat index less the
  // warp's first row's), which the gathers then overwrite with values
  __shared__ int list[kWarps][kList];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* const slots = list[warp];
  const long long row0 = (static_cast<long long>(blockIdx.x) * kWarps + warp)
                         * 32;
  const long long row = row0 + lane;                // this lane's row
  const bool live_row = row < V;
  const uint8_t* const end = mask + V * K;
  const uint8_t* const lo = mask + (live_row ? row * K : 0);
  const uint8_t* const hi = live_row ? lo + K : lo;   // [lo, hi): the row
  const uint8_t* const first = reinterpret_cast<const uint8_t*>(
      reinterpret_cast<uintptr_t>(lo) & ~static_cast<uintptr_t>(kWindow - 1));
  const int lane_at = lane * K;      // the row's flat index less row0's
  const long long warp_at = row0 * K;
  // every lane runs the warp's largest count of batches, so the
  // shuffles and __syncwarp below see the whole warp
  const int batches = __reduce_max_sync(
      0xffffffffu,
      static_cast<int>((hi - first + kBatch * kWindow - 1) /
                       (kBatch * kWindow)));
  float acc = neutral<OP>();
  for (int bt = 0; bt < batches; ++bt) {
    const uint8_t* const chunk = first + bt * kBatch * kWindow;
    uint32_t bits[kBatch];
    if (chunk >= lo && chunk + kBatch * kWindow <= hi) {
      // the whole batch inside the row (every window of an aligned row
      // of K = 128): kBatch loads in flight at once
      uint4 raw[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        raw[i] = __ldg(reinterpret_cast<const uint4*>(chunk) + i);
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const uint4 v = raw[i];
        bits[i] = (v.x | v.y | v.z | v.w) ? vector_bits(v) : 0u;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const uint8_t* wp = chunk + i * kWindow;
        bits[i] = vector_bits(load_window(wp, lo, hi, mask, end)) &
                  row_bits(wp, lo, hi);
      }
    }
    // the warp's live slots of this batch, row by row: this lane's are
    // [start, start + n)
    int n = 0;
#pragma unroll
    for (int i = 0; i < kBatch; ++i) n += __popc(bits[i]);
    int start = n;                                  // inclusive prefix
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, start, o);
      if (lane >= o) start += t;
    }
    const int total = __shfl_sync(0xffffffffu, start, 31);
    start -= n;
    for (int p0 = 0; p0 < total; p0 += kList) {
      const int m = min(total - p0, kList);
      // this lane lists its live slots that fall in the pass
      int at = start;
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int at0 = lane_at + static_cast<int>(chunk - lo) + i * kWindow;
        for (uint32_t b = bits[i]; b; b &= b - 1, ++at) {
          if (at >= p0 && at < p0 + m) slots[at - p0] = at0 + __ffs(b) - 1;
        }
      }
      __syncwarp();
      // the warp gathers the pass's slots, neighbouring lanes on
      // neighbouring slots (a row's live ids and weights in one
      // coalesced read), kGather per lane in flight at once
      for (int e = lane; e < m; e += 32 * kGather) {
        float val[kGather];
#pragma unroll
        for (int u = 0; u < kGather; ++u) {
          const int idx = e + 32 * u;
          if (idx < m) {
            const long long a = warp_at + slots[idx];
            int j = __ldg(nbr + a);
            j = j < 0 ? 0 : (j >= Vx ? Vx - 1 : j);
            float v = __ldg(x + j);
            if constexpr (OP == SUM) v = __fmul_rn(v, __ldg(w + a));
            val[u] = v;
          }
        }
#pragma unroll
        for (int u = 0; u < kGather; ++u) {
          if (e + 32 * u < m) slots[e + 32 * u] = __float_as_int(val[u]);
        }
      }
      __syncwarp();
      // each lane combines its own row's values, in slot order
      const int a = max(start, p0) - p0;
      const int z = min(start + n, p0 + m) - p0;
      for (int k = a; k < z; ++k) {
        acc = combine<OP>(acc, __int_as_float(slots[k]));
      }
      __syncwarp();                     // the list is free for the next pass
    }
  }
  if (live_row) out[row] = acc;
}

template <int OP>
int launch(const int* n, const uint8_t* m, const float* wp, const float* xp,
           float* o, long long V, int k, int vx, cudaStream_t s) {
  const long long blocks = (V + kThreads - 1) / kThreads;   // a row a lane
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  ell_combine_kernel<OP><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      n, m, wp, xp, o, V, k, vx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point (bound with ctypes).  mask is [V, K] bool (one byte a
// slot), nbr [V, K] int32, w [V, K] float32 (read for op 0 only), x
// [Vx] float32, out [V] float32; op: 0 sum, 1 min, 2 max.  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue / cudaErrorInvalidConfiguration for arguments
// this file does not take.
extern "C" int ell_combine(const void* nbr, const void* mask, const void* w,
                           const void* x, void* out, long long V, long long K,
                           long long Vx, int op, void* stream) {
  if (V <= 0) return 0;
  if (K < 0 || K > INT_MAX / 32 || Vx < 1 || Vx > INT_MAX) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* n = static_cast<const int*>(nbr);
  const auto* m = static_cast<const uint8_t*>(mask);
  const auto* wp = static_cast<const float*>(w);
  const auto* xp = static_cast<const float*>(x);
  auto* o = static_cast<float*>(out);
  const int k = static_cast<int>(K), vx = static_cast<int>(Vx);
  switch (op) {
    case SUM:
      return launch<SUM>(n, m, wp, xp, o, V, k, vx, s);
    case MIN:
      return launch<MIN>(n, m, wp, xp, o, V, k, vx, s);
    case MAX:
      return launch<MAX>(n, m, wp, xp, o, V, k, vx, s);
    default:
      return cudaErrorInvalidValue;
  }
}
