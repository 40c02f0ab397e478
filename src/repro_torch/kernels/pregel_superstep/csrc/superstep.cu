// Fused Pregel superstep over the in-neighbour ELL layout, for Hopper (sm_90a).
//
//     agg[v] = reduce_k( op, mask[v,k] ? cast(message(x[nbr[v,k]], w[v,k]))
//                                      : fill )
//
// Replaces the TPU kernel src/repro/kernels/pregel_superstep/kernel.py:43
// (_superstep_kernel, launched by superstep_pallas).  The plain PyTorch
// version is ref.py:superstep_plain; ops.py:fused_superstep is the wrapper
// that checks arguments, allocates the output and launches this file's
// entry point through ctypes.
//
// What bounds it on the H100: bytes.  The function takes a bool [V, K]
// mask in which any slot may be live, so the whole mask must be read (1 B
// a slot); nbr (4 B) and, for the programs that use it, w (4 B) are
// needed only at the live slots; x is gathered once per live slot and the
// output written once.  About one operation per byte, far below the
// card's operations-per-byte balance, so the least time is bytes over
// 3.35 TB/s.  On the main path's in-ELL (V = 2^24, K = 19, 7.75 live
// slots a row, packed left) reading nbr at every slot would cost 1.27 GB,
// more than the whole bound; reading it at the live slots only costs the
// 32-byte sectors that hold them.
//
// Design: the slots stream through, coalesced and vectorised, with few
// dependent steps and many loads in flight.
//   * A block owns a tile of R consecutive rows (the wrapper picks R: as
//     many as fit kPiece = 2048 slots, a multiple of 4 from 4 up, so a
//     tile's slots are one contiguous, 4-aligned run of the flat [V, K]
//     arrays whatever K is; a row longer than a piece is a tile of its
//     own, walked piece by piece).  Blocks walk the tiles grid-stride, a
//     few resident on each SM.
//   * A thread takes 4-slot groups, neighbouring threads on neighbouring
//     groups: the group's 4 mask bytes as one 32-bit load, and its ids
//     (and weights) as one 16-byte load only when a slot of the group is
//     live, so a row's dead tail costs no nbr/w traffic.  These streamed
//     loads are marked evict-first (__ldcs), leaving L2 to x.  Then x is
//     gathered at the live slots, all of a thread's groups in flight at
//     once: two dependent steps per tile, mask and ids, then x.  Arrays
//     that are not aligned (a view at an odd offset) and a tile's ragged
//     last group are read slot by slot.
//   * nbr is clamped into [0, Vx) at live slots only (padding carries the
//     sentinel V, and Vx may be V).  The edge program is one of four
//     compiled programs (x, x+1, x+w, x*w), written with _rn intrinsics so
//     that the compiler cannot fuse it into the reduction; the message is
//     cast to the output type (the reduced-precision channel: bf16/f16
//     round to nearest even, as torch's .to() does).  A dead slot holds
//     the fill.  Each slot's value goes to shared memory in slot order.
//   * One thread then combines each row's K values in slot order.
//     min/max select among exactly the plain version's values, NaN
//     propagating as torch.amin/amax, so they are bit-identical; a float
//     sum has a fixed order, so repeated calls give the same bytes, and
//     differs from the plain version only in summation order.  int32 sums
//     wrap.  bf16/f16 accumulate in float32 and round once at the end, as
//     torch's reductions do.
//   * Offsets into [V, K] are 64-bit (the capped ELL holds 2^31 slots).
//     Nothing is allocated; the launch goes to the caller's stream and the
//     entry point returns cudaGetLastError().
//
// TPU-only behaviour left out on purpose: the 16 MiB VMEM budget for x
// with its fallback to the reference (x stays in device memory and L2 on
// the card), and the padding of rows to 512 and K to 128 lanes (this
// kernel masks its ragged edge itself).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <atomic>
#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

// The file compiles whole, or in four parts that link into one library
// (-DSUPERSTEP_PART=1, 2, 3, 4; ops.py builds them at once): the 1-D
// entry, the batched entry with its kernels on int32 state, its kernels on
// float32 state, and the CSR entry of the dense superstep.
#ifndef SUPERSTEP_PART
#define SUPERSTEP_PART 0
#endif
#define SUPERSTEP_HAS(part) (SUPERSTEP_PART == 0 || SUPERSTEP_PART == (part))

namespace {

enum Dtype { I32 = 0, F32 = 1, BF16 = 2, F16 = 3 };
enum Op { SUM = 0, MIN = 1, MAX = 2 };
enum Prog { SRC = 0, SRC_PLUS_ONE = 1, SRC_PLUS_W = 2, SRC_TIMES_W = 3 };

constexpr int kThreads = 256;
constexpr int kPiece = 2048;                 // slots a block takes at once

template <int OUT> struct OutType { using type = float; };
template <> struct OutType<I32> { using type = int; };
template <> struct OutType<BF16> { using type = __nv_bfloat16; };
template <> struct OutType<F16> { using type = __half; };

// accumulator: int32 for int32 outputs, float32 for everything else
template <int OUT> struct AccType { using type = float; };
template <> struct AccType<I32> { using type = int; };

// The four edge programs.  Program 0 keeps the state type; the others
// promote to float32 (int32 + 1.0 -> float32, as torch and jnp do).
template <int PROG, typename TIn>
__device__ __forceinline__ auto edge_program(TIn x, float w) {
  if constexpr (PROG == SRC) {
    return x;
  } else if constexpr (PROG == SRC_PLUS_ONE) {
    return __fadd_rn(static_cast<float>(x), 1.0f);
  } else if constexpr (PROG == SRC_PLUS_W) {
    return __fadd_rn(static_cast<float>(x), w);
  } else {
    return __fmul_rn(static_cast<float>(x), w);
  }
}

// Cast a message (or the fill) to the output type, then widen it to the
// accumulator: the rounding of the reduced-precision channel.
template <int OUT, typename M>
__device__ __forceinline__ typename AccType<OUT>::type to_acc(M m) {
  if constexpr (OUT == I32) {
    return static_cast<int>(m);
  } else if constexpr (OUT == F32) {
    return static_cast<float>(m);
  } else if constexpr (OUT == BF16) {
    return __bfloat162float(__float2bfloat16_rn(static_cast<float>(m)));
  } else {
    return __half2float(__float2half_rn(static_cast<float>(m)));
  }
}

template <int OUT>
__device__ __forceinline__ typename OutType<OUT>::type store_value(
    typename AccType<OUT>::type a) {
  if constexpr (OUT == BF16) {
    return __float2bfloat16_rn(a);
  } else if constexpr (OUT == F16) {
    return __float2half_rn(a);
  } else {
    return a;
  }
}

// Neutral start of a row's reduction.
template <int OP, typename A>
__device__ __forceinline__ A neutral() {
  if constexpr (OP == SUM) {
    return A(0);
  } else if constexpr (std::is_same<A, int>::value) {
    return OP == MIN ? INT_MAX : INT_MIN;
  } else {
    return OP == MIN ? INFINITY : -INFINITY;
  }
}

// min/max propagate NaN, as torch.amin/amax do.
template <int OP>
__device__ __forceinline__ int combine(int a, int b) {
  if constexpr (OP == SUM) {
    return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
  } else if constexpr (OP == MIN) {
    return b < a ? b : a;
  } else {
    return b > a ? b : a;
  }
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

__device__ __forceinline__ int as_bits(int v) { return v; }
__device__ __forceinline__ int as_bits(float v) { return __float_as_int(v); }
template <typename A>
__device__ __forceinline__ A from_bits(int b) {
  if constexpr (std::is_same<A, int>::value) {
    return b;
  } else {
    return __int_as_float(b);
  }
}

// A tile: rows [row0, row0 + rows), whose slots [s0, s0 + n) of the
// flat [V, K] arrays are walked in pieces of `piece` slots (more than one
// only for a row longer than a piece).
struct Tile {
  long long row0;
  int rows;
  long long s0;
  int n;
  int pieces;
};

__device__ __forceinline__ Tile make_tile(long long V, int K, int R,
                                          long long t, int piece = kPiece) {
  Tile s;
  s.row0 = t * R;
  const long long left = V - s.row0;
  s.rows = left < R ? static_cast<int>(left) : R;
  s.s0 = s.row0 * K;
  s.n = s.rows * K;
  s.pieces = (s.n + piece - 1) / piece;
  return s;
}

#if SUPERSTEP_HAS(1)

// What a slot contributes: its message, cast to the output type, where
// the mask is on; the fill where it is off.
template <typename TIn, int PROG, int OUT>
__device__ __forceinline__ typename AccType<OUT>::type slot_value(
    bool live, int id, float wk, const TIn* __restrict__ x, int Vx,
    typename AccType<OUT>::type fill_acc) {
  if (!live) return fill_acc;
  id = id < 0 ? 0 : (id >= Vx ? Vx - 1 : id);
  return to_acc<OUT>(edge_program<PROG>(__ldg(x + id), wk));
}

template <typename TIn, int PROG, int OP, int OUT>
__global__ void __launch_bounds__(kThreads) superstep_kernel(
    const int* __restrict__ nbr, const uint8_t* __restrict__ mask,
    const float* __restrict__ w, const TIn* __restrict__ x,
    typename OutType<OUT>::type* __restrict__ out, long long V, int K,
    int Vx, int R, double fill, bool aligned) {
  using Acc = typename AccType<OUT>::type;
  constexpr bool reads_w = PROG == SRC_PLUS_W || PROG == SRC_TIMES_W;
  constexpr int kG = kPiece / 4 / kThreads;      // groups a thread
  __shared__ __align__(16) int vals[kPiece];  // the piece's slot values
  const int tid = threadIdx.x;
  const Acc fill_acc = to_acc<OUT>(fill);
  const long long tiles = (V + R - 1) / R;

  if (K == 0) {                       // no slots: every row is the fill
    for (long long v = blockIdx.x * static_cast<long long>(kThreads) + tid;
         v < V; v += static_cast<long long>(gridDim.x) * kThreads) {
      out[v] = store_value<OUT>(fill_acc);
    }
    return;
  }

  long long t = blockIdx.x;
  if (t >= tiles) return;
  Tile tile = make_tile(V, K, R, t);
  int p = 0;                          // piece of the tile
  Acc acc = neutral<OP, Acc>();       // thread 0's row across pieces
  for (;;) {
    const long long base = tile.s0 + static_cast<long long>(p) * kPiece;
    const int count = min(kPiece, tile.n - p * kPiece);
    const bool vec = aligned && !(base & 3);
    const bool last_piece = p + 1 == tile.pieces;
    // this thread's 4-slot groups: the mask word, then ids (and weights)
    // only for a group that holds a live slot, then x at the live slots
#pragma unroll
    for (int q = 0; q < kG; ++q) {
      const int g = tid + q * kThreads;
      const int at = 4 * g;
      if (at >= count) continue;
      const long long s = base + at;
      Acc v4[4];
      if (vec && at + 4 <= count) {
        const uint32_t m =
            __ldcs(reinterpret_cast<const unsigned int*>(mask + s));
        int4 ids = make_int4(0, 0, 0, 0);
        float4 ws = make_float4(0.f, 0.f, 0.f, 0.f);
        if (m) {
          ids = __ldcs(reinterpret_cast<const int4*>(nbr + s));
          if constexpr (reads_w) {
            ws = __ldcs(reinterpret_cast<const float4*>(w + s));
          }
        }
        v4[0] = slot_value<TIn, PROG, OUT>(m & 0xFFu, ids.x, ws.x, x, Vx,
                                           fill_acc);
        v4[1] = slot_value<TIn, PROG, OUT>(m & 0xFF00u, ids.y, ws.y, x, Vx,
                                           fill_acc);
        v4[2] = slot_value<TIn, PROG, OUT>(m & 0xFF0000u, ids.z, ws.z, x, Vx,
                                           fill_acc);
        v4[3] = slot_value<TIn, PROG, OUT>(m & 0xFF000000u, ids.w, ws.w, x,
                                           Vx, fill_acc);
      } else {                        // slot by slot
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          v4[u] = fill_acc;
          if (at + u < count && __ldcs(mask + s + u)) {
            float wk = 0.f;
            if constexpr (reads_w) wk = __ldcs(w + s + u);
            v4[u] = slot_value<TIn, PROG, OUT>(true, __ldcs(nbr + s + u), wk,
                                               x, Vx, fill_acc);
          }
        }
      }
      *reinterpret_cast<int4*>(&vals[at]) =
          make_int4(as_bits(v4[0]), as_bits(v4[1]), as_bits(v4[2]),
                    as_bits(v4[3]));
    }
    __syncthreads();
    // each row's slots of this piece, combined in slot order by one thread
    const long long off = base - tile.s0;           // piece's first slot
    for (int r = tid; r < tile.rows; r += kThreads) {
      const long long rs = static_cast<long long>(r) * K - off;
      const int lo = rs < 0 ? 0 : (rs > count ? count : static_cast<int>(rs));
      const long long re = rs + K;
      const int hi = re > count ? count : static_cast<int>(re < 0 ? 0 : re);
      if (lo >= hi) continue;
      Acc a = tile.pieces > 1 ? acc : neutral<OP, Acc>();
      for (int k = lo; k < hi; ++k) {
        a = combine<OP>(a, from_bits<Acc>(vals[k]));
      }
      if (re <= count) {
        out[tile.row0 + r] = store_value<OUT>(a);
      } else {
        acc = a;                      // the row goes on in the next piece
      }
    }
    __syncthreads();                  // vals is free for the next piece
    if (last_piece) {
      acc = neutral<OP, Acc>();
      t += gridDim.x;
      if (t >= tiles) break;
      tile = make_tile(V, K, R, t);
      p = 0;
    } else {
      ++p;
    }
  }
}

struct Args {
  const void* nbr;
  const void* mask;
  const void* w;
  const void* x;
  void* out;
  long long V;
  int K;
  int Vx;
  int R;
  double fill;
  bool aligned;
  cudaStream_t stream;
};

template <typename TIn, int PROG, int OP, int OUT>
cudaError_t launch(const Args& a) {
  auto kernel = superstep_kernel<TIn, PROG, OP, OUT>;
  // blocks resident on the whole card, found once per kernel and device
  // (a benign race: concurrent first calls store the same value)
  static int resident[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
    if (err != cudaSuccess) return err;
    resident[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long work = a.K == 0 ? (a.V + kThreads - 1) / kThreads
                                  : (a.V + a.R - 1) / a.R;
  const long long blocks = work < resident[dev] ? work : resident[dev];
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, a.stream>>>(
      static_cast<const int*>(a.nbr), static_cast<const uint8_t*>(a.mask),
      static_cast<const float*>(a.w), static_cast<const TIn*>(a.x),
      static_cast<typename OutType<OUT>::type*>(a.out), a.V, a.K, a.Vx, a.R,
      a.fill, a.aligned);
  return cudaGetLastError();
}

template <typename TIn, int PROG, int OP>
cudaError_t by_out(int out_type, const Args& a) {
  // an int32 output only for an int32 message (program 0 on int32 state)
  constexpr bool int_msg = PROG == SRC && std::is_same<TIn, int>::value;
  switch (out_type) {
    case I32:
      if constexpr (int_msg) return launch<TIn, PROG, OP, I32>(a);
      return cudaErrorInvalidValue;
    case F32: return launch<TIn, PROG, OP, F32>(a);
    case BF16: return launch<TIn, PROG, OP, BF16>(a);
    case F16: return launch<TIn, PROG, OP, F16>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TIn, int PROG>
cudaError_t by_op(int op, int out_type, const Args& a) {
  switch (op) {
    case SUM: return by_out<TIn, PROG, SUM>(out_type, a);
    case MIN: return by_out<TIn, PROG, MIN>(out_type, a);
    case MAX: return by_out<TIn, PROG, MAX>(out_type, a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TIn>
cudaError_t by_prog(int program, int op, int out_type, const Args& a) {
  switch (program) {
    case SRC: return by_op<TIn, SRC>(op, out_type, a);
    case SRC_PLUS_ONE: return by_op<TIn, SRC_PLUS_ONE>(op, out_type, a);
    case SRC_PLUS_W: return by_op<TIn, SRC_PLUS_W>(op, out_type, a);
    case SRC_TIMES_W: return by_op<TIn, SRC_TIMES_W>(op, out_type, a);
    default: return cudaErrorInvalidValue;
  }
}

#endif  // SUPERSTEP_HAS(1)

}  // namespace

#if SUPERSTEP_HAS(1)
// C entry point (bound with ctypes).  Every pointer and the stream come in
// as void*; rows_per_tile is R (ops.py:_rows_per_tile).  The return value is
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a combination this file does not compile.
extern "C" int pregel_superstep(const void* nbr, const void* mask,
                                const void* w, const void* x, void* out,
                                long long V, long long K, long long Vx,
                                int state_type, int program, int op,
                                int out_type, double fill, int rows_per_tile,
                                void* stream) {
  if (V <= 0) return 0;
  if (K < 0 || K > INT_MAX || Vx < 1 || Vx > INT_MAX || rows_per_tile < 1 ||
      rows_per_tile > kPiece ||
      (rows_per_tile > 1 && rows_per_tile * K > kPiece)) {
    return cudaErrorInvalidValue;
  }
  // 4-slot groups load as one vector when the arrays allow it
  const bool aligned = reinterpret_cast<uintptr_t>(mask) % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(nbr) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const Args a{nbr, mask, w, x, out, V, static_cast<int>(K),
               static_cast<int>(Vx), rows_per_tile, fill, aligned,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  switch (state_type) {
    case I32: err = by_prog<int>(program, op, out_type, a); break;
    case F32: err = by_prog<float>(program, op, out_type, a); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
#endif  // SUPERSTEP_HAS(1)

// ---------------------------------------------------------------------------
// The same superstep over batched state: x is [Vx, B] row-major, out is
// [V, B], and column b of out is the 1-D superstep of column b of x, w
// shared by every column:
//
//     agg[v, b] = reduce_k( op, mask[v,k] ? cast(message(x[nbr[v,k], b],
//                                                        w[v,k]))
//                                         : fill )
//
// This is the fused batch of B queries that core/pregel.py:batched_spec
// lifts onto a trailing axis (the service's fusion of B BFS or SSSP
// tickets).  It replaces the same TPU kernel as the 1-D entry above; the
// reference runs such state through its jnp version instead
// (src/repro/kernels/pregel_superstep/ops.py:1-12), the port through this
// kernel.  Plain version: ref.py:superstep_plain, which takes trailing
// dims; wrapper: ops.py:fused_superstep, which routes 2-D state here.
//
// What bounds it: bytes, as the 1-D entry (the mask in full, nbr and w at
// the live slots, x and out once), with x and out B times as wide.  On
// the main path's in-ELL (V = 2^24, K = 19, 7.75 live slots a row) at
// B = 8 that is 1.91 GB, 0.571 ms at 3.35 TB/s; x and out are 0.54 GB
// each of it.  A live slot needs x[id, 0:B], B x 4 contiguous bytes: one
// whole 32-byte sector at B = 8, where the 1-D entry uses 4 bytes of
// every sector it gathers.  What keeps a kernel from the bound is the
// latency of its dependent loads (mask, then ids, then x) with too few
// bytes in flight, the lanes it leaves idle, and the B combines every slot
// costs (a warp walks its rows' slots in step, dead or live).
//
// Design: the 1-D entry's tiles, with the columns as a second axis of the
// work; every lane busy at every B, every gather 16 bytes, a thread's
// gathers in flight together, the loads of the next tile in flight while
// a tile is combined, and a kernel for each path so that each gets the
// registers it needs.
//   * A block owns a tile of R rows whose slots are one contiguous run of
//     the flat [V, K] arrays; the columns go in passes of C, all B at once
//     up to 1024, in 4-column groups where B is a multiple of 4 and x and
//     out are 16-byte aligned, else single columns with 4-byte loads.  The
//     wrapper computes R, the slots P a block holds, C, the vector flag
//     and the shared memory (ops.py:_batched_geometry); this file checks
//     them.  Blocks walk the tiles grid-stride, as many resident on each
//     SM as fit.  A tile's ids are read once for all B columns.
//   * Rows of at most kShortRow slots in 4-column groups (the main path's
//     in-ELLs have K = 18-19): a tile holds a row for each column group of
//     the block's threads (R = 128 at B = 8).  Its mask words, then the
//     ids (and weights) of its groups with a live slot only, come into
//     shared memory by cp.async, which holds no register while in flight:
//     while the block walks tile j, tile j + 1's ids and tile j + 2's mask
//     are copied (three mask buffers, two of ids and weights), so the two
//     dependent loads of a tile hide behind the walk of another.  A
//     thread per (row, 4-column group) walks its row kShortPairs slots at
//     a time: at each live slot a 16-byte gather of x[id, c:c+4], all of
//     them issued before the first is combined, then the edge program,
//     the cast to the channel dtype (as the 1-D entry's) and the combine,
//     the fill at a dead slot; out[v, c:c+4] in one store.  Values stay in
//     registers.  (cp.async with an L2 evict-first policy raised an
//     illegal instruction on the H100, so these copies carry no hint.)
//   * Longer rows, and single columns, go in pieces of P slots (a row
//     longer than a piece is a tile of its own, its partial results
//     carried to the next piece in shared memory), so that a row's
//     gathers spread over the block: step 1 reads the piece's mask words,
//     then its live groups' ids (and weights), as 16-byte evict-first
//     loads (__ldcs) into shared memory; step 2, threads take (slot,
//     column group) pairs, kPairs gathers a thread in flight, and put each
//     value into shared memory in slot order (8192 values a piece: P =
//     1024 at B = 8); step 3, a thread per (row, column group) combines
//     the row's values in slot order.  Unaligned arrays and a ragged last
//     group are read slot by slot.
//   * Either way the order is the 1-D entry's, and that of the
//     warp-per-row design this one replaced: min/max bit-identical to the
//     plain version, float sums the same bytes as before, int32 sums wrap,
//     bf16/f16 accumulate in float32 and round once.
//   * K = 0 rows are the fill.  Offsets are 64-bit.  The launch goes to
//     the caller's stream; the entry point returns cudaGetLastError().

// The parts' interface: the batched entry's arguments, and its dispatch
// on int32 and on float32 state (parts 2 and 3).
namespace superstep_parts {

struct BatchedArgs {
  const void* nbr;
  const void* mask;
  const void* w;
  const void* x;
  void* out;
  long long V;
  int K;
  int Vx;
  int B;
  int R;
  int P;
  int C;
  bool vec;
  bool aligned;
  bool shrt;
  int smem;
  double fill;
  cudaStream_t stream;
};

cudaError_t batched_int32(int program, int op, int out_type,
                          const BatchedArgs& a);
cudaError_t batched_float32(int program, int op, int out_type,
                            const BatchedArgs& a);

}  // namespace superstep_parts

namespace {

using superstep_parts::BatchedArgs;

constexpr int kShortRow = 64;             // K at most: rows in registers
constexpr int kMaxShortPiece = 3072;      // most slots a short-row tile
constexpr int kMaxPieceBatched = 2048;    // most slots a longer rows' piece
constexpr int kShortPairs = 6;            // a row walk's gathers in flight
constexpr int kShortBlocks = 4;           // short rows: blocks an SM holds
constexpr int kPairs = 8;                 // longer rows: gathers in flight
constexpr int kLongBlocks = 3;            // longer rows: blocks an SM holds
constexpr int kMaxSmem = 232448;          // a block's shared memory (H100)

__device__ __forceinline__ int clamp_id(int id, int Vx) {
  return id < 0 ? 0 : (id >= Vx ? Vx - 1 : id);
}

// Shared memory of a block, bytes.  Rows of at most kShortRow slots: two
// tiles' ids [P] and weights [P] and three tiles' mask bytes [P] (the
// pipeline of step 1).  Longer rows: ids [P], weights [P], the piece's
// values [P x C] (from a 16-byte boundary, P being a multiple of 4) and
// the carried partials of a long row [C].  ops.py:_batched_geometry
// computes the same.
__host__ __device__ __forceinline__ long long batched_smem_bytes(int P, int C,
                                                                 bool shrt) {
  return shrt ? 19LL * P
              : 4 * (2LL * P + static_cast<long long>(P) * C + C);
}

// cp.async (sm_80 and later): a copy from global to shared memory that
// holds no register while in flight (.cg: not through L1).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Step 1: a piece's ids (clamped, -1 where dead) and weights.  A thread
// takes at most kGroups 4-slot groups: all their mask words are loaded,
// then the ids (and weights) of all their live groups, so a piece costs
// two dependent loads whatever its size.
template <int kGroups, bool kReadsW>
__device__ __forceinline__ void load_piece_slots(
    const int* __restrict__ nbr, const uint8_t* __restrict__ mask,
    const float* __restrict__ w, long long base, int count, int Vx,
    bool aligned, int* ids_s, float* ws_s) {
  const bool vec = aligned && !(base & 3);
  uint32_t m[kGroups];
#pragma unroll
  for (int q = 0; q < kGroups; ++q) {
    const int at = 4 * (threadIdx.x + q * kThreads);
    const long long s = base + at;
    m[q] = 0;
    if (at >= count) continue;
    if (vec && at + 4 <= count) {
      m[q] = __ldcs(reinterpret_cast<const unsigned int*>(mask + s));
    } else {                              // slot by slot
      for (int u = 0; u < 4 && at + u < count; ++u) {
        int id = -1;
        if (__ldcs(mask + s + u)) {
          id = clamp_id(__ldcs(nbr + s + u), Vx);
          if constexpr (kReadsW) ws_s[at + u] = __ldcs(w + s + u);
        }
        ids_s[at + u] = id;
      }
    }
  }
  int4 raw[kGroups];
#pragma unroll
  for (int q = 0; q < kGroups; ++q) {
    const int at = 4 * (threadIdx.x + q * kThreads);
    if (m[q]) {
      raw[q] = __ldcs(reinterpret_cast<const int4*>(nbr + base + at));
      if constexpr (kReadsW) {
        *reinterpret_cast<float4*>(ws_s + at) =
            __ldcs(reinterpret_cast<const float4*>(w + base + at));
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kGroups; ++q) {
    const int at = 4 * (threadIdx.x + q * kThreads);
    if (!(vec && at + 4 <= count)) continue;
    int4 ids = make_int4(-1, -1, -1, -1);
    if (m[q]) {
      ids.x = (m[q] & 0xFFu) ? clamp_id(raw[q].x, Vx) : -1;
      ids.y = (m[q] & 0xFF00u) ? clamp_id(raw[q].y, Vx) : -1;
      ids.z = (m[q] & 0xFF0000u) ? clamp_id(raw[q].z, Vx) : -1;
      ids.w = (m[q] & 0xFF000000u) ? clamp_id(raw[q].w, Vx) : -1;
    }
    *reinterpret_cast<int4*>(ids_s + at) = ids;
  }
}

// VW consecutive elements: one 16-byte load or store for VW = 4.
template <int VW, typename T>
__device__ __forceinline__ void load_x(const T* __restrict__ p, T* v) {
  if constexpr (VW == 4) {
    const int4 r = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = from_bits<T>(r.x);
    v[1] = from_bits<T>(r.y);
    v[2] = from_bits<T>(r.z);
    v[3] = from_bits<T>(r.w);
  } else {
    v[0] = __ldg(p);
  }
}

template <int VW>
__device__ __forceinline__ void store_vals(int* p, const int* v) {
  if constexpr (VW == 4) {
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}

template <int VW>
__device__ __forceinline__ void load_vals(const int* p, int* v) {
  if constexpr (VW == 4) {
    const int4 r = *reinterpret_cast<const int4*>(p);
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  } else {
    v[0] = p[0];
  }
}

// The output's bits, for stores of four elements at once.
template <int OUT>
__device__ __forceinline__ unsigned out_bits(typename AccType<OUT>::type a) {
  if constexpr (OUT == BF16) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(a));
  } else if constexpr (OUT == F16) {
    return __half_as_ushort(__float2half_rn(a));
  } else {
    return static_cast<unsigned>(as_bits(a));
  }
}

template <int VW, int OUT>
__device__ __forceinline__ void store_out(
    typename OutType<OUT>::type* __restrict__ p,
    const typename AccType<OUT>::type* a) {
  if constexpr (VW == 1) {
    p[0] = store_value<OUT>(a[0]);
  } else if constexpr (sizeof(typename OutType<OUT>::type) == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(
        out_bits<OUT>(a[0]), out_bits<OUT>(a[1]), out_bits<OUT>(a[2]),
        out_bits<OUT>(a[3]));
  } else {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(out_bits<OUT>(a[0]) | (out_bits<OUT>(a[1]) << 16),
                   out_bits<OUT>(a[2]) | (out_bits<OUT>(a[3]) << 16));
  }
}

// Step 2: the piece's live values, VW columns a pair, into vals
// ([slot][column] of the pass, cw columns).
template <int VW, typename TIn, int PROG, int OUT>
__device__ __forceinline__ void gather_piece(
    const TIn* __restrict__ x, long long B, int c0, int cw, int count,
    const int* ids_s, const float* ws_s, int* vals) {
  constexpr bool reads_w = PROG == SRC_PLUS_W || PROG == SRC_TIMES_W;
  const int G = cw / VW;                  // column groups of the pass
  const int pairs = count * G;
  const int ds = kThreads / G, dg = kThreads % G;
  int s = threadIdx.x / G, g = threadIdx.x % G;
  for (int j0 = threadIdx.x; j0 < pairs; j0 += kPairs * kThreads) {
    TIn v[kPairs][VW];
    int at[kPairs];                       // where the values go; -1: none
    float wk[kPairs];
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      at[q] = -1;
      wk[q] = 0.f;
      if (j0 + q * kThreads < pairs) {
        const int id = ids_s[s];
        if (id >= 0) {
          at[q] = s * cw + g * VW;
          if constexpr (reads_w) wk[q] = ws_s[s];
          load_x<VW>(x + static_cast<long long>(id) * B + c0 + g * VW, v[q]);
        }
      }
      s += ds;
      g += dg;
      if (g >= G) {
        g -= G;
        ++s;
      }
    }
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      if (at[q] < 0) continue;
      int o[VW];
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        o[e] = as_bits(to_acc<OUT>(edge_program<PROG>(v[q][e], wk[q])));
      }
      store_vals<VW>(vals + at[q], o);
    }
  }
}

// Step 3: each (row, column group) of the piece combined in slot order;
// a row that ends in the piece is written, one that goes on is carried.
template <int VW, int OP, int OUT>
__device__ __forceinline__ void combine_piece(
    const int* ids_s, const int* vals, int* carry,
    typename OutType<OUT>::type* __restrict__ out, long long B, int c0,
    int cw, int K, const Tile& tile, long long off, int count,
    typename AccType<OUT>::type fill_acc) {
  using Acc = typename AccType<OUT>::type;
  const int G = cw / VW;
  const int n = tile.rows * G;
  const int dr = kThreads / G, dg = kThreads % G;
  int r = threadIdx.x / G, g = threadIdx.x % G;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const long long rs = static_cast<long long>(r) * K - off;
    const int lo = rs < 0 ? 0 : (rs > count ? count : static_cast<int>(rs));
    const long long re = rs + K;
    const int hi = re > count ? count : static_cast<int>(re < 0 ? 0 : re);
    if (lo < hi) {
      Acc a[VW];
#pragma unroll
      for (int e = 0; e < VW; ++e) {
        a[e] = rs < 0 ? from_bits<Acc>(carry[g * VW + e])
                      : neutral<OP, Acc>();
      }
#pragma unroll 4
      for (int k = lo; k < hi; ++k) {
        // read whatever a dead slot holds and keep the fill: no branch,
        // so the loads of several slots are in flight together
        const bool live = ids_s[k] >= 0;
        int b[VW];
        load_vals<VW>(vals + k * cw + g * VW, b);
#pragma unroll
        for (int e = 0; e < VW; ++e) {
          a[e] = combine<OP>(a[e], live ? from_bits<Acc>(b[e]) : fill_acc);
        }
      }
      if (re <= count) {
        store_out<VW, OUT>(out + (tile.row0 + r) * B + c0 + g * VW, a);
      } else {                            // the row goes on in the next piece
#pragma unroll
        for (int e = 0; e < VW; ++e) carry[g * VW + e] = as_bits(a[e]);
      }
    }
    r += dr;
    g += dg;
    if (g >= G) {
      g -= G;
      ++r;
    }
  }
}

// Rows of at most kShortRow slots.  Step 1 is a pipeline of cp.async
// copies into shared memory: while a block walks tile j, the mask words
// of tile j + 2 and the ids (and weights) of tile j + 1's live groups are
// in flight (the latter read where the former, copied during the walk of
// tile j - 1, say a group is live).  Groups that cannot be copied as
// words (arrays not aligned, a tile's ragged last group) are read slot
// by slot instead, at the same point of the pipeline.

// The mask of a tile's slots [0, count) from base, as bytes.
__device__ __forceinline__ void issue_mask(const uint8_t* __restrict__ mask,
                                           long long base, int count,
                                           bool aligned, uint8_t* mask_s) {
  const bool vec = aligned && !(base & 3);
  for (int at = 4 * threadIdx.x; at < count; at += 4 * kThreads) {
    if (vec && at + 4 <= count) {
      cp_async4(mask_s + at, mask + base + at);
    } else {
      for (int u = 0; u < 4 && at + u < count; ++u) {
        mask_s[at + u] = __ldcs(mask + base + at + u);
      }
    }
  }
}

// The ids (and weights) of the tile's live groups, as they are in
// memory (clamped where they are used); a dead slot's id is not read.
template <bool kReadsW>
__device__ __forceinline__ void issue_ids(
    const int* __restrict__ nbr, const float* __restrict__ w, long long base,
    int count, bool aligned, const uint8_t* mask_s, int* ids_s,
    float* ws_s) {
  const bool vec = aligned && !(base & 3);
  for (int at = 4 * threadIdx.x; at < count; at += 4 * kThreads) {
    if (vec && at + 4 <= count) {
      if (*reinterpret_cast<const unsigned*>(mask_s + at)) {
        cp_async16(ids_s + at, nbr + base + at);
        if constexpr (kReadsW) cp_async16(ws_s + at, w + base + at);
      }
    } else {
      for (int u = 0; u < 4 && at + u < count; ++u) {
        if (mask_s[at + u]) {
          ids_s[at + u] = __ldcs(nbr + base + at + u);
          if constexpr (kReadsW) ws_s[at + u] = __ldcs(w + base + at + u);
        }
      }
    }
  }
}

// A thread per (row, 4-column group) walks its row, kShortPairs slots at
// a time: every live slot's gather of the group in flight before the
// first is combined; the values never leave registers.
template <typename TIn, int PROG, int OP, int OUT>
__device__ __forceinline__ void walk_short_rows(
    const TIn* __restrict__ x, typename OutType<OUT>::type* __restrict__ out,
    long long B, int c0, int cw, int K, int Vx, long long row0, int rows,
    const uint8_t* mask_s, const int* ids_s, const float* ws_s,
    typename AccType<OUT>::type fill_acc) {
  using Acc = typename AccType<OUT>::type;
  const int G = cw / 4;
  const int n = rows * G;
  const int dr = kThreads / G, dg = kThreads % G;
  int r = threadIdx.x / G, g = threadIdx.x % G;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const uint8_t* ms = mask_s + r * K;
    const int* ids = ids_s + r * K;
    const float* ws = ws_s + r * K;
    const TIn* xg = x + c0 + g * 4;
    Acc a[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) a[e] = neutral<OP, Acc>();
    for (int k0 = 0; k0 < K; k0 += kShortPairs) {
      TIn v[kShortPairs][4];
      unsigned live = 0;
#pragma unroll
      for (int q = 0; q < kShortPairs; ++q) {
        if (k0 + q < K && ms[k0 + q]) {
          live |= 1u << q;
          load_x<4>(xg + static_cast<long long>(clamp_id(ids[k0 + q], Vx)) *
                              B,
                    v[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < kShortPairs; ++q) {
        if (k0 + q >= K) break;
        const float wk = ws[k0 + q];      // read by the programs that use it
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a[e] = combine<OP>(
              a[e], (live >> q) & 1u
                        ? to_acc<OUT>(edge_program<PROG>(v[q][e], wk))
                        : fill_acc);
        }
      }
    }
    store_out<4, OUT>(out + (row0 + r) * B + c0 + g * 4, a);
    r += dr;
    g += dg;
    if (g >= G) {
      g -= G;
      ++r;
    }
  }
}

template <typename TIn, int PROG, int OP, int OUT>
__global__ void __launch_bounds__(kThreads, kShortBlocks)
    superstep_batched_short_kernel(
    const int* __restrict__ nbr, const uint8_t* __restrict__ mask,
    const float* __restrict__ w, const TIn* __restrict__ x,
    typename OutType<OUT>::type* __restrict__ out, long long V, int K,
    int Vx, int B, int R, int P, int C, bool aligned, double fill) {
  using Acc = typename AccType<OUT>::type;
  constexpr bool reads_w = PROG == SRC_PLUS_W || PROG == SRC_TIMES_W;
  extern __shared__ __align__(16) int smem[];
  int* ids_s[2] = {smem, smem + P};
  float* ws_s[2] = {reinterpret_cast<float*>(smem + 2 * P),
                    reinterpret_cast<float*>(smem + 3 * P)};
  uint8_t* const mask0 = reinterpret_cast<uint8_t*>(smem + 4 * P);
  uint8_t* mask_s[3] = {mask0, mask0 + P, mask0 + 2 * P};
  const Acc fill_acc = to_acc<OUT>(fill);

  if (K == 0) {                       // no slots: every row is the fill
    const long long total = V * B;
    for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                       threadIdx.x;
         i < total; i += static_cast<long long>(gridDim.x) * kThreads) {
      out[i] = store_value<OUT>(fill_acc);
    }
    return;
  }

  const long long tiles = (V + R - 1) / R;
  const long long stride = gridDim.x;
  long long t = blockIdx.x;           // the block's tile j
  if (t >= tiles) return;
  Tile cur = make_tile(V, K, R, t, P);
  Tile nxt = make_tile(V, K, R, t + stride, P);
  issue_mask(mask, cur.s0, cur.n, aligned, mask_s[0]);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  issue_ids<reads_w>(nbr, w, cur.s0, cur.n, aligned, mask_s[0], ids_s[0],
                     ws_s[0]);
  if (t + stride < tiles) {
    issue_mask(mask, nxt.s0, nxt.n, aligned, mask_s[1]);
  }
  cp_async_commit();
  for (int j = 0;; ++j, t += stride) {
    // tile j's ids and tile j + 1's mask are in; every thread is done
    // with tile j - 1's buffers
    cp_async_wait_all();
    __syncthreads();
    if (t + stride < tiles) {
      issue_ids<reads_w>(nbr, w, nxt.s0, nxt.n, aligned,
                         mask_s[(j + 1) % 3], ids_s[(j + 1) & 1],
                         ws_s[(j + 1) & 1]);
    }
    if (t + 2 * stride < tiles) {
      const Tile after = make_tile(V, K, R, t + 2 * stride, P);
      issue_mask(mask, after.s0, after.n, aligned, mask_s[(j + 2) % 3]);
    }
    cp_async_commit();
    for (int c0 = 0; c0 < B; c0 += C) {
      walk_short_rows<TIn, PROG, OP, OUT>(
          x, out, B, c0, min(C, B - c0), K, Vx, cur.row0, cur.rows,
          mask_s[j % 3], ids_s[j & 1], ws_s[j & 1], fill_acc);
    }
    if (t + stride >= tiles) break;
    cur = nxt;
    nxt = make_tile(V, K, R, t + 2 * stride, P);
  }
  cp_async_wait_all();
}

// Rows longer than kShortRow: pieces of P slots, step 1 into shared
// memory (kGroups groups a thread, two dependent loads a piece), step 2
// the gathers into shared memory, step 3 the combine.
template <typename TIn, int PROG, int OP, int OUT>
__global__ void __launch_bounds__(kThreads, kLongBlocks)
    superstep_batched_long_kernel(
    const int* __restrict__ nbr, const uint8_t* __restrict__ mask,
    const float* __restrict__ w, const TIn* __restrict__ x,
    typename OutType<OUT>::type* __restrict__ out, long long V, int K,
    int Vx, int B, int R, int P, int C, bool vec, bool aligned,
    double fill) {
  using Acc = typename AccType<OUT>::type;
  constexpr bool reads_w = PROG == SRC_PLUS_W || PROG == SRC_TIMES_W;
  constexpr int kGroups = kMaxPieceBatched / 4 / kThreads;
  extern __shared__ __align__(16) int smem[];
  int* ids_s = smem;
  float* ws_s = reinterpret_cast<float*>(smem + P);
  int* vals = smem + 2 * P;
  int* carry = vals + P * C;
  const Acc fill_acc = to_acc<OUT>(fill);

  if (K == 0) {                       // no slots: every row is the fill
    const long long total = V * B;
    for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                       threadIdx.x;
         i < total; i += static_cast<long long>(gridDim.x) * kThreads) {
      out[i] = store_value<OUT>(fill_acc);
    }
    return;
  }

  const long long tiles = (V + R - 1) / R;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Tile tile = make_tile(V, K, R, t, P);
    for (int c0 = 0; c0 < B; c0 += C) {
      const int cw = min(C, B - c0);
      for (int p = 0; p < tile.pieces; ++p) {
        const long long off = static_cast<long long>(p) * P;
        const int count = static_cast<int>(
            min(static_cast<long long>(P), tile.n - off));
        // a tile of one piece keeps its ids for every pass of columns
        if (c0 == 0 || tile.pieces > 1) {
          load_piece_slots<kGroups, reads_w>(nbr, mask, w, tile.s0 + off,
                                             count, Vx, aligned, ids_s,
                                             ws_s);
        }
        __syncthreads();
        if (vec) {
          gather_piece<4, TIn, PROG, OUT>(x, B, c0, cw, count, ids_s, ws_s,
                                          vals);
        } else {
          gather_piece<1, TIn, PROG, OUT>(x, B, c0, cw, count, ids_s, ws_s,
                                          vals);
        }
        __syncthreads();
        if (vec) {
          combine_piece<4, OP, OUT>(ids_s, vals, carry, out, B, c0, cw, K,
                                    tile, off, count, fill_acc);
        } else {
          combine_piece<1, OP, OUT>(ids_s, vals, carry, out, B, c0, cw, K,
                                    tile, off, count, fill_acc);
        }
        __syncthreads();              // shared memory free for the next
      }
    }
  }
}


// Blocks resident on the card for one kernel at one size of shared
// memory, found once per kernel and device and cached as
// (smem << 32) | blocks (benign races: every writer stores a true pair);
// the first call also opts the kernel into the whole shared memory.
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int smem, std::atomic<bool>* opted,
                            std::atomic<long long>* cache, long long* blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!opted[dev].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    opted[dev].store(true, std::memory_order_relaxed);
  }
  long long known = cache[dev].load(std::memory_order_relaxed);
  if ((known >> 32) != smem) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    known = (static_cast<long long>(smem) << 32) |
            (sms * (per_sm > 0 ? per_sm : 1));
    cache[dev].store(known, std::memory_order_relaxed);
  }
  *blocks = known & 0xFFFFFFFFLL;
  return cudaSuccess;
}

template <typename TIn, int PROG, int OP, int OUT, bool kShort>
cudaError_t launch_batched(const BatchedArgs& a) {
  static std::atomic<bool> opted[64];
  static std::atomic<long long> cache[64];
  long long resident = 0;
  cudaError_t err;
  if constexpr (kShort) {
    err = resident_blocks(superstep_batched_short_kernel<TIn, PROG, OP, OUT>,
                          a.smem, opted, cache, &resident);
  } else {
    err = resident_blocks(superstep_batched_long_kernel<TIn, PROG, OP, OUT>,
                          a.smem, opted, cache, &resident);
  }
  if (err != cudaSuccess) return err;
  const long long work =
      a.K == 0 ? (a.V * a.B + kThreads - 1) / kThreads
               : (a.V + a.R - 1) / a.R;
  const unsigned blocks =
      static_cast<unsigned>(work < resident ? work : resident);
  const auto nbr = static_cast<const int*>(a.nbr);
  const auto mask = static_cast<const uint8_t*>(a.mask);
  const auto w = static_cast<const float*>(a.w);
  const auto x = static_cast<const TIn*>(a.x);
  const auto out = static_cast<typename OutType<OUT>::type*>(a.out);
  if constexpr (kShort) {
    superstep_batched_short_kernel<TIn, PROG, OP, OUT>
        <<<blocks, kThreads, a.smem, a.stream>>>(
            nbr, mask, w, x, out, a.V, a.K, a.Vx, a.B, a.R, a.P, a.C,
            a.aligned, a.fill);
  } else {
    superstep_batched_long_kernel<TIn, PROG, OP, OUT>
        <<<blocks, kThreads, a.smem, a.stream>>>(
            nbr, mask, w, x, out, a.V, a.K, a.Vx, a.B, a.R, a.P, a.C, a.vec,
            a.aligned, a.fill);
  }
  return cudaGetLastError();
}

template <typename TIn, int PROG, int OP, int OUT>
cudaError_t launch_batched_path(const BatchedArgs& a) {
  return a.shrt ? launch_batched<TIn, PROG, OP, OUT, true>(a)
                : launch_batched<TIn, PROG, OP, OUT, false>(a);
}

template <typename TIn, int PROG, int OP>
cudaError_t batched_by_out(int out_type, const BatchedArgs& a) {
  constexpr bool int_msg = PROG == SRC && std::is_same<TIn, int>::value;
  switch (out_type) {
    case I32:
      if constexpr (int_msg) {
        return launch_batched_path<TIn, PROG, OP, I32>(a);
      }
      return cudaErrorInvalidValue;
    case F32: return launch_batched_path<TIn, PROG, OP, F32>(a);
    case BF16: return launch_batched_path<TIn, PROG, OP, BF16>(a);
    case F16: return launch_batched_path<TIn, PROG, OP, F16>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TIn, int PROG>
cudaError_t batched_by_op(int op, int out_type, const BatchedArgs& a) {
  switch (op) {
    case SUM: return batched_by_out<TIn, PROG, SUM>(out_type, a);
    case MIN: return batched_by_out<TIn, PROG, MIN>(out_type, a);
    case MAX: return batched_by_out<TIn, PROG, MAX>(out_type, a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TIn>
cudaError_t batched_by_prog(int program, int op, int out_type,
                            const BatchedArgs& a) {
  switch (program) {
    case SRC: return batched_by_op<TIn, SRC>(op, out_type, a);
    case SRC_PLUS_ONE: return batched_by_op<TIn, SRC_PLUS_ONE>(op, out_type, a);
    case SRC_PLUS_W: return batched_by_op<TIn, SRC_PLUS_W>(op, out_type, a);
    case SRC_TIMES_W: return batched_by_op<TIn, SRC_TIMES_W>(op, out_type, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

#if SUPERSTEP_HAS(2)
cudaError_t superstep_parts::batched_int32(int program, int op, int out_type,
                                           const BatchedArgs& a) {
  return batched_by_prog<int>(program, op, out_type, a);
}
#endif

#if SUPERSTEP_HAS(3)
cudaError_t superstep_parts::batched_float32(int program, int op,
                                             int out_type,
                                             const BatchedArgs& a) {
  return batched_by_prog<float>(program, op, out_type, a);
}
#endif

#if SUPERSTEP_HAS(2)
// C entry point of the batched superstep (bound with ctypes): x is
// [Vx, B] row-major, out [V, B].  rows_per_tile, piece_slots, cols, vec
// and smem_bytes are the launch geometry (ops.py:_batched_geometry): R,
// P, C, 16-byte column loads and stores or not, and the block's dynamic
// shared memory, which must be this file's count for P and C.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for what
// this file does not compile or a geometry it does not take.
extern "C" int pregel_superstep_batched(
    const void* nbr, const void* mask, const void* w, const void* x,
    void* out, long long V, long long K, long long Vx, long long B,
    int state_type, int program, int op, int out_type, double fill,
    int rows_per_tile, int piece_slots, int cols, int vec, int smem_bytes,
    void* stream) {
  if (V <= 0 || B == 0) return 0;
  // rows in registers: short rows of 4-column groups on aligned x and out
  const bool shrt = K <= kShortRow && vec;
  if (K < 0 || K > INT_MAX || Vx < 1 || Vx > INT_MAX || B < 1 ||
      B > INT_MAX || piece_slots < 4 || piece_slots % 4 != 0 ||
      piece_slots > (shrt ? kMaxShortPiece : kMaxPieceBatched) ||
      cols < 1 || cols > B || rows_per_tile < 1 ||
      ((rows_per_tile > 1 || shrt) &&
       static_cast<long long>(rows_per_tile) * K > piece_slots) ||
      smem_bytes > kMaxSmem ||
      batched_smem_bytes(piece_slots, cols, shrt) != smem_bytes) {
    return cudaErrorInvalidValue;
  }
  // 16-byte column loads and stores need four columns a group, every row
  // of x and out on a 16-byte boundary
  if (vec && (B % 4 != 0 || cols % 4 != 0 ||
              reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(out) % 16 != 0)) {
    return cudaErrorInvalidValue;
  }
  // 4-slot groups load as one vector when the arrays allow it
  const bool aligned = reinterpret_cast<uintptr_t>(mask) % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(nbr) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const BatchedArgs a{nbr, mask, w, x, out, V, static_cast<int>(K),
                      static_cast<int>(Vx), static_cast<int>(B),
                      rows_per_tile, piece_slots, cols, vec != 0, aligned,
                      shrt, smem_bytes, fill,
                      static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  switch (state_type) {
    case I32:
      err = superstep_parts::batched_int32(program, op, out_type, a);
      break;
    case F32:
      err = superstep_parts::batched_float32(program, op, out_type, a);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
#endif  // SUPERSTEP_HAS(2)

// ---------------------------------------------------------------------------
// The dense superstep over the destination-sorted edge list, read as a CSR
// (part 4):
//
//     agg[v] = reduce_{rowptr[v] <= e < rowptr[v+1]} ( op,
//                                                  message(x[src[e]], w[e]) )
//
// min or max, and the identity `fill` where v has no in-edge.  This is
// core/pregel.py's dense path (gather, message, segment-combine) in one
// pass, with no mask, no [E] intermediate and no int64 segment index; it
// replaces no TPU kernel (the reference runs that path as jnp, and its
// Pallas kernel is the ELL entry above).  Plain version:
// ref.py:csr_superstep_plain; wrapper: ops.py:csr_superstep; the row
// offsets and the tile table come from ops.py:csr_layout, built once a
// graph.
//
// What bounds it on the H100: bytes.  Each edge's 4-byte source id (and
// its 4-byte weight for the programs that read one) once, the row offsets
// and the output once: at graph500 scale 21 (6.35e7 edges) 0.27 GB for
// BFS, 0.53 GB for SSSP.  x (4 B a vertex, 8 MB there) is gathered once
// an edge at random; it stays in the 50 MB L2.
//
// Design: an equal share of the work for every block whatever the rows'
// degrees (power-law graphs hold rows of 1e5 edges beside a majority
// under 32), and nothing written but the output.
//   * The work is the merge of the row ends with the edges (Merrill and
//     Garland's merge-path CSR SpMV): kCsrTile items, row ends and edges
//     together, a block.  The (row, edge) coordinate where each tile
//     starts is precomputed with the row offsets (the tile table), so a
//     block reads its range in two loads; a thread finds its own start
//     inside the tile by a binary search over the tile's row offsets in
//     shared memory.
//   * A block reads its rows' offsets, then its edges' ids (and weights)
//     as 16-byte evict-first loads (__ldcs), all of a thread's gathers of
//     x in flight together, and keeps each edge's message in shared
//     memory in edge order.  src and w are 16-byte aligned and hold a
//     multiple of 4 edges (the partition pads its shards to 256 edges);
//     the entry takes nothing else.
//   * A thread walks kCsrItems items in registers: an edge combines its
//     message into the running value, a row end writes the row out and
//     restarts (the identity for a row without edges).  The value open at
//     each thread's end is carried to the threads after it by a segmented
//     scan over the block (warp shuffles, then the warps' totals), and
//     combined into the row that thread closes first, which waits in a
//     register until then.
//   * A row cut by a tile boundary is merged with an atomic min or max:
//     a compare-and-swap loop over the same combine for float32 (NaN
//     propagating, as torch.amin/amax), atomicMin/atomicMax for int32.
//     A first launch sets exactly those rows to the monoid's neutral; the
//     tile that closes the row and each tile that carries part of it merge
//     into it.  min and max select among the plain version's values in
//     any order, so the result is bit-identical to it and to the dense
//     path's scatter_reduce.
//   * Padding edges (dst = V) lie past rowptr[V] and are never read; ids
//     are clamped into [0, Vx).  Nothing is allocated: the wrapper passes
//     the output, the two launches go to the caller's stream, the entry
//     point returns cudaGetLastError().

#if SUPERSTEP_HAS(4)

namespace {

constexpr int kCsrThreads = 256;
constexpr int kCsrItems = 8;                          // items a thread
constexpr int kCsrTile = kCsrThreads * kCsrItems;     // items a block
// 4-edge groups a thread loads at most (a tile's edges may start
// mid-group)
constexpr int kCsrGroups = (kCsrTile / 4 + 1 + kCsrThreads - 1) / kCsrThreads;

// int32 only for program 0 on int32 state, float32 otherwise (the ELL
// entry's typing without a reduced-precision channel)
template <typename TIn, int PROG>
using CsrAcc = typename std::conditional<PROG == SRC && std::is_same<TIn, int>::value,
                                         int, float>::type;

__device__ __forceinline__ int clamp_csr(int id, int Vx) {
  return id < 0 ? 0 : (id >= Vx ? Vx - 1 : id);
}

template <int OP>
__device__ __forceinline__ void atomic_merge(int* p, int v) {
  if constexpr (OP == MIN) {
    atomicMin(p, v);
  } else {
    atomicMax(p, v);
  }
}

template <int OP>
__device__ __forceinline__ void atomic_merge(float* p, float v) {
  unsigned* a = reinterpret_cast<unsigned*>(p);
  unsigned old = *reinterpret_cast<volatile unsigned*>(a);
  // values only ever move towards the combine's result, so a value that
  // does not change `old` changes no later one either
  while (true) {
    const unsigned nv = __float_as_uint(combine<OP>(__uint_as_float(old), v));
    if (nv == old) return;
    const unsigned seen = atomicCAS(a, old, nv);
    if (seen == old) return;
    old = seen;
  }
}

template <typename A>
struct CsrShared {
  int rp[kCsrTile + 1];      // rowptr[i0 .. i1]
  A msg[kCsrTile];           // the tile's messages, in edge order
  A warp_val[kCsrThreads / 32];
  int warp_flag[kCsrThreads / 32];
};

// The rows that a tile boundary cuts (a tile starts inside them): the
// monoid's neutral, before the superstep merges into them.
template <typename A, int OP>
__global__ void csr_cut_rows_kernel(const int* __restrict__ rowptr,
                                    const int2* __restrict__ tiles,
                                    A* __restrict__ out, long long n_tiles,
                                    int V) {
  const long long t = 1 + blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (t >= n_tiles) return;
  const int2 c = tiles[t];
  if (c.x < V && __ldg(rowptr + c.x) < c.y) out[c.x] = neutral<OP, A>();
}

template <typename TIn, int PROG, int OP>
__global__ void __launch_bounds__(kCsrThreads) csr_superstep_kernel(
    const int* __restrict__ rowptr, const int2* __restrict__ tiles,
    const int* __restrict__ src, const float* __restrict__ w,
    const TIn* __restrict__ x, CsrAcc<TIn, PROG>* __restrict__ out, int V,
    int Vx, CsrAcc<TIn, PROG> fill) {
  using A = CsrAcc<TIn, PROG>;
  constexpr bool kReadsW = PROG == SRC_PLUS_W || PROG == SRC_TIMES_W;
  __shared__ CsrShared<A> sh;
  const int tid = threadIdx.x;
  const int2 c0 = tiles[blockIdx.x];
  const int2 c1 = tiles[blockIdx.x + 1];
  const int i0 = c0.x, j0 = c0.y, j1 = c1.y;
  const int n_rows = c1.x - i0;       // row ends in the tile
  const int n_edges = j1 - j0;        // edges in the tile

  for (int k = tid; k <= n_rows; k += kCsrThreads) {
    sh.rp[k] = __ldg(rowptr + i0 + k);
  }
  const int base = j0 & ~3;
  int4 ids[kCsrGroups];
  float4 ws[kCsrGroups];
#pragma unroll
  for (int u = 0; u < kCsrGroups; ++u) {
    const int p = base + 4 * (tid + u * kCsrThreads);
    ids[u] = make_int4(0, 0, 0, 0);
    ws[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p < j1) {
      ids[u] = __ldcs(reinterpret_cast<const int4*>(src + p));
      if constexpr (kReadsW) {
        ws[u] = __ldcs(reinterpret_cast<const float4*>(w + p));
      }
    }
  }
  TIn xs[kCsrGroups][4];
#pragma unroll
  for (int u = 0; u < kCsrGroups; ++u) {
    const int p = base + 4 * (tid + u * kCsrThreads);
    const int id4[4] = {ids[u].x, ids[u].y, ids[u].z, ids[u].w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (p < j1 && p + c >= j0 && p + c < j1) {
        xs[u][c] = __ldg(x + clamp_csr(id4[c], Vx));
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kCsrGroups; ++u) {
    const int p = base + 4 * (tid + u * kCsrThreads);
    float w4[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (kReadsW) {
      if (p < j1) {
        w4[0] = ws[u].x; w4[1] = ws[u].y; w4[2] = ws[u].z; w4[3] = ws[u].w;
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (p < j1 && p + c >= j0 && p + c < j1) {
        sh.msg[p + c - j0] = static_cast<A>(edge_program<PROG>(xs[u][c], w4[c]));
      }
    }
  }
  __syncthreads();

  // this thread's start on the tile's merge path: r rows closed, e edges
  // taken (row r's end is rp[r + 1] - j0 in tile edges)
  const int items = n_rows + n_edges;
  const int d = min(tid * kCsrItems, items);
  int lo = max(0, d - n_edges), hi = min(d, n_rows);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sh.rp[mid + 1] - j0 + mid < d) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  // rows closed after a thread's first have all their edges in the
  // thread's walk: they go out at once (the identity where empty)
  const int first = lo;               // the row this thread closes first
  int r = lo, e = d - lo;
  const int mine = min(kCsrItems, items - d);
  A acc = neutral<OP, A>();
  A first_val = acc;
  bool closed = false;
#pragma unroll
  for (int k = 0; k < kCsrItems; ++k) {
    if (k < mine) {
      if (r == n_rows || e < sh.rp[r + 1] - j0) {
        acc = combine<OP>(acc, sh.msg[e]);
        ++e;
      } else {
        if (closed) {
          out[i0 + r] = sh.rp[r] == sh.rp[r + 1] ? fill : acc;
        } else {
          first_val = acc;
          closed = true;
        }
        acc = neutral<OP, A>();
        ++r;
      }
    }
  }

  // segmented inclusive scan of the open values, a segment starting at
  // each thread that closed a row: (f, v) after (fp, vp) is
  // (f | fp, f ? v : combine(vp, v))
  const int lane = tid & 31, warp = tid >> 5;
  int f = closed;
  A v = acc;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const A vp = __shfl_up_sync(0xffffffffu, v, s);
    const int fp = __shfl_up_sync(0xffffffffu, f, s);
    if (lane >= s) {
      if (!f) v = combine<OP>(vp, v);
      f |= fp;
    }
  }
  if (lane == 31) {
    sh.warp_val[warp] = v;
    sh.warp_flag[warp] = f;
  }
  __syncthreads();
  A pv = neutral<OP, A>();            // the warps before this one
  for (int k = 0; k < warp; ++k) {
    pv = sh.warp_flag[k] ? sh.warp_val[k] : combine<OP>(pv, sh.warp_val[k]);
  }
  if (!f) v = combine<OP>(pv, v);
  A carry = __shfl_up_sync(0xffffffffu, v, 1);
  if (lane == 0) carry = pv;
  // a thread's first row takes what the threads before it carry
  if (closed) {
    const int b = sh.rp[first];
    if (b == sh.rp[first + 1]) {
      out[i0 + first] = fill;
    } else if (first == 0 && b < j0) {      // begun in an earlier tile
      atomic_merge<OP>(out + i0, combine<OP>(carry, first_val));
    } else {
      out[i0 + first] = combine<OP>(carry, first_val);
    }
  }
  // the row open at the tile's end, if the tile holds some of its edges
  if (tid == kCsrThreads - 1 && i0 + n_rows < V &&
      j1 > max(j0, sh.rp[n_rows])) {
    atomic_merge<OP>(out + i0 + n_rows, v);
  }
}

struct CsrArgs {
  const int* rowptr;
  const int2* tiles;
  long long n_tiles;
  const int* src;
  const float* w;
  const void* x;
  void* out;
  int V;
  int Vx;
  double fill;
  cudaStream_t stream;
};

template <typename TIn, int PROG, int OP>
cudaError_t launch_csr(const CsrArgs& a) {
  using A = CsrAcc<TIn, PROG>;
  A* out = static_cast<A*>(a.out);
  if (a.n_tiles > 1) {
    const long long cuts = a.n_tiles - 1;
    csr_cut_rows_kernel<A, OP>
        <<<static_cast<unsigned>((cuts + 255) / 256), 256, 0, a.stream>>>(
            a.rowptr, a.tiles, out, a.n_tiles, a.V);
  }
  csr_superstep_kernel<TIn, PROG, OP>
      <<<static_cast<unsigned>(a.n_tiles), kCsrThreads, 0, a.stream>>>(
          a.rowptr, a.tiles, a.src, a.w, static_cast<const TIn*>(a.x), out,
          a.V, a.Vx, static_cast<A>(a.fill));
  return cudaGetLastError();
}

template <typename TIn, int PROG>
cudaError_t csr_by_op(int op, const CsrArgs& a) {
  switch (op) {
    case MIN: return launch_csr<TIn, PROG, MIN>(a);
    case MAX: return launch_csr<TIn, PROG, MAX>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename TIn>
cudaError_t csr_by_prog(int program, int op, const CsrArgs& a) {
  switch (program) {
    case SRC: return csr_by_op<TIn, SRC>(op, a);
    case SRC_PLUS_ONE: return csr_by_op<TIn, SRC_PLUS_ONE>(op, a);
    case SRC_PLUS_W: return csr_by_op<TIn, SRC_PLUS_W>(op, a);
    case SRC_TIMES_W: return csr_by_op<TIn, SRC_TIMES_W>(op, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point (bound with ctypes).  rowptr is [V + 1] int32, tiles
// [n_tiles + 1, 2] int32 (ops.py:csr_layout, for kCsrTile items a tile),
// src and w the n_src edges (src int32, w float32, both 16-byte aligned,
// n_src a multiple of 4; edges past rowptr[V] are not read), x [Vx] int32
// or float32, out [V] (int32 for program 0 on int32 state, else float32).
// op is min or max.  Returns cudaGetLastError() after the launches, or
// cudaErrorInvalidValue for what this file does not take.
extern "C" int pregel_superstep_csr(const void* rowptr, const void* tiles,
                                    long long n_tiles, const void* src,
                                    long long n_src, const void* w,
                                    const void* x, void* out, long long V,
                                    long long Vx, int state_type, int program,
                                    int op, double fill, void* stream) {
  if (V <= 0) return 0;
  if (V > INT_MAX || Vx < 1 || Vx > INT_MAX || n_tiles < 1 ||
      n_tiles > INT_MAX || n_src < 0 || n_src % 4 != 0 ||
      reinterpret_cast<uintptr_t>(tiles) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(src) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const CsrArgs a{static_cast<const int*>(rowptr),
                  static_cast<const int2*>(tiles), n_tiles,
                  static_cast<const int*>(src), static_cast<const float*>(w),
                  x, out, static_cast<int>(V), static_cast<int>(Vx), fill,
                  static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  switch (state_type) {
    case I32: err = csr_by_prog<int>(program, op, a); break;
    case F32: err = csr_by_prog<float>(program, op, a); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
#endif  // SUPERSTEP_HAS(4)
