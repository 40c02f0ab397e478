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
#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

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
// flat [V, K] arrays are walked in pieces of kPiece slots (more than one
// only for a row longer than a piece).
struct Tile {
  long long row0;
  int rows;
  long long s0;
  int n;
  int pieces;
};

__device__ __forceinline__ Tile make_tile(long long V, int K, int R,
                                          long long t) {
  Tile s;
  s.row0 = t * R;
  const long long left = V - s.row0;
  s.rows = left < R ? static_cast<int>(left) : R;
  s.s0 = s.row0 * K;
  s.n = s.rows * K;
  s.pieces = (s.n + kPiece - 1) / kPiece;
  return s;
}

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

}  // namespace

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
