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
// What bounds it on the H100: bytes.  Per call the function must read
// nbr (4 B), mask (1 B) and, for the programs that use it, w (4 B) for
// each of the V*K slots, the gather source x once (4 B * Vx), and write
// 4 B * V -- about one operation per byte, far below the card's
// operations-per-byte balance, so the least time is bytes / 3.35 TB/s.
//
// Design (simple and right first; speed is later work):
//   * A group of G lanes owns one destination row; a warp holds 32/G
//     rows.  The wrapper picks G, the power of two at or above K/16
//     (between 2 and 32): each lane strides up to 16 of the row's slots,
//     keeping several independent gathers in flight, while neighbouring
//     lanes still load neighbouring nbr/mask/w words.
//   * A slot whose mask is off skips the gather: it contributes `fill`.
//     A slot that is on clamps nbr into [0, Vx) before the
//     gather -- padding slots carry the sentinel id V, and Vx may be V,
//     so an unclamped load could read past x.
//   * The edge program is one of four compiled programs (x, x+1, x+w,
//     x*w), chosen at run time by index; each is written with _rn
//     intrinsics so the compiler cannot fuse it into the reduction and
//     round differently from the plain version.
//   * The message is cast to the output type (the reduced-precision
//     channel: bf16/f16 round to nearest even, as torch's .to() does)
//     before the reduce.  min/max then select among exactly those values,
//     so they are bit-identical to the plain version; a float sum differs
//     only in summation order.  bf16/f16 accumulate in float32 and round
//     once at the end, as torch's reductions do.
//   * The row is reduced with xor shuffles inside its group; lane 0 of
//     the group stores.  Nothing is allocated and nothing synchronises;
//     the launch goes to the caller's stream and the entry point returns
//     cudaGetLastError().
//
// TPU-only behaviour left out on purpose: the 16 MiB VMEM budget for x
// with its fallback to the reference (x stays in device memory and L2 on
// the card; the gather reads it through the read-only path), and the
// padding of rows to 512 and K to 128 lanes (this kernel masks its ragged
// edge itself; re-padding three [V,K] arrays every superstep would cost
// more than the kernel).

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

// Neutral start of a lane's partial reduction (lanes past K hold it).
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

template <typename TIn, int PROG, int OP, int OUT>
__global__ void __launch_bounds__(kThreads) superstep_kernel(
    const int* __restrict__ nbr, const uint8_t* __restrict__ mask,
    const float* __restrict__ w, const TIn* __restrict__ x,
    typename OutType<OUT>::type* __restrict__ out, long long V, int K,
    int Vx, double fill, int lanes_log2) {
  using Acc = typename AccType<OUT>::type;
  const int group = 1 << lanes_log2;
  const int sub = threadIdx.x & (group - 1);
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >>
      lanes_log2;
  const bool live = row < V;
  const Acc fill_acc = to_acc<OUT>(fill);
  Acc acc = neutral<OP, Acc>();
  if (live) {
    const long long base = row * K;
    for (int k = sub; k < K; k += group) {
      Acc c = fill_acc;
      // nbr is loaded beside mask, not after it: two independent loads
      // instead of a chain of three before the gather
      int j = __ldg(nbr + base + k);
      if (__ldg(mask + base + k)) {
        j = j < 0 ? 0 : (j >= Vx ? Vx - 1 : j);
        float wk = 0.0f;
        if constexpr (PROG == SRC_PLUS_W || PROG == SRC_TIMES_W) {
          wk = __ldg(w + base + k);
        }
        c = to_acc<OUT>(edge_program<PROG>(__ldg(x + j), wk));
      }
      acc = combine<OP>(acc, c);
    }
  }
  // every lane of the warp reaches the shuffles (no early return above)
  for (int o = group >> 1; o > 0; o >>= 1) {
    acc = combine<OP>(acc, __shfl_xor_sync(0xffffffffu, acc, o));
  }
  if (live && sub == 0) {
    out[row] = store_value<OUT>(K == 0 ? fill_acc : acc);
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
  double fill;
  int lanes_log2;
  cudaStream_t stream;
};

template <typename TIn, int PROG, int OP, int OUT>
cudaError_t launch(const Args& a) {
  const long long threads = a.V << a.lanes_log2;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  superstep_kernel<TIn, PROG, OP, OUT>
      <<<static_cast<unsigned>(blocks), kThreads, 0, a.stream>>>(
          static_cast<const int*>(a.nbr), static_cast<const uint8_t*>(a.mask),
          static_cast<const float*>(a.w), static_cast<const TIn*>(a.x),
          static_cast<typename OutType<OUT>::type*>(a.out), a.V, a.K, a.Vx,
          a.fill, a.lanes_log2);
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
// as void*; the return value is cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for a combination this file does not
// compile.
extern "C" int pregel_superstep(const void* nbr, const void* mask,
                                const void* w, const void* x, void* out,
                                long long V, long long K, long long Vx,
                                int state_type, int program, int op,
                                int out_type, double fill, int lanes_log2,
                                void* stream) {
  if (V <= 0) return 0;
  if (K < 0 || K > INT_MAX || Vx < 1 || Vx > INT_MAX || lanes_log2 < 0 ||
      lanes_log2 > 5) {
    return cudaErrorInvalidValue;
  }
  const Args a{nbr, mask, w, x, out, V, static_cast<int>(K),
               static_cast<int>(Vx), fill, lanes_log2,
               static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  switch (state_type) {
    case I32: err = by_prog<int>(program, op, out_type, a); break;
    case F32: err = by_prog<float>(program, op, out_type, a); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
