// Flash attention forward (online softmax) for Hopper (sm_90a).
//
//     o[b, h, i] = sum_j softmax_j(mask(i, j) ? cap(q[b,h,i] . k[b,h/G,j]
//                                                   / sqrt(D)) : -inf)
//                  * v[b, h/G, j]
//
// with cap(x) = softcap * tanh(x / softcap) when softcap > 0, the causal
// mask j <= i, the sliding-window mask j > i - window when window > 0, and
// G = Hq / Hkv query heads per kv head (GQA; MQA is Hkv = 1).  float32 or
// bfloat16 in, float32 accumulation, the output in the input's type; a row
// with no valid key comes out 0.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:30
// (_flash_kernel, launched by flash_attention_pallas).  The plain PyTorch
// version is ref.py (mha_plain); ops.py checks arguments, allocates the
// output and launches this file's entry point through ctypes.
//
// What bounds it on the H100: operations.  The function does 4 * D
// floating-point operations per valid (query, key) pair and query head
// (two dots of length D), so at Gemma-2's prefill shape (B = 2, S = 8192,
// Hq = 8, D = 256, causal) a global layer needs 5.5e11 of them against
// 0.13 GB of q, k, v and o: 0.56 ms at the tensor cores' 989 TFLOP/s
// (bf16) against 0.04 ms of memory traffic.  Two kernels:
//   * bfloat16 runs both products on the tensor cores with Hopper's
//     warpgroup MMA (wgmma), its tiles brought by the Tensor Memory
//     Accelerator (TMA) into a two-stage ring, one producer warpgroup
//     beside two consumer warpgroups (flash_fwd_wgmma_kernel; its own
//     design notes are above it).
//   * float32 runs them on the FMA units (flash_fwd_kernel; 67 TFLOP/s at
//     most), exact to float32 summation order, as the float32 oracles
//     need: bf16 or TF32 tensor-core products would round the inputs.
// The design both share:
//   * One block per (query tile, query head, batch row): 64 rows for
//     float32, 128 for bfloat16.  A loop over key tiles takes the place
//     of the TPU grid's sequential kv axis; the running max m, the
//     denominator l and the output accumulator stay in registers for the
//     block's whole life.
//   * Only the key tiles that the causal and window masks leave partly
//     open are visited (the band [q0 - window + 1, q0 + rows - 1]); a
//     key tile that is wholly masked for the block is never loaded.
//     Query tiles are issued last-first, so the long causal rows start
//     first (for bfloat16, the last tile of every head before any head's
//     second-to-last).
//   * q, k and v are read in place at the caller's strides (the model's
//     [B, S, H, D] activations, transposed, need no copy), with the kv
//     head h / G indexed directly: no k/v repeat per group.  The tiles
//     take more than the 48 KB default of shared memory (at D = 256: 147
//     KB float32, 193 KB bfloat16), so the entry point raises the
//     kernel's dynamic shared-memory limit before each launch.
//   * The TPU kernel runs exp(NEG_INF - NEG_INF) = 1 on a row whose first
//     tiles are all masked and relies on a later tile to wipe it out; here
//     a row whose running max is still -inf takes p = 0, so masked tiles
//     contribute nothing in any order.
//   * Any S: the ragged last tiles are masked (rows beyond S read as 0,
//     keys beyond S are masked, output rows beyond S are not written).
//     The TPU kernel's S % block == 0 rule and its 512 x 512 blocks are
//     TPU tiling and do not apply.
// Nothing is allocated and nothing synchronises; the launch goes to the
// caller's stream, and the entry point returns cudaGetLastError().

#include <cuda.h>   // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kRows = kBQ / 16;  // query rows per thread
constexpr int kKeys = kBK / 16;  // keys per thread
constexpr int kPStride = kBK + 4;

template <int D>
struct Shape {
  static constexpr int kStride = D + 4;   // floats per row in shared memory
  static constexpr int kCols = D / 16;    // accumulator columns per thread
  static constexpr size_t kSmemBytes =
      sizeof(float) * (static_cast<size_t>(kBQ) * kStride +
                       static_cast<size_t>(kBK) * kStride +
                       static_cast<size_t>(kBQ) * kPStride);
};

// Column c (0 <= c < D / 16) of the accumulator owned by lane tx: runs of
// four neighbouring columns at 4 tx + 64 m when D >= 64, so a row of V is
// read as one contiguous 256-byte span by the 16 lanes.
template <int D>
__device__ __forceinline__ int acc_col(int tx, int c) {
  constexpr int kCols = D / 16;
  if constexpr (kCols >= 4) {
    return (c >> 2) * 64 + tx * 4 + (c & 3);
  } else {
    return tx * kCols + c;
  }
}

// A tile of 64 rows x D float32 from global memory (row stride `stride`
// elements, 16-byte aligned rows) into shared memory; rows at or beyond
// `rows` are filled with 0.
template <int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          long long stride, int rows,
                                          int tid) {
  constexpr int kChunks = D / 4;
  constexpr int kStride = Shape<D>::kStride;
  for (int c = tid; c < 64 * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 4;
    *reinterpret_cast<float4*>(dst + r * kStride + col) =
        r < rows ? __ldg(reinterpret_cast<const float4*>(
                       src + static_cast<long long>(r) * stride + col))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

struct Strides {
  long long b, h, s;
};

// ---------------------------------------------------------------------
// float32: 256 threads on the FMA units.  Tiles are kept in shared memory
// (rows padded by 4 floats, so 16-byte reads of 8 neighbouring rows hit
// distinct banks).  Each thread owns 4 query rows (ty + 16 i) and 4 keys
// (tx + 16 j) of the 64 x 64 logit tile and D / 16 columns of the
// accumulator; row max and row sum are reduced over the 16 lanes of a row
// group with xor shuffles.  K is overwritten by V in the same buffer once
// the probabilities are in shared memory.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int S,
                     int group, Strides qs, Strides ks, Strides vs,
                     Strides os, int causal, int window, float softcap,
                     float sqrt_d) {
  constexpr int kStride = Shape<D>::kStride;
  constexpr int kCols = Shape<D>::kCols;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* KVs = Qs + kBQ * kStride;
  float* Ps = KVs + kBK * kStride;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int qt = static_cast<int>(gridDim.x - 1 - blockIdx.x);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int q0 = qt * kBQ;
  const int q_rows = min(kBQ, S - q0);

  const float* qp =
      q + b * qs.b + h * qs.h + static_cast<long long>(q0) * qs.s;
  const float* kp = k + b * ks.b + hk * ks.h;
  const float* vp = v + b * vs.b + hk * vs.h;
  load_tile<D>(Qs, qp, qs.s, q_rows, tid);

  // the band of keys some row of this tile may see
  int kv_lo = 0;
  int kv_hi = S;
  if (causal) kv_hi = min(S, q0 + q_rows);
  if (window > 0) kv_lo = max(0, q0 - window + 1);
  const int t_lo = kv_lo / kBK;
  const int t_hi = (kv_hi + kBK - 1) / kBK;

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBK;
    const int k_rows = min(kBK, S - k0);
    __syncthreads();  // Q is in place; the last tile's V and P are read
    load_tile<D>(KVs, kp + static_cast<long long>(k0) * ks.s, ks.s, k_rows,
                 tid);
    __syncthreads();

    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[kRows], kb[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qa[i] = *reinterpret_cast<const float4*>(
            Qs + (ty + 16 * i) * kStride + d);
      }
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        kb[j] = *reinterpret_cast<const float4*>(
            KVs + (tx + 16 * j) * kStride + d);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int kj = k0 + tx + 16 * j;
        float x = s[i][j] / sqrt_d;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = kj < S;
        if (causal) ok = ok && kj <= qi;
        if (window > 0) ok = ok && kj > qi - window;
        s[i][j] = ok ? x : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m[i], mx);
      float alpha = 1.f;
      float sum = 0.f;
      if (m_new == -INFINITY) {  // nothing valid in this row yet
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
      } else {
        alpha = expf(m[i] - m_new);  // 0 when m[i] is -inf
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          s[i][j] = expf(s[i][j] - m_new);
          sum += s[i][j];
        }
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        Ps[(ty + 16 * i) * kPStride + tx + 16 * j] = s[i][j];
      }
    }
    __syncthreads();  // P is written; every thread is done with K
    load_tile<D>(KVs, vp + static_cast<long long>(k0) * vs.s, vs.s, k_rows,
                 tid);
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 p4[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        p4[i] = *reinterpret_cast<const float4*>(
            Ps + (ty + 16 * i) * kPStride + j);
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vrow = KVs + (j + jj) * kStride;
        float vv[kCols];
        if constexpr (kCols >= 4) {
#pragma unroll
          for (int c = 0; c < kCols; c += 4) {
            const float4 x = *reinterpret_cast<const float4*>(
                vrow + acc_col<D>(tx, c));
            vv[c] = x.x;
            vv[c + 1] = x.y;
            vv[c + 2] = x.z;
            vv[c + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < kCols; ++c) vv[c] = vrow[acc_col<D>(tx, c)];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float p = jj == 0   ? p4[i].x
                          : jj == 1 ? p4[i].y
                          : jj == 2 ? p4[i].z
                                    : p4[i].w;
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty + 16 * i;
    if (r >= q_rows) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    float* orow =
        o + b * os.b + h * os.h + static_cast<long long>(q0 + r) * os.s;
#pragma unroll
    for (int c = 0; c < kCols; ++c) orow[acc_col<D>(tx, c)] = acc[i][c] * inv;
  }
}

// ---------------------------------------------------------------------
// bfloat16: Hopper's warpgroup MMA (wgmma) fed by the Tensor Memory
// Accelerator (TMA), warp-specialised (FlashAttention-3's shape, kept
// simple).  One block per (128-row query tile, query head, batch row):
// two consumer warpgroups of 64 query rows each and one producer
// warpgroup, of which one thread issues every copy.
//   * The host encodes three TMA tensor maps over the caller's strided
//     [B, H, S, D] views (q, k, v; the model's transposed [B, S, H, D]
//     activations go in without a copy) and passes them as
//     __grid_constant__ parameters.  Tiles land in shared memory in the
//     128-byte swizzle that wgmma reads, one 64-column chunk (128 bytes a
//     row) at a time; columns past D (head dims 16 and 32) and rows past
//     S come in as zeros (TMA's out-of-bounds fill), so a ragged last tile
//     needs no code.
//   * Q is loaded once; K and V tiles go through a ring of two stages
//     with full and empty mbarriers (K and V apart, so Q K^T starts
//     before V lands).  The producer gives up registers (setmaxnreg) to
//     the consumers.
//   * S = Q K^T: both operands from shared memory (K-major).  The logits
//     are soft-capped and masked in registers, the online softmax
//     updates m and l, and P is rounded to bf16 in registers, where it is
//     already wgmma's A-operand layout (at head dims up to 32, P V is
//     taken once more with what that rounding left, see kSplitP).
//     O += P V takes P from registers and V from shared memory through
//     the descriptor's transpose (MN-major).  The accumulator stays
//     float32 in registers.
//   * Inside a warpgroup the softmax of tile i runs while P V of tile
//     i - 1 is still on the tensor cores; then S of tile i + 1 and P V of
//     tile i are issued together and only S is waited for.  The scale
//     (or the cap) and log2(e) fold into one FFMA before ex2, and the
//     accumulator is rescaled only when some row's max moved.
//   * l sums the float32 probabilities before their rounding to bf16
//     (one FADD each; summing the rounded values would cost two more
//     instructions a pair to unpack them).
//   * Key tiles outside the block's band are never loaded.  Both
//     warpgroups walk the same tiles; at the band's edges a tile wholly
//     outside one warpgroup's rows is masked out (at most one at each
//     edge).
// Keys per tile: 128 up to D = 128, 64 at D = 256, where the 64 x 256
// float32 accumulator already takes 128 registers a thread.

constexpr int kTileQ = 128;               // query rows per block
constexpr int kConsumerThreads = 256;     // two warpgroups of 64 rows
constexpr int kWsThreads = kConsumerThreads + 128;   // + the producer
constexpr int kRowBytes = 128;            // one swizzled row: 64 bf16

template <int D>
struct WgShape {
  static constexpr int kCols = D < 64 ? 64 : D;    // columns in shared
  static constexpr int kChunks = kCols / 64;       // 128-byte chunks
  static constexpr int kBK = D <= 128 ? 128 : 64;  // keys per tile
  static constexpr int kStages = 2;                 // K/V ring depth
  // P V also with P's bf16 rounding residue (a second product): at head
  // dims up to 32 a row has too few outputs for the rounding of P to
  // average out against the row's size, and the bf16 probabilities alone
  // miss REL_TOL on long rows there; at 64 and above they hold it
  static constexpr bool kSplitP = D <= 32;
  static constexpr int kQChunk = kTileQ * kRowBytes;
  static constexpr int kKVChunk = kBK * kRowBytes;
  static constexpr int kQBytes = kChunks * kQChunk;
  static constexpr int kKVBytes = kChunks * kKVChunk;   // one K or V tile
  static constexpr int kBarriers = 1 + 4 * kStages;
  // + 1 KB to align the tiles to the swizzle's 1024-byte period
  static constexpr size_t kSmemBytes =
      1024 + kQBytes + 2 * kStages * kKVBytes + 8 * kBarriers;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of a 4-D tensor map (coordinates innermost first: column, row,
// head, batch) into shared memory; completion is counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma's registers
// across the asynchronous instructions that own them.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d[0, 32) (+)= A (64 x 16, shared, K-major) * B (16 x 64, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n64(
    float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[0, 64) (+)= A (64 x 16, shared, K-major) * B (16 x 128, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n128(
    float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[0, 32) += A (64 x 16, registers) * B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(
    float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[0, 64) += A (64 x 16, registers) * B (16 x 128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(
    float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[0, 128) += A (64 x 16, registers) * B (16 x 256, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(
    float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b,
                                         int accumulate) {
  if constexpr (N == 64) {
    wgmma_ss_n64(d, a, b, accumulate);
  } else {
    static_assert(N == 128, "keys per tile");
    wgmma_ss_n128(d, a, b, accumulate);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t b) {
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, b);
  } else if constexpr (N == 128) {
    wgmma_rs_n128(d, a, b);
  } else {
    static_assert(N == 256, "head dim");
    wgmma_rs_n256(d, a, b);
  }
}

// 2^x on the special-function unit (2^-inf = 0); its relative error,
// about 2^-22, is far below the bf16 rounding of p that follows
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (lo, hi) rounded to bf16 and packed; `sum` gets the pair's sum
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi,
                                              float& sum) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  sum += lo + hi;
  return *reinterpret_cast<const uint32_t*>(&h);
}

// What rounding (lo, hi) to the packed pair left, itself in bf16
__device__ __forceinline__ uint32_t pack_residue(float lo, float hi,
                                                 uint32_t packed) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&packed);
  const __nv_bfloat162 r =
      __floats2bfloat162_rn(lo - __low2float(h), hi - __high2float(h));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Logits of one S tile (rows qi[0], qi[1]; keys k0 + 8 n + 2 t + {0, 1})
// to y in place: tanh(s * y_in) with a softcap, else s itself; -inf where
// the causal, window or length mask closes the pair; mx gets each row's
// largest y (over four partial maxima: one chain of BK / 4 dependent
// fmaxf a row would leave the warp waiting on their latency).
template <int BK, bool kCap, bool kMask>
__device__ __forceinline__ void to_y(float* sacc, float* mx, float y_in,
                                     int k0, const int* qi, int t, int S,
                                     int causal, int window) {
  float part[2][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) part[0][j] = part[1][j] = -INFINITY;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float y = sacc[n * 4 + e];
      if constexpr (kCap) y = tanhf(y * y_in);
      if constexpr (kMask) {
        const int q_i = qi[e >> 1];
        const int kj = k0 + n * 8 + 2 * t + (e & 1);
        bool ok = kj < S;
        if (causal) ok = ok && kj <= q_i;
        if (window > 0) ok = ok && kj > q_i - window;
        y = ok ? y : -INFINITY;
      }
      sacc[n * 4 + e] = y;
      part[e >> 1][n & 3] = fmaxf(part[e >> 1][n & 3], y);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(fmaxf(part[r][0], part[r][1]),
                  fmaxf(part[r][2], part[r][3]));
  }
}

template <int D>
__global__ void __launch_bounds__(kWsThreads, 1)
    flash_fwd_wgmma_kernel(__grid_constant__ const CUtensorMap tq,
                           __grid_constant__ const CUtensorMap tk,
                           __grid_constant__ const CUtensorMap tv,
                           __nv_bfloat16* __restrict__ o, int S, int group,
                           Strides os, int causal, int window, float softcap,
                           float scale) {
  using Sh = WgShape<D>;
  constexpr int BK = Sh::kBK;
  constexpr int kCols = Sh::kCols;
  constexpr int kStages = Sh::kStages;
  extern __shared__ uint8_t smem_ws[];
  const uint32_t sQ = (smem_addr(smem_ws) + 1023u) & ~1023u;
  const uint32_t sK = sQ + Sh::kQBytes;
  const uint32_t sV = sK + kStages * Sh::kKVBytes;
  const uint32_t bars = sV + kStages * Sh::kKVBytes;
  const uint32_t q_full = bars;
  // per stage s: K full, V full, K empty, V empty
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto k_empty = [&](int s) { return bars + 8 * (1 + 2 * kStages + s); };
  auto v_empty = [&](int s) { return bars + 8 * (1 + 3 * kStages + s); };

  const int tid = threadIdx.x;
  // blocks are issued head-fastest and query tile slowest, last tile
  // first: the longest causal rows of every head start first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = static_cast<int>(gridDim.z - 1 - blockIdx.z);
  const int hk = h / group;
  const int q0 = qt * kTileQ;
  const int q_rows = min(kTileQ, S - q0);
  // the band of keys some row of this tile may see
  int kv_lo = 0;
  int kv_hi = S;
  if (causal) kv_hi = min(S, q0 + q_rows);
  if (window > 0) kv_lo = max(0, q0 - window + 1);
  const int t_lo = kv_lo / BK;
  const int n_tiles = (kv_hi + BK - 1) / BK - t_lo;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), kConsumerThreads / 128);   // one per warpgroup
      mbar_init(v_empty(s), kConsumerThreads / 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumerThreads) {
    // ---- producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == kConsumerThreads) {
      mbar_expect_tx(q_full, Sh::kQBytes);
      for (int c = 0; c < Sh::kChunks; ++c) {
        tma_load(sQ + c * Sh::kQChunk, &tq, q_full, c * 64, q0, h, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        // a stage's first use passes at once (the phase before 0)
        const uint32_t parity = ((i / kStages) & 1) ^ 1;
        const int k0 = (t_lo + i) * BK;
        mbar_wait(k_empty(s), parity);
        mbar_expect_tx(k_full(s), Sh::kKVBytes);
        for (int c = 0; c < Sh::kChunks; ++c) {
          tma_load(sK + s * Sh::kKVBytes + c * Sh::kKVChunk, &tk, k_full(s),
                   c * 64, k0, hk, b);
        }
        mbar_wait(v_empty(s), parity);
        mbar_expect_tx(v_full(s), Sh::kKVBytes);
        for (int c = 0; c < Sh::kChunks; ++c) {
          tma_load(sV + s * Sh::kKVBytes + c * Sh::kKVChunk, &tv, v_full(s),
                   c * 64, k0, hk, b);
        }
      }
    }
  } else {
    // ---- two consumer warpgroups, 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = tid >> 7;
    // one thread releases a stage for its warpgroup: a wgmma's reads of
    // shared memory are over once any of its threads has waited for it
    const bool releases = (tid & 127) == 0;
    auto release = [&](uint32_t bar) {
      if (releases) mbar_arrive(bar);
    };
    const int warp = (tid >> 5) & 3;
    const int lane = tid & 31;
    const int g = lane >> 2;   // accumulator row (and row + 8)
    const int t = lane & 3;    // accumulator columns 2 t, 2 t + 1
    const int row0 = wg * 64 + warp * 16 + g;      // in the query tile
    const int qi[2] = {q0 + row0, q0 + row0 + 8};
    // this warpgroup's first and last rows (for the mask test)
    const int wg_first = q0 + wg * 64;
    const int wg_last = wg_first + 63;
    // logits are kept as y: the raw dot q.k, or tanh(q.k * scale / cap)
    // with a softcap; p = 2^(y c - m c) with c folding the scale (or the
    // cap) and log2(e), so a logit costs one FFMA and one ex2
    constexpr float kLog2e = 1.4426950408889634f;
    const float y_in = softcap > 0.f ? scale / softcap : 0.f;
    const float c = softcap > 0.f ? softcap * kLog2e : scale * kLog2e;

    float m[2] = {-INFINITY, -INFINITY};   // running max of y per row
    float l[2] = {0.f, 0.f};
    float acc[kCols / 2];   // O: 64 x kCols, four values per 8 columns
    float sacc[BK / 2];     // S: 64 x BK
    uint32_t pa[BK / 16][4];   // P in bf16, wgmma's A-fragment layout
    uint32_t pr[Sh::kSplitP ? BK / 16 : 1][4];   // its residue (kSplitP)
#pragma unroll
    for (int i = 0; i < kCols / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sacc[i] = 0.f;

    const uint32_t q_wg = sQ + wg * 64 * kRowBytes;
    // S = Q K^T of tile i into sacc (committed, not waited for)
    auto issue_s = [&](int i) {
      const int s = i % kStages;
      mbar_wait(k_full(s), (i / kStages) & 1);
      const uint32_t k_tile = sK + s * Sh::kKVBytes;
      wgmma_fence();
      fence_regs<BK / 2>(sacc);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;   // 16 columns
        wgmma_ss<BK>(
            sacc, sw128_desc(q_wg + (kk / 4) * Sh::kQChunk + off, 16, 1024),
            sw128_desc(k_tile + (kk / 4) * Sh::kKVChunk + off, 16, 1024),
            kk > 0);
      }
      wgmma_commit();
    };

    mbar_wait(q_full, 0);
    issue_s(0);
    wgmma_wait<0>();
    fence_regs<BK / 2>(sacc);
    release(k_empty(0));
    // Tile i: its softmax runs while P V of tile i - 1 is still on the
    // tensor cores; then S of tile i + 1 and P V of tile i are issued
    // together, and only S is waited for.
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const int k0 = (t_lo + i) * BK;
      // mask only where the tile crosses the warpgroup's band (a tile
      // wholly outside it, at a band's edge, comes out all -inf: p = 0)
      const bool inside = k0 + BK <= S &&
                          (!causal || k0 + BK - 1 <= wg_first) &&
                          (window <= 0 || k0 > wg_last - window);
      float mx[2];
      // one loop per case, chosen by warpgroup-uniform tests: a branch
      // inside the loop would be predicated, and every logit would issue
      // the other case's instructions too
      if (softcap > 0.f) {
        if (inside) {
          to_y<BK, true, false>(sacc, mx, y_in, k0, qi, t, S, causal,
                                window);
        } else {
          to_y<BK, true, true>(sacc, mx, y_in, k0, qi, t, S, causal, window);
        }
      } else if (!inside) {
        to_y<BK, false, true>(sacc, mx, y_in, k0, qi, t, S, causal, window);
      } else {
        to_y<BK, false, false>(sacc, mx, y_in, k0, qi, t, S, causal,
                               window);
      }
      float alpha[2], mc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        // a row with nothing valid yet: p = 2^-inf = 0 for its keys
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = ex2((m[r] - m_use) * c);   // 0 while m[r] is -inf
        mc[r] = m_use * c;
        m[r] = m_new;
      }
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sacc[n * 4 + e] = ex2(fmaf(sacc[n * 4 + e], c, -mc[e >> 1]));
        }
      }
      // P V of tile i - 1 is done with acc and V (at i = 0 nothing is in
      // flight).  The wait is unconditional: ptxas serialises every wgmma
      // of the kernel if any path could reach a read of acc without it.
      wgmma_wait<0>();
      fence_regs<kCols / 2>(acc);
      if (i > 0) release(v_empty((i - 1) % kStages));
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < kCols / 8; ++n) {
          acc[n * 4 + 0] *= alpha[0];
          acc[n * 4 + 1] *= alpha[0];
          acc[n * 4 + 2] *= alpha[1];
          acc[n * 4 + 3] *= alpha[1];
        }
      }
      float sum[2][2] = {{0.f, 0.f}, {0.f, 0.f}};   // two chains a row
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const float* p0 = sacc + 8 * kk;       // keys 16 kk + 2 t, + 1
        const float* p1 = sacc + 8 * kk + 4;   // keys 16 kk + 8 + 2 t, + 1
        pa[kk][0] = pack_bf16(p0[0], p0[1], sum[0][0]);
        pa[kk][1] = pack_bf16(p0[2], p0[3], sum[1][0]);
        pa[kk][2] = pack_bf16(p1[0], p1[1], sum[0][1]);
        pa[kk][3] = pack_bf16(p1[2], p1[3], sum[1][1]);
        if constexpr (Sh::kSplitP) {
          pr[kk][0] = pack_residue(p0[0], p0[1], pa[kk][0]);
          pr[kk][1] = pack_residue(p0[2], p0[3], pa[kk][1]);
          pr[kk][2] = pack_residue(p1[0], p1[1], pa[kk][2]);
          pr[kk][3] = pack_residue(p1[2], p1[3], pa[kk][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = alpha[r] * l[r] + (sum[r][0] + sum[r][1]);
      }

      const bool more = i + 1 < n_tiles;
      if (more) issue_s(i + 1);
      mbar_wait(v_full(s), (i / kStages) & 1);
      const uint32_t v_tile = sV + s * Sh::kKVBytes;
      wgmma_fence();
      fence_regs<kCols / 2>(acc);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // 16 keys (two 8-row groups, 1024 bytes apart) x kCols columns
        // (64-column chunks kKVChunk apart)
        const uint64_t v_desc = sw128_desc(v_tile + kk * 16 * kRowBytes,
                                           Sh::kKVChunk, 1024);
        wgmma_rs<kCols>(acc, pa[kk], v_desc);
        if constexpr (Sh::kSplitP) wgmma_rs<kCols>(acc, pr[kk], v_desc);
      }
      wgmma_commit();
      // S of tile i + 1 (the older group) is done; unconditional for the
      // same reason (after the last tile only P V is in flight)
      wgmma_wait<1>();
      fence_regs<BK / 2>(sacc);
      if (more) release(k_empty((i + 1) % kStages));
    }
    wgmma_wait<0>();
    fence_regs<kCols / 2>(acc);
    release(v_empty((n_tiles - 1) % kStages));

    // each lane's l covers its own columns: sum over the quad
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= q_rows) continue;
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
      __nv_bfloat16* orow =
          o + b * os.b + h * os.h + static_cast<long long>(q0 + row) * os.s;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
            __floats2bfloat162_rn(acc[n * 4 + 2 * r] * inv,
                                  acc[n * 4 + 2 * r + 1] * inv);
      }
    }
  }
}

// ---------------------------------------------------------------------
// Host side.

// cuTensorMapEncodeTiled, taken from the driver at run time (so the
// library links against the runtime alone).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-D bf16 tensor map over [B, H, S, D] at element strides (b, h, s),
// boxes of 64 columns x `rows` rows, 128-byte swizzle, zero fill.  A
// dimension of size 1 is given a packed stride (its own is never used,
// and TMA wants every stride a positive multiple of 16 bytes).
bool make_map(CUtensorMap* map, const void* ptr, int B, int H, int S, int D,
              Strides st, int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  cuuint64_t s_bytes = static_cast<cuuint64_t>(st.s) * 2;
  cuuint64_t h_bytes = static_cast<cuuint64_t>(st.h) * 2;
  cuuint64_t b_bytes = static_cast<cuuint64_t>(st.b) * 2;
  if (S == 1) s_bytes = static_cast<cuuint64_t>(D) * 2;
  if (H == 1) h_bytes = s_bytes * S;
  if (B == 1) b_bytes = h_bytes * H;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {s_bytes, h_bytes, b_bytes};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int Hq, int Hkv, int S, const Strides* st, int causal,
                int window, float softcap, cudaStream_t stream) {
  using Sh = WgShape<D>;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, Hq, S, D, st[0], kTileQ) ||
      !make_map(&tk, k, B, Hkv, S, D, st[1], Sh::kBK) ||
      !make_map(&tv, v, B, Hkv, S, D, st[2], Sh::kBK)) {
    return cudaErrorInvalidValue;
  }
  const int q_tiles = S / kTileQ + (S % kTileQ != 0);
  if (q_tiles > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(Hq), static_cast<unsigned>(B),
                  static_cast<unsigned>(q_tiles));
  auto kernel = flash_fwd_wgmma_kernel<D>;
  constexpr size_t smem = Sh::kSmemBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kWsThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, Hq / Hkv, st[3],
      causal, window, softcap, 1.f / sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int Hq, int Hkv, int S, const Strides* st, int causal,
               int window, float softcap, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((S + kBQ - 1) / kBQ),
                  static_cast<unsigned>(Hq), static_cast<unsigned>(B));
  auto kernel = flash_fwd_kernel<D>;
  constexpr size_t smem = Shape<D>::kSmemBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, Hq / Hkv,
      st[0], st[1], st[2], st[3], causal, window, softcap,
      sqrtf(static_cast<float>(D)));
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           int B, int Hq, int Hkv, int S, const Strides* st, int causal,
           int window, float softcap, cudaStream_t stream) {
  return dtype == 0 ? launch_f32<D>(q, k, v, o, B, Hq, Hkv, S, st, causal,
                                    window, softcap, stream)
                    : launch_bf16<D>(q, k, v, o, B, Hq, Hkv, S, st, causal,
                                     window, softcap, stream);
}

}  // namespace

// C entry point (bound with ctypes).  dtype: 0 float32, 1 bfloat16.
// strides: 12 element strides, (batch, head, sequence) of q, k, v and o in
// that order; the last dimension is contiguous (and, for bfloat16, every
// stride of a dimension longer than 1 a positive multiple of 8 elements,
// the base 16-byte aligned: what TMA reads).  Returns cudaGetLastError()
// after the launch (0 on success), or cudaErrorInvalidValue /
// cudaErrorInvalidConfiguration for arguments this file does not take.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype, int B,
                                   int Hq, int Hkv, int S, int D,
                                   const long long* strides, int causal,
                                   int window, float softcap, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || window < 0 ||
      !(softcap >= 0.f) || (dtype != 0 && dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  if (B > 65535 || Hq > 65535) return cudaErrorInvalidConfiguration;
  const Strides st[4] = {{strides[0], strides[1], strides[2]},
                         {strides[3], strides[4], strides[5]},
                         {strides[6], strides[7], strides[8]},
                         {strides[9], strides[10], strides[11]}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(dtype, q, k, v, o, B, Hq, Hkv, S, st, causal, window,
                        softcap, s);
    case 32:
      return launch<32>(dtype, q, k, v, o, B, Hq, Hkv, S, st, causal, window,
                        softcap, s);
    case 64:
      return launch<64>(dtype, q, k, v, o, B, Hq, Hkv, S, st, causal, window,
                        softcap, s);
    case 128:
      return launch<128>(dtype, q, k, v, o, B, Hq, Hkv, S, st, causal,
                         window, softcap, s);
    case 256:
      return launch<256>(dtype, q, k, v, o, B, Hq, Hkv, S, st, causal,
                         window, softcap, s);
    default:
      return cudaErrorInvalidValue;
  }
}
