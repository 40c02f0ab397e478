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
// (bf16) against 0.04 ms of memory traffic.  Two kernels share the
// structure below:
//   * bfloat16 runs both products on the tensor cores with mma.sync
//     (flash_fwd_mma_kernel, FlashAttention-2's register layout; Hopper's
//     wgmma, TMA and warp specialisation are later work).
//   * float32 runs them on the FMA units (flash_fwd_kernel; 67 TFLOP/s at
//     most), exact to float32 summation order, as the float32 oracles
//     need: bf16 or TF32 tensor-core products would round the inputs.
// The design:
//   * One block per (query tile of 64 rows, query head, batch row).  A
//     loop over key tiles of 64 takes the place of the TPU grid's
//     sequential kv axis; the running max m, denominator l and the 64 x D
//     accumulator stay in registers for the block's whole life.
//   * Only the key tiles that the causal and window masks leave partly
//     open are visited (the band [q0 - window + 1, q0 + 63]); a key tile
//     that is wholly masked for the block is never loaded.  Query tiles
//     are issued last-first, so the long causal rows start first.
//   * q, k and v are read in place at the caller's strides (the model's
//     [B, S, H, D] activations, transposed, need no copy), with the kv
//     head h / G indexed directly: no k/v repeat per group.  At D = 256
//     the tiles take 99 KB (bf16) or 147 KB (float32) of shared memory,
//     above the 48 KB default, so the entry point raises the kernel's
//     dynamic shared-memory limit before each launch.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

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
// bfloat16: the two products on the tensor cores (mma.sync m16n8k16,
// bf16 in, float32 accumulate), FlashAttention-2's register layout.
// Four warps, each owning 16 query rows of the 64-row tile; per key tile
// of 64 a warp holds its 16 x 64 logits as mma accumulators, turns them
// into probabilities in registers and feeds them straight back as the A
// operand of P V (the accumulator layout of two neighbouring 8-key tiles
// is the A layout of one 16-key step).  Q, K and V tiles are copied to
// shared memory with cp.async (rows padded by 16 bytes, so ldmatrix's
// eight row reads hit distinct banks), the next tile's K during this
// tile's softmax and P V and its V during its own Q K^T, so a block waits
// on a copy only when it outruns it; V is read transposed by
// ldmatrix.trans.  The row max is reduced over the 4 lanes of a quad;
// the row sum stays a per-lane partial until the end.  Tiles that lie
// wholly inside the open band skip the mask tests.  The probabilities are
// rounded to bf16 for P V (as the reference's chunked attention rounds
// them to v's dtype), so the exponentials use the fast __expf.

constexpr int kMmaThreads = 128;   // 4 warps x 16 query rows

template <int D>
struct MmaShape {
  static constexpr int kStride = D + 8;   // bf16 per shared-memory row
  static constexpr size_t kSmemBytes =
      sizeof(__nv_bfloat16) * static_cast<size_t>(kStride) *
      (kBQ + 2 * kBK);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16 x 16, row) * b (16 x 8, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 64 rows x D of bf16 into shared memory with cp.async; rows at or beyond
// `rows` are zero-filled (source size 0; the address stays row 0's).
template <int D>
__device__ __forceinline__ void load_tile_async(
    __nv_bfloat16* __restrict__ dst, const __nv_bfloat16* __restrict__ src,
    long long stride, int rows, int tid) {
  constexpr int kChunks = D / 8;
  constexpr int kStride = MmaShape<D>::kStride;
  for (int c = tid; c < 64 * kChunks; c += kMmaThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    const __nv_bfloat16* from =
        src + static_cast<long long>(r < rows ? r : 0) * stride + col;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst + r * kStride + col)),
                 "l"(from), "r"(r < rows ? 16 : 0));
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o, int S, int group,
                         Strides qs, Strides ks, Strides vs, Strides os,
                         int causal, int window, float softcap,
                         float sqrt_d) {
  constexpr int kStride = MmaShape<D>::kStride;
  constexpr int kNT = kBK / 8;   // 8-key tiles of the logit block
  constexpr int kDT = D / 8;     // 8-column tiles of the accumulator
  extern __shared__ uint4 smem_mma[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  __nv_bfloat16* Ks = Qs + kBQ * kStride;
  __nv_bfloat16* Vs = Ks + kBK * kStride;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // accumulator row (and row + 8)
  const int t = lane & 3;    // accumulator columns 2 t, 2 t + 1
  const int qt = static_cast<int>(gridDim.x - 1 - blockIdx.x);
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / group;
  const int q0 = qt * kBQ;
  const int q_rows = min(kBQ, S - q0);

  const __nv_bfloat16* qp =
      q + b * qs.b + h * qs.h + static_cast<long long>(q0) * qs.s;
  const __nv_bfloat16* kp = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vp = v + b * vs.b + hk * vs.h;

  int kv_lo = 0;
  int kv_hi = S;
  if (causal) kv_hi = min(S, q0 + q_rows);
  if (window > 0) kv_lo = max(0, q0 - window + 1);
  const int t_lo = kv_lo / kBK;
  const int t_hi = (kv_hi + kBK - 1) / kBK;

  // Copies in flight, as cp.async groups in commit order: Q with the
  // first K, then the first V.  Each tile then waits only for the buffer
  // it reads next: K(t+1) is copied during tile t's softmax and P V, and
  // V(t+1) during tile t+1's Q K^T.
  load_tile_async<D>(Qs, qp, qs.s, q_rows, tid);
  load_tile_async<D>(Ks, kp + static_cast<long long>(t_lo * kBK) * ks.s,
                     ks.s, min(kBK, S - t_lo * kBK), tid);
  asm volatile("cp.async.commit_group;\n" ::);
  load_tile_async<D>(Vs, vp + static_cast<long long>(t_lo * kBK) * vs.s,
                     vs.s, min(kBK, S - t_lo * kBK), tid);
  asm volatile("cp.async.commit_group;\n" ::);
  const float scale = 1.f / sqrt_d;
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  // this lane's two rows: warp * 16 + g and + 8
  const int row0 = q0 + warp * 16 + g;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[kDT][4];
#pragma unroll
  for (int d = 0; d < kDT; ++d) {
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  }

  // ldmatrix row/column offsets of this lane
  const int a_row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 8;
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int v_col = (lane >> 4) * 8;

  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int k0 = tile * kBK;
    const bool more = tile + 1 < t_hi;
    const int next_rows = min(kBK, S - k0 - kBK);
    asm volatile("cp.async.wait_group 1;\n" ::);  // Q and this tile's K
    __syncthreads();

    float sacc[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, Qs + a_row * kStride + kk + a_col);
#pragma unroll
      for (int n = 0; n < kNT; n += 2) {
        uint32_t bb[4];
        ldmatrix_x4(bb, Ks + (n * 8 + b_row) * kStride + kk + b_col);
        mma_bf16(sacc[n], a, bb[0], bb[1]);
        mma_bf16(sacc[n + 1], a, bb[2], bb[3]);
      }
    }
    __syncthreads();  // every warp is done with this K
    if (more) {
      load_tile_async<D>(Ks, kp + static_cast<long long>(k0 + kBK) * ks.s,
                         ks.s, next_rows, tid);
      asm volatile("cp.async.commit_group;\n" ::);
    }

    // scale, softcap and mask; masks only where the tile crosses the band
    const bool inside = k0 + kBK <= S && (!causal || k0 + kBK - 1 <= q0) &&
                        (window <= 0 || k0 > q0 + kBQ - 1 - window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sacc[n][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x * inv_cap);
        if (!inside) {
          const int qi = row0 + (e >> 1) * 8;
          const int kj = k0 + n * 8 + 2 * t + (e & 1);
          bool ok = kj < S;
          if (causal) ok = ok && kj <= qi;
          if (window > 0) ok = ok && kj > qi - window;
          x = ok ? x : -INFINITY;
        }
        sacc[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // a row with nothing valid yet: p = exp(-inf) = 0 for all its keys
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = __expf(m[r] - m_use[r]);
      m[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sacc[n][e] = __expf(sacc[n][e] - m_use[e >> 1]);
        sum[e >> 1] += sacc[n][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + sum[r];
#pragma unroll
    for (int d = 0; d < kDT; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }

    if (more) {  // this tile's V has landed (the next K may not have)
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      const int n = kk / 8;
      const uint32_t a[4] = {pack_bf16(sacc[n][0], sacc[n][1]),
                             pack_bf16(sacc[n][2], sacc[n][3]),
                             pack_bf16(sacc[n + 1][0], sacc[n + 1][1]),
                             pack_bf16(sacc[n + 1][2], sacc[n + 1][3])};
#pragma unroll
      for (int d = 0; d < kDT; d += 2) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, Vs + (kk + v_row) * kStride + d * 8 + v_col);
        mma_bf16(acc[d], a, bb[0], bb[1]);
        mma_bf16(acc[d + 1], a, bb[2], bb[3]);
      }
    }
    __syncthreads();  // every warp is done with this V
    if (more) {
      load_tile_async<D>(Vs, vp + static_cast<long long>(k0 + kBK) * vs.s,
                         vs.s, next_rows, tid);
      asm volatile("cp.async.commit_group;\n" ::);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + r * 8;
    if (row >= q_rows) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    __nv_bfloat16* orow =
        o + b * os.b + h * os.h + static_cast<long long>(q0 + row) * os.s;
#pragma unroll
    for (int d = 0; d < kDT; ++d) {
      *reinterpret_cast<__nv_bfloat162*>(orow + d * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[d][2 * r] * inv, acc[d][2 * r + 1] * inv);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int S, const long long* st, int causal,
           int window, float softcap, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((S + kBQ - 1) / kBQ),
                  static_cast<unsigned>(Hq), static_cast<unsigned>(B));
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const float sqrt_d = sqrtf(static_cast<float>(D));
  cudaError_t err;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    auto kernel = flash_fwd_mma_kernel<D>;
    constexpr size_t smem = MmaShape<D>::kSmemBytes;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), S, Hq / Hkv, qs, ks,
        vs, os, causal, window, softcap, sqrt_d);
  } else {
    auto kernel = flash_fwd_kernel<D>;
    constexpr size_t smem = Shape<D>::kSmemBytes;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o), S, Hq / Hkv, qs, ks,
        vs, os, causal, window, softcap, sqrt_d);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v, void* o,
             int B, int Hq, int Hkv, int S, const long long* st, int causal,
             int window, float softcap, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, Hq, Hkv, S, st, causal, window,
                           softcap, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, Hq, Hkv, S, st, causal, window,
                           softcap, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Hq, Hkv, S, st, causal, window,
                           softcap, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Hq, Hkv, S, st, causal, window,
                            softcap, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, Hq, Hkv, S, st, causal, window,
                            softcap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point (bound with ctypes).  dtype: 0 float32, 1 bfloat16.
// strides: 12 element strides, (batch, head, sequence) of q, k, v and o in
// that order; the last dimension is contiguous.  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue / cudaErrorInvalidConfiguration for arguments this
// file does not take.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int dtype, int B,
                                   int Hq, int Hkv, int S, int D,
                                   const long long* strides, int causal,
                                   int window, float softcap, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || window < 0 ||
      !(softcap >= 0.f)) {
    return cudaErrorInvalidValue;
  }
  if (B > 65535 || Hq > 65535) return cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch<float>(D, q, k, v, o, B, Hq, Hkv, S, strides, causal,
                           window, softcap, s);
  }
  if (dtype == 1) {
    return dispatch<__nv_bfloat16>(D, q, k, v, o, B, Hq, Hkv, S, strides,
                                   causal, window, softcap, s);
  }
  return cudaErrorInvalidValue;
}
