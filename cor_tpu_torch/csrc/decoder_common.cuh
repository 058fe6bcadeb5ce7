// Device helpers shared by the SAM mask-decoder kernels (two_way_layer.cu,
// t2i_flash.cu, decoder_tail.cu; the flash attentions seq_attention.cu and
// vit_attention.cu take the bf16, mma and online-softmax helpers): bf16
// conversions, the tensor-core
// mma.sync m16n8k16 (bf16 in, fp32 accumulate) and a warp's 16-row GEMM tile
// over operands in shared memory, the loading of one 64-row tile of image
// rows (bf16, or an int8 store row dequantised as the TPU kernel does it),
// and warp reductions. Geometry of the SAM decoder: C = 256 channels, 8
// heads, internal width 128 (head_dim 16 in the cross attentions), and 5 to
// kMaxTok tokens: iou + 4 mask tokens + the sparse prompts (none for a mask
// or no prompt, n + 1 for n points, 2 for a box, n + 2 for a box and n
// points). The token count T is a template parameter of the two-way layer's
// token kernels (T 5 to 8) and a run-time argument of the image passes and
// the combines; 8 T (head, token) query rows take part in the t2i attention.
//
// The decoder kernels are templated on their element type T: uint16_t for
// bf16 and float for fp32 (cor_tpu's compute_dtype float32). Elem<T> reads,
// writes and rounds one value in the compute dtype (fp32 rounds nothing,
// as cor_tpu rounds to the compute dtype); warp_mma on fp32 tiles is the
// 3xTF32 product of mma_tf32x3.cuh; the fp32 tiles' padded row strides are
// 4 mod 8 words (conflict-free TF32 fragments).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32x3.cuh"

namespace cor {

constexpr int kC = 256;        // transformer_dim
constexpr int kI = 128;        // cross-attention internal width (downsample 2)
constexpr int kHeads = 8;
constexpr int kMaxTok = 32;    // the most tokens a decode may have
constexpr int kCrossD = kI / kHeads;   // 16
constexpr int kRows = 64;      // image rows per CTA of an image pass
constexpr int kImgThreads = 128;  // threads of an image pass: 4 warps of 16 rows
constexpr int kLdC = kC + 8;   // padded shared row strides (bf16 elements):
constexpr int kLdI = kI + 8;   // rows 4 banks apart, conflict-free fragments

__device__ __forceinline__ float bf2f(uint16_t v) { return __uint_as_float(uint32_t(v) << 16); }
__device__ __forceinline__ uint16_t f2bf(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float round_bf16(float x) { return bf2f(f2bf(x)); }

// two floats -> bf16x2 in one 32-bit register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return uint32_t(f2bf(lo)) | (uint32_t(f2bf(hi)) << 16);
}
__device__ __forceinline__ uint32_t lds32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ void sts32(uint16_t* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[n] (16 x 8 tile n) += A[row0 .. row0+15][0 .. K) * B[n*8 .. n*8+7][0 .. K)^T
// with A [rows][lda] and B [cols][ldb] bf16 in shared memory, both K-contiguous
// (B is a weight in the [out, in] layout). Accumulator layout of mma.sync:
// acc[n][0..1] row row0+g, cols n*8+2t, +1; acc[n][2..3] row row0+g+8.
template <int NT, int K>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const uint16_t* sA, int lda,
                                         const uint16_t* sB, int ldb, int row0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kc = 0; kc < K / 16; ++kc) {
    uint32_t a[4];
    const uint16_t* pa = sA + (row0 + g) * lda + kc * 16 + 2 * t;
    a[0] = lds32(pa);
    a[1] = lds32(pa + 8 * lda);
    a[2] = lds32(pa + 8);
    a[3] = lds32(pa + 8 * lda + 8);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const uint16_t* pb = sB + (n * 8 + g) * ldb + kc * 16 + 2 * t;
      mma_bf16_16816(acc[n], a, lds32(pb), lds32(pb + 8));
    }
  }
}

// The fp32 tiles: acc[n] += A . B^T as warp_mma above, 3xTF32.
template <int NT, int K>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const float* sA, int lda,
                                         const float* sB, int ldb, int row0, int lane) {
  warp_mma_f32<NT, K>(acc, sA, lda, sB, ldb, row0, lane);
}

// One value of the compute dtype: bf16 (T = uint16_t) or fp32 (T = float),
// with the padded shared row strides of kC- and kI-wide tiles of it.
template <typename T>
struct Elem;
template <>
struct Elem<uint16_t> {
  static constexpr int kLdC = cor::kLdC, kLdI = cor::kLdI;
  static __device__ __forceinline__ float get(uint16_t v) { return bf2f(v); }
  static __device__ __forceinline__ uint16_t put(float x) { return f2bf(x); }
  static __device__ __forceinline__ float round(float x) { return round_bf16(x); }
  // two consecutive values
  static __device__ __forceinline__ void get2(const uint16_t* p, float& a, float& b) {
    const uint32_t w = lds32(p);
    a = bf2f(static_cast<uint16_t>(w & 0xffffu));
    b = bf2f(static_cast<uint16_t>(w >> 16));
  }
  static __device__ __forceinline__ void put2(uint16_t* p, float a, float b) {
    sts32(p, pack_bf16x2(a, b));
  }
};
template <>
struct Elem<float> {
  static constexpr int kLdC = kC + 4, kLdI = kI + 4;  // 4 mod 8 words
  static __device__ __forceinline__ float get(float v) { return v; }
  static __device__ __forceinline__ float put(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void get2(const float* p, float& a, float& b) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    a = v.x;
    b = v.y;
  }
  static __device__ __forceinline__ void put2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

// The online (flash) softmax of K4 and K6/K7, per lane: rows g and g + 8
// of a warp's 16 query rows, in the log2 domain. Once a 64-key tile's
// logits are final (scaled, biased, masked to -inf) and mt holds this lane's
// maxima of them, fold the tile's row max into the running max m_run and
// rescale the running sums l_run and the output tiles o.
template <int NO>
__device__ __forceinline__ void softmax_rescale(float (&mt)[2], float (&m_run)[2],
                                                float (&l_run)[2], float (&o)[NO][4]) {
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
    const float m_new = fmaxf(m_run[r], mt[r]);  // finite: every tile has a key < N
    alpha[r] = exp2f(m_run[r] - m_new);           // 0 on the first tile
    m_run[r] = m_new;
    l_run[r] *= alpha[r];
  }
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    o[n][0] *= alpha[0];
    o[n][1] *= alpha[0];
    o[n][2] *= alpha[1];
    o[n][3] *= alpha[1];
  }
}

// 1 / the row sums of rows g and g + 8 (each lane holds a share of them)
__device__ __forceinline__ void softmax_inverse_sums(float (&l_run)[2], float (&inv)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    inv[r] = 1.f / l_run[r];
  }
}

// The store row a candidate reads: idx[cand] clipped to [0, S - 1] (the JAX
// server clips), or the candidate itself without idx.
__device__ __forceinline__ int source_row(const int* idx, int cand, int S) {
  if (idx == nullptr) return cand;
  const int r = idx[cand];
  return r < 0 ? 0 : (r > S - 1 ? S - 1 : r);
}

// 8 int8 values (a uint2) of a store row -> 8 bf16 (a uint4), and 4 int8
// values (a uint32) -> 4 fp32: each value (int8 -> fp32) * scale, rounded to
// the compute dtype (fp32 rounds nothing), the TPU kernel's rounding
// (two_way_layer.py:382-389)
__device__ __forceinline__ uint4 dequant8_bf16(uint2 q, float scale) {
  const uint32_t w[2] = {q.x, q.y};
  uint32_t o[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int8_t lo = static_cast<int8_t>((w[j >> 1] >> (16 * (j & 1))) & 0xff);
    const int8_t hi = static_cast<int8_t>((w[j >> 1] >> (16 * (j & 1) + 8)) & 0xff);
    o[j] = pack_bf16x2(static_cast<float>(lo) * scale, static_cast<float>(hi) * scale);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ uint4 dequant4_f32(uint32_t w, float scale) {
  float f[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = static_cast<float>(static_cast<int8_t>((w >> (8 * j)) & 0xff)) * scale;
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
// 16 bytes of the compute dtype T dequantised from the int8 values at q8
template <typename T>
__device__ __forceinline__ uint4 dequant16(const int8_t* q8, float scale) {
  if constexpr (sizeof(T) == 2)
    return dequant8_bf16(*reinterpret_cast<const uint2*>(q8), scale);
  else
    return dequant4_f32(*reinterpret_cast<const uint32_t*>(q8), scale);
}

// Rows [r0, r0 + kRows) of source row `row` ([N, C]) -> sRows [kRows][Elem<T>::kLdC]
// in the compute dtype T. An int8 row dequantises as T((int8 -> fp32) *
// scale), the TPU kernel's rounding (two_way_layer.py:382-389); fp32 rounds
// nothing.
template <bool kInt8, typename T>
__device__ __forceinline__ void load_rows(T* sRows, const void* src, int row, int N, int r0,
                                          float scale, int tid, int nthreads) {
  constexpr int kVec = 16 / sizeof(T);  // values per 16-byte chunk
  constexpr int kLd = Elem<T>::kLdC;
  const int64_t base = (static_cast<int64_t>(row) * N + r0) * kC;
  for (int i = tid; i < kRows * (kC / kVec); i += nthreads) {
    const int r = i / (kC / kVec);
    const int c = (i % (kC / kVec)) * kVec;
    uint4 v;
    if (kInt8)
      v = dequant16<T>(static_cast<const int8_t*>(src) + base + r * kC + c, scale);
    else
      v = *reinterpret_cast<const uint4*>(static_cast<const T*>(src) + base + r * kC + c);
    *reinterpret_cast<uint4*>(sRows + r * kLd + c) = v;
  }
}

// The same dequantisation out of shared memory: an int8 row tile sRaw
// [kRows][kC] (as cp.async brought it) -> sRows [kRows][Elem<T>::kLdC]
template <typename T>
__device__ __forceinline__ void dequant_rows(T* sRows, const int8_t* sRaw, float scale, int tid,
                                             int nthreads) {
  constexpr int kVec = 16 / sizeof(T);
  for (int i = tid; i < kRows * (kC / kVec); i += nthreads) {
    const int r = i / (kC / kVec);
    const int c = (i % (kC / kVec)) * kVec;
    *reinterpret_cast<uint4*>(sRows + r * Elem<T>::kLdC + c) =
        dequant16<T>(sRaw + r * kC + c, scale);
  }
}

// Two consecutive channels (col, col + 1) of row r of a row tile [kRows][ld]
// of the source type (the rows in device memory with ld = kC, or a tile
// staged in shared memory), as the compute dtype's values in fp32
// (dequantised for an int8 store).
template <bool kInt8, typename T>
__device__ __forceinline__ void tile_pair(const void* tile, int ld, int r, int col, float scale,
                                          float& v0, float& v1) {
  const int64_t off = static_cast<int64_t>(r) * ld + col;
  if (kInt8) {
    const int8_t* p = static_cast<const int8_t*>(tile) + off;
    v0 = Elem<T>::round(static_cast<float>(p[0]) * scale);
    v1 = Elem<T>::round(static_cast<float>(p[1]) * scale);
  } else {
    Elem<T>::get2(static_cast<const T*>(tile) + off, v0, v1);
  }
}

// Row r0 of source row `row` of a [*, N, kC] tensor of the source type
// (int8, or the compute dtype T): the base of a row tile in device memory.
template <bool kInt8, typename T>
__device__ __forceinline__ const void* row_tile(const void* src, int row, int N, int r0) {
  const int64_t off = (static_cast<int64_t>(row) * N + r0) * kC;
  if (kInt8) return static_cast<const int8_t*>(src) + off;
  return static_cast<const T*>(src) + off;
}

// cp.async (sm_80+): 16 bytes from device to shared memory without a
// register, bypassing L1, in commit groups that a thread waits for
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying rows [r0, r0 + kRows) of a [*, N, width] tensor (source row
// `row`, `bytes_per_row` = width * element size, a multiple of 16) into
// dst [kRows][ld_bytes / element size] in shared memory.
__device__ __forceinline__ void copy_tile_async(void* dst, int ld_bytes, const void* src,
                                                int row, int N, int r0, int bytes_per_row,
                                                int tid, int nthreads) {
  const char* s = static_cast<const char*>(src) +
                  (static_cast<int64_t>(row) * N + r0) * bytes_per_row;
  char* d = static_cast<char*>(dst);
  const int chunks = bytes_per_row / 16;
  for (int i = tid; i < kRows * chunks; i += nthreads) {
    const int r = i / chunks, c = (i % chunks) * 16;
    cp_async16(d + r * ld_bytes + c, s + static_cast<int64_t>(r) * bytes_per_row + c);
  }
}

// The t2i flash partials of query q (of nq = 8 T), channel d (of kCrossD),
// merged over the `tiles` row tiles of one candidate (tile j at base + j):
// sum_j acc_j e^(m_j - m) / sum_j l_j e^(m_j - m) with m = max_j m_j. Two
// passes, unrolled so that the loads of 8 tiles are in flight at once and no
// exponential waits on the one before it. The partials are read through the
// non-coherent read-only path (__ldg), right for partials an earlier kernel
// wrote (the fused transformer of two_way_stack.cuh, which writes its own,
// has a copy of this arithmetic reading L2, combine_ordered).
__device__ __forceinline__ float combine_partials(const float* __restrict__ part_m,
                                                  const float* __restrict__ part_l,
                                                  const float* __restrict__ part_acc,
                                                  int64_t base, int tiles, int nq, int q,
                                                  int d) {
  auto ld = [](const float* p) { return __ldg(p); };
  float m = -INFINITY;
#pragma unroll 8
  for (int j = 0; j < tiles; ++j) m = fmaxf(m, ld(part_m + (base + j) * nq + q));
  float l = 0.f, acc = 0.f;
#pragma unroll 8
  for (int j = 0; j < tiles; ++j) {
    const int64_t pq = (base + j) * nq + q;
    const float a = expf(ld(part_m + pq) - m);
    l += ld(part_l + pq) * a;
    acc += ld(part_acc + pq * kCrossD + d) * a;
  }
  return acc / l;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
// sum over the 4 lanes (t = 0..3) that share accumulator rows
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

}  // namespace cor
