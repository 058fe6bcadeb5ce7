// LayerNorm over the last axis, fp32 statistics, output in the input dtype;
// and LayerNorm(x + y), the residual add fused in front of it. The kernel
// template and its launcher, instantiated by layernorm.cu (cor_layer_norm,
// K5) and layernorm_add.cu (cor_add_layer_norm, K5'), one nvcc each.
//
// Replaces the TPU kernels cor_tpu/ops/pallas/layernorm.py:layer_norm_pallas
// (_layer_norm_pallas_impl, its pallas_call at line 70) and
// add_layer_norm_pallas (_add_layer_norm_pallas_impl, line 100). Same
// numerics as their _ln_block: fp32 mean, then the biased variance as
// mean((x - mean)^2) in a second pass over the row, y = (x - mean) *
// rsqrt(var + eps) * scale + bias, rounded once to x's dtype. The fused add
// (_add_ln_kernel) takes x + y in fp32 and never rounds the sum; cor_tpu's
// XLA fallback (C % 128 != 0, or rows that do not tile) rounds it to x's
// dtype, this kernel does not at any shape.
//
// What bounds it on the H100: bytes. One row of C elements is read once and
// written once (2 * C * sizeof(T) bytes; the add: one more read) for about
// 8 * C flops, far below the card's ~295 flop/byte ridge. The design (the
// Hopper redesign; the first one took one element a lane per load, 2-byte
// requests in bf16, and reloaded scale and bias for every row):
//  - one warp owns one row at a time and keeps it in registers, so the two
//    statistics passes and the normalising pass read registers, and device
//    memory is touched once each way;
//  - every access is 16 bytes a lane (8 bf16 or 4 fp32: a warp request is
//    512 bytes): lane l owns the chunks l, l + 32, l + 64, ... of the row.
//    The add's y moves in chunks of as many elements (32 bytes of fp32 y
//    beside bf16 x, 8 of bf16 y beside fp32 x);
//  - persistent blocks: the grid is sized to what the SMs hold at once, and
//    each warp strides over rows; a block widens scale and bias to fp32 in
//    shared memory once and reuses them for every row it takes. Rows of 3
//    KB and more (fp32 at C >= 768) take one block for each 8 rows instead,
//    which measured faster there;
//  - the next row's loads are issued before this row's reductions (a
//    register double buffer), so a warp always has a row in flight;
//  - the sums: each lane adds its own values in fp32 in order (chunk by
//    chunk, element by element), then a butterfly of shuffles (xor 16, 8,
//    4, 2, 1) adds the lanes: the mean is that sum / C; the variance the
//    same over (v - mean)^2.
// A row that is not whole 16-byte chunks (C not a multiple of the vector
// width) or a tensor not 16-byte aligned takes the scalar instantiation of
// the same kernel (kVec = 1: one element a lane per access, lane l owning
// elements l, l + 32, ...; no double buffer, whose registers at C = 2048
// would spill); the launcher picks it, and the wrapper counts it as the same
// launch. Ragged row counts need nothing: a warp past the last row does no
// work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cor {
namespace ln {

constexpr int kWarps = 8;         // warps a block
constexpr int kMaxCols = 2048;    // the widest row (scale and bias in shared memory)
constexpr int kMaxDevices = 64;   // per-device launch records

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// N elements of T moved as one access (two for 32 bytes)
template <typename T, int N>
struct alignas(sizeof(T) * N >= 16 ? 16 : sizeof(T) * N) Pack {
  T v[N];
};

// kVec elements a lane per access (16 / sizeof(TX), or 1: the scalar case),
// kItems accesses a lane per row. kAdd: the row is x + r (r of type TR,
// summed in fp32); without it r is not read and the kernel is K5's.
// Scale and bias in shared memory, widened to fp32: element e of chunk ch at
// float4 slot (e / 4) * kM + ch (kVec >= 4), so that for each e / 4 a lane
// reads 16 bytes and a warp 512 contiguous ones, without bank conflicts;
// the scalar case at slot ch.
template <int kVec, int kItems, bool kAdd, typename TX, typename TR, typename TW>
__global__ void __launch_bounds__(kWarps * 32)
layer_norm_kernel(const TX* __restrict__ x, const TR* __restrict__ r,
                  const TW* __restrict__ scale, const TW* __restrict__ bias,
                  TX* __restrict__ y, int64_t rows, int cols, float eps) {
  using PX = Pack<TX, kVec>;
  using PR = Pack<TR, kVec>;
  constexpr bool kPrefetch = kVec > 1;
  constexpr int kS = kVec >= 4 ? 4 : 1;  // floats of scale (bias) a shared-memory read
  constexpr int kM = kMaxCols / kVec;    // chunks of the widest row
  using PS = Pack<float, kS>;
  __shared__ PS s_scale[kMaxCols / kS];
  __shared__ PS s_bias[kMaxCols / kS];

  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarps;
  int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const int chunks = cols / kVec;  // whole accesses of a row (cols % kVec == 0)

  PX xa[kItems], xb[kItems];
  PR ra[kItems], rb[kItems];
  auto load = [&](int64_t rw, PX (&xs)[kItems], PR (&rs)[kItems]) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int ch = i * 32 + lane;
      if (ch < chunks) {
        xs[i] = reinterpret_cast<const PX*>(x + rw * cols)[ch];
        if constexpr (kAdd) rs[i] = reinterpret_cast<const PR*>(r + rw * cols)[ch];
      }
    }
  };
  // value e of the row's access i, the add in fp32
  auto value = [&](int i, int e) {
    if constexpr (kAdd)
      return to_f32(xa[i].v[e]) + to_f32(ra[i].v[e]);
    else
      return to_f32(xa[i].v[e]);
  };
  // the first row's loads go out before the block stages scale and bias
  if (kPrefetch && row < rows) load(row, xa, ra);
  for (int c = threadIdx.x; c < cols; c += blockDim.x) {
    const int ch = c / kVec, e = c % kVec;
    const int slot = (e / kS) * kM + ch;
    s_scale[slot].v[e % kS] = to_f32(scale[c]);
    s_bias[slot].v[e % kS] = to_f32(bias[c]);
  }
  __syncthreads();

  for (; row < rows; row += stride) {
    if constexpr (kPrefetch) {
      if (row + stride < rows) load(row + stride, xb, rb);  // in flight meanwhile
    } else {
      load(row, xa, ra);
    }
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kItems; ++i)
      if (i * 32 + lane < chunks)
#pragma unroll
        for (int e = 0; e < kVec; ++e) sum += value(i, e);
    const float mean = warp_sum(sum) / static_cast<float>(cols);

    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kItems; ++i)
      if (i * 32 + lane < chunks)
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float d = value(i, e) - mean;
          sq += d * d;
        }
    const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(cols) + eps);

    PX* yr = reinterpret_cast<PX*>(y + row * cols);
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int ch = i * 32 + lane;
      if (ch < chunks) {
        PX o;
#pragma unroll
        for (int j = 0; j < kVec / kS; ++j) {
          const PS sc = s_scale[j * kM + ch], bi = s_bias[j * kM + ch];
#pragma unroll
          for (int q = 0; q < kS; ++q) {
            const float n = (value(i, j * kS + q) - mean) * rstd;
            o.v[j * kS + q] = from_f32<TX>(n * sc.v[q] + bi.v[q]);
          }
        }
        yr[ch] = o;
      }
    }
    if constexpr (kPrefetch) {
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        xa[i] = xb[i];
        if constexpr (kAdd) ra[i] = rb[i];
      }
    }
  }
}

// Internal linkage: each library loaded beside another (tools/kernel_bits.py)
// keeps its own per-device records.
namespace {

// the blocks of one instantiation the card holds at once, cached per device
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int (&cache)[kMaxDevices], int& blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cache[dev] > 0) {
    blocks = cache[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarps * 32, 0);
  if (err != cudaSuccess) return err;
  blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) cache[dev] = blocks;
  return cudaSuccess;
}

template <int kVec, int kItems, bool kAdd, typename TX, typename TR, typename TW>
cudaError_t launch_case(const void* x, const void* r, const void* scale, const void* bias,
                        void* y, int64_t rows, int cols, float eps, cudaStream_t stream) {
  const auto kernel = layer_norm_kernel<kVec, kItems, kAdd, TX, TR, TW>;
  static int cache[kMaxDevices];
  int resident = 0;
  const cudaError_t err = resident_blocks(kernel, cache, resident);
  if (err != cudaSuccess) return err;
  // Rows of 3 KB and more (a lane's share 96 bytes or more: fp32 at C >=
  // 768) take a block for each 8 rows, which the block scheduler streams in
  // order; narrower rows take the persistent grid, which stages scale and
  // bias once for many rows. (Measured on the H100: the persistent grid lost
  // 4-7% at the wide fp32 rows, and gained 5-15% on the narrow bf16 ones.)
  const int64_t wanted = (rows + kWarps - 1) / kWarps;
  const bool wide = kItems * kVec * sizeof(TX) >= 96;
  const unsigned blocks = static_cast<unsigned>(wide || wanted < resident ? wanted : resident);
  kernel<<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TR*>(r), static_cast<const TW*>(scale),
      static_cast<const TW*>(bias), static_cast<TX*>(y), rows, cols, eps);
  return cudaGetLastError();
}

// The vector instantiation where the rows are whole 16-byte chunks and x, r
// and y are 16-byte aligned, else the scalar one; kItems the fewest
// accesses a lane that cover a row.
template <bool kAdd, typename TX, typename TR, typename TW>
cudaError_t launch(const void* x, const void* r, const void* scale, const void* bias, void* y,
                   int64_t rows, int cols, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(TX);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = cols % kVec == 0 && aligned(x) && aligned(y) && (!kAdd || aligned(r));
  const int items = vec ? (cols / kVec + 31) / 32 : (cols + 31) / 32;
#define COR_LN_CASE(V, N)                                                               \
  if (items <= N)                                                                       \
    return launch_case<V, N, kAdd, TX, TR, TW>(x, r, scale, bias, y, rows, cols, eps, stream);
  if (vec) {
    COR_LN_CASE(kVec, 1)
    COR_LN_CASE(kVec, 2)
    COR_LN_CASE(kVec, 3)
    COR_LN_CASE(kVec, 4)
    COR_LN_CASE(kVec, 5)
    COR_LN_CASE(kVec, 6)
    COR_LN_CASE(kVec, 8)
    if constexpr (kVec == 4) {  // fp32 rows: up to 512 chunks
      COR_LN_CASE(kVec, 10)
      COR_LN_CASE(kVec, 12)
      COR_LN_CASE(kVec, 16)
    }
    return cudaErrorInvalidValue;
  }
  COR_LN_CASE(1, 8)
  COR_LN_CASE(1, 16)
  COR_LN_CASE(1, 32)
  COR_LN_CASE(1, 64)
#undef COR_LN_CASE
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace ln
}  // namespace cor
