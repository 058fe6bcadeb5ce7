// LayerNorm over the last axis, fp32 statistics, output in the input dtype;
// and LayerNorm(x + y), the residual add fused in front of it.
//
// Replaces the TPU kernels cor_tpu/ops/pallas/layernorm.py:layer_norm_pallas
// (_layer_norm_pallas_impl, its pallas_call at line 70) and
// add_layer_norm_pallas (_add_layer_norm_pallas_impl, line 100). Same
// numerics as their _ln_block: fp32 mean, then the biased variance as
// mean((x - mean)^2) in a second pass over the row, y = (x - mean) *
// rsqrt(var + eps) * scale + bias. The fused add (_add_ln_kernel) takes
// x + y in fp32 and never rounds the sum; cor_tpu's XLA fallback (C % 128
// != 0, or rows that do not tile) rounds it to x's dtype, this kernel does
// not at any shape.
//
// What bounds it on the H100: bytes. One row of C elements is read once and
// written once (2 * C * sizeof(T) bytes; the add: one more read) for about
// 8 * C flops, far below the card's ~295 flop/byte ridge. The design
// therefore touches device memory exactly once each way: one warp owns one
// row and keeps the whole row in registers (ITEMS = ceil(C / 32) values per
// lane, 24 at C = 768), so the two statistics passes and the normalising
// pass read registers, not memory; the add happens in those registers as
// the two rows are loaded. Lanes read neighbouring elements (element i * 32
// + lane), so every warp load is one coalesced transaction. Ragged rows
// (any row count) need no fallback: a warp past the last row returns, and a
// ragged C is masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // rows per block

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

// kAdd: the row is x + r (r of type TR, summed in fp32); without it r is
// not read and the kernel is K5's.
template <int ITEMS, bool kAdd, typename TX, typename TR, typename TW>
__global__ void __launch_bounds__(kWarps * 32)
layer_norm_kernel(const TX* __restrict__ x, const TR* __restrict__ r,
                  const TW* __restrict__ scale, const TW* __restrict__ bias,
                  TX* __restrict__ y, int64_t rows, int cols, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const TX* xr = x + row * cols;
  TX* yr = y + row * cols;

  float v[ITEMS];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int c = i * 32 + lane;
    if constexpr (kAdd)
      v[i] = c < cols ? to_f32(xr[c]) + to_f32(r[row * cols + c]) : 0.f;
    else
      v[i] = c < cols ? to_f32(xr[c]) : 0.f;
    sum += v[i];
  }
  const float mean = warp_sum(sum) / static_cast<float>(cols);

  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int c = i * 32 + lane;
    const float d = c < cols ? v[i] - mean : 0.f;
    sq += d * d;
  }
  const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(cols) + eps);

#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int c = i * 32 + lane;
    if (c < cols) {
      const float n = (v[i] - mean) * rstd;
      yr[c] = from_f32<TX>(n * to_f32(scale[c]) + to_f32(bias[c]));
    }
  }
}

template <bool kAdd, typename TX, typename TR, typename TW>
cudaError_t launch(const void* x, const void* r, const void* scale, const void* bias, void* y,
                   int64_t rows, int cols, float eps, cudaStream_t stream) {
  const int items = (cols + 31) / 32;
  const dim3 grid(static_cast<unsigned>((rows + kWarps - 1) / kWarps));
  const dim3 block(kWarps * 32);
  const TX* xp = static_cast<const TX*>(x);
  const TR* rp = static_cast<const TR*>(r);
  const TW* sp = static_cast<const TW*>(scale);
  const TW* bp = static_cast<const TW*>(bias);
  TX* yp = static_cast<TX*>(y);
#define COR_LN_CASE(N)                                                             \
  if (items <= N) {                                                                \
    layer_norm_kernel<N, kAdd, TX, TR, TW><<<grid, block, 0, stream>>>(            \
        xp, rp, sp, bp, yp, rows, cols, eps);                                      \
    return cudaGetLastError();                                                     \
  }
  COR_LN_CASE(4)
  COR_LN_CASE(8)
  COR_LN_CASE(16)
  COR_LN_CASE(24)
  COR_LN_CASE(32)
  COR_LN_CASE(48)
  COR_LN_CASE(64)
#undef COR_LN_CASE
  return cudaErrorInvalidValue;
}

// LayerNorm(x + r) with r's element type picked at run time
template <typename TX, typename TW>
cudaError_t launch_add(const void* x, const void* r, int r_bf16, const void* scale,
                       const void* bias, void* y, int64_t rows, int cols, float eps,
                       cudaStream_t stream) {
  if (r_bf16)
    return launch<true, TX, __nv_bfloat16, TW>(x, r, scale, bias, y, rows, cols, eps, stream);
  return launch<true, TX, float, TW>(x, r, scale, bias, y, rows, cols, eps, stream);
}

}  // namespace

// x, y: [rows, cols] contiguous, fp32 (x_bf16 = 0) or bf16 (x_bf16 = 1).
// scale, bias: [cols], fp32 (w_bf16 = 0) or bf16 (w_bf16 = 1).
// cols <= 2048; rows >= 1. Returns the launch's cudaError_t.
extern "C" int cor_layer_norm(const void* x, const void* scale, const void* bias, void* y,
                              long long rows, int cols, float eps, int x_bf16, int w_bf16,
                              void* stream) {
  if (rows < 1 || cols < 1 || cols > 64 * 32) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (x_bf16 && w_bf16)
    return launch<false, bf, bf, bf>(x, nullptr, scale, bias, y, rows, cols, eps, s);
  if (x_bf16)
    return launch<false, bf, bf, float>(x, nullptr, scale, bias, y, rows, cols, eps, s);
  if (w_bf16)
    return launch<false, float, float, bf>(x, nullptr, scale, bias, y, rows, cols, eps, s);
  return launch<false, float, float, float>(x, nullptr, scale, bias, y, rows, cols, eps, s);
}

// LayerNorm(x + y) -> out. x, y: [rows, cols] contiguous, each fp32 (*_bf16
// = 0) or bf16 (1); out: [rows, cols] in x's type. scale, bias: [cols], fp32
// (w_bf16 = 0) or bf16 (1). cols <= 2048; rows >= 1. Returns the launch's
// cudaError_t.
extern "C" int cor_add_layer_norm(const void* x, const void* y, const void* scale,
                                  const void* bias, void* out, long long rows, int cols,
                                  float eps, int x_bf16, int y_bf16, int w_bf16, void* stream) {
  if (rows < 1 || cols < 1 || cols > 64 * 32) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (x_bf16 && w_bf16)
    return launch_add<bf, bf>(x, y, y_bf16, scale, bias, out, rows, cols, eps, s);
  if (x_bf16)
    return launch_add<bf, float>(x, y, y_bf16, scale, bias, out, rows, cols, eps, s);
  if (w_bf16)
    return launch_add<float, bf>(x, y, y_bf16, scale, bias, out, rows, cols, eps, s);
  return launch_add<float, float>(x, y, y_bf16, scale, bias, out, rows, cols, eps, s);
}
