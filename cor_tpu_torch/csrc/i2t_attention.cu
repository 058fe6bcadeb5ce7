// cor_tpu's K8b, and the body of stage 4 of the two-way layer that the first
// designs ran (K1's own is twl_i2t.cu, which K8b, K1-dma, K1-stack and K1-grid
// run too; no wrapper calls this entry now: tools/kernel_bits.py serves an
// older library's K8b by it; two_way_layer.cu says
// what the layer's four launches do and what bounds them): per (64-row tile,
// candidate), the image -> token softmax over the T tokens of each head, its
// product with the tokens' values, the out-projection [128 -> 256] on the
// tensor cores, the residual with the (re-read, dequantised) rows, LN4, and
// the new rows.
//
// The first port, besides the layer's stage 4, of the TPU kernel
// cor_tpu/ops/pallas/i2t_attention.py:i2t_attention_fused (its pallas_call
// at line 105), which cor_tpu's fused decode runs where its layer kernel
// does not (above 8 tokens), with the tokens' keys and values computed
// outside; K8b runs K1's pass redesigned for Hopper since (twl_i2t.cu), and
// no wrapper calls cor_twl_image_i2t now: it stays as the reference the
// redesign keeps the bits of (tools/kernel_bits.py serves an older
// library's K8b by it). T is a run-time argument, 1 to
// kMaxTok = 32; the shared memory (the out-projection weight, the
// attention output and the tokens' keys and values: 87,040 + 1,024 T bytes
// in bf16, 168,960 + 1,024 T in fp32) is sized at launch. What bounds it on
// the H100: per candidate it reads 1 MiB of q_img and 2 MiB of rows and
// writes 2 MiB (bf16), and does 0.27 GFLOP of out-projection on the tensor
// cores and 8 x 4096 x 2 x 16 T MACs of the softmax on the CUDA cores:
// bytes, at T up to 32.

#include "i2t_attention.cuh"

namespace {

using namespace cor;

template <typename T, bool kInt8>
__global__ void __launch_bounds__(kImgThreads)
twl_image_i2t_kernel(const void* __restrict__ src, const int* __restrict__ idx,
                     const float* __restrict__ scale, int S, int N, const T* __restrict__ q_img,
                     const T* __restrict__ k_i, const T* __restrict__ v_i, int nt,
                     const T* __restrict__ wo, const float* __restrict__ bo_ln, float eps,
                     float cross_scale, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  i2t_tile<T, kInt8>(smem, src, idx, scale, S, N, q_img, k_i, v_i, nt, wo, bo_ln, eps,
                     cross_scale, out, blockIdx.x, blockIdx.y);
}

template <typename T, bool kInt8>
int launch_i2t(const void* src, const int* idx, const float* scale, int S, int n, int nt, int N,
               const void* q_img, const void* k_i, const void* v_i, const void* wo,
               const float* bo_ln, float eps, float cross_scale, void* out, cudaStream_t stream) {
  auto kernel = twl_image_i2t_kernel<T, kInt8>;
  const size_t smem = smem_i2t<T>(nt);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(N / kRows, n), kImgThreads, smem, stream>>>(
      src, idx, scale, S, N, static_cast<const T*>(q_img), static_cast<const T*>(k_i),
      static_cast<const T*>(v_i), nt, static_cast<const T*>(wo), bo_ln, eps, cross_scale,
      static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// src/idx/S as for cor_t2i_image_pass (src_int8 must be 0: K1's int8 store
// takes cor_twl_i2t); q_img T [n][N][128]; k_i, v_i T [n][n_tok][128]; wo T
// [256][128]; bo_ln4 fp32 [3][256]; keys_out T [n][N][256]. K8b
// (its first port): bf16 or fp32 rows, no idx, the tokens' keys and values
// from its caller.
extern "C" int cor_twl_image_i2t(const void* src, int src_int8, const void* idx,
                                 const void* scale, int S, int n, int n_tok, int N,
                                 const void* q_img, const void* k_i, const void* v_i,
                                 const void* wo, const void* bo_ln4, float eps, float cross_scale,
                                 void* keys_out, int f32, void* stream) {
  if (n < 1 || n > 65535 || n_tok < 1 || n_tok > kMaxTok || N < kRows || N % kRows || S < 1 ||
      src_int8)
    return cudaErrorInvalidValue;
  const int* ip = static_cast<const int*>(idx);
  const float* sp = static_cast<const float*>(scale);
  const float* bl = static_cast<const float*>(bo_ln4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto launch) {
    return launch(src, ip, sp, S, n, n_tok, N, q_img, k_i, v_i, wo, bl, eps, cross_scale,
                  keys_out, s);
  };
  return f32 ? go(launch_i2t<float, false>) : go(launch_i2t<uint16_t, false>);
}
