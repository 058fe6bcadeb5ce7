// One TwoWayAttentionBlock of the SAM mask decoder over n candidates:
// tokens [n, T, 256] (T = 5 to 8: iou + 4 mask tokens + up to 3 prompt
// tokens) and image rows [n, N, 256] (or an int8 candidate store gathered
// through idx).
//
// Replaces the TPU kernel cor_tpu/ops/pallas/two_way_layer.py:
// two_way_layer_fused (its pallas_calls at lines 978, 998 and 1012). The TPU
// kernel runs the whole layer for 4 candidates in one grid step, because
// VMEM holds their 8 MiB of rows, with the tokens padded to 8 and masked. On
// the H100 the kernels run T itself. Two steps of the layer need
// every row of a candidate before they can go on: the token -> image softmax
// runs over all N rows before the token MLP, and every row's image -> token
// attention needs the tokens after the MLP. So the layer is four launches,
// each hand-written:
//
//  1. cor_twl_tokens_in_cluster (twl_tokens_in.cu), a cluster of 4 CTAs per
//     candidate while they all fit at once (else cor_twl_tokens_in, here,
//     one CTA per candidate): token self-attention (8 heads of 32; no PE and no residual
//     on the first layer), LN1, and the t2i query, scaled after its bias and
//     rounded;
//  2. cor_twl_t2i (twl_t2i.cu), a persistent CTA an SM over (candidate,
//     row tiles) items: the rows (int8 dequantised inside), their packed
//     [k|v|q] projection on wgmma, q_img written out, and the t2i flash
//     partials of each 64-row tile;
//  3. cor_twl_tokens_mid_cluster (twl_tokens_mid.cu), as stage 1 (else
//     cor_twl_tokens_mid, two_way_layer_mid.cu): the partials' combine, the t2i out-projection, LN2, the
//     ReLU MLP (256 -> 2048 -> 256), LN3, and the i2t keys and values of the
//     T tokens;
//  4. cor_twl_i2t (twl_i2t.cu), a persistent CTA an SM over (candidate,
//     row tiles) items: the i2t softmax over the T tokens of each head
//     (exact per-head max), its product with the values, the out-projection
//     [128 -> 256] on wgmma, the residual with the (re-read, dequantised)
//     rows, LN4, and the new rows in bf16.
//
// The four are K1's own, redesigned for Hopper (their sources say how);
// they compute what the shared __device__ bodies compute, bit for bit: the
// token stages of two_way_tokens.cuh, which this file's cor_twl_tokens_in
// and two_way_layer_mid.cu's cor_twl_tokens_mid run one CTA per candidate
// (K1's cluster entries fall back to them above 66 candidates), and the
// image bodies of t2i_flash.cuh and i2t_attention.cuh, which the first K2,
// K8a, K8b and K1-dma ran (t2i_flash.cu, i2t_attention.cu); K1-dma runs K1's
// passes with its rows moved by bulk copies (two_way_layer_dma.cu), K1-stack
// and K1-grid (two_way_stack.cuh) K1's passes and their own split of the
// token stages.
//
// The token stages are small (T tokens x ~1.4 M MACs per layer and
// candidate): each warp computes 4 whole output columns at a time (2 for the
// MLP's 2048-wide input), its lanes walking the weight rows [out, in] with
// 16-byte loads all issued up front, and reducing with shuffles; the
// token state stays fp32 in shared memory between the steps, and every
// product operand is rounded to bf16 first, as in the TPU kernel.
//
// What bounds the layer on the H100: the image passes. Per candidate they
// read the rows twice (2 x 2 MiB in bf16, 2 x 0.5 MiB as int8), write and
// read q_img (2 x 1 MiB), write the new rows (2 MiB), and do about 1.1 GFLOP
// on the tensor cores, at the ~295 flop/byte ridge of the card: bytes and
// operations both count.
//
// fp32 (compute_dtype float32): the four kernels are templated on the
// element type T (decoder_common.cuh's Elem<T>); the weights, tokens,
// q_img, k/v of the tokens and the new rows are fp32, nothing is rounded
// (cor_tpu rounds each product operand to the compute dtype: in fp32 that
// is nothing), the int8 store dequantises to fp32, and the i2t
// out-projection runs in 3xTF32 (mma_tf32x3.cuh). The token kernels stay
// on the CUDA cores (fp32 FMAs), their weight rows read with 16-byte loads
// of 4 values; the i2t pass stages 168,960 + 1,024 T bytes of shared memory
// in fp32 (its out-projection weight [256][132], the attention output
// [64][132], the tokens' keys and values).
//
// The token count: the two token kernels are templated on it (T = 5, 6, 7,
// 8: their loops over the tokens unroll, and T = 6 is the code of the 6-token
// kernel). The image passes take it at run time, up to kMaxTok = 32, with
// their shared memory sized at launch, because the i2t kernel was also
// cor_tpu's K8b (cor_tpu/ops/pallas/i2t_attention.py:i2t_attention_fused,
// its pallas_call at line 105: the same stage 4 where cor_tpu's fused decode
// does not take its layer kernel, above 8 tokens), called with its tokens'
// keys and values computed outside (K8b runs twl_i2t.cu's pass since).

#include "two_way_tokens.cuh"

namespace {

using namespace cor;

template <typename T, int NT>
__global__ void __launch_bounds__(kTokThreads)
twl_tokens_in_kernel(const T* __restrict__ tokens, const T* __restrict__ qpe,
                     const T* __restrict__ wt, const float* __restrict__ bt, int skip_pe,
                     float self_scale, float cross_scale, float eps, float* __restrict__ x_out,
                     T* __restrict__ qt_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  tokens_in_body<T, NT, kTokWarps>(smem, tokens, qpe, wt, bt, skip_pe, self_scale, cross_scale,
                                   eps, x_out, qt_out, blockIdx.x);
}

template <typename T, int NT>
int tokens_in(const void* tokens, const void* qpe, const void* wt, const void* bt, int skip_pe,
              float self_scale, float cross_scale, float eps, int n, void* x_out, void* qt_out,
              cudaStream_t stream) {
  constexpr size_t smem = smem_tokens_in<NT>();
  cudaError_t err = cudaFuncSetAttribute(twl_tokens_in_kernel<T, NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  twl_tokens_in_kernel<T, NT><<<n, kTokThreads, smem, stream>>>(
      static_cast<const T*>(tokens), static_cast<const T*>(qpe), static_cast<const T*>(wt),
      static_cast<const float*>(bt), skip_pe, self_scale, cross_scale, eps,
      static_cast<float*>(x_out), static_cast<T*>(qt_out));
  return cudaGetLastError();
}

}  // namespace

// Compute dtype T: bf16 (f32 = 0) or fp32 (f32 = 1), in all four entries of
// the layer; n_tok: the tokens, 5 to 8 in the token kernels, 1 to 32 in the
// image passes. tokens, qpe: T [n][n_tok][256]; wt: the T weights, bt: the
// fp32 vectors (offsets in two_way_tokens.cuh); x_out: fp32 [n][n_tok][256];
// qt_out: T [n][n_tok][128].
extern "C" int cor_twl_tokens_in(const void* tokens, const void* qpe, const void* wt,
                                 const void* bt, int skip_pe, float self_scale,
                                 float cross_scale, float eps, int n, int n_tok, void* x_out,
                                 void* qt_out, int f32, void* stream) {
  if (n < 1 || n > 65535) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_tokens(n_tok, [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    return f32 ? tokens_in<float, NT>(tokens, qpe, wt, bt, skip_pe, self_scale, cross_scale, eps,
                                      n, x_out, qt_out, s)
               : tokens_in<uint16_t, NT>(tokens, qpe, wt, bt, skip_pe, self_scale, cross_scale,
                                         eps, n, x_out, qt_out, s);
  });
}

