// Stage 3 of the two-way layer (two_way_layer.cu says what the layer's four
// launches do and what bounds them): per candidate, the combine of the
// image pass's t2i partials, the t2i out-projection, LN2, the ReLU MLP (256
// -> 2048 -> 256), LN3, and the i2t keys and values of the T tokens. Its
// own file so that nvcc compiles it beside the other token kernel.

#include "two_way_tokens.cuh"

namespace {

using namespace cor;

template <typename T, int NT>
__global__ void __launch_bounds__(kTokThreads)
twl_tokens_mid_kernel(const float* __restrict__ x_in, const T* __restrict__ qpe,
                      const float* __restrict__ part_m, const float* __restrict__ part_l,
                      const float* __restrict__ part_acc, int tiles,
                      const T* __restrict__ wt, const float* __restrict__ bt, float eps,
                      T* __restrict__ tokens_out, T* __restrict__ k_out,
                      T* __restrict__ v_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  tokens_mid_body<T, NT, kTokWarps>(smem, x_in, qpe, part_m, part_l, part_acc, tiles, wt, bt,
                                    eps, tokens_out, k_out, v_out, blockIdx.x);
}

template <typename T, int NT>
int tokens_mid(const void* x_in, const void* qpe, const void* part_m, const void* part_l,
               const void* part_acc, int tiles, const void* wt, const void* bt, float eps, int n,
               void* tokens_out, void* k_out, void* v_out, cudaStream_t stream) {
  constexpr size_t smem = smem_tokens_mid<NT>();
  cudaError_t err = cudaFuncSetAttribute(twl_tokens_mid_kernel<T, NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  twl_tokens_mid_kernel<T, NT><<<n, kTokThreads, smem, stream>>>(
      static_cast<const float*>(x_in), static_cast<const T*>(qpe),
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), tiles, static_cast<const T*>(wt),
      static_cast<const float*>(bt), eps, static_cast<T*>(tokens_out), static_cast<T*>(k_out),
      static_cast<T*>(v_out));
  return cudaGetLastError();
}

}  // namespace

// x_in: fp32 [n][n_tok][256] from cor_twl_tokens_in; partials of the image
// pass over `tiles` row tiles; tokens_out: T [n][n_tok][256]; k_out, v_out:
// T [n][n_tok][128].
extern "C" int cor_twl_tokens_mid(const void* x_in, const void* qpe, const void* part_m,
                                  const void* part_l, const void* part_acc, int tiles,
                                  const void* wt, const void* bt, float eps, int n, int n_tok,
                                  void* tokens_out, void* k_out, void* v_out, int f32,
                                  void* stream) {
  if (n < 1 || n > 65535 || tiles < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_tokens(n_tok, [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    return f32 ? tokens_mid<float, NT>(x_in, qpe, part_m, part_l, part_acc, tiles, wt, bt, eps,
                                       n, tokens_out, k_out, v_out, s)
               : tokens_mid<uint16_t, NT>(x_in, qpe, part_m, part_l, part_acc, tiles, wt, bt,
                                          eps, n, tokens_out, k_out, v_out, s);
  });
}

