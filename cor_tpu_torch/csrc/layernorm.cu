// K5: LayerNorm over the last axis (cor_tpu/ops/pallas/layernorm.py:
// layer_norm_pallas, its pallas_call at line 70). The kernel and its design:
// layernorm.cuh; LayerNorm(x + y), K5', in layernorm_add.cu.

#include "layernorm.cuh"

// x, y: [rows, cols] contiguous, fp32 (x_bf16 = 0) or bf16 (x_bf16 = 1).
// scale, bias: [cols], fp32 (w_bf16 = 0) or bf16 (w_bf16 = 1).
// cols <= 2048; rows >= 1. Returns the launch's cudaError_t.
extern "C" int cor_layer_norm(const void* x, const void* scale, const void* bias, void* y,
                              long long rows, int cols, float eps, int x_bf16, int w_bf16,
                              void* stream) {
  namespace ln = cor::ln;
  if (rows < 1 || cols < 1 || cols > ln::kMaxCols) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (x_bf16 && w_bf16)
    return ln::launch<false, bf, bf, bf>(x, nullptr, scale, bias, y, rows, cols, eps, s);
  if (x_bf16)
    return ln::launch<false, bf, bf, float>(x, nullptr, scale, bias, y, rows, cols, eps, s);
  if (w_bf16)
    return ln::launch<false, float, float, bf>(x, nullptr, scale, bias, y, rows, cols, eps, s);
  return ln::launch<false, float, float, float>(x, nullptr, scale, bias, y, rows, cols, eps, s);
}
