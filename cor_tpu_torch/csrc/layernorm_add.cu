// K5': LayerNorm(x + y), the sum in fp32 and never rounded
// (cor_tpu/ops/pallas/layernorm.py:add_layer_norm_pallas, its pallas_call at
// line 100): K5's kernel (layernorm.cuh) with the add in its registers.

#include "layernorm.cuh"

namespace {

// LayerNorm(x + r) with r's element type picked at run time
template <typename TX, typename TW>
cudaError_t launch_add(const void* x, const void* r, int r_bf16, const void* scale,
                       const void* bias, void* y, int64_t rows, int cols, float eps,
                       cudaStream_t stream) {
  namespace ln = cor::ln;
  if (r_bf16)
    return ln::launch<true, TX, __nv_bfloat16, TW>(x, r, scale, bias, y, rows, cols, eps, stream);
  return ln::launch<true, TX, float, TW>(x, r, scale, bias, y, rows, cols, eps, stream);
}

}  // namespace

// LayerNorm(x + y) -> out. x, y: [rows, cols] contiguous, each fp32 (*_bf16
// = 0) or bf16 (1); out: [rows, cols] in x's type. scale, bias: [cols], fp32
// (w_bf16 = 0) or bf16 (1). cols <= 2048; rows >= 1. Returns the launch's
// cudaError_t.
extern "C" int cor_add_layer_norm(const void* x, const void* y, const void* scale,
                                  const void* bias, void* out, long long rows, int cols,
                                  float eps, int x_bf16, int y_bf16, int w_bf16, void* stream) {
  if (rows < 1 || cols < 1 || cols > cor::ln::kMaxCols) return cudaErrorInvalidValue;
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
