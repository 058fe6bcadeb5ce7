// K6/K7's fp32 kernel at head_dim 80 (vit_attention_f32.cuh), a source of
// its own so that nvcc builds each head_dim in parallel.
#include "vit_attention_f32.cuh"

int cor::vit::launch_f32_d80(const float* qkv, const float* rel_h, const float* rel_w,
                             float* out, float* lse, int blocks, int N, int C, int num_heads,
                             int H, int W, float scale, const WindowGrid& wgrid, bool win,
                             cudaStream_t stream) {
  return f32::launch<80>(qkv, rel_h, rel_w, out, lse, blocks, N, C, num_heads, H, W, scale,
                         wgrid, win, stream);
}
