// K6b's bf16 kernels at head_dim 80 (vit_attention_bwd_wgmma.cuh), a source
// of their own so that nvcc builds each head_dim in parallel.
#include "vit_attention_bwd_wgmma.cuh"

int cor::k6b::launch_bf16_d80(const void* qkv, const void* rel_h, const void* rel_w,
                             const void* dout, const void* out, const void* lse, void* dqkv,
                             void* drel_h, void* drel_w, void* stats, int B, int N, int C,
                             int num_heads, int H, int W, float scale, cudaStream_t stream) {
  return launch_bf16<80>(qkv, rel_h, rel_w, dout, out, lse, dqkv, drel_h, drel_w, stats, B, N, C,
                        num_heads, H, W, scale, stream);
}
