// K1-stack and K1-grid (two_way_stack.cuh) at 8 tokens, bf16 and fp32.

#include "two_way_stack.cuh"

namespace cor {
template int launch_fused<uint16_t, 8>(const FusedArgs&, cudaStream_t);
template int launch_fused<float, 8>(const FusedArgs&, cudaStream_t);
}  // namespace cor
