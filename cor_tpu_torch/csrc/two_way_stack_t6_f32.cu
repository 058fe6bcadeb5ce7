// K1-stack and K1-grid (two_way_stack.cuh) at 6 tokens in fp32.

#include "two_way_stack.cuh"

namespace cor {
COR_FUSED_DEFINE(float, 6, f32)
}  // namespace cor
