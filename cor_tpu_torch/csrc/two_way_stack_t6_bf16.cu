// K1-stack and K1-grid (two_way_stack.cuh) at 6 tokens in bf16.

#include "two_way_stack.cuh"

namespace cor {
COR_FUSED_DEFINE(uint16_t, 6, bf16)
}  // namespace cor
