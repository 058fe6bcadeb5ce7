// K1-stack and K1-grid (two_way_stack.cuh says what they compute, how they
// run on the H100 and what bounds them): the C entry. The kernels are
// instantiated in two_way_stack_t{5,6,7,8}_{bf16,f32}.cu, compiled beside
// this.

#include "two_way_stack.cuh"

namespace cor {
COR_FUSED_INSTANCES(COR_FUSED_DECLARE)

// the instance for n_tok and the dtype
static int fused_launch(const stack::FusedArgs& a, int grid, int cl, int n_tok, int f32,
                        cudaStream_t s, int* dry) {
  switch (n_tok * 2 + (f32 ? 1 : 0)) {
#define COR_FUSED_CASE(T, NT, TAG) \
  case NT * 2 + (sizeof(T) == 4 ? 1 : 0): return COR_FUSED_NAME(NT, TAG)(a, grid, cl, s, dry);
    COR_FUSED_INSTANCES(COR_FUSED_CASE)
#undef COR_FUSED_CASE
    default: return cudaErrorInvalidValue;
  }
}
}  // namespace cor

// The fused depth-2 two-way transformer over n candidates, n_tok (5 to 8)
// tokens and N rows (a multiple of 64). cluster: bit 0 the schedule, 0 for
// K1-stack (a cooperative grid, the token state fp32 throughout), 1 for
// K1-grid (a cluster of CTAs per candidate, the token state rounded to the
// compute dtype after layer 1); bits 8-11 the CTAs of a candidate's token
// stages (1, 2, 4 or 8; 0, as the wrappers call it: two_way_stack.cuh's
// choose_cluster). ptrs: a host array of the 55 device pointers of
// FusedArgs in this order: tokens, qpe_tok, src, idx (or null: candidate b
// reads src[b]; S is src's row count), 8 per layer (wtok, btok, w_img,
// b_img, wo_i, bo_ln4, kpe, qpe_img), kpe_f, wkv, bkv, wfin, bfin, x_mid[2],
// x_state[2], qt[3], q_img[2], part_m[3], part_l[3], part_acc[3], k_i[2],
// v_i[2], keys1, keys_out, tokens_out; then the bf16 weights laid out as the
// image passes' ring blocks (null in fp32, unread): per layer w_img_blocks
// and wo_i_blocks, and wkv_blocks (the first 50 are the earlier entry's, in
// its order). f32: the compute dtype (0 bf16, 1 fp32).
extern "C" int cor_two_way_fused(int cluster, int S, int n, int n_tok, int N,
                                 const void* const* ptrs, float self_scale, float cross_scale,
                                 float eps, int f32, void* stream) {
  using namespace cor;
  const int grid = cluster & 1, cl = (cluster >> 8) & 0xf;
  if (n < 1 || n_tok < 5 || n_tok > 8 || N < kRows || N % kRows || S < 1 || !ptrs ||
      (cluster & ~0xf01) || (cl != 0 && cl != 1 && cl != 2 && cl != 4 && cl != 8))
    return cudaErrorInvalidValue;
  stack::FusedArgs a = {};
  a.n = n;
  a.N = N;
  a.S = S;
  a.self_scale = self_scale;
  a.cross_scale = cross_scale;
  a.eps = eps;
  int i = 0;
  auto next = [&]() { return const_cast<void*>(ptrs[i++]); };
  a.tokens = next();
  a.qpe_tok = next();
  a.src = next();
  a.idx = static_cast<const int*>(next());
  for (auto& w : a.layer) {
    w.wtok = next();
    w.btok = static_cast<const float*>(next());
    w.w_img = next();
    w.b_img = static_cast<const float*>(next());
    w.wo_i = next();
    w.bo_ln4 = static_cast<const float*>(next());
    w.kpe = next();
    w.qpe_img = next();
  }
  a.kpe_f = next();
  a.wkv = next();
  a.bkv = static_cast<const float*>(next());
  a.wfin = next();
  a.bfin = static_cast<const float*>(next());
  for (auto& p : a.x_mid) p = static_cast<float*>(next());
  for (auto& p : a.x_state) p = static_cast<float*>(next());
  for (auto& p : a.qt) p = next();
  for (auto& p : a.q_img) p = next();
  for (auto& p : a.part_m) p = static_cast<float*>(next());
  for (auto& p : a.part_l) p = static_cast<float*>(next());
  for (auto& p : a.part_acc) p = static_cast<float*>(next());
  for (auto& p : a.k_i) p = next();
  for (auto& p : a.v_i) p = next();
  a.keys1 = next();
  a.keys_out = next();
  a.tokens_out = next();
  for (auto& w : a.layer) {
    w.w_img_blocks = next();
    w.wo_i_blocks = next();
  }
  a.wkv_blocks = next();
  if (!f32 && (!a.layer[0].w_img_blocks || !a.layer[0].wo_i_blocks ||
               !a.layer[1].w_img_blocks || !a.layer[1].wo_i_blocks || !a.wkv_blocks))
    return cudaErrorInvalidValue;
  return cor::fused_launch(a, grid, cl, n_tok, f32, static_cast<cudaStream_t>(stream), nullptr);
}

// The launch cor_two_way_fused would make, without making it: team[0] the
// CTAs of a candidate's token stages, team[1] the CTAs of the grid; cluster,
// n, n_tok, N and f32 as cor_two_way_fused takes them.
extern "C" int cor_two_way_fused_team(int cluster, int n, int n_tok, int N, int f32, int* team) {
  using namespace cor;
  const int grid = cluster & 1, cl = (cluster >> 8) & 0xf;
  if (n < 1 || n_tok < 5 || n_tok > 8 || N < kRows || N % kRows || !team ||
      (cluster & ~0xf01) || (cl != 0 && cl != 1 && cl != 2 && cl != 4 && cl != 8))
    return cudaErrorInvalidValue;
  stack::FusedArgs a = {};
  a.n = n;
  a.N = N;
  return cor::fused_launch(a, grid, cl, n_tok, f32, nullptr, team);
}
