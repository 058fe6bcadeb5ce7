// K1-stack and K1-grid (two_way_stack.cuh says what they compute, how they
// run on the H100 and what bounds them): the C entry. The kernels are
// instantiated in two_way_stack_t{5,6,7,8}.cu, compiled beside this.

#include "two_way_stack.cuh"

namespace cor {
#define COR_FUSED_EXTERN(T, NT) \
  extern template int launch_fused<T, NT>(const FusedArgs&, cudaStream_t);
COR_FUSED_INSTANCES(COR_FUSED_EXTERN)
}  // namespace cor

// The fused depth-2 two-way transformer over n candidates, n_tok (5 to 8)
// tokens and N rows (a multiple of 64). cluster: 0 for K1-stack (a
// cooperative grid, the token state fp32 throughout), 1 for K1-grid (a
// cluster of 8 CTAs per candidate, the token state rounded to the compute
// dtype after layer 1). ptrs: a host array of the 50 device pointers of FusedArgs in its
// order: tokens, qpe_tok, src, idx (or null: candidate b reads src[b]; S is
// src's row count), 8 per layer (wtok, btok, w_img, b_img, wo_i, bo_ln4,
// kpe, qpe_img), kpe_f, wkv, bkv, wfin, bfin, x_mid[2], x_state[2], qt[3],
// q_img[2], part_m[3], part_l[3], part_acc[3], k_i[2], v_i[2], keys1,
// keys_out, tokens_out. f32: the compute dtype (0 bf16, 1 fp32).
extern "C" int cor_two_way_fused(int cluster, int S, int n, int n_tok, int N,
                                 const void* const* ptrs, float self_scale, float cross_scale,
                                 float eps, int f32, void* stream) {
  using namespace cor;
  if (n < 1 || n_tok < 5 || n_tok > 8 || N < kRows || N % kRows || S < 1 || !ptrs ||
      (cluster && static_cast<int64_t>(n) * kClusterCtas > 0x7fffffff))
    return cudaErrorInvalidValue;
  FusedArgs a = {};
  a.n = n;
  a.N = N;
  a.S = S;
  a.cluster = cluster;
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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_tokens(n_tok, [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    return f32 ? launch_fused<float, NT>(a, s) : launch_fused<uint16_t, NT>(a, s);
  });
}
