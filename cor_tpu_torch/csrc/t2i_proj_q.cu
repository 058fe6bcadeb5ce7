// K8a, the token -> image attention of a two-way layer on the K8 route (the
// fused decode above 8 tokens), redesigned for Hopper: the entry
// cor_t2i_proj_q. Per candidate, with its rows [N][256]:
//
//   k = T(rows @ Wk^T + bk + kpe),  v = T(rows @ Wv^T + bv),
//   q_img = T(rows @ Wq^T + bq + qpe)                      (written out)
//   out[t, head h] = softmax_rows(qt_h[t] . k_h) v_h      (qt pre-scaled)
//
// Replaces the TPU kernel cor_tpu/ops/pallas/t2i_flash.py:proj_q_t2i_flash
// (its pallas_call at line 163). It computes what cor_t2i_image_pass and
// cor_t2i_combine (t2i_flash.cu) compute for it, in bf16 bit for bit, in one
// launch.
//
// What held the shared pass back (PERF.md): one 4-warp CTA per 64-row tile
// staged the whole packed [k | v | q] weight through one 128 x 128 shared
// block for every tile, each block a load, a barrier and then mma.sync,
// with nothing overlapping the loads; its logits read k with bank
// conflicts; the combine was a launch of its own. Here K1's t2i pass
// (twl_t2i.cuh; twl_t2i.cu says how it runs) with its q chunk (kQ) and K2's
// tokens and combine (kFold; t2i_final.cu says how they run):
//
//  - a persistent grid, one CTA an SM, walks contiguous ranges of items of
//    kGroups consecutive 64-row tiles of a candidate (bf16: 2, fp32: 1); the
//    packed weight streams through a ring of 128-output blocks in K1's chunk
//    order q, k, v: in bf16 one TMA bulk copy a block out of the weight laid
//    out block by block (the wrapper's pack, K1's layout), in fp32 split
//    once into its TF32 halves by the producer; the next item's rows load
//    under the current item's attention arithmetic, asking L2 to evict them
//    first;
//  - the projections run on wgmma m64n128 (bf16 in the mma.sync pass's k
//    order, so q_img, k and v are its bits; fp32 in 3xTF32); q_img goes out
//    through k's buffer, 16 bytes a thread and whole rows a warp;
//  - the tokens (5 to 32: the K8 route calls it above 8) are taken kMaxT = 8
//    at a time over the same k and v tile, each (head, token) partial in the
//    shared pass's order, so the shared memory is K1's at any T: 228,952 B
//    in bf16, 222,804 in fp32 (with the ticket slots);
//  - the consumer warpgroup that finishes a candidate's last tile combines
//    its partials in cor_t2i_combine's order (a per-candidate ticket shared
//    with K2: each launch leaves it at zero, and the two kernels run on one
//    stream).
//
// What bounds it: per candidate 2 MiB of bf16 rows read (4 MiB in fp32), 1
// MiB of q_img written (2 MiB) and 3 * 2 * 4096 * 256 * 128 = 0.8 GFLOP of
// projections (3x that in 3xTF32 at half bf16's rate: operations there);
// bytes in bf16. The logits and the exponentials' product with v (8 T x 64
// x 16 MACs each per tile, CUDA cores) reach a quarter of the projections'
// MACs at T = 32. The weight blocks come from L2 once per item (192 KiB per
// 128 rows in bf16, 384 KiB per 64 rows in fp32).

#include "twl_t2i.cuh"

namespace {

using namespace cor;
using namespace cor::t2i_hopper;

template <typename T>
__global__ void __launch_bounds__(T2iL<T>::kGroups * 128 + kProd, 1)
t2i_proj_q_kernel(const T* __restrict__ keys, int n, int N, const T* __restrict__ w,
                  const T* __restrict__ w_blocks, const float* __restrict__ b,
                  const T* __restrict__ kpe, const T* __restrict__ qpe,
                  const T* __restrict__ qt, int nt, T* __restrict__ q_img,
                  float* __restrict__ part_m, float* __restrict__ part_l,
                  float* __restrict__ part_acc, int* __restrict__ tickets, T* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  t2i_pass<T, false, true, true>(smem, keys, nullptr, nullptr, n, n, N, w, w_blocks, b, kpe, qpe,
                                 qt, nt, q_img, part_m, part_l, part_acc, tickets, out);
}

template <typename T>
int launch(const void* keys, int n, int nt, int N, const void* w, const void* wb,
           const float* b, const void* kpe, const void* qpe, const void* qt, void* q_img,
           float* pm, float* pl, float* pa, int* tickets, void* out, cudaStream_t stream) {
  // internal linkage (the anonymous namespace): each library keeps its own
  static int raised[wg::kMaxDevices] = {};
  using M = T2iSmem<T, true, true>;
  auto kernel = t2i_proj_q_kernel<T>;
  cudaError_t err =
      wg::raise_shared_memory(reinterpret_cast<const void*>(kernel), M::bytes(kMaxT), raised);
  if (err != cudaSuccess) return err;
  constexpr int G = T2iL<T>::kGroups;
  const int items = n * ((N / kRows + G - 1) / G);
  const int sms = wg::sm_count();
  const int grid = items < sms ? items : sms;
  kernel<<<grid, G * 128 + kProd, M::bytes(nt), stream>>>(
      static_cast<const T*>(keys), n, N, static_cast<const T*>(w), static_cast<const T*>(wb), b,
      static_cast<const T*>(kpe), static_cast<const T*>(qpe), static_cast<const T*>(qt), nt,
      static_cast<T*>(q_img), pm, pl, pa, tickets, static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// K8a. Compute dtype T: bf16 (f32 = 0) or fp32 (f32 = 1). keys: T
// [n][N][256]; n_tok: the tokens, 1 to 32; w: T [3][128][256] (k | v | q
// projections, [out, in]); w_blocks: in bf16 w laid out as the ring's blocks
// (12 of [128][64] in the core-matrix layout, chunks in the order q, k, v:
// K1's pack), unread in fp32; b: fp32 [3][128]; kpe, qpe: T [N][128]; qt: T
// [n][n_tok][128], scaled; q_img: T [n][N][128]; partials: fp32
// [n][N/64][8 n_tok] (m, l) and [n][N/64][8 n_tok][16] (acc), scratch;
// tickets: int32 [n], zero (and left zero); out: T [n][n_tok][128].
extern "C" int cor_t2i_proj_q(const void* keys, int n, int n_tok, int N, const void* w,
                              const void* w_blocks, const void* b, const void* kpe,
                              const void* qpe, const void* qt, void* q_img, void* part_m,
                              void* part_l, void* part_acc, void* tickets, void* out, int f32,
                              void* stream) {
  if (n < 1 || n > 65535 || n_tok < 1 || n_tok > kMaxTok || N < kRows || N % kRows ||
      (!f32 && !w_blocks) || !qpe || !q_img || !tickets || !out)
    return cudaErrorInvalidValue;
  const float* bp = static_cast<const float*>(b);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  int* tk = static_cast<int*>(tickets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? launch<float>(keys, n, n_tok, N, w, w_blocks, bp, kpe, qpe, qt, q_img, pm, pl, pa,
                             tk, out, s)
             : launch<uint16_t>(keys, n, n_tok, N, w, w_blocks, bp, kpe, qpe, qt, q_img, pm, pl,
                                pa, tk, out, s);
}
