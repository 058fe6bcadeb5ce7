// K2, the SAM mask decoder's final token -> image attention, redesigned for
// Hopper: the entry cor_t2i_final. Per candidate, with its rows [N][256]:
//
//   k = T(rows @ Wk^T + bk + kpe),  v = T(rows @ Wv^T + bv)
//   out[t, head h] = softmax_rows(qt_h[t] . k_h) v_h      (qt pre-scaled)
//
// Replaces the TPU kernel cor_tpu/ops/pallas/t2i_flash.py:t2i_flash_kv (its
// pallas_call at line 220). It computes what cor_t2i_image_pass and
// cor_t2i_combine (t2i_flash.cu) compute for it, in bf16 bit for bit, in one
// launch.
//
// What held the shared pass back (PERF.md): one 4-warp CTA per 64-row tile
// (2,560 at 40 candidates) staged the whole packed [k | v] weight through
// one 128 x 128 shared block for every tile (in bf16 128 KiB of weight from
// L2 for every 32 KiB of rows), each block a load, a barrier and then
// mma.sync, with nothing overlapping; in fp32 its 204,800 B of shared memory
// left one 4-warp CTA an SM; the combine was a launch of its own. Here K1's
// t2i pass (twl_t2i.cuh, twl_t2i.cu says how it runs) without its q chunk:
//
//  - a persistent grid, one CTA an SM, walks items of kGroups consecutive
//    64-row tiles of a candidate (bf16: 2, fp32: 1); the [k | v] weight
//    streams through a ring of 128-output blocks handed over by full/empty
//    mbarriers: in bf16 one TMA bulk copy a block out of the weight laid out
//    block by block (the wrapper's pack), in fp32 split once into its TF32
//    halves by the producer; the next item's rows load under the current
//    item's attention arithmetic;
//  - the projections run on wgmma m64n128: in bf16 the same products in the
//    same k order as the mma.sync pass (k and v are its bits), in fp32 in
//    3xTF32; k and v never leave shared memory;
//  - the tokens (5 to 32: the K8 route calls it above 8) are taken kMaxT = 8
//    at a time over the same k and v tile, so the logits stay at K1's
//    [64][68] and the shared memory at K1's size at any T: 228,440 B in
//    bf16, 222,292 in fp32. Each (head, token) partial is summed in the
//    shared pass's order;
//  - the combine is folded in: the consumer warpgroup that finishes a
//    candidate's last tile (a per-candidate ticket, atomicAdd after a
//    __threadfence) combines its partials in cor_t2i_combine's order (the
//    same bits), 8 tiles' float4 loads in flight a thread, and zeroes the
//    ticket, so the next launch, or a CUDA graph's replay, finds it at 0.
//    A CTA walks a contiguous range of items: dealt out round-robin, the
//    CTA that combined a candidate was, being behind by the combine, also
//    the last to finish the candidate of the next round, and the combines
//    chained along the kernel (PERF.md). The fold beat the pass followed
//    by cor_t2i_combine (PERF.md);
//
// What bounds it: per candidate 2 MiB of bf16 rows read (4 MiB in fp32) and
// 2 * 4096 * 256 * 256 = 0.54 GFLOP of projections (3x that in 3xTF32 at
// half bf16's rate), near the ~295 flop/byte ridge in bf16; the logits and
// the exponentials' product with v (8 T x 64 x 16 MACs each per tile, CUDA
// cores) reach a third of the projections' MACs at T = 32. The weight blocks
// come from L2 once per item (128 KiB per 128 rows in bf16, 256 KiB per 64
// rows in fp32), the partials (64 tiles x 8 T x 18 floats a candidate) go
// to L2 and back for the combine.

#include "twl_t2i.cuh"

namespace {

using namespace cor;
using namespace cor::t2i_hopper;

template <typename T>
__global__ void __launch_bounds__(T2iL<T>::kGroups * 128 + kProd, 1)
t2i_final_kernel(const T* __restrict__ keys, int n, int N, const T* __restrict__ w,
                 const T* __restrict__ w_blocks, const float* __restrict__ b,
                 const T* __restrict__ kpe, const T* __restrict__ qt, int nt,
                 float* __restrict__ part_m, float* __restrict__ part_l,
                 float* __restrict__ part_acc, int* __restrict__ tickets, T* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  t2i_pass<T, false, false, true>(smem, keys, nullptr, nullptr, n, n, N, w, w_blocks, b, kpe,
                                  nullptr, qt, nt, nullptr, part_m, part_l, part_acc, tickets,
                                  out);
}

template <typename T>
int launch(const void* keys, int n, int nt, int N, const void* w, const void* wb,
           const float* b, const void* kpe, const void* qt, float* pm, float* pl, float* pa,
           int* tickets, void* out, cudaStream_t stream) {
  // internal linkage (the anonymous namespace): each library keeps its own
  static int raised[wg::kMaxDevices] = {};
  using M = T2iSmem<T, false, true>;
  auto kernel = t2i_final_kernel<T>;
  cudaError_t err =
      wg::raise_shared_memory(reinterpret_cast<const void*>(kernel), M::bytes(kMaxT), raised);
  if (err != cudaSuccess) return err;
  constexpr int G = T2iL<T>::kGroups;
  const int items = n * ((N / kRows + G - 1) / G);
  const int sms = wg::sm_count();
  const int grid = items < sms ? items : sms;
  kernel<<<grid, G * 128 + kProd, M::bytes(nt), stream>>>(
      static_cast<const T*>(keys), n, N, static_cast<const T*>(w), static_cast<const T*>(wb), b,
      static_cast<const T*>(kpe), static_cast<const T*>(qt), nt, pm, pl, pa, tickets,
      static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// The final attention. Compute dtype T: bf16 (f32 = 0) or fp32 (f32 = 1).
// keys: T [n][N][256]; n_tok: the tokens, 1 to 32; w: T [2][128][256] (k | v
// projections, [out, in]); w_blocks: in bf16 w laid out as the ring's blocks
// (8 of [128][64] in the core-matrix layout, k's then v's; the wrapper's
// pack), unread in fp32; b: fp32 [2][128]; kpe: T [N][128]; qt: T
// [n][n_tok][128], scaled; partials: fp32 [n][N/64][8 n_tok] (m, l) and
// [n][N/64][8 n_tok][16] (acc), scratch; tickets: int32 [n], zero (and left
// zero); out: T [n][n_tok][128].
extern "C" int cor_t2i_final(const void* keys, int n, int n_tok, int N, const void* w,
                             const void* w_blocks, const void* b, const void* kpe,
                             const void* qt, void* part_m, void* part_l, void* part_acc,
                             void* tickets, void* out, int f32, void* stream) {
  if (n < 1 || n > 65535 || n_tok < 1 || n_tok > kMaxTok || N < kRows || N % kRows ||
      (!f32 && !w_blocks) || !tickets || !out)
    return cudaErrorInvalidValue;
  const float* bp = static_cast<const float*>(b);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  int* tk = static_cast<int*>(tickets);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? launch<float>(keys, n, n_tok, N, w, w_blocks, bp, kpe, qt, pm, pl, pa, tk, out, s)
             : launch<uint16_t>(keys, n, n_tok, N, w, w_blocks, bp, kpe, qt, pm, pl, pa, tk,
                                out, s);
}
