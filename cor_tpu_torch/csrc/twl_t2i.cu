// K1's token -> image pass (stage 2 of the two-way layer, two_way_layer.cu),
// redesigned for Hopper: the entry cor_twl_t2i, K1's own. It computes what
// cor_t2i_image_pass (t2i_flash.cu) computes for K1, and writes the same
// q_img and the same per-64-row-tile flash partials, which
// cor_twl_tokens_mid combines as before:
//
//   k = T(rows @ Wk^T + bk + kpe),  v = T(rows @ Wv^T + bv),
//   q_img = T(rows @ Wq^T + bq + qpe)                      (written out)
//   per tile and (head, token) query: m = max of the tile's 64 logits
//   qt_h[t] . k_h, l = sum exp(logit - m), acc = sum T(exp(logit - m)) v_h
//
// Replaces, with the three other launches of the layer, the TPU kernel
// cor_tpu/ops/pallas/two_way_layer.py:two_way_layer_fused (its pallas_calls
// at lines 978, 998 and 1012). The pass's body is twl_t2i.cuh's, which K2
// runs too without its q chunk (t2i_final.cu) and K8a with the tokens taken
// 8 at a time and the combine folded in (t2i_proj_q.cu), and K1-stack and
// K1-grid in their layers and final attention (two_way_stack.cuh), and
// K1-dma with its rows brought in by the TMA (two_way_layer_dma.cu).
//
// What held the shared pass back on the H100 (measured by launch, PERF.md):
// one CTA of 4 warps per 64-row tile staged the whole packed [k|v|q] weight
// (384 x 256) through one 128 x 128 shared block for every tile, each block
// a load, a barrier and then mma.sync, with nothing overlapping the loads;
// its logits read k with 4-way bank conflicts. Here:
//
//  - a persistent grid, one CTA an SM, walks work items of kGroups
//    consecutive 64-row tiles of a candidate (bf16: 2, one per consumer
//    warpgroup; fp32: 1). The weight streams through a ring of kStages
//    shared-memory blocks of 128 outputs x kKB inputs in wgmma's K-major
//    core-matrix layout, handed over by full and empty mbarriers, every
//    block serving the item's kGroups tiles. In bf16 one producer thread
//    moves each block with one TMA bulk copy out of the weight laid out
//    block by block (the wrapper's pack): per-thread cp.async of the same
//    blocks moved the ring several times slower and set the pass's time.
//    In fp32 two producer warps load each block kFetchDepth blocks ahead
//    and split it once into its TF32 halves (tf32_tiles.cuh). The
//    producer's other warps load the next item's rows into a warpgroup's
//    row tile once that warpgroup has finished its products (an int8 store
//    row is gathered through idx, 8 chunks of loads in flight a thread, and
//    dequantised as load_rows does it), under the attention arithmetic;
//  - the projections run on wgmma m64n128, chunk by chunk in the order q,
//    k, v: bf16 with the rows and the weight block from shared memory, the
//    same products in the same k order as the mma.sync pass, so k, v and
//    q_img are its bits; fp32 in 3xTF32 with each row fragment split as it
//    is loaded, the A operand from registers: small.big + big.small +
//    big.big a k-step. Each chunk's PE values are loaded under its
//    products and the bias is in shared memory; q goes out through k's
//    buffer, 16 bytes a thread and whole rows a warp;
//  - the logits, the tile softmax and the exponentials' product with v stay
//    on the CUDA cores in the shared pass's order (each logit summed over
//    d = 0..15, each acc over the rows 0..63, the same warp reductions), so
//    the partials are its bits in bf16; thread (row, head) forms the T
//    logits of a row's head side by side (k by 16-byte loads, q broadcast),
//    a warp reduces 4 query rows side by side, and thread (head, d) forms
//    the T sums of one channel (v and the exponentials broadcast).
//
// Shared memory (T = n_tok, 1 to 8): kStages x 16 KB of weight blocks, per
// consumer warpgroup its row tile (bf16 core-matrix [64][256], 32 KB; fp32
// [64][260], 66,560 B), k and v [64][kLdI] of the compute dtype, the logits
// [8 T][68] fp32 and the candidate's scaled queries [T][128] fp32, and the
// bias: 228,944 B in bf16 and 222,800 in fp32 at T = 8.
//
// What bounds it: per candidate 2 MiB of bf16 rows (0.5 MiB as int8) read,
// 1 MiB of q_img written and 0.8 GFLOP of projections (3x that in fp32's
// 3xTF32 at half bf16's rate: operations); the weight blocks come from L2
// once per item, 192 KiB per 128 rows in bf16, 384 KiB per 64 rows in fp32.
// What the card still spends beyond that (PERF.md): the attention
// arithmetic, which no product overlaps (both warpgroups reach it together,
// bound by the ring they share), and in fp32 the producer's splitting.

#include "twl_t2i.cuh"

namespace {

using namespace cor;
using namespace cor::t2i_hopper;

template <typename T, bool kInt8>
__global__ void __launch_bounds__(T2iL<T>::kGroups * 128 + kProd, 1)
twl_t2i_kernel(const void* __restrict__ src, const int* __restrict__ idx,
               const float* __restrict__ scale, int S, int n, int N, const T* __restrict__ w,
               const T* __restrict__ w_blocks, const float* __restrict__ b,
               const T* __restrict__ kpe,
               const T* __restrict__ qpe, const T* __restrict__ qt, int nt,
               T* __restrict__ q_img, float* __restrict__ part_m, float* __restrict__ part_l,
               float* __restrict__ part_acc) {
  extern __shared__ __align__(128) unsigned char smem[];
  t2i_pass<T, kInt8, true, false>(smem, src, idx, scale, S, n, N, w, w_blocks, b, kpe, qpe, qt,
                                  nt, q_img, part_m, part_l, part_acc, nullptr, nullptr);
}

template <typename T, bool kInt8>
int launch(const void* src, const int* idx, const float* scale, int S, int n, int nt, int N,
           const void* w, const void* wb, const float* b, const void* kpe, const void* qpe,
           const void* qt, void* q_img, float* pm, float* pl, float* pa, cudaStream_t stream) {
  static int raised[wg::kMaxDevices] = {};
  auto kernel = twl_t2i_kernel<T, kInt8>;
  const int bytes = T2iSmem<T, true, false>::bytes(kMaxT);
  cudaError_t err = wg::raise_shared_memory(reinterpret_cast<const void*>(kernel), bytes, raised);
  if (err != cudaSuccess) return err;
  constexpr int G = T2iL<T>::kGroups;
  const int items = n * ((N / kRows + G - 1) / G);
  const int sms = wg::sm_count();
  const int grid = items < sms ? items : sms;
  kernel<<<grid, G * 128 + kProd, T2iSmem<T, true, false>::bytes(nt), stream>>>(
      src, idx, scale, S, n, N, static_cast<const T*>(w), static_cast<const T*>(wb), b,
      static_cast<const T*>(kpe),
      static_cast<const T*>(qpe), static_cast<const T*>(qt), nt, static_cast<T*>(q_img), pm, pl,
      pa);
  return cudaGetLastError();
}

template <typename T>
int t2i(const void* src, int src_int8, const int* ip, const float* sp, int S, int n, int nt,
        int N, const void* w, const void* wb, const float* bp, const void* kpe, const void* qpe,
        const void* qt, void* q_img, float* pm, float* pl, float* pa, cudaStream_t s) {
  auto go = [&](auto fn) {
    return fn(src, ip, sp, S, n, nt, N, w, wb, bp, kpe, qpe, qt, q_img, pm, pl, pa, s);
  };
  return src_int8 ? go(launch<T, true>) : go(launch<T, false>);
}

}  // namespace

// K1's stage 2: cor_t2i_image_pass's arguments (t2i_flash.cu) with qpe and
// q_img required, n_tok 1 to 8, and w_blocks: in bf16 w laid out as the
// ring's blocks (12 of [128][64] in the core-matrix layout, chunks in the
// order q, k, v; the wrapper's pack), unread in fp32. The same outputs (in
// bf16 the same bits).
extern "C" int cor_twl_t2i(const void* src, int src_int8, const void* idx, const void* scale,
                           int S, int n, int n_tok, int N, const void* w, const void* w_blocks,
                           const void* b, const void* kpe, const void* qpe, const void* qt,
                           void* q_img, void* part_m, void* part_l, void* part_acc, int f32,
                           void* stream) {
  if (n < 1 || n > 65535 || n_tok < 1 || n_tok > kMaxT || N < kRows || N % kRows || S < 1 ||
      (src_int8 && (!scale || !idx)) || !qpe || !q_img || (!f32 && !w_blocks))
    return cudaErrorInvalidValue;
  const int* ip = static_cast<const int*>(idx);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(b);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? t2i<float>(src, src_int8, ip, sp, S, n, n_tok, N, w, w_blocks, bp, kpe, qpe, qt,
                          q_img, pm, pl, pa, s)
             : t2i<uint16_t>(src, src_int8, ip, sp, S, n, n_tok, N, w, w_blocks, bp, kpe, qpe,
                             qt, q_img, pm, pl, pa, s);
}
