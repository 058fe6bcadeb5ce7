// K1's image -> token pass (stage 4 of the two-way layer, two_way_layer.cu),
// redesigned for Hopper: the entry cor_twl_i2t, K1's own. It computes what
// cor_twl_image_i2t (i2t_attention.cu) computes for K1: per row and head the
// softmax over the T tokens' keys of the scaled query q_img, its product with
// the tokens' values, the out-projection [128 -> 256], + bias + the rows
// (re-read, an int8 store row dequantised), LN4, the new rows.
//
// Replaces, with the three other launches of the layer, the TPU kernel
// cor_tpu/ops/pallas/two_way_layer.py:two_way_layer_fused (its pallas_calls
// at lines 978, 998 and 1012), and, at 9 to 32 tokens (kWide), the TPU
// kernel cor_tpu/ops/pallas/i2t_attention.py:i2t_attention_fused (its
// pallas_call at line 105), K8b, which the K8 route runs with the tokens'
// keys and values from torch (ops/kernels/i2t_attention.py). The pass's body
// is twl_i2t.cuh's, which K1-stack and K1-grid run too (two_way_stack.cuh),
// and K1-dma with its rows moved by bulk copies (two_way_layer_dma.cu).
//
// What held the shared pass back on the H100 (measured by launch, PERF.md):
// one CTA of 4 warps per 64-row tile staged the whole out-projection weight
// (256 x 128, 64 KiB in bf16) into shared memory for every tile, with
// nothing overlapping it, its per-(row, head) softmax read the tokens' keys
// and values with 4-way bank conflicts, and its epilogue read the rows and
// wrote the new rows 4 bytes a thread, 8 rows an instruction. Here:
//
//  - a persistent grid, one CTA an SM, walks work items of two consecutive
//    64-row tiles of a candidate, one per consumer warpgroup. The weight
//    streams through a ring of shared-memory blocks of 256 outputs x kKB
//    inputs in wgmma's K-major core-matrix layout, handed over by full and
//    empty mbarriers, every block serving both tiles: in bf16 four blocks,
//    the whole weight, each moved by one TMA bulk copy out of the weight
//    laid out block by block (the wrapper's pack); in fp32 two producer
//    warps load each block a block ahead and split it once into its TF32
//    halves. A third producer warp copies each group's next q_img tile in
//    once the group's attention has read the last one, and in bf16 its
//    next rows tile once its new rows are out, so both loads run under the
//    products and the epilogue of the tile before;
//  - the producer warpgroup hands registers to the consumers (setmaxnreg:
//    bf16 40 and 232 a thread, fp32 128 and 184): the epilogue holds 128
//    accumulators and spilled at the launch's 168;
//  - thread (row, head) runs the shared body's softmax and product with the
//    values in its order (so bf16 keeps the bits); a warp's 32 threads take
//    32 rows of one head, so the tokens' keys and values are broadcast reads
//    and the query rows 16-byte reads of a padded tile; the attention output
//    goes to shared memory in the layout the product reads: bf16
//    core-matrix [64][128], fp32 [64][132];
//  - the out-projection is wgmma m64n256: bf16 with both operands in shared
//    memory, the same products in the same k order as the shared body's
//    mma.sync (its bits); fp32 in 3xTF32 with the attention output's
//    fragments split as they are loaded, the A operand from registers. Its
//    accumulators have mma.sync's layout, so the residual, LN4 and the
//    stores are the shared body's epilogue; in bf16 the residual comes from
//    the staged rows and the new rows go back through the same tile, then
//    out 16 bytes a thread, whole rows a warp (fp32, whose tiles would not
//    fit beside its split weight blocks, reads and writes device memory).
//
// Shared memory: the ring (bf16 4 x 16 KiB, fp32 2 x 32 KiB), per consumer
// warpgroup its q_img tile ([64][136] bf16, [64][132] fp32), in bf16 its
// rows tile ([64][264]; an int8 tile [64][272 B] under it), its attention
// output (bf16 16 KiB, fp32 33,792 B) and the candidate's token keys and
// values [8][128] fp32, and the bias and LN4 vectors: 220,288 B in bf16,
// 220,256 in fp32.
//
// K8b (kWide, 9 to 32 tokens): the tokens' keys and values [32][128] fp32,
// four times K1's, would not fit twice. Both warpgroups of an item take two
// tiles of one candidate, so the CTA holds one copy, loaded by both
// warpgroups between two barriers of theirs when the candidate changes
// (rows past the tokens zeroed). The attention output is written over its
// q_img tile (each (row, head) is read, then written, by one thread; bf16
// holds the tile in the core-matrix layout the product reads, [64][128]),
// so a tile's q_img is released once the out-projection has read its
// output, under the epilogue. In bf16 each logit is still summed over d in
// order, 4 tokens side by side (K1: one), so the bits are the shared
// body's; the unrolled loops over 32 tokens' logits and divisions spilled
// ~780 B in fp32 and ran at ~1.7x K1's time, so fp32 (whose bits no check
// holds) takes an online softmax over the tokens 4 at a time in a loop:
// no spill, 1.5-1.6x faster (PERF.md). The softmax's CUDA-core work grows with
// T: at 32 tokens it is 4x K1's at 8. kWide uses 201,856 B in bf16,
// 169,056 in fp32.
//
// What bounds it: per candidate 1 MiB of q_img and 2 MiB of bf16 rows read
// (0.5 MiB as int8) and 2 MiB of new rows written, 0.27 GFLOP of
// out-projection (3x in fp32's 3xTF32: operations there) and 8 x 4096 x 2 x
// 16 T MACs of the softmax on the CUDA cores.

#include "twl_i2t.cuh"

namespace {

using namespace cor;
using namespace cor::i2t_hopper;

template <typename T, bool kInt8, bool kWide>
__global__ void __launch_bounds__(kGroups * 128 + kProd, 1)
twl_i2t_kernel(const void* __restrict__ src, const int* __restrict__ idx,
               const float* __restrict__ scale, int S, int n, int N,
               const T* __restrict__ q_img, const T* __restrict__ k_i,
               const T* __restrict__ v_i, int nt, const T* __restrict__ wo,
               const T* __restrict__ wo_blocks, const float* __restrict__ bo_ln, float eps,
               float cross_scale, T* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  i2t_pass<T, kInt8, kWide>(smem, src, idx, scale, S, n, N, q_img, k_i, v_i, nt, wo, wo_blocks,
                            bo_ln, eps, cross_scale, out);
}

template <typename T, bool kInt8, bool kWide>
int launch(const void* src, const int* idx, const float* scale, int S, int n, int nt, int N,
           const void* q_img, const void* k_i, const void* v_i, const void* wo, const void* wob,
           const float* bo_ln, float eps, float cross_scale, void* out, cudaStream_t stream) {
  static int raised[wg::kMaxDevices] = {};
  auto kernel = twl_i2t_kernel<T, kInt8, kWide>;
  const int bytes = I2tSmem<T, kWide>::kBytes;
  cudaError_t err = wg::raise_shared_memory(reinterpret_cast<const void*>(kernel), bytes, raised);
  if (err != cudaSuccess) return err;
  const int items = n * ((N / kRows + kGroups - 1) / kGroups);
  const int sms = wg::sm_count();
  const int grid = items < sms ? items : sms;
  kernel<<<grid, kGroups * 128 + kProd, bytes, stream>>>(
      src, idx, scale, S, n, N, static_cast<const T*>(q_img), static_cast<const T*>(k_i),
      static_cast<const T*>(v_i), nt, static_cast<const T*>(wo), static_cast<const T*>(wob),
      bo_ln, eps, cross_scale,
      static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// K1's stage 4 and K8b: cor_twl_image_i2t's arguments (i2t_attention.cu)
// with n_tok 1 to 32 (above 8: K8b's kWide, which takes no int8 store), and
// wo_blocks: in bf16 wo laid out as the ring's blocks (4 of [256][32] in the
// core-matrix layout; the wrapper's pack), unread in fp32. The same output
// (in bf16 the same bits).
extern "C" int cor_twl_i2t(const void* src, int src_int8, const void* idx, const void* scale,
                           int S, int n, int n_tok, int N, const void* q_img, const void* k_i,
                           const void* v_i, const void* wo, const void* wo_blocks,
                           const void* bo_ln4, float eps, float cross_scale, void* keys_out,
                           int f32, void* stream) {
  if (n < 1 || n > 65535 || n_tok < 1 || n_tok > kMaxTok || N < kRows || N % kRows || S < 1 ||
      (src_int8 && (!scale || !idx || n_tok > kMaxT)) || (!f32 && !wo_blocks))
    return cudaErrorInvalidValue;
  const int* ip = static_cast<const int*>(idx);
  const float* sp = static_cast<const float*>(scale);
  const float* bl = static_cast<const float*>(bo_ln4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto fn) {
    return fn(src, ip, sp, S, n, n_tok, N, q_img, k_i, v_i, wo, wo_blocks, bl, eps, cross_scale,
              keys_out, s);
  };
  if (n_tok > kMaxT)
    return f32 ? go(launch<float, false, true>) : go(launch<uint16_t, false, true>);
  if (f32) return src_int8 ? go(launch<float, true, false>) : go(launch<float, false, false>);
  return src_int8 ? go(launch<uint16_t, true, false>) : go(launch<uint16_t, false, false>);
}
