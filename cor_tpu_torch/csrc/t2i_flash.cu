// Token -> image cross-attention of the SAM two-way transformer, with the
// image-side projections computed from the rows inside:
//
//   k = bf16(rows @ Wk^T + bk + kpe),  v = bf16(rows @ Wv^T + bv)
//   out[t, head h] = softmax_rows(qt_h[t] . k_h) v_h      (qt pre-scaled, bf16)
//
// The first port of the TPU kernel cor_tpu/ops/pallas/t2i_flash.py:
// proj_q_t2i_flash (K8a, its pallas_call at line 163: the per-layer attention
// that also emits the i2t query q_img = rows @ Wq^T + bq + qpe, where
// cor_tpu's fused decode does not take its layer kernel); no wrapper calls
// these entries now (K1, K1-dma, K1-stack and K1-grid run twl_t2i.cuh's
// pass): tools/kernel_bits.py serves an older library's K2 and K8a by them.
// K2, the final attention (t2i_flash.py:t2i_flash_kv, its pallas_call at line
// 220), K1 and K8a ran it too until each was redesigned for Hopper
// (t2i_final.cu, twl_t2i.cu, t2i_proj_q.cu): no wrapper calls these two
// entries now; they stay as the reference the redesigns keep the bits of
// (tools/kernel_bits.py serves an older library's K2 and K8a by them). On the
// TPU one grid step holds a candidate's whole 2 MiB of rows in VMEM and
// carries a running softmax across its sequential row tiles. On the H100 the
// tiles of a candidate run in parallel, so the work is two launches:
//
//  1. cor_t2i_image_pass: one CTA of 4 warps per (64-row tile, candidate).
//     The tile's rows are loaded once into shared memory (a store row
//     through idx; an int8 store is K1's alone, whose own pass, twl_t2i.cu,
//     dequantises it), then projected on
//     the tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate) against
//     the packed [k | v | q] weight, staged in 128 x 128 shared-memory
//     blocks. k and v stay in shared memory; the i2t query q_img (+ its PE)
//     of the two-way layer is the only image-side tensor written out. The
//     tile then computes, for each of the 8 T (head, token) queries, its
//     flash partials: the max m of its 64 logits, the sum l of exp(logit -
//     m) in fp32, and sum_rows bf16(exp(logit - m)) * v (16 values).
//  2. the combine, one CTA per candidate (cor_t2i_combine here for the final
//     attention and K8a; inside the two-way layer's second token kernel
//     there):
//     rescales every tile's partials by exp(m_tile - m) and divides by the
//     total sum once, in fp32.
//
// What bounds it on the H100: per candidate the image pass reads 2 MiB of
// bf16 rows (0.5 MiB as int8) and does 2 * 4096 * 256 * 384 = 0.8 GFLOP of
// projections (0.54 GFLOP without q), next to the ~295 flop/byte ridge, so
// both count; the logits and the exponentials (8 T x 64 x 16 MACs each per
// tile, CUDA cores) are small at T = 6 and a third of the projections' MACs
// at T = 32. The partials (64 tiles x 8 T x 18 floats, 0.2 MiB per candidate
// at T = 6, 1.2 MiB at T = 32) are the price of running the tiles in
// parallel. wgmma, TMA, the query rows on the tensor cores and a fused
// combine are later work.
//
// The token count T (1 to kMaxTok) is a run-time argument: the queries
// [T][128] fp32 and the logits [8 T][65] fp32 are sized at launch. The
// logits reuse the weight block's space once the projections are done where
// they fit in it (bf16 up to T = 16, 34,816 B; fp32 to 32, 67,584 B), and
// take their own space above that (bf16 at T = 32: 186,368 B in all).
//
// fp32 (compute_dtype float32): every kernel is templated on its element
// type (decoder_common.cuh's Elem<T>). The projections run in 3xTF32 on
// mma.sync m16n8k8 (mma_tf32x3.cuh), nothing is rounded (the scaled
// queries, k, v and the exponentials stay fp32), the int8 store
// dequantises to fp32, q_img and the combine's output are fp32. The image
// pass then stages 204,800 bytes of shared memory (rows [64][260], the
// weight block [128][132], k and v [64][132], fp32; within the 232,448 a
// block may take, so no tile is halved): one block per SM.

#include "t2i_flash.cuh"

namespace {

using namespace cor;

template <typename T, bool kInt8, bool kEmitQ>
__global__ void __launch_bounds__(kImgThreads)
t2i_image_kernel(const void* __restrict__ src, const int* __restrict__ idx,
                 const float* __restrict__ scale, int S, int N, const T* __restrict__ w,
                 const float* __restrict__ b, const T* __restrict__ kpe,
                 const T* __restrict__ qpe, const T* __restrict__ qt, int nt,
                 T* __restrict__ q_img, float* __restrict__ part_m, float* __restrict__ part_l,
                 float* __restrict__ part_acc) {
  extern __shared__ __align__(16) unsigned char smem[];
  t2i_tile<T, kInt8, kEmitQ>(smem, src, idx, scale, S, N, w, b, kpe, qpe, qt, nt, q_img, part_m,
                             part_l, part_acc, blockIdx.x, gridDim.x, blockIdx.y);
}

template <typename T>
__global__ void __launch_bounds__(256)
t2i_combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                   const float* __restrict__ part_acc, int tiles, int nt, T* __restrict__ out) {
  t2i_combine_body<T>(part_m, part_l, part_acc, tiles, nt, out, blockIdx.x);
}

template <typename T, bool kInt8, bool kEmitQ>
int launch_image(const void* src, const int* idx, const float* scale, int S, int n, int nt,
                 int N, const void* w, const float* b, const void* kpe, const void* qpe,
                 const void* qt, void* q_img, float* pm, float* pl, float* pa,
                 cudaStream_t stream) {
  auto kernel = t2i_image_kernel<T, kInt8, kEmitQ>;
  const size_t smem = smem_image<T>(nt);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(N / kRows, n), kImgThreads, smem, stream>>>(
      src, idx, scale, S, N, static_cast<const T*>(w), b, static_cast<const T*>(kpe),
      static_cast<const T*>(qpe), static_cast<const T*>(qt), nt, static_cast<T*>(q_img), pm, pl,
      pa);
  return cudaGetLastError();
}

template <typename T>
int image_pass(const void* src, const int* ip, const float* sp, int S, int n, int nt, int N,
               const void* w, const float* bp, const void* kpe, const void* qpe, const void* qt,
               void* q_img, float* pm, float* pl, float* pa, cudaStream_t s) {
  auto go = [&](auto launch) {
    return launch(src, ip, sp, S, n, nt, N, w, bp, kpe, qpe, qt, q_img, pm, pl, pa, s);
  };
  return qpe ? go(launch_image<T, false, true>) : go(launch_image<T, false, false>);
}

}  // namespace

// The image pass. Compute dtype T: bf16 (f32 = 0) or fp32 (f32 = 1). src: T
// rows [S][N][256] (src_int8 must be 0: K1's int8 store takes cor_twl_t2i);
// idx: int32 [n]
// store rows, or null (candidate b reads src[b]); n_tok: the tokens T, 1 to
// 32; w: T [2 or 3][128][256] (k | v | q projections, [out, in]); b: fp32 [2
// or 3][128]; kpe, qpe: T [N][128]; qt: T [n][n_tok][128], scaled; q_img: T
// [n][N][128], written when qpe is given; partials: fp32 [n][N/64][8 n_tok]
// (m, l) and [n][N/64][8 n_tok][16] (acc).
extern "C" int cor_t2i_image_pass(const void* src, int src_int8, const void* idx,
                                  const void* scale, int S, int n, int n_tok, int N,
                                  const void* w, const void* b, const void* kpe, const void* qpe,
                                  const void* qt, void* q_img, void* part_m, void* part_l,
                                  void* part_acc, int f32, void* stream) {
  if (n < 1 || n > 65535 || n_tok < 1 || n_tok > kMaxTok || N < kRows || N % kRows || S < 1 ||
      src_int8 || (qpe != nullptr) != (q_img != nullptr))
    return cudaErrorInvalidValue;
  const int* ip = static_cast<const int*>(idx);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(b);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? image_pass<float>(src, ip, sp, S, n, n_tok, N, w, bp, kpe, qpe, qt, q_img, pm,
                                 pl, pa, s)
             : image_pass<uint16_t>(src, ip, sp, S, n, n_tok, N, w, bp, kpe, qpe, qt, q_img, pm,
                                    pl, pa, s);
}

// The combine of the final attention and of K8a: out T [n][n_tok][128] (f32
// as above).
extern "C" int cor_t2i_combine(const void* part_m, const void* part_l, const void* part_acc,
                               int tiles, int n, int n_tok, void* out, int f32, void* stream) {
  if (n < 1 || n > 65535 || tiles < 1 || n_tok < 1 || n_tok > kMaxTok)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pm = static_cast<const float*>(part_m);
  const float* pl = static_cast<const float*>(part_l);
  const float* pa = static_cast<const float*>(part_acc);
  if (f32)
    t2i_combine_kernel<float><<<n, 256, 0, s>>>(pm, pl, pa, tiles, n_tok,
                                                static_cast<float*>(out));
  else
    t2i_combine_kernel<uint16_t><<<n, 256, 0, s>>>(pm, pl, pa, tiles, n_tok,
                                                   static_cast<uint16_t*>(out));
  return cudaGetLastError();
}
