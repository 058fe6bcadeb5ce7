// Token -> image cross-attention of the SAM two-way transformer, with the
// image-side projections computed from the rows inside:
//
//   k = bf16(rows @ Wk^T + bk + kpe),  v = bf16(rows @ Wv^T + bv)
//   out[t, head h] = softmax_rows(qt_h[t] . k_h) v_h      (qt pre-scaled, bf16)
//
// Replaces the TPU kernels cor_tpu/ops/pallas/t2i_flash.py:t2i_flash_kv (its
// pallas_call at line 220, the final attention), proj_q_t2i_flash (K8a, its
// pallas_call at line 163: the per-layer attention that also emits the i2t
// query q_img = rows @ Wq^T + bq + qpe, where cor_tpu's fused decode does not
// take its layer kernel) and, as stage 2 of the two-way layer, the t2i part
// of two_way_layer.py:two_way_layer_fused. On the
// TPU one grid step holds a candidate's whole 2 MiB of rows in VMEM and
// carries a running softmax across its sequential row tiles. On the H100 the
// tiles of a candidate run in parallel, so the work is two launches:
//
//  1. cor_t2i_image_pass: one CTA of 4 warps per (64-row tile, candidate).
//     The tile's rows are loaded once into shared memory (an int8 store row
//     is gathered through idx and dequantised on the way), then projected on
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

#include "decoder_common.cuh"

namespace {

using namespace cor;

constexpr int kThreads = 128;
constexpr int kLdL = kRows + 1;
// rows [kRows][kLdC], a 128 x 128 weight block [kI][kLdI], k and v [kRows][kLdI]
// in T, the queries [nt][kI] fp32, and the logits [8 nt][kLdL] fp32 where they
// do not fit in the weight block's space
template <typename T>
__host__ __device__ constexpr size_t weight_block_bytes() {
  return sizeof(T) * kI * Elem<T>::kLdI;
}
__host__ __device__ constexpr size_t logits_bytes(int nt) {
  return sizeof(float) * kHeads * nt * kLdL;
}
template <typename T>
size_t smem_image(int nt) {
  const size_t own = logits_bytes(nt) > weight_block_bytes<T>() ? logits_bytes(nt) : 0;
  return sizeof(T) * (kRows * Elem<T>::kLdC + 2 * kRows * Elem<T>::kLdI) +
         weight_block_bytes<T>() + sizeof(float) * nt * kI + own;
}

template <typename T, bool kInt8, bool kEmitQ>
__global__ void __launch_bounds__(kThreads)
t2i_image_kernel(const void* __restrict__ src, const int* __restrict__ idx,
                 const float* __restrict__ scale, int S, int N,
                 const T* __restrict__ w,    // [(2 or 3) * kI][kC]: k | v (| q)
                 const float* __restrict__ b,  // [(2 or 3) * kI]
                 const T* __restrict__ kpe,  // [N][kI]
                 const T* __restrict__ qpe,  // [N][kI] (kEmitQ)
                 const T* __restrict__ qt,   // [n][nt][kI], scaled (and rounded)
                 int nt,
                 T* __restrict__ q_img,      // [n][N][kI] (kEmitQ)
                 float* __restrict__ part_m, float* __restrict__ part_l,
                 float* __restrict__ part_acc) {
  using E = Elem<T>;
  constexpr int kLdR = E::kLdC, kLdW = E::kLdI, kLdKV = E::kLdI;
  constexpr int kVec = 16 / sizeof(T);  // values per 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem[];
  T* sRows = reinterpret_cast<T*>(smem);
  T* sW = sRows + kRows * kLdR;
  T* sK = sW + kI * kLdW;
  T* sV = sK + kRows * kLdKV;
  float* sQt = reinterpret_cast<float*>(sV + kRows * kLdKV);
  // the logits: the weight block's space, after the projections, or their own
  float* sL = logits_bytes(nt) > weight_block_bytes<T>() ? sQt + nt * kI
                                                          : reinterpret_cast<float*>(sW);
  const int nq = kHeads * nt;  // (head, token) query rows

  const int tile = blockIdx.x, tiles = gridDim.x, cand = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int r0 = tile * kRows;
  const int row = source_row(idx, cand, S);
  const float sc = kInt8 ? scale[row] : 1.f;

  load_rows<kInt8>(sRows, src, row, N, r0, sc, tid, kThreads);
  for (int i = tid; i < nt * kI; i += kThreads)
    sQt[i] = E::get(qt[static_cast<int64_t>(cand) * nt * kI + i]);

  constexpr int kChunks = kEmitQ ? 3 : 2;
  const int ra = warp * 16 + (lane >> 2), rb = ra + 8;
#pragma unroll 1
  for (int c = 0; c < kChunks; ++c) {
    float acc[kI / 8][4];
#pragma unroll
    for (int n = 0; n < kI / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll 1
    for (int kh = 0; kh < kC / kI; ++kh) {
      __syncthreads();  // rows loaded; the previous weight block consumed
      for (int i = tid; i < kI * (kI / kVec); i += kThreads) {
        const int o = i / (kI / kVec), cv = (i % (kI / kVec)) * kVec;
        *reinterpret_cast<uint4*>(sW + o * kLdW + cv) = *reinterpret_cast<const uint4*>(
            w + static_cast<int64_t>(c * kI + o) * kC + kh * kI + cv);
      }
      __syncthreads();
      warp_mma<kI / 8, kI>(acc, sRows + kh * kI, kLdR, sW, kLdW, warp * 16, lane);
    }
    // epilogue: + bias (+ the PE projection for k and q), rounded to T
    const T* pe = c == 0 ? kpe : qpe;
#pragma unroll
    for (int n = 0; n < kI / 8; ++n) {
      const int col = n * 8 + 2 * t;
      const float b0 = b[c * kI + col], b1 = b[c * kI + col + 1];
      float v0 = acc[n][0] + b0, v1 = acc[n][1] + b1, v2 = acc[n][2] + b0, v3 = acc[n][3] + b1;
      if (c != 1) {
        float pa0, pa1, pb0, pb1;
        E::get2(pe + static_cast<int64_t>(r0 + ra) * kI + col, pa0, pa1);
        E::get2(pe + static_cast<int64_t>(r0 + rb) * kI + col, pb0, pb1);
        v0 += pa0;
        v1 += pa1;
        v2 += pb0;
        v3 += pb1;
      }
      if (c == 0) {
        E::put2(sK + ra * kLdKV + col, v0, v1);
        E::put2(sK + rb * kLdKV + col, v2, v3);
      } else if (c == 1) {
        E::put2(sV + ra * kLdKV + col, v0, v1);
        E::put2(sV + rb * kLdKV + col, v2, v3);
      } else {
        T* q = q_img + (static_cast<int64_t>(cand) * N + r0) * kI + col;
        E::put2(q + static_cast<int64_t>(ra) * kI, v0, v1);
        E::put2(q + static_cast<int64_t>(rb) * kI, v2, v3);
      }
    }
  }
  __syncthreads();  // k and v complete; the weight block's space is free

  // logits of the 8 nt (head, token) queries against the tile's 64 rows
  for (int e = tid; e < nq * kRows; e += kThreads) {
    const int q = e / kRows, r = e % kRows, h = q / nt, tt = q % nt;
    const float* qv = sQt + tt * kI + h * kCrossD;
    const T* kv = sK + r * kLdKV + h * kCrossD;
    float l = 0.f;
#pragma unroll
    for (int d = 0; d < kCrossD; ++d) l += qv[d] * E::get(kv[d]);
    sL[q * kLdL + r] = l;
  }
  __syncthreads();
  const int64_t pbase = static_cast<int64_t>(cand) * tiles + tile;
  for (int q = warp; q < nq; q += kThreads / 32) {
    const float la = sL[q * kLdL + lane], lb = sL[q * kLdL + lane + 32];
    const float m = warp_max(fmaxf(la, lb));
    const float ea = expf(la - m), eb = expf(lb - m);
    const float l = warp_sum(ea + eb);
    sL[q * kLdL + lane] = E::round(ea);  // rounded before the product with v
    sL[q * kLdL + lane + 32] = E::round(eb);
    if (lane == 0) {
      part_m[pbase * nq + q] = m;
      part_l[pbase * nq + q] = l;
    }
  }
  __syncthreads();
  for (int o = tid; o < nq * kCrossD; o += kThreads) {
    const int q = o / kCrossD, d = o % kCrossD, h = q / nt;
    float acc = 0.f;
#pragma unroll 8
    for (int r = 0; r < kRows; ++r)
      acc += sL[q * kLdL + r] * E::get(sV[r * kLdKV + h * kCrossD + d]);
    part_acc[(pbase * nq + q) * kCrossD + d] = acc;
  }
}

// out[cand][t][h*16 + d] = T(sum_tiles acc * exp(m_tile - m) / sum_tiles l * exp(m_tile - m))
template <typename T>
__global__ void __launch_bounds__(256)
t2i_combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                   const float* __restrict__ part_acc, int tiles, int nt, T* __restrict__ out) {
  const int cand = blockIdx.x, nq = kHeads * nt;
  for (int o = threadIdx.x; o < nq * kCrossD; o += blockDim.x) {
    const int q = o / kCrossD, d = o % kCrossD, h = q / nt, tt = q % nt;
    const float v = combine_partials(part_m, part_l, part_acc,
                                     static_cast<int64_t>(cand) * tiles, tiles, nq, q, d);
    out[(static_cast<int64_t>(cand) * nt + tt) * kI + h * kCrossD + d] = Elem<T>::put(v);
  }
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
  kernel<<<dim3(N / kRows, n), kThreads, smem, stream>>>(
      src, idx, scale, S, N, static_cast<const T*>(w), b, static_cast<const T*>(kpe),
      static_cast<const T*>(qpe), static_cast<const T*>(qt), nt, static_cast<T*>(q_img), pm, pl,
      pa);
  return cudaGetLastError();
}

template <typename T>
int image_pass(const void* src, int src_int8, const int* ip, const float* sp, int S, int n,
               int nt, int N, const void* w, const float* bp, const void* kpe, const void* qpe,
               const void* qt, void* q_img, float* pm, float* pl, float* pa, cudaStream_t s) {
  auto go = [&](auto launch) {
    return launch(src, ip, sp, S, n, nt, N, w, bp, kpe, qpe, qt, q_img, pm, pl, pa, s);
  };
  if (src_int8)
    return qpe ? go(launch_image<T, true, true>) : go(launch_image<T, true, false>);
  return qpe ? go(launch_image<T, false, true>) : go(launch_image<T, false, false>);
}

}  // namespace

// The image pass. Compute dtype T: bf16 (f32 = 0) or fp32 (f32 = 1). src: T
// rows [S][N][256], or an int8 store with fp32 scale [S]; idx: int32 [n]
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
      (src_int8 && !scale) ||
      (src_int8 && !idx) || (qpe != nullptr) != (q_img != nullptr))
    return cudaErrorInvalidValue;
  const int* ip = static_cast<const int*>(idx);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(b);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? image_pass<float>(src, src_int8, ip, sp, S, n, n_tok, N, w, bp, kpe, qpe, qt,
                                 q_img, pm, pl, pa, s)
             : image_pass<uint16_t>(src, src_int8, ip, sp, S, n, n_tok, N, w, bp, kpe, qpe, qt,
                                    q_img, pm, pl, pa, s);
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
