// Token -> image cross-attention of the SAM two-way transformer, with the
// image-side projections computed from the rows inside:
//
//   k = bf16(rows @ Wk^T + bk + kpe),  v = bf16(rows @ Wv^T + bv)
//   out[t, head h] = softmax_rows(qt_h[t] . k_h) v_h      (qt pre-scaled, bf16)
//
// Replaces the TPU kernels cor_tpu/ops/pallas/t2i_flash.py:t2i_flash_kv (its
// pallas_call at line 220, the final attention) and, as stage 2 of the
// two-way layer, the t2i part of two_way_layer.py:two_way_layer_fused. On the
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
//     tile then computes, for each of the 48 (head, token) queries, its
//     flash partials: the max m of its 64 logits, the sum l of exp(logit -
//     m) in fp32, and sum_rows bf16(exp(logit - m)) * v (16 values).
//  2. the combine, one CTA per candidate (cor_t2i_combine here for the final
//     attention; inside the two-way layer's second token kernel there):
//     rescales every tile's partials by exp(m_tile - m) and divides by the
//     total sum once, in fp32.
//
// What bounds it on the H100: per candidate the image pass reads 2 MiB of
// bf16 rows (0.5 MiB as int8) and does 2 * 4096 * 256 * 384 = 0.8 GFLOP of
// projections (0.54 GFLOP without q), next to the ~295 flop/byte ridge, so
// both count; the logits and the exponentials are small (CUDA cores). The
// partials (64 tiles x 48 x 18 floats, 0.2 MiB per candidate) are the price
// of running the tiles in parallel. wgmma, TMA and a fused combine are later
// work.

#include "decoder_common.cuh"

namespace {

using namespace cor;

constexpr int kThreads = 128;
constexpr int kLdW = kI + 8;  // a 128 x 128 weight block, padded
constexpr int kLdL = kRows + 1;
constexpr size_t kSmemImage =
    sizeof(uint16_t) * (kRows * kLdC + kI * kLdW + 2 * kRows * kLdI) + sizeof(float) * kTok * kI;

template <bool kInt8, bool kEmitQ>
__global__ void __launch_bounds__(kThreads)
t2i_image_kernel(const void* __restrict__ src, const int* __restrict__ idx,
                 const float* __restrict__ scale, int S, int N,
                 const uint16_t* __restrict__ w,   // [(2 or 3) * kI][kC]: k | v (| q)
                 const float* __restrict__ b,      // [(2 or 3) * kI]
                 const uint16_t* __restrict__ kpe, // [N][kI]
                 const uint16_t* __restrict__ qpe, // [N][kI] (kEmitQ)
                 const uint16_t* __restrict__ qt,  // [n][kTok][kI], scaled and rounded
                 uint16_t* __restrict__ q_img,     // [n][N][kI] (kEmitQ)
                 float* __restrict__ part_m, float* __restrict__ part_l,
                 float* __restrict__ part_acc) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* sRows = reinterpret_cast<uint16_t*>(smem);
  uint16_t* sW = sRows + kRows * kLdC;
  uint16_t* sK = sW + kI * kLdW;
  uint16_t* sV = sK + kRows * kLdI;
  float* sQt = reinterpret_cast<float*>(sV + kRows * kLdI);
  float* sL = reinterpret_cast<float*>(sW);  // the weight block's space, after the projections

  const int tile = blockIdx.x, tiles = gridDim.x, cand = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = tile * kRows;
  const int row = source_row(idx, cand, S);
  const float sc = kInt8 ? scale[row] : 1.f;

  load_rows<kInt8>(sRows, src, row, N, r0, sc, tid, kThreads);
  for (int i = tid; i < kTok * kI; i += kThreads)
    sQt[i] = bf2f(qt[static_cast<int64_t>(cand) * kTok * kI + i]);

  constexpr int kChunks = kEmitQ ? 3 : 2;
  const int ra = warp * 16 + g, rb = ra + 8;
#pragma unroll 1
  for (int c = 0; c < kChunks; ++c) {
    float acc[kI / 8][4];
#pragma unroll
    for (int n = 0; n < kI / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll 1
    for (int kh = 0; kh < kC / kI; ++kh) {
      __syncthreads();  // rows loaded; the previous weight block consumed
      for (int i = tid; i < kI * (kI / 8); i += kThreads) {
        const int o = i / (kI / 8), c8 = (i % (kI / 8)) * 8;
        *reinterpret_cast<uint4*>(sW + o * kLdW + c8) = *reinterpret_cast<const uint4*>(
            w + static_cast<int64_t>(c * kI + o) * kC + kh * kI + c8);
      }
      __syncthreads();
      warp_mma<kI / 8, kI>(acc, sRows + kh * kI, kLdC, sW, kLdW, warp * 16, lane);
    }
    // epilogue: + bias (+ the PE projection for k and q), rounded to bf16
    const uint16_t* pe = c == 0 ? kpe : qpe;
#pragma unroll
    for (int n = 0; n < kI / 8; ++n) {
      const int col = n * 8 + 2 * t;
      const float b0 = b[c * kI + col], b1 = b[c * kI + col + 1];
      float v0 = acc[n][0] + b0, v1 = acc[n][1] + b1, v2 = acc[n][2] + b0, v3 = acc[n][3] + b1;
      if (c != 1) {
        const uint32_t pa = lds32(pe + static_cast<int64_t>(r0 + ra) * kI + col);
        const uint32_t pb = lds32(pe + static_cast<int64_t>(r0 + rb) * kI + col);
        v0 += bf2f(pa & 0xffffu);
        v1 += bf2f(pa >> 16);
        v2 += bf2f(pb & 0xffffu);
        v3 += bf2f(pb >> 16);
      }
      const uint32_t wa = pack_bf16x2(v0, v1), wb = pack_bf16x2(v2, v3);
      if (c == 0) {
        sts32(sK + ra * kLdI + col, wa);
        sts32(sK + rb * kLdI + col, wb);
      } else if (c == 1) {
        sts32(sV + ra * kLdI + col, wa);
        sts32(sV + rb * kLdI + col, wb);
      } else {
        uint16_t* q = q_img + (static_cast<int64_t>(cand) * N + r0) * kI + col;
        sts32(q + static_cast<int64_t>(ra) * kI, wa);
        sts32(q + static_cast<int64_t>(rb) * kI, wb);
      }
    }
  }
  __syncthreads();  // k and v complete; the weight block's space is free

  // logits of the 48 (head, token) queries against the tile's 64 rows
  for (int e = tid; e < kQ * kRows; e += kThreads) {
    const int q = e / kRows, r = e % kRows, h = q / kTok, tt = q % kTok;
    const float* qv = sQt + tt * kI + h * kCrossD;
    const uint16_t* kv = sK + r * kLdI + h * kCrossD;
    float l = 0.f;
#pragma unroll
    for (int d = 0; d < kCrossD; ++d) l += qv[d] * bf2f(kv[d]);
    sL[q * kLdL + r] = l;
  }
  __syncthreads();
  const int64_t pbase = static_cast<int64_t>(cand) * tiles + tile;
  for (int q = warp; q < kQ; q += kThreads / 32) {
    const float la = sL[q * kLdL + lane], lb = sL[q * kLdL + lane + 32];
    const float m = warp_max(fmaxf(la, lb));
    const float ea = expf(la - m), eb = expf(lb - m);
    const float l = warp_sum(ea + eb);
    sL[q * kLdL + lane] = round_bf16(ea);  // rounded before the product with v
    sL[q * kLdL + lane + 32] = round_bf16(eb);
    if (lane == 0) {
      part_m[pbase * kQ + q] = m;
      part_l[pbase * kQ + q] = l;
    }
  }
  __syncthreads();
  for (int o = tid; o < kQ * kCrossD; o += kThreads) {
    const int q = o / kCrossD, d = o % kCrossD, h = q / kTok;
    float acc = 0.f;
#pragma unroll 8
    for (int r = 0; r < kRows; ++r) acc += sL[q * kLdL + r] * bf2f(sV[r * kLdI + h * kCrossD + d]);
    part_acc[(pbase * kQ + q) * kCrossD + d] = acc;
  }
}

// out[cand][t][h*16 + d] = bf16(sum_tiles acc * exp(m_tile - m) / sum_tiles l * exp(m_tile - m))
__global__ void __launch_bounds__(256)
t2i_combine_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
                   const float* __restrict__ part_acc, int tiles, uint16_t* __restrict__ out) {
  const int cand = blockIdx.x;
  for (int o = threadIdx.x; o < kQ * kCrossD; o += blockDim.x) {
    const int q = o / kCrossD, d = o % kCrossD, h = q / kTok, tt = q % kTok;
    const float v = combine_partials(part_m, part_l, part_acc,
                                     static_cast<int64_t>(cand) * tiles, tiles, q, d);
    out[(static_cast<int64_t>(cand) * kTok + tt) * kI + h * kCrossD + d] = f2bf(v);
  }
}

template <bool kInt8, bool kEmitQ>
int launch_image(const void* src, const int* idx, const float* scale, int S, int n, int N,
                 const void* w, const float* b, const void* kpe, const void* qpe, const void* qt,
                 void* q_img, float* pm, float* pl, float* pa, cudaStream_t stream) {
  auto kernel = t2i_image_kernel<kInt8, kEmitQ>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemImage);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(N / kRows, n), kThreads, kSmemImage, stream>>>(
      src, idx, scale, S, N, static_cast<const uint16_t*>(w), b,
      static_cast<const uint16_t*>(kpe), static_cast<const uint16_t*>(qpe),
      static_cast<const uint16_t*>(qt), static_cast<uint16_t*>(q_img), pm, pl, pa);
  return cudaGetLastError();
}

}  // namespace

// The image pass. src: bf16 rows [S][N][256], or an int8 store with fp32
// scale [S]; idx: int32 [n] store rows, or null (candidate b reads src[b]);
// w: bf16 [2 or 3][128][256] (k | v | q projections, [out, in]); b: fp32
// [2 or 3][128]; kpe, qpe: bf16 [N][128]; qt: bf16 [n][6][128], scaled;
// q_img: bf16 [n][N][128], written when qpe is given; partials: fp32
// [n][N/64][48] (m, l) and [n][N/64][48][16] (acc).
extern "C" int cor_t2i_image_pass(const void* src, int src_int8, const void* idx,
                                  const void* scale, int S, int n, int N, const void* w,
                                  const void* b, const void* kpe, const void* qpe, const void* qt,
                                  void* q_img, void* part_m, void* part_l, void* part_acc,
                                  void* stream) {
  if (n < 1 || n > 65535 || N < kRows || N % kRows || S < 1 || (src_int8 && !scale) ||
      (src_int8 && !idx) || (qpe != nullptr) != (q_img != nullptr))
    return cudaErrorInvalidValue;
  const int* ip = static_cast<const int*>(idx);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(b);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (src_int8)
    return qpe ? launch_image<true, true>(src, ip, sp, S, n, N, w, bp, kpe, qpe, qt, q_img, pm, pl, pa, s)
               : launch_image<true, false>(src, ip, sp, S, n, N, w, bp, kpe, qpe, qt, q_img, pm, pl, pa, s);
  return qpe ? launch_image<false, true>(src, ip, sp, S, n, N, w, bp, kpe, qpe, qt, q_img, pm, pl, pa, s)
             : launch_image<false, false>(src, ip, sp, S, n, N, w, bp, kpe, qpe, qt, q_img, pm, pl, pa, s);
}

// The combine of the final attention: out bf16 [n][6][128].
extern "C" int cor_t2i_combine(const void* part_m, const void* part_l, const void* part_acc,
                               int tiles, int n, void* out, void* stream) {
  if (n < 1 || n > 65535 || tiles < 1) return cudaErrorInvalidValue;
  t2i_combine_kernel<<<n, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), tiles, static_cast<uint16_t*>(out));
  return cudaGetLastError();
}
