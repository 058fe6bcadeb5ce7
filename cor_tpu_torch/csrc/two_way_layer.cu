// One TwoWayAttentionBlock of the SAM mask decoder over n candidates:
// tokens [n, 6, 256] and image rows [n, N, 256] (or an int8 candidate store
// gathered through idx).
//
// Replaces the TPU kernel cor_tpu/ops/pallas/two_way_layer.py:
// two_way_layer_fused (its pallas_calls at lines 978, 998 and 1012). The TPU
// kernel runs the whole layer for 4 candidates in one grid step, because
// VMEM holds their 8 MiB of rows. On the H100 two steps of the layer need
// every row of a candidate before they can go on: the token -> image softmax
// runs over all N rows before the token MLP, and every row's image -> token
// attention needs the tokens after the MLP. So the layer is four launches,
// each hand-written:
//
//  1. cor_twl_tokens_in (here), one CTA of 8 warps per candidate: token
//     self-attention (8 heads of 32; no PE and no residual on the first
//     layer), LN1, and the t2i query, scaled after its bias and rounded;
//  2. cor_t2i_image_pass (t2i_flash.cu), one CTA per (64-row tile,
//     candidate): the rows (int8 dequantised inside), their packed [k|v|q]
//     projection on the tensor cores, q_img written out, and the t2i flash
//     partials of the tile;
//  3. cor_twl_tokens_mid (here), one CTA per candidate: the partials'
//     combine, the t2i out-projection, LN2, the ReLU MLP (256 -> 2048 ->
//     256), LN3, and the i2t keys and values of the 6 tokens;
//  4. cor_twl_image_i2t (here), one CTA per (64-row tile, candidate): the
//     i2t softmax over the 6 tokens of each head (exact per-head max), its
//     product with the values, the out-projection [128 -> 256] on the
//     tensor cores, the residual with the (re-read, dequantised) rows, LN4,
//     and the new rows in bf16.
//
// The token kernels are small (6 tokens x ~1.4 M MACs per layer and
// candidate): each warp computes 4 whole output columns at a time (2 for the
// MLP's 2048-wide input), its lanes walking the weight rows [out, in] with
// 16-byte loads all issued up front, and reducing with shuffles; the
// token state stays fp32 in shared memory between the steps, and every
// product operand is rounded to bf16 first, as in the TPU kernel.
//
// What bounds the layer on the H100: the image passes. Per candidate they
// read the rows twice (2 x 2 MiB in bf16, 2 x 0.5 MiB as int8), write and
// read q_img (2 x 1 MiB), write the new rows (2 MiB), and do about 1.1 GFLOP
// on the tensor cores, at the ~295 flop/byte ridge of the card: bytes and
// operations both count. Keeping q_img and the rows on chip between the two
// passes, wgmma and TMA are later work.
//
// fp32 (compute_dtype float32): the four kernels are templated on the
// element type T (decoder_common.cuh's Elem<T>); the weights, tokens,
// q_img, k/v of the tokens and the new rows are fp32, nothing is rounded
// (cor_tpu rounds each product operand to the compute dtype: in fp32 that
// is nothing), the int8 store dequantises to fp32, and the i2t
// out-projection runs in 3xTF32 (mma_tf32x3.cuh). The token kernels stay
// on the CUDA cores (fp32 FMAs), their weight rows read with 16-byte loads
// of 4 values; the i2t pass stages 175,104 bytes of shared memory in fp32
// (its out-projection weight [256][132], the attention output [64][132]).

#include "decoder_common.cuh"

namespace {

using namespace cor;

constexpr int kMlp = 2048;
constexpr int kSelfD = kC / kHeads;  // 32

// bf16 weights, [out, in] each, concatenated in this order
constexpr int64_t kWqS = 0;
constexpr int64_t kWkS = kWqS + kC * kC;
constexpr int64_t kWvS = kWkS + kC * kC;
constexpr int64_t kWoS = kWvS + kC * kC;
constexpr int64_t kWqT = kWoS + kC * kC;
constexpr int64_t kWoT = kWqT + kI * kC;
constexpr int64_t kW1 = kWoT + kC * kI;
constexpr int64_t kW2 = kW1 + kMlp * kC;
constexpr int64_t kWkI = kW2 + kC * kMlp;
constexpr int64_t kWvI = kWkI + kI * kC;
// fp32 biases and LayerNorm parameters, concatenated in this order
constexpr int kBqS = 0, kBkS = kBqS + kC, kBvS = kBkS + kC, kBoS = kBvS + kC;
constexpr int kLn1S = kBoS + kC, kLn1B = kLn1S + kC;
constexpr int kBqT = kLn1B + kC, kBoT = kBqT + kI;
constexpr int kLn2S = kBoT + kC, kLn2B = kLn2S + kC;
constexpr int kB1 = kLn2B + kC, kB2 = kB1 + kMlp;
constexpr int kLn3S = kB2 + kC, kLn3B = kLn3S + kC;
constexpr int kBkI = kLn3B + kC, kBvI = kBkI + kI;

constexpr int kTokThreads = 256;
constexpr int kTokWarps = kTokThreads / 32;

enum Epi { kPlain = 0, kRound = 1, kReluRound = 2 };

// out[t][j] = epi((sum_k in[t][k] * W[j][k] + bias[j]) * mul) for j < O:
// in is [kTok][K] fp32 in shared memory (values already rounded to T), W is
// [O][K] of T in global memory. A warp takes kCols output columns at a
// time, its lanes splitting K in 8-element pieces: the weight loads of all
// kCols columns are issued before the first product (one at a time they
// would wait on L2 in turn), and each input value read from shared memory
// serves all kCols columns.
template <typename T, int K, int E>
__device__ void tok_linear(const float* in, const T* __restrict__ W,
                           const float* __restrict__ bias, int O, float* out, int ldo, float mul,
                           int warp, int lane) {
  constexpr int kChunks = (K + 255) / 256;  // 8-element pieces per lane
  constexpr int kWords = sizeof(T) / 2;     // 16-byte loads per piece: 1 (bf16), 2 (fp32)
  constexpr int kCols = kChunks >= 8 ? 2 / kWords : 4;
  for (int j0 = warp * kCols; j0 < O; j0 += kTokWarps * kCols) {
    uint4 wv[kCols][kChunks][kWords];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch) {
        const int k = ch * 256 + lane * 8;
#pragma unroll
        for (int wd = 0; wd < kWords; ++wd)
          wv[c][ch][wd] = (k < K && j0 + c < O)
                              ? __ldg(reinterpret_cast<const uint4*>(
                                          W + static_cast<int64_t>(j0 + c) * K + k) + wd)
                              : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    float acc[kCols][kTok];
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int tt = 0; tt < kTok; ++tt) acc[c][tt] = 0.f;
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      const int k = ch * 256 + lane * 8;
      if (k < K) {
        float w[kCols][8];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          if constexpr (kWords == 1) {
            const uint32_t ww[4] = {wv[c][ch][0].x, wv[c][ch][0].y, wv[c][ch][0].z,
                                    wv[c][ch][0].w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              w[c][2 * i] = bf2f(static_cast<uint16_t>(ww[i] & 0xffffu));
              w[c][2 * i + 1] = bf2f(static_cast<uint16_t>(ww[i] >> 16));
            }
          } else {
#pragma unroll
            for (int wd = 0; wd < kWords; ++wd) {
              w[c][4 * wd] = __uint_as_float(wv[c][ch][wd].x);
              w[c][4 * wd + 1] = __uint_as_float(wv[c][ch][wd].y);
              w[c][4 * wd + 2] = __uint_as_float(wv[c][ch][wd].z);
              w[c][4 * wd + 3] = __uint_as_float(wv[c][ch][wd].w);
            }
          }
        }
#pragma unroll
        for (int tt = 0; tt < kTok; ++tt) {
          const float4 x0 = *reinterpret_cast<const float4*>(in + tt * K + k);
          const float4 x1 = *reinterpret_cast<const float4*>(in + tt * K + k + 4);
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            acc[c][tt] += x0.x * w[c][0] + x0.y * w[c][1] + x0.z * w[c][2] + x0.w * w[c][3] +
                          x1.x * w[c][4] + x1.y * w[c][5] + x1.z * w[c][6] + x1.w * w[c][7];
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int tt = 0; tt < kTok; ++tt) acc[c][tt] = warp_sum(acc[c][tt]);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int j = j0 + c;
        if (j < O) {
#pragma unroll
          for (int tt = 0; tt < kTok; ++tt) {
            float v = (acc[c][tt] + bias[j]) * mul;
            if (E == kReluRound) v = fmaxf(v, 0.f);
            out[tt * ldo + j] = E == kPlain ? v : Elem<T>::round(v);
          }
        }
      }
    }
  }
}

// LayerNorm over the kC channels of each of the kTok rows of x, in place:
// one warp per token, fp32 mean and biased variance.
__device__ void tok_layer_norm(float* x, const float* __restrict__ s, const float* __restrict__ b,
                               float eps, int warp, int lane) {
  if (warp >= kTok) return;
  float v[8];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    v[i] = x[warp * kC + lane * 8 + i];
    sum += v[i];
  }
  const float mean = warp_sum(sum) / kC;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) sq += (v[i] - mean) * (v[i] - mean);
  const float rstd = rsqrtf(warp_sum(sq) / kC + eps);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = lane * 8 + i;
    x[warp * kC + c] = (v[i] - mean) * rstd * s[c] + b[c];
  }
}

// Stage 1 and the t2i query.
template <typename T>
__global__ void __launch_bounds__(kTokThreads)
twl_tokens_in_kernel(const T* __restrict__ tokens, const T* __restrict__ qpe,
                     const T* __restrict__ wt, const float* __restrict__ bt, int skip_pe,
                     float self_scale, float cross_scale, float eps, float* __restrict__ x_out,
                     T* __restrict__ qt_out) {
  using E = Elem<T>;
  __shared__ __align__(16) float sX[kTok * kC];
  __shared__ __align__(16) float sPe[kTok * kC];
  __shared__ __align__(16) float sIn[kTok * kC];
  __shared__ __align__(16) float sIn2[kTok * kC];
  __shared__ __align__(16) float sQ[kTok * kC];
  __shared__ __align__(16) float sK[kTok * kC];
  __shared__ __align__(16) float sV[kTok * kC];
  __shared__ float sL[kHeads * kTok * kTok];  // logits, then probabilities

  const int cand = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t tbase = static_cast<int64_t>(cand) * kTok * kC;
  for (int i = tid; i < kTok * kC; i += kTokThreads) {
    const float x = E::get(tokens[tbase + i]), p = E::get(qpe[tbase + i]);
    sX[i] = x;
    sPe[i] = p;
    sIn[i] = E::round(skip_pe ? x : x + p);
    sIn2[i] = E::round(x);
  }
  __syncthreads();
  tok_linear<T, kC, kRound>(sIn, wt + kWqS, bt + kBqS, kC, sQ, kC, self_scale, warp, lane);
  tok_linear<T, kC, kRound>(sIn, wt + kWkS, bt + kBkS, kC, sK, kC, 1.f, warp, lane);
  tok_linear<T, kC, kRound>(sIn2, wt + kWvS, bt + kBvS, kC, sV, kC, 1.f, warp, lane);
  __syncthreads();
  for (int e = tid; e < kHeads * kTok * kTok; e += kTokThreads) {
    const int h = e / (kTok * kTok), qi = (e / kTok) % kTok, kj = e % kTok;
    float l = 0.f;
#pragma unroll 8
    for (int d = 0; d < kSelfD; ++d) l += sQ[qi * kC + h * kSelfD + d] * sK[kj * kC + h * kSelfD + d];
    sL[e] = l;
  }
  __syncthreads();
  if (tid < kHeads * kTok) {  // softmax of row (h, qi) over the kTok keys
    float* l = sL + tid * kTok;
    float m = l[0];
    for (int j = 1; j < kTok; ++j) m = fmaxf(m, l[j]);
    float e[kTok], s = 0.f;
#pragma unroll
    for (int j = 0; j < kTok; ++j) {
      e[j] = expf(l[j] - m);
      s += e[j];
    }
#pragma unroll
    for (int j = 0; j < kTok; ++j) l[j] = E::round(e[j] / s);
  }
  __syncthreads();
  for (int o = tid; o < kTok * kC; o += kTokThreads) {  // P V, heads merged
    const int tt = o / kC, c = o % kC, h = c / kSelfD;
    const float* p = sL + (h * kTok + tt) * kTok;
    float av = 0.f;
#pragma unroll
    for (int j = 0; j < kTok; ++j) av += p[j] * sV[j * kC + c];
    sIn[o] = E::round(av);
  }
  __syncthreads();
  tok_linear<T, kC, kPlain>(sIn, wt + kWoS, bt + kBoS, kC, sQ, kC, 1.f, warp, lane);
  __syncthreads();
  for (int i = tid; i < kTok * kC; i += kTokThreads) sX[i] = skip_pe ? sQ[i] : sX[i] + sQ[i];
  __syncthreads();
  tok_layer_norm(sX, bt + kLn1S, bt + kLn1B, eps, warp, lane);
  __syncthreads();
  for (int i = tid; i < kTok * kC; i += kTokThreads) {
    x_out[tbase + i] = sX[i];
    sIn[i] = E::round(sX[i] + sPe[i]);
  }
  __syncthreads();
  tok_linear<T, kC, kRound>(sIn, wt + kWqT, bt + kBqT, kI, sK, kI, cross_scale, warp, lane);
  __syncthreads();
  for (int i = tid; i < kTok * kI; i += kTokThreads)
    qt_out[static_cast<int64_t>(cand) * kTok * kI + i] = E::put(sK[i]);
}

// The rest of stage 2, stage 3 and the i2t keys and values.
constexpr size_t kSmemMid = sizeof(float) * (4 * kTok * kC + kTok * kMlp);

template <typename T>
__global__ void __launch_bounds__(kTokThreads)
twl_tokens_mid_kernel(const float* __restrict__ x_in, const T* __restrict__ qpe,
                      const float* __restrict__ part_m, const float* __restrict__ part_l,
                      const float* __restrict__ part_acc, int tiles,
                      const T* __restrict__ wt, const float* __restrict__ bt, float eps,
                      T* __restrict__ tokens_out, T* __restrict__ k_out,
                      T* __restrict__ v_out) {
  using E = Elem<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sX = reinterpret_cast<float*>(smem);
  float* sPe = sX + kTok * kC;
  float* sIn = sPe + kTok * kC;
  float* sTmp = sIn + kTok * kC;
  float* sH = sTmp + kTok * kC;  // [kTok][kMlp]

  const int cand = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t tbase = static_cast<int64_t>(cand) * kTok * kC;
  for (int i = tid; i < kTok * kC; i += kTokThreads) {
    sX[i] = x_in[tbase + i];
    sPe[i] = E::get(qpe[tbase + i]);
  }
  // combine the image pass's per-tile flash partials -> t2i output [kTok][kI]
  const int64_t pbase = static_cast<int64_t>(cand) * tiles;
  for (int o = tid; o < kQ * kCrossD; o += kTokThreads) {
    const int q = o / kCrossD, d = o % kCrossD, h = q / kTok, tt = q % kTok;
    sIn[tt * kI + h * kCrossD + d] =
        E::round(combine_partials(part_m, part_l, part_acc, pbase, tiles, q, d));
  }
  __syncthreads();
  tok_linear<T, kI, kPlain>(sIn, wt + kWoT, bt + kBoT, kC, sTmp, kC, 1.f, warp, lane);
  __syncthreads();
  for (int i = tid; i < kTok * kC; i += kTokThreads) sX[i] += sTmp[i];
  __syncthreads();
  tok_layer_norm(sX, bt + kLn2S, bt + kLn2B, eps, warp, lane);
  __syncthreads();
  for (int i = tid; i < kTok * kC; i += kTokThreads) sIn[i] = E::round(sX[i]);
  __syncthreads();
  tok_linear<T, kC, kReluRound>(sIn, wt + kW1, bt + kB1, kMlp, sH, kMlp, 1.f, warp, lane);
  __syncthreads();
  tok_linear<T, kMlp, kPlain>(sH, wt + kW2, bt + kB2, kC, sTmp, kC, 1.f, warp, lane);
  __syncthreads();
  for (int i = tid; i < kTok * kC; i += kTokThreads) sX[i] += sTmp[i];
  __syncthreads();
  tok_layer_norm(sX, bt + kLn3S, bt + kLn3B, eps, warp, lane);
  __syncthreads();
  for (int i = tid; i < kTok * kC; i += kTokThreads) {
    sIn[i] = E::round(sX[i] + sPe[i]);
    sTmp[i] = E::round(sX[i]);
    tokens_out[tbase + i] = E::put(sX[i]);
  }
  __syncthreads();
  tok_linear<T, kC, kRound>(sIn, wt + kWkI, bt + kBkI, kI, sH, kI, 1.f, warp, lane);
  tok_linear<T, kC, kRound>(sTmp, wt + kWvI, bt + kBvI, kI, sH + kTok * kI, kI, 1.f, warp, lane);
  __syncthreads();
  for (int i = tid; i < kTok * kI; i += kTokThreads) {
    k_out[static_cast<int64_t>(cand) * kTok * kI + i] = E::put(sH[i]);
    v_out[static_cast<int64_t>(cand) * kTok * kI + i] = E::put(sH[kTok * kI + i]);
  }
}

// Stage 4.
constexpr int kImgThreads = 128;
// the out-projection weight [kC][kLdI] and the attention output [kRows][kLdI]
// in T, the tokens' keys and values [kTok][kI] fp32
template <typename T>
constexpr size_t smem_i2t() {
  return sizeof(T) * (kC * Elem<T>::kLdI + kRows * Elem<T>::kLdI) + sizeof(float) * 2 * kTok * kI;
}

template <typename T, bool kInt8>
__global__ void __launch_bounds__(kImgThreads)
twl_image_i2t_kernel(const void* __restrict__ src, const int* __restrict__ idx,
                     const float* __restrict__ scale, int S, int N,
                     const T* __restrict__ q_img,  // [n][N][kI]
                     const T* __restrict__ k_i, const T* __restrict__ v_i,  // [n][kTok][kI]
                     const T* __restrict__ wo,     // [kC][kI]
                     const float* __restrict__ bo_ln,  // bo [kC], ln4 scale [kC], bias [kC]
                     float eps, float cross_scale, T* __restrict__ out) {
  using E = Elem<T>;
  constexpr int kLd = E::kLdI;
  constexpr int kVec = 16 / sizeof(T);  // values per 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem[];
  T* sWo = reinterpret_cast<T*>(smem);
  T* sAV = sWo + kC * kLd;
  float* sKi = reinterpret_cast<float*>(sAV + kRows * kLd);
  float* sVi = sKi + kTok * kI;

  const int tile = blockIdx.x, cand = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = tile * kRows;
  const int row = source_row(idx, cand, S);
  const float sc = kInt8 ? scale[row] : 1.f;

  for (int i = tid; i < kC * (kI / kVec); i += kImgThreads) {
    const int o = i / (kI / kVec), cv = (i % (kI / kVec)) * kVec;
    *reinterpret_cast<uint4*>(sWo + o * kLd + cv) =
        *reinterpret_cast<const uint4*>(wo + static_cast<int64_t>(o) * kI + cv);
  }
  for (int i = tid; i < kTok * kI; i += kImgThreads) {
    sKi[i] = E::get(k_i[static_cast<int64_t>(cand) * kTok * kI + i]);
    sVi[i] = E::get(v_i[static_cast<int64_t>(cand) * kTok * kI + i]);
  }
  __syncthreads();

  // per (row, head): softmax over the kTok tokens, product with the values
  for (int it = tid; it < kRows * kHeads; it += kImgThreads) {
    const int r = it / kHeads, h = it % kHeads;
    const T* qp = q_img + (static_cast<int64_t>(cand) * N + r0 + r) * kI + h * kCrossD;
    float q[kCrossD];
#pragma unroll
    for (int i = 0; i < kCrossD; i += 2) {
      float a, b;
      E::get2(qp + i, a, b);
      q[i] = E::round(a * cross_scale);
      q[i + 1] = E::round(b * cross_scale);
    }
    float l[kTok], m = -INFINITY;
#pragma unroll
    for (int tt = 0; tt < kTok; ++tt) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < kCrossD; ++d) s += q[d] * sKi[tt * kI + h * kCrossD + d];
      l[tt] = s;
      m = fmaxf(m, s);
    }
    float sum = 0.f;
#pragma unroll
    for (int tt = 0; tt < kTok; ++tt) {
      l[tt] = expf(l[tt] - m);
      sum += l[tt];
    }
#pragma unroll
    for (int tt = 0; tt < kTok; ++tt) l[tt] = E::round(l[tt] / sum);
#pragma unroll
    for (int d = 0; d < kCrossD; d += 2) {
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int tt = 0; tt < kTok; ++tt) {
        a0 += l[tt] * sVi[tt * kI + h * kCrossD + d];
        a1 += l[tt] * sVi[tt * kI + h * kCrossD + d + 1];
      }
      E::put2(sAV + r * kLd + h * kCrossD + d, a0, a1);
    }
  }
  __syncthreads();

  // out-projection [kRows x kI] x [kI -> kC] on the tensor cores
  float acc[kC / 8][4];
#pragma unroll
  for (int n = 0; n < kC / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  warp_mma<kC / 8, kI>(acc, sAV, kLd, sWo, kLd, warp * 16, lane);

  // + bias + the rows, LayerNorm over kC; each row's channels are spread
  // over the 4 lanes of a quad
  const int ra = r0 + warp * 16 + g, rb = ra + 8;
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int n = 0; n < kC / 8; ++n) {
    const int col = n * 8 + 2 * t;
    float x0, x1, x2, x3;
    load_pair<kInt8, T>(src, row, N, ra, col, sc, x0, x1);
    load_pair<kInt8, T>(src, row, N, rb, col, sc, x2, x3);
    acc[n][0] += bo_ln[col] + x0;
    acc[n][1] += bo_ln[col + 1] + x1;
    acc[n][2] += bo_ln[col] + x2;
    acc[n][3] += bo_ln[col + 1] + x3;
    sa += acc[n][0] + acc[n][1];
    sb += acc[n][2] + acc[n][3];
  }
  const float ma = quad_sum(sa) / kC, mb = quad_sum(sb) / kC;
  float va = 0.f, vb = 0.f;
#pragma unroll
  for (int n = 0; n < kC / 8; ++n) {
    va += (acc[n][0] - ma) * (acc[n][0] - ma) + (acc[n][1] - ma) * (acc[n][1] - ma);
    vb += (acc[n][2] - mb) * (acc[n][2] - mb) + (acc[n][3] - mb) * (acc[n][3] - mb);
  }
  const float ia = rsqrtf(quad_sum(va) / kC + eps), ib = rsqrtf(quad_sum(vb) / kC + eps);
  const float* s4 = bo_ln + kC;
  const float* b4 = bo_ln + 2 * kC;
  T* oa = out + (static_cast<int64_t>(cand) * N + ra) * kC;
  T* ob = out + (static_cast<int64_t>(cand) * N + rb) * kC;
#pragma unroll
  for (int n = 0; n < kC / 8; ++n) {
    const int col = n * 8 + 2 * t;
    E::put2(oa + col, (acc[n][0] - ma) * ia * s4[col] + b4[col],
            (acc[n][1] - ma) * ia * s4[col + 1] + b4[col + 1]);
    E::put2(ob + col, (acc[n][2] - mb) * ib * s4[col] + b4[col],
            (acc[n][3] - mb) * ib * s4[col + 1] + b4[col + 1]);
  }
}

template <typename T, bool kInt8>
int launch_i2t(const void* src, const int* idx, const float* scale, int S, int n, int N,
               const void* q_img, const void* k_i, const void* v_i, const void* wo,
               const float* bo_ln, float eps, float cross_scale, void* out, cudaStream_t stream) {
  auto kernel = twl_image_i2t_kernel<T, kInt8>;
  constexpr size_t smem = smem_i2t<T>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(N / kRows, n), kImgThreads, smem, stream>>>(
      src, idx, scale, S, N, static_cast<const T*>(q_img), static_cast<const T*>(k_i),
      static_cast<const T*>(v_i), static_cast<const T*>(wo), bo_ln, eps, cross_scale,
      static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
int tokens_in(const void* tokens, const void* qpe, const void* wt, const void* bt, int skip_pe,
              float self_scale, float cross_scale, float eps, int n, void* x_out, void* qt_out,
              cudaStream_t stream) {
  twl_tokens_in_kernel<T><<<n, kTokThreads, 0, stream>>>(
      static_cast<const T*>(tokens), static_cast<const T*>(qpe), static_cast<const T*>(wt),
      static_cast<const float*>(bt), skip_pe, self_scale, cross_scale, eps,
      static_cast<float*>(x_out), static_cast<T*>(qt_out));
  return cudaGetLastError();
}

template <typename T>
int tokens_mid(const void* x_in, const void* qpe, const void* part_m, const void* part_l,
               const void* part_acc, int tiles, const void* wt, const void* bt, float eps, int n,
               void* tokens_out, void* k_out, void* v_out, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(twl_tokens_mid_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMid);
  if (err != cudaSuccess) return err;
  twl_tokens_mid_kernel<T><<<n, kTokThreads, kSmemMid, stream>>>(
      static_cast<const float*>(x_in), static_cast<const T*>(qpe),
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), tiles, static_cast<const T*>(wt),
      static_cast<const float*>(bt), eps, static_cast<T*>(tokens_out), static_cast<T*>(k_out),
      static_cast<T*>(v_out));
  return cudaGetLastError();
}

}  // namespace

// Compute dtype T: bf16 (f32 = 0) or fp32 (f32 = 1), in all four entries.
// tokens, qpe: T [n][6][256]; wt: the T weights, bt: the fp32 vectors
// (offsets above); x_out: fp32 [n][6][256]; qt_out: T [n][6][128].
extern "C" int cor_twl_tokens_in(const void* tokens, const void* qpe, const void* wt,
                                 const void* bt, int skip_pe, float self_scale,
                                 float cross_scale, float eps, int n, void* x_out, void* qt_out,
                                 int f32, void* stream) {
  if (n < 1 || n > 65535) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? tokens_in<float>(tokens, qpe, wt, bt, skip_pe, self_scale, cross_scale, eps, n,
                                x_out, qt_out, s)
             : tokens_in<uint16_t>(tokens, qpe, wt, bt, skip_pe, self_scale, cross_scale, eps, n,
                                   x_out, qt_out, s);
}

// x_in: fp32 [n][6][256] from cor_twl_tokens_in; partials of the image pass
// over `tiles` row tiles; tokens_out: T [n][6][256]; k_out, v_out: T
// [n][6][128].
extern "C" int cor_twl_tokens_mid(const void* x_in, const void* qpe, const void* part_m,
                                  const void* part_l, const void* part_acc, int tiles,
                                  const void* wt, const void* bt, float eps, int n,
                                  void* tokens_out, void* k_out, void* v_out, int f32,
                                  void* stream) {
  if (n < 1 || n > 65535 || tiles < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? tokens_mid<float>(x_in, qpe, part_m, part_l, part_acc, tiles, wt, bt, eps, n,
                                 tokens_out, k_out, v_out, s)
             : tokens_mid<uint16_t>(x_in, qpe, part_m, part_l, part_acc, tiles, wt, bt, eps, n,
                                    tokens_out, k_out, v_out, s);
}

// src/idx/scale/S as for cor_t2i_image_pass; q_img T [n][N][128]; k_i, v_i
// T [n][6][128]; wo T [256][128]; bo_ln4 fp32 [3][256]; keys_out T
// [n][N][256].
extern "C" int cor_twl_image_i2t(const void* src, int src_int8, const void* idx,
                                 const void* scale, int S, int n, int N, const void* q_img,
                                 const void* k_i, const void* v_i, const void* wo,
                                 const void* bo_ln4, float eps, float cross_scale,
                                 void* keys_out, int f32, void* stream) {
  if (n < 1 || n > 65535 || N < kRows || N % kRows || S < 1 ||
      (src_int8 && (!scale || !idx)))
    return cudaErrorInvalidValue;
  const int* ip = static_cast<const int*>(idx);
  const float* sp = static_cast<const float*>(scale);
  const float* bl = static_cast<const float*>(bo_ln4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32)
    return src_int8 ? launch_i2t<float, true>(src, ip, sp, S, n, N, q_img, k_i, v_i, wo, bl, eps,
                                              cross_scale, keys_out, s)
                    : launch_i2t<float, false>(src, ip, sp, S, n, N, q_img, k_i, v_i, wo, bl,
                                               eps, cross_scale, keys_out, s);
  return src_int8 ? launch_i2t<uint16_t, true>(src, ip, sp, S, n, N, q_img, k_i, v_i, wo, bl,
                                               eps, cross_scale, keys_out, s)
                  : launch_i2t<uint16_t, false>(src, ip, sp, S, n, N, q_img, k_i, v_i, wo, bl,
                                                eps, cross_scale, keys_out, s);
}
