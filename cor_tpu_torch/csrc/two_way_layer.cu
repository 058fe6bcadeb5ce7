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
// in is [kTok][K] fp32 in shared memory (values already rounded to bf16),
// W is [O][K] bf16 in global memory. A warp takes kCols output columns at a
// time, its lanes splitting K in 8-element pieces: the weight loads of all
// kCols columns are issued before the first product (one at a time they
// would wait on L2 in turn), and each input value read from shared memory
// serves all kCols columns.
template <int K, int E>
__device__ void tok_linear(const float* in, const uint16_t* __restrict__ W,
                           const float* __restrict__ bias, int O, float* out, int ldo, float mul,
                           int warp, int lane) {
  constexpr int kChunks = (K + 255) / 256;  // 8-element pieces per lane
  constexpr int kCols = kChunks >= 8 ? 2 : 4;
  for (int j0 = warp * kCols; j0 < O; j0 += kTokWarps * kCols) {
    uint4 wv[kCols][kChunks];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch) {
        const int k = ch * 256 + lane * 8;
        wv[c][ch] = (k < K && j0 + c < O)
                        ? __ldg(reinterpret_cast<const uint4*>(
                              W + static_cast<int64_t>(j0 + c) * K + k))
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
          const uint32_t ww[4] = {wv[c][ch].x, wv[c][ch].y, wv[c][ch].z, wv[c][ch].w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            w[c][2 * i] = bf2f(static_cast<uint16_t>(ww[i] & 0xffffu));
            w[c][2 * i + 1] = bf2f(static_cast<uint16_t>(ww[i] >> 16));
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
            out[tt * ldo + j] = E == kPlain ? v : round_bf16(v);
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
__global__ void __launch_bounds__(kTokThreads)
twl_tokens_in_kernel(const uint16_t* __restrict__ tokens, const uint16_t* __restrict__ qpe,
                     const uint16_t* __restrict__ wt, const float* __restrict__ bt, int skip_pe,
                     float self_scale, float cross_scale, float eps, float* __restrict__ x_out,
                     uint16_t* __restrict__ qt_out) {
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
    const float x = bf2f(tokens[tbase + i]), p = bf2f(qpe[tbase + i]);
    sX[i] = x;
    sPe[i] = p;
    sIn[i] = round_bf16(skip_pe ? x : x + p);
    sIn2[i] = round_bf16(x);
  }
  __syncthreads();
  tok_linear<kC, kRound>(sIn, wt + kWqS, bt + kBqS, kC, sQ, kC, self_scale, warp, lane);
  tok_linear<kC, kRound>(sIn, wt + kWkS, bt + kBkS, kC, sK, kC, 1.f, warp, lane);
  tok_linear<kC, kRound>(sIn2, wt + kWvS, bt + kBvS, kC, sV, kC, 1.f, warp, lane);
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
    for (int j = 0; j < kTok; ++j) l[j] = round_bf16(e[j] / s);
  }
  __syncthreads();
  for (int o = tid; o < kTok * kC; o += kTokThreads) {  // P V, heads merged
    const int tt = o / kC, c = o % kC, h = c / kSelfD;
    const float* p = sL + (h * kTok + tt) * kTok;
    float av = 0.f;
#pragma unroll
    for (int j = 0; j < kTok; ++j) av += p[j] * sV[j * kC + c];
    sIn[o] = round_bf16(av);
  }
  __syncthreads();
  tok_linear<kC, kPlain>(sIn, wt + kWoS, bt + kBoS, kC, sQ, kC, 1.f, warp, lane);
  __syncthreads();
  for (int i = tid; i < kTok * kC; i += kTokThreads) sX[i] = skip_pe ? sQ[i] : sX[i] + sQ[i];
  __syncthreads();
  tok_layer_norm(sX, bt + kLn1S, bt + kLn1B, eps, warp, lane);
  __syncthreads();
  for (int i = tid; i < kTok * kC; i += kTokThreads) {
    x_out[tbase + i] = sX[i];
    sIn[i] = round_bf16(sX[i] + sPe[i]);
  }
  __syncthreads();
  tok_linear<kC, kRound>(sIn, wt + kWqT, bt + kBqT, kI, sK, kI, cross_scale, warp, lane);
  __syncthreads();
  for (int i = tid; i < kTok * kI; i += kTokThreads)
    qt_out[static_cast<int64_t>(cand) * kTok * kI + i] = f2bf(sK[i]);
}

// The rest of stage 2, stage 3 and the i2t keys and values.
constexpr size_t kSmemMid = sizeof(float) * (4 * kTok * kC + kTok * kMlp);

__global__ void __launch_bounds__(kTokThreads)
twl_tokens_mid_kernel(const float* __restrict__ x_in, const uint16_t* __restrict__ qpe,
                      const float* __restrict__ part_m, const float* __restrict__ part_l,
                      const float* __restrict__ part_acc, int tiles,
                      const uint16_t* __restrict__ wt, const float* __restrict__ bt, float eps,
                      uint16_t* __restrict__ tokens_out, uint16_t* __restrict__ k_out,
                      uint16_t* __restrict__ v_out) {
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
    sPe[i] = bf2f(qpe[tbase + i]);
  }
  // combine the image pass's per-tile flash partials -> t2i output [kTok][kI]
  const int64_t pbase = static_cast<int64_t>(cand) * tiles;
  for (int o = tid; o < kQ * kCrossD; o += kTokThreads) {
    const int q = o / kCrossD, d = o % kCrossD, h = q / kTok, tt = q % kTok;
    sIn[tt * kI + h * kCrossD + d] =
        round_bf16(combine_partials(part_m, part_l, part_acc, pbase, tiles, q, d));
  }
  __syncthreads();
  tok_linear<kI, kPlain>(sIn, wt + kWoT, bt + kBoT, kC, sTmp, kC, 1.f, warp, lane);
  __syncthreads();
  for (int i = tid; i < kTok * kC; i += kTokThreads) sX[i] += sTmp[i];
  __syncthreads();
  tok_layer_norm(sX, bt + kLn2S, bt + kLn2B, eps, warp, lane);
  __syncthreads();
  for (int i = tid; i < kTok * kC; i += kTokThreads) sIn[i] = round_bf16(sX[i]);
  __syncthreads();
  tok_linear<kC, kReluRound>(sIn, wt + kW1, bt + kB1, kMlp, sH, kMlp, 1.f, warp, lane);
  __syncthreads();
  tok_linear<kMlp, kPlain>(sH, wt + kW2, bt + kB2, kC, sTmp, kC, 1.f, warp, lane);
  __syncthreads();
  for (int i = tid; i < kTok * kC; i += kTokThreads) sX[i] += sTmp[i];
  __syncthreads();
  tok_layer_norm(sX, bt + kLn3S, bt + kLn3B, eps, warp, lane);
  __syncthreads();
  for (int i = tid; i < kTok * kC; i += kTokThreads) {
    sIn[i] = round_bf16(sX[i] + sPe[i]);
    sTmp[i] = round_bf16(sX[i]);
    tokens_out[tbase + i] = f2bf(sX[i]);
  }
  __syncthreads();
  tok_linear<kC, kRound>(sIn, wt + kWkI, bt + kBkI, kI, sH, kI, 1.f, warp, lane);
  tok_linear<kC, kRound>(sTmp, wt + kWvI, bt + kBvI, kI, sH + kTok * kI, kI, 1.f, warp, lane);
  __syncthreads();
  for (int i = tid; i < kTok * kI; i += kTokThreads) {
    k_out[static_cast<int64_t>(cand) * kTok * kI + i] = f2bf(sH[i]);
    v_out[static_cast<int64_t>(cand) * kTok * kI + i] = f2bf(sH[kTok * kI + i]);
  }
}

// Stage 4.
constexpr int kImgThreads = 128;
constexpr size_t kSmemI2t =
    sizeof(uint16_t) * (kC * kLdI + kRows * kLdI) + sizeof(float) * 2 * kTok * kI;

template <bool kInt8>
__global__ void __launch_bounds__(kImgThreads)
twl_image_i2t_kernel(const void* __restrict__ src, const int* __restrict__ idx,
                     const float* __restrict__ scale, int S, int N,
                     const uint16_t* __restrict__ q_img,  // [n][N][kI]
                     const uint16_t* __restrict__ k_i, const uint16_t* __restrict__ v_i,  // [n][kTok][kI]
                     const uint16_t* __restrict__ wo,     // [kC][kI]
                     const float* __restrict__ bo_ln,     // bo [kC], ln4 scale [kC], bias [kC]
                     float eps, float cross_scale, uint16_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* sWo = reinterpret_cast<uint16_t*>(smem);
  uint16_t* sAV = sWo + kC * kLdI;
  float* sKi = reinterpret_cast<float*>(sAV + kRows * kLdI);
  float* sVi = sKi + kTok * kI;

  const int tile = blockIdx.x, cand = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = tile * kRows;
  const int row = source_row(idx, cand, S);
  const float sc = kInt8 ? scale[row] : 1.f;

  for (int i = tid; i < kC * (kI / 8); i += kImgThreads) {
    const int o = i / (kI / 8), c8 = (i % (kI / 8)) * 8;
    *reinterpret_cast<uint4*>(sWo + o * kLdI + c8) =
        *reinterpret_cast<const uint4*>(wo + static_cast<int64_t>(o) * kI + c8);
  }
  for (int i = tid; i < kTok * kI; i += kImgThreads) {
    sKi[i] = bf2f(k_i[static_cast<int64_t>(cand) * kTok * kI + i]);
    sVi[i] = bf2f(v_i[static_cast<int64_t>(cand) * kTok * kI + i]);
  }
  __syncthreads();

  // per (row, head): softmax over the kTok tokens, product with the values
  for (int it = tid; it < kRows * kHeads; it += kImgThreads) {
    const int r = it / kHeads, h = it % kHeads;
    const uint4* qp = reinterpret_cast<const uint4*>(
        q_img + (static_cast<int64_t>(cand) * N + r0 + r) * kI + h * kCrossD);
    const uint4 qa = qp[0], qb = qp[1];
    const uint32_t qw[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
    float q[kCrossD];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      q[2 * i] = round_bf16(bf2f(static_cast<uint16_t>(qw[i] & 0xffffu)) * cross_scale);
      q[2 * i + 1] = round_bf16(bf2f(static_cast<uint16_t>(qw[i] >> 16)) * cross_scale);
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
    for (int tt = 0; tt < kTok; ++tt) l[tt] = round_bf16(l[tt] / sum);
#pragma unroll
    for (int d = 0; d < kCrossD; d += 2) {
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int tt = 0; tt < kTok; ++tt) {
        a0 += l[tt] * sVi[tt * kI + h * kCrossD + d];
        a1 += l[tt] * sVi[tt * kI + h * kCrossD + d + 1];
      }
      sts32(sAV + r * kLdI + h * kCrossD + d, pack_bf16x2(a0, a1));
    }
  }
  __syncthreads();

  // out-projection [kRows x kI] x [kI -> kC] on the tensor cores
  float acc[kC / 8][4];
#pragma unroll
  for (int n = 0; n < kC / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  warp_mma<kC / 8, kI>(acc, sAV, kLdI, sWo, kLdI, warp * 16, lane);

  // + bias + the rows, LayerNorm over kC; each row's channels are spread
  // over the 4 lanes of a quad
  const int ra = r0 + warp * 16 + g, rb = ra + 8;
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int n = 0; n < kC / 8; ++n) {
    const int col = n * 8 + 2 * t;
    float x0, x1, x2, x3;
    load_pair<kInt8>(src, row, N, ra, col, sc, x0, x1);
    load_pair<kInt8>(src, row, N, rb, col, sc, x2, x3);
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
  uint16_t* oa = out + (static_cast<int64_t>(cand) * N + ra) * kC;
  uint16_t* ob = out + (static_cast<int64_t>(cand) * N + rb) * kC;
#pragma unroll
  for (int n = 0; n < kC / 8; ++n) {
    const int col = n * 8 + 2 * t;
    sts32(oa + col, pack_bf16x2((acc[n][0] - ma) * ia * s4[col] + b4[col],
                                (acc[n][1] - ma) * ia * s4[col + 1] + b4[col + 1]));
    sts32(ob + col, pack_bf16x2((acc[n][2] - mb) * ib * s4[col] + b4[col],
                                (acc[n][3] - mb) * ib * s4[col + 1] + b4[col + 1]));
  }
}

template <bool kInt8>
int launch_i2t(const void* src, const int* idx, const float* scale, int S, int n, int N,
               const void* q_img, const void* k_i, const void* v_i, const void* wo,
               const float* bo_ln, float eps, float cross_scale, void* out, cudaStream_t stream) {
  auto kernel = twl_image_i2t_kernel<kInt8>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemI2t);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(N / kRows, n), kImgThreads, kSmemI2t, stream>>>(
      src, idx, scale, S, N, static_cast<const uint16_t*>(q_img),
      static_cast<const uint16_t*>(k_i), static_cast<const uint16_t*>(v_i),
      static_cast<const uint16_t*>(wo), bo_ln, eps, cross_scale, static_cast<uint16_t*>(out));
  return cudaGetLastError();
}

}  // namespace

// tokens, qpe: bf16 [n][6][256]; wt: the bf16 weights, bt: the fp32 vectors
// (offsets above); x_out: fp32 [n][6][256]; qt_out: bf16 [n][6][128].
extern "C" int cor_twl_tokens_in(const void* tokens, const void* qpe, const void* wt,
                                 const void* bt, int skip_pe, float self_scale,
                                 float cross_scale, float eps, int n, void* x_out, void* qt_out,
                                 void* stream) {
  if (n < 1 || n > 65535) return cudaErrorInvalidValue;
  twl_tokens_in_kernel<<<n, kTokThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(tokens), static_cast<const uint16_t*>(qpe),
      static_cast<const uint16_t*>(wt), static_cast<const float*>(bt), skip_pe, self_scale,
      cross_scale, eps, static_cast<float*>(x_out), static_cast<uint16_t*>(qt_out));
  return cudaGetLastError();
}

// x_in: fp32 [n][6][256] from cor_twl_tokens_in; partials of the image pass
// over `tiles` row tiles; tokens_out: bf16 [n][6][256]; k_out, v_out: bf16
// [n][6][128].
extern "C" int cor_twl_tokens_mid(const void* x_in, const void* qpe, const void* part_m,
                                  const void* part_l, const void* part_acc, int tiles,
                                  const void* wt, const void* bt, float eps, int n,
                                  void* tokens_out, void* k_out, void* v_out, void* stream) {
  if (n < 1 || n > 65535 || tiles < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(twl_tokens_mid_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMid);
  if (err != cudaSuccess) return err;
  twl_tokens_mid_kernel<<<n, kTokThreads, kSmemMid, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x_in), static_cast<const uint16_t*>(qpe),
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), tiles, static_cast<const uint16_t*>(wt),
      static_cast<const float*>(bt), eps, static_cast<uint16_t*>(tokens_out),
      static_cast<uint16_t*>(k_out), static_cast<uint16_t*>(v_out));
  return cudaGetLastError();
}

// src/idx/scale/S as for cor_t2i_image_pass; q_img bf16 [n][N][128]; k_i,
// v_i bf16 [n][6][128]; wo bf16 [256][128]; bo_ln4 fp32 [3][256];
// keys_out bf16 [n][N][256].
extern "C" int cor_twl_image_i2t(const void* src, int src_int8, const void* idx,
                                 const void* scale, int S, int n, int N, const void* q_img,
                                 const void* k_i, const void* v_i, const void* wo,
                                 const void* bo_ln4, float eps, float cross_scale,
                                 void* keys_out, void* stream) {
  if (n < 1 || n > 65535 || N < kRows || N % kRows || S < 1 ||
      (src_int8 && (!scale || !idx)))
    return cudaErrorInvalidValue;
  const int* ip = static_cast<const int*>(idx);
  const float* sp = static_cast<const float*>(scale);
  const float* bl = static_cast<const float*>(bo_ln4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return src_int8 ? launch_i2t<true>(src, ip, sp, S, n, N, q_img, k_i, v_i, wo, bl, eps,
                                     cross_scale, keys_out, s)
                  : launch_i2t<false>(src, ip, sp, S, n, N, q_img, k_i, v_i, wo, bl, eps,
                                      cross_scale, keys_out, s);
}
