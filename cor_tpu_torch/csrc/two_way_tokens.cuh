// The two-way layer's token stages (two_way_layer.cu: stage 1,
// two_way_layer_mid.cu: stage 3): the packed weights' offsets, the token
// linears and LayerNorm, the stages' __device__ bodies, which take their
// candidate as an argument (K1's one-CTA token kernels run one per CTA of 8
// warps, above 66 candidates; K1's cluster kernels, twl_tokens_{in,mid}.cu, and the
// fused transformer, two_way_stack.cuh, split the same linears over several
// CTAs), and the dispatch on the token count T (a template parameter of the
// token stages, 5 to 8).
#pragma once

#include <type_traits>

#include "decoder_common.cuh"

namespace cor {

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
// in is [NT][K] fp32 in shared memory (values already rounded to T), W is
// [O][K] of T in global memory. A warp takes kCols output columns at a
// time, its lanes splitting K in 8-element pieces: the weight loads of all
// kCols columns are issued before the first product (one at a time they
// would wait on L2 in turn), and each input value read from shared memory
// serves all kCols columns.
// kWarps: the warps of the block (the columns' split among them; each
// column's sum is the same at any kWarps), or nwarps, the warps of several
// blocks that split the columns (the fused transformer's clusters, whose
// size is chosen at launch; warp: this warp among them).
template <typename T, int NT, int K, int E, int kWarps = kTokWarps>
__device__ void tok_linear(const float* in, const T* __restrict__ W,
                           const float* __restrict__ bias, int O, float* out, int ldo, float mul,
                           int warp, int lane, int nwarps = kWarps) {
  constexpr int kChunks = (K + 255) / 256;  // 8-element pieces per lane
  constexpr int kWords = sizeof(T) / 2;     // 16-byte loads per piece: 1 (bf16), 2 (fp32)
  constexpr int kCols = kChunks >= 8 ? 2 / kWords : 4;
  for (int j0 = warp * kCols; j0 < O; j0 += nwarps * kCols) {
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
    float acc[kCols][NT];
#pragma unroll
    for (int c = 0; c < kCols; ++c)
#pragma unroll
      for (int tt = 0; tt < NT; ++tt) acc[c][tt] = 0.f;
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
        for (int tt = 0; tt < NT; ++tt) {
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
      for (int tt = 0; tt < NT; ++tt) acc[c][tt] = warp_sum(acc[c][tt]);
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int j = j0 + c;
        if (j < O) {
#pragma unroll
          for (int tt = 0; tt < NT; ++tt) {
            float v = (acc[c][tt] + bias[j]) * mul;
            if (E == kReluRound) v = fmaxf(v, 0.f);
            out[tt * ldo + j] = E == kPlain ? v : Elem<T>::round(v);
          }
        }
      }
    }
  }
}

// LayerNorm over the kC channels of each of the NT rows of x, in place:
// one warp per token, fp32 mean and biased variance.
template <int NT, int kWarps = kTokWarps>
__device__ void tok_layer_norm(float* x, const float* __restrict__ s, const float* __restrict__ b,
                               float eps, int warp, int lane) {
  for (int tk = warp; tk < NT; tk += kWarps) {
    float v[8];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[i] = x[tk * kC + lane * 8 + i];
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
      x[tk * kC + c] = (v[i] - mean) * rstd * s[c] + b[c];
    }
  }
}

// A token state value as fp32: the compute dtype's, or the fp32 state of the
// fused transformer (two_way_stack.cuh); and its store in the compute dtype.
__device__ __forceinline__ float tok_get(uint16_t v) { return bf2f(v); }
__device__ __forceinline__ float tok_get(float v) { return v; }
__device__ __forceinline__ void tok_put(uint16_t* p, float v) { *p = f2bf(v); }
__device__ __forceinline__ void tok_put(float* p, float v) { *p = v; }

// Stage 1 and the t2i query, for candidate `cand`: token self-attention (8
// heads of 32; no PE and no residual with skip_pe), LN1, the t2i query
// scaled after its bias and rounded. tokens: T [n][NT][kC]; x_out: the fp32
// state after LN1; qt_out: T [n][NT][kI].
template <int NT>
__host__ __device__ constexpr size_t smem_tokens_in() {
  return sizeof(float) * (7 * NT * kC + kHeads * NT * NT);
}

template <typename T, int NT, int kWarps>
__device__ __forceinline__ void tokens_in_body(
    unsigned char* smem, const T* __restrict__ tokens,
    const T* __restrict__ qpe, const T* __restrict__ wt, const float* __restrict__ bt,
    int skip_pe, float self_scale, float cross_scale, float eps, float* __restrict__ x_out,
    T* __restrict__ qt_out, int cand) {
  using E = Elem<T>;
  constexpr int kThr = kWarps * 32;
  float* sX = reinterpret_cast<float*>(smem);  // 59,392 B at NT = 8
  float* sPe = sX + NT * kC;
  float* sIn = sPe + NT * kC;
  float* sIn2 = sIn + NT * kC;
  float* sQ = sIn2 + NT * kC;
  float* sK = sQ + NT * kC;
  float* sV = sK + NT * kC;
  float* sL = sV + NT * kC;  // [kHeads * NT * NT] logits, then probabilities

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t tbase = static_cast<int64_t>(cand) * NT * kC;
  for (int i = tid; i < NT * kC; i += kThr) {
    const float x = E::get(tokens[tbase + i]);
    const float p = E::get(qpe[tbase + i]);
    sX[i] = x;
    sPe[i] = p;
    sIn[i] = E::round(skip_pe ? x : x + p);
    sIn2[i] = E::round(x);
  }
  __syncthreads();
  tok_linear<T, NT, kC, kRound, kWarps>(sIn, wt + kWqS, bt + kBqS, kC, sQ, kC, self_scale, warp,
                                        lane);
  tok_linear<T, NT, kC, kRound, kWarps>(sIn, wt + kWkS, bt + kBkS, kC, sK, kC, 1.f, warp, lane);
  tok_linear<T, NT, kC, kRound, kWarps>(sIn2, wt + kWvS, bt + kBvS, kC, sV, kC, 1.f, warp, lane);
  __syncthreads();
  for (int e = tid; e < kHeads * NT * NT; e += kThr) {
    const int h = e / (NT * NT), qi = (e / NT) % NT, kj = e % NT;
    float l = 0.f;
#pragma unroll 8
    for (int d = 0; d < kSelfD; ++d) l += sQ[qi * kC + h * kSelfD + d] * sK[kj * kC + h * kSelfD + d];
    sL[e] = l;
  }
  __syncthreads();
  if (tid < kHeads * NT) {  // softmax of row (h, qi) over the NT keys
    float* l = sL + tid * NT;
    float m = l[0];
    for (int j = 1; j < NT; ++j) m = fmaxf(m, l[j]);
    float e[NT], s = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      e[j] = expf(l[j] - m);
      s += e[j];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) l[j] = E::round(e[j] / s);
  }
  __syncthreads();
  for (int o = tid; o < NT * kC; o += kThr) {  // P V, heads merged
    const int tt = o / kC, c = o % kC, h = c / kSelfD;
    const float* p = sL + (h * NT + tt) * NT;
    float av = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) av += p[j] * sV[j * kC + c];
    sIn[o] = E::round(av);
  }
  __syncthreads();
  tok_linear<T, NT, kC, kPlain, kWarps>(sIn, wt + kWoS, bt + kBoS, kC, sQ, kC, 1.f, warp, lane);
  __syncthreads();
  for (int i = tid; i < NT * kC; i += kThr) sX[i] = skip_pe ? sQ[i] : sX[i] + sQ[i];
  __syncthreads();
  tok_layer_norm<NT, kWarps>(sX, bt + kLn1S, bt + kLn1B, eps, warp, lane);
  __syncthreads();
  for (int i = tid; i < NT * kC; i += kThr) {
    x_out[tbase + i] = sX[i];
    sIn[i] = E::round(sX[i] + sPe[i]);
  }
  __syncthreads();
  tok_linear<T, NT, kC, kRound, kWarps>(sIn, wt + kWqT, bt + kBqT, kI, sK, kI, cross_scale, warp,
                                        lane);
  __syncthreads();
  for (int i = tid; i < NT * kI; i += kThr)
    qt_out[static_cast<int64_t>(cand) * NT * kI + i] = E::put(sK[i]);
}

// The rest of stage 2, stage 3 and the i2t keys and values, for candidate
// `cand`: the combine of the image pass's t2i partials, the t2i
// out-projection, LN2, the ReLU MLP (256 -> 2048 -> 256), LN3; the state
// into tokens_out (T, rounded), the i2t keys and values of the NT tokens
// from the unrounded state into k_out, v_out (T [n][NT][kI]).
template <int NT>
__host__ __device__ constexpr size_t smem_tokens_mid() {
  return sizeof(float) * (4 * NT * kC + NT * kMlp);
}

template <typename T, int NT, int kWarps>
__device__ __forceinline__ void tokens_mid_body(
    unsigned char* smem, const float* __restrict__ x_in, const T* __restrict__ qpe,
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    const float* __restrict__ part_acc, int tiles, const T* __restrict__ wt,
    const float* __restrict__ bt, float eps, T* __restrict__ tokens_out,
    T* __restrict__ k_out, T* __restrict__ v_out, int cand) {
  using E = Elem<T>;
  constexpr int kThr = kWarps * 32;
  float* sX = reinterpret_cast<float*>(smem);
  float* sPe = sX + NT * kC;
  float* sIn = sPe + NT * kC;
  float* sTmp = sIn + NT * kC;
  float* sH = sTmp + NT * kC;  // [NT][kMlp]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t tbase = static_cast<int64_t>(cand) * NT * kC;
  for (int i = tid; i < NT * kC; i += kThr) {
    sX[i] = x_in[tbase + i];
    sPe[i] = E::get(qpe[tbase + i]);
  }
  // combine the image pass's per-tile flash partials -> t2i output [NT][kI]
  const int64_t pbase = static_cast<int64_t>(cand) * tiles;
  for (int o = tid; o < kHeads * NT * kCrossD; o += kThr) {
    const int q = o / kCrossD, d = o % kCrossD, h = q / NT, tt = q % NT;
    sIn[tt * kI + h * kCrossD + d] = E::round(
        combine_partials(part_m, part_l, part_acc, pbase, tiles, kHeads * NT, q, d));
  }
  __syncthreads();
  tok_linear<T, NT, kI, kPlain, kWarps>(sIn, wt + kWoT, bt + kBoT, kC, sTmp, kC, 1.f, warp, lane);
  __syncthreads();
  for (int i = tid; i < NT * kC; i += kThr) sX[i] += sTmp[i];
  __syncthreads();
  tok_layer_norm<NT, kWarps>(sX, bt + kLn2S, bt + kLn2B, eps, warp, lane);
  __syncthreads();
  for (int i = tid; i < NT * kC; i += kThr) sIn[i] = E::round(sX[i]);
  __syncthreads();
  tok_linear<T, NT, kC, kReluRound, kWarps>(sIn, wt + kW1, bt + kB1, kMlp, sH, kMlp, 1.f, warp,
                                            lane);
  __syncthreads();
  tok_linear<T, NT, kMlp, kPlain, kWarps>(sH, wt + kW2, bt + kB2, kC, sTmp, kC, 1.f, warp, lane);
  __syncthreads();
  for (int i = tid; i < NT * kC; i += kThr) sX[i] += sTmp[i];
  __syncthreads();
  tok_layer_norm<NT, kWarps>(sX, bt + kLn3S, bt + kLn3B, eps, warp, lane);
  __syncthreads();
  for (int i = tid; i < NT * kC; i += kThr) {
    sIn[i] = E::round(sX[i] + sPe[i]);
    sTmp[i] = E::round(sX[i]);
    tok_put(tokens_out + tbase + i, sX[i]);
  }
  __syncthreads();
  tok_linear<T, NT, kC, kRound, kWarps>(sIn, wt + kWkI, bt + kBkI, kI, sH, kI, 1.f, warp, lane);
  tok_linear<T, NT, kC, kRound, kWarps>(sTmp, wt + kWvI, bt + kBvI, kI, sH + NT * kI, kI, 1.f,
                                        warp, lane);
  __syncthreads();
  for (int i = tid; i < NT * kI; i += kThr) {
    k_out[static_cast<int64_t>(cand) * NT * kI + i] = E::put(sH[i]);
    v_out[static_cast<int64_t>(cand) * NT * kI + i] = E::put(sH[NT * kI + i]);
  }
}

// The token count of the token kernels, a template parameter (T 5 to 8):
// go(std::integral_constant<int, T>) for n_tok = T, or an error for another.
template <typename Go>
int by_tokens(int n_tok, Go go) {
  switch (n_tok) {
    case 5: return go(std::integral_constant<int, 5>());
    case 6: return go(std::integral_constant<int, 6>());
    case 7: return go(std::integral_constant<int, 7>());
    case 8: return go(std::integral_constant<int, 8>());
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace cor
