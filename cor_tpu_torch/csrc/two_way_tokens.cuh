// The two-way layer's token kernels' shared parts (two_way_layer.cu: stage
// 1, two_way_layer_mid.cu: stage 3): the packed weights' offsets, the
// token linears and LayerNorm, and the dispatch on the token count T (a
// template parameter of the token kernels, 5 to 8).
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
template <typename T, int NT, int K, int E>
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
template <int NT>
__device__ void tok_layer_norm(float* x, const float* __restrict__ s, const float* __restrict__ b,
                               float eps, int warp, int lane) {
  if (warp >= NT) return;
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
