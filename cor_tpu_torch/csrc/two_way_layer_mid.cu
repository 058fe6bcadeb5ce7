// Stage 3 of the two-way layer (two_way_layer.cu says what the layer's four
// launches do and what bounds them): per candidate, the combine of the
// image pass's t2i partials, the t2i out-projection, LN2, the ReLU MLP (256
// -> 2048 -> 256), LN3, and the i2t keys and values of the T tokens. Its
// own file so that nvcc compiles it beside the other token kernel.

#include "two_way_tokens.cuh"

namespace {

using namespace cor;

// The rest of stage 2, stage 3 and the i2t keys and values.
template <int NT>
constexpr size_t smem_tokens_mid() {
  return sizeof(float) * (4 * NT * kC + NT * kMlp);
}

template <typename T, int NT>
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
  float* sPe = sX + NT * kC;
  float* sIn = sPe + NT * kC;
  float* sTmp = sIn + NT * kC;
  float* sH = sTmp + NT * kC;  // [NT][kMlp]

  const int cand = blockIdx.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t tbase = static_cast<int64_t>(cand) * NT * kC;
  for (int i = tid; i < NT * kC; i += kTokThreads) {
    sX[i] = x_in[tbase + i];
    sPe[i] = E::get(qpe[tbase + i]);
  }
  // combine the image pass's per-tile flash partials -> t2i output [NT][kI]
  const int64_t pbase = static_cast<int64_t>(cand) * tiles;
  for (int o = tid; o < kHeads * NT * kCrossD; o += kTokThreads) {
    const int q = o / kCrossD, d = o % kCrossD, h = q / NT, tt = q % NT;
    sIn[tt * kI + h * kCrossD + d] =
        E::round(combine_partials(part_m, part_l, part_acc, pbase, tiles, kHeads * NT, q, d));
  }
  __syncthreads();
  tok_linear<T, NT, kI, kPlain>(sIn, wt + kWoT, bt + kBoT, kC, sTmp, kC, 1.f, warp, lane);
  __syncthreads();
  for (int i = tid; i < NT * kC; i += kTokThreads) sX[i] += sTmp[i];
  __syncthreads();
  tok_layer_norm<NT>(sX, bt + kLn2S, bt + kLn2B, eps, warp, lane);
  __syncthreads();
  for (int i = tid; i < NT * kC; i += kTokThreads) sIn[i] = E::round(sX[i]);
  __syncthreads();
  tok_linear<T, NT, kC, kReluRound>(sIn, wt + kW1, bt + kB1, kMlp, sH, kMlp, 1.f, warp, lane);
  __syncthreads();
  tok_linear<T, NT, kMlp, kPlain>(sH, wt + kW2, bt + kB2, kC, sTmp, kC, 1.f, warp, lane);
  __syncthreads();
  for (int i = tid; i < NT * kC; i += kTokThreads) sX[i] += sTmp[i];
  __syncthreads();
  tok_layer_norm<NT>(sX, bt + kLn3S, bt + kLn3B, eps, warp, lane);
  __syncthreads();
  for (int i = tid; i < NT * kC; i += kTokThreads) {
    sIn[i] = E::round(sX[i] + sPe[i]);
    sTmp[i] = E::round(sX[i]);
    tokens_out[tbase + i] = E::put(sX[i]);
  }
  __syncthreads();
  tok_linear<T, NT, kC, kRound>(sIn, wt + kWkI, bt + kBkI, kI, sH, kI, 1.f, warp, lane);
  tok_linear<T, NT, kC, kRound>(sTmp, wt + kWvI, bt + kBvI, kI, sH + NT * kI, kI, 1.f, warp, lane);
  __syncthreads();
  for (int i = tid; i < NT * kI; i += kTokThreads) {
    k_out[static_cast<int64_t>(cand) * NT * kI + i] = E::put(sH[i]);
    v_out[static_cast<int64_t>(cand) * NT * kI + i] = E::put(sH[NT * kI + i]);
  }
}

template <typename T, int NT>
int tokens_mid(const void* x_in, const void* qpe, const void* part_m, const void* part_l,
               const void* part_acc, int tiles, const void* wt, const void* bt, float eps, int n,
               void* tokens_out, void* k_out, void* v_out, cudaStream_t stream) {
  constexpr size_t smem = smem_tokens_mid<NT>();
  cudaError_t err = cudaFuncSetAttribute(twl_tokens_mid_kernel<T, NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  twl_tokens_mid_kernel<T, NT><<<n, kTokThreads, smem, stream>>>(
      static_cast<const float*>(x_in), static_cast<const T*>(qpe),
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), tiles, static_cast<const T*>(wt),
      static_cast<const float*>(bt), eps, static_cast<T*>(tokens_out), static_cast<T*>(k_out),
      static_cast<T*>(v_out));
  return cudaGetLastError();
}

}  // namespace

// x_in: fp32 [n][n_tok][256] from cor_twl_tokens_in; partials of the image
// pass over `tiles` row tiles; tokens_out: T [n][n_tok][256]; k_out, v_out:
// T [n][n_tok][128].
extern "C" int cor_twl_tokens_mid(const void* x_in, const void* qpe, const void* part_m,
                                  const void* part_l, const void* part_acc, int tiles,
                                  const void* wt, const void* bt, float eps, int n, int n_tok,
                                  void* tokens_out, void* k_out, void* v_out, int f32,
                                  void* stream) {
  if (n < 1 || n > 65535 || tiles < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_tokens(n_tok, [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    return f32 ? tokens_mid<float, NT>(x_in, qpe, part_m, part_l, part_acc, tiles, wt, bt, eps,
                                       n, tokens_out, k_out, v_out, s)
               : tokens_mid<uint16_t, NT>(x_in, qpe, part_m, part_l, part_acc, tiles, wt, bt,
                                          eps, n, tokens_out, k_out, v_out, s);
  });
}

