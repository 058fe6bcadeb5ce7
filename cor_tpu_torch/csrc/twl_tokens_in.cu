// K1's stage 1 over a cluster of CTAs per candidate: the entry
// cor_twl_tokens_in_cluster, K1's own. It computes what cor_twl_tokens_in
// (two_way_layer.cu, tokens_in_body of two_way_tokens.cuh) computes, bit
// for bit: token self-attention (8 heads of 32; no PE and no residual on
// the first layer), LN1, and the t2i query, scaled after its bias and
// rounded.
//
// Replaces, with the three other launches of the layer, the TPU kernel
// cor_tpu/ops/pallas/two_way_layer.py:two_way_layer_fused (its pallas_calls
// at lines 978, 998 and 1012). K1-dma runs it too.
//
// As twl_tokens_mid.cu: one CTA per candidate left 92 of the 132 SMs idle
// at 40 candidates. A cluster of 4 CTAs takes a candidate while n x 4 CTAs
// are all resident at once (twl_cluster.cuh; beyond, cor_twl_tokens_in
// runs):
// the five linears' output columns are split over the cluster's warps and
// gathered through distributed shared memory; the attention between them,
// the residual and LN1, cheap, run whole in every CTA on the same inputs.
//
// Shared memory: tokens_in_body's (smem_tokens_in: 7 T x 256 + 8 T^2 fp32),
// 59,392 B at T = 8.

#include "twl_cluster.cuh"

namespace {

using namespace cor;
using twl::gather;
using twl::owner;
namespace cg = cooperative_groups;

constexpr int kCl = twl::kCluster;

template <typename T, int NT>
__global__ void __cluster_dims__(kCl, 1, 1) __launch_bounds__(kTokThreads)
twl_tokens_in_cluster_kernel(const T* __restrict__ tokens, const T* __restrict__ qpe,
                             const T* __restrict__ wt, const float* __restrict__ bt, int skip_pe,
                             float self_scale, float cross_scale, float eps,
                             float* __restrict__ x_out, T* __restrict__ qt_out) {
  using E = Elem<T>;
  constexpr int kClWarps = kCl * kTokWarps;  // the warps a linear's columns are split over
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cand = blockIdx.x / kCl;
  float* sX = reinterpret_cast<float*>(smem);
  float* sPe = sX + NT * kC;
  float* sIn = sPe + NT * kC;
  float* sIn2 = sIn + NT * kC;
  float* sQ = sIn2 + NT * kC;
  float* sK = sQ + NT * kC;
  float* sV = sK + NT * kC;
  float* sL = sV + NT * kC;  // [kHeads * NT * NT] logits, then probabilities

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cw = rank * kTokWarps + warp;  // this warp among the cluster's
  const int64_t tbase = static_cast<int64_t>(cand) * NT * kC;
  for (int i = tid; i < NT * kC; i += kTokThreads) {
    const float x = E::get(tokens[tbase + i]);
    const float p = E::get(qpe[tbase + i]);
    sX[i] = x;
    sPe[i] = p;
    sIn[i] = E::round(skip_pe ? x : x + p);
    sIn2[i] = E::round(x);
  }
  __syncthreads();
  tok_linear<T, NT, kC, kRound, kClWarps>(sIn, wt + kWqS, bt + kBqS, kC, sQ, kC, self_scale, cw,
                                          lane);
  tok_linear<T, NT, kC, kRound, kClWarps>(sIn, wt + kWkS, bt + kBkS, kC, sK, kC, 1.f, cw, lane);
  tok_linear<T, NT, kC, kRound, kClWarps>(sIn2, wt + kWvS, bt + kBvS, kC, sV, kC, 1.f, cw, lane);
  cluster.sync();
  gather<T, NT, kC, kCl>(cluster, sQ, kC, kC, rank);
  gather<T, NT, kC, kCl>(cluster, sK, kC, kC, rank);
  gather<T, NT, kC, kCl>(cluster, sV, kC, kC, rank);
  cluster.sync();
  // the attention, as tokens_in_body computes it
  for (int e = tid; e < kHeads * NT * NT; e += kTokThreads) {
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
  for (int o = tid; o < NT * kC; o += kTokThreads) {  // P V, heads merged
    const int tt = o / kC, c = o % kC, h = c / kSelfD;
    const float* p = sL + (h * NT + tt) * NT;
    float av = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) av += p[j] * sV[j * kC + c];
    sIn[o] = E::round(av);
  }
  __syncthreads();
  tok_linear<T, NT, kC, kPlain, kClWarps>(sIn, wt + kWoS, bt + kBoS, kC, sQ, kC, 1.f, cw, lane);
  cluster.sync();
  gather<T, NT, kC, kCl>(cluster, sQ, kC, kC, rank);
  cluster.sync();
  for (int i = tid; i < NT * kC; i += kTokThreads) sX[i] = skip_pe ? sQ[i] : sX[i] + sQ[i];
  __syncthreads();
  tok_layer_norm<NT>(sX, bt + kLn1S, bt + kLn1B, eps, warp, lane);
  __syncthreads();
  for (int i = tid; i < NT * kC; i += kTokThreads) {
    if (rank == 0) x_out[tbase + i] = sX[i];
    sIn[i] = E::round(sX[i] + sPe[i]);
  }
  __syncthreads();
  tok_linear<T, NT, kC, kRound, kClWarps>(sIn, wt + kWqT, bt + kBqT, kI, sK, kI, cross_scale, cw,
                                          lane);
  __syncthreads();
  for (int i = tid; i < NT * kI; i += kTokThreads)
    if (owner<T, kC, kCl>(i % kI) == rank)
      qt_out[static_cast<int64_t>(cand) * NT * kI + i] = E::put(sK[i]);
}

template <typename T, int NT>
int tokens_in(const void* tokens, const void* qpe, const void* wt, const void* bt, int skip_pe,
              float self_scale, float cross_scale, float eps, int n, void* x_out, void* qt_out,
              cudaStream_t stream) {
  static int raised[wg::kMaxDevices] = {};
  auto kernel = twl_tokens_in_cluster_kernel<T, NT>;
  constexpr int smem = smem_tokens_in<NT>();
  cudaError_t err = wg::raise_shared_memory(reinterpret_cast<const void*>(kernel), smem, raised);
  if (err != cudaSuccess) return err;
  kernel<<<n * kCl, kTokThreads, smem, stream>>>(
      static_cast<const T*>(tokens), static_cast<const T*>(qpe), static_cast<const T*>(wt),
      static_cast<const float*>(bt), skip_pe, self_scale, cross_scale, eps,
      static_cast<float*>(x_out), static_cast<T*>(qt_out));
  return cudaGetLastError();
}

}  // namespace

extern "C" int cor_twl_tokens_in(const void* tokens, const void* qpe, const void* wt,
                                 const void* bt, int skip_pe, float self_scale,
                                 float cross_scale, float eps, int n, int n_tok, void* x_out,
                                 void* qt_out, int f32, void* stream);

// cor_twl_tokens_in's arguments (two_way_layer.cu); the same outputs, bit
// for bit: over clusters while they all fit at once, else by
// cor_twl_tokens_in itself.
extern "C" int cor_twl_tokens_in_cluster(const void* tokens, const void* qpe, const void* wt,
                                         const void* bt, int skip_pe, float self_scale,
                                         float cross_scale, float eps, int n, int n_tok,
                                         void* x_out, void* qt_out, int f32, void* stream) {
  if (n < 1 || n > 65535) return cudaErrorInvalidValue;
  if (!twl::cluster_fits(n))
    return cor_twl_tokens_in(tokens, qpe, wt, bt, skip_pe, self_scale, cross_scale, eps, n, n_tok,
                             x_out, qt_out, f32, stream);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_tokens(n_tok, [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    return f32 ? tokens_in<float, NT>(tokens, qpe, wt, bt, skip_pe, self_scale, cross_scale, eps,
                                      n, x_out, qt_out, s)
               : tokens_in<uint16_t, NT>(tokens, qpe, wt, bt, skip_pe, self_scale, cross_scale,
                                         eps, n, x_out, qt_out, s);
  });
}
