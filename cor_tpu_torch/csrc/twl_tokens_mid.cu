// K1's stage 3 over a cluster of CTAs per candidate: the entry
// cor_twl_tokens_mid_cluster, K1's own. It computes what
// cor_twl_tokens_mid (two_way_layer_mid.cu, tokens_mid_body of
// two_way_tokens.cuh) computes, bit for bit: the combine of the image pass's
// t2i partials, the t2i out-projection, LN2, the ReLU MLP (256 -> 2048 ->
// 256), LN3, and the i2t keys and values of the T tokens.
//
// Replaces, with the three other launches of the layer, the TPU kernel
// cor_tpu/ops/pallas/two_way_layer.py:two_way_layer_fused (its pallas_calls
// at lines 978, 998 and 1012). K1-dma runs it too.
//
// What held it back on the H100 (PERF.md): one CTA of 8 warps per candidate,
// so 40 candidates use 40 of the 132 SMs, each reading the stage's ~1.3
// million weights (2.6 MB in bf16, 5.2 in fp32) from L2 alone; its time did
// not fall with fewer candidates and, once the image passes were
// redesigned, it was the largest launch of a bf16 layer at 40. Here a
// cluster of 4 CTAs takes a candidate, while n x 4 CTAs are all resident at
// once (twl_cluster.cuh; beyond, cor_twl_tokens_mid runs): each linear's
// output columns are split over the cluster's warps by tok_linear's own
// assignment
// (each column summed by one warp in its order, so the same bits at any
// warp count), the columns the other CTAs computed are read through
// distributed shared memory, and the combine and the LayerNorms, cheap, run
// whole in every CTA on the same inputs. Each CTA reads a quarter of the
// weights.
//
// Shared memory: tokens_mid_body's (smem_tokens_mid: 4 T x 256 + T x 2048
// fp32), 98,304 B at T = 8, so two CTAs an SM.

#include "twl_cluster.cuh"

namespace {

using namespace cor;
using twl::gather;
using twl::owner;
namespace cg = cooperative_groups;

constexpr int kCl = twl::kCluster;

template <typename T, int NT>
__global__ void __cluster_dims__(kCl, 1, 1) __launch_bounds__(kTokThreads)
twl_tokens_mid_cluster_kernel(const float* __restrict__ x_in, const T* __restrict__ qpe,
                              const float* __restrict__ part_m, const float* __restrict__ part_l,
                              const float* __restrict__ part_acc, int tiles,
                              const T* __restrict__ wt, const float* __restrict__ bt, float eps,
                              T* __restrict__ tokens_out, T* __restrict__ k_out,
                              T* __restrict__ v_out) {
  using E = Elem<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  constexpr int kClWarps = kCl * kTokWarps;  // the warps a linear's columns are split over
  const int cand = blockIdx.x / kCl;
  float* sX = reinterpret_cast<float*>(smem);
  float* sPe = sX + NT * kC;
  float* sIn = sPe + NT * kC;
  float* sTmp = sIn + NT * kC;
  float* sH = sTmp + NT * kC;  // [NT][kMlp]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cw = rank * kTokWarps + warp;  // this warp among the cluster's
  const int64_t tbase = static_cast<int64_t>(cand) * NT * kC;
  for (int i = tid; i < NT * kC; i += kTokThreads) {
    sX[i] = x_in[tbase + i];
    sPe[i] = E::get(qpe[tbase + i]);
  }
  // combine the image pass's per-tile flash partials -> t2i output [NT][kI]
  const int64_t pbase = static_cast<int64_t>(cand) * tiles;
  for (int o = tid; o < kHeads * NT * kCrossD; o += kTokThreads) {
    const int q = o / kCrossD, d = o % kCrossD, h = q / NT, tt = q % NT;
    sIn[tt * kI + h * kCrossD + d] = E::round(
        combine_partials(part_m, part_l, part_acc, pbase, tiles, kHeads * NT, q, d));
  }
  __syncthreads();
  tok_linear<T, NT, kI, kPlain, kClWarps>(sIn, wt + kWoT, bt + kBoT, kC, sTmp, kC, 1.f, cw,
                                          lane);
  cluster.sync();
  gather<T, NT, kI, kCl>(cluster, sTmp, kC, kC, rank);
  cluster.sync();
  for (int i = tid; i < NT * kC; i += kTokThreads) sX[i] += sTmp[i];
  __syncthreads();
  tok_layer_norm<NT>(sX, bt + kLn2S, bt + kLn2B, eps, warp, lane);
  __syncthreads();
  for (int i = tid; i < NT * kC; i += kTokThreads) sIn[i] = E::round(sX[i]);
  __syncthreads();
  tok_linear<T, NT, kC, kReluRound, kClWarps>(sIn, wt + kW1, bt + kB1, kMlp, sH, kMlp, 1.f, cw,
                                              lane);
  cluster.sync();
  gather<T, NT, kC, kCl>(cluster, sH, kMlp, kMlp, rank);
  cluster.sync();
  tok_linear<T, NT, kMlp, kPlain, kClWarps>(sH, wt + kW2, bt + kB2, kC, sTmp, kC, 1.f, cw, lane);
  cluster.sync();
  gather<T, NT, kMlp, kCl>(cluster, sTmp, kC, kC, rank);
  cluster.sync();
  for (int i = tid; i < NT * kC; i += kTokThreads) sX[i] += sTmp[i];
  __syncthreads();
  tok_layer_norm<NT>(sX, bt + kLn3S, bt + kLn3B, eps, warp, lane);
  __syncthreads();
  for (int i = tid; i < NT * kC; i += kTokThreads) {
    sIn[i] = E::round(sX[i] + sPe[i]);
    sTmp[i] = E::round(sX[i]);
    if (rank == 0) tok_put(tokens_out + tbase + i, sX[i]);
  }
  __syncthreads();
  tok_linear<T, NT, kC, kRound, kClWarps>(sIn, wt + kWkI, bt + kBkI, kI, sH, kI, 1.f, cw, lane);
  tok_linear<T, NT, kC, kRound, kClWarps>(sTmp, wt + kWvI, bt + kBvI, kI, sH + NT * kI, kI, 1.f,
                                          cw, lane);
  __syncthreads();
  for (int i = tid; i < NT * kI; i += kTokThreads) {
    if (owner<T, kC, kCl>(i % kI) != rank) continue;
    k_out[static_cast<int64_t>(cand) * NT * kI + i] = E::put(sH[i]);
    v_out[static_cast<int64_t>(cand) * NT * kI + i] = E::put(sH[NT * kI + i]);
  }
}

template <typename T, int NT>
int tokens_mid(const void* x_in, const void* qpe, const void* part_m, const void* part_l,
               const void* part_acc, int tiles, const void* wt, const void* bt, float eps, int n,
               void* tokens_out, void* k_out, void* v_out, cudaStream_t stream) {
  static int raised[wg::kMaxDevices] = {};
  auto kernel = twl_tokens_mid_cluster_kernel<T, NT>;
  constexpr int smem = smem_tokens_mid<NT>();
  cudaError_t err = wg::raise_shared_memory(reinterpret_cast<const void*>(kernel), smem, raised);
  if (err != cudaSuccess) return err;
  kernel<<<n * kCl, kTokThreads, smem, stream>>>(
      static_cast<const float*>(x_in), static_cast<const T*>(qpe),
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), tiles, static_cast<const T*>(wt),
      static_cast<const float*>(bt), eps, static_cast<T*>(tokens_out), static_cast<T*>(k_out),
      static_cast<T*>(v_out));
  return cudaGetLastError();
}

}  // namespace

extern "C" int cor_twl_tokens_mid(const void* x_in, const void* qpe, const void* part_m,
                                  const void* part_l, const void* part_acc, int tiles,
                                  const void* wt, const void* bt, float eps, int n, int n_tok,
                                  void* tokens_out, void* k_out, void* v_out, int f32,
                                  void* stream);

// cor_twl_tokens_mid's arguments (two_way_layer_mid.cu); the same outputs,
// bit for bit: over clusters while they all fit at once, else by
// cor_twl_tokens_mid itself.
extern "C" int cor_twl_tokens_mid_cluster(const void* x_in, const void* qpe, const void* part_m,
                                          const void* part_l, const void* part_acc, int tiles,
                                          const void* wt, const void* bt, float eps, int n,
                                          int n_tok, void* tokens_out, void* k_out,
                                          void* v_out, int f32, void* stream) {
  if (n < 1 || n > 65535 || tiles < 1) return cudaErrorInvalidValue;
  if (!twl::cluster_fits(n))
    return cor_twl_tokens_mid(x_in, qpe, part_m, part_l, part_acc, tiles, wt, bt, eps, n, n_tok,
                              tokens_out, k_out, v_out, f32, stream);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_tokens(n_tok, [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    return f32 ? tokens_mid<float, NT>(x_in, qpe, part_m, part_l, part_acc, tiles, wt, bt, eps,
                                       n, tokens_out, k_out, v_out, s)
               : tokens_mid<uint16_t, NT>(x_in, qpe, part_m, part_l, part_acc, tiles, wt, bt,
                                          eps, n, tokens_out, k_out, v_out, s);
  });
}
