// K1-stack and K1-grid: the whole depth-2 two-way transformer of the SAM
// mask decoder (both TwoWayAttentionBlocks, the final token -> image
// attention and norm_final) as one kernel launch, over n candidates.
//
// Replaces the TPU kernels cor_tpu/ops/pallas/two_way_layer.py:
//  - two_way_stack_fused (_stack_kernel; its pallas_calls at lines 1236 and
//    1250): the whole stack in one body per group of candidates, the
//    inter-layer keys in a VMEM scratch, the token state fp32 from layer 1
//    through norm_final;
//  - two_way_grid_fused (_grid_kernel; lines 1135 and 1148): the same
//    function with the layer as an inner grid axis, the token state rounded
//    to the compute dtype between the layers (the revisited tokens block)
//    and kept fp32 from layer 2 into the final attention.
// On the TPU both keep a candidate group's keys in VMEM across the layers so
// that they cross HBM once in and once out. On the H100 a candidate's two
// passes over its 4,096 rows each need the whole token side first, so the
// kernel runs ten stages, each K1's or K2's stage body over its work items,
// with a barrier between stages:
//
//   layer 1: tokens_in (per candidate), t2i image pass (per 64-row tile and
//            candidate), tokens_mid (per candidate), i2t image pass (per
//            tile);
//   layer 2: the same four; its tokens_mid also computes the final
//            attention's query from the fp32 state;
//   the final image pass (per tile, K2's), and the final combine,
//   out-projection, residual and norm_final (per candidate).
//
// The inter-stage tensors go through device memory (L2 keeps what it can):
// the fp32 token state, the queries, q_img, the flash partials, the tokens'
// keys and values, and the keys after each layer; every buffer is written by
// one stage and read by later ones only, each layer with its own, so that no
// SM reads a line it could have cached before the write.
//
//  - K1-stack (cluster == 0): one cooperative launch
//    (cudaLaunchCooperativeKernel) of the co-resident CTAs, each stage a
//    grid-stride loop over its work items, cooperative_groups'
//    this_grid().sync() between stages. The token state stays fp32
//    between the layers, as _stack_kernel keeps it, so its tokens and
//    its keys after layer 2 differ from K1 + K2's; its keys after layer 1
//    are one K1 launch's.
//  - K1-grid (cluster == 1): candidate-major, a thread-block cluster of 8
//    CTAs per candidate (cudaLaunchKernelEx with a cluster dimension), each
//    CTA taking every 8th of the candidate's 64 row tiles and rank 0 the
//    token stages, this_cluster().sync() (barrier.cluster, release/acquire)
//    between stages: candidates run independently, with no co-residency
//    limit on n, each walking its layers in order with its keys L2-hot.
//    The tokens leave layer 1 rounded, as K1's do, so its keys after
//    layer 2 (its output) are two K1 launches' bit for bit.
//
// Both run 4-warp CTAs (the image passes' shape; the token stages run K1's
// token bodies with 4 warps, the same sums), in dynamic shared memory sized
// for the largest stage (bf16 107,520 B at T = 8: two CTAs per SM; fp32
// 205,824 B: one). What bounds them on the H100: per candidate two layers'
// image passes and the final pass read ~10 MiB and write ~7 MiB in bf16 and
// do ~2.7 GFLOP on the tensor cores, near the ridge; the token stages run on
// one CTA per candidate while the others wait at the barrier. Keeping a
// candidate's keys in the cluster's shared memory across the layers, wgmma
// and warp specialisation are later work.
#pragma once

#include <cooperative_groups.h>

#include "i2t_attention.cuh"
#include "t2i_flash.cuh"
#include "two_way_tokens.cuh"

namespace cor {

constexpr int kFusedWarps = kImgThreads / 32;
constexpr int kClusterCtas = 8;

// One layer's weights (the packs of ops/kernels/two_way_layer.py) and its
// PE projections [N][kI] (t2i.k_proj and i2t.q_proj of the image PE).
struct FusedLayer {
  const void* wtok;
  const float* btok;
  const void* w_img;
  const float* b_img;
  const void* wo_i;
  const float* bo_ln4;
  const void* kpe;
  const void* qpe_img;
};

struct FusedArgs {
  int n, N, S, cluster;  // cluster: K1-grid (else K1-stack)
  float self_scale, cross_scale, eps;
  const void* tokens;   // T [n][NT][kC]: the point embeddings
  const void* qpe_tok;  // T [n][NT][kC]
  const void* src;      // T [S][N][kC] rows, store row idx[b] (or b) for candidate b
  const int* idx;
  FusedLayer layer[2];
  // the final attention: kpe_f [N][kI]; wkv [k | v][kC] (T), bkv fp32 [2 kI];
  // wq [kI][kC] | wo [kC][kI] (T); bq [kI] | bo [kC] | norm_final scale, bias
  const void* kpe_f;
  const void* wkv;
  const float* bkv;
  const void* wfin;
  const float* bfin;
  // per-stage buffers
  float* x_mid[2];    // fp32 [n][NT][kC]: after LN1
  float* x_state[2];  // fp32 [n][NT][kC]: after each layer
  void* qt[3];        // T [n][NT][kI]: layer 1, layer 2, final
  void* q_img[2];     // T [n][N][kI]
  float* part_m[3];   // fp32 [n][N/64][8 NT]
  float* part_l[3];
  float* part_acc[3];  // fp32 [n][N/64][8 NT][16]
  void* k_i[2];       // T [n][NT][kI]
  void* v_i[2];
  void* keys1;        // T [n][N][kC]: after layer 1
  void* keys_out;     // T [n][N][kC]: after layer 2
  void* tokens_out;   // T [n][NT][kC]
};

template <typename T, int NT>
__host__ __device__ constexpr size_t smem_fused() {
  size_t m = smem_image<T>(NT);
  m = smem_i2t<T>(NT) > m ? smem_i2t<T>(NT) : m;
  m = smem_tokens_in<NT>() > m ? smem_tokens_in<NT>() : m;
  m = smem_tokens_mid<NT>() > m ? smem_tokens_mid<NT>() : m;
  return smem_final_tokens<NT>() > m ? smem_final_tokens<NT>() : m;
}

// The work items of a stage and the barrier between stages, by mode.
struct FusedSched {
  int n, tiles, cluster;
  // a token stage: f(candidate)
  template <typename F>
  __device__ __forceinline__ void tokens(F f) const {
    if (cluster) {
      if (blockIdx.x % kClusterCtas == 0) f(blockIdx.x / kClusterCtas);
      return;
    }
    for (int c = blockIdx.x; c < n; c += gridDim.x) {
      f(c);
      __syncthreads();  // the block's shared memory free for the next item
    }
  }
  // an image stage: f(tile, candidate)
  template <typename F>
  __device__ __forceinline__ void rows(F f) const {
    if (cluster) {
      const int c = blockIdx.x / kClusterCtas;
      for (int t = blockIdx.x % kClusterCtas; t < tiles; t += kClusterCtas) {
        f(t, c);
        __syncthreads();
      }
      return;
    }
    for (int i = blockIdx.x; i < n * tiles; i += gridDim.x) {
      f(i % tiles, i / tiles);
      __syncthreads();
    }
  }
  __device__ __forceinline__ void sync() const {
    if (cluster)
      cooperative_groups::this_cluster().sync();
    else
      cooperative_groups::this_grid().sync();
  }
};

// The stages, each a function of its own (__noinline__: ptxas then
// allocates each stage's registers apart, which keeps the build short), on
// the kernel's dynamic shared memory.
extern __shared__ __align__(16) unsigned char fused_smem[];

template <typename T, int NT, typename TIn>
__device__ __noinline__ void fused_tokens_in(const TIn* tokens, bool round_in, const T* qpe,
                                             const T* wt, const float* bt, int skip_pe,
                                             float self_scale, float cross_scale, float eps,
                                             float* x_out, T* qt_out, int cand) {
  tokens_in_body<T, NT, kFusedWarps, TIn>(fused_smem, tokens, round_in, qpe, wt, bt, skip_pe,
                                          self_scale, cross_scale, eps, x_out, qt_out, cand);
}

// tokens_mid into the fp32 state; with wq (layer 2), then the final
// attention's query from that state
template <typename T, int NT>
__device__ __noinline__ void fused_tokens_mid(const float* x_in, const T* qpe, const float* pm,
                                              const float* pl, const float* pa, int tiles,
                                              const T* wt, const float* bt, float eps,
                                              float* x_out, T* k_out, T* v_out, const T* wq,
                                              const float* bq, float cross_scale, T* qt_out,
                                              int cand) {
  tokens_mid_body<T, NT, kFusedWarps, float, false>(fused_smem, x_in, qpe, pm, pl, pa, tiles, wt,
                                                    bt, eps, x_out, k_out, v_out, cand);
  if (wq != nullptr) {
    __syncthreads();  // the block's writes of the state seen by the block
    final_query_body<T, NT, kFusedWarps>(fused_smem, x_out, qpe, wq, bq, cross_scale, qt_out,
                                         cand);
  }
}

template <typename T, int NT>
__device__ __noinline__ void fused_final_tokens(const float* x_in, const float* pm,
                                                const float* pl, const float* pa, int tiles,
                                                const T* wo, const float* bo, const float* nf,
                                                float eps, T* tokens_out, int cand) {
  final_tokens_body<T, NT, kFusedWarps>(fused_smem, x_in, pm, pl, pa, tiles, wo, bo, nf, eps,
                                        tokens_out, cand);
}

template <typename T, bool kEmitQ>
__device__ __noinline__ void fused_t2i_tile(const void* src, const int* idx, int S, int N,
                                            const T* w, const float* b, const T* kpe,
                                            const T* qpe, const T* qt, int nt, T* q_img,
                                            float* pm, float* pl, float* pa, int tile,
                                            int tiles, int cand) {
  t2i_tile<T, false, kEmitQ>(fused_smem, src, idx, nullptr, S, N, w, b, kpe, qpe, qt, nt, q_img,
                             pm, pl, pa, tile, tiles, cand);
}

template <typename T>
__device__ __noinline__ void fused_i2t_tile(const void* src, const int* idx, int S, int N,
                                            const T* q_img, const T* k_i, const T* v_i, int nt,
                                            const T* wo, const float* bo_ln, float eps,
                                            float cross_scale, T* out, int tile, int cand) {
  i2t_tile<T, false>(fused_smem, src, idx, nullptr, S, N, q_img, k_i, v_i, nt, wo, bo_ln, eps,
                     cross_scale, out, tile, cand);
}

template <typename T, int NT>
__global__ void __launch_bounds__(kImgThreads) two_way_fused_kernel(const FusedArgs a) {
  const int tiles = a.N / kRows;
  const FusedSched s{a.n, tiles, a.cluster};
  const T* qpe = static_cast<const T*>(a.qpe_tok);
  const T* wfin = static_cast<const T*>(a.wfin);
  // (a layer's buffers picked by selects: a dynamic index into the kernel's
  // parameters would copy them to local memory)
#pragma unroll 1
  for (int l = 0; l < 2; ++l) {
    const bool l0 = l == 0;
    const FusedLayer w = l0 ? a.layer[0] : a.layer[1];
    const T* wtok = static_cast<const T*>(w.wtok);
    // layer 1 reads the rows (store rows through idx), layer 2 the keys after layer 1
    const void* rows = l0 ? a.src : a.keys1;
    const int* idx = l0 ? a.idx : nullptr;
    const int S = l0 ? a.S : a.n;
    T* qt = static_cast<T*>(l0 ? a.qt[0] : a.qt[1]);
    T* q_img = static_cast<T*>(l0 ? a.q_img[0] : a.q_img[1]);
    T* k_i = static_cast<T*>(l0 ? a.k_i[0] : a.k_i[1]);
    T* v_i = static_cast<T*>(l0 ? a.v_i[0] : a.v_i[1]);
    float* x_mid = l0 ? a.x_mid[0] : a.x_mid[1];
    float* x_state = l0 ? a.x_state[0] : a.x_state[1];
    float* pm = l0 ? a.part_m[0] : a.part_m[1];
    float* pl = l0 ? a.part_l[0] : a.part_l[1];
    float* pa = l0 ? a.part_acc[0] : a.part_acc[1];
    T* keys = static_cast<T*>(l0 ? a.keys1 : a.keys_out);
    s.tokens([&](int c) {
      if (l0)
        fused_tokens_in<T, NT, T>(static_cast<const T*>(a.tokens), false, qpe, wtok, w.btok, 1,
                                  a.self_scale, a.cross_scale, a.eps, x_mid, qt, c);
      else
        fused_tokens_in<T, NT, float>(a.x_state[0], a.cluster != 0, qpe, wtok, w.btok, 0,
                                      a.self_scale, a.cross_scale, a.eps, x_mid, qt, c);
    });
    s.sync();
    s.rows([&](int tile, int c) {
      fused_t2i_tile<T, true>(rows, idx, S, a.N, static_cast<const T*>(w.w_img), w.b_img,
                              static_cast<const T*>(w.kpe), static_cast<const T*>(w.qpe_img), qt,
                              NT, q_img, pm, pl, pa, tile, tiles, c);
    });
    s.sync();
    s.tokens([&](int c) {
      fused_tokens_mid<T, NT>(x_mid, qpe, pm, pl, pa, tiles, wtok, w.btok, a.eps, x_state, k_i,
                              v_i, l0 ? nullptr : wfin, a.bfin, a.cross_scale,
                              static_cast<T*>(a.qt[2]), c);
    });
    s.sync();
    s.rows([&](int tile, int c) {
      fused_i2t_tile<T>(rows, idx, S, a.N, q_img, k_i, v_i, NT, static_cast<const T*>(w.wo_i),
                        w.bo_ln4, a.eps, a.cross_scale, keys, tile, c);
    });
    s.sync();
  }
  s.rows([&](int tile, int c) {
    fused_t2i_tile<T, false>(a.keys_out, nullptr, a.n, a.N, static_cast<const T*>(a.wkv), a.bkv,
                             static_cast<const T*>(a.kpe_f), nullptr,
                             static_cast<const T*>(a.qt[2]), NT, nullptr, a.part_m[2],
                             a.part_l[2], a.part_acc[2], tile, tiles, c);
  });
  s.sync();
  s.tokens([&](int c) {
    fused_final_tokens<T, NT>(a.x_state[1], a.part_m[2], a.part_l[2], a.part_acc[2], tiles,
                              wfin + kI * kC, a.bfin + kI, a.bfin + kI + kC, a.eps,
                              static_cast<T*>(a.tokens_out), c);
  });
}

// Launch the fused transformer: a cluster grid (K1-grid) or a cooperative
// grid of the co-resident CTAs (K1-stack). A launch the card refuses (too
// much shared memory, no cooperative launch) returns its error.
template <typename T, int NT>
int launch_fused(const FusedArgs& a, cudaStream_t stream) {
  auto kernel = two_way_fused_kernel<T, NT>;
  constexpr size_t smem = smem_fused<T, NT>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  FusedArgs args = a;
  if (a.cluster) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kClusterCtas * a.n);
    cfg.blockDim = dim3(kImgThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kClusterCtas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    err = cudaLaunchKernelEx(&cfg, kernel, args);
  } else {
    int dev = 0, coop = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
      return err;
    if (!coop) return cudaErrorNotSupported;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kImgThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const int items = a.n * (a.N / kRows);
    const int grid = per_sm * sms < items ? per_sm * sms : items;
    void* params[] = {&args};
    err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                      dim3(kImgThreads), params, smem, stream);
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// launch_fused<T, NT> is instantiated in one file per token count
// (two_way_stack_t{5,6,7,8}.cu, bf16 and fp32 in each), which nvcc compiles
// in parallel; two_way_stack.cu holds the C entry.
#define COR_FUSED_INSTANCES(X) \
  X(uint16_t, 5) X(float, 5) X(uint16_t, 6) X(float, 6) X(uint16_t, 7) X(float, 7) \
  X(uint16_t, 8) X(float, 8)

}  // namespace cor
