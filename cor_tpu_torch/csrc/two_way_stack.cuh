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
// kernel runs ten stages with a barrier between stages:
//
//   layer 1: tokens_in (per candidate), the t2i pass (per item of 64-row
//            tiles), tokens_mid (per candidate), the i2t pass (per item);
//   layer 2: the same four; its tokens_mid also computes the final
//            attention's query from the fp32 state;
//   the final t2i pass (k and v only), and the final combine,
//   out-projection, residual and norm_final (per candidate).
//
// The image stages are K1's and K2's passes redesigned for Hopper, the same
// bodies as cor_twl_t2i, cor_twl_i2t and cor_t2i_final run: the layer's t2i
// pass with its q chunk (twl_t2i.cuh, t2i_pass<T, kInt8 = false, kQ = true,
// kFold = false>), K1's i2t pass (twl_i2t.cuh), and the t2i pass without the
// q chunk for the final attention (kQ = false, kFold = false: K2's products
// and partials, combined by the last token stage). Each is persistent over
// the items its schedule hands it, on wgmma behind TMA-fed weight rings, so
// the kernel is one 384-thread CTA an SM: a producer warpgroup and two
// consumer warpgroups, the passes' own shape. fp32's t2i pass has one
// consumer warpgroup (T2iL<float>::kGroups = 1); a second would need a
// second [64][260] fp32 row tile and k and v tiles (another ~133 KB, beyond
// 232,448 B), so the second warpgroup idles through that stage.
//
// The token stages run on all twelve warps of the CTA (K1's bodies of
// two_way_tokens.cuh rewritten for several CTAs, the same sums: each output
// column of a linear summed by one warp in its order, whatever the number of
// warps), and a candidate's token stages are split over a team of CTAs: the
// columns of every linear over the team's warps, the combine of the image
// pass's partials by output column over the CTAs, the columns the other CTAs
// computed read through distributed shared memory (DSMEM), 16 bytes a load;
// the attention, residuals and LayerNorms, cheap, run whole in every CTA on
// the same inputs. The combine keeps cor_t2i_combine's order per output (the
// max over the tiles, l and acc summed over them in order), 32 tiles' loads
// in flight a thread. A team barrier follows a gather only where a CTA
// writes the gathered buffer again before the next one.
//
//  - K1-grid (mode 1): candidate-major, one thread-block cluster per
//    candidate (cudaLaunchKernelEx with a cluster dimension): each CTA takes
//    every cl-th item of its candidate's image stages and the cluster is the
//    team; barrier.cluster (release/acquire) between stages. Candidates run
//    independently, with no co-residency limit on n: clusters beyond the
//    resident ones start as others finish. The tokens leave layer 1 rounded,
//    as K1's do, so its keys after layer 2 (its output) are two K1
//    launches' bit for bit.
//  - K1-stack (mode 0): one cooperative launch of the co-resident CTAs, one
//    an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor, or the resident
//    clusters), each image stage a persistent pass over every candidate's
//    items, a grid barrier (cooperative_groups' this_grid().sync()) between
//    stages; the candidates of a token stage go round the teams, a team
//    barrier between two. Of the three ways to split its token stages (a
//    cooperative launch that carries a cluster dimension too, the split
//    through device memory between grid barriers, K1's one-CTA kernels) it
//    takes the first: the token stages are then K1-grid's, and the H100
//    takes the pair of attributes. The token state stays fp32 between the
//    layers, as _stack_kernel keeps it.
//
// Cluster sizes (cl CTAs a candidate's team, 1 to 8): chosen at launch by
// choose_cluster below from cudaOccupancyMaxActiveClusters' resident
// clusters of each size (15 of 8, 30 of 4, 66 of 2 on the H100), following
// cluster_sweep's times by size (PERF.md §6): K1-stack 8 at 3
// candidates, 2 at 40, 1 at 128; K1-grid 2 at 40 in bf16, 8 in fp32, 1 at
// 128.
//
// Shared memory is one union of the stages, each laid out from offset 0:
// the t2i pass with its q chunk 228,944 B in bf16 and 222,800 in fp32 at T =
// 8 (the largest), the final t2i pass 512 B less, the i2t pass 220,288 and
// 220,256, tokens_mid 98,304, tokens_in 59,392. Each pass initialises its
// mbarriers and the kernel invalidates them (mbarrier.inval) once the pass
// is done, before another stage puts data in their words; every thread
// fences the async proxy (fence.proxy.async.shared::cta) before each stage
// barrier, so that the TMA bulk writes of a later stage follow the generic
// stores of an earlier one.
//
// Registers: the launch gives 168 a thread (65,536 / 384). Inlined into one
// kernel function, the passes and token stages spilled several KB (ptxas
// keeps the stages' values around each pass), so the token stages and the
// t2i passes, and fp32's i2t pass, are functions of their own (__noinline__)
// at 168 registers: there the fp32 t2i producer holds kFusedFetch = 2 weight
// blocks in flight (K1's 4 spilled) and its consumers read the PE values
// after the products. bf16's i2t pass runs inline and moves registers with
// setmaxnreg as K1's does (producer 40, consumers 232: at 168 its epilogue
// spills), then hands them back before it returns (kRestore: the consumers'
// .dec first, then, after a named barrier, the producer's .inc: without the
// barrier a producer with no items could take its registers back before the
// consumers' .inc, which would then wait for ever), so every other stage
// runs at 168.
//
// Memory between stages: the inter-stage tensors go through device memory
// (L2 keeps what it can): the fp32 token state, the queries, q_img, the
// flash partials, the tokens' keys and values, and the keys after each
// layer. The passes read with __ldg (ld.global.nc) and cp.async under L2
// hints; that is safe because every buffer is written by one stage and read
// by later ones only, each layer with its own, so that no SM reads a line it
// could have cached before the write.
//
// What bounds it on the H100: per candidate two layers' image passes and
// the final pass read ~10 MiB and write ~7 MiB in bf16 and do ~2.7 GFLOP on
// the tensor cores, near the ridge (PERF.md §6 has the bound by shape); what
// the card spends beyond that is the passes' own (their attention
// arithmetic, the producer's split in fp32, fp32's passes at 168 registers
// where K1's own run at 255 and 184), the token stages' chains of dependent
// L2 loads between DSMEM gathers (cluster_sweep's times put them and the
// barriers at ~0.3 ms a candidate in bf16, whatever the team size), and the
// barriers between stages, at which the CTAs that finished first wait for
// the last.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "two_way_tokens.cuh"
#include "twl_cluster.cuh"
#include "twl_i2t.cuh"
#include "twl_t2i.cuh"

namespace cor {
namespace stack {

namespace cg = cooperative_groups;

constexpr int kThreads = 384;  // a producer warpgroup and two consumer warpgroups
constexpr int kWarps = kThreads / 32;
// the t2i passes' fp32 weight blocks in flight a producer thread (K1's 4
// spilled at 168 registers; the PE values are read after the products, not
// under them: the same sums)
constexpr int kFusedFetch = 2;
static_assert(kThreads == i2t_hopper::kGroups * 128 + i2t_hopper::kProd &&
                  kThreads >= t2i_hopper::T2iL<uint16_t>::kGroups * 128 + t2i_hopper::kProd &&
                  kThreads >= t2i_hopper::T2iL<float>::kGroups * 128 + t2i_hopper::kProd,
              "the passes' warpgroups in one block");

// One layer's weights (the packs of ops/kernels/two_way_layer.py), its PE
// projections [N][kI] (t2i.k_proj and i2t.q_proj of the image PE), and in
// bf16 the image passes' weights laid out as their rings' blocks
struct FusedLayer {
  const void* wtok;
  const float* btok;
  const void* w_img;
  const float* b_img;
  const void* wo_i;
  const float* bo_ln4;
  const void* kpe;
  const void* qpe_img;
  const void* w_img_blocks;
  const void* wo_i_blocks;
};

struct FusedArgs {
  int n, N, S;
  int grid;  // 1: K1-grid, 0: K1-stack
  int cl;    // the CTAs of a candidate's team (the cluster's size, or 1)
  float self_scale, cross_scale, eps;
  const void* tokens;   // T [n][NT][kC]: the point embeddings
  const void* qpe_tok;  // T [n][NT][kC]
  const void* src;      // T [S][N][kC] rows, store row idx[b] (or b) for candidate b
  const int* idx;
  FusedLayer layer[2];
  // the final attention: kpe_f [N][kI]; wkv [k | v][kC] (T), bkv fp32 [2 kI];
  // wq [kI][kC] | wo [kC][kI] (T); bq [kI] | bo [kC] | norm_final scale, bias;
  // wkv_blocks: wkv as K2's ring blocks (bf16)
  const void* kpe_f;
  const void* wkv;
  const float* bkv;
  const void* wfin;
  const float* bfin;
  const void* wkv_blocks;
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

// the final token stage's fp32 buffers: the state, the combined attention
// and the out-projection's output, [NT][kC] each
template <int NT>
__host__ __device__ constexpr size_t smem_final_tokens() {
  return sizeof(float) * 3 * NT * kC;
}

// the dynamic shared memory of the kernel at NT tokens: the largest stage's
template <typename T, int NT>
__host__ __device__ constexpr size_t smem_fused() {
  const size_t s[] = {static_cast<size_t>(t2i_hopper::T2iSmem<T, true, false>::bytes(NT)),
                      static_cast<size_t>(t2i_hopper::T2iSmem<T, false, false>::bytes(NT)),
                      static_cast<size_t>(i2t_hopper::I2tSmem<T, false>::kBytes),
                      smem_tokens_in<NT>(), smem_tokens_mid<NT>(), smem_final_tokens<NT>()};
  size_t m = 0;
  for (size_t v : s) m = v > m ? v : m;
  return m;
}

// ---------------------------------------------------------------------------
// the token stages over a team of CTAs
// ---------------------------------------------------------------------------

// The CTAs that share a candidate's token stage: a cluster of `size`, or
// the CTA alone (size 1)
struct Team {
  int size, rank;
  __device__ __forceinline__ void sync() const {
    if (size > 1)
      cg::this_cluster().sync();
    else
      __syncthreads();
  }
};

// the CTA whose warp computes output column j of a linear of input width K
// (tok_linear's assignment over nw warps, kWarps a CTA)
template <typename T, int K>
struct LinearOwner {
  int nw;
  __device__ __forceinline__ int operator()(int j) const {
    return (j / twl::cols_at_a_time<T, K>()) % nw / kWarps;
  }
};
// the CTA that combines output column j (of kI) of the image pass's
// partials: contiguous runs of `per` columns
struct CombineOwner {
  int per;
  __device__ __forceinline__ int operator()(int j) const { return j / per; }
};

// Copy into this CTA's buf [NT][ld] the columns j < O that the team's other
// CTAs computed (owner(j) != rank), through DSMEM, kV columns a load (each
// run of kV columns from j = 0 has one owner; ld and O multiples of 4), four
// loads in flight a thread: every load is made (an index past the end reads
// the last chunk again, a chunk of this CTA's its own copy) and only the
// stores are predicated, so that the loaded values stay in registers. The
// caller syncs the team before (every CTA's columns written) and syncs it
// again before any CTA writes buf anew (every CTA's reads done); where buf
// is not written again before the next team barrier, a block barrier
// after the gather suffices.
template <int NT, int kV, typename Owner>
__device__ __forceinline__ void gather(const Team& tm, float* buf, int ld, int O, Owner owner) {
  using Vec = typename std::conditional<
      kV == 4, float4, typename std::conditional<kV == 2, float2, float>::type>::type;
  if (tm.size == 1) return;
  cg::cluster_group cluster = cg::this_cluster();
  const int per_row = O / kV, total = NT * per_row;
  constexpr int kU = 4;
  for (int i0 = threadIdx.x; i0 < total; i0 += kU * kThreads) {
    Vec v[kU];
    int off[kU], r[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = min(i0 + u * kThreads, total - 1);
      off[u] = (i / per_row) * ld + (i % per_row) * kV;
      r[u] = owner(off[u] - (i / per_row) * ld);
      v[u] = *reinterpret_cast<const Vec*>(cluster.map_shared_rank(buf, r[u]) + off[u]);
    }
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (i0 + u * kThreads < total && r[u] != tm.rank)
        *reinterpret_cast<Vec*>(buf + off[u]) = v[u];
  }
}
// a linear's columns (of input width K): runs of tok_linear's columns at a time
template <typename T, int K>
constexpr int kRun = twl::cols_at_a_time<T, K>();

// The flash partials of query q (of nq), channel d, merged over the `tiles`
// row tiles of one candidate (tile j at base + j), in combine_partials'
// arithmetic and order (the max over the tiles; l and acc summed over them
// in order, each tile's term scaled by exp(m_j - m)): the same bits, with
// kB tiles' loads issued before their terms (a candidate's 64 tiles in
// four round trips to L2). The partials come from L2
// (__ldcg): this launch wrote them.
__device__ __forceinline__ float combine_ordered(const float* __restrict__ part_m,
                                                 const float* __restrict__ part_l,
                                                 const float* __restrict__ part_acc,
                                                 int64_t base, int tiles, int nq, int q, int d) {
  constexpr int kB = 32;
  float m = -INFINITY;
#pragma unroll 1
  for (int j0 = 0; j0 < tiles; j0 += kB) {
    float v[kB];
#pragma unroll
    for (int k = 0; k < kB; ++k)
      v[k] = j0 + k < tiles ? __ldcg(part_m + (base + j0 + k) * nq + q) : -INFINITY;
#pragma unroll
    for (int k = 0; k < kB; ++k) m = fmaxf(m, v[k]);
  }
  float l = 0.f, acc = 0.f;
#pragma unroll 1
  for (int j0 = 0; j0 < tiles; j0 += kB) {
    float mv[kB], lv[kB], av[kB];
#pragma unroll
    for (int k = 0; k < kB; ++k) {
      const int64_t pq = (base + (j0 + k < tiles ? j0 + k : 0)) * nq + q;
      mv[k] = __ldcg(part_m + pq);
      lv[k] = __ldcg(part_l + pq);
      av[k] = __ldcg(part_acc + pq * kCrossD + d);
    }
#pragma unroll
    for (int k = 0; k < kB; ++k) {
      if (j0 + k >= tiles) break;
      const float a = expf(mv[k] - m);
      l += lv[k] * a;
      acc += av[k] * a;
    }
  }
  return acc / l;
}

// This CTA's share of the combine of candidate cand's partials into sIn
// [NT][kI] (rounded to T), then the team's other columns gathered
template <typename T, int NT>
__device__ __forceinline__ void combine_split(const Team& tm, float* sIn, const float* pm,
                                              const float* pl, const float* pa, int tiles,
                                              int cand) {
  const int per = kI / tm.size, c0 = tm.rank * per;
  const int64_t pbase = static_cast<int64_t>(cand) * tiles;
  for (int o = threadIdx.x; o < NT * per; o += kThreads) {
    const int tt = o / per, c = c0 + o % per, h = c / kCrossD, d = c % kCrossD;
    sIn[tt * kI + c] =
        Elem<T>::round(combine_ordered(pm, pl, pa, pbase, tiles, kHeads * NT, h * NT + tt, d));
  }
  tm.sync();
  gather<NT, 4>(tm, sIn, kI, kI, CombineOwner{per});
  // (no team barrier: sIn is not written again before the next one)
  __syncthreads();
}

// Stage 1 and the t2i query for candidate cand (tokens_in_body's function
// and sums): token self-attention (8 heads of 32; no PE and no residual with
// skip_pe), LN1, the t2i query scaled after its bias and rounded. tokens:
// TIn [n][NT][kC] (T, or the fp32 state, rounded to T on the way in with
// round_in); x_out: the fp32 state after LN1; qt_out: T [n][NT][kI].
template <typename T, int NT, typename TIn>
__device__ __forceinline__ void tokens_in_split(
    unsigned char* smem, const Team& tm, const TIn* __restrict__ tokens, bool round_in,
    const T* __restrict__ qpe, const T* __restrict__ wt, const float* __restrict__ bt,
    int skip_pe, float self_scale, float cross_scale, float eps, float* __restrict__ x_out,
    T* __restrict__ qt_out, int cand) {
  using E = Elem<T>;
  float* sX = reinterpret_cast<float*>(smem);
  float* sPe = sX + NT * kC;
  float* sIn = sPe + NT * kC;
  float* sIn2 = sIn + NT * kC;
  float* sQ = sIn2 + NT * kC;
  float* sK = sQ + NT * kC;
  float* sV = sK + NT * kC;
  float* sL = sV + NT * kC;  // [kHeads * NT * NT] logits, then probabilities
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cw = tm.rank * kWarps + warp, nw = tm.size * kWarps;  // this warp among the team's
  const int64_t tbase = static_cast<int64_t>(cand) * NT * kC;
  for (int i = tid; i < NT * kC; i += kThreads) {
    float x = tok_get(tokens[tbase + i]);
    if (round_in) x = E::round(x);
    const float p = E::get(qpe[tbase + i]);
    sX[i] = x;
    sPe[i] = p;
    sIn[i] = E::round(skip_pe ? x : x + p);
    sIn2[i] = E::round(x);
  }
  __syncthreads();
  tok_linear<T, NT, kC, kRound, kWarps>(sIn, wt + kWqS, bt + kBqS, kC, sQ, kC, self_scale, cw,
                                        lane, nw);
  tok_linear<T, NT, kC, kRound, kWarps>(sIn, wt + kWkS, bt + kBkS, kC, sK, kC, 1.f, cw, lane, nw);
  tok_linear<T, NT, kC, kRound, kWarps>(sIn2, wt + kWvS, bt + kBvS, kC, sV, kC, 1.f, cw, lane,
                                        nw);
  tm.sync();
  const LinearOwner<T, kC> by_c{nw};
  gather<NT, kRun<T, kC>>(tm, sQ, kC, kC, by_c);
  gather<NT, kRun<T, kC>>(tm, sK, kC, kC, by_c);
  gather<NT, kRun<T, kC>>(tm, sV, kC, kC, by_c);
  tm.sync();
  for (int e = tid; e < kHeads * NT * NT; e += kThreads) {
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
  for (int o = tid; o < NT * kC; o += kThreads) {  // P V, heads merged
    const int tt = o / kC, c = o % kC, h = c / kSelfD;
    const float* p = sL + (h * NT + tt) * NT;
    float av = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) av += p[j] * sV[j * kC + c];
    sIn[o] = E::round(av);
  }
  __syncthreads();
  tok_linear<T, NT, kC, kPlain, kWarps>(sIn, wt + kWoS, bt + kBoS, kC, sQ, kC, 1.f, cw, lane, nw);
  tm.sync();
  gather<NT, kRun<T, kC>>(tm, sQ, kC, kC, by_c);
  __syncthreads();  // (sQ is not written again in this stage: the stage's end syncs the team)
  for (int i = tid; i < NT * kC; i += kThreads) sX[i] = skip_pe ? sQ[i] : sX[i] + sQ[i];
  __syncthreads();
  tok_layer_norm<NT, kWarps>(sX, bt + kLn1S, bt + kLn1B, eps, warp, lane);
  __syncthreads();
  for (int i = tid; i < NT * kC; i += kThreads) {
    if (tm.rank == 0) x_out[tbase + i] = sX[i];
    sIn[i] = E::round(sX[i] + sPe[i]);
  }
  __syncthreads();
  tok_linear<T, NT, kC, kRound, kWarps>(sIn, wt + kWqT, bt + kBqT, kI, sK, kI, cross_scale, cw,
                                        lane, nw);
  __syncthreads();
  for (int i = tid; i < NT * kI; i += kThreads)
    if (by_c(i % kI) == tm.rank) qt_out[static_cast<int64_t>(cand) * NT * kI + i] = E::put(sK[i]);
}

// The rest of stage 2, stage 3 and the i2t keys and values for candidate
// cand (tokens_mid_body's function and sums, the state fp32): the combine
// of the t2i partials, the t2i out-projection, LN2, the ReLU MLP (256 ->
// 2048 -> 256), LN3; the state into x_out, the i2t keys and values from it
// into k_out, v_out (T [n][NT][kI]); with wq (layer 2), the final
// attention's query round((round(x + qpe) Wq^T + bq) * cross_scale) into
// qt_out (the first port's final_query_body's sums).
template <typename T, int NT>
__device__ __forceinline__ void tokens_mid_split(
    unsigned char* smem, const Team& tm, const float* __restrict__ x_in,
    const T* __restrict__ qpe, const float* __restrict__ pm, const float* __restrict__ pl,
    const float* __restrict__ pa, int tiles, const T* __restrict__ wt,
    const float* __restrict__ bt, float eps, float* __restrict__ x_out, T* __restrict__ k_out,
    T* __restrict__ v_out, const T* __restrict__ wq, const float* __restrict__ bq,
    float cross_scale, T* __restrict__ qt_out, int cand) {
  using E = Elem<T>;
  float* sX = reinterpret_cast<float*>(smem);
  float* sPe = sX + NT * kC;
  float* sIn = sPe + NT * kC;
  float* sTmp = sIn + NT * kC;
  float* sH = sTmp + NT * kC;  // [NT][kMlp]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cw = tm.rank * kWarps + warp, nw = tm.size * kWarps;
  const int64_t tbase = static_cast<int64_t>(cand) * NT * kC;
  for (int i = tid; i < NT * kC; i += kThreads) {
    sX[i] = x_in[tbase + i];
    sPe[i] = E::get(qpe[tbase + i]);
  }
  combine_split<T, NT>(tm, sIn, pm, pl, pa, tiles, cand);
  tok_linear<T, NT, kI, kPlain, kWarps>(sIn, wt + kWoT, bt + kBoT, kC, sTmp, kC, 1.f, cw, lane,
                                        nw);
  tm.sync();
  gather<NT, kRun<T, kI>>(tm, sTmp, kC, kC, LinearOwner<T, kI>{nw});
  __syncthreads();  // (sTmp is next written after the next team barrier)
  for (int i = tid; i < NT * kC; i += kThreads) sX[i] += sTmp[i];
  __syncthreads();
  tok_layer_norm<NT, kWarps>(sX, bt + kLn2S, bt + kLn2B, eps, warp, lane);
  __syncthreads();
  for (int i = tid; i < NT * kC; i += kThreads) sIn[i] = E::round(sX[i]);
  __syncthreads();
  tok_linear<T, NT, kC, kReluRound, kWarps>(sIn, wt + kW1, bt + kB1, kMlp, sH, kMlp, 1.f, cw,
                                            lane, nw);
  tm.sync();
  gather<NT, kRun<T, kC>>(tm, sH, kMlp, kMlp, LinearOwner<T, kC>{nw});
  __syncthreads();  // (sH is next written after the next team barrier)
  tok_linear<T, NT, kMlp, kPlain, kWarps>(sH, wt + kW2, bt + kB2, kC, sTmp, kC, 1.f, cw, lane,
                                          nw);
  tm.sync();
  gather<NT, kRun<T, kMlp>>(tm, sTmp, kC, kC, LinearOwner<T, kMlp>{nw});
  tm.sync();
  for (int i = tid; i < NT * kC; i += kThreads) sX[i] += sTmp[i];
  __syncthreads();
  tok_layer_norm<NT, kWarps>(sX, bt + kLn3S, bt + kLn3B, eps, warp, lane);
  __syncthreads();
  for (int i = tid; i < NT * kC; i += kThreads) {
    sIn[i] = E::round(sX[i] + sPe[i]);
    sTmp[i] = E::round(sX[i]);
    if (tm.rank == 0) x_out[tbase + i] = sX[i];
  }
  __syncthreads();
  tok_linear<T, NT, kC, kRound, kWarps>(sIn, wt + kWkI, bt + kBkI, kI, sH, kI, 1.f, cw, lane, nw);
  tok_linear<T, NT, kC, kRound, kWarps>(sTmp, wt + kWvI, bt + kBvI, kI, sH + NT * kI, kI, 1.f,
                                        cw, lane, nw);
  // the final query's input round(x + qpe) is the keys' (sIn)
  if (wq != nullptr)
    tok_linear<T, NT, kC, kRound, kWarps>(sIn, wq, bq, kI, sH + 2 * NT * kI, kI, cross_scale, cw,
                                          lane, nw);
  __syncthreads();
  const LinearOwner<T, kC> by_c{nw};
  const int64_t obase = static_cast<int64_t>(cand) * NT * kI;
  for (int i = tid; i < NT * kI; i += kThreads) {
    if (by_c(i % kI) != tm.rank) continue;
    k_out[obase + i] = E::put(sH[i]);
    v_out[obase + i] = E::put(sH[NT * kI + i]);
    if (wq != nullptr) qt_out[obase + i] = E::put(sH[2 * NT * kI + i]);
  }
}

// The final attention's token side after its image pass, for candidate cand
// (the first port's final_tokens_body's sums): the combine of its partials
// (rounded), the out-projection wo [kC][kI] + bo, the residual with the fp32
// state x_in and norm_final (nf: scale [kC], bias [kC]) into tokens_out
// (T [n][NT][kC]).
template <typename T, int NT>
__device__ __forceinline__ void final_tokens_split(
    unsigned char* smem, const Team& tm, const float* __restrict__ x_in,
    const float* __restrict__ pm, const float* __restrict__ pl, const float* __restrict__ pa,
    int tiles, const T* __restrict__ wo, const float* __restrict__ bo,
    const float* __restrict__ nf, float eps, T* __restrict__ tokens_out, int cand) {
  using E = Elem<T>;
  float* sX = reinterpret_cast<float*>(smem);
  float* sIn = sX + NT * kC;
  float* sTmp = sIn + NT * kC;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cw = tm.rank * kWarps + warp, nw = tm.size * kWarps;
  const int64_t tbase = static_cast<int64_t>(cand) * NT * kC;
  for (int i = tid; i < NT * kC; i += kThreads) sX[i] = x_in[tbase + i];
  combine_split<T, NT>(tm, sIn, pm, pl, pa, tiles, cand);
  tok_linear<T, NT, kI, kPlain, kWarps>(sIn, wo, bo, kC, sTmp, kC, 1.f, cw, lane, nw);
  tm.sync();
  gather<NT, kRun<T, kI>>(tm, sTmp, kC, kC, LinearOwner<T, kI>{nw});
  tm.sync();
  for (int i = tid; i < NT * kC; i += kThreads) sX[i] += sTmp[i];
  __syncthreads();
  tok_layer_norm<NT, kWarps>(sX, nf, nf + kC, eps, warp, lane);
  __syncthreads();
  if (tm.rank == 0)
    for (int i = tid; i < NT * kC; i += kThreads) tokens_out[tbase + i] = E::put(sX[i]);
}

// The kernel's dynamic shared memory, named at namespace scope so that the
// stages below, each a function of its own (__noinline__: ptxas allocates
// its registers apart, see the header), address it as shared memory.
extern __shared__ __align__(128) unsigned char fused_smem[];

template <typename T, int NT, typename TIn>
__device__ __noinline__ void tokens_in_stage(Team tm, const TIn* tokens, bool round_in,
                                             const T* qpe, const T* wt, const float* bt,
                                             int skip_pe, float self_scale, float cross_scale,
                                             float eps, float* x_out, T* qt_out, int cand) {
  tokens_in_split<T, NT, TIn>(fused_smem, tm, tokens, round_in, qpe, wt, bt, skip_pe, self_scale,
                              cross_scale, eps, x_out, qt_out, cand);
}

template <typename T, int NT>
__device__ __noinline__ void tokens_mid_stage(Team tm, const float* x_in, const T* qpe,
                                              const float* pm, const float* pl, const float* pa,
                                              int tiles, const T* wt, const float* bt, float eps,
                                              float* x_out, T* k_out, T* v_out, const T* wq,
                                              const float* bq, float cross_scale, T* qt_out,
                                              int cand) {
  tokens_mid_split<T, NT>(fused_smem, tm, x_in, qpe, pm, pl, pa, tiles, wt, bt, eps, x_out, k_out,
                          v_out, wq, bq, cross_scale, qt_out, cand);
}

template <typename T, int NT>
__device__ __noinline__ void final_tokens_stage(Team tm, const float* x_in, const float* pm,
                                                const float* pl, const float* pa, int tiles,
                                                const T* wo, const float* bo, const float* nf,
                                                float eps, T* tokens_out, int cand) {
  final_tokens_split<T, NT>(fused_smem, tm, x_in, pm, pl, pa, tiles, wo, bo, nf, eps, tokens_out,
                            cand);
}

// The image passes that run in functions of their own, at the launch's 168
// registers: the t2i passes in both dtypes and fp32's i2t pass (no
// setmaxnreg); bf16's i2t pass runs inline (the header says why).
template <typename T, bool kQ>
__device__ __noinline__ void t2i_stage(const void* rows, const int* idx, int S, int n, int N,
                                       const T* w, const T* w_blocks, const float* b,
                                       const T* kpe, const T* qpe, const T* qt, int nt, T* q_img,
                                       float* pm, float* pl, float* pa, wg::GivenItems items) {
  t2i_hopper::t2i_pass<T, false, kQ, false, kThreads, kFusedFetch, false>(
      fused_smem, rows, idx, nullptr, S, n, N, w, w_blocks, b, kpe, qpe, qt, nt, q_img, pm, pl,
      pa, nullptr, nullptr, items);
}

template <typename T>
__device__ __noinline__ void i2t_stage(const void* rows, const int* idx, int S, int n, int N,
                                       const T* q_img, const T* k_i, const T* v_i, int nt,
                                       const T* wo, const T* wo_blocks, const float* bo_ln,
                                       float eps, float cross_scale, T* out,
                                       wg::GivenItems items) {
  i2t_hopper::i2t_pass<T, false, false, false, wg::GivenItems, false>(
      fused_smem, rows, idx, nullptr, S, n, N, q_img, k_i, v_i, nt, wo, wo_blocks, bo_ln, eps,
      cross_scale, out, items);
}

// ---------------------------------------------------------------------------
// the schedules
// ---------------------------------------------------------------------------

// The work items of a stage and the barrier between stages, by mode
struct Sched {
  int grid, n, cl;
  __device__ __forceinline__ Team team() const {
    return {cl, cl > 1 ? static_cast<int>(blockIdx.x % cl) : 0};
  }
  // a token stage: f(candidate, team), K1-grid's candidate, or K1-stack's
  // candidates round the teams
  template <typename F>
  __device__ __forceinline__ void tokens(F f) const {
    const Team tm = team();
    if (grid) {
      f(static_cast<int>(blockIdx.x) / cl, tm);
      return;
    }
    const int teams = gridDim.x / cl;
    for (int c = blockIdx.x / cl; c < n; c += teams) {
      f(c, tm);
      tm.sync();  // the team's shared memory free for the next candidate
    }
  }
  // an image stage's items, of per_cand items a candidate: every cl-th of
  // the cluster's candidate's (K1-grid), or every gridDim.x-th of all
  // (K1-stack)
  __device__ __forceinline__ wg::GivenItems items(int per_cand) const {
    if (grid) {
      const int c = blockIdx.x / cl, r = blockIdx.x % cl;
      return {{c * per_cand + r, static_cast<unsigned>(cl), (c + 1) * per_cand}};
    }
    return {{static_cast<int>(blockIdx.x), gridDim.x, n * per_cand}};
  }
  // the barrier between stages; every thread first orders its generic
  // shared-memory writes before a later stage's TMA bulk writes
  __device__ __forceinline__ void sync() const {
    wg::fence_proxy_async();
    if (!grid)
      cg::this_grid().sync();
    else if (cl > 1)
      cg::this_cluster().sync();
    else
      __syncthreads();
  }
};

// the end of a pass: once every thread is done, its mbarriers invalidated
__device__ __forceinline__ void end_pass(uint64_t* bars, int count) {
  __syncthreads();
  if (threadIdx.x == 0) wg::mbar_inval(bars, count);
}

// One two-way layer, L (0 or 1): its four stages. Every pointer is a field
// of the kernel's parameters at a constant index, read where it is used (a
// pointer picked at run time would stay in a register across the passes,
// which spilled).
template <typename T, int NT, int L>
__device__ __forceinline__ void fused_layer(unsigned char* smem, const FusedArgs& a,
                                            const Sched& s) {
  using i2t_hopper::i2t_pass;
  constexpr int G = t2i_hopper::T2iL<T>::kGroups, G4 = i2t_hopper::kGroups;
  const int tiles = a.N / kRows;
  const FusedLayer& w = a.layer[L];
  const T* qpe = static_cast<const T*>(a.qpe_tok);
  const T* wtok = static_cast<const T*>(w.wtok);
  // layer 1 reads the rows (store rows through idx), layer 2 the keys after layer 1
  const void* rows = L == 0 ? a.src : a.keys1;
  const int* idx = L == 0 ? a.idx : nullptr;
  const int S = L == 0 ? a.S : a.n;
  s.tokens([&](int c, const Team& tm) {
    if constexpr (L == 0)
      tokens_in_stage<T, NT, T>(tm, static_cast<const T*>(a.tokens), false, qpe, wtok, w.btok, 1,
                                a.self_scale, a.cross_scale, a.eps, a.x_mid[L],
                                static_cast<T*>(a.qt[L]), c);
    else
      tokens_in_stage<T, NT, float>(tm, a.x_state[0], a.grid != 0, qpe, wtok, w.btok, 0,
                                    a.self_scale, a.cross_scale, a.eps, a.x_mid[L],
                                    static_cast<T*>(a.qt[L]), c);
  });
  s.sync();
  t2i_stage<T, true>(rows, idx, S, a.n, a.N, static_cast<const T*>(w.w_img),
                     static_cast<const T*>(w.w_img_blocks), w.b_img, static_cast<const T*>(w.kpe),
                     static_cast<const T*>(w.qpe_img), static_cast<const T*>(a.qt[L]), NT,
                     static_cast<T*>(a.q_img[L]), a.part_m[L], a.part_l[L], a.part_acc[L],
                     s.items((tiles + G - 1) / G));
  end_pass(t2i_hopper::t2i_bars<T, true, false>(smem, NT), t2i_hopper::kT2iBars<T>);
  s.sync();
  s.tokens([&](int c, const Team& tm) {
    tokens_mid_stage<T, NT>(tm, a.x_mid[L], qpe, a.part_m[L], a.part_l[L], a.part_acc[L], tiles,
                            wtok, w.btok, a.eps, a.x_state[L], static_cast<T*>(a.k_i[L]),
                            static_cast<T*>(a.v_i[L]),
                            L == 0 ? nullptr : static_cast<const T*>(a.wfin), a.bfin,
                            a.cross_scale, static_cast<T*>(a.qt[2]), c);
  });
  s.sync();
  if constexpr (sizeof(T) == 4)
    i2t_stage<T>(rows, idx, S, a.n, a.N, static_cast<const T*>(a.q_img[L]),
                 static_cast<const T*>(a.k_i[L]), static_cast<const T*>(a.v_i[L]), NT,
                 static_cast<const T*>(w.wo_i), static_cast<const T*>(w.wo_i_blocks), w.bo_ln4,
                 a.eps, a.cross_scale, static_cast<T*>(L == 0 ? a.keys1 : a.keys_out),
                 s.items((tiles + G4 - 1) / G4));
  else
    i2t_pass<T, false, false, true>(
        smem, rows, idx, nullptr, S, a.n, a.N, static_cast<const T*>(a.q_img[L]),
        static_cast<const T*>(a.k_i[L]), static_cast<const T*>(a.v_i[L]), NT,
        static_cast<const T*>(w.wo_i), static_cast<const T*>(w.wo_i_blocks), w.bo_ln4, a.eps,
        a.cross_scale, static_cast<T*>(L == 0 ? a.keys1 : a.keys_out),
        s.items((tiles + G4 - 1) / G4));
  using M = i2t_hopper::I2tSmem<T, false>;
  end_pass(reinterpret_cast<uint64_t*>(smem + M::kBarsAt), M::kBars);
  s.sync();
}

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, 1)
    two_way_fused_kernel(const __grid_constant__ FusedArgs a) {
  unsigned char* smem = fused_smem;
  constexpr int G = t2i_hopper::T2iL<T>::kGroups;
  const int tiles = a.N / kRows;
  const Sched s{a.grid, a.n, a.cl};
  fused_layer<T, NT, 0>(smem, a, s);
  fused_layer<T, NT, 1>(smem, a, s);
  t2i_stage<T, false>(a.keys_out, nullptr, a.n, a.n, a.N, static_cast<const T*>(a.wkv),
                      static_cast<const T*>(a.wkv_blocks), a.bkv, static_cast<const T*>(a.kpe_f),
                      nullptr, static_cast<const T*>(a.qt[2]), NT, nullptr, a.part_m[2],
                      a.part_l[2], a.part_acc[2], s.items((tiles + G - 1) / G));
  end_pass(t2i_hopper::t2i_bars<T, false, false>(smem, NT), t2i_hopper::kT2iBars<T>);
  s.sync();
  const T* wfin = static_cast<const T*>(a.wfin);
  s.tokens([&](int c, const Team& tm) {
    final_tokens_stage<T, NT>(tm, a.x_state[1], a.part_m[2], a.part_l[2], a.part_acc[2], tiles,
                              wfin + kI * kC, a.bfin + kI, a.bfin + kI + kC, a.eps,
                              static_cast<T*>(a.tokens_out), c);
  });
}

// ---------------------------------------------------------------------------
// the launch
// ---------------------------------------------------------------------------

// The team size by mode and n, from resident[i], the teams of kSizes[i]
// CTAs resident at once (size 1: CTAs; 0: none). K1-stack: the largest size
// whose resident teams take every candidate in one round (else 1: a round's
// token stages run at once on every team, and more rounds cost more than a
// team's width saves). K1-grid: the fewest rounds x (1 / size + beta), a
// round's time as its image work split over size CTAs plus the part that
// does not shrink with the size (its token stages and barriers), beta of
// the image work of one CTA (kBeta, from cluster_sweep's times by size,
// PERF.md §6: a bf16 round is ~1/8 token stages, a fp32 round ~1/64).
constexpr int kSizes[] = {1, 2, 4, 8};
inline int choose_cluster(int grid, int n, const int (&resident)[4], double beta) {
  int best = 1;
  double cost = 0.;
  for (int i = 0; i < 4; ++i) {
    const int c = kSizes[i], r = resident[i];
    if (r < 1) continue;
    const int rounds = (n + r - 1) / r;
    if (!grid) {
      if (rounds == 1) best = c;
      continue;
    }
    const double v = rounds * (1.0 / c + beta);
    if (i == 0 || v < cost) best = c, cost = v;
  }
  return best;
}
template <typename T>
constexpr double kBeta = sizeof(T) == 2 ? 1.0 / 8 : 1.0 / 64;

}  // namespace stack

namespace {  // internal linkage: each library keeps its own records (kernel_bits loads two)

// Launch the fused transformer: K1-grid (mode 1, a cluster of cl CTAs a
// candidate) or K1-stack (mode 0, a cooperative grid of the co-resident
// CTAs, in clusters of cl). cl 0: choose_cluster's. A launch the card
// refuses (too much shared memory, no cooperative launch, the pair of
// attributes) returns its error. dry: no launch; dry[0] the team size,
// dry[1] the CTAs it would launch.
template <typename T, int NT>
int launch_fused(const stack::FusedArgs& args, int grid, int cl_req, cudaStream_t stream,
                 int* dry) {
  using namespace stack;
  static int raised[wg::kMaxDevices] = {};
  static int resident[wg::kMaxDevices][4] = {};  // teams + 1 (0: not queried yet)
  auto kernel = two_way_fused_kernel<T, NT>;
  constexpr int smem = static_cast<int>(smem_fused<T, NT>());
  cudaError_t err =
      wg::raise_shared_memory(reinterpret_cast<const void*>(kernel), smem, raised);
  if (err != cudaSuccess) return err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  const int d = dev < wg::kMaxDevices ? dev : 0;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  // the teams of kSizes[i] CTAs resident at once (size 1: the CTAs of one
  // an SM; else cudaOccupancyMaxActiveClusters'), queried once per device
  auto teams = [&](int i) -> int {
    if (resident[d][i] == 0) {
      int r = 0;
      if (kSizes[i] == 1) {
        int sms = 0, per_sm = 0;
        if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) == cudaSuccess &&
            cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem) ==
                cudaSuccess)
          r = sms * per_sm;
      } else {
        cudaLaunchConfig_t q = cfg;
        cudaLaunchAttribute at;
        at.id = cudaLaunchAttributeClusterDimension;
        at.val.clusterDim.x = kSizes[i];
        at.val.clusterDim.y = at.val.clusterDim.z = 1;
        q.gridDim = dim3(kSizes[i]);
        q.attrs = &at;
        q.numAttrs = 1;
        if (cudaOccupancyMaxActiveClusters(&r, kernel, &q) != cudaSuccess) r = 0;
      }
      cudaGetLastError();  // a size the card refuses counts none resident
      resident[d][i] = r + 1;
    }
    return resident[d][i] - 1;
  };
  int cl = cl_req;
  if (cl == 0) {
    const int r[4] = {teams(0), teams(1), teams(2), teams(3)};
    cl = choose_cluster(grid, args.n, r, kBeta<T>);
  }
  int size_i = -1;
  for (int i = 0; i < 4; ++i)
    if (kSizes[i] == cl) size_i = i;
  if (size_i < 0) return cudaErrorInvalidValue;
  if (teams(size_i) < 1) return cudaErrorInvalidConfiguration;
  int na = 0;
  if (cl > 1) {
    attr[na].id = cudaLaunchAttributeClusterDimension;
    attr[na].val.clusterDim.x = cl;
    attr[na].val.clusterDim.y = attr[na].val.clusterDim.z = 1;
    ++na;
  }
  if (grid) {
    if (static_cast<int64_t>(args.n) * cl > 0x7fffffff) return cudaErrorInvalidValue;
    cfg.gridDim = dim3(args.n * cl);
  } else {
    int coop = 0;
    if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
      return err;
    if (!coop) return cudaErrorNotSupported;
    // the co-resident teams (one CTA an SM), no more CTAs than the most items
    // of a stage (fp32's t2i pass: a tile an item)
    int64_t ctas = static_cast<int64_t>(teams(size_i)) * cl;
    const int64_t items = static_cast<int64_t>(args.n) * (args.N / kRows);
    if (ctas > items) ctas = (items + cl - 1) / cl * cl;
    cfg.gridDim = dim3(static_cast<unsigned>(ctas));
    attr[na].id = cudaLaunchAttributeCooperative;
    attr[na].val.cooperative = 1;
    ++na;
  }
  cfg.attrs = attr;
  cfg.numAttrs = na;
  if (dry) {
    dry[0] = cl;
    dry[1] = static_cast<int>(cfg.gridDim.x);
    return cudaSuccess;
  }
  stack::FusedArgs a = args;
  a.grid = grid;
  a.cl = cl;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// launch_fused<T, NT> is instantiated in one file per token count and dtype
// (two_way_stack_t{5,6,7,8}_{bf16,f32}.cu), which nvcc compiles in parallel,
// each behind a function of its own name; two_way_stack.cu holds the C entry.
#define COR_FUSED_INSTANCES(X) \
  X(uint16_t, 5, bf16) X(float, 5, f32) X(uint16_t, 6, bf16) X(float, 6, f32) \
  X(uint16_t, 7, bf16) X(float, 7, f32) X(uint16_t, 8, bf16) X(float, 8, f32)
#define COR_FUSED_NAME(NT, TAG) cor_fused_launch_t##NT##_##TAG
#define COR_FUSED_DECLARE(T, NT, TAG) \
  int COR_FUSED_NAME(NT, TAG)(const cor::stack::FusedArgs&, int, int, cudaStream_t, int*);
#define COR_FUSED_DEFINE(T, NT, TAG)                                                           \
  int COR_FUSED_NAME(NT, TAG)(const cor::stack::FusedArgs& a, int grid, int cl,               \
                              cudaStream_t s, int* dry) {                                      \
    return launch_fused<T, NT>(a, grid, cl, s, dry);                                           \
  }

}  // namespace cor
