// Whole-sequence multi-head self-attention, out_h = softmax(q_h k_h^T / sqrt(D)) v_h
// for every head h of every batch row, with head_dim D in {64, 72, 80}.
//
// Replaces the TPU kernels of cor_tpu/ops/pallas/seq_attention.py:
//  - attention_seq_qkv_pallas (_qkv_pair_call, its pallas_call at line 99),
//    head_dim 64: q, k and v of head h are read in place from qkv [B, N, 3C]
//    at column offsets h*D, C + h*D and 2C + h*D, and the output is written
//    into [B, N, C] at h*D with the heads already merged for the
//    out-projection;
//  - attention_seq_pallas (_attention_padded, its pallas_call at line 49):
//    the same over [B, H, N, D] operands, the TPU's route for head dims that
//    do not tile its 128 lanes (ViT-SO400M-14-SigLIP-384: 16 heads of 72).
//    cor_tpu transposes the fused QKV to [B, H, N, D] for it; here one kernel
//    takes both layouts through strides, so the towers at head_dim 72 read
//    the fused QKV in place too.
// No transposes and no [B, H, N, N] logits ever reach device memory.
//
// What bounds it on the H100: at the SigLIP towers' shapes (N = 576, 729 or
// 64) a (batch, head) pair is 4 * N^2 * D flops on 4 * N * D * 2 bytes,
// about 290 flop/byte at N = 576, next to the card's ~295 flop/byte ridge,
// and the products are small (64 x 64 x D tiles). What the first (mma.sync)
// design lost was the overlap of loads and products: every K/V tile went
// through registers between two __syncthreads while the tensor cores
// waited. Measured on the H100 (PERF.md), the wgmma design is bound
// by moving the K/V tiles from L2 to shared memory: sharing each tile
// between two warpgroups did more than cheaper softmax arithmetic, a
// software-pipelined warpgroup or another stage of the ring.
//
// The bf16 kernel (seq_attention_kernel<D>), FlashAttention-3-shaped, on
// wgmma (wgmma.cuh):
//  - one block per (128 query rows, head, batch): two consumer warpgroups
//    (64 rows each, 16 a warp) and a producer of two warps, 320 threads. A
//    sequence of one key tile (N <= 64, the text towers) takes blocks of 64
//    rows and one warpgroup, which live shorter;
//  - every thread of the block starts the copies of Q and the first K
//    tile; then the producer copies the 64-key V tiles and the other K
//    tiles, with cp.async into a ring of kStages = 3 stages in wgmma's
//    core-matrix layout, zero-filling keys past N and D = 72's pad columns;
//    a full and an empty mbarrier per stage hand each stage over
//    (wgmma.cuh), so up to three tiles are on the way while the warpgroups
//    compute, and the first logits wait for no V;
//  - S = Q K^T is wgmma m64n64k16 with Q and K from shared memory, both
//    K-major, over D rounded up to 16 (at D = 72 a fifth k-step reads
//    columns 72..79 of Q and K, zero in shared memory: it adds exactly 0);
//  - O += P V is wgmma m64nDk16 (N = 64, 72, 80) with P as bf16 register
//    fragments and V's [key][d] tile as an N-major B operand: no
//    transposed copy of V;
//  - the softmax is online in fp32, in the log2 domain, with the row max
//    and row sum reduced across the four lanes that share a row; P is
//    rounded to bf16 before P.V, as the TPU kernel rounds its probabilities
//    to the compute dtype; the division by the row sum happens once, in
//    fp32, at the end. Keys past N get -inf logits; query rows past N are
//    computed on zeros and not stored. The sums run in the first design's
//    order: its outputs are the same bits.
// Dynamic shared memory: two Q tiles [64][Dk] and three stages of K [64][Dk]
// and V [64][D] (Dk = D rounded up to 16): 65,536 bytes at D = 64, 78,848
// at 72, 81,920 at 80, plus the barriers (one Q tile less for N <= 64); 98
// registers at most, two blocks an SM. TMA is not used: its 128-byte
// swizzle wants 64-bf16 rows, which 72 and 80 are not, and the fused QKV's
// column pad at 72 would read the next head; cp.async places any 16-byte
// chunk.
//
// fp32 (cor_tpu's compute_dtype float32): seq_attention_f32_kernel<D>, the
// same structure on wgmma's tf32 products, every product in 3xTF32 (fp32
// accuracy on the tensor cores: big = tf32(x) and small = tf32(x - big),
// both rounded to nearest with ties away, and a.b = small_a.big_b +
// big_a.small_b + big_a.big_b, small.small dropped; mma_tf32x3.cuh). Nothing
// is rounded to a narrower type, P included, as cor_tpu rounds to the compute
// dtype. What bounds it: operations, three TF32 products per fp32 one. The
// first design (4 warps of mma.sync, every B fragment split again by each
// warp at each load, tiles staged through registers between two
// __syncthreads) reached 14% of the bound. Here:
//  - one block per (128 query rows, head, batch): two consumer warpgroups
//    and a producer warpgroup, 384 threads. The producer loads each 64-key K
//    and V tile into registers (the next tile's loads in flight while it
//    waits for a stage), splits it once into its TF32 halves and stores both
//    in wgmma's K-major core-matrix layout; full and empty mbarriers per
//    stage hand K and V over separately, so the next K tile is split while
//    the warpgroups run P.V, and the next V tile while they run Q K^T. Each
//    warpgroup splits its 64 Q rows once, into shared memory;
//  - tf32 wgmma takes both shared operands K-major only (the transpose flags
//    are for 16-bit types), so V is stored transposed, [d][key], with the
//    keys within each 8 in the order of P's register fragments (the
//    accumulator tile n of S is the A fragment of k-step n in the permuted
//    key order of mma_tf32x3.cuh). Four lanes transpose each 4 x 4 block by
//    shuffles, so every store is 16 bytes (tf32_tiles.cuh; with 4-byte
//    stores each lane rotating the element it stores, D = 80 spilled);
//  - S = Q K^T: wgmma m64n64k8 with Q and K from shared memory, small.big
//    and big.small over D, then big.big; O += P V: wgmma m64nDk8 with P's
//    halves as register A fragments and V^T's halves from shared memory, in
//    the same order;
//  - the online softmax as in bf16 (log2 domain, fp32), the division by the
//    row sum once at the end;
//  - shared memory: two Q tiles and `stages` K and V^T tiles, each as its
//    two halves: 196,608 bytes at D = 64 and 221,184 at 72 (two stages),
//    163,840 at 80 (one), one block an SM; 168 registers. A sequence of one
//    key tile (the text towers' N = 64) takes a block of one warpgroup and
//    no producer, which stages K and V itself beside Q (V's transposed split
//    while the S product runs): 256-thread blocks of 168 registers would
//    leave one block an SM and run the text towers' 192-256 blocks in two
//    waves.

#include "decoder_common.cuh"
#include "tf32_tiles.cuh"
#include "wgmma.cuh"

namespace {

namespace wg = cor::wg;

constexpr int kBK = 64;        // keys per shared-memory tile
constexpr int kMaxGroups = 2;  // consumer warpgroups a block, 64 query rows each
constexpr int kProducers = 64;  // bf16: the producer's two warps
constexpr int kStages = 3;     // the bf16 kernel's K/V ring
constexpr int kProducersF32 = 128;  // fp32: the producer warpgroup (loads and splits)

// the bf16 kernel's tiles, from the head_dim D
template <int D>
struct Tiles {
  static_assert(D % 8 == 0, "a row of D bf16 is whole 16-byte chunks");
  static constexpr int kDk = (D + 15) / 16 * 16;  // the logits' product depth
  static constexpr int kChQK = kDk / 8;           // chunks of a Q or K row, pad included
  static constexpr int kChV = D / 8;              // chunks of a V row
  static constexpr int kQK = 64 * kDk;            // bf16 elements of a 64-row Q or K tile
  static constexpr int kV = kBK * D;
  // shared memory of a block of `groups` consumer warpgroups
  static constexpr int smem(int groups) {
    return (groups * kQK + kStages * (kQK + kV)) * 2 + (1 + 2 * kStages) * 8;
  }
};

using cor::pack_bf16x2;

// S (a 64-key tile of this lane's rows g and g + 8) into the log2 domain,
// keys past N masked to -inf; mt: this lane's row maxima of it
__device__ __forceinline__ void scale_mask_max(float (&s)[kBK / 8][4], int k0, int N, int t,
                                               float scale_log2, float (&mt)[2]) {
  mt[0] = mt[1] = -INFINITY;
#pragma unroll
  for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + n * 8 + 2 * t + (e & 1);
      const float val = key < N ? s[n][e] * scale_log2 : -INFINITY;
      s[n][e] = val;
      mt[e >> 1] = fmaxf(mt[e >> 1], val);
    }
  }
}

// q, k, v: element (b, h, n, d) at b * in_b + h * in_h + n * in_n + d (the
// three share strides); out: at b * out_b + h * out_h + n * out_n + d.
// A block of blockDim.x = groups * 128 + kProducers threads takes the
// groups * 64 query rows from blockIdx.x * groups * 64.
template <int D>
__global__ void __launch_bounds__(kMaxGroups * 128 + kProducers)
seq_attention_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                     const uint16_t* __restrict__ v, uint16_t* __restrict__ out, int N,
                     int64_t in_b, int64_t in_h, int64_t in_n, int64_t out_b, int64_t out_h,
                     int64_t out_n, float scale_log2) {
  using T = Tiles<D>;
  const int groups = (blockDim.x - kProducers) / 128;
  const int consumers = groups * 128;
  extern __shared__ __align__(128) unsigned char smem[];
  uint16_t* sQ = reinterpret_cast<uint16_t*>(smem);  // groups x [query][Dk]
  uint16_t* sK = sQ + groups * T::kQK;                // kStages x [key][Dk]
  uint16_t* sV = sK + kStages * T::kQK;               // kStages x [key][D]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kStages * T::kV);
  uint64_t* full = q_full + 1;       // stage s holds the next K/V tile
  uint64_t* empty = full + kStages;  // stage s is consumed

  const int q0 = blockIdx.x * groups * 64;
  const int tid = threadIdx.x;
  const int tiles = (N + kBK - 1) / kBK;
  const int64_t head = blockIdx.z * in_b + blockIdx.y * in_h;
  if (tid == 0) {
    wg::mbar_init(q_full, 2 * blockDim.x);
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(&full[s], 2 * kProducers);
      wg::mbar_init(&empty[s], consumers);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();
  // every thread starts the copies of Q and the first K tile (the first
  // product needs no V): a block's first tiles are on their way sooner
  for (int w = 0; w < groups; ++w)
    wg::load_tile<T::kChQK, D / 8>(sQ + w * T::kQK, q + head, in_n, q0 + 64 * w, N, tid,
                                   blockDim.x);
  wg::load_tile<T::kChQK, D / 8>(sK, k + head, in_n, 0, N, tid, blockDim.x);
  wg::mbar_arrive_copies(q_full);
  wg::mbar_arrive(q_full);

  if (tid >= consumers) {
    // the producer warps: the V tiles and the other K tiles through the ring
    const int lane = tid - consumers;
    for (int j = 0; j < tiles; ++j) {
      const int s = j % kStages;
      if (j >= kStages) wg::mbar_wait(&empty[s], (j / kStages - 1) & 1);
      if (j > 0)
        wg::load_tile<T::kChQK, D / 8>(sK + s * T::kQK, k + head, in_n, j * kBK, N, lane,
                                       kProducers);
      wg::load_tile<T::kChV, D / 8>(sV + s * T::kV, v + head, in_n, j * kBK, N, lane,
                                    kProducers);
      wg::mbar_arrive_copies(&full[s]);
      wg::mbar_arrive(&full[s]);
    }
    cor::cp_async_wait<0>();  // exit with no copy in flight
    return;
  }

  // consumer warpgroup cw: query rows q0 + 64 cw .. + 63
  const int cw = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const uint32_t q_addr = wg::smem_u32(sQ + cw * T::kQK);
  const uint32_t k_addr = wg::smem_u32(sK);
  const uint32_t v_addr = wg::smem_u32(sV);
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, log2 domain
  float l_run[2] = {0.f, 0.f};              // this lane's share of the row sums
  wg::mbar_wait(q_full, 0);
  wg::fence_proxy_async();

  for (int j = 0; j < tiles; ++j) {
    const int s = j % kStages;
    if (j > 0) {
      wg::mbar_wait(&full[s], (j / kStages) & 1);
      wg::fence_proxy_async();
    }
    // S = Q K^T: 64 rows x 64 keys
    float sc[kBK / 8][4];
    wg::fence();
#pragma unroll
    for (int kc = 0; kc < T::kDk / 16; ++kc)
      wg::mma_ss_n64<0>(sc, wg::desc_k(q_addr, T::kChQK, kc),
                        wg::desc_k(k_addr + s * T::kQK * 2, T::kChQK, kc), kc > 0);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(sc);

    // scale into the log2 domain, mask keys past N, tile row max
    float mt[2];
    scale_mask_max(sc, j * kBK, N, t, scale_log2, mt);
    cor::softmax_rescale(mt, m_run, l_run, o);

    // P = exp2(S - m) in fp32 for the row sums, bf16 A fragments for P.V
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      const float p0 = exp2f(sc[n][0] - m_run[0]);
      const float p1 = exp2f(sc[n][1] - m_run[0]);
      const float p2 = exp2f(sc[n][2] - m_run[1]);
      const float p3 = exp2f(sc[n][3] - m_run[1]);
      l_run[0] += p0 + p1;
      l_run[1] += p2 + p3;
      pa[n >> 1][(n & 1) * 2 + 0] = pack_bf16x2(p0, p1);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16x2(p2, p3);
    }

    // O += P V: V's [key][d] tile is the N-major B operand
    if (j == 0) {
      wg::mbar_wait(&full[0], 0);  // the first V tile
      wg::fence_proxy_async();
    }
    wg::fence_regs(o);
    wg::fence();
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc)
      wg::mma_rs<D, 1>(o, pa[kc], wg::desc_n(v_addr + s * T::kV * 2, T::kChV, kc), 1);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(o);
    wg::mbar_arrive(&empty[s]);
  }

  float inv[2];
  cor::softmax_inverse_sums(l_run, inv);
  const int qa_row = q0 + cw * 64 + warp * 16 + g;
  const int qb_row = qa_row + 8;
  uint16_t* dst = out + blockIdx.z * out_b + blockIdx.y * out_h + 2 * t;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (qa_row < N)
      *reinterpret_cast<uint32_t*>(dst + qa_row * out_n + n * 8) =
          pack_bf16x2(o[n][0] * inv[0], o[n][1] * inv[0]);
    if (qb_row < N)
      *reinterpret_cast<uint32_t*>(dst + qb_row * out_n + n * 8) =
          pack_bf16x2(o[n][2] * inv[1], o[n][3] * inv[1]);
  }
}

// the fp32 kernel's tiles, from the head_dim D: every tile is stored twice,
// as its TF32 big and small halves, in wgmma's K-major core-matrix layout
// (wgmma.cuh; 4 fp32 a 16-byte chunk)
template <int D>
struct F32Tiles {
  static_assert(D % 8 == 0, "whole k-steps of 8");
  static constexpr int kCh = D / 4;        // chunks of a Q or K row
  static constexpr int kChV = kBK / 4;     // chunks of a V^T row (64 keys)
  static constexpr int kTile = kBK * D;    // floats of one half of a Q, K or V^T tile
  static constexpr int kPer = kBK * kCh / kProducersF32;  // chunks of a tile a thread moves
  static constexpr int kMaxStages = D == 80 ? 1 : 2;      // what 227 KB hold beside two Q tiles
  // bytes: groups x Q (big, small), stages x (K big, small, V^T big, small),
  // four barriers a stage
  static constexpr int smem(int groups, int stages) {
    return (2 * groups + 4 * stages) * kTile * 4 + 4 * stages * 8;
  }
};

// Thread p (of 128) of a 64-row tile of src (row r at src + r * in_n, rows
// from r0; rows >= N zeros): its kPer chunks into registers
template <int D>
__device__ __forceinline__ void fetch_tile(const float* src, int64_t in_n, int r0, int N, int p,
                                           float4 (&r)[F32Tiles<D>::kPer]) {
  using T = F32Tiles<D>;
#pragma unroll
  for (int u = 0; u < T::kPer; ++u) {
    int row, c;
    cor::tf32::chunk_of<T::kCh>(p + kProducersF32 * u, row, c);
    r[u] = r0 + row < N
               ? __ldg(reinterpret_cast<const float4*>(src + (r0 + row) * in_n) + c)
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The fp32 case: q, k, v, out fp32, element (b, h, n, d) as above. A block
// of blockDim.x = groups * 128 + kProducersF32 threads takes the groups * 64
// query rows from blockIdx.x * groups * 64, with a ring of `stages` K and
// V^T stages. kSolo (one key tile: N <= 64): a block of 128 threads and no
// producer, whose warpgroup stages K and V itself beside Q; two such blocks
// fit an SM's registers.
template <int D, bool kSolo>
__global__ void __launch_bounds__(kSolo ? 128 : kMaxGroups * 128 + kProducersF32, kSolo ? 2 : 1)
seq_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out, int N,
                         int64_t in_b, int64_t in_h, int64_t in_n, int64_t out_b, int64_t out_h,
                         int64_t out_n, float scale_log2, int stages) {
  using T = F32Tiles<D>;
  constexpr bool solo = kSolo;
  const int groups = solo ? 1 : (blockDim.x - kProducersF32) / 128;
  const int consumers = groups * 128;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);    // groups x (big, small) [query][D]
  float* sK = sQ + 2 * groups * T::kTile;        // stages x (big, small) [key][D]
  float* sV = sK + 2 * stages * T::kTile;        // stages x (big, small) [d][key]
  uint64_t* k_full = reinterpret_cast<uint64_t*>(sV + 2 * stages * T::kTile);
  uint64_t* k_empty = k_full + stages;
  uint64_t* v_full = k_empty + stages;
  uint64_t* v_empty = v_full + stages;

  const int q0 = blockIdx.x * groups * 64;
  const int tid = threadIdx.x;
  const int tiles = (N + kBK - 1) / kBK;
  const int64_t head = blockIdx.z * in_b + blockIdx.y * in_h;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      wg::mbar_init(&k_full[s], kProducersF32);
      wg::mbar_init(&v_full[s], kProducersF32);
      wg::mbar_init(&k_empty[s], consumers);
      wg::mbar_init(&v_empty[s], consumers);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (!solo && tid >= consumers) {
    // The producer warpgroup: K and V tiles from device memory into
    // registers (the next one's loads in flight while it waits for a stage),
    // split once into TF32 halves and stored: K as [key][d], V transposed to
    // [d][key] (the tf32 B operand of P.V must be K-major)
    const int p = tid - consumers;
    float4 kr[T::kPer], vr[T::kPer];
    fetch_tile<D>(k + head, in_n, 0, N, p, kr);
    for (int j = 0; j < tiles; ++j) {
      const int s = stages == 1 ? 0 : j & 1;
      const uint32_t ph = (stages == 1 ? j : j >> 1) & 1;
      fetch_tile<D>(v + head, in_n, j * kBK, N, p, vr);
      if (j >= stages) wg::mbar_wait(&k_empty[s], ph ^ 1);
      cor::tf32::store_rows_split<T::kCh>(sK + 2 * s * T::kTile, T::kTile, p, kr);
      wg::fence_proxy_async();
      wg::mbar_arrive(&k_full[s]);
      if (j + 1 < tiles) fetch_tile<D>(k + head, in_n, (j + 1) * kBK, N, p, kr);
      if (j >= stages) wg::mbar_wait(&v_empty[s], ph ^ 1);
      cor::tf32::store_vt_split<T::kCh>(sV + 2 * s * T::kTile, T::kTile, p, vr);
      wg::fence_proxy_async();
      wg::mbar_arrive(&v_full[s]);
    }
    return;
  }

  // consumer warpgroup cw: query rows q0 + 64 cw .. + 63
  const int cw = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  float* qb = sQ + 2 * cw * T::kTile;
  float4 vr[solo ? T::kPer : 1];  // kSolo: the V tile, in flight while Q and K are split
  {
    // Q, split once into its halves by the warpgroup that reads it (and,
    // without a producer, the one K tile; V's is split while S runs)
    float4 qr[T::kPer];
    fetch_tile<D>(q + head, in_n, q0 + cw * 64, N, tid & 127, qr);
    if constexpr (solo) {
      float4 kr[T::kPer];
      fetch_tile<D>(k + head, in_n, 0, N, tid, kr);
      fetch_tile<D>(v + head, in_n, 0, N, tid, vr);
      cor::tf32::store_rows_split<T::kCh>(sK, T::kTile, tid, kr);
    }
    cor::tf32::store_rows_split<T::kCh>(qb, T::kTile, tid & 127, qr);
    wg::fence_proxy_async();
    wg::group_sync(cw);
  }
  const uint32_t qb_addr = wg::smem_u32(qb);
  const uint32_t qs_addr = qb_addr + T::kTile * 4;
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, log2 domain
  float l_run[2] = {0.f, 0.f};              // this lane's share of the row sums

  for (int j = 0; j < tiles; ++j) {
    const int s = stages == 1 ? 0 : j & 1;
    const uint32_t ph = (stages == 1 ? j : j >> 1) & 1;
    const uint32_t kb_addr = wg::smem_u32(sK + 2 * s * T::kTile);
    const uint32_t ks_addr = kb_addr + T::kTile * 4;
    const uint32_t vb_addr = wg::smem_u32(sV + 2 * s * T::kTile);
    const uint32_t vs_addr = vb_addr + T::kTile * 4;
    if (!solo) {
      wg::mbar_wait(&k_full[s], ph);
      wg::fence_proxy_async();
    }
    // S = Q K^T in 3xTF32: small.big + big.small, then big.big
    float sc[kBK / 8][4];
    wg::fence();
#pragma unroll
    for (int kc = 0; kc < D / 8; ++kc)
      wg::mma_tf32_ss_n64(sc, wg::desc_k(qs_addr, T::kCh, kc), wg::desc_k(kb_addr, T::kCh, kc),
                          kc > 0);
#pragma unroll
    for (int kc = 0; kc < D / 8; ++kc)
      wg::mma_tf32_ss_n64(sc, wg::desc_k(qb_addr, T::kCh, kc), wg::desc_k(ks_addr, T::kCh, kc),
                          1);
#pragma unroll
    for (int kc = 0; kc < D / 8; ++kc)
      wg::mma_tf32_ss_n64(sc, wg::desc_k(qb_addr, T::kCh, kc), wg::desc_k(kb_addr, T::kCh, kc),
                          1);
    wg::commit();
    if constexpr (solo) {
      cor::tf32::store_vt_split<T::kCh>(sV, T::kTile, tid, vr);
      wg::fence_proxy_async();
    }
    wg::wait<0>();
    wg::fence_regs(sc);
    if (!solo) wg::mbar_arrive(&k_empty[s]);

    float mt[2];
    scale_mask_max(sc, j * kBK, N, t, scale_log2, mt);
    cor::softmax_rescale(mt, m_run, l_run, o);

    // P = exp2(S - m) in fp32, split into TF32 A fragments of k-step n in the
    // permuted key order: {c0, c2, c1, c3} of accumulator tile n
    uint32_t pb[kBK / 8][4], ps[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      const float p0 = exp2f(sc[n][0] - m_run[0]);
      const float p1 = exp2f(sc[n][1] - m_run[0]);
      const float p2 = exp2f(sc[n][2] - m_run[1]);
      const float p3 = exp2f(sc[n][3] - m_run[1]);
      l_run[0] += p0 + p1;
      l_run[1] += p2 + p3;
      cor::split_tf32(p0, pb[n][0], ps[n][0]);
      cor::split_tf32(p2, pb[n][1], ps[n][1]);
      cor::split_tf32(p1, pb[n][2], ps[n][2]);
      cor::split_tf32(p3, pb[n][3], ps[n][3]);
    }

    // O += P V in 3xTF32, V^T's [d][key] tile the K-major B operand
    if constexpr (solo) {
      wg::group_sync(cw);  // every thread's V^T stores
    } else {
      wg::mbar_wait(&v_full[s], ph);
      wg::fence_proxy_async();
    }
    wg::fence_regs(o);
    wg::fence();
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
      wg::mma_tf32_rs<D>(o, ps[n], wg::desc_k(vb_addr, T::kChV, n), 1);
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
      wg::mma_tf32_rs<D>(o, pb[n], wg::desc_k(vs_addr, T::kChV, n), 1);
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n)
      wg::mma_tf32_rs<D>(o, pb[n], wg::desc_k(vb_addr, T::kChV, n), 1);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(o);
    if (!solo) wg::mbar_arrive(&v_empty[s]);
  }

  float inv[2];
  cor::softmax_inverse_sums(l_run, inv);
  const int qa_row = q0 + cw * 64 + warp * 16 + g;
  const int qb_row = qa_row + 8;
  float* dst = out + blockIdx.z * out_b + blockIdx.y * out_h + 2 * t;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (qa_row < N)
      *reinterpret_cast<float2*>(dst + qa_row * out_n + n * 8) =
          make_float2(o[n][0] * inv[0], o[n][1] * inv[0]);
    if (qb_row < N)
      *reinterpret_cast<float2*>(dst + qb_row * out_n + n * 8) =
          make_float2(o[n][2] * inv[1], o[n][3] * inv[1]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int N,
           int64_t in_b, int64_t in_h, int64_t in_n, int64_t out_b, int64_t out_h,
           int64_t out_n, int f32, void* stream) {
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // two consumer warpgroups share each K/V tile, halving the tiles' traffic;
  // a sequence of one key tile (the text towers' 64) takes one, whose blocks
  // are shorter-lived
  const int groups = N > kBK ? kMaxGroups : 1;
  const dim3 grid((N + 64 * groups - 1) / (64 * groups), H, B);
  if (f32) {
    using T = F32Tiles<D>;
    // one key tile (the text towers' 64): one stage, and one warpgroup
    // without a producer (two such blocks fit an SM's registers)
    const int stages = N > kBK ? T::kMaxStages : 1;
    const auto kernel = N > kBK ? seq_attention_f32_kernel<D, false>
                                : seq_attention_f32_kernel<D, true>;
    static int raised32[2][wg::kMaxDevices];
    const cudaError_t err = wg::raise_shared_memory(
        reinterpret_cast<const void*>(kernel),
        N > kBK ? T::smem(kMaxGroups, T::kMaxStages) : T::smem(1, 1), raised32[N <= kBK]);
    if (err != cudaSuccess) return err;
    const int threads = N > kBK ? groups * 128 + kProducersF32 : 128;
    kernel<<<grid, threads, T::smem(groups, stages), s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(out), N, in_b, in_h, in_n, out_b, out_h, out_n, scale_log2, stages);
    return cudaGetLastError();
  }
  const int smem = Tiles<D>::smem(groups);
  static int raised[wg::kMaxDevices];
  const cudaError_t err = wg::raise_shared_memory(
      reinterpret_cast<const void*>(seq_attention_kernel<D>), Tiles<D>::smem(2), raised);
  if (err != cudaSuccess) return err;
  seq_attention_kernel<D><<<grid, groups * 128 + kProducers, smem, s>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(out), N, in_b, in_h, in_n, out_b,
      out_h, out_n, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: bf16 (f32 = 0) or fp32 (f32 = 1), element (b, h, n, d) of each at
// b * in_b + h * in_h + n * in_n + d, every row 16-byte aligned (pointers
// 16-byte aligned, strides multiples of 8 bf16 or 4 fp32). out: of the same
// type, element (b, h, n, d) at b * out_b + h * out_h + n * out_n + d, rows
// 4-byte (bf16) or 8-byte (fp32) aligned. D in {64, 72, 80}. The fused QKV [B, N, 3C] is
// q = qkv, k = qkv + C, v = qkv + 2C with strides (N * 3C, D, 3C) into an out
// [B, N, C] of strides (N * C, D, C); [B, H, N, D] operands have strides
// (H * N * D, N * D, D). Returns the launch's cudaError_t
// (cudaErrorInvalidValue for shapes the kernel does not take).
extern "C" int cor_seq_attention(const void* q, const void* k, const void* v, void* out, int B,
                                 int H, int N, int D, long long in_b, long long in_h,
                                 long long in_n, long long out_b, long long out_h,
                                 long long out_n, int f32, void* stream) {
  if (B < 1 || H < 1 || N < 1 || B > 65535 || H > 65535) return cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return launch<64>(q, k, v, out, B, H, N, in_b, in_h, in_n, out_b, out_h, out_n, f32,
                         stream);
    case 72:
      return launch<72>(q, k, v, out, B, H, N, in_b, in_h, in_n, out_b, out_h, out_n, f32,
                         stream);
    case 80:
      return launch<80>(q, k, v, out, B, H, N, in_b, in_h, in_n, out_b, out_h, out_n, f32,
                         stream);
    default:
      return cudaErrorInvalidValue;
  }
}
