// K1's token -> image pass (stage 2 of the two-way layer, two_way_layer.cu),
// redesigned for Hopper: the entry cor_twl_t2i, K1's own. It computes what
// cor_t2i_image_pass (t2i_flash.cu) computes for K1, and writes the same
// q_img and the same per-64-row-tile flash partials, which
// cor_twl_tokens_mid combines as before:
//
//   k = T(rows @ Wk^T + bk + kpe),  v = T(rows @ Wv^T + bv),
//   q_img = T(rows @ Wq^T + bq + qpe)                      (written out)
//   per tile and (head, token) query: m = max of the tile's 64 logits
//   qt_h[t] . k_h, l = sum exp(logit - m), acc = sum T(exp(logit - m)) v_h
//
// Replaces, with the three other launches of the layer, the TPU kernel
// cor_tpu/ops/pallas/two_way_layer.py:two_way_layer_fused (its pallas_calls
// at lines 978, 998 and 1012). K2, K8a and the opt-in schedules keep the
// shared image pass of t2i_flash.cuh.
//
// What held the shared pass back on the H100 (measured by launch, PERF.md):
// one CTA of 4 warps per 64-row tile staged the whole packed [k|v|q] weight
// (384 x 256) through one 128 x 128 shared block for every tile, each block
// a load, a barrier and then mma.sync, with nothing overlapping the loads;
// its logits read k with 4-way bank conflicts. Here:
//
//  - a persistent grid, one CTA an SM, walks work items of kGroups
//    consecutive 64-row tiles of a candidate (bf16: 2, one per consumer
//    warpgroup; fp32: 1). The weight streams through a ring of kStages
//    shared-memory blocks of 128 outputs x kKB inputs in wgmma's K-major
//    core-matrix layout, handed over by full and empty mbarriers, every
//    block serving the item's kGroups tiles. In bf16 one producer thread
//    moves each block with one TMA bulk copy out of the weight laid out
//    block by block (the wrapper's pack): per-thread cp.async of the same
//    blocks moved the ring several times slower and set the pass's time.
//    In fp32 two producer warps load each block kFetchDepth blocks ahead
//    and split it once into its TF32 halves (tf32_tiles.cuh). The
//    producer's other warps load the next item's rows into a warpgroup's
//    row tile once that warpgroup has finished its products (an int8 store
//    row is gathered through idx, 8 chunks of loads in flight a thread, and
//    dequantised as load_rows does it), under the attention arithmetic;
//  - the projections run on wgmma m64n128, chunk by chunk in the order q,
//    k, v: bf16 with the rows and the weight block from shared memory, the
//    same products in the same k order as the mma.sync pass, so k, v and
//    q_img are its bits; fp32 in 3xTF32 with each row fragment split as it
//    is loaded, the A operand from registers: small.big + big.small +
//    big.big a k-step. Each chunk's PE values are loaded under its
//    products and the bias is in shared memory; q goes out through k's
//    buffer, 16 bytes a thread and whole rows a warp;
//  - the logits, the tile softmax and the exponentials' product with v stay
//    on the CUDA cores in the shared pass's order (each logit summed over
//    d = 0..15, each acc over the rows 0..63, the same warp reductions), so
//    the partials are its bits in bf16; thread (row, head) forms the T
//    logits of a row's head side by side (k by 16-byte loads, q broadcast),
//    a warp reduces 4 query rows side by side, and thread (head, d) forms
//    the T sums of one channel (v and the exponentials broadcast).
//
// Shared memory (T = n_tok, 1 to 8): kStages x 16 KB of weight blocks, per
// consumer warpgroup its row tile (bf16 core-matrix [64][256], 32 KB; fp32
// [64][260], 66,560 B), k and v [64][kLdI] of the compute dtype, the logits
// [8 T][68] fp32 and the candidate's scaled queries [T][128] fp32, and the
// bias: 228,944 B in bf16 and 222,800 in fp32 at T = 8.
//
// What bounds it: per candidate 2 MiB of bf16 rows (0.5 MiB as int8) read,
// 1 MiB of q_img written and 0.8 GFLOP of projections (3x that in fp32's
// 3xTF32 at half bf16's rate: operations); the weight blocks come from L2
// once per item, 192 KiB per 128 rows in bf16, 384 KiB per 64 rows in fp32.
// What the card still spends beyond that (PERF.md): the attention
// arithmetic, which no product overlaps (both warpgroups reach it together,
// bound by the ring they share), and in fp32 the producer's splitting.

#include <type_traits>

#include "decoder_common.cuh"
#include "tf32_tiles.cuh"
#include "wgmma.cuh"
#include "twl_hopper.cuh"

namespace {

using namespace cor;

constexpr int kMaxT = 8;         // K1's tokens: 5 to 8 (the entry takes 1 to 8)
constexpr int kProd = 128;       // the producer warpgroup
// its threads that stream the weight, the rest loading the rows: in bf16 one
// thread issuing a TMA bulk copy a block (warp 0), in fp32 warps 0-1
template <typename T>
constexpr int kWThreads = sizeof(T) == 2 ? 32 : 64;
constexpr int kLdL = kRows + 4;  // the logits' row stride: 16-byte aligned rows
// the chunks of the packed weight [k | v | q] in the order an item takes
// them: q first, staged through k's buffer and written out in whole rows
__host__ __device__ constexpr int chunk_at(int i) { return i == 0 ? 2 : i - 1; }

// two consecutive values of the compute dtype, loaded as one register
// (bf16) or two (fp32) and read back as fp32
template <typename T>
struct Pair;
template <>
struct Pair<uint16_t> {
  using type = uint32_t;
  static __device__ __forceinline__ type load(const uint16_t* p) {
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  static __device__ __forceinline__ void get(type v, float& a, float& b) {
    a = bf2f(static_cast<uint16_t>(v & 0xffffu));
    b = bf2f(static_cast<uint16_t>(v >> 16));
  }
};
template <>
struct Pair<float> {
  using type = float2;
  static __device__ __forceinline__ type load(const float* p) {
    return __ldg(reinterpret_cast<const float2*>(p));
  }
  static __device__ __forceinline__ void get(type v, float& a, float& b) {
    a = v.x;
    b = v.y;
  }
};

// the layout, by compute dtype: bf16 uint16_t, fp32 float
template <typename T>
struct T2iL;
template <>
struct T2iL<uint16_t> {
  static constexpr int kGroups = 2, kKB = 64, kStages = 3;
  static constexpr int kRowsBytes = kRows * kC * 2;  // core-matrix [64][256]
};
template <>
struct T2iL<float> {
  static constexpr int kGroups = 1, kKB = 16, kStages = 4;
  static constexpr int kRowsBytes = kRows * (kC + 4) * 4;  // [64][260]
};

template <typename T>
struct T2iSmem {
  using L = T2iL<T>;
  static constexpr int kLdI = Elem<T>::kLdI;
  // a weight block: [128][kKB] of bf16, or the two TF32 halves of one of fp32
  static constexpr int kStageBytes = kI * L::kKB * (sizeof(T) == 2 ? 2 : 8);
  static constexpr int kBlocks = 3 * (kC / L::kKB);  // blocks of an item: q, k, v
  static constexpr int kKV = kRows * kLdI * sizeof(T);
  static __host__ __device__ constexpr int group_bytes(int nt) {
    return L::kRowsBytes + 2 * kKV + kHeads * nt * kLdL * 4 + nt * kI * 4;
  }
  static __host__ __device__ constexpr int bytes(int nt) {
    return L::kStages * kStageBytes + L::kGroups * group_bytes(nt) + 3 * kI * 4 +
           (2 * L::kStages + 2 * L::kGroups) * 8;
  }
};

// the mbarriers, after the ring and the groups' buffers
struct Bars {
  uint64_t* full;        // [kStages]: a weight block has landed
  uint64_t* empty;       // [kStages]: every consumer is done with it
  uint64_t* rows_full;   // [kGroups]: a group's row tile has landed
  uint64_t* rows_empty;  // [kGroups]: its products are done
};

// Weight block `blk` of an item (chunk c = chunk_at(blk / (kC / kKB)), inputs
// kb * kKB ..) of w [3 * kI][kC]
template <typename T>
__device__ __forceinline__ const T* weight_block_src(const T* w, int blk) {
  using L = T2iL<T>;
  constexpr int kPer = kC / L::kKB;
  return w + static_cast<int64_t>(chunk_at(blk / kPer)) * kI * kC + (blk % kPer) * L::kKB;
}

// fp32: lane's chunks of weight block `blk` loaded into registers, then
// split into their TF32 halves and stored into a ring stage (big, then small
// kI * kKB floats on): the producer keeps kFetchDepth blocks of loads in
// flight.
constexpr int kChF32 = T2iL<float>::kKB / 4;
constexpr int kPerF32 = kI * kChF32 / kWThreads<float>;  // chunks of a block a lane moves
constexpr int kFetchDepth = 4;
__device__ __forceinline__ void fetch_weight_block(const float* w, int blk, int lane,
                                                   float4 (&r)[kPerF32]) {
  const float* src = weight_block_src(w, blk);
#pragma unroll
  for (int u = 0; u < kPerF32; ++u) {
    int o, ch;
    tf32::chunk_of<kChF32>(lane + kWThreads<float> * u, o, ch);
    r[u] = __ldg(reinterpret_cast<const float4*>(src + o * kC) + ch);
  }
}
__device__ __forceinline__ void place_weight_block(unsigned char* stage, int lane,
                                                   const float4 (&r)[kPerF32]) {
  float* dst = reinterpret_cast<float*>(stage);
#pragma unroll
  for (int u = 0; u < kPerF32; ++u) {
    int o, ch;
    tf32::chunk_of<kChF32>(lane + kWThreads<float> * u, o, ch);
    tf32::store_split4(dst, dst + kI * T2iL<float>::kKB, tf32::chunk_offset(o, ch, kChF32),
                       r[u]);
  }
}

// The rows [r0, r0 + 64) of source row `row` into a group's row tile, by
// the producer's row threads (lane 0 .. kProd - kWThreads - 1): bf16 into the
// core-matrix layout, fp32 into [64][260]; by cp.async, or an int8 store row
// loaded kBatch chunks at a time, dequantised as load_rows does it and
// stored.
template <typename T, bool kInt8>
__device__ __forceinline__ void load_row_tile(unsigned char* tile, const void* src, int row,
                                              int N, int r0, float scale, int lane) {
  constexpr int kVec = 16 / sizeof(T);  // values per 16-byte chunk
  constexpr int kCh = kC / kVec;
  constexpr int kThreads = kProd - kWThreads<T>;
  constexpr int kBatch = 8;
  const int64_t base = (static_cast<int64_t>(row) * N + r0) * kC;
  auto place = [&](int f, int& at) -> T* {
    int r, c;
    if constexpr (sizeof(T) == 2) {
      tf32::chunk_of<kCh>(f, r, c);
    } else {
      r = f / kCh;
      c = f % kCh;
    }
    at = r * kC + c * kVec;
    return reinterpret_cast<T*>(tile) +
           (sizeof(T) == 2 ? wg::cm_offset(r, c * kVec, kCh) : r * (kC + 4) + c * kVec);
  };
  if constexpr (kInt8) {
    using Raw = typename std::conditional<sizeof(T) == 2, uint2, uint32_t>::type;
    const int8_t* s8 = static_cast<const int8_t*>(src) + base;
    for (int f0 = lane; f0 < kRows * kCh; f0 += kBatch * kThreads) {
      Raw raw[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int f = f0 + u * kThreads;
        int at;
        place(f, at);
        if (f < kRows * kCh) raw[u] = __ldg(reinterpret_cast<const Raw*>(s8 + at));
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int f = f0 + u * kThreads;
        int at;
        T* dst = place(f, at);
        if (f >= kRows * kCh) break;
        if constexpr (sizeof(T) == 2)
          *reinterpret_cast<uint4*>(dst) = dequant8_bf16(raw[u], scale);
        else
          *reinterpret_cast<uint4*>(dst) = dequant4_f32(raw[u], scale);
      }
    }
  } else {
#pragma unroll 4
    for (int f = lane; f < kRows * kCh; f += kThreads) {
      int at;
      T* dst = place(f, at);
      wg::cp16(dst, static_cast<const T*>(src) + base + at, 16u);
    }
  }
}

template <typename T, bool kInt8>
__global__ void __launch_bounds__(T2iL<T>::kGroups * 128 + kProd, 1)
twl_t2i_kernel(const void* __restrict__ src, const int* __restrict__ idx,
               const float* __restrict__ scale, int S, int n, int N, const T* __restrict__ w,
               const T* __restrict__ w_blocks, const float* __restrict__ b,
               const T* __restrict__ kpe,
               const T* __restrict__ qpe, const T* __restrict__ qt, int nt,
               T* __restrict__ q_img, float* __restrict__ part_m, float* __restrict__ part_l,
               float* __restrict__ part_acc) {
  using L = T2iL<T>;
  using M = T2iSmem<T>;
  using E = Elem<T>;
  constexpr int G = L::kGroups;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  unsigned char* groups = smem + L::kStages * M::kStageBytes;
  float* sB = reinterpret_cast<float*>(groups + G * M::group_bytes(nt));  // [3 kI]: b
  uint64_t* bar = reinterpret_cast<uint64_t*>(sB + 3 * kI);
  const Bars bars{bar, bar + L::kStages, bar + 2 * L::kStages, bar + 2 * L::kStages + G};

  const int tiles = N / kRows;
  const int per_cand = (tiles + G - 1) / G;
  const int items = n * per_cand;
  const int consumers = G * 128;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      wg::mbar_init(&bars.full[s], sizeof(T) == 2 ? 1 : 2 * kWThreads<T>);
      wg::mbar_init(&bars.empty[s], consumers);
    }
    for (int gi = 0; gi < G; ++gi) {
      wg::mbar_init(&bars.rows_full[gi], 2 * (kProd - kWThreads<T>));
      wg::mbar_init(&bars.rows_empty[gi], 128);
    }
    wg::mbar_init_fence();
  }
  for (int i = tid; i < 3 * kI; i += blockDim.x) sB[i] = b[i];
  __syncthreads();

  if (tid >= consumers) {
    const int p = tid - consumers;
    if (p < kWThreads<T>) {
      // the weight ring: kBlocks blocks an item, in the consumers' order
      const int total = (items - blockIdx.x + gridDim.x - 1) / gridDim.x * M::kBlocks;
      if constexpr (sizeof(T) == 2) {
        // one bulk copy a block, from the weight laid out block by block as
        // the ring holds it (w_blocks)
        if (p == 0) {
          for (int j = 0; j < total; ++j) {
            const int s = j % L::kStages;
            if (j >= L::kStages) wg::mbar_wait(&bars.empty[s], (j / L::kStages - 1) & 1);
            wg::mbar_expect_tx(&bars.full[s], M::kStageBytes);
            wg::bulk_copy(ring + s * M::kStageBytes,
                          w_blocks + (j % M::kBlocks) * (M::kStageBytes / 2), M::kStageBytes,
                          &bars.full[s]);
          }
        }
      } else {
        float4 r[kFetchDepth][kPerF32];
#pragma unroll
        for (int d = 0; d < kFetchDepth; ++d)
          if (d < total) fetch_weight_block(w, d % M::kBlocks, p, r[d]);
        for (int j0 = 0; j0 < total; j0 += kFetchDepth) {
#pragma unroll
          for (int d = 0; d < kFetchDepth; ++d) {
            const int j = j0 + d, s = j % L::kStages;
            if (j >= total) break;
            if (j >= L::kStages) wg::mbar_wait(&bars.empty[s], (j / L::kStages - 1) & 1);
            place_weight_block(ring + s * M::kStageBytes, p, r[d]);
            wg::mbar_arrive_copies(&bars.full[s]);
            wg::mbar_arrive(&bars.full[s]);
            if (j + kFetchDepth < total)
              fetch_weight_block(w, (j + kFetchDepth) % M::kBlocks, p, r[d]);
          }
        }
      }
    } else {
      // the rows: a group's tile of the next item once it has done its products
      const int lane = p - kWThreads<T>;
      int it = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
        const int cand = item / per_cand;
        const int row = source_row(idx, cand, S);
        const float sc = kInt8 ? scale[row] : 1.f;
        for (int gi = 0; gi < G; ++gi) {
          const int tile = (item % per_cand) * G + gi;
          if (it > 0) wg::mbar_wait(&bars.rows_empty[gi], (it - 1) & 1);
          if (tile < tiles)
            load_row_tile<T, kInt8>(groups + gi * M::group_bytes(nt), src, row, N,
                                    tile * kRows, sc, lane);
          wg::mbar_arrive_copies(&bars.rows_full[gi]);
          wg::mbar_arrive(&bars.rows_full[gi]);
        }
      }
    }
    cp_async_wait<0>();  // exit with no copy in flight
    return;
  }

  // consumer warpgroup cw: the item's tile cw
  const int cw = tid >> 7, tg = tid & 127, warp = tg >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* mine = groups + cw * M::group_bytes(nt);
  T* sK = reinterpret_cast<T*>(mine + L::kRowsBytes);
  T* sV = reinterpret_cast<T*>(mine + L::kRowsBytes + M::kKV);
  float* sL = reinterpret_cast<float*>(mine + L::kRowsBytes + 2 * M::kKV);
  float* sQt = sL + kHeads * nt * kLdL;
  const uint32_t rows_addr = wg::smem_u32(mine);
  const uint32_t ring_addr = wg::smem_u32(ring);
  const int nq = kHeads * nt;
  const int ra = warp * 16 + g, rb = ra + 8;
  int j = 0, it = 0, cur = -1;

  for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
    const int cand = item / per_cand;
    const int tile = (item % per_cand) * G + cw;
    const bool valid = tile < tiles;
    const int r0 = tile * kRows;
    if (cand != cur) {  // the candidate's scaled queries (the last item's logits are done)
      for (int i = tg; i < nt * kI; i += 128)
        sQt[i] = E::get(qt[static_cast<int64_t>(cand) * nt * kI + i]);
      cur = cand;
    }
    wg::mbar_wait(&bars.rows_full[cw], it & 1);
    wg::fence_proxy_async();

    // the packed projection, chunk by chunk (q, k, v), each over the ring's
    // kC / kKB blocks of its 128 outputs
#pragma unroll 1
    for (int ci = 0; ci < 3; ++ci) {
      const int c = chunk_at(ci);
      // this thread's PE projection values for the epilogue (k and q), loaded
      // under the products: two rows x 16 column pairs
      typename Pair<T>::type pa[kI / 8], pb[kI / 8];
      if (c != 1 && valid) {
        const T* pe = (c == 0 ? kpe : qpe) + static_cast<int64_t>(r0) * kI + 2 * t;
#pragma unroll
        for (int q = 0; q < kI / 8; ++q) {
          pa[q] = Pair<T>::load(pe + ra * kI + q * 8);
          pb[q] = Pair<T>::load(pe + rb * kI + q * 8);
        }
      }
      float acc[kI / 8][4];
#pragma unroll
      for (int q = 0; q < kI / 8; ++q) acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.f;
      int prev = -1;
#pragma unroll 1
      for (int kb = 0; kb < kC / L::kKB; ++kb, ++j) {
        const int s = j % L::kStages;
        wg::mbar_wait(&bars.full[s], (j / L::kStages) & 1);
        wg::fence_proxy_async();
        const uint32_t stage = ring_addr + s * M::kStageBytes;
        if constexpr (sizeof(T) == 2) {
          wg::fence_regs(acc);
          wg::fence();
#pragma unroll
          for (int kk = 0; kk < L::kKB / 16; ++kk)
            wg::mma_ss_n128(acc, wg::desc_k(rows_addr, kC / 8, kb * (L::kKB / 16) + kk),
                            wg::desc_k(stage, L::kKB / 8, kk), 1);
          wg::commit();
          // keep this block's products in flight; release the previous block
          wg::wait<1>();
          wg::fence_regs(acc);
          if (prev >= 0) wg::mbar_arrive(&bars.empty[prev]);
          prev = s;
        } else {
          // A: this warp's rows of the block's 2 k-steps, split into TF32 halves
          const float* rows = reinterpret_cast<const float*>(mine);
          FragA a[L::kKB / 8];
#pragma unroll
          for (int kk = 0; kk < L::kKB / 8; ++kk)
            a[kk] = load_a_tf32(rows, kC + 4, warp * 16, kb * L::kKB + kk * 8, g, t);
          constexpr uint32_t kHalf = kI * L::kKB * 4;  // the small half, bytes on
          wg::fence_regs(acc);
          wg::fence();
#pragma unroll
          for (int kk = 0; kk < L::kKB / 8; ++kk) {
            wg::mma_tf32_rs_n128(acc, a[kk].small, wg::desc_k(stage, L::kKB / 4, kk), 1);
            wg::mma_tf32_rs_n128(acc, a[kk].big, wg::desc_k(stage + kHalf, L::kKB / 4, kk), 1);
            wg::mma_tf32_rs_n128(acc, a[kk].big, wg::desc_k(stage, L::kKB / 4, kk), 1);
          }
          wg::commit();
          wg::wait<0>();  // the A registers are read until the products complete
          wg::fence_regs(acc);
          wg::mbar_arrive(&bars.empty[s]);
        }
      }
      if constexpr (sizeof(T) == 2) {
        wg::wait<0>();
        wg::fence_regs(acc);
        wg::mbar_arrive(&bars.empty[prev]);
      }
      if (ci == 2) wg::mbar_arrive(&bars.rows_empty[cw]);  // the rows' last reader is done
      if (!valid) continue;
      if (c == 0) wg::group_sync(cw);  // q's rows are out of k's buffer
      // + bias (+ the PE projection for k and q), rounded to T: the shared
      // pass's epilogue; q goes through k's buffer
      T* dst = c == 1 ? sV : sK;
      const float* bc = sB + c * kI;
#pragma unroll
      for (int q = 0; q < kI / 8; ++q) {
        const int col = q * 8 + 2 * t;
        const float b0 = bc[col], b1 = bc[col + 1];
        float v0 = acc[q][0] + b0, v1 = acc[q][1] + b1, v2 = acc[q][2] + b0,
              v3 = acc[q][3] + b1;
        if (c != 1) {
          float pa0, pa1, pb0, pb1;
          Pair<T>::get(pa[q], pa0, pa1);
          Pair<T>::get(pb[q], pb0, pb1);
          v0 += pa0;
          v1 += pa1;
          v2 += pb0;
          v3 += pb1;
        }
        E::put2(dst + ra * M::kLdI + col, v0, v1);
        E::put2(dst + rb * M::kLdI + col, v2, v3);
      }
      if (c == 2) {
        // q_img's 64 rows, 16 bytes a thread and whole rows a warp
        wg::group_sync(cw);
        constexpr int kCh = kI * sizeof(T) / 16;
        T* qo = q_img + (static_cast<int64_t>(cand) * N + r0) * kI;
#pragma unroll 4
        for (int f = tg; f < kRows * kCh; f += 128) {
          const int r = f / kCh, ch = f % kCh;
          *reinterpret_cast<uint4*>(qo + r * kI + ch * (16 / sizeof(T))) =
              *reinterpret_cast<const uint4*>(sK + r * M::kLdI + ch * (16 / sizeof(T)));
        }
      }
    }
    if (!valid) continue;
    wg::group_sync(cw);  // k, v and the queries complete

    // logits: thread (row r, head h) forms the nt logits of r's head h, each
    // summed over d = 0..15 in order, the nt sums side by side
    {
      const int r = tg & 63;
#pragma unroll 1
      for (int h = tg >> 6; h < kHeads; h += 2) {
        float kf[kCrossD];
        wg::load16(sK + r * M::kLdI + h * kCrossD, kf);
        float l[kMaxT];
#pragma unroll
        for (int tt = 0; tt < kMaxT; ++tt) l[tt] = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < kCrossD / 4; ++d4) {
#pragma unroll
          for (int tt = 0; tt < kMaxT; ++tt) {
            if (tt >= nt) break;
            const float4 q4 = reinterpret_cast<const float4*>(sQt + tt * kI + h * kCrossD)[d4];
            l[tt] += q4.x * kf[4 * d4];
            l[tt] += q4.y * kf[4 * d4 + 1];
            l[tt] += q4.z * kf[4 * d4 + 2];
            l[tt] += q4.w * kf[4 * d4 + 3];
          }
        }
#pragma unroll
        for (int tt = 0; tt < kMaxT; ++tt) {
          if (tt >= nt) break;
          sL[(h * nt + tt) * kLdL + r] = l[tt];
        }
      }
    }
    wg::group_sync(cw);
    // the tile softmax of each (head, token) query row, the shared pass's
    // reductions, kSoftRows rows of a warp side by side
    const int64_t pbase = static_cast<int64_t>(cand) * tiles + tile;
    constexpr int kSoftRows = 4;
#pragma unroll 1
    for (int q0 = warp; q0 < nq; q0 += 4 * kSoftRows) {
      float la[kSoftRows], lb[kSoftRows], m[kSoftRows], l[kSoftRows];
#pragma unroll
      for (int i = 0; i < kSoftRows; ++i) {
        const int q = min(q0 + 4 * i, nq - 1);
        la[i] = sL[q * kLdL + lane];
        lb[i] = sL[q * kLdL + lane + 32];
        m[i] = fmaxf(la[i], lb[i]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < kSoftRows; ++i)
          m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], o));
#pragma unroll
      for (int i = 0; i < kSoftRows; ++i) {
        la[i] = expf(la[i] - m[i]);
        lb[i] = expf(lb[i] - m[i]);
        l[i] = la[i] + lb[i];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < kSoftRows; ++i) l[i] += __shfl_xor_sync(0xffffffffu, l[i], o);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kSoftRows; ++i) {
        const int q = q0 + 4 * i;
        if (q >= nq) break;
        sL[q * kLdL + lane] = E::round(la[i]);  // rounded before the product with v
        sL[q * kLdL + lane + 32] = E::round(lb[i]);
        if (lane == 0) {
          part_m[pbase * nq + q] = m[i];
          part_l[pbase * nq + q] = l[i];
        }
      }
    }
    wg::group_sync(cw);
    // the exponentials' product with v: thread (head h, channel d), the nt
    // sums over the rows in order
    {
      const int h = tg >> 4, d = tg & 15;
      float acc[kMaxT];
#pragma unroll
      for (int tt = 0; tt < kMaxT; ++tt) acc[tt] = 0.f;
      const T* vp = sV + h * kCrossD + d;
      const float* lp = sL + h * nt * kLdL;
#pragma unroll 4
      for (int r = 0; r < kRows; r += 4) {
        const float v0 = E::get(vp[r * M::kLdI]), v1 = E::get(vp[(r + 1) * M::kLdI]),
                    v2 = E::get(vp[(r + 2) * M::kLdI]), v3 = E::get(vp[(r + 3) * M::kLdI]);
#pragma unroll
        for (int tt = 0; tt < kMaxT; ++tt) {
          if (tt >= nt) break;
          const float4 e = *reinterpret_cast<const float4*>(lp + tt * kLdL + r);
          acc[tt] += e.x * v0;
          acc[tt] += e.y * v1;
          acc[tt] += e.z * v2;
          acc[tt] += e.w * v3;
        }
      }
#pragma unroll
      for (int tt = 0; tt < kMaxT; ++tt) {
        if (tt >= nt) break;
        part_acc[(pbase * nq + h * nt + tt) * kCrossD + d] = acc[tt];
      }
    }
    wg::group_sync(cw);  // k, v and the logits free for the next item
  }
}

template <typename T, bool kInt8>
int launch(const void* src, const int* idx, const float* scale, int S, int n, int nt, int N,
           const void* w, const void* wb, const float* b, const void* kpe, const void* qpe,
           const void* qt, void* q_img, float* pm, float* pl, float* pa, cudaStream_t stream) {
  static int raised[wg::kMaxDevices] = {};
  auto kernel = twl_t2i_kernel<T, kInt8>;
  const int bytes = T2iSmem<T>::bytes(kMaxT);
  cudaError_t err = wg::raise_shared_memory(reinterpret_cast<const void*>(kernel), bytes, raised);
  if (err != cudaSuccess) return err;
  constexpr int G = T2iL<T>::kGroups;
  const int items = n * ((N / kRows + G - 1) / G);
  const int sms = wg::sm_count();
  const int grid = items < sms ? items : sms;
  kernel<<<grid, G * 128 + kProd, T2iSmem<T>::bytes(nt), stream>>>(
      src, idx, scale, S, n, N, static_cast<const T*>(w), static_cast<const T*>(wb), b,
      static_cast<const T*>(kpe),
      static_cast<const T*>(qpe), static_cast<const T*>(qt), nt, static_cast<T*>(q_img), pm, pl,
      pa);
  return cudaGetLastError();
}

template <typename T>
int t2i(const void* src, int src_int8, const int* ip, const float* sp, int S, int n, int nt,
        int N, const void* w, const void* wb, const float* bp, const void* kpe, const void* qpe,
        const void* qt, void* q_img, float* pm, float* pl, float* pa, cudaStream_t s) {
  auto go = [&](auto fn) {
    return fn(src, ip, sp, S, n, nt, N, w, wb, bp, kpe, qpe, qt, q_img, pm, pl, pa, s);
  };
  return src_int8 ? go(launch<T, true>) : go(launch<T, false>);
}

}  // namespace

// K1's stage 2: cor_t2i_image_pass's arguments (t2i_flash.cu) with qpe and
// q_img required, n_tok 1 to 8, and w_blocks: in bf16 w laid out as the
// ring's blocks (12 of [128][64] in the core-matrix layout, chunks in the
// order q, k, v; the wrapper's pack), unread in fp32. The same outputs (in
// bf16 the same bits).
extern "C" int cor_twl_t2i(const void* src, int src_int8, const void* idx, const void* scale,
                           int S, int n, int n_tok, int N, const void* w, const void* w_blocks,
                           const void* b, const void* kpe, const void* qpe, const void* qt,
                           void* q_img, void* part_m, void* part_l, void* part_acc, int f32,
                           void* stream) {
  if (n < 1 || n > 65535 || n_tok < 1 || n_tok > kMaxT || N < kRows || N % kRows || S < 1 ||
      (src_int8 && (!scale || !idx)) || !qpe || !q_img || (!f32 && !w_blocks))
    return cudaErrorInvalidValue;
  const int* ip = static_cast<const int*>(idx);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(b);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? t2i<float>(src, src_int8, ip, sp, S, n, n_tok, N, w, w_blocks, bp, kpe, qpe, qt,
                          q_img, pm, pl, pa, s)
             : t2i<uint16_t>(src, src_int8, ip, sp, S, n, n_tok, N, w, w_blocks, bp, kpe, qpe,
                             qt, q_img, pm, pl, pa, s);
}
