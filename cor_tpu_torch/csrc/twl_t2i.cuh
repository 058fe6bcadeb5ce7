// The token -> image pass of the SAM decoder redesigned for Hopper, shared
// by K1's stage 2 (twl_t2i.cu, cor_twl_t2i: the k, v and q projections,
// q_img written, the per-tile flash partials), K2, the decoder's final
// token -> image attention (t2i_final.cu, cor_t2i_final: k and v only, 5 to
// 32 tokens, the partials combined in the same launch), and K8a, the K8
// route's per-layer attention (t2i_proj_q.cu, cor_t2i_proj_q: K1's q chunk
// with K2's tokens and combine), and the fused transformer of
// two_way_stack.cuh (K1-stack, K1-grid: each layer's pass with its q chunk
// and the final pass without it, over the items its schedule hands them, in
// a block of three warpgroups). Two switches: kQ, the q chunk (q_img
// written); kFold, the tokens up to kMaxTok taken kMaxT at a time and the
// partials combined in the launch; kDma (K1-dma, two_way_layer_dma.cu), the
// rows brought in by the TMA, as K1-dma's header describes. Each source says
// what bounds its pass; the design is the one twl_t2i.cu describes.
#pragma once

#include <math.h>

#include <type_traits>

#include "decoder_common.cuh"
#include "tf32_tiles.cuh"
#include "wgmma.cuh"
#include "tma.cuh"
#include "twl_hopper.cuh"

namespace cor {
namespace t2i_hopper {

using wg::GivenItems;
using wg::Items;

// the tokens a pass holds in shared memory at once: K1's 5 to 8 (its entry
// takes 1 to 8); K2 and K8a (kFold) take up to kMaxTok in groups of kMaxT
constexpr int kMaxT = 8;
constexpr int kProd = 128;       // the producer warpgroup
// its threads that stream the weight, the rest loading the rows: in bf16 one
// thread issuing a TMA bulk copy a block (warp 0), in fp32 warps 0-1
template <typename T>
constexpr int kWThreads = sizeof(T) == 2 ? 32 : 64;
constexpr int kLdL = kRows + 4;  // the logits' row stride: 16-byte aligned rows
// the chunks of the packed weight [k | v (| q)] in the order an item takes
// them: with the q chunk (kQ: K1, K8a) q first, staged through k's buffer
// and written out in whole rows; K2 has none
template <bool kQ>
__host__ __device__ constexpr int chunk_at(int i) { return kQ ? (i == 0 ? 2 : i - 1) : i; }
template <bool kQ>
constexpr int kChunks = kQ ? 3 : 2;

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

template <typename T, bool kQ, bool kFold, bool kDma = false>
struct T2iSmem {
  using L = T2iL<T>;
  static constexpr int kLdI = Elem<T>::kLdI;
  // a weight block: [128][kKB] of bf16, or the two TF32 halves of one of fp32
  static constexpr int kStageBytes = kI * L::kKB * (sizeof(T) == 2 ? 2 : 8);
  static constexpr int kBlocks = kChunks<kQ> * (kC / L::kKB);  // blocks of an item
  static constexpr int kKV = kRows * kLdI * sizeof(T);
  // the tokens held at once: kFold takes its queries kMaxT at a time
  static __host__ __device__ constexpr int held(int nt) {
    return kFold && nt > kMaxT ? kMaxT : nt;
  }
  static __host__ __device__ constexpr int group_bytes(int nt) {
    return L::kRowsBytes + 2 * kKV + kHeads * held(nt) * kLdL * 4 + held(nt) * kI * 4;
  }
  // + the bias, the mbarriers, (kFold) a ticket slot per group and (kDma)
  // an mbarrier per group for an int8 store's raw tile
  static __host__ __device__ constexpr int bytes(int nt) {
    return L::kStages * kStageBytes + L::kGroups * group_bytes(nt) + kChunks<kQ> * kI * 4 +
           (2 * L::kStages + 2 * L::kGroups) * 8 + (kFold ? 4 * L::kGroups : 0) +
           (kDma ? 8 * L::kGroups : 0);
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
template <typename T, bool kQ>
__device__ __forceinline__ const T* weight_block_src(const T* w, int blk) {
  using L = T2iL<T>;
  constexpr int kPer = kC / L::kKB;
  return w + static_cast<int64_t>(chunk_at<kQ>(blk / kPer)) * kI * kC +
         (blk % kPer) * L::kKB;
}

// fp32: lane's chunks of weight block `blk` loaded into registers, then
// split into their TF32 halves and stored into a ring stage (big, then small
// kI * kKB floats on): the producer keeps kFetchDepth blocks of loads in
// flight.
constexpr int kChF32 = T2iL<float>::kKB / 4;
constexpr int kPerF32 = kI * kChF32 / kWThreads<float>;  // chunks of a block a lane moves
constexpr int kFetchDepth = 4;
template <bool kQ>
__device__ __forceinline__ void fetch_weight_block(const float* w, int blk, int lane,
                                                   float4 (&r)[kPerF32]) {
  const float* src = weight_block_src<float, kQ>(w, blk);
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

// L2 cache policies: lines read once (evict first) and lines read again
// (evict last), for the cache-hinted copies and stores below
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}
// cp.async of 16 bytes under an L2 cache policy
__device__ __forceinline__ void cp16_hint(void* dst, const void* src, uint64_t policy) {
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n"
               ::"r"(wg::smem_u32(dst)), "l"(src), "l"(policy)
               : "memory");
}
// a store of one float under an L2 cache policy
__device__ __forceinline__ void st_hint(float* p, float v, uint64_t policy) {
  asm volatile("st.global.L2::cache_hint.f32 [%0], %1, %2;\n" ::"l"(p), "f"(v), "l"(policy)
               : "memory");
}

// The rows [r0, r0 + 64) of source row `row` into a group's row tile, by
// the producer's row threads (lane 0 .. kProd - kWThreads - 1): bf16 into the
// core-matrix layout, fp32 into [64][260]; by cp.async, or an int8 store row
// loaded kBatch chunks at a time, dequantised as load_rows does it and
// stored. kStream (kFold: K2, K8a): the copies ask L2 to evict the rows
// first, which are read once, so that what is read again (the PE
// projections, the weight blocks, the partials of the combine) stays.
template <typename T, bool kInt8, bool kStream = false>
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
    const uint64_t policy = kStream ? l2_evict_first() : 0;
#pragma unroll 4
    for (int f = lane; f < kRows * kCh; f += kThreads) {
      int at;
      T* dst = place(f, at);
      if constexpr (kStream)
        cp16_hint(dst, static_cast<const T*>(src) + base + at, policy);
      else
        wg::cp16(dst, static_cast<const T*>(src) + base + at, 16u);
    }
  }
}

// K1-dma (kDma): the rows of a group's tile come in by the TMA, one thread
// issuing the copies (kRowThreads producer threads load the rows).
template <typename T>
constexpr int kRowThreads = kProd - kWThreads<T>;
constexpr int kRowsBar = 4;  // the row threads' named barrier (kDma, an int8 store)
// where an int8 store's raw tile [64][256] lands: the top 16 KB of the
// group's row tile, which its dequantised rows then fill
template <typename T>
constexpr int kRawAt = T2iL<T>::kRowsBytes - kRows * kC;

// kDma, an int8 store: the raw tile at tile + kRawAt<T> dequantised as
// load_rows does it into the row tile (bf16 as its 16-byte chunks,
// [chunk][row][8]; fp32 [64][260]) by the row threads: first the values whose
// place lies below the raw tile, then, once every row thread has read the
// rest into registers, the rest over it.
template <typename T>
__device__ __forceinline__ void dequant_dma_tile(unsigned char* tile, float sc, int lane) {
  constexpr int kThreads = kRowThreads<T>;
  const int8_t* raw = reinterpret_cast<const int8_t*>(tile + kRawAt<T>);
  if constexpr (sizeof(T) == 2) {
    // chunk (c, r): 8 values, raw bytes r * kC + 8c, placed at (c * 64 + r) * 16;
    // chunks 0 .. 15 lie below the raw tile
    constexpr int kLow = 16 * kRows, kAll = 32 * kRows;
    constexpr int kHigh = (kAll - kLow + kThreads - 1) / kThreads;
    for (int f = lane; f < kLow; f += kThreads) {
      const int c = f % 16, r = f / 16;
      *reinterpret_cast<uint4*>(tile + (c * kRows + r) * 16) =
          dequant8_bf16(*reinterpret_cast<const uint2*>(raw + r * kC + 8 * c), sc);
    }
    uint2 v[kHigh];
#pragma unroll
    for (int u = 0; u < kHigh; ++u) {
      const int f = lane + u * kThreads;
      if (f < kAll - kLow) {
        const int c = 16 + f % 16, r = f / 16;
        v[u] = *reinterpret_cast<const uint2*>(raw + r * kC + 8 * c);
      }
    }
    wg::bar_sync<kRowsBar, kThreads>();
#pragma unroll
    for (int u = 0; u < kHigh; ++u) {
      const int f = lane + u * kThreads;
      if (f < kAll - kLow) {
        const int c = 16 + f % 16, r = f / 16;
        *reinterpret_cast<uint4*>(tile + (c * kRows + r) * 16) = dequant8_bf16(v[u], sc);
      }
    }
  } else {
    // chunk (r, c): 4 values, raw bytes r * kC + 4c, placed at row r, column
    // 4c of [64][260]; rows 0 .. 47 lie below the raw tile
    constexpr int kCh = kC / 4, kLd = kC + 4, kLowRows = 48;
    static_assert(kLowRows * kLd * 4 <= kRawAt<float>, "the low rows overlap the raw tile");
    constexpr int kHigh = ((kRows - kLowRows) * kCh + kThreads - 1) / kThreads;
    float* rows = reinterpret_cast<float*>(tile);
    for (int f = lane; f < kLowRows * kCh; f += kThreads) {
      const int r = f / kCh, c = f % kCh;
      *reinterpret_cast<uint4*>(rows + r * kLd + 4 * c) =
          dequant4_f32(*reinterpret_cast<const uint32_t*>(raw + r * kC + 4 * c), sc);
    }
    uint32_t v[kHigh];
#pragma unroll
    for (int u = 0; u < kHigh; ++u) {
      const int f = kLowRows * kCh + lane + u * kThreads;
      v[u] = *reinterpret_cast<const uint32_t*>(raw + (f / kCh) * kC + 4 * (f % kCh));
    }
    wg::bar_sync<kRowsBar, kThreads>();
#pragma unroll
    for (int u = 0; u < kHigh; ++u) {
      const int f = kLowRows * kCh + lane + u * kThreads;
      *reinterpret_cast<uint4*>(rows + (f / kCh) * kLd + 4 * (f % kCh)) = dequant4_f32(v[u], sc);
    }
  }
}

// kDma: one thread starts the copies of source row `row`'s rows [r0, r0 +
// 64) into a group's row tile, completing on bar: bf16 by the TMA as 32
// column chunks ([chunk][row][8], rows_map over the rows [S N][kC]), fp32 as
// 64 row copies into [64][260], an int8 store as one 16 KB copy of the raw
// tile (at kRawAt).
template <typename T, bool kInt8>
__device__ __forceinline__ void dma_row_tile(unsigned char* tile, const void* src,
                                             const CUtensorMap* rows_map, int row, int N, int r0,
                                             uint64_t* bar) {
  const int64_t first = static_cast<int64_t>(row) * N + r0;
  // the tile's last writers and readers (the row threads' dequantised
  // values, the consumers' products) come before this copy's writes
  wg::fence_proxy_async();
  if constexpr (kInt8) {
    wg::mbar_expect_tx(bar, kRows * kC);
    wg::bulk_copy(tile + kRawAt<T>, static_cast<const int8_t*>(src) + first * kC, kRows * kC, bar);
  } else if constexpr (sizeof(T) == 2) {
    wg::mbar_expect_tx(bar, kRows * kC * 2);
    tma::load_chunks(tile, rows_map, kC / 8, 2, static_cast<int>(first), bar);
  } else {
    wg::mbar_expect_tx(bar, kRows * kC * 4);
    const float* s = static_cast<const float*>(src) + first * kC;
    for (int r = 0; r < kRows; ++r)
      wg::bulk_copy(tile + r * (kC + 4) * 4, s + r * kC, kC * 4, bar);
  }
}

// The items a CTA walks (wg::Items): K1's round-robin (blockIdx.x, +
// gridDim.x, ...); with the combine folded in (kFold) a contiguous range,
// so that a candidate's tiles end on a few CTAs and the one that combines it
// (falling behind by the combine) is not the last to finish the next
// candidates as well.
template <bool kFold>
__device__ __forceinline__ Items cta_items(int items) {
  if constexpr (kFold)
    return {static_cast<int>(static_cast<int64_t>(blockIdx.x) * items / gridDim.x), 1u,
            static_cast<int>(static_cast<int64_t>(blockIdx.x + 1) * items / gridDim.x)};
  else
    return {static_cast<int>(blockIdx.x), gridDim.x, items};
}

// The folded combine (K2, K8a) of candidate `cand`'s partials (its `tiles`
// tiles at base), by one consumer warpgroup (tg, cw) once every tile is
// out: cor_t2i_combine's
// function in its order (m the max over the tiles; l and acc summed over
// them in order, each scaled by exp(m_tile - m); acc / l), for the held
// token group's (at most 64) queries at a time. Thread (q = tg % 64, half
// tg / 64) takes the max over every other tile (a max in any order is the
// max) and forms exp(m_tile - m) of its tiles into sA (the logits' space,
// [query][tile], 64 tiles at a time), 16 loads in flight; then thread tg <
// nqg sums l of query tg, and every thread the acc of two (query, 4
// channels) units, over the tiles in order, each 8 tiles' loads issued
// before their sums (PERF.md: the combine is the kernel's tail).
// The partials are read from L2 (__ldcg): this kernel wrote them, under
// an evict-last policy.
template <typename T>
__device__ __forceinline__ void final_combine(const float* part_m, const float* part_l,
                                              const float* part_acc, int64_t base, int tiles,
                                              int nt, float* sA, float* sQt, T* out, int cand,
                                              int tg, int cw) {
  const int nq = kHeads * nt;
  float* sMx = sQt;  // [2][64]: the halves' maxima
  float* sLs = sQt;  // [64]: l (once every thread has read its max)
  const int qm = tg & 63, hf = tg >> 6;
#pragma unroll 1
  for (int t0 = 0; t0 < nt; t0 += kMaxT) {
    const int ng = min(kMaxT, nt - t0), nqg = kHeads * ng;
    auto gq = [&](int q) { return (q / ng) * nt + t0 + q % ng; };
    const float* mp = part_m + base * nq + gq(qm < nqg ? qm : 0);
    float mx = -INFINITY;
    if (qm < nqg) {
      // 16 of this thread's tiles' loads in flight, then their max
#pragma unroll 1
      for (int j0 = hf; j0 < tiles; j0 += 32) {
        float v[16];
#pragma unroll
        for (int k = 0; k < 16; ++k)
          v[k] = j0 + 2 * k < tiles ? __ldcg(mp + static_cast<int64_t>(j0 + 2 * k) * nq)
                                    : -INFINITY;
#pragma unroll
        for (int k = 0; k < 16; ++k) mx = fmaxf(mx, v[k]);
      }
    }
    sMx[hf * 64 + qm] = mx;
    wg::group_sync(cw);
    const float m_q = fmaxf(sMx[qm], sMx[64 + qm]);
    // this thread's units: (query u / 4, channels 4 (u % 4) ..) for u = tg, tg + 128
    float4 acc[2];
    const float* ap[2];
    const float* fp[2];
    int nu = 0;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      const int u = tg + 128 * k, q = u < nqg * 4 ? u >> 2 : 0;
      nu += u < nqg * 4;
      ap[k] = part_acc + (base * nq + gq(q)) * kCrossD + 4 * (u & 3);
      fp[k] = sA + q * kLdL;
    }
    const float* lp = part_l + base * nq + gq(tg < nqg ? tg : 0);
    float l = 0.f;
#pragma unroll 1
    for (int j0 = 0; j0 < tiles; j0 += 64) {
      const int jc = min(64, tiles - j0);
      wg::group_sync(cw);  // the last chunk's factors read
      if (qm < nqg) {
#pragma unroll 1
        for (int jb = hf; jb < jc; jb += 32) {
          float v[16];
#pragma unroll
          for (int k = 0; k < 16; ++k)
            v[k] = jb + 2 * k < jc
                       ? __ldcg(mp + static_cast<int64_t>(j0 + jb + 2 * k) * nq) : 0.f;
#pragma unroll
          for (int k = 0; k < 16; ++k)
            if (jb + 2 * k < jc) sA[qm * kLdL + jb + 2 * k] = expf(v[k] - m_q);
        }
      }
      wg::group_sync(cw);
      // kB tiles' loads in flight, then their sums in tile order (more
      // spilled: the pass's registers are at the 168 a thread it may take)
      constexpr int kB = 8;
#pragma unroll 1
      for (int jb = 0; jb < jc; jb += kB) {
        float4 v[2][kB];
        float lv[kB];
#pragma unroll
        for (int jj = 0; jj < kB; ++jj) {
          const bool ok = jb + jj < jc;
          const int64_t j = j0 + jb + (ok ? jj : 0);
          lv[jj] = tg < nqg && ok ? __ldcg(lp + j * nq) : 0.f;
#pragma unroll
          for (int k = 0; k < 2; ++k)
            v[k][jj] = k < nu && ok
                           ? __ldcg(reinterpret_cast<const float4*>(ap[k] + j * nq * kCrossD))
                           : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int jj = 0; jj < kB; ++jj) {
          const int j = jb + jj;
          if (j >= jc) break;
          if (tg < nqg) l += lv[jj] * sA[tg * kLdL + j];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            if (k >= nu) break;
            const float a = fp[k][j];
            acc[k].x += v[k][jj].x * a;
            acc[k].y += v[k][jj].y * a;
            acc[k].z += v[k][jj].z * a;
            acc[k].w += v[k][jj].w * a;
          }
        }
      }
    }
    if (tg < nqg) sLs[tg] = l;
    wg::group_sync(cw);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (k >= nu) break;
      const int u = tg + 128 * k, q = u >> 2, h = q / ng, tt = q % ng;
      const float lq = sLs[q];
      T* o = out + (static_cast<int64_t>(cand) * nt + t0 + tt) * kI + h * kCrossD + 4 * (u & 3);
      Elem<T>::put2(o, acc[k].x / lq, acc[k].y / lq);
      Elem<T>::put2(o + 2, acc[k].z / lq, acc[k].w / lq);
    }
    wg::group_sync(cw);  // sQt and sA free for the next group
  }
}

// The pass's mbarriers in smem at T = nt, and their count: a kernel that
// runs the pass more than once over the same shared memory, or puts other
// data there afterwards, invalidates them once every thread is done
// (two_way_stack.cuh).
template <typename T, bool kQ, bool kFold>
__device__ __forceinline__ uint64_t* t2i_bars(unsigned char* smem, int nt) {
  using L = T2iL<T>;
  using M = T2iSmem<T, kQ, kFold>;
  return reinterpret_cast<uint64_t*>(smem + L::kStages * M::kStageBytes +
                                     L::kGroups * M::group_bytes(nt) + kChunks<kQ> * kI * 4);
}
template <typename T>
constexpr int kT2iBars = 2 * T2iL<T>::kStages + 2 * T2iL<T>::kGroups;

// The items of a pass of `items` items (item i: candidate i / per_cand)
// that this CTA walks without a schedule of its own: cta_items' order
template <bool kFold>
struct CtaItems {
  __device__ __forceinline__ Items operator()(int items) const { return cta_items<kFold>(items); }
};

// The pass, run by a block of kThreads threads: kGroups consumer warpgroups
// first, the producer warpgroup last, the warpgroups between (a fp32 pass
// in a block of three) idle; over the dynamic shared memory smem. kQ (K1,
// K8a): q_img written. Without kFold (K1): T 1 to kMaxT, the partials
// written out. kFold (K2, K8a): T 1 to kMaxTok in groups of kMaxT; the last
// group to finish a candidate's tiles combines its partials into out
// (final_combine), through the tickets. walk(items): the items this CTA
// takes (CtaItems: K1's, K2's and K8a's persistent grids). kFetch: fp32's
// weight blocks a producer thread holds in flight; kPeEarly: the PE values
// loaded under the products (else after them, 64 fewer live registers in
// fp32). kDma (K1-dma; without kFold): the rows come in by the TMA
// (dma_row_tile, rows_map in bf16) and the bf16 rows are read as their
// column chunks.
template <typename T, bool kInt8, bool kQ, bool kFold,
          int kThreads = T2iL<T>::kGroups * 128 + kProd, int kFetch = kFetchDepth,
          bool kPeEarly = true, typename Walk = CtaItems<kFold>, bool kDma = false>
__device__ __forceinline__ void t2i_pass(
    unsigned char* smem, const void* __restrict__ src, const int* __restrict__ idx,
    const float* __restrict__ scale, int S, int n, int N, const T* __restrict__ w,
    const T* __restrict__ w_blocks, const float* __restrict__ b, const T* __restrict__ kpe,
    const T* __restrict__ qpe, const T* __restrict__ qt, int nt, T* __restrict__ q_img,
    float* __restrict__ part_m, float* __restrict__ part_l, float* __restrict__ part_acc,
    int* __restrict__ tickets, T* __restrict__ out, Walk walk = Walk(),
    const CUtensorMap* rows_map = nullptr) {
  using L = T2iL<T>;
  using M = T2iSmem<T, kQ, kFold, kDma>;
  using E = Elem<T>;
  constexpr int G = L::kGroups;
  constexpr int kNc = kChunks<kQ>;
  static_assert(kThreads >= G * 128 + kProd && kThreads % 128 == 0, "the pass's warpgroups");
  static_assert(!(kDma && kFold), "K1-dma's pass writes its partials out");
  unsigned char* ring = smem;
  unsigned char* groups = smem + L::kStages * M::kStageBytes;
  float* sB = reinterpret_cast<float*>(groups + G * M::group_bytes(nt));  // [kNc kI]: b
  uint64_t* bar = reinterpret_cast<uint64_t*>(sB + kNc * kI);
  const Bars bars{bar, bar + L::kStages, bar + 2 * L::kStages, bar + 2 * L::kStages + G};
  int* sTicket = reinterpret_cast<int*>(bar + 2 * L::kStages + 2 * G);  // [G] (kFold)
  uint64_t* raw_full = bar + 2 * L::kStages + 2 * G;  // [G] (kDma): a raw int8 tile has landed

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
      // kDma: the copying thread's arrival (an int8 store: the row threads',
      // once they have dequantised the raw tile)
      wg::mbar_init(&bars.rows_full[gi], !kDma ? 2 * kRowThreads<T> : kInt8 ? kRowThreads<T> : 1);
      wg::mbar_init(&bars.rows_empty[gi], 128);
      if (kDma && kInt8) wg::mbar_init(&raw_full[gi], 1);
    }
    wg::mbar_init_fence();
  }
  for (int i = tid; i < kNc * kI; i += blockDim.x) sB[i] = b[i];
  __syncthreads();

  if (tid >= kThreads - kProd) {
    const int p = tid - (kThreads - kProd);
    if (p < kWThreads<T>) {
      // the weight ring: kBlocks blocks an item, in the consumers' order
      const Items r = walk(items);
      const int total = r.count() * M::kBlocks;
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
        float4 r[kFetch][kPerF32];
#pragma unroll
        for (int d = 0; d < kFetch; ++d)
          if (d < total) fetch_weight_block<kQ>(w, d % M::kBlocks, p, r[d]);
        for (int j0 = 0; j0 < total; j0 += kFetch) {
#pragma unroll
          for (int d = 0; d < kFetch; ++d) {
            const int j = j0 + d, s = j % L::kStages;
            if (j >= total) break;
            if (j >= L::kStages) wg::mbar_wait(&bars.empty[s], (j / L::kStages - 1) & 1);
            place_weight_block(ring + s * M::kStageBytes, p, r[d]);
            wg::mbar_arrive_copies(&bars.full[s]);
            wg::mbar_arrive(&bars.full[s]);
            if (j + kFetch < total)
              fetch_weight_block<kQ>(w, (j + kFetch) % M::kBlocks, p, r[d]);
          }
        }
      }
    } else {
      // the rows: a group's tile of the next item once it has done its products
      const int lane = p - kWThreads<T>;
      int it = 0;
      const Items r = walk(items);
      for (int item = r.first; item < r.end; item += r.step, ++it) {
        const int cand = item / per_cand;
        const int row = source_row(idx, cand, S);
        const float sc = kInt8 ? scale[row] : 1.f;
        for (int gi = 0; gi < G; ++gi) {
          const int tile = (item % per_cand) * G + gi;
          if (it > 0) wg::mbar_wait(&bars.rows_empty[gi], (it - 1) & 1);
          unsigned char* dst = groups + gi * M::group_bytes(nt);
          if constexpr (kDma) {
            // a tile past the candidate's (an odd tile count) copies tile 0,
            // which no consumer reads
            const int r0 = (tile < tiles ? tile : 0) * kRows;
            uint64_t* done = kInt8 ? &raw_full[gi] : &bars.rows_full[gi];
            if (lane == 0) dma_row_tile<T, kInt8>(dst, src, rows_map, row, N, r0, done);
            if constexpr (kInt8) {
              wg::mbar_wait(&raw_full[gi], it & 1);
              dequant_dma_tile<T>(dst, sc, lane);
              wg::mbar_arrive(&bars.rows_full[gi]);
            }
            continue;
          }
          if (tile < tiles)
            load_row_tile<T, kInt8, kFold>(dst, src, row, N, tile * kRows, sc, lane);
          wg::mbar_arrive_copies(&bars.rows_full[gi]);
          wg::mbar_arrive(&bars.rows_full[gi]);
        }
      }
    }
    cp_async_wait<0>();  // exit with no copy in flight
    return;
  }
  if (tid >= consumers) return;  // a warpgroup the pass leaves idle

  // consumer warpgroup cw: the item's tile cw
  const int cw = tid >> 7, tg = tid & 127, warp = tg >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* mine = groups + cw * M::group_bytes(nt);
  T* sK = reinterpret_cast<T*>(mine + L::kRowsBytes);
  T* sV = reinterpret_cast<T*>(mine + L::kRowsBytes + M::kKV);
  float* sL = reinterpret_cast<float*>(mine + L::kRowsBytes + 2 * M::kKV);
  const int held = M::held(nt);  // the tokens whose queries and logits are held at once
  float* sQt = sL + kHeads * held * kLdL;
  const uint32_t rows_addr = wg::smem_u32(mine);
  const uint32_t ring_addr = wg::smem_u32(ring);
  const int nq = kHeads * nt;
  const int ra = warp * 16 + g, rb = ra + 8;
  int j = 0, it = 0, cur = -1;

  const Items r = walk(items);
  for (int item = r.first; item < r.end; item += r.step, ++it) {
    const int cand = item / per_cand;
    const int tile = (item % per_cand) * G + cw;
    const bool valid = tile < tiles;
    const int r0 = tile * kRows;
    if (held == nt && cand != cur) {
      // the candidate's scaled queries (the last item's logits are done)
      for (int i = tg; i < nt * kI; i += 128)
        sQt[i] = E::get(qt[static_cast<int64_t>(cand) * nt * kI + i]);
      cur = cand;
    }
    wg::mbar_wait(&bars.rows_full[cw], it & 1);
    wg::fence_proxy_async();

    // the packed projection, chunk by chunk (q, k, v), each over the ring's
    // kC / kKB blocks of its 128 outputs
#pragma unroll 1
    for (int ci = 0; ci < kNc; ++ci) {
      const int c = chunk_at<kQ>(ci);
      // this thread's PE projection values for the epilogue (k and q), loaded
      // under the products: two rows x 16 column pairs
      typename Pair<T>::type pa[kI / 8], pb[kI / 8];
      const T* pe = (c == 0 ? kpe : qpe) + static_cast<int64_t>(r0) * kI + 2 * t;
      auto load_pe = [&]() {
        if (c != 1 && valid) {
#pragma unroll
          for (int q = 0; q < kI / 8; ++q) {
            pa[q] = Pair<T>::load(pe + ra * kI + q * 8);
            pb[q] = Pair<T>::load(pe + rb * kI + q * 8);
          }
        }
      };
      if constexpr (kPeEarly) load_pe();
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
          for (int kk = 0; kk < L::kKB / 16; ++kk) {
            const int ks = kb * (L::kKB / 16) + kk;
            wg::mma_ss_n128(acc, kDma ? tma::desc_chunks(rows_addr, ks)
                                      : wg::desc_k(rows_addr, kC / 8, ks),
                            wg::desc_k(stage, L::kKB / 8, kk), 1);
          }
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
      if (ci == kNc - 1) wg::mbar_arrive(&bars.rows_empty[cw]);  // the rows' last reader is done
      if (!valid) continue;
      if constexpr (!kPeEarly) load_pe();
      if (kQ && c == 0) wg::group_sync(cw);  // q's rows are out of k's buffer
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
      if (kQ && c == 2) {
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
    const int64_t pbase = static_cast<int64_t>(cand) * tiles + tile;

    // the attention over the tile, for the held tokens t0 .. t0 + ng - 1 at
    // a time (K1: all of them; kFold: kMaxT a group, the queries loaded for
    // each), every (head, token) partial in the shared pass's order
    auto attend = [&](const int t0, const int ng) {
      const int nqg = kHeads * ng;  // the held (head, token) query rows
      if (kFold && held < nt) {
        // this group's scaled queries (the last group's logits are done)
        for (int i = tg; i < ng * kI; i += 128)
          sQt[i] = E::get(qt[(static_cast<int64_t>(cand) * nt + t0) * kI + i]);
        wg::group_sync(cw);
      }
      // logits: thread (row r, head h) forms the ng logits of r's head h,
      // each summed over d = 0..15 in order, the ng sums side by side
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
              if (tt >= ng) break;
              const float4 q4 =
                  reinterpret_cast<const float4*>(sQt + tt * kI + h * kCrossD)[d4];
              l[tt] += q4.x * kf[4 * d4];
              l[tt] += q4.y * kf[4 * d4 + 1];
              l[tt] += q4.z * kf[4 * d4 + 2];
              l[tt] += q4.w * kf[4 * d4 + 3];
            }
          }
#pragma unroll
          for (int tt = 0; tt < kMaxT; ++tt) {
            if (tt >= ng) break;
            sL[(h * ng + tt) * kLdL + r] = l[tt];
          }
        }
      }
      wg::group_sync(cw);
      // the tile softmax of each (head, token) query row, the shared pass's
      // reductions, kSoftRows rows of a warp side by side
      constexpr int kSoftRows = 4;
#pragma unroll 1
      for (int q0 = warp; q0 < nqg; q0 += 4 * kSoftRows) {
        float la[kSoftRows], lb[kSoftRows], m[kSoftRows], l[kSoftRows];
#pragma unroll
        for (int i = 0; i < kSoftRows; ++i) {
          const int q = min(q0 + 4 * i, nqg - 1);
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
          if (q >= nqg) break;
          sL[q * kLdL + lane] = E::round(la[i]);  // rounded before the product with v
          sL[q * kLdL + lane + 32] = E::round(lb[i]);
          if (lane == 0) {
            // the query's index among all nq: head q / ng, token t0 + q % ng
            const int gq = kFold ? (q / ng) * nt + t0 + q % ng : q;
            if constexpr (kFold) {  // kept in L2 for the combine
              st_hint(part_m + pbase * nq + gq, m[i], l2_evict_last());
              st_hint(part_l + pbase * nq + gq, l[i], l2_evict_last());
            } else {
              part_m[pbase * nq + gq] = m[i];
              part_l[pbase * nq + gq] = l[i];
            }
          }
        }
      }
      wg::group_sync(cw);
      // the exponentials' product with v: thread (head h, channel d), the ng
      // sums over the rows in order
      {
        const int h = tg >> 4, d = tg & 15;
        float acc[kMaxT];
#pragma unroll
        for (int tt = 0; tt < kMaxT; ++tt) acc[tt] = 0.f;
        const T* vp = sV + h * kCrossD + d;
        const float* lp = sL + h * ng * kLdL;
#pragma unroll 4
        for (int r = 0; r < kRows; r += 4) {
          const float v0 = E::get(vp[r * M::kLdI]), v1 = E::get(vp[(r + 1) * M::kLdI]),
                      v2 = E::get(vp[(r + 2) * M::kLdI]), v3 = E::get(vp[(r + 3) * M::kLdI]);
#pragma unroll
          for (int tt = 0; tt < kMaxT; ++tt) {
            if (tt >= ng) break;
            const float4 e = *reinterpret_cast<const float4*>(lp + tt * kLdL + r);
            acc[tt] += e.x * v0;
            acc[tt] += e.y * v1;
            acc[tt] += e.z * v2;
            acc[tt] += e.w * v3;
          }
        }
#pragma unroll
        for (int tt = 0; tt < kMaxT; ++tt) {
          if (tt >= ng) break;
          float* pa = part_acc + (pbase * nq + h * nt + t0 + tt) * kCrossD + d;
          if constexpr (kFold)
            st_hint(pa, acc[tt], l2_evict_last());
          else
            *pa = acc[tt];
        }
      }
      wg::group_sync(cw);  // k, v and the logits free for the next item (or group)
    };
    if constexpr (kFold) {
#pragma unroll 1
      for (int t0 = 0; t0 < nt; t0 += kMaxT) attend(t0, min(kMaxT, nt - t0));
    } else {
      attend(0, nt);
    }
    if constexpr (kFold) {
      // the tile's partials are out; the group that completes the
      // candidate's tiles combines them (its ticket reset for the next
      // launch, which a CUDA graph's replay is)
      __threadfence();
      wg::group_sync(cw);
      if (tg == 0) sTicket[cw] = atomicAdd(&tickets[cand], 1);
      wg::group_sync(cw);
      if (sTicket[cw] == tiles - 1) {
        __threadfence();
        final_combine<T>(part_m, part_l, part_acc, static_cast<int64_t>(cand) * tiles, tiles,
                         nt, sL, sQt, out, cand, tg, cw);
        if (tg == 0) tickets[cand] = 0;
        cur = -1;  // sQt was the combine's scratch
      }
    }
  }
}

}  // namespace t2i_hopper
}  // namespace cor
