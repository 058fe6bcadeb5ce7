// The image -> token pass of the SAM decoder redesigned for Hopper, shared
// by K1's stage 4 (twl_i2t.cu, cor_twl_i2t: 1 to 8 tokens, the rows from
// the candidates or an int8 store), K8b, the K8 route's i2t block tail
// (cor_twl_i2t at 9 to 32 tokens: kWide), and the fused transformer's two
// layers (two_way_stack.cuh, K1-stack and K1-grid: each layer's stage 4 over
// the items its schedule gives it), and K1-dma's stage 4 (kDma,
// two_way_layer_dma.cu: the tiles brought in by bulk copies, the new rows
// written by bulk stores). twl_i2t.cu describes the design and what bounds
// it.
#pragma once

#include "decoder_common.cuh"
#include "tf32_tiles.cuh"
#include "wgmma.cuh"
#include "tma.cuh"
#include "twl_hopper.cuh"

namespace cor {
namespace i2t_hopper {

using wg::Items;

constexpr int kMaxT = 8;   // K1's tokens: 5 to 8 (kWide takes 9 to kMaxTok = 32)
constexpr int kGroups = 2;  // consumer warpgroups, one 64-row tile each
// the producer warpgroup: in bf16 one thread of warp 0 streams the weight by
// TMA bulk copies, in fp32 warps 0-1 split it; warp 2 loads the tiles
constexpr int kProd = 128;
constexpr int kWThreads = 64;

template <typename T>
struct I2tL;
template <>
struct I2tL<uint16_t> {
  static constexpr int kKB = 32, kStages = 4;
  // registers a thread, handed from the producer to the consumers (the
  // epilogue holds 128 accumulators; 168 each spilled)
  static constexpr int kProdRegs = 40, kConsRegs = 232;
  static constexpr int kAV = kRows * kI * 2;  // core-matrix [64][128]
  static constexpr int kLdQ = kI + 8;          // q_img's tile [64][136]
  static constexpr int kLdO = kC + 8;          // the rows' and new rows' tile [64][264]
  static constexpr bool kStageRows = true;
};
template <>
struct I2tL<float> {
  static constexpr int kKB = 16, kStages = 2;
  // the producer splits the weight: at 104 it spilled and the pass lost
  // more than the consumers' spills at 168 had cost; at 128 neither spills
  static constexpr int kProdRegs = 128, kConsRegs = 184;
  static constexpr int kAV = kRows * (kI + 4) * 4;  // [64][132]
  static constexpr int kLdQ = kI + 4;
  static constexpr int kLdO = 0;
  static constexpr bool kStageRows = false;  // read and written in device memory
};
constexpr int kLdRaw = kC + 16;  // an int8 row tile's stride in bytes, staged for bf16

// A block of 384 threads starts with 168 registers a thread (65,536 / 384,
// rounded down to 8); what the consumers take on must be what the producer
// gave up, or their setmaxnreg.inc waits for ever (with kRestore the same
// registers go back: the consumers' setmaxnreg.dec, then the producer's
// .inc)
constexpr int kLaunchRegs = 168;
constexpr int kRegsBar = 5;  // kRestore's named barrier (1, 2: the groups'; 3: both groups')
template <typename L>
constexpr bool regs_balance() {
  return (kLaunchRegs - L::kProdRegs) * 128 >= (L::kConsRegs - kLaunchRegs) * kGroups * 128;
}
static_assert(regs_balance<I2tL<uint16_t>>() && regs_balance<I2tL<float>>(),
              "the consumers take more registers than the producer gives up");

// kDma (K1-dma) in fp32: the attention output is written over the q_img tile
// (no tile of its own), and one tile [64][260] (kShared) stages both groups'
// new rows in turn
template <typename T, bool kWide, bool kDma = false>
struct I2tSmem {
  using L = I2tL<T>;
  static constexpr bool kOne = kDma && sizeof(T) == 4;  // the shared rows tile
  // a weight block: [256][kKB] of bf16, or the two TF32 halves of one of fp32
  static constexpr int kStageBytes = kC * L::kKB * (sizeof(T) == 2 ? 2 : 8);
  static constexpr int kBlocks = kI / L::kKB;
  // the q_img tile (kWide: the attention output written over it, bf16 in
  // the core-matrix layout [64][128])
  static constexpr int kQ =
      kWide && sizeof(T) == 2 ? kRows * kI * 2 : kRows * L::kLdQ * int(sizeof(T));
  static constexpr int kO = kRows * L::kLdO * sizeof(T);
  static constexpr int kAV = kWide || kOne ? 0 : L::kAV;
  static constexpr int kTok = kWide ? kMaxTok : kMaxT;  // the tokens held
  // the tokens' keys and values [kTok][kI] fp32: per group, or (kWide) per CTA
  static constexpr int kTokBytes = 2 * kTok * kI * 4;
  static constexpr int kGroupBytes = kQ + kO + kAV + (kWide ? 0 : kTokBytes);
  static constexpr int kShared = kOne ? kRows * (kC + 4) * 4 : 0;
  // the mbarriers, after the ring, the groups' buffers, the tokens, the
  // vectors and the shared rows tile (kBars of them)
  static constexpr int kBarsAt = L::kStages * kStageBytes + kGroups * kGroupBytes +
                                 (kWide ? kTokBytes : 0) + 3 * kC * 4 + kShared;
  static constexpr int kBars = 2 * L::kStages + 4 * kGroups;
  static constexpr int kBytes = kBarsAt + kBars * 8;
};

// fp32: the producer's chunks of weight block kb (inputs kb * kKB ..) of wo
// [kC][kI], loaded into registers (fetch_wo_block, a block ahead), then split
// into their TF32 halves and stored into a ring stage (big, then small).
constexpr int kChF32 = I2tL<float>::kKB / 4;
constexpr int kPerF32 = kC * kChF32 / kWThreads;
__device__ __forceinline__ void fetch_wo_block(const float* wo, int kb, int lane,
                                               float4 (&r)[kPerF32]) {
  const float* src = wo + kb * I2tL<float>::kKB;
#pragma unroll
  for (int u = 0; u < kPerF32; ++u) {
    int o, ch;
    tf32::chunk_of<kChF32>(lane + kWThreads * u, o, ch);
    r[u] = __ldg(reinterpret_cast<const float4*>(src + o * kI) + ch);
  }
}
__device__ __forceinline__ void place_wo_block(unsigned char* stage, int lane,
                                               const float4 (&r)[kPerF32]) {
  float* dst = reinterpret_cast<float*>(stage);
#pragma unroll
  for (int u = 0; u < kPerF32; ++u) {
    int o, ch;
    tf32::chunk_of<kChF32>(lane + kWThreads * u, o, ch);
    tf32::store_split4(dst, dst + kC * I2tL<float>::kKB, tf32::chunk_offset(o, ch, kChF32),
                       r[u]);
  }
}

// One warp starts copying `rows` rows of `bytes` bytes each (a multiple of
// 16), src rows contiguous, into dst with a row stride of ld bytes.
__device__ __forceinline__ void copy_rows(unsigned char* dst, int ld, const void* src,
                                          int rows, int bytes, int lane) {
  const int ch = bytes / 16;
  const unsigned char* s = static_cast<const unsigned char*>(src);
#pragma unroll 8
  for (int f = lane; f < rows * ch; f += 32) {
    const int r = f / ch, c = f % ch;
    wg::cp16(dst + r * ld + c * 16, s + static_cast<int64_t>(r) * bytes + c * 16, 16u);
  }
}

// One warp starts copying a q_img tile [kRows][kI] of bf16 (rows
// contiguous) into dst in the core-matrix layout, eight lanes a core matrix.
__device__ __forceinline__ void copy_q_cm(unsigned char* dst, const uint16_t* src, int lane) {
  constexpr int kCh = kI / 8;
#pragma unroll 8
  for (int f = lane; f < kRows * kCh; f += 32) {
    int r, c;
    tf32::chunk_of<kCh>(f, r, c);
    wg::cp16(dst + 2 * wg::cm_offset(r, 8 * c, kCh), src + r * kI + 8 * c, 16u);
  }
}

// 16 values of row r, columns c0 .. c0 + 15, of a core-matrix bf16 tile of
// kI / 8 chunks a row, as fp32
__device__ __forceinline__ void load16_cm(const uint16_t* tile, int r, int c0, float (&v)[16]) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const uint4 u = *reinterpret_cast<const uint4*>(tile + wg::cm_offset(r, c0 + 8 * c, kI / 8));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[8 * c + 2 * e] = bf2f(static_cast<uint16_t>(w[e] & 0xffffu));
      v[8 * c + 2 * e + 1] = bf2f(static_cast<uint16_t>(w[e] >> 16));
    }
  }
}

// kDma: the 32 lanes of a warp start copying `rows` rows of `bytes` bytes
// each (a multiple of 16), src rows contiguous, into dst with a row stride
// of ld bytes, by bulk copies completing on bar (lane 0 arms it)
__device__ __forceinline__ void bulk_rows(unsigned char* dst, int ld, const void* src, int bytes,
                                          int lane, uint64_t* bar) {
  if (lane == 0) wg::mbar_expect_tx(bar, kRows * bytes);
  __syncwarp();
  const unsigned char* s = static_cast<const unsigned char*>(src);
  for (int r = lane; r < kRows; r += 32)
    wg::bulk_copy(dst + r * ld, s + static_cast<int64_t>(r) * bytes, bytes, bar);
}

// both consumer warpgroups (named barrier 3, 256 threads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
}

// The pass, run by a block of kGroups consumer warpgroups and the producer
// warpgroup over the dynamic shared memory smem: K1's stage 4 at 1 to kMaxT
// tokens, K8b's (kWide, no int8 store) at 9 to kMaxTok. walk(items): the
// items this CTA takes (RoundRobin: K1's and K8b's persistent grids).
// kRestore: both warpgroups hand back the registers setmaxnreg moved before
// they leave the pass, so that a kernel that runs other stages afterwards
// (two_way_stack.cuh) finds every thread at kLaunchRegs again. kMove: the
// registers moved at all (else every thread runs the pass at kLaunchRegs).
// kDma (K1-dma, 1 to kMaxT tokens): the q_img tiles (and in bf16 the rows)
// come in by bulk copies, and the new rows go out by bulk stores from their
// staged tile, which is reused once the stores have read it; in fp32 the
// rows are read from device memory as K1 reads them, and the new rows are
// staged in one tile that the groups take in turn.
template <typename T, bool kInt8, bool kWide, bool kRestore = false,
          typename Walk = wg::RoundRobin, bool kMove = true, bool kDma = false>
__device__ __forceinline__ void i2t_pass(
    unsigned char* smem, const void* __restrict__ src, const int* __restrict__ idx,
    const float* __restrict__ scale, int S, int n, int N, const T* __restrict__ q_img,
    const T* __restrict__ k_i, const T* __restrict__ v_i, int nt, const T* __restrict__ wo,
    const T* __restrict__ wo_blocks, const float* __restrict__ bo_ln, float eps,
    float cross_scale, T* __restrict__ out, Walk walk = Walk()) {
  using L = I2tL<T>;
  using M = I2tSmem<T, kWide, kDma>;
  using E = Elem<T>;
  static_assert(!(kDma && kWide), "K1-dma's stage 4 takes at most kMaxT tokens");
  // the new rows staged in shared memory (bf16, or fp32 kDma in the shared
  // tile), and the rows read from there (bf16: the producer brings them)
  constexpr bool kStage = L::kStageRows || kDma;
  constexpr bool kRowsIn = L::kStageRows;
  // the rows' (or new rows') stride in elements of the staged tile
  constexpr int kLdO = L::kStageRows ? L::kLdO : kC + 4;
  // the tokens whose logits are summed side by side (fp32 kWide: a step of
  // its online softmax)
  constexpr int kTc = kWide ? 4 : 1;
  unsigned char* ring = smem;
  unsigned char* groups = smem + L::kStages * M::kStageBytes;
  // kWide: the CTA's tokens' keys and values
  float* sTok = reinterpret_cast<float*>(groups + kGroups * M::kGroupBytes);
  float* sBo = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(sTok) +
                                        (kWide ? M::kTokBytes : 0));  // bo, ln4 s, b
  unsigned char* shared_rows = reinterpret_cast<unsigned char*>(sBo + 3 * kC);  // M::kOne
  uint64_t* full = reinterpret_cast<uint64_t*>(shared_rows + M::kShared);
  uint64_t* empty = full + L::kStages;
  uint64_t* q_full = empty + L::kStages;  // [kGroups]: a group's q_img tile has landed
  uint64_t* q_empty = q_full + kGroups;   // its attention has read it
  uint64_t* rows_full = q_empty + kGroups;  // its rows tile has landed (bf16)
  uint64_t* rows_empty = rows_full + kGroups;  // its new rows are out of it

  const int tiles = N / kRows;
  const int per_cand = (tiles + kGroups - 1) / kGroups;
  const int items = n * per_cand;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      wg::mbar_init(&full[s], sizeof(T) == 2 ? 1 : 2 * kWThreads);
      wg::mbar_init(&empty[s], kGroups * 128);
    }
    for (int gi = 0; gi < kGroups; ++gi) {
      // kDma: lane 0's arrival, with the bulk copies' bytes
      wg::mbar_init(&q_full[gi], kDma ? 1 : 2 * 32);
      wg::mbar_init(&q_empty[gi], 128);
      wg::mbar_init(&rows_full[gi], kDma ? 1 : 2 * 32);
      wg::mbar_init(&rows_empty[gi], 128);
    }
    wg::mbar_init_fence();
  }
  for (int i = tid; i < 3 * kC; i += blockDim.x) sBo[i] = bo_ln[i];
  __syncthreads();

  if (tid >= kGroups * 128) {
    if constexpr (kMove && L::kProdRegs != kLaunchRegs) wg::regs_dec<L::kProdRegs>();
    const int p = tid - kGroups * 128, lane = tid & 31;
    // kDma: item `item` (the it-th of this CTA, candidate cand)'s tiles by
    // bulk copies: each group's q_img tile once its products have read the
    // last one, then (bf16) its rows once its last new rows are out. A tile
    // past the candidate's (an odd tile count) copies tile 0, unread.
    auto dma_tiles = [&](int item, int it, int cand, int lane) {
      for (int gi = 0; gi < kGroups; ++gi) {
        const int tile = (item % per_cand) * kGroups + gi;
        const int r0 = (tile < tiles ? tile : 0) * kRows;
        if (it > 0) wg::mbar_wait(&q_empty[gi], (it - 1) & 1);
        bulk_rows(groups + gi * M::kGroupBytes, L::kLdQ * int(sizeof(T)),
                  q_img + (static_cast<int64_t>(cand) * N + r0) * kI, kI * int(sizeof(T)), lane,
                  &q_full[gi]);
      }
      const int row = source_row(idx, cand, S);
      for (int gi = 0; gi < kGroups && kRowsIn; ++gi) {
        const int tile = (item % per_cand) * kGroups + gi;
        const int r0 = (tile < tiles ? tile : 0) * kRows;
        if (it > 0) wg::mbar_wait(&rows_empty[gi], (it - 1) & 1);
        bulk_rows(groups + gi * M::kGroupBytes + M::kQ, kInt8 ? kLdRaw : kLdO * int(sizeof(T)),
                  row_tile<kInt8, T>(src, row, N, r0), kInt8 ? kC : kC * int(sizeof(T)), lane,
                  &rows_full[gi]);
      }
    };
    if (p < kWThreads) {
      // the weight ring, kBlocks blocks an item
      const int total = walk(items).count() * M::kBlocks;
      if constexpr (sizeof(T) == 2) {
        // one bulk copy a block, from the weight laid out block by block as
        // the ring holds it (wo_blocks)
        if (p == 0) {
          for (int j = 0; j < total; ++j) {
            const int s = j % L::kStages;
            if (j >= L::kStages) wg::mbar_wait(&empty[s], (j / L::kStages - 1) & 1);
            wg::mbar_expect_tx(&full[s], M::kStageBytes);
            wg::bulk_copy(ring + s * M::kStageBytes,
                          wo_blocks + (j % M::kBlocks) * (M::kStageBytes / 2), M::kStageBytes,
                          &full[s]);
          }
        }
      } else {
        float4 r[kPerF32];
        fetch_wo_block(wo, 0, p, r);
        for (int j = 0; j < total; ++j) {
          const int s = j % L::kStages;
          if (j >= L::kStages) wg::mbar_wait(&empty[s], (j / L::kStages - 1) & 1);
          place_wo_block(ring + s * M::kStageBytes, p, r);
          if (j + 1 < total) fetch_wo_block(wo, (j + 1) % M::kBlocks, p, r);
          wg::mbar_arrive_copies(&full[s]);
          wg::mbar_arrive(&full[s]);
        }
      }
    } else if (p < kWThreads + 32) {
      // the tiles: each group's q_img rows once its attention has read the
      // last ones, and (bf16) its rows once its new rows are out
      int it = 0;
      const Items r = walk(items);
      for (int item = r.first; item < r.end; item += r.step, ++it) {
        const int cand = item / per_cand;
        if constexpr (kDma) {
          dma_tiles(item, it, cand, lane);
          continue;
        }
        for (int gi = 0; gi < kGroups; ++gi) {
          const int tile = (item % per_cand) * kGroups + gi;
          if (it > 0) wg::mbar_wait(&q_empty[gi], (it - 1) & 1);
          const T* qsrc = q_img + (static_cast<int64_t>(cand) * N + tile * kRows) * kI;
          if (tile < tiles) {
            if constexpr (kWide && sizeof(T) == 2)
              copy_q_cm(groups + gi * M::kGroupBytes, qsrc, lane);
            else
              copy_rows(groups + gi * M::kGroupBytes, L::kLdQ * sizeof(T), qsrc, kRows,
                        kI * sizeof(T), lane);
          }
          wg::mbar_arrive_copies(&q_full[gi]);
          wg::mbar_arrive(&q_full[gi]);
        }
        if constexpr (L::kStageRows) {
          const int row = source_row(idx, cand, S);
          for (int gi = 0; gi < kGroups; ++gi) {
            const int tile = (item % per_cand) * kGroups + gi;
            if (it > 0) wg::mbar_wait(&rows_empty[gi], (it - 1) & 1);
            if (tile < tiles)
              copy_rows(groups + gi * M::kGroupBytes + M::kQ,
                        kInt8 ? kLdRaw : L::kLdO * int(sizeof(T)),
                        row_tile<kInt8, T>(src, row, N, tile * kRows), kRows,
                        kInt8 ? kC : kC * int(sizeof(T)), lane);
            wg::mbar_arrive_copies(&rows_full[gi]);
            wg::mbar_arrive(&rows_full[gi]);
          }
        }
      }
    }
    cp_async_wait<0>();
    if constexpr (kMove && kRestore && L::kProdRegs != kLaunchRegs) {
      // only once the consumers have handed theirs back: a producer done
      // early (no items) would take its registers back before the
      // consumers' .inc, which would then wait for ever
      wg::bar_sync<kRegsBar, kGroups * 128 + kProd>();
      wg::regs_inc<kLaunchRegs>();
    }
    return;
  }

  if constexpr (kMove && L::kConsRegs != kLaunchRegs) wg::regs_inc<L::kConsRegs>();
  const int cw = tid >> 7, tg = tid & 127, warp = tg >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* mine = groups + cw * M::kGroupBytes;
  T* sQ = reinterpret_cast<T*>(mine);
  // the staged rows (raw int8 or T), then the new rows: bf16 the group's own,
  // fp32 kDma the shared tile
  unsigned char* sO = M::kOne ? shared_rows : mine + M::kQ;
  T* sAV = kWide || M::kOne ? sQ : reinterpret_cast<T*>(mine + M::kQ + M::kO);
  float* sKi = kWide ? sTok : reinterpret_cast<float*>(mine + M::kQ + M::kO + M::kAV);
  float* sVi = sKi + M::kTok * kI;
  const uint32_t av_addr = wg::smem_u32(sAV);
  const uint32_t ring_addr = wg::smem_u32(ring);
  int j = 0, it = 0, cur = -1;

  const Items r = walk(items);
  for (int item = r.first; item < r.end; item += r.step, ++it) {
    const int cand = item / per_cand;
    const int tile = (item % per_cand) * kGroups + cw;
    const bool valid = tile < tiles;
    const int r0 = tile * kRows;
    const int row = source_row(idx, cand, S);
    const float sc = kInt8 ? scale[row] : 1.f;
    if (kWide && cand != cur) {
      // the candidate's token keys and values, once both groups are done
      // with the last candidate's (rows nt .. kMaxTok - 1 zeroed)
      consumers_sync();
      for (int i = tid; i < kMaxTok * kI; i += kGroups * 128) {
        const bool in = i < nt * kI;
        sKi[i] = in ? E::get(k_i[static_cast<int64_t>(cand) * nt * kI + i]) : 0.f;
        sVi[i] = in ? E::get(v_i[static_cast<int64_t>(cand) * nt * kI + i]) : 0.f;
      }
      cur = cand;
      consumers_sync();
    }
    wg::mbar_wait(&q_full[cw], it & 1);
    if (valid) {
      if (!kWide && cand != cur) {  // the candidate's token keys and values
        for (int i = tg; i < nt * kI; i += 128) {
          sKi[i] = E::get(k_i[static_cast<int64_t>(cand) * nt * kI + i]);
          sVi[i] = E::get(v_i[static_cast<int64_t>(cand) * nt * kI + i]);
        }
        cur = cand;
        wg::group_sync(cw);
      }
      // per (row r, head h): the softmax over the nt tokens and its product
      // with the values, in the shared body's order (i2t_attention.cuh)
      const int r = tg & 63;
#pragma unroll 1
      for (int h = tg >> 6; h < kHeads; h += 2) {
        float q[kCrossD];
        if constexpr (kWide && sizeof(T) == 2)
          load16_cm(reinterpret_cast<const uint16_t*>(sQ), r, h * kCrossD, q);
        else
          wg::load16(sQ + r * L::kLdQ + h * kCrossD, q);
#pragma unroll
        for (int i = 0; i < kCrossD; ++i) q[i] = E::round(q[i] * cross_scale);
        float a[kCrossD];
        if constexpr (kWide && sizeof(T) == 4) {
          // fp32 (bits not kept): an online softmax over the tokens kTc at a
          // time in a loop, with no array of every logit and one division
          float m = -INFINITY, sum = 0.f;
#pragma unroll
          for (int d = 0; d < kCrossD; ++d) a[d] = 0.f;
#pragma unroll 1
          for (int t0 = 0; t0 < nt; t0 += kTc) {
            float s[kTc];
#pragma unroll
            for (int u = 0; u < kTc; ++u) s[u] = 0.f;
#pragma unroll
            for (int d = 0; d < kCrossD; ++d)
#pragma unroll
              for (int u = 0; u < kTc; ++u)
                s[u] += q[d] * sKi[(t0 + u) * kI + h * kCrossD + d];
            float mc = m;
#pragma unroll
            for (int u = 0; u < kTc; ++u)
              if (t0 + u < nt) mc = fmaxf(mc, s[u]);
            const float c = expf(m - mc);  // 0 at the first chunk
            sum *= c;
#pragma unroll
            for (int d = 0; d < kCrossD; ++d) a[d] *= c;
#pragma unroll
            for (int u = 0; u < kTc; ++u) {
              const float e = t0 + u < nt ? expf(s[u] - mc) : 0.f;
              const float* v = sVi + (t0 + u) * kI + h * kCrossD;
              sum += e;
#pragma unroll
              for (int d = 0; d < kCrossD; ++d) a[d] += e * v[d];
            }
            m = mc;
          }
          const float inv = 1.f / sum;
#pragma unroll
          for (int d = 0; d < kCrossD; ++d) a[d] *= inv;
        } else {
          // the logits of kTc tokens side by side, each summed over d in order
          float l[M::kTok], m = -INFINITY;
#pragma unroll
          for (int t0 = 0; t0 < M::kTok; t0 += kTc) {
            if (t0 >= nt) break;
            float s[kTc];
#pragma unroll
            for (int u = 0; u < kTc; ++u) s[u] = 0.f;
#pragma unroll
            for (int d = 0; d < kCrossD; ++d)
#pragma unroll
              for (int u = 0; u < kTc; ++u) s[u] += q[d] * sKi[(t0 + u) * kI + h * kCrossD + d];
#pragma unroll
            for (int u = 0; u < kTc; ++u) {
              l[t0 + u] = s[u];
              if (t0 + u < nt) m = fmaxf(m, s[u]);
            }
          }
          float sum = 0.f;
#pragma unroll
          for (int tt = 0; tt < M::kTok; ++tt) {
            if (tt >= nt) break;
            l[tt] = expf(l[tt] - m);
            sum += l[tt];
          }
#pragma unroll
          for (int d = 0; d < kCrossD; ++d) a[d] = 0.f;
#pragma unroll
          for (int tt = 0; tt < M::kTok; ++tt) {
            if (tt >= nt) break;
            const float p = E::round(l[tt] / sum);
            const float* v = sVi + tt * kI + h * kCrossD;
#pragma unroll
            for (int d = 0; d < kCrossD; ++d) a[d] += p * v[d];
          }
        }
        if constexpr (sizeof(T) == 2) {
          // chunks 2h and 2h + 1 of row r in the core-matrix layout
#pragma unroll
          for (int c = 0; c < 2; ++c)
            *reinterpret_cast<uint4*>(sAV + wg::cm_offset(r, h * kCrossD + 8 * c, kI / 8)) =
                make_uint4(pack_bf16x2(a[8 * c], a[8 * c + 1]),
                           pack_bf16x2(a[8 * c + 2], a[8 * c + 3]),
                           pack_bf16x2(a[8 * c + 4], a[8 * c + 5]),
                           pack_bf16x2(a[8 * c + 6], a[8 * c + 7]));
        } else {
#pragma unroll
          for (int c = 0; c < kCrossD; c += 4)
            *reinterpret_cast<float4*>(sAV + r * (kI + 4) + h * kCrossD + c) =
                make_float4(a[c], a[c + 1], a[c + 2], a[c + 3]);
        }
      }
    }
    if constexpr (!kWide && !M::kOne) wg::mbar_arrive(&q_empty[cw]);
    wg::group_sync(cw);  // the attention output complete
    wg::fence_proxy_async();

    // the out-projection [64 x kI] x [kI -> kC] over the ring's blocks
    float acc[kC / 8][4];
#pragma unroll
    for (int q = 0; q < kC / 8; ++q) acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.f;
    int prev = -1;
#pragma unroll 1
    for (int kb = 0; kb < M::kBlocks; ++kb, ++j) {
      const int s = j % L::kStages;
      wg::mbar_wait(&full[s], (j / L::kStages) & 1);
      wg::fence_proxy_async();
      const uint32_t stage = ring_addr + s * M::kStageBytes;
      if constexpr (sizeof(T) == 2) {
        wg::fence_regs(acc);
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < L::kKB / 16; ++kk)
          wg::mma_ss_n256(acc, wg::desc_k(av_addr, kI / 8, kb * (L::kKB / 16) + kk),
                          wg::desc_k(stage, L::kKB / 8, kk), 1);
        wg::commit();
        wg::wait<1>();
        wg::fence_regs(acc);
        if (prev >= 0) wg::mbar_arrive(&empty[prev]);
        prev = s;
      } else {
        const float* av = reinterpret_cast<const float*>(sAV);
        FragA a[L::kKB / 8];
#pragma unroll
        for (int kk = 0; kk < L::kKB / 8; ++kk)
          a[kk] = load_a_tf32(av, kI + 4, warp * 16, kb * L::kKB + kk * 8, g, t);
        constexpr uint32_t kHalf = kC * L::kKB * 4;
        wg::fence_regs(acc);
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < L::kKB / 8; ++kk) {
          wg::mma_tf32_rs_n256(acc, a[kk].small, wg::desc_k(stage, L::kKB / 4, kk), 1);
          wg::mma_tf32_rs_n256(acc, a[kk].big, wg::desc_k(stage + kHalf, L::kKB / 4, kk), 1);
          wg::mma_tf32_rs_n256(acc, a[kk].big, wg::desc_k(stage, L::kKB / 4, kk), 1);
        }
        wg::commit();
        wg::wait<0>();
        wg::fence_regs(acc);
        wg::mbar_arrive(&empty[s]);
      }
    }
    if constexpr (sizeof(T) == 2) {
      wg::wait<0>();
      wg::fence_regs(acc);
      wg::mbar_arrive(&empty[prev]);
    }
    // kWide, fp32 kDma: the attention output, written over q_img's tile, is read
    if constexpr (kWide || M::kOne) wg::mbar_arrive(&q_empty[cw]);

    // + bias + the rows, LayerNorm over kC: the shared body's epilogue, the
    // rows read from (and, bf16, the new rows written through) the staged
    // tile
    if constexpr (kRowsIn) wg::mbar_wait(&rows_full[cw], it & 1);
    // fp32 K1-dma: the shared tile's turn, once the other group's new rows
    // of its last use are read out of it
    auto take_turn = [&]() {
      if constexpr (kStage && !kRowsIn) {
        if (cw == 1)
          wg::mbar_wait(&rows_empty[0], it & 1);
        else if (it > 0)
          wg::mbar_wait(&rows_empty[1], (it - 1) & 1);
      }
    };
    if (!valid) take_turn();
    if (valid) {
      const void* rows_tile = kRowsIn ? static_cast<const void*>(sO)
                                      : row_tile<kInt8, T>(src, row, N, r0);
      const int ldr = !kRowsIn ? kC : (kInt8 ? kLdRaw : kLdO);
      const int ra = warp * 16 + g, rb = ra + 8;
      float sa = 0.f, sb = 0.f;
#pragma unroll
      for (int q = 0; q < kC / 8; ++q) {
        const int col = q * 8 + 2 * t;
        float x0, x1, x2, x3;
        tile_pair<kInt8, T>(rows_tile, ldr, ra, col, sc, x0, x1);
        tile_pair<kInt8, T>(rows_tile, ldr, rb, col, sc, x2, x3);
        acc[q][0] += sBo[col] + x0;
        acc[q][1] += sBo[col + 1] + x1;
        acc[q][2] += sBo[col] + x2;
        acc[q][3] += sBo[col + 1] + x3;
        sa += acc[q][0] + acc[q][1];
        sb += acc[q][2] + acc[q][3];
      }
      const float ma = quad_sum(sa) / kC, mb = quad_sum(sb) / kC;
      float va = 0.f, vb = 0.f;
#pragma unroll
      for (int q = 0; q < kC / 8; ++q) {
        va += (acc[q][0] - ma) * (acc[q][0] - ma) + (acc[q][1] - ma) * (acc[q][1] - ma);
        vb += (acc[q][2] - mb) * (acc[q][2] - mb) + (acc[q][3] - mb) * (acc[q][3] - mb);
      }
      const float ia = rsqrtf(quad_sum(va) / kC + eps), ib = rsqrtf(quad_sum(vb) / kC + eps);
      const float* s4 = sBo + kC;
      const float* b4 = sBo + 2 * kC;
      T* oa;
      T* ob;
      if constexpr (kStage) {
        if constexpr (kRowsIn)
          wg::group_sync(cw);  // every row read (an int8 tile lies under the new rows)
        else
          take_turn();
        oa = reinterpret_cast<T*>(sO) + ra * kLdO;
        ob = reinterpret_cast<T*>(sO) + rb * kLdO;
      } else {
        oa = out + (static_cast<int64_t>(cand) * N + r0 + ra) * kC;
        ob = out + (static_cast<int64_t>(cand) * N + r0 + rb) * kC;
      }
#pragma unroll
      for (int q = 0; q < kC / 8; ++q) {
        const int col = q * 8 + 2 * t;
        E::put2(oa + col, (acc[q][0] - ma) * ia * s4[col] + b4[col],
                (acc[q][1] - ma) * ia * s4[col + 1] + b4[col + 1]);
        E::put2(ob + col, (acc[q][2] - mb) * ib * s4[col] + b4[col],
                (acc[q][3] - mb) * ib * s4[col + 1] + b4[col + 1]);
      }
      if constexpr (kDma) {
        // the new rows by bulk stores, a row a store, by the lanes of warp 0,
        // each waiting until its stores have read the tile before it frees it
        wg::fence_proxy_async();
        wg::group_sync(cw);
        if (warp == 0) {
          T* o = out + (static_cast<int64_t>(cand) * N + r0) * kC;
          for (int r = lane; r < kRows; r += 32)
            tma::store(o + r * kC, reinterpret_cast<const T*>(sO) + r * kLdO, kC * sizeof(T));
          tma::store_commit();
          tma::store_wait_read();
        }
      } else if constexpr (L::kStageRows) {
        // the new rows, 16 bytes a thread and whole rows a warp
        wg::group_sync(cw);
        constexpr int kCh = kC * sizeof(T) / 16;
        T* o = out + (static_cast<int64_t>(cand) * N + r0) * kC;
#pragma unroll 4
        for (int f = tg; f < kRows * kCh; f += 128) {
          const int r = f / kCh, ch = f % kCh;
          *reinterpret_cast<uint4*>(o + r * kC + ch * (16 / sizeof(T))) =
              *reinterpret_cast<const uint4*>(reinterpret_cast<const T*>(sO) + r * L::kLdO +
                                              ch * (16 / sizeof(T)));
        }
      }
    }
    if constexpr (kStage) wg::mbar_arrive(&rows_empty[cw]);
    wg::group_sync(cw);  // the attention output free for the next item
  }
  if constexpr (kMove && kRestore && L::kConsRegs != kLaunchRegs) {
    wg::regs_dec<kLaunchRegs>();
    wg::bar_arrive<kRegsBar, kGroups * 128 + kProd>();
  }
}

}  // namespace i2t_hopper
}  // namespace cor
