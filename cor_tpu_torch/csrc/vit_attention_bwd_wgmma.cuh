// K6b in bf16, redesigned for Hopper: the backward of K6 (vit_attention.cu)
// on wgmma with asynchronous tile loads. The function, the TPU kernel it
// replaces and the fp32 kernels are described in vit_attention_bwd.cu; this
// header holds the bf16 kernels, instantiated per head_dim in
// vit_attention_bwd_d64.cu and vit_attention_bwd_d80.cu.
//
// What bounds it on the H100: at the global blocks (N = 4096) operations.
// The design runs seven N x N x D products where the gradient needs five
// (the first design ran nine), in three launches, deterministic, without
// atomics:
//  0. prep: one block per token row writes bf16(q * scale) [B, N, C] into
//     scratch (the rounding point of cor_tpu's logits and dK: at D = 80 the
//     scale is not a power of two, and a tile copied by cp.async cannot be
//     scaled on the way, so the passes load the scaled copy; 12.6 MB at
//     SAM-base's global shape) and delta_i = sum_d do_i,d out_i,d in fp32
//     over the forward's bf16 out (what SDPA's and FlashAttention's
//     backwards do; cor_tpu sums a * da exactly, which differs by the bf16
//     rounding of out: a known, deliberate difference). The rows'
//     log-sum-exp comes from the forward (K6 writes it beside out), so no
//     pass recomputes the statistics;
//  1. dq: one block per (64-query tile, head, image): S = bf16(q * scale)
//     K^T and dP = dO V^T, then a = exp(S + bias - lse) and bf16(dl) =
//     bf16(a (dP - delta)) per key tile, dQ += bf16(dl) K, and the bias
//     gradients. Three products per key tile;
//  2. dk/dv: one block per (64-key tile, head, image): S^T = K bf16(q *
//     scale)^T and dP^T = V dO^T per query tile, a^T and dl^T from the
//     rows' lse and delta, dV += bf16(a^T) dO and dK += bf16(dl^T)
//     bf16(q * scale). Four products per query tile.
// Each pass is one consumer warpgroup (128 threads, 16 rows a warp) and one
// producer warp (160 threads a block). The producer copies the block's own
// tiles once, then streams the other side's 64-row tiles with cp.async into
// a ring of kStages = 2 stages in wgmma's core-matrix layout (wgmma.cuh),
// rows past N zero-filled, handed over by a full and an empty mbarrier per
// stage (wgmma.cuh), so loads overlap the products. Every product is
// wgmma: the logits and dP m64n64k16 (the dk/dv pass: m64n32k16, a query
// tile in two halves, to keep the logits of 32 queries live beside dK and
// dV and not 64) with
// both operands from shared memory, K-major ([token][d] tiles); dQ, dV and
// dK m64nDk16 with the rounded a or dl as register A fragments (the
// accumulators of S or S^T, rows = the block's own tokens) and the streamed
// [token][d] tile as an N-major B operand, so nothing is transposed in
// shared memory. The bias gradients, three ways (BiasGrad):
//  - W = 64 (the global blocks): a 64-key tile is one key-grid row r = k0 /
//    64, so drel_h[:, r] is the tile's row sum of bf16(dl) (four lanes
//    shuffle, one writes an fp32 [64][H + 1] tile) and drel_w accumulates
//    the bf16(dl) tile itself in registers, in the accumulator's layout,
//    across the key tiles; no shared-memory fold;
//  - H + W <= 32 (the 14 x 14 windows, whose tiles span key rows):
//    cor_tpu's product, [drel_h | drel_w] += bf16(dl) [Eh | Ew], the
//    tile's keys against an indicator matrix built once per block in shared
//    memory ([tiles * 64][32] bf16), a wgmma m64n32k16 with bf16(dl) as the
//    register A operand it already is for dQ (four more products a tile);
//  - any other grid: bf16(dl) goes through an fp32 [64][65] tile and each
//    lane folds one (row, rel_h or rel_w) over it into fp32 [64][H + 1] and
//    [64][W + 1] tiles, the first design's fold.
// Sums are fp32 and rounded once. Rounding points are cor_tpu's: q * scale
// in bf16; logits, a, dP and dl in fp32; a and dl rounded to bf16 before
// their products; dq * scale, dk, dv and the bias gradients rounded once.
// Keys and queries past N are masked.
//
// Shared memory (dynamic, raised per launch; T = 64 D bf16 = 8,192 bytes
// at D = 64, 10,240 at 80):
//  - dq: Q, dO and two stages of K and V (6 T), the block's bias rows
//    [64][H] + [64][W] bf16, and the fp32 [64][H + 1] rel_h tile (W = 64;
//    82,216 bytes at D = 64 global, 94,504 at 80), the indicator matrix
//    (H + W <= 32; 69,160 and 81,448 at 14 x 14) or the fold's fp32 tiles;
//    two blocks an SM;
//  - dk/dv: K, V and two stages of Q, dO, the bias rows and lse and delta
//    [64] fp32: 82,984 bytes at D = 64 global, 95,272 at 80 (two blocks an
//    SM); 57,384 and 69,672 at 14 x 14.
#pragma once

#include "decoder_common.cuh"
#include "wgmma.cuh"

namespace cor {
namespace k6b {

constexpr int kT = 64;                    // query and key rows per tile (16 per warp)
constexpr int kConsumers = 128;           // one consumer warpgroup
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kStages = 2;                // the streamed tiles' ring
constexpr int kMaxSide = 64;              // H, W <= 64
constexpr int kPrepThreads = 128;
constexpr int kMaxC = 4096;               // prep: C / 8 partial dot products in shared memory
constexpr float kLog2e = 1.4426950408889634f;

// How the dq pass sums the bias gradients: kRowSums (W = 64: a key tile is
// one key-grid row), kIndicator (H + W <= 32: a product against [Eh | Ew],
// as cor_tpu's kernel does), kFold (any other grid: a shared-memory fold)
enum BiasGrad { kRowSums = 0, kIndicator = 1, kFold = 2 };

// s (this lane's logits of query rows g and g + 8 against keys k0 + 8n + 2t
// + e) -> log2-domain logits with the bias rows' factors (of the element type
// T) added; keys >= N -> -inf
template <typename T>
__device__ __forceinline__ void bias_log2(float (&s)[kT / 8][4], const T* rh0, const T* rw0,
                                          const T* rh1, const T* rw1, int k0, int t, int N,
                                          int W) {
  using E = cor::Elem<T>;
  int jh = (k0 + 2 * t) / W;
  int jw = (k0 + 2 * t) - jh * W;
#pragma unroll
  for (int n = 0; n < kT / 8; ++n) {
    const int key = k0 + n * 8 + 2 * t;
    int jh1 = jh, jw1 = jw + 1;  // key + 1
    if (jw1 == W) {
      jw1 = 0;
      ++jh1;
    }
    if (key < N) {
      s[n][0] = (s[n][0] + E::get(rh0[jh]) + E::get(rw0[jw])) * kLog2e;
      s[n][2] = (s[n][2] + E::get(rh1[jh]) + E::get(rw1[jw])) * kLog2e;
    } else {
      s[n][0] = s[n][2] = -INFINITY;
    }
    if (key + 1 < N) {
      s[n][1] = (s[n][1] + E::get(rh0[jh1]) + E::get(rw0[jw1])) * kLog2e;
      s[n][3] = (s[n][3] + E::get(rh1[jh1]) + E::get(rw1[jw1])) * kLog2e;
    } else {
      s[n][1] = s[n][3] = -INFINITY;
    }
    jw += 8;
    while (jw >= W) {
      jw -= W;
      ++jh;
    }
  }
}

// The bf16 launches of one backward (prep, dq, dk/dv). stats: scratch of
// qs_offset_floats(B * heads * N) fp32 (delta), then B * N * C bf16 (bf16(q *
// scale)).
int launch_bf16_d64(const void* qkv, const void* rel_h, const void* rel_w, const void* dout,
                    const void* out, const void* lse, void* dqkv, void* drel_h, void* drel_w,
                    void* stats, int B, int N, int C, int num_heads, int H, int W, float scale,
                    cudaStream_t stream);
int launch_bf16_d80(const void* qkv, const void* rel_h, const void* rel_w, const void* dout,
                    const void* out, const void* lse, void* dqkv, void* drel_h, void* drel_w,
                    void* stats, int B, int N, int C, int num_heads, int H, int W, float scale,
                    cudaStream_t stream);

// where bf16(q * scale) starts in the scratch: after delta, 16-byte aligned
inline __host__ __device__ int64_t qs_offset_floats(int64_t rows) { return (rows + 3) / 4 * 4; }

namespace wg = cor::wg;

// bytes of shared memory of each pass, and where its regions start
template <int D>
struct Plan {
  static constexpr int kTile = kT * D;  // bf16 elements of a [64][D] tile
  static constexpr int kCh = D / 8;     // 16-byte chunks of a tile row
  static __host__ __device__ int pad16(int bytes) { return (bytes + 15) / 16 * 16; }
  // dq: tiles (Q, dO, kStages x K, V), bias rows, the indicator tiles
  // (kIndicator: [tiles * 64][32] bf16), fp32 tiles, barriers
  static __host__ __device__ int dq_bias(int H, int W) { return pad16(kT * (H + W) * 2); }
  static __host__ __device__ int dq_ind(int N, int bias) {
    return bias == kIndicator ? (N + kT - 1) / kT * kT * 32 * 2 : 0;
  }
  static __host__ __device__ int dq_floats(int H, int W, int bias) {
    return bias == kIndicator ? 0
                              : kT * (H + 1) + (bias == kRowSums ? 0 : kT * (W + 1) + kT * 65);
  }
  static __host__ __device__ int dq_bytes(int H, int W, int N, int bias) {
    return (2 + 2 * kStages) * kTile * 2 + dq_bias(H, W) + dq_ind(N, bias) +
           dq_floats(H, W, bias) * 4 + (1 + 2 * kStages) * 8;
  }
  // dk/dv: tiles (K, V, kStages x Q, dO), then per stage the bias rows,
  // lse and delta, barriers
  static __host__ __device__ int dkv_extra(int H, int W) {
    return pad16(kT * H * 2) + pad16(kT * W * 2) + 2 * kT * 4;
  }
  static __host__ __device__ int dkv_bytes(int H, int W) {
    return (2 + 2 * kStages) * kTile * 2 + kStages * dkv_extra(H, W) + (1 + 2 * kStages) * 8;
  }
};

// two bf16 in one 32-bit word, each times s, rounded back to bf16
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t w, float s) {
  return pack_bf16x2(bf2f(static_cast<uint16_t>(w & 0xffffu)) * s,
                     bf2f(static_cast<uint16_t>(w >> 16)) * s);
}

// the fp32 dot product of 8 bf16 pairs
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s += bf2f(static_cast<uint16_t>(x[i] & 0xffffu)) * bf2f(static_cast<uint16_t>(y[i] & 0xffffu));
    s += bf2f(static_cast<uint16_t>(x[i] >> 16)) * bf2f(static_cast<uint16_t>(y[i] >> 16));
  }
  return s;
}

// One block per token row (b, i): qs[b, i] = bf16(q * scale); delta[b, h, i]
// = sum_d do[b, i, hD + d] out[b, i, hD + d], fp32, chunk partials summed in
// order.
template <int D>
__global__ void __launch_bounds__(kPrepThreads)
vit_attention_bwd_prep_kernel(const uint16_t* __restrict__ qkv, const uint16_t* __restrict__ dout,
                              const uint16_t* __restrict__ out, uint16_t* __restrict__ qs,
                              float* __restrict__ delta, int N, int C, int heads, float scale) {
  __shared__ float part[kMaxC / 8];
  const int64_t row = blockIdx.x;
  const int64_t b = row / N;
  const int i = static_cast<int>(row - b * N);
  const uint4* qrow = reinterpret_cast<const uint4*>(qkv + row * 3 * C);
  const uint4* drow = reinterpret_cast<const uint4*>(dout + row * C);
  const uint4* orow = reinterpret_cast<const uint4*>(out + row * C);
  uint4* qsrow = reinterpret_cast<uint4*>(qs + row * C);
  for (int c = threadIdx.x; c < C / 8; c += kPrepThreads) {
    const uint4 x = qrow[c];
    qsrow[c] = make_uint4(scale_bf16x2(x.x, scale), scale_bf16x2(x.y, scale),
                          scale_bf16x2(x.z, scale), scale_bf16x2(x.w, scale));
    part[c] = dot8(drow[c], orow[c]);
  }
  __syncthreads();
  for (int hh = threadIdx.x; hh < heads; hh += kPrepThreads) {
    float s = 0.f;
    for (int c = hh * (D / 8); c < (hh + 1) * (D / 8); ++c) s += part[c];
    delta[(b * heads + hh) * N + i] = s;
  }
}

// The producer warp: n_total bf16 from src (n_valid of them read, the rest
// zero) into dst (16-byte aligned, n_total a multiple of 8): cp.async where
// src is 16-byte aligned, plain copies for a partial chunk or an unaligned
// src (rel_h / rel_w rows of odd widths).
__device__ __forceinline__ void copy_flat(uint16_t* dst, const uint16_t* src, int n_valid,
                                          int n_total, int lane) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int c = lane; c < n_total / 8; c += 32) {
      const int left = n_valid - c * 8;
      if (left >= 8 || left <= 0) {
        wg::cp16(dst + c * 8, left > 0 ? src + c * 8 : src, left > 0 ? 16u : 0u);
      } else {
        for (int e = 0; e < 8; ++e) dst[c * 8 + e] = e < left ? src[c * 8 + e] : uint16_t(0);
      }
    }
  } else {
    for (int i = lane; i < n_total; i += 32) dst[i] = i < n_valid ? src[i] : uint16_t(0);
  }
}

// accumulator tiles 2kc and 2kc+1, rounded to bf16, are the A fragment of
// columns 16kc .. 16kc+15
__device__ __forceinline__ void pack_frags(uint32_t (&p)[kT / 16][4], const float (&x)[kT / 8][4]) {
#pragma unroll
  for (int n = 0; n < kT / 8; ++n) {
    p[n >> 1][(n & 1) * 2 + 0] = pack_bf16x2(x[n][0], x[n][1]);
    p[n >> 1][(n & 1) * 2 + 1] = pack_bf16x2(x[n][2], x[n][3]);
  }
}

// The dq pass; kBias, how it sums the bias gradients (BiasGrad).
template <int D, int kBias>
__global__ void __launch_bounds__(kThreads, 2)
vit_attention_bwd_dq_kernel(const uint16_t* __restrict__ qkv, const uint16_t* __restrict__ qs,
                            const uint16_t* __restrict__ rel_h, const uint16_t* __restrict__ rel_w,
                            const uint16_t* __restrict__ dout, const float* __restrict__ lse,
                            const float* __restrict__ delta, uint16_t* __restrict__ dqkv,
                            uint16_t* __restrict__ drel_h, uint16_t* __restrict__ drel_w, int N,
                            int C, int H, int W, float scale) {
  using P = Plan<D>;
  constexpr int kTile = P::kTile, kCh = P::kCh;
  extern __shared__ __align__(128) unsigned char smem[];
  uint16_t* sQ = reinterpret_cast<uint16_t*>(smem);  // [query][d], bf16(q * scale)
  uint16_t* sDO = sQ + kTile;                         // [query][d]
  uint16_t* sK = sDO + kTile;                         // kStages x [key][d]
  uint16_t* sV = sK + kStages * kTile;                // kStages x [key][d]
  uint16_t* sRh = sV + kStages * kTile;               // [query][H]
  uint16_t* sRw = sRh + kT * H;                       // [query][W]
  uint16_t* sE = reinterpret_cast<uint16_t*>(reinterpret_cast<unsigned char*>(sRh) +
                                             P::dq_bias(H, W));  // kIndicator: [key][32]
  float* sDrh = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(sE) +
                                         P::dq_ind(N, kBias));  // [query][H + 1]
  float* sDrw = sDrh + kT * (H + 1);  // kFold: [query][W + 1]
  float* sDl = sDrw + kT * (W + 1);   // kFold: [query][65], bf16(dl)
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sDrh + P::dq_floats(H, W, kBias));
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int q0 = blockIdx.x * kT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int heads = gridDim.y;
  const int tid = threadIdx.x;
  const int tiles = (N + kT - 1) / kT;
  const int64_t row_stride = 3LL * C;
  const uint16_t* base = qkv + static_cast<int64_t>(b) * N * row_stride + h * D;
  const int64_t tok0 = static_cast<int64_t>(b) * N * C + h * D;  // (b, 0, h) of [B, N, C]
  const int64_t rel_row0 = (static_cast<int64_t>(b) * heads + h) * N + q0;
  if (tid == 0) {
    wg::mbar_init(q_full, 64);
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(&full[s], 64);
      wg::mbar_init(&empty[s], kConsumers);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // the producer warp: Q and dO once, then the K/V tiles through the ring
    const int lane = tid - kConsumers;
    wg::load_tile<kCh, kCh>(sQ, qs + tok0, C, q0, N, lane);
    wg::load_tile<kCh, kCh>(sDO, dout + tok0, C, q0, N, lane);
    wg::mbar_arrive_copies(q_full);
    wg::mbar_arrive(q_full);
    for (int j = 0; j < tiles; ++j) {
      const int s = j % kStages;
      if (j >= kStages) wg::mbar_wait(&empty[s], (j / kStages - 1) & 1);
      wg::load_tile<kCh, kCh>(sK + s * kTile, base + C, row_stride, j * kT, N, lane);
      wg::load_tile<kCh, kCh>(sV + s * kTile, base + 2 * C, row_stride, j * kT, N, lane);
      wg::mbar_arrive_copies(&full[s]);
      wg::mbar_arrive(&full[s]);
    }
    cor::cp_async_wait<0>();  // exit with no copy in flight
    return;
  }

  // the consumer warpgroup
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp * 16;
  // this block's bias rows (a contiguous slab of each factor), zeros past N
  const int nq = min(kT, N - q0);
  for (int i = tid; i < kT * H; i += kConsumers)
    sRh[i] = i < nq * H ? rel_h[rel_row0 * H + i] : uint16_t(0);
  for (int i = tid; i < kT * W; i += kConsumers)
    sRw[i] = i < nq * W ? rel_w[rel_row0 * W + i] : uint16_t(0);
  for (int i = tid; i < P::dq_floats(H, W, kBias); i += kConsumers) sDrh[i] = 0.f;
  if constexpr (kBias == kIndicator) {
    // [Eh | Ew] of every key: column c < H is 1 on the keys of grid row c,
    // column H + c on those of grid column c; zero past N and past H + W
    for (int i = tid; i < tiles * kT * 32; i += kConsumers) {
      const int key = i >> 5, c = i & 31;
      const bool one = key < N && (c < H ? key / W == c : c - H < W && key % W == c - H);
      sE[wg::cm_offset(key, c, 4)] = one ? uint16_t(0x3f80) : uint16_t(0);  // bf16 1 or 0
    }
    wg::fence_proxy_async();  // written here, read by wgmma
  }
  wg::consumer_sync();
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wr + g + 8 * r;
    const int64_t at = rel_row0 - q0 + row;
    lse2[r] = row < N ? lse[at] * kLog2e : 0.f;
    dlt[r] = row < N ? delta[at] : 0.f;
  }
  const uint16_t* rh0 = sRh + (wr + g) * H;
  const uint16_t* rw0 = sRw + (wr + g) * W;
  const uint16_t* rh1 = rh0 + 8 * H;
  const uint16_t* rw1 = rw0 + 8 * W;
  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  // kRowSums: drel_w in registers, bf16(dl) summed over the key tiles;
  // kIndicator: [drel_h | drel_w] of this lane's rows
  constexpr int kAcc = kBias == kRowSums ? kT / 8 : (kBias == kIndicator ? 4 : 1);
  float drw[kAcc][4];
#pragma unroll
  for (int n = 0; n < kAcc; ++n) drw[n][0] = drw[n][1] = drw[n][2] = drw[n][3] = 0.f;
  const uint32_t e_addr = wg::smem_u32(sE);
  // kFold: each lane one (row, rel_h or rel_w)
  const int my_row = wr + (lane & 15);
  const bool my_h = lane < 16;
  float* my_acc = my_h ? sDrh + my_row * (H + 1) : sDrw + my_row * (W + 1);
  const float* my_dl = sDl + my_row * 65;
  float* dl_r0 = sDl + (wr + g) * 65;
  float* dl_r1 = dl_r0 + 8 * 65;
  const uint32_t q_addr = wg::smem_u32(sQ), do_addr = wg::smem_u32(sDO);
  const uint32_t k_addr = wg::smem_u32(sK), v_addr = wg::smem_u32(sV);
  wg::mbar_wait(q_full, 0);

  for (int j = 0; j < tiles; ++j) {
    const int s = j % kStages;
    const int k0 = j * kT;
    wg::mbar_wait(&full[s], (j / kStages) & 1);
    wg::fence_proxy_async();
    float sc[kT / 8][4], dp[kT / 8][4];
    wg::fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
      wg::mma_ss_n64<0>(sc, wg::desc_k(q_addr, kCh, kc),
                        wg::desc_k(k_addr + s * kTile * 2, kCh, kc), kc > 0);
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
      wg::mma_ss_n64<0>(dp, wg::desc_k(do_addr, kCh, kc),
                        wg::desc_k(v_addr + s * kTile * 2, kCh, kc), kc > 0);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(sc);
    wg::fence_regs(dp);
    bias_log2(sc, rh0, rw0, rh1, rw1, k0, t, N, W);
#pragma unroll
    for (int n = 0; n < kT / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float a = exp2f(sc[n][e] - lse2[e >> 1]);  // 0 for a masked key
        sc[n][e] = round_bf16(a * (dp[n][e] - dlt[e >> 1]));  // bf16(dl)
      }
    }
    if constexpr (kBias == kRowSums) {
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < kT / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) drw[n][e] += sc[n][e];
        rs[0] += sc[n][0] + sc[n][1];
        rs[1] += sc[n][2] + sc[n][3];
      }
      rs[0] = quad_sum(rs[0]);
      rs[1] = quad_sum(rs[1]);
      if (t == 0) {
        sDrh[(wr + g) * (H + 1) + j] = rs[0];
        sDrh[(wr + g + 8) * (H + 1) + j] = rs[1];
      }
    } else if constexpr (kBias == kFold) {
#pragma unroll
      for (int n = 0; n < kT / 8; ++n) {
        dl_r0[n * 8 + 2 * t] = sc[n][0];
        dl_r0[n * 8 + 2 * t + 1] = sc[n][1];
        dl_r1[n * 8 + 2 * t] = sc[n][2];
        dl_r1[n * 8 + 2 * t + 1] = sc[n][3];
      }
      __syncwarp();
      // this lane's (row, factor): bf16(dl) of the tile's keys summed by key
      // grid row (rel_h) or column (rel_w), in key order
      const int kn = min(kT, N - k0);
      int jh = k0 / W, jw = k0 - (k0 / W) * W;
      float run = 0.f;
      for (int kk = 0; kk < kn; ++kk) {
        const float v = my_dl[kk];
        if (my_h) {
          run += v;
          if (++jw == W || kk == kn - 1) {
            my_acc[jh] += run;
            run = 0.f;
            if (jw == W) {
              jw = 0;
              ++jh;
            }
          }
        } else {
          my_acc[jw] += v;
          if (++jw == W) jw = 0;
        }
      }
      __syncwarp();
    }
    // dQ += bf16(dl) K: the K tile [key][d] is the N-major B operand;
    // kIndicator: [drel_h | drel_w] += bf16(dl) [Eh | Ew] of the tile's keys
    uint32_t dla[kT / 16][4];
    pack_frags(dla, sc);
    wg::fence();
#pragma unroll
    for (int kc = 0; kc < kT / 16; ++kc)
      wg::mma_rs<D, 1>(dq, dla[kc], wg::desc_n(k_addr + s * kTile * 2, kCh, kc), 1);
    if constexpr (kBias == kIndicator) {
#pragma unroll
      for (int kc = 0; kc < kT / 16; ++kc)
        wg::mma_rs<32, 1>(drw, dla[kc], wg::desc_n(e_addr + j * kT * 32 * 2, 4, kc), 1);
    }
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(dq);
    wg::fence_regs(drw);
    wg::mbar_arrive(&empty[s]);
  }

  // dq * scale -> the q third of dqkv
  uint16_t* dq_out = dqkv + static_cast<int64_t>(b) * N * row_stride + h * D + 2 * t;
  const int ra = q0 + wr + g, rb = ra + 8;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (ra < N)
      *reinterpret_cast<uint32_t*>(dq_out + ra * row_stride + n * 8) =
          pack_bf16x2(dq[n][0] * scale, dq[n][1] * scale);
    if (rb < N)
      *reinterpret_cast<uint32_t*>(dq_out + rb * row_stride + n * 8) =
          pack_bf16x2(dq[n][2] * scale, dq[n][3] * scale);
  }
  if constexpr (kBias == kIndicator) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wr + g + 8 * (e >> 1), c = n * 8 + 2 * t + (e & 1);
        if (q0 + r >= N) continue;
        if (c < H) drel_h[(rel_row0 + r) * H + c] = f2bf(drw[n][e]);
        else if (c - H < W) drel_w[(rel_row0 + r) * W + c - H] = f2bf(drw[n][e]);
      }
    }
    return;
  }
  if constexpr (kBias == kRowSums) {
    uint16_t* dw = drel_w + (rel_row0 + wr + g) * W + 2 * t;
#pragma unroll
    for (int n = 0; n < kT / 8; ++n) {
      if (ra < N) *reinterpret_cast<uint32_t*>(dw + n * 8) = pack_bf16x2(drw[n][0], drw[n][1]);
      if (rb < N)
        *reinterpret_cast<uint32_t*>(dw + 8 * W + n * 8) = pack_bf16x2(drw[n][2], drw[n][3]);
    }
  }
  wg::consumer_sync();  // every warp's bias-gradient sums are in shared memory
  for (int i = tid; i < nq * H; i += kConsumers)
    drel_h[rel_row0 * H + i] = f2bf(sDrh[(i / H) * (H + 1) + i % H]);
  if constexpr (kBias == kFold) {
    for (int i = tid; i < nq * W; i += kConsumers)
      drel_w[rel_row0 * W + i] = f2bf(sDrw[(i / W) * (W + 1) + i % W]);
  }
}

// The dk/dv pass: one block per 64-key tile.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
vit_attention_bwd_dkv_kernel(const uint16_t* __restrict__ qkv, const uint16_t* __restrict__ qs,
                             const uint16_t* __restrict__ rel_h,
                             const uint16_t* __restrict__ rel_w, const uint16_t* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             uint16_t* __restrict__ dqkv, int N, int C, int H, int W) {
  using P = Plan<D>;
  constexpr int kTile = P::kTile, kCh = P::kCh;
  extern __shared__ __align__(128) unsigned char smem[];
  uint16_t* sK = reinterpret_cast<uint16_t*>(smem);  // [key][d]
  uint16_t* sV = sK + kTile;                          // [key][d]
  uint16_t* sQ = sV + kTile;                          // kStages x [query][d], bf16(q * scale)
  uint16_t* sDO = sQ + kStages * kTile;               // kStages x [query][d]
  unsigned char* extra = reinterpret_cast<unsigned char*>(sDO + kStages * kTile);
  const int extra_bytes = P::dkv_extra(H, W);
  const int rw_off = P::pad16(kT * H * 2), f_off = rw_off + P::pad16(kT * W * 2);
  // stage s: rel_h rows [query][H], rel_w rows [query][W] bf16, lse, delta [64] fp32
  auto s_rh = [&](int s) { return reinterpret_cast<uint16_t*>(extra + s * extra_bytes); };
  auto s_rw = [&](int s) { return reinterpret_cast<uint16_t*>(extra + s * extra_bytes + rw_off); };
  auto s_lse = [&](int s) { return reinterpret_cast<float*>(extra + s * extra_bytes + f_off); };
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(extra + kStages * extra_bytes);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int k0 = blockIdx.x * kT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int heads = gridDim.y;
  const int tid = threadIdx.x;
  const int tiles = (N + kT - 1) / kT;
  const int64_t row_stride = 3LL * C;
  const uint16_t* base = qkv + static_cast<int64_t>(b) * N * row_stride + h * D;
  const int64_t tok0 = static_cast<int64_t>(b) * N * C + h * D;
  const int64_t rel0 = (static_cast<int64_t>(b) * heads + h) * N;
  if (tid == 0) {
    wg::mbar_init(kv_full, 64);
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(&full[s], 64);
      wg::mbar_init(&empty[s], kConsumers);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // the producer warp: K and V once, then the query tiles through the ring
    const int lane = tid - kConsumers;
    wg::load_tile<kCh, kCh>(sK, base + C, row_stride, k0, N, lane);
    wg::load_tile<kCh, kCh>(sV, base + 2 * C, row_stride, k0, N, lane);
    wg::mbar_arrive_copies(kv_full);
    wg::mbar_arrive(kv_full);
    for (int j = 0; j < tiles; ++j) {
      const int s = j % kStages;
      const int q0 = j * kT, nq = min(kT, N - q0);
      if (j >= kStages) wg::mbar_wait(&empty[s], (j / kStages - 1) & 1);
      wg::load_tile<kCh, kCh>(sQ + s * kTile, qs + tok0, C, q0, N, lane);
      wg::load_tile<kCh, kCh>(sDO + s * kTile, dout + tok0, C, q0, N, lane);
      copy_flat(s_rh(s), rel_h + (rel0 + q0) * H, nq * H, kT * H, lane);
      copy_flat(s_rw(s), rel_w + (rel0 + q0) * W, nq * W, kT * W, lane);
      float* sl = s_lse(s);
      for (int i = lane; i < kT; i += 32) {
        const bool ok = i < nq;
        wg::cp4(sl + i, ok ? lse + rel0 + q0 + i : lse, ok ? 4u : 0u);
        wg::cp4(sl + kT + i, ok ? delta + rel0 + q0 + i : delta, ok ? 4u : 0u);
      }
      wg::mbar_arrive_copies(&full[s]);
      wg::mbar_arrive(&full[s]);  // releases copy_flat's plain stores
    }
    cor::cp_async_wait<0>();  // exit with no copy in flight
    return;
  }

  // the consumer warpgroup
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp * 16;
  // this lane's two keys (rows g and g + 8 of the warp) and their grid
  // (row, column); keys >= N are masked and read bias column 0
  int key[2], jh[2], jw[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key[r] = k0 + wr + g + 8 * r;
    jh[r] = key[r] < N ? key[r] / W : 0;
    jw[r] = key[r] < N ? key[r] - jh[r] * W : 0;
  }
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  const uint32_t k_addr = wg::smem_u32(sK), v_addr = wg::smem_u32(sV);
  const uint32_t q_addr = wg::smem_u32(sQ), do_addr = wg::smem_u32(sDO);
  wg::mbar_wait(kv_full, 0);

  for (int j = 0; j < tiles; ++j) {
    const int s = j % kStages;
    const int q0 = j * kT;
    wg::mbar_wait(&full[s], (j / kStages) & 1);
    wg::fence_proxy_async();
    const uint16_t* rh = s_rh(s);
    const uint16_t* rw = s_rw(s);
    const float* sl = s_lse(s);
    const uint32_t qs_addr = q_addr + s * kTile * 2, dos_addr = do_addr + s * kTile * 2;
    // the tile's queries in two halves of 32 (N = 32 products): S^T = K
    // bf16(q * scale)^T and dP^T = V dO^T for this block's keys x the
    // half's queries, then a^T and dl^T, then dV += bf16(a^T) dO and dK +=
    // bf16(dl^T) bf16(q * scale) over the half's two k-steps, the streamed
    // [query][d] tiles as N-major B operands. A half keeps 32 logits a thread
    // live beside dK and dV, not 64.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint32_t rows = half * 4 * kCh * 128;  // 32 rows of a [query][d] tile
      float st[kT / 16][4], dpt[kT / 16][4];
      wg::fence();
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        wg::mma_ss_n32<0>(st, wg::desc_k(k_addr, kCh, kc), wg::desc_k(qs_addr + rows, kCh, kc),
                          kc > 0);
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        wg::mma_ss_n32<0>(dpt, wg::desc_k(v_addr, kCh, kc),
                          wg::desc_k(dos_addr + rows, kCh, kc), kc > 0);
      wg::commit();
      wg::wait<0>();
      wg::fence_regs(st);
      wg::fence_regs(dpt);
#pragma unroll
      for (int n = 0; n < kT / 16; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int qi = half * 32 + n * 8 + 2 * t + (e & 1);
          const bool in = q0 + qi < N && key[r] < N;
          const float l2 =
              (st[n][e] + bf2f(rh[qi * H + jh[r]]) + bf2f(rw[qi * W + jw[r]])) * kLog2e;
          const float a = in ? exp2f(l2 - sl[qi] * kLog2e) : 0.f;
          st[n][e] = a;
          dpt[n][e] = a * (dpt[n][e] - sl[kT + qi]);  // dl
        }
      }
      uint32_t aa[2][4], dla[2][4];
#pragma unroll
      for (int n = 0; n < kT / 16; ++n) {
        aa[n >> 1][(n & 1) * 2 + 0] = pack_bf16x2(st[n][0], st[n][1]);
        aa[n >> 1][(n & 1) * 2 + 1] = pack_bf16x2(st[n][2], st[n][3]);
        dla[n >> 1][(n & 1) * 2 + 0] = pack_bf16x2(dpt[n][0], dpt[n][1]);
        dla[n >> 1][(n & 1) * 2 + 1] = pack_bf16x2(dpt[n][2], dpt[n][3]);
      }
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        wg::mma_rs<D, 1>(dv, aa[kk], wg::desc_n(dos_addr, kCh, 2 * half + kk), 1);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        wg::mma_rs<D, 1>(dk, dla[kk], wg::desc_n(qs_addr, kCh, 2 * half + kk), 1);
      wg::commit();
      wg::wait<0>();
      wg::fence_regs(dv);
      wg::fence_regs(dk);
    }
    wg::mbar_arrive(&empty[s]);
  }

  uint16_t* out = dqkv + static_cast<int64_t>(b) * N * row_stride + h * D + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= N) continue;
    uint16_t* row = out + static_cast<int64_t>(key[r]) * row_stride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(row + C + n * 8) = pack_bf16x2(dk[n][2 * r], dk[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(row + 2 * C + n * 8) =
          pack_bf16x2(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// static: its records of the attributes raised are this library's own (a
// template's static locals are otherwise one object across every library
// loaded that instantiates it, and tools/kernel_bits.py loads two)
template <int D>
static int launch_bf16(const void* qkv, const void* rel_h, const void* rel_w, const void* dout,
                       const void* out, const void* lse, void* dqkv, void* drel_h, void* drel_w,
                       void* stats, int B, int N, int C, int num_heads, int H, int W, float scale,
                       cudaStream_t st) {
  if (C > kMaxC || out == nullptr || lse == nullptr) return cudaErrorInvalidValue;
  float* delta = static_cast<float*>(stats);
  uint16_t* qs = reinterpret_cast<uint16_t*>(
      delta + qs_offset_floats(static_cast<int64_t>(B) * num_heads * N));
  const uint16_t* q = static_cast<const uint16_t*>(qkv);
  const uint16_t* rh = static_cast<const uint16_t*>(rel_h);
  const uint16_t* rw = static_cast<const uint16_t*>(rel_w);
  const uint16_t* d = static_cast<const uint16_t*>(dout);
  const float* l = static_cast<const float*>(lse);
  uint16_t* dq = static_cast<uint16_t*>(dqkv);
  vit_attention_bwd_prep_kernel<D><<<static_cast<unsigned>(B) * N, kPrepThreads, 0, st>>>(
      q, d, static_cast<const uint16_t*>(out), qs, delta, N, C, num_heads, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kT - 1) / kT, num_heads, B);
  const int bias = W == kT ? kRowSums : (H + W <= 32 ? kIndicator : kFold);
  const int dq_smem = Plan<D>::dq_bytes(H, W, N, bias);
  auto dq_kernel = bias == kRowSums     ? vit_attention_bwd_dq_kernel<D, kRowSums>
                   : bias == kIndicator ? vit_attention_bwd_dq_kernel<D, kIndicator>
                                        : vit_attention_bwd_dq_kernel<D, kFold>;
  static int raised_dq[3][wg::kMaxDevices], raised_dkv[wg::kMaxDevices];
  err = wg::raise_shared_memory(reinterpret_cast<const void*>(dq_kernel), dq_smem,
                                raised_dq[bias]);
  if (err != cudaSuccess) return err;
  dq_kernel<<<grid, kThreads, dq_smem, st>>>(q, qs, rh, rw, d, l, delta, dq,
                                             static_cast<uint16_t*>(drel_h),
                                             static_cast<uint16_t*>(drel_w), N, C, H, W, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int dkv_smem = Plan<D>::dkv_bytes(H, W);
  err = wg::raise_shared_memory(reinterpret_cast<const void*>(vit_attention_bwd_dkv_kernel<D>),
                                dkv_smem, raised_dkv);
  if (err != cudaSuccess) return err;
  vit_attention_bwd_dkv_kernel<D><<<grid, kThreads, dkv_smem, st>>>(q, qs, rh, rw, d, l, delta, dq,
                                                                    N, C, H, W);
  return cudaGetLastError();
}

}  // namespace k6b
}  // namespace cor
