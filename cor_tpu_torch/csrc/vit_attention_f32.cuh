// K6 and K7 in fp32 (compute_dtype float32): SAM's rel-pos attention on fp32
// operands, every product in 3xTF32 on wgmma's tf32 products. The function
// is vit_attention.cu's (cor_tpu/ops/pallas/vit_attention.py:284,
// vit_attention_relpos_pallas, global and windowed; :180,
// vit_attention_relpos_windows_pallas, the windows by strides), with nothing
// rounded to a narrower type: q * scale in fp32 (scale = D^-1/2 of the true
// D), the bias added to the fp32 logits as (s + rel_h[i, j / W]) + rel_w[i, j
// % W], keys >= N masked (the 196 = 3 * 64 + 4 tail of a 14 x 14 window; the
// zero tokens the partition pads in are real keys), an online softmax in
// fp32 in the log2 domain with P unrounded, the division by the row sum once
// at the end. With a non-null lse it writes each row's natural-log
// log-sum-exp into [B, heads, N] (K6b@fp32 reads it); out is the same code
// with it or without, so the same bits.
//
// What bounds it on the H100: a global block (N = 4096) is 4 N^2 D flops per
// (image, head), three TF32 products each, so operations at a third of the
// TF32 rate (0.625 ms for SAM-base's [2, 4096, 2304], 1.04 for sam_huge's
// [2, 4096, 3840]); a 14 x 14 window (N = 196) is bound by bytes (0.040 and
// 0.065 ms at [50, 196, 3C]), though 128-row blocks over 4 key tiles do 1.7x
// the products of 196 x 196. The first design (4-warp blocks of 64 queries
// on mma.sync m16n8k8, every K and V fragment split again into its TF32
// halves by each warp at each load, the tiles staged through registers
// between two __syncthreads) reached 15% (global) and 8% (windowed) of
// these bounds; this one about 43% (global) and 15-17% (windowed) on an
// H100 (PERF.md). It is K4@fp32's design (seq_attention.cu) with the bias:
//  - one block per (128 query rows, head, image or window): two consumer
//    warpgroups of 64 rows (16 a warp) and a producer warpgroup, 384 threads
//    of 168 registers, one block an SM;
//  - the producer loads each 64-key K and V tile (K7: each row by strides,
//    at grid_pos) into registers, a whole tile's loads in flight while it
//    waits for the stage, splits it once into TF32 big and small halves and
//    stores both in wgmma's K-major core-matrix layout (tf32_tiles.cuh): K
//    as [key][d], V transposed to [d][key] with its keys in P's fragment
//    order (tf32 wgmma reads shared operands K-major only), each 4 x 4
//    block transposed across four lanes by shuffles so that every store is
//    16 bytes; full and empty mbarriers per stage hand K and V over apart,
//    so the next K tile is split while the consumers run P.V and the next V
//    tile while they run Q K^T. Two stages at D = 64, one at 80 (or where a
//    large bias leaves no room for two);
//  - each consumer warpgroup scales its 64 Q rows in fp32 and splits them
//    once, and stages its rows' bias factors;
//  - S = Q K^T: wgmma m64n64k8, Q and K from shared memory, small.big and
//    big.small over D, then big.big; O += P V: wgmma m64nDk8 with P's halves
//    as register A fragments and V^T's halves from shared memory, in the same
//    order (mma_tf32x3.cuh's scheme, small.small dropped);
//  - the bias. Where W = 64 (the global blocks, kRow) a 64-key tile is one
//    key-grid row, so a row's rel_w is the same 64 values in every tile: each
//    lane holds its two rows' 16 columns of S's accumulator layout in
//    registers (32 floats, loaded once), and rel_h is one value a row and
//    tile, read from shared memory. Elsewhere (the 14 x 14 windows, any other
//    grid) each key's grid row comes from a float reciprocal and both factors
//    from shared memory. The bias rows are stored per lane pair: rows g and g
//    + 8 of a warp side by side (one 8-byte read serves both), the pairs an
//    odd number of 8-byte words apart (no bank conflict across g).
// Shared memory: two Q tiles, `stages` K and V^T tiles, each as its two
// halves, then the bias rows: 229,952 bytes at D = 64 global (two stages;
// rel_h only), 211,520 windowed; 197,152 at D = 80 global, 178,720 windowed.
// The first design's bias rows, [128][68] fp32 for both factors, would not
// fit beside K4@fp32's tiles (266 KB at D = 64, 233,504 B at 80).
// Registers: the consumers' O, S, P's two halves and the 32 bias values fit
// in 168 without a spill at D = 64 and 80; the producer is the tight side
// (ptxas keeps each chunk's addresses and shared-memory offsets across
// tiles). Tried, each against another version in one process on an H100:
//  - setmaxnreg, the producer lowered to 72 registers (one tile in flight,
//    half a tile at 80) and the consumers raised to 216: ptxas spilled
//    168-284 bytes in the producer, 1.9x (64 global) and 1.8x (80 global)
//    slower;
//  - the producer with V(j) and K(j + 1) in flight together (K4@fp32's, two
//    tiles of registers): a tie at 64, at 80 52-56 bytes spilled and 6%
//    slower; half a tile at a time at 80: no spill, 1.7x slower global (the
//    producer's exposed load latency); the offsets recomputed at every tile
//    (no spill): 1.24x slower at 64 global, 1.2x at 80 (the producer's
//    instructions are on the critical path);
//  - V^T by 4-byte stores, each lane rotating the element it stores (no
//    bank conflict): ptxas held four offsets a chunk (40 registers at 80)
//    and spilled 20-24 bytes there, 4-5% slower at 80 global, a tie
//    elsewhere;
//  - each warpgroup issuing P V of tile j and S of tile j + 1 together, the
//    two warpgroups taking turns at the tensor cores by named barriers
//    (FlashAttention-3's ping-pong), so that one's softmax overlaps the
//    other's products: 2-3% faster at the 64 windows, 1-4% slower at 64
//    global (ptxas spilled 120 bytes there), and at 80, with 52-224 bytes
//    spilled, 6-17% slower (with the last tile's products in a branch
//    instead of peeled, ptxas serialized the wgmmas: 1.36-1.38x and 1.63x
//    slower global).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "decoder_common.cuh"
#include "mma_tf32x3.cuh"
#include "tf32_tiles.cuh"
#include "wgmma.cuh"

namespace cor {
namespace vit {

// K7's window grid: windows of ws x ws tokens over the padded Hp x Wp grid
// (nwj windows per row of windows, nW per image), the output cropped to
// Hout x Wout; unused by K6
struct WindowGrid {
  int ws, Hp, Wp, Hout, Wout, nwj, nW;
  float inv_ws;  // 1 / ws: a token's window row by a float reciprocal (exact below 2^12)
};

// the place of token i of a block's image (K6) or of its window, whose
// first grid row and column are y0, x0 (K7), in its image's token grid
template <bool kWin>
__device__ __forceinline__ int64_t grid_pos(int i, const WindowGrid& wgrid, int y0, int x0) {
  if (!kWin) return i;
  const int r = __float2int_rz((static_cast<float>(i) + 0.5f) * wgrid.inv_ws);
  return static_cast<int64_t>(y0 + r) * wgrid.Wp + x0 + (i - r * wgrid.ws);
}

// The fp32 kernel's launch at head_dim 64 and 80 (vit_attention_f32_d64.cu,
// _d80.cu: nvcc builds each in parallel). blocks: B images (K6) or B *
// wgrid.nW windows (K7, win); lse: null or [B, heads, N] (K6 only).
int launch_f32_d64(const float* qkv, const float* rel_h, const float* rel_w, float* out,
                   float* lse, int blocks, int N, int C, int num_heads, int H, int W, float scale,
                   const WindowGrid& wgrid, bool win, cudaStream_t stream);
int launch_f32_d80(const float* qkv, const float* rel_h, const float* rel_w, float* out,
                   float* lse, int blocks, int N, int C, int num_heads, int H, int W, float scale,
                   const WindowGrid& wgrid, bool win, cudaStream_t stream);

namespace f32 {

namespace wg = cor::wg;

constexpr int kBK = 64;          // keys a tile
constexpr int kConsumers = 256;  // two warpgroups, 64 query rows each
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kMaxSmem = 232448;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tiles {
  static_assert(D % 8 == 0, "whole k-steps of 8");
  static constexpr int kCh = D / 4;        // 16-byte chunks of a Q or K row
  static constexpr int kChV = kBK / 4;     // chunks of a V^T row (64 keys)
  static constexpr int kTile = kBK * D;    // floats of one half of a Q, K or V^T tile
  static constexpr int kPer = kBK * kCh / tf32::kPlacers;  // chunks of a tile a thread places
  static constexpr int kMaxStages = D == 80 ? 1 : 2;
  // bytes: Q (2 warpgroups x big, small), `stages` x (K, V^T) x (big,
  // small), the bias rows (2 warpgroups x 32 lane pairs x ldb float2), four
  // barriers a stage
  static constexpr int smem(int stages, int ldb) {
    return (4 + 4 * stages) * kTile * 4 + 2 * 32 * ldb * 8 + 4 * stages * 8;
  }
};

// The bias rows' stride in float2 (one a lane pair): rel_h's H columns, and
// rel_w's W after them unless kRow; odd, so that the 8 pairs of a warp fall
// in 16 different bank pairs
__host__ __device__ __forceinline__ int bias_stride(bool row, int H, int W) {
  return (row ? H : H + W) | 1;
}

// Thread p's kN chunks of a 64-row tile of tokens [r0, r0 + 64) (token i's
// row at base + grid_pos(i) * stride; tokens >= N zeros) into registers
template <int kCh, bool kWin, int kN>
__device__ __forceinline__ void fetch_rows(const float* base, int64_t stride, int r0, int N, int p,
                                           float4 (&r)[kN], const WindowGrid& wgrid, int y0,
                                           int x0) {
#pragma unroll
  for (int u = 0; u < kN; ++u) {
    int row, c;
    tf32::chunk_of<kCh>(p + tf32::kPlacers * u, row, c);
    r[u] = r0 + row < N
               ? __ldg(reinterpret_cast<const float4*>(
                           base + grid_pos<kWin>(r0 + row, wgrid, y0, x0) * stride) + c)
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The logits of key tile j (this lane's rows g and g + 8 against keys 64 j +
// 8n + 2t + e) + the bias, in the first design's order (s + rel_h) + rel_w,
// into the log2 domain; mt: this lane's row maxima. kRow: the tile is
// key-grid row j, h = (rel_h of row g, of row g + 8) at column j, rw[r][n] =
// rel_w of row g + 8r at columns 8n + 2t and + 1. Else bias (this lane
// pair's rows) holds rel_h at [0, H) and rel_w at [H, H + W), each key's grid
// row by a float reciprocal (exact for keys < 2^12 and W <= 64), keys >= N
// masked to -inf.
template <bool kRow>
__device__ __forceinline__ void bias_max(float (&s)[kBK / 8][4], const float2* bias,
                                         const float2 (&rw)[2][kBK / 8], int j, int N, int H,
                                         int W, float inv_w, int t, float (&mt)[2]) {
  mt[0] = mt[1] = -INFINITY;
  if constexpr (kRow) {
    const float2 h = bias[j];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      s[n][0] = (s[n][0] + h.x + rw[0][n].x) * kLog2e;
      s[n][1] = (s[n][1] + h.x + rw[0][n].y) * kLog2e;
      s[n][2] = (s[n][2] + h.y + rw[1][n].x) * kLog2e;
      s[n][3] = (s[n][3] + h.y + rw[1][n].y) * kLog2e;
      mt[0] = fmaxf(mt[0], fmaxf(s[n][0], s[n][1]));
      mt[1] = fmaxf(mt[1], fmaxf(s[n][2], s[n][3]));
    }
  } else {
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = j * kBK + n * 8 + 2 * t + e;
        if (key < N) {
          const int jh = __float2int_rz((static_cast<float>(key) + 0.5f) * inv_w);
          const float2 h = bias[jh], w = bias[H + key - jh * W];
          s[n][e] = (s[n][e] + h.x + w.x) * kLog2e;
          s[n][2 + e] = (s[n][2 + e] + h.y + w.y) * kLog2e;
        } else {
          s[n][e] = s[n][2 + e] = -INFINITY;
        }
      }
      mt[0] = fmaxf(mt[0], fmaxf(s[n][0], s[n][1]));
      mt[1] = fmaxf(mt[1], fmaxf(s[n][2], s[n][3]));
    }
  }
}

// One (128 query rows, head, image or window) on fp32 operands (qkv, rel_h,
// rel_w, out fp32). K6 (kWin false): the N = H * W tokens of image
// blockIdx.z, rows of qkv [B, N, 3C], the factors [B, heads, N, H|W]. K7
// (kWin true): the N = ws * ws tokens of window blockIdx.z % nW of image
// blockIdx.z / nW, read by strides out of qkv [B, Hp, Wp, 3C] (H = W = ws),
// the factors [B, heads, Hp * Wp, ws], out into the cropped [B, Hout, Wout,
// C] grid. `stages`: the K/V ring's (1 or 2).
template <int D, bool kWin, bool kRow>
__global__ void __launch_bounds__(kThreads, 1)
vit_attention_relpos_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ rel_h,
                                const float* __restrict__ rel_w, float* __restrict__ out,
                                float* __restrict__ lse, int N, int C, int H, int W, float scale,
                                WindowGrid wgrid, int stages) {
  using T = Tiles<D>;
  const int ldb = bias_stride(kRow, H, W);
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);  // 2 warpgroups x (big, small) [query][D]
  float* sK = sQ + 4 * T::kTile;               // stages x (big, small) [key][D]
  float* sV = sK + 2 * stages * T::kTile;      // stages x (big, small) [d][key]
  float2* sBias = reinterpret_cast<float2*>(sV + 2 * stages * T::kTile);  // [64 pairs][ldb]
  uint64_t* k_full = reinterpret_cast<uint64_t*>(sBias + 64 * ldb);
  uint64_t* k_empty = k_full + stages;
  uint64_t* v_full = k_empty + stages;
  uint64_t* v_empty = v_full + stages;

  const int q0 = blockIdx.x * 128;
  const int h = blockIdx.y;
  const int b = kWin ? blockIdx.z / wgrid.nW : blockIdx.z;
  const int tid = threadIdx.x;
  const int tiles = (N + kBK - 1) / kBK;
  const int64_t row_stride = 3LL * C;
  // the window's first grid row and column (K7)
  const int win = kWin ? blockIdx.z - b * wgrid.nW : 0;
  const int y0 = kWin ? (win / wgrid.nwj) * wgrid.ws : 0;
  const int x0 = kWin ? (win - (win / wgrid.nwj) * wgrid.nwj) * wgrid.ws : 0;
  const int64_t grid_n = kWin ? static_cast<int64_t>(wgrid.Hp) * wgrid.Wp : N;  // tokens an image
  const float* base = qkv + static_cast<int64_t>(b) * grid_n * row_stride + h * D;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      wg::mbar_init(&k_full[s], 128);
      wg::mbar_init(&v_full[s], 128);
      wg::mbar_init(&k_empty[s], kConsumers);
      wg::mbar_init(&v_empty[s], kConsumers);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // The producer warpgroup: each K and V tile into registers (its loads
    // in flight while it waits for the stage), split once into its TF32
    // halves and stored, K as [key][d], V as V^T [d][key]
    const int p = tid - kConsumers;
    float4 r[T::kPer];
    fetch_rows<T::kCh, kWin>(base + C, row_stride, 0, N, p, r, wgrid, y0, x0);
    for (int j = 0; j < tiles; ++j) {
      const int s = stages == 1 ? 0 : j & 1;
      const uint32_t ph = (stages == 1 ? j : j >> 1) & 1;
      if (j >= stages) wg::mbar_wait(&k_empty[s], ph ^ 1);
      tf32::store_rows_split<T::kCh>(sK + 2 * s * T::kTile, T::kTile, p, r);
      wg::fence_proxy_async();
      wg::mbar_arrive(&k_full[s]);
      fetch_rows<T::kCh, kWin>(base + 2 * C, row_stride, j * kBK, N, p, r, wgrid, y0, x0);
      if (j >= stages) wg::mbar_wait(&v_empty[s], ph ^ 1);
      tf32::store_vt_split<T::kCh>(sV + 2 * s * T::kTile, T::kTile, p, r);
      wg::fence_proxy_async();
      wg::mbar_arrive(&v_full[s]);
      if (j + 1 < tiles)
        fetch_rows<T::kCh, kWin>(base + C, row_stride, (j + 1) * kBK, N, p, r, wgrid, y0, x0);
    }
    return;
  }

  // consumer warpgroup cw: query rows r0 .. r0 + 63
  const int cw = tid >> 7;
  const int ctid = tid & 127;
  const int warp = ctid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int r0 = q0 + cw * 64;
  const int64_t rel_base = (static_cast<int64_t>(b) * gridDim.y + h) * grid_n;
  float* qb = sQ + 2 * cw * T::kTile;
  float2* my_bias = sBias + cw * 32 * ldb;  // this warpgroup's 32 lane pairs
  float2 rw[2][kBK / 8];  // kRow: rel_w of rows g, g + 8 at columns 8n + 2t, + 1
  {
    // Q, scaled in fp32 and split once into its halves (rows past N zero)
    float4 qr[T::kPer];
    fetch_rows<T::kCh, kWin>(base, row_stride, r0, N, ctid, qr, wgrid, y0, x0);
#pragma unroll
    for (int u = 0; u < T::kPer; ++u)
      qr[u] = make_float4(qr[u].x * scale, qr[u].y * scale, qr[u].z * scale, qr[u].w * scale);
    tf32::store_rows_split<T::kCh>(qb, T::kTile, ctid, qr);
    // the bias rows: row rr of the warpgroup is half (rr / 8) % 2 of lane
    // pair (rr / 16) * 8 + rr % 8; rows past N zero
    const int cols = kRow ? H : H + W;
    for (int i = ctid; i < 64 * cols; i += 128) {
      const int rr = i / cols, c = i - rr * cols;
      float v = 0.f;
      if (r0 + rr < N) {
        const int64_t row = rel_base + grid_pos<kWin>(r0 + rr, wgrid, y0, x0);
        v = c < H ? rel_h[row * H + c] : rel_w[row * W + c - H];
      }
      float* pair = reinterpret_cast<float*>(my_bias + ((rr >> 4) * 8 + (rr & 7)) * ldb + c);
      pair[(rr >> 3) & 1] = v;
    }
    if constexpr (kRow) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = r0 + warp * 16 + g + 8 * r;
        const float* src =
            i < N ? rel_w + (rel_base + grid_pos<kWin>(i, wgrid, y0, x0)) * W + 2 * t : nullptr;
#pragma unroll
        for (int n = 0; n < kBK / 8; ++n)
          rw[r][n] = src ? __ldg(reinterpret_cast<const float2*>(src + n * 8))
                         : make_float2(0.f, 0.f);
      }
    }
    wg::fence_proxy_async();  // the split Q, before this warpgroup's wgmmas read it
    wg::group_sync(cw);
  }
  const float2* bias = my_bias + (warp * 8 + g) * ldb;  // this lane's rows g, g + 8
  const float inv_w = 1.f / static_cast<float>(W);
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
    wg::mbar_wait(&k_full[s], ph);
    wg::fence_proxy_async();
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
    wg::wait<0>();
    wg::fence_regs(sc);
    wg::mbar_arrive(&k_empty[s]);

    // add the bias, mask keys past N, scale into the log2 domain, tile row max
    float mt[2];
    bias_max<kRow>(sc, bias, rw, j, N, H, W, inv_w, t, mt);
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
    wg::mbar_wait(&v_full[s], ph);
    wg::fence_proxy_async();
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
    wg::mbar_arrive(&v_empty[s]);
  }

  float inv[2];
  cor::softmax_inverse_sums(l_run, inv);
  const int lr = r0 + warp * 16 + g;  // this lane's rows lr and lr + 8
  // K6 for K6b: each row's log-sum-exp of the logits, natural log, into
  // lse [B, heads, N] (l_run now holds the whole row sums)
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = lr + 8 * r;
      if (i < N)
        lse[(static_cast<int64_t>(b) * gridDim.y + h) * N + i] =
            (m_run[r] + log2f(l_run[r])) * 0.6931471805599453f;
    }
  }
  // the output rows of this lane's two queries: [B, N, C] (K6), or the
  // cropped [B, Hout, Wout, C] grid (K7); -1: not written (past N, or a pad
  // row or column of the grid)
  int64_t orow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = lr + 8 * r;
    orow[r] = -1;
    if (i < N) {
      if (!kWin) {
        orow[r] = static_cast<int64_t>(b) * N + i;
      } else {
        const int y = y0 + i / wgrid.ws, x = x0 + i % wgrid.ws;
        if (y < wgrid.Hout && x < wgrid.Wout)
          orow[r] = (static_cast<int64_t>(b) * wgrid.Hout + y) * wgrid.Wout + x;
      }
    }
  }
  float* out_h = out + h * D + 2 * t;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (orow[0] >= 0)
      *reinterpret_cast<float2*>(out_h + orow[0] * C + n * 8) =
          make_float2(o[n][0] * inv[0], o[n][1] * inv[0]);
    if (orow[1] >= 0)
      *reinterpret_cast<float2*>(out_h + orow[1] * C + n * 8) =
          make_float2(o[n][2] * inv[1], o[n][3] * inv[1]);
  }
}

// static: its records of the attributes raised are this library's own (a
// template's static locals are otherwise one object across every library
// loaded that instantiates it, and tools/kernel_bits.py loads two)
template <int D>
static int launch(const float* qkv, const float* rel_h, const float* rel_w, float* out,
                  float* lse, int blocks, int N, int C, int num_heads, int H, int W, float scale,
                  const WindowGrid& wgrid, bool win, cudaStream_t st) {
  using T = Tiles<D>;
  // W = 64 (K6's global blocks): a key tile is one key-grid row
  const bool row = !win && W == kBK;
  const int ldb = bias_stride(row, H, W);
  int stages = T::kMaxStages;
  while (stages > 1 && T::smem(stages, ldb) > kMaxSmem) --stages;
  const int smem = T::smem(stages, ldb);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const int which = win ? 0 : (row ? 1 : 2);
  auto kernel = win   ? vit_attention_relpos_f32_kernel<D, true, false>
                : row ? vit_attention_relpos_f32_kernel<D, false, true>
                      : vit_attention_relpos_f32_kernel<D, false, false>;
  static int raised[3][wg::kMaxDevices];
  const cudaError_t err =
      wg::raise_shared_memory(reinterpret_cast<const void*>(kernel), smem, raised[which]);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + 127) / 128, num_heads, blocks);
  kernel<<<grid, kThreads, smem, st>>>(qkv, rel_h, rel_w, out, lse, N, C, H, W, scale, wgrid,
                                       stages);
  return cudaGetLastError();
}

}  // namespace f32
}  // namespace vit
}  // namespace cor
