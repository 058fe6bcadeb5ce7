// SAM ViT attention with the decomposed relative-position bias, read straight
// off a fused QKV tensor. For every head h, over the N = H * W tokens of one
// image (global blocks: 64 x 64) or one window (14 x 14, N = 196):
//
//   l[i, j] = bf16(q_i * scale) . k_j + rel_h[i, j / W] + rel_w[i, j % W]
//   out[i, h*D:(h+1)*D] = sum_j exp(l[i, j] - m_i) v_j / sum_j exp(l[i, j] - m_i)
//
// Replaces the TPU kernel cor_tpu/ops/pallas/vit_attention.py:
// vit_attention_relpos_pallas (_vit_attention_relpos_pallas_impl, its
// pallas_call at line 284). That kernel folds the bias into its logits GEMM
// by concatenating [q*scale | rel_h | rel_w] against [k | Eh^T | Ew^T]
// (indicator columns, zero-padded to 32 lanes), a way to run the bias on the
// TPU's matrix unit. Here the two factors are added to each fp32 logit tile
// directly, indexed by the key's grid row j / W and column j % W; they are
// not padded and no indicator matrix exists.
//
// What bounds it on the H100: a global block does 4 N^2 D flops per (image,
// head) on ~(3 N D + 2 N 64 + N D) * 2 bytes, ~1,500 flop/byte at N = 4096,
// far above the card's ~295 flop/byte ridge: bound by operations (51.5 GFLOP
// per SAM-base image over 12 heads of 64, 0.052 ms at the bf16 peak; 85.9
// GFLOP per sam_huge image over 16 heads of 80). A 14 x 14 window (N = 196)
// does ~60 flop/byte: bound by bytes. What the first design (mma.sync, 4-warp
// blocks of 64 queries) lost was the overlap of loads and products: every
// K/V tile went through registers between two __syncthreads, V was
// transposed by scalar stores, and the key's grid row and column stepped by
// a loop per 8 keys.
//
// The bf16 kernel (vit_attention_relpos_kernel<D, kWin, kRow>) is the port's
// K4 (csrc/seq_attention.cu) on wgmma (wgmma.cuh) with the bias, templated
// on the head_dim D (64: SAM-base and SAM-large; 80: sam_huge):
//  - one block per (128 query rows, head, image or window): two consumer
//    warpgroups (64 rows each, 16 a warp) sharing each K/V tile, and a
//    producer of two warps, 320 threads (the windows at D = 80: 64-row
//    blocks of one warpgroup);
//  - the producer copies the block's Q tiles and its rel_h and rel_w rows
//    ([64][H], [64][W] bf16 a warpgroup, stride 72) once, then the 64-key K
//    and V tiles, with cp.async into a ring (3 stages at D = 64, 2 at 80) in
//    wgmma's core-matrix layout, rows past N zero-filled, handed over by a
//    full and an empty mbarrier per stage;
//  - each warpgroup scales its Q tile and rounds it to bf16 in place once
//    it lands (the TPU kernel's q * scale in the compute dtype, scale =
//    D^-1/2 of the true D: cor_tpu lane-pads 80 to 128 for its kernel and
//    passes 80^-1/2; a rounding point no copy engine applies), then fences
//    the async proxy before its first wgmma;
//  - S = Q K^T is wgmma m64n64k16 with both operands from shared memory (D
//    / 16 k-steps); O += P V is wgmma m64nDk16 with P as bf16 register
//    fragments and V's [key][d] tile as the N-major B operand, so no
//    transposed copy of V exists;
//  - the bias is added to the fp32 logits in the first design's order,
//    (s + rel_h) + rel_w, then keys >= N (the tail of the last tile: 196 = 3
//    * 64 + 4) are masked and the logits scaled by log2 e. Where W = 64 (the
//    global blocks, kRow) a 64-key tile is one key-grid row: rel_h is one
//    value a row and tile, rel_w is read in pairs; elsewhere (the 14 x 14
//    windows) each key's grid row comes from a float reciprocal. The zero
//    tokens that window_partition pads in are real keys and are not masked;
//  - online softmax in fp32 in the log2 domain, shifted by the running row
//    max (the TPU kernel shifts by the column mean of its concatenated keys:
//    the same function); P rounded to bf16 before P.V, as the TPU kernel
//    rounds its probabilities; the division by the fp32 row sum once at the
//    end. Query rows past N are computed on zeros and not stored. The sums
//    run in the first design's order: out is the same bits.
// With a non-null lse (the forward autograd records) each row's log-sum-exp
// of the logits, natural log, is written into [B, heads, N] for K6b; out's
// bits do not change. Dynamic shared memory: two Q tiles, the ring and the
// bias rows, 102,456 bytes at D = 64 (two blocks an SM, 96 registers) and
// 98,344 at 80 (one block an SM, so that its 112-117 registers need no
// spill). The shared-memory attributes are set once per device (set at
// every launch they cost a host-bound encode its time, as K4's did).
//
// K7, the same kernel with the window partition in its indexing (kWin):
// replaces cor_tpu/ops/pallas/vit_attention.py:
// vit_attention_relpos_windows_pallas (its pallas_call at line 180, the
// opt-in fused_window_indexing of the SAM encoder). Its qkv is the fused
// QKV GEMM over the whole zero-padded grid [B, Hp, Wp, 3C] (Hp, Wp multiples
// of the window ws; the pad tokens' k and v are the qkv bias, real keys of
// their window), and one block is one (image and window, head, 128-query
// tile): token i of window (wi, wj) is read by strides at grid row
// wi * ws + i / ws, column wj * ws + i % ws, so the partition is never
// materialised: the producer places each 16-byte chunk of a window's K and
// V rows from its grid row, and each warpgroup its Q and bias rows. The bias
// factors [B, heads, Hp * Wp, ws] are per grid token over the window's key
// rows and columns; the output is written straight into the cropped
// [B, H, W, C] grid (the tokens of the pad rows and columns are computed as
// keys need them and dropped), so the unpartition and the crop copies go
// too. A window's 196 queries take two blocks of 128 rows, which read its
// K/V twice (64-row blocks would read them four times). The softmax, the
// rounding points and the masking of the last key tile are K6's. The TPU
// kernel's 8-sublane column padding (14 -> 16) and its indicator matrices
// are TPU layout and have no counterpart here. It takes head_dim 64 and 80
// (cor_tpu's K7 takes no head_dim that needs lane padding, so at 80 cor_tpu
// falls back to the XLA partition and attention: the same function). What
// bounds it is what bounds K6's windowed shape: bytes.
//
// fp32 (compute_dtype float32), K6 and K7 alike: vit_attention_f32.cuh's
// vit_attention_relpos_f32_kernel<D, kWin, kRow> (built per head_dim in
// vit_attention_f32_d64.cu and _d80.cu), K4@fp32's design with the bias:
// the same function on fp32 operands, every product in 3xTF32 on wgmma's
// tf32 products, a producer warpgroup splitting each K and V tile once,
// two consumer warpgroups of 64 rows, and in the global case each row's
// rel_w in registers. See that header for what bounds it, its budget of
// shared memory and registers, and what was tried.

#include "decoder_common.cuh"
#include "vit_attention_f32.cuh"
#include "wgmma.cuh"

namespace {

namespace wg = cor::wg;
using cor::bf2f;
using cor::lds32;
using cor::pack_bf16x2;

using cor::vit::grid_pos;
using cor::vit::WindowGrid;

constexpr int kBK = 64;        // keys per shared-memory tile
constexpr int kMaxSide = 64;   // H, W <= 64
constexpr int kGroups = 2;     // consumer warpgroups a block, 64 query rows each
constexpr int kProducers = 64;  // the producer's two warps
constexpr int kLdr = kMaxSide + 8;  // the bias rows' stride (conflict-free pairs)
constexpr float kLog2e = 1.4426950408889634f;

// the bf16 kernel's tiles, from the head_dim D (64 or 80: whole k-steps of 16)
template <int D>
struct Tiles {
  static_assert(D % 16 == 0, "the logits' product runs in k-steps of 16");
  static constexpr int kCh = D / 8;         // 16-byte chunks of a row
  static constexpr int kTile = kBK * D;     // bf16 elements of a 64-row tile
  static constexpr int kStages = D == 64 ? 3 : 2;  // the K/V ring (80: two blocks an SM)
  // shared memory of a block of `groups` consumer warpgroups: Q tiles, the
  // ring of K and V tiles, the bias rows, the barriers
  static constexpr int smem(int groups) {
    return (groups * kTile + kStages * 2 * kTile + groups * 64 * kLdr * 2) * 2 +
           (1 + 2 * kStages) * 8;
  }
};

// two bf16 in one 32-bit word, each times s, rounded back to bf16
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t w, float s) {
  return pack_bf16x2(bf2f(static_cast<uint16_t>(w & 0xffffu)) * s,
                     bf2f(static_cast<uint16_t>(w >> 16)) * s);
}

// The producer warps start copying tokens [r0, r0 + 64) (rows of `base`,
// `stride` apart, at grid_pos) into the tile dst of kCh chunks a row in
// wgmma's core-matrix layout; tokens >= N are zeros. Eight lanes fill one
// core matrix (wgmma.cuh load_tile's order).
template <int kCh, bool kWin>
__device__ __forceinline__ void load_tokens(uint16_t* dst, const uint16_t* base, int64_t stride,
                                            int r0, int N, int lane, const WindowGrid& wgrid,
                                            int y0, int x0) {
#pragma unroll 4
  for (int i = lane; i < 64 * kCh; i += kProducers) {
    const int rg = i / (8 * kCh), rem = i - rg * 8 * kCh, c = rem >> 3, r = rg * 8 + (rem & 7);
    const bool ok = r0 + r < N;
    wg::cp16(dst + (rg * kCh + c) * 64 + (rem & 7) * 8,
             ok ? base + grid_pos<kWin>(r0 + r, wgrid, y0, x0) * stride + c * 8 : base,
             ok ? 16u : 0u);
  }
}

// The producer warps start copying the bias rows of tokens [r0, r0 + 64)
// (rows of `cols` bf16, row i at rel + grid_pos(i) * cols) into dst
// [64][kLdr]; tokens >= N are zeros. Pairs by 4-byte cp.async where the
// rows are whole words, else element by element with plain stores (which
// the producer's plain arrival on the stage's barrier releases).
template <bool kWin>
__device__ __forceinline__ void load_bias_rows(uint16_t* dst, const uint16_t* rel, int cols,
                                               int r0, int N, int lane, const WindowGrid& wgrid,
                                               int y0, int x0) {
  if ((cols & 1) == 0) {
    const int pairs = cols >> 1;
    for (int i = lane; i < 64 * pairs; i += kProducers) {
      const int r = i / pairs, c = (i - r * pairs) * 2;
      const bool ok = r0 + r < N;
      wg::cp4(dst + r * kLdr + c,
              ok ? rel + grid_pos<kWin>(r0 + r, wgrid, y0, x0) * cols + c : rel, ok ? 4u : 0u);
    }
  } else {
    for (int i = lane; i < 64 * cols; i += kProducers) {
      const int r = i / cols, c = i - r * cols;
      dst[r * kLdr + c] =
          r0 + r < N ? rel[grid_pos<kWin>(r0 + r, wgrid, y0, x0) * cols + c] : uint16_t(0);
    }
  }
}

// The logits of key tile j (this lane's rows g and g + 8 against keys 64 j +
// 8n + 2t + e) + the bias rows' factors rh[key / W] + rw[key % W], added in
// fp32 in the first design's order, into the log2 domain; mt: this lane's
// row maxima. kRow: W = 64 (the global blocks), so the tile is key-grid row
// j and key column 8n + 2t + e: one rel_h value a row, rel_w read in pairs;
// else each key's row by a float reciprocal (exact for keys < 2^12 and W <=
// 64) and keys >= N masked to -inf.
template <bool kRow>
__device__ __forceinline__ void bias_max(float (&s)[kBK / 8][4], const uint16_t* rh0,
                                         const uint16_t* rw0, const uint16_t* rh1,
                                         const uint16_t* rw1, int j, int N, int W, float inv_w,
                                         int t, float (&mt)[2]) {
  mt[0] = mt[1] = -INFINITY;
  if constexpr (kRow) {
    const float h0 = bf2f(rh0[j]), h1 = bf2f(rh1[j]);
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      const uint32_t w0 = lds32(rw0 + n * 8 + 2 * t), w1 = lds32(rw1 + n * 8 + 2 * t);
      s[n][0] = (s[n][0] + h0 + bf2f(static_cast<uint16_t>(w0 & 0xffffu))) * kLog2e;
      s[n][1] = (s[n][1] + h0 + bf2f(static_cast<uint16_t>(w0 >> 16))) * kLog2e;
      s[n][2] = (s[n][2] + h1 + bf2f(static_cast<uint16_t>(w1 & 0xffffu))) * kLog2e;
      s[n][3] = (s[n][3] + h1 + bf2f(static_cast<uint16_t>(w1 >> 16))) * kLog2e;
      mt[0] = fmaxf(mt[0], fmaxf(s[n][0], s[n][1]));
      mt[1] = fmaxf(mt[1], fmaxf(s[n][2], s[n][3]));
    }
  } else {
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = j * kBK + n * 8 + 2 * t + e;
        const int jh = __float2int_rz((static_cast<float>(key) + 0.5f) * inv_w);
        const int jw = key - jh * W;
        if (key < N) {
          s[n][e] = (s[n][e] + bf2f(rh0[jh]) + bf2f(rw0[jw])) * kLog2e;
          s[n][2 + e] = (s[n][2 + e] + bf2f(rh1[jh]) + bf2f(rw1[jw])) * kLog2e;
        } else {
          s[n][e] = s[n][2 + e] = -INFINITY;
        }
      }
      mt[0] = fmaxf(mt[0], fmaxf(s[n][0], s[n][1]));
      mt[1] = fmaxf(mt[1], fmaxf(s[n][2], s[n][3]));
    }
  }
}

// One (64 groups query rows, head, image or window). K6 (kWin false): the
// N = H * W tokens of image blockIdx.z, rows of qkv [B, N, 3C]. K7 (kWin
// true): the N = ws * ws tokens of window blockIdx.z % nW of image
// blockIdx.z / nW, read by strides out of qkv [B, Hp, Wp, 3C] (H = W = ws).
// A block of groups * 128 + kProducers threads; 102,456 bytes of dynamic
// shared memory at D = 64 with two warpgroups, two blocks an SM (96
// registers a thread); at D = 80 one block an SM (98,344 bytes), so that
// the accumulators need no spill (at 96 registers ptxas spilled ~480 bytes
// and serialized the wgmmas: 1.11 ms global and 0.50 windowed, against 0.87
// and 0.19 at one block).
template <int D, bool kWin, bool kRow>
__global__ void __launch_bounds__(kGroups * 128 + kProducers, D == 64 ? 2 : 1)
vit_attention_relpos_kernel(const uint16_t* __restrict__ qkv, const uint16_t* __restrict__ rel_h,
                            const uint16_t* __restrict__ rel_w, uint16_t* __restrict__ out,
                            float* __restrict__ lse, int N, int C, int H, int W, float scale,
                            WindowGrid wgrid) {
  using T = Tiles<D>;
  constexpr int kCh = T::kCh, kStages = T::kStages;
  const int groups = (blockDim.x - kProducers) / 128;
  const int consumers = groups * 128;
  extern __shared__ __align__(128) unsigned char smem[];
  uint16_t* sQ = reinterpret_cast<uint16_t*>(smem);  // groups x [query][D], bf16(q * scale)
  uint16_t* sK = sQ + groups * T::kTile;              // kStages x [key][D]
  uint16_t* sV = sK + kStages * T::kTile;             // kStages x [key][D]
  uint16_t* sRh = sV + kStages * T::kTile;            // [query][kLdr]: the rows' rel_h
  uint16_t* sRw = sRh + groups * 64 * kLdr;           // [query][kLdr]: the rows' rel_w
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sRw + groups * 64 * kLdr);  // Q, bias landed
  uint64_t* full = q_full + 1;       // stage s landed
  uint64_t* empty = full + kStages;  // stage s consumed

  const int q0 = blockIdx.x * groups * 64;
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
  const uint16_t* base = qkv + static_cast<int64_t>(b) * grid_n * row_stride + h * D;
  if (tid == 0) {
    wg::mbar_init(q_full, 2 * kProducers);
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(&full[s], 2 * kProducers);
      wg::mbar_init(&empty[s], consumers);
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= consumers) {
    // the producer warps: the block's Q tiles and bias rows (rel_h/rel_w
    // [B, heads, grid_n, H|W]), then every K and V tile through the ring
    const int lane = tid - consumers;
    const int64_t rel_base = (static_cast<int64_t>(b) * gridDim.y + h) * grid_n;
    for (int w = 0; w < groups; ++w) {
      load_tokens<kCh, kWin>(sQ + w * T::kTile, base, row_stride, q0 + 64 * w, N, lane, wgrid,
                             y0, x0);
      load_bias_rows<kWin>(sRh + w * 64 * kLdr, rel_h + rel_base * H, H, q0 + 64 * w, N, lane,
                           wgrid, y0, x0);
      load_bias_rows<kWin>(sRw + w * 64 * kLdr, rel_w + rel_base * W, W, q0 + 64 * w, N, lane,
                           wgrid, y0, x0);
    }
    wg::mbar_arrive_copies(q_full);
    wg::mbar_arrive(q_full);
    for (int j = 0; j < tiles; ++j) {
      const int s = j % kStages;
      if (j >= kStages) wg::mbar_wait(&empty[s], (j / kStages - 1) & 1);
      load_tokens<kCh, kWin>(sK + s * T::kTile, base + C, row_stride, j * kBK, N, lane, wgrid, y0,
                             x0);
      load_tokens<kCh, kWin>(sV + s * T::kTile, base + 2 * C, row_stride, j * kBK, N, lane, wgrid,
                             y0, x0);
      wg::mbar_arrive_copies(&full[s]);
      wg::mbar_arrive(&full[s]);
    }
    cor::cp_async_wait<0>();  // exit with no copy in flight
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
  uint16_t* myQ = sQ + cw * T::kTile;
  const uint16_t* myRh = sRh + cw * 64 * kLdr;
  const uint16_t* myRw = sRw + cw * 64 * kLdr;
  // its Q tile, scaled and rounded to bf16 in place (a rounding point the
  // copy cannot apply; the rows past N stay zero)
  wg::mbar_wait(q_full, 0);
  for (int i = ctid; i < 64 * kCh; i += 128) {
    uint4* p = reinterpret_cast<uint4*>(myQ + i * 8);
    const uint4 v = *p;
    *p = make_uint4(scale_bf16x2(v.x, scale), scale_bf16x2(v.y, scale), scale_bf16x2(v.z, scale),
                    scale_bf16x2(v.w, scale));
  }
  wg::fence_proxy_async();  // the scaled Q, before this warpgroup's wgmmas read it
  wg::group_sync(cw);

  const int lr = warp * 16 + g;  // this lane's rows lr and lr + 8 of the warpgroup's 64
  const uint16_t* rh0 = myRh + lr * kLdr;
  const uint16_t* rw0 = myRw + lr * kLdr;
  const uint16_t* rh1 = rh0 + 8 * kLdr;
  const uint16_t* rw1 = rw0 + 8 * kLdr;
  const float inv_w = 1.f / static_cast<float>(W);
  const uint32_t q_addr = wg::smem_u32(myQ);
  const uint32_t k_addr = wg::smem_u32(sK);
  const uint32_t v_addr = wg::smem_u32(sV);
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows lr and lr + 8, log2 domain
  float l_run[2] = {0.f, 0.f};              // this lane's share of the row sums

  for (int j = 0; j < tiles; ++j) {
    const int s = j % kStages;
    wg::mbar_wait(&full[s], (j / kStages) & 1);
    wg::fence_proxy_async();
    // S = Q K^T: 64 rows x 64 keys, D / 16 k-steps in the first design's order
    float sc[kBK / 8][4];
    wg::fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
      wg::mma_ss_n64<0>(sc, wg::desc_k(q_addr, kCh, kc),
                        wg::desc_k(k_addr + s * T::kTile * 2, kCh, kc), kc > 0);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(sc);

    // add the bias, mask keys past N, scale into the log2 domain, tile row max
    float mt[2];
    bias_max<kRow>(sc, rh0, rw0, rh1, rw1, j, N, W, inv_w, t, mt);
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
    wg::fence_regs(o);
    wg::fence();
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc)
      wg::mma_rs<D, 1>(o, pa[kc], wg::desc_n(v_addr + s * T::kTile * 2, kCh, kc), 1);
    wg::commit();
    wg::wait<0>();
    wg::fence_regs(o);
    wg::mbar_arrive(&empty[s]);
  }

  float inv[2];
  cor::softmax_inverse_sums(l_run, inv);
  // K6 for K6b: each row's log-sum-exp of the logits, natural log, into
  // lse [B, heads, N] (l_run now holds the whole row sums)
  if (!kWin && lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = r0 + lr + 8 * r;
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
    const int i = r0 + lr + 8 * r;
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
  uint16_t* out_h = out + h * D + 2 * t;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (orow[0] >= 0)
      *reinterpret_cast<uint32_t*>(out_h + orow[0] * C + n * 8) =
          pack_bf16x2(o[n][0] * inv[0], o[n][1] * inv[0]);
    if (orow[1] >= 0)
      *reinterpret_cast<uint32_t*>(out_h + orow[1] * C + n * 8) =
          pack_bf16x2(o[n][2] * inv[1], o[n][3] * inv[1]);
  }
}

// blocks: B images (K6) or B * wgrid.nW windows (K7); f32: fp32 operands
// (vit_attention_f32.cuh's kernel). Each instantiation's shared-memory
// attributes are set once per device.
template <int D, bool kWin, bool kRow>
int launch(const void* qkv, const void* rel_h, const void* rel_w, void* out, void* lse,
           int blocks, int N, int C, int num_heads, int H, int W, float scale, WindowGrid wgrid,
           int f32, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32) {
    const auto run = D == 64 ? cor::vit::launch_f32_d64 : cor::vit::launch_f32_d80;
    return run(static_cast<const float*>(qkv), static_cast<const float*>(rel_h),
               static_cast<const float*>(rel_w), static_cast<float*>(out),
               kWin ? nullptr : static_cast<float*>(lse), blocks, N, C, num_heads, H, W, scale,
               wgrid, kWin, s);
  }
  // the windows' blocks at D = 80 (one block an SM) are 64 rows: K7 0.259
  // against 0.318 ms with 128-row ones; at D = 64 128 rows read a window's
  // K/V twice, not four times (0.098 against 0.114 ms)
  const int groups = D == 80 && N <= 4 * kBK ? 1 : kGroups;
  auto kernel = vit_attention_relpos_kernel<D, kWin, kRow>;
  const int smem = Tiles<D>::smem(groups);
  static int raised[wg::kMaxDevices];
  const cudaError_t err = wg::raise_shared_memory(reinterpret_cast<const void*>(kernel),
                                                  Tiles<D>::smem(kGroups), raised);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + 64 * groups - 1) / (64 * groups), num_heads, blocks);
  kernel<<<grid, groups * 128 + kProducers, smem, s>>>(
      static_cast<const uint16_t*>(qkv), static_cast<const uint16_t*>(rel_h),
      static_cast<const uint16_t*>(rel_w), static_cast<uint16_t*>(out),
      static_cast<float*>(lse), N, C, H, W, scale, wgrid);
  return cudaGetLastError();
}

// K6 at head_dim D: the global blocks' kernel where W = 64
template <int D>
int launch_k6(const void* qkv, const void* rel_h, const void* rel_w, void* out, void* lse, int B,
              int N, int C, int num_heads, int H, int W, float scale, int f32, void* stream) {
  const WindowGrid none{};
  if (W == kBK)
    return launch<D, false, true>(qkv, rel_h, rel_w, out, lse, B, N, C, num_heads, H, W, scale,
                                  none, f32, stream);
  return launch<D, false, false>(qkv, rel_h, rel_w, out, lse, B, N, C, num_heads, H, W, scale,
                                 none, f32, stream);
}

}  // namespace

// qkv: [B, N, 3C] bf16 (f32 = 0) or fp32 (f32 = 1) contiguous, 16-byte
// aligned, C = num_heads * D with D in {64, 80}. rel_h: [B, num_heads, N, H],
// rel_w: [B, num_heads, N, W] contiguous, N = H * W, H and W <= 64. out:
// [B, N, C] contiguous. All four of one type. lse: null, or fp32
// [B, num_heads, N] that takes each row's log-sum-exp of the logits (natural
// log), the statistics K6b reads (bf16 and fp32 alike; out's bits do not
// change with it).
// scale: D^-1/2. Returns the launch's cudaError_t (cudaErrorInvalidValue for
// shapes the kernel does not take; a refused shared-memory size or launch as
// the runtime reports it).
extern "C" int cor_vit_attention_relpos(const void* qkv, const void* rel_h, const void* rel_w,
                                        void* out, void* lse, int B, int N, int C, int num_heads,
                                        int H, int W, float scale, int f32, void* stream) {
  if (B < 1 || N < 1 || num_heads < 1 || C % num_heads != 0 || B > 65535 ||
      num_heads > 65535 || H < 1 || W < 1 || H > kMaxSide || W > kMaxSide || H * W != N)
    return cudaErrorInvalidValue;
  switch (C / num_heads) {
    case 64:
      return launch_k6<64>(qkv, rel_h, rel_w, out, lse, B, N, C, num_heads, H, W, scale, f32,
                           stream);
    case 80:
      return launch_k6<80>(qkv, rel_h, rel_w, out, lse, B, N, C, num_heads, H, W, scale, f32,
                           stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// K7. qkv: [B, Hp, Wp, 3C] bf16 (f32 = 0) or fp32 (f32 = 1) contiguous,
// 16-byte aligned, C = num_heads * D with D in {64, 80}, Hp and Wp multiples
// of window (<= 64). rel_h, rel_w: [B, num_heads, Hp * Wp, window]
// contiguous. out: [B, H, W, C] contiguous, H <= Hp, W <= Wp. All four of
// one type. scale: D^-1/2. Returns the launch's
// cudaError_t (cudaErrorInvalidValue for shapes the kernel does not take).
extern "C" int cor_vit_attention_relpos_windows(const void* qkv, const void* rel_h,
                                                const void* rel_w, void* out, int B, int Hp,
                                                int Wp, int H, int W, int C, int num_heads,
                                                int window, float scale, int f32, void* stream) {
  if (B < 1 || num_heads < 1 || C % num_heads != 0 || num_heads > 65535 || window < 1 ||
      window > kMaxSide || Hp < window || Wp < window || Hp % window || Wp % window || H < 1 ||
      W < 1 || H > Hp || W > Wp)
    return cudaErrorInvalidValue;
  const int nwj = Wp / window, nW = (Hp / window) * nwj;
  if (static_cast<int64_t>(B) * nW > 65535) return cudaErrorInvalidValue;
  const WindowGrid wgrid{window, Hp, Wp, H, W, nwj, nW, 1.f / static_cast<float>(window)};
  const int N = window * window;
  switch (C / num_heads) {
    case 64:
      return launch<64, true, false>(qkv, rel_h, rel_w, out, nullptr, B * nW, N, C, num_heads,
                                     window, window, scale, wgrid, f32, stream);
    case 80:
      return launch<80, true, false>(qkv, rel_h, rel_w, out, nullptr, B * nW, N, C, num_heads,
                                     window, window, scale, wgrid, f32, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
