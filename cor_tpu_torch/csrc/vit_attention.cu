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
// does ~60 flop/byte: bound by bytes. The design is the port's K4
// (csrc/seq_attention.cu) with the bias, templated on the head_dim D
// (64: SAM-base and SAM-large; 80: sam_huge):
//  - one block of 4 warps per (64-query tile, head, image or window); each
//    warp owns 16 query rows;
//  - q is scaled and rounded to bf16 as it is staged in shared memory (the
//    TPU kernel's q * scale in the compute dtype, scale = D^-1/2 of the true
//    D: cor_tpu lane-pads 80 to 128 for its kernel and passes 80^-1/2); the
//    tile's rel_h and rel_w rows ([64][H], [64][W] bf16) are staged beside it
//    once;
//  - K and V stream through shared memory in 64-key tiles with 16-byte loads
//    (V transposed there, so its tensor-core operand is one 32-bit load);
//  - logits and P.V on mma.sync m16n8k16, bf16 in, fp32 accumulate (D / 16
//    k-steps for the logits, D / 8 n-tiles for P.V); the bias is added in
//    fp32; each lane steps the grid (row, column) of its keys through the
//    tile instead of dividing per key;
//  - online softmax in fp32 in the log2 domain, shifted by the running row
//    max (the TPU kernel shifts by the column mean of its concatenated keys:
//    the same function); P rounded to bf16 before P.V, as the TPU kernel
//    rounds its probabilities; the division by the fp32 row sum once at the
//    end;
//  - keys j >= N (the tail of the last tile: 196 = 3 * 64 + 4) are masked.
//    The zero tokens that window_partition pads in are real keys and are not.
// Shared memory, dynamic: Q and K tiles [64][72] bf16 at D = 64 and [64][88]
// at D = 80 (a row of 40 words would put fragment rows g and g + 4 on one
// bank; 44 words do not), V^T [D][72], the bias rows 2 x [64][72]: 46,080
// bytes at 64 and 52,480 at 80, above the 48 KiB a launch gets without
// cudaFuncSetAttribute. wgmma, TMA and a pipelined K/V ring are left for
// later. With a non-null lse (the forward autograd records) each row's
// log-sum-exp of the logits, natural log, is written into [B, heads, N]
// for K6b; out's bits do not change.
//
// K7, the same kernel with the window partition in its indexing (kWin):
// replaces cor_tpu/ops/pallas/vit_attention.py:
// vit_attention_relpos_windows_pallas (its pallas_call at line 180, the
// opt-in fused_window_indexing of the SAM encoder). Its qkv is the fused
// QKV GEMM over the whole zero-padded grid [B, Hp, Wp, 3C] (Hp, Wp multiples
// of the window ws; the pad tokens' k and v are the qkv bias, real keys of
// their window), and one block is one (image and window, head, 64-query
// tile): token i of window (wi, wj) is read by strides at grid row
// wi * ws + i / ws, column wj * ws + i % ws, so the partition is never
// materialised. The bias factors [B, heads, Hp * Wp, ws] are per grid token
// over the window's key rows and columns; the output is written straight
// into the cropped [B, H, W, C] grid (the tokens of the pad rows and
// columns are computed as keys need them and dropped), so the unpartition
// and the crop copies go too. The softmax, the rounding points and the
// masking of the last key tile (196 = 3 * 64 + 4) are K6's. The TPU
// kernel's 8-sublane column padding (14 -> 16) and its indicator matrices
// are TPU layout and have no counterpart here. It takes head_dim 64 and 80
// (cor_tpu's K7 takes no head_dim that needs lane padding, so at 80 cor_tpu
// falls back to the XLA partition and attention: the same function). What
// bounds it is what bounds K6's windowed shape: bytes.
//
// fp32 (compute_dtype float32), K6 and K7 alike:
// vit_attention_relpos_f32_kernel<D, kWin>, the same blocks, addressing,
// bias and online softmax on fp32 operands, every product in 3xTF32 on
// mma.sync m16n8k8 (mma_tf32x3.cuh): fp32 accuracy on the tensor cores at
// three TF32 products per fp32 one, so a global block is bound by
// operations at a third of the bf16 rate. q * scale, the bias and P stay
// fp32 (cor_tpu rounds to the compute dtype: nothing). Tiles [64][D + 4]
// fp32 (68 / 84 words: 4 mod 8, conflict-free TF32 fragments); Q shares
// its tile with K once it is in registers; V stays [key][d], read in the
// permuted key order that lets P's accumulator tiles be the A operand of
// P.V; the bias rows [64][68] fp32. 69,632 bytes of dynamic shared memory at
// D = 64 and 77,824 at 80.

#include "decoder_common.cuh"
#include "mma_tf32x3.cuh"

namespace {

using cor::bf2f;
using cor::lds32;
using cor::mma_bf16_16816;
using cor::pack_bf16x2;

constexpr int kBQ = 64;        // query rows per block (16 per warp)
constexpr int kBK = 64;        // keys per shared-memory tile
constexpr int kLdv = kBK + 8;  // padded row stride of the V^T tile [d][key], in bf16
constexpr int kMaxSide = 64;   // H, W <= 64
constexpr int kLdr = kMaxSide + 8;  // padded stride of the staged bias rows
constexpr int kThreads = 128;  // 4 warps
constexpr float kLog2e = 1.4426950408889634f;

// the shapes that follow from the head_dim D (64 or 80: whole m16n8k16 k-steps)
template <int D>
struct HeadDim {
  static_assert(D % 16 == 0, "the logits' product runs in k-steps of 16");
  static constexpr int kLdq = D == 64 ? 72 : 88;  // row stride of the Q and K tiles
  static_assert(kLdq >= D && (kLdq / 2) % 8 == 4, "conflict-free fragment rows");
  // sQ, sK [64][kLdq]; sVt [D][kLdv]; sRh, sRw [64][kLdr]
  static constexpr int kSmem = (2 * kBQ * kLdq + D * kLdv + 2 * kBQ * kLdr) * 2;
};

// two bf16 in one 32-bit word, each times s, rounded back to bf16
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t w, float s) {
  return pack_bf16x2(bf2f(static_cast<uint16_t>(w & 0xffffu)) * s,
                     bf2f(static_cast<uint16_t>(w >> 16)) * s);
}

// K7's window grid: windows of ws x ws tokens over the padded Hp x Wp grid
// (nwj windows per row of windows, nW per image), the output cropped to
// Hout x Wout; unused by K6
struct WindowGrid {
  int ws, Hp, Wp, Hout, Wout, nwj, nW;
};

// K6's logits of a 64-key tile (this lane's rows g and g + 8) + the bias
// rows' factors rh[key / W] + rw[key % W] of the compute dtype T, keys past N
// masked, into the log2 domain; mt: this lane's row maxima. Accumulator
// column (n, e & 1) is key k0 + 8n + 2t + (e & 1); its grid row jh and
// column jw step along with n.
template <typename T>
__device__ __forceinline__ void bias_mask_max(float (&s)[kBK / 8][4], const T* rh0, const T* rw0,
                                              const T* rh1, const T* rw1, int k0, int N, int W,
                                              int t, float (&mt)[2]) {
  using E = cor::Elem<T>;
  int jh = (k0 + 2 * t) / W;
  int jw = (k0 + 2 * t) - jh * W;
  mt[0] = mt[1] = -INFINITY;
#pragma unroll
  for (int n = 0; n < kBK / 8; ++n) {
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
    mt[0] = fmaxf(mt[0], fmaxf(s[n][0], s[n][1]));
    mt[1] = fmaxf(mt[1], fmaxf(s[n][2], s[n][3]));
    jw += 8;
    while (jw >= W) {
      jw -= W;
      ++jh;
    }
  }
}

// One (image or window, head, 64-query tile). K6 (kWin false): the N = H * W
// tokens of image blockIdx.z, rows of qkv [B, N, 3C]. K7 (kWin true): the
// N = ws * ws tokens of window blockIdx.z % nW of image blockIdx.z / nW,
// read by strides out of qkv [B, Hp, Wp, 3C] (H = W = ws). Four blocks an
// SM, as the shared memory allows: 128 registers at most (the lse epilogue
// took 133 at D = 80 without the bound, and a block an SM with them).
template <int D, bool kWin>
__global__ void __launch_bounds__(kThreads, 4)
vit_attention_relpos_kernel(const uint16_t* __restrict__ qkv, const uint16_t* __restrict__ rel_h,
                            const uint16_t* __restrict__ rel_w, uint16_t* __restrict__ out,
                            float* __restrict__ lse, int N, int C, int H, int W, float scale,
                            WindowGrid wg) {
  constexpr int kLds = HeadDim<D>::kLdq;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* sQ = reinterpret_cast<uint16_t*>(smem);
  uint16_t* sK = sQ + kBQ * kLds;    // [key][d]
  uint16_t* sVt = sK + kBK * kLds;   // [d][key]
  uint16_t* sRh = sVt + D * kLdv;    // [query][key grid row]
  uint16_t* sRw = sRh + kBQ * kLdr;  // [query][key grid column]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = kWin ? blockIdx.z / wg.nW : blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int64_t row_stride = 3LL * C;
  // the window's first grid row and column (K7)
  const int win = kWin ? blockIdx.z - b * wg.nW : 0;
  const int y0 = kWin ? (win / wg.nwj) * wg.ws : 0;
  const int x0 = kWin ? (win - (win / wg.nwj) * wg.nwj) * wg.ws : 0;
  const int64_t grid_n = kWin ? static_cast<int64_t>(wg.Hp) * wg.Wp : N;  // tokens per image
  // the place of this block's token i (< N) in its image's token grid
  auto grid_pos = [&](int i) -> int64_t {
    if (!kWin) return i;
    const int r = i / wg.ws;
    return static_cast<int64_t>(y0 + r) * wg.Wp + x0 + (i - r * wg.ws);
  };
  const uint16_t* base = qkv + static_cast<int64_t>(b) * grid_n * row_stride + h * D;

  // Q tile, scaled and rounded to bf16 -> shared (rows past N are zero)
  for (int i = tid; i < kBQ * (D / 8); i += kThreads) {
    const int r = i / (D / 8);
    const int c8 = (i % (D / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < N) {
      v = *reinterpret_cast<const uint4*>(base + grid_pos(q0 + r) * row_stride + c8);
      v = make_uint4(scale_bf16x2(v.x, scale), scale_bf16x2(v.y, scale),
                     scale_bf16x2(v.z, scale), scale_bf16x2(v.w, scale));
    }
    *reinterpret_cast<uint4*>(&sQ[r * kLds + c8]) = v;
  }
  // the tile's bias rows of this (image, head): rel_h/rel_w [B, heads,
  // grid_n, H|W]
  const int64_t rel_base = (static_cast<int64_t>(b) * gridDim.y + h) * grid_n;
  for (int i = tid; i < kBQ * H; i += kThreads) {
    const int r = i / H, c = i % H;
    sRh[r * kLdr + c] =
        q0 + r < N ? rel_h[(rel_base + grid_pos(q0 + r)) * H + c] : uint16_t(0);
  }
  for (int i = tid; i < kBQ * W; i += kThreads) {
    const int r = i / W, c = i % W;
    sRw[r * kLdr + c] =
        q0 + r < N ? rel_w[(rel_base + grid_pos(q0 + r)) * W + c] : uint16_t(0);
  }
  __syncthreads();

  // this warp's 16 query rows as m16k16 A fragments, one per 16 columns of D
  const int wr = warp * 16;
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const uint16_t* p = sQ + (wr + g) * kLds + kc * 16 + 2 * t;
    qa[kc][0] = lds32(p);
    qa[kc][1] = lds32(p + 8 * kLds);
    qa[kc][2] = lds32(p + 8);
    qa[kc][3] = lds32(p + 8 * kLds + 8);
  }
  // the bias rows of this lane's two query rows (g and g + 8)
  const uint16_t* rh0 = sRh + (wr + g) * kLdr;
  const uint16_t* rw0 = sRw + (wr + g) * kLdr;
  const uint16_t* rh1 = rh0 + 8 * kLdr;
  const uint16_t* rw1 = rw0 + 8 * kLdr;

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, log2 domain
  float l_run[2] = {0.f, 0.f};              // this lane's share of the row sums

  for (int k0 = 0; k0 < N; k0 += kBK) {
    __syncthreads();  // the previous K/V tile is fully consumed
    for (int i = tid; i < kBK * (D / 8); i += kThreads) {
      const int r = i / (D / 8);
      const int c8 = (i % (D / 8)) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < N) {
        const uint16_t* rowp = base + grid_pos(k0 + r) * row_stride + c8;
        kv = *reinterpret_cast<const uint4*>(rowp + C);
        vv = *reinterpret_cast<const uint4*>(rowp + 2 * C);
      }
      *reinterpret_cast<uint4*>(&sK[r * kLds + c8]) = kv;
      const uint32_t w[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sVt[(c8 + 2 * j) * kLdv + r] = static_cast<uint16_t>(w[j] & 0xffffu);
        sVt[(c8 + 2 * j + 1) * kLdv + r] = static_cast<uint16_t>(w[j] >> 16);
      }
    }
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys, 8 n-tiles of 8 keys
    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const uint16_t* p = sK + (n * 8 + g) * kLds + kc * 16 + 2 * t;
        mma_bf16_16816(s[n], qa[kc], lds32(p), lds32(p + 8));
      }
    }

    // add the bias, mask keys past N, scale into the log2 domain, tile row max
    float mt[2];
    bias_mask_max(s, rh0, rw0, rh1, rw1, k0, N, W, t, mt);
    cor::softmax_rescale(mt, m_run, l_run, o);

    // P = exp2(S - m) in fp32 for the row sums, bf16 A fragments for P.V:
    // accumulator tiles 2kc and 2kc+1 are exactly the A fragment of keys
    // 16kc .. 16kc+15
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      const float p0 = exp2f(s[n][0] - m_run[0]);
      const float p1 = exp2f(s[n][1] - m_run[0]);
      const float p2 = exp2f(s[n][2] - m_run[1]);
      const float p3 = exp2f(s[n][3] - m_run[1]);
      l_run[0] += p0 + p1;
      l_run[1] += p2 + p3;
      pa[n >> 1][(n & 1) * 2 + 0] = pack_bf16x2(p0, p1);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16x2(p2, p3);
    }

    // O += P V: B[key][d] = V[key][d], read from the transposed tile
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
#pragma unroll
      for (int kc = 0; kc < kBK / 16; ++kc) {
        const uint16_t* p = sVt + (n * 8 + g) * kLdv + kc * 16 + 2 * t;
        mma_bf16_16816(o[n], pa[kc], lds32(p), lds32(p + 8));
      }
    }
  }

  float inv[2];
  cor::softmax_inverse_sums(l_run, inv);
  // K6 for K6b: each row's log-sum-exp of the logits, natural log, into
  // lse [B, heads, N] (l_run now holds the whole row sums)
  if (!kWin && lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = q0 + wr + g + 8 * r;
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
    const int i = q0 + wr + g + 8 * r;
    orow[r] = -1;
    if (i < N) {
      if (!kWin) {
        orow[r] = static_cast<int64_t>(b) * N + i;
      } else {
        const int y = y0 + i / wg.ws, x = x0 + i % wg.ws;
        if (y < wg.Hout && x < wg.Wout)
          orow[r] = (static_cast<int64_t>(b) * wg.Hout + y) * wg.Wout + x;
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

// the fp32 case's tiles: sQK, sV [64][D + 4]; sRh, sRw [64][kLdrF]
constexpr int kLdrF = kMaxSide + 4;
template <int D>
struct HeadDimF32 {
  static_assert(D % 8 == 0, "the products run in k-steps of 8");
  static constexpr int kLd = D + 4;  // 4 mod 8 words: conflict-free TF32 fragments
  static constexpr int kSmem = (2 * kBK * kLd + 2 * kBQ * kLdrF) * 4;
};

// K6 / K7 on fp32 operands (qkv, rel_h, rel_w, out fp32), as the kernel above.
template <int D, bool kWin>
__global__ void __launch_bounds__(kThreads)
vit_attention_relpos_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ rel_h,
                                const float* __restrict__ rel_w, float* __restrict__ out, int N,
                                int C, int H, int W, float scale, WindowGrid wg) {
  constexpr int kLd = HeadDimF32<D>::kLd;
  constexpr int kChunks = D / 4;  // 16-byte chunks of a row
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQK = reinterpret_cast<float*>(smem);  // the Q tile, then each K tile [key][d]
  float* sV = sQK + kBK * kLd;                  // [key][d]
  float* sRh = sV + kBK * kLd;                  // [query][key grid row]
  float* sRw = sRh + kBQ * kLdrF;               // [query][key grid column]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = kWin ? blockIdx.z / wg.nW : blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int64_t row_stride = 3LL * C;
  const int win = kWin ? blockIdx.z - b * wg.nW : 0;
  const int y0 = kWin ? (win / wg.nwj) * wg.ws : 0;
  const int x0 = kWin ? (win - (win / wg.nwj) * wg.nwj) * wg.ws : 0;
  const int64_t grid_n = kWin ? static_cast<int64_t>(wg.Hp) * wg.Wp : N;
  auto grid_pos = [&](int i) -> int64_t {
    if (!kWin) return i;
    const int r = i / wg.ws;
    return static_cast<int64_t>(y0 + r) * wg.Wp + x0 + (i - r * wg.ws);
  };
  const float* base = qkv + static_cast<int64_t>(b) * grid_n * row_stride + h * D;

  // Q tile, scaled in fp32 -> shared (rows past N are zero)
  for (int i = tid; i < kBQ * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c4 = (i % kChunks) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < N) {
      v = *reinterpret_cast<const float4*>(base + grid_pos(q0 + r) * row_stride + c4);
      v = make_float4(v.x * scale, v.y * scale, v.z * scale, v.w * scale);
    }
    *reinterpret_cast<float4*>(&sQK[r * kLd + c4]) = v;
  }
  const int64_t rel_base = (static_cast<int64_t>(b) * gridDim.y + h) * grid_n;
  for (int i = tid; i < kBQ * H; i += kThreads) {
    const int r = i / H, c = i % H;
    sRh[r * kLdrF + c] = q0 + r < N ? rel_h[(rel_base + grid_pos(q0 + r)) * H + c] : 0.f;
  }
  for (int i = tid; i < kBQ * W; i += kThreads) {
    const int r = i / W, c = i % W;
    sRw[r * kLdrF + c] = q0 + r < N ? rel_w[(rel_base + grid_pos(q0 + r)) * W + c] : 0.f;
  }
  __syncthreads();

  const int wr = warp * 16;
  cor::FragA qa[D / 8];
#pragma unroll
  for (int kc = 0; kc < D / 8; ++kc) qa[kc] = cor::load_a_tf32(sQK, kLd, wr, kc * 8, g, t);
  const float* rh0 = sRh + (wr + g) * kLdrF;
  const float* rw0 = sRw + (wr + g) * kLdrF;
  const float* rh1 = rh0 + 8 * kLdrF;
  const float* rw1 = rw0 + 8 * kLdrF;

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < N; k0 += kBK) {
    __syncthreads();  // the Q fragments, or the previous K/V tile, are consumed
    for (int i = tid; i < kBK * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int c4 = (i % kChunks) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kv;
      if (k0 + r < N) {
        const float* rowp = base + grid_pos(k0 + r) * row_stride + c4;
        kv = *reinterpret_cast<const float4*>(rowp + C);
        vv = *reinterpret_cast<const float4*>(rowp + 2 * C);
      }
      *reinterpret_cast<float4*>(&sQK[r * kLd + c4]) = kv;
      *reinterpret_cast<float4*>(&sV[r * kLd + c4]) = vv;
    }
    __syncthreads();

    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 8; ++kc)
        cor::mma_tf32x3(s[n], qa[kc], cor::load_b_tf32(sQK, kLd, n * 8, kc * 8, g, t));
    }

    float mt[2];
    bias_mask_max(s, rh0, rw0, rh1, rw1, k0, N, W, t, mt);
    cor::softmax_rescale(mt, m_run, l_run, o);

    // O += P V, one k-step of 8 keys per accumulator tile of S, keys in the
    // permuted order (2t, 2t + 1 of the tile)
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      const float p0 = exp2f(s[n][0] - m_run[0]);
      const float p1 = exp2f(s[n][1] - m_run[0]);
      const float p2 = exp2f(s[n][2] - m_run[1]);
      const float p3 = exp2f(s[n][3] - m_run[1]);
      l_run[0] += p0 + p1;
      l_run[1] += p2 + p3;
      const cor::FragA pa = cor::a_from_c_tf32(p0, p1, p2, p3);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        cor::mma_tf32x3(o[j], pa, cor::load_b_tf32_kn_paired(sV, kLd, n * 8, j * 8, g, t));
    }
  }

  float inv[2];
  cor::softmax_inverse_sums(l_run, inv);
  int64_t orow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = q0 + wr + g + 8 * r;
    orow[r] = -1;
    if (i < N) {
      if (!kWin) {
        orow[r] = static_cast<int64_t>(b) * N + i;
      } else {
        const int y = y0 + i / wg.ws, x = x0 + i % wg.ws;
        if (y < wg.Hout && x < wg.Wout)
          orow[r] = (static_cast<int64_t>(b) * wg.Hout + y) * wg.Wout + x;
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

// blocks: B images (K6) or B * wg.nW windows (K7); f32: fp32 operands
template <int D, bool kWin>
int launch(const void* qkv, const void* rel_h, const void* rel_w, void* out, void* lse,
           int blocks, int N, int C, int num_heads, int H, int W, float scale, WindowGrid wg,
           int f32, void* stream) {
  const dim3 grid((N + kBQ - 1) / kBQ, num_heads, blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32) {
    constexpr int smem = HeadDimF32<D>::kSmem;
    const cudaError_t err =
        cudaFuncSetAttribute(vit_attention_relpos_f32_kernel<D, kWin>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    vit_attention_relpos_f32_kernel<D, kWin><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(rel_h),
        static_cast<const float*>(rel_w), static_cast<float*>(out), N, C, H, W, scale, wg);
    return cudaGetLastError();
  }
  constexpr int smem = HeadDim<D>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      vit_attention_relpos_kernel<D, kWin>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  vit_attention_relpos_kernel<D, kWin><<<grid, kThreads, smem, s>>>(
      static_cast<const uint16_t*>(qkv), static_cast<const uint16_t*>(rel_h),
      static_cast<const uint16_t*>(rel_w), static_cast<uint16_t*>(out),
      static_cast<float*>(lse), N, C, H, W, scale, wg);
  return cudaGetLastError();
}

}  // namespace

// qkv: [B, N, 3C] bf16 (f32 = 0) or fp32 (f32 = 1) contiguous, 16-byte
// aligned, C = num_heads * D with D in {64, 80}. rel_h: [B, num_heads, N, H],
// rel_w: [B, num_heads, N, W] contiguous, N = H * W, H and W <= 64. out:
// [B, N, C] contiguous. All four of one type. lse: null, or (bf16 only) fp32
// [B, num_heads, N] that takes each row's log-sum-exp of the logits (natural
// log), the statistics K6b reads; the fp32 kernel ignores it.
// scale: D^-1/2. Returns the launch's cudaError_t (cudaErrorInvalidValue for
// shapes the kernel does not take; a refused shared-memory size or launch as
// the runtime reports it).
extern "C" int cor_vit_attention_relpos(const void* qkv, const void* rel_h, const void* rel_w,
                                        void* out, void* lse, int B, int N, int C, int num_heads,
                                        int H, int W, float scale, int f32, void* stream) {
  if (B < 1 || N < 1 || num_heads < 1 || C % num_heads != 0 || B > 65535 ||
      num_heads > 65535 || H < 1 || W < 1 || H > kMaxSide || W > kMaxSide || H * W != N)
    return cudaErrorInvalidValue;
  const WindowGrid none{};
  switch (C / num_heads) {
    case 64:
      return launch<64, false>(qkv, rel_h, rel_w, out, lse, B, N, C, num_heads, H, W, scale,
                               none, f32, stream);
    case 80:
      return launch<80, false>(qkv, rel_h, rel_w, out, lse, B, N, C, num_heads, H, W, scale,
                               none, f32, stream);
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
  const WindowGrid wg{window, Hp, Wp, H, W, nwj, nW};
  const int N = window * window;
  switch (C / num_heads) {
    case 64:
      return launch<64, true>(qkv, rel_h, rel_w, out, nullptr, B * nW, N, C, num_heads, window,
                              window, scale, wg, f32, stream);
    case 80:
      return launch<80, true>(qkv, rel_h, rel_w, out, nullptr, B * nW, N, C, num_heads, window,
                              window, scale, wg, f32, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
