// The backward of K6 (csrc/vit_attention.cu): SAM ViT attention with the
// decomposed relative-position bias, off a fused QKV tensor. For every head
// h, over the N = H * W tokens of one image or window, with the forward's
//
//   l[i, j] = bf16(q_i * scale) . k_j + rel_h[i, j / W] + rel_w[i, j % W],  a = softmax_j(l)
//
// and the cotangent do of the output:
//
//   da = do v^T,  delta_i = sum_j a[i, j] da[i, j],  dl = a * (da - delta)
//   dq = bf16(dl) k * scale,  dk = bf16(dl)^T bf16(q * scale),  dv = bf16(a)^T do
//   drel_h[i, r] = sum_{j / W == r} bf16(dl)[i, j],  drel_w[i, c] = sum_{j % W == c} bf16(dl)[i, j]
//
// Replaces the TPU kernel cor_tpu/ops/pallas/vit_attention.py:
// _vit_attention_relpos_bwd (its pallas_call at line 459, K6's custom_vjp).
// That kernel holds a whole [Tq, N] logit row in VMEM, so it needs no row
// statistics, and reads the bias gradients off one GEMM against the
// concatenated keys [k | Eh^T | Ew^T]. Here, FlashAttention-2 style, the
// logits are recomputed in 64 x 64 tiles and never reach memory, in a dq
// pass (one block per 64-query tile, head and image: dq and the bias
// gradients) and a dk/dv pass (one block per 64-key tile), with no atomics.
// Rounding points are the TPU kernel's: q * scale in bf16; logits, a, da and
// dl in fp32; a and dl rounded to bf16 before their products; dq, dk, dv
// and the bias gradients summed in fp32 and rounded once. (The TPU kernel
// shifts its keys by their column mean; rowsum(dl) = 0 makes the shift
// vanish from every gradient, so none is applied.) Keys j >= N (the tail of
// the last tile: 196 = 3 * 64 + 4) and queries i >= N are masked. Templated
// on the head_dim D: 64 (SAM-base, SAM-large) and 80 (sam_huge; scale
// 80^-1/2).
//
// bf16: vit_attention_bwd_wgmma.cuh, the Hopper design (wgmma, a producer
// warp's cp.async ring, the forward's log-sum-exp, delta from the forward's
// output: seven products where this file's first design ran nine),
// instantiated in vit_attention_bwd_d64.cu and vit_attention_bwd_d80.cu.
//
// fp32 (compute_dtype float32): vit_attention_bwd_{prep,dq,dkv}_f32_kernel,
// redesigned from the first design's two passes, whose dq pass swept
// the key tiles twice (nine products where the gradient needs five), held
// 154,368 / 170,752 bytes of shared memory (one 4-warp block an SM) and
// staged every tile through registers between barriers. Every product is
// 3xTF32 on mma.sync m16n8k8 (mma_tf32x3.cuh): fp32 accuracy at three TF32
// products per fp32 one. Rounding points are cor_tpu's in fp32, so nothing
// is rounded: q * scale, a and dl enter their products as they are. Three
// launches, deterministic, without atomics:
//  0. prep: delta_i = sum_d do_i,d out_i,d in fp32 over the forward's fp32
//     out (one block per token row); the rows' log-sum-exp comes from the
//     forward (the fp32 K6 writes it as the bf16 one does), so no pass
//     recomputes the statistics;
//  1. dq: one block of 8 warps per (128 queries, head, image), sharing each
//     64-key K/V tile of a 2-stage cp.async ring (every thread copies, two
//     barriers a tile): S and dP, a = exp(S + bias - lse) in the natural
//     domain (the forward's lse as it is: no rescaling by log2 e to round),
//     dl = a (dP - delta), dQ += dl K. Three products a tile. The bias
//     gradients: W = 64 (the global blocks, kRowSums) makes a key tile one
//     key-grid row, so drel_h[:, j] is the tile's row sum of dl (written
//     once) and drel_w the tiles' dl summed in registers; any other grid
//     (kIndicator: the 14 x 14 windows) takes cor_tpu's product dl [Eh | Ew]
//     against the indicator columns, 32 at a time, built in registers (exact
//     in TF32: two products, dl's halves), each k-step's sum taken from zero
//     on the tensor cores and added on the CUDA cores, each tile's added by
//     its own lane to an fp32 accumulator in shared memory. The forward's
//     fp32 statistics are off
//     by its fp32 error: delta = rowsum(do * out) by out's (~1e-6, which the
//     first design's own rowsum(a * da) did not have, and which cost the
//     bias gradients their accuracy against float64: tools/k6b_accuracy.py),
//     lse by its rounding. The pass sees every key of its rows and dl sums
//     to 0 over a row, so its own row sums of a and dl correct both: dq and
//     the bias gradients are normalised by the row's sum of a, the bias
//     gradients take the delta error times their sums of a, and the pass
//     writes the corrected lse and delta for the dk/dv pass;
//  2. dk/dv: one block of 8 warps per (128 keys, head, image), sharing each
//     query tile of the ring (Q, dO, the tile's rel_w rows, the rel_h columns
//     of the block's key-grid rows, lse and delta): S^T and dP^T, a^T and
//     dl^T, dV += a^T dO, dK += dl^T (q * scale). Four products a tile. Q is
//     scaled in place where it lands, by the thread that copied it.
// Seven products where the first design ran nine. Tiles [token][d] take a
// row stride of D + 4 words (68 / 84: 4 mod 8, conflict-free TF32
// fragments) and no tile is transposed: the products whose contraction runs
// over tokens read their accumulator tiles as A operands in the permuted k
// order of mma_tf32x3.cuh and B ([token][d]) in the same order. The operands
// are split into their TF32 halves at each fragment load: big and small
// copies of the shared tiles would not fit beside 8 warps' Q and dO (or K
// and V). Dynamic shared memory (D = 64 / 80): dq 176,128 / 208,896 bytes at
// the global blocks, 188,416 / 221,184 at the windows; dk/dv 176,640 /
// 209,408 and 180,736 / 213,504: one 8-warp block an SM (the first design:
// one 4-warp block in the dq pass). A grid whose bias rows would not fit
// takes 4-warp blocks. What bounds it: operations, at a third of the bf16
// rate.

#include <cuda_fp16.h>

#include "decoder_common.cuh"
#include "mma_tf32x3.cuh"
#include "vit_attention_bwd_wgmma.cuh"

namespace {

using cor::k6b::kIndicator;
using cor::k6b::kMaxSide;
using cor::k6b::kPrepThreads;
using cor::k6b::kRowSums;
using cor::k6b::kT;
using cor::quad_sum;

// ---------------------------------------------------------------------------
// fp32: prep (delta), the dq pass and the dk/dv pass, products in 3xTF32
// ---------------------------------------------------------------------------

constexpr int kGroupsF32 = 2;      // warps / 4 of a block (each warp 16 rows)
constexpr int kStagesF32 = 2;      // the streamed tiles' ring
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block can have (227 KB)
constexpr int kLdwQ = kMaxSide + 8;  // the dq pass's rel_w rows, read in pairs: 8 mod 32 words
constexpr int kLdwK = kMaxSide + 4;  // the dk/dv pass's, read by 8 keys x 4 queries: 4 mod 32

// the shapes of one head_dim D
template <int D>
struct F32 {
  static_assert(D % 8 == 0, "the products run in k-steps of 8");
  static constexpr int kLd = D + 4;       // row stride of a [token][d] tile: 4 mod 8 words
  static constexpr int kTile = kT * kLd;  // floats of a 64-row tile
  static constexpr int kChunks = D / 4;   // 16-byte chunks of a row
};

// The dq pass's shared memory, in floats: Q and dO [rows][kLd], kStagesF32 x
// (K, V) [64][kLd], then the bias rows and (kIndicator) the bias gradients'
// accumulators: kRowSums stages rel_w [rows][kLdwQ] (rel_h is one value a
// row and tile, read from device memory); kIndicator rel_h [rows][H + 1] and
// rel_w [rows][W + 1], and [drel_h | drel_w] and the same sums of a
// [rows][acc_ld(H, W)].
template <int D>
struct DqPlan {
  static __host__ __device__ int acc_ld(int H, int W) { return (H + W + 31) / 32 * 32 + 1; }
  static __host__ __device__ int bias_floats(int rows, int H, int W, int bias) {
    return bias == kRowSums ? rows * kLdwQ : rows * (H + 1 + W + 1 + 2 * acc_ld(H, W));
  }
  static __host__ __device__ int bytes(int groups, int H, int W, int bias) {
    const int rows = 64 * groups;
    return (2 * rows * F32<D>::kLd + kStagesF32 * 2 * F32<D>::kTile +
            bias_floats(rows, H, W, bias)) * 4;
  }
};

// The dk/dv pass's shared memory, in floats: K and V [keys][kLd], then per
// stage Q * scale and dO [64][kLd], rel_w [64][kLdwQ], the rel_h columns of the
// block's key rows [64][rh_ld], lse and delta [64].
template <int D>
struct DkvPlan {
  // the key-grid rows a block of `keys` keys spans, and their columns' stride
  static __host__ __device__ int rh_cols(int keys, int H, int W) {
    const int spanned = (keys - 1) / W + 2;
    return spanned < H ? spanned : H;
  }
  static __host__ __device__ int rh_ld(int keys, int H, int W) { return rh_cols(keys, H, W) | 1; }
  static __host__ __device__ int stage_floats(int keys, int H, int W) {
    return 2 * F32<D>::kTile + kT * kLdwK + kT * rh_ld(keys, H, W) + 2 * kT;
  }
  static __host__ __device__ int bytes(int groups, int H, int W) {
    const int keys = 64 * groups;
    return (2 * keys * F32<D>::kLd + kStagesF32 * stage_floats(keys, H, W)) * 4;
  }
};

// Start copying rows [r0, r0 + 64) of an fp32 [., stride] matrix, D columns
// from src, into s [64][D + 4] (all `threads` threads of the block); rows >= N
// zero-filled.
template <int D>
__device__ __forceinline__ void copy_tile_f32(float* s, const float* src, int64_t stride, int r0,
                                              int N, int tid, int threads) {
  constexpr int kCh = F32<D>::kChunks;
  for (int i = tid; i < kT * kCh; i += threads) {
    const int r = i / kCh, c = i - r * kCh;
    const bool ok = r0 + r < N;
    cor::wg::cp16(s + r * F32<D>::kLd + c * 4, ok ? src + (r0 + r) * stride + c * 4 : src,
                  ok ? 16u : 0u);
  }
}

// Start copying `rows` rows of `cols` fp32 (row r at src + r * stride) into
// dst [rows][ld]; rows >= n_valid zero-filled. 16-byte copies where src,
// stride and cols allow them, else 4-byte ones.
__device__ __forceinline__ void copy_rows_f32(float* dst, int ld, const float* src, int64_t stride,
                                              int rows, int cols, int n_valid, int tid,
                                              int threads) {
  if (((reinterpret_cast<uintptr_t>(src) | (stride * 4) | (ld * 4) | (cols * 4)) & 15) == 0) {
    const int ch = cols / 4;
    for (int i = tid; i < rows * ch; i += threads) {
      const int r = i / ch, c = i - r * ch;
      const bool ok = r < n_valid;
      cor::wg::cp16(dst + r * ld + c * 4, ok ? src + r * stride + c * 4 : src, ok ? 16u : 0u);
    }
  } else {
    for (int i = tid; i < rows * cols; i += threads) {
      const int r = i / cols, c = i - r * cols;
      const bool ok = r < n_valid;
      cor::wg::cp4(dst + r * ld + c, ok ? src + r * stride + c : src, ok ? 4u : 0u);
    }
  }
}

// acc[j] += P (16 x 64 accumulator tiles p, the contraction over their 64
// columns) times sB [64 tokens][D + 4]: k-step n of P's tile n, in the
// permuted order, against rows 8n + 2t and 8n + 2t + 1 of sB
template <int D>
__device__ __forceinline__ void mma_acc_f32(float (&acc)[D / 8][4], const float (&p)[kT / 8][4],
                                            const float* sB, int g, int t) {
#pragma unroll
  for (int n = 0; n < kT / 8; ++n) {
    const cor::FragA a = cor::a_from_c_tf32(p[n][0], p[n][1], p[n][2], p[n][3]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      cor::mma_tf32x3(acc[j], a, cor::load_b_tf32_kn_paired(sB, F32<D>::kLd, n * 8, j * 8, g, t));
  }
}

// One block per token row (b, i): delta[b, h, i] = sum_d do[b, i, hD + d]
// out[b, i, hD + d] in fp32 over the forward's fp32 out, each 4-column
// chunk's partial summed in order.
template <int D>
__global__ void __launch_bounds__(kPrepThreads)
vit_attention_bwd_prep_f32_kernel(const float* __restrict__ dout, const float* __restrict__ out,
                                  float* __restrict__ delta, int N, int C, int heads) {
  __shared__ float part[cor::k6b::kMaxC / 4];
  const int64_t row = blockIdx.x;
  const int64_t b = row / N;
  const int i = static_cast<int>(row - b * N);
  const float4* drow = reinterpret_cast<const float4*>(dout + row * C);
  const float4* orow = reinterpret_cast<const float4*>(out + row * C);
  for (int c = threadIdx.x; c < C / 4; c += kPrepThreads) {
    const float4 x = drow[c], y = orow[c];
    part[c] = x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
  }
  __syncthreads();
  for (int hh = threadIdx.x; hh < heads; hh += kPrepThreads) {
    float s = 0.f;
    for (int c = hh * (D / 4); c < (hh + 1) * (D / 4); ++c) s += part[c];
    delta[(b * heads + hh) * N + i] = s;
  }
}

// key's grid row and column by a float reciprocal (exact for keys < 2^12 and
// W <= 64)
__device__ __forceinline__ void grid_rc(int key, int W, float inv_w, int& jh, int& jw) {
  jh = __float2int_rz((static_cast<float>(key) + 0.5f) * inv_w);
  jw = key - jh * W;
}

// The dq pass: one block per (64 groups query rows, head, image), 4 groups
// warps sharing each K/V tile of the ring; kBias, how it sums the bias
// gradients (kRowSums: W = 64; kIndicator: any other grid).
template <int D, int kBias>
__global__ void __launch_bounds__(kGroupsF32 * 128)
vit_attention_bwd_dq_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ rel_h,
                                const float* __restrict__ rel_w, const float* __restrict__ dout,
                                const float* __restrict__ lse, float* __restrict__ delta,
                                float* __restrict__ lse_c, float* __restrict__ dqkv,
                                float* __restrict__ drel_h, float* __restrict__ drel_w, int N,
                                int C, int H, int W, float scale) {
  constexpr int kLd = F32<D>::kLd, kTile = F32<D>::kTile;
  const int threads = blockDim.x;
  const int rows = threads / 2;  // 16 a warp
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);  // [query][d], q * scale
  float* sDO = sQ + rows * kLd;                 // [query][d]
  float* sKV = sDO + rows * kLd;                // kStagesF32 x (K, V) [key][d]
  float* sBias = sKV + kStagesF32 * 2 * kTile;
  const int hw_ld = DqPlan<D>::acc_ld(H, W);
  float* sRh = sBias;                                            // kIndicator: [query][H + 1]
  float* sRw = kBias == kRowSums ? sBias : sRh + rows * (H + 1);  // [query][kLdwQ | W + 1]
  float* sAcc = sRw + rows * (W + 1);  // kIndicator: [query][hw_ld], [drel_h | drel_w]
  float* sAccA = sAcc + rows * hw_ld;  // kIndicator: [query][hw_ld], the same sums of a

  const int q0 = blockIdx.x * rows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int heads = gridDim.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp * 16;
  const int tiles = (N + kT - 1) / kT;
  const int64_t row_stride = 3LL * C;
  const float* base = qkv + static_cast<int64_t>(b) * N * row_stride + h * D;
  const int64_t rel_row0 = (static_cast<int64_t>(b) * heads + h) * N + q0;
  const int nq = min(rows, N - q0);
  const int rw_ld = kBias == kRowSums ? kLdwQ : W + 1;

  // dO, the bias rows and the first K/V tile by cp.async (one group); Q
  // scaled in registers on the way (cor_tpu's q * scale in fp32)
  copy_rows_f32(sDO, kLd, dout + static_cast<int64_t>(b) * N * C + h * D + q0 * C, C, rows, D,
                nq, tid, threads);
  copy_rows_f32(sRw, rw_ld, rel_w + rel_row0 * W, W, rows, W, nq, tid, threads);
  if constexpr (kBias == kIndicator)
    copy_rows_f32(sRh, H + 1, rel_h + rel_row0 * H, H, rows, H, nq, tid, threads);
  copy_tile_f32<D>(sKV, base + C, row_stride, 0, N, tid, threads);
  copy_tile_f32<D>(sKV + kTile, base + 2 * C, row_stride, 0, N, tid, threads);
  cor::cp_async_commit();
  for (int i = tid; i < rows * F32<D>::kChunks; i += threads) {
    const int r = i / F32<D>::kChunks, c4 = (i - r * F32<D>::kChunks) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nq) {
      v = *reinterpret_cast<const float4*>(base + (q0 + r) * row_stride + c4);
      v = make_float4(v.x * scale, v.y * scale, v.z * scale, v.w * scale);
    }
    *reinterpret_cast<float4*>(&sQ[r * kLd + c4]) = v;
  }
  if constexpr (kBias == kIndicator)
    for (int i = tid; i < 2 * rows * hw_ld; i += threads) sAcc[i] = 0.f;  // sAcc, sAccA

  // this lane's rows wr + g and wr + g + 8: the forward's lse (natural log,
  // used as it is: a = exp(l - lse), no rescaling into the log2 domain to
  // round) and delta
  float lse_r[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wr + g + 8 * r;
    lse_r[r] = row < nq ? lse[rel_row0 + row] : 0.f;
    dlt[r] = row < nq ? delta[rel_row0 + row] : 0.f;
  }
  const float* rw0 = sRw + (wr + g) * rw_ld;
  const float* rw1 = rw0 + 8 * rw_ld;
  const float* rh0 = sRh + (wr + g) * (H + 1);
  const float* rh1 = rh0 + 8 * (H + 1);
  const float inv_w = 1.f / static_cast<float>(W);
  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  // kRowSums: drel_w of this lane's rows, the tiles' dl summed in registers;
  // beside it the sums of a that the statistics' correction needs (fp16
  // pairs: they scale a correction of ~1e-6 relative) and each tile's row sum
  // of a, kept in the k third of this (row, head)'s dqkv until the dk/dv
  // pass writes dk there. Both modes: the rows' sums of dl and of a.
  constexpr int kAcc = kBias == kRowSums ? kT / 8 : 1;
  float drw[kAcc][4];
  __half2 aw[kAcc][2];
#pragma unroll
  for (int n = 0; n < kAcc; ++n) {
    drw[n][0] = drw[n][1] = drw[n][2] = drw[n][3] = 0.f;
    aw[n][0] = aw[n][1] = __floats2half2_rn(0.f, 0.f);
  }
  float dl_sum[2] = {0.f, 0.f}, a_sum[2] = {0.f, 0.f};
  float* ah0 = dqkv + static_cast<int64_t>(b) * N * row_stride + (q0 + wr + g) * row_stride + C +
               h * D;
  float* ah1 = ah0 + 8 * row_stride;

  float s[kT / 8][4], dp[kT / 8][4];
  for (int j = 0; j < tiles; ++j) {
    const float* sK = sKV + (j % kStagesF32) * 2 * kTile;
    const float* sV = sK + kTile;
    if (j + 1 < tiles) {  // the next tile into the other stage, consumed at j - 1
      float* nK = sKV + ((j + 1) % kStagesF32) * 2 * kTile;
      copy_tile_f32<D>(nK, base + C, row_stride, (j + 1) * kT, N, tid, threads);
      copy_tile_f32<D>(nK + kTile, base + 2 * C, row_stride, (j + 1) * kT, N, tid, threads);
    }
    cor::cp_async_commit();
    cor::cp_async_wait<1>();  // tile j (and, at j = 0, dO and the bias rows) landed
    __syncthreads();
    const int k0 = j * kT;
    // kRowSums: rel_h of this tile's key-grid row j for the lane's rows
    float h0 = 0.f, h1 = 0.f;
    if constexpr (kBias == kRowSums) {
      if (wr + g < nq) h0 = __ldg(rel_h + (rel_row0 + wr + g) * H + j);
      if (wr + g + 8 < nq) h1 = __ldg(rel_h + (rel_row0 + wr + g + 8) * H + j);
    }
    // S = (q * scale) K^T and dP = dO V^T: the warp's 16 rows x 64 keys
#pragma unroll
    for (int n = 0; n < kT / 8; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    cor::warp_mma_f32<kT / 8, D>(s, sQ, kLd, sK, kLd, wr, lane);
    cor::warp_mma_f32<kT / 8, D>(dp, sDO, kLd, sV, kLd, wr, lane);
    // + the bias (cor_tpu's order); a = exp(l - lse); dl
    float ra[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kT / 8; ++n) {
      float an[2][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float l0, l1;
        if constexpr (kBias == kRowSums) {
          const float2 w0 = *reinterpret_cast<const float2*>(rw0 + n * 8 + 2 * t);
          const float2 w1 = *reinterpret_cast<const float2*>(rw1 + n * 8 + 2 * t);
          l0 = s[n][e] + h0 + (e ? w0.y : w0.x);
          l1 = s[n][2 + e] + h1 + (e ? w1.y : w1.x);
        } else {
          const int key = k0 + n * 8 + 2 * t + e;
          int jh, jw;
          grid_rc(key, W, inv_w, jh, jw);
          const bool in = key < N;
          l0 = in ? s[n][e] + rh0[jh] + rw0[jw] : -INFINITY;
          l1 = in ? s[n][2 + e] + rh1[jh] + rw1[jw] : -INFINITY;
        }
        an[0][e] = expf(l0 - lse_r[0]);  // 0 for a masked key
        an[1][e] = expf(l1 - lse_r[1]);
        s[n][e] = an[0][e] * (dp[n][e] - dlt[0]);  // dl
        s[n][2 + e] = an[1][e] * (dp[n][2 + e] - dlt[1]);
        dp[n][e] = an[0][e];  // dp is spent: a, for kIndicator's sums of a
        dp[n][2 + e] = an[1][e];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        ra[r] += an[r][0] + an[r][1];
        if constexpr (kBias == kRowSums)
          aw[n][r] = __hadd2(aw[n][r], __floats2half2_rn(an[r][0], an[r][1]));
      }
    }
    // the rows' sums of this tile's a and dl
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kT / 8; ++n) {
      rs[0] += s[n][0] + s[n][1];
      rs[1] += s[n][2] + s[n][3];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] = quad_sum(rs[r]);
      ra[r] = quad_sum(ra[r]);
      dl_sum[r] += rs[r];
      a_sum[r] += ra[r];
    }
    // dq += dl K (k-step n: dl's tile n in the permuted order against K's
    // rows 8n + 2t, + 1); the bias gradients
    if constexpr (kBias == kRowSums) {
#pragma unroll
      for (int n = 0; n < kT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) drw[n][e] += s[n][e];
      if (t == 0) {
        if (wr + g < nq) {
          drel_h[(rel_row0 + wr + g) * H + j] = rs[0];
          ah0[j] = ra[0];
        }
        if (wr + g + 8 < nq) {
          drel_h[(rel_row0 + wr + g + 8) * H + j] = rs[1];
          ah1[j] = ra[1];
        }
      }
    }
#pragma unroll
    for (int n = 0; n < kT / 8; ++n) {
      const cor::FragA a = cor::a_from_c_tf32(s[n][0], s[n][1], s[n][2], s[n][3]);
#pragma unroll
      for (int jd = 0; jd < D / 8; ++jd)
        cor::mma_tf32x3(dq[jd], a, cor::load_b_tf32_kn_paired(sK, kLd, n * 8, jd * 8, g, t));
    }
    if constexpr (kBias == kIndicator) {
      // [drel_h | drel_w] += dl [Eh | Ew] over the tile's keys, 32 columns
      // at a time: Eh[key][c] = (key / W == c), Ew[key][c] = (key % W == c),
      // exact in TF32, so two products (dl's small and big halves); the same
      // sums of a in one (a's big half: they only scale the statistics'
      // correction)
      int jh[kT / 8][2], jw[kT / 8][2];
#pragma unroll
      for (int n = 0; n < kT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) grid_rc(k0 + n * 8 + 2 * t + e, W, inv_w, jh[n][e], jw[n][e]);
      for (int c0 = 0; c0 < H + W; c0 += 32) {
        float acc[4][4], acc_a[4][4];
#pragma unroll
        for (int cn = 0; cn < 4; ++cn)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[cn][e] = acc_a[cn][e] = 0.f;
#pragma unroll
        for (int n = 0; n < kT / 8; ++n) {
          const cor::FragA a = cor::a_from_c_tf32(s[n][0], s[n][1], s[n][2], s[n][3]);
          const cor::FragA pa = cor::a_from_c_tf32(dp[n][0], dp[n][1], dp[n][2], dp[n][3]);
#pragma unroll
          for (int cn = 0; cn < 4; ++cn) {
            const int c = c0 + cn * 8 + g;
            uint32_t e01[2];
#pragma unroll
            for (int e = 0; e < 2; ++e)
              e01[e] = (c < H ? jh[n][e] == c : jw[n][e] == c - H) ? 0x3f800000u : 0u;
            // each k-step's sum from zero on the tensor cores, the running
            // sum on the CUDA cores (rounded to nearest: a sum kept inside
            // the tensor cores loses more, PERF.md §7)
            float part[4] = {0.f, 0.f, 0.f, 0.f};
            cor::mma_tf32_1688(part, a.small, e01[0], e01[1]);
            cor::mma_tf32_1688(part, a.big, e01[0], e01[1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[cn][e] += part[e];
            cor::mma_tf32_1688(acc_a[cn], pa.big, e01[0], e01[1]);
          }
        }
        // each element of the warp's rows belongs to one lane: no atomics
#pragma unroll
        for (int cn = 0; cn < 4; ++cn) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = c0 + cn * 8 + 2 * t + (e & 1);
            if (c < H + W) {
              sAcc[(wr + g + 8 * (e >> 1)) * hw_ld + c] += acc[cn][e];
              sAccA[(wr + g + 8 * (e >> 1)) * hw_ld + c] += acc_a[cn][e];
            }
          }
        }
      }
    }
    __syncthreads();  // stage j % 2 consumed: tile j + 2 may land there
  }

  // The statistics' correction. The fp32 statistics are off by the
  // forward's fp32 error: lse by a rounding of ~9 (a row's a sums to 1 + e),
  // delta = rowsum(do * out) by out's error. This pass saw every key of its
  // rows, and dl sums to 0 over a row, so its own sums fix both: a / a_sum is
  // the softmax, and eps = dl_sum / a_sum is rowsum(a * da) / a_sum - delta.
  // dq and the bias gradients are divided by a_sum, the bias gradients take
  // -eps times their sums of a, and the dk/dv pass reads lse + log(a_sum)
  // and delta + eps (dq keeps its eps term: its error is the products').
  float eps[2], inv_a[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    eps[r] = dl_sum[r] / a_sum[r];
    inv_a[r] = 1.f / a_sum[r];
  }
  const int ra = q0 + wr + g, rb = ra + 8;
  if (t == 0) {
    if (ra < N) {
      delta[rel_row0 + wr + g] = dlt[0] + eps[0];
      lse_c[rel_row0 + wr + g] = lse_r[0] + logf(a_sum[0]);
    }
    if (rb < N) {
      delta[rel_row0 + wr + g + 8] = dlt[1] + eps[1];
      lse_c[rel_row0 + wr + g + 8] = lse_r[1] + logf(a_sum[1]);
    }
  }
  // dq * scale -> the q third of dqkv; the bias gradients -> drel_h, drel_w
  float* dq_out = dqkv + static_cast<int64_t>(b) * N * row_stride + h * D + 2 * t;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (ra < N)
      *reinterpret_cast<float2*>(dq_out + ra * row_stride + n * 8) =
          make_float2(dq[n][0] * inv_a[0] * scale, dq[n][1] * inv_a[0] * scale);
    if (rb < N)
      *reinterpret_cast<float2*>(dq_out + rb * row_stride + n * 8) =
          make_float2(dq[n][2] * inv_a[1] * scale, dq[n][3] * inv_a[1] * scale);
  }
  if constexpr (kBias == kRowSums) {
#pragma unroll
    for (int n = 0; n < kT / 8; ++n) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 a2 = __half22float2(aw[n][r]);
        drw[n][2 * r] = (drw[n][2 * r] - eps[r] * a2.x) * inv_a[r];
        drw[n][2 * r + 1] = (drw[n][2 * r + 1] - eps[r] * a2.y) * inv_a[r];
      }
    }
    __syncwarp();  // lane t == 0's tile sums, before the quad's lanes read them
    for (int j = t; j < tiles; j += 4) {
      if (ra < N) {
        float* p = drel_h + (rel_row0 + wr + g) * H + j;
        *p = (*p - eps[0] * ah0[j]) * inv_a[0];
      }
      if (rb < N) {
        float* p = drel_h + (rel_row0 + wr + g + 8) * H + j;
        *p = (*p - eps[1] * ah1[j]) * inv_a[1];
      }
    }
    float* dw = drel_w + (rel_row0 + wr + g) * W + 2 * t;
#pragma unroll
    for (int n = 0; n < kT / 8; ++n) {
      if (ra < N) *reinterpret_cast<float2*>(dw + n * 8) = make_float2(drw[n][0], drw[n][1]);
      if (rb < N)
        *reinterpret_cast<float2*>(dw + 8 * W + n * 8) = make_float2(drw[n][2], drw[n][3]);
    }
  } else {
    // each warp wrote only its own rows of sAcc and sAccA; a row's 1 / a_sum
    // and eps go in their pad columns (hw_ld - 1 >= H + W)
    if (t == 0) {
      sAcc[(wr + g) * hw_ld + hw_ld - 1] = inv_a[0];
      sAcc[(wr + g + 8) * hw_ld + hw_ld - 1] = inv_a[1];
      sAccA[(wr + g) * hw_ld + hw_ld - 1] = eps[0];
      sAccA[(wr + g + 8) * hw_ld + hw_ld - 1] = eps[1];
    }
    __syncwarp();
    for (int i = lane; i < 16 * (H + W); i += 32) {
      const int r = wr + i / (H + W), c = i % (H + W);
      if (r >= nq) continue;
      const float* acc = sAcc + r * hw_ld;
      const float* acc_a = sAccA + r * hw_ld;
      const float v = (acc[c] - acc_a[hw_ld - 1] * acc_a[c]) * acc[hw_ld - 1];
      if (c < H) drel_h[(rel_row0 + r) * H + c] = v;
      else drel_w[(rel_row0 + r) * W + c - H] = v;
    }
  }
}

// The dk/dv pass: one block per (64 groups keys, head, image), 4 groups
// warps sharing each query tile of the ring.
template <int D>
__global__ void __launch_bounds__(kGroupsF32 * 128)
vit_attention_bwd_dkv_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ rel_h,
                                 const float* __restrict__ rel_w, const float* __restrict__ dout,
                                 const float* __restrict__ lse, const float* __restrict__ delta,
                                 float* __restrict__ dqkv, int N, int C, int H, int W,
                                 float scale) {
  constexpr int kLd = F32<D>::kLd, kTile = F32<D>::kTile, kCh = F32<D>::kChunks;
  const int threads = blockDim.x;
  const int keys = threads / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);  // [key][d]
  float* sV = sK + keys * kLd;                  // [key][d]
  float* sStage = sV + keys * kLd;
  const int rh_ld = DkvPlan<D>::rh_ld(keys, H, W);
  const int stage_floats = DkvPlan<D>::stage_floats(keys, H, W);
  // stage s: Q * scale, dO [query][d]; rel_w [query][kLdwK]; the rel_h
  // columns jh_lo .. of the block's keys [query][rh_ld]; lse, delta
  auto st_q = [&](int s) { return sStage + s * stage_floats; };

  const int k0 = blockIdx.x * keys;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int heads = gridDim.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp * 16;
  const int tiles = (N + kT - 1) / kT;
  const int64_t row_stride = 3LL * C;
  const float* base = qkv + static_cast<int64_t>(b) * N * row_stride + h * D;
  const float* dbase = dout + static_cast<int64_t>(b) * N * C + h * D;
  const int64_t rel0 = (static_cast<int64_t>(b) * heads + h) * N;
  const int jh_lo = k0 / W;
  const int rh_cols = min(DkvPlan<D>::rh_cols(keys, H, W), H - jh_lo);

  // the tiles of query tile j into stage s (one cp.async group)
  auto issue = [&](int j, int s) {
    float* q = st_q(s);
    const int q0 = j * kT, nq = min(kT, N - q0);
    copy_tile_f32<D>(q, base, row_stride, q0, N, tid, threads);
    copy_tile_f32<D>(q + kTile, dbase, C, q0, N, tid, threads);
    copy_rows_f32(q + 2 * kTile, kLdwK, rel_w + (rel0 + q0) * W, W, kT, W, nq, tid, threads);
    copy_rows_f32(q + 2 * kTile + kT * kLdwK, rh_ld, rel_h + (rel0 + q0) * H + jh_lo, H, kT,
                  rh_cols, nq, tid, threads);
    float* sl = q + 2 * kTile + kT * kLdwK + kT * rh_ld;
    copy_rows_f32(sl, 1, lse + rel0 + q0, 1, kT, 1, nq, tid, threads);
    copy_rows_f32(sl + kT, 1, delta + rel0 + q0, 1, kT, 1, nq, tid, threads);
  };
  for (int r = 0; r < keys; r += kT) {
    copy_tile_f32<D>(sK + r * kLd, base + C, row_stride, k0 + r, N, tid, threads);
    copy_tile_f32<D>(sV + r * kLd, base + 2 * C, row_stride, k0 + r, N, tid, threads);
  }
  issue(0, 0);
  cor::cp_async_commit();

  // this lane's two keys (rows g and g + 8 of the warp) and their grid
  // (row - jh_lo, column); keys >= N are masked and read column 0
  int key[2], jh[2], jw[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key[r] = k0 + wr + g + 8 * r;
    jh[r] = key[r] < N ? key[r] / W : jh_lo;
    jw[r] = key[r] < N ? key[r] - jh[r] * W : 0;
    jh[r] -= jh_lo;
  }
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;

  float s[kT / 8][4], dp[kT / 8][4];
  for (int j = 0; j < tiles; ++j) {
    const int st = j % kStagesF32;
    if (j + 1 < tiles) issue(j + 1, (j + 1) % kStagesF32);
    cor::cp_async_commit();
    cor::cp_async_wait<1>();  // tile j (and, at j = 0, K and V) landed
    float* sQ = st_q(st);
    // q * scale in place: each thread scales the chunks it copied itself
    for (int i = tid; i < kT * kCh; i += threads) {
      float4* p = reinterpret_cast<float4*>(sQ + (i / kCh) * kLd + (i % kCh) * 4);
      const float4 v = *p;
      *p = make_float4(v.x * scale, v.y * scale, v.z * scale, v.w * scale);
    }
    __syncthreads();
    const float* sDO = sQ + kTile;
    const float* sRw = sQ + 2 * kTile;
    const float* sRh = sRw + kT * kLdwK;
    const float* sl = sRh + kT * rh_ld;
    const int q0 = j * kT;
    // S^T = K (q * scale)^T and dP^T = V dO^T: the warp's 16 keys x 64 queries
#pragma unroll
    for (int n = 0; n < kT / 8; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    cor::warp_mma_f32<kT / 8, D>(s, sK, kLd, sQ, kLd, wr, lane);
    cor::warp_mma_f32<kT / 8, D>(dp, sV, kLd, sDO, kLd, wr, lane);
#pragma unroll
    for (int n = 0; n < kT / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int qi = n * 8 + 2 * t + (e & 1);
        const bool in = q0 + qi < N && key[r] < N;
        const float l = s[n][e] + sRh[qi * rh_ld + jh[r]] + sRw[qi * kLdwK + jw[r]];
        const float a = in ? expf(l - sl[qi]) : 0.f;
        s[n][e] = a;
        dp[n][e] = a * (dp[n][e] - sl[kT + qi]);  // dl
      }
    }
    // dV += a^T dO, dK += dl^T (q * scale): the contraction over the tile's
    // queries, accumulator tile n as the k-step in the permuted order
    mma_acc_f32<D>(dv, s, sDO, g, t);
    mma_acc_f32<D>(dk, dp, sQ, g, t);
    __syncthreads();  // stage st consumed: tile j + 2 may land there
  }

  float* out = dqkv + static_cast<int64_t>(b) * N * row_stride + h * D + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= N) continue;
    float* row = out + static_cast<int64_t>(key[r]) * row_stride;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(row + C + n * 8) = make_float2(dk[n][2 * r], dk[n][2 * r + 1]);
      *reinterpret_cast<float2*>(row + 2 * C + n * 8) =
          make_float2(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

template <int D>
int launch_f32(const void* qkv, const void* rel_h, const void* rel_w, const void* dout,
               const void* out, const void* lse, void* dqkv, void* drel_h, void* drel_w,
               void* stats, int B, int N, int C, int num_heads, int H, int W, float scale,
               void* stream) {
  if (C > cor::k6b::kMaxC || out == nullptr || lse == nullptr) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* delta = static_cast<float*>(stats);
  const float* q = static_cast<const float*>(qkv);
  const float* rh = static_cast<const float*>(rel_h);
  const float* rw = static_cast<const float*>(rel_w);
  const float* d = static_cast<const float*>(dout);
  const float* l = static_cast<const float*>(lse);
  float* dq = static_cast<float*>(dqkv);
  vit_attention_bwd_prep_f32_kernel<D><<<static_cast<unsigned>(B) * N, kPrepThreads, 0, st>>>(
      d, static_cast<const float*>(out), delta, N, C, num_heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int bias = W == kT ? kRowSums : kIndicator;
  int groups = kGroupsF32;
  if (DqPlan<D>::bytes(groups, H, W, bias) > kMaxSmem) groups = 1;
  const int dq_smem = DqPlan<D>::bytes(groups, H, W, bias);
  auto dq_kernel = bias == kRowSums ? vit_attention_bwd_dq_f32_kernel<D, kRowSums>
                                    : vit_attention_bwd_dq_f32_kernel<D, kIndicator>;
  static int raised_dq[2][cor::wg::kMaxDevices], raised_dkv[cor::wg::kMaxDevices];
  err = cor::wg::raise_shared_memory(reinterpret_cast<const void*>(dq_kernel), dq_smem,
                                     raised_dq[bias == kRowSums ? 0 : 1]);
  if (err != cudaSuccess) return err;
  const dim3 grid_dq((N + 64 * groups - 1) / (64 * groups), num_heads, B);
  float* lse_c = delta + static_cast<int64_t>(B) * num_heads * N;
  dq_kernel<<<grid_dq, groups * 128, dq_smem, st>>>(q, rh, rw, d, l, delta, lse_c, dq,
                                                    static_cast<float*>(drel_h),
                                                    static_cast<float*>(drel_w), N, C, H, W,
                                                    scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  groups = DkvPlan<D>::bytes(kGroupsF32, H, W) <= kMaxSmem ? kGroupsF32 : 1;
  const int dkv_smem = DkvPlan<D>::bytes(groups, H, W);
  err = cor::wg::raise_shared_memory(
      reinterpret_cast<const void*>(vit_attention_bwd_dkv_f32_kernel<D>), dkv_smem, raised_dkv);
  if (err != cudaSuccess) return err;
  const dim3 grid_dkv((N + 64 * groups - 1) / (64 * groups), num_heads, B);
  vit_attention_bwd_dkv_f32_kernel<D><<<grid_dkv, groups * 128, dkv_smem, st>>>(
      q, rh, rw, d, lse_c, delta, dq, N, C, H, W, scale);
  return cudaGetLastError();
}

}  // namespace

// qkv: [B, N, 3C] bf16 (f32 = 0) or fp32 (f32 = 1) contiguous, 16-byte
// aligned, C = num_heads * D with D in {64, 80}; rel_h [B, num_heads, N, H],
// rel_w [B, num_heads, N, W] contiguous, N = H * W, H and W <= 64; dout
// [B, N, C] contiguous, 16-byte aligned; all of one type. scale: D^-1/2.
// Both dtypes also take the forward's out [B, N, C] (of qkv's type, 16-byte
// aligned) and lse [B, num_heads, N] fp32 (K6's row log-sum-exp); C <= 4096.
// Writes dqkv [B, N, 3C], drel_h, drel_w (of that type, the shapes of their
// inputs) and uses stats, fp32 scratch: bf16, delta and bf16(q * scale)
// (cor::k6b::qs_offset_floats(B * num_heads * N) floats, then B * N * C
// bf16); fp32, delta and the dq pass's corrected lse (2 * B * num_heads * N
// floats). Returns the launches' cudaError_t
// (cudaErrorInvalidValue for shapes the kernels do not take or a call
// without out and lse; a refused shared-memory size or launch as the
// runtime reports it).
extern "C" int cor_vit_attention_relpos_bwd(const void* qkv, const void* rel_h, const void* rel_w,
                                            const void* dout, const void* out, const void* lse,
                                            void* dqkv, void* drel_h, void* drel_w, void* stats,
                                            int B, int N, int C, int num_heads, int H, int W,
                                            float scale, int f32, void* stream) {
  if (B < 1 || N < 1 || num_heads < 1 || C % num_heads != 0 || B > 65535 ||
      num_heads > 65535 || H < 1 || W < 1 || H > kMaxSide || W > kMaxSide || H * W != N)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C / num_heads) {
    case 64:
      if (!f32)
        return cor::k6b::launch_bf16_d64(qkv, rel_h, rel_w, dout, out, lse, dqkv, drel_h, drel_w,
                                         stats, B, N, C, num_heads, H, W, scale, st);
      return launch_f32<64>(qkv, rel_h, rel_w, dout, out, lse, dqkv, drel_h, drel_w, stats, B, N,
                            C, num_heads, H, W, scale, stream);
    case 80:
      if (!f32)
        return cor::k6b::launch_bf16_d80(qkv, rel_h, rel_w, dout, out, lse, dqkv, drel_h, drel_w,
                                         stats, B, N, C, num_heads, H, W, scale, st);
      return launch_f32<80>(qkv, rel_h, rel_w, dout, out, lse, dqkv, drel_h, drel_w, stats, B, N,
                            C, num_heads, H, W, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
