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
// fp32 (compute_dtype float32): vit_attention_bwd_{dq,dkv}_f32_kernel<D>,
// the first design, on fp32 operands. Blocks of 4 warps, each owning 16
// rows. The dq pass sweeps the key tiles twice: once for each row's max,
// exp-sum and delta (exactly, as the sum of a * da) online, which it writes
// for the second pass, then again for a and dl per tile, dq += dl k, and
// the bias gradients, each lane folding one (row, rel_h or rel_w) over the
// tile from shared memory. The dk/dv pass recomputes the transposed logits
// K Q^T and da^T = V dO^T per query tile. Nine products where the gradient
// needs five, in 3xTF32 on mma.sync m16n8k8 (mma_tf32x3.cuh): fp32 accuracy
// at three TF32 products per fp32 one. Rounding points are cor_tpu's in
// fp32, so nothing is rounded: q * scale, a and dl enter their products as
// they are. Tiles [token][d] take a row stride of D + 4 words (68 / 84:
// 4 mod 8, conflict-free TF32 fragments) and no tile is transposed: the
// products whose contraction runs over tokens (dl K in pass 1; a^T dO and
// dl^T Q in pass 2) read their accumulator tiles as A operands in the
// permuted k order of mma_tf32x3.cuh and B ([token][d]) in the same order.
// The A fragments of Q, dO, K and V are read from shared memory at each use,
// not held in registers (their TF32 halves at D = 80 alone would take 160).
// The bias rows are fp32 [64][68]. Dynamic shared memory: pass 1 holds sQ,
// sDO, sK, sV, the bias rows and the three [64][65] fp32 tiles: 154,368
// bytes at D = 64, 170,752 at 80 (one block per SM); pass 2 sK, sV, sQ, sDO,
// the bias rows and 512 bytes: 104,960 and 121,344 (two blocks per SM at 64,
// one at 80). What bounds it: operations, at a third of the bf16 rate.

#include "decoder_common.cuh"
#include "mma_tf32x3.cuh"
#include "vit_attention_bwd_wgmma.cuh"

namespace {

using cor::k6b::bias_log2;
using cor::k6b::kLog2e;
using cor::k6b::kMaxSide;
using cor::k6b::kT;
using cor::quad_sum;

constexpr int kLdf = kT + 1;   // fp32 row stride of the dl tile and bias gradients
constexpr int kThreads = 128;  // 4 warps

// The bias rows [q0, q0 + 64) of one (image, head): rel [., N, K] of the
// element type T -> sR [row][kLd], rows >= N zero.
template <typename T, int kLd>
__device__ __forceinline__ void stage_bias(T* sR, const T* rel, int64_t row0, int q0, int N,
                                           int K, int tid) {
  for (int i = tid; i < kT * K; i += kThreads) {
    const int r = i / K, c = i % K;
    sR[r * kLd + c] = q0 + r < N ? rel[(row0 + r) * K + c] : T(0);
  }
}

// ---------------------------------------------------------------------------
// fp32: the first design's two passes on fp32 operands, products in 3xTF32
// ---------------------------------------------------------------------------

constexpr int kLdrF = kMaxSide + 4;  // fp32 bias rows: 68 words, 4 mod 8

template <int D>
struct HeadDimF32 {
  static_assert(D % 8 == 0, "the products run in k-steps of 8");
  static constexpr int kLd = D + 4;  // row stride of a [token][d] tile: 4 mod 8 words
  static constexpr int kTile = kT * kLd;
  static constexpr size_t kSmemDq = (4 * kTile + 2 * kT * kLdrF + 3 * kT * kLdf) * sizeof(float);
  static constexpr size_t kSmemDkv = (4 * kTile + 2 * kT * kLdrF + 2 * kT) * sizeof(float);
};

// Rows [r0, r0 + 64) of a [., stride] fp32 matrix, D columns from src -> s
// [row][D + 4]; rows >= N are zeros; with kScale each value times scale.
template <int D, bool kScale>
__device__ __forceinline__ void stage_tile_f32(float* s, const float* src, int64_t stride, int r0,
                                               int N, float scale, int tid) {
  constexpr int kLd = HeadDimF32<D>::kLd;
  for (int i = tid; i < kT * (D / 4); i += kThreads) {
    const int r = i / (D / 4);
    const int c4 = (i % (D / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < N) {
      v = *reinterpret_cast<const float4*>(src + (r0 + r) * stride + c4);
      if (kScale) v = make_float4(v.x * scale, v.y * scale, v.z * scale, v.w * scale);
    }
    *reinterpret_cast<float4*>(&s[r * kLd + c4]) = v;
  }
}

// acc = this warp's 16 rows of sA times the 64 rows of sB, transposed, over
// the D-wide contraction (both [token][D + 4] fp32)
template <int D>
__device__ __forceinline__ void mma_rows_f32(float (&acc)[kT / 8][4], const float* sA,
                                             const float* sB, int row0, int lane) {
#pragma unroll
  for (int n = 0; n < kT / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  cor::warp_mma_f32<kT / 8, D>(acc, sA, HeadDimF32<D>::kLd, sB, HeadDimF32<D>::kLd, row0, lane);
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
      cor::mma_tf32x3(acc[j], a,
                      cor::load_b_tf32_kn_paired(sB, HeadDimF32<D>::kLd, n * 8, j * 8, g, t));
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
vit_attention_bwd_dq_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ rel_h,
                                const float* __restrict__ rel_w, const float* __restrict__ dout,
                                float* __restrict__ dqkv, float* __restrict__ drel_h,
                                float* __restrict__ drel_w, float* __restrict__ lse,
                                float* __restrict__ delta, int N, int C, int H, int W,
                                float scale) {
  constexpr int kTile = HeadDimF32<D>::kTile;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);  // [query][d], q * scale
  float* sDO = sQ + kTile;                      // [query][d]
  float* sK = sDO + kTile;                      // [key][d]
  float* sV = sK + kTile;                       // [key][d]
  float* sRh = sV + kTile;                      // [query][key grid row]
  float* sRw = sRh + kT * kLdrF;                // [query][key grid column]
  float* sDl = sRw + kT * kLdrF;                // [query][key] dl
  float* sDrh = sDl + kT * kLdf;                // [query][key grid row]
  float* sDrw = sDrh + kT * kLdf;               // [query][key grid column]

  const int q0 = blockIdx.x * kT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int heads = gridDim.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp * 16;
  const int64_t row_stride = 3LL * C;
  const float* base = qkv + static_cast<int64_t>(b) * N * row_stride + h * D;
  const int64_t rel_row0 = (static_cast<int64_t>(b) * heads + h) * N + q0;

  stage_tile_f32<D, true>(sQ, base, row_stride, q0, N, scale, tid);
  stage_tile_f32<D, false>(sDO, dout + static_cast<int64_t>(b) * N * C + h * D, C, q0, N, 0.f,
                           tid);
  stage_bias<float, kLdrF>(sRh, rel_h, rel_row0, q0, N, H, tid);
  stage_bias<float, kLdrF>(sRw, rel_w, rel_row0, q0, N, W, tid);
  for (int i = tid; i < 2 * kT * kLdf; i += kThreads) sDrh[i] = 0.f;  // sDrh and sDrw

  const float* rh0 = sRh + (wr + g) * kLdrF;
  const float* rw0 = sRw + (wr + g) * kLdrF;
  const float* rh1 = rh0 + 8 * kLdrF;
  const float* rw1 = rw0 + 8 * kLdrF;

  // sweep 1: each row's max, exp-sum and delta, online (log2 domain)
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float d_run[2] = {0.f, 0.f};
  float s[kT / 8][4], da[kT / 8][4];
  for (int k0 = 0; k0 < N; k0 += kT) {
    __syncthreads();  // the previous K/V tiles are fully consumed (the first: Q, dO staged)
    stage_tile_f32<D, false>(sK, base + C, row_stride, k0, N, 0.f, tid);
    stage_tile_f32<D, false>(sV, base + 2 * C, row_stride, k0, N, 0.f, tid);
    __syncthreads();
    mma_rows_f32<D>(s, sQ, sK, wr, lane);
    mma_rows_f32<D>(da, sDO, sV, wr, lane);
    bias_log2(s, rh0, rw0, rh1, rw1, k0, t, N, W);
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kT / 8; ++n) {
      mt[0] = fmaxf(mt[0], fmaxf(s[n][0], s[n][1]));
      mt[1] = fmaxf(mt[1], fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m_run[r], mt[r]);
      const float alpha = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha;
      d_run[r] *= alpha;
    }
#pragma unroll
    for (int n = 0; n < kT / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m_run[e >> 1]);
        l_run[e >> 1] += p;
        d_run[e >> 1] += p * da[n][e];
      }
    }
  }
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_run[r]);
    dlt[r] = quad_sum(d_run[r]) / l;
    lse2[r] = m_run[r] + log2f(l);
    const int row = q0 + wr + g + 8 * r;
    if (t == 0 && row < N) {
      const int64_t at = (static_cast<int64_t>(b) * heads + h) * N + row;
      lse[at] = lse2[r];
      delta[at] = dlt[r];
    }
  }

  // sweep 2: a and dl per tile; dq += dl K on the tensor cores, the bias
  // gradients from shared memory
  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  float* dl_r0 = sDl + (wr + g) * kLdf;
  float* dl_r1 = dl_r0 + 8 * kLdf;
  const int my_row = wr + (lane & 15);
  const bool my_h = lane < 16;
  float* my_acc = (my_h ? sDrh : sDrw) + my_row * kLdf;
  const float* my_dl = sDl + my_row * kLdf;
  for (int k0 = 0; k0 < N; k0 += kT) {
    __syncthreads();
    stage_tile_f32<D, false>(sK, base + C, row_stride, k0, N, 0.f, tid);
    stage_tile_f32<D, false>(sV, base + 2 * C, row_stride, k0, N, 0.f, tid);
    __syncthreads();
    mma_rows_f32<D>(s, sQ, sK, wr, lane);
    mma_rows_f32<D>(da, sDO, sV, wr, lane);
    bias_log2(s, rh0, rw0, rh1, rw1, k0, t, N, W);
#pragma unroll
    for (int n = 0; n < kT / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float a = exp2f(s[n][e] - lse2[e >> 1]);  // 0 for a masked key
        s[n][e] = a * (da[n][e] - dlt[e >> 1]);         // dl
      }
      dl_r0[n * 8 + 2 * t] = s[n][0];
      dl_r0[n * 8 + 2 * t + 1] = s[n][1];
      dl_r1[n * 8 + 2 * t] = s[n][2];
      dl_r1[n * 8 + 2 * t + 1] = s[n][3];
    }
    mma_acc_f32<D>(dq, s, sK, g, t);
    __syncwarp();
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

  // dq * scale -> the q third of dqkv; the bias gradients -> drel_h, drel_w
  float* dq_out = dqkv + static_cast<int64_t>(b) * N * row_stride + h * D + 2 * t;
  const int ra = q0 + wr + g, rb = ra + 8;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (ra < N)
      *reinterpret_cast<float2*>(dq_out + ra * row_stride + n * 8) =
          make_float2(dq[n][0] * scale, dq[n][1] * scale);
    if (rb < N)
      *reinterpret_cast<float2*>(dq_out + rb * row_stride + n * 8) =
          make_float2(dq[n][2] * scale, dq[n][3] * scale);
  }
  for (int i = lane; i < 16 * H; i += 32) {
    const int r = wr + i / H, c = i % H;
    if (q0 + r < N) drel_h[(rel_row0 + r) * H + c] = sDrh[r * kLdf + c];
  }
  for (int i = lane; i < 16 * W; i += 32) {
    const int r = wr + i / W, c = i % W;
    if (q0 + r < N) drel_w[(rel_row0 + r) * W + c] = sDrw[r * kLdf + c];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
vit_attention_bwd_dkv_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ rel_h,
                                 const float* __restrict__ rel_w, const float* __restrict__ dout,
                                 const float* __restrict__ lse, const float* __restrict__ delta,
                                 float* __restrict__ dqkv, int N, int C, int H, int W,
                                 float scale) {
  constexpr int kTile = HeadDimF32<D>::kTile;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);  // [key][d]
  float* sV = sK + kTile;                       // [key][d]
  float* sQ = sV + kTile;                       // [query][d], q * scale
  float* sDO = sQ + kTile;                      // [query][d]
  float* sRh = sDO + kTile;                     // [query][key grid row]
  float* sRw = sRh + kT * kLdrF;                // [query][key grid column]
  float* sLse = sRw + kT * kLdrF;
  float* sDelta = sLse + kT;

  const int k0 = blockIdx.x * kT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int heads = gridDim.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wr = warp * 16;
  const int64_t row_stride = 3LL * C;
  const float* base = qkv + static_cast<int64_t>(b) * N * row_stride + h * D;
  const float* dbase = dout + static_cast<int64_t>(b) * N * C + h * D;
  const int64_t rel0 = (static_cast<int64_t>(b) * heads + h) * N;

  stage_tile_f32<D, false>(sK, base + C, row_stride, k0, N, 0.f, tid);
  stage_tile_f32<D, false>(sV, base + 2 * C, row_stride, k0, N, 0.f, tid);
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
  float s[kT / 8][4], da[kT / 8][4];
  for (int q0 = 0; q0 < N; q0 += kT) {
    __syncthreads();  // the previous query tiles are fully consumed
    stage_tile_f32<D, true>(sQ, base, row_stride, q0, N, scale, tid);
    stage_tile_f32<D, false>(sDO, dbase, C, q0, N, 0.f, tid);
    stage_bias<float, kLdrF>(sRh, rel_h, rel0 + q0, q0, N, H, tid);
    stage_bias<float, kLdrF>(sRw, rel_w, rel0 + q0, q0, N, W, tid);
    for (int i = tid; i < kT; i += kThreads) {
      const bool in = q0 + i < N;
      sLse[i] = in ? lse[rel0 + q0 + i] : 0.f;
      sDelta[i] = in ? delta[rel0 + q0 + i] : 0.f;
    }
    __syncthreads();
    mma_rows_f32<D>(s, sK, sQ, wr, lane);    // S^T: this warp's keys x the tile's queries
    mma_rows_f32<D>(da, sV, sDO, wr, lane);  // da^T
#pragma unroll
    for (int n = 0; n < kT / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int qi = n * 8 + 2 * t + (e & 1);
        const bool in = q0 + qi < N && key[r] < N;
        const float l2 = (s[n][e] + sRh[qi * kLdrF + jh[r]] + sRw[qi * kLdrF + jw[r]]) * kLog2e;
        const float a = in ? exp2f(l2 - sLse[qi]) : 0.f;
        s[n][e] = a;
        da[n][e] = a * (da[n][e] - sDelta[qi]);  // dl
      }
    }
    mma_acc_f32<D>(dv, s, sDO, g, t);
    mma_acc_f32<D>(dk, da, sQ, g, t);
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
               void* dqkv, void* drel_h, void* drel_w, void* stats, int B, int N, int C,
               int num_heads, int H, int W, float scale, void* stream) {
  constexpr size_t smem_dq = HeadDimF32<D>::kSmemDq, smem_dkv = HeadDimF32<D>::kSmemDkv;
  cudaError_t err = cudaFuncSetAttribute(
      vit_attention_bwd_dq_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(vit_attention_bwd_dkv_f32_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkv);
  if (err != cudaSuccess) return err;
  float* lse = static_cast<float*>(stats);
  float* delta = lse + static_cast<int64_t>(B) * num_heads * N;
  const dim3 grid((N + kT - 1) / kT, num_heads, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* q = static_cast<const float*>(qkv);
  const float* rh = static_cast<const float*>(rel_h);
  const float* rw = static_cast<const float*>(rel_w);
  const float* d = static_cast<const float*>(dout);
  float* dq = static_cast<float*>(dqkv);
  vit_attention_bwd_dq_f32_kernel<D><<<grid, kThreads, smem_dq, st>>>(
      q, rh, rw, d, dq, static_cast<float*>(drel_h), static_cast<float*>(drel_w), lse, delta, N,
      C, H, W, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  vit_attention_bwd_dkv_f32_kernel<D><<<grid, kThreads, smem_dkv, st>>>(
      q, rh, rw, d, lse, delta, dq, N, C, H, W, scale);
  return cudaGetLastError();
}

}  // namespace

// qkv: [B, N, 3C] bf16 (f32 = 0) or fp32 (f32 = 1) contiguous, 16-byte
// aligned, C = num_heads * D with D in {64, 80}; rel_h [B, num_heads, N, H],
// rel_w [B, num_heads, N, W] contiguous, N = H * W, H and W <= 64; dout
// [B, N, C] contiguous, 16-byte aligned; all of one type. scale: D^-1/2.
// bf16 also takes the forward's out [B, N, C] (16-byte aligned) and lse
// [B, num_heads, N] fp32 (K6's row log-sum-exp); fp32 ignores them (null
// allowed). Writes dqkv [B, N, 3C], drel_h, drel_w (of that type, the shapes
// of their inputs) and uses stats, fp32 scratch: bf16, delta and bf16(q *
// scale) (cor::k6b::qs_offset_floats(B * num_heads * N) floats, then
// B * N * C bf16; C <= 4096); fp32, the rows' log-sum-exp and delta (2 * B *
// num_heads * N). Returns the launches' cudaError_t (cudaErrorInvalidValue
// for shapes the kernels do not take or a bf16 call without out and lse; a
// refused shared-memory size or launch as the runtime reports it).
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
      return launch_f32<64>(qkv, rel_h, rel_w, dout, dqkv, drel_h, drel_w, stats, B, N, C,
                            num_heads, H, W, scale, stream);
    case 80:
      if (!f32)
        return cor::k6b::launch_bf16_d80(qkv, rel_h, rel_w, dout, out, lse, dqkv, drel_h, drel_w,
                                         stats, B, N, C, num_heads, H, W, scale, st);
      return launch_f32<80>(qkv, rel_h, rel_w, dout, dqkv, drel_h, drel_w, stats, B, N, C,
                            num_heads, H, W, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
