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
// logits are recomputed in 64 x 64 tiles and never reach memory, in two
// launches and with no atomics:
//  1. the dq pass: one block of 4 warps per (64-query tile, head, image);
//     each warp owns 16 query rows. A first sweep over the key tiles takes
//     each row's max, exp-sum and delta online (delta exactly, as the fp32
//     sum of a * da, not as rowsum(do * o)); it writes the row's log-sum-exp
//     and delta for pass 2. A second sweep recomputes a and dl per tile,
//     accumulates dq += bf16(dl) k on the tensor cores, and folds bf16(dl)
//     into the bias gradients, each lane summing one (row, rel_h or rel_w)
//     over the tile from shared memory: fp32, deterministic, in shared
//     memory ([64][H] + [64][W] fp32);
//  2. the dk/dv pass: one block per (64-key tile, head, image); each warp
//     owns 16 keys and sweeps the query tiles, recomputing the transposed
//     logits K Q^T and da^T = V dO^T, then a and dl from pass 1's row
//     statistics, and accumulates dv += bf16(a)^T do and dk += bf16(dl)^T
//     bf16(q * scale) in fp32, rounded once at the end.
// Rounding points are the TPU kernel's: q * scale in bf16; logits, a, da and
// dl in fp32; a and dl rounded to bf16 before their products; dq, dk, dv
// and the bias gradients summed in fp32 and rounded once. (The TPU kernel
// shifts its keys by their column mean; rowsum(dl) = 0 makes the shift
// vanish from every gradient, so none is applied.) Keys j >= N (the tail of
// the last tile: 196 = 3 * 64 + 4) and queries i >= N are masked.
//
// What bounds it on the H100: per (image, head) the two passes run nine
// N x N x D products (pass 1: S and da twice, dq; pass 2: S, da, dv, dk)
// against the five the gradient needs, on ~(3 N D + 2 N 64 + N D) * 2 bytes
// in and the same out: at N = 4096 far above the card's ~295 flop/byte
// ridge, bound by operations; a 14 x 14 window (N = 196) by bytes. mma.sync
// m16n8k16 (bf16 in, fp32 accumulate) as in K6; wgmma, TMA and the forward's
// log-sum-exp saved in place of pass 1's first sweep are left for later.
//
// Templated on the head_dim D, as K6 is: 64 (SAM-base, SAM-large) and 80
// (sam_huge; scale 80^-1/2). D sets the contraction of the logits (D / 16
// k-steps) and the width of dq, dk and dv (D / 8 n-tiles); the token side of
// every tile stays 64. Tiles [token][d] take a row stride of 72 bf16 at
// D = 64 and 88 at D = 80, K6's choice (a row of 80 bf16, 40 words, would
// put fragment rows g and g + 4 on one bank; 44 words do not); the
// transposed tiles [d][token] keep 72.
// Shared memory, dynamic, raised per instantiation: pass 1 holds four
// [64][ld] tiles (sQ, sDO, sK, sV), the transposed sKt [D][72], the two bias
// tiles [64][72] and three [64][65] fp32 tiles: 114,432 bytes at 64,
// 124,928 at 80 (two blocks fit on an SM at 64, one at 80); pass 2 four
// [64][ld] tiles (sK, sV, sQ, sDO), two transposed (sQt, sDOt) [D][72], the
// bias tiles and 512 bytes of fp32: 74,240 and 87,040 bytes. At D = 64 the
// kernels compute exactly what the untemplated ones did.
//
// fp32 (compute_dtype float32): vit_attention_bwd_{dq,dkv}_f32_kernel<D>, the
// same two passes, blocks, row statistics, masking and bias-gradient sums on
// fp32 operands, as K6's fp32 kernel is to K6. The nine products run in
// 3xTF32 on mma.sync m16n8k8 (mma_tf32x3.cuh): fp32 accuracy at three TF32
// products per fp32 one. Rounding points are cor_tpu's in fp32, so nothing is
// rounded: q * scale, a and dl enter their products as they are. Tiles
// [token][d] take a row stride of D + 4 words (68 / 84: 4 mod 8,
// conflict-free TF32 fragments) and no tile is transposed: the products
// whose contraction runs over tokens (dl K in pass 1; a^T dO and dl^T Q in
// pass 2) read their accumulator tiles as A operands in the permuted k order
// of mma_tf32x3.cuh and B ([token][d]) in the same order. The A fragments of
// Q, dO, K and V are read from shared memory at each use, not held in
// registers (their TF32 halves at D = 80 alone would take 160). The bias rows
// are fp32 [64][68]. Dynamic shared memory: pass 1 holds sQ, sDO, sK, sV,
// the bias rows and the three [64][65] fp32 tiles: 154,368 bytes at D = 64,
// 170,752 at 80 (one block per SM); pass 2 sK, sV, sQ, sDO, the bias rows and
// 512 bytes: 104,960 and 121,344 (two blocks per SM at 64, one at 80). No
// tile is halved: all fit the 232,448 bytes a block may take. The bf16
// kernels give the bits they gave
// before fp32 came in (tools/kernel_bits.py).

#include "decoder_common.cuh"
#include "mma_tf32x3.cuh"

namespace {

using cor::bf2f;
using cor::f2bf;
using cor::lds32;
using cor::mma_bf16_16816;
using cor::pack_bf16x2;
using cor::quad_sum;
using cor::round_bf16;

constexpr int kT = 64;         // query and key rows per tile (16 per warp)
constexpr int kLdt = kT + 8;   // padded row stride of a transposed tile [d][token]
constexpr int kMaxSide = 64;   // H, W <= 64
constexpr int kLdr = kMaxSide + 8;  // padded stride of the staged bias rows
constexpr int kLdf = kT + 1;   // fp32 row stride of the dl tile and bias gradients
constexpr int kThreads = 128;  // 4 warps
constexpr float kLog2e = 1.4426950408889634f;

// the shapes that follow from the head_dim D (64 or 80: whole m16n8k16 k-steps)
template <int D>
struct HeadDim {
  static_assert(D % 16 == 0, "the logits' product runs in k-steps of 16");
  static constexpr int kLds = D == 64 ? 72 : 88;  // row stride of a [token][d] tile
  static_assert(kLds >= D && (kLds / 2) % 8 == 4, "conflict-free fragment rows");
  static constexpr int kTile = kT * kLds;  // bf16 elements of a [token][d] tile
  static constexpr int kTileT = D * kLdt;  // bf16 elements of a [d][token] tile
  static constexpr size_t kSmemDq = (4 * kTile + kTileT + 2 * kT * kLdr) * sizeof(uint16_t) +
                                    3 * kT * kLdf * sizeof(float);
  static constexpr size_t kSmemDkv = (4 * kTile + 2 * kTileT + 2 * kT * kLdr) *
                                     sizeof(uint16_t) + 2 * kT * sizeof(float);
};

// two bf16 in one 32-bit word, each times s, rounded back to bf16
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t w, float s) {
  return pack_bf16x2(bf2f(static_cast<uint16_t>(w & 0xffffu)) * s,
                     bf2f(static_cast<uint16_t>(w >> 16)) * s);
}

// Rows [r0, r0 + 64) of a [., stride] bf16 matrix, D columns from src ->
// s [row][kLds] (if s) and its transpose st [col][kLdt] (if st); rows >= N
// are zeros; with kScale each value is multiplied by scale and rounded.
template <int D, bool kScale>
__device__ __forceinline__ void stage_tile(uint16_t* s, uint16_t* st, const uint16_t* src,
                                           int64_t stride, int r0, int N, float scale, int tid) {
  constexpr int kLds = HeadDim<D>::kLds;
  for (int i = tid; i < kT * (D / 8); i += kThreads) {
    const int r = i / (D / 8);
    const int c8 = (i % (D / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < N) {
      v = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + c8);
      if (kScale)
        v = make_uint4(scale_bf16x2(v.x, scale), scale_bf16x2(v.y, scale),
                       scale_bf16x2(v.z, scale), scale_bf16x2(v.w, scale));
    }
    if (s != nullptr) *reinterpret_cast<uint4*>(&s[r * kLds + c8]) = v;
    if (st != nullptr) {
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        st[(c8 + 2 * j) * kLdt + r] = static_cast<uint16_t>(w[j] & 0xffffu);
        st[(c8 + 2 * j + 1) * kLdt + r] = static_cast<uint16_t>(w[j] >> 16);
      }
    }
  }
}

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

// acc[n] (16 rows x 8 columns) = A (this warp's 16 rows, as fragments a[4])
// times the 64 rows of sB [n*8 + col][kLds] transposed: the 16 x 64 product
// over the D-wide contraction
template <int D>
__device__ __forceinline__ void mma_rows(float (&acc)[kT / 8][4], const uint32_t (&a)[D / 16][4],
                                         const uint16_t* sB, int g, int t) {
  constexpr int kLds = HeadDim<D>::kLds;
#pragma unroll
  for (int n = 0; n < kT / 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      const uint16_t* p = sB + (n * 8 + g) * kLds + kc * 16 + 2 * t;
      mma_bf16_16816(acc[n], a[kc], lds32(p), lds32(p + 8));
    }
  }
}

// acc[n] += P (16 x 64, fragments p[4] along the contraction) times sB^T,
// with sB [n*8 + col][kLdt] holding the 64-deep operand transposed
template <int D>
__device__ __forceinline__ void mma_acc(float (&acc)[D / 8][4], const uint32_t (&p)[kT / 16][4],
                                        const uint16_t* sB, int g, int t) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int kc = 0; kc < kT / 16; ++kc) {
      const uint16_t* q = sB + (n * 8 + g) * kLdt + kc * 16 + 2 * t;
      mma_bf16_16816(acc[n], p[kc], lds32(q), lds32(q + 8));
    }
  }
}

// The A fragments of a warp's 16 rows of a staged tile
template <int D>
__device__ __forceinline__ void load_frags(uint32_t (&a)[D / 16][4], const uint16_t* s, int row0,
                                           int g, int t) {
  constexpr int kLds = HeadDim<D>::kLds;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const uint16_t* p = s + (row0 + g) * kLds + kc * 16 + 2 * t;
    a[kc][0] = lds32(p);
    a[kc][1] = lds32(p + 8 * kLds);
    a[kc][2] = lds32(p + 8);
    a[kc][3] = lds32(p + 8 * kLds + 8);
  }
}

// accumulator tiles 2kc and 2kc+1, rounded to bf16, are exactly the A
// fragment of columns 16kc .. 16kc+15
__device__ __forceinline__ void pack_frags(uint32_t (&p)[kT / 16][4], const float (&x)[kT / 8][4]) {
#pragma unroll
  for (int n = 0; n < kT / 8; ++n) {
    p[n >> 1][(n & 1) * 2 + 0] = pack_bf16x2(x[n][0], x[n][1]);
    p[n >> 1][(n & 1) * 2 + 1] = pack_bf16x2(x[n][2], x[n][3]);
  }
}

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

template <int D>
__global__ void __launch_bounds__(kThreads)
vit_attention_bwd_dq_kernel(const uint16_t* __restrict__ qkv, const uint16_t* __restrict__ rel_h,
                            const uint16_t* __restrict__ rel_w, const uint16_t* __restrict__ dout,
                            uint16_t* __restrict__ dqkv, uint16_t* __restrict__ drel_h,
                            uint16_t* __restrict__ drel_w, float* __restrict__ lse,
                            float* __restrict__ delta, int N, int C, int H, int W, float scale) {
  constexpr int kTile = HeadDim<D>::kTile;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* sQ = reinterpret_cast<uint16_t*>(smem);  // [query][d], q * scale
  uint16_t* sDO = sQ + kTile;                         // [query][d]
  uint16_t* sK = sDO + kTile;                         // [key][d]
  uint16_t* sV = sK + kTile;                          // [key][d]
  uint16_t* sKt = sV + kTile;                         // [d][key]
  uint16_t* sRh = sKt + HeadDim<D>::kTileT;           // [query][key grid row]
  uint16_t* sRw = sRh + kT * kLdr;                    // [query][key grid column]
  float* sDl = reinterpret_cast<float*>(sRw + kT * kLdr);  // [query][key] bf16(dl)
  float* sDrh = sDl + kT * kLdf;                      // [query][key grid row]
  float* sDrw = sDrh + kT * kLdf;                     // [query][key grid column]

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
  const uint16_t* base = qkv + static_cast<int64_t>(b) * N * row_stride + h * D;
  const int64_t rel_row0 = (static_cast<int64_t>(b) * heads + h) * N + q0;

  stage_tile<D, true>(sQ, nullptr, base, row_stride, q0, N, scale, tid);
  stage_tile<D, false>(sDO, nullptr, dout + static_cast<int64_t>(b) * N * C + h * D, C, q0, N,
                       0.f, tid);
  stage_bias<uint16_t, kLdr>(sRh, rel_h, rel_row0, q0, N, H, tid);
  stage_bias<uint16_t, kLdr>(sRw, rel_w, rel_row0, q0, N, W, tid);
  for (int i = tid; i < 2 * kT * kLdf; i += kThreads) sDrh[i] = 0.f;  // sDrh and sDrw
  __syncthreads();

  uint32_t qa[D / 16][4], doa[D / 16][4];
  load_frags<D>(qa, sQ, wr, g, t);
  load_frags<D>(doa, sDO, wr, g, t);
  const uint16_t* rh0 = sRh + (wr + g) * kLdr;
  const uint16_t* rw0 = sRw + (wr + g) * kLdr;
  const uint16_t* rh1 = rh0 + 8 * kLdr;
  const uint16_t* rw1 = rw0 + 8 * kLdr;

  // sweep 1: each row's max, exp-sum and delta, online (log2 domain)
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this lane's shares, rescaled with m_run
  float d_run[2] = {0.f, 0.f};
  float s[kT / 8][4], da[kT / 8][4];
  for (int k0 = 0; k0 < N; k0 += kT) {
    __syncthreads();  // the previous K/V tiles are fully consumed
    stage_tile<D, false>(sK, nullptr, base + C, row_stride, k0, N, 0.f, tid);
    stage_tile<D, false>(sV, nullptr, base + 2 * C, row_stride, k0, N, 0.f, tid);
    __syncthreads();
    mma_rows<D>(s, qa, sK, g, t);
    mma_rows<D>(da, doa, sV, g, t);
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
      const float m_new = fmaxf(m_run[r], mt[r]);  // finite: every tile has a key < N
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

  // sweep 2: a and dl per tile; dq on the tensor cores, the bias gradients
  // from shared memory
  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  float* dl_r0 = sDl + (wr + g) * kLdf;
  float* dl_r1 = dl_r0 + 8 * kLdf;
  const int my_row = wr + (lane & 15);  // the row whose bias gradient this lane sums
  const bool my_h = lane < 16;          // rel_h (lanes 0-15) or rel_w (16-31)
  float* my_acc = (my_h ? sDrh : sDrw) + my_row * kLdf;
  const float* my_dl = sDl + my_row * kLdf;
  for (int k0 = 0; k0 < N; k0 += kT) {
    __syncthreads();
    stage_tile<D, false>(sK, sKt, base + C, row_stride, k0, N, 0.f, tid);
    stage_tile<D, false>(sV, nullptr, base + 2 * C, row_stride, k0, N, 0.f, tid);
    __syncthreads();
    mma_rows<D>(s, qa, sK, g, t);
    mma_rows<D>(da, doa, sV, g, t);
    bias_log2(s, rh0, rw0, rh1, rw1, k0, t, N, W);
#pragma unroll
    for (int n = 0; n < kT / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float a = exp2f(s[n][e] - lse2[e >> 1]);  // 0 for a masked key
        s[n][e] = round_bf16(a * (da[n][e] - dlt[e >> 1]));  // bf16(dl)
      }
      dl_r0[n * 8 + 2 * t] = s[n][0];
      dl_r0[n * 8 + 2 * t + 1] = s[n][1];
      dl_r1[n * 8 + 2 * t] = s[n][2];
      dl_r1[n * 8 + 2 * t + 1] = s[n][3];
    }
    uint32_t dla[kT / 16][4];
    pack_frags(dla, s);
    mma_acc<D>(dq, dla, sKt, g, t);
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

  // dq * scale -> the q third of dqkv; the bias gradients -> drel_h, drel_w
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
  for (int i = lane; i < 16 * H; i += 32) {
    const int r = wr + i / H, c = i % H;
    if (q0 + r < N) drel_h[(rel_row0 + r) * H + c] = f2bf(sDrh[r * kLdf + c]);
  }
  for (int i = lane; i < 16 * W; i += 32) {
    const int r = wr + i / W, c = i % W;
    if (q0 + r < N) drel_w[(rel_row0 + r) * W + c] = f2bf(sDrw[r * kLdf + c]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
vit_attention_bwd_dkv_kernel(const uint16_t* __restrict__ qkv, const uint16_t* __restrict__ rel_h,
                             const uint16_t* __restrict__ rel_w, const uint16_t* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             uint16_t* __restrict__ dqkv, int N, int C, int H, int W,
                             float scale) {
  constexpr int kTile = HeadDim<D>::kTile;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* sK = reinterpret_cast<uint16_t*>(smem);  // [key][d]
  uint16_t* sV = sK + kTile;                          // [key][d]
  uint16_t* sQ = sV + kTile;                          // [query][d], q * scale
  uint16_t* sDO = sQ + kTile;                         // [query][d]
  uint16_t* sQt = sDO + kTile;                        // [d][query]
  uint16_t* sDOt = sQt + HeadDim<D>::kTileT;          // [d][query]
  uint16_t* sRh = sDOt + HeadDim<D>::kTileT;          // [query][key grid row]
  uint16_t* sRw = sRh + kT * kLdr;                    // [query][key grid column]
  float* sLse = reinterpret_cast<float*>(sRw + kT * kLdr);
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
  const uint16_t* base = qkv + static_cast<int64_t>(b) * N * row_stride + h * D;
  const uint16_t* dbase = dout + static_cast<int64_t>(b) * N * C + h * D;
  const int64_t rel0 = (static_cast<int64_t>(b) * heads + h) * N;

  stage_tile<D, false>(sK, nullptr, base + C, row_stride, k0, N, 0.f, tid);
  stage_tile<D, false>(sV, nullptr, base + 2 * C, row_stride, k0, N, 0.f, tid);
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
  float s[kT / 8][4], da[kT / 8][4];
  for (int q0 = 0; q0 < N; q0 += kT) {
    __syncthreads();  // the previous query tiles are fully consumed
    stage_tile<D, true>(sQ, sQt, base, row_stride, q0, N, scale, tid);
    stage_tile<D, false>(sDO, sDOt, dbase, C, q0, N, 0.f, tid);
    stage_bias<uint16_t, kLdr>(sRh, rel_h, rel0 + q0, q0, N, H, tid);
    stage_bias<uint16_t, kLdr>(sRw, rel_w, rel0 + q0, q0, N, W, tid);
    for (int i = tid; i < kT; i += kThreads) {
      const bool in = q0 + i < N;
      sLse[i] = in ? lse[rel0 + q0 + i] : 0.f;
      sDelta[i] = in ? delta[rel0 + q0 + i] : 0.f;
    }
    __syncthreads();
    uint32_t ka[D / 16][4], va[D / 16][4];
    load_frags<D>(ka, sK, wr, g, t);
    mma_rows<D>(s, ka, sQ, g, t);  // S^T: this warp's keys x the tile's queries
    load_frags<D>(va, sV, wr, g, t);
    mma_rows<D>(da, va, sDO, g, t);  // da^T
#pragma unroll
    for (int n = 0; n < kT / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int qi = n * 8 + 2 * t + (e & 1);
        const bool in = q0 + qi < N && key[r] < N;
        const float l2 = (s[n][e] + bf2f(sRh[qi * kLdr + jh[r]]) + bf2f(sRw[qi * kLdr + jw[r]])) *
                         kLog2e;
        const float a = in ? exp2f(l2 - sLse[qi]) : 0.f;
        s[n][e] = a;
        da[n][e] = a * (da[n][e] - sDelta[qi]);  // dl
      }
    }
    uint32_t aa[kT / 16][4], dla[kT / 16][4];
    pack_frags(aa, s);
    pack_frags(dla, da);
    mma_acc<D>(dv, aa, sDOt, g, t);
    mma_acc<D>(dk, dla, sQt, g, t);
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

// ---------------------------------------------------------------------------
// fp32: the same passes on fp32 operands, products in 3xTF32
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
int launch(const void* qkv, const void* rel_h, const void* rel_w, const void* dout, void* dqkv,
           void* drel_h, void* drel_w, void* stats, int B, int N, int C, int num_heads, int H,
           int W, float scale, void* stream) {
  constexpr size_t smem_dq = HeadDim<D>::kSmemDq, smem_dkv = HeadDim<D>::kSmemDkv;
  cudaError_t err = cudaFuncSetAttribute(
      vit_attention_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(vit_attention_bwd_dkv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkv);
  if (err != cudaSuccess) return err;
  float* lse = static_cast<float*>(stats);
  float* delta = lse + static_cast<int64_t>(B) * num_heads * N;
  const dim3 grid((N + kT - 1) / kT, num_heads, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint16_t* q = static_cast<const uint16_t*>(qkv);
  const uint16_t* rh = static_cast<const uint16_t*>(rel_h);
  const uint16_t* rw = static_cast<const uint16_t*>(rel_w);
  const uint16_t* d = static_cast<const uint16_t*>(dout);
  uint16_t* dq = static_cast<uint16_t*>(dqkv);
  vit_attention_bwd_dq_kernel<D><<<grid, kThreads, smem_dq, st>>>(
      q, rh, rw, d, dq, static_cast<uint16_t*>(drel_h), static_cast<uint16_t*>(drel_w), lse,
      delta, N, C, H, W, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  vit_attention_bwd_dkv_kernel<D><<<grid, kThreads, smem_dkv, st>>>(q, rh, rw, d, lse, delta, dq,
                                                                    N, C, H, W, scale);
  return cudaGetLastError();
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
// Writes dqkv [B, N, 3C], drel_h, drel_w (of that type, the shapes of their
// inputs) and uses stats: fp32 scratch of 2 * B * num_heads * N (the rows'
// log-sum-exp and delta). Returns the launches' cudaError_t
// (cudaErrorInvalidValue for shapes the kernels do not take; a refused
// shared-memory size or launch as the runtime reports it).
extern "C" int cor_vit_attention_relpos_bwd(const void* qkv, const void* rel_h, const void* rel_w,
                                            const void* dout, void* dqkv, void* drel_h,
                                            void* drel_w, void* stats, int B, int N, int C,
                                            int num_heads, int H, int W, float scale, int f32,
                                            void* stream) {
  if (B < 1 || N < 1 || num_heads < 1 || C % num_heads != 0 || B > 65535 ||
      num_heads > 65535 || H < 1 || W < 1 || H > kMaxSide || W > kMaxSide || H * W != N)
    return cudaErrorInvalidValue;
  switch (C / num_heads) {
    case 64:
      return (f32 ? launch_f32<64> : launch<64>)(qkv, rel_h, rel_w, dout, dqkv, drel_h, drel_w,
                                                 stats, B, N, C, num_heads, H, W, scale, stream);
    case 80:
      return (f32 ? launch_f32<80> : launch<80>)(qkv, rel_h, rel_w, dout, dqkv, drel_h, drel_w,
                                                 stats, B, N, C, num_heads, H, W, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}
