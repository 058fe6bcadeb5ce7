// Whole-sequence multi-head self-attention, out_h = softmax(q_h k_h^T / sqrt(D)) v_h
// for every head h of every batch row, with head_dim D in {64, 72, 80}.
//
// Replaces the TPU kernels of cor_tpu/ops/pallas/seq_attention.py:
//  - attention_seq_qkv_pallas (_qkv_pair_call, its pallas_call at line 99),
//    head_dim 64: q, k and v of head h are read in place from qkv [B, N, 3C]
//    at column offsets h*D, C + h*D and 2C + h*D, and the output is written
//    into [B, N, C] at h*D with the heads already merged for the
//    out-projection;
//  - attention_seq_pallas (_attention_padded, its pallas_call at line 49):
//    the same over [B, H, N, D] operands, the TPU's route for head dims that
//    do not tile its 128 lanes (ViT-SO400M-14-SigLIP-384: 16 heads of 72).
//    cor_tpu transposes the fused QKV to [B, H, N, D] for it; here one kernel
//    takes both layouts through strides, so the towers at head_dim 72 read
//    the fused QKV in place too.
// No transposes and no [B, H, N, N] logits ever reach device memory.
//
// What bounds it on the H100: at the SigLIP towers' shapes (N = 576, 729 or
// 64) a (batch, head) pair is 4 * N^2 * D flops on 4 * N * D * 2 bytes,
// about 290 flop/byte at N = 576, next to the card's ~295 flop/byte ridge,
// and the products are small (64 x 64 x D tiles). So both the bytes and the
// rate of small matrix products count. The design:
//  - one block of 4 warps per (64-query tile, head, batch); each warp owns 16
//    query rows, so the SO400M vision tower at B = 16 launches
//    12 * 16 * 16 = 3,072 blocks and fills the 132 SMs many times over;
//  - K and V of the (batch, head) stream through shared memory in 64-key
//    tiles with 16-byte loads (a row of D bf16 is D / 8 of them: 9 at 72);
//    V is stored transposed there so that its tensor-core operand is one
//    32-bit shared load per register;
//  - logits and P.V run on the tensor cores with mma.sync m16n8k16 bf16 and
//    fp32 accumulation. The logits' product runs over D rounded up to the
//    mma's k of 16: at D = 72 a fifth k-step reads columns 72..79 of the Q
//    and K tiles, which are zero in shared memory, so it adds exactly 0.
//    P.V is D / 8 n-tiles of 8 (9 at 72, 10 at 80);
//  - the softmax is online (flash-style) in fp32, in the log2 domain, with
//    the row max and row sum reduced across the four lanes that share a row;
//  - P is rounded to bf16 before P.V, as the TPU kernel rounds its
//    probabilities to the compute dtype; here P is unnormalised and the
//    division by the row sum happens once, in fp32, at the end.
// Padded shared-memory rows keep the fragment loads free of bank conflicts:
// the Q and K tiles' rows are 72 bf16 (36 words) at D = 64 and 88 bf16 (44
// words) at D = 72 and 80, where 80 (40 words) would put fragment rows g and
// g + 4 on one bank; V^T's rows hold 64 keys and are 72 bf16 at every D.
// Ragged N is masked: keys past N get -inf logits, query rows past N are
// computed on zeros and not stored. wgmma and TMA are left for later.
//
// fp32 (cor_tpu's compute_dtype float32): seq_attention_f32_kernel, the same
// blocks, tiles and online softmax on fp32 operands, with every product in
// 3xTF32 on mma.sync m16n8k8 (mma_tf32x3.cuh): fp32 accuracy on the tensor
// cores, three TF32 products per fp32 one. Nothing is rounded (P included),
// as cor_tpu rounds to the compute dtype. The tiles are [64][D + 4] fp32
// (68, 76, 84 words: 4 mod 8, conflict-free TF32 fragment loads; D = 72 is
// 9 whole k-steps of 8, no zero columns), Q shares its tile with K (Q lives
// in registers once loaded), and V stays [key][d]: P's accumulator tiles are
// the A operand of P.V in the permuted key order of mma_tf32x3.cuh, so V's
// B fragments read keys 2t and 2t + 1. 43,008 bytes of shared memory at
// D = 80. What bounds it: operations (three products per product).

#include "decoder_common.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block (16 per warp)
constexpr int kBK = 64;        // keys per shared-memory tile
constexpr int kLdv = kBK + 8;  // padded row stride of the V^T tile [d][key], in bf16
constexpr int kThreads = 128;  // 4 warps

// the shapes that follow from the head_dim D
template <int D>
struct HeadDim {
  static_assert(D % 8 == 0, "a row of D bf16 is whole 16-byte chunks");
  static constexpr int kDk = (D + 15) / 16 * 16;  // the logits' product depth
  static constexpr int kLdq = D == 64 ? 72 : 88;  // row stride of the Q and K tiles
  static_assert(kLdq >= kDk && (kLdq / 2) % 8 == 4, "conflict-free fragment rows");
};

using cor::lds32;
using cor::mma_bf16_16816;
using cor::pack_bf16x2;

// S (a 64-key tile of this lane's rows g and g + 8) into the log2 domain,
// keys past N masked to -inf; mt: this lane's row maxima of it
__device__ __forceinline__ void scale_mask_max(float (&s)[kBK / 8][4], int k0, int N, int t,
                                               float scale_log2, float (&mt)[2]) {
  mt[0] = mt[1] = -INFINITY;
#pragma unroll
  for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + n * 8 + 2 * t + (e & 1);
      const float val = key < N ? s[n][e] * scale_log2 : -INFINITY;
      s[n][e] = val;
      mt[e >> 1] = fmaxf(mt[e >> 1], val);
    }
  }
}

// q, k, v: element (b, h, n, d) at b * in_b + h * in_h + n * in_n + d (the
// three share strides); out: at b * out_b + h * out_h + n * out_n + d.
template <int D>
__global__ void __launch_bounds__(kThreads)
seq_attention_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                     const uint16_t* __restrict__ v, uint16_t* __restrict__ out, int N,
                     int64_t in_b, int64_t in_h, int64_t in_n, int64_t out_b, int64_t out_h,
                     int64_t out_n, float scale_log2) {
  constexpr int kDk = HeadDim<D>::kDk;
  constexpr int kLdq = HeadDim<D>::kLdq;
  constexpr int kChunks = kDk / 8;  // 16-byte chunks of a tile row, the zero pad included
  __shared__ __align__(16) uint16_t sQ[kBQ * kLdq];
  __shared__ __align__(16) uint16_t sK[kBK * kLdq];  // [key][d]
  __shared__ __align__(16) uint16_t sVt[D * kLdv];   // [d][key]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int64_t head = b * in_b + h * in_h;
  const uint16_t* qh = q + head;
  const uint16_t* kh = k + head;
  const uint16_t* vh = v + head;

  // Q tile -> shared (rows past N and columns past D are zero)
  for (int i = tid; i < kBQ * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c8 = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (c8 < D && q0 + r < N)
      val = *reinterpret_cast<const uint4*>(qh + (q0 + r) * in_n + c8);
    *reinterpret_cast<uint4*>(&sQ[r * kLdq + c8]) = val;
  }
  __syncthreads();

  // this warp's 16 query rows as m16k16 A fragments, one per 16 columns of D
  const int wr = warp * 16;
  uint32_t qa[kDk / 16][4];
#pragma unroll
  for (int kc = 0; kc < kDk / 16; ++kc) {
    const uint16_t* p = sQ + (wr + g) * kLdq + kc * 16 + 2 * t;
    qa[kc][0] = lds32(p);
    qa[kc][1] = lds32(p + 8 * kLdq);
    qa[kc][2] = lds32(p + 8);
    qa[kc][3] = lds32(p + 8 * kLdq + 8);
  }

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, log2 domain
  float l_run[2] = {0.f, 0.f};              // this lane's share of the row sums

  for (int k0 = 0; k0 < N; k0 += kBK) {
    __syncthreads();  // the previous K/V tile is fully consumed
    for (int i = tid; i < kBK * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int c8 = (i % kChunks) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (c8 < D && k0 + r < N) {
        kv = *reinterpret_cast<const uint4*>(kh + (k0 + r) * in_n + c8);
        vv = *reinterpret_cast<const uint4*>(vh + (k0 + r) * in_n + c8);
      }
      *reinterpret_cast<uint4*>(&sK[r * kLdq + c8]) = kv;
      if (c8 < D) {
        const uint32_t w[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sVt[(c8 + 2 * j) * kLdv + r] = static_cast<uint16_t>(w[j] & 0xffffu);
          sVt[(c8 + 2 * j + 1) * kLdv + r] = static_cast<uint16_t>(w[j] >> 16);
        }
      }
    }
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys, 8 n-tiles of 8 keys
    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < kDk / 16; ++kc) {
        const uint16_t* p = sK + (n * 8 + g) * kLdq + kc * 16 + 2 * t;
        mma_bf16_16816(s[n], qa[kc], lds32(p), lds32(p + 8));
      }
    }

    // scale into the log2 domain, mask keys past N, tile row max
    float mt[2];
    scale_mask_max(s, k0, N, t, scale_log2, mt);
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
  const int qa_row = q0 + wr + g;
  const int qb_row = qa_row + 8;
  uint16_t* dst = out + b * out_b + h * out_h + 2 * t;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (qa_row < N)
      *reinterpret_cast<uint32_t*>(dst + qa_row * out_n + n * 8) =
          pack_bf16x2(o[n][0] * inv[0], o[n][1] * inv[0]);
    if (qb_row < N)
      *reinterpret_cast<uint32_t*>(dst + qb_row * out_n + n * 8) =
          pack_bf16x2(o[n][2] * inv[1], o[n][3] * inv[1]);
  }
}

// The fp32 case: q, k, v, out fp32, element (b, h, n, d) as above.
template <int D>
__global__ void __launch_bounds__(kThreads)
seq_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out, int N,
                         int64_t in_b, int64_t in_h, int64_t in_n, int64_t out_b, int64_t out_h,
                         int64_t out_n, float scale_log2) {
  static_assert(D % 8 == 0, "whole k-steps of 8");
  constexpr int kLd = D + 4;  // 4 mod 8 words: conflict-free TF32 fragments
  constexpr int kChunks = D / 4;  // 16-byte chunks of a row
  __shared__ __align__(16) float sQK[kBK * kLd];  // the Q tile, then each K tile [key][d]
  __shared__ __align__(16) float sV[kBK * kLd];   // [key][d]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int64_t head = b * in_b + h * in_h;
  const float* qh = q + head;
  const float* kh = k + head;
  const float* vh = v + head;

  for (int i = tid; i < kBQ * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c4 = (i % kChunks) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < N) val = *reinterpret_cast<const float4*>(qh + (q0 + r) * in_n + c4);
    *reinterpret_cast<float4*>(&sQK[r * kLd + c4]) = val;
  }
  __syncthreads();
  const int wr = warp * 16;
  cor::FragA qa[D / 8];
#pragma unroll
  for (int kc = 0; kc < D / 8; ++kc) qa[kc] = cor::load_a_tf32(sQK, kLd, wr, kc * 8, g, t);

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
        kv = *reinterpret_cast<const float4*>(kh + (k0 + r) * in_n + c4);
        vv = *reinterpret_cast<const float4*>(vh + (k0 + r) * in_n + c4);
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
    scale_mask_max(s, k0, N, t, scale_log2, mt);
    cor::softmax_rescale(mt, m_run, l_run, o);

    // O += P V, one k-step of 8 keys per accumulator tile of S, in the
    // permuted key order (keys 2t, 2t + 1 of the tile)
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
  const int qa_row = q0 + wr + g;
  const int qb_row = qa_row + 8;
  float* dst = out + b * out_b + h * out_h + 2 * t;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (qa_row < N)
      *reinterpret_cast<float2*>(dst + qa_row * out_n + n * 8) =
          make_float2(o[n][0] * inv[0], o[n][1] * inv[0]);
    if (qb_row < N)
      *reinterpret_cast<float2*>(dst + qb_row * out_n + n * 8) =
          make_float2(o[n][2] * inv[1], o[n][3] * inv[1]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int N,
           int64_t in_b, int64_t in_h, int64_t in_n, int64_t out_b, int64_t out_h,
           int64_t out_n, int f32, void* stream) {
  const dim3 grid((N + kBQ - 1) / kBQ, H, B);
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f32)
    seq_attention_f32_kernel<D><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(out), N, in_b, in_h, in_n, out_b, out_h, out_n, scale_log2);
  else
    seq_attention_kernel<D><<<grid, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
        static_cast<const uint16_t*>(v), static_cast<uint16_t*>(out), N, in_b, in_h, in_n, out_b,
        out_h, out_n, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// q, k, v: bf16 (f32 = 0) or fp32 (f32 = 1), element (b, h, n, d) of each at
// b * in_b + h * in_h + n * in_n + d, every row 16-byte aligned (pointers
// 16-byte aligned, strides multiples of 8 bf16 or 4 fp32). out: of the same
// type, element (b, h, n, d) at b * out_b + h * out_h + n * out_n + d, rows
// 4-byte (bf16) or 8-byte (fp32) aligned. D in {64, 72, 80}. The fused QKV [B, N, 3C] is
// q = qkv, k = qkv + C, v = qkv + 2C with strides (N * 3C, D, 3C) into an out
// [B, N, C] of strides (N * C, D, C); [B, H, N, D] operands have strides
// (H * N * D, N * D, D). Returns the launch's cudaError_t
// (cudaErrorInvalidValue for shapes the kernel does not take).
extern "C" int cor_seq_attention(const void* q, const void* k, const void* v, void* out, int B,
                                 int H, int N, int D, long long in_b, long long in_h,
                                 long long in_n, long long out_b, long long out_h,
                                 long long out_n, int f32, void* stream) {
  if (B < 1 || H < 1 || N < 1 || B > 65535 || H > 65535) return cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return launch<64>(q, k, v, out, B, H, N, in_b, in_h, in_n, out_b, out_h, out_n, f32,
                         stream);
    case 72:
      return launch<72>(q, k, v, out, B, H, N, in_b, in_h, in_n, out_b, out_h, out_n, f32,
                         stream);
    case 80:
      return launch<80>(q, k, v, out, B, H, N, in_b, in_h, in_n, out_b, out_h, out_n, f32,
                         stream);
    default:
      return cudaErrorInvalidValue;
  }
}
