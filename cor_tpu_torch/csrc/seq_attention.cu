// Whole-sequence multi-head self-attention read straight off a fused QKV
// tensor: out[b, n, h*D:(h+1)*D] = softmax(q_h k_h^T / sqrt(D)) v_h.
//
// Replaces the TPU kernel cor_tpu/ops/pallas/seq_attention.py:
// attention_seq_qkv_pallas (_qkv_pair_call, its pallas_call at line 99). As
// there, q, k and v of head h are read in place from qkv [B, N, 3C] at
// column offsets h*D, C + h*D and 2C + h*D, and the output is written into
// [B, N, C] at h*D with the heads already merged for the out-projection:
// no transposes and no [B, H, N, N] logits ever reach device memory.
//
// What bounds it on the H100: at the SigLIP towers' shapes (N = 576 or 64,
// D = 64) a (batch, head) pair is 4 * N^2 * D flops on 3 * N * D * 2 bytes,
// about 280 flop/byte at N = 576, next to the card's ~295 flop/byte ridge,
// and the products are small (64 x 64 x 64 tiles). So both the bytes and the
// rate of small matrix products count. The design:
//  - one block of 4 warps per (64-query tile, head, batch); each warp owns 16
//    query rows, so the vision tower at B = 16 launches 9 * 12 * 16 = 1,728
//    blocks and fills the 132 SMs many times over;
//  - K and V of the (batch, head) stream through shared memory in 64-key
//    tiles with 16-byte loads (V is stored transposed there so that its
//    tensor-core operand is one 32-bit shared load per register);
//  - logits and P.V run on the tensor cores with mma.sync m16n8k16 bf16 and
//    fp32 accumulation; the softmax is online (flash-style) in fp32, in the
//    log2 domain, with the row max and row sum reduced across the four lanes
//    that share a row;
//  - P is rounded to bf16 before P.V, as the TPU kernel rounds its
//    probabilities to the compute dtype; here P is unnormalised and the
//    division by the row sum happens once, in fp32, at the end.
// Padded shared-memory rows (72 bf16) keep the fragment loads free of bank
// conflicts. Ragged N is masked: keys past N get -inf logits, query rows past
// N are computed on zeros and not stored. wgmma and TMA are left for later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;         // head_dim this kernel takes
constexpr int kBQ = 64;        // query rows per block (16 per warp)
constexpr int kBK = 64;        // keys per shared-memory tile
constexpr int kLds = kD + 8;   // padded shared row stride, in bf16 elements
constexpr int kThreads = 128;  // 4 warps

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2 in one 32-bit register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

__device__ __forceinline__ uint32_t lds32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kThreads)
seq_attention_qkv_kernel(const uint16_t* __restrict__ qkv, uint16_t* __restrict__ out,
                         int N, int C, float scale_log2) {
  __shared__ __align__(16) uint16_t sQ[kBQ * kLds];
  __shared__ __align__(16) uint16_t sK[kBK * kLds];   // [key][d]
  __shared__ __align__(16) uint16_t sVt[kD * kLds];   // [d][key]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int64_t row_stride = 3LL * C;
  const uint16_t* base = qkv + static_cast<int64_t>(b) * N * row_stride + h * kD;

  // Q tile -> shared (rows past N are zero)
  for (int i = tid; i < kBQ * (kD / 8); i += kThreads) {
    const int r = i / (kD / 8);
    const int c8 = (i % (kD / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < N) v = *reinterpret_cast<const uint4*>(base + (q0 + r) * row_stride + c8);
    *reinterpret_cast<uint4*>(&sQ[r * kLds + c8]) = v;
  }
  __syncthreads();

  // this warp's 16 query rows as m16k16 A fragments, one per 16 columns of D
  const int wr = warp * 16;
  uint32_t qa[kD / 16][4];
#pragma unroll
  for (int kc = 0; kc < kD / 16; ++kc) {
    const uint16_t* p = sQ + (wr + g) * kLds + kc * 16 + 2 * t;
    qa[kc][0] = lds32(p);
    qa[kc][1] = lds32(p + 8 * kLds);
    qa[kc][2] = lds32(p + 8);
    qa[kc][3] = lds32(p + 8 * kLds + 8);
  }

  float o[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, log2 domain
  float l_run[2] = {0.f, 0.f};              // this lane's share of the row sums

  for (int k0 = 0; k0 < N; k0 += kBK) {
    __syncthreads();  // the previous K/V tile is fully consumed
    for (int i = tid; i < kBK * (kD / 8); i += kThreads) {
      const int r = i / (kD / 8);
      const int c8 = (i % (kD / 8)) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < N) {
        const uint16_t* rowp = base + (k0 + r) * row_stride + c8;
        kv = *reinterpret_cast<const uint4*>(rowp + C);
        vv = *reinterpret_cast<const uint4*>(rowp + 2 * C);
      }
      *reinterpret_cast<uint4*>(&sK[r * kLds + c8]) = kv;
      const uint32_t w[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sVt[(c8 + 2 * j) * kLds + r] = static_cast<uint16_t>(w[j] & 0xffffu);
        sVt[(c8 + 2 * j + 1) * kLds + r] = static_cast<uint16_t>(w[j] >> 16);
      }
    }
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys, 8 n-tiles of 8 keys
    float s[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < kD / 16; ++kc) {
        const uint16_t* p = sK + (n * 8 + g) * kLds + kc * 16 + 2 * t;
        mma_bf16_16816(s[n], qa[kc], lds32(p), lds32(p + 8));
      }
    }

    // scale into the log2 domain, mask keys past N, tile row max
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        const float v = key < N ? s[n][e] * scale_log2 : -INFINITY;
        s[n][e] = v;
        mt[e >> 1] = fmaxf(mt[e >> 1], v);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m_run[r], mt[r]);  // finite: every tile has a key < N
      alpha[r] = exp2f(m_run[r] - m_new);           // 0 on the first tile
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

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
    for (int n = 0; n < kD / 8; ++n) {
#pragma unroll
      for (int kc = 0; kc < kBK / 16; ++kc) {
        const uint16_t* p = sVt + (n * 8 + g) * kLds + kc * 16 + 2 * t;
        mma_bf16_16816(o[n], pa[kc], lds32(p), lds32(p + 8));
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    inv[r] = 1.f / l_run[r];
  }
  const int qa_row = q0 + wr + g;
  const int qb_row = qa_row + 8;
  uint16_t* out_h = out + static_cast<int64_t>(b) * N * C + h * kD + 2 * t;
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    if (qa_row < N)
      *reinterpret_cast<uint32_t*>(out_h + static_cast<int64_t>(qa_row) * C + n * 8) =
          pack_bf16x2(o[n][0] * inv[0], o[n][1] * inv[0]);
    if (qb_row < N)
      *reinterpret_cast<uint32_t*>(out_h + static_cast<int64_t>(qb_row) * C + n * 8) =
          pack_bf16x2(o[n][2] * inv[1], o[n][3] * inv[1]);
  }
}

}  // namespace

// qkv: [B, N, 3C] bf16 contiguous, 16-byte aligned, C = num_heads * 64,
// C % 8 == 0. out: [B, N, C] bf16 contiguous. Returns the launch's
// cudaError_t (cudaErrorInvalidValue for shapes the kernel does not take).
extern "C" int cor_seq_attention_qkv(const void* qkv, void* out, int B, int N, int C,
                                     int num_heads, void* stream) {
  if (B < 1 || N < 1 || num_heads < 1 || C != num_heads * kD || B > 65535 ||
      num_heads > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((N + kBQ - 1) / kBQ, num_heads, B);
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(kD));
  seq_attention_qkv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(qkv), static_cast<uint16_t*>(out), N, C, scale_log2);
  return cudaGetLastError();
}
