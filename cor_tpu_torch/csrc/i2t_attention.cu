// Stage 4 of the two-way layer (two_way_layer.cu says what the layer's four
// launches do and what bounds them), and cor_tpu's K8b: per (64-row tile,
// candidate), the image -> token softmax over the T tokens of each head, its
// product with the tokens' values, the out-projection [128 -> 256] on the
// tensor cores, the residual with the (re-read, dequantised) rows, LN4, and
// the new rows.
//
// Replaces, besides the layer's stage 4, the TPU kernel
// cor_tpu/ops/pallas/i2t_attention.py:i2t_attention_fused (its pallas_call
// at line 105), which cor_tpu's fused decode runs where its layer kernel
// does not (above 8 tokens), with the tokens' keys and values computed
// outside (ops/kernels/i2t_attention.py). T is a run-time argument, 1 to
// kMaxTok = 32; the shared memory (the out-projection weight, the
// attention output and the tokens' keys and values: 87,040 + 1,024 T bytes
// in bf16, 168,960 + 1,024 T in fp32) is sized at launch. What bounds it on
// the H100: per candidate it reads 1 MiB of q_img and 2 MiB of rows and
// writes 2 MiB (bf16), and does 0.27 GFLOP of out-projection on the tensor
// cores and 8 x 4096 x 2 x 16 T MACs of the softmax on the CUDA cores:
// bytes, at T up to 32.

#include "decoder_common.cuh"

namespace {

using namespace cor;

// Stage 4.
constexpr int kImgThreads = 128;
// the out-projection weight [kC][kLdI] and the attention output [kRows][kLdI]
// in T, the tokens' keys and values [nt][kI] fp32
template <typename T>
size_t smem_i2t(int nt) {
  return sizeof(T) * (kC * Elem<T>::kLdI + kRows * Elem<T>::kLdI) + sizeof(float) * 2 * nt * kI;
}

template <typename T, bool kInt8>
__global__ void __launch_bounds__(kImgThreads)
twl_image_i2t_kernel(const void* __restrict__ src, const int* __restrict__ idx,
                     const float* __restrict__ scale, int S, int N,
                     const T* __restrict__ q_img,  // [n][N][kI]
                     const T* __restrict__ k_i, const T* __restrict__ v_i,  // [n][nt][kI]
                     int nt,
                     const T* __restrict__ wo,     // [kC][kI]
                     const float* __restrict__ bo_ln,  // bo [kC], ln4 scale [kC], bias [kC]
                     float eps, float cross_scale, T* __restrict__ out) {
  using E = Elem<T>;
  constexpr int kLd = E::kLdI;
  constexpr int kVec = 16 / sizeof(T);  // values per 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem[];
  T* sWo = reinterpret_cast<T*>(smem);
  T* sAV = sWo + kC * kLd;
  float* sKi = reinterpret_cast<float*>(sAV + kRows * kLd);
  float* sVi = sKi + nt * kI;

  const int tile = blockIdx.x, cand = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = tile * kRows;
  const int row = source_row(idx, cand, S);
  const float sc = kInt8 ? scale[row] : 1.f;

  for (int i = tid; i < kC * (kI / kVec); i += kImgThreads) {
    const int o = i / (kI / kVec), cv = (i % (kI / kVec)) * kVec;
    *reinterpret_cast<uint4*>(sWo + o * kLd + cv) =
        *reinterpret_cast<const uint4*>(wo + static_cast<int64_t>(o) * kI + cv);
  }
  for (int i = tid; i < nt * kI; i += kImgThreads) {
    sKi[i] = E::get(k_i[static_cast<int64_t>(cand) * nt * kI + i]);
    sVi[i] = E::get(v_i[static_cast<int64_t>(cand) * nt * kI + i]);
  }
  __syncthreads();

  // per (row, head): softmax over the nt tokens, product with the values.
  // The loops over the tokens unroll to kMaxTok and stop at nt, so that l
  // stays in registers; they add in the token order at every nt. The query
  // is scaled and rounded before the product, where cor_tpu's K8b scales
  // the fp32 logits after it (i2t_attention.py:41): the scale is 1/4 at
  // head width 16, a power of two, so both give the same bits.
  for (int it = tid; it < kRows * kHeads; it += kImgThreads) {
    const int r = it / kHeads, h = it % kHeads;
    const T* qp = q_img + (static_cast<int64_t>(cand) * N + r0 + r) * kI + h * kCrossD;
    float q[kCrossD];
#pragma unroll
    for (int i = 0; i < kCrossD; i += 2) {
      float a, b;
      E::get2(qp + i, a, b);
      q[i] = E::round(a * cross_scale);
      q[i + 1] = E::round(b * cross_scale);
    }
    float l[kMaxTok], m = -INFINITY;
#pragma unroll
    for (int tt = 0; tt < kMaxTok; ++tt) {
      if (tt >= nt) break;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < kCrossD; ++d) s += q[d] * sKi[tt * kI + h * kCrossD + d];
      l[tt] = s;
      m = fmaxf(m, s);
    }
    float sum = 0.f;
#pragma unroll
    for (int tt = 0; tt < kMaxTok; ++tt) {
      if (tt >= nt) break;
      l[tt] = expf(l[tt] - m);
      sum += l[tt];
    }
    float a[kCrossD];
#pragma unroll
    for (int d = 0; d < kCrossD; ++d) a[d] = 0.f;
#pragma unroll
    for (int tt = 0; tt < kMaxTok; ++tt) {
      if (tt >= nt) break;
      const float p = E::round(l[tt] / sum);
      const float* v = sVi + tt * kI + h * kCrossD;
#pragma unroll
      for (int d = 0; d < kCrossD; ++d) a[d] += p * v[d];
    }
#pragma unroll
    for (int d = 0; d < kCrossD; d += 2) E::put2(sAV + r * kLd + h * kCrossD + d, a[d], a[d + 1]);
  }
  __syncthreads();

  // out-projection [kRows x kI] x [kI -> kC] on the tensor cores
  float acc[kC / 8][4];
#pragma unroll
  for (int n = 0; n < kC / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  warp_mma<kC / 8, kI>(acc, sAV, kLd, sWo, kLd, warp * 16, lane);

  // + bias + the rows, LayerNorm over kC; each row's channels are spread
  // over the 4 lanes of a quad
  const int ra = r0 + warp * 16 + g, rb = ra + 8;
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int n = 0; n < kC / 8; ++n) {
    const int col = n * 8 + 2 * t;
    float x0, x1, x2, x3;
    load_pair<kInt8, T>(src, row, N, ra, col, sc, x0, x1);
    load_pair<kInt8, T>(src, row, N, rb, col, sc, x2, x3);
    acc[n][0] += bo_ln[col] + x0;
    acc[n][1] += bo_ln[col + 1] + x1;
    acc[n][2] += bo_ln[col] + x2;
    acc[n][3] += bo_ln[col + 1] + x3;
    sa += acc[n][0] + acc[n][1];
    sb += acc[n][2] + acc[n][3];
  }
  const float ma = quad_sum(sa) / kC, mb = quad_sum(sb) / kC;
  float va = 0.f, vb = 0.f;
#pragma unroll
  for (int n = 0; n < kC / 8; ++n) {
    va += (acc[n][0] - ma) * (acc[n][0] - ma) + (acc[n][1] - ma) * (acc[n][1] - ma);
    vb += (acc[n][2] - mb) * (acc[n][2] - mb) + (acc[n][3] - mb) * (acc[n][3] - mb);
  }
  const float ia = rsqrtf(quad_sum(va) / kC + eps), ib = rsqrtf(quad_sum(vb) / kC + eps);
  const float* s4 = bo_ln + kC;
  const float* b4 = bo_ln + 2 * kC;
  T* oa = out + (static_cast<int64_t>(cand) * N + ra) * kC;
  T* ob = out + (static_cast<int64_t>(cand) * N + rb) * kC;
#pragma unroll
  for (int n = 0; n < kC / 8; ++n) {
    const int col = n * 8 + 2 * t;
    E::put2(oa + col, (acc[n][0] - ma) * ia * s4[col] + b4[col],
            (acc[n][1] - ma) * ia * s4[col + 1] + b4[col + 1]);
    E::put2(ob + col, (acc[n][2] - mb) * ib * s4[col] + b4[col],
            (acc[n][3] - mb) * ib * s4[col + 1] + b4[col + 1]);
  }
}

template <typename T, bool kInt8>
int launch_i2t(const void* src, const int* idx, const float* scale, int S, int n, int nt, int N,
               const void* q_img, const void* k_i, const void* v_i, const void* wo,
               const float* bo_ln, float eps, float cross_scale, void* out, cudaStream_t stream) {
  auto kernel = twl_image_i2t_kernel<T, kInt8>;
  const size_t smem = smem_i2t<T>(nt);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(N / kRows, n), kImgThreads, smem, stream>>>(
      src, idx, scale, S, N, static_cast<const T*>(q_img), static_cast<const T*>(k_i),
      static_cast<const T*>(v_i), nt, static_cast<const T*>(wo), bo_ln, eps, cross_scale,
      static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace

// src/idx/scale/S as for cor_t2i_image_pass; q_img T [n][N][128]; k_i, v_i
// T [n][n_tok][128]; wo T [256][128]; bo_ln4 fp32 [3][256]; keys_out T
// [n][N][256]. Also K8b (ops/kernels/i2t_attention.py): bf16 or fp32 rows,
// no idx, the tokens' keys and values from its caller.
extern "C" int cor_twl_image_i2t(const void* src, int src_int8, const void* idx,
                                 const void* scale, int S, int n, int n_tok, int N,
                                 const void* q_img, const void* k_i, const void* v_i,
                                 const void* wo, const void* bo_ln4, float eps, float cross_scale,
                                 void* keys_out, int f32, void* stream) {
  if (n < 1 || n > 65535 || n_tok < 1 || n_tok > kMaxTok || N < kRows || N % kRows || S < 1 ||
      (src_int8 && (!scale || !idx)))
    return cudaErrorInvalidValue;
  const int* ip = static_cast<const int*>(idx);
  const float* sp = static_cast<const float*>(scale);
  const float* bl = static_cast<const float*>(bo_ln4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto launch) {
    return launch(src, ip, sp, S, n, n_tok, N, q_img, k_i, v_i, wo, bl, eps, cross_scale,
                  keys_out, s);
  };
  if (f32) return src_int8 ? go(launch_i2t<float, true>) : go(launch_i2t<float, false>);
  return src_int8 ? go(launch_i2t<uint16_t, true>) : go(launch_i2t<uint16_t, false>);
}
