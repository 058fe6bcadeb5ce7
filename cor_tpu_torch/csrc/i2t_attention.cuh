// Stage 4 of the two-way layer (the first K1 and K8b) as __device__ bodies that take
// their work item (a 64-row tile of a candidate) as arguments: i2t_attention.cu
// wraps them in a kernel of one tile per CTA (the first K1-dma ran the tile
// body over several tiles per CTA behind a cp.async ring).
// i2t_attention.cu says what the stage computes and what bounds it.
#pragma once

#include "decoder_common.cuh"

namespace cor {

// the out-projection weight [kC][kLdI] and the attention output [kRows][kLdI]
// in T, the tokens' keys and values [nt][kI] fp32 (K1's layout)
template <typename T>
__host__ __device__ constexpr size_t smem_i2t(int nt) {
  return sizeof(T) * (kC * Elem<T>::kLdI + kRows * Elem<T>::kLdI) + sizeof(float) * 2 * nt * kI;
}

// One 64-row tile, the tokens' keys and values (sKi, sVi: [nt][kI] fp32) in
// shared memory: per (row, head) the softmax over the nt tokens and its
// product with the values into av, the out-projection [kI -> kC] on the
// tensor cores, + bias + the rows, LN4, the new rows into out_tile. q_tile
// [kRows][ldq] (device or shared memory) holds the queries; av [kRows][ldav]
// is shared memory and may be q_tile itself (each (row, head) is read, then
// written, by one thread); rows_tile [kRows][ldr] of the source type (device
// or shared memory). kWoK == kI: wo [kC][ldw] staged whole in shared memory
// by the caller; kWoK < kI: wo is the weight [kC][kI] in device memory,
// staged here block by block (kC outputs x kWoK inputs) through sWo, the
// same products in the same k order (the same bits).
template <typename T, bool kInt8, int kWoK = kI>
__device__ __forceinline__ void i2t_tile_compute(
    const T* q_tile, int ldq, T* av, int ldav, const void* rows_tile, int ldr, float sc,
    const T* wo, int ldw, T* sWo,
    const float* __restrict__ bo_ln,  // bo [kC], ln4 scale [kC], bias [kC]
    const float* sKi, const float* sVi, int nt, float eps, float cross_scale,
    T* __restrict__ out_tile) {  // [kRows][kC]
  using E = Elem<T>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  // per (row, head): softmax over the nt tokens, product with the values.
  // The loops over the tokens unroll to kMaxTok and stop at nt, so that l
  // stays in registers; they add in the token order at every nt. The query
  // is scaled and rounded before the product, where cor_tpu's K8b scales
  // the fp32 logits after it (i2t_attention.py:41): the scale is 1/4 at
  // head width 16, a power of two, so both give the same bits.
  for (int it = tid; it < kRows * kHeads; it += kImgThreads) {
    const int r = it / kHeads, h = it % kHeads;
    const T* qp = q_tile + static_cast<int64_t>(r) * ldq + h * kCrossD;
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
    for (int d = 0; d < kCrossD; d += 2) E::put2(av + r * ldav + h * kCrossD + d, a[d], a[d + 1]);
  }
  __syncthreads();

  // out-projection [kRows x kI] x [kI -> kC] on the tensor cores
  float acc[kC / 8][4];
#pragma unroll
  for (int n = 0; n < kC / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  if constexpr (kWoK == kI) {
    warp_mma<kC / 8, kI>(acc, av, ldav, wo, ldw, warp * 16, lane);
  } else {
    constexpr int kVec = 16 / sizeof(T), kLdB = kWoK + (sizeof(T) == 2 ? 8 : 4);
#pragma unroll 1
    for (int kh = 0; kh < kI / kWoK; ++kh) {
      if (kh) __syncthreads();  // the previous block consumed
      for (int i = tid; i < kC * (kWoK / kVec); i += kImgThreads) {
        const int o = i / (kWoK / kVec), cv = (i % (kWoK / kVec)) * kVec;
        *reinterpret_cast<uint4*>(sWo + o * kLdB + cv) = *reinterpret_cast<const uint4*>(
            wo + static_cast<int64_t>(o) * kI + kh * kWoK + cv);
      }
      __syncthreads();
      warp_mma<kC / 8, kWoK>(acc, av + kh * kWoK, ldav, sWo, kLdB, warp * 16, lane);
    }
  }

  // + bias + the rows, LayerNorm over kC; each row's channels are spread
  // over the 4 lanes of a quad
  const int ra = warp * 16 + g, rb = ra + 8;
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int n = 0; n < kC / 8; ++n) {
    const int col = n * 8 + 2 * t;
    float x0, x1, x2, x3;
    tile_pair<kInt8, T>(rows_tile, ldr, ra, col, sc, x0, x1);
    tile_pair<kInt8, T>(rows_tile, ldr, rb, col, sc, x2, x3);
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
  T* oa = out_tile + static_cast<int64_t>(ra) * kC;
  T* ob = out_tile + static_cast<int64_t>(rb) * kC;
#pragma unroll
  for (int n = 0; n < kC / 8; ++n) {
    const int col = n * 8 + 2 * t;
    E::put2(oa + col, (acc[n][0] - ma) * ia * s4[col] + b4[col],
            (acc[n][1] - ma) * ia * s4[col + 1] + b4[col + 1]);
    E::put2(ob + col, (acc[n][2] - mb) * ib * s4[col] + b4[col],
            (acc[n][3] - mb) * ib * s4[col + 1] + b4[col + 1]);
  }
}

// K1's stage 4 for one tile of candidate `cand`: the out-projection weight
// and the tokens' keys and values staged into shared memory (K1's layout),
// then i2t_tile_compute with the queries and rows read from device memory.
template <typename T, bool kInt8>
__device__ __forceinline__ void i2t_tile(
    unsigned char* smem, const void* __restrict__ src, const int* __restrict__ idx,
    const float* __restrict__ scale, int S, int N,
    const T* __restrict__ q_img,  // [n][N][kI]
    const T* __restrict__ k_i, const T* __restrict__ v_i,  // [n][nt][kI]
    int nt,
    const T* __restrict__ wo,     // [kC][kI]
    const float* __restrict__ bo_ln, float eps, float cross_scale, T* __restrict__ out,
    int tile, int cand) {
  using E = Elem<T>;
  constexpr int kLd = E::kLdI;
  constexpr int kVec = 16 / sizeof(T);  // values per 16-byte chunk
  T* sWo = reinterpret_cast<T*>(smem);
  T* sAV = sWo + kC * kLd;
  float* sKi = reinterpret_cast<float*>(sAV + kRows * kLd);
  float* sVi = sKi + nt * kI;
  const int tid = threadIdx.x;
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
  i2t_tile_compute<T, kInt8>(q_img + (static_cast<int64_t>(cand) * N + r0) * kI, kI, sAV, kLd,
                             row_tile<kInt8, T>(src, row, N, r0), kC, sc, sWo, kLd, nullptr,
                             bo_ln, sKi, sVi, nt, eps, cross_scale,
                             out + (static_cast<int64_t>(cand) * N + r0) * kC);
}

}  // namespace cor
