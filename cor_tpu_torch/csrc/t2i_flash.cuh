// The image pass of the token -> image attention and its combine, as
// __device__ bodies that take their work item (a 64-row tile of a candidate,
// or a candidate) as arguments: t2i_flash.cu wraps each in a kernel of one
// work item per CTA (the first K1, K2 and K8a; the first K1-dma ran the tile
// body over several tiles per CTA behind a cp.async ring).
// t2i_flash.cu says what the pass computes and what bounds it.
#pragma once

#include "decoder_common.cuh"

namespace cor {

constexpr int kLdL = kRows + 1;
// rows [kRows][kLdC], a 128 x 128 weight block [kI][kLdI], k and v [kRows][kLdI]
// in T, the queries [nt][kI] fp32, and the logits [8 nt][kLdL] fp32 where they
// do not fit in the weight block's space
template <typename T>
__host__ __device__ constexpr size_t weight_block_bytes() {
  return sizeof(T) * kI * Elem<T>::kLdI;
}
__host__ __device__ constexpr size_t logits_bytes(int nt) {
  return sizeof(float) * kHeads * nt * kLdL;
}
template <typename T>
__host__ __device__ constexpr size_t smem_image(int nt) {
  return sizeof(T) * (kRows * Elem<T>::kLdC + 2 * kRows * Elem<T>::kLdI) +
         weight_block_bytes<T>() + sizeof(float) * nt * kI +
         (logits_bytes(nt) > weight_block_bytes<T>() ? logits_bytes(nt) : 0);
}

// The image pass's shared memory: the rows, the weight block (null when the
// weights are read from device memory), k, v, the queries and the logits.
template <typename T>
struct ImageSmem {
  T* rows;
  T* w;
  T* k;
  T* v;
  float* qt;
  float* l;
};

// K1's layout (smem_image): rows, weight block, k, v, queries, and the
// logits in the weight block's space where they fit, else after the queries
template <typename T>
__device__ __forceinline__ ImageSmem<T> image_smem(unsigned char* smem, int nt) {
  ImageSmem<T> s;
  s.rows = reinterpret_cast<T*>(smem);
  s.w = s.rows + kRows * Elem<T>::kLdC;
  s.k = s.w + kI * Elem<T>::kLdI;
  s.v = s.k + kRows * Elem<T>::kLdI;
  s.qt = reinterpret_cast<float*>(s.v + kRows * Elem<T>::kLdI);
  s.l = logits_bytes(nt) > weight_block_bytes<T>() ? s.qt + nt * kI
                                                    : reinterpret_cast<float*>(s.w);
  return s;
}

// The padded row stride of a weight block kWK values wide (4 banks apart in
// bf16, 4 mod 8 words in fp32, as kLdI).
template <typename T, int kWK>
__host__ __device__ constexpr int weight_block_ld() {
  return kWK + (sizeof(T) == 2 ? 8 : 4);
}

// One 64-row tile (`tile` of `tiles`) of candidate `cand`: its rows
// (s.rows) and the scaled queries (s.qt) already in shared memory, their
// packed [k | v (| q)] projection on the tensor cores against the weight
// staged through s.w in blocks of 128 outputs x kWK inputs (K1: 128 x 128;
// the first block's barrier makes the rows visible), q_img written out
// (kEmitQ), and the tile's flash partials. Narrower blocks take the same
// products in the same k order, so any kWK gives the same bits.
template <typename T, bool kEmitQ, int kWK = kI>
__device__ __forceinline__ void t2i_tile_compute(
    const ImageSmem<T>& s, int N,
    const T* __restrict__ w,    // [(2 or 3) * kI][kC]: k | v (| q)
    const float* __restrict__ b,  // [(2 or 3) * kI]
    const T* __restrict__ kpe,  // [N][kI]
    const T* __restrict__ qpe,  // [N][kI] (kEmitQ)
    int nt,
    T* __restrict__ q_img,      // [n][N][kI] (kEmitQ)
    float* __restrict__ part_m, float* __restrict__ part_l, float* __restrict__ part_acc,
    int tile, int tiles, int cand) {
  using E = Elem<T>;
  constexpr int kLdR = E::kLdC, kLdW = weight_block_ld<T, kWK>(), kLdKV = E::kLdI;
  constexpr int kVec = 16 / sizeof(T);  // values per 16-byte chunk
  const int nq = kHeads * nt;  // (head, token) query rows
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, t = lane & 3;
  const int r0 = tile * kRows;

  constexpr int kChunks = kEmitQ ? 3 : 2;
  const int ra = warp * 16 + (lane >> 2), rb = ra + 8;
#pragma unroll 1
  for (int c = 0; c < kChunks; ++c) {
    float acc[kI / 8][4];
#pragma unroll
    for (int n = 0; n < kI / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll 1
    for (int kh = 0; kh < kC / kWK; ++kh) {
      __syncthreads();  // rows loaded; the previous weight block consumed
      for (int i = tid; i < kI * (kWK / kVec); i += kImgThreads) {
        const int o = i / (kWK / kVec), cv = (i % (kWK / kVec)) * kVec;
        *reinterpret_cast<uint4*>(s.w + o * kLdW + cv) = *reinterpret_cast<const uint4*>(
            w + static_cast<int64_t>(c * kI + o) * kC + kh * kWK + cv);
      }
      __syncthreads();
      warp_mma<kI / 8, kWK>(acc, s.rows + kh * kWK, kLdR, s.w, kLdW, warp * 16, lane);
    }
    // epilogue: + bias (+ the PE projection for k and q), rounded to T
    const T* pe = c == 0 ? kpe : qpe;
#pragma unroll
    for (int n = 0; n < kI / 8; ++n) {
      const int col = n * 8 + 2 * t;
      const float b0 = b[c * kI + col], b1 = b[c * kI + col + 1];
      float v0 = acc[n][0] + b0, v1 = acc[n][1] + b1, v2 = acc[n][2] + b0, v3 = acc[n][3] + b1;
      if (c != 1) {
        float pa0, pa1, pb0, pb1;
        E::get2(pe + static_cast<int64_t>(r0 + ra) * kI + col, pa0, pa1);
        E::get2(pe + static_cast<int64_t>(r0 + rb) * kI + col, pb0, pb1);
        v0 += pa0;
        v1 += pa1;
        v2 += pb0;
        v3 += pb1;
      }
      if (c == 0) {
        E::put2(s.k + ra * kLdKV + col, v0, v1);
        E::put2(s.k + rb * kLdKV + col, v2, v3);
      } else if (c == 1) {
        E::put2(s.v + ra * kLdKV + col, v0, v1);
        E::put2(s.v + rb * kLdKV + col, v2, v3);
      } else {
        T* q = q_img + (static_cast<int64_t>(cand) * N + r0) * kI + col;
        E::put2(q + static_cast<int64_t>(ra) * kI, v0, v1);
        E::put2(q + static_cast<int64_t>(rb) * kI, v2, v3);
      }
    }
  }
  __syncthreads();  // k and v complete; the weight block's space is free

  // logits of the 8 nt (head, token) queries against the tile's 64 rows
  for (int e = tid; e < nq * kRows; e += kImgThreads) {
    const int q = e / kRows, r = e % kRows, h = q / nt, tt = q % nt;
    const float* qv = s.qt + tt * kI + h * kCrossD;
    const T* kv = s.k + r * kLdKV + h * kCrossD;
    float l = 0.f;
#pragma unroll
    for (int d = 0; d < kCrossD; ++d) l += qv[d] * E::get(kv[d]);
    s.l[q * kLdL + r] = l;
  }
  __syncthreads();
  const int64_t pbase = static_cast<int64_t>(cand) * tiles + tile;
  for (int q = warp; q < nq; q += kImgThreads / 32) {
    const float la = s.l[q * kLdL + lane], lb = s.l[q * kLdL + lane + 32];
    const float m = warp_max(fmaxf(la, lb));
    const float ea = expf(la - m), eb = expf(lb - m);
    const float l = warp_sum(ea + eb);
    s.l[q * kLdL + lane] = E::round(ea);  // rounded before the product with v
    s.l[q * kLdL + lane + 32] = E::round(eb);
    if (lane == 0) {
      part_m[pbase * nq + q] = m;
      part_l[pbase * nq + q] = l;
    }
  }
  __syncthreads();
  for (int o = tid; o < nq * kCrossD; o += kImgThreads) {
    const int q = o / kCrossD, d = o % kCrossD, h = q / nt;
    float acc = 0.f;
#pragma unroll 8
    for (int r = 0; r < kRows; ++r)
      acc += s.l[q * kLdL + r] * E::get(s.v[r * kLdKV + h * kCrossD + d]);
    part_acc[(pbase * nq + q) * kCrossD + d] = acc;
  }
}

// K1's image pass for one tile: the rows of source row source_row(idx,
// cand, S) (an int8 store dequantised on the way) and the candidate's
// queries loaded into shared memory (K1's layout), then t2i_tile_compute.
template <typename T, bool kInt8, bool kEmitQ>
__device__ __forceinline__ void t2i_tile(
    unsigned char* smem, const void* __restrict__ src, const int* __restrict__ idx,
    const float* __restrict__ scale, int S, int N, const T* __restrict__ w,
    const float* __restrict__ b, const T* __restrict__ kpe, const T* __restrict__ qpe,
    const T* __restrict__ qt,  // [n][nt][kI], scaled (and rounded)
    int nt, T* __restrict__ q_img, float* __restrict__ part_m, float* __restrict__ part_l,
    float* __restrict__ part_acc, int tile, int tiles, int cand) {
  const ImageSmem<T> s = image_smem<T>(smem, nt);
  const int tid = threadIdx.x;
  const int row = source_row(idx, cand, S);
  const float sc = kInt8 ? scale[row] : 1.f;
  load_rows<kInt8>(s.rows, src, row, N, tile * kRows, sc, tid, kImgThreads);
  for (int i = tid; i < nt * kI; i += kImgThreads)
    s.qt[i] = Elem<T>::get(qt[static_cast<int64_t>(cand) * nt * kI + i]);
  t2i_tile_compute<T, kEmitQ>(s, N, w, b, kpe, qpe, nt, q_img, part_m, part_l, part_acc, tile,
                              tiles, cand);
}

// The combine for candidate `cand`, as many threads as the block has:
// out[cand][t][h*16 + d] = T(sum_tiles acc * exp(m_tile - m) / sum_tiles l * exp(m_tile - m))
template <typename T>
__device__ __forceinline__ void t2i_combine_body(const float* __restrict__ part_m,
                                                 const float* __restrict__ part_l,
                                                 const float* __restrict__ part_acc, int tiles,
                                                 int nt, T* __restrict__ out, int cand) {
  const int nq = kHeads * nt;
  for (int o = threadIdx.x; o < nq * kCrossD; o += blockDim.x) {
    const int q = o / kCrossD, d = o % kCrossD, h = q / nt, tt = q % nt;
    const float v = combine_partials(part_m, part_l, part_acc,
                                     static_cast<int64_t>(cand) * tiles, tiles, nq, q, d);
    out[(static_cast<int64_t>(cand) * nt + tt) * kI + h * kCrossD + d] = Elem<T>::put(v);
  }
}

}  // namespace cor
