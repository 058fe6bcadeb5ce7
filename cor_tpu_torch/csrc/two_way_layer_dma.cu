// K1-dma: the two-way layer of two_way_layer.cu (K1) with its two image
// passes made persistent over the row tiles of a candidate, each CTA
// bringing tile j+1's rows into a second shared-memory stage with cp.async
// while tile j computes.
//
// Replaces the TPU kernel cor_tpu/ops/pallas/two_way_layer.py:
// two_way_layer_dma (_dma_kernel; its pallas_call at line 610), which
// computes K1's function with the keys left in HBM and double-buffered into
// VMEM by the kernel itself (pltpu.make_async_copy), because the
// auto-pipelined layer kernel ran its keys' DMA and its body one after the
// other (tools/decode_bench.py:4-8). K1 on the H100 has the same fault in
// its own form: its image passes load a tile's rows synchronously
// (load_rows: 16-byte loads, then stores to shared memory) and only then
// compute, one tile per CTA, so no load overlaps a product.
//
// The layer is K1's four launches: the token kernels of two_way_layer.cu and
// two_way_layer_mid.cu as they are, and the two image passes here, each a
// grid of (ceil(N/64 / kDmaTiles), n) CTAs of 4 warps, a CTA walking
// kDmaTiles consecutive 64-row tiles of one candidate:
//
//  - t2i pass: the rows of tile j+1 (an int8 store row gathered through idx
//    and copied raw, then dequantised on the way out of shared memory, as
//    load_rows does it) stream into the other of two stages while tile j
//    runs t2i_tile_compute (t2i_flash.cuh), the body of K1's image pass;
//    the candidate's queries are loaded once per CTA.
//  - i2t pass: the ring holds tile j+1's q_img rows and key rows (for the
//    residual); the attention output is written over the tile's q_img stage
//    in place (each (row, head) read, then written, by one thread), and
//    i2t_tile_compute (i2t_attention.cuh) runs as in K1; the out-projection
//    weight (bf16) and the tokens' keys and values are staged once per CTA,
//    not once per tile.
//
// The ring covers the rows (and q_img), not the t2i pass's weight blocks,
// which are restaged between barriers per tile as in K1 (in fp32 in
// narrower blocks, below). Every sum is K1's, in K1's order, and the
// partials are K1's per-tile partials, so the outputs are K1's bit for bit,
// in bf16 and fp32.
//
// Shared memory, and what fp32 forced: K1's fp32 image pass already stages
// 204,800 B (rows [64][260], the weight block [128][132], k and v
// [64][132]); a second fp32 row stage (66,560 B) would take it to 271,360 B,
// above the 232,448 B a block may take, and 32-row half-tile stages do not
// fit either. So the fp32 passes keep two whole row stages and stage their
// weights in narrower blocks: the t2i pass in [128][32 + 4] blocks (8 per
// 256-wide projection instead of K1's 2), the logits in that space,
// 2 x 66,560 + 18,432 + 67,584 (k, v) + 512 T B (223,232 at T = 8); the i2t
// pass its out-projection weight in [256][16 + 4] blocks, 8 per tile:
// 20,480 + 1,024 T + 2 x (33,792 + 66,560) B (229,376 at T = 8). The blocks
// take the same products in the same k order, so the bits stay K1's. bf16:
// t2i 2 x 33,792 + 34,816 + 34,816 + 512 T B (the logits in the weight
// block's space), i2t 69,632 (the weight, once per CTA) + 1,024 T + 2 x
// (17,408 + 33,792) B; an int8 store's raw stage is [64][256] bytes (t2i:
// plus one dequantised [64][kLdC] tile) and [64][272] (i2t).
//
// What bounds it on the H100: as K1 (two_way_layer.cu), the image passes'
// bytes (the rows twice, q_img out and in, the new rows) and their tensor-
// core products; the ring lets a tile's loads run under the previous tile's
// products. One CTA per SM at these sizes (K1's bf16 image pass fits two),
// 4 warps, no wgmma or TMA: a first version, right before fast.

#include "i2t_attention.cuh"
#include "t2i_flash.cuh"

namespace {

using namespace cor;

constexpr int kDmaTiles = 8;  // 64-row tiles per CTA

// bytes of one stage's row tile: raw int8 [kRows][kC], or the compute dtype
// [kRows][kLdC] (t2i) / [kRows][ld] (i2t)
template <typename T, bool kInt8>
struct DmaT2i {
  static constexpr int kWK = sizeof(T) == 2 ? kI : 32;  // the weight blocks' k-width
  static constexpr size_t kStage =
      kInt8 ? size_t(kRows) * kC : sizeof(T) * kRows * Elem<T>::kLdC;
  static constexpr size_t kRowsTile = kInt8 ? sizeof(T) * kRows * Elem<T>::kLdC : 0;
  static constexpr size_t kW = sizeof(T) * kI * weight_block_ld<T, kWK>();
  static constexpr size_t kKV = sizeof(T) * kRows * Elem<T>::kLdI;
  static __host__ __device__ bool logits_own(int nt) { return logits_bytes(nt) > kW; }
  static __host__ __device__ size_t bytes(int nt) {
    return 2 * kStage + kRowsTile + kW + 2 * kKV + sizeof(float) * nt * kI +
           (logits_own(nt) ? logits_bytes(nt) : 0);
  }
};

template <typename T, bool kInt8>
__global__ void __launch_bounds__(kImgThreads)
dma_t2i_kernel(const void* __restrict__ src, const int* __restrict__ idx,
               const float* __restrict__ scale, int S, int N, const T* __restrict__ w,
               const float* __restrict__ b, const T* __restrict__ kpe,
               const T* __restrict__ qpe, const T* __restrict__ qt, int nt,
               T* __restrict__ q_img, float* __restrict__ part_m, float* __restrict__ part_l,
               float* __restrict__ part_acc) {
  using L = DmaT2i<T, kInt8>;
  using E = Elem<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* stage[2] = {smem, smem + L::kStage};
  unsigned char* p = smem + 2 * L::kStage;
  ImageSmem<T> s;
  s.rows = kInt8 ? reinterpret_cast<T*>(p) : nullptr;
  p += L::kRowsTile;
  s.w = reinterpret_cast<T*>(p);
  p += L::kW;
  s.k = reinterpret_cast<T*>(p);
  s.v = s.k + kRows * E::kLdI;
  s.qt = reinterpret_cast<float*>(s.v + kRows * E::kLdI);
  s.l = L::logits_own(nt) ? s.qt + nt * kI : reinterpret_cast<float*>(s.w);

  const int tiles = N / kRows, cand = blockIdx.y, tid = threadIdx.x;
  const int t0 = blockIdx.x * kDmaTiles, t1 = min(t0 + kDmaTiles, tiles);
  const int row = source_row(idx, cand, S);
  const float sc = kInt8 ? scale[row] : 1.f;
  // a stage's rows: raw int8 [kRows][kC], or K1's padded compute-dtype tile
  constexpr int kLdBytes = kInt8 ? kC : int(sizeof(T)) * E::kLdC;
  constexpr int kRowBytes = kInt8 ? kC : int(sizeof(T)) * kC;

  copy_tile_async(stage[0], kLdBytes, src, row, N, t0 * kRows, kRowBytes, tid, kImgThreads);
  cp_async_commit();
  for (int i = tid; i < nt * kI; i += kImgThreads)
    s.qt[i] = E::get(qt[static_cast<int64_t>(cand) * nt * kI + i]);
#pragma unroll 1
  for (int tile = t0; tile < t1; ++tile) {
    const int cur = (tile - t0) & 1;
    if (tile + 1 < t1) {
      // the other stage held tile - 1, done with at the last iteration's barrier
      copy_tile_async(stage[cur ^ 1], kLdBytes, src, row, N, (tile + 1) * kRows, kRowBytes,
                      tid, kImgThreads);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the tile's rows (and the queries) seen by every thread
    if constexpr (kInt8) {
      dequant_rows<T>(s.rows, reinterpret_cast<const int8_t*>(stage[cur]), sc, tid, kImgThreads);
      __syncthreads();
    } else {
      s.rows = reinterpret_cast<T*>(stage[cur]);
    }
    t2i_tile_compute<T, true, L::kWK>(s, N, w, b, kpe, qpe, nt, q_img, part_m, part_l, part_acc,
                                      tile, tiles, cand);
    __syncthreads();  // the stage and the tile's buffers free for the next tile
  }
}

template <typename T, bool kInt8>
struct DmaI2t {
  // bf16: the out-projection weight staged whole, once per CTA; fp32: in
  // blocks of kC x 16 per tile
  static constexpr bool kStageWo = sizeof(T) == 2;
  static constexpr int kWoK = kStageWo ? kI : 16;
  static constexpr int kLdR = kInt8 ? kC + 16 : Elem<T>::kLdC;  // rows' stride, source type
  static constexpr size_t kQ = sizeof(T) * kRows * Elem<T>::kLdI;
  static constexpr size_t kR = (kInt8 ? 1 : sizeof(T)) * size_t(kRows) * kLdR;
  static constexpr size_t kWo = sizeof(T) * kC * (kStageWo ? Elem<T>::kLdI : kWoK + 4);
  static __host__ __device__ size_t bytes(int nt) {
    return kWo + sizeof(float) * 2 * nt * kI + 2 * (kQ + kR);
  }
};

template <typename T, bool kInt8>
__global__ void __launch_bounds__(kImgThreads)
dma_i2t_kernel(const void* __restrict__ src, const int* __restrict__ idx,
               const float* __restrict__ scale, int S, int N, const T* __restrict__ q_img,
               const T* __restrict__ k_i, const T* __restrict__ v_i, int nt,
               const T* __restrict__ wo, const float* __restrict__ bo_ln, float eps,
               float cross_scale, T* __restrict__ out) {
  using L = DmaI2t<T, kInt8>;
  using E = Elem<T>;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kElem = kInt8 ? 1 : int(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  T* sWo = reinterpret_cast<T*>(smem);
  float* sKi = reinterpret_cast<float*>(smem + L::kWo);
  float* sVi = sKi + nt * kI;
  unsigned char* ring = reinterpret_cast<unsigned char*>(sVi + nt * kI);
  T* sQ[2] = {reinterpret_cast<T*>(ring), reinterpret_cast<T*>(ring + L::kQ + L::kR)};
  unsigned char* sR[2] = {ring + L::kQ, ring + 2 * L::kQ + L::kR};

  const int tiles = N / kRows, cand = blockIdx.y, tid = threadIdx.x;
  const int t0 = blockIdx.x * kDmaTiles, t1 = min(t0 + kDmaTiles, tiles);
  const int row = source_row(idx, cand, S);
  const float sc = kInt8 ? scale[row] : 1.f;
  auto prefetch = [&](int buf, int tile) {
    copy_tile_async(sQ[buf], int(sizeof(T)) * E::kLdI, q_img, cand, N, tile * kRows,
                    int(sizeof(T)) * kI, tid, kImgThreads);
    copy_tile_async(sR[buf], kElem * L::kLdR, src, row, N, tile * kRows, kElem * kC, tid,
                    kImgThreads);
    cp_async_commit();
  };

  prefetch(0, t0);
  if constexpr (L::kStageWo) {
    for (int i = tid; i < kC * (kI / kVec); i += kImgThreads) {
      const int o = i / (kI / kVec), cv = (i % (kI / kVec)) * kVec;
      *reinterpret_cast<uint4*>(sWo + o * E::kLdI + cv) =
          *reinterpret_cast<const uint4*>(wo + static_cast<int64_t>(o) * kI + cv);
    }
  }
  for (int i = tid; i < nt * kI; i += kImgThreads) {
    sKi[i] = E::get(k_i[static_cast<int64_t>(cand) * nt * kI + i]);
    sVi[i] = E::get(v_i[static_cast<int64_t>(cand) * nt * kI + i]);
  }
#pragma unroll 1
  for (int tile = t0; tile < t1; ++tile) {
    const int cur = (tile - t0) & 1;
    if (tile + 1 < t1) {
      prefetch(cur ^ 1, tile + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the tile's q_img and rows seen by every thread
    i2t_tile_compute<T, kInt8, L::kWoK>(sQ[cur], E::kLdI, sQ[cur], E::kLdI, sR[cur], L::kLdR,
                                        sc, L::kStageWo ? sWo : wo, L::kStageWo ? E::kLdI : kI,
                                        sWo, bo_ln, sKi, sVi, nt, eps, cross_scale,
                               out + (static_cast<int64_t>(cand) * N + tile * kRows) * kC);
    __syncthreads();  // the stage free for the tile after next
  }
}

template <typename T, bool kInt8>
int launch_t2i(const void* src, const int* idx, const float* scale, int S, int n, int nt, int N,
               const void* w, const float* b, const void* kpe, const void* qpe, const void* qt,
               void* q_img, float* pm, float* pl, float* pa, cudaStream_t stream) {
  auto kernel = dma_t2i_kernel<T, kInt8>;
  const size_t smem = DmaT2i<T, kInt8>::bytes(nt);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles = N / kRows;
  kernel<<<dim3((tiles + kDmaTiles - 1) / kDmaTiles, n), kImgThreads, smem, stream>>>(
      src, idx, scale, S, N, static_cast<const T*>(w), b, static_cast<const T*>(kpe),
      static_cast<const T*>(qpe), static_cast<const T*>(qt), nt, static_cast<T*>(q_img), pm, pl,
      pa);
  return cudaGetLastError();
}

template <typename T, bool kInt8>
int launch_i2t(const void* src, const int* idx, const float* scale, int S, int n, int nt, int N,
               const void* q_img, const void* k_i, const void* v_i, const void* wo,
               const float* bo_ln, float eps, float cross_scale, void* out,
               cudaStream_t stream) {
  auto kernel = dma_i2t_kernel<T, kInt8>;
  const size_t smem = DmaI2t<T, kInt8>::bytes(nt);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles = N / kRows;
  kernel<<<dim3((tiles + kDmaTiles - 1) / kDmaTiles, n), kImgThreads, smem, stream>>>(
      src, idx, scale, S, N, static_cast<const T*>(q_img), static_cast<const T*>(k_i),
      static_cast<const T*>(v_i), nt, static_cast<const T*>(wo), bo_ln, eps, cross_scale,
      static_cast<T*>(out));
  return cudaGetLastError();
}

bool bad_geometry(int n, int n_tok, int N, int S, int src_int8, const void* idx,
                  const void* scale) {
  return n < 1 || n > 65535 || n_tok < 5 || n_tok > 8 || N < kRows || N % kRows || S < 1 ||
         (src_int8 && (!scale || !idx));
}

}  // namespace

// K1-dma's stage 2 (t2i pass, q_img always written) and stage 4 (i2t pass),
// with the arguments of cor_t2i_image_pass and cor_twl_image_i2t; n_tok: 5
// to 8 (the layer's token kernels), f32: the compute dtype.
extern "C" int cor_twl_dma_image_t2i(const void* src, int src_int8, const void* idx,
                                     const void* scale, int S, int n, int n_tok, int N,
                                     const void* w, const void* b, const void* kpe,
                                     const void* qpe, const void* qt, void* q_img, void* part_m,
                                     void* part_l, void* part_acc, int f32, void* stream) {
  if (bad_geometry(n, n_tok, N, S, src_int8, idx, scale) || !qpe || !q_img)
    return cudaErrorInvalidValue;
  auto go = [&](auto launch) {
    return launch(src, static_cast<const int*>(idx), static_cast<const float*>(scale), S, n,
                  n_tok, N, w, static_cast<const float*>(b), kpe, qpe, qt, q_img,
                  static_cast<float*>(part_m), static_cast<float*>(part_l),
                  static_cast<float*>(part_acc), static_cast<cudaStream_t>(stream));
  };
  if (f32) return src_int8 ? go(launch_t2i<float, true>) : go(launch_t2i<float, false>);
  return src_int8 ? go(launch_t2i<uint16_t, true>) : go(launch_t2i<uint16_t, false>);
}

extern "C" int cor_twl_dma_image_i2t(const void* src, int src_int8, const void* idx,
                                     const void* scale, int S, int n, int n_tok, int N,
                                     const void* q_img, const void* k_i, const void* v_i,
                                     const void* wo, const void* bo_ln4, float eps,
                                     float cross_scale, void* keys_out, int f32, void* stream) {
  if (bad_geometry(n, n_tok, N, S, src_int8, idx, scale)) return cudaErrorInvalidValue;
  auto go = [&](auto launch) {
    return launch(src, static_cast<const int*>(idx), static_cast<const float*>(scale), S, n,
                  n_tok, N, q_img, k_i, v_i, wo, static_cast<const float*>(bo_ln4), eps,
                  cross_scale, keys_out, static_cast<cudaStream_t>(stream));
  };
  if (f32) return src_int8 ? go(launch_i2t<float, true>) : go(launch_i2t<float, false>);
  return src_int8 ? go(launch_i2t<uint16_t, true>) : go(launch_i2t<uint16_t, false>);
}
