// K1-dma: the two-way layer of K1 with the rows moved by the kernel's own
// asynchronous copies, on K1's Hopper image passes.
//
// Replaces the TPU kernel cor_tpu/ops/pallas/two_way_layer.py:
// two_way_layer_dma (_dma_kernel; its pallas_call at line 610), which
// computes K1's function with the keys left in HBM and double-buffered into
// VMEM by the kernel itself (pltpu.make_async_copy): the next group's rows
// come in while this group computes, the updated rows go out while the next
// group computes.
//
// The layer is K1's four launches: K1's token stages (twl_tokens_in.cu,
// twl_tokens_mid.cu: a cluster of CTAs a candidate while they all fit, else
// one CTA a candidate) and the two image passes here, which are K1's
// (twl_t2i.cuh, twl_i2t.cuh: persistent CTAs, one an SM, a producer
// warpgroup streaming the weights through shared-memory rings by TMA bulk
// copies in bf16, consumer warpgroups on wgmma) with their kDma switch. What
// the switch changes is the rows' traffic, which K1 moves thread by thread:
//
//  - t2i pass (stage 2): a group's 64-row tile of the next item comes in
//    while the group runs this item's attention arithmetic, copied by one
//    producer thread: bf16 by the TMA as its 32 column chunks of 16 bytes
//    (tma.cuh: a 2-D tensor map over the rows [S N][256]; the tile is read
//    by wgmma as [chunk][row][8], LBO 1024, SBO 128, the same products in
//    the same order as K1's core-matrix tile), fp32 as 64 row copies of 1 KB
//    into K1's [64][260] tile, an int8 store row's tile as one 16 KB bulk
//    copy of the raw bytes into the top of the row tile, which the producer's
//    row threads then dequantise in place as load_rows does it (the values
//    whose place lies below the raw bytes first, then the rest once every
//    row thread holds it in registers). Rows, a store through idx and an
//    int8 store take the same route, through idx.
//  - i2t pass (stage 4): each group's q_img tile comes in by bulk copies, a
//    row a copy issued by the 32 lanes of the producer's tile warp (bf16: its
//    rows tile too), and the new rows, written over the staged rows as K1's
//    bf16 pass does it, go out by bulk stores
//    (cp.async.bulk.global.shared::cta, a row a store, in each lane's bulk
//    group): they drain while the next item computes, and a tile is refilled
//    only after its stores' wait. K1 stores its new rows thread by thread,
//    and in fp32 reads and writes them in device memory.
//
// Every sum is K1's, in K1's order: the outputs are K1's bit for bit, in
// bf16 and fp32, from rows, a store through idx and an int8 store.
//
// Shared memory, and the stages that did not fit. K1's passes already hold
// one row tile per consumer warpgroup, filled while the warpgroup works on
// what does not read it (the t2i attention, the i2t attention and
// out-projection): that tile is the ring of row stages, a tile ahead of its
// reader. A second stage per warpgroup fits nowhere: bf16 t2i takes K1's
// 228,944 B at 8 tokens + 16 B of mbarriers for the raw tiles (a second
// 32 KB stage would take it to 261,728 B, above the 232,448 B a block may
// take), bf16 i2t K1's 220,288 B (+67,584). fp32 t2i takes K1's 222,800 B +
// 8 (+66,560 for a second stage). fp32 i2t had no rows tile at all; to stage
// its new rows it narrows the attention output, written over the q_img tile
// in place (each (row, head) read, then written, by one thread; the q_img
// tile is refilled only after the out-projection has read it), which frees
// 67,584 B for one [64][260] tile that both warpgroups take in turn, each
// once the other's stores have read it: 219,232 B. Its rows are read from
// device memory in the epilogue, as K1 reads them: brought into that tile
// by bulk copies instead, each warpgroup's rows waited for the other's
// epilogue and stores, and the pass ran slower (PERF.md). The int8 raw tiles
// lie inside the row tiles (t2i: the top 16 KB; bf16 i2t: [64][272] bytes
// under the new rows, as in K1's pass).
//
// What bounds it on the H100: K1's bytes and products (twl_t2i.cu,
// twl_i2t.cu): per candidate 2 MiB of bf16 rows (0.5 MiB as int8) read
// twice, q_img written and read, 2 MiB of new rows written, and 1.1 GFLOP of
// projections (3x that in fp32's 3xTF32 at half bf16's rate); beyond them,
// as in K1, the attention arithmetic on the CUDA cores, which no product
// overlaps.

#include "twl_i2t.cuh"
#include "twl_t2i.cuh"

namespace {

using namespace cor;

template <typename T, bool kInt8>
__global__ void __launch_bounds__(t2i_hopper::T2iL<T>::kGroups * 128 + t2i_hopper::kProd, 1)
twl_dma_t2i_kernel(const __grid_constant__ CUtensorMap rows_map, const void* __restrict__ src,
                   const int* __restrict__ idx, const float* __restrict__ scale, int S, int n,
                   int N, const T* __restrict__ w, const T* __restrict__ w_blocks,
                   const float* __restrict__ b, const T* __restrict__ kpe,
                   const T* __restrict__ qpe, const T* __restrict__ qt, int nt,
                   T* __restrict__ q_img, float* __restrict__ part_m,
                   float* __restrict__ part_l, float* __restrict__ part_acc) {
  using namespace t2i_hopper;
  extern __shared__ __align__(128) unsigned char smem[];
  t2i_pass<T, kInt8, true, false, T2iL<T>::kGroups * 128 + kProd, kFetchDepth, true,
           CtaItems<false>, true>(smem, src, idx, scale, S, n, N, w, w_blocks, b, kpe, qpe, qt,
                                  nt, q_img, part_m, part_l, part_acc, nullptr, nullptr,
                                  CtaItems<false>(), &rows_map);
}

template <typename T, bool kInt8>
__global__ void __launch_bounds__(i2t_hopper::kGroups * 128 + i2t_hopper::kProd, 1)
twl_dma_i2t_kernel(const void* __restrict__ src, const int* __restrict__ idx,
                   const float* __restrict__ scale, int S, int n, int N,
                   const T* __restrict__ q_img, const T* __restrict__ k_i,
                   const T* __restrict__ v_i, int nt, const T* __restrict__ wo,
                   const T* __restrict__ wo_blocks, const float* __restrict__ bo_ln, float eps,
                   float cross_scale, T* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  i2t_hopper::i2t_pass<T, kInt8, false, false, wg::RoundRobin, true, true>(
      smem, src, idx, scale, S, n, N, q_img, k_i, v_i, nt, wo, wo_blocks, bo_ln, eps,
      cross_scale, out);
}

// a persistent grid: one CTA an SM, or one an item
inline int grid_of(int items) {
  const int sms = wg::sm_count();
  return items < sms ? items : sms;
}

template <typename T, bool kInt8>
int launch_t2i(const void* src, const int* idx, const float* scale, int S, int n, int nt, int N,
               const void* w, const void* wb, const float* b, const void* kpe, const void* qpe,
               const void* qt, void* q_img, float* pm, float* pl, float* pa,
               cudaStream_t stream) {
  using namespace t2i_hopper;
  using M = T2iSmem<T, true, false, true>;
  static int raised[wg::kMaxDevices] = {};
  auto kernel = twl_dma_t2i_kernel<T, kInt8>;
  cudaError_t err =
      wg::raise_shared_memory(reinterpret_cast<const void*>(kernel), M::bytes(kMaxT), raised);
  if (err != cudaSuccess) return err;
  CUtensorMap map = {};  // bf16 rows only
  if (sizeof(T) == 2 && !kInt8) {
    err = tma::chunk_map(&map, src, static_cast<uint64_t>(S) * N, kC, 2, kRows);
    if (err != cudaSuccess) return err;
  }
  constexpr int G = T2iL<T>::kGroups;
  kernel<<<grid_of(n * ((N / kRows + G - 1) / G)), G * 128 + kProd, M::bytes(nt), stream>>>(
      map, src, idx, scale, S, n, N, static_cast<const T*>(w), static_cast<const T*>(wb), b,
      static_cast<const T*>(kpe), static_cast<const T*>(qpe), static_cast<const T*>(qt), nt,
      static_cast<T*>(q_img), pm, pl, pa);
  return cudaGetLastError();
}

template <typename T, bool kInt8>
int launch_i2t(const void* src, const int* idx, const float* scale, int S, int n, int nt, int N,
               const void* q_img, const void* k_i, const void* v_i, const void* wo,
               const void* wob, const float* bo_ln, float eps, float cross_scale, void* out,
               cudaStream_t stream) {
  using namespace i2t_hopper;
  static int raised[wg::kMaxDevices] = {};
  auto kernel = twl_dma_i2t_kernel<T, kInt8>;
  const int bytes = I2tSmem<T, false, true>::kBytes;
  cudaError_t err = wg::raise_shared_memory(reinterpret_cast<const void*>(kernel), bytes, raised);
  if (err != cudaSuccess) return err;
  kernel<<<grid_of(n * ((N / kRows + kGroups - 1) / kGroups)), kGroups * 128 + kProd, bytes,
           stream>>>(src, idx, scale, S, n, N, static_cast<const T*>(q_img),
                     static_cast<const T*>(k_i), static_cast<const T*>(v_i), nt,
                     static_cast<const T*>(wo), static_cast<const T*>(wob), bo_ln, eps,
                     cross_scale, static_cast<T*>(out));
  return cudaGetLastError();
}

bool bad_geometry(int n, int n_tok, int N, int S, int src_int8, const void* idx,
                  const void* scale, int f32, const void* blocks) {
  return n < 1 || n > 65535 || n_tok < 5 || n_tok > 8 || N < kRows || N % kRows || S < 1 ||
         (src_int8 && (!scale || !idx)) || (!f32 && !blocks);
}

}  // namespace

// K1-dma's stage 2 (the t2i pass, q_img written) and stage 4 (the i2t pass),
// with the arguments of K1's cor_twl_t2i and cor_twl_i2t (w_blocks and
// wo_blocks: in bf16 the weights laid out as their rings' blocks, unread in
// fp32); n_tok 5 to 8 (the layer's token stages), f32: the compute dtype. The
// same outputs as K1's, bit for bit.
extern "C" int cor_twl_dma_image_t2i(const void* src, int src_int8, const void* idx,
                                     const void* scale, int S, int n, int n_tok, int N,
                                     const void* w, const void* w_blocks, const void* b,
                                     const void* kpe, const void* qpe, const void* qt,
                                     void* q_img, void* part_m, void* part_l, void* part_acc,
                                     int f32, void* stream) {
  if (bad_geometry(n, n_tok, N, S, src_int8, idx, scale, f32, w_blocks) || !qpe || !q_img)
    return cudaErrorInvalidValue;
  auto go = [&](auto launch) {
    return launch(src, static_cast<const int*>(idx), static_cast<const float*>(scale), S, n,
                  n_tok, N, w, w_blocks, static_cast<const float*>(b), kpe, qpe, qt, q_img,
                  static_cast<float*>(part_m), static_cast<float*>(part_l),
                  static_cast<float*>(part_acc), static_cast<cudaStream_t>(stream));
  };
  if (f32) return src_int8 ? go(launch_t2i<float, true>) : go(launch_t2i<float, false>);
  return src_int8 ? go(launch_t2i<uint16_t, true>) : go(launch_t2i<uint16_t, false>);
}

extern "C" int cor_twl_dma_image_i2t(const void* src, int src_int8, const void* idx,
                                     const void* scale, int S, int n, int n_tok, int N,
                                     const void* q_img, const void* k_i, const void* v_i,
                                     const void* wo, const void* wo_blocks, const void* bo_ln4,
                                     float eps, float cross_scale, void* keys_out, int f32,
                                     void* stream) {
  if (bad_geometry(n, n_tok, N, S, src_int8, idx, scale, f32, wo_blocks))
    return cudaErrorInvalidValue;
  auto go = [&](auto launch) {
    return launch(src, static_cast<const int*>(idx), static_cast<const float*>(scale), S, n,
                  n_tok, N, q_img, k_i, v_i, wo, wo_blocks, static_cast<const float*>(bo_ln4),
                  eps, cross_scale, keys_out, static_cast<cudaStream_t>(stream));
  };
  if (f32) return src_int8 ? go(launch_i2t<float, true>) : go(launch_i2t<float, false>);
  return src_int8 ? go(launch_i2t<uint16_t, true>) : go(launch_i2t<uint16_t, false>);
}
