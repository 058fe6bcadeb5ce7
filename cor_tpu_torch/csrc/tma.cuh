// The Tensor Memory Accelerator's copies of K1-dma (two_way_layer_dma.cu)
// and K9 (upscale.cu): tiles of a row-major matrix brought into shared memory
// by TMA tensor copies, 1-D bulk copies, and bulk stores of shared memory
// back to device memory.
//
// A tile lands in wgmma's K-major core-matrix layout without swizzling
// (wgmma.cuh) as its 16-byte column chunks: a 2-D tensor map over the matrix
// [rows][cols] with a box of 16 bytes x 64 rows, one copy per chunk c, puts
// rows r0 .. r0 + 63 of chunk c at byte c * 1024 of the tile: [chunk][row][16
// bytes]. wgmma reads that as an operand whose next 8 columns of K are 1024
// bytes on (LBO) and whose next 8 rows are 128 bytes on (SBO): desc_chunks. A
// single 3-D box (16 bytes, 64 rows, the chunks) would land the same tile in
// one copy, but its chunk stride (16 bytes) below its row stride is outside
// what CUDA documents for a tensor map; the copies cost one instruction
// each and move the same 16-byte pieces. Rows past the matrix come in as
// zeros, and a copy always counts its whole box on the barrier.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace cor {
namespace tma {

// Host side: cuTensorMapEncodeTiled, looked up once through the CUDA
// runtime (no link against libcuda). Internal linkage: each library keeps
// its own.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
static inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map over the row-major matrix at base, [rows][cols] of elem_bytes
// (1, 2 or 4) each, with a box of 16 bytes x box_rows rows. Returns
// cudaErrorInvalidValue where CUDA refuses it.
static inline cudaError_t chunk_map(CUtensorMap* map, const void* base, uint64_t rows,
                                    uint64_t cols, int elem_bytes, uint32_t box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const CUtensorMapDataType type = elem_bytes == 1   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                   : elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16
                                                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(16 / elem_bytes), box_rows};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(base), dims, strides, box, steps,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The box of `map` at (column col, row row) into shared memory at dst, its
// bytes completed on bar (armed by mbar_expect_tx)
__device__ __forceinline__ void load_box(void* dst, const CUtensorMap* map, int col, int row,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(wg::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(wg::smem_u32(bar))
      : "memory");
}

// Rows r0 .. r0 + 63 of the matrix behind `map` as `chunks` 16-byte column
// chunks into tile ([chunk][row][16 bytes]), on bar: one thread
__device__ __forceinline__ void load_chunks(unsigned char* tile, const CUtensorMap* map,
                                            int chunks, int elem_bytes, int r0, uint64_t* bar) {
  for (int c = 0; c < chunks; ++c) load_box(tile + c * 1024, map, c * (16 / elem_bytes), r0, bar);
}

// A descriptor of k-step kc (16 bf16 or 8 fp32 columns: 2 chunks) of a
// 64-row tile laid out as its chunks
__device__ __forceinline__ uint64_t desc_chunks(uint32_t addr, int kc) {
  return wg::desc(addr + kc * 2048, 1024, 128);
}

// Bulk stores: `bytes` (a multiple of 16) of shared memory at src to device
// memory at dst, in this thread's bulk group; commit the group; wait until
// the thread's groups have read their shared memory (it may then be written)
__device__ __forceinline__ void store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(wg::smem_u32(src)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

}  // namespace tma
}  // namespace cor
