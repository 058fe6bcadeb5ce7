// Hopper (sm_90a) building blocks of the redesigned bf16 attention kernels
// (K4/K4' in seq_attention.cu, K6/K7 in vit_attention.cu, K6b in
// vit_attention_bwd_wgmma.cuh): warpgroup
// matrix products (wgmma.mma_async), mbarriers, and cp.async copies into the
// layout wgmma reads from shared memory.
//
// Tile layout. A tile of `rows` x (ch * 8) bf16 is stored as core matrices
// of 8 rows x 8 columns (16 bytes a row, 128 contiguous bytes): element
// (r, c) at ((r / 8) * ch + c / 8) * 64 + (r % 8) * 8 + c % 8. wgmma reads it
// without swizzling (layout type 0), as
//  - a K-major operand [M or N rows][K columns] (the logits' Q and K, dO and
//    V): the next 8 columns of K are 128 bytes on (LBO), the next 8 rows
//    ch * 128 bytes on (SBO); a k-step of 16 columns is 256 bytes;
//  - an N-major ("transposed") B operand [K rows][N columns] (V in P.V, K
//    in dQ, dO and q * scale in dV and dK: the tiles as they are stored,
//    [token][d]): the next 8 rows (along K) are ch * 128 bytes on, the next
//    8 columns (along N) 128 bytes on; a k-step of 16 rows is 2 ch * 128.
// Rows of any multiple of 16 bytes fit: head_dim 64, 72 and 80 alike (the
// 128-byte swizzle would want rows of exactly 64 bf16), and a producer warp
// places each 16-byte chunk with cp.async, zero-filling the rows past N and
// the pad columns (D = 72's logits contract over 80).
//
// The hand-over of a ring stage: each producer thread arrives on the
// stage's full barrier twice, once through cp.async.mbarrier.arrive.noinc
// (when its copies have landed) and once plainly (releasing any plain
// shared-memory stores it made), so a full barrier expects two arrivals a
// producer thread; the consumers wait
// on it, fence the async proxy (wgmma reads shared memory through it, the
// copies wrote through the generic one), and arrive on the stage's empty
// barrier once their wgmmas on it have completed. No copy waits for another:
// every stage of the ring can be in flight.
//
// Accumulators and register A operands follow mma.sync m16n8k16's layout,
// warp w of the warpgroup holding rows 16w .. 16w + 15: d[j][0..1] is row
// 16w + g, columns 8j + 2t and + 1; d[j][2..3] row 16w + g + 8 (g = lane / 4,
// t = lane % 4). So accumulator tiles 2kc and 2kc + 1, rounded to bf16, are
// the A fragment of columns 16kc .. 16kc + 15.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cor {
namespace wg {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The offset (in bf16) of element (r, c) of a tile of ch 16-byte chunks a row
__device__ __forceinline__ int cm_offset(int r, int c, int ch) {
  return ((r >> 3) * ch + (c >> 3)) * 64 + (r & 7) * 8 + (c & 7);
}

// A shared-memory matrix descriptor, no swizzle: start address, leading and
// stride byte offsets (each in 16-byte units)
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffffu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}
// k-step kc (16 columns) of a K-major tile of ch chunks a row at addr
__device__ __forceinline__ uint64_t desc_k(uint32_t addr, int ch, int kc) {
  return desc(addr + kc * 256, 128, ch * 128);
}
// k-step kc (16 rows) of an N-major B tile [K rows][ch chunks] at addr
__device__ __forceinline__ uint64_t desc_n(uint32_t addr, int ch, int kc) {
  return desc(addr + kc * 2 * ch * 128, ch * 128, 128);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving reads or writes of accumulator registers
// across a wgmma issue or wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

// mbarriers in shared memory
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}
// an arrival on bar once all of this thread's earlier cp.async copies have
// landed (.noinc: it counts as one of the arrivals bar expects)
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// order the generic-proxy shared-memory writes this thread has seen (cp.async,
// st.shared, acquired through an mbarrier) before its async-proxy reads (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// the consumer warpgroup's own barrier (named barrier 1, 128 threads)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}
// consumer warpgroup cw's (0 or 1) own barrier, of a block with two (named
// barrier 1 + cw, 128 threads; ids fixed at compile time, so that ptxas
// reserves two barriers and not all sixteen)
__device__ __forceinline__ void group_sync(int cw) {
  if (cw == 0)
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 128;\n" ::: "memory");
}

// cp.async of 16 (4) bytes, the bytes past src_bytes zero-filled (src_bytes
// 0 or the full size)
__device__ __forceinline__ void cp16(void* dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// Host side: raise `kernel`'s dynamic shared memory to `bytes` and (with
// max_shared) ask for all of L1 as shared memory, once per device and size
// (`raised`: the bytes set so far, per device). The attributes persist, so
// no launch after the first pays the runtime calls.
constexpr int kMaxDevices = 64;
inline cudaError_t raise_shared_memory(const void* kernel, int bytes, int (&raised)[kMaxDevices],
                                       bool max_shared = true) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && raised[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && max_shared)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < kMaxDevices) raised[dev] = bytes;
  return err;
}

// `lanes` threads (lane 0 .. lanes - 1; a multiple of 8) start copying rows
// [r0, r0 + 64) of a bf16 matrix (row r at src + r * stride) into the tile
// dst of kCh chunks a row; each row's first kValid chunks are read, rows >=
// n and the chunks past kValid are zeros. Eight lanes fill one core matrix
// (128 contiguous bytes) and read 16 bytes of each of 8 rows.
template <int kCh, int kValid>
__device__ __forceinline__ void load_tile(uint16_t* dst, const uint16_t* src, int64_t stride,
                                          int r0, int n, int lane, int lanes = 32) {
#pragma unroll 4
  for (int i = lane; i < 64 * kCh; i += lanes) {
    const int rg = i / (8 * kCh), rem = i - rg * 8 * kCh, c = rem >> 3, r = rg * 8 + (rem & 7);
    const bool ok = r0 + r < n && c < kValid;
    cp16(dst + (rg * kCh + c) * 64 + (rem & 7) * 8,
         ok ? src + static_cast<int64_t>(r0 + r) * stride + c * 8 : src, ok ? 16u : 0u);
  }
}

// d (64 x 32, fp32) {=, +=} A (64 x 16, bf16, shared memory, descriptor a) .
// B (16 x 32, bf16, shared memory, descriptor b): scale_d 0 overwrites d.
template <int kTransB>
__device__ __forceinline__ void mma_ss_n32(float (&d)[4][4], uint64_t a, uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTransB));
}

// d (64 x 64, fp32) {=, +=} A (64 x 16, bf16, shared memory, descriptor a) .
// B (16 x 64, bf16, shared memory, descriptor b): scale_d 0 overwrites d.
template <int kTransB>
__device__ __forceinline__ void mma_ss_n64(float (&d)[8][4], uint64_t a, uint64_t b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTransB));
}

// d (64 x 32, fp32) {=, +=} A (64 x 16, bf16 fragments a in registers) .
// B (16 x 32, bf16, shared memory, descriptor b): scale_d 0 overwrites d.
template <int kTransB>
__device__ __forceinline__ void mma_rs_n32(float (&d)[4][4], const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(kTransB));
}

// d (64 x 64, fp32) {=, +=} A (64 x 16, bf16 fragments a in registers) .
// B (16 x 64, bf16, shared memory, descriptor b): scale_d 0 overwrites d.
template <int kTransB>
__device__ __forceinline__ void mma_rs_n64(float (&d)[8][4], const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(kTransB));
}

// d (64 x 72, fp32) {=, +=} A (64 x 16, bf16 fragments a in registers) .
// B (16 x 72, bf16, shared memory, descriptor b): scale_d 0 overwrites d.
template <int kTransB>
__device__ __forceinline__ void mma_rs_n72(float (&d)[9][4], const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35}, "
      "{%36, %37, %38, %39}, %40, p, 1, 1, %42;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(kTransB));
}

// d (64 x 80, fp32) {=, +=} A (64 x 16, bf16 fragments a in registers) .
// B (16 x 80, bf16, shared memory, descriptor b): scale_d 0 overwrites d.
template <int kTransB>
__device__ __forceinline__ void mma_rs_n80(float (&d)[10][4], const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(kTransB));
}


// O (64 x N) {=, +=} A (registers) . B (shared, N-major or K-major), N in {32, 64, 72, 80}
template <int N, int kTransB>
__device__ __forceinline__ void mma_rs(float (&d)[N / 8][4], const uint32_t (&a)[4], uint64_t b,
                                       int scale_d) {
  if constexpr (N == 32) mma_rs_n32<kTransB>(d, a, b, scale_d);
  else if constexpr (N == 64) mma_rs_n64<kTransB>(d, a, b, scale_d);
  else if constexpr (N == 72) mma_rs_n72<kTransB>(d, a, b, scale_d);
  else mma_rs_n80<kTransB>(d, a, b, scale_d);
}

// tf32 products (the fp32 sequence attention's 3xTF32): wgmma's k-step is 8
// tf32 (32 bytes, two core matrices of 8 rows x 4 tf32), and both shared
// operands are K-major (the transpose flags are for 16-bit types only): a
// K-major tile of rows x (ch * 4) fp32 in the core-matrix layout above
// (16-byte chunks, 4 fp32 a chunk) is read by desc_k(addr, ch, kc) for k-step
// kc, as a bf16 one. The register A fragment of warp w is mma.sync
// m16n8k8.tf32's: a[0] = A[16w + g][t], a[1] = A[16w + g + 8][t], a[2] =
// A[16w + g][t + 4], a[3] = A[16w + g + 8][t + 4]. Each operand is a 32-bit
// fp32 pattern that the tensor cores read as tf32.
// d (64 x 64, fp32) {=, +=} A (64 x 8, tf32, shared memory, K-major, descriptor a) .
// B (8 x 64, tf32, shared memory, K-major, descriptor b): scale_d 0 overwrites d.
__device__ __forceinline__ void mma_tf32_ss_n64(float (&d)[8][4], uint64_t a, uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (64 x 64, fp32) {=, +=} A (64 x 8, tf32 fragments a in registers) .
// B (8 x 64, tf32, shared memory, K-major, descriptor b): scale_d 0 overwrites d.
__device__ __forceinline__ void mma_tf32_rs_n64(float (&d)[8][4], const uint32_t (&a)[4],
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (64 x 72, fp32) {=, +=} A (64 x 8, tf32 fragments a in registers) .
// B (8 x 72, tf32, shared memory, K-major, descriptor b): scale_d 0 overwrites d.
__device__ __forceinline__ void mma_tf32_rs_n72(float (&d)[9][4], const uint32_t (&a)[4],
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35}, "
      "{%36, %37, %38, %39}, %40, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (64 x 80, fp32) {=, +=} A (64 x 8, tf32 fragments a in registers) .
// B (8 x 80, tf32, shared memory, K-major, descriptor b): scale_d 0 overwrites d.
__device__ __forceinline__ void mma_tf32_rs_n80(float (&d)[10][4], const uint32_t (&a)[4],
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// O (64 x N) {=, +=} A (tf32 registers) . B (shared, K-major), N in {64, 72, 80}
template <int N>
__device__ __forceinline__ void mma_tf32_rs(float (&d)[N / 8][4], const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
  if constexpr (N == 64) mma_tf32_rs_n64(d, a, b, scale_d);
  else if constexpr (N == 72) mma_tf32_rs_n72(d, a, b, scale_d);
  else mma_tf32_rs_n80(d, a, b, scale_d);
}

}  // namespace wg
}  // namespace cor
