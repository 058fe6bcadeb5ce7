// The fp32 attention kernels' shared-memory tiles for wgmma's tf32 products
// (K4@fp32 in seq_attention.cu, K6/K7@fp32 in vit_attention_f32.cuh): every
// 64-row tile is stored twice, as its TF32 big and small halves
// (mma_tf32x3.cuh), in wgmma's K-major core-matrix layout (wgmma.cuh; 4 fp32
// a 16-byte chunk). 128 threads place a tile: thread p's u-th chunk is chunk
// f = p + 128 u of the tile.
#pragma once

#include <stdint.h>

#include "mma_tf32x3.cuh"

namespace cor {
namespace tf32 {

constexpr int kTileRows = 64;
constexpr int kPlacers = 128;  // the threads that place one tile

// the float offset of chunk c of row r in a K-major tile of ch chunks a row
__device__ __forceinline__ int chunk_offset(int r, int c, int ch) {
  return ((r >> 3) * ch + c) * 32 + (r & 7) * 4;
}

// a chunk split into its TF32 halves, stored at off of big and small
__device__ __forceinline__ void store_split4(float* big, float* small, int off, float4 v) {
  uint4 b, s;
  cor::split_tf32(v.x, b.x, s.x);
  cor::split_tf32(v.y, b.y, s.y);
  cor::split_tf32(v.z, b.z, s.z);
  cor::split_tf32(v.w, b.w, s.w);
  *reinterpret_cast<uint4*>(big + off) = b;
  *reinterpret_cast<uint4*>(small + off) = s;
}

// Chunk f of a 64-row tile of kCh chunks a row: its row and 16-byte column.
// Eight consecutive threads take the eight rows of one core matrix, so their
// 16-byte stores fill 128 contiguous bytes.
template <int kCh>
__device__ __forceinline__ void chunk_of(int f, int& row, int& c) {
  const int rg = f / (8 * kCh), rem = f - rg * 8 * kCh;
  c = rem >> 3;
  row = rg * 8 + (rem & 7);
}

// Thread p's chunks (in registers r) split into TF32 halves and stored as a
// [row][d] tile of kCh chunks a row (big at dst, small `tile` floats on)
template <int kCh, int kN>
__device__ __forceinline__ void store_rows_split(float* dst, int tile, int p,
                                                 const float4 (&r)[kN]) {
#pragma unroll
  for (int u = 0; u < kN; ++u) {
    int row, c;
    chunk_of<kCh>(p + kPlacers * u, row, c);
    store_split4(dst, dst + tile, chunk_offset(row, c, kCh), r[u]);
  }
}

// ... or transposed, as V^T [d][key] (64 keys: 16 chunks a row) with the
// keys within each 8 in the order of P's register fragments (key 2t at
// position t, 2t + 1 at t + 4; mma_tf32x3.cuh). Lanes 8m .. 8m + 7 of a
// warp hold the 8 rows of one chunk column c (chunk_of); the four of one
// row parity b (lanes 8m + 2q + b, q = 0..3) swap their chunks' elements
// by two xor shuffles, a 4 x 4 transpose, after which lane 8m + 2q + b
// holds d = 4c + q at keys b, 2 + b, 4 + b, 6 + b: positions 4b .. 4b + 3 of
// V^T's row d, one 16-byte store of each half. Every lane of the warp calls
// it (the shuffles).
template <int kCh, int kN>
__device__ __forceinline__ void store_vt_split(float* dst, int tile, int p,
                                               const float4 (&r)[kN]) {
  constexpr int kChV = kTileRows / 4;
  const int lane = p & 31;
  const bool hi = (lane >> 2) & 1, lo = (lane >> 1) & 1;
#pragma unroll
  for (int u = 0; u < kN; ++u) {
    int row, c;
    chunk_of<kCh>(p + kPlacers * u, row, c);
    float4 v = r[u];
    // the off-diagonal 2 x 2 blocks (q ^ 2: lane ^ 4), then the elements
    // off the diagonal within each (q ^ 1: lane ^ 2)
    float s0 = hi ? v.x : v.z, s1 = hi ? v.y : v.w;
    s0 = __shfl_xor_sync(0xffffffffu, s0, 4);
    s1 = __shfl_xor_sync(0xffffffffu, s1, 4);
    if (hi) {
      v.x = s0;
      v.y = s1;
    } else {
      v.z = s0;
      v.w = s1;
    }
    s0 = lo ? v.x : v.y;
    s1 = lo ? v.z : v.w;
    s0 = __shfl_xor_sync(0xffffffffu, s0, 2);
    s1 = __shfl_xor_sync(0xffffffffu, s1, 2);
    if (lo) {
      v.x = s0;
      v.z = s1;
    } else {
      v.y = s0;
      v.w = s1;
    }
    const int d = 4 * c + ((lane >> 1) & 3);
    const int pos = (row & ~7) + 4 * (lane & 1);  // the first of the 4 keys' positions
    store_split4(dst, dst + tile, chunk_offset(d, pos >> 2, kChV), v);
  }
}

}  // namespace tf32
}  // namespace cor
