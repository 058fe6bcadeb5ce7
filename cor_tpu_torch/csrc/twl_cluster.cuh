// K1's token stages over a cluster of CTAs per candidate (twl_tokens_in.cu,
// twl_tokens_mid.cu): a linear of two_way_tokens.cuh's tok_linear split by
// output columns over the cluster's warps, and the gather of the columns
// the other CTAs computed through distributed shared memory. tok_linear
// sums each output column in one warp, in the same order at any warp count,
// so the split keeps the bits of the one-CTA stages.
#pragma once

#include <cooperative_groups.h>

#include "two_way_tokens.cuh"
#include "twl_hopper.cuh"

namespace cor {
namespace twl {

namespace cg = cooperative_groups;

// CTAs a candidate, while the n x kCluster CTAs are all resident at once
// (two an SM: cluster_fits); beyond, the stage takes its one-CTA kernel (at
// 128 candidates clusters of 4 ran in two waves and lost to it)
constexpr int kCluster = 4;
static inline bool cluster_fits(int n) { return n * kCluster <= 2 * wg::sm_count(); }

// tok_linear's columns a warp takes at a time, for inputs of width K
template <typename T, int K>
__host__ __device__ constexpr int cols_at_a_time() {
  return (K + 255) / 256 >= 8 ? 2 / (int(sizeof(T)) / 2) : 4;
}

// the CTA of a cluster of kCl whose warp computes output column j of a
// linear of input width K
template <typename T, int K, int kCl>
__device__ __forceinline__ int owner(int j) {
  return (j / cols_at_a_time<T, K>()) % (kCl * kTokWarps) / kTokWarps;
}

// Copy into this CTA's buf [NT][ld] the columns 0 .. O - 1 (of a linear of
// input width K) that the other CTAs of the cluster computed. The caller
// syncs the cluster before (every CTA's columns written) and after (every
// CTA's reads done, so that buf may be written again).
template <typename T, int NT, int K, int kCl>
__device__ __forceinline__ void gather(cg::cluster_group& cluster, float* buf, int ld, int O,
                                       int rank) {
  for (int i = threadIdx.x; i < NT * O; i += kTokThreads) {
    const int tt = i / O, j = i % O, r = owner<T, K, kCl>(j);
    if (r != rank) buf[tt * ld + j] = cluster.map_shared_rank(buf, r)[tt * ld + j];
  }
}

}  // namespace twl
}  // namespace cor
