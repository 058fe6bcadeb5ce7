// fp32 products on the tensor cores, to fp32 accuracy: 3xTF32.
//
// The H100's tensor cores take fp32 operands only as TF32 (a 10-bit
// mantissa), which alone keeps about three decimal digits. Each fp32 operand
// x is split into big = tf32(x) and small = tf32(x - big), so that
// x = big + small to within 2^-22 |x|, and a product a.b is taken as
//
//   small_a.big_b + big_a.small_b + big_a.big_b
//
// accumulated in fp32 in that order (the small terms first, so that they
// are not lost against the large one): three mma.sync m16n8k8 TF32 products
// for one fp32 product, the scheme of CUTLASS's "fast accurate fp32"
// tensor-op warp MMA. The dropped small_a.small_b term is below 2^-22 of
// a.b. cor_tpu's fp32 kernels run their products in full fp32 (XLA's
// default precision on the CPU, HIGHEST on the TPU), and torch's fp32 matmul
// keeps TF32 off by default; 1xTF32 would miss their tolerances.
//
// Fragments of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, lane =
// 4 g + t (g = lane / 4, t = lane % 4):
//   A (16 x 8, row): a0 = A[g][t], a1 = A[g + 8][t], a2 = A[g][t + 4],
//                    a3 = A[g + 8][t + 4]
//   B (8 x 8, col):  b0 = B[t][g], b1 = B[t + 4][g]
//   C (16 x 8):      c0 = C[g][2t], c1 = C[g][2t + 1], c2 = C[g + 8][2t],
//                    c3 = C[g + 8][2t + 1] (the layout of m16n8k16's C)
// An fp32 tile [row][k] in shared memory gives conflict-free A and B
// fragment loads when its row stride is 4 mod 8 words (rows g = 0..7 then
// start on banks 4 apart, and t = 0..3 fills the gaps).
//
// A C tile reused as the A operand of a second product (P of a flash
// attention, the GELU'd activations of the decoder tail) does not line up
// with A's layout. The second product sums over that k, so any order of k
// will do: for the k-step of C tile n, column t of A is k = 8n + 2t and
// column t + 4 is k = 8n + 2t + 1, so that
//   a = {c0, c2, c1, c3}
// and the B operand is read in the same order: b0 = B[8n + 2t][g],
// b1 = B[8n + 2t + 1][g].
#pragma once

#include <stdint.h>

namespace cor {

// x -> (tf32(x), tf32(x - tf32(x))), each in a 32-bit register
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float rest = x - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

// an fp32 operand fragment split into its big and small TF32 halves
template <int R>
struct Tf32Frag {
  uint32_t big[R], small[R];
  __device__ __forceinline__ void set(int i, float x) { split_tf32(x, big[i], small[i]); }
};
using FragA = Tf32Frag<4>;
using FragB = Tf32Frag<2>;

__device__ __forceinline__ void mma_tf32_1688(float c[4], const uint32_t a[4], uint32_t b0,
                                              uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a.b in fp32 accuracy: small.big + big.small + big.big
__device__ __forceinline__ void mma_tf32x3(float c[4], const FragA& a, const FragB& b) {
  mma_tf32_1688(c, a.small, b.big[0], b.big[1]);
  mma_tf32_1688(c, a.big, b.small[0], b.small[1]);
  mma_tf32_1688(c, a.big, b.big[0], b.big[1]);
}

// The A fragment of rows row0 .. row0 + 15, columns k0 .. k0 + 7 of an fp32
// [row][k] tile with row stride ld.
__device__ __forceinline__ FragA load_a_tf32(const float* s, int ld, int row0, int k0, int g,
                                             int t) {
  FragA a;
  const float* p = s + (row0 + g) * ld + k0 + t;
  a.set(0, p[0]);
  a.set(1, p[8 * ld]);
  a.set(2, p[4]);
  a.set(3, p[8 * ld + 4]);
  return a;
}

// The B fragment of output columns n0 .. n0 + 7, k0 .. k0 + 7, from an fp32
// [n][k] tile (k contiguous, a weight's [out, in] or K's [key][d]).
__device__ __forceinline__ FragB load_b_tf32(const float* s, int ld, int n0, int k0, int g,
                                             int t) {
  FragB b;
  const float* p = s + (n0 + g) * ld + k0 + t;
  b.set(0, p[0]);
  b.set(1, p[4]);
  return b;
}

// The B fragment of the permuted k order above (k0 + 2t, k0 + 2t + 1) for
// output columns n0 .. n0 + 7, from an fp32 [k][n] tile (n contiguous: V's
// [key][d]).
__device__ __forceinline__ FragB load_b_tf32_kn_paired(const float* s, int ld, int k0, int n0,
                                                       int g, int t) {
  FragB b;
  const float* p = s + (k0 + 2 * t) * ld + n0 + g;
  b.set(0, p[0]);
  b.set(1, p[ld]);
  return b;
}

// The A fragment of the permuted k order from a C tile {c0, c1, c2, c3}.
__device__ __forceinline__ FragA a_from_c_tf32(float c0, float c1, float c2, float c3) {
  FragA a;
  a.set(0, c0);
  a.set(1, c2);
  a.set(2, c1);
  a.set(3, c3);
  return a;
}

// acc[n] (16 x 8 tile n) += A[row0 .. row0+15][0 .. K) * B[n*8 .. n*8+7][0 .. K)^T
// with A [rows][lda] and B [cols][ldb] fp32 in shared memory, both
// K-contiguous: the fp32 counterpart of warp_mma (decoder_common.cuh).
template <int NT, int K>
__device__ __forceinline__ void warp_mma_f32(float (&acc)[NT][4], const float* sA, int lda,
                                             const float* sB, int ldb, int row0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int kc = 0; kc < K / 8; ++kc) {
    const FragA a = load_a_tf32(sA, lda, row0, kc * 8, g, t);
#pragma unroll
    for (int n = 0; n < NT; ++n) mma_tf32x3(acc[n], a, load_b_tf32(sB, ldb, n * 8, kc * 8, g, t));
  }
}

}  // namespace cor
