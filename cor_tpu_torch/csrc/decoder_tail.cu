// The SAM mask decoder's upscale tail in one pass, per input pixel x [256]:
//
//   z   = x @ W1 + b1 for the 4 output positions (p, q), 64 channels each
//   y   = bf16(gelu(LN_64(z)))                       (eps 1e-6, fp32 stats)
//   u   = bf16(gelu(y @ W2 + b2)) for the 4 sub-positions (r, s), 32 each
//   out[4i + 2p + r, 4j + 2q + s] = sum_o u[o] * bf16(hyper[o])   (fp32)
//
// Replaces the TPU kernel cor_tpu/ops/pallas/decoder_tail.py:
// fused_decoder_tail (its pallas_call at line 150). As there, the two
// transposed convolutions, the LayerNorm, both GELUs and the hypernetwork
// dot run on a tile of input pixels without any intermediate reaching
// device memory: the only output is the fp32 mask. The TPU kernel folds the
// LN mean into W1 and takes the variance from bf16 operands; here the
// statistics are fp32 (closer to the exact function). GELU is the
// _PHI_COEF polynomial of cor_tpu's bf16 path.
//
// The design: one CTA of 4 warps per (grid row i of 64 pixels, candidate,
// output map). The row's 64 x 256 pixels sit in shared memory; for each
// position (p, q) its 64-channel slice of W1 is staged and multiplied on the
// tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate): each warp's
// 16 pixels x 64 channels is exactly one LayerNorm group per pixel, reduced
// across the 4 lanes that share an accumulator row. The GELU'd, rounded
// accumulators are re-packed in registers as the A operand of the second
// product (64 -> 4 x 32, W2 resident in shared memory), whose accumulators
// are GELU'd, rounded and dotted with the hypernetwork vector in registers.
// The 4 x 256 output rows of the tile are gathered in shared memory and
// written coalesced.
//
// What bounds it on the H100: per candidate 2 MiB of bf16 input, 0.25 MiB
// of fp32 output, and 2 * 4096 * (256 * 256 + 4 * 64 * 128) = 0.81 GFLOP on
// the tensor cores, plus ~1.5 M GELU polynomials (CUDA cores): past the
// ridge, so operations bound it. W1 (128 KiB) is re-read from L2 by every
// CTA; wgmma with W1 resident across a persistent CTA is later work.
//
// fp32 (compute_dtype float32): the kernel is templated on its element type
// (decoder_common.cuh's Elem<T>). Both products run in 3xTF32 on mma.sync
// m16n8k8 (mma_tf32x3.cuh); y and u are not rounded, and GELU is the exact
// erf form (cor_tpu's _gelu_exact: it takes the polynomial in bf16 only).
// The GELU'd accumulators of the first product are the A operand of the
// second in the permuted k order of mma_tf32x3.cuh, so W2's B fragments are
// the pairs (2t, 2t + 1) of a row: one 64-bit load, conflict-free with the
// row stride of 72 words (8 mod 32). 174,080 bytes of shared memory: x and
// the W1 slice [64][260], W2 [128][72], fp32.

#include "decoder_common.cuh"

namespace {

using namespace cor;

constexpr int kO1 = 64, kO2 = 32, kW = 64;  // convT1 out, convT2 out, grid width
constexpr int kThreads = 128;
// x and the W1 slice [kW or kO1][kLdC], W2 [4 * kO2][kLdO1], in T; the output
// rows [4][4 * kW] fp32
template <typename T>
struct TailTiles {
  static constexpr int kLdC = Elem<T>::kLdC;
  static constexpr int kLdO1 = kO1 + 8;  // bf16: rows 4 banks apart; fp32: 8 mod 32 words
  static constexpr size_t kSmem =
      sizeof(T) * (kW * kLdC + kO1 * kLdC + 4 * kO2 * kLdO1) + sizeof(float) * 4 * 4 * kW;
};

__device__ __forceinline__ float gelu_poly(float x) {
  // x * Phi(x), Phi(x) ~ 0.5 + t * P(t^2), t = clip(x, -4, 4): cor_tpu's _PHI_COEF
  const float t = fminf(fmaxf(x, -4.f), 4.f);
  const float t2 = t * t;
  float p = 2.967939450354871e-08f;
  p = p * t2 + -1.968709803084503e-06f;
  p = p * t2 + 5.561942806489455e-05f;
  p = p * t2 + -0.0008908471655209013f;
  p = p * t2 + 0.00915741119509791f;
  p = p * t2 + -0.06549521524440009f;
  p = p * t2 + 0.3988655684219049f;
  return x * (0.5f + t * p);
}

// cor_tpu's GELU of the compute dtype: the polynomial in bf16, exact in fp32
template <typename T>
__device__ __forceinline__ float gelu(float x) {
  if constexpr (sizeof(T) == 2) return gelu_poly(x);
  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decoder_tail_kernel(const T* __restrict__ src,  // [n][H*kW][kC]
                    const T* __restrict__ w1t,  // [(p, q, o1)][kC]
                    const T* __restrict__ w2t,  // [(r, s, o2)][kO1]
                    const float* __restrict__ vec,  // b1 [64], ln scale [64], ln bias [64], b2 [32]
                    const T* __restrict__ hyper,  // [n][m][kO2]
                    int m, int H, float eps, float* __restrict__ out) {  // [n][m][4H][4kW]
  using E = Elem<T>;
  constexpr int kLd = TailTiles<T>::kLdC, kLdO1 = TailTiles<T>::kLdO1;
  constexpr int kVec = 16 / sizeof(T);  // values per 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem[];
  T* sX = reinterpret_cast<T*>(smem);
  T* sW1 = sX + kW * kLd;
  T* sW2 = sW1 + kO1 * kLd;
  float* sOut = reinterpret_cast<float*>(sW2 + 4 * kO2 * kLdO1);  // [4][4 * kW]

  const int i = blockIdx.x, cand = blockIdx.y, mo = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const float* b1 = vec;
  const float* lns = vec + kO1;
  const float* lnb = vec + 2 * kO1;
  const float* b2 = vec + 3 * kO1;

  const T* x = src + (static_cast<int64_t>(cand) * H + i) * kW * kC;
  for (int e = tid; e < kW * (kC / kVec); e += kThreads) {
    const int r = e / (kC / kVec), c = (e % (kC / kVec)) * kVec;
    *reinterpret_cast<uint4*>(sX + r * kLd + c) = *reinterpret_cast<const uint4*>(x + r * kC + c);
  }
  for (int e = tid; e < 4 * kO2 * (kO1 / kVec); e += kThreads) {
    const int o = e / (kO1 / kVec), c = (e % (kO1 / kVec)) * kVec;
    *reinterpret_cast<uint4*>(sW2 + o * kLdO1 + c) =
        *reinterpret_cast<const uint4*>(w2t + o * kO1 + c);
  }
  // the hypernetwork values this lane multiplies: o2 = nn * 8 + 2t (+1)
  float hv[4][2];
  const T* hp = hyper + (static_cast<int64_t>(cand) * m + mo) * kO2;
#pragma unroll
  for (int nn = 0; nn < 4; ++nn) {
    hv[nn][0] = E::get(hp[nn * 8 + 2 * t]);
    hv[nn][1] = E::get(hp[nn * 8 + 2 * t + 1]);
  }

#pragma unroll 1
  for (int pq = 0; pq < 4; ++pq) {
    const int p = pq >> 1, q = pq & 1;
    __syncthreads();  // the previous position's W1 slice consumed (and sX, sW2 loaded)
    for (int e = tid; e < kO1 * (kC / kVec); e += kThreads) {
      const int o = e / (kC / kVec), c = (e % (kC / kVec)) * kVec;
      *reinterpret_cast<uint4*>(sW1 + o * kLd + c) =
          *reinterpret_cast<const uint4*>(w1t + static_cast<int64_t>(pq * kO1 + o) * kC + c);
    }
    __syncthreads();
    float a1[kO1 / 8][4];
#pragma unroll
    for (int n = 0; n < kO1 / 8; ++n) a1[n][0] = a1[n][1] = a1[n][2] = a1[n][3] = 0.f;
    warp_mma<kO1 / 8, kC>(a1, sX, kLd, sW1, kLd, warp * 16, lane);

    // + b1, LayerNorm over the 64 channels of pixels g and g + 8
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int n = 0; n < kO1 / 8; ++n) {
      const int c = n * 8 + 2 * t;
      a1[n][0] += b1[c];
      a1[n][1] += b1[c + 1];
      a1[n][2] += b1[c];
      a1[n][3] += b1[c + 1];
      sa += a1[n][0] + a1[n][1];
      sb += a1[n][2] + a1[n][3];
    }
    const float ma = quad_sum(sa) / kO1, mb = quad_sum(sb) / kO1;
    float va = 0.f, vb = 0.f;
#pragma unroll
    for (int n = 0; n < kO1 / 8; ++n) {
      va += (a1[n][0] - ma) * (a1[n][0] - ma) + (a1[n][1] - ma) * (a1[n][1] - ma);
      vb += (a1[n][2] - mb) * (a1[n][2] - mb) + (a1[n][3] - mb) * (a1[n][3] - mb);
    }
    const float ia = rsqrtf(quad_sum(va) / kO1 + eps), ib = rsqrtf(quad_sum(vb) / kO1 + eps);
    float u[4 * kO2 / 8][4];
#pragma unroll
    for (int n = 0; n < 4 * kO2 / 8; ++n) u[n][0] = u[n][1] = u[n][2] = u[n][3] = 0.f;
    if constexpr (sizeof(T) == 2) {
      // GELU, rounded, re-packed as the A fragments of the second product:
      // accumulator tiles 2kc and 2kc + 1 are the A fragment of k = 16kc..16kc+15
      uint32_t a2[kO1 / 16][4];
#pragma unroll
      for (int n = 0; n < kO1 / 8; ++n) {
        const int c = n * 8 + 2 * t;
        const float y0 = gelu_poly((a1[n][0] - ma) * ia * lns[c] + lnb[c]);
        const float y1 = gelu_poly((a1[n][1] - ma) * ia * lns[c + 1] + lnb[c + 1]);
        const float y2 = gelu_poly((a1[n][2] - mb) * ib * lns[c] + lnb[c]);
        const float y3 = gelu_poly((a1[n][3] - mb) * ib * lns[c + 1] + lnb[c + 1]);
        a2[n >> 1][(n & 1) * 2 + 0] = pack_bf16x2(y0, y1);
        a2[n >> 1][(n & 1) * 2 + 1] = pack_bf16x2(y2, y3);
      }
#pragma unroll
      for (int kc = 0; kc < kO1 / 16; ++kc) {
#pragma unroll
        for (int n = 0; n < 4 * kO2 / 8; ++n) {
          const uint16_t* pb = sW2 + (n * 8 + g) * kLdO1 + kc * 16 + 2 * t;
          mma_bf16_16816(u[n], a2[kc], lds32(pb), lds32(pb + 8));
        }
      }
    } else {
      // GELU'd accumulator tile n is the A fragment of the k-step over
      // channels 8n .. 8n + 7 in the permuted order (2t, 2t + 1): W2's B
      // fragment is the pair (8n + 2t, 8n + 2t + 1) of its row
#pragma unroll
      for (int n = 0; n < kO1 / 8; ++n) {
        const int c = n * 8 + 2 * t;
        const FragA a = a_from_c_tf32(gelu<T>((a1[n][0] - ma) * ia * lns[c] + lnb[c]),
                                      gelu<T>((a1[n][1] - ma) * ia * lns[c + 1] + lnb[c + 1]),
                                      gelu<T>((a1[n][2] - mb) * ib * lns[c] + lnb[c]),
                                      gelu<T>((a1[n][3] - mb) * ib * lns[c + 1] + lnb[c + 1]));
#pragma unroll
        for (int nn = 0; nn < 4 * kO2 / 8; ++nn) {
          const float2 w = *reinterpret_cast<const float2*>(sW2 + (nn * 8 + g) * kLdO1 + c);
          FragB b;
          b.set(0, w.x);
          b.set(1, w.y);
          mma_tf32x3(u[nn], a, b);
        }
      }
    }
    // + b2, GELU, rounded, dotted with the hypernetwork vector per (r, s)
#pragma unroll
    for (int rs = 0; rs < 4; ++rs) {
      float da = 0.f, db = 0.f;
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        const int n = rs * 4 + nn, o = nn * 8 + 2 * t;
        da += E::round(gelu<T>(u[n][0] + b2[o])) * hv[nn][0] +
              E::round(gelu<T>(u[n][1] + b2[o + 1])) * hv[nn][1];
        db += E::round(gelu<T>(u[n][2] + b2[o])) * hv[nn][0] +
              E::round(gelu<T>(u[n][3] + b2[o + 1])) * hv[nn][1];
      }
      da = quad_sum(da);
      db = quad_sum(db);
      if (t == 0) {
        const int orow = 2 * p + (rs >> 1), s = rs & 1;
        const int j = warp * 16 + g;
        sOut[orow * 4 * kW + 4 * j + 2 * q + s] = da;
        sOut[orow * 4 * kW + 4 * (j + 8) + 2 * q + s] = db;
      }
    }
  }
  __syncthreads();
  float* o = out + ((static_cast<int64_t>(cand) * m + mo) * 4 * H + 4 * i) * 4 * kW;
  for (int e = tid; e < 4 * 4 * kW / 4; e += kThreads)
    reinterpret_cast<float4*>(o)[e] = reinterpret_cast<const float4*>(sOut)[e];
}

template <typename T>
int launch(const void* src, const void* w1t, const void* w2t, const void* vec, const void* hyper,
           int n, int m, int H, float eps, void* out, cudaStream_t stream) {
  constexpr size_t smem = TailTiles<T>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(decoder_tail_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  decoder_tail_kernel<T><<<dim3(H, n, m), kThreads, smem, stream>>>(
      static_cast<const T*>(src), static_cast<const T*>(w1t), static_cast<const T*>(w2t),
      static_cast<const float*>(vec), static_cast<const T*>(hyper), m, H, eps,
      static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

// Compute dtype T: bf16 (f32 = 0) or fp32 (f32 = 1). src T [n][H][64][256];
// w1t T [256 = (p, q, o1)][256]; w2t T [128 = (r, s, o2)][64]; vec fp32 [224]
// (b1, ln scale, ln bias, b2); hyper T [n][m][32]; out fp32 [n][m][4H][256].
extern "C" int cor_decoder_tail(const void* src, const void* w1t, const void* w2t,
                                const void* vec, const void* hyper, int n, int m, int H,
                                float eps, void* out, int f32, void* stream) {
  if (n < 1 || n > 65535 || m < 1 || m > 65535 || H < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? launch<float>(src, w1t, w2t, vec, hyper, n, m, H, eps, out, s)
             : launch<uint16_t>(src, w1t, w2t, vec, hyper, n, m, H, eps, out, s);
}
