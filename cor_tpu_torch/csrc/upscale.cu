// The mask decoder's last upscale stage fused with the hypernetwork product
// (K9), per input pixel x[b, i, j, :] of C channels:
//
//   u[p, q, o] = gelu(sum_c x[c] * w[c, p, q, o] + b[o])       (fp32, unrounded)
//   out[b, n, 2i + p, 2j + q] = sum_o u[p, q, o] * hyper[b, n, o]   (fp32)
//
// Replaces the TPU kernel cor_tpu/ops/pallas/upscale.py:fused_upscale2_hyper
// (its pallas_call at line 104), with its numerics: w and hyper in x's
// dtype, the first product accumulated in fp32, the bias fp32, GELU with erf
// by Abramowitz-Stegun 7.1.26 (cor_tpu's _gelu_exact: the same polynomial,
// with expf) on the unrounded accumulator in bf16 and fp32 alike, the second
// product in fp32. The TPU kernel leaves the (p, q, n) interleave to XLA;
// here the kernel writes the final [B, N, 2H, 2W] layout itself.
//
// The design: one CTA of 4 warps per tile of 64 input pixels of one sample:
// 64 columns of one row where W >= 64, else 64 / W whole rows (a ragged tile
// is masked). The tile's x [64][C] sits in shared memory; for each position
// (p, q) its slice of w, [O][C] (the wrapper packs w as [(p, q, o)][C]), is
// staged and multiplied on the tensor cores: mma.sync m16n8k16 (bf16 in,
// fp32 accumulate), or 3xTF32 m16n8k8 (mma_tf32x3.cuh) in fp32. Each warp's
// 16 pixels x O channels come out in registers, take the bias and the GELU
// there, and are dotted with hyper[b] ([N][O] fp32 in shared memory) on the
// CUDA cores: each lane sums its 2 x O / 4 channels for every map, and the 4
// lanes sharing a pixel reduce with two shuffles. The tile's N x 2R x 2Wc
// outputs are gathered in shared memory and written to the final layout in
// coalesced rows of 2Wc floats per map.
//
// What bounds it on the H100: at the decoder's shape (x [40, 128, 128, 64],
// O 32, N 4) bf16 reads 83.9 MB and writes 41.9 MB: 0.038 ms at 3.35 TB/s,
// above the first product's 10.7 GFLOP (0.011 ms at 989 TFLOP/s), so bytes
// by the data sheet. fp32 reads 167.8 MB (0.063 ms with the writes); its
// 3xTF32 product (0.065 ms at 494.7 / 3 TFLOP/s) is the larger. Beyond the
// bound: 84 M GELUs, each a reciprocal and an exponential on the SFUs plus
// ~15 FMAs, and the 4 syncs per tile that stage w's slices. Keeping w
// resident across tiles in a persistent CTA is later work.

#include "decoder_common.cuh"

namespace {

using namespace cor;

constexpr int kPix = 64;  // input pixels (GEMM rows) per CTA: 4 warps of 16
constexpr int kThreads = 128;
constexpr int kMaxNt = 8;  // O / 8 accumulator tiles: O <= 64
constexpr int kMaxN = 16;  // hypernetwork maps

// the padded row stride of an x or w row of C values: bf16 C + 8 (rows 4
// banks apart, conflict-free m16n8k16 fragments for every C % 16 == 0),
// fp32 C + 4 (4 mod 8 words, conflict-free TF32 fragments)
template <typename T>
__host__ __device__ constexpr int row_pad() {
  return sizeof(T) == 2 ? 8 : 4;
}

// cor_tpu's _gelu_exact: 0.5 x (1 + erf(x / sqrt 2)), erf by
// Abramowitz-Stegun 7.1.26 (|error| < 1.5e-7)
__device__ __forceinline__ float gelu_erf_as(float x) {
  const float z = x * 0.7071067811865476f;
  const float az = fabsf(z);
  const float t = 1.f / (1.f + 0.3275911f * az);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float e = 1.f - poly * expf(-az * az);
  return 0.5f * x * (1.f + (z < 0.f ? -e : (z > 0.f ? e : 0.f)));
}

template <typename T>
size_t smem_bytes(int C, int O, int N) {
  const int ld = C + row_pad<T>();
  return sizeof(float) * (static_cast<size_t>(N) * 4 * kPix + N * O + O) +
         sizeof(T) * (static_cast<size_t>(kPix) * ld + static_cast<size_t>(O) * ld);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
upscale2_hyper_kernel(const T* __restrict__ x,      // [B][H][W][C]
                      const T* __restrict__ wt,     // [(p, q, o)][C]
                      const float* __restrict__ bias,  // [O]
                      const T* __restrict__ hyper,  // [B][N][O]
                      float* __restrict__ out,      // [B][N][2H][2W]
                      int H, int W, int C, int O, int N, int wc, int rt, int tiles_w) {
  using E = Elem<T>;
  constexpr int kVec = 16 / sizeof(T);  // values per 16-byte chunk
  const int ld = C + row_pad<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  float* sOut = reinterpret_cast<float*>(smem);  // [N][2 rt][2 wc]
  float* sH = sOut + N * 4 * kPix;                // [N][O]
  float* sB = sH + N * O;                         // [O]
  T* sX = reinterpret_cast<T*>(sB + O);           // [kPix][ld]
  T* sW = sX + kPix * ld;                         // [O][ld]

  const int b = blockIdx.y;
  const int i0 = (blockIdx.x / tiles_w) * rt, j0 = (blockIdx.x % tiles_w) * wc;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int nt_used = O / 8;
  const int cv = C / kVec;

  // the tile's pixels: GEMM row r is pixel (i0 + r / wc, j0 + r % wc)
  for (int e = tid; e < kPix * cv; e += kThreads) {
    const int r = e / cv, c = (e % cv) * kVec;
    const int i = i0 + r / wc, j = j0 + r % wc;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < rt * wc && i < H && j < W)
      v = *reinterpret_cast<const uint4*>(
          x + ((static_cast<int64_t>(b) * H + i) * W + j) * C + c);
    *reinterpret_cast<uint4*>(sX + r * ld + c) = v;
  }
  for (int e = tid; e < N * O; e += kThreads)
    sH[e] = E::get(hyper[static_cast<int64_t>(b) * N * O + e]);
  for (int e = tid; e < O; e += kThreads) sB[e] = bias[e];

  // this warp's rows g and g + 8: their place in the output tile
  const int ra = warp * 16 + g, rb = ra + 8;
  const bool va = ra < rt * wc, vb = rb < rt * wc;
  const int oa = 2 * (ra / wc) * (2 * wc) + 2 * (ra % wc);
  const int ob = 2 * (rb / wc) * (2 * wc) + 2 * (rb % wc);

#pragma unroll 1
  for (int pq = 0; pq < 4; ++pq) {
    __syncthreads();  // the previous slice consumed (and sX, sH, sB loaded)
    const T* wp = wt + static_cast<int64_t>(pq) * O * C;
    for (int e = tid; e < O * cv; e += kThreads) {
      const int o = e / cv, c = (e % cv) * kVec;
      *reinterpret_cast<uint4*>(sW + o * ld + c) =
          *reinterpret_cast<const uint4*>(wp + static_cast<int64_t>(o) * C + c);
    }
    __syncthreads();

    float acc[kMaxNt][4];
#pragma unroll
    for (int n = 0; n < kMaxNt; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    if constexpr (sizeof(T) == 2) {
#pragma unroll 1
      for (int kc = 0; kc < C / 16; ++kc) {
        const uint16_t* pa = sX + (warp * 16 + g) * ld + kc * 16 + 2 * t;
        const uint32_t a[4] = {lds32(pa), lds32(pa + 8 * ld), lds32(pa + 8),
                               lds32(pa + 8 * ld + 8)};
#pragma unroll
        for (int n = 0; n < kMaxNt; ++n) {
          if (n < nt_used) {
            const uint16_t* pb = sW + (n * 8 + g) * ld + kc * 16 + 2 * t;
            mma_bf16_16816(acc[n], a, lds32(pb), lds32(pb + 8));
          }
        }
      }
    } else {
#pragma unroll 1
      for (int kc = 0; kc < C / 8; ++kc) {
        const FragA a = load_a_tf32(sX, ld, warp * 16, kc * 8, g, t);
#pragma unroll
        for (int n = 0; n < kMaxNt; ++n)
          if (n < nt_used) mma_tf32x3(acc[n], a, load_b_tf32(sW, ld, n * 8, kc * 8, g, t));
      }
    }

    // + b, GELU, and this lane's share of the dot with every map's hyper row
    float part[kMaxN][2];
#pragma unroll
    for (int m = 0; m < kMaxN; ++m) part[m][0] = part[m][1] = 0.f;
#pragma unroll
    for (int n = 0; n < kMaxNt; ++n) {
      if (n < nt_used) {
        const int o = n * 8 + 2 * t;
        const float u0 = gelu_erf_as(acc[n][0] + sB[o]);
        const float u1 = gelu_erf_as(acc[n][1] + sB[o + 1]);
        const float u2 = gelu_erf_as(acc[n][2] + sB[o]);
        const float u3 = gelu_erf_as(acc[n][3] + sB[o + 1]);
#pragma unroll
        for (int m = 0; m < kMaxN; ++m) {
          if (m < N) {
            const float2 h = *reinterpret_cast<const float2*>(sH + m * O + o);
            part[m][0] += u0 * h.x + u1 * h.y;
            part[m][1] += u2 * h.x + u3 * h.y;
          }
        }
      }
    }
    const int p = pq >> 1, q = pq & 1;
#pragma unroll
    for (int m = 0; m < kMaxN; ++m) {
      if (m < N) {
        const float da = quad_sum(part[m][0]), db = quad_sum(part[m][1]);
        if ((m & 3) == t) {  // the 4 lanes of a pixel share the writes
          float* so = sOut + m * 4 * kPix + p * (2 * wc) + q;
          if (va) so[oa] = da;
          if (vb) so[ob] = db;
        }
      }
    }
  }
  __syncthreads();

  // out[b, m, 2 i0 + orow, 2 j0 + 2 c2 + (0, 1)]: rows of 2 wc floats per map
  const int rows2 = 2 * rt;
  for (int e = tid; e < N * rows2 * wc; e += kThreads) {
    const int m = e / (rows2 * wc), rem = e % (rows2 * wc);
    const int orow = rem / wc, c2 = rem % wc;
    const int gi = 2 * i0 + orow, gj = j0 + c2;
    if (gi < 2 * H && gj < W) {
      const float2 v = *reinterpret_cast<const float2*>(sOut + m * 4 * kPix + orow * 2 * wc +
                                                        2 * c2);
      *reinterpret_cast<float2*>(
          out + ((static_cast<int64_t>(b) * N + m) * 2 * H + gi) * 2 * W + 2 * gj) = v;
    }
  }
}

template <typename T>
int launch(const void* x, const void* wt, const void* bias, const void* hyper, void* out, int B,
           int H, int W, int C, int O, int N, cudaStream_t stream) {
  // the tile: 64 columns of a row, or 64 / W whole rows
  const int wc = W >= kPix ? kPix : W;
  const int rt = W >= kPix ? 1 : kPix / W;
  const int tiles_w = (W + wc - 1) / wc;
  const int64_t tiles = static_cast<int64_t>((H + rt - 1) / rt) * tiles_w;
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>(C, O, N);
  cudaError_t err = cudaFuncSetAttribute(upscale2_hyper_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  upscale2_hyper_kernel<T><<<dim3(static_cast<unsigned>(tiles), B), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wt), static_cast<const float*>(bias),
      static_cast<const T*>(hyper), static_cast<float*>(out), H, W, C, O, N, wc, rt, tiles_w);
  return cudaGetLastError();
}

}  // namespace

// Compute dtype T: bf16 (f32 = 0) or fp32 (f32 = 1). x T [B][H][W][C],
// 16-byte aligned; wt T [(p, q, o) = 4 O][C]; b fp32 [O]; hyper T [B][N][O];
// out fp32 [B][N][2H][2W]. C % 16 == 0, C <= 256; O % 8 == 0, O <= 64;
// 1 <= N <= 16; 1 <= B <= 65535; H, W >= 1. Returns the launch's
// cudaError_t.
extern "C" int cor_fused_upscale2_hyper(const void* x, const void* wt, const void* b,
                                        const void* hyper, void* out, int B, int H, int W, int C,
                                        int O, int N, int f32, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || C < 16 || C > 256 || C % 16 != 0 || O < 8 ||
      O > 8 * kMaxNt || O % 8 != 0 || N < 1 || N > kMaxN)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? launch<float>(x, wt, b, hyper, out, B, H, W, C, O, N, s)
             : launch<uint16_t>(x, wt, b, hyper, out, B, H, W, C, O, N, s);
}
