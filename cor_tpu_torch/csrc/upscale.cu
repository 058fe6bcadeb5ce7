// The mask decoder's last upscale stage fused with the hypernetwork product
// (K9), per input pixel x[b, i, j, :] of C channels:
//
//   u[p, q, o] = gelu(sum_c x[c] * w[c, p, q, o] + b[o])       (fp32, unrounded)
//   out[b, n, 2i + p, 2j + q] = sum_o u[p, q, o] * hyper[b, n, o]   (fp32)
//
// Replaces the TPU kernel cor_tpu/ops/pallas/upscale.py:fused_upscale2_hyper
// (its pallas_call at line 104), with its numerics: w and hyper in x's
// dtype, the first product accumulated in fp32, the bias fp32, GELU with erf
// by Abramowitz-Stegun 7.1.26 (cor_tpu's _gelu_exact: the same polynomial)
// on the unrounded accumulator in bf16 and fp32 alike, the second product in
// fp32. The TPU kernel leaves the (p, q, n) interleave to XLA; here the
// kernel writes the final [B, N, 2H, 2W] layout itself.
//
// Redesigned for Hopper. What held the first kernel back (PERF.md): one
// 4-warp CTA per 64-pixel tile restaged each of w's four (p, q) slices for
// every tile behind 8 __syncthreads, and ran its product on mma.sync. Here:
//
//  - a persistent grid (as many CTAs as fit on the card at once), each CTA
//    walking a contiguous range of 64-pixel tiles: 64 columns of one row
//    where W >= 64, else 64 / W whole rows (a ragged tile is masked);
//  - w resident in shared memory for the CTA's life, packed as [(p, q, o)][C]
//    with o padded to kOP (32 or 64) by zeros, in wgmma's K-major
//    core-matrix layout: 16 KB in bf16 at C 64, O 32; fp32 splits it once
//    into its TF32 halves (64 KB);
//  - x tiles streamed by a producer warp through a ring of up to six
//    stages, one TMA copy per 16-byte column chunk of the tile (tma.cuh: the
//    tile lands as [chunk][pixel][16 bytes]; rows past the tensor come in as
//    zeros);
//  - one product for all four positions: three consumer warpgroups (two
//    where a pass is 256 wide), each taking every third tile of the range,
//    run m64n(4 kOP) = m64n128 on wgmma per tile (bf16 both operands from
//    shared memory; fp32 3xTF32 with x's fragments split in registers, the
//    next k-step's loaded under this one's products), so nothing is
//    restaged;
//  - in registers: the bias and the A&S GELU (its reciprocal and
//    exponential on the SFU) on each warpgroup's 64 x 128 accumulators; the
//    hyper product (N <= 16 maps, [N][kOP] fp32 in shared memory per
//    warpgroup, reloaded when the sample changes) on the CUDA cores, two
//    maps at a time, each lane's share over its columns reduce-scattered
//    over the quad by 6 shuffles; the tile's output gathered in the
//    warpgroup's [N][2 rows][2 wc] buffer and written in the final layout by
//    16-byte stores (8-byte ones at an odd W), which drain under the next
//    tile's product.
//
// The summation order of both products differs from the first kernel's:
// K9 is held to its plain version by tolerance (1e-4), not by bits.
//
// Shapes where w (and the warpgroups' buffers) cannot stay whole (fp32 at
// large C x O): the CTA walks its range in 2 or 4 passes, each with the
// w slice of 2 positions or 1 resident (an x tile is then read once per
// pass), and where even that does not fit, fewer consumer warpgroups: the
// host takes the first plan that fits with at least one x stage
// (upscale_plan).
//
// What bounds it on the H100: at the decoder's shape (x [40, 128, 128, 64],
// O 32, N 4) bf16 reads 83.9 MB and writes 41.9 MB: 0.038 ms at 3.35 TB/s,
// above the first product's 10.7 GFLOP (0.011 ms at 989 TFLOP/s), so bytes
// by the data sheet; fp32 reads 167.8 MB (0.063 ms with the writes), its
// 3xTF32 product 0.065 ms at 494.7 / 3 TFLOP/s. Beyond the bound: 84 M GELUs
// on the CUDA cores, each a reciprocal and an exponential on the SFUs
// (~0.045 ms of SFU issue at 16 a clock an SM) and ~15 FMAs (~0.04 ms), and
// the hyper dot: the card spends about twice that issue time (PERF.md),
// so latency, not the SFU's rate, is what is left.

#include "decoder_common.cuh"
#include "mma_tf32x3.cuh"
#include "tf32_tiles.cuh"
#include "tma.cuh"
#include "twl_hopper.cuh"
#include "wgmma.cuh"

namespace {

using namespace cor;

constexpr int kPix = 64;   // input pixels a tile (wgmma's M)
constexpr int kMaxN = 16;  // hypernetwork maps
constexpr int kMaxStages = 6;
constexpr int kSmemLimit = 232448;
constexpr int kConsBar = 3;  // every consumer warpgroup's named barrier
constexpr int kMaps = 2;     // the maps whose hyper dots a thread sums at once
// consumer warpgroups a CTA at most: three where the accumulators leave
// room, two at n 256. tools/variant_sweep.py at the decoder's shape (x [40,
// 128, 128, 64], O 32, N 1 and 4; H100 80GB HBM3 at 700 W): four warpgroups
// run at 96 registers a thread and spill, 0.124-0.126 / 0.149-0.152 ms in
// bf16 and 0.232-0.234 / 0.259-0.260 in fp32; three 0.127 / 0.150-0.153 and
// 0.187-0.189 / 0.206-0.212; two 0.149-0.150 / 0.178-0.182 and 0.217 /
// 0.240-0.246
template <int kNP>
constexpr int kGroupsOf = kNP == 256 ? 2 : 3;

// cor_tpu's _gelu_exact: 0.5 x (1 + erf(x / sqrt 2)), erf by
// Abramowitz-Stegun 7.1.26 (|error| < 1.5e-7), the reciprocal and the
// exponential by the SFU (relative errors near 2^-22); the sign of erf is
// z's (at z = 0, x = 0 and so the value)
__device__ __forceinline__ float gelu_erf_as(float x) {
  const float z = x * 0.7071067811865476f;
  const float az = fabsf(z);
  float t, ex;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(t) : "f"(fmaf(0.3275911f, az, 1.f)));
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(ex) : "f"(-1.4426950408889634f * az * az));
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f + t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float e = copysignf(1.f - poly * ex, z);
  return fmaf(0.5f * x, e, 0.5f * x);
}

// The launch's geometry and operands (a kernel parameter)
struct Params {
  const void* wt;      // [(p, q, o) = 4 O][C], the compute dtype
  const float* bias;   // [O]
  const void* hyper;   // [B][N][O], the compute dtype
  float* out;          // [B][N][2H][2W]
  int B, H, W, C, O, N;
  int wc, rt, tiles_w, per_b;  // a tile: rt rows of wc pixels; tiles a sample
  int stages, groups;          // x stages; consumer warpgroups (1 to kGroupsOf)
};

// the tile's first pixel (b, i0, j0) and its valid pixels
struct Tile {
  int b, i0, j0, cnt;
  int64_t first;
};
__device__ __forceinline__ Tile tile_at(const Params& p, int tile) {
  Tile t;
  t.b = tile / p.per_b;
  const int r = tile % p.per_b;
  t.i0 = (r / p.tiles_w) * p.rt;
  t.j0 = (r % p.tiles_w) * p.wc;
  t.cnt = p.W >= kPix ? min(kPix, p.W - t.j0) : min(p.rt, p.H - t.i0) * p.W;
  t.first = (static_cast<int64_t>(t.b) * p.H + t.i0) * p.W + t.j0;
  return t;
}

// the consumers' named barrier (every consumer warpgroup)
__device__ __forceinline__ void consumers_sync(int groups) {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kConsBar), "r"(groups * 128) : "memory");
}
// consumer warpgroup cw's own barrier (named barrier 4 + cw)
__device__ __forceinline__ void group_sync(int cw) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(4 + cw) : "memory");
}

// One pass's slice of w: rows nn < kNP of positions pass * kNP / kOP .., row
// nn = (position, o) read from wt row pq * O + o (o < O; zeros past it), in
// the K-major core-matrix layout (bf16), or split into its TF32 halves (fp32:
// big, then small kNP * C floats on); by the consumer threads
template <typename T, int kOP, int kNP>
__device__ __forceinline__ void load_w_slice(unsigned char* sw, const T* wt, int pass, int C,
                                             int O, int ctid, int nthreads) {
  constexpr int kNpos = kNP / kOP;
  constexpr int kVec = 16 / sizeof(T);
  const int ch = C / kVec;
  for (int f = ctid; f < kNP * ch; f += nthreads) {
    const int nn = f / ch, c = f % ch;
    const int pq = pass * kNpos + nn / kOP, o = nn % kOP;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (o < O)
      v = __ldg(reinterpret_cast<const uint4*>(wt + (static_cast<int64_t>(pq) * O + o) * C) + c);
    if constexpr (sizeof(T) == 2) {
      *reinterpret_cast<uint4*>(sw + 2 * wg::cm_offset(nn, 8 * c, ch)) = v;
    } else {
      float* big = reinterpret_cast<float*>(sw);
      tf32::store_split4(big, big + kNP * C, tf32::chunk_offset(nn, c, ch),
                         make_float4(__uint_as_float(v.x), __uint_as_float(v.y),
                                     __uint_as_float(v.z), __uint_as_float(v.w)));
    }
  }
}

template <int N>
__device__ __forceinline__ void mma_bf16(float (&d)[N / 8][4], uint64_t a, uint64_t b) {
  if constexpr (N == 64) wg::mma_ss_n64<0>(d, a, b, 1);
  else if constexpr (N == 128) wg::mma_ss_n128(d, a, b, 1);
  else wg::mma_ss_n256(d, a, b, 1);
}
template <int N>
__device__ __forceinline__ void mma_tf32(float (&d)[N / 8][4], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64) wg::mma_tf32_rs_n64(d, a, b, 1);
  else if constexpr (N == 128) wg::mma_tf32_rs_n128(d, a, b, 1);
  else wg::mma_tf32_rs_n256(d, a, b, 1);
}

// fp32: the A fragment of k-step kc (columns 8 kc .. 8 kc + 7: chunks 2 kc
// and 2 kc + 1) of warp w's 16 pixels of an x tile [chunk][pixel][4], split
template <typename F>
__device__ __forceinline__ F frag_x(const float* x, int kc, int warp, int g, int t) {
  F a;
  const float* p0 = x + ((2 * kc) * kPix + warp * 16 + g) * 4 + t;
  const float* p1 = p0 + kPix * 4;
  a.set(0, p0[0]);
  a.set(1, p0[32]);
  a.set(2, p1[0]);
  a.set(3, p1[32]);
  return a;
}

// The quad's sums of v[r][pl] (row a or b, position pl of kNpos), scattered:
// lane t gets the sums with r * kNpos + pl = t (and t + 4 at kNpos 4):
// reduce-scatter by two xor shuffles (6 shuffles at 4 positions)
template <int kNpos>
__device__ __forceinline__ void quad_scatter(float (&v)[2][kNpos], int t, float (&out)[2]) {
  const bool b0 = t & 1, b1 = t & 2;
  if constexpr (kNpos == 4) {
    float w[2][2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int k = 0; k < 2; ++k) {  // positions 2k, 2k + 1: keep the one of t's parity
        const float keep = b0 ? v[r][2 * k + 1] : v[r][2 * k];
        const float send = b0 ? v[r][2 * k] : v[r][2 * k + 1];
        w[r][k] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // positions t & 1, 2 + (t & 1): keep the one of t's half
      const float keep = b1 ? w[r][1] : w[r][0];
      const float send = b1 ? w[r][0] : w[r][1];
      out[r] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
    }
  } else if constexpr (kNpos == 2) {
    float w[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float keep = b0 ? v[r][1] : v[r][0];
      const float send = b0 ? v[r][0] : v[r][1];
      w[r] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
    }
    const float keep = b1 ? w[1] : w[0];
    const float send = b1 ? w[0] : w[1];
    out[0] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
  } else {
    const float keep = b0 ? v[1][0] : v[0][0];
    const float send = b0 ? v[0][0] : v[1][0];
    const float w = keep + __shfl_xor_sync(0xffffffffu, send, 1);
    out[0] = w + __shfl_xor_sync(0xffffffffu, w, 2);
  }
}

template <typename T, int kOP, int kNP>
__global__ void __launch_bounds__(kGroupsOf<kNP> * 128 + 32, 1)
upscale2_hyper_kernel(const __grid_constant__ CUtensorMap xmap, const Params p) {
  using E = Elem<T>;
  constexpr int kNpos = kNP / kOP;     // positions a pass
  constexpr int kPasses = 4 / kNpos;
  constexpr int kSz = sizeof(T);
  constexpr int kCons = kGroupsOf<kNP> * 128;  // the producer warp's first thread
  const int C = p.C, S = p.stages, G = p.groups;
  const int xs = kPix * C * kSz;  // an x stage
  const int nm = (p.N + kMaps - 1) / kMaps * kMaps;  // the maps, by kMaps (rows past N zero)
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* ring = smem;
  unsigned char* sw = smem + S * xs;  // the w slice
  float* sB = reinterpret_cast<float*>(sw + kNP * C * (kSz == 2 ? 2 : 8));  // [kOP]
  float* groups = sB + kOP;  // per warpgroup: hyper [nm][kOP], out [N][4 kPix]
  const int gfloats = nm * kOP + p.N * 4 * kPix;
  uint64_t* full = reinterpret_cast<uint64_t*>(groups + G * gfloats);
  uint64_t* empty = full + S;

  const int tiles = p.B * p.per_b;
  const int first = static_cast<int>(static_cast<int64_t>(blockIdx.x) * tiles / gridDim.x);
  const int len = static_cast<int>(static_cast<int64_t>(blockIdx.x + 1) * tiles / gridDim.x) -
                  first;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], 128);
    }
    wg::mbar_init_fence();
  }
  for (int i = tid; i < kOP; i += blockDim.x) sB[i] = i < p.O ? p.bias[i] : 0.f;
  __syncthreads();

  if (tid >= kCons) {
    // the producer warp: lane 0 streams the x tiles in the order the
    // consumers take them (pass by pass over the range)
    if (tid == kCons) {
      for (int j = 0; j < kPasses * len; ++j) {
        const int s = j % S;
        if (j >= S) wg::mbar_wait(&empty[s], (j / S - 1) & 1);
        wg::mbar_expect_tx(&full[s], xs);
        tma::load_chunks(ring + s * xs, &xmap, C * kSz / 16, kSz,
                         static_cast<int>(tile_at(p, first + j % len).first), &full[s]);
      }
    }
    return;
  }
  if (tid >= G * 128) return;  // a warpgroup this launch leaves idle

  const int cw = tid >> 7, tg = tid & 127, warp = tg >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float* sH = groups + cw * gfloats;  // [nm][kOP]
  float* sOut = sH + nm * kOP;        // [N][2 rt][2 wc]
  const int ra = warp * 16 + g, rb = ra + 8;
  const T* hyper = static_cast<const T*>(p.hyper);
  const uint32_t wa = wg::smem_u32(sw);
  // a tile of whole 64-pixel rows (W >= 64): the output rows of a map are
  // 128 floats apart in sOut, and a full one is 32 16-byte stores
  const bool wide = p.rt == 1 && p.wc == kPix;
  int cur_b = -1;

#pragma unroll 1
  for (int pass = 0; pass < kPasses; ++pass) {
    consumers_sync(G);  // every product on the last slice is done
    load_w_slice<T, kOP, kNP>(sw, static_cast<const T*>(p.wt), pass, C, p.O, tid, G * 128);
    wg::fence_proxy_async();
    consumers_sync(G);
#pragma unroll 1
    for (int k = cw; k < len; k += G) {
      const int j = pass * len + k, s = j % S;
      const Tile tl = tile_at(p, first + k);
      if (tl.b != cur_b) {
        // the sample's hyper rows (the last tile's dots are done)
        group_sync(cw);
        for (int i = tg; i < nm * kOP; i += 128) {
          const int m = i / kOP, o = i % kOP;
          sH[i] = o < p.O && m < p.N
                      ? E::get(hyper[(static_cast<int64_t>(tl.b) * p.N + m) * p.O + o]) : 0.f;
        }
        group_sync(cw);
        cur_b = tl.b;
      }

      // the product: [64 pixels x C] x [C -> kNP]
      float acc[kNP / 8][4];
#pragma unroll
      for (int q = 0; q < kNP / 8; ++q) acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.f;
      wg::mbar_wait(&full[s], (j / S) & 1);
      wg::fence_proxy_async();
      unsigned char* xt = ring + s * xs;
      if constexpr (kSz == 2) {
        const uint32_t xa = wg::smem_u32(xt);
        wg::fence_regs(acc);
        wg::fence();
#pragma unroll 1
        for (int kc = 0; kc < C / 16; ++kc)
          mma_bf16<kNP>(acc, tma::desc_chunks(xa, kc), wg::desc_k(wa, C / 8, kc));
        wg::commit();
        wg::wait<0>();
        wg::fence_regs(acc);
      } else {
        const float* x = reinterpret_cast<const float*>(xt);
        const uint32_t small = wa + kNP * C * 4;  // w's small TF32 half
        // k-steps in pairs, each step's fragments loaded under the last
        // step's products (the registers of a step are free once its
        // products are done: wait<1> after the next step's commit)
        auto step = [&](const FragA& f, int kc) {
          wg::fence_regs(acc);
          wg::fence();
          mma_tf32<kNP>(acc, f.small, wg::desc_k(wa, C / 4, kc));
          mma_tf32<kNP>(acc, f.big, wg::desc_k(small, C / 4, kc));
          mma_tf32<kNP>(acc, f.big, wg::desc_k(wa, C / 4, kc));
          wg::commit();
          wg::wait<1>();
          wg::fence_regs(acc);
        };
        FragA a0 = frag_x<FragA>(x, 0, warp, g, t), a1;
#pragma unroll 1
        for (int kc = 0; kc < C / 8; kc += 2) {  // C / 8 is even
          step(a0, kc);
          a1 = frag_x<FragA>(x, kc + 1, warp, g, t);
          step(a1, kc + 1);
          if (kc + 2 < C / 8) a0 = frag_x<FragA>(x, kc + 2, warp, g, t);
        }
        wg::wait<0>();
        wg::fence_regs(acc);
      }
      wg::mbar_arrive(&empty[s]);

      // + b and the GELU, in place, on the columns of real outputs (o < O)
#pragma unroll
      for (int q = 0; q < kNP / 8; ++q) {
        const int o = (8 * q) % kOP + 2 * t;
        if ((8 * q) % kOP >= p.O) continue;
        const float b0 = sB[o], b1 = sB[o + 1];
        acc[q][0] = gelu_erf_as(acc[q][0] + b0);
        acc[q][1] = gelu_erf_as(acc[q][1] + b1);
        acc[q][2] = gelu_erf_as(acc[q][2] + b0);
        acc[q][3] = gelu_erf_as(acc[q][3] + b1);
      }
      group_sync(cw);  // the last tile's output is out of sOut
      // the hyper dot, kMaps maps at a time: this lane's columns, then the
      // quad's sums scattered over its lanes, each lane's into sOut
      int rowv[2], at[2];  // the lane's (row, position) values' pixel and place
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int v = t + 4 * u;  // value index r * kNpos + pl
        const int row = (v / kNpos) ? rb : ra, pq = pass * kNpos + v % kNpos;
        rowv[u] = v < 2 * kNpos && row < tl.cnt;
        at[u] = wide ? (pq >> 1) * (2 * kPix) + 2 * row + (pq & 1)
                     : (2 * (row / p.wc) + (pq >> 1)) * (2 * p.wc) + 2 * (row % p.wc) + (pq & 1);
      }
#pragma unroll 1
      for (int m0 = 0; m0 < p.N; m0 += kMaps) {
        float part[kMaps][2][kNpos];
#pragma unroll
        for (int mm = 0; mm < kMaps; ++mm)
#pragma unroll
          for (int pl = 0; pl < kNpos; ++pl) part[mm][0][pl] = part[mm][1][pl] = 0.f;
        const float* h = sH + m0 * kOP + 2 * t;
#pragma unroll
        for (int q = 0; q < kNP / 8; ++q) {
          if ((8 * q) % kOP >= p.O) continue;
          const int pl = (8 * q) / kOP;
#pragma unroll
          for (int mm = 0; mm < kMaps; ++mm) {
            const float2 hv = *reinterpret_cast<const float2*>(h + mm * kOP + (8 * q) % kOP);
            part[mm][0][pl] = fmaf(acc[q][1], hv.y, fmaf(acc[q][0], hv.x, part[mm][0][pl]));
            part[mm][1][pl] = fmaf(acc[q][3], hv.y, fmaf(acc[q][2], hv.x, part[mm][1][pl]));
          }
        }
#pragma unroll
        for (int mm = 0; mm < kMaps; ++mm) {
          float sums[2];
          quad_scatter<kNpos>(part[mm], t, sums);
          if (m0 + mm < p.N) {
#pragma unroll
            for (int u = 0; u < 2; ++u)
              if (rowv[u]) sOut[(m0 + mm) * 4 * kPix + at[u]] = sums[u];
          }
        }
      }
      group_sync(cw);

      // the tile's output rows in the final layout: rows 2 i0 .. of each map,
      // 2 wc floats a row, 16 bytes a thread (8 at an odd W); a pass of two
      // positions writes every other row, of one every other value
      float* ob = p.out + (static_cast<int64_t>(tl.b) * p.N * 2 * p.H + 2 * tl.i0) * 2 * p.W +
                  2 * tl.j0;
      const int64_t map_stride = static_cast<int64_t>(4) * p.H * p.W;
      if (kNpos == 4 && wide && tl.cnt == kPix && p.W % 2 == 0) {
        // two full rows of 128 floats a map: 64 16-byte stores a map
#pragma unroll 1
        for (int e = tg; e < p.N * 64; e += 128) {
          const int m = e >> 6, orow = (e >> 5) & 1, c = (e & 31) * 4;
          *reinterpret_cast<float4*>(ob + m * map_stride + orow * 2 * p.W + c) =
              *reinterpret_cast<const float4*>(sOut + m * 4 * kPix + orow * 2 * kPix + c);
        }
      } else {
        const int rows = 2 * (p.W >= kPix ? 1 : min(p.rt, p.H - tl.i0));
        const int cols = 2 * (p.W >= kPix ? min(kPix, p.W - tl.j0) : p.W);
        const int vec = kNpos == 1 ? 2 : (p.W % 2 == 0 ? 4 : 2);
        const int units = cols / vec;
        const int per_map = rows * units;
#pragma unroll 1
        for (int e = tg; e < p.N * per_map; e += 128) {
          const int m = e / per_map, rem = e % per_map;
          const int orow = rem / units, c = (rem % units) * vec;
          if (kNpos < 4 && (orow & 1) != (kNpos == 2 ? pass : pass >> 1)) continue;
          const float* src = sOut + m * 4 * kPix + orow * (2 * p.wc) + c;
          float* dst = ob + m * map_stride + orow * 2 * p.W + c;
          if (kNpos == 1)
            dst[pass & 1] = src[pass & 1];
          else if (vec == 4)
            *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
          else
            *reinterpret_cast<float2*>(dst) = *reinterpret_cast<const float2*>(src);
        }
      }
    }
  }
}

// The launch plan: positions of w resident a pass and consumer warpgroups,
// x stages and shared memory, for kop outputs a position (O padded): the
// first of (4 positions, 3 warpgroups), (4, 2), (2, 3), (2, 2), (1, 3), (1,
// 2), (4, 1), (2, 1), (1, 1) with n = positions x kop of 64 to 256, at most
// kGroupsOf<n> warpgroups and room for an x stage
struct Plan {
  int npos, groups, stages, smem;
};
Plan upscale_plan(int C, int kop, int N, int elem) {
  const int xs = kPix * C * elem;
  const int wpos = kop * C * (elem == 2 ? 2 : 8);  // one position's slice of w
  const int group = ((N + kMaps - 1) / kMaps * kMaps * kop + N * 4 * kPix) * 4;
  const int fixed = kop * 4 + 2 * kMaxStages * 8;
  static const int order[9][2] = {{4, 3}, {4, 2}, {2, 3}, {2, 2}, {1, 3},
                                  {1, 2}, {4, 1}, {2, 1}, {1, 1}};
  for (const auto& o : order) {
    const int npos = o[0], groups = o[1], n = npos * kop;
    if (n < 64 || groups > (n == 256 ? 2 : 3)) continue;
    const int rest = kSmemLimit - fixed - groups * group - npos * wpos;
    if (rest < xs) continue;
    const int stages = rest / xs < kMaxStages ? rest / xs : kMaxStages;
    return {npos, groups, stages,
            npos * wpos + kop * 4 + groups * group + 2 * stages * 8 + stages * xs};
  }
  return {0, 0, 0, 0};
}

template <typename T, int kOP, int kNP>
int launch_kernel(const CUtensorMap& map, const Params& p, int smem, cudaStream_t stream) {
  static int raised[wg::kMaxDevices] = {};
  auto kernel = upscale2_hyper_kernel<T, kOP, kNP>;
  constexpr int kThreads = kGroupsOf<kNP> * 128 + 32;
  cudaError_t err = wg::raise_shared_memory(reinterpret_cast<const void*>(kernel), smem, raised);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  const int64_t tiles = static_cast<int64_t>(p.B) * p.per_b;
  const int64_t ctas = static_cast<int64_t>(wg::sm_count()) * (per_sm > 0 ? per_sm : 1);
  kernel<<<static_cast<unsigned>(tiles < ctas ? tiles : ctas), kThreads, smem, stream>>>(map, p);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* wt, const void* bias, const void* hyper, void* out, int B,
           int H, int W, int C, int O, int N, cudaStream_t stream) {
  Params p{wt, static_cast<const float*>(bias), hyper, static_cast<float*>(out), B, H, W, C, O, N};
  // the tile: 64 columns of a row, or 64 / W whole rows
  p.wc = W >= kPix ? kPix : W;
  p.rt = W >= kPix ? 1 : kPix / W;
  p.tiles_w = (W + p.wc - 1) / p.wc;
  const int64_t per_b = static_cast<int64_t>((H + p.rt - 1) / p.rt) * p.tiles_w;
  const int64_t pixels = static_cast<int64_t>(B) * H * W;
  if (per_b * B > 0x7fffffff || pixels > 0x7fffffff) return cudaErrorInvalidValue;
  p.per_b = static_cast<int>(per_b);
  const int kop = O <= 32 ? 32 : 64;
  const Plan plan = upscale_plan(C, kop, N, sizeof(T));
  if (!plan.npos) return cudaErrorInvalidValue;
  p.stages = plan.stages;
  p.groups = plan.groups;
  CUtensorMap map;
  cudaError_t err = tma::chunk_map(&map, x, static_cast<uint64_t>(pixels), C, sizeof(T), kPix);
  if (err != cudaSuccess) return err;
  if (kop == 32)
    return plan.npos == 4 ? launch_kernel<T, 32, 128>(map, p, plan.smem, stream)
                          : launch_kernel<T, 32, 64>(map, p, plan.smem, stream);
  return plan.npos == 4   ? launch_kernel<T, 64, 256>(map, p, plan.smem, stream)
         : plan.npos == 2 ? launch_kernel<T, 64, 128>(map, p, plan.smem, stream)
                          : launch_kernel<T, 64, 64>(map, p, plan.smem, stream);
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
      O > 64 || O % 8 != 0 || N < 1 || N > kMaxN)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? launch<float>(x, wt, b, hyper, out, B, H, W, C, O, N, s)
             : launch<uint16_t>(x, wt, b, hyper, out, B, H, W, C, O, N, s);
}
