// The SAM mask decoder's upscale tail in one pass, per input pixel x [256]:
//
//   z   = x @ W1 + b1 for the 4 output positions (p, q), 64 channels each
//   y   = T(gelu(LN_64(z)))                          (eps 1e-6, fp32 stats)
//   u   = T(gelu(y @ W2 + b2)) for the 4 sub-positions (r, s), 32 each
//   out[m][4i + 2p + r, 4j + 2q + s] = sum_o u[o] * T(hyper[m][o])   (fp32)
//
// Replaces the TPU kernel cor_tpu/ops/pallas/decoder_tail.py:
// fused_decoder_tail (its pallas_call at line 150). As there, the two
// transposed convolutions, the LayerNorm, both GELUs and the hypernetwork
// dot run on a tile of input pixels without any intermediate reaching
// device memory: the only output is the fp32 mask of every map. The TPU
// kernel folds the LN mean into W1 and takes the variance from bf16
// operands; here the statistics are fp32 (closer to the exact function).
// GELU is the _PHI_COEF polynomial of cor_tpu's bf16 path, and the exact
// erf form in fp32 (cor_tpu's _gelu_exact).
//
// Redesigned for Hopper. What held the first kernel back (PERF.md): one
// 4-warp CTA per (grid row, candidate, map) staged W1 (128 KiB in bf16, 256
// KiB in fp32) through shared memory in four 64-output slices per row, each
// a load, a barrier and then mma.sync, at 2 CTAs an SM in bf16 and 1 in
// fp32 (174,080 B); and every map m ran both products, the LayerNorm and
// both GELUs again, though only the hypernetwork dot depends on m. Here:
//
//  - a persistent grid, one CTA an SM; the grid has no map dimension: every
//    map's dot is taken from the same GELU'd u (the hypernetwork values of
//    one map at a time in registers), each map's sums in the first
//    kernel's order;
//  - bf16: an item is one 64-pixel grid row, each of four warpgroups
//    taking one position (p, q): 16 warps an SM for the GELUs, which set
//    the time (two warpgroups of two positions each issued at half the
//    rate; a 17th, producer warp capped the threads at 96 registers and
//    they spilled). W1 ([(p, q, o1)][256], 128 KiB) and W2 ([(r, s,
//    o2)][64], 16 KiB) stay resident in shared memory for the CTA's life,
//    loaded once by TMA bulk copies out of the wrapper's core-matrix pack;
//    the row tiles come by cp.async (4 chunks a thread) into a 2-deep ring
//    (2 x 32 KiB), two items ahead. A position's first product is a wgmma
//    m64n64k16 chain (the same products in the same k order as mma.sync:
//    the first kernel's bits), the next item's issued under this item's
//    GELUs and dots; the second product two wgmma m64n64k16 halves
//    (sub-positions 0-1, 2-3) with A from registers (the GELU'd, rounded
//    accumulators re-packed as mma.sync's A fragments). The two warpgroups
//    of one output row pair stage their maps' rows in shared memory (4
//    maps; more go out from registers) and write them whole, 16 bytes a
//    thread. 230,336 B of shared memory;
//  - fp32: W1 (256 KiB) cannot stay. An item is two grid rows, one a
//    warpgroup, each row tile ([64][256] fp32, 16-byte chunks XOR-swizzled
//    by row: conflict-free TF32 fragments) in its warpgroup's buffer; W1
//    streams through a 3-stage ring of [64 outputs][16 inputs] blocks that
//    two producer warps split once into their TF32 halves, each block
//    serving both rows; W2 is split once per CTA and stays (64 KiB, its k
//    permuted within each 8 as mma_tf32x3.cuh's C-to-A reuse takes it).
//    The first product is 3xTF32 wgmma m64n64k8 with A from registers (the
//    next block's fragments split under the current block's products), the
//    second two m64n64k8 halves in 3xTF32 with A from registers, one after
//    the other (both in flight spilled). Map 0's rows are staged, others go
//    out from registers. 230,352 B;
//  - the LayerNorm statistics are quad reductions of the accumulator
//    fragments, as before (wgmma's accumulator layout is mma.sync's).
//
// What bounds it on the H100: per candidate 2 MiB of bf16 input (4 MiB in
// fp32), 0.25 MiB of fp32 output a map, and 2 * 4096 * (256 * 256 + 4 * 64
// * 128) = 0.81 GFLOP on the tensor cores (3x that in fp32's 3xTF32 at half
// bf16's rate), plus about 3.1 M GELUs per candidate (4096 pixels x (256
// after the LayerNorm + 512 after the second product)) on the CUDA cores,
// with the LayerNorm and the dot: in bf16 the CUDA cores' share is the
// larger (chip_smoke.py's bound counts both).

#include "decoder_common.cuh"
#include "tf32_tiles.cuh"
#include "twl_hopper.cuh"
#include "wgmma.cuh"

namespace {

using namespace cor;

constexpr int kO1 = 64, kO2 = 32, kW = 64;  // convT1 out, convT2 out, grid width
constexpr int kVecLen = 3 * kO1 + kO2;     // b1, ln scale, ln bias, b2

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

template <int R>
__device__ __forceinline__ void zero(float (&d)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i][0] = d[i][1] = d[i][2] = d[i][3] = 0.f;
}

// + b1 and the LayerNorm over the 64 channels of a position, for pixels g
// and g + 8 of this warp's 16 (rows of the accumulator fragments), then
// GELU: the first kernel's arithmetic. Each of the 4 values of tile n is
// handed to emit(n, y0, y1, y2, y3) (row g columns 8n + 2t, + 1; row g + 8).
template <typename T, typename Emit>
__device__ __forceinline__ void layer_norm_gelu(float (&a1)[kO1 / 8][4], const float* b1,
                                                const float* lns, const float* lnb, float eps,
                                                int t, Emit emit) {
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
#pragma unroll
  for (int n = 0; n < kO1 / 8; ++n) {
    const int c = n * 8 + 2 * t;
    emit(n, gelu<T>((a1[n][0] - ma) * ia * lns[c] + lnb[c]),
         gelu<T>((a1[n][1] - ma) * ia * lns[c + 1] + lnb[c + 1]),
         gelu<T>((a1[n][2] - mb) * ib * lns[c] + lnb[c]),
         gelu<T>((a1[n][3] - mb) * ib * lns[c + 1] + lnb[c + 1]));
  }
}

// u (the second product's tiles n0 .. n0 + NU - 1 of 16: sub-position rs =
// n / 4, o2 = (n % 4) * 8 + 2t, + 1) -> T(gelu(u + b2)), in place
template <typename T, int NU>
__device__ __forceinline__ void second_gelu(float (&u)[NU][4], int n0, const float* b2, int t) {
#pragma unroll
  for (int k = 0; k < NU; ++k) {
    const int o = ((n0 + k) & 3) * 8 + 2 * t;
    u[k][0] = Elem<T>::round(gelu<T>(u[k][0] + b2[o]));
    u[k][1] = Elem<T>::round(gelu<T>(u[k][1] + b2[o + 1]));
    u[k][2] = Elem<T>::round(gelu<T>(u[k][2] + b2[o]));
    u[k][3] = Elem<T>::round(gelu<T>(u[k][3] + b2[o + 1]));
  }
}

// map mo's hypernetwork values this lane multiplies: o2 = nn * 8 + 2t (+ 1)
template <typename T>
__device__ __forceinline__ void load_hyper(const T* hyper, int mo, int t, float (&hv)[4][2]) {
  const T* hp = hyper + static_cast<int64_t>(mo) * kO2;
#pragma unroll
  for (int nn = 0; nn < 4; ++nn) {
    hv[nn][0] = Elem<T>::get(hp[nn * 8 + 2 * t]);
    hv[nn][1] = Elem<T>::get(hp[nn * 8 + 2 * t + 1]);
  }
}

// Every map's hypernetwork dot of the GELU'd u of one position (p, q) (its
// tiles n0 .. n0 + NU - 1, whole sub-positions rs), in the first kernel's
// order: per rs the 4 x 2 products of a lane, then the quad's sum. The
// quad's lane 0 puts the two pixels' values of output row 2p + rs / 2 (row
// `orow` of the item's 4) through put(map, orow, column, value). Map 0's
// values come loaded (hv0: at the item's start, under its products), each
// next map's are loaded under the current map's dots.
template <typename T, int NU, typename Put>
__device__ __forceinline__ void hyper_dots(const float (&u)[NU][4], int n0,
                                           const float (&hv0)[4][2], const T* hyper, int m,
                                           int p, int q, int warp, int g, int t, Put put) {
  float hv[4][2];
#pragma unroll
  for (int nn = 0; nn < 4; ++nn) hv[nn][0] = hv0[nn][0], hv[nn][1] = hv0[nn][1];
#pragma unroll 1
  for (int mo = 0; mo < m; ++mo) {
    float hn[4][2];
    if (mo + 1 < m) load_hyper(hyper, mo + 1, t, hn);
#pragma unroll
    for (int rs0 = 0; rs0 < NU / 4; ++rs0) {
      const int rs = n0 / 4 + rs0;
      float da = 0.f, db = 0.f;
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        const int k = rs0 * 4 + nn;
        da += u[k][0] * hv[nn][0] + u[k][1] * hv[nn][1];
        db += u[k][2] * hv[nn][0] + u[k][3] * hv[nn][1];
      }
      da = quad_sum(da);
      db = quad_sum(db);
      if (t == 0) {
        const int orow = 2 * p + (rs >> 1), col = 4 * (warp * 16 + g) + 2 * q + (rs & 1);
        put(mo, orow, col, da);
        put(mo, orow, col + 32, db);  // pixel + 8
      }
    }
    if (mo + 1 < m) {
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) hv[nn][0] = hn[nn][0], hv[nn][1] = hn[nn][1];
    }
  }
}

// ---------------------------------------------------------------- bf16 ----

struct TailB {
  static constexpr int kConsumers = 4;  // warpgroups: one a position (p, q)
  // no producer warp: 17 warps would cap a thread at 96 registers (a
  // sub-partition's 16,384 over 5 warps), and the consumers spilled there
  static constexpr int kThreads = kConsumers * 128;
  static constexpr int kW1 = 4 * kO1 * kC * 2;   // W1 [256][256] bf16, core-matrix
  static constexpr int kW2 = 4 * kO2 * kO1 * 2;  // W2 [128][64]
  static constexpr int kRowsB = kW * kC * 2;     // a row tile [64][256]
  static constexpr int kStaged = 4;              // maps staged in shared memory
  static constexpr int kOutB = kStaged * 2 * 4 * kW * 4;  // a row pair's staged maps
  static constexpr int kOffW2 = kW1, kOffRows = kOffW2 + kW2, kOffOut = kOffRows + 2 * kRowsB,
                       kOffVec = kOffOut + 2 * kOutB, kOffBars = kOffVec + kVecLen * 4;
  static constexpr int kSmem = kOffBars + 8 * 8;  // w_full[4], rows_full[2], rows_empty[2]
  static_assert(kSmem <= 232448, "K3 bf16: shared memory");
};

// the two warpgroups of output rows 2p and 2p + 1 (positions (p, 0) and (p,
// 1)): named barrier 1 + p, 256 threads
__device__ __forceinline__ void pair_sync(int p) {
  if (p == 0)
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 256;\n" ::: "memory");
}

__device__ __forceinline__ void tail_bf16(unsigned char* smem, const uint16_t* __restrict__ src,
                                          const uint16_t* __restrict__ w_blocks,
                                          const float* __restrict__ vec,
                                          const uint16_t* __restrict__ hyper, int n, int m, int H,
                                          float eps, float* __restrict__ out) {
  using L = TailB;
  constexpr int kQuarter = L::kW1 / 4;  // a position's 64 rows of W1
  float* sVec = reinterpret_cast<float*>(smem + L::kOffVec);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::kOffBars);
  uint64_t* w_full = bar;
  uint64_t* rows_full = bar + 4;
  uint64_t* rows_empty = bar + 6;
  const int items = n * H;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) wg::mbar_init(&w_full[i], 1);
    for (int i = 0; i < 2; ++i) {
      wg::mbar_init(&rows_full[i], 2 * L::kThreads);
      wg::mbar_init(&rows_empty[i], L::kThreads);
    }
    wg::mbar_init_fence();
    // the weights, once, 16 KiB a copy: W2 with W1's position 0, then
    // positions 1-3, each on its own barrier
    constexpr int kCopy = 16384;
    for (int pq = 0; pq < 4; ++pq) {
      wg::mbar_expect_tx(&w_full[pq], kQuarter + (pq == 0 ? L::kW2 : 0));
      for (int o = pq * kQuarter; o < (pq + 1) * kQuarter; o += kCopy)
        wg::bulk_copy(smem + o, w_blocks + o / 2, kCopy, &w_full[pq]);
      if (pq == 0) wg::bulk_copy(smem + L::kOffW2, w_blocks + L::kW1 / 2, L::kW2, &w_full[0]);
    }
  }
  for (int i = tid; i < kVecLen; i += blockDim.x) sVec[i] = vec[i];
  // every thread brings 4 of a row tile's 2,048 16-byte chunks into a ring
  // stage (the core-matrix layout), then arrives on its full barrier
  auto load_rows = [&](int item, int s) {
    const uint16_t* x = src + static_cast<int64_t>(item) * kW * kC;
    uint16_t* dst = reinterpret_cast<uint16_t*>(smem + L::kOffRows + s * L::kRowsB);
#pragma unroll
    for (int f = tid; f < kW * (kC / 8); f += L::kThreads) {
      int r, c;
      tf32::chunk_of<kC / 8>(f, r, c);
      wg::cp16(dst + wg::cm_offset(r, c * 8, kC / 8), x + r * kC + c * 8, 16u);
    }
    wg::mbar_arrive_copies(&rows_full[s]);
    wg::mbar_arrive(&rows_full[s]);
  };
  __syncthreads();  // the barriers initialised
  if (static_cast<int>(blockIdx.x) < items) load_rows(blockIdx.x, 0);
  if (static_cast<int>(blockIdx.x + gridDim.x) < items) load_rows(blockIdx.x + gridDim.x, 1);

  // warpgroup w: position (p, q) = (w / 2, w % 2) of every item
  const int w = tid >> 7, tg = tid & 127, warp = tg >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, p = w >> 1, q = w & 1;
  const float* b1 = sVec;
  const float* lns = sVec + kO1;
  const float* lnb = sVec + 2 * kO1;
  const float* b2 = sVec + 3 * kO1;
  float* sOut = reinterpret_cast<float*>(smem + L::kOffOut + p * L::kOutB);  // [kStaged][2][256]
  const uint32_t w1a = wg::smem_u32(smem) + w * kQuarter;
  const uint32_t w2a = wg::smem_u32(smem + L::kOffW2);
  const uint32_t rows0 = wg::smem_u32(smem + L::kOffRows);
  wg::mbar_wait(&w_full[0], 0);
  if (w > 0) wg::mbar_wait(&w_full[w], 0);
  wg::fence_proxy_async();

  float acc[kO1 / 8][4], u[8][4];
  uint32_t a2[kO1 / 16][4];
  // the first product: rows [64][256] . this position's 64 outputs of W1
  auto first = [&](uint32_t rows) {
    zero(acc);
    wg::fence_regs(acc);
    wg::fence();
#pragma unroll
    for (int kc = 0; kc < kC / 16; ++kc)
      wg::mma_ss_n64<0>(acc, wg::desc_k(rows, kC / 8, kc), wg::desc_k(w1a, kC / 8, kc), 1);
    wg::commit();
  };
  // the second product's 64 outputs of sub-positions 2 half, 2 half + 1: the
  // GELU'd, rounded first product (a2) . W2's rows 64 half ..
  auto second = [&](int half) {
    zero(u);
    wg::fence_regs(u);
    wg::fence();
#pragma unroll
    for (int kc = 0; kc < kO1 / 16; ++kc)
      wg::mma_rs_n64<0>(u, a2[kc], wg::desc_k(w2a + half * (L::kW2 / 2), kO1 / 8, kc), 1);
    wg::commit();
  };

  int it = 0;
  if (static_cast<int>(blockIdx.x) < items) {
    wg::mbar_wait(&rows_full[0], 0);
    wg::fence_proxy_async();
    first(rows0);
  }
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
    const int s = it & 1;
    const int cand = item / H, i = item % H;
    const uint16_t* hyp = hyper + static_cast<int64_t>(cand) * m * kO2;
    float* orow0 = out + (static_cast<int64_t>(cand) * m * 4 * H + 4 * i) * (4 * kW);
    auto put = [&](int mo, int orow, int col, float v) {
      if (mo < L::kStaged)
        sOut[(mo * 2 + (orow & 1)) * (4 * kW) + col] = v;
      else
        orow0[(static_cast<int64_t>(mo) * 4 * H + orow) * (4 * kW) + col] = v;
    };
    float hv0[4][2];  // map 0's hypernetwork values, loaded under the products
    load_hyper(hyp, 0, t, hv0);
    wg::wait<0>();  // this item's first product (issued under the last item's dots)
    wg::fence_regs(acc);
    wg::mbar_arrive(&rows_empty[s]);  // this warpgroup's last read of the rows
    // LN and GELU, rounded and packed as the second product's A fragments
    // (tiles 2kc and 2kc + 1: k-step kc)
    layer_norm_gelu<uint16_t>(acc, b1, lns, lnb, eps, t,
                              [&](int nt, float y0, float y1, float y2, float y3) {
                                a2[nt >> 1][(nt & 1) * 2 + 0] = pack_bf16x2(y0, y1);
                                a2[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16x2(y2, y3);
                              });
    second(0);
    const int next = item + gridDim.x;
    if (next < items) {  // the next item's first product, under the dots
      wg::mbar_wait(&rows_full[s ^ 1], ((it + 1) >> 1) & 1);
      wg::fence_proxy_async();
      first(rows0 + (s ^ 1) * L::kRowsB);
      wg::wait<1>();
    } else {
      wg::wait<0>();
    }
    wg::fence_regs(u);
    second_gelu<uint16_t>(u, 0, b2, t);
    hyper_dots<uint16_t>(u, 0, hv0, hyp, m, p, q, warp, g, t, put);
    if (next + static_cast<int>(gridDim.x) < items) {
      // the item after next's rows into this stage, once every warpgroup's
      // first product has read it
      wg::mbar_wait(&rows_empty[s], (it >> 1) & 1);
      load_rows(next + gridDim.x, s);
    }
    second(1);
    wg::wait<0>();
    wg::fence_regs(u);
    wg::fence_regs(acc);
    second_gelu<uint16_t>(u, 8, b2, t);
    hyper_dots<uint16_t>(u, 8, hv0, hyp, m, p, q, warp, g, t, put);
    // the staged maps' rows 2p and 2p + 1, 16 bytes a thread of the pair
    pair_sync(p);
    const int staged = m < L::kStaged ? m : L::kStaged;
    for (int e = q * 128 + tg; e < staged * 128; e += 256)
      reinterpret_cast<float4*>(orow0 + (static_cast<int64_t>(e >> 7) * 4 * H + 2 * p) *
                                            (4 * kW))[e & 127] =
          reinterpret_cast<const float4*>(sOut + (e >> 7) * 2 * (4 * kW))[e & 127];
    pair_sync(p);
  }
  cp_async_wait<0>();  // exit with no copy in flight
}

// ---------------------------------------------------------------- fp32 ----

struct TailF {
  static constexpr int kThreads = 2 * 128 + 3 * 32;  // 2 consumer warpgroups, 3 producer warps
  static constexpr int kWWarps = 2;                  // producer warps that split W1's blocks
  static constexpr int kRowsB = kW * kC * 4;         // a row tile [64][256], swizzled
  static constexpr int kKB = 16;                     // a ring block: [64 outputs][16 inputs]
  static constexpr int kStageB = kO1 * kKB * 8;      // ... as its TF32 halves
  static constexpr int kStages = 3;
  static constexpr int kBlocks = 4 * (kC / kKB);     // ring blocks an item: 4 positions
  static constexpr int kW2Half = 4 * kO2 * kO1 * 4;  // one TF32 half of W2 [128][64]
  static constexpr int kStaged = 1;                  // maps staged in shared memory
  static constexpr int kOutB = kStaged * 4 * 4 * kW * 4;  // a warpgroup's staged rows
  static constexpr int kOffW2 = 2 * kRowsB, kOffRing = kOffW2 + 2 * kW2Half,
                       kOffOut = kOffRing + kStages * kStageB, kOffVec = kOffOut + 2 * kOutB,
                       kOffBars = kOffVec + kVecLen * 4;
  // full[kStages], empty[kStages], rows_full[2], rows_empty[2]
  static constexpr int kSmem = kOffBars + (2 * kStages + 4) * 8;
  static_assert(kSmem <= 232448, "K3 fp32: shared memory");
};

// the float offset of element (r, k) of a swizzled fp32 row tile [64][256]:
// 16-byte chunk k / 4 of row r at chunk (k / 4) ^ (r % 8)
__device__ __forceinline__ int swz(int r, int k) {
  return r * kC + ((((k >> 2) ^ (r & 7))) << 2) + (k & 3);
}

// the A fragment of this warp's 16 pixels (row0 ..), inputs k0 .. k0 + 7,
// of a swizzled row tile: load_a_tf32's
__device__ __forceinline__ FragA load_a_swz(const float* rows, int row0, int k0, int g, int t) {
  FragA a;
  const int r = row0 + g;
  a.set(0, rows[swz(r, k0 + t)]);
  a.set(1, rows[swz(r + 8, k0 + t)]);
  a.set(2, rows[swz(r, k0 + t + 4)]);
  a.set(3, rows[swz(r + 8, k0 + t + 4)]);
  return a;
}

// W1 block j of an item (position j / 16, inputs (j % 16) * 16 ..) from w1t
// [(p, q, o1)][256]: the chunks producer lane pl (of kWWarps * 32) moves
constexpr int kPerLaneF = kO1 * (TailF::kKB / 4) / (TailF::kWWarps * 32);
__device__ __forceinline__ void fetch_w1(const float* w1t, int j, int pl,
                                         float4 (&r)[kPerLaneF]) {
  const int pq = j / (kC / TailF::kKB), kb = j % (kC / TailF::kKB);
#pragma unroll
  for (int u = 0; u < kPerLaneF; ++u) {
    int o, ch;
    tf32::chunk_of<TailF::kKB / 4>(pl + TailF::kWWarps * 32 * u, o, ch);
    r[u] = __ldg(reinterpret_cast<const float4*>(
                     w1t + static_cast<int64_t>(pq * kO1 + o) * kC + kb * TailF::kKB) + ch);
  }
}
__device__ __forceinline__ void place_w1(unsigned char* stage, int pl,
                                         const float4 (&r)[kPerLaneF]) {
  float* dst = reinterpret_cast<float*>(stage);
#pragma unroll
  for (int u = 0; u < kPerLaneF; ++u) {
    int o, ch;
    tf32::chunk_of<TailF::kKB / 4>(pl + TailF::kWWarps * 32 * u, o, ch);
    tf32::store_split4(dst, dst + kO1 * TailF::kKB, tf32::chunk_offset(o, ch, TailF::kKB / 4),
                       r[u]);
  }
}

__device__ __forceinline__ void tail_f32(unsigned char* smem, const float* __restrict__ src,
                                         const float* __restrict__ w1t,
                                         const float* __restrict__ w2t,
                                         const float* __restrict__ vec,
                                         const float* __restrict__ hyper, int n, int m, int H,
                                         float eps, float* __restrict__ out) {
  using L = TailF;
  float* sW2 = reinterpret_cast<float*>(smem + L::kOffW2);  // big, then small
  unsigned char* ring = smem + L::kOffRing;
  float* sVec = reinterpret_cast<float*>(smem + L::kOffVec);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::kOffBars);
  uint64_t* full = bar;
  uint64_t* empty = bar + L::kStages;
  uint64_t* rows_full = bar + 2 * L::kStages;
  uint64_t* rows_empty = bar + 2 * L::kStages + 2;
  const int per = (H + 1) / 2;  // items of a candidate: grid rows 2k (warpgroup 0), 2k + 1
  const int items = n * per;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      wg::mbar_init(&full[s], L::kWWarps * 32);
      wg::mbar_init(&empty[s], 2 * 128);
    }
    for (int i = 0; i < 2; ++i) {
      wg::mbar_init(&rows_full[i], 2 * 32);
      wg::mbar_init(&rows_empty[i], 128);
    }
    wg::mbar_init_fence();
  }
  for (int i = tid; i < kVecLen; i += blockDim.x) sVec[i] = vec[i];
  // W2 [(r, s, o2)][64], split once into its TF32 halves, K-major, each row's
  // k permuted within every 8 to the order a C tile reused as A takes
  // (mma_tf32x3.cuh): k = 8n + 2t at position t, 8n + 2t + 1 at t + 4
  for (int e = tid; e < 4 * kO2 * kO1; e += blockDim.x) {
    const int o = e / kO1, k = e % kO1;
    const int pos = (k & ~7) + ((k & 7) >> 1) + ((k & 1) << 2);
    uint32_t big, small;
    split_tf32(__ldg(w2t + e), big, small);
    const int off = tf32::chunk_offset(o, pos >> 2, kO1 / 4) + (pos & 3);
    reinterpret_cast<uint32_t*>(sW2)[off] = big;
    reinterpret_cast<uint32_t*>(sW2)[L::kW2Half / 4 + off] = small;
  }
  __syncthreads();

  if (tid >= 256) {
    const int pw = (tid - 256) >> 5, lane = tid & 31;
    if (pw < L::kWWarps) {
      // W1's ring: kBlocks blocks an item, in the consumers' order, fetched
      // one block ahead and split into TF32 halves
      const int pl = tid - 256;
      const int total = (items - blockIdx.x + gridDim.x - 1) / gridDim.x * L::kBlocks;
      float4 r[2][kPerLaneF];
      if (total > 0) fetch_w1(w1t, 0, pl, r[0]);
      for (int j0 = 0; j0 < total; j0 += 2) {
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          const int j = j0 + d, s = j % L::kStages;
          if (j >= total) break;
          if (j + 1 < total) fetch_w1(w1t, (j + 1) % L::kBlocks, pl, r[d ^ 1]);
          if (j >= L::kStages) wg::mbar_wait(&empty[s], (j / L::kStages - 1) & 1);
          place_w1(ring + s * L::kStageB, pl, r[d]);
          wg::mbar_arrive(&full[s]);
        }
      }
    } else {
      // the row tiles: a warpgroup's row of the next item once its first
      // products are done
      int it = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
        const int cand = item / per;
        for (int gi = 0; gi < 2; ++gi) {
          const int i = 2 * (item % per) + gi;
          if (it > 0) wg::mbar_wait(&rows_empty[gi], (it - 1) & 1);
          if (i < H) {
            const float* x = src + (static_cast<int64_t>(cand) * H + i) * kW * kC;
            float* dst = reinterpret_cast<float*>(smem + gi * L::kRowsB);
#pragma unroll 4
            for (int f = lane; f < kW * (kC / 4); f += 32) {
              const int rr = f / (kC / 4), c = f % (kC / 4);
              wg::cp16(dst + swz(rr, 4 * c), x + rr * kC + 4 * c, 16u);
            }
          }
          wg::mbar_arrive_copies(&rows_full[gi]);
          wg::mbar_arrive(&rows_full[gi]);
        }
      }
      cp_async_wait<0>();  // exit with no copy in flight
    }
    return;
  }

  // consumer warpgroup w: grid row 2k + w of item k of a candidate
  const int w = tid >> 7, tg = tid & 127, warp = tg >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* b1 = sVec;
  const float* lns = sVec + kO1;
  const float* lnb = sVec + 2 * kO1;
  const float* b2 = sVec + 3 * kO1;
  const float* rows = reinterpret_cast<const float*>(smem + w * L::kRowsB);
  float* sOut = reinterpret_cast<float*>(smem + L::kOffOut + w * L::kOutB);  // [kStaged][4][256]
  const uint32_t ring_addr = wg::smem_u32(ring);
  const uint32_t w2a = wg::smem_u32(sW2);
  constexpr uint32_t kSmallW1 = kO1 * L::kKB * 4;  // a block's small half, bytes on
  wg::fence_proxy_async();  // W2's halves, stored before the block's barrier, read by wgmma
  int j = 0, it = 0;

  for (int item = blockIdx.x; item < items; item += gridDim.x, ++it) {
    const int cand = item / per, i = 2 * (item % per) + w;
    const bool valid = i < H;
    const float* hyp = hyper + static_cast<int64_t>(cand) * m * kO2;
    float* orow0 = out + (static_cast<int64_t>(cand) * m * 4 * H + 4 * i) * (4 * kW);
    auto put = [&](int mo, int orow, int col, float v) {
      if (mo < L::kStaged)
        sOut[(mo * 4 + orow) * (4 * kW) + col] = v;
      else
        orow0[(static_cast<int64_t>(mo) * 4 * H + orow) * (4 * kW) + col] = v;
    };
    float hv0[4][2];  // map 0's hypernetwork values, loaded under the products
    load_hyper(hyp, 0, t, hv0);
    wg::mbar_wait(&rows_full[w], it & 1);
#pragma unroll 1
    for (int pq = 0; pq < 4; ++pq) {
      // the first product over the ring's 16 blocks of this position, A from
      // the rows split into TF32 halves one block ahead
      float acc[kO1 / 8][4];
      zero(acc);
      FragA a0[2], a1[2];
      auto load_blk = [&](FragA (&a)[2], int kb) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) a[kk] = load_a_swz(rows, warp * 16, kb * L::kKB + kk * 8, g, t);
      };
      auto issue_blk = [&](FragA (&a)[2]) {
        const int s = j % L::kStages;
        wg::mbar_wait(&full[s], (j / L::kStages) & 1);
        wg::fence_proxy_async();
        const uint32_t stage = ring_addr + s * L::kStageB;
        wg::fence_regs(acc);
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          wg::mma_tf32_rs_n64(acc, a[kk].small, wg::desc_k(stage, L::kKB / 4, kk), 1);
          wg::mma_tf32_rs_n64(acc, a[kk].big, wg::desc_k(stage + kSmallW1, L::kKB / 4, kk), 1);
          wg::mma_tf32_rs_n64(acc, a[kk].big, wg::desc_k(stage, L::kKB / 4, kk), 1);
        }
        wg::commit();
        return s;
      };
      load_blk(a0, 0);
      int prev = -1;
#pragma unroll 1
      for (int kb = 0; kb < kC / L::kKB; kb += 2) {
        int s = issue_blk(a0);
        ++j;
        wg::wait<1>();  // the block before: its A registers (a1) and stage free
        wg::fence_regs(acc);
        if (prev >= 0) wg::mbar_arrive(&empty[prev]);
        prev = s;
        load_blk(a1, kb + 1);
        s = issue_blk(a1);
        ++j;
        wg::wait<1>();
        wg::fence_regs(acc);
        wg::mbar_arrive(&empty[prev]);
        prev = s;
        if (kb + 2 < kC / L::kKB) load_blk(a0, kb + 2);
      }
      wg::wait<0>();
      wg::fence_regs(acc);
      wg::mbar_arrive(&empty[prev]);
      if (pq == 3) wg::mbar_arrive(&rows_empty[w]);  // the rows' last reader is done
      if (!valid) continue;
      // LN and GELU, each tile n the A fragment of k-step n in the permuted
      // order (a_from_c_tf32); the second product in two 64-column halves
      // (sub-positions 0-1, 2-3), one after the other (two in flight spilled)
      FragA fa[kO1 / 8];
      layer_norm_gelu<float>(acc, b1, lns, lnb, eps, t,
                             [&](int nt, float y0, float y1, float y2, float y3) {
                               fa[nt] = a_from_c_tf32(y0, y1, y2, y3);
                             });
      float uh[8][4];
      auto second_half = [&](int half) {
        const uint32_t big = w2a + half * (L::kW2Half / 2), small = big + L::kW2Half;
        zero(uh);
        wg::fence_regs(uh);
        wg::fence();
#pragma unroll
        for (int k = 0; k < kO1 / 8; ++k) {
          wg::mma_tf32_rs_n64(uh, fa[k].small, wg::desc_k(big, kO1 / 4, k), 1);
          wg::mma_tf32_rs_n64(uh, fa[k].big, wg::desc_k(small, kO1 / 4, k), 1);
          wg::mma_tf32_rs_n64(uh, fa[k].big, wg::desc_k(big, kO1 / 4, k), 1);
        }
        wg::commit();
      };
      const int p = pq >> 1, q = pq & 1;
#pragma unroll 1
      for (int half = 0; half < 2; ++half) {
        second_half(half);
        wg::wait<0>();
        wg::fence_regs(uh);
        second_gelu<float>(uh, 8 * half, b2, t);
        hyper_dots<float>(uh, 8 * half, hv0, hyp, m, p, q, warp, g, t, put);
      }
    }
    if (!valid) continue;
    // the staged maps' 4 rows, 16 bytes a thread
    wg::group_sync(w);
    const int staged = m < L::kStaged ? m : L::kStaged;
    for (int mo = 0; mo < staged; ++mo) {
      for (int e = tg; e < 4 * 4 * kW / 4; e += 128)
        reinterpret_cast<float4*>(orow0 + static_cast<int64_t>(mo) * 4 * H * (4 * kW))[e] =
            reinterpret_cast<const float4*>(sOut + mo * 4 * (4 * kW))[e];
    }
    wg::group_sync(w);
  }
}

template <typename T>
struct TailOf;
template <>
struct TailOf<uint16_t> {
  using L = TailB;
};
template <>
struct TailOf<float> {
  using L = TailF;
};

template <typename T>
__global__ void __launch_bounds__(sizeof(T) == 2 ? TailB::kThreads : TailF::kThreads, 1)
decoder_tail_kernel(const T* __restrict__ src, const T* __restrict__ w1t,
                    const T* __restrict__ w2t, const T* __restrict__ w_blocks,
                    const float* __restrict__ vec, const T* __restrict__ hyper, int n, int m,
                    int H, float eps, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  if constexpr (sizeof(T) == 2)
    tail_bf16(smem, src, w_blocks, vec, hyper, n, m, H, eps, out);
  else
    tail_f32(smem, src, w1t, w2t, vec, hyper, n, m, H, eps, out);
}

template <typename T>
int launch(const void* src, const void* w1t, const void* w2t, const void* w_blocks,
           const void* vec, const void* hyper, int n, int m, int H, float eps, void* out,
           cudaStream_t stream) {
  using L = typename TailOf<T>::L;
  // internal linkage (the anonymous namespace): each library keeps its own
  static int raised[wg::kMaxDevices] = {};
  auto kernel = decoder_tail_kernel<T>;
  cudaError_t err =
      wg::raise_shared_memory(reinterpret_cast<const void*>(kernel), L::kSmem, raised);
  if (err != cudaSuccess) return err;
  const int items = sizeof(T) == 2 ? n * H : n * ((H + 1) / 2);
  const int sms = wg::sm_count();
  const int grid = items < sms ? items : sms;
  kernel<<<grid, L::kThreads, L::kSmem, stream>>>(
      static_cast<const T*>(src), static_cast<const T*>(w1t), static_cast<const T*>(w2t),
      static_cast<const T*>(w_blocks), static_cast<const float*>(vec),
      static_cast<const T*>(hyper), n, m, H, eps, static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

// Compute dtype T: bf16 (f32 = 0) or fp32 (f32 = 1). src T [n][H][64][256];
// w1t T [256 = (p, q, o1)][256]; w2t T [128 = (r, s, o2)][64]; w_blocks: in
// bf16 w1t then w2t, each in wgmma's core-matrix layout (the wrapper's
// pack), unread in fp32 (w1t and w2t are read there instead); vec fp32
// [224] (b1, ln scale, ln bias, b2); hyper T [n][m][32]; out fp32
// [n][m][4H][256].
extern "C" int cor_decoder_tail(const void* src, const void* w1t, const void* w2t,
                                const void* w_blocks, const void* vec, const void* hyper, int n,
                                int m, int H, float eps, void* out, int f32, void* stream) {
  if (n < 1 || n > 65535 || m < 1 || m > 65535 || H < 1 || (!f32 && !w_blocks))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return f32 ? launch<float>(src, w1t, w2t, w_blocks, vec, hyper, n, m, H, eps, out, s)
             : launch<uint16_t>(src, w1t, w2t, w_blocks, vec, hyper, n, m, H, eps, out, s);
}
