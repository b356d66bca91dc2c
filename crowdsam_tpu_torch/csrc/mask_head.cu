// The packed mask head of the fused decode for Hopper (sm_90a).
//
// Replaces the TPU kernel `mask_head_pallas`
// (crowdsam_tpu/models/mask_head_kernel.py:165, body `_kernel`): per prompt
// and image row, dense 256 -> 4 x 64 (the first 2x2 transposed convolution,
// sub-pixel major), LayerNorm over each group of 64 (eps 1e-6), erf GELU,
// dense 64 -> 4 x 32 per group (the second transposed convolution), GELU,
// and the dot of each of the 16 sub-pixels' 32 channels with the prompt's K
// hypernetwork vectors: packed masks (P, K, M, 16).  With `emit_exp` also
// e = exp(mask - tile max) in the same layout and the tile maxes (P, M/64),
// the softmax terms of the PWD pooling.
//
// What bounds it.  Per 32 prompts at M = 4096 the kernel must read 64 MB of
// keys2 and write 16 MB of masks and 16 MB of e (0.030 ms at 3.35 TB/s),
// against ~34 GFLOP of bf16 products with the split operands (0.035 ms at
// 989 TFLOP/s).  Above both lies the CUDA-core work: 768 GELUs a row (256
// after the first product, 512 after the second), the group LayerNorm and
// the hi/lo splits.  With erff (24 SASS instructions from argument to
// result, branch-free, on sm_90a) this design's SASS issues 14,700
// instructions a thread per tile, 120 M warp instructions a call: 0.115 ms
// at four a clock on 132 SMs at 1.98 GHz.  So the design cuts the
// instruction stream and keeps the CUDA cores issuing while the products
// and the loads run.
//
// Design: a persistent grid of one block an SM, min(tiles, #SMs) blocks,
// each walking the (prompt, 64-row tile) pairs t = blockIdx.x + i * grid in
// order.  A block is two consumer warpgroups and one producer warp:
// - Resident weights.  The first weight (256 x 256 bf16, 128 KB) and the
//   second (128 x 64, 16 KB) are loaded into shared memory once per block
//   by TMA, 128-byte swizzled, K-major: ~19 MB of L2 traffic a call where
//   the first design, which streamed the first weight through every one of
//   its 2048 blocks, moved 268 MB.  Their tensor maps are encoded once per
//   weight pointer; only the keys map is encoded per call.
// - A two-stage TMA ring for keys2: the producer warp loads tile i (64 x
//   256 bf16, 32 KB, four 64-column boxes) into stage i % 2 behind a full
//   mbarrier and refills a stage when its empty mbarrier says the four
//   warps of its consumer have retired their last product that reads it.
// - Consumer warpgroup w takes the block's tiles i = w, w + 2, ...: each
//   warpgroup works on its own tile, so one's LayerNorm and GELUs on the
//   CUDA cores overlap the other's wgmma and the next tile's load.
// - The first product: per sub-pixel group q1, wgmma m64n64k16 with A = the
//   keys tile and B = the group's 64 weight rows, both from shared memory
//   (16 k-steps).  The accumulator of a warp's 16 rows is the m16n8 layout,
//   so the group LayerNorm takes its f32 mean and variance from the four
//   lanes that hold a row (quad shuffles), and the GELU output becomes the
//   next product's A fragments in registers.
// - The second product: wgmma m64n64k16 with A from registers (the GELU
//   output as hi and lo bf16 fragments), one product per pair of
//   sub-pixels q2 (64 of the 128 columns): a 32-register accumulator
//   rather than one of 64, inside the 168 registers a thread has when a
//   block of nine warps puts three on one scheduler.
// - The hypernetwork contraction: mma.sync m16n8k16 from registers, the
//   pair's two sub-pixels as a block-diagonal B (the K = 4 vectors in
//   columns 0-3 for the first, 4-7 for the second), so that every lane's
//   accumulator holds masks and no lane idles; a wgmma would need its A,
//   16 rows of the GELU output a warp, staged in shared memory first.
// - The tile's masks stay in registers (32 f32 a thread).  The tile max is
//   a warp shuffle and a reduction over the warpgroup's four warps through
//   shared memory (a named barrier of the warpgroup); one shuffle between
//   lanes t4 and t4 ^ 2 then gives each lane one mask's 16 sub-pixels of
//   its two rows, written as two 16-byte pieces a row: no staging.
// - Fewer instructions: GELU from a polynomial and one ex2 (10 instructions,
//   `gelu` below); the lo term of the split from the packed hi pair itself;
//   the wgmma descriptors formed once a tile and offset.
//
// Numerics.  Between the products every value stays f32, and the two GELU
// outputs enter the next product as two bf16 terms, hi + lo (~16 bits):
// with bf16 stages, one rounding step anywhere, times hypernetwork weights
// of tens, moved a mask by ~0.06 and e by twice its bound.  The GELU is
// within 2^-22 max(|x|, 1) of the exact-erf one (the plain version keeps
// torch.erf), far below the split's 2^-17; chip_smoke.py holds the compiled
// `gelu` to that over a sweep of x, and the kernel's mean error against
// float32 to that of the plain version.
//
// Measured against each other in single calls (device ms at P = 32,
// M = 4096, H100 80GB HBM3 at 700 W, one-off A/B probes on random
// operands): the first design (a block per tile and prompt, the first
// weight streamed, mma.sync) 0.274-0.279; this design with erff
// 0.208-0.213; with a degree-8 polynomial GELU 0.158-0.167; with the
// degree-6 one, the split and the descriptors as here 0.125-0.132
// (chip_smoke.py on the model's operands: 0.131-0.135, and the same kernel
// with the erff GELU 0.200-0.201).
// Lost: a software-pipelined form (the next group's first product and both
// second-product halves issued ahead, a producer warpgroup giving its
// registers to the consumers by setmaxnreg, 384 threads) at 0.136-0.140,
// the erff GELU (above), and the Abramowitz-Stegun rational erf of the TPU
// kernel (in the first design: 0.39 against 0.27).
//
// Shared memory (1024-byte aligned base): first weight 131072, second
// weight 16384, keys ring 2 x 32768, biases and LayerNorm parameters 2048,
// tile-max reduction 64, barriers 64: 215,104 bytes + 1024 of alignment
// slack, of the 232,448 a block may have.  A third keys stage does not fit
// (248 KB); nor does an f32 staging of the tile's masks (16 KB a
// warpgroup), which the register epilogue avoids.
#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;
using sm90::kmajor_desc;
using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::pack_bf16;
using sm90::smem_u32;
using sm90::tma_load_2d;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_wait;

constexpr int C = 256;       // input width
constexpr int C1 = 64;       // channels after the first upscale
constexpr int C2 = 32;       // channels after the second upscale
constexpr int K = 4;         // masks per prompt
constexpr int TM = 64;       // rows per tile
constexpr int CONSUMERS = 2;                   // warpgroups
constexpr int THREADS = CONSUMERS * 128 + 32;  // + the producer warp
constexpr float EPS = 1e-6f;

constexpr int ATOM = 128;                // bytes of one swizzled row (64 k)
constexpr int W0_ATOM = C * ATOM;        // 256 weight rows, 64 inputs
constexpr int W0_BYTES = 4 * W0_ATOM;
constexpr int W2_BYTES = 4 * C2 * ATOM;  // 128 rows, 64 inputs
constexpr int KEY_ATOM = TM * ATOM;      // 64 rows, 64 inputs
constexpr int KEY_BYTES = 4 * KEY_ATOM;
constexpr int O_W0 = 0;
constexpr int O_W2 = O_W0 + W0_BYTES;
constexpr int O_KEYS = O_W2 + W2_BYTES;
constexpr int O_B0 = O_KEYS + 2 * KEY_BYTES;   // f32 [4 C1]
constexpr int O_LNW = O_B0 + 4 * C1 * 4;       // f32 [C1]
constexpr int O_LNB = O_LNW + C1 * 4;          // f32 [C1]
constexpr int O_B2 = O_LNB + C1 * 4;           // f32 [4 C2]
constexpr int O_RED = O_B2 + 4 * C2 * 4;       // f32 [warpgroup][2][4]
constexpr int O_BAR = O_RED + 64;              // weights, full[2], empty[2]
constexpr int SMEM = O_BAR + 64 + 1024;
static_assert(SMEM <= 232448, "shared memory budget");

struct Args {
  const bf16* hyper;   // (P, K, C2)
  const float* b0;     // (4*C1)
  const float* lnw;    // (C1)
  const float* lnb;    // (C1)
  const float* b2;     // (4*C2)
  bf16* masks;         // (P, K, M, 16)
  bf16* e;             // (P, K, M, 16) or null
  float* mx;           // (P, M/TM) or null
  int P, M;
};

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// GELU(x) = x Phi(x) = relu(x) - |x| 2^g(|x|), 2^g(a) = erfc(a / sqrt 2) / 2:
// g a degree-6 polynomial in a <= 4 sqrt 2 (weighted least squares, f32
// coefficients), beyond which |x| 2^g < 8e-9 |x|.  Within 2^-22 max(|x|, 1)
// of the exact-erf GELU in float32, ex2.approx included (below the 2^-17
// of the hi + lo split), in 11 SASS instructions where erff takes 32.
__device__ __forceinline__ float gelu(float x) {
  const float a = fminf(fabsf(x), 5.656854f);
  float g = 2.1093423e-05f;
  g = fmaf(g, a, -6.719686e-04f);
  g = fmaf(g, a, 7.7875615e-03f);
  g = fmaf(g, a, -5.300123e-02f);
  g = fmaf(g, a, -4.590438e-01f);
  g = fmaf(g, a, -1.1511246e+00f);
  g = fmaf(g, a, -9.9999964e-01f);
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(g));
  return fmaf(-fabsf(x), e, fmaxf(x, 0.f));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D(64x64, f32) (+)= A(64x16, bf16 registers) B(16x64), B K-major in shared
// memory.
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// f32 accumulator pieces (m16n8 layout: [4j + c], row g for c < 2, g + 8
// otherwise) through GELU into hi and lo A fragments of the next product:
// k-step j / 2 takes pieces j (registers 0, 1) and j + 1 (registers 2, 3).
template <int N>
__device__ __forceinline__ void gelu_split(const float (&y)[4 * N],
                                           uint32_t (&hi)[N / 2][4],
                                           uint32_t (&lo)[N / 2][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float y0 = gelu(y[4 * j + 2 * r]);
      const float y1 = gelu(y[4 * j + 2 * r + 1]);
      const uint32_t h = pack_bf16(y0, y1);
      hi[j >> 1][(j & 1) * 2 + r] = h;
      // rnd(y) from the packed pair itself: its halves as f32.
      lo[j >> 1][(j & 1) * 2 + r] =
          pack_bf16(y0 - __uint_as_float(h << 16),
                    y1 - __uint_as_float(h & 0xffff0000u));
    }
  }
}

template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&x)[N][4]) {
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) sm90::fence_reg(x[k][i]);
}

// Eight f32 -> bf16, as one 16-byte value.
__device__ __forceinline__ uint4 pack8(const float* v) {
  return make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                    pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

template <bool EMIT_EXP>
__global__ void __launch_bounds__(THREADS, 1)
    mask_head(const __grid_constant__ CUtensorMap tm_keys,
              const __grid_constant__ CUtensorMap tm_w0,
              const __grid_constant__ CUtensorMap tm_w2, const Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  float* sb0 = reinterpret_cast<float*>(sm + O_B0);
  float* slnw = reinterpret_cast<float*>(sm + O_LNW);
  float* slnb = reinterpret_cast<float*>(sm + O_LNB);
  float* sb2 = reinterpret_cast<float*>(sm + O_B2);
  float* red = reinterpret_cast<float*>(sm + O_RED);
  const uint32_t wbar = base + O_BAR;
  const uint32_t full = wbar + 8, empty = wbar + 24;   // + 8 * stage

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles_p = a.M / TM, n_tiles = a.P * tiles_p;

  if (tid == 0) {
    mbar_init(wbar, 1);
    for (int s = 0; s < 2; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);     // the consumer's four warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    sm90::fence_proxy_async();
  }
  for (int i = tid; i < 4 * C1; i += THREADS) sb0[i] = a.b0[i];
  for (int i = tid; i < 4 * C2; i += THREADS) sb2[i] = a.b2[i];
  if (tid < C1) {
    slnw[tid] = a.lnw[tid];
    slnb[tid] = a.lnb[tid];
  }
  __syncthreads();

  if (warp == 4 * CONSUMERS) {
    // The producer: both weights once, then the block's keys tiles in
    // order through the two stages.
    if (lane == 0) {
      sm90::prefetch_map(&tm_keys);
      mbar_expect_tx(wbar, W0_BYTES + W2_BYTES);
#pragma unroll
      for (int at = 0; at < 4; ++at)
        tma_load_2d(base + O_W0 + at * W0_ATOM, &tm_w0, wbar, at * 64, 0);
      tma_load_2d(base + O_W2, &tm_w2, wbar, 0, 0);
      int i = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, ++i) {
        const int s = i & 1;
        if (i >= 2) mbar_wait(empty + 8 * s, ((i >> 1) - 1) & 1);
        mbar_expect_tx(full + 8 * s, KEY_BYTES);
        const uint32_t dst = base + O_KEYS + s * KEY_BYTES;
#pragma unroll
        for (int at = 0; at < 4; ++at)
          tma_load_2d(dst + at * KEY_ATOM, &tm_keys, full + 8 * s, at * 64,
                      t * TM);
      }
    }
    return;
  }

  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int lr0 = wl * 16 + g, lr1 = lr0 + 8;   // tile rows of this lane
  // After the exchange below, lane t4 holds mask mk of its two rows.
  const int h2 = t4 >> 1, mk = ((2 * t4) & 3) + h2;
  const uint64_t dw0 = kmajor_desc(base + O_W0);
  const uint64_t dw2 = kmajor_desc(base + O_W2);
  mbar_wait(wbar, 0);

  int i = wg;
  for (int t = blockIdx.x + wg * gridDim.x; t < n_tiles;
       t += CONSUMERS * gridDim.x, i += CONSUMERS) {
    const int s = i & 1;
    const int p = t / tiles_p, m0 = (t - p * tiles_p) * TM;

    // The contraction's B fragments: column n = g of a pair's block-diagonal
    // operand is vector g & 3 of the pair's first (g < 4) or second
    // sub-pixel; the other block is zero.
    uint32_t hv[2][2];
    {
      const bf16* hp = a.hyper + ((size_t)p * K + (g & 3)) * C2 + 2 * t4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        hv[h][0] = ld32(hp + 16 * h);
        hv[h][1] = ld32(hp + 16 * h + 8);
      }
    }
    uint32_t hb[2][2][2];   // [block][channel half][register]
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 2; ++r) hb[x][h][r] = (g >> 2) == x ? hv[h][r] : 0u;

    mbar_wait(full + 8 * s, (i >> 1) & 1);
    // Operand descriptors, formed once: an address offset moves the
    // descriptor's start field by offset / 16 (no carry below 256 KB).
    const uint64_t dkeys = kmajor_desc(base + O_KEYS + s * KEY_BYTES);

    // mres[q1][pair]: rows lr0 (0, 1) and lr1 (2, 3); columns 2 t4, 2 t4 +
    // 1 of the pair's block-diagonal product: sub-pixel q1 * 4 + 2 pair +
    // (t4 >> 1), masks (2 t4) & 3 and that + 1.  The q1 loop is not
    // unrolled (its body holds 160 inlined GELUs): each group's results
    // go to mres[3] after the older ones move down one, so that every
    // index stays static.
    float mres[4][2][4];
#pragma unroll 1
    for (int q1 = 0; q1 < 4; ++q1) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int pr = 0; pr < 2; ++pr)
#pragma unroll
          for (int c = 0; c < 4; ++c) mres[j][pr][c] = mres[j + 1][pr][c];
      // up1 = x @ w0[:, group q1] (f32): 64 rows x 64 channels.
      float acc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk)
        sm90::wgmma_m64n64k16_ss(
            acc, dkeys + (((kk >> 2) * KEY_ATOM + (kk & 3) * 32) >> 4),
            dw0 + ((q1 * C1 * ATOM + (kk >> 2) * W0_ATOM + (kk & 3) * 32) >>
                   4),
            kk > 0 ? 1 : 0);
      wgmma_commit();
      wgmma_wait<0>();
      sm90::fence_regs(acc);
      if (q1 == 3) {
        // The keys stage is free once all four warps' products retired.
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }

      // + b0, LayerNorm over the group's 64 channels (f32 mean and
      // variance from the four lanes of a row), GELU.
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int j = 0; j < C1 / 8; ++j) {
        const float2 b =
            *reinterpret_cast<const float2*>(sb0 + q1 * C1 + j * 8 + 2 * t4);
        acc[4 * j] += b.x;
        acc[4 * j + 1] += b.y;
        acc[4 * j + 2] += b.x;
        acc[4 * j + 3] += b.y;
        s0 += acc[4 * j] + acc[4 * j + 1];
        s1 += acc[4 * j + 2] + acc[4 * j + 3];
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      }
      const float mean0 = s0 * (1.f / C1), mean1 = s1 * (1.f / C1);
      float v0 = 0.f, v1 = 0.f;
#pragma unroll
      for (int j = 0; j < C1 / 8; ++j) {
        acc[4 * j] -= mean0;
        acc[4 * j + 1] -= mean0;
        acc[4 * j + 2] -= mean1;
        acc[4 * j + 3] -= mean1;
        v0 += acc[4 * j] * acc[4 * j] + acc[4 * j + 1] * acc[4 * j + 1];
        v1 += acc[4 * j + 2] * acc[4 * j + 2] +
              acc[4 * j + 3] * acc[4 * j + 3];
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        v0 += __shfl_xor_sync(0xffffffffu, v0, off);
        v1 += __shfl_xor_sync(0xffffffffu, v1, off);
      }
      const float r0 = rsqrtf(v0 * (1.f / C1) + EPS);
      const float r1 = rsqrtf(v1 * (1.f / C1) + EPS);
#pragma unroll
      for (int j = 0; j < C1 / 8; ++j) {
        const float2 w = *reinterpret_cast<const float2*>(slnw + j * 8 + 2 * t4);
        const float2 b = *reinterpret_cast<const float2*>(slnb + j * 8 + 2 * t4);
        acc[4 * j] = acc[4 * j] * r0 * w.x + b.x;
        acc[4 * j + 1] = acc[4 * j + 1] * r0 * w.y + b.y;
        acc[4 * j + 2] = acc[4 * j + 2] * r1 * w.x + b.x;
        acc[4 * j + 3] = acc[4 * j + 3] * r1 * w.y + b.y;
      }
      // The GELU output y as two bf16 terms, hi = rnd(y), lo = rnd(y - hi).
      uint32_t ga[C1 / 16][4], gl[C1 / 16][4];
      gelu_split<C1 / 8>(acc, ga, gl);

      // Second upscale, two sub-pixels q2 (64 channels) a product, then the
      // hypernetwork contraction of that pair.
#pragma unroll
      for (int pair = 0; pair < 2; ++pair) {
        float acc2[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < C1 / 16; ++kk) {
          const uint64_t db = dw2 + ((pair * 64 * ATOM + kk * 32) >> 4);
          wgmma_rs_n64(acc2, ga[kk], db, kk > 0);
          wgmma_rs_n64(acc2, gl[kk], db, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        sm90::fence_regs(acc2);
        fence_frags(ga);
        fence_frags(gl);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 b = *reinterpret_cast<const float2*>(
              sb2 + pair * 64 + j * 8 + 2 * t4);
          acc2[4 * j] += b.x;
          acc2[4 * j + 1] += b.y;
          acc2[4 * j + 2] += b.x;
          acc2[4 * j + 3] += b.y;
        }
        // u, like y, as two bf16 terms: k-steps 0, 1 are the pair's first
        // sub-pixel, 2, 3 its second.
        uint32_t ua[4][4], ul[4][4];
        gelu_split<8>(acc2, ua, ul);
        float* mc = mres[3][pair];
        mc[0] = mc[1] = mc[2] = mc[3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          mma_bf16(mc, ua[kk], hb[kk >> 1][kk & 1][0], hb[kk >> 1][kk & 1][1]);
          mma_bf16(mc, ul[kk], hb[kk >> 1][kk & 1][0], hb[kk >> 1][kk & 1][1]);
        }
      }
    }

    float tile_max = 0.f;
    if (EMIT_EXP) {
      float mx = -INFINITY;
#pragma unroll
      for (int q1 = 0; q1 < 4; ++q1)
#pragma unroll
        for (int pr = 0; pr < 2; ++pr)
#pragma unroll
          for (int c = 0; c < 4; ++c) mx = fmaxf(mx, mres[q1][pr][c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // Two buffers by tile parity: a warp writes this buffer again two
      // tiles on, after the next tile's barrier, which every warp reaches
      // only after its read of this tile's partials.
      float* rb = red + (wg * 2 + ((i >> 1) & 1)) * 4;
      if (lane == 0) rb[wl] = mx;
      sm90::named_bar(1 + wg, 128);
      tile_max = fmaxf(fmaxf(rb[0], rb[1]), fmaxf(rb[2], rb[3]));
      if (wl == 0 && lane == 0) a.mx[t] = tile_max;
    }

    // Lanes t4 and t4 ^ 2 hold the same two masks for complementary
    // sub-pixels: after one exchange, lane t4 holds mask mk, all 16
    // sub-pixels of rows lr0 and lr1.
    float v[2][16];
#pragma unroll
    for (int q1 = 0; q1 < 4; ++q1)
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {
        const float* mc = mres[q1][pr];
        const int sub = q1 * 4 + 2 * pr;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float keep = h2 ? mc[2 * r + 1] : mc[2 * r];
          const float send = h2 ? mc[2 * r] : mc[2 * r + 1];
          const float got = __shfl_xor_sync(0xffffffffu, send, 2);
          v[r][sub] = h2 ? got : keep;
          v[r][sub + 1] = h2 ? keep : got;
        }
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const size_t dst =
          (((size_t)p * K + mk) * a.M + m0 + (r ? lr1 : lr0)) * 16;
      uint4* out = reinterpret_cast<uint4*>(a.masks + dst);
      out[0] = pack8(v[r]);
      out[1] = pack8(v[r] + 8);
      if (EMIT_EXP) {
        float ev[16];
#pragma unroll
        for (int c = 0; c < 16; ++c) ev[c] = __expf(v[r][c] - tile_max);
        uint4* eo = reinterpret_cast<uint4*>(a.e + dst);
        eo[0] = pack8(ev);
        eo[1] = pack8(ev + 8);
      }
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
  }
  return n;
}

// A 2-d bf16 map of a row-major (rows, cols) tensor, boxes of 64 columns x
// `box_rows` rows (128-byte swizzle).
bool encode_2d(CUtensorMap* map, const void* ptr, int cols, long long rows,
               int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  return sm90::encode_bf16(map, ptr, 2, dims, strides, box);
}

// The map of a weight, whole in one box.  It depends only on the pointer and
// the fixed shape, so it is encoded once and kept until another weight comes.
struct WeightMap {
  const void* ptr = nullptr;
  alignas(64) CUtensorMap map;
};

const CUtensorMap* weight_map(WeightMap& w, const void* ptr, int cols,
                              int rows) {
  if (w.ptr == ptr) return &w.map;
  w.ptr = encode_2d(&w.map, ptr, cols, rows, rows) ? ptr : nullptr;
  return w.ptr ? &w.map : nullptr;
}

}  // namespace

// keys (P, M, 256) bf16; hyper (P, 4, 32) bf16; w0t (256, 256) and w2t
// (128, 64) bf16, [out][in] with the sub-pixel index major in `out`; b0
// (256), lnw/lnb (64), b2 (128) f32; masks (P, 4, M, 16) bf16.  With
// emit_exp != 0 also e (like masks) and mx (P, M/64) f32.  Requires
// M % 64 == 0 and 16-byte aligned operands.  Launches on `stream`;
// returns cudaGetLastError() (or an error before the launch).
extern "C" int mask_head_forward(const void* keys, const void* hyper,
                                 const void* w0t, const void* b0,
                                 const void* lnw, const void* lnb,
                                 const void* w2t, const void* b2, void* masks,
                                 void* e, void* mx, int P, int M,
                                 int emit_exp, void* stream) {
  if (P <= 0 || M <= 0 || M % TM) return (int)cudaErrorInvalidValue;
  if (emit_exp && (e == nullptr || mx == nullptr))
    return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sm90::encode_fn() == nullptr || sms == 0)
    return (int)cudaErrorNotSupported;
  static WeightMap map_w0, map_w2;
  const CUtensorMap* tm_w0 = weight_map(map_w0, w0t, C, 4 * C1);
  const CUtensorMap* tm_w2 = weight_map(map_w2, w2t, C1, 4 * C2);
  alignas(64) CUtensorMap tm_keys;
  if (tm_w0 == nullptr || tm_w2 == nullptr ||
      !encode_2d(&tm_keys, keys, C, (long long)P * M, TM))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.hyper = static_cast<const bf16*>(hyper);
  a.b0 = static_cast<const float*>(b0);
  a.lnw = static_cast<const float*>(lnw);
  a.lnb = static_cast<const float*>(lnb);
  a.b2 = static_cast<const float*>(b2);
  a.masks = static_cast<bf16*>(masks);
  a.e = static_cast<bf16*>(e);
  a.mx = static_cast<float*>(mx);
  a.P = P;
  a.M = M;
  const void* fn = emit_exp ? (const void*)mask_head<true>
                            : (const void*)mask_head<false>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  const int tiles = P * (M / TM);
  const int grid = tiles < sms ? tiles : sms;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (emit_exp)
    mask_head<true><<<grid, THREADS, SMEM, st>>>(tm_keys, *tm_w0, *tm_w2, a);
  else
    mask_head<false><<<grid, THREADS, SMEM, st>>>(tm_keys, *tm_w0, *tm_w2,
                                                   a);
  return (int)cudaGetLastError();
}
