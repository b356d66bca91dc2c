// Float32 packed mask head of the fused decode for Hopper (sm_90a): the
// float32 arm of K6, for `tpu.compute_dtype float32` with the fused decode
// on the card.
//
// Replaces, for float32, the TPU kernel `mask_head_pallas`
// (crowdsam_tpu/models/mask_head_kernel.py:165), which the JAX package
// turns off for float32 (`mask_head_kernel_enabled`, :33-41) and computes
// through XLA.  It computes what `mask_head_plain` computes at float32: per
// prompt and image row, dense 256 -> 4 x 64 (the first 2x2 transposed
// convolution, sub-pixel major), LayerNorm over each group of 64 (eps
// 1e-6), erf GELU, dense 64 -> 4 x 32 per group (the second transposed
// convolution), erf GELU, and the dot of each of the 16 sub-pixels' 32
// channels with the prompt's K = 4 hypernetwork vectors: packed masks (P,
// 4, M, 16).  With `emit_exp` also e = exp(mask - tile max) in the same
// layout and the tile maxes (P, M / 64), the softmax terms of the PWD
// pooling.  Everything float32: no hi/lo split, no rounding of the masks
// (at float32 the plain version's are the identity).
//
// Bound: operations.  0.82 GFLOP a prompt at M = 4096 (256 -> 256: 0.54;
// 4 x 64 -> 128: 0.27; the hypernetwork dot 0.017): 26 GFLOP at 32
// prompts, 0.39 ms at the card's 67 TFLOP/s float32 peak; 0.20 GB moved
// (keys2 in, masks and e out).  Beside the FMAs, 768 erff GELUs a row.
//
// Design (simple first).  One block of 256 threads a (64-row tile,
// prompt), one block an SM (207 KB of shared memory):
//   1. the keys2 tile (64 x 256) to shared memory by cp.async; the second
//      weight (128 x 64) transposed into shared memory, [k][128];
//   2. the first product by `tile_product` (f32_tile.cuh): the first
//      weight (256 x 256, 256 KB in float32, more than a block holds)
//      streamed in stages of 128 rows x 32 inputs, two 128-column chunks,
//      each epilogue adding b0 into a [64][4][72] buffer (a row's four
//      groups of 64, padded so that the eight threads of a float4 phase,
//      two rows x four groups, fall on distinct banks);
//   3. a thread a (row, group): the group LayerNorm (two passes), GELU,
//      in place; then for each second sub-pixel q2 its 32 outputs (64-deep
//      FMA chains against the transposed weight, broadcast from shared
//      memory), + b2, GELU, and the four hypernetwork dots: the thread's
//      16 masks (4 K x its 4 sub-pixels q1 q2 in 0..15 of one q1), written
//      as one float4 a mask;
//   4. with `emit_exp`: the tile max over the block (warp shuffles, then
//      the eight warps through shared memory), e = exp(mask - max).
//
// Where this design can go wrong, and what guards it:
//   1. The LayerNorm's group: 64 channels of one sub-pixel, not the row's
//      256 (chip_smoke.py's fault: the LayerNorm over all 256).
//   2. The sub-pixel order: q1 (the first product's group) major, q2 minor
//      in the packed axis (fault: q1 and q2 swapped).
//   3. The tile max over all eight warps' masks (fault: one warp's only).
//   4. The hypernetwork vector of mask k read at k (fault: k + 1).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "f32_tile.cuh"

namespace {

using f32tile::THREADS;
using f32tile::TR;

constexpr int C = 256;        // keys2 width
constexpr int C1 = 64;        // channels after the first product, a group
constexpr int C2 = 32;        // channels after the second, a sub-pixel
constexpr int K = 4;          // masks
constexpr float EPS = 1e-6f;

constexpr int LDA = C + 4;            // keys rows (floats)
constexpr int LDG = C1 + 8;           // a group of the first product's rows
constexpr int LDU = 4 * LDG + 4;      // a row of four groups
constexpr int SM_A = 0;                                 // [TR][LDA]
constexpr int SM_B = SM_A + TR * LDA;                   // 2 weight stages
constexpr int SM_U = SM_B + 2 * f32tile::STAGE_FLOATS;     // [TR][LDU]
constexpr int SM_W2 = SM_U + TR * LDU;                  // [C1][4 C2]
constexpr int SM_HYP = SM_W2 + C1 * 4 * C2;             // [K][C2]
constexpr int SM_RED = SM_HYP + K * C2;                 // [8] warp maxes
constexpr int SM_FLOATS = SM_RED + 8;

struct Args {
  const float* keys;    // (P, M, C)
  const float* hyper;   // (P, K, C2)
  const float* w0t;     // (4 C1, C) [out][in]
  const float* b0;      // (4 C1)
  const float* lnw;     // (C1)
  const float* lnb;
  const float* w2t;     // (4 C2, C1) [out][in]
  const float* b2;      // (4 C2)
  float* masks;         // (P, K, M, 16)
  float* e;             // (P, K, M, 16), with emit_exp
  float* mx;            // (P, M / TR), with emit_exp
  int P, M;
};

template <bool EXP>
__global__ void __launch_bounds__(THREADS, 1) mask_head_f32(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int tile = blockIdx.x, p = blockIdx.y;
  const size_t m0 = (size_t)tile * TR;
  float* as = sm + SM_A;
  float* us = sm + SM_U;
  float* w2 = sm + SM_W2;
  float* hyp = sm + SM_HYP;
  const int tid = threadIdx.x;
  f32tile::load_rows(as, LDA, a.keys + ((size_t)p * a.M + m0) * C, C, TR, C);
  f32tile::cp_commit();
  for (int i = tid; i < C1 * 4 * C2; i += THREADS) {
    const int n = i % (4 * C2), k = i / (4 * C2);
    w2[k * 4 * C2 + n] = a.w2t[n * C1 + k];
  }
  if (tid < K * C2) hyp[tid] = a.hyper[(size_t)p * K * C2 + tid];

  // 1. up = keys @ w0t^T + b0, into the groups' rows.
  const int tx = tid & 15, ty = tid >> 4;
  for (int n0 = 0; n0 < 4 * C1; n0 += f32tile::TN) {
    float acc[4][8];
    f32tile::zero(acc);
    f32tile::tile_product(acc, as, LDA, a.w0t, C, n0, C, sm + SM_B);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = 4 * ty + i, col = n0 + tx + 16 * j;
        us[r * LDU + (col / C1) * LDG + col % C1] = acc[i][j] + a.b0[col];
      }
  }
  __syncthreads();

  // 2. A thread a (row r, group q1): LayerNorm, GELU, in place.
  const int r = tid >> 2, q1 = tid & 3;
  float* gp = us + r * LDU + q1 * LDG;
  float s = 0.f;
  for (int c = 0; c < C1; c += 4) {
    const float4 v = *reinterpret_cast<const float4*>(gp + c);
    s += v.x;
    s += v.y;
    s += v.z;
    s += v.w;
  }
  const float mean = s / C1;
  float var = 0.f;
  for (int c = 0; c < C1; c += 4) {
    const float4 v = *reinterpret_cast<const float4*>(gp + c);
    var = fmaf(v.x - mean, v.x - mean, var);
    var = fmaf(v.y - mean, v.y - mean, var);
    var = fmaf(v.z - mean, v.z - mean, var);
    var = fmaf(v.w - mean, v.w - mean, var);
  }
  const float rs = 1.f / sqrtf(var / C1 + EPS);
  for (int c = 0; c < C1; ++c)
    gp[c] = f32tile::gelu_erf((gp[c] - mean) * rs * a.lnw[c] + a.lnb[c]);

  // 3. Per second sub-pixel q2: 32 outputs (64-deep FMA chains), GELU, the
  // four masks.
  float mk[K][4];
#pragma unroll
  for (int q2 = 0; q2 < 4; ++q2) {
    float h[C2];
#pragma unroll
    for (int c = 0; c < C2; ++c) h[c] = 0.f;
#pragma unroll 2
    for (int k4 = 0; k4 < C1; k4 += 4) {
      const float4 gv = *reinterpret_cast<const float4*>(gp + k4);
      const float gk[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* wr = w2 + (k4 + u) * 4 * C2 + q2 * C2;
#pragma unroll
        for (int c = 0; c < C2; c += 4) {
          const float4 wv = *reinterpret_cast<const float4*>(wr + c);
          h[c] = fmaf(gk[u], wv.x, h[c]);
          h[c + 1] = fmaf(gk[u], wv.y, h[c + 1]);
          h[c + 2] = fmaf(gk[u], wv.z, h[c + 2]);
          h[c + 3] = fmaf(gk[u], wv.w, h[c + 3]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < C2; ++c)
      h[c] = f32tile::gelu_erf(h[c] + a.b2[q2 * C2 + c]);
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      float m = 0.f;
#pragma unroll
      for (int c = 0; c < C2; ++c) m = fmaf(hyp[kk * C2 + c], h[c], m);
      mk[kk][q2] = m;
    }
  }
  const size_t row = m0 + r;
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
    *reinterpret_cast<float4*>(
        a.masks + (((size_t)p * K + kk) * a.M + row) * 16 + q1 * 4) =
        make_float4(mk[kk][0], mk[kk][1], mk[kk][2], mk[kk][3]);
  if (!EXP) return;

  // 4. The tile max over the block's masks, then e.
  float mx = -INFINITY;
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int q2 = 0; q2 < 4; ++q2) mx = fmaxf(mx, mk[kk][q2]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float* red = sm + SM_RED;
  if ((tid & 31) == 0) red[tid >> 5] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) mx = fmaxf(mx, red[w]);
  if (tid == 0) a.mx[(size_t)p * (a.M / TR) + tile] = mx;
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
    *reinterpret_cast<float4*>(
        a.e + (((size_t)p * K + kk) * a.M + row) * 16 + q1 * 4) =
        make_float4(expf(mk[kk][0] - mx), expf(mk[kk][1] - mx),
                    expf(mk[kk][2] - mx), expf(mk[kk][3] - mx));
}

template <bool EXP>
cudaError_t configure() {
  static const cudaError_t status = cudaFuncSetAttribute(
      mask_head_f32<EXP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SM_FLOATS * (int)sizeof(float));
  return status;
}

}  // namespace

// keys (P, M, 256), hyper (P, 4, 32), w0t (256, 256), b0 (256), lnw / lnb
// (64), w2t (128, 64), b2 (128), all float32 and contiguous; masks (and,
// with emit_exp, e) (P, 4, M, 16) float32, mx (P, M / 64) float32.  Returns
// a cudaError_t: cudaErrorInvalidValue for arguments the kernel does not
// take.
extern "C" int mask_head_f32_forward(const float* keys, const float* hyper,
                                     const float* w0t, const float* b0,
                                     const float* lnw, const float* lnb,
                                     const float* w2t, const float* b2,
                                     float* masks, float* e, float* mx, int P,
                                     int M, int emit_exp, void* stream) {
  if (P <= 0 || P > 65535 || M <= 0 || M % TR)
    return (int)cudaErrorInvalidValue;
  if (emit_exp && (e == nullptr || mx == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaError_t c = emit_exp ? configure<true>() : configure<false>();
  if (c != cudaSuccess) return (int)c;
  Args a;
  a.keys = keys;
  a.hyper = hyper;
  a.w0t = w0t;
  a.b0 = b0;
  a.lnw = lnw;
  a.lnb = lnb;
  a.w2t = w2t;
  a.b2 = b2;
  a.masks = masks;
  a.e = e;
  a.mx = mx;
  a.P = P;
  a.M = M;
  const dim3 grid(M / TR, P);
  const size_t smem = SM_FLOATS * sizeof(float);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (emit_exp)
    mask_head_f32<true><<<grid, THREADS, smem, cs>>>(a);
  else
    mask_head_f32<false><<<grid, THREADS, smem, cs>>>(a);
  return (int)cudaGetLastError();
}

// out[0] the kernel's dynamic shared memory, out[1] its blocks an SM.
extern "C" int mask_head_f32_occupancy(int* out) {
  const cudaError_t c = configure<true>();
  if (c != cudaSuccess) return (int)c;
  out[0] = SM_FLOATS * (int)sizeof(float);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], mask_head_f32<true>, THREADS, out[0]);
}
