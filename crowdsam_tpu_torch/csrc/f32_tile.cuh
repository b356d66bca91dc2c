// FFMA building blocks shared by the float32 arms of K5 and K6
// (`decode_tail_f32.cu`, `mask_head_f32.cu`): a block of 256 threads
// multiplies a 64-row tile held in shared memory by a weight streamed from
// device memory, in float32 on the CUDA cores (no tensor core, so no TF32).
//
// `tile_product` computes acc[i][j] += sum_k A[4 ty + i][k] W[n0 + tx + 16 j][k]
// for thread (ty, tx) = (tid / 16, tid % 16): a 64 x 128 output chunk of
// A (64 x K) W^T, with W (N, K) row-major, as a Linear weight is stored.
// W's chunk comes to shared memory in stages of 128 rows x 32 inputs by
// cp.async (16-byte copies, eight threads a row: 128 contiguous bytes), two
// stages in flight.  Each thread reads four float4 of A (its four rows) and
// eight float4 of the stage (its eight columns) for 128 FMAs.  A stage's
// rows are padded to 36 floats, so the eight threads of a float4 phase
// (tx = 0..7 or 8..15, columns tx + 16 j) fall on distinct 16-byte banks.
// Every output is one FMA chain over k in order, as a float32 GEMM sums.
#pragma once

#include <cuda_runtime.h>

namespace f32tile {

constexpr int THREADS = 256;   // 16 x 16 threads (ty, tx)
constexpr int TR = 64;         // rows of a tile
constexpr int TN = 128;        // output columns of a chunk
constexpr int TK = 32;         // inputs of a stage
constexpr int LDB = TK + 4;    // padded row of a stage (floats)
constexpr int STAGE_FLOATS = TN * LDB;

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// `rows` rows of `width` floats (a multiple of 4) from `src` (row stride
// `ld` floats) into `dst` (row stride `ldd`), by cp.async; the caller
// commits and waits.
__device__ __forceinline__ void load_rows(float* dst, int ldd,
                                          const float* src, size_t ld,
                                          int rows, int width) {
  const int per_row = width / 4;
  for (int c = threadIdx.x; c < rows * per_row; c += THREADS) {
    const int r = c / per_row, q = c - r * per_row;
    cp_async16(dst + r * ldd + 4 * q, src + r * ld + 4 * q);
  }
}

// Stage of inputs [k0, k0 + 32) of rows [n0, n0 + 128) of W (row stride ld).
__device__ __forceinline__ void load_stage(float* stage, const float* w,
                                           size_t ld, int n0, int k0) {
  for (int c = threadIdx.x; c < TN * TK / 4; c += THREADS) {
    const int r = c >> 3, q = c & 7;
    cp_async16(stage + r * LDB + 4 * q, w + (size_t)(n0 + r) * ld + k0 + 4 * q);
  }
}

// acc += the 64 x 128 chunk at columns n0 of A (64 x K, shared memory, row
// stride lda floats, 16-byte aligned rows) times W^T (W: (N, K), row stride
// ld, K a multiple of 32), through `stages` (2 x STAGE_FLOATS floats of
// shared memory).  A must be written before the call (its first barrier
// precedes every read of A); `stages` is free again when it returns.
__device__ __forceinline__ void tile_product(float (&acc)[4][8],
                                             const float* a, int lda,
                                             const float* w, size_t ld,
                                             int n0, int k, float* stages) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nk = k / TK;
  load_stage(stages, w, ld, n0, 0);
  cp_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const float* cur = stages + (kt & 1) * STAGE_FLOATS;
    if (kt + 1 < nk) {
      load_stage(stages + ((kt + 1) & 1) * STAGE_FLOATS, w, ld, n0,
                 (kt + 1) * TK);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* ar = a + ty * 4 * lda + kt * TK;
#pragma unroll
    for (int kk = 0; kk < TK; kk += 4) {
      float4 av[4], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        av[i] = *reinterpret_cast<const float4*>(ar + i * lda + kk);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        bv[j] = *reinterpret_cast<const float4*>(cur + (tx + 16 * j) * LDB +
                                                 kk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
          acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
          acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
          acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
        }
    }
    __syncthreads();   // the stage is free for the load two steps on
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// The erf GELU as PyTorch computes it in float32: x/2 (1 + erf(x / sqrt 2)).
__device__ __forceinline__ float gelu_erf(float x) {
  return x * 0.5f * (1.f + erff(x * 0.70710678118654752f));
}

}  // namespace f32tile
