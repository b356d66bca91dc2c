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
// Bound: bytes.  Per 32 prompts at M = 4096 the kernel must read 64 MB of
// keys2 and write 16 MB of masks (and 16 MB of e), against ~27 GFLOP of
// useful bf16 products.
//
// Design: one block of four warps per (tile of 64 rows, prompt); a warp
// owns 16 rows.  Nothing between keys2 and the masks touches device memory:
// the warp keeps its rows as mma.sync A fragments, and each stage's m16n8 C
// tiles, rounded to bf16, are the next stage's A fragments (two adjacent
// column tiles make one m16k16 tile).  The first weight (128 KB in bf16)
// streams through shared memory one sub-pixel group (64 output columns) at
// a time, double-buffered with cp.async; the second weight and the prompt's
// hypernetwork vectors stay in shared memory; all are stored [n][k] with
// padded rows, so the ldmatrix reads of the B fragments meet no bank
// conflicts.  The group LayerNorm takes its f32 mean and variance directly
// from the four lanes that hold a row.  The hypernetwork contraction is an
// m16n8k16 product with the K masks as columns.  Between the products every
// value stays f32, and the two GELU outputs enter the next product as two
// bf16 terms, hi + lo (~16 bits): with bf16 stages, one rounding step
// anywhere, times hypernetwork weights of tens, moved a mask by ~0.06 and e
// by twice its bound (the same step lands on two sides of a rounding
// boundary in two computations whose f32 sums differ in the last bits; two
// more mma.sync a k-step of the second product and of the last).  The tile's
// masks are staged in shared memory in f32, so that the tile max is known
// before e is formed and the (P, K, M, 16) output is written in 16-byte
// pieces, whole rows at a time.  What bounds the kernel in practice is neither
// bytes nor the tensor cores but erff on the CUDA cores: 768 GELUs a row.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int C = 256;       // input width
constexpr int C1 = 64;       // channels after the first upscale
constexpr int C2 = 32;       // channels after the second upscale
constexpr int K = 4;         // masks per prompt
constexpr int TM = 64;       // rows per block
constexpr int WLD = C + 8;   // shared row strides (bf16 elements)
constexpr int W2LD = C1 + 8;
constexpr int HLD = C2 + 8;
constexpr float EPS = 1e-6f;

constexpr int SMEM = 2 * C1 * WLD * 2      // first weight, two groups
                     + 4 * C2 * W2LD * 2   // second weight
                     + 8 * HLD * 2         // hypernetwork vectors (8 rows)
                     + K * TM * 16 * 4     // the tile's masks, f32
                     + 16                  // block reduction
                     + (4 * C1 + 2 * C1 + 4 * C2) * 4;  // biases, LN params

struct Args {
  const bf16* keys;    // (P, M, C)
  const bf16* hyper;   // (P, K, C2)
  const bf16* w0t;     // (4*C1, C): [q1*C1 + o][c]
  const float* b0;     // (4*C1)
  const float* lnw;    // (C1)
  const float* lnb;    // (C1)
  const bf16* w2t;     // (4*C2, C1): [q2*C2 + o][c]
  const float* b2;     // (4*C2)
  bf16* masks;         // (P, K, M, 16)
  bf16* e;             // (P, K, M, 16) or null
  float* mx;           // (P, M/TM) or null
  int M;
};

__device__ __forceinline__ float rnd(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Exact-erf GELU.  (The Abramowitz-Stegun rational form of the TPU kernel,
// with a reciprocal and an exponential per value, measured slower here:
// 0.39 ms against 0.27 ms for the whole kernel on an H100 at 700 W.)
__device__ __forceinline__ float gelu(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i (16 contiguous bytes each).  From a weight stored
// [n][k], rows n0 + (lane & 7) and columns k0 + 8 (lane >> 3) give the B
// fragments of column tile n0 for the two 16-deep steps at k0 and k0 + 16.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* ptr) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Eight consecutive f32 -> bf16, as one 16-byte value.
__device__ __forceinline__ uint4 pack8(const float* v) {
  uint4 o;
  o.x = pack_bf16(v[0], v[1]);
  o.y = pack_bf16(v[2], v[3]);
  o.z = pack_bf16(v[4], v[5]);
  o.w = pack_bf16(v[6], v[7]);
  return o;
}

template <bool EMIT_EXP>
__global__ void __launch_bounds__(128) mask_head(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* wbuf = reinterpret_cast<bf16*>(smem_raw);          // [2][C1][WLD]
  bf16* w2s = wbuf + 2 * C1 * WLD;                          // [4*C2][W2LD]
  bf16* hyp = w2s + 4 * C2 * W2LD;                          // [8][HLD]
  float* mst = reinterpret_cast<float*>(hyp + 8 * HLD);     // [K][TM][16]
  float* red = mst + K * TM * 16;                           // [4]
  // Biases and LayerNorm parameters, staged: a load from device memory
  // inside the register-bound chain would wait out its latency.
  float* sb0 = red + 4;                                     // [4*C1]
  float* slnw = sb0 + 4 * C1;                               // [C1]
  float* slnb = slnw + C1;                                  // [C1]
  float* sb2 = slnb + C1;                                   // [4*C2]

  const int tile = blockIdx.x, p = blockIdx.y;
  const int m0 = tile * TM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int lm_r = lane & 7, lm_i = lane >> 3;   // ldmatrix: row, matrix
  const int lr0 = warp * 16 + g, lr1 = lr0 + 8;

  auto prefetch = [&](int q1) {
    const bf16* src = a.w0t + (size_t)q1 * C1 * C;
    bf16* dst = wbuf + (q1 & 1) * C1 * WLD;
#pragma unroll
    for (int it = 0; it < C1 * (C / 8) / 128; ++it) {
      const int e = it * 128 + tid;
      const int r = e / (C / 8), part = e % (C / 8);
      cp_async16(dst + r * WLD + part * 8, src + r * C + part * 8);
    }
    cp_async_commit();
  };
  prefetch(0);

  for (int e = tid; e < 4 * C2 * (C1 / 8); e += 128) {
    const int n = e / (C1 / 8), part = e % (C1 / 8);
    *reinterpret_cast<uint4*>(w2s + n * W2LD + part * 8) =
        *reinterpret_cast<const uint4*>(a.w2t + n * C1 + part * 8);
  }
  for (int i = tid; i < 4 * C1; i += 128) sb0[i] = a.b0[i];
  if (tid < C1) {
    slnw[tid] = a.lnw[tid];
    slnb[tid] = a.lnb[tid];
  }
  sb2[tid] = a.b2[tid];                 // 4 * C2 == 128 threads
  {
    // Rows K..7 of the hypernetwork operand are zero: the product has 8
    // columns, K of them masks.
    const int k = tid >> 5, ch = tid & 31;
    hyp[k * HLD + ch] = a.hyper[((size_t)p * K + k) * C2 + ch];
    hyp[(K + k) * HLD + ch] = __float2bfloat16(0.f);
  }

  // The warp's 16 rows of keys2 as A fragments (K = 256: 16 steps).
  uint32_t xa[C / 16][4];
  {
    const bf16* x0 = a.keys + ((size_t)p * a.M + m0 + lr0) * C;
    const bf16* x1 = x0 + 8 * C;
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) {
      const int col = kk * 16 + 2 * t4;
      xa[kk][0] = ld32(x0 + col);
      xa[kk][1] = ld32(x1 + col);
      xa[kk][2] = ld32(x0 + col + 8);
      xa[kk][3] = ld32(x1 + col + 8);
    }
  }
  __syncthreads();
  uint32_t hb[C2 / 16][2];
#pragma unroll
  for (int kk = 0; kk < C2 / 16; ++kk) {
    hb[kk][0] = ld32(hyp + g * HLD + kk * 16 + 2 * t4);
    hb[kk][1] = ld32(hyp + g * HLD + kk * 16 + 2 * t4 + 8);
  }

#pragma unroll 1
  for (int q1 = 0; q1 < 4; ++q1) {
    cp_async_wait_all();
    __syncthreads();
    if (q1 + 1 < 4) prefetch(q1 + 1);
    const bf16* wc = wbuf + (q1 & 1) * C1 * WLD;

    // up1 = x @ w0[:, group q1] + b0 (f32): 16 rows x 64 channels.
    float acc[C1 / 8][4];
#pragma unroll
    for (int j = 0; j < C1 / 8; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int k2 = 0; k2 < C / 32; ++k2) {
#pragma unroll
      for (int j = 0; j < C1 / 8; ++j) {
        uint32_t b[4];
        ldsm_x4(b, wc + (j * 8 + lm_r) * WLD + k2 * 32 + lm_i * 8);
        mma_bf16(acc[j], xa[2 * k2], b[0], b[1]);
        mma_bf16(acc[j], xa[2 * k2 + 1], b[2], b[3]);
      }
    }
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < C1 / 8; ++j) {
      const float2 b =
          *reinterpret_cast<const float2*>(sb0 + q1 * C1 + j * 8 + 2 * t4);
      acc[j][0] += b.x;
      acc[j][1] += b.y;
      acc[j][2] += b.x;
      acc[j][3] += b.y;
      s0 += acc[j][0] + acc[j][1];
      s1 += acc[j][2] + acc[j][3];
    }
    // LayerNorm over the group's 64 channels (f32 mean and variance), GELU.
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    }
    const float mean0 = s0 * (1.f / C1), mean1 = s1 * (1.f / C1);
    float v0 = 0.f, v1 = 0.f;
#pragma unroll
    for (int j = 0; j < C1 / 8; ++j) {
      v0 += (acc[j][0] - mean0) * (acc[j][0] - mean0) +
            (acc[j][1] - mean0) * (acc[j][1] - mean0);
      v1 += (acc[j][2] - mean1) * (acc[j][2] - mean1) +
            (acc[j][3] - mean1) * (acc[j][3] - mean1);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      v0 += __shfl_xor_sync(0xffffffffu, v0, off);
      v1 += __shfl_xor_sync(0xffffffffu, v1, off);
    }
    const float r0 = rsqrtf(v0 * (1.f / C1) + EPS);
    const float r1 = rsqrtf(v1 * (1.f / C1) + EPS);
    // The GELU output y as the A operand of the next product in two bf16
    // terms, hi = rnd(y) (ga) and lo = rnd(y - hi) (gl).
    uint32_t ga[C1 / 16][4], gl[C1 / 16][4];
#pragma unroll
    for (int j = 0; j < C1 / 8; ++j) {
      const float2 w = *reinterpret_cast<const float2*>(slnw + j * 8 + 2 * t4);
      const float2 b = *reinterpret_cast<const float2*>(slnb + j * 8 + 2 * t4);
      const float y00 = gelu((acc[j][0] - mean0) * r0 * w.x + b.x);
      const float y01 = gelu((acc[j][1] - mean0) * r0 * w.y + b.y);
      const float y10 = gelu((acc[j][2] - mean1) * r1 * w.x + b.x);
      const float y11 = gelu((acc[j][3] - mean1) * r1 * w.y + b.y);
      ga[j >> 1][(j & 1) * 2] = pack_bf16(y00, y01);
      ga[j >> 1][(j & 1) * 2 + 1] = pack_bf16(y10, y11);
      gl[j >> 1][(j & 1) * 2] = pack_bf16(y00 - rnd(y00), y01 - rnd(y01));
      gl[j >> 1][(j & 1) * 2 + 1] = pack_bf16(y10 - rnd(y10), y11 - rnd(y11));
    }

    // Second upscale, one sub-pixel q2 (32 channels) at a time, then the
    // hypernetwork contraction of that sub-pixel.
#pragma unroll
    for (int q2 = 0; q2 < 4; ++q2) {
      float acc2[C2 / 8][4];
#pragma unroll
      for (int j = 0; j < C2 / 8; ++j)
        acc2[j][0] = acc2[j][1] = acc2[j][2] = acc2[j][3] = 0.f;
#pragma unroll
      for (int k2 = 0; k2 < C1 / 32; ++k2) {
#pragma unroll
        for (int j = 0; j < C2 / 8; ++j) {
          uint32_t b[4];
          ldsm_x4(b, w2s + (q2 * C2 + j * 8 + lm_r) * W2LD + k2 * 32 +
                         lm_i * 8);
          mma_bf16(acc2[j], ga[2 * k2], b[0], b[1]);
          mma_bf16(acc2[j], ga[2 * k2 + 1], b[2], b[3]);
          mma_bf16(acc2[j], gl[2 * k2], b[0], b[1]);
          mma_bf16(acc2[j], gl[2 * k2 + 1], b[2], b[3]);
        }
      }
      // u, like y, as two bf16 terms for the hypernetwork contraction.
      uint32_t ua[C2 / 16][4], ul[C2 / 16][4];
#pragma unroll
      for (int j = 0; j < C2 / 8; ++j) {
        const float2 b =
            *reinterpret_cast<const float2*>(sb2 + q2 * C2 + j * 8 + 2 * t4);
        const float u00 = gelu(acc2[j][0] + b.x);
        const float u01 = gelu(acc2[j][1] + b.y);
        const float u10 = gelu(acc2[j][2] + b.x);
        const float u11 = gelu(acc2[j][3] + b.y);
        ua[j >> 1][(j & 1) * 2] = pack_bf16(u00, u01);
        ua[j >> 1][(j & 1) * 2 + 1] = pack_bf16(u10, u11);
        ul[j >> 1][(j & 1) * 2] = pack_bf16(u00 - rnd(u00), u01 - rnd(u01));
        ul[j >> 1][(j & 1) * 2 + 1] =
            pack_bf16(u10 - rnd(u10), u11 - rnd(u11));
      }
      float mk[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < C2 / 16; ++kk) {
        mma_bf16(mk, ua[kk], hb[kk][0], hb[kk][1]);
        mma_bf16(mk, ul[kk], hb[kk][0], hb[kk][1]);
      }
      // Columns 2*t4, 2*t4+1 of the product are masks only for t4 < K/2.
      if (2 * t4 < K) {
        const int sub = q1 * 4 + q2;
        mst[((2 * t4) * TM + lr0) * 16 + sub] = mk[0];
        mst[((2 * t4 + 1) * TM + lr0) * 16 + sub] = mk[1];
        mst[((2 * t4) * TM + lr1) * 16 + sub] = mk[2];
        mst[((2 * t4 + 1) * TM + lr1) * 16 + sub] = mk[3];
      }
    }
  }
  __syncthreads();

  float tile_max = 0.f;
  if (EMIT_EXP) {
    float mx = -INFINITY;
    for (int i = tid; i < K * TM * 16; i += 128) mx = fmaxf(mx, mst[i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) red[warp] = mx;
    __syncthreads();
    tile_max = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
    if (tid == 0) a.mx[(size_t)p * (a.M / TM) + tile] = tile_max;
  }
  // (k, row) pairs hold 16 contiguous values: two 16-byte pieces each.
  for (int u = tid; u < K * TM * 2; u += 128) {
    const int k = u / (TM * 2), rem = u % (TM * 2);
    const int row = rem >> 1, half = rem & 1;
    const float* src = mst + (k * TM + row) * 16 + half * 8;
    const size_t dst = (((size_t)p * K + k) * a.M + m0 + row) * 16 + half * 8;
    *reinterpret_cast<uint4*>(a.masks + dst) = pack8(src);
    if (EMIT_EXP) {
      float ev[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) ev[i] = __expf(src[i] - tile_max);
      *reinterpret_cast<uint4*>(a.e + dst) = pack8(ev);
    }
  }
}

}  // namespace

// keys (P, M, 256) bf16; hyper (P, 4, 32) bf16; w0t (256, 256) and w2t
// (128, 64) bf16, [out][in] with the sub-pixel index major in `out`; b0
// (256), lnw/lnb (64), b2 (128) f32; masks (P, 4, M, 16) bf16.  With
// emit_exp != 0 also e (like masks) and mx (P, M/64) f32.  Requires
// M % 64 == 0.  Launches on `stream`; returns cudaGetLastError().
extern "C" int mask_head_forward(const void* keys, const void* hyper,
                                 const void* w0t, const void* b0,
                                 const void* lnw, const void* lnb,
                                 const void* w2t, const void* b2, void* masks,
                                 void* e, void* mx, int P, int M,
                                 int emit_exp, void* stream) {
  if (P <= 0 || M <= 0 || M % TM) return (int)cudaErrorInvalidValue;
  if (emit_exp && (e == nullptr || mx == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.keys = static_cast<const bf16*>(keys);
  a.hyper = static_cast<const bf16*>(hyper);
  a.w0t = static_cast<const bf16*>(w0t);
  a.b0 = static_cast<const float*>(b0);
  a.lnw = static_cast<const float*>(lnw);
  a.lnb = static_cast<const float*>(lnb);
  a.w2t = static_cast<const bf16*>(w2t);
  a.b2 = static_cast<const float*>(b2);
  a.masks = static_cast<bf16*>(masks);
  a.e = static_cast<bf16*>(e);
  a.mx = static_cast<float*>(mx);
  a.M = M;
  const void* fn = emit_exp ? (const void*)mask_head<true>
                            : (const void*)mask_head<false>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(M / TM, P);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (emit_exp)
    mask_head<true><<<grid, 128, SMEM, st>>>(a);
  else
    mask_head<false><<<grid, 128, SMEM, st>>>(a);
  return (int)cudaGetLastError();
}
