// Row-wise LayerNorm for Hopper (sm_90a): forward (K1) and backward.
//
// Replaces: crowdsam_tpu/ops/layernorm.py, `layer_norm_2d` (Pallas kernel
// `_ln_kernel`), reached through `fused_layer_norm` from
// crowdsam_tpu/models/common.py `_ln_impl`.  The Pallas kernel has no VJP
// (the JAX trainer turns it off and differentiates the jnp path); here the
// backward is a kernel of its own, so that the full-decoder training step
// runs every LayerNorm through this file.
//
// Forward bound: memory.  One read of x and one write of y (N*D elements
// each) plus two D-wide f32 vectors; at 3.35 TB/s a (5330, 1024) bf16 call
// needs ~6.5 us, a (4096, 1280) one (SAM ViT-H) ~6.3 us.  There is nothing
// to gain from the tensor cores.
//
// Forward design: one warp per row, eight rows per 256-thread block.  A
// lane holds D/32 values of its row in registers (D <= 1280: 40 a lane),
// so the row is read from device memory once: the mean and the centred
// variance (two passes over the registers, f32) need no second read.
// Neighbouring lanes read neighbouring elements.  Widths up to 1280 (SAM
// ViT-H's, the port's widest LayerNorm); wider rows are refused.  Input and output are bf16 or
// f32, the affine weights f32, eps a per-call argument.  When a gradient is
// wanted, lane 0 also writes the row's f32 mean and rstd (`ln_forward_stats`).
//
// Backward bound: memory.  Reads x and dy, writes dx (3*N*D elements) plus
// the statistics (8*N bytes) and dw, db; ~0.11 ms for 983040x64 bf16.
//
// Backward design: with xhat = (x - mean) rstd and gw = dy w,
//   dx = rstd (gw - mean(gw) - xhat mean(gw xhat)),
//   dw = sum over rows of dy xhat,  db = sum over rows of dy.
// `ln_bwd_rows`: one warp per row as in the forward (x and dy in registers,
// the two row means by warp shuffles).  A block walks a fixed contiguous
// range of rows, each lane summing dw/db for its own columns in registers;
// the block's eight warps then add their sums in shared memory in warp
// order and write one f32 partial per block.  `ln_bwd_reduce` adds the
// partials of all blocks column by column in a fixed order (16 strided
// slices of blocks, then the slices in order).  The grid depends only on N,
// so the result is the same bit for bit from call to call: no atomics.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr int kWarps = 8;
// Widest rows: the forward's register ladder ends at 40 values a lane
// (1280), the backward's at 32 (1024: no training path is wider).
constexpr int kMaxWidth = 1280;
constexpr int kMaxBwdWidth = 1024;

template <typename T, int VPT>
__global__ void __launch_bounds__(kWarps * 32)
ln_rows(const T* __restrict__ x, const float* __restrict__ w,
        const float* __restrict__ b, T* __restrict__ y, long long rows,
        int d, float eps, float* __restrict__ mean_out,
        float* __restrict__ rstd_out) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  float v[VPT];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < d ? load_f(xr + c) : 0.f;
    s += v[i];
  }
  const float mu = warp_sum(s) / d;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + 32 * i;
    const float t = v[i] - mu;
    q += c < d ? t * t : 0.f;
  }
  const float rstd = rsqrtf(warp_sum(q) / d + eps);
  if (mean_out != nullptr && lane == 0) {
    mean_out[row] = mu;
    rstd_out[row] = rstd;
  }
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + 32 * i;
    if (c < d) store_f(yr + c, (v[i] - mu) * rstd * w[c] + b[c]);
  }
}

template <typename T>
void launch(const void* x, const float* w, const float* b, void* y,
            long long rows, int d, float eps, float* mean, float* rstd,
            cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  const dim3 grid((unsigned)((rows + kWarps - 1) / kWarps));
  const dim3 block(kWarps * 32);
  if (d <= 64)
    ln_rows<T, 2><<<grid, block, 0, st>>>(xp, w, b, yp, rows, d, eps,
                                                mean, rstd);
  else if (d <= 128)
    ln_rows<T, 4><<<grid, block, 0, st>>>(xp, w, b, yp, rows, d, eps,
                                                mean, rstd);
  else if (d <= 256)
    ln_rows<T, 8><<<grid, block, 0, st>>>(xp, w, b, yp, rows, d, eps,
                                                mean, rstd);
  else if (d <= 512)
    ln_rows<T, 16><<<grid, block, 0, st>>>(xp, w, b, yp, rows, d, eps,
                                                mean, rstd);
  else if (d <= 1024)
    ln_rows<T, 32><<<grid, block, 0, st>>>(xp, w, b, yp, rows, d, eps,
                                                mean, rstd);
  else
    ln_rows<T, 40><<<grid, block, 0, st>>>(xp, w, b, yp, rows, d, eps,
                                                mean, rstd);
}

// Rows a backward block walks: the grid is min(ceil(N / 8), kMaxBlocks)
// blocks, a function of N alone.
constexpr int kMaxBlocks = 1024;

template <typename T, int VPT>
__global__ void __launch_bounds__(kWarps * 32)
ln_bwd_rows(const T* __restrict__ x, const T* __restrict__ dy,
            const float* __restrict__ w, const float* __restrict__ mean,
            const float* __restrict__ rstd, T* __restrict__ dx,
            float* __restrict__ part_w, float* __restrict__ part_b,
            long long rows, long long rows_per_block, int d) {
  __shared__ float red[kWarps][32 * VPT];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float acc_w[VPT], acc_b[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    acc_w[i] = 0.f;
    acc_b[i] = 0.f;
  }
  const long long first = (long long)blockIdx.x * rows_per_block;
  long long last = first + rows_per_block;
  if (last > rows) last = rows;
  for (long long row = first + warp; row < last; row += kWarps) {
    const T* xr = x + row * d;
    const T* gr = dy + row * d;
    const float mu = mean[row], rs = rstd[row];
    float xh[VPT], gw[VPT];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = lane + 32 * i;
      const float xv = c < d ? load_f(xr + c) : 0.f;
      const float g = c < d ? load_f(gr + c) : 0.f;
      xh[i] = c < d ? (xv - mu) * rs : 0.f;
      gw[i] = c < d ? g * w[c] : 0.f;
      acc_w[i] += g * xh[i];
      acc_b[i] += g;
      s1 += gw[i];
      s2 += gw[i] * xh[i];
    }
    const float a = warp_sum(s1) / d;
    const float c2 = warp_sum(s2) / d;
    T* dxr = dx + row * d;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = lane + 32 * i;
      if (c < d) store_f(dxr + c, rs * (gw[i] - a - xh[i] * c2));
    }
  }
  // dw, then db: the eight warps' sums added in warp order.
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    float* part = which == 0 ? part_w : part_b;
#pragma unroll
    for (int i = 0; i < VPT; ++i)
      red[warp][lane + 32 * i] = which == 0 ? acc_w[i] : acc_b[i];
    __syncthreads();
    for (int c = threadIdx.x; c < d; c += kWarps * 32) {
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) sum += red[k][c];
      part[(long long)blockIdx.x * d + c] = sum;
    }
    __syncthreads();
  }
}

// dw[c] = sum over blocks of part_w[blk][c] (db alike), in a fixed order:
// a block covers 32 columns with 16 slices of threads, slice s adds blocks
// s, s + 16, s + 32, ... in order, then the slices are added in order.
constexpr int kRedCols = 32;
constexpr int kRedSlices = 16;

__global__ void __launch_bounds__(kRedCols * kRedSlices)
ln_bwd_reduce(const float* __restrict__ part_w,
              const float* __restrict__ part_b, float* __restrict__ dw,
              float* __restrict__ db, int blocks, int d) {
  __shared__ float red[2][kRedSlices][kRedCols];
  const int col = threadIdx.x % kRedCols;
  const int slice = threadIdx.x / kRedCols;
  const int c = blockIdx.x * kRedCols + col;
  float sw = 0.f, sb = 0.f;
  if (c < d) {
    for (int k = slice; k < blocks; k += kRedSlices) {
      sw += part_w[(long long)k * d + c];
      sb += part_b[(long long)k * d + c];
    }
  }
  red[0][slice][col] = sw;
  red[1][slice][col] = sb;
  __syncthreads();
  if (slice == 0 && c < d) {
    float tw = 0.f, tb = 0.f;
    for (int s2 = 0; s2 < kRedSlices; ++s2) {
      tw += red[0][s2][col];
      tb += red[1][s2][col];
    }
    dw[c] = tw;
    db[c] = tb;
  }
}

template <typename T>
void launch_bwd(const void* x, const void* dy, const float* w,
                const float* mean, const float* rstd, void* dx,
                float* part_w, float* part_b, float* dw, float* db,
                long long rows, int d, int blocks, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  const long long per = (rows + blocks - 1) / blocks;
  const dim3 block(kWarps * 32);
  if (d <= 64)
    ln_bwd_rows<T, 2><<<blocks, block, 0, st>>>(
        xp, gp, w, mean, rstd, dxp, part_w, part_b, rows, per, d);
  else if (d <= 128)
    ln_bwd_rows<T, 4><<<blocks, block, 0, st>>>(
        xp, gp, w, mean, rstd, dxp, part_w, part_b, rows, per, d);
  else if (d <= 256)
    ln_bwd_rows<T, 8><<<blocks, block, 0, st>>>(
        xp, gp, w, mean, rstd, dxp, part_w, part_b, rows, per, d);
  else if (d <= 512)
    ln_bwd_rows<T, 16><<<blocks, block, 0, st>>>(
        xp, gp, w, mean, rstd, dxp, part_w, part_b, rows, per, d);
  else
    ln_bwd_rows<T, 32><<<blocks, block, 0, st>>>(
        xp, gp, w, mean, rstd, dxp, part_w, part_b, rows, per, d);
  ln_bwd_reduce<<<(d + kRedCols - 1) / kRedCols, kRedCols * kRedSlices, 0,
                  st>>>(part_w, part_b, dw, db, blocks, d);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; 0 < d <= 1280 (else
// cudaErrorInvalidValue).  Returns cudaGetLastError().
extern "C" int ln_forward(const void* x, const void* w, const void* b,
                          void* y, long long rows, int d, float eps,
                          int dtype, void* stream) {
  if (d < 1 || d > kMaxWidth) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(b);
  if (rows > 0) {
    if (dtype == 1)
      launch<__nv_bfloat16>(x, wp, bp, y, rows, d, eps, nullptr, nullptr,
                            st);
    else
      launch<float>(x, wp, bp, y, rows, d, eps, nullptr, nullptr, st);
  }
  return (int)cudaGetLastError();
}

// `ln_forward` that also writes each row's f32 mean and rstd (rows floats
// each), for the backward.
extern "C" int ln_forward_stats(const void* x, const void* w, const void* b,
                                void* y, void* mean, void* rstd,
                                long long rows, int d, float eps, int dtype,
                                void* stream) {
  if (d < 1 || d > kMaxWidth) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(b);
  float* mp = static_cast<float*>(mean);
  float* rp = static_cast<float*>(rstd);
  if (rows > 0) {
    if (dtype == 1)
      launch<__nv_bfloat16>(x, wp, bp, y, rows, d, eps, mp, rp, st);
    else
      launch<float>(x, wp, bp, y, rows, d, eps, mp, rp, st);
  }
  return (int)cudaGetLastError();
}

// The number of f32 partial rows (of d each, for dw and for db) that
// `ln_backward` needs as scratch for `rows` rows.
extern "C" int ln_backward_blocks(long long rows) {
  const long long want = (rows + kWarps - 1) / kWarps;
  return (int)(want < kMaxBlocks ? want : kMaxBlocks);
}

// dx (x's dtype), dw and db (f32, d each) from x, dy, w and the forward's
// mean and rstd; part_w and part_b hold ln_backward_blocks(rows) * d floats
// each; 0 < d <= 1024 (else cudaErrorInvalidValue).  Returns
// cudaGetLastError().
extern "C" int ln_backward(const void* x, const void* dy, const void* w,
                           const void* mean, const void* rstd, void* dx,
                           void* part_w, void* part_b, void* dw, void* db,
                           long long rows, int d, int dtype, void* stream) {
  if (d < 1 || d > kMaxBwdWidth) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wp = static_cast<const float*>(w);
  const float* mp = static_cast<const float*>(mean);
  const float* rp = static_cast<const float*>(rstd);
  float* pw = static_cast<float*>(part_w);
  float* pb = static_cast<float*>(part_b);
  float* dwp = static_cast<float*>(dw);
  float* dbp = static_cast<float*>(db);
  const int blocks = ln_backward_blocks(rows);
  if (rows > 0) {
    if (dtype == 1)
      launch_bwd<__nv_bfloat16>(x, dy, wp, mp, rp, dx, pw, pb, dwp, dbp,
                                rows, d, blocks, st);
    else
      launch_bwd<float>(x, dy, wp, mp, rp, dx, pw, pb, dwp, dbp, rows, d,
                        blocks, st);
  }
  return (int)cudaGetLastError();
}
