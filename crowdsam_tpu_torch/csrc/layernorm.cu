// Row-wise LayerNorm for Hopper (sm_90a).
//
// Replaces: crowdsam_tpu/ops/layernorm.py, `layer_norm_2d` (Pallas kernel
// `_ln_kernel`), reached through `fused_layer_norm` from
// crowdsam_tpu/models/common.py `_ln_impl`.
//
// Bound: memory.  The work is one read of x and one write of y (N*D
// elements each) plus two D-wide f32 vectors; at 3.35 TB/s a (5330, 1024)
// bf16 call needs ~6.5 us.  There is nothing to gain from the tensor cores.
//
// Design: one warp per row, eight rows per 256-thread block.  A lane holds
// D/32 values of its row in registers (D <= 1024), so the row is read from
// device memory once: the mean and the centred variance (two passes over
// the registers, f32) need no second read.  Neighbouring lanes read
// neighbouring elements.  Widths up to 1024 (the port's widest LayerNorm);
// the wrapper refuses wider rows.  Input and output are bf16 or f32, the
// affine weights f32, eps a per-call argument.
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

template <typename T, int VPT>
__global__ void __launch_bounds__(kWarps * 32)
ln_rows(const T* __restrict__ x, const float* __restrict__ w,
        const float* __restrict__ b, T* __restrict__ y, long long rows,
        int d, float eps) {
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
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + 32 * i;
    if (c < d) store_f(yr + c, (v[i] - mu) * rstd * w[c] + b[c]);
  }
}

template <typename T>
void launch(const void* x, const float* w, const float* b, void* y,
            long long rows, int d, float eps, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  const dim3 grid((unsigned)((rows + kWarps - 1) / kWarps));
  const dim3 block(kWarps * 32);
  if (d <= 64)
    ln_rows<T, 2><<<grid, block, 0, st>>>(xp, w, b, yp, rows, d, eps);
  else if (d <= 128)
    ln_rows<T, 4><<<grid, block, 0, st>>>(xp, w, b, yp, rows, d, eps);
  else if (d <= 256)
    ln_rows<T, 8><<<grid, block, 0, st>>>(xp, w, b, yp, rows, d, eps);
  else if (d <= 512)
    ln_rows<T, 16><<<grid, block, 0, st>>>(xp, w, b, yp, rows, d, eps);
  else
    ln_rows<T, 32><<<grid, block, 0, st>>>(xp, w, b, yp, rows, d, eps);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; 0 < d <= 1024.  Returns
// cudaGetLastError().
extern "C" int ln_forward(const void* x, const void* w, const void* b,
                          void* y, long long rows, int d, float eps,
                          int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(b);
  if (rows > 0) {
    if (dtype == 1)
      launch<__nv_bfloat16>(x, wp, bp, y, rows, d, eps, st);
    else
      launch<float>(x, wp, bp, y, rows, d, eps, st);
  }
  return (int)cudaGetLastError();
}
