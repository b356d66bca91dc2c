// Row-wise LayerNorm for Hopper (sm_90a): forward (K1) and backward.
//
// Replaces: crowdsam_tpu/ops/layernorm.py, `layer_norm_2d` (Pallas kernel
// `_ln_kernel`), reached through `fused_layer_norm` from
// crowdsam_tpu/models/common.py `_ln_impl`.  The Pallas kernel has no VJP
// (the JAX trainer turns it off and differentiates the jnp path); here the
// backward is a kernel of its own, so that the full-decoder training step
// runs every LayerNorm through this file.
//
// What K1 computes: y = (x - mean) rstd w + b over each row of a (rows, d)
// tensor, with f32 statistics and the two-pass centred variance of
// `_ln_impl` (mean first, then the mean of (x - mean)^2, both over values
// held on chip: the second pass reads no byte from device memory).  Input
// and output bf16 or f32, the affine weights f32, eps a call argument;
// widths up to 1280 (SAM ViT-H's) forward, 1024 backward (no training path
// is wider).  `ln_forward_stats` also writes each row's f32 mean and rstd.
//
// Forward bound: memory.  One read of x and one write of y (2 N d elements)
// plus w and b; at 3.35 TB/s 524288x64 bf16 (the unfused decoder's
// upscaling LayerNorm) needs 0.040 ms, 131072x256 0.040 ms, 5330x1024
// 0.0065 ms.  Backward bound: memory, x and dy read and dx written (3 N d
// elements) plus the statistics; 983040x64 bf16 0.115 ms, 5330x1024 f32
// 0.0196 ms.  There is nothing to gain from the tensor cores.
//
// Design (the vector arm: d a multiple of one 16-byte vector, 8 bf16 or 4
// f32, and x, y, dy, dx 16-byte aligned):
// - Row groups.  A row spans L lanes, L the power of two that covers its
//   16-byte vectors, so a warp holds 32 / L rows at once: 4 at width 64
//   bf16, one at 256.  The sums shuffle inside each L-lane segment.  Wider
//   rows keep one warp a row, VPL vectors a lane (4 at bf16 1024, 5 at
//   1280, 8 / 10 at f32 1024 / 1280).  Loads and stores are 16 bytes a
//   lane; the parent kernel's were 2, one row a warp, 43% of the bound at
//   524288x64.
// - Forward, many rows (`ln_fwd_vec`): a persistent grid of SMs x resident
//   blocks (`cudaOccupancyMaxActiveBlocksPerMultiprocessor` of each
//   instantiation, read once) walks the chunks b, b + grid, ... of `ch`
//   contiguous rows, ch a multiple of the block's rows at once (every warp
//   takes as many row groups of a chunk) and ~16 KB.  A chunk is one range
//   of device memory, so one thread copies it with one 1-d bulk copy
//   (`cp.async.bulk`, completion on an mbarrier a stage, no tensor map) into
//   a 3-stage ring, two chunks ahead of the one the warps read; the warps
//   take the chunk into registers, release the stage (the refill is issued
//   before they normalise) and store y in 16-byte stores.  Chosen over
//   register double-buffering because the bytes in flight then cost no
//   registers: 96-192 KB an SM, where a 16-byte register buffer a thread
//   gives 24-32 KB at full occupancy.  An input larger than L2 is copied
//   with an evict-first policy (no later read finds it there anyway;
//   +6-8% at 64 MB).  A lane's w and b columns are read once a block
//   (through shared memory) and stay in registers where it has one vector.
// - Forward, few rows (no block would walk more than two chunks: the
//   ring's set-up costs more than it hides), `ln_fwd_direct`: one or two
//   row groups a warp straight from device memory into registers, x's
//   loads issued first, w and b beside them.
// - Backward (`ln_bwd_vec`): the same row groups and ring (x and dy of a
//   chunk behind one barrier), a block walking a contiguous range of rows:
//   `ln_backward_blocks(rows)` = min(ceil(rows / 32), 2 x SMs) blocks of
//   ceil(rows / blocks) rows each.  With xhat = (x - mean) rstd, gw = dy w:
//     dx = rstd (gw - mean(gw) - xhat mean(gw xhat)),
//     dw = sum over rows of dy xhat,  db = sum over rows of dy.
//   A first pass over a row's values in shared memory gives the two row
//   sums and adds dy xhat and dy into the lane's own dw / db columns in
//   registers; the second pass reads the values again from shared memory
//   and writes dx.  So a lane holds only its accumulators (64 floats at
//   width 1024, bf16 or f32) and no row: ptxas stays under 128 registers
//   (two 256-thread blocks an SM, or at f32 widths above 512 two blocks of
//   4 warps, whose 3 stages of 4 rows of x and dy take 96 KB).
//   One launch: each block adds its warps' sums in warp order (segments of
//   a warp by shuffles, warps in shared memory) into one f32 partial; the
//   blocks then take tickets (an acq_rel atomic add of thread 0 after a
//   barrier: the release publishes the block's partial, and no thread
//   waits on a fence of its own) in groups of 16: the last block of a
//   group to arrive adds the group's partials in block order into a group
//   partial, and the last group to finish adds the group partials in group
//   order into dw and db (with one group, up to 16 blocks, its last block
//   writes them).  Each last block resets its counter, so the word the
//   wrapper allocates once stays zero between calls.  The order of every
//   sum depends on rows and the SM count alone: the result is the same bit
//   for bit from call to call, with no atomic on a sum.  Two levels keep
//   the serial tail short: the last block reads 16 + 17 partials, not 264
//   (2.2 MB at width 1024); the tail (a ticket, the last block's read) is
//   what a call of a few hundred rows pays against the parent's second
//   launch.
// The scalar arm (widths that are not a multiple of a vector, as the
// serving head's width 4, or unaligned tensors): one warp a row, lane c of
// each 32 columns, eight rows a block (forward); the backward walks the
// same contiguous ranges and ends with the same tickets.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "sm90.cuh"

namespace {

using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::smem_u32;

constexpr int kWarps = 8;            // warps of a block (but below)
constexpr int kStages = 3;           // chunks in the ring
constexpr int kMaxWidth = 1280;      // forward
constexpr int kMaxBwdWidth = 1024;   // backward
constexpr int kBwdMinRows = 32;      // rows a backward block, at least
constexpr int kBwdBlocksPerSM = 2;   // every backward arm fits two an SM
constexpr int kDirectBlocksPerSM = 2;  // the direct forward's grid, and
constexpr int kDirectGroups = 2;       // its row groups a warp at most
constexpr int kGroup = 16;           // blocks a ticket group
constexpr int kMaxGroups = 64;
constexpr int kTicketWords = 128;    // scratch words ahead of the partials

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The sum over the L lanes of a lane's segment (L a power of two).
template <int L>
__device__ __forceinline__ float seg_sum(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// bulk_load whose lines L2 evicts first: for an input larger than L2,
// which no later read finds there anyway.
__device__ __forceinline__ void bulk_load_once(uint32_t dst, const void* src,
                                               uint32_t bytes, uint32_t bar) {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(pol));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "l"(pol)
      : "memory");
}

// 16 bytes of T as floats (`unpack` of the raw bytes: a load issued
// first and unpacked later does not stall the thread before its use).
template <typename T>
struct V16;

template <>
struct V16<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4 a, float* v) {
    v[0] = __uint_as_float(a.x);
    v[1] = __uint_as_float(a.y);
    v[2] = __uint_as_float(a.z);
    v[3] = __uint_as_float(a.w);
  }
  __device__ static void load(const void* p, float* v) {
    unpack(*static_cast<const uint4*>(p), v);
  }
  __device__ static void store(void* p, const float* v) {
    *static_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct V16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4 a, float* v) {
    const uint32_t u[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      __nv_bfloat162 h;
      memcpy(&h, &u[k], 4);
      const float2 f = __bfloat1622float2(h);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
  __device__ static void load(const void* p, float* v) {
    unpack(*static_cast<const uint4*>(p), v);
  }
  __device__ static void store(void* p, const float* v) {
    uint32_t u[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      memcpy(&u[k], &h, 4);
    }
    *static_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  }
};

// w (and b) of the E columns of vector j, 16 bytes at a time (s 16-byte
// aligned; shared or device memory).
template <int E>
__device__ __forceinline__ void cols16(const float* s, int j, float* v) {
#pragma unroll
  for (int k = 0; k < E / 4; ++k) {
    const float4 a = reinterpret_cast<const float4*>(s + j * E)[k];
    v[4 * k] = a.x;
    v[4 * k + 1] = a.y;
    v[4 * k + 2] = a.z;
    v[4 * k + 3] = a.w;
  }
}

// One vector-arm instantiation: L lanes a row, VPL vectors a lane.
template <typename T, int L, int VPL, bool BWD>
struct Cfg {
  static constexpr int E = V16<T>::N;           // elements a vector
  static constexpr int RPW = 32 / L;            // rows a warp holds at once
  static constexpr int WARPS = (BWD && VPL >= 8) ? 4 : kWarps;
  // Row groups a warp takes from one chunk: ~16 KB a stage (x and dy: 16
  // KB each up to 4 vectors a lane, 32 KB above).
  static constexpr int GPW = (BWD ? 2 : 4) / VPL > 0 ? (BWD ? 2 : 4) / VPL
                                                     : 1;
  static constexpr int CH = GPW * RPW * WARPS;  // rows a chunk, at most
  static constexpr int DMAX_ROW = E * L * VPL;
  static constexpr int DCAP = BWD ? kMaxBwdWidth : kMaxWidth;
  static constexpr int DMAX = DMAX_ROW < DCAP ? DMAX_ROW : DCAP;
  static constexpr int NIN = BWD ? 2 : 1;
  static constexpr int SMEM_MAX = kStages * NIN * CH * DMAX * (int)sizeof(T) +
                                  (BWD ? 1 : 2) * DMAX * 4 + kStages * 8;
};

struct FwdArgs {
  const void* x;
  const float* w;
  const float* b;
  void* y;
  float* mean;  // null: no statistics
  float* rstd;
  long long rows;
  long long chunks;
  int d;
  int ch;
  float eps;
  int once;     // x larger than L2: its bulk copies evict first
  int wb16;     // w and b 16-byte aligned (the direct kernel's loads)
};

template <typename T, int L, int VPL>
__global__ void __launch_bounds__(kWarps * 32)
    ln_fwd_vec(const FwdArgs a) {
  using C = Cfg<T, L, VPL, false>;
  using V = V16<T>;
  constexpr int E = C::E;
  constexpr int RPW = C::RPW;
  constexpr int GPW = C::GPW;
  constexpr bool kRegW = VPL == 1;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int seg = lane / L, s = lane % L;
  const int d = a.d, nv = d / E;
  const size_t row_bytes = (size_t)d * sizeof(T);
  const size_t stage_bytes = (size_t)a.ch * row_bytes;
  float* ws = reinterpret_cast<float*>(smem + kStages * stage_bytes);
  float* bs = ws + d;
  const uint32_t bars = smem_u32(bs + d);
  const long long first = blockIdx.x, stride = gridDim.x;
  // Chunks of this block (32-bit: the host refuses 2^31 chunks).
  const int mine =
      a.chunks > first
          ? (int)((unsigned)(a.chunks - 1 - first) / (unsigned)stride) + 1
          : 0;
  const unsigned char* xg = static_cast<const unsigned char*>(a.x);
  // The k-th chunk of this block into stage k % kStages.
  auto issue = [&](int k) {
    const long long r0 = (first + k * stride) * a.ch;
    const long long n = min((long long)a.ch, a.rows - r0);
    const uint32_t bytes = (uint32_t)(n * (long long)row_bytes);
    const uint32_t bar = bars + 8 * (k % kStages);
    const uint32_t dst = smem_u32(smem + (k % kStages) * stage_bytes);
    mbar_expect_tx(bar, bytes);
    if (a.once)
      bulk_load_once(dst, xg + r0 * (long long)row_bytes, bytes, bar);
    else
      bulk_load(dst, xg + r0 * (long long)row_bytes, bytes, bar);
  };
  // w and b through shared memory (coalesced, once a block); a lane with
  // one vector keeps its columns in registers.
  float wr[E], br[E];
  auto stage_wb = [&]() {
    for (int c = tid; c < d; c += kWarps * 32) {
      ws[c] = a.w[c];
      bs[c] = a.b[c];
    }
    __syncthreads();
    if constexpr (kRegW) {
      if (s < nv) {
        cols16<E>(ws, s, wr);
        cols16<E>(bs, s, br);
      }
    }
  };
  // This warp's row groups of a chunk of n rows (GPW at most), held at
  // `base`, into registers as raw 16-byte vectors.
  uint4 raw[GPW][VPL];
  auto load = [&](const unsigned char* base, int n) {
#pragma unroll
    for (int u = 0; u < GPW; ++u) {
      const int rl = (warp + u * kWarps) * RPW + seg;
      const unsigned char* row = base + (size_t)rl * row_bytes;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int j = s + L * i;
        raw[u][i] = rl < n && j < nv
                        ? *reinterpret_cast<const uint4*>(row + 16 * j)
                        : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
  // Normalise the loaded groups of the chunk from row r0 and store them.
  auto norm = [&](long long r0, int n) {
#pragma unroll
    for (int u = 0; u < GPW; ++u) {
      const int g = warp + u * kWarps;
      if (g * RPW >= n) continue;  // the same for the whole warp
      const int rl = g * RPW + seg;
      const bool live = rl < n;
      float v[VPL][E];
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        V::unpack(raw[u][i], v[i]);
#pragma unroll
        for (int e = 0; e < E; ++e) sum += v[i][e];
      }
      const float mu = seg_sum<L>(sum) / d;
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        if (s + L * i < nv) {
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const float t = v[i][e] - mu;
            q += t * t;
          }
        }
      }
      const float rs = rsqrtf(seg_sum<L>(q) / d + a.eps);
      if (live) {
        const long long r = r0 + rl;
        if (a.mean != nullptr && s == 0) {
          a.mean[r] = mu;
          a.rstd[r] = rs;
        }
        char* yr = static_cast<char*>(a.y) + r * (long long)row_bytes;
#pragma unroll
        for (int i = 0; i < VPL; ++i) {
          const int j = s + L * i;
          if (j < nv) {
            float wv[E], bv[E], o[E];
            if constexpr (kRegW) {
#pragma unroll
              for (int e = 0; e < E; ++e) {
                wv[e] = wr[e];
                bv[e] = br[e];
              }
            } else {
              cols16<E>(ws, j, wv);
              cols16<E>(bs, j, bv);
            }
#pragma unroll
            for (int e = 0; e < E; ++e)
              o[e] = (v[i][e] - mu) * rs * wv[e] + bv[e];
            V::store(yr + 16 * j, o);
          }
        }
      }
    }
  };
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    sm90::fence_proxy_async();
  }
  __syncthreads();
  if (tid == 0)
    for (int k = 0; k < kStages && k < mine; ++k) issue(k);
  stage_wb();
  for (int k = 0; k < mine; ++k) {
    const long long r0 = (first + k * stride) * a.ch;
    const int n = (int)min((long long)a.ch, a.rows - r0);
    const int st = k % kStages;
    mbar_wait(bars + 8 * st, (k / kStages) & 1);
    load(smem + st * stage_bytes, n);
    __syncthreads();  // stage st is in every warp's registers: refill it
    if (tid == 0 && k + kStages < mine) issue(k + kStages);
    norm(r0, n);
  }
}

// The forward where no block would walk more than two chunks (few rows:
// the ring's set-up would cost more than it hides): G row groups a warp
// (`ch` rows a block: G = 2 where a lane holds two vectors or fewer and one
// group a warp would launch more than two blocks an SM, else 1), straight
// from device memory into registers, x's loads issued first; the lane's w
// and b columns read from device memory (L1, 16 bytes at a time where
// aligned), beside x's where a lane holds two vectors or fewer.
template <typename T, int L, int VPL>
__global__ void __launch_bounds__(kWarps * 32)
    ln_fwd_direct(const FwdArgs a) {
  using V = V16<T>;
  constexpr int E = V::N;
  constexpr int RPW = 32 / L;
  constexpr bool kEarly = VPL <= 2;
  constexpr int DG = kEarly ? kDirectGroups : 1;  // row groups a warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int seg = lane / L, s = lane % L;
  const int d = a.d, nv = d / E;
  const int groups = a.ch / (kWarps * RPW);  // this call's G
  const long long g0 = ((long long)blockIdx.x * kWarps + warp) * groups;
  const size_t row_bytes = (size_t)d * sizeof(T);
  uint4 raw[DG][VPL];
#pragma unroll
  for (int u = 0; u < DG; ++u) {
    const long long row = (g0 + u) * RPW + seg;
    const unsigned char* xr =
        static_cast<const unsigned char*>(a.x) + row * (long long)row_bytes;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int j = s + L * i;
      raw[u][i] = u < groups && row < a.rows && j < nv
                      ? *reinterpret_cast<const uint4*>(xr + 16 * j)
                      : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  // The lane's w and b columns: in flight with x where they take few
  // registers, else read after the sums.
  float we[kEarly ? VPL : 1][E], be[kEarly ? VPL : 1][E];
  auto cols = [&](int j, float* wv, float* bv) {
    if (a.wb16) {
      cols16<E>(a.w, j, wv);
      cols16<E>(a.b, j, bv);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        wv[e] = a.w[j * E + e];
        bv[e] = a.b[j * E + e];
      }
    }
  };
  if constexpr (kEarly) {
#pragma unroll
    for (int i = 0; i < VPL; ++i)
      if (s + L * i < nv) cols(s + L * i, we[i], be[i]);
  }
#pragma unroll
  for (int u = 0; u < DG; ++u) {
    if (u >= groups) continue;  // the same for the whole warp
    const long long row = (g0 + u) * RPW + seg;
    float v[VPL][E];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      V::unpack(raw[u][i], v[i]);
#pragma unroll
      for (int e = 0; e < E; ++e) sum += v[i][e];
    }
    const float mu = seg_sum<L>(sum) / d;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      if (s + L * i < nv) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float t = v[i][e] - mu;
          q += t * t;
        }
      }
    }
    const float rs = rsqrtf(seg_sum<L>(q) / d + a.eps);
    if (row >= a.rows) continue;
    if (a.mean != nullptr && s == 0) {
      a.mean[row] = mu;
      a.rstd[row] = rs;
    }
    char* yr = static_cast<char*>(a.y) + row * (long long)row_bytes;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int j = s + L * i;
      if (j < nv) {
        float wv[E], bv[E], o[E];
        if constexpr (kEarly) {
#pragma unroll
          for (int e = 0; e < E; ++e) {
            wv[e] = we[i][e];
            bv[e] = be[i][e];
          }
        } else {
          cols(j, wv, bv);
        }
#pragma unroll
        for (int e = 0; e < E; ++e)
          o[e] = (v[i][e] - mu) * rs * wv[e] + bv[e];
        V::store(yr + 16 * j, o);
      }
    }
  }
}

// The scalar arm: one warp a row, eight rows a block, lane c of each 32
// columns (VPT of them).
template <typename T>
__device__ __forceinline__ float load_f(const T* p);
template <>
__device__ __forceinline__ float load_f(const float* p) {
  return *p;
}
template <>
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

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

struct BwdArgs {
  const void* x;
  const void* dy;
  const float* w;
  const float* mean;
  const float* rstd;
  void* dx;
  float* dw;
  float* db;
  float* part;        // blocks x 2d: a block's dw, then its db
  float* gpart;       // groups x 2d
  unsigned* tickets;  // kMaxGroups + 1 counters, zero between calls
  long long rows;
  long long per;      // rows a block
  int d;
  int ch;
};

// out(c, sum over k < count of src[k n2 + c]) for c < n2, k in order, by
// `nthreads` threads from registers, 8 partials in flight (the scalar arm:
// any width).
template <typename Out>
__device__ void add_partials(const float* src, int count, int n2,
                             int nthreads, Out out) {
  for (int c = threadIdx.x; c < n2; c += nthreads) {
    float acc = 0.f;
    for (int k0 = 0; k0 < count; k0 += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (k0 + u < count) v[u] = __ldcg(src + (long long)(k0 + u) * n2 + c);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (k0 + u < count) acc += v[u];
    }
    out(c, acc);
  }
}

// Thread 0's ticket on `word`, after a barrier over the block's writes:
// the release publishes them (with the barrier, every thread's) to the
// block that draws the last ticket, whose acquire makes all of them
// visible to it.
__device__ __forceinline__ unsigned take_ticket(unsigned* word) {
  unsigned t;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
               : "=r"(t)
               : "l"(word)
               : "memory");
  return t;
}

// add_partials staged through shared memory `buf`: batches of `cap` rows
// copied by cp.async (16 bytes a thread, all in flight at once; n2 a
// multiple of 4), added to a row of running sums after them.
template <typename Out>
__device__ void add_partials(const float* src, int count, int n2,
                             int nthreads, float* buf, int cap, Out out) {
  const int tid = threadIdx.x;
  float* acc = buf + (size_t)cap * n2;
  for (int c = tid; c < n2; c += nthreads) acc[c] = 0.f;
  for (int k0 = 0; k0 < count; k0 += cap) {
    const int rows = min(cap, count - k0);
    const float* from = src + (long long)k0 * n2;
    for (int i = tid; i < rows * n2 / 4; i += nthreads)
      sm90::cp_async16(smem_u32(buf + 4 * i), from + 4 * i, 16);
    sm90::cp_async_wait_all();
    __syncthreads();
    for (int c = tid; c < n2; c += nthreads) {
      float sum = acc[c];
      for (int k = 0; k < rows; ++k) sum += buf[k * n2 + c];
      acc[c] = sum;
    }
    __syncthreads();
  }
  for (int c = tid; c < n2; c += nthreads) out(c, acc[c]);
}

// After every thread of the block wrote its share of the block's partial:
// the ticket groups (see the note at the top).  `nthreads` threads; the
// partials added through shared memory `buf` (`cap` rows) with kStaged,
// else from registers.
template <bool kStaged>
__device__ void finish_partials(const BwdArgs& a, int nthreads, float* buf,
                                int cap) {
  __shared__ unsigned last;
  const int tid = threadIdx.x;
  const int blocks = gridDim.x, q = blockIdx.x / kGroup;
  const int groups = (blocks + kGroup - 1) / kGroup;
  const int size = min(kGroup, blocks - q * kGroup);
  const int d = a.d, n2 = 2 * d;
  __syncthreads();
  if (tid == 0) last = take_ticket(&a.tickets[q]) == (unsigned)size - 1;
  __syncthreads();
  if (!last) return;
  if (tid == 0) a.tickets[q] = 0;
  const auto add = [&](const float* src, int count, auto out) {
    if constexpr (kStaged)
      add_partials(src, count, n2, nthreads, buf, cap, out);
    else
      add_partials(src, count, n2, nthreads, out);
  };
  const auto to_out = [&](int c, float v) {
    if (c < d)
      a.dw[c] = v;
    else
      a.db[c - d] = v;
  };
  const float* mine = a.part + (long long)q * kGroup * n2;
  if (groups == 1) {  // one group: its last block is the last of all
    add(mine, size, to_out);
    return;
  }
  float* gq = a.gpart + (long long)q * n2;
  add(mine, size, [&](int c, float v) { gq[c] = v; });
  __syncthreads();
  if (tid == 0)
    last = take_ticket(&a.tickets[kMaxGroups]) == (unsigned)groups - 1;
  __syncthreads();
  if (!last) return;
  if (tid == 0) a.tickets[kMaxGroups] = 0;
  add(a.gpart, groups, to_out);
}

// Bytes at the start of a backward block's shared memory: its ring at the
// arm's largest chunk, `ch_max` rows (at any chunk the call takes); reused
// once every chunk is read for the warps' dw / db sums (8 or 4 rows of 2d
// floats: the ring holds at least 1.5 x as many) and for the partials a
// last block adds.
__host__ __device__ inline size_t bwd_region(int ch_max, int d, int esz) {
  return (size_t)kStages * 2 * ch_max * d * esz;
}

template <typename T, int L, int VPL>
__global__ void __launch_bounds__(Cfg<T, L, VPL, true>::WARPS * 32, 2)
    ln_bwd_vec(const BwdArgs a) {
  using C = Cfg<T, L, VPL, true>;
  using V = V16<T>;
  constexpr int E = C::E;
  constexpr int RPW = C::RPW;
  constexpr int WARPS = C::WARPS;
  constexpr int GPW = C::GPW;
  constexpr bool kRegW = VPL == 1;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int seg = lane / L, s = lane % L;
  const int d = a.d, nv = d / E;
  const size_t row_bytes = (size_t)d * sizeof(T);
  const size_t half = (size_t)a.ch * row_bytes;  // x rows, then dy rows
  const size_t region = bwd_region(C::CH, d, (int)sizeof(T));
  float* ws = reinterpret_cast<float*>(smem + region);
  const uint32_t bars = smem_u32(ws + d);
  const long long r_begin = blockIdx.x * a.per;
  const long long r_end = min(a.rows, r_begin + a.per);
  const long long nrows = r_end > r_begin ? r_end - r_begin : 0;
  const int mine = (int)(((unsigned)nrows + a.ch - 1) / (unsigned)a.ch);
  const unsigned char* xg = static_cast<const unsigned char*>(a.x);
  const unsigned char* gg = static_cast<const unsigned char*>(a.dy);
  auto issue = [&](int k) {
    const long long r0 = r_begin + (long long)k * a.ch;
    const long long n = min((long long)a.ch, r_end - r0);
    const uint32_t bytes = (uint32_t)(n * (long long)row_bytes);
    const uint32_t bar = bars + 8 * (k % kStages);
    const uint32_t dst = smem_u32(smem + (k % kStages) * 2 * half);
    mbar_expect_tx(bar, 2 * bytes);
    bulk_load(dst, xg + r0 * (long long)row_bytes, bytes, bar);
    bulk_load(dst + (uint32_t)half, gg + r0 * (long long)row_bytes, bytes,
              bar);
  };
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(bars + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    sm90::fence_proxy_async();
  }
  __syncthreads();
  if (tid == 0)
    for (int k = 0; k < kStages && k < mine; ++k) issue(k);
  for (int c = tid; c < d; c += WARPS * 32) ws[c] = a.w[c];
  __syncthreads();
  float wr[E];
  if constexpr (kRegW) {
    if (s < nv) cols16<E>(ws, s, wr);
  }
  float acc_w[VPL][E], acc_b[VPL][E];
#pragma unroll
  for (int i = 0; i < VPL; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) acc_w[i][e] = acc_b[i][e] = 0.f;
  // The n rows of a chunk from row r0: x at xb, dy at gb; mu and rs the
  // statistics of this lane's rows.
  auto run = [&](const unsigned char* xb, const unsigned char* gb,
                 long long r0, int n, const float* mu, const float* rs) {
#pragma unroll
    for (int u = 0; u < GPW; ++u) {
      const int g = warp + u * WARPS;
      if (g * RPW >= n) continue;  // the same for the whole warp
      const int rl = g * RPW + seg;
      const bool live = rl < n;
      const unsigned char* xr = xb + (size_t)rl * row_bytes;
      const unsigned char* gr = gb + (size_t)rl * row_bytes;
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        const int j = s + L * i;
        if (live && j < nv) {
          float xv[E], gv[E], wv[E];
          V::load(xr + 16 * j, xv);
          V::load(gr + 16 * j, gv);
          if constexpr (kRegW) {
#pragma unroll
            for (int e = 0; e < E; ++e) wv[e] = wr[e];
          } else {
            cols16<E>(ws, j, wv);
          }
#pragma unroll
          for (int e = 0; e < E; ++e) {
            const float xh = (xv[e] - mu[u]) * rs[u];
            const float gw = gv[e] * wv[e];
            s1 += gw;
            s2 += gw * xh;
            acc_w[i][e] += gv[e] * xh;
            acc_b[i][e] += gv[e];
          }
        }
      }
      const float mg = seg_sum<L>(s1) / d;
      const float mgx = seg_sum<L>(s2) / d;
      if (live) {
        char* dxr = static_cast<char*>(a.dx) +
                    (r0 + rl) * (long long)row_bytes;
#pragma unroll
        for (int i = 0; i < VPL; ++i) {
          const int j = s + L * i;
          if (j < nv) {
            float xv[E], gv[E], wv[E], o[E];
            V::load(xr + 16 * j, xv);
            V::load(gr + 16 * j, gv);
            if constexpr (kRegW) {
#pragma unroll
              for (int e = 0; e < E; ++e) wv[e] = wr[e];
            } else {
              cols16<E>(ws, j, wv);
            }
#pragma unroll
            for (int e = 0; e < E; ++e) {
              const float xh = (xv[e] - mu[u]) * rs[u];
              o[e] = rs[u] * (gv[e] * wv[e] - mg - xh * mgx);
            }
            V::store(dxr + 16 * j, o);
          }
        }
      }
    }
  };
  for (int k = 0; k < mine; ++k) {
    const long long r0 = r_begin + (long long)k * a.ch;
    const int n = (int)min((long long)a.ch, r_end - r0);
    // This lane's rows' statistics, loaded before the wait.
    float mu[GPW], rs[GPW];
#pragma unroll
    for (int u = 0; u < GPW; ++u) {
      const int rl = (warp + u * WARPS) * RPW + seg;
      mu[u] = rl < n ? a.mean[r0 + rl] : 0.f;
      rs[u] = rl < n ? a.rstd[r0 + rl] : 0.f;
    }
    const int st = k % kStages;
    mbar_wait(bars + 8 * st, (k / kStages) & 1);
    const unsigned char* xb = smem + st * 2 * half;
    run(xb, xb + half, r0, n, mu, rs);
    __syncthreads();  // stage st read by every warp: refill it
    if (tid == 0 && k + kStages < mine) issue(k + kStages);
  }
  // The segments of a warp hold the same columns: add them (every lane
  // gets the sums, in the same order).
#pragma unroll
  for (int o = L; o < 32; o <<= 1)
#pragma unroll
    for (int i = 0; i < VPL; ++i)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        acc_w[i][e] += __shfl_xor_sync(0xffffffffu, acc_w[i][e], o);
        acc_b[i][e] += __shfl_xor_sync(0xffffffffu, acc_b[i][e], o);
      }
  // The warps' sums, added in warp order, at the start of shared memory
  // (the ring's: every chunk has been read, the loop ended on a barrier).
  float* red = reinterpret_cast<float*>(smem);
  const int n2 = 2 * d;
  if (seg == 0) {
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int j = s + L * i;
      if (j < nv) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          red[warp * n2 + j * E + e] = acc_w[i][e];
          red[warp * n2 + d + j * E + e] = acc_b[i][e];
        }
      }
    }
  }
  __syncthreads();
  for (int c = tid; c < n2; c += WARPS * 32) {
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) sum += red[k * n2 + c];
    a.part[(long long)blockIdx.x * n2 + c] = sum;
  }
  // The partials a last block adds: through the region, 4 bytes a float
  // of n2 a row, less a row of running sums.
  finish_partials<true>(a, WARPS * 32, red,
                        (int)(region / (4 * (size_t)n2)) - 1);
}

// The scalar backward arm: one warp a row of the block's range, lane c of
// each 32 columns; x and dy read again from device memory (L1) for dx.
template <typename T, int VPT>
__global__ void __launch_bounds__(kWarps * 32)
    ln_bwd_rows(const BwdArgs a) {
  __shared__ float red[kWarps][32 * VPT];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d = a.d;
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  T* dx = static_cast<T*>(a.dx);
  float acc_w[VPT], acc_b[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) acc_w[i] = acc_b[i] = 0.f;
  const long long r_begin = blockIdx.x * a.per;
  const long long r_end = min(a.rows, r_begin + a.per);
  for (long long row = r_begin + warp; row < r_end; row += kWarps) {
    const T* xr = x + row * d;
    const T* gr = dy + row * d;
    const float mu = a.mean[row], rs = a.rstd[row];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = lane + 32 * i;
      if (c < d) {
        const float xh = (load_f(xr + c) - mu) * rs;
        const float g = load_f(gr + c);
        const float gw = g * a.w[c];
        acc_w[i] += g * xh;
        acc_b[i] += g;
        s1 += gw;
        s2 += gw * xh;
      }
    }
    const float mg = warp_sum(s1) / d;
    const float mgx = warp_sum(s2) / d;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = lane + 32 * i;
      if (c < d) {
        const float xh = (load_f(xr + c) - mu) * rs;
        store_f(dx + row * d + c,
                rs * (load_f(gr + c) * a.w[c] - mg - xh * mgx));
      }
    }
  }
  // dw, then db: the eight warps' sums added in warp order.
  const int n2 = 2 * d;
#pragma unroll
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int i = 0; i < VPT; ++i)
      red[warp][lane + 32 * i] = which == 0 ? acc_w[i] : acc_b[i];
    __syncthreads();
    for (int c = threadIdx.x; c < d; c += kWarps * 32) {
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) sum += red[k][c];
      a.part[(long long)blockIdx.x * n2 + which * d + c] = sum;
    }
    __syncthreads();
  }
  finish_partials<false>(a, kWarps * 32, nullptr, 0);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) ==
        cudaSuccess)
      counts[dev] = n;
  }
  return counts[dev];
}

int l2_bytes() {
  static int bytes[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (bytes[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrL2CacheSize, dev) ==
        cudaSuccess)
      bytes[dev] = n;
  }
  return bytes[dev];
}

// One vector-arm kernel: its function, its configuration, and (read once)
// its shared memory allowed and its resident blocks an SM there.
struct KernelRef {
  const void* fn;
  int warps, gpw, rpw, ch_max, smem_max, occ;
  cudaError_t err;
};

// The kernels of a vector arm: the forward's ring, its direct kernel, the
// backward.
enum Kind { kRing = 0, kDirect = 1, kBackward = 2 };

template <typename T, int L, int VPL, int K>
const KernelRef* ref() {
  static const KernelRef r = [] {
    constexpr bool BWD = K == kBackward;
    using C = Cfg<T, L, VPL, BWD>;
    KernelRef k{};
    if constexpr (K == kBackward)
      k.fn = reinterpret_cast<const void*>(ln_bwd_vec<T, L, VPL>);
    else if constexpr (K == kDirect)
      k.fn = reinterpret_cast<const void*>(ln_fwd_direct<T, L, VPL>);
    else
      k.fn = reinterpret_cast<const void*>(ln_fwd_vec<T, L, VPL>);
    k.warps = C::WARPS;
    k.gpw = C::GPW;
    k.rpw = C::RPW;
    k.ch_max = C::CH;
    k.smem_max = K == kDirect ? 0 : C::SMEM_MAX;
    k.err = cudaFuncSetAttribute(
        k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, k.smem_max);
    if (k.err == cudaSuccess)
      k.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &k.occ, k.fn, C::WARPS * 32, k.smem_max);
    return k;
  }();
  return &r;
}

// The vector arm of a row of d elements of esz bytes: lanes a row and
// vectors a lane; lanes 0 for the scalar arm.
struct Arm {
  int lanes, vpl;
};

Arm pick_arm(int d, int esz, bool aligned) {
  const int vec = 16 / esz;
  if (!aligned || d % vec != 0) return {0, 0};
  const int nv = d / vec;
  if (nv <= 16) {
    int lanes = 1;
    while (lanes < nv) lanes <<= 1;
    return {lanes, 1};
  }
  const int need = (nv + 31) / 32;
  int vpl = need <= 1 ? 1 : need <= 2 ? 2 : need <= 4 ? 4 : 0;
  if (vpl == 0) vpl = esz == 2 ? 5 : need <= 8 ? 8 : 10;
  return {32, vpl};
}

template <typename T, int K>
const KernelRef* vec_ref(Arm arm) {
  constexpr bool BWD = K == kBackward;
  switch (arm.lanes) {
    case 1: return ref<T, 1, 1, K>();
    case 2: return ref<T, 2, 1, K>();
    case 4: return ref<T, 4, 1, K>();
    case 8: return ref<T, 8, 1, K>();
    case 16: return ref<T, 16, 1, K>();
    case 32:
      switch (arm.vpl) {
        case 1: return ref<T, 32, 1, K>();
        case 2: return ref<T, 32, 2, K>();
        case 4: return ref<T, 32, 4, K>();
        case 5:
          if constexpr (sizeof(T) == 2 && !BWD) return ref<T, 32, 5, K>();
          break;
        case 8:
          if constexpr (sizeof(T) == 4) return ref<T, 32, 8, K>();
          break;
        case 10:
          if constexpr (sizeof(T) == 4 && !BWD) return ref<T, 32, 10, K>();
          break;
      }
  }
  return nullptr;
}

template <int K>
const KernelRef* vector_kernel(Arm arm, int dtype) {
  return dtype == 1 ? vec_ref<__nv_bfloat16, K>(arm) : vec_ref<float, K>(arm);
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// How a call's rows are laid out (also exported by `ln_plan`).
struct Plan {
  Arm arm;
  const KernelRef* k;  // null for the scalar arm
  int rpw;             // rows a warp holds at once
  int ch;              // rows a chunk (scalar forward: a block's 8 rows)
  long long grid;
  long long spread;    // forward: chunks; backward: rows a block
  int smem;            // dynamic shared memory a block
  int occ;             // resident blocks an SM (the instantiation's)
  int direct;          // rows straight from device memory, no ring
};

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

cudaError_t forward_plan(long long rows, int d, int dtype, bool aligned,
                         Plan* p) {
  const int esz = dtype == 1 ? 2 : 4;
  *p = Plan{};
  p->arm = pick_arm(d, esz, aligned);
  if (p->arm.lanes == 0) {
    p->rpw = 1;
    p->ch = kWarps;
    p->grid = ceil_div(rows, kWarps);
    p->spread = p->grid;
    p->direct = 1;
    return cudaSuccess;
  }
  p->k = vector_kernel<kRing>(p->arm, dtype);
  if (p->k == nullptr) return cudaErrorInvalidValue;
  if (p->k->err != cudaSuccess) return p->k->err;
  const int sms = sm_count();
  if (sms <= 0 || p->k->occ <= 0) return cudaErrorInvalidConfiguration;
  const long long want = (long long)sms * p->k->occ;
  const int w = p->k->warps, rpw = p->k->rpw;
  // Row groups a chunk: enough chunks for every resident block where the
  // rows allow (fewer groups than warps where they are few), else a
  // multiple of the block's warps, at most its ring's stage.
  long long cg = ceil_div(ceil_div(rows, rpw), want);
  if (cg > w) cg = ceil_div(cg, w) * w;
  if (cg > (long long)w * p->k->gpw) cg = (long long)w * p->k->gpw;
  p->rpw = rpw;
  p->ch = (int)cg * rpw;
  p->spread = ceil_div(rows, p->ch);
  p->grid = p->spread < want ? p->spread : want;
  p->smem = kStages * p->ch * d * esz + 2 * d * 4 + kStages * 8;
  p->occ = p->k->occ;
  // Two chunks a block or fewer: the ring's set-up costs more than it
  // hides; the direct kernel takes a row group a warp, a block of them a
  // chunk.
  p->direct = p->spread <= 2 * want;
  if (p->direct) {
    p->k = vector_kernel<kDirect>(p->arm, dtype);
    if (p->k->err != cudaSuccess) return p->k->err;
    // G row groups a warp: enough to keep the grid within
    // kDirectBlocksPerSM blocks an SM, at most the kernel's.
    long long g = ceil_div(ceil_div(rows, (long long)w * rpw),
                           (long long)kDirectBlocksPerSM * sms);
    const int most = p->arm.vpl <= 2 ? kDirectGroups : 1;
    if (g > most) g = most;
    p->ch = (int)g * w * rpw;
    p->spread = ceil_div(rows, p->ch);
    p->grid = p->spread;
    p->smem = 0;
    p->occ = p->k->occ;
  }
  return cudaSuccess;
}

long long backward_blocks(long long rows) {
  if (rows <= 0) return 0;
  long long cap = (long long)kBwdBlocksPerSM * sm_count();
  if (cap > (long long)kGroup * kMaxGroups) cap = (long long)kGroup * kMaxGroups;
  const long long want = ceil_div(rows, kBwdMinRows);
  return want < cap ? want : cap;
}

cudaError_t backward_plan(long long rows, int d, int dtype, bool aligned,
                          Plan* p) {
  const int esz = dtype == 1 ? 2 : 4;
  *p = Plan{};
  p->grid = backward_blocks(rows);
  p->spread = p->grid > 0 ? ceil_div(rows, p->grid) : 0;
  p->arm = pick_arm(d, esz, aligned);
  if (p->arm.lanes == 0) {
    p->rpw = 1;
    p->ch = kWarps;
    p->occ = kBwdBlocksPerSM;
    p->direct = 1;
    return cudaSuccess;
  }
  p->k = vector_kernel<kBackward>(p->arm, dtype);
  if (p->k == nullptr) return cudaErrorInvalidValue;
  if (p->k->err != cudaSuccess) return p->k->err;
  const int w = p->k->warps, rpw = p->k->rpw;
  long long cg = ceil_div(p->spread > 0 ? p->spread : 1, rpw);
  if (cg > w) cg = ceil_div(cg, w) * w;
  if (cg > (long long)w * p->k->gpw) cg = (long long)w * p->k->gpw;
  p->rpw = rpw;
  p->ch = (int)cg * rpw;
  p->smem = (int)bwd_region(p->k->ch_max, d, esz) + d * 4 + kStages * 8;
  p->occ = p->k->occ;
  return cudaSuccess;
}

cudaError_t launch_plan(const Plan& p, void* args, cudaStream_t st) {
  void* params[] = {args};
  return cudaLaunchKernel(p.k->fn, dim3((unsigned)p.grid),
                          dim3(p.k->warps * 32), params, (size_t)p.smem, st);
}

template <typename T>
void launch_rows(const void* x, const float* w, const float* b, void* y,
                 long long rows, int d, float eps, float* mean, float* rstd,
                 cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  const dim3 grid((unsigned)ceil_div(rows, kWarps));
  const dim3 block(kWarps * 32);
  if (d <= 64)
    ln_rows<T, 2><<<grid, block, 0, st>>>(xp, w, b, yp, rows, d, eps, mean,
                                          rstd);
  else if (d <= 128)
    ln_rows<T, 4><<<grid, block, 0, st>>>(xp, w, b, yp, rows, d, eps, mean,
                                          rstd);
  else if (d <= 256)
    ln_rows<T, 8><<<grid, block, 0, st>>>(xp, w, b, yp, rows, d, eps, mean,
                                          rstd);
  else if (d <= 512)
    ln_rows<T, 16><<<grid, block, 0, st>>>(xp, w, b, yp, rows, d, eps, mean,
                                           rstd);
  else if (d <= 1024)
    ln_rows<T, 32><<<grid, block, 0, st>>>(xp, w, b, yp, rows, d, eps, mean,
                                           rstd);
  else
    ln_rows<T, 40><<<grid, block, 0, st>>>(xp, w, b, yp, rows, d, eps, mean,
                                           rstd);
}

template <typename T>
void launch_bwd_rows(const BwdArgs& a, long long blocks, cudaStream_t st) {
  const dim3 grid((unsigned)blocks), block(kWarps * 32);
  if (a.d <= 64)
    ln_bwd_rows<T, 2><<<grid, block, 0, st>>>(a);
  else if (a.d <= 128)
    ln_bwd_rows<T, 4><<<grid, block, 0, st>>>(a);
  else if (a.d <= 256)
    ln_bwd_rows<T, 8><<<grid, block, 0, st>>>(a);
  else if (a.d <= 512)
    ln_bwd_rows<T, 16><<<grid, block, 0, st>>>(a);
  else
    ln_bwd_rows<T, 32><<<grid, block, 0, st>>>(a);
}

int forward(const void* x, const void* w, const void* b, void* y, void* mean,
            void* rstd, long long rows, int d, float eps, int dtype,
            void* stream) {
  if (d < 1 || d > kMaxWidth) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Plan p;
  const cudaError_t err =
      forward_plan(rows, d, dtype, aligned16(x) && aligned16(y), &p);
  if (err != cudaSuccess) return (int)err;
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(b);
  float* mp = static_cast<float*>(mean);
  float* rp = static_cast<float*>(rstd);
  if (p.k == nullptr) {
    if (dtype == 1)
      launch_rows<__nv_bfloat16>(x, wp, bp, y, rows, d, eps, mp, rp, st);
    else
      launch_rows<float>(x, wp, bp, y, rows, d, eps, mp, rp, st);
    return (int)cudaGetLastError();
  }
  if (p.spread >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int once = (long long)rows * d * (dtype == 1 ? 2 : 4) >= l2_bytes();
  const int wb16 = aligned16(wp) && aligned16(bp);
  FwdArgs a{x, wp, bp, y, mp, rp, rows, p.spread, d, p.ch, eps, once, wb16};
  const cudaError_t launched = launch_plan(p, &a, st);
  return launched != cudaSuccess ? (int)launched : (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; 0 < d <= 1280 (else
// cudaErrorInvalidValue).  Returns cudaGetLastError().
extern "C" int ln_forward(const void* x, const void* w, const void* b,
                          void* y, long long rows, int d, float eps,
                          int dtype, void* stream) {
  return forward(x, w, b, y, nullptr, nullptr, rows, d, eps, dtype, stream);
}

// `ln_forward` that also writes each row's f32 mean and rstd (rows floats
// each), for the backward.
extern "C" int ln_forward_stats(const void* x, const void* w, const void* b,
                                void* y, void* mean, void* rstd,
                                long long rows, int d, float eps, int dtype,
                                void* stream) {
  return forward(x, w, b, y, mean, rstd, rows, d, eps, dtype, stream);
}

// The backward's blocks for `rows` rows on the current device: block k
// takes rows [k per, min((k + 1) per, rows)), per = ceil(rows / blocks).
extern "C" int ln_backward_blocks(long long rows) {
  return (int)backward_blocks(rows);
}

// Floats of the scratch `ln_backward` takes on the current device: the
// ticket words (zero before the first call; the kernel leaves them zero),
// then the blocks' and the groups' partials at any width.
extern "C" long long ln_backward_scratch_floats() {
  const long long blocks = backward_blocks(1LL << 40);
  return kTicketWords +
         (blocks + ceil_div(blocks, kGroup)) * 2LL * kMaxBwdWidth;
}

// dx (x's dtype), dw and db (f32, d each) from x, dy, w and the forward's
// mean and rstd; `scratch` holds `ln_backward_scratch_floats()` floats, its
// ticket words zero; 0 < d <= 1024 (else cudaErrorInvalidValue).  One
// launch.  Returns cudaGetLastError().
extern "C" int ln_backward(const void* x, const void* dy, const void* w,
                           const void* mean, const void* rstd, void* dx,
                           void* dw, void* db, void* scratch, long long rows,
                           int d, int dtype, void* stream) {
  if (d < 1 || d > kMaxBwdWidth) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0) {
    cudaMemsetAsync(dw, 0, (size_t)d * 4, st);
    cudaMemsetAsync(db, 0, (size_t)d * 4, st);
    return (int)cudaGetLastError();
  }
  Plan p;
  const cudaError_t err = backward_plan(
      rows, d, dtype, aligned16(x) && aligned16(dy) && aligned16(dx), &p);
  if (err != cudaSuccess) return (int)err;
  if (p.spread >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  float* sc = static_cast<float*>(scratch);
  float* part = sc + kTicketWords;
  BwdArgs a{x,
            dy,
            static_cast<const float*>(w),
            static_cast<const float*>(mean),
            static_cast<const float*>(rstd),
            dx,
            static_cast<float*>(dw),
            static_cast<float*>(db),
            part,
            part + p.grid * 2LL * d,
            reinterpret_cast<unsigned*>(sc),
            rows,
            p.spread,
            d,
            p.ch};
  if (p.k == nullptr) {
    if (dtype == 1)
      launch_bwd_rows<__nv_bfloat16>(a, p.grid, st);
    else
      launch_bwd_rows<float>(a, p.grid, st);
    return (int)cudaGetLastError();
  }
  const cudaError_t launched = launch_plan(p, &a, st);
  return launched != cudaSuccess ? (int)launched : (int)cudaGetLastError();
}

// How a forward (`backward` 0) or backward (1) call of `rows` x `d` in
// `dtype` lays out its rows on the current device, tensors aligned:
// out = {lanes a row (0: the scalar arm), vectors a lane, warps a block,
// rows a warp at once, rows a chunk, blocks, chunks (forward) or rows a
// block (backward), dynamic shared memory, resident blocks an SM, SMs,
// 1 where the rows are read straight from device memory (no ring)}.
extern "C" int ln_plan(int backward, long long rows, int d, int dtype,
                       long long* out) {
  Plan p;
  const cudaError_t err = backward ? backward_plan(rows, d, dtype, true, &p)
                                   : forward_plan(rows, d, dtype, true, &p);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.arm.lanes;
  out[1] = p.arm.vpl;
  out[2] = p.k ? p.k->warps : kWarps;
  out[3] = p.rpw;
  out[4] = p.ch;
  out[5] = p.grid;
  out[6] = p.spread;
  out[7] = p.smem;
  out[8] = p.occ;
  out[9] = sm_count();
  out[10] = p.direct;
  return (int)cudaSuccess;
}
