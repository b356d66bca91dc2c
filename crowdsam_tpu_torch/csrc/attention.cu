// Flash attention (head dim 64, bf16) for Hopper (sm_90a) with the
// decomposed relative-position bias added in the kernel.
//
// Replaces two TPU kernels of crowdsam_tpu/models/attention.py:
//   - `window_attention_pallas`      (SAM window blocks: 14x14 windows),
//   - `flash_mha_decomposed_relpos`  (SAM global blocks: 64x64 grid),
// the second through the library Pallas `flash_attention`.  DINOv2's
// `flash_mha` (no bias) runs on its own kernel, csrc/flash_sm90.cu.
//
// Bound: tensor-core operations for the global shape (4*S^2*64 FLOP per
// head against 4*S*64*2 bytes of q/k/v/o: ~1000 FLOP/byte), memory for the
// 196-token windows (~100 FLOP/byte, below the card's ~295).
//
// Design: one block of four warps per (batch or window, head, 64-query
// tile); each warp owns 16 query rows.  K and V tiles of 64 keys are staged
// in shared memory, rows padded to 144 bytes so that the ldmatrix reads of
// their B fragments (V's through the .trans form) meet no bank conflicts;
// QK^T and PV run on the tensor cores through
// mma.sync.m16n8k16 (bf16 operands, f32 accumulators), and the softmax is
// the online (running max / running sum) form in f32 registers, so no
// S x S tile ever reaches device memory.  The PV product takes the
// probabilities straight from the QK^T accumulators (the m16n8 C layout of
// two adjacent key chunks is the m16k16 A layout).  Keys at or beyond
// kv_len are masked to -inf.
//
// The TPU kernels fold the rel-pos bias into QK^T by widening the head to
// 192/256 columns; here the bias is added to the logits instead:
//   bias[q, k] = fh[q, row(k)] + fw[q, col(k)],  row = k / rel_w, col = k % rel_w
// with fh = q.Rh[row(q)] and fw = q.Rw[col(q)] computed outside (bf16).
// The 64-query tile's fh/fw rows sit in shared memory, and so do the
// row and column of each key of the current tile.
//
// Token addressing covers both layouts without copies: in global mode a
// token t of batch b is at b*bstride + t*ld; in window mode the "batch" is
// a window of a padded (Hp, Wp) grid and token t = (t / ws, t % ws) inside
// it.  Heads sit at h*hstride.  The head dimension must be contiguous.
// K/V tiles are double-buffered with cp.async: the next tile loads while
// this one is computed.  No TMA, no wgmma yet: csrc/flash_sm90.cu shows
// the pipeline this kernel can take, with the bias in its softmax.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;        // head dim
constexpr int BQ = 64;       // query rows per block (4 warps x 16)
constexpr int BK = 64;       // keys per tile
constexpr int KPAD = D + 8;  // shared row stride (bf16), avoids bank conflicts
constexpr int MAXREL = 64;   // max rel-pos rows/cols

struct Strides {
  long long bs, hs, ld;  // batch, head, token strides (elements)
};

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  const __nv_bfloat16* fh;
  const __nv_bfloat16* fw;
  Strides sq, sk, sv, so;
  int heads, seq, kv_len;
  float scale_log2;  // softmax scale * log2(e)
  int win, nwh, nww, grid_w;
  int rel_h, rel_w;
};

__device__ __forceinline__ long long token_offset(const Params& p,
                                                  const Strides& s, int b,
                                                  int t) {
  if (p.win == 0) return (long long)b * s.bs + (long long)t * s.ld;
  const int per = p.nwh * p.nww;
  const int img = b / per, r = b % per;
  const int wy = r / p.nww, wx = r % p.nww;
  const int ty = t / p.win, tx = t % p.win;
  const long long pix =
      (long long)(wy * p.win + ty) * p.grid_w + (wx * p.win + tx);
  return (long long)img * s.bs + pix * s.ld;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// Four 8x8 b16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i (16 contiguous bytes each).
__device__ __forceinline__ void ldsm_x4(uint32_t* r, unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// cp.async of 16 bytes global -> shared; src_bytes 0 fills zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

constexpr int FPAD = MAXREL + 2;  // fh/fw row stride: rows on distinct banks

// Dynamic shared memory: K and V, two buffers each, then the query tile's
// fh/fw rows and each buffer's key row/column tables.
constexpr int KV_BYTES = 2 * BK * KPAD * 2;
constexpr int SMEM_BYTES = 2 * KV_BYTES + 2 * BQ * FPAD * 2 + 4 * BK;

__global__ void __launch_bounds__(128)
flash_attn_relpos(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  typedef __nv_bfloat16 Tile[BK][KPAD];
  Tile* ks = reinterpret_cast<Tile*>(smem);
  Tile* vs = reinterpret_cast<Tile*>(smem + KV_BYTES);
  typedef __nv_bfloat16 FRow[FPAD];
  FRow* fhs = reinterpret_cast<FRow*>(smem + 2 * KV_BYTES);
  FRow* fws = fhs + BQ;
  unsigned char* krs = reinterpret_cast<unsigned char*>(fws + BQ);  // [2][BK]
  unsigned char* kcs = krs + 2 * BK;                                 // [2][BK]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int lm_i = lane >> 3, lm_r = lane & 7;  // ldmatrix: matrix, row
  const int b = blockIdx.z, h = blockIdx.y;
  const int q_tile = blockIdx.x * BQ;

  // Stage one 64-key tile of K and V (16 bytes a thread a step, keys past
  // kv_len zero-filled) and its keys' rows and columns.
  auto load_tile = [&](int kt, int buf) {
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int e = it * 128 + tid;
      const int key = e >> 3, chunk = (e & 7) * 8;
      const int kg = kt + key;
      const bool ok = kg < p.kv_len;
      const __nv_bfloat16* kp = p.k;
      const __nv_bfloat16* vp = p.v;
      if (ok) {
        kp += token_offset(p, p.sk, b, kg) + h * p.sk.hs + chunk;
        vp += token_offset(p, p.sv, b, kg) + h * p.sv.hs + chunk;
      }
      cp_async16(&ks[buf][key][chunk], kp, ok ? 16 : 0);
      cp_async16(&vs[buf][key][chunk], vp, ok ? 16 : 0);
    }
    if (tid < BK) {
      const int kg = kt + tid;
      krs[buf * BK + tid] = (unsigned char)(kg / p.rel_w);
      kcs[buf * BK + tid] = (unsigned char)(kg % p.rel_w);
    }
    cp_async_commit();
  };
  load_tile(0, 0);

  {
    const long long base = ((long long)b * p.heads + h) * p.seq;
    for (int e = tid; e < BQ * p.rel_h; e += 128) {
      const int r = e / p.rel_h, j = e % p.rel_h;
      const int qi = q_tile + r;
      fhs[r][j] = qi < p.seq ? p.fh[(base + qi) * p.rel_h + j]
                             : __float2bfloat16(0.f);
    }
    for (int e = tid; e < BQ * p.rel_w; e += 128) {
      const int r = e / p.rel_w, j = e % p.rel_w;
      const int qi = q_tile + r;
      fws[r][j] = qi < p.seq ? p.fw[(base + qi) * p.rel_w + j]
                             : __float2bfloat16(0.f);
    }
  }

  // Q fragments (A operand, m16k16) for the warp's 16 rows x 64 dims.
  const int r0 = q_tile + warp * 16 + g;  // this thread's rows r0, r0 + 8
  const int r1 = r0 + 8;
  uint32_t qa[4][4];
  {
    const __nv_bfloat16* q0 =
        r0 < p.seq ? p.q + token_offset(p, p.sq, b, r0) + h * p.sq.hs : nullptr;
    const __nv_bfloat16* q1 =
        r1 < p.seq ? p.q + token_offset(p, p.sq, b, r1) + h * p.sq.hs : nullptr;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int c = kk * 16 + 2 * t4;
      qa[kk][0] = q0 ? *reinterpret_cast<const uint32_t*>(q0 + c) : 0u;
      qa[kk][1] = q1 ? *reinterpret_cast<const uint32_t*>(q1 + c) : 0u;
      qa[kk][2] = q0 ? *reinterpret_cast<const uint32_t*>(q0 + c + 8) : 0u;
      qa[kk][3] = q1 ? *reinterpret_cast<const uint32_t*>(q1 + c + 8) : 0u;
    }
  }

  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const int lr0 = warp * 16 + g, lr1 = lr0 + 8;  // block-local query rows

  for (int kt = 0, buf = 0; kt < p.kv_len; kt += BK, buf ^= 1) {
    // Prefetch the next tile into the other buffer (free since the end of
    // the previous step), then wait for this one.
    if (kt + BK < p.kv_len) {
      load_tile(kt + BK, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T for 64 keys: 8 chunks of 8 keys.  One ldmatrix.x4 gives
    // the B fragments of two 16-dim steps (matrices: dims +0, +8, +16,
    // +24 of the chunk's 8 key rows).
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk2 = 0; kk2 < 2; ++kk2) {
        uint32_t b[4];
        ldsm_x4(b, smem_addr(&ks[buf][n * 8 + lm_r][kk2 * 32 + lm_i * 8]));
        mma_bf16(s[n], qa[2 * kk2], b[0], b[1]);
        mma_bf16(s[n], qa[2 * kk2 + 1], b[2], b[3]);
      }
    }

    // Scale, bias, mask (log2 domain), row max.
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kl = n * 8 + 2 * t4 + j, kg = kt + kl;
        float x0 = s[n][j] * p.scale_log2;
        float x1 = s[n][2 + j] * p.scale_log2;
        const int kr = krs[buf * BK + kl], kc = kcs[buf * BK + kl];
        const float kb = 1.4426950408889634f;
        if (kg < p.kv_len) {
          x0 += kb * (__bfloat162float(fhs[lr0][kr]) +
                      __bfloat162float(fws[lr0][kc]));
          x1 += kb * (__bfloat162float(fhs[lr1][kr]) +
                      __bfloat162float(fws[lr1][kc]));
        }
        if (kg >= p.kv_len) x0 = x1 = -INFINITY;
        s[n][j] = x0;
        s[n][2 + j] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = exp2f(s[n][0] - mn0);
      s[n][1] = exp2f(s[n][1] - mn0);
      s[n][2] = exp2f(s[n][2] - mn1);
      s[n][3] = exp2f(s[n][3] - mn1);
      l0 += s[n][0] + s[n][1];
      l1 += s[n][2] + s[n][3];
    }

    // O += P V: 4 steps of 16 keys, 8 chunks of 8 dims.
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kq][0], s[2 * kq][1]);
      pa[1] = pack_bf16(s[2 * kq][2], s[2 * kq][3]);
      pa[2] = pack_bf16(s[2 * kq + 1][0], s[2 * kq + 1][1]);
      pa[3] = pack_bf16(s[2 * kq + 1][2], s[2 * kq + 1][3]);
      // ldmatrix.x4.trans: the B fragments of two 8-dim chunks (matrices:
      // keys +0 / +8 of dims n*8, then of dims (n+1)*8).
      const int key = kq * 16 + (lm_i & 1) * 8 + lm_r;
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        uint32_t b[4];
        ldsm_x4_trans(b, smem_addr(
            &vs[buf][key][(2 * n2 + (lm_i >> 1)) * 8]));
        mma_bf16(o[2 * n2], pa, b[0], b[1]);
        mma_bf16(o[2 * n2 + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two steps later
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  if (r0 < p.seq) {
    __nv_bfloat16* out = p.o + token_offset(p, p.so, b, r0) + h * p.so.hs;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<uint32_t*>(out + n * 8 + 2 * t4) =
          pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
  }
  if (r1 < p.seq) {
    __nv_bfloat16* out = p.o + token_offset(p, p.so, b, r1) + h * p.so.hs;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<uint32_t*>(out + n * 8 + 2 * t4) =
          pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
}

}  // namespace

// strides: host array of 12 int64, (batch, head, token) strides in elements
// for q, k, v, o in that order.  fh/fw: contiguous (batch, heads, seq,
// rel_h) / (..., rel_w) bf16.
// win == 0: global layout; win > 0: windows of a (nwh*win, nww*win) grid of
// row width grid_w tokens.  Returns cudaGetLastError().
extern "C" int attn_forward(const void* q, const void* k, const void* v,
                            void* o, const void* fh, const void* fw,
                            const long long* strides, int batch, int heads,
                            int seq, int kv_len, float scale, int win,
                            int nwh, int nww, int grid_w, int rel_h,
                            int rel_w, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.fh = static_cast<const __nv_bfloat16*>(fh);
  p.fw = static_cast<const __nv_bfloat16*>(fw);
  Strides* ss[4] = {&p.sq, &p.sk, &p.sv, &p.so};
  for (int i = 0; i < 4; ++i) {
    ss[i]->bs = strides[3 * i];
    ss[i]->hs = strides[3 * i + 1];
    ss[i]->ld = strides[3 * i + 2];
  }
  p.heads = heads;
  p.seq = seq;
  p.kv_len = kv_len;
  p.scale_log2 = scale * 1.4426950408889634f;
  p.win = win;
  p.nwh = nwh;
  p.nww = nww;
  p.grid_w = grid_w;
  p.rel_h = rel_h;
  p.rel_w = rel_w;
  if (fh == nullptr || fw == nullptr || rel_h > MAXREL || rel_w > MAXREL ||
      rel_w < 1)
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attn_relpos, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((seq + BQ - 1) / BQ, heads, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (seq > 0 && batch > 0)
    flash_attn_relpos<<<grid, 128, SMEM_BYTES, st>>>(p);
  return (int)cudaGetLastError();
}
