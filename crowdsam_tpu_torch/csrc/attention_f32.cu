// Float32 attention for Hopper (sm_90a): the float32 arms of K2, K3 and K4,
// for `tpu.compute_dtype float32` on the card.
//
// The JAX package turns its Pallas kernels off for float32
// (`flash_enabled`, crowdsam_tpu/models/attention.py:33) and computes the
// same functions densely through XLA.  This source is the card's float32
// counterpart of the three kernels:
//   - K2 f32, `window_attention_pallas`
//     (crowdsam_tpu/models/attention.py:163): SAM's window blocks, 14x14
//     windows (any window up to 64x64) with the decomposed rel-pos bias;
//   - K3 f32, `flash_mha_decomposed_relpos` (attention.py:126): SAM's global
//     blocks, any grid up to 64x64, query bands (Sq < S) included;
//   - K4 f32, `flash_mha` (attention.py:86): DINOv2, keys at or past
//     `valid_len` masked, query bands included.
// Per (batch or window, head) and query row q, with keys k < valid:
//     O[q] = softmax_k(s[q, k]) v,
//     s[q, k] = (scale q).k + fh[q, row(k)] + fw[q, col(k)]    (K2, K3)
//     s[q, k] = scale (q.k)                                     (K4)
// row(k) = k / gw, col(k) = k % gw on the gh x gw key grid.  fh = q.Rh[row(q)]
// and fw = q.Rw[col(q)] come from the wrapper (float32 batched products, as
// the JAX float32 path computes them by einsum outside any kernel).  Keys
// at or past `valid` are masked to -inf: K4's valid_len, and for K2/K3 the
// key count, past which lie the pad keys of the last key tile (a window's
// 196 keys take four tiles of 64).
//
// Arithmetic: float32 throughout, FFMA on the CUDA cores: no tensor core,
// so no TF32 and no rounding to bf16 anywhere.  The softmax is online, in
// float32, with expf; the scale is applied where the plain versions apply it
// (to q before the product for K2/K3, to the product for K4).
//
// Bound: operations.  Q K^T and P V take 4 Sq S hd FLOP a head, at the
// card's 67 TFLOP/s float32 peak: 16x5330x64 (K4) 1.74 ms, 16x4096x64 (K3)
// 1.03 ms, 25x16x196x64 (K2) 0.059 ms.  The bytes are far below that (K4
// reads and writes 87 MB: 0.026 ms at 3.35 TB/s).
//
// Design (simple first; making it fast is later work).  A block of 256
// threads per (64-query tile, head, batch or window).  The query tile and,
// per 64-key tile, K and V come to shared memory by cp.async in 16-byte
// chunks (rows past the tensor zero-filled: nothing is read there), K and V
// double-buffered so that tile t + 1 is in flight while tile t is computed.
// Rows are padded to hd + 4 floats, so the 16-byte reads of 8 neighbouring
// rows fall on distinct banks.  Thread (ty, tx) of a 16x16 layout holds in
// registers the scores of query rows 4ty..4ty+3 against keys tx + 16j (j <
// 4), from float4 reads along the head dim; the running max and sum of its
// four rows, reduced over the 16 threads of a row by shuffles; and O of its
// four rows at dims 4tx..4tx+3 (and 64 + tx at head dim 80).  P goes
// through shared memory to the P V product, whose 64 terms a tile are
// summed apart before they join O: a sum in two levels, as cuBLAS's tiled
// float32 product of the plain version sums (one sequential sum over all S
// keys came to 1.9x the plain version's largest error on a card run).  fh
// and fw of the block's 64 query rows are staged in shared memory once.
// Shared memory: 137 KB at head dim 64 with the bias (one block an SM), 158
// KB at 80, 104 KB without the bias (two blocks an SM).
//
// Where this can go wrong, and what guards it:
//   1. A key tile dropped or read from the wrong stage: the loop waits for
//      tile t's copy group before the barrier, and the end-of-tile barrier
//      keeps a stage from being refilled while it is read.
//   2. The masking: keys at or past `valid` are -inf before the row max;
//      tile 0 always holds key 0, so every row's max is finite from the
//      first tile on.  Zero-filled V rows meet P = 0.
//   3. The bias indices: fh by the key's grid row, fw by its column, each
//      read for the query's own row of the staged terms.
//   chip_smoke.py's float32 phases hold plain versions with these faults
//   (the last key tile dropped, valid_len off by one, fh from the next grid
//   row, fw one column off, a window's pad key unmasked) against the bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // queries a block
constexpr int BK = 64;         // keys a tile
constexpr int THREADS = 256;
constexpr int PLD = BK + 4;    // padded row of the P tile (floats)
constexpr int MAX_GRID = 64;   // K2/K3: key grids up to 64x64

struct Strides {
  long long q[3], k[3], v[3], o[3];   // (batch, head, token), in elements
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = full ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + 64) of a (token, hd) slab whose token stride is `ld`
// into a [64][hd + 4] tile; rows at or past `rows` are zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile(float* tile, const float* base,
                                          long long ld, int row0, int rows) {
  constexpr int CH = HD / 4, LD = HD + 4;
  for (int c = threadIdx.x; c < BQ * CH; c += THREADS) {
    const int r = c / CH, ch = c - r * CH;
    const bool full = row0 + r < rows;
    const float* src = base + (full ? (long long)(row0 + r) * ld : 0) + ch * 4;
    cp_async16(tile + r * LD + ch * 4, src, full);
  }
}

__device__ __forceinline__ float lane(const float4& x, int u) {
  return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}

__host__ __device__ constexpr size_t smem_floats(int hd, bool relpos, int gh,
                                                 int gw) {
  return (size_t)BQ * (hd + 4) + 4 * (size_t)BK * (hd + 4) +
         (size_t)BQ * PLD + (relpos ? (size_t)BQ * (gh + gw) : 0);
}

template <int HD, bool RELPOS>
__global__ void __launch_bounds__(THREADS)
    attn_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o,
             const float* __restrict__ fh, const float* __restrict__ fw,
             Strides st, int heads, int sq, int s, int valid, int gh, int gw,
             float scale) {
  constexpr int LD = HD + 4;
  constexpr int XD = (HD - 64) / 16;   // dims past 64 a thread holds: 0 or 1
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // [BQ][LD]
  float* ks = qs + BQ * LD;            // [2][BK][LD]
  float* vs = ks + 2 * BK * LD;        // [2][BK][LD]
  float* ps = vs + 2 * BK * LD;        // [BQ][PLD]
  float* fhs = ps + BQ * PLD;          // [BQ][gh]  (RELPOS)
  float* fws = fhs + BQ * gh;          // [BQ][gw]  (RELPOS)

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const float* qb = q + b * st.q[0] + h * st.q[1];
  const float* kb = k + b * st.k[0] + h * st.k[1];
  const float* vb = v + b * st.v[0] + h * st.v[1];
  const int ntiles = (valid + BK - 1) / BK;

  load_tile<HD>(qs, qb, st.q[2], q0, sq);
  load_tile<HD>(ks, kb, st.k[2], 0, s);
  load_tile<HD>(vs, vb, st.v[2], 0, s);
  cp_commit();
  if (RELPOS) {
    // The block's rows of fh and fw (contiguous); rows past Sq get zeros.
    const long long row = ((long long)b * heads + h) * sq + q0;
    const int nq = min(BQ, sq - q0);
    for (int i = tid; i < BQ * gh; i += THREADS)
      fhs[i] = i < nq * gh ? fh[row * gh + i] : 0.f;
    for (int i = tid; i < BQ * gw; i += THREADS)
      fws[i] = i < nq * gw ? fw[row * gw + i] : 0.f;
  }
  cp_wait<0>();
  __syncthreads();
  if (RELPOS) {
    for (int i = tid; i < BQ * LD; i += THREADS) qs[i] *= scale;
    __syncthreads();
  }

  float m[4], l[4], acc[4][4 + XD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 + XD; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int cur = t & 1;
    if (t + 1 < ntiles) {
      load_tile<HD>(ks + (cur ^ 1) * BK * LD, kb, st.k[2], (t + 1) * BK, s);
      load_tile<HD>(vs + (cur ^ 1) * BK * LD, vb, st.v[2], (t + 1) * BK, s);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();

    // S = Q K^T for rows 4ty + i, keys tx + 16j.
    const float* kt = ks + cur * BK * LD;
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + (ty * 4 + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        c[j] = *reinterpret_cast<const float4*>(kt + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = sc[i][j];
          x = fmaf(a[i].x, c[j].x, x);
          x = fmaf(a[i].y, c[j].y, x);
          x = fmaf(a[i].z, c[j].z, x);
          x = fmaf(a[i].w, c[j].w, x);
          sc[i][j] = x;
        }
    }

    // Scale or bias, and the mask.
    bool ok[4];
    int kr[4], kc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = t * BK + tx + 16 * j;
      ok[j] = kk < valid;
      kr[j] = RELPOS && ok[j] ? kk / gw : 0;
      kc[j] = RELPOS && ok[j] ? kk - kr[j] * gw : 0;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = RELPOS ? sc[i][j] + fhs[r * gh + kr[j]] +
                                     fws[r * gw + kc[j]]
                               : sc[i][j] * scale;
        sc[i][j] = ok[j] ? x : -INFINITY;
      }
    }

    // Online softmax over the row's 16 threads (lanes of one half-warp).
    float scl[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(sc[i][0], sc[i][1]), fmaxf(sc[i][2], sc[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - mn);
        sc[i][j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = mn;
      scl[i] = alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[(ty * 4 + i) * PLD + tx + 16 * j] = sc[i][j];
    }
    __syncthreads();

    // O = O alpha + P V for rows 4ty + i, dims 4tx..4tx+3 (and 64 + tx).
    // The tile's 64 products are summed apart and then added to O: a sum
    // in two levels, whose rounding grows with 64 + S / 64 terms, not S.
    const float* vt = vs + cur * BK * LD;
    float part[4][4 + XD];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4 + XD; ++c) part[i][c] = 0.f;
#pragma unroll 2
    for (int c0 = 0; c0 < BK; c0 += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = *reinterpret_cast<const float4*>(ps + (ty * 4 + i) * PLD + c0);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 w =
            *reinterpret_cast<const float4*>(vt + (c0 + u) * LD + 4 * tx);
        float we = 0.f;
        if (XD) we = vt[(c0 + u) * LD + 64 + tx];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pi = lane(p[i], u);
          part[i][0] = fmaf(pi, w.x, part[i][0]);
          part[i][1] = fmaf(pi, w.y, part[i][1]);
          part[i][2] = fmaf(pi, w.z, part[i][2]);
          part[i][3] = fmaf(pi, w.w, part[i][3]);
          if (XD) part[i][4 + XD - 1] = fmaf(pi, we, part[i][4 + XD - 1]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4 + XD; ++c)
        acc[i][c] = fmaf(acc[i][c], scl[i], part[i][c]);
    __syncthreads();   // stage `cur` and P are free for the next tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= sq) continue;
    float* ob = o + b * st.o[0] + h * st.o[1] + (long long)r * st.o[2];
    const float4 w = make_float4(acc[i][0] / l[i], acc[i][1] / l[i],
                                 acc[i][2] / l[i], acc[i][3] / l[i]);
    *reinterpret_cast<float4*>(ob + 4 * tx) = w;
    if (XD) ob[64 + tx] = acc[i][4 + XD - 1] / l[i];
  }
}

template <int HD, bool RELPOS>
cudaError_t configure() {
  // The most shared memory any call of this instantiation asks for.
  static const cudaError_t status = cudaFuncSetAttribute(
      attn_f32<HD, RELPOS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(smem_floats(HD, RELPOS, MAX_GRID, MAX_GRID) * sizeof(float)));
  return status;
}

template <int HD, bool RELPOS>
int launch(const float* q, const float* k, const float* v, float* o,
           const float* fh, const float* fw, const Strides& st, int batch,
           int heads, int sq, int s, int valid, int gh, int gw, float scale,
           cudaStream_t stream) {
  cudaError_t e = configure<HD, RELPOS>();
  if (e != cudaSuccess) return e;
  const size_t smem = smem_floats(HD, RELPOS, gh, gw) * sizeof(float);
  const dim3 grid((sq + BQ - 1) / BQ, heads, batch);
  attn_f32<HD, RELPOS><<<grid, THREADS, smem, stream>>>(
      q, k, v, o, fh, fw, st, heads, sq, s, valid, gh, gw, scale);
  return cudaGetLastError();
}

template <int HD, bool RELPOS>
int occupancy(int gh, int gw, int* out) {
  cudaError_t e = configure<HD, RELPOS>();
  if (e != cudaSuccess) return e;
  const size_t smem = smem_floats(HD, RELPOS, gh, gw) * sizeof(float);
  out[0] = (int)smem;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], attn_f32<HD, RELPOS>, THREADS, smem);
}

}  // namespace

// q, k, v: (B, H, Sq | S, hd) float32 with a contiguous head dim, 16-byte
// aligned rows; o: likewise (B, H, Sq, hd); strides: 12 int64, (batch, head,
// token) of q, k, v and o in elements.  fh (B, H, Sq, gh) and fw (B, H, Sq,
// gw) contiguous, or both null (K4: no bias, the product scaled).  Keys at
// or past `valid` are masked.  Returns a cudaError_t: cudaErrorInvalidValue
// for arguments the kernel does not take.
extern "C" int attention_f32_forward(const float* q, const float* k,
                                     const float* v, float* o,
                                     const float* fh, const float* fw,
                                     const long long* strides, int batch,
                                     int heads, int sq, int s, int valid,
                                     int gh, int gw, int head_dim, float scale,
                                     void* stream) {
  const bool relpos = fh != nullptr;
  if ((head_dim != 64 && head_dim != 80) || batch < 1 || heads < 1 ||
      batch > 65535 || heads > 65535 || sq < 1 || s < 1 || valid < 1 ||
      valid > s || relpos != (fw != nullptr))
    return cudaErrorInvalidValue;
  if (relpos && (gh < 1 || gw < 1 || gh > MAX_GRID || gw > MAX_GRID ||
                 (long long)gh * gw != s))
    return cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return relpos ? launch<64, true>(q, k, v, o, fh, fw, st, batch, heads, sq,
                                     s, valid, gh, gw, scale, cs)
                  : launch<64, false>(q, k, v, o, fh, fw, st, batch, heads,
                                      sq, s, valid, 1, 1, scale, cs);
  return relpos ? launch<80, true>(q, k, v, o, fh, fw, st, batch, heads, sq, s,
                                   valid, gh, gw, scale, cs)
                : launch<80, false>(q, k, v, o, fh, fw, st, batch, heads, sq,
                                    s, valid, 1, 1, scale, cs);
}

// out[0] the dynamic shared memory of a call, out[1] its blocks an SM.
extern "C" int attention_f32_occupancy(int head_dim, int relpos, int gh,
                                       int gw, int* out) {
  if (head_dim == 64)
    return relpos ? occupancy<64, true>(gh, gw, out)
                  : occupancy<64, false>(1, 1, out);
  if (head_dim == 80)
    return relpos ? occupancy<80, true>(gh, gw, out)
                  : occupancy<80, false>(1, 1, out);
  return cudaErrorInvalidValue;
}
