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
// pooling.
//
// Arithmetic: both products in 3xTF32 on wgmma (`tf32x3.cuh`), float32
// everywhere else; `mask_head_kernel.mask_head_tf32x3_model` is it in
// PyTorch.
//
// Bound: operations.  0.82 GFLOP a prompt at M = 4096 (256 -> 256: 0.54;
// 4 x 64 -> 128: 0.27; the hypernetwork dot 0.017): 26 GFLOP at 32
// prompts, 0.159 ms at 165 TFLOP/s (three TF32 products at 495); 0.20 GB
// moved (keys2 in, masks and e out).  Beside the products, 768 erff GELUs
// a row on the CUDA cores.
//
// Design.  A persistent grid of min(tiles x prompts, SMs) blocks of two
// consumer warpgroups and a producer warp (`tf32x3::THREADS`), one block an
// SM (227 KB of shared memory); block b takes the (64-row tile, prompt)
// items b, b + grid, ...  The second weight (hi + lo, 64 KB) is resident:
// the producer brings it once, then streams the first weight's 16 stages
// an item through a ring of three.  Per item:
//   1. the keys2 tile (64 x 256) to shared memory by cp.async (float32,
//      rows of 260 floats), the hypernetwork vectors;
//   2. for each 128-column chunk c of the first product (8 stages of
//      keys @ w0t^T), warpgroup w takes the 64 columns of group q1 = 2c + w
//      (m64n64k8): the accumulators are one group's 64 channels of the
//      warpgroup's 64 rows, a row's in the 4 lanes of a quad;
//   3. + b0, the group LayerNorm (sums over the thread's 16 values, then
//      the quad), GELU, in registers;
//   4. the second product, A from those registers: the accumulators d0,
//      d2, d1, d3 of each 8-column group are the A fragment of a k-step,
//      which holds columns 2t and 2t + 1 of the group at positions t and
//      t + 4, so the host packs the second weight with its inputs in that
//      order (`tf32x3.KEY_ORDER`); against the resident weight, in two
//      halves of 64 outputs (m64n64k8, 8 k-steps each, each k-stage of 4
//      summed on its own as in `tf32x3::product`: in one accumulator the
//      tensor core's truncating adds gave 1.4x the bound's mean error on
//      the shipped adapter's masks; the fragments split a k-stage at a
//      time: the whole product at once would hold 128 registers of
//      accumulators and fragments and spill, a block of 9 warps having 168
//      a thread): the group's 4 x 32 outputs;
//   5. + b2, GELU, the four hypernetwork dots of each of the 4 sub-pixels
//      (partials over the thread's 8 channels, then the quad); lane t of a
//      quad writes mask k = t of its rows, two sub-pixels a half;
//   6. with `emit_exp`: the tile max over the two warpgroups (warp
//      shuffles, then the eight warps through shared memory), e = exp(mask
//      - max) from the masks the thread wrote (read back: held in
//      registers over both chunks, they made ptxas spill).
//
// Where this design can go wrong, and what guards it:
//   1. The LayerNorm's group: 64 channels of one sub-pixel, not the row's
//      256 (chip_smoke.py's fault: the LayerNorm over all 256).
//   2. The sub-pixel order: q1 (the first product's group) major, q2 minor
//      in the packed axis (fault: q1 and q2 swapped).
//   3. The second weight's input order against the A fragments (fault of
//      the model: the weight's inputs in their own order).
//   4. The tile max over both warpgroups' masks (fault: the first warp's
//      rows only).
//   5. The hypernetwork vector of mask k read at k (fault: k + 1).
//   6. The stages and their swizzle: `tf32x3.cuh`; the model's faults of
//      every product (lo.hi dropped, a stage's lo from the next stage, A's
//      lo not split again at a k-step).
#include "tf32x3.cuh"

namespace {

using tf32x3::CONSUMERS;
using tf32x3::PART_BYTES;
using tf32x3::Ring;
using tf32x3::STAGE_BYTES;
using tf32x3::THREADS;
using tf32x3::TR;

constexpr int C = 256;        // keys2 width
constexpr int C1 = 64;        // channels after the first product, a group
constexpr int C2 = 32;        // channels after the second, a sub-pixel
constexpr int K = 4;          // masks
constexpr float EPS = 1e-6f;
constexpr int W0_STAGES = 16; // 2 chunks x 8 stages of the first weight
constexpr int RING = 3;       // stage slots

constexpr int LDA = C + 4;    // keys rows (floats)
// Shared memory, bytes from the 1024-aligned base.
constexpr int SM_RING = 0;
constexpr int SM_W2 = SM_RING + RING * STAGE_BYTES;   // 2 stages, resident
constexpr int SM_A = SM_W2 + 2 * STAGE_BYTES;         // [TR][LDA] floats
constexpr int SM_HYP = SM_A + TR * LDA * 4;           // [K][C2]
constexpr int SM_RED = SM_HYP + K * C2 * 4;           // [8] warp maxes
constexpr int SM_BAR = SM_RED + 8 * 4;                // full, empty, w2
constexpr int SM_BYTES = SM_BAR + 8 * (2 * RING + 1);
constexpr int SMEM = SM_BYTES + 1024;                 // + the alignment

struct Args {
  const float* keys;          // (P, M, C)
  const float* hyper;         // (P, K, C2)
  const unsigned char* w0p;   // w0t (4 C1, C) packed: 16 stages
  const float* b0;            // (4 C1)
  const float* lnw;           // (C1)
  const float* lnb;
  const unsigned char* w2p;   // w2t (4 C2, C1) packed, KEY_ORDER: 2 stages
  const float* b2;            // (4 C2)
  float* masks;               // (P, K, M, 16)
  float* e;                   // (P, K, M, 16), with emit_exp
  float* mx;                  // (P, M / TR), with emit_exp
  int P, M;
};

template <bool EXP>
__global__ void __launch_bounds__(THREADS, 1) mask_head_f32(Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = tf32x3::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  float* as = reinterpret_cast<float*>(sm + SM_A);
  float* hyp = reinterpret_cast<float*>(sm + SM_HYP);
  float* red = reinterpret_cast<float*>(sm + SM_RED);
  Ring ring{base + SM_RING, base + SM_BAR, base + SM_BAR + 8 * RING, 0,
            RING};
  const uint32_t w2bar = base + SM_BAR + 16 * RING;
  const int tid = threadIdx.x;
  const int nt = a.M / TR, items = nt * a.P;
  if (tid == 0) {
    tf32x3::ring_init(ring);
    tf32x3::mbar_init(w2bar, 1);
    tf32x3::mbar_init_fence();
  }
  __syncthreads();
  if (tid >= CONSUMERS) {
    // ---- producer: the second weight once, the first an item ----
    if (tid == CONSUMERS) {
      tf32x3::mbar_expect_tx(w2bar, 2 * STAGE_BYTES);
      tf32x3::bulk_load(base + SM_W2, a.w2p, 2 * STAGE_BYTES, w2bar);
      for (int it = blockIdx.x; it < items; it += gridDim.x)
        for (int s = 0; s < W0_STAGES; ++s)
          tf32x3::put(ring, a.w0p + (size_t)s * STAGE_BYTES);
    }
    return;
  }

  // ---- consumers: warpgroup wg, its warp w, lane (g, t4) ----
  const int wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * (warp & 3) + g;   // the thread's rows r0, r0 + 8
  bool w2_ready = false;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int tile = it % nt, p = it / nt;
    const size_t m0 = (size_t)tile * TR;
    tf32x3::consumers_sync();   // the last item's reads of A, hyp, red
    const float* src = a.keys + ((size_t)p * a.M + m0) * C;
    for (int c = tid; c < TR * C / 4; c += CONSUMERS) {
      const int r = c / (C / 4), q = c % (C / 4);
      tf32x3::cp_async16(as + r * LDA + 4 * q, src + (size_t)r * C + 4 * q);
    }
    if (tid < K * C2) hyp[tid] = a.hyper[(size_t)p * K * C2 + tid];
    tf32x3::cp_async_wait_all();
    tf32x3::consumers_sync();
    if (!w2_ready) {
      tf32x3::mbar_wait(w2bar, 0);
      w2_ready = true;
    }

    float mx = -INFINITY;   // over the thread's masks, with emit_exp
#pragma unroll 1
    for (int ch = 0; ch < 2; ++ch) {
      const int q1 = 2 * ch + wg;
      // 1. up = keys @ w0t^T + b0: group q1's 64 channels.
      float acc[32];
      tf32x3::product<4>(ring, acc, as, LDA, 8, true, wg);
      // 2. The group LayerNorm and GELU, a row's 64 values in its quad.
      float s[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        acc[i] += __ldg(a.b0 + C1 * q1 + tf32x3::acc_col(i));
        s[(i >> 1) & 1] += acc[i];
      }
      float mean[2], rs[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
        s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
        mean[h] = s[h] / C1;
      }
      float v[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float d = acc[i] - mean[(i >> 1) & 1];
        v[(i >> 1) & 1] = fmaf(d, d, v[(i >> 1) & 1]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        v[h] += __shfl_xor_sync(0xffffffffu, v[h], 1);
        v[h] += __shfl_xor_sync(0xffffffffu, v[h], 2);
        rs[h] = 1.f / sqrtf(v[h] / C1 + EPS);
      }
      // 3. The GELU of the normalised values, in place.
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = tf32x3::acc_col(i);
        acc[i] = tf32x3::gelu_erf((acc[i] - mean[(i >> 1) & 1]) *
                                      rs[(i >> 1) & 1] * __ldg(a.lnw + c) +
                                  __ldg(a.lnb + c));
      }
      // 4. The second product in two halves of 64 outputs (sub-pixels q2 =
      // 2 hf, 2 hf + 1), both k-stages of the resident weight summed in one
      // accumulator; + b2, GELU, the hypernetwork dots (output n = 32 q2 +
      // c): partials over the thread's 8 channels, then the quad.
      const uint32_t w2 = tf32x3::desc_lo(base + SM_W2);
#pragma unroll 1
      for (int hf = 0; hf < 2; ++hf) {
        float h[32];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          // A fragments of k-steps 4 ks..: k-step j takes (d[4j], d[4j + 2],
          // d[4j + 1], d[4j + 3]).
          uint32_t fh[4][4], fl[4][4];
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int j = 4 * (4 * ks + kk);
            tf32x3::split(acc[j], fh[kk][0], fl[kk][0]);
            tf32x3::split(acc[j + 2], fh[kk][1], fl[kk][1]);
            tf32x3::split(acc[j + 1], fh[kk][2], fl[kk][2]);
            tf32x3::split(acc[j + 3], fh[kk][3], fl[kk][3]);
          }
          const uint32_t hi = w2 + ks * (STAGE_BYTES >> 4) + hf * (8192 >> 4);
          const uint32_t lo = hi + (PART_BYTES >> 4);
          float part[32];   // the k-stage summed on its own (tf32x3.cuh)
          tf32x3::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            tf32x3::mma_n64(part, fl[kk], hi + 2 * kk, kk > 0);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            tf32x3::mma_n64(part, fh[kk], lo + 2 * kk, 1);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            tf32x3::mma_n64(part, fh[kk], hi + 2 * kk, 1);
          tf32x3::wgmma_commit();
          tf32x3::wgmma_wait0();
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            tf32x3::fence_reg(part[i]);
            h[i] = ks == 0 ? part[i] : h[i] + part[i];
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              tf32x3::fence_reg(fh[kk][i]);
              tf32x3::fence_reg(fl[kk][i]);
            }
        }
        float dots[2][2][K];   // [row][q2 - 2 hf][k]
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int k = 0; k < K; ++k) dots[rr][q][k] = 0.f;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int n = 64 * hf + tf32x3::acc_col(i), c = n & 31;
          const float y = tf32x3::gelu_erf(h[i] + __ldg(a.b2 + n));
#pragma unroll
          for (int k = 0; k < K; ++k)
            dots[(i >> 1) & 1][(n >> 5) & 1][k] =
                fmaf(hyp[k * C2 + c], y, dots[(i >> 1) & 1][(n >> 5) & 1][k]);
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
#pragma unroll
          for (int q = 0; q < 2; ++q) {
#pragma unroll
            for (int k = 0; k < K; ++k) {
              float x = dots[rr][q][k];
              x += __shfl_xor_sync(0xffffffffu, x, 1);
              x += __shfl_xor_sync(0xffffffffu, x, 2);
              dots[rr][q][k] = x;
            }
          }
        // lane t4 writes mask k = t4 of its rows, sub-pixels q1 4 + 2 hf..
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float m[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            m[q] = dots[rr][q][0];
#pragma unroll
            for (int k = 1; k < K; ++k)
              if (t4 == k) m[q] = dots[rr][q][k];
            mx = fmaxf(mx, m[q]);
          }
          const size_t row = m0 + r0 + 8 * rr;
          *reinterpret_cast<float2*>(
              a.masks + (((size_t)p * K + t4) * a.M + row) * 16 + q1 * 4 +
              2 * hf) = make_float2(m[0], m[1]);
        }
      }
    }
    if (!EXP) continue;

    // 5. The tile max over the block's masks, then e from the masks this
    // thread wrote.
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) red[warp] = mx;
    tf32x3::consumers_sync();
    mx = red[0];
#pragma unroll
    for (int w = 1; w < CONSUMERS / 32; ++w) mx = fmaxf(mx, red[w]);
    if (tid == 0) a.mx[(size_t)p * nt + tile] = mx;
#pragma unroll
    for (int ch = 0; ch < 2; ++ch)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const size_t at = (((size_t)p * K + t4) * a.M + m0 + r0 + 8 * rr) * 16 +
                          (2 * ch + wg) * 4;
        const float4 m = *reinterpret_cast<const float4*>(a.masks + at);
        *reinterpret_cast<float4*>(a.e + at) =
            make_float4(expf(m.x - mx), expf(m.y - mx), expf(m.z - mx),
                        expf(m.w - mx));
      }
  }
}

template <bool EXP>
cudaError_t configure() {
  static const cudaError_t status = cudaFuncSetAttribute(
      mask_head_f32<EXP>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  return status;
}

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 132;
    return v;
  }();
  return n;
}

}  // namespace

// keys (P, M, 256), hyper (P, 4, 32), b0 (256), lnw / lnb (64), b2 (128)
// float32 and contiguous; w0p and w2p the packed weights (`tf32x3.pack` of
// w0t (256, 256) and, inputs in KEY_ORDER, of w2t (128, 64)); masks (and,
// with emit_exp, e) (P, 4, M, 16) float32, mx (P, M / 64) float32.  Returns
// a cudaError_t: cudaErrorInvalidValue for arguments the kernel does not
// take.
extern "C" int mask_head_f32_forward(const float* keys, const float* hyper,
                                     const void* w0p, const float* b0,
                                     const float* lnw, const float* lnb,
                                     const void* w2p, const float* b2,
                                     float* masks, float* e, float* mx, int P,
                                     int M, int emit_exp, void* stream) {
  if (P <= 0 || M <= 0 || M % TR || (long long)P * (M / TR) > (1 << 30))
    return (int)cudaErrorInvalidValue;
  if (emit_exp && (e == nullptr || mx == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaError_t c = emit_exp ? configure<true>() : configure<false>();
  if (c != cudaSuccess) return (int)c;
  Args a;
  a.keys = keys;
  a.hyper = hyper;
  a.w0p = static_cast<const unsigned char*>(w0p);
  a.b0 = b0;
  a.lnw = lnw;
  a.lnb = lnb;
  a.w2p = static_cast<const unsigned char*>(w2p);
  a.b2 = b2;
  a.masks = masks;
  a.e = e;
  a.mx = mx;
  a.P = P;
  a.M = M;
  const int items = P * (M / TR);
  const int grid = items < sm_count() ? items : sm_count();
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (emit_exp)
    mask_head_f32<true><<<grid, THREADS, SMEM, cs>>>(a);
  else
    mask_head_f32<false><<<grid, THREADS, SMEM, cs>>>(a);
  return (int)cudaGetLastError();
}

// out[0] the kernel's dynamic shared memory, out[1] its blocks an SM.
extern "C" int mask_head_f32_occupancy(int* out) {
  const cudaError_t c = configure<true>();
  if (c != cudaSuccess) return (int)c;
  out[0] = SMEM;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[1], mask_head_f32<true>, THREADS, out[0]);
}
