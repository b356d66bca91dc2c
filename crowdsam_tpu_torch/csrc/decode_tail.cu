// The two-way transformer of the fused mask decode for Hopper (sm_90a).
//
// Replaces the TPU kernel `twoway_tail_pallas`
// (crowdsam_tpu/models/decode_tail_kernel.py:359, body `_kernel`): for each
// of P prompts, both two-way blocks (token self-attention, token->image
// attention, ReLU MLP, image->token update + LayerNorm) and the final
// token->image attention + LayerNorm.  In: keys0 (M, 256) and block 1's
// image-side projections q1i/k1/v1 (M, 128), shared by the prompts; tokens
// (P, T, 256).  Out: keys2 (P, M, 256) and the final tokens (P, T, 256).
//
// Bound: tensor-core operations.  Per 32 prompts at M = 4096 about 65 GFLOP
// of bf16 products (keys1 @ wide2 and keys2 @ widef carry two thirds)
// against ~70 MB that must move (keys2 out, the shared inputs, the weights).
//
// Design.  The TPU kernel holds one prompt's whole (M, 256) image tensor in
// VMEM; a block here has 227 KB, so the rows are tiled and the work is
// split by what crosses rows.  One call launches seven kernels on the
// caller's stream:
//
//   tok 0   block 1 self-attention, LN, q projection
//   row 0   partial token->image softmax over the shared k1/v1
//   tok 1   merge, out-projection, LN, MLP, LN; token keys and folded
//           values of update 1; block 2 self-attention, LN, q projection
//   row 1   keys1 = LN(keys0 + update 1); k2/v2 = keys1 @ wide2; partial
//           softmax of block 2
//   tok 2   merge, out-projection, LN, MLP, LN; token keys and folded values
//           of update 2; final q projection
//   row 2   keys1 again (recomputed from the shared keys0/q1i instead of a
//           round trip of 64 MB through device memory), q2i = keys1 @
//           wide2[q], keys2 = LN(keys1 + update 2), written once;
//           kf/vf = keys2 @ widef; partial softmax of the final attention
//   tok 3   merge, out-projection, final LN
//
// Row phases run as (row tile of 64, prompt) blocks of four warps; a warp
// owns 16 rows and keeps them in registers as mma.sync A fragments from the
// residual through the LayerNorm into the wide product (the m16n8 C layout
// of two adjacent column tiles is the m16k16 A layout).  The image->token
// update is per head: one m16n8k16 gives a head's scores of 16 rows against
// the (up to 8) tokens, the softmax runs over the four lanes that hold a
// row, and the probabilities feed a rank-64 product with the token values
// already folded through the out-projection.  Weights stream through
// shared memory in chunks of 32 output columns, double-buffered with
// cp.async, stored [n][k] (a Linear's own layout) with padded rows so that
// the ldmatrix reads of the B fragments meet no bank conflicts.
//
// Each token->image softmax spans all rows: a block writes the max, the sum
// and the (56, 16) partial of P.V of its tile (scores and P.V on the tensor
// cores, the exponentials rounded to bf16 as their operand), and the next
// token phase merges the tiles in index order (no atomics: a run repeats
// bit for bit).
//
// The token side (T x 256 per prompt) rides inside these launches, one block
// per prompt: its dense layers take the tokens as rows 0..7 of an m16 tile
// and read the weights from device memory straight into B fragments; its
// softmaxes and LayerNorms are plain SIMT.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int C = 256;        // embedding width
constexpr int CD = 128;       // cross-attention width
constexpr int H = 8;          // heads
constexpr int HD = 16;        // cross-attention head dim
constexpr int HD2 = 32;       // self-attention head dim
constexpr int TP = 8;         // tokens, padded
constexpr int HT = H * TP;    // stacked (head, token) axis
constexpr int TM = 64;        // rows per block in the row phases
constexpr int WCH = 32;       // weight chunk: output columns per step
constexpr int WLD = C + 8;    // shared row strides (bf16 elements)
constexpr int ULD = HT + 8;
constexpr int KLD = CD + 8;
constexpr int VLD = TM + 8;   // transposed v tile / exp tile stride
constexpr int PW = 2 + HD;    // floats per partial row: max, sum, P.V
constexpr float EPS = 1e-5f;
constexpr float SCALE = 0.25f;               // 1 / sqrt(HD)
constexpr float SCALE2 = 0.17677669529663687f;  // 1 / sqrt(HD2)
constexpr int TOK_THREADS = 512;
constexpr int LDT = C + 8;    // token buffers' row stride (floats)

// Order of `PARAM_NAMES` in models/decode_tail_kernel.py.
enum Param {
  kpe2, qpe2i, kpef, wide2, widef, bv2, bvf,
  t2i_q_w, t2i_q_b, t2i_o_w, t2i_o_b,
  n2_w, n2_b, n3_w, n3_b, n4_w, n4_b, nf_w, nf_b,
  mlp1_w, mlp1_b, mlp2_w, mlp2_b,
  i2t_k_w, i2t_k_b, i2t_v_w, i2t_v_b, i2t_o_w, i2t_o_b,
  fin_q_w, fin_q_b, fin_o_w, fin_o_b,
  i2t1_k_w, i2t1_k_b, i2t1_v_w, i2t1_v_b, i2t1_o_w, i2t1_o_b,
  n4l0_w, n4l0_b,
  l0sa_q_w, l0sa_q_b, l0sa_k_w, l0sa_k_b, l0sa_v_w, l0sa_v_b,
  l0sa_o_w, l0sa_o_b, n1l0_w, n1l0_b,
  t2i1_q_w, t2i1_q_b, t2i1_o_w, t2i1_o_b, n2l0_w, n2l0_b,
  mlp1l0_w, mlp1l0_b, mlp2l0_w, mlp2l0_b, n3l0_w, n3l0_b,
  l1sa_q_w, l1sa_q_b, l1sa_k_w, l1sa_k_b, l1sa_v_w, l1sa_v_b,
  l1sa_o_w, l1sa_o_b, n1l1_w, n1l1_b,
  N_PARAMS
};

struct Args {
  const bf16* keys0;
  const bf16* q1i;
  const bf16* k1;
  const bf16* v1;
  const bf16* tokens;   // (P, T, C)
  bf16* keys2;          // (P, M, C)
  bf16* tok_out;        // (P, T, C)
  float* tok_state;     // (P, TP, C)
  float* qh;            // (P, TP, CD)
  bf16* ktok[2];        // (P, TP, CD) token keys of update 1 / 2
  bf16* ut[2];          // (P, C, HT) folded token values, transposed
  float* part;          // (P, NT, HT, PW)
  int T, M, NT, mlp;
  const void* w[N_PARAMS];
};

__device__ __forceinline__ const bf16* wb(const Args& a, int i) {
  return static_cast<const bf16*>(a.w[i]);
}
__device__ __forceinline__ const float* wf(const Args& a, int i) {
  return static_cast<const float*>(a.w[i]);
}

__device__ __forceinline__ float rnd(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&u);
  return __bfloat1622float2(v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

// ===========================================================================
// token phases: one block per prompt
// ===========================================================================

// out[t][n] = rnd(rnd(in[t]) . W[n] + b[n]) (ReLU optional) for t < T, on
// the tensor cores: the (up to 8) tokens are rows 0..7 of an m16n8k16 A
// tile (rows 8..15 zero), the weight rows [n][k] are read straight from
// device memory as B fragments.  A warp takes NT column tiles of 8 per
// pass.  N is a multiple of 8 NT, K of 16; `in` has 8 rows.
template <int NT>
__device__ void dense_tok(float* out, int ldo, const float* in, int ldi,
                          const bf16* W, const float* b, int N, int K, int T,
                          bool relu) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const float* xrow = in + g * ldi + 2 * t4;
  for (int n0 = warp * 8 * NT; n0 < N; n0 += nw * 8 * NT) {
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    const bf16* wrow = W + (size_t)(n0 + g) * K + 2 * t4;
#pragma unroll 8
    for (int k = 0; k < K; k += 16) {
      const float2 x0 = *reinterpret_cast<const float2*>(xrow + k);
      const float2 x1 = *reinterpret_cast<const float2*>(xrow + k + 8);
      uint32_t xa[4];
      xa[0] = pack_bf16(x0.x, x0.y);
      xa[1] = 0u;
      xa[2] = pack_bf16(x1.x, x1.y);
      xa[3] = 0u;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const bf16* wp = wrow + (size_t)j * 8 * K + k;
        mma_bf16(acc[j], xa, ld32(wp), ld32(wp + 8));
      }
    }
    if (g < T) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + j * 8 + 2 * t4;
        float v0 = acc[j][0] + b[n], v1 = acc[j][1] + b[n + 1];
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        out[g * ldo + n] = rnd(v0);
        out[g * ldo + n + 1] = rnd(v1);
      }
    }
  }
}

// out[t] = rnd(LN(rnd(x[t] + res[t])) * w + b) over C columns; a warp per
// token.  res may be null; out may alias x or res.  Rows have stride LDT.
__device__ void ln_tok(float* out, const float* x, const float* res,
                       const float* w, const float* b, int T) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  for (int t = warp; t < T; t += nw) {
    float v[C / 32];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < C / 32; ++i) {
      const int c = lane + 32 * i;
      float y = x[t * LDT + c];
      if (res != nullptr) y += res[t * LDT + c];
      v[i] = rnd(y);
      sum += v[i];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float mean = sum * (1.f / C);
    float var = 0.f;
#pragma unroll
    for (int i = 0; i < C / 32; ++i) var += (v[i] - mean) * (v[i] - mean);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      var += __shfl_xor_sync(0xffffffffu, var, off);
    const float rstd = rsqrtf(var * (1.f / C) + EPS);
#pragma unroll
    for (int i = 0; i < C / 32; ++i) {
      const int c = lane + 32 * i;
      out[t * LDT + c] = rnd((v[i] - mean) * rstd * w[c] + b[c]);
    }
  }
}

// Token self-attention over T tokens, 8 heads of 32: out[t][h*32+d] =
// rnd(sum_s softmax_s(q[t,h] . k[s,h] * scale) v[s][h*32+d]).
__device__ void self_attn_tok(float* out, const float* q, const float* k,
                              const float* v, int T) {
  for (int i = threadIdx.x; i < H * T; i += blockDim.x) {
    const int h = i / T, t = i % T;
    float s[TP];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < TP; ++j) {
      s[j] = -INFINITY;
      if (j < T) {
        float dot = 0.f;
        for (int d = 0; d < HD2; ++d)
          dot += q[t * LDT + h * HD2 + d] * k[j * LDT + h * HD2 + d];
        s[j] = dot * SCALE2;
        mx = fmaxf(mx, s[j]);
      }
    }
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < TP; ++j) {
      s[j] = j < T ? __expf(s[j] - mx) : 0.f;
      l += s[j];
    }
    const float inv = 1.f / l;
    for (int d = 0; d < HD2; ++d) {
      float o = 0.f;
#pragma unroll
      for (int j = 0; j < TP; ++j)
        if (j < T) o += s[j] * v[j * LDT + h * HD2 + d];
      out[t * LDT + h * HD2 + d] = rnd(o * inv);
    }
  }
}

// Merge the row tiles' partial softmaxes of one prompt, in tile order:
// out[t][h*16+d] = rnd(sum_j w_j acc_j / sum_j w_j l_j), w_j = exp(m_j - max).
__device__ void merge_partials(float* out, const float* part, int NT, int T) {
  for (int idx = threadIdx.x; idx < HT * HD; idx += blockDim.x) {
    const int c = idx / HD, d = idx % HD;
    const int h = c / TP, t = c % TP;
    if (t >= T) continue;
    float mx = -INFINITY;
#pragma unroll 8
    for (int j = 0; j < NT; ++j)
      mx = fmaxf(mx, part[((size_t)j * HT + c) * PW]);
    float l = 0.f, acc = 0.f;
#pragma unroll 8
    for (int j = 0; j < NT; ++j) {
      const float* pr = part + ((size_t)j * HT + c) * PW;
      const float w = __expf(pr[0] - mx);
      l += w * pr[1];
      acc += w * pr[2 + d];
    }
    out[t * LDT + h * HD + d] = rnd(acc / l);
  }
}

// Parameter indices of one middle token phase (after block 1 / block 2).
struct MidNames {
  int o_w, o_b, n2w, n2b, m1w, m1b, m2w, m2b, n3w, n3b;
  int kw, kb, vw, vb, uw, qw, qb;
};

__global__ void __launch_bounds__(TOK_THREADS) tok_phase(const Args a,
                                                         const int stage) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* s_pe = reinterpret_cast<float*>(smem_raw);
  float* s_q = s_pe + TP * LDT;         // (TP, LDT) each: rows padded so
  float* s_a = s_q + TP * LDT;          // that the 8 rows an A fragment
  float* s_b = s_a + TP * LDT;          // reads sit on distinct banks
  float* s_c = s_b + TP * LDT;
  float* s_d = s_c + TP * LDT;
  float* s_h = s_d + TP * LDT;          // (TP, mlp + 8)
  const int ldh = a.mlp + 8;
  const int p = blockIdx.x, tid = threadIdx.x, nthr = blockDim.x;
  const int T = a.T;
  float* state = a.tok_state + (size_t)p * TP * C;
  float* qh_out = a.qh + (size_t)p * TP * CD;

  for (int i = tid; i < TP * C; i += nthr) {
    const int t = i / C, c = i % C;
    s_pe[t * LDT + c] =
        t < T ? __bfloat162float(a.tokens[((size_t)p * T + t) * C + c]) : 0.f;
    s_q[t * LDT + c] = stage > 0 ? state[i] : 0.f;
  }
  __syncthreads();

  if (stage == 0) {
    // block 1: self-attention without PE and without residual, LN, then the
    // query heads of the token->image attention.
    dense_tok<2>(s_a, LDT, s_pe, LDT, wb(a, l0sa_q_w), wf(a, l0sa_q_b), C, C, T,
              false);
    dense_tok<2>(s_b, LDT, s_pe, LDT, wb(a, l0sa_k_w), wf(a, l0sa_k_b), C, C, T,
              false);
    dense_tok<2>(s_c, LDT, s_pe, LDT, wb(a, l0sa_v_w), wf(a, l0sa_v_b), C, C, T,
              false);
    __syncthreads();
    self_attn_tok(s_d, s_a, s_b, s_c, T);
    __syncthreads();
    dense_tok<2>(s_a, LDT, s_d, LDT, wb(a, l0sa_o_w), wf(a, l0sa_o_b), C, C, T,
              false);
    __syncthreads();
    ln_tok(s_q, s_a, nullptr, wf(a, n1l0_w), wf(a, n1l0_b), T);
    __syncthreads();
    for (int i = tid; i < TP * LDT; i += nthr) s_a[i] = s_q[i] + s_pe[i];
    __syncthreads();
    dense_tok<1>(s_b, CD, s_a, LDT, wb(a, t2i1_q_w), wf(a, t2i1_q_b), CD, C, T,
              false);
    __syncthreads();
    for (int i = tid; i < TP * CD; i += nthr)
      qh_out[i] = i / CD < T ? s_b[i] : 0.f;
    for (int i = tid; i < TP * C; i += nthr)
    state[i] = s_q[(i / C) * LDT + i % C];
    return;
  }

  const MidNames nm =
      stage == 1
          ? MidNames{t2i1_o_w, t2i1_o_b, n2l0_w, n2l0_b, mlp1l0_w, mlp1l0_b,
                     mlp2l0_w, mlp2l0_b, n3l0_w, n3l0_b, i2t1_k_w, i2t1_k_b,
                     i2t1_v_w, i2t1_v_b, i2t1_o_w, t2i_q_w, t2i_q_b}
          : stage == 2
                ? MidNames{t2i_o_w, t2i_o_b, n2_w, n2_b, mlp1_w, mlp1_b,
                           mlp2_w, mlp2_b, n3_w, n3_b, i2t_k_w, i2t_k_b,
                           i2t_v_w, i2t_v_b, i2t_o_w, fin_q_w, fin_q_b}
                : MidNames{fin_o_w, fin_o_b, nf_w, nf_b, 0, 0, 0, 0, 0, 0, 0,
                           0, 0, 0, 0, 0, 0};

  // token->image attention: merge the tiles, out-projection, residual + LN.
  merge_partials(s_a, a.part + (size_t)p * a.NT * HT * PW, a.NT, T);
  __syncthreads();
  dense_tok<2>(s_b, LDT, s_a, LDT, wb(a, nm.o_w), wf(a, nm.o_b), C, CD, T,
               false);
  __syncthreads();
  ln_tok(s_q, s_q, s_b, wf(a, nm.n2w), wf(a, nm.n2b), T);
  __syncthreads();
  if (stage == 3) {
    for (int i = tid; i < T * C; i += nthr)
      a.tok_out[(size_t)p * T * C + i] =
          __float2bfloat16(s_q[(i / C) * LDT + i % C]);
    return;
  }

  // MLP, residual + LN.
  dense_tok<8>(s_h, ldh, s_q, LDT, wb(a, nm.m1w), wf(a, nm.m1b), a.mlp, C, T,
            true);
  __syncthreads();
  dense_tok<2>(s_b, LDT, s_h, ldh, wb(a, nm.m2w), wf(a, nm.m2b), C, a.mlp, T,
            false);
  __syncthreads();
  ln_tok(s_q, s_q, s_b, wf(a, nm.n3w), wf(a, nm.n3b), T);
  __syncthreads();

  // The image->token update's token side: keys from tokens + PE, values
  // folded through the out-projection, head by head:
  // ut[c][h*TP+t] = rnd(sum_d v[t][h*16+d] Wo[c][h*16+d]).
  for (int i = tid; i < TP * LDT; i += nthr) s_a[i] = s_q[i] + s_pe[i];
  __syncthreads();
  dense_tok<1>(s_b, CD, s_a, LDT, wb(a, nm.kw), wf(a, nm.kb), CD, C, T, false);
  dense_tok<1>(s_c, CD, s_q, LDT, wb(a, nm.vw), wf(a, nm.vb), CD, C, T, false);
  __syncthreads();
  {
    bf16* ktok = a.ktok[stage - 1] + (size_t)p * TP * CD;
    for (int i = tid; i < TP * CD; i += nthr)
      ktok[i] = __float2bfloat16(i / CD < T ? s_b[i] : 0.f);
    // A thread takes one (column c, head h): its 16 out-projection weights
    // against the head's slice of every token's value, 8 results at once.
    bf16* ut = a.ut[stage - 1] + (size_t)p * C * HT;
    const bf16* wo = wb(a, nm.uw);
    for (int i = tid; i < C * H; i += nthr) {
      const int c = i / H, h = i % H;
      float w[HD];
#pragma unroll
      for (int d = 0; d < HD; d += 2) {
        const float2 wv = unpack_bf16(ld32(wo + c * CD + h * HD + d));
        w[d] = wv.x;
        w[d + 1] = wv.y;
      }
      float u[TP];
#pragma unroll
      for (int t = 0; t < TP; ++t) {
        u[t] = 0.f;
        if (t < T) {
#pragma unroll
          for (int d = 0; d < HD; ++d) u[t] += s_c[t * CD + h * HD + d] * w[d];
        }
      }
      uint4 o;
      o.x = pack_bf16(u[0], u[1]);
      o.y = pack_bf16(u[2], u[3]);
      o.z = pack_bf16(u[4], u[5]);
      o.w = pack_bf16(u[6], u[7]);
      *reinterpret_cast<uint4*>(ut + c * HT + h * TP) = o;
    }
  }
  __syncthreads();

  if (stage == 1) {
    // block 2: self-attention on tokens + PE, residual + LN.
    dense_tok<2>(s_b, LDT, s_a, LDT, wb(a, l1sa_q_w), wf(a, l1sa_q_b), C, C, T,
              false);
    dense_tok<2>(s_c, LDT, s_a, LDT, wb(a, l1sa_k_w), wf(a, l1sa_k_b), C, C, T,
              false);
    dense_tok<2>(s_d, LDT, s_q, LDT, wb(a, l1sa_v_w), wf(a, l1sa_v_b), C, C, T,
              false);
    __syncthreads();
    self_attn_tok(s_a, s_b, s_c, s_d, T);
    __syncthreads();
    dense_tok<2>(s_b, LDT, s_a, LDT, wb(a, l1sa_o_w), wf(a, l1sa_o_b), C, C, T,
              false);
    __syncthreads();
    ln_tok(s_q, s_q, s_b, wf(a, n1l1_w), wf(a, n1l1_b), T);
    __syncthreads();
    for (int i = tid; i < TP * LDT; i += nthr) s_a[i] = s_q[i] + s_pe[i];
    __syncthreads();
  }

  // Query heads of the next token->image attention.
  dense_tok<1>(s_b, CD, s_a, LDT, wb(a, nm.qw), wf(a, nm.qb), CD, C, T, false);
  __syncthreads();
  for (int i = tid; i < TP * CD; i += nthr)
    qh_out[i] = i / CD < T ? s_b[i] : 0.f;
  for (int i = tid; i < TP * C; i += nthr)
    state[i] = s_q[(i / C) * LDT + i % C];
}

// ===========================================================================
// row phases: one block of four warps per (row tile, prompt)
// ===========================================================================

constexpr int ROW_SMEM = 2 * WCH * WLD * 2   // weight chunks
                         + C * ULD * 2       // ut, later the exp tile
                         + 2 * TP * KLD * 2  // token keys, query heads
                         + TM * KLD * 2      // k tile [row][c]
                         + CD * VLD * 2;     // v tile, transposed [c][row]

// Scores of the warp's 16 rows against the tokens, head by head, from an
// image-side q in device memory: sc[h] is the m16n8 C tile (rows g / g+8,
// tokens 2*t4, 2*t4+1).
__device__ __forceinline__ void scores_global(float (&sc)[H][4],
                                              const bf16* q0, const bf16* q1,
                                              const bf16* ktok, int g,
                                              int t4) {
#pragma unroll
  for (int h = 0; h < H; ++h) {
    uint32_t qa[4];
    qa[0] = ld32(q0 + h * HD + 2 * t4);
    qa[1] = ld32(q1 + h * HD + 2 * t4);
    qa[2] = ld32(q0 + h * HD + 2 * t4 + 8);
    qa[3] = ld32(q1 + h * HD + 2 * t4 + 8);
    const bf16* kp = ktok + g * KLD + h * HD + 2 * t4;
    sc[h][0] = sc[h][1] = sc[h][2] = sc[h][3] = 0.f;
    mma_bf16(sc[h], qa, ld32(kp), ld32(kp + 8));
  }
}

// x <- rnd(LN(rnd(x + rnd(P U) + ob)) * lnw + lnb) on the warp's 16 rows
// held as A fragments: P = per-head softmax of the scores over the T
// tokens, U^T in shared memory ([c][h*TP+t]).
__device__ __forceinline__ void image_update(uint32_t (&xa)[C / 16][4],
                                             float (&sc)[H][4],
                                             const bf16* ut, const float* ob,
                                             const float* lnw,
                                             const float* lnb, int T, int g,
                                             int t4) {
  const int lm_r = (g * 4 + t4) & 7, lm_i = (g * 4 + t4) >> 3;  // ldmatrix
  uint32_t pa[HT / 16][4];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const bool ok0 = 2 * t4 < T, ok1 = 2 * t4 + 1 < T;
    float a0 = ok0 ? sc[h][0] * SCALE : -INFINITY;
    float a1 = ok1 ? sc[h][1] * SCALE : -INFINITY;
    float b0 = ok0 ? sc[h][2] * SCALE : -INFINITY;
    float b1 = ok1 ? sc[h][3] * SCALE : -INFINITY;
    float ma = fmaxf(a0, a1), mb = fmaxf(b0, b1);
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, off));
      mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off));
    }
    a0 = __expf(a0 - ma);
    a1 = __expf(a1 - ma);
    b0 = __expf(b0 - mb);
    b1 = __expf(b1 - mb);
    float la = a0 + a1, lb = b0 + b1;
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      la += __shfl_xor_sync(0xffffffffu, la, off);
      lb += __shfl_xor_sync(0xffffffffu, lb, off);
    }
    const float ia = 1.f / la, ib = 1.f / lb;
    pa[h >> 1][(h & 1) * 2] = pack_bf16(a0 * ia, a1 * ia);
    pa[h >> 1][(h & 1) * 2 + 1] = pack_bf16(b0 * ib, b1 * ib);
  }

  // delta = P U in quarters of 64 columns, folded into x in place.
#pragma unroll
  for (int qd = 0; qd < 4; ++qd) {
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int k2 = 0; k2 < HT / 32; ++k2) {
        uint32_t b[4];
        ldsm_x4(b, ut + ((qd * 8 + j) * 8 + lm_r) * ULD + k2 * 32 + lm_i * 8);
        mma_bf16(acc[j], pa[2 * k2], b[0], b[1]);
        mma_bf16(acc[j], pa[2 * k2 + 1], b[2], b[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int nt = qd * 8 + j;
      const float2 o = *reinterpret_cast<const float2*>(ob + nt * 8 + 2 * t4);
      const int kx = nt >> 1, ix = (nt & 1) * 2;
      const float2 x0 = unpack_bf16(xa[kx][ix]);
      const float2 x1 = unpack_bf16(xa[kx][ix + 1]);
      xa[kx][ix] = pack_bf16(x0.x + rnd(acc[j][0]) + o.x,
                             x0.y + rnd(acc[j][1]) + o.y);
      xa[kx][ix + 1] = pack_bf16(x1.x + rnd(acc[j][2]) + o.x,
                                 x1.y + rnd(acc[j][3]) + o.y);
    }
  }

  // LayerNorm over the 256 columns of rows g and g + 8 (four lanes a row).
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float2 x0 = unpack_bf16(xa[kk][hf * 2]);
      const float2 x1 = unpack_bf16(xa[kk][hf * 2 + 1]);
      s0 += x0.x + x0.y;
      s1 += x1.x + x1.y;
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, off);
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
  }
  const float mean0 = s0 * (1.f / C), mean1 = s1 * (1.f / C);
  float v0 = 0.f, v1 = 0.f;
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float2 x0 = unpack_bf16(xa[kk][hf * 2]);
      const float2 x1 = unpack_bf16(xa[kk][hf * 2 + 1]);
      v0 += (x0.x - mean0) * (x0.x - mean0) + (x0.y - mean0) * (x0.y - mean0);
      v1 += (x1.x - mean1) * (x1.x - mean1) + (x1.y - mean1) * (x1.y - mean1);
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    v0 += __shfl_xor_sync(0xffffffffu, v0, off);
    v1 += __shfl_xor_sync(0xffffffffu, v1, off);
  }
  const float r0 = rsqrtf(v0 * (1.f / C) + EPS);
  const float r1 = rsqrtf(v1 * (1.f / C) + EPS);
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int col = kk * 16 + hf * 8 + 2 * t4;
      const float2 w = *reinterpret_cast<const float2*>(lnw + col);
      const float2 b = *reinterpret_cast<const float2*>(lnb + col);
      const float2 x0 = unpack_bf16(xa[kk][hf * 2]);
      const float2 x1 = unpack_bf16(xa[kk][hf * 2 + 1]);
      xa[kk][hf * 2] = pack_bf16((x0.x - mean0) * r0 * w.x + b.x,
                                 (x0.y - mean0) * r0 * w.y + b.y);
      xa[kk][hf * 2 + 1] = pack_bf16((x1.x - mean1) * r1 * w.x + b.x,
                                     (x1.y - mean1) * r1 * w.y + b.y);
    }
  }
}

// acc (16 rows x 32 columns) = x (A fragments, K = 256) @ chunk^T, the
// chunk stored [n][k] in shared memory.
__device__ __forceinline__ void gemm_chunk(float (&acc)[WCH / 8][4],
                                           const uint32_t (&xa)[C / 16][4],
                                           const bf16* wchunk, int g,
                                           int t4) {
  const int lm_r = (g * 4 + t4) & 7, lm_i = (g * 4 + t4) >> 3;  // ldmatrix
#pragma unroll
  for (int j = 0; j < WCH / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int k2 = 0; k2 < C / 32; ++k2) {
#pragma unroll
    for (int j = 0; j < WCH / 8; ++j) {
      uint32_t b[4];
      ldsm_x4(b, wchunk + (j * 8 + lm_r) * WLD + k2 * 32 + lm_i * 8);
      mma_bf16(acc[j], xa[2 * k2], b[0], b[1]);
      mma_bf16(acc[j], xa[2 * k2 + 1], b[2], b[3]);
    }
  }
}

// STAGE 0: partial softmax over the shared k1/v1.  STAGE 1: keys1, k2/v2,
// partial softmax of block 2.  STAGE 2: keys1, q2i, keys2 (written), kf/vf,
// partial softmax of the final attention.
template <int STAGE>
__global__ void __launch_bounds__(128) row_phase(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* wbuf = reinterpret_cast<bf16*>(smem_raw);
  bf16* ut = wbuf + 2 * WCH * WLD;
  bf16* et = ut;                                // after the last update:
  float* redm = reinterpret_cast<float*>(et + HT * VLD);   // exp tile and
  float* redl = redm + 4 * HT;                  // the warps' maxes and sums
  bf16* ktok = ut + C * ULD;
  bf16* qhb = ktok + TP * KLD;
  bf16* ktile = qhb + TP * KLD;
  bf16* vt = ktile + TM * KLD;

  const int tile = blockIdx.x, p = blockIdx.y;
  const int m0 = tile * TM, T = a.T;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int lr0 = warp * 16 + g, lr1 = lr0 + 8;   // block-local rows
  const size_t r0 = (size_t)m0 + lr0, r1 = r0 + 8;

  // The query heads (bf16 values, kept in f32 between the phases).
  for (int i = tid; i < TP * CD; i += 128)
    qhb[(i / CD) * KLD + i % CD] =
        __float2bfloat16(a.qh[(size_t)p * TP * CD + i]);

  if constexpr (STAGE == 0) {
    for (int e = tid; e < TM * (CD / 8); e += 128) {
      const int r = e / (CD / 8), part = e % (CD / 8);
      const size_t src = ((size_t)m0 + r) * CD + part * 8;
      *reinterpret_cast<uint4*>(ktile + r * KLD + part * 8) =
          *reinterpret_cast<const uint4*>(a.k1 + src);
      const uint4 v = *reinterpret_cast<const uint4*>(a.v1 + src);
      const bf16* ve = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i) vt[(part * 8 + i) * VLD + r] = ve[i];
    }
  } else {
    // The weight chunks of this phase, in order: (STAGE 2) wide2's q rows,
    // then the k and v rows of wide2 (STAGE 1) or widef (STAGE 2).
    constexpr int NQ = STAGE == 2 ? CD / WCH : 0;
    constexpr int NKV = 2 * CD / WCH;
    auto prefetch = [&](int ci) {
      const bf16* src =
          STAGE == 1 ? wb(a, wide2) + (size_t)ci * WCH * C
                     : (ci < NQ ? wb(a, wide2) + (size_t)(2 * CD + ci * WCH) * C
                                : wb(a, widef) + (size_t)(ci - NQ) * WCH * C);
      bf16* dst = wbuf + (ci & 1) * WCH * WLD;
#pragma unroll
      for (int it = 0; it < WCH * (C / 8) / 128; ++it) {
        const int e = it * 128 + tid;
        const int r = e / (C / 8), part = e % (C / 8);
        cp_async16(dst + r * WLD + part * 8, src + r * C + part * 8);
      }
      cp_async_commit();
    };
    auto load_update = [&](int which) {
      const bf16* usrc = a.ut[which] + (size_t)p * C * HT;
      for (int e = tid; e < C * (HT / 8); e += 128) {
        const int c = e / (HT / 8), part = e % (HT / 8);
        *reinterpret_cast<uint4*>(ut + c * ULD + part * 8) =
            *reinterpret_cast<const uint4*>(usrc + c * HT + part * 8);
      }
      const bf16* ksrc = a.ktok[which] + (size_t)p * TP * CD;
      for (int e = tid; e < TP * (CD / 8); e += 128) {
        const int t = e / (CD / 8), part = e % (CD / 8);
        *reinterpret_cast<uint4*>(ktok + t * KLD + part * 8) =
            *reinterpret_cast<const uint4*>(ksrc + t * CD + part * 8);
      }
    };

    prefetch(0);
    load_update(0);
    // The updates' out-projection bias and LayerNorm parameters, staged in
    // the k tile's space (free until the k/v products): a load from device
    // memory inside the register-bound update would wait out its latency.
    float* pst = reinterpret_cast<float*>(ktile);       // [6][C]
    for (int i = tid; i < C; i += 128) {
      pst[i] = wf(a, i2t1_o_b)[i];
      pst[C + i] = wf(a, n4l0_w)[i];
      pst[2 * C + i] = wf(a, n4l0_b)[i];
      if (STAGE == 2) {
        pst[3 * C + i] = wf(a, i2t_o_b)[i];
        pst[4 * C + i] = wf(a, n4_w)[i];
        pst[5 * C + i] = wf(a, n4_b)[i];
      }
    }
    uint32_t xa[C / 16][4];
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) {
      const int col = kk * 16 + 2 * t4;
      xa[kk][0] = ld32(a.keys0 + r0 * C + col);
      xa[kk][1] = ld32(a.keys0 + r1 * C + col);
      xa[kk][2] = ld32(a.keys0 + r0 * C + col + 8);
      xa[kk][3] = ld32(a.keys0 + r1 * C + col + 8);
    }
    __syncthreads();
    float sc[H][4];
    scores_global(sc, a.q1i + r0 * CD, a.q1i + r1 * CD, ktok, g, t4);
    image_update(xa, sc, ut, pst, pst + C, pst + 2 * C, T, g, t4);
    // xa = keys1

    float acc[WCH / 8][4];
    if constexpr (STAGE == 2) {
      __syncthreads();          // every warp is done with update 1's tokens
      load_update(1);
      const bf16* qpe = wb(a, qpe2i);
#pragma unroll
      for (int ci = 0; ci < NQ; ++ci) {
        cp_async_wait_all();
        __syncthreads();
        prefetch(ci + 1);
        // The PE-side terms of this chunk's columns load during the product.
        uint32_t pe0[WCH / 8], pe1[WCH / 8];
#pragma unroll
        for (int j = 0; j < WCH / 8; ++j) {
          pe0[j] = ld32(qpe + r0 * CD + ci * WCH + j * 8 + 2 * t4);
          pe1[j] = ld32(qpe + r1 * CD + ci * WCH + j * 8 + 2 * t4);
        }
        gemm_chunk(acc, xa, wbuf + (ci & 1) * WCH * WLD, g, t4);
        // q2i of two heads, straight into their scores against update 2's
        // token keys.
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          uint32_t qa[4];
#pragma unroll
          for (int o = 0; o < 2; ++o) {
            const int j = 2 * hh + o;
            const float2 e0 = unpack_bf16(pe0[j]);
            const float2 e1 = unpack_bf16(pe1[j]);
            qa[2 * o] = pack_bf16(acc[j][0] + e0.x, acc[j][1] + e0.y);
            qa[2 * o + 1] = pack_bf16(acc[j][2] + e1.x, acc[j][3] + e1.y);
          }
          const int h = 2 * ci + hh;
          const bf16* kp = ktok + g * KLD + h * HD + 2 * t4;
          sc[h][0] = sc[h][1] = sc[h][2] = sc[h][3] = 0.f;
          mma_bf16(sc[h], qa, ld32(kp), ld32(kp + 8));
        }
      }
      image_update(xa, sc, ut, pst + 3 * C, pst + 4 * C, pst + 5 * C, T, g,
                   t4);                                // xa = keys2
      bf16* out = a.keys2 + (size_t)p * a.M * C;
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk) {
        const int col = kk * 16 + 2 * t4;
        *reinterpret_cast<uint32_t*>(out + r0 * C + col) = xa[kk][0];
        *reinterpret_cast<uint32_t*>(out + r1 * C + col) = xa[kk][1];
        *reinterpret_cast<uint32_t*>(out + r0 * C + col + 8) = xa[kk][2];
        *reinterpret_cast<uint32_t*>(out + r1 * C + col + 8) = xa[kk][3];
      }
    }

    const bf16* kpe = wb(a, STAGE == 1 ? kpe2 : kpef);
    const float* bv = wf(a, STAGE == 1 ? bv2 : bvf);
#pragma unroll 1
    for (int ci = 0; ci < NKV; ++ci) {
      cp_async_wait_all();
      __syncthreads();
      if (ci + 1 < NKV) prefetch(NQ + ci + 1);
      const bool is_k = ci < NKV / 2;
      // The PE-side terms (k) or the bias (v) of this chunk's columns load
      // during the product.
      uint32_t pe0[WCH / 8], pe1[WCH / 8];
      float2 bvv[WCH / 8];
#pragma unroll
      for (int j = 0; j < WCH / 8; ++j) {
        const int col = (ci % (NKV / 2)) * WCH + j * 8 + 2 * t4;
        if (is_k) {
          pe0[j] = ld32(kpe + r0 * CD + col);
          pe1[j] = ld32(kpe + r1 * CD + col);
        } else {
          bvv[j] = *reinterpret_cast<const float2*>(bv + col);
        }
      }
      gemm_chunk(acc, xa, wbuf + ((NQ + ci) & 1) * WCH * WLD, g, t4);
#pragma unroll
      for (int j = 0; j < WCH / 8; ++j) {
        const int col = (ci % (NKV / 2)) * WCH + j * 8 + 2 * t4;
        if (is_k) {
          const float2 e0 = unpack_bf16(pe0[j]);
          const float2 e1 = unpack_bf16(pe1[j]);
          *reinterpret_cast<uint32_t*>(ktile + lr0 * KLD + col) =
              pack_bf16(acc[j][0] + e0.x, acc[j][1] + e0.y);
          *reinterpret_cast<uint32_t*>(ktile + lr1 * KLD + col) =
              pack_bf16(acc[j][2] + e1.x, acc[j][3] + e1.y);
        } else {
          const float2 e = bvv[j];
          vt[col * VLD + lr0] = __float2bfloat16(acc[j][0] + e.x);
          vt[(col + 1) * VLD + lr0] = __float2bfloat16(acc[j][1] + e.y);
          vt[col * VLD + lr1] = __float2bfloat16(acc[j][2] + e.x);
          vt[(col + 1) * VLD + lr1] = __float2bfloat16(acc[j][3] + e.y);
        }
      }
    }
  }
  __syncthreads();

  // Partial token->image softmax of this tile, all heads.  Scores of the
  // warp's 16 rows per head on the tensor cores; the tile's max and sum per
  // (head, token) through the warps' partials; the exponentials, rounded to
  // bf16, transposed through shared memory into the B operand of
  // (P.V)^T = V^T E, two heads a warp.
  float sc[H][4];
  scores_global(sc, ktile + lr0 * KLD, ktile + lr1 * KLD, qhb, g, t4);
#pragma unroll
  for (int h = 0; h < H; ++h) {
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[h][i] *= SCALE;
    float m0 = fmaxf(sc[h][0], sc[h][2]), m1 = fmaxf(sc[h][1], sc[h][3]);
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
    }
    if (g == 0) {
      redm[warp * HT + h * TP + 2 * t4] = m0;
      redm[warp * HT + h * TP + 2 * t4 + 1] = m1;
    }
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int c0 = h * TP + 2 * t4;
    float m0 = redm[c0], m1 = redm[c0 + 1];
#pragma unroll
    for (int w = 1; w < 4; ++w) {
      m0 = fmaxf(m0, redm[w * HT + c0]);
      m1 = fmaxf(m1, redm[w * HT + c0 + 1]);
    }
    const bf16 e00 = __float2bfloat16(__expf(sc[h][0] - m0));
    const bf16 e01 = __float2bfloat16(__expf(sc[h][1] - m1));
    const bf16 e10 = __float2bfloat16(__expf(sc[h][2] - m0));
    const bf16 e11 = __float2bfloat16(__expf(sc[h][3] - m1));
    et[c0 * VLD + lr0] = e00;
    et[(c0 + 1) * VLD + lr0] = e01;
    et[c0 * VLD + lr1] = e10;
    et[(c0 + 1) * VLD + lr1] = e11;
    float l0 = __bfloat162float(e00) + __bfloat162float(e10);
    float l1 = __bfloat162float(e01) + __bfloat162float(e11);
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    if (g == 0) {
      redl[warp * HT + c0] = l0;
      redl[warp * HT + c0 + 1] = l1;
    }
  }
  __syncthreads();
  float* part = a.part + ((size_t)p * a.NT + tile) * HT * PW;
  if (tid < HT && (tid % TP) < T) {
    float mx = redm[tid], l = redl[tid];
#pragma unroll
    for (int w = 1; w < 4; ++w) {
      mx = fmaxf(mx, redm[w * HT + tid]);
      l += redl[w * HT + tid];
    }
    part[tid * PW] = mx;
    part[tid * PW + 1] = l;
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int h = 2 * warp + hh;
    float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < TM / 16; ++kk) {
      const bf16* v0 = vt + (h * HD + g) * VLD + kk * 16 + 2 * t4;
      const bf16* v1 = v0 + 8 * VLD;
      uint32_t va[4];
      va[0] = ld32(v0);
      va[1] = ld32(v1);
      va[2] = ld32(v0 + 8);
      va[3] = ld32(v1 + 8);
      const bf16* ep = et + (h * TP + g) * VLD + kk * 16 + 2 * t4;
      mma_bf16(o, va, ld32(ep), ld32(ep + 8));
    }
    // o: head dims g and g + 8 against tokens 2*t4 and 2*t4 + 1.
    float* pr = part + (h * TP + 2 * t4) * PW + 2;
    if (2 * t4 < T) {
      pr[g] = o[0];
      pr[g + 8] = o[2];
    }
    if (2 * t4 + 1 < T) {
      pr[PW + g] = o[1];
      pr[PW + g + 8] = o[3];
    }
  }
}

}  // namespace

// params: host array of N_PARAMS device pointers in the order of enum Param.
// All tensors contiguous; bf16 unless noted.  Scratch (allocated by the
// caller): tok_state (P, 8, 256) f32, qh (P, 8, 128) f32, ktok1/ktok2
// (P, 8, 128), ut1/ut2 (P, 256, 64), part (P, M/64, 64, 18) f32.
// Requires M % 64 == 0, 1 <= T <= 8, mlp % 64 == 0.  Launches on `stream`
// and returns cudaGetLastError().
extern "C" int twoway_tail_forward(
    const void* keys0, const void* q1i, const void* k1, const void* v1,
    const void* tokens, const void* const* params, void* keys2,
    void* tok_out, void* tok_state, void* qh, void* ktok1, void* ut1,
    void* ktok2, void* ut2, void* part, int P, int T, int M, int mlp,
    void* stream) {
  if (P <= 0 || M <= 0 || M % TM || T < 1 || T > TP || mlp <= 0 || mlp % 64)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.keys0 = static_cast<const bf16*>(keys0);
  a.q1i = static_cast<const bf16*>(q1i);
  a.k1 = static_cast<const bf16*>(k1);
  a.v1 = static_cast<const bf16*>(v1);
  a.tokens = static_cast<const bf16*>(tokens);
  a.keys2 = static_cast<bf16*>(keys2);
  a.tok_out = static_cast<bf16*>(tok_out);
  a.tok_state = static_cast<float*>(tok_state);
  a.qh = static_cast<float*>(qh);
  a.ktok[0] = static_cast<bf16*>(ktok1);
  a.ktok[1] = static_cast<bf16*>(ktok2);
  a.ut[0] = static_cast<bf16*>(ut1);
  a.ut[1] = static_cast<bf16*>(ut2);
  a.part = static_cast<float*>(part);
  a.T = T;
  a.M = M;
  a.NT = M / TM;
  a.mlp = mlp;
  for (int i = 0; i < N_PARAMS; ++i) a.w[i] = params[i];

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tok_smem = (6 * TP * LDT + TP * (mlp + 8)) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)tok_phase, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tok_smem);
  if (err != cudaSuccess) return (int)err;
  const void* rows[3] = {(const void*)row_phase<0>, (const void*)row_phase<1>,
                         (const void*)row_phase<2>};
  for (int i = 0; i < 3; ++i) {
    err = cudaFuncSetAttribute(
        rows[i], cudaFuncAttributeMaxDynamicSharedMemorySize, ROW_SMEM);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 rgrid(a.NT, P);
  tok_phase<<<P, TOK_THREADS, tok_smem, st>>>(a, 0);
  row_phase<0><<<rgrid, 128, ROW_SMEM, st>>>(a);
  tok_phase<<<P, TOK_THREADS, tok_smem, st>>>(a, 1);
  row_phase<1><<<rgrid, 128, ROW_SMEM, st>>>(a);
  tok_phase<<<P, TOK_THREADS, tok_smem, st>>>(a, 2);
  row_phase<2><<<rgrid, 128, ROW_SMEM, st>>>(a);
  tok_phase<<<P, TOK_THREADS, tok_smem, st>>>(a, 3);
  return (int)cudaGetLastError();
}
