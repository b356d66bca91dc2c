// Float32 two-way transformer of the fused mask decode for Hopper (sm_90a):
// the float32 arm of K5, for `tpu.compute_dtype float32` with the fused
// decode on the card.
//
// Replaces, for float32, the TPU kernel `twoway_tail_pallas`
// (crowdsam_tpu/models/decode_tail_kernel.py:359), which the JAX package
// turns off for float32 (`tail_kernel_enabled`, :60-70) and computes through
// XLA.  It computes what `twoway_tail_plain` computes at float32: for each
// of P prompts, block 1's token self-attention, token->image attention,
// ReLU MLP and image->token update + LayerNorm, block 2 likewise, and the
// final token->image attention + LayerNorm; each head's softmax on its own,
// LayerNorm eps 1e-5, everything float32.  In: keys0 (B, M, 256), block 1's
// image-side projections q1i/k1/v1 (B, M, 128) of B images; img (P,) int32
// each prompt's image (null: B = 1; an index outside 0..B-1 is clamped);
// tokens (P, T, 256); the parameters of `PARAM_NAMES`, all float32.  Out:
// keys2 (P, M, 256) and the final tokens (P, T, 256).
//
// Bound: operations.  At 32 prompts x 4096 rows about 54 GFLOP, two thirds
// of it keys1 @ wide2 (0.81 GFLOP a prompt) and keys2 @ widef (0.54); the
// two rank-64 image updates 0.13 each: 0.81 ms at the card's 67 TFLOP/s
// float32 peak.  It moves ~0.4 GB (keys1 out and back, keys2 out).
//
// Design (simple first; making it fast is later work).  Seven launches on
// the caller's stream, each a function of what the ones before it wrote:
//
//   tok 0   block 1 self-attention, LN, token->image q
//   row 0   per (64-row tile, prompt): partial softmax over k1/v1
//   tok 1   merge, out-projection, LN, MLP, LN; update 1's token keys and
//           folded values; block 2 self-attention, LN, token->image q
//   row 1   keys1 = LN(keys0 + update 1), written; k2/v2/q2i = keys1 @
//           wide2 (q2i written); partial softmax of block 2
//   tok 2   merge, out-projection, LN, MLP, LN; update 2's token keys and
//           folded values; the final q
//   row 2   keys2 = LN(keys1 + update 2), written; kf/vf = keys2 @ widef;
//           partial softmax of the final attention
//   tok 3   merge, out-projection, final LN: the tokens
//
// Token stages: one block of 256 threads a prompt, its T <= 8 tokens as 8
// rows in shared memory (rows past T zero).  A dense layer gives a thread
// one output column at a time for all 8 rows, reading the weight's row
// along k as float4 (each thread its own row: L1 keeps the lines) against
// the rows broadcast from shared memory; k is summed in chunks of 32 whose
// FMA chains join the total, as a split float32 product sums a deep k (the
// MLP's second product is 2048 deep).  LayerNorm: a warp a row, two passes
// (mean, then the centred squares).
//
// Row phases: one block of 256 threads a (64-row tile, prompt), one block
// an SM (188 KB of shared memory).  The image update of all heads: the
// per-head softmax over the tokens gives P (64 rows x 64 (head, token));
// delta = P U, U the token values folded through the out-projection (256 x
// 64, from the token stage), by `tile_product`; x = (prev + delta) + b, the
// row LayerNorm in place (four threads a row), the tile written out.  Then
// the wide product by `tile_product`, 128 output columns at a time, each
// chunk's epilogue adding its PE-side term or bias: q2i to device memory, k
// and v into shared memory.  The token->image partial softmax of the tile:
// four threads a (head, token), 16 rows each, the tile's max, sum and 16
// values of P V reduced over the four; written as (max, sum, P V) per
// (prompt, head, token, tile).  A token stage merges a (head, token)'s tiles
// in tile order (no atomics: a run repeats bit for bit) in float32, as the
// plain version merges them.
//
// Where this design can go wrong, and what guards it:
//   1. A tile's partial left out of a merge: the merge walks every tile
//      0..NT-1 of its (prompt, head, token).
//   2. A prompt reading another image's rows: every image-side load (keys0,
//      q1i, k1, v1) is offset by `image_row` of the prompt.
//   3. The PE-side terms: kpe2 / qpe2i / kpef are indexed by the tile's own
//      rows, bv2 / bvf by the column; chip_smoke.py leaves kpe2 out as a
//      fault.
//   4. Padded tokens (t >= T): zero rows in the token stages, probability 0
//      in the image update (their folded values are zero too), no partial.
//   5. Stage reuse in `tile_product`: see f32_tile.cuh.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "f32_tile.cuh"

namespace {

using f32tile::THREADS;
using f32tile::TR;

constexpr int C = 256;        // embedding width
constexpr int CD = 128;       // cross-attention width
constexpr int H = 8;          // heads
constexpr int HD = 16;        // cross-attention head dim
constexpr int HD2 = 32;       // self-attention head dim
constexpr int TP = 8;         // tokens, padded
constexpr int HT = H * TP;    // the (head, token) axis
constexpr int MLP = 2048;     // the MLP's hidden width
constexpr int PW = 20;        // floats a partial: max, sum, P V, 2 pad
constexpr float EPS = 1e-5f;
constexpr float SCALE = 0.25f;                  // 1 / sqrt(HD)
constexpr float SCALE2 = 0.17677669529663687f;  // 1 / sqrt(HD2)

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
  const float* keys0;   // (B, M, C)
  const float* q1i;     // (B, M, CD), and k1, v1
  const float* k1;
  const float* v1;
  const int* img;       // (P,) each prompt's image, or null for B = 1
  const float* tokens;  // (P, T, C)
  float* keys2;         // (P, M, C)
  float* tok_out;       // (P, T, C)
  float* keys1;         // (P, M, C) scratch: row 1 to row 2
  float* q2i;           // (P, M, CD) scratch: row 1 to row 2
  float* state;         // (P, TP, C) the token state between token stages
  float* qh;            // (P, TP, CD) the token->image query of the next row
  float* ktok;          // (P, TP, CD) the next update's token keys
  float* ut;            // (P, C, HT) its folded token values, transposed
  float* part;          // (P, HT, NT, PW) the row tiles' partial softmaxes
  int P, T, M, NT, B;
  const float* w[N_PARAMS];
};

// The first row of prompt q's image in the image-side operands (an index
// outside 0..B-1 is clamped).
__device__ __forceinline__ size_t image_row(const Args& a, int q) {
  if (a.img == nullptr) return 0;
  const int i = min(max(a.img[q], 0), a.B - 1);
  return (size_t)i * a.M;
}

// --------------------------------------------------------------------------
// token stages
// --------------------------------------------------------------------------

// Shared memory of a token stage (floats): the query PE, the state, three
// (TP, C) buffers, the MLP's hidden rows (also the self-attention's
// q/k/v/o), the merged attention, the self-attention's scores.
constexpr int TOK_PE = 0;
constexpr int TOK_X = TOK_PE + TP * C;
constexpr int TOK_Y1 = TOK_X + TP * C;
constexpr int TOK_Y2 = TOK_Y1 + TP * C;
constexpr int TOK_Y3 = TOK_Y2 + TP * C;
constexpr int TOK_HID = TOK_Y3 + TP * C;
constexpr int TOK_ATT = TOK_HID + TP * MLP;
constexpr int TOK_SC = TOK_ATT + TP * CD;
constexpr int TOK_FLOATS = TOK_SC + H * TP * TP;

// Y[t][n] = b[n] + sum_k X[t][k] W[n][k] (optionally ReLU) for the TP rows,
// rows t >= T set to 0; X (TP, K) row stride ldx in shared memory, W (N, K)
// in device memory, K a multiple of 32.
__device__ void tok_dense(const float* x, int ldx, int k, const float* w,
                          const float* b, int n_out, float* y, int ldy,
                          int t_cnt, bool relu) {
  for (int n = threadIdx.x; n < n_out; n += THREADS) {
    const float* wr = w + (size_t)n * k;
    float tot[TP];
#pragma unroll
    for (int t = 0; t < TP; ++t) tot[t] = 0.f;
    for (int k0 = 0; k0 < k; k0 += 32) {
      float part[TP];
#pragma unroll
      for (int t = 0; t < TP; ++t) part[t] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 32; kk += 4) {
        const float4 wv = __ldg(reinterpret_cast<const float4*>(wr + k0 + kk));
#pragma unroll
        for (int t = 0; t < TP; ++t) {
          const float4 xv =
              *reinterpret_cast<const float4*>(x + t * ldx + k0 + kk);
          part[t] = fmaf(xv.x, wv.x, part[t]);
          part[t] = fmaf(xv.y, wv.y, part[t]);
          part[t] = fmaf(xv.z, wv.z, part[t]);
          part[t] = fmaf(xv.w, wv.w, part[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < TP; ++t) tot[t] += part[t];
    }
    const float bn = b[n];
#pragma unroll
    for (int t = 0; t < TP; ++t) {
      float v = tot[t] + bn;
      if (relu) v = fmaxf(v, 0.f);
      y[t * ldy + n] = t < t_cnt ? v : 0.f;
    }
  }
  __syncthreads();
}

// Y = LayerNorm(X) over C for rows t < T (a warp a row), rows past T zero.
// Y may be X.
__device__ void tok_ln(const float* x, float* y, const float* g,
                       const float* b, int t_cnt) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = warp;   // 8 warps, TP rows
  float v[C / 32];
#pragma unroll
  for (int i = 0; i < C / 32; ++i) v[i] = x[t * C + lane + 32 * i];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < C / 32; ++i) s += v[i];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float u = s / C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < C / 32; ++i) {
    const float d = v[i] - u;
    q = fmaf(d, d, q);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
  const float r = 1.f / sqrtf(q / C + EPS);
  __syncwarp();
#pragma unroll
  for (int i = 0; i < C / 32; ++i) {
    const int c = lane + 32 * i;
    y[t * C + c] = t < t_cnt ? (v[i] - u) * r * g[c] + b[c] : 0.f;
  }
  __syncthreads();
}

// Y = A + B elementwise over the TP x C rows (Y may be A or B).
__device__ void tok_add(const float* a, const float* b, float* y) {
  for (int i = threadIdx.x; i < TP * C; i += THREADS) y[i] = a[i] + b[i];
  __syncthreads();
}

// out = out_proj(attention(q = Xqk Wq, k = Xqk Wk, v = Xv Wv)), 8 heads of
// 32, each head's softmax over the T tokens on its own; `pfx` the index of
// the q weight (q, k, v, o weights and biases follow it in `Param` order).
__device__ void tok_self_attn(const Args& a, float* sm, const float* xqk,
                              const float* xv, int pfx, float* out) {
  float* q = sm + TOK_HID;
  float* k = q + TP * C;
  float* v = k + TP * C;
  float* o = v + TP * C;
  float* sc = sm + TOK_SC;
  const int t_cnt = a.T;
  tok_dense(xqk, C, C, a.w[pfx], a.w[pfx + 1], C, q, C, t_cnt, false);
  tok_dense(xqk, C, C, a.w[pfx + 2], a.w[pfx + 3], C, k, C, t_cnt, false);
  tok_dense(xv, C, C, a.w[pfx + 4], a.w[pfx + 5], C, v, C, t_cnt, false);
  for (int e = threadIdx.x; e < H * TP * TP; e += THREADS) {
    const int h = e / (TP * TP), i = (e / TP) % TP, j = e % TP;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < HD2; ++d)
      s = fmaf(q[i * C + h * HD2 + d], k[j * C + h * HD2 + d], s);
    sc[e] = s * SCALE2;
  }
  __syncthreads();
  if (threadIdx.x < H * TP) {    // (head, query) rows: softmax over j < T
    float* row = sc + threadIdx.x * TP;
    float mx = -INFINITY;
    for (int j = 0; j < t_cnt; ++j) mx = fmaxf(mx, row[j]);
    float sum = 0.f;
    for (int j = 0; j < t_cnt; ++j) {
      row[j] = expf(row[j] - mx);
      sum += row[j];
    }
    for (int j = 0; j < TP; ++j) row[j] = j < t_cnt ? row[j] / sum : 0.f;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < TP * C; e += THREADS) {
    const int i = e / C, c = e % C, h = c / HD2;
    float s = 0.f;
    for (int j = 0; j < t_cnt; ++j)
      s = fmaf(sc[(h * TP + i) * TP + j], v[j * C + c], s);
    o[e] = i < t_cnt ? s : 0.f;
  }
  __syncthreads();
  tok_dense(o, C, C, a.w[pfx + 6], a.w[pfx + 7], C, out, C, t_cnt, false);
}

// The merged token->image attention (TP, CD) of prompt p from the row
// tiles' partials: each (head, token)'s tiles in order, rescaled to their
// largest max.
__device__ void tok_merge(const Args& a, int p, float* att) {
  for (int e = threadIdx.x; e < TP * CD; e += THREADS) {
    const int t = e / CD, hd = e % CD, h = hd / HD, d = hd % HD;
    if (t >= a.T) {
      att[e] = 0.f;
      continue;
    }
    const float* pp = a.part + (size_t)(p * HT + h * TP + t) * a.NT * PW;
    float mx = -INFINITY;
    for (int i = 0; i < a.NT; ++i) mx = fmaxf(mx, pp[i * PW]);
    float num = 0.f, den = 0.f;
    for (int i = 0; i < a.NT; ++i) {
      const float wgt = expf(pp[i * PW] - mx);
      num = fmaf(wgt, pp[i * PW + 2 + d], num);
      den = fmaf(wgt, pp[i * PW + 1], den);
    }
    att[e] = num / den;
  }
  __syncthreads();
}

// The token side of an image->token update from the token state x: its
// token keys (x + pe) Wk + bk and values v = x Wv + bv, the values folded
// through the out-projection per head, U[c][h TP + t] = sum_d v[t][h HD +
// d] Wo[c][h HD + d] (zero for t >= T); keys and U written for the row
// phase (a thread a (c, h): eight contiguous values of U).
__device__ void tok_update(const Args& a, float* sm, int p, int kw, int vw,
                           int ow) {
  float* y2 = sm + TOK_Y2;
  float* y3 = sm + TOK_Y3;
  tok_add(sm + TOK_X, sm + TOK_PE, y2);
  tok_dense(y2, C, C, a.w[kw], a.w[kw + 1], CD, y3, CD, a.T, false);
  for (int i = threadIdx.x; i < TP * CD; i += THREADS)
    a.ktok[(size_t)p * TP * CD + i] = y3[i];
  __syncthreads();
  tok_dense(sm + TOK_X, C, C, a.w[vw], a.w[vw + 1], CD, y3, CD, a.T, false);
  const float* wo = a.w[ow];
  float* ut = a.ut + (size_t)p * C * HT;
  for (int e = threadIdx.x; e < C * H; e += THREADS) {
    const int c = e / H, h = e % H;
    float wr[HD];
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      const float4 v =
          __ldg(reinterpret_cast<const float4*>(wo + (size_t)c * CD + h * HD + d));
      wr[d] = v.x;
      wr[d + 1] = v.y;
      wr[d + 2] = v.z;
      wr[d + 3] = v.w;
    }
#pragma unroll
    for (int t = 0; t < TP; ++t) {
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < HD; ++d) s = fmaf(y3[t * CD + h * HD + d], wr[d], s);
      ut[c * HT + h * TP + t] = t < a.T ? s : 0.f;
    }
  }
  __syncthreads();
}

// y3 = (x + pe) Wq + bq, written as the next row phase's query heads.
__device__ void tok_query(const Args& a, float* sm, int p, int qw) {
  float* y2 = sm + TOK_Y2;
  float* y3 = sm + TOK_Y3;
  tok_add(sm + TOK_X, sm + TOK_PE, y2);
  tok_dense(y2, C, C, a.w[qw], a.w[qw + 1], CD, y3, CD, a.T, false);
  for (int i = threadIdx.x; i < TP * CD; i += THREADS)
    a.qh[(size_t)p * TP * CD + i] = y3[i];
  __syncthreads();
}

// x = LN(x + out_proj(merged attention)), then x = LN(x + MLP(x)); the
// arguments index the weights (each bias follows its weight).
__device__ void tok_attn_mlp(const Args& a, float* sm, int p, int ow, int nw,
                             int m1, int m2, int n3) {
  float* x = sm + TOK_X;
  float* y1 = sm + TOK_Y1;
  float* att = sm + TOK_ATT;
  float* hid = sm + TOK_HID;
  tok_merge(a, p, att);
  tok_dense(att, CD, CD, a.w[ow], a.w[ow + 1], C, y1, C, a.T, false);
  tok_add(x, y1, x);
  tok_ln(x, x, a.w[nw], a.w[nw + 1], a.T);
  tok_dense(x, C, C, a.w[m1], a.w[m1 + 1], MLP, hid, MLP, a.T, true);
  tok_dense(hid, MLP, MLP, a.w[m2], a.w[m2 + 1], C, y1, C, a.T, false);
  tok_add(x, y1, x);
  tok_ln(x, x, a.w[n3], a.w[n3 + 1], a.T);
}

template <int STAGE>
__global__ void __launch_bounds__(THREADS, 1) tok_stage(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int p = blockIdx.x;
  float* pe = sm + TOK_PE;
  float* x = sm + TOK_X;
  float* y1 = sm + TOK_Y1;
  float* state = a.state + (size_t)p * TP * C;
  for (int i = threadIdx.x; i < TOK_FLOATS; i += THREADS) sm[i] = 0.f;
  __syncthreads();
  for (int i = threadIdx.x; i < a.T * C; i += THREADS) {
    pe[i] = a.tokens[(size_t)p * a.T * C + i];
    if (STAGE > 0) x[i] = state[i];
  }
  __syncthreads();
  if (STAGE == 0) {
    // block 1: self-attention of the tokens (no PE added, no residual)
    tok_self_attn(a, sm, pe, pe, l0sa_q_w, y1);
    tok_ln(y1, x, a.w[n1l0_w], a.w[n1l0_b], a.T);
    tok_query(a, sm, p, t2i1_q_w);
  } else if (STAGE == 1) {
    tok_attn_mlp(a, sm, p, t2i1_o_w, n2l0_w, mlp1l0_w, mlp2l0_w, n3l0_w);
    tok_update(a, sm, p, i2t1_k_w, i2t1_v_w, i2t1_o_w);
    // block 2: self-attention with the PE on q and k, residual, LN
    float* y2 = sm + TOK_Y2;
    tok_add(x, pe, y2);
    tok_self_attn(a, sm, y2, x, l1sa_q_w, y1);
    tok_add(x, y1, x);
    tok_ln(x, x, a.w[n1l1_w], a.w[n1l1_b], a.T);
    tok_query(a, sm, p, t2i_q_w);
  } else if (STAGE == 2) {
    tok_attn_mlp(a, sm, p, t2i_o_w, n2_w, mlp1_w, mlp2_w, n3_w);
    tok_update(a, sm, p, i2t_k_w, i2t_v_w, i2t_o_w);
    tok_query(a, sm, p, fin_q_w);
  } else {
    float* att = sm + TOK_ATT;
    tok_merge(a, p, att);
    tok_dense(att, CD, CD, a.w[fin_o_w], a.w[fin_o_b], C, y1, C, a.T, false);
    tok_add(x, y1, x);
    tok_ln(x, x, a.w[nf_w], a.w[nf_b], a.T);
    for (int i = threadIdx.x; i < a.T * C; i += THREADS)
      a.tok_out[(size_t)p * a.T * C + i] = x[i];
    return;
  }
  for (int i = threadIdx.x; i < TP * C; i += THREADS) state[i] = x[i];
}

// --------------------------------------------------------------------------
// row phases
// --------------------------------------------------------------------------

constexpr int LDA = C + 4;    // the tile's rows (floats)
constexpr int LDQ = CD + 4;   // q / k / v rows
constexpr int LDP = HT + 4;   // P rows
constexpr int ROW_A = 0;                              // [TR][LDA]
constexpr int ROW_B = ROW_A + TR * LDA;               // 2 weight stages
constexpr int ROW_Q = ROW_B + 2 * f32tile::STAGE_FLOATS; // [TR][LDQ]: q, then k
constexpr int ROW_V = ROW_Q + TR * LDQ;               // [TR][LDQ]
constexpr int ROW_P = ROW_V + TR * LDQ;               // [TR][LDP]
constexpr int ROW_KT = ROW_P + TR * LDP;              // [TP][CD] token keys
constexpr int ROW_FLOATS = ROW_KT + TP * CD;

// The tile's partial token->image softmax: four threads a (head, token),
// rows sub + 4 i; (max, sum, P V) of the 64 rows written to `part`.
__device__ void row_partial(const Args& a, int p, int tile, const float* ks,
                            const float* vs) {
  const int pair = threadIdx.x >> 2, sub = threadIdx.x & 3;
  const int h = pair / TP, t = pair % TP;
  if (t >= a.T) return;        // the group's four lanes leave together
  const unsigned lane = threadIdx.x & 31;
  const unsigned group = 0xfu << (lane & ~3u);
  const float* qr = a.qh + ((size_t)p * TP + t) * CD + h * HD;
  float q[HD];
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    const float4 v = *reinterpret_cast<const float4*>(qr + d);
    q[d] = v.x;
    q[d + 1] = v.y;
    q[d + 2] = v.z;
    q[d + 3] = v.w;
  }
  float s[TR / 4];
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < TR / 4; ++i) {
    const float* kr = ks + (sub + 4 * i) * LDQ + h * HD;
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc = fmaf(q[d], kr[d], acc);
    s[i] = acc * SCALE;
    mx = fmaxf(mx, s[i]);
  }
  mx = fmaxf(mx, __shfl_xor_sync(group, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(group, mx, 2));
  float l = 0.f, pv[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) pv[d] = 0.f;
#pragma unroll
  for (int i = 0; i < TR / 4; ++i) {
    const float e = expf(s[i] - mx);
    l += e;
    const float* vr = vs + (sub + 4 * i) * LDQ + h * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) pv[d] = fmaf(e, vr[d], pv[d]);
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l += __shfl_xor_sync(group, l, o);
#pragma unroll
    for (int d = 0; d < HD; ++d) pv[d] += __shfl_xor_sync(group, pv[d], o);
  }
  if (sub == 0) {
    float* out = a.part + ((size_t)(p * HT + h * TP + t) * a.NT + tile) * PW;
    out[0] = mx;
    out[1] = l;
#pragma unroll
    for (int d = 0; d < HD; ++d) out[2 + d] = pv[d];
  }
}

// The image update of the tile in `as` (prev, 64 x C), in place: per row
// and head the softmax over the tokens of q . ktok / 4, P (64 x HT) times
// U (the prompt's folded values, C x HT), x = (prev + delta) + bo, then the
// row LayerNorm (g, b); the result written to `out` (the tile's rows).
__device__ void row_update(const Args& a, float* sm, int p, const float* qs,
                           int ow, int nw, float* out) {
  float* as = sm + ROW_A;
  float* ps = sm + ROW_P;
  const float* kt = sm + ROW_KT;
  {
    const int r = threadIdx.x >> 2;
    for (int hh = 0; hh < 2; ++hh) {
      const int h = (threadIdx.x & 3) * 2 + hh;
      const float* qr = qs + r * LDQ + h * HD;
      float s[TP];
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < TP; ++t) {
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc = fmaf(qr[d], kt[t * CD + h * HD + d], acc);
        s[t] = acc * SCALE;
        if (t < a.T) mx = fmaxf(mx, s[t]);
      }
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < TP; ++t) {
        s[t] = t < a.T ? expf(s[t] - mx) : 0.f;
        sum += s[t];
      }
#pragma unroll
      for (int t = 0; t < TP; ++t) ps[r * LDP + h * TP + t] = s[t] / sum;
    }
  }
  // delta = P U^T chunk by chunk; x = (prev + delta) + bo in place.
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* u = a.ut + (size_t)p * C * HT;
  const float* bo = a.w[ow + 1];
  for (int n0 = 0; n0 < C; n0 += f32tile::TN) {
    float acc[4][8];
    f32tile::zero(acc);
    f32tile::tile_product(acc, ps, LDP, u, HT, n0, HT, sm + ROW_B);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = 4 * ty + i, c = n0 + tx + 16 * j;
        as[r * LDA + c] = (as[r * LDA + c] + acc[i][j]) + bo[c];
      }
  }
  __syncthreads();
  // Row LayerNorm: four threads a row, columns q + 4 i.
  {
    const int r = threadIdx.x >> 2, q = threadIdx.x & 3;
    const unsigned lane = threadIdx.x & 31;
    const unsigned group = 0xfu << (lane & ~3u);
    float* xr = as + r * LDA;
    float s = 0.f;
    for (int i = 0; i < C / 4; ++i) s += xr[q + 4 * i];
    s += __shfl_xor_sync(group, s, 1);
    s += __shfl_xor_sync(group, s, 2);
    const float mean = s / C;
    float v = 0.f;
    for (int i = 0; i < C / 4; ++i) {
      const float d = xr[q + 4 * i] - mean;
      v = fmaf(d, d, v);
    }
    v += __shfl_xor_sync(group, v, 1);
    v += __shfl_xor_sync(group, v, 2);
    const float rs = 1.f / sqrtf(v / C + EPS);
    const float* g = a.w[nw];
    const float* b = a.w[nw + 1];
    for (int i = 0; i < C / 4; ++i) {
      const int c = q + 4 * i;
      xr[c] = (xr[c] - mean) * rs * g[c] + b[c];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TR * C / 4; i += THREADS) {
    const int r = i / (C / 4), c = 4 * (i % (C / 4));
    *reinterpret_cast<float4*>(out + (size_t)r * C + c) =
        *reinterpret_cast<const float4*>(as + r * LDA + c);
  }
}

template <int PHASE>
__global__ void __launch_bounds__(THREADS, 1) row_phase(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int tile = blockIdx.x, p = blockIdx.y;
  const size_t m0 = (size_t)tile * TR;
  float* as = sm + ROW_A;
  float* qk = sm + ROW_Q;
  float* vs = sm + ROW_V;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  if (PHASE == 0) {
    const size_t ir = image_row(a, p) + m0;
    f32tile::load_rows(qk, LDQ, a.k1 + ir * CD, CD, TR, CD);
    f32tile::load_rows(vs, LDQ, a.v1 + ir * CD, CD, TR, CD);
    f32tile::cp_commit();
    f32tile::cp_wait<0>();
    __syncthreads();
    row_partial(a, p, tile, qk, vs);
    return;
  }
  // prev (keys0 of the prompt's image, or keys1), the image-side q (q1i or
  // q2i) and the update's token keys.
  const size_t pr = (size_t)p * a.M + m0;
  if (PHASE == 1) {
    const size_t ir = image_row(a, p) + m0;
    f32tile::load_rows(as, LDA, a.keys0 + ir * C, C, TR, C);
    f32tile::load_rows(qk, LDQ, a.q1i + ir * CD, CD, TR, CD);
  } else {
    f32tile::load_rows(as, LDA, a.keys1 + pr * C, C, TR, C);
    f32tile::load_rows(qk, LDQ, a.q2i + pr * CD, CD, TR, CD);
  }
  f32tile::load_rows(sm + ROW_KT, CD, a.ktok + (size_t)p * TP * CD, CD, TP, CD);
  f32tile::cp_commit();
  f32tile::cp_wait<0>();
  __syncthreads();
  if (PHASE == 1)
    row_update(a, sm, p, qk, i2t1_o_w, n4l0_w, a.keys1 + pr * C);
  else
    row_update(a, sm, p, qk, i2t_o_w, n4_w, a.keys2 + pr * C);
  // The wide product of the updated tile, a chunk of 128 columns at a time:
  // row 1 q2i (to device memory), then k, v; row 2 k, v.
  const float* wide = a.w[PHASE == 1 ? wide2 : widef];
  const float* kpe = a.w[PHASE == 1 ? kpe2 : kpef];
  const float* bv = a.w[PHASE == 1 ? bv2 : bvf];
  const int first = PHASE == 1 ? -1 : 0;
  for (int chunk = first; chunk < 2; ++chunk) {
    const int n0 = (chunk < 0 ? 2 : chunk) * f32tile::TN;
    float acc[4][8];
    f32tile::zero(acc);
    f32tile::tile_product(acc, as, LDA, wide, C, n0, C, sm + ROW_B);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = 4 * ty + i, c = tx + 16 * j;
        const size_t row = m0 + r;
        if (chunk < 0)
          a.q2i[(pr + r) * CD + c] = acc[i][j] + a.w[qpe2i][row * CD + c];
        else if (chunk == 0)
          qk[r * LDQ + c] = acc[i][j] + kpe[row * CD + c];
        else
          vs[r * LDQ + c] = acc[i][j] + bv[c];
      }
  }
  __syncthreads();
  row_partial(a, p, tile, qk, vs);
}

template <typename K>
cudaError_t set_smem(K kernel, int floats) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              floats * (int)sizeof(float));
}

cudaError_t configure() {
  static const cudaError_t status = [] {
    cudaError_t e = cudaSuccess;
    const cudaError_t all[] = {
        set_smem(tok_stage<0>, TOK_FLOATS), set_smem(tok_stage<1>, TOK_FLOATS),
        set_smem(tok_stage<2>, TOK_FLOATS), set_smem(tok_stage<3>, TOK_FLOATS),
        set_smem(row_phase<0>, ROW_FLOATS), set_smem(row_phase<1>, ROW_FLOATS),
        set_smem(row_phase<2>, ROW_FLOATS)};
    for (cudaError_t x : all)
      if (x != cudaSuccess) e = x;
    return e;
  }();
  return status;
}

}  // namespace

// keys0 (B, M, 256), q1i/k1/v1 (B, M, 128), tokens (P, T, 256), the
// N_PARAMS parameters (`params`, device pointers in `PARAM_NAMES` order),
// all float32 and contiguous; img (P,) int32 or null.  Outputs keys2 (P, M,
// 256), tok_out (P, T, 256); scratch keys1 (P, M, 256), q2i (P, M, 128),
// state (P, 8, 256), qh and ktok (P, 8, 128), ut (P, 256, 64), part (P, 64,
// M / 64, 20).  Returns a cudaError_t: cudaErrorInvalidValue for arguments
// the kernels do not take.
extern "C" int twoway_tail_f32_forward(
    const float* keys0, const float* q1i, const float* k1, const float* v1,
    const float* tokens, const void* const* params, float* keys2,
    float* tok_out, float* keys1, float* q2i, float* state, float* qh,
    float* ktok, float* ut, float* part, const int* img, int P, int T, int M,
    int B, int mlp, void* stream) {
  if (P <= 0 || P > 65535 || T < 2 || T > TP || M <= 0 || M % TR || B < 1 ||
      mlp != MLP || (img == nullptr && B != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = configure();
  if (e != cudaSuccess) return (int)e;
  Args a;
  a.keys0 = keys0;
  a.q1i = q1i;
  a.k1 = k1;
  a.v1 = v1;
  a.img = img;
  a.tokens = tokens;
  a.keys2 = keys2;
  a.tok_out = tok_out;
  a.keys1 = keys1;
  a.q2i = q2i;
  a.state = state;
  a.qh = qh;
  a.ktok = ktok;
  a.ut = ut;
  a.part = part;
  a.P = P;
  a.T = T;
  a.M = M;
  a.NT = M / TR;
  a.B = B;
  for (int i = 0; i < N_PARAMS; ++i)
    a.w[i] = static_cast<const float*>(params[i]);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const size_t tok_smem = TOK_FLOATS * sizeof(float);
  const size_t row_smem = ROW_FLOATS * sizeof(float);
  const dim3 rows(a.NT, P);
  tok_stage<0><<<P, THREADS, tok_smem, cs>>>(a);
  row_phase<0><<<rows, THREADS, row_smem, cs>>>(a);
  tok_stage<1><<<P, THREADS, tok_smem, cs>>>(a);
  row_phase<1><<<rows, THREADS, row_smem, cs>>>(a);
  tok_stage<2><<<P, THREADS, tok_smem, cs>>>(a);
  row_phase<2><<<rows, THREADS, row_smem, cs>>>(a);
  tok_stage<3><<<P, THREADS, tok_smem, cs>>>(a);
  return (int)cudaGetLastError();
}

// out[0] a token stage's dynamic shared memory, out[1] a row phase's,
// out[2] / out[3] their blocks an SM.
extern "C" int twoway_tail_f32_occupancy(int* out) {
  cudaError_t e = configure();
  if (e != cudaSuccess) return (int)e;
  out[0] = TOK_FLOATS * (int)sizeof(float);
  out[1] = ROW_FLOATS * (int)sizeof(float);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], tok_stage<1>,
                                                    THREADS, out[0]);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3], row_phase<1>, THREADS, out[1]);
}
