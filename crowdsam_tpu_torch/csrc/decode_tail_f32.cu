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
// LayerNorm eps 1e-5.  In: keys0 (B, M, 256), block 1's image-side
// projections q1i/k1/v1 (B, M, 128) of B images; img (P,) int32 each
// prompt's image (null: B = 1; an index outside 0..B-1 is clamped); tokens
// (P, T, 256); the parameters of `PARAM_NAMES` and the packed weights of
// `PACKED`, all float32.  Out: keys2 (P, M, 256) and the final tokens
// (P, T, 256).
//
// Arithmetic: every product on the tensor cores in 3xTF32 (`tf32x3.cuh`:
// each float32 operand split into TF32 hi + lo, lo.hi + hi.lo + hi.hi),
// the softmaxes, LayerNorms and token->image partials in float32 on the
// CUDA cores.  `decode_tail_kernel.twoway_tail_tf32x3_model` is it in
// PyTorch.
//
// Bound: operations.  At 32 prompts x 7 tokens x 4096 rows about 54 GFLOP,
// two thirds of it keys1 @ wide2 (0.81 GFLOP a prompt) and keys2 @ widef
// (0.54): 0.325 ms at 165 TFLOP/s (three TF32 products at 495).  It moves
// ~0.4 GB (keys1 out and back, keys2 out).
//
// Design.  Sixteen launches on the caller's stream, each a programmatic
// dependent launch of the one before (it waits, griddepcontrol.wait, before
// it reads anything):
//
//   qkv 0    block 1's self-attention q, k, v: a block each a tile
//   tok 0    block 1: self-attention, out-projection, LN; the token->image
//            q of the next row phase
//   row 0    per (64-row tile, prompt): partial softmax over k1/v1
//   merge 0  the tiles' partials, in tile order
//   tok 1    out-projection, residual, LN
//   mlp 0    the MLP, K-split: block j the hidden columns 256 j.. and their
//            partial of the second product
//   qkv 1    the partials summed in order, residual, LN; block 2's
//            self-attention q, k, v
//   tok 2    the same sum and LN; then (block y = 0) update 1's token keys,
//            values and the values folded through the out-projection, or
//            (y = 1) block 2's self-attention, LN and the next query
//   row 1    keys1 = LN(keys0 + update 1), written; k2/v2/q2i = keys1 @
//            wide2 (q2i written); partial softmax of block 2
//   merge 1, tok 3, mlp 1
//   tok 4    as tok 2 with update 2's weights; (y = 1) the final query
//   row 2    keys2 = LN(keys1 + update 2), written; kf/vf = keys2 @ widef;
//            partial softmax of the final attention
//   merge 2
//   tok 5    out-projection, residual, final LN: the tokens
//
// Every product kernel is a block of two consumer warpgroups and a
// producer warp (`tf32x3::THREADS`), one block an SM, a 64-row tile of A
// in shared memory in float32 (rows of 260 floats) and the weight streamed
// by the producer in stages of 128 output rows x 32 inputs, hi then lo,
// that the host split and laid out once (`tf32x3.pack`); each warpgroup
// takes 64 of a stage's 128 output rows (m64n64k8), the two issuing in
// turns.  The producer runs the same program as the consumers with every
// step but the weight stream left out (`Ctx`), so the stream's order is
// the products' order by construction.  Loads from device memory outside
// the products go by cp.async or several at once (no branch between
// them): a loop that waits for each load in turn cost tens of
// microseconds a block.
//
// Token side (199,712 B of shared memory, two ring slots): the P prompts'
// T <= 8 tokens are rows p * 8 + t of one batch of P8 = 8 ceil(P / 8) rows,
// cut into tiles of 64 rows (8 prompts): every weight is read once a tile,
// not once a prompt.  Rows of padding tokens
// (t >= T) and prompts (p >= P) are zero and never reach an output.  The
// token state lives in device memory between the stages (one buffer a
// stage).  The MLP's 2048-deep second product is split over 8 blocks of 256
// inputs; tok 2 / tok 4 sum the partials in block order (no atomics).  The
// fold: U[c][h 8 + t] = sum_d v[t][16 h + d] Wo[c][16 h + d], per head a
// product of 16 inputs (the head's columns of Wo, packed as one stage whose
// inputs past 16 are zero, two k-steps), written split and packed as the
// row phases' B operand: per prompt 4 stages (256 outputs x 64 (head,
// token) inputs).
//
// Row phases: a persistent grid of min(tiles x prompts, SMs) blocks
// (226,352 B of shared memory, three ring slots), block b taking the
// (tile, prompt) items b, b + grid, ...  The image update of all heads:
// the per-head softmax over the tokens gives P (64 rows x 64 (head,
// token)); delta = P U^T (2 stages a chunk of 128 columns); x = (prev +
// delta) + b, the row LayerNorm in place (four threads a row), the tile
// written out.  Then the wide product, 8 stages a chunk of 128 columns,
// each chunk's epilogue adding its PE-side term or bias: (row 1) q2i to
// device memory, k into shared memory, and v last, into the tile's place
// (three slots fit only so).  The
// token->image partial softmax of the tile: four threads a (head, token),
// the tile's max, sum and 16 values of P V, written as (max, sum, P V) per
// (prompt, head, token, tile); a merge thread a (prompt, head, token, dim)
// combines a (head, token)'s tiles in tile order, as the plain version
// merges them.
//
// Where this design can go wrong, and what guards it:
//   1. A tile's partial left out of a merge: the merge walks every tile
//      0..NT-1 of its (prompt, head, token) (chip_smoke.py's fault: the
//      last tile left out).
//   2. A prompt reading another image's rows: every image-side load (keys0,
//      q1i, k1, v1) is offset by `image_row` of the prompt.
//   3. The PE-side terms: kpe2 / qpe2i / kpef are indexed by the tile's own
//      rows, bv2 / bvf by the column (fault: kpe2 left out).
//   4. Token rows: a tile's row r is prompt 8 tile + r / 8, token r % 8;
//      rows past T or P are zero (faults: a prompt's MLP reading the next
//      prompt's rows; the model's: a prompt's folded values from the next
//      prompt's).
//   5. The stages and their swizzle: `tf32x3.cuh`; the model's faults of
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

constexpr int C = 256;        // embedding width
constexpr int CD = 128;       // cross-attention width
constexpr int H = 8;          // heads
constexpr int HD = 16;        // cross-attention head dim
constexpr int HD2 = 32;       // self-attention head dim
constexpr int TP = 8;         // tokens, padded
constexpr int HT = H * TP;    // the (head, token) axis
constexpr int MLP = 2048;     // the MLP's hidden width
constexpr int KSPLIT = MLP / C;   // blocks of the MLP's K-split
constexpr int PW = 20;        // floats a partial: max, sum, P V, 2 pad
constexpr float EPS = 1e-5f;
constexpr float SCALE = 0.25f;                  // 1 / sqrt(HD)
constexpr float SCALE2 = 0.17677669529663687f;  // 1 / sqrt(HD2)
constexpr int U_STAGES = 4;   // a prompt's folded values: 2 chunks x 2
constexpr int TOK_RING = 2;   // stage slots of a token kernel
constexpr int ROW_RING = 3;   // and of a row phase

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

// Order of `PACKED` in models/decode_tail_kernel.py: the weights of the
// products, packed.  The MLPs' second weights are packed as 8 blocks of 256
// inputs, the image updates' out-projections as 8 heads of 16 inputs.
enum Packed {
  pk_wide2, pk_widef,
  pk_l0sa_q, pk_l0sa_k, pk_l0sa_v, pk_l0sa_o, pk_t2i1_q, pk_t2i1_o,
  pk_mlp1l0, pk_mlp2l0, pk_i2t1_k, pk_i2t1_v, pk_i2t1_o,
  pk_l1sa_q, pk_l1sa_k, pk_l1sa_v, pk_l1sa_o, pk_t2i_q, pk_t2i_o,
  pk_mlp1, pk_mlp2, pk_i2t_k, pk_i2t_v, pk_i2t_o, pk_fin_q, pk_fin_o,
  N_PACKED
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
  float* state;         // (5, P8 TP, C) the token state after tok 0..4
  float* qkv;           // (P8 TP, 3 C) a self-attention's q, k, v
  float* mlp;           // (KSPLIT, P8 TP, C) the MLP's partials
  float* att;           // (P8 TP, CD) the merged token->image attention
  float* qh;            // (P8 TP, CD) the next row phase's query heads
  float* ktok;          // (P8 TP, CD) the next update's token keys
  unsigned char* ut;    // (P8, U_STAGES stages) its folded values, packed
  float* part;          // (P, HT, NT, PW) the row tiles' partial softmaxes
  int P, T, M, NT, B, P8;
  const float* w[N_PARAMS];
  const unsigned char* pk[N_PACKED];
};

// The first row of prompt q's image in the image-side operands (an index
// outside 0..B-1 is clamped).
__device__ __forceinline__ size_t image_row(const Args& a, int q) {
  if (a.img == nullptr) return 0;
  const int i = min(max(a.img[q], 0), a.B - 1);
  return (size_t)i * a.M;
}

__device__ __forceinline__ float* state(const Args& a, int i) {
  return a.state + (size_t)i * a.P8 * TP * C;
}

// A thread's part in a product kernel: the producer (warp 8, lane 0) or a
// consumer (threads 0..255, warpgroup wg).
struct Ctx {
  Ring ring;
  bool prod;
  int wg;
};

// A dense product of `nch` chunks of 128 outputs, `nst` stages each, of the
// packed weight at `src` (chunk-major) with A at `x` (64 rows, row stride
// ldx): the producer streams the stages; each consumer gives every element
// of its chunks to epi(row, output, value).
template <int KS, class Epi>
__device__ __forceinline__ void dense(Ctx& c, const unsigned char* src,
                                      int nch, int nst, const float* x,
                                      int ldx, Epi epi) {
  if (c.prod) {
    for (int i = 0; i < nch * nst; ++i)
      tf32x3::put(c.ring, src + (size_t)i * STAGE_BYTES);
    return;
  }
  for (int ch = 0; ch < nch; ++ch) {
    float acc[32];
    tf32x3::product<KS>(c.ring, acc, x, ldx, nst, true, c.wg);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      epi(tf32x3::acc_row(i), 128 * ch + 64 * c.wg + tf32x3::acc_col(i),
          acc[i]);
  }
}

// --------------------------------------------------------------------------
// token stages
// --------------------------------------------------------------------------

constexpr int LDA = C + 4;    // a tile's rows (floats)
// Shared memory of a token kernel, bytes from the 1024-aligned base: the
// ring, A and Y (64 x LDA floats each), the ring's barriers.  A third slot
// would not fit beside A and Y.
constexpr int TOK_A = TOK_RING * STAGE_BYTES;
constexpr int TOK_Y = TOK_A + TR * LDA * 4;
constexpr int TOK_BAR = TOK_Y + TR * LDA * 4;
constexpr int TOK_SMEM = TOK_BAR + 16 * TOK_RING + 1024;

// Row r of the tile from token row t0 holds a token (t < T of a prompt
// p < P).
__device__ __forceinline__ bool valid(const Args& a, int t0, int r) {
  return ((t0 + r) >> 3) < a.P && (r & 7) < a.T;
}

// dst[r][c] = src[t0 + r][c] for the tile's valid rows, 0 elsewhere (src
// row stride ld, ncols a multiple of 4), by cp.async: every load of a
// thread in flight at once (a loop of dependent global loads waits for
// each, ~0.5 us apiece).  The caller waits (cp_async_wait_all) and syncs.
__device__ void rows_in(const Args& a, int t0, float* dst, const float* src,
                        int ld, int ncols) {
  const int per = ncols / 4;
  for (int i = tf32x3::tid(); i < TR * per; i += CONSUMERS) {
    const int r = i / per, c = 4 * (i - r * per);
    const bool keep = valid(a, t0, r);
    tf32x3::cp_async16_or_zero(dst + r * LDA + c,
                               src + (size_t)(keep ? t0 + r : 0) * ld + c,
                               keep);
  }
}

// dst[r][c] = the query PE (the tokens) of the tile's valid rows, 0
// elsewhere, by cp.async; the caller waits and syncs.
__device__ void pe_in(const Args& a, int t0, float* dst) {
  for (int i = tf32x3::tid(); i < TR * C / 4; i += CONSUMERS) {
    const int r = i / (C / 4), c = 4 * (i % (C / 4)), row = t0 + r;
    const bool keep = valid(a, t0, r);
    tf32x3::cp_async16_or_zero(
        dst + r * LDA + c,
        a.tokens + (keep ? ((size_t)(row >> 3) * a.T + (row & 7)) * C : 0) + c,
        keep);
  }
}

// dst = y + the query PE (0 in rows that hold no token), 64 x C: the PE by
// cp.async, then the sum in shared memory.
__device__ void with_pe(const Args& a, int t0, float* dst, const float* y) {
  pe_in(a, t0, dst);
  tf32x3::cp_async_wait_all();
  tf32x3::consumers_sync();
  for (int i = tf32x3::tid(); i < TR * C / 4; i += CONSUMERS) {
    const int r = i / (C / 4), c = 4 * (i % (C / 4));
    float4 v = *reinterpret_cast<const float4*>(y + r * LDA + c);
    const float4 e = *reinterpret_cast<const float4*>(dst + r * LDA + c);
    v.x += e.x;
    v.y += e.y;
    v.z += e.z;
    v.w += e.w;
    *reinterpret_cast<float4*>(dst + r * LDA + c) = v;
  }
}

// The 64 rows of y (row stride LDA) to dst (row stride C).
__device__ void rows_out(float* dst, const float* y) {
  for (int i = tf32x3::tid(); i < TR * C / 4; i += CONSUMERS) {
    const int r = i / (C / 4), c = 4 * (i % (C / 4));
    *reinterpret_cast<float4*>(dst + (size_t)r * C + c) =
        *reinterpret_cast<const float4*>(y + r * LDA + c);
  }
}

// LayerNorm over C of the 64 rows of x in place, four threads a row
// (thread q of a row the float4 columns 4 q + 16 i); rows that hold no
// token set to 0.  The sums in four lanes of 16 terms each, joined in a
// tree (as PyTorch's reductions, which the plain version takes: one chain
// of 64 terms a thread gave the tokens twice the plain version's largest
// error).
__device__ __forceinline__ float tree4(const float4& s) {
  return (s.x + s.y) + (s.z + s.w);
}

__device__ void ln_rows(float* x, const float* g, const float* b,
                        bool keep) {
  const int r = tf32x3::tid() >> 2, q = tf32x3::tid() & 3;
  float4* xr = reinterpret_cast<float4*>(x + r * LDA) + q;
  float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int i = 0; i < C / 16; ++i) {
    const float4 v = xr[4 * i];
    s4.x += v.x;
    s4.y += v.y;
    s4.z += v.z;
    s4.w += v.w;
  }
  float s = tree4(s4);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  const float mean = s / C;
  float4 d4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int i = 0; i < C / 16; ++i) {
    const float4 v = xr[4 * i];
    d4.x = fmaf(v.x - mean, v.x - mean, d4.x);
    d4.y = fmaf(v.y - mean, v.y - mean, d4.y);
    d4.z = fmaf(v.z - mean, v.z - mean, d4.z);
    d4.w = fmaf(v.w - mean, v.w - mean, d4.w);
  }
  float v2 = tree4(d4);
  v2 += __shfl_xor_sync(0xffffffffu, v2, 1);
  v2 += __shfl_xor_sync(0xffffffffu, v2, 2);
  const float rs = 1.f / sqrtf(v2 / C + EPS);
  const float4* g4 = reinterpret_cast<const float4*>(g) + q;
  const float4* b4 = reinterpret_cast<const float4*>(b) + q;
#pragma unroll 4
  for (int i = 0; i < C / 16; ++i) {
    const float4 v = xr[4 * i], gg = __ldg(g4 + 4 * i), bb = __ldg(b4 + 4 * i);
    xr[4 * i] = keep ? make_float4((v.x - mean) * rs * gg.x + bb.x,
                                   (v.y - mean) * rs * gg.y + bb.y,
                                   (v.z - mean) * rs * gg.z + bb.z,
                                   (v.w - mean) * rs * gg.w + bb.w)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ void ln_tokens(const Args& a, int t0, float* y, int nw) {
  ln_rows(y, a.w[nw], a.w[nw + 1], valid(a, t0, tf32x3::tid() >> 2));
}

// o (the tile's 64 rows, columns h 32..) = each head's self-attention of
// the tile's prompts from q, k, v in a.qkv: softmax over the T tokens of
// q . k / sqrt(32), times v; rows that hold no token 0.
__device__ void attn_core(const Args& a, int t0, float* o) {
  for (int e = tf32x3::tid(); e < TR * H; e += CONSUMERS) {
    const int pl = e >> 6, h = (e >> 3) & 7, i = e & 7;
    float* out = o + (8 * pl + i) * LDA + h * HD2;
    if (!valid(a, t0, 8 * pl + i)) {
#pragma unroll
      for (int d = 0; d < HD2; d += 4)
        *reinterpret_cast<float4*>(out + d) = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    // Every load unconditional (rows of padding tokens hold zeros, and
    // their probabilities are set to 0), so that none waits for another;
    // two key or value rows' loads in flight at a time (all eight at once
    // took more registers than the block has).
    const float* base = a.qkv + (size_t)(t0 + 8 * pl) * 3 * C + h * HD2;
    float4 q[HD2 / 4];
#pragma unroll
    for (int d = 0; d < HD2 / 4; ++d)
      q[d] = *reinterpret_cast<const float4*>(base + i * 3 * C + 4 * d);
    float s[TP];
#pragma unroll 2
    for (int j = 0; j < TP; ++j) {
      float4 k[HD2 / 4];
#pragma unroll
      for (int d = 0; d < HD2 / 4; ++d)
        k[d] = *reinterpret_cast<const float4*>(base + j * 3 * C + C + 4 * d);
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < HD2 / 4; ++d) {
        acc = fmaf(q[d].x, k[d].x, acc);
        acc = fmaf(q[d].y, k[d].y, acc);
        acc = fmaf(q[d].z, k[d].z, acc);
        acc = fmaf(q[d].w, k[d].w, acc);
      }
      s[j] = acc * SCALE2;
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < TP; ++j)
      if (j < a.T) mx = fmaxf(mx, s[j]);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < TP; ++j) {
      s[j] = j < a.T ? expf(s[j] - mx) : 0.f;
      sum += s[j];
    }
#pragma unroll
    for (int j = 0; j < TP; ++j) s[j] = s[j] / sum;
    float4 o4[HD2 / 4];
#pragma unroll
    for (int d = 0; d < HD2 / 4; ++d) o4[d] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 2
    for (int j = 0; j < TP; ++j) {
      float4 v[HD2 / 4];
#pragma unroll
      for (int d = 0; d < HD2 / 4; ++d)
        v[d] = *reinterpret_cast<const float4*>(base + j * 3 * C + 2 * C +
                                                4 * d);
#pragma unroll
      for (int d = 0; d < HD2 / 4; ++d) {
        o4[d].x = fmaf(s[j], v[d].x, o4[d].x);
        o4[d].y = fmaf(s[j], v[d].y, o4[d].y);
        o4[d].z = fmaf(s[j], v[d].z, o4[d].z);
        o4[d].w = fmaf(s[j], v[d].w, o4[d].w);
      }
    }
#pragma unroll
    for (int d = 0; d < HD2 / 4; ++d)
      *reinterpret_cast<float4*>(out + 4 * d) = o4[d];
  }
}

// A self-attention projection of A into a.qkv's columns `off`...
__device__ __forceinline__ void qkv_dense(Ctx& c, const Args& a, int t0,
                                          int pk, int bias, const float* x,
                                          int off) {
  const float* b = a.w[bias];
  dense<4>(c, a.pk[pk], 2, 8, x, LDA, [&](int r, int n, float v) {
    a.qkv[(size_t)(t0 + r) * 3 * C + off + n] =
        valid(a, t0, r) ? v + b[n] : 0.f;
  });
}

// Y = res + (x W^T + b) (res null: no residual; res may be Y itself) over
// C outputs, K = 32 nst inputs.
__device__ __forceinline__ void out_dense(Ctx& c, const Args& a, int t0,
                                          int pk, int bias, const float* x,
                                          int nst, float* y, const float* res,
                                          int ldr) {
  const float* b = a.w[bias];
  if (res == nullptr)
    dense<4>(c, a.pk[pk], 2, nst, x, LDA, [&](int r, int n, float v) {
      y[r * LDA + n] = valid(a, t0, r) ? v + b[n] : 0.f;
    });
  else
    dense<4>(c, a.pk[pk], 2, nst, x, LDA, [&](int r, int n, float v) {
      y[r * LDA + n] = valid(a, t0, r) ? res[r * ldr + n] + (v + b[n]) : 0.f;
    });
}

// dst (P8 TP, CD) rows of the tile = x W^T + b over CD outputs.
__device__ __forceinline__ void head_dense(Ctx& c, const Args& a, int t0,
                                           int pk, int bias, const float* x,
                                           float* dst) {
  const float* b = a.w[bias];
  dense<4>(c, a.pk[pk], 1, 8, x, LDA, [&](int r, int n, float v) {
    dst[(size_t)(t0 + r) * CD + n] = valid(a, t0, r) ? v + b[n] : 0.f;
  });
}

// The token side of an image->token update from the state in Y: token keys
// (Y + pe) Wk + bk, values Y Wv + bv (into A), and the values folded
// through the out-projection, U[c][h TP + t], a product per head, written
// packed for the row phase (`ut`, prompt p's U_STAGES stages).
__device__ void tok_update(Ctx& c, const Args& a, int t0, float* A, float* Y,
                           int pk_k, int bk, int pk_v, int bv, int pk_o) {
  if (!c.prod) {
    with_pe(a, t0, A, Y);
    tf32x3::consumers_sync();
  }
  head_dense(c, a, t0, pk_k, bk, A, a.ktok);
  if (!c.prod) tf32x3::consumers_sync();   // A free again
  const float* b = a.w[bv];
  dense<4>(c, a.pk[pk_v], 1, 8, Y, LDA, [&](int r, int n, float v) {
    A[r * LDA + n] = valid(a, t0, r) ? v + b[n] : 0.f;
  });
  if (!c.prod) tf32x3::consumers_sync();
  for (int h = 0; h < H; ++h)
    dense<2>(c, a.pk[pk_o] + (size_t)2 * h * STAGE_BYTES, 2, 1,
             A + HD * h, LDA, [&](int r, int n, float v) {
      const int row = t0 + r, k = h * TP + (r & 7), rr = n & 127;
      const uint32_t off = rr * 128 + ((((k & 31) >> 2) ^ (rr & 7)) << 4) +
                           (k & 3) * 4;
      unsigned char* st =
          a.ut + ((size_t)(row >> 3) * U_STAGES + (n >> 7) * 2 + (k >> 5)) *
                     STAGE_BYTES;
      uint32_t hi, lo;
      tf32x3::split(valid(a, t0, r) ? v : 0.f, hi, lo);
      *reinterpret_cast<uint32_t*>(st + off) = hi;
      *reinterpret_cast<uint32_t*>(st + PART_BYTES + off) = lo;
    });
}

// Y = LN(state + ((the MLP's partials summed in block order) + b2)); four
// columns a thread at a time, two such groups' loads in flight.
__device__ void mlp_sum_ln(const Args& a, int t0, float* Y, const float* st,
                           int b2, int nw) {
  const float* b = a.w[b2];
  const size_t plane = (size_t)a.P8 * TP * C;
#pragma unroll 2
  for (int i = tf32x3::tid(); i < TR * C / 4; i += CONSUMERS) {
    const int r = i / (C / 4), n = 4 * (i % (C / 4));
    const size_t at = (size_t)(t0 + r) * C + n;
    float4 p[KSPLIT];
#pragma unroll
    for (int j = 0; j < KSPLIT; ++j)
      p[j] = *reinterpret_cast<const float4*>(a.mlp + j * plane + at);
    const float4 x = *reinterpret_cast<const float4*>(st + at);
    const float4 bb = *reinterpret_cast<const float4*>(b + n);
    float4 s = p[0];
#pragma unroll
    for (int j = 1; j < KSPLIT; ++j) {
      s.x += p[j].x;
      s.y += p[j].y;
      s.z += p[j].z;
      s.w += p[j].w;
    }
    const bool keep = valid(a, t0, r);
    *reinterpret_cast<float4*>(Y + r * LDA + n) =
        keep ? make_float4(x.x + (s.x + bb.x), x.y + (s.y + bb.y),
                           x.z + (s.z + bb.z), x.w + (s.w + bb.w))
             : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  tf32x3::consumers_sync();
  ln_tokens(a, t0, Y, nw);
  tf32x3::consumers_sync();
}

// A token stage on the tile of token rows t0.. (block y of tok 2 / tok 4).
template <int S>
__device__ void tok_program(Ctx& c, const Args& a, int t0, int y, float* A,
                            float* Y) {
  const bool cons = !c.prod;
  if (S == 0) {
    // block 1: self-attention of the tokens (no PE added, no residual),
    // q, k and v from `tok_qkv<0>`
    if (cons) {
      attn_core(a, t0, A);
      tf32x3::consumers_sync();
    }
    out_dense(c, a, t0, pk_l0sa_o, l0sa_o_b, A, 8, Y, nullptr, 0);
    if (cons) {
      tf32x3::consumers_sync();
      ln_tokens(a, t0, Y, n1l0_w);
      tf32x3::consumers_sync();
      rows_out(state(a, 0) + (size_t)t0 * C, Y);
      with_pe(a, t0, A, Y);
      tf32x3::consumers_sync();
    }
    head_dense(c, a, t0, pk_t2i1_q, t2i1_q_b, A, a.qh);
  } else if (S == 1 || S == 3 || S == 5) {
    // the token->image attention's out-projection, residual, LayerNorm
    const int prev = S == 1 ? 0 : S == 3 ? 2 : 4;
    const float* st = state(a, prev) + (size_t)t0 * C;
    if (cons) {
      rows_in(a, t0, A, a.att, CD, CD);
      tf32x3::cp_async_wait_all();
      tf32x3::consumers_sync();
    }
    out_dense(c, a, t0, S == 1 ? pk_t2i1_o : S == 3 ? pk_t2i_o : pk_fin_o,
              S == 1 ? t2i1_o_b : S == 3 ? t2i_o_b : fin_o_b, A, 4, Y, st,
              C);
    if (cons) {
      tf32x3::consumers_sync();
      ln_tokens(a, t0, Y, S == 1 ? n2l0_w : S == 3 ? n2_w : nf_w);
      tf32x3::consumers_sync();
      if (S < 5) {
        rows_out(state(a, S) + (size_t)t0 * C, Y);
      } else {
        for (int i = tf32x3::tid(); i < TR * C; i += CONSUMERS) {
          const int r = i / C, n = i % C, row = t0 + r;
          if (valid(a, t0, r))
            a.tok_out[((size_t)(row >> 3) * a.T + (row & 7)) * C + n] =
                Y[r * LDA + n];
        }
      }
    }
  } else {
    // S == 2 / 4: the MLP's partials summed, LayerNorm; then the update's
    // token side (y = 0) or block 2's self-attention and the next query /
    // the final query (y = 1)
    const bool l0 = S == 2;
    if (cons)
      mlp_sum_ln(a, t0, Y, state(a, S - 1) + 0, l0 ? mlp2l0_b : mlp2_b,
                 l0 ? n3l0_w : n3_w);
    if (y == 0) {
      if (l0)
        tok_update(c, a, t0, A, Y, pk_i2t1_k, i2t1_k_b, pk_i2t1_v, i2t1_v_b,
                   pk_i2t1_o);
      else
        tok_update(c, a, t0, A, Y, pk_i2t_k, i2t_k_b, pk_i2t_v, i2t_v_b,
                   pk_i2t_o);
      return;
    }
    if (l0) {
      // block 2's self-attention, q, k and v from `tok_qkv<1>`
      if (cons) {
        attn_core(a, t0, A);
        tf32x3::consumers_sync();
      }
      out_dense(c, a, t0, pk_l1sa_o, l1sa_o_b, A, 8, Y, Y, LDA);
      if (cons) {
        tf32x3::consumers_sync();
        ln_tokens(a, t0, Y, n1l1_w);
        tf32x3::consumers_sync();
      }
    }
    if (cons) {
      rows_out(state(a, S) + (size_t)t0 * C, Y);
      with_pe(a, t0, A, Y);
      tf32x3::consumers_sync();
    }
    head_dense(c, a, t0, l0 ? pk_t2i_q : pk_fin_q, l0 ? t2i_q_b : fin_q_b, A,
               a.qh);
  }
}

// Shared setup of a product kernel: the ring of `slots` at the aligned
// base, its barriers initialised, the wait for the kernel before; returns
// the base.
__device__ __forceinline__ unsigned char* product_block(unsigned char* raw,
                                                        int bar_off,
                                                        int slots, Ctx& c) {
  const uint32_t r = tf32x3::smem_u32(raw);
  const uint32_t base = (r + 1023u) & ~1023u;
  c.ring = Ring{base, base + bar_off, base + bar_off + 8 * slots, 0,
                (uint32_t)slots};
  c.prod = threadIdx.x == CONSUMERS;
  c.wg = threadIdx.x >> 7;
  if (threadIdx.x == 0) {
    tf32x3::ring_init(c.ring);
    tf32x3::mbar_init_fence();
  }
  __syncthreads();
  tf32x3::grid_wait();
  tf32x3::grid_launch_next();
  return raw + (base - r);
}

template <int S>
__global__ void __launch_bounds__(THREADS, 1) tok_stage(Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  Ctx c;
  unsigned char* sm = product_block(smem_raw, TOK_BAR, TOK_RING, c);
  if (threadIdx.x >= CONSUMERS && !c.prod) return;
  tok_program<S>(c, a, blockIdx.x * TR, blockIdx.y,
                 reinterpret_cast<float*>(sm + TOK_A),
                 reinterpret_cast<float*>(sm + TOK_Y));
}

// A self-attention's q, k and v, a block each (blockIdx.y), into a.qkv:
// block 1's of the PE (L = 0); block 2's (L = 1) of x + PE (q, k) and x
// (v), x = LN(state + MLP) as tok 2 forms it.  Three blocks a tile, so
// that the three products do not wait for each other.
template <int L>
__global__ void __launch_bounds__(THREADS, 1) tok_qkv(Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  Ctx c;
  unsigned char* sm = product_block(smem_raw, TOK_BAR, TOK_RING, c);
  if (threadIdx.x >= CONSUMERS && !c.prod) return;
  float* A = reinterpret_cast<float*>(sm + TOK_A);
  float* Y = reinterpret_cast<float*>(sm + TOK_Y);
  const int t0 = blockIdx.x * TR, y = blockIdx.y;
  if (!c.prod) {
    if (L == 0) {
      pe_in(a, t0, A);
      tf32x3::cp_async_wait_all();
    } else {
      mlp_sum_ln(a, t0, Y, state(a, 1), mlp2l0_b, n3l0_w);
      if (y < 2) with_pe(a, t0, A, Y);
    }
    tf32x3::consumers_sync();
  }
  const int pq = L == 0 ? pk_l0sa_q : pk_l1sa_q;
  const int bq = L == 0 ? l0sa_q_b : l1sa_q_b;
  // q, k, v weights and biases follow each other in both enums
  qkv_dense(c, a, t0, pq + y, bq + 2 * y, L == 1 && y == 2 ? Y : A, C * y);
}

// The MLP of block L + 1, K-split: block (tile, j) computes the hidden
// columns 256 j.. of its tile, relu(x W1^T + b1), then their partial of
// the second product (no bias).
template <int L>
__global__ void __launch_bounds__(THREADS, 1) tok_mlp(Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  Ctx c;
  unsigned char* sm = product_block(smem_raw, TOK_BAR, TOK_RING, c);
  if (threadIdx.x >= CONSUMERS && !c.prod) return;
  float* A = reinterpret_cast<float*>(sm + TOK_A);
  float* Y = reinterpret_cast<float*>(sm + TOK_Y);
  const int t0 = blockIdx.x * TR, j = blockIdx.y;
  if (!c.prod) {
    rows_in(a, t0, A, state(a, L == 0 ? 1 : 3), C, C);
    tf32x3::cp_async_wait_all();
    tf32x3::consumers_sync();
  }
  const float* b1 = a.w[L == 0 ? mlp1l0_b : mlp1_b] + C * j;
  dense<4>(c, a.pk[L == 0 ? pk_mlp1l0 : pk_mlp1] + (size_t)16 * j * STAGE_BYTES,
           2, 8, A, LDA, [&](int r, int n, float v) {
    Y[r * LDA + n] = valid(a, t0, r) ? fmaxf(v + b1[n], 0.f) : 0.f;
  });
  if (!c.prod) tf32x3::consumers_sync();
  float* out = a.mlp + (size_t)j * a.P8 * TP * C + (size_t)t0 * C;
  dense<4>(c, a.pk[L == 0 ? pk_mlp2l0 : pk_mlp2] + (size_t)16 * j * STAGE_BYTES,
           2, 8, Y, LDA, [&](int r, int n, float v) {
    out[(size_t)r * C + n] = v;
  });
}

// The merged token->image attention: a thread a (prompt, head, token,
// dim), the (head, token)'s tiles in order, rescaled to their largest max.
template <int S>
__global__ void __launch_bounds__(256) t2i_merge(Args a) {
  tf32x3::grid_wait();
  tf32x3::grid_launch_next();
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= a.P * HT * HD) return;
  const int d = e % HD, t = (e / HD) % TP, h = (e / (HD * TP)) % H;
  const int p = e / (HD * HT);
  float* out = a.att + ((size_t)p * TP + t) * CD + h * HD + d;
  if (t >= a.T) {
    *out = 0.f;
    return;
  }
  const float* pp = a.part + (size_t)(p * HT + h * TP + t) * a.NT * PW;
  // The tiles' loads in batches of 16 (each thread's loads are
  // independent), the sums in tile order.
  float mx = -INFINITY;
  for (int i0 = 0; i0 < a.NT; i0 += 16) {
    float m[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      m[j] = i0 + j < a.NT ? pp[(i0 + j) * PW] : -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j) mx = fmaxf(mx, m[j]);
  }
  float num = 0.f, den = 0.f;
  for (int i0 = 0; i0 < a.NT; i0 += 16) {
    float m[16], l[16], v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const bool in = i0 + j < a.NT;
      const float* q = pp + (in ? i0 + j : 0) * PW;
      m[j] = in ? q[0] : -INFINITY;
      l[j] = q[1];
      v[j] = q[2 + d];
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float wgt = expf(m[j] - mx);
      num = fmaf(wgt, v[j], num);
      den = fmaf(wgt, l[j], den);
    }
  }
  *out = num / den;
}

// --------------------------------------------------------------------------
// row phases
// --------------------------------------------------------------------------

constexpr int LDQ = CD + 4;   // q / k / v rows
constexpr int LDP = HT + 4;   // P rows
constexpr int KT_HEAD = HD + 4;        // a head of the staged token keys
constexpr int KT_ROW = H * KT_HEAD;    // a token of them
// Shared memory of a row phase, bytes from the 1024-aligned base: the
// ring, the tile X (v takes its place once the wide product's last chunk
// has read it: [TR][LDQ]), q then k, P, the token keys.
constexpr int ROW_X = ROW_RING * STAGE_BYTES;          // [TR][LDA]
constexpr int ROW_Q = ROW_X + TR * LDA * 4;            // [TR][LDQ]: q, then k
constexpr int ROW_P = ROW_Q + TR * LDQ * 4;            // [TR][LDP]
constexpr int ROW_KT = ROW_P + TR * LDP * 4;           // [TP][KT_ROW] token keys
constexpr int ROW_QH = ROW_KT + TP * KT_ROW * 4;       // [TP][CD] query heads
constexpr int ROW_BAR = ROW_QH + TP * CD * 4;
constexpr int ROW_SMEM = ROW_BAR + 16 * ROW_RING + 1024;

// `rows` rows of `width` floats from src (row stride ld) into dst (row
// stride ldd) by cp.async; the caller waits.
__device__ void load_rows(float* dst, int ldd, const float* src, size_t ld,
                          int rows, int width) {
  const int per = width / 4;
  for (int i = tf32x3::tid(); i < rows * per; i += CONSUMERS) {
    const int r = i / per, q = i - r * per;
    tf32x3::cp_async16(dst + r * ldd + 4 * q, src + r * ld + 4 * q);
  }
}

// The tile's partial token->image softmax: four threads a (head, token),
// rows sub + 4 i; (max, sum, P V) of the 64 rows written to `part`.  qs:
// the prompt's query heads (TP x CD), staged in shared memory.
__device__ void row_partial(const Args& a, int p, int tile, const float* ks,
                            const float* vs, const float* qs) {
  const int pair = tf32x3::tid() >> 2, sub = tf32x3::tid() & 3;
  const int h = pair / TP, t = pair % TP;
  if (t >= a.T) return;        // the group's four lanes leave together
  const unsigned lane = tf32x3::tid() & 31;
  const unsigned group = 0xfu << (lane & ~3u);
  const float* qr = qs + t * CD + h * HD;
  float q[HD];
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    const float4 v = *reinterpret_cast<const float4*>(qr + d);
    q[d] = v.x;
    q[d + 1] = v.y;
    q[d + 2] = v.z;
    q[d + 3] = v.w;
  }
  // The max over the thread's 16 rows, then each row's score again (the
  // same operations, so the same value) for its exponential: no array of
  // scores is held.
  auto score = [&](int i) {
    const float4* kr =
        reinterpret_cast<const float4*>(ks + (sub + 4 * i) * LDQ + h * HD);
    float acc = 0.f;
#pragma unroll
    for (int d = 0; d < HD / 4; ++d) {
      const float4 k = kr[d];
      acc = fmaf(q[4 * d], k.x, acc);
      acc = fmaf(q[4 * d + 1], k.y, acc);
      acc = fmaf(q[4 * d + 2], k.z, acc);
      acc = fmaf(q[4 * d + 3], k.w, acc);
    }
    return acc * SCALE;
  };
  float mx = -INFINITY;
#pragma unroll 4
  for (int i = 0; i < TR / 4; ++i) mx = fmaxf(mx, score(i));
  mx = fmaxf(mx, __shfl_xor_sync(group, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(group, mx, 2));
  float l = 0.f, pv[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) pv[d] = 0.f;
#pragma unroll 4
  for (int i = 0; i < TR / 4; ++i) {
    const float e = expf(score(i) - mx);
    l += e;
    const float4* vr =
        reinterpret_cast<const float4*>(vs + (sub + 4 * i) * LDQ + h * HD);
#pragma unroll
    for (int d = 0; d < HD / 4; ++d) {
      const float4 v = vr[d];
      pv[4 * d] = fmaf(e, v.x, pv[4 * d]);
      pv[4 * d + 1] = fmaf(e, v.y, pv[4 * d + 1]);
      pv[4 * d + 2] = fmaf(e, v.z, pv[4 * d + 2]);
      pv[4 * d + 3] = fmaf(e, v.w, pv[4 * d + 3]);
    }
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

// The image update's probabilities: per row and head the softmax over the
// tokens of q . ktok / 4 (a thread a row and heads h, h + 4), into ps.  The
// token keys are staged a head to 20 floats (`KT_HEAD`), so that the four
// heads a quarter-warp reads fall on distinct banks.
__device__ void row_scores(const Args& a, const float* qs, const float* kt,
                           float* ps) {
  const int r = tf32x3::tid() >> 2;
  for (int hh = 0; hh < 2; ++hh) {
    const int h = (tf32x3::tid() & 3) + 4 * hh;
    float4 q[HD / 4];
#pragma unroll
    for (int d = 0; d < HD / 4; ++d)
      q[d] = *reinterpret_cast<const float4*>(qs + r * LDQ + h * HD + 4 * d);
    float s[TP];
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < TP; ++t) {
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < HD / 4; ++d) {
        const float4 k = *reinterpret_cast<const float4*>(
            kt + t * KT_ROW + h * KT_HEAD + 4 * d);
        acc = fmaf(q[d].x, k.x, acc);
        acc = fmaf(q[d].y, k.y, acc);
        acc = fmaf(q[d].z, k.z, acc);
        acc = fmaf(q[d].w, k.w, acc);
      }
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

// The part of the wide weight (0 k, 1 v, 2 q: its chunks) that row phase
// PHASE's ch-th product takes: row 1 q, k, v; row 2 k, v.  v comes last, so
// that it can take the tile's place.
__host__ __device__ constexpr int wide_chunk(int phase, int ch) {
  return phase == 1 ? (ch + 2) % 3 : ch;
}

template <int PHASE>
__global__ void __launch_bounds__(THREADS, 1) row_phase(Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  Ctx c;
  unsigned char* sm = product_block(smem_raw, ROW_BAR, ROW_RING, c);
  const int items = a.NT * a.P;
  const int nwide = PHASE == 1 ? 3 : 2;   // chunks of the wide product
  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: a prompt's folded values, then the wide weight ----
    if (c.prod && PHASE > 0) {
      const unsigned char* wide = a.pk[PHASE == 1 ? pk_wide2 : pk_widef];
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const unsigned char* u =
            a.ut + (size_t)(it / a.NT) * U_STAGES * STAGE_BYTES;
        for (int s = 0; s < U_STAGES; ++s)
          tf32x3::put(c.ring, u + (size_t)s * STAGE_BYTES);
        // the chunks in the consumers' order: (row 1) q, then k, then v
        for (int ch = 0; ch < nwide; ++ch)
          for (int s = 0; s < 8; ++s)
            tf32x3::put(c.ring, wide + (size_t)(8 * wide_chunk(PHASE, ch) + s) *
                                           STAGE_BYTES);
      }
    }
    return;
  }
  float* xs = reinterpret_cast<float*>(sm + ROW_X);
  float* qk = reinterpret_cast<float*>(sm + ROW_Q);
  float* vs = xs;
  float* ps = reinterpret_cast<float*>(sm + ROW_P);
  float* kt = reinterpret_cast<float*>(sm + ROW_KT);
  float* qt = reinterpret_cast<float*>(sm + ROW_QH);
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int tile = it % a.NT, p = it / a.NT;
    const size_t m0 = (size_t)tile * TR;
    tf32x3::consumers_sync();   // the last item's reads of the buffers
    if (PHASE == 0) {
      const size_t ir = image_row(a, p) + m0;
      load_rows(qk, LDQ, a.k1 + ir * CD, CD, TR, CD);
      load_rows(vs, LDQ, a.v1 + ir * CD, CD, TR, CD);
      load_rows(qt, CD, a.qh + (size_t)p * TP * CD, CD, TP, CD);
      tf32x3::cp_async_wait_all();
      tf32x3::consumers_sync();
      row_partial(a, p, tile, qk, vs, qt);
      continue;
    }
    // prev (keys0 of the prompt's image, or keys1), the image-side q (q1i
    // or q2i) and the update's token keys.
    const size_t pr = (size_t)p * a.M + m0;
    if (PHASE == 1) {
      const size_t ir = image_row(a, p) + m0;
      load_rows(xs, LDA, a.keys0 + ir * C, C, TR, C);
      load_rows(qk, LDQ, a.q1i + ir * CD, CD, TR, CD);
    } else {
      load_rows(xs, LDA, a.keys1 + pr * C, C, TR, C);
      load_rows(qk, LDQ, a.q2i + pr * CD, CD, TR, CD);
    }
    for (int i = tf32x3::tid(); i < TP * CD / 4; i += CONSUMERS) {
      const int t = i / (CD / 4), c = 4 * (i % (CD / 4));
      tf32x3::cp_async16(kt + t * KT_ROW + (c / HD) * KT_HEAD + c % HD,
                         a.ktok + ((size_t)p * TP + t) * CD + c);
    }
    load_rows(qt, CD, a.qh + (size_t)p * TP * CD, CD, TP, CD);
    tf32x3::cp_async_wait_all();
    tf32x3::consumers_sync();
    row_scores(a, qk, kt, ps);
    tf32x3::consumers_sync();
    // x = (prev + P U^T) + bo, in place.
    const float* bo = a.w[PHASE == 1 ? i2t1_o_b : i2t_o_b];
#pragma unroll 1
    for (int ch = 0; ch < 2; ++ch) {
      float acc[32];
      tf32x3::product<4>(c.ring, acc, ps, LDP, 2, true, c.wg);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = tf32x3::acc_row(i);
        const int n = 128 * ch + 64 * c.wg + tf32x3::acc_col(i);
        xs[r * LDA + n] = (xs[r * LDA + n] + acc[i]) + bo[n];
      }
    }
    tf32x3::consumers_sync();
    ln_rows(xs, a.w[PHASE == 1 ? n4l0_w : n4_w],
            a.w[PHASE == 1 ? n4l0_b : n4_b], true);
    tf32x3::consumers_sync();
    rows_out((PHASE == 1 ? a.keys1 : a.keys2) + pr * C, xs);
    // The wide product, chunk by chunk: (row 1) q2i to device memory, k
    // into qk, then v into the tile's place once both warpgroups have read
    // the tile for it.
    const float* kpe = a.w[PHASE == 1 ? kpe2 : kpef];
    const float* bv = a.w[PHASE == 1 ? bv2 : bvf];
#pragma unroll 1
    for (int ch = 0; ch < nwide; ++ch) {
      const int part = wide_chunk(PHASE, ch);   // 0 k, 1 v, 2 q
      float acc[32];
      tf32x3::product<4>(c.ring, acc, xs, LDA, 8, true, c.wg);
      // One loop a part, so that no branch stands between the loads.
      const int n0 = 64 * c.wg;
      if (part == 0) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = tf32x3::acc_row(i), n = n0 + tf32x3::acc_col(i);
          qk[r * LDQ + n] = acc[i] + kpe[(m0 + r) * CD + n];
        }
      } else if (part == 1) {
        tf32x3::consumers_sync();   // both warpgroups done with the tile
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = tf32x3::acc_row(i), n = n0 + tf32x3::acc_col(i);
          vs[r * LDQ + n] = acc[i] + bv[n];
        }
      } else {
        const float* qpe = a.w[qpe2i] + m0 * CD;
        float* q2 = a.q2i + pr * CD;
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = tf32x3::acc_row(i), n = n0 + tf32x3::acc_col(i);
          q2[r * CD + n] = acc[i] + qpe[r * CD + n];
        }
      }
    }
    tf32x3::consumers_sync();
    row_partial(a, p, tile, qk, vs, qt);
  }
}

// --------------------------------------------------------------------------
// host side
// --------------------------------------------------------------------------

// Byte offsets of the scratch buffers in one allocation (1024-aligned).
struct Layout {
  size_t keys1, q2i, state, qkv, mlp, att, qh, ktok, ut, part, total;
};

Layout layout(int P, int M) {
  const size_t p8 = (size_t)(P + 7) / 8 * 8, rows = p8 * TP;
  size_t at = 0;
  auto take = [&](size_t bytes) {
    const size_t off = at;
    at += (bytes + 1023) / 1024 * 1024;
    return off;
  };
  Layout l;
  l.keys1 = take((size_t)P * M * C * 4);
  l.q2i = take((size_t)P * M * CD * 4);
  l.state = take(5 * rows * C * 4);
  l.qkv = take(rows * 3 * C * 4);
  l.mlp = take(KSPLIT * rows * C * 4);
  l.att = take(rows * CD * 4);
  l.qh = take(rows * CD * 4);
  l.ktok = take(rows * CD * 4);
  l.ut = take(p8 * U_STAGES * STAGE_BYTES);
  l.part = take((size_t)P * HT * (M / TR) * PW * 4);
  l.total = at;
  return l;
}

// Launch `k` on `st`; with `follows`, as a programmatic dependent of the
// kernel before it on the stream.
cudaError_t launch(void (*k)(Args), dim3 grid, int threads, int smem,
                   cudaStream_t st, bool follows, const Args& a) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = at;
  cfg.numAttrs = follows ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, k, a);
}

cudaError_t configure() {
  static const cudaError_t status = [] {
    void (*tok[])(Args) = {tok_stage<0>, tok_stage<1>, tok_stage<2>,
                           tok_stage<3>, tok_stage<4>, tok_stage<5>,
                           tok_mlp<0>,   tok_mlp<1>,   tok_qkv<0>,
                           tok_qkv<1>};
    for (auto k : tok) {
      const cudaError_t e = cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize, TOK_SMEM);
      if (e != cudaSuccess) return e;
    }
    void (*rows[])(Args) = {row_phase<0>, row_phase<1>, row_phase<2>};
    for (auto k : rows) {
      const cudaError_t e = cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize, ROW_SMEM);
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  }();
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

// Bytes of the scratch allocation that `twoway_tail_f32_forward` takes for
// P prompts and M rows.
extern "C" long long twoway_tail_f32_scratch_bytes(int P, int M) {
  if (P <= 0 || M <= 0) return 0;
  return (long long)layout(P, M).total;
}

// keys0 (B, M, 256), q1i/k1/v1 (B, M, 128), tokens (P, T, 256), the
// N_PARAMS parameters (`params`, device pointers in `PARAM_NAMES` order)
// and the N_PACKED packed weights (`packed`, in `PACKED` order), all
// float32 and contiguous; img (P,) int32 or null; scratch of
// `twoway_tail_f32_scratch_bytes(P, M)` bytes.  Outputs keys2 (P, M, 256),
// tok_out (P, T, 256).  Returns a cudaError_t: cudaErrorInvalidValue for
// arguments the kernels do not take.
extern "C" int twoway_tail_f32_forward(
    const float* keys0, const float* q1i, const float* k1, const float* v1,
    const float* tokens, const void* const* params,
    const void* const* packed, float* keys2, float* tok_out, void* scratch,
    const int* img, int P, int T, int M, int B, int mlp, void* stream) {
  if (P <= 0 || P > 65535 || T < 2 || T > TP || M <= 0 || M % TR || B < 1 ||
      mlp != MLP || (img == nullptr && B != 1) ||
      (long long)P * (M / TR) > (1 << 30))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = configure();
  if (e != cudaSuccess) return (int)e;
  const Layout l = layout(P, M);
  unsigned char* s = static_cast<unsigned char*>(scratch);
  Args a;
  a.keys0 = keys0;
  a.q1i = q1i;
  a.k1 = k1;
  a.v1 = v1;
  a.img = img;
  a.tokens = tokens;
  a.keys2 = keys2;
  a.tok_out = tok_out;
  a.keys1 = reinterpret_cast<float*>(s + l.keys1);
  a.q2i = reinterpret_cast<float*>(s + l.q2i);
  a.state = reinterpret_cast<float*>(s + l.state);
  a.qkv = reinterpret_cast<float*>(s + l.qkv);
  a.mlp = reinterpret_cast<float*>(s + l.mlp);
  a.att = reinterpret_cast<float*>(s + l.att);
  a.qh = reinterpret_cast<float*>(s + l.qh);
  a.ktok = reinterpret_cast<float*>(s + l.ktok);
  a.ut = s + l.ut;
  a.part = reinterpret_cast<float*>(s + l.part);
  a.P = P;
  a.T = T;
  a.M = M;
  a.NT = M / TR;
  a.B = B;
  a.P8 = (P + 7) / 8 * 8;
  for (int i = 0; i < N_PARAMS; ++i)
    a.w[i] = static_cast<const float*>(params[i]);
  for (int i = 0; i < N_PACKED; ++i)
    a.pk[i] = static_cast<const unsigned char*>(packed[i]);
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int tiles = a.P8 / 8, items = a.NT * P;
  const dim3 rows(items < sm_count() ? items : sm_count());
  const dim3 merge((P * HT * HD + 255) / 256);
  struct Step {
    void (*k)(Args);
    dim3 grid;
    int threads, smem;
  };
  const Step steps[] = {
      {tok_qkv<0>, dim3(tiles, 3), THREADS, TOK_SMEM},
      {tok_stage<0>, dim3(tiles), THREADS, TOK_SMEM},
      {row_phase<0>, rows, THREADS, ROW_SMEM},
      {t2i_merge<0>, merge, 256, 0},
      {tok_stage<1>, dim3(tiles), THREADS, TOK_SMEM},
      {tok_mlp<0>, dim3(tiles, KSPLIT), THREADS, TOK_SMEM},
      {tok_qkv<1>, dim3(tiles, 3), THREADS, TOK_SMEM},
      {tok_stage<2>, dim3(tiles, 2), THREADS, TOK_SMEM},
      {row_phase<1>, rows, THREADS, ROW_SMEM},
      {t2i_merge<1>, merge, 256, 0},
      {tok_stage<3>, dim3(tiles), THREADS, TOK_SMEM},
      {tok_mlp<1>, dim3(tiles, KSPLIT), THREADS, TOK_SMEM},
      {tok_stage<4>, dim3(tiles, 2), THREADS, TOK_SMEM},
      {row_phase<2>, rows, THREADS, ROW_SMEM},
      {t2i_merge<2>, merge, 256, 0},
      {tok_stage<5>, dim3(tiles), THREADS, TOK_SMEM}};
  bool follows = false;
  for (const Step& st : steps) {
    e = launch(st.k, st.grid, st.threads, st.smem, cs, follows, a);
    if (e != cudaSuccess) return (int)e;
    follows = true;
  }
  return (int)cudaGetLastError();
}

// out[0] a token kernel's dynamic shared memory, out[1] a row phase's,
// out[2] / out[3] their blocks an SM.
extern "C" int twoway_tail_f32_occupancy(int* out) {
  cudaError_t e = configure();
  if (e != cudaSuccess) return (int)e;
  out[0] = TOK_SMEM;
  out[1] = ROW_SMEM;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], tok_stage<2>,
                                                    THREADS, out[0]);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[3], row_phase<1>, THREADS, out[1]);
}
