// Attention with SAM's decomposed relative-position bias (head dim 64, or 80
// for SAM ViT-H; bf16) for Hopper (sm_90a): TMA loads behind mbarriers, warp
// specialization and wgmma for every product.
//
// Replaces two TPU kernels of crowdsam_tpu/models/attention.py:
//   - `flash_mha_decomposed_relpos` (K3, SAM's 4 global blocks: 16 heads x
//     a 64x64 grid of tokens), through the library Pallas flash kernel;
//   - `window_attention_pallas` (K2, SAM's 20 window blocks: 25 windows of
//     14x14 tokens of a 70x70 padded grid, 16 heads).
// Both compute, per (batch or window, head),
//     O = softmax(scale q.k^T + fh[q, row(k)] + fw[q, col(k)]) v,
//     fh = q.Rh[row(q)], fw = q.Rw[col(q)],
// with f32 softmax and accumulation.  The TPU kernels fold the bias into
// the product by widening the head: q' = [q scale, fh, fw], k' = [k,
// onehot(row), onehot(col)].
//
// Bound.  K3: tensor-core operations (4 S^2 64 FLOP a head against 4 S 64
// 2 bytes: ~1000 FLOP/byte at S = 4096).  K2: memory (196 keys a window:
// ~100 FLOP/byte, below the card's ~295).
//
// Design: a block per (64-query tile, head, batch or window), two
// warpgroups as csrc/flash_sm90.cu (K4): a producer warpgroup (registers
// given away with setmaxnreg) of which one thread issues the TMA loads, and
// a consumer warpgroup that owns the 64 query rows: S = Q K^T by
// wgmma.m64n128k16 from shared memory, the online softmax in f32 registers
// (log2 domain), O += P V by wgmma.m64n64k16 with P packed from S's
// accumulators.  The bias costs no shared-memory lookup per score; it
// reaches the scores in one of three ways (the template's MODE):
//
//   GRID64 (K3 on a grid 64 wide: SAM's 64x64, the main path).  A block's
//     64 queries are one grid row r and a 128-key tile is two grid rows
//     2t and 2t+1.  fw[q, col(k)] goes through the tensor cores: QA =
//     fw / scale (the wrapper's one batched product, 64 dims a query)
//     against KA = onehot(col(k)) = onehot(k % 64), which is the same for
//     every tile and built once per block, so S = Q K^T + QA KA^T takes 4
//     more k-steps.  fh[q, row(k)] is one value per query row and tile
//     half: fh = Q Rh[r]^T is one m64n64k16 product per block (Rh[r] by
//     TMA), kept in shared memory, and the softmax adds fh[q, 2t] and
//     fh[q, 2t + 1] to the row maxima and exponents of its two halves
//     (two loads a row a tile).  Per score the SIMT work is K4's.
//   FOLD (K3 on any other grid up to 64x64).  The TPU kernels' fold, in
//     shared memory: QA = [fh | fw | 0] / scale in one or two 64-dim slabs,
//     built once per block from the wrapper's fh/fw; KA = [onehot(row(k)) |
//     onehot(col(k))], built by the consumer for each key tile; S = Q K^T +
//     QA KA^T takes 4 or 8 more k-steps, and the scale applies to the sum.
//   WINDOW (K2, its own kernel).  The same fold with everything inside the
//     kernel: a window's 196 keys and values come as one TMA box each from
//     the qkv projection, read in place through a 5-d tensor map {64,
//     heads, Wp, Hp, B} with box {64, 1, 14, 14, 1} (no partition copy);
//     the query tile comes by cp.async (64 tokens are not a box of the
//     window); the tables come by TMA as [ws][16][64] (rows past ws zero), so
//     Rh[x] is a 16-row tile, and G = Q R^T against seven such tiles is one
//     m64n112k16: each query row keeps the 16 columns of its own window
//     row (Rh) and column (Rw) by register selects, giving QA = [fh | fw];
//     the one-hot KA is the same for every window, built once per block.
//     Two tiles of 112 keys cover the window (keys from 196 on masked;
//     128-key tiles for windows of 15x15 and 16x16).
//
// Where this design can go wrong, and what it does about it:
//   1. Matching layouts: every tile is written as TMA's 128-byte swizzle
//      (16-byte chunk index XORed with row % 8, tiles 1024-byte aligned),
//      also the tiles the consumer writes itself (QA, KA, the cp.async
//      query tile; `sw128`).  A mismatch permutes dims inside a product.
//   2. Proxies: what the consumer writes with st.shared or cp.async is
//      read by wgmma (the async proxy) only after fence.proxy.async and a
//      barrier of the four consumer warps (named barrier 1).
//   3. mbarrier phases as in K4: stage s of tile i waits for parity (i /
//      STAGES) & 1; a stage is released (4 arrivals, one per consumer
//      warp) after the PV product that read its V has retired.  In WINDOW
//      mode Rw is loaded into the V buffer: the producer issues V's load
//      only after the four consumer warps have retired G = Q Rw^T
//      (`v_free`), which therefore comes before G = Q Rh^T.  A wait that
//      never completes traps.
//   4. Registers: `__launch_bounds__(256, 2)` caps a thread at 128, where
//      K4 already sits; fw kept in registers (32 f32 a thread) spilled and
//      made ptxas serialize the products, hence GRID64's fw in the product.
//      A wgmma issued under a runtime condition also serializes every
//      product of the kernel (ptxas C7520): the k-step counts and the
//      window's two tiles are constants, and selects replace branches.
//   5. Ragged edges: TMA fills rows past the tensor with zeros; keys from
//      the sequence's end on are masked to -inf in the last tile, whatever
//      the shared memory holds there; V rows past the window's last key are
//      zero in shared memory (P is 0 there, and 0 x NaN would not be);
//      query rows past the end are not stored.
//   6. A wrong grid row for the second half of a tile, fw one column off or
//      one-hot columns shifted by one: chip_smoke.py's K2/K3 phases hold
//      plain versions with each of those faults against the tolerance.
//
// Head dim 80 (SAM ViT-H: width 1280, 16 heads; the template's HD).  A
// token's 80 bf16 are 160 bytes: not one 128-byte swizzle atom, and TMA's
// 128-byte swizzle takes an inner box of at most 128 bytes.  Each operand is
// split into two slabs instead of being zero-padded to 128 dims in shared
// memory: dims 0-63 stay the 128-byte swizzled tile every helper above
// reads, and dims 64-79 come by a second TMA box (16 dims, the 32-byte
// swizzle) into a tile of 32-byte rows (`sm90.cuh`: `sw32`, layout type 3
// descriptors).  Q K^T takes 4 + 1 k-steps, P V one m64n16k16 beside the
// m64n64k16 (O: 32 + 8 f32 a thread), fh = Q Rh^T (K3 GRID64) and K2's
// G = Q R^T one k-step more; the bias terms and their fold do not depend on
// the head dim.  The split costs 25% more shared memory for Q, K, V and the
// tables, where the zero pad would cost 100% (every K/V stage two 16 KB
// tiles, of which 48 of 64 dims zeros, and 3 more k-steps of zeros a tile).
// Both head dims are instantiations of the same templates; the slab code is
// `if constexpr (HD == 80)`, so that the head-dim-64 kernels keep their
// code and layout.  With the slab the head-dim-80 blocks need more than
// half of the SM's shared memory, so one block runs a SM (two at 64).
#include "sm90.cuh"

namespace {

using namespace sm90;

enum Mode { GRID64 = 0, FOLD = 1 };   // K3's forms; K2 has its own kernel

constexpr int THREADS = 256;       // consumer warpgroup + producer warpgroup
constexpr int CONSUMER_WARPS = 4;
constexpr int Q_BYTES = BQ * ROW_BYTES;      // 8 KB: 64 rows
constexpr int TILE_BYTES = BK * ROW_BYTES;   // 16 KB: 128 rows
constexpr int MAX_GRID = 64;       // K3: h, w <= 64
constexpr int MAX_WINDOW = 16;     // K2: ws^2 <= 256 keys (two tiles)
constexpr int BLOCKS_PER_SM = 2;
constexpr int Q1_BYTES = BQ * ROW1_BYTES;    // 2 KB: the slab of 64 rows
constexpr int TILE1_BYTES = BK * ROW1_BYTES; // 4 KB: the slab of 128 rows
constexpr int TABLE1_BYTES = MAX_WINDOW * 16 * ROW1_BYTES;  // K2's Rh slab

// The tensor maps of the second slab (head dim 80), a kernel's last
// argument; an empty struct at head dim 64.
template <int HD>
struct SlabMaps {
  CUtensorMap a, b, c, d;
};
template <>
struct SlabMaps<64> {};

// Shared memory (bytes from the 1024-byte aligned base); the [slabs] of
// dims 64-79 exist at head dim 80 only.
//   GRID64: Q | [Q1] | QA (fw) | KA (128 keys) | fh (64 x 64 bf16) | [Rh1] |
//           K ring | [K1 ring] | V ring | [V1 ring] | barriers
//   FOLD:   Q | [Q1] | QA (2 slabs) | KA (2 slabs) | K ring | [K1 ring] |
//           V ring | [V1 ring] | barriers
//   WINDOW: Q | [Q1] | QA | KA (256 rows; holds Rh first) | K (the window's
//           rows, rounded to 8) | [K1] | V (256 rows; holds Rw first) |
//           [V1 (256 rows; holds Rw's slab first)] | [Rh1] | barriers
// A product over a window's second tile reads TK rows of K and KA: the
// rows past the window's keys are masked, whatever buffer they fall in.
template <int MODE, int HD>
struct Ring {                      // K3: GRID64, FOLD
  static constexpr bool WIDE = HD == D_WIDE;
  static constexpr int STAGES = 2;
  static constexpr int Q1 = Q_BYTES;
  static constexpr int QA = Q1 + (WIDE ? Q1_BYTES : 0);
  static constexpr int KA = QA + (MODE == FOLD ? 2 : 1) * Q_BYTES;
  static constexpr int FH = KA + (MODE == GRID64 ? 1 : 2) * TILE_BYTES;
  static constexpr int RH1 = FH + (MODE == GRID64 ? Q_BYTES : 0);
  static constexpr int K = RH1 + (MODE == GRID64 && WIDE ? Q1_BYTES : 0);
  static constexpr int K1 = K + STAGES * TILE_BYTES;
  static constexpr int V = K1 + (WIDE ? STAGES * TILE1_BYTES : 0);
  static constexpr int V1 = V + STAGES * TILE_BYTES;
  static constexpr int BAR = V1 + (WIDE ? STAGES * TILE1_BYTES : 0);
  static constexpr int N_BARS = 2 + 3 * STAGES;  // q, rh, full_k/v, empty
  static constexpr int SMEM = BAR + 8 * N_BARS + 1024;
};

// WINDOW layout for a window of `n` tokens.
struct WinLayout {
  int q1, qa, ka, k, k1, v, v1, rh1, bar, smem;
};
template <int HD>
__host__ __device__ inline WinLayout win_layout(int n) {
  constexpr bool WIDE = HD == D_WIDE;
  const int rows = ((n + 7) / 8) * 8;
  WinLayout w;
  w.q1 = Q_BYTES;
  w.qa = w.q1 + (WIDE ? Q1_BYTES : 0);
  w.ka = w.qa + Q_BYTES;
  w.k = w.ka + 2 * TILE_BYTES;
  w.k1 = w.k + rows * ROW_BYTES;
  w.v = w.k1 + (WIDE ? (rows * ROW1_BYTES + 1023) / 1024 * 1024 : 0);
  w.v1 = w.v + 2 * TILE_BYTES;
  w.rh1 = w.v1 + (WIDE ? 2 * TILE1_BYTES : 0);
  w.bar = w.rh1 + (WIDE ? TABLE1_BYTES : 0);
  w.smem = w.bar + 8 * 5 + 1024;   // k_full, v_full, rh_full, rw_full, v_free
  return w;
}

struct Params {
  __nv_bfloat16* o;
  long long obs, ohs, old;   // output strides: batch (image), head, token
  const __nv_bfloat16* fh;   // K3 FOLD: (B, H, S, rel_h), bf16, contiguous
  const __nv_bfloat16* fw;   // K3: FOLD (B, H, S, rel_w), contiguous;
  long long fw_sc, fw_sbh, fw_sr;  // GRID64: strides of a column, a
                             // (batch, head) and a grid row (64 j a row)
  const __nv_bfloat16* qkv;  // K2: the projection (B, Hp, Wp, 3 dim)
  int seq, heads;
  int rel_h, rel_w;          // K3: the grid; K2: the window twice
  float scale_log2;          // softmax scale * log2(e)
  float inv_scale;           // the folded bias terms are divided by scale
  int pos[3][3];             // K3: q/k/v map dims of (head, token, batch)
  int hp, wp, dim, nwh, nww; // K2: padded grid, channels of q, windows
};

// A 16-byte chunk of 8 bf16, element i = 1 where 8 * chunk + i is `a` or
// `b`, else 0.
__device__ __forceinline__ void onehot_chunk(uint32_t addr, int chunk, int a,
                                             int b) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e0 = 8 * chunk + 2 * i, e1 = e0 + 1;
    const uint32_t lo = (e0 == a || e0 == b) ? 0x3F80u : 0u;   // bf16 1.0
    const uint32_t hi = (e1 == a || e1 == b) ? 0x3F80u : 0u;
    w[i] = lo | (hi << 16);
  }
  st_shared_v4(addr, w[0], w[1], w[2], w[3]);
}

// S += QA KA^T: NKA k-steps of 16 dims over slabs of 64 dims (QA slabs
// Q_BYTES apart, KA slabs `ka_slab` bytes apart).  The count is a constant
// (dims past the bias terms are zero on both sides): a wgmma issued under
// a condition would make ptxas serialize every product of the kernel.
template <int NKA, int NSC>
__device__ __forceinline__ void issue_fold(float (&sc)[NSC], uint32_t qa,
                                           uint32_t ka, int ka_slab) {
#pragma unroll
  for (int kk = 0; kk < NKA; ++kk)
    wgmma_scores(sc, kmajor_desc(qa + (kk >> 2) * Q_BYTES + (kk & 3) * 32),
                 kmajor_desc(ka + (kk >> 2) * ka_slab + (kk & 3) * 32), 1);
}

// The low (c = 0) or high (c = 1) bf16 of a pair, as f32.
__device__ __forceinline__ float bf16_half(uint32_t pair, int c) {
  return __uint_as_float(c == 0 ? pair << 16 : pair & 0xFFFF0000u);
}

// Store the consumer's normalized O rows; `dst(row)` gives a row's output
// pointer or nullptr for a row that is not stored.
template <typename Dst>
__device__ __forceinline__ void store_rows(const float (&o)[32], float (&l)[2],
                                           int warp, int lane, Dst dst) {
  const int t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
    __nv_bfloat16* out = dst(warp * 16 + (lane >> 2) + 8 * r);
    if (out == nullptr) continue;
    const float inv = 1.f / l[r];
    out += 2 * t4;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
  }
}

// `store_rows` at head dim 80: dims 0-63 from o, 64-79 from o1.
template <typename Dst>
__device__ __forceinline__ void store_rows_wide(const float (&o)[32],
                                                const float (&o1)[8],
                                                float (&l)[2], int warp,
                                                int lane, Dst dst) {
  const int t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
    __nv_bfloat16* out = dst(warp * 16 + (lane >> 2) + 8 * r);
    if (out == nullptr) continue;
    const float inv = 1.f / l[r];
    out += 2 * t4;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      *reinterpret_cast<uint32_t*>(out + D + 8 * j) =
          pack_bf16(o1[4 * j + 2 * r] * inv, o1[4 * j + 2 * r + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// K3: GRID64 and FOLD
// ---------------------------------------------------------------------------

// NSLAB: FOLD's 64-dim slabs of [fh | fw] (h + w <= 64 * NSLAB).  HD: the
// head dim, 64 or 80 (`m`: the maps of dims 64-79 of q, k, v and Rh).
template <int MODE, int NSLAB, int HD>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
flash_attn_relpos(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_rh, const Params p,
                  const __grid_constant__ SlabMaps<HD> m) {
  using L = Ring<MODE, HD>;
  constexpr bool WIDE = L::WIDE;
  constexpr int STAGES = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sqa = base + L::QA, ska = base + L::KA;
  const uint32_t sfh = base + L::FH, sk = base + L::K, sv = base + L::V;
  const uint32_t sq1 = base + L::Q1, srh1 = base + L::RH1;
  const uint32_t sk1 = base + L::K1, sv1 = base + L::V1;
  const uint32_t q_full = base + L::BAR, rh_full = q_full + 8;
  const uint32_t full_k = rh_full + 8;                // [STAGES]
  const uint32_t full_v = full_k + 8 * STAGES;        // [STAGES]
  const uint32_t empty = full_v + 8 * STAGES;         // [STAGES]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int n_tiles = (p.seq + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(rh_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_proxy_async();
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {
    // ---- producer warpgroup: one thread keeps the K/V ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == CONSUMER_WARPS && lane == 0) {
      prefetch_map(&tm_q);
      prefetch_map(&tm_k);
      prefetch_map(&tm_v);
      mbar_expect_tx(q_full, Q_BYTES + (WIDE ? Q1_BYTES : 0));
      load_bhsd(sq, &tm_q, q_full, p.pos[0], h, q0, b);
      if constexpr (WIDE) load_bhsd1(sq1, &m.a, q_full, p.pos[0], h, q0, b);
      if (MODE == GRID64) {
        // The block's 64 queries are grid row blockIdx.x: Rh[row] (64 j
        // x 64 dims, rows past the table's end zero).
        mbar_expect_tx(rh_full, Q_BYTES + (WIDE ? Q1_BYTES : 0));
        tma_load_2d(sfh, &tm_rh, rh_full, 0, blockIdx.x * p.rel_h);
        if constexpr (WIDE)
          tma_load_2d(srh1, &m.d, rh_full, D, blockIdx.x * p.rel_h);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(full_k + 8 * s, TILE_BYTES + (WIDE ? TILE1_BYTES : 0));
        load_bhsd(sk + s * TILE_BYTES, &tm_k, full_k + 8 * s, p.pos[1], h,
                  it * BK, b);
        if constexpr (WIDE)
          load_bhsd1(sk1 + s * TILE1_BYTES, &m.b, full_k + 8 * s, p.pos[1],
                     h, it * BK, b);
        mbar_expect_tx(full_v + 8 * s, TILE_BYTES + (WIDE ? TILE1_BYTES : 0));
        load_bhsd(sv + s * TILE_BYTES, &tm_v, full_v + 8 * s, p.pos[2], h,
                  it * BK, b);
        if constexpr (WIDE)
          load_bhsd1(sv1 + s * TILE1_BYTES, &m.c, full_v + 8 * s, p.pos[2],
                     h, it * BK, b);
      }
    }
    return;
  }

  // ---- consumer warpgroup: 64 query rows ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int t4 = lane & 3;
  const int rh = p.rel_h, rw = p.rel_w;
  const long long bh = (long long)b * p.heads + h;
  float o[32], sc[NS], alpha[2];
  float o1[8];                    // head dim 80: O's dims 64-79
  uint32_t pa[NP][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) o1[i] = 0.f;
  float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // GRID64: QA = fw / scale (a 64-dim slab), KA = onehot(col(k)) =
  // onehot(k % 64), the same for every tile, and fh = Q Rh[row]^T (0 past
  // the grid's h rows), all once per block.
  if constexpr (MODE == GRID64) {
    const __nv_bfloat16* fw_row =
        p.fw + bh * p.fw_sbh + (long long)blockIdx.x * p.fw_sr;
    for (int e = tid; e < BQ * 8; e += 128) {
      const int i = e >> 3, ch = e & 7;
      const uint4 raw = *reinterpret_cast<const uint4*>(
          fw_row + i * p.fw_sc + ch * 8);
      const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
      uint32_t w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        w[u] = pack_bf16(bf16_half(in[u], 0) * p.inv_scale,
                         bf16_half(in[u], 1) * p.inv_scale);
      st_shared_v4(sqa + sw128(i, ch), w[0], w[1], w[2], w[3]);
    }
    for (int e = tid; e < BK * 8; e += 128)
      onehot_chunk(ska + sw128(e >> 3, e & 7), e & 7, (e >> 3) % MAX_GRID, -1);
    fence_proxy_async();
    float fh[32];
    mbar_wait(q_full, 0);
    mbar_wait(rh_full, 0);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_ss(fh, kmajor_desc(sq + kk * 32),
                         kmajor_desc(sfh + kk * 32), kk > 0 ? 1 : 0);
    if constexpr (WIDE)
      wgmma_m64n64k16_ss(fh, kmajor32_desc(sq1), kmajor32_desc(srh1), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(fh);
    named_bar(1, 128);     // every warp's product has read Rh[row]
    // fh over Rh[row], row-major bf16 pairs: (i, 2 jp) at i * 128 + 4 jp.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = warp * 16 + (lane >> 2) + 8 * r;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * jj + 2 * t4;
        st_shared_u32(sfh + i * ROW_BYTES + 2 * j,
                      j < rh ? pack_bf16(fh[4 * jj + 2 * r],
                                         fh[4 * jj + 2 * r + 1])
                             : 0u);
      }
    }
    named_bar(1, 128);
  }
  // FOLD: QA = [fh | fw | 0] / scale, NSLAB 64-dim slabs.
  if constexpr (MODE == FOLD) {
    for (int e = tid; e < NSLAB * BQ * 8; e += 128) {
      const int s = e / (BQ * 8), i = (e / 8) % BQ, ch = e % 8;
      const int q = q0 + i;
      uint32_t w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float v[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int d = 64 * s + 8 * ch + 2 * u + c;
          v[c] = 0.f;
          if (q < p.seq) {
            const long long row = bh * p.seq + q;
            if (d < rh) v[c] = __bfloat162float(p.fh[row * rh + d]);
            else if (d < rh + rw)
              v[c] = __bfloat162float(p.fw[row * rw + d - rh]);
          }
        }
        w[u] = pack_bf16(v[0] * p.inv_scale, v[1] * p.inv_scale);
      }
      st_shared_v4(sqa + s * Q_BYTES + sw128(i, ch), w[0], w[1], w[2], w[3]);
    }
  }

  if constexpr (MODE == FOLD) mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const uint32_t par = (it / STAGES) & 1;
    // GRID64: the tile's two grid rows 2 it and 2 it + 1 give each query
    // row one fh a tile half (two loads a row a tile, none a score).
    float off[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    if constexpr (MODE == GRID64) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = warp * 16 + (lane >> 2) + 8 * r;
        const uint32_t pair = ld_shared_u32(sfh + i * ROW_BYTES + 4 * it);
        off[r][0] = LOG2E * bf16_half(pair, 0);
        off[r][1] = LOG2E * bf16_half(pair, 1);
      }
    }
    if constexpr (MODE == FOLD) {
      // KA for this tile's keys, once the last tile's product has read it:
      // a thread a key row.
      named_bar(1, 128);
      const int key = it * BK + tid;
      const int a = key < p.seq ? key / rw : -1;
      const int c = key < p.seq ? rh + key % rw : -1;
#pragma unroll
      for (int s2 = 0; s2 < NSLAB; ++s2)
#pragma unroll
        for (int ch = 0; ch < 8; ++ch)
          onehot_chunk(ska + s2 * TILE_BYTES + sw128(tid, ch), ch, a - 64 * s2,
                       c - 64 * s2);
      fence_proxy_async();
      named_bar(1, 128);
    }
    mbar_wait(full_k + 8 * s, par);
    wgmma_fence();
    issue_qk(sc, sq, sk + s * TILE_BYTES, false);
    if constexpr (WIDE) issue_qk_slab1(sc, sq1, sk1 + s * TILE1_BYTES);
    if constexpr (MODE == GRID64) issue_fold<4>(sc, sqa, ska, 0);
    if constexpr (MODE == FOLD)
      issue_fold<4 * NSLAB>(sc, sqa, ska, TILE_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    softmax_tile(sc, pa, mx, l, alpha, p.seq - it * BK, t4, p.scale_log2,
                 off);
    rescale(o, alpha);
    if constexpr (WIDE) rescale8(o1, alpha);
    mbar_wait(full_v + 8 * s, par);
    wgmma_fence();
    issue_pv(o, pa, sv + s * TILE_BYTES);
    if constexpr (WIDE) issue_pv_slab1(o1, pa, sv1 + s * TILE1_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if constexpr (WIDE) fence_regs(o1);
    fence_regs(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  auto dst = [&](int i) -> __nv_bfloat16* {
    const int q = q0 + i;
    if (q >= p.seq) return nullptr;
    return p.o + (long long)b * p.obs + (long long)h * p.ohs +
           (long long)q * p.old;
  };
  if constexpr (WIDE) store_rows_wide(o, o1, l, warp, lane, dst);
  else store_rows(o, l, warp, lane, dst);
}

// ---------------------------------------------------------------------------
// K2: WINDOW
// ---------------------------------------------------------------------------

// TK: keys of a score tile, 112 (two tiles cover a 14x14 window with 28
// keys masked) or 128 (windows of up to 16x16).  HD: the head dim, 64 or
// 80 (`m`: the maps of dims 64-79 of k, v, Rh and Rw).
template <int TK, int HD>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
window_attn_relpos(const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_rh,
                   const __grid_constant__ CUtensorMap tm_rw,
                   const Params p, const __grid_constant__ SlabMaps<HD> m) {
  constexpr bool WIDE = HD == D_WIDE;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int ws = p.rel_w, n = ws * ws;
  const WinLayout lay = win_layout<HD>(n);
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sqa = base + lay.qa, ska = base + lay.ka;
  const uint32_t sk = base + lay.k, sv = base + lay.v;
  const uint32_t sq1 = base + lay.q1, sk1 = base + lay.k1;
  const uint32_t sv1 = base + lay.v1, srh1 = base + lay.rh1;
  const uint32_t k_full = base + lay.bar, v_full = k_full + 8;
  const uint32_t rh_full = v_full + 8, rw_full = rh_full + 8;
  const uint32_t v_free = rw_full + 8;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int per_img = p.nwh * p.nww;
  const int img = blockIdx.z / per_img, wy = (blockIdx.z % per_img) / p.nww,
            wx = blockIdx.z % p.nww;
  const int box_bytes = n * (ROW_BYTES + (WIDE ? ROW1_BYTES : 0));
  const int table_bytes = ws * 16 * (ROW_BYTES + (WIDE ? ROW1_BYTES : 0));

  if (tid == 0) {
    mbar_init(k_full, 1);
    mbar_init(v_full, 1);
    mbar_init(rh_full, 1);
    mbar_init(rw_full, 1);
    mbar_init(v_free, CONSUMER_WARPS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_proxy_async();
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {
    // ---- producer: the tables, the window's keys, then its values ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == CONSUMER_WARPS && lane == 0) {
      prefetch_map(&tm_k);
      prefetch_map(&tm_v);
      mbar_expect_tx(rw_full, table_bytes);
      tma_load_3d(sv, &tm_rw, rw_full, 0, 0, 0);
      if constexpr (WIDE) tma_load_3d(sv1, &m.d, rw_full, D, 0, 0);
      mbar_expect_tx(rh_full, table_bytes);
      tma_load_3d(ska, &tm_rh, rh_full, 0, 0, 0);
      if constexpr (WIDE) tma_load_3d(srh1, &m.c, rh_full, D, 0, 0);
      mbar_expect_tx(k_full, box_bytes);
      tma_load_5d(sk, &tm_k, k_full, 0, h, wx * ws, wy * ws, img);
      if constexpr (WIDE)
        tma_load_5d(sk1, &m.a, k_full, D, h, wx * ws, wy * ws, img);
      mbar_wait(v_free, 0);
      mbar_expect_tx(v_full, box_bytes);
      tma_load_5d(sv, &tm_v, v_full, 0, h, wx * ws, wy * ws, img);
      if constexpr (WIDE)
        tma_load_5d(sv1, &m.b, v_full, D, h, wx * ws, wy * ws, img);
    }
    return;
  }

  // ---- consumer warpgroup: 64 of the window's query tokens ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int t4 = lane & 3;
  const long long tok_ld = 3LL * p.dim;              // qkv token stride
  const __nv_bfloat16* qkv_img =
      p.qkv + (long long)img * p.hp * p.wp * tok_ld + h * HD;
  auto pixel = [&](int t) {                          // window token -> pixel
    return (long long)(wy * ws + t / ws) * p.wp + wx * ws + t % ws;
  };

  // The query tile (cp.async, swizzled, zeros past the window).
  for (int e = tid; e < BQ * 8; e += 128) {
    const int i = e >> 3, ch = e & 7, t = q0 + i;
    const __nv_bfloat16* src =
        t < n ? qkv_img + pixel(t) * tok_ld + ch * 8 : p.qkv;
    cp_async16(sq + sw128(i, ch), src, t < n ? 16 : 0);
  }
  if constexpr (WIDE) {           // dims 64-79: two chunks a row
    for (int e = tid; e < BQ * 2; e += 128) {
      const int i = e >> 1, ch = e & 1, t = q0 + i;
      const __nv_bfloat16* src =
          t < n ? qkv_img + pixel(t) * tok_ld + D + ch * 8 : p.qkv;
      cp_async16(sq1 + sw32(i, ch), src, t < n ? 16 : 0);
    }
  }
  cp_async_wait_all();
  fence_proxy_async();
  named_bar(1, 128);

  // fh and fw.  The tables sit in shared memory as [ws][16][64] (TMA
  // fills rows j >= ws with zeros), so Rh[r] is a 16-row B tile at 2048 r.
  // G = Q R^T against GB = 7 such tiles at once (m64n112k16): for the
  // window rows x that the tile's queries span, each query row of row x
  // keeps its 16 columns of Rh[x]; for every window column x likewise of
  // Rw[x].  A thread ends with 4 values of fh and 4 of fw for each of its
  // two rows, in registers, with no condition around any product: then
  // QA = [fh | 0 | fw | 0] / scale, fh at dims 0-15 and fw at 16-31.
  constexpr int GB = 7;
  constexpr int TABLE_TILES = 2 * BK / 16;   // 16-row tiles a buffer holds
  float qa_h[2][4], qa_w[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int u = 0; u < 4; ++u) qa_h[r][u] = qa_w[r][u] = 0.f;
  int row_of[2], col_of[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + warp * 16 + (lane >> 2) + 8 * r;
    row_of[r] = t < n ? t / ws : -1;      // rows past the window keep 0
    col_of[r] = t < n ? t % ws : -1;
  }
  const int r_lo = q0 / ws;
  const int r_hi = min(ws - 1, (q0 + BQ - 1) / ws);
  // Rw first: V loads over it while the Rh products run.
#pragma unroll
  for (int tab = 0; tab < 2; ++tab) {
    mbar_wait(tab == 0 ? rw_full : rh_full, 0);
    const int lo = tab == 0 ? 0 : r_lo, hi = tab == 0 ? ws - 1 : r_hi;
    const uint32_t table = tab == 0 ? sv : ska;
    const uint32_t table1 = tab == 0 ? sv1 : srh1;   // dims 64-79 (HD 80)
    for (int x0 = lo; x0 <= hi; x0 += GB) {
      // The last batch of a large window starts early so as to stay in
      // the buffer (tiles past the table are never kept).
      const int xs = min(x0, TABLE_TILES - GB);
      float g[GB * 8];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n112k16_ss(g, kmajor_desc(sq + kk * 32),
                            kmajor_desc(table + xs * 2048 + kk * 32),
                            kk > 0 ? 1 : 0);
      if constexpr (WIDE)
        wgmma_m64n112k16_ss(g, kmajor32_desc(sq1),
                            kmajor32_desc(table1 + xs * 16 * ROW1_BYTES), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(g);
#pragma unroll
      for (int b = 0; b < GB; ++b)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const bool mine = (tab == 0 ? col_of[r] : row_of[r]) == xs + b;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            // g[4 jj + 2 r + c]: row r, column 8 jj + 2 t4 + c, where
            // column 16 b + 8 (u / 2) + 2 t4 + (u % 2) is jj = 2 b + u / 2
            const float v = g[8 * b + 4 * (u >> 1) + 2 * r + (u & 1)];
            if (tab == 0) qa_w[r][u] = mine ? v : qa_w[r][u];
            else qa_h[r][u] = mine ? v : qa_h[r][u];
          }
        }
    }
    if (tab == 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(v_free);   // Rw read: V may load over it
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = warp * 16 + (lane >> 2) + 8 * r;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int d = 8 * jj + 2 * t4;
      st_shared_u32(sqa + sw128(i, d >> 3) + (d & 7) * 2,
                    pack_bf16(qa_h[r][2 * jj] * p.inv_scale,
                              qa_h[r][2 * jj + 1] * p.inv_scale));
      st_shared_u32(sqa + sw128(i, 2 + (d >> 3)) + (d & 7) * 2,
                    pack_bf16(qa_w[r][2 * jj] * p.inv_scale,
                              qa_w[r][2 * jj + 1] * p.inv_scale));
    }
  }

  // KA: the one-hot rows and columns of the window's keys (over Rh), and
  // V's rows past the window zeroed (over Rw; V loads into the rows before).
  named_bar(1, 128);
  for (int e = n * 8 + tid; e < 2 * BK * 8; e += 128)
    st_shared_v4(sv + (e >> 3) * ROW_BYTES + ((e & 7) << 4), 0u, 0u, 0u, 0u);
  if constexpr (WIDE)
    for (int e = n * 2 + tid; e < 2 * BK * 2; e += 128)
      st_shared_v4(sv1 + (e >> 1) * ROW1_BYTES + ((e & 1) << 4), 0u, 0u, 0u,
                   0u);
  for (int e = tid; e < n * 4; e += 128) {    // dims 0-31: two k-steps
    const int key = e >> 2, ch = e & 3;
    onehot_chunk(ska + sw128(key, ch), ch, key / ws, 16 + key % ws);
  }
  fence_proxy_async();
  named_bar(1, 128);

  float o[32], alpha[2];
  float o1[8];                    // head dim 80: O's dims 64-79
  uint32_t pa[TK / 16][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) o1[i] = 0.f;
  float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // Two key tiles (a window of up to TK keys has its second tile all
  // masked: it leaves O and the running sums as they were).
  float sc[TK / 2];
  mbar_wait(k_full, 0);
#pragma unroll
  for (int tt = 0; tt < 2; ++tt) {
    const uint32_t rows = tt * TK * ROW_BYTES;   // the tile's first key
    const uint32_t rows1 = tt * TK * ROW1_BYTES;
    wgmma_fence();
    issue_qk(sc, sq, sk + rows, false);
    if constexpr (WIDE) issue_qk_slab1(sc, sq1, sk1 + rows1);
    issue_fold<2>(sc, sqa, ska + rows, 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    const float no_off[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    softmax_tile(sc, pa, mx, l, alpha, n - tt * TK, t4, p.scale_log2,
                 no_off);
    rescale(o, alpha);
    if constexpr (WIDE) rescale8(o1, alpha);
    if (tt == 0) mbar_wait(v_full, 0);
    wgmma_fence();
    issue_pv(o, pa, sv + rows);
    if constexpr (WIDE) issue_pv_slab1(o1, pa, sv1 + rows1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if constexpr (WIDE) fence_regs(o1);
    fence_regs(pa);
  }

  __nv_bfloat16* out_img = p.o + (long long)img * p.obs + h * p.ohs;
  auto dst = [&](int i) -> __nv_bfloat16* {
    const int t = q0 + i;
    return t < n ? out_img + pixel(t) * p.old : nullptr;
  };
  if constexpr (WIDE) store_rows_wide(o, o1, l, warp, lane, dst);
  else store_rows(o, l, warp, lane, dst);
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// K3's launch at head dim HD; maps[4..7] are the second slab's (HD 80).
template <int HD>
int global_launch(const CUtensorMap* maps, const Params& p, int batch,
                  int heads, int mode, cudaStream_t st) {
  using G = Ring<GRID64, HD>;
  using F = Ring<FOLD, HD>;
  static const cudaError_t attr[3] = {
      allow_smem(flash_attn_relpos<GRID64, 1, HD>, G::SMEM),
      allow_smem(flash_attn_relpos<FOLD, 1, HD>, F::SMEM),
      allow_smem(flash_attn_relpos<FOLD, 2, HD>, F::SMEM)};
  for (cudaError_t e : attr)
    if (e != cudaSuccess) return (int)e;
  SlabMaps<HD> m;
  if constexpr (HD == D_WIDE) m = {maps[4], maps[5], maps[6], maps[7]};
  if (batch > 0 && heads > 0) {
    const dim3 grid((p.seq + BQ - 1) / BQ, heads, batch);
    if (mode == GRID64)
      flash_attn_relpos<GRID64, 1, HD><<<grid, THREADS, G::SMEM, st>>>(
          maps[0], maps[1], maps[2], maps[3], p, m);
    else if (p.rel_h + p.rel_w <= D)
      flash_attn_relpos<FOLD, 1, HD><<<grid, THREADS, F::SMEM, st>>>(
          maps[0], maps[1], maps[2], maps[3], p, m);
    else
      flash_attn_relpos<FOLD, 2, HD><<<grid, THREADS, F::SMEM, st>>>(
          maps[0], maps[1], maps[2], maps[3], p, m);
  }
  return (int)cudaGetLastError();
}

// K2's launch at head dim HD; maps[4..7] are the second slab's (HD 80).
template <int HD>
int window_launch(const CUtensorMap* maps, const Params& p, int batch,
                  int heads, cudaStream_t st) {
  const int smem = win_layout<HD>(MAX_WINDOW * MAX_WINDOW).smem;
  static const cudaError_t attr[2] = {
      allow_smem(window_attn_relpos<112, HD>, smem),
      allow_smem(window_attn_relpos<BK, HD>, smem)};
  for (cudaError_t e : attr)
    if (e != cudaSuccess) return (int)e;
  SlabMaps<HD> m;
  if constexpr (HD == D_WIDE) m = {maps[4], maps[5], maps[6], maps[7]};
  const int n = p.seq;
  if (batch > 0 && heads > 0) {
    const dim3 grid((n + BQ - 1) / BQ, heads, batch * p.nwh * p.nww);
    if (n <= 2 * 112)
      window_attn_relpos<112, HD><<<grid, THREADS, win_layout<HD>(n).smem,
                                    st>>>(maps[0], maps[1], maps[2], maps[3],
                                          p, m);
    else
      window_attn_relpos<BK, HD><<<grid, THREADS, win_layout<HD>(n).smem,
                                   st>>>(maps[0], maps[1], maps[2], maps[3],
                                         p, m);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K3. q, k, v: (B, H, S, hd) bf16 operands, hd = head_dim (64 or 80), S =
// rel_h * rel_w, with their tensor-map layouts (`layouts`: 3 x 14 int64, q
// then k then v, each with dims[0] = hd and a box of 64 dims); rh_table:
// the (rel_h, rel_h, hd) bf16 table, contiguous.  FOLD: fh/fw contiguous
// (B, H, S, rel_h) / (B, H, S, rel_w) bf16.  GRID64: fh unused (formed in
// the kernel); fw (64 j contiguous) at column c, (batch, head) bh and grid
// row r at c fw_strides[0] + bh fw_strides[1] + r fw_strides[2]; o: the
// output, strides `o_strides` (batch, head, token; elements).  `mode`: 0
// (GRID64, a grid 64 wide only) or 1 (FOLD, any grid).  At head dim 80
// fh/fw come already divided by `scale` (at 64 the kernel divides, x8
// being exact).  Returns
// cudaGetLastError(), or -1 when the CUDA driver has no
// cuTensorMapEncodeTiled, -2 - i when operand i's tensor map is refused, -6
// for a grid outside 1..64, a mode it does not take or another head dim.
extern "C" int relpos_global_forward(const void* q, const void* k,
                                     const void* v, void* o, const void* fh,
                                     const void* fw,
                                     const long long* fw_strides,
                                     const void* rh_table,
                                     const long long* layouts,
                                     const long long* o_strides, int batch,
                                     int heads, int rel_h, int rel_w,
                                     int head_dim, int mode, float scale,
                                     void* stream) {
  if (encode_fn() == nullptr) return -1;
  if (rel_h < 1 || rel_w < 1 || rel_h > MAX_GRID || rel_w > MAX_GRID)
    return -6;
  if (mode != GRID64 && mode != FOLD) return -6;
  if (mode == GRID64 && rel_w != MAX_GRID) return -6;
  if (head_dim != D && head_dim != D_WIDE) return -6;
  const bool wide = head_dim == D_WIDE;
  alignas(64) CUtensorMap maps[8];
  Params p = {};
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const long long* lay = layouts + 14 * i;
    if (lay[0] != head_dim) return -2 - i;
    for (int slab = 0; slab < (wide ? 2 : 1); ++slab)
      if (!encode_bhsd_slab(&maps[slab ? 4 + i : i], ptrs[i], lay,
                            p.pos[i], i == 0 ? BQ : BK, slab))
        return -2 - i;
  }
  // Rh: {hd, h^2} rows of the (h, h, hd) table, a box of 64 rows (of 64
  // dims; of 16 dims from dim 64 on for the second slab).
  const cuuint64_t rh_dims[2] = {(cuuint64_t)head_dim,
                                 (cuuint64_t)rel_h * rel_h};
  const cuuint64_t rh_str[1] = {(cuuint64_t)head_dim * 2};
  const cuuint32_t rh_box[2] = {(cuuint32_t)D, (cuuint32_t)BQ};
  if (!encode_bf16(&maps[3], rh_table, 2, rh_dims, rh_str, rh_box)) return -5;
  const cuuint32_t rh_box1[2] = {(cuuint32_t)D1, (cuuint32_t)BQ};
  if (wide && !encode_bf16(&maps[7], rh_table, 2, rh_dims, rh_str, rh_box1,
                           CU_TENSOR_MAP_SWIZZLE_32B))
    return -5;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.obs = o_strides[0];
  p.ohs = o_strides[1];
  p.old = o_strides[2];
  p.fh = static_cast<const __nv_bfloat16*>(fh);
  p.fw = static_cast<const __nv_bfloat16*>(fw);
  p.fw_sc = fw_strides[0];
  p.fw_sbh = fw_strides[1];
  p.fw_sr = fw_strides[2];
  p.seq = rel_h * rel_w;
  p.heads = heads;
  p.rel_h = rel_h;
  p.rel_w = rel_w;
  p.scale_log2 = scale * LOG2E;
  p.inv_scale = wide ? 1.f : 1.f / scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return wide ? global_launch<D_WIDE>(maps, p, batch, heads, mode, st)
              : global_launch<D>(maps, p, batch, heads, mode, st);
}

// K2.  qkv: (B, Hp, Wp, 3 * heads * hd) bf16, contiguous, hd = head_dim (64
// or 80), Hp and Wp multiples of ws; rh/rw: (ws, ws, hd) bf16 tables,
// contiguous; o: (B, Hp, Wp, heads * hd) bf16, contiguous.  Returns
// cudaGetLastError(), -1 as above, -2 - i when map i (k, v, Rh, Rw) is
// refused, -6 for a window outside 1..16, a grid it does not divide or
// another head dim.
extern "C" int relpos_window_forward(const void* qkv, void* o, const void* rh,
                                     const void* rw, int batch, int hp,
                                     int wp, int heads, int ws, int head_dim,
                                     float scale, void* stream) {
  if (encode_fn() == nullptr) return -1;
  if (ws < 1 || ws > MAX_WINDOW || hp % ws || wp % ws) return -6;
  if (head_dim != D && head_dim != D_WIDE) return -6;
  const bool wide = head_dim == D_WIDE;
  const int dim = heads * head_dim, n = ws * ws;
  const cuuint64_t esz = sizeof(__nv_bfloat16);
  alignas(64) CUtensorMap maps[8];
  // k and v: {hd, heads, Wp, Hp, B}, a box a window of one head (64 dims;
  // 16 from dim 64 on for the second slab).
  const cuuint64_t dims5[5] = {(cuuint64_t)head_dim, (cuuint64_t)heads,
                               (cuuint64_t)wp, (cuuint64_t)hp,
                               (cuuint64_t)batch};
  const cuuint64_t str5[4] = {head_dim * esz, 3ull * dim * esz,
                              3ull * dim * wp * esz,
                              3ull * dim * wp * hp * esz};
  const cuuint32_t box5[5] = {(cuuint32_t)D, 1, (cuuint32_t)ws,
                              (cuuint32_t)ws, 1};
  const cuuint32_t box5_1[5] = {(cuuint32_t)D1, 1, (cuuint32_t)ws,
                                (cuuint32_t)ws, 1};
  const char* qkv_b = static_cast<const char*>(qkv);
  // The tables: {hd, ws (j), ws (r)}, one box of 16 j a row, so that each
  // Rh[r] lands as a 16-row tile (rows j >= ws filled with zeros).
  const cuuint64_t dims3[3] = {(cuuint64_t)head_dim, (cuuint64_t)ws,
                               (cuuint64_t)ws};
  const cuuint64_t str3[2] = {head_dim * esz, head_dim * esz * ws};
  const cuuint32_t box3[3] = {(cuuint32_t)D, 16, (cuuint32_t)ws};
  const cuuint32_t box3_1[3] = {(cuuint32_t)D1, 16, (cuuint32_t)ws};
  const void* srcs[4] = {qkv_b + dim * esz, qkv_b + 2 * dim * esz, rh, rw};
  for (int i = 0; i < 4; ++i) {
    const bool table = i >= 2;
    for (int slab = 0; slab < (wide ? 2 : 1); ++slab) {
      const bool ok = encode_bf16(
          &maps[slab ? 4 + i : i], srcs[i], table ? 3 : 5,
          table ? dims3 : dims5, table ? str3 : str5,
          slab ? (table ? box3_1 : box5_1) : (table ? box3 : box5),
          slab ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_128B);
      if (!ok) return -2 - i;
    }
  }
  Params p = {};
  p.o = static_cast<__nv_bfloat16*>(o);
  p.obs = (long long)hp * wp * dim;
  p.ohs = head_dim;
  p.old = dim;
  p.qkv = static_cast<const __nv_bfloat16*>(qkv);
  p.seq = n;
  p.heads = heads;
  p.rel_h = p.rel_w = ws;
  p.scale_log2 = scale * LOG2E;
  p.inv_scale = 1.f / scale;
  p.hp = hp;
  p.wp = wp;
  p.dim = dim;
  p.nwh = hp / ws;
  p.nww = wp / ws;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return wide ? window_launch<D_WIDE>(maps, p, batch, heads, st)
              : window_launch<D>(maps, p, batch, heads, st);
}
