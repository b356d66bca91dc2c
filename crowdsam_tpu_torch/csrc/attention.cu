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
// reaches the scores in one of three ways (the template's MODE; K3's form
// is picked by `models/attention.relpos_form`):
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
//     COLUMNS (the template's COLS): GRID64 on the whole of a grid 64
//     tall and narrower (a portrait frame's 64x48, SAM's rect encode).
//     Attention does not change when the keys are permuted, and permuting
//     the queries permutes the output rows alike; exchanging rows and
//     columns makes a (64, w) grid a (w, 64) one, 64 wide, with Rh and Rw
//     trading places.  So q, k and v are read column by column through
//     5-d tensor maps (the token axis split into {column, row}, a box one
//     grid column of 64 tokens: a query block is one column, a key tile
//     two loads of one), the term formed in the kernel is q.Rw[col(q)]
//     (Rw as the kernel's Rh table), the folded 64-wide term q.Rh[row(q)]
//     comes from the wrapper's batched product over the grid's rows, and
//     a block's output row i is stored at grid token i w + column.
//   FOLD (K3 on any other grid up to 64x64: under 64 both ways, a query
//     band of a grid 64 tall, K2's windows above 16).  The TPU kernels'
//     fold, in
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
//      K4 already sits (ptxas allots no more to the consumer after
//      setmaxnreg.inc); fw kept in registers (32 f32 a thread) spilled and
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
//      one-hot columns shifted by one; COLUMNS' tables not exchanged or its
//      rows stored in grid order; K2's Rh slab overwritten (at head dim 80)
//      before G has read it: chip_smoke.py's K2/K3 phases hold plain
//      versions with each of those faults against the tolerance.
//
// Query bands (K3 on a rank of the spatial axis, which holds grid rows
// [row0, row0 + q_rows) of the queries and every key): the block grid
// spans the band's Sq = q_rows w queries, and a query's grid row is row0
// plus its row in the band.  Only the queries' side changes: GRID64 loads
// Rh[row0 + block] for fh; FOLD reads the band's fh/fw rows (the wrapper
// cuts them); the key loop, the one-hot KA and the masking past S keep
// the whole grid's S = h w keys.  The output has Sq rows.
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
// The slab code is `if constexpr (HD == 80)` or a kernel of its own, so
// that the head-dim-64 kernels keep their code and layout.
//   K3 GRID64 and COLUMNS at head dim 80 (`flash_attn_relpos_wide`).  With
//   the slabs a block of one consumer needed 128,064 bytes, over half the
//   SM's shared memory: one block ran an SM, so nothing hid its softmax
//   behind products (at 64 the second block does), and its two-block
//   register bound (128) spilled and serialized the products.  Instead, one
//   block an SM of three warpgroups (`__launch_bounds__(384, 1)`: ptxas
//   allots 168 registers a thread): a producer whose one thread keeps a
//   ring of three K/V stages full, and two consumers of 64 queries each,
//   the exchanged grid's rows 2x and 2x + 1 (a band's rows; COLUMNS: grid
//   columns).  Each consumer has its own Q, QA and fh (its own Rh row by
//   TMA); the one-hot KA and every K/V stage are shared, so a stage comes
//   from L2 once for 128 queries.  Each step a consumer issues the last
//   tile's P V and this tile's scores as one batch, waits, and runs the
//   softmax; named barriers make the two consumers issue in turns, so that
//   one's softmax runs while the other's products do (FA3's ping-pong).  A
//   stage is released once both consumers' P V products that read it have
//   retired (eight warp arrivals).  QA comes from the wrapper's f32 product,
//   divided by the scale and rounded to bf16 once, here.  A last block
//   whose second row is past the grid or band repeats the first's (every
//   load in bounds) and stores nothing.  210,024 bytes (`Wide`).
//   K3 FOLD at head dim 80 keeps the one-consumer kernel, one block an SM
//   by its shared memory and so bounded.
//   K2's head-dim-80 layout is its own (`win_layout`), cut to two blocks
//   an SM (115,496 of the 115,712 bytes two blocks may take, against
//   134,184 for the head-dim-64 order with the slabs): KA and V span the
//   224 rows that two 112-key tiles read, not 256; K and K1 the window's
//   196 rows, not 200 rounded to 1 KB; Rh's slab lies over QA, which is
//   written only once G = Q Rh^T has read it; the 32-byte swizzled slabs
//   sit together at the end, 256-byte aligned.
#include "sm90.cuh"

namespace {

using namespace sm90;

// K3's forms as the entry point takes them; K2 has its own kernel.  COLUMNS
// is GRID64's kernel with its template flag COLS set (at head dim 80 both
// are `flash_attn_relpos_wide<MODE>`).
enum Mode { GRID64 = 0, FOLD = 1, COLUMNS = 2 };

constexpr int THREADS = 256;       // consumer warpgroup + producer warpgroup
constexpr int CONSUMER_WARPS = 4;
constexpr int Q_BYTES = BQ * ROW_BYTES;      // 8 KB: 64 rows
constexpr int TILE_BYTES = BK * ROW_BYTES;   // 16 KB: 128 rows
constexpr int MAX_GRID = 64;       // K3: h, w <= 64
constexpr int MAX_WINDOW = 16;     // K2: ws^2 <= 256 keys (two tiles)
constexpr int BLOCKS_PER_SM = 2;
constexpr int Q1_BYTES = BQ * ROW1_BYTES;    // 2 KB: the slab of 64 rows
constexpr int TILE1_BYTES = BK * ROW1_BYTES; // 4 KB: the slab of 128 rows

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
//   GRID64: Q | QA (fw) | KA (128 keys) | fh (64 x 64 bf16) | K ring |
//           V ring | barriers (head dim 64; at 80 `Wide`)
//   FOLD:   Q | [Q1] | QA (2 slabs) | KA (2 slabs) | K ring | [K1 ring] |
//           V ring | [V1 ring] | barriers
//   WINDOW: `win_layout` (its own order at head dim 80).
// A product over a window's second tile reads TK rows of K and KA: the
// rows past the window's keys are masked, whatever buffer they fall in.
template <int MODE, int HD>
struct Ring {                      // K3: GRID64 (head dim 64), FOLD
  static constexpr bool WIDE = HD == D_WIDE;
  static_assert(!(WIDE && MODE == GRID64), "GRID64 at 80 is `Wide`");
  static constexpr int STAGES = 2;
  static constexpr int Q1 = Q_BYTES;
  static constexpr int QA = Q1 + (WIDE ? Q1_BYTES : 0);
  static constexpr int KA = QA + (MODE == FOLD ? 2 : 1) * Q_BYTES;
  static constexpr int FH = KA + (MODE == GRID64 ? 1 : 2) * TILE_BYTES;
  static constexpr int K = FH + (MODE == GRID64 ? Q_BYTES : 0);
  static constexpr int K1 = K + STAGES * TILE_BYTES;
  static constexpr int V = K1 + (WIDE ? STAGES * TILE1_BYTES : 0);
  static constexpr int V1 = V + STAGES * TILE_BYTES;
  static constexpr int BAR = V1 + (WIDE ? STAGES * TILE1_BYTES : 0);
  static constexpr int N_BARS = 2 + 3 * STAGES;  // q, rh, full_k/v, empty
  static constexpr int SMEM = BAR + 8 * N_BARS + 1024;
};

// K3 GRID64 and COLUMNS at head dim 80 (`flash_attn_relpos_wide`): two
// consumers' Q, QA and fh (64 x 64 f32, over Rh[row], which lands in its
// first 8 KB), the one-hot KA they share, a ring of three K and V stages;
// then the 32-byte swizzled slabs (256-byte aligned) and the barriers:
//   Q[2] | QA[2] | KA | fh[2] | K ring | V ring | Q1[2] | Rh1[2] |
//   K1 ring | V1 ring | barriers
// 210,024 bytes of the 232,448 a block may take; a fourth stage (+40 KB)
// does not fit.
struct Wide {
  static constexpr int STAGES = 3;
  static constexpr int FH_BYTES = BQ * MAX_GRID * 4;
  static constexpr int QA = 2 * Q_BYTES;
  static constexpr int KA = QA + 2 * Q_BYTES;
  static constexpr int FH = KA + TILE_BYTES;
  static constexpr int K = FH + 2 * FH_BYTES;
  static constexpr int V = K + STAGES * TILE_BYTES;
  static constexpr int Q1 = V + STAGES * TILE_BYTES;
  static constexpr int RH1 = Q1 + 2 * Q1_BYTES;
  static constexpr int K1 = RH1 + 2 * Q1_BYTES;
  static constexpr int V1 = K1 + STAGES * TILE1_BYTES;
  static constexpr int BAR = V1 + STAGES * TILE1_BYTES;
  static constexpr int N_BARS = 4 + 3 * STAGES;  // q[2], rh[2], full_k/v, empty
  static constexpr int SMEM = BAR + 8 * N_BARS + 1024;
};

// WINDOW layout for a window of ws x ws tokens.
struct WinLayout {
  int q1, qa, ka, k, k1, v, v1, rh1, bar, smem;
};
template <int HD>
__host__ __device__ inline WinLayout win_layout(int ws) {
  constexpr bool WIDE = HD == D_WIDE;
  const int n = ws * ws;
  WinLayout w;
  if constexpr (WIDE) {
    // Head dim 80, cut to two blocks an SM (at most 115,712 bytes): the
    // 128-byte swizzled tiles first, each a multiple of 1 KB, then the
    // 32-byte swizzled slabs (256-byte aligned):
    //   Q | QA (holds Rh's slab first) | KA (holds Rh first) | V (holds Rw
    //   first) | K (n rows) | K1 (n rows) | V1 (holds Rw's slab first) |
    //   Q1 | barriers
    // KA and V span the rows that the two score tiles read (2 TK) or the
    // table (16 ws), whichever is more; K and K1 the window's n rows (the
    // second tile's rows past them fall in the next buffer: masked keys).
    const int tk = n <= 2 * 112 ? 112 : BK;
    const int span = 2 * tk > 16 * ws ? 2 * tk : 16 * ws;
    w.qa = Q_BYTES;
    w.rh1 = w.qa;
    w.ka = w.qa + Q_BYTES;
    w.v = w.ka + span * ROW_BYTES;
    w.k = w.v + span * ROW_BYTES;
    w.k1 = (w.k + n * ROW_BYTES + 255) / 256 * 256;
    w.v1 = (w.k1 + n * ROW1_BYTES + 255) / 256 * 256;
    w.q1 = w.v1 + span * ROW1_BYTES;
    w.bar = w.q1 + Q1_BYTES;
    // The second tile's reads of K and K1 stay inside the block's memory
    // also for a small window, whose buffers after K are small.
    int end = w.bar + 8 * 5;
    end = end > w.k + 2 * tk * ROW_BYTES ? end : w.k + 2 * tk * ROW_BYTES;
    end = end > w.k1 + 2 * tk * ROW1_BYTES ? end : w.k1 + 2 * tk * ROW1_BYTES;
    w.smem = end + 1024;
    return w;
  }
  // Head dim 64: Q | QA | KA (256 rows; holds Rh first) | K (the window's
  // rows, rounded to 8) | V (256 rows; holds Rw first) | barriers.
  const int rows = ((n + 7) / 8) * 8;
  w.q1 = w.k1 = w.v1 = w.rh1 = 0;    // no second slab
  w.qa = Q_BYTES;
  w.ka = w.qa + Q_BYTES;
  w.k = w.ka + 2 * TILE_BYTES;
  w.v = w.k + rows * ROW_BYTES;
  w.bar = w.v + 2 * TILE_BYTES;
  w.smem = w.bar + 8 * 5 + 1024;   // k_full, v_full, rh_full, rw_full, v_free
  return w;
}

struct Params {
  __nv_bfloat16* o;
  long long obs, ohs, old;   // output strides: batch (image), head, token
  const __nv_bfloat16* fh;   // K3 FOLD: (B, H, S, rel_h), bf16, contiguous
  const __nv_bfloat16* fw;   // K3: FOLD (B, H, S, rel_w), contiguous;
  long long fw_sc, fw_sbh, fw_sr;  // GRID64: strides of a column, a
                             // (batch, head) and a grid row (64 j a row);
                             // GRID64 / COLUMNS at head dim 80: f32 terms
  const __nv_bfloat16* qkv;  // K2: the projection (B, Hp, Wp, 3 dim)
  int seq, heads;            // seq: keys (K3: the grid's h w; K2: a window)
  int seq_q, row0;           // K3: queries (a band of grid rows from row0)
  int rel_h, rel_w;          // K3: the grid; K2: the window twice
  float scale_log2;          // softmax scale * log2(e)
  float inv_scale;           // the folded bias terms are multiplied by it
  int pos[3][3];             // K3: q/k/v map dims of (head, token, batch)
  int pos5[3][4];            // K3 COLUMNS: q/k/v map dims of (head, column,
                             // row, batch)
  int hp, wp, dim, nwh, nww; // K2: padded grid, channels of q, windows
};

// K3 COLUMNS: a 5-d map of one slab of a (B, H, S, hd) operand of a grid
// whose S tokens are rows of `cols` columns, read column by column: the
// token axis of the layout row (`models/attention.tma_layout`) split into
// (column: stride t, row: stride cols t), a box of one column of BQ rows
// (64 dims, or dims 64-79 under the 32-byte swizzle for slab 1).  pos5:
// the map dims (1-4) of (head, column, row, batch).  The dims keep the
// layout row's order of strides.
inline bool encode_cols_slab(CUtensorMap* map, const void* ptr,
                             const long long* lay, int* pos5, int cols,
                             int slab) {
  int pos[3];
  for (int i = 0; i < 3; ++i) {
    pos[i] = (int)lay[11 + i];
    if (pos[i] < 1 || pos[i] > 3) return false;
  }
  if ((lay[0] != D && lay[0] != D_WIDE) || (slab && lay[0] != D_WIDE) ||
      lay[pos[1]] != (long long)cols * BQ)
    return false;
  cuuint64_t dims[5] = {(cuuint64_t)lay[0]}, strides[4];
  cuuint32_t box[5] = {(cuuint32_t)(slab ? D1 : D)};
  int out = 1;
  for (int i = 1; i < 4; ++i) {
    const cuuint64_t st = (cuuint64_t)lay[3 + i];
    if (i == pos[1]) {
      pos5[1] = out;
      dims[out] = cols, strides[out - 1] = st, box[out++] = 1;
      pos5[2] = out;
      dims[out] = BQ, strides[out - 1] = st * cols, box[out++] = BQ;
    } else {
      pos5[i == pos[0] ? 0 : 3] = out;
      dims[out] = (cuuint64_t)lay[i], strides[out - 1] = st, box[out++] = 1;
    }
  }
  return encode_bf16(map, ptr, 5, dims, strides, box,
                     slab ? CU_TENSOR_MAP_SWIZZLE_32B
                          : CU_TENSOR_MAP_SWIZZLE_128B);
}

// One grid column (BQ tokens) of head h, batch b through a column map, from
// dim d0 (0, or D for the second slab).
__device__ __forceinline__ void load_col(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, const int* pos5, int h,
                                         int col, int b, int d0) {
  int c[4];
#pragma unroll
  for (int slot = 1; slot <= 4; ++slot)
    c[slot - 1] = pos5[0] == slot ? h
                  : pos5[1] == slot ? col
                  : pos5[2] == slot ? 0
                                    : b;
  tma_load_5d(dst, map, bar, d0, c[0], c[1], c[2], c[3]);
}

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

// Arrive at named barrier `id` of `threads` threads without waiting.
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// K3's key tile `it` (128 keys) of K or V into a ring stage: COLS two grid
// columns of 64 through column maps, else 128 tokens; at head dim HD = 80
// also its dims 64-79 (`map1`, into `dst1`).
template <int HD, bool COLS>
__device__ __forceinline__ void load_tile(uint32_t dst, uint32_t dst1,
                                          const CUtensorMap* map,
                                          const CUtensorMap* map1,
                                          uint32_t bar, const int* pos,
                                          const int* pos5, int h, int it,
                                          int b) {
  if constexpr (COLS) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      load_col(dst + c * Q_BYTES, map, bar, pos5, h, 2 * it + c, b, 0);
      if constexpr (HD == D_WIDE)
        load_col(dst1 + c * Q1_BYTES, map1, bar, pos5, h, 2 * it + c, b, D);
    }
  } else {
    load_bhsd(dst, map, bar, pos, h, it * BK, b);
    if constexpr (HD == D_WIDE)
      load_bhsd1(dst1, map1, bar, pos, h, it * BK, b);
  }
}

// GRID64: fh = Q Rh[row]^T of a warpgroup's 64 query rows (Rh[row] at
// `sfh`, at head dim 80 its dims 64-79 at `srh1`, both landed), written
// over Rh[row] once every warp's product has read it (named barrier `bar`)
// as row-major bf16 pairs, (i, 2 jp) at i * 128 + 4 jp, 0 past the grid's
// `rh` rows; at head dim 80 as f32, (i, j) at i * 256 + 4 j (the bf16 fh
// took a third of the kernel's mean error there, and its largest error
// near the smoke's bound).  The caller's barrier makes the rows visible to
// the loop.
template <int HD>
__device__ __forceinline__ void form_fh(uint32_t sq, uint32_t sfh,
                                        uint32_t sq1, uint32_t srh1, int rh,
                                        int warp, int lane, int bar) {
  float fh[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n64k16_ss(fh, kmajor_desc(sq + kk * 32),
                       kmajor_desc(sfh + kk * 32), kk > 0 ? 1 : 0);
  if constexpr (HD == D_WIDE)
    wgmma_m64n64k16_ss(fh, kmajor32_desc(sq1), kmajor32_desc(srh1), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(fh);
  named_bar(bar, 128);
  const int t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = warp * 16 + (lane >> 2) + 8 * r;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = 8 * jj + 2 * t4;
      const float lo = j < rh ? fh[4 * jj + 2 * r] : 0.f;
      const float hi = j < rh ? fh[4 * jj + 2 * r + 1] : 0.f;
      if constexpr (HD == D_WIDE) {
        st_shared_u32(sfh + i * 256 + 4 * j, __float_as_uint(lo));
        st_shared_u32(sfh + i * 256 + 4 * j + 4, __float_as_uint(hi));
      } else {
        st_shared_u32(sfh + i * ROW_BYTES + 2 * j, pack_bf16(lo, hi));
      }
    }
  }
}

// GRID64: the logit offsets of key tile `it` for a thread's two rows: fh at
// the tile's grid rows 2 it and 2 it + 1, one a tile half (log2 domain),
// from `form_fh`'s rows at head dim HD.
template <int HD>
__device__ __forceinline__ void fh_offsets(float (&off)[2][2], uint32_t sfh,
                                           int it, int warp, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = warp * 16 + (lane >> 2) + 8 * r;
    if constexpr (HD == D_WIDE) {
      const uint32_t at = sfh + i * 256 + 8 * it;
      off[r][0] = LOG2E * __uint_as_float(ld_shared_u32(at));
      off[r][1] = LOG2E * __uint_as_float(ld_shared_u32(at + 4));
    } else {
      const uint32_t pair = ld_shared_u32(sfh + i * ROW_BYTES + 4 * it);
      off[r][0] = LOG2E * bf16_half(pair, 0);
      off[r][1] = LOG2E * bf16_half(pair, 1);
    }
  }
}

// ---------------------------------------------------------------------------
// K3: GRID64 (head dim 64) and FOLD
// ---------------------------------------------------------------------------

// NSLAB: FOLD's 64-dim slabs of [fh | fw] (h + w <= 64 * NSLAB).  HD: the
// head dim, 64 or 80 (FOLD only; `m`: the maps of dims 64-79 of q, k and
// v).  COLS (GRID64 only): the grid is the exchange of a grid 64 tall, read
// column by column (`tm_q/k/v` are column maps, `load_col`), and a block's
// query row i is stored at token i * w + blockIdx.x.  FOLD at head dim 80
// runs one block an SM (its shared memory): bounded so, ptxas gives a
// thread up to 232 registers (128 for two blocks, where it spilled).
template <int MODE, int NSLAB, int HD, bool COLS = false>
__global__ void __launch_bounds__(THREADS, HD == D_WIDE ? 1 : BLOCKS_PER_SM)
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
  const uint32_t sq1 = base + L::Q1;
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
      if constexpr (COLS) {          // the block's 64 queries: grid column
        load_col(sq, &tm_q, q_full, p.pos5[0], h, blockIdx.x, b, 0);
      } else {
        load_bhsd(sq, &tm_q, q_full, p.pos[0], h, q0, b);
        if constexpr (WIDE) load_bhsd1(sq1, &m.a, q_full, p.pos[0], h, q0, b);
      }
      if (MODE == GRID64) {
        // The block's 64 queries are grid row row0 + blockIdx.x: Rh[row]
        // (64 j x 64 dims, rows past the table's end zero).
        const int row = p.row0 + blockIdx.x;
        mbar_expect_tx(rh_full, Q_BYTES);
        tma_load_2d(sfh, &tm_rh, rh_full, 0, row * p.rel_h);
      }
      const CUtensorMap *k1 = nullptr, *v1 = nullptr;   // head dim 80
      if constexpr (WIDE) k1 = &m.b, v1 = &m.c;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(full_k + 8 * s, TILE_BYTES + (WIDE ? TILE1_BYTES : 0));
        load_tile<HD, COLS>(sk + s * TILE_BYTES, sk1 + s * TILE1_BYTES,
                            &tm_k, k1, full_k + 8 * s, p.pos[1],
                            p.pos5[1], h, it, b);
        mbar_expect_tx(full_v + 8 * s, TILE_BYTES + (WIDE ? TILE1_BYTES : 0));
        load_tile<HD, COLS>(sv + s * TILE_BYTES, sv1 + s * TILE1_BYTES,
                            &tm_v, v1, full_v + 8 * s, p.pos[2],
                            p.pos5[2], h, it, b);
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
    mbar_wait(q_full, 0);
    mbar_wait(rh_full, 0);
    form_fh<D>(sq, sfh, 0, 0, rh, warp, lane, 1);
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
          if (q < p.seq_q) {
            const long long row = bh * p.seq_q + q;
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
    if constexpr (MODE == GRID64) fh_offsets<D>(off, sfh, it, warp, lane);
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
    // COLUMNS: the exchanged grid's rel_h rows are the grid's w columns.
    const int q = COLS ? i * p.rel_h + blockIdx.x : q0 + i;   // grid token
    if (q0 + i >= p.seq_q) return nullptr;
    return p.o + (long long)b * p.obs + (long long)h * p.ohs +
           (long long)q * p.old;
  };
  if constexpr (WIDE) store_rows_wide(o, o1, l, warp, lane, dst);
  else store_rows(o, l, warp, lane, dst);
}

// ---------------------------------------------------------------------------
// K3 at head dim 80: GRID64 and COLUMNS, two consumer warpgroups a block
// ---------------------------------------------------------------------------

constexpr int WIDE_CONSUMERS = 2;
constexpr int WIDE_THREADS = 128 * (WIDE_CONSUMERS + 1);
// Named barriers of `flash_attn_relpos_wide` (0 is __syncthreads): both
// consumers; consumer c's own warpgroup (+ c); "consumer c issues its
// products next" (+ c), which orders the two consumers' products.
constexpr int BAR_CONSUMERS = 1;
constexpr int BAR_OWN = 2;
constexpr int BAR_TURN = 4;

// Consumer c's grid row of a block (the band's; COLUMNS: the grid column):
// 2 blockIdx.x + c.  The second of a last block past the `rows` rows
// repeats the first's (so that every product and load stays in the
// tensors) and stores nothing.
__device__ __forceinline__ int wide_row(int c, int rows) {
  return min(2 * (int)blockIdx.x + c, rows - 1);
}

// S = Q K^T + QA KA^T of one key tile at head dim 80: 4 + 1 + 4 k-steps.
__device__ __forceinline__ void wide_scores(float (&sc)[NS], uint32_t sq,
                                            uint32_t sq1, uint32_t sqa,
                                            uint32_t ska, uint32_t k,
                                            uint32_t k1) {
  issue_qk(sc, sq, k, false);
  issue_qk_slab1(sc, sq1, k1);
  issue_fold<4>(sc, sqa, ska, 0);
}

// O += P V of one key tile at head dim 80 (dims 0-63 and 64-79).
__device__ __forceinline__ void wide_values(float (&o)[32], float (&o1)[8],
                                            const uint32_t (&pa)[NP][4],
                                            uint32_t v, uint32_t v1) {
  issue_pv(o, pa, v);
  issue_pv_slab1(o1, pa, v1);
}

// A block of three warpgroups: a producer (one thread keeps a ring of
// three K/V stages full) and two consumers of 64 queries each, grid rows
// (MODE COLUMNS: grid columns) 2 blockIdx.x and 2 blockIdx.x + 1, which share
// every K/V stage and the one-hot KA.  Each consumer forms its QA from the
// wrapper's f32 product (divided by the scale and rounded to bf16 here,
// once) and its fh from its own Rh row.  Each step a consumer issues the
// last tile's P V and this tile's scores together, then runs the softmax
// while the other consumer's products run: the named barriers BAR_TURN + c
// let the consumers issue in turns.  A stage is released when both
// consumers' P V products that read it have retired.
template <int MODE>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
flash_attn_relpos_wide(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_rh,
                       const Params p,
                       const __grid_constant__ SlabMaps<D_WIDE> m) {
  using L = Wide;
  constexpr bool COLS = MODE == COLUMNS;
  constexpr int STAGES = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ska = base + L::KA, sk = base + L::K, sv = base + L::V;
  const uint32_t sk1 = base + L::K1, sv1 = base + L::V1;
  const uint32_t q_full = base + L::BAR;                   // [2]
  const uint32_t rh_full = q_full + 8 * WIDE_CONSUMERS;    // [2]
  const uint32_t full_k = rh_full + 8 * WIDE_CONSUMERS;    // [STAGES]
  const uint32_t full_v = full_k + 8 * STAGES;             // [STAGES]
  const uint32_t empty = full_v + 8 * STAGES;              // [STAGES]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, h = blockIdx.y;
  const int n_tiles = (p.seq + BK - 1) / BK;
  const int rows = p.seq_q / MAX_GRID;   // the launch's query rows

  if (tid == 0) {
    for (int c = 0; c < WIDE_CONSUMERS; ++c) {
      mbar_init(q_full + 8 * c, 1);
      mbar_init(rh_full + 8 * c, 1);
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, WIDE_CONSUMERS * CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    fence_proxy_async();
  }
  __syncthreads();

  if (warp >= WIDE_CONSUMERS * CONSUMER_WARPS) {
    // ---- producer warpgroup: each consumer's Q and Rh row, then the ring --
    // (72 registers: at 40-56 the columns form's 5-d coordinates spilled)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 72;\n" ::: "memory");
    if (warp == WIDE_CONSUMERS * CONSUMER_WARPS && lane == 0) {
      prefetch_map(&tm_q);
      prefetch_map(&tm_k);
      prefetch_map(&tm_v);
      for (int c = 0; c < WIDE_CONSUMERS; ++c) {
        const int r = wide_row(c, rows);
        const uint32_t sq = base + c * Q_BYTES;
        const uint32_t sq1 = base + L::Q1 + c * Q1_BYTES;
        const uint32_t bar = q_full + 8 * c;
        mbar_expect_tx(bar, Q_BYTES + Q1_BYTES);
        if constexpr (COLS) {
          load_col(sq, &tm_q, bar, p.pos5[0], h, r, b, 0);
          load_col(sq1, &m.a, bar, p.pos5[0], h, r, b, D);
        } else {
          load_bhsd(sq, &tm_q, bar, p.pos[0], h, r * BQ, b);
          load_bhsd1(sq1, &m.a, bar, p.pos[0], h, r * BQ, b);
        }
        // Rh[row0 + r] (COLS: Rw[r]): 64 j x 80 dims, the rows past the
        // table's end zero.
        const int row = (p.row0 + r) * p.rel_h;
        mbar_expect_tx(rh_full + 8 * c, Q_BYTES + Q1_BYTES);
        tma_load_2d(base + L::FH + c * L::FH_BYTES, &tm_rh, rh_full + 8 * c,
                    0, row);
        tma_load_2d(base + L::RH1 + c * Q1_BYTES, &m.d, rh_full + 8 * c, D,
                    row);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(full_k + 8 * s, TILE_BYTES + TILE1_BYTES);
        load_tile<D_WIDE, COLS>(sk + s * TILE_BYTES, sk1 + s * TILE1_BYTES,
                                &tm_k, &m.b, full_k + 8 * s, p.pos[1],
                                p.pos5[1], h, it, b);
        mbar_expect_tx(full_v + 8 * s, TILE_BYTES + TILE1_BYTES);
        load_tile<D_WIDE, COLS>(sv + s * TILE_BYTES, sv1 + s * TILE1_BYTES,
                                &tm_v, &m.c, full_v + 8 * s, p.pos[2],
                                p.pos5[2], h, it, b);
      }
    }
    return;
  }

  // ---- consumer warpgroup c: 64 query rows ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 216;\n" ::: "memory");
  const int c = warp / CONSUMER_WARPS, cw = warp % CONSUMER_WARPS;
  const int r = wide_row(c, rows);
  const uint32_t sq = base + c * Q_BYTES, sqa = base + L::QA + c * Q_BYTES;
  const uint32_t sfh = base + L::FH + c * L::FH_BYTES;
  const uint32_t sq1 = base + L::Q1 + c * Q1_BYTES;
  const uint32_t srh1 = base + L::RH1 + c * Q1_BYTES;
  const int t4 = lane & 3;
  const long long bh = (long long)b * p.heads + h;

  // QA = fw / scale of the consumer's 64 queries, from the f32 product
  // (rounded to bf16 once, here); KA = onehot(k % 64), built by both.
  const float* fw_row = reinterpret_cast<const float*>(p.fw) +
                       bh * p.fw_sbh + (long long)r * p.fw_sr;
  for (int e = tid % 128; e < BQ * 8; e += 128) {
    const int i = e >> 3, ch = e & 7;
    const float4* src =
        reinterpret_cast<const float4*>(fw_row + i * p.fw_sc + ch * 8);
    const float4 lo = src[0], hi = src[1];
    const float s = p.inv_scale;
    st_shared_v4(sqa + sw128(i, ch), pack_bf16(lo.x * s, lo.y * s),
                 pack_bf16(lo.z * s, lo.w * s), pack_bf16(hi.x * s, hi.y * s),
                 pack_bf16(hi.z * s, hi.w * s));
  }
  for (int e = tid; e < BK * 8; e += 128 * WIDE_CONSUMERS)
    onehot_chunk(ska + sw128(e >> 3, e & 7), e & 7, (e >> 3) % MAX_GRID, -1);
  fence_proxy_async();
  mbar_wait(q_full + 8 * c, 0);
  mbar_wait(rh_full + 8 * c, 0);
  form_fh<D_WIDE>(sq, sfh, sq1, srh1, p.rel_h, cw, lane, BAR_OWN + c);
  named_bar(BAR_CONSUMERS, 128 * WIDE_CONSUMERS);   // QA, KA and fh written

  float o[32], o1[8], sc[NS], alpha[2];
  uint32_t pa[NP][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) o1[i] = 0.f;
  float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  auto softmax = [&](int it) {
    float off[2][2];
    fh_offsets<D_WIDE>(off, sfh, it, cw, lane);
    softmax_tile(sc, pa, mx, l, alpha, p.seq - it * BK, t4, p.scale_log2,
                 off);
    rescale(o, alpha);
    rescale8(o1, alpha);
  };
  // Consumer 0 issues first; then each issues once the other has issued.
  // Step 0 issues the first tile's scores, step it (1 .. n_tiles - 1) the
  // last tile's P V and this tile's scores, the last step the last tile's
  // P V: every product unconditional within its step.  Consumer 1 leaves
  // out its last arrival, which nothing would wait for.
  const int turn = BAR_TURN + c, other = BAR_TURN + 1 - c;
  constexpr int PAIR = 128 * WIDE_CONSUMERS;
  if (c == 1) named_bar_arrive(BAR_TURN, PAIR);
  mbar_wait(full_k, 0);
  named_bar(turn, PAIR);
  wgmma_fence();
  wide_scores(sc, sq, sq1, sqa, ska, sk, sk1);
  wgmma_commit();
  named_bar_arrive(other, PAIR);
  wgmma_wait<0>();
  fence_regs(sc);
  softmax(0);
  for (int it = 1; it < n_tiles; ++it) {
    const int s = it % STAGES, sp = (it - 1) % STAGES;
    mbar_wait(full_v + 8 * sp, ((it - 1) / STAGES) & 1);
    mbar_wait(full_k + 8 * s, (it / STAGES) & 1);
    named_bar(turn, PAIR);
    wgmma_fence();
    wide_values(o, o1, pa, sv + sp * TILE_BYTES, sv1 + sp * TILE1_BYTES);
    wide_scores(sc, sq, sq1, sqa, ska, sk + s * TILE_BYTES,
                sk1 + s * TILE1_BYTES);
    wgmma_commit();
    named_bar_arrive(other, PAIR);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(o1);
    fence_regs(pa);
    fence_regs(sc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * sp);
    softmax(it);
  }
  const int sp = (n_tiles - 1) % STAGES;
  mbar_wait(full_v + 8 * sp, ((n_tiles - 1) / STAGES) & 1);
  named_bar(turn, PAIR);
  wgmma_fence();
  wide_values(o, o1, pa, sv + sp * TILE_BYTES, sv1 + sp * TILE1_BYTES);
  wgmma_commit();
  if (c == 0) named_bar_arrive(other, PAIR);
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(o1);
  fence_regs(pa);

  const bool stored = 2 * (int)blockIdx.x + c < rows;
  auto dst = [&](int i) -> __nv_bfloat16* {
    if (!stored) return nullptr;
    // COLUMNS: the exchanged grid's rel_h rows are the grid's w columns.
    const int q = COLS ? i * p.rel_h + r : r * BQ + i;   // token of the band
    return p.o + (long long)b * p.obs + (long long)h * p.ohs +
           (long long)q * p.old;
  };
  store_rows_wide(o, o1, l, cw, lane, dst);
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
  const WinLayout lay = win_layout<HD>(ws);
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
                                             // (head dim 64)
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
      // the buffer (tiles past the table are never kept); at head dim 80,
      // whose buffers end with the table, inside the table.
      const int xs = WIDE ? max(min(x0, ws - GB), 0)
                          : min(x0, TABLE_TILES - GB);
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
  // Head dim 80: QA is written over Rh's slab, once every warp's G = Q
  // Rh^T has read it.
  if constexpr (WIDE) named_bar(1, 128);
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
  // V's rows past the window zeroed up to those the two tiles read (over
  // Rw; V loads into the rows before).
  constexpr int V_ROWS = WIDE ? 2 * TK : 2 * BK;
  named_bar(1, 128);
  for (int e = n * 8 + tid; e < V_ROWS * 8; e += 128)
    st_shared_v4(sv + (e >> 3) * ROW_BYTES + ((e & 7) << 4), 0u, 0u, 0u, 0u);
  if constexpr (WIDE)
    for (int e = n * 2 + tid; e < V_ROWS * 2; e += 128)
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

// K3's kernels at head dim HD allowed their shared memory (once).
template <int HD>
cudaError_t global_attrs() {
  static const cudaError_t err = [] {
    const int f = Ring<FOLD, HD>::SMEM;
    cudaError_t errs[4];
    if constexpr (HD == D_WIDE) {
      errs[0] = allow_smem(flash_attn_relpos_wide<GRID64>, Wide::SMEM);
      errs[1] = allow_smem(flash_attn_relpos_wide<COLUMNS>, Wide::SMEM);
    } else {
      const int g = Ring<GRID64, HD>::SMEM;
      errs[0] = allow_smem(flash_attn_relpos<GRID64, 1, HD>, g);
      errs[1] = allow_smem(flash_attn_relpos<GRID64, 1, HD, true>, g);
    }
    errs[2] = allow_smem(flash_attn_relpos<FOLD, 1, HD>, f);
    errs[3] = allow_smem(flash_attn_relpos<FOLD, 2, HD>, f);
    for (const cudaError_t e : errs)
      if (e != cudaSuccess) return e;
    return cudaSuccess;
  }();
  return err;
}

// K3's launch at head dim HD; maps[4..7] are the second slab's (HD 80).
// GRID64 and COLUMNS at head dim 80: a block of two consumers a pair of
// the launch's grid rows (`flash_attn_relpos_wide`).
template <int HD>
int global_launch(const CUtensorMap* maps, const Params& p, int batch,
                  int heads, int mode, cudaStream_t st) {
  using F = Ring<FOLD, HD>;
  if (const cudaError_t e = global_attrs<HD>(); e != cudaSuccess)
    return (int)e;
  SlabMaps<HD> m;
  if constexpr (HD == D_WIDE) m = {maps[4], maps[5], maps[6], maps[7]};
  if (batch <= 0 || heads <= 0) return (int)cudaGetLastError();
  const dim3 grid((p.seq_q + BQ - 1) / BQ, heads, batch);
  if (mode == FOLD) {
    if (p.rel_h + p.rel_w <= D)
      flash_attn_relpos<FOLD, 1, HD><<<grid, THREADS, F::SMEM, st>>>(
          maps[0], maps[1], maps[2], maps[3], p, m);
    else
      flash_attn_relpos<FOLD, 2, HD><<<grid, THREADS, F::SMEM, st>>>(
          maps[0], maps[1], maps[2], maps[3], p, m);
  } else if constexpr (HD == D_WIDE) {
    const dim3 pairs((p.seq_q / MAX_GRID + 1) / 2, heads, batch);
    if (mode == GRID64)
      flash_attn_relpos_wide<GRID64><<<pairs, WIDE_THREADS, Wide::SMEM, st>>>(
          maps[0], maps[1], maps[2], maps[3], p, m);
    else
      flash_attn_relpos_wide<COLUMNS><<<pairs, WIDE_THREADS, Wide::SMEM, st>>>(
          maps[0], maps[1], maps[2], maps[3], p, m);
  } else {
    using G = Ring<GRID64, HD>;
    if (mode == GRID64)
      flash_attn_relpos<GRID64, 1, HD><<<grid, THREADS, G::SMEM, st>>>(
          maps[0], maps[1], maps[2], maps[3], p, m);
    else
      flash_attn_relpos<GRID64, 1, HD, true><<<grid, THREADS, G::SMEM, st>>>(
          maps[0], maps[1], maps[2], maps[3], p, m);
  }
  return (int)cudaGetLastError();
}

// K2's kernels at head dim HD allowed the shared memory of the largest
// window (once).
template <int HD>
cudaError_t window_attrs() {
  static const cudaError_t err = [] {
    const int smem = win_layout<HD>(MAX_WINDOW).smem;
    const cudaError_t e = allow_smem(window_attn_relpos<112, HD>, smem);
    return e != cudaSuccess ? e : allow_smem(window_attn_relpos<BK, HD>, smem);
  }();
  return err;
}

// K2's launch at head dim HD; maps[4..7] are the second slab's (HD 80).
template <int HD>
int window_launch(const CUtensorMap* maps, const Params& p, int batch,
                  int heads, cudaStream_t st) {
  if (const cudaError_t e = window_attrs<HD>(); e != cudaSuccess)
    return (int)e;
  SlabMaps<HD> m;
  if constexpr (HD == D_WIDE) m = {maps[4], maps[5], maps[6], maps[7]};
  const int n = p.seq, smem = win_layout<HD>(p.rel_w).smem;
  if (batch > 0 && heads > 0) {
    const dim3 grid((n + BQ - 1) / BQ, heads, batch * p.nwh * p.nww);
    if (n <= 2 * 112)
      window_attn_relpos<112, HD><<<grid, THREADS, smem, st>>>(
          maps[0], maps[1], maps[2], maps[3], p, m);
    else
      window_attn_relpos<BK, HD><<<grid, THREADS, smem, st>>>(
          maps[0], maps[1], maps[2], maps[3], p, m);
  }
  return (int)cudaGetLastError();
}

// `out` = {dynamic shared memory, blocks an SM} of `kernel` at `smem` bytes
// and `threads` threads a block.
template <typename K>
int occupancy(K kernel, int smem, int* out, int threads = THREADS) {
  out[0] = smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], kernel,
                                                            threads, smem);
}

template <int HD>
int relpos_occupancy_at(int kind, int arg, int* out) {
  if (kind == 3) {
    if (arg < 1 || arg > MAX_WINDOW) return -6;
    if (const cudaError_t e = window_attrs<HD>(); e != cudaSuccess)
      return (int)e;
    const int smem = win_layout<HD>(arg).smem;
    return arg * arg <= 2 * 112
               ? occupancy(window_attn_relpos<112, HD>, smem, out)
               : occupancy(window_attn_relpos<BK, HD>, smem, out);
  }
  if (const cudaError_t e = global_attrs<HD>(); e != cudaSuccess)
    return (int)e;
  const int f = Ring<FOLD, HD>::SMEM;
  if constexpr (HD == D_WIDE) {
    if (kind == GRID64)
      return occupancy(flash_attn_relpos_wide<GRID64>, Wide::SMEM, out,
                       WIDE_THREADS);
    if (kind == COLUMNS)
      return occupancy(flash_attn_relpos_wide<COLUMNS>, Wide::SMEM, out,
                       WIDE_THREADS);
  } else {
    const int g = Ring<GRID64, HD>::SMEM;
    if (kind == GRID64)
      return occupancy(flash_attn_relpos<GRID64, 1, HD>, g, out);
    if (kind == COLUMNS)
      return occupancy(flash_attn_relpos<GRID64, 1, HD, true>, g, out);
  }
  if (kind == FOLD && arg == 1)
    return occupancy(flash_attn_relpos<FOLD, 1, HD>, f, out);
  if (kind == FOLD && arg == 2)
    return occupancy(flash_attn_relpos<FOLD, 2, HD>, f, out);
  return -6;
}

}  // namespace

// K3. k, v: (B, H, S, hd) bf16 operands, hd = head_dim (64 or 80), S =
// rel_h * rel_w; q: (B, H, Sq, hd), Sq = q_rows * rel_w, the queries of
// grid rows [row0, row0 + q_rows) (a query band against every key; the
// whole grid when q_rows = rel_h); each with its tensor-map layout
// (`layouts`: 3 x 14 int64, q then k then v, each with dims[0] = hd and a
// box of 64 dims); rh_table: the (rel_h, rel_h, hd) bf16 table, contiguous
// (COLUMNS: the (rel_w, rel_w, hd) table).  FOLD: fh/fw contiguous (B, H,
// Sq, rel_h) / (B, H, Sq, rel_w) bf16, the band's rows.  GRID64: fh unused
// (formed in the kernel from Rh[row0 + local row]); fw (64 j contiguous) at
// column c, (batch, head) bh and the band's grid row r at c fw_strides[0]
// + bh fw_strides[1] + r fw_strides[2].  COLUMNS (the whole of a grid 64
// tall, GRID64 on its exchange): the term formed in the kernel is q.Rw[
// col(q)] from rh_table, and `fw` is q.Rh[row(q)] (64 j contiguous) at grid
// row r, bh and grid column c at r fw_strides[0] + bh fw_strides[1] + c
// fw_strides[2].  o: the output, strides `o_strides` (batch, head, token;
// elements).  `mode`: 0 (GRID64, a grid 64 wide only), 1 (FOLD, any grid)
// or 2 (COLUMNS, the whole of a grid 64 tall).  At head dim 80 FOLD's fh/fw
// come already divided by `scale`, and GRID64's and COLUMNS' `fw` is the
// f32 product (the kernel divides and rounds to bf16 once); at 64 the
// kernel divides a bf16 term, x8 being exact.
// Returns cudaGetLastError(), or -1 when
// the CUDA driver has no cuTensorMapEncodeTiled, -2 - i when operand i's
// tensor map is refused, -6 for a grid outside 1..64, a band outside it, a
// mode it does not take or another head dim.
extern "C" int relpos_global_forward(const void* q, const void* k,
                                     const void* v, void* o, const void* fh,
                                     const void* fw,
                                     const long long* fw_strides,
                                     const void* rh_table,
                                     const long long* layouts,
                                     const long long* o_strides, int batch,
                                     int heads, int rel_h, int rel_w,
                                     int q_rows, int row0, int head_dim,
                                     int mode, float scale, void* stream) {
  if (encode_fn() == nullptr) return -1;
  if (rel_h < 1 || rel_w < 1 || rel_h > MAX_GRID || rel_w > MAX_GRID)
    return -6;
  if (q_rows < 1 || row0 < 0 || row0 + q_rows > rel_h) return -6;
  if (mode != GRID64 && mode != FOLD && mode != COLUMNS) return -6;
  if (mode == GRID64 && rel_w != MAX_GRID) return -6;
  if (mode == COLUMNS && (rel_h != MAX_GRID || q_rows != rel_h)) return -6;
  if (head_dim != D && head_dim != D_WIDE) return -6;
  const bool wide = head_dim == D_WIDE;
  alignas(64) CUtensorMap maps[8];
  Params p = {};
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const long long* lay = layouts + 14 * i;
    if (lay[0] != head_dim) return -2 - i;
    for (int slab = 0; slab < (wide ? 2 : 1); ++slab) {
      CUtensorMap* map = &maps[slab ? 4 + i : i];
      if (mode == COLUMNS
              ? !encode_cols_slab(map, ptrs[i], lay, p.pos5[i], rel_w, slab)
              : !encode_bhsd_slab(map, ptrs[i], lay, p.pos[i],
                                  i == 0 ? BQ : BK, slab))
        return -2 - i;
    }
  }
  // COLUMNS runs GRID64 on the exchanged grid: rel_w rows of 64 tokens
  // (its in-kernel term from the (rel_w, rel_w) table given as rh_table).
  if (mode == COLUMNS) {
    rel_h = q_rows = rel_w;
    rel_w = MAX_GRID;
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
  p.seq_q = q_rows * rel_w;
  p.row0 = row0;
  p.heads = heads;
  p.rel_h = rel_h;
  p.rel_w = rel_w;
  p.scale_log2 = scale * LOG2E;
  p.inv_scale = wide && mode == FOLD ? 1.f : 1.f / scale;
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

// The dynamic shared memory (out[0], bytes) and the blocks an SM (out[1],
// cudaOccupancyMaxActiveBlocksPerMultiprocessor) of one instantiation at
// head dim `head_dim`: K3's `kind` 0 (GRID64), 1 (FOLD, `arg` 64-dim slabs
// of the bias terms) or 2 (COLUMNS); K2's (`kind` 3) for windows of `arg`
// x `arg`.  Returns a cudaError_t, or -6 for what no kernel takes.
extern "C" int relpos_occupancy(int head_dim, int kind, int arg, int* out) {
  if (head_dim == D) return relpos_occupancy_at<D>(kind, arg, out);
  if (head_dim == D_WIDE) return relpos_occupancy_at<D_WIDE>(kind, arg, out);
  return -6;
}
