// Float32 attention for Hopper (sm_90a): the float32 arms of K2, K3 and K4,
// for `tpu.compute_dtype float32` on the card, on the tensor cores in 3xTF32.
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
// Arithmetic: float32-accurate products in 3xTF32 on wgmma.  Each float32
// operand x is split into hi = rna_tf32(x) and lo = rna_tf32(x - hi)
// (`cvt.rna.tf32.f32`: the tensor core would truncate the 13 low bits of
// an unrounded value, and x - hi would then not be what it multiplies), and
// each product is lo.hi + hi.lo + hi.hi, the small terms first, summed in
// the float32 accumulators; lo.lo (2^-22 of the product) is dropped.  The
// softmax is online, in float32: exp(x - m) is ex2.approx(x log2(e) - m
// log2(e)), one FFMA and one MUFU op where expf takes about eight
// instructions (its ~2^-22 relative error stays inside the bound at every
// shape chip_smoke.py holds; m log2(e) is rounded once a row, a factor that
// the division by the row's sum cancels).  The scale is applied where the
// plain versions apply it (to q before the product for K2/K3, to the
// product for K4); the bias is added to the accumulator as (s + fh) + fw.
// `models/attention.f32_attention_tf32x3_model` is this arithmetic in
// PyTorch (the CPU tests hold its error from float64 to 2x the plain
// float32 version's, as chip_smoke.py holds the kernel's).
//
// Bound: operations.  Q K^T and P V take 4 Sq S hd FLOP a head; in three
// TF32 products at 495 TFLOP/s that is 165 TFLOP/s of float32 work:
// 16x5330x64 (K4) 0.705 ms, 16x4096x64 (K3) 0.416 ms, 25x16x196x64 (K2)
// 0.024 ms.  The bytes are far below that (K4 reads and writes 87 MB:
// 0.026 ms at 3.35 TB/s).
//
// Design.  A block of three warpgroups per (128-query tile, head, batch or
// window), one block an SM:
//   - the producer warpgroup (threads 256-383) reads each 64-key tile of K
//     and V from device memory into registers (the next tile's loads in
//     flight while the current one is written), splits it into hi and lo,
//     and writes both in wgmma's 128-byte-swizzled K-major layout: K as it
//     is (keys x hd), V transposed (hd x keys: TF32 has no transpose bit,
//     so B must be K-major), behind full/empty mbarriers.  At head dim 80
//     the dims 64-79 of Q and K form a slab of 64-byte rows under the
//     64-byte swizzle (layout type 2), so no k-step is padded;
//   - two consumer warpgroups of 64 queries each: S = Q K^T by
//     wgmma.m64n64k8 with Q (hi and lo, split once into shared memory) and
//     K from shared memory, the bias and mask in registers, the online
//     softmax, then P V by wgmma.m64nHDk8 with P from registers (hi and lo
//     split from the accumulators) and V^T from shared memory.  The two
//     issue their Q K^T in turns (named barriers), so that one's products
//     run while the other's softmax does.
// P as A from registers: the m64nN accumulator holds keys {2t, 2t + 1} of
// each 8-key group in thread t = lane % 4, while the TF32 A fragment holds
// k-columns {t, t + 4}.  The accumulators d0, d2, d1, d3 of a group are fed
// as a0..a3, and the producer writes V^T with the keys of each 8-key group
// in the matching order: position c holds key 2c for c < 4 and key
// 2(c - 4) + 1 otherwise.  The order of a sum over keys is free, so this
// costs nothing; getting it wrong pairs P with the wrong keys of V.
// Each key tile's P V is summed into a fresh accumulator and then joins O
// (O = O alpha + part): a sum in two levels, whose rounding grows with 64 +
// S / 64 terms, not S (one sequential sum over all S keys came to 1.9x the
// plain version's largest error in the FFMA arm this kernel replaced).
// fh and fw of the block's 128 query rows are staged in shared memory once
// (rows padded to an odd length, so that the 8 rows a warp reads fall on
// different banks).  Shared memory: K4 197,696 B (two K/V stages), K2/K3
// at head dim 64 132,128 B + the bias rows (one stage; 198,688 B at a
// 64x64 grid, 147,488 B for 14x14 windows), at head dim 80 164,896 B + the
// bias rows (231,456 B at 64x64).  Registers: a block of 12 warps puts 3 on
// some SM sub-partition, so every thread gets at most 168 (ptxas compiles
// the whole kernel to the launch bound: setmaxnreg cannot give the
// consumers more, and the spills grew when tried).  The consumers hold S
// (32), O and the tile's part (hd / 2 each) and P's hi and lo for 32 keys:
// P V is issued in two halves of 32 keys, the second half's fragments made
// after the first half retired.  The descriptors' high words are
// immediates of the wgmma instructions and their low words advance by
// constants, so no 64-bit descriptor is held: no spills.
//
// Where this can go wrong, and what guards it:
//   1. A layout mismatch between the producer's stores and the
//      descriptors (swizzle, the sub-tiles of 32 dims or keys, the 64-byte
//      slab at head dim 80): wrong products; chip_smoke.py's error bound.
//   2. The key order of V^T (above): chip_smoke.py holds the model with
//      V's keys left unpermuted against the bound.
//   3. A stage refilled while read: the consumers release K after their
//      Q K^T retired and V after their P V retired (wgmma.wait_group), one
//      arrival a warp; the producer fences its generic-proxy stores for the
//      async proxy (fence.proxy.async) before arriving on the full barrier.
//      A wait that never completes traps after ~2^34 cycles.
//   4. The masking: keys at or past `valid` are -inf before the row max;
//      tile 0 always holds key 0, so every row's max is finite from the
//      first tile on.  K and V rows past the tensor are zero-filled.
//   5. The bias indices: fh by the key's grid row, fw by its column
//      (row(k) from a float reciprocal of gw, exact for k < 4096, gw <= 64),
//      each read for the query's own row of the staged terms.
//   chip_smoke.py's float32 phases hold plain versions with these faults
//   (the last key tile dropped, valid_len off by one, fh from the next grid
//   row, fw one column off, a window's pad key unmasked) and the model's
//   (lo.hi dropped, V's keys unpermuted, a tile's lo part from the previous
//   tile) against the bound.

#include "sm90.cuh"

namespace {

using sm90::ex2;
using sm90::fence_proxy_async;
using sm90::fence_reg;
using sm90::mbar_arrive;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::named_bar;
using sm90::smem_u32;
using sm90::st_shared_v4;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_wait;

constexpr int BQ = 128;        // queries a block: two consumers of 64
constexpr int BK = 64;         // keys a tile
constexpr int THREADS = 384;   // two consumer warpgroups + the producer
constexpr int CONSUMERS = 256;
constexpr int MAX_GRID = 64;   // K2/K3: key grids up to 64x64

struct Strides {
  long long q[3], k[3], v[3], o[3];   // (batch, head, token), in elements
};

// The shared-memory plan of one instantiation.  A "tile" is one part (hi
// or lo) of a 64-row K-major operand (Q of one consumer, or K: rows x hd
// dims), or of V^T (hd rows x 64 keys): 256 hd bytes either way.
template <int HD, bool RELPOS>
struct Plan {
  static constexpr int TILE = 256 * HD;
  static constexpr int STAGES = (!RELPOS && HD == 64) ? 2 : 1;
  static constexpr int Q_OFF = 0;             // [hi, lo][consumer]
  static constexpr int K_OFF = Q_OFF + 4 * TILE;             // [stage][hi, lo]
  static constexpr int V_OFF = K_OFF + 2 * STAGES * TILE;    // [stage][hi, lo]
  static constexpr int BAR_OFF = V_OFF + 2 * STAGES * TILE;
  static constexpr int BIAS_OFF = BAR_OFF + 8 * 4 * STAGES;  // fh, fw rows
  static constexpr int KPT = HD / 8;          // K float4 a producer thread
  static constexpr int V_ITEMS = 4 * HD;      // V items (4 keys x 4 dims)
  static constexpr int VPT = (V_ITEMS + 127) / 128;
  static_assert(HD == 64 || HD == 80, "head dims 64 and 80");
};

// Bytes of dynamic shared memory of a call (+ 1024 to align the tiles).
template <int HD, bool RELPOS>
__host__ __device__ constexpr int smem_bytes(int gh, int gw) {
  return Plan<HD, RELPOS>::BIAS_OFF +
         (RELPOS ? 4 * BQ * ((gh | 1) + (gw | 1)) : 0) + 1024;
}

// wgmma shared-memory descriptors, as two words.  The low word: start
// address / 16, leading byte offset 16 (unused by K-major swizzled
// layouts); k-steps move it by a constant.  The high word, an immediate of
// the product: 8-row groups 1024 bytes apart under the 128-byte swizzle
// (layout type 1), or 512 bytes apart under the 64-byte swizzle (type 2).
constexpr uint32_t SW128_HI = (1024 >> 4) | (1u << 30);
constexpr uint32_t SW64_HI = (512 >> 4) | (2u << 30);

__device__ __forceinline__ uint32_t desc_lo(uint32_t saddr) {
  return ((saddr & 0x3FFFF) >> 4) | (1u << 16);
}

// Byte offset of (row r, dims f..f+3) in a 64-row K-major tile: dims
// 32i..32i+31 in sub-tile i (rows of 128 bytes, chunk ^ (r % 8)); at head
// dim 80, dims 64-79 in the slab after them (rows of 64 bytes, chunk ^
// ((r / 2) % 4)).
template <int HD>
__device__ __forceinline__ uint32_t kmajor_off(int r, int f) {
  constexpr int NSUB = HD / 32;
  if (f < 32 * NSUB)
    return (f >> 5) * 8192 + r * 128 + ((((f >> 2) & 7) ^ (r & 7)) << 4);
  return NSUB * 8192 + r * 64 +
         ((((f - 32 * NSUB) >> 2) ^ ((r >> 1) & 3)) << 4);
}

// Low descriptor word of k-step kk (8 dims, 32 bytes) of a K-major tile
// whose word is w: sub-tiles 8192 bytes apart, the slab after them.
template <int HD>
__device__ __forceinline__ uint32_t kstep_lo(uint32_t w, int kk) {
  constexpr int NSUB = HD / 32;
  return kk < 4 * NSUB ? w + (kk >> 2) * 512 + (kk & 3) * 2
                       : w + NSUB * 512 + (kk - 4 * NSUB) * 2;
}

// Byte offset of (dim n, key positions p..p+3) in a V^T tile: positions
// 32i..32i+31 in sub-tile i of HD rows of 128 bytes.
template <int HD>
__device__ __forceinline__ uint32_t vt_off(int n, int p) {
  return (p >> 5) * (HD * 128) + n * 128 + ((((p >> 2) & 7) ^ (n & 7)) << 4);
}

// Low descriptor word of k-step j (8 key positions) of a V^T tile whose
// word is w: sub-tiles of 32 keys HD x 128 bytes apart.
template <int HD>
__device__ __forceinline__ uint32_t vstep_lo(uint32_t w, int j) {
  return w + (j >> 2) * (HD * 8) + (j & 3) * 2;
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo (+ at most 2^-22 |x|), both TF32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split4(const float4& x, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  split(x.x, hi[0], lo[0]);
  split(x.y, hi[1], lo[1]);
  split(x.z, hi[2], lo[2]);
  split(x.w, hi[3], lo[3]);
}

__device__ __forceinline__ float lane_of(const float4& x, int u) {
  return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}

// D(64x64) (+)= A(64x8) B(8x64), TF32, A and B K-major in shared memory
// under the same swizzle (descriptor high word HI), their low words a, b.
template <uint32_t HI>
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint32_t a,
                                           uint32_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 hi;\n.reg .b64 da, db;\n"
      "setp.ne.b32 p, %34, 0;\nmov.b32 hi, %35;\n"
      "mov.b64 da, {%32, hi};\nmov.b64 db, {%33, hi};\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "da, db, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a), "r"(b), "r"(scale_d), "n"(HI));
}

// D(64x64) (+)= A(64x8, registers) B(8x64), TF32, B K-major in shared
// memory under the 128-byte swizzle, its low descriptor word b.
__device__ __forceinline__ void mma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint32_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 hi;\n.reg .b64 db;\n"
      "setp.ne.b32 p, %37, 0;\nmov.b32 hi, %38;\n"
      "mov.b64 db, {%36, hi};\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, db, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b), "r"(scale_d),
        "n"(SW128_HI));
}

// D(64x80) (+)= A(64x8, registers) B(8x80), as mma_rs_n64.
__device__ __forceinline__ void mma_rs_n80(float (&d)[40],
                                           const uint32_t (&a)[4],
                                           uint32_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 hi;\n.reg .b64 db;\n"
      "setp.ne.b32 p, %45, 0;\nmov.b32 hi, %46;\n"
      "mov.b64 db, {%44, hi};\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, db, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b), "r"(scale_d),
        "n"(SW128_HI));
}

template <int HD>
__device__ __forceinline__ void mma_pv(float (&d)[HD / 2],
                                       const uint32_t (&a)[4], uint32_t b,
                                       int scale_d) {
  if constexpr (HD == 64) mma_rs_n64(d, a, b, scale_d);
  else mma_rs_n80(d, a, b, scale_d);
}

// k-step kk of S (+)= Q K^T, a and b the tiles' low words.
template <int HD>
__device__ __forceinline__ void mma_qk(float (&sc)[32], uint32_t a,
                                       uint32_t b, int kk, int scale_d) {
  if (kk < 4 * (HD / 32))
    mma_ss_n64<SW128_HI>(sc, kstep_lo<HD>(a, kk), kstep_lo<HD>(b, kk),
                         scale_d);
  else
    mma_ss_n64<SW64_HI>(sc, kstep_lo<HD>(a, kk), kstep_lo<HD>(b, kk),
                        scale_d);
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ float ld_shared_f32(uint32_t addr) {
  float x;
  asm("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(addr));
  return x;
}

__device__ __forceinline__ float4 load4(const float* p, bool full) {
  return full ? __ldg(reinterpret_cast<const float4*>(p))
              : make_float4(0.f, 0.f, 0.f, 0.f);
}

// Producer thread p's share of key tile [row0, row0 + 64) of K: float4 c =
// p + 128 i of the tile's rows (HD / 4 a row); rows past s read as zeros.
template <int HD>
__device__ __forceinline__ void load_k(float4 (&x)[HD / 8], const float* kb,
                                       long long ld, int row0, int s, int p) {
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    const int c = p + 128 * i, r = c / (HD / 4), ch = c - r * (HD / 4);
    const int key = row0 + r;
    x[i] = load4(kb + (long long)(key < s ? key : 0) * ld + 4 * ch, key < s);
  }
}

template <int HD>
__device__ __forceinline__ void store_k(const float4 (&x)[HD / 8],
                                        uint32_t hi, uint32_t lo, int p) {
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    const int c = p + 128 * i, r = c / (HD / 4), ch = c - r * (HD / 4);
    uint32_t h[4], l[4];
    split4(x[i], h, l);
    const uint32_t off = kmajor_off<HD>(r, 4 * ch);
    st_shared_v4(hi + off, h[0], h[1], h[2], h[3]);
    st_shared_v4(lo + off, l[0], l[1], l[2], l[3]);
  }
}

// A V item: dims 4ch..4ch+3 of the keys 8G + 2j + par (j < 4) of 8-key
// group G, which land at positions 8G + 4 par + j of V^T.  Item bits: par,
// g (2), chq (2), the tile half hh, then chb; G = 4 hh + g, ch = 4 chb +
// chq: a quarter warp's 8 items write 8 distinct 16-byte chunks of one V^T
// row, and a warp reads 8 keys x 64 contiguous bytes a load.
struct VItem {
  int par, g, hh, ch;
  __device__ __forceinline__ explicit VItem(int item)
      : par(item & 1), g((item >> 1) & 3), hh((item >> 5) & 1),
        ch(4 * (item >> 6) + ((item >> 3) & 3)) {}
  __device__ __forceinline__ int key(int j) const {
    return 8 * (4 * hh + g) + 2 * j + par;
  }
};

template <int HD, int VPT>
__device__ __forceinline__ void load_v(float4 (&x)[VPT][4], const float* vb,
                                       long long ld, int row0, int s, int p) {
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int item = p + 128 * i;
    if (item < 4 * HD) {
      const VItem it(item);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = row0 + it.key(j);
        x[i][j] = load4(vb + (long long)(key < s ? key : 0) * ld + 4 * it.ch,
                        key < s);
      }
    }
  }
}

template <int HD, int VPT>
__device__ __forceinline__ void store_v(const float4 (&x)[VPT][4],
                                        uint32_t hi, uint32_t lo, int p) {
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int item = p + 128 * i;
    if (item < 4 * HD) {
      const VItem it(item);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        uint32_t h[4], l[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) split(lane_of(x[i][j], u), h[j], l[j]);
        const uint32_t off =
            vt_off<HD>(4 * it.ch + u, 8 * (4 * it.hh + it.g) + 4 * it.par);
        st_shared_v4(hi + off, h[0], h[1], h[2], h[3]);
        st_shared_v4(lo + off, l[0], l[1], l[2], l[3]);
      }
    }
  }
}

template <int HD, bool RELPOS>
__global__ void __launch_bounds__(THREADS, 1)
    attn_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o,
             const float* __restrict__ fh, const float* __restrict__ fw,
             Strides st, int heads, int sq, int s, int valid, int gh, int gw,
             float scale) {
  using P = Plan<HD, RELPOS>;
  constexpr int ST = P::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  float* fhs = reinterpret_cast<float*>(smem_raw + (base - raw) +
                                        P::BIAS_OFF);
  const int ghs = gh | 1, gws = gw | 1;
  float* fws = fhs + BQ * ghs;
  const uint32_t kfull = base + P::BAR_OFF, kempty = kfull + 8 * ST;
  const uint32_t vfull = kempty + 8 * ST, vempty = vfull + 8 * ST;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const float* qb = q + b * st.q[0] + h * st.q[1];
  const float* kb = k + b * st.k[0] + h * st.k[1];
  const float* vb = v + b * st.v[0] + h * st.v[1];
  const int ntiles = (valid + BK - 1) / BK;

  if (tid == 0) {
    for (int i = 0; i < ST; ++i) {
      mbar_init(kfull + 8 * i, THREADS - CONSUMERS);
      mbar_init(vfull + 8 * i, THREADS - CONSUMERS);
      mbar_init(kempty + 8 * i, CONSUMERS / 32);
      mbar_init(vempty + 8 * i, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // The block's 128 query rows (scaled for K2/K3), split once: consumer
  // c's 64 rows form its hi and lo tiles.  Rows past Sq are zeros.
  for (int c = tid; c < BQ * (HD / 4); c += THREADS) {
    const int r = c / (HD / 4), ch = c - r * (HD / 4);
    float4 x = load4(qb + (long long)(q0 + r < sq ? q0 + r : 0) * st.q[2] +
                         4 * ch,
                     q0 + r < sq);
    if (RELPOS) {
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
    }
    uint32_t hi[4], lo[4];
    split4(x, hi, lo);
    const uint32_t off = kmajor_off<HD>(r & 63, 4 * ch);
    const uint32_t t_hi = base + P::Q_OFF + (r >> 6) * P::TILE;
    st_shared_v4(t_hi + off, hi[0], hi[1], hi[2], hi[3]);
    st_shared_v4(t_hi + 2 * P::TILE + off, lo[0], lo[1], lo[2], lo[3]);
  }
  if (RELPOS) {
    // The block's rows of fh and fw (contiguous); rows past Sq get zeros.
    const long long row = ((long long)b * heads + h) * sq + q0;
    const int nq = min(BQ, sq - q0);
    for (int i = tid; i < BQ * gh; i += THREADS) {
      const int r = i / gh;
      fhs[r * ghs + i - r * gh] = r < nq ? fh[row * gh + i] : 0.f;
    }
    for (int i = tid; i < BQ * gw; i += THREADS) {
      const int r = i / gw;
      fws[r * gws + i - r * gw] = r < nq ? fw[row * gw + i] : 0.f;
    }
  }
  fence_proxy_async();
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer warpgroup: split K and V into the stages ----
    const int p = tid - CONSUMERS;
    float4 kx[P::KPT], vx[P::VPT][4];
    load_k<HD>(kx, kb, st.k[2], 0, s, p);
    load_v<HD, P::VPT>(vx, vb, st.v[2], 0, s, p);
    for (int t = 0; t < ntiles; ++t) {
      const int stg = t % ST;
      const uint32_t par = ((t / ST) & 1) ^ 1;
      const uint32_t k_hi = base + P::K_OFF + 2 * stg * P::TILE;
      const uint32_t v_hi = base + P::V_OFF + 2 * stg * P::TILE;
      mbar_wait(kempty + 8 * stg, par);
      store_k<HD>(kx, k_hi, k_hi + P::TILE, p);
      fence_proxy_async();
      mbar_arrive(kfull + 8 * stg);
      if (t + 1 < ntiles) load_k<HD>(kx, kb, st.k[2], (t + 1) * BK, s, p);
      mbar_wait(vempty + 8 * stg, par);
      store_v<HD, P::VPT>(vx, v_hi, v_hi + P::TILE, p);
      fence_proxy_async();
      mbar_arrive(vfull + 8 * stg);
      if (t + 1 < ntiles)
        load_v<HD, P::VPT>(vx, vb, st.v[2], (t + 1) * BK, s, p);
    }
    return;
  }

  // ---- consumer warpgroup c: query rows 64c..64c+63 of the block ----
  constexpr int NO = HD / 2;         // O accumulators a thread
  constexpr int TILE_W = P::TILE >> 4;   // a tile in descriptor words
  const int c = tid >> 7, warp = tid >> 5, lane = tid & 31;
  const int t4 = lane & 3;
  const int lrow = c * 64 + (warp & 3) * 16 + (lane >> 2);   // and + 8
  const uint32_t q_hi = desc_lo(base + P::Q_OFF + c * P::TILE);
  const uint32_t q_lo = q_hi + 2 * TILE_W;
  // The staged bias rows of lrow (those of lrow + 8 are 8 rows further).
  const uint32_t fh_row = base + P::BIAS_OFF + 4 * lrow * ghs;
  const uint32_t fw_row = base + P::BIAS_OFF + 4 * BQ * ghs + 4 * lrow * gws;
  const float inv_gw = 1.f / (float)gw;

  float acc[NO], part[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = part[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // The consumers issue Q K^T in turns (named barriers 1 and 2: consumer
  // 0 first), so that one's products run while the other's softmax does.
  if (c == 1) named_arrive(1, CONSUMERS);
  for (int t = 0; t < ntiles; ++t) {
    const int stg = t % ST;
    const uint32_t par = (t / ST) & 1;
    const uint32_t k_hi = desc_lo(base + P::K_OFF + 2 * stg * P::TILE);
    const uint32_t k_lo = k_hi + TILE_W;

    // S = Q K^T: lo.hi and hi.lo for every k-step, then hi.hi.
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    mbar_wait(kfull + 8 * stg, par);
    named_bar(1 + c, CONSUMERS);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) mma_qk<HD>(sc, q_lo, k_hi, kk, kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) mma_qk<HD>(sc, q_hi, k_lo, kk, 1);
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) mma_qk<HD>(sc, q_hi, k_hi, kk, 1);
    wgmma_commit();
    if (c == 0 || t + 1 < ntiles) named_arrive(2 - c, CONSUMERS);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 32; ++i) fence_reg(sc[i]);
    __syncwarp();
    if (lane == 0) mbar_arrive(kempty + 8 * stg);

    // Scale or bias, and the mask: sc[4j + cc] is row lrow, key
    // 8j + 2 t4 + cc of the tile; sc[4j + 2 + cc] row lrow + 8.
    const int key0 = t * BK + 2 * t4;
    const float kf0 = (float)key0 + 0.5f;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int key = key0 + 8 * j + cc;
        const bool ok = key < valid;
        float x0 = sc[4 * j + cc], x1 = sc[4 * j + 2 + cc];
        if constexpr (RELPOS) {
          const int kr =
              ok ? __float2int_rz((kf0 + (float)(8 * j + cc)) * inv_gw) : 0;
          const int kc = ok ? key - kr * gw : 0;
          const uint32_t ah = fh_row + 4 * kr, aw = fw_row + 4 * kc;
          x0 = x0 + ld_shared_f32(ah) + ld_shared_f32(aw);
          x1 = x1 + ld_shared_f32(ah + 32 * ghs) + ld_shared_f32(aw + 32 * gws);
        } else {
          x0 *= scale;
          x1 *= scale;
        }
        sc[4 * j + cc] = ok ? x0 : -INFINITY;
        sc[4 * j + 2 + cc] = ok ? x1 : -INFINITY;
        mx[0] = fmaxf(mx[0], sc[4 * j + cc]);
        mx[1] = fmaxf(mx[1], sc[4 * j + 2 + cc]);
      }

    // Online softmax over the row's 4 threads (t4); exp(x - m) as
    // ex2(x log2(e) - m log2(e)), the second term rounded once a row (a
    // factor common to the row, which the division by l cancels).
    float alpha[2], neg[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      alpha[r] = ex2((m[r] - mn) * sm90::LOG2E);
      m[r] = mn;
      neg[r] = -mn * sm90::LOG2E;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      sc[i] = ex2(fmaf(sc[i], sm90::LOG2E, neg[r]));
      ls[r] += sc[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];

    // part = P V for the tile, fresh: per half of 32 keys, lo.hi and hi.lo
    // for its four k-steps, then hi.hi.  Key group j's A fragment is
    // (d0, d2, d1, d3) of its accumulators: positions t4 and t4 + 4 hold
    // keys 2 t4 and 2 t4 + 1, as the producer ordered V^T.
    const uint32_t v_hi = desc_lo(base + P::V_OFF + 2 * stg * P::TILE);
    const uint32_t v_lo = v_hi + TILE_W;
    uint32_t ph[8][4], pl[8][4];
    mbar_wait(vfull + 8 * stg, par);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
      for (int j = 4 * hf; j < 4 * hf + 4; ++j) {
        split(sc[4 * j], ph[j][0], pl[j][0]);
        split(sc[4 * j + 2], ph[j][1], pl[j][1]);
        split(sc[4 * j + 1], ph[j][2], pl[j][2]);
        split(sc[4 * j + 3], ph[j][3], pl[j][3]);
      }
      wgmma_fence();
#pragma unroll
      for (int j = 4 * hf; j < 4 * hf + 4; ++j)
        mma_pv<HD>(part, pl[j], vstep_lo<HD>(v_hi, j), j > 0);
#pragma unroll
      for (int j = 4 * hf; j < 4 * hf + 4; ++j)
        mma_pv<HD>(part, ph[j], vstep_lo<HD>(v_lo, j), 1);
#pragma unroll
      for (int j = 4 * hf; j < 4 * hf + 4; ++j)
        mma_pv<HD>(part, ph[j], vstep_lo<HD>(v_hi, j), 1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int j = 4 * hf; j < 4 * hf + 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          fence_reg(ph[j][i]);
          fence_reg(pl[j][i]);
        }
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) fence_reg(part[i]);
    __syncwarp();
    if (lane == 0) mbar_arrive(vempty + 8 * stg);
#pragma unroll
    for (int i = 0; i < NO; ++i)
      acc[i] = fmaf(acc[i], alpha[(i >> 1) & 1], part[i]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + lrow + 8 * r;
    if (row >= sq) continue;
    float* ob = o + b * st.o[0] + h * st.o[1] + (long long)row * st.o[2];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(ob + 8 * j + 2 * t4) =
          make_float2(acc[4 * j + 2 * r] / l[r], acc[4 * j + 2 * r + 1] / l[r]);
  }
}

template <int HD, bool RELPOS>
cudaError_t configure() {
  // The most shared memory any call of this instantiation asks for.
  static const cudaError_t status = cudaFuncSetAttribute(
      attn_f32<HD, RELPOS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<HD, RELPOS>(MAX_GRID, MAX_GRID));
  return status;
}

template <int HD, bool RELPOS>
int launch(const float* q, const float* k, const float* v, float* o,
           const float* fh, const float* fw, const Strides& st, int batch,
           int heads, int sq, int s, int valid, int gh, int gw, float scale,
           cudaStream_t stream) {
  cudaError_t e = configure<HD, RELPOS>();
  if (e != cudaSuccess) return e;
  const dim3 grid((sq + BQ - 1) / BQ, heads, batch);
  const int smem = smem_bytes<HD, RELPOS>(gh, gw);
  attn_f32<HD, RELPOS><<<grid, THREADS, smem, stream>>>(
      q, k, v, o, fh, fw, st, heads, sq, s, valid, gh, gw, scale);
  return cudaGetLastError();
}

template <int HD, bool RELPOS>
int occupancy(int gh, int gw, int* out) {
  cudaError_t e = configure<HD, RELPOS>();
  if (e != cudaSuccess) return e;
  const int smem = smem_bytes<HD, RELPOS>(gh, gw);
  out[0] = smem;
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
