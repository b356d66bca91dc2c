// Non-causal flash attention (head dim 64, bf16) for Hopper (sm_90a): TMA
// loads, warp specialization and wgmma for both products.
//
// Replaces `flash_mha` of crowdsam_tpu/models/attention.py (the library
// Pallas `flash_attention`, K4): DINOv2's global attention over 1 + 73^2 =
// 5330 tokens, 16 heads, keys at or beyond `valid_len` masked.
//
// Bound: tensor-core operations.  4*S^2*64 FLOP per head against 4*S*64*2
// bytes of q/k/v/o is ~1300 FLOP/byte at S = 5330, far above the card's
// ~295: 116 GFLOP, 0.118 ms at 989 TFLOP/s (16 heads).  At head dim 64 the
// exponentials cost about as much as the products (64x128 exp2 per
// 2x64x128x64 FLOP: 512 MUFU cycles against 512 tensor cycles an SM), so
// the softmax of one warpgroup has to overlap the products of another.
//
// Design.  A block per (64-query tile, head, batch), two warpgroups:
//   - the producer warpgroup gives its registers away (setmaxnreg.dec);
//     one of its threads loads the Q tile once and keeps a ring of STAGES
//     K/V stages (128 keys each: 16 KB of K, 16 KB of V) in flight with TMA
//     (cp.async.bulk.tensor) into 128-byte-swizzled shared memory, behind
//     full/empty mbarriers;
//   - the consumer warpgroup (setmaxnreg.inc) owns the 64 query rows: S =
//     Q K^T by wgmma.m64n128k16 (A = Q, B = K, both K-major in shared
//     memory), the online softmax in f32 registers in the log2 domain, then
//     O += P V by wgmma.m64n64k16 with P from registers (packed to bf16
//     straight from S's accumulators: the accumulator layout of a 16-column
//     pair is the A-fragment layout) and V from shared memory through the
//     transposed (MN-major) descriptor.
// BLOCKS_PER_SM blocks share an SM.  They run out of step, so one block's
// exponentials overlap another's products.  Two consumer warpgroups in one
// block, fed by one ring, ran in lock step and were slower: their
// softmaxes, and then their products, contended for the same units.
// The output is stored from registers straight into its (B, S, H, D) buffer.
//
// Where this design can go wrong, and what it does about it:
//   1. cuTensorMapEncodeTiled is driver API and the library is loaded with
//      ctypes, not linked to libcuda: the function comes from
//      cudaGetDriverEntryPoint(ByVersion), once per process.
//   2. Matching layouts: TMA writes each 128-byte row with 16-byte chunks
//      XORed by (row % 8) (SWIZZLE_128B); the wgmma descriptors say the
//      same (layout type 1 = 128B swizzle, 8-row groups 1024 bytes apart,
//      every tile 1024-byte aligned so the base offset is 0).  A K-major
//      operand steps through its 64 dims by moving the start address 32
//      bytes inside the swizzle atom; V steps 16 keys (2048 bytes) at a
//      time.  A mismatch permutes dims inside the products: the smoke run's
//      faults include one.
//   3. mbarrier phase parity: stage s of tile i waits for parity (i /
//      STAGES) & 1 on its full barriers; the producer waits for the
//      opposite parity on the empty one, so its first round passes at
//      once.  A stage is released (one arrival per consumer warp, 4 in
//      all) only after wgmma.wait_group has retired the PV product that
//      read its V.  A wait that never completes traps after ~9 s instead
//      of hanging the card.
//   4. Ragged edges: TMA fills rows past S with zeros; the key loop ends at
//      kv_len, and only the tile that holds kv_len masks (every query row
//      masks the pad keys, as the plain version); query rows >= S are not
//      stored.
//   5. Registers: a consumer thread holds 64 (S) + 32 (O) + 32 (P) f32/b32
//      fragments.  Two blocks of 256 threads an SM start at 128 registers a
//      thread; the producer warpgroup drops to 24 so that the consumers may
//      take 232.  `-Xptxas -v` of this file is printed by chip_smoke.py.
//   6. Host cost: the shared-memory attribute is set once per process; the
//      three tensor maps are encoded per call (part of the wrapper's time).
//
// Operands are (B, H, S, 64) views with a contiguous head dim and 16-byte
// aligned base and strides (the qkv projection read in place); each comes
// with its tensor-map layout from `models/attention.tma_layout`.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;             // head dim: one 128-byte row a token
constexpr int BQ = 64;            // query rows per block: one warpgroup
constexpr int BK = 128;           // keys per stage
constexpr int STAGES = 3;
constexpr int BLOCKS_PER_SM = 2;
constexpr int THREADS = 256;      // consumer warpgroup + producer warpgroup
constexpr int CONSUMER_WARPS = 4;
constexpr int Q_BYTES = BQ * D * 2;         // 8 KB
constexpr int TILE_BYTES = BK * D * 2;      // 16 KB of K or V a stage
constexpr int Q_OFF = 0;
constexpr int K_OFF = Q_OFF + Q_BYTES;
constexpr int V_OFF = K_OFF + STAGES * TILE_BYTES;
constexpr int BAR_OFF = V_OFF + STAGES * TILE_BYTES;
constexpr int N_BARS = 1 + 3 * STAGES;      // q_full, full_k, full_v, empty
// + 1024: the tiles start at the first 1024-byte boundary of the window.
constexpr int SMEM_BYTES = BAR_OFF + 8 * N_BARS + 1024;
constexpr int NS = BK / 2;        // S accumulators a thread (64 x BK tile)
constexpr int NP = BK / 16;       // 16-key steps of PV

struct Params {
  __nv_bfloat16* o;
  long long obs, ohs, old;   // output batch, head, token strides (elements)
  int seq, kv_len;
  float scale_log2;          // softmax scale * log2(e)
  int pos[3][3];             // q/k/v: tensor-map dim of (head, token, batch)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait for the phase of `parity` to complete; trap after ~2^34 cycles (a
// lost arrival or transfer), so that a fault ends the launch with an error.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > (1LL << 34)) __trap();
  }
}

// One TMA box (64 dims x BQ or BK tokens) into shared memory; completion
// is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Tensor-map coordinate of dim `slot` (1..3) for (head, token, batch).
__device__ __forceinline__ int coord(const int* pos, int slot, int h, int row,
                                     int b) {
  return pos[0] == slot ? h : (pos[1] == slot ? row : b);
}

__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, const int* pos, int h,
                                          int row, int b) {
  tma_load_4d(dst, map, bar, 0, coord(pos, 1, h, row, b),
              coord(pos, 2, h, row, b), coord(pos, 3, h, row, b));
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets in 16-byte units, layout type 1 in bits 62-63.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
  uint64_t d = (uint64_t)((saddr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

// K-major tile (rows of 64 bf16 = 128 bytes): 8-row groups 1024 bytes apart;
// the leading offset is unused inside one swizzle atom.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t saddr) {
  return sw128_desc(saddr, 16, 1024);
}

// MN-major tile (V: keys x 64 dims, the dims contiguous): 8-key groups 1024
// bytes apart; the N extent (64) is one atom, so the other offset is unused.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t saddr) {
  return sw128_desc(saddr, 1024, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin a register across the asynchronous product: the compiler neither
// reads an accumulator before the wait nor reuses an A fragment's register
// while the product may still read it.
__device__ __forceinline__ void fence_reg(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}
__device__ __forceinline__ void fence_reg(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D(64x128, f32) (+)= A(64x16) B(16x128), A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float* d, uint64_t da,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64x64, f32) += A(64x16, bf16 registers) B(16x64), B MN-major in
// shared memory (the transposed form: imm-trans-b = 1).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float* d, const uint32_t* a,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Online softmax of one 64 x BK tile of S, in the wgmma accumulator
// layout: sc[4j + c] is row g, key 8j + 2*t4 + c; sc[4j + 2 + c] is row
// g + 8.  Keys from `lim` on are masked.  Updates the running max m (log2
// domain) and sum l of both rows, returns the factor `alpha` by which O is
// to be rescaled, and packs P = exp2(S * scale_log2 - m) into bf16 A
// fragments (keys 16kq..16kq+15 are accumulator chunks 2kq and 2kq+1).
// Maxes and sums run in independent partials, so that no long dependent
// chain holds the warp.
__device__ __forceinline__ void softmax_tile(float (&sc)[NS],
                                             uint32_t (&pa)[NP][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int lim,
                                             int t4, float sl2) {
  if (lim < BK) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (8 * j + 2 * t4 + c >= lim)
          sc[4 * j + c] = sc[4 * j + 2 + c] = -INFINITY;
  }
  float mx[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) mx[r][i] = -INFINITY;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      mx[r][j & 3] = fmaxf(mx[r][j & 3],
                           fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
  float neg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    const float mn = fmaxf(m[r], v * sl2);
    alpha[r] = ex2(m[r] - mn);
    m[r] = mn;
    neg[r] = -mn;
  }
  float ls[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int kq = 0; kq < NP; ++kq) {
    float e[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      e[i] = ex2(fmaf(sc[8 * kq + i], sl2, neg[(i >> 1) & 1]));
    ls[0][kq & 1] += (e[0] + e[1]) + (e[4] + e[5]);
    ls[1][kq & 1] += (e[2] + e[3]) + (e[6] + e[7]);
    pa[kq][0] = pack_bf16(e[0], e[1]);
    pa[kq][1] = pack_bf16(e[2], e[3]);
    pa[kq][2] = pack_bf16(e[4], e[5]);
    pa[kq][3] = pack_bf16(e[6], e[7]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + (ls[r][0] + ls[r][1]);
}

__device__ __forceinline__ void rescale(float (&o)[32], const float (&a)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    o[4 * j] *= a[0];
    o[4 * j + 1] *= a[0];
    o[4 * j + 2] *= a[1];
    o[4 * j + 3] *= a[1];
  }
}

// S = Q K^T for one stage: four k-steps of 16 dims (32 bytes inside the
// swizzle atom).
__device__ __forceinline__ void issue_qk(float (&sc)[NS], uint32_t q_tile,
                                         uint32_t k_tile) {
  static_assert(BK == 128, "one m64n128k16 product per 16 dims");
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n128k16_ss(sc, kmajor_desc(q_tile + kk * 32),
                        kmajor_desc(k_tile + kk * 32), kk > 0 ? 1 : 0);
}

// O += P V for one stage: k-steps of 16 keys (2048 bytes of V each).
__device__ __forceinline__ void issue_pv(float (&o)[32],
                                         const uint32_t (&pa)[NP][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kq = 0; kq < NP; ++kq)
    wgmma_m64n64k16_rs(o, pa[kq], mnmajor_desc(v_tile + kq * 2048));
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_reg(x[i]);
}
__device__ __forceinline__ void fence_regs(uint32_t (&x)[NP][4]) {
#pragma unroll
  for (int k = 0; k < NP; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) fence_reg(x[k][i]);
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
flash_attn_sm90(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sq = base + Q_OFF, sk = base + K_OFF, sv = base + V_OFF;
  const uint32_t q_full = base + BAR_OFF;
  const uint32_t full_k = q_full + 8;                 // [STAGES]
  const uint32_t full_v = full_k + 8 * STAGES;        // [STAGES]
  const uint32_t empty = full_v + 8 * STAGES;         // [STAGES]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
  const int n_tiles = (p.kv_len + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {
    // ---- producer warpgroup: one thread keeps the K/V ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == CONSUMER_WARPS && lane == 0) {
      prefetch_map(&tm_q);
      prefetch_map(&tm_k);
      prefetch_map(&tm_v);
      mbar_expect_tx(q_full, Q_BYTES);
      load_tile(sq, &tm_q, q_full, p.pos[0], h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(full_k + 8 * s, TILE_BYTES);
        load_tile(sk + s * TILE_BYTES, &tm_k, full_k + 8 * s, p.pos[1], h,
                  it * BK, b);
        mbar_expect_tx(full_v + 8 * s, TILE_BYTES);
        load_tile(sv + s * TILE_BYTES, &tm_v, full_v + 8 * s, p.pos[2], h,
                  it * BK, b);
      }
    }
    return;
  }

  // ---- consumer warpgroup: 64 query rows ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int t4 = lane & 3;
  const float sl2 = p.scale_log2;
  float o[32], sc[NS], alpha[2];
  uint32_t pa[NP][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const uint32_t par = (it / STAGES) & 1;
    mbar_wait(full_k + 8 * s, par);
    wgmma_fence();
    issue_qk(sc, sq, sk + s * TILE_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    softmax_tile(sc, pa, m, l, alpha, p.kv_len - it * BK, t4, sl2);
    rescale(o, alpha);
    mbar_wait(full_v + 8 * s, par);
    wgmma_fence();
    issue_pv(o, pa, sv + s * TILE_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
    const int row = q0 + warp * 16 + (lane >> 2) + 8 * r;
    if (row >= p.seq) continue;
    const float inv = 1.f / l[r];
    __nv_bfloat16* out = p.o + (long long)b * p.obs + (long long)h * p.ohs +
                         (long long)row * p.old + 2 * t4;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
  }
}

PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      ptr = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }();
  return fn;
}

// lay: dims[4] (elements, innermost first), byte strides of dims 1-3,
// box[4], then the dims of (head, token, batch) among 1-3.  The box must be
// 64 dims x `rows` tokens: the kernel's expect_tx counts those bytes.
bool encode(CUtensorMap* map, const void* ptr, const long long* lay,
            int* pos, int rows) {
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], elem[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) {
    dims[i] = (cuuint64_t)lay[i];
    box[i] = (cuuint32_t)lay[7 + i];
  }
  for (int i = 0; i < 3; ++i) {
    strides[i] = (cuuint64_t)lay[4 + i];
    pos[i] = (int)lay[11 + i];
    if (pos[i] < 1 || pos[i] > 3) return false;
  }
  if (dims[0] != D || box[0] != D || box[pos[1]] != (cuuint32_t)rows ||
      box[pos[0]] != 1 || box[pos[2]] != 1)
    return false;
  return encode_fn()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                     const_cast<void*>(ptr), dims, strides, box, elem,
                     CU_TENSOR_MAP_INTERLEAVE_NONE,
                     CU_TENSOR_MAP_SWIZZLE_128B,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// q, k, v: (B, H, S, 64) bf16 operands with their tensor-map layouts
// (`layouts`: 3 x 14 int64, q then k then v); o: the output, strides
// `o_strides` (batch, head, token; elements).  Returns cudaGetLastError(),
// or -1 when the CUDA driver has no cuTensorMapEncodeTiled, -2 - i when
// operand i's tensor map is refused.
extern "C" int flash_sm90_forward(const void* q, const void* k, const void* v,
                                  void* o, const long long* layouts,
                                  const long long* o_strides, int batch,
                                  int heads, int seq, int kv_len, float scale,
                                  void* stream) {
  if (encode_fn() == nullptr) return -1;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attn_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  alignas(64) CUtensorMap maps[3];
  Params p;
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i)
    if (!encode(&maps[i], ptrs[i], layouts + 14 * i, p.pos[i],
                i == 0 ? BQ : BK))
      return -2 - i;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.obs = o_strides[0];
  p.ohs = o_strides[1];
  p.old = o_strides[2];
  p.seq = seq;
  p.kv_len = kv_len;
  p.scale_log2 = scale * 1.4426950408889634f;
  if (seq > 0 && batch > 0 && kv_len > 0) {
    const dim3 grid((seq + BQ - 1) / BQ, heads, batch);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    flash_attn_sm90<<<grid, THREADS, SMEM_BYTES, st>>>(maps[0], maps[1],
                                                       maps[2], p);
  }
  return (int)cudaGetLastError();
}
