// Hopper (sm_90a) building blocks shared by the attention kernels: mbarrier
// waits, TMA tensor loads, wgmma descriptors and products for 128-byte
// swizzled tiles of 64 bf16 a row (and, for head dim 80, 32-byte swizzled
// tiles of the 16 dims past the first 64), the online softmax of one 64 x
// 128 tile of scores in the wgmma accumulator layout, and the driver entry
// point that encodes tensor maps without linking libcuda.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sm90 {

constexpr int D = 64;           // head dim: one 128-byte row a token
constexpr int BQ = 64;          // query rows of one consumer warpgroup
constexpr int BK = 128;         // keys of one score tile
constexpr int NS = BK / 2;      // S accumulators a thread (64 x BK tile)
constexpr int NP = BK / 16;     // 16-key steps of PV
// A score tile of TK keys (128, or 112 for K2's windows) holds TK / 2
// accumulators a thread (NSC) and TK / 16 A fragments of P: the helpers
// below take the tile width from their arrays.
constexpr int ROW_BYTES = D * 2;
constexpr float LOG2E = 1.4426950408889634f;

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

// Generic-proxy writes to shared memory (st.shared, cp.async) made visible
// to the async proxy (wgmma operands, TMA) of this block.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier of the `threads` threads of named barrier `id` (0 is
// __syncthreads).
__device__ __forceinline__ void named_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

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

__device__ __forceinline__ void tma_load_5d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// cp.async of 16 bytes global -> shared; src_bytes 0 fills zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ uint32_t ld_shared_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint32_t a,
                                             uint32_t b, uint32_t c,
                                             uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

// Byte offset of (row, 16-byte chunk) in a tile of 128-byte rows under the
// 128-byte swizzle that TMA writes and the wgmma descriptors read: the
// chunk index XORed with the row's position in its 8-row group (the tile
// 1024-byte aligned).
__device__ __forceinline__ uint32_t sw128(int row, int chunk) {
  return (uint32_t)(row * ROW_BYTES + ((chunk ^ (row & 7)) << 4));
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

template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_reg(x[i]);
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&x)[N][4]) {
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) fence_reg(x[k][i]);
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

// D(64x112, f32) (+)= A(64x16) B(16x112), A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n112k16_ss(float* d, uint64_t da,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55}, "
      "%56, %57, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[55])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64x64, f32) (+)= A(64x16) B(16x64), A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float* d, uint64_t da,
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
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

// One k-step of 16 dims of a 64 x (2 NSC) score tile.
template <int NSC>
__device__ __forceinline__ void wgmma_scores(float (&sc)[NSC], uint64_t da,
                                             uint64_t db, int scale_d) {
  static_assert(NSC == 64 || NSC == 56, "tiles of 128 or 112 keys");
  if constexpr (NSC == 64) wgmma_m64n128k16_ss(sc, da, db, scale_d);
  else wgmma_m64n112k16_ss(sc, da, db, scale_d);
}

// S (+)= Q K^T over the 64 head dims of one key tile: four k-steps of 16
// dims (32 bytes inside the swizzle atom).
template <int NSC>
__device__ __forceinline__ void issue_qk(float (&sc)[NSC], uint32_t q_tile,
                                         uint32_t k_tile, bool accumulate) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_scores(sc, kmajor_desc(q_tile + kk * 32),
                 kmajor_desc(k_tile + kk * 32),
                 (accumulate || kk > 0) ? 1 : 0);
}

// O += P V for one tile: k-steps of 16 keys (2048 bytes of V each).
template <int NPV>
__device__ __forceinline__ void issue_pv(float (&o)[32],
                                         const uint32_t (&pa)[NPV][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kq = 0; kq < NPV; ++kq)
    wgmma_m64n64k16_rs(o, pa[kq], mnmajor_desc(v_tile + kq * 2048));
}

// Online softmax of one 64 x (2 NSC) tile of S, in the wgmma accumulator
// layout: sc[4j + c] is row g, key 8j + 2*t4 + c; sc[4j + 2 + c] is row
// g + 8.  The logits in the log2 domain are sc * sl2 + off[r][h], off a
// term of row r (g, g + 8) and 64-key half h of the tile.  Keys from
// `lim` on are masked.  Updates the running max m (log2 domain) and sum l
// of both rows, returns the factor `alpha` by which O is to be rescaled,
// and packs P = exp2(logit - m) into bf16 A fragments (keys 16kq..16kq+15
// are accumulator chunks 2kq and 2kq+1).  Maxes and sums run in
// independent partials, so that no long dependent chain holds the warp.
template <int NSC>
__device__ __forceinline__ void softmax_tile(float (&sc)[NSC],
                                             uint32_t (&pa)[NSC / 8][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int lim,
                                             int t4, float sl2,
                                             const float (&off)[2][2]) {
  constexpr int TK = 2 * NSC;
  if (lim < TK) {
#pragma unroll
    for (int j = 0; j < TK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (8 * j + 2 * t4 + c >= lim)
          sc[4 * j + c] = sc[4 * j + 2 + c] = -INFINITY;
  }
  float mx[2][2][2];              // [row][half][partial]
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) mx[r][i >> 1][i & 1] = -INFINITY;
#pragma unroll
  for (int j = 0; j < TK / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      mx[r][j >> 3][j & 1] =
          fmaxf(mx[r][j >> 3][j & 1],
                fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
  float neg[2][2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v = fmaxf(fmaxf(mx[r][0][0], mx[r][0][1]) * sl2 + off[r][0],
                    fmaxf(mx[r][1][0], mx[r][1][1]) * sl2 + off[r][1]);
#pragma unroll
    for (int o = 1; o < 4; o <<= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    const float mn = fmaxf(m[r], v);
    alpha[r] = ex2(m[r] - mn);
    m[r] = mn;
    neg[r][0] = off[r][0] - mn;
    neg[r][1] = off[r][1] - mn;
  }
  float ls[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int kq = 0; kq < TK / 16; ++kq) {
    const int h = kq >> 2;        // keys 16 kq.. lie in tile half h
    float e[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      e[i] = ex2(fmaf(sc[8 * kq + i], sl2, neg[(i >> 1) & 1][h]));
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

// cuTensorMapEncodeTiled from the runtime's driver entry point, once per
// process (the library is loaded with ctypes, not linked to libcuda).
inline PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
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

// A bf16 tensor map of `rank` dims (innermost first, `dims` in elements,
// byte `strides` of dims 1..rank-1) whose box of `box` elements lands in
// shared memory under the 128-byte swizzle.
// (`swizzle`: the 32-byte swizzle for the 16-dim slab of head dim 80.)
inline bool encode_bf16(CUtensorMap* map, const void* ptr, int rank,
                        const cuuint64_t* dims, const cuuint64_t* strides,
                        const cuuint32_t* box,
                        CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return encode_fn()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                     const_cast<void*>(ptr), dims, strides, box, elem,
                     CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                     CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                     CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 4-d map of one (B, H, S, 64) operand from its layout row (14 int64:
// dims[4], byte strides of dims 1-3, box[4], the map dims of (head, token,
// batch) among 1-3, as `models/attention.tma_layout` writes it).  The box
// must be 64 dims x `rows` tokens: a kernel's expect_tx counts those bytes.
inline bool encode_bhsd(CUtensorMap* map, const void* ptr,
                        const long long* lay, int* pos, int rows) {
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4];
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
  return encode_bf16(map, ptr, 4, dims, strides, box);
}

// Tensor-map coordinate of dim `slot` (1..3) for (head, token, batch).
__device__ __forceinline__ int coord(const int* pos, int slot, int h, int row,
                                     int b) {
  return pos[0] == slot ? h : (pos[1] == slot ? row : b);
}

__device__ __forceinline__ void load_bhsd(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, const int* pos, int h,
                                          int row, int b) {
  tma_load_4d(dst, map, bar, 0, coord(pos, 1, h, row, b),
              coord(pos, 2, h, row, b), coord(pos, 3, h, row, b));
}

// ---------------------------------------------------------------------------
// Head dim 80 (SAM ViT-H): a token's 80 dims as two slabs.  Dims 0-63 keep
// the 128-byte rows above; dims 64-79 form a second tile of 32-byte rows
// under the 32-byte swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_32B, wgmma layout
// type 3), so that Q K^T takes one more k-step and P V one m64n16k16 more.
// ---------------------------------------------------------------------------

constexpr int D_WIDE = 80;             // the second head dim the kernels take
constexpr int D1 = D_WIDE - D;         // 16 dims of the second slab
constexpr int ROW1_BYTES = D1 * 2;     // 32 bytes a token

// Byte offset of (row, 16-byte chunk 0/1) in a tile of 32-byte rows under
// the 32-byte swizzle: the chunk index XORed with bit 2 of the row (the
// tile 256-byte aligned).
__device__ __forceinline__ uint32_t sw32(int row, int chunk) {
  return (uint32_t)(row * ROW1_BYTES + ((chunk ^ ((row >> 2) & 1)) << 4));
}

// wgmma shared-memory descriptor, 32-byte swizzle (layout type 3).
__device__ __forceinline__ uint64_t sw32_desc(uint32_t saddr, uint32_t lbo,
                                              uint32_t sbo) {
  uint64_t d = (uint64_t)((saddr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)3 << 62;
  return d;
}

// K-major tile of 32-byte rows: one k-step of 16 dims is the whole row;
// 8-row groups 256 bytes apart.
__device__ __forceinline__ uint64_t kmajor32_desc(uint32_t saddr) {
  return sw32_desc(saddr, 16, 256);
}

// MN-major tile (V's dims 64-79: keys x 16 dims): 8-key groups 256 bytes
// apart; the N extent (16) is one atom.
__device__ __forceinline__ uint64_t mnmajor32_desc(uint32_t saddr) {
  return sw32_desc(saddr, 256, 256);
}

// D(64x16, f32) += A(64x16, bf16 registers) B(16x16), B MN-major in shared
// memory (imm-trans-b = 1).
__device__ __forceinline__ void wgmma_m64n16k16_rs(float* d, const uint32_t* a,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The k-step of the second slab: S += Q[:, 64:80] K[:, 64:80]^T.
template <int NSC>
__device__ __forceinline__ void issue_qk_slab1(float (&sc)[NSC],
                                               uint32_t q_tile1,
                                               uint32_t k_tile1) {
  wgmma_scores(sc, kmajor32_desc(q_tile1), kmajor32_desc(k_tile1), 1);
}

// O[:, 64:80] += P V[:, 64:80] for one tile: k-steps of 16 keys (512 bytes
// of the slab each).
template <int NPV>
__device__ __forceinline__ void issue_pv_slab1(float (&o1)[8],
                                               const uint32_t (&pa)[NPV][4],
                                               uint32_t v_tile1) {
#pragma unroll
  for (int kq = 0; kq < NPV; ++kq)
    wgmma_m64n16k16_rs(o1, pa[kq], mnmajor32_desc(v_tile1 + kq * 512));
}

__device__ __forceinline__ void rescale8(float (&o1)[8], const float (&a)[2]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    o1[4 * j] *= a[0];
    o1[4 * j + 1] *= a[0];
    o1[4 * j + 2] *= a[1];
    o1[4 * j + 3] *= a[1];
  }
}

// A 4-d map of one slab of a (B, H, S, hd) operand, hd 64 or 80, from its
// layout row (as `encode_bhsd`; the row's box is the first slab's, 64
// dims): slab 0 brings dims 0-63 under the 128-byte swizzle, slab 1 (hd 80
// only) dims 64-79 under the 32-byte swizzle.  The box is `rows` tokens.
inline bool encode_bhsd_slab(CUtensorMap* map, const void* ptr,
                             const long long* lay, int* pos, int rows,
                             int slab) {
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4];
  for (int i = 0; i < 4; ++i) {
    dims[i] = (cuuint64_t)lay[i];
    box[i] = (cuuint32_t)lay[7 + i];
  }
  for (int i = 0; i < 3; ++i) {
    strides[i] = (cuuint64_t)lay[4 + i];
    pos[i] = (int)lay[11 + i];
    if (pos[i] < 1 || pos[i] > 3) return false;
  }
  if ((dims[0] != D && dims[0] != D_WIDE) || box[0] != D ||
      box[pos[1]] != (cuuint32_t)rows || box[pos[0]] != 1 ||
      box[pos[2]] != 1)
    return false;
  if (slab == 0) return encode_bf16(map, ptr, 4, dims, strides, box);
  if (dims[0] != D_WIDE) return false;
  box[0] = D1;
  return encode_bf16(map, ptr, 4, dims, strides, box,
                     CU_TENSOR_MAP_SWIZZLE_32B);
}

// `load_bhsd` of the second slab (dims 64-79).
__device__ __forceinline__ void load_bhsd1(uint32_t dst,
                                           const CUtensorMap* map,
                                           uint32_t bar, const int* pos,
                                           int h, int row, int b) {
  tma_load_4d(dst, map, bar, D, coord(pos, 1, h, row, b),
              coord(pos, 2, h, row, b), coord(pos, 3, h, row, b));
}

}  // namespace sm90
