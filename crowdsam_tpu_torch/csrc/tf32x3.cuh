// The 3xTF32 tile product shared by the float32 arms of K5 and K6
// (`decode_tail_f32.cu`, `mask_head_f32.cu`) on Hopper's tensor cores
// (sm_90a), and the pieces around it: the stage ring, the bulk copies, the
// mbarriers and programmatic dependent launch.
//
// Arithmetic.  A float32 operand x is split into hi = rna_tf32(x) and lo =
// rna_tf32(x - hi) (`cvt.rna.tf32.f32`: the tensor core would truncate the
// 13 low bits of an unrounded value, and x - hi would then not be what it
// multiplies), and each product is lo.hi + hi.lo + hi.hi, the small terms
// first, summed in the float32 accumulators of wgmma.mma_async.m64nNk8
// .f32.tf32.tf32; lo.lo (2^-22 of the product) is dropped.  A stage of 32
// inputs is summed on its own, the four k-steps of lo.hi, then of hi.lo,
// then of hi.hi, and joins the product's sum by a float32 add (`product`).
// `models/tf32x3.mm` is this arithmetic in PyTorch.
//
// Operands.  A, the activations, stays float32 in shared memory (row-major,
// a row stride of 4 mod 32 floats, so that the 32 lanes of a fragment load
// fall on distinct banks) and is split a k-step at a time into register
// fragments (wgmma's A from registers): a 64 x 256 tile in hi + lo would
// take 128 KB of shared memory.  B, the weight, arrives split: the host
// splits each weight once (`models/tf32x3.pack`, cached) into stages of 128
// output rows x 32 inputs, the hi part then the lo part, each row 128 bytes
// under the 128-byte swizzle, one contiguous 32 KB block a stage.  So one
// bulk copy (`cp.async.bulk`, no tensor map) brings a stage into the
// layout that the wgmma descriptors read, and no thread of the kernel
// splits or rearranges a weight.  Splitting in the kernel instead would
// cost a producer warpgroup and its registers in every block, for a weight
// that is the same at every call of a frame's decode (16 calls).
//
// The ring.  A block is two consumer warpgroups and one producer warp
// (`THREADS`).  Lane 0 of the producer streams the stages of the block's
// products, in the order the consumers take them, into the ring's slots
// (three where shared memory allows: a stage's bulk copy from L2 takes
// about as long as two stages' products, so two slots leave the tensor
// cores waiting), each
// behind a "full" mbarrier (the bulk copy's bytes) and an "empty" one (one
// arrival from each of the 8 consumer warps once its products of the stage
// have retired).  Both sides count the stages they have put or taken, so
// the slot of stage n is n % slots and its parity (n / slots) & 1.  The two
// warpgroups split a stage's 128 output rows, 64 each (m64n64k8).
//
// Where this can go wrong, and what guards it:
//   1. The swizzle: the host's `pack` and the descriptors (start address /
//      16 in the low word, 1024-byte 8-row groups and layout type 1 in the
//      high word; a k-step of 8 inputs moves the start by 32 bytes): every
//      product of chip_smoke.py's error bound goes through it.
//   2. The order of the stream: the producer and the consumers run the same
//      program (the kernels' `Ctx`), so the order cannot drift; a wrong
//      count hangs, and a wait that never completes traps after ~2^34
//      cycles.
//   3. A slot refilled while read: a warp arrives on "empty" only after
//      wgmma.wait_group 0, so its products of the stage have retired.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace tf32x3 {

constexpr int CONSUMERS = 256;             // two warpgroups
constexpr int THREADS = CONSUMERS + 32;    // and the producer warp
constexpr int TR = 64;                     // rows of a tile (wgmma's M)
constexpr int SN = 128;                    // output rows of a stage
constexpr int SK = 32;                     // inputs of a stage
constexpr int PART_BYTES = SN * SK * 4;    // the hi or the lo part
constexpr int STAGE_BYTES = 2 * PART_BYTES;
constexpr int CBAR = 1;                    // the consumers' named barrier
constexpr int TURN0 = 2, TURN1 = 3;        // a warpgroup's turn to issue

// threadIdx.x, read where it is used: the compiler may neither keep it nor
// the indices derived from it in registers across a kernel's products
// (kept over K5's row phases' whole item loop, they pushed its 288-thread
// blocks past their 168 registers a thread).
__device__ __forceinline__ int tid() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  return t;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

// `bytes` (a multiple of 16) from global `src` to shared `dst`, counted on
// mbarrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// cp.async of 16 bytes, global -> shared.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// cp.async of 16 bytes, or 16 zero bytes where `keep` is false (src is
// not read then, but must be a valid address).
__device__ __forceinline__ void cp_async16_or_zero(void* dst, const void* src,
                                                   bool keep) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(keep ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// The consumers' barrier (the producer warp never joins it); their writes
// before it, shared and global, are visible to all of them after it (a
// barrier orders the memory accesses of the threads it joins, so no fence
// waits here for the threads' global stores to land).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(CBAR), "n"(CONSUMERS) : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(CONSUMERS) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(CONSUMERS) : "memory");
}

// Programmatic dependent launch: a kernel of a call reads what an earlier
// kernel wrote only after grid_wait(), which returns once the kernel before
// it on the stream has completed and its writes are visible.
__device__ __forceinline__ void grid_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void grid_launch_next() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
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

// wgmma descriptors as two words.  The low word: start address / 16, the
// leading byte offset 16 (unused by K-major swizzled layouts); a k-step of
// 8 inputs adds 2.  The high word, an immediate: 8-row groups 1024 bytes
// apart, layout type 1 (128-byte swizzle).
constexpr uint32_t SW128_HI = (1024 >> 4) | (1u << 30);

__device__ __forceinline__ uint32_t desc_lo(uint32_t saddr) {
  return ((saddr & 0x3FFFF) >> 4) | (1u << 16);
}

// D(64x64) (+)= A(64x8, registers) B(8x64), TF32; B's descriptor low word b.
__device__ __forceinline__ void mma_n64(float (&d)[32], const uint32_t (&a)[4],
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

// The stage ring: `slots` slots of STAGE_BYTES from `buf` (1024-byte
// aligned), their "full" mbarriers from `full` and "empty" ones from
// `empty` (8 bytes apart), and the stages this thread has put (the
// producer) or taken.
struct Ring {
  uint32_t buf, full, empty;
  uint32_t n, slots;
};

// Set up the ring's barriers (one thread, before the block's first
// __syncthreads).
__device__ __forceinline__ void ring_init(const Ring& r) {
  for (uint32_t i = 0; i < r.slots; ++i) {
    mbar_init(r.full + 8 * i, 1);
    mbar_init(r.empty + 8 * i, CONSUMERS / 32);
  }
}

// Producer: stage `src` (STAGE_BYTES, 16-byte aligned) into the next slot
// once every consumer warp has released the stage that held it before.
__device__ __forceinline__ void put(Ring& r, const void* src) {
  const uint32_t s = r.n % r.slots;
  if (r.n >= r.slots) mbar_wait(r.empty + 8 * s, ((r.n / r.slots) - 1) & 1);
  mbar_expect_tx(r.full + 8 * s, STAGE_BYTES);
  bulk_load(r.buf + s * STAGE_BYTES, src, STAGE_BYTES, r.full + 8 * s);
  ++r.n;
}

// Consumer: the next stage's address once it has arrived.
__device__ __forceinline__ uint32_t take(const Ring& r) {
  const uint32_t s = r.n % r.slots;
  mbar_wait(r.full + 8 * s, (r.n / r.slots) & 1);
  return r.buf + s * STAGE_BYTES;
}

// Consumer: the warp's products of the stage have retired.
__device__ __forceinline__ void release(Ring& r) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(r.empty + 8 * (r.n % r.slots));
  ++r.n;
}

// The A fragment of k-step `k0` (inputs k0..k0+7) of the warpgroup's 64 rows
// at `a` (row stride lda floats), split: rows 16 warp + lane / 4 (and + 8),
// inputs k0 + lane % 4 (and + 4), the m64nNk8 TF32 register layout.
__device__ __forceinline__ void a_frag(const float* a, int lda, int k0,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const float* p = a + (16 * w + (lane >> 2)) * lda + k0 + (lane & 3);
  split(p[0], hi[0], lo[0]);
  split(p[8 * lda], hi[1], lo[1]);
  split(p[4], hi[2], lo[2]);
  split(p[8 * lda + 4], hi[3], lo[3]);
}

// acc (+)= A W^T for the calling warpgroup's 64 rows and its 64 of a
// stage's 128 output rows (warpgroup `wg` takes rows 64 wg..64 wg + 63),
// over `nst` stages taken from the ring, KS k-steps of 8 inputs a stage (4;
// 2 for a 16-deep product whose stages are zero past input 16).  A: float32
// in shared memory from column 0 (stage s reads columns 32 s..), row stride
// lda.  With `zero` the accumulator starts from 0.  Both warpgroups call it
// with the same `nst`.
//
// Each stage is summed in a fresh accumulator (`part`) that then joins acc
// by a float32 add: the tensor core's own additions truncate, and over the
// 24 steps of a 256-deep product (three TF32 products of 8 inputs a stage
// step) their error came to 3-4x the plain float32 version's on the
// decode's outputs; summed a stage at a time, the truncated sums are 12
// steps long.  The two warpgroups issue a stage's products in turns (named
// barriers TURN0 / TURN1, warpgroup 0 first), so that one's products run
// while the other splits its next fragments and adds its part: issued at
// once, both wait for the tensor core together and leave it idle together.
template <int KS>
__device__ __forceinline__ void product(Ring& r, float (&acc)[32],
                                        const float* a, int lda, int nst,
                                        bool zero, int wg) {
  if (wg == 1) named_arrive(TURN0);
  for (int s = 0; s < nst; ++s) {
    uint32_t ah[KS][4], al[KS][4];
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) a_frag(a, lda, 32 * s + 8 * kk, ah[kk], al[kk]);
    const uint32_t hi = desc_lo(take(r) + 8192 * wg);
    const uint32_t lo = hi + (PART_BYTES >> 4);
    float part[32];
    named_sync(wg == 0 ? TURN0 : TURN1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) mma_n64(part, al[kk], hi + 2 * kk, kk > 0);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) mma_n64(part, ah[kk], lo + 2 * kk, 1);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) mma_n64(part, ah[kk], hi + 2 * kk, 1);
    wgmma_commit();
    if (wg == 0 || s + 1 < nst) named_arrive(wg == 0 ? TURN1 : TURN0);
    wgmma_wait0();
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      fence_reg(part[i]);
      acc[i] = (zero && s == 0) ? part[i] : acc[i] + part[i];
    }
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        fence_reg(ah[kk][i]);
        fence_reg(al[kk][i]);
      }
    release(r);
  }
}

// The accumulator element i of a m64nNk8 product: row 16 warp + lane / 4
// (+ 8 for i % 4 >= 2), column 8 (i / 4) + 2 (lane % 4) + i % 2.
__device__ __forceinline__ int acc_row(int i) {
  return 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2) +
         ((i & 2) ? 8 : 0);
}
__device__ __forceinline__ int acc_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

// The erf GELU as PyTorch computes it in float32: x/2 (1 + erf(x / sqrt 2)).
__device__ __forceinline__ float gelu_erf(float x) {
  return x * 0.5f * (1.f + erff(x * 0.70710678118654752f));
}

}  // namespace tf32x3
