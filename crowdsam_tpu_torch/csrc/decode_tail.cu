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
// Bound: tensor-core operations.  Per 32 prompts at M = 4096 about 54 GFLOP
// of bf16 products (keys1 @ wide2 and keys2 @ widef carry two thirds)
// against ~80 MB that must move (keys2 out, the shared inputs, the weights).
//
// Design.  The TPU kernel holds one prompt's whole (M, 256) image tensor in
// VMEM; a block here has 227 KB, so the rows are tiled and the work is
// split by what crosses rows.  One call launches ten kernels on the
// caller's stream: token stages (tok), row phases (row) and merges:
//
//   tok 0   block 1 self-attention, LN, q projection
//   row 0   partial token->image softmax over the shared k1/v1
//   merge   the row tiles' partials of that softmax
//   tok 1   out-projection, LN, MLP, LN; token keys and folded values of
//           update 1; block 2 self-attention, LN, q projection
//   row 1   keys1 = LN(keys0 + update 1), written; k2/v2 = keys1 @ wide2;
//           partial softmax of block 2
//   merge
//   tok 2   out-projection, LN, MLP, LN; token keys and folded values of
//           update 2; final q projection
//   row 2   keys1 read back, q2i = keys1 @ wide2[q], keys2 = LN(keys1 +
//           update 2), written; kf/vf = keys2 @ widef; partial softmax of
//           the final attention
//   merge
//   tok 3   out-projection, final LN
//
// Each kernel but the first is a programmatic dependent launch: it starts
// while the one before it drains, does what needs nothing of that kernel
// (weight prefetch, the call's inputs, row 2's q product), then waits
// (griddepcontrol.wait) for it.
//
// Token stages: the P prompts' T <= 8 tokens are rows p * 8 + t of one
// batch of P * 8 rows, cut into tiles of 64 rows (8 prompts).  A tile is a
// cluster of 8 blocks of two warpgroups; block j of the cluster owns head
// j.  Every dense layer is a wgmma product of the tile's 64 rows (A, in
// shared memory) against block j's slice of the weight's output columns
// (B, staged by cp.async in two 32 KB stages): 32 of 256, 16 of 128, 256
// of the MLP's 2048 (128 a warpgroup).  So each weight is read once per
// tile, not once per prompt.  A slice's results go to every block of the
// cluster through distributed shared memory (all-gather), and each block
// then holds the whole rows for the LayerNorms, which every block computes for
// itself (four threads a row).  The tokens' residual stream stays f32: the
// state lives in device memory in two buffers that alternate (a LayerNorm
// reads one, and block j writes its prompt's rows of the other), and only the
// operands of the products are rounded to bf16.  An out-projection's slice is
// written locally and then sent as 16-byte chunks (4-byte stores from the
// accumulators cost four times the remote transactions).  Self-attention
// head j needs only block j's own q/k/v columns; q and k are computed by
// the two warpgroups at once.  The MLP's second product is split over its
// 2048-deep K: block j multiplies its own 256 hidden columns, and block j
// then sums the 8 partials of its 32 output columns in rank order (a fixed
// order, no atomics).  The token keys of head j and the values of head j
// folded through the out-projection (m64n128k16, a warpgroup per half) are
// block j's as well.
//
// Row phases: a block of one warpgroup per (64-row tile, prompt), three
// blocks an SM (row phase 0: two prompts a block over one k/v tile).  A warp
// owns 16 rows and keeps them in registers from the residual through the
// LayerNorm as wgmma A fragments (the m64nNk16 register-A layout of a warp's
// 16 rows is the m16n8k16 one, and so is each 8-column piece of the
// accumulator).  The wide products keys1 @ wide2 and keys2 @ widef are
// wgmma.m64n128k16 with B in shared memory: weight chunks of 128 output
// columns x 64 inputs arrive by TMA (128-byte swizzle) in a ring of two
// stages, each behind its own mbarrier (three stages, or two blocks an SM
// without register spills, measured slower).  The PE-side terms added to q2i
// and k come into shared memory by cp.async during the product.  The image
// update of all heads: scores by one m64n8k16 per head against the token
// keys, the per-head softmax over the 4 lanes that hold a row, then P (64 x
// 64 (head, token)) times the folded values (64 x 256) as four m64n64k16
// products, and the LayerNorm from one pass of sums of x and x^2 taken on
// the f32 sum (the four products run twice: for the statistics, then for
// the output, instead of holding the f32 sum in registers).  The
// updated rows go to device memory through a swizzled staging tile, a warp
// per 512-byte row.  keys1 makes that round trip (64 MB each way at 32
// prompts) rather than being recomputed in row 2: measured, the recompute
// (keys0 and q1i loads, a second update 1) cost more.  The token->image
// partial softmax: scores per head by m64n8k16 against the query heads, tile
// max and sum across the warps, the exponentials rounded to bf16 and
// transposed into shared memory, and (P.V)^T = E^T V as two m64n64k16
// products (V through the transposed descriptor).
//
// Each token->image softmax spans all rows: a row block writes the max,
// the sum and the (64, 16) partial of P.V of its tile, and a merge kernel
// (a warp per prompt, head and token, the tiles in a fixed order and a
// fixed butterfly) combines them (no atomics: a run repeats bit for bit).
//
// Where this design can go wrong, and what it does about it:
//   1. Layouts: every wgmma operand in shared memory is K-major (or V's
//      MN-major) with 128-byte rows XOR-swizzled by (row % 8) in 16-byte
//      chunks, 1024-byte aligned atoms; `sw_off` writes that layout from
//      the threads and TMA writes it for the weight chunks.  A k-step of
//      16 moves the descriptor 32 bytes inside an atom.
//   2. Cluster traffic: a block writes into another's shared memory only
//      after a cluster barrier that the target passed once done with the
//      buffer; every buffer's remote writes and reads are listed at the
//      token stage.  Generic-proxy writes that a wgmma reads are fenced
//      (fence.proxy.async, scoped to the block's or the cluster's shared
//      memory) before the barrier.
//   3. Rings: the row phases' stage s of chunk c waits for parity (c / 2)
//      & 1; a stage is refilled only after every warp's wgmma that read it
//      has retired and the block has synchronised.  A wait that never
//      completes traps.
//   4. Overlapped launches: before its grid_wait() a kernel reads only
//      constants, the call's inputs and what kernels two or more before it
//      wrote, and it writes nothing; it lets the next kernel launch only
//      after its own wait.
//   5. Ragged edges: P * 8 rows need not fill the last tile; rows of
//      prompts >= P are zero and never stored, token rows >= T are zero in
//      the keys and folded values that the row phases read.
#include <cuda.h>
#include <cudaTypedefs.h>
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
constexpr int TM = 64;        // rows per tile, token and image side
constexpr int MLP = 2048;     // the MLP's hidden width
constexpr int PW = 20;        // floats per partial: max, sum, P.V, 2 pad
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
  const bf16* keys0;
  const bf16* q1i;
  const bf16* k1;
  const bf16* v1;
  const bf16* tokens;   // (P, T, C)
  bf16* keys1;          // (P, M, C) scratch: keys1, from row 1 to row 2
  bf16* keys2;          // (P, M, C)
  bf16* tok_out;        // (P, T, C)
  float* tok_state;     // (2, P, TP, C): the f32 token state, two buffers
  float* qh;            // (P, TP, CD)
  bf16* ktok[2];        // (P, TP, CD) token keys of update 1 / 2
  bf16* ut[2];          // (P, C, HT) folded token values, transposed
  float* part;          // (P, HT, NT, PW): a (prompt, head, token)'s tiles
                        // side by side
  float* att;           // (P, TP, CD) the merged token->image attention
  int P, T, M, NT;
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (r, k) in a tile of `rows` rows whose k axis runs
// along 128-byte rows: atoms of 64 k (rows x 128 bytes each, 1024-byte
// aligned), the 16-byte chunks of row r XORed by r % 8 (SWIZZLE_128B, the
// layout of the wgmma descriptors below and of TMA).
__device__ __forceinline__ uint32_t sw_off(int r, int k, int rows) {
  return (uint32_t)((k >> 6) * rows * 128 + r * 128 +
                    ((((k & 63) >> 3) ^ (r & 7)) << 4) + (k & 7) * 2);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Generic-proxy writes to this block's shared memory made visible to the
// async proxy (wgmma operands, TMA destinations).  Scoped to shared::cta:
// the unscoped fence also orders global memory, waits for the block's
// loads in flight, and cost 7% of the call.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The same for writes into other blocks' shared memory (distributed shared
// memory) that their wgmma reads after the next cluster barrier.
__device__ __forceinline__ void fence_async_cluster() {
  asm volatile("fence.proxy.async.shared::cluster;\n" ::: "memory");
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
// lost transfer), so that a fault ends the launch with an error.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > (1LL << 34)) __trap();
  }
}

// One TMA box of a 2-D map (64 inputs x 128 output rows of a weight) into
// shared memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
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

// K-major operand (rows of 64 k = 128 bytes): 8-row groups 1024 bytes
// apart; the leading offset is unused inside one swizzle atom.
__device__ __forceinline__ uint64_t kdesc(uint32_t saddr) {
  return sw128_desc(saddr, 16, 1024);
}

// MN-major operand (V: rows of 64 output columns, k along the rows): 8-row
// groups 1024 bytes apart; the N extent of one product is one atom.
__device__ __forceinline__ uint64_t mndesc(uint32_t saddr) {
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

// Pin registers across the asynchronous product: the compiler neither
// reads an accumulator before the wait nor reuses an A fragment's register
// while the product may still read it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&x)[N][4]) {
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(x[k][i])::"memory");
}

// ---- cluster: rank, distributed shared memory, barrier ----

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The shared::cluster address of local shared address `saddr` in block
// `rank` of the cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t saddr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(saddr), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster4(uint32_t addr, uint4 v) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n"
               ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// Programmatic dependent launch: the kernels of one call follow each other
// on the stream with the launch attribute that lets the next one start
// before this one ends.  A kernel reads what the kernel just before it
// wrote only after grid_wait(), and lets the next one launch only after
// its own grid_wait(): so before grid_wait() a kernel may read constants,
// the call's inputs, and what the kernels two or more before it wrote.
__device__ __forceinline__ void grid_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void grid_launch_next() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Every thread of every block of the cluster arrives and waits; writes
// before it (local, remote) are visible to all after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}
// D(64x16, f32) (+)= A(64x16) B(16x16), A K-major and B K-major in
// shared memory.
__device__ __forceinline__ void wgmma_ss_n16(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}"
      ", %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64x32, f32) (+)= A(64x16) B(16x32), A K-major and B K-major in
// shared memory.
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15}"
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64x128, f32) (+)= A(64x16) B(16x128), A K-major and B K-major in
// shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
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

// D(64x64, f32) (+)= A(64x16) B(16x64), A K-major and B MN-major in
// shared memory.
__device__ __forceinline__ void wgmma_ss_n64_tb(float* d, uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64x8, f32) (+)= A(64x16, bf16 registers) B(16x8), B K-major in
// shared memory.
__device__ __forceinline__ void wgmma_rs_n8(float* d, const uint32_t* a,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}"
      ", {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D(64x64, f32) (+)= A(64x16, bf16 registers) B(16x64), B K-major in
// shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D(64x128, f32) (+)= A(64x16, bf16 registers) B(16x128), B K-major in
// shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
      "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
// ===========================================================================
// token stages: a cluster of 8 blocks per tile of 64 token rows
// ===========================================================================

constexpr int CL = 8;                  // blocks a cluster: block j owns head j
constexpr int TOK_THREADS = 256;       // two warpgroups
constexpr int WG = 128;                // threads a warpgroup
constexpr int TILE = TM * C * 2;       // a [64][256] bf16 operand tile, 32 KB
constexpr int SLOT = 32768;            // one weight stage
constexpr int TSLOTS = 2;              // weight stages in flight
// Shared memory, in tiles from the 1024-byte aligned base.  PART (the
// MLP's f32 partial product, 64 KB) reuses X and G; QKV (self-attention
// q/k/v of the block's head, f32) and the staging of the folded values
// reuse HD.
constexpr int O_PE = 0, O_S = TILE, O_X = 2 * TILE, O_G = 3 * TILE,
              O_HD = 4 * TILE, O_RING = 5 * TILE, O_PART = O_X;
constexpr int QLD = HD2 + 1;           // QKV row stride (floats)
constexpr int TOK_SMEM = 5 * TILE + TSLOTS * SLOT + 1024;
static_assert(3 * TM * QLD * 4 <= TILE, "QKV fits HD");
static_assert(TM * C * 4 == 2 * TILE, "PART is X and G");

// A weight operand of one token product: `rows` output rows of `src` (row
// stride `ld`) by `atoms` x 64 inputs from `src` on, staged as atoms of
// [rows][64] in the swizzled layout.
struct WItem {
  const bf16* src;
  int rows, ld, atoms;
};

// The weight operands of token stage `stage` for block j, in the order its
// products consume them (rows == 0 past the end).
__device__ WItem tok_item(const Args& a, int stage, int i, int j) {
  auto slice = [&](int w, int rows, int ld, int atoms) {
    return WItem{wb(a, w) + (size_t)j * rows * ld, rows, ld, atoms};
  };
  const WItem none{nullptr, 0, 0, 0};
  if (stage == 0) {
    switch (i) {
      case 0: return slice(l0sa_q_w, HD2, C, 4);
      case 1: return slice(l0sa_k_w, HD2, C, 4);
      case 2: return slice(l0sa_v_w, HD2, C, 4);
      case 3: return slice(l0sa_o_w, HD2, C, 4);
      case 4: return slice(t2i1_q_w, HD, C, 4);
    }
    return none;
  }
  if (stage == 3) return i == 0 ? slice(fin_o_w, HD2, CD, 2) : none;
  const bool b1 = stage == 1;
  if (i == 0) return slice(b1 ? t2i1_o_w : t2i_o_w, HD2, CD, 2);
  if (i <= 4)     // MLP 1: the block's 256 hidden columns, one k-atom each
    return WItem{wb(a, b1 ? mlp1l0_w : mlp1_w) + (size_t)j * 256 * C +
                     (i - 1) * 64,
                 256, C, 1};
  if (i <= 8)     // MLP 2: all outputs over the block's 256 hidden inputs
    return WItem{wb(a, b1 ? mlp2l0_w : mlp2_w) + j * 256 + (i - 5) * 64, C,
                 MLP, 1};
  if (i == 9) return slice(b1 ? i2t1_k_w : i2t_k_w, HD, C, 4);
  if (i == 10) return slice(b1 ? i2t1_v_w : i2t_v_w, HD, C, 4);
  if (i == 11)    // out-projection: the k-atom that holds head j's 16 dims
    return WItem{wb(a, b1 ? i2t1_o_w : i2t_o_w) + (j >> 2) * 64, C, CD, 1};
  if (b1) {
    switch (i) {
      case 12: return slice(l1sa_q_w, HD2, C, 4);
      case 13: return slice(l1sa_k_w, HD2, C, 4);
      case 14: return slice(l1sa_v_w, HD2, C, 4);
      case 15: return slice(l1sa_o_w, HD2, C, 4);
      case 16: return slice(t2i_q_w, HD, C, 4);
    }
    return none;
  }
  return i == 12 ? slice(fin_q_w, HD, C, 4) : none;
}

// TSLOTS (two) stages of weights in flight through cp.async: item i lives
// in slot i % TSLOTS.  Each issue commits one group (empty past the end),
// so that the item in use is complete when at most the one group issued
// after it is pending.
struct Ring {
  uint32_t base;
  int issued, used;
};

__device__ void ring_issue(Ring& r, const Args& a, int stage, int j) {
  const WItem it = tok_item(a, stage, r.issued, j);
  const uint32_t dst = r.base + (r.issued % TSLOTS) * SLOT;
  const int per_row = it.atoms * 8;          // 16-byte chunks a row
  for (int e = threadIdx.x; e < it.rows * per_row; e += TOK_THREADS) {
    const int row = e / per_row, k = (e % per_row) * 8;
    cp_async16(dst + sw_off(row, k, it.rows),
               it.src + (size_t)row * it.ld + k);
  }
  cp_async_commit();
  ++r.issued;
}

// The slot of the next item, once its bytes have landed for every thread.
__device__ uint32_t ring_wait(Ring& r) {
  static_assert(TSLOTS == 2, "one later group at most");
  if (r.issued - r.used >= 2)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
  fence_async();
  __syncthreads();
  return r.base + (r.used % TSLOTS) * SLOT;
}

// After the product that read the slot retired in every warp: refill it.
__device__ void ring_release(Ring& r, const Args& a, int stage, int j) {
  __syncthreads();
  ++r.used;
  ring_issue(r, a, stage, j);
}

// acc (64 x N) (+)= A[:, 64 a0 ...] (the [64][256] tile at `a_tile`) times
// the staged weight (N rows, `atoms` k-atoms), on the tensor cores.
template <int N>
__device__ __forceinline__ void gemm_tok(float (&acc)[N / 2], uint32_t a_tile,
                                         int a0, uint32_t slot, int atoms,
                                         bool accumulate) {
  wgmma_fence();
  for (int at = 0; at < atoms; ++at) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = kdesc(a_tile + (a0 + at) * TM * 128 + kk * 32);
      const uint64_t db = kdesc(slot + at * N * 128 + kk * 32);
      const int sd = (accumulate || at > 0 || kk > 0) ? 1 : 0;
      if constexpr (N == 16) wgmma_ss_n16(acc, da, db, sd);
      if constexpr (N == 32) wgmma_ss_n32(acc, da, db, sd);
      if constexpr (N == 128) wgmma_ss_n128(acc, da, db, sd);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// Visit a wgmma accumulator of N columns: f(row, col, v0, v1) for the
// thread's pairs (row, col) and (row, col + 1), rows of the warpgroup's 64.
template <int N, typename F>
__device__ __forceinline__ void each_pair(const float (&acc)[N / 2], F f) {
  const int warp = (threadIdx.x % WG) >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16 + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
  for (int jj = 0; jj < N / 8; ++jj) {
    f(r0, jj * 8 + c0, acc[4 * jj], acc[4 * jj + 1]);
    f(r0 + 8, jj * 8 + c0, acc[4 * jj + 2], acc[4 * jj + 3]);
  }
}

struct TokCtx {
  unsigned char* sm;     // generic pointer to the aligned base
  uint32_t base;         // its shared address
  uint32_t rb[CL];       // the same base in each block of the cluster
  int j, tile, P, T;

  // Write 8 values (a 16-byte chunk; col a multiple of 8) at (row, col) of
  // the [64][256] tile at `off` in every block of the cluster.
  __device__ __forceinline__ void gather8(int off, int row, int col,
                                          uint4 v) const {
    const uint32_t o = off + sw_off(row, col, TM);
#pragma unroll
    for (int r = 0; r < CL; ++r) st_cluster4(rb[r] + o, v);
  }
  __device__ __forceinline__ bool valid(int row) const {
    return tile * 8 + (row >> 3) < P && (row & 7) < T;
  }
};

// The token residual stream, in f32: y = LN(x + res) * w + b over the 64
// rows of the tile, x the bf16 tile at `x` (a dense output) and res the f32
// token state in buffer `in_buf` of a.tok_state (-1: none); the sum, its
// statistics and y stay f32.  y becomes the state in buffer `out_buf` (-1:
// none; block j writes its prompt's 8 rows), rnd(y) the product operand
// at `dst` and, with `xpe` >= 0, rnd(y + pe) at `xpe`.  Four threads a row,
// 64 columns each (16-byte chunks 8 quarter ..).  A bf16 state would round
// the stream after every LayerNorm: two computations whose f32 sums differ
// in the last bits then part by a bf16 step now and then, and the chain of
// LayerNorms carries such steps to the output.
__device__ __forceinline__ void ln_state(const TokCtx& cx, const Args& a,
                                         int x, int in_buf, int out_buf,
                                         int dst, int xpe, const float* w,
                                         const float* b) {
  const int quarter = threadIdx.x & 3, row = threadIdx.x >> 2;
  const int p = cx.tile * 8 + (row >> 3);
  const bool live = p < cx.P;
  const size_t buf = (size_t)cx.P * TP * C;
  const size_t srow = ((size_t)p * TP + (row & 7)) * C;
  float y[64];
  float s4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c0 = (quarter * 8 + i) * 8;
    const uint4 xv =
        *reinterpret_cast<const uint4*>(cx.sm + x + sw_off(row, c0, TM));
    const uint32_t xs[4] = {xv.x, xv.y, xv.z, xv.w};
    float4 r0 = make_float4(0.f, 0.f, 0.f, 0.f), r1 = r0;
    if (in_buf >= 0 && live) {
      const float4* src = reinterpret_cast<const float4*>(
          a.tok_state + in_buf * buf + srow + c0);
      r0 = src[0];
      r1 = src[1];
    }
    const float rs[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 u = unpack_bf16(xs[q]);
      y[8 * i + 2 * q] = u.x + rs[2 * q];
      y[8 * i + 2 * q + 1] = u.y + rs[2 * q + 1];
      s4[q] += y[8 * i + 2 * q] + y[8 * i + 2 * q + 1];
    }
  }
  float sum = (s4[0] + s4[1]) + (s4[2] + s4[3]);
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  const float mean = sum * (1.f / C);
  float v4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i)
    v4[i & 3] += (y[i] - mean) * (y[i] - mean);
  float var = (v4[0] + v4[1]) + (v4[2] + v4[3]);
  var += __shfl_xor_sync(0xffffffffu, var, 1);
  var += __shfl_xor_sync(0xffffffffu, var, 2);
  const float rstd = rsqrtf(var * (1.f / C) + EPS);
  const bool store = out_buf >= 0 && live && (row >> 3) == cx.j;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c0 = (quarter * 8 + i) * 8;
    const uint32_t o = sw_off(row, c0, TM);
    const float4 w0 = *reinterpret_cast<const float4*>(w + c0);
    const float4 w1 = *reinterpret_cast<const float4*>(w + c0 + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(b + c0);
    const float4 b1 = *reinterpret_cast<const float4*>(b + c0 + 4);
    const float gw[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    const float gb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    float z[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      z[k] = (y[8 * i + k] - mean) * rstd * gw[k] + gb[k];
    *reinterpret_cast<uint4*>(cx.sm + dst + o) =
        make_uint4(pack_bf16(z[0], z[1]), pack_bf16(z[2], z[3]),
                   pack_bf16(z[4], z[5]), pack_bf16(z[6], z[7]));
    if (xpe >= 0) {
      const uint4 pv = *reinterpret_cast<const uint4*>(cx.sm + O_PE + o);
      const uint32_t ps[4] = {pv.x, pv.y, pv.z, pv.w};
      uint32_t out[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 e = unpack_bf16(ps[q]);
        out[q] = pack_bf16(z[2 * q] + e.x, z[2 * q + 1] + e.y);
      }
      *reinterpret_cast<uint4*>(cx.sm + xpe + o) =
          make_uint4(out[0], out[1], out[2], out[3]);
    }
    if (store) {
      float4* d4 =
          reinterpret_cast<float4*>(a.tok_state + out_buf * buf + srow + c0);
      d4[0] = make_float4(z[0], z[1], z[2], z[3]);
      d4[1] = make_float4(z[4], z[5], z[6], z[7]);
    }
  }
}

// Self-attention of head j over the T tokens of each of the tile's 8
// prompts, from q/k/v (f32, QKV); the result, rnd(softmax(q k^T * scale)
// v), goes to columns 32j.. of tile `dst` in every block.  Four threads a
// row: each takes the scores of 2 of the 8 tokens and 8 of the 32 dims.
__device__ __forceinline__ void self_attn_tile(const TokCtx& cx, int dst) {
  const float* q = reinterpret_cast<const float*>(cx.sm + O_HD);
  const float* k = q + TM * QLD;
  const float* v = k + TM * QLD;
  const int row = threadIdx.x >> 2, quarter = threadIdx.x & 3;
  const int r0 = row & ~7;           // the prompt's first token row
  const int lane0 = (threadIdx.x & 31) & ~3;
  float mine[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = quarter * 2 + i;
    float dot = 0.f;
#pragma unroll
    for (int d = 0; d < HD2; ++d)
      dot += q[row * QLD + d] * k[(r0 + t) * QLD + d];
    mine[i] = t < cx.T ? dot * SCALE2 : -INFINITY;
  }
  float s[TP];
#pragma unroll
  for (int t = 0; t < TP; ++t)
    s[t] = __shfl_sync(0xffffffffu, mine[t & 1], lane0 + (t >> 1));
  float mx = s[0];
#pragma unroll
  for (int t = 1; t < TP; ++t) mx = fmaxf(mx, s[t]);
  float l = 0.f;
#pragma unroll
  for (int t = 0; t < TP; ++t) {
    s[t] = t < cx.T ? __expf(s[t] - mx) : 0.f;
    l += s[t];
  }
  const float inv = 1.f / l;
  uint32_t out[4];
#pragma unroll
  for (int d = 0; d < 8; d += 2) {
    const int dd = quarter * 8 + d;
    float o0 = 0.f, o1 = 0.f;
#pragma unroll
    for (int t = 0; t < TP; ++t) {
      if (t < cx.T) {
        o0 += s[t] * v[(r0 + t) * QLD + dd];
        o1 += s[t] * v[(r0 + t) * QLD + dd + 1];
      }
    }
    out[d / 2] = pack_bf16(o0 * inv, o1 * inv);
  }
  cx.gather8(dst, row, cx.j * HD2 + quarter * 8,
             make_uint4(out[0], out[1], out[2], out[3]));
}

// The merged token->image attention of the tile's rows (`merge_stage`),
// rounded, into columns 0..127 of tile `dst`; rows of absent prompts 0.
__device__ __forceinline__ void load_att(const TokCtx& cx, const Args& a,
                                         int dst) {
  for (int e = threadIdx.x; e < TM * (CD / 8); e += TOK_THREADS) {
    const int row = e / (CD / 8), c = (e % (CD / 8)) * 8;
    const int p = cx.tile * 8 + (row >> 3);
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = 0.f;
    if (p < cx.P) {
      const float4* src = reinterpret_cast<const float4*>(
          a.att + ((size_t)p * TP + (row & 7)) * CD + c);
      const float4 x0 = src[0], x1 = src[1];
      v[0] = x0.x; v[1] = x0.y; v[2] = x0.z; v[3] = x0.w;
      v[4] = x1.x; v[5] = x1.y; v[6] = x1.z; v[7] = x1.w;
    }
    *reinterpret_cast<uint4*>(cx.sm + dst + sw_off(row, c, TM)) =
        make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                   pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  }
}

// One dense layer's slice of N columns with bias, rounded, from tile
// `a_tile` over `atoms` k-atoms: f(row, col, v0, v1) with col inside the
// slice.
template <int N, typename F>
__device__ __forceinline__ void dense_tok(const TokCtx& cx, Ring& rg,
                                          const Args& a, int stage,
                                          int a_tile, int atoms,
                                          const float* bias, F f) {
  const uint32_t slot = ring_wait(rg);
  const bool wg0 = threadIdx.x < WG;     // the product is warpgroup 0's
  float acc[N / 2];
  if (wg0) gemm_tok<N>(acc, cx.base + a_tile, 0, slot, atoms, false);
  ring_release(rg, a, stage, cx.j);
  if (!wg0) return;
  const float* b = bias + cx.j * N;
  each_pair<N>(acc, [&](int row, int col, float v0, float v1) {
    f(row, col, rnd(v0 + b[col]), rnd(v1 + b[col + 1]));
  });
}

// An out-projection's slice of block j (32 columns, from `atoms` k-atoms of
// tile `src`) into tile `dst` of every block: written here, then each
// 16-byte chunk sent to the other blocks (a thread a chunk: far fewer
// remote transactions than 4-byte stores from the accumulators).
__device__ __forceinline__ void out_proj(const TokCtx& cx, Ring& rg,
                                         const Args& a, int stage, int src,
                                         int atoms, const float* bias,
                                         int dst) {
  dense_tok<HD2>(cx, rg, a, stage, src, atoms, bias,
                 [&](int row, int col, float v0, float v1) {
                   *reinterpret_cast<uint32_t*>(
                       cx.sm + dst + sw_off(row, cx.j * HD2 + col, TM)) =
                       pack_bf16(v0, v1);
                 });
  __syncthreads();
  const int row = threadIdx.x >> 2, c = cx.j * HD2 + (threadIdx.x & 3) * 8;
  const uint32_t o = dst + sw_off(row, c, TM);
  const uint4 v = *reinterpret_cast<const uint4*>(cx.sm + o);
#pragma unroll
  for (int r = 0; r < CL; ++r)
    if (r != cx.j) st_cluster4(cx.rb[r] + o, v);
}

// q, k or v of head j (32 columns) into QKV matrix m, f32.
__device__ __forceinline__ void qkv_slice(const TokCtx& cx, Ring& rg,
                                          const Args& a, int stage, int src,
                                          int m, const float* bias) {
  float* dst = reinterpret_cast<float*>(cx.sm + O_HD) + m * TM * QLD;
  dense_tok<HD2>(cx, rg, a, stage, src, 4, bias,
                 [&](int row, int col, float v0, float v1) {
                   dst[row * QLD + col] = v0;
                   dst[row * QLD + col + 1] = v1;
                 });
}

// q and k of head j at once, from tile `src`: the next two weight stages
// are both in, warpgroup 0 takes q (QKV matrix 0) and warpgroup 1 k (1).
__device__ __forceinline__ void qk_slices(const TokCtx& cx, Ring& rg,
                                          const Args& a, int stage, int src,
                                          const float* qb, const float* kb) {
  cp_async_wait<0>();
  fence_async();
  __syncthreads();
  const int wg = threadIdx.x / WG;
  const uint32_t slot = rg.base + ((rg.used + wg) % TSLOTS) * SLOT;
  float acc[HD2 / 2];
  gemm_tok<HD2>(acc, cx.base + src, 0, slot, 4, false);
  __syncthreads();
  rg.used += 2;
  ring_issue(rg, a, stage, cx.j);
  ring_issue(rg, a, stage, cx.j);
  float* dst = reinterpret_cast<float*>(cx.sm + O_HD) + wg * TM * QLD;
  const float* b = (wg ? kb : qb) + cx.j * HD2;
  each_pair<HD2>(acc, [&](int row, int col, float v0, float v1) {
    dst[row * QLD + col] = rnd(v0 + b[col]);
    dst[row * QLD + col + 1] = rnd(v1 + b[col + 1]);
  });
}

// The next token->image query heads, head j: qh[p][t][16j + col] (f32; 0
// for tokens >= T).
__device__ __forceinline__ void q_heads(const TokCtx& cx, Ring& rg,
                                        const Args& a, int stage,
                                        const float* bias) {
  dense_tok<HD>(cx, rg, a, stage, O_X, 4, bias,
                [&](int row, int col, float v0, float v1) {
                  const int p = cx.tile * 8 + (row >> 3);
                  if (p >= cx.P) return;
                  const bool ok = (row & 7) < cx.T;
                  *reinterpret_cast<float2*>(
                      a.qh + ((size_t)p * TP + (row & 7)) * CD + cx.j * HD +
                      col) = make_float2(ok ? v0 : 0.f, ok ? v1 : 0.f);
                });
}

// The token state (the tile's S) of prompt j of the tile, f32.
// The whole token stage `STAGE` for one tile of 8 prompts (see the note at
// the top for what each stage computes).  Remote traffic, by buffer: X
// receives the merge (and in stage 0 the self-attention) before the first
// barriers; G the out-projection (and in stage 1 block 2's self-attention,
// after the MLP's barriers); HD the MLP's reduced output and in stage 1
// block 2's out-projection; PART (X and G) is read by the other blocks
// between the two barriers around the MLP reduction.
template <int STAGE>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(TOK_THREADS, 1)
    tok_stage(const Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  TokCtx cx;
  const uint32_t raw = smem_u32(smem_raw);
  cx.base = (raw + 1023u) & ~1023u;
  cx.sm = smem_raw + (cx.base - raw);
  cx.j = (int)cluster_rank();
  cx.tile = blockIdx.x / CL;
  cx.P = a.P;
  cx.T = a.T;
#pragma unroll
  for (int r = 0; r < CL; ++r) cx.rb[r] = map_rank(cx.base, r);
  const int tid = threadIdx.x, j = cx.j;

  Ring rg{cx.base + O_RING, 0, 0};
  for (int i = 0; i < TSLOTS; ++i) ring_issue(rg, a, STAGE, j);

  // The tokens (the query PE), exact in bf16.  The token state (f32)
  // stays in a.tok_state: each stage's first LayerNorm reads it there.
  if (STAGE < 3) {
    for (int e = tid; e < TM * (C / 8); e += TOK_THREADS) {
      const int row = e / (C / 8), c = (e % (C / 8)) * 8;
      const int p = cx.tile * 8 + (row >> 3), t = row & 7;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (p < a.P && t < a.T)
        v = *reinterpret_cast<const uint4*>(a.tokens +
                                            ((size_t)p * a.T + t) * C + c);
      *reinterpret_cast<uint4*>(cx.sm + O_PE + sw_off(row, c, TM)) = v;
    }
  }
  fence_async();
  grid_wait();           // the merged attention of the kernel before
  grid_launch_next();
  cluster_sync();        // every block has started: its memory is live

  if constexpr (STAGE == 0) {
    // block 1: self-attention on the tokens (no PE, no residual), LN, then
    // the query heads of the token->image attention.
    qk_slices(cx, rg, a, 0, O_PE, wf(a, l0sa_q_b), wf(a, l0sa_k_b));
    qkv_slice(cx, rg, a, 0, O_PE, 2, wf(a, l0sa_v_b));
    __syncthreads();
    self_attn_tile(cx, O_X);
    fence_async_cluster();
    cluster_sync();
    out_proj(cx, rg, a, 0, O_X, 4, wf(a, l0sa_o_b), O_G);
    cluster_sync();
    ln_state(cx, a, O_G, -1, 0, O_S, O_X, wf(a, n1l0_w), wf(a, n1l0_b));
    fence_async();
    __syncthreads();
    q_heads(cx, rg, a, 0, wf(a, t2i1_q_b));
  } else {
  const bool b1 = STAGE == 1;
  // token->image attention (merged by `merge_stage`), out-projection,
  // residual + LN.
  load_att(cx, a, O_X);
  fence_async();
  __syncthreads();
  const int o_b = STAGE == 1 ? t2i1_o_b : STAGE == 2 ? t2i_o_b : fin_o_b;
  out_proj(cx, rg, a, STAGE, O_X, 2, wf(a, o_b), O_G);
  cluster_sync();
  if constexpr (STAGE == 3) {
    ln_state(cx, a, O_G, 1, -1, O_S, -1, wf(a, nf_w), wf(a, nf_b));
    __syncthreads();
    const int p = cx.tile * 8 + j;
    if (p < a.P) {
      for (int e = tid; e < a.T * C; e += TOK_THREADS) {
        const int row = j * 8 + e / C, c = e % C;
        a.tok_out[(size_t)p * a.T * C + e] =
            *reinterpret_cast<const bf16*>(cx.sm + O_S + sw_off(row, c, TM));
      }
    }
    return;
  } else {
    // The state's buffers alternate: stage 0 leaves it in 0, stages 1
    // and 2 in 1 (a LayerNorm reads one and writes the other).
    ln_state(cx, a, O_G, b1 ? 0 : 1, b1 ? 1 : 0, O_S, -1,
             wf(a, b1 ? n2l0_w : n2_w), wf(a, b1 ? n2l0_b : n2_b));
    fence_async();
    __syncthreads();

    // MLP: hidden columns 256j.. (ReLU, rounded) stay in HD; the second
    // product over them is block j's partial of all 256 outputs (PART).
    // Warpgroup w takes the 128 columns w of each product (weight rows
    // 128 w.. of the staged operand).
    {
      const int wg = tid / WG;
      float acc[64];
      for (int at = 0; at < 4; ++at) {
        const uint32_t slot = ring_wait(rg);
        gemm_tok<128>(acc, cx.base + O_S, at, slot + wg * 128 * 128, 1,
                      at > 0);
        ring_release(rg, a, STAGE, j);
      }
      const float* b = wf(a, b1 ? mlp1l0_b : mlp1_b) + j * 256 + wg * 128;
      each_pair<128>(acc, [&](int row, int col, float v0, float v1) {
        *reinterpret_cast<uint32_t*>(cx.sm + O_HD +
                                     sw_off(row, wg * 128 + col, TM)) =
            pack_bf16(fmaxf(v0 + b[col], 0.f), fmaxf(v1 + b[col + 1], 0.f));
      });
      fence_async();
      __syncthreads();
      for (int at = 0; at < 4; ++at) {
        const uint32_t slot = ring_wait(rg);
        gemm_tok<128>(acc, cx.base + O_HD, at, slot + wg * 128 * 128, 1,
                      at > 0);
        ring_release(rg, a, STAGE, j);
      }
      float* part = reinterpret_cast<float*>(cx.sm + O_PART) + wg * 128;
      each_pair<128>(acc, [&](int row, int col, float v0, float v1) {
        *reinterpret_cast<float2*>(part + row * C + col) = make_float2(v0, v1);
      });
    }
    cluster_sync();
    {
      // Block j sums the 8 partials of its 32 output columns, rank by rank.
      const int row = tid >> 2, c0 = j * HD2 + (tid & 3) * 8;
      float4 v[CL][2];            // every partial in flight at once
#pragma unroll
      for (int r = 0; r < CL; ++r)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          v[r][q] = ld_cluster4(cx.rb[r] + O_PART + (row * C + c0) * 4 +
                                q * 16);
      float s[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i] = 0.f;
#pragma unroll
      for (int r = 0; r < CL; ++r) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          s[4 * q] += v[r][q].x;
          s[4 * q + 1] += v[r][q].y;
          s[4 * q + 2] += v[r][q].z;
          s[4 * q + 3] += v[r][q].w;
        }
      }
      const float* b = wf(a, b1 ? mlp2l0_b : mlp2_b);
      uint32_t out[4];
#pragma unroll
      for (int i = 0; i < 8; i += 2)
        out[i / 2] = pack_bf16(s[i] + b[c0 + i], s[i + 1] + b[c0 + i + 1]);
      cx.gather8(O_HD, row, c0, make_uint4(out[0], out[1], out[2], out[3]));
    }
    cluster_sync();
    ln_state(cx, a, O_HD, b1 ? 1 : 0, b1 ? 0 : 1, O_S, O_X,
             wf(a, b1 ? n3l0_w : n3_w), wf(a, b1 ? n3l0_b : n3_b));
    fence_async();
    __syncthreads();

    // The image->token update's token side, head j: keys from tokens + PE
    // (0 for tokens >= T), values folded through the out-projection:
    // ut[p][c][8j + t] = rnd(sum_d v[t][16j + d] Wo[c][16j + d]).
    bf16* ktok = a.ktok[STAGE - 1];
    dense_tok<HD>(cx, rg, a, STAGE, O_X, 4, wf(a, b1 ? i2t1_k_b : i2t_k_b),
                  [&](int row, int col, float v0, float v1) {
                    const int p = cx.tile * 8 + (row >> 3);
                    if (p >= a.P) return;
                    const bool ok = (row & 7) < a.T;
                    *reinterpret_cast<uint32_t*>(
                        ktok + ((size_t)p * TP + (row & 7)) * CD + j * HD +
                        col) = ok ? pack_bf16(v0, v1) : 0u;
                  });
    {
      // Head j's values (0 for absent rows) as the A fragment of one k-step
      // of 16: rows g and g + 8 of the warp, dims 2 t4 and 2 t4 + 8.  Both
      // warpgroups compute them; warpgroup w then folds them through output
      // columns 128 w.. of the out-projection.
      const int wg = tid / WG;
      float vacc[8];
      uint32_t slot = ring_wait(rg);
      gemm_tok<HD>(vacc, cx.base + O_S, 0, slot, 4, false);
      ring_release(rg, a, STAGE, j);
      const float* vb = wf(a, b1 ? i2t1_v_b : i2t_v_b) + j * HD;
      const int r0 = ((tid % WG) >> 5) * 16 + ((tid & 31) >> 2);
      const int c0 = 2 * (tid & 3);
      const bool ok0 = cx.valid(r0), ok1 = cx.valid(r0 + 8);
      uint32_t va[4];
      va[0] = ok0 ? pack_bf16(vacc[0] + vb[c0], vacc[1] + vb[c0 + 1]) : 0u;
      va[1] = ok1 ? pack_bf16(vacc[2] + vb[c0], vacc[3] + vb[c0 + 1]) : 0u;
      va[2] = ok0 ? pack_bf16(vacc[4] + vb[c0 + 8], vacc[5] + vb[c0 + 9]) : 0u;
      va[3] = ok1 ? pack_bf16(vacc[6] + vb[c0 + 8], vacc[7] + vb[c0 + 9]) : 0u;
      slot = ring_wait(rg);
      float acc[64];
      wgmma_fence();
      wgmma_rs_n128(acc, va, kdesc(slot + wg * 128 * 128 + (j & 3) * 32), 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      ring_release(rg, a, STAGE, j);
      bf16* st = reinterpret_cast<bf16*>(cx.sm + O_HD);   // [8][C][TP]
      each_pair<128>(acc, [&](int row, int col, float v0, float v1) {
        const int pl = row >> 3, t = row & 7, c = wg * 128 + col;
        st[(pl * C + c) * TP + t] = __float2bfloat16(v0);
        st[(pl * C + c + 1) * TP + t] = __float2bfloat16(v1);
      });
      __syncthreads();
      bf16* ut = a.ut[STAGE - 1];
      for (int e = tid; e < 8 * C; e += TOK_THREADS) {
        const int p = cx.tile * 8 + e / C, c = e % C;
        if (p < a.P)
          *reinterpret_cast<uint4*>(ut + ((size_t)p * C + c) * HT + j * TP) =
              *reinterpret_cast<const uint4*>(st + (size_t)e * TP);
      }
      __syncthreads();
    }

    if constexpr (STAGE == 1) {
      // block 2: self-attention on tokens + PE, residual + LN.
      qk_slices(cx, rg, a, 1, O_X, wf(a, l1sa_q_b), wf(a, l1sa_k_b));
      qkv_slice(cx, rg, a, 1, O_S, 2, wf(a, l1sa_v_b));
      __syncthreads();
      self_attn_tile(cx, O_G);
      fence_async_cluster();
      cluster_sync();
      out_proj(cx, rg, a, 1, O_G, 4, wf(a, l1sa_o_b), O_HD);
      cluster_sync();
      ln_state(cx, a, O_HD, 0, 1, O_S, O_X, wf(a, n1l1_w), wf(a, n1l1_b));
      fence_async();
      __syncthreads();
    }
    q_heads(cx, rg, a, STAGE, wf(a, b1 ? t2i_q_b : fin_q_b));
  }
  }
}


// ===========================================================================
// merge of the row tiles' partial softmaxes: a warp per (prompt, head, token)
// ===========================================================================

constexpr int MERGE_THREADS = 256;

// att[p][t][16h + d] = sum_n w_n acc_n / sum_n w_n l_n, w_n = exp(m_n -
// max) over the NT row tiles (0 for tokens >= T).  Lane i takes tiles i,
// i + 32, ... in order with a running max; the lanes then combine by a
// butterfly whose two sides add the same two terms, so that every lane
// ends with the same sum and a run repeats bit for bit.
__global__ void __launch_bounds__(MERGE_THREADS) merge_stage(const Args a) {
  const int w = blockIdx.x * (MERGE_THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  grid_wait();           // the row phase's partials
  grid_launch_next();
  if (w >= a.P * HT) return;
  const int p = w / HT, ht = w % HT, h = ht / TP, t = ht % TP;
  float4* out = reinterpret_cast<float4*>(
      a.att + ((size_t)p * TP + t) * CD + h * HD);
  if (t >= a.T) {
    if (lane < HD / 4) out[lane] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const float4* pr = reinterpret_cast<const float4*>(
      a.part + (size_t)w * a.NT * PW);
  float mx = -INFINITY, l = 0.f, acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  for (int n = lane; n < a.NT; n += 32) {
    float4 e[PW / 4];
#pragma unroll
    for (int i = 0; i < PW / 4; ++i) e[i] = pr[n * (PW / 4) + i];
    const float mn = fmaxf(mx, e[0].x);
    const float f = __expf(mx - mn), wt = __expf(e[0].x - mn);
    mx = mn;
    l = l * f + wt * e[0].y;
    const float pv[HD] = {e[0].z, e[0].w, e[1].x, e[1].y, e[1].z, e[1].w,
                          e[2].x, e[2].y, e[2].z, e[2].w, e[3].x, e[3].y,
                          e[3].z, e[3].w, e[4].x, e[4].y};
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] = acc[d] * f + wt * pv[d];
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, mx, off);
    const float mn = fmaxf(mx, mo);
    const float fs = mx == -INFINITY ? 0.f : __expf(mx - mn);
    const float fo = mo == -INFINITY ? 0.f : __expf(mo - mn);
    l = l * fs + __shfl_xor_sync(0xffffffffu, l, off) * fo;
#pragma unroll
    for (int d = 0; d < HD; ++d)
      acc[d] = acc[d] * fs + __shfl_xor_sync(0xffffffffu, acc[d], off) * fo;
    mx = mn;
  }
  if (lane == 0) {
    const float inv = 1.f / l;
#pragma unroll
    for (int q = 0; q < HD / 4; ++q)
      out[q] = make_float4(acc[4 * q] * inv, acc[4 * q + 1] * inv,
                           acc[4 * q + 2] * inv, acc[4 * q + 3] * inv);
  }
}

// ===========================================================================
// row phases: one warpgroup per (row tile, prompt), three blocks an SM
// ===========================================================================

constexpr int ROW_THREADS = 128;
constexpr int ROW0_PROMPTS = 2;        // prompts a block of row phase 0
constexpr int NSLOT = 2;               // weight chunks in flight
constexpr int WROWS = 128;             // weight rows (output columns) a chunk
constexpr int CHUNK = WROWS * 64 * 2;  // x 64 inputs, 16 KB
// Shared memory from the 1024-byte aligned base.  After the last chunk the
// ring holds E^T; after the last update UT holds the v tile and the query
// heads.
constexpr int R_RING = 0;
constexpr int R_UT = NSLOT * CHUNK;          // folded values [256][64]
constexpr int R_V = R_UT;                    // v tile [64][128], MN-major
constexpr int R_QH = R_UT + 16384;           // query heads [64 (h,t)][128]
constexpr int R_ET = R_RING;                 // exponentials^T [64 (h,t)][64]
constexpr int R_KT = R_UT + 32768;           // token keys [8][128]
constexpr int R_PST = R_KT + 2048;           // 3 x 256 f32 parameters
constexpr int R_RED = R_PST + 3 * C * 4;     // per-warp maxes and sums
constexpr int R_BAR = R_RED + 2 * 4 * HT * 4;
constexpr int ROW_SMEM = R_BAR + 8 * NSLOT + 1024;

// The per-head scores of the warpgroup's 64 rows against 8 tokens: one
// m64n8k16 per head, A = the rows' 16 dims of head h (registers), B = the
// tokens' 16 dims of head h: rows 8 b_row(h).. of the K-major tile at `kt`
// ([rows][128], two atoms of `rows` x 64).
__device__ __forceinline__ void head_scores(float (&sc)[H][4],
                                            uint32_t (&qa)[H][4],
                                            uint32_t kt, int rows,
                                            bool diag) {
#pragma unroll
  for (int h = 0; h < H; ++h) sc[h][0] = sc[h][1] = sc[h][2] = sc[h][3] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int h = 0; h < H; ++h)
    wgmma_rs_n8(sc[h], qa[h],
                kdesc(kt + (h >> 2) * rows * 128 + (diag ? h * 1024 : 0) +
                      (h & 3) * 32),
                0);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < H; ++h) fence_regs(sc[h]);
  fence_regs(qa);
}

// x <- rnd(LN(x + rnd(P U) + ob) * lnw + lnb) on the warpgroup's 64
// rows held as A fragments: P = per-head softmax of the scores over the T
// tokens, U^T staged at `ut` ([256 c][64 (h,t)], K-major).
__device__ __forceinline__ void image_update(uint32_t (&xa)[C / 16][4],
                                             float (&sc)[H][4], uint32_t ut,
                                             const float* ob, const float* lnw,
                                             const float* lnb, int T, int t4) {
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

  // The LayerNorm's input, x + rnd(P U) + ob, stays f32: rounding it to
  // bf16 first would turn a one-ulp difference of P U's sum order into
  // several ulps of the normalized output.  It is formed twice, P U in
  // quarters of 64 columns (K = 64 (head, token) pairs) each time, for the
  // statistics and then for the output, rather than held in registers; the
  // products are the same instructions on the same operands, so both
  // passes see the same sums.  The statistics are one pass of sums of x and
  // x^2 (the inputs are O(1), so E[x^2] - mean^2 loses nothing at f32 that
  // the bf16 output would keep); y = (x rstd - mean rstd) w + b.
  float s0 = 0.f, s1 = 0.f, q0 = 0.f, q1 = 0.f;
  float r0 = 0.f, r1 = 0.f, c0 = 0.f, c1 = 0.f;
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int qd = 0; qd < 4; ++qd) {
      float acc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HT / 16; ++kk)
        wgmma_rs_n64(acc, pa[kk], kdesc(ut + qd * 64 * 128 + kk * 32),
                     kk > 0 ? 1 : 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int nt = qd * 8 + j;
        const float2 o =
            *reinterpret_cast<const float2*>(ob + nt * 8 + 2 * t4);
        const int kx = nt >> 1, ix = (nt & 1) * 2;
        const float2 x0 = unpack_bf16(xa[kx][ix]);
        const float2 x1 = unpack_bf16(xa[kx][ix + 1]);
        // rnd(delta), a pair at a time
        const float2 d0 = unpack_bf16(pack_bf16(acc[4 * j], acc[4 * j + 1]));
        const float2 d1 =
            unpack_bf16(pack_bf16(acc[4 * j + 2], acc[4 * j + 3]));
        const float v00 = x0.x + d0.x + o.x, v01 = x0.y + d0.y + o.y;
        const float v10 = x1.x + d1.x + o.x, v11 = x1.y + d1.y + o.y;
        if (pass == 0) {
          s0 += v00 + v01;
          s1 += v10 + v11;
          q0 = fmaf(v00, v00, fmaf(v01, v01, q0));
          q1 = fmaf(v10, v10, fmaf(v11, v11, q1));
        } else {
          const int col = nt * 8 + 2 * t4;
          const float2 w = *reinterpret_cast<const float2*>(lnw + col);
          const float2 b = *reinterpret_cast<const float2*>(lnb + col);
          xa[kx][ix] = pack_bf16(fmaf(fmaf(v00, r0, c0), w.x, b.x),
                                 fmaf(fmaf(v01, r0, c0), w.y, b.y));
          xa[kx][ix + 1] = pack_bf16(fmaf(fmaf(v10, r1, c1), w.x, b.x),
                                     fmaf(fmaf(v11, r1, c1), w.y, b.y));
        }
      }
    }
    if (pass == 0) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        q0 += __shfl_xor_sync(0xffffffffu, q0, off);
        q1 += __shfl_xor_sync(0xffffffffu, q1, off);
      }
      const float mean0 = s0 * (1.f / C), mean1 = s1 * (1.f / C);
      r0 = rsqrtf(fmaxf(q0 * (1.f / C) - mean0 * mean0, 0.f) + EPS);
      r1 = rsqrtf(fmaxf(q1 * (1.f / C) - mean1 * mean1, 0.f) + EPS);
      c0 = -mean0 * r0;
      c1 = -mean1 * r1;
    }
  }
}

// The row phases' weight ring: chunk c (128 weight rows x 64 inputs) in
// stage c % NSLOT behind mbarrier c % NSLOT.
struct RowRing {
  uint32_t ring, bar;
  int used, n;
};

// acc (64 x 128) = x (A fragments, K = 256) @ the next four chunks^T (the
// four k-atoms of 128 weight rows).  Each stage is refilled with chunk c +
// NSLOT once every warp's product that read it has retired.
template <typename Issue>
__device__ __forceinline__ void gemm_rows(float (&acc)[64],
                                          uint32_t (&xa)[C / 16][4],
                                          RowRing& rr, Issue issue) {
#pragma unroll
  for (int at = 0; at < 4; ++at) {
    const int c = rr.used, s = c % NSLOT;
    mbar_wait(rr.bar + 8 * s, (c / NSLOT) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n128(acc, xa[at * 4 + kk],
                    kdesc(rr.ring + s * CHUNK + kk * 32),
                    (at > 0 || kk > 0) ? 1 : 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(xa);
    __syncthreads();
    if (threadIdx.x == 0 && c + NSLOT < rr.n) issue(c + NSLOT);
    ++rr.used;
  }
}

// The tile's 64 rows of a (M, 128) PE-side term into the swizzled [64][128]
// tile at `dst` (cp.async, one group).
__device__ __forceinline__ void stage_pe(uint32_t dst, const bf16* src) {
  for (int e = threadIdx.x; e < TM * (CD / 8); e += ROW_THREADS) {
    const int r = e / (CD / 8), c = (e % (CD / 8)) * 8;
    cp_async16(dst + sw_off(r, c, TM), src + (size_t)r * CD + c);
  }
  cp_async_commit();
}

// (rows g, g + 8 of the warp) x (this thread's 32 columns of 128): the
// PE-side terms from a staged tile, bf16 pairs, as the accumulator holds
// them.
__device__ __forceinline__ void load_pe(uint32_t (&pe)[32],
                                        const unsigned char* tile, int lr0,
                                        int lr1, int t4) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = j * 8 + 2 * t4;
    pe[2 * j] =
        *reinterpret_cast<const uint32_t*>(tile + sw_off(lr0, col, TM));
    pe[2 * j + 1] =
        *reinterpret_cast<const uint32_t*>(tile + sw_off(lr1, col, TM));
  }
}

// A fragments per head (16 dims) from a 128-column accumulator plus the
// PE-side terms, rounded: head h is column tiles 2h and 2h + 1.
__device__ __forceinline__ void heads_from_acc(uint32_t (&qa)[H][4],
                                               const float (&acc)[64],
                                               const uint32_t (&pe)[32]) {
#pragma unroll
  for (int h = 0; h < H; ++h) {
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      const int j = 2 * h + o;
      const float2 e0 = unpack_bf16(pe[2 * j]);
      const float2 e1 = unpack_bf16(pe[2 * j + 1]);
      qa[h][2 * o] = pack_bf16(acc[4 * j] + e0.x, acc[4 * j + 1] + e0.y);
      qa[h][2 * o + 1] =
          pack_bf16(acc[4 * j + 2] + e1.x, acc[4 * j + 3] + e1.y);
    }
  }
}

// part rows (h, t) of product `a` (heads 4a..4a+3): the warp's rows 16w + g
// (head 2w) and 16w + g + 8 (head 2w + 1), token g, 16 dims a head.
__device__ __forceinline__ void store_pv(const float (&o)[32], float* part,
                                         size_t ld, int warp, int g, int t4,
                                         int T) {
  if (g >= T) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int h = 2 * warp + hh;
    float* pr = part + (h * TP + g) * ld + 2;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      if ((jj >> 1) != (h & 3)) continue;
      const int dd = (jj & 1) * 8 + 2 * t4;
      pr[dd] = o[4 * jj + 2 * hh];
      pr[dd + 1] = o[4 * jj + 2 * hh + 1];
    }
  }
}

// The warpgroup's 64 rows (A fragments) to rows of 256 at dst (device
// memory), through the 32 KB at `stage` (swizzled like an operand tile so
// that neither side meets bank conflicts): a warp stores whole 512-byte
// rows, 16 bytes a lane.  Synchronises the block before and after.
__device__ __forceinline__ void store_rows(const uint32_t (&xa)[C / 16][4],
                                           unsigned char* stage, bf16* dst,
                                           int lr0, int lr1, int t4) {
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk) {
    const int col = kk * 16 + 2 * t4;
    *reinterpret_cast<uint32_t*>(stage + sw_off(lr0, col, TM)) = xa[kk][0];
    *reinterpret_cast<uint32_t*>(stage + sw_off(lr1, col, TM)) = xa[kk][1];
    *reinterpret_cast<uint32_t*>(stage + sw_off(lr0, col + 8, TM)) = xa[kk][2];
    *reinterpret_cast<uint32_t*>(stage + sw_off(lr1, col + 8, TM)) = xa[kk][3];
  }
  __syncthreads();
#pragma unroll 4
  for (int e = threadIdx.x; e < TM * (C / 8); e += ROW_THREADS) {
    const int r = e / (C / 8), c = (e % (C / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + (size_t)r * C + c) =
        *reinterpret_cast<const uint4*>(stage + sw_off(r, c, TM));
  }
  __syncthreads();
}

// STAGE 0: partial softmax over the shared k1/v1.  STAGE 1: keys1, k2/v2,
// partial softmax of block 2.  STAGE 2: keys1, q2i, keys2 (written), kf/vf,
// partial softmax of the final attention.  tm_a / tm_b: TMA maps of wide2
// and widef (box 64 inputs x 128 rows).
template <int STAGE>
__global__ void __launch_bounds__(ROW_THREADS, 3)
    row_phase(const __grid_constant__ CUtensorMap tm_a,
              const __grid_constant__ CUtensorMap tm_b, const Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  float* redm = reinterpret_cast<float*>(sm + R_RED);
  float* redl = redm + 4 * HT;

  const int tile = blockIdx.x, p = blockIdx.y;
  const int m0 = tile * TM, T = a.T;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int lr0 = warp * 16 + g, lr1 = lr0 + 8;   // block-local rows
  const size_t r0 = (size_t)m0 + lr0, r1 = r0 + 8;

  constexpr int NCH = STAGE == 1 ? 8 : STAGE == 2 ? 12 : 0;
  RowRing rr{base + R_RING, base + R_BAR, 0, NCH};
  // Chunk c of this phase: (STAGE 2) wide2's q rows, then the k and the v
  // rows of wide2 (STAGE 1) or widef (STAGE 2), each as four k-atoms.
  auto issue = [&](int c) {
    const int s = c % NSLOT;
    const bool q = STAGE == 2 && c < 4;
    const CUtensorMap* map = (STAGE == 1 || q) ? &tm_a : &tm_b;
    const int kv = STAGE == 2 ? c - 4 : c;          // 0..3 k, 4..7 v
    const int row0 = q ? 2 * CD : (kv < 4 ? 0 : CD);
    mbar_expect_tx(rr.bar + 8 * s, CHUNK);
    tma_load_2d(rr.ring + s * CHUNK, map, rr.bar + 8 * s, (c & 3) * 64,
                row0);
  };
  if constexpr (NCH > 0) {
    if (tid == 0) {
      for (int s = 0; s < NSLOT; ++s) mbar_init(rr.bar + 8 * s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      fence_async();
    }
    __syncthreads();
    if (tid == 0)
      for (int c = 0; c < NSLOT; ++c) issue(c);
  }

  // The query heads, bf16, head h's 16 dims in rows 8h..8h+7 of QH.
  auto load_qh = [&](int q) {
    const int h = tid >> 4, t = (tid >> 1) & 7, d0 = (tid & 1) * 8;
    const float4* src = reinterpret_cast<const float4*>(
        a.qh + ((size_t)q * TP + t) * CD + h * HD + d0);
    const float4 x0 = src[0], x1 = src[1];
    *reinterpret_cast<uint4*>(sm + R_QH +
                              sw_off(h * TP + t, h * HD + d0, TM)) =
        make_uint4(pack_bf16(x0.x, x0.y), pack_bf16(x0.z, x0.w),
                   pack_bf16(x1.x, x1.y), pack_bf16(x1.z, x1.w));
  };

  uint32_t kf[H][4];      // the tile's k as A fragments, per head
  auto t2i_partial = [&](int q) {
    // Partial token->image softmax of this tile, all heads: scores per head
    // against the query heads; the tile's max and sum per (head, token)
    // through the warps' partials; the exponentials, rounded to bf16, into
    // E^T (shared memory), then (P.V)^T = E^T V.
    float sc[H][4];
    head_scores(sc, kf, base + R_QH, TM, true);
  #pragma unroll
    for (int h = 0; h < H; ++h) {
  #pragma unroll
      for (int i = 0; i < 4; ++i) sc[h][i] *= SCALE;
      float mx0 = fmaxf(sc[h][0], sc[h][2]), mx1 = fmaxf(sc[h][1], sc[h][3]);
  #pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      if (g == 0) {
        redm[warp * HT + h * TP + 2 * t4] = mx0;
        redm[warp * HT + h * TP + 2 * t4 + 1] = mx1;
      }
    }
    __syncthreads();
    bf16* et = reinterpret_cast<bf16*>(sm + R_ET);
  #pragma unroll
    for (int h = 0; h < H; ++h) {
      const int c0 = h * TP + 2 * t4;
      float mx0 = redm[c0], mx1 = redm[c0 + 1];
  #pragma unroll
      for (int w = 1; w < 4; ++w) {
        mx0 = fmaxf(mx0, redm[w * HT + c0]);
        mx1 = fmaxf(mx1, redm[w * HT + c0 + 1]);
      }
      const bf16 e00 = __float2bfloat16(__expf(sc[h][0] - mx0));
      const bf16 e01 = __float2bfloat16(__expf(sc[h][1] - mx1));
      const bf16 e10 = __float2bfloat16(__expf(sc[h][2] - mx0));
      const bf16 e11 = __float2bfloat16(__expf(sc[h][3] - mx1));
      et[sw_off(c0, lr0, TM) / 2] = e00;
      et[sw_off(c0 + 1, lr0, TM) / 2] = e01;
      et[sw_off(c0, lr1, TM) / 2] = e10;
      et[sw_off(c0 + 1, lr1, TM) / 2] = e11;
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
    fence_async();
    __syncthreads();
    // (h, t)'s partial of this tile: part + (h TP + t) * ld.
    const size_t ld = (size_t)a.NT * PW;
    float* part = a.part + ((size_t)q * HT * a.NT + tile) * PW;
    if (tid < HT && (tid % TP) < T) {
      float mx = redm[tid], l = redl[tid];
  #pragma unroll
      for (int w = 1; w < 4; ++w) {
        mx = fmaxf(mx, redm[w * HT + tid]);
        l += redl[w * HT + tid];
      }
      part[tid * ld] = mx;
      part[tid * ld + 1] = l;
    }
    // (P.V)^T: rows (h, t), K = the tile's 64 rows, N = the 64 dims of heads
    // 0-3 (o0) and 4-7 (o1); a warp keeps the block of its own two heads.
    float o0[32], o1[32];
    wgmma_fence();
  #pragma unroll
    for (int kq = 0; kq < TM / 16; ++kq)
      wgmma_ss_n64_tb(o0, kdesc(base + R_ET + kq * 32),
                      mndesc(base + R_V + kq * 2048), kq > 0 ? 1 : 0);
  #pragma unroll
    for (int kq = 0; kq < TM / 16; ++kq)
      wgmma_ss_n64_tb(o1, kdesc(base + R_ET + kq * 32),
                      mndesc(base + R_V + TM * 128 + kq * 2048),
                      kq > 0 ? 1 : 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o0);
    fence_regs(o1);
    if (warp < 2)
      store_pv(o0, part, ld, warp, g, t4, T);
    else
      store_pv(o1, part, ld, warp, g, t4, T);
  };

  if constexpr (STAGE == 0) {
    for (int e = tid; e < TM * (CD / 8); e += ROW_THREADS) {
      const int r = e / (CD / 8), c = (e % (CD / 8)) * 8;
      cp_async16(base + R_V + sw_off(r, c, TM),
                 a.v1 + ((size_t)m0 + r) * CD + c);
    }
    cp_async_commit();
#pragma unroll
    for (int h = 0; h < H; ++h) {
      kf[h][0] = ld32(a.k1 + r0 * CD + h * HD + 2 * t4);
      kf[h][1] = ld32(a.k1 + r1 * CD + h * HD + 2 * t4);
      kf[h][2] = ld32(a.k1 + r0 * CD + h * HD + 2 * t4 + 8);
      kf[h][3] = ld32(a.k1 + r1 * CD + h * HD + 2 * t4 + 8);
    }
    cp_async_wait<0>();
    grid_wait();          // the token stage's query heads
    grid_launch_next();
    // The shared k/v tile serves ROW0_PROMPTS prompts in turn.
    for (int i = 0; i < ROW0_PROMPTS; ++i) {
      const int q = blockIdx.y * ROW0_PROMPTS + i;
      if (q >= a.P) break;
      __syncthreads();          // the previous prompt is done with QH, E^T
      load_qh(q);
      fence_async();
      __syncthreads();
      t2i_partial(q);
    }
  } else {
    // STAGE 1: keys0 through update 1 (keys1, stored); STAGE 2: keys1
    // through update 2 (keys2, stored), its queries from keys1 @ wide2[q].
    const int upd = STAGE - 1;
    // The update's out-projection bias and LayerNorm parameters: a load
    // from device memory inside the register-bound update would wait out
    // its latency.
    float* pst = reinterpret_cast<float*>(sm + R_PST);    // [3][C]
    for (int i = tid; i < C; i += ROW_THREADS) {
      pst[i] = wf(a, STAGE == 1 ? i2t1_o_b : i2t_o_b)[i];
      pst[C + i] = wf(a, STAGE == 1 ? n4l0_w : n4_w)[i];
      pst[2 * C + i] = wf(a, STAGE == 1 ? n4l0_b : n4_b)[i];
    }
    const bf16* src = STAGE == 1 ? a.keys0 : a.keys1 + (size_t)p * a.M * C;
    uint32_t xa[C / 16][4];
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) {
      const int col = kk * 16 + 2 * t4;
      xa[kk][0] = ld32(src + r0 * C + col);
      xa[kk][1] = ld32(src + r1 * C + col);
      xa[kk][2] = ld32(src + r0 * C + col + 8);
      xa[kk][3] = ld32(src + r1 * C + col + 8);
    }
    uint32_t qa[H][4];
    float acc[64];
    uint32_t pe[32];
    if constexpr (STAGE == 1) {
#pragma unroll
      for (int h = 0; h < H; ++h) {
        qa[h][0] = ld32(a.q1i + r0 * CD + h * HD + 2 * t4);
        qa[h][1] = ld32(a.q1i + r1 * CD + h * HD + 2 * t4);
        qa[h][2] = ld32(a.q1i + r0 * CD + h * HD + 2 * t4 + 8);
        qa[h][3] = ld32(a.q1i + r1 * CD + h * HD + 2 * t4 + 8);
      }
    } else {
      // q2i = keys1 @ wide2[q] + its PE-side term (staged in UT's space,
      // free until the folded values come).
      stage_pe(base + R_UT, wb(a, qpe2i) + (size_t)m0 * CD);
      gemm_rows(acc, xa, rr, issue);
      cp_async_wait<0>();
      __syncthreads();
      load_pe(pe, sm + R_UT, lr0, lr1, t4);
      heads_from_acc(qa, acc, pe);           // q2i, per head
      __syncthreads();
    }
    grid_wait();          // the token stage's keys and folded values
    grid_launch_next();
    {
      const bf16* usrc = a.ut[upd] + (size_t)p * C * HT;
      for (int e = tid; e < C * (HT / 8); e += ROW_THREADS) {
        const int c = e / (HT / 8), k = (e % (HT / 8)) * 8;
        cp_async16(base + R_UT + sw_off(c, k, C), usrc + c * HT + k);
      }
      const bf16* ksrc = a.ktok[upd] + (size_t)p * TP * CD;
      const int t = tid >> 4, k = (tid & 15) * 8;
      cp_async16(base + R_KT + sw_off(t, k, TP), ksrc + t * CD + k);
      cp_async_commit();
    }
    cp_async_wait<0>();
    fence_async();
    __syncthreads();
    float sc[H][4];
    head_scores(sc, qa, base + R_KT, TP, false);
    image_update(xa, sc, base + R_UT, pst, pst + C, pst + 2 * C, T, t4);
    __syncthreads();            // UT is free: staging, then v and QH
    store_rows(xa, sm + R_UT,
               (STAGE == 1 ? a.keys1 : a.keys2) + ((size_t)p * a.M + m0) * C,
               lr0, lr1, t4);
    load_qh(p);

    // k = x @ W_k^T + the PE-side terms (staged in the v tile's space), as
    // A fragments per head.
    stage_pe(base + R_V, wb(a, STAGE == 1 ? kpe2 : kpef) + (size_t)m0 * CD);
    gemm_rows(acc, xa, rr, issue);
    cp_async_wait<0>();
    __syncthreads();
    load_pe(pe, sm + R_V, lr0, lr1, t4);
    heads_from_acc(kf, acc, pe);
    // v = x @ W_v^T + bv into the v tile ([row][128], MN-major for P.V).
    const float* bv = wf(a, STAGE == 1 ? bv2 : bvf);
    gemm_rows(acc, xa, rr, issue);   // its first barrier: PE reads done
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = j * 8 + 2 * t4;
      const float2 b = *reinterpret_cast<const float2*>(bv + col);
      *reinterpret_cast<uint32_t*>(sm + R_V + sw_off(lr0, col, TM)) =
          pack_bf16(acc[4 * j] + b.x, acc[4 * j + 1] + b.y);
      *reinterpret_cast<uint32_t*>(sm + R_V + sw_off(lr1, col, TM)) =
          pack_bf16(acc[4 * j + 2] + b.x, acc[4 * j + 3] + b.y);
    }
    fence_async();
    __syncthreads();
    t2i_partial(p);
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

// The TMA map of a (rows, 256) bf16 weight: boxes of 64 inputs x 128 rows,
// 128-byte swizzle (the layout of the row phases' chunks).  A map depends
// only on the pointer and the fixed shape, so it is encoded once per
// parameter set and kept until another set comes.
struct WeightMap {
  const void* ptr = nullptr;
  alignas(64) CUtensorMap map;
};

const CUtensorMap* weight_map(WeightMap& w, const void* ptr, int rows) {
  if (w.ptr == ptr) return &w.map;
  cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)C * sizeof(bf16)};
  cuuint32_t box[2] = {64, WROWS}, elem[2] = {1, 1};
  if (encode_fn()(&w.map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                  const_cast<void*>(ptr), dims, strides, box, elem,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    w.ptr = nullptr;
    return nullptr;
  }
  w.ptr = ptr;
  return &w.map;
}

// Launch `k` on `st`; with `follows`, as a programmatic dependent of the
// kernel before it on the stream (see grid_wait).
template <typename... Params, typename... Act>
cudaError_t launch(void (*k)(Params...), dim3 grid, int threads, int smem,
                   cudaStream_t st, bool follows, Act... args) {
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
  return cudaLaunchKernelEx(&cfg, k, args...);
}

cudaError_t set_smem_attributes() {
  const void* tok[4] = {(const void*)tok_stage<0>, (const void*)tok_stage<1>,
                        (const void*)tok_stage<2>, (const void*)tok_stage<3>};
  const void* rows[3] = {(const void*)row_phase<0>, (const void*)row_phase<1>,
                         (const void*)row_phase<2>};
  for (const void* k : tok) {
    const cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, TOK_SMEM);
    if (err != cudaSuccess) return err;
  }
  for (const void* k : rows) {
    const cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, ROW_SMEM);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// params: host array of N_PARAMS device pointers in the order of enum Param.
// All tensors contiguous; bf16 unless noted.  Scratch (allocated by the
// caller): keys1 (P, M, 256), tok_state (2, P, 8, 256) f32, qh (P, 8, 128) f32,
// ktok1/ktok2 (P, 8, 128), ut1/ut2 (P, 256, 64), part (P, 64, M/64, 20) f32,
// att (P, 8, 128) f32.
// Requires M % 64 == 0, 1 <= T <= 8, mlp == 2048.  Launches on `stream` and
// returns cudaGetLastError(), or -1 when the CUDA driver has no
// cuTensorMapEncodeTiled, -2 when a weight's tensor map is refused.
extern "C" int twoway_tail_forward(
    const void* keys0, const void* q1i, const void* k1, const void* v1,
    const void* tokens, const void* const* params, void* keys2,
    void* keys1, void* tok_out, void* tok_state, void* qh, void* ktok1,
    void* ut1, void* ktok2, void* ut2, void* part, void* att, int P, int T,
    int M, int mlp, void* stream) {
  if (P <= 0 || M <= 0 || M % TM || T < 1 || T > TP || mlp != MLP)
    return (int)cudaErrorInvalidValue;
  if (encode_fn() == nullptr) return -1;
  static const cudaError_t attr = set_smem_attributes();
  if (attr != cudaSuccess) return (int)attr;
  static WeightMap map_wide2, map_widef;
  const CUtensorMap* m2 = weight_map(map_wide2, params[wide2], 3 * CD);
  const CUtensorMap* mf = weight_map(map_widef, params[widef], 2 * CD);
  if (m2 == nullptr || mf == nullptr) return -2;

  Args a;
  a.keys0 = static_cast<const bf16*>(keys0);
  a.q1i = static_cast<const bf16*>(q1i);
  a.k1 = static_cast<const bf16*>(k1);
  a.v1 = static_cast<const bf16*>(v1);
  a.tokens = static_cast<const bf16*>(tokens);
  a.keys1 = static_cast<bf16*>(keys1);
  a.keys2 = static_cast<bf16*>(keys2);
  a.tok_out = static_cast<bf16*>(tok_out);
  a.tok_state = static_cast<float*>(tok_state);
  a.qh = static_cast<float*>(qh);
  a.ktok[0] = static_cast<bf16*>(ktok1);
  a.ktok[1] = static_cast<bf16*>(ktok2);
  a.ut[0] = static_cast<bf16*>(ut1);
  a.ut[1] = static_cast<bf16*>(ut2);
  a.part = static_cast<float*>(part);
  a.att = static_cast<float*>(att);
  a.P = P;
  a.T = T;
  a.M = M;
  a.NT = M / TM;
  for (int i = 0; i < N_PARAMS; ++i) a.w[i] = params[i];

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tgrid = CL * ((P * TP + TM - 1) / TM);
  const dim3 rgrid(a.NT, P);
  const dim3 rgrid0(a.NT, (P + ROW0_PROMPTS - 1) / ROW0_PROMPTS);
  const int mgrid = (P * HT + MERGE_THREADS / 32 - 1) / (MERGE_THREADS / 32);
  // The first kernel waits for all the caller's work (a plain launch); each
  // later one follows the kernel before it.
  // 0..3: token stage, 4..6: row phase, 7: merge.
  const int order[10] = {0, 4, 7, 1, 5, 7, 2, 6, 7, 3};
  for (int i = 0; i < 10; ++i) {
    const int w = order[i];
    const bool follows = i > 0;
    cudaError_t err;
    if (w < 4) {
      void (*k)(Args) = w == 0 ? tok_stage<0> : w == 1 ? tok_stage<1>
                      : w == 2 ? tok_stage<2> : tok_stage<3>;
      err = launch(k, dim3(tgrid), TOK_THREADS, TOK_SMEM, st, follows, a);
    } else if (w < 7) {
      void (*k)(CUtensorMap, CUtensorMap, Args) =
          w == 4 ? row_phase<0> : w == 5 ? row_phase<1> : row_phase<2>;
      err = launch(k, w == 4 ? rgrid0 : rgrid, ROW_THREADS, ROW_SMEM, st,
                   follows, *m2, *mf, a);
    } else {
      err = launch(merge_stage, dim3(mgrid), MERGE_THREADS, 0, st, follows,
                   a);
    }
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
