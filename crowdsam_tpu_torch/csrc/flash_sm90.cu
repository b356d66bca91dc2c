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
#include "sm90.cuh"

namespace {

using namespace sm90;

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

struct Params {
  __nv_bfloat16* o;
  long long obs, ohs, old;   // output batch, head, token strides (elements)
  int seq, kv_len;
  float scale_log2;          // softmax scale * log2(e)
  int pos[3][3];             // q/k/v: tensor-map dim of (head, token, batch)
};

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
      load_bhsd(sq, &tm_q, q_full, p.pos[0], h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(full_k + 8 * s, TILE_BYTES);
        load_bhsd(sk + s * TILE_BYTES, &tm_k, full_k + 8 * s, p.pos[1], h,
                  it * BK, b);
        mbar_expect_tx(full_v + 8 * s, TILE_BYTES);
        load_bhsd(sv + s * TILE_BYTES, &tm_v, full_v + 8 * s, p.pos[2], h,
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
    issue_qk(sc, sq, sk + s * TILE_BYTES, false);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    const float no_off[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    softmax_tile(sc, pa, m, l, alpha, p.kv_len - it * BK, t4, sl2, no_off);
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
    if (!encode_bhsd(&maps[i], ptrs[i], layouts + 14 * i, p.pos[i],
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
