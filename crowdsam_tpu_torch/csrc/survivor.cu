// K7: the survivor mask tail, one post-NMS mask per blockIdx.y.
//
// Replaces the JAX package's Pallas `survivor_rle_pallas`
// (crowdsam_tpu/ops/survivor_kernel.py:231).  Contract and plain version:
// `crowdsam_tpu_torch/ops/survivor_kernel.py`.  Per mask, with S = 4R:
// bilinear 4x upsample of the (R, R) logits, threshold, nearest-expanded
// cleanup edits, crop to (in_h, in_w), the bit-packed bitmap (S, S/8), the
// box, and per column the Fortran-order change count and first 24 change
// rows (three 10-bit rows a word).
//
// Bound: bytes.  A mask reads R*R logits and edits (192 KB at R = 256, bf16)
// and writes 164 KB (packed bits, change rows, counts); the arithmetic is a
// few float operations per output pixel.
//
// Design.  The TPU kernel expresses everything as matmuls with constant
// operators for its matrix unit; here a thread owns one output column x and
// walks y = 0 .. S-1 in order, carrying the column's state in registers:
// the previous pixel, the change count, the first 24 change rows packed
// three to an int32, and the column's first and last set rows.
// - A block covers a strip of 128 columns (4 warps).  Those read 34 source
//   columns (32 plus one on each side), staged once in shared memory as
//   float together with their edits: 43.5 KB at R = 256.
// - The upsample computes the horizontal pass first (two taps of the
//   column), then the vertical one (two taps of the row), each as a
//   product, a product and a sum with __fmul_rn/__fadd_rn, so nothing is
//   contracted to an FMA and the result is the plain version's bit for bit.
//   The horizontal values of the two source rows in use are kept and
//   recomputed only when the row's taps move on.
// - Packed bits: __ballot_sync over the warp's 32 columns gives 32 bits of
//   row y; __brev puts column 0 at bit 31 and a byte swap makes the word's
//   first byte in memory hold columns 0-7 with column 0 at bit 7
//   (MSB-first, np.unpackbits order).
// - The column link: row 0 of column x compares with pixel (in_h-1, x-1).
//   Each thread recomputes that one pixel from the staged strip (which
//   holds source column lo(x-1)) rather than wait for its neighbour.
// - Box, totals and overflow: reduced over the block, written per strip,
//   and reduced over the strips by a second small kernel in strip order
//   (no atomics: two runs agree bit for bit).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int STRIP = 128;            // output columns per block
constexpr int SRC = STRIP / 4 + 2;    // source columns a strip reads
constexpr int MAX_R = 256;
constexpr int COL_SLOTS = 24;
constexpr int CAND_WORDS = COL_SLOTS / 3;
constexpr int PART = 8;               // per-strip partial summary words

// The two taps of output index o of the 4x linear resize of n samples
// (jax.image.resize "linear", half-pixel centres): o = 4q + m sits at
// q + (2m - 3)/8, so the weights are k/8; where a tap falls off the edge
// the resize renormalizes to one weight of 1.
__device__ __forceinline__ void taps(int o, int n, int& lo, int& hi,
                                     float& wa, float& wb) {
    const int q = o >> 2, m = o & 3;
    lo = (m < 2) ? q - 1 : q;
    hi = lo + 1;
    wb = (m == 0) ? 0.625f : (m == 1) ? 0.875f : (m == 2) ? 0.125f : 0.375f;
    wa = 1.0f - wb;
    if (lo < 0) {
        lo = 0; hi = 0; wa = 1.0f; wb = 0.0f;
    } else if (hi > n - 1) {
        hi = lo; wa = 1.0f; wb = 0.0f;
    }
}

__device__ __forceinline__ float blend(float wa, float a, float wb, float b) {
    return __fadd_rn(__fmul_rn(wa, a), __fmul_rn(wb, b));
}

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
    return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(STRIP)
survivor_strip_kernel(const T* __restrict__ logits,
                      const int8_t* __restrict__ edit,
                      const int* __restrict__ in_hw, float thresh, int r,
                      uint8_t* __restrict__ packed, int* __restrict__ cand,
                      int* __restrict__ n_col, int* __restrict__ partial) {
    __shared__ float src[MAX_R][SRC];
    __shared__ int8_t eds[MAX_R][SRC];
    __shared__ int red[STRIP / 32][PART];

    const int s = 4 * r;
    const int strip = blockIdx.x, k = blockIdx.y;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int x = strip * STRIP + tid;
    const int c_base = strip * (STRIP / 4) - 1;   // source column of slot 0
    // Clamped to [1, S], as the plain version clamps: the column link reads
    // row in_h - 1 of the staged strip.
    const int in_h = min(max(in_hw[2 * k], 1), s);
    const int in_w = min(max(in_hw[2 * k + 1], 1), s);

    const T* lg = logits + (size_t)k * r * r;
    const int8_t* ed = edit + (size_t)k * r * r;
    for (int i = tid; i < r * SRC; i += STRIP) {
        const int row = i / SRC, c = i % SRC;
        const int col = min(max(c_base + c, 0), r - 1);
        src[row][c] = to_f32(lg[(size_t)row * r + col]);
        eds[row][c] = ed[(size_t)row * r + col];
    }
    __syncthreads();

    int xlo, xhi;
    float xwa, xwb;
    taps(x, r, xlo, xhi, xwa, xwb);
    xlo -= c_base;
    xhi -= c_base;
    const int xe = (x >> 2) - c_base;
    const bool col_ok = x < in_w;

    // The column link: pixel (in_h - 1, x - 1), or 0 for column 0.
    int link = 0;
    if (col_ok && x > 0) {
        int plo, phi, ylo, yhi;
        float pwa, pwb, ya, yb;
        taps(x - 1, r, plo, phi, pwa, pwb);
        const int y = in_h - 1;
        taps(y, r, ylo, yhi, ya, yb);
        const int e = eds[y >> 2][((x - 1) >> 2) - c_base];
        plo -= c_base;
        phi -= c_base;
        const float up = blend(ya, blend(pwa, src[ylo][plo], pwb, src[ylo][phi]),
                               yb, blend(pwa, src[yhi][plo], pwb, src[yhi][phi]));
        link = e > 0 ? 1 : (e < 0 ? 0 : (up > thresh ? 1 : 0));
    }

    const int empty = (s - 1) | ((s - 1) << 10) | ((s - 1) << 20);
    int words[CAND_WORDS];
#pragma unroll
    for (int t = 0; t < CAND_WORDS; ++t) words[t] = empty;
    int n = 0, last = link, ymin = s, ymax = -1;
    int ra = -1, rb = -1;                    // source rows of ha, hb
    float ha = 0.0f, hb = 0.0f;
    uint8_t* out_row = packed + (size_t)k * s * (s / 8) + (x - lane) / 8;

    for (int y = 0; y < s; ++y) {
        int bit = 0;
        if (col_ok && y < in_h) {
            const int e = eds[y >> 2][xe];
            if (e != 0) {
                bit = e > 0;
            } else {
                int ylo, yhi;
                float ya, yb;
                taps(y, r, ylo, yhi, ya, yb);
                if (ylo != ra) {
                    ha = (ylo == rb) ? hb : blend(xwa, src[ylo][xlo], xwb,
                                                  src[ylo][xhi]);
                    ra = ylo;
                }
                if (yhi != rb) {
                    hb = (yhi == ra) ? ha : blend(xwa, src[yhi][xlo], xwb,
                                                  src[yhi][xhi]);
                    rb = yhi;
                }
                bit = blend(ya, ha, yb, hb) > thresh;
            }
            if (bit != last) {
                if (n < COL_SLOTS) {
                    const int t = n / 3, shift = 20 - 10 * (n % 3);
#pragma unroll
                    for (int w = 0; w < CAND_WORDS; ++w)
                        if (w == t)
                            words[w] = (words[w] & ~(0x3FF << shift)) |
                                       (y << shift);
                }
                ++n;
            }
            last = bit;
            if (bit) {
                ymin = min(ymin, y);
                ymax = y;
            }
        }
        const unsigned b = __ballot_sync(0xffffffffu, bit);
        if (lane == 0)
            *reinterpret_cast<uint32_t*>(out_row + (size_t)y * (s / 8)) =
                __byte_perm(__brev(b), 0, 0x0123);
    }

#pragma unroll
    for (int t = 0; t < CAND_WORDS; ++t)
        cand[((size_t)k * CAND_WORDS + t) * s + x] = words[t];
    n_col[(size_t)k * s + x] = n;

    // Block reduction: [x0, y0, x1, y1, any, total, max n].
    const bool any = ymax >= 0;
    int v[7] = {any ? x : s, ymin, any ? x : -1, ymax, any ? 1 : 0, n, n};
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        v[0] = min(v[0], __shfl_xor_sync(0xffffffffu, v[0], off));
        v[1] = min(v[1], __shfl_xor_sync(0xffffffffu, v[1], off));
        v[2] = max(v[2], __shfl_xor_sync(0xffffffffu, v[2], off));
        v[3] = max(v[3], __shfl_xor_sync(0xffffffffu, v[3], off));
        v[4] = max(v[4], __shfl_xor_sync(0xffffffffu, v[4], off));
        v[5] += __shfl_xor_sync(0xffffffffu, v[5], off);
        v[6] = max(v[6], __shfl_xor_sync(0xffffffffu, v[6], off));
    }
    if (lane == 0) {
#pragma unroll
        for (int i = 0; i < 7; ++i) red[warp][i] = v[i];
    }
    __syncthreads();
    if (tid == 0) {
        for (int w = 1; w < STRIP / 32; ++w) {
            v[0] = min(v[0], red[w][0]);
            v[1] = min(v[1], red[w][1]);
            v[2] = max(v[2], red[w][2]);
            v[3] = max(v[3], red[w][3]);
            v[4] = max(v[4], red[w][4]);
            v[5] += red[w][5];
            v[6] = max(v[6], red[w][6]);
        }
        int* p = partial + ((size_t)k * gridDim.x + strip) * PART;
#pragma unroll
        for (int i = 0; i < 7; ++i) p[i] = v[i];
        p[7] = 0;
    }
}

// Per mask: the strips' partial summaries in strip order -> [x0, y0, x1, y1,
// nonempty, total, overflow, 0], the box [0, 0, 0, 0] when empty.
__global__ void survivor_summary_kernel(const int* __restrict__ partial,
                                        int n_strips, int k_masks, int s,
                                        int* __restrict__ summary) {
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= k_masks) return;
    int x0 = s, y0 = s, x1 = -1, y1 = -1, any = 0, total = 0, maxn = 0;
    for (int i = 0; i < n_strips; ++i) {
        const int* p = partial + ((size_t)k * n_strips + i) * PART;
        x0 = min(x0, p[0]);
        y0 = min(y0, p[1]);
        x1 = max(x1, p[2]);
        y1 = max(y1, p[3]);
        any |= p[4];
        total += p[5];
        maxn = max(maxn, p[6]);
    }
    int* o = summary + (size_t)k * 8;
    o[0] = any ? x0 : 0;
    o[1] = any ? y0 : 0;
    o[2] = any ? x1 : 0;
    o[3] = any ? y1 : 0;
    o[4] = any;
    o[5] = total;
    o[6] = maxn > COL_SLOTS ? 1 : 0;
    o[7] = 0;
}

}  // namespace

// logits (K, R, R) bf16 (logits_f32 = 0) or float32; edit (K, R, R) int8;
// in_hw (K, 2) int32; packed (K, S, S/8) uint8; cand (K, 8, S), n_col
// (K, S), partial (K, S/128, 8) scratch and summary (K, 8) int32.  R a
// multiple of 32, at most 256.  Returns the cudaError_t of the launches.
extern "C" int survivor_rle_forward(const void* logits, int logits_f32,
                                    const void* edit, const void* in_hw,
                                    float thresh, int k, int r, void* packed,
                                    void* cand, void* n_col, void* partial,
                                    void* summary, cudaStream_t stream) {
    const int s = 4 * r;
    const dim3 grid(s / STRIP, k);
    const int8_t* ed = static_cast<const int8_t*>(edit);
    const int* hw = static_cast<const int*>(in_hw);
    if (logits_f32)
        survivor_strip_kernel<float><<<grid, STRIP, 0, stream>>>(
            static_cast<const float*>(logits), ed, hw, thresh, r,
            static_cast<uint8_t*>(packed), static_cast<int*>(cand),
            static_cast<int*>(n_col), static_cast<int*>(partial));
    else
        survivor_strip_kernel<__nv_bfloat16><<<grid, STRIP, 0, stream>>>(
            static_cast<const __nv_bfloat16*>(logits), ed, hw, thresh, r,
            static_cast<uint8_t*>(packed), static_cast<int*>(cand),
            static_cast<int*>(n_col), static_cast<int*>(partial));
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    survivor_summary_kernel<<<(k + 127) / 128, 128, 0, stream>>>(
        static_cast<const int*>(partial), s / STRIP, k, s,
        static_cast<int*>(summary));
    return static_cast<int>(cudaGetLastError());
}
