// K7: the survivor mask tail on row bands.
//
// Replaces the JAX package's Pallas `survivor_rle_pallas`
// (crowdsam_tpu/ops/survivor_kernel.py:231).  Contract and plain version:
// `crowdsam_tpu_torch/ops/survivor_kernel.py`.  Per mask, with S = 4R:
// bilinear 4x upsample of the (R, R) logits, threshold, nearest-expanded
// cleanup edits, crop to (in_h, in_w), the bit-packed bitmap (S, S/8), the
// box, and per column the Fortran-order change count and first 24 change
// rows (three 10-bit rows a word).
//
// What bounds it.  By bytes, a mask reads R*R logits and edits (192 KB at
// R = 256, bf16) and writes 164 KB (packed bits, change rows, counts): 0.0035
// ms for 32 masks at 3.35 TB/s.  The arithmetic is a few float operations a
// pixel, but the column walk is a chain: the first design gave each thread
// one column and walked its 1024 rows in order, 8 blocks of 4 warps a mask,
// and spent ~450 cycles a row step waiting on its own chain (0.263 ms at
// k = 32, 1.3% of its bound's rate).  The packed bits of a row do not depend
// on the row above; only the change count, the first 24 change rows and the
// first and last set rows are carried down a column, and all of them
// combine across row bands.
//
// Design.  A block covers 32 columns x BANDS row bands of S / BANDS rows;
// warp b walks band b of the 32 columns, one column a lane, so 8 times as
// many warps walk 8 times shorter chains.
// - The block stages its 10 source columns (8 plus one on each side) of all
//   R rows once in shared memory as float, with their edits (12.5 KB at
//   R = 256).
// - The walk steps one source row q (four output rows 4q .. 4q + 3) at a
//   time.  The horizontal pass of source rows q - 1, q and q + 1 is carried
//   in registers, one new row a step; the four vertical weights are
//   constants of the step (k/8; the first and the last step of a mask,
//   where the resize clamps to one weight of 1, are peeled); each pass is a
//   product, a product and a sum with __fmul_rn/__fadd_rn, so nothing is
//   contracted to an FMA and every pixel is the plain version's bit for
//   bit.  The step's edit (one low-res cell covers its four rows) overrides
//   the four bits at once, by a select.
// - The four bits go into the lane's own column word.  Every 32 rows (or
//   at the band's end) the word is cut to the valid rows (rows at or past
//   in_h, and all rows of a column at or past in_w, are empty and carry no
//   changes, as in the plain version); its changes against the row above
//   (word ^ (word << 1 | last)) give the band's count by popcount and its
//   first change rows, which go to the band's list in shared memory while
//   it has fewer than 24; its first and last set rows update the band's.
// - Packed bits: the same 32 x 32 bit block, transposed across the warp
//   (five butterfly levels of shuffles), gives lane i the 32 columns of row
//   i; __brev puts column 0 at bit 31 and a byte swap makes the word's
//   first byte in memory hold columns 0-7 with column 0 at bit 7
//   (MSB-first, np.unpackbits order).
// - What row y0 of band b > 0 compares with is pixel (y0 - 1, x), the last
//   row of band b - 1: the band's own lane recomputes it from the staged
//   strip (one more horizontal row and one blend), so the change at the
//   band boundary is counted in band b and no pixel crosses between warps.
//   Band 0's row 0 compares with the column link, pixel (in_h - 1, x - 1),
//   recomputed the same way.
// - The merge, in band order, in shared memory (no atomics: two runs agree
//   bit for bit).  A column's count is the sum of its bands' counts; its
//   first 24 change rows are the bands' lists concatenated in band order
//   and cut at 24 (thread (x, b) forms output word b, slots 3b .. 3b + 2,
//   from the bands' prefix counts); its first and last set rows are the
//   min and max over the bands.
// - Box, totals and the overflow flag: reduced over the block's 32 columns
//   by one warp, written per strip, and reduced over the strips by a second
//   small kernel in strip order (a launch of ~2 us; folding it in would
//   need a last-block count across the strips).
//
// Measured against each other in single calls (device ms at k = 1 / 32 /
// 320 person-shaped masks, H100 80GB HBM3 at 700 W, one-off A/B probes):
// the first design 0.209 / 0.261 / 1.130; bands with four ballots a step and
// the change bookkeeping every step 0.018 / 0.060 / 0.448; with the
// transpose 0.018 / 0.053 / 0.370; as here 0.0124 / 0.0403 / 0.2856
// (chip_smoke.py: 0.0120 / 0.0405-0.0407 / 0.2856-0.2890).
//
// Shared memory a block (R = 256, 8 bands): strip 10,240 + edits 2,560 +
// band lists 8 x 24 x 32 x 2 = 12,288 + counts and set rows 3 x 8 x 32 x 4 =
// 3,072: 28,160 bytes, static; eight blocks (64 warps) an SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int STRIP = 32;             // output columns per block: one warp
constexpr int SRC = STRIP / 4 + 2;    // source columns a strip reads
constexpr int BANDS = 8;              // row bands per block: one warp each
constexpr int MAX_R = 256;
constexpr int COL_SLOTS = 24;
constexpr int CAND_WORDS = COL_SLOTS / 3;
constexpr int PART = 8;               // per-strip partial summary words
static_assert(BANDS >= CAND_WORDS, "band b forms output word b");

__device__ __forceinline__ float blend(float wa, float a, float wb, float b) {
    return __fadd_rn(__fmul_rn(wa, a), __fmul_rn(wb, b));
}

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

// A 32 x 32 bit matrix across the warp: lane l holds row l (bit i =
// A[l][i]); returns row i of the transpose in lane i (bit l = A[l][i]).
// Five levels swap the off-diagonal blocks of 16, 8, 4, 2 and 1.
__device__ __forceinline__ unsigned transpose32(unsigned x, int lane) {
    unsigned m = 0x0000FFFFu;
#pragma unroll
    for (int j = 16; j > 0; j >>= 1, m ^= m << j) {
        const unsigned y = __shfl_xor_sync(0xffffffffu, x, j);
        x = (lane & j) ? (x & ~m) | ((y >> j) & m) : (x & m) | ((y & m) << j);
    }
    return x;
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
__global__ void __launch_bounds__(STRIP * BANDS)
survivor_band_kernel(const T* __restrict__ logits,
                     const int8_t* __restrict__ edit,
                     const int* __restrict__ in_hw, float thresh, int r,
                     uint8_t* __restrict__ packed, int* __restrict__ cand,
                     int* __restrict__ n_col, int* __restrict__ partial) {
    __shared__ float src[MAX_R][SRC];
    __shared__ int8_t eds[MAX_R][SRC];
    __shared__ uint16_t rows[BANDS][COL_SLOTS][STRIP];
    __shared__ int cnt[BANDS][STRIP];
    __shared__ int ymn[BANDS][STRIP];
    __shared__ int ymx[BANDS][STRIP];

    const int s = 4 * r;
    const int strip = blockIdx.x, k = blockIdx.y;
    const int tid = threadIdx.x, lane = tid & 31, band = tid >> 5;
    const int x = strip * STRIP + lane;
    const int c_base = strip * (STRIP / 4) - 1;   // source column of slot 0
    // Clamped to [1, S], as the plain version clamps: the column link reads
    // row in_h - 1 of the staged strip.
    const int in_h = min(max(in_hw[2 * k], 1), s);
    const int in_w = min(max(in_hw[2 * k + 1], 1), s);

    const T* lg = logits + (size_t)k * r * r;
    const int8_t* ed = edit + (size_t)k * r * r;
    for (int i = tid; i < r * SRC; i += STRIP * BANDS) {
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
    auto hrow = [&](int q) {   // the horizontal pass of source row q
        return blend(xwa, src[q][xlo], xwb, src[q][xhi]);
    };
    auto pixel = [&](int e, float v) {
        return e > 0 ? 1 : (e < 0 ? 0 : (v > thresh ? 1 : 0));
    };

    const int rows_b = s / BANDS;                 // output rows a band
    const int y0 = band * rows_b, q0 = y0 >> 2;
    // The pixel row y0 compares with: (y0 - 1, x), or for band 0 the column
    // link (in_h - 1, x - 1), 0 for column 0.
    int last = 0;
    if (col_ok && y0 < in_h) {
        if (band > 0) {
            last = pixel(eds[q0 - 1][xe],
                         blend(0.625f, hrow(q0 - 1), 0.375f, hrow(q0)));
        } else if (x > 0) {
            int plo, phi, ylo, yhi;
            float pwa, pwb, ya, yb;
            taps(x - 1, r, plo, phi, pwa, pwb);
            const int y = in_h - 1;
            taps(y, r, ylo, yhi, ya, yb);
            plo -= c_base;
            phi -= c_base;
            const float up = blend(
                ya, blend(pwa, src[ylo][plo], pwb, src[ylo][phi]), yb,
                blend(pwa, src[yhi][plo], pwb, src[yhi][phi]));
            last = pixel(eds[y >> 2][((x - 1) >> 2) - c_base], up);
        }
    }

    int n = 0, ymin = s, ymax = -1;
    // Rows at or past in_h, and every row of a column at or past in_w, are
    // empty and carry no changes.
    const int lim = col_ok ? in_h : 0;
    const float* s_lo = &src[0][xlo];
    const float* s_hi = &src[0][xhi];
    const int8_t* s_ed = &eds[0][xe];
    float hp = hrow(max(q0 - 1, 0)), hc = hrow(q0);
    uint8_t* out = packed + (size_t)k * s * (s / 8) + strip * (STRIP / 8);
    // The rows' bits collect in the lane's own column word, four a step.
    // Every 32 rows (or at the band's end) the word is cut to the valid
    // rows; its changes against the row above, its first and last set rows
    // are taken from it at once, and a transpose across the warp gives lane
    // i the 32 columns of row i.
    unsigned colbits = 0;
    const int nq = rows_b / 4;
    auto flush = [&](int qq) {
        const int steps = (qq & 7) + 1;
        const int y_base = 4 * (q0 + qq + 1 - steps);
        const int left = min(max(lim - y_base, 0), 4 * steps);
        const unsigned valid = left == 32 ? 0xffffffffu : (1u << left) - 1u;
        const unsigned bits = colbits & valid;
        const unsigned ch = (bits ^ ((bits << 1) | last)) & valid;
        last = bits >> 31;
        if (ch) {
            unsigned c = ch;
            for (int j = n; c && j < COL_SLOTS; ++j) {
                rows[band][j][lane] = (uint16_t)(y_base + __ffs(c) - 1);
                c &= c - 1;
            }
            n += __popc(ch);
        }
        if (bits) {
            if (ymin == s) ymin = y_base + __ffs(bits) - 1;
            ymax = y_base + 31 - __clz(bits);
        }
        const unsigned word = transpose32(bits, lane);
        if (lane < 4 * steps)
            *reinterpret_cast<uint32_t*>(
                out + (size_t)(y_base + lane) * (s / 8)) =
                __byte_perm(__brev(word), 0, 0x0123);
        colbits = 0;
    };
    // One source row q: output rows 4q, 4q + 1 blend source rows q - 1 and
    // q, rows 4q + 2, 4q + 3 rows q and q + 1; at the top and the bottom
    // edge the resize clamps to one weight of 1.  Called with constant
    // edges, so the weights fold.
    auto step = [&](int qq, bool top, bool bottom) {
        const int q = q0 + qq;
        const float hn = bottom ? hc : blend(xwa, s_lo[(q + 1) * SRC], xwb,
                                             s_hi[(q + 1) * SRC]);
        const float v0 = top ? blend(1.0f, hp, 0.0f, hc)
                             : blend(0.375f, hp, 0.625f, hc);
        const float v1 = top ? blend(1.0f, hp, 0.0f, hc)
                             : blend(0.125f, hp, 0.875f, hc);
        const float v2 = bottom ? blend(1.0f, hc, 0.0f, hn)
                                : blend(0.875f, hc, 0.125f, hn);
        const float v3 = bottom ? blend(1.0f, hc, 0.0f, hn)
                                : blend(0.625f, hc, 0.375f, hn);
        hp = hc;
        hc = hn;
        const int e = s_ed[q * SRC];
        const unsigned up = (v0 > thresh ? 1u : 0u) | (v1 > thresh ? 2u : 0u) |
                            (v2 > thresh ? 4u : 0u) | (v3 > thresh ? 8u : 0u);
        const unsigned nib = e > 0 ? 0xFu : (e < 0 ? 0u : up);
        colbits |= nib << (4 * (qq & 7));
        if ((qq & 7) == 7 || qq == nq - 1) flush(qq);
    };
    int qq = 0;
    if (q0 == 0) step(qq++, true, false);
    const int q_end = q0 + nq == r ? nq - 1 : nq;
    for (; qq < q_end; ++qq) step(qq, false, false);
    if (q_end < nq) step(qq, false, true);
    cnt[band][lane] = n;
    ymn[band][lane] = ymin;
    ymx[band][lane] = ymax;
    __syncthreads();

    // Merge in band order: thread (x, b < 8) forms output word b of column
    // x, change slots 3b .. 3b + 2.
    if (band < CAND_WORDS) {
        int slot[3] = {s - 1, s - 1, s - 1};
        int total = 0;
#pragma unroll
        for (int bb = 0; bb < BANDS; ++bb) {
            const int c = cnt[bb][lane];
#pragma unroll
            for (int i = 0; i < 3; ++i) {
                const int j = 3 * band + i;
                if (j >= total && j < total + c)
                    slot[i] = rows[bb][j - total][lane];
            }
            total += c;
        }
        cand[((size_t)k * CAND_WORDS + band) * s + x] =
            (slot[0] << 20) | (slot[1] << 10) | slot[2];
        if (band == 0) {
            n_col[(size_t)k * s + x] = total;
            int y_lo = s, y_hi = -1;
#pragma unroll
            for (int bb = 0; bb < BANDS; ++bb) {
                y_lo = min(y_lo, ymn[bb][lane]);
                y_hi = max(y_hi, ymx[bb][lane]);
            }
            // Strip reduction: [x0, y0, x1, y1, any, total, max n].
            const bool any = y_hi >= 0;
            int v[7] = {any ? x : s, y_lo, any ? x : -1, y_hi, any ? 1 : 0,
                        total, total};
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
                int* p = partial + ((size_t)k * gridDim.x + strip) * PART;
#pragma unroll
                for (int i = 0; i < 7; ++i) p[i] = v[i];
                p[7] = 0;
            }
        }
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
// (K, S), partial (K, S/32, 8) scratch and summary (K, 8) int32.  R a
// multiple of 8, at most 256.  Returns the cudaError_t of the launches.
extern "C" int survivor_rle_forward(const void* logits, int logits_f32,
                                    const void* edit, const void* in_hw,
                                    float thresh, int k, int r, void* packed,
                                    void* cand, void* n_col, void* partial,
                                    void* summary, cudaStream_t stream) {
    if (k <= 0 || r <= 0 || r > MAX_R || r % 8)
        return static_cast<int>(cudaErrorInvalidValue);
    const int s = 4 * r;
    const dim3 grid(s / STRIP, k);
    const int8_t* ed = static_cast<const int8_t*>(edit);
    const int* hw = static_cast<const int*>(in_hw);
    if (logits_f32)
        survivor_band_kernel<float><<<grid, STRIP * BANDS, 0, stream>>>(
            static_cast<const float*>(logits), ed, hw, thresh, r,
            static_cast<uint8_t*>(packed), static_cast<int*>(cand),
            static_cast<int*>(n_col), static_cast<int*>(partial));
    else
        survivor_band_kernel<__nv_bfloat16>
            <<<grid, STRIP * BANDS, 0, stream>>>(
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
