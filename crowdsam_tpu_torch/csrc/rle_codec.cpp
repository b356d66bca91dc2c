// COCO run-length-encoding codec (host C++, not a device kernel).
//
// The port's own copy of the JAX package's `native/rle_codec.cpp`: it turns
// Fortran-order byte masks or ready-made run counts into COCO "compressed
// RLE" strings and back, in place of pycocotools (reference
// `segment_anything_cs/utils/amg.py:294-300`, `crowdsam/utils.py:59-70`).
//
// The string format: run counts alternating 0-run, 1-run, ... starting with
// the leading zeros (possibly 0); every count after the second is stored as
// a delta against the count two places back, each value as little-endian
// 5-bit groups with a continuation bit, biased by 48 into printable ASCII.
//
// Built by `crowdsam_tpu_torch/kernels/_build.py` with
// `g++ -O3 -shared -fPIC -std=c++17` and loaded through ctypes (plain C ABI).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Append the compressed form of `cnts` to `out`; -1 when it does not fit.
int64_t compress(const int64_t* cnts, int64_t m, char* out, int64_t out_cap) {
    int64_t p = 0;
    for (int64_t i = 0; i < m; ++i) {
        int64_t x = cnts[i];
        if (i > 2) x -= cnts[i - 2];
        bool more = true;
        while (more) {
            int64_t c = x & 0x1f;
            x >>= 5;
            more = (c & 0x10) ? (x != -1) : (x != 0);
            if (more) c |= 0x20;
            if (p >= out_cap) return -1;
            out[p++] = static_cast<char>(c + 48);
        }
    }
    return p;
}

// Parse a compressed string into run counts; false on a truncated value.
bool decompress(const char* s, int64_t slen, std::vector<int64_t>& cnts) {
    int64_t i = 0;
    while (i < slen) {
        int64_t x = 0;
        int k = 0;
        bool more = true;
        while (more) {
            if (i >= slen) return false;
            int64_t c = static_cast<int64_t>(s[i]) - 48;
            x |= (c & 0x1f) << (5 * k);
            more = (c & 0x20) != 0;
            ++i;
            ++k;
            if (!more && (c & 0x10)) x |= -1LL << (5 * k);
        }
        if (cnts.size() > 2) x += cnts[cnts.size() - 2];
        cnts.push_back(x);
    }
    return true;
}

}  // namespace

extern "C" {

// Encode one Fortran-order 0/1 byte mask of length n.  Writes the string
// into `out` (capacity `out_cap`, not NUL-terminated); returns its length,
// or -1 when it does not fit.
int64_t rle_encode_mask(const uint8_t* data, int64_t n, char* out,
                        int64_t out_cap) {
    std::vector<int64_t> cnts;
    cnts.reserve(256);
    uint8_t cur = 0;
    int64_t run = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint8_t v = data[i] ? 1 : 0;
        if (v != cur) {
            cnts.push_back(run);
            run = 0;
            cur = v;
        }
        ++run;
    }
    cnts.push_back(run);
    return compress(cnts.data(), static_cast<int64_t>(cnts.size()), out,
                    out_cap);
}

// Decode a compressed string into a Fortran-order byte mask of length n.
// Returns 0, or -1 when the string is malformed or its runs do not sum to n.
int64_t rle_decode_mask(const char* s, int64_t slen, uint8_t* out, int64_t n) {
    std::vector<int64_t> cnts;
    cnts.reserve(256);
    if (!decompress(s, slen, cnts)) return -1;
    int64_t pos = 0;
    uint8_t v = 0;
    for (int64_t c : cnts) {
        if (c < 0 || pos + c > n) return -1;
        std::memset(out + pos, v, static_cast<size_t>(c));
        pos += c;
        v ^= 1;
    }
    return pos == n ? 0 : -1;
}

// B masks of length n each, stored one after another: mask b's string goes
// to `out + b * out_stride`, its length to lens[b].  Returns 0, or -1 when
// any mask did not fit (its length is then 0).
int64_t rle_encode_batch(const uint8_t* data, int64_t b, int64_t n, char* out,
                         int64_t out_stride, int64_t* lens) {
    int64_t status = 0;
    for (int64_t i = 0; i < b; ++i) {
        int64_t len = rle_encode_mask(data + i * n, n, out + i * out_stride,
                                      out_stride);
        if (len < 0) {
            status = -1;
            len = 0;
        }
        lens[i] = len;
    }
    return status;
}

// Compress ready-made run counts (the survivor pass's change positions
// turned into runs on the host).  Returns the length, or -1.
int64_t rle_compress_counts(const int64_t* cnts, int64_t m, char* out,
                            int64_t out_cap) {
    return compress(cnts, m, out, out_cap);
}

// Foreground area (the sum of the odd runs) of a compressed string, or -1.
int64_t rle_area(const char* s, int64_t slen) {
    std::vector<int64_t> cnts;
    if (!decompress(s, slen, cnts)) return -1;
    int64_t area = 0;
    for (size_t j = 1; j < cnts.size(); j += 2) area += cnts[j];
    return area;
}

}  // extern "C"
