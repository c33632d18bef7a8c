// Host C++ of the store tier's read path and of the LZ4 block codec, with a
// plain C interface for ctypes (diagon_tpu_torch/native.py builds it with
// bulk.cpp into one library).
//
// Copied from diagon_tpu/native/_native.cpp (decode_freqs,
// positions_from_deltas, lz4_compress and lz4_decompress) without the
// CPython extension: callers pass buffers whose sizes they know, and the
// one output whose length is known only here (a compressed block) comes back
// malloc'd for the caller to copy and hand to diagon_free. The arithmetic is
// the original's, so the LZ4 blocks are byte for byte the JAX extension's.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#define DIAGON_API extern "C" __attribute__((visibility("default")))

namespace {

// ---- LZ4 block format, implemented from its public spec: sequences of
// [token][lit-ext*][literals][offset LE16][match-ext*], token =
// (lit_len<<4)|(match_len-4) with 15 -> 255-run extension bytes, matches are
// >= 4 bytes at offsets <= 65535, the final sequence is literals-only, the
// last 5 bytes are always literals, and the last match starts >= 12 bytes
// before the end. ----

constexpr size_t LZ4_MINMATCH = 4;

inline uint32_t lz4_load32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

inline uint32_t lz4_hash(uint32_t seq) {
    return (seq * 2654435761u) >> 16;  // 16-bit bucket
}

void lz4_emit_len(std::vector<uint8_t>& out, size_t rest) {
    for (; rest >= 255; rest -= 255) out.push_back(255);
    out.push_back(static_cast<uint8_t>(rest));
}

}  // namespace

// Every block's freq section, in segment posting order (fbits == 0 -> all
// 1s); out holds sum(count) entries. The read-path counterpart of
// pack_blocks: pos_start is the cumulative sum of these freqs.
DIAGON_API int diagon_decode_freqs(const int32_t* count, const int32_t* dbits,
                                   const int32_t* fbits, const int32_t* woff,
                                   int64_t nb, const uint32_t* packed,
                                   int32_t* freqs) {
    size_t e = 0;
    for (int64_t b = 0; b < nb; b++) {
        int c = count[b];
        int fb = fbits[b];
        if (fb == 0) {
            for (int i = 0; i < c; i++) freqs[e + i] = 1;
        } else {
            const uint32_t* fw =
                packed + woff[b] + ((int64_t(c) * dbits[b] + 31) >> 5);
            for (int i = 0; i < c; i++) {
                int64_t bitpos = int64_t(i) * fb;
                uint64_t w = fw[bitpos >> 5];
                int sh = static_cast<int>(bitpos & 31);
                uint64_t v = w >> sh;
                if (sh) v |= static_cast<uint64_t>(fw[(bitpos >> 5) + 1])
                             << (32 - sh);
                freqs[e + i] =
                    static_cast<int32_t>(v & ((uint64_t(1) << fb) - 1));
            }
        }
        e += static_cast<size_t>(c);
    }
    return 0;
}

// Absolute positions from per-entry u16 deltas split into a low and a high
// byte plane (the first of an entry is absolute). Returns 1, writing
// nothing past np, when the freqs ask for more than np positions.
DIAGON_API int diagon_positions_from_deltas(const uint8_t* lo,
                                            const uint8_t* hi, int64_t np,
                                            const int32_t* freqs, int64_t ne,
                                            int32_t* pos) {
    int64_t i = 0;
    for (int64_t e = 0; e < ne; e++) {
        if (freqs[e] > np - i) return 1;
        int32_t cur = 0;
        for (int32_t j = 0; j < freqs[e]; j++, i++) {
            int32_t d = static_cast<int32_t>(lo[i]) |
                        (static_cast<int32_t>(hi[i]) << 8);
            cur = (j == 0) ? d : cur + d;
            pos[i] = cur;
        }
    }
    return i == np ? 0 : 1;
}

// One raw LZ4 block of src[0:n], malloc'd into *out (*out_n bytes).
// Returns 1 if the output cannot be allocated.
DIAGON_API int diagon_lz4_compress(const uint8_t* src, int64_t n_,
                                   uint8_t** out_p, int64_t* out_n) {
    const size_t n = static_cast<size_t>(n_);
    std::vector<uint8_t> out;
    out.reserve(n + n / 128 + 16);
    std::vector<uint32_t> table(1u << 16, 0);  // position + 1; 0 = empty

    auto emit_seq = [&](size_t anchor, size_t ip, size_t mlen,
                        size_t offset) {
        const size_t lit = ip - anchor;
        const size_t mrest = mlen - LZ4_MINMATCH;
        out.push_back(static_cast<uint8_t>(
            (std::min<size_t>(lit, 15) << 4) | std::min<size_t>(mrest, 15)));
        if (lit >= 15) lz4_emit_len(out, lit - 15);
        out.insert(out.end(), src + anchor, src + anchor + lit);
        out.push_back(static_cast<uint8_t>(offset & 0xFF));
        out.push_back(static_cast<uint8_t>(offset >> 8));
        if (mrest >= 15) lz4_emit_len(out, mrest - 15);
    };

    size_t anchor = 0;
    if (n > 12) {
        const size_t mflimit = n - 12;   // last match starts before this
        const size_t matchlimit = n - 5; // last 5 bytes stay literal
        size_t ip = 0;
        while (ip < mflimit) {
            const uint32_t seq = lz4_load32(src + ip);
            const uint32_t h = lz4_hash(seq);
            const uint32_t cand = table[h];
            table[h] = static_cast<uint32_t>(ip + 1);
            if (cand != 0 && ip + 1 - cand <= 65535 &&
                lz4_load32(src + (cand - 1)) == seq) {
                size_t mpos = cand - 1;
                size_t mlen = LZ4_MINMATCH;
                while (ip + mlen < matchlimit &&
                       src[mpos + mlen] == src[ip + mlen])
                    mlen++;
                // fold preceding literals into the match where they agree
                while (ip > anchor && mpos > 0 &&
                       src[ip - 1] == src[mpos - 1]) {
                    ip--; mpos--; mlen++;
                }
                emit_seq(anchor, ip, mlen, ip - mpos);
                ip += mlen;
                anchor = ip;
            } else {
                ip++;
            }
        }
    }
    // final literals-only sequence (no offset follows, per the spec)
    const size_t lit = n - anchor;
    out.push_back(static_cast<uint8_t>(std::min<size_t>(lit, 15) << 4));
    if (lit >= 15) lz4_emit_len(out, lit - 15);
    out.insert(out.end(), src + anchor, src + n);

    uint8_t* buf = static_cast<uint8_t*>(std::malloc(out.size()));
    if (buf == nullptr) return 1;
    std::memcpy(buf, out.data(), out.size());
    *out_p = buf;
    *out_n = static_cast<int64_t>(out.size());
    return 0;
}

// Decode one raw LZ4 block of n bytes into exactly out_size bytes of dst.
// Returns 1 on a corrupt block (one that decodes to any other size).
DIAGON_API int diagon_lz4_decompress(const uint8_t* src, int64_t n_,
                                     uint8_t* dst, int64_t out_size) {
    const size_t n = static_cast<size_t>(n_);
    const size_t cap = static_cast<size_t>(out_size);
    size_t len = 0;  // bytes written to dst
    size_t ip = 0;
    bool ok = true;
    auto read_len = [&](size_t base) -> size_t {
        size_t l = base;
        if (base == 15) {
            uint8_t b;
            do {
                if (ip >= n) { ok = false; return l; }
                b = src[ip++];
                l += b;
            } while (b == 255);
        }
        return l;
    };
    while (ip < n && ok) {
        const uint8_t token = src[ip++];
        const size_t lit = read_len(token >> 4);
        if (!ok || ip + lit > n || len + lit > cap) { ok = false; break; }
        std::memcpy(dst + len, src + ip, lit);
        len += lit;
        ip += lit;
        if (ip >= n) break;  // literals-only final sequence
        if (ip + 2 > n) { ok = false; break; }
        const size_t offset = src[ip] | (static_cast<size_t>(src[ip + 1]) << 8);
        ip += 2;
        if (offset == 0 || offset > len) { ok = false; break; }
        const size_t mlen = read_len(token & 0x0F) + LZ4_MINMATCH;
        if (!ok || len + mlen > cap) { ok = false; break; }
        size_t from = len - offset;
        for (size_t i = 0; i < mlen; i++)  // overlap-safe byte copy
            dst[len + i] = dst[from + i];
        len += mlen;
    }
    return ok && len == cap ? 0 : 1;
}
