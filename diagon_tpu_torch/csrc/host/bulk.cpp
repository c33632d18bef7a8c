// Host C++ of the synthetic-corpus builder: token sampling, postings
// inversion and the posting-block packer, with a plain C interface for
// ctypes (diagon_tpu_torch/native.py builds it with the host compiler).
//
// Copied from diagon_tpu/native/_native.cpp (synth_tokens, invert_tokens,
// pack_blocks and the SplitMix64 / AliasTable helpers), without the CPython
// extension: callers pass buffers, and outputs whose length is known only
// here come back as malloc'd arrays that the caller copies and hands to
// diagon_free. The arithmetic is the original's, so the same seed gives the
// same token stream and the same packed bytes; built with -ffp-contract=off
// and without -march=native, so the stream does not depend on the host CPU.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#define DIAGON_API extern "C" __attribute__((visibility("default")))

namespace {

constexpr int kBlock = 128;

inline int bits_for(int64_t v) {
    if (v <= 0) return 1;
    int b = 0;
    while (v) { b++; v >>= 1; }
    return b;
}

struct SplitMix64 {
    uint64_t s;
    explicit SplitMix64(uint64_t seed) : s(seed) {}
    uint64_t next() {
        uint64_t z = (s += 0x9E3779B97F4A7C15ull);
        z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
        z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
        return z ^ (z >> 31);
    }
    double next_double() {  // uniform [0, 1)
        return static_cast<double>(next() >> 11) * 0x1.0p-53;
    }
    // uniform integer in [0, n) (n < 2^32; modulo bias negligible here)
    uint32_t next_below(uint32_t n) {
        return static_cast<uint32_t>(next() % n);
    }
};

// Walker alias table for O(1) categorical sampling from `probs`.
struct AliasTable {
    std::vector<double> prob;    // acceptance threshold per bucket
    std::vector<int32_t> alias;  // fallback bucket

    explicit AliasTable(const double* p, size_t n) : prob(n), alias(n) {
        std::vector<double> scaled(n);
        double sum = 0.0;
        for (size_t i = 0; i < n; i++) sum += p[i];
        std::vector<int32_t> small, large;
        small.reserve(n);
        large.reserve(n);
        for (size_t i = 0; i < n; i++) {
            scaled[i] = p[i] / sum * static_cast<double>(n);
            (scaled[i] < 1.0 ? small : large).push_back(
                static_cast<int32_t>(i));
        }
        while (!small.empty() && !large.empty()) {
            int32_t s = small.back(); small.pop_back();
            int32_t l = large.back(); large.pop_back();
            prob[s] = scaled[s];
            alias[s] = l;
            scaled[l] = (scaled[l] + scaled[s]) - 1.0;
            (scaled[l] < 1.0 ? small : large).push_back(l);
        }
        for (int32_t s : small) { prob[s] = 1.0; alias[s] = s; }
        for (int32_t l : large) { prob[l] = 1.0; alias[l] = l; }
    }

    int32_t sample(SplitMix64& rng, size_t n) const {
        uint32_t b = rng.next_below(static_cast<uint32_t>(n));
        return rng.next_double() < prob[b] ? static_cast<int32_t>(b)
                                           : alias[b];
    }
};

// A malloc'd copy of a vector's elements (nullptr-safe for empty vectors:
// malloc(0) may return nullptr, so allocate at least one element).
template <typename T>
T* to_malloc(const std::vector<T>& v) {
    T* out = static_cast<T*>(std::malloc((v.size() ? v.size() : 1) * sizeof(T)));
    if (out && !v.empty()) std::memcpy(out, v.data(), v.size() * sizeof(T));
    return out;
}

}  // namespace

DIAGON_API void diagon_free(void* p) { std::free(p); }

// Sample one field's token-id stream. len_kind 0: lognormal(mu=len_a,
// sigma=len_b) clamped to >= min_len; len_kind 1: uniform integer in
// [len_a, len_b). With probability phrase_prob a document gets 1-3
// occurrences of one phrase written at random offsets. Token ids are
// remapped through `remap` (rank space -> sorted-term space) when it is not
// null. Writes doc_len[num_docs]; returns the tokens through *tokens_out
// (malloc'd, *n_tokens_out of them). Returns 0, or 1 when out of memory.
DIAGON_API int diagon_synth_tokens(
        int64_t num_docs, uint64_t seed, const double* probs, int64_t V,
        int len_kind, double len_a, double len_b, int64_t min_len,
        const int32_t* pflat, const int32_t* pstart, int64_t n_phrases,
        double phrase_prob, const int32_t* remap, int32_t* doc_len,
        int32_t** tokens_out, int64_t* n_tokens_out) {
    AliasTable alias(probs, static_cast<size_t>(V));
    SplitMix64 rng(seed);
    std::vector<int32_t> tokens;
    double mean_est = len_kind == 0 ? std::exp(len_a + len_b * len_b / 2.0)
                                    : (len_a + len_b) / 2.0;
    tokens.reserve(static_cast<size_t>(num_docs * mean_est * 1.05) + 1024);

    for (int64_t d = 0; d < num_docs; d++) {
        long L;
        if (len_kind == 0) {
            // Box-Muller normal -> lognormal
            double u1 = rng.next_double(), u2 = rng.next_double();
            if (u1 < 1e-300) u1 = 1e-300;
            double z = std::sqrt(-2.0 * std::log(u1)) *
                       std::cos(6.283185307179586 * u2);
            L = static_cast<long>(std::exp(len_a + len_b * z));
        } else {
            L = static_cast<long>(len_a) +
                static_cast<long>(rng.next_below(
                    static_cast<uint32_t>(len_b - len_a)));
        }
        if (L < min_len) L = min_len;
        if (L > 60000) L = 60000;  // keep positions < 2^16 (disk format)
        doc_len[d] = static_cast<int32_t>(L);
        size_t base = tokens.size();
        tokens.resize(base + static_cast<size_t>(L));
        for (long j = 0; j < L; j++)
            tokens[base + static_cast<size_t>(j)] =
                alias.sample(rng, static_cast<size_t>(V));
        if (n_phrases > 0 && rng.next_double() < phrase_prob) {
            const int32_t pi = static_cast<int32_t>(
                rng.next_below(static_cast<uint32_t>(n_phrases)));
            int32_t ps = pstart[pi], pe = pstart[pi + 1];
            long plen = pe - ps;
            long n_occ = 1 + static_cast<long>(rng.next_below(3));
            for (long o = 0; o < n_occ; o++) {
                if (L > plen + 1) {
                    long off = static_cast<long>(rng.next_below(
                        static_cast<uint32_t>(L - plen)));
                    for (long j = 0; j < plen; j++)
                        tokens[base + static_cast<size_t>(off + j)] =
                            pflat[ps + j];
                }
            }
        }
    }
    if (remap)
        for (size_t i = 0; i < tokens.size(); i++)
            tokens[i] = remap[tokens[i]];
    *n_tokens_out = static_cast<int64_t>(tokens.size());
    *tokens_out = to_malloc(tokens);
    return *tokens_out ? 0 : 1;
}

// Counting sort of the doc-major token stream into term-major postings:
// histogram -> per-term regions -> scatter (doc, pos) -> per-region runs of
// (doc, freq). The scan is doc-major and position-major, so each term
// region comes out sorted by (doc, pos), and the scattered positions are
// the flat per-entry positions CSR (pos_start = cumsum(freqs)). Terms with
// no occurrence get empty ranges. Writes entry_start[V+1] and, when
// positions is not null, positions[T]; returns docs and freqs through
// *docs_out / *freqs_out (malloc'd, *ne_out of each). Returns 0, or 1 when
// out of memory.
DIAGON_API int diagon_invert_tokens(
        const int32_t* doc_len, int64_t N, const int32_t* tok, int64_t T,
        int64_t V, int32_t* positions, int64_t* entry_start,
        int32_t** docs_out, int32_t** freqs_out, int64_t* ne_out) {
    const bool with_positions = positions != nullptr;
    const size_t nv = static_cast<size_t>(V);
    // pass 1: histogram -> per-term token regions
    std::vector<int64_t> tok_off(nv + 1, 0);
    for (int64_t i = 0; i < T; i++) tok_off[tok[i] + 1]++;
    for (size_t v = 0; v < nv; v++) tok_off[v + 1] += tok_off[v];

    // pass 2: scatter (doc, pos) into term regions
    std::vector<int32_t> doc_sc(static_cast<size_t>(T));
    {
        std::vector<int64_t> cur(tok_off.begin(), tok_off.end() - 1);
        int64_t i = 0;
        for (int64_t d = 0; d < N; d++) {
            int32_t L = doc_len[d];
            for (int32_t p = 0; p < L; p++, i++) {
                int64_t slot = cur[tok[i]]++;
                doc_sc[static_cast<size_t>(slot)] = static_cast<int32_t>(d);
                if (with_positions) positions[slot] = p;
            }
        }
    }

    // pass 3: count (term, doc) entries per term
    entry_start[0] = 0;
    for (size_t v = 0; v < nv; v++) {
        int64_t ne = 0;
        int32_t prev = -1;
        for (int64_t j = tok_off[v]; j < tok_off[v + 1]; j++) {
            if (doc_sc[static_cast<size_t>(j)] != prev) {
                ne++;
                prev = doc_sc[static_cast<size_t>(j)];
            }
        }
        entry_start[v + 1] = entry_start[v] + ne;
    }
    const size_t NE = static_cast<size_t>(entry_start[nv]);

    // pass 4: emit (doc, freq) runs
    int32_t* docs = static_cast<int32_t*>(std::malloc((NE ? NE : 1) * 4));
    int32_t* freqs = static_cast<int32_t*>(std::malloc((NE ? NE : 1) * 4));
    if (!docs || !freqs) {
        std::free(docs);
        std::free(freqs);
        return 1;
    }
    size_t e = 0;
    for (size_t v = 0; v < nv; v++) {
        int32_t prev = -1;
        for (int64_t j = tok_off[v]; j < tok_off[v + 1]; j++) {
            int32_t d = doc_sc[static_cast<size_t>(j)];
            if (d != prev) {
                docs[e] = d;
                freqs[e] = 1;
                e++;
                prev = d;
            } else {
                freqs[e - 1]++;
            }
        }
    }
    *docs_out = docs;
    *freqs_out = freqs;
    *ne_out = static_cast<int64_t>(NE);
    return 0;
}

// The posting-block packer over CSR postings (T terms, NE entries; norms may
// be null, then every block's max norm is 127). The caller sizes the block
// arrays from entry_start: NB = sum over terms of ceil(df / 128). Writes
// block_start[T+1], doc_freq[T], total_tf[T], the eight per-block columns
// [NB] and block_entry_start[NB+1]; returns the packed word stream through
// *packed_out (malloc'd, *n_words_out words: the blocks' words, then
// max_window + 1 slack words of zero). Little-endian within u32 words,
// value i of a section at bit i*bits: codecs/bitpack.pack_u32's layout.
// Returns 0, or 1 when out of memory.
DIAGON_API int diagon_pack_blocks(
        const int64_t* entry_start, int64_t T, const int32_t* docs,
        const int32_t* freqs, int64_t NE, const uint8_t* norms,
        int32_t* block_start, int32_t* doc_freq, int64_t* total_tf,
        int32_t* b_term, int32_t* b_base, int32_t* b_count, int32_t* b_dbits,
        int32_t* b_fbits, int32_t* b_woff, int32_t* b_maxf, int32_t* b_maxn,
        int64_t* b_estart, uint32_t** packed_out, int64_t* n_words_out,
        int64_t* max_window_out) {
    size_t NB = 0;
    for (int64_t t = 0; t < T; t++) {
        block_start[t] = static_cast<int32_t>(NB);
        int64_t df = entry_start[t + 1] - entry_start[t];
        doc_freq[t] = static_cast<int32_t>(df);
        total_tf[t] = 0;
        NB += static_cast<size_t>((df + kBlock - 1) / kBlock);
    }
    block_start[T] = static_cast<int32_t>(NB);

    // pass 1: per-block metadata + word layout
    int64_t word_off = 0;
    int64_t max_window = 1;
    size_t nb_i = 0;
    for (int64_t t = 0; t < T; t++) {
        int64_t s = entry_start[t], e = entry_start[t + 1];
        for (int64_t bs = s; bs < e; bs += kBlock, nb_i++) {
            int64_t be = bs + kBlock < e ? bs + kBlock : e;
            int count = static_cast<int>(be - bs);
            int64_t max_delta = 0, max_freq = 0;
            int max_norm = norms ? 0 : 127;
            int64_t prev = docs[bs];
            int64_t tf = 0;
            for (int64_t j = bs; j < be; j++) {
                int64_t d = docs[j] - prev;
                prev = docs[j];
                if (j == bs) d = 0;
                if (d > max_delta) max_delta = d;
                if (freqs[j] > max_freq) max_freq = freqs[j];
                tf += freqs[j];
                if (norms) {
                    int n = norms[docs[j]];
                    if (n > max_norm) max_norm = n;
                }
            }
            total_tf[t] += tf;
            int dbits = bits_for(max_delta);
            // fbits == 0 encodes an all-freq-1 block: no freq section
            int fbits = (max_freq == 1) ? 0 : bits_for(max_freq);
            b_term[nb_i] = static_cast<int32_t>(t);
            b_base[nb_i] = docs[bs];
            b_count[nb_i] = count;
            b_dbits[nb_i] = dbits;
            b_fbits[nb_i] = fbits;
            b_woff[nb_i] = static_cast<int32_t>(word_off);
            b_maxf[nb_i] = static_cast<int32_t>(max_freq);
            b_maxn[nb_i] = max_norm;
            b_estart[nb_i] = bs;
            int64_t dwords = (int64_t(count) * dbits + 31) >> 5;
            int64_t fwords = (int64_t(count) * fbits + 31) >> 5;
            word_off += dwords + fwords;
            int64_t window = ((int64_t(kBlock) * dbits + 31) >> 5) +
                             ((int64_t(kBlock) * fbits + 31) >> 5);
            if (window > max_window) max_window = window;
        }
    }
    b_estart[NB] = NE;

    // pass 2: bit packing
    const size_t n_words = static_cast<size_t>(word_off + max_window + 1);
    uint32_t* packed = static_cast<uint32_t*>(std::calloc(n_words, 4));
    if (!packed) return 1;
    for (size_t b = 0; b < NB; b++) {
        int64_t bs = b_estart[b];
        int count = b_count[b];
        int dbits = b_dbits[b];
        int fbits = b_fbits[b];
        uint32_t* dw = packed + b_woff[b];
        int64_t prev = docs[bs];
        for (int i = 0; i < count; i++) {
            uint64_t v = 0;
            if (i > 0) v = static_cast<uint64_t>(docs[bs + i] - prev);
            prev = docs[bs + i];
            int64_t bitpos = int64_t(i) * dbits;
            dw[bitpos >> 5] |= static_cast<uint32_t>(v << (bitpos & 31));
            int sh = static_cast<int>(bitpos & 31);
            if (sh) dw[(bitpos >> 5) + 1] |=
                static_cast<uint32_t>(v >> (32 - sh));
        }
        if (fbits > 0) {
            uint32_t* fw = dw + ((int64_t(count) * dbits + 31) >> 5);
            for (int i = 0; i < count; i++) {
                uint64_t v = static_cast<uint64_t>(freqs[bs + i]);
                int64_t bitpos = int64_t(i) * fbits;
                fw[bitpos >> 5] |= static_cast<uint32_t>(v << (bitpos & 31));
                int sh = static_cast<int>(bitpos & 31);
                if (sh) fw[(bitpos >> 5) + 1] |=
                    static_cast<uint32_t>(v >> (32 - sh));
            }
        }
    }
    *packed_out = packed;
    *n_words_out = static_cast<int64_t>(n_words);
    *max_window_out = max_window;
    return 0;
}
