// The port's ingest tier: the ASCII standard tokenizer and the per-field
// postings accumulator (FreqProx), behind a plain C interface for ctypes.
//
// A copy of the JAX package's CPython extension (diagon_tpu/native/
// _native.cpp: tokenize_ascii_fast, standard_tokenize_ascii,
// TermPostings/TermStore and FreqProx's add_document, add_documents,
// add_keywords, finish, ram_bytes and num_terms), without the CPython API:
// a FreqProx is an opaque handle made by diagon_fp_new and released by
// diagon_fp_free; a batch of texts comes in as one byte blob plus int64
// offsets; outputs whose length is known only here come back as malloc'd
// arrays that the caller copies and hands to diagon_free (bulk.cpp). The
// tokens, the term order (memcmp, length breaking ties), the CSR arrays and
// the RAM accounting are the original's. Every entry point catches
// std::bad_alloc and returns 1 (or -1 where it returns a count).
//
// A handle is not thread-safe: the caller serialises every call on one
// handle (ctypes releases the interpreter lock during a call).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <string>
#include <utility>
#include <vector>

#define DIAGON_API extern "C" __attribute__((visibility("default")))

namespace {

inline bool is_alnum(unsigned char c) {
    return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
           (c >= '0' && c <= '9');
}
inline char lower(unsigned char c) {
    return (c >= 'A' && c <= 'Z') ? static_cast<char>(c + 32)
                                  : static_cast<char>(c);
}

inline uint64_t hash_token_bytes(const char* p, size_t n) {
    uint64_t h = 0x9E3779B97F4A7C15ull ^ n;
    size_t rem = n;
    while (rem >= 8) {
        uint64_t k;
        std::memcpy(&k, p, 8);
        h = (h ^ k) * 0x9DDFEA08EB382D69ull;
        h ^= h >> 29;
        p += 8;
        rem -= 8;
    }
    uint64_t k = 0;
    for (size_t i = 0; i < rem; i++)
        k = (k << 8) | static_cast<unsigned char>(p[i]);
    h = (h ^ k) * 0x9DDFEA08EB382D69ull;
    return h ^ (h >> 32);
}

// 256-entry character classes + lowercase table: one load per byte.
struct CharTables {
    unsigned char cls[256];  // 0 = separator, 1 = alnum, 2 = '
    char low[256];
    CharTables() {
        for (int c = 0; c < 256; c++) {
            unsigned char u = static_cast<unsigned char>(c);
            cls[c] = is_alnum(u) ? 1 : (u == '\'' ? 2 : 0);
            low[c] = lower(u);
        }
    }
};
const CharTables kTables;

// Tokenize ASCII text: a token starts at an alnum, continues over
// alnum + '\'', and is lowercased. Each token is lowercased into a stack
// buffer and hashed in the same pass (the same hash as hash_token_bytes);
// calls fn(lowered_bytes, len, hash). Tokens longer than the stack buffer
// go through the std::string path. (The JAX extension keeps a second,
// string-building copy of this scan for standard_tokenize_ascii; its
// tokens are these.)
template <typename Fn>
void tokenize_ascii_fast(const char* data, int64_t len, std::string& scratch,
                         Fn&& fn) {
    constexpr int64_t kBuf = 256;
    char buf[kBuf];
    int64_t i = 0;
    while (i < len) {
        if (kTables.cls[static_cast<unsigned char>(data[i])] != 1) {
            i++;
            continue;
        }
        int64_t start = i;
        i++;
        while (i < len && kTables.cls[static_cast<unsigned char>(data[i])])
            i++;
        int64_t n = i - start;
        if (n <= kBuf) {
            uint64_t h = 0x9E3779B97F4A7C15ull ^ static_cast<uint64_t>(n);
            int64_t j = start, w = 0;
            while (j + 8 <= i) {
                uint64_t k = 0;
                for (int b = 0; b < 8; b++)
                    buf[w + b] =
                        kTables.low[static_cast<unsigned char>(data[j + b])];
                std::memcpy(&k, buf + w, 8);
                h = (h ^ k) * 0x9DDFEA08EB382D69ull;
                h ^= h >> 29;
                j += 8;
                w += 8;
            }
            uint64_t k = 0;
            for (; j < i; j++, w++) {
                buf[w] = kTables.low[static_cast<unsigned char>(data[j])];
                k = (k << 8) | static_cast<unsigned char>(buf[w]);
            }
            h = (h ^ k) * 0x9DDFEA08EB382D69ull;
            fn(buf, static_cast<size_t>(n), h ^ (h >> 32));
        } else {
            scratch.clear();
            for (int64_t j = start; j < i; j++)
                scratch.push_back(
                    kTables.low[static_cast<unsigned char>(data[j])]);
            fn(scratch.data(), scratch.size(),
               hash_token_bytes(scratch.data(), scratch.size()));
        }
    }
}

struct TermPostings {
    std::vector<int32_t> docs;
    std::vector<int32_t> freqs;
};

// Open-addressing term table: slots hold (hash, idx+1); term bytes live in
// one arena; postings in a parallel vector indexed by term id. Each term's
// newest (doc, freq) entry stays pending in one packed word,
// (doc+1) << 32 | freq, until the next doc or finish; positions are one
// sequential (term << 32 | pos) stream distributed into CSR at finish.
struct TermStore {
    std::vector<uint64_t> slot_hash;
    std::vector<uint32_t> slot_idx;  // 0 = empty, else term idx + 1
    std::string arena;
    std::vector<uint64_t> offs;  // [T+1] arena offsets
    std::vector<TermPostings> posts;
    std::vector<uint64_t> pos_stream;
    std::vector<uint64_t> pending;
    size_t mask;

    TermStore() : slot_hash(1u << 12, 0), slot_idx(1u << 12, 0),
                  offs(1, 0), mask((1u << 12) - 1) {}

    void flush_entry(uint32_t idx) {
        TermPostings& tp = posts[idx];
        uint64_t e = pending[idx];
        tp.docs.push_back(static_cast<int32_t>((e >> 32) - 1));
        tp.freqs.push_back(static_cast<int32_t>(e & 0xffffffffu));
        pending[idx] = 0;
    }

    size_t size() const { return posts.size(); }

    void grow() {
        size_t cap = (mask + 1) * 2;
        std::vector<uint64_t> nh(cap, 0);
        std::vector<uint32_t> ni(cap, 0);
        size_t nm = cap - 1;
        for (size_t s = 0; s <= mask; s++) {
            if (!slot_idx[s]) continue;
            size_t d = slot_hash[s] & nm;
            while (ni[d]) d = (d + 1) & nm;
            nh[d] = slot_hash[s];
            ni[d] = slot_idx[s];
        }
        slot_hash.swap(nh);
        slot_idx.swap(ni);
        mask = nm;
    }

    uint32_t find_or_insert_h(const char* p, size_t n, uint64_t h,
                              int64_t* ram_bytes) {
        if ((size() + 1) * 10 >= (mask + 1) * 7) grow();  // 0.7 load max
        size_t s = h & mask;
        while (slot_idx[s]) {
            if (slot_hash[s] == h) {
                uint32_t idx = slot_idx[s] - 1;
                uint64_t o = offs[idx];
                if (offs[idx + 1] - o == n &&
                    std::memcmp(arena.data() + o, p, n) == 0)
                    return idx;
            }
            s = (s + 1) & mask;
        }
        uint32_t idx = static_cast<uint32_t>(size());
        slot_hash[s] = h;
        slot_idx[s] = idx + 1;
        arena.append(p, n);
        offs.push_back(arena.size());
        posts.emplace_back();
        pending.push_back(0);
        *ram_bytes += 64 + static_cast<int64_t>(n);
        return idx;
    }

    // one occurrence of term idx in doc_id
    void add(uint32_t idx, int32_t doc_id) {
        uint64_t e = pending[idx];
        if ((e >> 32) == static_cast<uint64_t>(doc_id) + 1) {
            pending[idx] = e + 1;
        } else {
            if (e) flush_entry(idx);
            pending[idx] = ((static_cast<uint64_t>(doc_id) + 1) << 32) | 1u;
        }
    }
};

struct FreqProx {
    TermStore terms;
    std::vector<std::pair<int32_t, int32_t>> field_lengths;  // (doc, len)
    int64_t sum_total_tf = 0;
    int64_t ram_bytes = 0;

    // tokenize + accumulate one document's text; its token count
    int32_t add_text(int32_t doc_id, const char* data, int64_t len,
                     bool with_positions, std::string& tok) {
        int32_t pos = 0;
        tokenize_ascii_fast(data, len, tok, [&](const char* tp, size_t tn,
                                                uint64_t th) {
            uint32_t idx = terms.find_or_insert_h(tp, tn, th, &ram_bytes);
            terms.add(idx, doc_id);
            if (with_positions)
                terms.pos_stream.push_back(
                    (static_cast<uint64_t>(idx) << 32) |
                    static_cast<uint32_t>(pos));
            ram_bytes += 12;
            pos++;
        });
        sum_total_tf += pos;
        if (pos > 0) field_lengths.emplace_back(doc_id, pos);
        return pos;
    }
};

template <typename T>
T* to_malloc(const std::vector<T>& v) {
    T* out =
        static_cast<T*>(std::malloc((v.size() ? v.size() : 1) * sizeof(T)));
    if (out && !v.empty()) std::memcpy(out, v.data(), v.size() * sizeof(T));
    return out;
}

}  // namespace

// standard_tokenize_ascii: the tokens of `text` as one blob of their bytes
// (*blob_out) and int64 offsets [n+1] (*offs_out), both malloc'd.
DIAGON_API int diagon_tokenize_ascii(const char* text, int64_t len,
                                     char** blob_out, int64_t** offs_out,
                                     int64_t* n_out) {
    try {
        std::vector<char> blob;
        std::vector<int64_t> offs(1, 0);
        std::string tok;
        tokenize_ascii_fast(text, len, tok,
                            [&](const char* t, size_t n, uint64_t) {
            blob.insert(blob.end(), t, t + n);
            offs.push_back(static_cast<int64_t>(blob.size()));
        });
        char* b = to_malloc(blob);
        int64_t* o = to_malloc(offs);
        if (!b || !o) {
            std::free(b);
            std::free(o);
            return 1;
        }
        *blob_out = b;
        *offs_out = o;
        *n_out = static_cast<int64_t>(offs.size()) - 1;
        return 0;
    } catch (const std::bad_alloc&) {
        return 1;
    }
}

DIAGON_API void* diagon_fp_new() {
    return new (std::nothrow) FreqProx();
}

DIAGON_API void diagon_fp_free(void* h) { delete static_cast<FreqProx*>(h); }

// add_documents: texts k = 0..n-1 are blob[offs[k]:offs[k+1]] and become doc
// doc_id0 + k; counts[k] gets each one's token count.
DIAGON_API int diagon_fp_add_documents(void* h, int32_t doc_id0,
                                       const char* blob, const int64_t* offs,
                                       int64_t n, int with_positions,
                                       int32_t* counts) {
    try {
        FreqProx& fp = *static_cast<FreqProx*>(h);
        std::string tok;
        for (int64_t k = 0; k < n; k++)
            counts[k] = fp.add_text(doc_id0 + static_cast<int32_t>(k),
                                    blob + offs[k], offs[k + 1] - offs[k],
                                    with_positions != 0, tok);
        return 0;
    } catch (const std::bad_alloc&) {
        return 1;
    }
}

// add_keywords: value k (blob[offs[k]:offs[k+1]], UTF-8) is one
// case-sensitive term of doc doc_id0 + k, with no positions; an empty value
// means the doc lacks the field. Returns the number of docs with the field,
// or -1 when out of memory.
DIAGON_API int64_t diagon_fp_add_keywords(void* h, int32_t doc_id0,
                                          const char* blob,
                                          const int64_t* offs, int64_t n) {
    try {
        FreqProx& fp = *static_cast<FreqProx*>(h);
        int64_t with_field = 0;
        for (int64_t k = 0; k < n; k++) {
            const char* data = blob + offs[k];
            size_t len = static_cast<size_t>(offs[k + 1] - offs[k]);
            if (len == 0) continue;
            int32_t doc_id = doc_id0 + static_cast<int32_t>(k);
            uint32_t idx = fp.terms.find_or_insert_h(
                data, len, hash_token_bytes(data, len), &fp.ram_bytes);
            fp.terms.add(idx, doc_id);
            fp.ram_bytes += 12;
            fp.sum_total_tf += 1;
            with_field++;
            fp.field_lengths.emplace_back(doc_id, 1);
        }
        return with_field;
    } catch (const std::bad_alloc&) {
        return -1;
    }
}

DIAGON_API int64_t diagon_fp_ram_bytes(void* h) {
    return static_cast<FreqProx*>(h)->ram_bytes;
}

DIAGON_API int64_t diagon_fp_num_terms(void* h) {
    return static_cast<int64_t>(static_cast<FreqProx*>(h)->terms.size());
}

// finish: the accumulated postings as CSR, terms sorted by memcmp with the
// shorter first on a tie; every output malloc'd:
//   term blob (*blob, *blob_len bytes) and offsets int64 [T+1];
//   entry_start int64 [T+1] into docs/freqs int32 [NE];
//   pos_start int64 [NE+1] into positions int32 [NP] (with_positions;
//     else NP = 0 and pos_start is one unused element);
//   field_docs/field_lens int32 [ND]: the docs with the field, their
//     token counts.
DIAGON_API int diagon_fp_finish(
        void* h, int with_positions, char** blob_out, int64_t* blob_len,
        int64_t** toffs_out, int64_t* T_out, int64_t** estart_out,
        int32_t** docs_out, int32_t** freqs_out, int64_t* ne_out,
        int64_t** pstart_out, int32_t** pos_out, int64_t* np_out,
        int32_t** fdocs_out, int32_t** flens_out, int64_t* nd_out) {
    try {
        FreqProx& fp = *static_cast<FreqProx*>(h);
        TermStore& terms = fp.terms;
        size_t T = terms.size();
        for (size_t t = 0; t < T; t++)  // flush deferred tail entries
            if (terms.pending[t]) terms.flush_entry(static_cast<uint32_t>(t));
        const char* ar = terms.arena.data();
        std::vector<uint32_t> order(T);
        for (size_t i = 0; i < T; i++) order[i] = static_cast<uint32_t>(i);
        std::sort(order.begin(), order.end(), [&](uint32_t a, uint32_t b) {
            size_t la = terms.offs[a + 1] - terms.offs[a];
            size_t lb = terms.offs[b + 1] - terms.offs[b];
            int c = std::memcmp(ar + terms.offs[a], ar + terms.offs[b],
                                la < lb ? la : lb);
            return c < 0 || (c == 0 && la < lb);
        });

        std::vector<char> term_blob;
        term_blob.reserve(terms.arena.size());
        std::vector<int64_t> term_offsets(T + 1, 0), entry_start(T + 1, 0);
        size_t total_entries = 0;
        for (size_t t = 0; t < T; t++)
            total_entries += terms.posts[t].docs.size();
        std::vector<int32_t> docs(total_entries), freqs(total_entries);
        std::vector<int64_t> pos_start;
        std::vector<int32_t> positions;
        std::vector<uint64_t> pos_cursor;  // per original term id
        if (with_positions) {
            pos_start.resize(total_entries + 1);
            positions.resize(terms.pos_stream.size());
            pos_cursor.assign(T, 0);
        }

        size_t e = 0, p = 0;
        for (size_t t = 0; t < T; t++) {
            uint32_t id = order[t];
            term_offsets[t] = static_cast<int64_t>(term_blob.size());
            term_blob.insert(term_blob.end(), ar + terms.offs[id],
                             ar + terms.offs[id + 1]);
            entry_start[t] = static_cast<int64_t>(e);
            const TermPostings& tp = terms.posts[id];
            std::copy(tp.docs.begin(), tp.docs.end(), docs.begin() + e);
            std::copy(tp.freqs.begin(), tp.freqs.end(), freqs.begin() + e);
            if (with_positions) {
                // pos_start is the running freqs cumsum; the stream then
                // lands each term's positions contiguously, (doc, pos)
                // ascending
                pos_cursor[id] = p;
                for (size_t j = 0; j < tp.docs.size(); j++) {
                    pos_start[e + j] = static_cast<int64_t>(p);
                    p += static_cast<size_t>(tp.freqs[j]);
                }
            }
            e += tp.docs.size();
        }
        term_offsets[T] = static_cast<int64_t>(term_blob.size());
        entry_start[T] = static_cast<int64_t>(e);
        if (with_positions) {
            pos_start[total_entries] = static_cast<int64_t>(p);
            for (uint64_t s : terms.pos_stream)
                positions[pos_cursor[s >> 32]++] =
                    static_cast<int32_t>(s & 0xffffffffu);
        }
        std::vector<int32_t> fdocs(fp.field_lengths.size());
        std::vector<int32_t> flens(fp.field_lengths.size());
        for (size_t i = 0; i < fp.field_lengths.size(); i++) {
            fdocs[i] = fp.field_lengths[i].first;
            flens[i] = fp.field_lengths[i].second;
        }

        void* out[9] = {to_malloc(term_blob), to_malloc(term_offsets),
                        to_malloc(entry_start), to_malloc(docs),
                        to_malloc(freqs), to_malloc(pos_start),
                        to_malloc(positions), to_malloc(fdocs),
                        to_malloc(flens)};
        for (void* o : out) {
            if (o) continue;
            for (void* f : out) std::free(f);
            return 1;
        }
        *blob_out = static_cast<char*>(out[0]);
        *blob_len = static_cast<int64_t>(term_blob.size());
        *toffs_out = static_cast<int64_t*>(out[1]);
        *T_out = static_cast<int64_t>(T);
        *estart_out = static_cast<int64_t*>(out[2]);
        *docs_out = static_cast<int32_t*>(out[3]);
        *freqs_out = static_cast<int32_t*>(out[4]);
        *ne_out = static_cast<int64_t>(total_entries);
        *pstart_out = static_cast<int64_t*>(out[5]);
        *pos_out = static_cast<int32_t*>(out[6]);
        *np_out = static_cast<int64_t>(positions.size());
        *fdocs_out = static_cast<int32_t*>(out[7]);
        *flens_out = static_cast<int32_t*>(out[8]);
        *nd_out = static_cast<int64_t>(fdocs.size());
        return 0;
    } catch (const std::bad_alloc&) {
        return 1;
    }
}
