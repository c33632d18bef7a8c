// The block-at-a-time engine's scorer for Hopper (sm_90a): X2.
//
// Replaces diagon_tpu/search/engine.py: score_and_topk (:205) and
// count_matches (:309), over diagon_tpu/ops/bitpack_ops.py:
// decode_doc_blocks (:74). Those are jitted XLA programs with no Pallas
// body, as X1 is for the columnar engine.
//
// What it computes. A plan (ops/block_score.py) is B entries per query:
// blocks[q, p] a posting block of the field (-1 padding), with its
// clause's weight, req, sho and neg values. Each block's 128 lanes decode
// from the shared u32 word stream (doc deltas at doc_bits from the block's
// word offset, freqs at freq_bits from the next whole word after them,
// freq_bits 0 meaning freq 1; the window of window_words words clipped to
// the stream, as gather_windows and unpack_lanes clip). For every valid
// lane (lane < count) of doc d:
//
//   contrib  = weight * tf_lut[norms[d] * F + min(max(freq, 0), F - 1)]
//   score[d] += contrib;  req[d] += req;  sho[d] += sho;  neg[d] += neg
//
// then per doc mask = req == num_required && sho >= min_should && neg == 0
// && req + sho > 0 && live[d] > 0, final[d] = mask ? score : -1, and
// hits[q] = the count of the mask. The score form writes no final row: each
// tile writes its first min(k, n) docs in lax.top_k's order (final
// descending, -0.0 tying +0.0, then docid ascending) as candidates
// [Q, tiles, min(k, tile)]; the wrapper's exact_topk over the candidates
// gives the row's top k (a doc of the row's top k is among its own tile's
// top k in the same total order). The count form writes only hits.
//
// Exactness. A doc's score must be ((0 + c1) + c2) + ... in plan order,
// the order in which XLA's CPU scatter and the oracle add. So no float
// atomics: they fix no order. A run of the plan (one clause: consecutive
// entries holding every block of one term, in order) holds each doc at
// most once, because a term's postings strictly ascend. The plan gives its
// runs (run_end[q, r]; 0 after the last run: build_segment_plan). Each
// block owns a tile of n <= 2048 docs of one query, held in shared memory
// (a float4 a doc: score, req, sho, neg), and adds the runs in plan order
// with a barrier between runs that reach the tile; inside a run its warps
// take the run's blocks with plain shared-memory stores, since no two
// lanes of a run meet on a doc. Adds use __fadd_rn / __fmul_rn, and the
// build has --fmad=false.
//
// Bound: bytes. Each valid block's own words and metadata, the plan, the
// tf table once, a norm and a live value a doc reached, and the candidates
// written, over HBM (chip_smoke.py x2_bound). The design, against what
// held the first tile form back (a serial chain of two binary searches
// and a barrier a run, two global reads a decoded value, a full [Q, D]
// row written and sorted after):
// - prologue: eight lanes a run find the run's blocks that reach the tile
//   (log8 loads deep, not two log2 searches a run), while the tile's norms
//   and live flags are staged, a byte a doc, with coalesced 16-byte loads
//   (the tf table stays on __ldg: staging its first 8 freqs of each norm
//   in shared memory measured no faster, 16 of them cost a block a SM);
// - a term's blocks are consecutive in the word stream, so a run's blocks
//   that reach a tile are one word range: thread 0 packs the runs' ranges
//   into batches of two shared-memory slots, and cp.async copies batch
//   b + 2 (words, block headers and plan entries) while batch b is added;
//   every value then decodes from shared memory, and a doc's four sums are
//   one 16-byte read and write. A block whose words lie outside its staged
//   range (a stream not laid out so, or a range above a slot) decodes from
//   global memory with the old clamps, so any input gives the same bits;
// - 48 KB of shared memory and at most 64 registers a thread at 2,048-doc
//   tiles: four blocks a SM, so a 1M-doc query's 490 tiles run at once;
// - epilogue: the mask, the hit count and the tile's top min(k, n): for
//   k <= kFastK each warp takes its top k by k rounds of a warp max over
//   (score, docid) keys, warp 0 merges the eight lists; above that a
//   bitonic sort of the tile's keys in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 2048;  // docs a block owns
constexpr int kKeys = kMaxTile / kThreads;  // keys a thread holds
constexpr int kMinBlocks = 4;  // blocks a SM: at most 64 registers
constexpr int kSearchLanes = 8;  // lanes that search one run together
constexpr int kRunsWin = kThreads / kSearchLanes;  // runs a prologue pass
constexpr int kSlotWords = 1024;  // words a staging slot holds (4 KB)
constexpr int kSlotBlocks = 64;  // block headers a staging slot holds
constexpr int kFastK = 32;  // k up to this: warp selection, else a sort
// per-run fields of a prologue pass, each [kRunsWin] ints
enum { kFirst, kPFirst, kNBlk, kWStart, kWEnd, kSOff, kBOff, kRunFields };
// block header and plan entry columns staged beside the words
enum { kBase, kCount, kDBits, kFBits, kWOff, kWeight, kReq, kSho, kNeg,
       kHeaderCols };

static_assert(2 * kSlotWords >= kMaxTile,
              "the slots hold the epilogue's final scores");

struct X2Args {
  const uint32_t* packed;
  const int* block_base;
  const int* block_count;
  const int* block_doc_bits;
  const int* block_freq_bits;
  const int* block_word_off;
  const int* norms;
  const float* tf_lut;
  const float* live;
  const int* blocks;
  const float* weight;
  const float* req;
  const float* sho;
  const float* neg;
  const float* bool_params;
  const int* run_end;
  float* cand_score;  // [Q, tiles, kk]; null in the count form
  int* cand_doc;
  int* hits;
  int64_t n_words;
  int D, B, F, ww, tile, tiles, kk;
  int vec_tile;  // norms and live 16-byte aligned, tile % 4 == 0
  int vec_words;  // packed 16-byte aligned
};

// Byte offsets of the dynamic shared memory, each 16-byte aligned. The
// epilogue's final scores take the slots, its keys the sums.
struct Layout {
  int acc, doc8, words, header, runs, batch, total;
};

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

__host__ __device__ inline Layout layout(int tile, bool score) {
  const int keys = kWarps * kFastK * 8;  // topk_warps' lists
  Layout L;
  L.acc = 0;
  L.doc8 = tile * 16 > keys ? tile * 16 : keys;
  L.words = L.doc8 + align16(tile);
  L.header = L.words + 2 * kSlotWords * 4;
  L.runs = L.header + 2 * kHeaderCols * kSlotBlocks * 4;
  L.batch = L.runs + kRunFields * kRunsWin * 4;
  L.total = L.batch + align16((kRunsWin + 1) * 4);
  return L;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Words of a block's doc and freq sections (the packer's layout).
__host__ __device__ __forceinline__ int64_t block_words(int cnt, int db,
                                                        int fb) {
  const int64_t c = cnt > 0 ? cnt : 0;
  return ((c * db + 31) >> 5) + ((c * fb + 31) >> 5);
}

// Word x of a block's window in global memory: the window is clipped to
// its last word, the stream to its ends (gather_windows, unpack_lanes).
struct GlobalWords {
  const uint32_t* packed;
  int64_t n_words;
  int word_off, ww;
  __device__ __forceinline__ uint32_t operator()(int x) const {
    x = min(x, ww - 1);
    int64_t i = (int64_t)word_off + x;
    i = i < 0 ? 0 : (i >= n_words ? n_words - 1 : i);
    return __ldg(packed + i);
  }
};

// Word x of a block staged in shared memory. A valid lane's bits lie in
// the block's sections, and a value's second word past them is masked
// off (whatever the word after a staged range holds: the next slot's, or
// the headers'), so this gives GlobalWords' values for every valid lane of
// a block whose sections fit its window.
struct SharedWords {
  const uint32_t* w;
  __device__ __forceinline__ uint32_t operator()(int x) const {
    return w[x];
  }
};

// Lane ``i`` of a section at ``bits`` starting at window word
// ``word_base`` (u32 arithmetic, as the JAX decode).
template <class Words>
__device__ __forceinline__ uint32_t lane_value(const Words& words,
                                               uint32_t bits,
                                               uint32_t word_base,
                                               uint32_t i) {
  const uint32_t bitpos = word_base * 32u + i * bits;
  const int widx = (int)(bitpos >> 5);
  const uint32_t mask = bits ? (0xFFFFFFFFu >> (32u - bits)) : 0u;
  // (w1:w0) >> shift: w0 alone where the shift is 0
  return __funnelshift_r(words(widx), words(widx + 1), bitpos & 31u) & mask;
}

// First j in [0, n) with base[j] > x (kUpper) or base[j] >= x (n if
// none), found by the kSearchLanes lanes of a group together: each step
// probes kSearchLanes evenly spaced entries, one load deep, so the search
// is log8(n) loads deep, not log2(n). Every lane of the warp calls it (a
// group with nothing to find passes n = 0).
template <bool kUpper>
__device__ __forceinline__ int group_bound(const int* base, int n, int x,
                                           int lane) {
  const int g = lane & (kSearchLanes - 1);
  const int shift = lane & ~(kSearchLanes - 1);
  int lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (__any_sync(0xFFFFFFFFu, lo < hi)) {
    const int step = (hi - lo + kSearchLanes - 1) / kSearchLanes;
    const int p = lo + (g + 1) * step - 1;  // past hi: true
    bool pred = true;
    if (lo < hi && p < hi) {
      const int v = __ldg(base + p);
      pred = kUpper ? v > x : v >= x;
    }
    const unsigned bal =
        (__ballot_sync(0xFFFFFFFFu, pred) >> shift) & 0xFFu;
    if (lo < hi) {
      if (bal == 0) {
        lo = hi;  // the last probe was hi - 1, and false
      } else {
        const int f = __ffs(bal) - 1;
        const int pf = lo + (f + 1) * step - 1;
        lo = lo + f * step;
        hi = min(pf, hi);
      }
    }
  }
  return lo;
}

struct Tile {
  float4* acc;  // [n]: score, req, sho, neg
  const uint8_t* doc8;  // [n]: norm (7 bits) | live << 7
  int d0, n;
};

// A warp adds the lanes of one block whose docs fall in the tile, with its
// plan entry's weight and flags. Lane L decodes values 4L..4L+3; docids are
// the block base plus a warp prefix sum of the deltas (u32 adds: the JAX
// int32 cumsum; a lane past the count adds 0, which changes no valid lane).
template <bool kScore, class Words>
__device__ __forceinline__ void add_block(const X2Args& a, const Tile& t,
                                          const Words& words, int base,
                                          int cnt, int db, int fb, float w,
                                          float rq, float sh, float ng,
                                          int lane) {
  uint32_t incl[4], sum = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = 4 * lane + e;
    sum += i < cnt ? lane_value(words, (uint32_t)db, 0u, (uint32_t)i) : 0u;
    incl[e] = sum;
  }
  uint32_t x = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, x, off);
    if (lane >= off) x += y;
  }
  const uint32_t excl = x - sum;
  const uint32_t dwords = (uint32_t)((cnt * db + 31) >> 5);
  int d[4];
  float c[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = 4 * lane + e;
    const int doc = (int)((uint32_t)base + excl + incl[e]);
    d[e] = (i < cnt && doc >= t.d0 && doc < t.d0 + t.n) ? doc - t.d0 : -1;
    c[e] = 0.f;
    if (kScore) {
      // no branch: a lane outside the tile reads lane 0's freq and doc 0's
      // norm (both there), so the four tf loads issue together; its
      // contribution is never added
      const bool in = d[e] >= 0;
      int freq = fb ? (int)lane_value(words, (uint32_t)fb, dwords,
                                      in ? (uint32_t)i : 0u)
                    : 1;
      freq = min(max(freq, 0), a.F - 1);
      const int norm = t.doc8[in ? d[e] : 0] & 127;
      c[e] = __fmul_rn(w, __ldg(a.tf_lut + norm * a.F + freq));
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (d[e] < 0) continue;
    float4 v = t.acc[d[e]];
    if (kScore) v.x = __fadd_rn(v.x, c[e]);
    v.y = __fadd_rn(v.y, rq);
    v.z = __fadd_rn(v.z, sh);
    v.w = __fadd_rn(v.w, ng);
    t.acc[d[e]] = v;
  }
}

// Copies batch b's word ranges, block headers and plan entries into slot
// b & 1 (a warp a run, 16 bytes a lane), then commits a group (an empty
// one past the last batch, so every thread's groups count alike).
__device__ void stage_batch(const X2Args& a, int64_t qb, int b, int nbatch,
                            const int* s_batch, const int* s_run,
                            uint32_t* s_words, int* s_header, int warp,
                            int lane) {
  if (b < nbatch) {
    uint32_t* w = s_words + (b & 1) * kSlotWords;
    int* h = s_header + (b & 1) * kHeaderCols * kSlotBlocks;
    for (int i = s_batch[b] + warp; i < s_batch[b + 1]; i += kWarps) {
      const int soff = s_run[kSOff * kRunsWin + i];
      if (soff < 0) continue;
      const int ws = s_run[kWStart * kRunsWin + i];
      const int we = s_run[kWEnd * kRunsWin + i];
      const int a0 = ws & ~3, chunks = (((we + 3) & ~3) - a0) >> 2;
      uint32_t* dst = w + soff - (ws - a0);  // 16-byte aligned
      for (int c = lane; c < chunks; c += 32) {
        const int64_t g = (int64_t)a0 + 4 * c;
        if (a.vec_words && g + 4 <= a.n_words) {
          cp_async16(dst + 4 * c, a.packed + g);
        } else {
          for (int e = 0; e < 4; ++e)
            if (g + e < a.n_words) cp_async4(dst + 4 * c + e, a.packed + g + e);
        }
      }
      const int first = s_run[kFirst * kRunsWin + i];
      const int64_t p = qb + s_run[kPFirst * kRunsWin + i];
      const int nblk = s_run[kNBlk * kRunsWin + i];
      const int boff = s_run[kBOff * kRunsWin + i];
      const void* cols[kHeaderCols] = {
          a.block_base + first, a.block_count + first,
          a.block_doc_bits + first, a.block_freq_bits + first,
          a.block_word_off + first, a.weight + p, a.req + p, a.sho + p,
          a.neg + p};
      for (int j = lane; j < nblk; j += 32) {
#pragma unroll
        for (int c = 0; c < kHeaderCols; ++c)
          cp_async4(h + c * kSlotBlocks + boff + j,
                    (const int*)cols[c] + j);
      }
    }
  }
  cp_async_commit();
}

// Adds run i (its blocks that reach the tile) from batch slot ``slot``, or
// from global memory where the run was not staged.
template <bool kScore>
__device__ __forceinline__ void add_run(const X2Args& a, const Tile& t,
                                        int64_t qb, int i, const int* s_run,
                                        const uint32_t* slot_words,
                                        const int* slot_header, int warp,
                                        int lane) {
  const int nblk = s_run[kNBlk * kRunsWin + i];
  const int soff = s_run[kSOff * kRunsWin + i];
  const int ws = s_run[kWStart * kRunsWin + i];
  const int we = s_run[kWEnd * kRunsWin + i];
  for (int j = warp; j < nblk; j += kWarps) {
    int base, cnt, db, fb, wo;
    float w, rq, sh, ng;
    if (soff >= 0) {
      const int* h = slot_header + s_run[kBOff * kRunsWin + i] + j;
      base = h[kBase * kSlotBlocks];
      cnt = h[kCount * kSlotBlocks];
      db = h[kDBits * kSlotBlocks];
      fb = h[kFBits * kSlotBlocks];
      wo = h[kWOff * kSlotBlocks];
      w = __int_as_float(h[kWeight * kSlotBlocks]);
      rq = __int_as_float(h[kReq * kSlotBlocks]);
      sh = __int_as_float(h[kSho * kSlotBlocks]);
      ng = __int_as_float(h[kNeg * kSlotBlocks]);
    } else {
      const int b = s_run[kFirst * kRunsWin + i] + j;
      const int64_t p = qb + s_run[kPFirst * kRunsWin + i] + j;
      base = __ldg(a.block_base + b);
      cnt = __ldg(a.block_count + b);
      db = __ldg(a.block_doc_bits + b);
      fb = __ldg(a.block_freq_bits + b);
      wo = __ldg(a.block_word_off + b);
      w = __ldg(a.weight + p);
      rq = __ldg(a.req + p);
      sh = __ldg(a.sho + p);
      ng = __ldg(a.neg + p);
    }
    if (cnt <= 0) continue;
    const int64_t nw = block_words(cnt, db, fb);
    if (soff >= 0 && wo >= ws && wo + nw <= we && nw <= a.ww) {
      const SharedWords words{slot_words + soff + (wo - ws)};
      add_block<kScore>(a, t, words, base, cnt, db, fb, w, rq, sh, ng, lane);
    } else {
      const GlobalWords words{a.packed, a.n_words, wo, a.ww};
      add_block<kScore>(a, t, words, base, cnt, db, fb, w, rq, sh, ng, lane);
    }
  }
}

// (final, docid) -> a key whose u64 order is lax.top_k's: final
// descending (-0.0 tying +0.0), then docid ascending.
__device__ __forceinline__ uint64_t topk_key(float f, int doc) {
  uint32_t u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0u;
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((uint64_t)u << 32) | (uint64_t)(0xFFFFFFFFu - (uint32_t)doc);
}

__device__ __forceinline__ int key_doc(uint64_t key) {
  return (int)(0xFFFFFFFFu - (uint32_t)key);
}

// The warp's largest key: the largest high word, then the largest low
// word among the lanes holding it (two redux.sync).
__device__ __forceinline__ uint64_t warp_max64(uint64_t v) {
  const uint32_t hi = __reduce_max_sync(0xFFFFFFFFu, (uint32_t)(v >> 32));
  const uint32_t lo = __reduce_max_sync(
      0xFFFFFFFFu, (uint32_t)(v >> 32) == hi ? (uint32_t)v : 0u);
  return ((uint64_t)hi << 32) | lo;
}

// The tile's top kk < n by warps: each thread sorts its keys, each warp
// takes its top kk by kk rounds of a warp max (keys are distinct), warp 0
// merges the eight lists the same way. Keys past n are 0, below any doc's.
__device__ __forceinline__ void topk_warps(const X2Args& a, const Tile& t,
                                           const float* s_final,
                                           uint64_t* s_cand, int64_t out,
                                           int tid, int warp, int lane) {
  uint64_t key[kKeys];
#pragma unroll
  for (int e = 0; e < kKeys; ++e) {
    const int d = tid + e * kThreads;
    key[e] = d < t.n ? topk_key(s_final[d], t.d0 + d) : 0ull;
  }
#pragma unroll
  for (int size = 2; size <= kKeys; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int i = 0; i < kKeys; ++i) {
        const int j = i ^ stride;
        if (j > i) {
          const uint64_t x = key[i], y = key[j];
          const bool swap = (x < y) == ((i & size) == 0);
          key[i] = swap ? y : x;
          key[j] = swap ? x : y;
        }
      }
    }
  }
  for (int r = 0; r < a.kk; ++r) {
    const uint64_t m = warp_max64(key[0]);
    const bool own = key[0] == m;
#pragma unroll
    for (int e = 0; e + 1 < kKeys; ++e) key[e] = own ? key[e + 1] : key[e];
    key[kKeys - 1] = own ? 0ull : key[kKeys - 1];
    if (lane == 0) s_cand[warp * kFastK + r] = m;
  }
  __syncthreads();
  if (warp == 0) {
    int ptr = 0;
    uint64_t head = lane < kWarps ? s_cand[lane * kFastK] : 0ull, mine = 0;
    for (int r = 0; r < a.kk; ++r) {
      const uint64_t m = warp_max64(head);
      if (lane < kWarps && head == m) {
        ++ptr;
        head = ptr < a.kk ? s_cand[lane * kFastK + ptr] : 0ull;
      }
      if (lane == r) mine = m;
    }
    if (lane < a.kk) {
      const int doc = key_doc(mine);
      a.cand_score[out + lane] = s_final[doc - t.d0];
      a.cand_doc[out + lane] = doc;
    }
  }
}

// The tile's first min(kk, n) docs by a bitonic sort of its keys (a power
// of two at or above n, zeros past n) in shared memory.
__device__ void topk_sort(const X2Args& a, const Tile& t,
                          const float* s_final, uint64_t* s_keys, int64_t out,
                          int tid) {
  int P = 1;
  while (P < t.n) P <<= 1;
  for (int i = tid; i < P; i += kThreads)
    s_keys[i] = i < t.n ? topk_key(s_final[i], t.d0 + i) : 0ull;
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < P / 2; i += kThreads) {
        const int lo = ((i & ~(stride - 1)) << 1) | (i & (stride - 1));
        const int hi = lo + stride;
        const uint64_t x = s_keys[lo], y = s_keys[hi];
        if ((x < y) == ((lo & size) == 0)) {
          s_keys[lo] = y;
          s_keys[hi] = x;
        }
      }
      __syncthreads();
    }
  }
  const int m = min(a.kk, t.n);
  for (int i = tid; i < m; i += kThreads) {
    const int doc = key_doc(s_keys[i]);
    a.cand_score[out + i] = s_final[doc - t.d0];
    a.cand_doc[out + i] = doc;
  }
}

// Grid (tiles, Q): block (x, q) owns docs [x * tile, x * tile + n) of
// query q and adds q's runs in plan order.
template <bool kScore>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
block_score_kernel(const X2Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(a.tile, kScore);
  const int q = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  Tile t;
  t.d0 = blockIdx.x * a.tile;
  t.n = min(a.tile, a.D - t.d0);
  t.acc = (float4*)(smem + L.acc);
  uint8_t* s_doc8 = smem + L.doc8;
  uint32_t* s_words = (uint32_t*)(smem + L.words);
  int* s_header = (int*)(smem + L.header);
  int* s_run = (int*)(smem + L.runs);
  int* s_batch = (int*)(smem + L.batch);
  t.doc8 = s_doc8;
  __shared__ int s_stop, s_nbatch, s_warp_cnt[kWarps];

  // the tile's state: zeroed sums; a byte a doc (its norm, 0-127 as the
  // tf table's rows, and its live flag)
  for (int i = tid; i < t.n; i += kThreads)
    t.acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int n4 = a.vec_tile ? t.n >> 2 : 0;
  for (int i = tid; i < n4; i += kThreads) {
    const float4 l = __ldg((const float4*)(a.live + t.d0) + i);
    const int4 v = kScore ? __ldg((const int4*)(a.norms + t.d0) + i)
                          : make_int4(0, 0, 0, 0);
    ((uint32_t*)s_doc8)[i] = (uint32_t)((v.x & 127) | (l.x > 0.f) << 7) |
                             (uint32_t)((v.y & 127) | (l.y > 0.f) << 7) << 8 |
                             (uint32_t)((v.z & 127) | (l.z > 0.f) << 7) << 16 |
                             (uint32_t)((v.w & 127) | (l.w > 0.f) << 7) << 24;
  }
  for (int i = 4 * n4 + tid; i < t.n; i += kThreads) {
    const int norm = kScore ? __ldg(a.norms + t.d0 + i) & 127 : 0;
    s_doc8[i] = (uint8_t)(norm | (__ldg(a.live + t.d0 + i) > 0.f) << 7);
  }
  const int64_t qb = (int64_t)q * a.B;
  for (int R0 = 0;; R0 += kRunsWin) {
    if (tid == 0) s_stop = kRunsWin;
    __syncthreads();
    // 1. a group of kSearchLanes lanes a run: its entries, then its blocks
    // that reach the tile (from the last one starting at or before d0 to
    // the last one starting before d0 + n) and their word range
    {
      const int slot = tid / kSearchLanes;
      const int r = R0 + slot;
      bool valid = false;
      int len = 0, b0 = 0, p0 = 0;
      if (r < a.B) {
        p0 = r ? min(__ldg(a.run_end + qb + r - 1), a.B) : 0;
        const int p1 = min(__ldg(a.run_end + qb + r), a.B);
        b0 = p1 > p0 ? __ldg(a.blocks + qb + p0) : -1;
        valid = b0 >= 0;  // padding: the runs are over
        len = valid ? p1 - p0 : 0;
      }
      const int* base = a.block_base + (valid ? b0 : 0);
      const int lo = max(group_bound<true>(base, len, t.d0, lane) - 1, 0);
      // a full block spans 128 docs: n / 128 + 2 blocks reach the tile
      const int lim = min(len, lo + (t.n >> 7) + 3);
      int hi = lo + group_bound<false>(base + lo, max(lim - lo, 0),
                                       t.d0 + t.n, lane);
      const int more = (hi == lim && lim < len) ? len - lim : 0;
      const int past = group_bound<false>(base + lim, more, t.d0 + t.n, lane);
      if (more) hi = lim + past;
      if (tid % kSearchLanes == 0) {
        int nblk = 0, ws = 0, we = 0;
        if (valid) {
          nblk = hi - lo;
          if (nblk > 0) {
            const int first = b0 + lo, last = first + nblk - 1;
            const int64_t end =
                (int64_t)__ldg(a.block_word_off + last) +
                block_words(__ldg(a.block_count + last),
                            __ldg(a.block_doc_bits + last),
                            __ldg(a.block_freq_bits + last));
            ws = __ldg(a.block_word_off + first);
            we = (int)(end < 0x7FFFFFF0 ? end : 0x7FFFFFF0);
          }
        } else {
          atomicMin(&s_stop, slot);
        }
        s_run[kFirst * kRunsWin + slot] = b0 + lo;
        s_run[kPFirst * kRunsWin + slot] = p0 + lo;
        s_run[kNBlk * kRunsWin + slot] = nblk;
        s_run[kWStart * kRunsWin + slot] = ws;
        s_run[kWEnd * kRunsWin + slot] = we;
      }
    }
    __syncthreads();
    const int nruns = s_stop;
    // 2. the batches: the runs' ranges packed in plan order into slots of
    // kSlotWords words and kSlotBlocks headers; a range that cannot be
    // staged (soff -1) decodes from global memory
    if (tid == 0) {
      int nb = 0, used = 0, bused = 0;
      s_batch[0] = 0;
      for (int i = 0; i < nruns; ++i) {
        const int nbk = s_run[kNBlk * kRunsWin + i];
        const int64_t w0 = s_run[kWStart * kRunsWin + i];
        const int64_t w1 = s_run[kWEnd * kRunsWin + i];
        const int span = (int)(((w1 + 3) & ~3ll) - (w0 & ~3ll));
        s_run[kSOff * kRunsWin + i] = -1;
        if (nbk == 0 || w0 < 0 || w1 < w0 || w1 > a.n_words ||
            span > kSlotWords || nbk > kSlotBlocks)
          continue;
        if (used + span > kSlotWords || bused + nbk > kSlotBlocks) {
          s_batch[++nb] = i;
          used = bused = 0;
        }
        s_run[kSOff * kRunsWin + i] = used + (int)(w0 & 3);
        s_run[kBOff * kRunsWin + i] = bused;
        used += span;
        bused += nbk;
      }
      s_batch[nb + 1] = nruns;
      s_nbatch = nb + 1;
    }
    __syncthreads();
    const int nbatch = s_nbatch;
    // 3. the batches in plan order through the two slots: batch b + 2's
    // copies start once batch b is added
    stage_batch(a, qb, 0, nbatch, s_batch, s_run, s_words, s_header, warp,
                lane);
    stage_batch(a, qb, 1, nbatch, s_batch, s_run, s_words, s_header, warp,
                lane);
    for (int b = 0; b < nbatch; ++b) {
      cp_async_wait<1>();
      __syncthreads();
      const uint32_t* w = s_words + (b & 1) * kSlotWords;
      const int* h = s_header + (b & 1) * kHeaderCols * kSlotBlocks;
      for (int i = s_batch[b]; i < s_batch[b + 1]; ++i) {
        if (s_run[kNBlk * kRunsWin + i] == 0) continue;
        add_run<kScore>(a, t, qb, i, s_run, w, h, warp, lane);
        __syncthreads();
      }
      stage_batch(a, qb, b + 2, nbatch, s_batch, s_run, s_words, s_header,
                  warp, lane);
    }
    cp_async_wait<0>();
    __syncthreads();
    if (nruns < kRunsWin || R0 + kRunsWin >= a.B) break;
  }

  // the mask, the final scores (into the free slots), the hit count
  float* s_final = (float*)s_words;
  const float num_required = __ldg(a.bool_params + 2 * q);
  const float min_should = __ldg(a.bool_params + 2 * q + 1);
  int cnt = 0;
  for (int i = tid; i < t.n; i += kThreads) {
    const float4 v = t.acc[i];
    const bool m = v.y == num_required && v.z >= min_should && v.w == 0.f &&
                   __fadd_rn(v.y, v.z) > 0.f && (s_doc8[i] & 128);
    if (kScore) s_final[i] = m ? v.x : -1.f;
    cnt += m;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    cnt += __shfl_down_sync(0xFFFFFFFFu, cnt, off);
  if (lane == 0) s_warp_cnt[warp] = cnt;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += s_warp_cnt[w];
    if (total) atomicAdd(a.hits + q, total);  // integers: any order is exact
  }
  if (kScore) {
    // the keys take the sums' space, free since the barrier above
    const int64_t out = ((int64_t)q * a.tiles + blockIdx.x) * a.kk;
    uint64_t* s_keys = (uint64_t*)(smem + L.acc);
    if (a.kk <= kFastK && a.kk < t.n) {
      topk_warps(a, t, s_final, s_keys, out, tid, warp, lane);
    } else {
      topk_sort(a, t, s_final, s_keys, out, tid);
    }
  }
}

// Raises the kernel's dynamic shared memory limit to ``bytes`` where it
// is above the 48 KB default; fails where the card offers less.
template <bool kScore>
cudaError_t allow_smem(int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (bytes > optin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(block_score_kernel<kScore>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

// X2: one launch on ``stream``, no sync; hits must be zeroed before it.
// ``cand_score`` null selects the count form; else the candidates are
// [Q, ceil(D / tile), min(k, tile)] (the last tile's first min(k, n)
// written). Returns the CUDA error code.
extern "C" int diagon_block_score(
    const void* packed, int64_t n_words, const void* block_base,
    const void* block_count, const void* block_doc_bits,
    const void* block_freq_bits, const void* block_word_off,
    const void* norms, const void* tf_lut, const void* live,
    const void* blocks, const void* run_end, const void* weight,
    const void* req, const void* sho, const void* neg,
    const void* bool_params, void* cand_score, void* cand_doc, void* hits,
    int D, int B, int Q, int F, int window_words, int tile, int k,
    void* stream) {
  const bool score = cand_score != nullptr;
  if (D < 1 || B < 1 || Q < 1 || Q > 65535 || F < 1 || window_words < 1 ||
      tile < 1 || tile > kMaxTile || (score && (k < 1 || !cand_doc)))
    return (int)cudaErrorInvalidValue;
  X2Args a;
  a.packed = (const uint32_t*)packed;
  a.block_base = (const int*)block_base;
  a.block_count = (const int*)block_count;
  a.block_doc_bits = (const int*)block_doc_bits;
  a.block_freq_bits = (const int*)block_freq_bits;
  a.block_word_off = (const int*)block_word_off;
  a.norms = (const int*)norms;
  a.tf_lut = (const float*)tf_lut;
  a.live = (const float*)live;
  a.blocks = (const int*)blocks;
  a.weight = (const float*)weight;
  a.req = (const float*)req;
  a.sho = (const float*)sho;
  a.neg = (const float*)neg;
  a.bool_params = (const float*)bool_params;
  a.run_end = (const int*)run_end;
  a.cand_score = (float*)cand_score;
  a.cand_doc = (int*)cand_doc;
  a.hits = (int*)hits;
  a.n_words = n_words;
  a.D = D;
  a.B = B;
  a.F = F;
  a.ww = window_words;
  a.tile = tile;
  a.tiles = (D + tile - 1) / tile;
  a.kk = score ? (k < tile ? k : tile) : 0;
  a.vec_tile = tile % 4 == 0 && ((uintptr_t)norms & 15) == 0 &&
               ((uintptr_t)live & 15) == 0;
  a.vec_words = ((uintptr_t)packed & 15) == 0;
  const int bytes = layout(tile, score).total;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(a.tiles, Q);
  cudaError_t err;
  if (score) {
    err = allow_smem<true>(bytes);
    if (err != cudaSuccess) return (int)err;
    block_score_kernel<true><<<grid, kThreads, bytes, s>>>(a);
  } else {
    err = allow_smem<false>(bytes);
    if (err != cudaSuccess) return (int)err;
    block_score_kernel<false><<<grid, kThreads, bytes, s>>>(a);
  }
  return (int)cudaGetLastError();
}
