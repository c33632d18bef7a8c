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
// && req + sho > 0 && live[d] > 0, final[q, d] = mask ? score : -1, and
// hits[q] = the count of the mask. The top-k over final (score descending,
// docid ascending) is torch ops in the wrapper, as lax.top_k is XLA's.
// The count form (count_matches) writes no final row and skips the score.
//
// Exactness. A doc's score must be ((0 + c1) + c2) + ... in plan order,
// the order in which XLA's CPU scatter and the oracle add. So no float
// atomics: they fix no order. A run of the plan (one clause: consecutive
// entries holding every block of one term, in order) holds each doc at
// most once, because a term's postings strictly ascend. The plan gives its
// runs (run_end[q, r], the end of run r, which starts where run r - 1
// ended; 0 after the last run: build_segment_plan). The design: each block
// owns a tile of T docs of one query, held in shared memory (four f32
// columns), and walks the runs in plan order with a barrier between runs;
// inside a run its warps take the run's blocks that reach the tile (a
// binary search on the run's block bases: block j's docs lie in
// [base_j, base_j+1)) and add with plain shared-memory stores, since no two
// lanes of a run meet on a doc. Adds use __fadd_rn / __fmul_rn, and the
// build has --fmad=false. The alternative, one launch per run on the
// stream, needs a launch per run and query; this one takes one launch a
// call. hits[q] is zeroed by the caller.
//
// Bound: bytes. Each valid block's own words and metadata, the plan, the
// tf table once, a norm a distinct doc, the live mask read and the final
// row written, over HBM (chip_smoke.py x2_bound). What this form costs
// beyond that: a block read and decoded by every tile it reaches (a rare term's block spans many tiles), every tile's
// shared-memory columns set and read, and one barrier a run per tile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 2048;  // docs a block owns: 4 x 8 KB of columns

// Word x of a block's window: the window is clipped to its last word, the
// stream to its ends (gather_windows, unpack_lanes).
__device__ __forceinline__ uint32_t window_word(const uint32_t* packed,
                                                int64_t n_words, int word_off,
                                                int ww, int x) {
  x = min(x, ww - 1);
  int64_t i = (int64_t)word_off + x;
  i = i < 0 ? 0 : (i >= n_words ? n_words - 1 : i);
  return __ldg(packed + i);
}

// Lane ``lane`` of a section at ``bits`` starting at window word
// ``word_base`` (u32 arithmetic, as the JAX decode).
__device__ __forceinline__ uint32_t lane_value(const uint32_t* packed,
                                               int64_t n_words, int word_off,
                                               int ww, uint32_t bits,
                                               uint32_t word_base,
                                               uint32_t lane) {
  const uint32_t bitpos = word_base * 32u + lane * bits;
  const int widx = (int)(bitpos >> 5);
  const uint32_t shift = bitpos & 31u;
  const uint32_t w0 = window_word(packed, n_words, word_off, ww, widx);
  const uint32_t w1 = window_word(packed, n_words, word_off, ww, widx + 1);
  const uint32_t lo = w0 >> shift;
  const uint32_t hi = shift ? (w1 << (32u - shift)) : 0u;
  const uint32_t mask = bits ? (0xFFFFFFFFu >> (32u - bits)) : 0u;
  return (lo | hi) & mask;
}

// First j in [0, n) with base[j] >= x (n if none).
__device__ __forceinline__ int lower_bound(const int* base, int n, int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(base + mid) < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// First j in [0, n) with base[j] > x (n if none).
__device__ __forceinline__ int upper_bound(const int* base, int n, int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(base + mid) <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

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
  float* final_;  // [Q, D]; null in the count form
  int* hits;
  int64_t n_words;
  int D, B, F, ww, tile;
};

// A warp adds the lanes of block b (plan entry p) whose docs fall in
// [d0, d0 + n). Lane L decodes values 4L..4L+3; docids are the block base
// plus a warp prefix sum of the deltas (u32 adds: the JAX int32 cumsum).
template <bool kScore>
__device__ __forceinline__ void add_block(const X2Args& a, int64_t qb, int p,
                                          int b, int d0, int n, int lane,
                                          float* s_score, float* s_req,
                                          float* s_sho, float* s_neg) {
  const int cnt = __ldg(a.block_count + b);
  const uint32_t db = (uint32_t)__ldg(a.block_doc_bits + b);
  const uint32_t fb = (uint32_t)__ldg(a.block_freq_bits + b);
  const int wo = __ldg(a.block_word_off + b);
  const uint32_t base = (uint32_t)__ldg(a.block_base + b);
  uint32_t incl[4], sum = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    sum += lane_value(a.packed, a.n_words, wo, a.ww, db, 0u,
                      (uint32_t)(4 * lane + e));
    incl[e] = sum;
  }
  uint32_t x = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, x, off);
    if (lane >= off) x += y;
  }
  const uint32_t excl = x - sum;
  const float w = a.weight[qb + p], rq = a.req[qb + p];
  const float sh = a.sho[qb + p], ng = a.neg[qb + p];
  const uint32_t dwords = (uint32_t)((cnt * (int)db + 31) >> 5);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = 4 * lane + e;
    const int doc = (int)(base + excl + incl[e]);
    if (i >= cnt || doc < d0 || doc >= d0 + n) continue;
    const int t = doc - d0;
    if (kScore) {
      int freq = fb ? (int)lane_value(a.packed, a.n_words, wo, a.ww, fb,
                                       dwords, (uint32_t)i)
                    : 1;
      freq = min(max(freq, 0), a.F - 1);
      const float tf = __ldg(a.tf_lut + __ldg(a.norms + doc) * a.F + freq);
      s_score[t] = __fadd_rn(s_score[t], __fmul_rn(w, tf));
    }
    s_req[t] = __fadd_rn(s_req[t], rq);
    s_sho[t] = __fadd_rn(s_sho[t], sh);
    s_neg[t] = __fadd_rn(s_neg[t], ng);
  }
}

// Grid (tiles, Q): block (x, q) owns docs [x * tile, x * tile + tile) of
// query q and walks q's runs in plan order.
template <bool kScore>
__global__ void __launch_bounds__(kThreads)
block_score_kernel(const X2Args a) {
  extern __shared__ float smem[];
  const int q = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int d0 = blockIdx.x * a.tile;
  const int n = min(a.tile, a.D - d0);
  float* s_score = smem;
  float* s_req = smem + (kScore ? a.tile : 0);
  float* s_sho = s_req + a.tile;
  float* s_neg = s_sho + a.tile;
  for (int i = tid; i < n; i += kThreads) {
    if (kScore) s_score[i] = 0.f;
    s_req[i] = 0.f;
    s_sho[i] = 0.f;
    s_neg[i] = 0.f;
  }
  __syncthreads();
  const int64_t qb = (int64_t)q * a.B;
  int p0 = 0;
  for (int r = 0; r < a.B; ++r) {
    const int p1 = min(a.run_end[qb + r], a.B);
    if (p1 <= p0) break;
    const int b0 = a.blocks[qb + p0];
    if (b0 < 0) break;  // padding: the runs are over
    const int len = p1 - p0;
    const int* base = a.block_base + b0;
    // the run's blocks that reach the tile: from the last one starting at
    // or before d0 to the last one starting before d0 + n
    const int lo = max(upper_bound(base, len, d0) - 1, 0);
    const int hi = lower_bound(base, len, d0 + n);
    for (int j = lo + warp; j < hi; j += kWarps) {
      add_block<kScore>(a, qb, p0 + j, b0 + j, d0, n, lane, s_score, s_req,
                        s_sho, s_neg);
    }
    __syncthreads();
    p0 = p1;
  }
  const float num_required = a.bool_params[2 * q];
  const float min_should = a.bool_params[2 * q + 1];
  int cnt = 0;
  for (int i = tid; i < n; i += kThreads) {
    const float rq = s_req[i], sh = s_sho[i];
    const bool m = rq == num_required && sh >= min_should &&
                   s_neg[i] == 0.f && __fadd_rn(rq, sh) > 0.f &&
                   __ldg(a.live + d0 + i) > 0.f;
    if (kScore) a.final_[(int64_t)q * a.D + d0 + i] = m ? s_score[i] : -1.f;
    cnt += m;
  }
  __shared__ int warp_cnt[kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    cnt += __shfl_down_sync(0xFFFFFFFFu, cnt, off);
  if (lane == 0) warp_cnt[warp] = cnt;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_cnt[w];
    if (total) atomicAdd(a.hits + q, total);  // integers: any order is exact
  }
}

}  // namespace

// X2: one launch on ``stream``, no sync; hits must be zeroed before it.
// ``final_`` null selects the count form. Returns the CUDA error code.
extern "C" int diagon_block_score(
    const void* packed, int64_t n_words, const void* block_base,
    const void* block_count, const void* block_doc_bits,
    const void* block_freq_bits, const void* block_word_off,
    const void* norms, const void* tf_lut, const void* live,
    const void* blocks, const void* run_end, const void* weight,
    const void* req, const void* sho, const void* neg,
    const void* bool_params, void* final_, void* hits, int D, int B, int Q,
    int F, int window_words, int tile, void* stream) {
  if (D < 1 || B < 1 || Q < 1 || Q > 65535 || F < 1 || window_words < 1 ||
      tile < 1 || tile > kMaxTile)
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
  a.final_ = (float*)final_;
  a.hits = (int*)hits;
  a.n_words = n_words;
  a.D = D;
  a.B = B;
  a.F = F;
  a.ww = window_words;
  a.tile = tile;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((D + tile - 1) / tile, Q);
  if (final_) {
    block_score_kernel<true><<<grid, kThreads, 4 * tile * sizeof(float), s>>>(a);
  } else {
    block_score_kernel<false><<<grid, kThreads, 3 * tile * sizeof(float), s>>>(a);
  }
  return (int)cudaGetLastError();
}
