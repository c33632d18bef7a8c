// Exact hit counts from presence bitmaps for Hopper (sm_90a): the phase-0
// route's per-query live hit count.
//
// Replaces diagon_tpu/ops/pallas/bits_hits.py: pallas_bits_hits (_mk_kernel).
//
// What it computes. Each compact-bank row r is a bitmap over the padded doc
// axis, W = D / 32 words (bit d % 32 of word d / 32 set where the row's
// score is > 0 and doc d is live), held as int32 bit patterns. Clause t of
// query q reads row cidx[q, t] with role flags cflags[q, t] (bit1 required,
// bit2 should, bit3 must_not; bit0, scoring, plays no part here). Per query:
//
//   base  = AND of the required rows
//   sho   = OR of the should rows
//   neg   = OR of the must_not rows
//   match = (mode & REQ ? base : ~0) & (mode & SHO ? sho : ~0) & ~neg
//
// and hits[q] = popcount(match) summed over the words, or 0 where mode has
// DEAD (an absent required clause). The caller guarantees min_should <= 1,
// where this equals the oracle's match set. Counts are integers, so the
// kernel equals its plain version exactly.
//
// Layout. The TPU kernel keeps a [U8, WB] word chunk resident in VMEM and
// walks every query over it in a sequential grid. Here too a block owns a
// span of words and stages every row's words of that span in shared memory
// once (cp.async, 16 bytes a thread; words past W are zero and not
// counted), then walks the queries over it, a group of up to 64 at a time:
//
// - Prologue of a group: a warp a query compacts the query's role clauses
//   into required / should / must_not lists of shared-memory row offsets
//   (ballots over 32 clauses at a time), so scoring-only and padding
//   clauses drop out, and roles the mode word ignores with them. The
//   group's cidx, cflags and mode words are loaded into registers while the
//   block walks the group before it.
// - Walk: the items (query, 32-lane column of the span) go round the warps.
//   A lane holds V consecutive words (V = 4, 2 or 1, the widest whose
//   column of every row fits). A row costs one shared-memory load of V
//   words, half a load of list entries (two 16-bit offsets a word) and
//   half a 3-input logic op a word (two rows of one role fold in one), with
//   no predicate: each ballot of an odd count writes its last entry twice
//   (x & x = x | x = x). Counts: __popc per word, a warp sum, one
//   shared-memory atomic per item.
// - Two barriers a group: the counts are double-buffered, and a group's are
//   flushed (one global atomicAdd per block and query) while the next one
//   walks.
//
// ops/bits_hits.py bits_plan picks V, the span and the group from U8, Tq,
// W and the SM count: as many columns as fit two blocks an SM, and the span
// whose count of blocks fills the card's slots in the fewest waves; where
// the spans are fewer than the slots, grid.y splits the query groups.
//
// Bound: operations. The bank is read from HBM once (U8 * W * 4 bytes, 50 MB
// at 10M docs and 40 rows); the logic is k // 2 three-input ops per
// (query, word) for a query's k role rows, at 64 lanes an SM a clock, and a
// popcount per (query, word), at 16. Each (query, role row, word) is also
// one shared-memory word, at 32 words an SM a clock: about 2.2e9 words,
// 0.26 ms on 132 SMs at 1.98 GHz, at the 10M phase-0 shape. The walk runs at about half that rate, and its time
// grows with Q, not with the groups or blocks: neither two columns an item
// (twice the loads in flight), nor fewer instructions a row, nor the
// shared-memory carveout moved it more than a few percent (PERF.md section 6).
// The first CUDA form read every clause row from L1/L2 once per query
// (about 9 GB a call).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroupPerWarp = 8;  // queries a warp compacts per group
constexpr int kModeReq = 1;
constexpr int kModeSho = 2;
constexpr int kModeDead = 4;
constexpr int64_t kDefaultSmem = 48 * 1024;  // a block's without opting in
constexpr int64_t kMaxSmem = 232448;  // a block's dynamic shared memory, max

// V consecutive words of one row, loaded from shared memory in one access.
template <int V>
struct alignas(4 * V) Words {
  uint32_t w[V];
};

template <int V>
__device__ __forceinline__ Words<V> fill(uint32_t x) {
  Words<V> a;
#pragma unroll
  for (int v = 0; v < V; ++v) a.w[v] = x;
  return a;
}

// acc AND (or OR) the rows of entries e[0..n), two entries a 4-byte read
// and two rows an op; n is even (the lists repeat their last entry, and
// x & x = x | x = x).
template <bool OR, int V>
__device__ __forceinline__ Words<V> fold(Words<V> acc, const Words<V>* rows,
                                         const uint16_t* e, int n) {
  const uint32_t* e2 = reinterpret_cast<const uint32_t*>(e);
#pragma unroll 2
  for (int i = 0; i < n; i += 2) {
    const uint32_t k = e2[i >> 1];
    const Words<V> a = rows[k & 0xffffu];
    const Words<V> b = rows[k >> 16];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      acc.w[v] = OR ? (acc.w[v] | a.w[v] | b.w[v])
                    : (acc.w[v] & a.w[v] & b.w[v]);
    }
  }
  return acc;
}

// The lane's clause of the first 32 and the mode word of each query a warp
// compacts in a group (queries warp + kWarps * k of it), loaded ahead. The
// values stay as loaded until the next prologue reads them, so the loads
// are in flight during the walk before it.
struct Raw {
  int f[kGroupPerWarp];
  int c[kGroupPerWarp];
  int m[kGroupPerWarp];
};

__device__ __forceinline__ void load_raw(Raw& raw,
                                         const int32_t* __restrict__ cidx,
                                         const int32_t* __restrict__ cflags,
                                         const int32_t* __restrict__ qmode,
                                         int64_t g0, int nq, int Tq, int warp,
                                         int lane) {
#pragma unroll
  for (int k = 0; k < kGroupPerWarp; ++k) {
    const int j = warp + kWarps * k;
    const bool ok = j < nq && lane < Tq;
    const int64_t at = (g0 + j) * Tq + lane;
    raw.f[k] = ok ? __ldg(cflags + at) : 0;
    raw.c[k] = ok ? __ldg(cidx + at) : 0;
    raw.m[k] = j < nq ? __ldg(qmode + g0 + j) : 0;
  }
}

// Appends this lane's entry `off` to a list at n (where `on`), in lane
// order, the last of an odd count twice; returns the list's new (even)
// length.
__device__ __forceinline__ int append(uint16_t* list, int n, bool on,
                                      int off, int lane) {
  const unsigned b = __ballot_sync(0xffffffffu, on);
  const int c = __popc(b);
  if (on) {
    const int at = n + __popc(b & ((1u << lane) - 1));
    list[at] = (uint16_t)off;
    if ((c & 1) && at == n + c - 1) list[at + 1] = (uint16_t)off;
  }
  return n + c + (c & 1);
}

// Shared memory (dynamic): U8 rows of `span` words, then per query of a
// group (qg of them) its header {required, should, must_not list lengths,
// mode} and its three lists of row offsets (in Words<V>; cap entries each,
// room for Tq and one repeat a 32-clause chunk), then two buffers of qg
// hit counts (a group's are flushed while the next one walks).
template <int V>
__global__ void __launch_bounds__(kThreads, 2) bits_hits_kernel(
    const int32_t* __restrict__ bits, const int32_t* __restrict__ cidx,
    const int32_t* __restrict__ cflags, const int32_t* __restrict__ qmode,
    int32_t* __restrict__ hits, int U8, int64_t W, int Q, int Tq, int span,
    int qg) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int cap = (Tq + (Tq + 31) / 32 + 1) & ~1;
  int4* s_head = reinterpret_cast<int4*>(smem + (int64_t)U8 * span);
  uint16_t* s_list = reinterpret_cast<uint16_t*>(s_head + qg);
  int32_t* s_counts = reinterpret_cast<int32_t*>(s_list + 3 * cap * qg);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t w0 = (int64_t)blockIdx.x * span;
  const int rw = span / V;  // Words<V> a staged row

  // stage the span of every row: 16 bytes a copy, zero past W
  {
    const uint32_t s_rows = (uint32_t)__cvta_generic_to_shared(smem);
    const int per_row = span / 4;
    for (int i = threadIdx.x; i < U8 * per_row; i += kThreads) {
      const int r = i / per_row;
      const int64_t w = w0 + 4 * (i - r * per_row);
      const bool in = w < W;
      const int32_t* src = in ? bits + r * W + w : bits;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                   :: "r"(s_rows + 16u * i), "l"(src), "r"(in ? 16 : 0)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  }

  const int64_t step = (int64_t)gridDim.y * qg;
  int64_t g0 = (int64_t)blockIdx.y * qg;
  Raw raw;
  load_raw(raw, cidx, cflags, qmode, g0, (int)min((int64_t)qg, Q - g0), Tq,
           warp, lane);
  bool staged = false;
  int64_t g_done = 0;  // the group whose counts wait to be flushed
  int n_done = 0, p_done = 0;
  for (int parity = 0; g0 < Q; g0 += step, parity ^= 1) {
    const int nq = (int)min((int64_t)qg, Q - g0);
    int32_t* s_count = s_counts + parity * qg;
    // prologue: the group's lists (the walk and flush before are done)
#pragma unroll
    for (int k = 0; k < kGroupPerWarp; ++k) {
      const int j = warp + kWarps * k;
      if (j >= nq) break;
      const int mode = raw.m[k];
      const bool live = !(mode & kModeDead);
      const bool req = live && (mode & kModeReq);
      const bool sho = live && (mode & kModeSho);
      uint16_t* list = s_list + j * 3 * cap;
      int nr = 0, ns = 0, nn = 0;
      for (int t0 = 0; t0 < Tq; t0 += 32) {
        int f = raw.f[k], c = raw.c[k];
        if (t0) {
          const bool ok = t0 + lane < Tq;
          const int64_t at = (g0 + j) * Tq + t0 + lane;
          f = ok ? __ldg(cflags + at) : 0;
          c = ok ? __ldg(cidx + at) : 0;
        }
        const int off = c * rw;
        nr = append(list, nr, req && (f & 2), off, lane);
        ns = append(list + cap, ns, sho && (f & 4), off, lane);
        nn = append(list + 2 * cap, nn, live && (f & 8), off, lane);
      }
      if (lane == 0) {
        s_head[j] = make_int4(nr, ns, nn, mode);
        s_count[j] = 0;
      }
    }
    if (!staged) {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
      staged = true;
    }
    __syncthreads();
    // the group before: its counts, complete since the barrier after its walk
    for (int j = threadIdx.x; j < n_done; j += kThreads) {
      const int32_t n = s_counts[p_done * qg + j];
      if (n) atomicAdd(&hits[g_done + j], n);
    }
    // the next group's clauses, in flight during this walk
    const int64_t g1 = g0 + step;
    if (g1 < Q) {
      load_raw(raw, cidx, cflags, qmode, g1, (int)min((int64_t)qg, Q - g1),
               Tq, warp, lane);
    }
    // walk: item (query j, column col) at lane words x * V .. x * V + V - 1;
    // warp w takes items w, w + kWarps, ... of the j-major order
    const int ncol = span / (32 * V);
    const int dj = kWarps / ncol, dc = kWarps - dj * ncol;
    const Words<V>* rows = reinterpret_cast<const Words<V>*>(smem);
    for (int j = warp / ncol, col = warp % ncol; j < nq;
         j += dj + (col + dc >= ncol),
             col = col + dc >= ncol ? col + dc - ncol : col + dc) {
      const int4 h = s_head[j];
      if (h.w & kModeDead) continue;  // warp-uniform: no count
      const int x = col * 32 + lane;
      const uint16_t* e = s_list + j * 3 * cap;
      const Words<V>* at = rows + x;
      // match = AND of required & OR of should & ~OR of must_not
      Words<V> m = fold<false, V>(fill<V>(~0u), at, e, h.x);
      const Words<V> sho = fold<true, V>(
          fill<V>((h.w & kModeSho) ? 0u : ~0u), at, e + cap, h.y);
#pragma unroll
      for (int v = 0; v < V; ++v) m.w[v] &= sho.w[v];
      const Words<V> neg = fold<true, V>(fill<V>(0u), at, e + 2 * cap, h.z);
      unsigned cnt = 0;
      if (w0 + (int64_t)x * V < W) {
#pragma unroll
        for (int v = 0; v < V; ++v) cnt += __popc(m.w[v] & ~neg.w[v]);
      }
      cnt = __reduce_add_sync(0xffffffffu, cnt);
      if (lane == 0 && cnt) atomicAdd(&s_count[j], (int32_t)cnt);
    }
    __syncthreads();  // the walk is done: lists free, counts complete
    g_done = g0;
    n_done = nq;
    p_done = parity;
  }
  for (int j = threadIdx.x; j < n_done; j += kThreads) {
    const int32_t n = s_counts[p_done * qg + j];
    if (n) atomicAdd(&hits[g_done + j], n);
  }
}

}  // namespace

// Launcher: plain C interface for ctypes. Runs on the given stream, zeroes
// hits there first, allocates nothing and returns cudaGetLastError() as an
// int (0 = launched).
//
// Preconditions, checked by the Python wrapper: bits i32 [U8, W], 16-byte
// aligned, with W % 4 == 0; cidx and cflags i32 [Q, Tq]; qmode and hits i32
// [Q]; all contiguous on one device; Q, Tq >= 1; the plan of
// ops/bits_hits.py bits_plan: V in {1, 2, 4}, span a multiple of 32 * V
// words, qg <= 64 queries a group, gy <= ceil(Q / qg) blocks along y, and
// the shared memory of bits_smem within a block's. Index values are the
// caller's contract: 0 <= cidx < U8.
extern "C" int diagon_bits_hits(const int32_t* bits, const int32_t* cidx,
                                const int32_t* cflags, const int32_t* qmode,
                                int32_t* hits, int U8, int64_t W, int Q,
                                int Tq, int V, int span, int qg, int gy,
                                cudaStream_t stream) {
  if (span < 32 * V || span % (32 * V) || qg < 1 ||
      qg > kWarps * kGroupPerWarp || gy < 1 || gy > 65535 ||
      (int64_t)(gy - 1) * qg >= Q) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t cap = ((int64_t)Tq + (Tq + 31) / 32 + 1) & ~1;
  const int64_t smem = 4 * (int64_t)U8 * span + (int64_t)qg * (16 + 8 + 6 * cap);
  const int64_t gx = (W + span - 1) / span;
  if (smem > kMaxSmem || gx > 0x7fffffff) return (int)cudaErrorInvalidValue;
  void (*kernel)(const int32_t*, const int32_t*, const int32_t*,
                 const int32_t*, int32_t*, int, int64_t, int, int, int, int);
  switch (V) {
    case 4: kernel = bits_hits_kernel<4>; break;
    case 2: kernel = bits_hits_kernel<2>; break;
    case 1: kernel = bits_hits_kernel<1>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  cudaError_t err =
      cudaMemsetAsync(hits, 0, sizeof(int32_t) * (size_t)Q, stream);
  if (err != cudaSuccess) return (int)err;
  if (smem > kDefaultSmem) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3((unsigned)gx, (unsigned)gy), kThreads, (size_t)smem, stream>>>(
      bits, cidx, cflags, qmode, hits, U8, W, Q, Tq, span, qg);
  return (int)cudaGetLastError();
}
