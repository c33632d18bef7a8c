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
// walks every query over it in a sequential grid, a single-sublane layout
// that wastes most of each vector register. Here a block owns a group of
// queries (grid.x) and a span of 1024 words (grid.y); a thread owns 4
// consecutive words (one 16-byte load per clause, coalesced along the
// words) and, for each query of its group, folds the clause rows in
// registers, counts with __popc, and sums over its warp with
// __reduce_add_sync. Lane 0 adds the warp's count to the block's
// shared-memory count of that query, and the block adds each query's count
// to hits with one global atomicAdd. The query groups of one word span are
// consecutive in launch order, so they run together and read the span's
// rows from L1 and L2 rather than from HBM.
//
// Bound: integer operations. The bank is read once from HBM (U8 * W * 4
// bytes, 50 MB at 10M docs and 40 rows), but the work is one 32-bit logic
// operation per (query, role clause, word), 5.1e9 of them for the 10M mixed
// pure-OR subset, plus a popcount per (query, word). A simple, correct
// kernel first: keeping a span's rows in shared memory and sharing the
// folds of equal clause prefixes across queries are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWordsPerThread = 4;
constexpr int kModeReq = 1;
constexpr int kModeSho = 2;
constexpr int kModeDead = 4;

__device__ __forceinline__ uint4 and4(uint4 a, uint4 b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}

__device__ __forceinline__ uint4 or4(uint4 a, uint4 b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}

// Shared memory: cidx and flags of the block's queries ([qpb, Tq] each),
// their mode words and their running counts ([qpb] each).
__global__ void __launch_bounds__(kThreads) bits_hits_kernel(
    const uint4* __restrict__ bits, const int32_t* __restrict__ cidx,
    const int32_t* __restrict__ cflags, const int32_t* __restrict__ qmode,
    int32_t* __restrict__ hits, int64_t W4, int Q, int Tq, int qpb) {
  extern __shared__ int32_t smem[];
  int32_t* s_cidx = smem;
  int32_t* s_flags = s_cidx + qpb * Tq;
  int32_t* s_mode = s_flags + qpb * Tq;
  int32_t* s_count = s_mode + qpb;

  const int q0 = blockIdx.x * qpb;
  const int nq = min(qpb, Q - q0);
  for (int i = threadIdx.x; i < nq * Tq; i += kThreads) {
    s_cidx[i] = cidx[(int64_t)q0 * Tq + i];
    s_flags[i] = cflags[(int64_t)q0 * Tq + i];
  }
  for (int i = threadIdx.x; i < nq; i += kThreads) {
    s_mode[i] = qmode[q0 + i];
    s_count[i] = 0;
  }
  __syncthreads();

  const int64_t w4 = (int64_t)blockIdx.y * kThreads + threadIdx.x;
  const bool in_row = w4 < W4;
  const uint4 ones = make_uint4(~0u, ~0u, ~0u, ~0u);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int j = 0; j < nq; ++j) {  // block-uniform: every lane reduces
    const int mode = s_mode[j];
    unsigned count = 0;
    if (in_row && !(mode & kModeDead)) {
      uint4 band = ones, bor = zero, bneg = zero;
      const int32_t* ci = s_cidx + j * Tq;
      const int32_t* fl = s_flags + j * Tq;
      for (int t = 0; t < Tq; ++t) {
        const int f = fl[t];
        if (!(f & 14)) continue;  // padding or scoring-only clause
        const uint4 row = __ldg(bits + (int64_t)ci[t] * W4 + w4);
        if (f & 2) band = and4(band, row);
        if (f & 4) bor = or4(bor, row);
        if (f & 8) bneg = or4(bneg, row);
      }
      uint4 m = and4((mode & kModeReq) ? band : ones,
                     (mode & kModeSho) ? bor : ones);
      m = make_uint4(m.x & ~bneg.x, m.y & ~bneg.y, m.z & ~bneg.z,
                     m.w & ~bneg.w);
      count = __popc(m.x) + __popc(m.y) + __popc(m.z) + __popc(m.w);
    }
    count = __reduce_add_sync(0xffffffffu, count);
    if ((threadIdx.x & 31) == 0 && count) {
      atomicAdd(&s_count[j], (int32_t)count);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nq; i += kThreads) {
    if (s_count[i]) atomicAdd(&hits[q0 + i], s_count[i]);
  }
}

}  // namespace

// Launcher: plain C interface for ctypes. Runs on the given stream, zeroes
// hits there first, allocates nothing and returns cudaGetLastError() as an
// int (0 = launched).
//
// Preconditions, checked by the Python wrapper: bits i32 [U8, W] with
// W % 4 == 0 and W / 4 <= 65535 * 256; cidx and cflags i32 [Q, Tq]; qmode
// and hits i32 [Q]; all contiguous on one device; Q, Tq >= 1;
// 1 <= qpb and (2 * qpb * Tq + 2 * qpb) * 4 <= 48 KB. Index values are the
// caller's contract: 0 <= cidx < U8.
extern "C" int diagon_bits_hits(const int32_t* bits, const int32_t* cidx,
                                const int32_t* cflags, const int32_t* qmode,
                                int32_t* hits, int64_t W, int Q, int Tq,
                                int qpb, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(hits, 0, sizeof(int32_t) * (size_t)Q, stream);
  if (err != cudaSuccess) return (int)err;
  const int64_t W4 = W / kWordsPerThread;
  const dim3 grid((unsigned)((Q + qpb - 1) / qpb),
                  (unsigned)((W4 + kThreads - 1) / kThreads));
  const size_t shmem = sizeof(int32_t) * (size_t)(2 * qpb * Tq + 2 * qpb);
  bits_hits_kernel<<<grid, kThreads, shmem, stream>>>(
      reinterpret_cast<const uint4*>(bits), cidx, cflags, qmode, hits, W4, Q,
      Tq, qpb);
  return (int)cudaGetLastError();
}
