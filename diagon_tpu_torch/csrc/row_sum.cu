// Exhaustive row-sum kernels for Hopper (sm_90a): the pure-OR row sum and
// the general boolean row sum with MUST/SHOULD/MUST_NOT counts.
//
// Replaces diagon_tpu/ops/pallas/row_sum.py: pallas_row_sum (_kernel) and
// pallas_row_boolean (_kernel_boolean).
//
// What they compute. Query q's clause t selects one dense f32 row over the
// padded doc axis: heavy[hidx[q, t]] when hidx >= 0, else light[lidx[q, t]]
// (light row 0 is all zero). The score is the sum of the rows, taken as one
// f32 add per clause in clause order t = 0..Tq-1, the first clause being
// copied rather than added to a zero. That is the add sequence of the JAX
// scan, the Pallas kernel and the host oracle, so results are bit-identical
// to them, not merely close. No multiply touches the score path (the build
// passes --fmad=false regardless).
//
// Boolean flags per clause: bit0 scoring, bit1 required, bit2 should, bit3
// must_not. The boolean kernel keeps four accumulators: the score of the
// scoring clauses and the required/should/must_not counts of row > 0, which
// are exact 0/1 sums in f32.
//
// Layout. A block owns one query and a span of docs; a thread owns 4
// consecutive docs read and written as float4 (D % 1024 == 0, so every row
// starts 16-byte aligned). Nothing carries between blocks, so no atomics.
// The grid is (blocks along docs, min(Q, 65535) query slots); a block strides
// over queries past that limit, and block_slot says which block takes what.
//
// Bound: bytes. The kernel reads Q*Tq*D*4 bytes of rows and writes Q*D*4
// (x4 for the boolean kernel) with one add per element read. The heavy bank
// is shared across queries, so at serving sizes (tens of MB) the repeated
// row reads of a batch hit the 50 MB L2 rather than HBM.
//
// B1's design for this card. On the main path B1 mostly runs one query over
// a 19,456-doc axis (an or20 plan): 1.6 MB of row reads, a few microseconds
// of memory time, so what bounds it is latency and how much of the card it
// fills, not bandwidth. Three things follow:
//   - the block stages its query's clause indices once, resolved to row
//     pointers in shared memory (one coalesced read; no thread re-reads an
//     index from global memory before each row load);
//   - a thread issues the row loads of kGroup clauses back to back, then
//     adds them in clause order, so up to kGroup independent 16-byte loads
//     are in flight instead of one;
//   - the caller picks the block size from Q * D and the SM count
//     (ops/row_sum.py launch_geometry): 32-thread blocks at Q = 1 spread the
//     4,864 float4 columns over 152 blocks, where 256-thread blocks gave 19.
// B2 has the same three parts. Its block also stages each clause's flags
// beside the row pointer, so no thread reads an index or a flag from global
// memory before a row load, and up to kGroup row loads are in flight where
// the first layout had one dependent load per clause, 20 in series. A
// query's clause flags are the same for every thread of its block, so the
// four accumulators take block-uniform branches: a clause adds only into the
// planes of the roles it has (a role it lacks costs no arithmetic, and a
// plane no clause feeds is written as the zeros it started from). Skipping
// the add of a +0 changes no bit: the rows hold no negative value and no -0,
// each plane starts at +0, x + 0 = x, and 0 + x = x is also what copying the
// first clause gives. The four planes are written once and read once by the
// caller, so they are stored streaming (__stcs) and leave the L2 to the bank
// rows. What bounds B2 is the write of the planes (4 Q D f32) and, where a
// batch reads each row many times, the L2's read rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // the largest block
constexpr int kMaxGridY = 65535;
constexpr int kStage = 64;  // clause row pointers (B2: and flags) staged per pass
constexpr int kGroup = 8;   // row loads in flight per thread

__device__ __forceinline__ const float4* clause_row(
    const float* __restrict__ heavy, const float* __restrict__ light,
    int hi, int li, int64_t D) {
  const float* base = hi >= 0 ? heavy + (int64_t)hi * D : light + (int64_t)li * D;
  return reinterpret_cast<const float4*>(base);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float4 present4(float4 v) {
  return make_float4(v.x > 0.f ? 1.f : 0.f, v.y > 0.f ? 1.f : 0.f,
                     v.z > 0.f ? 1.f : 0.f, v.w > 0.f ? 1.f : 0.f);
}

// The block's first query and its thread's float4 column. Blocks start in
// linear order, x fastest; numbering them with the query fastest puts the
// blocks that run together on one span of docs, so the span of a row that
// several queries read comes from HBM once and from the L2 after that; with
// the docs fastest, a batch over a bank beyond the L2 streams every row again
// for every query.
__device__ __forceinline__ void block_slot(int& q0, int64_t& d4) {
  const uint64_t lin = (uint64_t)blockIdx.y * gridDim.x + blockIdx.x;
  q0 = (int)(lin % gridDim.y);
  d4 = (int64_t)(lin / gridDim.y) * blockDim.x + threadIdx.x;
}

// Any blockDim.x in {32, 64, 128, 256}; every thread reaches every barrier.
__global__ void __launch_bounds__(kThreads) row_sum_kernel(
    const float* __restrict__ heavy, const float* __restrict__ light,
    const int32_t* __restrict__ hidx, const int32_t* __restrict__ lidx,
    float* __restrict__ out, int Q, int Tq, int64_t D) {
  __shared__ const float4* s_row[kStage];
  int q0;
  int64_t d4;
  block_slot(q0, d4);
  const bool active = d4 * 4 < D;
  for (int q = q0; q < Q; q += gridDim.y) {
    const int32_t* hq = hidx + (int64_t)q * Tq;
    const int32_t* lq = lidx + (int64_t)q * Tq;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    bool first = true;  // clause 0 is copied, not added to a zero
    for (int t0 = 0; t0 < Tq; t0 += kStage) {
      const int n = min(kStage, Tq - t0);
      __syncthreads();  // the previous pass has read its pointers
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        s_row[i] = clause_row(heavy, light, hq[t0 + i], lq[t0 + i], D);
      }
      __syncthreads();
      if (!active) continue;
      int i = 0;
      for (; i + kGroup <= n; i += kGroup) {
        float4 r[kGroup];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) r[j] = __ldg(s_row[i + j] + d4);
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          acc = first ? r[j] : add4(acc, r[j]);
          first = false;
        }
      }
      for (; i < n; ++i) {
        const float4 r = __ldg(s_row[i] + d4);
        acc = first ? r : add4(acc, r);
        first = false;
      }
    }
    if (active) reinterpret_cast<float4*>(out + (int64_t)q * D)[d4] = acc;
  }
}

__device__ __forceinline__ void stcs4(float* plane, int64_t d4, float4 v) {
  __stcs(reinterpret_cast<float4*>(plane) + d4, v);
}

// One clause into the four planes, by its flags (uniform over the block).
__device__ __forceinline__ void add_clause(int fl, bool first, float4 row,
                                           float4& s, float4& r, float4& o,
                                           float4& n) {
  if (fl & 1) s = first ? row : add4(s, row);  // clause 0 is copied
  if (fl & 14) {
    const float4 pres = present4(row);
    if (fl & 2) r = add4(r, pres);
    if (fl & 4) o = add4(o, pres);
    if (fl & 8) n = add4(n, pres);
  }
}

// Any blockDim.x in {32, 64, 128, 256}; every thread reaches every barrier.
__global__ void __launch_bounds__(kThreads) row_boolean_kernel(
    const float* __restrict__ heavy, const float* __restrict__ light,
    const int32_t* __restrict__ hidx, const int32_t* __restrict__ lidx,
    const int32_t* __restrict__ flags, float* __restrict__ out, int Q,
    int Tq, int64_t D) {
  __shared__ const float4* s_row[kStage];
  __shared__ int s_flag[kStage];
  int q0;
  int64_t d4;
  block_slot(q0, d4);
  const bool active = d4 * 4 < D;
  const int64_t plane = (int64_t)Q * D;
  for (int q = q0; q < Q; q += gridDim.y) {
    const int32_t* hq = hidx + (int64_t)q * Tq;
    const int32_t* lq = lidx + (int64_t)q * Tq;
    const int32_t* fq = flags + (int64_t)q * Tq;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 s = zero, r = zero, o = zero, n = zero;
    for (int t0 = 0; t0 < Tq; t0 += kStage) {
      const int m = min(kStage, Tq - t0);
      __syncthreads();  // the previous pass has read its pointers and flags
      for (int i = threadIdx.x; i < m; i += blockDim.x) {
        s_row[i] = clause_row(heavy, light, hq[t0 + i], lq[t0 + i], D);
        s_flag[i] = fq[t0 + i];
      }
      __syncthreads();
      if (!active) continue;
      int i = 0;
      for (; i + kGroup <= m; i += kGroup) {
        float4 row[kGroup];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) row[j] = __ldg(s_row[i + j] + d4);
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          add_clause(s_flag[i + j], t0 + i + j == 0, row[j], s, r, o, n);
        }
      }
      for (; i < m; ++i) {
        add_clause(s_flag[i], t0 + i == 0, __ldg(s_row[i] + d4), s, r, o, n);
      }
    }
    if (active) {
      float* oq = out + (int64_t)q * D;
      stcs4(oq, d4, s);
      stcs4(oq + plane, d4, r);
      stcs4(oq + 2 * plane, d4, o);
      stcs4(oq + 3 * plane, d4, n);
    }
  }
}

// threads: 32, 64, 128 or 256 (ops/row_sum.py launch_geometry)
bool block_ok(int threads) {
  return threads == 32 || threads == 64 || threads == 128 || threads == 256;
}

dim3 grid_for(int Q, int64_t D, int threads) {
  return dim3((unsigned)(D / 4 / threads),
              (unsigned)(Q < kMaxGridY ? Q : kMaxGridY));
}

}  // namespace

// Launchers: plain C interface for ctypes. Each runs on the given stream,
// allocates nothing (the caller owns every buffer) and returns
// cudaGetLastError() as an int (0 = launched).
//
// Preconditions, checked by the Python wrapper: all tensors contiguous on
// one device; heavy f32 [H, D], light f32 [L, D], hidx/lidx/flags i32
// [Q, Tq]; D % 1024 == 0; Q >= 1, Tq >= 1. Index values are the caller's
// contract: -1 <= hidx < H and 0 <= lidx < L.

// threads: the block size, 32, 64, 128 or 256 (ops/row_sum.py
// launch_geometry); any other value is refused with cudaErrorInvalidValue.
extern "C" int diagon_row_sum(const float* heavy, const float* light,
                              const int32_t* hidx, const int32_t* lidx,
                              float* out, int Q, int Tq, int64_t D,
                              int threads, cudaStream_t stream) {
  if (!block_ok(threads)) return (int)cudaErrorInvalidValue;
  row_sum_kernel<<<grid_for(Q, D, threads), threads, 0, stream>>>(
      heavy, light, hidx, lidx, out, Q, Tq, D);
  return (int)cudaGetLastError();
}

// out: f32 [4, Q, D] = (score, required count, should count, must_not count)
extern "C" int diagon_row_boolean(const float* heavy, const float* light,
                                  const int32_t* hidx, const int32_t* lidx,
                                  const int32_t* flags, float* out, int Q,
                                  int Tq, int64_t D, int threads,
                                  cudaStream_t stream) {
  if (!block_ok(threads)) return (int)cudaErrorInvalidValue;
  row_boolean_kernel<<<grid_for(Q, D, threads), threads, 0, stream>>>(
      heavy, light, hidx, lidx, flags, out, Q, Tq, D);
  return (int)cudaGetLastError();
}
