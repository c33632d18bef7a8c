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
// grid.y strides over queries so any Q fits the 65535 limit on gridDim.y.
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
// B2 keeps the first layout (a 256-thread block, one dependent load per
// clause): it runs at Q = 1024, where the grid already fills the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // B2's block; B1's largest
constexpr int kMaxGridY = 65535;
constexpr int kStage = 64;  // B1: clause row pointers staged per pass
constexpr int kGroup = 8;   // B1: row loads in flight per thread

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

__device__ __forceinline__ float4 select4(bool on, float4 v) {
  return on ? v : make_float4(0.f, 0.f, 0.f, 0.f);
}

// Any blockDim.x in {32, 64, 128, 256}; every thread reaches every barrier.
__global__ void __launch_bounds__(kThreads) row_sum_kernel(
    const float* __restrict__ heavy, const float* __restrict__ light,
    const int32_t* __restrict__ hidx, const int32_t* __restrict__ lidx,
    float* __restrict__ out, int Q, int Tq, int64_t D) {
  __shared__ const float4* s_row[kStage];
  const int64_t d4 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = d4 * 4 < D;
  for (int q = blockIdx.y; q < Q; q += gridDim.y) {
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

__global__ void __launch_bounds__(kThreads) row_boolean_kernel(
    const float* __restrict__ heavy, const float* __restrict__ light,
    const int32_t* __restrict__ hidx, const int32_t* __restrict__ lidx,
    const int32_t* __restrict__ flags, float* __restrict__ out, int Q,
    int Tq, int64_t D) {
  const int64_t d4 = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (d4 * 4 >= D) return;
  const int64_t plane = (int64_t)Q * D;
  for (int q = blockIdx.y; q < Q; q += gridDim.y) {
    const int32_t* hq = hidx + (int64_t)q * Tq;
    const int32_t* lq = lidx + (int64_t)q * Tq;
    const int32_t* fq = flags + (int64_t)q * Tq;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 s = zero, r = zero, o = zero, n = zero;
    for (int t = 0; t < Tq; ++t) {
      const float4 row = __ldg(clause_row(heavy, light, hq[t], lq[t], D) + d4);
      const float4 pres = present4(row);
      const int fl = fq[t];
      const float4 sc = select4(fl & 1, row);
      const float4 rc = select4(fl & 2, pres);
      const float4 oc = select4(fl & 4, pres);
      const float4 nc = select4(fl & 8, pres);
      if (t == 0) {
        s = sc; r = rc; o = oc; n = nc;
      } else {
        s = add4(s, sc); r = add4(r, rc); o = add4(o, oc); n = add4(n, nc);
      }
    }
    const int64_t off = (int64_t)q * D;
    reinterpret_cast<float4*>(out + off)[d4] = s;
    reinterpret_cast<float4*>(out + plane + off)[d4] = r;
    reinterpret_cast<float4*>(out + 2 * plane + off)[d4] = o;
    reinterpret_cast<float4*>(out + 3 * plane + off)[d4] = n;
  }
}

dim3 grid_for(int Q, int64_t D) {
  const int64_t blocks_x = (D / 4 + kThreads - 1) / kThreads;
  return dim3((unsigned)blocks_x, (unsigned)(Q < kMaxGridY ? Q : kMaxGridY));
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

// threads: B1's block size, 32, 64, 128 or 256 (ops/row_sum.py
// launch_geometry); any other value is refused with cudaErrorInvalidValue.
extern "C" int diagon_row_sum(const float* heavy, const float* light,
                              const int32_t* hidx, const int32_t* lidx,
                              float* out, int Q, int Tq, int64_t D,
                              int threads, cudaStream_t stream) {
  if (threads != 32 && threads != 64 && threads != 128 && threads != 256) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)(D / 4 / threads),
                  (unsigned)(Q < kMaxGridY ? Q : kMaxGridY));
  row_sum_kernel<<<grid, threads, 0, stream>>>(heavy, light, hidx, lidx, out,
                                               Q, Tq, D);
  return (int)cudaGetLastError();
}

// out: f32 [4, Q, D] = (score, required count, should count, must_not count)
extern "C" int diagon_row_boolean(const float* heavy, const float* light,
                                  const int32_t* hidx, const int32_t* lidx,
                                  const int32_t* flags, float* out, int Q,
                                  int Tq, int64_t D, cudaStream_t stream) {
  row_boolean_kernel<<<grid_for(Q, D), kThreads, 0, stream>>>(
      heavy, light, hidx, lidx, flags, out, Q, Tq, D);
  return (int)cudaGetLastError();
}
