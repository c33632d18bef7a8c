// Phase-2 rescore for Hopper (sm_90a): the exact rescore of each query's
// selected 128-doc tiles from the batch-compact bank, pure-OR and boolean
// forms, in two kernels with one contract.
//
// gather_rescore_kernel (B6) replaces diagon_tpu/ops/pallas/gather_rescore.py
// pallas_gather_rescore (_mk_kernel_resident, _mk_kernel); union_rescore_kernel
// (B7) replaces pallas_union_rescore (_mk_union_kernel). B7 walks the
// (query, tile) pairs sorted by tile, so a block's pairs share tiles and each
// distinct tile's rows come from memory once and are reused out of L1.
//
// What it computes. compact_t is the tile-major f32 compact bank
// [G, U8, 128]: tile g of row u is one contiguous 512-byte lane row. For query
// q and its b-th selected tile g = tsel[q, b], lane l, the score is
// sum over t of compact_t[g, cidx[q, t], l], taken as f32 adds from 0.0 in
// clause order t = 0..Tq-1 (cidx 0 is the zero row). That is the add sequence
// of the JAX kernel, the exhaustive kernels and the oracle, so the result is
// bit-identical to them. The boolean form adds the row to the score only
// where flags bit0 is set, and counts presence (row > 0) into the required /
// should / must_not lanes for bits 1, 2 and 3.
//
// Layout. A block owns one (query, selected tile) pair, one thread per lane:
// each clause is one coalesced 512-byte read, and the lane's sums stay in
// registers. grid.x walks the selected tiles, grid.y the queries (strided, so
// any Q fits the 65535 limit on gridDim.y). The TPU kernel's VMEM slab ring,
// double buffering and B-chunking have no counterpart: L1/L2 serve the
// repeated reads of a hot tile.
//
// Bound: bytes. Q * B * Tq * 512 bytes of reads and Q * B * 512 bytes of
// writes (x4 boolean); at Q = 1024, B = 24, Tq = 20 that is 252 MB of reads,
// much of it L2 hits because a batch selects the same hot tiles many times.
//
// B7 layout. The caller sorts the Q * B pairs by tile (a stable sort of the
// flattened tsel) and passes `order`, sorted position -> original pair. A
// block of one thread per lane takes kUnionPairs consecutive sorted pairs:
// pairs of one tile follow each other, so the rows they share are read from
// L2/HBM once and from L1 after that. Each pair writes its lanes straight to
// its original position, so no un-permute pass follows. The TPU kernel's
// slab ring and per-step DMA issue ranges have no counterpart.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;
constexpr int kMaxGridY = 65535;
constexpr int kUnionPairs = 8;  // sorted pairs per block (the TPU's UNION_PB)

// The exact rescore of one (query q, tile g) pair at lane l, written to pair
// slot p of the [Q * B, 128] output planes: sequential f32 adds in clause
// order from 0.0, the same adds in both kernels.
template <bool BOOL>
__device__ __forceinline__ void rescore_pair(
    const float* __restrict__ compact_t, const int32_t* __restrict__ cidx,
    const int32_t* __restrict__ flags, float* __restrict__ out, int64_t q,
    int64_t g, int64_t p, int64_t plane, int l, int U8, int Tq) {
  const float* slab = compact_t + g * U8 * kLane + l;
  const int32_t* cq = cidx + q * Tq;
  float s = 0.f, r = 0.f, o = 0.f, n = 0.f;
  for (int t = 0; t < Tq; ++t) {
    const float row = __ldg(slab + (int64_t)__ldg(cq + t) * kLane);
    if (BOOL) {
      const int fl = __ldg(flags + q * Tq + t);
      const float pres = row > 0.f ? 1.f : 0.f;
      s = __fadd_rn(s, (fl & 1) ? row : 0.f);
      r = __fadd_rn(r, (fl & 2) ? pres : 0.f);
      o = __fadd_rn(o, (fl & 4) ? pres : 0.f);
      n = __fadd_rn(n, (fl & 8) ? pres : 0.f);
    } else {
      s = __fadd_rn(s, row);
    }
  }
  const int64_t at = p * kLane + l;
  out[at] = s;
  if (BOOL) {
    out[plane + at] = r;
    out[2 * plane + at] = o;
    out[3 * plane + at] = n;
  }
}

template <bool BOOL>
__global__ void __launch_bounds__(kLane) gather_rescore_kernel(
    const float* __restrict__ compact_t, const int32_t* __restrict__ cidx,
    const int32_t* __restrict__ tsel, const int32_t* __restrict__ flags,
    float* __restrict__ out, int U8, int Q, int Tq, int B) {
  const int b = blockIdx.x;
  const int64_t plane = (int64_t)Q * B * kLane;
  for (int q = blockIdx.y; q < Q; q += gridDim.y) {
    const int64_t p = (int64_t)q * B + b;
    rescore_pair<BOOL>(compact_t, cidx, flags, out, q, __ldg(tsel + p), p,
                       plane, threadIdx.x, U8, Tq);
  }
}

template <bool BOOL>
__global__ void __launch_bounds__(kLane) union_rescore_kernel(
    const float* __restrict__ compact_t, const int32_t* __restrict__ cidx,
    const int32_t* __restrict__ tsel, const int32_t* __restrict__ flags,
    const int32_t* __restrict__ order, float* __restrict__ out, int U8, int Q,
    int Tq, int B) {
  const int64_t P = (int64_t)Q * B;
  const int64_t plane = P * kLane;
  const int64_t j0 = (int64_t)blockIdx.x * kUnionPairs;
  const int64_t j1 = j0 + kUnionPairs < P ? j0 + kUnionPairs : P;
  for (int64_t j = j0; j < j1; ++j) {
    const int64_t p = __ldg(order + j);
    rescore_pair<BOOL>(compact_t, cidx, flags, out, p / B, __ldg(tsel + p), p,
                       plane, threadIdx.x, U8, Tq);
  }
}

}  // namespace

// Launcher: plain C interface for ctypes; runs on the given stream, allocates
// nothing, returns cudaGetLastError() (0 = launched).
//
// Preconditions, checked by the Python wrapper: all tensors contiguous on one
// device; compact_t f32 [G, U8, 128]; cidx i32 [Q, Tq] with 0 <= cidx < U8;
// tsel i32 [Q, B] with 0 <= tsel < G; flags i32 [Q, Tq] or null for the
// pure-OR form; out f32 [Q, B, 128], or [4, Q, B, 128] (score, required,
// should, must_not) with flags; Q, Tq, B >= 1.
extern "C" int diagon_gather_rescore(const float* compact_t,
                                     const int32_t* cidx,
                                     const int32_t* tsel,
                                     const int32_t* flags, float* out, int U8,
                                     int Q, int Tq, int B,
                                     cudaStream_t stream) {
  const dim3 grid((unsigned)B, (unsigned)(Q < kMaxGridY ? Q : kMaxGridY));
  if (flags == nullptr) {
    gather_rescore_kernel<false><<<grid, kLane, 0, stream>>>(
        compact_t, cidx, tsel, flags, out, U8, Q, Tq, B);
  } else {
    gather_rescore_kernel<true><<<grid, kLane, 0, stream>>>(
        compact_t, cidx, tsel, flags, out, U8, Q, Tq, B);
  }
  return (int)cudaGetLastError();
}

// B7 launcher: the preconditions of diagon_gather_rescore, plus order i32
// [Q * B], a permutation of the pairs that lists them sorted by tile (the
// result does not depend on it; the reuse of rows does).
extern "C" int diagon_union_rescore(const float* compact_t,
                                    const int32_t* cidx, const int32_t* tsel,
                                    const int32_t* flags,
                                    const int32_t* order, float* out, int U8,
                                    int Q, int Tq, int B,
                                    cudaStream_t stream) {
  const int64_t P = (int64_t)Q * B;
  const dim3 grid((unsigned)((P + kUnionPairs - 1) / kUnionPairs));
  if (flags == nullptr) {
    union_rescore_kernel<false><<<grid, kLane, 0, stream>>>(
        compact_t, cidx, tsel, flags, order, out, U8, Q, Tq, B);
  } else {
    union_rescore_kernel<true><<<grid, kLane, 0, stream>>>(
        compact_t, cidx, tsel, flags, order, out, U8, Q, Tq, B);
  }
  return (int)cudaGetLastError();
}
