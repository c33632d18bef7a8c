// Phase-2 rescore for Hopper (sm_90a): the exact rescore of each query's
// selected 128-doc tiles from the batch-compact bank, pure-OR and boolean
// forms, in two kernels with one contract.
//
// gather_rescore_kernel (B6) replaces diagon_tpu/ops/pallas/gather_rescore.py
// pallas_gather_rescore (_mk_kernel_resident :102, _mk_kernel :45);
// union_rescore_kernel (B7) replaces pallas_union_rescore (_mk_union_kernel
// :192), whose (query, tile) pairs are sorted by tile so that each distinct
// tile's slab is read once.
//
// What it computes. compact_t is the tile-major f32 compact bank
// [G, U8, 128]: tile g of row u is one contiguous 512-byte lane row. For query
// q and its b-th selected tile g = tsel[q, b], lane l, the score is
// sum over t of compact_t[g, cidx[q, t], l], taken as f32 adds from 0.0 in
// clause order t = 0..Tq-1 (cidx 0 is the zero row). That is the add sequence
// of the JAX kernel, the exhaustive kernels and the oracle, so the result is
// bit-identical to them. The boolean form adds the row to the score only
// where flags bit0 is set, and counts presence (row > 0) into the required /
// should / must_not lanes for bits 1, 2 and 3 (add_clause, shared by both
// kernels).
//
// One pair body for both: a warp a pair. Lane l holds lanes 4l..4l+3 of the
// tile, one 16-byte load per clause row, and a warp walks a stream of pairs
// with up to 8 clause rows in flight: it issues the loads of the next 8
// rows, of this pair or of the next one, before it adds the current 8, so
// loads stay in flight across pairs (rescore_pairs_warp). The clause rows
// and flags come from the block's staged copy in shared memory (one
// broadcast read a row). The two kernels differ only in how a block finds
// its pairs.
//
// B6 layout (gather_rescore_kernel). Block k of ops/gather_rescore.py
// gather_plan owns the run of ppb pairs [k * ppb, (k + 1) * ppb) of the
// flat (query, selected tile) order: one query's tiles, or the tail of one
// and the head of the next few. It stages that run's tsel slice and its
// queries' cidx (and flags) rows in shared memory once, and its 4 warps
// take the run's pairs in a strided loop. ppb is sized from the SM count so
// that about 4 blocks an SM hold the whole batch in one wave (no tail): 38
// pairs a block at Q 824, B 24 (521 blocks), one pair a block at Q 1, B 24
// (24 warps on 24 SMs). The TPU kernel's VMEM slab ring, double buffering
// and B-chunking have no counterpart: L1/L2 serve the repeated reads of a
// hot tile.
//
// Bound: bytes, and in practice L2 reads. Each pair reads Tq rows of 512
// bytes and writes 512 (x4 boolean): at Q 824, B 24, Tq 20 that is 202 MB
// of row reads, of which about 80 MB are distinct (tile, row) lanes, above
// the 50 MB L2; the bound counts the distinct ones once. The design keeps
// enough rows in flight on every SM for the L2 and HBM rates (4 blocks of 4
// warps, 8-16 rows of 512 bytes each a warp) and no block waits on a
// clause index in global memory. At the 10M entry (Q 811, B 152) the 1.26
// GB of row reads from the L2 set the time (about 5 TB/s); taking the pairs
// b-major, or by tile ranges as B7 does, found no reuse in L1 (PERF.md
// section 6).
//
// B7 layout (union_rescore_kernel): blocks own ranges of tiles and find
// their pairs themselves. Block (x, y) owns the tiles [x * tiles_per_block,
// ...) and the queries [y * q_per_block, ...) (ops/gather_rescore.py
// union_plan); it stages its queries' clause rows and flags in shared
// memory while its warps load their slices of the flat tsel (coalesced,
// L2-resident), ballot the pairs whose tile falls in the block's range, and
// feed each such pair to the shared warp body. Every pair falls in exactly
// one block, whatever the order of tsel, and is written to its own slot, so
// no order and no un-permute pass are needed.
// Why this and not a counting sort of the pairs by tile (a histogram, a scan
// and a scatter on the device, then the rescore): that is four launches and
// a memset, several microseconds of launch gaps in a call of about ten, to
// win an order whose use on this card is only reuse: a tile's rows come
// from HBM once and from the L2 (50 MB, far above a batch's touched rows)
// after that, whichever block reads them. The ranges keep the tiles a block
// touches together; grid.y splits the queries, so a tile that every query
// selects is spread over grid.y blocks instead of serialising one.
// What bounds B7: latency, not bytes. A warp takes the pairs of its slices
// one after another, so a block whose tile range a batch selects often
// finishes last (PERF.md section 6).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;
constexpr int kMaxGridY = 65535;
constexpr int kGatherWarps = 4;  // B6: warps a block
constexpr int kUnionWarps = 8;  // B7: warps a block
constexpr int kRowsInFlight = 8;  // clause rows a warp loads before adding
constexpr int64_t kDefaultSmem = 48 * 1024;  // a block's without opting in
constexpr int64_t kMaxSmem = 232448;  // a block's dynamic shared memory, max

// One clause into the pair's sums at one lane: the score row where flags
// bit0 is set; presence (row > 0) into the required / should / must_not
// counts for bits 1, 2, 3. Adding 0.0 to a sum leaves its bits.
__device__ __forceinline__ void add_clause(float& s, float& r, float& o,
                                           float& n, float row, int fl) {
  const float pres = row > 0.f ? 1.f : 0.f;
  s = __fadd_rn(s, (fl & 1) ? row : 0.f);
  r = __fadd_rn(r, (fl & 2) ? pres : 0.f);
  o = __fadd_rn(o, (fl & 4) ? pres : 0.f);
  n = __fadd_rn(n, (fl & 8) ? pres : 0.f);
}

// A (query, tile) pair as the warp body takes it: tile g, output slot p of
// the [Q * B, 128] planes, and the query's clause rows and flags in the
// block's shared memory.
struct Pair {
  int64_t g;
  int64_t p;
  const int32_t* cq;
  const int32_t* fq;
};

// Loads clause rows t1 .. t1 + kRowsInFlight - 1 (those below Tq) of pair
// pr at the warp's lane: one float4 of each row.
__device__ __forceinline__ void load_rows(float4 (&row)[kRowsInFlight],
                                          const float* __restrict__ compact_t,
                                          const Pair& pr, int t1, int lane,
                                          int U8, int Tq) {
  const float4* slab =
      reinterpret_cast<const float4*>(compact_t + pr.g * U8 * kLane) + lane;
#pragma unroll
  for (int i = 0; i < kRowsInFlight; ++i) {
    if (t1 + i < Tq) row[i] = __ldg(slab + (int64_t)pr.cq[t1 + i] * (kLane / 4));
  }
}

// Adds the loaded rows t1 .. of pair pr to the lane's sums, in clause
// order, as sequential f32 adds.
template <bool BOOL>
__device__ __forceinline__ void add_rows(const float4 (&row)[kRowsInFlight],
                                         const Pair& pr, int t1, int Tq,
                                         float4& s, float4& r, float4& o,
                                         float4& n) {
#pragma unroll
  for (int i = 0; i < kRowsInFlight; ++i) {
    if (t1 + i >= Tq) break;
    if (BOOL) {
      const int fl = pr.fq[t1 + i];
      add_clause(s.x, r.x, o.x, n.x, row[i].x, fl);
      add_clause(s.y, r.y, o.y, n.y, row[i].y, fl);
      add_clause(s.z, r.z, o.z, n.z, row[i].z, fl);
      add_clause(s.w, r.w, o.w, n.w, row[i].w, fl);
    } else {
      s.x = __fadd_rn(s.x, row[i].x);
      s.y = __fadd_rn(s.y, row[i].y);
      s.z = __fadd_rn(s.z, row[i].z);
      s.w = __fadd_rn(s.w, row[i].w);
    }
  }
}

// The exact rescore, with one warp, of every pair that next(Pair&) yields
// (warp-uniform; false ends the stream): sequential f32 adds in clause
// order from 0.0, written to the pair's slot with streaming float4 stores.
// The rows go by in chunks of kRowsInFlight; the next chunk's loads (the
// pair's next rows or the next pair's first ones) are issued before the
// current chunk's adds.
template <bool BOOL, class Next>
__device__ __forceinline__ void rescore_pairs_warp(
    const float* __restrict__ compact_t, float* __restrict__ out,
    int64_t plane, int lane, int U8, int Tq, Next&& next) {
  Pair cur;
  if (!next(cur)) return;
  float4 row[kRowsInFlight];
  load_rows(row, compact_t, cur, 0, lane, U8, Tq);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 s = zero, r = zero, o = zero, n = zero;
  for (int t1 = 0;;) {
    Pair nxt = cur;
    int u1 = t1 + kRowsInFlight;
    const bool last = u1 >= Tq;  // the pair's last chunk
    bool more = true;
    if (last) {
      more = next(nxt);
      u1 = 0;
    }
    float4 ahead[kRowsInFlight];
    if (more) load_rows(ahead, compact_t, nxt, u1, lane, U8, Tq);
    add_rows<BOOL>(row, cur, t1, Tq, s, r, o, n);
    if (last) {
      float4* at = reinterpret_cast<float4*>(out + cur.p * kLane) + lane;
      __stcs(at, s);
      if (BOOL) {
        __stcs(at + plane / 4, r);
        __stcs(at + 2 * (plane / 4), o);
        __stcs(at + 3 * (plane / 4), n);
      }
      s = r = o = n = zero;
    }
    if (!more) break;
    cur = nxt;
    t1 = u1;
#pragma unroll
    for (int i = 0; i < kRowsInFlight; ++i) row[i] = ahead[i];
  }
}

// Block k rescores the flat pairs [k * ppb, k * ppb + n) of the [Q, B]
// selection (n = ppb but in the last block). It stages the run's tsel slice
// and the cidx rows (and flags) of the queries the run touches, then warp w
// takes the run's pairs w, w + kGatherWarps, ...
//
// Dynamic shared memory: nq * Tq clause rows, (boolean) nq * Tq flags, then
// ppb tiles, where nq <= ceil((ppb - 1) / B) + 1 is the number of queries
// the run touches.
template <bool BOOL>
__global__ void __launch_bounds__(32 * kGatherWarps, 4) gather_rescore_kernel(
    const float* __restrict__ compact_t, const int32_t* __restrict__ cidx,
    const int32_t* __restrict__ tsel, const int32_t* __restrict__ flags,
    float* __restrict__ out, int U8, int Q, int Tq, int B, int ppb) {
  extern __shared__ int32_t s_meta[];
  const int lane = threadIdx.x & 31;
  const int64_t P = (int64_t)Q * B;
  const int64_t p0 = (int64_t)blockIdx.x * ppb;
  const int n = (int)(P - p0 < ppb ? P - p0 : ppb);
  const int64_t qa = p0 / B;  // the run's first query
  const int nq = (int)((p0 + n - 1) / B - qa + 1);
  int32_t* s_flags = s_meta + nq * Tq;
  int32_t* s_tsel = s_flags + (BOOL ? nq * Tq : 0);
  for (int i = threadIdx.x; i < nq * Tq; i += blockDim.x) {
    s_meta[i] = __ldg(cidx + qa * Tq + i);
    if (BOOL) s_flags[i] = __ldg(flags + qa * Tq + i);
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s_tsel[i] = __ldg(tsel + p0 + i);
  }
  __syncthreads();
  int i = threadIdx.x >> 5;
  rescore_pairs_warp<BOOL>(
      compact_t, out, P * kLane, lane, U8, Tq, [&](Pair& pr) {
        if (i >= n) return false;
        const int64_t p = p0 + i;
        const int row = (int)(p / B - qa) * Tq;
        pr.g = s_tsel[i];
        pr.p = p;
        pr.cq = s_meta + row;
        pr.fq = s_flags + row;
        i += kGatherWarps;
        return true;
      });
}

// Block (x, y) rescores the pairs (q, b) with tsel[q, b] in [x * tpb,
// (x + 1) * tpb) and q in [y * qpb, (y + 1) * qpb). It stages its queries'
// clause rows (and flags) in shared memory while each warp loads its first
// 32-pair slice of tsel, so a pair then waits on one global load, its rows.
// Warp w scans the slices w, w + kUnionWarps, ... of the block's pairs: it
// ballots a slice, loads the next one at once, and hands the pairs its
// ballot found to the warp body in slice order.
//
// Dynamic shared memory: qpb * Tq clause rows, then (boolean) qpb * Tq flags.
template <bool BOOL>
__global__ void __launch_bounds__(32 * kUnionWarps) union_rescore_kernel(
    const float* __restrict__ compact_t, const int32_t* __restrict__ cidx,
    const int32_t* __restrict__ tsel, const int32_t* __restrict__ flags,
    float* __restrict__ out, int U8, int Q, int Tq, int B, int tpb,
    int qpb) {
  extern __shared__ int32_t s_meta[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t g0 = (int64_t)blockIdx.x * tpb;
  const int64_t plane = (int64_t)Q * B * kLane;
  const int64_t q0 = (int64_t)blockIdx.y * qpb;
  const int nq = (int)(q0 + qpb < Q ? qpb : Q - q0);
  const int64_t p_end = (q0 + nq) * B;
  int32_t* s_flags = s_meta + qpb * Tq;
  int64_t nb = q0 * B + 32 * warp;  // the slice g holds
  int g = nb + lane < p_end ? __ldg(tsel + nb + lane) : -1;
  for (int i = threadIdx.x; i < nq * Tq; i += blockDim.x) {
    s_meta[i] = __ldg(cidx + q0 * Tq + i);
    if (BOOL) s_flags[i] = __ldg(flags + q0 * Tq + i);
  }
  __syncthreads();
  unsigned mine = 0;  // the block's pairs of the slice at base, not taken
  int64_t base = 0;
  int gp = -1;
  rescore_pairs_warp<BOOL>(
      compact_t, out, plane, lane, U8, Tq, [&](Pair& pr) {
        while (!mine) {
          if (nb >= p_end) return false;
          mine = __ballot_sync(0xffffffffu, g >= g0 && g < g0 + tpb);
          gp = g;
          base = nb;
          nb += 32 * kUnionWarps;
          g = nb + lane < p_end ? __ldg(tsel + nb + lane) : -1;
        }
        const int j = __ffs(mine) - 1;
        mine &= mine - 1;
        pr.g = __shfl_sync(0xffffffffu, gp, j);
        pr.p = base + j;
        const int row = (int)(pr.p / B - q0) * Tq;
        pr.cq = s_meta + row;
        pr.fq = s_flags + row;
        return true;
      });
}

}  // namespace

// Launchers: plain C interface for ctypes; runs on the given stream,
// allocates nothing, returns cudaGetLastError() (0 = launched).
//
// Preconditions, checked by the Python wrapper: all tensors contiguous on one
// device; compact_t f32 [G, U8, 128] and out 16-byte aligned; cidx i32
// [Q, Tq] with 0 <= cidx < U8; tsel i32 [Q, B] with 0 <= tsel < G; flags
// i32 [Q, Tq] or null for the pure-OR form; out f32 [Q, B, 128], or
// [4, Q, B, 128] (score, required, should, must_not) with flags; Q, Tq,
// B >= 1.
//
// B6: ppb pairs a block (ops/gather_rescore.py gather_plan), so
// ceil(Q * B / ppb) blocks, and the run's staged rows and tiles within a
// block's shared memory.
extern "C" int diagon_gather_rescore(const float* compact_t,
                                     const int32_t* cidx,
                                     const int32_t* tsel,
                                     const int32_t* flags, float* out, int U8,
                                     int Q, int Tq, int B, int ppb,
                                     cudaStream_t stream) {
  if (ppb < 1) return (int)cudaErrorInvalidValue;
  const int64_t P = (int64_t)Q * B;
  const int64_t nq = (ppb - 1 + (int64_t)B - 1) / B + 1;
  const int64_t smem =
      (nq * Tq * (flags == nullptr ? 1 : 2) + ppb) * (int64_t)sizeof(int32_t);
  const int64_t blocks = (P + ppb - 1) / ppb;
  if (smem > kMaxSmem || blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  auto* kernel = flags == nullptr ? gather_rescore_kernel<false>
                                  : gather_rescore_kernel<true>;
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)blocks, 32 * kGatherWarps, (size_t)smem, stream>>>(
      compact_t, cidx, tsel, flags, out, U8, Q, Tq, B, ppb);
  return (int)cudaGetLastError();
}

// B7 launcher: the preconditions above, plus the plan of
// ops/gather_rescore.py union_plan: tpb tiles and qpb queries a block, so
// ceil(G / tpb) x ceil(Q / qpb) blocks, at most 65535 along y, and qpb * Tq
// clause entries a block stages (twice with flags) within its shared
// memory. One launch, no scratch.
extern "C" int diagon_union_rescore(const float* compact_t,
                                    const int32_t* cidx, const int32_t* tsel,
                                    const int32_t* flags, float* out, int G,
                                    int U8, int Q, int Tq, int B, int tpb,
                                    int qpb, cudaStream_t stream) {
  if (tpb < 1 || qpb < 1) return (int)cudaErrorInvalidValue;
  const int64_t gy = ((int64_t)Q + qpb - 1) / qpb;
  const int64_t smem =
      (int64_t)qpb * Tq * (flags == nullptr ? 1 : 2) * sizeof(int32_t);
  if (gy > kMaxGridY || smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((G + tpb - 1) / tpb), (unsigned)gy);
  auto* kernel = flags == nullptr ? union_rescore_kernel<false>
                                  : union_rescore_kernel<true>;
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, 32 * kUnionWarps, (size_t)smem, stream>>>(
      compact_t, cidx, tsel, flags, out, U8, Q, Tq, B, tpb, qpb);
  return (int)cudaGetLastError();
}
