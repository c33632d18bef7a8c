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
// B6 layout. A block owns one (query, selected tile) pair, one thread per
// lane: each clause is one coalesced 512-byte read, and the lane's sums stay
// in registers. grid.x walks the selected tiles, grid.y the queries (strided,
// so any Q fits the 65535 limit on gridDim.y). The TPU kernel's VMEM slab
// ring, double buffering and B-chunking have no counterpart: L1/L2 serve the
// repeated reads of a hot tile.
//
// Bound: bytes. Q * B * Tq * 512 bytes of reads and Q * B * 512 bytes of
// writes (x4 boolean); at Q = 1024, B = 24, Tq = 20 that is 252 MB of reads,
// much of it L2 hits because a batch selects the same hot tiles many times.
// Counted once per distinct (tile, row), as the bound does, it is a few MB.
//
// B7 layout: blocks own ranges of tiles and find their pairs themselves.
// Block (x, y) owns the tiles [x * tiles_per_block, ...) and the queries
// [y * q_per_block, ...) (ops/gather_rescore.py union_plan); it stages its
// queries' clause rows and flags in shared memory while its warps load their
// slices of the flat tsel (coalesced, L2-resident), ballot the pairs whose
// tile falls in the block's range, and rescore each such pair with the whole
// warp: lane l holds lanes 4l..4l+3 of the tile (one 16-byte load per clause
// row), up to 8 of the pair's rows are in flight before their adds, and the
// adds and stores are those of B6. Every pair
// falls in exactly one block, whatever the order of tsel, and is written to
// its own slot, so no order and no un-permute pass are needed.
// Why this and not a counting sort of the pairs by tile (a histogram, a scan
// and a scatter on the device, then the rescore): that is four launches and
// a memset, several microseconds of launch gaps in a call of about ten, to
// win an order whose use on this card is only reuse: a tile's rows come
// from HBM once and from the L2 (50 MB, far above a batch's touched rows)
// after that, whichever block reads them. The ranges keep the tiles a block
// touches together; grid.y splits the queries, so a tile that every query
// selects is spread over grid.y blocks instead of serialising one. The
// earlier B7 (one thread a lane, 8 sorted pairs a block in series, one
// 4-byte load a clause) took 0.020 ms of kernel and ~0.185 ms of torch.sort
// and casts in its wrapper at Q 200, Tq 4, B 24 over 1M docs on an H100 at
// 700 W (PERF.md, PR 5).
// What bounds B7 now: latency, not bytes. A block's first pair waits for its
// slice of tsel and its staged clause rows (loaded together), then for the
// pair's rows; a warp takes the pairs of its slice one after another, so a
// block whose tile range a batch selects often finishes last. B6, one block
// a pair, has no such tail: at the main-path shape its kernel alone is the
// faster of the two, and B7's whole call the faster (PERF.md, PR 6).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;
constexpr int kMaxGridY = 65535;
constexpr int kUnionWarps = 8;  // B7: warps a block
constexpr int kRowsInFlight = 8;  // B7: clause rows a warp loads before adding
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

// The exact rescore of one (query q, tile g) pair at lane l, written to pair
// slot p of the [Q * B, 128] output planes: sequential f32 adds in clause
// order from 0.0.
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
      add_clause(s, r, o, n, row, __ldg(flags + q * Tq + t));
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

// rescore_pair with a warp: lane holds lanes 4 lane .. 4 lane + 3, one
// float4 of each clause row; the pair's clause rows cq and flags fq (the
// block's staged copy) come into the lanes 32 at a time and go round by
// shuffles, and kRowsInFlight rows are loaded before their adds. The adds per
// lane are rescore_pair's.
template <bool BOOL>
__device__ __forceinline__ void rescore_pair_warp(
    const float* __restrict__ compact_t, const int32_t* cq, const int32_t* fq,
    float* __restrict__ out, int64_t g, int64_t p, int64_t plane, int lane,
    int U8, int Tq) {
  const float4* slab =
      reinterpret_cast<const float4*>(compact_t + g * U8 * kLane) + lane;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f), r = s, o = s, n = s;
  for (int t0 = 0; t0 < Tq; t0 += 32) {
    const int nt = min(32, Tq - t0);  // the same in every lane
    const int ci = lane < nt ? cq[t0 + lane] : 0;
    const int fi = BOOL && lane < nt ? fq[t0 + lane] : 0;
    for (int t1 = 0; t1 < nt; t1 += kRowsInFlight) {
      float4 row[kRowsInFlight];
#pragma unroll
      for (int i = 0; i < kRowsInFlight; ++i) {
        const int c = __shfl_sync(0xffffffffu, ci, t1 + i);
        if (t1 + i < nt) row[i] = __ldg(slab + (int64_t)c * (kLane / 4));
      }
#pragma unroll
      for (int i = 0; i < kRowsInFlight; ++i) {
        const int fl = __shfl_sync(0xffffffffu, fi, t1 + i);
        if (t1 + i >= nt) break;
        if (BOOL) {
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
  }
  float4* at = reinterpret_cast<float4*>(out + p * kLane) + lane;
  at[0] = s;
  if (BOOL) {
    at[plane / 4] = r;
    at[2 * (plane / 4)] = o;
    at[3 * (plane / 4)] = n;
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

// Block (x, y) rescores the pairs (q, b) with tsel[q, b] in [x * tpb,
// (x + 1) * tpb) and q in [y * qpb, (y + 1) * qpb). It stages its queries'
// clause rows (and flags) in shared memory while each warp loads its first
// 32-pair slice of tsel, so a pair then waits on one global load, its rows.
// Warp w scans the slices w, w + kUnionWarps, ... of the block's pairs, loads
// the next slice before it rescores the pairs its ballot found in this one,
// and takes those in slice order.
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
  int64_t base = q0 * B + 32 * warp;
  int g = base + lane < p_end ? __ldg(tsel + base + lane) : -1;
  for (int i = threadIdx.x; i < nq * Tq; i += blockDim.x) {
    s_meta[i] = __ldg(cidx + q0 * Tq + i);
    if (BOOL) s_flags[i] = __ldg(flags + q0 * Tq + i);
  }
  __syncthreads();
  for (; base < p_end; base += 32 * kUnionWarps) {
    unsigned mine = __ballot_sync(0xffffffffu, g >= g0 && g < g0 + tpb);
    const int gp = g;
    const int64_t nb = base + 32 * kUnionWarps;
    g = nb + lane < p_end ? __ldg(tsel + nb + lane) : -1;
    while (mine) {
      const int j = __ffs(mine) - 1;
      mine &= mine - 1;
      const int64_t pj = base + j;
      const int row = (int)(pj / B - q0) * Tq;
      rescore_pair_warp<BOOL>(compact_t, s_meta + row, s_flags + row, out,
                              __shfl_sync(0xffffffffu, gp, j), pj, plane,
                              lane, U8, Tq);
    }
  }
}

}  // namespace

// Launchers: plain C interface for ctypes; runs on the given stream,
// allocates nothing, returns cudaGetLastError() (0 = launched).
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

// B7 launcher: the preconditions of diagon_gather_rescore, plus compact_t and
// out 16-byte aligned, and the plan of ops/gather_rescore.py union_plan: tpb
// tiles and qpb queries a block, so ceil(G / tpb) x ceil(Q / qpb) blocks, at
// most 65535 along y, and qpb * Tq clause entries a block stages (twice with
// flags) within its shared memory. One launch, no scratch.
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
