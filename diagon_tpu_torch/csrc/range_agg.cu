// Columnar range aggregate for Hopper (sm_90a): kernel X1, the granule skip,
// the row scan and the combine of one range query over a device table, in
// one launch.
//
// Replaces diagon_tpu/columnar/engine.py: _range_agg_kernel (with _lex_ge /
// _lex_le, _cnt2, _agg_block, _row_mask and _group_block), a jitted XLA
// program with no Pallas body.
//
// What it computes. A table of G granules of R rows. The filter column is
// three i32 planes of 16 bits each (an integer offset-encoded into a 48-bit
// range) or one f32 plane; so is the aggregate column. Per granule the
// filter's min and max (three planes or one). For bounds [lo, hi]:
//
//   gmask[g] = gmax[g] >= lo && gmin[g] <= hi           (the SKIP level)
//   row r of granule g counts iff valid && lo <= value <= hi && gmask[g]
//
// and the result is out[0:6] = [cnt_lo, cnt_hi, sum, min, max, granules
// scanned], as the JAX program packs it: the count as two exact 16-bit
// halves; the sum of the aggregate; its min and max; min(nsel, G) with nsel
// the number of granules gmask keeps. With a group column (low plane plus
// an offset) it also adds a count and a sum per group into out[6:6+N] and
// out[6+N:6+2N], N = num_groups, with the JAX program's index rule: its
// scatter into N + 1 slots (mode "drop") wraps a negative id before it
// drops anything, so an id in [-(N+1), -2] counts in group id + N + 1, and
// every other id outside [0, N) is dropped (-1 and N land in the cut-off
// slot). A lexicographic comparison of three planes, each in [0, 2^16), is
// the comparison of the 48-bit values they make, so the kernel rebuilds the
// value in int64 and compares that; min and max are taken on it too, which
// equals the JAX program's three-stage lexicographic reduction.
//
// Numbers. Counts and the integer plane sums are exact integers (int64
// across rows), min and max exact; the f32 results are formed with the JAX
// program's own expressions and in its order, f32(s0) + f32(s1) * 2^16
// + f32(s2) * 2^32 (the products are exact; --fmad=false keeps the adds
// apart), so they equal the JAX program's wherever its f32 sums are exact
// (each plane's total below 2^24) and are its sums rounded once elsewhere.
// An empty result keeps the JAX sentinels (planes of 2^16 for min, -1 for
// max; +inf and -inf for an f32 column). Float sums and every group sum
// accumulate in f64 and are rounded to f32 once: the JAX program sums in f32
// in an order XLA picks, so these agree with it to f32 rounding, not bit for
// bit. Group counts are exact (int32). The partials combine in block order,
// so the result is the same from call to call for a given grid.
//
// No branch. The JAX program picks the pruned scan (the <= cap granules
// gmask keeps, gathered) or the full scan with lax.cond, but the same rows
// count in both: when nsel <= cap the pruned branch scans every kept granule
// (slot_ok masks only the empty slots), and the full branch masks every row
// of a granule gmask drops. So this kernel scans exactly the kept granules
// and reports min(nsel, G) = nsel; cap does not enter it.
//
// One launch over a persistent grid: SMs x the blocks an SM holds (the
// occupancy API), at most 512 threads an SM, fixed per plan in
// ops/range_agg.py. Blocks are 256 threads, or 512 with a group table.
//
//  1. Every block tests all G granules against the bounds (24 bytes a
//     granule of minmax planes for an int filter, 8 for a float one, which
//     the L2 holds after the first block) and compacts the kept ids into
//     shared memory in ascending order: a thread tests granules a block
//     apart (coalesced, every load in flight), and the warps' ballots and
//     their counts give each kept granule its place. G above the list's
//     2,048 entries is taken in windows of 2,048 granules, after one
//     counting pass over all of them.
//  2. The kept granules' rows, in that order, are one run of K R / 4 row
//     quads; block b takes the b-th of grid equal slices of it, so the
//     card's SMs share the work evenly whether 20 or 1,221 granules
//     survive. A thread loads two quads (16-byte loads of every plane,
//     valid and group words) before it adds either, and keeps its partial
//     (count, plane sums, min, max; or count, f64 sum, f32 min and max) in
//     registers over all its quads.
//  3. Groups: with N <= kSmemGroups a block keeps one shared-memory table
//     (i32 counts, f64 sums) for all its rows and flushes it once, at its
//     end, to the global accumulators, skipping empty entries; above that
//     it adds straight into the global accumulators (the same function,
//     with global adds: not a fallback). The shared f64 add is a
//     compare-and-swap loop in SASS (ATOMS.CAST.SPIN.64), which keeps few
//     loads in flight, so a table block also asks the L2 for its next quads
//     one step ahead (cp.async.bulk.prefetch).
//  4. Each block writes one 48-byte partial, fences, and takes a ticket.
//     The block that draws the last ticket reduces the partials in block
//     order (int64 or f64), writes out[0:6], converts the group
//     accumulators to f32 into out[6:], and zeroes the accumulators and the
//     ticket, so the next launch on the stream finds clean scratch with no
//     memset (the plan allocates the scratch zeroed once).
//
// Bound: bytes. The scan reads each plane of the filter and the aggregate
// column once over the kept granules (12 bytes a row for an int column, 4
// for a float one; the aggregate again only when it is another column), the
// valid mask (1 byte a row) and the group plane (4); every block also reads
// the minmax planes (24 bytes a granule, from the L2), and the last block
// the grid's partials. A full scan at 10M rows with an int filter and a
// float aggregate reads about 17 bytes a row.
//
// Preconditions, checked by the Python wrapper (ops/range_agg.py): planes
// [G, R] contiguous, R % 4 == 0, 16-byte aligned; valid uint8 [G, R];
// gmin/gmax [G]; groups i32 [G, R] or null; the plan's scratch zeroed
// before its first launch: grid partials, the ticket, then num_groups f64
// sums and i32 counts; out f32 [6 + 2 num_groups]; all on one device. The
// launchers return a cudaError_t as int (0 = launched).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// The launch's argument block: the plan's fields and the call's bounds and
// output (ops/range_agg.py X1Args). Only 8-byte fields, so neither compiler
// pads it; both sides assert its size.
struct X1Args {
  const void* f0;  // filter planes [G, R]; a float column repeats plane 0
  const void* f1;
  const void* f2;
  const void* a0;  // aggregate planes, the same way
  const void* a1;
  const void* a2;
  const uint8_t* valid;  // [G, R]
  const void* gmin0;     // the filter's granule minima and maxima [G]
  const void* gmin1;
  const void* gmin2;
  const void* gmax0;
  const void* gmax1;
  const void* gmax2;
  const int* groups;     // the group column's low plane [G, R], or null
  void* parts;           // [grid] 48-byte partials
  unsigned int* ticket;  // zero between launches
  int* gcnt;             // [num_groups], zero between launches
  double* gsum;          // [num_groups], zero between launches
  float* out;            // [6 + 2 num_groups]
  long long lo, hi;      // 48-bit bounds (int filter)
  double flo, fhi;       // f32 bounds, exact in f64 (float filter)
  long long goff;        // added to the low plane (int32 wrap, as JAX)
  long long num_groups;
  long long G, R, grid;
  long long filt_int, agg_int;
};
static_assert(sizeof(X1Args) == 240, "X1Args must stay 30 fields of 8 bytes");

namespace {

constexpr int kWin = 2048;  // granules a window: 8 a thread of 256, 4 of 512
constexpr int kSmemGroups = 4096;  // groups counted in shared memory (48 KB)
constexpr long long kMinEmpty = 0x7fffffffffffffffLL;
constexpr long long kMaxEmpty = -1LL;

enum GroupMode { kNoGroups = 0, kTable = 1, kGlobal = 2 };

// Threads a block: 512 with a group table (one block an SM, so half as
// many tables to flush), else 256 (two an SM: smaller blocks compact and
// reduce sooner, which short scans feel). Either way 512 threads an SM:
// more blocks would each re-read the minmax planes and add a partial, which
// costs a pruned query more than it gains a full scan.
constexpr int kThreadsPerSm = 512;
__host__ __device__ constexpr int threads_of(int gm) {
  return gm == kTable ? 512 : 256;
}

// a block's partial: 48 bytes. Int aggregate: the three plane sums and the
// 48-bit min / max (kMinEmpty / kMaxEmpty when no row counts). Float
// aggregate: s0 holds the f64 sum's bits, mn / mx the f32 min / max bits.
struct Part {
  long long cnt, s0, s1, s2, mn, mx;
};

__device__ __forceinline__ long long v48(int p0, int p1, int p2) {
  return (long long)p0 | ((long long)p1 << 16) | ((long long)p2 << 32);
}

__device__ __forceinline__ int ldi(const void* plane, int i) {
  return __ldg(reinterpret_cast<const int*>(plane) + i);
}

// gmask[g]. Both tests are taken (&, not &&), so no load waits on
// another's comparison.
template <bool FI>
__device__ __forceinline__ bool granule_kept(const X1Args& A, int g) {
  if (FI) {
    const long long mx = v48(ldi(A.gmax0, g), ldi(A.gmax1, g), ldi(A.gmax2, g));
    const long long mn = v48(ldi(A.gmin0, g), ldi(A.gmin1, g), ldi(A.gmin2, g));
    return (mx >= A.lo) & (mn <= A.hi);
  }
  return (__int_as_float(ldi(A.gmax0, g)) >= (float)A.flo) &
         (__int_as_float(ldi(A.gmin0, g)) <= (float)A.fhi);
}

// Kept granules among all G (the windows' total, when G > kWin).
template <bool FI, int T>
__device__ int count_kept(const X1Args& A, int G, int* warp_tot) {
  int n = 0;
  for (int g = threadIdx.x; g < G; g += T) n += granule_kept<FI>(A, g);
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) n += __shfl_down_sync(0xffffffffu, n, d);
  if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = n;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int i = 0; i < T / 32; ++i) total += warp_tot[i];
  __syncthreads();  // warp_tot is rewritten by the first window
  return total;
}

// The kept granules of [w0, w0 + kWin) into sel, ascending; returns their
// number. Thread t tests granules w0 + T j + t, j < kWin / T (coalesced,
// all its loads in flight at once; past G it reads granule G - 1 and masks
// it); granule w0 + T j + 32 w + lane lands after those of rounds < j and
// of warps < w in round j, and after the kept lanes below it in its warp's
// ballot. cnt holds each round's count a warp.
template <bool FI, int T>
__device__ int compact_window(const X1Args& A, int w0, int G, int* sel,
                              int* cnt) {
  constexpr int kWarps = T / 32, kPerThread = kWin / T;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  unsigned keep = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int g = w0 + j * T + (int)threadIdx.x;
    keep |= (unsigned)((g < G) & granule_kept<FI>(A, min(g, G - 1))) << j;
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const unsigned b = __ballot_sync(0xffffffffu, (keep >> j) & 1u);
    if (lane == 0) cnt[j * kWarps + w] = __popc(b);
  }
  __syncthreads();
  int base = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const unsigned b = __ballot_sync(0xffffffffu, (keep >> j) & 1u);
    int before = 0, round = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      const int c = cnt[j * kWarps + i];
      before += i < w ? c : 0;
      round += c;
    }
    if ((keep >> j) & 1u)
      sel[base + before + __popc(b & ((1u << lane) - 1u))] =
          w0 + j * T + threadIdx.x;
    base += round;
  }
  __syncthreads();
  return base;
}

__device__ __forceinline__ void merge(Part& r, const Part& o, bool agg_int) {
  r.cnt += o.cnt;
  if (agg_int) {
    r.s0 += o.s0;
    r.s1 += o.s1;
    r.s2 += o.s2;
    r.mn = o.mn < r.mn ? o.mn : r.mn;
    r.mx = o.mx > r.mx ? o.mx : r.mx;
  } else {
    r.s0 = __double_as_longlong(__longlong_as_double(r.s0) +
                                __longlong_as_double(o.s0));
    r.mn = __float_as_int(fminf(__int_as_float((int)r.mn),
                                __int_as_float((int)o.mn)));
    r.mx = __float_as_int(fmaxf(__int_as_float((int)r.mx),
                                __int_as_float((int)o.mx)));
  }
}

__device__ __forceinline__ Part shfl_down(const Part& p, int d) {
  Part o;
  o.cnt = __shfl_down_sync(0xffffffffu, p.cnt, d);
  o.s0 = __shfl_down_sync(0xffffffffu, p.s0, d);
  o.s1 = __shfl_down_sync(0xffffffffu, p.s1, d);
  o.s2 = __shfl_down_sync(0xffffffffu, p.s2, d);
  o.mn = __shfl_down_sync(0xffffffffu, p.mn, d);
  o.mx = __shfl_down_sync(0xffffffffu, p.mx, d);
  return o;
}

// Reduce the block's per-thread partials; thread 0 writes the total to out.
// The order is fixed (lanes, then warps in order), so the f64 sum is too.
template <int T>
__device__ void block_partial(Part t, bool agg_int, Part* out, Part* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) merge(t, shfl_down(t, d), agg_int);
  if (lane == 0) red[w] = t;
  __syncthreads();
  if (threadIdx.x == 0) {
    Part r = red[0];
    for (int i = 1; i < T / 32; ++i) merge(r, red[i], agg_int);
    *out = r;
  }
}

__device__ __forceinline__ Part empty_part(bool agg_int) {
  Part p;
  p.cnt = 0;
  p.s1 = p.s2 = 0;
  if (agg_int) {
    p.s0 = 0;
    p.mn = kMinEmpty;
    p.mx = kMaxEmpty;
  } else {
    p.s0 = __double_as_longlong(0.0);
    p.mn = __float_as_int(INFINITY);
    p.mx = __float_as_int(-INFINITY);
  }
  return p;
}

// A thread's accumulators over all its rows.
struct Acc {
  Part p;       // count, int plane sums, 48-bit min / max
  double fsum;  // float aggregate
  float fmn, fmx;
};

// Four rows: the valid bytes and every plane's 16-byte word.
struct Quad {
  uchar4 v;
  int4 f0, f1, f2, a0, a1, a2, g;
};

// Global adds with no result (red): the table flush and the global group
// mode issue them without waiting for a reply.
__device__ __forceinline__ void red_add(int* p, int v) {
  asm volatile("red.global.add.s32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void red_add(double* p, double v) {
  asm volatile("red.global.add.f64 [%0], %1;" :: "l"(p), "d"(v) : "memory");
}

__device__ __forceinline__ int4 ld4(const void* plane, long long q) {
  return __ldg(reinterpret_cast<const int4*>(plane) + q);
}

template <bool FI, bool AI, int GM>
__device__ __forceinline__ Quad load_quad(const X1Args& A, long long q,
                                          bool same) {
  Quad d;
  d.v = __ldg(reinterpret_cast<const uchar4*>(A.valid) + q);
  d.f0 = ld4(A.f0, q);
  d.f1 = FI ? ld4(A.f1, q) : d.f0;  // a float column has one plane
  d.f2 = FI ? ld4(A.f2, q) : d.f0;
  if (same) {  // the aggregate is the filter column
    d.a0 = d.f0;
    d.a1 = d.f1;
    d.a2 = d.f2;
  } else {
    d.a0 = ld4(A.a0, q);
    d.a1 = AI ? ld4(A.a1, q) : d.a0;
    d.a2 = AI ? ld4(A.a2, q) : d.a0;
  }
  d.g = GM != kNoGroups ? ld4(A.groups, q) : make_int4(0, 0, 0, 0);
  return d;
}

// The JAX scatter's index rule for N + 1 slots, mode "drop", the last slot
// cut off: -1 if the row adds to no group.
__device__ __forceinline__ int group_slot(int id, int N) {
  if ((unsigned)id < (unsigned)N) return id;
  if (id >= -(N + 1) && id <= -2) return id + N + 1;
  return -1;
}

// Four rows into a thread's accumulators; with groups, each row's group
// slot (-1: none) and value into slot / av.
template <bool FI, bool AI, int GM>
__device__ __forceinline__ void add_quad(const X1Args& A, const Quad& d,
                                         Acc& t, int* slot, float* av) {
  const int vm[4] = {d.v.x, d.v.y, d.v.z, d.v.w};
  const int f0[4] = {d.f0.x, d.f0.y, d.f0.z, d.f0.w};
  const int f1[4] = {d.f1.x, d.f1.y, d.f1.z, d.f1.w};
  const int f2[4] = {d.f2.x, d.f2.y, d.f2.z, d.f2.w};
  const int c0[4] = {d.a0.x, d.a0.y, d.a0.z, d.a0.w};
  const int c1[4] = {d.a1.x, d.a1.y, d.a1.z, d.a1.w};
  const int c2[4] = {d.a2.x, d.a2.y, d.a2.z, d.a2.w};
  const int gp[4] = {d.g.x, d.g.y, d.g.z, d.g.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    slot[j] = -1;
    bool pass = vm[j] != 0;
    if (FI) {
      const long long v = v48(f0[j], f1[j], f2[j]);
      pass = pass && v >= A.lo && v <= A.hi;
    } else {
      const float v = __int_as_float(f0[j]);
      pass = pass && v >= (float)A.flo && v <= (float)A.fhi;
    }
    if (!pass) continue;
    t.p.cnt += 1;
    if (AI) {
      t.p.s0 += c0[j];
      t.p.s1 += c1[j];
      t.p.s2 += c2[j];
      const long long v = v48(c0[j], c1[j], c2[j]);
      t.p.mn = v < t.p.mn ? v : t.p.mn;
      t.p.mx = v > t.p.mx ? v : t.p.mx;
      // the JAX group value: f32(p0) + f32(p1) * 2^16 + f32(p2) * 2^32
      av[j] = __fadd_rn(
          __fadd_rn((float)c0[j], __fmul_rn((float)c1[j], 65536.0f)),
          __fmul_rn((float)c2[j], 4294967296.0f));
    } else {
      av[j] = __int_as_float(c0[j]);
      t.fsum += (double)av[j];
      t.fmn = fminf(t.fmn, av[j]);
      t.fmx = fmaxf(t.fmx, av[j]);
    }
    if (GM != kNoGroups)
      slot[j] = group_slot((int)((unsigned)gp[j] + (unsigned)A.goff),
                           (int)A.num_groups);
  }
}

// N rows into the block's shared group table. The f64 add compiles to a
// compare-and-swap loop (ATOMS.CAST.SPIN.64), one row after another;
// issuing all rows' first attempts through atomicCAS before checking any
// was several times slower on an H100.
template <int N>
__device__ __forceinline__ void table_add(int* cnt, double* sum,
                                          const int* slot, const float* av) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
    if (slot[r] < 0) continue;
    atomicAdd(cnt + slot[r], 1);
    atomicAdd(sum + slot[r], (double)av[r]);
  }
}

// Ask the L2 for quads [q, q + nq) of every plane the scan reads: one
// bulk prefetch a plane (lanes 0-7 of warp 0), which holds no register.
template <bool FI, bool AI, int GM>
__device__ __forceinline__ void prefetch_quads(const X1Args& A, long long q,
                                               long long nq, bool same) {
  const int t = threadIdx.x;
  if (t >= 8 || nq <= 0) return;
  const void* p = nullptr;
  long long b0 = q * 16, b1 = (q + nq) * 16;
  switch (t) {
    case 0: p = A.f0; break;
    case 1: p = FI ? A.f1 : nullptr; break;
    case 2: p = FI ? A.f2 : nullptr; break;
    case 3: p = same ? nullptr : A.a0; break;
    case 4: p = same || !AI ? nullptr : A.a1; break;
    case 5: p = same || !AI ? nullptr : A.a2; break;
    case 6: p = GM != kNoGroups ? A.groups : nullptr; break;
    default:  // valid, 4 bytes a quad, cut to 16-byte bounds inside it
      p = A.valid;
      b0 = (q * 4 + 15) & ~15LL;
      b1 = ((q + nq) * 4) & ~15LL;
  }
  if (p == nullptr || b1 <= b0) return;
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
               :: "l"(reinterpret_cast<const char*>(p) + b0),
                  "r"((unsigned)(b1 - b0)) : "memory");
}

// Row quads [p0, p0 + n) of one granule: thread t takes quads t, t + T,
// ..., two at a time with both loaded before either is added.
template <bool FI, bool AI, int GM>
__device__ __forceinline__ void scan_quads(const X1Args& A, long long p0,
                                           long long n, bool same, Acc& t,
                                           int* gs_cnt, double* gs_sum) {
  constexpr int T = threads_of(GM);
  constexpr long long kStep = 2 * T;
#pragma unroll 1  // unrolled, its registers would cut the blocks an SM holds
  for (long long i = threadIdx.x; i < n; i += kStep) {
    // A table block asks the L2 for its next step's quads: its shared adds
    // keep few loads in flight. The other modes stream at the card's rate
    // already and ran slower with it on an H100.
    if (GM == kTable) {
      const long long ahead = i - threadIdx.x + kStep;
      prefetch_quads<FI, AI, GM>(A, p0 + ahead, min(kStep, n - ahead), same);
    }
    const bool two = i + T < n;
    const Quad x = load_quad<FI, AI, GM>(A, p0 + i, same);
    const Quad y = load_quad<FI, AI, GM>(A, two ? p0 + i + T : p0 + i,
                                         same);
    int slot[8];
    float av[8];
    add_quad<FI, AI, GM>(A, x, t, slot, av);
    if (two) {
      add_quad<FI, AI, GM>(A, y, t, slot + 4, av + 4);
    } else {
#pragma unroll
      for (int r = 4; r < 8; ++r) slot[r] = -1;
    }
    if (GM == kTable) table_add<8>(gs_cnt, gs_sum, slot, av);
    if (GM == kGlobal) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (slot[r] < 0) continue;
        red_add(A.gcnt + slot[r], 1);
        red_add(A.gsum + slot[r], (double)av[r]);
      }
    }
  }
}

__device__ __forceinline__ Part load_part(const Part* p) {
  const longlong2* q = reinterpret_cast<const longlong2*>(p);
  const longlong2 a = __ldcg(q), b = __ldcg(q + 1), c = __ldcg(q + 2);
  return Part{a.x, a.y, b.x, b.y, c.x, c.y};
}

// f32(m0) + f32(m1) * 2^16 + f32(m2) * 2^32, the JAX expression and order
__device__ __forceinline__ float f32_of(int m0, int m1, int m2) {
  return __fadd_rn(__fadd_rn((float)m0, __fmul_rn((float)m1, 65536.0f)),
                   __fmul_rn((float)m2, 4294967296.0f));
}

// The last block: the partials in block order, out[0:6], the groups to f32,
// and the scratch zeroed for the next launch.
template <bool AI, int GM>
__device__ void finish(const X1Args& A, const int* kept, Part* red) {
  const Part* parts = reinterpret_cast<const Part*>(A.parts);
  Part t = empty_part(AI);
#pragma unroll 1  // unrolled, its loads would set the kernel's register count
  for (int i = threadIdx.x; i < (int)gridDim.x; i += threads_of(GM))
    merge(t, load_part(parts + i), AI);
  block_partial<threads_of(GM)>(t, AI, red, red);  // the total in red[0]
  if (threadIdx.x == 0) {
    const Part r = red[0];
    const int cnt = (int)r.cnt;
    float s, mn, mx;
    if (AI) {
      s = __fadd_rn(__fadd_rn((float)r.s0, __fmul_rn((float)r.s1, 65536.0f)),
                    __fmul_rn((float)r.s2, 4294967296.0f));
      if (r.cnt == 0) {  // the JAX sentinels of an empty reduction
        mn = f32_of(65536, 65536, 65536);
        mx = f32_of(-1, -1, -1);
      } else {
        mn = f32_of((int)(r.mn & 0xffff), (int)((r.mn >> 16) & 0xffff),
                    (int)(r.mn >> 32));
        mx = f32_of((int)(r.mx & 0xffff), (int)((r.mx >> 16) & 0xffff),
                    (int)(r.mx >> 32));
      }
    } else {
      s = (float)__longlong_as_double(r.s0);
      mn = __int_as_float((int)r.mn);
      mx = __int_as_float((int)r.mx);
    }
    A.out[0] = (float)(cnt & 0xffff);
    A.out[1] = (float)((cnt >> 16) & 0xffff);
    A.out[2] = s;
    A.out[3] = mn;
    A.out[4] = mx;
    A.out[5] = (float)*kept;
    *A.ticket = 0u;
  }
  if (GM != kNoGroups) {
    const int N = (int)A.num_groups;
    for (int i = threadIdx.x; i < N; i += threads_of(GM)) {
      A.out[6 + i] = (float)__ldcg(A.gcnt + i);
      A.out[6 + N + i] = (float)__ldcg(A.gsum + i);
      A.gcnt[i] = 0;
      A.gsum[i] = 0.0;
    }
  }
}

template <bool FI, bool AI, int GM>
__global__ void __launch_bounds__(threads_of(GM))
    range_agg_kernel(const X1Args A) {
  constexpr int T = threads_of(GM);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int sel[kWin];
  __shared__ int warp_tot[kWin / 32];
  __shared__ Part red[T / 32];
  // kept granules, all windows' and so far: in shared memory, as ptxas
  // would rather spill them than hold them in registers over the scan
  __shared__ int kept_total, kept_all;
  __shared__ bool last;
  const int G = (int)A.G;
  const long long Rq = A.R / 4;
  const bool same = A.a0 == A.f0;
  double* gs_sum = reinterpret_cast<double*>(smem_raw);
  int* gs_cnt =
      reinterpret_cast<int*>(gs_sum + (GM == kTable ? A.num_groups : 0));
  if (GM == kTable) {
    for (int i = threadIdx.x; i < (int)A.num_groups; i += T) {
      gs_sum[i] = 0.0;
      gs_cnt[i] = 0;
    }
    __syncthreads();
  }

  Acc t;
  t.p = empty_part(AI);
  t.fsum = 0.0;
  t.fmn = INFINITY;
  t.fmx = -INFINITY;
  if (G > kWin) {
    const int n = count_kept<FI, T>(A, G, warp_tot);
    if (threadIdx.x == 0) kept_total = n;  // read after the next barrier
  }
  int kept = 0;  // kept granules before this window
  for (int w0 = 0; w0 < G; w0 += kWin) {
    const int nw = compact_window<FI, T>(A, w0, G, sel, warp_tot);
    const long long all = (long long)(G > kWin ? kept_total : nw) * Rq;
    // this block's slice of the kept rows' quads, clipped to this window
    const long long lo = all * blockIdx.x / gridDim.x;
    const long long hi = all * (blockIdx.x + 1) / gridDim.x;
    const long long wlo = (long long)kept * Rq;
    long long s = max(lo, wlo);
    const long long e = min(hi, wlo + (long long)nw * Rq);
    while (s < e) {  // one granule's part of the slice at a time
      const int k = (int)((s - wlo) / Rq);
      const long long end = min(e, wlo + (k + 1) * Rq);
      const long long p0 = (long long)sel[k] * Rq + (s - wlo - k * Rq);
      scan_quads<FI, AI, GM>(A, p0, end - s, same, t, gs_cnt, gs_sum);
      s = end;
    }
    kept += nw;
    __syncthreads();  // sel and warp_tot are rewritten by the next window
  }
  if (threadIdx.x == 0) kept_all = kept;

  if (!AI) {
    t.p.s0 = __double_as_longlong(t.fsum);
    t.p.mn = __float_as_int(t.fmn);
    t.p.mx = __float_as_int(t.fmx);
  }
  block_partial<T>(t.p, AI, reinterpret_cast<Part*>(A.parts) + blockIdx.x,
                   red);
  if (GM == kTable) {
    __syncthreads();
    for (int i = threadIdx.x; i < (int)A.num_groups; i += T) {
      const int c = gs_cnt[i];
      if (c) {
        red_add(A.gcnt + i, c);
        red_add(A.gsum + i, gs_sum[i]);
      }
    }
  }
  // this block's partial (thread 0) and group adds before its ticket
  if (GM != kNoGroups || threadIdx.x == 0) __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(A.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  finish<AI, GM>(A, &kept_all, red);
}

using Kernel = void (*)(const X1Args);

template <bool FI, bool AI>
Kernel pick_gm(int gm) {
  switch (gm) {
    case kTable:
      return range_agg_kernel<FI, AI, kTable>;
    case kGlobal:
      return range_agg_kernel<FI, AI, kGlobal>;
    default:
      return range_agg_kernel<FI, AI, kNoGroups>;
  }
}

Kernel pick(bool fi, bool ai, int gm) {
  if (fi) return ai ? pick_gm<true, true>(gm) : pick_gm<true, false>(gm);
  return ai ? pick_gm<false, true>(gm) : pick_gm<false, false>(gm);
}

int group_mode(bool with_groups, long long num_groups) {
  if (!with_groups) return kNoGroups;
  return num_groups <= kSmemGroups ? kTable : kGlobal;
}

size_t table_bytes(int gm, long long num_groups) {
  return gm == kTable ? (size_t)num_groups * (sizeof(double) + sizeof(int)) : 0;
}

}  // namespace

// The persistent grid of a plan on the current device: SMs x the blocks an
// SM holds at once (the occupancy API, for the kernel and the shared memory
// the plan's flags select), at most kThreadsPerSm threads an SM.
extern "C" int diagon_range_agg_grid(int filt_int, int agg_int,
                                     long long num_groups, int* grid) {
  const int gm = group_mode(num_groups > 0, num_groups);
  const Kernel k = pick(filt_int != 0, agg_int != 0, gm);
  cudaError_t err;
  if (gm == kTable) {  // 48 KB of table beside the static list
    err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemGroups * (int)(sizeof(double) + sizeof(int)));
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0, occ = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, k, threads_of(gm), table_bytes(gm, num_groups));
  if (err != cudaSuccess) return (int)err;
  if (occ < 1) return (int)cudaErrorInvalidConfiguration;
  const int cap = kThreadsPerSm / threads_of(gm);
  *grid = sms * (occ < cap ? occ : cap);
  return 0;
}

extern "C" int diagon_range_agg(const X1Args* a, cudaStream_t stream) {
  if (a == nullptr || a->G < 1 || a->R < 4 || a->R % 4 || a->grid < 1 ||
      a->parts == nullptr || a->ticket == nullptr || a->out == nullptr ||
      (a->groups != nullptr &&
       (a->num_groups < 1 || a->gcnt == nullptr || a->gsum == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const int gm = group_mode(a->groups != nullptr, a->num_groups);
  const Kernel k = pick(a->filt_int != 0, a->agg_int != 0, gm);
  k<<<(unsigned)a->grid, threads_of(gm), table_bytes(gm, a->num_groups),
      stream>>>(*a);
  return (int)cudaGetLastError();
}
