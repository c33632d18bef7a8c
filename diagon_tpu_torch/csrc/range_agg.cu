// Columnar range aggregate for Hopper (sm_90a): kernel X1, the granule skip,
// the row scan and the combine of one range query over a device table.
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
// and the result is out[6] = [cnt_lo, cnt_hi, sum, min, max, granules
// scanned], as the JAX program packs it: the count as two exact 16-bit
// halves; the sum of the aggregate; its min and max; min(nsel, G) with nsel
// the number of granules gmask keeps. With a group column (low plane plus
// an offset) it also adds a count and a sum per group id in [0, groups);
// other ids are dropped. A lexicographic comparison of three planes, each
// in [0, 2^16), is the comparison of the 48-bit values they make, so the
// kernels rebuild the value in int64 and compare that; min and max are taken
// on it too, which equals the JAX program's three-stage lexicographic
// reduction.
//
// Numbers. Counts and the integer plane sums are exact integers (int64
// across granules), min and max exact; the f32 results are formed with the
// JAX program's own expressions and in its order, f32(s0) + f32(s1) * 2^16
// + f32(s2) * 2^32 (the products are exact; --fmad=false keeps the adds
// apart), so they equal the JAX program's wherever its f32 sums are exact
// (each plane's total below 2^24) and are its sums rounded once elsewhere.
// An empty result keeps the JAX sentinels (planes of 2^16 for min, -1 for
// max; +inf and -inf for an f32 column). Float sums and every group sum
// accumulate in f64 and are rounded to f32 once: the JAX program sums in f32
// in an order XLA picks, so these agree with it to f32 rounding, not bit for
// bit. Group counts are exact (int32).
//
// Why a hand kernel although the TPU had none. The JAX program decides on
// the device between the pruned scan (gather the <= cap granules gmask
// keeps) and the full scan, with lax.cond, and returns one device vector, so
// a serving loop chains queries with no readback. Eager PyTorch cannot
// branch on a device value without a host sync. Here the three launches
// read nsel and the granule list from device memory, so no launch waits for
// the host and the host never waits for one:
//
//  (a) range_skip_kernel, one block: gmask for every granule, then the
//      selected ids compacted in ascending order (a ballot prefix a warp, a
//      scan over the warps, chunk by chunk), and nsel;
//  (b) range_scan_kernel, a block a granule slot, G blocks: when nsel <= cap
//      block b < cap scans granule sel[b] if b < nsel (the JAX slot_ok) and
//      the rest exit; otherwise block b scans granule b, and writes an empty
//      partial where gmask[b] is false (the JAX full branch's rmask &=
//      gmask[b]; the read of a granule that holds no match is skipped). A
//      thread takes 4 rows at a time with 16-byte plane loads; warp
//      shuffles and one shared-memory pass reduce the block to one partial
//      (count, the three plane sums, min and max; or count, f64 sum, f32
//      min and max). Groups add into shared-memory counters (f64 sums, i32
//      counts) when the group count fits, flushed with one global atomic a
//      group a block; otherwise straight into global memory;
//  (c) range_combine_kernel, one block: the partials of the branch taken (cap
//      slots or G granules) reduced in int64 / f64, and the f32 results.
//
// Bound: bytes. The scan reads each plane of the filter and the aggregate
// column once over the scanned granules (12 bytes a row for an int column,
// 4 for a float one; the aggregate again only when it is another column),
// the valid mask (1 byte a row) and the group plane (4), and writes 48
// bytes a granule; (a) and (c) touch O(G) words. A full scan at 10M rows with
// an int filter and a float aggregate reads about 17 bytes a row. At 1M
// rows the three launches' fixed costs are larger than the reads.
//
// Preconditions, checked by the Python wrapper (ops/range_agg.py): planes
// [G, R] contiguous, R % 4 == 0, 16-byte aligned; valid uint8 [G, R];
// gmin/gmax [G]; groups i32 [G, R] or null; scratch of 14 G + 2 i32
// words (8-byte aligned) and, with groups, gcnt i32 and gsum f64
// [groups]; all on one device. The launcher returns a cudaError_t as int
// (0 = launched).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSkipThreads = 1024;
constexpr int kSmemGroups = 4096;  // groups counted in shared memory (48 KB)
constexpr long long kMinEmpty = 0x7fffffffffffffffLL;
constexpr long long kMaxEmpty = -1LL;

// one granule's partial: 48 bytes. Int aggregate: the three plane sums and
// the 48-bit min / max (kMinEmpty / kMaxEmpty when no row counts). Float
// aggregate: s0 holds the f64 sum's bits, mn / mx the f32 min / max bits.
struct Part {
  long long cnt, s0, s1, s2, mn, mx;
};

struct Bounds {
  long long lo, hi;  // 48-bit values (int filter)
  float flo, fhi;    // f32 bounds (float filter)
};

__device__ __forceinline__ long long v48(int p0, int p1, int p2) {
  return (long long)p0 | ((long long)p1 << 16) | ((long long)p2 << 32);
}

__device__ __forceinline__ bool granule_kept(
    const void* gmin0, const void* gmin1, const void* gmin2,
    const void* gmax0, const void* gmax1, const void* gmax2, int g,
    bool filt_int, const Bounds& b) {
  if (filt_int) {
    const long long mx = v48(((const int*)gmax0)[g], ((const int*)gmax1)[g],
                             ((const int*)gmax2)[g]);
    const long long mn = v48(((const int*)gmin0)[g], ((const int*)gmin1)[g],
                             ((const int*)gmin2)[g]);
    return mx >= b.lo && mn <= b.hi;
  }
  return ((const float*)gmax0)[g] >= b.flo && ((const float*)gmin0)[g] <= b.fhi;
}

__global__ void __launch_bounds__(kSkipThreads) range_skip_kernel(
    const void* gmin0, const void* gmin1, const void* gmin2,
    const void* gmax0, const void* gmax1, const void* gmax2, Bounds b,
    bool filt_int, int G, int* __restrict__ sel, int* __restrict__ gmask,
    int* __restrict__ nsel) {
  __shared__ int warp_off[kSkipThreads / 32];
  __shared__ int chunk_total;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int base = 0;
  for (int c0 = 0; c0 < G; c0 += kSkipThreads) {
    const int g = c0 + threadIdx.x;
    bool m = false;
    if (g < G) {
      m = granule_kept(gmin0, gmin1, gmin2, gmax0, gmax1, gmax2, g, filt_int, b);
      gmask[g] = m;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, m);
    if (lane == 0) warp_off[w] = __popc(bal);
    __syncthreads();
    if (w == 0) {
      const int v = warp_off[lane];
      int inc = v;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc += t;
      }
      warp_off[lane] = inc - v;
      if (lane == 31) chunk_total = inc;
    }
    __syncthreads();
    if (m) sel[base + warp_off[w] + __popc(bal & ((1u << lane) - 1u))] = g;
    base += chunk_total;
    __syncthreads();  // warp_off and chunk_total are rewritten next chunk
  }
  if (threadIdx.x == 0) *nsel = base;
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  return v;
}

__device__ __forceinline__ double warp_sum_f64(double v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xffffffffu, v, d);
  return v;
}

__device__ __forceinline__ long long warp_min(long long v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const long long o = __shfl_down_sync(0xffffffffu, v, d);
    v = o < v ? o : v;
  }
  return v;
}

__device__ __forceinline__ long long warp_max(long long v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const long long o = __shfl_down_sync(0xffffffffu, v, d);
    v = o > v ? o : v;
  }
  return v;
}

__device__ __forceinline__ float warp_fmin(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = fminf(v, __shfl_down_sync(0xffffffffu, v, d));
  return v;
}

__device__ __forceinline__ float warp_fmax(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, d));
  return v;
}

// Reduce the block's per-thread partial into part (thread 0 writes it).
__device__ void block_partial(Part t, bool agg_int, Part* __restrict__ out,
                              Part* __restrict__ smem) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  t.cnt = warp_sum(t.cnt);
  if (agg_int) {
    t.s0 = warp_sum(t.s0);
    t.s1 = warp_sum(t.s1);
    t.s2 = warp_sum(t.s2);
    t.mn = warp_min(t.mn);
    t.mx = warp_max(t.mx);
  } else {
    t.s0 = __double_as_longlong(warp_sum_f64(__longlong_as_double(t.s0)));
    t.mn = __float_as_int(warp_fmin(__int_as_float((int)t.mn)));
    t.mx = __float_as_int(warp_fmax(__int_as_float((int)t.mx)));
  }
  if (lane == 0) smem[w] = t;
  __syncthreads();
  if (threadIdx.x == 0) {
    Part r = smem[0];
    for (int i = 1; i < kWarps; ++i) {
      const Part o = smem[i];
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

__device__ __forceinline__ int4 ld4(const void* plane, int64_t i) {
  return __ldg(reinterpret_cast<const int4*>(plane) + i);
}

__global__ void __launch_bounds__(kThreads) range_scan_kernel(
    const void* f0, const void* f1, const void* f2, const void* a0,
    const void* a1, const void* a2, const uint8_t* __restrict__ valid,
    const int* __restrict__ groups, int goff, int num_groups, Bounds b,
    bool filt_int, bool agg_int, int G, int R, int cap,
    const int* __restrict__ sel, const int* __restrict__ gmask,
    const int* __restrict__ nsel_p, Part* __restrict__ parts,
    int* __restrict__ gcnt, double* __restrict__ gsum) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Part red[kWarps];
  const int nsel = *nsel_p;
  const int slot = blockIdx.x;
  int g;
  if (nsel <= cap) {
    if (slot >= cap) return;
    if (slot >= nsel) return;  // an empty slot: the combine reads nsel
    g = sel[slot];
  } else {
    if (!gmask[slot]) {
      if (threadIdx.x == 0) parts[slot] = empty_part(agg_int);
      return;
    }
    g = slot;
  }
  const bool smem_groups = groups != nullptr && num_groups <= kSmemGroups;
  double* gs_sum = reinterpret_cast<double*>(smem_raw);
  int* gs_cnt = reinterpret_cast<int*>(gs_sum + (smem_groups ? num_groups : 0));
  if (smem_groups) {
    for (int i = threadIdx.x; i < num_groups; i += kThreads) {
      gs_sum[i] = 0.0;
      gs_cnt[i] = 0;
    }
    __syncthreads();
  }

  Part t = empty_part(agg_int);
  double fsum = 0.0;
  float fmn = INFINITY, fmx = -INFINITY;
  const int64_t row0 = (int64_t)g * R;
  const int64_t q0 = row0 / 4;
  for (int r = threadIdx.x * 4; r < R; r += kThreads * 4) {
    const int64_t q = q0 + r / 4;
    const uchar4 vm = __ldg(reinterpret_cast<const uchar4*>(valid) + q);
    bool pass[4] = {vm.x != 0, vm.y != 0, vm.z != 0, vm.w != 0};
    if (filt_int) {
      const int4 p0 = ld4(f0, q), p1 = ld4(f1, q), p2 = ld4(f2, q);
      const long long v[4] = {v48(p0.x, p1.x, p2.x), v48(p0.y, p1.y, p2.y),
                              v48(p0.z, p1.z, p2.z), v48(p0.w, p1.w, p2.w)};
#pragma unroll
      for (int j = 0; j < 4; ++j) pass[j] = pass[j] && v[j] >= b.lo && v[j] <= b.hi;
    } else {
      const float4 p = __ldg(reinterpret_cast<const float4*>(f0) + q);
      const float v[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) pass[j] = pass[j] && v[j] >= b.flo && v[j] <= b.fhi;
    }
    if (!(pass[0] || pass[1] || pass[2] || pass[3])) continue;
    float av[4];
    if (agg_int) {
      const int4 p0 = ld4(a0, q), p1 = ld4(a1, q), p2 = ld4(a2, q);
      const int c0[4] = {p0.x, p0.y, p0.z, p0.w};
      const int c1[4] = {p1.x, p1.y, p1.z, p1.w};
      const int c2[4] = {p2.x, p2.y, p2.z, p2.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!pass[j]) continue;
        t.cnt += 1;
        t.s0 += c0[j];
        t.s1 += c1[j];
        t.s2 += c2[j];
        const long long v = v48(c0[j], c1[j], c2[j]);
        t.mn = v < t.mn ? v : t.mn;
        t.mx = v > t.mx ? v : t.mx;
        // the JAX group value: f32(p0) + f32(p1) * 2^16 + f32(p2) * 2^32
        av[j] = __fadd_rn(__fadd_rn((float)c0[j], __fmul_rn((float)c1[j], 65536.0f)),
                          __fmul_rn((float)c2[j], 4294967296.0f));
      }
    } else {
      const float4 p = __ldg(reinterpret_cast<const float4*>(a0) + q);
      const float v[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!pass[j]) continue;
        t.cnt += 1;
        fsum += (double)v[j];
        fmn = fminf(fmn, v[j]);
        fmx = fmaxf(fmx, v[j]);
        av[j] = v[j];
      }
    }
    if (groups != nullptr) {
      const int4 gp = __ldg(reinterpret_cast<const int4*>(groups) + q);
      const int gid[4] = {gp.x + goff, gp.y + goff, gp.z + goff, gp.w + goff};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!pass[j] || gid[j] < 0 || gid[j] >= num_groups) continue;
        if (smem_groups) {
          atomicAdd(gs_cnt + gid[j], 1);
          atomicAdd(gs_sum + gid[j], (double)av[j]);
        } else {
          atomicAdd(gcnt + gid[j], 1);
          atomicAdd(gsum + gid[j], (double)av[j]);
        }
      }
    }
  }
  if (!agg_int) {
    t.s0 = __double_as_longlong(fsum);
    t.mn = __float_as_int(fmn);
    t.mx = __float_as_int(fmx);
  }
  block_partial(t, agg_int, parts + slot, red);
  if (smem_groups) {
    __syncthreads();
    for (int i = threadIdx.x; i < num_groups; i += kThreads) {
      if (gs_cnt[i]) {
        atomicAdd(gcnt + i, gs_cnt[i]);
        atomicAdd(gsum + i, gs_sum[i]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) range_combine_kernel(
    const Part* __restrict__ parts, const int* __restrict__ nsel_p, int G,
    int cap, bool agg_int, int num_groups, const int* __restrict__ gcnt,
    const double* __restrict__ gsum, float* __restrict__ out,
    float* __restrict__ gcnt_out, float* __restrict__ gsum_out) {
  __shared__ Part red[kWarps];
  const int nsel = *nsel_p;
  const int n = nsel <= cap ? nsel : G;
  Part t = empty_part(agg_int);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const Part p = parts[i];
    t.cnt += p.cnt;
    if (agg_int) {
      t.s0 += p.s0;
      t.s1 += p.s1;
      t.s2 += p.s2;
      t.mn = p.mn < t.mn ? p.mn : t.mn;
      t.mx = p.mx > t.mx ? p.mx : t.mx;
    } else {
      t.s0 = __double_as_longlong(__longlong_as_double(t.s0) +
                                  __longlong_as_double(p.s0));
      t.mn = __float_as_int(fminf(__int_as_float((int)t.mn), __int_as_float((int)p.mn)));
      t.mx = __float_as_int(fmaxf(__int_as_float((int)t.mx), __int_as_float((int)p.mx)));
    }
  }
  block_partial(t, agg_int, red, red);  // thread 0: the total in red[0]
  if (threadIdx.x == 0) {
    const Part r = red[0];
    const int cnt = (int)r.cnt;
    float s, mn, mx;
    if (agg_int) {
      s = __fadd_rn(__fadd_rn((float)r.s0, __fmul_rn((float)r.s1, 65536.0f)),
                    __fmul_rn((float)r.s2, 4294967296.0f));
      long long lo = r.mn, hi = r.mx;
      int m0, m1, m2, x0, x1, x2;
      if (r.cnt == 0) {
        m0 = m1 = m2 = 65536;  // the JAX sentinels of an empty reduction
        x0 = x1 = x2 = -1;
      } else {
        m0 = (int)(lo & 0xffff), m1 = (int)((lo >> 16) & 0xffff), m2 = (int)(lo >> 32);
        x0 = (int)(hi & 0xffff), x1 = (int)((hi >> 16) & 0xffff), x2 = (int)(hi >> 32);
      }
      mn = __fadd_rn(__fadd_rn((float)m0, __fmul_rn((float)m1, 65536.0f)),
                     __fmul_rn((float)m2, 4294967296.0f));
      mx = __fadd_rn(__fadd_rn((float)x0, __fmul_rn((float)x1, 65536.0f)),
                     __fmul_rn((float)x2, 4294967296.0f));
    } else {
      s = (float)__longlong_as_double(r.s0);
      mn = __int_as_float((int)r.mn);
      mx = __int_as_float((int)r.mx);
    }
    out[0] = (float)(cnt & 0xffff);
    out[1] = (float)((cnt >> 16) & 0xffff);
    out[2] = s;
    out[3] = mn;
    out[4] = mx;
    out[5] = (float)(nsel < G ? nsel : G);
  }
  if (gcnt_out != nullptr) {
    for (int i = threadIdx.x; i < num_groups; i += kThreads) {
      gcnt_out[i] = (float)gcnt[i];
      gsum_out[i] = (float)gsum[i];
    }
  }
}

}  // namespace

// The scratch (ops/range_agg.py scratch_words: 14 G + 2 i32 words, 8-byte
// aligned) holds the partials (12 words each) first, then sel, gmask, nsel.
extern "C" int diagon_range_agg(
    const void* f0, const void* f1, const void* f2, const void* a0,
    const void* a1, const void* a2, const uint8_t* valid, const void* gmin0,
    const void* gmin1, const void* gmin2, const void* gmax0,
    const void* gmax1, const void* gmax2, int64_t lo, int64_t hi, float flo,
    float fhi, const int* groups, int goff, int num_groups, int* scratch,
    int* gcnt, double* gsum, float* out, float* gcnt_out, float* gsum_out,
    int G, int R, int cap, int filt_int, int agg_int, cudaStream_t stream) {
  if (G < 1 || R < 4 || R % 4 || cap < 1 || cap > G ||
      (groups != nullptr && (num_groups < 1 || gcnt == nullptr ||
                             gsum == nullptr || gcnt_out == nullptr ||
                             gsum_out == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  Part* parts = reinterpret_cast<Part*>(scratch);
  int* sel = scratch + (int64_t)G * 12;
  int* gmask = sel + G;
  int* nsel = gmask + G;
  Bounds b{lo, hi, flo, fhi};
  cudaError_t err;
  if (groups != nullptr) {
    err = cudaMemsetAsync(gcnt, 0, sizeof(int) * (size_t)num_groups, stream);
    if (err != cudaSuccess) return (int)err;
    err = cudaMemsetAsync(gsum, 0, sizeof(double) * (size_t)num_groups, stream);
    if (err != cudaSuccess) return (int)err;
  }
  range_skip_kernel<<<1, kSkipThreads, 0, stream>>>(
      gmin0, gmin1, gmin2, gmax0, gmax1, gmax2, b, filt_int != 0, G, sel,
      gmask, nsel);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (groups != nullptr && num_groups <= kSmemGroups)
                          ? (size_t)num_groups * (sizeof(double) + sizeof(int))
                          : 0;
  static bool smem_raised = false;  // 48 KB of groups + the static partials
  if (smem > 0 && !smem_raised) {
    err = cudaFuncSetAttribute(
        range_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemGroups * (int)(sizeof(double) + sizeof(int)));
    if (err != cudaSuccess) return (int)err;
    smem_raised = true;
  }
  range_scan_kernel<<<G, kThreads, smem, stream>>>(
      f0, f1, f2, a0, a1, a2, valid, groups, goff, num_groups, b,
      filt_int != 0, agg_int != 0, G, R, cap, sel, gmask, nsel, parts, gcnt,
      gsum);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  range_combine_kernel<<<1, kThreads, 0, stream>>>(
      parts, nsel, G, cap, agg_int != 0, groups != nullptr ? num_groups : 0,
      gcnt, gsum, out, groups != nullptr ? gcnt_out : nullptr, gsum_out);
  return (int)cudaGetLastError();
}
