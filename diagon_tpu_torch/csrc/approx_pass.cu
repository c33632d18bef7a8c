// Phase-1 approximate select kernels for Hopper (sm_90a): the pure-OR select
// (B3), the general boolean select (B4) and the no-MUST_NOT boolean select in
// two products (B5).
//
// Replaces diagon_tpu/ops/pallas/approx_pass.py: pallas_approx_select
// (_kernel_or), pallas_approx_select_bool (_kernel_bool) and
// pallas_approx_select_bool2 (_kernel_bool2).
//
// What they compute. The batch-compact bank holds U8 clause rows over the
// padded doc axis in bf16 ([U8, D]); each role matrix a_t ([U8, Q], bf16)
// says how often query q uses row u in that role. For every doc d and query q
// a product p(q, d) = sum_u a_t[u, q] * bank[u, d] (bf16 inputs, f32
// arithmetic: a bf16 x bf16 product is exact in f32, the sum rounds once per
// add). Per (query, 128-doc tile) the kernels write:
//   B3: the max of the score product over every doc of the tile (dead docs
//       included), rounded once to bf16 (__float2bfloat16_rn, round to
//       nearest even like XLA's cast); a doc matches iff product > 0 and live;
//   B4: score product from a_sc; required/should/must_not counts from a_rq,
//       a_sh, a_ng against presence = (bank > 0), derived here from the same
//       bank; match = req == nreq, sho >= msm, neg == 0, req + sho > 0, live;
//   B5: score product from a_sc; one count product cc from a_cb = rq*256 + sh
//       against presence, decoded as rc = floor(cc * (1/256)), oc = cc - 256 rc;
//       match = rc == nreq, oc >= msm, cc > 0, live.
// B4 and B5 write the f32 tile max of the score product (no bf16 rounding)
// where some doc of the tile matches, else -1. The counts are sums of small
// integers below 2^24, so they and the hit counts are exact in any order.
//
// Layout. Each indicator column holds at most Tq nonzeros while U8 may be
// hundreds, so a first kernel compacts every role matrix into per-query lists
// of (row, value) in ascending row order, and the select kernel sums only the
// listed rows (adding an exact zero product changes no f32 sum). A block of 8
// warps owns one 128-doc tile and a slice of the queries: it stages the
// tile's [U8, 128] bf16 slab in shared memory once, then each warp walks its
// own queries (q = warp, warp + 8, ...) with no further barrier. A lane owns
// 4 neighbouring docs, so each list entry feeds 4 independent f32 adds from
// one 8-byte shared read, and per query the warp reduces its tile with 5
// shuffles (max) and one integer reduction (match count), written by lane 0.
// Each warp writes the tile's max and match count per query; a last kernel
// sums the per-tile counts of each query in a fixed order, so hits are
// deterministic without atomics.
//
// Bound: at 1M docs, Q = 1024, Tq = 20 the select reads the bf16 bank once
// (U8 * D * 2 bytes, ~340 MB at U8 = 168) and performs Q * Tq * D
// multiply-adds, one shared read per 4 of them: the latency of the list
// loads and the issue rate of the adds bound it, not HBM. Tensor-core MMA
// over the dense indicator matrix, and staging the lists in shared memory,
// are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;  // docs per tile
constexpr int kThreads = 256;  // 8 warps; a lane owns 4 docs of the tile
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 264;  // 2 blocks per SM on a 132-SM card
constexpr int kMaxGridY = 65535;

enum Mode { kOr = 0, kBool = 1, kBool2 = 2 };

struct Lists {
  const int32_t* idx;  // [Q, U8] row of the j-th nonzero of column q
  const float* val;    // [Q, U8] its value
  const int32_t* cnt;  // [Q] nonzeros of column q
};

// One thread per query: rows of column q in ascending order. Threads of a
// warp read neighbouring columns of one row, so the reads coalesce.
__global__ void compact_lists_kernel(const __nv_bfloat16* __restrict__ a_t,
                                     int U8, int Q, int32_t* __restrict__ idx,
                                     float* __restrict__ val,
                                     int32_t* __restrict__ cnt) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= Q) return;
  int32_t* iq = idx + (int64_t)q * U8;
  float* vq = val + (int64_t)q * U8;
  int n = 0;
  for (int u = 0; u < U8; ++u) {
    const float v = __bfloat162float(a_t[(int64_t)u * Q + q]);
    if (v != 0.f) {
      iq[n] = u;
      vq[n] = v;
      ++n;
    }
  }
  cnt[q] = n;
}

// acc[i] = sum over the listed rows of value * bank (or * presence) at doc
// 4 * lane + i of the staged tile: exact products, one f32 add each,
// ascending rows. bf16 -> f32 is exact: the bf16 bits are the high half.
__device__ __forceinline__ void list_dot4(const Lists& L, int q, int U8,
                                          const __nv_bfloat16* s_bank,
                                          int lane, bool presence,
                                          float acc[4]) {
  const int n = __ldg(L.cnt + q);
  const int32_t* iq = L.idx + (int64_t)q * U8;
  const float* vq = L.val + (int64_t)q * U8;
  acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
  for (int j = 0; j < n; ++j) {
    const float v = __ldg(vq + j);
    const uint2 raw = *reinterpret_cast<const uint2*>(
        s_bank + __ldg(iq + j) * kLane + 4 * lane);
    float b[4] = {__uint_as_float(raw.x << 16),
                  __uint_as_float(raw.x & 0xffff0000u),
                  __uint_as_float(raw.y << 16),
                  __uint_as_float(raw.y & 0xffff0000u)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = presence ? (b[i] > 0.f ? 1.f : 0.f) : b[i];
      acc[i] = __fadd_rn(acc[i], __fmul_rn(v, x));
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) approx_select_kernel(
    const __nv_bfloat16* __restrict__ bank, const float* __restrict__ live,
    const float* __restrict__ params, Lists l0, Lists l1, Lists l2, Lists l3,
    float* __restrict__ tmax, int32_t* __restrict__ tcnt, int U8, int Q,
    int q_per_block, int64_t D) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_bank = reinterpret_cast<__nv_bfloat16*>(smem);

  const int64_t S = D / kLane;
  const int64_t g = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // stage the tile: U8 rows of 128 bf16 (256 bytes = 16 x 16-byte loads)
  const uint4* src = reinterpret_cast<const uint4*>(bank);
  uint4* dst = reinterpret_cast<uint4*>(s_bank);
  for (int i = threadIdx.x; i < U8 * 16; i += kThreads) {
    const int64_t u = i >> 4;
    dst[i] = __ldg(src + (u * D + g * kLane) / 8 + (i & 15));
  }
  const float4 lv = __ldg(reinterpret_cast<const float4*>(live + g * kLane) + lane);
  const bool alive[4] = {lv.x > 0.f, lv.y > 0.f, lv.z > 0.f, lv.w > 0.f};
  __syncthreads();

  for (int ys = blockIdx.y; (int64_t)ys * q_per_block < Q; ys += gridDim.y) {
    const int q_end = min(Q, (ys + 1) * q_per_block);
    for (int q = ys * q_per_block + warp; q < q_end; q += kWarps) {
      float ap[4];
      list_dot4(l0, q, U8, s_bank, lane, false, ap);
      bool match[4];
      if (MODE == kOr) {
#pragma unroll
        for (int i = 0; i < 4; ++i) match[i] = ap[i] > 0.f && alive[i];
      } else {
        const float nreq = __ldg(params + q);
        const float msm = __ldg(params + Q + q);
        if (MODE == kBool) {
          float rc[4], oc[4], nc[4];
          list_dot4(l1, q, U8, s_bank, lane, true, rc);
          list_dot4(l2, q, U8, s_bank, lane, true, oc);
          list_dot4(l3, q, U8, s_bank, lane, true, nc);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            match[i] = rc[i] == nreq && oc[i] >= msm && nc[i] == 0.f &&
                       __fadd_rn(rc[i], oc[i]) > 0.f && alive[i];
          }
        } else {
          float cc[4];
          list_dot4(l1, q, U8, s_bank, lane, true, cc);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float rc = floorf(__fmul_rn(cc[i], 1.0f / 256.0f));
            const float oc = __fsub_rn(cc[i], __fmul_rn(rc, 256.0f));
            match[i] = rc == nreq && oc >= msm && cc[i] > 0.f && alive[i];
          }
        }
      }
      float mx = fmaxf(fmaxf(ap[0], ap[1]), fmaxf(ap[2], ap[3]));
      int c = (int)match[0] + (int)match[1] + (int)match[2] + (int)match[3];
      for (int o = 16; o > 0; o >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      }
      c = __reduce_add_sync(0xffffffffu, c);
      if (lane == 0) {
        float out;
        if (MODE == kOr) {
          out = __bfloat162float(__float2bfloat16_rn(mx));
        } else {
          out = c > 0 ? mx : -1.f;
        }
        const int64_t o = (int64_t)q * S + g;
        tmax[o] = out;
        tcnt[o] = c;
      }
    }
  }
}

// hits[q] = sum over tiles of the per-tile match counts, in a fixed order
__global__ void __launch_bounds__(256) hits_kernel(
    const int32_t* __restrict__ tcnt, int64_t S, int Q,
    int32_t* __restrict__ hits) {
  __shared__ int part[256];
  for (int q = blockIdx.x; q < Q; q += gridDim.x) {
    const int32_t* row = tcnt + (int64_t)q * S;
    int acc = 0;
    for (int64_t i = threadIdx.x; i < S; i += 256) acc += row[i];
    part[threadIdx.x] = acc;
    __syncthreads();
    for (int w = 128; w > 0; w >>= 1) {
      if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
      __syncthreads();
    }
    if (threadIdx.x == 0) hits[q] = part[0];
    __syncthreads();
  }
}

template <int MODE>
int launch(const void* const* mats, int n_mats, const void* bank,
           const float* params, const float* live, int32_t* idx, float* val,
           int32_t* cnt, float* tmax, int32_t* tcnt, int32_t* hits, int U8,
           int Q, int64_t D, cudaStream_t stream) {
  const int64_t list = (int64_t)Q * U8;
  Lists lists[4];
  for (int r = 0; r < 4; ++r) {
    const int rr = r < n_mats ? r : 0;  // unused roles alias list 0
    lists[r] = Lists{idx + rr * list, val + rr * list, cnt + (int64_t)rr * Q};
  }
  for (int r = 0; r < n_mats; ++r) {
    compact_lists_kernel<<<(Q + 127) / 128, 128, 0, stream>>>(
        reinterpret_cast<const __nv_bfloat16*>(mats[r]), U8, Q,
        idx + r * list, val + r * list, cnt + (int64_t)r * Q);
  }
  const int64_t S = D / kLane;
  const size_t smem = (size_t)U8 * kLane * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      approx_select_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  // split the queries over grid.y when the tiles alone cannot fill the card
  int64_t ys = (kMinBlocks + S - 1) / S;
  const int64_t max_ys = (Q + kWarps - 1) / kWarps;
  if (ys > max_ys) ys = max_ys;
  if (ys > kMaxGridY) ys = kMaxGridY;
  if (ys < 1) ys = 1;
  const int64_t per = (Q + ys - 1) / ys;
  const int q_per_block = (int)(((per + kWarps - 1) / kWarps) * kWarps);
  const dim3 grid((unsigned)S, (unsigned)ys);
  approx_select_kernel<MODE><<<grid, kThreads, smem, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(bank), live, params, lists[0],
      lists[1], lists[2], lists[3], tmax, tcnt, U8, Q, q_per_block, D);
  hits_kernel<<<Q < kMaxGridY ? Q : kMaxGridY, 256, 0, stream>>>(tcnt, S, Q,
                                                                  hits);
  return (int)cudaGetLastError();
}

}  // namespace

// Launchers: plain C interface for ctypes, one signature for all three. Each
// runs on the given stream, allocates nothing and returns cudaGetLastError()
// (0 = launched).
//
// Preconditions, checked by the Python wrapper: all tensors contiguous on one
// device; a0..a3 bf16 [U8, Q] (B3 reads a0; B5 reads a0 = a_sc, a1 = a_cb; B4
// reads a0..a3 = a_sc, a_rq, a_sh, a_ng; unused ones may be null); bank bf16
// [U8, D], 16-byte aligned; params f32 [8, Q] (rows 0 num_required, 1
// min_should; null for B3); live f32 [D]; scratch idx i32 and val f32
// [R, Q, U8], cnt i32 [R, Q] (R = matrices read); outputs tmax f32 [Q, D/128],
// tcnt i32 [Q, D/128] (per-tile match counts), hits i32 [Q];
// 8 <= U8 <= 896, U8 % 8 == 0, D % 128 == 0, Q >= 1.

#define DIAGON_APPROX_ARGS                                                   \
  const void *a0, const void *a1, const void *a2, const void *a3,            \
      const void *bank, const float *params, const float *live, int32_t *idx, \
      float *val, int32_t *cnt, float *tmax, int32_t *tcnt, int32_t *hits,   \
      int U8, int Q, int64_t D, cudaStream_t stream

extern "C" int diagon_approx_select(DIAGON_APPROX_ARGS) {
  const void* mats[4] = {a0, a1, a2, a3};
  return launch<kOr>(mats, 1, bank, params, live, idx, val, cnt, tmax, tcnt,
                     hits, U8, Q, D, stream);
}

extern "C" int diagon_approx_select_bool(DIAGON_APPROX_ARGS) {
  const void* mats[4] = {a0, a1, a2, a3};
  return launch<kBool>(mats, 4, bank, params, live, idx, val, cnt, tmax, tcnt,
                       hits, U8, Q, D, stream);
}

extern "C" int diagon_approx_select_bool2(DIAGON_APPROX_ARGS) {
  const void* mats[4] = {a0, a1, a2, a3};
  return launch<kBool2>(mats, 2, bank, params, live, idx, val, cnt, tmax,
                        tcnt, hits, U8, Q, D, stream);
}
