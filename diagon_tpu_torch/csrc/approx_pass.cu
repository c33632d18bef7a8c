// Phase-1 approximate select kernels for Hopper (sm_90a), all on the tensor
// cores: the pure-OR select (B3), the general boolean select (B4) and the
// no-MUST_NOT boolean select in two products (B5).
//
// Replaces diagon_tpu/ops/pallas/approx_pass.py: _kernel_or (:63, B3),
// _kernel_bool (:87, B4) and _kernel_bool2 (:196, B5), the kernels of
// pallas_approx_select, pallas_approx_select_bool and
// pallas_approx_select_bool2.
//
// What they compute. The batch-compact bank holds U8 clause rows over the
// padded doc axis in bf16 ([U8, D]); each role matrix a_t ([U8, Q], bf16)
// says how often query q uses row u in that role. For every doc d and query q
// a product p(q, d) = sum_u a_t[u, q] * bank[u, d] (bf16 inputs, f32 sums on
// the tensor cores). Per (query, 128-doc tile) the kernels write:
//   B3: the max of the score product over every doc of the tile (dead docs
//       included), rounded once to bf16 (__float2bfloat16_rn, round to
//       nearest even like XLA's cast); a doc matches iff product > 0 and live;
//   B4: score product from a_sc; required/should/must_not counts rc, oc, nc
//       from a_rq, a_sh, a_ng against presence = (bank > 0), derived here from
//       the same bank; match = rc == nreq, oc >= msm, nc == 0, rc + oc > 0,
//       live;
//   B5: score product from a_sc; one count product cc from a_cb = rq*256 + sh
//       against presence, decoded as rc = floor(cc * (1/256)), oc = cc - 256 rc;
//       match = rc == nreq, oc >= msm, cc > 0, live.
// B4 and B5 write the f32 tile max of the score product (no bf16 rounding)
// where some doc of the tile matches, else -1. Every count is a sum of
// integers below 2^24, exact under the tensor cores' truncating accumulator
// (ops/approx_pass.py), so the matches and the hit counts are exact.
//
// B3 on the tensor cores (approx_or_mma_kernel). The TPU kernel is a dense
// bf16 product on the MXU, and so is this one: P = A x B with A = a_t^T
// ([Q, U8], the indicator) and B = the bank ([U8, docs]), bf16 in, f32 sums
// in registers. As a list kernel on the CUDA cores (the port's first form of
// B3, B4 and B5) B3 spent one __fmul_rn and one __fadd_rn per (query, list
// entry, doc), ~1.65e10 of each at the 1M main-path shape, and the issue rate
// of the f32 pipes bounded it at about 1 ms whatever the schedule; the dense
// product is 2 Q U8 D ~ 2.9e11 bf16 operations there, 0.3 ms at the
// tensor-core peak. The bank is read from HBM once in either design.
//   - Persistent blocks of one warpgroup (4 per SM) walk the 128-doc tiles;
//     grid.y splits the queries where the tiles alone leave SMs idle. A
//     block copies its tile's [U8, 128] bf16 slab into shared memory
//     (cp.async) in wgmma's 128-byte-swizzled docs-major layout, K padded to
//     a multiple of 16 with zero-filled rows (uninitialised padding times a
//     zero indicator could be NaN).
//   - Per 64-query chunk the warpgroup runs the k-steps as asynchronous
//     wgmma.m64n128k16 batches: A from registers (warp w holds the m16k16
//     fragments of rows 16w..16w+15, one 16-byte load each from a copy that
//     pack_indicator_kernel lays out in fragment order; rows past Q and
//     columns past U8 are zero), loaded one batch ahead; B through a
//     shared-memory descriptor. The 64 x 128 sums stay in 64 registers a
//     thread.
//   - Epilogue in registers on packed bf16 pairs: a max tree, then two
//     xor-shuffles over the 4 lanes of a row; the 0/1 match pairs
//     (set.gt.bf16x2) are counted against the live docs by one mma.sync per
//     16 docs. tmax is rounded once to bf16 (rounding is monotone, so the max
//     of the rounded sums is the rounded max); the counts go to hits with
//     one integer atomicAdd per (block, query), exact in any order.
// The tensor core may align a k-group of products to its largest exponent
// and truncate; ops/approx_pass.py derives the bound of _APPROX_RELEPS for
// that arithmetic. Every product is >= 0, so p > 0 iff some product is > 0
// and the hit counts stay exact.
//
// B4 and B5 on the tensor cores: one body (bool_select) with the number of
// count products as its parameter, behind two kernels (approx_bool_mma_kernel
// for B4, approx_bool2_mma_kernel for B5). Every product is an MMA
// (mma.sync.m16n8k16, bf16 in, f32 sums) from one staged copy of the bank
// tile. As list kernels on the CUDA cores both were bounded, like B3 before
// them, by the rate of one f32 multiply and one add per (query, list entry,
// doc) and product; B4 took three launches (list compaction, the list
// kernel, a pass over a per-tile count plane) and four such products, 8.0 ms
// at Q 820, U8 168 over 1M docs on an H100 at 700 W (PERF.md, PR 5). B4
// keeps its three counts as three exact
// count products that share the presence fragments: packing them into fewer
// is not exact in bf16 for the rows it exists for, a (row, query) pair in
// two roles (rq * 256 + sh needs 9 significant bits where both are 1).
//   - Persistent blocks, one or two an SM. A block owns runs of 8
//     neighbouring tiles (x, x + gridDim.x, ...: neighbouring blocks read
//     neighbouring runs of every bank row together) and a range of 16-query
//     fragments (grid.y splits the fragments where the tiles alone leave SMs
//     idle or the block's shared memory needs it). The tile's [U8, 128] slab
//     is copied with cp.async into the swizzled layout above (core_offset
//     spreads the 8 rows of a 16-byte chunk over all banks, which is what
//     ldmatrix needs too), K padded to 16 with written zero rows; where two
//     tiles fit, the next tile's copy runs under this tile's MMAs.
//   - The indicators are A fragments that pack_indicator_kernel lays out in
//     fragment order once per call (B5: a_sc, a_cb; B4: a_sc, a_rq, a_sh,
//     a_ng). The block copies its fragments into shared memory once and
//     keeps them for every tile: read from global memory per k-step they
//     cost an L2 round trip each, which set B5's first time. Only where they
//     do not fit beside the tile (U8 of several hundred) do they stay in
//     global memory, loaded a k-step ahead.
//   - A warp takes whole fragments (16 queries x the tile's 128 docs) in
//     passes that hold 64 sums a thread: B5 in two passes of 64 docs (score
//     and cc, 32 sums each), B4 in four of 32 docs (score and three counts,
//     16 sums each), so four products fit the registers of two; B4's four A
//     fragments a k-step still take it past 128 registers, so an SM runs 12
//     of its warps, not 16. Per k-step
//     and 16 docs one ldmatrix.x4.trans gives the B fragments of the bank;
//     presence = (bank > 0) is made from them in registers (set.gt.bf16x2),
//     never read from memory, and feeds every count product; the score
//     product takes the same fragments. The first k-step's MMAs take a zero
//     C operand: sums zeroed in registers first made every tile's first MMAs
//     wait.
//   - Epilogue in registers. B5: cc is an exact integer, so rc == nreq && oc
//     >= msm && cc > 0 is the range test lo <= cc <= hi (match_range), one
//     subtract and one compare per doc. B4: rc == nreq && oc >= lo && nc == 0
//     on its three exact counts (match_counts; lo folds rc + oc > 0 into
//     msm). The matches become bits that a popcount takes against the tile's
//     live bits. The f32 tile max is reduced with two shuffles over the 4
//     lanes of a row.
//   - The tile maxima of a run wait in a [queries, 8] slab in shared memory
//     and leave as 32 contiguous bytes per query; hits add up per (block,
//     query) in shared memory and go out with one integer atomicAdd each
//     (pack_indicator_kernel zeroes hits): exact in any order. There is no
//     per-tile count plane and no pass over one.
// What bounds them: the rate of mma.sync (below wgmma's) and the fragments'
// way through the shared-memory pipe (192 bytes per MMA in either form) where
// U8 is in the hundreds; the epilogue, the per-tile barriers and the
// [Q, D/128] stores where U8 is a few tens. B4 does twice B5's MMAs per tile
// and loads its A fragments once per pass, four times a tile; at U8 168 its
// fragments take 22.5 KB of shared memory each, so a block holds 8 of them
// beside the tile and an SM runs one block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kLane = 128;  // docs per tile
constexpr int kMaxGridY = 65535;

// ---------------------------------------------------------------------------
// B3: the pure-OR select on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;  // one warpgroup per block
constexpr int kWgBlocks = 528;  // persistent blocks: 4 per SM of a 132-SM card
constexpr int kChunkQ = 64;  // queries per chunk: the warpgroup's M = 64
constexpr int kGroup = 4;  // k-steps per batch of asynchronous MMAs
constexpr int kMaxChunksPerBlock = 32;  // 2,048 queries' counts, 8 KB
constexpr int64_t kMaxSmem = 232448;  // a block's dynamic shared memory, max
constexpr int64_t kSmSmem = 233472;  // an SM's shared memory, all its blocks
constexpr int64_t kBlockReserve = 1024;  // of it, a block's cost beside its own
constexpr int kSms = 132;  // the card's SMs
constexpr int kNFrags = kLane / 8;  // 16 column groups of 8 docs per tile
constexpr int kAtomBytes = 1024;  // 8 rows x 64 docs, 128-byte swizzle
constexpr int kKGroupBytes = 2 * kAtomBytes;  // 8 rows of the tile
static_assert(kWgThreads == kLane, "a thread stages one doc's live flag");


// The indicator matrices a select packs, in packing order: B3 a_t; B5 a_sc,
// a_cb; B4 a_sc, a_rq, a_sh, a_ng.
struct Indicators {
  const __nv_bfloat16* mat[4];
  int n;
};

// The m16k16 A fragments (row-major, 16 queries x 16 rows) in the order the
// kernels load them: packed[((i * MF + m) * KS + ks) * 32 + lane] holds
// lane's four registers of fragment (m, ks) of matrix i. With g = lane / 4,
// t = lane % 4 and A(q, k) = a_t[k, q] (zero past Q or U8), the registers are
// (A(g, 2t), A(g, 2t+1)), (A(g+8, 2t), ..), (A(g, 2t+8), ..),
// (A(g+8, 2t+8), ..), each pair low half first, q and k relative to the
// fragment's origin (16 m, 16 ks). B3: warp w of the warpgroup takes fragment
// m = 4 * chunk + w. B4 and B5: a warp takes fragment m of every matrix. The
// kernel also zeroes hits[0..Q), which the select kernels add into.
__global__ void pack_indicator_kernel(Indicators ind, int U8, int Q, int MF,
                                      int KS, uint4* __restrict__ packed,
                                      int32_t* __restrict__ hits) {
  const int64_t per = (int64_t)MF * KS * 32;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < Q) hits[i] = 0;  // MF * 16 >= Q: the grid covers every query
  if (i >= ind.n * per) return;
  const int lane = (int)(i & 31);
  const int64_t f = (i % per) >> 5;
  const int m = (int)(f / KS), ks = (int)(f % KS);
  const int g = lane >> 2, t = lane & 3;
  const int64_t mi = i / per;
  // a select, not an index: a dynamic index into a kernel parameter would
  // copy the struct to local memory
  const __nv_bfloat16* a_t = mi == 0   ? ind.mat[0]
                             : mi == 1 ? ind.mat[1]
                             : mi == 2 ? ind.mat[2]
                                       : ind.mat[3];
  const unsigned short* raw = reinterpret_cast<const unsigned short*>(a_t);
  auto at = [&](int q, int k) -> uint32_t {
    return (q < Q && k < U8) ? raw[(int64_t)k * Q + q] : 0u;
  };
  auto pair = [&](int q, int k) -> uint32_t {
    return at(q, k) | (at(q, k + 1) << 16);
  };
  const int q0 = 16 * m + g, k0 = 16 * ks + 2 * t;
  packed[i] = make_uint4(pair(q0, k0), pair(q0 + 8, k0), pair(q0, k0 + 8),
                         pair(q0 + 8, k0 + 8));
}


// d (+)= A x B for 64 queries x 128 docs x 16 rows on the tensor cores
// (wgmma, asynchronous): A from registers (lane's m16k16 A fragment, warp w
// of the warpgroup holding rows 16w..16w+15), B = the staged tile through
// its shared-memory descriptor, docs-major (transposed); with accumulate = 0
// the sums start from zero.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint4& a,
                                                 uint64_t desc_b,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "l"(desc_b), "r"(accumulate));
}

// c (+)= A x B for one m16n8k16 (the match counts of the epilogue).
template <bool kZero = false>
__device__ __forceinline__ void mma_bf16(float c[4], const uint4& a,
                                         uint32_t b0, uint32_t b1) {
  if (kZero) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
        : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
        : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1),
          "f"(0.f));
  } else {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
  }
}

// Keeps the compiler from moving reads or writes of r across the
// asynchronous MMAs (it sees them only where they are issued).
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_operand(uint4& r) {
  asm volatile("" : "+r"(r.x), "+r"(r.y), "+r"(r.z), "+r"(r.w)::"memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t& r0,
                                                  uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}

// (x.lo > 0, x.hi > 0) as a bf16 pair of 1.0 or 0.0, x a bf16 pair
__device__ __forceinline__ uint32_t positive2(uint32_t x) {
  uint32_t y;
  asm("set.gt.bf16x2.bf16x2 %0, %1, %2;" : "=r"(y) : "r"(x), "r"(0u));
  return y;
}
__device__ __forceinline__ uint32_t positive2(__nv_bfloat162 x) {
  return positive2(*reinterpret_cast<uint32_t*>(&x));
}

// Byte offset of 16-byte chunk c (docs 8c..8c+7) of row k of the staged
// tile, in the canonical 128-byte-swizzled layout of a docs-major wgmma
// operand: atoms of 8 rows x 64 docs (1 KB, 1 KB aligned) whose row r holds
// its 16-byte chunks XOR-ed with r; two atoms along the docs, then the next
// 8 rows. The swizzle spreads the 8 rows of a chunk over all banks.
__device__ __forceinline__ uint32_t core_offset(int k, int c) {
  return (uint32_t)((k / 8) * kKGroupBytes + (c / 8) * kAtomBytes +
                    (k % 8) * 128 + (((c % 8) ^ (k % 8)) * 16));
}

// Copies tile `tile` of the bank ([U8, 128] bf16) into the buffer at shared
// address s_buf with cp.async, as one commit group of the block's threads.
__device__ __forceinline__ void stage_tile(uint32_t s_buf,
                                           const __nv_bfloat16* bank,
                                           int64_t tile, int U8, int64_t D) {
  const char* src = reinterpret_cast<const char*>(bank + tile * kLane);
  for (int i = threadIdx.x; i < U8 * 16; i += blockDim.x) {
    const int k = i >> 4, c = i & 15;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"(s_buf + core_offset(k, c)),
                    "l"(src + (int64_t)k * D * 2 + c * 16));
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Persistent: block (x, y), one warpgroup, walks tiles x, x + gridDim.x, ...
// (neighbouring blocks read neighbouring tiles of every bank row together)
// for the 64-query chunks [y * chunks_per_y, ...). Per tile it stages the
// bank tile in shared memory, then per chunk runs the KS k-steps as
// asynchronous wgmma batches of kGroup (the A fragments of the next batch
// load while a batch runs), and reduces the 64 x 128 sums in registers:
// tmax[q, tile] = bf16(max over the tile's docs of P[q, d]); #(P[q, d] > 0
// && live[d]) adds to the block's count of q in shared memory, which goes to
// hits[q] (zeroed by pack_indicator_kernel) with one integer atomicAdd when
// the block ends: exact in any order.
//
// The epilogue stays on packed bf16 pairs: rounding to nearest is monotone,
// so the max of the rounded sums is the rounded max. A sum is > 0 iff its
// bf16 rounding is (no sum is subnormal), and set.gt.bf16x2 maps each pair
// of rounded sums to 0 or 1 in one instruction; those 0/1 pairs form an
// m16k16 A fragment (the sums of two neighbouring 8-doc groups), and one
// mma.sync per 16 docs against the live docs (a B fragment of 0/1 from
// shared memory) counts the matches per query, exact as a sum of at most
// 128 ones.
//
// Dynamic shared memory: the tile, KS * 16 rows x 256 bytes (core_offset);
// the tile's live docs as 128 rows of 8 equal bf16 (2 KB); chunks_per_y * 64
// counts.
__global__ void __launch_bounds__(kWgThreads) approx_or_mma_kernel(
    const __nv_bfloat16* __restrict__ bank, const float* __restrict__ live,
    const uint4* __restrict__ packed, float* __restrict__ tmax,
    int32_t* __restrict__ hits, int U8, int Q, int KS, int chunks_per_y,
    int64_t D) {
  extern __shared__ __align__(1024) unsigned char s_mem[];
  const uint32_t s_tile = (uint32_t)__cvta_generic_to_shared(s_mem);
  const int tile_bytes = KS * 16 * kLane * 2;
  unsigned char* s_live = s_mem + tile_bytes;
  const uint32_t s_live_addr = s_tile + tile_bytes;
  int32_t* s_cnt = reinterpret_cast<int32_t*>(s_live + kLane * 16);
  const int64_t S = D / kLane;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int chunks = (Q + kChunkQ - 1) / kChunkQ;
  const int c_begin = (int)blockIdx.y * chunks_per_y;
  const int c_end = min(chunks, c_begin + chunks_per_y);

  int64_t tile = blockIdx.x;
  stage_tile(s_tile, bank, tile, U8, D);
  // counts, and the zero rows that pad K to KS * 16
  for (int i = threadIdx.x; i < chunks_per_y * kChunkQ; i += kWgThreads) {
    s_cnt[i] = 0;
  }
  for (int i = U8 * 16 + threadIdx.x; i < KS * 16 * 16; i += kWgThreads) {
    *reinterpret_cast<uint4*>(s_mem + core_offset(i >> 4, i & 15)) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  // B descriptor of k-step 0 (cute's GmmaDescriptor): start address,
  // leading byte offset (the two 64-doc atoms), stride byte offset (8-row
  // groups), all in 16-byte units; layout 1 = 128-byte swizzle, which needs
  // the tile 1 KB aligned (the kernel has no static shared memory, so the
  // dynamic one starts aligned: checked). k-step ks starts 2 ks row groups on.
  if (s_tile & (kAtomBytes - 1)) __trap();
  const uint64_t desc0 = (uint64_t)((s_tile >> 4) & 0x3fff) |
                         ((uint64_t)(kAtomBytes >> 4) << 16) |
                         ((uint64_t)(kKGroupBytes >> 4) << 32) | (1ull << 62);
  const uint64_t desc_step = (uint64_t)(2 * kKGroupBytes) >> 4;

  // the warp's A fragments of a tile: (chunk, k-step) in order, the same
  // stream for every tile; each batch loads the next batch's fragments
  auto frag = [&](int ch, int ks) {
    return packed + ((int64_t)(4 * ch + warp) * KS + ks) * 32 + lane;
  };
  uint4 a[kGroup], n[kGroup];
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    a[i] = (c_begin < c_end && i < KS) ? __ldg(frag(c_begin, i))
                                       : make_uint4(0u, 0u, 0u, 0u);
  }

  for (; tile < S; tile += gridDim.x) {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    // live docs of the tile: row d holds 8 copies of live[d] as bf16 0 or 1
    {
      const uint32_t v = __ldg(live + tile * kLane + threadIdx.x) > 0.f
                             ? 0x3f803f80u : 0u;
      *reinterpret_cast<uint4*>(s_live + threadIdx.x * 16) =
          make_uint4(v, v, v, v);
    }
    // the tile and the zero rows were written by the generic proxy; wgmma
    // reads them through the async proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();

    for (int ch = c_begin; ch < c_end; ++ch) {
      float acc[64];
      for (int kb = 0; kb < KS; kb += kGroup) {
        // the next batch of this stream: later k-steps, the next chunk, or
        // the first chunk again for the next tile
        int nch = ch, nkb = kb + kGroup;
        if (nkb >= KS) {
          nkb = 0;
          nch = ch + 1 < c_end ? ch + 1 : c_begin;
        }
#pragma unroll
        for (int i = 0; i < kGroup; ++i) fence_operand(a[i]);
#pragma unroll
        for (int i = 0; i < 64; ++i) fence_operand(acc[i]);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          if (kb + i < KS) {
            wgmma_m64n128k16(acc, a[i], desc0 + (kb + i) * desc_step,
                             kb + i > 0);
          }
        }
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          n[i] = nkb + i < KS ? __ldg(frag(nch, nkb + i)) : a[i];
        }
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          fence_operand(a[i]);
          a[i] = n[i];
        }
#pragma unroll
        for (int i = 0; i < 64; ++i) fence_operand(acc[i]);
      }
      // rows g and g + 8 of the warp's 16; docs 8j + 2t + {0, 1} in
      // acc[4j + {0, 1}] (row g) and acc[4j + {2, 3}] (row g + 8)
      float cnt[4];
      __nv_bfloat162 mx[2];  // row g, row g + 8
      uint32_t l0, l1, l2, l3;  // live docs of 32 docs: B fragments of 16
#pragma unroll
      for (int J = 0; J < kNFrags / 2; ++J) {  // 16 docs: groups 2J, 2J+1
        if (J % 2 == 0) {
          ldmatrix_x4_trans(s_live_addr + (32 * (J / 2) + lane) * 16, l0, l1,
                            l2, l3);
        }
        const float* lo = acc + 4 * (2 * J);
        const float* hi = acc + 4 * (2 * J + 1);
        const __nv_bfloat162 p0 = __floats2bfloat162_rn(lo[0], lo[1]);
        const __nv_bfloat162 p1 = __floats2bfloat162_rn(lo[2], lo[3]);
        const __nv_bfloat162 p2 = __floats2bfloat162_rn(hi[0], hi[1]);
        const __nv_bfloat162 p3 = __floats2bfloat162_rn(hi[2], hi[3]);
        const __nv_bfloat162 top_g = __hmax2(p0, p2);
        const __nv_bfloat162 top_g8 = __hmax2(p1, p3);
        mx[0] = J == 0 ? top_g : __hmax2(mx[0], top_g);
        mx[1] = J == 0 ? top_g8 : __hmax2(mx[1], top_g8);
        const uint4 y = make_uint4(positive2(p0), positive2(p1),
                                   positive2(p2), positive2(p3));
        const uint32_t lb0 = (J % 2 == 0) ? l0 : l2;
        const uint32_t lb1 = (J % 2 == 0) ? l1 : l3;
        if (J == 0) {
          mma_bf16<true>(cnt, y, lb0, lb1);
        } else {
          mma_bf16<false>(cnt, y, lb0, lb1);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float top = __bfloat162float(__hmax(mx[r].x, mx[r].y));
        top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, 1));
        top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, 2));
        const int qc = 16 * warp + 8 * r + g;  // row of the chunk
        const int q = ch * kChunkQ + qc;
        if (t == 0 && q < Q) {
          tmax[(int64_t)q * S + tile] = top;  // a bf16 value already
          s_cnt[(ch - c_begin) * kChunkQ + qc] +=
              __float2int_rn(cnt[2 * r]);  // one thread per q
        }
      }
    }
    __syncthreads();  // every warp is done with the tile and s_live
    if (tile + gridDim.x < S) {
      stage_tile(s_tile, bank, tile + gridDim.x, U8, D);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < (c_end - c_begin) * kChunkQ; i += kWgThreads) {
    const int q = c_begin * kChunkQ + i;
    if (q < Q && s_cnt[i] != 0) atomicAdd(hits + q, s_cnt[i]);
  }
}

// ---------------------------------------------------------------------------
// B4 and B5: the boolean selects on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kBoolStreamWarps = 8;  // the indicators left in global memory
constexpr int kRun = 8;  // tiles whose maxima leave together: 32 bytes a query
constexpr int kFragQ = 16;  // queries per m16 fragment
// a block's shared memory per fragment: its slab of maxima, its counts and
// its queries' match parameters
constexpr int kFragBytes = kFragQ * (kRun + 3) * 4;
constexpr int kMatABytes = 32 * 16;  // per k-step: one matrix's A fragment

// The two forms of bool_select. B5 (kCounts 1): the score product and the
// combined count product cc, over two passes of 64 docs. B4 (kCounts 3): the
// score product and the required, should and must_not counts, over four
// passes of 32 docs. Either way a thread holds 64 sums. An SM runs at most
// kMaxWarps of them with the indicators in shared memory: 16 at B5's 127
// registers a thread; B4's four A fragments a k-step need more than 128
// (ptxas spilled there), so 12, at up to 168.
template <int kCounts>
struct BoolForm {
  static constexpr int kMaxWarps = kCounts == 1 ? 16 : 12;
  static constexpr int kMats = 1 + kCounts;  // a_sc, then the counts
  static constexpr int kPass = kCounts == 1 ? 64 : 32;  // docs a pass
  static constexpr int kNF = kPass / 8;  // n8 fragments a pass
  static constexpr int kSums = 4 * kNF;  // sums a thread and product
  static constexpr int kWords = kPass / 32;  // live words a pass
};

// B5's match test rc == nreq && oc >= msm && cc > 0 on an exact integer cc
// (rc = floor(cc / 256), oc = cc - 256 rc) as |cc - mid| <= half: the range
// [max(256 nreq + max(ceil(msm), 0), 1), 256 nreq + 255], empty (half < 0)
// unless nreq is an integer in [0, 255]. Every value is a small integer or
// half of one, so the arithmetic is exact.
// Returns (mid, half) of query q; no count matches a query past Q.
__device__ __forceinline__ float2 match_range(const float* params, int Q,
                                              int q) {
  if (q >= Q) return make_float2(0.f, -1.f);
  const float nreq = __ldg(params + q), msm = __ldg(params + Q + q);
  const float base = __fmul_rn(256.f, nreq);
  const float lo = fmaxf(__fadd_rn(base, fmaxf(ceilf(msm), 0.f)), 1.f);
  const float hi = __fadd_rn(base, 255.f);
  const bool ok = nreq >= 0.f && nreq <= 255.f && nreq == floorf(nreq) &&
                  msm == msm;
  return make_float2(__fmul_rn(0.5f, __fadd_rn(lo, hi)),
                     ok ? __fmul_rn(0.5f, __fsub_rn(hi, lo)) : -1.f);
}

// B4's match test rc == nreq && oc >= msm && nc == 0 && rc + oc > 0 on exact
// integer counts as rc == nreq && oc >= lo && nc == 0: where rc == nreq,
// rc + oc > 0 fails only for nreq 0 with oc 0, so lo = ceil(msm), at least 1
// where nreq is 0; +inf where msm is NaN, which nothing matches.
// Returns (nreq, lo) of query q; no count matches a query past Q (rc >= 0).
__device__ __forceinline__ float2 match_counts(const float* params, int Q,
                                               int q) {
  if (q >= Q) return make_float2(-1.f, 0.f);
  const float nreq = __ldg(params + q), msm = __ldg(params + Q + q);
  float lo = msm == msm ? ceilf(msm) : __int_as_float(0x7f800000);
  if (nreq == 0.f) lo = fmaxf(lo, 1.f);
  return make_float2(nreq, lo);
}

// Sum i of a pass against query parameters rg (match_range or match_counts).
template <int kCounts, int N>
__device__ __forceinline__ bool matches(const float (&cnt)[kCounts][N], int i,
                                        float2 rg) {
  if constexpr (kCounts == 1) {
    return fabsf(__fsub_rn(cnt[0][i], rg.x)) <= rg.y;
  } else {
    return cnt[0][i] == rg.x && cnt[1][i] >= rg.y && cnt[2][i] == 0.f;
  }
}

// Block (x, y), 4 to kMaxWarps warps, owns the runs x, x + gridDim.x, ...
// of `run` neighbouring tiles and the 16-query fragments [y * mf_per_y,
// ...). With A_SMEM it first copies its fragments of every packed indicator
// into shared memory, where they stay for every tile (from global memory
// each A fragment is an L2 round trip per k-step); the launcher leaves them
// in global memory only where they do not fit beside the tile, and the
// kernel then loads them a k-step ahead. Per tile the block stages the [U8, 128] slab (cp.async;
// with nbuf = 2 the next tile's copy runs under this tile's MMAs), and each
// warp takes fragments warp, warp + warps, ... of the block's range: per pass
// of the tile's docs, the count products (the counts' A x (bank > 0)) and the
// score product ap = a_sc x bank from the same B fragments, 64 sums a thread
// in registers; then the matches (matches) as bits against the live bits of
// the lane's columns, and the f32 max of ap. tmax[q, tile] = max over the
// tile's docs of ap[q, d] where a live doc of the tile matches, else -1,
// through the block's [queries, kRun] slab; hits[q] (zeroed by
// pack_indicator_kernel) += the block's matches of q, one integer atomicAdd
// per (block, query).
//
// Dynamic shared memory: nbuf tiles of KS * 16 rows x 256 bytes
// (core_offset); with A_SMEM mf_per_y * KS * kMats * kMatABytes of A
// fragments, [fragment][k-step][matrix][lane]; 4 words of live bits;
// mf_per_y * 16 * kRun maxima; mf_per_y * 16 counts; mf_per_y * 16 match
// parameters.
template <int kCounts, bool A_SMEM>
__device__ __forceinline__ void bool_select(
    const __nv_bfloat16* __restrict__ bank, const float* __restrict__ live,
    const float* __restrict__ params, const uint4* __restrict__ packed,
    float* __restrict__ tmax, int32_t* __restrict__ hits, int U8, int Q,
    int KS, int MF, int mf_per_y, int nbuf, int run, int64_t D) {
  using F = BoolForm<kCounts>;
  extern __shared__ __align__(1024) unsigned char s_mem[];
  const uint32_t s_tile = (uint32_t)__cvta_generic_to_shared(s_mem);
  const int tile_bytes = KS * 16 * kLane * 2;
  uint4* s_a = reinterpret_cast<uint4*>(s_mem + nbuf * tile_bytes);
  const int a_bytes = A_SMEM ? mf_per_y * KS * F::kMats * kMatABytes : 0;
  uint32_t* s_live =
      reinterpret_cast<uint32_t*>(s_mem + nbuf * tile_bytes + a_bytes);
  float* s_max = reinterpret_cast<float*>(s_live + 4);
  int32_t* s_cnt =
      reinterpret_cast<int32_t*>(s_max + mf_per_y * kFragQ * kRun);
  float2* s_range = reinterpret_cast<float2*>(s_cnt + mf_per_y * kFragQ);
  const int S = (int)(D / kLane);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mf_begin = (int)blockIdx.y * mf_per_y;
  const int mf_end = min(MF, mf_begin + mf_per_y);
  // the block's tiles in order: tile `tile` of the run that starts at run0
  int run0 = (int)blockIdx.x * run;
  int tile = run0;
  if (tile >= S) return;

  stage_tile(s_tile, bank, tile, U8, D);
  // threads 0..127 hold the next tile's live docs, loaded one tile ahead
  float lv = threadIdx.x < kLane
                 ? __ldg(live + (int64_t)tile * kLane + threadIdx.x) : 0.f;
  for (int i = threadIdx.x; i < mf_per_y * kFragQ; i += blockDim.x) {
    const int q = mf_begin * kFragQ + i;
    s_cnt[i] = 0;
    s_range[i] = kCounts == 1 ? match_range(params, Q, q)
                              : match_counts(params, Q, q);
  }
  // the zero rows that pad K to KS * 16, in every buffer
  for (int b = 0; b < nbuf; ++b) {
    for (int i = U8 * 16 + threadIdx.x; i < KS * 16 * 16; i += blockDim.x) {
      *reinterpret_cast<uint4*>(s_mem + b * tile_bytes +
                                core_offset(i >> 4, i & 15)) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
  if (A_SMEM) {
    const int per_mat = (mf_end - mf_begin) * KS * 32;
    for (int i = threadIdx.x; i < F::kMats * per_mat; i += blockDim.x) {
      // r = (fragment * KS + k-step) * 32 + lane
      const int mat = i / per_mat, r = i % per_mat;
      s_a[(r / 32 * F::kMats + mat) * 32 + r % 32] =
          __ldg(packed + ((int64_t)(mat * MF + mf_begin) * KS) * 32 + r);
    }
  }
  // lane's A fragments of (fragment mf, k-step ks): a_sc, then the counts
  auto load_a = [&](int mf, int ks, uint4 (&a)[F::kMats]) {
    if (A_SMEM) {
      const uint4* f =
          s_a + ((mf - mf_begin) * KS + ks) * (32 * F::kMats) + lane;
#pragma unroll
      for (int m = 0; m < F::kMats; ++m) a[m] = f[32 * m];
    } else {
      const uint4* f = packed + ((int64_t)mf * KS + ks) * 32 + lane;
#pragma unroll
      for (int m = 0; m < F::kMats; ++m) {
        a[m] = __ldg(f + (int64_t)m * MF * KS * 32);
      }
    }
  };
  // ldmatrix.x4.trans: lanes 8i..8i+7 address the 8 rows of matrix i; matrices
  // 0, 1 are rows 0-7 and 8-15 of the k-step at one 8-doc chunk (b0, b1 of
  // one n8 fragment), matrices 2, 3 the same rows at the next chunk
  const int lm_row = lane & 7;
  const int lm_chunk = lane >> 4;
  const uint32_t lm_off = ((lane >> 3) & 1) * kKGroupBytes + lm_row * 128;

  for (int n = 0;; ++n) {
    const int cur = nbuf == 2 ? (n & 1) : 0;
    const int col = tile - run0;  // the tile's column of the slab
    const bool run_ends = col + 1 == run || tile + 1 == S;
    const int next_run0 = run_ends ? run0 + (int)gridDim.x * run : run0;
    const int next = run_ends ? next_run0 : tile + 1;
    const bool more = next < S;
    if (nbuf == 2 && more) {
      stage_tile(s_tile + (cur ^ 1) * tile_bytes, bank, next, U8, D);
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    if (threadIdx.x < kLane) {
      const unsigned on = __ballot_sync(0xffffffffu, lv > 0.f);
      if (lane == 0) s_live[warp] = on;
      if (more) lv = __ldg(live + (int64_t)next * kLane + threadIdx.x);
    }
    __syncthreads();  // the tile, the live bits (and A) are in place
    const uint32_t buf = s_tile + cur * tile_bytes;
    // live bits of the lane's columns: docs 32 w + 8 j + 2 t + e at bit
    // 8 j + e of x[w]
    uint32_t x[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) x[w] = (s_live[w] >> (2 * t)) & 0x03030303u;

    for (int mf = mf_begin + warp; mf < mf_end; mf += warps) {
      const int r0 = (mf - mf_begin) * kFragQ + g;  // lane's rows: r0, r0 + 8
      const float2 rg0 = s_range[r0], rg1 = s_range[r0 + 8];
      float mx0 = 0.f, mx1 = 0.f;  // no sum is negative
      int c0 = 0, c1 = 0;
#pragma unroll
      for (int h = 0; h < kLane / F::kPass; ++h) {  // docs kPass h, ...
        float ap[F::kSums], cnt[kCounts][F::kSums];
        uint4 a[F::kMats];
        if (!A_SMEM) load_a(mf, 0, a);
        // the pass's 64-doc atom of the staged tile and its first 8-doc chunk
        const uint32_t atom =
            buf + lm_off + (F::kPass * h / 64) * kAtomBytes;
        const int c_base = F::kPass * h % 64 / 8;
        // k-step ks into the sums; the first one starts them from zero
        auto k_step = [&](int ks, auto first) {
          constexpr bool kFirst = decltype(first)::value;
          uint4 nxt[F::kMats];
          if (A_SMEM) {
            load_a(mf, ks, a);
          } else if (ks + 1 < KS) {
            load_a(mf, ks + 1, nxt);  // an L2 round trip: a k-step ahead
          }
          const uint32_t row = atom + 2 * ks * kKGroupBytes;
#pragma unroll
          for (int jj = 0; jj < F::kNF / 2; ++jj) {  // 16 docs: 2jj, 2jj+1
            uint32_t b0, b1, b2, b3;
            ldmatrix_x4_trans(
                row + (((c_base + 2 * jj + lm_chunk) ^ lm_row) << 4), b0, b1,
                b2, b3);
            const uint32_t p0 = positive2(b0), p1 = positive2(b1);
            const uint32_t p2 = positive2(b2), p3 = positive2(b3);
#pragma unroll
            for (int c = 0; c < kCounts; ++c) {
              mma_bf16<kFirst>(cnt[c] + 8 * jj, a[1 + c], p0, p1);
              mma_bf16<kFirst>(cnt[c] + 8 * jj + 4, a[1 + c], p2, p3);
            }
            mma_bf16<kFirst>(ap + 8 * jj, a[0], b0, b1);
            mma_bf16<kFirst>(ap + 8 * jj + 4, a[0], b2, b3);
          }
          if (!A_SMEM && ks + 1 < KS) {
#pragma unroll
            for (int m = 0; m < F::kMats; ++m) a[m] = nxt[m];
          }
        };
        k_step(0, std::true_type{});
        for (int ks = 1; ks < KS; ++ks) k_step(ks, std::false_type{});
        // n8 fragment j: docs kPass h + 8 j + 2 t + e in [4 j + e] (row g)
        // and [4 j + 2 + e] (row g + 8)
        uint32_t m0[F::kWords] = {}, m1[F::kWords] = {};
#pragma unroll
        for (int j = 0; j < F::kNF; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const uint32_t bit = 1u << (8 * (j % 4) + e);
            if (matches(cnt, 4 * j + e, rg0)) m0[j / 4] |= bit;
            if (matches(cnt, 4 * j + 2 + e, rg1)) m1[j / 4] |= bit;
          }
          mx0 = fmaxf(mx0, fmaxf(ap[4 * j], ap[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(ap[4 * j + 2], ap[4 * j + 3]));
        }
#pragma unroll
        for (int w = 0; w < F::kWords; ++w) {
          c0 += __popc(m0[w] & x[F::kWords * h + w]);
          c1 += __popc(m1[w] & x[F::kWords * h + w]);
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {  // the 4 lanes of a row
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
        c0 += __shfl_xor_sync(0xffffffffu, c0, o);
        c1 += __shfl_xor_sync(0xffffffffu, c1, o);
      }
      if (t == 0) {  // one thread per query of the block
        s_max[r0 * kRun + col] = c0 > 0 ? mx0 : -1.f;
        s_max[(r0 + 8) * kRun + col] = c1 > 0 ? mx1 : -1.f;
        s_cnt[r0] += c0;
        s_cnt[r0 + 8] += c1;
      }
    }
    __syncthreads();  // every warp is done with the tile, and the slab is set
    if (nbuf == 1 && more) stage_tile(s_tile, bank, next, U8, D);
    if (run_ends) {
      // the run's maxima: 8 neighbouring threads write one query's 32 bytes;
      // the slab is next written after the next tile's first barrier
      for (int i = threadIdx.x; i < (mf_end - mf_begin) * kFragQ * kRun;
           i += blockDim.x) {
        const int q = mf_begin * kFragQ + i / kRun;
        const int r = i % kRun;
        if (q < Q && r <= col) tmax[(int64_t)q * S + run0 + r] = s_max[i];
      }
    }
    if (!more) break;
    tile = next;
    run0 = next_run0;
  }
  for (int i = threadIdx.x; i < (mf_end - mf_begin) * kFragQ;
       i += blockDim.x) {
    const int q = mf_begin * kFragQ + i;
    if (q < Q && s_cnt[i] != 0) atomicAdd(hits + q, s_cnt[i]);
  }
}

#define DIAGON_BOOL_SELECT_ARGS                                               \
  const __nv_bfloat16 *__restrict__ bank, const float *__restrict__ live,     \
      const float *__restrict__ params, const uint4 *__restrict__ packed,     \
      float *__restrict__ tmax, int32_t *__restrict__ hits, int U8, int Q,    \
      int KS, int MF, int mf_per_y, int nbuf, int run, int64_t D

// B4: the score and three count products.
template <bool A_SMEM>
__global__ void __launch_bounds__(32 * (A_SMEM ? BoolForm<3>::kMaxWarps
                                               : kBoolStreamWarps), 1)
    approx_bool_mma_kernel(DIAGON_BOOL_SELECT_ARGS) {
  bool_select<3, A_SMEM>(bank, live, params, packed, tmax, hits, U8, Q, KS,
                         MF, mf_per_y, nbuf, run, D);
}

// B5: the score and the combined count product.
template <bool A_SMEM>
__global__ void __launch_bounds__(32 * (A_SMEM ? BoolForm<1>::kMaxWarps
                                               : kBoolStreamWarps), 1)
    approx_bool2_mma_kernel(DIAGON_BOOL_SELECT_ARGS) {
  bool_select<1, A_SMEM>(bank, live, params, packed, tmax, hits, U8, Q, KS,
                         MF, mf_per_y, nbuf, run, D);
}

#undef DIAGON_BOOL_SELECT_ARGS

// The fewest warps (4 to `most`) that take `frags` fragments in as few rounds
// as `most` warps would: 13 fragments run on 13 warps, not on 8 in two rounds.
int balanced_warps(int64_t frags, int most) {
  const int64_t rounds = (frags + most - 1) / most;
  const int64_t warps = (frags + rounds - 1) / rounds;
  return (int)(warps < 4 ? 4 : warps);
}

template <int kCounts, bool A_SMEM>
int launch_bool_kernel(dim3 grid, int warps, size_t smem, cudaStream_t stream,
                       const void* bank, const float* live,
                       const float* params, const uint4* packed, float* tmax,
                       int32_t* hits, int U8, int Q, int KS, int MF,
                       int mf_per_y, int nbuf, int run, int64_t D) {
  auto* kernel = kCounts == 1 ? approx_bool2_mma_kernel<A_SMEM>
                              : approx_bool_mma_kernel<A_SMEM>;
  static bool sized = false;  // once per instantiation: the largest block
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  kernel<<<grid, warps * 32, smem, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(bank), live, params, packed, tmax,
      hits, U8, Q, KS, MF, mf_per_y, nbuf, run, D);
  return (int)cudaGetLastError();
}

// B4 (kCounts 3) and B5 (kCounts 1): packs the indicators (which zeroes hits)
// and sizes the grid: x over the runs of tiles, y over ranges of fragments.
// The block keeps its fragments' A in shared memory beside two tile buffers,
// or beside one, where at least min(MF, 8) fragments fit so; grid.y then
// splits the fragments as the shared memory needs (and grid.x shrinks so
// the grid stays one wave), and further where the tiles alone leave SMs
// idle; one or two persistent blocks an SM, with as many warps as balance a
// block's fragments. Else (U8 of several hundred) A
// stays in global memory: 8 warps, the slab alone beside one or two tile
// buffers.
template <int kCounts>
int launch_bool_mma(const Indicators& ind, const void* bank,
                    const float* params, const float* live, uint4* packed,
                    float* tmax, int32_t* hits, int U8, int Q, int64_t D,
                    cudaStream_t stream) {
  using F = BoolForm<kCounts>;
  const int KS = (U8 + 15) / 16;
  const int MF = (Q + kFragQ - 1) / kFragQ;
  const int64_t n_packed = (int64_t)F::kMats * MF * KS * 32;
  pack_indicator_kernel<<<(unsigned)((n_packed + 255) / 256), 256, 0,
                          stream>>>(ind, U8, Q, MF, KS, packed, hits);
  const int64_t S = D / kLane;
  const int64_t tile_bytes = (int64_t)KS * 16 * kLane * sizeof(__nv_bfloat16);
  const int64_t fixed = 16;  // the live bits
  const int64_t want = MF < 8 ? MF : 8;
  bool a_smem = true;
  int nbuf = 2;
  int64_t per_frag = (int64_t)KS * F::kMats * kMatABytes + kFragBytes;
  int64_t cap = (kMaxSmem - 2 * tile_bytes - fixed) / per_frag;
  if (cap < want) {
    nbuf = 1;
    cap = (kMaxSmem - tile_bytes - fixed) / per_frag;
  }
  if (cap < want) {
    a_smem = false;
    per_frag = kFragBytes;
    nbuf = 2 * tile_bytes + fixed + want * per_frag <= kMaxSmem ? 2 : 1;
    cap = (kMaxSmem - nbuf * tile_bytes - fixed) / per_frag;
  }
  if (cap < 1) return (int)cudaErrorInvalidValue;
  // two blocks an SM where their shared memory allows (each then takes half
  // the warps): one computes while the other waits at its tile's barriers
  const int per_sm =
      2 * (nbuf * tile_bytes + fixed + (MF < cap ? MF : cap) * per_frag +
           kBlockReserve) <= kSmSmem ? 2 : 1;
  const int64_t blocks = kSms * per_sm;
  // runs of kRun tiles; shorter ones where those would leave SMs idle
  int run = kRun;
  while (run > 1 && (S + run - 1) / run < blocks) run /= 2;
  const int64_t runs = (S + run - 1) / run;
  // where the shared memory splits the fragments over min_ys blocks, the
  // x-blocks shrink to match, so the grid is one wave and a block copies
  // its fragments once for many tiles (B4 at U8 168: 8 fragments a block)
  const int64_t min_ys = (MF + cap - 1) / cap;
  const int64_t gx_cap = blocks / min_ys > 1 ? blocks / min_ys : 1;
  const int64_t gx = runs < gx_cap ? runs : gx_cap;
  int64_t ys = (blocks + gx - 1) / gx;
  if (ys > MF) ys = MF;
  if (ys < min_ys) ys = min_ys;
  if (ys > kMaxGridY) return (int)cudaErrorInvalidValue;
  const int mf_per_y = (int)((MF + ys - 1) / ys);
  ys = (MF + mf_per_y - 1) / mf_per_y;
  const size_t smem =
      (size_t)(nbuf * tile_bytes + fixed + (int64_t)mf_per_y * per_frag);
  const dim3 grid((unsigned)gx, (unsigned)ys);
  const int warps = balanced_warps(
      mf_per_y, a_smem ? F::kMaxWarps / per_sm : kBoolStreamWarps);
  auto* launch = a_smem ? launch_bool_kernel<kCounts, true>
                        : launch_bool_kernel<kCounts, false>;
  return launch(grid, warps, smem, stream, bank, live, params, packed, tmax,
                hits, U8, Q, KS, MF, mf_per_y, nbuf, run, D);
}

int launch_or_mma(const void* a_t, const void* bank, const float* live,
                  uint4* packed, float* tmax, int32_t* hits, int U8, int Q,
                  int64_t D, cudaStream_t stream) {
  const int KS = (U8 + 15) / 16;
  const int chunks = (Q + kChunkQ - 1) / kChunkQ;
  const int64_t n_packed = (int64_t)4 * chunks * KS * 32;
  pack_indicator_kernel<<<(unsigned)((n_packed + 255) / 256), 256, 0,
                          stream>>>(
      Indicators{{reinterpret_cast<const __nv_bfloat16*>(a_t)}, 1}, U8, Q,
      4 * chunks, KS, packed, hits);
  const int64_t S = D / kLane;
  // split the chunks over grid.y when the tiles alone leave SMs idle, or
  // when the block's counts would not fit beside the tile
  const size_t tile_bytes = (size_t)KS * 16 * kLane * sizeof(__nv_bfloat16);
  int64_t cap = (kMaxSmem - (int64_t)tile_bytes - kLane * 16) / (kChunkQ * 4);
  if (cap < 1) return (int)cudaErrorInvalidValue;
  if (cap > kMaxChunksPerBlock) cap = kMaxChunksPerBlock;
  int64_t ys = (kWgBlocks + S - 1) / S;
  if (ys > chunks) ys = chunks;
  const int64_t min_ys = (chunks + cap - 1) / cap;
  if (ys < min_ys) ys = min_ys;
  if (ys > kMaxGridY) ys = kMaxGridY;
  const int chunks_per_y = (int)((chunks + ys - 1) / ys);
  const size_t smem =
      tile_bytes + kLane * 16 + (size_t)chunks_per_y * kChunkQ * 4;
  cudaError_t err = cudaFuncSetAttribute(approx_or_mma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(S < kWgBlocks ? S : kWgBlocks), (unsigned)ys);
  approx_or_mma_kernel<<<grid, kWgThreads, smem, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(bank), live, packed, tmax, hits,
      U8, Q, KS, chunks_per_y, D);
  return (int)cudaGetLastError();
}

}  // namespace

// Launchers: plain C interface for ctypes. Each runs on the given stream,
// allocates nothing and returns cudaGetLastError() (0 = launched).
//
// Preconditions, checked by the Python wrapper: all tensors contiguous on one
// device; bank bf16 [U8, D], 16-byte aligned; live f32 [D], 16-byte aligned;
// outputs tmax f32 [Q, D/128], hits i32 [Q]; 8 <= U8 <= 896, U8 % 8 == 0,
// D % 128 == 0, Q >= 1. Each zeroes hits and sums into it with atomics.

// B3: a_t bf16 [U8, Q]; scratch packed: 4 * ceil(Q / 64) * ceil(U8 / 16) * 32
// uint4 (16-byte aligned), the indicator in fragment order.
extern "C" int diagon_approx_select(const void* a_t, const void* bank,
                                    const float* live, void* packed,
                                    float* tmax, int32_t* hits, int U8, int Q,
                                    int64_t D, cudaStream_t stream) {
  return launch_or_mma(a_t, bank, live, reinterpret_cast<uint4*>(packed),
                       tmax, hits, U8, Q, D, stream);
}

// B4: a_sc, a_rq, a_sh, a_ng bf16 [U8, Q]; params f32 [8, Q] (rows 0
// num_required, 1 min_should); scratch packed: 4 * ceil(Q / 16) *
// ceil(U8 / 16) * 32 uint4 (16-byte aligned), the four indicators in
// fragment order.
extern "C" int diagon_approx_select_bool(
    const void* a_sc, const void* a_rq, const void* a_sh, const void* a_ng,
    const void* bank, const float* params, const float* live, void* packed,
    float* tmax, int32_t* hits, int U8, int Q, int64_t D,
    cudaStream_t stream) {
  const Indicators ind{{static_cast<const __nv_bfloat16*>(a_sc),
                        static_cast<const __nv_bfloat16*>(a_rq),
                        static_cast<const __nv_bfloat16*>(a_sh),
                        static_cast<const __nv_bfloat16*>(a_ng)},
                       4};
  return launch_bool_mma<3>(ind, bank, params, live,
                            reinterpret_cast<uint4*>(packed), tmax, hits, U8,
                            Q, D, stream);
}

// B5: a_sc, a_cb bf16 [U8, Q]; params as B4's; scratch packed: 2 *
// ceil(Q / 16) * ceil(U8 / 16) * 32 uint4 (16-byte aligned), both indicators
// in fragment order.
extern "C" int diagon_approx_select_bool2(const void* a_sc, const void* a_cb,
                                          const void* bank,
                                          const float* params,
                                          const float* live, void* packed,
                                          float* tmax, int32_t* hits, int U8,
                                          int Q, int64_t D,
                                          cudaStream_t stream) {
  const Indicators ind{{static_cast<const __nv_bfloat16*>(a_sc),
                        static_cast<const __nv_bfloat16*>(a_cb)},
                       2};
  return launch_bool_mma<1>(ind, bank, params, live,
                            reinterpret_cast<uint4*>(packed), tmax, hits, U8,
                            Q, D, stream);
}
