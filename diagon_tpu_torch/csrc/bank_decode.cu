// Posting blocks decoded into dense score rows for Hopper (sm_90a): B9, the
// row engine's bank build (the resident heavy bank at set-up, each batch's
// light bank, the on-demand row groups).
//
// Replaces no Pallas kernel: the JAX package builds its banks with jitted
// XLA gathers and a scatter (diagon_tpu/search/row_engine.py:1004
// _build_bank_chunk), which the port first carried over as about twenty
// int64 torch ops a 65,536-block chunk, each materialising a [chunk, 128]
// temporary, with the chunk's block metadata gathered and uploaded by the
// host. Those ops remain as the CPU path and the card's oracle
// (ops/bank_decode.py bank_decode_reference).
//
// What it computes. Spec s = (bank row r, term t, scale w) owns the term's
// posting blocks block_start[t] .. block_start[t + 1] - 1; a launch's blocks
// are its specs' blocks laid end to end, spec s's from prefix[s]. A block
// holds count <= 128 postings: count doc deltas of doc_bits bits from word
// word_off, then (freq_bits > 0) count freqs of freq_bits bits from word
// word_off + ceil(count * doc_bits / 32), value i of a section at bit
// i * bits, LSB first. Value i is the 64-bit window over the section's words
// (i * bits) / 32 and the next, each index clamped at the stream's last
// word, shifted right by (i * bits) % 32 and masked to bits. Then
//   doc  = base + (inclusive prefix sum of the deltas)
//   freq = min(freq_bits ? value : 1, F - 1)
//   bank[r, doc] = w * lut[norms[doc] * F + freq]   (one IEEE multiply)
// A term's docs strictly ascend and a bank's specs have distinct rows, so
// the targets are unique and the bank is bit-equal to the plain version's
// scatter and to the host decode (RowFieldIndex.host_row). The build passes
// --fmad=false; the multiply is __fmul_rn besides.
//
// Layout. A warp a posting block, the warps grid-strided over the launch's
// blocks. The warp finds its spec by binary search of the prefix (a few
// hundred bytes, L1 resident) and stages the block's words (both sections
// and the straddle word, at most 257) in shared memory in one coalesced
// pass. Lane l then decodes postings l, l + 32, l + 64 and l + 96, so a
// store of the warp writes 32 consecutive postings, a short run of the row
// (4 consecutive postings a lane made each store touch 32 sectors spread
// over the block's whole doc span): per run of 32, a warp-wide inclusive
// scan of the deltas gives the doc ids, then come the freqs, the norm and
// LUT reads and the store. Nothing goes through device memory but the
// words, the block's 11 bytes of table and the stores, so there is no int64
// temporary, and one launch decodes a whole bank whatever its size.
//
// Bound: bytes. A posting costs its share of the words (about 1.5 bytes at
// the SPLADE shard's widths) and 4 bytes of store; the norm byte and the
// LUT entry hit the L1/L2 (the LUT is 128 F floats). The caller zeroes the
// bank first (R * D * 4 bytes), which is most of a light bank's bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;                // postings a block, at most
constexpr int kPer = kLane / 32;          // postings a lane
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWords = 2 * kLane + 1;     // two 32-bit sections + straddle
constexpr unsigned kFull = 0xffffffffu;

// Value i, `bits` wide, of a section whose words start at sw[0]; the caller
// guarantees that words (i * bits) / 32 and the next are staged.
__device__ __forceinline__ uint32_t field(const uint32_t* sw, int i,
                                          int bits) {
  const int bitpos = i * bits;
  const int w = bitpos >> 5;
  const uint64_t win = (uint64_t)sw[w] | ((uint64_t)sw[w + 1] << 32);
  return (uint32_t)((win >> (bitpos & 31)) & ((1ull << bits) - 1ull));
}

__global__ void __launch_bounds__(kThreads)
bank_decode_kernel(float* __restrict__ bank, const int32_t* __restrict__ specs,
                   int S, int total, const int32_t* __restrict__ block_start,
                   const int32_t* __restrict__ word_off,
                   const uint8_t* __restrict__ doc_bits,
                   const uint8_t* __restrict__ freq_bits,
                   const int32_t* __restrict__ base,
                   const uint8_t* __restrict__ count,
                   const uint32_t* __restrict__ packed, int64_t W,
                   const uint8_t* __restrict__ norms,
                   const float* __restrict__ lut, int F, int64_t D) {
  __shared__ uint32_t stage[kWarps][kWords + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t* sw = stage[warp];
  // pack_specs's [4, S + 1] rows: bank row, term, scale bits, block prefix
  const int32_t* rows = specs;
  const int32_t* tids = specs + (S + 1);
  const int32_t* scales = specs + 2 * (S + 1);
  const int32_t* prefix = specs + 3 * (S + 1);
  const int64_t last = W - 1;
  const int stride = gridDim.x * kWarps;
  for (int g = blockIdx.x * kWarps + warp; g < total; g += stride) {
    // the last spec whose blocks start at or before g (an empty spec shares
    // its start with the next one, which is then the last)
    int lo = 0, hi = S - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (__ldg(prefix + mid) <= g) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    const int64_t b = (int64_t)__ldg(block_start + __ldg(tids + lo)) +
                      (g - __ldg(prefix + lo));
    const int64_t row = __ldg(rows + lo);
    const float w = __int_as_float(__ldg(scales + lo));
    const int64_t woff = __ldg(word_off + b);
    const int dbits = __ldg(doc_bits + b);
    const int fbits = __ldg(freq_bits + b);
    const int cnt = __ldg(count + b);
    const int64_t b0 = __ldg(base + b);
    const int dwords = (cnt * dbits + 31) >> 5;
    const int nw = dwords + ((cnt * fbits + 31) >> 5);
    __syncwarp();  // every lane is done with the previous block's words
    for (int i = lane; i <= nw; i += 32) {
      const int64_t at = woff + i;
      sw[i] = __ldg(packed + (at < last ? at : last));
    }
    __syncwarp();

    // lane l decodes postings l, l + 32, l + 64, l + 96: a store of the
    // warp covers 32 consecutive postings, a short run of the row
    float* out = bank + row * D;
    int64_t doc = b0;  // the doc of the posting before this 32-posting run
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (32 * j >= cnt) break;  // uniform across the warp
      const int p = 32 * j + lane;
      const bool ok = p < cnt;
      int64_t incl = ok ? (int64_t)field(sw, p, dbits) : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int64_t v = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += v;
      }
      const int64_t at = doc + incl;
      doc += __shfl_sync(kFull, incl, 31);
      if (ok && at >= 0 && at < D) {
        uint32_t f = fbits ? field(sw + dwords, p, fbits) : 1u;
        f = min(f, (uint32_t)(F - 1));
        const float tf = __ldg(lut + (int64_t)__ldg(norms + at) * F + f);
        out[at] = __fmul_rn(w, tf);
      }
    }
  }
}

}  // namespace

// bank: f32 [R, D], zeroed; specs: int32 [4, S + 1] (ops/bank_decode.py
// pack_specs) on the device; total = specs[3, S] > 0 blocks.
extern "C" int diagon_bank_decode(
    float* bank, const int32_t* specs, int S, int total,
    const int32_t* block_start, const int32_t* word_off,
    const uint8_t* doc_bits, const uint8_t* freq_bits, const int32_t* base,
    const uint8_t* count, const uint32_t* packed, int64_t W,
    const uint8_t* norms, const float* lut, int F, int64_t D, int grid,
    cudaStream_t stream) {
  if (S < 1 || total < 1 || W < 1 || F < 1 || D < 1 || grid < 1) {
    return (int)cudaErrorInvalidValue;
  }
  bank_decode_kernel<<<grid, kThreads, 0, stream>>>(
      bank, specs, S, total, block_start, word_off, doc_bits, freq_bits, base,
      count, packed, W, norms, lut, F, D);
  return (int)cudaGetLastError();
}
