#!/usr/bin/env python3
"""Drive diagon_tpu_torch's main path once on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package (``diagon_tpu``): segments
come from the port's own builder, queries from its own query sets, and the
reference answers from its own oracle. Phases (any failure raises and the
script exits non-zero), in the order they run:

1. Device: card name and power limit, SM count and top SM clock (the
   CUDA-core rates of the bounds); build the CUDA kernels from
   ``diagon_tpu_torch/csrc`` (one nvcc per source, all at once) and time
   the build; fail if ``ptxas -v`` reports a spill in a kernel of B1-B9,
   X1 or X2.
2. Kernels B1 (row_sum) and B2 (row_boolean) against their plain PyTorch
   versions on the card, bit for bit (D = 19,456; Q in {1, 3, 7, 19,
   1024}; Tq in {4, 20, 24, 64, 100}; both stage 64 clauses per pass), and
   at D = 1,003,520 with Q in {1, 3, 19}, Tq 20: the block sizes the
   wrappers pick for few queries over a long doc axis.
3. Kernels B3-B5 (approx_select, _bool, _bool2), B6 (gather_rescore)
   and B7 (union_rescore) against their plain versions at the main
   path's shapes (D in {19,456, 1,003,520}; Q in {1, 8, 820, 1024}; U8 in
   {32, 168, 512}; Tq in {4, 20}; B = 24): B6 and B7 bit for bit, and B7
   bit-equal to B6; B3-B5 equal hits and tile feasibility, tile maxima
   within 2^-8 relative (B3: one bf16 step, 2^-7); and the soundness of
   the bound: tmax * (1 +
   2^-7) >= the exact tile max of the f32 scores that B1/B2 compute from
   the same compact rows (over matching docs for B4/B5), with B1/B2's
   hit counts equal to the kernels'. B3 (tensor cores) again at its
   edges, held the same way against plain and exact: U8 = 896 (MAX_ROWS),
   Q in {1, 65, 820} (off its 32-query chunk), and banks built against a
   truncating accumulator (one large value per doc beside rows just under
   its ulp, indicator values above 1). B5 (tensor cores) at its edges too:
   U8 = 896, Q in {1, 65, 820}, and queries of 64 required and 64 should
   clauses (the largest counts its combined count product carries) with
   min_should up to 64 on a dense bank, hits and feasibility equal to plain
   and exact. B4 (tensor cores) at its edges: U8 in {32, 168, 512, 896} x Q
   in {1, 65, 820} on queries where one row serves two roles (SHOULD twice
   and MUST, MUST twice and MUST_NOT, SHOULD twice and MUST_NOT, MUST_NOT
   twice and SHOULD), U8 = 896 on random roles, and two such cases at
   D = 1,003,520, held like B5. B7 also with each query's tiles shuffled
   out of ascending order, bit-equal to plain and to B6. Then B8
   (bits_hits) exactly equal to
   its plain version at D in {19,456, 10,002,432} x (Q, U8, Tq) in
   {(1, 40, 20), (820, 40, 20), (200, 40, 4), (1024, 512, 4), (64, 168,
   40)}, every mode word, dead queries and queries without a required
   clause included; each shape's last span ragged or not as its plan
   falls (the plan is printed).
4. Serving at 19,043 docs (main path, counted): solo searches of the
   Reuters families, the five phrases included (a solo phrase runs the
   position intersection in torch ops, no kernel of B1-B8), and
   search_batch sizes 1-7 (B1/B2), or20 x 1024 (dedups to one plan,
   exhaustive on B1), bench.py's mixed 1024 with phrase_share 5 (pruned:
   B3 and B6 for the pure-OR subset, phrases included, B5 and B7 for the
   boolean one), a 1024-query MUST_NOT batch (pruned: B4, B7) and
   bench.py's phrase batch of 1024 over 32 texts (dedups to 32 plans,
   pruned: B3, B6), through dispatch_batch + collect_many. Sampled
   queries, every phrase text among them, are oracle-exact, and over each
   whole batch the pruned route's finalize equals the exhaustive route's
   bit for bit. Solo phrase latency, and the phrase batch's plans built
   cold under torch.profiler (host against device time).
5. Scale at 1,000,000 docs, served from disk (main path, counted): the
   built segment goes through the store tier (write_segment into a
   temporary FSDirectory with a segments_1 commit, DirectoryReader.open
   with verify_checksums; every postings array and the norms equal to the
   built segment's, dtypes included, the positions still undecoded, and
   equal to the built ones after their first decode), and the searcher
   serves the loaded segment; set-up seconds of the write, the open (mmap
   and header; and with the checksums), the first position decode and the
   device load. Then mixed 1024 (B3, B5, B6,
   B7), or20 x 1024 (dedups to Q = 1, forced onto the batch route:
   B3 + B6), a 1024-query MUST_NOT batch over the segment's frequent
   terms (B4, B7), then the positions' decode and upload (seconds,
   bytes), the five solo phrases and the phrase batch (B3, B6), pruned
   equal to exhaustive over each whole batch, samples oracle-exact,
   escalation counts printed. Then the small-batch tile-UB route, the
   default for fewer than 8 pure-OR plans here: six solo pure-OR queries
   (or20, ORs of 2-5 frequent terms, one with a rare term) and a batch of
   3, oracle-exact, [Q, 2k+2] rows outside batch mode, finalize equal to
   the exhaustive route's bit for bit, escalations (onto B1), and each solo
   query's search latency on both routes (median of 10, in turns), its
   dispatch's device time and device operations.
9. Sparse vectors at 1,000,000 docs (main path, counted):
   benchmarks/sparse_bench.py's corpus (vocab 30,000, Zipf 1.05, 30-120
   draws a doc, values U(0.05, 2.05), seed 5; built vectorised) and 256
   queries of 8-23 Zipf terms: corpus and index build seconds, the solo
   search (the tile-UB route, B1 on escalation; equal to the exhaustive
   route), search_batch (pruned: B5, B6; every clause a light row)
   and search_rerank_batch; search_oracle bit-equal on a sample of 8,
   search_rerank and search_rerank_batch equal to search_exact there,
   pruned equal to exhaustive over the whole batch, served qps and a
   torch.profiler pass over each route.
8. Scale at 10,000,000 docs, bench.py's 10M tier (main path, counted per
   route): a segment of 4M+ docs holds no resident bank (on-demand mode).
   or20 x 1024, then mixed 1024 over the 32 most frequent terms, with
   query_cache off, through dispatch_batch + collect_many on (a) the
   default route (phase 1 on B3/B5, then B6/B7) and (b) use_phase0 (phase
   0, B8, then B6/B7): the kernels each route must launch (B8 on (b)
   only), 3-4 queries oracle-exact, pruned finalize equal to the
   exhaustive finalize (B1/B2 on the batch's on-demand heavy rows) over
   each whole batch, escalations, served qps (median of 3 batches; one
   batch on the phase-0 route, where a batch takes seconds),
   first-batch time (entry builds included), segment build and device
   load seconds; a query_cache replay returns the same bits and skips
   phase 1; a torch.profiler pass over each route of the mixed batch.
6. On the very tensors the main path hands each kernel: B3-B5 checked
   as in phase 3 (hits, feasibility, soundness against B1/B2; B4 at the
   19k and 1M MUST_NOT batches, and on the 1M mixed batch's boolean
   subset with its counts split from the same plans, timed beside B5
   there; B3 and B5 at the 1M mixed batch and at the 10M phase-1 entries
   of its two subsets, whose banks must hold no subnormal value), B2 bit
   for bit also
   on the queries the 10M mixed batch escalates, B6/B7 bit for bit, B8
   exactly (the 10M phase-0 entry's own bitmaps), and kernel and plain
   times (CUDA events); each
   kernel's bound (the least time for its work on the card) and the time
   of one PyTorch call computing the same function where there is one.
   B1 and embedding_bag are timed three ways at Q 1, Tq 20 (the main
   path's args) and Q 1024, Tq 20: events around one call, events around
   100 back-to-back calls / 100, and kernel only: events around 100 calls
   queued behind a device sleep, so that no host time enters. So are B6 (at the 1M mixed batch's pure-OR subset, at
   the 10M phase-1 entry and at the deduped 1M or20 batch, Q 1, each
   checked bit for bit, with its bound and embedding_bag's time), B8 at
   the 10M phase-0 entry, B4, B7, and B6 on B7's tensors.
10. The columnar engine (X1, ``range_agg``, one launch a call) on
   benchmarks/columnar_bench.py's table (same columns, distributions and
   seed) at 1,000,000 and 10,000,000 rows (ClickBench's ~100M-row hits
   table cut for the time limit), with a group column whose ids go below
   zero, through DeviceTable on the card (main path, counted): the
   bench's six queries through range_agg with host_fast False (X1) and
   True, its range_group_agg (region, 4096 groups, agg duration) and one
   over the negative ids, counts exact against the numpy int64 scan (ids
   wrapped as the JAX program wraps them); X1 against its plain version on
   each (counts, min, max, granules and int sums bit for bit, f32 sums
   within relative 1e-5, group counts exact), through the table's cached
   launch plans and once through a bare range_agg call. The 1M table is
   served as read back from disk (write_table with the default chain,
   read_table with verify_checksums; every column and the minmax and bloom
   indexes equal to the built table's; every query's answer bit-equal to
   the built table's); the 10M table stays in memory. At 1M, X1 also
   against its plain version on a float column with NaN rows (aggregate,
   filter and group sums; NaN compared as NaN) and at granule sizes 1,001
   and 10, not multiples of 4. At 1M, one device
   kernel and no memset a call (torch.profiler); 32 chained
   dispatch_range_agg calls with no host sync (torch's sync debug mode
   "error", all enqueued behind a device sleep); per query the branch
   (pruned or full), the grid, chained, kernel-only, one-call and plain
   times, the bound and the host BULK path's time.
7. Routes on the same plans: served qps of the mixed cells, the phrase
   batches, 1M or20 and 1M MUST_NOT through the pruned and the exhaustive
   route (pruned,
   exhaustive, exhaustive, pruned; the exhaustive route is the same
   dispatch with the pruning floor raised past the segment), then a
   torch.profiler pass over each route: device time by kernel and the
   card's busy share. A profiled window that launched no B4 must hold no
   row of B4's kernel (approx_bool_mma_kernel): B5 serves those batches.

11. The write path at 19,043 docs (main path, counted): corpus_documents'
   Reuters-shaped documents (title and body text with positions, the date
   keyword) indexed two ways: (a) one add_documents into a 512 MB buffer
   and a commit; (b) add_document per document with max_buffered_docs
   4,761 (four flushes) and the serial scheduler, a commit, force_merge(1)
   and commit_merge_results. (a)'s segment must equal (b)'s merged one
   (norms, terms, every postings array, positions, stored rows). Then (b)
   reopened in APPEND mode takes the first 500 documents again, commits
   and merges over the segment read from disk (lazy positions): 19,543
   docs, equal to one add_documents flush of the same documents. The index
   is opened with DirectoryReader and served on the card (solo searches
   and search_batch sizes 1-7: B1, B2; or20 x 1024, mixed 1024 with
   phrase_share 5, phrase 1024, the MUST_NOT batch: B3-B7), sampled
   queries oracle-exact and pruned == exhaustive over each pruned batch;
   then delete_documents on a date term, a commit and a reopen: every
   served query's hits drop by exactly the deleted docs that match it (the
   oracle's count over a segment of just those docs), served oracle-exact
   again. Host seconds (docs/s), each flush, commit and force_merge, and
   the file MiB.

12. The embedding API (``diagon_tpu_torch.api``) and tier-managed
   residency (main path, counted): (a) corpus_documents(19,043) with a
   views field (indexed long and long point, numpy default_rng(13))
   written through the C-API form (writer config setters,
   max_buffered_docs 4,761: four segments), open_index_reader and
   create_index_searcher on the card; 64 term / boolean / phrase /
   MUST_NOT queries drawn as phase 11 draws its batches, two ranges on
   views, a range filter and match-all through search_top_docs and count
   equal to the oracle (docids, score bits, hits); TermsEnum /
   PostingsEnum over the first 200 body terms equal to the oracle's
   postings; the doc-values bulk read and scan, compute_histogram and
   search_with_date_histogram equal to numpy; pcall on a missing index;
   the port's validator (diagon_tpu_torch.validate_bundle --deep) prints
   RESULT: OK (its own process, beside the rest of the phase). (b) the same four segments under
   hbm_budget_bytes of 2.5 x the first segment's estimate: 2 DEVICE and
   2 HOST, every query through search and count bit-equal to (a)'s
   resident searcher, search_batch equal to search, dispatch_batch raising
   MemoryError, the host ms of one tier-managed search; under 10 x all
   four resident, a batch dispatched and collected bit-equal, and per
   segment the estimate against the memory_allocated delta of a promote,
   each demote returning exactly that memory. (c) phase 5's 1M index
   reopened through open_reader / open_searcher: its six solo pure-OR
   queries and three booleans through dg.search / dg.count bit-equal to
   phase 5's searcher; QueryProfiler's plan / execute / merge counts; a
   QueryProfiler.trace of one or20 search on (a)'s index names B1's
   kernel; device_health_check is healthy and names the card. B1 and B2
   must launch.

13. Segment-sharded search (``diagon_tpu_torch.parallel``, main path,
   counted in every rank): (a) four 250,000-doc shards
   (``build_synthetic_segment``, seeds 20260816-20260819: phase 5's
   1,000,000 docs), built and written through the store tier in four
   threads, served by four spawned ranks over gloo on the one card, each
   rank opening every shard (mmap) and holding its own on the card: the
   first 7 reuters queries (the exhaustive program, B2), 64 ORs of 2-5
   frequent terms and or20 (B3, B6), bench.py's mixed family at 256 (B5,
   B6), 64 MUST_NOT booleans (B4, B7), the mixed batch again with one tile
   a query (escalations onto B2) and 16 booleans around the five reference
   phrases (phrase rows from each rank's PhraseExecutor). Every rank's
   TopDocs and route equal; bit-equal to IndexSearcher over the four
   segments for whole batches; 8 samples a batch equal to the oracle
   (checked in the ranks, dealt between them); per rank its heavy bank and
   memory, per batch rank 0's host ms split into plan, device and gather +
   merge. (b) Shard 0 on an NCCL group of one rank (collectives on CUDA
   tensors), bit-equal to IndexSearcher([shard 0]). (c)
   ``entry.dryrun_multichip(4)`` over gloo on the card. B2-B7 must launch.

14. The block-at-a-time engine (X2, ``block_score``, main path, counted)
   on the DeviceSegments phases 4, 5 (from disk) and 8 hold, nothing new
   uploaded, each right after its phase: (a) a SegmentExecutor over the
   segment serves top_k and count of the Reuters term / OR / AND
   families, a mixed boolean, min_should 2, a term given twice,
   FILTER-only, a MUST_NOT boolean and a missing term (at 10M: or20, the
   mixed boolean, the term twice, FILTER-only and term:oil), and one
   top_k_batch of them all; X2 must launch. (b) Every answer equal to
   IndexSearcher's (the row engine) for the same query, the batch to the
   solo calls and to the batch split by the wrapper into chunks of 3
   queries; 7 samples oracle-exact (2 at 10M). (c) X2 bit-equal to its
   plain version on the card at the kernel's tile size, both forms: the
   candidate form at k 10 and at k 2,048 (every doc of every tile, sorted),
   the hits of both, on every plan (padding blocks, the term twice,
   FILTER-only) and on their batch, at D 19,456, 1,003,520 and
   10,002,432; the plain decode of up to 8,193 of each plan's blocks on
   the card equal to the host's. (d) X2's time a call (CUDA events,
   wrapper), kernel only (queued_ms), the top-k call, the plain version,
   the count form's call and kernel, beside the bounds of the row form
   (a [Q, D] final row, X2's first form), the candidate form and the
   count form, at or20 and the mixed
   boolean (19k, 1M) and or20 (10M).

15. Kernel B9 (bank_decode: posting blocks into bank rows, the row
   engine's every bank build) against its plain version, bit for bit, on
   the cases of ``tests/test_torch_bank_decode.py`` (postings packed by
   hand: no freq section, 32-bit and straddling fields, tail blocks,
   freqs past the LUT, a block ending on the stream's last word, terms
   without blocks, one term twice, no specs) and on its random bank of 163
   rows over 1,105,920 docs; each ``build_rows`` one launch. B9's time
   (wrapper, kernel only), ``build_rows``'s, the plain version's and the
   bound by bytes at the random bank.

Phases run in the order 1, 2, 3, 3b, 15, 10, 4, 14 (19k), 11, 5, 14 (1M),
12, 9, 8 with 14 (10M) at its end, 6, 7, 13.
Launch counters are set to 0 just before each main-path phase (10 at each
table size, 4, 11, 5, 12, 9, each route of 8, each run of 14, and each
rank of 13, which starts with its counters at 0) and read just after it;
comparisons with plain versions and with the exhaustive route, and phases
6-7, do not count. Each kernel
must launch on a path where it has to run.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout,
the script fails before printing either.
"""

import sys

# Neither the port nor this script may use JAX or the JAX package: an
# import of either fails here.
sys.modules["jax"] = None
sys.modules["diagon_tpu"] = None

import atexit  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
SERVE_DOCS = 19043  # the reference's Reuters corpus size
SCALE_DOCS = 1_000_000
KERNEL_D = 19456  # SERVE_DOCS padded to the 1024-doc granule
SCALE_D = 1003520  # SCALE_DOCS padded to the 4096-doc granule
SCALE10_DOCS = 10_000_000  # bench.py's 10M tier (benchmarks/scale_bench.py)
SCALE10_D = 10002432  # SCALE10_DOCS padded to the 4096-doc granule
# benchmarks/sparse_bench.py's corpus shape, at 1M docs
SPARSE_DOCS = 1_000_000
SPARSE_VOCAB = 30000
# what the sparse batch must launch: every plan is padded to one clause
# bucket with zero-weight clauses, so none is pure OR (B5), and its
# partition groups hold fewer than 64 queries (B6); each group's light
# bank is one B9 launch
SPARSE_NEED = ["approx_select_bool2", "gather_rescore", "bank_decode"]
# columnar_bench.py's table at its default size, and ClickBench's ~100M-row
# hits table cut to 10M for the time limit
COLUMNAR_ROWS = (1_000_000, 10_000_000)
# X1's int operations a scanned row costs (valid test, the 48-bit value
# rebuilt and compared twice, the aggregate's adds, min and max): an
# estimate for its bound, far below its bytes
X1_OPS_PER_ROW = 16
# a group column with ids below zero beside columnar_bench's table (seed
# 12): over 4096 groups, -1 lands in the JAX scatter's cut-off slot,
# -2..-4097 wrap to 4095..0 and -4200..-4098 are dropped
# X1's compaction window (granules) and shared group table (groups):
# csrc/range_agg.cu's kWin and kSmemGroups
X1_WINDOW, X1_SMEM_GROUPS = 2048, 4096
GNEG_QUERY = dict(filter_col="event_ts", group_col="gneg", num_groups=4096,
                  lower=0, upper=1 << 21, agg_col="duration")
K = 10
B_TILES = 24  # PRUNE_B0: the main path's tile budget at these sizes
REL_TOL = 2.0 ** -8  # kernel vs plain tile maxima (two f32 add orders)
# B3 rounds each tile max once to bf16 from sums the tensor cores take in
# another order and precision than the plain matmul: the two roundings may
# land on neighbouring bf16 values, one step (at most 2^-7 relative) apart.
# What B3 guarantees is checked against the exact scores (soundness, hits).
BF16_STEP = 2.0 ** -7
DEVICE = torch.device("cuda")
# the kernels of diagon_tpu_torch/csrc, by function name (profile rows)
PORT_KERNELS = ("row_sum_kernel", "row_boolean_kernel", "approx_or_mma_kernel",
                "approx_bool_mma_kernel", "approx_bool2_mma_kernel",
                "pack_indicator_kernel", "gather_rescore_kernel",
                "union_rescore_kernel", "bits_hits_kernel",
                "range_agg_kernel", "block_score_kernel",
                "bank_decode_kernel")
# B4's kernel: a batch without MUST_NOT must not launch it (B5 takes those)
B4_KERNELS = ("approx_bool_mma_kernel",)
# the kernels of B1-B9, X1 and X2: ptxas must report no spill
NO_SPILL = PORT_KERNELS
# the card's published peaks (H100 SXM datasheet, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16 = 989e12  # bf16 tensor-core products
# CUDA-core operations an SM issues a clock on compute capability 9.0 (the
# CUDA C++ Programming Guide's table of arithmetic instruction throughput):
# f32 add, multiply or compare on 128 lanes (the datasheet's 67 TFLOP/s
# counts an FMA as two on those lanes), 32-bit logic on 64, popcount on 16.
LANES = {"f32": 128, "logic": 64, "popc": 16}
RATES = {}  # operations per second by type: LANES x SMs x top SM clock


def log(*a):
    print(*a, flush=True)


def spills(log_text):
    """{mangled kernel name: (spill store bytes, spill load bytes)} from
    ``ptxas -v`` output."""
    out, fn = {}, None
    for line in log_text.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for", 1)[1].strip()
        elif fn and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            out[fn] = (nums[1], nums[2])
            fn = None
    return out


def cuda_ms(fn, reps=20, warmup=3):
    """Median device time of ``fn`` in ms from CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bits_equal(a, b):
    """Equal shapes and equal f32 bit patterns (tuples compare pairwise)."""
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(bits_equal(x, y) for x, y in zip(a, b))
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
    )


def max_abs_err(a, b):
    if isinstance(a, (tuple, list)):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    return float((a - b).abs().max())


def same_topdocs(a, b):
    if a.total_hits != b.total_hits:
        return False
    if [sd.doc for sd in a.score_docs] != [sd.doc for sd in b.score_docs]:
        return False
    sa = np.asarray([sd.score for sd in a.score_docs], np.float32)
    sb = np.asarray([sd.score for sd in b.score_docs], np.float32)
    return np.array_equal(sa.view(np.uint32), sb.view(np.uint32))


class Oracle:
    """The host oracle with its answers memoised per query object, and per
    text for phrases (equal texts have one answer; the oracle takes seconds
    per phrase at 1M docs)."""

    def __init__(self, seg):
        from diagon_tpu_torch.search.oracle import OracleSearcher

        self.searcher = OracleSearcher([seg])
        self.memo = {}

    def check(self, query, got, what):
        from diagon_tpu_torch.search.query import PhraseQuery

        key = repr(query) if isinstance(query, PhraseQuery) else id(query)
        want = self.memo.get(key)
        if want is None:
            want = self.memo[key] = (query, self.searcher.search(query, K))
        if not same_topdocs(got, want[1]):
            raise AssertionError(
                f"{what}: port differs from the oracle for {query!r}:\n"
                f"  port   {got}\n  oracle {want[1]}"
            )


class Counts:
    """Launches of the path's kernels (the registry's
    ``ops.<kernel>.launches`` for each name of ``kernels``) since the
    process started or the last ``reset``; ``uncounted`` runs a
    comparison or a timing without adding to them."""

    def __init__(self, kernels):
        self.kernels = kernels
        self.base = {name: 0 for name in kernels}

    def _total(self):
        from diagon_tpu_torch.ops import launches

        return {name: launches(name) for name in self.kernels}

    def reset(self):
        self.base = self._total()

    def read(self):
        return {n: v - self.base[n] for n, v in self._total().items()}

    def uncounted(self, fn, *args):
        saved = self._total()
        try:
            return fn(*args)
        finally:
            for name, n in self._total().items():
                self.base[name] += n - saved[name]

    def require(self, before, names, what):
        """Each of ``names`` launched since the snapshot ``before``."""
        now = self.read()
        idle = [n for n in names if now[n] <= before[n]]
        if idle:
            raise AssertionError(f"{what} never launched {idle}")


def kernel_inputs(rng, Q, Tq, D=KERNEL_D, H=160, L=33):
    """Seeded bank and clause inputs: ~30% nonzero rows, a quarter of the
    clauses on light rows (row 0 the zero row), random flags."""
    heavy = rng.random((H, D), dtype=np.float32)
    heavy *= rng.random((H, D)) < 0.3
    light = rng.random((L, D), dtype=np.float32)
    light *= rng.random((L, D)) < 0.3
    light[0] = 0.0
    hidx = rng.integers(0, H, (Q, Tq), dtype=np.int32)
    on_light = rng.random((Q, Tq)) < 0.25
    hidx[on_light] = -1
    lidx = np.where(on_light, rng.integers(0, L, (Q, Tq)), 0).astype(np.int32)
    flags = rng.integers(0, 16, (Q, Tq), dtype=np.int32)
    return tuple(torch.from_numpy(a).to(DEVICE)
                 for a in (heavy, light, hidx, lidx, flags))


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    from diagon_tpu_torch.ops import _build
    from diagon_tpu_torch.observability.metrics import registry

    # the plain versions' products are full f32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name}")
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.split()[0])
    RATES.update({k: n * sms * mhz * 1e6 for k, n in LANES.items()})
    log(f"  {sms} SMs (torch device properties), top SM clock {mhz:.0f} MHz "
        f"(nvidia-smi clocks.max.sm): " + ", ".join(
            f"{k} {r / 1e12:.2f} T/s" for k, r in RATES.items()))
    t0 = time.perf_counter()
    _build.library()
    # 0.0 where every library was found built
    nvcc_s = registry.snapshot()["ops.nvcc_seconds"]
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {nvcc_s} s) -> {_build.BUILD_DIR}")
    text = _build.build_log()
    for line in text.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")
    found = spills(text)
    checked = {f: n for f, n in found.items() if any(k in f for k in NO_SPILL)}
    if len(checked) < len(NO_SPILL) and nvcc_s:
        raise AssertionError(f"ptxas reported on {sorted(checked)} only, not "
                             f"on every kernel of {NO_SPILL}")
    spilled = {f: n for f, n in checked.items() if n != (0, 0)}
    if spilled:
        raise AssertionError(f"ptxas spills in B1-B9, X1 or X2 kernels: {spilled}")
    log(f"  ptxas: no spill in {len(checked)} B1-B9, X1 and X2 kernel(s)")
    x1_sass_atomics(_build)
    return smi


def x1_sass_atomics(build):
    """Read X1's atomics in the built SASS (``cuobjdump -sass``) and log
    them by kernel; fail unless each of the four group-table kernels
    (template mode 1) adds its shared f64 sums with the compare-and-swap
    loop ATOMS.CAST.SPIN.64, as csrc/range_agg.cu's table_add and PERF.md
    say (the reason a table block prefetches its next quads)."""
    tool = Path(build._nvcc()).with_name("cuobjdump")
    lib = next(p for p in build.library_paths() if "range_agg" in p.name)
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    fn, ops = None, {}
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            fn = fn[fn.find("range_agg_kernel"):] if "range_agg_kernel" in fn else None
        elif fn and "*/" in line:
            op = line.split("*/", 1)[1].split()[0:2]
            op = op[1] if op and op[0].startswith("@") and len(op) > 1 else op[0] if op else ""
            if op.startswith(("ATOM", "RED")):
                ops.setdefault(fn, {}).setdefault(op, 0)
                ops[fn][op] += 1
    for fn, found in sorted(ops.items()):
        log(f"  X1 SASS {fn}: " + ", ".join(
            f"{op} x{n}" for op, n in sorted(found.items())))
    table = {fn: found for fn, found in ops.items() if "ELi1EE" in fn}
    if len(table) != 4 or not all("ATOMS.CAST.SPIN.64" in f
                                  for f in table.values()):
        raise AssertionError(f"X1's group-table kernels {sorted(table)}: the "
                             "shared f64 add is no longer the CAS loop "
                             "ATOMS.CAST.SPIN.64 that range_agg.cu and "
                             "PERF.md describe")
    log("  X1 SASS: the shared f64 group add of all four table kernels is "
        "the CAS loop ATOMS.CAST.SPIN.64")


def phase_row_kernels(rs):
    """B1/B2 against their plain versions over the main path's shapes."""
    rng = np.random.default_rng(20261016)
    err = {"row_sum": 0.0, "row_boolean": 0.0}
    log("phase 2: B1/B2 vs plain versions on the card")

    def check(Q, Tq, **kw):
        heavy, light, hidx, lidx, flags = kernel_inputs(rng, Q, Tq, **kw)
        got = rs.row_sum(heavy, light, hidx, lidx)
        want = rs.row_sum_reference(heavy, light, hidx, lidx)
        gotb = rs.row_boolean(heavy, light, hidx, lidx, flags)
        wantb = rs.row_boolean_reference(heavy, light, hidx, lidx, flags)
        torch.cuda.synchronize()
        if not bits_equal(got, want) or not bits_equal(gotb, wantb):
            raise AssertionError(f"kernel != plain at Q={Q} Tq={Tq} {kw}")
        err["row_sum"] = max(err["row_sum"], max_abs_err(got, want))
        err["row_boolean"] = max(err["row_boolean"], max_abs_err(gotb, wantb))
        return cuda_ms(lambda: rs.row_boolean(heavy, light, hidx, lidx, flags),
                       reps=10)

    for Q in (1, 3, 7, 19, 1024):
        for Tq in (4, 20, 24, 64, 100):
            check(Q, Tq)
        log(f"  D={KERNEL_D} Q={Q:5d} Tq in (4, 20, 24, 64, 100): bit-exact")
    for Q in (1, 3, 19):
        ms = check(Q, 20, D=SCALE_D, H=24, L=5)
        log(f"  D={SCALE_D} Q={Q:5d} Tq=20: bit-exact; B2 {ms:.4f} ms")
    return err


# ---------------------------------------------------------------------------
# Phase 3: B3-B7 against their plain versions, and the bound's soundness
# ---------------------------------------------------------------------------

MUST, FILTER, SHOULD, MUST_NOT = range(4)


def compact_inputs(rng, gen, Q, U8, Tq, D, family):
    """A seeded compact batch as the row engine builds one: bank f32
    [U8, D] (row 0 zero, ~10% nonzero BM25-like values) and its bf16
    copy, Tq distinct clause rows per query (a few padding clauses on the
    zero row), clause roles per ``family`` ("or", "bool2" no MUST_NOT,
    "bool" with MUST_NOT; query 0 FILTER-only), flags and the indicator
    matrices of ``RowExecutor._build_compact``."""
    bank = torch.rand((U8, D), generator=gen, device=DEVICE) * 12.0
    bank *= torch.rand((U8, D), generator=gen, device=DEVICE) < 0.1
    bank[0] = 0.0
    live = (torch.rand(D, generator=gen, device=DEVICE) < 0.97).float()
    live[SCALE_DOCS if D == SCALE_D else SERVE_DOCS:] = 0.0  # the doc pad
    cidx = np.stack([rng.choice(np.arange(1, U8), Tq, replace=False)
                     for _ in range(Q)]).astype(np.int32)
    cidx[:, -1][rng.random(Q) < 0.2] = 0
    if family == "or":
        roles = np.full((Q, Tq), SHOULD)
    else:
        roles = rng.integers(0, 4 if family == "bool" else 3, (Q, Tq))
        roles[0] = FILTER
    return compact_batch(bank, live, cidx, roles)


def compact_batch(bank, live, cidx, roles, min_should=None):
    """The tensors of a compact batch from its bank, clause rows and roles:
    flags, params (min_should: 1 for a query without a required clause,
    else 0, unless given) and the indicator matrices of
    ``RowExecutor._build_compact``."""
    U8, Q = bank.shape[0], cidx.shape[0]
    a = {r: np.zeros((U8, Q), np.float32) for r in ("sc", "rq", "sh", "ng")}
    qgrid = np.broadcast_to(np.arange(Q)[:, None], cidx.shape)
    sc = (roles == MUST) | (roles == SHOULD)
    rq = (roles == MUST) | (roles == FILTER)
    for r, m in (("sc", sc), ("rq", rq), ("sh", roles == SHOULD),
                 ("ng", roles == MUST_NOT)):
        m = m & (cidx > 0)
        np.add.at(a[r], (cidx[m], qgrid[m]), 1.0)
    params = np.zeros((8, Q), np.float32)
    params[0] = rq.sum(axis=1)
    params[1] = (np.where(params[0] > 0, 0.0, 1.0) if min_should is None
                 else min_should)
    flags = (sc.astype(np.int32) + 2 * rq + 4 * (roles == SHOULD)
             + 8 * (roles == MUST_NOT)).astype(np.int32)
    dev = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(DEVICE)  # noqa: E731
    bf = lambda x: dev(x).to(torch.bfloat16)  # noqa: E731
    return {
        "bank": bank, "bank_bf16": bank.to(torch.bfloat16), "live": live,
        "cidx": dev(cidx), "flags": dev(flags), "params": dev(params),
        "a_sc": bf(a["sc"]), "a_rq": bf(a["rq"]), "a_sh": bf(a["sh"]),
        "a_ng": bf(a["ng"]), "a_cb": bf(a["rq"] * 256.0 + a["sh"]),
        "bool_params": dev(params[:2].T.copy()),
    }


def adversarial_inputs(rng, gen, Q, U8, Tq, D):
    """A pure-OR compact batch against the tensor cores' accumulator, as in
    tests/test_torch_approx_bound.py: per doc one large value (row 1,
    9-12) beside rows just under its f32 ulp (which truncate to nothing
    once aligned with it), and rows of one equal value on a third of the
    docs; each query draws Tq clause rows with replacement, so indicator
    values above 1 occur, and half the queries hold row 1."""
    big = 9.0 + 3.0 * torch.rand(D, generator=gen, device=DEVICE)
    ulp = torch.ldexp(torch.ones_like(big), torch.frexp(big).exponent - 24)
    bank = torch.empty((U8, D), device=DEVICE)
    bank[0] = 0.0
    bank[1] = big
    half = U8 // 2
    bank[2:half] = ulp * (1.0 - 2.0 ** -8)
    bank[half:] = 3.0 * (torch.rand((U8 - half, D), generator=gen,
                                    device=DEVICE) < 0.33)
    live = (torch.rand(D, generator=gen, device=DEVICE) < 0.97).float()
    cidx = rng.integers(1, U8, (Q, Tq)).astype(np.int32)
    cidx[::2, 0] = 1
    a = np.zeros((U8, Q), np.float32)
    np.add.at(a, (cidx, np.broadcast_to(np.arange(Q)[:, None], cidx.shape)),
              1.0)
    dev = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(DEVICE)  # noqa: E731
    return {"bank": bank, "bank_bf16": bank.to(torch.bfloat16), "live": live,
            "cidx": dev(cidx), "a_sc": dev(a).to(torch.bfloat16)}


def adversarial_bool2_inputs(rng, gen, Q, U8, D):
    """A no-MUST_NOT compact batch at the largest counts B5's combined
    product carries: every query holds 64 required clauses (MUST and FILTER
    in turn) and 64 should clauses on 128 distinct rows, so cc reaches 64 *
    256 + 64, with min_should 0, 1, 60 or 64 by query; the bank is dense
    (2% zeros), so docs that hold all 64 required rows exist."""
    bank = 0.05 + 12.0 * torch.rand((U8, D), generator=gen, device=DEVICE)
    bank *= torch.rand((U8, D), generator=gen, device=DEVICE) < 0.98
    bank[0] = 0.0
    live = (torch.rand(D, generator=gen, device=DEVICE) < 0.97).float()
    cidx = np.stack([rng.choice(np.arange(1, U8), 128, replace=False)
                     for _ in range(Q)]).astype(np.int32)
    roles = np.empty((Q, 128), np.int64)
    roles[:, 0:64:2], roles[:, 1:64:2], roles[:, 64:] = MUST, FILTER, SHOULD
    min_should = np.array([0.0, 1.0, 60.0, 64.0], np.float32)[np.arange(Q) % 4]
    return compact_batch(bank, live, cidx, roles, min_should)


def two_role_inputs(rng, gen, Q, U8, Tq, D):
    """A compact batch that only B4 takes: in every query one row serves two
    roles with a count of 2 in one of them, by query in turn: SHOULD twice
    and MUST (required and should, which a_cb cannot hold); MUST twice and
    MUST_NOT (which no doc matches); SHOULD twice and MUST_NOT; MUST_NOT
    twice and SHOULD. The other
    Tq - 3 clauses take distinct rows: one FILTER, then SHOULD or (30%)
    MUST_NOT; min_should 0 or 1 by query. The bank is half dense, so many
    docs match."""
    bank = 0.05 + 12.0 * torch.rand((U8, D), generator=gen, device=DEVICE)
    bank *= torch.rand((U8, D), generator=gen, device=DEVICE) < 0.5
    bank[0] = 0.0
    live = (torch.rand(D, generator=gen, device=DEVICE) < 0.97).float()
    live[SCALE_DOCS if D == SCALE_D else SERVE_DOCS:] = 0.0  # the doc pad
    rows = np.stack([rng.choice(np.arange(1, U8), Tq - 2, replace=False)
                     for _ in range(Q)]).astype(np.int32)
    cidx = np.concatenate([rows[:, :1], rows[:, :1], rows], axis=1)
    roles = np.where(rng.random((Q, Tq)) < 0.3, MUST_NOT, SHOULD)
    roles[:, 3] = FILTER
    roles[:, :3] = np.array([[SHOULD, SHOULD, MUST],
                             [MUST, MUST, MUST_NOT],
                             [SHOULD, SHOULD, MUST_NOT],
                             [MUST_NOT, MUST_NOT, SHOULD]])[np.arange(Q) % 4]
    min_should = ((np.arange(Q) // 4) % 2).astype(np.float32)
    return compact_batch(bank, live, cidx, roles, min_should)


def no_subnormals(what, *banks):
    """The phase-1 banks hold no subnormal value (0 < |x| < 2^-126): the
    exactness of B3's hits on the tensor cores assumes it."""
    tiny = float(np.finfo(np.float32).tiny)
    for bank in banks:
        for rows in bank.split(8):
            if bool(((rows != 0) & (rows.float().abs() < tiny)).any()):
                raise AssertionError(f"{what}: the bank holds subnormal values")
    log(f"    {what}: no subnormal value in the bank")


def exact_tiles(rs, counts, b, boolean):
    """Exact per-(query, tile) maxima of the f32 clause sums (B1/B2 on the
    compact f32 rows, clause order), over matching docs for booleans
    (-inf where none matches), and the exact hit counts; in query chunks
    that keep B2's four planes under 8 GiB."""
    U8, D = b["bank"].shape
    q_chunk = min(128, max(1, (1 << 29) // D)) if boolean else 128
    zero = torch.zeros((1, D), device=DEVICE)
    Q = b["cidx"].shape[0]
    tmaxs, hits = [], []
    for q0 in range(0, Q, q_chunk):
        cidx = b["cidx"][q0 : q0 + q_chunk].contiguous()
        lidx = torch.zeros_like(cidx)
        live = b["live"] > 0
        if boolean:
            s, r, o, n = counts.uncounted(
                rs.row_boolean, b["bank"], zero, cidx, lidx,
                b["flags"][q0 : q0 + q_chunk].contiguous())
            p = b["params"][:, q0 : q0 + q_chunk]
            m = ((r == p[0][:, None]) & (o >= p[1][:, None]) & (n == 0)
                 & ((r + o) > 0) & live)
            s = torch.where(m, s, -float("inf"))
        else:
            s = counts.uncounted(rs.row_sum, b["bank"], zero, cidx, lidx)
            m = (s > 0) & live
        tmaxs.append(s.reshape(s.shape[0], -1, 128).amax(dim=-1))
        hits.append(m.sum(dim=1))
    return torch.cat(tmaxs), torch.cat(hits)


def check_select(name, got, want, exact, boolean, rel_tol=REL_TOL):
    """Kernel vs plain (hits, feasibility, maxima within rel_tol), and
    both against the exact scores (hits; tmax * (1 + eps) dominates)."""
    from diagon_tpu_torch.search.row_engine import _APPROX_RELEPS

    (tg, hg), (tw, hw), (te, he) = got, want, exact
    if not torch.equal(hg, hw) or not torch.equal(hg.long(), he):
        raise AssertionError(f"{name}: hits differ (kernel/plain/exact)")
    scale = torch.maximum(tg.abs(), tw.abs())
    if not bool(((tg - tw).abs() <= rel_tol * scale).all()):
        raise AssertionError(f"{name}: tile maxima beyond {rel_tol} relative")
    if rel_tol == BF16_STEP:
        log(f"    {name}: {int((tg != tw).sum())} of {tg.numel()} tile maxima "
            f"one bf16 step from the plain version's")
    up = tg * float(np.float32(1.0) + _APPROX_RELEPS)
    if boolean:
        feas = te > -float("inf")
        if not torch.equal(tg != -1.0, feas) or not torch.equal(tw != -1.0, feas):
            raise AssertionError(f"{name}: tile feasibility differs")
        sound = bool((up[feas] >= te[feas]).all())
    else:
        sound = bool((up >= te).all())
    if not sound:
        raise AssertionError(f"{name}: tmax * (1 + eps) below an exact tile max")
    return float((tg - tw).abs().max())


def phase_pruned_kernels(rs, ap, gr, counts):
    from diagon_tpu_torch.search.row_engine import _APPROX_RELEPS, _select_tiles

    log("phase 3: B3-B7 vs plain versions and the bound's soundness")
    rng = np.random.default_rng(7)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(7)
    err = {n: 0.0 for n in ("approx_select", "approx_select_bool",
                            "approx_select_bool2", "gather_rescore",
                            "union_rescore")}
    for D in (KERNEL_D, SCALE_D):
        for Q, U8, Tq in ((1, 32, 4), (8, 168, 20), (820, 168, 20),
                          (1024, 512, 4)):
            line = []
            for name, family, tag in (("approx_select", "or", "B3"),
                                      ("approx_select_bool", "bool", "B4"),
                                      ("approx_select_bool2", "bool2", "B5")):
                b = compact_inputs(rng, gen, Q, U8, Tq, D, family)
                lv, bank, p = b["live"], b["bank_bf16"], b["params"]
                args = {
                    "approx_select": (b["a_sc"], bank, lv),
                    "approx_select_bool": (b["a_sc"], b["a_rq"], b["a_sh"],
                                           b["a_ng"], bank, p, lv),
                    "approx_select_bool2": (b["a_sc"], b["a_cb"], bank, p, lv),
                }[name]
                fn, ref = getattr(ap, name), getattr(ap, name + "_reference")
                got = counts.uncounted(fn, *args)
                want = ref(*args)
                torch.cuda.synchronize()
                boolean = family != "or"
                e = check_select(f"{name} D={D} Q={Q} U8={U8} Tq={Tq}", got,
                                 want, exact_tiles(rs, counts, b, boolean),
                                 boolean, REL_TOL if boolean else BF16_STEP)
                err[name] = max(err[name], e)
                ms = cuda_ms(lambda: counts.uncounted(fn, *args), reps=10)
                pms = cuda_ms(lambda: ref(*args), reps=3, warmup=1)
                line.append(f"{tag} {ms:.4f}/{pms:.4f}")
                # B6 and B7 on the tiles this select chose, both forms
                G = D // 128
                tsel = _select_tiles(
                    got[0] * float(np.float32(1.0) + _APPROX_RELEPS),
                    min(B_TILES, G), G)[0]
                ct = b["bank"].reshape(U8, G, 128).permute(1, 0, 2).contiguous()
                fl = b["flags"] if boolean else None
                gargs = (ct, b["cidx"], tsel, fl)
                # the same pairs with each query's tiles out of ascending
                # order: B7 takes no order from tsel
                perm = torch.argsort(torch.rand(
                    tsel.shape, generator=gen, device=DEVICE), dim=1)
                sargs = (ct, b["cidx"],
                         torch.gather(tsel, 1, perm).contiguous(), fl)
                for rname, rtag in (("gather_rescore", "B6"),
                                    ("union_rescore", "B7")):
                    rfn = getattr(gr, rname)
                    rref = getattr(gr, rname + "_reference")
                    g = counts.uncounted(rfn, *gargs)
                    w = rref(*gargs)
                    torch.cuda.synchronize()
                    if not bits_equal(g, w):
                        raise AssertionError(f"{rname} != plain at D={D} "
                                             f"Q={Q} U8={U8} Tq={Tq} {family}")
                    if rname == "gather_rescore":
                        g6 = g
                    elif not bits_equal(g, g6):
                        raise AssertionError(f"union_rescore != gather_rescore "
                                             f"at D={D} Q={Q} U8={U8} Tq={Tq}")
                    err[rname] = max(err[rname], max_abs_err(g, w))
                    gs = counts.uncounted(rfn, *sargs)
                    if not bits_equal(gs, rref(*sargs)):
                        raise AssertionError(f"{rname} != plain with tsel "
                                             f"rows shuffled at D={D} Q={Q}")
                    if rname == "gather_rescore":
                        g6s = gs
                    elif not bits_equal(gs, g6s):
                        raise AssertionError(f"union_rescore != gather_rescore"
                                             f" with tsel rows shuffled at "
                                             f"D={D} Q={Q} U8={U8} Tq={Tq}")
                    if family != "bool2":
                        ms = cuda_ms(lambda: counts.uncounted(rfn, *gargs),
                                     reps=10)
                        pms = cuda_ms(lambda: rref(*gargs), reps=3, warmup=1)
                        line.append(f"{rtag}/{family} {ms:.4f}/{pms:.4f}")
                del b, args, got, want, ct, g, w, g6, gs, g6s, sargs
            log(f"  D={D} Q={Q} U8={U8} Tq={Tq}: sound, kernels == plain, "
                f"B7 == B6 also with tsel rows shuffled; "
                f"ms kernel/plain: {'; '.join(line)}")
    # B3 at its edges: U8 = MAX_ROWS, Q off the 32-query chunk, and a bank
    # made against the tensor cores' truncating accumulator
    for D, Q, U8, Tq, kind in ((KERNEL_D, 1, ap.MAX_ROWS, 20, "random"),
                               (KERNEL_D, 65, ap.MAX_ROWS, 64, "random"),
                               (KERNEL_D, 820, ap.MAX_ROWS, 20, "random"),
                               (SCALE_D, 65, ap.MAX_ROWS, 20, "random"),
                               (KERNEL_D, 65, ap.MAX_ROWS, 600, "adversarial"),
                               (KERNEL_D, 820, 168, 64, "adversarial"),
                               (SCALE_D, 1, 168, 64, "adversarial")):
        b = (compact_inputs(rng, gen, Q, U8, Tq, D, "or") if kind == "random"
             else adversarial_inputs(rng, gen, Q, U8, Tq, D))
        args = (b["a_sc"], b["bank_bf16"], b["live"])
        got = counts.uncounted(ap.approx_select, *args)
        want = ap.approx_select_reference(*args)
        torch.cuda.synchronize()
        e = check_select(f"approx_select {kind} D={D} Q={Q} U8={U8} Tq={Tq}",
                         got, want, exact_tiles(rs, counts, b, False), False,
                         BF16_STEP)
        err["approx_select"] = max(err["approx_select"], e)
        ms = counts.uncounted(cuda_ms, lambda: ap.approx_select(*args), 10)
        log(f"  B3 {kind} D={D} Q={Q} U8={U8} Tq={Tq}: sound, hits == plain "
            f"== exact; {ms:.4f} ms")
        del b, args, got, want
    # B5 at its edges: U8 = MAX_ROWS (one tile buffer, the indicators left
    # in global memory), Q off the 16-query fragment, and the largest counts
    for D, Q, U8, Tq, kind in ((KERNEL_D, 1, ap.MAX_ROWS, 20, "random"),
                               (KERNEL_D, 65, ap.MAX_ROWS, 64, "random"),
                               (KERNEL_D, 820, ap.MAX_ROWS, 20, "random"),
                               (SCALE_D, 65, ap.MAX_ROWS, 20, "random"),
                               (KERNEL_D, 65, ap.MAX_ROWS, 128, "adversarial"),
                               (KERNEL_D, 820, 168, 128, "adversarial"),
                               (SCALE_D, 8, 168, 128, "adversarial")):
        b = (compact_inputs(rng, gen, Q, U8, Tq, D, "bool2")
             if kind == "random"
             else adversarial_bool2_inputs(rng, gen, Q, U8, D))
        args = (b["a_sc"], b["a_cb"], b["bank_bf16"], b["params"], b["live"])
        got = counts.uncounted(ap.approx_select_bool2, *args)
        want = ap.approx_select_bool2_reference(*args)
        torch.cuda.synchronize()
        name = f"approx_select_bool2 {kind} D={D} Q={Q} U8={U8} Tq={Tq}"
        e = check_select(name, got, want, exact_tiles(rs, counts, b, True),
                         True)
        if kind == "adversarial" and int(got[1].sum()) == 0:
            raise AssertionError(f"{name}: no doc matches, the check is empty")
        err["approx_select_bool2"] = max(err["approx_select_bool2"], e)
        ms = counts.uncounted(cuda_ms, lambda: ap.approx_select_bool2(*args),
                              10)
        log(f"  B5 {kind} D={D} Q={Q} U8={U8} Tq={Tq}: sound, hits and "
            f"feasibility == plain == exact ({int(got[1].sum())} hits); "
            f"{ms:.4f} ms")
        del b, args, got, want
    # B4 at its edges: U8 up to MAX_ROWS (the indicators left in global
    # memory), Q off the 16-query fragment, and rows in two roles
    cases = [(KERNEL_D, Q, U8, 12, "two-role") for U8 in (32, 168, 512,
                                                          ap.MAX_ROWS)
             for Q in (1, 65, 820)]
    cases += [(KERNEL_D, Q, ap.MAX_ROWS, 20, "random") for Q in (1, 65, 820)]
    cases += [(SCALE_D, 65, 168, 12, "two-role"),
              (SCALE_D, 820, 32, 8, "two-role")]
    for D, Q, U8, Tq, kind in cases:
        b = (compact_inputs(rng, gen, Q, U8, Tq, D, "bool") if kind == "random"
             else two_role_inputs(rng, gen, Q, U8, Tq, D))
        args = (b["a_sc"], b["a_rq"], b["a_sh"], b["a_ng"], b["bank_bf16"],
                b["params"], b["live"])
        got = counts.uncounted(ap.approx_select_bool, *args)
        want = ap.approx_select_bool_reference(*args)
        torch.cuda.synchronize()
        name = f"approx_select_bool {kind} D={D} Q={Q} U8={U8} Tq={Tq}"
        e = check_select(name, got, want, exact_tiles(rs, counts, b, True),
                         True)
        if kind == "two-role" and int(got[1].sum()) == 0:
            raise AssertionError(f"{name}: no doc matches, the check is empty")
        err["approx_select_bool"] = max(err["approx_select_bool"], e)
        ms = counts.uncounted(cuda_ms, lambda: ap.approx_select_bool(*args),
                              10)
        log(f"  B4 {kind} D={D} Q={Q} U8={U8} Tq={Tq}: sound, hits and "
            f"feasibility == plain == exact ({int(got[1].sum())} hits); "
            f"{ms:.4f} ms")
        del b, args, got, want
    return err


def bits_inputs(rng, gen, Q, U8, Tq, D):
    """Seeded presence bitmaps i32 [U8, D/32] (row 0 empty, 1 bit in 8
    set) and Q queries in the row engine's contract for B8: kinds cycle
    through pure OR, MUST + SHOULD, required + MUST_NOT + SHOULD (min_should
    1), FILTER-only, no required clause with MUST_NOT, and dead (absent
    required clause); random scoring bits; a padding clause on row 0."""
    from diagon_tpu_torch.ops.bits_hits import MODE_DEAD, MODE_REQ, MODE_SHO

    W = D // 32
    words = [torch.randint(-2**31, 2**31, (U8, W), generator=gen,
                           dtype=torch.int32, device=DEVICE) for _ in range(3)]
    bits = words[0] & words[1] & words[2]
    bits[0] = 0
    cidx = rng.integers(1, U8, (Q, Tq)).astype(np.int32)
    cflags = np.zeros((Q, Tq), np.int32)
    qmode = np.zeros(Q, np.int32)
    h = max(1, Tq // 4)
    for q in range(Q):
        kind = (q + Q) % 6
        if kind == 0:
            cflags[q], qmode[q] = 4, MODE_SHO
        elif kind == 1:
            cflags[q, 0], cflags[q, 1:], qmode[q] = 2, 4, MODE_REQ
        elif kind == 2:
            cflags[q, :h], cflags[q, h], cflags[q, h + 1:] = 2, 8, 4
            qmode[q] = MODE_REQ | MODE_SHO
        elif kind == 3:
            cflags[q], qmode[q] = 2, MODE_REQ
        elif kind == 4:
            cflags[q] = np.where(rng.random(Tq) < 0.3, 8, 4)
            cflags[q, 0], qmode[q] = 4, MODE_SHO
        else:
            cflags[q], qmode[q] = 4, MODE_DEAD | MODE_SHO
        cflags[q] |= (((cflags[q] & 6) != 0)
                      & (rng.random(Tq) < 0.7)).astype(np.int32)
    cidx[:, -1] = 0
    cflags[:, -1] = 0
    dev = lambda x: torch.from_numpy(x).to(DEVICE)  # noqa: E731
    return bits, dev(cidx), dev(cflags), dev(qmode)


def phase_bits_kernel(bh, counts):
    """B8 against its plain version, exactly, at the 19k and 10M doc axes
    and the main path's (Q, U8, Tq) shapes."""
    log("phase 3b: B8 (bits_hits) vs plain on the card, exact")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(8)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(8)
    for D in (KERNEL_D, SCALE10_D):
        line = []
        for Q, U8, Tq in ((1, 40, 20), (820, 40, 20), (200, 40, 4),
                          (1024, 512, 4), (64, 168, 40)):
            args = bits_inputs(rng, gen, Q, U8, Tq, D)
            got = counts.uncounted(bh.bits_hits, *args)
            want = bh.bits_hits_reference(*args)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"bits_hits != plain at D={D} Q={Q} "
                                     f"U8={U8} Tq={Tq}")
            ms = cuda_ms(lambda: counts.uncounted(bh.bits_hits, *args), reps=10)
            pms = cuda_ms(lambda: bh.bits_hits_reference(*args), reps=3,
                          warmup=1)
            V, span, qg, gy = bh.bits_plan(U8, D // 32, Q, Tq, sms)
            line.append(f"({Q}, {U8}, {Tq}) {ms:.4f}/{pms:.4f} [V {V}, span "
                        f"{span}{', ragged' if (D // 32) % span else ''}, "
                        f"groups of {qg}, gy {gy}]")
            del args, got, want
        log(f"  D={D}: B8 == plain at every shape, every mode word; "
            f"ms kernel/plain: {'; '.join(line)}")
    return {"bits_hits": 0.0}


def bank_decode_bytes(pp, specs, D, F):
    """Bytes B9 must move for ``pack_specs``'s ``specs``, each once: the
    blocks' words, 11 bytes of block table a block, a 4-byte store a
    posting, the norms (a byte a doc), the LUT and the spec array; and the
    postings."""
    bs = pp.block_start
    blocks = np.concatenate([np.arange(bs[t], bs[t + 1])
                             for t in specs[1, :-1]] or [np.zeros(0, int)])
    cnt = pp.block_count[blocks].astype(np.int64)
    words = ((cnt * pp.block_doc_bits[blocks] + 31) // 32
             + (cnt * pp.block_freq_bits[blocks] + 31) // 32).sum()
    postings = int(cnt.sum())
    return (4 * int(words) + 11 * len(blocks) + 4 * postings + D
            + 4 * 128 * F + specs.nbytes), postings


def phase_bank_decode(smi):
    """B9 (bank_decode) against its plain version, bit for bit: every case
    of tests/test_torch_bank_decode.py (postings packed by hand: no freq
    section, 32-bit and straddling fields, tail blocks, freqs past the LUT,
    a block ending on the stream's last word, terms without blocks, one
    term twice, no specs), and its random bank of 163 rows over 1,105,920
    docs (one light bank of the SPLADE shard's size); each ``build_rows``
    one launch (none without blocks). Times at the random bank: B9 (CUDA
    events, wrapper), kernel only (queued behind a device sleep),
    ``build_rows`` (zero fill, spec upload, B9), the plain version, and the
    bound by bytes. Returns B9's record."""
    from diagon_tpu_torch.ops import bank_decode, launches

    log("phase 15: B9 (bank_decode) vs plain on the card, bit-equal")
    spec = importlib.util.spec_from_file_location(
        "test_torch_bank_decode", ROOT / "tests" / "test_torch_bank_decode.py")
    t = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(t)

    def check(idx, specs, label):
        n = t._nrows(specs)
        l0 = launches("bank_decode")
        got = idx.build_rows(specs, n)
        torch.cuda.synchronize()
        packed = bank_decode.pack_specs(specs, idx.pp.block_start, n)
        want_launches = 1 if bank_decode.spec_blocks(packed) else 0
        if launches("bank_decode") - l0 != want_launches:
            raise AssertionError(f"B9 {label}: {launches('bank_decode') - l0} "
                                 f"launches for one build_rows")
        if not bits_equal(got, t.reference_bank(idx, specs, n)):
            raise AssertionError(f"B9 != plain on {label}")
        return packed

    pp, norms, lut, D = t.crafted()
    idx = t.index_for(pp, norms, lut, D, DEVICE)
    for case, specs in sorted(t.CASES.items()):
        check(idx, [(r, tid, np.float32(w)) for r, tid, w in specs], case)
    log(f"  B9 == plain, one launch a build_rows, on {len(t.CASES)} crafted "
        f"cases: {', '.join(sorted(t.CASES))}")
    t0 = time.perf_counter()
    pp, norms, lut, D, specs = t.random_bank(9)
    log(f"  random bank: {len(specs)} rows, {pp.num_blocks} blocks over "
        f"{D} docs ({time.perf_counter() - t0:.1f} s on the host)")
    idx = t.index_for(pp, norms, lut, D, DEVICE)
    packed = check(idx, specs, "the random bank")
    tables = idx.device_decode_state()
    n = t._nrows(specs)
    bank = torch.zeros((n, D), dtype=torch.float32, device=DEVICE)
    ms = cuda_ms(lambda: bank_decode.bank_decode(bank, packed, tables))
    kernel = queued_ms(lambda: bank_decode.bank_decode(bank, packed, tables),
                       10)
    build = cuda_ms(lambda: idx.build_rows(specs, n), reps=10)
    plain = cuda_ms(lambda: bank_decode.bank_decode_reference(
        bank, packed, tables), reps=3, warmup=1)
    nbytes, postings = bank_decode_bytes(pp, packed, D, tables.F)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    zero = 4 * n * D / HBM_BYTES_PER_S * 1e3
    log(f"  B9 at {n} rows x {D} docs, {bank_decode.spec_blocks(packed)} "
        f"blocks, {postings} postings: {ms:.4f} ms ({kernel:.4f} kernel "
        f"only), bound {bound:.4f} ms by bytes ({nbytes} B); build_rows "
        f"{build:.4f} ms (bound with the zero fill {bound + zero:.4f}); "
        f"plain {plain:.4f} ms [{smi}]")
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": None, "max_abs_err": 0.0}


# ---------------------------------------------------------------------------
# Phases 4-5: the main path
# ---------------------------------------------------------------------------


def must_not_batch(pool, n=1024, seed=43):
    """``n`` distinct queries of a MUST head, a 2-4 term SHOULD tail and one
    MUST_NOT term, drawn from the frequent-term pool."""
    from diagon_tpu_torch.search.query import (
        BooleanClause,
        BooleanQuery,
        Occur,
        TermQuery,
    )

    rng = np.random.Generator(np.random.PCG64(seed))
    out, seen = [], set()
    while len(out) < n:
        w = int(rng.integers(4, 7))
        terms = tuple(pool[i] for i in rng.choice(len(pool), w, replace=False))
        if terms in seen:
            continue
        seen.add(terms)
        clauses = [BooleanClause(TermQuery("body", terms[0]), Occur.MUST)]
        clauses += [BooleanClause(TermQuery("body", t), Occur.SHOULD)
                    for t in terms[1:-1]]
        clauses.append(BooleanClause(TermQuery("body", terms[-1]),
                                     Occur.MUST_NOT))
        out.append(BooleanQuery(clauses, 0))
    return out


def timed_batches(searcher, batch, n):
    """Host seconds per dispatch_batch + collect_many, median of n."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        searcher.collect_many([searcher.dispatch_batch(batch, K)])
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def serve_batch(searcher, oracle, counts, batch, label, sample, need, smi,
                reps):
    """One batch on the main path (dispatch_batch + collect_many): the
    kernels in ``need`` must launch, sampled queries oracle-exact; then
    ``reps`` timed repeats. Returns (plans, pruned-counter delta,
    escalations delta)."""
    ex = searcher._ctx("body").row_executors[0]
    before = counts.read()
    m0 = {n: c.value() for n, c in ex.metrics.items()}
    t0 = time.perf_counter()
    res = searcher.collect_many([searcher.dispatch_batch(batch, K)])[0]
    first = time.perf_counter() - t0
    dm = {n: c.value() - m0[n] for n, c in ex.metrics.items()}
    counts.require(before, need, label)
    if len(res) != len(batch):
        raise AssertionError(f"{label}: {len(res)} results for {len(batch)}")
    for i in sample:
        oracle.check(batch[i], res[i], label)
    s = timed_batches(searcher, batch, reps) if reps else first
    log(f"  {label}: first {first * 1e3:.3f} ms, then {s * 1e3:.3f} ms/batch "
        f"-> {len(batch) / s:.1f} qps [{smi}]; pruned dispatches "
        f"{dm['pruned']}, escalations {dm['escalations']}, compact "
        f"fallbacks {dm['compact_fallbacks']}; {len(sample)} sampled "
        f"oracle-exact")
    plans = [searcher._query_plans(q)[1][0] for q in batch]
    return plans, dm


def pruned_equals_exhaustive(ex, counts, plans, label, pruned, want=None):
    """finalize of dispatch() (the pruned route, escalation included) equals
    finalize of the exhaustive route over the whole batch, bit for bit;
    returns the exhaustive side (``want``: an earlier one, reused)."""
    def run():
        fused = ex.dispatch(plans, K)
        return fused.shape[-1], ex.finalize(plans, fused, K)

    width, got = counts.uncounted(run)
    if want is None:
        want = counts.uncounted(
            lambda: ex.finalize(plans, ex._exhaustive_chunked(plans, K), K))
    if pruned and width != 2 * K + 2:
        raise AssertionError(f"{label}: dispatch did not take the pruned route")
    for g, w, what in zip(got, want, ("scores", "docs", "hits")):
        g, w = np.asarray(g), np.asarray(w)
        if g.dtype == np.float32:
            g, w = g.view(np.uint32), w.view(np.uint32)
        if not np.array_equal(g, w):
            raise AssertionError(f"{label}: pruned {what} != exhaustive")
    log(f"  {label}: pruned finalize == exhaustive finalize over all "
        f"{len(plans)} queries")
    return want


def scratch_dir():
    """A temporary directory, removed when the script exits."""
    tmp = tempfile.TemporaryDirectory(prefix="diagon_smoke_")
    atexit.register(tmp.cleanup)
    return Path(tmp.name)


def same_array(what, got, want):
    """Equal dtypes, shapes and values, or an AssertionError."""
    if got.dtype != want.dtype or not np.array_equal(got, want):
        raise AssertionError(f"{what}: the loaded array ({got.dtype}, "
                             f"{got.shape}) != the built one ({want.dtype}, "
                             f"{want.shape})")


def segment_from_disk(seg, smi):
    """``seg`` through the store tier: write_segment into a temporary
    FSDirectory with a ``segments_1`` commit (SegmentInfos and _gen_name; no
    IndexWriter), then DirectoryReader.open, timed without and with
    verify_checksums (the reader kept is the verified one). Every postings
    array and the norms are checked equal to the built segment's, dtypes
    included (the file narrows some; the reader rebuilds them); the
    positions must still be undecoded (``positions_equal`` checks them after
    their first decode). Returns (reader, seconds by step)."""
    from diagon_tpu_torch.codecs.postings import PackedPostings
    from diagon_tpu_torch.index import (
        DirectoryReader,
        SegmentInfo,
        SegmentInfos,
    )
    from diagon_tpu_torch.index.writer import _gen_name
    from diagon_tpu_torch.store import FSDirectory, write_segment

    d = FSDirectory(scratch_dir())
    t0 = time.perf_counter()
    files = write_segment(d, seg)
    infos = SegmentInfos(generation=1, counter=1,
                         segments=[SegmentInfo(seg.name, seg.num_docs, files)])
    d.write_bytes(_gen_name(1), json.dumps(infos.to_json()).encode())
    secs = {"write": time.perf_counter() - t0}
    size = sum(d.file_length(f) for f in d.list_files())
    t0 = time.perf_counter()
    DirectoryReader.open(d)
    secs["open"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    reader = DirectoryReader.open(d, verify_checksums=True)
    secs["open_verified"] = time.perf_counter() - t0
    (loaded,) = reader.segments_data()
    if (loaded.num_docs, list(loaded.fields)) != (seg.num_docs,
                                                   list(seg.fields)):
        raise AssertionError("the loaded segment's docs or fields differ")
    skip = ("pos_start", "positions", "pos_loader")
    for name, fd in seg.fields.items():
        lf = loaded.fields[name]
        same_array(f"{name} norms", lf.norms, fd.norms)
        for f in dataclasses.fields(PackedPostings):
            a, b = getattr(lf.postings, f.name), getattr(fd.postings, f.name)
            if f.name in skip:
                continue
            if isinstance(b, np.ndarray):
                same_array(f"{name} {f.name}", a, b)
            elif a != b:
                raise AssertionError(f"{name} {f.name}: {a!r} != {b!r}")
        if fd.postings.has_positions and lf.postings.pos_start is not None:
            raise AssertionError(f"{name}: positions decoded at open")
    log(f"  index on disk: write_segment + segments_1 {secs['write']:.2f} s "
        f"({size / 2**20:.1f} MiB in {len(d.list_files())} files); "
        f"DirectoryReader.open (mmap and header) {secs['open']:.3f} s, with "
        f"verify_checksums {secs['open_verified']:.2f} s; every postings "
        f"array and the norms equal the built segment's, dtypes included; "
        f"positions still undecoded [{smi}]")
    return reader, secs


def positions_equal(built, loaded, name="body"):
    """The loaded segment's positions of field ``name`` (the phrase path's),
    decoded by its first phrase use, equal the built segment's."""
    pb, pl = built.fields[name].postings, loaded.fields[name].postings
    if pl.pos_start is None:
        raise AssertionError(f"{name}: the positions were never decoded")
    same_array(f"{name} pos_start", pl.pos_start, pb.pos_start)
    same_array(f"{name} positions", pl.positions, pb.positions)
    log(f"  the loaded {name} positions equal the built segment's")


def load_searcher(n_docs, disk=None, **kw):
    """A built segment and its searcher on the card; seconds of both. With
    ``disk`` (a dict), the segment goes through the store tier first
    (``segment_from_disk``): the searcher serves the loaded segment, which
    is returned, and ``disk`` gets the built one, the reader and the
    set-up seconds."""
    from diagon_tpu_torch.bench.bulk_build import build_synthetic_segment
    from diagon_tpu_torch.search import IndexSearcher

    t0 = time.perf_counter()
    seg = build_synthetic_segment(n_docs)
    t_build = time.perf_counter() - t0
    log(f"  segment build {t_build:.2f} s")
    source = [seg]
    if disk is not None:
        reader, secs = segment_from_disk(seg, kw.pop("smi"))
        disk.update(built=seg, reader=reader, secs=secs)
        source = reader
        (seg,) = reader.segments_data()
    t0 = time.perf_counter()
    searcher = IndexSearcher(source, device=DEVICE, **kw)
    idx = searcher._ctx("body").row_executors[0].index
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    if idx.heavy_bank is not None:
        bank = idx.heavy_bank
        what = (f"bank {tuple(bank.shape)}, "
                f"{bank.numel() * 4 / 2**20:.1f} MiB")
    else:
        what = (f"on demand: {len(idx.heavy_tid_of_row)} heavy terms, "
                "no resident bank")
    log(f"  device load + heavy rows {t_load:.2f} s ({what})")
    return seg, searcher, t_build, t_load


def phrase_sample(batch, every=32, others=None):
    """Indices of every ``every``-th query and of every phrase query,
    ascending (the oracle answers each phrase text once); with ``others``
    set, of the first queries of the reference's five phrase texts and of
    the first ``others`` other texts only."""
    from diagon_tpu_torch.bench.queries import PHRASES
    from diagon_tpu_torch.search.query import PhraseQuery

    first = {}
    for i, q in enumerate(batch):
        if isinstance(q, PhraseQuery):
            first.setdefault(tuple(q.terms), []).append(i)
    if others is None:
        picked = [i for idx in first.values() for i in idx]
    else:
        fixed = {tuple(p) for p in PHRASES}
        picked = ([idx[0] for t, idx in first.items() if t in fixed]
                  + sorted(idx[0] for t, idx in first.items()
                           if t not in fixed)[:others])
    return sorted(set(range(0, len(batch), every)) | set(picked))


def solo_phrase_ms(searcher, queries, label, smi, reps=10):
    """Host ms of a solo phrase search (plan cached: the position
    intersection, top-k and one copy back), median of ``reps``."""
    from diagon_tpu_torch.search.query import PhraseQuery

    out = []
    for name, q in queries.items():
        if not isinstance(q, PhraseQuery):
            continue
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            searcher.search(q, K)
            times.append(time.perf_counter() - t0)
        out.append(f"{name.split(':')[1]} {statistics.median(times) * 1e3:.3f}")
    log(f"  {label} solo phrase ms (median of {reps}): {', '.join(out)} "
        f"[{smi}]")


def phrase_plan_split(searcher, batch, label, smi):
    """The batch's plans built cold, under torch.profiler: host wall against
    device time. A phrase text's plan is its ``score_row``: the host
    conjunction, the position intersection on the card, one copy of its C
    scores back and the host row; equal texts share one plan."""
    from torch.profiler import ProfilerActivity, profile

    texts = len({tuple(q.terms) for q in batch if hasattr(q, "terms")})
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for q in batch:
            searcher._query_plans(q)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = sum(e.self_device_time_total for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    log(f"  {label} plans, cold: {wall * 1e3:.3f} ms host for {len(batch)} "
        f"queries ({texts} phrase texts), device {dev:.3f} ms "
        f"({100 * dev / (wall * 1e3):.1f}%) [{smi}]")


def phase_serve(counts, smi):
    from diagon_tpu_torch.bench.queries import (
        frequent_terms,
        mixed_query_batch,
        phrase_query_batch,
        reuters_queries,
    )

    log(f"phase 4: serving at {SERVE_DOCS} docs")
    seg, searcher, _, _ = load_searcher(SERVE_DOCS)
    oracle = Oracle(seg)
    queries = reuters_queries()  # the five phrase families included
    pool = frequent_terms(searcher)
    # bench.py's batches: the mixed headline with phrase_share 5
    # (bench.py:412-415) and the phrase_qps batch (bench.py:446)
    mixed = mixed_query_batch(pool, 1024, seed=42, phrase_share=5)
    phrases = phrase_query_batch(pool, 1024, seed=43)
    neg = must_not_batch(pool)
    or20_batch = [queries["or20"]] * 1024
    sample = list(range(0, 1024, 32))

    counts.reset()
    before = counts.read()
    for name, q in queries.items():
        oracle.check(q, searcher.search(q, K), f"solo {name}")
    pos = 0
    for n in range(1, 8):
        batch = mixed[pos : pos + n]
        pos += n
        for q, r in zip(batch, searcher.search_batch(batch, K)):
            oracle.check(q, r, f"search_batch({n})")
    counts.require(before, ["row_sum", "row_boolean"], "solo + small batches")
    log(f"  solo search ({len(queries)} families, the five phrases included) "
        f"and search_batch sizes 1..7 ({pos} queries) oracle-exact")
    solo_phrase_ms(searcher, queries, "19k", smi)
    batches, sent = {}, {}
    for label, batch, need, pruned, smp in (
        ("or20 x 1024", or20_batch, ["row_sum"], False, sample),
        ("mixed 1024", mixed,
         ["approx_select", "approx_select_bool2", "gather_rescore",
          "union_rescore"], True, phrase_sample(mixed)),
        ("MUST_NOT 1024", neg, ["approx_select_bool", "union_rescore"], True,
         sample),
        ("phrase 1024", phrases, ["approx_select", "gather_rescore"], True,
         phrase_sample(phrases)),
    ):
        if label == "phrase 1024":
            phrase_plan_split(searcher, batch, label, smi)
        plans, dm = serve_batch(searcher, oracle, counts, batch, label,
                                smp, need, smi, reps=5)
        if pruned and dm["pruned"] < 1:
            raise AssertionError(f"{label}: search.pruned_dispatches did not move")
        batches[label] = plans
        sent[label] = batch
    launches = counts.read()
    ex = searcher._ctx("body").row_executors[0]
    for label in ("mixed 1024", "MUST_NOT 1024", "phrase 1024"):
        pruned_equals_exhaustive(ex, counts, batches[label], label, True)
    return searcher, batches, sent, launches


# ---------------------------------------------------------------------------
# Phase 11: the write path at the reference's indexing size
# ---------------------------------------------------------------------------


def same_segment(what, got, want):
    """Equal docs, fields, norms, terms, every PackedPostings array
    (positions after their decode; dtypes included) and stored rows."""
    from diagon_tpu_torch.codecs.postings import PackedPostings

    if (got.num_docs, list(got.fields)) != (want.num_docs, list(want.fields)):
        raise AssertionError(f"{what}: docs or fields differ")
    for name, fd in want.fields.items():
        gf = got.fields[name]
        if gf.with_positions != fd.with_positions:
            raise AssertionError(f"{what} {name}: with_positions differs")
        same_array(f"{what} {name} norms", gf.norms, fd.norms)
        gf.postings.ensure_positions()
        fd.postings.ensure_positions()
        for f in dataclasses.fields(PackedPostings):
            a, b = getattr(gf.postings, f.name), getattr(fd.postings, f.name)
            if f.name == "pos_loader":
                continue
            if isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
                same_array(f"{what} {name} {f.name}", a, b)
            elif a != b:
                raise AssertionError(f"{what} {name} {f.name}: differs")
    if list(got.stored) != list(want.stored):
        raise AssertionError(f"{what}: stored rows differ")


def timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


def dir_mib(d):
    return sum(d.file_length(f) for f in d.list_files()) / 2**20


def ingest_bulk(docs, smi):
    """(a): one add_documents of the corpus into a 512 MB buffer, one
    commit (its one flush)."""
    from diagon_tpu_torch.index.writer import IndexWriter, IndexWriterConfig
    from diagon_tpu_torch.store import FSDirectory

    d = FSDirectory(scratch_dir())
    w = IndexWriter(d, IndexWriterConfig(ram_buffer_mb=512,
                                         merge_scheduler="serial"))
    _, t_add = timed(w.add_documents, docs)
    _, t_commit = timed(w.commit)
    (seg,) = w._segments
    w.close()
    n = len(docs)
    log(f"  ingest (a) add_documents x {n}: {t_add:.3f} s, commit (one "
        f"flush + write) {t_commit:.3f} s -> {n / (t_add + t_commit):.0f} "
        f"docs/s host; {dir_mib(d):.1f} MiB on disk [{smi}]")
    return seg


def ingest_per_doc(docs, smi):
    """(b): add_document per document, max_buffered_docs 4,761 (four
    flushes), the serial scheduler; commit, force_merge(1),
    commit_merge_results, close."""
    from diagon_tpu_torch.index.writer import IndexWriter, IndexWriterConfig
    from diagon_tpu_torch.store import FSDirectory

    d = FSDirectory(scratch_dir())
    w = IndexWriter(d, IndexWriterConfig(max_buffered_docs=4761,
                                         merge_scheduler="serial"))
    flushes = []
    t0 = time.perf_counter()
    for doc in docs:
        before = w.segment_count
        t = time.perf_counter()
        w.add_document(doc)
        if w.segment_count > before:
            flushes.append(time.perf_counter() - t)
    t_add = time.perf_counter() - t0
    _, t_commit = timed(w.commit)
    if w.segment_count != 4:
        raise AssertionError(f"(b) flushed {w.segment_count} segments, not 4")
    sizes = [s.num_docs for s in w._segments]
    mib_before = dir_mib(d)
    _, t_merge = timed(w.force_merge, 1)
    _, t_cmr = timed(w.commit_merge_results)
    (merged,) = w._segments
    w.close()
    n = len(docs)
    log(f"  ingest (b) add_document x {n}: {t_add:.3f} s with 3 flushes "
        f"({', '.join(f'{t:.3f}' for t in flushes)} s) + commit (the 4th "
        f"flush) {t_commit:.3f} s -> {n / (t_add + t_commit):.0f} docs/s "
        f"host; segments {sizes}, {mib_before:.1f} MiB; force_merge(1) "
        f"{t_merge:.3f} s, commit_merge_results {t_cmr:.3f} s, "
        f"{dir_mib(d):.1f} MiB [{smi}]")
    return d, merged


def append_and_merge(d, docs, extra, smi):
    """Reopen (b) in APPEND mode, add ``extra`` again, commit and
    force_merge(1): the merge takes in the segment read from disk, whose
    positions are still lazy. Its segment must equal one add_documents
    flush of the same documents."""
    from diagon_tpu_torch.index.memory_index import MemoryIndex
    from diagon_tpu_torch.index.segment import flush_memory_index
    from diagon_tpu_torch.index.writer import IndexWriter, IndexWriterConfig

    w = IndexWriter(d, IndexWriterConfig(open_mode="APPEND",
                                         merge_scheduler="serial"))
    (loaded,) = w._segments
    if loaded.fields["body"].postings.pos_start is not None:
        raise AssertionError("the reopened segment's positions are decoded")
    _, t_add = timed(w.add_documents, extra)
    _, t_commit = timed(w.commit)
    _, t_merge = timed(w.force_merge, 1)
    _, t_cmr = timed(w.commit_merge_results)
    (merged,) = w._segments
    w.close()
    want = len(docs) + len(extra)
    if merged.num_docs != want:
        raise AssertionError(f"appended index has {merged.num_docs} docs")
    mem = MemoryIndex()
    mem.add_documents(docs + extra)
    same_segment("appended merge vs one flush", merged,
                 flush_memory_index(mem, merged.name))
    log(f"  append: reopened (APPEND), add_documents x {len(extra)} "
        f"{t_add:.3f} s, commit {t_commit:.3f} s, force_merge(1) over the "
        f"segment read from disk {t_merge:.3f} s, commit_merge_results "
        f"{t_cmr:.3f} s: {want} docs, equal to one add_documents flush of "
        f"the same documents; {dir_mib(d):.1f} MiB [{smi}]")


def serve_ingested(counts, d, smi, label, before=None):
    """Serve the body field of the index in ``d`` on the card with bench.py's
    batches, as phase 4 does: or20 x 1024, mixed 1024 (phrase_share 5),
    phrase 1024 and the MUST_NOT batch, sampled oracle checks and pruned ==
    exhaustive over each pruned batch; solo searches and search_batch
    sizes 1-7 first (B1, B2). Returns {batch label: (queries, totals)}."""
    from diagon_tpu_torch.bench.queries import (
        frequent_terms,
        mixed_query_batch,
        phrase_query_batch,
        reuters_queries,
    )
    from diagon_tpu_torch.index import DirectoryReader
    from diagon_tpu_torch.search import IndexSearcher

    reader, t_open = timed(DirectoryReader.open, d)
    (seg,) = reader.segments_data()
    searcher, t_load = timed(IndexSearcher, reader, DEVICE)
    torch.cuda.synchronize()
    log(f"  {label}: DirectoryReader.open {t_open:.3f} s, device load "
        f"{t_load:.3f} s ({seg.num_docs} docs, {seg.num_live_docs} live) "
        f"[{smi}]")
    oracle = Oracle(seg)
    queries = reuters_queries()
    if before is None:
        pool = frequent_terms(searcher)
        batches = {
            "or20 x 1024": [queries["or20"]] * 1024,
            "mixed 1024": mixed_query_batch(pool, 1024, seed=42,
                                            phrase_share=5),
            "phrase 1024": phrase_query_batch(pool, 1024, seed=43),
            "MUST_NOT 1024": must_not_batch(pool),
        }
    else:
        batches = {name: qs for name, (qs, _) in before.items()}
    need = {"or20 x 1024": ["row_sum"],
            "mixed 1024": ["approx_select", "approx_select_bool2",
                           "gather_rescore", "union_rescore"],
            "phrase 1024": ["approx_select", "gather_rescore"],
            "MUST_NOT 1024": ["approx_select_bool", "union_rescore"]}
    pre = counts.read()
    for name, q in queries.items():
        oracle.check(q, searcher.search(q, K), f"{label} solo {name}")
    mixed, pos = batches["mixed 1024"], 0
    for n in range(1, 8):
        batch = mixed[pos:pos + n]
        pos += n
        for q, r in zip(batch, searcher.search_batch(batch, K)):
            oracle.check(q, r, f"{label} search_batch({n})")
    counts.require(pre, ["row_sum", "row_boolean"], f"{label} solo + small")
    ex = searcher._ctx("body").row_executors[0]
    out = {}
    for name, batch in batches.items():
        sample = (list(range(0, 1024, 32)) if name in ("or20 x 1024",
                                                       "MUST_NOT 1024")
                  else phrase_sample(batch))
        plans, dm = serve_batch(searcher, oracle, counts, batch,
                                f"{label} {name}", sample, need[name], smi,
                                reps=2)
        if name != "or20 x 1024":
            if dm["pruned"] < 1:
                raise AssertionError(f"{label} {name}: not pruned")
            pruned_equals_exhaustive(ex, counts, plans, f"{label} {name}",
                                     True)
        res = searcher.collect_many([searcher.dispatch_batch(batch, K)])[0]
        out[name] = (batch, [r.total_hits for r in res])
    return out


def delete_and_check(counts, d, docs, served, smi):
    """delete_documents("date", <the first doc's date>) on a writer over
    the index, commit, reopen and serve again: each served query's
    total_hits drops by exactly the number of deleted docs that match it
    (the oracle's count over a segment of just those docs)."""
    from diagon_tpu_torch.index.memory_index import MemoryIndex
    from diagon_tpu_torch.index.segment import flush_memory_index
    from diagon_tpu_torch.index.writer import IndexWriter, IndexWriterConfig
    from diagon_tpu_torch.search.oracle import OracleSearcher

    date = docs[0].get("date")
    gone = [doc for doc in docs if doc.get("date") == date]
    w = IndexWriter(d, IndexWriterConfig(open_mode="APPEND",
                                         merge_scheduler="serial"))
    n, t_del = timed(w.delete_documents, "date", date)
    _, t_commit = timed(w.commit)
    w.close()
    if n != len(gone):
        raise AssertionError(f"deleted {n} docs, {len(gone)} hold {date!r}")
    log(f"  delete_documents('date', {date!r}): {n} docs {t_del:.3f} s, "
        f"commit {t_commit:.3f} s [{smi}]")
    mem = MemoryIndex()
    mem.add_documents(gone)
    only_gone = OracleSearcher([flush_memory_index(mem, "_gone")])
    after = serve_ingested(counts, d, smi, "after the delete", before=served)
    checked = moved = 0
    for name, (batch, hits) in served.items():
        memo = {}
        for q, h0, h1 in zip(batch, hits, after[name][1]):
            key = repr(q)
            if key not in memo:
                memo[key] = only_gone.count(q)
            if h0 - h1 != memo[key]:
                raise AssertionError(f"{name}: {q!r} lost {h0 - h1} hits, "
                                     f"{memo[key]} deleted docs match it")
            checked += 1
            moved += h0 != h1
    log(f"  every served query's hits dropped by its deleted matches "
        f"({checked} queries, {moved} of them moved)")


def phase_ingest(counts, smi):
    from diagon_tpu_torch.bench.synthetic import corpus_documents

    log(f"phase 11: the write path at {SERVE_DOCS} docs (corpus_documents, "
        "the reference's reuters_benchmark phase 1)")
    docs, t_gen = timed(lambda: list(corpus_documents(SERVE_DOCS)))
    log(f"  corpus_documents({SERVE_DOCS}): {t_gen:.3f} s")
    seg_a = ingest_bulk(docs, smi)
    d_b, merged = ingest_per_doc(docs, smi)
    same_segment("(a) one flush vs (b) four flushes merged", merged, seg_a)
    log("  (a)'s segment equals (b)'s merged one: norms, terms, every "
        "postings array, positions, stored rows")
    append_and_merge(d_b, docs, docs[:500], smi)
    counts.reset()
    served = serve_ingested(counts, d_b, smi, "ingested index")
    delete_and_check(counts, d_b, docs + docs[:500], served, smi)
    launches = counts.read()
    idle = [n for n in ("row_sum", "row_boolean", "approx_select",
                        "approx_select_bool", "approx_select_bool2",
                        "gather_rescore", "union_rescore")
            if launches[n] < 1]
    if idle:
        raise AssertionError(f"the ingested index's serving never "
                             f"launched {idle}")
    log(f"  launches: {launches}")
    return launches


def positions_upload(searcher, smi):
    """Decode (host) and upload (card) of the body field's positions, the
    first phrase use's set-up: seconds of each and the bytes on the card."""
    f = searcher.device_segments[0].fields["body"]
    t0 = time.perf_counter()
    f._pos_pp.ensure_positions()
    t_dec = time.perf_counter() - t0
    t0 = time.perf_counter()
    f.ensure_positions()
    torch.cuda.synchronize()
    t_up = time.perf_counter() - t0
    byts = nbytes(f.pos_start, f.positions)
    log(f"  positions: host decode {t_dec:.3f} s, upload {t_up:.3f} s, "
        f"{f.positions.numel()} positions + {f.pos_start.numel()} entry "
        f"offsets = {byts / 2**20:.1f} MiB on the card [{smi}]")
    return t_dec


def rare_term(searcher, lo=50, hi=400):
    """The body term of least document frequency in [lo, hi)."""
    pp = searcher._host_segments()[0].fields["body"].postings
    df = pp.doc_freq
    ok = np.nonzero((df >= lo) & (df < hi))[0]
    tid = int(ok[np.argmin(df[ok])])
    return pp.terms[tid], int(df[tid])


def device_ops(fn):
    """(device operations, device ms) of one call of ``fn`` under
    torch.profiler; (0, 0.0) where the profiler recorded no device row."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.count for e in rows),
            sum(e.self_device_time_total for e in rows) / 1e3)


def solo_pure_or(searcher, pool, or20):
    """Phase 5's solo pure-OR queries by name: or20, ORs of 2-5 frequent
    terms, and one with a rare term."""
    from diagon_tpu_torch.bench.queries import _or_query as or_query

    rare, rare_df = rare_term(searcher)
    return {
        "or20": or20,
        "or2": or_query(pool[:2]),
        "or3": or_query([pool[30], pool[77], pool[120]]),
        "or4": or_query(pool[2:6]),
        "or5": or_query(pool[10:15]),
        f"{rare}(df {rare_df})+1": or_query([rare, pool[50]]),
    }


def solo_route(searcher, oracle, counts, pool, or20, smi):
    """Phase 5's solo pure-OR queries (or20, ORs of 2-5 frequent terms, one
    with a rare term) and a pure-OR batch of 3 plans: at 1M docs they take
    the small-batch tile-UB route by default (routed outside batch mode;
    [Q, 2k+2] rows). Counted as main path; then, uncounted: the route and
    its rows,
    finalize equal to the exhaustive route's bit for bit, and each solo
    query's latency on both routes (searcher.search, median of 10, in
    turns), its device time (calls queued behind a device sleep) and the
    device operations of one tile-UB dispatch. The batch reuses three of
    the solo queries (the oracle answers each query object once), as
    ``or20`` is the object the or20 batch already checked."""
    t0 = time.perf_counter()
    ex = searcher._ctx("body").row_executors[0]
    solos = solo_pure_or(searcher, pool, or20)
    batch = [solos["or2"], solos["or5"], list(solos.values())[-1]]
    m0 = {n: c.value() for n, c in ex.metrics.items()}
    before = counts.read()
    for name, q in solos.items():
        oracle.check(q, searcher.search(q, K), f"1M solo {name}")
    res = searcher.collect_many([searcher.dispatch_batch(batch, K)])[0]
    for q, r in zip(batch, res):
        oracle.check(q, r, "1M pure-OR batch of 3")
    dm = {n: c.value() - m0[n] for n, c in ex.metrics.items()}
    launched = {n: v - before[n] for n, v in counts.read().items()
                if v > before[n]}
    if dm["pruned"] < len(solos) + 1:
        raise AssertionError(f"1M solo route: {dm['pruned']} pruned "
                             f"dispatches for {len(solos) + 1} calls")
    log(f"  1M tile-UB route: {len(solos)} solo queries and a batch of 3 "
        f"oracle-exact ({time.perf_counter() - t0:.1f} s); pruned "
        f"dispatches {dm['pruned']}, escalations {dm['escalations']} (onto "
        f"B1); launched {launched}")

    def plans_of(qs):
        return [searcher._query_plans(q)[1][0] for q in qs]

    cases = [(f"solo {n}", plans_of([q])) for n, q in solos.items()]
    cases.append(("pure-OR batch of 3", plans_of(batch)))
    for label, plans in cases:
        if ex._batch_mode(plans) or not ex._use_pruned(plans):
            raise AssertionError(f"1M {label}: not routed to the tile-UB "
                                 "route")
        pruned_equals_exhaustive(ex, counts, plans, f"1M {label}", True)
    for name, q in solos.items():
        (plan,) = plans_of([q])
        times = {"tile-UB": [], "exhaustive": []}

        def timed():
            for _ in range(10):
                for route in times:
                    with on_route(ex, route):
                        t0 = time.perf_counter()
                        searcher.search(q, K)
                        times[route].append(time.perf_counter() - t0)

        counts.uncounted(timed)
        dev = {}
        for route in times:
            with on_route(ex, route):
                # 4 calls: a tile-UB dispatch launches ~160 device ops,
                # and more than the launch queue holds would block the host
                dev[route] = counts.uncounted(
                    queued_ms, lambda: ex.dispatch([plan], K), 4)
        n_ops, _ = counts.uncounted(device_ops, lambda: ex.dispatch([plan], K))
        med = {r: statistics.median(t) * 1e3 for r, t in times.items()}
        log(f"  1M solo {name} (Tq {len(plan.hidx)}): search "
            f"{med['tile-UB']:.4f} ms tile-UB, {med['exhaustive']:.4f} ms "
            f"exhaustive (median of 10, in turns); dispatch device time "
            f"{dev['tile-UB']:.4f} / {dev['exhaustive']:.4f} ms; "
            f"{n_ops} device ops a tile-UB dispatch [{smi}]")


def phase_scale(counts, smi):
    from diagon_tpu_torch.bench.queries import (
        PHRASES,
        frequent_terms,
        mixed_query_batch,
        phrase_query_batch,
        reuters_queries,
    )

    log(f"phase 5: scale at {SCALE_DOCS} docs, served from disk")
    disk = {}
    seg, searcher, _, t_load = load_searcher(SCALE_DOCS, disk=disk, smi=smi)
    oracle = Oracle(seg)
    pool = frequent_terms(searcher)
    # the scale tiers keep phrase_share 0 (bench.py:412-414)
    mixed = mixed_query_batch(pool, 1024, phrase_share=0)
    queries = reuters_queries()
    or20_batch = [queries["or20"]] * 1024
    phrases = phrase_query_batch(pool, 1024, seed=43)
    counts.reset()
    batches, sent = {}, {}
    for label, batch, need, sample in (
        ("1M mixed 1024", mixed,
         ["approx_select", "approx_select_bool2", "gather_rescore",
          "union_rescore"],
         [0, 37, 512]),
        ("1M or20 x 1024", or20_batch, ["approx_select", "gather_rescore"],
         [0]),
        ("1M MUST_NOT 1024", must_not_batch(pool),
         ["approx_select_bool", "union_rescore"], [0, 511]),
    ):
        plans, dm = serve_batch(searcher, oracle, counts, batch, label,
                                sample, need, smi, reps=3)
        if dm["pruned"] < 1:
            raise AssertionError(f"{label}: search.pruned_dispatches did not move")
        batches[label] = plans
        sent[label] = batch
    # phrases at 1M: the five families solo, then bench.py's phrase batch
    # (the oracle takes seconds a phrase here: the sample holds the five
    # reference texts, already checked solo, and one other)
    t_dec = positions_upload(searcher, smi)
    positions_equal(disk.pop("built"), seg)
    secs = disk["secs"]
    log(f"  1M set-up from disk: write {secs['write']:.2f} s, open "
        f"{secs['open']:.3f} s (verified {secs['open_verified']:.2f} s), "
        f"first position decode {t_dec:.2f} s, device load {t_load:.2f} s "
        f"[{smi}]")
    for p in PHRASES:
        name = "phrase:" + " ".join(p)
        oracle.check(queries[name], searcher.search(queries[name], K),
                     f"1M solo {name}")
    log(f"  1M solo phrases ({len(PHRASES)} families) oracle-exact")
    solo_phrase_ms(searcher, queries, "1M", smi)
    phrase_plan_split(searcher, phrases, "1M phrase 1024", smi)
    plans, dm = serve_batch(searcher, oracle, counts, phrases,
                            "1M phrase 1024", phrase_sample(phrases, 1024, 1),
                            ["approx_select", "gather_rescore"], smi, reps=3)
    if dm["pruned"] < 1:
        raise AssertionError("1M phrase 1024: search.pruned_dispatches did "
                             "not move")
    batches["1M phrase 1024"] = plans
    sent["1M phrase 1024"] = phrases
    solo_route(searcher, oracle, counts, pool, queries["or20"], smi)
    launches = counts.read()
    ex = searcher._ctx("body").row_executors[0]
    for label, plans in batches.items():
        pruned_equals_exhaustive(ex, counts, plans, label, True)
    return searcher, batches, sent, launches, disk["reader"]


# ---------------------------------------------------------------------------
# Phase 12: the embedding API and tier-managed residency
# ---------------------------------------------------------------------------

API_VIEWS_SEED = 13  # numpy.random.default_rng seed of the views field
API_VIEWS_MAX = 1_000_000


def api_index(dg, smi):
    """corpus_documents(SERVE_DOCS) with a views field (an indexed long:
    keyword + stored + NUMERIC doc values, and a long point for the point
    range and the histogram) written through the C-API form: writer config
    setters, max_buffered_docs 4,761 (four flushes), add_documents, commit,
    close. Returns (path, views)."""
    from diagon_tpu_torch.bench.synthetic import corpus_documents

    docs = list(corpus_documents(SERVE_DOCS))
    views = np.random.default_rng(API_VIEWS_SEED).integers(
        0, API_VIEWS_MAX, SERVE_DOCS)
    for doc, v in zip(docs, views.tolist()):
        dg.document_add_field(doc, dg.create_indexed_long_field("views", v))
        dg.document_add_field(doc, dg.create_long_point_field("views", v))
    path = str(scratch_dir())
    cfg = dg.create_index_writer_config()
    dg.config_set_ram_buffer_size(cfg, 512.0)
    dg.config_set_max_buffered_docs(cfg, 4761)
    dg.config_set_open_mode(cfg, 0)  # CREATE
    dg.config_set_commit_on_close(cfg, True)
    dg.config_set_use_compound_file(cfg, True)
    t0 = time.perf_counter()
    w = dg.create_index_writer(path, cfg)
    n = dg.add_documents(w, docs)
    gen = dg.commit(w)
    dg.close_writer(w)
    t_write = time.perf_counter() - t0
    log(f"  C-API writer: add_documents x {n} + commit (gen {gen}) + close "
        f"{t_write:.3f} s -> {n / t_write:.0f} docs/s host; "
        f"{dg.directory_get_size(dg.open_fs_directory(path)) / 2**20:.1f} "
        f"MiB [{smi}]")
    return path, views


def api_queries(dg, searcher):
    """64 term / boolean / phrase queries drawn as phase 11 draws its
    batches (48 of the mixed batch with phrase_share 5, 16 MUST_NOT
    queries), then ranges on views and match-all."""
    from diagon_tpu_torch.bench.queries import frequent_terms, mixed_query_batch

    pool = frequent_terms(searcher)
    queries = (mixed_query_batch(pool, 48, seed=42, phrase_share=5)
               + must_not_batch(pool, 16))
    lo, hi = API_VIEWS_MAX // 5, API_VIEWS_MAX // 2
    queries += [
        dg.numeric_range_query("views", lo, hi),
        dg.double_point_range_query("views", float(hi), None),
        dg.boolean_query(must=[dg.term_query("body", pool[1])],
                         filter_=[dg.numeric_range_query("views", 0, hi)]),
        dg.match_all_query(),
    ]
    return queries


def api_checks(dg, reader, searcher, views, queries, smi):
    """(a)'s gates: every query through search_top_docs and count equal to
    the oracle (docids, score bits, hits); TermsEnum / PostingsEnum over the
    first 200 body terms equal to the oracle's postings; the doc-values
    bulk read and scan, compute_histogram and search_with_date_histogram
    equal to numpy over the same documents; pcall on a missing index.
    Returns the oracle's TopDocs by query."""
    from diagon_tpu_torch.search.oracle import OracleSearcher

    segs = reader.segments_data()
    oracle = OracleSearcher(segs)
    t0 = time.perf_counter()
    got = [dg.search_top_docs(searcher, q, K) for q in queries]
    counts = [dg.count(searcher, q) for q in queries]
    t_api = time.perf_counter() - t0
    want = [oracle.search(q, K) for q in queries]
    for q, g, w, c in zip(queries, got, want, counts):
        if not same_topdocs(g, w):
            raise AssertionError(f"API search_top_docs differs from the "
                                 f"oracle for {q!r}:\n  {g}\n  {w}")
        if c != oracle.count(q):
            raise AssertionError(f"API count {c} != the oracle's for {q!r}")
    log(f"  {len(queries)} queries through search_top_docs + count equal "
        f"to the oracle (docids, score bits, hits) in {t_api:.3f} s of "
        f"host [{smi}]")

    te = dg.reader_get_terms(reader, "body")
    bases = [leaf.doc_base for leaf in reader.leaves()]
    n_terms = n_post = 0
    while n_terms < 200 and dg.terms_enum_next(te):
        term = dg.terms_enum_get_term(te)
        pe = dg.terms_enum_get_postings(te)
        docs = []
        while (d := dg.postings_next_doc(pe)) != -1:
            docs.append((d, dg.postings_freq(pe)))
        want_docs = []
        for base, seg in zip(bases, segs):
            dd, ff = OracleSearcher._term_postings(seg, "body", term)
            want_docs += [(int(x) + base, int(f)) for x, f in zip(dd, ff)]
        if docs != want_docs or dg.terms_enum_doc_freq(te) != len(docs):
            raise AssertionError(f"PostingsEnum of {term!r} differs from "
                                 "the oracle's postings")
        n_terms += 1
        n_post += len(docs)
    log(f"  TermsEnum / PostingsEnum: the first {n_terms} body terms "
        f"({n_post} postings) equal the oracle's")

    ids = np.random.default_rng(API_VIEWS_SEED).integers(
        0, SERVE_DOCS + 100, 4096)
    vals, found = dg.reader_get_numeric_doc_values_bulk(reader, "views", ids)
    inside = ids < SERVE_DOCS
    same_array("numeric DV bulk found", found, inside)
    same_array("numeric DV bulk values", vals,
               np.where(inside, views[np.minimum(ids, SERVE_DOCS - 1)],
                        0).astype(np.float64))
    scan, valid = dg.reader_scan_numeric_doc_values(reader, "views")
    same_array("numeric DV scan", scan, views.astype(np.float64))
    same_array("numeric DV scan valid", valid, np.ones(SERVE_DOCS, bool))
    interval = API_VIEWS_MAX / 20
    hist, total = dg.compute_histogram(reader, "views", 0.0, interval, 20)
    same_array("compute_histogram", hist,
               np.bincount(np.floor(views / interval).astype(np.int64),
                           minlength=20))
    if total != SERVE_DOCS:
        raise AssertionError(f"compute_histogram total {total}")
    rq = queries[-4]
    lo, hi = rq.lower, rq.upper
    mask = (views >= lo) & (views <= hi)
    keys, hc, hits = dg.search_with_date_histogram(
        searcher, rq, reader, "views", interval / 4, float(lo), float(hi))
    nb = int(np.ceil((hi - lo) / (interval / 4)))
    b = np.floor((views[mask] - lo) / (interval / 4)).astype(np.int64)
    same_array("date histogram counts", hc,
               np.bincount(b[b < nb], minlength=nb))
    same_array("date histogram keys", keys,
               lo + np.arange(nb, dtype=np.float64) * (interval / 4))
    if hits != int(mask.sum()):
        raise AssertionError(f"date histogram hits {hits} != {mask.sum()}")
    log(f"  doc values (bulk of {len(ids)}, scan), compute_histogram and "
        f"search_with_date_histogram ({nb} buckets, {hits} hits) equal "
        "numpy over the same documents")

    dg.clear_error()
    missing = str(scratch_dir() / "missing")
    if dg.pcall(dg.open_index_reader, missing) is not None:
        raise AssertionError("pcall on a missing index returned a reader")
    if not dg.last_error().startswith("FileNotFoundError"):
        raise AssertionError(f"last_error: {dg.last_error()!r}")
    log(f"  pcall(open_index_reader, <no commit>) -> None, last_error "
        f"{dg.last_error()!r}")
    dg.clear_error()
    return want


# the port's index validator with JAX and the JAX package made unimportable
_VALIDATE = ("import sys\n"
             "sys.modules['jax'] = sys.modules['diagon_tpu'] = None\n"
             "from diagon_tpu_torch.validate_bundle import validate\n"
             "sys.exit(validate(sys.argv[1], deep=True))\n")


@contextlib.contextmanager
def validating(path):
    """The port's index validator (diagon_tpu_torch/validate_bundle.py,
    --deep; host numpy, about 15 s at 19k docs) runs in its own process
    beside the block, with jax and diagon_tpu unimportable there, and must
    print RESULT: OK; the process never outlives the block."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c", _VALIDATE, path],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
    try:
        yield
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode != 0 or "RESULT: OK" not in out:
        raise AssertionError("validate_bundle: " + out[-2000:] + err[-2000:])
    log(f"  diagon_tpu_torch.validate_bundle --deep: RESULT: OK (its process "
        f"{time.perf_counter() - t0:.1f} s, beside the rest of the phase)")


def tier_counts(searcher):
    tiers = [e["tier"] for e in searcher.tier_stats().values()]
    return tiers.count("device"), tiers.count("host")


def tier_short_budget(reader, full, queries, counts, smi):
    """(b) under a budget of 2.5 x the first segment's estimate: 2 DEVICE
    and 2 HOST; every query through search and count bit-equal to the
    fully resident searcher ``full`` (its calls uncounted); search_batch
    equal to per-query search; dispatch_batch raises MemoryError; the host
    ms of one tier-managed search."""
    from diagon_tpu_torch.search import IndexSearcher, PhraseQuery, TermQuery

    segs = reader.segments_data()
    est = IndexSearcher._estimate_device_bytes(segs[0])
    t = IndexSearcher(reader, device=DEVICE, hbm_budget_bytes=int(est * 2.5))
    if tier_counts(t) != (2, 2):
        raise AssertionError(f"short budget: tiers {t.tier_stats()}")
    t0 = time.perf_counter()
    for q in queries:
        want = counts.uncounted(full.search, q, K)
        if not same_topdocs(t.search(q, K), want):
            raise AssertionError(f"tier-managed search differs for {q!r}")
        if t.count(q) != want.total_hits:
            raise AssertionError(f"tier-managed count differs for {q!r}")
    t_all = time.perf_counter() - t0
    batch = [q for q in queries if not isinstance(q, PhraseQuery)][:16]
    for q, r in zip(batch, t.search_batch(batch, K)):
        if not same_topdocs(r, t.search(q, K)):
            raise AssertionError(f"search_batch != search for {q!r}")
    try:
        t.dispatch_batch(batch, K)
        raise AssertionError("dispatch_batch under the short budget did not "
                             "raise MemoryError")
    except MemoryError:
        pass
    term = next(q for q in queries if isinstance(q, TermQuery))
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        t.search(term, K)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    log(f"  (b) budget 2.5 x {est} B: tiers (device, host) {tier_counts(t)}; "
        f"{len(queries)} queries through search + count bit-equal to the "
        f"resident searcher ({t_all:.2f} s: every call sweeps the four "
        f"segments on and off the card); search_batch == search; "
        f"dispatch_batch raises MemoryError; one tier-managed search "
        f"{statistics.median(times) * 1e3:.3f} ms host (median of 5) [{smi}]")
    return est


def tier_generous_budget(reader, full, queries, est, counts, smi):
    """(b) under 10 x the estimate: all four resident, the batches served on
    the card (dispatch_batch + collect_many) bit-equal to ``full`` (its
    calls uncounted); then per segment the estimate against the
    memory_allocated delta of a promote, and a demote that returns exactly
    that memory."""
    from diagon_tpu_torch.search import IndexSearcher

    g = IndexSearcher(reader, device=DEVICE, hbm_budget_bytes=est * 10)
    if tier_counts(g) != (4, 0):
        raise AssertionError(f"generous budget: tiers {g.tier_stats()}")
    batch = queries[:64]
    res = g.collect_many([g.dispatch_batch(batch, K)])[0]
    for q, r in zip(batch, res):
        if not same_topdocs(r, counts.uncounted(full.search, q, K)):
            raise AssertionError(f"resident batch differs for {q!r}")
    rows = []
    for seg in reader.segments_data():
        def allocated():
            gc.collect()
            torch.cuda.synchronize()
            return torch.cuda.memory_allocated(DEVICE)

        g._tier_demote(seg.name)
        m1 = allocated()
        g._tier_promote(seg.name)
        m2 = allocated()
        g._tier_demote(seg.name)
        m3 = allocated()
        g._tier_promote(seg.name)
        if m2 <= m1 or m3 != m1:
            raise AssertionError(f"{seg.name}: promote {m1} -> {m2} B, "
                                 f"demote back to {m3} B")
        e = IndexSearcher._estimate_device_bytes(seg)
        rows.append(f"{seg.name} est {e} B / measured {m2 - m1} B "
                    f"({(m2 - m1) / e:.2f}x)")
    log(f"  (b) budget 10 x: tiers {tier_counts(g)}; the {len(batch)} "
        f"queries dispatched and collected bit-equal; per segment "
        f"(fields {sorted(g._field_ctx)}), the estimate against the "
        f"memory_allocated delta of a promote, and each demote returned "
        f"exactly that memory: {'; '.join(rows)} [{smi}]")


def api_from_disk(dg, counts, searcher1m, reader1m, smi, s19):
    """(c) phase 5's 1M index reopened through the API: 9 solo queries
    (phase 5's pure-OR set and three booleans) through dg.search and
    dg.count bit-equal to phase 5's searcher; the profiler's report; a
    torch.profiler trace naming B1's kernel; the device health check."""
    from diagon_tpu_torch.bench.queries import frequent_terms, reuters_queries
    from diagon_tpu_torch.observability import QueryProfiler
    from diagon_tpu_torch.observability.health import device_health_check

    path = reader1m.directory.path
    t0 = time.perf_counter()
    r = dg.open_reader(path)
    s = dg.open_searcher(r, device=DEVICE)
    torch.cuda.synchronize()
    t_open = time.perf_counter() - t0
    pool = frequent_terms(searcher1m)
    queries = reuters_queries()
    solos = solo_pure_or(searcher1m, pool, queries["or20"])
    solos["and2:oil+price"] = queries["and2:oil+price"]
    solos["must+should"] = dg.boolean_query(
        must=[dg.term_query("body", pool[0])],
        should=[dg.term_query("body", pool[3]), dg.term_query("body", pool[7])])
    solos["must_not"] = must_not_batch(pool, 1)[0]
    times = {}
    for name, q in solos.items():
        t0 = time.perf_counter()
        hits = dg.search(s, q, K)
        times[name] = (time.perf_counter() - t0) * 1e3
        n = dg.count(s, q)
        want = counts.uncounted(searcher1m.search, q, K)
        if (hits != [(sd.doc, sd.score) for sd in want.score_docs]
                or n != counts.uncounted(searcher1m.count, q)):
            raise AssertionError(f"1M through the API: {name} differs from "
                                 f"phase 5's searcher")
    log(f"  (c) the 1M index from disk: open_reader + open_searcher "
        f"{t_open:.2f} s; {len(solos)} solo queries through dg.search and "
        f"dg.count bit-equal to phase 5's searcher; first-call host ms "
        + ", ".join(f"{n} {t:.2f}" for n, t in times.items()) + f" [{smi}]")

    p = QueryProfiler.enable()
    plain = [q for n, q in solos.items() if n != "must_not"][:3]
    for q in plain:
        dg.search(s, q, K)
    rep = p.report()
    QueryProfiler._tls.profiler = QueryProfiler(enabled=False)
    if any(rep.get(ph, {}).get("count") != len(plain)
           for ph in ("plan", "execute", "merge")):
        raise AssertionError(f"QueryProfiler report {rep}")
    log("  QueryProfiler: " + ", ".join(
        f"{ph} x{r['count']} {r['total_us'] / r['count']:.1f} us"
        for ph, r in rep.items()))

    d = scratch_dir()
    or20 = reuters_queries()["or20"]
    with QueryProfiler.trace(str(d), device=DEVICE):
        dg.search(s19, or20, K)
    text = (d / "trace.json").read_text()
    if "row_sum_kernel" not in text:
        raise AssertionError("the trace of an or20 search on the 19k API "
                             "index names no row_sum_kernel (B1)")
    log(f"  QueryProfiler.trace: {len(text) / 2**10:.0f} KiB Chrome trace "
        "of one or20 search on the 19k API index names row_sum_kernel (B1)")
    h = device_health_check(DEVICE)
    if (h.status.value != "healthy"
            or torch.cuda.get_device_name(0) not in h.message):
        raise AssertionError(f"device_health_check: {h}")
    log(f"  device_health_check: {h.status.value}, {h.message}")


def phase_api(counts, smi, searcher1m, reader1m):
    import diagon_tpu_torch.api as dg

    log(f"phase 12: the embedding API (diagon_tpu_torch.api) at {SERVE_DOCS} "
        "docs, tier-managed residency, and the 1M index through the API")
    counts.reset()
    path, views = api_index(dg, smi)
    reader = dg.open_index_reader(path)
    if dg.reader_get_segment_count(reader) != 4:
        raise AssertionError(f"{dg.reader_get_segment_count(reader)} "
                             "segments, not 4")
    searcher = dg.create_index_searcher(reader, device=DEVICE)
    queries = api_queries(dg, searcher)
    with validating(path):
        api_checks(dg, reader, searcher, views, queries, smi)
        est = tier_short_budget(reader, searcher, queries, counts, smi)
        tier_generous_budget(reader, searcher, queries, est, counts, smi)
        api_from_disk(dg, counts, searcher1m, reader1m, smi, searcher)
    launches = counts.read()
    idle = [n for n in ("row_sum", "row_boolean") if launches[n] < 1]
    if idle:
        raise AssertionError(f"phase 12 never launched {idle}")
    log(f"  launches: {launches}")
    del searcher, reader
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 9: the sparse-vector searcher at 1,000,000 docs
# ---------------------------------------------------------------------------


def sparse_corpus(n_docs, vocab=SPARSE_VOCAB, nnz=120, seed=5):
    """benchmarks/sparse_bench.py's SPLADE-like corpus, vectorised: doc i
    keeps the unique ids of its first keep_n[i] of nnz Zipf(1.05) draws
    over ``vocab``, with values U(0.05, 2.05), from the generator stream
    sparse_bench.py's per-doc loop reads (the same vectors). Returns the
    vectors, the generator (its queries come next) and the Zipf weights."""
    from diagon_tpu_torch.sparse import SparseVector

    rng = np.random.Generator(np.random.PCG64(seed))
    probs = 1.0 / np.arange(1, vocab + 1) ** 1.05
    probs /= probs.sum()
    ids = np.searchsorted(np.cumsum(probs),
                          rng.random((n_docs, nnz))).astype(np.int64)
    keep_n = rng.integers(30, nnz, size=n_docs)
    ids[np.arange(nnz)[None, :] >= keep_n[:, None]] = vocab  # dropped slots
    ids.sort(axis=1)
    keep = ids < vocab
    keep[:, 1:] &= ids[:, 1:] != ids[:, :-1]
    starts = np.zeros(n_docs + 1, np.int64)
    np.cumsum(keep.sum(axis=1), out=starts[1:])
    ids = ids[keep]
    del keep
    vals = rng.random(len(ids)).astype(np.float32) * 2 + 0.05
    vecs = [SparseVector(ids[a:b], vals[a:b])
            for a, b in zip(starts[:-1], starts[1:])]
    return vecs, rng, probs


def sparse_queries(rng, probs, n, vocab=SPARSE_VOCAB):
    """sparse_bench.py:96-100: 8-23 Zipf draws a query, unique, weights
    U(0, 1)."""
    from diagon_tpu_torch.sparse import SparseVector

    out = []
    for _ in range(n):
        k = int(rng.integers(8, 24))
        ids = np.unique(rng.choice(vocab, size=k, p=probs))
        out.append(SparseVector(ids, rng.random(len(ids)).astype(np.float32)))
    return out


def same_triple(got, want):
    """(scores, docids, hits) equal: f32 bits, docids, hits."""
    return (int(got[2]) == int(want[2])
            and np.array_equal(np.asarray(got[1]), np.asarray(want[1]))
            and np.array_equal(np.asarray(got[0], np.float32).view(np.uint32),
                               np.asarray(want[0], np.float32).view(np.uint32)))


def phase_sparse(counts, smi):
    """The sparse searcher on sparse_bench.py's corpus at 1M docs (MS
    MARCO's 8.8M passages cut to 1M for the time limit): the solo search
    (the tile-UB route, B1 on escalation), search_batch of 256 queries (the
    pruned route: every clause a light row) and search_rerank_batch,
    counted; then, uncounted,
    search_oracle bit-equality and search_rerank == search_exact on a
    sample of 8, pruned == exhaustive over the whole batch, served qps and
    a torch.profiler pass over each route."""
    from diagon_tpu_torch.sparse import SparseIndex, SparseSearcher

    log(f"phase 9: sparse vectors at {SPARSE_DOCS} docs")
    t0 = time.perf_counter()
    vecs, rng, probs = sparse_corpus(SPARSE_DOCS)
    t_corpus = time.perf_counter() - t0
    nnz = sum(len(v) for v in vecs)
    t0 = time.perf_counter()
    index = SparseIndex.build(vecs)
    t_build = time.perf_counter() - t0
    del vecs
    t0 = time.perf_counter()
    s = SparseSearcher(index, device=DEVICE)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    pp = index.segment.fields["_sparse"].postings
    log(f"  corpus {t_corpus:.2f} s ({nnz} postings), index build "
        f"{t_build:.2f} s ({pp.num_terms} terms, {pp.num_blocks} blocks), "
        f"searcher {t_load:.2f} s [{smi}]")
    qs = sparse_queries(rng, probs, 256)
    ex = s.executor
    sample = list(range(0, 256, 32))

    counts.reset()
    m0 = {n: c.value() for n, c in ex.metrics.items()}
    solo = s.search(qs[0], K)
    dsolo = {n: c.value() - m0[n] for n, c in ex.metrics.items()}
    if dsolo["pruned"] != 1:
        raise AssertionError("1M sparse solo: not on the tile-UB route")
    before = counts.read()
    m0 = {n: c.value() for n, c in ex.metrics.items()}
    t0 = time.perf_counter()
    res = s.search_batch(qs, K)
    first = time.perf_counter() - t0
    dm = {n: c.value() - m0[n] for n, c in ex.metrics.items()}
    counts.require(before, SPARSE_NEED, "1M sparse 256")
    if dm["pruned"] < 1:
        raise AssertionError("1M sparse 256: search.pruned_dispatches did "
                             "not move")
    batch_launches = {n: v - before[n] for n, v in counts.read().items()
                      if v > before[n]}
    m1 = {n: c.value() for n, c in ex.metrics.items()}
    t0 = time.perf_counter()
    rr = s.search_rerank_batch(qs, K)
    t_rr = time.perf_counter() - t0
    drr = {n: c.value() - m1[n] for n, c in ex.metrics.items()}
    launches = counts.read()

    def checks():
        if not same_triple(solo, s.search_oracle(qs[0], K)):
            raise AssertionError("1M sparse solo != search_oracle")
        for i in sample:
            if not same_triple(res[i], s.search_oracle(qs[i], K)):
                raise AssertionError(f"1M sparse 256 query {i} != "
                                     "search_oracle")
            want = s.search_exact(qs[i], K)
            if not same_triple(s.search_rerank(qs[i], K), want):
                raise AssertionError(f"search_rerank {i} != search_exact")
            if not same_triple(rr[i], want):
                raise AssertionError(f"search_rerank_batch {i} != "
                                     "search_exact")

    t0 = time.perf_counter()
    counts.uncounted(checks)
    log(f"  solo and {len(sample)} sampled batch queries bit-equal to "
        f"search_oracle; search_rerank and search_rerank_batch == "
        f"search_exact on them ({time.perf_counter() - t0:.1f} s)")
    plans = [p for p in s._plan_batch(qs) if p is not None]
    pruned_equals_exhaustive(ex, counts, plans, "1M sparse 256", True)
    solo_plan = [s._plan(qs[0])]
    if ex._batch_mode(solo_plan):
        raise AssertionError("1M sparse solo: routed as a batch")
    pruned_equals_exhaustive(ex, counts, solo_plan, "1M sparse solo", True)
    log(f"  1M sparse solo: the tile-UB route, escalations "
        f"{dsolo['escalations']} (onto B1)")

    def served(n):
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            s.collect_batch(s.dispatch_batch(qs, K))
            times.append(time.perf_counter() - t0)
        return statistics.median(times)

    t = counts.uncounted(served, 3)
    log(f"  1M sparse 256: first {first * 1e3:.3f} ms (entry builds "
        f"included), then {t * 1e3:.3f} ms/batch -> {256 / t:.1f} qps "
        f"[{smi}]; pruned dispatches {dm['pruned']}, partitions "
        f"{dm['partitions']}, exhaustive dispatches {dm['exhaustive']}, "
        f"escalations {dm['escalations']}; launched {batch_launches}")
    log(f"  1M sparse search_rerank_batch (R 1024): {t_rr * 1e3:.3f} ms, "
        f"escalations {drr['escalations']}, pruned dispatches "
        f"{drr['pruned']} [{smi}]")
    for route in ("pruned", "exhaustive"):
        counts.uncounted(profile_route, ex, plans, "1M sparse 256", route,
                         smi, counts, 2)
    return launches


# ---------------------------------------------------------------------------
# Phase 10: the columnar device engine, kernel X1
# ---------------------------------------------------------------------------


def range_mask(table, kw):
    """The numpy int64 / f64 scan of a query's filter: bool [rows]."""
    v = table.columns[kw["filter_col"]].values
    m = np.ones(len(v), bool)
    if kw.get("lower") is not None:
        m &= v >= kw["lower"]
    if kw.get("upper") is not None:
        m &= v <= kw["upper"]
    return m


def kept_granules(table, kw):
    """The granules the filter's minmax keeps, from the host index."""
    mm = table.minmax[kw["filter_col"]]
    keep = np.ones(len(mm.mins), bool)
    if kw.get("lower") is not None:
        keep &= mm.maxs >= kw["lower"]
    if kw.get("upper") is not None:
        keep &= mm.mins <= kw["upper"]
    return int(keep.sum())


def check_range_result(table, kw, res, what):
    """count exact against the numpy scan; min and max exact (the int
    columns here are below 2^24; a float column's values are its f32
    plane's); the sum within relative 1e-6 of the exact int64 sum, or 1e-5
    of the f64 sum of the f32 values; granules_scanned the minmax count
    (device route). The host BULK path is exact throughout."""
    m = range_mask(table, kw)
    av = table.columns[kw.get("agg_col") or kw["filter_col"]].values[m]
    host = res.get("host_fast_path", False)
    if res["count"] != int(m.sum()):
        raise AssertionError(f"{what}: count {res['count']} != {int(m.sum())}")
    if not len(av):
        return
    if av.dtype.kind == "i":
        want = (float(av.sum(dtype=np.int64)), float(av.min()),
                float(av.max()), 1e-6)
    elif host:
        want = (float(av.sum(dtype=np.float64)), float(av.min()),
                float(av.max()), 1e-12)
    else:
        f = av.astype(np.float32)
        want = (float(f.sum(dtype=np.float64)), float(f.min()),
                float(f.max()), 1e-5)
    s, mn, mx, tol = want
    if host:
        tol = 0.0 if av.dtype.kind == "i" else tol
    if (res["min"], res["max"]) != (mn, mx) or abs(res["sum"] - s) > tol * abs(s):
        raise AssertionError(f"{what}: {res} against sum {s}, min {mn}, "
                             f"max {mx}")
    if not host and res["granules_scanned"] != kept_granules(table, kw):
        raise AssertionError(f"{what}: granules_scanned "
                             f"{res['granules_scanned']}")


def minmax_bytes(dt, filter_col):
    """Bytes of a filter column's granule minmax planes (min and max, three
    i32 planes each for an int column, one f32 plane for a float one)."""
    return 2 * dt.num_granules * 4 * len(dt.planes[filter_col])


def x1_bound(dt, kw, scanned, groups):
    """(bound_ms, bound_by) of one X1 call: the planes it must read over
    the scanned granules (filter, aggregate when another column, valid,
    the group plane), the filter's granule minmax planes once and its
    outputs, over HBM_BYTES_PER_S; and X1_OPS_PER_ROW int operations a
    scanned row at RATES["logic"]. The kernel's own re-reads of the minmax
    planes (every block tests every granule; ``minmax_bytes`` x grid - 1,
    from the L2) are its design's overhead, not the function's work, and
    are logged beside the bound, not counted in it."""
    f = kw["filter_col"]
    a = kw.get("agg_col") or f
    per_row = 4 * len(dt.planes[f]) + 1 + (4 if groups else 0)
    if a != f:
        per_row += 4 * len(dt.planes[a])
    rows = scanned * dt.granule_rows
    byts = rows * per_row + minmax_bytes(dt, f) + 24 + 8 * groups
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = rows * X1_OPS_PER_ROW / RATES["logic"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def x1_equals_plain(got, want, agg_is_int, what):
    """Counts, min, max and granules bit for bit; the sum bit for bit for
    an int aggregate (exact int64 totals, the same f32 expression), within
    relative 1e-5 for a float one (f64 sums in two orders); group counts
    exact, group sums within relative 1e-5. A NaN lane or group sum equals
    only a NaN (both NaN, whatever their payloads: jnp.min fixes none)."""
    if isinstance(got, tuple):
        (got, (gc, gs)), (want, (wc, ws)) = got, want
        if not torch.equal(gc, wc):
            raise AssertionError(f"{what}: X1 group counts != plain")
        if not torch.allclose(gs.double(), ws.double(), rtol=1e-5, atol=0,
                              equal_nan=True):
            raise AssertionError(f"{what}: X1 group sums != plain")
    g, w = got.cpu(), want.cpu()
    both_nan = g.isnan() & w.isnan()
    gb = torch.where(both_nan, 0, g.view(torch.int32))
    wb = torch.where(both_nan, 0, w.view(torch.int32))
    lanes = [0, 1, 3, 4, 5] + ([2] if agg_is_int else [])
    if not torch.equal(gb[lanes], wb[lanes]) or (
            not agg_is_int and not both_nan[2]
            and not abs(float(g[2]) - float(w[2])) <= 1e-5 * abs(float(w[2]))):
        raise AssertionError(f"{what}: X1 {g.tolist()} != plain {w.tolist()}")
    return max_abs_err(torch.where(both_nan, 0, g), torch.where(both_nan, 0, w))


def chained_us(dt, kw, n=32, iters=5):
    """columnar_bench.py's device time: n chained dispatch_range_agg calls
    and one sync, per call, the least of ``iters`` chains (us)."""
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fused = dt.dispatch_range_agg(**kw)
        fused[0].item()
        times.append((time.perf_counter() - t0) / n)
    return min(times) * 1e6


def no_sync_chain(dt, kw, n=32):
    """n chained dispatch_range_agg calls enqueued behind a device sleep,
    under torch's sync debug mode "error": none may synchronise (the mode
    raises), and the host must enqueue all n while the sleep still runs
    (no call waited for the card). Returns the host us a call."""
    torch.cuda.synchronize()
    torch.cuda._sleep(1 << 26)  # about 34 ms at 2 GHz
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        outs = [dt.dispatch_range_agg(**kw) for _ in range(n)]
        host = time.perf_counter() - t0
        pending = not torch.cuda.current_stream().query()
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    torch.cuda.synchronize()
    if not pending:
        raise AssertionError(f"the card went idle before the host had "
                             f"enqueued {n} dispatches: a call waited")
    if not all(torch.equal(o, outs[0]) for o in outs):
        raise AssertionError("chained dispatches disagree")
    return host / n * 1e6


def gneg_column(rows):
    """GNEG_QUERY's group column: ids in [-4200, 4095] (seed 12)."""
    from diagon_tpu_torch.columnar import Int64Column

    return Int64Column(np.random.default_rng(12).integers(-4200, 4096, rows))


def jax_group_slots(ids, num_groups):
    """The JAX group block's index rule (a scatter into num_groups + 1
    slots, mode "drop", the last cut off) in numpy: -1 where a row adds to
    no group."""
    n = num_groups
    ids = np.where((ids >= -(n + 1)) & (ids <= -2), ids + n + 1, ids)
    return np.where((ids >= 0) & (ids < n), ids, -1)


def check_group_result(table, kw, grp, what):
    """Group counts exact and group sums within relative 1e-5 of the numpy
    scan (f32 values summed in f64), ids mapped as the JAX program maps
    them."""
    m = range_mask(table, kw)
    ng = kw["num_groups"]
    ids = jax_group_slots(table.columns[kw["group_col"]].values[m], ng)
    dur = table.columns[kw["agg_col"]].values[m].astype(np.float32)
    keep = ids >= 0
    if not np.array_equal(grp["group_counts"].astype(np.int64),
                          np.bincount(ids[keep], minlength=ng)):
        raise AssertionError(f"{what}: group counts != numpy")
    want = np.bincount(ids[keep], weights=dur[keep].astype(np.float64),
                       minlength=ng)
    if not np.allclose(grp["group_sums"], want, rtol=1e-5, atol=0):
        raise AssertionError(f"{what}: group sums != numpy")


def x1_device_work(calls, reps=2):
    """The device work of X1 calls under torch.profiler: each call of
    ``calls`` run ``reps`` times, then {device row name: count}. The launch
    plans must exist already (a plan's first call allocates its scratch
    zeroed, a fill kernel)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for call in calls:
                call()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def one_launch_a_call(calls, tag):
    """Each X1 call is one device kernel and no memset: torch.profiler must
    record exactly one range_agg_kernel row a call and no other row."""
    work = x1_device_work(calls)
    if not work:  # the profiler recorded no device row: ask once more
        work = x1_device_work(calls)
    n = 2 * len(calls)
    kern = sum(c for k, c in work.items() if "range_agg_kernel" in k)
    other = {k: c for k, c in work.items() if "range_agg_kernel" not in k}
    if kern != n or other:
        raise AssertionError(f"{tag}: {n} X1 calls ran {kern} X1 kernels "
                             f"and {other} (memsets included) on the card")
    log(f"  {tag}: {n} X1 calls, {kern} device kernels, no memset and no "
        f"other device work (torch.profiler)")


def x1_args(dt, kw):
    """A query (``group_col`` and ``num_groups`` for a group-by) as X1's
    arguments through ``dt``'s planes: (the query without its group keys,
    the planes and bounds, the group plane and offset or (), the flags)."""
    q = {k: v for k, v in kw.items() if k not in ("group_col", "num_groups")}
    args, flags = dt._args(q["filter_col"], q.get("lower"), q.get("upper"),
                           q.get("agg_col"))
    extra = ()
    if "group_col" in kw:
        extra = (dt.planes[kw["group_col"]][0], dt.offsets[kw["group_col"]])
        flags = dict(flags, num_groups=kw["num_groups"])
    return q, args, extra, flags


def x1_wide_shapes(ra, table, dt, smi):
    """X1 against its plain version, bit for bit as x1_equals_plain holds
    it, on the two paths the bench's shapes do not reach: more granules
    than one compaction window (``table`` re-cut into granules of 256
    rows: 3,907 at 1M, a counting pass and two windows) under the six
    queries and the group-bys, and more groups than the shared table holds
    (GNEG_QUERY over 6,000 groups: global adds, ids -2..-4200 wrapped) on
    that table and on ``dt``."""
    from diagon_tpu_torch.bench.columnar import GROUP_QUERY, QUERIES
    from diagon_tpu_torch.columnar import ColumnarTable, DeviceTable

    fine = ColumnarTable(granule_rows=256)
    for name, col in table.columns.items():
        fine.add_column(name, col, minmax=name in table.minmax)
    dt256 = DeviceTable(fine, device=DEVICE)
    wide = dict(GNEG_QUERY, num_groups=6000)
    if dt256.num_granules <= X1_WINDOW or wide["num_groups"] <= X1_SMEM_GROUPS:
        raise AssertionError("x1_wide_shapes: the shapes miss the windowed "
                             "compaction or the global group adds")
    specs = list(QUERIES.items()) + [("group region", GROUP_QUERY),
                                     ("group gneg", GNEG_QUERY),
                                     ("group gneg 6000", wide)]
    for d, names in ((dt256, specs), (dt, specs[-1:])):
        res = x1_check_specs(ra, d, names, f"{d.num_granules} granules")
        seen = [f"{name} {scanned(got)}" for name, (got, _) in res.items()]
        log(f"  X1 at {d.num_granules} granules of {d.granule_rows} rows "
            f"equals its plain version bit for bit (granules scanned: "
            f"{', '.join(seen)}) [{smi}]")
    del dt256, fine
    x1_nan_and_odd_granules(ra, table, smi)


def scanned(result):
    """The granules an X1 result says it scanned (a group-by's fused
    vector is its first element)."""
    return int((result[0] if isinstance(result, tuple) else result)[5])


def x1_check_specs(ra, d, specs, what):
    """X1 on ``d`` against its plain version for each (name, query) of
    ``specs`` (x1_equals_plain); returns {name: (X1's result, plain's)}."""
    out = {}
    for name, kw in specs:
        _, args, extra, flags = x1_args(d, kw)
        got = (d.dispatch_range_group_agg(**kw) if extra
               else d.dispatch_range_agg(**kw))
        want = ra.range_agg_reference(*args, *extra, **flags)
        x1_equals_plain(got, want, flags["agg_is_int"], f"{what} {name}")
        out[name] = (got, want)
    return out


def x1_nan_and_odd_granules(ra, table, smi):
    """X1 against its plain version where the JAX program's answers once
    differed from the kernel's (uncounted):

    - NaN rows in a float column (``duration`` with a NaN every 99,991st
      row): as the aggregate (min, max and sum NaN, as jnp.min, jnp.max and
      the f64 sums make them, pruned and full), as the filter (a NaN fails
      the range; a granule whose minmax is NaN is skipped), with its minmax
      from the table and from the planes, and in a group-by's sums;
    - granule sizes that are not a multiple of 4: the 1M table re-cut
      into granules of 1,001 rows, and its first 200,000 rows into
      granules of 10 (20,000 granules, past one compaction window), under
      columnar_bench's six queries and its group-by (``DeviceTable`` pads
      each granule's planes to a multiple of 4 rows with ``valid``
      False)."""
    from diagon_tpu_torch.bench.columnar import GROUP_QUERY, QUERIES
    from diagon_tpu_torch.columnar import (
        ColumnarTable,
        DeviceTable,
        Float64Column,
    )

    ts = table.columns["event_ts"].values
    dur = table.columns["duration"].values.copy()
    nan_rows = np.arange(0, len(dur), 99_991)
    dur[nan_rows] = np.nan
    nt = ColumnarTable(granule_rows=table.granule_rows)
    nt.add_column("event_ts", table.columns["event_ts"])
    nt.add_column("region", table.columns["region"])
    nt.add_column("dur_nan", Float64Column(dur))
    nt.add_column("dur_nan_planes", Float64Column(dur), minmax=False)
    r = int(nan_rows[len(nan_rows) // 2])
    specs = [
        ("NaN agg, full", dict(filter_col="event_ts", lower=0,
                               upper=1 << 22, agg_col="dur_nan")),
        ("NaN agg, pruned", dict(filter_col="event_ts", lower=int(ts[r]) - 5,
                                 upper=int(ts[r]) + 5, agg_col="dur_nan")),
        ("NaN filter", dict(filter_col="dur_nan", lower=100.0, upper=400.0,
                            agg_col="region")),
        ("NaN filter, minmax from planes",
         dict(filter_col="dur_nan_planes", lower=100.0, upper=400.0,
              agg_col="region")),
        ("NaN filter and agg", dict(filter_col="dur_nan", agg_col="dur_nan")),
        ("NaN group sums", dict(GROUP_QUERY, agg_col="dur_nan")),
    ]
    res = x1_check_specs(ra, DeviceTable(nt, device=DEVICE), specs,
                         "NaN table")
    for name in ("NaN agg, full", "NaN agg, pruned"):
        got = res[name][0].cpu()
        if not bool(got[3:5].isnan().all()):
            raise AssertionError(f"{name}: min and max are not NaN: "
                                 f"{got.tolist()}")
    log(f"  X1 on a float column with {len(nan_rows)} NaN rows equals its "
        f"plain version, NaN as NaN (aggregate full and pruned, filter with "
        f"minmax from the table and from the planes, group sums) [{smi}]")

    specs = list(QUERIES.items()) + [("group region", GROUP_QUERY)]
    for gr, rows in ((1001, len(ts)), (10, 200_000)):
        cut = ColumnarTable(granule_rows=gr)
        for name, col in table.columns.items():
            if name != "gneg":
                cut.add_column(name, type(col)(col.values[:rows]),
                               minmax=name in table.minmax)
        d = DeviceTable(cut, device=DEVICE)
        if d.width % 4 or d.width == gr:
            raise AssertionError(f"granules of {gr} rows: width {d.width}")
        res = x1_check_specs(ra, d, specs, f"{gr}-row granules")
        log(f"  X1 at {d.num_granules} granules of {gr} rows (planes "
            f"{d.width} wide) equals its plain version on the six queries "
            f"and the group-by (granules scanned "
            f"{[scanned(got) for got, _ in res.values()]}) [{smi}]")


def table_from_disk(table, smi):
    """``table`` through the columnar host I/O: write_table (the default
    chain) into a temporary FSDirectory, then read_table with
    verify_checksums; every column, the minmax and the bloom indexes
    checked equal to the built table's. Returns the loaded table."""
    from diagon_tpu_torch.columnar import read_table, write_table
    from diagon_tpu_torch.columnar.store import DEFAULT_CHAIN
    from diagon_tpu_torch.store import FSDirectory

    d = FSDirectory(scratch_dir())
    t0 = time.perf_counter()
    fname = write_table(d, "columnar", table)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = read_table(d, "columnar", verify_checksums=True)
    t_read = time.perf_counter() - t0
    if (loaded.num_rows, loaded.granule_rows, list(loaded.columns)) != (
            table.num_rows, table.granule_rows, list(table.columns)):
        raise AssertionError("the loaded table's shape or columns differ")
    for name, col in table.columns.items():
        got = loaded.columns[name]
        if type(got) is not type(col):
            raise AssertionError(f"{name}: {type(got)} != {type(col)}")
        if hasattr(col, "values"):
            same_array(f"column {name}", got.values, col.values)
        else:
            same_array(f"column {name} offsets", got.offsets, col.offsets)
            same_array(f"column {name} chars", got.chars, col.chars)
    for kind in ("minmax", "bloom"):
        want, got = getattr(table, kind), getattr(loaded, kind)
        if set(got) != set(want):
            raise AssertionError(f"{kind}: {sorted(got)} != {sorted(want)}")
        for name, idx in want.items():
            for f in dataclasses.fields(idx):
                same_array(f"{kind} {name} {f.name}",
                           getattr(got[name], f.name), getattr(idx, f.name))
    log(f"  table on disk: write_table ({'+'.join(DEFAULT_CHAIN)}) "
        f"{t_write:.2f} s, {d.file_length(fname) / 2**20:.1f} MiB; read_table "
        f"(verify_checksums) {t_read:.2f} s; every column and the minmax and "
        f"bloom indexes equal the built table's [{smi}]")
    return loaded


def phase_columnar(ra, counts, smi):
    """columnar_bench.py's table (its columns, distributions and seed 11)
    at 1,000,000 rows and at 10,000,000 (ClickBench's ~100M-row hits table
    cut for the time limit), through DeviceTable on the card, with one
    more column: GNEG_QUERY's group ids, below zero for part of the rows.
    Counted as main path: each of columnar_bench's six queries through
    range_agg with host_fast False (X1) and True (the metadata BULK path
    where it applies), the bench's range_group_agg (region, 4096 groups,
    agg duration) and GNEG_QUERY's; results against the numpy scan (counts
    exact, group ids mapped as the JAX program maps them). Uncounted: X1
    against its plain version on every query and both group queries,
    through the table's cached launch plans and once through a bare
    ``range_agg`` call; at 1M, under torch.profiler, one device kernel and
    no memset a call, and ``x1_wide_shapes`` (over 2,048 granules, over
    4,096 groups); 32 chained dispatch_range_agg calls with no host
    sync; per query its branch (pruned: the kept granules <= cap; the
    kernel scans the kept granules either way), the grid, chained us (the
    bench's columnar_q9_device_us method), kernel-only us (queued behind a
    device sleep), one-call and plain ms, the bound and the host path's
    us. Returns the main path's launches, the largest X1 - plain
    difference and X1's record at the 10M q9_region_range (the bench's
    headline)."""
    from diagon_tpu_torch.bench.columnar import (
        GROUP_QUERY,
        QUERIES,
        build_table,
    )
    from diagon_tpu_torch.columnar import DeviceTable

    log("phase 10: columnar range aggregates (X1)")
    launches, err, record = 0, 0.0, None
    groups = {"group region": GROUP_QUERY, "group gneg": GNEG_QUERY}
    for rows in COLUMNAR_ROWS:
        tag = f"{rows // 1_000_000}M"
        t0 = time.perf_counter()
        table = build_table(rows)
        table.add_column("gneg", gneg_column(rows))
        t_build = time.perf_counter() - t0
        # the 1M table is served as read back from disk; the 10M one stays
        # in memory (the time limit)
        served = table_from_disk(table, smi) if rows == COLUMNAR_ROWS[0] \
            else table
        t0 = time.perf_counter()
        dt = DeviceTable(served, device=DEVICE)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        on_card = sum(nbytes(*p) for p in dt.planes.values()) + nbytes(
            dt.valid)
        log(f"  {tag} rows: table build {t_build:.2f} s, DeviceTable "
            f"{t_load:.2f} s, {on_card / 2**20:.1f} MiB of planes on the "
            f"card, {dt.num_granules} granules, cap {dt.cap} [{smi}]")
        counts.reset()
        before = counts.read()["range_agg"]
        results = {name: (dt.range_agg(**kw, host_fast=False),
                          dt.range_agg(**kw))
                   for name, kw in QUERIES.items()}
        grp = {name: dt.range_group_agg(**kw) for name, kw in groups.items()}
        n = counts.read()["range_agg"] - before
        if n < 1:
            raise AssertionError(f"{tag} columnar: X1 never launched")
        launches += n
        for name, kw in QUERIES.items():
            dev, fast = results[name]
            check_range_result(table, kw, dev, f"{tag} {name} device")
            check_range_result(table, kw, fast, f"{tag} {name} host_fast")
        for name, kw in groups.items():
            check_group_result(table, kw, grp[name], f"{tag} {name}")
        log(f"  {tag}: six queries (host_fast False and True) and the "
            f"group-bys ({grp['group region']['count']} rows, "
            f"{grp['group region']['granules_scanned']} granules; ids below "
            f"zero wrapped as the JAX program does) equal the numpy scan; "
            f"{n} X1 launches")

        specs = list(QUERIES.items()) + list(groups.items())
        calls = {}
        for name, kw in specs:
            if name in groups:
                calls[name] = (lambda kw=kw: dt.dispatch_range_group_agg(**kw))
            else:
                calls[name] = (lambda kw=kw: dt.dispatch_range_agg(**kw))
        if served is not table:
            counts.uncounted(same_as_built, dt, table, calls, specs, groups,
                             tag, smi)
        if rows == COLUMNAR_ROWS[0]:
            counts.uncounted(one_launch_a_call, list(calls.values()), tag)
        for name, kw in specs:
            q, args, extra, flags = x1_args(dt, kw)
            ng = flags.get("num_groups", 0)
            call = calls[name]
            got = counts.uncounted(call)
            want = ra.range_agg_reference(*args, *extra, **flags)
            err = max(err, x1_equals_plain(got, want, flags["agg_is_int"],
                                           f"{tag} {name}"))
            if name in ("q9_region_range", "group region"):  # a bare call
                bare = counts.uncounted(
                    lambda: ra.range_agg(*args, *extra, **flags))
                x1_equals_plain(bare, want, flags["agg_is_int"],
                                f"{tag} {name} bare range_agg")
            kept = scanned(got)
            branch = "pruned" if kept <= dt.cap else "full"
            grid = dt._plan(q["filter_col"], q.get("agg_col"),
                            kw.get("group_col"), ng)[1].grid
            ms = counts.uncounted(cuda_ms, call)
            kern = counts.uncounted(queued_ms, call, 32)
            plain = cuda_ms(lambda: ra.range_agg_reference(
                *args, *extra, **flags), reps=5, warmup=1)
            b_ms, b_by = x1_bound(dt, q, kept, ng)
            reread = (grid - 1) * minmax_bytes(dt, q["filter_col"])
            line = (f"  {tag} {name}: {branch} ({kept}/{dt.num_granules}"
                    f" granules), grid {grid}; one call {ms * 1e3:.1f} us, "
                    f"kernel only {kern * 1e3:.1f} us, plain "
                    f"{plain * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us by "
                    f"{b_by}; overhead beyond the bound: minmax re-read "
                    f"{reread / 1e6:.2f} MB by the other blocks, "
                    f"{reread / HBM_BYTES_PER_S * 1e6:.2f} us at the HBM "
                    f"rate (the L2 serves them)")
            if not extra:
                line += (f"; chained {counts.uncounted(chained_us, dt, q):.1f}"
                         " us a query (32 dispatches, one sync)")
                if results[name][1].get("host_fast_path"):
                    t0 = time.perf_counter()
                    for _ in range(200):
                        dt.range_agg(**q)
                    line += (f"; host BULK path "
                             f"{(time.perf_counter() - t0) / 200 * 1e6:.1f} us")
            log(line + f" [{smi}]")
            if rows == COLUMNAR_ROWS[-1] and name == "q9_region_range":
                record = {"ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                          "bound_by": b_by, "library_ms": None}
        if rows == COLUMNAR_ROWS[0]:
            counts.uncounted(x1_wide_shapes, ra, table, dt, smi)
        host_us = counts.uncounted(no_sync_chain, dt, QUERIES["wide_ts_agg"])
        log(f"  {tag}: 32 chained dispatch_range_agg calls, no host sync "
            f"(sync debug mode 'error'; all enqueued behind a device sleep), "
            f"{host_us:.1f} us of host a call")
        del dt, table, served, results, grp, calls
    return launches, err, record


def same_as_built(dt, table, calls, specs, groups, tag, smi):
    """Each query's X1 result on ``dt`` (a table read back from disk)
    bit-equal to the same call on a DeviceTable of the built ``table``."""
    from diagon_tpu_torch.columnar import DeviceTable

    built = DeviceTable(table, device=DEVICE)
    for name, kw in specs:
        want = (built.dispatch_range_group_agg(**kw) if name in groups
                else built.dispatch_range_agg(**kw))
        if not bits_equal(calls[name](), want):
            raise AssertionError(f"{tag} {name}: the table read from disk "
                                 "answers otherwise than the built one")
    log(f"  {tag}: the table read from disk answers every query bit-equal "
        f"to the built table [{smi}]")


# ---------------------------------------------------------------------------
# Phase 8: scale at 10,000,000 docs, on-demand banks, phase 1 and phase 0
# ---------------------------------------------------------------------------


def fresh_entries(ex, phase0):
    """Route ``ex``'s on-demand batches through phase 0 or phase 1. A cached
    entry keeps the phase it was built for, so the cache is emptied."""
    ex.use_phase0 = phase0
    ex._batch_cache.clear()
    ex._batch_bytes = 0
    ex._demand_args_cache.clear()


def family_samples(batch):
    """Indices of the first term, AND and MUST + SHOULD queries of a mixed
    batch (the oracle decodes every posting block of a query's terms in
    Python, seconds per frequent term at 10M docs)."""
    from diagon_tpu_torch.search.query import BooleanQuery, Occur, TermQuery

    def family(q):
        if isinstance(q, TermQuery):
            return "term"
        occurs = {c.occur for c in q.clauses} if isinstance(q, BooleanQuery) else set()
        if occurs == {Occur.MUST}:
            return "and"
        if occurs == {Occur.MUST, Occur.SHOULD}:
            return "bool"
        return None

    first = {}
    for i, q in enumerate(batch):
        first.setdefault(family(q), i)
    return [first[f] for f in ("term", "and", "bool")]


def phase_scale10(counts, smi):
    """bench.py's 10M tier (benchmarks/scale_bench.py): or20 x 1024, then
    mixed 1024 over the 32 most frequent terms, query_cache off, through
    dispatch_batch + collect_many on both on-demand routes: (a) phase 1
    (B3/B5, then B6/B7), (b) use_phase0 (phase 0 and B8, then B6/B7).
    Returns the launches of each route and, for phase 6, the kernels' own
    tensors there: B8's phase-0 arguments, B3's and B5's phase-1 entries
    (with their f32 rows), B6's at the pure-OR subset's phase-1 entry, and
    B2's arguments for the queries the mixed batch escalates."""
    from diagon_tpu_torch.bench.queries import (
        frequent_terms,
        mixed_query_batch,
        reuters_queries,
    )

    log(f"phase 8: scale at {SCALE10_DOCS} docs, on-demand banks")
    seg, searcher, t_build, t_load = load_searcher(SCALE10_DOCS,
                                                   query_cache=False)
    ex = searcher._ctx("body").row_executors[0]
    if not ex.index.bank_on_demand or ex.index.heavy_bank is not None:
        raise AssertionError("10M segment is not in on-demand mode")
    oracle = Oracle(seg)
    mixed = mixed_query_batch(frequent_terms(searcher, "body", 32), 1024,
                              phrase_share=0)
    or20 = [reuters_queries()["or20"]] * 1024
    cells = (("10M or20 x 1024", or20, [0]),
             ("10M mixed 1024", mixed, family_samples(mixed)))
    need = {
        "phase1": {"10M or20 x 1024": ["approx_select", "gather_rescore"],
                   "10M mixed 1024": ["approx_select", "approx_select_bool2",
                                      "gather_rescore", "union_rescore"]},
        "phase0": {"10M or20 x 1024": ["bits_hits", "gather_rescore"],
                   "10M mixed 1024": ["bits_hits", "gather_rescore",
                                      "union_rescore"]},
    }
    launches, plans, exhaustive = {}, {}, {}
    for route in ("phase1", "phase0"):
        log(f"  route {route}:")
        fresh_entries(ex, route == "phase0")
        counts.reset()
        for label, batch, sample in cells:
            # a phase-0 batch takes seconds: its first batch is its time
            plans[label], dm = serve_batch(searcher, oracle, counts, batch,
                                           f"{label} {route}", sample,
                                           need[route][label], smi,
                                           reps=2 if route == "phase1" else 0)
            if dm["pruned"] < 1 or dm["phase0_ineligible"]:
                raise AssertionError(f"{label} {route}: not on the route")
        launches[route] = counts.read()
        log(f"  {route} launches {launches[route]}")
        p1 = ("approx_select", "approx_select_bool", "approx_select_bool2")
        wrong = (["bits_hits"] if route == "phase1" else list(p1))
        if any(launches[route][n] for n in wrong):
            raise AssertionError(f"route {route} launched {wrong}")
        if route == "phase1":
            check_replay(ex, counts, plans["10M mixed 1024"])
            # B3's and B5's own tensors at the phase-1 entries of the mixed
            # batch's two subsets, and B2's for the queries it escalates
            args, rows = counts.uncounted(main_path_args, ex,
                                          plans["10M mixed 1024"])
            at10m = {n: (args[n], rows[n])
                     for n in ("approx_select", "approx_select_bool2")}
            at10m["gather_rescore"] = args["gather_rescore"]
            del args, rows
            at10m["row_boolean"] = counts.uncounted(
                escalation_args, ex, plans["10M mixed 1024"])
        for label, _, _ in cells:
            exhaustive[label] = pruned_equals_exhaustive(
                ex, counts, plans[label], f"{label} {route}", True,
                exhaustive.get(label))
    # phase 0's own B8 arguments for phase 6: the pure-OR subset's entry
    split = ex._purity_split(plans["10M mixed 1024"])
    c = ex._compact(split[0])
    at10m["bits_hits"] = (c.bits, c.cidx, c.cflags, c.qmode)
    # one profiled batch per route: a phase-0 batch escalates most of its
    # queries onto B1/B2 and takes seconds (profiled last: the phase-1
    # profile taken after it had no row for B3, which every phase-1 batch
    # launches)
    for route in ("phase1", "phase0"):
        fresh_entries(ex, route == "phase0")
        counts.uncounted(profile_route, ex, plans["10M mixed 1024"],
                         "10M mixed 1024", route, smi, counts, 1,
                         route == "phase1")
    log(f"  10M set-up: segment build {t_build:.2f} s, device load "
        f"{t_load:.2f} s [{smi}]")
    x2 = phase_block_engine(counts, smi, searcher, "10M", oracle,
                            solo_only=True)
    return launches, at10m, x2


def escalation_args(ex, plans):
    """B2's arguments for the queries of ``plans`` whose certificate fails
    on the pruned route (the ones ``finalize`` rescores exhaustively), and
    whether B2 is the kernel the main path runs on them (B1 where every one
    is pure OR)."""
    from diagon_tpu_torch.search.row_engine import _flags

    fused = ex.dispatch(plans, K).cpu().numpy()
    unsafe = np.nonzero(fused[:, 2 * K + 1] == 0.0)[0]
    if not len(unsafe):
        raise AssertionError("the 10M mixed batch escalates no query")
    sub = [plans[int(i)] for i in unsafe]
    a = ex._args(sub)
    return ((a[0], a[1], a[3], a[4], _flags(*a[5:9])),
            not all(p.pure_or for p in sub))


def check_replay(ex, counts, plans):
    """With query_cache on, the second dispatch of an identical batch
    replays phase 1 (no phase-1 launch) and returns the same bits."""
    p1 = ("approx_select", "approx_select_bool", "approx_select_bool2")

    def run():
        a0 = counts.read()
        f1 = ex.dispatch(plans, K)
        a1 = counts.read()
        f2 = ex.dispatch(plans, K)
        torch.cuda.synchronize()
        return f1, f2, a0, a1, counts.read()

    ex.query_cache = True
    try:
        f1, f2, a0, a1, a2 = counts.uncounted(run)
    finally:
        ex.query_cache = False
    if not bits_equal(f1, f2):
        raise AssertionError("p1 replay changed the fused rows")
    if sum(a1[n] - a0[n] for n in p1) < 1 or any(a2[n] != a1[n] for n in p1):
        raise AssertionError("the replayed dispatch ran phase 1 again")
    if a2["gather_rescore"] <= a1["gather_rescore"]:
        raise AssertionError("the replayed dispatch skipped phase 2")
    log("  query_cache replay: same bits, no phase-1 launch on the second "
        "dispatch")


# ---------------------------------------------------------------------------
# Phase 6: the kernels on the main path's own tensors
# ---------------------------------------------------------------------------


def main_path_args(ex, plans):
    """The tensors the pruned route hands each kernel for ``plans``: the
    purity split's subsets, their compact banks, and phase 1's tile
    selection (recomputed uncounted) for the phase-2 kernel the route picks
    (``_use_union``); the compact rows and clause arrays for the soundness
    check; the larger subset wins where two take one kernel."""
    from diagon_tpu_torch.search import row_engine as re

    split = ex._purity_split(plans)
    subsets = (split[0], split[1]) if split else (plans,)
    out, rows = {}, {}
    live = ex.index.live
    for sub in subsets:
        c = ex._compact(sub)
        boolean = not all(p.pure_or for p in sub)
        if not boolean:
            name = "approx_select"
            args = (c.a_sc_t, c.compact_bf16, live)
        elif c.a_cb_t is not None:
            name = "approx_select_bool2"
            args = (c.a_sc_t, c.a_cb_t, c.compact_bf16, c.params_t, live)
        else:
            name = "approx_select_bool"
            args = (c.a_sc_t, c.a_rq_t, c.a_sh_t, c.a_ng_t, c.compact_bf16,
                    c.params_t, live)
        G, U8, _ = c.compact_t.shape
        out[name] = args
        rows[name] = {
            "bank": c.compact_t.permute(1, 0, 2).reshape(U8, G * 128)
                    .contiguous(),
            "cidx": c.cidx, "flags": c.cflags, "params": c.params_t,
            "live": live,
        }
        B = min(ex.tile_budget(len(sub), K), G)
        tsel = re._pruned_batch_phase1(
            c.compact_bf16, c.a_sc_t, c.a_rq_t, c.a_sh_t, c.a_ng_t,
            c.params_t, live, Bk=B, boolean=boolean, a_cb_t=c.a_cb_t)[0]
        gargs = (c.compact_t, c.cidx, tsel, c.cflags if boolean else None)
        rname = ("union_rescore" if re._use_union(*c.cidx.shape, B)
                 else "gather_rescore")
        if rname not in out or len(sub) > out[rname][1].shape[0]:
            out[rname] = gargs
    return out, rows


def split_bool_args(ex, plans):
    """B4's arguments on the boolean subset of ``plans`` that B5 serves on
    the main path: the same compact bank and params, with the indicators
    a_rq, a_sh and a_ng (all zero here) in place of a_cb."""
    split = ex._purity_split(plans)
    c = ex._compact(split[1] if split else plans)
    if c.a_cb_t is None:
        raise AssertionError("the boolean subset is not B5's")
    return (c.a_sc_t, c.a_rq_t, c.a_sh_t, c.a_ng_t, c.compact_bf16,
            c.params_t, ex.index.live)


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def kernel_bound(name, args):
    """(bound_ms, bound_by): the least time the card could take for the
    work of one call on ``args``, the larger of the bytes it must move
    (each input row it reads once, each output once) over HBM_BYTES_PER_S
    and the operations these inputs need over the rate of their type:
    f32 adds / compares for B1, B2, B6, B7 (RATES["f32"]); bf16
    multiply-adds of the indicator nonzeros for B3-B5 (the listed rows
    only, PEAK_BF16); for B8 per live query and word a popcount
    (RATES["popc"]) and the 3-input logic ops (LOP3, RATES["logic"]) that
    fold its k role rows into one match word, k // 2 of them (each folds
    two more rows in; none where k <= 1: the popcount of ~x is 32 minus
    that of x), the slower of the two pipes setting the time. A role row
    counts where the mode word uses its role (required under MODE_REQ,
    should under MODE_SHO, must_not always)."""
    if name in ("row_sum", "row_boolean"):
        heavy, light, hidx, lidx = args[:4]
        D = heavy.shape[1]
        Q, Tq = hidx.shape
        rows = (torch.unique(hidx[hidx >= 0]).numel()
                + torch.unique(lidx[hidx < 0]).numel())
        outs = 1 if name == "row_sum" else 4
        byts = rows * D * 4 + nbytes(*args[2:]) + outs * Q * D * 4
        t_ops = Q * D * ((Tq - 1) if name == "row_sum" else 5 * Tq) / RATES["f32"]
    elif name.startswith("approx_select"):
        bank = args[{"approx_select": 1, "approx_select_bool": 4,
                     "approx_select_bool2": 2}[name]]
        inds = [a for a in args if a.dtype == torch.bfloat16 and a is not bank]
        D = bank.shape[1]
        Q = inds[0].shape[1]
        byts = nbytes(*args) + Q * (D // 128) * 4 + Q * 4
        t_ops = 2 * D * sum(int((a != 0).sum()) for a in inds) / PEAK_BF16
    elif name in ("gather_rescore", "union_rescore"):
        ct, cidx, tsel, flags = args
        U8 = ct.shape[1]
        Q, Tq = cidx.shape
        B = tsel.shape[1]
        lanes = torch.unique(tsel.long()[:, :, None] * U8
                             + cidx.long()[:, None, :]).numel()
        outs = 1 if flags is None else 4
        byts = lanes * 128 * 4 + nbytes(cidx, tsel, flags) + outs * Q * B * 512
        t_ops = Q * B * 128 * Tq * (1 if flags is None else 5) / RATES["f32"]
    else:  # bits_hits
        from diagon_tpu_torch.ops.bits_hits import (MODE_DEAD, MODE_REQ,
                                                     MODE_SHO)

        bits, cidx, cflags, qmode = args
        W = bits.shape[1]
        role = (cflags & 14) != 0
        rows = torch.unique(cidx[role]).numel()
        byts = rows * W * 4 + nbytes(cidx, cflags, qmode) + qmode.numel() * 4
        alive = (qmode & MODE_DEAD) == 0
        mode = qmode[:, None]
        k = ((((cflags & 2) != 0) & ((mode & MODE_REQ) != 0)).sum(dim=1)
             + (((cflags & 4) != 0) & ((mode & MODE_SHO) != 0)).sum(dim=1)
             + ((cflags & 8) != 0).sum(dim=1))
        logic = W * int(((k // 2) * alive).sum())
        popc = W * int(alive.sum())
        t_ops = max(logic / RATES["logic"], popc / RATES["popc"])
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops *= 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rescore_bags(args):
    """B6's pure-OR function as ``embedding_bag(mode="sum")`` arguments:
    the bank as [G * U8, 128] rows and one bag of Tq rows
    tsel[q, b] * U8 + cidx[q, t] a pair."""
    ct, cidx, tsel, _ = args
    G, U8, lanes = ct.shape
    bags = (tsel.long()[:, :, None] * U8 + cidx.long()[:, None, :])
    return bags.reshape(-1, cidx.shape[1]), ct.view(G * U8, lanes)


def library_ms(name, args):
    """One PyTorch call computing the same function on the same inputs,
    timed: B1's row sums are ``embedding_bag(mode="sum")`` over the heavy
    bank when every clause reads it, and so is B6's pure-OR rescore over
    the compact bank's lane rows (``rescore_bags``), each in another add
    order (timing only: the port never calls it); no single call computes
    B2-B5's, B6's boolean form's, B7's or B8's outputs (B3-B5's product
    alone is a matmul, without the tile maxima or the hits)."""
    if name == "row_sum":
        heavy, _, hidx, _ = args
        if bool((hidx >= 0).all()):
            idx = hidx.long()
            return cuda_ms(lambda: torch.nn.functional.embedding_bag(
                idx, heavy, mode="sum"))
    if name == "gather_rescore" and args[3] is None:
        bags, rows = rescore_bags(args)
        return cuda_ms(lambda: torch.nn.functional.embedding_bag(
            bags, rows, mode="sum"))
    return None


def queued_ms(fn, n):
    """Device ms per call of n calls of ``fn`` queued behind a device-side
    sleep that outlasts their launches: the calls then run back to back, so
    the time holds their kernels and the device's gaps between them but no
    host time. The sleep is lengthened until it does outlast them; NaN
    (not measured) where even 134 ms do not, as when ``fn`` waits on the
    device."""
    cycles = 1 << 24  # about 8 ms at 2 GHz
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        dry = a.query()  # the sleep ended before the last launch
        b.synchronize()
        if not dry:
            return a.elapsed_time(b) / n
        cycles *= 4
    return float("nan")


def three_ways(fn, n=100, reps=5):
    """Three times of one call of ``fn``, ms: CUDA events around one call
    (median of 20), events around n back-to-back calls divided by n, and
    the device time per call of n calls queued behind a device sleep
    (``queued_ms``: kernel only; the host's share is the gap between the
    last two), each a median of ``reps``."""
    one = cuda_ms(fn)
    batch = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        batch.append(a.elapsed_time(b) / n)
    queued = [queued_ms(fn, n) for _ in range(reps)]
    dev = (statistics.median(queued) if all(t == t for t in queued)
           else float("nan"))  # t != t: NaN
    return one, statistics.median(batch), dev


def row_sum_split(rs, counts, args, label, smi):
    """B1 and embedding_bag (same rows, all clauses on the heavy bank) at
    one shape, each timed three ways."""
    heavy, light, hidx, lidx = args
    if not bool((hidx >= 0).all()):
        raise AssertionError(f"{label}: embedding_bag needs heavy rows only")
    idx = hidx.long()
    b1 = counts.uncounted(three_ways, lambda: rs.row_sum(*args))
    lib = three_ways(lambda: torch.nn.functional.embedding_bag(
        idx, heavy, mode="sum"))
    log(f"  B1 split {label}: one call / per call of 100 / kernel only: "
        f"row_sum {b1[0]:.4f} / {b1[1]:.4f} / {b1[2]:.4f} ms, embedding_bag "
        f"{lib[0]:.4f} / {lib[1]:.4f} / {lib[2]:.4f} ms [{smi}]")
    return b1, lib


def time_kernel(counts, name, fn, ref, args, exact):
    got = counts.uncounted(fn, *args)
    want = ref(*args)
    torch.cuda.synchronize()
    if exact and not bits_equal(got, want):
        raise AssertionError(f"{name} != plain on the main path's args")
    ms = counts.uncounted(cuda_ms, lambda: fn(*args))
    plain = cuda_ms(lambda: ref(*args), reps=5, warmup=1)
    rescore = name in ("gather_rescore", "union_rescore")
    shape = tuple(args[1].shape if rescore else args[0].shape)
    log(f"  main-path {name} {shape}: {ms:.4f} ms, plain {plain:.4f} ms")
    return ms, plain, max_abs_err(got, want), got, want


def phase_main_path_kernels(rs, ap, gr, bh, counts, searcher19, batches19,
                            ex1m, batches1m, at10m, smi):
    """Each kernel on the args the main path gives it: B1 at the deduped
    or20 plan and B2 at the mixed batch's exhaustive args (the escalation
    shape) at 19k; B4 at the 19k MUST_NOT batch (its record), at the 1M
    MUST_NOT batch, and on the 1M mixed batch's boolean subset beside B5;
    B3, B5, B6 and B7 at the 1M mixed batch; B8 at the 10M phase-0 entry of
    the mixed batch's pure-OR subset. B3-B5 are checked as in phase 3
    (hits, feasibility, maxima within 2^-8, soundness against B1/B2 on the
    compact rows), and B3 and B5 again on the 10M phase-1 entries' own
    tensors, B2 on the queries the 10M mixed batch escalates (``at10m``);
    B6 and B7 bit for bit against their plain versions and each other; B8
    exactly. B1 and embedding_bag are split three ways (one call, per call
    of 100, kernel only) at the main path's args and at Q 1024, Tq 20, and
    so are B4, B7 and B6 on B7's tensors; B6 and embedding_bag also at the
    1M mixed pure-OR subset, the 10M phase-1 entry and the deduped 1M or20
    batch (Q 1), B6 checked bit for bit at each; B8 at the 10M phase-0
    entry. Returns each kernel's times, error, bound and library time."""
    from diagon_tpu_torch.search.row_engine import _flags

    log("phase 6: kernels vs plain on the main path's tensors")
    ex19 = searcher19._ctx("body").row_executors[0]
    out, at = {}, {}
    a1 = ex19._args(batches19["or20 x 1024"][:1])
    a2 = ex19._args(batches19["mixed 1024"])
    for name, fn, ref, args in (
        ("row_sum", rs.row_sum, rs.row_sum_reference,
         (a1[0], a1[1], a1[3], a1[4])),
        ("row_boolean", rs.row_boolean, rs.row_boolean_reference,
         (a2[0], a2[1], a2[3], a2[4], _flags(*a2[5:9]))),
        ("bits_hits", bh.bits_hits, bh.bits_hits_reference,
         at10m["bits_hits"]),
    ):
        out[name] = time_kernel(counts, name, fn, ref, args, True)[:3]
        at[name] = args
    heavy, light, hidx, lidx, _ = kernel_inputs(np.random.default_rng(6), 1024,
                                                20)
    hidx = hidx.abs()  # every clause on the heavy bank, as embedding_bag needs
    got = counts.uncounted(rs.row_sum, heavy, light, hidx, lidx)
    if not bits_equal(got, rs.row_sum_reference(heavy, light, hidx, lidx)):
        raise AssertionError("row_sum != plain at Q 1024, Tq 20")
    row_sum_split(rs, counts, at["row_sum"], "main path (Q 1, Tq 20)", smi)
    row_sum_split(rs, counts, (heavy, light, hidx, lidx), "Q 1024, Tq 20",
                  smi)
    del heavy, light, hidx, lidx, got
    neg_args, neg_rows = main_path_args(ex19, batches19["MUST_NOT 1024"])
    mixed_args, mixed_rows = main_path_args(ex1m, batches1m["1M mixed 1024"])
    neg1m_args, neg1m_rows = main_path_args(ex1m,
                                            batches1m["1M MUST_NOT 1024"])
    for name, args, rows, what in (
        ("approx_select_bool", neg_args, neg_rows, "19k MUST_NOT"),
        ("approx_select", mixed_args, mixed_rows, "1M mixed"),
        ("approx_select_bool2", mixed_args, mixed_rows, "1M mixed"),
        ("approx_select_bool", neg1m_args, neg1m_rows, "1M MUST_NOT"),
    ):
        ms, plain, _, got, want = time_kernel(
            counts, name, getattr(ap, name), getattr(ap, name + "_reference"),
            args[name], False)
        boolean = name != "approx_select"
        e = check_select(f"main-path {name} {what}", got, want,
                         exact_tiles(rs, counts, rows[name], boolean), boolean,
                         REL_TOL if boolean else BF16_STEP)
        b_ms, b_by = kernel_bound(name, args[name])
        log(f"    {what} (Q {args[name][0].shape[1]}, U8 "
            f"{args[name][0].shape[0]}): sound, hits and feasibility == plain "
            f"== exact; {ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.4f} "
            f"ms by {b_by} [{smi}]")
        if name in out:  # B4 at 1M: its error counts, its times are logged
            out[name] = out[name][:2] + (max(out[name][2], e),)
        else:
            out[name] = (ms, plain, e)
            at[name] = args[name]
        if name == "approx_select":
            no_subnormals("1M pure-OR entry", rows[name]["bank"], args[name][1])
    # the cost of the general form as one number: B4 on the 1M mixed
    # batch's boolean subset, the counts split from the same plans (a_ng
    # 0), beside B5 on the same compact bank
    b5 = mixed_args["approx_select_bool2"]
    b4 = split_bool_args(ex1m, batches1m["1M mixed 1024"])
    got4 = counts.uncounted(ap.approx_select_bool, *b4)
    got5 = counts.uncounted(ap.approx_select_bool2, *b5)
    torch.cuda.synchronize()
    if not (torch.equal(got4[1], got5[1])
            and torch.equal(got4[0] == -1.0, got5[0] == -1.0)):
        raise AssertionError("B4 and B5 differ in hits or feasibility on the "
                             "1M mixed boolean subset")
    e = check_select("main-path approx_select_bool 1M mixed boolean subset",
                     got4, ap.approx_select_bool_reference(*b4),
                     exact_tiles(rs, counts, mixed_rows["approx_select_bool2"],
                                 True), True)
    out["approx_select_bool"] = out["approx_select_bool"][:2] + (
        max(out["approx_select_bool"][2], e),)
    ms4 = counts.uncounted(cuda_ms, lambda: ap.approx_select_bool(*b4))
    ms5 = counts.uncounted(cuda_ms, lambda: ap.approx_select_bool2(*b5))
    log(f"    1M mixed boolean subset (Q {b4[0].shape[1]}, U8 "
        f"{b4[0].shape[0]}): B4 {ms4:.4f} ms beside B5 {ms5:.4f} ms on the "
        f"same plans; hits and feasibility equal, sound; tile maxima differ "
        f"by at most {max_abs_err(got4[0], got5[0]):.3g} [{smi}]")
    del got4, got5, b4, b5
    for name, boolean in (("approx_select", False),
                          ("approx_select_bool2", True)):
        args10, rows10 = at10m[name]
        no_subnormals(f"10M phase-1 {name} entry", rows10["bank"],
                      args10[2 if boolean else 1])
        ms, plain, _, got, want = time_kernel(
            counts, name, getattr(ap, name), getattr(ap, name + "_reference"),
            args10, False)
        e = check_select(f"main-path {name} 10M", got, want,
                         exact_tiles(rs, counts, rows10, boolean), boolean,
                         REL_TOL if boolean else BF16_STEP)
        b_ms, b_by = kernel_bound(name, args10)
        log(f"    10M phase-1 entry (Q {args10[0].shape[1]}, U8 "
            f"{args10[0].shape[0]}): sound, hits and feasibility == plain == "
            f"exact; {ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.4f} ms "
            f"by {b_by} [{smi}]")
        out[name] = out[name][:2] + (max(out[name][2], e),)
        del got, want, args10, rows10
    args10, on_b2 = at10m["row_boolean"]
    ms, plain, e = time_kernel(counts, "row_boolean", rs.row_boolean,
                               rs.row_boolean_reference, args10, True)[:3]
    b_ms, b_by = kernel_bound("row_boolean", args10)
    log(f"    10M mixed batch's escalated queries (Q {args10[2].shape[0]}, Tq "
        f"{args10[2].shape[1]}, D {args10[0].shape[1]}; the main path runs "
        f"{'B2' if on_b2 else 'B1'} on them): bit-exact; {ms:.4f} ms, plain "
        f"{plain:.4f} ms, bound {b_ms:.4f} ms by {b_by} [{smi}]")
    # B2 beside it at Q 1024, Tq 20, D 19,456 on seeded inputs
    args_q = kernel_inputs(np.random.default_rng(62), 1024, 20)
    ms, plain, _ = time_kernel(counts, "row_boolean", rs.row_boolean,
                               rs.row_boolean_reference, args_q, True)[:3]
    b_ms, b_by = kernel_bound("row_boolean", args_q)
    log(f"    Q 1024, Tq 20, D {KERNEL_D} (seeded inputs): bit-exact; "
        f"{ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.4f} ms by {b_by} "
        f"[{smi}]")
    del args10, args_q
    for name in ("gather_rescore", "union_rescore"):
        ms, plain, e, got, _ = time_kernel(
            counts, name, getattr(gr, name), getattr(gr, name + "_reference"),
            mixed_args[name], True)
        oname = "union_rescore" if name == "gather_rescore" else "gather_rescore"
        other = getattr(gr, oname)
        if not bits_equal(got, counts.uncounted(other, *mixed_args[name])):
            raise AssertionError(f"main-path {name}: B6 and B7 differ")
        oms = cuda_ms(lambda: counts.uncounted(other, *mixed_args[name]))
        log(f"    bit-equal to {oname} on the same tensors, which takes "
            f"{oms:.4f} ms")
        out[name] = (ms, plain, e)
        at[name] = mixed_args[name]
    # the redesigned B4, B7, B6 and B8 split into wrapper and device time,
    # B7 beside B6 on B7's tensors (no library call computes B7's boolean
    # form)
    for label, fn, args in (
        ("B4 19k MUST_NOT", ap.approx_select_bool,
         neg_args["approx_select_bool"]),
        ("B4 1M MUST_NOT", ap.approx_select_bool,
         neg1m_args["approx_select_bool"]),
        ("B7 1M mixed", gr.union_rescore, mixed_args["union_rescore"]),
        ("B6 on B7's tensors", gr.gather_rescore, mixed_args["union_rescore"]),
        ("B8 10M phase-0 entry", bh.bits_hits, at["bits_hits"]),
    ):
        w = counts.uncounted(three_ways, lambda: fn(*args), 50, 3)
        log(f"  {label} split: one call / per call of 50 / kernel only "
            f"{w[0]:.4f} / {w[1]:.4f} / {w[2]:.4f} ms [{smi}]")
    # B6 beside embedding_bag (the same pure-OR function, another add
    # order) at the main path's three B6 shapes, each checked bit for bit
    q1 = main_path_args(ex1m, batches1m["1M or20 x 1024"][:1])[0]
    for label, args in (("1M mixed pure-OR subset",
                         mixed_args["gather_rescore"]),
                        ("10M phase-1 entry", at10m["gather_rescore"]),
                        ("1M or20 deduped, Q 1", q1["gather_rescore"])):
        _, _, e, got, _ = time_kernel(counts, "gather_rescore",
                                      gr.gather_rescore,
                                      gr.gather_rescore_reference, args, True)
        out["gather_rescore"] = out["gather_rescore"][:2] + (
            max(out["gather_rescore"][2], e),)
        bags, rows = rescore_bags(args)
        lib = torch.nn.functional.embedding_bag(bags, rows, mode="sum")
        lib_err = max_abs_err(lib.view(got.shape), got)
        w6 = counts.uncounted(three_ways, lambda: gr.gather_rescore(*args),
                              50, 3)
        wl = three_ways(lambda: torch.nn.functional.embedding_bag(
            bags, rows, mode="sum"), 50, 3)
        b_ms, b_by = kernel_bound("gather_rescore", args)
        Q, Tq = args[1].shape
        log(f"  B6 {label} (Q {Q}, Tq {Tq}, B {args[2].shape[1]}, U8 "
            f"{args[0].shape[1]}): bit-exact; one call / per call of 50 / "
            f"kernel only: B6 {w6[0]:.4f} / {w6[1]:.4f} / {w6[2]:.4f} ms, "
            f"embedding_bag {wl[0]:.4f} / {wl[1]:.4f} / {wl[2]:.4f} ms "
            f"(max |diff| {lib_err:.3g}); bound {b_ms:.4f} ms by {b_by} "
            f"[{smi}]")
        del bags, rows, lib, got
    del q1
    record = {}
    for name, (ms, plain, e) in out.items():
        b_ms, b_by = kernel_bound(name, at[name])
        lib = counts.uncounted(library_ms, name, at[name])
        record[name] = {"ms": ms, "plain_ms": plain, "max_abs_err": e,
                        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}
        log(f"  {name}: {ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}, "
            f"library {'none' if lib is None else f'{lib:.4f} ms'}")
    return record


# ---------------------------------------------------------------------------
# Phase 7: the pruned route against the exhaustive one, same plans
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def on_route(ex, route):
    """Route ``ex``'s batches as the JAX package does (any route name but
    "exhaustive": the executor as set), or with the pruning floor raised
    past every segment ("exhaustive": the dedup still applies)."""
    floor = ex.prune_min_docs
    if route == "exhaustive":
        ex.prune_min_docs = 1 << 62
    try:
        yield
    finally:
        ex.prune_min_docs = floor


def served_both_routes(searcher, batch, label, reps, smi):
    """Served batch (dispatch_batch + collect_many) through each route:
    pruned, exhaustive, exhaustive, pruned; medians."""
    ex = searcher._ctx("body").row_executors[0]
    times = {"pruned": [], "exhaustive": []}
    for route in ("pruned", "exhaustive", "exhaustive", "pruned"):
        with on_route(ex, route):
            times[route].append(timed_batches(searcher, batch, reps))
    med = {r: statistics.median(t) for r, t in times.items()}
    log(f"  {label} served: pruned {med['pruned'] * 1e3:.3f} ms/batch "
        f"({len(batch) / med['pruned']:.1f} qps), exhaustive "
        f"{med['exhaustive'] * 1e3:.3f} ms/batch "
        f"({len(batch) / med['exhaustive']:.1f} qps) [{smi}]")


def profile_route(ex, plans, label, route, smi, counts, n=5, wall_pass=True):
    """torch.profiler over n batches of dispatch + finalize on one route:
    wall, device time by kernel, and the busy share; and the port kernels
    launched inside the profiled window, by their counters. The wall time
    comes from n batches before the profiled ones, or (``wall_pass`` false,
    for batches that take seconds) from the profiled batches themselves."""
    from torch.profiler import ProfilerActivity, profile

    def run():
        with on_route(ex, route):
            return ex.finalize(plans, ex.dispatch(plans, K), K)

    def timed_runs():
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n

    run()
    torch.cuda.synchronize()
    if wall_pass:
        wall = timed_runs()
    before = counts.read()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        in_profile = timed_runs()
    if not wall_pass:
        wall = in_profile
    launched = {k: v - before[k] for k, v in counts.read().items()
                if v > before[k]}
    # device-side events only: an aten op's row repeats its kernels' time
    # (self_device_time_total is in us)
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in rows) / n / 1e3
    log(f"  {label} {route}: wall {wall * 1e3:.3f} ms/batch (dispatch + "
        f"finalize), device {total:.3f} ms/batch, busy "
        f"{100 * total / (wall * 1e3):.1f}% [{smi}]; launched {launched}")
    stray = [e.key for e in rows if "approx_select_bool" not in launched
             and any(f"(anonymous namespace)::{n}" in e.key
                     for n in B4_KERNELS)]
    if stray:
        raise AssertionError(f"{label} {route}: a batch without B4 launched "
                             f"B4's kernel: {stray}")
    rows.sort(key=lambda e: -e.self_device_time_total)
    # the top rows, then the port's own kernels further down
    for i, e in enumerate(rows):
        if i < 8 or any(f"(anonymous namespace)::{n}" in e.key
                        for n in PORT_KERNELS):
            ms = e.self_device_time_total / n / 1e3
            log(f"    {ms:8.3f} ms/batch {100 * ms / total:5.1f}%  "
                f"{e.key[:90]}")


def phase_routes(cells, counts, smi):
    """For each (label, searcher, queries, plans): served qps through both
    routes, then a profile of each route, all uncounted."""
    log("phase 7: pruned vs exhaustive route on the same plans")
    for label, searcher, batch, plans in cells:
        ex = searcher._ctx("body").row_executors[0]
        counts.uncounted(served_both_routes, searcher, batch, label,
                         5 if "1M" not in label else 2, smi)
        for route in ("pruned", "exhaustive"):
            counts.uncounted(profile_route, ex, plans, label, route, smi,
                             counts)


# ---------------------------------------------------------------------------
# Phase 14: the block-at-a-time engine (X2) on phases 4, 5 and 8's segments
# ---------------------------------------------------------------------------

X2_DECODE_BLOCKS = 4096  # plan blocks a decode check takes from each end
X2_CHUNK = 3  # queries a chunk in the chunked-batch check


def block_plan(searcher, query):
    """``query``'s block plan on the searcher's first segment, built as the
    JAX searcher's ``_segment_plans`` builds it: MUST, FILTER, SHOULD,
    MUST_NOT clauses, each group by term text, MUST and SHOULD weighted by
    idf * boost."""
    from diagon_tpu_torch.search.engine import TermPlan, build_segment_plan
    from diagon_tpu_torch.search.query import Occur

    field, clauses, min_should = searcher._term_clauses(query)
    f = searcher.device_segments[0].fields[field]

    def group(occur, weighted, **role):
        qs = sorted((q for q, o in clauses if o == occur),
                    key=lambda q: q.term.text)
        return [TermPlan(f.term_id(q.term.text),
                         float(searcher._idf(field, q.term.text, q.boost))
                         if weighted else 0.0, **role) for q in qs]

    tps = (group(Occur.MUST, True, required=True)
           + group(Occur.FILTER, False, required=True)
           + group(Occur.SHOULD, True, should=True)
           + group(Occur.MUST_NOT, False, negated=True))
    return build_segment_plan(f, tps, min_should,
                              float(1.0 / searcher._ctx(field).avgdl))


def block_queries(pool, solo_only):
    """name -> query: the Reuters term and OR / AND families, then a mixed
    boolean, min_should 2, a term given twice, FILTER-only, a MUST_NOT
    boolean and a missing term over the frequent-term pool; at 10M
    (``solo_only``) or20 and four of the rest."""
    from diagon_tpu_torch.bench.queries import reuters_queries
    from diagon_tpu_torch.search.query import (
        BooleanClause,
        BooleanQuery,
        Occur,
        TermQuery,
    )

    def T(w):
        return TermQuery("body", w)

    def B(*clauses, ms=0):
        return BooleanQuery([BooleanClause(q, o) for q, o in clauses], ms)

    M, S, F, N = Occur.MUST, Occur.SHOULD, Occur.FILTER, Occur.MUST_NOT
    qs = {n: q for n, q in reuters_queries().items()
          if not n.startswith("phrase:")}
    qs.update({
        "mixed": B((T(pool[0]), M), (T(pool[3]), S), (T(pool[7]), S),
                   (T(pool[11]), N)),
        "min_should2": B(*[(T(w), S) for w in pool[20:25]], ms=2),
        "twice": B((T(pool[1]), S), (T(pool[1]), S), (T(pool[5]), M)),
        "filter_only": B((T(pool[2]), F), (T(pool[9]), F)),
        "must_not": must_not_batch(pool, 1)[0],
        "missing": T("zzzz_not_a_term"),
    })
    if solo_only:
        qs = {n: qs[n] for n in ("or20", "mixed", "twice", "filter_only",
                                 "term:oil")}
    return qs


def x2_args(ex, plans):
    """X2's arguments for ``plans`` stacked as ``top_k_batch`` stacks
    them."""
    f = ex.field
    blocks, weight, req, sho, neg, bool_params, run_end = ex.batch_args(plans)
    return (f.packed, f.block_base, f.block_count, f.block_doc_bits,
            f.block_freq_bits, f.block_word_off, f.norms, ex.tf_lut,
            ex.live_mask, blocks, run_end, weight, req, sho, neg, bool_params,
            f.window_words)


def x2_touched(ex, plan):
    """The distinct docs that ``plan``'s postings reach: its valid blocks
    decoded on the card by the plain decode, in slices of 65,536 blocks."""
    from diagon_tpu_torch.ops.bitpack_ops import decode_doc_blocks

    f = ex.field
    valid = torch.from_numpy(
        plan.blocks[plan.blocks >= 0].astype(np.int64)).to(DEVICE)
    seen = torch.zeros(ex.segment.num_docs_pad, dtype=torch.bool,
                       device=DEVICE)
    for s in range(0, len(valid), 65536):
        idx = valid[s:s + 65536]
        docids, _, ok = decode_doc_blocks(
            f.packed, f.block_word_off[idx], f.block_base[idx],
            f.block_count[idx], f.block_doc_bits[idx], f.block_freq_bits[idx],
            f.window_words)
        seen[docids[ok].long()] = True
    return int(seen.sum())


def x2_bound(ex, plan, meta, touched, tile):
    """Bounds (ms, bound_by) of one X2 call on ``plan`` over HBM, counting
    what this plan's data needs, for three forms. Each reads every valid
    block's doc section (ceil(count * doc_bits / 32) words) and its five
    metadata columns (20 B), the plan's run ends and bool_params, and a
    live value for each of the ``touched`` docs (no other doc's is needed),
    and writes the hits. The score forms also read the freq sections, the
    plan's valid entries (block, weight and three flags: 20 B; the count
    form reads 16 B: no weight), the tf table once and a norm for each
    touched doc; the row form (X2's first) writes the final row (4 B a doc), the
    candidate form its candidates (8 B each: ``candidates(D, tile, K)``).
    Operations: a decode, a multiply and four adds a lane, 16 counted (12
    in the count form), at the f32 rate. Returns {"row", "cand", "count"}:
    (bound_ms, bound_by)."""
    from diagon_tpu_torch.ops.block_score import candidates

    valid = plan.blocks[plan.blocks >= 0].astype(np.int64)
    cnt = meta["block_count"][valid].astype(np.int64)
    dwords = int(((cnt * meta["block_doc_bits"][valid] + 31) // 32).sum())
    fwords = int(((cnt * meta["block_freq_bits"][valid] + 31) // 32).sum())
    runs = int((plan.run_end > 0).sum())
    D = ex.segment.num_docs_pad
    common = 4 * dwords + 20 * len(valid) + 4 * runs + 8 + 4 * touched + 4
    score = (common + 4 * fwords + 20 * len(valid) + 4 * ex.tf_lut.numel()
             + 4 * touched)
    byts = {"row": score + 4 * D, "cand": score + 8 * candidates(D, tile, K),
            "count": common + 16 * len(valid)}
    ops = {"row": 16, "cand": 16, "count": 12}
    out = {}
    for form, b in byts.items():
        t_bytes = b / HBM_BYTES_PER_S * 1e3
        t_ops = int(cnt.sum()) * ops[form] / RATES["f32"] * 1e3
        out[form] = (max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def x2_tile(args):
    """The tile size X2 takes for ``args`` on this card."""
    from diagon_tpu_torch.ops.block_score import tile_for

    return tile_for(args[6].shape[0], args[9].shape[0],
                    torch.cuda.get_device_properties(0).multi_processor_count)


def x2_equals_plain(bs, args, what):
    """X2 bit-equal to its plain version on ``args`` at the kernel's tile
    size: the candidate form at k = K and at k = MAX_TILE (every doc of
    every tile, sorted: every doc's score compared), and the count form's
    hits equal to both."""
    tile = x2_tile(args)
    _, _, count_hits = bs.block_score(*args, scores=False)
    err = 0.0
    for k in (K, bs.MAX_TILE):
        got = bs.block_score(*args, k=k)
        want = bs.block_score_reference(*args, k=k, tile=tile)
        torch.cuda.synchronize()
        if not (bits_equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            bad = int(((got[0].view(torch.int32) != want[0].view(torch.int32))
                       | (got[1] != want[1])).sum())
            raise AssertionError(f"X2 {what} k {k} tile {tile}: candidates "
                                 f"!= plain at {bad} of {got[0].numel()}")
        if not (torch.equal(got[2], want[2])
                and torch.equal(count_hits, got[2])):
            raise AssertionError(f"X2 {what}: hits {got[2].tolist()} count "
                                 f"form {count_hits.tolist()} plain "
                                 f"{want[2].tolist()}")
        err = max(err, max_abs_err(got[0], want[0]))
    return err


def decode_equals_host(ex, plan, what):
    """The plain decode (``decode_doc_blocks``) of the plan's blocks on the
    card equals the same on the host (the first and last
    X2_DECODE_BLOCKS valid blocks, and the field's last block)."""
    from diagon_tpu_torch.ops.bitpack_ops import decode_doc_blocks

    f = ex.field
    valid = plan.blocks[plan.blocks >= 0]
    sel = np.unique(np.concatenate([valid[:X2_DECODE_BLOCKS],
                                    valid[-X2_DECODE_BLOCKS:],
                                    [f.num_blocks - 1]])).astype(np.int64)
    cols = (f.block_word_off, f.block_base, f.block_count, f.block_doc_bits,
            f.block_freq_bits)
    idx = torch.from_numpy(sel)
    got = decode_doc_blocks(f.packed, *(c[idx.to(DEVICE)] for c in cols),
                            f.window_words)
    want = decode_doc_blocks(f.packed.cpu(), *(c.cpu()[idx] for c in cols),
                             f.window_words)
    for g, w, name in zip(got, want, ("docids", "freqs", "valid")):
        if not torch.equal(g.cpu(), w):
            raise AssertionError(f"{what}: decoded {name} on the card != host")
    return len(sel)


def executor_topdocs(res):
    from diagon_tpu_torch.search.topdocs import ScoreDoc, TopDocs

    scores, docs, hits = res
    sds = [ScoreDoc(int(d), float(s)) for s, d in zip(scores, docs)
           if s >= 0.0][: int(hits)]
    return TopDocs(int(hits), sds)


def x2_times(bs, ex, plan, meta, label, smi):
    """X2 on one solo plan: the score form (k = K) a call (the wrapper's
    CUDA-event median), kernel only (queued behind a device sleep), the
    plain version, the top-k call (``score_and_topk``: X2 and exact_topk
    over its candidates), the count form a call and kernel only, and the
    bounds of the row form, the candidate form and the count form."""
    from diagon_tpu_torch.search import engine

    args = x2_args(ex, [plan])
    tile = x2_tile(args)

    def score():
        return bs.block_score(*args, k=K)

    def count():
        return bs.block_score(*args, scores=False)

    ms = cuda_ms(score)
    kernel = statistics.median(queued_ms(score, 20) for _ in range(3))
    count_ms = cuda_ms(count)
    count_kernel = statistics.median(queued_ms(count, 20) for _ in range(3))
    plain = cuda_ms(lambda: bs.block_score_reference(*args, k=K, tile=tile),
                    reps=3, warmup=1)
    *pa, run_end = ex._device_plan(plan)
    topk = cuda_ms(lambda: engine.score_and_topk(
        *ex._index_args(), *pa, window_words=ex.field.window_words, k=K,
        run_end=run_end))
    touched = x2_touched(ex, plan)
    bounds = x2_bound(ex, plan, meta, touched, tile)
    valid = int((plan.blocks >= 0).sum())
    (bound, by), (row, _), (cbound, cby) = (bounds["cand"], bounds["row"],
                                            bounds["count"])
    log(f"  X2 {label} ({valid} blocks, {touched} docs reached, B_pad "
        f"{plan.b_pad}, D {ex.segment.num_docs_pad}, tile {tile}): score "
        f"form {ms:.4f} ms a call (wrapper), kernel only {kernel:.4f} ms, "
        f"score_and_topk {topk:.4f} ms, plain {plain:.4f} ms, bound "
        f"{bound:.4f} ms ({by}; row form {row:.4f}); count form "
        f"{count_ms:.4f} ms a call, kernel only {count_kernel:.4f} ms, bound "
        f"{cbound:.4f} ms ({cby}) [{smi}]")
    return dict(ms=ms, kernel_ms=kernel, topk_ms=topk, plain_ms=plain,
                touched=touched, bound_ms=bound, bound_by=by,
                row_bound_ms=row, count_ms=count_ms,
                count_kernel_ms=count_kernel, count_bound_ms=cbound,
                library_ms=None)


def phase_block_engine(counts, smi, searcher, label, oracle=None,
                       solo_only=False):
    """X2 and SegmentExecutor on the searcher's (one) resident segment:
    (a) counted: top_k and count of every query of ``block_queries`` and
    one top_k_batch of them all, through a SegmentExecutor over the
    segment's DeviceSegment; X2 must launch. (b) every answer equal to the
    row engine's (IndexSearcher.search) and the batch to the solo calls;
    samples oracle-exact; the batch again in chunks of X2_CHUNK queries
    (the wrapper's memory split, forced) equal. (c) X2 bit-equal to its
    plain version on the card (both forms) on plans with a term twice,
    FILTER-only ones, padding blocks, and on the whole batch; the plain
    decode on the card equal to the host's. (d) times at or20 and the
    mixed boolean. Returns (launches, max_abs_err, times by plan)."""
    from diagon_tpu_torch.bench.queries import frequent_terms
    from diagon_tpu_torch.ops import block_score as bs
    from diagon_tpu_torch.search import engine

    log(f"phase 14 ({label}): the block-at-a-time engine (X2)")
    ctx = searcher._ctx("body")
    ds = searcher.device_segments[0]
    ex = engine.SegmentExecutor(ds, "body", ctx.tf_lut_host)
    meta = {c: getattr(ex.field, c).cpu().numpy()
            for c in ("block_count", "block_doc_bits", "block_freq_bits")}
    queries = block_queries(frequent_terms(searcher), solo_only)
    plans = {n: block_plan(searcher, q) for n, q in queries.items()}
    names = list(queries)

    counts.reset()
    before = counts.read()
    t0 = time.perf_counter()
    solo = {n: executor_topdocs(ex.top_k(plans[n], K)) for n in names}
    hits = {n: ex.count(plans[n]) for n in names}
    batch = ex.top_k_batch([plans[n] for n in names], K)
    t_served = time.perf_counter() - t0
    counts.require(before, ["block_score"], f"{label} SegmentExecutor")
    launches = counts.read()

    for i, n in enumerate(names):
        if hits[n] != solo[n].total_hits:
            raise AssertionError(f"{label} {n}: count {hits[n]} != top_k "
                                 f"hits {solo[n].total_hits}")
        row = counts.uncounted(searcher.search, queries[n], K)
        if not same_topdocs(solo[n], row):
            raise AssertionError(f"{label} {n}: SegmentExecutor {solo[n]} != "
                                 f"row engine {row}")
        one = executor_topdocs(tuple(a[i] for a in batch))
        if not same_topdocs(one, solo[n]):
            raise AssertionError(f"{label} {n}: top_k_batch != top_k")
    sample = (["or20", "filter_only"] if solo_only
              else ["or20", "and2:oil+price", "mixed", "twice", "filter_only",
                    "must_not", "min_should2"])
    if oracle is None:
        oracle = Oracle(ds.source)
    for n in sample:
        oracle.check(queries[n], solo[n], f"{label} SegmentExecutor {n}")

    def chunked():
        saved = engine.query_chunk
        engine.query_chunk = lambda D, Q, k, dev: min(Q, X2_CHUNK)
        ex._batch_cache.clear()
        try:
            return ex.top_k_batch([plans[n] for n in names], K)
        finally:
            engine.query_chunk = saved

    split = counts.uncounted(chunked)
    for g, w in zip(split, batch):
        same_array(f"{label}: chunked top_k_batch", g, w)
    log(f"  {label}: top_k, count ({len(names)} queries) and top_k_batch "
        f"served in {t_served:.3f} s, equal to the row engine, the batch "
        f"equal to the solo calls and to {-(-len(names) // X2_CHUNK)} chunks "
        f"of {X2_CHUNK}; {len(sample)} sampled oracle-exact; X2 launches "
        f"{launches['block_score']}")

    kernel_names = (["or20", "mixed", "twice", "filter_only"] if solo_only
                    else [n for n in names])
    err, decoded = 0.0, 0
    for n in kernel_names:
        args = x2_args(ex, [plans[n]])
        err = max(err, counts.uncounted(x2_equals_plain, bs, args,
                                        f"{label} {n}"))
        decoded += decode_equals_host(ex, plans[n], f"{label} {n}")
    args = x2_args(ex, [plans[n] for n in kernel_names])
    err = max(err, counts.uncounted(x2_equals_plain, bs, args,
                                    f"{label} batch of {len(kernel_names)}"))
    log(f"  X2 == plain bit for bit on {len(kernel_names)} plans (padding "
        f"blocks, a term twice, FILTER-only) and their batch: candidates at "
        f"k {K} and at k {bs.MAX_TILE} (every doc), hits of both forms; the "
        f"plain decode of {decoded} blocks on the card == the host's")
    times = {}
    for n in (["or20"] if solo_only else ["or20", "mixed"]):
        times[n] = counts.uncounted(x2_times, bs, ex, plans[n], meta,
                                    f"{label} {n}", smi)
    return launches, err, times


# ---------------------------------------------------------------------------
# Phase 13: segment-sharded search over ranks
# ---------------------------------------------------------------------------

SHARD_DOCS = 250_000  # four shards: phase 5's 1,000,000 docs
SHARDS = 4
SHARD_SEED = 20260816
SHARD_REPS = 3  # timed repeats of each batch after its first call
SHARD_SAMPLE = 8  # oracle samples a batch
# the kernels phase 13 must launch: the exhaustive program and the
# escalations (B2), each phase-1 variant (B3-B5) and both rescores (B6, B7)
SHARD_NEED = ["row_boolean", "approx_select", "approx_select_bool",
              "approx_select_bool2", "gather_rescore", "union_rescore"]


def kernel_wrappers():
    """The main path's kernel wrappers by name; each counts its launches."""
    from diagon_tpu_torch.ops import approx_pass as ap
    from diagon_tpu_torch.ops import bank_decode as bd
    from diagon_tpu_torch.ops import bits_hits as bh
    from diagon_tpu_torch.ops import block_score as bs
    from diagon_tpu_torch.ops import gather_rescore as gr
    from diagon_tpu_torch.ops import range_agg as ra
    from diagon_tpu_torch.ops import row_sum as rs

    return {
        "row_sum": rs.row_sum, "row_boolean": rs.row_boolean,
        "approx_select": ap.approx_select,
        "approx_select_bool": ap.approx_select_bool,
        "approx_select_bool2": ap.approx_select_bool2,
        "gather_rescore": gr.gather_rescore,
        "union_rescore": gr.union_rescore,
        "bits_hits": bh.bits_hits,
        "range_agg": ra.range_agg,
        "block_score": bs.block_score,
        "bank_decode": bd.bank_decode,
    }


def shard_corpus(smi, path):
    """Four 250,000-doc shards (``build_synthetic_segment``, seeds
    20260816 + i), built and written through the store tier in four
    threads (zlib and numpy release the GIL) into an FSDirectory at
    ``path`` with a ``segments_1`` commit."""
    from concurrent.futures import ThreadPoolExecutor

    from diagon_tpu_torch.bench.bulk_build import build_synthetic_segment
    from diagon_tpu_torch.index import SegmentInfo, SegmentInfos
    from diagon_tpu_torch.index.writer import _gen_name
    from diagon_tpu_torch.store import FSDirectory, write_segment

    d = FSDirectory(path)

    def one(i):
        seg = build_synthetic_segment(SHARD_DOCS, seed=SHARD_SEED + i)
        seg.name = f"_shard{i}"
        return SegmentInfo(seg.name, seg.num_docs, write_segment(d, seg))

    t0 = time.perf_counter()
    with ThreadPoolExecutor(SHARDS) as pool:
        infos = list(pool.map(one, range(SHARDS)))
    d.write_bytes(_gen_name(1), json.dumps(SegmentInfos(
        generation=1, counter=SHARDS, segments=infos).to_json()).encode())
    size = sum(d.file_length(f) for f in d.list_files())
    log(f"  {SHARDS} shards x {SHARD_DOCS} docs built and written in "
        f"{SHARDS} threads: {time.perf_counter() - t0:.2f} s, "
        f"{size / 2**20:.1f} MiB [{smi}]")


def shard_batches(pool):
    """(label, queries, prune_B_override, kernels the batch must launch)
    over the shards' frequent-term pool: reuters' first 7 (below
    approx_min_q: the exhaustive program, B2); 64 ORs of 2-5 terms and
    or20 (pure OR: B3, then B6 at Tq 20); bench.py's mixed family at 256
    (fused2: B5, then B6 at Tq 20); 64 MUST_NOT booleans (B4, then B7 at Q
    64, Tq 8); the mixed batch with one tile a query (escalations onto
    B2); 16 booleans around the five reference phrases (phrase rows from
    each rank's PhraseExecutor; B5, B6)."""
    from diagon_tpu_torch.bench.queries import (
        PHRASES,
        mixed_query_batch,
        reuters_queries,
    )
    from diagon_tpu_torch.search.query import (
        BooleanClause,
        BooleanQuery,
        Occur,
        PhraseQuery,
        TermQuery,
    )

    queries = reuters_queries()
    rng = np.random.Generator(np.random.PCG64(44))
    ors, seen = [], set()
    while len(ors) < 64:
        terms = tuple(pool[i] for i in rng.choice(
            len(pool), int(rng.integers(2, 6)), replace=False))
        if terms not in seen:
            seen.add(terms)
            ors.append(BooleanQuery([BooleanClause(TermQuery("body", t),
                                                   Occur.SHOULD)
                                     for t in terms], 0))
    mixed = mixed_query_batch(pool, 256, seed=42, phrase_share=0)
    phrases = [
        BooleanQuery([
            BooleanClause(PhraseQuery("body", PHRASES[j % len(PHRASES)]),
                          Occur.MUST if j % 2 else Occur.SHOULD),
            BooleanClause(TermQuery("body", pool[j]), Occur.SHOULD),
        ], 0)
        for j in range(16)
    ]
    return [
        ("reuters 7", list(queries.values())[:7], 0, ["row_boolean"]),
        ("pure-OR 65", ors + [queries["or20"]], 0,
         ["approx_select", "gather_rescore"]),
        ("mixed 256", mixed, 0, ["approx_select_bool2", "gather_rescore"]),
        ("MUST_NOT 64", must_not_batch(pool, 64), 0,
         ["approx_select_bool", "union_rescore"]),
        ("mixed 256, B 1", mixed, 1, ["approx_select_bool2", "row_boolean"]),
        ("phrase 16", phrases, 0, ["approx_select_bool2", "gather_rescore"]),
    ]


def shard_oracle(segs, batches):
    """The port's OracleSearcher over the shards on SHARD_SAMPLE queries a
    batch, evenly spaced: {(batch, query): TopDocs}. Equal queries (the
    B 1 batch repeats the mixed one) are answered once."""
    from diagon_tpu_torch.search.oracle import OracleSearcher

    oracle, memo, answers = OracleSearcher(segs), {}, {}
    for b, (_, queries, _, _) in enumerate(batches):
        step = max(1, len(queries) // SHARD_SAMPLE)
        for i in list(range(0, len(queries), step))[:SHARD_SAMPLE]:
            key = repr(queries[i])
            if key not in memo:
                memo[key] = oracle.search(queries[i], K)
            answers[b, i] = memo[key]
    return answers


def shard_rank(path, batches):
    """Phase 13's rank body (a spawned process: it imports this script):
    opens every shard from ``path`` (mmap) and serves its own on its card
    through a ShardedSearcher on the default group; each batch searched
    once, then SHARD_REPS timed times (a barrier before each). Returns
    what phase 13 prints and gates on."""
    import torch.distributed as dist

    from diagon_tpu_torch.index import DirectoryReader
    from diagon_tpu_torch.observability.metrics import registry
    from diagon_tpu_torch.parallel import ShardedSearcher
    from diagon_tpu_torch.store import FSDirectory

    entered = time.time()
    counts = Counts(kernel_wrappers())
    counts.reset()
    t0 = time.perf_counter()
    shards = DirectoryReader.open(FSDirectory(path)).segments_data()
    t_open = time.perf_counter() - t0
    t0 = time.perf_counter()
    ss = ShardedSearcher(shards, "body")
    torch.cuda.synchronize()
    out = {"rank": ss.rank, "device": str(ss.device), "open_s": t_open,
           "entered": entered, "init_s": time.perf_counter() - t0,
           "heavy": len(ss.heavy_terms), "bank": tuple(ss.heavy_bank.shape),
           "batches": []}
    esc = registry.counter("search.sharded_escalations")
    t_batches = time.perf_counter()
    for label, queries, override, _ in batches:
        ss.prune_B_override = override
        e0, c0 = esc.value(), counts.read()
        t0 = time.perf_counter()
        got = ss.search_batch(queries, K)
        first = time.perf_counter() - t0
        n_esc = esc.value() - e0
        plan = ss._plans(queries)
        splits = []
        for _ in range(SHARD_REPS):
            dist.barrier()
            t0 = time.perf_counter()
            again = ss.search_batch(queries, K)
            splits.append((time.perf_counter() - t0,) + ss.last_split)
            if again != got:
                raise AssertionError(f"{label}: a repeat differs")
        compact = plan[-1]
        out["batches"].append({
            "label": label, "topdocs": got, "esc": n_esc, "first_s": first,
            "split": [statistics.median(c) for c in zip(*splits)],
            "route": None if compact is None
            else ("pure_or" if compact["pure_or"] else
                  "fused2" if compact["fused2"] else "bool"),
            "l_pad": int(plan[0].shape[0]),
            "launched": {n: v - c0[n] for n, v in counts.read().items()
                         if v > c0[n]},
        })
    out["launches"] = counts.read()
    out["batches_s"] = time.perf_counter() - t_batches
    out["mem"] = torch.cuda.memory_allocated(ss.device)
    out["max_mem"] = torch.cuda.max_memory_allocated(ss.device)
    return out


def nccl_one_rank(path, batches, counts, smi):
    """Shard 0 on an NCCL group of one rank in this process (FileStore),
    the all-gather and the all-reduce on CUDA tensors: bit-equal to
    IndexSearcher([shard 0]). Returns the launches."""
    import torch.distributed as dist

    from diagon_tpu_torch.index import DirectoryReader
    from diagon_tpu_torch.parallel import ShardedSearcher
    from diagon_tpu_torch.search import IndexSearcher
    from diagon_tpu_torch.store import FSDirectory

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    shard0 = DirectoryReader.open(FSDirectory(path)).segments_data()[:1]
    ref = IndexSearcher(shard0, device=DEVICE)
    store = scratch_dir() / "nccl_store"
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    try:
        ss = ShardedSearcher(shard0, "body", device=DEVICE)
        counts.reset()
        for label, queries, _, _ in batches:
            t0 = time.perf_counter()
            got = ss.search_batch(queries, K)
            ms = (time.perf_counter() - t0) * 1e3
            want = counts.uncounted(ref.search_batch, queries, K)
            bad = [i for i, (a, b) in enumerate(zip(got, want))
                   if not same_topdocs(a, b)]
            if bad or len(got) != len(want):
                raise AssertionError(f"NCCL {label}: queries {bad[:5]} differ "
                                     "from IndexSearcher([shard 0])")
            log(f"  (b) NCCL, one rank, shard 0: {label} bit-equal to "
                f"IndexSearcher([shard 0]) over all {len(got)} queries; "
                f"first call {ms:.1f} ms [{smi}]")
        launched = counts.read()
    finally:
        dist.destroy_process_group()
    return launched


def phase_sharded(counts, smi):
    """Phase 13: segment-sharded search (``diagon_tpu_torch.parallel``).
    (a) four ranks over gloo on the one card, one 250,000-doc shard each
    (1,000,000 docs), the six batches of ``shard_batches``: every rank's
    TopDocs equal, bit-equal to IndexSearcher over the four segments for
    whole batches, 8 samples a batch equal to the oracle; (b) shard 0 on an
    NCCL group of one rank; (c) ``entry.dryrun_multichip(4)`` over gloo.
    Returns the launches of all three, summed over the ranks."""
    import diagon_tpu_torch.entry as entry

    log(f"phase 13: segment-sharded search, {SHARDS} ranks x {SHARD_DOCS} "
        f"docs (torch {torch.__version__})")
    path = scratch_dir()
    launches, batches = serve_sharded(path, counts, smi)
    picked = [batches[0], batches[2]]
    for n, v in nccl_one_rank(path, picked, counts, smi).items():
        launches[n] += v
    t0 = time.perf_counter()
    _, _, dry = entry.dryrun_multichip(SHARDS)
    log(f"  (c) entry.dryrun_multichip({SHARDS}) over gloo on the card: "
        f"oracle-exact, every rank equal, {time.perf_counter() - t0:.2f} s; "
        f"launches by rank {dry} [{smi}]")
    for d in dry:
        for n, v in d.items():
            launches[n] += v
    idle = [n for n in SHARD_NEED if launches[n] < 1]
    if idle:
        raise AssertionError(f"phase 13 never launched {idle}")
    log(f"  phase 13 launches (all ranks, (a)-(c)): {launches}")
    return launches


def serve_sharded(path, counts, smi, backend="gloo"):
    """Phase 13 (a): builds the shards at ``path`` (``shard_corpus``) and
    their batches; answers every batch with IndexSearcher over the same
    segments and SHARD_SAMPLE queries a batch with the oracle; then serves
    the batches on SHARDS ranks (``shard_rank``; gloo: they share the one
    card, "nccl" wants a card a rank). Every rank's answers and route
    equal, bit-equal to the reference for whole batches, the samples equal
    to the oracle, each batch's kernels launched. Prints each rank's
    set-up and memory and each batch's split on rank 0; returns (the
    launches summed over the ranks, the batches)."""
    from types import SimpleNamespace

    from diagon_tpu_torch.bench.queries import frequent_terms
    from diagon_tpu_torch.index import DirectoryReader
    from diagon_tpu_torch.parallel.launch import run_ranks
    from diagon_tpu_torch.search import IndexSearcher
    from diagon_tpu_torch.store import FSDirectory

    shard_corpus(smi, path)
    segs = DirectoryReader.open(FSDirectory(path)).segments_data()
    # the pool reads nothing of a searcher but its host segments
    batches = shard_batches(frequent_terms(
        SimpleNamespace(_host_segments=lambda: segs)))
    t0 = time.perf_counter()
    ref = IndexSearcher(segs, device=DEVICE)
    want = {label: counts.uncounted(ref.search_batch, queries, K)
            for label, queries, _, _ in batches}
    t_ref = time.perf_counter() - t0
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    answers = shard_oracle(segs, batches)
    t_oracle = time.perf_counter() - t0
    log(f"  the reference (IndexSearcher over the {SHARDS} segments, every "
        f"batch) {t_ref:.2f} s; {len(answers)} oracle samples "
        f"{t_oracle:.2f} s [{smi}]")
    started = time.time()
    t0 = time.perf_counter()
    ranks = run_ranks(shard_rank, SHARDS, backend, str(path), batches,
                      timeout=600)
    where = ("sharing one card, host-side gathers" if backend == "gloo"
             else "a card each, gathers on the cards")
    log(f"  (a) {SHARDS} {backend} ranks {where}: "
        f"{time.perf_counter() - t0:.2f} s from spawn to the last result; "
        f"global heavy set {ranks[0]['heavy']} terms [{smi}]")
    for r in ranks:
        log(f"    rank {r['rank']} on {r['device']}: body entered "
            f"{r['entered'] - started:.1f} s after the spawn, open "
            f"{r['open_s']:.3f} s, searcher {r['init_s']:.2f} s, batches "
            f"{r['batches_s']:.1f} s, bank {r['bank']}, memory_allocated "
            f"{r['mem'] / 2**30:.2f} GiB (peak {r['max_mem'] / 2**30:.2f}); "
            f"launched {r['launches']}")
    for b, (label, queries, override, need) in enumerate(batches):
        recs = [r["batches"][b] for r in ranks]
        if override and recs[0]["esc"] < 1:
            raise AssertionError(f"{label}: B {override} escalated nothing")
        for r, rec in enumerate(recs):
            if rec["topdocs"] != recs[0]["topdocs"]:
                raise AssertionError(f"{label}: rank {r} differs from rank 0")
            if rec["route"] != recs[0]["route"]:
                raise AssertionError(f"{label}: rank {r} took another route")
        got = recs[0]["topdocs"]
        bad = [i for i, (a, w) in enumerate(zip(got, want[label]))
               if not same_topdocs(a, w)]
        if bad or len(got) != len(queries):
            raise AssertionError(f"{label}: queries {bad[:5]} differ from "
                                 "IndexSearcher over the same segments")
        sampled = [i for (bb, i) in answers if bb == b]
        for i in sampled:
            if not same_topdocs(got[i], answers[b, i]):
                raise AssertionError(
                    f"{label}: the merged answer to {queries[i]!r} differs "
                    f"from the oracle:\n  sharded {got[i]}\n  oracle  "
                    f"{answers[b, i]}")
        launched = {n: sum(rec["launched"].get(n, 0) for rec in recs)
                    for n in need}
        idle = [n for n, c in launched.items() if c < 1]
        if idle:
            raise AssertionError(f"{label} never launched {idle}")
        r0 = recs[0]
        total, plan, dev, merge = r0["split"][:4]
        log(f"  {label}: route {r0['route'] or 'exhaustive'}, escalations "
            f"{r0['esc']}; bit-equal to IndexSearcher over all "
            f"{len(queries)} queries, every rank equal, oracle-exact on "
            f"{len(sampled)} samples; light bank "
            f"{r0['l_pad']} x {ranks[0]['bank'][1]} f32 = "
            f"{r0['l_pad'] * ranks[0]['bank'][1] * 4 / 2**20:.1f} MiB a rank; "
            f"rank 0 first {r0['first_s'] * 1e3:.1f} ms, then {total * 1e3:.2f} "
            f"ms (plan {plan * 1e3:.2f}, device {dev * 1e3:.2f}, gather + "
            f"merge {merge * 1e3:.2f}; median of {SHARD_REPS}); launches by "
            f"rank {[rec['launched'] for rec in recs]} [{smi}]")
    return ({n: sum(r["launches"][n] for r in ranks) for n in counts.kernels},
            batches)


def main():
    t_start = time.perf_counter()
    smi = phase_device()
    from diagon_tpu_torch.ops import approx_pass as ap
    from diagon_tpu_torch.ops import bits_hits as bh
    from diagon_tpu_torch.ops import gather_rescore as gr
    from diagon_tpu_torch.ops import range_agg as ra
    from diagon_tpu_torch.ops import row_sum as rs

    kernels = kernel_wrappers()
    counts = Counts(kernels)

    def phase(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"  [{fn.__name__}: {time.perf_counter() - t0:.1f} s]")
        return out

    err = phase(phase_row_kernels, rs)
    err.update(phase(phase_pruned_kernels, rs, ap, gr, counts))
    err.update(phase(phase_bits_kernel, bh, counts))
    b9 = phase(phase_bank_decode, smi)
    launches_col, err["range_agg"], x1_record = phase(phase_columnar, ra,
                                                      counts, smi)
    searcher19, batches19, sent19, launches19 = phase(phase_serve, counts, smi)
    x2 = {"19k": phase(phase_block_engine, counts, smi, searcher19, "19k")}
    launches_ing = phase(phase_ingest, counts, smi)
    searcher1m, batches1m, sent1m, launches1m, reader1m = phase(
        phase_scale, counts, smi)
    x2["1M"] = phase(phase_block_engine, counts, smi, searcher1m, "1M")
    launches_api = phase(phase_api, counts, smi, searcher1m, reader1m)
    del reader1m
    launches_sp = phase(phase_sparse, counts, smi)
    launches10, at10m, x2["10M"] = phase(phase_scale10, counts, smi)
    ex1m = searcher1m._ctx("body").row_executors[0]
    times = phase(phase_main_path_kernels, rs, ap, gr, bh, counts, searcher19,
                  batches19, ex1m, batches1m, at10m, smi)
    del at10m
    phase(phase_routes, [
        ("mixed 1024", searcher19, sent19["mixed 1024"],
         batches19["mixed 1024"]),
        ("phrase 1024", searcher19, sent19["phrase 1024"],
         batches19["phrase 1024"]),
        ("1M mixed 1024", searcher1m, sent1m["1M mixed 1024"],
         batches1m["1M mixed 1024"]),
        ("1M or20 x 1024", searcher1m, sent1m["1M or20 x 1024"],
         batches1m["1M or20 x 1024"]),
        ("1M MUST_NOT 1024", searcher1m, sent1m["1M MUST_NOT 1024"],
         batches1m["1M MUST_NOT 1024"]),
        ("1M phrase 1024", searcher1m, sent1m["1M phrase 1024"],
         batches1m["1M phrase 1024"]),
    ], counts, smi)
    # phase 13 on a card freed of the earlier phases' searchers
    del searcher19, batches19, sent19, searcher1m, batches1m, sent1m, ex1m
    gc.collect()
    torch.cuda.empty_cache()
    launches_sh = phase(phase_sharded, counts, smi)
    runs = (launches19, launches_ing, launches1m, launches_api, launches_sp,
            launches10["phase1"], launches10["phase0"], launches_sh,
            *(r[0] for r in x2.values()))
    launches = {n: sum(r.get(n, 0) for r in runs) for n in kernels}
    launches["range_agg"] += launches_col
    times["range_agg"] = dict(x1_record, max_abs_err=0.0)
    # X2's record: or20 at 1M, from disk
    times["block_score"] = dict(x2["1M"][2]["or20"],
                                max_abs_err=max(r[1] for r in x2.values()))
    err["block_score"] = 0.0
    times["bank_decode"], err["bank_decode"] = b9, 0.0
    log(f"main-path launches at 19k {launches19}; the ingested 19k index "
        f"{launches_ing}; at 1M {launches1m}; the API (phase 12) "
        f"{launches_api}; "
        f"sparse 1M {launches_sp}; at 10M phase 1 {launches10['phase1']}, "
        f"phase 0 {launches10['phase0']}; columnar (X1) {launches_col}; "
        f"sharded (phase 13, all ranks) {launches_sh}; block engine (X2, "
        f"phase 14) " + ", ".join(f"{k} {r[0]['block_score']}"
                                  for k, r in x2.items()))
    idle = [n for n, c in launches.items() if c < 1]
    if idle:
        raise AssertionError(f"the main path never launched {idle}")

    source = {
        "row_sum": "diagon_tpu_torch/csrc/row_sum.cu",
        "row_boolean": "diagon_tpu_torch/csrc/row_sum.cu",
        "approx_select": "diagon_tpu_torch/csrc/approx_pass.cu",
        "approx_select_bool": "diagon_tpu_torch/csrc/approx_pass.cu",
        "approx_select_bool2": "diagon_tpu_torch/csrc/approx_pass.cu",
        "gather_rescore": "diagon_tpu_torch/csrc/gather_rescore.cu",
        "union_rescore": "diagon_tpu_torch/csrc/gather_rescore.cu",
        "bits_hits": "diagon_tpu_torch/csrc/bits_hits.cu",
        "range_agg": "diagon_tpu_torch/csrc/range_agg.cu",
        "block_score": "diagon_tpu_torch/csrc/block_score.cu",
        "bank_decode": "diagon_tpu_torch/csrc/bank_decode.cu",
    }
    # the Pallas kernel bodies (B6: the resident form; _mk_kernel :45 too)
    replaces = {
        "row_sum": "diagon_tpu/ops/pallas/row_sum.py:27",
        "row_boolean": "diagon_tpu/ops/pallas/row_sum.py:42",
        "approx_select": "diagon_tpu/ops/pallas/approx_pass.py:63",
        "approx_select_bool": "diagon_tpu/ops/pallas/approx_pass.py:87",
        "approx_select_bool2": "diagon_tpu/ops/pallas/approx_pass.py:196",
        "gather_rescore": "diagon_tpu/ops/pallas/gather_rescore.py:102",
        "union_rescore": "diagon_tpu/ops/pallas/gather_rescore.py:192",
        "bits_hits": "diagon_tpu/ops/pallas/bits_hits.py:52",
        # no Pallas body: the jitted XLA program of the JAX DeviceTable
        "range_agg": "diagon_tpu/columnar/engine.py:159",
        # no Pallas body: the jitted XLA program of the JAX SegmentExecutor
        "block_score": "diagon_tpu/search/engine.py:205",
        # no Pallas body: the JAX row engine's XLA gathers and scatter
        "bank_decode": "diagon_tpu/search/row_engine.py:1004",
    }
    record = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": source[name],
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": max(err[name], times[name]["max_abs_err"]),
            "ms": times[name]["ms"],
            "plain_ms": times[name]["plain_ms"],
            "bound_ms": times[name]["bound_ms"],
            "bound_by": times[name]["bound_by"],
            "library_ms": times[name]["library_ms"],
        }
        for name in kernels
    ]}
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
