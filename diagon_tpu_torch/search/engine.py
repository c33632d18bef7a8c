"""Block-at-a-time query engine: the port of ``diagon_tpu/search/engine.py``.

1. **Host plan**: per query term its f32 idf, then flat per-block arrays
   (the block ids of every block of the clause's term, the clause's weight
   and MUST / SHOULD / MUST_NOT flags), padded to a power-of-two bucket,
   as the JAX module pads them (``build_segment_plan``).
2. **Device scoring** (X2, ``ops/block_score.py`` and
   ``csrc/block_score.cu``): decode the plan's posting blocks from the
   packed word stream, BM25 by the host tf table, per-doc score and
   must / should / must-not counts in plan order, the boolean and live
   mask and the hit count, and each tile's top k (score descending, docid
   ascending, ``lax.top_k``'s order) as candidates; the row's top k is
   ``row_engine.exact_topk`` over the candidates, fused into one ``[2k+1]``
   row per query.

Every float op mirrors ``BM25Similarity`` bit for bit, and a doc's score
adds in plan order (MUST, FILTER, SHOULD, MUST_NOT, each by term text), the
order the oracle adds in. The searcher serves through the row engine
(``row_engine.py``); ``SegmentExecutor`` runs plans on one segment as the
JAX module's does.

One deviation from the JAX functions' arguments: ``score_and_topk``,
``count_matches`` and ``score_and_topk_batch`` also take the plan's
``run_end`` (keyword), the clause boundaries along which X2 adds in plan
order.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch

from diagon_tpu_torch.ops.block_score import block_score, query_chunk
from diagon_tpu_torch.search.bm25 import BM25Similarity
from diagon_tpu_torch.search.device_index import DeviceField, DeviceSegment


def _bucket(n: int, minimum: int = 16) -> int:
    """Round up to a power of two (the JAX module's plan buckets)."""
    return max(minimum, 1 << math.ceil(math.log2(max(1, n))))


@dataclass
class TermPlan:
    """Scored/flagged clause for one segment.

    Either a posting term (``term_id`` >= 0) or a precomputed host row
    (``host_row`` set: range / match-all / nested clauses, whose dense
    indicator-score row is built on the host).
    """

    term_id: int
    weight: float  # idf * boost; 0.0 for FILTER / MUST_NOT clauses
    required: bool = False  # MUST or FILTER
    should: bool = False
    negated: bool = False
    host_row: object = None  # optional np.ndarray [num_docs_pad] f32


@dataclass
class SegmentPlan:
    """Flat per-block arrays for one segment (padded)."""

    blocks: np.ndarray  # int32 [B_pad]; -1 = padding
    weight: np.ndarray  # f32  [B_pad]
    req: np.ndarray  # f32  [B_pad] 1.0 if required clause
    sho: np.ndarray  # f32  [B_pad]
    neg: np.ndarray  # f32  [B_pad]
    # int32 [B_pad]: run (clause) r's entries end at run_end[r], starting
    # where run r - 1 ended; 0 after the last run (X2's add order)
    run_end: np.ndarray
    num_required: int
    min_should: int
    inv_avgdl: float

    @property
    def b_pad(self) -> int:
        return len(self.blocks)


def build_segment_plan(
    field: DeviceField,
    terms: Sequence[TermPlan],
    min_should: int,
    inv_avgdl: float,
    bucket_min: int = 16,
) -> SegmentPlan:
    """Every block of each posting term, in the order of ``terms``; each
    term's blocks are one run."""
    parts: List[tuple] = []
    num_required = 0
    for tp in terms:
        if tp.required:
            num_required += 1
        if tp.term_id < 0:
            continue
        bs = int(field.block_start[tp.term_id])
        be = int(field.block_start[tp.term_id + 1])
        if be > bs:
            parts.append((np.arange(bs, be, dtype=np.int32), tp))

    b_pad = _bucket(sum(len(b) for b, _ in parts), bucket_min)

    def cat(values, dtype, fill):
        out = np.full(b_pad, fill, dtype=dtype)
        at = 0
        for blocks, tp in parts:
            out[at : at + len(blocks)] = values(blocks, tp)
            at += len(blocks)
        return out

    return SegmentPlan(
        blocks=cat(lambda b, tp: b, np.int32, -1),
        weight=cat(lambda b, tp: np.float32(tp.weight), np.float32, 0.0),
        req=cat(lambda b, tp: 1.0 if tp.required else 0.0, np.float32, 0.0),
        sho=cat(lambda b, tp: 1.0 if tp.should else 0.0, np.float32, 0.0),
        neg=cat(lambda b, tp: 1.0 if tp.negated else 0.0, np.float32, 0.0),
        run_end=np.pad(np.cumsum([len(b) for b, _ in parts], dtype=np.int32),
                       (0, b_pad - len(parts))),
        num_required=num_required,
        min_should=min_should,
        inv_avgdl=inv_avgdl,
    )


def make_tf_table(avgdl: np.float32, max_freq: int,
                  k1: float = 1.2, b: float = 0.75) -> np.ndarray:
    """Host-precomputed ``freq/(freq + k(norm))`` factor, f32 [128*F].

    A posting's BM25 score is ``idf * freq/(freq + k)`` where ``k`` depends
    only on the norm byte and ``avgdl``. The table holds the oracle's exact
    numpy f32 arithmetic, so the device work is one gather and one
    multiply, with no device division.

    Layout: row-major [norm (128), freq (max_freq+1)]; freq 0 -> 0.0.
    """
    F = max_freq + 1
    sim = BM25Similarity(k1, b)
    scorer = sim.scorer(np.float32(1.0), np.float32(avgdl))
    norms = np.repeat(np.arange(128, dtype=np.int32), F)
    freqs = np.tile(np.arange(F, dtype=np.float32), 128)
    table = scorer.score(freqs, norms).astype(np.float32)
    table[freqs == 0] = 0.0
    return table


# ---------------------------------------------------------------------------
# Device scoring (X2)
# ---------------------------------------------------------------------------


def _fuse(cand_scores: torch.Tensor, cand_docs: torch.Tensor,
          hits: torch.Tensor, k: int) -> torch.Tensor:
    """[Q, 2k+1]: k scores | k docids as f32 | hits (exact below 2^24),
    the top k over X2's candidates: their positions ascend in docid where
    scores tie, so the stable selection keeps ``lax.top_k``'s order."""
    # imported here: row_engine imports this module
    from diagon_tpu_torch.search.row_engine import exact_topk

    top_scores, pos = exact_topk(cand_scores, k)
    top_docs = torch.gather(cand_docs, 1, pos)
    return torch.cat([top_scores, top_docs.float(), hits.float()[:, None]],
                     dim=1)


def score_and_topk_batch(
    packed, block_base, block_count, block_doc_bits, block_freq_bits,
    block_word_off, norms, tf_lut, live_mask,
    blocks,  # int32 [Q, B_pad]: a batch of Q query plans
    weight, req, sho, neg,  # f32 [Q, B_pad]
    bool_params,  # f32 [Q, 2]: num_required, min_should
    *, window_words: int, k: int, run_end,
):
    """Batched scoring -> fused f32 [Q, 2k+1] (see ``unfuse_topk``): X2's
    tile candidates, then ``exact_topk`` over them. The queries go to X2 in
    chunks whose candidates fit the free device memory (``query_chunk``);
    the rows are the same either way."""
    Q = blocks.shape[0]
    step = query_chunk(norms.shape[0], Q, k, packed.device)
    plan = (blocks, run_end, weight, req, sho, neg, bool_params)
    out = []
    for q0 in range(0, Q, step):
        part = plan if step >= Q else [t[q0:q0 + step] for t in plan]
        out.append(_fuse(*block_score(
            packed, block_base, block_count, block_doc_bits, block_freq_bits,
            block_word_off, norms, tf_lut, live_mask, *part, window_words,
            k=k), k))
    return torch.cat(out) if len(out) > 1 else out[0]


def score_and_topk(
    packed, block_base, block_count, block_doc_bits, block_freq_bits,
    block_word_off, norms, tf_lut,
    live_mask,  # f32 [num_docs_pad]: 1.0 live, 0.0 deleted/padding
    blocks,  # int32 [B_pad]
    weight, req, sho, neg,  # f32 [B_pad]
    bool_params,  # f32 [2]: num_required, min_should
    *, window_words: int, k: int, run_end,
):
    """Full boolean scoring -> fused f32 [2k+1]: top-k scores, top-k
    docids, total hits."""
    return score_and_topk_batch(
        packed, block_base, block_count, block_doc_bits, block_freq_bits,
        block_word_off, norms, tf_lut, live_mask, blocks[None], weight[None],
        req[None], sho[None], neg[None], bool_params[None],
        window_words=window_words, k=k, run_end=run_end[None])[0]


def count_matches(
    packed, block_base, block_count, block_doc_bits, block_freq_bits,
    block_word_off, norms, tf_lut, live_mask, blocks, weight, req, sho, neg,
    bool_params, *, window_words: int, run_end,
):
    """Match count only (int32 scalar tensor): X2's count form."""
    _, _, hits = block_score(
        packed, block_base, block_count, block_doc_bits, block_freq_bits,
        block_word_off, norms, tf_lut, live_mask, blocks[None], run_end[None],
        weight[None], req[None], sho[None], neg[None], bool_params[None],
        window_words, scores=False)
    return hits[0]


def unfuse_topk(fused: np.ndarray, k: int):
    """Decode fused rows ``[k scores | k docids as f32 | hits]`` into
    (scores f32, docs i32, hits i32)."""
    fused = np.asarray(fused)
    scores = fused[..., :k]
    docs = fused[..., k : 2 * k].astype(np.int32)
    hits = fused[..., 2 * k].astype(np.int32)
    return scores, docs, hits


def unfuse_topk_device(fused: torch.Tensor, k: int):
    """``unfuse_topk`` on the device (for composing into larger programs)."""
    scores = fused[..., :k]
    docs = fused[..., k : 2 * k].to(torch.int32)
    hits = fused[..., 2 * k].to(torch.int32)
    return scores, docs, hits


# ---------------------------------------------------------------------------
# Segment executor
# ---------------------------------------------------------------------------

BM25_K1 = np.float32(1.2)
BM25_B = np.float32(0.75)


class SegmentExecutor:
    """Runs plans against one device segment and field.

    ``tf_lut`` is collection-level (avgdl spans all segments), so the
    caller supplies it (a host array or a tensor).
    """

    def __init__(self, segment: DeviceSegment, field_name: str, tf_lut):
        self.segment = segment
        self.field = segment.field(field_name)
        self.device = self.field.device
        self.tf_lut = torch.as_tensor(tf_lut, dtype=torch.float32,
                                      device=self.device)
        # batched-plan device-array cache (keyed by plan identities; holds
        # strong refs to the plans so the ids stay valid)
        self._batch_cache: Dict[tuple, tuple] = {}
        live = segment.live_docs
        if live is None:
            lm = torch.zeros(segment.num_docs_pad, dtype=torch.float32)
            lm[: segment.num_docs] = 1.0
            self.live_mask = lm.to(self.device)
        else:
            self.live_mask = live.to(torch.float32)

    def _index_args(self):
        f = self.field
        return (f.packed, f.block_base, f.block_count, f.block_doc_bits,
                f.block_freq_bits, f.block_word_off, f.norms, self.tf_lut,
                self.live_mask)

    def _tensor(self, x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _device_plan(self, plan: SegmentPlan):
        # the device copies are memoised on the plan (plans are immutable
        # and cached by their caller, so repeated queries skip the uploads)
        dev = getattr(plan, "_dev_args", None)
        if dev is None or dev[0].device != self.device:
            dev = (
                self._tensor(plan.blocks, torch.int32),
                *(self._tensor(x, torch.float32)
                  for x in (plan.weight, plan.req, plan.sho, plan.neg)),
                self._tensor([plan.num_required, plan.min_should],
                             torch.float32),
                self._tensor(plan.run_end, torch.int32),
            )
            plan._dev_args = dev
        return dev

    def _plan_args(self, plan: SegmentPlan):
        """The JAX executor's plan arguments, on the device."""
        return self._device_plan(plan)[:6]

    def top_k(self, plan: SegmentPlan, k: int):
        *args, run_end = self._device_plan(plan)
        fused = score_and_topk(*self._index_args(), *args, run_end=run_end,
                               window_words=self.field.window_words, k=k)
        return unfuse_topk(fused.cpu().numpy(), k)

    def count(self, plan: SegmentPlan) -> int:
        *args, run_end = self._device_plan(plan)
        return int(count_matches(*self._index_args(), *args, run_end=run_end,
                                 window_words=self.field.window_words))

    def batch_args(self, plans: Sequence[SegmentPlan]):
        """The plans stacked [Q, b_pad] on the device, each row padded as
        a plan is (blocks -1, zero weights, flags and run ends), b_pad the
        bucket of the longest: the JAX executor's six arguments (their
        bool_params [Q, 2] last), then run_end."""
        b_pad = _bucket(max(p.b_pad for p in plans))

        def stack(col, fill, dtype):
            out = np.full((len(plans), b_pad), fill, dtype=dtype)
            for i, p in enumerate(plans):
                v = getattr(p, col)
                out[i, : len(v)] = v
            return torch.from_numpy(out).to(self.device)

        return (
            stack("blocks", -1, np.int32),
            *(stack(c, 0.0, np.float32) for c in ("weight", "req", "sho", "neg")),
            self._tensor([[p.num_required, p.min_should] for p in plans],
                         torch.float32),
            stack("run_end", 0, np.int32),
        )

    def top_k_batch(self, plans: Sequence[SegmentPlan], k: int):
        """Run Q plans -> ([Q,k], [Q,k], [Q])."""
        cache_key = tuple(id(p) for p in plans)
        cached = self._batch_cache.get(cache_key)
        if cached is not None:
            dev_args = cached[1]
        else:
            dev_args = self.batch_args(plans)
            if len(self._batch_cache) < 64:
                self._batch_cache[cache_key] = (list(plans), dev_args)
        *args, run_end = dev_args
        fused = score_and_topk_batch(*self._index_args(), *args,
                                     run_end=run_end,
                                     window_words=self.field.window_words, k=k)
        return unfuse_topk(fused.cpu().numpy(), k)
