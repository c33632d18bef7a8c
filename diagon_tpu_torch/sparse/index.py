"""Quantized sparse-vector index and its searcher on one PyTorch device:
the port of ``diagon_tpu/sparse/index.py``.

Build: per term, (doc, weight) postings; weights quantize to 8-bit bins
with a per-term scale (``bin = round(w / scale)``, ``scale = max_w / 255``),
the QBlock quantization idea (reference ``QBlockIndex.h:20-48``) applied to
the Sindi block layout (``SindiIndex.h:20-70``). Bins ride the packed block
format's freq lanes.

Search: score = sum_t q_w[t] * scale[t] * bin, run by the row engine that
serves text queries, with

- per-clause weight = q_w[t] * scale[t] (one f32 multiply),
- norms all zero (so the LUT row is row 0),
- tf LUT row 0 the identity: lut[bin] = bin,

so a clause row is exactly ``weight * bin``, the quantized oracle's
arithmetic. Quantization error is <= scale/2 per posting (a documented
approximation, as in the reference's quantized indexes); ``search_rerank``
and ``search_exact`` give the exact dot product.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from diagon_tpu_torch.codecs.postings import (
    build_packed_postings_csr,
    decode_block_numpy,
)
from diagon_tpu_torch.index.segment import SegmentData, SegmentFieldData
from diagon_tpu_torch.observability.metrics import registry
from diagon_tpu_torch.observability.profiler import ProfileScope
from diagon_tpu_torch.search.row_engine import (
    RowExecutor,
    RowFieldIndex,
    RowPlan,
    _bucket_tq,
)
from diagon_tpu_torch.sparse.vector import SparseVector

NUM_BINS = 255

_PLANNED = registry.counter("search.sparse_plans_batched",
                            "queries whose row plans the sparse batch pass "
                            "built")


class SparseIndex:
    """Immutable quantized sparse index over a corpus of sparse vectors."""

    def __init__(self, seg: SegmentData, scales: Dict[str, float],
                 exact: Optional[Dict[str, Tuple[np.ndarray, np.ndarray]]]
                 = None):
        self.segment = seg
        self.scales = scales
        self.num_docs = seg.num_docs
        # exact per-term CSR (docs i32 asc, weights f32): the SindiIndex
        # role (reference SindiIndex.h:20-70 is exact accumulation), read
        # by the exact search mode and the rerank stage
        self.exact = exact or {}

    @staticmethod
    def build(vectors: Sequence[SparseVector],
              name: str = "_sparse") -> "SparseIndex":
        """The index of one document a vector: their CSR, built by
        ``from_csr``."""
        n = len(vectors)
        counts = np.fromiter(
            (len(v.ids) for v in vectors), dtype=np.int64, count=n
        )
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        ids = (
            np.concatenate([np.asarray(v.ids, np.int64) for v in vectors])
            if n else np.zeros(0, np.int64)
        )
        values = (
            np.concatenate([np.asarray(v.values, np.float32)
                            for v in vectors])
            if n else np.zeros(0, np.float32)
        )
        return SparseIndex.from_csr(indptr, ids, values, name)

    @staticmethod
    def from_csr(indptr, ids, values, name: str = "_sparse") -> "SparseIndex":
        """Vectorised build from a document-major CSR: document d holds the
        term ids ``ids[indptr[d]:indptr[d + 1]]`` (unique within the
        document) with f32 weights ``values``. One stable sort groups the
        postings by term, in the string order of the term keys (the JAX
        package's ``build_packed_postings`` sorts its keys as strings), so
        the packed blocks are the JAX package's; per-term scales and bins
        are segmented numpy reductions with the JAX per-term loop's
        arithmetic."""
        indptr = np.asarray(indptr, np.int64)
        terms = np.asarray(ids, np.int64)
        weights = np.asarray(values, np.float32)
        n = len(indptr) - 1
        doc_ids = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
        if len(terms) and terms.min() >= 0 and terms.max() < 1 << 24:
            # np.unique's result without its sort of every posting
            present = np.zeros(int(terms.max()) + 1, bool)
            present[terms] = True
            uniq = np.flatnonzero(present)
            term_of = (np.cumsum(present) - 1)[terms]
        else:
            uniq, term_of = np.unique(terms, return_inverse=True)
        keys = [str(int(t)) for t in uniq]
        by_key = sorted(range(len(keys)), key=keys.__getitem__)
        rank = np.empty(len(keys), np.int64)
        rank[by_key] = np.arange(len(keys))
        ent_term = rank[term_of]
        T = len(keys)
        # doc order per term; 16-bit keys take numpy's radix sort
        order = np.argsort(
            ent_term.astype(np.uint16) if T <= 1 << 16 else ent_term,
            kind="stable")
        ent_term = ent_term[order]
        docs, ws = doc_ids[order], weights[order]
        entry_start = np.zeros(T + 1, np.int64)
        np.cumsum(np.bincount(ent_term, minlength=T), out=entry_start[1:])

        max_w = (np.maximum.reduceat(ws, entry_start[:-1]) if T
                 else np.zeros(0, np.float32))
        scale = max_w.astype(np.float64) / NUM_BINS  # Python-float division
        scale[scale <= 0] = 1.0
        bins = np.clip(
            np.round(ws / scale.astype(np.float32)[ent_term]), 1, NUM_BINS
        ).astype(np.int64)

        sorted_keys = [keys[i] for i in by_key]
        pp = build_packed_postings_csr(sorted_keys, entry_start, docs, bins)
        pp.doc_count_with_field = n
        scales: Dict[str, float] = {}
        exact: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        docs32 = docs.astype(np.int32)
        for r, key in enumerate(sorted_keys):
            lo, hi = int(entry_start[r]), int(entry_start[r + 1])
            scales[key] = float(scale[r])
            exact[key] = (docs32[lo:hi], ws[lo:hi])
        seg = SegmentData(name=name, num_docs=n)
        seg.fields["_sparse"] = SegmentFieldData(
            postings=pp,
            norms=np.zeros(n, dtype=np.uint8),
            with_positions=False,
        )
        return SparseIndex(seg, scales, exact)

    def dequantized_weight(self, term: int, bin_value: int) -> float:
        return self.scales[str(term)] * bin_value


class SparseSearcher:
    """Row-engine executor for a SparseIndex on ``device`` (the CUDA card
    unless the caller names another), approximate to the quantization.

    Each query term is a (tid, weight) light entry that the batch entry
    decodes on the device into a row of dequantized partial products
    (weight * bin, the identity LUT and all-zero norms), exactly the
    quantized oracle's arithmetic; the device sums rows and takes the
    top-k.

    The zero ``[1, D]`` heavy bank and its tile aux switch the pruned
    routes on, as in the JAX searcher: batches take the batch route, and a
    solo query (its plan is pure OR: no padding clauses) on a segment of
    ``prune_solo_min_docs`` padded docs or more takes the small-batch
    tile-UB route.

    Counter: ``search.sparse_plans_batched``, the queries whose plans
    ``_plan_batch`` built (a batch's queries, or 1 a solo search)."""

    def __init__(self, index: SparseIndex, device="cuda"):
        self.index = index
        seg = index.segment
        fd = seg.fields["_sparse"]
        pp = fd.postings
        F = int(pp.block_max_freq.max(initial=1)) + 1
        lut = np.tile(np.arange(F, dtype=np.float32), 128)
        # a 1024 multiple: the row kernels' D granule and the pruned
        # route's tiles; live masks exclude the pad docs
        num_docs_pad = max(1024, ((seg.num_docs + 1023) // 1024) * 1024)
        ridx = RowFieldIndex(
            pp, fd.norms, num_docs_pad, seg.live_docs, lut, device
        )
        # no idf-scaled heavy rows (weights are query-dependent): every
        # clause is a light entry of the batch-compact bank. The zero
        # heavy bank and its tile aux turn the pruned routes on.
        ridx.heavy_row_of_term = np.full(pp.num_terms, -1, np.int32)
        ridx.set_heavy_bank(torch.zeros(
            (1, num_docs_pad), dtype=torch.float32, device=ridx.device
        ))
        self.executor = RowExecutor(ridx)
        self.pp = pp
        self.num_docs_pad = num_docs_pad
        # clause lookup (every key is str(int)): a dense table from id to
        # term id over the ids in [0, 2**24), -1 where no term has the id,
        # and a dict for any other key; each term's scale in f32
        key_ids = np.asarray([int(t) for t in pp.terms], np.int64)
        dense = (key_ids >= 0) & (key_ids < 1 << 24)
        self._tid_of_id = np.full(int(key_ids[dense].max(initial=0)) + 1,
                                  -1, np.int32)
        self._tid_of_id[key_ids[dense]] = np.flatnonzero(dense)
        self._tid_of_other = {int(key_ids[t]): int(t)
                              for t in np.flatnonzero(~dense)}
        self._scale_f32 = np.asarray(
            [index.scales[t] for t in pp.terms], np.float64
        ).astype(np.float32)

    def _term_ids(self, ids: np.ndarray) -> np.ndarray:
        """Term id of each id, -1 where no term has it: the
        ``pp.term_id(str(int(t)))`` of each, by table lookup."""
        size = len(self._tid_of_id)
        tid = self._tid_of_id[np.clip(ids, 0, size - 1)]
        outside = (ids < 0) | (ids >= size)
        tid[outside] = -1
        if self._tid_of_other:
            for j in np.flatnonzero(outside).tolist():
                tid[j] = self._tid_of_other.get(int(ids[j]), -1)
        return tid

    def _plan(self, query: SparseVector, alpha: float = 1.0):
        """The solo plan: ``_plan_batch`` of the one query, unpadded (its
        clauses fill a ``_bucket_tq`` of their count, and it is pure OR
        unless a clause weight is 0); None if no id is in the index."""
        return self._plan_batch([query], pad=False, alpha=alpha)[0]

    def search(self, query: SparseVector, k: int = 10, alpha: float = 1.0):
        """Top-k docs by quantized dot product -> (scores, docids, hits).
        ``alpha`` < 1 prunes low-gain clauses (QBlock-style, approximate)."""
        plan = self._plan(query, alpha=alpha)
        if plan is None:
            return np.zeros(0, np.float32), np.zeros(0, np.int32), 0
        scores, docs, hits = self.executor.top_k(
            plan, min(k, self.num_docs_pad)
        )
        n = min(int(hits), k)
        return scores[:n], docs[:n], int(hits)

    # -- exact paths (the SindiIndex role + BlockMaxQuantizedIndex rerank) --
    def _exact_rescore(self, query: SparseVector, cands: np.ndarray):
        """Exact f32 dot products for candidate docs, terms accumulated in
        ascending term-id order (the deterministic contract; matches
        search_exact brute force bit for bit)."""
        order = np.argsort(np.asarray(query.ids, dtype=np.int64))
        out = np.zeros(len(cands), dtype=np.float32)
        for j in order:
            key = str(int(query.ids[j]))
            e = self.index.exact.get(key)
            if e is None:
                continue
            docs_t, w_t = e
            loc = np.searchsorted(docs_t, cands)
            loc_c = np.minimum(loc, len(docs_t) - 1)
            hit = docs_t[loc_c] == cands
            contrib = np.where(
                hit, np.float32(query.values[j]) * w_t[loc_c], np.float32(0)
            ).astype(np.float32)
            out = (out + contrib).astype(np.float32)
        return out

    def _half_width(self, query: SparseVector) -> np.float32:
        """hw = 0.5 * sum_t q_w[t] * scale[t]: the largest gap between a
        doc's exact and quantized scores."""
        hw = np.float32(0.0)
        for t, w in zip(query.ids, query.values):
            s = self.index.scales.get(str(int(t)))
            if s is not None:
                hw += np.float32(0.5) * np.float32(w) * np.float32(s)
        return hw

    def search_rerank(
        self, query: SparseVector, k: int = 10, R: int = 4096
    ):
        """Exact top-k via quantized candidate selection + exact rescore
        (the reference BlockMaxQuantizedIndex rerank stage,
        BlockMaxQuantizedIndex.h:13-56) with an exactness certificate:

        per-doc |exact - quantized| <= hw = 0.5 * sum_t q_w[t]*scale[t],
        so if the exact k-th candidate score clears the quantized score of
        the first EXCLUDED candidate plus hw, no excluded doc can enter
        the top k; otherwise escalate R (up to the full match set), so
        recall is always 1.0.
        """
        hw = self._half_width(query)
        while True:
            RR = min(max(R, k), self.num_docs_pad)
            qs, qd, hits = self.search(query, k=RR)
            if len(qd) == 0:
                return qs[:k], qd[:k], hits
            exact = self._exact_rescore(query, qd)
            order = np.lexsort((qd, -exact))[: min(k, len(qd))]
            top_docs = qd[order]
            top_scores = exact[order]
            covered = len(qd) >= hits  # every matching doc was rescored
            if not covered:
                theta = top_scores[-1] if len(top_scores) >= k else None
                q_excl_upper = qs[-1] + hw  # quantized scores descend
                if theta is None or not (theta > q_excl_upper):
                    R = RR * 4
                    continue
            return top_scores, top_docs, int(hits)

    def search_rerank_batch(
        self, queries: Sequence[SparseVector], k: int = 10, R: int = 1024
    ):
        """Batched exact top-k: one quantized batch at k=R, host exact
        rescore per query, the same certificate as search_rerank, and
        per-query escalation (rare) only for queries the certificate
        cannot clear. Returns a list of (scores, docids, hits)."""
        RR = min(max(R, k), self.num_docs_pad)
        qres = self.search_batch(queries, RR)
        out = []
        for q, (qs, qd, hits) in zip(queries, qres):
            if len(qd) == 0:
                out.append((qs[:k], qd[:k], hits))
                continue
            hw = self._half_width(q)
            exact = self._exact_rescore(q, qd)
            order = np.lexsort((qd, -exact))[: min(k, len(qd))]
            top_docs, top_scores = qd[order], exact[order]
            covered = len(qd) >= hits
            if not covered:
                theta = top_scores[-1] if len(top_scores) >= k else None
                if theta is None or not (theta > qs[-1] + hw):
                    out.append(self.search_rerank(q, k, R=RR * 4))
                    continue
            out.append((top_scores, top_docs, int(hits)))
        return out

    def search_exact(self, query: SparseVector, k: int = 10):
        """Brute-force exact search (test oracle for the rerank path)."""
        scores = np.zeros(self.index.num_docs, dtype=np.float32)
        matched = np.zeros(self.index.num_docs, dtype=bool)
        order = np.argsort(np.asarray(query.ids, dtype=np.int64))
        for j in order:
            key = str(int(query.ids[j]))
            e = self.index.exact.get(key)
            if e is None:
                continue
            docs_t, w_t = e
            scores[docs_t] = (
                scores[docs_t] + np.float32(query.values[j]) * w_t
            ).astype(np.float32)
            matched[docs_t] = True
        idx = np.lexsort((np.arange(len(scores)), -scores))
        idx = [d for d in idx if matched[d]][:k]
        return (
            scores[idx].astype(np.float32),
            np.asarray(idx, np.int32),
            int(matched.sum()),
        )

    def _plan_batch(self, queries: Sequence[SparseVector], pad: bool = True,
                    alpha: float = 1.0):
        """The queries' row plans, built from whole-batch arrays.

        Each query's ids go through one table lookup (``_term_ids``);
        an id that no term has is dropped. A clause's weight is
        ``f32(q_w) * f32(scale)``, one f32 multiply; it scores where it is
        not 0, and its light entry is ``(tid, weight)``, or ``(tid, 1.0)``
        for a weight of 0. Clauses keep the query's id order, one light
        row each (no heavy row: the bank is zero), all SHOULD, with
        ``num_required`` 0 and ``min_should`` 1.

        Padding: with ``pad``, every plan is ``pad_to`` =
        ``_bucket_tq(longest query)`` clauses wide, its slots past its
        present clauses padding (no row, no role); a plan is pure OR only
        where it needs no padding slot and no weight is 0. Without ``pad``
        a plan is ``_bucket_tq`` of its present clauses wide and pure OR
        unless a weight is 0; a query with no present clause has no plan
        (None).

        alpha < 1 enables QBlock-style gain selection (reference
        ``QBlockIndex.h:20-48``), query by query: clauses sort stably by
        their score upper bound (q_w * scale * 255 = q_w * max stored
        weight), descending, and only the shortest prefix whose bound,
        summed in that order, reaches ``alpha`` of the total is scored, a
        documented approximation on top of the quantization."""
        nq = len(queries)
        lens = np.fromiter((len(q) for q in queries), np.int64, nq)
        pad_to = _bucket_tq(max(int(lens.max(initial=0)), 1)) if pad else 0
        _PLANNED.increment(nq)
        tid = self._term_ids(np.concatenate([q.ids for q in queries]))
        present = tid >= 0
        tid = tid[present]
        qof = np.repeat(np.arange(nq), lens)[present]
        weight = (np.concatenate([q.values for q in queries])[present]
                  * self._scale_f32[tid])
        n = np.bincount(qof, minlength=nq)
        start = np.zeros(nq + 1, np.int64)
        np.cumsum(n, out=start[1:])
        if alpha < 1.0:
            sel = []
            for s, e in zip(start[:-1].tolist(), start[1:].tolist()):
                if s == e:
                    continue
                ub = weight[s:e].astype(np.float64) * NUM_BINS
                order = np.argsort(-ub, kind="stable")
                acc = np.cumsum(ub[order])
                reach = np.flatnonzero(acc >= alpha * acc[-1])
                sel.append(s + order[: reach[0] + 1 if len(reach) else e - s])
            sel = np.concatenate(sel) if sel else np.zeros(0, np.int64)
            tid, qof, weight = tid[sel], qof[sel], weight[sel]
            n = np.bincount(qof, minlength=nq)
            np.cumsum(n, out=start[1:])
        slot = np.arange(len(tid)) - start[qof]
        widths = [_bucket_tq(max(c, pad_to)) for c in n.tolist()]
        tq = max(widths)
        hidx = np.full((nq, tq), -1, np.int32)
        lidx = np.zeros((nq, tq), np.int32)
        scoring = np.zeros((nq, tq), bool)
        req = np.zeros((nq, tq), np.float32)
        sho = np.zeros((nq, tq), np.float32)
        neg = np.zeros((nq, tq), np.float32)
        lidx[qof, slot] = slot + 1
        nonzero = weight != 0
        scoring[qof, slot] = nonzero
        sho[qof, slot] = 1.0
        zero_w = np.bincount(qof[~nonzero], minlength=nq)
        pure_or = ((n >= pad_to) & (zero_w == 0)).tolist()
        entries = list(zip(tid.tolist(),
                           np.where(nonzero, weight, np.float32(1.0))))
        plans = []
        for q, (s, e, w) in enumerate(zip(start[:-1].tolist(),
                                          start[1:].tolist(), widths)):
            if s == e and not pad_to:
                plans.append(None)
                continue
            plans.append(RowPlan(
                hidx[q, :w], entries[s:e], lidx[q, :w], scoring[q, :w],
                req[q, :w], sho[q, :w], neg[q, :w], 0, 1, pure_or[q],
            ))
        return plans

    def dispatch_batch(self, queries: Sequence[SparseVector], k: int = 10):
        """Launch a batch without waiting for it; returns a handle for
        collect_batch (a serving loop chains batches with no device->host
        round trip between them). Spans: ``plan`` (the row plans) and
        ``route`` (the row engine's dispatch)."""
        with ProfileScope("plan"):
            plans = self._plan_batch(queries)
        live = [p for p in plans if p is not None]
        kk = min(k, self.num_docs_pad)
        fused = None
        if live:
            with ProfileScope("route"):
                fused = self.executor.dispatch(live, kk)
        return (plans, live, fused, k, kk)

    def collect_batch(self, handle):
        plans, live, fused, k, kk = handle
        out = []
        if live:
            scores, docs, hits = self.executor.finalize(live, fused, kk)
        li = 0
        for p in plans:
            if p is None:
                out.append(
                    (np.zeros(0, np.float32), np.zeros(0, np.int32), 0)
                )
            else:
                n = min(int(hits[li]), k)
                out.append((scores[li][:n], docs[li][:n], int(hits[li])))
                li += 1
        return out

    def search_batch(self, queries: Sequence[SparseVector], k: int = 10):
        """Batched top-k: list of (scores, docids, hits) per query."""
        return self.collect_batch(self.dispatch_batch(queries, k))

    def search_oracle(self, query: SparseVector, k: int = 10):
        """Exact numpy scoring of the QUANTIZED index (test oracle)."""
        pp = self.index.segment.fields["_sparse"].postings
        scores = np.zeros(self.index.num_docs, dtype=np.float32)
        matched = np.zeros(self.index.num_docs, dtype=bool)
        for t, w in zip(query.ids, query.values):
            key = str(int(t))
            tid = pp.term_id(key)
            if tid < 0:
                continue
            weight = np.float32(
                np.float32(w) * np.float32(self.index.scales[key])
            )
            for b in range(int(pp.block_start[tid]),
                           int(pp.block_start[tid + 1])):
                docs, bins = decode_block_numpy(pp, b)
                scores[docs] += weight * bins.astype(np.float32)
                matched[docs] = True
        order = np.lexsort((np.arange(len(scores)), -scores))
        order = [d for d in order if matched[d]][:k]
        return scores[order], np.asarray(order, np.int32), int(matched.sum())
