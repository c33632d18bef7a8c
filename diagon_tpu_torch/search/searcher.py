"""IndexSearcher on one PyTorch device.

Counterpart of ``diagon_tpu/search/searcher.py`` for term, boolean,
range, nested and phrase queries, served by the row engine
(``row_engine.py``): exhaustively, or through the pruned batch route where
the JAX package routes a batch there. A solo ``PhraseQuery`` takes the
direct candidate path (``phrase.py``); a phrase inside a boolean, or in a
batch, is a host row built by ``PhraseExecutor.score_row``. Per-segment
top-k results merge by (score desc, global docid asc), the order of the
reference's ``TopScoreDocCollector``. Queries the row planner rejects
(pure MUST_NOT, unsupported types) take the host oracle, as in the JAX
package. Queries are the port's own classes (``search/query.py``); a JAX
package query raises TypeError (``convert.query_from_jax`` carries one
across). ``search`` times its phases ("phrase", "plan", "execute",
"merge") into the thread's ``QueryProfiler`` when one is enabled, with
"topdocs" once a segment; ``dispatch_batch`` times "plan" and "route" and
``collect_many`` "copy" and "topdocs", once a call (the batch paths build
a batch's TopDocs in one ``top_docs_batch``); the row engine times
"route" (solo), "copy", "finalize" and "escalate" once a segment
(``row_engine.py``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from diagon_tpu_torch.index.segment import SegmentData
from diagon_tpu_torch.observability.profiler import ProfileScope
from diagon_tpu_torch.observability.storage_tiers import (
    StorageTier,
    TierManager,
)
from diagon_tpu_torch.search.bm25 import BM25Similarity
from diagon_tpu_torch.search.device_index import DeviceSegment, load_segment
from diagon_tpu_torch.search.engine import TermPlan, make_tf_table
from diagon_tpu_torch.search.oracle import (
    OracleSearcher,
    double_range_mask,
    numeric_range_mask,
    point_range_mask,
)
from diagon_tpu_torch.search.phrase import PhraseExecutor
from diagon_tpu_torch.search.query import (
    BooleanQuery,
    DoubleRangeQuery,
    MatchAllDocsQuery,
    NumericRangeQuery,
    Occur,
    PhraseQuery,
    PointRangeQuery,
    Query,
    TermQuery,
)
from diagon_tpu_torch.search.row_engine import (
    HEAVY_FRACTION,
    HEAVY_MIN_DF,
    RowExecutor,
    RowFieldIndex,
)
from diagon_tpu_torch.search.topdocs import (ScoreDoc, TopDocs, merge_top_docs,
                                             top_docs_batch)

_RANGEABLE = (NumericRangeQuery, PointRangeQuery, DoubleRangeQuery,
              MatchAllDocsQuery)


def _check_query(query: Query) -> None:
    """Raise on a query (or nested clause) that is not one of the port's
    classes."""
    if not isinstance(query, Query):
        raise TypeError(
            f"{type(query).__module__}.{type(query).__name__} is not a "
            "diagon_tpu_torch query (convert.query_from_jax carries a JAX "
            "package query across)"
        )
    if isinstance(query, BooleanQuery):
        for c in query.clauses:
            _check_query(c.query)


class _FieldContext:
    """Collection-level scoring state for one field: the BM25 tf table and
    one row executor per segment (None where the segment lacks the field
    or is not resident)."""

    def __init__(self, searcher: "IndexSearcher", field: str):
        self.field = field
        # collection stats come from the host segments, so they do not
        # depend on residency (a tier-managed searcher demotes segments)
        stt = 0
        max_freq = 1
        for seg in searcher._host_segments():
            fd = seg.fields.get(field)
            if fd is not None:
                if fd.postings.sum_total_tf > 0:
                    stt += fd.postings.sum_total_tf
                if fd.postings.num_blocks:
                    max_freq = max(
                        max_freq, int(fd.postings.block_max_freq.max())
                    )
        if stt <= 0:
            stt = searcher.max_doc * 10
        self.avgdl = BM25Similarity.avg_field_length(stt, searcher.max_doc)
        self.tf_lut_host = make_tf_table(self.avgdl, max_freq)
        n = len(searcher.device_segments)
        self.row_executors: List[Optional[RowExecutor]] = [None] * n
        for si in range(n):
            self.rebuild_segment(searcher, si)

    def rebuild_segment(self, searcher: "IndexSearcher", si: int) -> None:
        """(Re)build this field's executor for one resident segment, or
        drop it: also the tier-promotion hook."""
        ds = searcher.device_segments[si]
        if ds is None or self.field not in ds.fields:
            self.row_executors[si] = None
            return
        fd = ds.source.fields[self.field]
        pp = fd.postings
        ridx = RowFieldIndex(
            pp, fd.norms, ds.num_docs_pad, ds.source.live_docs,
            self.tf_lut_host, searcher.device,
        )

        def idf_of_tid(tid, _pp=pp, _s=searcher, _f=self.field):
            return _s._idf(_f, _pp.terms[tid], 1.0)

        ridx.build_heavy_bank(idf_of_tid)
        ex = RowExecutor(ridx)
        ex.query_cache = searcher.enable_query_cache
        ex.idf_of_tid = idf_of_tid
        self.row_executors[si] = ex


class IndexSearcher:
    """Searches segments resident on ``device`` (a ``torch.device`` or its
    name; the CUDA card unless the caller names another); everything is
    placed there and nothing picks a device itself.

    ``segments`` is a list of ``SegmentData``, a
    ``diagon_tpu_torch.index.reader.DirectoryReader`` (an index opened from
    disk: ``DirectoryReader.open(FSDirectory(path))``, as the port's
    ``IndexWriter`` or the JAX package's commits it), or the reader's
    ``leaves()``. A segment read from disk keeps its positions undecoded
    until the first phrase query needs them.

    The batch paths (``search_batch``, ``dispatch_batch``) take the
    queries of one field: a batch that spans two fields raises ValueError.

    ``query_cache``: replay the phase-1 state of a re-issued identical batch
    on segments of ``batch_only_min_docs`` or more (the JAX searcher's
    option and default; benchmarks pass False so each batch is rescored).

    ``hbm_budget_bytes``: tier-managed residency, as in the JAX searcher.
    Segments stay host copies and move onto ``device`` through a
    ``TierManager`` that holds them to this many bytes of
    ``_estimate_device_bytes`` (LRU demotion frees a segment's tensors).
    Every query first sweeps the segments onto the device
    (``_ensure_resident``); a segment that does not fit is served exactly
    by the host oracle. ``search_batch`` then falls back to per-query
    ``search``, and ``dispatch_batch`` raises ``MemoryError``. Without a
    budget every segment is placed on ``device`` when the searcher is
    built."""

    def __init__(self, segments, device="cuda", query_cache: bool = True,
                 hbm_budget_bytes: Optional[int] = None):
        # a DirectoryReader, or its leaves() contexts
        if hasattr(segments, "segments_data"):
            segments = segments.segments_data()
        segments = [
            s.reader.data if hasattr(s, "reader") and hasattr(s, "doc_base")
            else s
            for s in segments
        ]
        self.device = torch.device(device)
        self.enable_query_cache = query_cache
        self.sim = BM25Similarity()
        self._field_ctx: Dict[str, _FieldContext] = {}
        self._phrase_execs: Dict[str, list] = {}
        self._idf_cache: Dict[Tuple[str, str, float], np.float32] = {}
        # LRU: plans hold O(D) host rows for range / nested clauses
        self._plan_cache: "OrderedDict[tuple, list]" = OrderedDict()
        self._plan_cache_max = 512
        self._oracle: Optional[OracleSearcher] = None
        self._tier: Optional[TierManager] = None
        if hbm_budget_bytes is not None:
            # tier-managed residency: segments load onto the device lazily
            # through the TierManager (budget + LRU demotion move tensors)
            self._host_segs: List[SegmentData] = [
                s.source if isinstance(s, DeviceSegment) else s
                for s in segments
            ]
            if any(s is None for s in self._host_segs):
                raise ValueError(
                    "tier-managed searcher needs host segment copies"
                )
            self._seg_index = {
                s.name: i for i, s in enumerate(self._host_segs)
            }
            self.device_segments: List[Optional[DeviceSegment]] = [
                None
            ] * len(self._host_segs)
            self._tier = TierManager(
                hbm_budget_bytes,
                promote=self._tier_promote,
                demote_to_host=self._tier_demote,
            )
            for s in self._host_segs:
                self._tier.register(
                    s.name,
                    StorageTier.HOST,
                    bytes_device=self._estimate_device_bytes(s),
                )
            self._ensure_resident()
        else:
            self.device_segments = [
                s if isinstance(s, DeviceSegment)
                else load_segment(s, self.device)
                for s in segments
            ]
        self.doc_bases = np.cumsum([0] + [
            s.num_docs for s in (self._host_segs if self._tier is not None
                                 else self.device_segments)
        ]).tolist()
        self.max_doc = self.doc_bases[-1]

    # -- storage tiers -----------------------------------------------------
    @staticmethod
    def _estimate_device_bytes(seg: SegmentData) -> int:
        """The JAX searcher's footprint estimate of a resident segment
        (packed arrays + norms + positions + the heavy bank with a bf16
        copy, docs padded to 1024), kept formula for formula so that a
        budget makes the same tier decisions in both packages. It is the
        JAX package's device layout, not a measurement of this port's
        tensors on the card."""
        total = 0
        d_pad = max(1024, -(-seg.num_docs // 1024) * 1024)
        for fd in seg.fields.values():
            pp = fd.postings
            total += pp.packed.nbytes + pp.num_blocks * 40
            total += d_pad * 4  # norms widened
            if pp.positions is not None:
                total += pp.positions.nbytes + pp.block_entry_start.nbytes
            threshold = max(HEAVY_MIN_DF, d_pad // HEAVY_FRACTION)
            n_heavy = int((pp.doc_freq >= threshold).sum())
            total += n_heavy * d_pad * 6  # f32 bank + bf16 copy
        return total

    def _tier_promote(self, name: str) -> int:
        si = self._seg_index[name]
        self.device_segments[si] = load_segment(
            self._host_segs[si], self.device
        )
        # rebuild per-field executors for this segment only
        for ctx in self._field_ctx.values():
            ctx.rebuild_segment(self, si)
        self._phrase_execs.clear()
        return self._estimate_device_bytes(self._host_segs[si])

    def _tier_demote(self, name: str) -> None:
        """Drop every holder of the segment's tensors: the DeviceSegment,
        each field's executor (its heavy bank, batch-entry LRU and compact
        banks) and the phrase executors. Cached plans hold host arrays
        only, and are keyed by residency (``_residency``)."""
        si = self._seg_index[name]
        self.device_segments[si] = None
        for ctx in self._field_ctx.values():
            ctx.row_executors[si] = None
        self._phrase_execs.clear()

    def _ensure_resident(self) -> None:
        """Promote segments to DEVICE (LRU-evicting within the budget)
        before executing a query; segments that cannot fit stay HOST and
        are served by the oracle tier (exact, slower)."""
        if self._tier is None:
            return
        for s in self._host_segs:
            try:
                self._tier.ensure_device(s.name)
            except MemoryError:
                pass

    def _residency(self) -> Optional[tuple]:
        """Which segments are resident (None without a tier manager): part
        of every cached plan's key, so a plan built before a promotion or a
        demotion is never served after it (F3: the JAX searcher serves such
        a plan, skipping a segment promoted since or calling the executor
        of one demoted since)."""
        if self._tier is None:
            return None
        return tuple(ds is not None for ds in self.device_segments)

    def _is_host(self, si: int) -> bool:
        """Segment ``si`` is in the HOST tier (demoted or never promoted)."""
        return self._tier is not None and self.device_segments[si] is None

    def _host_segment_dense(self, si: int, query: Query):
        """(scores, live match mask) of one HOST-tier segment, from the
        oracle (exact)."""
        if self._oracle is None:
            self._oracle = OracleSearcher(self._host_segments())
        seg = self._host_segments()[si]
        scores, mask = self._oracle._score_dense(seg, query)
        if seg.live_docs is not None:
            mask = mask & seg.live_docs
        return scores, mask

    def _host_segment_topdocs(self, si: int, query: Query, k: int) -> TopDocs:
        """Score one HOST-tier segment with the oracle (exact)."""
        scores, mask = self._host_segment_dense(si, query)
        docs = np.nonzero(mask)[0]
        sds = sorted(
            (ScoreDoc(int(d) + self.doc_bases[si], float(scores[d]))
             for d in docs),
            key=lambda sd: (-sd.score, sd.doc),
        )[:k]
        return TopDocs(len(docs), sds)

    def tier_stats(self):
        return self._tier.stats() if self._tier is not None else {}

    # -- stats -------------------------------------------------------------
    def _ctx(self, field: str) -> _FieldContext:
        ctx = self._field_ctx.get(field)
        if ctx is None:
            ctx = _FieldContext(self, field)
            self._field_ctx[field] = ctx
        return ctx

    def term_doc_freq(self, field: str, text: str) -> int:
        df = 0
        for seg in self._host_segments():
            fd = seg.fields.get(field)
            if fd is None:
                continue
            tid = fd.postings.term_id(text)
            if tid >= 0:
                df += int(fd.postings.doc_freq[tid])
        return df

    def _idf(self, field: str, text: str, boost: float) -> np.float32:
        key = (field, text, boost)
        v = self._idf_cache.get(key)
        if v is None:
            df = self.term_doc_freq(field, text)
            if df == 0:
                df = max(1, self.max_doc // 10)  # reference fallback
            v = np.float32(self.sim.idf(df, self.max_doc) * np.float32(boost))
            self._idf_cache[key] = v
        return v

    # -- plan construction -------------------------------------------------
    def _any_field(self) -> Optional[str]:
        for seg in self._host_segments():
            for name in seg.fields:
                return name
        return None

    def _term_clauses(
        self, query: Query
    ) -> Optional[Tuple[str, List[Tuple[Query, Occur]], int]]:
        """Flatten into (field, [(clause, occur)], min_should).

        Same-field terms become bank rows; ranges / match-all become host
        indicator rows; nested booleans, phrase clauses and foreign-field
        terms compile to host (score row, match row) pairs. Standalone
        phrase, range and match-all queries arrive as single-SHOULD
        booleans (solo ``search`` sends a phrase to ``_search_phrase``
        first). Returns None when nothing is indexed or nothing can match
        (pure MUST_NOT)."""
        _check_query(query)
        if isinstance(query, TermQuery):
            return query.term.field, [(query, Occur.SHOULD)], 1
        if isinstance(query, PhraseQuery):
            return query.field, [(query, Occur.SHOULD)], 1
        if isinstance(query, _RANGEABLE):
            field = self._any_field()
            if field is None:
                return None
            return field, [(query, Occur.SHOULD)], 1
        if not isinstance(query, BooleanQuery):
            return None
        clauses: List[Tuple[Query, Occur]] = []
        field = None
        for c in query.clauses:
            q = c.query
            if not isinstance(q, (TermQuery, BooleanQuery, PhraseQuery)
                              + _RANGEABLE):
                return None
            if field is None and isinstance(q, TermQuery):
                field = q.term.field
            clauses.append((q, c.occur))
        if field is None:
            field = self._any_field()
        if field is None:
            return None
        min_should = query.minimum_number_should_match
        has_required = any(o in (Occur.MUST, Occur.FILTER) for _, o in clauses)
        has_should = any(o == Occur.SHOULD for _, o in clauses)
        if has_should and not has_required:
            min_should = max(min_should, 1)
        if not has_should and not has_required:
            return None  # pure MUST_NOT: matches nothing; the oracle answers
        return field, clauses, min_should

    @staticmethod
    def _clause_key(q: Query, o: Occur) -> tuple:
        if isinstance(q, TermQuery):
            return (o.value, "T", q.term.field, q.term.text, float(q.boost))
        return (o.value, "Q", repr(q), "", 0.0)

    def _clause_host_row(self, seg: SegmentData, q: Query) -> np.ndarray:
        """Indicator-score row for a range / match-all clause (f32, the
        oracle's exact values: 1.0 at matching docs)."""
        if isinstance(q, MatchAllDocsQuery):
            return np.ones(seg.num_docs, dtype=np.float32)
        if isinstance(q, NumericRangeQuery):
            mask = numeric_range_mask(seg, q.field, q.lower, q.upper)
        elif isinstance(q, PointRangeQuery):
            mask = point_range_mask(seg, q.field, q.lower, q.upper)
        elif isinstance(q, DoubleRangeQuery):
            mask = double_range_mask(
                seg, q.field, q.lower, q.upper,
                q.include_lower, q.include_upper,
            )
        else:
            raise TypeError(f"no host row for {q!r}")
        return mask.astype(np.float32)

    def _oracle_rows(self, si: int, q: Query):
        """(masked score row f32, match row f32) of one clause on one
        segment, with the oracle's exact global-stats arithmetic: the
        compile target of nested booleans, foreign-field terms and phrases
        on another field."""
        if self._oracle is None:
            self._oracle = OracleSearcher(self._host_segments())
        scores, mask = self._oracle._score_dense(self._oracle.segments[si], q)
        return scores, mask.astype(np.float32)

    def _clause_term_plans(
        self, field: str, clauses: List[Tuple[Query, Occur]]
    ) -> List[Optional[List[TermPlan]]]:
        """Per-segment TermPlan lists in oracle accumulation order (MUST,
        FILTER, SHOULD, MUST_NOT, each sorted; non-term clauses sort
        first, stably, as in OracleSearcher._score_boolean)."""

        def _key(item):
            q = item[0]
            return (
                (q.term.field, q.term.text) if isinstance(q, TermQuery)
                else ("", "")
            )

        def group(occur):
            return sorted([c for c in clauses if c[1] == occur], key=_key)

        must, should = group(Occur.MUST), group(Occur.SHOULD)
        filt, must_not = group(Occur.FILTER), group(Occur.MUST_NOT)
        weights = {
            id(q): (
                float(self._idf(field, q.term.text, q.boost))
                if isinstance(q, TermQuery) and q.term.field == field
                else 1.0
            )
            for q, _ in must + should
        }
        out = []
        for si, ds in enumerate(self.device_segments):
            f = ds.fields.get(field) if ds is not None else None
            if f is None:
                out.append(None)
                continue

            def plans_for(q, weight, scoring: bool, **flags):
                """1-2 TermPlans for one clause (an A/B pair when the match
                set can include zero-score docs, i.e. nested booleans)."""
                if isinstance(q, TermQuery) and q.term.field == field:
                    return [TermPlan(f.term_id(q.term.text), weight, **flags)]
                if isinstance(q, _RANGEABLE):
                    row = self._clause_host_row(ds.source, q)
                    return [TermPlan(-1, weight, host_row=row, **flags)]
                if isinstance(q, PhraseQuery) and q.field == field:
                    # the position intersection builds the clause rows,
                    # bit-identical to the oracle's
                    ex = self._phrase_executors(field)[si]
                    if ex is not None:
                        scores, match = ex.score_row(
                            q.terms, self._phrase_idf(q), ds.num_docs
                        )
                        row = scores if scoring else match
                        return [TermPlan(-1, 1.0 if scoring else 0.0,
                                         host_row=row, **flags)]
                scores, match = self._oracle_rows(si, q)
                if isinstance(q, BooleanQuery):
                    # A: score at this clause's position; B: presence
                    plans = []
                    if scoring:
                        plans.append(TermPlan(-1, 1.0, host_row=scores))
                    plans.append(TermPlan(-1, 0.0, host_row=match, **flags))
                    return plans
                # phrase / foreign-field term: score > 0 iff matched, one
                # row serves
                row = scores if scoring else match
                return [TermPlan(-1, 1.0 if scoring else 0.0,
                                 host_row=row, **flags)]

            tps: List[TermPlan] = []
            for q, _ in must:
                tps.extend(plans_for(q, weights[id(q)], True, required=True))
            for q, _ in filt:
                tps.extend(plans_for(q, 0.0, False, required=True))
            for q, _ in should:
                tps.extend(plans_for(q, weights[id(q)], True, should=True))
            for q, _ in must_not:
                tps.extend(plans_for(q, 0.0, False, negated=True))
            out.append(tps)
        return out

    def _query_plans(self, query: Query):
        """(field, per-segment row plans) for a query, or None where
        ``_term_clauses`` gives none; the plans come from ``_row_plans``'
        content-keyed LRU."""
        tc = self._term_clauses(query)
        if tc is None:
            return None
        field, clauses, min_should = tc
        return field, self._row_plans(field, clauses, min_should)

    def _row_plans(self, field: str, clauses, min_should: int):
        cache_key = (
            "row", field,
            tuple(sorted(self._clause_key(q, o) for q, o in clauses)),
            min_should, self._residency(),
        )
        cached = self._plan_cache.get(cache_key)
        if cached is not None:
            self._plan_cache.move_to_end(cache_key)
            return cached
        ctx = self._ctx(field)
        plans = []
        for si, tps in enumerate(self._clause_term_plans(field, clauses)):
            ex = ctx.row_executors[si]
            if tps is None or ex is None:
                plans.append(None)
                continue
            plans.append(ex.build_plan(tps, min_should, ex.idf_of_tid))
        self._plan_cache[cache_key] = plans
        while len(self._plan_cache) > self._plan_cache_max:
            self._plan_cache.popitem(last=False)
        return plans

    # -- public API --------------------------------------------------------
    def search(self, query: Query, k: int = 10) -> TopDocs:
        self._ensure_resident()
        if isinstance(query, PhraseQuery):
            # a solo phrase takes the direct candidate path (no batch to
            # share a row build with)
            with ProfileScope("phrase"):
                return self._search_phrase(query, k)
        with ProfileScope("plan"):
            qp = self._query_plans(query)
        if qp is None:
            return self._fallback_search(query, k)
        field, plans = qp
        ctx = self._ctx(field)
        parts: List[TopDocs] = []
        with ProfileScope("execute"):
            for si, plan in enumerate(plans):
                if plan is None:
                    # tier-demoted segment: serve it from the HOST tier
                    if self._is_host(si):
                        parts.append(self._host_segment_topdocs(si, query, k))
                    continue
                kk = min(k, self.device_segments[si].num_docs_pad)
                scores, docs, hits = ctx.row_executors[si].top_k(plan, kk)
                with ProfileScope("topdocs"):
                    parts.append(self._to_topdocs(si, scores, docs, hits))
        with ProfileScope("merge"):
            return merge_top_docs(parts, k)

    def search_batch(self, queries: Sequence[Query], k: int = 10) -> List[TopDocs]:
        """A batch of queries of one field, one kernel launch per segment
        (and query chunk); results equal per-query ``search``. It is
        ``collect_batch(dispatch_batch(...))``, or per-query ``search``
        where a segment is HOST-tier."""
        self._ensure_resident()
        if any(self._is_host(si) for si in range(len(self.device_segments))):
            # the working set exceeds the device budget: the per-query
            # path serves the HOST-tier segments
            return [self.search(q, k) for q in queries]
        return self.collect_batch(self.dispatch_batch(queries, k))

    def dispatch_batch(self, queries: Sequence[Query], k: int = 10):
        """Launch a batch without waiting for it: returns an opaque handle
        for ``collect_many`` / ``collect_batch``. The fused rows stay on
        the device and nothing synchronises here. A tier-managed searcher
        whose segments do not all fit its budget raises MemoryError; an
        empty batch, an unsupported query or a batch of more than one
        field raises ValueError (deliberate deviation: the JAX package
        scores every query of a batch against its first query's field)."""
        self._ensure_resident()
        if any(self._is_host(si) for si in range(len(self.device_segments))):
            raise MemoryError(
                "dispatch_batch requires the full working set resident; "
                "the device budget is too small for these segments"
            )
        flat = []
        with ProfileScope("plan"):
            for q in queries:
                qp = self._query_plans(q)
                if qp is None:
                    raise ValueError(f"dispatch_batch: unsupported query {q!r}")
                flat.append(qp)
        fields = {f for f, _ in flat}
        if len(fields) != 1:
            raise ValueError("dispatch_batch requires a single field per batch")
        ctx = self._ctx(fields.pop())
        handles = []
        with ProfileScope("route"):
            for si, ds in enumerate(self.device_segments):
                ex = ctx.row_executors[si]
                if ex is None:
                    continue
                plans = [seg_plans[si] for _, seg_plans in flat]
                kk = min(k, ds.num_docs_pad)
                handles.append((si, kk, ex.dispatch(plans, kk), ex, plans))
        return (len(queries), k, handles)

    def collect_many(self, handles) -> List[List[TopDocs]]:
        """Resolve many dispatch_batch handles with one device->host copy
        of their concatenated fused rows."""
        all_fused = [f for _, _, parts in handles for _, _, f, _, _ in parts]
        if not all_fused:
            return [self.collect_batch(h) for h in handles]
        with ProfileScope("copy"):
            stacked = torch.cat([f.reshape(-1) for f in all_fused]).cpu().numpy()
        out: List[List[TopDocs]] = []
        pos = 0
        for nq, k, parts in handles:
            rows = []
            for si, kk, f, ex, plans in parts:
                n = f.numel()
                flat = stacked[pos : pos + n].reshape(tuple(f.shape))
                pos += n
                rows.append((*ex.finalize(plans, flat, kk), self.doc_bases[si]))
            with ProfileScope("topdocs"):
                out.append(self._batch_topdocs(nq, rows, k))
        return out

    def collect_batch(self, handle) -> List[TopDocs]:
        """Resolve one dispatch_batch handle into per-query TopDocs."""
        nq, k, parts_h = handle
        rows = [(*ex.finalize(plans, fused, kk), self.doc_bases[si])
                for si, kk, fused, ex, plans in parts_h]
        return self._batch_topdocs(nq, rows, k)

    def count(self, query: Query) -> int:
        self._ensure_resident()
        # O(1) fast paths with no deletes (reference Weight::count): a
        # term's count is its docFreq and match-all is maxDoc
        if all(s.live_docs is None for s in self._host_segments()):
            if isinstance(query, TermQuery):
                return self.term_doc_freq(query.term.field, query.term.text)
            if isinstance(query, MatchAllDocsQuery):
                return self.max_doc
        qp = self._query_plans(query)
        if qp is None:
            return self._fallback_count(query)
        field, plans = qp
        ctx = self._ctx(field)
        total = 0
        for si, plan in enumerate(plans):
            if plan is None:
                if self._is_host(si):
                    total += int(self._host_segment_dense(si, query)[1].sum())
                continue
            total += ctx.row_executors[si].count(plan)
        return total

    # -- phrase ------------------------------------------------------------
    def _phrase_executors(self, field: str) -> List[Optional[PhraseExecutor]]:
        """One PhraseExecutor per segment (None where the field is absent
        or was indexed without positions)."""
        execs = self._phrase_execs.get(field)
        if execs is None:
            ctx = self._ctx(field)
            execs = []
            for ds in self.device_segments:
                ex = None
                if ds is not None and field in ds.fields:
                    try:
                        ex = PhraseExecutor(ds, field, ctx.tf_lut_host)
                    except ValueError:  # no positions
                        ex = None
                execs.append(ex)
            self._phrase_execs[field] = execs
        return execs

    def _phrase_idf(self, query: PhraseQuery) -> float:
        """idf from the rarest member term (PhraseQuery.cpp:304-338)."""
        min_df = self.max_doc
        for t in query.terms:
            df = self.term_doc_freq(query.field, t)
            if df > 0:
                min_df = min(min_df, df)
        if min_df <= 0:
            min_df = 1
        return float(
            self.sim.idf(min_df, self.max_doc) * np.float32(query.boost)
        )

    def _search_phrase(self, query: PhraseQuery, k: int) -> TopDocs:
        self._ensure_resident()
        execs = self._phrase_executors(query.field)
        idf = self._phrase_idf(query)
        parts: List[TopDocs] = []
        for si, ex in enumerate(execs):
            if ex is None:
                if (self._is_host(si)
                        and query.field in self._host_segments()[si].fields):
                    parts.append(self._host_segment_topdocs(si, query, k))
                continue
            res = ex.top_k(query.terms, idf, k)
            if res is None:
                continue
            scores, docs, hits = res
            parts.append(self._to_topdocs(si, scores, docs, hits))
        return merge_top_docs(parts, k)

    # -- host oracle route -------------------------------------------------
    def _host_segments(self) -> List[SegmentData]:
        if self._tier is not None:
            return self._host_segs
        segs = [ds.source for ds in self.device_segments]
        if any(seg is None for seg in segs):
            raise RuntimeError(
                "host fallback requires segments loaded with keep_source=True"
            )
        return segs

    def _fallback_search(self, query: Query, k: int) -> TopDocs:
        return OracleSearcher(self._host_segments()).search(query, k)

    def _fallback_count(self, query: Query) -> int:
        return OracleSearcher(self._host_segments()).count(query)

    # -- helpers -----------------------------------------------------------
    @staticmethod
    def _batch_topdocs(nq: int, rows, k: int) -> List[TopDocs]:
        """The batch paths' TopDocs: ``top_docs_batch`` over one
        ``(scores, docs, hits, doc_base)`` a segment; none where no
        segment holds the batch's field."""
        if not rows:
            return [TopDocs(0, []) for _ in range(nq)]
        return top_docs_batch(rows, k)

    def _to_topdocs(self, si: int, scores, docs, hits) -> TopDocs:
        hits = int(hits)
        base = self.doc_bases[si]
        sds = [
            ScoreDoc(int(d) + base, float(s))
            for s, d in zip(np.asarray(scores), np.asarray(docs))
            if s >= 0.0
        ][:hits]
        return TopDocs(hits, sds)
