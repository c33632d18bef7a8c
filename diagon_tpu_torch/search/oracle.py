"""NumPy oracle searcher: the port's own copy of
``diagon_tpu/search/oracle.py``.

The trusted reference implementation every device kernel is tested against —
the role Lucene plays for the C++ reference (SURVEY.md section 4 "golden
comparison"). Operates on flushed :class:`SegmentData` by decoding the packed
posting blocks with the numpy decoder, so oracle runs also exercise the
storage format.

Scoring semantics follow the reference exactly (see ``bm25.py``); per-doc
disjunction sums accumulate in ascending term order in float32, mirroring
the deterministic device accumulation order.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from diagon_tpu_torch.codecs.postings import decode_blocks_numpy
from diagon_tpu_torch.index.segment import SegmentData
from diagon_tpu_torch.search.bm25 import BM25Similarity
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
from diagon_tpu_torch.search.topdocs import ScoreDoc, TopDocs


def numeric_range_mask(seg: SegmentData, field: str, lower, upper) -> np.ndarray:
    """bool [num_docs]: docs with a NUMERIC/SORTED_NUMERIC doc value in
    [lower, upper] (inclusive; None = open). Shared by oracle + device."""
    mask = np.zeros(seg.num_docs, dtype=bool)
    dv = seg.doc_values.get(field)
    if dv is None:
        return mask
    vals = dv.values
    ok = np.ones(len(vals), dtype=bool)
    if lower is not None:
        ok &= vals >= lower
    if upper is not None:
        ok &= vals <= upper
    if dv.value_start is None:
        mask[dv.docs[ok]] = True
    else:
        # multi-valued CSR: a doc matches if ANY of its values matches
        starts = dv.value_start
        if len(dv.docs):
            doc_ok = np.add.reduceat(ok.astype(np.int64), starts[:-1]) > 0
            mask[dv.docs[doc_ok]] = True
    return mask


def double_range_mask(
    seg: SegmentData,
    field: str,
    lower,
    upper,
    include_lower: bool = True,
    include_upper: bool = True,
) -> np.ndarray:
    """bool [num_docs]: docs whose DOUBLE doc value (stored as the
    double's int64 bit pattern, reference ``diagon_c_api.cpp:441``) is
    in the given open/closed range (``DoubleRangeQuery.cpp`` scorer)."""
    mask = np.zeros(seg.num_docs, dtype=bool)
    dv = seg.doc_values.get(field)
    if dv is None:
        return mask
    vals = dv.values.view(np.float64)
    ok = np.ones(len(vals), dtype=bool)
    if lower is not None:
        ok &= (vals >= lower) if include_lower else (vals > lower)
    if upper is not None:
        ok &= (vals <= upper) if include_upper else (vals < upper)
    if dv.value_start is None:
        mask[dv.docs[ok]] = True
    else:
        starts = dv.value_start
        if len(dv.docs):
            doc_ok = np.add.reduceat(ok.astype(np.int64), starts[:-1]) > 0
            mask[dv.docs[doc_ok]] = True
    return mask


def point_range_mask(seg: SegmentData, field: str, lower, upper) -> np.ndarray:
    """bool [num_docs]: docs with a 1-D point value in [lower, upper]."""
    mask = np.zeros(seg.num_docs, dtype=bool)
    pt = seg.points.get(field)
    if pt is None:
        return mask
    lo = (
        np.searchsorted(pt.values, lower, side="left")
        if lower is not None
        else 0
    )
    hi = (
        np.searchsorted(pt.values, upper, side="right")
        if upper is not None
        else len(pt.values)
    )
    mask[pt.docs[lo:hi]] = True
    return mask


class OracleSearcher:
    """Exhaustive host searcher over a list of segments."""

    def __init__(self, segments: Sequence[SegmentData]):
        self.segments = list(segments)
        self.doc_bases = np.cumsum(
            [0] + [s.num_docs for s in self.segments]
        ).tolist()
        self.max_doc = self.doc_bases[-1]
        self.sim = BM25Similarity()

    # -- collection stats (TermQuery.cpp:184-260 aggregation) -------------
    def field_stats(self, field: str) -> Tuple[int, int]:
        """(sumTotalTermFreq, sumDocFreq) across segments."""
        stt, sdf = 0, 0
        for seg in self.segments:
            fd = seg.fields.get(field)
            if fd is None:
                continue
            if fd.postings.sum_total_tf > 0:
                stt += fd.postings.sum_total_tf
            if fd.postings.sum_doc_freq > 0:
                sdf += fd.postings.sum_doc_freq
        if stt <= 0:
            stt = self.max_doc * 10
        if sdf <= 0:
            sdf = self.max_doc
        return stt, sdf

    def term_doc_freq(self, field: str, text: str) -> int:
        df = 0
        for seg in self.segments:
            fd = seg.fields.get(field)
            if fd is None:
                continue
            tid = fd.postings.term_id(text)
            if tid >= 0:
                df += int(fd.postings.doc_freq[tid])
        return df

    def _sim_scorer(self, field: str, text: str, boost: float):
        stt, _ = self.field_stats(field)
        avgdl = BM25Similarity.avg_field_length(stt, self.max_doc)
        df = self.term_doc_freq(field, text)
        if df == 0:
            # Reference fallback (TermQuery.cpp:249-253); matches no docs
            # anyway, so the value only matters for never-taken branches.
            df = max(1, self.max_doc // 10)
        idf = self.sim.idf(df, self.max_doc) * np.float32(boost)
        return self.sim.scorer(idf, avgdl)

    # -- per-segment postings --------------------------------------------
    @staticmethod
    def _term_postings(
        seg: SegmentData, field: str, text: str
    ) -> Tuple[np.ndarray, np.ndarray]:
        fd = seg.fields.get(field)
        if fd is None:
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        pp = fd.postings
        tid = pp.term_id(text)
        if tid < 0:
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        return decode_blocks_numpy(
            pp, int(pp.block_start[tid]), int(pp.block_start[tid + 1])
        )

    @staticmethod
    def _term_positions(
        seg: SegmentData, field: str, text: str
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(docids, every position of the term, the docid of each
        position) for a term; positions in posting order."""
        empty = np.zeros(0, np.int32)
        fd = seg.fields.get(field)
        if fd is None or not fd.postings.has_positions:
            return empty, empty, empty
        pp = fd.postings
        pp.ensure_positions()
        tid = pp.term_id(text)
        if tid < 0:
            return empty, empty, empty
        b0, b1 = int(pp.block_start[tid]), int(pp.block_start[tid + 1])
        docs, _ = decode_blocks_numpy(pp, b0, b1)
        e0 = int(pp.block_entry_start[b0])
        bounds = pp.pos_start[e0:e0 + len(docs) + 1].astype(np.int64)
        per_doc = np.diff(bounds)
        at = np.arange(int(per_doc.sum()), dtype=np.int64)
        at += np.repeat(bounds[:-1] - (np.cumsum(per_doc) - per_doc), per_doc)
        return docs, pp.positions[at], np.repeat(docs, per_doc)

    # -- scoring -----------------------------------------------------------
    def _score_dense(
        self, seg: SegmentData, query: Query
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(scores f32 [num_docs], match mask bool [num_docs]) for a segment."""
        n = seg.num_docs
        if isinstance(query, TermQuery):
            scorer = self._sim_scorer(query.term.field, query.term.text, query.boost)
            docs, freqs = self._term_postings(seg, query.term.field, query.term.text)
            scores = np.zeros(n, dtype=np.float32)
            mask = np.zeros(n, dtype=bool)
            if len(docs):
                norms = seg.fields[query.term.field].norms[docs]
                scores[docs] = scorer.score(freqs, norms)
                mask[docs] = True
            return scores, mask

        if isinstance(query, BooleanQuery):
            return self._score_boolean(seg, query)

        if isinstance(query, PhraseQuery):
            return self._score_phrase(seg, query)

        if isinstance(query, MatchAllDocsQuery):
            return np.full(n, 1.0, np.float32), np.ones(n, bool)

        if isinstance(query, NumericRangeQuery):
            mask = numeric_range_mask(seg, query.field, query.lower, query.upper)
            return mask.astype(np.float32), mask

        if isinstance(query, DoubleRangeQuery):
            mask = double_range_mask(
                seg, query.field, query.lower, query.upper,
                query.include_lower, query.include_upper,
            )
            return mask.astype(np.float32), mask

        if isinstance(query, PointRangeQuery):
            mask = point_range_mask(seg, query.field, query.lower, query.upper)
            return mask.astype(np.float32), mask

        raise TypeError(f"unsupported query type: {type(query)}")

    def _score_boolean(
        self, seg: SegmentData, query: BooleanQuery
    ) -> Tuple[np.ndarray, np.ndarray]:
        n = seg.num_docs
        must, should, filt, must_not = query.split()

        # Deterministic accumulation order: term clauses sorted by term text
        # within each occur group (the device engine scores terms in sorted
        # term-id order, which for one field is the same order).
        def _sorted(qs):
            return sorted(
                qs,
                key=lambda q: (
                    (q.term.field, q.term.text)
                    if isinstance(q, TermQuery)
                    else ("", "")
                ),
            )

        scores = np.zeros(n, dtype=np.float32)
        mask = np.ones(n, dtype=bool)

        for q in _sorted(must):
            s, m = self._score_dense(seg, q)
            scores = (scores + s).astype(np.float32)
            mask &= m

        should_count = np.zeros(n, dtype=np.int32)
        for q in _sorted(should):
            s, m = self._score_dense(seg, q)
            scores = (scores + s).astype(np.float32)
            should_count += m.astype(np.int32)

        if should:
            min_should = query.minimum_number_should_match
            if not must and not filt:
                # Pure disjunction: at least one SHOULD clause must match.
                min_should = max(min_should, 1)
            if min_should > 0:
                mask &= should_count >= min_should

        for q in filt:
            _, m = self._score_dense(seg, q)
            mask &= m

        for q in must_not:
            _, m = self._score_dense(seg, q)
            mask &= ~m

        if not (must or should or filt):
            mask[:] = False  # only MUST_NOT (or empty) matches nothing
        scores = np.where(mask, scores, np.float32(0))
        return scores, mask

    def _score_phrase(
        self, seg: SegmentData, query: PhraseQuery
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact phrase: all terms adjacent (PhraseQuery.cpp:186-202)."""
        n = seg.num_docs
        scores = np.zeros(n, dtype=np.float32)
        mask = np.zeros(n, dtype=bool)
        if not query.terms:
            return scores, mask

        per_term = []
        for t in query.terms:
            docs, pos, pos_doc = self._term_positions(seg, query.field, t)
            if len(docs) == 0:
                return scores, mask
            per_term.append((docs, pos, pos_doc))

        # conjunction of docids
        common = per_term[0][0]
        for docs, _, _ in per_term[1:]:
            common = np.intersect1d(common, docs, assume_unique=True)
        if len(common) == 0:
            return scores, mask

        # Phrase "freq" = number of positions where term_i appears at
        # lead_pos + i for all i; (docid, position) pairs as int64 keys.
        def keys(doc, pos):
            return (doc.astype(np.int64) << 32) | pos.astype(np.int64)

        _, lead_pos, lead_doc = per_term[0]
        keep = np.isin(lead_doc, common)
        lead_pos, lead_doc = lead_pos[keep], lead_doc[keep]
        ok = np.ones(len(lead_pos), dtype=bool)
        for i in range(1, len(per_term)):
            _, pos_i, doc_i = per_term[i]
            ok &= np.isin(keys(lead_doc, lead_pos.astype(np.int64) + i),
                          keys(doc_i, pos_i))
        phrase_freqs = np.bincount(
            np.searchsorted(common, lead_doc[ok]), minlength=len(common)
        ).astype(np.float32)

        matched = phrase_freqs > 0
        common = common[matched]
        phrase_freqs = phrase_freqs[matched]
        if len(common) == 0:
            return scores, mask

        # Reference semantics (PhraseQuery.cpp:304-338): IDF uses the RAREST
        # member term's docFreq ("phrase can't match more docs than the
        # rarest term"), aggregated across segments; phraseFreq is the tf.
        stt, _ = self.field_stats(query.field)
        avgdl = BM25Similarity.avg_field_length(stt, self.max_doc)
        min_df = self.max_doc
        for t in query.terms:
            df = self.term_doc_freq(query.field, t)
            if df > 0:
                min_df = min(min_df, df)
        if min_df <= 0:
            min_df = 1
        idf = self.sim.idf(min_df, self.max_doc) * np.float32(query.boost)
        scorer = self.sim.scorer(idf, avgdl)

        norms = seg.fields[query.field].norms[common]
        scores[common] = scorer.score(phrase_freqs, norms)
        mask[common] = True
        return scores, mask

    # -- public API --------------------------------------------------------
    def search(self, query: Query, k: int = 10) -> TopDocs:
        scores, docs = [np.zeros(0, np.float32)], [np.zeros(0, np.int64)]
        for si, seg in enumerate(self.segments):
            s, mask = self._score_dense(seg, query)
            if seg.live_docs is not None:
                mask &= seg.live_docs
            hit = np.nonzero(mask)[0]
            scores.append(s[hit])
            docs.append(hit + self.doc_bases[si])
        s, d = np.concatenate(scores), np.concatenate(docs)
        # (score desc, docid asc); lexsort is stable and -0.0 ties +0.0
        top = np.lexsort((d, -s))[:k]
        return TopDocs(len(d), [ScoreDoc(int(d[i]), float(s[i])) for i in top])

    def count(self, query: Query) -> int:
        total = 0
        for seg in self.segments:
            _, mask = self._score_dense(seg, query)
            if seg.live_docs is not None:
                mask &= seg.live_docs
            total += int(mask.sum())
        return total
