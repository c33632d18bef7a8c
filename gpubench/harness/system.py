"""The system under test: the port's index built from the corpus's token
arrays by the port's own indexing functions, served by its
``IndexSearcher``. The only module of the harness that imports the
program."""

from __future__ import annotations

import copy
from typing import Dict, List

import numpy as np

from diagon_tpu_torch import native
from diagon_tpu_torch.codecs.postings import build_packed_postings_csr
from diagon_tpu_torch.index.memory_index import encode_norm
from diagon_tpu_torch.index.segment import SegmentData, SegmentFieldData
from diagon_tpu_torch.observability.metrics import registry
from diagon_tpu_torch.observability.profiler import QueryProfiler
from diagon_tpu_torch.search import (BooleanQuery, IndexSearcher, Occur,
                                     PhraseQuery, TermQuery)

from harness.check import Answer
from harness.corpus import Corpus, FieldTokens


def _field(f: FieldTokens) -> SegmentFieldData:
    """Invert and pack one field: token ids are remapped to the sorted
    term order first, so the counting sort yields dictionary-order CSR."""
    order = sorted(range(len(f.vocab)), key=f.vocab.__getitem__)
    remap = np.empty(len(order), np.int32)
    remap[np.asarray(order, np.int64)] = np.arange(len(order), dtype=np.int32)
    entry_start, docs, freqs, positions = native.invert_tokens(
        f.doc_len, remap[f.tokens], len(order), f.with_positions)
    df = np.diff(entry_start)
    keep = np.nonzero(df > 0)[0]
    terms = [f.vocab[order[i]] for i in keep]
    entry_start = np.concatenate([[0], np.cumsum(df[keep])]).astype(np.int64)
    pos_start = None
    if positions is not None:
        pos_start = np.zeros(len(freqs) + 1, np.int64)
        np.cumsum(freqs, dtype=np.int64, out=pos_start[1:])
    lengths, at = np.unique(f.doc_len, return_inverse=True)
    norms = np.asarray([encode_norm(int(n)) for n in lengths], np.uint8)[at]
    pp = build_packed_postings_csr(terms, entry_start, docs, freqs, pos_start,
                                   positions, norms)
    pp.doc_count_with_field = int((norms > 0).sum())
    return SegmentFieldData(postings=pp, norms=norms,
                            with_positions=f.with_positions)


def build_segment(corpus: Corpus) -> SegmentData:
    seg = SegmentData(name="_bench", num_docs=corpus.num_docs)
    for name, f in corpus.fields.items():
        seg.fields[name] = _field(f)
    return seg


def to_query(spec, field: str):
    if spec[0] == "phrase":
        return PhraseQuery(field, list(spec[1]))
    _, must, should, must_not = spec
    if not must and not must_not and len(should) == 1:
        return TermQuery(field, should[0])
    b = BooleanQuery.Builder()
    for group, occur in ((must, Occur.MUST), (should, Occur.SHOULD),
                         (must_not, Occur.MUST_NOT)):
        for t in group:
            b.add(TermQuery(field, t), occur)
    return b.build()


class System:
    """One searcher over one segment, fresh query objects every call:
    the program's caches keyed by object identity never see a query
    twice, as with a client that parses each request anew."""

    def __init__(self, corpus: Corpus, device):
        self.segment = build_segment(corpus)
        self.searcher = IndexSearcher([self.segment], device=device,
                                      query_cache=False)

    @staticmethod
    def queries(specs, field: str) -> List:
        return [to_query(s, field) for s in specs]

    @staticmethod
    def fresh(q):
        return copy.copy(q)

    @staticmethod
    def answer(td) -> Answer:
        """A ``TopDocs`` as (total hits, doc ids, scores)."""
        return (int(td.total_hits), tuple(int(sd.doc) for sd in td.score_docs),
                tuple(float(sd.score) for sd in td.score_docs))

    def dispatch(self, queries, k: int):
        return self.searcher.dispatch_batch(queries, k=k)

    def collect(self, handle) -> List:
        return self.searcher.collect_many([handle])[0]

    def search(self, query, k: int):
        return self.searcher.search(query, k=k)

    @staticmethod
    def counters() -> Dict[str, int]:
        return {name: v for name, v in registry.snapshot().items()
                if isinstance(v, int)}

    @staticmethod
    def enable_phase_profiler():
        return QueryProfiler.enable()

    def close(self) -> None:
        self.searcher = None
        self.segment = None
