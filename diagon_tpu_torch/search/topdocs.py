"""TopDocs / ScoreDoc result types (reference ``search/TopDocs.h``): the
port's own copy of ``diagon_tpu/search/topdocs.py``, with
``top_docs_batch``, the batch paths' builder of a whole batch's TopDocs."""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from itertools import repeat
from typing import List, Sequence, Tuple

import numpy as np

from diagon_tpu_torch.observability.metrics import registry


@dataclass(frozen=True, slots=True)
class ScoreDoc:
    doc: int
    score: float


@dataclass
class TopDocs:
    total_hits: int
    score_docs: List[ScoreDoc]

    def doc_ids(self) -> List[int]:
        return [sd.doc for sd in self.score_docs]

    def scores(self) -> List[float]:
        return [sd.score for sd in self.score_docs]


def merge_top_docs(parts: List[TopDocs], k: int) -> TopDocs:
    """k-way merge across segments/shards: score desc, docid asc."""
    total = sum(p.total_hits for p in parts)
    all_docs = [sd for p in parts for sd in p.score_docs]
    all_docs.sort(key=lambda sd: (-sd.score, sd.doc))
    return TopDocs(total, all_docs[:k])


_BATCHED = registry.counter("search.topdocs_batched",
                            "queries whose TopDocs the batch builder built")
_new = object.__new__
_set_doc = ScoreDoc.doc.__set__
_set_score = ScoreDoc.score.__set__


def _score_docs(docs: List[int], scores: List[float]) -> List[ScoreDoc]:
    """``[ScoreDoc(d, s) for d, s in zip(docs, scores)]`` in loops that
    stay in C: the slots are filled through their member descriptors, as
    the frozen class's generated ``__init__`` fills them."""
    sds = list(map(_new, repeat(ScoreDoc, len(docs))))
    deque(map(_set_doc, sds, docs), maxlen=0)
    deque(map(_set_score, sds, scores), maxlen=0)
    return sds


def top_docs_batch(
    parts: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray, int]], k: int
) -> List[TopDocs]:
    """A batch's TopDocs from its per-segment top-k rows in whole-batch
    numpy operations. ``parts`` holds one ``(scores f32 [Q, kk], docs
    [Q, kk], hits [Q], doc_base)`` a segment, as ``RowExecutor.finalize``
    returns them; query q keeps, of each row, the entries with ``score >=
    0.0`` up to the segment's ``hits[q]`` of them, merges them by (score
    desc, global docid asc), stably in part order, and keeps k. Equal to
    ``merge_top_docs`` over one TopDocs a (query, segment)."""
    scores, docs, keep, total = [], [], [], 0
    for s, d, h, base in parts:
        s = np.asarray(s)
        h = np.asarray(h, np.int64)
        v = s >= 0.0
        keep.append(v & (np.cumsum(v, axis=1) <= h[:, None]))
        scores.append(s)
        docs.append(np.asarray(d, np.int64) + base)
        total = total + h
    scores = np.concatenate(scores, axis=1)
    docs = np.concatenate(docs, axis=1)
    keep = np.concatenate(keep, axis=1)
    nq = scores.shape[0]
    # stable: kept entries first, then score desc (-0.0 ties +0.0), docid asc
    order = np.lexsort((docs, np.where(keep, -scores, 0), ~keep))[:, :k]
    counts = np.minimum(keep.sum(axis=1), order.shape[1])
    first = np.arange(order.shape[1]) < counts[:, None]
    sds = _score_docs(np.take_along_axis(docs, order, 1)[first].tolist(),
                      np.take_along_axis(scores, order, 1)[first].tolist())
    ends = np.cumsum(counts).tolist()
    starts = [0] + ends[:-1]
    _BATCHED.increment(nq)
    return [TopDocs(t, sds[a:b])
            for t, a, b in zip(total.tolist(), starts, ends)]
