"""TopDocs / ScoreDoc result types (reference ``search/TopDocs.h``): the
port's own copy of ``diagon_tpu/search/topdocs.py``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List


@dataclass(frozen=True)
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
