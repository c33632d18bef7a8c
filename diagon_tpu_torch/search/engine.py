"""Clause plans, the BM25 tf table and the fused-result decode.

The subset of ``diagon_tpu/search/engine.py`` the row engine needs. These
are host (numpy) code; the JAX module's v1 scatter engine
(``score_and_topk``, ``SegmentExecutor``) is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from diagon_tpu_torch.search.bm25 import BM25Similarity


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


def unfuse_topk(fused: np.ndarray, k: int):
    """Decode fused rows ``[k scores | k docids as f32 | hits]`` into
    (scores f32, docs i32, hits i32)."""
    fused = np.asarray(fused)
    scores = fused[..., :k]
    docs = fused[..., k : 2 * k].astype(np.int32)
    hits = fused[..., 2 * k].astype(np.int32)
    return scores, docs, hits
