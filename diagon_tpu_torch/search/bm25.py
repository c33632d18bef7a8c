"""BM25 similarity — exact reference semantics (the port's own copy of
``diagon_tpu/search/bm25.py``).

Every constant and rounding choice matches the reference
(``search/BM25Similarity.h:87-224``, stats aggregation
``search/TermQuery.cpp:184-260``), because the north star requires bit-exact
top-10 parity:

- ``idf = ln(1 + (docCount - df + 0.5) / (df + 0.5))`` with
  ``docCount = maxDoc`` (NOT docs-with-field).
- ``avgFieldLength = sumTotalTermFreq / docCount`` in float32.
- norm decode: ``norm in (0, 127) -> fieldLength = 1.0`` else
  ``fieldLength = (127/norm)^2``.
- ``k = k1 * (1 - b + b * fieldLength * (1/avgFieldLength))``;
  ``score = idf * freq / (freq + k)`` (Lucene 8+ form without (k1+1)).
- defaults k1 = 1.2, b = 0.75; query boost multiplies idf.

All arithmetic is float32 to match the C++ ``float`` path.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class BM25Params:
    k1: float = 1.2
    b: float = 0.75


class BM25Similarity:
    def __init__(self, k1: float = 1.2, b: float = 0.75):
        self.k1 = np.float32(k1)
        self.b = np.float32(b)

    def idf(self, doc_freq: int, doc_count: int) -> np.float32:
        return np.float32(
            np.log(
                np.float32(1.0)
                + (np.float32(doc_count - doc_freq) + np.float32(0.5))
                / (np.float32(doc_freq) + np.float32(0.5))
            )
        )

    @staticmethod
    def avg_field_length(sum_total_tf: int, doc_count: int) -> np.float32:
        if doc_count > 0 and sum_total_tf > 0:
            return np.float32(sum_total_tf) / np.float32(doc_count)
        return np.float32(50.0)  # reference fallback (BM25Similarity.h:197)

    @staticmethod
    def decode_norm_length(norm) -> np.ndarray:
        """Vectorized norm-byte -> field length (float32)."""
        norm = np.asarray(norm, dtype=np.float32)
        inv = np.float32(127.0) / np.where(norm == 0, np.float32(1.0), norm)
        field_len = inv * inv
        one = np.float32(1.0)
        return np.where((norm == 0) | (norm == 127), one, field_len).astype(
            np.float32
        )

    def scorer(self, idf: np.float32, avgdl: np.float32) -> "SimScorer":
        return SimScorer(idf, self.k1, self.b, avgdl)


@dataclass(frozen=True)
class SimScorer:
    """Per-term scorer; ``score`` is vectorized over docs."""

    idf: np.float32
    k1: np.float32
    b: np.float32
    avgdl: np.float32

    def score(self, freq, norm) -> np.ndarray:
        freq = np.asarray(freq, dtype=np.float32)
        field_len = BM25Similarity.decode_norm_length(norm)
        inv_avgdl = np.float32(1.0) / np.float32(self.avgdl)
        k = np.float32(self.k1) * (
            np.float32(1.0)
            - np.float32(self.b)
            + np.float32(self.b) * field_len * inv_avgdl
        )
        # Association: idf * (freq/(freq+k)) — the tf factor is computed
        # first so the device LUT path (engine.make_tf_table) is bit-equal.
        # (The C++ reference associates (idf*freq)/(freq+k); the difference
        # is sub-ULP and never affects doc ordering.)
        return (np.float32(self.idf) * (freq / (freq + k))).astype(np.float32)
