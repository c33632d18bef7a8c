"""Plain top-k of the quantized sparse dot product over a corpus given as
a document-major CSR.

The reference quantizes the raw corpus itself and scores each query with
dense per-document accumulators, in plain torch operations on whatever
device it is given. It imports nothing of the program under test and
reads nothing the program made: the harness hands it the same CSR it
hands the program's index build.

Semantics, the configuration's ``guarantees``:

- a term's scale is ``scale_t = f32(f64(max_w_t) / 255)``, ``max_w_t``
  its largest weight in the corpus;
- a posting's bin is ``clip(round_half_even(f32(w) / scale_t), 1, 255)``;
- a query clause ``"<id>^<weight>"`` has the weight
  ``q_w = np.float32(float(weight))`` and scores with
  ``f32(q_w * scale_t)``; a term no passage holds scores nothing;
- a passage's score is the f32 sum, from 0.0 and in ascending term-id
  order, of ``f32(clause weight * bin)``: one ``index_add`` a clause;
- a passage matches when it holds at least one query term; the top k are
  ordered by score descending, then doc id ascending; ``total_hits``
  counts every match.

``precision="bf16"`` computes the same answers with every product and
every sum rounded to bfloat16: the benchmark's control, which its
comparison has to reject.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

NUM_BINS = 255

Answer = Tuple[int, List[int], List[float]]  # total hits, docs, scores


def parse_clause(text: str) -> Tuple[int, np.float32]:
    """``"<id>^<weight>"`` -> (id, f32 weight)."""
    term, weight = text.split("^")
    return int(term), np.float32(float(weight))


class Reference:
    """Exact top-k answers for SHOULD-list specs of ``id^weight`` clauses.

    ``indptr``: int [N + 1]; ``ids``: int [NNZ], the term ids of passage d
    at ``indptr[d]:indptr[d + 1]``, unique within it; ``values``: their f32
    weights, > 0."""

    def __init__(self, indptr: np.ndarray, ids: np.ndarray,
                 values: np.ndarray, device="cpu"):
        dev = self.device = torch.device(device)
        indptr = np.asarray(indptr, np.int64)
        self.num_docs = len(indptr) - 1
        tid = torch.as_tensor(np.asarray(ids, np.int64), device=dev)
        w = torch.as_tensor(np.asarray(values, np.float32), device=dev)
        doc = torch.repeat_interleave(
            torch.arange(self.num_docs, device=dev),
            torch.as_tensor(np.diff(indptr), device=dev))
        V = int(tid.max()) + 1 if len(tid) else 1
        max_w = torch.zeros(V, dtype=torch.float32, device=dev).scatter_reduce_(
            0, tid, w, "amax", include_self=False)
        scale = (max_w.double() / NUM_BINS).float()
        bins = torch.clamp(torch.round(w / scale[tid]), 1, NUM_BINS)
        # term-major postings, doc ids ascending within a term
        order = torch.sort(tid, stable=True).indices
        self.docs, self.bins = doc[order], bins[order]
        start = torch.zeros(V + 1, dtype=torch.int64, device=dev)
        torch.cumsum(torch.bincount(tid, minlength=V), 0, out=start[1:])
        self.start = start.cpu().numpy()
        self.scale = scale.cpu().numpy()

    @classmethod
    def for_corpus(cls, corpus, field: str, cfg: dict, device) -> "Reference":
        """The reference over the generator's corpus (one field)."""
        return cls(corpus.indptr, corpus.ids, corpus.values, device)

    def answer(self, specs: Sequence[tuple], k: int,
               precision: str = "f32") -> List[Answer]:
        dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[precision]
        return [self._answer(spec[2], k, dtype) for spec in specs]

    def _answer(self, should: Sequence[str], k: int, dtype) -> Answer:
        acc = torch.zeros(self.num_docs, dtype=dtype, device=self.device)
        mask = torch.zeros(self.num_docs, dtype=torch.bool, device=self.device)
        for t, q_w in sorted(map(parse_clause, should)):
            if t >= len(self.scale) or self.start[t] == self.start[t + 1]:
                continue
            weight = torch.tensor(float(np.float32(q_w * self.scale[t])),
                                  dtype=dtype, device=self.device)
            a, z = int(self.start[t]), int(self.start[t + 1])
            docs = self.docs[a:z]
            acc.index_add_(0, docs, self.bins[a:z].to(dtype) * weight)
            mask[docs] = True
        cand = torch.nonzero(mask).squeeze(1)  # doc ids ascending
        scores = acc[cand].float()
        order = torch.sort(scores, descending=True, stable=True).indices[:k]
        return (len(cand), cand[order].tolist(), scores[order].tolist())
