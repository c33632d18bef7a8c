"""Plain BM25 top-k over a corpus given as token arrays.

The reference inverts the corpus itself (one sort of the needed terms'
(term, doc) keys) and scores each query with dense per-document
accumulators, in plain torch operations on whatever device holds the
tokens. It imports nothing of the program under test and reads nothing
the program made: the harness hands it the same token arrays it hands the
program's indexer.

Semantics, those of the reference engine (Lucene 8's BM25 form):

- ``idf = ln(1 + (N - df + 0.5) / (df + 0.5))`` in float32, N the number
  of documents;
- ``avgdl = f32(sum of the field's lengths) / f32(N)``;
- a document's norm byte is ``min(127, trunc(127 / sqrt(length)))``; it
  decodes to the length ``(127 / norm)^2`` in float32, and to 1.0 for
  the norms 0 and 127;
- ``k = k1 * ((1 - b) + (b * length) * (1 / avgdl))`` and a term scores
  ``idf * (freq / (freq + k))``, every step in float32;
- a query adds its clauses' scores in float32, the MUST clauses first,
  then the SHOULD clauses, each group in term-text order;
- a document matches when it holds every MUST term, at least one SHOULD
  term where there is no MUST clause, and no MUST_NOT term;
- a phrase matches exact adjacency within a document; its frequency is
  the number of positions where it starts, and its idf is that of its
  rarest term;
- the top k are ordered by score descending, then doc id ascending;
  ``total_hits`` counts every match.

``precision="bf16"`` computes the same answers with every term score and
every sum rounded to bfloat16: the benchmark's control, which its
comparison has to reject.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

NORM_LEVELS = 128
_F32 = np.float32


def norm_bytes(doc_len: np.ndarray) -> np.ndarray:
    """The norm byte of each document: min(127, trunc(127 / sqrt(len)))."""
    out = np.zeros(len(doc_len), np.int64)
    nz = doc_len > 0
    out[nz] = np.minimum(127.0, 127.0 / np.sqrt(doc_len[nz].astype(np.float64)))
    return out


def idf(df: int, n: int) -> np.float32:
    return _F32(np.log(_F32(1.0) + (_F32(n - df) + _F32(0.5))
                       / (_F32(df) + _F32(0.5))))


def k_of_norm(k1: float, b: float, avgdl: np.float32) -> np.ndarray:
    """f32 [128]: BM25's k for each norm byte."""
    norm = np.arange(NORM_LEVELS, dtype=_F32)
    inv = _F32(127.0) / np.where(norm == 0, _F32(1.0), norm)
    length = np.where((norm == 0) | (norm == 127), _F32(1.0), inv * inv)
    inv_avgdl = _F32(1.0) / avgdl
    return (_F32(k1) * ((_F32(1.0) - _F32(b))
                        + (_F32(b) * length) * inv_avgdl)).astype(_F32)


def score_table(term_idf: np.float32, k: np.ndarray, max_freq: int) -> np.ndarray:
    """f32 [max_freq + 1, 128]: a term's score for each (freq, norm)."""
    freq = np.arange(max_freq + 1, dtype=_F32)[:, None]
    return (term_idf * (freq / (freq + k[None, :]))).astype(_F32)


Spec = Tuple  # ("bool", must, should, must_not) or ("phrase", terms)
Answer = Tuple[int, List[int], List[float]]  # total hits, docs, scores


class Reference:
    """Exact top-k answers for query specs over one field's tokens.

    ``doc_len``: int [N], the field's length of every document;
    ``tokens``: int [T], the field's token ids document after document;
    ``vocab``: the term of each token id."""

    def __init__(self, doc_len: np.ndarray, tokens: np.ndarray,
                 vocab: Sequence[str], device="cpu", k1: float = 1.2,
                 b: float = 0.75):
        self.device = torch.device(device)
        self.num_docs = len(doc_len)
        self.term_id = {t: i for i, t in enumerate(vocab)}
        doc_len = np.asarray(doc_len, np.int64)
        self.tokens = torch.as_tensor(np.asarray(tokens, np.int32)).to(self.device)
        self.doc_of = torch.repeat_interleave(
            torch.arange(self.num_docs, dtype=torch.int32, device=self.device),
            torch.as_tensor(doc_len, device=self.device))
        self.norms = torch.as_tensor(norm_bytes(doc_len), device=self.device)
        avgdl = (_F32(int(doc_len.sum())) / _F32(self.num_docs)
                 if doc_len.sum() > 0 else _F32(50.0))
        self.k = k_of_norm(k1, b, _F32(avgdl))
        self._postings: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}

    @classmethod
    def for_corpus(cls, corpus, field: str, cfg: dict, device) -> "Reference":
        """The reference over one field of the generator's corpus."""
        f = corpus.fields[field]
        return cls(f.doc_len, f.tokens, f.vocab, device, cfg["bm25_k1"],
                   cfg["bm25_b"])

    # -- inversion -------------------------------------------------------
    def _invert(self, term_ids: Sequence[int]) -> None:
        """(docs, freqs) of each term not yet inverted, from one sort."""
        todo = sorted({t for t in term_ids if t not in self._postings})
        if not todo:
            return
        n = self.num_docs
        slot_of = torch.full((len(self.term_id),), -1, dtype=torch.int32,
                             device=self.device)
        slot_of[torch.as_tensor(todo, device=self.device)] = torch.arange(
            len(todo), dtype=torch.int32, device=self.device)
        slot = slot_of[self.tokens.long()]
        keep = slot >= 0
        key = slot[keep].long() * n + self.doc_of[keep].long()
        del slot, keep
        key, counts = torch.unique_consecutive(torch.sort(key).values,
                                               return_counts=True)
        kslot = key // n
        bounds = torch.searchsorted(
            kslot, torch.arange(len(todo) + 1, device=self.device)).tolist()
        docs = key % n
        for i, t in enumerate(todo):
            a, z = bounds[i], bounds[i + 1]
            self._postings[t] = (docs[a:z].clone(), counts[a:z].clone())

    def _phrase_freqs(self, ids: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(docs, phrase frequency) of the documents holding the phrase."""
        span = len(ids)
        m = len(self.tokens) - span + 1
        if m <= 0:
            empty = torch.zeros(0, dtype=torch.int64, device=self.device)
            return empty, empty
        hit = self.doc_of[:m] == self.doc_of[span - 1:]
        for i, t in enumerate(ids):
            hit &= self.tokens[i:i + m] == t
        freq = torch.bincount(self.doc_of[:m][hit].long(),
                              minlength=self.num_docs)
        docs = torch.nonzero(freq).squeeze(1)
        return docs, freq[docs]

    # -- scoring ---------------------------------------------------------
    def _term_scores(self, docs, freqs, term_idf, dtype) -> torch.Tensor:
        max_freq = int(freqs.max()) if len(freqs) else 0
        table = torch.as_tensor(score_table(term_idf, self.k, max_freq),
                                device=self.device).to(dtype)
        return table.reshape(-1)[freqs * NORM_LEVELS + self.norms[docs]]

    def answer(self, specs: Sequence[Spec], k: int,
               precision: str = "f32") -> List[Answer]:
        dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[precision]
        need = []
        for spec in specs:
            for group in spec[1:]:
                need += [self.term_id[t] for t in group if t in self.term_id]
        self._invert(need)
        return [self._answer(spec, k, dtype) for spec in specs]

    def _df(self, term: str) -> int:
        tid = self.term_id.get(term)
        return 0 if tid is None else len(self._postings[tid][0])

    def _answer(self, spec: Spec, k: int, dtype) -> Answer:
        n = self.num_docs
        acc = torch.zeros(n, dtype=dtype, device=self.device)
        if spec[0] == "phrase":
            terms = spec[1]
            if any(t not in self.term_id for t in terms):
                return 0, [], []
            docs, freqs = self._phrase_freqs([self.term_id[t] for t in terms])
            dfs = [d for d in map(self._df, terms) if d > 0]
            term_idf = idf(max(1, min(dfs, default=n)), n)
            acc[docs] = self._term_scores(docs, freqs, term_idf, dtype)
            mask = torch.zeros(n, dtype=torch.bool, device=self.device)
            mask[docs] = True
            return self._top(acc, mask, k)
        _, must, should, must_not = spec
        if not must and not should:
            return 0, [], []
        must_hits = torch.zeros(n, dtype=torch.int32, device=self.device)
        any_should = torch.zeros(n, dtype=torch.bool, device=self.device)
        for group, required in ((sorted(must), True), (sorted(should), False)):
            for t in group:
                tid = self.term_id.get(t)
                if tid is None:
                    continue
                docs, freqs = self._postings[tid]
                scores = self._term_scores(docs, freqs, idf(len(docs), n), dtype)
                acc[docs] = acc[docs] + scores
                if required:
                    must_hits[docs] += 1
                else:
                    any_should[docs] = True
        mask = must_hits == len(must) if must else any_should
        for t in must_not:
            tid = self.term_id.get(t)
            if tid is not None:
                mask[self._postings[tid][0]] = False
        return self._top(acc, mask, k)

    @staticmethod
    def _top(acc: torch.Tensor, mask: torch.Tensor, k: int) -> Answer:
        cand = torch.nonzero(mask).squeeze(1)  # doc ids ascending
        scores = acc[cand].float()
        order = torch.sort(scores, descending=True, stable=True).indices[:k]
        return (len(cand), cand[order].tolist(), scores[order].tolist())
