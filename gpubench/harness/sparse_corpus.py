"""The SPLADE-shaped sparse corpus, made on the device.

A passage is a set of distinct WordPiece ids with positive f32 weights:

- its number of non-zeros is log-normal with the configuration's mean
  and ``doc_nnz_sigma``, rounded and clipped to ``[doc_nnz_min,
  doc_nnz_max]``;
- its ids are drawn without replacement from a Zipf law over term ranks,
  ``1/(rank + zipf_offset)^zipf_exponent`` (successive draws, a repeat
  skipped), and a rank is a WordPiece id through a permutation of the
  vocabulary drawn from ``corpus_seed``;
- its weights are log-normal with median ``doc_weight_median`` and
  ``doc_weight_sigma``, clipped to ``[doc_weight_min, doc_weight_max]``.

The passages come from ``corpus_seed``, so every run indexes the same
documents and does the same work; the run's seed sets their order, and
so every doc id. The term law and the permutation are computed in numpy
(``term_cdf``, ``wordpiece_of_rank``), so the query table's script
(``splade_queries.py``) draws from the same law on any device. The result
is a document-major CSR as host arrays: the harness hands the same arrays
to the program's index build and to the plain reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from harness.corpus import _permuted

CHUNK_DOCS = 1 << 17  # passages drawn per step: bounds the draw temporaries


@dataclass
class SparseCorpus:
    num_docs: int
    indptr: np.ndarray  # int64 [N + 1]
    ids: np.ndarray  # int32 [NNZ]: WordPiece ids, ascending within a passage
    values: np.ndarray  # float32 [NNZ], > 0


def term_cdf(cfg: dict) -> np.ndarray:
    """f64 [V]: the Zipf law's CDF over term ranks."""
    ranks = np.arange(cfg["vocab_size"], dtype=np.float64)
    probs = 1.0 / np.power(ranks + cfg["zipf_offset"], cfg["zipf_exponent"])
    return np.cumsum(probs / probs.sum())


def wordpiece_of_rank(cfg: dict) -> np.ndarray:
    """int64 [V]: the WordPiece id of each term rank, from corpus_seed."""
    rng = np.random.Generator(np.random.PCG64(cfg["corpus_seed"]))
    return rng.permutation(cfg["vocab_size"]).astype(np.int64)


def lognormal_counts(n: int, mean: float, sigma: float, lo: int, hi: int,
                     g: torch.Generator, device) -> torch.Tensor:
    """int64 [n]: log-normal counts of the given mean, rounded, clipped."""
    x = torch.empty(n, dtype=torch.float64, device=device).log_normal_(
        math.log(mean) - sigma * sigma / 2, sigma, generator=g)
    return x.round_().clamp_(lo, hi).long()


def _distinct(counts, cdf, wp, factor: float, g):
    """(kept a passage int64 [n], ids int64 [sum]): for each passage,
    the first ``counts[d]`` distinct ids of ``ceil(factor * counts[d]) + 8``
    Zipf draws, ids ascending within the passage."""
    dev = counts.device
    V = len(wp)
    draws = (counts.double() * factor).ceil().long() + 8
    n = len(counts)
    doc = torch.repeat_interleave(torch.arange(n, device=dev), draws)
    u = torch.rand(len(doc), dtype=torch.float64, device=dev, generator=g)
    key = doc * V + wp[torch.searchsorted(cdf, u).clamp_(max=V - 1)]
    del u
    skey, perm = torch.sort(key, stable=True)
    del key
    first = torch.ones_like(skey, dtype=torch.bool)
    first[1:] = skey[1:] != skey[:-1]
    keep = torch.zeros_like(first)
    keep[perm[first]] = True  # a draw that repeats none before it
    seen = torch.cumsum(keep, 0)
    start = torch.cumsum(draws, 0) - draws
    before = (seen - keep.long())[start]  # kept draws of earlier passages
    keep &= (seen - before[doc]) <= counts[doc]
    kept = skey[keep[perm]]
    return torch.bincount(kept // V, minlength=n), kept % V


def make_corpus(cfg: dict, seed: int, device) -> SparseCorpus:
    dev = torch.device(device)
    n = cfg["num_docs"]
    cdf = torch.as_tensor(term_cdf(cfg), device=dev)
    wp = torch.as_tensor(wordpiece_of_rank(cfg), device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(cfg["corpus_seed"])
    counts = lognormal_counts(n, cfg["doc_nnz_mean"], cfg["doc_nnz_sigma"],
                              cfg["doc_nnz_min"], cfg["doc_nnz_max"], g, dev)
    lens, ids = [], []
    for a in range(0, n, CHUNK_DOCS):
        ln, i = _distinct(counts[a:a + CHUNK_DOCS], cdf, wp,
                          cfg["draw_factor"], g)
        lens.append(ln)
        ids.append(i.int())
    lens, ids = torch.cat(lens), torch.cat(ids)
    values = torch.empty(len(ids), dtype=torch.float32, device=dev).log_normal_(
        math.log(cfg["doc_weight_median"]), cfg["doc_weight_sigma"],
        generator=g).clamp_(cfg["doc_weight_min"], cfg["doc_weight_max"])

    g.manual_seed(seed % (1 << 63))
    perm = torch.randperm(n, device=dev, generator=g)
    ids, new_lens = _permuted(ids, lens, perm)
    values, _ = _permuted(values, lens, perm)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(new_lens.cpu().numpy(), out=indptr[1:])
    return SparseCorpus(n, indptr, ids.cpu().numpy(), values.cpu().numpy())
