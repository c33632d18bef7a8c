"""The Reuters-shaped corpus, made on the device.

A frozen copy of the repo's synthetic generator's rules (vocabulary with
the benchmark's query terms planted in its head, Zipf ``1/(rank +
2.7)^1.07`` over the configuration's vocabulary, log-normal body lengths,
3-8 token titles, phrase injection, the date keyword), drawn with a ``torch.Generator`` on
the device in a few large calls. The documents come from the
configuration's ``corpus_seed``, so every run indexes the same documents
and does the same work; the run's seed sets their order, and so every
doc id. The result is each field's token stream as host arrays: the
harness hands the same arrays to the program's indexer and to the plain
reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

CHUNK = 1 << 24  # tokens drawn per call


@dataclass
class FieldTokens:
    doc_len: np.ndarray  # int32 [N]
    tokens: np.ndarray  # int32 [T], ids into vocab, document after document
    vocab: List[str]
    with_positions: bool


@dataclass
class Corpus:
    num_docs: int
    fields: Dict[str, FieldTokens]


def build_vocab(size: int, planted: List[str], every: int) -> List[str]:
    """The planted terms at every ``every``-th rank from rank 1, then
    ``w<i>`` fillers."""
    vocab, seen, pi, gi = [], set(), 0, 0
    while len(vocab) < size:
        if pi < len(planted) and len(vocab) % every == 1:
            w, pi = planted[pi], pi + 1
        else:
            w, gi = f"w{gi}", gi + 1
        if w not in seen:
            seen.add(w)
            vocab.append(w)
    for i, w in enumerate(planted):  # tiny vocabularies keep every term
        if w not in seen:
            vocab[-(i + 1)] = w
    return vocab


def zipf_cdf(cfg: dict) -> np.ndarray:
    ranks = np.arange(cfg["vocab_size"], dtype=np.float64)
    probs = 1.0 / np.power(ranks + cfg["zipf_offset"], cfg["zipf_exponent"])
    return np.cumsum(probs / probs.sum())


def _draw_tokens(n: int, cdf: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    out = torch.empty(n, dtype=torch.int32, device=cdf.device)
    for a in range(0, n, CHUNK):
        u = torch.rand(min(CHUNK, n - a), dtype=torch.float64,
                       device=cdf.device, generator=g)
        out[a:a + len(u)] = torch.searchsorted(cdf, u).clamp_(max=len(cdf) - 1)
    return out


def _inject_phrases(tokens, doc_len, phrases, cfg, g) -> None:
    """``phrase_doc_share`` of the documents get 1 to
    ``phrase_max_occurrences`` copies of one phrase at random offsets,
    written in occurrence order."""
    dev = tokens.device
    n = len(doc_len)
    plen_all = torch.tensor([len(p) for p in phrases], device=dev)
    width = int(plen_all.max())
    ptok = torch.tensor([p + [0] * (width - len(p)) for p in phrases],
                        dtype=torch.int32, device=dev)
    occ = cfg["phrase_max_occurrences"]
    chosen = torch.rand(n, dtype=torch.float64, device=dev,
                        generator=g) < cfg["phrase_doc_share"]
    which = torch.randint(0, len(phrases), (n,), device=dev, generator=g)
    n_occ = torch.randint(1, occ + 1, (n,), device=dev, generator=g)
    u_off = torch.rand((occ, n), dtype=torch.float64, device=dev, generator=g)
    lens = doc_len.long()
    start = torch.cumsum(lens, 0) - lens
    plen = plen_all[which]
    for j in range(occ):
        ok = chosen & (j < n_occ) & (lens > plen + 1)
        off = (u_off[j] * (lens - plen)).floor().long()
        for i in range(width):
            use = ok & (i < plen)
            tokens[(start + off + i)[use]] = ptok[which[use], i]


def _permuted(tokens: torch.Tensor, lens: torch.Tensor, perm: torch.Tensor):
    """The token stream with its documents in the order ``perm``."""
    lens = lens.long()
    start = torch.cumsum(lens, 0) - lens
    new_lens = lens[perm]
    new_start = torch.cumsum(new_lens, 0) - new_lens
    at = torch.arange(len(tokens), device=tokens.device)
    at += torch.repeat_interleave(start[perm] - new_start, new_lens)
    return tokens[at], new_lens.int()


def make_corpus(cfg: dict, seed: int, device) -> Corpus:
    dev = torch.device(device)
    n = cfg["num_docs"]
    vocab = build_vocab(cfg["vocab_size"], cfg["planted_terms"],
                        cfg["planted_every"])
    rank = {w: i for i, w in enumerate(vocab)}
    cdf = torch.as_tensor(zipf_cdf(cfg), device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(cfg["corpus_seed"])

    body_len = torch.empty(n, dtype=torch.float64, device=dev).log_normal_(
        math.log(cfg["body_mean_len"]), cfg["body_sigma"], generator=g)
    body_len = body_len.floor().clamp_(min=cfg["body_min_len"]).int()
    body = _draw_tokens(int(body_len.sum()), cdf, g)
    phrases = [[rank[w] for w in p] for p in cfg["injected_phrases"]]
    if phrases and cfg["phrase_doc_share"] > 0:
        _inject_phrases(body, body_len, phrases, cfg, g)

    title_len = torch.randint(cfg["title_min_len"], cfg["title_max_len"] + 1,
                              (n,), dtype=torch.int32, device=dev, generator=g)
    title = _draw_tokens(int(title_len.sum()), cdf, g)

    g.manual_seed(seed % (1 << 63))
    perm = torch.randperm(n, device=dev, generator=g)
    body, body_len = _permuted(body, body_len, perm)
    title, title_len = _permuted(title, title_len, perm)
    fields = {
        "body": FieldTokens(body_len.cpu().numpy(), body.cpu().numpy(), vocab,
                            True),
        "title": FieldTokens(title_len.cpu().numpy(), title.cpu().numpy(),
                             vocab, True),
    }
    if cfg.get("date_keyword"):
        # "DD-FEB-1987 15:01:SS.00" with DD = d % 28 + 1, SS = d % 60; the
        # zero padding makes id order the terms' sorted order
        d = perm.cpu().numpy()  # a document keeps its date
        fields["date"] = FieldTokens(
            np.ones(n, np.int32), ((d % 28) * 60 + d % 60).astype(np.int32),
            [f"{c // 60 + 1:02d}-FEB-1987 15:01:{c % 60:02d}.00"
             for c in range(28 * 60)], False)
    return Corpus(n, fields)
