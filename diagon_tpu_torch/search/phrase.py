"""Phrase query execution (slop = 0) on one PyTorch device.

Counterpart of ``diagon_tpu/search/phrase.py``, with the same host/device
split:

- **Host (exact, cached)**: the conjunction. Per-term docid lists decode
  once from the packed blocks (numpy, cached per term) and intersect with
  ``np.intersect1d``; the candidate set and each candidate's per-term
  posting-entry index are exact, so the device side needs no scatter and
  no overflow escalation.
- **Device (torch ops)**: position intersection and scoring. Each
  candidate's per-term position window (a slice of the flat positions
  array) is gathered, and the lead term's positions ``p`` with term ``i``
  at ``p + (i - lead)`` for every other term are counted.

Scoring: BM25 with phraseFreq as tf and the rarest member term's docFreq
for the idf (PhraseQuery.cpp:304-338), through the host-exact tf table:
one f32 multiply ``idf * tf_lut[...]``, bit-identical to the oracle.

Deliberate deviations from the JAX function, none of which changes a
result:

- A window is one direct masked gather ``positions[p_lo + arange(P)]``
  (the JAX function's two aligned row gathers exist for the TPU's DMA);
  the slots past the entry hold ``_POS_SENTINEL``, so each row ascends.
- Membership is a batched ``torch.searchsorted`` of the lead's targets in
  each other term's row instead of the ``[C, P_lead, P_i]`` broadcast
  compare: the same ``found`` in ``P log P`` per candidate, since the
  broadcast is ``C * P^2`` elements (10^11 for two frequent terms at 1M
  docs). Candidates run in chunks that bound the temporaries.
- The result is (scores f32, docids i32, hits i32) and not one f32 vector
  with the ints as f32 values (the TPU's flush-to-zero reason, exact only
  below 2^24 docs); ``PhraseExecutor.top_k`` reads the three back in one
  copy.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from diagon_tpu_torch.codecs.postings import decode_blocks_numpy
from diagon_tpu_torch.search.device_index import DeviceSegment
from diagon_tpu_torch.search.row_engine import exact_topk

_POS_SENTINEL = 2**30
# elements of one candidate chunk's [chunk, P] windows (all terms)
_CHUNK_ELEMS = 1 << 24


def _window(pos_start, positions, ent_i, P: int):
    """([c, P] positions of one term per candidate, ascending, sentinel
    past the entry; [c, P] validity). An entry holds at most P positions
    (``pos_caps`` covers the term's largest block freq)."""
    e = ent_i.clamp_min(0).long()
    p_lo = pos_start[e].long()
    p_hi = pos_start[e + 1].long()
    gidx = p_lo[:, None] + torch.arange(P, device=positions.device)
    ok = gidx < p_hi[:, None]
    vals = positions[gidx.clamp_max(positions.shape[0] - 1)]
    return torch.where(ok, vals, _POS_SENTINEL), ok


def _phrase_freqs(pos_start, positions, ent, pos_caps, lead):
    """int32 [c] phraseFreq per candidate: lead positions p at which every
    term i sits at p + (i - lead)."""
    lead_w, found = _window(pos_start, positions, ent[lead], pos_caps[lead])
    for i, P in enumerate(pos_caps):
        if i == lead:
            continue
        arr, _ = _window(pos_start, positions, ent[i], P)
        target = lead_w + (i - lead)
        j = torch.searchsorted(arr, target).clamp_max(P - 1)
        found &= torch.gather(arr, 1, j) == target
    return found.sum(dim=1, dtype=torch.int32)


def phrase_positions_topk(
    pos_start,  # int32 [NE+1]
    positions,  # int32 [NP]
    norms,  # int32 [num_docs_pad]
    tf_lut,  # f32 [128*F]
    cand,  # int32 [C] candidate docids (-1 pad)
    ent,  # int32 [n_terms, C] posting-entry ids per candidate
    idf,  # f32 [] tensor
    *,
    pos_caps: tuple,  # per-term position-window widths
    lead: int,  # anchor slot = rarest term (its tf bounds phraseFreq)
    k: int,
):
    """(top scores f32 [k], top docids i32 [k], hits i32 []) of a phrase
    over its candidates: unmatched and padded candidates score -1.0, and
    equal scores keep ascending candidate order (``lax.top_k``'s)."""
    C = cand.shape[0]
    chunk = max(1, _CHUNK_ELEMS // sum(pos_caps))
    pfreq = torch.cat([
        _phrase_freqs(pos_start, positions, ent[:, c0 : c0 + chunk],
                      pos_caps, lead)
        for c0 in range(0, C, chunk)
    ])
    matched = (cand >= 0) & (pfreq > 0)
    hits = matched.sum(dtype=torch.int32)
    F = tf_lut.shape[0] // 128
    norm_c = norms[cand.clamp(0, norms.shape[0] - 1).long()].long()
    tf_factor = tf_lut[norm_c * F + pfreq.clamp(0, F - 1).long()]
    scores = torch.where(matched, idf * tf_factor, -1.0)
    top_scores, top_i = exact_topk(scores, k)
    return top_scores, cand[top_i], hits


class PhraseExecutor:
    """Per-(segment, field) phrase runner: host conjunction + device
    position intersection on the segment's device."""

    def __init__(self, segment: DeviceSegment, field_name: str, tf_lut):
        self.segment = segment
        self.field = segment.field(field_name)
        if not self.field.with_positions:
            raise ValueError(
                f"field {field_name!r} was indexed without positions"
            )
        self._host_pp = segment.source.fields[field_name].postings
        self._live_host = segment.source.live_docs
        self.tf_lut = torch.as_tensor(
            np.asarray(tf_lut, np.float32), device=self.field.device
        )
        self._term_docs: Dict[int, np.ndarray] = {}
        self._plan_cache: Dict[tuple, tuple] = {}
        self._row_cache: Dict[tuple, tuple] = {}

    def _docs_of(self, tid: int) -> np.ndarray:
        """Decoded ascending docids of one term (cached)."""
        got = self._term_docs.get(tid)
        if got is None:
            pp = self._host_pp
            got = decode_blocks_numpy(
                pp, int(pp.block_start[tid]), int(pp.block_start[tid + 1])
            )[0]
            if len(self._term_docs) < 4096:
                self._term_docs[tid] = got
        return got

    def _plan(self, terms: List[str]):
        """(cand, ent, (pos_caps, lead), tids) host conjunction plan with
        the tensors on the device, cached; ([], None, None, tids) for an
        empty conjunction; None when a term is missing."""
        key = tuple(terms)
        got = self._plan_cache.get(key)
        if got is not None:
            return got
        f = self.field
        pp = self._host_pp
        tids = [f.term_id(t) for t in terms]
        if any(t < 0 for t in tids):
            plan = None
        else:
            conj = self._docs_of(tids[0])
            for tid in tids[1:]:
                conj = np.intersect1d(
                    conj, self._docs_of(tid), assume_unique=True
                )
            if self._live_host is not None and len(conj):
                conj = conj[self._live_host[conj]]
            if len(conj) == 0:
                plan = ([], None, None, tids)
            else:
                C = max(8, 1 << int(np.ceil(np.log2(len(conj)))))
                cand = np.full(C, -1, dtype=np.int32)
                cand[: len(conj)] = conj
                ent = np.zeros((len(tids), C), dtype=np.int32)
                pos_caps = []
                for i, tid in enumerate(tids):
                    docs_t = self._docs_of(tid)
                    base = int(
                        pp.block_entry_start[int(pp.block_start[tid])]
                    )
                    ent[i, : len(conj)] = base + np.searchsorted(
                        docs_t, conj
                    )
                    bs, be = int(pp.block_start[tid]), int(
                        pp.block_start[tid + 1]
                    )
                    max_tf = (
                        int(pp.block_max_freq[bs:be].max()) if be > bs else 1
                    )
                    pos_caps.append(
                        max(4, 1 << int(np.ceil(np.log2(max_tf))))
                    )
                lead = int(np.argmin([len(self._docs_of(t)) for t in tids]))
                dev = f.device
                plan = (
                    torch.from_numpy(cand).to(dev),
                    torch.from_numpy(ent).to(dev),
                    (tuple(pos_caps), lead),
                    tids,
                )
        if len(self._plan_cache) < 1024:
            self._plan_cache[key] = plan
        return plan

    def top_k(
        self, terms: List[str], idf: float, k: int
    ) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
        plan = self._plan(terms)
        if plan is None:
            return None  # a term is missing: no phrase matches here
        cand, ent, caps_lead, _tids = plan
        if isinstance(cand, list):  # empty conjunction
            return (
                np.full(k, -1.0, dtype=np.float32),
                np.zeros(k, dtype=np.int32),
                0,
            )
        pos_caps, lead = caps_lead
        f = self.field
        f.ensure_positions()  # positions reach the device on first use
        kk = min(k, cand.shape[0])
        scores, docs, hits = phrase_positions_topk(
            f.pos_start,
            f.positions,
            f.norms,
            self.tf_lut,
            cand,
            ent,
            torch.tensor(np.float32(idf), device=f.device),
            pos_caps=pos_caps,
            lead=lead,
            k=kk,
        )
        # one device->host copy: the scores travel as their bit patterns
        fused = torch.cat(
            [scores.view(torch.int32), docs, hits.reshape(1)]
        ).cpu().numpy()
        scores = fused[:kk].view(np.float32)
        docs = fused[kk : 2 * kk]
        hits = int(fused[2 * kk])
        if kk < k:
            scores = np.concatenate(
                [scores, np.full(k - kk, -1.0, np.float32)]
            )
            docs = np.concatenate([docs, np.zeros(k - kk, np.int32)])
        return scores, docs, hits

    def score_row(self, terms: List[str], idf: float, num_docs: int):
        """Exact phrase clause rows: (scores f32 [num_docs], match f32
        [num_docs]), the compile target for phrase clauses inside boolean
        plans. The same position intersection as top_k, over the FULL
        candidate conjunction (k = C); scores bit-identical to the
        oracle's.

        Memoized by (terms, idf): a serving batch of phrase query objects
        repeating one phrase text would otherwise run the intersection
        once per object."""
        ck = (tuple(terms), float(idf))
        got = self._row_cache.get(ck)
        if got is not None:
            return got
        row = np.zeros(num_docs, np.float32)
        plan = self._plan(terms)
        if plan is None or isinstance(plan[0], list):
            out = (row, np.zeros(num_docs, np.float32))
        else:
            C = int(plan[0].shape[0])
            scores, docs, _hits = self.top_k(terms, idf, C)
            ok = scores > 0
            row[docs[ok]] = scores[ok]
            out = (row, (row > 0).astype(np.float32))
        if len(self._row_cache) < 64:
            self._row_cache[ck] = out
        return out
