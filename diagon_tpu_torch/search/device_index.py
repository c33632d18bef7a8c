"""Device-resident segment index (PyTorch).

Counterpart of ``diagon_tpu/search/device_index.py``: a flushed
:class:`SegmentData`'s packed postings arrays move to one device as
tensors; the term dictionary stays a host dict. Every function takes the
device explicitly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from diagon_tpu_torch.index.segment import SegmentData, SegmentFieldData
from diagon_tpu_torch.search.bm25 import BM25Similarity


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _tensor(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(device)  # a writable copy


@dataclass
class DeviceField:
    """One field's device tensors + host term dict."""

    # host
    term_ids: Dict[str, int]
    doc_freq: np.ndarray
    block_start: np.ndarray  # int32 [T+1]
    sum_total_tf: int
    doc_count_with_field: int
    window_words: int
    num_blocks: int
    with_positions: bool
    max_freq: int  # max term freq in the field (sizes the BM25 tf table)
    device: torch.device

    # device; the packed u32 word stream is held as its int32 bit pattern
    packed: torch.Tensor  # int32 [W]
    block_base: torch.Tensor  # int32 [NB]
    block_count: torch.Tensor
    block_doc_bits: torch.Tensor
    block_freq_bits: torch.Tensor
    block_word_off: torch.Tensor
    block_term: torch.Tensor
    block_max_freq: torch.Tensor
    block_max_norm: torch.Tensor
    block_entry_start: torch.Tensor
    norms: torch.Tensor  # int32 [num_docs_pad]

    # positions: host decode and device upload both wait for the first
    # phrase use (ensure_positions); only phrase queries read them
    pos_start: Optional[torch.Tensor] = None  # int32 [NE+1]
    positions: Optional[torch.Tensor] = None  # int32 [NP]
    max_positions_per_entry: int = 0
    _pos_pp: Optional[object] = None  # PackedPostings with (lazy) positions

    @property
    def with_position_data(self) -> bool:
        """The field has position data, decoded or still deferred; reads
        only what the load kept, uploads nothing."""
        return self.pos_start is not None or self._pos_pp is not None

    def ensure_positions(self) -> None:
        """Decode (if still deferred) and upload the position arrays."""
        if self.pos_start is not None or self._pos_pp is None:
            return
        pp = self._pos_pp
        pp.ensure_positions()
        if pp.pos_start is None:
            return
        pos = pp.positions if len(pp.positions) else np.zeros(1, np.int32)
        counts = np.diff(pp.pos_start)
        self.max_positions_per_entry = int(counts.max()) if len(counts) else 0
        self.pos_start = _tensor(pp.pos_start.astype(np.int32), self.device)
        self.positions = _tensor(np.asarray(pos, np.int32), self.device)

    def term_id(self, term: str) -> int:
        return self.term_ids.get(term, -1)


@dataclass
class DeviceSegment:
    """A segment resident on one device, with its host copy."""

    name: str
    num_docs: int
    num_docs_pad: int
    fields: Dict[str, DeviceField]
    live_docs: Optional[torch.Tensor]  # bool [num_docs_pad] or None
    # host copy (row builds, oracle clauses, stats); None when loaded with
    # keep_source=False, which only SegmentExecutor can serve
    source: Optional[SegmentData] = None

    def field(self, name: str) -> DeviceField:
        f = self.fields.get(name)
        if f is None:
            raise KeyError(f"field {name!r} is not indexed in segment {self.name}")
        return f


def _pad_blocks(arr: np.ndarray, nb_pad: int, fill=0) -> np.ndarray:
    out = np.full(nb_pad, fill, dtype=np.int32)
    out[: len(arr)] = arr
    return out


def load_field(fd: SegmentFieldData, num_docs_pad: int, device) -> DeviceField:
    pp = fd.postings
    nb = pp.num_blocks
    nb_pad = max(8, _round_up(nb, 8))
    norms32 = np.zeros(num_docs_pad, dtype=np.int32)
    norms32[: len(fd.norms)] = fd.norms.astype(np.int32)

    def blocks(arr, fill=0):
        return _tensor(_pad_blocks(arr, nb_pad, fill), device)

    return DeviceField(
        term_ids={t: i for i, t in enumerate(pp.terms)},
        doc_freq=pp.doc_freq.copy(),
        block_start=pp.block_start.copy(),
        sum_total_tf=pp.sum_total_tf,
        doc_count_with_field=pp.doc_count_with_field,
        window_words=pp.max_window_words,
        num_blocks=nb,
        with_positions=fd.with_positions,
        max_freq=int(pp.block_max_freq.max()) if nb else 1,
        device=device,
        packed=_tensor(pp.packed.view(np.uint32).view(np.int32), device),
        block_base=blocks(pp.block_base),
        block_count=blocks(pp.block_count),
        block_doc_bits=blocks(pp.block_doc_bits, fill=1),
        block_freq_bits=blocks(pp.block_freq_bits, fill=1),
        block_word_off=blocks(pp.block_word_off),
        block_term=blocks(pp.block_term, fill=-1),
        block_max_freq=blocks(pp.block_max_freq),
        block_max_norm=blocks(pp.block_max_norm),
        block_entry_start=blocks(pp.block_entry_start[:-1]),
        norms=_tensor(norms32, device),
        _pos_pp=pp if pp.has_positions else None,
    )


def load_segment(seg: SegmentData, device,
                 keep_source: bool = True) -> DeviceSegment:
    """Upload a segment's search structures to ``device``; the host
    segment stays as ``source`` unless ``keep_source`` is False.

    Docs pad to a multiple of 1024 (the row-sum kernels' D granule), and
    to 4096 once the segment exceeds 64k docs, the same rule as the JAX
    package, so both score the same padded doc axis."""
    device = torch.device(device)
    align = 4096 if seg.num_docs > (64 << 10) else 1024
    num_docs_pad = max(1024, _round_up(seg.num_docs, align))
    fields = {
        name: load_field(fd, num_docs_pad, device)
        for name, fd in seg.fields.items()
    }
    live = None
    if seg.live_docs is not None:
        lv = np.zeros(num_docs_pad, dtype=bool)
        lv[: seg.num_docs] = seg.live_docs
        live = _tensor(lv, device)
    return DeviceSegment(
        name=seg.name,
        num_docs=seg.num_docs,
        num_docs_pad=num_docs_pad,
        fields=fields,
        live_docs=live,
        source=seg if keep_source else None,
    )


def collection_stats(segments, field: str, max_doc: int):
    """avgdl across device segments, mirroring TermQuery.cpp:184-260: the
    sum of per-segment sumTotalTermFreq over docCount = maxDoc, in f32."""
    stt = 0
    for ds in segments:
        f = ds.fields.get(field)
        if f is not None and f.sum_total_tf > 0:
            stt += f.sum_total_tf
    if stt <= 0:
        stt = max_doc * 10
    return BM25Similarity.avg_field_length(stt, max_doc)
