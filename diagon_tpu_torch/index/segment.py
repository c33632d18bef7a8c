"""Immutable segment data: the port's own copy of the data classes of
``diagon_tpu/index/segment.py``.

``SegmentData`` is the flushed, immutable form of a segment: per-field packed
postings + norms, doc values, points, stored rows, live-docs bitmap. It is
the unit of search and of device residency
(``diagon_tpu_torch/search/device_index``). The port builds segments with
``diagon_tpu_torch.bench.bulk_build``, reads one from disk with
``diagon_tpu_torch.store.read_segment`` (or a whole commit with
``diagon_tpu_torch.index.reader.DirectoryReader``), or carries one across
from the JAX package with ``diagon_tpu_torch.search.convert.segment_from_jax``;
it has no document writer of its own yet.

``SegmentInfo``/``SegmentInfos`` are the commit model: a commit is an
atomic generation file (``segments_<gen>``) listing immutable per-segment
artifact files.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional

import numpy as np

from diagon_tpu_torch.codecs.postings import PackedPostings


class DocValuesType(enum.Enum):
    NONE = 0
    NUMERIC = 1
    BINARY = 2
    SORTED = 3
    SORTED_NUMERIC = 4
    SORTED_SET = 5


@dataclass
class SegmentFieldData:
    """One indexed field within a segment: postings + norms."""

    postings: PackedPostings
    norms: np.ndarray  # uint8 [num_docs]
    with_positions: bool = False


@dataclass
class DocValuesData:
    dv_type: DocValuesType
    docs: np.ndarray  # int32 [n] ascending
    # NUMERIC/SORTED_NUMERIC: int64 values; SORTED/SORTED_SET/BINARY:
    # ord int32 into ``ord_values`` (sorted unique byte strings).
    values: np.ndarray
    ord_values: Optional[List[bytes]] = None
    # multi-valued CSR for SORTED_NUMERIC / SORTED_SET
    value_start: Optional[np.ndarray] = None


@dataclass
class PointsData:
    """1-D numeric point index: (value, docid) pairs sorted by value, so a
    range is two binary searches and a docid slice."""

    values: np.ndarray  # int64 or float64 [n], ascending
    docs: np.ndarray  # int32 [n], parallel
    is_double: bool = False


@dataclass
class SegmentData:
    name: str
    num_docs: int
    fields: Dict[str, SegmentFieldData] = dc_field(default_factory=dict)
    doc_values: Dict[str, DocValuesData] = dc_field(default_factory=dict)
    points: Dict[str, PointsData] = dc_field(default_factory=dict)
    stored: List[Dict[str, object]] = dc_field(default_factory=list)
    # live-docs bitmap; None means all live (reference .liv)
    live_docs: Optional[np.ndarray] = None  # bool [num_docs]

    @property
    def num_live_docs(self) -> int:
        if self.live_docs is None:
            return self.num_docs
        return int(self.live_docs.sum())

    def delete_document(self, doc_id: int) -> bool:
        if doc_id < 0 or doc_id >= self.num_docs:
            return False
        if self.live_docs is None:
            self.live_docs = np.ones(self.num_docs, dtype=bool)
        was_live = bool(self.live_docs[doc_id])
        self.live_docs[doc_id] = False
        return was_live


@dataclass
class SegmentInfo:
    """Per-segment commit metadata."""

    name: str
    num_docs: int
    files: List[str] = dc_field(default_factory=list)
    del_count: int = 0
    diagnostics: Dict[str, str] = dc_field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "num_docs": self.num_docs,
            "files": self.files,
            "del_count": self.del_count,
            "diagnostics": self.diagnostics,
        }

    @staticmethod
    def from_json(d: dict) -> "SegmentInfo":
        return SegmentInfo(
            name=d["name"],
            num_docs=d["num_docs"],
            files=list(d.get("files", [])),
            del_count=int(d.get("del_count", 0)),
            diagnostics=dict(d.get("diagnostics", {})),
        )


@dataclass
class SegmentInfos:
    """The commit point: generation + list of segments (``segments_N``)."""

    generation: int = 0
    segments: List[SegmentInfo] = dc_field(default_factory=list)
    counter: int = 0  # next segment name counter

    def to_json(self) -> dict:
        return {
            "generation": self.generation,
            "counter": self.counter,
            "segments": [s.to_json() for s in self.segments],
        }

    @staticmethod
    def from_json(d: dict) -> "SegmentInfos":
        return SegmentInfos(
            generation=int(d["generation"]),
            counter=int(d.get("counter", 0)),
            segments=[SegmentInfo.from_json(s) for s in d["segments"]],
        )

    def total_docs(self) -> int:
        return sum(s.num_docs for s in self.segments)
