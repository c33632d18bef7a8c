"""Immutable segment data: the port's own copy of the data classes of
``diagon_tpu/index/segment.py``.

``SegmentData`` is the flushed, immutable form of a segment: per-field packed
postings + norms, doc values, points, stored rows, live-docs bitmap. It is
the unit of search and of device residency
(``diagon_tpu_torch/search/device_index``). The port builds segments with
``diagon_tpu_torch.bench.bulk_build`` or carries one across from the JAX
package with ``diagon_tpu_torch.search.convert.segment_from_jax``; it has no
writer of its own.
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

    def delete_document(self, doc_id: int) -> bool:
        if doc_id < 0 or doc_id >= self.num_docs:
            return False
        if self.live_docs is None:
            self.live_docs = np.ones(self.num_docs, dtype=bool)
        was_live = bool(self.live_docs[doc_id])
        self.live_docs[doc_id] = False
        return was_live
