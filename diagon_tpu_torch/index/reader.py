"""DirectoryReader / SegmentReader, point-in-time index snapshots: the
port's own copy of ``diagon_tpu/index/reader.py``. The port's
``IndexSearcher`` takes a ``DirectoryReader`` (or its leaves) as it takes
segments, so an index on disk is served with
``IndexSearcher(DirectoryReader.open(FSDirectory(path)), device="cuda")``.

Equivalent of the reference's reader stack (``DirectoryReader.cpp:13-80``,
``SegmentReader.cpp``): open the latest commit generation, one SegmentReader
per segment, ``leaves()`` exposing docBase offsets. Readers are immutable
snapshots; a reopen returns a new reader at the newest generation.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from diagon_tpu_torch.index.segment import SegmentData, SegmentInfos
from diagon_tpu_torch.index.writer import read_segment_infos


@dataclass
class LeafReaderContext:
    reader: "SegmentReader"
    ord: int
    doc_base: int


class SegmentReader:
    def __init__(self, data: SegmentData):
        self.data = data

    @property
    def name(self) -> str:
        return self.data.name

    def max_doc(self) -> int:
        return self.data.num_docs

    def num_docs(self) -> int:
        return self.data.num_live_docs

    def live_docs(self):
        return self.data.live_docs

    def terms(self, field: str):
        fd = self.data.fields.get(field)
        return fd.postings if fd is not None else None

    def norms(self, field: str):
        fd = self.data.fields.get(field)
        return fd.norms if fd is not None else None

    def doc_values(self, field: str):
        return self.data.doc_values.get(field)

    def points(self, field: str):
        return self.data.points.get(field)

    def document(self, doc_id: int) -> Dict[str, object]:
        if 0 <= doc_id < len(self.data.stored):
            return self.data.stored[doc_id]
        return {}


class DirectoryReader:
    def __init__(self, directory, infos: SegmentInfos,
                 segments: List[SegmentData]):
        self.directory = directory
        self.segment_infos = infos
        self._readers = [SegmentReader(s) for s in segments]
        self._leaves: List[LeafReaderContext] = []
        base = 0
        for i, r in enumerate(self._readers):
            self._leaves.append(LeafReaderContext(r, i, base))
            base += r.max_doc()
        self._max_doc = base

    @staticmethod
    def open(directory, verify_checksums: bool = False) -> "DirectoryReader":
        # imported here: the store imports index.segment, whose package
        # imports this module
        from diagon_tpu_torch.store.format import read_segment

        infos = read_segment_infos(directory)
        segments = [
            read_segment(directory, si.name, verify_checksums)
            for si in infos.segments
        ]
        return DirectoryReader(directory, infos, segments)

    def reopen(self) -> "DirectoryReader":
        """New reader at the latest commit (reference ReaderReopenTest)."""
        return DirectoryReader.open(self.directory)

    def leaves(self) -> List[LeafReaderContext]:
        return self._leaves

    def max_doc(self) -> int:
        return self._max_doc

    def num_docs(self) -> int:
        return sum(r.num_docs() for r in self._readers)

    def segments_data(self) -> List[SegmentData]:
        return [r.data for r in self._readers]

    def document(self, doc_id: int) -> Dict[str, object]:
        for leaf in reversed(self._leaves):
            if doc_id >= leaf.doc_base:
                return leaf.reader.document(doc_id - leaf.doc_base)
        return {}

    @property
    def generation(self) -> int:
        return self.segment_infos.generation
