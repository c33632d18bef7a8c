"""Index layer: write/read lifecycle; the port's counterpart of
``diagon_tpu/index``.

Equivalent of the reference's ``diagon/index/`` (SURVEY.md section 2.4):
IndexWriter + in-memory buffer + flush to immutable segment artifacts,
SegmentInfos manifest commits, DirectoryReader over segments, tiered merge.

The segment classes import at once. The rest loads on first use of its
name (``from diagon_tpu_torch.index import IndexWriter`` works): the
writer side imports the document model, whose ``DocValuesType`` lives in
``index.segment``, so an eager import here would close a cycle whenever
``diagon_tpu_torch.document`` is imported first.
"""

import importlib

from diagon_tpu_torch.index.segment import (  # noqa: F401
    SegmentData,
    SegmentFieldData,
    SegmentInfo,
    SegmentInfos,
)

_LAZY = {
    "MemoryIndex": "memory_index",
    "IndexWriter": "writer",
    "IndexWriterConfig": "writer",
    "DirectoryReader": "reader",
    "SegmentReader": "reader",
    "TieredMergePolicy": "merge",
    "MergeSpecification": "merge",
    "OneMerge": "merge",
    "SegmentMerger": "merge",
}

__all__ = ["SegmentData", "SegmentFieldData", "SegmentInfo", "SegmentInfos",
           *_LAZY]


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
