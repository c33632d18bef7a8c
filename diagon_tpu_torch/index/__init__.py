"""Index layer: segments, commits and readers; the port's counterpart of
``diagon_tpu/index`` for what is ported so far (the write path, with
``MemoryIndex``, ``IndexWriter`` and merges, is not)."""

from diagon_tpu_torch.index.segment import (  # noqa: F401
    SegmentData,
    SegmentFieldData,
    SegmentInfo,
    SegmentInfos,
)
from diagon_tpu_torch.index.reader import (  # noqa: F401
    DirectoryReader,
    SegmentReader,
)
