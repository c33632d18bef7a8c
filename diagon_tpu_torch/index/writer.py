"""The commit files' read side: the port's own copy of the commit-file
functions of ``diagon_tpu/index/writer.py`` (``_gen_name``, ``_parse_gen``,
``find_latest_commit_gen``, ``read_segment_infos``).

A commit is an atomic ``segments_<gen>`` file (the generation in base 36)
holding ``SegmentInfos.to_json()``; the newest generation is the index.
``IndexWriter`` (documents in, flush, commit, merge) is not ported yet: it
comes with the write path. Until then an index is written by the JAX
package's ``IndexWriter``, or by ``store.write_segment`` and a commit file
made from ``SegmentInfos(...).to_json()`` and ``_gen_name``.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

from diagon_tpu_torch.index.segment import SegmentInfos

SEGMENTS_PREFIX = "segments_"


def _gen_name(gen: int) -> str:
    return f"{SEGMENTS_PREFIX}{np.base_repr(gen, 36).lower()}"


def _parse_gen(name: str) -> int:
    return int(name[len(SEGMENTS_PREFIX):], 36)


def find_latest_commit_gen(directory) -> Optional[int]:
    gens = [
        _parse_gen(f)
        for f in directory.list_files()
        if f.startswith(SEGMENTS_PREFIX) and not f.endswith(".tmp")
    ]
    return max(gens) if gens else None


def read_segment_infos(directory, gen: Optional[int] = None) -> SegmentInfos:
    if gen is None:
        gen = find_latest_commit_gen(directory)
    if gen is None:
        return SegmentInfos()
    data = json.loads(directory.read_bytes(_gen_name(gen)).decode())
    infos = SegmentInfos.from_json(data)
    infos.generation = gen
    return infos
