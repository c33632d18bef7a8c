"""IndexWriter: add/update/delete documents, flush, commit, merge; the
port's own copy of ``diagon_tpu/index/writer.py``.

Equivalent of the reference's ``IndexWriter`` (``index/IndexWriter.h:176-380``):
single-writer lock, RAM-buffered docs flushed to immutable segments, atomic
``segments_<gen>`` commits, deferred deletion of superseded files, tiered
background merges, rollback to last commit.

Buffered deletes follow the reference model: ``delete_documents(term)``
applies eagerly to already-flushed segments (live-docs bitmap) and is
replayed against the RAM buffer's segment at flush time.

A commit is an atomic ``segments_<gen>`` file (the generation in base 36)
holding ``SegmentInfos.to_json()``; the newest generation is the index
(``find_latest_commit_gen``, ``read_segment_infos``; ``DirectoryReader``
opens it). The files are the JAX package's, byte for byte, so either
package reads what the other wrote.

The store tier (``store.format``) and the codec registry are imported
where they are used: the store imports ``index.segment``, and importing it
here would close a cycle.

Threads: with the concurrent scheduler a merge runs on a thread that takes
the writer's mutex to swap segments; ``commit``, ``force_merge``,
``rollback`` and ``close`` wait for it outside the mutex. Every call on the
in-memory buffer (and so on its host accumulators, ``native.FreqProx``,
which run with the interpreter lock released) is made under the mutex.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field as dc_field
from typing import List, Optional, Sequence, Set

import numpy as np

from diagon_tpu_torch.codecs.postings import decode_block_numpy
from diagon_tpu_torch.document.document import Document
from diagon_tpu_torch.index.memory_index import MemoryIndex
from diagon_tpu_torch.index.merge import (
    ConcurrentMergeScheduler,
    MergePolicy,
    MergeScheduler,
    OneMerge,
    SegmentMerger,
    SerialMergeScheduler,
    TieredMergePolicy,
)
from diagon_tpu_torch.index.segment import (
    SegmentData,
    SegmentInfo,
    SegmentInfos,
    flush_memory_index,
)

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


@dataclass
class IndexWriterConfig:
    ram_buffer_mb: float = 16.0
    max_buffered_docs: int = -1
    open_mode: str = "CREATE_OR_APPEND"  # CREATE | APPEND | CREATE_OR_APPEND
    commit_on_close: bool = True
    merge_policy: MergePolicy = dc_field(default_factory=TieredMergePolicy)
    merge_scheduler: str = "concurrent"  # concurrent | serial
    verify_checksums_on_open: bool = False
    codec: str = "DiagonTPU1"  # registered format name (codecs/registry.py)


class IndexWriter:
    def __init__(self, directory, config: Optional[IndexWriterConfig] = None):
        self.directory = directory
        self.config = config or IndexWriterConfig()
        self._lock = directory.obtain_lock("write.lock")
        self._mutex = threading.RLock()
        self._closed = False
        self._seq_no = 0

        self._scheduler: MergeScheduler = (
            ConcurrentMergeScheduler()
            if self.config.merge_scheduler == "concurrent"
            else SerialMergeScheduler()
        )

        mode = self.config.open_mode
        existing_gen = find_latest_commit_gen(directory)
        if mode == "CREATE" or (mode == "CREATE_OR_APPEND" and existing_gen is None):
            self._infos = SegmentInfos()
        elif mode == "APPEND" and existing_gen is None:
            raise FileNotFoundError("no commit to append to")
        else:
            self._infos = read_segment_infos(directory, existing_gen)

        from diagon_tpu_torch.store.format import read_segment

        # live SegmentData handles for everything in _infos
        self._segments: List[SegmentData] = [
            read_segment(
                directory, si.name, self.config.verify_checksums_on_open
            )
            for si in self._infos.segments
        ]
        self._mem = MemoryIndex()
        self._pending_delete_files: Set[str] = set()
        self._dirty_live_docs: Set[str] = set()
        # segments currently in a background merge (the reference's
        # mergingSegments_ guard, IndexWriter.h:356-378): without it two
        # overlapping merge specs would duplicate documents
        self._merging: Set[str] = set()

    # ------------------------------------------------------------------
    def _ensure_open(self):
        if self._closed:
            raise RuntimeError("IndexWriter is closed")

    def add_document(self, doc: Document) -> int:
        with self._mutex:
            self._ensure_open()
            self._mem.add_document(doc)
            self._seq_no += 1
            seq = self._seq_no
            self._maybe_flush()
            return seq

    def add_documents(self, docs: Sequence[Document]) -> int:
        """Bulk add (reference IndexWriter::addDocuments): the block is
        buffered atomically (no intermediate flush) through the native
        batch ingest path (MemoryIndex.add_documents)."""
        with self._mutex:
            self._ensure_open()
            docs = list(docs)
            self._mem.add_documents(docs)
            self._seq_no += len(docs)
            seq = self._seq_no
            self._maybe_flush()
            return seq

    def delete_documents(self, field: str, text: str) -> int:
        """Delete every doc containing term (reference deleteDocuments)."""
        with self._mutex:
            self._ensure_open()
            deleted = 0
            for seg in self._segments:
                deleted += self._apply_delete(seg, field, text)
            # buffer replay for in-RAM docs: flush, then delete on the
            # resulting segment (covers both the Python and native buffers)
            if self._mem.num_docs > 0:
                seg = self._flush_buffer()
                if seg is not None:
                    deleted += self._apply_delete(seg, field, text)
            self._seq_no += 1
            return deleted

    def _apply_delete(self, seg: SegmentData, field: str, text: str) -> int:
        fd = seg.fields.get(field)
        if fd is None:
            return 0
        pp = fd.postings
        tid = pp.term_id(text)
        if tid < 0:
            return 0
        n = 0
        for b in range(int(pp.block_start[tid]), int(pp.block_start[tid + 1])):
            docs, _ = decode_block_numpy(pp, b)
            for d in docs:
                if seg.delete_document(int(d)):
                    n += 1
        if n:
            self._dirty_live_docs.add(seg.name)
        return n

    def update_document(self, field: str, text: str, doc: Document) -> int:
        with self._mutex:
            self._ensure_open()
            self.delete_documents(field, text)
            return self.add_document(doc)

    # ------------------------------------------------------------------
    def _maybe_flush(self):
        cfg = self.config
        if (
            cfg.max_buffered_docs > 0
            and self._mem.num_docs >= cfg.max_buffered_docs
        ) or self._mem.ram_bytes_used() > cfg.ram_buffer_mb * 1024 * 1024:
            self._flush_buffer()

    def _next_segment_name(self) -> str:
        name = f"_{np.base_repr(self._infos.counter, 36).lower()}"
        self._infos.counter += 1
        return name

    def _flush_buffer(self) -> Optional[SegmentData]:
        if self._mem.num_docs == 0:
            return None
        seg = flush_memory_index(self._mem, self._next_segment_name())
        self._mem = MemoryIndex()
        from diagon_tpu_torch.codecs.registry import for_name

        files = for_name(self.config.codec).write_segment(self.directory, seg)
        self._segments.append(seg)
        self._infos.segments.append(
            SegmentInfo(name=seg.name, num_docs=seg.num_docs, files=files)
        )
        return seg

    def flush(self) -> None:
        """Flush buffered docs to a new segment (no segments_N write)."""
        with self._mutex:
            self._ensure_open()
            self._flush_buffer()

    def commit(self) -> int:
        """Flush + atomic segments_N + fsync + cleanup (IndexWriter.h:237).

        maybe_merge runs OUTSIDE the writer mutex: the scheduler joins the
        previous merge thread, which itself needs the mutex to swap
        segments — joining while holding it would deadlock."""
        with self._mutex:
            self._ensure_open()
            self._flush_buffer()
            gen = self._write_segments_file()
        self.maybe_merge()
        return gen

    def _write_segments_file(self) -> int:
        # refresh .liv files for segments with new deletes
        for seg in self._segments:
            if seg.name in self._dirty_live_docs and seg.live_docs is not None:
                liv = f"{seg.name}.liv"
                self.directory.write_bytes(
                    liv, np.packbits(seg.live_docs).tobytes()
                )
                info = self._info_for(seg.name)
                if info is not None and liv not in info.files:
                    info.files.append(liv)
        self._dirty_live_docs.clear()

        for info, seg in zip(self._infos.segments, self._segments):
            info.del_count = seg.num_docs - seg.num_live_docs

        old_gen = self._infos.generation
        self._infos.generation += 1
        payload = json.dumps(self._infos.to_json()).encode()
        self.directory.write_bytes(_gen_name(self._infos.generation), payload)
        self.directory.sync(
            [f for si in self._infos.segments for f in si.files]
            + [_gen_name(self._infos.generation)]
        )
        self.directory.sync_meta()

        # deferred deletes: drop superseded files + stale generations
        for f in list(self._pending_delete_files):
            try:
                self.directory.delete_file(f)
                self._pending_delete_files.discard(f)
            except OSError:
                pass
        if old_gen > 0:
            try:
                self.directory.delete_file(_gen_name(old_gen))
            except OSError:
                pass
        return self._infos.generation

    def _info_for(self, name: str) -> Optional[SegmentInfo]:
        for si in self._infos.segments:
            if si.name == name:
                return si
        return None

    # ------------------------------------------------------------------
    def maybe_merge(self) -> None:
        with self._mutex:
            candidates = [
                s for s in self._segments if s.name not in self._merging
            ]
            spec = self.config.merge_policy.find_merges(candidates)
            for m in spec.merges:
                self._merging.update(seg.name for seg in m.segments)
        if spec.merges:
            self._scheduler.execute(self, spec)

    def force_merge(self, max_num_segments: int = 1) -> None:
        """Synchronously merge down to <= max_num_segments."""
        self._scheduler.wait()  # drain background merges first
        with self._mutex:
            self._ensure_open()
            self._flush_buffer()
        while True:
            with self._mutex:
                live = [s for s in self._segments]
                if len(live) <= max_num_segments:
                    break
                spec = self.config.merge_policy.find_forced_merges(
                    live, max_num_segments
                )
                if not spec.merges:
                    break
            for m in spec.merges:
                self._do_merge(m)

    def wait_for_merges(self) -> None:
        self._scheduler.wait()

    def commit_merge_results(self) -> int:
        """Persist post-merge segmentInfos without flushing (reference
        commitMergeResults, IndexWriter.h:276-290)."""
        with self._mutex:
            self._ensure_open()
            return self._write_segments_file()

    def _do_merge(self, merge: OneMerge) -> None:
        # Snapshot live-docs under the mutex: the merge runs on the
        # scheduler thread while delete_documents keeps mutating live_docs;
        # deletes that land during the merge are re-applied to the merged
        # segment below (the reference's merged-deletes commit step).
        with self._mutex:
            live_snaps = [
                None if s.live_docs is None else s.live_docs.copy()
                for s in merge.segments
            ]
        merged, doc_maps = SegmentMerger.merge(
            merge.segments, name="_tmp", live=live_snaps
        )
        src_names = {s.name for s in merge.segments}
        with self._mutex:
            if self._closed or not src_names.issubset(
                {s.name for s in self._segments}
            ):
                # a source vanished (concurrent merge/rollback): abort
                self._merging.difference_update(src_names)
                return
            # re-apply deletes that arrived during the merge
            for seg, snap, dmap in zip(merge.segments, live_snaps, doc_maps):
                cur = seg.live_docs
                if cur is None:
                    continue
                was = (
                    np.ones(seg.num_docs, dtype=bool) if snap is None else snap
                )
                newly_dead = np.nonzero(was & ~cur)[0]
                for old_id in newly_dead:
                    new_id = int(dmap[old_id])
                    if new_id >= 0:
                        merged.delete_document(new_id)
            from diagon_tpu_torch.store.format import write_segment

            merged.name = self._next_segment_name()
            files = write_segment(self.directory, merged)
            # swap under the lock (IndexWriter.h:358-378 deferred deletes);
            # the merged segment takes the first source's position so global
            # docid order stays stable across forced-merge rounds.
            new_segments, new_infos = [], []
            inserted = False
            for seg, info in zip(self._segments, self._infos.segments):
                if seg.name in src_names:
                    self._pending_delete_files.update(info.files)
                    if not inserted:
                        new_segments.append(merged)
                        new_infos.append(
                            SegmentInfo(
                                name=merged.name,
                                num_docs=merged.num_docs,
                                files=files,
                            )
                        )
                        inserted = True
                else:
                    new_segments.append(seg)
                    new_infos.append(info)
            if not inserted:
                new_segments.append(merged)
                new_infos.append(
                    SegmentInfo(
                        name=merged.name, num_docs=merged.num_docs, files=files
                    )
                )
            self._segments = new_segments
            self._infos.segments = new_infos
            self._merging.difference_update(src_names)

    # ------------------------------------------------------------------
    def rollback(self) -> None:
        """Discard uncommitted state; restore last commit (the reference
        acknowledges its rollback is partial — ours is complete)."""
        from diagon_tpu_torch.store.format import read_segment

        self._scheduler.wait()  # outside the mutex (merge threads need it)
        with self._mutex:
            self._ensure_open()
            self._mem = MemoryIndex()
            gen = find_latest_commit_gen(self.directory)
            self._infos = (
                read_segment_infos(self.directory, gen)
                if gen is not None
                else SegmentInfos()
            )
            committed = {si.name for si in self._infos.segments}
            # delete uncommitted segment files
            for f in self.directory.list_files():
                base = f.split(".")[0]
                if (
                    f.endswith((".bnd", ".liv"))
                    and base.startswith("_")
                    and base not in committed
                ):
                    try:
                        self.directory.delete_file(f)
                    except OSError:
                        pass
            self._segments = [
                read_segment(self.directory, si.name)
                for si in self._infos.segments
            ]
            self._dirty_live_docs.clear()
            # Deferred deletes queued by uncommitted merges reference files
            # the restored commit still needs; dropping the queue here (and
            # re-deriving nothing — committed files are never queued twice)
            # prevents the next commit from deleting live segments.
            self._pending_delete_files.clear()
            self._merging.clear()

    def close(self) -> None:
        self._scheduler.wait()  # outside the mutex (merge threads need it)
        with self._mutex:
            if self._closed:
                return
            try:
                if self.config.commit_on_close:
                    self._flush_buffer()
                    self._write_segments_file()
            finally:
                self._scheduler.close()
                self._closed = True
                self._lock.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- introspection ---------------------------------------------------
    @property
    def segment_count(self) -> int:
        with self._mutex:
            return len(self._segments)

    def num_docs(self) -> int:
        with self._mutex:
            return (
                sum(s.num_live_docs for s in self._segments)
                + self._mem.num_docs
            )

    def ram_bytes_used(self) -> int:
        return self._mem.ram_bytes_used()
