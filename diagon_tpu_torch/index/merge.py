"""Merge system: tiered merge policy + segment merger + schedulers; the
port's own copy of ``diagon_tpu/index/merge.py``.

Equivalents of the reference's merge layer (SURVEY.md section 2.4):
``TieredMergePolicy`` (TieredMergePolicy.h:33-112), ``SegmentMerger``
(SegmentMerger.cpp:423-462: k-way term merge with docBase remap), and
``ConcurrentMergeScheduler`` (one background merge thread,
ConcurrentMergeScheduler.cpp:35-66).

The merger differs from the reference's iterator k-way heap: segments are
columnar arrays, so merging is a vectorized decode, remap and concat over
every source's postings at once (numpy), then one repack — an array
program, not a stream program. The JAX merger decodes and concatenates
block by block and term by term in Python, then packs with the per-term
dict packer; this one gives the same segment (every array equal) from
whole-field arrays and the CSR packer.

Deliberate deviation: the merger materialises lazily loaded positions
(``ensure_positions``) before it reads them, so a merge that takes in a
segment read from disk (a writer reopened in APPEND mode) gives the same
segment as the merge of the in-memory sources. The JAX merger reads
``pos_start`` without doing so and raises IndexError there.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Sequence

import numpy as np

from diagon_tpu_torch.codecs.postings import (
    build_packed_postings_csr,
    decode_all_numpy,
)
from diagon_tpu_torch.index.segment import (
    DocValuesData,
    PointsData,
    SegmentData,
    SegmentFieldData,
    _multi_value_csr,
)


@dataclass
class OneMerge:
    segments: List[SegmentData]


@dataclass
class MergeSpecification:
    merges: List[OneMerge] = dc_field(default_factory=list)


class MergePolicy:
    def find_merges(self, segments: Sequence[SegmentData]) -> MergeSpecification:
        raise NotImplementedError

    def find_forced_merges(
        self, segments: Sequence[SegmentData], max_segment_count: int
    ) -> MergeSpecification:
        raise NotImplementedError


def segment_size_bytes(seg: SegmentData) -> int:
    """Approximate in-memory segment size (postings + norms + DV + points
    + stored refs) — the SegmentSize.sizeInBytes role
    (TieredMergePolicy.h:70-87) without a serialization pass."""
    total = 0
    for fd in seg.fields.values():
        pp = fd.postings
        for arr in (pp.packed, pp.block_start, pp.block_term,
                    pp.block_max_freq, pp.doc_freq):
            if arr is not None:
                total += arr.nbytes
        if pp.pos_start is not None:
            total += pp.pos_start.nbytes
        if pp.positions is not None:
            total += pp.positions.nbytes
        if fd.norms is not None:
            total += fd.norms.nbytes
    for dv in seg.doc_values.values():
        total += getattr(dv.docs, "nbytes", 0)
        vals = dv.values
        total += vals.nbytes if hasattr(vals, "nbytes") else 16 * len(vals)
    for pb in seg.points.values():
        total += pb.docs.nbytes + pb.values.nbytes
    total += 64 * len(seg.stored)  # row refs; payloads lazy
    return total


class TieredMergePolicy(MergePolicy):
    """Tiered merging, full reference behavior (TieredMergePolicy.h:33-112
    is interface-only; semantics follow its documented Lucene model):

    - segment sizes are DELETE-ADJUSTED (bytes * live/maxDoc) and floored
      to ``floor_segment_mb`` for tier math, so many tiny segments count
      as one floor-sized tier member instead of an infinite tail;
    - the index's ALLOWED segment count derives from total size: each
      tier holds ``segs_per_tier`` segments of ~``max_merge_at_once``x
      the size of the tier below; only when the index exceeds its
      allowance is a merge selected;
    - candidate merges are scored by SKEW (largest member / total) times
      a mild size preference, so the policy prefers balanced merges of
      small segments — the write-amplification/search-cost balance the
      reference documents;
    - no merge may produce a segment over ``max_merged_segment_mb``
      (candidates stop accumulating at the cap; oversized segments are
      never merge inputs unless mostly deleted).
    """

    def __init__(self, segs_per_tier: int = 10, max_merge_at_once: int = 10,
                 floor_segment_mb: float = 2.0,
                 max_merged_segment_mb: float = 5 * 1024.0):
        self.segs_per_tier = segs_per_tier
        self.max_merge_at_once = max_merge_at_once
        self.floor_segment_mb = floor_segment_mb
        self.max_merged_segment_mb = max_merged_segment_mb
        # forced-deletes threshold (reference findForcedDeletesMerges)
        self.deletes_pct_allowed = 10.0

    # -- size helpers (SegmentSize, TieredMergePolicy.h:70-87) --
    def _adjusted(self, seg: SegmentData) -> float:
        size = segment_size_bytes(seg)
        if seg.num_docs == 0:
            return 0.0
        return size * (seg.num_live_docs / seg.num_docs)

    def _floored(self, nbytes: float) -> float:
        return max(nbytes, self.floor_segment_mb * 1024 * 1024)

    def _allowed_count(self, sizes: List[float]) -> int:
        """Allowed segment count for the index's total size
        (calculateAllowedSegmentCount): segs_per_tier at each size level,
        levels scaling by max_merge_at_once from the floor size up."""
        total = sum(self._floored(s) for s in sizes)
        level = self.floor_segment_mb * 1024 * 1024
        allowed = 0.0
        while True:
            count_at_level = total / level
            if count_at_level < self.segs_per_tier:
                allowed += count_at_level
                break
            allowed += self.segs_per_tier
            total -= self.segs_per_tier * level
            level *= self.max_merge_at_once
        return max(self.segs_per_tier, int(np.ceil(allowed)))

    def find_merges(self, segments: Sequence[SegmentData]) -> MergeSpecification:
        spec = MergeSpecification()
        if len(segments) < 2:
            return spec
        sized = [(self._adjusted(s), s) for s in segments]
        if len(sized) <= self._allowed_count([sz for sz, _ in sized]):
            return spec
        max_bytes = self.max_merged_segment_mb * 1024 * 1024
        # largest-first, like getSortedSegments; oversized segments (would
        # exceed the cap even alone + smallest partner) are not eligible
        sized.sort(key=lambda t: -t[0])
        eligible = [t for t in sized if t[0] <= max_bytes / 2]
        if len(eligible) < 2:
            return spec
        best = None  # (score, [segments])
        for start in range(len(eligible) - 1):
            acc = 0.0
            members: List[SegmentData] = []
            floored_sum = 0.0
            largest = self._floored(eligible[start][0])
            for sz, seg in eligible[start:]:
                if len(members) >= self.max_merge_at_once:
                    break
                if acc + sz > max_bytes and len(members) >= 2:
                    break
                acc += sz
                floored_sum += self._floored(sz)
                members.append(seg)
            if len(members) < 2:
                continue
            # skew in [1/n, 1]: lower = more balanced = better; the
            # size term prefers reclaiming small-segment tiers first
            skew = largest / floored_sum
            score = skew * (acc ** 0.05)
            if best is None or score < best[0]:
                best = (score, members)
        if best is not None:
            spec.merges.append(OneMerge(best[1]))
        return spec

    def find_forced_deletes_merges(
        self, segments: Sequence[SegmentData]
    ) -> MergeSpecification:
        """Merge (rewrite) segments whose delete percentage exceeds
        deletes_pct_allowed (reference findForcedDeletesMerges)."""
        spec = MergeSpecification()
        victims = [
            s for s in segments
            if s.num_docs > 0
            and 100.0 * (s.num_docs - s.num_live_docs) / s.num_docs
            > self.deletes_pct_allowed
        ]
        for i in range(0, len(victims), self.max_merge_at_once):
            group = victims[i : i + self.max_merge_at_once]
            if group:
                spec.merges.append(OneMerge(group))
        return spec

    def find_forced_merges(
        self, segments: Sequence[SegmentData], max_segment_count: int
    ) -> MergeSpecification:
        """One round of forced merging, in segment (docid) order so that
        force_merge(1) keeps global doc order stable. The writer re-asks
        until the target count is reached."""
        spec = MergeSpecification()
        if len(segments) <= max_segment_count:
            return spec
        take = min(
            self.max_merge_at_once, len(segments) - max_segment_count + 1
        )
        if take >= 2:
            spec.merges.append(OneMerge(list(segments[:take])))
        return spec


class SegmentMerger:
    """Merges N segments into one, dropping deleted docs and remapping
    docids (the reference's docBase remap, SegmentMerger.cpp:67-149)."""

    @staticmethod
    def merge(
        segments: Sequence[SegmentData],
        name: str,
        live: Optional[Sequence[Optional[np.ndarray]]] = None,
    ) -> "tuple[SegmentData, List[np.ndarray]]":
        """Merge into one segment.

        ``live`` is an optional per-source live-docs snapshot (taken under
        the writer mutex) so a merge running on the scheduler thread sees a
        consistent view while deletes keep landing; deletes that arrive
        during the merge are re-applied by the writer via the returned
        ``doc_maps`` (old docid -> new docid, -1 = dropped), mirroring the
        reference's merged-deletes commit step.
        """
        # ----- cross-segment schema check (reference FieldInfos.merge;
        # structural derivation covers disk-loaded segments too) -----
        from diagon_tpu_torch.index.field_infos import (
            FieldInfos,
            infos_from_segment,
        )

        merged_infos = FieldInfos.merge(
            *[infos_from_segment(s) for s in segments]
        )  # raises FieldSchemaError on type drift

        # ----- docid remap (compact over deletions) -----
        doc_maps: List[np.ndarray] = []  # old docid -> new docid (-1 deleted)
        new_num_docs = 0
        for si, seg in enumerate(segments):
            snap = live[si] if live is not None else seg.live_docs
            live_mask = (
                np.ones(seg.num_docs, dtype=bool) if snap is None else snap
            )
            m = np.full(seg.num_docs, -1, dtype=np.int64)
            idx = np.nonzero(live_mask)[0]
            m[idx] = new_num_docs + np.arange(len(idx))
            new_num_docs += len(idx)
            doc_maps.append(m)

        out = SegmentData(name=name, num_docs=new_num_docs)
        out.field_infos = merged_infos

        # ----- inverted fields -----
        field_names: Dict[str, bool] = {}
        for seg in segments:
            for fname, fd in seg.fields.items():
                field_names[fname] = (
                    field_names.get(fname, True) and fd.with_positions
                )

        for fname, with_pos in field_names.items():
            merged = _merge_field(
                [seg.fields.get(fname) for seg in segments], doc_maps,
                new_num_docs, with_pos, fname,
            )
            if merged is not None:
                out.fields[fname] = merged

        # ----- doc values -----
        # Multi-valued types (SORTED_NUMERIC/SORTED_SET) store a CSR:
        # ``docs`` is unique docs, ``value_start`` offsets into ``values``.
        # Expand per-segment to flat (doc, value) rows, filter by the doc
        # map, then rebuild the CSR for the merged segment.
        dv_names = {n for seg in segments for n in seg.doc_values}
        for fname in dv_names:
            docs_parts, val_parts = [], []
            dv_type = None
            has_ords = False
            multi = False
            for si, seg in enumerate(segments):
                dv = seg.doc_values.get(fname)
                if dv is None:
                    continue
                dv_type = dv.dv_type
                has_ords = dv.ord_values is not None
                nd = doc_maps[si][dv.docs]
                if dv.value_start is not None:
                    multi = True
                    counts = np.diff(dv.value_start)
                    nd_flat = np.repeat(nd, counts)
                    keep = nd_flat >= 0
                    docs_parts.append(nd_flat[keep])
                    kept_vals = dv.values[keep]
                else:
                    keep = nd >= 0
                    docs_parts.append(nd[keep])
                    kept_vals = dv.values[keep]
                if has_ords:
                    val_parts.append([dv.ord_values[int(o)] for o in kept_vals])
                else:
                    val_parts.append(kept_vals)
            if not docs_parts:
                continue
            docs = np.concatenate(docs_parts).astype(np.int32)
            order = np.argsort(docs, kind="stable")
            if has_ords:
                raw = [v for part in val_parts for v in part]
                raw = [raw[i] for i in order]
                uniq = sorted(set(raw))
                omap = {b: i for i, b in enumerate(uniq)}
                vals = np.asarray([omap[b] for b in raw], dtype=np.int64)
                if multi:
                    mdocs, mvals, starts = _multi_value_csr(
                        docs[order], vals, sort_vals=True
                    )
                    out.doc_values[fname] = DocValuesData(
                        dv_type, mdocs, mvals, ord_values=uniq,
                        value_start=starts,
                    )
                else:
                    out.doc_values[fname] = DocValuesData(
                        dv_type, docs[order], vals, ord_values=uniq
                    )
            else:
                vals = (
                    np.concatenate(val_parts)[order]
                    if val_parts
                    else np.zeros(0, np.int64)
                )
                if multi:
                    mdocs, mvals, starts = _multi_value_csr(
                        docs[order], vals, sort_vals=True
                    )
                    out.doc_values[fname] = DocValuesData(
                        dv_type, mdocs, mvals, value_start=starts
                    )
                else:
                    out.doc_values[fname] = DocValuesData(
                        dv_type, docs[order], vals
                    )

        # ----- points -----
        pt_names = {n for seg in segments for n in seg.points}
        for fname in pt_names:
            v_parts, d_parts = [], []
            is_double = False
            for si, seg in enumerate(segments):
                pt = seg.points.get(fname)
                if pt is None:
                    continue
                is_double = pt.is_double
                nd = doc_maps[si][pt.docs]
                keep = nd >= 0
                v_parts.append(pt.values[keep])
                d_parts.append(nd[keep].astype(np.int32))
            vals = np.concatenate(v_parts)
            docs = np.concatenate(d_parts)
            order = np.lexsort((docs, vals))
            out.points[fname] = PointsData(vals[order], docs[order], is_double)

        # ----- stored fields -----
        for si, seg in enumerate(segments):
            dmap = doc_maps[si]
            for old_id, row in enumerate(seg.stored):
                if old_id < len(dmap) and dmap[old_id] >= 0:
                    out.stored.append(row)

        return out, doc_maps


def _merge_field(fds, doc_maps, new_num_docs: int, with_pos: bool,
                 fname: str) -> "Optional[SegmentFieldData]":
    """One inverted field of the merged segment from its sources' field
    data (None where a source lacks it), or None when no live posting is
    left. Every source's postings decode at once; each entry's term is
    renumbered into the sorted union of the terms that keep a live entry,
    and a stable sort by that number puts each term's entries in source
    order, which is docid order because each source's new docids follow
    the previous source's."""
    norms = np.zeros(new_num_docs, dtype=np.uint8)
    tid_parts, doc_parts, freq_parts, luts = [], [], [], []
    lo_parts, hi_parts, pos_parts = [], [], []
    pos_base = 0
    for fd, dmap in zip(fds, doc_maps):
        if fd is None:
            continue
        src_norms = fd.norms
        live_new = dmap[np.arange(len(src_norms))]
        keep = live_new >= 0
        norms[live_new[keep]] = src_norms[keep]

        pp = fd.postings
        docs, freqs = decode_all_numpy(pp)
        new_docs = dmap[docs]
        keep = new_docs >= 0
        tids = np.repeat(pp.block_term, pp.block_count)[keep]
        tid_parts.append(tids)
        doc_parts.append(new_docs[keep])
        freq_parts.append(freqs[keep])
        luts.append((pp.terms, np.unique(tids)))
        kept = np.nonzero(keep)[0]
        if with_pos and len(kept):
            pp.ensure_positions()
            if pp.pos_start is None:
                raise ValueError(f"field {fname!r}: a source indexed with "
                                 "positions has none")
            lo_parts.append(pp.pos_start[kept] + pos_base)
            hi_parts.append(pp.pos_start[kept + 1] + pos_base)
            pos_parts.append(pp.positions)
            pos_base += len(pp.positions)

    terms = sorted({terms[t] for terms, used in luts for t in used.tolist()})
    if not terms:
        return None
    merged_id = {t: i for i, t in enumerate(terms)}
    mtids = []
    for (src_terms, used), tids in zip(luts, tid_parts):
        lut = np.zeros(len(src_terms), np.int64)
        lut[used] = [merged_id[src_terms[t]] for t in used.tolist()]
        mtids.append(lut[tids])
    mtid = np.concatenate(mtids)
    order = np.argsort(mtid, kind="stable")
    entry_start = np.zeros(len(terms) + 1, np.int64)
    np.cumsum(np.bincount(mtid, minlength=len(terms)), out=entry_start[1:])
    docs = np.concatenate(doc_parts)[order]
    freqs = np.concatenate(freq_parts)[order]
    pos_start = positions = None
    if with_pos:
        lo = np.concatenate(lo_parts)[order]
        lens = np.concatenate(hi_parts)[order] - lo
        pos_start = np.zeros(len(lo) + 1, np.int64)
        np.cumsum(lens, out=pos_start[1:])
        gather = (np.repeat(lo - pos_start[:-1], lens)
                  + np.arange(pos_start[-1], dtype=np.int64))
        positions = np.concatenate(pos_parts)[gather]
    pp_new = build_packed_postings_csr(terms, entry_start, docs, freqs,
                                       pos_start, positions, norms)
    # docs-with-field across sources (live only): norms>0 surviving
    pp_new.doc_count_with_field = int((norms > 0).sum())
    return SegmentFieldData(postings=pp_new, norms=norms,
                            with_positions=with_pos)


class MergeScheduler:
    def execute(self, writer, spec: MergeSpecification) -> None:
        raise NotImplementedError

    def wait(self) -> None:
        pass

    def close(self) -> None:
        pass


class SerialMergeScheduler(MergeScheduler):
    def execute(self, writer, spec: MergeSpecification) -> None:
        for m in spec.merges:
            writer._do_merge(m)


class ConcurrentMergeScheduler(MergeScheduler):
    """One background merge thread, errors swallowed (like the reference's
    ConcurrentMergeScheduler.cpp:35-66)."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def execute(self, writer, spec: MergeSpecification) -> None:
        if not spec.merges:
            return
        self.wait()

        def run():
            for m in spec.merges:
                try:
                    writer._do_merge(m)
                except Exception:  # pragma: no cover - parity w/ reference
                    import traceback

                    traceback.print_exc()

        with self._lock:
            self._thread = threading.Thread(target=run, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        with self._lock:
            t = self._thread
        if t is not None:
            t.join()

    def close(self) -> None:
        self.wait()
