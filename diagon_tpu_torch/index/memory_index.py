"""In-memory indexing buffer — the FreqProx equivalent: the port's own
copy of ``diagon_tpu/index/memory_index.py``.

Accumulates documents until flush, per field: term -> postings
(docids/freqs/positions), per-doc field lengths for norms, stored rows, doc
values, and points. Mirrors the reference's
``FreqProxTermsWriter.h:24-120`` + ``DocumentsWriterPerThread.cpp:128-369``
single-pass per-field dispatch. Standard-analyzed ASCII text and keyword
values accumulate in the port's host C++ (``native.FreqProx``,
``csrc/host/ingest.cpp``), built at first use; a failed build raises, and
no such value ever takes the Python dicts instead. The dicts take what the
JAX package gives them too: non-ASCII text, other analyzers, overridden
``tokenize`` methods and non-str values; a field that saw both is merged at
flush (``field_term_arrays``). ``ram_bytes_used`` counts what the JAX
package counts, so a ``ram_buffer_mb`` writer flushes at the same
documents.

Norm encoding matches ``DocumentsWriterPerThread.cpp:462-484``:
``norm = length <= 0 ? 127 : min(127, int(127/sqrt(length)))``.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Dict, List, Optional, Tuple

import numpy as np

from diagon_tpu_torch import native
from diagon_tpu_torch.document.document import (
    DocValuesType,
    Document,
    Field,
    IndexOptions,
)


def encode_norm(length: int) -> int:
    """Reference norm encoding (DocumentsWriterPerThread.cpp:462-484)."""
    if length <= 0:
        return 127
    encoded = 127.0 / float(np.sqrt(float(length)))
    if encoded > 127.0:
        return 127
    return int(encoded)  # truncation toward zero, as the C++ static_cast


def decode_norm_to_length(norm: int) -> float:
    """Reference norm decoding (BM25Similarity.h:216-224 / SimScorer)."""
    if norm == 0 or norm == 127:
        return 1.0
    inv = 127.0 / float(norm)
    return inv * inv


@dataclass
class _FieldBuffer:
    index_options: IndexOptions = IndexOptions.NONE
    with_positions: bool = False
    # term -> ([docids], [freqs], [positions per doc])
    postings: Dict[str, Tuple[List[int], List[int], List[List[int]]]] = dc_field(
        default_factory=dict
    )
    field_lengths: Dict[int, int] = dc_field(default_factory=dict)
    doc_count_with_field: int = 0
    # host (C++) accumulator for the plain-ASCII TextField hot path and
    # keywords; non-ASCII / custom-tokenizer adds take the Python dicts and
    # the two are merged at flush.
    native: object = None


@dataclass
class _DocValuesBuffer:
    dv_type: DocValuesType = DocValuesType.NONE
    docs: List[int] = dc_field(default_factory=list)
    values: list = dc_field(default_factory=list)


@dataclass
class _PointsBuffer:
    docs: List[int] = dc_field(default_factory=list)
    values: List[float] = dc_field(default_factory=list)
    is_double: bool = False


class MemoryIndex:
    """Mutable per-segment buffer; becomes immutable SegmentData on flush."""

    def __init__(self):
        from diagon_tpu_torch.index.field_infos import FieldInfosBuilder

        self.num_docs = 0
        self.fields: Dict[str, _FieldBuffer] = {}
        self.doc_values: Dict[str, _DocValuesBuffer] = {}
        self.points: Dict[str, _PointsBuffer] = {}
        self.stored: List[Dict[str, object]] = []
        self._ram_bytes = 0
        # write-time schema drift detection (reference FieldInfosBuilder);
        # sightings dedup by (name, FieldType identity, point value class)
        # so the per-doc cost is one set probe per field
        self._field_infos = FieldInfosBuilder()
        self._fi_seen: set = set()

    def _sight_field(self, f) -> None:
        key = (
            f.name,
            id(f.type),
            type(f.value) if f.type.point_dims else None,
        )
        if key not in self._fi_seen:
            self._field_infos.add_field(f)  # raises FieldSchemaError
            self._fi_seen.add(key)

    def field_infos(self):
        """FieldInfos snapshot of everything buffered so far."""
        return self._field_infos.finish()

    # ------------------------------------------------------------------
    def add_document(self, doc: Document) -> int:
        doc_id = self.num_docs
        self.num_docs += 1
        stored_row: Dict[str, object] = {}

        for f in doc.fields:
            ft = f.type
            self._sight_field(f)
            if ft.stored:
                stored_row[f.name] = f.value
            if ft.index_options != IndexOptions.NONE:
                self._add_inverted(f, doc_id)
            if ft.doc_values_type != DocValuesType.NONE:
                self._add_doc_values(f, doc_id)
            if ft.point_dims > 0:
                self._add_point(f, doc_id)

        self.stored.append(stored_row)
        return doc_id

    def add_documents(self, docs) -> int:
        """Bulk ingest (reference IndexWriter::addDocuments,
        IndexWriter.h:95-117): one native ``FreqProx.add_documents`` call
        per (field, run) instead of one Python call per document — the
        per-document interpreter overhead is most of the gap to the
        reference's 43k docs/s addDocument loop (README.md:50).

        Semantics match a ``for d in docs: add_document(d)`` loop exactly
        (same doc ids, postings, norms, stored rows). Docs that cannot
        ride the native batch (duplicate indexed field names, non-ASCII,
        custom analyzers) fall back to add_document, splitting the batch
        into runs around them. Returns the first assigned doc id."""
        docs = list(docs)
        first_id = self.num_docs
        run: list = []
        # static eligibility memo per (field class, name, FieldType
        # identity): analyzer / tokenize-override / index-options checks
        # don't depend on the value, and real corpora reuse a handful of
        # (class, name, type) shapes across millions of docs. Values:
        # 0 = skip (not indexed), 1 = tokenized (value must be ascii str),
        # 2 = keyword (value must be non-empty str), -1 = ineligible.
        static_elig: dict = {}

        def _bulk_eligible(d) -> bool:
            seen = []
            for f in d.fields:
                key = (f.__class__, f.name, id(f.type))
                e = static_elig.get(key)
                if e is None:
                    ft = f.type
                    if ft.index_options is IndexOptions.NONE:
                        e = 0
                    elif ft.tokenized:
                        e = (
                            1
                            if ft.analyzer == "standard"
                            and type(f).tokenize is Field.tokenize
                            else -1
                        )
                    else:
                        e = 2
                    static_elig[key] = e
                if e == 0:
                    continue
                if e == -1:
                    return False  # python tokenizer path per doc is
                    # fine, but keep runs homogeneous for simplicity
                if f.name in seen:
                    return False  # duplicate field: order-sensitive
                seen.append(f.name)
                v = f.value
                if e == 1:
                    if not (v.__class__ is str and v.isascii()):
                        return False
                elif not (v.__class__ is str and v):
                    # keyword path indexes str(value) — and even "" is a
                    # term there; only plain non-empty str rides the
                    # native case-sensitive batch
                    return False
            return True

        def _flush_run():
            if not run:
                return
            doc_id0 = self.num_docs
            n = len(run)
            texts: Dict[str, list] = {}
            keywords: Dict[str, list] = {}
            sight = self._sight_field
            stored_rows = self.stored
            _NONE_IO = IndexOptions.NONE
            _NONE_DV = DocValuesType.NONE
            for j, d in enumerate(run):
                stored_row: Dict[str, object] = {}
                doc_id = doc_id0 + j
                for f in d.fields:
                    ft = f.type
                    sight(f)
                    if ft.stored:
                        stored_row[f.name] = f.value
                    if ft.index_options is not _NONE_IO:
                        cols = texts if ft.tokenized else keywords
                        col = cols.get(f.name)
                        if col is None:
                            col = ["" if ft.tokenized else None] * n
                            cols[f.name] = col
                            if f.name not in self.fields:
                                self.fields[f.name] = _FieldBuffer(
                                    index_options=ft.index_options,
                                    with_positions=(
                                        ft.tokenized
                                        and ft.index_options
                                        == IndexOptions.DOCS_AND_FREQS_AND_POSITIONS
                                    ),
                                )
                        col[j] = f.value
                    if ft.doc_values_type is not _NONE_DV:
                        self._add_doc_values(f, doc_id)
                    if ft.point_dims > 0:
                        self._add_point(f, doc_id)
                stored_rows.append(stored_row)
            for name, col in texts.items():
                fb = self.fields[name]
                if fb.native is None:
                    fb.native = native.FreqProx()
                counts = fb.native.add_documents(
                    doc_id0, col, fb.with_positions
                )
                fb.doc_count_with_field += int((counts > 0).sum())
                self._ram_bytes += 12 * int(counts.sum())
            for name, col in keywords.items():
                fb = self.fields[name]
                if fb.native is None:
                    fb.native = native.FreqProx()
                # case-sensitive single-term-per-doc path (StringField)
                nk = fb.native.add_keywords(doc_id0, col)
                fb.doc_count_with_field += int(nk)
                self._ram_bytes += 12 * int(nk)
            self.num_docs += n
            run.clear()

        for d in docs:
            if _bulk_eligible(d):
                run.append(d)
            else:
                _flush_run()
                self.add_document(d)
        _flush_run()
        return first_id

    def _add_inverted(self, f, doc_id: int) -> None:
        fb = self.fields.get(f.name)
        if fb is None:
            fb = _FieldBuffer(
                index_options=f.type.index_options,
                with_positions=(
                    f.type.index_options
                    == IndexOptions.DOCS_AND_FREQS_AND_POSITIONS
                ),
            )
            self.fields[f.name] = fb

        # Host fast path: default standard tokenization of an ASCII str.
        if (
            f.type.tokenized
            and f.type.analyzer == "standard"
            and type(f).tokenize is Field.tokenize
            and isinstance(f.value, str)
            and f.value.isascii()
        ):
            if fb.native is None:
                fb.native = native.FreqProx()
            n = fb.native.add_document(doc_id, f.value, fb.with_positions)
            if n > 0:
                fb.doc_count_with_field += 1
            self._ram_bytes += 12 * n
            return

        tokens = f.tokenize()
        if not tokens:
            return
        fb.doc_count_with_field += 1
        fb.field_lengths[doc_id] = fb.field_lengths.get(doc_id, 0) + len(tokens)

        for pos, tok in enumerate(tokens):
            entry = fb.postings.get(tok)
            if entry is None:
                entry = ([], [], [])
                fb.postings[tok] = entry
                self._ram_bytes += 64 + len(tok)
            docs, freqs, poslists = entry
            if docs and docs[-1] == doc_id:
                freqs[-1] += 1
                if fb.with_positions:
                    poslists[-1].append(pos)
            else:
                docs.append(doc_id)
                freqs.append(1)
                if fb.with_positions:
                    poslists.append([pos])
            self._ram_bytes += 12

    def _add_doc_values(self, f, doc_id: int) -> None:
        dv = self.doc_values.get(f.name)
        if dv is None:
            dv = _DocValuesBuffer(dv_type=f.type.doc_values_type)
            self.doc_values[f.name] = dv
        if dv.dv_type != f.type.doc_values_type:
            raise ValueError(
                f"doc values type mismatch for field {f.name!r}: "
                f"{dv.dv_type} vs {f.type.doc_values_type}"
            )
        dv.docs.append(doc_id)
        dv.values.append(f.value)
        self._ram_bytes += 16

    def _add_point(self, f, doc_id: int) -> None:
        pb = self.points.get(f.name)
        if pb is None:
            pb = _PointsBuffer(is_double=isinstance(f.value, float))
            self.points[f.name] = pb
        pb.docs.append(doc_id)
        pb.values.append(f.value)
        self._ram_bytes += 16

    # ------------------------------------------------------------------
    def ram_bytes_used(self) -> int:
        return self._ram_bytes

    def compute_norms(self, field: str) -> np.ndarray:
        """uint8 norms for every doc in the buffer (0 for docs w/o field)."""
        fb = self.fields[field]
        lengths = np.zeros(self.num_docs, dtype=np.int64)
        for doc_id, length in fb.field_lengths.items():
            lengths[doc_id] += length
        nat = self._native_arrays(fb)
        if nat is not None:
            np.add.at(lengths, nat["field_docs"], nat["field_lens"])
        # Vectorized reference encoding: min(127, trunc(127/sqrt(len))).
        norms = np.zeros(self.num_docs, dtype=np.uint8)
        nz = lengths > 0
        enc = np.minimum(
            127.0, 127.0 / np.sqrt(lengths[nz].astype(np.float64))
        ).astype(np.uint8)
        norms[nz] = enc
        # Docs without the field keep norm 0, which decodes to length 1.0 —
        # same as the reference (missing docs never match anyway).
        return norms

    @staticmethod
    def _native_arrays(fb) -> Optional[dict]:
        """Drain + memoize the host accumulator's CSR arrays."""
        if fb.native is None:
            return None
        cached = getattr(fb, "_native_cache", None)
        if cached is not None:
            return cached
        out = fb.native.finish(fb.with_positions)
        fb._native_cache = out
        return out

    def field_term_arrays(
        self, field: str
    ) -> Tuple[
        Dict[str, Tuple[np.ndarray, np.ndarray]],
        Optional[Dict[str, List[np.ndarray]]],
    ]:
        """Postings as numpy arrays per term, for the packed codec."""
        fb = self.fields[field]
        postings = {}
        positions: Optional[Dict[str, List[np.ndarray]]] = (
            {} if fb.with_positions else None
        )
        for term, (docs, freqs, poslists) in fb.postings.items():
            postings[term] = (
                np.asarray(docs, dtype=np.int64),
                np.asarray(freqs, dtype=np.int64),
            )
            if positions is not None:
                positions[term] = [np.asarray(p, dtype=np.int32) for p in poslists]

        nat = self._native_arrays(fb)
        if nat is not None:
            es = nat["entry_start"]
            for tid, term in enumerate(nat["terms"]):
                s, e = int(es[tid]), int(es[tid + 1])
                ndocs = nat["docs"][s:e].astype(np.int64)
                nfreqs = nat["freqs"][s:e].astype(np.int64)
                nplists = None
                if positions is not None:
                    ps = nat["pos_start"]
                    nplists = [
                        nat["positions"][int(ps[j]) : int(ps[j + 1])]
                        for j in range(s, e)
                    ]
                if term in postings:
                    # merge with Python-path postings, re-sorted by docid;
                    # a doc hit by both paths (mixed ASCII/unicode field
                    # instances) combines freqs and positions.
                    pdocs, pfreqs = postings[term]
                    docs = np.concatenate([pdocs, ndocs])
                    freqs = np.concatenate([pfreqs, nfreqs])
                    order = np.argsort(docs, kind="stable")
                    docs, freqs = docs[order], freqs[order]
                    plists = None
                    if positions is not None:
                        plists = positions[term] + nplists
                        plists = [plists[i] for i in order]
                    if len(docs) > 1 and (np.diff(docs) == 0).any():
                        u_docs, u_freqs, u_plists = [], [], []
                        for i in range(len(docs)):
                            if u_docs and u_docs[-1] == docs[i]:
                                u_freqs[-1] += freqs[i]
                                if plists is not None:
                                    u_plists[-1] = np.concatenate(
                                        [u_plists[-1], plists[i]]
                                    )
                            else:
                                u_docs.append(docs[i])
                                u_freqs.append(freqs[i])
                                if plists is not None:
                                    u_plists.append(np.asarray(plists[i]))
                        docs = np.asarray(u_docs, dtype=np.int64)
                        freqs = np.asarray(u_freqs, dtype=np.int64)
                        if plists is not None:
                            plists = u_plists
                    postings[term] = (docs, freqs)
                    if positions is not None:
                        positions[term] = plists
                else:
                    postings[term] = (ndocs, nfreqs)
                    if positions is not None:
                        positions[term] = nplists
        return postings, positions
