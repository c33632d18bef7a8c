"""Carry state from the JAX package into the port.

- ``segment_from_jax`` and ``query_from_jax`` rebuild a ``diagon_tpu``
  segment or query as the port's own classes, reading attributes only, so
  the same data can be searched by both packages (the port's searcher
  takes nothing else); ``sparse_vector_from_jax`` and
  ``sparse_index_from_jax`` do the same for the sparse layer;
- ``row_field_index_from_state`` builds a port :class:`RowFieldIndex` on a
  given device from the numpy state of a ``diagon_tpu`` row index, so that
  both packages score the very same heavy bank.

Nothing here imports the JAX package: the caller passes its objects, and
converts JAX arrays to numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from diagon_tpu_torch.codecs.postings import PackedPostings
from diagon_tpu_torch.index.segment import (
    DocValuesData,
    DocValuesType,
    PointsData,
    SegmentData,
    SegmentFieldData,
)
from diagon_tpu_torch.search import query as Q
from diagon_tpu_torch.search.row_engine import RowFieldIndex, _pack_live_bits
from diagon_tpu_torch.sparse.index import SparseIndex
from diagon_tpu_torch.sparse.vector import SparseVector

STATE_KEYS = (
    "heavy_bank",  # f32 [H(+1), D]; a trailing scatter-dump row is dropped
    "heavy_row_of_term",  # i32 [T]
    "heavy_tid_of_row",  # i64 [H]
    "heavy_weight",  # f32 [H]
    "live",  # f32 [D]
    "tf_lut_host",  # f32 [128*F]
)


def _postings_from_jax(pp) -> PackedPostings:
    return PackedPostings(**{
        f.name: getattr(pp, f.name) for f in dataclasses.fields(PackedPostings)
    })


def segment_from_jax(seg) -> SegmentData:
    """The port's SegmentData for a ``diagon_tpu`` one. The arrays are
    shared, not copied, except the live-docs bitmap, which deletes
    mutate."""
    return SegmentData(
        name=seg.name,
        num_docs=seg.num_docs,
        fields={
            name: SegmentFieldData(_postings_from_jax(fd.postings), fd.norms,
                                   fd.with_positions)
            for name, fd in seg.fields.items()
        },
        doc_values={
            name: DocValuesData(DocValuesType[dv.dv_type.name], dv.docs,
                                dv.values, dv.ord_values, dv.value_start)
            for name, dv in seg.doc_values.items()
        },
        points={
            name: PointsData(pt.values, pt.docs, pt.is_double)
            for name, pt in seg.points.items()
        },
        stored=list(seg.stored),
        live_docs=None if seg.live_docs is None else np.array(seg.live_docs),
    )


def query_from_jax(q) -> Q.Query:
    """The port's query for a ``diagon_tpu`` one, by class name, nested
    clauses included; TypeError for a class the port does not have."""
    kind = type(q).__name__
    if kind == "TermQuery":
        out = Q.TermQuery(q.term.field, q.term.text)
    elif kind == "BooleanQuery":
        out = Q.BooleanQuery(
            [Q.BooleanClause(query_from_jax(c.query), Q.Occur[c.occur.name])
             for c in q.clauses],
            q.minimum_number_should_match,
        )
    elif kind == "PhraseQuery":
        out = Q.PhraseQuery(q.field, list(q.terms))
    elif kind == "MatchAllDocsQuery":
        out = Q.MatchAllDocsQuery()
    elif kind in ("NumericRangeQuery", "PointRangeQuery"):
        out = getattr(Q, kind)(q.field, q.lower, q.upper)
    elif kind == "DoubleRangeQuery":
        out = Q.DoubleRangeQuery(q.field, q.lower, q.upper, q.include_lower,
                                 q.include_upper)
    else:
        raise TypeError(f"no port counterpart for query type {kind}")
    out.boost = q.boost
    return out


def sparse_vector_from_jax(v) -> SparseVector:
    """The port's SparseVector for a ``diagon_tpu.sparse`` one."""
    return SparseVector(np.array(v.ids), np.array(v.values))


def sparse_index_from_jax(index) -> SparseIndex:
    """The port's SparseIndex over a ``diagon_tpu.sparse`` index's
    segment, scales and exact per-term CSR (arrays shared, not copied)."""
    return SparseIndex(segment_from_jax(index.segment), dict(index.scales),
                       dict(index.exact))


def row_field_index_from_state(pp, norms: np.ndarray, state: dict,
                               device) -> RowFieldIndex:
    """A port RowFieldIndex over postings ``pp`` and ``norms`` (the host
    data the JAX index was built from) holding the JAX index's bank."""
    missing = [k for k in STATE_KEYS if k not in state]
    if missing:
        raise KeyError(f"row index state lacks {missing}")
    live = np.asarray(state["live"], np.float32)
    bank = np.asarray(state["heavy_bank"], np.float32)
    H = len(state["heavy_tid_of_row"])
    if live.shape != (bank.shape[1],) or bank.shape[0] < max(1, H):
        raise ValueError(
            f"inconsistent state: bank {bank.shape}, live {live.shape}, H={H}"
        )
    idx = RowFieldIndex(
        pp, norms, bank.shape[1], None, state["tf_lut_host"], device
    )
    dev = idx.device
    idx.live = torch.from_numpy(live.copy()).to(dev)
    if idx.prunable:
        idx.live_bits = _pack_live_bits(idx.live)
    idx.set_heavy_bank(torch.from_numpy(np.array(bank[: max(1, H)])).to(dev))
    idx.heavy_row_of_term = np.asarray(state["heavy_row_of_term"], np.int32)
    idx.heavy_tid_of_row = np.asarray(state["heavy_tid_of_row"], np.int64)
    idx.heavy_weight = np.asarray(state["heavy_weight"], np.float32)
    return idx
