"""Packed posting-block format: the port's own copy of the parts of
``diagon_tpu/codecs/postings.py`` (and of ``codecs/bitpack.py``) it uses.

A segment's postings for one field are a struct-of-arrays: every posting
block (up to 128 postings of one term, docids ascending) is one row of
dense per-block metadata plus a slice of one shared uint32 word stream:

- doc-id deltas ``d[0]=0, d[i]=doc[i]-doc[i-1]`` packed at ``doc_bits``
  (per-block width), starting at word ``word_off``, word-aligned;
- freqs packed at ``freq_bits``, starting at word
  ``word_off + ceil(count*doc_bits/32)``; ``freq_bits == 0`` marks an
  all-freq-1 block with no freq section.

Values pack little-endian within u32 words, value i of a section at bit
``i * bits``; a value may straddle two words.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

BLOCK_SIZE = 128


def words_for(count: int, bits: int) -> int:
    return (count * bits + 31) // 32


def unpack_u32_numpy(words: np.ndarray, bits: int, count: int) -> np.ndarray:
    """Decode ``count`` values of ``bits`` bits from a u32 word stream."""
    words = np.asarray(words, dtype=np.uint64)
    # slack word so straddle reads never go out of bounds
    words = np.concatenate([words, np.zeros(1, dtype=np.uint64)])
    i = np.arange(count, dtype=np.uint64)
    bitpos = i * np.uint64(bits)
    widx = (bitpos >> np.uint64(5)).astype(np.int64)
    shift = bitpos & np.uint64(31)
    lo = words[widx] >> shift
    hi = np.where(
        shift == 0, np.uint64(0), words[widx + 1] << (np.uint64(32) - shift)
    )
    mask = np.uint64((1 << bits) - 1)
    return ((lo | hi) & mask).astype(np.uint32)


@dataclass
class PackedPostings:
    """One field's postings for one segment, as dense numpy arrays."""

    # per-term (T terms), term strings sorted ascending; tid = rank
    terms: List[str]
    block_start: np.ndarray  # int32 [T+1]
    doc_freq: np.ndarray  # int32 [T]
    total_tf: np.ndarray  # int64 [T]

    # per-block (NB blocks)
    block_term: np.ndarray  # int32 [NB]
    block_base: np.ndarray  # int32 [NB]
    block_count: np.ndarray  # int32 [NB]
    block_doc_bits: np.ndarray  # int32 [NB]
    block_freq_bits: np.ndarray  # int32 [NB]
    block_word_off: np.ndarray  # int32 [NB]
    block_max_freq: np.ndarray  # int32 [NB]
    block_max_norm: np.ndarray  # int32 [NB]
    # CSR offset of each block's first posting in segment posting order
    # (addresses the positions arrays)
    block_entry_start: np.ndarray  # int64 [NB+1]

    packed: np.ndarray  # uint32 [W] shared word stream (padded with slack)

    # positions (present iff the field was indexed with positions):
    # per posting-entry CSR offsets into the flat positions array
    pos_start: Optional[np.ndarray] = None  # int64 [NE+1]
    positions: Optional[np.ndarray] = None  # int32 [NP] absolute, ascending
    # lazy position decode: a thunk () -> (pos_start, positions) that
    # ensure_positions runs on first use
    pos_loader: Optional[object] = None

    # collection stats for the field
    sum_total_tf: int = 0
    sum_doc_freq: int = 0
    doc_count_with_field: int = 0

    # static decode-window size (words) covering any block's both sections
    max_window_words: int = 1

    @property
    def has_positions(self) -> bool:
        return self.pos_start is not None or self.pos_loader is not None

    def ensure_positions(self) -> None:
        """Materialize pos_start/positions from the lazy loader."""
        if self.pos_start is None and self.pos_loader is not None:
            self.pos_start, self.positions = self.pos_loader()
            self.pos_loader = None

    @property
    def num_terms(self) -> int:
        return len(self.terms)

    @property
    def num_blocks(self) -> int:
        return len(self.block_term)

    def term_id(self, term: str) -> int:
        """Sorted term lookup; -1 if absent."""
        lo, hi = 0, len(self.terms)
        while lo < hi:
            mid = (lo + hi) // 2
            if self.terms[mid] < term:
                lo = mid + 1
            else:
                hi = mid
        if lo < len(self.terms) and self.terms[lo] == term:
            return lo
        return -1


def build_packed_postings_csr(
    terms: List[str],
    entry_start: np.ndarray,  # int64 [T+1] CSR into docs/freqs
    docs: np.ndarray,  # int32/int64 [NE] ascending per term
    freqs: np.ndarray,  # int32/int64 [NE]
    pos_start: Optional[np.ndarray] = None,  # int64 [NE+1]
    positions: Optional[np.ndarray] = None,  # int32 [NP]
    norms: Optional[np.ndarray] = None,
) -> PackedPostings:
    """Pack CSR postings into the block format with the host packer
    (``csrc/host/bulk.cpp``, the JAX package's ``pack_blocks``): the same
    arrays as the JAX package's ``build_packed_postings_csr``."""
    from diagon_tpu_torch import native

    entry_start = np.asarray(entry_start, dtype=np.int64)
    if len(entry_start) != len(terms) + 1:
        raise ValueError("entry_start needs one offset per term plus one")
    if len(docs) == 0 or len(terms) == 0:
        return _empty_postings()
    cols = native.pack_blocks(entry_start, docs, freqs, norms)
    pp = PackedPostings(
        terms=list(terms),
        block_start=cols["block_start"],
        doc_freq=cols["doc_freq"],
        total_tf=cols["total_tf"],
        block_term=cols["block_term"],
        block_base=cols["block_base"],
        block_count=cols["block_count"],
        block_doc_bits=cols["block_doc_bits"],
        block_freq_bits=cols["block_freq_bits"],
        block_word_off=cols["block_word_off"],
        block_max_freq=cols["block_max_freq"],
        block_max_norm=cols["block_max_norm"],
        block_entry_start=cols["block_entry_start"],
        packed=cols["packed"],
        sum_total_tf=int(cols["total_tf"].sum()),
        sum_doc_freq=int(len(docs)),
        max_window_words=cols["max_window"],
    )
    if pos_start is not None:
        pp.pos_start = np.asarray(pos_start, dtype=np.int64)
        pp.positions = (
            np.asarray(positions, dtype=np.int32)
            if positions is not None and len(positions)
            else np.zeros(0, dtype=np.int32)
        )
    return pp


def _empty_postings() -> PackedPostings:
    """The JAX package's packing of no postings (two zero slack words)."""
    i32 = np.zeros(0, np.int32)
    return PackedPostings(
        terms=[], block_start=np.zeros(1, np.int32), doc_freq=i32,
        total_tf=np.zeros(0, np.int64), block_term=i32, block_base=i32,
        block_count=i32, block_doc_bits=i32, block_freq_bits=i32,
        block_word_off=i32, block_max_freq=i32, block_max_norm=i32,
        block_entry_start=np.zeros(1, np.int64),
        packed=np.zeros(2, np.uint32),
    )


def decode_block_numpy(pp: PackedPostings, b: int):
    """Oracle decoder for one block -> (docids i32, freqs i32)."""
    count = int(pp.block_count[b])
    db = int(pp.block_doc_bits[b])
    fb = int(pp.block_freq_bits[b])
    off = int(pp.block_word_off[b])
    dw = words_for(count, db)
    deltas = unpack_u32_numpy(pp.packed[off : off + dw], db, count)
    if fb == 0:  # all-freq-1 block: no freq section
        freqs = np.ones(count, dtype=np.uint32)
    else:
        fw = words_for(count, fb)
        freqs = unpack_u32_numpy(
            pp.packed[off + dw : off + dw + fw], fb, count
        )
    docs = int(pp.block_base[b]) + np.cumsum(deltas.astype(np.int64))
    return docs.astype(np.int32), freqs.astype(np.int32)
