"""Packed posting-block format: the port's own copy of the parts of
``diagon_tpu/codecs/postings.py`` it uses.

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
from typing import Dict, List, Optional, Tuple

import numpy as np

from diagon_tpu_torch.codecs.bitpack import unpack_u32_numpy, words_for

BLOCK_SIZE = 128


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


def build_packed_postings(
    term_postings: Dict[str, Tuple[np.ndarray, np.ndarray]],
    term_positions: Optional[Dict[str, List[np.ndarray]]] = None,
    norms: Optional[np.ndarray] = None,
) -> PackedPostings:
    """Pack per-term (docids, freqs) arrays into the block format: the JAX
    package's per-term dict packer, the same arrays.

    ``term_postings``: term -> (docids int array ascending, freqs int array).
    ``term_positions``: term -> list of per-doc position arrays (parallel to
    docids), or None for fields without positions.
    ``norms``: uint8 per-doc norm array used to compute block max-norm
    (may be None — max_norm falls back to 127).

    The JAX function packs block by block in Python; this one lays the
    dict out as CSR in sorted term order and packs it with the host packer
    (``csrc/host/bulk.cpp``), whose widths, offsets, maxima and word stream
    follow the same rules, so every array is the same.
    """
    terms = sorted(term_postings.keys())
    parts = [term_postings[t] for t in terms]
    entry_start = np.zeros(len(terms) + 1, np.int64)
    np.cumsum([len(d) for d, _ in parts], out=entry_start[1:])
    docs, freqs = (
        np.concatenate([np.asarray(p[i]) for p in parts]) if parts
        else np.zeros(0, np.int64) for i in (0, 1))
    pp = _pack(terms, entry_start, docs, freqs, norms)
    if term_positions is not None:
        plists = [p for t in terms for p in term_positions[t]]
        pos_start = np.zeros(len(plists) + 1, np.int64)
        np.cumsum([len(p) for p in plists], out=pos_start[1:])
        pp.pos_start = pos_start
        pp.positions = (np.concatenate(plists).astype(np.int32) if plists
                        else np.zeros(0, np.int32))
    return pp


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
    if len(entry_start) != len(terms) + 1:
        raise ValueError("entry_start needs one offset per term plus one")
    if len(docs) == 0 or len(terms) == 0:
        return _empty_postings()  # no positions, as in the JAX package
    pp = _pack(terms, entry_start, docs, freqs, norms)
    if pos_start is not None:
        pp.pos_start = np.asarray(pos_start, dtype=np.int64)
        pp.positions = (
            np.asarray(positions, dtype=np.int32)
            if positions is not None and len(positions)
            else np.zeros(0, dtype=np.int32)
        )
    return pp


def _pack(terms, entry_start, docs, freqs, norms) -> PackedPostings:
    """The host packer's block columns for CSR postings (no positions)."""
    from diagon_tpu_torch import native

    entry_start = np.asarray(entry_start, dtype=np.int64)
    if len(entry_start) != len(terms) + 1:
        raise ValueError("entry_start needs one offset per term plus one")
    if len(terms) == 0:
        return _empty_postings()
    cols = native.pack_blocks(entry_start, docs, freqs, norms)
    return PackedPostings(
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


def decode_all_numpy(pp: PackedPostings) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized full decode -> (docs int32 [NE], freqs int32 [NE]) in
    segment posting order (term-major, docid ascending)."""
    NB = pp.num_blocks
    if NB == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    words = np.concatenate(
        [pp.packed.astype(np.uint64), np.zeros(1, np.uint64)]
    )
    counts = pp.block_count.astype(np.int64)
    NE = int(pp.block_entry_start[NB])

    ent_block = np.repeat(np.arange(NB, dtype=np.int64), counts)
    ent_lane = (
        np.arange(NE, dtype=np.int64) - pp.block_entry_start[ent_block]
    )

    def unpack(bits_per_block, base_word):
        bits_e = bits_per_block[ent_block].astype(np.uint64)
        bitpos = ent_lane.astype(np.uint64) * bits_e
        widx = (base_word[ent_block].astype(np.uint64)
                + (bitpos >> np.uint64(5))).astype(np.int64)
        shift = bitpos & np.uint64(31)
        lo = words[widx] >> shift
        hi = np.where(
            shift == 0, np.uint64(0), words[widx + 1] << (np.uint64(32) - shift)
        )
        mask = (np.uint64(1) << bits_e) - np.uint64(1)
        return ((lo | hi) & mask).astype(np.int64)

    dbits = pp.block_doc_bits.astype(np.int64)
    deltas = unpack(dbits, pp.block_word_off.astype(np.int64))
    # per-block inclusive prefix sum of deltas: global cumsum minus the
    # cumsum value at each block start
    cs = np.cumsum(deltas)
    cs_at_start = cs[pp.block_entry_start[:NB]]
    docs = (
        pp.block_base[ent_block].astype(np.int64)
        + cs
        - cs_at_start[ent_block]
    )

    dwords = (counts * dbits + 31) >> 5
    fbits = pp.block_freq_bits.astype(np.int64)
    freqs = unpack(fbits, pp.block_word_off.astype(np.int64) + dwords)
    # fbits == 0 encodes an all-freq-1 block (no freq section)
    freqs = np.where(fbits[ent_block] == 0, 1, freqs)
    return docs.astype(np.int32), freqs.astype(np.int32)


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
