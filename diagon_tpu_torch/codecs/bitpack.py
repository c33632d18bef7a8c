"""Fixed-width bit packing into uint32 word streams: the port's own copy
of ``diagon_tpu/codecs/bitpack.py``, numpy only.

Values are packed little-endian at a fixed bits-per-value within each
section; a value may straddle a word boundary, in which case its low bits
live in word ``i`` and its high bits in word ``i+1``. That layout decodes
with two gathers, shifts and masks, branch-free, which is how the posting
blocks (``codecs/postings.py``) and the row-bank builds read it.
"""

from __future__ import annotations

import numpy as np


def bits_needed(max_value: int) -> int:
    """Minimum bits to represent values in [0, max_value]. At least 1."""
    if max_value < 0:
        raise ValueError("bit packing requires non-negative values")
    return max(1, int(max_value).bit_length())


def pack_u32(values: np.ndarray, bits: int) -> np.ndarray:
    """Pack non-negative ints into a little-endian uint32 word stream.

    Returns exactly ``ceil(len(values) * bits / 32)`` words.
    """
    values = np.asarray(values, dtype=np.uint64)
    n = len(values)
    if n == 0:
        return np.zeros(0, dtype=np.uint32)
    if bits < 1 or bits > 32:
        raise ValueError(f"bits must be in [1, 32], got {bits}")
    if values.max() >= (1 << bits):
        raise ValueError(f"value {values.max()} does not fit in {bits} bits")

    nwords = (n * bits + 31) // 32
    words = np.zeros(nwords + 1, dtype=np.uint64)  # +1 slack for straddle

    bitpos = np.arange(n, dtype=np.uint64) * np.uint64(bits)
    widx = (bitpos >> np.uint64(5)).astype(np.int64)
    shift = bitpos & np.uint64(31)

    lo = (values << shift) & np.uint64(0xFFFFFFFF)
    # a value that starts on a word boundary has no high part (numpy would
    # shift it by 32)
    hi = np.where(shift == 0, np.uint64(0),
                  values >> (np.uint64(32) - shift))

    np.add.at(words, widx, lo)
    np.add.at(words, widx + 1, hi)
    return words[:nwords].astype(np.uint32)


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


def words_for(count: int, bits: int) -> int:
    return (count * bits + 31) // 32
