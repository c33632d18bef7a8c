"""Bit-unpacking of packed posting blocks in torch ops.

The port's counterpart of ``diagon_tpu/ops/bitpack_ops.py``: the same
functions, names, argument order and shapes. The format is
``codecs/bitpack.py``'s: values at a per-block fixed width, little-endian
within u32 words, a value may straddle two words. Lane ``i`` at width
``bits`` decodes as

    bitpos = word_base*32 + i*bits                      (u32, wraps)
    lo = window[bitpos >> 5] >> (bitpos & 31)
    hi = window[(bitpos >> 5) + 1] << (32 - (bitpos & 31))   (0 if aligned)
    value = (lo | hi) & ((1 << bits) - 1)                (0 if bits == 0)

The port holds the word stream as the int32 bit pattern of the u32 words
(``search/device_index.py``), and torch's ``>>`` on int32 is arithmetic, so
the lanes are computed on int64 values masked to 32 bits and returned as
the int32 bit pattern of the JAX u32 lanes. These are the plain versions X2
(``ops/block_score.py``) is held against; the CPU runs them.
"""

from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF


def _as_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> their int32 bit pattern."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def unpack_lanes(
    window: torch.Tensor,  # int32 [B, W] gathered words (u32 bit patterns)
    bits: torch.Tensor,  # int32 [B] bits per value per block
    word_base: torch.Tensor,  # int32 [B] first word of the section in-window
    num_lanes: int = 128,
) -> torch.Tensor:
    """Decode ``num_lanes`` values per block. Returns int32 [B, num_lanes].

    Lanes beyond a block's logical count decode whatever words follow
    (the next block's); callers mask by count.
    """
    W = window.shape[1]
    bits_u = bits.long()[:, None] & _U32
    lane = torch.arange(num_lanes, dtype=torch.int64, device=window.device)
    bitpos = ((word_base.long()[:, None] & _U32) * 32 + lane[None, :] * bits_u) & _U32
    widx = bitpos >> 5
    shift = bitpos & 31

    words = window.long() & _U32
    w0 = torch.gather(words, 1, torch.clamp(widx, max=W - 1))
    w1 = torch.gather(words, 1, torch.clamp(widx + 1, max=W - 1))

    lo = w0 >> shift
    # an aligned value has no high part (a shift by 32 is not a zero)
    hi = torch.where(shift == 0, 0, (w1 << (32 - shift)) & _U32)
    # bits == 0 is a valid width (an empty section): it decodes as 0
    mask = torch.where(bits_u == 0, 0, _U32 >> (32 - torch.clamp(bits_u, min=1)))
    return _as_i32((lo | hi) & mask)


def gather_windows(
    packed: torch.Tensor,  # int32 [W_total] shared word stream
    word_off: torch.Tensor,  # int32 [B] per-block word offsets
    window_words: int,
) -> torch.Tensor:
    """A fixed-size word window per block, clipped to the stream:
    int32 [B, window_words]."""
    idx = word_off.long()[:, None] + torch.arange(
        window_words, dtype=torch.int64, device=packed.device)[None, :]
    idx = torch.clamp(idx, 0, packed.shape[0] - 1)
    return packed[idx]


def decode_doc_blocks(
    packed: torch.Tensor,
    word_off: torch.Tensor,  # int32 [B]
    base: torch.Tensor,  # int32 [B]
    count: torch.Tensor,  # int32 [B]
    doc_bits: torch.Tensor,  # int32 [B]
    freq_bits: torch.Tensor,  # int32 [B]
    window_words: int,
):
    """Decode gathered posting blocks -> (docids, freqs, valid) each
    [B, 128]; docids and freqs int32, valid bool. Invalid lanes hold
    whatever the decode gives, with ``valid`` False."""
    window = gather_windows(packed, word_off, window_words)

    deltas = unpack_lanes(window, doc_bits, torch.zeros_like(word_off))
    docids = base[:, None] + torch.cumsum(deltas, dim=1, dtype=torch.int32)

    # the freq section starts word-aligned after ceil(count*doc_bits/32)
    dwords = (count * doc_bits + 31) >> 5
    freqs = unpack_lanes(window, freq_bits, dwords)
    # freq_bits == 0 encodes an all-freq-1 block (no freq section)
    freqs = torch.where(freq_bits[:, None] == 0, 1, freqs).to(torch.int32)

    lane = torch.arange(128, dtype=torch.int32, device=packed.device)
    valid = lane[None, :] < count[:, None]
    return docids, freqs, valid
