"""Posting blocks decoded into dense score rows (B9) and its plain version.

The row engine's banks (the resident heavy bank, each batch's light bank,
the on-demand row groups) hold one f32 row over the padded doc axis per
term spec ``(bank row, term id, scale)``: ``scale * lut[norm * F + freq]``
at each doc of the term's postings, zero elsewhere. ``bank_decode`` writes
those values into a zeroed bank in place. On CUDA tensors it launches the
hand-written kernel of ``csrc/bank_decode.cu``, one launch a bank; on CPU
tensors it runs ``bank_decode_reference``, the torch ops the port used
before the kernel, which is also what the kernel is held against on the
card. There is no fallback: a CUDA call launches or raises.

The kernel reads the postings from ``DecodeTables``, uploaded once per
field (``decode_tables``): the term -> block map, each block's word
offset, bit widths, base and count, the u32 word stream, the docs' norms
as bytes and the tf LUT. A call sends only its specs, packed on the host
by ``pack_specs`` with the exclusive prefix of their block counts, in one
copy. Each spec gets one IEEE multiply a posting and targets are unique,
so every version is bit-equal to the host decode
(``RowFieldIndex.host_row``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from diagon_tpu_torch.ops import _build, launch_counter
from diagon_tpu_torch.ops.row_sum import _sm_count

_LAUNCHES = launch_counter("bank_decode")

NORM_SLOTS = 128  # norm values index this many rows of F slots in the LUT
BLOCK = 128  # postings a block, at most
MAX_BITS = 32  # a delta or freq field's width, at most
THREADS = 256  # the kernel's block: 8 warps, a warp a posting block
BLOCKS_PER_SM = 8  # 2,048 threads an SM
# posting blocks per step of the plain version: bounds its temporaries
# ([chunk, 128] int64 values, a few of them live at once)
_REFERENCE_CHUNK_BLOCKS = 1 << 16


class DecodeTables(NamedTuple):
    """One field's posting tables on one device, as the kernel reads them."""

    block_start: torch.Tensor  # int32 [T+1]: term t's blocks
    word_off: torch.Tensor  # int32 [NB]: a block's first word
    doc_bits: torch.Tensor  # uint8 [NB]
    freq_bits: torch.Tensor  # uint8 [NB]; 0: every freq is 1
    base: torch.Tensor  # int32 [NB]: the block's first doc
    count: torch.Tensor  # uint8 [NB]: postings in the block
    packed: torch.Tensor  # int32 [W]: the u32 word stream's bit patterns
    norms: torch.Tensor  # uint8 [D]: each padded doc's norm
    lut: torch.Tensor  # f32 [NORM_SLOTS * F]
    F: int


def decode_tables(pp, norms, num_docs_pad: int, lut, device) -> DecodeTables:
    """Upload postings ``pp`` (a ``PackedPostings``), the docs' ``norms``
    and the tf ``lut`` (``NORM_SLOTS * F`` floats) to ``device``; raises
    where a value does not fit the kernel's types: a norm outside the LUT's
    128 norm slots, a block of more than 128 postings or a field wider
    than 32 bits, a word stream of 2**31 words or more."""
    lut = np.ascontiguousarray(lut, np.float32)
    if len(lut) == 0 or len(lut) % NORM_SLOTS:
        raise ValueError(f"the LUT holds {len(lut)} floats, not a positive "
                         f"multiple of {NORM_SLOTS}")
    norms = np.asarray(norms)
    if len(norms) > num_docs_pad:
        raise ValueError(f"{len(norms)} norms for {num_docs_pad} padded docs")
    if len(norms) and (int(norms.min()) < 0
                       or int(norms.max()) >= NORM_SLOTS):
        raise ValueError(
            f"norms span [{int(norms.min())}, {int(norms.max())}]: a norm "
            f"indexes one of the LUT's {NORM_SLOTS} norm slots")
    cols = {"count": (pp.block_count, BLOCK),
            "doc_bits": (pp.block_doc_bits, MAX_BITS),
            "freq_bits": (pp.block_freq_bits, MAX_BITS)}
    for name, (a, top) in cols.items():
        if len(a) and (int(a.min()) < 0 or int(a.max()) > top):
            raise ValueError(f"block {name} spans [{int(a.min())}, "
                             f"{int(a.max())}], outside [0, {top}]")
    packed = np.asarray(pp.packed).view(np.uint32)
    if len(packed) >= 1 << 31:
        raise ValueError(f"{len(packed)} words: the kernel indexes 2**31")
    if len(packed) == 0:
        packed = np.zeros(1, np.uint32)  # the clamped window reads word 0
    norms8 = np.zeros(num_docs_pad, np.uint8)
    norms8[: len(norms)] = norms

    def up(a, dtype):
        a = np.ascontiguousarray(a, dtype)
        if not a.flags.writeable:  # a loaded segment's mapped arrays
            a = a.copy()
        return torch.from_numpy(a).to(device)

    return DecodeTables(
        block_start=up(pp.block_start, np.int32),
        word_off=up(pp.block_word_off, np.int32),
        doc_bits=up(pp.block_doc_bits, np.uint8),
        freq_bits=up(pp.block_freq_bits, np.uint8),
        base=up(pp.block_base, np.int32),
        count=up(pp.block_count, np.uint8),
        packed=up(packed.view(np.int32), np.int32),
        norms=up(norms8, np.uint8),
        lut=up(lut, np.float32),
        F=len(lut) // NORM_SLOTS,
    )


def pack_specs(specs, block_start: np.ndarray, nrows: int) -> np.ndarray:
    """int32 [4, S+1] for specs ``(bank row, term id, scale)``: rows, term
    ids and the scales' f32 bit patterns in columns 0..S-1, and in row 3
    the exclusive prefix of the terms' block counts (``[3, S]``, the
    block total). Raises on a row outside ``[0, nrows)`` or an unknown
    term."""
    S = len(specs)
    out = np.zeros((4, S + 1), np.int32)
    if S == 0:
        return out
    rows, tids, scales = zip(*specs)
    rows = np.asarray(rows, np.int64)
    tids = np.asarray(tids, np.int64)
    T = len(block_start) - 1
    if rows.min() < 0 or rows.max() >= nrows:
        raise ValueError(f"bank rows span [{rows.min()}, {rows.max()}], "
                         f"outside [0, {nrows})")
    if tids.min() < 0 or tids.max() >= T:
        raise ValueError(f"term ids span [{tids.min()}, {tids.max()}], "
                         f"outside [0, {T})")
    n = block_start[tids + 1].astype(np.int64) - block_start[tids]
    prefix = np.cumsum(n)
    if prefix[-1] >= 1 << 31:
        raise ValueError(f"{prefix[-1]} blocks: a launch decodes < 2**31")
    out[0, :S] = rows
    out[1, :S] = tids
    out[2, :S] = np.asarray(scales, np.float32).view(np.int32)
    out[3, 1:] = prefix
    return out


def spec_blocks(specs: np.ndarray) -> int:
    """The posting blocks ``pack_specs``'s array decodes."""
    return int(specs[3, -1])


def _check(bank, specs, tables):
    """Raise on anything the kernel does not take; returns (R, D, S)."""
    dev = bank.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"bank_decode runs on cpu or cuda tensors, not {dev}")
    if bank.dtype != torch.float32 or bank.dim() != 2 \
            or not bank.is_contiguous():
        raise ValueError(f"bank must be a contiguous f32 [R, D], got "
                         f"{bank.dtype} {tuple(bank.shape)}")
    if not isinstance(specs, np.ndarray) or specs.dtype != np.int32 \
            or specs.ndim != 2 or specs.shape[0] != 4 or specs.shape[1] < 1:
        raise ValueError("specs must be pack_specs's int32 [4, S+1] array")
    for name, t in zip(DecodeTables._fields, tables):
        if isinstance(t, torch.Tensor) and t.device != dev:
            raise ValueError(f"table {name} is on {t.device}, bank on {dev}")
    R, D = bank.shape
    if tables.norms.shape[0] != D:
        raise ValueError(f"{tables.norms.shape[0]} norms for a bank of "
                         f"{D} docs")
    S = specs.shape[1] - 1
    if S and (int(specs[0, :S].min()) < 0 or int(specs[0, :S].max()) >= R):
        raise ValueError(f"a spec's row is outside the bank's {R} rows")
    return R, D, S


def bank_decode_reference(bank, specs, tables) -> None:
    """Plain PyTorch B9: the same values written into ``bank``, a step of
    ``_REFERENCE_CHUNK_BLOCKS`` blocks at a time. A 64-bit window over two
    words, clamped at the stream's last word, is shifted and masked per
    field; the one f32 multiply ``scale * tf`` is a plain IEEE product; the
    valid (row, doc) targets are unique, so the flat ``index_put_`` is
    exact."""
    _, D, S = _check(bank, specs, tables)
    total = spec_blocks(specs)
    if total == 0:
        return
    dev = bank.device
    F = tables.F
    sp = torch.from_numpy(specs.astype(np.int64)).to(dev)
    rows, tids, prefix = sp[0, :S], sp[1, :S], sp[3]
    scale = torch.from_numpy(specs[2, :S].view(np.float32).copy()).to(dev)
    spec_of = torch.repeat_interleave(
        torch.arange(S, device=dev), prefix[1:] - prefix[:-1])
    bsel = (tables.block_start.long()[tids][spec_of]
            + torch.arange(total, device=dev) - prefix[:-1][spec_of])
    packed = tables.packed
    last = packed.shape[0] - 1
    lane = torch.arange(BLOCK, device=dev, dtype=torch.int64)[None, :]

    def word(i):
        return packed[i.clamp(max=last)].long() & 0xFFFFFFFF

    def extract(bits, base_word):
        bitpos = lane * bits[:, None]
        widx = base_word[:, None] + (bitpos >> 5)
        mask = (1 << bits[:, None]) - 1
        return ((word(widx) | (word(widx + 1) << 32)) >> (bitpos & 31)) & mask

    for c0 in range(0, total, _REFERENCE_CHUNK_BLOCKS):
        b = bsel[c0 : c0 + _REFERENCE_CHUNK_BLOCKS]
        s = spec_of[c0 : c0 + _REFERENCE_CHUNK_BLOCKS]
        woff, dbits, fbits, base, count = (
            t[b].long() for t in (tables.word_off, tables.doc_bits,
                                  tables.freq_bits, tables.base, tables.count))
        deltas = extract(dbits, woff)
        dwords = (count * dbits + 31) >> 5
        freqs = extract(fbits, woff + dwords)
        freqs = torch.where(fbits[:, None] == 0, 1, freqs)  # no freq section
        docs = base[:, None] + torch.cumsum(deltas, dim=1)
        valid = lane < count[:, None]
        docs = torch.where(valid, docs, 0)
        tf = tables.lut[tables.norms[docs].long() * F + freqs.clamp(0, F - 1)]
        vals = scale[s][:, None] * tf
        flat = rows[s][:, None] * D + docs
        bank.view(-1).index_put_((flat[valid],), vals[valid])


def bank_decode(bank, specs, tables) -> None:
    """B9: decode ``pack_specs``'s specs into the zeroed f32 ``bank`` [R, D]
    in place, one launch (none for specs without blocks). The specs go up
    in one copy from pinned memory, without a wait."""
    _, D, S = _check(bank, specs, tables)
    if bank.device.type == "cpu":
        bank_decode_reference(bank, specs, tables)
        return
    total = spec_blocks(specs)
    if total == 0:
        return
    dev = bank.get_device()
    spec_dev = torch.from_numpy(specs).pin_memory().to(bank.device,
                                                      non_blocking=True)
    grid = min(-(-total // (THREADS // 32)), _sm_count(dev) * BLOCKS_PER_SM)
    rc = _build.library().diagon_bank_decode(
        bank.data_ptr(), spec_dev.data_ptr(), S, total,
        tables.block_start.data_ptr(), tables.word_off.data_ptr(),
        tables.doc_bits.data_ptr(), tables.freq_bits.data_ptr(),
        tables.base.data_ptr(), tables.count.data_ptr(),
        tables.packed.data_ptr(), tables.packed.shape[0],
        tables.norms.data_ptr(), tables.lut.data_ptr(), tables.F, D, grid,
        torch._C._cuda_getCurrentRawStream(dev),
    )
    if rc != 0:
        raise RuntimeError(f"diagon_bank_decode launch failed: cudaError {rc}")
    _LAUNCHES.increment()
