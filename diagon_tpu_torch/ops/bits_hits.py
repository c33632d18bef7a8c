"""Exact hit counts from presence bitmaps (B8) and its plain version.

``bits_hits`` is the port's counterpart of
``diagon_tpu/ops/pallas/bits_hits.py``'s ``pallas_bits_hits``: the same
arguments in the same order and the same counts. On CUDA tensors it
launches the hand-written kernel of ``csrc/bits_hits.cu``; on CPU tensors
it runs ``bits_hits_reference``, which is also what the kernel is held
against on the card. There is no fallback: a CUDA call launches or raises.

Each compact-bank row is a bitmap over the padded doc axis: bit d % 32 of
word d // 32 is set where the row's score is > 0 and doc d is live. The
port holds the u32 words as int32 bit patterns (torch has no general
uint32 arithmetic). Per query, with the role flags of its clauses (bit1
required, bit2 should, bit3 must_not) and its mode word:

  match = (REQ ? AND of required rows : ~0) & (SHO ? OR of should rows : ~0)
          & ~(OR of must_not rows)

and the hit count is the popcount of ``match`` over the words, or 0 for a
DEAD query. It equals the oracle's live match count whenever min_should
<= 1 and MODE_DEAD marks an absent required clause (the caller's
contract, as in the JAX package).
"""

from __future__ import annotations

import torch

from diagon_tpu_torch.ops import _build

# per-query mode word bits (the JAX module's values)
MODE_REQ = 1  # query has required clauses (all present): AND them
MODE_SHO = 2  # query needs >= 1 should match (min_should >= 1 or no req)
MODE_DEAD = 4  # query can never match (absent required clause): hits 0

_MAX_SPANS = 65535  # the kernel's grid.y: 1024-word spans of a row
_SHARED_INTS = 12 << 10  # the kernel's static shared-memory budget, in i32
# words per query chunk of the plain version's [chunk, W] temporaries
_REFERENCE_CHUNK_WORDS = 1 << 24


def _check(bits, cidx, cflags, qmode):
    """Raise on anything the kernel does not take; returns (U8, W, Q, Tq)."""
    dev = bits.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"bits_hits runs on cpu or cuda tensors, not {dev}")
    tensors = {"bits": bits, "cidx": cidx, "cflags": cflags, "qmode": qmode}
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, bits on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be torch.int32, got {t.dtype}")
    if bits.dim() != 2 or cidx.dim() != 2:
        raise ValueError(f"bits {tuple(bits.shape)} and cidx "
                         f"{tuple(cidx.shape)} must be [U8, W] and [Q, Tq]")
    U8, W = bits.shape
    Q, Tq = cidx.shape
    if tuple(cflags.shape) != (Q, Tq) or tuple(qmode.shape) != (Q,):
        raise ValueError(f"cflags {tuple(cflags.shape)} and qmode "
                         f"{tuple(qmode.shape)} must be {(Q, Tq)} and {(Q,)}")
    if min(U8, W, Q, Tq) < 1:
        raise ValueError(f"empty operand: U8, W, Q, Tq = {(U8, W, Q, Tq)}")
    if W % 4 or W // 4 > _MAX_SPANS * 256:
        raise ValueError(f"W ({W}) must be a multiple of 4 words (128 docs) "
                         f"and at most {_MAX_SPANS * 1024}")
    return U8, W, Q, Tq


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of int32 bit patterns (SWAR on int64 values)."""
    x = x.long() & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def bits_hits_reference(bits, cidx, cflags, qmode):
    """Plain PyTorch B8: hit counts i32 [Q], a loop over clauses on [Q, W]
    words (in query chunks that bound the temporaries)."""
    U8, W, Q, Tq = _check(bits, cidx, cflags, qmode)
    chunk = max(1, _REFERENCE_CHUNK_WORDS // W)
    out = []
    for q0 in range(0, Q, chunk):
        ci, fl = cidx[q0 : q0 + chunk], cflags[q0 : q0 + chunk]
        mode = qmode[q0 : q0 + chunk, None]
        n = ci.shape[0]
        band = torch.full((n, W), -1, dtype=torch.int32, device=bits.device)
        bor = torch.zeros_like(band)
        bneg = torch.zeros_like(band)
        for t in range(Tq):
            row = bits[ci[:, t].long()]
            f = fl[:, t : t + 1]
            band = torch.where((f & 2) != 0, band & row, band)
            bor = torch.where((f & 4) != 0, bor | row, bor)
            bneg = torch.where((f & 8) != 0, bneg | row, bneg)
        m = (torch.where((mode & MODE_REQ) != 0, band, -1)
             & torch.where((mode & MODE_SHO) != 0, bor, -1) & ~bneg)
        m = torch.where((mode & MODE_DEAD) != 0, 0, m)
        out.append(_popcount(m).sum(dim=1))
    return torch.cat(out).int()


def bits_hits(bits, cidx, cflags, qmode):
    """B8: exact live hit counts i32 [Q]."""
    U8, W, Q, Tq = _check(bits, cidx, cflags, qmode)
    if bits.device.type == "cpu":
        return bits_hits_reference(bits, cidx, cflags, qmode)
    # queries per block: as many as 32 whose clause lists fit the block's
    # shared memory
    qpb = max(1, min(32, (_SHARED_INTS - 64) // (2 * Tq)))
    if 2 * qpb * Tq + 2 * qpb > _SHARED_INTS:
        raise ValueError(f"Tq ({Tq}) too large for one query per block")
    out = torch.empty(Q, dtype=torch.int32, device=bits.device)
    stream = torch.cuda.current_stream(bits.device).cuda_stream
    rc = _build.library().diagon_bits_hits(
        bits.data_ptr(), cidx.data_ptr(), cflags.data_ptr(), qmode.data_ptr(),
        out.data_ptr(), W, Q, Tq, qpb, stream,
    )
    if rc != 0:
        raise RuntimeError(f"diagon_bits_hits launch failed: cudaError {rc}")
    bits_hits.launches += 1
    return out


# kernel launches since process start (or since a caller reset them); the
# CPU path never counts
bits_hits.launches = 0
