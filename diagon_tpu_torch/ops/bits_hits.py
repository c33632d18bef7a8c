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

The kernel stages, per block, a span of words of every row in shared
memory once and walks the queries over it, a group at a time, with each
query's role clauses compacted into required / should / must_not lists
(csrc/bits_hits.cu). ``bits_plan`` sizes the span, the words a lane holds
and the query group from the shapes and the SM count.
"""

from __future__ import annotations

import functools

import torch

from diagon_tpu_torch.ops import _build, launch_counter
from diagon_tpu_torch.ops.row_sum import _sm_count

_LAUNCHES = launch_counter("bits_hits")

# per-query mode word bits (the JAX module's values)
MODE_REQ = 1  # query has required clauses (all present): AND them
MODE_SHO = 2  # query needs >= 1 should match (min_should >= 1 or no req)
MODE_DEAD = 4  # query can never match (absent required clause): hits 0

# the kernel's plan (bits_plan): blocks of 256 threads, each compacting up
# to GROUP queries' clause lists at a time (8 warps x 8 queries)
GROUP = 64
SMEM_TWO = 115712  # a block's shared memory where two blocks fit an SM
MAX_SMEM = 232448  # a block's dynamic shared memory on sm_90, max
MAX_COLUMNS = 256  # 32-lane columns a span may hold
# a block's fixed cost (list prologue, staging latency) in words of span,
# for comparing spans by the waves of blocks they make
SPAN_OVERHEAD_WORDS = 64
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
    if W % 4:
        raise ValueError(f"W ({W}) must be a multiple of 4 words (128 docs)")
    return U8, W, Q, Tq


def bits_smem(U8: int, Tq: int, span: int, qg: int) -> int:
    """Bytes of shared memory a B8 block uses: ``span`` words of each of
    the U8 rows, and per query of a group a 16-byte header, two counts and
    three lists of 2-byte row offsets, each with room for Tq entries and
    one repeat a 32-clause chunk, rounded up to an even count."""
    cap = (Tq + -(-Tq // 32) + 1) // 2 * 2
    return 4 * U8 * span + qg * (24 + 6 * cap)


@functools.lru_cache(maxsize=256)
def bits_plan(U8: int, W: int, Q: int, Tq: int, sms: int):
    """B8's plan, (V, span, qg, gy): block (x, y) stages words [x * span,
    (x + 1) * span) of all U8 rows (the last span ragged past W) and walks
    the query groups y, y + gy, ... of qg queries over them; a lane holds V
    consecutive words, so a span is a whole number of 32 * V-word columns.

    The rule: the query group takes at most an eighth of the budget (GROUP
    queries where that fits); then, with two blocks an SM where the span
    can hold a column of every row at some V (else one, with the whole 227
    KB), the widest V with a column that fits, and of the spans that fit
    the one that fills the 2 or 1 x ``sms`` slots in the fewest waves
    (waves x (span + SPAN_OVERHEAD_WORDS), ties to the wider span). Where
    the spans are fewer than the slots, gy splits the query groups over the
    rest."""
    for budget, per_sm in ((SMEM_TWO, 2), (MAX_SMEM, 1)):
        qg = min(Q, GROUP, max(1, budget // 8 // bits_smem(0, Tq, 0, 1)))
        room = budget - bits_smem(0, Tq, 0, qg)
        slots = sms * per_sm
        for V in (4, 2, 1):
            cols = min(MAX_COLUMNS, room // (4 * U8 * 32 * V))
            if cols < 1:
                continue
            best = None
            for n in range(1, cols + 1):
                span = 32 * V * n
                waves = -(-(-(-W // span)) // slots)
                cost = waves * (span + SPAN_OVERHEAD_WORDS)
                if best is None or cost <= best[0]:
                    best = (cost, span)
            span = best[1]
            gy = max(1, min(-(-Q // qg), slots // -(-W // span), 65535))
            return V, span, qg, gy
    raise ValueError(f"U8 ({U8}) x Tq ({Tq}) too large for B8's shared memory")


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
    if bits.data_ptr() % 16:
        raise ValueError("bits must be 16-byte aligned")
    dev = bits.get_device()
    plan = bits_plan(U8, W, Q, Tq, _sm_count(dev))
    out = torch.empty(Q, dtype=torch.int32, device=bits.device)
    rc = _build.library().diagon_bits_hits(
        bits.data_ptr(), cidx.data_ptr(), cflags.data_ptr(), qmode.data_ptr(),
        out.data_ptr(), U8, W, Q, Tq, *plan,
        torch._C._cuda_getCurrentRawStream(dev),
    )
    if rc != 0:
        raise RuntimeError(f"diagon_bits_hits launch failed: cudaError {rc}")
    _LAUNCHES.increment()
    return out
