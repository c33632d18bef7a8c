"""Phase-2 rescore kernels (B6, B7) and their plain versions.

``gather_rescore`` and ``union_rescore`` are the port's counterparts of
``diagon_tpu/ops/pallas/gather_rescore.py``'s ``pallas_gather_rescore``
and ``pallas_union_rescore``: the same arguments in the same order, the
same results. On CUDA tensors each launches its hand-written kernel of
``csrc/gather_rescore.cu``; on CPU tensors it runs the plain version beside
it, which is also what the kernel is held against on the card. There is no
fallback: a CUDA call launches or raises.

For query q and its b-th selected tile g = tsel[q, b], the scores are the
sum over clauses t of the compact bank's lane row
``compact_t[g, cidx[q, t], :]``, as f32 adds from 0.0 in clause order, so
every version is bit-identical to the JAX kernel and the oracle. With
``flags`` (bit0 scoring, bit1 required, bit2 should, bit3 must_not) only
scoring rows add to the score, and the presence (row > 0) of the other
roles is counted into three more lanes.

The two share that contract. B7 is the JAX union kernel's counterpart
(``diagon_tpu/ops/pallas/gather_rescore.py:192``), which sorts the pairs
by tile so each distinct tile's slab is read once; the row engine routes
to it where the JAX package routes to its union kernel. On this card its
pairs reach the blocks without a sort: block (x, y) of ``union_plan``
owns a range of tiles and a slice of the queries, finds its pairs in
``tsel`` itself and rescores each with one warp, so a call is one launch
with no scratch and no torch op in the wrapper (csrc/gather_rescore.cu
says why this and not a counting sort). What bounds B7 at the main
path's shapes is latency, not the bytes it must move: a block stages its
queries' ``cidx`` and ``flags`` while it loads ``tsel``, and a pair then
waits on its clause rows.

Both kernels rescore a pair with one warp, through one pair body that
keeps clause rows in flight across a warp's pairs; they differ in how a
block finds its pairs. B6's blocks each own a run of the flat (query,
tile) order (``gather_plan``): the run's ``tsel`` slice and its queries'
``cidx`` and ``flags`` rows are staged once in shared memory, and the
run's length is set from the SM count so that the whole batch is one wave
of blocks.
"""

from __future__ import annotations

import functools

import torch

from diagon_tpu_torch.ops import _build, launch_counter
from diagon_tpu_torch.ops.row_sum import _sm_count

_LAUNCHES_B6 = launch_counter("gather_rescore")
_LAUNCHES_B7 = launch_counter("union_rescore")

LANE = 128
# the JAX package's union-kernel limits (its SMEM scalar-prefetch budget and
# a 2048-query pair word), kept so both packages route the same batches
UNION_MAX_PAIRS = 64 << 10
UNION_MAX_Q = 2048
# B7's grid (union_plan): ranges of tiles along x, and slices of the
# queries along y up to about 4 blocks of 8 warps an SM of a 132-SM card
UNION_RANGES = 32
UNION_BLOCKS = 528
UNION_STAGED = 4096  # clause entries a B7 block stages (16 KB, 32 with flags)
MAX_GRID_Y = 65535
# B6's grid (gather_plan): blocks of GATHER_WARPS warps, GATHER_BLOCKS_PER_SM
# of them on an SM at once (the kernel's launch bounds hold it to 128
# registers a thread for that)
GATHER_WARPS = 4
GATHER_BLOCKS_PER_SM = 4
MAX_SMEM = 232448  # a block's dynamic shared memory on sm_90, max


_F32, _I32 = torch.float32, torch.int32


def _check(compact_t, cidx, tsel, flags):
    """(G, U8, Q, Tq, B) of arguments the kernels take, checked in one pass
    (the wrapper's host time is part of every call); ``_diagnose`` raises
    the error that names anything else."""
    dev = compact_t.device
    if (
        compact_t.dtype == _F32 and cidx.dtype == _I32 and tsel.dtype == _I32
        and compact_t.dim() == 3 and cidx.dim() == 2 and tsel.dim() == 2
        and compact_t.is_contiguous() and cidx.is_contiguous()
        and tsel.is_contiguous() and dev.type in ("cpu", "cuda")
        and cidx.device == dev and tsel.device == dev
        and (flags is None
             or (flags.dtype == _I32 and flags.shape == cidx.shape
                 and flags.is_contiguous() and flags.device == dev))
    ):
        G, U8, lanes = compact_t.shape
        Q, Tq = cidx.shape
        B = tsel.shape[1]
        if (lanes == LANE and tsel.shape[0] == Q and G >= 1 and U8 >= 1
                and Q >= 1 and Tq >= 1 and B >= 1):
            return G, U8, Q, Tq, B
    _diagnose(compact_t, cidx, tsel, flags)
    raise ValueError("rescore refused its inputs")  # _diagnose raises first


def _diagnose(compact_t, cidx, tsel, flags):
    """Raise the error that names what the kernels do not take."""
    dev = compact_t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"gather rescore runs on cpu or cuda tensors, not {dev}")
    tensors = {"compact_t": compact_t, "cidx": cidx, "tsel": tsel}
    if flags is not None:
        tensors["flags"] = flags
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, compact_t on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        want = torch.float32 if name == "compact_t" else torch.int32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
    if compact_t.dim() != 3 or compact_t.shape[2] != LANE:
        raise ValueError(f"compact_t must be [G, U8, {LANE}], "
                         f"got {tuple(compact_t.shape)}")
    G, U8, _ = compact_t.shape
    if cidx.dim() != 2 or tsel.dim() != 2 or tsel.shape[0] != cidx.shape[0]:
        raise ValueError(f"cidx {tuple(cidx.shape)} and tsel "
                         f"{tuple(tsel.shape)} must be [Q, Tq] and [Q, B]")
    Q, Tq = cidx.shape
    B = tsel.shape[1]
    if flags is not None and tuple(flags.shape) != (Q, Tq):
        raise ValueError(f"flags shape {tuple(flags.shape)} != {(Q, Tq)}")
    if min(G, U8, Q, Tq, B) < 1:
        raise ValueError(f"empty operand: G, U8, Q, Tq, B = {(G, U8, Q, Tq, B)}")


def gather_rescore_reference(compact_t, cidx, tsel, flags=None):
    """Plain PyTorch B6: scores f32 [Q, B, 128], plus the required /
    should / must_not count lanes with ``flags``."""
    G, U8, Q, Tq, B = _check(compact_t, cidx, tsel, flags)
    rows_of = compact_t.reshape(G * U8, LANE)
    base = tsel.long() * U8  # [Q, B]
    zero = torch.zeros((Q, B, LANE), dtype=torch.float32,
                       device=compact_t.device)
    acc = [zero] * (1 if flags is None else 4)
    for t in range(Tq):
        row = rows_of[base + cidx[:, t : t + 1].long()]  # [Q, B, 128]
        if flags is None:
            acc[0] = acc[0] + row
            continue
        fl = flags[:, t][:, None, None]
        present = torch.where(row > 0, 1.0, 0.0)
        acc[0] = acc[0] + torch.where((fl & 1) != 0, row, 0.0)
        acc[1] = acc[1] + torch.where((fl & 2) != 0, present, 0.0)
        acc[2] = acc[2] + torch.where((fl & 4) != 0, present, 0.0)
        acc[3] = acc[3] + torch.where((fl & 8) != 0, present, 0.0)
    return acc[0] if flags is None else tuple(acc)


def gather_smem(ppb: int, B: int, Tq: int, boolean: bool) -> int:
    """Bytes of shared memory a B6 block of ``ppb`` pairs stages: the cidx
    rows (and flags) of the at most ceil((ppb - 1) / B) + 1 queries its run
    touches, and its ``ppb`` tiles."""
    nq = -(-(ppb - 1) // B) + 1
    return 4 * (nq * Tq * (2 if boolean else 1) + ppb)


@functools.lru_cache(maxsize=256)
def gather_plan(Q: int, B: int, Tq: int, sms: int, boolean: bool) -> int:
    """B6's pairs a block, ppb: block k of the ceil(Q * B / ppb) blocks
    rescores the flat pairs [k * ppb, (k + 1) * ppb) of the [Q, B]
    selection (pair q * B + b), its warps taking them in turn. As few pairs
    a block as put the batch in one wave of GATHER_BLOCKS_PER_SM blocks on
    each of ``sms`` SMs, so no block starts late; halved where a block's
    staged rows would not fit its shared memory."""
    ppb = -(-(Q * B) // (sms * GATHER_BLOCKS_PER_SM))
    while gather_smem(ppb, B, Tq, boolean) > MAX_SMEM:
        if ppb == 1:
            raise ValueError(f"Tq ({Tq}) too large for B6's shared memory")
        ppb //= 2
    return ppb


_gather_fn = None  # the launchers, looked up once
_union_fn = None


def gather_rescore(compact_t, cidx, tsel, flags=None):
    """B6: scores f32 [Q, B, 128]; with ``flags`` a tuple of four lanes
    (score, required, should, must_not count)."""
    G, U8, Q, Tq, B = _check(compact_t, cidx, tsel, flags)
    if compact_t.device.type == "cpu":
        return gather_rescore_reference(compact_t, cidx, tsel, flags)
    if compact_t.data_ptr() % 16:
        raise ValueError("compact_t must be 16-byte aligned")
    global _gather_fn
    if _gather_fn is None:
        _gather_fn = _build.library().diagon_gather_rescore
    dev = compact_t.get_device()
    out = compact_t.new_empty((1 if flags is None else 4, Q, B, LANE))
    rc = _gather_fn(
        compact_t.data_ptr(), cidx.data_ptr(), tsel.data_ptr(),
        None if flags is None else flags.data_ptr(), out.data_ptr(),
        U8, Q, Tq, B, gather_plan(Q, B, Tq, _sm_count(dev), flags is not None),
        torch._C._cuda_getCurrentRawStream(dev),
    )
    if rc != 0:
        raise RuntimeError(f"diagon_gather_rescore launch failed: cudaError {rc}")
    _LAUNCHES_B6.increment()
    return out[0] if flags is None else out.unbind(0)


def union_rescore_supported(Q: int, B: int) -> bool:
    """Whether the JAX package's union kernel serves a [Q, B] selection. Its
    third condition, 8 | Q * B, always holds there (its batches are padded
    to a multiple of 8 above 8 queries) and the port's kernel needs none."""
    return Q * B <= UNION_MAX_PAIRS and Q <= UNION_MAX_Q


@functools.lru_cache(maxsize=256)
def union_plan(Q: int, B: int, G: int, Tq: int):
    """B7's blocks, (tiles a block owns, queries a block owns): block
    (x, y) of the ceil(G / tpb) x ceil(Q / qpb) grid rescores exactly the
    pairs (q, b) with x * tpb <= tsel[q, b] < (x + 1) * tpb and y * qpb <= q
    < (y + 1) * qpb, so every pair falls in one block whatever the order of
    ``tsel``. At most UNION_RANGES ranges of tiles, and as many slices of
    the queries as make about UNION_BLOCKS blocks, or more where a block
    would stage more than UNION_STAGED clause entries; a block scans qpb * B
    entries of ``tsel``."""
    tpb = -(-G // min(G, UNION_RANGES))
    ranges = -(-G // tpb)
    slices = max(1, min(Q, -(-UNION_BLOCKS // ranges)))
    qpb = min(-(-Q // slices), max(1, UNION_STAGED // Tq))
    return tpb, max(qpb, -(-Q // MAX_GRID_Y))


def union_rescore_reference(compact_t, cidx, tsel, flags=None):
    """Plain PyTorch B7: B6's results, computed over the pairs in the order
    of ``union_plan``'s blocks and written back to their own positions."""
    G, U8, Q, Tq, B = _check(compact_t, cidx, tsel, flags)
    tpb, qpb = union_plan(Q, B, G, Tq)
    pairs = torch.arange(Q * B, device=compact_t.device)
    block = ((tsel.reshape(-1).long() // tpb) * (-(-Q // qpb))
             + (pairs // B) // qpb)
    order = torch.argsort(block, stable=True)
    q = order // B
    base = tsel.reshape(-1)[order].long() * U8  # [P] sorted tiles
    rows_of = compact_t.reshape(G * U8, LANE)
    zero = torch.zeros((Q * B, LANE), dtype=torch.float32,
                       device=compact_t.device)
    acc = [zero] * (1 if flags is None else 4)
    for t in range(Tq):
        row = rows_of[base + cidx[q, t].long()]  # [P, 128]
        if flags is None:
            acc[0] = acc[0] + row
            continue
        fl = flags[q, t][:, None]
        present = torch.where(row > 0, 1.0, 0.0)
        acc[0] = acc[0] + torch.where((fl & 1) != 0, row, 0.0)
        acc[1] = acc[1] + torch.where((fl & 2) != 0, present, 0.0)
        acc[2] = acc[2] + torch.where((fl & 4) != 0, present, 0.0)
        acc[3] = acc[3] + torch.where((fl & 8) != 0, present, 0.0)
    outs = []
    for a in acc:
        o = torch.empty_like(a)
        o[order] = a
        outs.append(o.reshape(Q, B, LANE))
    return outs[0] if flags is None else tuple(outs)


def union_rescore(compact_t, cidx, tsel, flags=None):
    """B7: ``gather_rescore``'s results, each block of ``union_plan``
    finding its own pairs in ``tsel`` (one launch, no scratch)."""
    G, U8, Q, Tq, B = _check(compact_t, cidx, tsel, flags)
    if compact_t.device.type == "cpu":
        return union_rescore_reference(compact_t, cidx, tsel, flags)
    if compact_t.data_ptr() % 16:
        raise ValueError("compact_t must be 16-byte aligned")
    global _union_fn
    if _union_fn is None:
        _union_fn = _build.library().diagon_union_rescore
    out = compact_t.new_empty((1 if flags is None else 4, Q, B, LANE))
    rc = _union_fn(
        compact_t.data_ptr(), cidx.data_ptr(), tsel.data_ptr(),
        None if flags is None else flags.data_ptr(), out.data_ptr(),
        G, U8, Q, Tq, B, *union_plan(Q, B, G, Tq),
        torch._C._cuda_getCurrentRawStream(compact_t.get_device()),
    )
    if rc != 0:
        raise RuntimeError(f"diagon_union_rescore launch failed: cudaError {rc}")
    _LAUNCHES_B7.increment()
    return out[0] if flags is None else out.unbind(0)
