"""Exhaustive row-sum kernels (B1, B2) and their plain PyTorch versions.

``row_sum`` and ``row_boolean`` are the port's counterparts of
``diagon_tpu/ops/pallas/row_sum.py``'s ``pallas_row_sum`` and
``pallas_row_boolean``. On CUDA tensors they launch the hand-written
kernels of ``csrc/row_sum.cu``; on CPU tensors they run the plain
versions beside them, which are also what the kernels are held against
on the card. There is no fallback: a CUDA call launches or raises.

Each clause row is ``heavy[hidx[q, t]]`` when ``hidx >= 0`` and
``light[lidx[q, t]]`` otherwise (light row 0 is the zero row). Rows
accumulate as sequential f32 adds in clause order, so every version is
bit-identical to the JAX scan, the Pallas kernel and the oracle.
"""

from __future__ import annotations

import functools

import torch

from diagon_tpu_torch.ops import _build, launch_counter

_LAUNCHES_B1 = launch_counter("row_sum")
_LAUNCHES_B2 = launch_counter("row_boolean")

TILE = 1024  # D must be a multiple of this (float4 rows, 16-byte aligned)
MAX_GRID_Y = 65535
_BLOCKS = (256, 128, 64, 32)  # the kernels' block sizes, largest first
_F32, _I32 = torch.float32, torch.int32


@functools.lru_cache(maxsize=256)
def launch_geometry(Q: int, D: int, sms: int):
    """B1's and B2's (threads per block, blocks along docs, query slots):
    the largest block that still puts two blocks on every SM, else the
    smallest. A thread owns one float4 column (D / 4 of them). The kernels
    number the blocks of this grid query-fastest (csrc/row_sum.cu
    block_slot) and stride over queries past MAX_GRID_Y."""
    cols, gy = D // 4, min(Q, MAX_GRID_Y)
    for threads in _BLOCKS:
        if (cols // threads) * gy >= 2 * sms:
            break
    return threads, cols // threads, gy


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(heavy, light, hidx, lidx, flags=None):
    """Raise on anything the kernels do not take; returns (Q, Tq, D). One
    pass over the cheap attributes; only a refused call pays for
    ``_diagnose``, which names the fault."""
    shape = hidx.shape
    dev = heavy.device
    if (
        heavy.dtype == _F32 and light.dtype == _F32
        and hidx.dtype == _I32 and lidx.dtype == _I32
        and heavy.dim() == 2 and light.dim() == 2 and len(shape) == 2
        and lidx.shape == shape
        and heavy.is_contiguous() and light.is_contiguous()
        and hidx.is_contiguous() and lidx.is_contiguous()
        and dev.type in ("cpu", "cuda") and light.device == dev
        and hidx.device == dev and lidx.device == dev
        and (flags is None or (flags.dtype == _I32 and flags.shape == shape
                               and flags.is_contiguous()
                               and flags.device == dev))
    ):
        D = heavy.shape[1]
        Q, Tq = shape
        if (light.shape[1] == D and D > 0 and D % TILE == 0
                and heavy.shape[0] >= 1 and light.shape[0] >= 1
                and Q >= 1 and Tq >= 1):
            return Q, Tq, D
    _diagnose(heavy, light, hidx, lidx, flags)
    raise ValueError("row sums refused their inputs")  # _diagnose raises first


def _diagnose(heavy, light, hidx, lidx, flags):
    """Raise the error that names what the kernels do not take."""
    tensors = {"heavy": heavy, "light": light, "hidx": hidx, "lidx": lidx}
    if flags is not None:
        tensors["flags"] = flags
    dev = heavy.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"row sums run on cpu or cuda tensors, not {dev}")
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, heavy on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        want = torch.float32 if name in ("heavy", "light") else torch.int32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
    D = heavy.shape[1]
    if light.shape[1] != D:
        raise ValueError(f"light has {light.shape[1]} docs, heavy {D}")
    if D == 0 or D % TILE:
        raise ValueError(f"D ({D}) must be a positive multiple of {TILE}")
    if heavy.shape[0] < 1 or light.shape[0] < 1:
        raise ValueError("heavy and light banks need at least one row")
    Q, Tq = hidx.shape
    for name, t in tensors.items():
        if name not in ("heavy", "light") and tuple(t.shape) != (Q, Tq):
            raise ValueError(f"{name} shape {tuple(t.shape)} != {(Q, Tq)}")
    if Q < 1 or Tq < 1:
        raise ValueError(f"need at least one query and one clause, got {(Q, Tq)}")


def _clause_rows(heavy, light, hidx_t, lidx_t):
    """[Q, D] rows of clause column t (plain version's row select)."""
    return torch.where(
        (hidx_t >= 0)[:, None],
        heavy[hidx_t.clamp(min=0).long()],
        light[lidx_t.long()],
    )


def row_sum_reference(heavy, light, hidx, lidx):
    """Plain PyTorch B1: scores f32 [Q, D], sequential adds over t."""
    _check(heavy, light, hidx, lidx)
    scores = _clause_rows(heavy, light, hidx[:, 0], lidx[:, 0])
    for t in range(1, hidx.shape[1]):
        scores = scores + _clause_rows(heavy, light, hidx[:, t], lidx[:, t])
    return scores


def row_boolean_reference(heavy, light, hidx, lidx, flags):
    """Plain PyTorch B2: (scores, req_cnt, sho_cnt, neg_cnt), each f32
    [Q, D]. flags bit0 scoring, bit1 required, bit2 should, bit3 must_not."""
    _check(heavy, light, hidx, lidx, flags)
    acc = None
    for t in range(hidx.shape[1]):
        row = _clause_rows(heavy, light, hidx[:, t], lidx[:, t])
        present = torch.where(row > 0, 1.0, 0.0)
        fl = flags[:, t][:, None]
        parts = (
            torch.where((fl & 1) != 0, row, 0.0),
            torch.where((fl & 2) != 0, present, 0.0),
            torch.where((fl & 4) != 0, present, 0.0),
            torch.where((fl & 8) != 0, present, 0.0),
        )
        acc = parts if acc is None else tuple(a + p for a, p in zip(acc, parts))
    return acc


_row_sum_fn = None  # the launchers, looked up once
_row_boolean_fn = None


def row_sum(heavy, light, hidx, lidx):
    """B1: scores f32 [Q, D] = sum over clauses of the selected rows."""
    global _row_sum_fn
    Q, Tq, D = _check(heavy, light, hidx, lidx)
    if not heavy.is_cuda:
        return row_sum_reference(heavy, light, hidx, lidx)
    if _row_sum_fn is None:
        _row_sum_fn = _build.library().diagon_row_sum
    index = heavy.get_device()
    threads = launch_geometry(Q, D, _sm_count(index))[0]
    out = heavy.new_empty((Q, D))
    rc = _row_sum_fn(
        heavy.data_ptr(), light.data_ptr(), hidx.data_ptr(), lidx.data_ptr(),
        out.data_ptr(), Q, Tq, D, threads,
        torch._C._cuda_getCurrentRawStream(index),
    )
    if rc != 0:
        raise RuntimeError(f"diagon_row_sum launch failed: cudaError {rc}")
    _LAUNCHES_B1.increment()
    return out


def row_boolean(heavy, light, hidx, lidx, flags):
    """B2: (scores, req_cnt, sho_cnt, neg_cnt), each f32 [Q, D]."""
    global _row_boolean_fn
    Q, Tq, D = _check(heavy, light, hidx, lidx, flags)
    if not heavy.is_cuda:
        return row_boolean_reference(heavy, light, hidx, lidx, flags)
    if _row_boolean_fn is None:
        _row_boolean_fn = _build.library().diagon_row_boolean
    index = heavy.get_device()
    threads = launch_geometry(Q, D, _sm_count(index))[0]
    out = heavy.new_empty((4, Q, D))
    rc = _row_boolean_fn(
        heavy.data_ptr(), light.data_ptr(), hidx.data_ptr(), lidx.data_ptr(),
        flags.data_ptr(), out.data_ptr(), Q, Tq, D, threads,
        torch._C._cuda_getCurrentRawStream(index),
    )
    if rc != 0:
        raise RuntimeError(f"diagon_row_boolean launch failed: cudaError {rc}")
    _LAUNCHES_B2.increment()
    return out.unbind(0)
