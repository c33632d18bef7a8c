"""Columnar range aggregate (X1) and its plain version.

``range_agg`` is the port's counterpart of
``diagon_tpu/columnar/engine.py``'s ``_range_agg_kernel``, a jitted XLA
program (no Pallas body) that the JAX ``DeviceTable`` dispatches for every
range query. On CUDA tensors it launches the hand-written kernels of
``csrc/range_agg.cu`` (the granule skip, the scan, the combine: three
launches, no host sync, so a serving loop can chain queries as the JAX
program does); on CPU tensors it runs ``range_agg_reference``, torch ops
that branch on the host, which is also what the kernel is held against on
the card. There is no fallback: a CUDA call launches or raises.

Arguments (``DeviceTable``'s layout): ``filt`` and ``agg`` are tuples of
planes [G, R], three i32 planes of 16 bits for an integer column
(offset-encoded, exact for 48-bit ranges) or one f32 plane; ``valid`` bool
[G, R]; ``gmin`` / ``gmax`` the filter's per-granule min and max planes
[G]; ``blo`` / ``bhi`` host bounds, i32 [3] planes or f32 [1]. Result: f32
[6] = [cnt_lo, cnt_hi, sum, min, max, granules scanned] and, with
``groups`` (the group column's low plane, plus ``goff``), f32 per-group
counts and sums [num_groups].

Numbers (csrc/range_agg.cu says why): counts, min, max and the integer
plane sums are exact, and the f32 results are formed with the JAX
program's expressions in its order, so they equal its results wherever
its f32 plane sums are exact (each plane's total below 2^24). Float and
group sums accumulate in f64 and round to f32 once, where the JAX program
sums in f32: they agree to f32 rounding. Group ids outside [0,
num_groups) are dropped.
"""

from __future__ import annotations

import numpy as np
import torch

from diagon_tpu_torch.ops import _build

_PLANE = 16
_PMASK = (1 << _PLANE) - 1
_I32, _F32 = torch.int32, torch.float32


def scratch_words(G: int) -> int:
    """i32 words of the kernels' scratch: 12 a granule partial (48 bytes),
    then the selected granules, the skip mask and their count."""
    return 14 * G + 2


def _value48(planes) -> int:
    """A bound's three 16-bit planes as the 48-bit value they encode."""
    p = [int(x) for x in planes]
    return p[0] | (p[1] << _PLANE) | (p[2] << (2 * _PLANE))


def _v48(planes) -> torch.Tensor:
    p0, p1, p2 = (p.long() for p in planes)
    return p0 | (p1 << _PLANE) | (p2 << (2 * _PLANE))


def _f32_planes(m0, m1, m2) -> torch.Tensor:
    """f32(m0) + f32(m1) * 2^16 + f32(m2) * 2^32, in the JAX program's
    order (the products are exact)."""
    return (m0.float() + m1.float() * float(1 << _PLANE)) + \
        m2.float() * float(1 << (2 * _PLANE))


def _granule_mask(gmin, gmax, blo, bhi, filt_is_int: bool):
    if filt_is_int:
        return (_v48(gmax) >= _value48(blo)) & (_v48(gmin) <= _value48(bhi))
    return (gmax[0] >= float(blo[0])) & (gmin[0] <= float(bhi[0]))


def _row_pred(planes, blo, bhi, filt_is_int: bool):
    if filt_is_int:
        v = _v48(planes)
        return (v >= _value48(blo)) & (v <= _value48(bhi))
    return (planes[0] >= float(blo[0])) & (planes[0] <= float(bhi[0]))


def _masked(x, mask, empty) -> torch.Tensor:
    """The masked values of ``x``, flat, with one ``empty`` appended (a
    reduction over no row gives it)."""
    flat = torch.where(mask, x, empty).reshape(-1)
    return torch.cat([flat, flat.new_full((1,), empty)])


def _agg_block(rmask, agg, agg_is_int: bool) -> torch.Tensor:
    """f32 [5] = [cnt_lo, cnt_hi, sum, min, max] over the masked rows."""
    cnt = rmask.sum()
    lanes = [(cnt & _PMASK).float(), ((cnt >> _PLANE) & _PMASK).float()]
    if agg_is_int:
        s = _f32_planes(*(torch.where(rmask, p, 0).sum(dtype=torch.int64)
                          for p in agg))
        v = _v48(agg)
        mn = _masked(v, rmask, torch.iinfo(torch.int64).max).amin()
        mx = _masked(v, rmask, -1).amax()
        some = cnt > 0

        def planes(x, empty):
            return [torch.where(some, (x >> (_PLANE * i)) & _PMASK, empty)
                    for i in range(3)]

        mn = _f32_planes(*planes(mn, _PMASK + 1))
        mx = _f32_planes(*planes(mx, -1))
    else:
        av = agg[0]
        s = torch.where(rmask, av.double(), 0.0).sum().float()
        mn = _masked(av, rmask, float("inf")).amin()
        mx = _masked(av, rmask, -float("inf")).amax()
    return torch.stack(lanes + [s, mn, mx])


def _group_block(rmask, gid, agg, agg_is_int: bool, num_groups: int):
    keep = rmask & (gid >= 0) & (gid < num_groups)
    idx = torch.where(keep, gid, 0).reshape(-1).long()
    cnt = torch.zeros(num_groups, dtype=torch.int64, device=gid.device)
    cnt.index_add_(0, idx, keep.reshape(-1).long())
    # per-row f32 values as the JAX group block forms them
    av = _f32_planes(*agg) if agg_is_int else agg[0]
    av = torch.where(keep, av.double(), 0.0)
    s = torch.zeros(num_groups, dtype=torch.float64, device=gid.device)
    s.index_add_(0, idx, av.reshape(-1))
    return cnt.float(), s.float()


def range_agg_reference(filt, agg, valid, gmin, gmax, blo, bhi, groups=None,
                        goff: int = 0, *, cap: int, filt_is_int: bool,
                        agg_is_int: bool, num_groups: int = 0):
    """Plain PyTorch X1: the JAX program's two branches, chosen on the
    host (the pruned scan of the <= cap granules the skip keeps, in
    ascending order, or the full scan masked by the skip)."""
    G = valid.shape[0]
    gm = _granule_mask(gmin, gmax, blo, bhi, filt_is_int)
    nsel = int(gm.sum())
    if nsel <= cap:
        sel = torch.nonzero(gm)[:, 0]

        def part(p):
            return p[sel]

        v = valid[sel]
    else:
        def part(p):
            return p

        v = valid & gm[:, None]
    ap = tuple(part(p) for p in agg)
    rmask = v & _row_pred(tuple(part(p) for p in filt), blo, bhi, filt_is_int)
    fused = torch.cat([
        _agg_block(rmask, ap, agg_is_int),
        torch.tensor([float(min(nsel, G))], dtype=_F32, device=valid.device),
    ])
    if groups is None:
        return fused
    return fused, _group_block(rmask, part(groups) + goff, ap, agg_is_int,
                               num_groups)


def _check(filt, agg, valid, gmin, gmax, groups, filt_is_int, agg_is_int,
           num_groups, cap):
    """Raise on anything the kernel does not take; returns (G, R)."""
    if valid.dim() != 2 or valid.dtype != torch.bool:
        raise ValueError("valid must be bool [G, R]")
    G, R = valid.shape
    dev = valid.device
    if R % 4 or R < 4 or G < 1 or not 1 <= cap <= G:
        raise ValueError(f"X1 takes R % 4 == 0 and 1 <= cap <= G; got "
                         f"G={G}, R={R}, cap={cap}")

    def planes(name, ps, is_int, shape, n=None):
        want = (n or 3, _I32) if is_int else (1, _F32)
        if len(ps) != want[0]:
            raise ValueError(f"{name}: {want[0]} planes, got {len(ps)}")
        for p in ps:
            if (p.dtype != want[1] or tuple(p.shape) != shape
                    or not p.is_contiguous() or p.device != dev
                    or p.data_ptr() % 16):
                raise ValueError(f"{name}: contiguous 16-byte aligned "
                                 f"{want[1]} {shape} planes on {dev}")

    planes("filt", filt, filt_is_int, (G, R))
    planes("agg", agg, agg_is_int, (G, R))
    planes("gmin", gmin, filt_is_int, (G,))
    planes("gmax", gmax, filt_is_int, (G,))
    if not valid.is_contiguous():
        raise ValueError("valid must be contiguous")
    if groups is not None:
        planes("groups", (groups,), True, (G, R), n=1)
        if num_groups < 1:
            raise ValueError("num_groups must be >= 1 with groups")
    return G, R


def range_agg(filt, agg, valid, gmin, gmax, blo, bhi, groups=None,
              goff: int = 0, *, cap: int, filt_is_int: bool, agg_is_int: bool,
              num_groups: int = 0):
    """X1: the fused vector f32 [6] (and, with ``groups``, the per-group
    f32 counts and sums), enqueued on the current stream; nothing waits."""
    if valid.device.type == "cpu":
        return range_agg_reference(
            filt, agg, valid, gmin, gmax, blo, bhi, groups, goff, cap=cap,
            filt_is_int=filt_is_int, agg_is_int=agg_is_int,
            num_groups=num_groups)
    G, R = _check(filt, agg, valid, gmin, gmax, groups, filt_is_int,
                  agg_is_int, num_groups, cap)
    dev = valid.device
    if filt_is_int:
        lo, hi, flo, fhi = _value48(blo), _value48(bhi), 0.0, 0.0
    else:
        lo, hi = 0, 0
        flo, fhi = float(np.float32(blo[0])), float(np.float32(bhi[0]))
    out = torch.empty(6, dtype=_F32, device=dev)
    scratch = torch.empty(scratch_words(G), dtype=_I32, device=dev)
    ng = num_groups if groups is not None else 0
    gcnt = torch.empty(ng, dtype=_I32, device=dev)
    gsum = torch.empty(ng, dtype=torch.float64, device=dev)
    gcnt_out = torch.empty(ng, dtype=_F32, device=dev)
    gsum_out = torch.empty(ng, dtype=_F32, device=dev)

    def ptrs(ps):
        return [p.data_ptr() for p in ps] * (3 // len(ps))

    def ptr(t):
        return t.data_ptr() if t is not None and t.numel() else None

    rc = _build.library().diagon_range_agg(
        *ptrs(filt), *ptrs(agg), valid.data_ptr(), *ptrs(gmin), *ptrs(gmax),
        lo, hi, flo, fhi, ptr(groups), goff, ng, scratch.data_ptr(),
        ptr(gcnt), ptr(gsum), out.data_ptr(), ptr(gcnt_out), ptr(gsum_out),
        G, R, cap, int(filt_is_int), int(agg_is_int),
        torch._C._cuda_getCurrentRawStream(valid.get_device()),
    )
    if rc != 0:
        raise RuntimeError(f"diagon_range_agg launch failed: cudaError {rc}")
    range_agg.launches += 1
    if groups is None:
        return out
    return out, (gcnt_out, gsum_out)


# calls that launched the kernels since process start (or since a caller
# reset the count); the CPU path never counts
range_agg.launches = 0
