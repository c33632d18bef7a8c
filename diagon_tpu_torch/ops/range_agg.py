"""Columnar range aggregate (X1) and its plain version.

``range_agg`` is the port's counterpart of
``diagon_tpu/columnar/engine.py``'s ``_range_agg_kernel``, a jitted XLA
program (no Pallas body) that the JAX ``DeviceTable`` dispatches for every
range query. On CUDA tensors it launches the hand-written kernel of
``csrc/range_agg.cu``: one launch (granule skip, scan and combine, with no
memset), no host sync, so a serving loop can chain queries as the JAX
program does. On CPU tensors it runs ``range_agg_reference``, torch ops
that branch on the host, which is also what the kernel is held against on
the card. There is no fallback: a CUDA call launches or raises.

A launch takes a ``RangeAggPlan``: the checked plane pointers, the flags,
the persistent grid and the plan's zeroed scratch (partials, ticket, group
accumulators; the kernel leaves them zeroed), in one packed argument block
(``X1Args``). A call then costs the bounds, one ``torch.empty`` for all
outputs and one ctypes call. ``DeviceTable`` caches its plans, one per
(query shape, stream): it owns the planes, so a plan's pointers live as
long as they do (a cache keyed by pointers in this module could outlive its
tensors and meet a new tensor at a recycled address), and a stream's
launches are ordered, so two streams never share a ticket. ``range_agg``
called bare makes a plan for the one call.

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
sums in f32: they agree to f32 rounding. Group ids follow the JAX
program's scatter into num_groups + 1 slots, mode "drop": an id in
[-(num_groups + 1), -2] wraps to id + num_groups + 1, and every other id
outside [0, num_groups) is dropped (``group_slots``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from diagon_tpu_torch.ops import _build, launch_counter

_LAUNCHES = launch_counter("range_agg")

_PLANE = 16
_PMASK = (1 << _PLANE) - 1
_I32, _F32 = torch.int32, torch.float32

_PTRS = ("f0", "f1", "f2", "a0", "a1", "a2", "valid", "gmin0", "gmin1",
         "gmin2", "gmax0", "gmax1", "gmax2", "groups", "parts", "ticket",
         "gcnt", "gsum", "out")


class X1Args(ctypes.Structure):
    """``struct X1Args`` of csrc/range_agg.cu: the launch's argument block.
    Only 8-byte fields, so neither side pads it; ``ARGS_BYTES`` is the size
    both assert."""

    _fields_ = ([(n, ctypes.c_void_p) for n in _PTRS]
                + [("lo", ctypes.c_int64), ("hi", ctypes.c_int64),
                   ("flo", ctypes.c_double), ("fhi", ctypes.c_double)]
                + [(n, ctypes.c_int64) for n in (
                    "goff", "num_groups", "G", "R", "grid", "filt_int",
                    "agg_int")])


ARGS_BYTES = 240  # static_assert(sizeof(X1Args) == 240) in the .cu
if ctypes.sizeof(X1Args) != ARGS_BYTES:
    raise ImportError(f"X1Args is {ctypes.sizeof(X1Args)} bytes, the kernel "
                      f"takes {ARGS_BYTES}")

_PART_WORDS = 6  # int64 words of a block's partial
_grids = {}  # (device index, flags, num_groups) -> the grid


def scratch_words(grid: int, num_groups: int) -> int:
    """int64 words of a plan's scratch: the grid's partials, the ticket,
    then the f64 group sums and the i32 group counts."""
    return _PART_WORDS * grid + 1 + num_groups + (num_groups + 1) // 2


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


def group_slots(gid, num_groups: int):
    """The JAX group block's index rule (a scatter into ``num_groups + 1``
    slots, mode "drop", the last slot cut off): an id in [-(N+1), -2]
    wraps to ``id + N + 1``; every other id outside [0, N) is dropped
    (-1 when so, as -1 and N land in the cut-off slot)."""
    N = num_groups
    gid = torch.where((gid >= -(N + 1)) & (gid <= -2), gid + (N + 1), gid)
    return torch.where((gid >= 0) & (gid < N), gid, -1)


def _group_block(rmask, gid, agg, agg_is_int: bool, num_groups: int):
    gid = group_slots(gid, num_groups)
    keep = rmask & (gid >= 0)
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
    if not valid.is_contiguous() or valid.data_ptr() % 4:
        raise ValueError("valid must be contiguous and 4-byte aligned")
    if groups is not None:
        planes("groups", (groups,), True, (G, R), n=1)
        if num_groups < 1:
            raise ValueError("num_groups must be >= 1 with groups")
    return G, R


def _grid(index: int, filt_is_int: bool, agg_is_int: bool,
          num_groups: int) -> int:
    """X1's persistent grid on device ``index``: SMs x the blocks an SM
    holds (the occupancy API); once per device and flags."""
    key = (index, filt_is_int, agg_is_int, num_groups)
    grid = _grids.get(key)
    if grid is None:
        out = ctypes.c_int(0)
        with torch.cuda.device(index):
            rc = _build.library().diagon_range_agg_grid(
                int(filt_is_int), int(agg_is_int), num_groups,
                ctypes.byref(out))
        if rc != 0:
            raise RuntimeError(f"diagon_range_agg_grid failed: cudaError {rc}")
        grid = _grids[key] = out.value
    return grid


class RangeAggPlan:
    """X1's launch plan for one query shape on one stream: the planes'
    pointers (checked once, here), the flags, the grid and the zeroed
    scratch, packed into ``args``. Calling it with a query's bounds runs X1
    on them; a call writes the bounds and the output into its own copy of
    ``args``, so host threads may share a plan (their launches on its one
    stream are ordered, so they share its scratch too). On CPU tensors it
    makes the same checks, holds the same pointers, allocates nothing and
    runs ``range_agg_reference``."""

    def __init__(self, filt, agg, valid, gmin, gmax, groups=None,
                 goff: int = 0, *, cap: int, filt_is_int: bool,
                 agg_is_int: bool, num_groups: int = 0):
        # the plan holds the tensors its pointers point into
        self.tensors = (filt, agg, valid, gmin, gmax, groups)
        self.goff = goff
        self.flags = dict(cap=cap, filt_is_int=filt_is_int,
                          agg_is_int=agg_is_int, num_groups=num_groups)
        self.num_groups = num_groups if groups is not None else 0
        self.device = valid.device
        self.grid = 0
        self.scratch = None
        a = self.args = X1Args()

        def ptrs(ps):
            return [p.data_ptr() for p in ps] * (3 // len(ps))

        a.f0, a.f1, a.f2 = ptrs(filt)
        a.a0, a.a1, a.a2 = ptrs(agg)
        a.valid = valid.data_ptr()
        a.gmin0, a.gmin1, a.gmin2 = ptrs(gmin)
        a.gmax0, a.gmax1, a.gmax2 = ptrs(gmax)
        a.groups = groups.data_ptr() if groups is not None else None
        a.goff, a.num_groups = goff, self.num_groups
        a.G, a.R = valid.shape
        a.filt_int, a.agg_int = int(filt_is_int), int(agg_is_int)
        # the same checks on either device, so the plain version takes
        # nothing the kernel refuses
        _check(filt, agg, valid, gmin, gmax, groups, filt_is_int, agg_is_int,
               num_groups, cap)
        if not -(1 << 31) <= goff < (1 << 31):
            raise ValueError(f"goff {goff} is not an int32 (the group ids are)")
        if self.device.type == "cpu":
            return
        index = valid.get_device()
        self.grid = a.grid = _grid(index, filt_is_int, agg_is_int,
                                   self.num_groups)
        self.scratch = torch.zeros(scratch_words(self.grid, self.num_groups),
                                   dtype=torch.int64, device=self.device)
        base = self.scratch.data_ptr()
        a.parts = base
        a.ticket = base + 8 * _PART_WORDS * self.grid
        if self.num_groups:
            a.gsum = a.ticket + 8
            a.gcnt = a.gsum + 8 * self.num_groups
        self.stream = torch._C._cuda_getCurrentRawStream(index)
        self._launch = _build.library().diagon_range_agg

    def __call__(self, blo, bhi):
        """X1 over the rows within [blo, bhi], enqueued on the plan's
        stream; nothing waits. A launch that fails raises; the plan's
        scratch may then be dirty, so its owner drops it."""
        if self.scratch is None:
            filt, agg, valid, gmin, gmax, groups = self.tensors
            return range_agg_reference(filt, agg, valid, gmin, gmax, blo, bhi,
                                       groups, self.goff, **self.flags)
        a = X1Args.from_buffer_copy(self.args)  # this call's own block
        if a.filt_int:
            a.lo, a.hi = _value48(blo), _value48(bhi)
        else:
            a.flo, a.fhi = float(np.float32(blo[0])), float(np.float32(bhi[0]))
        ng = self.num_groups
        out = torch.empty(6 + 2 * ng, dtype=_F32, device=self.device)
        a.out = out.data_ptr()
        rc = self._launch(ctypes.byref(a), self.stream)
        if rc != 0:
            raise RuntimeError(f"diagon_range_agg launch failed: cudaError {rc}")
        _LAUNCHES.increment()
        if not ng:
            return out
        return out[:6], (out[6:6 + ng], out[6 + ng:])


def range_agg(filt, agg, valid, gmin, gmax, blo, bhi, groups=None,
              goff: int = 0, *, cap: int, filt_is_int: bool, agg_is_int: bool,
              num_groups: int = 0):
    """X1: the fused vector f32 [6] (and, with ``groups``, the per-group
    f32 counts and sums), enqueued on the current stream; nothing waits.
    Makes a plan for this one call (``DeviceTable`` keeps its own)."""
    return RangeAggPlan(filt, agg, valid, gmin, gmax, groups, goff, cap=cap,
                        filt_is_int=filt_is_int, agg_is_int=agg_is_int,
                        num_groups=num_groups)(blo, bhi)
