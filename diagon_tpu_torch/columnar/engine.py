"""Columnar scan/filter/aggregate on the device with granule skipping:
the port's counterpart of ``diagon_tpu/columnar/engine.py``.

The reference's 3-level granule evaluation (``ColumnarStore.h:1-47``:
SKIP / BULK / decompress+scan):

- **SKIP that saves device memory traffic**: a range predicate first
  evaluates against the per-granule minmax arrays, the surviving granule
  ids compact on the device, and only those granules are scanned (the JAX
  program's pruned and full branches count the same rows). Kernel X1
  (``ops/range_agg.py``, ``csrc/range_agg.cu``) does all of it in one
  launch from a launch plan the table caches per query shape and stream,
  so ``dispatch_range_agg`` never waits for the card and a serving loop can
  chain queries.
- **Exact int64 predicates**: integer columns ride as three 16-bit i32
  planes (offset-encoded, so any int64 column whose value range fits 48
  bits compares exactly); counts are exact, as are min and max.
- **Sums**: int plane sums are exact integers, combined into f32 with the
  JAX program's expression (exact when each plane's table total is below
  2^24); float sums accumulate in f64 and round once to f32. The host
  ``ColumnarTable`` scan stays the exact-int64 oracle, and the metadata
  BULK path (``host_fast_agg``) answers exactly on the host.

Every constructor takes an explicit ``device`` (the CUDA card unless the
caller names another); on a CPU table X1 runs its plain version.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from diagon_tpu_torch.columnar.table import ColumnarTable, MinMaxIndex
from diagon_tpu_torch.ops.range_agg import RangeAggPlan

_PLANE = 16  # bits per integer plane
_PMASK = (1 << _PLANE) - 1


def _int_planes(values: np.ndarray, offset: int) -> np.ndarray:
    """[3, n] i32 planes of (values - offset); exact for 48-bit ranges."""
    u = (values.astype(np.int64) - np.int64(offset)).astype(np.uint64)
    return np.stack(
        [
            (u & _PMASK).astype(np.int32),
            ((u >> _PLANE) & _PMASK).astype(np.int32),
            ((u >> (2 * _PLANE)) & _PMASK).astype(np.int32),
        ]
    )


def _bound_planes(bound: int) -> Tuple[int, int, int]:
    """A bound in [0, 2^48) as its three 16-bit planes."""
    return (bound & _PMASK, (bound >> _PLANE) & _PMASK,
            (bound >> (2 * _PLANE)) & _PMASK)


class DeviceTable:
    """A ColumnarTable resident on ``device``, tiled [G, granule_rows].

    Integer columns are offset-encoded 16-bit i32 planes (exact 48-bit
    range predicates and aggregates); float columns are one f32 plane;
    string columns are dictionary codes on int planes."""

    #: granule-selection slots for the pruned scan; queries surviving in
    #: more granules than this take the full scan inside X1
    PRUNE_CAP_FRACTION = 8

    def __init__(self, table: ColumnarTable, device="cuda"):
        self.table = table
        self.device = torch.device(device)
        self.granule_rows = table.granule_rows
        self.num_rows = table.num_rows
        G = table.num_granules
        self.num_granules = G
        R = self.granule_rows
        self.cap = min(max(1, G), max(8, G // self.PRUNE_CAP_FRACTION))

        def dev(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

        self.planes: Dict[str, Tuple] = {}
        self.is_int: Dict[str, bool] = {}
        self.offsets: Dict[str, int] = {}
        self.minmax: Dict[str, Tuple] = {}
        # dictionary-encoded strings (ClickHouse LowCardinality role): a
        # SORTED host dictionary + per-row int codes on the device, so
        # string equality/range predicates and group-bys ride the exact
        # int path (dict order == byte order -> code range == byte range)
        self.dicts: Dict[str, np.ndarray] = {}
        valid = np.zeros((G, R), dtype=bool)
        valid.reshape(-1)[: self.num_rows] = True
        self.valid = dev(valid)
        # X1's launch plans, by (filter, aggregate, group column,
        # num_groups, stream): the planes' pointers, checked once, and the
        # plan's scratch
        self._plans: Dict[tuple, RangeAggPlan] = {}
        self._index = (self.valid.get_device() if self.device.type == "cuda"
                       else None)

        # host-side state for the metadata BULK fast path (the reference's
        # SKIP/BULK levels answer metadata-decidable queries with no data
        # read, ColumnarStore.h:1-47): per-column granule stats, built
        # lazily by _granule_stats
        self._host_codes: Dict[str, np.ndarray] = {}
        self._gstats: Dict[str, tuple] = {}

        for name, col in table.columns.items():
            if not hasattr(col, "values"):
                raws = np.empty(len(col), dtype=object)
                for i in range(len(col)):
                    raws[i] = col[i]
                uniq, codes = np.unique(raws, return_inverse=True)
                self.dicts[name] = uniq
                self._host_codes[name] = codes.astype(np.int64)
                pl = np.zeros((3, G * R), np.int32)
                pl[:, : self.num_rows] = _int_planes(
                    codes.astype(np.int64), 0
                )
                self.planes[name] = tuple(dev(p.reshape(G, R)) for p in pl)
                self.is_int[name] = True
                self.offsets[name] = 0
                mm_h = MinMaxIndex.build(
                    codes.astype(np.int64), self.granule_rows
                )
                self.minmax[name] = (
                    tuple(dev(p) for p in _int_planes(mm_h.mins, 0)),
                    tuple(dev(p) for p in _int_planes(mm_h.maxs, 0)),
                )
                continue
            vals = col.values
            if np.issubdtype(vals.dtype, np.integer):
                off = int(vals.min()) if len(vals) else 0
                span = (int(vals.max()) - off) if len(vals) else 0
                if span < (1 << 48):
                    pl = np.zeros((3, G * R), np.int32)
                    pl[:, : self.num_rows] = _int_planes(vals, off)
                    self.planes[name] = tuple(
                        dev(p.reshape(G, R)) for p in pl
                    )
                    self.is_int[name] = True
                    self.offsets[name] = off
                    mm = table.minmax.get(name)
                    if mm is not None:
                        self.minmax[name] = (
                            tuple(dev(p) for p in _int_planes(mm.mins, off)),
                            tuple(dev(p) for p in _int_planes(mm.maxs, off)),
                        )
                    continue
            flat = np.zeros(G * R, dtype=np.float32)
            flat[: self.num_rows] = vals.astype(np.float32)
            self.planes[name] = (dev(flat.reshape(G, R)),)
            self.is_int[name] = False
            self.offsets[name] = 0
            mm = table.minmax.get(name)
            if mm is not None:
                self.minmax[name] = (
                    (dev(mm.mins.astype(np.float32)),),
                    (dev(mm.maxs.astype(np.float32)),),
                )

    # -- bounds ----------------------------------------------------------
    def _bounds(self, name, lower, upper):
        """Host bounds for X1: three 16-bit planes, or one f32."""
        if name in self.dicts:
            uniq = self.dicts[name]

            def enc(v):
                return v.encode() if isinstance(v, str) else bytes(v)

            lo = 0
            if lower is not None:
                lo = int(np.searchsorted(uniq, enc(lower), "left"))
            hi = len(uniq) - 1
            if upper is not None:
                hi = int(np.searchsorted(uniq, enc(upper), "right")) - 1
            if hi < lo:
                return _bound_planes(1), _bound_planes(0)  # empty range
            return _bound_planes(lo), _bound_planes(hi)
        if self.is_int[name]:
            off = self.offsets[name]
            span = (1 << 48) - 1
            lo = 0 if lower is None else max(0, int(lower) - off)
            hi = span if upper is None else min(span, int(upper) - off)
            if (upper is not None and int(upper) < off) or lo > span:
                # empty range (below every value / above the 48-bit span):
                # encode as lo > hi via planes (1, 0)
                return _bound_planes(1), _bound_planes(0)
            return _bound_planes(lo), _bound_planes(hi)
        lo = -np.inf if lower is None else lower
        hi = np.inf if upper is None else upper
        return (np.float32(lo),), (np.float32(hi),)

    def _mm(self, name):
        mm = self.minmax.get(name)
        if mm is not None:
            return mm
        pl = self.planes[name]
        if self.is_int[name]:
            # an f32 reduction of the planes is not exact at 48 bits, so
            # reduce exactly on the host once and cache
            vals = self.table.columns[name].values
            mm_h = MinMaxIndex.build(vals, self.granule_rows)
            off = self.offsets[name]

            def dev(x):
                return torch.from_numpy(np.ascontiguousarray(x)).to(
                    self.device)

            mm = (
                tuple(dev(p) for p in _int_planes(mm_h.mins, off)),
                tuple(dev(p) for p in _int_planes(mm_h.maxs, off)),
            )
        else:
            v = pl[0]
            mm = (
                (torch.where(self.valid, v, float("inf")).amin(dim=1),),
                (torch.where(self.valid, v, -float("inf")).amax(dim=1),),
            )
        self.minmax[name] = mm
        return mm

    # -- host metadata fast path (reference SKIP/BULK levels) ------------
    def _host_values(self, name) -> Optional[np.ndarray]:
        """Host value array a granule-level scan can use: raw numeric
        values, or dictionary codes for string columns (code order ==
        byte order, so range predicates translate exactly)."""
        if name in self._host_codes:
            return self._host_codes[name]
        col = self.table.columns.get(name)
        return col.values if col is not None and hasattr(col, "values") \
            else None

    def _granule_stats(self, name):
        """(counts, sums, mins, maxs) per granule over host values —
        int64/f64 exact; cached. sums is None for string columns."""
        st = self._gstats.get(name)
        if st is not None:
            return st
        vals = self._host_values(name)
        if vals is None:
            return None
        R = self.granule_rows
        G = self.num_granules
        starts = np.arange(G, dtype=np.int64) * R
        counts = np.minimum(self.num_rows - starts, R)
        mins = np.minimum.reduceat(vals, starts)
        maxs = np.maximum.reduceat(vals, starts)
        if name in self.dicts:
            sums = None
        elif np.issubdtype(vals.dtype, np.integer):
            sums = np.add.reduceat(vals.astype(np.int64), starts)
        else:
            sums = np.add.reduceat(vals.astype(np.float64), starts)
        st = (counts, sums, mins, maxs)
        self._gstats[name] = st
        return st

    def _host_bounds(self, name, lower, upper):
        """(lo, hi) in host-value space (codes for strings), or None when
        the range is empty by construction."""
        if name in self.dicts:
            uniq = self.dicts[name]

            def enc(v):
                return v.encode() if isinstance(v, str) else bytes(v)

            lo = 0 if lower is None else int(
                np.searchsorted(uniq, enc(lower), "left")
            )
            hi = len(uniq) - 1 if upper is None else int(
                np.searchsorted(uniq, enc(upper), "right")
            ) - 1
            if hi < lo:
                return None
            return lo, hi
        lo = -np.inf if lower is None else lower
        hi = np.inf if upper is None else upper
        return lo, hi

    def host_fast_agg(self, filter_col, lower=None, upper=None,
                      agg_col: Optional[str] = None, max_partial: int = 4):
        """Metadata-level resolution (the reference's SKIP/BULK levels,
        ColumnarStore.h:1-47): classify every granule against the filter
        range via host minmax; fully-inside granules contribute their
        precomputed count/sum/min/max, fully-outside granules nothing,
        and up to ``max_partial`` boundary granules get an exact host
        scan of their <=granule_rows rows. Returns None (caller takes the
        device path) when more granules are partial than that, or when a
        column has no host values.

        Results are EXACT (int64/f64 accumulation): they match the
        host-oracle scan bit for bit, which the device path's f32 results
        only approximate."""
        agg_name = agg_col or filter_col
        fstats = self._granule_stats(filter_col)
        astats = self._granule_stats(agg_name)
        fvals = self._host_values(filter_col)
        avals = self._host_values(agg_name)
        if fstats is None or astats is None:
            return None
        counts, _, fmins, fmaxs = fstats
        _, asums, amins, amaxs = astats
        is_str_agg = agg_name in self.dicts
        bounds = self._host_bounds(filter_col, lower, upper)
        G, R = self.num_granules, self.granule_rows
        if bounds is None:
            full_in = np.zeros(G, bool)
            partial = np.zeros(G, bool)
        else:
            lo, hi = bounds
            full_out = (fmaxs < lo) | (fmins > hi)
            full_in = (fmins >= lo) & (fmaxs <= hi)
            partial = ~full_out & ~full_in
            if int(partial.sum()) > max_partial:
                return None
        cnt = int(counts[full_in].sum())
        s = None if is_str_agg else (
            float(asums[full_in].sum()) if cnt else 0.0
        )
        mn = amins[full_in].min() if full_in.any() else None
        mx = amaxs[full_in].max() if full_in.any() else None
        for g in np.nonzero(partial)[0]:
            a, b = g * R, min((g + 1) * R, self.num_rows)
            fv = fvals[a:b]
            m = (fv >= lo) & (fv <= hi)
            k = int(m.sum())
            if not k:
                continue
            cnt += k
            sel = avals[a:b][m]
            if not is_str_agg:
                s = (s or 0.0) + float(
                    sel.sum(dtype=np.int64)
                    if np.issubdtype(sel.dtype, np.integer)
                    else sel.sum(dtype=np.float64)
                )
            pmn, pmx = sel.min(), sel.max()
            mn = pmn if mn is None else min(mn, pmn)
            mx = pmx if mx is None else max(mx, pmx)
        if is_str_agg:
            uniq = self.dicts[agg_name]
            out_mn = bytes(uniq[int(mn)]) if cnt else None
            out_mx = bytes(uniq[int(mx)]) if cnt else None
            return {
                "count": cnt, "sum": None, "min": out_mn, "max": out_mx,
                "avg": None,
                "granules_scanned": int(partial.sum()),
                "granules_total": G, "host_fast_path": True,
            }
        return {
            "count": cnt,
            "sum": s if cnt else 0.0,
            "min": float(mn) if cnt else None,
            "max": float(mx) if cnt else None,
            "avg": (s / cnt) if cnt else None,
            "granules_scanned": int(partial.sum()),
            "granules_total": G, "host_fast_path": True,
        }

    # -- queries ---------------------------------------------------------
    def _args(self, filter_col, lower, upper, agg_col):
        """X1's arguments for a query (``ops.range_agg.range_agg``'s
        order) and its flags."""
        filt = self.planes[filter_col]
        agg = self.planes[agg_col] if agg_col else filt
        gmin, gmax = self._mm(filter_col)
        blo, bhi = self._bounds(filter_col, lower, upper)
        flags = dict(
            cap=self.cap,
            filt_is_int=self.is_int[filter_col],
            agg_is_int=self.is_int[agg_col or filter_col],
        )
        return (filt, agg, self.valid, gmin, gmax, blo, bhi), flags

    def _plan(self, filter_col, agg_col=None, group_col=None, num_groups=0):
        """(key, X1's launch plan) of a query shape on the current stream,
        made on its first use."""
        stream = (None if self._index is None
                  else torch._C._cuda_getCurrentRawStream(self._index))
        key = (filter_col, agg_col, group_col, num_groups, stream)
        plan = self._plans.get(key)
        if plan is None:
            (filt, agg, valid, gmin, gmax, _, _), flags = self._args(
                filter_col, None, None, agg_col)
            groups, goff = None, 0
            if group_col is not None:
                groups = self.planes[group_col][0]
                # the low plane plus the column's offset is the value
                goff = self.offsets[group_col] if self.is_int[group_col] \
                    else 0
            plan = self._plans[key] = RangeAggPlan(
                filt, agg, valid, gmin, gmax, groups, goff,
                num_groups=num_groups, **flags)
        return key, plan

    def _run(self, key, plan, blo, bhi):
        try:
            return plan(blo, bhi)
        except RuntimeError:
            # a failed launch may leave the plan's scratch dirty
            self._plans.pop(key, None)
            raise

    def dispatch_range_agg(self, filter_col, lower=None, upper=None,
                           agg_col: Optional[str] = None):
        """Enqueue; returns the device vector f32 [6] = [cnt_lo, cnt_hi,
        sum, min, max, granules_scanned], with no host sync (chainable)."""
        blo, bhi = self._bounds(filter_col, lower, upper)
        return self._run(*self._plan(filter_col, agg_col), blo, bhi)

    def _decode(self, fused, agg_col):
        cnt = int(fused[0]) + (int(fused[1]) << _PLANE)
        if agg_col in self.dicts:
            # string aggregate: min/max are dictionary codes -> bytes;
            # sum/avg are meaningless over strings
            uniq = self.dicts[agg_col]
            return {
                "count": cnt,
                "sum": None,
                "min": bytes(uniq[int(fused[3])]) if cnt else None,
                "max": bytes(uniq[int(fused[4])]) if cnt else None,
                "avg": None,
                "granules_scanned": int(fused[5]),
                "granules_total": self.num_granules,
            }
        is_int = bool(self.is_int.get(agg_col, False))
        off = self.offsets.get(agg_col, 0) if is_int else 0

        def val(x):
            return float(x) + off

        return {
            "count": cnt,
            "sum": float(fused[2]) + off * cnt,
            "min": val(fused[3]) if cnt else None,
            "max": val(fused[4]) if cnt else None,
            "avg": (float(fused[2]) / cnt + off) if cnt else None,
            "granules_scanned": int(fused[5]),
            "granules_total": self.num_granules,
        }

    def range_agg(
        self,
        filter_col: str,
        lower=None,
        upper=None,
        agg_col: Optional[str] = None,
        host_fast: bool = True,
    ) -> Dict[str, float]:
        """count/sum/min/max/avg of ``agg_col`` over rows where
        ``filter_col`` in [lower, upper] (one readback).

        ``host_fast=True`` (default) first tries the metadata BULK path
        (host_fast_agg): a query decided by granule minmax (+ a few
        boundary-granule host scans) answers in microseconds with no
        device dispatch, and with exact int64/f64 aggregation."""
        if host_fast:
            out = self.host_fast_agg(filter_col, lower, upper, agg_col)
            if out is not None:
                return out
        fused = self.dispatch_range_agg(
            filter_col, lower, upper, agg_col).cpu().numpy()
        return self._decode(fused, agg_col or filter_col)

    def dispatch_range_group_agg(
        self,
        filter_col: str,
        group_col: str,
        num_groups: Optional[int] = None,
        lower=None,
        upper=None,
        agg_col: Optional[str] = None,
    ):
        """Enqueue; returns (the fused f32 [6], (group counts, group sums)
        f32 [num_groups]) on the device, with no host sync."""
        if num_groups is None:
            if group_col in self.dicts:
                num_groups = len(self.dicts[group_col])
            else:
                raise ValueError("num_groups required for int group columns")
        if group_col in self.dicts and len(self.dicts[group_col]) > _PMASK:
            # group codes ride the LOW plane only; beyond 2^16 distinct
            # values they would wrap (filters/aggregates stay exact at any
            # cardinality; only group-by keys have this limit)
            raise ValueError(
                f"string group-by cardinality {len(self.dicts[group_col])} "
                f"exceeds {_PMASK}"
            )
        blo, bhi = self._bounds(filter_col, lower, upper)
        return self._run(*self._plan(filter_col, agg_col, group_col,
                                     num_groups), blo, bhi)

    def range_group_agg(
        self,
        filter_col: str,
        group_col: str,
        num_groups: Optional[int] = None,
        lower=None,
        upper=None,
        agg_col: Optional[str] = None,
    ):
        """Per-group count/sum for a small-cardinality int or
        dictionary-encoded string group column."""
        fused, (gcnt, gsum) = self.dispatch_range_group_agg(
            filter_col, group_col, num_groups, lower, upper, agg_col)
        fused = fused.cpu().numpy()
        agg_name = agg_col or filter_col
        aoff = self.offsets.get(agg_name, 0) if self.is_int.get(agg_name) \
            else 0
        gcnt = gcnt.cpu().numpy()
        gsum = gsum.cpu().numpy() + aoff * gcnt
        out = {
            "count": int(fused[0]) + (int(fused[1]) << _PLANE),
            "group_counts": gcnt,
            "group_sums": gsum,
            "granules_scanned": int(fused[5]),
        }
        if group_col in self.dicts:
            out["group_labels"] = [bytes(v) for v in self.dicts[group_col]]
        return out
