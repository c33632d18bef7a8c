#!/usr/bin/env python3
"""Time B6 (gather_rescore), B7 (union_rescore), X1 (range_agg) and X2
(block_score) of this checkout against the same wrappers of another
checkout of the port, on the same inputs, in one process on one CUDA card.

    python3 chip_ab.py OTHER_ROOT

OTHER_ROOT is the root of another checkout, say the parent commit unpacked
with ``git archive`` into a directory that .gitignore lists. Its
``diagon_tpu_torch`` is imported first and its kernels built into its own
build directory; its wrapper functions and its ``DeviceTable`` keep their
modules when the package is dropped from ``sys.modules`` and this
checkout's is imported.

B6 and B7: the tensors come from chip_smoke.py's own helpers
(``main_path_args``): the 1M mixed batch's pure-OR subset (B6's) and
boolean subset (B7's), the deduped 1M or20 batch (Q 1, B6) and the 10M
mixed batch's phase-1 pure-OR entry (B6). Each (wrapper, tensors) must give
the same bits in both checkouts, and is timed other, this, this, other,
each time three ways (``chip_smoke.three_ways``: one call, per call of 50,
kernel only).

X1: columnar_bench.py's table at 1M and 10M rows, loaded by each
checkout's own ``DeviceTable``; q9_region_range, narrow_ts_agg and the
bench's group-by through each table's dispatch (the other checkout's
group-by through its ``_args`` and ``range_agg``, as its
``range_group_agg`` calls it, without the readback). Both must give the
same bits, and each is timed other, this, this, other: one call (CUDA
events), kernel only (32 calls queued behind a device sleep) and chained
(32 calls, one sync, host clock), us a call.

X2: the block plans of or20 and chip_smoke.py's mixed boolean on the 1M
segment and of or20 on the 10M one (``chip_smoke.block_plan``), through
each checkout's ``block_score`` (its score form: a [Q, D] final row, or the
tile candidates at k 10) and its ``search.engine.score_and_topk``, on the
same tensors. Both must give the same fused rows, bit for bit; each is
timed other, this, this, other: one call (CUDA events, wrapper), kernel
only (20 calls queued behind a device sleep) and ``score_and_topk``, ms.
Then this checkout's score form at each tile size (``X2_TILES``), kernel
only, in turns. The other checkout's ``score_and_topk`` imports
``exact_topk`` at call time, from this checkout's ``search.row_engine``.

It imports nothing of JAX or of the JAX package.
"""

import inspect
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

import chip_smoke as cs


def load_other(root):
    """The other checkout's gather_rescore and range_agg modules and its
    DeviceTable, its kernels built."""
    root = Path(root).resolve()
    sys.path.insert(0, str(root))
    try:
        from diagon_tpu_torch.columnar.engine import DeviceTable
        from diagon_tpu_torch.ops import _build
        from diagon_tpu_torch.ops import block_score as bs
        from diagon_tpu_torch.ops import gather_rescore as gr
        from diagon_tpu_torch.ops import range_agg as ra
        from diagon_tpu_torch.search import engine

        if Path(gr.__file__).resolve().parents[2] != root:
            raise SystemExit(f"chip_ab: {gr.__file__} is not under {root}")
        _build.library()
    finally:
        sys.path.remove(str(root))
        for name in [m for m in sys.modules
                     if m.split(".")[0] == "diagon_tpu_torch"]:
            del sys.modules[name]
    return SimpleNamespace(gr=gr, ra=ra, bs=bs, engine=engine,
                           DeviceTable=DeviceTable)


def plans_of(searcher, batch):
    return [searcher._query_plans(q)[1][0] for q in batch]


X2_TILES = (512, 1024, 2048)


def x2_cases(other, smi, searcher, label, names):
    """X2 of both checkouts on ``names``' block plans over the searcher's
    segment (see the module doc)."""
    from diagon_tpu_torch.bench.queries import frequent_terms
    from diagon_tpu_torch.ops import block_score as this_bs
    from diagon_tpu_torch.search import engine as this_engine

    ex = this_engine.SegmentExecutor(searcher.device_segments[0], "body",
                                     searcher._ctx("body").tf_lut_host)
    queries = cs.block_queries(frequent_terms(searcher), False)
    # the row form takes no k; the candidate form needs it
    other_kw = ({"k": cs.K} if "k" in inspect.signature(
        other.bs.block_score).parameters else {})
    for name in names:
        plan = cs.block_plan(searcher, queries[name])
        args = cs.x2_args(ex, [plan])
        *pa, run_end = ex._device_plan(plan)
        kw = dict(window_words=ex.field.window_words, k=cs.K,
                  run_end=run_end)
        calls = {
            "other": (lambda: other.bs.block_score(*args, **other_kw),
                      lambda: other.engine.score_and_topk(
                          *ex._index_args(), *pa, **kw)),
            "this": (lambda: this_bs.block_score(*args, k=cs.K),
                     lambda: this_engine.score_and_topk(
                         *ex._index_args(), *pa, **kw)),
        }
        fused = {side: c[1]() for side, c in calls.items()}
        torch.cuda.synchronize()
        if not cs.bits_equal(fused["other"], fused["this"]):
            raise AssertionError(f"X2 {label} {name}: the checkouts' fused "
                                 "rows differ")
        times = {"other": [], "this": []}
        for side in ("other", "this", "this", "other"):
            x2, topk = calls[side]
            times[side].append((
                cs.cuda_ms(x2),
                statistics.median(cs.queued_ms(x2, 20) for _ in range(3)),
                cs.cuda_ms(topk)))
        cs.log(f"block_score {label} {name} ({int((plan.blocks >= 0).sum())} "
               f"blocks, D {ex.segment.num_docs_pad}): fused rows bit-equal; "
               "one call / kernel only / score_and_topk ms, other then this, "
               "in run order [" + smi + "]")
        for side in ("other", "this"):
            cs.log(f"  {side}: " + "; ".join(
                " / ".join(f"{t:.4f}" for t in w) for w in times[side]))
        tiles = {t: [] for t in X2_TILES}
        for order in (X2_TILES, X2_TILES[::-1]):
            for t in order:
                tiles[t].append(statistics.median(cs.queued_ms(
                    lambda: this_bs.block_score(*args, k=cs.K, tile=t), 20)
                    for _ in range(3)))
        cs.log(f"  this, kernel only ms by tile size (tile_for takes "
               f"{cs.x2_tile(args)}): " + "; ".join(
                   f"{t}: " + " / ".join(f"{v:.4f}" for v in tiles[t])
                   for t in X2_TILES))


def cases(other, smi):
    """(label, wrapper name, args) at the main path's B6 and B7 shapes;
    X2's A/B on the same searchers as they load."""
    from diagon_tpu_torch.bench.queries import (
        frequent_terms,
        mixed_query_batch,
        reuters_queries,
    )

    out = []
    _, s1, _, _ = cs.load_searcher(cs.SCALE_DOCS)
    x2_cases(other, smi, s1, "1M", ["or20", "mixed"])
    ex = s1._ctx("body").row_executors[0]
    mixed = mixed_query_batch(frequent_terms(s1), 1024, phrase_share=0)
    args = cs.main_path_args(ex, plans_of(s1, mixed))[0]
    q1 = cs.main_path_args(ex, plans_of(s1, [reuters_queries()["or20"]]))[0]
    out += [("1M mixed pure-OR subset", "gather_rescore",
             args["gather_rescore"]),
            ("1M mixed boolean subset (B7's)", "union_rescore",
             args["union_rescore"]),
            ("1M mixed boolean subset (B7's)", "gather_rescore",
             args["union_rescore"]),
            ("1M or20 deduped, Q 1", "gather_rescore", q1["gather_rescore"])]
    del s1, ex, args, q1
    _, s10, _, _ = cs.load_searcher(cs.SCALE10_DOCS, query_cache=False)
    x2_cases(other, smi, s10, "10M", ["or20"])
    ex = s10._ctx("body").row_executors[0]
    mixed = mixed_query_batch(frequent_terms(s10, "body", 32), 1024,
                              phrase_share=0)
    args = cs.main_path_args(ex, plans_of(s10, mixed))[0]
    out.append(("10M phase-1 entry", "gather_rescore", args["gather_rescore"]))
    return out


def chained(call, n=32, iters=5):
    """us a call of n chained calls and one sync, the least of iters
    chains (columnar_bench.py's columnar_q9_device_us method)."""
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            out = call()
        (out[0] if isinstance(out, tuple) else out)[0].item()
        times.append((time.perf_counter() - t0) / n)
    return min(times) * 1e6


def x1_call(dt, name, kw, ra):
    """One X1 dispatch of a query through a checkout's table, no readback."""
    if "group_col" not in kw:
        return lambda: dt.dispatch_range_agg(**kw)
    if hasattr(dt, "dispatch_range_group_agg"):
        return lambda: dt.dispatch_range_group_agg(**kw)
    args, flags = dt._args(kw["filter_col"], kw["lower"], kw["upper"],
                           kw["agg_col"])
    groups = dt.planes[kw["group_col"]][0]
    goff = dt.offsets[kw["group_col"]]
    return lambda: ra.range_agg(*args, groups, goff,
                                num_groups=kw["num_groups"], **flags)


def x1_cases(other, smi):
    """X1 of both checkouts on columnar_bench.py's table at 1M and 10M."""
    from diagon_tpu_torch.bench.columnar import (
        GROUP_QUERY,
        QUERIES,
        build_table,
    )
    from diagon_tpu_torch.columnar import DeviceTable
    from diagon_tpu_torch.ops import range_agg as this_ra

    queries = [("q9_region_range", QUERIES["q9_region_range"]),
               ("narrow_ts_agg", QUERIES["narrow_ts_agg"]),
               ("group region", GROUP_QUERY)]
    for rows in cs.COLUMNAR_ROWS:
        table = build_table(rows)
        tables = {"other": other.DeviceTable(table, device=cs.DEVICE),
                  "this": DeviceTable(table, device=cs.DEVICE)}
        mods = {"other": other.ra, "this": this_ra}
        for name, kw in queries:
            calls = {side: x1_call(dt, name, kw, mods[side])
                     for side, dt in tables.items()}
            got = {side: call() for side, call in calls.items()}
            torch.cuda.synchronize()
            if not cs.bits_equal(got["other"], got["this"]):
                raise AssertionError(f"X1 {rows} {name}: the checkouts differ")
            times = {"other": [], "this": []}
            for side in ("other", "this", "this", "other"):
                call = calls[side]
                times[side].append((cs.cuda_ms(call) * 1e3,
                                    cs.queued_ms(call, 32) * 1e3,
                                    chained(call)))
            cs.log(f"range_agg {rows // 1_000_000}M {name}: bit-equal; one "
                   "call / kernel only / chained us, other then this, in run "
                   "order [" + smi + "]")
            for side in ("other", "this"):
                cs.log(f"  {side}: " + "; ".join(
                    " / ".join(f"{t:.1f}" for t in w) for w in times[side]))
        del tables, table


def main():
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("chip_ab: torch.cuda.is_available() is false")
    other = load_other(sys.argv[1])
    smi = cs.phase_device()
    from diagon_tpu_torch.ops import gather_rescore as this

    x1_cases(other, smi)
    for label, name, args in cases(other, smi):
        fns = {"other": getattr(other.gr, name), "this": getattr(this, name)}
        got = {side: fn(*args) for side, fn in fns.items()}
        torch.cuda.synchronize()
        if not cs.bits_equal(got["other"], got["this"]):
            raise AssertionError(f"{label} {name}: the checkouts differ")
        times = {"other": [], "this": []}
        for side in ("other", "this", "this", "other"):
            times[side].append(cs.three_ways(lambda: fns[side](*args), 50,
                                             3))
        Q, Tq = args[1].shape
        cs.log(f"{name} {label} (Q {Q}, Tq {Tq}, B {args[2].shape[1]}, "
               f"{'boolean' if args[3] is not None else 'pure OR'}): "
               "bit-equal; one call / per call of 50 / kernel only ms, "
               "other then this, in run order [" + smi + "]")
        for side in ("other", "this"):
            cs.log(f"  {side}: " + "; ".join(
                " / ".join(f"{t:.4f}" for t in w) for w in times[side]))


if __name__ == "__main__":
    main()
