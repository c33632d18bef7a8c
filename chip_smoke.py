#!/usr/bin/env python3
"""Drive diagon_tpu_torch's main path once on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Device: card name and power limit; build the CUDA kernels from
   ``diagon_tpu_torch/csrc`` (one nvcc per source, all at once) and time
   the build.
2. Kernels B1 (row_sum) and B2 (row_boolean) against their plain PyTorch
   versions on the card, bit for bit (D = 19,456; Q in {1, 7, 1024};
   Tq in {4, 20, 24, 64}).
3. Kernels B3-B5 (approx_select, _bool, _bool2), B6 (gather_rescore)
   and B7 (union_rescore) against their plain versions at the main
   path's shapes (D in {19,456, 1,003,520}; Q in {1, 8, 820, 1024}; U8 in
   {32, 168, 512}; Tq in {4, 20}; B = 24): B6 and B7 bit for bit, and B7
   bit-equal to B6; B3-B5 equal hits and tile feasibility, tile maxima
   within 2^-8 relative; and the soundness of the bound: tmax * (1 +
   2^-7) >= the exact tile max of the f32 scores that B1/B2 compute from
   the same compact rows (over matching docs for B4/B5), with B1/B2's
   hit counts equal to the kernels'.
4. Serving at 19,043 docs (main path, counted): solo searches of the
   Reuters families and search_batch sizes 1-7 (B1/B2), or20 x 1024
   (dedups to one plan, exhaustive on B1), mixed 1024 (pruned: B3 and B6
   for the pure-OR subset, B5 and B7 for the boolean one) and a
   1024-query MUST_NOT batch (pruned: B4, B7), through dispatch_batch +
   collect_many. Sampled queries are oracle-exact, and over each whole
   batch the pruned route's finalize equals the exhaustive route's bit
   for bit.
5. Scale at 1,000,000 docs (main path, counted): mixed 1024 (B3, B5, B6,
   B7) and or20 x 1024 (dedups to Q = 1, forced onto the batch route:
   B3 + B6), pruned equal to exhaustive over the whole batch, 4 queries
   oracle-exact, escalation counts printed.
6. On the very tensors the main path hands each kernel: B3-B5 checked
   as in phase 3 (hits, feasibility, soundness against B1/B2), B6/B7 bit
   for bit, and kernel and plain times (CUDA events).
7. Routes on the same plans: served qps of the mixed cells and 1M or20
   through the pruned and the exhaustive route (pruned, exhaustive,
   exhaustive, pruned; the exhaustive route is the same dispatch with
   the pruning floor raised past the segment), then a torch.profiler
   pass over each route: device time by kernel and the card's busy
   share.

Launch counters are set to 0 just before each main-path phase (4, 5) and
read just after it; comparisons with plain versions and with the
exhaustive route, and phases 6-7, do not count. Each kernel must launch on a path where
it has to run.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without CUDA, or outside a checkout,
the script fails before printing either.
"""

import sys

# Neither the port nor this script may use JAX: an import of it fails here.
sys.modules["jax"] = None

import contextlib  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent
SERVE_DOCS = 19043  # the reference's Reuters corpus size
SCALE_DOCS = 1_000_000
KERNEL_D = 19456  # SERVE_DOCS padded to the 1024-doc granule
SCALE_D = 1003520  # SCALE_DOCS padded to the 4096-doc granule
K = 10
B_TILES = 24  # PRUNE_B0: the main path's tile budget at these sizes
REL_TOL = 2.0 ** -8  # kernel vs plain tile maxima (two f32 add orders)
DEVICE = torch.device("cuda")
# the kernels of diagon_tpu_torch/csrc, by function name (profile rows)
PORT_KERNELS = ("row_sum_kernel", "row_boolean_kernel", "approx_select_kernel",
                "compact_lists_kernel", "hits_kernel", "gather_rescore_kernel",
                "union_rescore_kernel")


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps=20, warmup=3):
    """Median device time of ``fn`` in ms from CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bits_equal(a, b):
    """Equal shapes and equal f32 bit patterns (tuples compare pairwise)."""
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(bits_equal(x, y) for x, y in zip(a, b))
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
    )


def max_abs_err(a, b):
    if isinstance(a, (tuple, list)):
        return max(max_abs_err(x, y) for x, y in zip(a, b))
    return float((a - b).abs().max())


def same_topdocs(a, b):
    if a.total_hits != b.total_hits:
        return False
    if [sd.doc for sd in a.score_docs] != [sd.doc for sd in b.score_docs]:
        return False
    sa = np.asarray([sd.score for sd in a.score_docs], np.float32)
    sb = np.asarray([sd.score for sd in b.score_docs], np.float32)
    return np.array_equal(sa.view(np.uint32), sb.view(np.uint32))


class Oracle:
    """The host oracle with its answers memoised per query object."""

    def __init__(self, seg):
        from diagon_tpu.search.oracle import OracleSearcher

        self.searcher = OracleSearcher([seg])
        self.memo = {}

    def check(self, query, got, what):
        want = self.memo.get(id(query))
        if want is None:
            want = self.memo[id(query)] = (query, self.searcher.search(query, K))
        if not same_topdocs(got, want[1]):
            raise AssertionError(
                f"{what}: port differs from the oracle for {query!r}:\n"
                f"  port   {got}\n  oracle {want[1]}"
            )


class Counts:
    """Launch counters of the path's kernels; ``uncounted`` runs a
    comparison or a timing without adding to them."""

    def __init__(self, kernels):
        self.kernels = kernels

    def reset(self):
        for fn in self.kernels.values():
            fn.launches = 0

    def read(self):
        return {name: fn.launches for name, fn in self.kernels.items()}

    def uncounted(self, fn, *args):
        saved = self.read()
        try:
            return fn(*args)
        finally:
            for name, n in saved.items():
                self.kernels[name].launches = n

    def require(self, before, names, what):
        """Each of ``names`` launched since the snapshot ``before``."""
        now = self.read()
        idle = [n for n in names if now[n] <= before[n]]
        if idle:
            raise AssertionError(f"{what} never launched {idle}")


def kernel_inputs(rng, Q, Tq, D=KERNEL_D, H=160, L=33):
    """Seeded bank and clause inputs: ~30% nonzero rows, a quarter of the
    clauses on light rows (row 0 the zero row), random flags."""
    heavy = rng.random((H, D), dtype=np.float32)
    heavy *= rng.random((H, D)) < 0.3
    light = rng.random((L, D), dtype=np.float32)
    light *= rng.random((L, D)) < 0.3
    light[0] = 0.0
    hidx = rng.integers(0, H, (Q, Tq), dtype=np.int32)
    on_light = rng.random((Q, Tq)) < 0.25
    hidx[on_light] = -1
    lidx = np.where(on_light, rng.integers(0, L, (Q, Tq)), 0).astype(np.int32)
    flags = rng.integers(0, 16, (Q, Tq), dtype=np.int32)
    return tuple(torch.from_numpy(a).to(DEVICE)
                 for a in (heavy, light, hidx, lidx, flags))


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    from diagon_tpu_torch.ops import _build

    # the plain versions' products are full f32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name}")
    log(f"nvidia-smi: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.library()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds} s) -> {_build.BUILD_DIR}")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")
    return smi


def phase_row_kernels(rs):
    """B1/B2 against their plain versions over the main path's shapes."""
    rng = np.random.default_rng(20261016)
    err = {"row_sum": 0.0, "row_boolean": 0.0}
    log("phase 2: B1/B2 vs plain versions on the card, D=19456")
    for Q in (1, 7, 1024):
        for Tq in (4, 20, 24, 64):
            heavy, light, hidx, lidx, flags = kernel_inputs(rng, Q, Tq)
            got = rs.row_sum(heavy, light, hidx, lidx)
            want = rs.row_sum_reference(heavy, light, hidx, lidx)
            gotb = rs.row_boolean(heavy, light, hidx, lidx, flags)
            wantb = rs.row_boolean_reference(heavy, light, hidx, lidx, flags)
            torch.cuda.synchronize()
            if not bits_equal(got, want) or not bits_equal(gotb, wantb):
                raise AssertionError(f"kernel != plain at Q={Q} Tq={Tq}")
            err["row_sum"] = max(err["row_sum"], max_abs_err(got, want))
            err["row_boolean"] = max(err["row_boolean"], max_abs_err(gotb, wantb))
        log(f"  Q={Q:5d} Tq in (4, 20, 24, 64): bit-exact")
    return err


# ---------------------------------------------------------------------------
# Phase 3: B3-B7 against their plain versions, and the bound's soundness
# ---------------------------------------------------------------------------

MUST, FILTER, SHOULD, MUST_NOT = range(4)


def compact_inputs(rng, gen, Q, U8, Tq, D, family):
    """A seeded compact batch as the row engine builds one: bank f32
    [U8, D] (row 0 zero, ~10% nonzero BM25-like values) and its bf16
    copy, Tq distinct clause rows per query (a few padding clauses on the
    zero row), clause roles per ``family`` ("or", "bool2" no MUST_NOT,
    "bool" with MUST_NOT; query 0 FILTER-only), flags and the indicator
    matrices of ``RowExecutor._build_compact``."""
    bank = torch.rand((U8, D), generator=gen, device=DEVICE) * 12.0
    bank *= torch.rand((U8, D), generator=gen, device=DEVICE) < 0.1
    bank[0] = 0.0
    live = (torch.rand(D, generator=gen, device=DEVICE) < 0.97).float()
    live[SCALE_DOCS if D == SCALE_D else SERVE_DOCS:] = 0.0  # the doc pad
    cidx = np.stack([rng.choice(np.arange(1, U8), Tq, replace=False)
                     for _ in range(Q)]).astype(np.int32)
    cidx[:, -1][rng.random(Q) < 0.2] = 0
    if family == "or":
        roles = np.full((Q, Tq), SHOULD)
    else:
        roles = rng.integers(0, 4 if family == "bool" else 3, (Q, Tq))
        roles[0] = FILTER
    a = {r: np.zeros((U8, Q), np.float32) for r in ("sc", "rq", "sh", "ng")}
    qgrid = np.broadcast_to(np.arange(Q)[:, None], cidx.shape)
    sc = (roles == MUST) | (roles == SHOULD)
    rq = (roles == MUST) | (roles == FILTER)
    for r, m in (("sc", sc), ("rq", rq), ("sh", roles == SHOULD),
                 ("ng", roles == MUST_NOT)):
        m = m & (cidx > 0)
        np.add.at(a[r], (cidx[m], qgrid[m]), 1.0)
    params = np.zeros((8, Q), np.float32)
    params[0] = rq.sum(axis=1)
    params[1] = np.where(params[0] > 0, 0.0, 1.0)
    flags = (sc.astype(np.int32) + 2 * rq + 4 * (roles == SHOULD)
             + 8 * (roles == MUST_NOT)).astype(np.int32)
    dev = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(DEVICE)  # noqa: E731
    bf = lambda x: dev(x).to(torch.bfloat16)  # noqa: E731
    return {
        "bank": bank, "bank_bf16": bank.to(torch.bfloat16), "live": live,
        "cidx": dev(cidx), "flags": dev(flags), "params": dev(params),
        "a_sc": bf(a["sc"]), "a_rq": bf(a["rq"]), "a_sh": bf(a["sh"]),
        "a_ng": bf(a["ng"]), "a_cb": bf(a["rq"] * 256.0 + a["sh"]),
        "bool_params": dev(params[:2].T.copy()),
    }


def exact_tiles(rs, counts, b, boolean, q_chunk=128):
    """Exact per-(query, tile) maxima of the f32 clause sums (B1/B2 on the
    compact f32 rows, clause order), over matching docs for booleans
    (-inf where none matches), and the exact hit counts."""
    U8, D = b["bank"].shape
    zero = torch.zeros((1, D), device=DEVICE)
    Q = b["cidx"].shape[0]
    tmaxs, hits = [], []
    for q0 in range(0, Q, q_chunk):
        cidx = b["cidx"][q0 : q0 + q_chunk].contiguous()
        lidx = torch.zeros_like(cidx)
        live = b["live"] > 0
        if boolean:
            s, r, o, n = counts.uncounted(
                rs.row_boolean, b["bank"], zero, cidx, lidx,
                b["flags"][q0 : q0 + q_chunk].contiguous())
            p = b["params"][:, q0 : q0 + q_chunk]
            m = ((r == p[0][:, None]) & (o >= p[1][:, None]) & (n == 0)
                 & ((r + o) > 0) & live)
            s = torch.where(m, s, -float("inf"))
        else:
            s = counts.uncounted(rs.row_sum, b["bank"], zero, cidx, lidx)
            m = (s > 0) & live
        tmaxs.append(s.reshape(s.shape[0], -1, 128).amax(dim=-1))
        hits.append(m.sum(dim=1))
    return torch.cat(tmaxs), torch.cat(hits)


def check_select(name, got, want, exact, boolean):
    """Kernel vs plain (hits, feasibility, maxima within REL_TOL), and
    both against the exact scores (hits; tmax * (1 + eps) dominates)."""
    from diagon_tpu_torch.search.row_engine import _APPROX_RELEPS

    (tg, hg), (tw, hw), (te, he) = got, want, exact
    if not torch.equal(hg, hw) or not torch.equal(hg.long(), he):
        raise AssertionError(f"{name}: hits differ (kernel/plain/exact)")
    scale = torch.maximum(tg.abs(), tw.abs())
    if not bool(((tg - tw).abs() <= REL_TOL * scale).all()):
        raise AssertionError(f"{name}: tile maxima beyond 2^-8 relative")
    up = tg * float(np.float32(1.0) + _APPROX_RELEPS)
    if boolean:
        feas = te > -float("inf")
        if not torch.equal(tg != -1.0, feas) or not torch.equal(tw != -1.0, feas):
            raise AssertionError(f"{name}: tile feasibility differs")
        sound = bool((up[feas] >= te[feas]).all())
    else:
        sound = bool((up >= te).all())
    if not sound:
        raise AssertionError(f"{name}: tmax * (1 + eps) below an exact tile max")
    return float((tg - tw).abs().max())


def phase_pruned_kernels(rs, ap, gr, counts):
    from diagon_tpu_torch.search.row_engine import _APPROX_RELEPS, _select_tiles

    log("phase 3: B3-B7 vs plain versions and the bound's soundness")
    rng = np.random.default_rng(7)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(7)
    err = {n: 0.0 for n in ("approx_select", "approx_select_bool",
                            "approx_select_bool2", "gather_rescore",
                            "union_rescore")}
    for D in (KERNEL_D, SCALE_D):
        for Q, U8, Tq in ((1, 32, 4), (8, 168, 20), (820, 168, 20),
                          (1024, 512, 4)):
            line = []
            for name, family, tag in (("approx_select", "or", "B3"),
                                      ("approx_select_bool", "bool", "B4"),
                                      ("approx_select_bool2", "bool2", "B5")):
                b = compact_inputs(rng, gen, Q, U8, Tq, D, family)
                lv, bank, p = b["live"], b["bank_bf16"], b["params"]
                args = {
                    "approx_select": (b["a_sc"], bank, lv),
                    "approx_select_bool": (b["a_sc"], b["a_rq"], b["a_sh"],
                                           b["a_ng"], bank, p, lv),
                    "approx_select_bool2": (b["a_sc"], b["a_cb"], bank, p, lv),
                }[name]
                fn, ref = getattr(ap, name), getattr(ap, name + "_reference")
                got = counts.uncounted(fn, *args)
                want = ref(*args)
                torch.cuda.synchronize()
                boolean = family != "or"
                e = check_select(f"{name} D={D} Q={Q} U8={U8} Tq={Tq}", got,
                                 want, exact_tiles(rs, counts, b, boolean),
                                 boolean)
                err[name] = max(err[name], e)
                ms = cuda_ms(lambda: counts.uncounted(fn, *args), reps=10)
                pms = cuda_ms(lambda: ref(*args), reps=3, warmup=1)
                line.append(f"{tag} {ms:.4f}/{pms:.4f}")
                # B6 and B7 on the tiles this select chose, both forms
                G = D // 128
                tsel = _select_tiles(
                    got[0] * float(np.float32(1.0) + _APPROX_RELEPS),
                    min(B_TILES, G), G)[0]
                ct = b["bank"].reshape(U8, G, 128).permute(1, 0, 2).contiguous()
                fl = b["flags"] if boolean else None
                gargs = (ct, b["cidx"], tsel, fl)
                for rname, rtag in (("gather_rescore", "B6"),
                                    ("union_rescore", "B7")):
                    rfn = getattr(gr, rname)
                    rref = getattr(gr, rname + "_reference")
                    g = counts.uncounted(rfn, *gargs)
                    w = rref(*gargs)
                    torch.cuda.synchronize()
                    if not bits_equal(g, w):
                        raise AssertionError(f"{rname} != plain at D={D} "
                                             f"Q={Q} U8={U8} Tq={Tq} {family}")
                    if rname == "gather_rescore":
                        g6 = g
                    elif not bits_equal(g, g6):
                        raise AssertionError(f"union_rescore != gather_rescore "
                                             f"at D={D} Q={Q} U8={U8} Tq={Tq}")
                    err[rname] = max(err[rname], max_abs_err(g, w))
                    if family != "bool2":
                        ms = cuda_ms(lambda: counts.uncounted(rfn, *gargs),
                                     reps=10)
                        pms = cuda_ms(lambda: rref(*gargs), reps=3, warmup=1)
                        line.append(f"{rtag}/{family} {ms:.4f}/{pms:.4f}")
                del b, args, got, want, ct, g, w, g6
            log(f"  D={D} Q={Q} U8={U8} Tq={Tq}: sound, kernels == plain; "
                f"ms kernel/plain: {'; '.join(line)}")
    return err


# ---------------------------------------------------------------------------
# Phases 4-5: the main path
# ---------------------------------------------------------------------------


def must_not_batch(pool, n=1024, seed=43):
    """``n`` distinct queries of a MUST head, a 2-4 term SHOULD tail and one
    MUST_NOT term, drawn from the frequent-term pool."""
    from diagon_tpu.search.query import BooleanClause, BooleanQuery, Occur, TermQuery

    rng = np.random.Generator(np.random.PCG64(seed))
    out, seen = [], set()
    while len(out) < n:
        w = int(rng.integers(4, 7))
        terms = tuple(pool[i] for i in rng.choice(len(pool), w, replace=False))
        if terms in seen:
            continue
        seen.add(terms)
        clauses = [BooleanClause(TermQuery("body", terms[0]), Occur.MUST)]
        clauses += [BooleanClause(TermQuery("body", t), Occur.SHOULD)
                    for t in terms[1:-1]]
        clauses.append(BooleanClause(TermQuery("body", terms[-1]),
                                     Occur.MUST_NOT))
        out.append(BooleanQuery(clauses, 0))
    return out


def timed_batches(searcher, batch, n):
    """Host seconds per dispatch_batch + collect_many, median of n."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        searcher.collect_many([searcher.dispatch_batch(batch, K)])
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def serve_batch(searcher, oracle, counts, batch, label, sample, need, smi,
                reps):
    """One batch on the main path (dispatch_batch + collect_many): the
    kernels in ``need`` must launch, sampled queries oracle-exact; then
    ``reps`` timed repeats. Returns (plans, pruned-counter delta,
    escalations delta)."""
    ex = searcher._ctx("body").row_executors[0]
    before = counts.read()
    m0 = {n: c.value() for n, c in ex.metrics.items()}
    t0 = time.perf_counter()
    res = searcher.collect_many([searcher.dispatch_batch(batch, K)])[0]
    first = time.perf_counter() - t0
    dm = {n: c.value() - m0[n] for n, c in ex.metrics.items()}
    counts.require(before, need, label)
    if len(res) != len(batch):
        raise AssertionError(f"{label}: {len(res)} results for {len(batch)}")
    for i in sample:
        oracle.check(batch[i], res[i], label)
    s = timed_batches(searcher, batch, reps) if reps else first
    log(f"  {label}: first {first * 1e3:.3f} ms, then {s * 1e3:.3f} ms/batch "
        f"-> {len(batch) / s:.1f} qps [{smi}]; pruned dispatches "
        f"{dm['pruned']}, escalations {dm['escalations']}, compact "
        f"fallbacks {dm['compact_fallbacks']}; {len(sample)} sampled "
        f"oracle-exact")
    plans = [searcher._cached_query_plans(q)[1][0] for q in batch]
    return plans, dm


def pruned_equals_exhaustive(ex, counts, plans, label, pruned):
    """finalize of dispatch() (the pruned route, escalation included) equals
    finalize of the exhaustive route over the whole batch, bit for bit."""
    def run():
        fused = ex.dispatch(plans, K)
        return fused.shape[-1], ex.finalize(plans, fused, K)

    width, got = counts.uncounted(run)
    want = counts.uncounted(
        lambda: ex.finalize(plans, ex._exhaustive_chunked(plans, K), K))
    if pruned and width != 2 * K + 2:
        raise AssertionError(f"{label}: dispatch did not take the pruned route")
    for g, w, what in zip(got, want, ("scores", "docs", "hits")):
        g, w = np.asarray(g), np.asarray(w)
        if g.dtype == np.float32:
            g, w = g.view(np.uint32), w.view(np.uint32)
        if not np.array_equal(g, w):
            raise AssertionError(f"{label}: pruned {what} != exhaustive")
    log(f"  {label}: pruned finalize == exhaustive finalize over all "
        f"{len(plans)} queries")


def load_searcher(n_docs):
    from diagon_tpu.bench.bulk_build import build_synthetic_segment
    from diagon_tpu_torch.search import IndexSearcher

    t0 = time.perf_counter()
    seg = build_synthetic_segment(n_docs)
    log(f"  segment build {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    searcher = IndexSearcher([seg], device=DEVICE)
    bank = searcher._ctx("body").row_executors[0].index.heavy_bank
    torch.cuda.synchronize()
    log(f"  device load + heavy bank {time.perf_counter() - t0:.2f} s "
        f"(bank {tuple(bank.shape)}, {bank.numel() * 4 / 2**20:.1f} MiB)")
    return seg, searcher


def phase_serve(counts, smi):
    from diagon_tpu.bench.queries import (
        frequent_terms,
        mixed_query_batch,
        reuters_queries,
    )
    from diagon_tpu.search.query import PhraseQuery

    log(f"phase 4: serving at {SERVE_DOCS} docs")
    seg, searcher = load_searcher(SERVE_DOCS)
    oracle = Oracle(seg)
    queries = {n: q for n, q in reuters_queries().items()
               if not isinstance(q, PhraseQuery)}
    pool = frequent_terms(searcher)
    mixed = mixed_query_batch(pool, 1024, phrase_share=0)
    neg = must_not_batch(pool)
    or20_batch = [queries["or20"]] * 1024
    sample = list(range(0, 1024, 32))

    counts.reset()
    before = counts.read()
    for name, q in queries.items():
        oracle.check(q, searcher.search(q, K), f"solo {name}")
    pos = 0
    for n in range(1, 8):
        batch = mixed[pos : pos + n]
        pos += n
        for q, r in zip(batch, searcher.search_batch(batch, K)):
            oracle.check(q, r, f"search_batch({n})")
    counts.require(before, ["row_sum", "row_boolean"], "solo + small batches")
    log(f"  solo search ({len(queries)} families) and search_batch sizes "
        f"1..7 ({pos} queries) oracle-exact")
    batches, sent = {}, {}
    for label, batch, need, pruned in (
        ("or20 x 1024", or20_batch, ["row_sum"], False),
        ("mixed 1024", mixed,
         ["approx_select", "approx_select_bool2", "gather_rescore",
          "union_rescore"], True),
        ("MUST_NOT 1024", neg, ["approx_select_bool", "union_rescore"], True),
    ):
        plans, dm = serve_batch(searcher, oracle, counts, batch, label,
                                sample, need, smi, reps=10)
        if pruned and dm["pruned"] < 1:
            raise AssertionError(f"{label}: search.pruned_dispatches did not move")
        batches[label] = plans
        sent[label] = batch
    launches = counts.read()
    ex = searcher._ctx("body").row_executors[0]
    for label in ("mixed 1024", "MUST_NOT 1024"):
        pruned_equals_exhaustive(ex, counts, batches[label], label, True)
    return searcher, batches, sent, launches


def phase_scale(counts, smi):
    from diagon_tpu.bench.queries import (
        frequent_terms,
        mixed_query_batch,
        reuters_queries,
    )

    log(f"phase 5: scale at {SCALE_DOCS} docs")
    seg, searcher = load_searcher(SCALE_DOCS)
    oracle = Oracle(seg)
    mixed = mixed_query_batch(frequent_terms(searcher), 1024, phrase_share=0)
    or20_batch = [reuters_queries()["or20"]] * 1024
    counts.reset()
    batches, sent = {}, {}
    for label, batch, need, sample in (
        ("1M mixed 1024", mixed,
         ["approx_select", "approx_select_bool2", "gather_rescore",
          "union_rescore"],
         [0, 37, 512]),
        ("1M or20 x 1024", or20_batch, ["approx_select", "gather_rescore"],
         [0]),
    ):
        plans, dm = serve_batch(searcher, oracle, counts, batch, label,
                                sample, need, smi, reps=5)
        if dm["pruned"] < 1:
            raise AssertionError(f"{label}: search.pruned_dispatches did not move")
        batches[label] = plans
        sent[label] = batch
    launches = counts.read()
    ex = searcher._ctx("body").row_executors[0]
    for label, plans in batches.items():
        pruned_equals_exhaustive(ex, counts, plans, label, True)
    return searcher, batches, sent, launches


# ---------------------------------------------------------------------------
# Phase 6: the kernels on the main path's own tensors
# ---------------------------------------------------------------------------


def main_path_args(ex, plans):
    """The tensors the pruned route hands each kernel for ``plans``: the
    purity split's subsets, their compact banks, and phase 1's tile
    selection (recomputed uncounted) for the phase-2 kernel the route picks
    (``_use_union``); the compact rows and clause arrays for the soundness
    check; the larger subset wins where two take one kernel."""
    from diagon_tpu_torch.search import row_engine as re

    split = ex._purity_split(plans)
    subsets = (split[0], split[1]) if split else (plans,)
    out, rows = {}, {}
    live = ex.index.live
    for sub in subsets:
        c = ex._compact(sub)
        boolean = not all(p.pure_or for p in sub)
        if not boolean:
            name = "approx_select"
            args = (c.a_sc_t, c.compact_bf16, live)
        elif c.a_cb_t is not None:
            name = "approx_select_bool2"
            args = (c.a_sc_t, c.a_cb_t, c.compact_bf16, c.params_t, live)
        else:
            name = "approx_select_bool"
            args = (c.a_sc_t, c.a_rq_t, c.a_sh_t, c.a_ng_t, c.compact_bf16,
                    c.params_t, live)
        G, U8, _ = c.compact_t.shape
        out[name] = args
        rows[name] = {
            "bank": c.compact_t.permute(1, 0, 2).reshape(U8, G * 128)
                    .contiguous(),
            "cidx": c.cidx, "flags": c.cflags, "params": c.params_t,
            "live": live,
        }
        B = min(ex.tile_budget(len(sub), K), G)
        tsel = re._pruned_batch_phase1(
            c.compact_bf16, c.a_sc_t, c.a_rq_t, c.a_sh_t, c.a_ng_t,
            c.params_t, live, Bk=B, boolean=boolean, a_cb_t=c.a_cb_t)[0]
        gargs = (c.compact_t, c.cidx, tsel, c.cflags if boolean else None)
        rname = ("union_rescore" if re._use_union(*c.cidx.shape, B)
                 else "gather_rescore")
        if rname not in out or len(sub) > out[rname][1].shape[0]:
            out[rname] = gargs
    return out, rows


def time_kernel(counts, name, fn, ref, args, exact):
    got = counts.uncounted(fn, *args)
    want = ref(*args)
    torch.cuda.synchronize()
    if exact and not bits_equal(got, want):
        raise AssertionError(f"{name} != plain on the main path's args")
    ms = cuda_ms(lambda: counts.uncounted(fn, *args))
    plain = cuda_ms(lambda: ref(*args), reps=5, warmup=1)
    rescore = name in ("gather_rescore", "union_rescore")
    shape = tuple(args[1].shape if rescore else args[0].shape)
    log(f"  main-path {name} {shape}: {ms:.4f} ms, plain {plain:.4f} ms")
    return ms, plain, max_abs_err(got, want), got, want


def phase_main_path_kernels(rs, ap, gr, counts, searcher19, batches19,
                            ex1m, batches1m):
    """Each kernel on the args the main path gives it: B1 at the deduped
    or20 plan and B2 at the mixed batch's exhaustive args (the escalation
    shape) at 19k; B4 at the 19k MUST_NOT batch; B3, B5, B6 and B7 at the
    1M mixed batch. B3-B5 are checked as in phase 3 (hits, feasibility,
    maxima within 2^-8, soundness against B1/B2 on the compact rows); B6
    and B7 bit for bit against their plain versions and each other."""
    from diagon_tpu_torch.search.row_engine import _flags

    log("phase 6: kernels vs plain on the main path's tensors")
    ex19 = searcher19._ctx("body").row_executors[0]
    out = {}
    a1 = ex19._args(batches19["or20 x 1024"][:1])
    a2 = ex19._args(batches19["mixed 1024"])
    for name, fn, ref, args in (
        ("row_sum", rs.row_sum, rs.row_sum_reference,
         (a1[0], a1[1], a1[3], a1[4])),
        ("row_boolean", rs.row_boolean, rs.row_boolean_reference,
         (a2[0], a2[1], a2[3], a2[4], _flags(*a2[5:9]))),
    ):
        out[name] = time_kernel(counts, name, fn, ref, args, True)[:3]
    neg_args, neg_rows = main_path_args(ex19, batches19["MUST_NOT 1024"])
    mixed_args, mixed_rows = main_path_args(ex1m, batches1m["1M mixed 1024"])
    for name, args, rows in (
        ("approx_select_bool", neg_args, neg_rows),
        ("approx_select", mixed_args, mixed_rows),
        ("approx_select_bool2", mixed_args, mixed_rows),
    ):
        ms, plain, _, got, want = time_kernel(
            counts, name, getattr(ap, name), getattr(ap, name + "_reference"),
            args[name], False)
        boolean = name != "approx_select"
        e = check_select(f"main-path {name}", got, want,
                         exact_tiles(rs, counts, rows[name], boolean), boolean)
        out[name] = (ms, plain, e)
        log("    sound, hits and feasibility == plain and exact")
    for name in ("gather_rescore", "union_rescore"):
        ms, plain, e, got, _ = time_kernel(
            counts, name, getattr(gr, name), getattr(gr, name + "_reference"),
            mixed_args[name], True)
        oname = "union_rescore" if name == "gather_rescore" else "gather_rescore"
        other = getattr(gr, oname)
        if not bits_equal(got, counts.uncounted(other, *mixed_args[name])):
            raise AssertionError(f"main-path {name}: B6 and B7 differ")
        oms = cuda_ms(lambda: counts.uncounted(other, *mixed_args[name]))
        log(f"    bit-equal to {oname} on the same tensors, which takes "
            f"{oms:.4f} ms")
        out[name] = (ms, plain, e)
    return out


# ---------------------------------------------------------------------------
# Phase 7: the pruned route against the exhaustive one, same plans
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def on_route(ex, route):
    """Route ``ex``'s batches as the JAX package does ("pruned"), or with
    the pruning floor raised past every segment ("exhaustive": the dedup
    still applies)."""
    floor = ex.prune_min_docs
    if route == "exhaustive":
        ex.prune_min_docs = 1 << 62
    try:
        yield
    finally:
        ex.prune_min_docs = floor


def served_both_routes(searcher, batch, label, reps, smi):
    """Served batch (dispatch_batch + collect_many) through each route:
    pruned, exhaustive, exhaustive, pruned; medians."""
    ex = searcher._ctx("body").row_executors[0]
    times = {"pruned": [], "exhaustive": []}
    for route in ("pruned", "exhaustive", "exhaustive", "pruned"):
        with on_route(ex, route):
            times[route].append(timed_batches(searcher, batch, reps))
    med = {r: statistics.median(t) for r, t in times.items()}
    log(f"  {label} served: pruned {med['pruned'] * 1e3:.3f} ms/batch "
        f"({len(batch) / med['pruned']:.1f} qps), exhaustive "
        f"{med['exhaustive'] * 1e3:.3f} ms/batch "
        f"({len(batch) / med['exhaustive']:.1f} qps) [{smi}]")


def profile_route(ex, plans, label, route, smi):
    """torch.profiler over 5 batches of dispatch + finalize on one route:
    wall, device time by kernel, and the busy share."""
    from torch.profiler import ProfilerActivity, profile

    def run():
        with on_route(ex, route):
            return ex.finalize(plans, ex.dispatch(plans, K), K)

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        run()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            run()
        torch.cuda.synchronize()
    # device-side events only: an aten op's row repeats its kernels' time
    # (self_device_time_total is in us)
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in rows) / 5 / 1e3
    log(f"  {label} {route}: wall {wall * 1e3:.3f} ms/batch (dispatch + "
        f"finalize), device {total:.3f} ms/batch, busy "
        f"{100 * total / (wall * 1e3):.1f}% [{smi}]")
    rows.sort(key=lambda e: -e.self_device_time_total)
    # the top rows, then the port's own kernels further down
    for i, e in enumerate(rows):
        if i < 8 or any(f"(anonymous namespace)::{n}" in e.key
                        for n in PORT_KERNELS):
            ms = e.self_device_time_total / 5 / 1e3
            log(f"    {ms:8.3f} ms/batch {100 * ms / total:5.1f}%  "
                f"{e.key[:90]}")


def phase_routes(cells, counts, smi):
    """For each (label, searcher, queries, plans): served qps through both
    routes, then a profile of each route, all uncounted."""
    log("phase 7: pruned vs exhaustive route on the same plans")
    for label, searcher, batch, plans in cells:
        ex = searcher._ctx("body").row_executors[0]
        counts.uncounted(served_both_routes, searcher, batch, label,
                         10 if "1M" not in label else 3, smi)
        for route in ("pruned", "exhaustive"):
            counts.uncounted(profile_route, ex, plans, label, route, smi)


def main():
    t_start = time.perf_counter()
    smi = phase_device()
    from diagon_tpu_torch.ops import approx_pass as ap
    from diagon_tpu_torch.ops import gather_rescore as gr
    from diagon_tpu_torch.ops import row_sum as rs

    kernels = {
        "row_sum": rs.row_sum, "row_boolean": rs.row_boolean,
        "approx_select": ap.approx_select,
        "approx_select_bool": ap.approx_select_bool,
        "approx_select_bool2": ap.approx_select_bool2,
        "gather_rescore": gr.gather_rescore,
        "union_rescore": gr.union_rescore,
    }
    counts = Counts(kernels)
    err = phase_row_kernels(rs)
    err.update(phase_pruned_kernels(rs, ap, gr, counts))
    searcher19, batches19, sent19, launches19 = phase_serve(counts, smi)
    searcher1m, batches1m, sent1m, launches1m = phase_scale(counts, smi)
    ex1m = searcher1m._ctx("body").row_executors[0]
    times = phase_main_path_kernels(rs, ap, gr, counts, searcher19, batches19,
                                    ex1m, batches1m)
    phase_routes([
        ("mixed 1024", searcher19, sent19["mixed 1024"],
         batches19["mixed 1024"]),
        ("1M mixed 1024", searcher1m, sent1m["1M mixed 1024"],
         batches1m["1M mixed 1024"]),
        ("1M or20 x 1024", searcher1m, sent1m["1M or20 x 1024"],
         batches1m["1M or20 x 1024"]),
    ], counts, smi)
    launches = {n: launches19[n] + launches1m[n] for n in kernels}
    log(f"main-path launches at 19k {launches19}; at 1M {launches1m}")

    source = {
        "row_sum": "diagon_tpu_torch/csrc/row_sum.cu",
        "row_boolean": "diagon_tpu_torch/csrc/row_sum.cu",
        "approx_select": "diagon_tpu_torch/csrc/approx_pass.cu",
        "approx_select_bool": "diagon_tpu_torch/csrc/approx_pass.cu",
        "approx_select_bool2": "diagon_tpu_torch/csrc/approx_pass.cu",
        "gather_rescore": "diagon_tpu_torch/csrc/gather_rescore.cu",
        "union_rescore": "diagon_tpu_torch/csrc/gather_rescore.cu",
    }
    replaces = {
        "row_sum": "diagon_tpu/ops/pallas/row_sum.py:129",
        "row_boolean": "diagon_tpu/ops/pallas/row_sum.py:76",
        "approx_select": "diagon_tpu/ops/pallas/approx_pass.py:151",
        "approx_select_bool": "diagon_tpu/ops/pallas/approx_pass.py:301",
        "approx_select_bool2": "diagon_tpu/ops/pallas/approx_pass.py:248",
        "gather_rescore": "diagon_tpu/ops/pallas/gather_rescore.py:364",
        "union_rescore": "diagon_tpu/ops/pallas/gather_rescore.py:279",
    }
    record = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": source[name],
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": max(err[name], times[name][2]),
            "ms": times[name][0],
            "plain_ms": times[name][1],
        }
        for name in kernels
    ]}
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
