"""Segment-sharded search on ``torch.distributed``: one process per shard.

Counterpart of ``diagon_tpu/parallel/sharded.py``. There one controller
runs a ``shard_map`` program over a 1-D device mesh, a segment shard per
device. Here each rank of a process group holds one shard on its device
and runs the same step:

- its fused ``[Q, 2k+1]`` rows from the row engine: the exhaustive program
  (``row_score_topk_pallas``, kernel B2), or, for batches of
  ``approx_min_q`` queries and more, the pruned batch route
  (``row_score_topk_pruned_batch``: B3, B4 or B5, then B6 or B7, then the
  certificates), after which the rank rescores its failed queries on B2;
- one all-gather of its (score, global docid) pairs, hit counts and
  escalations, the counts then summed over the shards (the JAX program's
  all-gather and psum);
- the exact (score desc, docid asc) merge, ``merge_topk``.

Every rank returns the same ``TopDocs``, as the mesh program's replicated
outputs. Every rank must call ``search_batch`` with the same queries in the
same order: each planned batch and each search is a collective.

Deliberate deviations from the JAX program, none of which changes a
result:

- Ranks in place of one controller. Every rank holds every shard's
  ``SegmentData`` on the host (the collection statistics, the global heavy
  set and the oracle rows need them) and plans its own shard only.
- The route reduction. The JAX program plans over all shards at once: the
  clause bucket Tq, the light-bank rows, the compact bank's rows and with
  them whether the batch prunes, and the ``pure_or`` / ``fused2`` kernel
  choice. Here each planned batch reduces those quantities with one
  all-reduce (MAX), so every rank takes the JAX program's route, and no
  rank waits in a collective that another skips.
- The exhaustive program is kernel B2 where the JAX program runs the jnp
  ``row_score_topk`` (XLA); escalation rescores only the failed queries
  (the JAX program's ``lax.cond`` rescores the shard's whole batch and
  keeps the failed rows). Each query's rows are the same either way.
- Collectives run on CUDA tensors under NCCL and on host copies under
  gloo, by the group's backend.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from diagon_tpu_torch.observability.metrics import registry
from diagon_tpu_torch.search.bm25 import BM25Similarity
from diagon_tpu_torch.search.device_index import load_segment
from diagon_tpu_torch.search.engine import make_tf_table
from diagon_tpu_torch.search.oracle import (
    OracleSearcher,
    double_range_mask,
    numeric_range_mask,
    point_range_mask,
)
from diagon_tpu_torch.search.phrase import PhraseExecutor
from diagon_tpu_torch.search.query import (
    BooleanQuery,
    DoubleRangeQuery,
    MatchAllDocsQuery,
    NumericRangeQuery,
    Occur,
    PhraseQuery,
    PointRangeQuery,
    Query,
    TermQuery,
)
from diagon_tpu_torch.search.row_engine import (
    HEAVY_FRACTION,
    HEAVY_MIN_DF,
    LANE,
    PRUNE_B0,
    RowFieldIndex,
    _bucket_tq,
    _tile_major,
    row_score_topk_pallas,
    row_score_topk_pruned_batch,
)
from diagon_tpu_torch.search.topdocs import TopDocs, top_docs_batch


def merge_topk(scores: torch.Tensor, docs: torch.Tensor, k: int):
    """Exact (score desc, docid asc) top-k over the last axis: the JAX
    two-key stable ``lax.sort`` of (-score, docid), as a stable sort by
    docid and then a stable sort by the negated score. Like ``lax.sort``,
    it ties -0.0 with +0.0 (the docid decides) and puts NaN last. (It is
    not ``lax.top_k``, which ranks -0.0 below +0.0: ``_select_tiles``' key.)"""
    docs, by_doc = torch.sort(docs, dim=-1, stable=True)
    neg = torch.gather(torch.neg(scores), -1, by_doc)
    neg, order = torch.sort(neg, dim=-1, stable=True)
    return torch.neg(neg[..., :k]), torch.gather(docs, -1, order[..., :k])


def _shard_compact_build(heavy: torch.Tensor, light: torch.Tensor,
                         srcidx: torch.Tensor):
    """One shard's batch-compact bank, the per-shard body of the JAX
    ``_sharded_compact_build``: (tile-major f32 [G, U8, LANE], bf16
    [U8, D]). ``srcidx`` row 0 is the zero row, 1 + h heavy row h and
    1 + H + j light-bank row j (light row 0 is zero too): the exact f32
    rows the exhaustive program reads, so the pruned rescore stays
    bit-exact."""
    D = heavy.shape[1]
    src = torch.cat([heavy.new_zeros((1, D)), heavy, light])
    bank = src[srcidx.long()]
    return _tile_major(bank), bank.to(torch.bfloat16)


def _rank_device(device, rank: int) -> torch.device:
    """``device`` as given, or ``cuda:(LOCAL_RANK, else rank, mod the card
    count)``; raises where CUDA is wanted and absent."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ShardedSearcher: no CUDA device; pass device='cpu' to "
                "search on the host"
            )
        local = int(os.environ.get("LOCAL_RANK", rank))
        return torch.device("cuda", local % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"ShardedSearcher: {device} asked for, no CUDA "
                           "device present")
    return device


# the planning quantities every rank reduces (MAX) before building a
# batch's device arrays, in the order of the reduced vector
_ROUTE_KEYS = ("n_spec", "n_light", "max_u", "any_req", "any_neg",
               "any_present_nonscoring", "max_min_should", "any_ng",
               "any_rq_sh", "max_rq")


class ShardedSearcher:
    """Search across segment shards, one per rank of ``group`` (the
    default group when None): rank r holds ``shards[r]`` on ``device``
    (None: ``cuda:(LOCAL_RANK, else rank, mod the card count)``; the
    caller names "cpu" to search on the host). ``shards`` is every shard's
    ``SegmentData``, in the same order on every rank."""

    # batches at least this large take the pruned per-shard kernels (the
    # single-device RowExecutor.approx_min_q); below it the exhaustive
    # program wins (one bank pass, no certificate risk)
    approx_min_q = 8
    COMPACT_MAX_ROWS = 512
    # tests force a tiny tile budget to exercise the escalation
    prune_B_override: int = 0

    def __init__(self, shards: Sequence, field: str, group=None,
                 device=None):
        if not dist.is_initialized():
            raise RuntimeError(
                "ShardedSearcher needs an initialized torch.distributed "
                "process group (parallel.launch.run_ranks starts one)"
            )
        self.group = dist.group.WORLD if group is None else group
        self.shards = list(shards)
        S = len(self.shards)
        self.world = dist.get_world_size(self.group)
        if self.world != S:
            raise ValueError(
                f"the process group has {self.world} ranks, need {S}"
            )
        self.rank = dist.get_rank(self.group)
        self.device = _rank_device(device, self.rank)
        self._nccl = str(dist.get_backend(self.group)).lower() == "nccl"
        if self._nccl and self.device.type != "cuda":
            raise ValueError(
                f"an NCCL group collects CUDA tensors; device is {self.device}"
            )
        self.field = field

        self.doc_bases = np.cumsum([0] + [s.num_docs for s in self.shards])
        self.max_doc = int(self.doc_bases[-1])
        self.doc_base = int(self.doc_bases[self.rank])
        self.sim = BM25Similarity()

        pps = [s.fields[field].postings for s in self.shards]
        self._pps = pps
        stt = sum(pp.sum_total_tf for pp in pps)
        if stt <= 0:
            stt = self.max_doc * 10
        self.avgdl = BM25Similarity.avg_field_length(stt, self.max_doc)
        max_freq = max(
            max(1, int(pp.block_max_freq.max(initial=1))) for pp in pps
        )
        self.tf_lut_host = make_tf_table(self.avgdl, max_freq)

        self._idf_cache: Dict[str, np.float32] = {}
        self._phrase_exec = False  # this rank's PhraseExecutor, once built
        self._oracle: Optional[OracleSearcher] = None

        # a COMMON doc padding (1024 = the row kernels' granule)
        self.num_docs_pad = max(
            1024,
            ((max(s.num_docs for s in self.shards) + 1023) // 1024) * 1024,
        )
        seg = self.shards[self.rank]
        fd = seg.fields[field]
        self.row_index = RowFieldIndex(
            fd.postings, fd.norms, self.num_docs_pad, seg.live_docs,
            self.tf_lut_host, self.device,
        )

        # GLOBALLY ALIGNED heavy bank: the heavy set is chosen by
        # collection df, and every shard's bank row j holds the same term
        # (a zero row where the shard lacks it)
        global_df: Dict[str, int] = {}
        for pp in pps:
            for tid, t in enumerate(pp.terms):
                global_df[t] = global_df.get(t, 0) + int(pp.doc_freq[tid])
        threshold = max(HEAVY_MIN_DF, self.max_doc // HEAVY_FRACTION)
        self.heavy_terms = sorted(
            t for t, df_ in global_df.items() if df_ >= threshold
        )
        own = pps[self.rank]
        self.row_index.build_heavy_bank(
            lambda tid: self._idf(own.terms[tid]),
            heavy_tids=[own.term_id(t) for t in self.heavy_terms],
        )
        self.heavy_bank = self.row_index.heavy_bank
        self.live = self.row_index.live
        self._plan_cache: Dict[tuple, tuple] = {}
        # host seconds of the last search_batch: plan, device, gather+merge
        self.last_split: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    # ------------------------------------------------------------------
    def term_doc_freq(self, text: str) -> int:
        df = 0
        for pp in self._pps:
            tid = pp.term_id(text)
            if tid >= 0:
                df += int(pp.doc_freq[tid])
        return df

    def _idf(self, text: str, boost: float = 1.0) -> np.float32:
        key = text if boost == 1.0 else f"{text}\0{boost}"
        v = self._idf_cache.get(key)
        if v is None:
            df = self.term_doc_freq(text)
            if df == 0:
                df = max(1, self.max_doc // 10)
            v = np.float32(self.sim.idf(df, self.max_doc) * np.float32(boost))
            self._idf_cache[key] = v
        return v

    _GENERAL = (
        "BooleanQuery", "PhraseQuery", "NumericRangeQuery",
        "PointRangeQuery", "DoubleRangeQuery", "MatchAllDocsQuery",
    )

    def _clauses(self, q: Query) -> Optional[Tuple[list, int]]:
        """Flatten like IndexSearcher._term_clauses: same-field terms
        become bank rows, every other clause a host row (``_flat_specs``)."""
        if isinstance(q, TermQuery):
            return [(q, Occur.SHOULD)], 1
        if type(q).__name__ in self._GENERAL and not isinstance(
            q, BooleanQuery
        ):
            return [(q, Occur.SHOULD)], 1
        clauses = [(c.query, c.occur) for c in q.clauses]
        min_should = q.minimum_number_should_match
        has_required = any(
            o in (Occur.MUST, Occur.FILTER) for _, o in clauses
        )
        if not has_required:
            min_should = max(min_should, 1)
        has_should = any(o == Occur.SHOULD for _, o in clauses)
        if not has_should and not has_required:
            return None
        return clauses, min_should

    def _oracle_rows(self, q: Query):
        if self._oracle is None:
            self._oracle = OracleSearcher(self.shards)
        scores, mask = self._oracle._score_dense(self.shards[self.rank], q)
        return scores, mask.astype(np.float32)

    def _phrase_rows(self, q: PhraseQuery) -> Optional[tuple]:
        """Phrase clause rows from this rank's ``PhraseExecutor`` on its
        device, scored with the global statistics; None (the oracle's
        rows) for another field or a shard without positions."""
        if q.field != self.field:
            return None
        ex = self._phrase_exec
        if ex is False:
            try:
                ex = PhraseExecutor(
                    load_segment(self.shards[self.rank], self.device),
                    self.field, self.tf_lut_host,
                )
            except (ValueError, KeyError):
                ex = None
            self._phrase_exec = ex
        if ex is None:
            return None
        # idf from the rarest member term over GLOBAL stats, as
        # OracleSearcher._score_phrase (PhraseQuery.cpp:304-338)
        min_df = self.max_doc
        for t in q.terms:
            df = self.term_doc_freq(t)
            if df > 0:
                min_df = min(min_df, df)
        if min_df <= 0:
            min_df = 1
        idf = float(
            self.sim.idf(min_df, self.max_doc) * np.float32(q.boost)
        )
        return ex.score_row(q.terms, idf, self.shards[self.rank].num_docs)

    def _flat_specs(self, clauses, min_should):
        """This rank's flat clause specs in oracle order: (heavy row, host
        row, weight, scoring, is_req, is_sho, is_neg)."""
        pp = self._pps[self.rank]
        ridx = self.row_index
        seg = self.shards[self.rank]

        def _key(item):
            q = item[0]
            return (
                (q.term.field, q.term.text)
                if isinstance(q, TermQuery)
                else ("", "")
            )

        groups = [
            (sorted([c for c in clauses if c[1] == o], key=_key), o)
            for o in (Occur.MUST, Occur.FILTER, Occur.SHOULD, Occur.MUST_NOT)
        ]
        num_required = sum(
            len(g) for g, o in groups if o in (Occur.MUST, Occur.FILTER)
        )
        specs = []
        for group, occ in groups:
            is_req = occ in (Occur.MUST, Occur.FILTER)
            is_sho = occ == Occur.SHOULD
            is_neg = occ == Occur.MUST_NOT
            scoring = occ in (Occur.MUST, Occur.SHOULD)
            for q, _ in group:
                if isinstance(q, TermQuery) and q.term.field == self.field:
                    tid = pp.term_id(q.term.text)
                    if tid < 0:
                        specs.append(
                            (-1, None, 0.0, False, is_req, is_sho, is_neg)
                        )
                        continue
                    w = self._idf(q.term.text, q.boost)
                    hrow = int(ridx.heavy_row_of_term[tid])
                    if hrow >= 0 and (
                        not scoring
                        or np.float32(w) == self._idf(q.term.text)
                    ):
                        specs.append(
                            (hrow, None, float(w), scoring,
                             is_req, is_sho, is_neg)
                        )
                    else:
                        ww = np.float32(w) if scoring else np.float32(1.0)
                        specs.append(
                            (-1, ridx.host_row(tid, ww), float(ww),
                             scoring, is_req, is_sho, is_neg)
                        )
                    continue
                if isinstance(
                    q, (NumericRangeQuery, PointRangeQuery,
                        DoubleRangeQuery, MatchAllDocsQuery)
                ):
                    if isinstance(q, MatchAllDocsQuery):
                        row = np.ones(seg.num_docs, np.float32)
                    elif isinstance(q, NumericRangeQuery):
                        row = numeric_range_mask(
                            seg, q.field, q.lower, q.upper
                        ).astype(np.float32)
                    elif isinstance(q, DoubleRangeQuery):
                        row = double_range_mask(
                            seg, q.field, q.lower, q.upper,
                            q.include_lower, q.include_upper,
                        ).astype(np.float32)
                    else:
                        row = point_range_mask(
                            seg, q.field, q.lower, q.upper
                        ).astype(np.float32)
                    specs.append(
                        (-1, row, 1.0 if scoring else 0.0, scoring,
                         is_req, is_sho, is_neg)
                    )
                    continue
                pr = (
                    self._phrase_rows(q)
                    if isinstance(q, PhraseQuery)
                    else None
                )
                scores, match = pr if pr is not None else self._oracle_rows(q)
                if isinstance(q, BooleanQuery):
                    if scoring:
                        specs.append(
                            (-1, scores, 1.0, True, False, False, False)
                        )
                    specs.append(
                        (-1, match, 0.0, False, is_req, is_sho, is_neg)
                    )
                else:  # phrase / foreign-field term: score>0 iff matched
                    row = scores if scoring else match
                    specs.append(
                        (-1, row, 1.0 if scoring else 0.0, scoring,
                         is_req, is_sho, is_neg)
                    )
        return specs, num_required

    # ------------------------------------------------------------------
    def _to_backend(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where the group's collectives take it: the card under
        NCCL, the host under gloo."""
        return t.to(self.device) if self._nccl else t.cpu()

    def _reduce_route(self, local: Dict[str, int]) -> Dict[str, int]:
        """Every rank's planning quantities, reduced (MAX) over the group."""
        t = self._to_backend(torch.tensor([int(local[k]) for k in _ROUTE_KEYS],
                                          dtype=torch.int64))
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return dict(zip(_ROUTE_KEYS, t.cpu().tolist()))

    def _plans(self, queries: Sequence[Query]):
        """This rank's plan arrays on its device, routed as the JAX program
        routes the whole batch: (light bank, hidx, lidx, scoring, req, sho,
        neg, bool_params, compact or None). A collective on a cache miss
        (every rank misses together: the same queries, the same cache)."""
        key = tuple(repr(q) for q in queries)
        cached = self._plan_cache.get(key)
        if cached is not None:
            return cached

        Q = len(queries)
        per_query = []
        for q in queries:
            c = self._clauses(q)
            if c is None:
                raise ValueError(
                    f"ShardedSearcher: query matches nothing ({q!r})"
                )
            per_query.append(c)
        all_specs = [self._flat_specs(clauses, ms) for clauses, ms in per_query]
        n_spec = max(len(specs) for specs, _ in all_specs)

        hidx = np.full((Q, n_spec), -1, dtype=np.int32)
        lidx = np.zeros((Q, n_spec), dtype=np.int32)
        scoring = np.zeros((Q, n_spec), dtype=bool)
        req = np.zeros((Q, n_spec), dtype=np.float32)
        sho = np.zeros((Q, n_spec), dtype=np.float32)
        neg = np.zeros((Q, n_spec), dtype=np.float32)
        bool_params = np.zeros((Q, 2), dtype=np.float32)
        light_rows: List[np.ndarray] = []
        for qi, ((_, min_should), (specs, num_required)) in enumerate(
            zip(per_query, all_specs)
        ):
            for i, (
                hrow, host_row, w, sc, is_req, is_sho, is_neg
            ) in enumerate(specs):
                present = hrow >= 0 or host_row is not None
                scoring[qi, i] = sc and w != 0.0
                req[qi, i] = 1.0 if (is_req and present) else 0.0
                sho[qi, i] = 1.0 if (is_sho and present) else 0.0
                neg[qi, i] = 1.0 if (is_neg and present) else 0.0
                if hrow >= 0:
                    hidx[qi, i] = hrow
                elif host_row is not None:
                    light_rows.append(host_row)
                    lidx[qi, i] = len(light_rows)
            bool_params[qi] = (num_required, min_should)

        local = self._compact_local(hidx, lidx, scoring, req, sho, neg,
                                    bool_params, len(light_rows))
        g = self._reduce_route(dict(local["stats"], n_spec=n_spec,
                                    n_light=len(light_rows)))

        tq = _bucket_tq(g["n_spec"])
        l_pad = max(1, g["n_light"] + 1)
        l_pad = 1 << int(np.ceil(np.log2(l_pad)))
        lbank = np.zeros((l_pad, self.num_docs_pad), dtype=np.float32)
        for j, row in enumerate(light_rows):
            lbank[j + 1, : len(row)] = row

        def dev(a, width=tq, fill=0):
            out = np.full((a.shape[0], width), fill, dtype=a.dtype)
            out[:, : a.shape[1]] = a
            return torch.from_numpy(out).to(self.device)

        lbank_d = torch.from_numpy(lbank).to(self.device)
        out = (
            lbank_d, dev(hidx, fill=-1), dev(lidx), dev(scoring), dev(req),
            dev(sho), dev(neg), torch.from_numpy(bool_params).to(self.device),
        )
        compact = None
        if Q >= self.approx_min_q and g["max_u"] <= self.COMPACT_MAX_ROWS:
            compact = self._compact_finish(local, g, out)
        out = out + (compact,)
        if len(self._plan_cache) < 64:
            self._plan_cache[key] = out
        return out

    def _compact_local(self, hidx, lidx, scoring, req, sho, neg,
                       bool_params, n_light):
        """This shard's half of the JAX ``_compact_plans``: its clause rows
        compacted into gather indices, the per-clause compact rows and the
        role indicators, and the planning quantities the route reduction
        needs (all zero for batches below ``approx_min_q``)."""
        Q, T = hidx.shape
        stats = dict.fromkeys(_ROUTE_KEYS[2:], 0)
        if Q < self.approx_min_q:
            return {"stats": stats}
        H_pad = int(self.heavy_bank.shape[0])
        u = np.unique(hidx[hidx >= 0])
        U = 1 + len(u) + n_light
        srcidx = np.zeros(U, np.int32)
        srcidx[1 : 1 + len(u)] = 1 + u
        srcidx[1 + len(u) :] = 1 + H_pad + 1 + np.arange(n_light)
        hpos = np.zeros(int(u.max()) + 1 if len(u) else 1, np.int32)
        hpos[u] = 1 + np.arange(len(u), dtype=np.int32)
        cidx = np.where(
            hidx >= 0,
            hpos[np.maximum(hidx, 0)],
            np.where(lidx > 0, 1 + len(u) + (lidx - 1), 0),
        ).astype(np.int32)
        qgrid = np.broadcast_to(np.arange(Q)[:, None], (Q, T))
        a = {}
        for r, marr in (("sc", scoring), ("rq", req > 0), ("sh", sho > 0),
                        ("ng", neg > 0)):
            a[r] = np.zeros((U, Q), np.float32)
            m = marr.astype(bool) & (cidx > 0)
            np.add.at(a[r], (cidx[m], qgrid[m]), 1.0)
        stats.update(
            max_u=U,
            any_req=bool((req > 0).any()),
            any_neg=bool((neg > 0).any()),
            any_present_nonscoring=bool(((cidx > 0) & ~scoring).any()),
            max_min_should=int(bool_params[:, 1].max(initial=0)),
            any_ng=bool(a["ng"].any()),
            any_rq_sh=bool(((a["rq"] > 0) & (a["sh"] > 0)).any()),
            max_rq=int(a["rq"].max(initial=0)),
        )
        return {"stats": stats, "srcidx": srcidx, "cidx": cidx, "a": a}

    def _compact_finish(self, local, g, arrays):
        """The compact plan on this rank's device from its local half, the
        reduced quantities and the batch's device ``arrays`` (``_plans``'
        first eight): U8 from the largest shard's rows, and the JAX
        program's kernel choice (pure-OR -> 1-product phase 1, B3;
        no-negation booleans without role-overlapping rows -> the fused
        2-product B5; else the 4-product B4)."""
        lbank, hidx, _, scoring, req, sho, neg, bool_params = arrays
        pure_or = bool(
            not g["any_req"]
            and not g["any_neg"]
            and g["max_min_should"] <= 1
            and not g["any_present_nonscoring"]
        )
        fused2 = bool(
            not pure_or
            and not g["any_ng"]
            and not g["any_rq_sh"]
            and g["max_rq"] < 256
        )
        U8 = -(-g["max_u"] // 8) * 8
        Q, T = local["cidx"].shape
        srcidx = np.zeros(U8, np.int32)
        srcidx[: len(local["srcidx"])] = local["srcidx"]
        cidx = np.zeros((Q, hidx.shape[1]), np.int32)
        cidx[:, :T] = local["cidx"]
        a = {}
        for r, arr in local["a"].items():
            a[r] = np.zeros((U8, Q), np.float32)
            a[r][: arr.shape[0]] = arr
        a["cb"] = a["rq"] * np.float32(256.0) + a["sh"]
        params = torch.zeros((8, Q), dtype=torch.float32, device=self.device)
        params[0] = bool_params[:, 0]
        params[1] = bool_params[:, 1]
        cflags = (scoring.int() + 2 * (req > 0).int() + 4 * (sho > 0).int()
                  + 8 * (neg > 0).int())
        srcidx = torch.from_numpy(srcidx).to(self.device)
        compact_t, compact_bf16 = _shard_compact_build(
            self.heavy_bank, lbank, srcidx
        )
        out = {
            "srcidx": srcidx,
            "cidx": torch.from_numpy(cidx).to(self.device),
            "cflags": cflags.contiguous(),
            "params_t": params,
            "compact_t": compact_t,
            "compact_bf16": compact_bf16,
            "pure_or": pure_or,
            "fused2": fused2,
        }
        for r, arr in a.items():
            out[f"a_{r}_t"] = torch.from_numpy(arr).to(self.device).to(
                torch.bfloat16)
        return out

    # ------------------------------------------------------------------
    def search_batch(self, queries: Sequence[Query], k: int = 10) -> List[TopDocs]:
        """Top-k of each query over every shard, the same on every rank."""
        t0 = time.perf_counter()
        (
            lbank, hidx, lidx, scoring, req, sho, neg, bool_params, compact,
        ) = self._plans(queries)
        t1 = time.perf_counter()
        n_fail = 0
        if compact is not None:
            G = self.num_docs_pad // LANE
            Q = len(queries)
            smem_cap = max(32, (512 << 10) // (4 * max(Q, 1)))
            B = self.prune_B_override or min(
                G, smem_cap, max(PRUNE_B0, -(-k // LANE) + 1, G // 512)
            )
            fusedp = row_score_topk_pruned_batch(
                compact["compact_t"], compact["compact_bf16"],
                compact["cidx"], compact["cflags"], self.live,
                compact["a_sc_t"], compact["a_rq_t"], compact["a_sh_t"],
                compact["a_ng_t"], compact["params_t"], bool_params,
                k=k, B=B, boolean=not compact["pure_or"],
                a_cb_t=compact["a_cb_t"] if compact["fused2"] else None,
            )  # [Q, 2k+2]
            fused = fusedp[:, : 2 * k + 1]
            safe = fusedp[:, 2 * k + 1] > 0
            if not bool(safe.all()):
                # escalation: the failed queries on the exhaustive kernel
                fail = torch.nonzero(~safe).flatten()
                fused = fused.clone()
                fused[fail] = row_score_topk_pallas(
                    self.heavy_bank, lbank, self.live,
                    *(t[fail].contiguous() for t in (
                        hidx, lidx, scoring, req, sho, neg, bool_params)),
                    k=k,
                )
                n_fail = int(fail.numel())
        else:
            fused = row_score_topk_pallas(
                self.heavy_bank, lbank, self.live, hidx, lidx, scoring, req,
                sho, neg, bool_params, k=k,
            )  # [Q, 2k+1]
        scores = fused[:, :k]
        docs = fused[:, k : 2 * k].to(torch.int32) + self.doc_base
        hits = fused[:, 2 * k : 2 * k + 1].to(torch.int32)
        rows = torch.cat([scores.contiguous().view(torch.int32), docs, hits],
                         dim=1)
        tail = torch.zeros((1, 2 * k + 1), dtype=torch.int32,
                           device=rows.device)
        tail[0, 0] = n_fail
        rows = self._to_backend(torch.cat([rows, tail]))
        t2 = time.perf_counter()
        m_scores, m_docs, total, n_esc = self._gather_merge(rows, k)
        if n_esc:
            registry.counter(
                "search.sharded_escalations",
                "sharded (query, shard) pairs escalated to exhaustive",
            ).increment(n_esc)
        out = top_docs_batch([(m_scores.cpu().numpy(), m_docs.cpu().numpy(),
                               total.cpu().numpy(), 0)], k)
        self.last_split = (t1 - t0, t2 - t1, time.perf_counter() - t2)
        return out

    def _gather_merge(self, rows, k: int):
        """All-gather every rank's [Q+1, 2k+1] i32 ``rows`` (per query:
        k score bit patterns, k global docids, the hit count; last row:
        the escalation count) in one collective, sum the counts over the
        shards (the JAX program's psum) and merge the [Q, S*k] candidates
        in the JAX order (shard-major within each query). Returns (scores,
        docids, total hits, escalations)."""
        Q = rows.shape[0] - 1
        parts = [torch.empty_like(rows) for _ in range(self.world)]
        dist.all_gather(parts, rows, group=self.group)
        allp = torch.stack(parts)  # [S, Q+1, 2k+1]
        flat_scores = (allp[:, :Q, :k].contiguous().view(torch.float32)
                       .transpose(0, 1).reshape(Q, self.world * k))
        flat_docs = (allp[:, :Q, k : 2 * k].transpose(0, 1)
                     .reshape(Q, self.world * k))
        m_scores, m_docs = merge_topk(flat_scores, flat_docs, k)
        total = allp[:, :Q, 2 * k].to(torch.int64).sum(dim=0)
        return m_scores, m_docs, total, int(allp[:, Q, 0].sum())

    def search(self, query: Query, k: int = 10) -> TopDocs:
        return self.search_batch([query], k)[0]
