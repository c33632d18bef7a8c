"""Row-bank scoring engine (PyTorch): the exhaustive and the pruned route.

Counterpart of ``diagon_tpu/search/row_engine.py``. The index view for
scoring is one dense f32 score row per term over the padded doc axis (the
exact BM25 contribution of that term to every doc, idf folded in):

- heavy terms (df >= num_docs_pad / HEAVY_FRACTION) live in a device bank
  ``[H, D]`` built once per searcher, decoded on the device from the
  packed postings (kernel B9, ``diagon_tpu_torch.ops.bank_decode``);
- light terms, boosted clauses and host rows (ranges, nested booleans)
  form a small per-batch light bank whose row 0 is all zero.

Exhaustive route: a query is a walk over its clauses in oracle order, one
row read and one f32 add per clause (kernels B1/B2,
``diagon_tpu_torch.ops.row_sum``), then the match mask and an exact top-k
with ties toward the lower docid. No device multiply feeds an add, so
results are bit-identical to the oracle.

Pruned route, for query batches on segments of at least
``PRUNE_MIN_DOCS`` docs (``row_score_topk_pruned_batch``): the batch's
clause rows are compacted into one small bank (``_assemble_compact``);
phase 1 (B3/B4/B5, ``ops.approx_pass``) bounds every (query, 128-doc
tile) from one product of the clause indicators with its bf16 copy and
counts the exact hits; ``_select_tiles`` keeps the best tiles; phase 2
(B6 or B7, ``ops.gather_rescore``) rescores them exactly, and the
certificates of ``_pruned_batch_finish`` prove the top-k exact or send
the query back to the exhaustive route in ``RowExecutor.finalize``.
Results stay bit-identical to the exhaustive route, the JAX searcher and
the oracle.

Small-batch tile-UB route, for pure-OR batches of fewer than
``approx_min_q`` plans (a solo search among them) on segments of
``prune_solo_min_docs`` to ``batch_only_min_docs`` padded docs
(``row_score_topk_pruned_or``): tile bounds are the sums of the clause
rows' tile maxima and hits come from presence bitmaps (``build_tile_aux``,
built with the resident heavy bank and, lazily, the batch's light bank);
the best tiles are rescored in torch ops with the same certificate and
escalation.

On-demand mode, for segments of ``BANK_ON_DEMAND_MIN_DOCS`` padded docs or
more: heavy terms are classified but no resident bank is built. Each
batch's compact bank is scatter-built from the packed postings in row
groups (``RowFieldIndex.build_rows_grouped``), and exhaustive scoring,
counts and escalations read a bank of just the batch's heavy rows
(``RowExecutor._demand_heavy_args``). Every pure-OR batch takes the batch
route there. Phase 1 may replay from the entry's cache when an identical
batch is re-issued (``query_cache``). With ``use_phase0`` set (off by
default, as in the JAX package), batches whose plans all have
min_should <= 1 take phase 0 instead of phase 1: tile bounds from
per-row tile maxima (``_pruned_batch_phase0``, full-f32 products) and
exact hit counts from presence bitmaps (kernel B8, ``ops.bits_hits``).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from diagon_tpu_torch.codecs.postings import decode_blocks_numpy
from diagon_tpu_torch.observability.metrics import registry
from diagon_tpu_torch.observability.profiler import ProfileScope
from diagon_tpu_torch.ops import bank_decode
from diagon_tpu_torch.ops.approx_pass import (
    approx_select,
    approx_select_bool,
    approx_select_bool2,
)
from diagon_tpu_torch.ops.bits_hits import (
    MODE_DEAD,
    MODE_REQ,
    MODE_SHO,
    _popcount,
    bits_hits,
)
from diagon_tpu_torch.ops.gather_rescore import (
    gather_rescore,
    union_rescore,
    union_rescore_supported,
)
from diagon_tpu_torch.ops.row_sum import (
    row_boolean,
    row_boolean_reference,
    row_sum,
    row_sum_reference,
)
from diagon_tpu_torch.search.engine import unfuse_topk

LANE = 128  # docs per tile of the two-stage top-k
HEAVY_FRACTION = 16  # heavy iff df >= num_docs_pad / HEAVY_FRACTION
HEAVY_MIN_DF = 256

# Block-max pruned scoring engages once a segment has this many padded
# docs, and starts from PRUNE_B0 candidate tiles per query (the JAX
# package's values, kept for parity; ROADMAP: retune on the H100)
PRUNE_MIN_DOCS = 1 << 14
PRUNE_B0 = 24

# Relative error bound of the phase-1 tile maxima: true tile max <=
# tmax * (1 + _APPROX_RELEPS). Derived for the port's kernels and plain
# versions in ``diagon_tpu_torch/ops/approx_pass.py``.
_APPROX_RELEPS = np.float32(2.0 ** -7)

# Segments at least this large hold no resident heavy bank (on-demand
# mode): compact banks are built per batch from the packed postings
BANK_ON_DEMAND_MIN_DOCS = 4 << 20
# rows per on-demand row group (build_rows_grouped): one group's [rows, D]
# f32 transient is 2.6 GB at 10M docs (patchable in tests to force
# several groups)
_ROW_GROUP_ROWS = 64


def _bucket_tq(n: int) -> int:
    """Clause-count bucket: multiples of 4 up to 24, then powers of two
    (the JAX package's plan width, kept so both score the same [Q, Tq])."""
    if n <= 24:
        return max(4, ((n + 3) // 4) * 4)
    return 1 << (n - 1).bit_length()


def exact_topk(final: torch.Tensor, k: int):
    """(scores desc, docid asc) top-k over the last axis of ``final``.

    ``torch.topk`` promises no order among ties, so selection is a stable
    descending sort: equal scores keep ascending docid order, the order
    ``lax.top_k`` gives the JAX package. For D > 32768 a two-stage exact
    selection: per-128-tile maxima -> top-k tiles (ties to the lower
    tile) -> stable sort of their k*128 candidates in ascending docid
    order. Exact: a true top-k doc in an unselected tile would be outranked
    by the max doc of each of k selected tiles (on ties, those have lower
    docids)."""
    D = final.shape[-1]
    if D <= 32768 or D % LANE != 0:
        vals, idx = torch.sort(final, dim=-1, descending=True, stable=True)
        return vals[..., :k], idx[..., :k]
    G = D // LANE
    kt = min(k, G)
    tiles = final.reshape(*final.shape[:-1], G, LANE)
    tmax = tiles.amax(dim=-1)
    _, tidx = torch.sort(tmax, dim=-1, descending=True, stable=True)
    tidx = tidx[..., :kt].sort(dim=-1).values  # ascending docid order
    cand = torch.gather(
        tiles, -2, tidx[..., None].expand(*tidx.shape, LANE)
    ).reshape(*final.shape[:-1], kt * LANE)
    lane = torch.arange(LANE, device=final.device)
    cand_docs = (tidx[..., None] * LANE + lane).reshape(cand.shape)
    vals, order = torch.sort(cand, dim=-1, descending=True, stable=True)
    return vals[..., :k], torch.gather(cand_docs, -1, order[..., :k])


def _fuse(final: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """[Q, 2k+1] fused rows: k scores | k docids as f32 | hits. Docids
    and hits travel as exact f32 values, exact below 2^24 docs."""
    top_scores, top_docs = exact_topk(final, k)
    hits = mask.sum(dim=-1, dtype=torch.int64)
    return torch.cat(
        [top_scores, top_docs.float(), hits.float()[:, None]], dim=1
    )


def _finish_pure_or(scores, live, k):
    mask = (scores > 0) & (live > 0)
    return _fuse(torch.where(mask, scores, -1.0), mask, k)


def _boolean_mask(req_c, sho_c, neg_c, live, bool_params):
    num_required = bool_params[:, 0:1]
    min_should = bool_params[:, 1:2]
    return (
        (req_c == num_required)
        & (sho_c >= min_should)
        & (neg_c == 0)
        & ((req_c + sho_c) > 0)
        & (live > 0)
    )


def _flags(scoring, req, sho, neg):
    """bit0 scoring, bit1 required, bit2 should, bit3 must_not (i32)."""
    return (
        scoring.int() + 2 * req.int() + 4 * sho.int() + 8 * neg.int()
    ).contiguous()


def row_score_topk_pure_or_pallas(heavy, light, live, hidx, lidx, *, k: int):
    """Pure-OR exhaustive scoring through kernel B1 (a doc matches iff its
    score is positive). Counterpart of the JAX function of this name;
    returns fused rows [Q, 2k+1]."""
    return _finish_pure_or(row_sum(heavy, light, hidx, lidx), live, k)


def row_score_topk_pure_or(heavy, light, live, hidx, lidx, *, k: int):
    """Plain PyTorch version of ``row_score_topk_pure_or_pallas``."""
    return _finish_pure_or(
        row_sum_reference(heavy, light, hidx, lidx), live, k
    )


def _finish_boolean(accs, live, bool_params, k):
    scores, req_c, sho_c, neg_c = accs
    mask = _boolean_mask(req_c, sho_c, neg_c, live, bool_params)
    return _fuse(torch.where(mask, scores, -1.0), mask, k)


def row_score_topk_pallas(heavy, light, live, hidx, lidx, scoring, req, sho,
                          neg, bool_params, *, k: int):
    """General boolean exhaustive scoring through kernel B2; fused rows
    [Q, 2k+1]. Counterpart of the JAX function of this name."""
    accs = row_boolean(heavy, light, hidx, lidx, _flags(scoring, req, sho, neg))
    return _finish_boolean(accs, live, bool_params, k)


def row_score_topk(heavy, light, live, hidx, lidx, scoring, req, sho, neg,
                   bool_params, *, k: int):
    """Plain PyTorch version of ``row_score_topk_pallas``."""
    accs = row_boolean_reference(
        heavy, light, hidx, lidx, _flags(scoring, req, sho, neg)
    )
    return _finish_boolean(accs, live, bool_params, k)


def row_count(heavy, light, live, hidx, lidx, scoring, req, sho, neg,
              bool_params):
    """Match counts i64 [Q] from B2's count accumulators."""
    _, req_c, sho_c, neg_c = row_boolean(
        heavy, light, hidx, lidx, _flags(scoring, req, sho, neg)
    )
    mask = _boolean_mask(req_c, sho_c, neg_c, live, bool_params)
    return mask.sum(dim=-1)


# ---------------------------------------------------------------------------
# Pruned batch route
# ---------------------------------------------------------------------------


def _pad_rows8(bank: torch.Tensor) -> torch.Tensor:
    """Pad a bank's row count to a multiple of 8 with zero rows (zero rows
    add nothing to a product)."""
    n = bank.shape[0]
    n8 = -(-n // 8) * 8
    if n8 == n:
        return bank
    return torch.cat([bank, bank.new_zeros((n8 - n, bank.shape[1]))])


def _tile_major(bank: torch.Tensor) -> torch.Tensor:
    """[N, D] row bank -> [G, N8, LANE] tile-major copy, rows padded to a
    multiple of 8: one selected tile is one contiguous [N8, LANE] slab.
    (The JAX module defines ``_tile_major`` twice; this is its second,
    padding definition, the one in effect.)"""
    b8 = _pad_rows8(bank)
    N8, D = b8.shape
    return b8.reshape(N8, D // LANE, LANE).permute(1, 0, 2).contiguous()


def _assemble_compact(heavy_bank, used: np.ndarray, light_bank,
                      n_light: int) -> torch.Tensor:
    """The batch-compact bank f32 [U8, D]: row 0 zero, then the heavy rows
    ``used`` (ascending), then light rows 1..n_light, zero rows up to a
    multiple of 8. The JAX package buckets the gather to 32 rows to spare
    XLA recompiles; eager PyTorch assembles at the exact size."""
    D = heavy_bank.shape[1]
    n_used = len(used)
    n_rows = 1 + n_used + n_light
    rows = heavy_bank.new_zeros((-(-n_rows // 8) * 8, D))
    if n_used:
        sel = torch.from_numpy(np.asarray(used, np.int64)).to(heavy_bank.device)
        rows[1 : 1 + n_used] = heavy_bank[sel]
    if n_light:
        rows[1 + n_used : n_rows] = light_bank[1 : 1 + n_light]
    return rows


def _select_tiles(tile_upper: torch.Tensor, Bk: int, G: int):
    """Batch tile selection: (tsel i32 [Q, Bk] ascending, u_next f32 [Q],
    min_unsel_feas i32 [Q]), the semantics of the JAX package's
    ``_select_tiles_flat`` at every G.

    The Bk tiles with the largest upper bounds, ties toward the lower tile
    index (``lax.top_k``'s rule, in its total order): the Bk-th largest is the
    threshold, every tile above it is selected, and the lowest-index tiles
    equal to it fill the rest. ``u_next`` is the exact maximum over the
    unselected tiles (-inf when every tile is selected);
    ``min_unsel_feas`` the smallest unselected tile index whose bound is
    >= 0 (G when none), which on the boolean path bounds the lowest docid
    of any unselected match. No device-to-host sync: the selected indices
    are scattered to their ranks."""
    Q = tile_upper.shape[0]
    dev = tile_upper.device
    if Bk >= G:
        tsel = torch.arange(G, dtype=torch.int32, device=dev).expand(Q, G)
        return (
            tsel.contiguous(),
            torch.full((Q,), -float("inf"), dtype=torch.float32, device=dev),
            torch.full((Q,), G, dtype=torch.int32, device=dev),
        )
    # rank by the IEEE total order, as lax.top_k does (-0.0 below +0.0):
    # the int32 key flips the magnitude bits of negative values
    bits = tile_upper.contiguous().view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    kth = torch.topk(key, Bk, dim=1).values[:, -1:]
    above = key > kth
    tied = key == kth
    room = Bk - above.sum(dim=1, keepdim=True)
    sel = above | (tied & (torch.cumsum(tied, dim=1) <= room))
    rank = torch.where(sel, torch.cumsum(sel, dim=1) - 1, Bk)  # Bk = dump
    gidx = torch.arange(G, dtype=torch.int32, device=dev)
    tsel = torch.zeros((Q, Bk + 1), dtype=torch.int32, device=dev)
    tsel.scatter_(1, rank, gidx.expand(Q, G).contiguous())
    masked = tile_upper.masked_fill(sel, -float("inf"))
    u_next = masked.amax(dim=1)
    min_unsel = torch.where(masked >= 0, gidx, G).amin(dim=1)
    return tsel[:, :Bk].contiguous(), u_next, min_unsel.int()


def _topk_in_tiles_final(final: torch.Tensor, tsel: torch.Tensor, k: int):
    """(score desc, docid asc) top-k of masked per-tile lanes
    ``final`` [Q, B, LANE] (-1 = no match); REQUIRES ascending ``tsel``.

    The top-k tiles by max score (stable sort: ties toward the lower tile,
    the lower docids), then one lexicographic sort of their k*128 lanes:
    by docid, then a stable descending sort by score, the order of the JAX
    package's two-key ``lax.sort``. Exact: each of k selected tiles holds
    a doc that outranks any doc of an excluded tile."""
    Q, B, _ = final.shape
    kt = min(k, B)
    lane = torch.arange(LANE, device=final.device)
    dgrid = tsel.long()[..., None] * LANE + lane  # [Q, B, LANE]
    _, top = torch.sort(final.amax(dim=-1), dim=1, descending=True,
                        stable=True)
    pick = top[:, :kt, None].expand(Q, kt, LANE)
    cand = torch.gather(final, 1, pick).reshape(Q, kt * LANE)
    cand_docs = torch.gather(dgrid, 1, pick).reshape(Q, kt * LANE)
    cand_docs, by_doc = torch.sort(cand_docs, dim=1)
    cand = torch.gather(cand, 1, by_doc)
    vals, order = torch.sort(cand, dim=1, descending=True, stable=True)
    return vals[:, :k], torch.gather(cand_docs, 1, order[:, :k])


def _pruned_batch_finish(scores, rc, oc, nc, bool_params, tsel, u_next,
                         min_unsel, hits, live_tiles, *, k: int,
                         boolean: bool):
    """Mask, rank and certify the rescored tiles: [Q, 2k+2] rows of k
    scores | k docids as f32 | hits | safe (1.0 = proven exact, 0.0 = the
    executor must escalate the query).

    Pure-OR certificate: safe iff theta > u_next (every unselected doc
    scores at most u_next < theta) or u_next <= 0 (no unselected doc
    matches: contributions are nonnegative).

    Boolean certificate. A boolean match may score 0 (FILTER-only
    clauses), so u_next <= 0 proves nothing. Safe iff (a) theta > u_next;
    (b) u_next < 0: every unselected tile is infeasible (bound -1*(1+eps));
    or (c) theta == 0, u_next == 0 and the k-th candidate's tile precedes
    every unselected feasible tile: unselected matches then score exactly
    0 with higher docids than the k-th candidate. (c) relies on ascending
    ``tsel`` and on the selection of the lower index among tied tiles."""
    lv = live_tiles[tsel.long()]
    if boolean:
        nreq = bool_params[:, 0, None, None]
        msm = bool_params[:, 1, None, None]
        mask = ((rc == nreq) & (oc >= msm) & (nc == 0) & ((rc + oc) > 0)
                & (lv > 0))
    else:
        mask = (scores > 0) & (lv > 0)
    final = torch.where(mask, scores, -1.0)
    top_scores, top_docs = _topk_in_tiles_final(final, tsel, k)
    theta = top_scores[:, k - 1]
    if boolean:
        tile_k = top_docs[:, k - 1] // LANE
        safe = ((theta > u_next) | (u_next < 0)
                | ((theta == 0) & (u_next == 0) & (tile_k < min_unsel)))
    else:
        safe = (theta > u_next) | (u_next <= 0)
    return torch.cat([
        top_scores, top_docs.float(), hits.float()[:, None],
        safe.float()[:, None],
    ], dim=1)


def _pruned_batch_phase1(compact_bf16, a_sc_t, a_rq_t, a_sh_t, a_ng_t,
                         params_t, live, *, Bk: int, boolean: bool,
                         a_cb_t=None):
    """Phase 1 and tile selection: (tsel, u_next, min_unsel, hits). B5
    when the batch has the combined indicator, else B4 for booleans and B3
    for pure-OR batches."""
    G = compact_bf16.shape[1] // LANE
    if boolean and a_cb_t is not None:
        tmax, hits = approx_select_bool2(a_sc_t, a_cb_t, compact_bf16,
                                         params_t, live)
    elif boolean:
        tmax, hits = approx_select_bool(a_sc_t, a_rq_t, a_sh_t, a_ng_t,
                                        compact_bf16, params_t, live)
    else:
        tmax, hits = approx_select(a_sc_t, compact_bf16, live)
    tile_upper = tmax * float(np.float32(1.0) + _APPROX_RELEPS)
    tsel, u_next, min_unsel = _select_tiles(tile_upper, Bk, G)
    return tsel, u_next, min_unsel, hits


def _use_union(Q: int, Tq: int, B: int) -> bool:
    """The JAX package's phase-2 kernel choice: the union rescore (B7) for
    batches of 64+ queries with at most 8 clauses, where tiles repeat across
    queries and the per-pair work is small; B6 otherwise. Q is the unpadded
    batch here, the Q-bucket there (the two differ only for 57-63 queries,
    and both kernels give the same results)."""
    return Q >= 64 and Tq <= 8 and union_rescore_supported(Q, B)


def _pruned_batch_phase2(compact_t, cidx, cflags, live, tsel, u_next,
                         min_unsel, hits, bool_params, *, k: int,
                         boolean: bool):
    """Phase 2 (B7 or B6, ``_use_union``) and the certificates."""
    G = compact_t.shape[0]
    live_tiles = live.reshape(G, LANE)
    rescore = (union_rescore if _use_union(*cidx.shape, tsel.shape[1])
               else gather_rescore)
    if boolean:
        scores, rc, oc, nc = rescore(compact_t, cidx, tsel, cflags)
    else:
        scores = rescore(compact_t, cidx, tsel)
        rc = oc = nc = None
    return _pruned_batch_finish(
        scores, rc, oc, nc, bool_params, tsel, u_next, min_unsel, hits,
        live_tiles, k=k, boolean=boolean,
    )


def row_score_topk_pruned_batch(
    compact_t,  # f32 [G, U8, LANE] batch-compact tile-major bank (exact)
    compact_bf16,  # bf16 [U8, D] approx copy (phase 1)
    cidx,  # i32 [Q, Tq] compact row per clause (0 = zero row)
    cflags,  # i32 [Q, Tq] bit0 scoring / 1 req / 2 sho / 3 neg
    live,  # f32 [D]
    a_sc_t,  # bf16 [U8, Q] scoring-clause indicator (transposed)
    a_rq_t,  # bf16 [U8, Q]
    a_sh_t,  # bf16 [U8, Q]
    a_ng_t,  # bf16 [U8, Q]
    params_t,  # f32 [8, Q] rows 0 = num_required, 1 = min_should
    bool_params,  # f32 [Q, 2]
    *,
    k: int,
    B: int,
    boolean: bool,
    a_cb_t=None,
    p1_cache: Optional[dict] = None,
):
    """Pruned scoring of a query batch against its compact bank: phase 1,
    tile selection, phase 2 and the certificates, one eager pipeline (the
    JAX package's staged/fused program split is an XLA temp-plan measure).
    Returns [Q, 2k+2] rows (see ``_pruned_batch_finish``).

    ``p1_cache`` ({Bk: (tsel, u_next, min_unsel, hits)}, the entry's): phase
    1 and the selection are a pure function of the batch's plans, bank,
    live docs and Bk, so a re-issued identical batch replays them and runs
    only phase 2 (the JAX package's staged branch; None: no replay)."""
    G = compact_t.shape[0]
    Bk = min(B, G)
    p1 = p1_cache.get(Bk) if p1_cache is not None else None
    if p1 is None:
        p1 = _pruned_batch_phase1(
            compact_bf16, a_sc_t, a_rq_t, a_sh_t, a_ng_t, params_t, live,
            Bk=Bk, boolean=boolean, a_cb_t=a_cb_t,
        )
        if p1_cache is not None:
            p1_cache[Bk] = p1
    tsel, u_next, min_unsel, hits = p1
    return _pruned_batch_phase2(
        compact_t, cidx, cflags, live, tsel, u_next, min_unsel, hits,
        bool_params, k=k, boolean=boolean,
    )


def _ubank_from_tiles(compact_t: torch.Tensor) -> torch.Tensor:
    """[G, U8, LANE] tile-major bank -> [U8, G] per-row tile maxima."""
    return compact_t.amax(dim=2).T.contiguous()


def _build_bits_bank(compact_t: torch.Tensor, live: torch.Tensor):
    """Presence bitmaps i32 [U8, G*4] (u32 bit patterns) of a tile-major
    bank: bit d % 32 of word d // 32 is set where the row is > 0 and doc d
    is live (d = g * LANE + l -> word g * 4 + l // 32). Built in tile
    chunks so the int64 packing temporary stays near 256 MB."""
    G, U8, _ = compact_t.shape
    dev = compact_t.device
    live_tiles = live.reshape(G, LANE) > 0
    bits = torch.empty((U8, G * 4), dtype=torch.int32, device=dev)
    step = max(256, (1 << 25) // max(U8 * LANE, 1))
    for g0 in range(0, G, step):
        sl = compact_t[g0 : g0 + step]
        rows = sl.shape[0]
        w = _pack_words((sl > 0) & live_tiles[g0 : g0 + rows, None, :])
        bits[:, g0 * 4 : (g0 + rows) * 4] = (
            w.permute(1, 0, 2).reshape(U8, rows * 4))
    return bits


def _pack_words(m: torch.Tensor) -> torch.Tensor:
    """bool [..., 32 n] -> i32 [..., n]: bit j of word w is element
    w * 32 + j, held as the u32 word's int32 bit pattern (torch has no
    uint32 shifts: the words are summed as int64 and wrapped)."""
    shifts = torch.arange(32, dtype=torch.int64, device=m.device)
    w = (m.reshape(*m.shape[:-1], -1, 32).long() << shifts).sum(dim=-1)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).int()


# ---------------------------------------------------------------------------
# Small-batch tile-UB route
# ---------------------------------------------------------------------------
#
# Pure-OR batches of fewer than approx_min_q plans on segments below
# batch_only_min_docs (the JAX package's ``row_score_topk_pruned_or``):
# each query's tile upper bounds are the sums of its clause rows' tile
# maxima (one [G] row a clause, no pass over the bank), its exact hit count
# the popcount of the live-masked union of its clause rows' presence
# bitmaps; the best Bk tiles are rescored exactly in clause order and
# ranked, and the certificate (theta > u_next, or u_next <= 0) sends a
# query whose top-k may lie outside them back to the exhaustive route in
# ``RowExecutor.finalize``. Torch ops: the JAX package has no Pallas kernel
# here, only jitted ``jnp``, and ``vmap`` over the queries becomes a batch
# axis. Clause rows are added one clause at a time in clause order (the
# ``lax.scan``), so the sums are the exhaustive kernel's bit for bit.


def build_tile_aux(bank: torch.Tensor):
    """Per-row tile maxima and presence bitmaps of a dense row bank: f32
    [N, D] -> (ub f32 [N, D/128], bits i32 [N, D/32]), bit j of word w
    set where the row's doc w * 32 + j is > 0 (the packing of
    ``_pack_live_bits``). Built in row chunks so the int64 packing
    temporary stays near 256 MB."""
    N, D = bank.shape
    ub = torch.empty((N, D // LANE), dtype=torch.float32, device=bank.device)
    bits = torch.empty((N, D // 32), dtype=torch.int32, device=bank.device)
    step = max(1, (1 << 25) // max(1, D))
    for r0 in range(0, N, step):
        rows = bank[r0 : r0 + step]
        ub[r0 : r0 + step] = rows.reshape(rows.shape[0], -1, LANE).amax(-1)
        bits[r0 : r0 + step] = _pack_words(rows > 0)
    return ub, bits


def _pack_live_bits(live: torch.Tensor) -> torch.Tensor:
    """f32 [D] 0/1 -> i32 [D/32] presence bitmap (build_tile_aux's
    packing)."""
    return _pack_words(live > 0)


def _clause_rows(hidx, lidx, heavy, light, light_small: bool, zero):
    """[Q, Tq, ...] clause rows: the heavy row where hidx >= 0, else the
    light row (or ``zero`` when the light bank is its zero row alone)."""
    hmask = (hidx >= 0).reshape(*hidx.shape, *([1] * (heavy.dim() - 1)))
    rows = heavy[hidx.clamp(min=0).long()]
    other = zero if light_small else light[lidx.clamp(min=0).long()]
    return torch.where(hmask, rows, other)


def _bitmap_hits(hidx, lidx, heavy_bits, light_bits, live_bits,
                 light_small: bool):
    """Exact hit counts i32 [Q]: popcount of the live-masked union of each
    query's clause bitmaps (``_bitmap_hits_q`` over the batch)."""
    rows = _clause_rows(hidx, lidx, heavy_bits, light_bits, light_small, 0)
    acc = torch.zeros_like(rows[:, 0])
    for t in range(rows.shape[1]):
        acc |= rows[:, t]
    return _popcount(acc & live_bits).sum(dim=1).int()


def _rescore_tiles(hidx, lidx, tsel, heavy_tiles, light_tiles, G: int,
                   light_small: bool):
    """Exact scores f32 [Q, B, LANE] of the selected tiles, clause rows
    added in clause order (``_rescore_tiles_q`` over the batch)."""
    hi = hidx.clamp(min=0).long()[:, :, None] * G + tsel.long()[:, None, :]
    rows = heavy_tiles[hi]
    if light_small:
        rows = torch.where((hidx >= 0)[:, :, None, None], rows, 0.0)
    else:
        li = lidx.clamp(min=0).long()[:, :, None] * G + tsel.long()[:, None, :]
        rows = torch.where((hidx >= 0)[:, :, None, None], rows,
                           light_tiles[li])
    scores = torch.zeros_like(rows[:, 0])
    for t in range(rows.shape[1]):
        scores += rows[:, t]
    return scores


def row_score_topk_pruned_or(heavy_bank, light_bank, heavy_ub, light_ub,
                             heavy_bits, light_bits, live, live_bits, hidx,
                             lidx, *, k: int, B: int):
    """Pruned pure-OR scoring with sum-of-tile-maxima bounds, the JAX
    function of this name over the batch axis: [Q, 2k+2] rows of k scores
    | k docids as f32 | exact hits | safe (0.0: the executor escalates the
    query).

    heavy_bank f32 [H, D]; light_bank f32 [L, D] (row 0 zero); heavy_ub /
    light_ub f32 [*, D/128] and heavy_bits / light_bits / live_bits i32
    [*, D/32] from ``build_tile_aux`` / ``_pack_live_bits``; live f32 [D];
    hidx, lidx i32 [Q, Tq]. The tile selection is ``_select_tiles``'s (the
    Bk best bounds in IEEE total order, ties toward the lower tile, which
    ``lax.top_k`` gives the JAX package), and the rank stage
    ``_topk_in_tiles_final``'s. A contiguous bank's [H * G, LANE] tile view
    is a view here, not a copy."""
    H, D = heavy_bank.shape
    G = D // LANE
    Bk = min(B, G)
    light_small = light_bank.shape[0] == 1
    ub = torch.zeros((hidx.shape[0], G), dtype=torch.float32,
                     device=heavy_bank.device)
    ub_rows = _clause_rows(hidx, lidx, heavy_ub, light_ub, light_small, 0.0)
    for t in range(ub_rows.shape[1]):
        ub += ub_rows[:, t]
    del ub_rows
    hits = _bitmap_hits(hidx, lidx, heavy_bits, light_bits, live_bits,
                        light_small)
    tsel, u_next, _ = _select_tiles(ub, Bk, G)
    scores = _rescore_tiles(hidx, lidx, tsel, heavy_bank.view(H * G, LANE),
                            light_bank.view(-1, LANE), G, light_small)
    lv = live.reshape(G, LANE)[tsel.long()]
    final = torch.where((scores > 0) & (lv > 0), scores, -1.0)
    top_scores, top_docs = _topk_in_tiles_final(final, tsel, k)
    # u_next is -inf when every tile is selected: always safe
    safe = (top_scores[:, k - 1] > u_next) | (u_next <= 0)
    return torch.cat([
        top_scores, top_docs.float(), hits.float()[:, None],
        safe.float()[:, None],
    ], dim=1)


def _pruned_batch_phase0(ubank, a_sc_f, a_rq_f, a_sh_f, params_t, *,
                         Bk: int, boolean: bool):
    """Tile selection from per-row tile maxima, with no per-doc pass:
    (tsel, u_next, min_unsel) as ``_select_tiles`` gives them.

    tile_upper[q, g] = (sum over q's scoring clauses of the rows' tile
    maxima) * (1 + _APPROX_RELEPS), above the true max score in tile g: the
    true scores are f32 sums of the same row values, and the inflation
    covers the reassociation of the f32 products' sums and the oracle's
    summation order. Boolean tiles missing a required row, or with fewer
    present SHOULD rows than min_should, hold no match and get the phase-1
    infeasible marker -1 * (1 + eps), so the certificates are unchanged. A
    loose bound only ever costs an escalation. The products are plain
    matrix products (the JAX package leaves them to XLA); they must run in
    full f32, since the inflation was derived for f32 sums, so TF32 must be
    off on the card."""
    if ubank.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "phase 0 needs full-f32 products: set "
            "torch.backends.cuda.matmul.allow_tf32 = False"
        )
    G = ubank.shape[1]
    m = float(np.float32(1.0) + _APPROX_RELEPS)
    ub0 = a_sc_f.T @ ubank  # [Q, G]
    if boolean:
        pres = (ubank > 0).float()
        rc = a_rq_f.T @ pres
        oc = a_sh_f.T @ pres
        feasible = ((rc >= params_t[0][:, None])
                    & (oc >= params_t[1][:, None]))
        tile_upper = torch.where(feasible, ub0 * m, -m)
    else:
        tile_upper = ub0 * m
    return _select_tiles(tile_upper, Bk, G)


def _widen(fused: torch.Tensor, k: int) -> torch.Tensor:
    """An exhaustive layout [Q, 2k+1] widened with a safe = 1 column (exact
    by construction), so it concatenates with pruned rows."""
    if fused.shape[-1] != 2 * k + 1:
        return fused
    return torch.cat([fused, fused.new_ones((fused.shape[0], 1))], dim=1)


def _merge_split(f1, f2, inv, k: int):
    """Reassemble a purity-split batch in its original query order."""
    return torch.cat([_widen(f1, k), _widen(f2, k)])[inv]


# ---------------------------------------------------------------------------
# Row-bank build
# ---------------------------------------------------------------------------


class RowFieldIndex:
    """Host + device state producing one field's dense score rows on one
    device: a resident heavy bank, or, at ON_DEMAND_MIN_DOCS padded docs
    and more, heavy rows built per batch (``bank_on_demand``)."""

    # device bytes the dense heavy bank may occupy (top-df rows win); the
    # JAX package's value, kept for parity (ROADMAP: retune per card)
    BANK_BUDGET_BYTES = 6 << 30
    ON_DEMAND_MIN_DOCS = BANK_ON_DEMAND_MIN_DOCS

    def __init__(self, pp, norms: np.ndarray, num_docs_pad: int,
                 live_docs: Optional[np.ndarray], tf_lut_host: np.ndarray,
                 device):
        self.pp = pp
        self.num_docs_pad = num_docs_pad
        self.tf_lut_host = np.asarray(tf_lut_host, np.float32)
        self.F = len(self.tf_lut_host) // 128
        self.norms = norms.astype(np.int64)
        self.device = torch.device(device)

        live = np.zeros(num_docs_pad, dtype=np.float32)
        if live_docs is None:
            live[: len(norms)] = 1.0
        else:
            live[: len(live_docs)] = live_docs.astype(np.float32)
        self.live = torch.from_numpy(live).to(self.device)
        # pruning needs the padded doc axis divisible into 128-doc tiles
        self.prunable = num_docs_pad % LANE == 0
        self.live_bits = _pack_live_bits(self.live) if self.prunable else None

        # filled by build_heavy_bank (idf needs collection stats)
        self.heavy_row_of_term: Optional[np.ndarray] = None
        self.heavy_tid_of_row: Optional[np.ndarray] = None
        self.heavy_weight: Optional[np.ndarray] = None
        self.heavy_bank: Optional[torch.Tensor] = None
        # the heavy bank's tile aux (build_tile_aux), read by the
        # small-batch tile-UB route; None where no resident bank is
        # prunable
        self.heavy_ub: Optional[torch.Tensor] = None
        self.heavy_bits: Optional[torch.Tensor] = None
        self.bank_on_demand = False
        self._decode_state = None

    def device_decode_state(self) -> bank_decode.DecodeTables:
        """The postings' decode tables on the device (B9's inputs), uploaded
        once and shared by the heavy bank and light rows."""
        if self._decode_state is None:
            self._decode_state = bank_decode.decode_tables(
                self.pp, self.norms, self.num_docs_pad, self.tf_lut_host,
                self.device)
        return self._decode_state

    def host_row(self, tid: int, weight: np.float32) -> np.ndarray:
        """Dense f32 score row for one term, decoded on the host with the
        oracle's arithmetic."""
        row = np.zeros(self.num_docs_pad, dtype=np.float32)
        docs, freqs = decode_blocks_numpy(
            self.pp, int(self.pp.block_start[tid]),
            int(self.pp.block_start[tid + 1]))
        if len(docs):
            row[docs] = np.float32(weight) * self.tf_lut_host[
                self.norms[docs] * self.F + np.minimum(freqs, self.F - 1)
            ]
        return row

    def build_rows(self, specs, nrows: int) -> torch.Tensor:
        """f32 [nrows, D] bank with row r = w-scaled score row of tid for
        each (r, tid, w) in ``specs``, decoded on the device; other rows
        zero."""
        return self.decode_rows(
            bank_decode.pack_specs(specs, self.pp.block_start, nrows), nrows)

    def decode_rows(self, specs: np.ndarray, nrows: int) -> torch.Tensor:
        """``build_rows`` from specs already packed by
        ``bank_decode.pack_specs``: one B9 launch on the card."""
        bank = torch.zeros((nrows, self.num_docs_pad), dtype=torch.float32,
                           device=self.device)
        if bank_decode.spec_blocks(specs):
            bank_decode.bank_decode(bank, specs, self.device_decode_state())
        return bank

    def build_heavy_bank(self, idf_of_tid, heavy_tids=None) -> None:
        """Classify the frequent terms and materialize their device rows,
        or, on an on-demand segment, only classify them: batches build the
        rows they use (``build_rows_grouped``), and no bank budget caps the
        heavy set.

        idf_of_tid: callable tid -> np.float32 collection-level idf.
        heavy_tids: an explicit term-id list, row j holding heavy_tids[j]
        (the sharded searcher passes a globally aligned heavy set, so bank
        rows line up across shards). A tid of -1 is a term heavy elsewhere
        and absent here: a zero row of weight 0.0 that no term maps to.
        The bank is then always resident and never capped."""
        df = self.pp.doc_freq
        if heavy_tids is not None:
            self.bank_on_demand = False
            heavy = np.asarray(heavy_tids, dtype=np.int64)
        else:
            self.bank_on_demand = (self.prunable and self.num_docs_pad
                                   >= self.ON_DEMAND_MIN_DOCS)
            threshold = max(HEAVY_MIN_DF, self.num_docs_pad // HEAVY_FRACTION)
            heavy = np.nonzero(df >= threshold)[0]
            max_rows = max(1, int(self.BANK_BUDGET_BYTES
                                  // (4 * self.num_docs_pad)))
            if not self.bank_on_demand and len(heavy) > max_rows:
                order = np.argsort(df[heavy], kind="stable")[::-1]
                heavy = np.sort(heavy[order[:max_rows]])
        H = len(heavy)
        present = heavy >= 0
        self.heavy_row_of_term = np.full(self.pp.num_terms, -1, dtype=np.int32)
        self.heavy_row_of_term[heavy[present]] = np.nonzero(present)[0].astype(
            np.int32)
        self.heavy_tid_of_row = heavy.astype(np.int64)
        self.heavy_weight = np.asarray(
            [idf_of_tid(int(t)) if t >= 0 else 0.0 for t in heavy],
            dtype=np.float32,
        )
        if self.bank_on_demand:
            self.heavy_bank = self.heavy_ub = self.heavy_bits = None
            return
        self.set_heavy_bank(self.build_rows(
            [(r, int(t), self.heavy_weight[r])
             for r, t in enumerate(heavy) if t >= 0],
            max(1, H),
        ))

    def set_heavy_bank(self, bank: torch.Tensor) -> None:
        """Hold ``bank`` as the resident heavy bank, with its tile aux
        when the segment is prunable (the JAX package builds both in
        ``build_heavy_bank``)."""
        self.heavy_bank = bank
        self.heavy_ub = self.heavy_bits = None
        if self.prunable:
            self.heavy_ub, self.heavy_bits = build_tile_aux(bank)

    def build_rows_grouped(self, tids, weights):
        """Yield ``(g0, rows)`` for the given term ids in groups of at most
        ``_ROW_GROUP_ROWS``: ``rows`` is an f32 [n, D] group built by
        ``build_rows``, row j the weights[g0+j]-scaled score row of
        tids[g0+j] (tid < 0: a zero row). The on-demand form of the heavy-bank build: one group
        is the only transient, so a batch's compact bank is assembled
        group by group. Bit-equal to ``host_row`` (same LUT, same single
        IEEE multiply)."""
        R = len(tids)
        for g0 in range(0, R, _ROW_GROUP_ROWS):
            n = min(_ROW_GROUP_ROWS, R - g0)
            specs = [(j, int(tids[g0 + j]), np.float32(weights[g0 + j]))
                     for j in range(n) if tids[g0 + j] >= 0]
            yield g0, self.build_rows(specs, n)


# ---------------------------------------------------------------------------
# Plans + executor
# ---------------------------------------------------------------------------


@dataclass
class RowPlan:
    hidx: np.ndarray  # int32 [Tq_pad]; -1 -> light row
    # one light entry per lidx slot: an np.ndarray is a host-materialized
    # row (range / nested indicators); a (tid, weight) tuple is a term row
    # the executor decodes on the device when it stacks the batch
    light_entries: list
    lidx: np.ndarray  # int32 [Tq_pad]: plan-local light row + 1; 0 = zero row
    scoring: np.ndarray  # bool [Tq_pad]
    req: np.ndarray  # f32 [Tq_pad]
    sho: np.ndarray
    neg: np.ndarray
    num_required: int
    min_should: int
    pure_or: bool = False  # SHOULD-only, minShouldMatch <= 1


@dataclass
class CompactBatch:
    """Batch-compact clause-row bank and remapped plan arrays, built once
    per cached batch entry and read by the pruned route: phase 1 reads the
    bf16 bank, phase 0 (on-demand entries of eligible batches) the tile
    maxima and the presence bitmaps instead, and phase 2 the tile-major
    f32 bank either way."""

    compact_t: torch.Tensor  # f32 [G, U8, LANE] tile-major (exact rescore)
    compact_bf16: Optional[torch.Tensor]  # bf16 [U8, D] (phase 1; None on phase-0 entries)
    cidx: torch.Tensor  # i32 [Q, Tq]
    cflags: torch.Tensor  # i32 [Q, Tq]
    a_sc_t: torch.Tensor  # bf16 [U8, Q]
    a_rq_t: torch.Tensor
    a_sh_t: torch.Tensor
    a_ng_t: torch.Tensor
    # combined rq*256 + sh indicator for B5; None when the batch has
    # MUST_NOT clauses, a (row, query) pair serves both roles, or rq >= 256
    # (mixed digits are not bf16-exact)
    a_cb_t: Optional[torch.Tensor]
    params_t: torch.Tensor  # f32 [8, Q]
    nbytes: int
    # phase-1 replay cache {Bk: (tsel, u_next, min_unsel, hits)}, the
    # LRUQueryCache role: filled and read only where the executor allows
    # it (query_cache, at batch_only_min_docs and more)
    p1_cache: dict = field(default_factory=dict)
    # phase-0 state (on-demand entries of min_should <= 1 batches only)
    ubank: Optional[torch.Tensor] = None  # f32 [U8, G] per-row tile maxima
    bits: Optional[torch.Tensor] = None  # i32 [U8, G*4] presence bitmaps
    qmode: Optional[torch.Tensor] = None  # i32 [Q] bits_hits MODE_* words
    a_sc_f: Optional[torch.Tensor] = None  # f32 [U8, Q] (phase-0 products)
    a_rq_f: Optional[torch.Tensor] = None
    a_sh_f: Optional[torch.Tensor] = None


@dataclass
class _BatchEntry:
    """One cached batch: its plans (pinned, so their ids stay unique while
    the entry is cached), the device arguments of exhaustive scoring, the
    host arrays a compact bank is built from, and that bank once the pruned
    route has asked for it (``RowExecutor._compact``)."""

    plans: list
    args: tuple  # hidx, lidx, scoring, req, sho, neg, bool_params, light bank
    host: tuple  # hidx, lidx, sc, rq, sh, ng (numpy [Q, Tq]), light rows used
    nbytes: int
    compact: Optional[CompactBatch] = None
    compact_built: bool = False
    # the light bank's tile aux (ub, bits), once the tile-UB route has
    # asked for it (``RowExecutor._light_aux``)
    light_aux: Optional[tuple] = None


def _plan_row_keys(p: RowPlan) -> set:
    keys = {int(h) for h in p.hidx if h >= 0}
    for e in p.light_entries:
        keys.add(_light_key(e))
    return keys


def _light_key(e) -> tuple:
    return ("t", int(e[0]), float(e[1])) if isinstance(e, tuple) else ("h", id(e))


class RowExecutor:
    """Scores batches of RowPlans for one field of one segment."""

    # device bytes the batch-entry LRU may hold; the JAX package's value,
    # kept for parity (ROADMAP: retune from torch.cuda.mem_get_info)
    BATCH_CACHE_BUDGET = 5 << 30
    # query-chunk bound of exhaustive scoring and of escalation: the
    # [Q, D] f32 accumulators (x4 for booleans) of one launch stay under
    # this many bytes
    EXHAUSTIVE_CHUNK_BYTES = 512 << 20
    # compact banks beyond this many rows are not built; larger batches
    # are partitioned into query groups under the cap (_partition_plans).
    # A TPU VMEM limit in the JAX package, kept for parity
    COMPACT_MAX_ROWS = 512
    # device bytes one group's banks may occupy (~10 bytes/doc/row)
    COMPACT_GROUP_BYTES = 2 << 30
    # on-demand segments: the entry LRU's budget (the compact entries own
    # the card's memory there; the split mixed entries and the or20 entry
    # must all stay cached at 10M docs) and the bytes of one group's banks
    # (5 bytes/doc/row for phase-0 entries, 7 for phase-1 ones). The JAX
    # package's values, kept for parity (ROADMAP: retune per card)
    ON_DEMAND_CACHE_BUDGET = 7 << 30
    ON_DEMAND_GROUP_BYTES = 4 << 30

    # pruning knobs at the JAX package's values (instance-overridable;
    # tests force small ones)
    prune_min_docs: int = PRUNE_MIN_DOCS
    prune_B0: int = PRUNE_B0
    # batches at least this large prune through the phase-1 product
    approx_min_q: int = 8
    # below this segment size, batches smaller than approx_min_q stay
    # exhaustive
    prune_solo_min_docs: int = 1 << 18
    # segments at least this large take the batch route for every pure-OR
    # batch, and replay phase 1 from the entry's cache
    batch_only_min_docs: int = 4 << 20
    # on-demand batches whose plans all have min_should <= 1 take phase 0
    # (tile maxima + B8) instead of phase 1; off by default, as in the JAX
    # package
    use_phase0: bool = False
    # replay phase 1 when an identical batch is re-issued (at
    # batch_only_min_docs and more); the searcher sets it
    query_cache: bool = True
    # transient: a deduped homogeneous burst routes through the batch
    # route even at sub-batch sizes (set around the dispatch recursion)
    _force_batch: bool = False

    def __init__(self, index: RowFieldIndex):
        self.index = index
        # LRU keyed by plan identity, bounded by device bytes
        self._batch_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._batch_bytes = 0
        # batch-shape decisions cached by plan identity
        self._dedup_cache: dict = {}
        self._split_cache: dict = {}
        self._part_cache: dict = {}
        # on-demand exhaustive banks by plan identity (4 entries)
        self._demand_args_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        # the JAX package's counters under its registry names, in the
        # port's own registry (one process-wide object per name)
        self.metrics = {
            "pruned": registry.counter(
                "search.pruned_dispatches",
                "query batches scored via the pruned (block-max) path",
            ),
            "exhaustive": registry.counter(
                "search.exhaustive_dispatches",
                "query batches scored exhaustively",
            ),
            "escalations": registry.counter(
                "search.escalations",
                "queries re-run exhaustively after a certificate failure",
            ),
            "escalated_plans": registry.counter(
                "search.escalated_plans",
                "distinct plans among the queries a finalize re-ran "
                "exhaustively",
            ),
            "compact_fallbacks": registry.counter(
                "search.compact_fallbacks",
                "batches that could not build a compact bank",
            ),
            "partitions": registry.counter(
                "search.compact_partitions",
                "batches partitioned into vocabulary groups",
            ),
            "tiles": registry.counter(
                "search.tiles_rescored",
                "(query, tile) pairs rescored by the pruned phase 2",
            ),
            "phase0_ineligible": registry.counter(
                "search.phase0_ineligible",
                "on-demand batches routed to phase 1 with use_phase0 set "
                "(a plan has min_should >= 2)",
            ),
            "light_rows": registry.counter(
                "search.light_rows",
                "term rows decoded into batch light banks",
            ),
            "light_blocks": registry.counter(
                "search.light_blocks",
                "posting blocks decoded into batch light banks",
            ),
            "compact_groups": registry.counter(
                "search.compact_groups",
                "query groups of the partitioned batches",
            ),
        }

    def build_plan(self, term_plans, min_should: int, idf_of_tid) -> RowPlan:
        """term_plans: engine.TermPlan list in oracle order. Clauses whose
        weight differs from the bank row's idf, and light terms, get light
        entries."""
        idx = self.index
        n = len(term_plans)
        tq = _bucket_tq(n)
        hidx = np.full(tq, -1, dtype=np.int32)
        lidx = np.zeros(tq, dtype=np.int32)
        scoring = np.zeros(tq, dtype=bool)
        req = np.zeros(tq, dtype=np.float32)
        sho = np.zeros(tq, dtype=np.float32)
        neg = np.zeros(tq, dtype=np.float32)
        light_entries: list = []
        num_required = 0

        for i, tp in enumerate(term_plans):
            if tp.required:
                num_required += 1
            present = tp.term_id >= 0 or tp.host_row is not None
            scoring[i] = (not tp.negated) and tp.weight != 0.0
            req[i] = 1.0 if (tp.required and present) else 0.0
            sho[i] = 1.0 if (tp.should and present) else 0.0
            neg[i] = 1.0 if (tp.negated and present) else 0.0
            if not present:
                continue
            if tp.host_row is not None:
                row = np.zeros(idx.num_docs_pad, dtype=np.float32)
                row[: len(tp.host_row)] = np.asarray(tp.host_row, np.float32)
                light_entries.append(row)
                lidx[i] = len(light_entries)
                continue
            hrow = idx.heavy_row_of_term[tp.term_id]
            # a bank row carries the term's collection idf: usable when
            # the clause scores with that weight, or when only presence
            # matters (FILTER / MUST_NOT)
            bank_ok = hrow >= 0 and (
                (not scoring[i])
                or np.float32(tp.weight) == idf_of_tid(tp.term_id)
            )
            if bank_ok:
                hidx[i] = hrow
            else:
                w = np.float32(tp.weight) if scoring[i] else np.float32(1.0)
                light_entries.append((int(tp.term_id), w))
                lidx[i] = len(light_entries)
        # pure-OR needs "row > 0 iff the clause matches and scores" for
        # every clause, so every plan must be a scoring SHOULD clause
        # (nested A/B pairs break it)
        pure_or = (
            num_required == 0
            and min_should <= 1
            and not any(tp.negated for tp in term_plans)
            and all(tp.should and tp.weight != 0.0 for tp in term_plans)
        )
        return RowPlan(
            hidx, light_entries, lidx, scoring, req, sho, neg,
            num_required, min_should, pure_or,
        )

    def _build_light_bank(self, total, specs, host_rows) -> torch.Tensor:
        """The batch light bank, f32 [total+1, D], row 0 zero: term specs
        (row, tid, weight) decode on the device from the packed stream;
        host rows (range / nested indicators) upload one by one. Span
        ``light``; counters ``search.light_rows``, the term rows decoded,
        and ``search.light_blocks``, their posting blocks."""
        with ProfileScope("light"):
            idx = self.index
            packed = bank_decode.pack_specs(specs, idx.pp.block_start,
                                            total + 1)
            self.metrics["light_rows"].increment(len(specs))
            self.metrics["light_blocks"].increment(
                bank_decode.spec_blocks(packed))
            bank = idx.decode_rows(packed, total + 1)
            for r, arr in host_rows:
                bank[r].copy_(torch.from_numpy(arr))
        return bank

    def _stack(self, plans: Sequence[RowPlan]) -> _BatchEntry:
        """A new batch entry: the padded plan arrays and the batch's deduped
        light bank (its compact bank comes later, from ``_compact``)."""
        tq = _bucket_tq(max(len(p.hidx) for p in plans))

        def pad(get, dtype, fill=0):
            out = np.full((len(plans), tq), fill, dtype=dtype)
            for i, p in enumerate(plans):
                v = get(p)
                out[i, : len(v)] = v
            return out

        # one light bank for the batch, deduped across plans: equal term
        # rows (tid, weight) and identical host-row objects share a row
        lidx = pad(lambda p: p.lidx, np.int32)
        specs = []  # (bank row, tid, weight)
        host_rows = []  # (bank row, np row)
        row_of: dict = {}  # entry key -> shared bank row (1-based)
        for qi, p in enumerate(plans):
            if not p.light_entries:
                continue
            remap = np.zeros(len(p.light_entries) + 1, dtype=np.int32)
            for j, e in enumerate(p.light_entries):
                key = _light_key(e)
                r = row_of.get(key)
                if r is None:
                    r = len(row_of) + 1
                    row_of[key] = r
                    if isinstance(e, tuple):
                        specs.append((r, e[0], e[1]))
                    else:
                        host_rows.append((r, e))
                remap[j + 1] = r
            lidx[qi] = remap[lidx[qi]]
        light_bank = self._build_light_bank(len(row_of), specs, host_rows)
        hidx = pad(lambda p: p.hidx, np.int32, fill=-1)
        sc = pad(lambda p: p.scoring, bool)
        rq = pad(lambda p: p.req, np.float32)
        sh = pad(lambda p: p.sho, np.float32)
        ng = pad(lambda p: p.neg, np.float32)
        dev = self.index.device

        def t(a):
            return torch.from_numpy(a).to(dev)

        params = np.asarray(
            [[p.num_required, p.min_should] for p in plans], np.float32
        )
        return _BatchEntry(
            list(plans),
            (t(hidx), t(lidx), t(sc), t(rq), t(sh), t(ng), t(params),
             light_bank),
            (hidx, lidx, sc, rq, sh, ng, len(row_of)),
            light_bank.numel() * light_bank.element_size(),
        )

    def _build_compact(self, entry: _BatchEntry):
        """CompactBatch: the batch's clause rows compacted into one small
        bank, f32 tile-major for the exact rescore and bf16 row-major for
        phase 1, with per-clause indices remapped, so both pruned phases
        scale with the batch's vocabulary. Row 0 is the zero row; padding
        clauses keep cidx 0. None when the bank would exceed
        COMPACT_MAX_ROWS rows.

        On an on-demand segment the heavy rows are scatter-built from the
        postings group by group, straight into the banks; a phase-0 entry
        (``use_phase0`` and every plan's min_should <= 1) holds no bf16
        bank but the tile maxima and the presence bitmaps."""
        hidx_arr, lidx, sc_arr, rq_arr, sh_arr, ng_arr, n_light = entry.host
        plans, light_bank = entry.plans, entry.args[7]
        idx = self.index
        used = np.unique(hidx_arr[hidx_arr >= 0])
        n_rows = 1 + len(used) + n_light
        if n_rows > self.COMPACT_MAX_ROWS:
            return None
        hpos = np.zeros(int(used.max()) + 1 if len(used) else 1, np.int32)
        hpos[used] = 1 + np.arange(len(used), dtype=np.int32)
        cidx = np.where(
            hidx_arr >= 0,
            hpos[np.maximum(hidx_arr, 0)],
            np.where(lidx > 0, 1 + len(used) + (lidx - 1), 0),
        ).astype(np.int32)
        cflags = (
            sc_arr.astype(np.int32)
            + 2 * (rq_arr > 0).astype(np.int32)
            + 4 * (sh_arr > 0).astype(np.int32)
            + 8 * (ng_arr > 0).astype(np.int32)
        )
        phase0 = (self.use_phase0 and idx.bank_on_demand
                  and all(p.min_should <= 1 for p in plans))
        if idx.bank_on_demand:
            compact_t, compact_bf16 = self._build_banks_on_demand(
                used, light_bank, n_light, -(-n_rows // 8) * 8, phase0)
        else:
            compact_f32 = _assemble_compact(
                idx.heavy_bank, used, light_bank, n_light
            )
            compact_t = _tile_major(compact_f32)
            compact_bf16 = compact_f32.to(torch.bfloat16)
            del compact_f32
        G, U8, _ = compact_t.shape
        D = G * LANE

        # transposed per-role clause-indicator matrices for phase 1
        nq = cidx.shape[0]
        a = {r: np.zeros((U8, nq), np.float32) for r in ("sc", "rq", "sh", "ng")}
        qgrid = np.broadcast_to(np.arange(nq)[:, None], cidx.shape)
        for r, marr in (("sc", sc_arr), ("rq", rq_arr > 0),
                        ("sh", sh_arr > 0), ("ng", ng_arr > 0)):
            m = marr.astype(bool) & (cidx > 0)
            np.add.at(a[r], (cidx[m], qgrid[m]), 1.0)
        params = np.zeros((8, nq), np.float32)
        params[0] = [p.num_required for p in plans]
        params[1] = [p.min_should for p in plans]
        dev = idx.device

        def t(x):
            return torch.from_numpy(x).to(dev)

        def bf16(x):
            return t(x).to(torch.bfloat16)

        a_cb = None
        if (not all(p.pure_or for p in plans) and not a["ng"].any()
                and not ((a["rq"] > 0) & (a["sh"] > 0)).any()
                and a["rq"].max(initial=0) < 256):
            a_cb = bf16(a["rq"] * np.float32(256.0) + a["sh"])
        c = CompactBatch(
            compact_t, compact_bf16, t(cidx), t(cflags),
            bf16(a["sc"]), bf16(a["rq"]), bf16(a["sh"]), bf16(a["ng"]), a_cb,
            t(params),
            U8 * D * 6,  # f32 tile-major + bf16
        )
        if phase0:
            # tile maxima and live presence bitmaps: two bank reads, once
            # per cached entry
            c.ubank = _ubank_from_tiles(compact_t)
            c.bits = _build_bits_bank(compact_t, idx.live)
            qmode = np.zeros(nq, np.int32)
            for qi, p in enumerate(plans):
                if p.num_required > 0:
                    qmode[qi] |= MODE_REQ
                    if int((rq_arr[qi] > 0).sum()) < p.num_required:
                        qmode[qi] |= MODE_DEAD  # an absent required clause
                if p.min_should >= 1 or p.num_required == 0:
                    qmode[qi] |= MODE_SHO
            c.qmode = t(qmode)
            c.a_sc_f, c.a_rq_f, c.a_sh_f = t(a["sc"]), t(a["rq"]), t(a["sh"])
            # f32 tile-major + bitmaps + tile maxima (no bf16 bank)
            c.nbytes = U8 * D * 4 + U8 * (D // 8) + U8 * (D // LANE) * 4
        return c

    def _build_banks_on_demand(self, used, light_bank, n_light: int, U8: int,
                               phase0: bool):
        """The compact banks of an on-demand entry: row 0 zero, the heavy
        rows ``used`` scatter-built from the postings one row group at a
        time and placed straight into the tile-major f32 bank (and the bf16
        bank, phase-1 entries only), then the light rows. Peak residency:
        the banks and one row group."""
        idx = self.index
        D = idx.num_docs_pad
        G = D // LANE
        compact_t = torch.zeros((G, U8, LANE), dtype=torch.float32,
                                device=idx.device)
        compact_bf16 = None if phase0 else torch.zeros(
            (U8, D), dtype=torch.bfloat16, device=idx.device)

        def place(r0, rows):
            n = rows.shape[0]
            compact_t[:, r0 : r0 + n].copy_(
                rows.reshape(n, G, LANE).permute(1, 0, 2))
            if compact_bf16 is not None:
                compact_bf16[r0 : r0 + n].copy_(rows)

        if len(used):
            for g0, rows in idx.build_rows_grouped(
                    idx.heavy_tid_of_row[used], idx.heavy_weight[used]):
                place(1 + g0, rows)
        if n_light:
            place(1 + len(used), light_bank[1 : 1 + n_light])
        return compact_t, compact_bf16

    def _entry(self, plans: Sequence[RowPlan]) -> _BatchEntry:
        ck = tuple(id(p) for p in plans)
        entry = self._batch_cache.get(ck)
        if entry is not None:
            self._batch_cache.move_to_end(ck)
            return entry
        # evict before building, by an estimate that overshoots the real
        # size (light bank + compact banks): over-eviction costs a
        # rebuild, under-eviction costs device memory
        vocab = set()
        for p in plans:
            vocab |= _plan_row_keys(p)
        est = self._entry_estimate(len(vocab))
        budget = self._cache_budget()
        while self._batch_bytes + est > budget and self._batch_cache:
            self._batch_bytes -= self._batch_cache.popitem(last=False)[1].nbytes
        entry = self._stack(plans)
        self._batch_bytes += entry.nbytes
        self._batch_cache[ck] = entry
        self._evict()
        return entry

    def _entry_estimate(self, n_keys: int) -> int:
        """Device bytes a batch entry of ``n_keys`` distinct clause rows is
        taken to need. Bytes per doc and row: on an on-demand segment the
        estimate tracks the real entry closely (f32 tile-major + bf16, or
        the phase-0 banks), so the cached split entries do not evict each
        other; elsewhere it covers the light bank too."""
        if self.index.bank_on_demand:
            per_row = 5 if self.use_phase0 else 7
        else:
            per_row = 12
        return per_row * self.index.num_docs_pad * (n_keys + 9)

    def _cache_budget(self) -> int:
        if self.index.bank_on_demand:
            return self.ON_DEMAND_CACHE_BUDGET
        return self.BATCH_CACHE_BUDGET

    def _evict(self):
        """Drop the least recently used entries until the cache fits its
        budget, never the newest one."""
        budget = self._cache_budget()
        while self._batch_bytes > budget and len(self._batch_cache) > 1:
            self._batch_bytes -= self._batch_cache.popitem(last=False)[1].nbytes

    def _drop_entries_except(self, held: set) -> None:
        """Drop the cached entries whose keys are not in ``held``."""
        for ck in [c for c in self._batch_cache if c not in held]:
            self._batch_bytes -= self._batch_cache.pop(ck).nbytes

    def _compact(self, plans: Sequence[RowPlan]) -> Optional[CompactBatch]:
        """The batch's compact bank (None when too many rows), built on the
        pruned route's first request and cached with the batch entry. The
        JAX package builds it in ``_stack`` for every batch that may prune;
        the port builds it only where it is read, so exhaustive batches and
        escalation chunks never pay for one (same results)."""
        entry = self._entry(plans)
        if not entry.compact_built:
            entry.compact = self._build_compact(entry)
            entry.compact_built = True
            if entry.compact is not None:
                entry.nbytes += entry.compact.nbytes
                self._batch_bytes += entry.compact.nbytes
                self._evict()
        return entry.compact

    def _args(self, plans: Sequence[RowPlan]):
        """The exhaustive kernels' arguments for a batch: on an on-demand
        segment, a bank of just the batch's heavy rows."""
        entry = self._entry(plans)
        hidx, lidx, scoring, req, sho, neg, bool_params, light = entry.args
        heavy = self.index.heavy_bank
        if self.index.bank_on_demand:
            heavy, hidx = self._demand_heavy_args(plans, entry.host[0])
        return (heavy, light, self.index.live, hidx, lidx,
                scoring, req, sho, neg, bool_params)

    def _demand_heavy_args(self, plans: Sequence[RowPlan], hidx: np.ndarray):
        """(bank f32 [max(1, H_b), D], hidx i32 [Q, Tq]): the heavy rows the
        batch uses, scatter-built from the postings in ascending row order,
        and the plans' heavy indices remapped into that bank. Exhaustive
        scoring, counts and escalations read it on an on-demand segment;
        cached by plan identity (4 entries: escalation reruns and repeated
        counts reuse one)."""
        ck = tuple(map(id, plans))
        hit = self._demand_args_cache.get(ck)
        if hit is not None:
            self._demand_args_cache.move_to_end(ck)
            return hit[1]
        idx = self.index
        used = np.unique(hidx[hidx >= 0])
        bank = idx.build_rows(
            [(r, int(idx.heavy_tid_of_row[u]), idx.heavy_weight[u])
             for r, u in enumerate(used)],
            max(1, len(used)),
        )
        hpos = np.zeros(int(used.max()) + 1 if len(used) else 1, np.int32)
        hpos[used] = np.arange(len(used), dtype=np.int32)
        remapped = np.where(hidx >= 0, hpos[np.maximum(hidx, 0)], -1)
        out = (bank, torch.from_numpy(remapped.astype(np.int32)).to(idx.device))
        if len(self._demand_args_cache) >= 4:
            self._demand_args_cache.popitem(last=False)
        # the plans are pinned so the key's ids stay unique while cached
        self._demand_args_cache[ck] = (list(plans), out)
        return out

    # -- routing -----------------------------------------------------------
    def _compact_row_cap(self) -> int:
        D = self.index.num_docs_pad
        if self.index.bank_on_demand:
            per_row = 5 * D if self.use_phase0 else 7 * D
            return min(self.COMPACT_MAX_ROWS,
                       max(32, self.ON_DEMAND_GROUP_BYTES // per_row))
        return min(self.COMPACT_MAX_ROWS,
                   max(32, self.COMPACT_GROUP_BYTES // (10 * D)))

    def _partition_plans(self, plans: Sequence[RowPlan]):
        """(contiguous query groups whose deduped clause-row vocabulary each
        fits the compact cap, the vocabulary size of each group); None
        when the whole batch fits. A plan that alone exceeds the cap gets
        its own group (which then takes the exhaustive fallback)."""
        cap = self._compact_row_cap()
        per_plan = [_plan_row_keys(p) for p in plans]
        # the cap must admit the largest single plan, or a batch of wide
        # queries would shatter into groups that still cannot build a bank
        cap = max(cap, max(len(ks) for ks in per_plan) + 1)
        if len(set().union(*per_plan)) + 1 <= cap:
            return None
        groups, sizes = [], []
        cur: set = set()
        start = 0
        for i, keys in enumerate(per_plan):
            merged = cur | keys
            if cur and len(merged) + 1 > cap:
                groups.append((start, i))
                sizes.append(len(cur))
                start = i
                cur = set(keys)
            else:
                cur = merged
        groups.append((start, len(plans)))
        sizes.append(len(cur))
        return groups, sizes

    def _cached_partition(self, plans: Sequence[RowPlan]):
        """(groups, keep) for a batch, cached by plan identity: its
        partition (None when it needs none), and whether the groups'
        entries together fit the entry cache's budget. When they do not,
        a re-issued batch, which walks its groups in the same order, would
        find each group's entry evicted by the groups after it, so
        ``dispatch`` drops them as each group is done."""
        if len(plans) < 2:
            return None, True
        ck = tuple(id(p) for p in plans)
        hit = self._part_cache.get(ck)
        if hit is not None:
            return hit[1:]
        part = self._partition_plans(plans)
        groups, keep = None, True
        if part is not None:
            groups, sizes = part
            keep = (sum(self._entry_estimate(n) for n in sizes)
                    <= self._cache_budget())
        if len(self._part_cache) > 256:
            self._part_cache.clear()
        self._part_cache[ck] = (list(plans), groups, keep)  # pin plan ids
        return groups, keep

    def _batch_mode(self, plans: Sequence[RowPlan]) -> bool:
        """The JAX package's rule for the compact batch route (in its
        ``_dispatch_pruned``): batches of approx_min_q plans or more, every
        boolean batch, every batch on a segment of batch_only_min_docs or
        more or held on demand, and a deduped burst (``_force_batch``)."""
        idx = self.index
        return (len(plans) >= self.approx_min_q
                or not all(p.pure_or for p in plans)
                or idx.num_docs_pad >= self.batch_only_min_docs
                or idx.bank_on_demand
                or self._force_batch)

    def _use_pruned(self, plans: Sequence[RowPlan]) -> bool:
        """The JAX package's routing: a prunable segment with the heavy
        bank's tile aux (``heavy_ub``) or held on demand, of at least
        prune_min_docs padded docs; below prune_solo_min_docs only batches
        of approx_min_q plans or more. Every pure-OR batch then prunes
        (``_dispatch_pruned`` picks the batch or the tile-UB route);
        general booleans only in batch mode."""
        idx = self.index
        if not (idx.prunable
                and (idx.heavy_ub is not None or idx.bank_on_demand)
                and idx.num_docs_pad >= self.prune_min_docs):
            return False
        if (idx.num_docs_pad < self.prune_solo_min_docs
                and len(plans) < self.approx_min_q):
            return False
        if all(p.pure_or for p in plans):
            return True
        # general booleans prune only in batch mode
        return len(plans) >= self.approx_min_q

    def tile_budget(self, Q: int, k: int) -> int:
        """Candidate tiles per query, B. It grows with the tile count (the
        bound's inflation leaves more tiles near theta); the cap is the JAX
        package's SMEM bound on its [B, Q] prefetch, kept for parity."""
        G = self.index.num_docs_pad // LANE
        smem_cap = max(32, (512 << 10) // (4 * max(Q, 1)))
        return min(G, smem_cap,
                   max(self.prune_B0, -(-k // LANE) + 1, G // 512))

    def _light_aux(self, entry: _BatchEntry):
        """The batch light bank's tile aux for the tile-UB route, built on
        its first request and cached with the entry (the JAX package builds
        it in ``_stack`` for every batch on a prunable resident segment).
        A light bank of its zero row alone is never read there (its
        clauses all take heavy rows): no aux, as the JAX route passes
        zeros for a missing one."""
        if entry.light_aux is None:
            light = entry.args[7]
            if light.shape[0] == 1:
                entry.light_aux = (None, None)
            else:
                entry.light_aux = build_tile_aux(light)
                n = sum(a.numel() * a.element_size()
                        for a in entry.light_aux)
                entry.nbytes += n
                self._batch_bytes += n
                self._evict()
        return entry.light_aux

    def _dispatch_pruned(self, plans: Sequence[RowPlan], k: int):
        """The pruned routes: [Q, 2k+2] rows, or None when a batch-mode
        batch has no compact bank (too many rows), so dispatch() falls back
        to exhaustive scoring. In batch mode (``_batch_mode``) phase-0
        entries take phase 0 and B8, others phase 1, replayed from the
        entry's cache where the JAX package stages its pipeline
        (query_cache, batch_only_min_docs and more). Other pure-OR batches
        take the small-batch tile-UB route (``row_score_topk_pruned_or``)
        over the resident heavy bank and the batch's light bank."""
        idx = self.index
        B = self.tile_budget(len(plans), k)
        if not self._batch_mode(plans):
            entry = self._entry(plans)
            hidx, lidx = entry.args[0], entry.args[1]
            light = entry.args[7]
            light_ub, light_bits = self._light_aux(entry)
            return row_score_topk_pruned_or(
                idx.heavy_bank, light, idx.heavy_ub, light_ub,
                idx.heavy_bits, light_bits, idx.live, idx.live_bits,
                hidx, lidx, k=k, B=B,
            )
        c = self._compact(plans)
        if c is None:
            return None
        self.metrics["tiles"].increment(len(plans) * B)
        boolean = not all(p.pure_or for p in plans)
        bool_params = self._entry(plans).args[6]
        if c.ubank is not None:
            # tile_budget caps B at the tile count
            tsel, u_next, min_unsel = _pruned_batch_phase0(
                c.ubank, c.a_sc_f, c.a_rq_f, c.a_sh_f, c.params_t,
                Bk=B, boolean=boolean,
            )
            hits = bits_hits(c.bits, c.cidx, c.cflags, c.qmode)
            return _pruned_batch_phase2(
                c.compact_t, c.cidx, c.cflags, idx.live, tsel, u_next,
                min_unsel, hits, bool_params, k=k, boolean=boolean,
            )
        if self.use_phase0 and idx.bank_on_demand:
            self.metrics["phase0_ineligible"].increment()
        replay = (self.query_cache
                  and idx.num_docs_pad >= self.batch_only_min_docs)
        return row_score_topk_pruned_batch(
            c.compact_t, c.compact_bf16, c.cidx, c.cflags, idx.live,
            c.a_sc_t, c.a_rq_t, c.a_sh_t, c.a_ng_t, c.params_t, bool_params,
            k=k, B=B, boolean=boolean, a_cb_t=c.a_cb_t,
            p1_cache=c.p1_cache if replay else None,
        )

    def _purity_split(self, plans: Sequence[RowPlan]):
        """(pure-OR plans, boolean plans, inverse permutation) for a batch
        that mixes both, cached by plan identity; False otherwise. There
        is no Q-bucket padding, so the inverse uses the unpadded sizes."""
        ck = tuple(map(id, plans))
        sp = self._split_cache.get(ck)
        if sp is None:
            po = np.asarray([p.pure_or for p in plans])
            n_or = int(po.sum())
            sp = False
            if 0 < n_or < len(plans):
                idx_or = np.nonzero(po)[0]
                idx_bool = np.nonzero(~po)[0]
                pos = np.empty(len(plans), np.int64)
                pos[idx_or] = np.arange(n_or)
                pos[idx_bool] = n_or + np.arange(len(idx_bool))
                sp = (
                    [plans[i] for i in idx_or],
                    [plans[i] for i in idx_bool],
                    torch.from_numpy(pos).to(self.index.device),
                )
            if len(self._split_cache) > 128:
                self._split_cache.clear()
            # the key's plan ids stay unique while the searcher's plan
            # caches pin the plans (as in the JAX package)
            self._split_cache[ck] = sp
        return sp

    def dispatch(self, plans: Sequence[RowPlan], k: int) -> torch.Tensor:
        """Fused rows on the device, not synchronised: [Q, 2k+1] from the
        exhaustive route, [Q, 2k+2] (with the safe flag) when any part of
        the batch went through the pruned route; finalize() reads both."""
        # identical-plan dedup: a homogeneous burst (one query fanned
        # across a batch) scores each unique plan once and broadcasts
        if len(plans) > 1:
            ck = tuple(map(id, plans))
            hit = self._dedup_cache.get(ck)
            if hit is None:
                uniq_of: dict = {}
                uniq = []
                for p in plans:
                    if id(p) not in uniq_of:
                        uniq_of[id(p)] = len(uniq)
                        uniq.append(p)
                hit = False
                if len(uniq) < len(plans):
                    take = torch.tensor(
                        [uniq_of[id(p)] for p in plans],
                        dtype=torch.int64, device=self.index.device,
                    )
                    hit = (uniq, take)
                if len(self._dedup_cache) > 128:
                    self._dedup_cache.clear()
                # the key's plan ids stay unique while the searcher's
                # plan caches pin the plans (as in the JAX package)
                self._dedup_cache[ck] = hit
            if hit:
                uniq, take = hit
                # the deduped sub-batch stands for a large batch: route it
                # as one (the JAX package's _force_batch)
                prev = self._force_batch
                self._force_batch = True
                try:
                    fused = self.dispatch(uniq, k)
                finally:
                    self._force_batch = prev
                return fused[take]
        if self._use_pruned(plans):
            # purity split: the pure-OR majority takes the one-product
            # phase 1, only the boolean subset the boolean kernels
            sp = self._purity_split(plans)
            if sp:
                p_or, p_bool, inv = sp
                return _merge_split(self.dispatch(p_or, k),
                                    self.dispatch(p_bool, k), inv, k)
            groups, keep = self._cached_partition(plans)
            if groups is not None:
                self.metrics["partitions"].increment()
                self.metrics["compact_groups"].increment(len(groups))
                parts = []
                for a, b in groups:
                    held = None if keep else set(self._batch_cache)
                    parts.append(_widen(self.dispatch(list(plans[a:b]), k), k))
                    if held is not None:
                        self._drop_entries_except(held)
                return torch.cat(parts)
            fused = self._dispatch_pruned(plans, k)
            if fused is not None:
                self.metrics["pruned"].increment()
                return fused
            self.metrics["compact_fallbacks"].increment()
        self.metrics["exhaustive"].increment()
        return self._exhaustive_chunked(plans, k)

    def _exhaustive_fused(self, plans: Sequence[RowPlan], k: int):
        """One kernel launch for a (chunk of a) batch: B1 when every plan is
        pure-OR, else B2."""
        args = self._args(plans)
        if all(p.pure_or for p in plans):
            return row_score_topk_pure_or_pallas(*args[:5], k=k)
        return row_score_topk_pallas(*args, k=k)

    def _exhaustive_chunked(self, plans: Sequence[RowPlan], k: int):
        """Exhaustive scoring in query chunks that bound the [Q, D]
        accumulators to EXHAUSTIVE_CHUNK_BYTES."""
        D = self.index.num_docs_pad
        per_q = 4 * D * (1 if all(p.pure_or for p in plans) else 4)
        chunk = max(1, self.EXHAUSTIVE_CHUNK_BYTES // per_q)
        if len(plans) <= chunk:
            return self._exhaustive_fused(plans, k)
        return torch.cat([
            self._exhaustive_fused(list(plans[c0 : c0 + chunk]), k)
            for c0 in range(0, len(plans), chunk)
        ])

    def finalize(self, plans: Sequence[RowPlan], fused, k: int):
        """Decode a dispatch() result (tensor or host array) into
        (scores f32 [Q, k], docs i32 [Q, k], hits i32 [Q]); queries whose
        exactness certificate failed are rescored exhaustively (B1/B2), in
        query chunks that bound the [Q, D] accumulators."""
        with ProfileScope("finalize"):
            return self._finalize(plans, fused, k)

    def _finalize(self, plans: Sequence[RowPlan], fused, k: int):
        if isinstance(fused, torch.Tensor):
            with ProfileScope("copy"):
                fused = fused.cpu().numpy()
        if fused.shape[-1] == 2 * k + 1:  # exhaustive layout
            return unfuse_topk(fused, k)
        scores, docs, hits = (a.copy() for a in unfuse_topk(fused, k))
        unsafe = np.nonzero(fused[:, 2 * k + 1] == 0.0)[0]
        if len(unsafe):
            self.metrics["escalations"].increment(len(unsafe))
            self.metrics["escalated_plans"].increment(
                len({id(plans[int(i)]) for i in unsafe}))
            chunk = max(1, self.EXHAUSTIVE_CHUNK_BYTES
                        // (4 * self.index.num_docs_pad))
            with ProfileScope("escalate"):
                for c0 in range(0, len(unsafe), chunk):
                    grp = unsafe[c0 : c0 + chunk]
                    sub = [plans[int(i)] for i in grp]
                    s2, d2, h2 = unfuse_topk(
                        self._exhaustive_fused(sub, k).cpu().numpy(), k
                    )
                    scores[grp] = s2
                    docs[grp] = d2
                    hits[grp] = h2
        return scores, docs, hits

    def top_k_batch(self, plans: Sequence[RowPlan], k: int):
        with ProfileScope("route"):
            fused = self.dispatch(plans, k)
        return self.finalize(plans, fused, k)

    def top_k(self, plan: RowPlan, k: int):
        scores, docs, hits = self.top_k_batch([plan], k)
        return scores[0], docs[0], hits[0]

    def count_batch(self, plans: Sequence[RowPlan]) -> np.ndarray:
        return row_count(*self._args(plans)).cpu().numpy()

    def count(self, plan: RowPlan) -> int:
        return int(self.count_batch([plan])[0])
