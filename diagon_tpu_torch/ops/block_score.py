"""The block-at-a-time scorer (X2) and its plain version.

``block_score`` is the port's counterpart of the scoring part of
``diagon_tpu/search/engine.py``'s ``score_and_topk`` and ``count_matches``
(jitted XLA programs over ``ops/bitpack_ops.py``'s decode, with no Pallas
body). For Q plans of B entries (``blocks`` -1 is padding) it decodes every
plan block's 128 lanes from the packed word stream, scores each valid lane
by the BM25 tf table (``contrib = weight * tf_lut[norm * F + min(freq,
F - 1)]``, one rounded multiply), accumulates per doc the score and the
req / sho / neg counts, and applies the boolean and live mask: the final
row is the masked score, -1 where the doc does not match. It returns no
row: the score form gives each tile's first ``min(k, n)`` docs of the row
in ``lax.top_k``'s order (score descending, docid ascending) as
candidates, ``(cand_scores f32 [Q, C], cand_docs i32 [Q, C], hits i32
[Q])``, the tiles' lists one after another (``candidates``); the count
form (``scores=False``, ``count_matches``) gives ``(None, None, hits)``.
The row's top k is ``exact_topk`` over the candidates
(``search/engine.py``): a doc of the row's top k is among its own tile's
top k in the same total order, and the candidates' positions ascend in
docid wherever their scores tie.

On CUDA tensors it launches the hand-written kernels of
``csrc/block_score.cu``; on CPU tensors it runs ``block_score_reference``,
which is also what the kernels are held against on the card. There is no
fallback: a CUDA call launches or raises.

Exactness: a doc's score is ``((0 + c1) + c2) + ...`` in plan order, the
JAX scatter's and the oracle's order. Both versions add run by run, a run
being one clause's entries, every block of one term in order (``run_end``,
from ``build_segment_plan``; ``plan_runs``): a term's postings ascend, so a
run meets each doc at most once and the adds inside it need no order.
"""

from __future__ import annotations

import numpy as np
import torch

from diagon_tpu_torch.ops import _build, launch_counter
from diagon_tpu_torch.ops.bitpack_ops import decode_doc_blocks
from diagon_tpu_torch.ops.row_sum import _sm_count

_LAUNCHES = launch_counter("block_score")

# csrc/block_score.cu: a block owns at most MAX_TILE docs of one query
MAX_TILE = 2048
MIN_TILE = 256
MAX_QUERIES = 65535  # grid.y
H100_SMS = 132  # an H100 SXM's SMs: the CPU path takes the card's tile size
SMALL_CALL_BYTES = 64 << 20  # query_chunk: below this, no memory query


_BLOCK_COLS = ("block_base", "block_count", "block_doc_bits",
               "block_freq_bits", "block_word_off")
_PLAN_COLS = ("weight", "req", "sho", "neg")


def _check(packed, block_base, block_count, block_doc_bits, block_freq_bits,
           block_word_off, norms, tf_lut, live_mask, blocks, run_end,
           weight, req, sho, neg, bool_params, window_words):
    """Raise on anything the kernels do not take; returns (D, B, Q, F)."""
    dev = packed.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"block_score runs on cpu or cuda tensors, not {dev}")
    cols = dict(zip(_BLOCK_COLS, (block_base, block_count, block_doc_bits,
                                  block_freq_bits, block_word_off)))
    plan = dict(zip(_PLAN_COLS, (weight, req, sho, neg)))
    i32 = {"packed": packed, "norms": norms, "blocks": blocks,
           "run_end": run_end, **cols}
    f32 = {"tf_lut": tf_lut, "live_mask": live_mask, "bool_params": bool_params,
           **plan}
    for want, group in ((torch.int32, i32), (torch.float32, f32)):
        for name, t in group.items():
            if t.device != dev:
                raise ValueError(f"{name} is on {t.device}, packed on {dev}")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
            if t.dtype != want:
                raise TypeError(f"{name} must be {want}, got {t.dtype}")
    if blocks.dim() != 2:
        raise ValueError(f"blocks {tuple(blocks.shape)} must be [Q, B]")
    Q, B = blocks.shape
    for name, t in {**plan, "run_end": run_end}.items():
        if tuple(t.shape) != (Q, B):
            raise ValueError(f"{name} {tuple(t.shape)} must be {(Q, B)}")
    if tuple(bool_params.shape) != (Q, 2):
        raise ValueError(f"bool_params {tuple(bool_params.shape)} must be "
                         f"{(Q, 2)}")
    D = norms.shape[0]
    if tuple(live_mask.shape) != (D,):
        raise ValueError(f"live_mask {tuple(live_mask.shape)} must be {(D,)}")
    nb = block_base.shape[0]
    if any(tuple(t.shape) != (nb,) for t in cols.values()):
        raise ValueError("the block columns must be [NB] each")
    F = tf_lut.shape[0] // 128
    if tf_lut.shape[0] != 128 * F or F < 1:
        raise ValueError(f"tf_lut has {tf_lut.shape[0]} values, not 128 * F")
    if min(Q, B, D, packed.shape[0], window_words) < 1:
        raise ValueError(f"empty operand: Q, B, D, W, window = "
                         f"{(Q, B, D, packed.shape[0], window_words)}")
    return D, B, Q, F


def plan_runs(run_end: np.ndarray):
    """[(p0, p1)] entry ranges of one plan row's runs, in plan order: run r
    ends at ``run_end[r]`` and starts where run r - 1 ended; the first end
    that is not past the last one closes the list."""
    runs, p0 = [], 0
    for p1 in np.asarray(run_end).tolist():
        if p1 <= p0:
            break
        runs.append((p0, p1))
        p0 = p1
    return runs


def candidates(D: int, tile: int, k: int) -> int:
    """Candidates a query gets from a tile size: min(k, tile) a tile, the
    last tile's first min(k, n)."""
    tiles = -(-D // tile)
    kk = min(k, tile)
    return (tiles - 1) * kk + min(kk, D - (tiles - 1) * tile)


def block_score_reference(packed, block_base, block_count, block_doc_bits,
                          block_freq_bits, block_word_off, norms, tf_lut,
                          live_mask, blocks, run_end, weight, req, sho, neg,
                          bool_params, window_words: int, scores: bool = True,
                          k: int = None, tile: int = MAX_TILE):
    """Plain PyTorch X2: ``(cand_scores, cand_docs, hits)`` as
    ``block_score`` gives them for tiles of ``tile`` docs. Per query an
    accumulator [D + 1, 4] (score, req, sho, neg; row D takes the invalid
    lanes), one ``index_put_(accumulate=True)`` a run, whose docs are
    unique; the final row, then each tile's stable descending sort."""
    D, B, Q, F = _check(packed, block_base, block_count, block_doc_bits,
                        block_freq_bits, block_word_off, norms, tf_lut,
                        live_mask, blocks, run_end, weight, req, sho, neg,
                        bool_params, window_words)
    _check_form(scores, k, tile)
    dev = packed.device
    run_end_h = run_end.cpu().numpy()
    finals, hits = [], []
    for q in range(Q):
        acc = torch.zeros((D + 1, 4), dtype=torch.float32, device=dev)
        for p0, p1 in plan_runs(run_end_h[q]):
            bsel = blocks[q, p0:p1].long()
            docids, freqs, valid = decode_doc_blocks(
                packed, block_word_off[bsel], block_base[bsel],
                block_count[bsel], block_doc_bits[bsel], block_freq_bits[bsel],
                window_words)
            validf = valid.float()
            cols = [req[q, p0:p1, None] * validf, sho[q, p0:p1, None] * validf,
                    neg[q, p0:p1, None] * validf]
            if scores:
                norm = norms[torch.clamp(docids, 0, D - 1).long()].long()
                tf = tf_lut[norm * F + torch.clamp(freqs, 0, F - 1).long()]
                contrib = torch.where(valid, weight[q, p0:p1, None] * tf, 0.0)
            else:
                contrib = torch.zeros_like(validf)
            payload = torch.stack([contrib, *cols], dim=-1).reshape(-1, 4)
            sidx = torch.where(valid, docids, D).reshape(-1).long()
            acc.index_put_((sidx,), payload, accumulate=True)
        acc = acc[:D]
        mask = ((acc[:, 1] == bool_params[q, 0])
                & (acc[:, 2] >= bool_params[q, 1])
                & (acc[:, 3] == 0)
                & ((acc[:, 1] + acc[:, 2]) > 0)
                & (live_mask > 0))
        if scores:
            finals.append(torch.where(mask, acc[:, 0], -1.0))
        hits.append(mask.sum(dtype=torch.int32))
    hits = torch.stack(hits)
    if not scores:
        return None, None, hits
    # each tile's docs sorted (stable: docid ascending among equal scores);
    # the last tile's padding sorts after its docs and is cut off
    tiles = -(-D // tile)
    final = torch.full((Q, tiles * tile), float("-inf"), device=dev)
    final[:, :D] = torch.stack(finals)
    vals, idx = torch.sort(final.view(Q, tiles, tile), dim=-1,
                           descending=True, stable=True)
    kk = min(k, tile)
    docs = idx[..., :kk] + torch.arange(0, tiles * tile, tile,
                                        device=dev)[:, None]
    n = candidates(D, tile, k)
    return (vals[..., :kk].reshape(Q, -1)[:, :n],
            docs.to(torch.int32).reshape(Q, -1)[:, :n], hits)


def _check_form(scores: bool, k, tile: int):
    if scores and (k is None or k < 1):
        raise ValueError(f"the score form needs k >= 1, got {k}")
    if not 1 <= tile <= MAX_TILE:
        raise ValueError(f"tile {tile} outside [1, {MAX_TILE}]")


def tile_for(D: int, Q: int, sms: int) -> int:
    """Docs a kernel block owns: MAX_TILE where the (tile, query) blocks
    fill the card twice over, else halved down to MIN_TILE until they do
    (a solo query over 19k docs takes 256-doc tiles: 76 blocks)."""
    tile = MAX_TILE
    while tile > MIN_TILE and Q * -(-D // tile) < 2 * sms:
        tile //= 2
    return tile


def block_score(packed, block_base, block_count, block_doc_bits,
                block_freq_bits, block_word_off, norms, tf_lut, live_mask,
                blocks, run_end, weight, req, sho, neg, bool_params,
                window_words: int, scores: bool = True, k: int = None,
                tile: int = None):
    """X2: ``(cand_scores f32 [Q, C], cand_docs i32 [Q, C], hits i32 [Q])``
    for Q plans (``(None, None, hits)`` with ``scores=False``); the
    arguments are those of ``block_score_reference``. ``tile`` defaults to
    ``tile_for`` on the card's SM count (an H100's on the CPU). One launch
    on the current stream, after zeroing hits; nothing waits."""
    D, B, Q, F = _check(packed, block_base, block_count, block_doc_bits,
                        block_freq_bits, block_word_off, norms, tf_lut,
                        live_mask, blocks, run_end, weight, req, sho, neg,
                        bool_params, window_words)
    on_cpu = packed.device.type == "cpu"
    if tile is None:
        tile = tile_for(D, Q, H100_SMS if on_cpu
                        else _sm_count(packed.get_device()))
    _check_form(scores, k, tile)
    if on_cpu:
        return block_score_reference(
            packed, block_base, block_count, block_doc_bits, block_freq_bits,
            block_word_off, norms, tf_lut, live_mask, blocks, run_end, weight,
            req, sho, neg, bool_params, window_words, scores, k, tile)
    if Q > MAX_QUERIES:
        raise ValueError(f"Q ({Q}) above {MAX_QUERIES}: split the batch")
    dev = packed.get_device()
    hits = torch.zeros(Q, dtype=torch.int32, device=packed.device)
    cand_s = cand_d = None
    if scores:
        kk = min(k, tile)
        cand_s = torch.empty((Q, -(-D // tile) * kk), dtype=torch.float32,
                             device=packed.device)
        cand_d = torch.empty(cand_s.shape, dtype=torch.int32,
                             device=packed.device)
    rc = _build.library().diagon_block_score(
        packed.data_ptr(), packed.shape[0], block_base.data_ptr(),
        block_count.data_ptr(), block_doc_bits.data_ptr(),
        block_freq_bits.data_ptr(), block_word_off.data_ptr(),
        norms.data_ptr(), tf_lut.data_ptr(), live_mask.data_ptr(),
        blocks.data_ptr(), run_end.data_ptr(), weight.data_ptr(),
        req.data_ptr(), sho.data_ptr(), neg.data_ptr(), bool_params.data_ptr(),
        None if cand_s is None else cand_s.data_ptr(),
        None if cand_d is None else cand_d.data_ptr(), hits.data_ptr(),
        D, B, Q, F, window_words, tile, k if scores else 0,
        torch._C._cuda_getCurrentRawStream(dev),
    )
    if rc != 0:
        raise RuntimeError(f"diagon_block_score launch failed: cudaError {rc}")
    _LAUNCHES.increment()
    if not scores:
        return None, None, hits
    n = candidates(D, tile, k)
    return cand_s[:, :n], cand_d[:, :n], hits


def query_chunk(D: int, Q: int, k: int, device) -> int:
    """Queries one X2 call takes so that its candidates and the top-k's
    temporaries over them (24 bytes a candidate) fit in half the free
    device memory; a query has at most min(k, MIN_TILE) candidates a
    MIN_TILE docs and at most D + MAX_TILE in all. A call of at most
    SMALL_CALL_BYTES takes every query without asking the driver
    (``mem_get_info`` costs about 0.1 ms of host). All of Q on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return Q
    cands = min(-(-D // MIN_TILE) * min(k, MIN_TILE), D + MAX_TILE)
    per_query = 24 * cands + 4
    if Q * per_query <= SMALL_CALL_BYTES:
        return min(Q, MAX_QUERIES)
    free, _ = torch.cuda.mem_get_info(device)
    return max(1, min(Q, MAX_QUERIES, free // 2 // per_query))
