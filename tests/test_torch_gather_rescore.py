"""Phase-2 kernels B6 and B7 of diagon_tpu_torch (plain versions on the
CPU) against the JAX package's Pallas gather and union rescores
(interpret mode), bit for bit, in the pure-OR and boolean forms, and
against each other: the two share one contract."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diagon_tpu.ops.pallas.gather_rescore import (
    pallas_gather_rescore,
    pallas_union_rescore,
    union_rescore_supported,
)
from diagon_tpu_torch.ops import launches
from diagon_tpu_torch.ops import gather_rescore as gr

# (G, U8, Q, Tq, B): one query, every tile selected, many queries over
# shared tiles (the union kernel's shape class)
SHAPES = [(8, 8, 1, 4, 3), (6, 16, 5, 9, 6), (24, 16, 64, 5, 8),
          (32, 40, 9, 20, 24), (160, 40, 1, 33, 152)]
# shapes the JAX union kernel takes (8 | Q * B): a wider clause list, the
# routed class (Q >= 64, Tq <= 8) with every tile repeated across queries,
# and a sparse selection (SHAPES[2] is held against it below)
UNION_SHAPES = [(16, 16, 4, 12, 2), (4, 8, 70, 8, 4), (40, 16, 3, 4, 8)]


def _inputs(G, U8, Q, Tq, B, seed=3):
    rng = np.random.default_rng(seed + G * 7 + Q)
    bank = rng.normal(size=(G, U8, 128)).astype(np.float32)
    bank[:, 0, :] = 0.0  # row 0 is the zero row
    bank[bank < 0] = 0.0  # score rows are nonnegative
    cidx = rng.integers(0, U8, (Q, Tq)).astype(np.int32)
    tsel = np.sort(np.stack([rng.choice(G, B, replace=False)
                             for _ in range(Q)]), axis=1).astype(np.int32)
    flags = rng.integers(0, 16, (Q, Tq)).astype(np.int32)
    return bank, cidx, tsel, flags


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _both(shape, boolean):
    bank, cidx, tsel, flags = _inputs(*shape)
    jargs = (jnp.asarray(bank), jnp.asarray(cidx), jnp.asarray(tsel))
    targs = tuple(torch.from_numpy(a) for a in (bank, cidx, tsel))
    fl = flags if boolean else None
    return jargs, targs, fl


@pytest.mark.parametrize("boolean", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_gather_rescore_reference_matches_pallas(shape, boolean):
    jargs, targs, fl = _both(shape, boolean)
    want = pallas_gather_rescore(
        *jargs, None if fl is None else jnp.asarray(fl), interpret=True)
    got = gr.gather_rescore_reference(
        *targs, None if fl is None else torch.from_numpy(fl))
    if not boolean:
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(_bits(x.numpy()), _bits(y))


@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[3]])
def test_gather_rescore_reference_matches_pallas_with_every_flag_bit(shape):
    """The boolean form where every clause carries all four flag bits
    (scoring, required, should and must_not at once)."""
    bank, cidx, tsel, _ = _inputs(*shape)
    flags = np.full(cidx.shape, 15, np.int32)
    want = pallas_gather_rescore(jnp.asarray(bank), jnp.asarray(cidx),
                                 jnp.asarray(tsel), jnp.asarray(flags),
                                 interpret=True)
    got = gr.gather_rescore_reference(
        *(torch.from_numpy(a) for a in (bank, cidx, tsel, flags)))
    assert len(got) == len(want) == 4
    for x, y in zip(got, want):
        np.testing.assert_array_equal(_bits(x.numpy()), _bits(y))
    # the three count lanes see the same rows
    assert torch.equal(got[1], got[2]) and torch.equal(got[1], got[3])


@pytest.mark.parametrize("boolean", [False, True])
def test_gather_rescore_reference_matches_union_rescore(boolean):
    """B6 and the union kernel share one contract: B6's plain version
    equals the JAX union kernel bit for bit on its routed class."""
    jargs, targs, fl = _both(SHAPES[2], boolean)
    want = pallas_union_rescore(
        *jargs, None if fl is None else jnp.asarray(fl), interpret=True)
    got = gr.gather_rescore_reference(
        *targs, None if fl is None else torch.from_numpy(fl))
    if not boolean:
        want, got = (want,), (got,)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(_bits(x.numpy()), _bits(y))


@pytest.mark.parametrize("boolean", [False, True])
@pytest.mark.parametrize("shape", UNION_SHAPES)
def test_union_rescore_reference_matches_pallas(shape, boolean):
    jargs, targs, fl = _both(shape, boolean)
    want = pallas_union_rescore(
        *jargs, None if fl is None else jnp.asarray(fl), interpret=True)
    got = gr.union_rescore_reference(
        *targs, None if fl is None else torch.from_numpy(fl))
    if not boolean:
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(_bits(x.numpy()), _bits(y))


@pytest.mark.parametrize("boolean", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_union_rescore_reference_matches_gather_reference(shape, boolean):
    """B7's plain version equals B6's at every shape, also where the JAX
    union kernel's grid (8 | Q * B) would not take it."""
    _, targs, fl = _both(shape, boolean)
    fl = None if fl is None else torch.from_numpy(fl)
    got = gr.union_rescore_reference(*targs, fl)
    want = gr.gather_rescore_reference(*targs, fl)
    if not boolean:
        got, want = (got,), (want,)
    for x, y in zip(got, want):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


def _shuffled(shape, boolean, seed=11):
    """``_both``'s inputs with each query's tiles out of ascending order and
    drawn from a few hot tiles, so tiles repeat within and across queries."""
    G, U8, Q, Tq, B = shape
    bank, cidx, _, flags = _inputs(*shape)
    rng = np.random.default_rng(seed + Q)
    hot = rng.choice(G, min(G, 3), replace=False)
    tsel = hot[rng.integers(0, len(hot), (Q, B))].astype(np.int32)
    tsel[:, :2] = [G - 1, 0]  # descending where B allows
    tsel = np.ascontiguousarray(tsel[:, :B])
    assert not (np.diff(tsel, axis=1) >= 0).all()
    return bank, cidx, tsel, (flags if boolean else None)


# (G, U8, Q, Tq, B): the JAX union kernel's grid needs 8 | Q * B
SHUFFLED_SHAPES = [(6, 16, 8, 5, 4), (24, 16, 64, 5, 8), (40, 8, 70, 8, 4)]


@pytest.mark.parametrize("boolean", [False, True])
@pytest.mark.parametrize("shape", SHUFFLED_SHAPES)
def test_union_reference_matches_pallas_and_gather_with_tiles_out_of_order(
        shape, boolean):
    """B7 takes no order from tsel: its plain version equals the JAX union
    kernel and B6's plain version bit for bit with each query's tiles
    unsorted and repeated."""
    bank, cidx, tsel, fl = _shuffled(shape, boolean)
    want = pallas_union_rescore(
        jnp.asarray(bank), jnp.asarray(cidx), jnp.asarray(tsel),
        None if fl is None else jnp.asarray(fl), interpret=True)
    targs = tuple(torch.from_numpy(a) for a in (bank, cidx, tsel))
    tfl = None if fl is None else torch.from_numpy(fl)
    got = gr.union_rescore_reference(*targs, tfl)
    b6 = gr.gather_rescore_reference(*targs, tfl)
    if not boolean:
        want, got, b6 = (want,), (got,), (b6,)
    for x, y, z in zip(got, want, b6):
        np.testing.assert_array_equal(_bits(x.numpy()), _bits(y))
        np.testing.assert_array_equal(_bits(z.numpy()), _bits(y))


def _plan_blocks(Q, B, G, Tq, tsel):
    """csrc/gather_rescore.cu union_rescore_kernel's selection in numpy:
    for every block (x, y) of the grid, the flat pairs its warps take."""
    tpb, qpb = gr.union_plan(Q, B, G, Tq)
    gx, gy = -(-G // tpb), -(-Q // qpb)
    flat = tsel.reshape(-1)
    taken = []
    for y in range(gy):
        p0, p1 = y * qpb * B, min(Q, (y + 1) * qpb) * B
        g = flat[p0:p1]
        for x in range(gx):
            mine = (g >= x * tpb) & (g < (x + 1) * tpb)
            taken.append(p0 + np.nonzero(mine)[0])
    return gx, gy, taken, qpb


@pytest.mark.parametrize("Q,B,G,Tq", [(1, 1, 1, 4), (3, 8, 8, 20),
                                      (200, 24, 7840, 4), (1024, 24, 152, 8),
                                      (2048, 32, 78144, 8), (70, 4, 40, 8),
                                      (65, 24, 33, 64), (5000, 3, 64, 100),
                                      (3, 2, 5, 5000)])
def test_union_plan_takes_every_pair_exactly_once(Q, B, G, Tq):
    rng = np.random.default_rng(Q * 31 + G)
    hot = rng.integers(0, G, max(1, G // 50))
    tsel = np.where(rng.random((Q, B)) < 0.5, hot[rng.integers(0, len(hot),
                                                               (Q, B))],
                    rng.integers(0, G, (Q, B))).astype(np.int32)
    gx, gy, taken, qpb = _plan_blocks(Q, B, G, Tq, tsel)
    assert gx <= gr.UNION_RANGES and gy <= gr.MAX_GRID_Y
    assert qpb * Tq <= max(Tq, gr.UNION_STAGED)  # what a block stages
    hits = np.bincount(np.concatenate(taken), minlength=Q * B)
    np.testing.assert_array_equal(hits, np.ones(Q * B, np.int64))


@pytest.mark.parametrize("Q,B,G", [(200, 24, 7840), (1024, 24, 152),
                                   (2048, 32, 78144), (1, 1, 1)])
def test_union_plan_grid(Q, B, G):
    """About UNION_BLOCKS blocks where the batch allows (Tq 8, the routed
    class), and a block scans no more than its slice of the queries'
    pairs."""
    tpb, qpb = gr.union_plan(Q, B, G, 8)
    gx, gy = -(-G // tpb), -(-Q // qpb)
    assert tpb == -(-G // min(G, gr.UNION_RANGES)) and gx <= gr.UNION_RANGES
    assert gy == min(Q, -(-gr.UNION_BLOCKS // gx))
    assert (gy - 1) * qpb < Q <= gy * qpb


def _gather_blocks(Q, B, Tq, sms, boolean):
    """csrc/gather_rescore.cu gather_rescore_kernel's selection in numpy:
    for every block, its pairs (flat q * B + b) by warp, and the queries
    whose clause rows it stages."""
    ppb = gr.gather_plan(Q, B, Tq, sms, boolean)
    P = Q * B
    blocks = -(-P // ppb)
    p0 = np.arange(blocks, dtype=np.int64) * ppb
    n = np.minimum(ppb, P - p0)
    qa = p0 // B
    nq = (p0 + n - 1) // B - qa + 1
    return ppb, blocks, p0, n, qa, nq


@pytest.mark.parametrize("boolean", [False, True])
@pytest.mark.parametrize("Q,B,Tq", [(1, 24, 20), (1, 152, 20), (824, 24, 20),
                                    (811, 152, 20), (200, 24, 4),
                                    (70000, 3, 4), (66000, 24, 8),
                                    (3, 2, 5000)])
def test_gather_plan_takes_every_pair_exactly_once(Q, B, Tq, boolean):
    """Every pair falls in exactly one block's run and is taken by exactly
    one of its warps, whatever Q (no grid.y: the runs are flat), and each
    run's staged query rows hold the queries of its pairs within the
    shared memory the launcher sizes."""
    sms = 132
    ppb, blocks, p0, n, qa, nq = _gather_blocks(Q, B, Tq, sms, boolean)
    assert blocks <= 0x7FFFFFFF and (n >= 1).all()
    nq_max = -(-(ppb - 1) // B) + 1
    assert (nq <= nq_max).all()
    assert gr.gather_smem(ppb, B, Tq, boolean) <= gr.MAX_SMEM
    hits = np.zeros(Q * B, np.int64)
    for w in range(gr.GATHER_WARPS):  # warp w takes i = w, w + 4, ...
        i = np.arange(w, ppb, gr.GATHER_WARPS)
        p = (p0[:, None] + i[None, :])[i[None, :] < n[:, None]]
        np.add.at(hits, p, 1)
        q = p // B
        blk = np.repeat(np.arange(blocks), ((n[:, None] > i[None, :])
                                            .sum(axis=1)))
        assert ((q >= qa[blk]) & (q < qa[blk] + nq[blk])).all()
    np.testing.assert_array_equal(hits, np.ones(Q * B, np.int64))


@pytest.mark.parametrize("Q,B", [(1, 24), (1, 152), (824, 24), (811, 152),
                                 (200, 24), (4096, 16)])
@pytest.mark.parametrize("sms", [132, 114])
def test_gather_plan_grid(Q, B, sms):
    """One wave: the blocks fit GATHER_BLOCKS_PER_SM an SM at once, with as
    few pairs a block as that allows (a pair a block where the batch has
    fewer pairs than the card has block slots)."""
    ppb = gr.gather_plan(Q, B, 20, sms, True)
    blocks = -(-(Q * B) // ppb)
    slots = sms * gr.GATHER_BLOCKS_PER_SM
    assert blocks <= slots
    assert ppb == 1 or -(-(Q * B) // (ppb - 1)) > slots
    if Q * B <= slots:
        assert ppb == 1 and blocks == Q * B


def test_gather_plan_refuses_clause_lists_past_shared_memory():
    with pytest.raises(ValueError):
        gr.gather_plan(1, 24, 40000, 132, True)


@pytest.mark.parametrize("Q,B", [(64, 24), (1024, 24), (2048, 32), (2056, 8),
                                 (4096, 16), (8, 24), (2728, 24), (2000, 40)])
def test_union_rescore_supported_matches_jax(Q, B):
    assert gr.union_rescore_supported(Q, B) == union_rescore_supported(Q, B)


@pytest.mark.parametrize("boolean", [False, True])
def test_union_cpu_wrapper_uses_plain_version_without_launching(boolean):
    _, targs, fl = _both(SHAPES[2], boolean)
    fl = None if fl is None else torch.from_numpy(fl)
    before = launches("union_rescore")
    got = gr.union_rescore(*targs, fl)
    want = gr.union_rescore_reference(*targs, fl)
    if not boolean:
        got, want = (got,), (want,)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert launches("union_rescore") == before


@pytest.mark.parametrize("boolean", [False, True])
def test_cpu_wrapper_uses_plain_version_without_launching(boolean):
    _, targs, fl = _both(SHAPES[1], boolean)
    fl = None if fl is None else torch.from_numpy(fl)
    before = launches("gather_rescore")
    got = gr.gather_rescore(*targs, fl)
    want = gr.gather_rescore_reference(*targs, fl)
    if not boolean:
        got, want = (got,), (want,)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert launches("gather_rescore") == before


@pytest.mark.parametrize("case", ["bank_2d", "lane_64", "tsel_rows",
                                  "flags_shape", "cidx_i64"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    bank = torch.zeros((4, 8, 128))
    cidx = torch.zeros((3, 4), dtype=torch.int32)
    tsel = torch.zeros((3, 2), dtype=torch.int32)
    flags = None
    if case == "bank_2d":
        bank = torch.zeros((32, 128))
    elif case == "lane_64":
        bank = torch.zeros((4, 8, 64))
    elif case == "tsel_rows":
        tsel = torch.zeros((2, 2), dtype=torch.int32)
    elif case == "flags_shape":
        flags = torch.zeros((3, 5), dtype=torch.int32)
    elif case == "cidx_i64":
        cidx = cidx.long()
    with pytest.raises((ValueError, TypeError)):
        gr.gather_rescore(bank, cidx, tsel, flags)
    with pytest.raises((ValueError, TypeError)):
        gr.union_rescore(bank, cidx, tsel, flags)


@pytest.mark.cuda
@pytest.mark.parametrize("boolean", [False, True])
@pytest.mark.parametrize("shape", [SHAPES[3], SHAPES[4], (64, 40, 824, 20, 24),
                                   (8, 16, 300, 40, 3)])
def test_kernel_matches_plain_version_on_the_card(shape, boolean):
    """B6 bit for bit at one query over 152 tiles with 33 clauses, at the
    1M main path's (Q, Tq, B), and with runs that span several queries."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    _, targs, fl = _both(shape, boolean)
    dev = torch.device("cuda")
    targs = tuple(t.to(dev) for t in targs)
    fl = None if fl is None else torch.from_numpy(fl).to(dev)
    got = gr.gather_rescore(*targs, fl)
    want = gr.gather_rescore_reference(*targs, fl)
    torch.cuda.synchronize()
    if not boolean:
        got, want = (got,), (want,)
    for x, y in zip(got, want):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("boolean", [False, True])
@pytest.mark.parametrize("shape", SHUFFLED_SHAPES)
def test_union_kernel_matches_plain_with_tiles_out_of_order_on_the_card(
        shape, boolean):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    arrays = _shuffled(shape, boolean)
    args = [None if a is None else torch.from_numpy(a).to(dev)
            for a in arrays]
    got = gr.union_rescore(*args)
    want = gr.union_rescore_reference(*args)
    b6 = gr.gather_rescore(*args)
    torch.cuda.synchronize()
    if not boolean:
        got, want, b6 = (got,), (want,), (b6,)
    for x, y, z in zip(got, want, b6):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
        assert torch.equal(z.view(torch.int32), y.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("boolean", [False, True])
def test_union_kernel_matches_plain_version_on_the_card(boolean):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    _, targs, fl = _both(SHAPES[2], boolean)
    dev = torch.device("cuda")
    targs = tuple(t.to(dev) for t in targs)
    fl = None if fl is None else torch.from_numpy(fl).to(dev)
    got = gr.union_rescore(*targs, fl)
    want = gr.gather_rescore_reference(*targs, fl)
    torch.cuda.synchronize()
    if not boolean:
        got, want = (got,), (want,)
    for x, y in zip(got, want):
        assert torch.equal(x.view(torch.int32), y.view(torch.int32))
