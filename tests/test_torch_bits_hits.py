"""Kernel B8's plain version (``bits_hits_reference``, what the wrapper runs
on CPU tensors) against ``pallas_bits_hits`` in interpret mode and a numpy
loop: exact hit counts from presence bitmaps for pure-OR and general
(min_should <= 1) boolean batches. Mirrors ``tests/unit/test_bits_hits.py``;
the CUDA kernel is held against the plain version by the ``cuda`` cases
and by ``chip_smoke.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diagon_tpu.ops.pallas.bits_hits import pallas_bits_hits
from diagon_tpu_torch.ops import launches
from diagon_tpu_torch.ops import bits_hits as bh

REQ, SHO, DEAD = bh.MODE_REQ, bh.MODE_SHO, bh.MODE_DEAD


def test_mode_words_equal_jax():
    from diagon_tpu.ops.pallas import bits_hits as jbh

    assert (REQ, SHO, DEAD) == (jbh.MODE_REQ, jbh.MODE_SHO, jbh.MODE_DEAD)


def _pack_rows(rows_bool):
    """[N, D] bool -> [N, D/32] u32, bit d%32 of word d/32."""
    N, D = rows_bool.shape
    v = rows_bool.astype(np.uint32).reshape(N, D // 32, 32)
    return (v << np.arange(32, dtype=np.uint32)).sum(axis=-1, dtype=np.uint32)


def _numpy_hits(rows_bool, cidx, cflags, qmode):
    out = np.zeros(len(cidx), np.int32)
    for q in range(len(cidx)):
        if qmode[q] & DEAD:
            continue
        D = rows_bool.shape[1]
        band, bor, bneg = np.ones(D, bool), np.zeros(D, bool), np.zeros(D, bool)
        for t in range(cidx.shape[1]):
            row, fl = rows_bool[cidx[q, t]], cflags[q, t]
            band = band & row if fl & 2 else band
            bor = bor | row if fl & 4 else bor
            bneg = bneg | row if fl & 8 else bneg
        m = ~bneg
        if qmode[q] & REQ:
            m &= band
        if qmode[q] & SHO:
            m &= bor
        out[q] = int(m.sum())
    return out


def _batch(seed, Q, U8, Tq, D, density=0.08):
    """Seeded rows and queries in the row engine's contract: kinds cycle
    through pure OR, MUST + SHOULD, MUST + MUST_NOT + SHOULD, FILTER-only,
    SHOULD + MUST_NOT with no required clause, and dead; a padding clause
    (row 0, no flags) closes every query, and random flag mixes keep the
    scoring bit on or off."""
    rng = np.random.Generator(np.random.PCG64(seed))
    rows = rng.random((U8, D)) < density
    rows[0] = False  # row 0 = zero row
    cidx = rng.integers(1, U8, (Q, Tq)).astype(np.int32)
    cflags = np.zeros((Q, Tq), np.int32)
    qmode = np.zeros(Q, np.int32)
    for q in range(Q):
        kind = q % 6
        if kind == 0:  # pure OR
            cflags[q] = 4
            qmode[q] = SHO
        elif kind == 1:  # MUST head + SHOULD tail, min_should 0
            cflags[q, 0] = 2
            cflags[q, 1:] = 4
            qmode[q] = REQ
        elif kind == 2:  # MUST + MUST_NOT + SHOULD, min_should 1
            cflags[q, : max(1, Tq // 4)] = 2
            cflags[q, max(1, Tq // 4)] = 8
            cflags[q, max(1, Tq // 4) + 1 :] = 4
            qmode[q] = REQ | SHO
        elif kind == 3:  # FILTER-only (no scoring bit)
            cflags[q] = 2
            qmode[q] = REQ
        elif kind == 4:  # no required clause: SHOULD + MUST_NOT
            cflags[q] = np.where(rng.random(Tq) < 0.3, 8, 4)
            cflags[q, 0] = 4
            qmode[q] = SHO
        else:  # dead (absent required clause)
            cflags[q] = 4
            qmode[q] = DEAD | SHO
        scoring = (cflags[q] & 6) != 0
        cflags[q] |= (scoring & (rng.random(Tq) < 0.7)).astype(np.int32)
    cidx[:, -1] = 0
    cflags[:, -1] = 0
    return rows, cidx, cflags, qmode


def _torch(bits, cidx, cflags, qmode, device="cpu"):
    return (torch.from_numpy(bits.view(np.int32)).to(device),
            torch.from_numpy(cidx).to(device),
            torch.from_numpy(cflags).to(device),
            torch.from_numpy(qmode).to(device))


SHAPES = [(64, 24, 8, 32 * 128 * 3), (7, 40, 20, 4096), (30, 16, 4, 1024)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_reference_equals_pallas_and_numpy(seed, shape):
    Q, U8, Tq, D = shape
    rows, cidx, cflags, qmode = _batch(seed, Q, U8, Tq, D)
    bits = _pack_rows(rows)
    want = _numpy_hits(rows, cidx, cflags, qmode)
    jax_hits = np.asarray(pallas_bits_hits(
        jnp.asarray(bits), jnp.asarray(cidx), jnp.asarray(cflags),
        jnp.asarray(qmode), interpret=True))
    np.testing.assert_array_equal(jax_hits, want)
    got = bh.bits_hits(*_torch(bits, cidx, cflags, qmode))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[5::6] == 0).all() and want[::6].any()


def test_reference_chunks_equal_one_pass(monkeypatch):
    rows, cidx, cflags, qmode = _batch(5, 50, 24, 8, 4096)
    args = _torch(_pack_rows(rows), cidx, cflags, qmode)
    whole = bh.bits_hits_reference(*args)
    monkeypatch.setattr(bh, "_REFERENCE_CHUNK_WORDS", 3 * 128)
    assert torch.equal(bh.bits_hits_reference(*args), whole)


def test_all_bits_set_counts_every_doc():
    """Sign-bit words: a full row counts 32 docs per word."""
    D = 1024
    rows = np.ones((2, D), bool)
    rows[0] = False
    cidx = np.asarray([[1, 0], [1, 1]], np.int32)
    cflags = np.asarray([[4, 0], [2, 8]], np.int32)
    qmode = np.asarray([SHO, REQ], np.int32)
    got = bh.bits_hits(*_torch(_pack_rows(rows), cidx, cflags, qmode))
    assert got.tolist() == [D, 0]


def test_launch_counter_stays_zero_on_cpu():
    rows, cidx, cflags, qmode = _batch(0, 6, 8, 4, 1024)
    before = launches("bits_hits")
    bh.bits_hits(*_torch(_pack_rows(rows), cidx, cflags, qmode))
    assert launches("bits_hits") == before


def _bad(case):
    rows, cidx, cflags, qmode = _batch(0, 6, 8, 4, 1024)
    bits, ci, cf, qm = _torch(_pack_rows(rows), cidx, cflags, qmode)
    if case == "i64_bits":
        bits = bits.long()
    elif case == "ragged_words":
        bits = bits[:, :30].contiguous()
    elif case == "non_contiguous":
        bits = bits.t().contiguous().t()
    elif case == "flags_shape":
        cf = cf[:, :2].contiguous()
    elif case == "qmode_shape":
        qm = qm[:3]
    elif case == "f32_cidx":
        ci = ci.float()
    return bits, ci, cf, qm


@pytest.mark.parametrize("case", ["i64_bits", "ragged_words", "non_contiguous",
                                  "flags_shape", "qmode_shape", "f32_cidx"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    with pytest.raises((ValueError, TypeError)):
        bh.bits_hits(*_bad(case))


def _role_batch(seed, Q, U8, Tq, D, density=0.6):
    """Seeded rows and queries whose role clauses are all of one role:
    all required, all should, all must_not (no required clause, so SHO),
    scoring only (no role at all), padding only, and dead; each query's
    clause rows drawn from all U8 rows."""
    rng = np.random.Generator(np.random.PCG64(seed))
    rows = rng.random((U8, D)) < density
    rows[0] = False
    cidx = rng.integers(1, U8, (Q, Tq)).astype(np.int32)
    cflags = np.zeros((Q, Tq), np.int32)
    qmode = np.zeros(Q, np.int32)
    for q in range(Q):
        kind = q % 6
        if kind == 0:  # all required (MUST; FILTER where bit0 is off)
            cflags[q] = 2 | (rng.random(Tq) < 0.5)
            qmode[q] = REQ
        elif kind == 1:  # all should
            cflags[q] = 4 | (rng.random(Tq) < 0.5)
            qmode[q] = SHO
        elif kind == 2:  # all must_not: no required clause, no should row
            cflags[q] = 8
            qmode[q] = SHO
        elif kind == 3:  # scoring only: no role
            cflags[q] = 1
            qmode[q] = SHO
        elif kind == 4:  # padding only
            cidx[q] = 0
            qmode[q] = SHO
        else:  # dead
            cflags[q] = 2
            qmode[q] = DEAD | REQ
    return rows, cidx, cflags, qmode


def test_reference_equals_pallas_at_512_rows_on_a_ragged_span():
    """U8 = 512 (COMPACT_MAX_ROWS), a W that is not a whole number of the
    kernel's spans, and queries of one role or none, with a dead one."""
    Q, U8, Tq, D = 24, 512, 6, 1152
    W = D // 32
    V, span, qg, gy = bh.bits_plan(U8, W, Q, Tq, 132)
    assert W % span and W > span
    rows, cidx, cflags, qmode = _role_batch(7, Q, U8, Tq, D)
    bits = _pack_rows(rows)
    want = _numpy_hits(rows, cidx, cflags, qmode)
    jax_hits = np.asarray(pallas_bits_hits(
        jnp.asarray(bits), jnp.asarray(cidx), jnp.asarray(cflags),
        jnp.asarray(qmode), interpret=True))
    np.testing.assert_array_equal(jax_hits, want)
    got = bh.bits_hits(*_torch(bits, cidx, cflags, qmode))
    np.testing.assert_array_equal(got.numpy(), want)
    # all-required and all-should queries match; the rest count nothing
    assert (want[0::6] > 0).all() and (want[1::6] > 0).all()
    assert not want[2::6].any() and not want[3::6].any()
    assert not want[4::6].any() and not want[5::6].any()


def _popcount_np(x):
    return np.unpackbits(x.view(np.uint8)).reshape(x.shape + (32,)).sum(-1)


def _kernel_twin(bits, cidx, cflags, qmode, plan):
    """csrc/bits_hits.cu bits_hits_kernel in numpy at ``plan``: block (x, y)
    stages words [x * span, (x + 1) * span) of every row (zero past W),
    walks the query groups y, y + gy, ... with each query's role clauses
    compacted into lists (roles its mode ignores dropped, nothing for a
    dead query; an odd count of entries from one 32-clause chunk repeats
    its last), folds each list two rows at a time and counts the words
    below W; returns the hits and how many times each (query, word) was
    counted."""
    V, span, qg, gy = plan
    U8, W = bits.shape
    Q, Tq = cidx.shape
    hits = np.zeros(Q, np.int64)
    seen = np.zeros((Q, W), np.int64)
    for x in range(-(-W // span)):
        w0 = x * span
        n = min(span, W - w0)
        staged = np.zeros((U8, span), np.uint32)
        staged[:, :n] = bits[:, w0:w0 + n]
        for y in range(gy):
            for g0 in range(y * qg, Q, gy * qg):
                for q in range(g0, min(g0 + qg, Q)):
                    mode, f, c = qmode[q], cflags[q], cidx[q]
                    if mode & DEAD:
                        continue
                    lists = [[], [], []]
                    for t0 in range(0, Tq, 32):
                        for r, (bit, on) in enumerate(
                                ((2, mode & REQ), (4, mode & SHO), (8, True))):
                            e = [c[t] for t in range(t0, min(Tq, t0 + 32))
                                 if on and f[t] & bit]
                            lists[r] += e + e[-1:] * (len(e) % 2)
                    acc = [np.full(span, 0xFFFFFFFF, np.uint32),
                           np.full(span, 0 if mode & SHO else 0xFFFFFFFF,
                                   np.uint32),
                           np.zeros(span, np.uint32)]
                    for r, e in enumerate(lists):
                        for a, b in zip(e[::2], e[1::2]):
                            pair = (staged[a] & staged[b] if r == 0
                                    else staged[a] | staged[b])
                            acc[r] = acc[r] & pair if r == 0 else acc[r] | pair
                    m = (acc[0] & acc[1] & ~acc[2])[:n]
                    hits[q] += int(_popcount_np(m).sum())
                    seen[q, w0:w0 + n] += 1
    return hits, seen


@pytest.mark.parametrize("U8,Tq,D,sms,seed", [
    (24, 8, 32 * 128 * 3, 1, 0), (40, 20, 4096 * 3, 2, 1),
    (512, 6, 1152, 1, 2), (168, 40, 8192, 3, 3), (7, 70, 2048, 4, 4)])
def test_kernel_twin_equals_reference(U8, Tq, D, sms, seed):
    """The kernel's algorithm at its own plan (few SMs, so several spans
    and query groups split over grid.y) counts every live (query, word)
    once and equals the plain version, for the mixed batch and for queries
    of one role or none; Tq 40 and 70 take the lists past one warp's 32
    clauses."""
    Q = 70
    for batch in (_batch, _role_batch):
        rows, cidx, cflags, qmode = batch(seed, Q, U8, Tq, D)
        bits = _pack_rows(rows)
        plan = bh.bits_plan(U8, D // 32, Q, Tq, sms)
        got, seen = _kernel_twin(bits, cidx, cflags, qmode, plan)
        want = bh.bits_hits(*_torch(bits, cidx, cflags, qmode))
        np.testing.assert_array_equal(got, want.numpy())
        alive = (qmode & DEAD) == 0
        assert (seen[alive] == 1).all() and not seen[~alive].any()


@pytest.mark.parametrize("U8", [40, 168, 512])
@pytest.mark.parametrize("W", [608, 36, 312576])
@pytest.mark.parametrize("Tq", [4, 20, 64])
def test_bits_plan_fits_shared_memory(U8, W, Tq):
    """The plan's span, query group and shared bytes at the phase-0 and
    phase-3b row counts: within a block's 232,448 bytes (two blocks an SM
    where the widest lane fits), a span of whole 32 * V-word columns, and a
    grid.y that leaves no block without a query group."""
    Q = 820
    V, span, qg, gy = bh.bits_plan(U8, W, Q, Tq, 132)
    smem = bh.bits_smem(U8, Tq, span, qg)
    assert smem <= bh.MAX_SMEM
    assert V in (1, 2, 4) and span % (32 * V) == 0 and span >= 32 * V
    assert 1 <= qg <= bh.GROUP and 1 <= gy and (gy - 1) * qg < Q
    if U8 <= 168:
        assert V == 4 and smem <= bh.SMEM_TWO
    blocks = -(-W // span) * gy
    if blocks < 132 * 2:  # few spans: the groups spread over grid.y
        assert gy == min(-(-Q // qg), 132 * 2 // -(-W // span))


def test_bits_plan_at_the_10m_phase0_shape():
    """U8 40, Tq 20, W 312,576 on 132 SMs: four-word lanes, two blocks an
    SM, and the 640-word span whose 489 blocks fill the 264 slots in two
    waves."""
    assert bh.bits_plan(40, 312576, 820, 20, 132) == (4, 640, 64, 1)


def test_bits_plan_refuses_rows_past_shared_memory():
    with pytest.raises(ValueError):
        bh.bits_plan(4096, 312576, 8, 4, 132)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES + [(820, 40, 20, 1 << 20)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_equals_plain_version_on_the_card(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    Q, U8, Tq, D = shape
    rows, cidx, cflags, qmode = _batch(3, Q, U8, Tq, D)
    args = _torch(_pack_rows(rows), cidx, cflags, qmode, "cuda")
    got = bh.bits_hits(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, bh.bits_hits_reference(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(24, 512, 6, 1152), (70, 7, 70, 2048),
                                   (820, 512, 4, 1 << 20)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_equals_plain_on_roles_and_ragged_spans_on_the_card(shape):
    """U8 512 on a ragged last span, clause lists past 32, and queries of
    one role or none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    Q, U8, Tq, D = shape
    for batch in (_batch, _role_batch):
        rows, cidx, cflags, qmode = batch(4, Q, U8, Tq, D)
        args = _torch(_pack_rows(rows), cidx, cflags, qmode, "cuda")
        got = bh.bits_hits(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, bh.bits_hits_reference(*args))
