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
    before = bh.bits_hits.launches
    bh.bits_hits(*_torch(_pack_rows(rows), cidx, cflags, qmode))
    assert bh.bits_hits.launches == before


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
