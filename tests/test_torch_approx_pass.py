"""Phase-1 kernels B3/B4/B5 of diagon_tpu_torch (plain versions on the CPU)
against the JAX package's Pallas kernels in interpret mode: equal hits,
equal tile feasibility, tile maxima within 2^-8 relative (the two sum the
bf16 products in different orders, and B3 rounds its result to bf16)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diagon_tpu.ops.pallas.approx_pass import (
    pallas_approx_select,
    pallas_approx_select_bool,
    pallas_approx_select_bool2,
)
from diagon_tpu_torch.ops import launches
from diagon_tpu_torch.ops import approx_pass as ap

REL = 2.0 ** -8
MUST, FILTER, SHOULD, MUST_NOT = range(4)

# (Q, U8, D): one query, an odd batch, 130 crosses the JAX kernels' query
# block of 128; 8 and 40 compact rows
SHAPES = [(1, 8, 1024), (7, 40, 2048), (130, 8, 1024), (130, 40, 2048)]


def _batch(Q, U8, D, seed, negation=True):
    """Seeded compact bank (row 0 zero, ~70% zeros, dead docs and a dead
    pad), clause rows and roles per query, as the row engine builds them:
    query 0 is FILTER-only (score-0 matches), query 1 all SHOULD."""
    rng = np.random.default_rng(seed + 31 * Q + U8)
    bank = (rng.random((U8, D), dtype=np.float32) * 12
            * (rng.random((U8, D)) < 0.3)).astype(np.float32)
    bank[0] = 0.0
    live = (rng.random(D) < 0.85).astype(np.float32)
    live[D - 200:] = 0.0
    Tq = min(6, U8 - 1)
    cidx = np.stack([rng.choice(np.arange(1, U8), Tq, replace=False)
                     for _ in range(Q)]).astype(np.int32)
    roles = rng.integers(0, 4 if negation else 3, (Q, Tq))
    roles[0] = FILTER
    if Q > 1:
        roles[1] = SHOULD
    cidx[:, -1][rng.random(Q) < 0.3] = 0  # padding clauses on the zero row
    a = {r: np.zeros((U8, Q), np.float32) for r in ("sc", "rq", "sh", "ng")}
    qgrid = np.broadcast_to(np.arange(Q)[:, None], cidx.shape)
    for r, m in (("sc", (roles == MUST) | (roles == SHOULD)),
                 ("rq", (roles == MUST) | (roles == FILTER)),
                 ("sh", roles == SHOULD), ("ng", roles == MUST_NOT)):
        m = m & (cidx > 0)
        np.add.at(a[r], (cidx[m], qgrid[m]), 1.0)
    params = np.zeros((8, Q), np.float32)
    params[0] = a["rq"].sum(axis=0)
    params[1] = np.where(params[0] > 0, 0.0,
                         np.minimum(1 + (np.arange(Q) % 2), a["sh"].sum(axis=0)))
    a["cb"] = a["rq"] * np.float32(256.0) + a["sh"]
    return bank, live, a, params


def _jx(x, bf16=False):
    x = jnp.asarray(x)
    return x.astype(jnp.bfloat16) if bf16 else x


def _th(x, bf16=False):
    x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(torch.bfloat16) if bf16 else x


def _assert_close(got, want, gated):
    (tg, hg), (tw, hw) = got, want
    tg, tw = tg.numpy(), np.asarray(tw)
    np.testing.assert_array_equal(hg.numpy(), np.asarray(hw))
    assert hg.dtype == torch.int32 and tg.shape == tw.shape
    if gated:  # feasibility: -1 exactly where no doc of the tile matches
        np.testing.assert_array_equal(tg == -1.0, tw == -1.0)
    else:
        assert (tg >= 0).all()
    scale = np.maximum(np.abs(tg), np.abs(tw))
    assert (np.abs(tg - tw) <= REL * scale).all(), np.abs(tg - tw).max()


@pytest.mark.parametrize("shape", SHAPES)
def test_approx_select_reference_matches_pallas(shape):
    bank, live, a, _ = _batch(*shape, seed=1)
    want = pallas_approx_select(_jx(a["sc"], True), _jx(bank, True),
                                _jx(live), interpret=True)
    got = ap.approx_select_reference(_th(a["sc"], True), _th(bank, True),
                                     _th(live))
    _assert_close(got, want, gated=False)


@pytest.mark.parametrize("shape", SHAPES)
def test_approx_select_bool_reference_matches_pallas(shape):
    bank, live, a, params = _batch(*shape, seed=2)
    mats = [a[r] for r in ("sc", "rq", "sh", "ng")]
    want = pallas_approx_select_bool(
        *[_jx(m, True) for m in mats], _jx(bank, True), _jx(params),
        _jx(live), interpret=True)
    got = ap.approx_select_bool_reference(
        *[_th(m, True) for m in mats], _th(bank, True), _th(params),
        _th(live))
    _assert_close(got, want, gated=True)
    assert (got[1] > 0).any() and (got[0] == -1).any()


@pytest.mark.parametrize("shape", SHAPES)
def test_approx_select_bool2_reference_matches_pallas(shape):
    bank, live, a, params = _batch(*shape, seed=3, negation=False)
    want = pallas_approx_select_bool2(
        _jx(a["sc"], True), _jx(a["cb"], True), _jx(bank, True),
        _jx(params), _jx(live), interpret=True)
    got = ap.approx_select_bool2_reference(
        _th(a["sc"], True), _th(a["cb"], True), _th(bank, True),
        _th(params), _th(live))
    _assert_close(got, want, gated=True)


def test_bool2_equals_bool_without_negation():
    """The combined count product decodes to the four-product counts."""
    bank, live, a, params = _batch(130, 40, 2048, seed=4, negation=False)
    t = lambda r: _th(a[r], True)  # noqa: E731
    b4 = ap.approx_select_bool_reference(
        t("sc"), t("rq"), t("sh"), t("ng"), _th(bank, True), _th(params),
        _th(live))
    b5 = ap.approx_select_bool2_reference(
        t("sc"), t("cb"), _th(bank, True), _th(params), _th(live))
    assert torch.equal(b4[1], b5[1])
    assert torch.equal(b4[0], b5[0])


def test_bf16_casts_agree_with_jax():
    """torch's and XLA's f32 -> bf16 casts both round to nearest even."""
    rng = np.random.default_rng(5)
    x = (rng.random(1 << 16, dtype=np.float32) * 30).astype(np.float32)
    x[:4] = [0.0, 1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, 3.0e-39]
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    got = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_tile_bound_is_sound():
    """tmax * (1 + 2^-7) dominates the exact f32 tile max of the clause
    sums (summed in clause order, as the oracle does)."""
    Q, U8, D = 7, 40, 2048
    bank, live, a, params = _batch(Q, U8, D, seed=6)
    exact_rows = bank.astype(np.float32)
    got = ap.approx_select_reference(_th(a["sc"], True),
                                     _th(bank.astype(np.float32), True),
                                     _th(live))[0].numpy()
    for q in range(Q):
        rows = np.nonzero(a["sc"][:, q])[0]
        s = np.zeros(D, np.float32)
        for u in rows:
            for _ in range(int(a["sc"][u, q])):
                s = s + exact_rows[u]
        tile = s.reshape(-1, 128).max(axis=1)
        assert (got[q] * (np.float32(1) + np.float32(2.0 ** -7)) >= tile).all()


def test_cpu_wrappers_use_plain_versions_without_launching():
    bank, live, a, params = _batch(7, 8, 1024, seed=7)
    names = ("approx_select", "approx_select_bool", "approx_select_bool2")
    before = tuple(map(launches, names))
    t = lambda r: _th(a[r], True)  # noqa: E731
    b, p, lv = _th(bank, True), _th(params), _th(live)
    pairs = [
        (ap.approx_select(t("sc"), b, lv),
         ap.approx_select_reference(t("sc"), b, lv)),
        (ap.approx_select_bool(t("sc"), t("rq"), t("sh"), t("ng"), b, p, lv),
         ap.approx_select_bool_reference(t("sc"), t("rq"), t("sh"), t("ng"),
                                         b, p, lv)),
        (ap.approx_select_bool2(t("sc"), t("cb"), b, p, lv),
         ap.approx_select_bool2_reference(t("sc"), t("cb"), b, p, lv)),
    ]
    for got, want in pairs:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert before == tuple(map(launches, names))


@pytest.mark.parametrize("case", [
    "float_bank", "u8_not_8", "u8_too_big", "d_not_128", "q_mismatch",
    "params_shape", "live_len",
])
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    U8, Q, D = 8, 3, 1024
    a_t = torch.zeros((U8, Q), dtype=torch.bfloat16)
    bank = torch.zeros((U8, D), dtype=torch.bfloat16)
    live = torch.ones(D)
    params = torch.zeros((8, Q))
    args = dict(a_t=a_t, bank=bank, live=live)
    if case == "float_bank":
        args["bank"] = bank.float()
    elif case == "u8_not_8":
        args["a_t"], args["bank"] = a_t[:7].contiguous(), bank[:7].contiguous()
    elif case == "u8_too_big":
        n = ap.MAX_ROWS + 8
        args["a_t"] = torch.zeros((n, Q), dtype=torch.bfloat16)
        args["bank"] = torch.zeros((n, D), dtype=torch.bfloat16)
    elif case == "d_not_128":
        args["bank"] = torch.zeros((U8, D - 64), dtype=torch.bfloat16)
        args["live"] = torch.ones(D - 64)
    elif case == "live_len":
        args["live"] = torch.ones(D - 128)
    with pytest.raises((ValueError, TypeError)):
        if case == "q_mismatch":
            ap.approx_select_bool2(a_t, a_t[:, :2].contiguous(), bank,
                                   params, live)
        elif case == "params_shape":
            ap.approx_select_bool2(a_t, a_t, bank, params[:, :2].contiguous(),
                                   live)
        else:
            ap.approx_select(args["a_t"], args["bank"], args["live"])


@pytest.mark.parametrize("U8, Q, matrices, rows", [
    (40, 811, 1, 4 * 13 * 3 * 32),    # B3 at the 10M entry: 13 chunks of 64
    (168, 824, 1, 4 * 13 * 11 * 32),
    (40, 213, 2, 2 * 14 * 3 * 32),    # B5 at the 10M entry: 14 fragments
    (152, 200, 2, 2 * 13 * 10 * 32),  # B5 at the 1M mixed batch
    (896, 1, 2, 2 * 1 * 56 * 32),     # MAX_ROWS, one query
    (8, 17, 2, 2 * 2 * 1 * 32),       # U8 below one k-step pads to 16 rows
    (168, 1024, 4, 4 * 64 * 11 * 32),  # B4 at the 19k MUST_NOT batch
    (168, 820, 4, 4 * 52 * 11 * 32),  # ragged Q: 820 = 51 * 16 + 4
    (896, 65, 4, 4 * 5 * 56 * 32),    # MAX_ROWS, one query past a fragment
    (8, 1, 4, 4 * 1 * 1 * 32),        # one query, one k-step
])
def test_packed_indicator_scratch_shape(U8, Q, matrices, rows):
    """One 16-byte row per lane and 16 x 16 fragment: B3 pads the queries
    to its 64-query chunks, B5 packs a_sc then a_cb and B4 a_sc, a_rq,
    a_sh, a_ng in 16-query fragments."""
    pad_q = ap.MMA_CHUNK_Q if matrices == 1 else ap.MMA_FRAG_Q
    assert ap.packed_indicator_shape(U8, Q, matrices, pad_q) == (rows, 4)
    if matrices == 1:
        assert ap.packed_indicator_shape(U8, Q) == (rows, 4)


def _match_range(nreq, msm):
    """csrc/approx_pass.cu match_range in numpy f32: (mid, half) such that
    |cc - mid| <= half is B5's match test on an integer cc."""
    f = np.float32
    nreq, msm = f(nreq), f(msm)
    base = f(256) * nreq
    lo = np.maximum(base + np.maximum(np.ceil(msm), f(0)), f(1))
    hi = base + f(255)
    ok = (nreq >= 0) and (nreq <= 255) and nreq == np.floor(nreq) \
        and not np.isnan(msm)
    return f(0.5) * (lo + hi), (f(0.5) * (hi - lo) if ok else f(-1))


@pytest.mark.parametrize("nreq", [0, 1, 2, 63, 64, 255, 256, 1.5, -1])
@pytest.mark.parametrize("msm", [0, 1, 2, 60, 64, 255, 256, 0.5, -3,
                                 float("inf"), float("nan")])
def test_bool2_range_test_equals_the_decode(nreq, msm):
    """The kernel's one-subtract range test and the plain version's decode
    (rc = floor(cc / 256), oc = cc - 256 rc; rc == nreq, oc >= msm, cc > 0)
    agree on every count the product can reach, and past it."""
    cc = np.arange(0, 65 * 256 + 300, dtype=np.float32)
    rc = np.floor(cc * np.float32(1.0 / 256.0))
    oc = cc - rc * np.float32(256.0)
    with np.errstate(invalid="ignore"):
        want = (rc == np.float32(nreq)) & (oc >= np.float32(msm)) & (cc > 0)
        mid, half = _match_range(nreq, msm)
        got = np.abs(cc - mid) <= half
    np.testing.assert_array_equal(got, want)


# one row in two roles, a count of 2 in one of them: the batches the row
# engine sends to B4 (a_cb cannot hold them)
TWO_ROLES = {
    "must_twice_must_not": (MUST, MUST, MUST_NOT),
    "should_twice_must_not": (SHOULD, SHOULD, MUST_NOT),
    "must_not_twice_should": (MUST_NOT, MUST_NOT, SHOULD),
    "should_twice_must": (SHOULD, SHOULD, MUST),
    "filter_twice_should": (FILTER, FILTER, SHOULD),
}


def _two_role_batch(Q, U8, D, seed, kind):
    """Every query: three clauses on one row in the roles of ``kind``, one
    FILTER row, and SHOULD or MUST_NOT rows; min_should 0, 1 or 2 by query;
    a half-dense bank so that docs match."""
    rng = np.random.default_rng(seed + 31 * Q + U8)
    bank = (rng.random((U8, D), dtype=np.float32) * 12
            * (rng.random((U8, D)) < 0.5)).astype(np.float32)
    bank[0] = 0.0
    live = (rng.random(D) < 0.85).astype(np.float32)
    live[D - 200:] = 0.0
    Tq = 7
    rows = np.stack([rng.choice(np.arange(1, U8), Tq - 2, replace=False)
                     for _ in range(Q)])
    cidx = np.concatenate([rows[:, :1], rows[:, :1], rows], axis=1)
    roles = np.where(rng.random((Q, Tq)) < 0.3, MUST_NOT, SHOULD)
    roles[:, :3] = TWO_ROLES[kind]
    roles[:, 3] = FILTER
    a = {r: np.zeros((U8, Q), np.float32) for r in ("sc", "rq", "sh", "ng")}
    qgrid = np.broadcast_to(np.arange(Q)[:, None], cidx.shape)
    for r, m in (("sc", (roles == MUST) | (roles == SHOULD)),
                 ("rq", (roles == MUST) | (roles == FILTER)),
                 ("sh", roles == SHOULD), ("ng", roles == MUST_NOT)):
        np.add.at(a[r], (cidx[m], qgrid[m]), 1.0)
    params = np.zeros((8, Q), np.float32)
    params[0] = a["rq"].sum(axis=0)
    params[1] = np.arange(Q) % 3
    assert ((a["rq"] > 0) & (a["sh"] > 0)).any() or a["ng"].any()
    return bank, live, a, params


@pytest.mark.parametrize("kind", sorted(TWO_ROLES))
def test_approx_select_bool_reference_matches_pallas_with_rows_in_two_roles(
        kind):
    bank, live, a, params = _two_role_batch(19, 40, 1024, 9, kind)
    mats = [a[r] for r in ("sc", "rq", "sh", "ng")]
    want = pallas_approx_select_bool(
        *[_jx(m, True) for m in mats], _jx(bank, True), _jx(params),
        _jx(live), interpret=True)
    got = ap.approx_select_bool_reference(
        *[_th(m, True) for m in mats], _th(bank, True), _th(params),
        _th(live))
    _assert_close(got, want, gated=True)
    if kind != "must_twice_must_not":  # that one can match no doc
        assert (got[1] > 0).any()


def _match_counts(nreq, msm):
    """csrc/approx_pass.cu match_counts in numpy f32: (nreq, lo) such that
    rc == nreq, oc >= lo, nc == 0 is B4's match test on integer counts."""
    f = np.float32
    nreq, msm = f(nreq), f(msm)
    lo = np.ceil(msm) if not np.isnan(msm) else f(np.inf)
    if nreq == 0:
        lo = np.maximum(lo, f(1))
    return nreq, lo


@pytest.mark.parametrize("nreq", [0, 1, 2, 63, 64, 1.5, -1, float("nan")])
@pytest.mark.parametrize("msm", [0, 1, 2, 60, 64, 0.5, -3, float("inf"),
                                 float("-inf"), float("nan")])
def test_bool_match_test_equals_the_reference(nreq, msm):
    """B4's folded test (match_counts) and the plain version's five-term
    test agree on every count triple up to 70 required and should clauses
    and 2 must_not ones."""
    rc, oc, nc = np.meshgrid(*(np.arange(n, dtype=np.float32)
                               for n in (71, 71, 3)), indexing="ij")
    with np.errstate(invalid="ignore"):
        want = ((rc == np.float32(nreq)) & (oc >= np.float32(msm))
                & (nc == 0) & ((rc + oc) > 0))
        x, lo = _match_counts(nreq, msm)
        got = (rc == x) & (oc >= lo) & (nc == 0)
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(TWO_ROLES))
def test_bool_kernel_matches_plain_with_rows_in_two_roles_on_the_card(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    bank, live, a, params = _two_role_batch(130, 40, 2048, 10, kind)
    args = ([_th(a[r], True).to(dev) for r in ("sc", "rq", "sh", "ng")]
            + [_th(bank, True).to(dev), _th(params).to(dev),
               _th(live).to(dev)])
    got = ap.approx_select_bool(*args)
    want = ap.approx_select_bool_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0] == -1, want[0] == -1)
    scale = torch.maximum(got[0].abs(), want[0].abs())
    assert ((got[0] - want[0]).abs() <= REL * scale).all()


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    bank, live, a, params = _batch(130, 40, 2048, seed=8)
    t = lambda r: _th(a[r], True).to(dev)  # noqa: E731
    b, p, lv = _th(bank, True).to(dev), _th(params).to(dev), _th(live).to(dev)
    for fn, ref, args in (
        (ap.approx_select, ap.approx_select_reference, (t("sc"), b, lv)),
        (ap.approx_select_bool, ap.approx_select_bool_reference,
         (t("sc"), t("rq"), t("sh"), t("ng"), b, p, lv)),
        (ap.approx_select_bool2, ap.approx_select_bool2_reference,
         (t("sc"), t("cb"), b, p, lv)),
    ):
        got, want = fn(*args), ref(*args)
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[0] == -1, want[0] == -1)
        scale = torch.maximum(got[0].abs(), want[0].abs())
        assert ((got[0] - want[0]).abs() <= REL * scale).all()
