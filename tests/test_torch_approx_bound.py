"""The phase-1 bound _APPROX_RELEPS = 2^-7 under tensor-core accumulation.

B3 (``approx_select``) sums its bf16 products on the tensor cores, whose f32
accumulator may align a k-group of products to the largest exponent among
them and truncate. This file emulates that accumulator at its worst, in
numpy, on adversarial inputs made from a seed, and holds it to the closed
form of ``diagon_tpu_torch/ops/approx_pass.py``'s docstring:

- bf16(tile max of the emulated sums) * (1 + 2^-7) dominates every doc's
  exact f32 score, summed in clause order as the oracle sums it;
- every doc with a positive term has a positive emulated sum (exact hits);
- the emulated loss stays within the docstring's delta, and the closed
  form stays below 2^-7;
- B5's count product cc = a_cb x presence, a sum of integers below 2^15,
  comes out of that accumulator exactly, so its decode, the feasibility of
  a tile and the hits are exact on the tensor cores;
- B4's three count products (a_rq, a_sh, a_ng x presence) come out of it
  exactly too, also where one row serves two roles, the case B4 exists
  for, and a packed entry such as rq * 256 + sh would not be bf16-exact.
"""

import numpy as np
import pytest

from diagon_tpu_torch.ops.approx_pass import MAX_ROWS, tile_error_bound
from diagon_tpu_torch.search.row_engine import _APPROX_RELEPS

EPS = 2.0 ** -7
DOCS = 128  # one tile


def bf16(x):
    """f32 -> bf16 (round to nearest even) -> f32, as the caller's cast."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def trunc24(x, e):
    """Truncate x >= 0 (f64) to multiples of 2^(e - 23), elementwise."""
    q = np.ldexp(1.0, e - 23)
    return np.floor(x / q) * q


def exponent(x):
    """floor(log2(x)) for x > 0; 0 where x == 0 (unused there)."""
    return np.frexp(x)[1] - 1


def truncating_sum(products, k):
    """The worst accumulator of the docstring over [docs, T] products
    (f64, exact values of f32 products), in groups of k along T: each
    group's terms and the running sum align to their largest exponent and
    truncate to 24 bits there, add exactly, and the sum truncates to 24
    bits."""
    acc = np.zeros(products.shape[0])
    for g0 in range(0, products.shape[1], k):
        terms = np.concatenate([acc[:, None], products[:, g0:g0 + k]], axis=1)
        top = terms.max(axis=1)
        on = top > 0
        e = np.where(on, exponent(np.where(on, top, 1.0)), 0)
        s = trunc24(terms, e[:, None]).sum(axis=1)
        e2 = np.where(s > 0, exponent(np.where(s > 0, s, 1.0)), 0)
        acc = np.where(on, trunc24(s, e2), acc)
    return acc


def clause_order_f32(c, reps):
    """The oracle's score: c[:, t] added reps[t] times, t ascending, in f32
    (the first clause copied)."""
    s = None
    for t in range(c.shape[1]):
        for _ in range(int(reps[t])):
            s = c[:, t].copy() if s is None else (s + c[:, t]).astype(np.float32)
    return s


def adversarial(case, rng, T):
    """(c f32 [DOCS, T] clause contributions, reps int [T] indicator values)."""
    reps = np.ones(T, np.int64)
    if case == "big_then_sub_ulp":
        # one large term, the rest just under its f32 ulp: each truncates
        # to nothing once aligned with the large one, in any group
        big = np.float32(rng.uniform(1.0, 2.0)) * np.float32(2.0 ** rng.integers(-4, 5))
        ulp = np.ldexp(1.0, int(exponent(np.float64(big))) - 23)
        c = np.full((DOCS, T), np.float32(ulp * (1 - 2.0 ** -8)), np.float32)
        c[rng.integers(0, T, DOCS)[:, None] == np.arange(T)] = big
    elif case == "equal":
        c = np.full((DOCS, T), np.float32(rng.uniform(0.5, 12.0)), np.float32)
    elif case == "wide_range":
        c = (rng.uniform(1.0, 2.0, (DOCS, T))
             * 2.0 ** rng.integers(-20, 4, (DOCS, T))).astype(np.float32)
    elif case == "multiplicity":
        c = rng.uniform(0.1, 12.0, (DOCS, T)).astype(np.float32)
        reps = rng.integers(1, 9, T)
    elif case == "sparse_docs":
        c = rng.uniform(0.1, 12.0, (DOCS, T)).astype(np.float32)
        c *= rng.random((DOCS, T)) < 0.05
        c[:8] = 0.0  # docs with no term at all
        reps = rng.integers(1, 4, T)
    else:
        raise ValueError(case)
    return c, reps


CASES = ["big_then_sub_ulp", "equal", "wide_range", "multiplicity",
         "sparse_docs"]


@pytest.mark.parametrize("k", [8, 16, 32])
@pytest.mark.parametrize("T", [20, 168, MAX_ROWS])
@pytest.mark.parametrize("case", CASES)
def test_truncating_accumulator_keeps_the_bound(case, T, k):
    rng = np.random.default_rng([20261016, CASES.index(case), T, k])
    c, reps = adversarial(case, rng, T)
    b = bf16(c).astype(np.float64)
    products = b * reps  # exact: bf16 x small integer
    p = truncating_sum(products, k)
    exact = products.sum(axis=1)  # f64: exact at these magnitudes
    # the loss is within the docstring's delta for this doc's terms
    nnz = (products > 0).sum(axis=1)
    groups = np.array([
        sum(bool((row[g:g + k] > 0).any()) for g in range(0, T, k))
        for row in products])
    delta = (nnz + 2 * groups) * 2.0 ** -23
    assert (p <= exact).all()
    assert (p >= exact * (1 - delta)).all()
    # exact hits: positive iff some term is positive
    np.testing.assert_array_equal(p > 0, (products > 0).any(axis=1))
    # the inflated tile max dominates every doc's oracle score
    tmax = bf16(np.float32(p.max()))
    s = clause_order_f32(c, reps)
    up = np.float32(tmax) * (np.float32(1.0) + np.float32(EPS))
    assert (up >= s).all(), (float(up), float(s.max()))


def test_sub_ulp_terms_really_truncate():
    """The emulation loses what the docstring charges: 895 terms just under
    the ulp of one large term vanish from the sum."""
    products = np.zeros((1, MAX_ROWS))
    products[0, 0] = 1.0
    products[0, 1:] = 2.0 ** -23 * (1 - 2.0 ** -8)
    p = truncating_sum(products, 8)
    assert p[0] == 1.0 and products.sum() > 1.0 + 2.0 ** -14


@pytest.mark.parametrize("k", [1, 8, 16, 32])
def test_closed_form_stays_below_eps(k):
    assert float(_APPROX_RELEPS) == EPS
    mma = tile_error_bound(MAX_ROWS, MAX_ROWS, k)
    ieee = tile_error_bound(MAX_ROWS, MAX_ROWS, k, mma=False)
    assert ieee < mma < 2.0 ** -8 + 2.0 ** -11 < EPS
    if k == 8:
        assert mma < 2.0 ** -7.9



COUNT_LAYOUTS = ["required_first", "ones_first", "interleaved",
                 "multiplicity", "sparse_presence"]


def count_columns(layout, rng):
    """(a_cb values [T], presence [DOCS, T]) at the largest counts the row
    engine admits: 64 required clauses (rq * 256) and 64 should clauses (1),
    in the column order of ``layout``."""
    req = np.full(64, 256.0)
    sho = np.ones(64)
    if layout == "multiplicity":
        # a row required more than once: 2 * 256 and 3 * 256 beside ones
        req = 256.0 * rng.integers(1, 4, 64)
    if layout == "ones_first":
        a_cb = np.concatenate([sho, req])
    elif layout == "interleaved":
        a_cb = np.stack([req, sho], axis=1).ravel()
    else:  # the largest products first, the ones last
        a_cb = np.concatenate([np.sort(req)[::-1], sho])
    density = 0.3 if layout == "sparse_presence" else 0.97
    presence = (rng.random((DOCS, a_cb.size)) < density).astype(np.float64)
    presence[0] = 1.0  # a doc that holds every row: the largest cc
    presence[1] = 0.0  # and one that holds none
    return a_cb, presence


@pytest.mark.parametrize("k", [8, 16, 32])
@pytest.mark.parametrize("layout", COUNT_LAYOUTS)
def test_truncating_accumulator_keeps_integer_counts_exact(layout, k):
    rng = np.random.default_rng([20261016, COUNT_LAYOUTS.index(layout), k])
    a_cb, presence = count_columns(layout, rng)
    np.testing.assert_array_equal(bf16(a_cb), a_cb)  # the indicator is exact
    products = presence * a_cb
    cc = truncating_sum(products, k)
    exact = products.sum(axis=1)
    assert exact.max() < 2.0 ** 15 or layout == "multiplicity"
    assert exact.max() < 2.0 ** 24
    np.testing.assert_array_equal(cc, exact)
    # so the decode is the counts themselves
    rc = np.floor(cc.astype(np.float32) * np.float32(1.0 / 256.0))
    oc = cc.astype(np.float32) - rc * np.float32(256.0)
    is_req = a_cb >= 256.0
    np.testing.assert_array_equal(
        rc, (presence[:, is_req] * (a_cb[is_req] / 256.0)).sum(axis=1))
    np.testing.assert_array_equal(oc, presence[:, ~is_req].sum(axis=1))


def test_fractional_terms_would_not_survive_the_accumulator():
    """What makes the counts exact is that they are integers: the same
    accumulator drops a term below the ulp of a large one."""
    products = np.array([[64.0 * 256.0] + [2.0 ** -10] * 31])
    assert truncating_sum(products, 8)[0] == 64.0 * 256.0 < products.sum()


@pytest.mark.parametrize("rq", [1, 2, 3, 64, 127, 128, 255])
def test_bf16_holds_every_combined_count_entry(rq):
    """a_cb entries are rq * 256 (rq < 256) or sh (< 256): 8 significant
    bits, which bf16 has."""
    vals = np.array([rq, rq * 256.0], np.float32)
    np.testing.assert_array_equal(bf16(vals), vals)


TWO_ROLE_LAYOUTS = ["must_and_must_not", "should_and_must_not",
                    "must_and_should", "every_role_twice", "sparse_presence"]


def role_columns(layout, rng, T=128):
    """(a_rq, a_sh, a_ng values [T], presence [DOCS, T]) for T compact rows
    of one query at the largest counts the row engine sends to B4: every
    row holds one role or two, with multiplicities up to 3 in a role."""
    counts = rng.integers(1, 4, (3, T)).astype(np.float64)
    on = {
        "must_and_must_not": ([True, False, True], [True, False, False]),
        "should_and_must_not": ([False, True, True], [False, True, False]),
        "must_and_should": ([True, True, False], [True, False, False]),
        "every_role_twice": ([True, True, True], [True, True, False]),
        "sparse_presence": ([True, True, True], [False, True, True]),
    }[layout]
    # even rows take the first role set, odd rows the second
    roles = np.where(np.arange(T)[None, :] % 2 == 0,
                     np.asarray(on[0])[:, None], np.asarray(on[1])[:, None])
    a_rq, a_sh, a_ng = counts * roles
    density = 0.3 if layout == "sparse_presence" else 0.97
    presence = (rng.random((DOCS, T)) < density).astype(np.float64)
    presence[0] = 1.0  # a doc that holds every row: the largest counts
    presence[1] = 0.0  # and one that holds none
    return (a_rq, a_sh, a_ng), presence


@pytest.mark.parametrize("k", [8, 16, 32])
@pytest.mark.parametrize("layout", TWO_ROLE_LAYOUTS)
def test_truncating_accumulator_keeps_separate_counts_exact(layout, k):
    """B4's counts are three products from one presence tile; each is a sum
    of integers, exact whatever rows share roles."""
    rng = np.random.default_rng([20261017, TWO_ROLE_LAYOUTS.index(layout), k])
    mats, presence = role_columns(layout, rng)
    two = np.sum([m > 0 for m in mats], axis=0) >= 2
    assert two.any()  # some row really serves two roles
    for a in mats:
        np.testing.assert_array_equal(bf16(a), a)  # the indicator is exact
        products = presence * a
        exact = products.sum(axis=1)
        assert exact.max() < 2.0 ** 24
        np.testing.assert_array_equal(truncating_sum(products, k), exact)


@pytest.mark.parametrize("rq, sh", [(1, 1), (3, 1), (1, 3), (2, 5)])
def test_a_packed_two_role_entry_is_not_bf16(rq, sh):
    """Why B4 keeps its counts apart: rq * 256 + sh for a row both required
    and should needs more than bf16's 8 significant bits."""
    v = np.float32(rq * 256.0 + sh)
    assert bf16(v) != v
