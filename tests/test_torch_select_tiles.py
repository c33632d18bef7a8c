"""Tile selection, in-tile ranking and the certificates of the port's pruned
route against the JAX package's functions (mirrors
``tests/unit/test_select_tiles.py``): the port's ``_select_tiles`` equals
``_select_tiles_flat`` on tsel, u_next and min_unsel_feas at every G,
including value ties, zero-bound feasible tiles and Bk >= G."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diagon_tpu.search import row_engine as jre
from diagon_tpu_torch.search import row_engine as tre


def _bounds(kind, Q, G, seed):
    rng = np.random.Generator(np.random.PCG64(seed))
    if kind == "continuous":
        return rng.normal(size=(Q, G)).astype(np.float32)
    if kind == "ties":
        return (np.round(rng.normal(size=(Q, G)) * 4) / 4).astype(np.float32)
    # FILTER-style boolean bounds: feasible tiles at 0, the rest -1*(1+eps)
    infeasible = np.float32(-1.0) * (np.float32(1) + tre._APPROX_RELEPS)
    return np.where(rng.random((Q, G)) < 0.05, np.float32(0.0),
                    infeasible).astype(np.float32)


@pytest.mark.parametrize("kind", ["continuous", "ties", "zero_feasible"])
@pytest.mark.parametrize("Q,G,Bk", [(1, 16, 3), (7, 60, 24), (16, 300, 37),
                                    (5, 12, 12), (3, 8, 24)])
def test_select_tiles_matches_flat(kind, Q, G, Bk):
    tu = _bounds(kind, Q, G, seed=Q * 31 + G)
    want = jax.tree.map(np.asarray,
                        jre._select_tiles_flat(jnp.asarray(tu), min(Bk, G), G)
                        if Bk < G else
                        jre._select_tiles(jnp.asarray(tu), Bk, G))
    got = tre._select_tiles(torch.from_numpy(tu), min(Bk, G), G)
    for g, w, name in zip(got, want, ("tsel", "u_next", "min_unsel")):
        assert g.numpy().shape == w.shape, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.int32


def test_select_tiles_zero_ties_take_the_lowest_feasible():
    tu = _bounds("zero_feasible", 8, 400, seed=5)
    tsel, _, min_unsel = tre._select_tiles(torch.from_numpy(tu), 6, 400)
    for q in range(8):
        feas = np.nonzero(tu[q] >= 0)[0]
        assert np.array_equal(tsel[q].numpy()[: min(6, len(feas))],
                              feas[:6])
        rest = feas[6:]
        assert min_unsel[q] == (rest[0] if len(rest) else 400)


def _lanes(Q, B, G, seed, zero_heavy=False):
    rng = np.random.Generator(np.random.PCG64(seed))
    tsel = np.sort(np.stack([rng.choice(G, B, replace=False)
                             for _ in range(Q)]), axis=1).astype(np.int32)
    final = np.round(rng.random((Q, B, 128)) * 8).astype(np.float32)
    final[rng.random((Q, B, 128)) < 0.5] = -1.0
    if zero_heavy:
        final = np.where(final >= 0, np.float32(0.0), final)
    return final, tsel


@pytest.mark.parametrize("k", [1, 10, 200])
@pytest.mark.parametrize("zero_heavy", [False, True])
def test_topk_in_tiles_matches_jax(k, zero_heavy):
    """The two-key (score desc, docid asc) rank over candidates that come
    in top-tile order, not docid order; value ties everywhere."""
    final, tsel = _lanes(6, 5, 40, seed=k, zero_heavy=zero_heavy)
    ws, wd = jax.vmap(lambda f, t: jre._topk_in_tiles_final_q(f, t, k))(
        jnp.asarray(final), jnp.asarray(tsel))
    gs, gd = tre._topk_in_tiles_final(torch.from_numpy(final),
                                      torch.from_numpy(tsel), k)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


@pytest.mark.parametrize("boolean", [False, True])
def test_pruned_batch_finish_matches_jax(boolean):
    """Masks, ranking, hits and the certificates (pure-OR; boolean (a),
    (b) and the zero-tie (c)) on the same rescored lanes."""
    rng = np.random.Generator(np.random.PCG64(17 + boolean))
    Q, B, G, k = 9, 4, 12, 5
    scores, tsel = _lanes(Q, B, G, seed=3, zero_heavy=boolean)
    scores = np.maximum(scores, 0)
    rc = rng.integers(0, 3, (Q, B, 128)).astype(np.float32)
    oc = rng.integers(0, 3, (Q, B, 128)).astype(np.float32)
    nc = (rng.random((Q, B, 128)) < 0.1).astype(np.float32)
    bool_params = np.stack([rng.integers(0, 2, Q), rng.integers(0, 2, Q)],
                           axis=1).astype(np.float32)
    # u_next around theta: above, equal, zero, negative, -inf
    u_next = np.asarray([9, 0, 0, -1.0078125, -np.inf, 3, 0, 5, 0],
                        np.float32)
    min_unsel = np.asarray([12, 0, 11, 12, 12, 2, 12, 3, 1], np.int32)
    hits = rng.integers(0, 500, Q).astype(np.int32)
    live = (rng.random(G * 128) < 0.9).astype(np.float32)
    args = (scores, rc, oc, nc, bool_params, tsel, u_next, min_unsel, hits)
    if not boolean:
        args = (scores, None, None, None) + args[4:]
    want = jre._pruned_batch_finish(
        *[None if a is None else jnp.asarray(a) for a in args],
        jnp.asarray(live).reshape(G, 128), k=k, boolean=boolean)
    got = tre._pruned_batch_finish(
        *[None if a is None else torch.from_numpy(a) for a in args],
        torch.from_numpy(live).reshape(G, 128), k=k, boolean=boolean)
    want = np.asarray(want)
    assert got.shape == want.shape == (Q, 2 * k + 2)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    assert 0 < want[:, -1].sum() < Q  # both certificate outcomes occur
