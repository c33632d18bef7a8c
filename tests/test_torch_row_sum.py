"""Kernels B1/B2 of diagon_tpu_torch against the JAX package's Pallas
kernels (interpret mode), bit for bit, and the wrappers' CPU contract."""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diagon_tpu.ops.pallas.row_sum import pallas_row_boolean, pallas_row_sum
from diagon_tpu_torch.ops import launches
from diagon_tpu_torch.ops import row_sum as rs

# (Q, Tq, D, H, L): single query, light-only clauses, odd batch sizes,
# several 1024-doc tiles
SHAPES = [
    (1, 4, 1024, 3, 1),
    (3, 8, 1024, 5, 4),
    (7, 12, 2048, 6, 5),
    (4, 20, 4096, 4, 3),
]


def _inputs(Q, Tq, D, H, L, seed=7):
    """Seeded rows (~40% zero, so presence varies), a third of the
    clauses on light rows (row 0 all zero), random flags."""
    rng = np.random.default_rng(seed + Q * 1000 + Tq)
    heavy = (rng.random((H, D), dtype=np.float32)
             * (rng.random((H, D)) < 0.6)).astype(np.float32)
    light = (rng.random((L, D), dtype=np.float32)
             * (rng.random((L, D)) < 0.6)).astype(np.float32)
    light[0] = 0.0
    hidx = rng.integers(0, H, (Q, Tq)).astype(np.int32)
    on_light = rng.random((Q, Tq)) < 0.33
    hidx[on_light] = -1
    lidx = np.where(on_light, rng.integers(0, L, (Q, Tq)), 0).astype(np.int32)
    flags = rng.integers(0, 16, (Q, Tq)).astype(np.int32)
    return heavy, light, hidx, lidx, flags


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _torch(*arrays):
    return tuple(torch.from_numpy(a.copy()) for a in arrays)


@pytest.mark.parametrize("shape", SHAPES)
def test_row_sum_reference_matches_pallas(shape):
    heavy, light, hidx, lidx, _ = _inputs(*shape)
    want = pallas_row_sum(jnp.asarray(heavy), jnp.asarray(light),
                          jnp.asarray(hidx), jnp.asarray(lidx),
                          interpret=True)
    got = rs.row_sum_reference(*_torch(heavy, light, hidx, lidx))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("shape", SHAPES)
def test_row_boolean_reference_matches_pallas(shape):
    heavy, light, hidx, lidx, flags = _inputs(*shape)
    want = pallas_row_boolean(jnp.asarray(heavy), jnp.asarray(light),
                              jnp.asarray(hidx), jnp.asarray(lidx),
                              jnp.asarray(flags), interpret=True)
    got = rs.row_boolean_reference(*_torch(heavy, light, hidx, lidx, flags))
    assert len(got) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_cpu_wrappers_use_plain_versions_without_launching(shape):
    heavy, light, hidx, lidx, flags = _torch(*_inputs(*shape))
    n_sum, n_bool = launches("row_sum"), launches("row_boolean")
    assert torch.equal(rs.row_sum(heavy, light, hidx, lidx),
                       rs.row_sum_reference(heavy, light, hidx, lidx))
    for g, w in zip(rs.row_boolean(heavy, light, hidx, lidx, flags),
                    rs.row_boolean_reference(heavy, light, hidx, lidx, flags)):
        assert torch.equal(g, w)
    assert (launches("row_sum"), launches("row_boolean")) == (n_sum, n_bool)


def _bad_inputs(case):
    heavy, light, hidx, lidx, flags = _torch(*_inputs(2, 4, 1024, 3, 2))
    if case == "f64_bank":
        heavy = heavy.double()
    elif case == "i64_index":
        hidx = hidx.long()
    elif case == "ragged_docs":
        heavy, light = heavy[:, :1000].contiguous(), light[:, :1000].contiguous()
    elif case == "non_contiguous":
        hidx = torch.cat([hidx, hidx], dim=1)[:, ::2]
    elif case == "shape_mismatch":
        lidx = lidx[:1].contiguous()
    elif case == "light_width":
        light = torch.zeros((2, 2048))
    elif case == "no_clauses":
        hidx, lidx, flags = hidx[:, :0], lidx[:, :0], flags[:, :0]
    elif case == "flags_shape":
        flags = flags[:, :2].contiguous()
    return heavy, light, hidx, lidx, flags


@pytest.mark.parametrize("case", [
    "f64_bank", "i64_index", "ragged_docs", "non_contiguous",
    "shape_mismatch", "light_width", "no_clauses", "flags_shape",
])
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    heavy, light, hidx, lidx, flags = _bad_inputs(case)
    with pytest.raises((ValueError, TypeError)):
        rs.row_boolean(heavy, light, hidx, lidx, flags)
    if case != "flags_shape":
        with pytest.raises((ValueError, TypeError)):
            rs.row_sum(heavy, light, hidx, lidx)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_match_plain_versions_on_the_card(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    args = tuple(t.cuda() for t in _torch(*_inputs(*shape)))
    got = rs.row_sum(*args[:4])
    assert torch.equal(got.view(torch.int32),
                       rs.row_sum_reference(*args[:4]).view(torch.int32))
    for g, w in zip(rs.row_boolean(*args), rs.row_boolean_reference(*args)):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize("Q, D, want", [
    (1, 19456, 32),        # the main path's or20 plan: 152 blocks
    (7, 19456, 128),
    (1024, 19456, 256),
    (1, 1003520, 256),
    (70000, 1024, 256),    # grid.y capped, strided in the kernel
])
def test_launch_geometry_fills_the_card(Q, D, want):
    threads, bx, gy = rs.launch_geometry(Q, D, 132)
    assert threads == want
    assert threads * bx * 4 == D  # one float4 column per thread, all covered
    assert gy == min(Q, rs.MAX_GRID_Y)
    assert bx * gy >= 2 * 132 or threads == 32


@pytest.mark.parametrize("Q, D, want", [
    (3, 10002432, 256),   # the 10M mixed batch's escalated queries
    (19, 1003520, 256),   # the 1M mixed batch's
    (3, 19456, 32),       # few queries over the 19k axis: small blocks
    (19, 19456, 256),
    (127, 19456, 256),    # the 19k MUST_NOT batch's escalations
])
def test_launch_geometry_at_row_boolean_escalation_shapes(Q, D, want):
    """B2 takes B1's geometry: the largest block that still puts two blocks
    on every SM."""
    threads, bx, gy = rs.launch_geometry(Q, D, 132)
    assert threads == want
    assert threads * bx * 4 == D and gy == Q
    assert bx * gy >= 2 * 132
    if threads < 256:  # the next larger block would leave SMs idle
        assert (D // 4 // (2 * threads)) * gy < 2 * 132


@pytest.mark.parametrize("case", ["i64_flags", "non_contiguous_flags",
                                  "flags_on_meta", "f32_flags"])
def test_fast_check_names_bad_flags_as_the_diagnosis_does(case):
    heavy, light, hidx, lidx, flags = _torch(*_inputs(4, 6, 1024, 3, 2))
    if case == "i64_flags":
        flags = flags.long()
    elif case == "non_contiguous_flags":
        flags = torch.stack([flags, flags], dim=2)[:, :, 0]
        assert not flags.is_contiguous()
    elif case == "flags_on_meta":
        flags = flags.to("meta")
    elif case == "f32_flags":
        flags = flags.float()
    with pytest.raises((ValueError, TypeError)) as diag:
        rs._diagnose(heavy, light, hidx, lidx, flags)
    with pytest.raises(diag.type, match=re.escape(str(diag.value))):
        rs._check(heavy, light, hidx, lidx, flags)
    with pytest.raises(diag.type, match=re.escape(str(diag.value))):
        rs.row_boolean(heavy, light, hidx, lidx, flags)


@pytest.mark.parametrize("case", [
    "f64_bank", "i64_index", "ragged_docs", "non_contiguous",
    "shape_mismatch", "light_width", "no_clauses", "flags_shape",
])
def test_fast_check_raises_what_the_diagnosis_names(case):
    heavy, light, hidx, lidx, flags = _bad_inputs(case)
    with pytest.raises((ValueError, TypeError)) as diag:
        rs._diagnose(heavy, light, hidx, lidx, flags)
    with pytest.raises(diag.type, match=re.escape(str(diag.value))):
        rs._check(heavy, light, hidx, lidx, flags)


def test_check_refuses_other_devices_and_passes_good_inputs():
    heavy, light, hidx, lidx, flags = _torch(*_inputs(2, 4, 1024, 3, 2))
    assert rs._check(heavy, light, hidx, lidx) == (2, 4, 1024)
    assert rs._check(heavy, light, hidx, lidx, flags) == (2, 4, 1024)
    with pytest.raises(ValueError):
        rs._check(heavy.to("meta"), light.to("meta"), hidx.to("meta"),
                  lidx.to("meta"))
