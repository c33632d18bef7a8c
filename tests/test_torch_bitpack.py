"""The port's fixed-width bit packing (``diagon_tpu_torch.codecs.bitpack``):
the cases of ``tests/unit/test_bitpack.py``, and the words equal to the
JAX package's for the same values."""

import numpy as np
import pytest

from diagon_tpu.codecs import bitpack as jbitpack
from diagon_tpu_torch.codecs.bitpack import (
    bits_needed,
    pack_u32,
    unpack_u32_numpy,
    words_for,
)


def test_bits_needed():
    assert bits_needed(0) == 1
    assert bits_needed(1) == 1
    assert bits_needed(2) == 2
    assert bits_needed(127) == 7
    assert bits_needed(128) == 8
    assert bits_needed((1 << 31) - 1) == 31
    with pytest.raises(ValueError):
        bits_needed(-1)


@pytest.mark.parametrize("bits", [1, 2, 3, 5, 7, 8, 11, 13, 16, 17, 24, 31, 32])
@pytest.mark.parametrize("n", [1, 4, 127, 128, 129, 1000])
def test_roundtrip(bits, n):
    rng = np.random.Generator(np.random.PCG64(bits * 1000 + n))
    hi = (1 << bits) - 1
    vals = rng.integers(0, hi + 1, size=n, dtype=np.uint64)
    words = pack_u32(vals, bits)
    assert len(words) == words_for(n, bits)
    out = unpack_u32_numpy(words, bits, n)
    np.testing.assert_array_equal(out.astype(np.uint64), vals)
    # the JAX package's words, bit for bit
    np.testing.assert_array_equal(words, jbitpack.pack_u32(vals, bits))


def test_pack_rejects_overflow():
    with pytest.raises(ValueError):
        pack_u32(np.array([8]), 3)
    with pytest.raises(ValueError):
        pack_u32(np.array([1]), 33)


def test_pack_empty():
    assert len(pack_u32(np.array([], dtype=np.int64), 7)) == 0
