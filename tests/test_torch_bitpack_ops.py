"""The port's bit-unpacking (``diagon_tpu_torch.ops.bitpack_ops``) against
the JAX package's (``diagon_tpu.ops.bitpack_ops``, on the JAX CPU backend)
and the numpy block decoder: on every block of ``test_device_engine``'s
700-doc corpus, and on hand-packed blocks at widths 0, 1, 7, 31 and 32
with word-aligned and straddling lanes, the last block of a stream and
``freq_bits`` 0. Tolerance 0: equal int32 lanes (the port's lanes are the
int32 bit patterns of the JAX u32 lanes)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diagon_tpu.codecs.bitpack import pack_u32
from diagon_tpu.codecs.postings import decode_block_numpy
from diagon_tpu.document import Document, TextField
from diagon_tpu.index.memory_index import MemoryIndex
from diagon_tpu.index.segment import flush_memory_index
from diagon_tpu.ops import bitpack_ops as jops
from diagon_tpu.search.device_index import load_segment as jax_load
from diagon_tpu_torch.ops import bitpack_ops as ops
from diagon_tpu_torch.search.convert import segment_from_jax
from diagon_tpu_torch.search.device_index import load_segment

VOCAB = np.asarray([f"w{i}" for i in range(200)]
                   + ["oil", "price", "trade", "market"], dtype=object)


@pytest.fixture(scope="module")
def corpus():
    """test_device_engine's random_index corpus (seed 42, 700 docs)."""
    rng = np.random.Generator(np.random.PCG64(42))
    mem = MemoryIndex()
    for _ in range(700):
        ln = max(1, int(rng.normal(40, 40 / 3)))
        mem.add_document(Document().add(
            TextField("body", " ".join(rng.choice(VOCAB, size=ln)))))
    seg = flush_memory_index(mem, "_0")
    return (seg, jax_load(seg).fields["body"],
            load_segment(segment_from_jax(seg), "cpu").fields["body"])


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _port_words(words_u32):
    return _t(np.asarray(words_u32, np.uint32).view(np.int32))


def test_decode_every_corpus_block(corpus):
    seg, jf, pf = corpus
    pp = seg.fields["body"].postings
    nb = pp.num_blocks
    sel = np.arange(nb, dtype=np.int32)
    want = jops.decode_doc_blocks(
        jf.packed, jf.block_word_off[sel], jf.block_base[sel],
        jf.block_count[sel], jf.block_doc_bits[sel], jf.block_freq_bits[sel],
        window_words=jf.window_words)
    idx = _t(sel).long()
    got = ops.decode_doc_blocks(
        pf.packed, pf.block_word_off[idx], pf.block_base[idx],
        pf.block_count[idx], pf.block_doc_bits[idx], pf.block_freq_bits[idx],
        window_words=pf.window_words)
    docs, freqs, valid = (np.asarray(x) for x in want)
    gd, gf, gv = (x.numpy() for x in got)
    assert gd.dtype == np.int32 and gf.dtype == np.int32 and gv.dtype == bool
    np.testing.assert_array_equal(gv, valid)
    np.testing.assert_array_equal(np.where(valid, gd, 0),
                                  np.where(valid, docs, 0))
    np.testing.assert_array_equal(np.where(valid, gf, 0),
                                  np.where(valid, freqs, 0))
    for b in range(nb):
        exp_docs, exp_freqs = decode_block_numpy(pp, b)
        cnt = len(exp_docs)
        np.testing.assert_array_equal(gd[b, :cnt], exp_docs)
        np.testing.assert_array_equal(gf[b, :cnt], exp_freqs)
        assert gv[b, :cnt].all() and not gv[b, cnt:].any()


@pytest.mark.parametrize("bits", [0, 1, 7, 31, 32])
@pytest.mark.parametrize("word_base", [0, 1, 3])
def test_unpack_lanes_every_lane(bits, word_base):
    """All 128 lanes (invalid ones too) equal the JAX u32 lanes' bit
    patterns, on a window of random words: aligned lanes (shift 0, no high
    word), straddling ones, and lanes clipped to the window's last word."""
    rng = np.random.default_rng(bits * 7 + word_base)
    B, W = 5, 9
    window = rng.integers(0, 1 << 32, size=(B, W), dtype=np.uint64)
    window = window.astype(np.uint32)
    window[0] = 0xFFFFFFFF  # high bit set everywhere: no sign smear
    bits_a = np.full(B, bits, np.int32)
    base_a = np.full(B, word_base, np.int32)
    want = np.asarray(jops.unpack_lanes(jnp.asarray(window),
                                        jnp.asarray(bits_a),
                                        jnp.asarray(base_a)))
    got = ops.unpack_lanes(_port_words(window), _t(bits_a), _t(base_a))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather_windows_clip_to_the_stream():
    words = np.arange(1, 23, dtype=np.uint32) * np.uint32(0x9E3779B1)
    off = np.asarray([0, 5, 17, 21, 30], np.int32)  # the last ones run out
    want = np.asarray(jops.gather_windows(jnp.asarray(words), jnp.asarray(off),
                                          8))
    got = ops.gather_windows(_port_words(words), _t(off), 8)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def _hand_stream(specs):
    """Pack blocks [(deltas, freqs, doc_bits, freq_bits)] back to back into
    one word stream with no slack after the last block (its window runs
    past the stream and is clipped)."""
    words, off, base, count, dbits, fbits = [], [], [], [], [], []
    at, doc = 0, 3
    for deltas, freqs, db, fb in specs:
        d = pack_u32(np.asarray(deltas), db) if db else np.zeros(0, np.uint32)
        f = pack_u32(np.asarray(freqs), fb) if fb else np.zeros(0, np.uint32)
        words += [d, f]
        off.append(at)
        base.append(doc)
        count.append(len(deltas))
        dbits.append(db)
        fbits.append(fb)
        at += len(d) + len(f)
        doc += int(np.sum(deltas)) + 1000
    cols = [np.asarray(c, np.int32) for c in (off, base, count, dbits, fbits)]
    return np.concatenate(words).astype(np.uint32), cols


def _hand_specs():
    rng = np.random.default_rng(11)

    def deltas(n, bits):
        v = rng.integers(1, 1 << min(bits, 20), size=n)
        v[0] = 0
        return v

    return [
        (deltas(128, 7), rng.integers(1, 100, 128), 7, 7),  # straddling
        (deltas(128, 1) * 0 + 1, rng.integers(1, 2, 128), 1, 0),  # freq 1
        ([0], [5], 0, 3),  # doc width 0: one posting
        (deltas(100, 31), rng.integers(1, 1 << 31, 100), 31, 31),
        # freqs at 32 bits, high bit set: int32 bit patterns of the u32 lanes
        (deltas(64, 1) * 0 + 1, rng.integers(1 << 31, 1 << 32, 64), 1, 32),
        (deltas(128, 16), rng.integers(1, 1 << 16, 128), 16, 16),  # aligned
        (deltas(37, 32), rng.integers(1, 50, 37), 32, 6),  # last of stream
    ]


def test_decode_hand_packed_blocks():
    specs = _hand_specs()
    words, (off, base, count, dbits, fbits) = _hand_stream(specs)
    ww = 1 + max(-(-n * db // 32) + -(-n * fb // 32)
                 for n, db, fb in zip(count, dbits, fbits))
    want = jops.decode_doc_blocks(
        jnp.asarray(words), *(jnp.asarray(c) for c in
                              (off, base, count, dbits, fbits)),
        window_words=ww)
    got = ops.decode_doc_blocks(_port_words(words), *(_t(c) for c in
                                (off, base, count, dbits, fbits)),
                                window_words=ww)
    docs, freqs, valid = (np.asarray(x) for x in want)
    gd, gf, gv = (x.numpy() for x in got)
    np.testing.assert_array_equal(gv, valid)
    np.testing.assert_array_equal(np.where(valid, gd, 0),
                                  np.where(valid, docs, 0))
    np.testing.assert_array_equal(np.where(valid, gf, 0),
                                  np.where(valid, freqs, 0))
    for b, (dl, fr, db, fb) in enumerate(specs):
        n = len(dl)
        np.testing.assert_array_equal(gd[b, :n],
                                      base[b] + np.cumsum(np.asarray(dl)))
        want_f = np.asarray(fr, np.uint32).view(np.int32) if fb else np.ones(n)
        np.testing.assert_array_equal(gf[b, :n], want_f)
