"""B9 (``diagon_tpu_torch.ops.bank_decode``): posting blocks decoded into
dense score rows. The plain version (the CPU path) against the host decode
``RowFieldIndex.host_row`` bit for bit, on postings packed here by hand so
that every corner of the block format shows: blocks without a freq
section, 32-bit fields, fields that straddle two words, a block that ends
on the stream's last word, short tail blocks, freqs past the LUT, terms
without blocks, one term twice. The ``cuda`` cases hold the kernel against
the plain version on the same inputs and on a random bank of 163 rows over
1,105,920 docs; ``chip_smoke.py`` runs them on the card (``phase_bank_decode``).
This module imports nothing of JAX, so the card can run it."""

import numpy as np
import pytest
import torch

from diagon_tpu_torch.codecs.postings import PackedPostings
from diagon_tpu_torch.ops import bank_decode, launches
from diagon_tpu_torch.search.row_engine import RowFieldIndex

D_CRAFTED = 4096
F_CRAFTED = 8


def _pack_values(values, bits):
    """u32 words holding ``values`` at ``bits`` bits each, value i at bit
    i * bits, LSB first (Python integers: no width to overflow)."""
    acc = 0
    for i, v in enumerate(values):
        assert 0 <= int(v) < (1 << bits)
        acc |= int(v) << (i * bits)
    return [(acc >> (32 * k)) & 0xFFFFFFFF
            for k in range((len(values) * bits + 31) // 32)]


def _postings(terms):
    """PackedPostings of ``terms``: a list (one entry a term) of blocks
    ``(docs, freqs, doc_bits, freq_bits)``; freq_bits 0 means every freq
    is 1 and no freq section. The stream ends with the last block's last
    word: no slack."""
    cols = {k: [] for k in ("term", "base", "count", "dbits", "fbits",
                            "woff", "maxf")}
    words, block_start, entry_start, df = [], [0], [0], []
    for t, blocks in enumerate(terms):
        n = 0
        for docs, freqs, dbits, fbits in blocks:
            docs, freqs = np.asarray(docs), np.asarray(freqs)
            deltas = np.diff(docs, prepend=docs[0])
            cols["term"].append(t)
            cols["base"].append(int(docs[0]))
            cols["count"].append(len(docs))
            cols["dbits"].append(dbits)
            cols["fbits"].append(fbits)
            cols["woff"].append(len(words))
            cols["maxf"].append(int(freqs.max()))
            words += _pack_values(deltas, dbits)
            if fbits:
                words += _pack_values(freqs, fbits)
            else:
                assert (freqs == 1).all()
            n += len(docs)
            entry_start.append(entry_start[-1] + len(docs))
        block_start.append(len(cols["term"]))
        df.append(n)
    i32 = lambda k: np.asarray(cols[k], np.int32)  # noqa: E731
    return PackedPostings(
        terms=[f"t{i}" for i in range(len(terms))],
        block_start=np.asarray(block_start, np.int32),
        doc_freq=np.asarray(df, np.int32), total_tf=np.zeros(len(terms),
                                                            np.int64),
        block_term=i32("term"), block_base=i32("base"),
        block_count=i32("count"), block_doc_bits=i32("dbits"),
        block_freq_bits=i32("fbits"), block_word_off=i32("woff"),
        block_max_freq=i32("maxf"),
        block_max_norm=np.full(len(cols["term"]), 127, np.int32),
        block_entry_start=np.asarray(entry_start, np.int64),
        packed=np.asarray(words, np.uint32),
    )


def _docs(rng, lo, hi, n):
    return np.sort(rng.choice(np.arange(lo, hi), n, replace=False))


def crafted():
    """(postings, norms, lut, D) with one term for each corner of the
    format, in this order: t0 no freq section, t1 32-bit fields, t2 fields
    straddling words, t3 tail blocks, t4 no blocks, t5 freqs past F, t6
    straddling fields and a block that ends on the stream's last word."""
    rng = np.random.default_rng(22)
    F = F_CRAFTED
    terms = [
        [(_docs(rng, 0, 1000, 128), np.ones(128, int), 10, 0),
         (_docs(rng, 1000, 1100, 5), np.ones(5, int), 7, 0)],
        [(_docs(rng, 0, 2000, 128),
          rng.integers(0, 1 << 31, 128), 32, 32),
         (_docs(rng, 2000, 4090, 77), rng.integers(1, F, 77), 32, 32)],
        [(_docs(rng, 0, 1500, 128), rng.integers(1, 1 << 17, 128), 31, 17),
         (_docs(rng, 1500, 4090, 128), rng.integers(1, 1 << 29, 128), 13,
          29)],
        [(_docs(rng, 0, 10, 1), np.asarray([3]), 1, 2),
         (_docs(rng, 10, 300, 37), rng.integers(1, 4, 37), 9, 2),
         (_docs(rng, 300, 4090, 127), rng.integers(1, 3, 127), 12, 2)],
        [],
        [(_docs(rng, 0, 4090, 128), rng.integers(F, 32, 128), 12, 5)],
        [(_docs(rng, 0, 3000, 128), rng.integers(1, 1 << 11, 128), 31, 11),
         (_docs(rng, 3000, 4090, 50), rng.integers(1, 1 << 3, 50), 11, 3)],
    ]
    pp = _postings(terms)
    norms = rng.integers(0, 128, D_CRAFTED - 3).astype(np.uint8)
    lut = rng.random(128 * F, dtype=np.float32) + np.float32(0.01)
    return pp, norms, lut, D_CRAFTED


# bank specs (row, term, scale) of each case
CASES = {
    "no-freq-section": [(0, 0, 1.5)],
    "32-bit-fields": [(0, 1, 0.75)],
    "straddling-fields": [(1, 2, 2.0)],
    "tail-blocks": [(0, 3, 3.0)],
    "freqs-past-F": [(0, 5, 0.5)],
    "ends-on-last-word": [(0, 6, 1.25)],
    "no-specs": [],
    "terms-without-blocks": [(0, 4, 1.0), (1, 0, 1.0), (2, 4, 2.0)],
    "one-term-twice": [(2, 2, 1.0), (0, 2, 0.3), (1, 0, 1.0)],
    "every-term": [(6, 0, 1.1), (0, 1, 0.9), (3, 2, 1.7), (1, 3, 0.2),
                   (4, 4, 5.0), (2, 5, 1.0), (5, 6, 0.6)],
}


def index_for(pp, norms, lut, D, device):
    return RowFieldIndex(pp, norms, D, None, lut, device)


def _nrows(specs):
    return max([r for r, _, _ in specs], default=0) + 2  # a zero row past


def reference_bank(idx, specs, nrows):
    bank = torch.zeros((nrows, idx.num_docs_pad), dtype=torch.float32,
                       device=idx.device)
    bank_decode.bank_decode_reference(
        bank, bank_decode.pack_specs(specs, idx.pp.block_start, nrows),
        idx.device_decode_state())
    return bank


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.fixture(scope="module")
def crafted_index():
    return index_for(*crafted(), "cpu")


def test_the_crafted_postings_reach_every_corner(crafted_index):
    pp = crafted_index.pp
    assert (pp.block_freq_bits[pp.block_start[0]:pp.block_start[1]] == 0).all()
    assert pp.block_doc_bits.max() == 32 and pp.block_freq_bits.max() == 32
    assert pp.block_count.min() == 1 and (pp.block_count < 128).sum() >= 4
    assert pp.block_start[4] == pp.block_start[5]  # t4 has no block
    assert (pp.block_max_freq[pp.block_start[5]:pp.block_start[6]]
            >= F_CRAFTED).all()
    # t6's last block ends on the stream's last word: reading a field
    # there clamps the window's upper word
    b = len(pp.block_count) - 1
    dw = (pp.block_count[b] * pp.block_doc_bits[b] + 31) // 32
    fw = (pp.block_count[b] * pp.block_freq_bits[b] + 31) // 32
    assert pp.block_word_off[b] + dw + fw == len(pp.packed)


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_equals_host_row(crafted_index, case):
    specs = [(r, t, np.float32(w)) for r, t, w in CASES[case]]
    nrows = _nrows(specs)
    got = reference_bank(crafted_index, specs, nrows).numpy()
    used = set()
    for r, t, w in specs:
        np.testing.assert_array_equal(
            _bits(got[r]), _bits(crafted_index.host_row(t, w)))
        used.add(r)
    for r in set(range(nrows)) - used:
        assert not got[r].any()


def test_build_rows_is_the_reference_on_the_cpu(crafted_index, monkeypatch):
    """``build_rows`` on CPU tensors runs the plain version, also in many
    steps, and counts no launch."""
    specs = [(r, t, np.float32(w)) for r, t, w in CASES["every-term"]]
    want = reference_bank(crafted_index, specs, 8).numpy()
    before = launches("bank_decode")
    monkeypatch.setattr(bank_decode, "_REFERENCE_CHUNK_BLOCKS", 3)
    got = crafted_index.build_rows(specs, 8).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert launches("bank_decode") == before


def test_tables_hold_the_postings_in_the_kernels_types(crafted_index):
    t = crafted_index.device_decode_state()
    pp = crafted_index.pp
    assert t.packed.dtype == torch.int32 and t.norms.dtype == torch.uint8
    assert t.doc_bits.dtype == t.freq_bits.dtype == t.count.dtype \
        == torch.uint8
    np.testing.assert_array_equal(t.packed.numpy().view(np.uint32),
                                  pp.packed)
    assert t.norms.shape[0] == D_CRAFTED and t.F == F_CRAFTED
    assert crafted_index.device_decode_state() is t  # uploaded once


def test_tables_refuse_values_the_kernel_cannot_take():
    pp, norms, lut, D = crafted()
    bad = norms.copy()
    bad[7] = 128
    with pytest.raises(ValueError, match="norm"):
        bank_decode.decode_tables(pp, bad, D, lut, "cpu")
    with pytest.raises(ValueError, match="LUT"):
        bank_decode.decode_tables(pp, norms, D, lut[:-1], "cpu")
    pp.block_count = pp.block_count.copy()
    pp.block_count[0] = 129
    with pytest.raises(ValueError, match="count"):
        bank_decode.decode_tables(pp, norms, D, lut, "cpu")


def test_pack_specs_lays_out_rows_terms_scales_and_the_block_prefix():
    pp = crafted()[0]
    specs = [(2, 1, np.float32(0.5)), (0, 4, np.float32(2.0)),
             (1, 3, np.float32(-1.0))]
    a = bank_decode.pack_specs(specs, pp.block_start, 3)
    assert a.shape == (4, 4) and a.dtype == np.int32
    np.testing.assert_array_equal(a[0, :3], [2, 0, 1])
    np.testing.assert_array_equal(a[1, :3], [1, 4, 3])
    np.testing.assert_array_equal(a[2, :3].view(np.float32),
                                  [0.5, 2.0, -1.0])
    np.testing.assert_array_equal(a[3], [0, 2, 2, 5])
    assert bank_decode.spec_blocks(a) == 5
    assert bank_decode.spec_blocks(
        bank_decode.pack_specs([], pp.block_start, 3)) == 0
    with pytest.raises(ValueError, match="rows"):
        bank_decode.pack_specs(specs, pp.block_start, 2)
    with pytest.raises(ValueError, match="term"):
        bank_decode.pack_specs([(0, 7, 1.0)], pp.block_start, 1)


def test_light_blocks_counts_the_specs_blocks():
    """``search.light_blocks`` moves by the posting blocks of the light
    banks' term specs in a ``SparseSearcher.dispatch_batch``: one spec per
    distinct (term, weight) of the batch; ``search.light_rows`` by their
    number."""
    from diagon_tpu_torch.observability.metrics import registry
    from diagon_tpu_torch.sparse import (SparseIndex, SparseSearcher,
                                         SparseVector)

    rng = np.random.default_rng(5)
    vecs = []
    for _ in range(3000):
        ids = np.unique(rng.integers(0, 400, 30))
        vecs.append(SparseVector(ids, rng.random(len(ids)) * 2 + 0.05))
    s = SparseSearcher(SparseIndex.build(vecs), device="cpu")
    qs = vecs[:16] + vecs[:4]  # repeats share their rows
    keys = {e for p in s._plan_batch(qs) for e in p.light_entries}
    bs = s.pp.block_start
    want = sum(int(bs[t + 1] - bs[t]) for t, _ in keys)
    assert want > len(keys)  # terms of more than one block
    snap = registry.snapshot()
    s.collect_batch(s.dispatch_batch(qs, 10))
    now = registry.snapshot()
    assert now["search.light_blocks"] - snap.get("search.light_blocks",
                                                 0) == want
    assert now["search.light_rows"] - snap.get("search.light_rows",
                                               0) == len(keys)


def random_bank(seed, D=1_105_920, rows=163, F=256):
    """(postings, norms, lut, D, specs): ``rows`` terms of up to D / 2 docs
    each (about 45M postings at the defaults, the size of one light bank
    of the SPLADE shard), packed by the port's packer; freqs past F; row
    ``rows - 1`` holds term 0 again at another scale."""
    from diagon_tpu_torch.codecs.postings import build_packed_postings_csr

    rng = np.random.default_rng(seed)
    p = rng.random(rows - 1) * 0.5
    docs = [np.flatnonzero(rng.random(D - 1000) < q) for q in p]
    entry = np.zeros(rows, np.int64)
    np.cumsum([len(d) for d in docs], out=entry[1:])
    flat = np.concatenate(docs)
    freqs = rng.integers(1, F + 40, len(flat))
    norms = rng.integers(0, 128, D - 1000).astype(np.uint8)
    pp = build_packed_postings_csr([f"t{i:04d}" for i in range(rows - 1)],
                                   entry, flat, freqs, norms=norms)
    lut = rng.random(128 * F, dtype=np.float32)
    scales = (rng.random(rows, dtype=np.float32) + np.float32(0.1))
    specs = [(r, r, scales[r]) for r in range(rows - 1)]
    specs.append((rows - 1, 0, scales[-1]))
    return pp, norms, lut, D, specs


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES) + ["random-1.1M"])
def test_kernel_equals_plain_version_on_the_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    if case == "random-1.1M":
        pp, norms, lut, D, specs = random_bank(9)
    else:
        pp, norms, lut, D = crafted()
        specs = [(r, t, np.float32(w)) for r, t, w in CASES[case]]
    idx = index_for(pp, norms, lut, D, "cuda")
    nrows = _nrows(specs)
    before = launches("bank_decode")
    got = idx.build_rows(specs, nrows)
    torch.cuda.synchronize()
    blocks = bank_decode.spec_blocks(
        bank_decode.pack_specs(specs, pp.block_start, nrows))
    assert launches("bank_decode") - before == (1 if blocks else 0)
    want = reference_bank(idx, specs, nrows)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
