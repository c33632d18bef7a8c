"""The port's columnar host I/O (``diagon_tpu_torch.columnar.compression``,
``.store``, ``.parts``) on the CPU.

The codec and store cases of ``tests/unit/test_columnar.py`` and the five
cases of ``tests/unit/test_columnar_parts.py`` are mirrored on the port's
classes. Across the packages: every chain's bytes and the LZ4 blocks of
the port's host library are the JAX package's, the plain Python LZ4
decoder decodes the host library's blocks, and a table the JAX
``write_table`` writes reads back in the port and answers ``range_agg``
through ``DeviceTable(device="cpu")`` as the JAX ``DeviceTable`` does
(the same tolerances as ``tests/test_torch_columnar.py``: count, min, max
and granules bit-equal, an f32 sum within relative 1e-5).
"""

import numpy as np
import pytest

import diagon_tpu.columnar as jcol
import diagon_tpu.store as jstore
from diagon_tpu_torch import native
from diagon_tpu_torch.columnar import (
    CODECS,
    ColumnarTable,
    DataPartState,
    DataPartType,
    DeviceTable,
    Float64Column,
    Int64Column,
    StringColumn,
    compress,
    decompress,
    delete_part,
    merge_parts,
    read_part,
    read_table,
    select_part_type,
    write_part,
    write_table,
)
from diagon_tpu_torch.columnar.compression import (
    Lz4Codec,
    ZlibCodec,
    lz4_decompress_reference,
)
from diagon_tpu_torch.columnar.parts import (
    MAX_COMPACT_BYTES,
    MAX_COMPACT_ROWS,
    table_bytes_estimate,
)
from diagon_tpu_torch.store import FSDirectory, RAMDirectory


@pytest.fixture(scope="module", autouse=True)
def jnative(tmp_path_factory):
    """The JAX package's C++ extension, built by its own ``_build`` into a
    directory of this worker's own and loaded from there, and set as the
    JAX package's ``_native`` for this module's tests. On import the
    package builds it unlocked into its own directory, so parallel test
    workers can load a half-written library and fall back to None. A build
    that fails fails the tests."""
    import importlib.util
    import os

    import diagon_tpu.native as jmod

    so = tmp_path_factory.mktemp("jax_native") / os.path.basename(
        jmod._so_path())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmod, "_so_path", lambda: str(so))
        assert jmod._build(), "the JAX package's extension did not build"
        spec = importlib.util.spec_from_file_location(
            "diagon_tpu.native._native", str(so))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mp.setattr(jmod, "_native", mod)
        yield mod

CHAINS = [
    ["none"], ["zlib"], ["lz4"], ["delta"], ["delta", "zlib"],
    ["delta", "lz4"], ["doubledelta"], ["t64"],
    ["delta", "t64", "zlib"],
] + ([["zstd"], ["delta", "zstd"]] if "zstd" in CODECS else [])


# ---------------------------------------------------------------------------
# Mirrors of tests/unit/test_columnar.py's codec and store cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chain", CHAINS, ids="+".join)
def test_codec_chains_int64(chain):
    rng = np.random.Generator(np.random.PCG64(5))
    v = np.cumsum(rng.integers(0, 100, size=1000)).astype(np.int64)
    blob = compress(v.tobytes(), chain)
    out = np.frombuffer(decompress(blob), dtype=np.int64)
    np.testing.assert_array_equal(out, v)
    # the JAX package's bytes, and each package decodes the other's
    assert blob == jcol.compress(v.tobytes(), chain)
    assert jcol.decompress(blob) == v.tobytes()


def test_gorilla_floats():
    rng = np.random.Generator(np.random.PCG64(6))
    v = rng.normal(100, 1, size=500)
    blob = compress(v.tobytes(), ["gorilla", "zlib"])
    out = np.frombuffer(decompress(blob), dtype=np.float64)
    np.testing.assert_array_equal(out, v)
    assert blob == jcol.compress(v.tobytes(), ["gorilla", "zlib"])


def test_compression_actually_compresses():
    v = np.arange(8192, dtype=np.int64)  # perfectly delta-compressible
    blob = compress(v.tobytes(), ["delta", "t64", "zlib"])
    assert len(blob) < len(v.tobytes()) / 20


def test_zstd_is_registered_where_libzstd_is():
    """``zstd`` is in the registry exactly where the JAX package finds
    ``libzstd`` (nothing is installed for it)."""
    assert ("zstd" in CODECS) == ("zstd" in jcol.CODECS)


@pytest.mark.skipif("zstd" not in CODECS, reason="libzstd absent")
def test_zstd_roundtrip_and_ratio():
    from diagon_tpu_torch.columnar.compression import ZstdCodec

    c = ZstdCodec()
    rng = np.random.Generator(np.random.PCG64(9))
    text = (b"the quick brown fox jumps over the lazy dog " * 400)
    cases = [
        b"",
        b"a",
        text,
        bytes(rng.integers(0, 256, 100000, dtype=np.uint8)),
        bytes(8192),
    ]
    for data in cases:
        assert c.decompress(c.compress(data)) == data
    assert len(c.compress(text)) < len(ZlibCodec().compress(text))
    blob = compress(text, ["zstd"])
    assert decompress(blob) == text


def _lz4_cases():
    rng = np.random.Generator(np.random.PCG64(7))
    return [
        b"",
        b"a",
        b"abcd" * 3,                       # 12 bytes: literal-only zone
        b"x" * 13,                         # shortest matchable input
        b"ab" * 5000,                      # overlap copy, offset 2
        bytes(rng.integers(0, 256, 100000, dtype=np.uint8)),  # random
        bytes(rng.integers(0, 4, 65600, dtype=np.uint8)),     # long runs
        b"z" * 300,                        # match-len 255-extensions
        (b"hello world " * 40)[:300] + bytes(100) + b"hello world ",
    ]


def test_lz4_roundtrip_fuzz():
    c = Lz4Codec()
    for data in _lz4_cases():
        blob = c.compress(data)
        assert c.decompress(blob) == data, f"len={len(data)}"
    rep = b"the quick brown fox " * 500
    assert len(c.compress(rep)) < len(rep) / 10


@pytest.mark.parametrize("i", range(len(_lz4_cases())))
def test_lz4_blocks_equal_the_jax_extensions(i, jnative):
    """The host library's block is byte for byte the JAX extension's, and
    the plain Python decoder decodes it."""
    data = _lz4_cases()[i]
    block = native.lz4_compress(data)
    assert block == jnative.lz4_compress(data)
    assert lz4_decompress_reference(block, len(data)) == data
    assert native.lz4_decompress(block, len(data)) == data


def test_lz4_host_decoder_takes_literal_only_blocks_and_refuses_corrupt():
    """The JAX codec's literals-only block (its form without the
    extension) decodes in the host library; a corrupt or short block
    raises."""
    from diagon_tpu.columnar.compression import Lz4Codec as JaxLz4
    import diagon_tpu.native as jnative

    data = b"abcabcabc" * 200 + bytes(range(256)) * 4
    saved = jnative._native
    jnative._native = None
    try:
        literal_only = JaxLz4().compress(data)
    finally:
        jnative._native = saved
    assert Lz4Codec().decompress(literal_only) == data
    block = native.lz4_compress(data)
    with pytest.raises(ValueError):
        native.lz4_decompress(block, len(data) + 1)
    with pytest.raises(ValueError):
        native.lz4_decompress(block[:-3], len(data))
    with pytest.raises(ValueError):
        lz4_decompress_reference(block, len(data) - 1)


def test_lz4_raises_when_the_host_library_cannot_be_built(monkeypatch,
                                                          tmp_path):
    """No fallback: a host library that cannot be built makes the codec
    raise."""
    def no_compiler():
        raise RuntimeError("no host C++ compiler")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "library_path",
                        lambda: tmp_path / "libmissing.so")
    monkeypatch.setattr(native, "_cxx", no_compiler)
    with pytest.raises(RuntimeError):
        Lz4Codec().compress(b"abc" * 100)


def _table(n=20000, seed=3, granule_rows=8192):
    rng = np.random.Generator(np.random.PCG64(seed))
    t = ColumnarTable(granule_rows=granule_rows)
    t.add_column("ts", Int64Column(np.sort(rng.integers(0, 1 << 20, n))))
    t.add_column("price", Float64Column(rng.random(n) * 100))
    t.add_column("group", Int64Column(rng.integers(0, 8, n)), minmax=False)
    t.add_column(
        "name",
        StringColumn([f"item{int(i)}" for i in rng.integers(0, 500, n)]),
        bloom=True,
    )
    return t


def _jax_table(n=20000, seed=3, granule_rows=8192):
    rng = np.random.Generator(np.random.PCG64(seed))
    t = jcol.ColumnarTable(granule_rows=granule_rows)
    t.add_column("ts", jcol.Int64Column(np.sort(rng.integers(0, 1 << 20, n))))
    t.add_column("price", jcol.Float64Column(rng.random(n) * 100))
    t.add_column("group", jcol.Int64Column(rng.integers(0, 8, n)),
                 minmax=False)
    t.add_column(
        "name",
        jcol.StringColumn([f"item{int(i)}" for i in rng.integers(0, 500, n)]),
        bloom=True,
    )
    return t


def test_table_store_roundtrip():
    t = _table()
    d = RAMDirectory()
    write_table(d, "tbl", t)
    got = read_table(d, "tbl", verify_checksums=True)
    assert got.num_rows == t.num_rows
    np.testing.assert_array_equal(got.columns["ts"].values,
                                  t.columns["ts"].values)
    np.testing.assert_array_equal(got.columns["price"].values,
                                  t.columns["price"].values)
    assert got.columns["name"][5] == t.columns["name"][5]
    np.testing.assert_array_equal(got.minmax["ts"].mins, t.minmax["ts"].mins)
    np.testing.assert_array_equal(got.bloom["name"].words,
                                  t.bloom["name"].words)


# ---------------------------------------------------------------------------
# Across the packages
# ---------------------------------------------------------------------------


def test_table_bytes_equal_the_jax_writers():
    jd, td = jstore.RAMDirectory(), RAMDirectory()
    jcol.write_table(jd, "tbl", _jax_table(5000, 4, 512))
    write_table(td, "tbl", _table(5000, 4, 512))
    assert td.read_bytes("tbl.col") == jd.read_bytes("tbl.col")


QUERIES = [
    ("ts", 1000, 30000, None),  # pruned
    ("ts", 1000, 300000, "price"),
    ("ts", 0, 1 << 19, "group"),  # full
    ("price", 20.0, 30.0, "ts"),  # f32 filter
    ("group", 2, 5, "price"),  # no minmax: reduced from the planes
    ("name", "item10", "item19~", "price"),  # dictionary codes
    ("ts", 1 << 30, None, None),  # empty
]


@pytest.fixture(scope="module", params=[(20000, 3, 8192), (5003, 4, 10)],
                ids=["20000x8192", "5003x10"])
def jax_written(request, tmp_path_factory):
    """A table the JAX ``write_table`` wrote, read by each package."""
    n, seed, gr = request.param
    path = tmp_path_factory.mktemp("tbl")
    jcol.write_table(jstore.FSDirectory(path), "t", _jax_table(n, seed, gr))
    port = read_table(FSDirectory(path), "t", verify_checksums=True)
    jax_t = jcol.read_table(jstore.FSDirectory(path), "t")
    return port, jax_t


def test_a_jax_written_table_reads_back_in_the_port(jax_written):
    port, jax_t = jax_written
    assert (port.num_rows, port.granule_rows) == (jax_t.num_rows,
                                                  jax_t.granule_rows)
    for name, col in jax_t.columns.items():
        got = port.columns[name]
        if isinstance(col, jcol.StringColumn):
            np.testing.assert_array_equal(got.offsets, col.offsets)
            np.testing.assert_array_equal(got.chars, col.chars)
        else:
            assert got.values.dtype == col.values.dtype
            np.testing.assert_array_equal(got.values, col.values)
    for name, mm in jax_t.minmax.items():
        np.testing.assert_array_equal(port.minmax[name].mins, mm.mins)
        np.testing.assert_array_equal(port.minmax[name].maxs, mm.maxs)
    assert set(port.minmax) == set(jax_t.minmax)
    for name, bl in jax_t.bloom.items():
        np.testing.assert_array_equal(port.bloom[name].words, bl.words)


@pytest.mark.parametrize("q", QUERIES, ids=lambda q: f"{q[0]}-{q[3]}")
def test_a_jax_written_table_answers_as_jax(jax_written, q):
    port, jax_t = jax_written
    col, lo, hi, agg = q
    got = DeviceTable(port, device="cpu").dispatch_range_agg(
        col, lo, hi, agg).numpy()
    want = np.asarray(jcol.DeviceTable(jax_t).dispatch_range_agg(
        col, lo, hi, agg))
    gb, wb = got.view(np.uint32), want.view(np.uint32)
    for i in (0, 1, 3, 4, 5):
        assert gb[i] == wb[i], (q, i, got, want)
    assert abs(float(got[2]) - float(want[2])) <= 1e-5 * abs(float(want[2]))


def test_a_port_written_table_reads_back_in_the_jax_package(tmp_path):
    t = _table(3001, 8, 256)
    write_table(FSDirectory(tmp_path), "t", t)
    got = jcol.read_table(jstore.FSDirectory(tmp_path), "t",
                          verify_checksums=True)
    for name, col in t.columns.items():
        if isinstance(col, StringColumn):
            np.testing.assert_array_equal(got.columns[name].chars, col.chars)
        else:
            np.testing.assert_array_equal(got.columns[name].values,
                                          col.values)


# ---------------------------------------------------------------------------
# Mirrors of tests/unit/test_columnar_parts.py
# ---------------------------------------------------------------------------


def make_table(rows=20000, seed=3, strings=True):
    rng = np.random.Generator(np.random.PCG64(seed))
    t = ColumnarTable()
    t.add_column("ts", Int64Column(np.sort(rng.integers(0, 1 << 20, rows))))
    t.add_column("v", Float64Column(rng.random(rows) * 100))
    t.add_column("region", Int64Column(rng.integers(0, 64, rows)), bloom=True)
    if strings:
        t.add_column(
            "tag",
            StringColumn([f"tag{i % 37}" for i in range(rows)]),
            minmax=False,
        )
    return t


def assert_tables_equal(a, b):
    assert set(a.columns) == set(b.columns)
    assert a.num_rows == b.num_rows
    for cname, col in a.columns.items():
        other = b.columns[cname]
        if isinstance(col, StringColumn):
            assert np.array_equal(col.offsets, other.offsets)
            assert np.array_equal(col.chars, other.chars)
        else:
            assert np.array_equal(col.values, other.values)
    assert set(a.minmax) == set(b.minmax)
    for cname in a.minmax:
        assert np.array_equal(a.minmax[cname].mins, b.minmax[cname].mins)
        assert np.array_equal(a.minmax[cname].maxs, b.minmax[cname].maxs)
    assert set(a.bloom) == set(b.bloom)
    for cname in a.bloom:
        assert np.array_equal(a.bloom[cname].words, b.bloom[cname].words)


def test_select_part_type_reference_thresholds():
    assert select_part_type(1, 1) == DataPartType.COMPACT
    assert (select_part_type(MAX_COMPACT_BYTES, MAX_COMPACT_ROWS)
            == DataPartType.WIDE)
    # the reference's OR: small bytes keeps Compact even at many rows
    assert (select_part_type(MAX_COMPACT_BYTES - 1, MAX_COMPACT_ROWS * 10)
            == DataPartType.COMPACT)
    assert (select_part_type(MAX_COMPACT_BYTES * 10, MAX_COMPACT_ROWS - 1)
            == DataPartType.COMPACT)


@pytest.mark.parametrize("ptype", [DataPartType.COMPACT, DataPartType.WIDE])
def test_part_round_trip(ptype):
    t = make_table()
    d = RAMDirectory()
    part = write_part(d, "p_0", t, part_type=ptype)
    assert part.is_active and part.part_type == ptype
    assert part.rows_count == t.num_rows
    assert part.marks_count == t.num_granules
    assert part.bytes_on_disk == sum(d.file_length(f) for f in part.files)
    if ptype == DataPartType.WIDE:
        assert len(part.files) == len(t.columns)  # one bundle per column
    else:
        assert len(part.files) == 1
    got_part, got = read_part(d, "p_0")
    assert got_part.part_type == ptype
    assert got_part.rows_count == t.num_rows
    assert_tables_equal(t, got)


def test_in_memory_part_not_persisted():
    t = make_table(rows=500)
    d = RAMDirectory()
    part = write_part(d, "hot", t, part_type=DataPartType.IN_MEMORY)
    assert part.is_active and part.table is t
    assert d.list_files() == []


def test_auto_type_selection():
    t = make_table(rows=2000)
    d = RAMDirectory()
    assert write_part(d, "small", t).part_type == DataPartType.COMPACT
    big = ColumnarTable()
    rows = MAX_COMPACT_ROWS + 8192
    big.add_column("x", Int64Column(np.arange(rows, dtype=np.int64)))
    for j in range(12):
        big.add_column(f"pad{j}", Float64Column(np.zeros(rows)), minmax=False)
    assert table_bytes_estimate(big) >= MAX_COMPACT_BYTES
    assert write_part(d, "big", big).part_type == DataPartType.WIDE


def test_merge_parts_lifecycle_and_equivalence():
    t1 = make_table(rows=9000, seed=1)
    t2 = make_table(rows=11000, seed=2)
    d = RAMDirectory()
    p1 = write_part(d, "p_1", t1, part_type=DataPartType.COMPACT)
    p2 = write_part(d, "p_2", t2, part_type=DataPartType.WIDE)
    merge_parts(d, [p1, p2], "p_merged")
    assert p1.is_obsolete and p2.is_obsolete
    _, got = read_part(d, "p_merged")
    assert got.num_rows == 20000
    for cname in t1.columns:
        a, b = t1.columns[cname], t2.columns[cname]
        g = got.columns[cname]
        if isinstance(a, StringColumn):
            assert g[0] == a[0] and g[9000] == b[0]
            assert g[19999] == b[10999]
        else:
            assert np.array_equal(g.values,
                                  np.concatenate([a.values, b.values]))
    # skip indexes were rebuilt over the merged granule grid
    mm = got.minmax["ts"]
    assert len(mm.mins) == got.num_granules
    assert mm.mins[0] == t1.columns["ts"].values[0]
    seam = np.concatenate(
        [t1.columns["ts"].values[8192:],
         t2.columns["ts"].values[: 16384 - 9000]]
    )
    assert mm.mins[1] == seam.min() and mm.maxs[1] == seam.max()
    # and the merged part still scans correctly (X1's plain version)
    dt = DeviceTable(got, device="cpu")
    res = dt.range_agg(filter_col="region", lower=10, upper=20)
    want = sum(
        int(((t.columns["region"].values >= 10)
             & (t.columns["region"].values <= 20)).sum())
        for t in (t1, t2)
    )
    assert res["count"] == want
    delete_part(d, p1)
    delete_part(d, p2)
    assert p1.state == DataPartState.DELETING
    assert not d.file_exists("p_1.part")
    assert not d.file_exists("p_2.col")
    _, again = read_part(d, "p_merged")
    assert again.num_rows == 20000
