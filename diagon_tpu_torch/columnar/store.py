"""Columnar table persistence, per-granule compressed blocks + marks: the
port's own copy of ``diagon_tpu/columnar/store.py``. A table it reads
feeds ``DeviceTable(table, device=...)`` unchanged.

Mirrors the reference's ColumnarStore layout (``benchmarks/columnar/
ColumnarStore.h``: 8192-row granules, per-granule compression, per-granule
minmax + file offset "marks") inside our checksummed bundle container. The
skip indexes are stored precomputed, so a reader can prune granules without
touching column data — the reference's 3-level SKIP / BULK / SCAN
evaluation.
"""

from __future__ import annotations

import numpy as np

from diagon_tpu_torch.columnar.column import (
    Float64Column,
    Int64Column,
    StringColumn,
)
from diagon_tpu_torch.columnar.compression import CODECS as _CODECS
from diagon_tpu_torch.columnar.compression import compress, decompress
from diagon_tpu_torch.columnar.table import (
    BloomIndex,
    ColumnarTable,
    MinMaxIndex,
)
from diagon_tpu_torch.store.format import ArrayBundleReader, ArrayBundleWriter

# Entropy stage: ZSTD when libzstd is present (the reference's default
# strong codec, CompressionCodecs.h:141), zlib otherwise. The method-byte
# framing makes readers agnostic to which wrote a given block.

_ENTROPY = "zstd" if "zstd" in _CODECS else "zlib"
DEFAULT_CHAIN = [_ENTROPY]
NUMERIC_CHAIN = ["delta", "t64", _ENTROPY]


def write_table(directory, name: str, table: ColumnarTable,
                chains: dict = None) -> str:
    chains = chains or {}
    meta = {
        "format": 1,
        "num_rows": table.num_rows,
        "granule_rows": table.granule_rows,
        "columns": {},
    }
    w = ArrayBundleWriter(meta)
    gr = table.granule_rows

    for cname, col in table.columns.items():
        p = f"c.{cname}."
        if isinstance(col, StringColumn):
            kind = "string"
            chain = chains.get(cname, DEFAULT_CHAIN)
            blobs, offs = [], [0]
            for g in range(table.num_granules):
                s, e = g * gr, min((g + 1) * gr, table.num_rows)
                lens = np.diff(col.offsets[s : e + 1]).astype(np.int32)
                chars = col.chars[col.offsets[s] : col.offsets[e]]
                raw = lens.tobytes() + chars.tobytes()
                blob = compress(raw, chain)
                blobs.append(blob)
                offs.append(offs[-1] + len(blob))
            w.add(p + "blocks", np.frombuffer(b"".join(blobs), np.uint8))
            w.add(p + "marks", np.asarray(offs, dtype=np.int64))
        else:
            kind = "int64" if isinstance(col, Int64Column) else "float64"
            chain = chains.get(
                cname, NUMERIC_CHAIN if kind == "int64" else DEFAULT_CHAIN
            )
            blobs, offs = [], [0]
            for g in range(table.num_granules):
                s, e = g * gr, min((g + 1) * gr, table.num_rows)
                blob = compress(col.values[s:e].tobytes(), chain)
                blobs.append(blob)
                offs.append(offs[-1] + len(blob))
            w.add(p + "blocks", np.frombuffer(b"".join(blobs), np.uint8))
            w.add(p + "marks", np.asarray(offs, dtype=np.int64))
        meta["columns"][cname] = {"kind": kind}

        mm = table.minmax.get(cname)
        if mm is not None:
            w.add(p + "minmax_min", mm.mins)
            w.add(p + "minmax_max", mm.maxs)
        bl = table.bloom.get(cname)
        if bl is not None:
            w.add(p + "bloom", bl.words)

    fname = f"{name}.col"
    directory.write_bytes(fname, w.tobytes())
    return fname


def read_table(directory, name: str, verify_checksums: bool = False) -> ColumnarTable:
    r = ArrayBundleReader(directory.open_mmap(f"{name}.col"), verify_checksums)
    meta = r.meta
    gr = meta["granule_rows"]
    n = meta["num_rows"]
    table = ColumnarTable(granule_rows=gr)

    for cname, cmeta in meta["columns"].items():
        p = f"c.{cname}."
        blocks = r.array(p + "blocks").tobytes()
        marks = r.array(p + "marks")
        G = len(marks) - 1
        if cmeta["kind"] == "string":
            strings = []
            for g in range(G):
                raw = decompress(blocks[marks[g] : marks[g + 1]])
                rows = min(gr, n - g * gr)
                lens = np.frombuffer(raw[: rows * 4], dtype=np.int32)
                chars = raw[rows * 4 :]
                pos = 0
                for ln in lens:
                    strings.append(chars[pos : pos + ln])
                    pos += ln
            col = StringColumn(strings)
        else:
            dtype = np.int64 if cmeta["kind"] == "int64" else np.float64
            parts = [
                np.frombuffer(decompress(blocks[marks[g] : marks[g + 1]]), dtype)
                for g in range(G)
            ]
            vals = np.concatenate(parts) if parts else np.zeros(0, dtype)
            col = (Int64Column if dtype == np.int64 else Float64Column)(vals)
        table.columns[cname] = col

        if r.has(p + "minmax_min"):
            table.minmax[cname] = MinMaxIndex(
                r.array(p + "minmax_min").copy(),
                r.array(p + "minmax_max").copy(),
            )
        if r.has(p + "bloom"):
            table.bloom[cname] = BloomIndex(r.array(p + "bloom").copy())
    return table
