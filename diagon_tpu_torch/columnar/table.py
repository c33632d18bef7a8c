"""Columnar table with granule skip indexes: the port's own copy of
``diagon_tpu/columnar/table.py``, numpy only.

Granularity follows the reference (8192 rows/granule,
``IMergeTreeIndexGranularity.h:14-50`` Constant variant). Skip indexes are
dense per-granule arrays (the TPU form of ``MergeTreeIndexMinMax`` /
``MergeTreeIndexBloomFilter``): pruning a predicate over ALL granules is a
single vectorized comparison, no per-granule objects.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field
from typing import Dict, Optional, Sequence

import numpy as np

from diagon_tpu_torch.columnar.column import (
    Column,
    Float64Column,
    Int64Column,
    StringColumn,
)

GRANULE_ROWS = 8192

# ~8 bits per element at 8192 rows/granule -> ~2.4% false-positive rate
# with 4 hash functions (ClickHouse-like sizing).
BLOOM_WORDS = 2048  # 65536 bits / granule
BLOOM_HASHES = 4


def _bloom_hashes(h64: np.ndarray) -> np.ndarray:
    """ClickHouse-style double hashing: g_i = h1 + i*h2 (BloomFilter.h)."""
    h1 = (h64 & np.uint64(0xFFFFFFFF)).astype(np.uint64)
    h2 = (h64 >> np.uint64(32)).astype(np.uint64)
    i = np.arange(BLOOM_HASHES, dtype=np.uint64)[:, None]
    return (h1[None, :] + i * h2[None, :]) % np.uint64(BLOOM_WORDS * 32)


def _hash64(values: np.ndarray) -> np.ndarray:
    """Cheap splitmix64 over int64 values (CityHash's role here)."""
    x = values.astype(np.uint64, copy=True)
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    z = x
    z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    return z ^ (z >> np.uint64(31))


def hash_bytes64(value: bytes) -> int:
    import zlib

    # two independent crc32s -> 64 bits; stable across runs
    return (zlib.crc32(value) << 32) | zlib.crc32(value, 0xDEADBEEF)


@dataclass
class MinMaxIndex:
    """Per-granule min/max (reference MergeTreeIndexMinMax)."""

    mins: np.ndarray  # [G] column dtype
    maxs: np.ndarray  # [G]

    @staticmethod
    def build(values: np.ndarray, granule_rows: int = GRANULE_ROWS) -> "MinMaxIndex":
        n = len(values)
        G = (n + granule_rows - 1) // granule_rows
        mins = np.empty(G, dtype=values.dtype)
        maxs = np.empty(G, dtype=values.dtype)
        for g in range(G):
            chunk = values[g * granule_rows : (g + 1) * granule_rows]
            mins[g] = chunk.min()
            maxs[g] = chunk.max()
        return MinMaxIndex(mins, maxs)

    def granules_maybe_in_range(self, lower, upper) -> np.ndarray:
        """bool [G]: granule may contain a value in [lower, upper]."""
        ok = np.ones(len(self.mins), dtype=bool)
        if lower is not None:
            ok &= self.maxs >= lower
        if upper is not None:
            ok &= self.mins <= upper
        return ok


@dataclass
class BloomIndex:
    """Per-granule bloom filters as a dense [G, BLOOM_WORDS] uint32 array."""

    words: np.ndarray

    @staticmethod
    def build(hashed: np.ndarray, granule_rows: int = GRANULE_ROWS) -> "BloomIndex":
        n = len(hashed)
        G = (n + granule_rows - 1) // granule_rows
        words = np.zeros((G, BLOOM_WORDS), dtype=np.uint32)
        for g in range(G):
            h = hashed[g * granule_rows : (g + 1) * granule_rows]
            bits = _bloom_hashes(h).reshape(-1)
            w = (bits >> np.uint64(5)).astype(np.int64)
            b = (bits & np.uint64(31)).astype(np.uint32)
            np.bitwise_or.at(words[g], w, np.uint32(1) << b)
        return BloomIndex(words)

    def granules_maybe_contain(self, h64: int) -> np.ndarray:
        bits = _bloom_hashes(np.asarray([h64], dtype=np.uint64)).reshape(-1)
        w = (bits >> np.uint64(5)).astype(np.int64)
        b = (bits & np.uint64(31)).astype(np.uint32)
        need = np.uint32(1) << b
        return np.all((self.words[:, w] & need) == need, axis=1)


@dataclass
class ColumnarTable:
    """Named columns + per-column skip indexes."""

    columns: Dict[str, Column] = dc_field(default_factory=dict)
    granule_rows: int = GRANULE_ROWS
    minmax: Dict[str, MinMaxIndex] = dc_field(default_factory=dict)
    bloom: Dict[str, BloomIndex] = dc_field(default_factory=dict)

    @property
    def num_rows(self) -> int:
        return len(next(iter(self.columns.values()))) if self.columns else 0

    @property
    def num_granules(self) -> int:
        return (self.num_rows + self.granule_rows - 1) // self.granule_rows

    def add_column(
        self,
        name: str,
        column: Column,
        minmax: bool = True,
        bloom: bool = False,
    ) -> "ColumnarTable":
        if self.columns and len(column) != self.num_rows:
            raise ValueError("column length mismatch")
        self.columns[name] = column
        if isinstance(column, (Int64Column, Float64Column)) and minmax:
            self.minmax[name] = MinMaxIndex.build(
                column.values, self.granule_rows
            )
        if bloom:
            if isinstance(column, StringColumn):
                hashed = np.asarray(
                    [hash_bytes64(column[i]) for i in range(len(column))],
                    dtype=np.uint64,
                )
            else:
                hashed = _hash64(column.values)
            self.bloom[name] = BloomIndex.build(hashed, self.granule_rows)
        return self
