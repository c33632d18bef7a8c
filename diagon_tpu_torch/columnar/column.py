"""Typed column containers (reference ``columns/IColumn.h:43-209``): the
port's own copy of ``diagon_tpu/columnar/column.py``, numpy only.

The reference's COW ``IColumn`` virtual hierarchy becomes thin wrappers
over numpy arrays: ``insert``/``filter``/``cut``/``compare_at`` are array
ops. ``StringColumn`` uses the offsets+bytes layout (``ColumnString``).
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Union

import numpy as np


class Column:
    """Base column; subclasses wrap a numpy payload."""

    def __len__(self) -> int:
        raise NotImplementedError

    def filter(self, mask: np.ndarray) -> "Column":
        raise NotImplementedError

    def cut(self, start: int, length: int) -> "Column":
        raise NotImplementedError

    def compare_at(self, i: int, j: int, other: "Column") -> int:
        a, b = self[i], other[j]
        return int(a > b) - int(a < b)

    def __getitem__(self, i):
        raise NotImplementedError


class _NumericColumn(Column):
    dtype: np.dtype

    def __init__(self, values=None):
        self.values = (
            np.asarray(values, dtype=self.dtype)
            if values is not None
            else np.zeros(0, dtype=self.dtype)
        )

    def __len__(self):
        return len(self.values)

    def __getitem__(self, i):
        return self.values[i]

    def insert(self, value) -> None:
        self.values = np.append(self.values, self.dtype.type(value))

    def insert_range_from(self, other: "_NumericColumn", start: int, length: int):
        self.values = np.concatenate(
            [self.values, other.values[start : start + length]]
        )

    def filter(self, mask: np.ndarray):
        return type(self)(self.values[np.asarray(mask, bool)])

    def cut(self, start: int, length: int):
        return type(self)(self.values[start : start + length])

    def min(self):
        return self.values.min()

    def max(self):
        return self.values.max()


class Int64Column(_NumericColumn):
    dtype = np.dtype(np.int64)


class Int32Column(_NumericColumn):
    dtype = np.dtype(np.int32)


class Float64Column(_NumericColumn):
    dtype = np.dtype(np.float64)


class Float32Column(_NumericColumn):
    dtype = np.dtype(np.float32)


class StringColumn(Column):
    """Offsets + contiguous bytes (reference ``ColumnString``)."""

    def __init__(self, strings: Sequence[Union[str, bytes]] = ()):
        raws = [s.encode() if isinstance(s, str) else bytes(s) for s in strings]
        self.offsets = np.zeros(len(raws) + 1, dtype=np.int64)
        np.cumsum([len(r) for r in raws], out=self.offsets[1:])
        self.chars = np.frombuffer(b"".join(raws), dtype=np.uint8)

    @staticmethod
    def _from_parts(offsets, chars):
        c = StringColumn()
        c.offsets = offsets
        c.chars = chars
        return c

    def __len__(self):
        return len(self.offsets) - 1

    def __getitem__(self, i) -> bytes:
        return self.chars[self.offsets[i] : self.offsets[i + 1]].tobytes()

    def insert(self, value: Union[str, bytes]) -> None:
        raw = value.encode() if isinstance(value, str) else bytes(value)
        self.chars = np.concatenate(
            [self.chars, np.frombuffer(raw, dtype=np.uint8)]
        )
        self.offsets = np.append(self.offsets, self.offsets[-1] + len(raw))

    def filter(self, mask: np.ndarray) -> "StringColumn":
        mask = np.asarray(mask, bool)
        return StringColumn([self[i] for i in np.nonzero(mask)[0]])

    def cut(self, start: int, length: int) -> "StringColumn":
        return StringColumn([self[i] for i in range(start, start + length)])

    def tolist(self) -> List[bytes]:
        return [self[i] for i in range(len(self))]


def column_from_values(values: Iterable) -> Column:
    vals = list(values)
    if not vals:
        return Int64Column()
    v0 = vals[0]
    if isinstance(v0, bool):
        return Int64Column([int(v) for v in vals])
    if isinstance(v0, (int, np.integer)):
        return Int64Column(vals)
    if isinstance(v0, (float, np.floating)):
        return Float64Column(vals)
    return StringColumn([str(v) for v in vals])
