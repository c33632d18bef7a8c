"""Sparse vector type (reference ``sparse/SparseVector.h``): the port's own
copy of ``diagon_tpu/sparse/vector.py``."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SparseVector:
    """(term_id, weight) pairs; ids int32 ascending unique, weights f32 > 0."""

    ids: np.ndarray
    values: np.ndarray

    def __post_init__(self):
        self.ids = np.asarray(self.ids, dtype=np.int32)
        self.values = np.asarray(self.values, dtype=np.float32)
        if len(self.ids) != len(self.values):
            raise ValueError("ids/values length mismatch")
        if len(self.ids) > 1 and not (np.diff(self.ids) > 0).all():
            order = np.argsort(self.ids)
            self.ids = self.ids[order]
            self.values = self.values[order]

    def __len__(self):
        return len(self.ids)

    def dot(self, other: "SparseVector") -> float:
        i = np.intersect1d(self.ids, other.ids)
        a = self.values[np.searchsorted(self.ids, i)]
        b = other.values[np.searchsorted(other.ids, i)]
        return float(np.dot(a, b))
