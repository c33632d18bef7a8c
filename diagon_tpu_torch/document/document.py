"""Document and Field types: the port's own copy of
``diagon_tpu/document/document.py``.

Mirrors the reference's field zoo (``document/Field.h:123-271``): TextField
(tokenized, positions), StringField (keyword), StoredField, the doc-values
fields, and point fields for numeric range queries. The semantics that matter
for parity:

- ``TextField`` tokenizes with the standard tokenizer and indexes
  DOCS_AND_FREQS_AND_POSITIONS by default (as the Reuters benchmark sets up,
  ``benchmarks/dataset/SimpleReutersAdapter.h:80-92``).
- ``StringField`` indexes the raw value as one token, DOCS only.
- Doc-values / point fields contribute no inverted-index tokens
  (``Field.h:166-213`` return empty token lists).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field as dc_field, replace
from functools import lru_cache
from typing import List, Optional, Sequence, Union

from diagon_tpu_torch.analysis.tokenizers import standard_tokenize
# the one DocValuesType of the port (``DocValuesData.dv_type`` is compared
# by identity), re-exported here as the JAX module defines it here
from diagon_tpu_torch.index.segment import DocValuesType  # noqa: F401


class IndexOptions(enum.Enum):
    NONE = 0
    DOCS = 1
    DOCS_AND_FREQS = 2
    DOCS_AND_FREQS_AND_POSITIONS = 3


@dataclass
class FieldType:
    index_options: IndexOptions = IndexOptions.NONE
    stored: bool = False
    tokenized: bool = False
    doc_values_type: DocValuesType = DocValuesType.NONE
    point_dims: int = 0
    point_bytes: int = 0
    # Named analyzer from analysis.analyzer_for_name; "standard" keeps the
    # native ASCII fast path (reference fields carry an Analyzer the same
    # way, Field.h:91 -> AnalyzerFactory).
    analyzer: str = "standard"


@lru_cache(maxsize=32)
def _cached_analyzer(name: str):
    """Analyzers are stateless; building one (tokenizer + stop frozenset)
    per FIELD on the non-standard ingest path was measurable."""
    from diagon_tpu_torch.analysis.analyzer import analyzer_for_name

    return analyzer_for_name(name)


class Field:
    """Base field: name + value + FieldType."""

    def __init__(self, name: str, value, ftype: FieldType):
        self.name = name
        self.value = value
        self.type = ftype

    def tokenize(self) -> List[str]:
        """Tokens contributed to the inverted index (reference Field.h:91)."""
        if self.type.index_options == IndexOptions.NONE:
            return []
        if not self.type.tokenized:
            return [str(self.value)]
        if self.type.analyzer != "standard":
            return _cached_analyzer(self.type.analyzer).analyze(
                str(self.value)
            )
        return standard_tokenize(str(self.value))

    def __repr__(self):
        return f"{type(self).__name__}({self.name}={self.value!r})"


# Default TextField type: tokenized, positions, not stored — matches the
# Reuters benchmark FieldType (SimpleReutersAdapter.h:80-88).
TEXT_FIELD_TYPE = FieldType(
    index_options=IndexOptions.DOCS_AND_FREQS_AND_POSITIONS,
    stored=False,
    tokenized=True,
)

STRING_FIELD_TYPE = FieldType(
    index_options=IndexOptions.DOCS,
    stored=False,
    tokenized=False,
)

# Shared default FieldTypes: field constructors must NOT allocate a fresh
# FieldType per instance — MemoryIndex dedups write-time schema sightings
# by FieldType identity, and per-instance types forced a full
# FieldInfosBuilder merge per (doc, field) (~35% of measured ingest time)
_STRING_STORED_TYPE = FieldType(
    index_options=IndexOptions.DOCS, stored=True, tokenized=False
)
_STORED_ONLY_TYPE = FieldType(stored=True)
_NUMERIC_DV_TYPE = FieldType(doc_values_type=DocValuesType.NUMERIC)
_BINARY_DV_TYPE = FieldType(doc_values_type=DocValuesType.BINARY)
_SORTED_DV_TYPE = FieldType(doc_values_type=DocValuesType.SORTED)
_SORTED_NUMERIC_DV_TYPE = FieldType(
    doc_values_type=DocValuesType.SORTED_NUMERIC
)
_SORTED_SET_DV_TYPE = FieldType(doc_values_type=DocValuesType.SORTED_SET)
_POINT_1D_TYPE = FieldType(point_dims=1, point_bytes=8)


@lru_cache(maxsize=32)
def _text_type_for_analyzer(analyzer: str) -> FieldType:
    return replace(TEXT_FIELD_TYPE, analyzer=analyzer)


class TextField(Field):
    def __init__(self, name: str, value: str, ftype: Optional[FieldType] = None,
                 analyzer: str = "standard"):
        if ftype is None:
            ftype = (
                TEXT_FIELD_TYPE
                if analyzer == "standard"
                else _text_type_for_analyzer(analyzer)
            )
        elif analyzer != "standard" and ftype.analyzer != analyzer:
            # an explicit ftype used to silently win over the analyzer
            # argument; apply the explicit analyzer instead
            ftype = replace(ftype, analyzer=analyzer)
        super().__init__(name, value, ftype)


class StringField(Field):
    def __init__(self, name: str, value: str, ftype: Optional[FieldType] = None,
                 stored: bool = False):
        ft = ftype or (
            _STRING_STORED_TYPE if stored else STRING_FIELD_TYPE
        )
        super().__init__(name, value, ft)


class StoredField(Field):
    def __init__(self, name: str, value):
        super().__init__(name, value, _STORED_ONLY_TYPE)


class NumericDocValuesField(Field):
    def __init__(self, name: str, value: int):
        super().__init__(
            name, int(value), _NUMERIC_DV_TYPE
        )


class DoubleDocValuesField(Field):
    """Double stored as its int64 bit pattern in NUMERIC doc values
    (the reference's convention, ``diagon_c_api.cpp:441``: bit_cast
    preserves full precision where a static_cast would truncate).
    Queried by ``DoubleRangeQuery``."""

    def __init__(self, name: str, value: float):
        import struct

        bits = struct.unpack("<q", struct.pack("<d", float(value)))[0]
        Field.__init__(
            self, name, bits,
            _NUMERIC_DV_TYPE,
        )


class BinaryDocValuesField(Field):
    def __init__(self, name: str, value: bytes):
        super().__init__(
            name, bytes(value), _BINARY_DV_TYPE
        )


class SortedDocValuesField(Field):
    def __init__(self, name: str, value: Union[str, bytes]):
        super().__init__(
            name, value, _SORTED_DV_TYPE
        )


class SortedNumericDocValuesField(Field):
    def __init__(self, name: str, value: int):
        super().__init__(
            name, int(value), _SORTED_NUMERIC_DV_TYPE
        )


class SortedSetDocValuesField(Field):
    def __init__(self, name: str, value: Union[str, bytes]):
        super().__init__(
            name, value, _SORTED_SET_DV_TYPE
        )


class LongPointField(Field):
    """1-D int64 point for numeric range queries (reference LongPointField)."""

    def __init__(self, name: str, value: int):
        super().__init__(
            name, int(value), _POINT_1D_TYPE
        )


class DoublePointField(Field):
    def __init__(self, name: str, value: float):
        super().__init__(
            name, float(value), _POINT_1D_TYPE
        )


class ArrayField(Field):
    """Multi-valued field (reference design/15): each element tokenized."""

    def __init__(self, name: str, values: Sequence[str],
                 ftype: Optional[FieldType] = None):
        super().__init__(name, list(values), ftype or TEXT_FIELD_TYPE)

    def tokenize(self) -> List[str]:
        if self.type.index_options == IndexOptions.NONE:
            return []
        out: List[str] = []
        for v in self.value:
            if self.type.tokenized:
                out.extend(standard_tokenize(str(v)))
            else:
                out.append(str(v))
        return out


@dataclass
class Document:
    """Ordered container of fields (reference ``document/Document.h``)."""

    fields: List[Field] = dc_field(default_factory=list)

    def add(self, f: Field) -> "Document":
        self.fields.append(f)
        return self

    def get_fields(self, name: str) -> List[Field]:
        return [f for f in self.fields if f.name == name]

    def get(self, name: str):
        for f in self.fields:
            if f.name == name:
                return f.value
        return None

    def __iter__(self):
        return iter(self.fields)

    def __len__(self):
        return len(self.fields)
