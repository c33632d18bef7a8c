"""Explicit index schema, the port's own copy of
``diagon_tpu/document/mapping.py`` (reference ``IndexMapping.h:25-66``).

Maps field name -> (IndexOptions, DocValuesType, stored, tokenized).
Array fields must be declared, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from diagon_tpu_torch.document.document import (
    ArrayField,
    DocValuesType,
    Field,
    FieldType,
    IndexOptions,
)


@dataclass
class FieldMapping:
    index_options: IndexOptions = IndexOptions.NONE
    doc_values_type: DocValuesType = DocValuesType.NONE
    stored: bool = False
    tokenized: bool = False
    is_array: bool = False
    analyzer: str = "standard"

    def to_field_type(self) -> FieldType:
        return FieldType(
            index_options=self.index_options,
            stored=self.stored,
            tokenized=self.tokenized,
            doc_values_type=self.doc_values_type,
            analyzer=self.analyzer,
        )


class IndexMapping:
    def __init__(self):
        self._fields: Dict[str, FieldMapping] = {}

    def add_field(self, name: str, mapping: FieldMapping) -> "IndexMapping":
        self._fields[name] = mapping
        return self

    def text(
        self, name: str, stored: bool = False, analyzer: str = "standard"
    ) -> "IndexMapping":
        return self.add_field(
            name,
            FieldMapping(
                index_options=IndexOptions.DOCS_AND_FREQS_AND_POSITIONS,
                stored=stored,
                tokenized=True,
                analyzer=analyzer,
            ),
        )

    def keyword(self, name: str, stored: bool = False) -> "IndexMapping":
        return self.add_field(
            name,
            FieldMapping(index_options=IndexOptions.DOCS, stored=stored),
        )

    def numeric(self, name: str) -> "IndexMapping":
        return self.add_field(
            name, FieldMapping(doc_values_type=DocValuesType.NUMERIC)
        )

    def array(self, name: str, tokenized: bool = True) -> "IndexMapping":
        return self.add_field(
            name,
            FieldMapping(
                index_options=IndexOptions.DOCS_AND_FREQS_AND_POSITIONS,
                tokenized=tokenized,
                is_array=True,
            ),
        )

    def has(self, name: str) -> bool:
        return name in self._fields

    def get(self, name: str) -> FieldMapping:
        return self._fields[name]

    def make_field(self, name: str, value) -> Field:
        m = self._fields[name]
        if m.is_array:
            if not isinstance(value, list):
                raise ValueError(
                    f"field {name!r} is declared as array but got {type(value)}"
                )
            return ArrayField(name, [str(v) for v in value], m.to_field_type())
        if isinstance(value, list):
            raise ValueError(
                f"field {name!r} got an array value but is not declared as array"
            )
        return Field(name, value, m.to_field_type())
