"""JSON -> Document parsing, the port's own copy of
``diagon_tpu/document/json_parser.py`` (reference ``JsonDocumentParser`` via
nlohmann_json, exercised by ``benchmarks/JsonIngestionBenchmark.cpp``).

Field typing is driven by an :class:`IndexMapping` when given; untyped
strings become TextFields, ints become NumericDocValues+LongPoint, floats
DoublePoint, lists ArrayFields.
"""

from __future__ import annotations

import json
from typing import Optional, Union

from diagon_tpu_torch.document.document import (
    ArrayField,
    Document,
    DoublePointField,
    LongPointField,
    NumericDocValuesField,
    StringField,
    TextField,
)
from diagon_tpu_torch.document.mapping import IndexMapping


class JsonDocumentParser:
    def __init__(self, mapping: Optional[IndexMapping] = None):
        self.mapping = mapping

    def parse(self, data: Union[str, bytes, dict]) -> Document:
        if isinstance(data, (str, bytes)):
            obj = json.loads(data)
        else:
            obj = data
        if not isinstance(obj, dict):
            raise ValueError("JSON document must be an object")
        doc = Document()
        for name, value in obj.items():
            if self.mapping is not None and self.mapping.has(name):
                doc.add(self.mapping.make_field(name, value))
                continue
            if isinstance(value, bool):
                doc.add(StringField(name, "true" if value else "false"))
            elif isinstance(value, int):
                doc.add(NumericDocValuesField(name, value))
                doc.add(LongPointField(name, value))
            elif isinstance(value, float):
                doc.add(DoublePointField(name, value))
            elif isinstance(value, str):
                doc.add(TextField(name, value))
            elif isinstance(value, list):
                doc.add(ArrayField(name, [str(v) for v in value]))
            elif value is None:
                continue
            else:
                doc.add(TextField(name, json.dumps(value)))
        return doc
