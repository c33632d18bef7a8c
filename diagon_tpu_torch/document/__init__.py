"""Document model: Document, typed Fields, JSON parsing, index mapping; the
port's own copy of ``diagon_tpu/document``.

Equivalent of the reference's document layer (``diagon/document/``,
SURVEY.md section 2.6).
"""

from diagon_tpu_torch.document.document import (  # noqa: F401
    BinaryDocValuesField,
    Document,
    DoubleDocValuesField,
    DoublePointField,
    Field,
    FieldType,
    IndexOptions,
    DocValuesType,
    LongPointField,
    NumericDocValuesField,
    SortedDocValuesField,
    SortedNumericDocValuesField,
    SortedSetDocValuesField,
    StoredField,
    StringField,
    TextField,
)
from diagon_tpu_torch.document.json_parser import JsonDocumentParser  # noqa: F401
from diagon_tpu_torch.document.mapping import IndexMapping  # noqa: F401
