"""Columnar storage: the port's counterpart of ``diagon_tpu/columnar``'s
typed columns, granule skip indexes, compression codecs, table store and
data parts (host, numpy), and of its device engine (``DeviceTable``, with
the range-aggregate kernel X1). A table goes disk -> ``read_table`` ->
``DeviceTable(table, device="cuda")`` -> X1."""

from diagon_tpu_torch.columnar.column import (  # noqa: F401
    Column,
    Float64Column,
    Int64Column,
    StringColumn,
    column_from_values,
)
from diagon_tpu_torch.columnar.table import (  # noqa: F401
    GRANULE_ROWS,
    ColumnarTable,
)
from diagon_tpu_torch.columnar.compression import (  # noqa: F401
    CODECS,
    compress,
    decompress,
)
from diagon_tpu_torch.columnar.store import read_table, write_table  # noqa: F401
from diagon_tpu_torch.columnar.engine import DeviceTable  # noqa: F401
from diagon_tpu_torch.columnar.parts import (  # noqa: F401
    DataPart,
    DataPartState,
    DataPartType,
    delete_part,
    merge_parts,
    merge_tables,
    read_part,
    select_part_type,
    write_part,
)
