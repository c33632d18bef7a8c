"""Columnar storage on the device: the port's counterpart of
``diagon_tpu/columnar``'s typed columns, granule skip indexes and device
engine (``DeviceTable``, with the range-aggregate kernel X1). The host
I/O of the JAX package (compression, the store, data parts) is not
ported yet."""

from diagon_tpu_torch.columnar.column import (  # noqa: F401
    Column,
    Float64Column,
    Int64Column,
    StringColumn,
    column_from_values,
)
from diagon_tpu_torch.columnar.engine import DeviceTable  # noqa: F401
from diagon_tpu_torch.columnar.table import (  # noqa: F401
    GRANULE_ROWS,
    ColumnarTable,
)
