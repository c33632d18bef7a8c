"""MergeTree data parts, Wide / Compact / InMemory formats + lifecycle: the
port's own copy of ``diagon_tpu/columnar/parts.py``.

Reference: ``src/core/include/diagon/mergetree/IMergeTreeDataPart.h:19-140``
— there the part types and states are an interface-only stub ("NOTE: Stub
implementation - provides interface only"). Here all three formats are
actually implemented over the bundle container:

- **Compact**: every column in ONE ``<name>.col`` bundle (the existing
  ``write_table`` layout) — small parts, one file open.
- **Wide**: one ``<name>.<column>.col`` bundle PER COLUMN — large parts,
  so a scan touching two columns of a 50-column table maps/reads two
  files, and a merge can stream column-at-a-time.
- **InMemory**: nothing persisted; the part pins its ``ColumnarTable``
  (the reference marks this variant "Not yet implemented").

Part identity lives in a tiny ``<name>.part`` JSON manifest (the role of
the reference's part name / ``getBytesOnDisk`` metadata), and lifecycle
follows the reference's state machine: Temporary while writing, Active
after the manifest lands (the manifest write is the commit point — it is
``create_atomic``), Obsolete after a merge replaces the part, Deleting
while files are removed.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field as dc_field
from enum import Enum
from typing import Dict, List, Optional, Sequence

import numpy as np

from diagon_tpu_torch.columnar.column import (
    Column,
    Float64Column,
    Int64Column,
    StringColumn,
)
from diagon_tpu_torch.columnar.store import read_table, write_table
from diagon_tpu_torch.columnar.table import ColumnarTable

# reference thresholds (IMergeTreeDataPart.h selectPartType)
MAX_COMPACT_BYTES = 10 * 1024 * 1024
MAX_COMPACT_ROWS = 100_000


class DataPartType(Enum):
    WIDE = "Wide"
    COMPACT = "Compact"
    IN_MEMORY = "InMemory"


class DataPartState(Enum):
    TEMPORARY = "Temporary"
    ACTIVE = "Active"
    OBSOLETE = "Obsolete"
    DELETING = "Deleting"


def select_part_type(bytes_estimate: int, rows: int) -> DataPartType:
    """Reference heuristic: Compact for small parts, Wide otherwise."""
    if bytes_estimate < MAX_COMPACT_BYTES or rows < MAX_COMPACT_ROWS:
        return DataPartType.COMPACT
    return DataPartType.WIDE


def table_bytes_estimate(table: ColumnarTable) -> int:
    total = 0
    for col in table.columns.values():
        if isinstance(col, StringColumn):
            total += col.chars.nbytes + col.offsets.nbytes
        else:
            total += col.values.nbytes
    return total


@dataclass
class DataPart:
    """One immutable data part (reference ``IMergeTreeDataPart``)."""

    name: str
    part_type: DataPartType
    state: DataPartState
    rows_count: int
    bytes_on_disk: int
    marks_count: int
    files: List[str] = dc_field(default_factory=list)
    table: Optional[ColumnarTable] = None  # pinned for IN_MEMORY parts

    @property
    def is_active(self) -> bool:
        return self.state == DataPartState.ACTIVE

    @property
    def is_obsolete(self) -> bool:
        return self.state == DataPartState.OBSOLETE

    def manifest(self) -> dict:
        return {
            "name": self.name,
            "type": self.part_type.value,
            "rows": self.rows_count,
            "bytes_on_disk": self.bytes_on_disk,
            "marks": self.marks_count,
            "files": self.files,
        }


def _single_column_table(table: ColumnarTable, cname: str) -> ColumnarTable:
    sub = ColumnarTable(granule_rows=table.granule_rows)
    sub.columns[cname] = table.columns[cname]
    if cname in table.minmax:
        sub.minmax[cname] = table.minmax[cname]
    if cname in table.bloom:
        sub.bloom[cname] = table.bloom[cname]
    return sub


def write_part(
    directory,
    name: str,
    table: ColumnarTable,
    part_type: Optional[DataPartType] = None,
    chains: Optional[Dict[str, list]] = None,
) -> DataPart:
    """Persist ``table`` as a data part; the ``.part`` manifest write is
    the atomic commit point (state Temporary -> Active)."""
    if part_type is None:
        part_type = select_part_type(table_bytes_estimate(table), table.num_rows)

    part = DataPart(
        name=name,
        part_type=part_type,
        state=DataPartState.TEMPORARY,
        rows_count=table.num_rows,
        bytes_on_disk=0,
        marks_count=table.num_granules,
    )
    if part_type == DataPartType.IN_MEMORY:
        part.table = table
        part.state = DataPartState.ACTIVE
        return part

    if part_type == DataPartType.COMPACT:
        part.files = [write_table(directory, name, table, chains=chains)]
    else:  # WIDE: one bundle per column
        part.files = [
            write_table(
                directory, f"{name}.{cname}",
                _single_column_table(table, cname), chains=chains,
            )
            for cname in table.columns
        ]
    part.bytes_on_disk = sum(directory.file_length(f) for f in part.files)
    manifest = json.dumps(part.manifest()).encode()
    if not directory.create_atomic(f"{name}.part", manifest):
        directory.write_bytes(f"{name}.part", manifest)
    part.state = DataPartState.ACTIVE
    return part


def read_part(directory, name: str, verify_checksums: bool = False):
    """Load a part by name -> (DataPart, ColumnarTable)."""
    m = json.loads(directory.read_bytes(f"{name}.part").decode())
    ptype = DataPartType(m["type"])
    if ptype == DataPartType.COMPACT:
        table = read_table(directory, name, verify_checksums)
    else:
        table = ColumnarTable()
        for f in m["files"]:
            sub = read_table(
                directory, f[: -len(".col")], verify_checksums
            )
            table.granule_rows = sub.granule_rows
            table.columns.update(sub.columns)
            table.minmax.update(sub.minmax)
            table.bloom.update(sub.bloom)
    part = DataPart(
        name=m["name"],
        part_type=ptype,
        state=DataPartState.ACTIVE,
        rows_count=m["rows"],
        bytes_on_disk=m["bytes_on_disk"],
        marks_count=m["marks"],
        files=list(m["files"]),
    )
    return part, table


def delete_part(directory, part: DataPart) -> None:
    part.state = DataPartState.DELETING
    for f in part.files:
        if directory.file_exists(f):
            directory.delete_file(f)
    if directory.file_exists(f"{part.name}.part"):
        directory.delete_file(f"{part.name}.part")


def _concat_columns(cols: Sequence[Column]) -> Column:
    first = cols[0]
    if isinstance(first, StringColumn):
        out = StringColumn()
        out.offsets = np.concatenate(
            [first.offsets]
            + [c.offsets[1:] + off for c, off in zip(
                cols[1:],
                np.cumsum([int(c.offsets[-1]) for c in cols])[:-1],
            )]
        )
        out.chars = np.concatenate([c.chars for c in cols])
        return out
    cls = Int64Column if isinstance(first, Int64Column) else Float64Column
    return cls(np.concatenate([c.values for c in cols]))


def merge_tables(tables: Sequence[ColumnarTable]) -> ColumnarTable:
    """Concatenate same-schema tables; skip indexes rebuilt over the new
    granule grid (granule boundaries shift, so per-source indexes cannot
    be stitched)."""
    first = tables[0]
    out = ColumnarTable(granule_rows=first.granule_rows)
    for cname in first.columns:
        col = _concat_columns([t.columns[cname] for t in tables])
        out.add_column(
            cname, col,
            minmax=cname in first.minmax,
            bloom=cname in first.bloom,
        )
    return out


def merge_parts(
    directory,
    parts: Sequence[DataPart],
    new_name: str,
    part_type: Optional[DataPartType] = None,
) -> DataPart:
    """MergeTree merge: read source parts, concatenate, write the merged
    part, mark sources Obsolete (the caller garbage-collects them with
    ``delete_part``, mirroring the reference's Obsolete -> Deleting)."""
    tables = []
    for p in parts:
        if p.table is not None:
            tables.append(p.table)
        else:
            tables.append(read_part(directory, p.name)[1])
    merged = merge_tables(tables)
    new_part = write_part(directory, new_name, merged, part_type=part_type)
    for p in parts:
        p.state = DataPartState.OBSOLETE
    return new_part
