"""FieldInfo(s): per-field schema, with write-time drift detection; the
port's own copy of ``diagon_tpu/index/field_infos.py``.

Reference: FieldInfo/FieldInfos + FieldInfosBuilder (SURVEY §2.4) — the
builder catches type drift (a field indexed as points in one doc and as
doc values of another type in the next) AT WRITE TIME, and FieldInfos
instances from different segments must agree before a merge combines
them. Previously the schema was implicit in bundle metadata; conflicts
surfaced as corrupt merges instead of errors."""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Iterator, Optional

from diagon_tpu_torch.document.document import DocValuesType, IndexOptions


class FieldSchemaError(ValueError):
    """A field was used with conflicting types (reference
    IllegalArgumentException from FieldInfosBuilder)."""


@dataclass(frozen=True)
class FieldInfo:
    name: str
    index_options: IndexOptions = IndexOptions.NONE
    doc_values_type: DocValuesType = DocValuesType.NONE
    point_dims: int = 0
    point_double: bool = False
    analyzer: str = "standard"

    def _merged(self, other: "FieldInfo") -> "FieldInfo":
        """Combine two sightings of the same field, raising on conflict.
        NONE/0 slots fill in (a field may carry points in one doc and
        nothing in another); set slots must agree."""
        assert self.name == other.name
        out = self

        def pick(a, b, none, what):
            if a == none:
                return b
            if b == none or a == b:
                return a
            raise FieldSchemaError(
                f"field {self.name!r}: conflicting {what} ({a} vs {b})"
            )

        out = replace(
            out,
            index_options=pick(self.index_options, other.index_options,
                               IndexOptions.NONE, "index options"),
            doc_values_type=pick(self.doc_values_type,
                                 other.doc_values_type,
                                 DocValuesType.NONE, "doc values type"),
            point_dims=pick(self.point_dims, other.point_dims, 0,
                            "point dimensions"),
        )
        if self.point_dims and other.point_dims and (
            self.point_double != other.point_double
        ):
            raise FieldSchemaError(
                f"field {self.name!r}: conflicting point value type "
                f"(double vs long)"
            )
        if out.point_dims:
            out = replace(
                out, point_double=self.point_double or other.point_double
            )
        if (self.index_options != IndexOptions.NONE
                and other.index_options != IndexOptions.NONE
                and self.analyzer != other.analyzer):
            raise FieldSchemaError(
                f"field {self.name!r}: conflicting analyzers "
                f"({self.analyzer!r} vs {other.analyzer!r})"
            )
        return out


class FieldInfos:
    """Immutable-ish mapping name -> FieldInfo for one segment."""

    def __init__(self, infos: Optional[Dict[str, FieldInfo]] = None):
        self._by_name: Dict[str, FieldInfo] = dict(infos or {})

    def __iter__(self) -> Iterator[FieldInfo]:
        return iter(self._by_name.values())

    def __len__(self) -> int:
        return len(self._by_name)

    def field_info(self, name: str) -> Optional[FieldInfo]:
        return self._by_name.get(name)

    @staticmethod
    def merge(*many: "FieldInfos") -> "FieldInfos":
        """Cross-segment schema union; raises FieldSchemaError on drift
        (the merge-time check SegmentMerger runs before combining)."""
        b = FieldInfosBuilder()
        for fis in many:
            if fis is None:
                continue
            for fi in fis:
                b._sight(fi)
        return b.finish()


class FieldInfosBuilder:
    """Accumulates field sightings during indexing; raises at the first
    conflicting use (reference FieldInfosBuilder)."""

    def __init__(self):
        self._by_name: Dict[str, FieldInfo] = {}

    def add_field(self, f) -> FieldInfo:
        """Record one document field (document.Field)."""
        ft = f.type
        sight = FieldInfo(
            name=f.name,
            index_options=ft.index_options,
            doc_values_type=ft.doc_values_type,
            point_dims=ft.point_dims,
            point_double=bool(ft.point_dims)
            and isinstance(f.value, float),
            analyzer=ft.analyzer
            if ft.index_options != IndexOptions.NONE else "standard",
        )
        return self._sight(sight)

    def _sight(self, sight: FieldInfo) -> FieldInfo:
        cur = self._by_name.get(sight.name)
        merged = sight if cur is None else cur._merged(sight)
        self._by_name[sight.name] = merged
        return merged

    def finish(self) -> FieldInfos:
        return FieldInfos(dict(self._by_name))


def infos_from_segment(seg) -> FieldInfos:
    """Derive a FieldInfos view from SegmentData contents (disk-loaded
    segments predate explicit infos; the .bnd bundle stores types
    structurally). index_options collapses to DOCS_AND_FREQS[_AND_
    POSITIONS] — block freqs are always kept in the packed format."""
    b = FieldInfosBuilder()
    for name, fd in seg.fields.items():
        b._sight(FieldInfo(
            name=name,
            index_options=IndexOptions.DOCS_AND_FREQS_AND_POSITIONS
            if fd.with_positions else IndexOptions.DOCS_AND_FREQS,
        ))
    for name, dv in seg.doc_values.items():
        b._sight(FieldInfo(name=name, doc_values_type=dv.dv_type))
    for name, pb in seg.points.items():
        b._sight(FieldInfo(name=name, point_dims=1,
                           point_double=bool(pb.is_double)))
    return b.finish()
