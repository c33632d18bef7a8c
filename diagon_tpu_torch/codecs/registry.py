"""Codec registry, named segment formats: the port's own copy of
``diagon_tpu/codecs/registry.py`` (reference ``Codec::forName``,
``codecs/Codec.cpp`` SPI-style registration).

A codec binds a format name to segment serialize/deserialize functions.
Segment bundles record their codec name in the meta header; readers
dispatch through the registry so future formats (quantized row banks,
compressed stored fields) can coexist with old segments on disk.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List

_REGISTRY: Dict[str, "Codec"] = {}

DEFAULT_CODEC = "DiagonTPU1"


@dataclass(frozen=True)
class Codec:
    name: str
    write_segment: Callable  # (directory, SegmentData) -> [files]
    read_segment: Callable  # (directory, name, verify) -> SegmentData

    def register(self) -> "Codec":
        _REGISTRY[self.name] = self
        return self


def for_name(name: str) -> Codec:
    """Lookup (reference ``Codec::forName``); raises on unknown codecs."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown codec {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def available_codecs() -> List[str]:
    return sorted(_REGISTRY)


def _register_builtin() -> None:
    from diagon_tpu_torch.store import format as fmt

    Codec(
        name=DEFAULT_CODEC,
        write_segment=fmt.write_segment,
        read_segment=fmt.read_segment,
    ).register()


_register_builtin()
