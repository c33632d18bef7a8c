"""Codecs: the packed posting-block format (the port's copy of
``diagon_tpu.codecs``): dense fixed-dtype arrays, decoded block at a time.
Host only: importing it builds and touches nothing on a device."""

from diagon_tpu_torch.codecs.bitpack import (  # noqa: F401
    bits_needed,
    pack_u32,
    unpack_u32_numpy,
)
from diagon_tpu_torch.codecs.postings import (  # noqa: F401
    BLOCK_SIZE,
    PackedPostings,
    build_packed_postings,
)
