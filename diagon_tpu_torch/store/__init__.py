"""Store layer: directories, checksummed array files, locks; the port's
counterpart of ``diagon_tpu/store``.

Index artifacts are dense numpy arrays in a checksummed container that
memory-maps zero-copy (``np.memmap``); the reader's views are what the
port uploads to the card. The files are the JAX package's, byte for byte,
so either package opens an index the other wrote.
"""

from diagon_tpu_torch.store.directory import (  # noqa: F401
    Directory,
    FSDirectory,
    RAMDirectory,
)
from diagon_tpu_torch.store.format import (  # noqa: F401
    ArrayBundleReader,
    ArrayBundleWriter,
    read_segment,
    write_segment,
)
from diagon_tpu_torch.store.lock import Lock, LockObtainFailedError  # noqa: F401
