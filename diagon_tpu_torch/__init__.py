"""diagon_tpu_torch — the diagon search framework on PyTorch and CUDA.

A second package beside ``diagon_tpu`` (the JAX reference, which stays as
it is). It imports nothing of ``diagon_tpu``: it keeps its own copies of
the host tier it needs, under the JAX package's module names
(``document``, ``analysis``, ``index.{segment,memory_index,merge,writer,
reader}``, ``store``, ``codecs.postings``, ``observability.metrics``,
``bench.{synthetic,queries,bulk_build}``,
``search.{query,bm25,topdocs,oracle}``), and its host C++ in
``csrc/host/`` (corpus builder, store decodes, ingest tokenizer and
accumulator; ``native.py``). ``search.convert`` carries a JAX package
segment, query or row index across. It owns the device tier:

- ``search.device_index``: segments as tensors on one explicit device;
- ``search.row_engine``: the dense row banks (resident, or built per batch
  on segments of 4M+ docs), exhaustive scoring and the pruned batch route
  (compact bank, phase 1 or phase 0, tile selection, phase 2,
  certificates, escalation);
- ``search.searcher.IndexSearcher``: term / boolean / range / nested
  search, solo and batched, with tier-managed residency under a device
  byte budget (``observability.storage_tiers``);
- ``api``: the flat embedding surface, the reference C API's 88
  ``diagon_*`` functions one to one (``api.C_API_MAP``);
- ``ops.row_sum`` (B1/B2), ``ops.approx_pass`` (B3/B4/B5),
  ``ops.gather_rescore`` (B6/B7) and ``ops.bits_hits`` (B8): kernels in
  CUDA C++ for sm_90a in ``csrc/``, built with nvcc at first use, with
  plain PyTorch versions beside them.

Results are bit-identical to the JAX package and to the host oracle. The
document classes are re-exported here, as the JAX package does.
"""

__version__ = "0.1.0"

from diagon_tpu_torch.document.document import (  # noqa: F401
    Document,
    Field,
    TextField,
    StringField,
    StoredField,
    NumericDocValuesField,
    SortedDocValuesField,
    SortedNumericDocValuesField,
    SortedSetDocValuesField,
    BinaryDocValuesField,
    LongPointField,
    DoubleDocValuesField,
    DoublePointField,
    IndexOptions,
    FieldType,
)
