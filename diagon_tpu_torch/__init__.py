"""diagon_tpu_torch — the diagon search framework on PyTorch and CUDA.

A second package beside ``diagon_tpu`` (the JAX reference, which stays as
it is). It imports the reference's JAX-free host tier (``index``,
``codecs``, ``bench``, ``search.{query,oracle,bm25,topdocs}``,
``observability.metrics``) and owns the device tier:

- ``search.device_index``: segments as tensors on one explicit device;
- ``search.row_engine``: the dense row bank, exhaustive scoring and the
  pruned batch route (compact bank, phase 1, tile selection, phase 2,
  certificates, escalation);
- ``search.searcher.IndexSearcher``: term / boolean / range / nested
  search, solo and batched;
- ``ops.row_sum`` (B1/B2), ``ops.approx_pass`` (B3/B4/B5) and
  ``ops.gather_rescore`` (B6/B7): kernels in CUDA C++ for sm_90a in
  ``csrc/``, built with nvcc at first use, with plain PyTorch versions
  beside them.

Results are bit-identical to the JAX package and to the host oracle.
"""

__version__ = "0.1.0"
