"""Multi-device parallelism: segment shards over a ``torch.distributed``
process group, one rank per shard.

Counterpart of ``diagon_tpu/parallel/``. Each rank holds one segment shard
on its device, scores the batch with the single-device kernels, and the
per-shard top-k results merge exactly after an all-gather. ``launch``
starts the ranks of one host.
"""

from diagon_tpu_torch.parallel.sharded import ShardedSearcher, merge_topk

__all__ = ["ShardedSearcher", "merge_topk"]
