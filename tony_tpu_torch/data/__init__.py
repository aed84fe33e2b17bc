"""Data plane: memmapped token datasets, deterministic batch loading
(numpy; copies of the JAX package's data modules) and the loader's mesh
helpers."""

from .dataset import TokenDataset, has_ttpu_magic, write_tokens
from .loader import (
    BATCH_AXES,
    PrefetchLoader,
    ShardedBatchLoader,
    device_put_sharded_batch,
    loader_shard_info,
    seq_shard_info,
    sharded_batch_axes,
)

__all__ = ["TokenDataset", "write_tokens", "has_ttpu_magic",
           "ShardedBatchLoader", "PrefetchLoader", "BATCH_AXES",
           "sharded_batch_axes", "loader_shard_info", "seq_shard_info",
           "device_put_sharded_batch"]
