"""Data plane: memmapped token datasets and deterministic batch loading
(numpy; copies of the JAX package's data modules)."""

from .dataset import TokenDataset, has_ttpu_magic, write_tokens
from .loader import PrefetchLoader, ShardedBatchLoader

__all__ = ["TokenDataset", "write_tokens", "has_ttpu_magic",
           "ShardedBatchLoader", "PrefetchLoader"]
