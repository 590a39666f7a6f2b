from .token_store import PackedTokenStore
from .indexed_dataset import IndexedTokenDataset
from .pipeline import ShardedLoader

__all__ = ["PackedTokenStore", "IndexedTokenDataset", "ShardedLoader"]
